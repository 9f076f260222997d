"""Named-dim collectives over a ``DeviceMesh`` (counterpart of
``accelerate_tpu/ops/collectives.py``).

The JAX package's vocabulary (``psum``, ``pmean``, ``pmax``, ``pmin``,
``all_gather``, ``reduce_scatter``, ``ppermute``, ``ring_shift``,
``all_to_all``, ``broadcast_from``, ``axis_index``, ``axis_size``) names a
mesh axis inside ``shard_map``; here the axis is a dim of a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh=``, default the mesh
the ``Accelerator`` shards over) and each call runs over that dim's process
group. A tuple of dims reduces (or gathers) over each in turn, the last
first, which for a gather gives the dims' row-major order.

The sums, gathers, reduce-scatters, all-to-alls and broadcasts go through
``torch.distributed.nn.functional``, so gradients flow through them as
through the JAX collectives (the backward of a sum is a sum, of a gather a
reduce-scatter). ``pmax``/``pmin`` and ``ppermute`` act on values only.
Gloo has no reduce-scatter: there it is an all-reduce and this rank's
slice, the same value and the same gradient.

The tensor-parallel forward's collectives (Megatron's, with sequence
parallelism) take a process group and are autograd Functions whose
backward is the collective the layout needs:

* :func:`sequence_all_gather` (before a column-parallel block: the
  sequence-sharded residual whole) and :func:`sequence_reduce_scatter`
  (after a row-parallel projection: the partial sums summed and the
  sequence sharded again), each the other's backward;
* where ``tp`` does not divide the sequence the residual stays whole:
  :func:`copy_to_group` (identity, an all-reduce backward) into a block and
  :func:`reduce_from_group` (all-reduce, identity backward) out of it;
* :func:`gather_last_dim` (whole logits from vocabulary shards; the
  backward keeps this rank's slice, since every rank computes the same
  loss from them) and :func:`grad_share` (identity; the backward divides
  by the group's size, so that a gradient every rank computes whole is
  summed over the group like a partial one);
* :func:`all_reduce_` (in place, no gradient): the vocabulary-parallel
  loss's row max, sum of exponentials and label logit, the int8 KV
  cache's per-position scale over the ``tp`` ranks' heads, and the
  engine's agreed restore length; :func:`broadcast_first_` (in place): a
  disaggregated prefill's KV window from the mesh's first rank.

:func:`mirror_group` makes a process group of its own over the ranks of a
mesh dim (fp8's amax reductions run on one, apart from the collectives
that DDP and FSDP2 issue from autograd hooks while they run).

Serving over ``dp_shard`` (``inference.py``) reads FSDP2's shards with
:class:`ShardGather`: each leaf's dim-0 shards all-gathered whole into a
buffer kept for that leaf's name, so one layer's weights are whole at a
time (what GSPMD does for an FSDP-sharded scan), with no FSDP2 module hook
and no allocation after the first call: a CUDA graph captures the
gathers.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "all_gather",
    "ShardGather",
    "all_reduce_",
    "mirror_group",
    "copy_to_group",
    "gather_last_dim",
    "grad_share",
    "reduce_from_group",
    "sum_over_group",
    "sequence_all_gather",
    "sequence_reduce_scatter",
    "all_to_all",
    "axis_index",
    "axis_size",
    "broadcast_from",
    "pmax",
    "pmean",
    "pmin",
    "ppermute",
    "psum",
    "reduce_scatter",
    "ring_shift",
]

AxisNames = Union[str, Sequence[str]]


def _mesh(mesh):
    if mesh is not None:
        return mesh
    from ..state import AcceleratorState

    found = AcceleratorState._shared_state.get("device_mesh")
    if found is None:
        raise ValueError("no mesh: pass mesh= or prepare a model under a ParallelismConfig")
    return found


def _axes(axis: AxisNames) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def _group(axis: str, mesh):
    return _mesh(mesh).get_group(axis)


def _reduce(x, axis, op, mesh):
    from torch.distributed.nn import functional as dnf

    for name in reversed(_axes(axis)):
        group = _group(name, mesh)
        if op == dist.ReduceOp.SUM:
            x = dnf.all_reduce(x, op=op, group=group)
        else:
            x = x.clone()
            dist.all_reduce(x, op=op, group=group)
    return x


def psum(x: torch.Tensor, axis: AxisNames, mesh=None) -> torch.Tensor:
    """All-reduce sum over the mesh dim(s); differentiable."""
    return _reduce(x, axis, dist.ReduceOp.SUM, mesh)


def pmean(x: torch.Tensor, axis: AxisNames, mesh=None) -> torch.Tensor:
    """All-reduce mean over the mesh dim(s); differentiable."""
    return psum(x, axis, mesh) / axis_size(axis, mesh)


def pmax(x: torch.Tensor, axis: AxisNames, mesh=None) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MAX, mesh)


def pmin(x: torch.Tensor, axis: AxisNames, mesh=None) -> torch.Tensor:
    return _reduce(x, axis, dist.ReduceOp.MIN, mesh)


def all_gather(x: torch.Tensor, axis: AxisNames, *, gather_dim: int = 0, tiled: bool = True,
               mesh=None) -> torch.Tensor:
    """Every rank's ``x`` along the dim(s), concatenated on ``gather_dim``;
    ``tiled=False`` stacks them on a new dim ``gather_dim`` instead."""
    from torch.distributed.nn import functional as dnf

    if not tiled:
        x = x.unsqueeze(gather_dim)
    for name in reversed(_axes(axis)):
        x = torch.cat(dnf.all_gather(x.contiguous(), group=_group(name, mesh)), dim=gather_dim)
    return x


def reduce_scatter(x: torch.Tensor, axis: str, *, scatter_dim: int = 0,
                   mesh=None) -> torch.Tensor:
    """The sum over the dim, this rank's ``1/n`` slice of ``scatter_dim``."""
    from torch.distributed.nn import functional as dnf

    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    if x.shape[scatter_dim] % n:
        raise ValueError(f"reduce_scatter: dim {scatter_dim} ({x.shape[scatter_dim]}) is not a "
                         f"multiple of the {axis!r} size {n}")
    rank = dist.get_rank(group)
    if dist.get_backend(group) == "gloo":
        return dnf.all_reduce(x, group=group).chunk(n, dim=scatter_dim)[rank]
    inputs = [c.contiguous() for c in x.chunk(n, dim=scatter_dim)]
    out = torch.empty_like(inputs[0])
    return dnf.reduce_scatter(out, inputs, group=group)


def ppermute(x: torch.Tensor, axis: str, perm: Sequence[tuple], mesh=None) -> torch.Tensor:
    """Point-to-point permutation: ``(source, dest)`` index pairs along the
    dim; a rank no pair sends to receives zeros (as ``lax.ppermute``)."""
    group = _group(axis, mesh)
    me = dist.get_rank(group)
    out = torch.zeros_like(x)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    for work in dist.batch_isend_irecv(ops) if ops else []:
        work.wait()
    return out


def ring_shift(x: torch.Tensor, axis: str, shift: int = 1, mesh=None) -> torch.Tensor:
    """Each rank's ``x`` to the rank ``shift`` places further round the dim."""
    n = axis_size(axis, mesh)
    return ppermute(x, axis, [(i, (i + shift) % n) for i in range(n)], mesh)


def all_to_all(x: torch.Tensor, axis: str, *, split_dim: int, concat_dim: int,
               tiled: bool = True, mesh=None) -> torch.Tensor:
    """Scatter ``split_dim`` across the dim's ranks and gather what they
    send on ``concat_dim``; differentiable."""
    from torch.distributed.nn import functional as dnf

    if not tiled:
        raise NotImplementedError("all_to_all(tiled=False) is not ported; pass tiled=True")
    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    inputs = [c.contiguous() for c in x.chunk(n, dim=split_dim)]
    outputs = [torch.empty_like(c) for c in inputs]
    return torch.cat(dnf.all_to_all(outputs, inputs, group=group), dim=concat_dim)


def broadcast_from(x: torch.Tensor, axis: str, src: int = 0, mesh=None) -> torch.Tensor:
    """The value of the rank at index ``src`` along the dim, on every rank
    of it; differentiable (the gradient is summed back to ``src``)."""
    from torch.distributed.nn import functional as dnf

    group = _group(axis, mesh)
    return dnf.broadcast(x.contiguous(), src=dist.get_global_rank(group, src), group=group)


def axis_index(axis: str, mesh=None) -> int:
    """This rank's coordinate along the dim."""
    return _mesh(mesh).get_local_rank(axis)


def axis_size(axis: AxisNames, mesh=None) -> int:
    """The dim's size (the product over a tuple of dims)."""
    m = _mesh(mesh)
    size = 1
    for name in _axes(axis):
        size *= m.size(m.mesh_dim_names.index(name))
    return size


# ------------------------------------------------- tensor-parallel collectives
def all_reduce_(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``group`` in place (``"sum"``, ``"max"`` or
    ``"min"``); no gradient."""
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
    dist.all_reduce(x, op=ops[op], group=group)
    return x


def broadcast_first_(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` of the mesh's first rank on every rank, in place; no
    gradient. ``groups`` are the process groups of the mesh's dims, outer
    first: over each in turn, the ranks that are first along every later
    dim send from the group's first rank, so the value moves out along one
    dim at a time and each byte crosses each link once."""
    for i, group in enumerate(groups):
        if any(dist.get_rank(later) != 0 for later in groups[i + 1:]):
            continue
        dist.broadcast(x, src=dist.get_global_rank(group, 0), group=group)
    return x


def mirror_group(mesh, dims: AxisNames):
    """A new process group over the ranks that share this rank's
    coordinates on ``mesh``'s other dims (the ranks of its ``dims``
    together): the same ranks as the mesh's group of those dims, with a
    communicator of its own. Every rank makes every such group, in the same
    order, as ``new_group`` requires; each returns its own."""
    names = list(mesh.mesh_dim_names)
    axes = [names.index(d) for d in _axes(dims)]
    ranks = mesh.mesh.permute([i for i in range(len(names)) if i not in axes] + axes)
    ranks = ranks.reshape(-1, int(np.prod([mesh.size(i) for i in axes])))
    me, mine = dist.get_rank(), None
    for row in ranks.tolist():
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


def _gather_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, s, ...) on each of n ranks -> (B, n * s, ...), rank order."""
    n = dist.get_world_size(group)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    out = out.view(n, *x.shape)
    return out.movedim(0, 1).reshape(x.shape[0], n * x.shape[1], *x.shape[2:])


def _scatter_seq(x: torch.Tensor, group) -> torch.Tensor:
    """(B, S, ...) partial sums -> this rank's (B, S / n, ...) of their sum."""
    n = dist.get_world_size(group)
    b, s = x.shape[:2]
    parts = x.reshape(b, n, s // n, *x.shape[2:]).movedim(1, 0).contiguous()
    out = x.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.view(n * b, *parts.shape[2:]), group=group)
    return out


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(x, group=group)
    return x


class _SequenceAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_seq(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_seq(grad, ctx.group), None


class _SequenceReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter_seq(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather_seq(grad, ctx.group), None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherLastDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = dist.get_world_size(group)
        ctx.rank, ctx.width = dist.get_rank(group), x.shape[-1]
        x = x.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.view(n, *x.shape).movedim(0, -2).reshape(*x.shape[:-1], n * x.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(-1, ctx.rank * ctx.width, ctx.width), None


class _GradShare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad / ctx.n, None


def sequence_all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's (B, S/n, ...) sequence block, concatenated on dim 1 in
    rank order; the backward reduce-scatters the gradient along dim 1."""
    return _SequenceAllGather.apply(x, group)


def sequence_reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of (B, S, ...), this rank's block of S/n on
    dim 1; the backward all-gathers the gradient along dim 1. S must be a
    multiple of the group's size."""
    n = dist.get_world_size(group)
    if x.shape[1] % n:
        raise ValueError(f"sequence_reduce_scatter: the sequence ({x.shape[1]}) is not a multiple "
                         f"of the group's size {n}")
    return _SequenceReduceScatter.apply(x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; the backward sums the gradient over ``group``."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the backward passes the gradient
    through."""
    return _ReduceFromGroup.apply(x, group)


def gather_last_dim(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's shard of the last dim, concatenated in rank order; the
    backward keeps this rank's slice of the gradient."""
    return _GatherLastDim.apply(x, group)


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, a value every rank's loss then
    holds whole; the backward sums the gradient over ``group`` too, so each
    rank's share of the value gets every rank's cotangent."""
    return _SumOverGroup.apply(x, group)


def grad_share(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` as it is; the backward divides the gradient by ``n``."""
    return _GradShare.apply(x, n)


class ShardGather:
    """All-gathers FSDP2's dim-0 shards over ``group`` (the ``dp_shard``
    ranks). FSDP2 splits dim 0 as ``torch.chunk`` does, each rank's block
    padded to ``ceil(rows / n)`` rows; the whole leaf is the gather's first
    ``rows`` rows. A leaf name keeps its send and receive buffers from the
    first call on, so every layer's leaf of that name lands in the same
    buffer (the caller runs one layer at a time) and a CUDA graph replays
    the gathers on the same addresses."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self._buffers: dict = {}

    def __call__(self, name: str, local: torch.Tensor, rows: int) -> torch.Tensor:
        """The whole (``rows``, ...) leaf from this rank's block ``local``:
        a view of the buffer for ``name``, valid until the next call for
        that name."""
        chunk = -(-rows // self.size)
        buffers = self._buffers.get(name)
        if buffers is None:
            rest = tuple(local.shape[1:])
            # a block short of the padded rows is copied into a padded one
            send = (None if local.shape[0] == chunk and local.is_contiguous()
                    else local.new_zeros((chunk,) + rest))
            buffers = self._buffers[name] = (send, local.new_empty((self.size * chunk,) + rest))
        send, out = buffers
        if send is not None:
            send[:local.shape[0]].copy_(local)
        dist.all_gather_into_tensor(out, local if send is None else send, group=self.group)
        return out[:rows]
