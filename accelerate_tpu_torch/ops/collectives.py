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
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

__all__ = [
    "all_gather",
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
