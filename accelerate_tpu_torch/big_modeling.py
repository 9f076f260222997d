"""Big-model loading and inference on one device (counterpart of
``accelerate_tpu/big_modeling.py``).

* :func:`init_empty_weights` builds models on the ``meta`` device: shapes
  and dtypes, no memory, no random draws (the JAX package's
  ``jax.eval_shape``);
* :func:`load_checkpoint_in_model` streams a safetensors checkpoint into a
  model tensor by tensor, one shard file at a time; checkpoint keys are the
  JAX package's (the tree path joined with ``"."``), so a checkpoint
  written by either package loads into the other;
* :func:`cpu_offload` and, in ``utils/offload.py``, ``disk_offload`` keep
  the weights off the card and copy them in for every forward.

Over a mesh (a ``DeviceMesh`` of the process group, one card a rank) the
plan is the training layout's: ``rules`` (``(regex, dim)`` pairs, the whole
list, as the JAX package's ``dispatch_model`` takes them; e.g.
``parallel.tp.tensor_parallel_rules()``) split a Llama over the mesh's
``tp`` dim for its tensor-parallel forward (an MoE Llama's experts over
the mesh's ``ep`` dim instead, with ``parallel.ep.expert_parallel_rules()``),
and FSDP2 shards over the ``fsdp_axes`` (each per-layer leaf on dim 0,
gathered a layer at a time).
:func:`plan_shardings` says where each leaf goes and checks that a rank's
share fits its budget (:func:`get_max_memory`), as the JAX package's does;
:func:`load_checkpoint_and_dispatch` then copies each rank only its
``tp`` blocks from the memory-mapped checkpoint.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

from ._device import resolve_device
from .utils.modeling import get_leaf, named_leaves, replace_forward, set_leaf

__all__ = [
    "init_empty_weights",
    "abstract_params",
    "plan_shardings",
    "load_checkpoint_and_dispatch",
    "load_checkpoint_in_model",
    "dispatch_model",
    "cpu_offload",
    "get_max_memory",
]


@contextlib.contextmanager
def init_empty_weights(include_buffers: bool = True):
    """Inside, every tensor a factory function makes without an explicit
    device is on ``meta``, and ``create_llama`` / ``LlamaForCausalLM
    .from_seed`` build their parameters there without drawing: the model
    has its shapes and dtypes and holds no memory until
    :func:`load_checkpoint_in_model` fills it (reference
    big_modeling.py:62). ``include_buffers=False``: only parameters go to
    ``meta`` (each registered parameter is moved there); buffers and other
    tensors are made where they would be."""
    if include_buffers:
        with torch.device("meta"):
            yield
        return
    register = torch.nn.Module.register_parameter

    def register_on_meta(module, name, param):
        if param is not None:
            param = type(param)(param.to("meta"), requires_grad=param.requires_grad)
        register(module, name, param)

    torch.nn.Module.register_parameter = register_on_meta
    try:
        yield
    finally:
        torch.nn.Module.register_parameter = register


def abstract_params(init_fn: Callable, *args, **kwargs):
    """``init_fn(*args, **kwargs)`` under :func:`init_empty_weights`: the
    shape/dtype-only tree (the JAX package's ``jax.eval_shape``)."""
    with init_empty_weights():
        return init_fn(*args, **kwargs)


def get_max_memory(mesh=None) -> dict[str, int]:
    """Usable memory per card: 0.9 of its total (reference
    utils/modeling.py:757), keyed by card index; raises without a GPU. With
    ``mesh``: per rank of the mesh (one process a card, ranks of a host on
    its cards in order), keyed by rank; a CPU mesh's ranks share the host's
    memory evenly."""
    if mesh is None:
        resolve_device("cuda")
        return {str(i): int(torch.cuda.get_device_properties(i).total_memory * 0.9)
                for i in range(torch.cuda.device_count())}
    ranks = [int(r) for r in mesh.mesh.flatten().tolist()]
    if mesh.device_type == "cuda":
        cards = torch.cuda.device_count()
        return {str(r): int(torch.cuda.get_device_properties(r % cards).total_memory * 0.9)
                for r in ranks}
    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return {str(r): int(host * 0.9 / len(ranks)) for r in ranks}


class LeafPlan(NamedTuple):
    """Where a leaf (as its checkpoint key holds it) goes on a mesh: the
    dim split over ``tp`` (None: replicated), the dim FSDP2 shards over the
    ``fsdp_axes`` (None: not sharded), the bytes one rank holds, and the
    dim an MoE model splits over ``ep``."""

    tp_dim: Optional[int]
    fsdp_dim: Optional[int]
    rank_bytes: int
    ep_dim: Optional[int] = None


def _mesh_size(mesh, axes) -> int:
    names = mesh.mesh_dim_names or ()
    return math.prod(mesh.size(names.index(a)) for a in axes if a in names)


def _fsdp_axes(mesh, fsdp_axes) -> tuple:
    """The ``fsdp_axes`` the mesh has above size 1 (only ``dp_shard`` is
    ported: ``cp`` waits for ROADMAP.md A11)."""
    names = mesh.mesh_dim_names or ()
    axes = tuple(a for a in fsdp_axes if a in names and mesh.size(names.index(a)) > 1)
    if any(a != "dp_shard" for a in axes):
        raise NotImplementedError(f"fsdp_axes={tuple(fsdp_axes)}: FSDP2 shards over dp_shard; "
                                  "the other dims wait for ROADMAP.md A11")
    return axes


def _split_dim(model) -> str:
    """The dim ``rules`` split ``model`` over: ``"ep"`` for an MoE Llama
    (its experts), else ``"tp"``."""
    return "ep" if getattr(getattr(model, "config", None), "num_experts", 1) > 1 else "tp"


def _split_plan(model, mesh, rules) -> dict:
    """``{parameter name: (checkpoint key, layer, dim)}`` of ``rules`` (the
    whole list) over the mesh's ``tp`` dim, or an MoE model's ``ep`` dim
    (MoE under ``tp`` waits for ROADMAP.md A11)."""
    from .parallel.ep import expert_parallel_plan
    from .parallel.tp import tensor_parallel_plan

    if _split_dim(model) == "tp":
        return tensor_parallel_plan(model, _mesh_size(mesh, ("tp",)), rules, defaults=False)
    if _mesh_size(mesh, ("tp",)) > 1:
        raise NotImplementedError("MoE layers under tensor parallelism are not ported yet "
                                  "(ROADMAP.md A11): lay an MoE model over ep and dp_shard")
    return expert_parallel_plan(model, _mesh_size(mesh, ("ep",)), rules, defaults=False)


def plan_shardings(abstract_tree, mesh, rules=None, fsdp_axes=("dp_shard",),
                   hbm_budget_bytes: Optional[int] = None) -> dict:
    """``{checkpoint key: LeafPlan}`` for a model (built empty, e.g. under
    :func:`init_empty_weights`) laid out over ``mesh`` as
    :func:`dispatch_model` lays it: ``rules`` split a tensor-parallel
    model's leaves over ``tp`` (its forward's one plan; a rule placing a
    leaf elsewhere raises), FSDP2 shards each leaf's per-layer dim 0 over
    the ``fsdp_axes`` (rows padded to a multiple). Raises ``MemoryError``
    when one rank's share exceeds ``hbm_budget_bytes`` (default: the least
    of :func:`get_max_memory` over the mesh), as the JAX package's does.
    An MoE Llama's ``rules`` (``parallel.ep.expert_parallel_rules()``)
    split its experts over the mesh's ``ep`` dim (``ep_dim``)."""
    model = abstract_tree
    split = _split_dim(model)
    n_split = _mesh_size(mesh, (split,)) if rules is not None else 1
    n_fsdp = _mesh_size(mesh, _fsdp_axes(mesh, fsdp_axes))
    by_key = {}
    if rules is not None:
        if getattr(model, "tensor_parallel_forward", False):
            for _, (key, _, dim) in _split_plan(model, mesh, rules).items():
                by_key[key] = dim
        elif rules:
            raise ValueError(f"sharding rule {list(rules)[0]!r}: {type(model).__name__} has no "
                             "tensor-parallel forward (the Llama port has)")
    plans = {}
    for key, attr in named_leaves(model):
        leaf = get_leaf(model, attr)
        shape = list(leaf.shape)
        split_dim = by_key.get(key)
        # a Llama's stacked (L, ...) layer leaf is sharded per layer, on dim 1
        per_layer = hasattr(model, "unstack_layers") and key.split(".")[0] == "layers"
        fsdp_dim = (1 if per_layer else 0) if n_fsdp > 1 and shape else None
        local = list(shape)
        if split_dim is not None:
            local[split_dim] //= n_split
        if fsdp_dim is not None:
            local[fsdp_dim] = -(-local[fsdp_dim] // n_fsdp)
        dims = (None, split_dim) if split == "ep" else (split_dim, None)
        plans[key] = LeafPlan(dims[0], fsdp_dim, math.prod(local) * leaf.element_size(), dims[1])
    if hbm_budget_bytes is None:
        budgets = get_max_memory(mesh)
        hbm_budget_bytes = min(budgets.values()) if budgets else None
    per_rank = sum(p.rank_bytes for p in plans.values())
    if hbm_budget_bytes is not None and per_rank > hbm_budget_bytes:
        raise MemoryError(
            f"Sharded model needs ~{per_rank / 2**30:.1f} GiB per rank but the budget is "
            f"{hbm_budget_bytes / 2**30:.1f} GiB; add mesh dims (dp_shard/tp/ep) or use "
            "cpu_offload().")
    return plans


def load_checkpoint_in_model(
    model: nn.Module,
    checkpoint: str,
    mesh=None,
    strict: bool = True,
    device="cuda",
) -> None:
    """Stream a safetensors checkpoint (one file, or shards plus the index)
    into ``model`` one tensor at a time, one shard file at a time: each
    tensor is read from the memory-mapped file, cast to its leaf's dtype
    and copied to the leaf's device, a ``meta`` leaf to ``device``, and the
    file is released before the next (peak host overhead: one shard's
    touched pages). Every shape, and with ``strict`` every key, is checked
    before anything is loaded: a mismatch raises ``ValueError``, a missing
    key ``KeyError``, and the model is left as it was."""
    from .utils.serialization import SafetensorsReader

    if mesh is not None:
        return _load_over_mesh(model, checkpoint, mesh, None, ("dp_shard",), strict)
    dev = resolve_device(device)
    with SafetensorsReader(checkpoint) as reader:
        missing, by_file = [], {}
        for key, attr in named_leaves(model):
            if key not in reader:
                missing.append(key)
                continue
            leaf, shape = get_leaf(model, attr), tuple(reader.get(key).shape)
            if shape != tuple(leaf.shape):
                raise ValueError(f"Shape mismatch for {key}: ckpt {shape} vs model {tuple(leaf.shape)}")
            by_file.setdefault(reader.file_of(key), []).append((key, attr))
        if missing and strict:
            raise KeyError(f"Missing keys in checkpoint: {missing[:10]}{'...' if len(missing) > 10 else ''}")
        for fname, entries in by_file.items():
            for key, attr in entries:
                leaf = get_leaf(model, attr)
                target = dev if leaf.is_meta else leaf.device
                set_leaf(model, attr, reader.get(key).to(device=target, dtype=leaf.dtype, copy=True))
            reader.release_file(fname)


def _rank_device(mesh) -> torch.device:
    from .state import PartialState

    return PartialState().device if mesh.device_type == "cuda" else torch.device(mesh.device_type)


def _shard_over_mesh(model: nn.Module, mesh, rules, fsdp_axes, source=None) -> nn.Module:
    """Split ``model`` over the mesh's ``tp`` dim (an MoE model over
    ``ep``; with ``rules``) and shard it with FSDP2 over the ``fsdp_axes``:
    a Llama per layer, then the root."""
    from torch.distributed.fsdp import fully_shard

    from .parallel.ep import apply_expert_parallel
    from .parallel.mesh import sub_mesh
    from .parallel.tp import apply_tensor_parallel

    axes = _fsdp_axes(mesh, fsdp_axes)
    if (rules is not None or axes) and hasattr(model, "unstack_layers"):
        model.unstack_layers()
    split = _split_dim(model)
    if rules is not None and split in (mesh.mesh_dim_names or ()):
        apply = apply_expert_parallel if split == "ep" else apply_tensor_parallel
        apply(model, sub_mesh(mesh, split), rules, defaults=False, source=source)
    if axes:
        fsdp_mesh = sub_mesh(mesh, axes)
        for layer in getattr(model, "layers", None) or []:
            fully_shard(layer, mesh=fsdp_mesh)
        fully_shard(model, mesh=fsdp_mesh, reshard_after_forward=False)
    return model


def dispatch_model(model: nn.Module, mesh=None, rules=None, fsdp_axes=("dp_shard",),
                   device="cuda") -> nn.Module:
    """Place a materialized model on one device (reference dispatch_model,
    big_modeling.py:315), or lay it over ``mesh``: on this rank's device,
    split over ``tp`` by ``rules`` (the Llama's tensor-parallel forward
    then runs on each rank's blocks and gathers the logits whole; an MoE
    Llama's experts over ``ep``, each rank running its own), sharded by
    FSDP2 over the ``fsdp_axes``. Every rank holds the same values
    before."""
    if mesh is None:
        return model.to(resolve_device(device))
    plan_shardings(model, mesh, rules=rules, fsdp_axes=fsdp_axes)
    return _shard_over_mesh(model.to(_rank_device(mesh)), mesh, rules, fsdp_axes)


def _load_over_mesh(model, checkpoint, mesh, rules, fsdp_axes, strict):
    """Each rank copies its ``tp`` blocks of every leaf from the memory-
    mapped checkpoint onto its card (whole leaves where nothing splits
    them), then FSDP2 shards them."""
    from .utils.serialization import SafetensorsReader

    plan_shardings(model, mesh, rules=rules, fsdp_axes=fsdp_axes)
    dev = _rank_device(mesh)
    with SafetensorsReader(checkpoint) as reader:
        missing = [key for key, _ in named_leaves(model) if key not in reader]
        if missing and strict:
            raise KeyError(f"Missing keys in checkpoint: {missing[:10]}"
                           f"{'...' if len(missing) > 10 else ''}")
        if rules is not None and getattr(model, "tensor_parallel_forward", False) \
                and _split_dim(model) in (mesh.mesh_dim_names or ()):
            def source(key, layer):
                value = reader.get(key)
                return value if layer is None else value[layer]

            return _shard_over_mesh(model, mesh, rules, fsdp_axes, source=source)
        for key, attr in named_leaves(model):
            if key in reader:
                leaf = get_leaf(model, attr)
                set_leaf(model, attr, reader.get(key).to(device=dev, dtype=leaf.dtype, copy=True))
    return _shard_over_mesh(model.to(dev), mesh, rules, fsdp_axes)


def load_checkpoint_and_dispatch(
    model: nn.Module,
    checkpoint: str,
    mesh=None,
    rules=None,
    fsdp_axes=("dp_shard",),
    strict: bool = True,
    device="cuda",
) -> nn.Module:
    """:func:`load_checkpoint_in_model` then :func:`dispatch_model` on
    ``device`` (reference big_modeling.py:520-658). With ``mesh``: the plan
    is checked first (:func:`plan_shardings`), then each rank reads only
    its ``tp`` blocks of each leaf (a model built empty is filled on its
    rank's card) and FSDP2 shards them over the ``fsdp_axes``."""
    if mesh is not None:
        return _load_over_mesh(model, checkpoint, mesh, rules, fsdp_axes, strict)
    load_checkpoint_in_model(model, checkpoint, strict=strict, device=device)
    return dispatch_model(model, device=device)


def offload_to(model: nn.Module, host: dict, device) -> nn.Module:
    """Remove the leaves named in ``host`` (attribute path -> host tensor)
    from ``model`` and copy them to ``device`` for every forward."""
    dev = resolve_device(device)
    for attr in host:
        owner, _, name = attr.rpartition(".")
        delattr(model.get_submodule(owner), name)
    replace_forward(model, lambda: {attr: t.to(dev) for attr, t in host.items()})
    return model


def cpu_offload(model: nn.Module, execution_mesh=None, execution_device="cuda") -> nn.Module:
    """Keep the parameters and buffers in host memory and copy them to
    ``execution_device`` for every forward (reference ``CpuOffload``,
    hooks.py:720): slower, for models beyond the card's memory. With
    ``execution_mesh`` (the forward's mesh, one card a rank), a Llama with
    a tensor-parallel forward keeps only this rank's blocks of the mesh's
    ``tp`` split in host memory (``parallel.tp.tensor_parallel_rules``)
    and runs its tensor-parallel forward on this rank's card over them; any
    other model keeps the whole of it."""
    if execution_mesh is None:
        host = {attr: get_leaf(model, attr).detach().cpu() for _, attr in named_leaves(model)}
        return offload_to(model, host, execution_device)
    from .parallel.mesh import sub_mesh
    from .parallel.tp import TensorParallel, tensor_parallel_plan

    names = execution_mesh.mesh_dim_names or ()
    if not (getattr(model, "tensor_parallel_forward", False) and "tp" in names):
        host = {attr: get_leaf(model, attr).detach().cpu() for _, attr in named_leaves(model)}
        return offload_to(model, host, _rank_device(execution_mesh))
    tp = TensorParallel(sub_mesh(execution_mesh, "tp"))
    host = {}
    for fqn, (_, _, dim) in tensor_parallel_plan(model, tp.size).items():
        whole = get_leaf(model, fqn).detach()
        host[fqn] = (whole if dim is None else whole.chunk(tp.size, dim)[tp.rank]).cpu().clone()
    model.tp = tp
    return offload_to(model, host, _rank_device(execution_mesh))
