"""How ``prepare_model`` distributes a model over the mesh's dims
(counterpart of ``accelerate_tpu/parallel/sharding.py``).

The JAX package writes a ``PartitionSpec`` per parameter and lets XLA
place the collectives. Here the data-parallel layouts are PyTorch's own:

* ``"ddp"`` (``dp_replicate`` only): ``DistributedDataParallel`` over the
  ``dp_replicate`` group, the gradients views into its buckets; a
  ``"bf16"``/``"fp16"`` comm hook is DDP's compress hook.
* ``"fsdp"`` (``dp_shard``): FSDP2 ``fully_shard`` on the 1-D
  ``("dp_shard",)`` mesh; a comm hook's dtype is the
  ``MixedPrecisionPolicy``'s ``reduce_dtype``.
* ``"hsdp"`` (both): ``fully_shard`` on the 2-D ``(dp_replicate,
  dp_shard)`` mesh: replicated over the first dim, sharded over the second.

Under ``tp`` (``tp_size > 1``, or a ``TensorParallelConfig``) the mesh is
the 3-D ``(dp_replicate, dp_shard, tp)`` one and the model is first laid
out over its ``tp`` sub-mesh (``parallel/tp.py``: ``DTensor`` blocks, the
Megatron forward), then:

* ``"tp"``: nothing else (no data-parallel dim);
* ``"tp_fsdp"`` (``dp_shard``): FSDP2 on the ``dp_shard`` sub-mesh of
  the same root, per layer: the standard FSDP2 + TP 2-D composition, each
  parameter a 2-D ``DTensor``;
* ``"tp_hsdp"`` (``dp_replicate``, with or without ``dp_shard``): FSDP2
  on the ``(dp_replicate, dp_shard)`` sub-mesh, HSDP's replication over
  the first dim (at ``dp_shard`` 1 a plain replication: DDP does not take
  ``DTensor`` parameters).

Under ``ep`` (an MoE model over ``ep_size > 1``) the mesh is the 3-D
``(dp_replicate, dp_shard, ep)`` one and the model is first laid out over
its ``ep`` sub-mesh (``parallel/ep.py``: the expert leaves split on their
expert dim, the rest replicated), then ``"ep"``, ``"ep_fsdp"`` and
``"ep_hsdp"`` shard it as the ``tp`` layouts do: the data-parallel
reductions run over the ranks of one ``ep`` index, never across ``ep``.

A Llama is sharded per layer, as the JAX package gathers one layer's
weights at a time inside its scanned layer (``gather_over_fsdp``): its
stacked ``(L, ...)`` leaves are re-registered as one module per layer
(``LlamaForCausalLM.unstack_layers``), each layer is one ``fully_shard``
unit, and the root (embedding, final norm, head) is the last. Any other
module: each direct child holding at least ``min_weight_size`` parameter
elements, then the root. FSDP2 shards on dim 0, so a scalar parameter is
left out of its units (``ignored_params``) and replicated: the optimizer
averages its gradient across the processes before it uses it, as DDP
would (the JAX package replicates parameters below ``min_weight_size``).

:func:`shard_model` returns the wrapped model and, for every parameter the
caller held before, the parameters that took its place and their module
names (``param_map``), so an optimizer built before ``prepare`` is pointed
at them and a checkpoint restacks the layers under the stacked keys.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
from torch import nn

__all__ = ["EP_LAYOUTS", "TP_LAYOUTS", "data_parallel_layout", "fp8_groups", "layout_mesh",
           "shard_model", "unwrap_data_parallel"]


TP_LAYOUTS = ("tp", "tp_fsdp", "tp_hsdp")
EP_LAYOUTS = ("ep", "ep_fsdp", "ep_hsdp")


def model_dim_of(layout: str) -> Optional[str]:
    """``"tp"`` or ``"ep"`` for a layout that splits the model over that
    dim, else None."""
    return layout.split("_")[0] if layout in TP_LAYOUTS + EP_LAYOUTS else None


def data_parallel_layout(pcfg, fsdp_plugin=None, ddp_handler=None) -> str:
    """``"ddp"``, ``"fsdp"``, ``"hsdp"``, ``"tp"``, ``"tp_fsdp"``,
    ``"tp_hsdp"``, their ``"ep"`` counterparts or ``"none"`` for a
    validated configuration: under ``tp`` (``tp_size`` above 1 or a
    ``tp_config``) or ``ep`` (``ep_size`` above 1), ``dp_replicate``
    above 1 replicates through HSDP, else ``dp_shard`` above 1 or an
    ``FSDPPlugin`` shards; without them, ``dp_shard`` above 1 or an
    ``FSDPPlugin`` shards (HSDP with ``dp_replicate`` above 1 too), else
    ``dp_replicate`` above 1 or a ``DistributedDataParallelKwargs`` handler
    replicates."""
    from ..parallelism_config import refuse_queued_dims

    refuse_queued_dims(pcfg.axis_sizes)
    dim = pcfg.model_dim
    if dim is not None:
        if pcfg.dp_replicate_size > 1:
            return f"{dim}_hsdp"
        return f"{dim}_fsdp" if pcfg.dp_shard_size > 1 or fsdp_plugin is not None else dim
    if pcfg.dp_shard_size > 1 or fsdp_plugin is not None:
        return "hsdp" if pcfg.dp_replicate_size > 1 else "fsdp"
    if pcfg.dp_replicate_size > 1 or ddp_handler is not None:
        return "ddp"
    return "none"


def layout_mesh(layout: str, pcfg, device_type: str):
    """The mesh a layout shards over."""
    from .mesh import build_hybrid_mesh, build_mesh, model_mesh_dims

    if model_dim_of(layout):
        names = model_mesh_dims(model_dim_of(layout))
        return build_mesh([pcfg.axis_sizes[n] for n in names], names, device_type)
    if layout == "hsdp":
        return build_hybrid_mesh((pcfg.dp_replicate_size, 1), (1, pcfg.dp_shard_size),
                                 ("dp_replicate", "dp_shard"), device_type)
    if layout == "fsdp":
        return build_mesh((pcfg.dp_shard_size,), ("dp_shard",), device_type)
    return build_mesh((pcfg.dp_replicate_size,), ("dp_replicate",), device_type)


def fp8_groups(layout: str, mesh):
    """The ``ops.fp8.Fp8Groups`` of a layout's fp8 scales, as the JAX amax
    of a sharded array spans the mesh: activations and cotangents over
    every rank of ``mesh`` (the data-parallel ranks' rows, the ``tp``
    ranks' blocks), weights over ``tp`` (FSDP2 hands a product the gathered
    weight, DDP a whole one). Each is a group of its own
    (``ops.collectives.mirror_group``): the amax reductions run inside the
    backward while DDP's bucket reductions and FSDP2's collectives run on
    theirs. Over one rank (or no mesh) no group and no collective."""
    from ..ops.collectives import mirror_group
    from ..ops.fp8 import Fp8Groups

    if mesh is None or mesh.mesh.numel() == 1:
        return Fp8Groups()
    names = mesh.mesh_dim_names
    weight = None
    if layout in TP_LAYOUTS and mesh.size(names.index("tp")) > 1:
        weight = mirror_group(mesh, "tp")
    return Fp8Groups(act=mirror_group(mesh, tuple(names)), weight=weight)


def unwrap_data_parallel(model: nn.Module) -> nn.Module:
    """The module inside a ``DistributedDataParallel``, else ``model``."""
    from torch.nn.parallel import DistributedDataParallel

    return model.module if isinstance(model, DistributedDataParallel) else model


def _fsdp_mp_policy(policy, ddp_handler, casts_per_use: bool):
    from torch.distributed.fsdp import MixedPrecisionPolicy as FSDPMixedPrecision

    reduce_dtype = ddp_handler.gradient_dtype if ddp_handler is not None else None
    if casts_per_use or policy is None or policy.compute_dtype == policy.param_dtype:
        return FSDPMixedPrecision(reduce_dtype=reduce_dtype)
    # a module without its own casts: FSDP2 casts the gathered parameters
    # (the MixedPrecisionModule of one device) and reduces in f32
    return FSDPMixedPrecision(param_dtype=getattr(torch, policy.compute_dtype),
                              reduce_dtype=reduce_dtype or getattr(torch, policy.param_dtype),
                              output_dtype=getattr(torch, policy.output_dtype))


def shard_model(model: nn.Module, layout: str, mesh, device: torch.device, fsdp_plugin=None,
                ddp_handler=None, policy=None, tp_rules=None) -> tuple:
    """``(wrapped model, param_map, replicated, tp_replicated)``: ``model``
    (already on ``device``) wrapped for ``layout`` over ``mesh``;
    ``param_map`` maps each parameter of ``model`` before the call (by id,
    weakly) to ``(new parameters, module names, stacked)``;
    ``replicated`` lists the parameters FSDP2 left whole, whose gradients
    the optimizer averages over the data-parallel ranks;
    ``tp_replicated`` the parameters replicated over ``tp``, whose
    gradients it sums over ``tp`` (the ``tp_rules`` in front of the
    tensor-parallel defaults)."""
    from ..model import unwrap_model

    inner = unwrap_model(model)
    before = {name: p for name, p in inner.named_parameters()}
    if layout == "ddp":
        from torch.distributed.algorithms.ddp_comm_hooks import default_hooks
        from torch.nn.parallel import DistributedDataParallel

        group = mesh.get_group("dp_replicate")
        # the gradients are views into DDP's reduction buckets: no second
        # copy of them (7.7 GB of f32 at Llama-3-8B width and 4 layers)
        wrapped = DistributedDataParallel(
            model, device_ids=[device.index] if device.type == "cuda" else None,
            process_group=group, gradient_as_bucket_view=True)
        hook = {"bf16": default_hooks.bf16_compress_hook,
                "fp16": default_hooks.fp16_compress_hook}.get(
            ddp_handler.comm_hook if ddp_handler is not None else "no")
        if hook is not None:
            wrapped.register_comm_hook(group, hook)
        return wrapped, {id(p): (weakref.ref(p), ([p], [name], False))
                         for name, p in before.items()}, [], []

    from torch.distributed.fsdp import fully_shard

    from .mesh import sub_mesh

    tp_replicated = []
    dim = model_dim_of(layout)
    if dim is not None:
        if hasattr(inner, "unstack_layers"):
            inner.unstack_layers()
        if dim == "tp":
            from .tp import apply_tensor_parallel

            tp_replicated = apply_tensor_parallel(inner, sub_mesh(mesh, "tp"), tp_rules)
        else:  # every replicated leaf's gradient is whole on each ep rank: no sum
            from .ep import apply_expert_parallel

            apply_expert_parallel(inner, sub_mesh(mesh, "ep"))
        if layout == dim:
            return inner, _param_map(inner, before), [], tp_replicated
        mesh = sub_mesh(mesh, "dp_shard" if layout.endswith("_fsdp")
                        else ("dp_replicate", "dp_shard"))
    tp_names = [n for n, p in inner.named_parameters() if any(p is q for q in tp_replicated)]
    plugin = fsdp_plugin
    reshard = plugin.reshard_after_forward if plugin is not None else True
    casts = getattr(inner, "casts_per_use", False)
    kw = dict(mesh=mesh, reshard_after_forward=reshard,
              mp_policy=_fsdp_mp_policy(policy, ddp_handler, casts))
    scalars = [p for p in inner.parameters() if p.dim() == 0]
    if scalars:
        kw["ignored_params"] = set(scalars)
    if hasattr(inner, "unstack_layers"):
        inner.unstack_layers()
        for layer in inner.layers:
            fully_shard(layer, **kw)
    else:
        min_size = plugin.min_weight_size if plugin is not None else 2**10
        for child in inner.children():
            if sum(p.numel() for p in child.parameters()) >= min_size:
                fully_shard(child, **kw)
    # the root's weights stay gathered until its backward: a chunked loss
    # takes the head from the forward's output, after the root's forward
    fully_shard(inner, **{**kw, "reshard_after_forward": False})
    # FSDP2 put new parameters in place of the tp-replicated ones
    named = dict(inner.named_parameters())
    return inner, _param_map(inner, before), scalars, [named[n] for n in tp_names]


def _param_map(inner: nn.Module, before: dict) -> dict:
    """``{id(parameter before shard_model): (a weak reference to it, (its
    parameters now, module names, stacked))}``. Weak: once the optimizer
    is pointed at the new parameters nothing keeps the old ones (a model's
    whole f32 weights) alive."""
    after = dict(inner.named_parameters())
    if hasattr(inner, "checkpoint_fqns"):
        key_of = {".".join(path): name for path, name in inner._paths}
        entries = [(before[key_of[key]], ([after[f] for f in fqns], fqns, stacked))
                   for key, fqns, stacked in inner.checkpoint_fqns()]
    else:
        entries = [(p, ([after[name]], [name], False)) for name, p in before.items()]
    return {id(p): (weakref.ref(p), entry) for p, entry in entries}


def _mapped(param_map: dict, p):
    """``p``'s entry in a :func:`_param_map`, or None."""
    ref, entry = param_map.get(id(p), (None, None))
    return entry if ref is not None and ref() is p else None


def remap_optimizer(optimizer: torch.optim.Optimizer, param_map: dict) -> Optional[list]:
    """Point ``optimizer``'s param groups at the parameters that replaced
    its own (a stacked leaf by its L per-layer ones, in layer order).
    Returns, per original parameter in order, ``(module names, stacked)``,
    the layout a checkpoint restacks by; None when nothing was replaced."""
    if not any(_mapped(param_map, p) for g in optimizer.param_groups for p in g["params"]):
        return None
    if optimizer.state:
        raise ValueError("prepare the optimizer before its first step: its state is keyed by the "
                         "parameters that prepare_model replaced")
    layout, groups = [], []
    for group in optimizer.param_groups:
        new, idx = [], []
        for p in group["params"]:
            params, fqns, stacked = _mapped(param_map, p) or ([p], None, False)
            if fqns is None:
                raise ValueError("the optimizer holds a parameter of no prepared model")
            new.extend(params)
            idx.append(len(layout))
            layout.append((fqns, stacked))
        group["params"] = new
        groups.append(idx)
    return [layout, groups]
