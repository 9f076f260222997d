"""How ``prepare_model`` distributes a model over the data-parallel dims
(counterpart of ``accelerate_tpu/parallel/sharding.py``).

The JAX package writes a ``PartitionSpec`` per parameter and lets XLA
place the collectives. Here the three layouts are PyTorch's own:

* ``"ddp"`` (``dp_replicate`` only): ``DistributedDataParallel`` over the
  ``dp_replicate`` group, the gradients views into its buckets; a
  ``"bf16"``/``"fp16"`` comm hook is DDP's compress hook.
* ``"fsdp"`` (``dp_shard``): FSDP2 ``fully_shard`` on the 1-D
  ``("dp_shard",)`` mesh; a comm hook's dtype is the
  ``MixedPrecisionPolicy``'s ``reduce_dtype``.
* ``"hsdp"`` (both): ``fully_shard`` on the 2-D ``(dp_replicate,
  dp_shard)`` mesh: replicated over the first dim, sharded over the second.

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

from typing import Optional

import torch
from torch import nn

__all__ = ["data_parallel_layout", "layout_mesh", "shard_model", "unwrap_data_parallel"]


def data_parallel_layout(pcfg, fsdp_plugin=None, ddp_handler=None) -> str:
    """``"ddp"``, ``"fsdp"``, ``"hsdp"`` or ``"none"`` for a validated
    configuration: ``dp_shard`` above 1 or an ``FSDPPlugin`` shards (HSDP
    with ``dp_replicate`` above 1 too); else ``dp_replicate`` above 1 or a
    ``DistributedDataParallelKwargs`` handler replicates."""
    from ..parallelism_config import refuse_queued_dims

    refuse_queued_dims(pcfg.axis_sizes)
    if pcfg.dp_shard_size > 1 or fsdp_plugin is not None:
        return "hsdp" if pcfg.dp_replicate_size > 1 else "fsdp"
    if pcfg.dp_replicate_size > 1 or ddp_handler is not None:
        return "ddp"
    return "none"


def layout_mesh(layout: str, pcfg, device_type: str):
    """The mesh a layout shards over."""
    from .mesh import build_hybrid_mesh, build_mesh

    if layout == "hsdp":
        return build_hybrid_mesh((pcfg.dp_replicate_size, 1), (1, pcfg.dp_shard_size),
                                 ("dp_replicate", "dp_shard"), device_type)
    if layout == "fsdp":
        return build_mesh((pcfg.dp_shard_size,), ("dp_shard",), device_type)
    return build_mesh((pcfg.dp_replicate_size,), ("dp_replicate",), device_type)


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
                ddp_handler=None, policy=None) -> tuple:
    """``(wrapped model, param_map, replicated)``: ``model`` (already on
    ``device``) wrapped for ``layout`` over ``mesh``; ``param_map`` maps
    each parameter of ``model`` before the call to ``(new parameters,
    module names, stacked)``; ``replicated`` lists the parameters FSDP2
    left whole, whose gradients the optimizer averages."""
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
        return wrapped, {p: ([p], [name], False) for name, p in before.items()}, []

    from torch.distributed.fsdp import fully_shard

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
    fully_shard(inner, **kw)
    after = dict(inner.named_parameters())
    if hasattr(inner, "checkpoint_fqns"):
        key_of = {".".join(path): name for path, name in inner._paths}
        pmap = {before[key_of[key]]: ([after[f] for f in fqns], fqns, stacked)
                for key, fqns, stacked in inner.checkpoint_fqns()}
    else:
        pmap = {p: ([after[name]], [name], False) for name, p in before.items()}
    return inner, pmap, scalars


def remap_optimizer(optimizer: torch.optim.Optimizer, param_map: dict) -> Optional[list]:
    """Point ``optimizer``'s param groups at the parameters that replaced
    its own (a stacked leaf by its L per-layer ones, in layer order).
    Returns, per original parameter in order, ``(module names, stacked)``,
    the layout a checkpoint restacks by; None when nothing was replaced."""
    if not any(p in param_map for g in optimizer.param_groups for p in g["params"]):
        return None
    if optimizer.state:
        raise ValueError("prepare the optimizer before its first step: its state is keyed by the "
                         "parameters that prepare_model replaced")
    layout, groups = [], []
    for group in optimizer.param_groups:
        new, idx = [], []
        for p in group["params"]:
            params, fqns, stacked = param_map.get(p, ([p], None, False))
            if fqns is None:
                raise ValueError("the optimizer holds a parameter of no prepared model")
            new.extend(params)
            idx.append(len(layout))
            layout.append((fqns, stacked))
        group["params"] = new
        groups.append(idx)
    return [layout, groups]
