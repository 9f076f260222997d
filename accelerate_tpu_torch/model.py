"""Mixed-precision model wrapping (counterpart of ``accelerate_tpu/model.py``).

The JAX package bundles ``apply_fn`` and a parameter pytree into a
``Model``; in PyTorch an ``nn.Module`` already is that unit, so no bundle is
ported. What stays is the mixed-precision forward (``Model._mp_apply``):
float parameters cast to the policy's compute dtype for the call, float
outputs cast to its output dtype, with the master parameters untouched (the
cast is differentiable, so their gradients arrive in the parameter dtype).
"""

from __future__ import annotations

import torch
from torch import nn

from .utils.dataclasses import MixedPrecisionPolicy

__all__ = ["MixedPrecisionModule", "prepare_model", "unwrap_model"]


class MixedPrecisionModule(nn.Module):
    """Runs ``module`` with its float parameters cast to the policy's
    compute dtype (through :func:`torch.func.functional_call`) and its float
    outputs cast to the output dtype. The wrapped module's parameters are
    this module's, so an optimizer built on either updates both."""

    def __init__(self, module: nn.Module, policy: MixedPrecisionPolicy):
        super().__init__()
        self.module = module
        self.policy = policy

    def forward(self, *args, **kwargs):
        params = self.policy.cast_to_compute(dict(self.module.named_parameters()))
        out = torch.func.functional_call(self.module, params, args, kwargs)
        return self.policy.cast_to_output(out)


def prepare_model(model: nn.Module, policy: MixedPrecisionPolicy, device) -> nn.Module:
    """``model`` on ``device``, wrapped in :class:`MixedPrecisionModule` when
    the policy computes in another dtype than the parameters and the model
    does not cast per use itself (a module with ``casts_per_use = True``,
    such as :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM`,
    casts each weight where it is used)."""
    model = model.to(device)
    if policy.compute_dtype == policy.param_dtype and policy.output_dtype == policy.param_dtype:
        return model
    if getattr(model, "casts_per_use", False) or isinstance(model, MixedPrecisionModule):
        return model
    return MixedPrecisionModule(model, policy)


def unwrap_model(model: nn.Module) -> nn.Module:
    """The module inside a :class:`MixedPrecisionModule` or a
    ``DistributedDataParallel`` (either or both), else ``model``. An FSDP2
    module is its own (``fully_shard`` wraps nothing)."""
    from torch.nn.parallel import DistributedDataParallel

    while isinstance(model, (MixedPrecisionModule, DistributedDataParallel)):
        model = model.module
    return model
