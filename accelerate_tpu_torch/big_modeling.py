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

Meshes and sharding plans (``plan_shardings``, a ``mesh=`` argument) wait
for the distributed slice (ROADMAP A7) and raise.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

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


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "meshes and sharding plans are not ported yet (ROADMAP.md A7: "
            "distributed training); the port loads and runs a model on one device"
        )


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


def get_max_memory() -> dict[str, int]:
    """Usable memory per card: 0.9 of ``torch.cuda.mem_get_info``'s total
    (reference utils/modeling.py:757). Raises without a GPU."""
    resolve_device("cuda")
    return {str(i): int(torch.cuda.mem_get_info(i)[1] * 0.9)
            for i in range(torch.cuda.device_count())}


def plan_shardings(*args, **kwargs):
    """Sharding plans need a mesh (ROADMAP A7); raises."""
    _no_mesh(True)


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

    _no_mesh(mesh)
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


def dispatch_model(model: nn.Module, mesh=None, device="cuda") -> nn.Module:
    """Place a materialized model on one device (reference dispatch_model,
    big_modeling.py:315)."""
    _no_mesh(mesh)
    return model.to(resolve_device(device))


def load_checkpoint_and_dispatch(
    model: nn.Module,
    checkpoint: str,
    mesh=None,
    strict: bool = True,
    device="cuda",
) -> nn.Module:
    """:func:`load_checkpoint_in_model` then :func:`dispatch_model` on
    ``device`` (reference big_modeling.py:520-658)."""
    _no_mesh(mesh)
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


def cpu_offload(model: nn.Module, execution_device="cuda") -> nn.Module:
    """Keep the parameters and buffers in host memory and copy them to
    ``execution_device`` for every forward (reference ``CpuOffload``,
    hooks.py:720): slower, for models beyond the card's memory."""
    host = {attr: get_leaf(model, attr).detach().cpu() for _, attr in named_leaves(model)}
    return offload_to(model, host, execution_device)
