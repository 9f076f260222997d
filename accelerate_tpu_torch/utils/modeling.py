"""Model size and memory estimates over the port's parameter trees, and the
leaf plumbing the big-model helpers share (counterpart of
``accelerate_tpu/utils/modeling.py``).

A parameter tree is either nested dicts of tensors (the port's ``params``
form; paths joined with ``"/"`` as in the JAX package) or an
``nn.Module``: a :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM`
is walked by its tree paths, any other module by its parameter and buffer
names. Meta tensors count by shape and dtype, so an empty model built
under ``init_empty_weights`` can be sized before it is loaded. A quantized
leaf (an ``nn.Module`` in the tree) counts its buffers.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable

import numpy as np
import torch
from torch import nn

__all__ = [
    "dtype_byte_size",
    "compute_module_sizes",
    "calculate_maximum_sizes",
    "estimate_training_memory",
    "find_tied_parameters",
    "named_leaves",
    "replace_forward",
]

_DTYPE_BYTES = {
    "float64": 8,
    "float32": 4,
    "float16": 2,
    "bfloat16": 2,
    "int64": 8,
    "int32": 4,
    "int16": 2,
    "int8": 1,
    "uint8": 1,
    "bool": 1,
    "float8_e4m3fn": 1,
    "float8_e5m2": 1,
    "int4": 0.5,
}


def dtype_byte_size(dtype) -> float:
    """Bytes per element of a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype)
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = str(np.dtype(dtype))
    for key, size in _DTYPE_BYTES.items():
        if key in name:
            return size
    return 4


def named_leaves(module: nn.Module) -> list[tuple[str, str]]:
    """(checkpoint key, attribute path) of every parameter and buffer of
    ``module``. The key is the leaf's tree path joined with ``"."`` (the JAX
    package's checkpoint key); the attribute path is what
    ``get_parameter`` and ``torch.func.functional_call`` take. A module
    that names its leaves itself (``checkpoint_keys``) is taken at its
    word; for any other the two are its parameter or buffer name."""
    keys = getattr(module, "checkpoint_keys", None)
    if keys is not None:
        return keys()
    return [(name, name) for name, _ in itertools.chain(module.named_parameters(),
                                                        module.named_buffers())]


def get_leaf(module: nn.Module, attr_path: str):
    owner, _, attr = attr_path.rpartition(".")
    return getattr(module.get_submodule(owner), attr)


def set_leaf(module: nn.Module, attr_path: str, value) -> None:
    """Put ``value`` (a tensor, or a module replacing a parameter) at
    ``attr_path``; a tensor replacing a parameter becomes a parameter with
    the old one's ``requires_grad``."""
    owner_name, _, attr = attr_path.rpartition(".")
    owner = module.get_submodule(owner_name)
    old = getattr(owner, attr, None)
    if isinstance(value, nn.Module) or isinstance(old, nn.Module):
        delattr(owner, attr)
    elif isinstance(old, nn.Parameter):
        value = nn.Parameter(value, requires_grad=old.requires_grad)
    setattr(owner, attr, value)


def replace_forward(module: nn.Module, make_leaves: Callable[[], dict]) -> None:
    """Run ``module``'s forward with the leaves ``make_leaves()`` returns
    per call (attribute path -> tensor), through
    ``torch.func.functional_call``: the way the JAX package re-binds a
    model's ``apply_fn`` over other parameters. The caller has removed
    those leaves from the module."""

    def forward(*args, **kwargs):
        leaves = make_leaves()
        del module.forward  # the class's own forward runs inside functional_call
        try:
            return torch.func.functional_call(module, leaves, args, kwargs)
        finally:
            module.forward = forward

    module.forward = forward


def _flat(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _flat(v, path)
        else:
            yield path, v


def _iter_leaves(params: Any):
    """(``"/"``-joined path, tensor) of every tensor in a tree or module."""
    if isinstance(params, nn.Module):
        items = [(key.replace(".", "/"), get_leaf(params, attr)) for key, attr in named_leaves(params)]
    else:
        items = list(_flat(params))
    for path, leaf in items:
        if isinstance(leaf, nn.Module):  # a quantized leaf: its buffers
            for name, buf in leaf.named_buffers():
                yield f"{path}/{name}", buf
        else:
            yield path, leaf


def _nbytes(leaf, dtype=None) -> float:
    return float(np.prod(tuple(leaf.shape) or (1,))) * dtype_byte_size(
        dtype if dtype is not None else leaf.dtype)


def compute_module_sizes(params: Any, dtype=None) -> dict[str, float]:
    """Size in bytes per module prefix (reference utils/modeling.py:1085)."""
    sizes: dict[str, float] = {"": 0}
    for path, leaf in _iter_leaves(params):
        nbytes = _nbytes(leaf, dtype)
        parts = path.split("/")
        for i in range(len(parts) + 1):
            prefix = "/".join(parts[:i])
            sizes[prefix] = sizes.get(prefix, 0) + nbytes
    return sizes


def calculate_maximum_sizes(params: Any) -> tuple[float, tuple[str, float]]:
    """(total bytes, (largest leaf path, bytes)), reference
    utils/modeling.py:1067."""
    total = 0.0
    largest = ("", 0.0)
    for path, leaf in _iter_leaves(params):
        nbytes = _nbytes(leaf)
        total += nbytes
        if nbytes > largest[1]:
            largest = (path, nbytes)
    return total, largest


def estimate_training_memory(
    num_params: float,
    dtype: str = "bfloat16",
    optimizer: str = "adam",
    gradient_dtype: str = "float32",
    master_dtype: str = "float32",
) -> dict[str, float]:
    """Adam-training memory estimate in bytes (role of the reference's
    estimate-memory training table, commands/estimate.py:224-310)."""
    p = num_params
    weights = p * dtype_byte_size(dtype)
    master = p * dtype_byte_size(master_dtype) if master_dtype != dtype else 0
    grads = p * dtype_byte_size(gradient_dtype)
    opt_mult = {"adam": 2, "adamw": 2, "adafactor": 0.5, "sgd": 0, "momentum": 1}.get(
        optimizer.lower(), 2
    )
    opt_states = p * 4 * opt_mult
    total = weights + master + grads + opt_states
    return {
        "weights": weights,
        "master_weights": master,
        "gradients": grads,
        "optimizer_states": opt_states,
        "total": total,
    }


def find_tied_parameters(params: Any) -> list[list[str]]:
    """Groups of leaves sharing one storage (reference utils/modeling.py:567,
    by ``untyped_storage().data_ptr()``). Meta tensors have no storage:
    only the same tensor object twice counts as tied there."""
    seen: dict[Any, list[str]] = {}
    for path, leaf in _iter_leaves(params):
        key = (id(leaf),) if leaf.is_meta else (leaf.device, leaf.untyped_storage().data_ptr())
        seen.setdefault(key, []).append(path)
    return [group for group in seen.values() if len(group) > 1]
