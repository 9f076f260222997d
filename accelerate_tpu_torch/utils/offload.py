"""Disk offload: weights in memory-mapped files (counterpart of
``accelerate_tpu/utils/offload.py``).

The layout is the JAX package's (and the reference's, utils/offload.py
:25-104): one ``<key>.dat`` file of raw C-order bytes per leaf, keyed by its
tree path joined with ``"."``, and ``index.json`` mapping each key to its
``dtype`` name and ``shape`` (a scalar is stored as one element with shape
``[]``). bfloat16 is stored as its raw 16-bit patterns.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch
from torch import nn

from .modeling import get_leaf, named_leaves

__all__ = ["offload_state_dict", "OffloadedWeightsLoader", "disk_offload"]

# torch dtype <-> the index's dtype name (numpy's, ml_dtypes' "bfloat16")
_NAMES = {
    torch.float64: "float64", torch.float32: "float32", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int64: "int64", torch.int32: "int32",
    torch.int16: "int16", torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
}
_DTYPES = {name: dtype for dtype, name in _NAMES.items()}


def _flat(params: Any) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return {key: get_leaf(params, attr) for key, attr in named_leaves(params)}
    from .serialization import flatten_dict

    return flatten_dict(params)


def offload_state_dict(save_dir: str, params: Any) -> dict:
    """Write every leaf of a parameter tree or module to ``<key>.dat`` plus
    ``index.json``; returns the index."""
    os.makedirs(save_dir, exist_ok=True)
    index = {}
    for name, leaf in _flat(params).items():
        t = leaf.detach().to("cpu").contiguous().reshape(-1)
        with open(os.path.join(save_dir, f"{name}.dat"), "wb") as f:
            f.write(t.view(torch.uint8).numpy().data)
        index[name] = {"dtype": _NAMES[leaf.dtype], "shape": list(leaf.shape)}
    with open(os.path.join(save_dir, "index.json"), "w") as f:
        json.dump(index, f)
    return index


class OffloadedWeightsLoader:
    """Lazy dict-like view over an offload directory (reference :127):
    each item is a CPU tensor viewing its memory-mapped file."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        with open(os.path.join(save_dir, "index.json")) as f:
            self.index = json.load(f)

    def keys(self):
        return self.index.keys()

    def __len__(self):
        return len(self.index)

    def __contains__(self, key):
        return key in self.index

    def __getitem__(self, key: str) -> torch.Tensor:
        meta = self.index[key]
        dtype = _DTYPES[meta["dtype"]]
        shape = tuple(meta["shape"])
        path = os.path.join(self.save_dir, f"{key}.dat")
        # copy-on-write: a writable view for torch, the file is never written
        raw = np.memmap(path, dtype=np.uint8, mode="c")
        return torch.from_numpy(raw).view(dtype).reshape(shape)


def disk_offload(model: nn.Module, offload_dir: str, execution_device="cuda") -> nn.Module:
    """Write the model's parameters and buffers to ``offload_dir`` and run
    every forward on ``execution_device`` over copies read from those files
    (reference ``disk_offload``, big_modeling.py)."""
    from ..big_modeling import offload_to

    offload_state_dict(offload_dir, model)
    loader = OffloadedWeightsLoader(offload_dir)
    host = {attr: loader[key] for key, attr in named_leaves(model)}
    return offload_to(model, host, execution_device)
