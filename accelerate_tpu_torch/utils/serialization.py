"""Safetensors checkpoints without the ``safetensors`` package (counterpart
of ``accelerate_tpu/utils/serialization.py``).

The machine with the card has no ``safetensors``, so the port reads and
writes the format itself: a little-endian u64 header length, a JSON header
mapping each tensor name to its ``dtype``, ``shape`` and ``data_offsets``
(begin and end byte in the data region; ``__metadata__`` holds string
pairs), padded with spaces to a multiple of 8 bytes, then the raw
little-endian bytes of every tensor, back to back. The writer lays tensors
out widest dtype first, so each starts aligned to its element size.
Sharded checkpoints are ``model-0000i-of-0000n.safetensors`` files plus
``model.safetensors.index.json`` (the reference's ``save_model`` layout), so
checkpoints interchange with the JAX package and the torch ecosystem.
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Any

import numpy as np
import torch

from .constants import SAFE_WEIGHTS_INDEX_NAME, SAFE_WEIGHTS_NAME, SAFE_WEIGHTS_PATTERN_NAME

__all__ = [
    "flatten_dict",
    "unflatten_dict",
    "parse_size",
    "save_sharded_safetensors",
    "load_sharded_safetensors",
    "SafetensorsReader",
]

_SIZE_UNITS = {"KB": 2**10, "MB": 2**20, "GB": 2**30, "TB": 2**40}

# safetensors dtype name -> (torch dtype, numpy dtype of its bytes); bf16 has
# no numpy type here, so its bytes are read as uint16 and viewed as bf16
_DTYPES = {
    "F64": (torch.float64, np.float64),
    "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16),
    "BF16": (torch.bfloat16, np.uint16),
    "I64": (torch.int64, np.int64),
    "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16),
    "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8),
    "BOOL": (torch.bool, np.bool_),
}
_NAMES = {torch_dtype: name for name, (torch_dtype, _) in _DTYPES.items()}


def parse_size(size: str) -> int:
    m = re.fullmatch(r"(\d+(?:\.\d+)?)\s*(KB|MB|GB|TB)?", size.strip(), re.IGNORECASE)
    if not m:
        raise ValueError(f"Cannot parse size {size!r}")
    value = float(m.group(1))
    unit = (m.group(2) or "").upper()
    return int(value * _SIZE_UNITS.get(unit, 1))


def flatten_dict(tree: Any, sep: str = ".", prefix: str = "") -> dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{sep}{k}" if prefix else str(k)
            if isinstance(v, (dict, list, tuple)):
                out.update(flatten_dict(v, sep=sep, prefix=key))
            else:
                out[key] = v
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            key = f"{prefix}{sep}{i}" if prefix else str(i)
            if isinstance(v, (dict, list, tuple)):
                out.update(flatten_dict(v, sep=sep, prefix=key))
            else:
                out[key] = v
    else:
        out[prefix or "value"] = tree
    return out


def unflatten_dict(flat: dict[str, Any], sep: str = ".") -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _write_file(path: str, tensors: dict[str, torch.Tensor]) -> None:
    """One safetensors file; tensors are copied to the host one at a time."""
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict[str, Any] = {"__metadata__": {"format": "pt"}}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().to("cpu").contiguous().reshape(-1)
            f.write(t.view(torch.uint8).numpy().data)


def save_sharded_safetensors(
    params: Any, save_directory: str, max_shard_size: str = "10GB"
) -> list[str]:
    """Split a parameter tree (nested dicts of tensors; keys joined with
    ``"."``) into files of at most ``max_shard_size`` bytes, plus the index
    when there is more than one."""
    flat = {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in flatten_dict(params).items()}
    limit = parse_size(max_shard_size)

    shards: list[dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for key, t in flat.items():
        nbytes = t.numel() * t.element_size()
        if sizes[-1] + nbytes > limit and shards[-1]:
            shards.append({})
            sizes.append(0)
        shards[-1][key] = t
        sizes[-1] += nbytes

    os.makedirs(save_directory, exist_ok=True)
    if len(shards) == 1:
        path = os.path.join(save_directory, SAFE_WEIGHTS_NAME)
        _write_file(path, shards[0])
        return [path]

    written = []
    index = {"metadata": {"total_size": sum(sizes)}, "weight_map": {}}
    n = len(shards)
    for i, shard in enumerate(shards):
        fname = SAFE_WEIGHTS_PATTERN_NAME.format(suffix=f"-{i + 1:05d}-of-{n:05d}")
        _write_file(os.path.join(save_directory, fname), shard)
        written.append(os.path.join(save_directory, fname))
        for key in shard:
            index["weight_map"][key] = fname
    with open(os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), "w") as f:
        json.dump(index, f, indent=2)
    return written


class _MappedFile:
    """A safetensors file's header and its data region, memory-mapped
    copy-on-write (writable views for ``torch.from_numpy``; the file is
    never written)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        self.header = header
        start = 8 + n
        if os.path.getsize(path) > start:
            self.data = np.memmap(path, dtype=np.uint8, mode="c", offset=start)
        else:  # only empty tensors: nothing to map
            self.data = np.empty(0, np.uint8)

    def get(self, name: str) -> torch.Tensor:
        info = self.header[name]
        torch_dtype, np_dtype = _DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        arr = self.data[begin:end].view(np_dtype)
        if arr.ctypes.data % arr.itemsize:  # a writer that did not align
            arr = arr.copy()
        t = torch.from_numpy(arr)
        if torch_dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        return t.reshape(info["shape"])


class SafetensorsReader:
    """Lazy tensor-by-tensor access to a (possibly sharded) safetensors
    checkpoint, the streamed-load primitive behind
    ``load_checkpoint_in_model``. Each shard file is memory-mapped and
    :meth:`get` returns a CPU tensor viewing the mapping (no copy); callers
    copy it where it goes. Pages a view touches stay resident until the
    file is released and its views are gone, so callers group reads per
    file (:meth:`file_of`) and :meth:`release_file` between groups: at most
    one shard's pages are resident. Use as a context manager."""

    def __init__(self, load_directory: str):
        self._dir = load_directory
        self._files: dict[str, str] = {}  # tensor name -> file path
        self._handles: dict[str, _MappedFile] = {}
        index_path = os.path.join(load_directory, SAFE_WEIGHTS_INDEX_NAME)
        single = os.path.join(load_directory, SAFE_WEIGHTS_NAME)
        if os.path.exists(index_path):
            with open(index_path) as f:
                index = json.load(f)
            for name, fname in index["weight_map"].items():
                self._files[name] = os.path.join(load_directory, fname)
        elif os.path.exists(single):
            for name in self._open(single).header:
                self._files[name] = single
        else:
            found = False
            for fname in sorted(os.listdir(load_directory)):
                if fname.endswith(".safetensors"):
                    found = True
                    path = os.path.join(load_directory, fname)
                    for name in self._open(path).header:
                        self._files[name] = path
            if not found:
                raise FileNotFoundError(f"No safetensors files under {load_directory}")

    def _open(self, path: str) -> _MappedFile:
        handle = self._handles.get(path)
        if handle is None:
            handle = self._handles[path] = _MappedFile(path)
        return handle

    def keys(self):
        return self._files.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._files

    def file_of(self, name: str) -> str:
        """Which shard file holds ``name``."""
        return self._files[name]

    def release_file(self, path: str) -> None:
        """Drop the reader's mapping of ``path``; it is unmapped once the
        tensors viewing it are gone."""
        self._handles.pop(path, None)

    def get(self, name: str) -> torch.Tensor:
        return self._open(self._files[name]).get(name)

    def close(self) -> None:
        self._handles.clear()

    def __enter__(self) -> "SafetensorsReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_sharded_safetensors(load_directory: str) -> dict[str, torch.Tensor]:
    """Load a (possibly sharded) safetensors checkpoint into a flat dict of
    CPU tensors (copies: no file stays mapped)."""
    with SafetensorsReader(load_directory) as reader:
        by_file: dict[str, list] = {}
        for name in reader.keys():
            by_file.setdefault(reader.file_of(name), []).append(name)
        flat = {}
        for path, names in by_file.items():
            flat.update({name: reader.get(name).clone() for name in names})
            reader.release_file(path)
        return flat
