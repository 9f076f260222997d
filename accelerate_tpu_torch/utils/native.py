"""ctypes bridge to the host-side packing kernels of ``csrc/packing.cpp``
(counterpart of ``accelerate_tpu/utils/native.py``).

The port reads the repository's existing C++ source (it keeps no copy) and
builds it once with ``g++ -O3`` into ``build/native/`` of the checkout
(listed in ``.gitignore``). Every entry point has a NumPy version beside
the native one, as in the JAX package, and both give the same bytes;
:func:`native_available` says whether the native library loaded, so a
caller that must run the native path can require it.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

from ..logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "get_packing_lib",
    "native_available",
    "pack_ffd",
    "pack_contiguous",
    "fill_packed",
    "pack_dataset",
    "collate_padded",
    "collate_padded_flat",
    "packed_loss_mask",
    "packed_position_ids",
]

_REPO = Path(__file__).resolve().parents[2]
_SOURCE = _REPO / "csrc" / "packing.cpp"
_BUILD_DIR = _REPO / "build" / "native"


@functools.lru_cache(maxsize=1)
def get_packing_lib() -> Optional[ctypes.CDLL]:
    """Build (once, when the source is newer than the library) and load the
    native library; None when the source, ``g++`` or the build is missing
    (the reason is logged)."""
    if not _SOURCE.exists():
        logger.warning(f"native packing: {_SOURCE} not found; using the NumPy versions")
        return None
    out = _BUILD_DIR / "libaccel_packing.so"
    try:
        if not out.exists() or out.stat().st_mtime < _SOURCE.stat().st_mtime:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # build beside the target and rename: concurrent test workers
            # never load a half-written library
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
                                str(_SOURCE), "-o", tmp], check=True, capture_output=True, text=True)
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(out))
    except (OSError, subprocess.CalledProcessError) as exc:
        detail = getattr(exc, "stderr", "") or exc
        logger.warning(f"native packing: build or load failed ({detail}); using the NumPy versions")
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.pack_ffd.restype = ctypes.c_int64
    lib.pack_ffd.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.pack_contiguous.restype = ctypes.c_int64
    lib.pack_contiguous.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.fill_packed.restype = None
    lib.fill_packed.argtypes = [i32p, i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                ctypes.c_int64, i32p, i32p]
    lib.collate_padded.restype = None
    lib.collate_padded.argtypes = [i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                                   i32p, f32p]
    return lib


def native_available() -> bool:
    """Whether the native library built and loaded."""
    return get_packing_lib() is not None


def _pack_ffd_py(lengths: np.ndarray, capacity: int, bin_ids: np.ndarray) -> int:
    order = np.argsort(-lengths, kind="stable")
    remaining: list[int] = []
    for doc in order:
        ln = int(lengths[doc])
        if ln > capacity:
            bin_ids[doc] = -1
            continue
        for b, rem in enumerate(remaining):
            if rem >= ln:
                remaining[b] -= ln
                bin_ids[doc] = b
                break
        else:
            remaining.append(capacity - ln)
            bin_ids[doc] = len(remaining) - 1
    return len(remaining)


def pack_ffd(lengths, capacity: int):
    """First-fit-decreasing packing: (bin id per document, -1 when longer
    than ``capacity``; number of bins)."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    bin_ids = np.empty_like(lengths)
    lib = get_packing_lib()
    if lib is not None:
        n_bins = int(lib.pack_ffd(lengths, len(lengths), capacity, bin_ids))
    else:
        n_bins = _pack_ffd_py(lengths, capacity, bin_ids)
    return bin_ids, n_bins


def pack_contiguous(lengths, capacity: int):
    """Order-preserving greedy packing: (bin ids, number of bins)."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    bin_ids = np.empty_like(lengths)
    lib = get_packing_lib()
    if lib is not None:
        return bin_ids, int(lib.pack_contiguous(lengths, len(lengths), capacity, bin_ids))
    bin_id = used = n_bins = 0
    for i, ln in enumerate(lengths):
        if ln > capacity:
            bin_ids[i] = -1
            continue
        if used + ln > capacity:
            bin_id += 1
            used = 0
        bin_ids[i] = bin_id
        used += int(ln)
        n_bins = bin_id + 1
    return bin_ids, n_bins


def fill_packed(tokens, doc_starts, bin_ids, capacity: int, n_bins: int, pad_id: int = 0):
    """The (n_bins, capacity) int32 token and segment-id matrices (segment
    ids count each row's documents from 1; padding is 0)."""
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    doc_starts = np.ascontiguousarray(doc_starts, dtype=np.int64)
    bin_ids = np.ascontiguousarray(bin_ids, dtype=np.int64)
    out_tokens = np.full((n_bins, capacity), pad_id, dtype=np.int32)
    out_segments = np.zeros((n_bins, capacity), dtype=np.int32)
    lib = get_packing_lib()
    if lib is not None:
        lib.fill_packed(tokens, doc_starts, bin_ids, len(bin_ids), capacity, n_bins,
                        out_tokens.reshape(-1), out_segments.reshape(-1))
        return out_tokens, out_segments
    cursor = np.zeros(n_bins, dtype=np.int64)
    seg = np.zeros(n_bins, dtype=np.int32)
    for i, b in enumerate(bin_ids):
        if b < 0:
            continue
        ln = int(doc_starts[i + 1] - doc_starts[i])
        if cursor[b] + ln > capacity:
            continue
        seg[b] += 1
        sl = slice(int(cursor[b]), int(cursor[b]) + ln)
        out_tokens[b, sl] = tokens[doc_starts[i]:doc_starts[i + 1]]
        out_segments[b, sl] = seg[b]
        cursor[b] += ln
    return out_tokens, out_segments


def collate_padded_flat(flat, offsets, seq_len: int, pad_id: int = 0):
    """Padded collation from a flat (total,) int32 token buffer and (n+1,)
    offsets: ((n, seq_len) int32 tokens, (n, seq_len) f32 mask); longer
    sequences are truncated."""
    flat = np.ascontiguousarray(flat, dtype=np.int32)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    n = len(offsets) - 1
    out_tokens = np.empty((n, seq_len), dtype=np.int32)
    out_mask = np.empty((n, seq_len), dtype=np.float32)
    lib = get_packing_lib()
    if lib is not None:
        lib.collate_padded(flat, offsets, n, seq_len, pad_id, out_tokens.reshape(-1),
                           out_mask.reshape(-1))
        return out_tokens, out_mask
    out_tokens.fill(pad_id)
    out_mask.fill(0.0)
    for i in range(n):
        ln = min(int(offsets[i + 1] - offsets[i]), seq_len)
        out_tokens[i, :ln] = flat[offsets[i]:offsets[i] + ln]
        out_mask[i, :ln] = 1.0
    return out_tokens, out_mask


def collate_padded(docs, seq_len: Optional[int] = None, pad_id: int = 0):
    """Ragged 1-D int sequences as ((n, S) int32 tokens, (n, S) f32 mask),
    S = ``seq_len`` or the longest sequence."""
    n = len(docs)
    arrays = [np.asarray(d, dtype=np.int32).ravel() for d in docs]
    lengths = np.asarray([a.size for a in arrays], dtype=np.int64)
    if seq_len is None:
        seq_len = int(lengths.max()) if n else 0
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = np.concatenate(arrays) if n else np.zeros(0, np.int32)
    return collate_padded_flat(flat, offsets, seq_len, pad_id)


def pack_dataset(documents, seq_len: int, pad_id: int = 0, preserve_order: bool = False):
    """Variable-length token sequences packed into (N, seq_len) training
    rows and their segment ids (for segment-masked attention)."""
    lengths = np.asarray([len(d) for d in documents], dtype=np.int64)
    doc_starts = np.zeros(len(documents) + 1, dtype=np.int64)
    np.cumsum(lengths, out=doc_starts[1:])
    tokens = (np.concatenate([np.asarray(d, dtype=np.int32) for d in documents])
              if documents else np.zeros(0, np.int32))
    bin_ids, n_bins = (pack_contiguous if preserve_order else pack_ffd)(lengths, seq_len)
    return fill_packed(tokens, doc_starts, bin_ids, seq_len, n_bins, pad_id=pad_id)


def packed_loss_mask(segment_ids: np.ndarray) -> np.ndarray:
    """(N, S) segment ids as the (N, S) f32 next-token loss mask: position
    i trains only when tokens i and i + 1 are in the same (nonzero)
    document, as ``llama_loss``'s ``loss_mask`` reads it."""
    seg = np.asarray(segment_ids, dtype=np.int32)
    mask = np.zeros(seg.shape, dtype=np.float32)
    mask[:, :-1] = ((seg[:, :-1] == seg[:, 1:]) & (seg[:, :-1] > 0)).astype(np.float32)
    return mask


def packed_position_ids(segment_ids: np.ndarray) -> np.ndarray:
    """(N, S) segment ids as (N, S) int32 positions that restart at every
    packed document (0 on padding)."""
    seg = np.asarray(segment_ids, dtype=np.int32)
    n, s = seg.shape
    idx = np.arange(s, dtype=np.int32)[None, :].repeat(n, axis=0)
    change = np.ones((n, s), dtype=bool)
    change[:, 1:] = seg[:, 1:] != seg[:, :-1]
    start = np.maximum.accumulate(np.where(change, idx, 0), axis=1)
    pos = idx - start
    pos[seg == 0] = 0
    return pos
