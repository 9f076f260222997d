"""Paged KV cache: block pool, block tables and copy-on-write prefix
caching (counterpart of ``accelerate_tpu/kvcache.py``).

* **Block pool + block tables**: one device pool per K and V of shape
  ``(layers, num_blocks, block_size, kv_heads, head_dim)``; each slot owns
  a row of a host-side table mapping its logical positions to pool blocks.
* **Admission by free blocks**: a request needs ``ceil((prompt + budget) /
  block_size)`` blocks, so short requests stop paying for long ones.
* **Copy-on-write prefix caching**: full prompt blocks register under the
  exact block-aligned prompt-prefix bytes; a later request with the same
  prefix takes a reference on the existing blocks. Zero-reference
  registered blocks park in an LRU "cached" tier, evicted only on demand.

Safety invariants (why recycling a slot or a block cannot leak KV):

* Block 0 is the reserved **null block**: vacant and retired slots' table
  rows point at it, so their masked per-step writes land in a sink nobody
  attends (``k_pos <= pos`` masking gives unallocated positions exactly 0
  weight).
* A live slot writes position ``p`` in the same step that first attends
  it, so blocks recycled from an earlier occupant never show stale KV.
* Decode writes land at ``pos >= prompt_len`` while shared blocks cover
  only full prompt blocks, so shared content is never written after it is
  registered (re-running a shared prefix's prefill rewrites the same bytes).

* **int8 pool** (``paged_int8``): each pool leaf is ``{"q": int8 (L, NB,
  bs, kvh, hd), "s": f32 (L, NB, bs)}``, symmetric with one scale per
  (layer, block, position) (:func:`kv_quantize`); every commit quantizes,
  every read dequantizes.
* **Window commits** (speculative verify and chunked prefill): only the
  first ``count[b]`` columns of a window land; the rest, and positions past
  the row, are dropped, never clamped onto live positions.

Device tensors are updated in place (the JAX package rebuilt them
functionally). The host-RAM spill tier is not ported yet (ROADMAP.md A3).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .utils.fault import EngineCapacityError

__all__ = [
    "KV_BACKENDS",
    "kv_quantize",
    "kv_dequantize",
    "KVCacheBackend",
    "DenseKVBackend",
    "PagedKVBackend",
    "PagedBlockPool",
    "PagedKVLayout",
    "make_kv_backend",
]

KV_BACKENDS = ("dense", "paged", "paged_int8")

_NULL_BLOCK = 0  # reserved garbage sink; never allocated, never attended


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` without blocking the host on the
    device's queue: through pinned memory and a non-blocking copy (the
    caching host allocator keeps the staging buffer alive until the copy
    has run)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


# ------------------------------------------------------------------ int8 ops
def kv_quantize(x: torch.Tensor):
    """Symmetric int8 quantization with one f32 scale per leading position:
    ``x`` is ``(..., kvh, hd)``, the amax reduces over the last two axes
    (clamped at 1e-6). ``round`` is half-to-even and the division a true
    division, as ``jnp.round(x / scale)``, so the bytes equal the JAX
    package's. Deterministic: identical inputs give identical bytes, which
    shared-prefix rewrites rely on. Returns ``(q int8, scale f32 (...))``."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-1, -2)).clamp_min(1e-6)
    scale = amax / 127.0
    q = torch.round(xf / scale[..., None, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`: ``q (..., kvh, hd)`` times the
    per-position ``scale (...)``, in ``dtype``."""
    return (q.float() * scale[..., None, None]).to(dtype)


def _set_rows(leaf, index, value):
    """``leaf[index] = value`` for a float pool leaf or an int8 ``{"q",
    "s"}`` pair (``value`` quantized per position first), in place."""
    if isinstance(leaf, dict):
        q, s = kv_quantize(value)
        leaf["q"][index] = q
        leaf["s"][index] = s
    else:
        leaf[index] = value.to(leaf.dtype)


# --------------------------------------------------------------- device side
class PagedKVLayout:
    """View/commit ops over one layer's pool slice, closed over the device
    block tables ``(B, blocks_per_row)`` int32.

    ``attention_impl="reference"``: the decode layer gathers a dense view
    (:meth:`view`), writes its new column into it, attends, and the column
    is committed back (:meth:`commit`). ``"kernel"``: the new column is
    committed first (:meth:`commit_column`) and the flash-decode kernel
    walks the tables itself; no dense view exists."""

    def __init__(self, tables: torch.Tensor, block_size: int, compute_dtype,
                 attention_impl: str = "reference"):
        self.tables = tables
        self.block_size = block_size
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self._slots_at = None  # (pos, its version, block ids, offsets)

    def view(self, layer_cache) -> torch.Tensor:
        """(num_blocks, bs, kvh, hd) pool slice (or the int8 ``{"q", "s"}``
        pair, dequantized) -> (B, blocks_per_row * bs, kvh, hd) dense copy in
        the compute dtype; unallocated entries gather the null block."""
        t = self.tables.long()
        if isinstance(layer_cache, dict):
            dense = kv_dequantize(layer_cache["q"][t], layer_cache["s"][t], self.compute_dtype)
        else:
            dense = layer_cache[t]
        b, bpr, bs, kvh, hd = dense.shape
        return dense.reshape(b, bpr * bs, kvh, hd).to(self.compute_dtype)

    def _pool_index(self, pos):
        """(block id, offset) of each row's position. Every layer of a
        decode step writes the same positions, so the answer is kept for
        the same ``pos`` tensor at the same version (an in-place update of
        ``pos`` bumps its version and recomputes)."""
        cached = self._slots_at
        if cached is None or cached[0] is not pos or cached[1] != pos._version:
            p = (pos.expand(self.tables.shape[0]) if pos.dim() == 0 else pos).long()
            rows = torch.arange(self.tables.shape[0], device=p.device)
            blk = self.tables[rows, p // self.block_size].long()
            self._slots_at = cached = (pos, pos._version, blk, p % self.block_size)
        return cached[2:]

    def _scatter(self, layer_cache, col, pos):
        _set_rows(layer_cache, self._pool_index(pos), col)
        return layer_cache

    def commit(self, layer_cache, view, pos):
        """Write the column the decode layer wrote into ``view`` at ``pos``
        back into the pool slice, in place. Ghost slots' rows point at the
        null block, so their writes land in the sink."""
        pos_l = (pos.expand(self.tables.shape[0]) if pos.dim() == 0 else pos).long()
        col = view[torch.arange(view.shape[0], device=view.device), pos_l]
        return self._scatter(layer_cache, col, pos)

    def commit_column(self, layer_cache, col, pos):
        """Write a freshly computed (B, 1, kvh, hd) K or V column at ``pos``
        straight into the pool slice, in place (the kernel path's
        commit-before-attend)."""
        return self._scatter(layer_cache, col[:, 0], pos)

    def commit_window(self, cache_leaf, window, pos, count):
        """Write the first ``count[b]`` columns of a window into the pool,
        stacked over layers, in place: ``window`` (L, B, W, kvh, hd) holds
        positions ``pos .. pos+W-1``; ``cache_leaf`` is the whole (L, ...)
        pool leaf. Columns ``j >= count[b]`` and positions past the row's
        table (``pos + j >= blocks_per_row * block_size``) go to the null
        block: a rejected draft rewinds by never being committed. Windows
        start at or after the prompt's end (or, for a chunk, rewrite prompt
        positions with the same bytes), so shared prefix blocks keep their
        content."""
        bs = self.block_size
        w = window.shape[2]
        bpr = self.tables.shape[1]
        j = torch.arange(w, device=window.device)[None, :]
        abs_pos = pos.long()[:, None] + j  # (B, W)
        valid = (j < count.long()[:, None]) & (abs_pos < bpr * bs)
        blk = torch.gather(self.tables.long(), 1, (abs_pos // bs).clamp(0, bpr - 1))
        blk = torch.where(valid, blk, torch.full_like(blk, _NULL_BLOCK))
        _set_rows(cache_leaf, (slice(None), blk, abs_pos % bs), window)
        return cache_leaf


# ------------------------------------------------------------ host block pool
class PagedBlockPool:
    """Host-side allocator of the device block pool: free list, reference
    counts, per-slot table rows and the copy-on-write prefix registry.
    Single-threaded: the serving worker owns it.

    Block states: **free** (on the free list), **active** (reference count
    >= 1) and **cached** (count 0 but still registered under its prefix
    key, serving hits, evicted LRU only when the free list is empty). The
    registry keys are the exact prefix bytes ``prompt[: (d + 1) *
    block_size]``; a lookup walks depths 0, 1, 2, ... and stops at the
    first miss."""

    def __init__(self, *, num_blocks: int, block_size: int, slots: int,
                 blocks_per_row: int):
        if num_blocks < 2:
            raise ValueError(
                f"pool needs >= 2 blocks (1 is the reserved null block), got {num_blocks}"
            )
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.slots = slots
        self.blocks_per_row = blocks_per_row
        self.reset()

    def reset(self) -> None:
        self._free: List[int] = list(range(self.num_blocks - 1, _NULL_BLOCK, -1))
        self._ref = np.zeros(self.num_blocks, dtype=np.int64)
        self._registry: Dict[bytes, int] = {}
        self._key_of: Dict[int, bytes] = {}
        self._cached: "collections.OrderedDict[int, None]" = collections.OrderedDict()
        self._rows: List[List[int]] = [[] for _ in range(self.slots)]
        # chunked prefill: the fresh prompt blocks of a slot still being
        # prefilled must not serve prefix hits before their content exists;
        # their registrations wait here until the last chunk commits
        self._deferred: Dict[int, List[Tuple[bytes, int]]] = {}
        self.tables = np.zeros((self.slots, self.blocks_per_row), dtype=np.int32)
        self.prefix_hits = 0
        self.prefix_misses = 0

    def blocks_needed(self, prompt_len: int, budget: int) -> int:
        # budget tokens occupy positions [prompt_len, prompt_len + budget)
        return _ceil_div(prompt_len + budget, self.block_size)

    def max_request_blocks(self) -> int:
        return self.num_blocks - 1

    def free_blocks(self) -> int:
        """Allocatable capacity: truly free + LRU-evictable cached."""
        return len(self._free) + len(self._cached)

    def active_blocks(self) -> int:
        return int((self._ref > 0).sum())

    def _shared_prefix(self, prompt: np.ndarray) -> List[int]:
        bs = self.block_size
        hits: List[int] = []
        for depth in range(len(prompt) // bs):
            blk = self._registry.get(prompt[: (depth + 1) * bs].tobytes())
            if blk is None:
                break
            hits.append(blk)
        return hits

    def can_admit(self, prompt: np.ndarray, budget: int) -> bool:
        """Whether :meth:`acquire` would succeed now. Cached blocks the
        request would hit are not also counted as evictable capacity."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        hits = self._shared_prefix(prompt)
        needed = self.blocks_needed(len(prompt), budget) - len(hits)
        evictable = len(self._cached) - sum(1 for b in hits if self._ref[b] == 0)
        return needed <= len(self._free) + evictable

    def _evict_one(self) -> int:
        blk, _ = self._cached.popitem(last=False)  # LRU
        key = self._key_of.pop(blk)
        if self._registry.get(key) == blk:
            del self._registry[key]
        return blk

    def _alloc_block(self) -> int:
        if self._free:
            return self._free.pop()
        return self._evict_one()

    def _register(self, key: bytes, blk: int) -> None:
        """Map ``key`` -> ``blk``, first dropping a superseded mapping (an
        evicted shallow block orphans its deeper extensions, which may
        still hold the key)."""
        old = self._registry.get(key)
        if old is not None and old != blk:
            del self._key_of[old]
            if old in self._cached:
                del self._cached[old]
                self._free.append(old)
        self._registry[key] = blk
        self._key_of[blk] = key

    def acquire(self, slot: int, prompt: np.ndarray, budget: int,
                defer_register: bool = False) -> Tuple[np.ndarray, int]:
        """Allocate (or share) one admitted request's blocks and install the
        slot's table row. Returns ``(row, shared_blocks)``: the full
        ``(blocks_per_row,)`` int32 row, null beyond the allocation. Raises
        :class:`EngineCapacityError` when the pool lacks room (callers gate
        on :meth:`can_admit`). ``defer_register=True`` (chunked prefill)
        parks the fresh prompt blocks' registrations until
        :meth:`promote_deferred`; a release before that drops them."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        total = self.blocks_needed(len(prompt), budget)
        if total > self.blocks_per_row:
            raise EngineCapacityError(
                f"request needs {total} blocks but a table row holds {self.blocks_per_row}"
            )
        if not self.can_admit(prompt, budget):
            raise EngineCapacityError("no free KV blocks (caller must gate on can_admit())")
        bs = self.block_size
        full = len(prompt) // bs
        hits = self._shared_prefix(prompt)
        row: List[int] = []
        for blk in hits:
            if self._ref[blk] == 0:  # cached -> active
                del self._cached[blk]
            self._ref[blk] += 1
            row.append(blk)
        self.prefix_hits += len(hits)
        self.prefix_misses += full - len(hits)
        deferred: List[Tuple[bytes, int]] = []
        for j in range(len(hits), total):
            blk = self._alloc_block()
            self._ref[blk] = 1
            if j < full:
                key = prompt[: (j + 1) * bs].tobytes()
                if defer_register:
                    deferred.append((key, blk))
                else:
                    self._register(key, blk)
            row.append(blk)
        if deferred:
            self._deferred[slot] = deferred
        else:
            self._deferred.pop(slot, None)
        self._rows[slot] = row
        self.tables[slot] = _NULL_BLOCK
        self.tables[slot, : len(row)] = row
        return self.tables[slot].copy(), len(hits)

    def promote_deferred(self, slot: int, count: Optional[int] = None) -> int:
        """Install up to ``count`` (all when None) of the slot's parked
        registrations, shallowest first, once their content exists. Returns
        how many were promoted."""
        deferred = self._deferred.get(slot, [])
        n = len(deferred) if count is None else min(count, len(deferred))
        for key, blk in deferred[:n]:
            self._register(key, blk)
        rest = deferred[n:]
        if rest:
            self._deferred[slot] = rest
        else:
            self._deferred.pop(slot, None)
        return n

    def release(self, slot: int) -> None:
        """Drop the slot's references: zero-reference registered blocks
        park in the cached LRU, the rest free. The row resets to the null
        block so the ghost slot's masked writes stop touching real blocks.
        Registrations still parked (cancelled mid-prefill) are dropped."""
        self._deferred.pop(slot, None)
        for blk in self._rows[slot]:
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                if blk in self._key_of:
                    self._cached[blk] = None
                    self._cached.move_to_end(blk)
                else:
                    self._free.append(blk)
        self._rows[slot] = []
        self.tables[slot] = _NULL_BLOCK

    def stats(self) -> dict:
        lookups = self.prefix_hits + self.prefix_misses
        return {
            "blocks_total": self.num_blocks,
            "blocks_free": len(self._free),
            "blocks_cached": len(self._cached),
            "blocks_active": self.active_blocks(),
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": (self.prefix_hits / lookups) if lookups else 0.0,
        }


# ------------------------------------------------------------------- backends
class KVCacheBackend:
    """Interface the engine programs against. Device methods allocate or
    update the device store; host methods manage admission and tables."""

    kind: str = "abstract"

    def init_device_state(self) -> dict:
        raise NotImplementedError

    def make_layout(self, tables) -> Optional[PagedKVLayout]:
        """None: the model's decode step reads the cache directly (dense)."""
        raise NotImplementedError

    def prefill_write(self, cache, new_cache, slot: int, table_row: torch.Tensor) -> dict:
        """Write a bucketed prefill's KV (``(L, 1, max_len, kvh, hd)`` per
        leaf) into the store for ``slot``/``table_row``, in place."""
        raise NotImplementedError

    def commit_window(self, cache, window_kv, tables, pos, count) -> dict:
        """Write the first ``count[b]`` columns of a window (``window_kv``:
        ``{"k", "v"}`` of (L, B, W, kvh, hd), positions ``pos .. pos+W-1``)
        into the store, in place. Columns past ``count`` and positions past
        the row are dropped, never clamped onto live positions."""
        raise NotImplementedError

    def rows(self, cache, tables, slot: int):
        """``(cache, tables)`` restricted to one slot's row, for a window
        forward over that slot alone (chunked prefill)."""
        raise NotImplementedError

    def device_tables(self) -> torch.Tensor:
        raise NotImplementedError

    def acquire(self, slot: int, prompt: np.ndarray, budget: int,
                defer_register: bool = False) -> Tuple[np.ndarray, int]:
        raise NotImplementedError

    def release(self, slot: int) -> None:
        raise NotImplementedError

    def can_admit(self, prompt: np.ndarray, budget: int) -> bool:
        raise NotImplementedError

    def validate_request(self, prompt_len: int, budget: int) -> None:
        """Structural admission checks beyond the engine's; raises ValueError."""

    def reset(self) -> None:
        raise NotImplementedError

    def hbm_bytes(self) -> int:
        raise NotImplementedError

    def reserved_tokens(self) -> int:
        raise NotImplementedError

    def stats(self) -> dict:
        raise NotImplementedError


class DenseKVBackend(KVCacheBackend):
    """One dense ``(L, slots, max_len, kvh, hd)`` row per slot, wiped by
    each prefill; no admission constraint beyond slots."""

    kind = "dense"

    def __init__(self, *, config, slots: int, max_len: int, device: torch.device):
        self.config = config
        self.slots = slots
        self.max_len = max_len
        self.device = device
        self._shape = (config.num_hidden_layers, slots, max_len,
                       config.num_key_value_heads, config.head_dim)
        self._dtype = config.compute_dtype
        self._tables = torch.zeros((slots, 1), dtype=torch.int32, device=device)

    def init_device_state(self):
        return {w: torch.zeros(self._shape, dtype=self._dtype, device=self.device) for w in ("k", "v")}

    def make_layout(self, tables):
        return None

    def prefill_write(self, cache, new_cache, slot, table_row):
        for w in ("k", "v"):
            cache[w][:, slot] = new_cache[w][:, 0].to(self._dtype)
        return cache

    def commit_window(self, cache, window_kv, tables, pos, count):
        # row b of the window is arena row b of ``cache`` (the whole arena,
        # or one slot's row from rows()); positions past max_len are dropped
        # by writing them back unchanged: W <= max_len consecutive positions
        # are distinct modulo max_len, so the wrapped targets never collide
        # with a real write
        b, w = window_kv["k"].shape[1:3]
        j = torch.arange(w, device=pos.device)[None, :]
        idx = pos.long()[:, None] + j
        valid = ((j < count.long()[:, None]) & (idx < self.max_len))[None, :, :, None, None]
        rows = torch.arange(b, device=pos.device)[:, None]
        target = (slice(None), rows, idx % self.max_len)
        for w_ in ("k", "v"):
            leaf = cache[w_]
            leaf[target] = torch.where(valid, window_kv[w_].to(leaf.dtype), leaf[target])
        return cache

    def rows(self, cache, tables, slot):
        return {w: c[:, slot: slot + 1] for w, c in cache.items()}, tables[slot: slot + 1]

    def device_tables(self):
        return self._tables

    def acquire(self, slot, prompt, budget, defer_register=False):
        return np.zeros((1,), np.int32), 0

    def release(self, slot):
        pass

    def can_admit(self, prompt, budget):
        return True

    def reset(self):
        pass

    def hbm_bytes(self):
        return 2 * int(np.prod(self._shape)) * self._dtype.itemsize

    def reserved_tokens(self):
        return self.slots * self.max_len

    def stats(self):
        return {
            "backend": self.kind,
            "hbm_bytes": self.hbm_bytes(),
            "hbm_bytes_live": self.hbm_bytes(),
            "reserved_tokens": self.reserved_tokens(),
        }


class PagedKVBackend(KVCacheBackend):
    """Block pool + tables + copy-on-write prefix cache (+ int8 storage
    with ``quantized=True``, the ``"paged_int8"`` kind).

    ``pool_blocks=None`` provisions every slot's worst case plus the null
    block (the dense arena's token capacity); a smaller pool oversubscribes
    slots, with admission gated on free blocks."""

    def __init__(self, *, config, slots: int, max_len: int, prompt_bucket: int,
                 device: torch.device, block_size: int = 16,
                 pool_blocks: Optional[int] = None, quantized: bool = False,
                 attention_impl: str = "reference"):
        if attention_impl not in ("reference", "kernel"):
            raise ValueError(
                f"attention_impl must be 'reference' or 'kernel', got {attention_impl!r}"
            )
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if max_len % block_size != 0:
            raise ValueError(
                f"max_len ({max_len}) must be a multiple of engine_block_size "
                f"({block_size}) so a table row covers it exactly"
            )
        self.config = config
        self.slots = slots
        self.max_len = max_len
        self.device = device
        self.block_size = block_size
        self.blocks_per_row = max_len // block_size
        self.prefill_blocks = _ceil_div(prompt_bucket, block_size)
        if pool_blocks is None:
            pool_blocks = slots * self.blocks_per_row + 1
        if pool_blocks < self.prefill_blocks + 1:
            raise ValueError(
                f"engine_pool_blocks ({pool_blocks}) must cover at least one "
                f"bucketed prefill + the null block ({self.prefill_blocks + 1} "
                f"blocks of engine_block_size={block_size})"
            )
        self.pool_blocks = pool_blocks
        self._kvh, self._hd = config.num_key_value_heads, config.head_dim
        self._layers = config.num_hidden_layers
        self._dtype = config.compute_dtype
        self.quantized = quantized
        self.kind = "paged_int8" if quantized else "paged"
        self.attention_impl = attention_impl
        self.pool = PagedBlockPool(
            num_blocks=pool_blocks, block_size=block_size, slots=slots,
            blocks_per_row=self.blocks_per_row,
        )
        self._device_tables: Optional[torch.Tensor] = None

    def init_device_state(self):
        shape = (self._layers, self.pool_blocks, self.block_size, self._kvh, self._hd)
        if self.quantized:
            return {w: {"q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                        "s": torch.zeros(shape[:3], dtype=torch.float32, device=self.device)}
                    for w in ("k", "v")}
        return {w: torch.zeros(shape, dtype=self._dtype, device=self.device) for w in ("k", "v")}

    def make_layout(self, tables):
        return PagedKVLayout(tables, self.block_size, self._dtype, attention_impl=self.attention_impl)

    def prefill_write(self, cache, new_cache, slot, table_row):
        """Write the bucket's ``prefill_blocks`` blocks into the slot's
        table-row blocks in one indexed copy per leaf. Rows allocated shorter
        than the bucket carry null entries there, which absorb the extra
        writes; shared prefix blocks are rewritten with identical bytes (int8:
        the same quantization of the same values)."""
        n, bs = self.prefill_blocks, self.block_size
        ids = table_row[:n].long()
        for w in ("k", "v"):
            fresh = new_cache[w][:, 0, : n * bs]  # (L, n*bs, kvh, hd)
            fresh = fresh.reshape(self._layers, n, bs, self._kvh, self._hd)
            _set_rows(cache[w], (slice(None), ids), fresh if self.quantized else fresh.to(self._dtype))
        return cache

    def commit_window(self, cache, window_kv, tables, pos, count):
        layout = self.make_layout(tables)
        for w in ("k", "v"):
            layout.commit_window(cache[w], window_kv[w], pos, count)
        return cache

    def rows(self, cache, tables, slot):
        return cache, tables[slot: slot + 1]

    def device_tables(self):
        if self._device_tables is None:
            self._device_tables = host_to_device(self.pool.tables, self.device)
        return self._device_tables

    def acquire(self, slot, prompt, budget, defer_register=False):
        out = self.pool.acquire(slot, prompt, budget, defer_register=defer_register)
        self._device_tables = None
        return out

    def promote_deferred(self, slot: int, count: Optional[int] = None) -> int:
        return self.pool.promote_deferred(slot, count)

    def release(self, slot):
        self.pool.release(slot)
        self._device_tables = None

    def can_admit(self, prompt, budget):
        return self.pool.can_admit(prompt, budget)

    def validate_request(self, prompt_len, budget):
        needed = self.pool.blocks_needed(prompt_len, budget)
        limit = min(self.pool.max_request_blocks(), self.blocks_per_row)
        if needed > limit:
            raise ValueError(
                f"request needs {needed} KV blocks (engine_block_size="
                f"{self.block_size}) but the pool only has {limit} allocatable "
                "blocks per request; raise ServingConfig.engine_pool_blocks / "
                "engine_max_len or lower the budget"
            )

    def reset(self):
        self.pool.reset()
        self._device_tables = None

    def _per_block_bytes(self) -> int:
        """One block of one leaf over every layer; int8 adds its f32
        per-position scales."""
        per_block = self._layers * self.block_size * self._kvh * self._hd
        if self.quantized:
            return per_block + self._layers * self.block_size * 4
        return per_block * self._dtype.itemsize

    def hbm_bytes(self):
        return 2 * self.pool_blocks * self._per_block_bytes()

    def hbm_bytes_live(self):
        """Bytes the kernel reads per decode step at most: allocated blocks
        only (the dead tail and the null block are never read as live)."""
        return 2 * self.pool.active_blocks() * self._per_block_bytes()

    def reserved_tokens(self):
        return self.pool.active_blocks() * self.block_size

    def stats(self):
        return {
            "backend": self.kind,
            "block_size": self.block_size,
            "pool_blocks": self.pool_blocks,
            "attention_impl": self.attention_impl,
            "hbm_bytes": self.hbm_bytes(),
            "hbm_bytes_live": self.hbm_bytes_live(),
            "reserved_tokens": self.reserved_tokens(),
            **self.pool.stats(),
        }


def make_kv_backend(kind: str, *, config, slots: int, max_len: int, prompt_bucket: int,
                    device: torch.device, block_size: int = 16,
                    pool_blocks: Optional[int] = None,
                    attention_impl: str = "reference") -> KVCacheBackend:
    """Factory the engine (and ``ServingConfig.kv_cache``) selects through."""
    if kind == "dense":
        if attention_impl != "reference":
            raise ValueError(
                "attention_impl='kernel' requires a paged KV cache (kv_cache="
                "'paged' or 'paged_int8'); the dense arena has no block tables "
                "for the kernel to walk"
            )
        return DenseKVBackend(config=config, slots=slots, max_len=max_len, device=device)
    if kind in ("paged", "paged_int8"):
        return PagedKVBackend(
            config=config, slots=slots, max_len=max_len, prompt_bucket=prompt_bucket,
            device=device, block_size=block_size, pool_blocks=pool_blocks,
            quantized=kind == "paged_int8", attention_impl=attention_impl,
        )
    raise ValueError(f"kv_cache must be one of {KV_BACKENDS}, got {kind!r}")
