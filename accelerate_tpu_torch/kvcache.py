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

Device tensors are updated in place (the JAX package rebuilt them
functionally). The int8 pool (``paged_int8``) and the host-RAM spill tier
are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .utils.fault import EngineCapacityError

__all__ = [
    "KV_BACKENDS",
    "KVCacheBackend",
    "DenseKVBackend",
    "PagedKVBackend",
    "PagedBlockPool",
    "PagedKVLayout",
    "make_kv_backend",
]

KV_BACKENDS = ("dense", "paged")

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

    def view(self, layer_cache: torch.Tensor) -> torch.Tensor:
        """(num_blocks, bs, kvh, hd) pool slice -> (B, blocks_per_row * bs,
        kvh, hd) dense copy; unallocated entries gather the null block."""
        dense = layer_cache[self.tables.long()]
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
        blk, off = self._pool_index(pos)
        layer_cache[blk, off] = col.to(layer_cache.dtype)
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

    def acquire(self, slot: int, prompt: np.ndarray, budget: int) -> Tuple[np.ndarray, int]:
        """Allocate (or share) one admitted request's blocks and install the
        slot's table row. Returns ``(row, shared_blocks)``: the full
        ``(blocks_per_row,)`` int32 row, null beyond the allocation. Raises
        :class:`EngineCapacityError` when the pool lacks room (callers gate
        on :meth:`can_admit`)."""
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
        for j in range(len(hits), total):
            blk = self._alloc_block()
            self._ref[blk] = 1
            if j < full:
                self._register(prompt[: (j + 1) * bs].tobytes(), blk)
            row.append(blk)
        self._rows[slot] = row
        self.tables[slot] = _NULL_BLOCK
        self.tables[slot, : len(row)] = row
        return self.tables[slot].copy(), len(hits)

    def release(self, slot: int) -> None:
        """Drop the slot's references: zero-reference registered blocks
        park in the cached LRU, the rest free. The row resets to the null
        block so the ghost slot's masked writes stop touching real blocks."""
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

    def device_tables(self) -> torch.Tensor:
        raise NotImplementedError

    def acquire(self, slot: int, prompt: np.ndarray, budget: int) -> Tuple[np.ndarray, int]:
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

    def device_tables(self):
        return self._tables

    def acquire(self, slot, prompt, budget):
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
    """Block pool + tables + copy-on-write prefix cache.

    ``pool_blocks=None`` provisions every slot's worst case plus the null
    block (the dense arena's token capacity); a smaller pool oversubscribes
    slots, with admission gated on free blocks."""

    kind = "paged"

    def __init__(self, *, config, slots: int, max_len: int, prompt_bucket: int,
                 device: torch.device, block_size: int = 16,
                 pool_blocks: Optional[int] = None, attention_impl: str = "reference"):
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
        self.attention_impl = attention_impl
        self.pool = PagedBlockPool(
            num_blocks=pool_blocks, block_size=block_size, slots=slots,
            blocks_per_row=self.blocks_per_row,
        )
        self._device_tables: Optional[torch.Tensor] = None

    def init_device_state(self):
        shape = (self._layers, self.pool_blocks, self.block_size, self._kvh, self._hd)
        return {w: torch.zeros(shape, dtype=self._dtype, device=self.device) for w in ("k", "v")}

    def make_layout(self, tables):
        return PagedKVLayout(tables, self.block_size, self._dtype, attention_impl=self.attention_impl)

    def prefill_write(self, cache, new_cache, slot, table_row):
        """Write the bucket's ``prefill_blocks`` blocks into the slot's
        table-row blocks in one indexed copy per leaf. Rows allocated shorter
        than the bucket carry null entries there, which absorb the extra
        writes; shared prefix blocks are rewritten with identical bytes."""
        n, bs = self.prefill_blocks, self.block_size
        ids = table_row[:n].long()
        for w in ("k", "v"):
            fresh = new_cache[w][:, 0, : n * bs]  # (L, n*bs, kvh, hd)
            cache[w][:, ids] = fresh.reshape(self._layers, n, bs, self._kvh, self._hd).to(self._dtype)
        return cache

    def device_tables(self):
        if self._device_tables is None:
            self._device_tables = host_to_device(self.pool.tables, self.device)
        return self._device_tables

    def acquire(self, slot, prompt, budget):
        out = self.pool.acquire(slot, prompt, budget)
        self._device_tables = None
        return out

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
        return self._layers * self.block_size * self._kvh * self._hd * self._dtype.itemsize

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
                "attention_impl='kernel' requires kv_cache='paged'; the dense "
                "arena has no block tables for the kernel to walk"
            )
        return DenseKVBackend(config=config, slots=slots, max_len=max_len, device=device)
    if kind == "paged":
        return PagedKVBackend(
            config=config, slots=slots, max_len=max_len, prompt_bucket=prompt_bucket,
            device=device, block_size=block_size, pool_blocks=pool_blocks,
            attention_impl=attention_impl,
        )
    if kind == "paged_int8":
        raise NotImplementedError(
            "kv_cache='paged_int8' (int8 pool + per-position scales) is queued "
            "for slice 2 (ROADMAP.md)"
        )
    raise ValueError(f"kv_cache must be one of {KV_BACKENDS}, got {kind!r}")
