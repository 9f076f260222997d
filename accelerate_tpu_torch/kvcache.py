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
functionally), and every device operand of the engine's programs is a
tensor that lives as long as the engine: the block tables are one static
``(slots, blocks_per_row)`` tensor, refreshed from the host table by a
non-blocking copy (:class:`HostStage`) before the next program after an
``acquire`` or a ``release``, so a captured CUDA graph keeps reading it.

* **Host-RAM spill tier** (``host_tier_bytes``, :class:`HostKVTier`): an
  evicted registered prefix block spills to host memory under its prefix
  key instead of dying, and a later chunked admission of that prefix
  restores it. Because the pool is updated in place, the victims' bytes
  are gathered into a fresh device tensor inside :meth:`PagedKVBackend
  .acquire`, on the engine's stream, before the program that reuses the
  blocks is enqueued behind it; a non-blocking copy takes the gather to
  pinned host memory and records an event, and a spill thread waits on
  the event and files each block. A payload is the pool's own bytes
  (bf16/f32, or int8 ``q`` with f32 ``s``) in a pinned tensor, so a
  restore puts back exactly what was evicted and its host-to-device
  copies are asynchronous. :meth:`PagedKVBackend.prefetch` starts those
  copies from the submitter's thread on a side stream.

Under tensor parallelism (``tp_group``: a model laid over a mesh's ``tp``
dim) a backend's store holds this rank's ``kv_heads / tp`` heads in as
many blocks as one process's: the same tables on every rank, the pool's
bytes one process's over ``tp`` (an int8 pool's per-position scales are
whole on every rank, taken over every rank's heads).
"""

from __future__ import annotations

import collections
import contextlib
import queue
import threading
import time
import weakref
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .logging import get_logger
from .utils.fault import EngineCapacityError, fault_point

logger = get_logger(__name__)

__all__ = [
    "KV_BACKENDS",
    "HostKVTier",
    "kv_quantize",
    "kv_dequantize",
    "KVCacheBackend",
    "DenseKVBackend",
    "PagedKVBackend",
    "PagedBlockPool",
    "PagedKVLayout",
    "HostStage",
    "make_kv_backend",
    "pool_from_dense",
]

KV_BACKENDS = ("dense", "paged", "paged_int8")

_NULL_BLOCK = 0  # reserved garbage sink; never allocated, never attended


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _group_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


class HostStage:
    """A pinned host buffer that feeds one device tensor, ``dst``, which
    stays where it is: :meth:`write` fills the buffer and enqueues a
    non-blocking copy into ``dst``. The copy reads the buffer when the
    stream reaches it, so the next :meth:`write` first waits for the
    event recorded after the last copy (at once in steady state: the
    stream has long passed it). On the CPU the copy is a plain one."""

    def __init__(self, dst: torch.Tensor):
        self.dst = dst
        cuda = dst.device.type == "cuda"
        self.host = torch.empty(dst.shape, dtype=dst.dtype, pin_memory=cuda)
        self._event = torch.cuda.Event() if cuda else None

    def write(self, arr) -> None:
        if self._event is not None:
            self._event.synchronize()
        self.host.numpy()[...] = arr
        self.dst.copy_(self.host, non_blocking=True)
        if self._event is not None:
            # on dst's card: the calling thread's current card may be
            # another (an engine built on one thread for cuda:1, then run
            # by its serving thread)
            self._event.record(torch.cuda.current_stream(self.dst.device))


# ------------------------------------------------------------------ int8 ops
def kv_quantize(x: torch.Tensor, group=None):
    """Symmetric int8 quantization with one f32 scale per leading position:
    ``x`` is ``(..., kvh, hd)``, the amax reduces over the last two axes
    (clamped at 1e-6). ``round`` is half-to-even and the division a true
    division, as ``jnp.round(x / scale)``, so the bytes equal the JAX
    package's. Deterministic: identical inputs give identical bytes, which
    shared-prefix rewrites rely on. ``group``: ``x`` holds this ``tp``
    rank's kv heads, and the amax is taken over every rank's (a max over
    the group), so the scale and the bytes are one process's. Returns
    ``(q int8, scale f32 (...))``."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-1, -2))
    if group is not None:
        from .ops.collectives import all_reduce_

        all_reduce_(amax, group, "max")
    amax = amax.clamp_min(1e-6)
    scale = amax / 127.0
    q = torch.round(xf / scale[..., None, None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`kv_quantize`: ``q (..., kvh, hd)`` times the
    per-position ``scale (...)``, in ``dtype``."""
    return (q.float() * scale[..., None, None]).to(dtype)


def _map_leaves(fn, tree):
    """``fn`` over the tensors of a KV payload: ``{"k", "v"}`` of tensors
    or of int8 ``{"q", "s"}`` pairs."""
    return {name: _map_leaves(fn, leaf) if isinstance(leaf, dict) else fn(leaf)
            for name, leaf in tree.items()}


class _HostBlock(dict):
    """One spilled block's payload (``{"k", "v"}`` as :func:`_map_leaves`
    walks it). On the card its tensors are views of a slot of
    :class:`_PinnedSlabs`: ``slot`` names it, and ``reads`` holds the
    events recorded after each copy out of it, which must complete before
    the slot takes another block."""

    def __init__(self, leaves, slot=None):
        super().__init__(leaves)
        self.slot = slot
        self.reads: list = []


class _PinnedSlabs:
    """Pinned host memory of the spill tier, one slot a block, allocated
    in slabs of ``per_slab`` blocks (``template``: each leaf's block shape
    and dtype). Pinning memory is slow and holds up the host-to-device
    copies other threads enqueue meanwhile, and copies out of views of one
    allocation run faster than out of as many small ones (PERF.md §6:
    a block a pinned buffer of its own made a restore slower than
    recomputing the prompt): so the tier pins its capacity in slabs at its
    first spill, on the spill thread, and reuses a freed slot. A slot
    freed while a copy out of it may still be in flight waits until that
    copy's events complete."""

    def __init__(self, template, per_slab: int = 64):
        self.template = template
        self.per_slab = per_slab
        self._slabs: list = []
        self._free: List[int] = []
        self._pending: collections.deque = collections.deque()  # (slot, read events)
        self._lock = threading.Lock()

    def _grow(self) -> None:
        base = len(self._slabs) * self.per_slab
        self._slabs.append(_map_leaves(
            lambda spec: torch.empty((self.per_slab, *spec[0]), dtype=spec[1], pin_memory=True),
            self.template))
        self._free.extend(range(base + self.per_slab - 1, base - 1, -1))

    def reserve(self, slots: int) -> None:
        """Pin slabs until they hold at least ``slots`` blocks."""
        with self._lock:
            while len(self._slabs) * self.per_slab < slots:
                self._grow()

    def available(self) -> int:
        """Slots free now (a pending one once its reads completed)."""
        with self._lock:
            while self._pending and all(e.query() for e in self._pending[0][1]):
                self._free.append(self._pending.popleft()[0])
            return len(self._free)

    def take(self) -> _HostBlock:
        with self._lock:
            if not self._free and self._pending:
                slot, reads = self._pending.popleft()
                for e in reads:
                    e.synchronize()
                self._free.append(slot)
            if not self._free:
                self._grow()
            slot = self._free.pop()
        slab, i = divmod(slot, self.per_slab)
        return _HostBlock(_map_leaves(lambda t: t[i], self._slabs[slab]), slot)

    def slab(self, index: int):
        return self._slabs[index]

    def free(self, block: _HostBlock) -> None:
        with self._lock:
            if block.reads:
                self._pending.append((block.slot, list(block.reads)))
            else:
                self._free.append(block.slot)


def _map_pairs(fn, a, b):
    """``fn(x, y)`` over the tensors of two payloads of one structure."""
    for name, leaf in a.items():
        if isinstance(leaf, dict):
            _map_pairs(fn, leaf, b[name])
        else:
            fn(leaf, b[name])


def _spill_worker(backend_ref, spills: queue.Queue) -> None:
    """The spill thread of a :class:`PagedKVBackend` (``backend_ref``, a
    weak reference): files each queued gather in its host tier, until
    ``None`` or the backend is gone."""
    while True:
        item = spills.get()
        try:
            backend = backend_ref() if item is not None else None
            if backend is None:
                return
            keys, gathered, ready = item
            # a crash here loses the spill and nothing else: the gather
            # only read the pool, and the tier is host state
            fault_point("kvcache.spill_mid")
            backend._file(keys, gathered, ready)
        except Exception:  # noqa: BLE001 - a failed spill only loses a cache hit
            logger.exception("host-tier spill failed; the evicted block is lost to the "
                             "tier (device pool unaffected)")
        finally:
            backend = item = None
            spills.task_done()


def _set_rows(leaf, index, value, group=None):
    """``leaf[index] = value`` for a float pool leaf or an int8 ``{"q",
    "s"}`` pair (``value`` quantized per position first, its scale over
    ``group``'s heads too), in place."""
    if isinstance(leaf, dict):
        q, s = kv_quantize(value, group)
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
    walks the tables itself; no dense view exists. ``tp_group``: the pool
    holds this ``tp`` rank's kv heads, and an int8 column's scale is taken
    over every rank's heads (:func:`kv_quantize`)."""

    def __init__(self, tables: torch.Tensor, block_size: int, compute_dtype,
                 attention_impl: str = "reference", tp_group=None):
        self.tables = tables
        self.block_size = block_size
        self.compute_dtype = compute_dtype
        self.attention_impl = attention_impl
        self.tp_group = tp_group
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
        _set_rows(layer_cache, self._pool_index(pos), col, self.tp_group)
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
        _set_rows(cache_leaf, (slice(None), blk, abs_pos % bs), window, self.tp_group)
        return cache_leaf


# ----------------------------------------------------------- host spill tier
class HostKVTier:
    """Host-RAM tier below the pool's cached LRU: evicted registered prefix
    blocks land here under the same exact prefix-bytes key as the device
    registry, holding the pool's bytes (bf16/f32, or int8 ``q`` with f32
    per-position ``s``), so a hit restores exactly what a block that was
    never evicted would hold. Keys are content (the whole token prefix,
    and quantization is deterministic), so a stored block cannot go stale
    while the model stays the same.

    :meth:`insert` runs on the backend's spill thread; :meth:`lookup`,
    :meth:`stats` and :meth:`clear` on the engine's or a submitter's
    thread: every access holds the lock. Capacity is counted in blocks
    (``capacity_bytes // block_bytes``) and LRU-evicted on insert."""

    def __init__(self, capacity_bytes: int, block_bytes: int):
        if capacity_bytes < 0:
            raise ValueError(f"capacity_bytes must be >= 0, got {capacity_bytes}")
        if block_bytes < 1:
            raise ValueError(f"block_bytes must be >= 1, got {block_bytes}")
        self.capacity_bytes = capacity_bytes
        self.block_bytes = block_bytes
        self.capacity_blocks = capacity_bytes // block_bytes
        self._blocks: "collections.OrderedDict[bytes, Any]" = collections.OrderedDict()
        self._lock = threading.Lock()
        # called, under the lock, with each payload the tier lets go (LRU
        # drops, a key filed again, clear): the owner reuses its memory
        self.on_drop: Optional[Callable[[Any], None]] = None
        self.spill_blocks = 0
        self.spill_bytes = 0
        self.restore_hits = 0
        self.restore_bytes = 0
        self.restore_misses = 0
        self.dropped = 0  # LRU-evicted out of the tier

    def __len__(self) -> int:
        with self._lock:
            return len(self._blocks)

    def bytes_used(self) -> int:
        with self._lock:
            return len(self._blocks) * self.block_bytes

    def insert(self, key: bytes, payload: Any) -> bool:
        """File one spilled block. False when the tier has no capacity (the
        spill still counts, so the eviction pressure shows)."""
        with self._lock:
            self.spill_blocks += 1
            self.spill_bytes += self.block_bytes
            if self.capacity_blocks < 1:
                self.dropped += 1
                return False
            while len(self._blocks) >= self.capacity_blocks:
                self._let_go(self._blocks.popitem(last=False)[1])
                self.dropped += 1
            self._let_go(self._blocks.get(key))
            self._blocks[key] = payload
            self._blocks.move_to_end(key)
            return True

    def _let_go(self, payload) -> None:
        if payload is not None and self.on_drop is not None:
            self.on_drop(payload)

    def lookup(self, key: bytes) -> Optional[Any]:
        """Probe; a hit refreshes its recency, a miss counts. Hits count at
        restore time (:meth:`count_restore`)."""
        with self._lock:
            payload = self._blocks.get(key)
            if payload is None:
                self.restore_misses += 1
                return None
            self._blocks.move_to_end(key)
            return payload

    def count_restore(self, n_blocks: int) -> None:
        with self._lock:
            self.restore_hits += n_blocks
            self.restore_bytes += n_blocks * self.block_bytes

    def hot_keys(self, n: int = 8) -> List[bytes]:
        """The ``n`` most recently used keys, hottest first."""
        with self._lock:
            return list(reversed(self._blocks.keys()))[: max(0, n)]

    def contains(self, key: bytes) -> bool:
        """Membership without touching recency or the counters."""
        with self._lock:
            return key in self._blocks

    def clear(self) -> None:
        with self._lock:
            for payload in self._blocks.values():
                self._let_go(payload)
            self._blocks.clear()

    def stats(self) -> dict:
        with self._lock:
            return {
                "host_tier_capacity_bytes": self.capacity_bytes,
                "host_tier_blocks": len(self._blocks),
                "host_tier_bytes": len(self._blocks) * self.block_bytes,
                "spill_blocks": self.spill_blocks,
                "spill_bytes": self.spill_bytes,
                "restore_hits": self.restore_hits,
                "restore_bytes": self.restore_bytes,
                "restore_misses": self.restore_misses,
                "host_tier_dropped": self.dropped,
            }


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
        # host-tier spill: called with (key, block) for each evicted block
        # that still owns its key, before the registry entry dies (the
        # owner gathers the bytes before the block is written again)
        self.spill_fn: Optional[Callable[[bytes, int], None]] = None
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
            if self.spill_fn is not None:
                self.spill_fn(key, blk)
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

    def prefill_write(self, cache, new_cache, slot: torch.Tensor, table_row: torch.Tensor) -> dict:
        """Write a bucketed prefill's KV (``(L, 1, max_len, kvh, hd)`` per
        leaf) into the store for ``slot`` ((1,) int64 on the device) and
        ``table_row`` ((blocks_per_row,) int32 on the device), in place."""
        raise NotImplementedError

    def commit_window(self, cache, window_kv, tables, pos, count, rows=None) -> dict:
        """Write the first ``count[b]`` columns of a window (``window_kv``:
        ``{"k", "v"}`` of (L, B, W, kvh, hd), positions ``pos .. pos+W-1``)
        into the store, in place. Columns past ``count`` and positions past
        the row are dropped, never clamped onto live positions. ``rows``
        ((B,) int64): the slots the window's rows belong to, where
        ``tables`` were cut to them (:meth:`rows`); None for every slot."""
        raise NotImplementedError

    def rows(self, cache, tables, slot: torch.Tensor):
        """``(cache, tables)`` restricted to one slot's row (``slot`` (1,)
        int64 on the device), for a window forward over that slot alone
        (chunked prefill). The cache it returns is read only."""
        raise NotImplementedError

    def device_tables(self) -> torch.Tensor:
        """The static device block tables, brought up to date with the host
        table first (a non-blocking copy, only after a change)."""
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

    def __init__(self, *, config, slots: int, max_len: int, device: torch.device, tp_group=None):
        self.config = config
        self.slots = slots
        self.max_len = max_len
        self.device = device
        self._shape = (config.num_hidden_layers, slots, max_len,
                       config.num_key_value_heads // _group_size(tp_group), config.head_dim)
        self._dtype = config.compute_dtype
        self._tables = torch.zeros((slots, 1), dtype=torch.int32, device=device)

    def init_device_state(self):
        return {w: torch.zeros(self._shape, dtype=self._dtype, device=self.device) for w in ("k", "v")}

    def make_layout(self, tables):
        return None

    def prefill_write(self, cache, new_cache, slot, table_row):
        for w in ("k", "v"):
            cache[w].index_copy_(1, slot, new_cache[w][:, :1].to(self._dtype))
        return cache

    def commit_window(self, cache, window_kv, tables, pos, count, rows=None):
        # row b of the window is arena row rows[b]; positions past max_len
        # are dropped by writing them back unchanged: W <= max_len
        # consecutive positions are distinct modulo max_len, so the wrapped
        # targets never collide with a real write
        b, w = window_kv["k"].shape[1:3]
        j = torch.arange(w, device=pos.device)[None, :]
        idx = pos.long()[:, None] + j
        valid = ((j < count.long()[:, None]) & (idx < self.max_len))[None, :, :, None, None]
        if rows is None:
            rows = torch.arange(b, device=pos.device)
        target = (slice(None), rows[:, None], idx % self.max_len)
        for w_ in ("k", "v"):
            leaf = cache[w_]
            leaf[target] = torch.where(valid, window_kv[w_].to(leaf.dtype), leaf[target])
        return cache

    def rows(self, cache, tables, slot):
        return {w: c.index_select(1, slot) for w, c in cache.items()}, tables.index_select(0, slot)

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
                 attention_impl: str = "reference", tp_group=None, host_tier_bytes: int = 0):
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
        self.tp_group = tp_group
        self._kvh, self._hd = config.num_key_value_heads // _group_size(tp_group), config.head_dim
        self._layers = config.num_hidden_layers
        self._dtype = config.compute_dtype
        self.quantized = quantized
        self.kind = "paged_int8" if quantized else "paged"
        self.attention_impl = attention_impl
        self.pool = PagedBlockPool(
            num_blocks=pool_blocks, block_size=block_size, slots=slots,
            blocks_per_row=self.blocks_per_row,
        )
        self._device_tables = torch.zeros((slots, self.blocks_per_row), dtype=torch.int32,
                                          device=device)
        self._table_stage = HostStage(self._device_tables)
        self._tables_stale = True
        # the host-RAM spill tier (module docstring): the victims of the
        # current acquire, the spill thread's queue, and the prefetched
        # payloads by key, (device payload, event), which a submitter's
        # thread fills and the serving worker takes (under the lock)
        if host_tier_bytes < 0:
            raise ValueError(f"host_tier_bytes must be >= 0, got {host_tier_bytes}")
        self.host_tier: Optional[HostKVTier] = None
        self._cache_reader: Optional[Callable[[], Any]] = None
        self._spill_batch: List[Tuple[bytes, int]] = []
        self._spill_q: Optional[queue.Queue] = None
        self._spill_thread: Optional[threading.Thread] = None
        self._prefetched: Dict[bytes, Any] = {}
        self._prefetch_lock = threading.Lock()
        self._streams: Dict[str, Any] = {}  # the spill's and the prefetch's side streams
        self._slabs: Optional[_PinnedSlabs] = None  # the tier's pinned memory (CUDA)
        self.prefetch_hits = 0
        if host_tier_bytes > 0:
            self.host_tier = HostKVTier(host_tier_bytes, self.host_block_bytes())
            self.host_tier.on_drop = self._drop_block
            self.pool.spill_fn = lambda key, blk: self._spill_batch.append((key, blk))

    def init_device_state(self):
        shape = (self._layers, self.pool_blocks, self.block_size, self._kvh, self._hd)
        if self.quantized:
            return {w: {"q": torch.zeros(shape, dtype=torch.int8, device=self.device),
                        "s": torch.zeros(shape[:3], dtype=torch.float32, device=self.device)}
                    for w in ("k", "v")}
        return {w: torch.zeros(shape, dtype=self._dtype, device=self.device) for w in ("k", "v")}

    def make_layout(self, tables):
        return PagedKVLayout(tables, self.block_size, self._dtype, attention_impl=self.attention_impl,
                             tp_group=self.tp_group)

    def prefill_write(self, cache, new_cache, slot, table_row):
        """Write the bucket's ``prefill_blocks`` blocks into the slot's
        table-row blocks in one indexed copy per leaf. Rows allocated shorter
        than the bucket carry null entries there, which absorb the extra
        writes; shared prefix blocks are rewritten with identical bytes (int8:
        the same quantization of the same values)."""
        n, bs = self.prefill_blocks, self.block_size
        ids = table_row[:n].long()  # the row names the slot's blocks
        for w in ("k", "v"):
            fresh = new_cache[w][:, 0, : n * bs]  # (L, n*bs, kvh, hd)
            fresh = fresh.reshape(self._layers, n, bs, self._kvh, self._hd)
            _set_rows(cache[w], (slice(None), ids), fresh if self.quantized else fresh.to(self._dtype),
                      self.tp_group)
        return cache

    def commit_window(self, cache, window_kv, tables, pos, count, rows=None):
        layout = self.make_layout(tables)
        for w in ("k", "v"):
            layout.commit_window(cache[w], window_kv[w], pos, count)
        return cache

    def rows(self, cache, tables, slot):
        return cache, tables.index_select(0, slot)

    def device_tables(self):
        if self._tables_stale:
            self._table_stage.write(self.pool.tables)
            self._tables_stale = False
        return self._device_tables

    def acquire(self, slot, prompt, budget, defer_register=False):
        out = self.pool.acquire(slot, prompt, budget, defer_register=defer_register)
        self._tables_stale = True
        self._flush_spills()
        return out

    def promote_deferred(self, slot: int, count: Optional[int] = None) -> int:
        return self.pool.promote_deferred(slot, count)

    def prefix_digest(self, limit: int = 512) -> List[int]:
        """crc32 of each registered block-aligned prefix key, at most
        ``limit``: a fingerprint of what this pool holds (a collision only
        mis-scores a placement; nothing correct depends on it)."""
        keys = list(self.pool._registry.keys())[: max(0, limit)]
        return [zlib.crc32(k) & 0xFFFFFFFF for k in keys]

    # ---------------------------------------------------- host tier: spill
    def host_block_bytes(self) -> int:
        """Host bytes of one spilled block: K and V as the pool holds them
        (int8 with its f32 scales)."""
        return 2 * self._per_block_bytes()

    def bind_cache_reader(self, reader: Callable[[], Any]) -> None:
        """The engine's store, read by the spill gather (the store is
        updated in place, so the reader returns the same tensors)."""
        self._cache_reader = reader

    def _side_stream(self, name: str):
        with self._prefetch_lock:
            if name not in self._streams:
                self._streams[name] = torch.cuda.Stream(self.device)
            return self._streams[name]

    def _flush_spills(self) -> None:
        """Gather this acquire's eviction victims out of the pool into a
        fresh device tensor per leaf, ``(n, L, ...)``, on the current (the
        engine's) stream, before the program that overwrites the blocks is
        enqueued behind it, and hand the gather, with an event recorded
        after it, to the spill thread."""
        batch, self._spill_batch = self._spill_batch, []
        if not batch or self.host_tier is None or self._cache_reader is None:
            return
        keys = [key for key, _ in batch]
        ids = torch.tensor([blk for _, blk in batch], dtype=torch.long).to(self.device)
        gathered = _map_leaves(lambda leaf: leaf.index_select(1, ids).transpose(0, 1).contiguous(),
                               self._cache_reader())
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        self._spill_worker_q().put((keys, gathered, ready))

    def _spill_worker_q(self) -> queue.Queue:
        """The spill thread's queue, its thread started at the first spill.
        The thread holds the backend weakly: an engine let go is collected
        with its store and graphs, and its thread ends."""
        if self._spill_q is None:
            self._spill_q = queue.Queue()
            self._spill_thread = threading.Thread(
                target=_spill_worker, args=(weakref.ref(self), self._spill_q), name="kv-spill",
                daemon=True)
            self._spill_thread.start()
            weakref.finalize(self, self._spill_q.put, None)
        return self._spill_q

    def _file(self, keys, gathered, ready) -> None:
        """File each block of a spill gather in the tier, in host memory of
        its own. On the card: a slot of the pinned slabs each, filled by
        non-blocking copies on the spill's side stream once the gather is
        done, a round of as many blocks as there are free slots at a time
        (filing a round lets go of the tier's oldest blocks, whose slots
        the next round takes); the gather is dropped only after them."""
        k = gathered["k"]
        n = (k["q"] if isinstance(k, dict) else k).shape[0]
        if self.host_tier.capacity_blocks < 1:
            for key in keys:  # counted, then dropped, as the tier does
                self.host_tier.insert(key, None)
            return
        if ready is None:
            for i, key in enumerate(keys):
                self.host_tier.insert(key, _HostBlock(_map_leaves(lambda t: t[i].clone(), gathered)))
            return
        if self._slabs is None:
            self._slabs = _PinnedSlabs(_map_leaves(lambda t: (tuple(t.shape[1:]), t.dtype), gathered))
        self._slabs.reserve(self.host_tier.capacity_blocks)
        stream = self._side_stream("spill")
        with torch.cuda.device(self.device), torch.cuda.stream(stream):
            stream.wait_event(ready)
        start = 0
        while start < n:
            count = min(n - start, max(1, self._slabs.available()))
            blocks = []
            try:
                with torch.cuda.device(self.device), torch.cuda.stream(stream):
                    for i in range(start, start + count):
                        blocks.append(self._slabs.take())
                        _map_pairs(lambda dst, src: dst.copy_(src[i], non_blocking=True), blocks[-1],
                                   gathered)
                    done = torch.cuda.Event()
                    done.record(stream)
                done.synchronize()
            except BaseException:
                for block in blocks:
                    self._slabs.free(block)
                raise
            for key, block in zip(keys[start: start + count], blocks):
                if not self.host_tier.insert(key, block):
                    self._drop_block(block)
            start += count

    def _drop_block(self, block) -> None:
        if isinstance(block, _HostBlock) and block.slot is not None:
            self._slabs.free(block)

    def spill_flush(self, timeout_s: float = 30.0) -> None:
        """Wait (at most ``timeout_s``) until every queued spill is in the
        tier; for tests and measurements, never the serving path."""
        if self._spill_q is None:
            return
        deadline = time.monotonic() + timeout_s
        while self._spill_q.unfinished_tasks:
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"host-tier spill queue did not drain in {timeout_s}s "
                    f"({self._spill_q.unfinished_tasks} task(s) pending)")
            time.sleep(0.002)

    # -------------------------------------------------- host tier: restore
    def _host_chain(self, prompt: np.ndarray, start_depth: int) -> List[bytes]:
        """Keys of the consecutive host-tier (or prefetched) blocks of
        ``prompt`` from block depth ``start_depth``, up to the first miss."""
        if self.host_tier is None:
            return []
        bs = self.block_size
        keys: List[bytes] = []
        for depth in range(start_depth, len(prompt) // bs):
            key = prompt[: (depth + 1) * bs].tobytes()
            with self._prefetch_lock:
                prefetched = key in self._prefetched
            if not prefetched and self.host_tier.lookup(key) is None:
                break
            keys.append(key)
        return keys

    def _to_device(self, blocks: List[_HostBlock], stream=None):
        """Host blocks on the device, in order, by non-blocking copies on
        ``stream`` (default: the current one): one copy a leaf for each
        run of consecutive slots of one slab (a prefix spilled together
        lies in such runs), then an event that each slot's next use waits
        for. Under the tier's lock, so the tier cannot let a slot go in
        between. Returns (device payloads, the event)."""
        if self.device.type != "cuda":
            return [_map_leaves(lambda t: t.clone(), b) for b in blocks], None
        per_slab = self._slabs.per_slab
        out: list = []
        with self.host_tier._lock, torch.cuda.device(self.device), \
                torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            i = 0
            while i < len(blocks):
                j = i + 1
                while (j < len(blocks) and blocks[j].slot == blocks[j - 1].slot + 1
                       and blocks[j].slot % per_slab):
                    j += 1
                slab, first = divmod(blocks[i].slot, per_slab)
                run = _map_leaves(lambda t: t[first: first + j - i].to(self.device, non_blocking=True),
                                  self._slabs.slab(slab))
                out.extend(_map_leaves(lambda t: t[k], run) for k in range(j - i))
                i = j
            read = torch.cuda.Event()
            read.record()
            for block in blocks:
                block.reads = [e for e in block.reads if not e.query()] + [read]
        return out, read

    def prefetch(self, prompt) -> int:
        """Start the host-to-device copies of every host-tier block
        ``prompt`` would restore, on a side stream with an event, so they
        overlap the request's wait in the queue. Runs on the submitter's
        thread. Returns how many blocks are now on their way."""
        if self.host_tier is None:
            return 0
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        shared = len(self.pool._shared_prefix(prompt))
        n, keys, blocks = 0, [], []
        for key in self._host_chain(prompt, shared):
            with self._prefetch_lock:
                present = key in self._prefetched
            if not present:
                payload = self.host_tier.lookup(key)
                if payload is None:
                    break
                keys.append(key)
                blocks.append(payload)
            n += 1
        if blocks:
            stream = self._side_stream("prefetch") if self.device.type == "cuda" else None
            payloads, event = self._to_device(blocks, stream)
            with self._prefetch_lock:
                for key, dev in zip(keys, payloads):
                    self._prefetched.setdefault(key, (dev, event))
        return n

    def restore_plan(self, slot: int, prompt: np.ndarray, shared: int, row: np.ndarray):
        """The host-tier blocks a chunked admission restores: the
        consecutive hits past the device registry's ``shared`` blocks, on
        the device (prefetched, or copied now on the current stream), bound
        for the slot's fresh blocks ``row[shared: shared + n]``. Returns
        ``(n, payloads, target_ids)`` or None. A prefetched payload came on
        a side stream: the current stream waits for its event, and its
        memory is marked as used here. The caller scatters the payloads,
        then promotes the slot's first ``n`` parked registrations: the
        restored content is the original bytes."""
        if self.host_tier is None:
            return None
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        payloads, fetch = [], []  # fetch: (index in payloads, host block)
        for key in self._host_chain(prompt, shared):
            with self._prefetch_lock:
                taken = self._prefetched.pop(key, None)
            if taken is None:
                host = self.host_tier.lookup(key)
                if host is None:  # dropped from the tier since the probe
                    break
                fetch.append((len(payloads), host))
                payloads.append(None)
                continue
            dev, event = taken
            if event is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(event)
                _map_leaves(lambda t: t.record_stream(stream), dev)
            self.prefetch_hits += 1
            payloads.append(dev)
        if not payloads:
            return None
        if fetch:
            for (i, _), dev in zip(fetch, self._to_device([b for _, b in fetch])[0]):
                payloads[i] = dev
        n = len(payloads)
        self.host_tier.count_restore(n)
        return n, payloads, np.asarray(row[shared: shared + n], np.int32)

    def release(self, slot):
        self.pool.release(slot)
        self._tables_stale = True

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
        self._tables_stale = True
        # the host tier survives: its keys are content, so a rebuilt engine
        # restores warm prefixes; prefetches die with the store they were
        # bound for
        self._spill_batch = []
        with self._prefetch_lock:
            self._prefetched = {}

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
        out = {
            "backend": self.kind,
            "block_size": self.block_size,
            "pool_blocks": self.pool_blocks,
            "attention_impl": self.attention_impl,
            "hbm_bytes": self.hbm_bytes(),
            "hbm_bytes_live": self.hbm_bytes_live(),
            "reserved_tokens": self.reserved_tokens(),
            **self.pool.stats(),
        }
        if self.host_tier is not None:
            out.update(self.host_tier.stats())
            out["prefetch_hits"] = self.prefetch_hits
        return out


def make_kv_backend(kind: str, *, config, slots: int, max_len: int, prompt_bucket: int,
                    device: torch.device, block_size: int = 16,
                    pool_blocks: Optional[int] = None,
                    attention_impl: str = "reference", tp_group=None,
                    host_tier_bytes: int = 0) -> KVCacheBackend:
    """Factory the engine (and ``ServingConfig.kv_cache``) selects through;
    ``tp_group``: the store holds this ``tp`` rank's kv heads;
    ``host_tier_bytes``: the host-RAM spill tier's capacity (paged only)."""
    if kind == "dense":
        if attention_impl != "reference":
            raise ValueError(
                "attention_impl='kernel' requires a paged KV cache (kv_cache="
                "'paged' or 'paged_int8'); the dense arena has no block tables "
                "for the kernel to walk"
            )
        if host_tier_bytes > 0:
            raise ValueError(
                "kv_host_tier_bytes requires a paged KV cache (kv_cache='paged' or "
                "'paged_int8'); the dense arena has no blocks to spill"
            )
        return DenseKVBackend(config=config, slots=slots, max_len=max_len, device=device,
                              tp_group=tp_group)
    if kind in ("paged", "paged_int8"):
        return PagedKVBackend(
            config=config, slots=slots, max_len=max_len, prompt_bucket=prompt_bucket,
            device=device, block_size=block_size, pool_blocks=pool_blocks,
            quantized=kind == "paged_int8", attention_impl=attention_impl, tp_group=tp_group,
            host_tier_bytes=host_tier_bytes,
        )
    raise ValueError(f"kv_cache must be one of {KV_BACKENDS}, got {kind!r}")


# --------------------------------------------------- static generate() bridge
def pool_from_dense(cache, block_size: int, quantized: bool, group=None):
    """Re-lay a dense prefill cache ``{"k", "v"}`` of (L, B, total_len, kvh,
    hd) as a block pool with identity tables, so static ``generate`` decodes
    through the same :class:`PagedKVLayout` view/commit ops as the engine.
    Row b's block j is pool block ``b * nb + j`` (no null block: every block
    is a row's). ``quantized``: int8 ``{"q", "s"}`` leaves with one scale
    per position (:func:`kv_quantize`; over ``group``'s kv heads too when
    the cache holds a ``tp`` rank's). ``total_len`` must divide by
    ``block_size``. Returns (pool ``{"k", "v"}``, tables (B, nb) int32)."""
    L, b, total, kvh, hd = cache["k"].shape
    if total % block_size:
        raise ValueError(f"total_len {total} must be a multiple of block_size {block_size}")
    nb = total // block_size

    def relay(dense):
        pool = dense.reshape(L, b * nb, block_size, kvh, hd)
        if quantized:
            q, s = kv_quantize(pool, group)
            return {"q": q, "s": s}
        return pool

    tables = torch.arange(b * nb, dtype=torch.int32, device=cache["k"].device).reshape(b, nb)
    return {"k": relay(cache["k"]), "v": relay(cache["v"])}, tables
