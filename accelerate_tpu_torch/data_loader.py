"""Data loading (counterpart of ``accelerate_tpu/data_loader.py``).

:func:`prepare_data_loader` takes, as the JAX package's does:

1. a dict of numpy arrays (a column store) or a map-style dataset
   (``__getitem__``/``__len__``), batched here, optionally shuffled by a
   :class:`SeedableRandomSampler`;
2. a ``torch.utils.data.DataLoader``, rebuilt around a sharded batch
   sampler with its dataset, workers, collate function and pinning kept
   (and, with ``use_seedable_sampler``, a shuffling loader re-drawn from a
   :class:`SeedableRandomSampler`, so a resumed epoch replays its order);
   an ``IterableDataset`` goes through :class:`IterableDatasetShard`;
3. any iterable of ready batches.

It returns a :class:`DataLoaderShard` (or, with ``dispatch_batches``, a
:class:`DataLoaderDispatcher`) that yields tensors on the device. A host
thread (:class:`_DevicePrefetcher`) collates and pins each batch and copies
it on a side CUDA stream while the step before it runs; the step's stream
waits on the copy's event. The loader registers with ``GradientState``
while iterated and looks one batch ahead, so the last batch arrives with
``end_of_dataloader`` set. ``state_dict``/``load_state_dict`` give an exact
mid-epoch resume: the epoch and the batches already handed out (a seeded
order is replayed and skipped), or a stateful dataset's own state.

Several processes: each reads its own rows. The shard a process reads
comes from the mesh (``mesh=``, default the one the ``Accelerator`` shards
over; :func:`data_shard_info` over the ``batch_axes``), else from the
process index; ``batch_size`` is per process unless ``split_batches``.
With ``dispatch_batches`` the main process reads each global batch and
broadcasts it, and every process keeps its block of rows (the rows the JAX
package's global array puts on that process). ``rng_types`` synchronizes
those generators from the main process at every epoch
(``utils/random.py``), so a shuffle draws the same order everywhere.
"""

from __future__ import annotations

import collections
import collections.abc
import copy
import itertools
import math
import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from . import tracing
from ._device import resolve_device
from .state import GradientState, PartialState, process_layout

__all__ = [
    "BatchSamplerShard",
    "DataLoaderDispatcher",
    "BatchSharding",
    "DataLoaderShard",
    "IterableDatasetShard",
    "SeedableRandomSampler",
    "batch_sharding",
    "data_shard_info",
    "default_collate",
    "make_padded_collate",
    "prepare_data_loader",
    "skip_first_batches",
]


# --------------------------------------------------------------------- helpers
def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (nested dicts/tuples of arrays or scalars)."""
    first = samples[0]
    if isinstance(first, dict):
        return type(first)({k: default_collate([s[k] for s in samples]) for k in first})
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples], axis=0)


def make_padded_collate(pad_token_id: int = 0, max_length: Optional[int] = None,
                        ragged_keys: Sequence[str] = ("input_ids",), emit_loss_mask: bool = True):
    """A ``collate_fn`` for variable-length samples: the ragged keys are
    padded to one width (``max_length`` or the batch's longest) by the
    native ``collate_padded`` (``utils/native.py``), and a ``loss_mask`` of
    the first ragged key is added so padding adds no loss. Other keys go
    through :func:`default_collate`. Pass ``max_length`` for one shape per
    batch (a CUDA graph or a compiled step needs it)."""
    from .utils.native import collate_padded

    def collate(samples: Sequence[Any]):
        if not samples:
            return {}
        if not isinstance(samples[0], dict):
            tokens, mask = collate_padded(samples, max_length, pad_token_id)
            out = {"input_ids": tokens}
            if emit_loss_mask:
                out["loss_mask"] = mask
            return out
        present = [k for k in ragged_keys if k in samples[0]]
        width = max_length
        if width is None and present:
            width = max(len(np.asarray(s[k]).ravel()) for s in samples for k in present)
        out, mask = {}, None
        for key in samples[0]:
            values = [s[key] for s in samples]
            if key in present:
                out[key], key_mask = collate_padded(values, width, pad_token_id)
                if key == present[0]:
                    mask = key_mask
            else:
                out[key] = default_collate(values)
        if emit_loss_mask and mask is not None and "loss_mask" not in out:
            out["loss_mask"] = mask
        return out

    return collate


class BatchSharding(collections.namedtuple("BatchSharding", "mesh batch_axes seq_axes")):
    """How a batch lies on a ``DeviceMesh``: dim 0 over ``batch_axes``
    (the JAX package's ``NamedSharding(mesh, P(batch_axes, seq_axes))``)."""

    def row_blocks(self) -> dict:
        """``{rank: (start, stop)}``: the block of the batch dimension's
        rows each rank holds, the ranks of the batch axes in row-major
        order (one process per rank)."""
        import numpy as _np

        names = tuple(self.mesh.mesh_dim_names)
        ranks = _np.asarray(self.mesh.mesh.tolist())
        axes = [names.index(a) for a in self.batch_axes]
        sizes = [ranks.shape[i] for i in axes]
        blocks = {}
        for coord in _np.ndindex(*ranks.shape):
            row = 0
            for i, size in zip(axes, sizes):
                row = row * size + coord[i]
            blocks[int(ranks[coord])] = (row, row + 1)
        return blocks


def batch_sharding(mesh, batch_axes: Sequence[str] = ("dp_replicate", "dp_shard"),
                   seq_axes: Sequence[str] = ()) -> BatchSharding:
    """A batch's :class:`BatchSharding` on ``mesh``: the listed axes the
    mesh has above size 1. A sequence axis (cp, sp) waits for ROADMAP.md
    A11."""
    names = tuple(mesh.mesh_dim_names or ())

    def present(axes):
        return tuple(a for a in axes if a in names and mesh.size(names.index(a)) > 1)

    if present(seq_axes):
        raise NotImplementedError(f"seq_axes={tuple(seq_axes)}: a batch sharded on its sequence "
                                  "dim (context/sequence parallelism) waits for ROADMAP.md A11")
    return BatchSharding(mesh, present(batch_axes), ())


def data_shard_info(sharding=None, process_index: Optional[int] = None,
                    num_processes: Optional[int] = None,
                    process_of_device: Optional[Callable] = None) -> tuple:
    """Which slice of the batch this process reads: ``(num_shards,
    shard_index, rows_per_shard)``. ``sharding`` is a
    :class:`BatchSharding` (its mesh's ranks are the processes), or a dict
    mapping each device to the ``(start, stop)`` block of the batch
    dimension's ``n_rows`` blocks it holds (the JAX package reads it from a
    sharding's index map), with ``process_of_device``. Processes whose
    devices hold the same rows (tensor or context parallel ranks) read the
    same slice; ``None`` takes the batch's sharding on the mesh the
    ``Accelerator`` laid out (its data-parallel dims: the ``tp`` ranks of
    one coordinate read the same rows), and without one every process is
    its own data shard."""
    index, count = process_layout()
    process_index = index if process_index is None else process_index
    num_processes = count if num_processes is None else num_processes
    if sharding is None:
        from .state import AcceleratorState

        mesh = AcceleratorState._shared_state.get("device_mesh")
        if mesh is not None and mesh.size() == num_processes:
            sharding = batch_sharding(mesh)
    if sharding is None:
        return (num_processes, process_index, 1) if num_processes > 1 else (1, 0, 1)
    if isinstance(sharding, BatchSharding):
        row_blocks, process_of_device = sharding.row_blocks(), (lambda rank: rank)
    else:
        row_blocks = sharding
    if process_of_device is None:
        process_of_device = lambda d: d.process_index  # noqa: E731
    n_rows = max(stop for _, stop in row_blocks.values())
    if n_rows <= 1 or num_processes <= 1:
        return 1, 0, 1
    proc_rows: dict = {}
    for dev, (start, stop) in row_blocks.items():
        proc_rows.setdefault(process_of_device(dev), set()).update(range(start, stop))
    groups: dict = {}
    for proc, rows in proc_rows.items():
        groups.setdefault(frozenset(rows), []).append(proc)
    ordered = sorted(groups.items(), key=lambda kv: min(kv[0]))
    shard_index = next((i for i, (_, procs) in enumerate(ordered) if process_index in procs), 0)
    return len(ordered), shard_index, n_rows // len(ordered)


# --------------------------------------------------------------------- sampler
class SeedableRandomSampler:
    """Deterministic shuffling: a permutation from ``seed + epoch``, so a
    resumed run sees the same order (numpy's generator, as in the JAX
    package, so both draw the same permutation)."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0, generator=None):
        # generator: a torch.Generator of the reference's sampler, accepted
        # as the JAX package accepts it; the order is drawn from the seed
        self.data_source_len = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.data_source_len

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        yield from rng.permutation(self.data_source_len).tolist()


class BatchSamplerShard:
    """A batch sampler's batches for one of ``num_processes`` processes.
    ``split_batches=False``: the sampler yields per-process batches and
    process ``i`` takes every ``num_processes``-th from ``i``;
    ``split_batches=True``: it yields global batches and each process takes
    its ``1/num_processes`` slice. ``even_batches`` refills a short tail
    from the start so every process yields as many full batches;
    ``drop_last`` (read from the sampler) drops it instead."""

    def __init__(self, batch_sampler: Iterable, num_processes: int = 1, process_index: int = 0,
                 split_batches: bool = False, even_batches: bool = True):
        if (split_batches and num_processes > 1
                # probing a one-shot iterator would consume its first batch
                and not isinstance(batch_sampler, collections.abc.Iterator)):
            first = next(iter(batch_sampler), None)
            if first is not None and len(first) % num_processes != 0:
                raise ValueError(
                    f"split_batches=True requires batch size ({len(first)}) divisible "
                    f"by num_processes ({num_processes})")
        self.batch_sampler = batch_sampler
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches
        self.batch_size = getattr(batch_sampler, "batch_size", None)
        self.drop_last = getattr(batch_sampler, "drop_last", False)

    @property
    def total_length(self) -> int:
        return len(self.batch_sampler)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.batch_sampler)
        if self.split_batches:
            return n
        if n % self.num_processes == 0:
            return n // self.num_processes
        length = n // self.num_processes
        if self.drop_last:
            return length
        return length + 1 if self.even_batches else length + int(
            self.process_index < n % self.num_processes)

    def __iter__(self) -> Iterator[list]:
        yield from self._iter_split() if self.split_batches else self._iter_stride()

    def _iter_split(self):
        for batch in self.batch_sampler:
            size = len(batch) // self.num_processes
            start = self.process_index * size
            chunk = batch[start:start + size]
            if len(chunk) == size or not self.drop_last:
                if len(chunk) < size and self.even_batches and len(batch) > 0:
                    chunk = chunk + batch[:size - len(chunk)]
                if chunk:
                    yield chunk

    def _iter_stride(self):
        it = iter(self.batch_sampler)
        stored: list = []  # the first full cycle, kept to refill the tail
        while True:
            cycle = list(itertools.islice(it, self.num_processes))
            if not cycle:
                return
            size = self.batch_size or len(cycle[0])
            if len(cycle) == self.num_processes and len(cycle[-1]) == size:
                if len(stored) < self.num_processes:
                    stored.extend(cycle)
                yield cycle[self.process_index]
                continue
            # the incomplete last cycle
            if self.drop_last:
                return
            if not self.even_batches:
                if self.process_index < len(cycle):
                    yield cycle[self.process_index]
                return
            pool = [i for b in (stored or cycle) for i in b]
            batch = cycle[self.process_index] if self.process_index < len(cycle) else []
            fill = 0
            while len(batch) < size and pool:
                batch = batch + [pool[fill % len(pool)]]
                fill += 1
            if batch:
                yield batch
            return


class IterableDatasetShard(torch.utils.data.IterableDataset):
    """An iterable dataset's samples for one process: buffer ``batch_size *
    num_processes`` samples (``batch_size`` with ``split_batches``) and take
    this process's slice; a short tail is refilled from the first batch
    unless ``drop_last``."""

    def __init__(self, dataset: Iterable, batch_size: int = 1, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __iter__(self):
        real = self.batch_size if self.split_batches else self.batch_size * self.num_processes
        per = real // self.num_processes
        process_slice = range(self.process_index * per, (self.process_index + 1) * per)
        first_batch, current = None, []
        for element in self.dataset:
            current.append(element)
            if len(current) == real:
                for i in process_slice:
                    yield current[i]
                if first_batch is None:
                    first_batch = current.copy()
                current = []
        if not self.drop_last and current:
            if first_batch is None:
                first_batch = current.copy()
            while len(current) < real:
                current += first_batch
            for i in process_slice:
                yield current[i]


# ---------------------------------------------------------------- transfers
def _to_device(batch, device: Optional[torch.device], non_blocking: bool):
    """Numpy leaves as tensors on ``device`` (left on the host when
    ``device`` is None); for the card through pinned host memory, so a
    ``non_blocking`` copy overlaps the running step."""
    if isinstance(batch, dict):
        return type(batch)((k, _to_device(v, device, non_blocking)) for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device, non_blocking) for v in batch)
    if isinstance(batch, (np.ndarray, np.generic)):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not isinstance(batch, torch.Tensor) or device is None:
        return batch
    if device.type == "cuda" and batch.device.type == "cpu":
        if not batch.is_pinned():
            batch = batch.pin_memory()
        return batch.to(device, non_blocking=non_blocking)
    return batch.to(device)


def _tensor_leaves(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _tensor_leaves(v)
    elif isinstance(batch, (list, tuple)):
        for v in batch:
            yield from _tensor_leaves(v)
    elif isinstance(batch, torch.Tensor):
        yield batch


class _DevicePrefetcher:
    """A host thread that takes each host batch from ``iterator`` (so the
    dataset's reads and collation run there), pins it and copies it to the
    card on a side CUDA stream, recording an event; ``__next__`` makes the
    consumer's current stream wait on that event and ``record_stream``s
    every tensor to it, so the caching allocator keeps the memory until the
    step that reads it is done. ``depth`` batches may wait in the queue. On
    the CPU ``put_fn`` runs in the thread and there is no stream.

    ``wait_s`` sums the time the consumer waited for a batch (the data
    wait a step sees). A consumer that abandons iteration must call
    :meth:`close` (the owning loader does): it stops the thread, drains the
    staged batches and joins."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, put_fn: Callable[[Any], Any], depth: int = 2,
                 device: Optional[torch.device] = None):
        self.iterator = iterator
        self.put_fn = put_fn
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self.wait_s = 0.0
        self.batches = 0
        self._fetches = 0
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._worker, daemon=True, name="device-prefetch")
        self.thread.start()

    def _put(self, item) -> bool:
        """A put that gives way to :meth:`close` instead of blocking on a
        full queue nobody reads. False on stop."""
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            cuda = self.device is not None and self.device.type == "cuda"
            if cuda:
                torch.cuda.set_device(self.device)
                stream = torch.cuda.Stream(self.device)
            for item in self.iterator:
                if self._stop.is_set():
                    return
                if cuda:
                    with torch.cuda.stream(stream):
                        staged = self.put_fn(item)
                        event = torch.cuda.Event()
                        event.record(stream)
                else:
                    staged, event = self.put_fn(item), None
                if not self._put((staged, event)):
                    return
        except BaseException as e:  # noqa: BLE001 - raised again on the consumer's thread
            self.error = e
        finally:
            self._put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        # the blocking get is the data wait (a sampled span)
        step = self._fetches
        self._fetches += 1
        t0 = time.perf_counter()
        with tracing.step_span("train.data_wait", step):
            item = self.q.get()
        self.wait_s += time.perf_counter() - t0
        if item is self._SENTINEL:
            if self.error is not None:
                raise self.error
            raise StopIteration
        staged, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in _tensor_leaves(staged):
                if t.device.type == "cuda":
                    t.record_stream(stream)
        self.batches += 1
        return staged

    @property
    def closed(self) -> bool:
        return self._stop.is_set() and not self.thread.is_alive()

    def close(self, timeout: float = 5.0) -> bool:
        """Stop the thread, drain what it staged and join. Idempotent.
        True when the thread ended within ``timeout``."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self.thread.is_alive() and time.monotonic() < deadline:
            self._drain()
            self.thread.join(timeout=0.05)
        self._drain()
        return not self.thread.is_alive()

    def _drain(self) -> None:
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass


# ------------------------------------------------------------------- loaders
class _BaseAcceleratedLoader:
    """What both loaders share: ``GradientState`` registration, the
    one-batch lookahead that sets ``end_of_dataloader`` before the last
    batch, the remainder ``gather_for_metrics`` drops, the device
    prefetcher, and the exact resume position (``_position``: batches
    handed out this epoch, skipped ones included)."""

    def __init__(self, device: Optional[torch.device], device_prefetch: bool = True,
                 non_blocking: bool = True, total_dataset_length: Optional[int] = None,
                 total_batch_size: Optional[int] = None):
        self.device = device
        self.device_prefetch = device_prefetch
        self.non_blocking = non_blocking
        self.gradient_state = GradientState()
        self.end_of_dataloader = False
        self.remainder = -1
        self.total_dataset_length = total_dataset_length
        self._total_batch_size = total_batch_size
        self.iteration = 0
        self._position = 0
        self._skip_once = 0  # one-shot resume position set by load_state_dict
        # a stateful dataset's state, snapshotted as each batch is produced
        # and handed over with that batch: the lookahead and the prefetcher
        # run several batches ahead of the training loop
        self._ds_state_fifo: collections.deque = collections.deque()
        self._last_ds_state = None
        self._active_prefetcher: Optional[_DevicePrefetcher] = None

    @property
    def total_batch_size(self) -> Optional[int]:
        return self._total_batch_size

    @property
    def data_wait_s(self) -> float:
        """Seconds the training loop waited for batches in the running or
        last epoch (0 without the prefetcher)."""
        prefetcher = self._active_prefetcher or getattr(self, "_last_prefetcher", None)
        return prefetcher.wait_s if prefetcher is not None else 0.0

    def _place(self, batch):
        return _to_device(batch, self.device, self.non_blocking)

    def _resume_position(self) -> int:
        """The position a checkpoint records: a restored position the next
        epoch has not started from yet, else the batches handed out. (The
        JAX package records the latter only, so a loader saved again right
        after its own restore starts that epoch over.)"""
        return self._skip_once or self._position

    def _with_ds_snapshots(self, it):
        ds = self.dataset
        if not hasattr(ds, "state_dict"):
            return it

        def snapshotting():
            self._ds_state_fifo.clear()
            for batch in it:
                self._ds_state_fifo.append(copy.deepcopy(ds.state_dict()))
                yield batch

        return snapshotting()

    def _close_prefetcher(self) -> None:
        prefetcher, self._active_prefetcher = self._active_prefetcher, None
        if prefetcher is not None:
            prefetcher.close()

    def __del__(self):
        try:
            self._close_prefetcher()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass

    def _iter_with_gradient_state(self, raw_iter):
        self.end_of_dataloader = False
        # a new epoch abandons the previous one's iterator: reap its thread
        self._close_prefetcher()
        self.gradient_state._add_dataloader(self)
        prefetcher = None
        try:
            if self.device_prefetch:
                prefetcher = _DevicePrefetcher(raw_iter, self._place, device=self.device)
                self._active_prefetcher = self._last_prefetcher = raw_iter = prefetcher
                place = lambda b: b  # noqa: E731
            else:
                place = self._place
            current, have = None, False
            for nxt in raw_iter:
                nxt = place(nxt)
                if have:
                    # counted when handed out: a save while batch k runs
                    # resumes at k + 1
                    self._position += 1
                    if self._ds_state_fifo:
                        self._last_ds_state = self._ds_state_fifo.popleft()
                    yield current
                current, have = nxt, True
            if have:
                self.end_of_dataloader = True
                self._position += 1
                if self._ds_state_fifo:
                    self._last_ds_state = self._ds_state_fifo.popleft()
                yield current
                # the epoch was drained: a save from here on must not skip
                # into the next epoch
                self._position = 0
        finally:
            # on exhaustion and on GeneratorExit (break, exception); close
            # this epoch's prefetcher, not a newer epoch's
            if prefetcher is not None:
                prefetcher.close()
                if self._active_prefetcher is prefetcher:
                    self._active_prefetcher = None
            self.gradient_state._remove_dataloader(self)
            self.iteration += 1


class DataLoaderShard(_BaseAcceleratedLoader):
    """This process's loader over an inner iterable of host batches (a
    batcher, a torch ``DataLoader`` or any iterable), yielding them on
    ``device``. ``sharding``: the :class:`BatchSharding` the rows were
    chosen by (kept for the caller; the inner iterable already holds this
    process's rows). ``rng_types`` (and ``synchronized_generator``, a
    ``torch.Generator``) are synchronized from the main process as each
    epoch starts."""

    def __init__(self, inner: Iterable, device: Optional[torch.device] = None,
                 device_prefetch: bool = True, non_blocking: bool = True,
                 batch_sampler: Optional[BatchSamplerShard] = None,
                 total_dataset_length: Optional[int] = None,
                 total_batch_size: Optional[int] = None, sampler=None,
                 sharding: Optional[BatchSharding] = None,
                 rng_types: Optional[Sequence[str]] = None, synchronized_generator=None):
        super().__init__(device, device_prefetch, non_blocking, total_dataset_length,
                         total_batch_size)
        self.inner = inner
        self.batch_sampler = batch_sampler
        self.sampler = sampler
        self.sharding = sharding
        self.rng_types = rng_types
        self.synchronized_generator = synchronized_generator
        self._skip_batches = 0

    @property
    def dataset(self):
        return getattr(self.inner, "dataset", self.inner)

    def set_epoch(self, epoch: int) -> None:
        """Reshuffle: the sampler draws from ``seed + epoch``."""
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if hasattr(self.inner, "set_epoch"):
            self.inner.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return max(0, len(self.inner) - self._skip_batches)

    def __iter__(self):
        if self.total_dataset_length is not None and self.total_batch_size:
            rem = self.total_dataset_length % self.total_batch_size
            self.remainder = rem if rem != 0 else -1
        if self.rng_types:
            from .utils.random import synchronize_rng_states

            synchronize_rng_states(self.rng_types, self.synchronized_generator)
        # _skip_once is an absolute position (it counts the skipped
        # batches already); adding _skip_batches would skip them twice
        skip = self._skip_once or self._skip_batches
        self._skip_once = 0
        self._position = skip
        it = iter(self.inner)
        for _ in range(skip):
            next(it, None)
        yield from self._iter_with_gradient_state(self._with_ds_snapshots(it))

    def state_dict(self) -> dict:
        """The exact resume state: the epoch and the batches handed out in
        it, and a stateful dataset's own state."""
        state = {
            "iteration": self.iteration,
            "skip_batches": self._skip_batches,
            "position": self._resume_position(),
            "epoch": getattr(self.sampler, "epoch", 0) if self.sampler is not None else 0,
        }
        if self.total_batch_size:
            state["total_batch_size"] = self.total_batch_size
        if self._last_ds_state is not None:
            state["dataset_state"] = self._last_ds_state
        elif hasattr(self.dataset, "state_dict"):
            state["dataset_state"] = self.dataset.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        self.iteration = state.get("iteration", 0)
        self._skip_batches = state.get("skip_batches", 0)
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(state.get("epoch", 0))
        if "dataset_state" in state and hasattr(self.dataset, "load_state_dict"):
            self.dataset.load_state_dict(state["dataset_state"])
        else:
            # a seeded order is drawn again from (seed, epoch), so skipping
            # `position` batches lands where the checkpoint was taken
            self._skip_once = state.get("position", 0)


class DataLoaderDispatcher(_BaseAcceleratedLoader):
    """The main process reads every global batch and broadcasts it; each
    process keeps its block of rows (``num_shards`` blocks, this process's
    the ``shard_index``-th: the rows the JAX package's global array puts on
    it). A last batch whose rows do not divide is filled from its first
    rows, as even batches are, and ``remainder`` counts the real ones.
    With one process it reads and yields."""

    def __init__(self, inner: Iterable, device: Optional[torch.device] = None,
                 device_prefetch: bool = True, non_blocking: bool = True,
                 split_batches: bool = True, total_dataset_length: Optional[int] = None,
                 total_batch_size: Optional[int] = None, sharding: Optional[BatchSharding] = None,
                 num_shards: int = 1, shard_index: int = 0):
        super().__init__(device, device_prefetch, non_blocking, total_dataset_length,
                         total_batch_size)
        self.inner = inner
        self.split_batches = split_batches
        self.sharding = sharding
        self.num_shards = num_shards
        self.shard_index = shard_index
        if process_layout()[1] > 1:
            # the broadcast is a collective: it runs on the training thread,
            # in the order every rank issues its collectives, not on the
            # prefetch thread
            self.device_prefetch = False

    @property
    def dataset(self):
        return getattr(self.inner, "dataset", self.inner)

    def __len__(self) -> int:
        return len(self.inner)

    def _fetch(self):
        if process_layout()[1] == 1:
            yield from iter(self.inner)
            return
        from .ops.operations import broadcast_object_list

        it = iter(self.inner) if PartialState().is_main_process else None
        while True:
            # [batch] from the main process, [None] when it ran out
            box = [next(it, None) if it is not None else None]
            batch = broadcast_object_list(box, from_process=0)[0]
            if batch is None:
                return
            yield self._rows(batch)

    def _rows(self, batch):
        """This process's block of a global batch's rows."""
        n = self.num_shards

        def take(x):
            if not hasattr(x, "shape") or not getattr(x, "shape", ()):
                return x
            rows = x.shape[0]
            per = -(-rows // n)
            if rows % n:
                fill = np.arange(per * n) % rows
                x = x[torch.from_numpy(fill)] if isinstance(x, torch.Tensor) else x[fill]
            return x[self.shard_index * per:(self.shard_index + 1) * per]

        if isinstance(batch, dict):
            return type(batch)((k, self._rows(v) if isinstance(v, (dict, list, tuple)) else take(v))
                               for k, v in batch.items())
        if isinstance(batch, (list, tuple)):
            return type(batch)(self._rows(v) if isinstance(v, (dict, list, tuple)) else take(v)
                               for v in batch)
        return take(batch)

    def __iter__(self):
        if self.total_dataset_length is not None and self.total_batch_size:
            rem = self.total_dataset_length % self.total_batch_size
            self.remainder = rem if rem != 0 else -1
        skip, self._skip_once = self._skip_once, 0
        self._position = skip
        it = self._fetch()
        for _ in range(skip):
            next(it, None)
        yield from self._iter_with_gradient_state(self._with_ds_snapshots(it))

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.inner, "set_epoch"):
            self.inner.set_epoch(epoch)
        elif hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def state_dict(self) -> dict:
        state = {"iteration": self.iteration, "position": self._resume_position()}
        if self._last_ds_state is not None:
            state["dataset_state"] = self._last_ds_state
        elif hasattr(self.dataset, "state_dict"):
            state["dataset_state"] = self.dataset.state_dict()
        return state

    def load_state_dict(self, state: dict) -> None:
        self.iteration = state.get("iteration", 0)
        if "dataset_state" in state and hasattr(self.dataset, "load_state_dict"):
            self.dataset.load_state_dict(state["dataset_state"])
        else:
            self._skip_once = state.get("position", 0)


# ------------------------------------------------------------ native batching
class _ArrayBatcher:
    """Host batches (numpy) from a dict-of-arrays or map-style dataset."""

    def __init__(self, dataset, batch_sampler, collate_fn=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate

    def __len__(self):
        return len(self.batch_sampler)

    def set_epoch(self, epoch):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)

    def __iter__(self):
        for batch_indices in self.batch_sampler:
            if isinstance(self.dataset, dict):
                yield {k: np.asarray(v)[batch_indices] for k, v in self.dataset.items()}
            else:
                yield self.collate_fn([self.dataset[i] for i in batch_indices])


class _SimpleBatchSampler:
    """Chunk an index sampler into batches (torch's ``BatchSampler``)."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch):
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch


# -------------------------------------------------------------------- factory
def prepare_data_loader(
    dataloader,
    device=None,
    batch_size: Optional[int] = None,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    collate_fn=None,
    split_batches: bool = False,
    even_batches: bool = True,
    dispatch_batches: Optional[bool] = None,
    device_prefetch: bool = True,
    non_blocking: bool = True,
    use_seedable_sampler: bool = True,
    put_on_device: bool = True,
    mesh=None,
    rng_types: Optional[Sequence[str]] = None,
    batch_axes: Sequence[str] = ("dp_replicate", "dp_shard"),
    seq_axes: Sequence[str] = (),
):
    """A loader over ``dataloader`` (see the module docstring for what it
    takes) that yields batches on ``device`` (default: the state's device,
    the card unless the state was made with ``cpu=True``;
    ``put_on_device=False`` leaves them on the host). ``batch_size`` is
    per process unless ``split_batches``. ``mesh`` (default: the
    ``Accelerator``'s, if it built one) and ``batch_axes`` decide which rows
    this process reads (:func:`data_shard_info`); ``rng_types`` are
    synchronized from the main process at every epoch."""
    if isinstance(dataloader, (DataLoaderShard, DataLoaderDispatcher)):
        return dataloader
    if not put_on_device:
        device = None
    elif device is None:
        device = PartialState().device
    else:
        device = resolve_device(device)
    if mesh is None:
        from .state import AcceleratorState

        mesh = AcceleratorState._shared_state.get("device_mesh")
    sharding = batch_sharding(mesh, batch_axes, seq_axes) if mesh is not None else None
    if sharding is not None and process_layout()[1] > 1:
        num_shards, shard_index, _ = data_shard_info(sharding)
    else:
        num_shards, shard_index = process_layout()[::-1]
        num_shards, shard_index = (num_shards, shard_index) if num_shards > 1 else (1, 0)
    common = dict(device=device, device_prefetch=device_prefetch, non_blocking=non_blocking)
    shard_kw = dict(sharding=sharding, rng_types=rng_types)
    dispatch_kw = dict(sharding=sharding, num_shards=num_shards, shard_index=shard_index)

    if isinstance(dataloader, torch.utils.data.DataLoader):
        return _prepare_from_torch_loader(
            dataloader, num_shards, shard_index, split_batches, even_batches,
            bool(dispatch_batches), use_seedable_sampler, seed, common, shard_kw, dispatch_kw)

    dataset = dataloader
    if isinstance(dataset, dict) or (hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__")):
        if batch_size is None:
            raise ValueError("batch_size is required when passing a dataset")
        length = len(next(iter(dataset.values()))) if isinstance(dataset, dict) else len(dataset)
        sampler = SeedableRandomSampler(length, seed=seed) if shuffle else range(length)
        global_batch = batch_size if split_batches else batch_size * num_shards
        if dispatch_batches:
            inner = _ArrayBatcher(dataset, _SimpleBatchSampler(sampler, global_batch, drop_last),
                                  collate_fn)
            return DataLoaderDispatcher(inner, total_dataset_length=length,
                                        total_batch_size=global_batch, **common, **dispatch_kw)
        base = _SimpleBatchSampler(sampler, global_batch // num_shards, drop_last)
        shard_sampler = (BatchSamplerShard(base, num_processes=num_shards, process_index=shard_index,
                                           even_batches=even_batches)
                         if num_shards > 1 else base)
        return DataLoaderShard(_ArrayBatcher(dataset, shard_sampler, collate_fn),
                               batch_sampler=shard_sampler,
                               sampler=sampler if shuffle else None, total_dataset_length=length,
                               total_batch_size=global_batch, **common, **shard_kw)

    if not isinstance(dataset, collections.abc.Iterable):
        raise TypeError(f"cannot prepare a loader over {type(dataset).__name__}: expected a dict "
                        "of arrays, a map-style dataset, a torch DataLoader or an iterable of batches")
    # an iterable of ready batches
    return DataLoaderShard(dataset, **common, **shard_kw)


def _prepare_from_torch_loader(loader, num_shards, shard_index, split_batches, even_batches,
                               dispatch_batches, use_seedable_sampler, seed, common, shard_kw,
                               dispatch_kw):
    """Rebuild a torch ``DataLoader`` around a sharded batch sampler, with
    its dataset, workers, collate function and pinning."""
    import torch.utils.data as tud

    dataset = loader.dataset
    kept = dict(collate_fn=loader.collate_fn, num_workers=loader.num_workers,
                pin_memory=loader.pin_memory, timeout=loader.timeout,
                worker_init_fn=loader.worker_init_fn,
                multiprocessing_context=loader.multiprocessing_context,
                persistent_workers=loader.persistent_workers)
    if loader.num_workers > 0:
        kept["prefetch_factor"] = loader.prefetch_factor
    if isinstance(dataset, tud.IterableDataset):
        shard = IterableDatasetShard(dataset, batch_size=loader.batch_size or 1,
                                     drop_last=loader.drop_last, num_processes=num_shards,
                                     process_index=shard_index, split_batches=split_batches)
        return DataLoaderShard(tud.DataLoader(shard, batch_size=loader.batch_size, **kept),
                               **common, **shard_kw)

    batch_sampler, sampler = loader.batch_sampler, None
    if (use_seedable_sampler and loader.batch_size is not None
            and isinstance(loader.sampler, tud.RandomSampler)):
        sampler = SeedableRandomSampler(len(dataset), seed=seed)
        batch_sampler = tud.BatchSampler(sampler, loader.batch_size, loader.drop_last)
    if dispatch_batches:
        # the loader's own batches are the global batches handed out
        return DataLoaderDispatcher(tud.DataLoader(dataset, batch_sampler=batch_sampler, **kept),
                                    total_dataset_length=len(dataset),
                                    total_batch_size=loader.batch_size or 1, **common,
                                    **dispatch_kw)
    shard_sampler = BatchSamplerShard(batch_sampler, num_processes=num_shards,
                                      process_index=shard_index, split_batches=split_batches,
                                      even_batches=even_batches)
    total_bs = (loader.batch_size or 1) * (1 if split_batches else num_shards)
    return DataLoaderShard(tud.DataLoader(dataset, batch_sampler=shard_sampler, **kept),
                           batch_sampler=shard_sampler, sampler=sampler,
                           total_dataset_length=len(dataset), total_batch_size=total_bs, **common,
                           **shard_kw)


# ---------------------------------------------------------------------- skip
class _Skipper:
    """The batches of an iterable after its first ``n``."""

    def __init__(self, inner, n: int):
        self.inner = inner
        self.n = n

    def __len__(self):
        return max(0, len(self.inner) - self.n)

    def __iter__(self):
        it = iter(self.inner)
        for _ in range(self.n):
            next(it, None)
        yield from it


def skip_first_batches(dataloader, num_batches: int = 0):
    """Skip the first ``num_batches`` of the next epoch (a prepared loader
    counts them in its resume position); any other iterable is wrapped."""
    if isinstance(dataloader, DataLoaderShard):
        dataloader._skip_batches = num_batches
        return dataloader
    return _Skipper(dataloader, num_batches)
