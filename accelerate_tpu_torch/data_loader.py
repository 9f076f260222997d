"""Single-process, map-style data loading (counterpart of
``accelerate_tpu/data_loader.py``).

:func:`prepare_data_loader` batches a dict of numpy arrays (a column store)
or a ``__getitem__``/``__len__`` dataset, optionally shuffled by a
:class:`SeedableRandomSampler`, and wraps it in a :class:`DataLoaderShard`
that yields device tensors: each batch is copied into pinned host memory
and sent with a ``non_blocking`` copy while the step before it runs. The
loader registers with ``GradientState`` while iterated and looks one batch
ahead, so the last batch arrives with ``end_of_dataloader`` already set
(what forces the final gradient sync).

Queued with the data path (ROADMAP.md A5): ``BatchSamplerShard``,
``DataLoaderDispatcher``, unwrapping a ``torch.utils.data.DataLoader``,
iterables of ready batches and ``skip_first_batches``.
"""

from __future__ import annotations

import math
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

from .state import GradientState, PartialState

__all__ = [
    "DataLoaderShard",
    "SeedableRandomSampler",
    "default_collate",
    "prepare_data_loader",
]


def default_collate(samples: Sequence[Any]):
    """Stack a list of samples (nested dicts/tuples of arrays or scalars)."""
    first = samples[0]
    if isinstance(first, dict):
        return type(first)({k: default_collate([s[k] for s in samples]) for k in first})
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate([s[i] for s in samples]) for i in range(len(first)))
    return np.stack([np.asarray(s) for s in samples], axis=0)


class SeedableRandomSampler:
    """Deterministic shuffling: a permutation from ``seed + epoch``, so a
    resumed run sees the same order (numpy's generator, as in the JAX
    package, so both draw the same permutation)."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
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


class _SimpleBatchSampler:
    """Chunk an index sampler into batches."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False):
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last

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


class _ArrayBatcher:
    """Host batches (numpy) from a dict-of-arrays or map-style dataset."""

    def __init__(self, dataset, batch_sampler, collate_fn=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn or default_collate

    def __len__(self):
        return len(self.batch_sampler)

    def __iter__(self):
        for batch_indices in self.batch_sampler:
            if isinstance(self.dataset, dict):
                yield {k: np.asarray(v)[batch_indices] for k, v in self.dataset.items()}
            else:
                yield self.collate_fn([self.dataset[i] for i in batch_indices])


def _to_device(batch, device: torch.device, non_blocking: bool):
    """Numpy leaves as tensors on ``device``; for the card through pinned
    host memory, so a ``non_blocking`` copy overlaps the running step."""
    if isinstance(batch, dict):
        return type(batch)((k, _to_device(v, device, non_blocking)) for k, v in batch.items())
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device, non_blocking) for v in batch)
    if isinstance(batch, (np.ndarray, np.generic)):
        batch = torch.from_numpy(np.ascontiguousarray(batch))
    if not isinstance(batch, torch.Tensor):
        return batch
    if device.type == "cuda" and batch.device.type == "cpu":
        return batch.pin_memory().to(device, non_blocking=non_blocking)
    return batch.to(device)


class DataLoaderShard:
    """Iterates host batches and yields them as tensors on ``device``. While
    iterated it is the active loader of ``GradientState``; a one-batch
    lookahead sets ``end_of_dataloader`` before the last batch is handed
    out. ``set_epoch`` reshuffles (a new seed for the sampler)."""

    def __init__(self, inner, device: torch.device, non_blocking: bool = True, sampler=None):
        self.inner = inner
        self.device = device
        self.non_blocking = non_blocking
        self.sampler = sampler
        self.gradient_state = GradientState()
        self.end_of_dataloader = False

    def set_epoch(self, epoch: int) -> None:
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.inner)

    def __iter__(self):
        self.end_of_dataloader = False
        self.gradient_state._add_dataloader(self)
        try:
            current = None
            for nxt in self.inner:
                nxt = _to_device(nxt, self.device, self.non_blocking)  # copy batch k+1 while k runs
                if current is not None:
                    yield current
                current = nxt
            if current is not None:
                self.end_of_dataloader = True
                yield current
        finally:
            self.gradient_state._remove_dataloader(self)


def prepare_data_loader(
    dataloader,
    device=None,
    batch_size: Optional[int] = None,
    shuffle: bool = False,
    seed: int = 0,
    drop_last: bool = False,
    collate_fn=None,
    non_blocking: bool = True,
) -> DataLoaderShard:
    """A :class:`DataLoaderShard` over a dict of numpy arrays or a map-style
    dataset, ``batch_size`` rows per batch. ``device`` defaults to the
    state's device (the card unless the state was made with ``cpu=True``)."""
    if isinstance(dataloader, DataLoaderShard):
        return dataloader
    if isinstance(dataloader, torch.utils.data.DataLoader):
        raise NotImplementedError(
            "unwrapping a torch DataLoader waits for the data path (ROADMAP.md A5); "
            "pass its dataset and batch_size")
    dataset = dataloader
    if not (isinstance(dataset, dict) or hasattr(dataset, "__getitem__")):
        raise NotImplementedError(
            "iterables of ready-made batches wait for the data path (ROADMAP.md A5); "
            "pass a dict of arrays or a map-style dataset")
    if batch_size is None:
        raise ValueError("batch_size is required when passing a dataset")
    length = len(next(iter(dataset.values()))) if isinstance(dataset, dict) else len(dataset)
    sampler = SeedableRandomSampler(length, seed=seed) if shuffle else None
    batch_sampler = _SimpleBatchSampler(sampler if shuffle else range(length), batch_size, drop_last)
    device = PartialState().device if device is None else torch.device(device)
    return DataLoaderShard(_ArrayBatcher(dataset, batch_sampler, collate_fn), device,
                           non_blocking=non_blocking, sampler=sampler)
