"""The port's data path (``accelerate_tpu_torch/data_loader.py``) against the
JAX package's (``accelerate_tpu/data_loader.py``), on the CPU.

* ``BatchSamplerShard`` and ``IterableDatasetShard`` give every one of 1-3
  processes exactly the JAX classes' indices under ``split_batches``,
  ``even_batches`` and ``drop_last``; ``data_shard_info`` the JAX
  function's shards for the same row blocks.
* The prepared loaders: batch order equal to the JAX loader's (shuffled and
  not), ``end_of_dataloader`` and ``GradientState``, ``skip_first_batches``,
  the remainder, the dispatcher, a torch ``DataLoader`` round trip (workers,
  collate, the seedable shuffle), iterables of ready batches, the padded
  collate.
* Exact mid-epoch resume, as ``tests/test_data_loader.py`` pins it:
  shuffled, iterable and stateful datasets, and a torch ``DataLoader``.
* The device prefetcher: errors reach the consumer, ``close`` stops and
  joins its thread, an abandoned iteration closes it.
"""

import time

import numpy as np
import pytest
import torch

from accelerate_tpu import data_loader as jdl
from accelerate_tpu.parallelism_config import ParallelismConfig
from accelerate_tpu_torch import data_loader as dl
from accelerate_tpu_torch.state import GradientState


@pytest.fixture(autouse=True)
def fresh_state():
    GradientState._reset_state()
    yield
    GradientState._reset_state()


def _prepare(data, **kw):
    return dl.prepare_data_loader(data, device="cpu", **kw)


def _rows(loader, key="x"):
    return [b[key].reshape(-1).tolist() for b in loader]


# ---------------------------------------------------------------- samplers
@pytest.mark.parametrize("num_processes", [1, 2, 3])
@pytest.mark.parametrize("n", [36, 37, 41, 5])
@pytest.mark.parametrize("split_batches", [False, True])
@pytest.mark.parametrize("even_batches", [True, False])
@pytest.mark.parametrize("drop_last", [False, True])
def test_batch_sampler_shard_indices_equal_jax(num_processes, n, split_batches, even_batches,
                                               drop_last):
    bs = 6  # divisible by 1, 2 and 3 (split_batches requires it)
    for p in range(num_processes):
        kw = dict(split_batches=split_batches, even_batches=even_batches)
        try:
            theirs = jdl.BatchSamplerShard(jdl._SimpleBatchSampler(range(n), bs, drop_last),
                                           num_processes, p, **kw)
        except ValueError:  # a first batch (n = 5) the processes cannot split
            with pytest.raises(ValueError, match="divisible"):
                dl.BatchSamplerShard(dl._SimpleBatchSampler(range(n), bs, drop_last),
                                     num_processes, p, **kw)
            continue
        ours = dl.BatchSamplerShard(dl._SimpleBatchSampler(range(n), bs, drop_last), num_processes,
                                    p, **kw)
        assert list(ours) == list(theirs)
        assert len(ours) == len(theirs)


@pytest.mark.parametrize("num_processes", [1, 2, 3])
@pytest.mark.parametrize("n", [12, 13, 2])
@pytest.mark.parametrize("split_batches", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_shard_equals_jax(num_processes, n, split_batches, drop_last):
    for p in range(num_processes):
        kw = dict(batch_size=6 if split_batches else 2, drop_last=drop_last,
                  num_processes=num_processes, process_index=p, split_batches=split_batches)
        assert list(dl.IterableDatasetShard(range(n), **kw)) == list(
            jdl.IterableDatasetShard(list(range(n)), **kw))


def test_batch_sampler_shard_refuses_an_indivisible_split():
    with pytest.raises(ValueError, match="divisible"):
        dl.BatchSamplerShard(dl._SimpleBatchSampler(range(10), 5), 2, 0, split_batches=True)


@pytest.mark.parametrize("sizes,n_procs", [(dict(dp_shard_size=8), 4), (dict(dp_shard_size=4, tp_size=2), 4),
                                           (dict(dp_shard_size=2, tp_size=4), 2)])
def test_data_shard_info_equals_jax(sizes, n_procs):
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = ParallelismConfig(**sizes).build_device_mesh()
    sharding = NamedSharding(mesh, P(("dp_shard",)))
    devices = sorted(mesh.devices.flatten().tolist(), key=lambda d: d.id)
    per = len(devices) // n_procs
    proc = {d.id: i // per for i, d in enumerate(devices)}
    n_rows = mesh.shape["dp_shard"]
    blocks = {d: (s[0].start or 0, s[0].stop if s[0].stop is not None else n_rows)
              for d, s in sharding.devices_indices_map((n_rows,)).items()}
    for p in range(n_procs):
        want = jdl.data_shard_info(sharding, process_index=p, num_processes=n_procs,
                                   process_of_device=lambda d: proc[d.id])
        got = dl.data_shard_info(blocks, process_index=p, num_processes=n_procs,
                                 process_of_device=lambda d: proc[d.id])
        assert got == want
    assert dl.data_shard_info(None, 0, 1) == (1, 0, 1)
    assert dl.data_shard_info(None, 2, 3) == (3, 2, 1)


# ----------------------------------------------------------------- loaders
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_order_equals_the_jax_loader(shuffle):
    data = {"x": np.arange(48.0)[:, None]}
    kw = dict(batch_size=8, shuffle=shuffle, seed=5, drop_last=True)
    loader = _prepare(data, **kw)
    loader.set_epoch(2)
    mesh = ParallelismConfig(dp_shard_size=8).build_device_mesh()
    jloader = jdl.prepare_data_loader(data, mesh=mesh, **kw)
    jloader.set_epoch(2)
    assert _rows(loader) == [np.asarray(b["x"]).reshape(-1).tolist() for b in jloader]


def test_end_of_dataloader_flag_and_gradient_state():
    loader = _prepare({"x": np.arange(8.0)[:, None]}, batch_size=4, drop_last=True)
    gs = GradientState()
    seen = []
    for batch in loader:
        assert isinstance(batch["x"], torch.Tensor) and gs.in_dataloader
        seen.append(loader.end_of_dataloader)
    assert seen == [False, True] and not gs.in_dataloader


def test_shuffle_deterministic_across_epochs():
    loader = _prepare({"x": np.arange(16.0)[:, None]}, batch_size=8, shuffle=True, seed=7,
                      drop_last=True)
    e0 = _rows(loader)
    loader.set_epoch(0)
    assert _rows(loader) == e0
    loader.set_epoch(1)
    assert _rows(loader) != e0


def test_skip_first_batches():
    loader = _prepare({"x": np.arange(32.0)[:, None]}, batch_size=8, drop_last=True)
    every = _rows(loader)
    skipped = dl.skip_first_batches(loader, 2)
    assert skipped is loader and _rows(skipped) == every[2:] and len(skipped) == 2
    wrapped = dl.skip_first_batches([1, 2, 3, 4], 3)
    assert list(wrapped) == [4] and len(wrapped) == 1


def test_remainder_tracked():
    loader = _prepare({"x": np.arange(10.0)[:, None]}, batch_size=8)
    for _ in loader:
        pass
    assert loader.remainder == 2


def test_dispatcher_single_process():
    loader = _prepare({"x": np.arange(16.0)[:, None]}, batch_size=8, dispatch_batches=True,
                      drop_last=True)
    assert isinstance(loader, dl.DataLoaderDispatcher)
    assert _rows(loader) == [list(range(8)), list(range(8, 16))]


def _spawn(workers):
    # workers start by spawn: forking a process that runs JAX's threads can
    # deadlock the child
    return {"multiprocessing_context": "spawn"} if workers else {}


class _Squares(torch.utils.data.Dataset):
    def __len__(self):
        return 20

    def __getitem__(self, i):
        return {"x": torch.tensor([float(i)]), "y": np.int64(i * i)}


@pytest.mark.parametrize("workers", [0, 2])
def test_torch_dataloader_round_trip(workers):
    loader = torch.utils.data.DataLoader(_Squares(), batch_size=4, num_workers=workers,
                                         **_spawn(workers))
    prepared = _prepare(loader)
    batches = list(prepared)
    assert prepared.inner.num_workers == workers and prepared.inner.collate_fn is loader.collate_fn
    assert [b["x"].reshape(-1).tolist() for b in batches] == [
        [float(i) for i in range(j, j + 4)] for j in range(0, 20, 4)]
    assert batches[1]["y"].tolist() == [16, 25, 36, 49]
    assert prepared.end_of_dataloader and len(prepared) == 5


def test_torch_dataloader_shuffle_takes_the_seedable_sampler():
    loader = torch.utils.data.DataLoader(_Squares(), batch_size=5, shuffle=True)
    prepared = _prepare(loader, seed=11)
    order = list(dl.SeedableRandomSampler(20, seed=11))
    assert sum(_rows(prepared), []) == [float(i) for i in order]
    prepared.set_epoch(1)
    assert sum(_rows(prepared), []) == [float(i) for i in dl.SeedableRandomSampler(20, seed=11, epoch=1)]
    unseeded = _prepare(torch.utils.data.DataLoader(_Squares(), batch_size=5, shuffle=True),
                        use_seedable_sampler=False)
    assert sorted(sum(_rows(unseeded), [])) == [float(i) for i in range(20)]


def test_torch_iterable_dataset_is_sharded():
    class Stream(torch.utils.data.IterableDataset):
        def __iter__(self):
            return iter(np.arange(10.0, dtype=np.float32))

    prepared = _prepare(torch.utils.data.DataLoader(Stream(), batch_size=4))
    assert [b.tolist() for b in prepared] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 0, 1]]


def test_iterable_of_ready_batches():
    batches = [{"x": np.full((2, 3), float(i))} for i in range(3)]
    loader = _prepare(iter(batches))
    got = list(loader)
    assert [float(b["x"][0, 0]) for b in got] == [0.0, 1.0, 2.0] and loader.end_of_dataloader


def test_make_padded_collate_through_the_loader():
    class Ragged:
        def __len__(self):
            return 16

        def __getitem__(self, i):
            return {"input_ids": list(range(1, 2 + i % 5)), "idx": i}

    loader = _prepare(Ragged(), batch_size=8, drop_last=True,
                      collate_fn=dl.make_padded_collate(pad_token_id=0, max_length=8))
    batch = next(iter(loader))
    assert batch["input_ids"].shape == (8, 8) and batch["input_ids"].dtype == torch.int32
    np.testing.assert_array_equal(batch["loss_mask"].sum(1).numpy(), [1 + i % 5 for i in range(8)])
    assert batch["idx"].tolist() == list(range(8))


def test_prefetch_propagates_errors():
    def boom():
        yield 1
        raise RuntimeError("boom")

    pf = dl._DevicePrefetcher(boom(), lambda x: x)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)


# ----------------------------------------------------- exact mid-epoch resume
def test_exact_midepoch_resume_shuffled():
    data = {"x": np.arange(32.0)[:, None]}

    def build():
        return _prepare(data, batch_size=8, shuffle=True, seed=5, drop_last=True)

    loader = build()
    loader.set_epoch(1)
    it = iter(loader)
    for _ in range(2):
        next(it)
    state = loader.state_dict()
    rest = [b["x"].reshape(-1).tolist() for b in it]
    fresh = build()
    fresh.load_state_dict(state)
    assert _rows(fresh) == rest and len(rest) == 2
    fresh.set_epoch(2)
    assert len(_rows(fresh)) == 4  # the next epoch is whole


def test_a_restored_position_survives_a_save_before_the_next_epoch():
    # a checkpoint taken right after a resume, before the loader is iterated
    # again, records the restored position (not batch 0 of the epoch)
    data = {"x": np.arange(32.0)[:, None]}
    loader = _prepare(data, batch_size=8, shuffle=True, seed=5, drop_last=True)
    it = iter(loader)
    next(it)
    state = loader.state_dict()
    rest = [b["x"].reshape(-1).tolist() for b in it]
    fresh = _prepare(data, batch_size=8, shuffle=True, seed=5, drop_last=True)
    fresh.load_state_dict(state)
    again = _prepare(data, batch_size=8, shuffle=True, seed=5, drop_last=True)
    again.load_state_dict(fresh.state_dict())
    assert fresh.state_dict()["position"] == 1 and _rows(again) == rest


def test_exact_midepoch_resume_iterable():
    class Stream:
        def __iter__(self):
            for i in range(6):
                yield {"x": np.full((8, 1), float(i))}

    loader = _prepare(Stream())
    it = iter(loader)
    for _ in range(2):
        next(it)
    state = loader.state_dict()
    rest = [float(b["x"][0, 0]) for b in it]
    fresh = _prepare(Stream())
    fresh.load_state_dict(state)
    assert [float(b["x"][0, 0]) for b in fresh] == rest == [2.0, 3.0, 4.0, 5.0]


def test_exact_midepoch_resume_stateful_dataset():
    class StatefulStream:
        def __init__(self):
            self.cursor = 0

        def __iter__(self):
            while self.cursor < 6:
                i = self.cursor
                self.cursor += 1
                yield {"x": np.full((8, 1), float(i))}

        def state_dict(self):
            return {"cursor": self.cursor}

        def load_state_dict(self, sd):
            self.cursor = sd["cursor"]

    loader = _prepare(StatefulStream())
    it = iter(loader)
    for _ in range(3):
        next(it)
    state = loader.state_dict()
    assert state["dataset_state"] == {"cursor": 3}  # the batch handed out, not the prefetched
    fresh = _prepare(StatefulStream())
    fresh.load_state_dict(state)
    assert [float(b["x"][0, 0]) for b in fresh] == [3.0, 4.0, 5.0]


def test_exact_midepoch_resume_torch_dataloader():
    def build():
        return _prepare(torch.utils.data.DataLoader(_Squares(), batch_size=3, shuffle=True,
                                                    num_workers=2, **_spawn(2)), seed=3)

    loader = build()
    loader.set_epoch(4)
    it = iter(loader)
    for _ in range(3):
        next(it)
    state = loader.state_dict()
    rest = [b["x"].reshape(-1).tolist() for b in it]
    fresh = build()
    fresh.load_state_dict(state)
    assert _rows(fresh) == rest and state["epoch"] == 4 and state["position"] == 3


# ------------------------------------------------------------ the prefetcher
def test_prefetcher_close_unblocks_and_joins_the_thread():
    staged = []

    def put_fn(x):
        staged.append(x)
        return x

    pf = dl._DevicePrefetcher(iter(range(100)), put_fn, depth=2)
    for _ in range(50):
        if len(staged) >= 3:
            break
        time.sleep(0.01)
    assert pf.thread.is_alive()
    assert pf.close(timeout=5) and not pf.thread.is_alive() and pf.closed and pf.q.empty()
    assert pf.close(timeout=1)


def test_prefetcher_close_after_exhaustion_is_clean():
    pf = dl._DevicePrefetcher(iter([1, 2]), lambda x: x, depth=2)
    assert list(pf) == [1, 2] and pf.close(timeout=5) and pf.batches == 2 and pf.wait_s >= 0


def test_loader_abandoned_iteration_closes_the_prefetcher():
    loader = _prepare({"x": np.arange(400.0)[:, None]}, batch_size=8, drop_last=True)
    it = iter(loader)
    next(it)
    pf1 = loader._active_prefetcher
    assert pf1 is not None and pf1.thread.is_alive()
    it.close()
    assert pf1.closed and loader._active_prefetcher is None
    it2 = iter(loader)
    next(it2)
    pf2 = loader._active_prefetcher
    it3 = iter(loader)
    next(it3)
    pf3 = loader._active_prefetcher
    assert pf3 is not pf2 and pf2.closed  # a new epoch reaps the old one's thread
    it2.close()  # the stale generator closes its own prefetcher, not the new one
    assert loader._active_prefetcher is pf3 and not pf3.closed
    assert sum(1 for _ in it3) == 49 and pf3.closed
