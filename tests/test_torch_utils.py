"""The port's ``utils.random`` and ``utils.memory`` against the JAX
package's on the CPU: ``set_seed`` leaves Python's, NumPy's and torch's
generators where the JAX package's ``set_seed`` leaves them, the RNG
synchronization is a no-op on one process, ``find_executable_batch_size``
halves on an out-of-memory error (the JAX package's
``test_find_executable_batch_size_backoff``) and lets any other error
through, and the top-level exports name what the JAX package exports."""

import random

import numpy as np
import pytest
import torch

import accelerate_tpu
import accelerate_tpu_torch
from accelerate_tpu.utils import memory as jmemory
from accelerate_tpu.utils import random as jrandom
from accelerate_tpu_torch.utils import memory, random as trandom


def _draws():
    return (random.random(), float(np.random.rand()), torch.rand(3).tolist())


@pytest.mark.parametrize("seed", [0, 1234, 2**32 + 5])
def test_set_seed_matches_the_jax_package(seed):
    jrandom.set_seed(seed)
    ref = _draws()
    trandom.set_seed(seed)
    assert _draws() == ref
    trandom.set_seed(seed, device_specific=True)  # one process: index 0
    assert _draws() == ref


def test_set_seed_deterministic_flag():
    before = torch.are_deterministic_algorithms_enabled()
    try:
        trandom.set_seed(0, deterministic=True)
        assert torch.are_deterministic_algorithms_enabled()
    finally:
        torch.use_deterministic_algorithms(before)


def test_rng_synchronization_is_a_no_op_on_one_process():
    trandom.set_seed(7)
    state = (random.getstate(), np.random.get_state()[1].copy(), torch.get_rng_state())
    gen = torch.Generator().manual_seed(3)
    trandom.synchronize_rng_states(["python", "numpy", "torch"], generator=gen)
    trandom.synchronize_rng_state(gen)
    assert random.getstate() == state[0]
    assert (np.random.get_state()[1] == state[1]).all() and torch.equal(torch.get_rng_state(), state[2])


def test_find_executable_batch_size_backoff():
    attempts = []

    @memory.find_executable_batch_size(starting_batch_size=16)
    def run(batch_size):
        attempts.append(batch_size)
        if batch_size > 4:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return batch_size

    assert run() == 4
    assert attempts == [16, 8, 4]


@pytest.mark.parametrize("exc,oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), True),
    (RuntimeError("CUDA error: out of memory"), True),
    (RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate(handle)"), True),
    (RuntimeError("shape mismatch"), False),
    (ValueError("out of memory"), False),
])
def test_is_oom_error(exc, oom):
    assert memory.is_oom_error(exc) == oom
    if oom and "out of memory" in str(exc).lower():
        assert jmemory.is_oom_error(exc)  # the JAX package's heuristic reads them alike


def test_find_executable_batch_size_passes_other_errors_and_stops_at_zero():
    @memory.find_executable_batch_size(starting_batch_size=4)
    def bad(batch_size):
        raise ValueError("not memory")

    with pytest.raises(ValueError, match="not memory"):
        bad()

    @memory.find_executable_batch_size(starting_batch_size=2)
    def never(batch_size):
        raise RuntimeError("CUDA out of memory")

    with pytest.raises(RuntimeError, match="reached zero"):
        never()

    @memory.find_executable_batch_size(starting_batch_size=8)
    def takes_two(batch_size, extra):
        return batch_size, extra

    assert takes_two(3) == (8, 3)


def test_release_memory_returns_nones():
    a, b = torch.ones(4), [torch.zeros(2)]
    a, b = memory.release_memory(a, b)
    assert a is None and b is None
    assert jmemory.release_memory(1, 2) == memory.release_memory(1, 2) == [None, None]


def test_device_memory_stats_without_a_card():
    stats = memory.get_device_memory_stats()
    if torch.cuda.is_available():
        assert stats["bytes_limit"] > 0 and stats["bytes_in_use"] >= 0
    else:
        assert stats == {}
    assert memory.get_device_memory_stats("cpu") == {}


@pytest.mark.parametrize("name", ["set_seed", "synchronize_rng_states", "AcceleratedScheduler",
                                  "find_executable_batch_size", "release_memory"])
def test_top_level_exports_match_the_jax_package(name):
    # release_memory: the JAX package's utils.memory (not its top level)
    assert hasattr(accelerate_tpu, name) or hasattr(jmemory, name)
    assert name in accelerate_tpu_torch.__all__ and getattr(accelerate_tpu_torch, name) is not None
