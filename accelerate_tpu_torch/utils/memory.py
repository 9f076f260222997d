"""Memory utilities (counterpart of ``accelerate_tpu/utils/memory.py``):
cache clearing, out-of-memory detection, the batch-size finder that halves
on OOM, and the device's memory counters."""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable, Optional

import torch

__all__ = [
    "clear_device_cache",
    "find_executable_batch_size",
    "get_device_memory_stats",
    "is_oom_error",
    "release_memory",
]


def clear_device_cache(garbage_collection: bool = True) -> None:
    """Collect garbage (dead tensors free their memory into the caching
    allocator) and return the allocator's free blocks to the card."""
    if garbage_collection:
        gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def release_memory(*objects):
    """Drop the references in ``objects``, collect and clear the device
    cache; returns a list of as many Nones (``a, b = release_memory(a, b)``)."""
    objects = [None] * len(objects)
    clear_device_cache(garbage_collection=True)
    return objects


_OOM_MESSAGES = (
    "cuda out of memory",  # the caching allocator's message
    "out of memory",  # cudaErrorMemoryAllocation as a RuntimeError
    "cublas_status_alloc_failed",
)


def is_oom_error(exception: BaseException) -> bool:
    """Whether ``exception`` is the card running out of memory:
    ``torch.cuda.OutOfMemoryError``, or a ``RuntimeError`` with one of
    CUDA's out-of-memory messages."""
    if isinstance(exception, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(exception, RuntimeError) and len(exception.args) == 1:
        msg = str(exception.args[0]).lower()
        return any(m in msg for m in _OOM_MESSAGES)
    return False


def find_executable_batch_size(
    function: Optional[Callable] = None,
    starting_batch_size: int = 128,
    reduce_batch_size_fn: Optional[Callable[[int], int]] = None,
):
    """Decorator: call ``function(batch_size, ...)`` from
    ``starting_batch_size``; on an out-of-memory error clear the cache and
    retry with the batch size halved (``reduce_batch_size_fn``), as the
    JAX package does. Any other error propagates; a batch size of 0
    raises."""
    if function is None:
        return functools.partial(
            find_executable_batch_size,
            starting_batch_size=starting_batch_size,
            reduce_batch_size_fn=reduce_batch_size_fn,
        )
    if reduce_batch_size_fn is None:
        def reduce_batch_size_fn(b):
            return b // 2

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        batch_size = starting_batch_size
        params = list(inspect.signature(function).parameters.keys())
        if len(params) < (1 + len(args)) and params[0] != "batch_size":
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the first argument, "
                "but it should accept `batch_size` first."
            )
        while True:
            if batch_size == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                return function(batch_size, *args, **kwargs)
            except Exception as e:
                if not is_oom_error(e):
                    raise
                clear_device_cache(garbage_collection=True)
                batch_size = reduce_batch_size_fn(batch_size)

    return wrapper


def get_device_memory_stats(device=None) -> dict:
    """The caching allocator's counters of ``device`` (default: the current
    CUDA device) in bytes, under the JAX names where one exists
    (``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_reserved``,
    ``bytes_limit``); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda":
        return {}
    free, total = torch.cuda.mem_get_info(device)
    return {
        "bytes_in_use": torch.cuda.memory_allocated(device),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
        "bytes_reserved": torch.cuda.memory_reserved(device),
        "bytes_free": free,
        "bytes_limit": total,
    }
