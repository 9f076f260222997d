"""Process-level collectives on nested tensors (counterpart of the
collectives in ``accelerate_tpu/ops/operations.py``).

``gather``, ``gather_object``, ``broadcast``, ``broadcast_object_list``,
``pad_across_processes``, ``pad_input_tensors`` and ``reduce`` take a
tensor, or a dict, list or tuple of them, and run over every process of the
group; with one process each returns its input (``reduce`` scales it). The
JAX package gathers host objects through its coordination service's
key-value store; here ``gather_object`` is ``all_gather_object``. Under
NCCL a host tensor travels through the card and comes back on the host.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..state import PartialState

__all__ = [
    "broadcast",
    "broadcast_object_list",
    "gather",
    "gather_object",
    "pad_across_processes",
    "pad_input_tensors",
    "recursively_apply",
    "reduce",
]


def recursively_apply(fn: Callable, data, *args, **kwargs):
    """``fn`` on every tensor of a nested dict/list/tuple; other leaves pass
    through."""
    if isinstance(data, dict):
        return type(data)({k: recursively_apply(fn, v, *args, **kwargs) for k, v in data.items()})
    if isinstance(data, (list, tuple)):
        return type(data)(recursively_apply(fn, v, *args, **kwargs) for v in data)
    if isinstance(data, torch.Tensor):
        return fn(data, *args, **kwargs)
    return data


def _world():
    import torch.distributed as dist

    return dist


def _on_comm_device(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can move it: NCCL moves card memory only."""
    state = PartialState()
    if state.backend == "nccl" and t.device.type != "cuda":
        return t.to(state.device)
    return t


def gather(tensor):
    """Every process's tensors concatenated on dim 0, in process order
    (each process's must have the same shape: pad first with
    :func:`pad_across_processes`)."""
    state = PartialState()
    if state.num_processes == 1:
        return tensor
    dist = _world()

    def _gather_one(t):
        src = _on_comm_device(t.contiguous())
        if src.dim() == 0:
            src = src[None]
        parts = [torch.empty_like(src) for _ in range(state.num_processes)]
        dist.all_gather(parts, src)
        return torch.cat(parts, dim=0).to(t.device)

    return recursively_apply(_gather_one, tensor)


def gather_object(object: Any) -> list:
    """Every process's picklable object in process order; a list is
    flattened into the result (as the JAX package's is)."""
    state = PartialState()
    if state.num_processes == 1:
        return list(object) if isinstance(object, list) else [object]
    out = []
    for p in state.gather_object(object):
        out.extend(p) if isinstance(p, list) else out.append(p)
    return out


def broadcast(tensor, from_process: int = 0):
    """The tensors of ``from_process`` on every process (each process
    passes tensors of the same shapes and dtypes)."""
    state = PartialState()
    if state.num_processes == 1:
        return tensor
    dist = _world()

    def _bcast(t):
        buf = _on_comm_device(t.contiguous().clone())
        dist.broadcast(buf, src=from_process)
        return buf.to(t.device)

    return recursively_apply(_bcast, tensor)


def broadcast_object_list(object_list: list, from_process: int = 0) -> list:
    """``object_list`` of ``from_process`` on every process, in place."""
    state = PartialState()
    if state.num_processes == 1:
        return object_list
    _world().broadcast_object_list(object_list, src=from_process,
                                   device=state.device if state.backend == "nccl" else None)
    return object_list


def pad_across_processes(tensor, dim: int = 0, pad_index: int = 0, pad_first: bool = False):
    """Pad ``dim`` of each tensor with ``pad_index`` to its largest size
    over the processes, so a :func:`gather` is well shaped."""
    state = PartialState()

    def _pad(t):
        if t.dim() <= dim:
            return t
        if state.num_processes > 1:
            sizes = gather(torch.tensor([t.shape[dim]], device=t.device))
            max_size = int(sizes.max())
        else:
            max_size = t.shape[dim]
        if max_size == t.shape[dim]:
            return t
        shape = list(t.shape)
        shape[dim] = max_size
        out = t.new_full(shape, pad_index)
        index = [slice(None)] * t.dim()
        index[dim] = (slice(max_size - t.shape[dim], max_size) if pad_first
                      else slice(0, t.shape[dim]))
        out[tuple(index)] = t
        return out

    return recursively_apply(_pad, tensor)


def pad_input_tensors(tensor, batch_size: int, num_processes: int, dim: int = 0):
    """Pad ``dim`` by repeating its last slice until it divides evenly by
    ``num_processes``."""

    def _pad(t):
        if t.dim() <= dim or t.shape[dim] % num_processes == 0:
            return t
        missing = num_processes - t.shape[dim] % num_processes
        last = t.narrow(dim, t.shape[dim] - 1, 1)
        return torch.cat([t, last.repeat_interleave(missing, dim=dim)], dim=dim)

    return recursively_apply(_pad, tensor)


def reduce(tensor, reduction: str = "mean", scale: float = 1.0):
    """The element-wise sum (or mean) of each process's tensors, times
    ``scale``; ``"none"`` only scales."""
    if reduction not in ("sum", "mean", "none"):
        raise ValueError(f"reduction must be sum|mean|none, got {reduction!r}")
    state = PartialState()
    dist = _world()

    def _reduce(t):
        out = t.clone()
        if state.num_processes > 1 and reduction != "none":
            buf = _on_comm_device(out)
            dist.all_reduce(buf)
            out = buf.to(t.device)
            if reduction == "mean":
                out = out / state.num_processes if out.is_floating_point() \
                    else out // state.num_processes
        return out * scale if scale != 1.0 else out

    return recursively_apply(_reduce, tensor)
