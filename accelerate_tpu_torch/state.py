"""Process/device state singletons (counterpart of ``accelerate_tpu/state.py``).

``PartialState`` holds this process and its device. One process drives one
device: the card ``cuda:LOCAL_RANK`` (the card unless ``cpu=True`` or
``ACCELERATE_USE_CPU``; no card raises), or the CPU. Under a launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/
``MASTER_PORT``, as ``torchrun`` and ``commands/launch.py`` set them, or
``ACCELERATE_INIT_METHOD`` for another rendezvous such as ``file://``) with
``WORLD_SIZE`` above 1 it starts the process group: NCCL on the card, gloo
when the caller asked for the CPU. A missing card or a missing NCCL raises:
nothing drops to gloo or to the CPU on its own. A process group the caller
started already (``init_process_group`` before the first state) is used as
it is. The process helpers are the JAX package's: ``wait_for_everyone``
(a barrier, with a ``timeout``), ``gather_object``,
``split_between_processes``, ``main_process_first``,
``local_main_process_first`` and the ``on_*_process`` decorators.

``AcceleratorState`` adds the mixed precision and the parallelism
configuration, ``GradientState`` the accumulation bookkeeping the eager
loop observes. Each is a Borg singleton (every instance shares one state
dict) with a ``_reset_state`` hook for tests.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import math
import os
import threading
from typing import Any, Callable, Optional

import torch

from ._device import resolve_device

__all__ = ["PartialState", "AcceleratorState", "GradientState", "process_layout"]


def process_layout() -> tuple:
    """(process index, number of processes) of the initialised
    ``PartialState``, else of the launch environment (``RANK``,
    ``WORLD_SIZE``), without building the state (which picks a device)."""
    shared = PartialState._shared_state
    if shared.get("initialized"):
        return shared["process_index"], shared["num_processes"]
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def _flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def _process_device(cpu: bool, local_rank: int) -> tuple:
    """(device, backend) of a process of a group: the CPU over gloo when
    asked, else card ``local_rank`` over NCCL; raises without either."""
    if cpu:
        return torch.device("cpu"), "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a multi-process launch on the card needs CUDA, and torch.cuda.is_available() is "
            "False; pass cpu=True (or set ACCELERATE_USE_CPU=1) to run gloo processes on the CPU")
    if local_rank >= torch.cuda.device_count():
        raise RuntimeError(f"LOCAL_RANK={local_rank} but this host has "
                           f"{torch.cuda.device_count()} CUDA devices")
    if not _dist().is_nccl_available():
        raise RuntimeError("this torch build has no NCCL; the port does not fall back to gloo "
                           "on the card")
    device = torch.device("cuda", local_rank)
    torch.cuda.set_device(device)
    return device, "nccl"


class PartialState:
    """This process and its device (see the module docstring).
    ``cpu=True`` (or ``ACCELERATE_USE_CPU``) selects the CPU; otherwise the
    card, and no card raises."""

    _shared_state: dict[str, Any] = {}
    _lock = threading.Lock()

    def __init__(self, cpu: bool = False, _allow_uninitialized: bool = False, **kwargs):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        with self._lock:
            if not self.initialized:
                self._init(cpu)

    def _init(self, cpu: bool) -> None:
        cpu = cpu or _flag("ACCELERATE_USE_CPU")
        dist = _dist()
        world = int(os.environ.get("WORLD_SIZE", "1"))
        self.backend = None
        if dist is not None and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
            local = int(os.environ.get("LOCAL_RANK", rank if world > 1 else 0))
            self.backend = dist.get_backend()
            if world > 1:
                self.device = _process_device(cpu or self.backend == "gloo", local)[0]
            else:
                self.device = resolve_device("cpu" if cpu else "cuda")
        elif world > 1:
            if "RANK" not in os.environ:
                raise ValueError(f"WORLD_SIZE={world} without RANK: launch through torchrun or "
                                 "accelerate_tpu_torch.commands.launch")
            rank = int(os.environ["RANK"])
            local = int(os.environ.get("LOCAL_RANK", rank))
            self.device, self.backend = _process_device(cpu, local)
            dist.init_process_group(
                self.backend, init_method=os.environ.get("ACCELERATE_INIT_METHOD", "env://"),
                rank=rank, world_size=world,
                **({"device_id": self.device} if self.backend == "nccl" else {}))
        else:
            rank, local = 0, 0
            self.device = resolve_device("cpu" if cpu else "cuda")
        self.process_index = rank
        self.local_process_index = local
        self.num_processes = world
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["initialized"] = value

    @property
    def use_distributed(self) -> bool:
        """Whether a process group runs (at world size 1 too, once a mesh
        started one)."""
        dist = _dist()
        return dist is not None and dist.is_initialized()

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    @property
    def is_local_main_process(self) -> bool:
        return self.local_process_index == 0

    @property
    def is_last_process(self) -> bool:
        return self.process_index == self.num_processes - 1

    def __repr__(self) -> str:
        return (f"PartialState(num_processes={self.num_processes}, process_index="
                f"{self.process_index}, device={self.device}, backend={self.backend})")

    def ensure_process_group(self) -> None:
        """Start a one-rank process group when none runs (a mesh needs one
        at world size 1 too): gloo on the CPU, NCCL on the card."""
        dist = _dist()
        if dist.is_initialized():
            return
        if self.num_processes != 1:
            raise RuntimeError("no process group although the world has "
                               f"{self.num_processes} processes")
        backend = "gloo" if self.device.type == "cpu" else "nccl"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                **({"device_id": self.device} if backend == "nccl" else {}))
        self.backend = backend

    # --------------------------------------------------------- process control
    def wait_for_everyone(self, tag: str = "accelerate_tpu_torch.wait_for_everyone",
                          timeout: Optional[float] = None) -> None:
        """Barrier across processes; nothing to wait for with one.
        ``timeout`` (seconds; default ``ACCELERATE_BARRIER_TIMEOUT``, unset:
        wait for ever) raises ``BarrierTimeoutError`` naming ``tag``."""
        if self.num_processes <= 1:
            return
        dist = _dist()
        if timeout is None:
            raw = os.environ.get("ACCELERATE_BARRIER_TIMEOUT", "")
            timeout = float(raw) if raw else None
        if timeout is None:
            dist.barrier()
            return
        from .utils.fault import BarrierTimeoutError

        try:
            if self.backend == "gloo":
                dist.monitored_barrier(timeout=datetime.timedelta(seconds=timeout))
            else:
                dist.barrier(async_op=True).wait(timeout=datetime.timedelta(seconds=timeout))
        except RuntimeError as e:
            raise BarrierTimeoutError(f"barrier {tag!r} timed out after {timeout}s: {e}") from e

    def gather_object(self, obj) -> list:
        """Every process's ``obj``, in process order (a collective)."""
        if self.num_processes <= 1:
            return [obj]
        out = [None] * self.num_processes
        _dist().all_gather_object(out, obj)
        return out

    @contextlib.contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        """This process's share of a list, tuple, dict of equal-length
        values, array or tensor: ``ceil(len / num_processes)`` items each, the
        last process the rest; ``apply_padding`` repeats the last item so
        every share is as long."""
        if self.num_processes == 1:
            yield inputs
            return
        length = len(inputs)
        per = math.ceil(length / self.num_processes)
        start, end = self.process_index * per, self.process_index * per + per
        if isinstance(inputs, dict):
            for k, v in inputs.items():
                if len(v) != length:
                    raise ValueError(f"All dict values must share length; {k!r} has "
                                     f"{len(v)} != {length}")
            yield {k: self._slice_with_padding(v, start, end, apply_padding)
                   for k, v in inputs.items()}
        else:
            yield self._slice_with_padding(inputs, start, end, apply_padding)

    @staticmethod
    def _slice_with_padding(seq, start, end, apply_padding):
        import numpy as np

        part = seq[start:end]
        if apply_padding and len(part) < (end - start) and len(seq) > 0:
            missing = (end - start) - len(part)
            if isinstance(seq, torch.Tensor):
                pad = seq[-1:].repeat_interleave(missing, dim=0)
                part = torch.cat([part, pad]) if len(part) else pad
            elif isinstance(seq, np.ndarray):
                pad = np.repeat(seq[-1:], missing, axis=0)
                part = np.concatenate([part, pad], axis=0) if len(part) else pad
            else:
                part = list(part) + [seq[-1]] * missing
        return part

    @contextlib.contextmanager
    def main_process_first(self):
        """Run the block on the main process first, then on the others."""
        if not self.is_main_process:
            self.wait_for_everyone("accelerate_tpu_torch.main_process_first")
        yield
        if self.is_main_process:
            self.wait_for_everyone("accelerate_tpu_torch.main_process_first")

    @contextlib.contextmanager
    def local_main_process_first(self):
        """Run the block on each host's first process, then on the others."""
        if not self.is_local_main_process:
            self.wait_for_everyone("accelerate_tpu_torch.local_main_process_first")
        yield
        if self.is_local_main_process:
            self.wait_for_everyone("accelerate_tpu_torch.local_main_process_first")

    def _only_if(self, predicate: Callable[[], bool], function: Callable) -> Callable:
        @functools.wraps(function)
        def wrapper(*args, **kwargs):
            if predicate():
                return function(*args, **kwargs)

        return wrapper

    def on_main_process(self, function: Callable) -> Callable:
        """Decorator: run only on the main process."""
        return self._only_if(lambda: self.is_main_process, function)

    def on_local_main_process(self, function: Callable) -> Callable:
        return self._only_if(lambda: self.is_local_main_process, function)

    def on_last_process(self, function: Callable) -> Callable:
        return self._only_if(lambda: self.is_last_process, function)

    def on_process(self, function: Callable = None, process_index: int = None) -> Callable:
        if function is None:
            return functools.partial(self.on_process, process_index=process_index)
        return self._only_if(lambda: self.process_index == process_index, function)

    def on_local_process(self, function: Callable = None, local_process_index: int = None) -> Callable:
        if function is None:
            return functools.partial(self.on_local_process, local_process_index=local_process_index)
        return self._only_if(lambda: self.local_process_index == local_process_index, function)

    def print(self, *args, **kwargs) -> None:
        if self.is_main_process:
            print(*args, **kwargs)

    def destroy_process_group(self) -> None:
        """End the process group, if one runs."""
        dist = _dist()
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()


class AcceleratorState:
    """Mixed precision and the parallelism configuration on top of
    :class:`PartialState`, whose attributes it proxies. ``mixed_precision``
    is ``"no"``, ``"bf16"`` or ``"fp16"`` (default:
    ``ACCELERATE_MIXED_PRECISION`` or ``"no"``); ``"fp8"`` is not ported yet.
    ``parallelism_config`` defaults to ``ParallelismConfig.from_env`` over
    the world (data parallel over every process unless the launcher's
    environment says otherwise); ``device_mesh`` is the mesh the
    ``Accelerator`` shards over, once it built one."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision=None, cpu: bool = False, parallelism_config=None,
                 _from_accelerator: bool = False):
        self.__dict__ = self._shared_state
        if self.initialized:
            if mixed_precision is not None and mixed_precision != self.mixed_precision:
                raise ValueError(
                    f"AcceleratorState already initialized with mixed_precision="
                    f"{self.mixed_precision!r}; cannot re-init with {mixed_precision!r}. "
                    "Call AcceleratorState._reset_state() first"
                )
            return
        if mixed_precision is None:
            mixed_precision = os.environ.get("ACCELERATE_MIXED_PRECISION", "no")
        mixed_precision = str(mixed_precision).lower()
        if mixed_precision == "fp8":
            raise NotImplementedError("mixed_precision='fp8' (ops/fp8.py) is not ported yet (ROADMAP.md A4)")
        if mixed_precision not in ("no", "bf16", "fp16"):
            raise ValueError(f"Unknown mixed_precision {mixed_precision!r}; choose from no|bf16|fp16")
        self._partial = PartialState(cpu=cpu)
        self.mixed_precision = mixed_precision
        if parallelism_config is None:
            from .parallelism_config import ParallelismConfig

            parallelism_config = ParallelismConfig.from_env(self._partial.num_processes)
        else:
            parallelism_config._infer_and_validate(self._partial.num_processes)
        self.parallelism_config = parallelism_config
        self.device_mesh = None
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["initialized"] = value

    def __getattr__(self, name: str):
        if name in ("_shared_state", "__dict__"):
            raise AttributeError(name)
        partial = self._shared_state.get("_partial")
        if partial is not None and hasattr(partial, name):
            return getattr(partial, name)
        raise AttributeError(f"AcceleratorState has no attribute {name!r}")

    @classmethod
    def _reset_state(cls, reset_partial_state: bool = False) -> None:
        cls._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()


class GradientState:
    """Gradient-accumulation bookkeeping: ``sync_gradients`` (whether this
    micro-batch updates), ``end_of_dataloader`` of the active loader, and the
    registry of loaders being iterated."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, gradient_accumulation_plugin=None):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references = []
            self.plugin_kwargs = {}
            self.num_steps = 1
            self.initialized = True
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()
            self.num_steps = gradient_accumulation_plugin.num_steps

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["initialized"] = value

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def end_of_dataloader(self) -> bool:
        if self.active_dataloader is None:
            return False
        return getattr(self.active_dataloader, "end_of_dataloader", False)

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    @property
    def remainder(self) -> int:
        """Samples of the active loader's last batch that are real (the
        rest pads an even batch); -1 when nothing was padded."""
        if self.active_dataloader is None:
            return -1
        return getattr(self.active_dataloader, "remainder", -1)

    def _set_sync_gradients(self, value: bool) -> None:
        self.sync_gradients = value

    def _add_dataloader(self, dataloader) -> None:
        self.active_dataloader = dataloader
        self.dataloader_references.append(dataloader)

    def _remove_dataloader(self, dataloader) -> None:
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1] if self.dataloader_references else None

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()

