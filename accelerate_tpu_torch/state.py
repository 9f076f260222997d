"""Process/device state singletons (counterpart of ``accelerate_tpu/state.py``).

Single-process, single-device: ``PartialState`` holds the one process and
its device (the card unless ``cpu=True``) and the process helpers the
checkpoint, logging and tracking layers call (``is_main_process``,
``wait_for_everyone``, ``gather_object``, ``main_process_first``: at world
size 1 the barrier returns at once and a gather is a one-element list),
``AcceleratorState`` the mixed precision, ``GradientState`` the
accumulation bookkeeping the eager loop observes. Each is a Borg singleton (every instance shares one state dict)
with a ``_reset_state`` hook for tests. Several processes or devices (the
JAX package's multi-host SPMD) wait for the distributed slice (ROADMAP.md
A7): a launch that sets ``WORLD_SIZE`` above 1 is refused.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any

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


class PartialState:
    """The process and its device. ``cpu=True`` (or ``ACCELERATE_USE_CPU``)
    selects the CPU; otherwise the card, and no card raises."""

    _shared_state: dict[str, Any] = {}
    _lock = threading.Lock()

    def __init__(self, cpu: bool = False):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        with self._lock:
            if not self.initialized:
                self._init(cpu)

    def _init(self, cpu: bool) -> None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: several processes (DDP/FSDP2 across cards) wait "
                "for the distributed slice (ROADMAP.md A7); run one process"
            )
        self.device = resolve_device("cpu" if cpu or _flag("ACCELERATE_USE_CPU") else "cuda")
        self.process_index = 0
        self.local_process_index = 0
        self.num_processes = 1
        self.initialized = True

    @property
    def initialized(self) -> bool:
        return self._shared_state.get("initialized", False)

    @initialized.setter
    def initialized(self, value: bool) -> None:
        self._shared_state["initialized"] = value

    @property
    def is_main_process(self) -> bool:
        return self.process_index == 0

    def wait_for_everyone(self, tag: str = "accelerate_tpu_torch.wait_for_everyone") -> None:
        """Barrier across processes: with one process, nothing to wait for."""

    def gather_object(self, obj) -> list:
        """Every process's ``obj``, in process order."""
        return [obj]

    @contextlib.contextmanager
    def main_process_first(self):
        """Run the block on the main process first, then on the others."""
        if not self.is_main_process:
            self.wait_for_everyone("accelerate_tpu_torch.main_process_first")
        yield
        if self.is_main_process:
            self.wait_for_everyone("accelerate_tpu_torch.main_process_first")

    def print(self, *args, **kwargs) -> None:
        if self.is_main_process:
            print(*args, **kwargs)

    @classmethod
    def _reset_state(cls) -> None:
        cls._shared_state.clear()


class AcceleratorState:
    """Mixed precision on top of :class:`PartialState`, whose attributes it
    proxies. ``mixed_precision`` is ``"no"``, ``"bf16"`` or ``"fp16"``
    (default: ``ACCELERATE_MIXED_PRECISION`` or ``"no"``); ``"fp8"`` is not
    ported yet."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision=None, cpu: bool = False):
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
            raise NotImplementedError("mixed_precision='fp8' (ops/fp8.py) is not ported yet (ROADMAP.md)")
        if mixed_precision not in ("no", "bf16", "fp16"):
            raise ValueError(f"Unknown mixed_precision {mixed_precision!r}; choose from no|bf16|fp16")
        self._partial = PartialState(cpu=cpu)
        self.mixed_precision = mixed_precision
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

