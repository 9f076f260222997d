"""Learning-rate scheduler wrapper (counterpart of
``accelerate_tpu/scheduler.py``): a schedule steps only when the optimizer
really stepped, so gradient accumulation and fp16's skipped steps do not
move it."""

from __future__ import annotations

from typing import Callable, Union

from .state import GradientState

__all__ = ["AcceleratedScheduler"]


class AcceleratedScheduler:
    """Wraps a ``torch.optim.lr_scheduler`` scheduler, or a callable
    ``step -> lr`` (the JAX package's optax schedule), which sets the
    optimizer's groups' ``lr``: ``schedule(n)`` once ``n`` updates have
    been made, so update ``n`` (from 0) runs at ``schedule(n)``, as an optax
    optimizer built on the schedule does.

    With ``step_with_optimizer`` (the default), :meth:`step` does nothing on
    a micro-batch that does not update (``GradientState.sync_gradients``
    off) or when the optimizer skipped its update (fp16 overflow), whatever
    the accumulation plugin's ``adjust_scheduler`` says, as in the JAX
    package. ``step_multiplier`` counts each step that many times unless
    ``split_batches``."""

    def __init__(
        self,
        scheduler: Union[Callable[[int], float], object],
        optimizer=None,
        step_with_optimizer: bool = True,
        split_batches: bool = False,
        step_multiplier: int = 1,
    ):
        self.scheduler = scheduler
        self.optimizer = optimizer
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.step_multiplier = step_multiplier
        self.step_count = 0
        self.gradient_state = GradientState()
        self._set_lr()

    def _is_schedule_fn(self) -> bool:
        return callable(self.scheduler) and not hasattr(self.scheduler, "step")

    def _param_groups(self):
        opt = getattr(self.optimizer, "optimizer", self.optimizer)  # AcceleratedOptimizer
        return [] if opt is None else opt.param_groups

    def _set_lr(self) -> None:
        if self._is_schedule_fn():
            for group in self._param_groups():
                group["lr"] = float(self.scheduler(self.step_count))

    def step(self, *args, **kwargs) -> None:
        if self.step_with_optimizer:
            if not self.gradient_state.sync_gradients:
                return
            if self.optimizer is not None and getattr(self.optimizer, "step_was_skipped", False):
                return  # fp16: the update was skipped
        self.step_count += 1 if self.split_batches else self.step_multiplier
        if self._is_schedule_fn():
            self._set_lr()
        else:
            self.scheduler.step(*args, **kwargs)

    def get_last_lr(self) -> list:
        if self._is_schedule_fn():
            return [float(self.scheduler(self.step_count))]
        return list(self.scheduler.get_last_lr())

    def state_dict(self) -> dict:
        sd = {"step_count": self.step_count}
        if not self._is_schedule_fn() and hasattr(self.scheduler, "state_dict"):
            sd["inner"] = self.scheduler.state_dict()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        self.step_count = sd.get("step_count", 0)
        if "inner" in sd and hasattr(self.scheduler, "load_state_dict"):
            self.scheduler.load_state_dict(sd["inner"])
        self._set_lr()
