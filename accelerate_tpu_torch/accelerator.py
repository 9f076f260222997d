"""The training facade on one device (counterpart of
``accelerate_tpu/accelerator.py``).

``Accelerator(mixed_precision=...)`` then ``prepare(model, optimizer)``,
``prepare_data_loader(...)`` and either the eager loop
(``accumulate`` / ``backward`` / ``clip_grad_norm_`` / ``optimizer.step``
/ ``zero_grad``) or ``train_step(loss_fn, max_grad_norm=...)``, which runs
forward, backward, accumulation and the update in one call.

``backward`` keeps the JAX signature: it takes the loss *function* and its
arguments, differentiates ``loss / gradient_accumulation_steps`` (times the
fp16 loss scale) and returns the unscaled loss. Everything outside one
device (a mesh, pipeline schedules, gradient-compression hooks) waits for
the distributed slice (ROADMAP.md A7) and raises.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .data_loader import DataLoaderShard, prepare_data_loader
from .model import prepare_model, unwrap_model
from .optimizer import AcceleratedOptimizer, DynamicScale
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    MixedPrecisionPolicy,
)

__all__ = ["Accelerator"]


def _split_loss(out):
    return out if isinstance(out, tuple) else (out, None)


class Accelerator:
    """Single entry object for training on one device. ``cpu=False`` (the
    default) runs on the card and raises without one; ``cpu=True`` runs the
    plain versions on the CPU."""

    def __init__(
        self,
        *,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        parallelism_config=None,
        cpu: bool = False,
        kwargs_handlers: Optional[Sequence] = None,
    ):
        if parallelism_config is not None:
            raise NotImplementedError(
                "parallelism_config: a mesh of more than one device (FSDP2/DDP, tp, cp, "
                "and pp with its 1F1B schedule) waits for the distributed slice (ROADMAP.md A7)"
            )
        self.scaler_kwargs = None
        self.mp_policy_override = None
        self.ddp_handler = None
        for handler in kwargs_handlers or []:
            if isinstance(handler, GradScalerKwargs):
                self.scaler_kwargs = handler
            elif isinstance(handler, MixedPrecisionPolicy):
                self.mp_policy_override = handler
            elif isinstance(handler, DistributedDataParallelKwargs):
                self.ddp_handler = handler
            elif isinstance(handler, DataLoaderConfiguration) and dataloader_config is None:
                dataloader_config = handler
            elif isinstance(handler, GradientAccumulationPlugin) and gradient_accumulation_plugin is None:
                gradient_accumulation_plugin = handler
            else:
                raise TypeError(f"unsupported kwargs handler {type(handler).__name__}")
        self.dataloader_config = dataloader_config or DataLoaderConfiguration()
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu)
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=gradient_accumulation_steps)
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.policy = self.mp_policy_override or MixedPrecisionPolicy.from_mixed_precision(
            self.state.mixed_precision)
        self.scaler: Optional[DynamicScale] = None
        if self.state.mixed_precision == "fp16":
            kw = self.scaler_kwargs.to_dict() if self.scaler_kwargs else {}
            if kw.pop("enabled", True):
                self.scaler = DynamicScale(**kw)
        self.step = 0
        self._forced_sync = False
        self._models: list = []
        self._optimizers: list = []

    # ------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    def print(self, *args, **kwargs) -> None:
        """``print`` on the main process (with one process, always)."""
        print(*args, **kwargs)

    def __repr__(self) -> str:
        return f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r})"

    # ---------------------------------------------------------------- prepare
    def prepare(self, *args):
        """Prepare each object and return them in order: modules first (the
        optimizer steps their parameters), then optimizers, then loaders."""
        prepared = {i: self.prepare_model(obj) for i, obj in enumerate(args)
                    if isinstance(obj, nn.Module)}
        result = []
        for i, obj in enumerate(args):
            if i in prepared:
                result.append(prepared[i])
            elif isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                result.append(self.prepare_optimizer(obj))
            elif isinstance(obj, DataLoaderShard):
                result.append(self.prepare_data_loader(obj))
            elif isinstance(obj, torch.optim.lr_scheduler.LRScheduler):
                raise NotImplementedError(
                    "schedulers (scheduler.py, which GradientAccumulationPlugin.adjust_scheduler "
                    "steps) are not ported yet (ROADMAP.md A4)")
            else:
                result.append(obj)
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: nn.Module) -> nn.Module:
        """``model`` on the device, wrapped for mixed precision unless it
        casts per use (``model.prepare_model``)."""
        model = prepare_model(model, self.policy, self.device)
        if model not in self._models:
            self._models.append(model)
        return model

    def prepare_optimizer(self, optimizer) -> AcceleratedOptimizer:
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = AcceleratedOptimizer(optimizer, scaler=self.scaler)
        self._optimizers.append(optimizer)
        return optimizer

    def prepare_data_loader(self, dataloader, **kwargs) -> DataLoaderShard:
        """:func:`~accelerate_tpu_torch.data_loader.prepare_data_loader` on
        this device, with the ``DataLoaderConfiguration`` defaults."""
        cfg = self.dataloader_config
        kwargs.setdefault("non_blocking", cfg.non_blocking)
        if cfg.data_seed is not None:
            kwargs.setdefault("seed", cfg.data_seed)
        return prepare_data_loader(dataloader, device=self.device, **kwargs)

    # ------------------------------------------------------- training: eager
    def _loss_scale(self) -> float:
        return self.scaler.scale if self.scaler is not None else 1.0

    def backward(self, loss_fn: Callable, *args, model: Optional[nn.Module] = None, **kwargs):
        """Accumulate the gradients of ``loss_fn(model, *args, **kwargs)``
        into the parameters' ``.grad``, the loss divided by the accumulation
        steps (and times the fp16 loss scale). Returns the unscaled loss
        (detached); a ``(loss, aux)`` return passes aux through."""
        if model is None:
            if not self._models:
                raise ValueError("No prepared model; call prepare() first")
            model = self._models[-1]
        if not self._optimizers:
            raise RuntimeError(
                "backward() needs a prepared optimizer to accumulate gradients for; "
                "pass the optimizer to prepare(), or use accelerator.train_step"
            )
        loss, aux = _split_loss(loss_fn(model, *args, **kwargs))
        (loss * (self._loss_scale() / self.gradient_state.num_steps)).backward()
        loss = loss.detach()
        return loss if aux is None else (loss, aux)

    def unscale_gradients(self, optimizer: Optional[AcceleratedOptimizer] = None) -> None:
        """Divide the accumulated gradients by the fp16 loss scale (once)."""
        for opt in [optimizer] if optimizer is not None else self._optimizers:
            opt.unscale_()

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0):
        """Clip the accumulated gradients (of the prepared optimizer's
        parameters) by their global L2 norm; nothing mid-accumulation.
        Returns the norm before clipping."""
        if not self.gradient_state.sync_gradients or not self._optimizers:
            return torch.zeros((), device=self.device)
        return self._optimizers[-1].clip_grad_norm_(max_norm)

    def clip_grad_value_(self, parameters=None, clip_value: float = 1.0) -> None:
        if self.gradient_state.sync_gradients and self._optimizers:
            self._optimizers[-1].clip_grad_value_(clip_value)

    def _do_sync(self) -> None:
        """Set ``sync_gradients`` for this micro-batch: every
        ``gradient_accumulation_steps``-th call, and at the end of the data
        loader whatever the count."""
        if self.gradient_state.sync_with_dataloader and self.gradient_state.end_of_dataloader:
            self.step = 0
            self._forced_sync = False
            self.gradient_state._set_sync_gradients(True)
        else:
            self.step += 1
            forced, self._forced_sync = self._forced_sync, False
            self.gradient_state._set_sync_gradients(
                forced or (self.step % self.gradient_state.num_steps) == 0)

    @contextlib.contextmanager
    def accumulate(self, *models):
        """Per-micro-batch context that sets ``sync_gradients``."""
        self._do_sync()
        yield

    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A parity context: precision is the policy applied at
        ``prepare`` (or the model's own per-use casts), not toggled here."""
        yield

    def unwrap_model(self, model: nn.Module, keep_fp32_wrapper: bool = True) -> nn.Module:
        return model if keep_fp32_wrapper else unwrap_model(model)

    # ------------------------------------------------------ training: fused
    def train_step(
        self,
        loss_fn: Callable,
        model: Optional[nn.Module] = None,
        optimizer: Optional[AcceleratedOptimizer] = None,
        max_grad_norm: Optional[float] = None,
        multi_step: bool = False,
    ) -> Callable:
        """One step function: ``step(*batch) -> loss`` runs
        ``loss_fn(model, *batch)``, its backward, and accumulates; it sets
        ``sync_gradients`` on every ``gradient_accumulation_steps``-th call
        and then updates through the eager loop's own calls:
        ``optimizer.clip_grad_norm_(max_grad_norm)`` (unscaling under fp16),
        ``optimizer.step()`` (which, under fp16, keeps parameters and
        optimizer state on overflow and grows or backs off the scale) and
        ``optimizer.zero_grad()``. The loss it returns is the unscaled one,
        detached, on the device (no host readback outside the fp16 finite
        check).

        The JAX ``donate`` and ``flatten_params`` have no counterpart:
        donation frees a jitted program's inputs, and ``flatten_params``
        (``utils/flatbuf.py``) packs the pytree into a few buffers to avoid
        a per-buffer cost at the TPU program boundary; PyTorch runs eagerly
        and updates in place, so there is no program boundary to pay."""
        if multi_step:
            raise NotImplementedError(
                "multi_step=True (N steps in one program) is not ported; it waits "
                "for CUDA graphs (ROADMAP.md A9)")
        if self.ddp_handler is not None and self.ddp_handler.comm_hook == "powersgd":
            raise NotImplementedError(
                "comm_hook='powersgd' compresses the cross-device gradient reduction; "
                "PowerSGD waits for the distributed slice (ROADMAP.md A7)")
        if self.ddp_handler is not None and self.ddp_handler.comm_hook != "no":
            raise NotImplementedError(
                f"comm_hook={self.ddp_handler.comm_hook!r}: the gradient-compression dtype "
                "applies to the cross-device reduction and waits for the distributed "
                "slice (ROADMAP.md A7)")
        model = model or self._models[-1]
        optimizer = optimizer or self._optimizers[-1]
        k = int(self.gradient_state.num_steps)
        state = {"count": 0}

        def step(*batch):
            state["count"] = state["count"] % k + 1
            sync = state["count"] == k
            self.gradient_state._set_sync_gradients(sync)
            loss, _ = _split_loss(loss_fn(model, *batch))
            (loss * (self._loss_scale() / k)).backward()
            if sync:
                if max_grad_norm is not None:
                    optimizer.clip_grad_norm_(max_grad_norm)
                optimizer.step()
                optimizer.zero_grad()
            return loss.detach()

        return step
