"""The training facade on one device (counterpart of
``accelerate_tpu/accelerator.py``).

``Accelerator(mixed_precision=...)`` then ``prepare(model, optimizer)``,
``prepare_data_loader(...)`` and either the eager loop
(``accumulate`` / ``backward`` / ``clip_grad_norm_`` / ``optimizer.step``
/ ``zero_grad``) or ``train_step(loss_fn, max_grad_norm=...)``, which runs
forward, backward, accumulation and the update in one call.

A scheduler passed to ``prepare`` (a ``torch.optim.lr_scheduler`` or a
callable ``step -> lr``) is wrapped in
:class:`~accelerate_tpu_torch.scheduler.AcceleratedScheduler`, which
steps only when the optimizer updated.

Around the step, as in the JAX package: ``save_state``/``load_state``/
``resume_from_latest`` (``checkpointing.py``: atomic commits, automatic
naming and retention under ``ProjectConfiguration``, async saves, custom
objects and pre-hooks, the preemption handler); ``check_step_health``
(``TrainingHealthConfig``: raise, skip or restore on a non-finite step,
read now or ``readback_depth`` steps later); trackers (``log_with``,
``init_trackers``, ``log``, ``async_logging``); and the world-size-1
collectives (``gather``, ``gather_for_metrics``, ``reduce``,
``pad_across_processes``).

``backward`` keeps the JAX signature: it takes the loss *function* and its
arguments, differentiates ``loss / gradient_accumulation_steps`` (times the
fp16 loss scale) and returns the unscaled loss. Everything outside one
device (a mesh, pipeline schedules, gradient-compression hooks) waits for
the distributed slice (ROADMAP.md A7) and raises.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map

from .data_loader import DataLoaderDispatcher, DataLoaderShard, prepare_data_loader, skip_first_batches
from .logging import get_logger
from .model import prepare_model, unwrap_model
from .optimizer import AcceleratedOptimizer, DynamicScale
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    TrainingHealthConfig,
)
from .utils.fault import TrainingHealthError

logger = get_logger(__name__)

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
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        log_with: Optional[Union[str, list]] = None,
        step_scheduler_with_optimizer: bool = True,
        cpu: bool = False,
        kwargs_handlers: Optional[Sequence] = None,
        health_config: Optional[TrainingHealthConfig] = None,
        replication_config=None,
        async_logging: bool = False,
    ):
        if parallelism_config is not None:
            raise NotImplementedError(
                "parallelism_config: a mesh of more than one device (FSDP2/DDP, tp, cp, "
                "and pp with its 1F1B schedule) waits for the distributed slice (ROADMAP.md A7)"
            )
        if replication_config is not None:
            raise NotImplementedError(
                "replication_config: mirroring checkpoints to durable storage and restoring "
                "from a replica come with elastic resume in the distributed slice (ROADMAP.md A7)"
            )
        self.project_configuration = project_config or ProjectConfiguration(project_dir=project_dir)
        if project_dir is not None and self.project_configuration.project_dir is None:
            self.project_configuration.set_directories(project_dir)
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
            elif isinstance(handler, TrainingHealthConfig) and health_config is None:
                health_config = handler
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
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.log_with = [log_with] if isinstance(log_with, str) else list(log_with or [])
        self.trackers: list = []
        self.step = 0
        self.flag_tensor = None
        self._forced_sync = False
        self._models: list = []
        self._optimizers: list = []
        self._schedulers: list = []
        self._dataloaders: list = []
        self._custom_objects: list = []
        self._save_state_pre_hooks: list = []
        self._load_state_pre_hooks: list = []
        # the health watchdog: the ring of deferred summaries and the
        # tracker flusher are made when first needed
        self.health_config = health_config or TrainingHealthConfig()
        self._bad_step_count = 0
        self._last_committed_checkpoint: Optional[str] = None
        self._health_ring = None
        self._health_seq = 0
        self.last_health = None
        self.async_logging = async_logging or os.environ.get(
            "ACCELERATE_ASYNC_LOGGING", "").strip().lower() in ("1", "true", "yes", "on")
        self._tracker_flusher = None
        if os.environ.get("ACCELERATE_HANDLE_PREEMPTION", "").strip().lower() in (
                "1", "true", "yes", "on"):
            self.install_preemption_handler()

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

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def project_dir(self):
        return self.project_configuration.project_dir

    @property
    def logging_dir(self):
        return self.project_configuration.logging_dir

    @property
    def save_iteration(self) -> int:
        return self.project_configuration.iteration

    def print(self, *args, **kwargs) -> None:
        """``print`` on the main process (with one process, always)."""
        self.state.print(*args, **kwargs)

    def wait_for_everyone(self, tag: str = "accelerate_tpu_torch.Accelerator.wait_for_everyone"):
        self.state.wait_for_everyone(tag)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.main_process_first():
            yield

    def __repr__(self) -> str:
        return f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r})"

    # ---------------------------------------------------------------- prepare
    def prepare(self, *args):
        """Prepare each object and return them in order: modules first (the
        optimizer steps their parameters), then optimizers, loaders and
        schedulers (a scheduler wraps the last optimizer prepared; any other
        callable is taken for a schedule ``step -> lr``, as in the JAX
        package)."""
        prepared = {i: self.prepare_model(obj) for i, obj in enumerate(args)
                    if isinstance(obj, nn.Module)}
        result = []
        for i, obj in enumerate(args):
            if i in prepared:
                result.append(prepared[i])
            elif isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                result.append(self.prepare_optimizer(obj))
            elif isinstance(obj, (DataLoaderShard, DataLoaderDispatcher, torch.utils.data.DataLoader)):
                result.append(self.prepare_data_loader(obj))
            elif isinstance(obj, (AcceleratedScheduler, torch.optim.lr_scheduler.LRScheduler)) \
                    or callable(obj):
                result.append(self.prepare_scheduler(obj))
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

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        """Wrap ``scheduler`` so it steps with the last prepared optimizer's
        real updates (``step_scheduler_with_optimizer``)."""
        if not isinstance(scheduler, AcceleratedScheduler):
            scheduler = AcceleratedScheduler(
                scheduler,
                optimizer=self._optimizers[-1] if self._optimizers else None,
                step_with_optimizer=self.step_scheduler_with_optimizer,
                split_batches=self.dataloader_config.split_batches,
            )
        self._schedulers.append(scheduler)
        return scheduler

    def prepare_data_loader(self, dataloader, device_placement=None, **kwargs):
        """:func:`~accelerate_tpu_torch.data_loader.prepare_data_loader` on
        this device, with the ``DataLoaderConfiguration`` defaults; the
        loader's position is saved by ``save_state``."""
        if isinstance(dataloader, (DataLoaderShard, DataLoaderDispatcher)):
            if dataloader not in self._dataloaders:
                self._dataloaders.append(dataloader)
            return dataloader
        cfg = self.dataloader_config
        kwargs.setdefault("split_batches", cfg.split_batches)
        kwargs.setdefault("even_batches", cfg.even_batches)
        kwargs.setdefault("dispatch_batches", cfg.dispatch_batches)
        kwargs.setdefault("non_blocking", cfg.non_blocking)
        kwargs.setdefault("use_seedable_sampler", cfg.use_seedable_sampler)
        if cfg.data_seed is not None:
            kwargs.setdefault("seed", cfg.data_seed)
        prepared = prepare_data_loader(
            dataloader, device=self.device,
            put_on_device=True if device_placement is None else device_placement, **kwargs)
        self._dataloaders.append(prepared)
        return prepared

    def skip_first_batches(self, dataloader, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

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

    def eval_step(self, eval_fn: Callable, model: Optional[nn.Module] = None) -> Callable:
        """A forward-only step: ``step(*batch)`` runs ``eval_fn(model,
        *batch)`` without autograd."""
        model = model or self._models[-1]

        def step(*batch):
            with torch.no_grad():
                return eval_fn(model, *batch)

        return step

    # ------------------------------------------------------------ collectives
    def gather(self, tensor):
        """Every process's ``tensor`` concatenated on dim 0: with one
        process, the tensor itself."""
        return tensor

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """:meth:`gather`, then on the loader's last batch only its
        ``remainder`` real samples (the even-batches padding dropped). Data
        that is not tensors goes through the object gather."""
        if use_gather_object or not any(isinstance(t, torch.Tensor)
                                        for t in tree_leaves(input_data)):
            return list(input_data) if isinstance(input_data, (list, tuple)) \
                else self.state.gather_object(input_data)
        data = self.gather(input_data)
        gs = self.gradient_state
        if gs.end_of_dataloader and gs.remainder > 0:
            rem = gs.remainder
            data = tree_map(lambda t: t[:rem] if isinstance(t, torch.Tensor) else t, data)
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        """The sum (or mean) of ``tensor`` over processes, times ``scale``:
        with one process, ``tensor * scale``."""
        if reduction not in ("sum", "mean", "none"):
            raise ValueError(f"reduction must be sum|mean|none, got {reduction!r}")
        return tree_map(lambda t: t * scale if isinstance(t, torch.Tensor) and scale != 1.0 else t,
                        tensor)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        """Pad ``dim`` to the largest size over processes: with one
        process, nothing to pad."""
        return tensor

    # --------------------------------------------------------------- triggers
    def set_trigger(self) -> None:
        """Raise a flag :meth:`check_trigger` reads on every process."""
        self.flag_tensor = True

    def check_trigger(self) -> bool:
        if any(self.state.gather_object(bool(self.flag_tensor))):
            self.flag_tensor = False
            return True
        return False

    def free_memory(self, *objects):
        """Drop the prepared objects and release ``objects`` and cached
        device memory."""
        from .utils.memory import release_memory

        self._models.clear()
        self._optimizers.clear()
        self._schedulers.clear()
        self._dataloaders.clear()
        return release_memory(*objects)

    def clear(self, *objects):
        return self.free_memory(*objects)

    # ------------------------------------------------------------ checkpoints
    def register_for_checkpointing(self, *objects) -> None:
        """Objects with ``state_dict``/``load_state_dict`` saved and loaded
        with the training state."""
        invalid = [o for o in objects if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError(f"Objects must expose state_dict/load_state_dict: {invalid}")
        self._custom_objects.extend(objects)

    def register_save_state_pre_hook(self, hook: Callable) -> None:
        """``hook(models, weights, output_dir)`` runs before ``save_state``
        writes (``weights`` is None here, as in the JAX package)."""
        self._save_state_pre_hooks.append(hook)

    def register_load_state_pre_hook(self, hook: Callable) -> None:
        """``hook(models, input_dir)`` runs before ``load_state`` reads."""
        self._load_state_pre_hooks.append(hook)

    def save_state(self, output_dir: Optional[str] = None, **save_kwargs) -> str:
        """Save the training state (see ``checkpointing.py``); with
        ``automatic_checkpoint_naming``, to the next
        ``checkpoints/checkpoint_<n>``. Returns the directory."""
        from .checkpointing import _resolve_dir, save_accelerator_state

        output_dir = _resolve_dir(self, output_dir, for_save=True)
        for hook in self._save_state_pre_hooks:
            hook(self._models, None, output_dir)
        result = save_accelerator_state(self, output_dir, **save_kwargs)
        if not save_kwargs.get("async_save"):
            self._last_committed_checkpoint = result
        return result

    def load_state(self, input_dir: Optional[str] = None, **load_kwargs) -> None:
        """Restore the training state; with no ``input_dir``, the newest
        committed checkpoint under the project directory."""
        from .checkpointing import _resolve_dir, load_accelerator_state, wait_for_async_saves

        wait_for_async_saves()  # a save still in flight may be the newest
        input_dir = _resolve_dir(self, input_dir, for_save=False)
        for hook in self._load_state_pre_hooks:
            hook(self._models, input_dir)
        load_accelerator_state(self, input_dir, **load_kwargs)

    def resume_from_latest(self, input_dir: Optional[str] = None,
                           elastic: Optional[bool] = None) -> bool:
        """Load the newest committed checkpoint if there is one: True when
        state was restored, False on a first launch, so a script calls it
        unconditionally. Prepared loaders resume their mid-epoch position
        from the checkpoint (do not also ``skip_first_batches`` them). With
        automatic naming the next save goes past every checkpoint on disk.
        ``elastic`` (default ``ACCELERATE_ELASTIC``) waits for the
        distributed slice (ROADMAP.md A7)."""
        if elastic is None:
            elastic = os.environ.get("ACCELERATE_ELASTIC", "").strip().lower() in (
                "1", "true", "yes", "on")
        try:
            self.load_state(input_dir, **({"elastic": True} if elastic else {}))
        except FileNotFoundError:
            return False
        pc = self.project_configuration
        if input_dir is None and pc.automatic_checkpoint_naming and pc.project_dir:
            from .checkpointing import checkpoint_index, list_checkpoints

            indices = [checkpoint_index(os.path.basename(p))
                       for p in list_checkpoints(os.path.join(pc.project_dir, "checkpoints"))]
            if indices:
                pc.iteration = max(indices) + 1
        return True

    def wait_for_async_saves(self) -> None:
        """Join in-flight async saves and run their commits."""
        from .checkpointing import wait_for_async_saves

        wait_for_async_saves()

    def install_preemption_handler(self, **kwargs) -> bool:
        """Checkpoint, then exit, on SIGTERM/SIGINT (``utils/fault.py``)."""
        from .utils.fault import install_preemption_handler

        return install_preemption_handler(self, **kwargs)

    def save_model(self, model: nn.Module, save_directory: str, max_shard_size: str = "10GB",
                   safe_serialization: bool = True) -> None:
        """The model's tensors as sharded safetensors (the interchange
        format; a Llama under the JAX package's names)."""
        from .checkpointing import save_model_checkpoint

        save_model_checkpoint(model, save_directory, max_shard_size=max_shard_size)

    def get_state_dict(self, model: nn.Module, unwrap: bool = True) -> dict:
        """The model's tensors (detached) under their checkpoint names."""
        from .checkpointing import model_tensors

        return {k: t.detach() for k, t in model_tensors(model).items()}

    # ------------------------------------------------------- health watchdog
    def check_step_health(self, loss=None, grads=None, grad_norm=None) -> bool:
        """Check this step's ``loss`` (and, with ``health_config.
        check_grads``, the gradients: by default the prepared optimizers'
        ``.grad``, with the norm their clipping computed) for NaN/Inf and
        apply the policy. True: the step is healthy. False: it was
        discarded (``"skip"`` dropped the gradients, ``"restore"`` reloaded
        the last committed checkpoint). ``"raise"``, and ``max_bad_steps``
        consecutive bad steps under any policy, raise
        ``TrainingHealthError``. One device-to-host read per call
        (``telemetry.health_summary``). With ``health_config.sync=False``
        the summary is queued and the verdict applied and returned is the
        one from ``readback_depth`` calls earlier; :meth:`health_drain`
        (and ``end_training``) apply the rest."""
        from . import telemetry

        cfg = self.health_config
        if cfg.check_grads:
            if grads is None:
                grads = next((opt.grads() for opt in self._optimizers if opt.grads()), None)
            if grad_norm is None:
                grad_norm = next((opt._last_grad_norm for opt in self._optimizers
                                  if opt._last_grad_norm is not None), None)
        else:
            grads = None
        summary = telemetry.health_summary(loss, grads, grad_norm)
        step = self._health_seq
        self._health_seq += 1
        if cfg.sync:
            return self._apply_health_verdict(telemetry.read_summary(summary, step))
        if self._health_ring is None:
            self._health_ring = telemetry.DeferredReadbackRing(cfg.readback_depth)
        ok = True
        for s, matured in self._health_ring.push((step, telemetry.start_readback(summary))):
            ok = self._apply_health_verdict(telemetry.read_summary(matured, s)) and ok
        return ok

    def health_drain(self) -> bool:
        """Apply every verdict still on the deferred ring: True when every
        drained step was healthy (and in sync mode)."""
        from . import telemetry

        ok = True
        ring = self._health_ring
        while ring is not None and len(ring):
            # one at a time: a restore clears the ring (what is left
            # predates the reload)
            step, summary = ring.popleft()
            ok = self._apply_health_verdict(telemetry.read_summary(summary, step)) and ok
        return ok

    def _apply_health_verdict(self, health) -> bool:
        cfg = self.health_config
        self.last_health = health
        if health.healthy:
            self._bad_step_count = 0
            return True
        self._bad_step_count += 1
        if cfg.nonfinite_policy == "raise":
            raise TrainingHealthError(
                f"non-finite loss/gradients at health step {health.step} (nonfinite_policy='raise')")
        if self._bad_step_count >= cfg.max_bad_steps:
            raise TrainingHealthError(
                f"{self._bad_step_count} consecutive non-finite steps: exceeded max_bad_steps="
                f"{cfg.max_bad_steps} under nonfinite_policy={cfg.nonfinite_policy!r}")
        for opt in self._optimizers:
            opt.zero_grad()
        if cfg.nonfinite_policy == "skip":
            logger.warning(f"non-finite loss/gradients at health step {health.step}; skipping the "
                           f"step ({self._bad_step_count}/{cfg.max_bad_steps} consecutive)")
            return False
        logger.warning(f"non-finite loss/gradients at health step {health.step}; restoring the last "
                       f"committed checkpoint ({self._bad_step_count}/{cfg.max_bad_steps} consecutive)")
        if self._health_ring is not None:
            self._health_ring.clear()
        self.load_state(self._last_committed_checkpoint)
        return False

    # -------------------------------------------------------------- trackers
    def init_trackers(self, project_name: str, config: Optional[dict] = None,
                      init_kwargs: Optional[dict] = None) -> None:
        """Start the trackers of ``log_with`` under ``project_name``."""
        from .tracking import filter_trackers

        if self._tracker_flusher is not None:
            flusher, self._tracker_flusher = self._tracker_flusher, None
            flusher.close()
        init_kwargs = init_kwargs or {}
        self.trackers = []
        for tracker_cls in filter_trackers(self.log_with, self.logging_dir):
            tracker = tracker_cls(project_name, logging_dir=self.logging_dir,
                                  **init_kwargs.get(tracker_cls.name, {}))
            tracker.start()
            if config is not None:
                tracker.store_init_configuration(config)
            self.trackers.append(tracker)
        if self.async_logging and self.is_main_process:
            from .telemetry import AsyncTrackerFlusher

            self._tracker_flusher = AsyncTrackerFlusher(self.trackers)

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if tracker.name == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"Tracker {name} not initialized")

    def log(self, values: dict, step: Optional[int] = None, log_kwargs: Optional[dict] = None) -> None:
        """Log ``values`` to every tracker. With ``async_logging``, device
        tensors are queued as they are (no read on the training loop's
        thread); otherwise each tracker gets them now."""
        if not self.is_main_process:
            return
        log_kwargs = log_kwargs or {}
        if self._tracker_flusher is not None:
            self._tracker_flusher.submit(values, step, log_kwargs)
            return
        for tracker in self.trackers:
            tracker.log(values, step=step, **log_kwargs.get(tracker.name, {}))

    def flush_trackers(self) -> None:
        """Wait until every ``log`` so far is written (async logging);
        raise a deferred tracker error."""
        if self._tracker_flusher is not None:
            self._tracker_flusher.flush()

    def end_training(self) -> None:
        """Commit in-flight async saves, apply pending health verdicts, and
        flush and finish the trackers; every step runs, and the first error
        is raised after them."""
        from .checkpointing import wait_for_async_saves

        try:
            wait_for_async_saves()
        finally:
            try:
                self.health_drain()
            finally:
                try:
                    if self._tracker_flusher is not None:
                        flusher, self._tracker_flusher = self._tracker_flusher, None
                        flusher.close()
                finally:
                    for tracker in self.trackers:
                        tracker.finish()

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

        ``multi_step=True``: the callable takes batches with a leading N
        axis on every tensor and returns the (N,) losses of N steps, with the
        accumulation and the fp16 scaler semantics of N single calls, as the
        JAX package's ``lax.scan`` over its step. Here it is a Python loop
        over the single step: the training step keeps the card busy (busy
        share 0.98 at Llama-3-8B width), so one program for N steps would
        save launch time the card does not wait for.

        The JAX ``donate`` and ``flatten_params`` have no counterpart:
        donation frees a jitted program's inputs, and ``flatten_params``
        (``utils/flatbuf.py``) packs the pytree into a few buffers to avoid
        a per-buffer cost at the TPU program boundary; PyTorch runs eagerly
        and updates in place, so there is no program boundary to pay."""
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

        if not multi_step:
            return step

        def steps(*batches):
            return torch.stack([
                step(*tree_map(lambda t: t[i] if isinstance(t, torch.Tensor) else t, batches))
                for i in range(_steps_of(batches))])

        return steps


def _steps_of(batches) -> int:
    """N, the leading axis that every tensor of a multi-step batch tree
    shares."""
    sizes = {t.shape[0] for t in tree_leaves(batches) if isinstance(t, torch.Tensor)}
    if len(sizes) != 1:
        raise ValueError(f"multi_step batches need one leading N axis on every tensor, got {sorted(sizes)}")
    return sizes.pop()
