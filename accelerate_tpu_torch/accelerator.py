"""The training facade (counterpart of ``accelerate_tpu/accelerator.py``).

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
objects and pre-hooks, the preemption handler; ``elastic.py``: replicas
under a ``ReplicationConfig`` and, with several processes, the consensus
resume); the heartbeat the launch supervisor's watchdog reads (touched
when the Accelerator is built, after every step, and around a save and a
load); ``check_step_health``
(``TrainingHealthConfig``: raise, skip or restore on a non-finite step,
read now or ``readback_depth`` steps later); trackers (``log_with``,
``init_trackers``, ``log``, ``async_logging``); and the collectives across
processes (``gather``, ``gather_for_metrics``, ``reduce``,
``pad_across_processes``, ``ops/operations.py``).

Under ``mixed_precision="fp8"`` (bf16 compute) ``prepare`` puts the
products on the card's fp8 tensor cores (``ops/fp8.py``) before any
wrapping: a Llama's ``use_fp8`` is set, any other module is rewritten
(``fp8_rewrite``), and each scale's amax is all-reduced over the ranks the
JAX package's spans (``parallel.sharding.fp8_groups``).

``backward`` keeps the JAX signature: it takes the loss *function* and its
arguments, differentiates ``loss / gradient_accumulation_steps`` (times the
fp16 loss scale) and returns the unscaled loss.

Several processes (one per card, or gloo ranks on the CPU under
``cpu=True``; ``state.py`` starts the group) train data-parallel, as the
``ParallelismConfig`` says (default: the launcher's environment, else DDP
over every process): ``prepare`` wraps the model in DDP, FSDP2 or HSDP
(``parallel/sharding.py``) and points the optimizer at the parameters that
took the place of its own. A one-process run takes the same path when
given a ``ParallelismConfig`` with an ``FSDPPlugin`` (FSDP2) or a
``DistributedDataParallelKwargs`` (DDP). Each rank sees its own rows, and
the step gives what the JAX step gives on the global batch: a loss with a
``ce_denominator`` (``llama_loss``) has its per-rank sum divided by the
valid-token count summed over the ranks, so uneven ``loss_mask``s average
as one batch; the returned loss is the global one; ``accumulate`` and
``train_step`` skip the gradient reduction on the micro-steps that do not
update (``no_sync``); clipping takes the global norm. Under ``tp``
(``ParallelismConfig(tp_size=...)``, alone or with the data-parallel dims,
or a ``TensorParallelConfig`` at ``tp_size=1``) a Llama is split Megatron-
style with a sequence-parallel residual (``parallel/tp.py``) and then
sharded over the data-parallel dims (FSDP2, HSDP); the ``tp`` ranks of one
data-parallel coordinate read the same rows, the loss is reduced over the
data-parallel ranks only, and the gradients of ``tp``-replicated
parameters are summed over ``tp``. Under ``ep`` (``ep_size > 1``) an MoE
Llama keeps ``num_experts / ep_size`` experts a rank (``parallel/ep.py``),
laid out and sharded the same way; over the data-parallel ranks its MoE
layers route each global batch as one, as the JAX step does
(``ops/moe.py``). Context, sequence and pipeline parallelism, MoE under
``tp`` and PowerSGD wait for ROADMAP.md A11 and raise.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn
from torch.utils._pytree import tree_leaves, tree_map

from . import tracing
from .data_loader import DataLoaderDispatcher, DataLoaderShard, prepare_data_loader, skip_first_batches
from .logging import get_logger
from .model import prepare_model, unwrap_model
from .optimizer import AcceleratedOptimizer, DynamicScale
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DistributedDataParallelKwargs,
    FSDPPlugin,
    GradientAccumulationPlugin,
    GradScalerKwargs,
    MixedPrecisionPolicy,
    ProjectConfiguration,
    ReplicationConfig,
    TrainingHealthConfig,
)
from .utils.fault import TrainingHealthError

logger = get_logger(__name__)

__all__ = ["Accelerator"]


def _split_loss(out):
    return out if isinstance(out, tuple) else (out, None)


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


class Accelerator:
    """Single entry object for training. ``cpu=False`` (the default) runs on
    the card and raises without one; ``cpu=True`` runs the plain versions
    on the CPU (several processes over gloo). ``device_placement=False``
    leaves prepared models where they are and batches on the host;
    ``rng_types`` names the generators each prepared loader synchronizes
    from the main process at every epoch (``"python"``, ``"numpy"``,
    ``"torch"``, ``"generator"``)."""

    def __init__(
        self,
        *,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        fsdp_plugin: Optional[FSDPPlugin] = None,
        parallelism_config=None,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        project_dir: Optional[str] = None,
        project_config: Optional[ProjectConfiguration] = None,
        log_with: Optional[Union[str, list]] = None,
        rng_types: Optional[Sequence[str]] = None,
        cpu: bool = False,
        device_placement: bool = True,
        step_scheduler_with_optimizer: bool = True,
        kwargs_handlers: Optional[Sequence] = None,
        health_config: Optional[TrainingHealthConfig] = None,
        replication_config: Optional[ReplicationConfig] = None,
        async_logging: bool = False,
    ):
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
            elif isinstance(handler, ReplicationConfig) and replication_config is None:
                replication_config = handler
            else:
                raise TypeError(f"unsupported kwargs handler {type(handler).__name__}")
        self.dataloader_config = dataloader_config or DataLoaderConfiguration()
        if fsdp_plugin is None and os.environ.get("ACCELERATE_USE_FSDP", "") == "true":
            fsdp_plugin = FSDPPlugin()
        self.fsdp_plugin = fsdp_plugin
        self.device_placement = device_placement
        self.rng_types = rng_types
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu,
                                      parallelism_config=parallelism_config)
        # the data-parallel layout: under several processes always; with
        # one, when a configuration or the FSDP plugin asks for it
        self.layout = "none"
        self.mesh = None
        if parallelism_config is not None or fsdp_plugin is not None or self.num_processes > 1:
            from .parallel.sharding import data_parallel_layout, layout_mesh

            forced_ddp = self.ddp_handler if parallelism_config is not None else None
            self.layout = data_parallel_layout(self.parallelism_config, fsdp_plugin, forced_ddp)
            if self.layout != "none":
                self.mesh = layout_mesh(self.layout, self.parallelism_config, self.device.type)
                self.state.device_mesh = self.mesh
        self._param_map: dict = {}
        self._replicated: set = set()  # parameters FSDP2 left whole
        self._tp_replicated: set = set()  # parameters replicated over tp
        self._fp8_groups = None  # ops.fp8.Fp8Groups of the layout, made at the first prepare
        if gradient_accumulation_plugin is None:
            gradient_accumulation_plugin = GradientAccumulationPlugin(num_steps=int(os.environ.get(
                "ACCELERATE_GRADIENT_ACCUMULATION_STEPS", gradient_accumulation_steps)))
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
        # the perf observatory's window: the time between two materialised
        # health verdicts is the step's throughput, read where the host
        # already waits for the card
        self._pw_mark = None
        self.async_logging = async_logging or os.environ.get(
            "ACCELERATE_ASYNC_LOGGING", "").strip().lower() in ("1", "true", "yes", "on")
        self._tracker_flusher = None
        # checkpoint replication: every committed checkpoint is mirrored under
        # the target; the launcher arms it through the environment
        if replication_config is None and os.environ.get("ACCELERATE_REPLICATION_TARGET"):
            replication_config = ReplicationConfig(
                target=os.environ["ACCELERATE_REPLICATION_TARGET"],
                copies=int(os.environ.get("ACCELERATE_REPLICATION_COPIES", "1")),
                async_replicate=not _env_flag("ACCELERATE_REPLICATION_SYNC"))
        self.replication_config = replication_config
        self._replicator = None
        if _env_flag("ACCELERATE_HANDLE_PREEMPTION"):
            self.install_preemption_handler()
        self._touch_heartbeat()  # the worker is up: its start counts no further

    # ------------------------------------------------------------- properties
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision

    @property
    def fp8_backend(self) -> Optional[str]:
        """``"NATIVE"`` under ``mixed_precision="fp8"`` (``ops/fp8.py``: the
        card's fp8 tensor cores through ``torch._scaled_mm``), else None."""
        return "NATIVE" if self.state.mixed_precision == "fp8" else None

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
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def parallelism_config(self):
        return self.state.parallelism_config

    @property
    def is_fsdp2(self) -> bool:
        return self.layout in ("fsdp", "hsdp", "tp_fsdp", "tp_hsdp", "ep_fsdp", "ep_hsdp")

    @property
    def split_batches(self) -> bool:
        return self.dataloader_config.split_batches

    @property
    def dispatch_batches(self):
        return self.dataloader_config.dispatch_batches

    @property
    def even_batches(self) -> bool:
        return self.dataloader_config.even_batches

    @property
    def use_seedable_sampler(self) -> bool:
        return self.dataloader_config.use_seedable_sampler

    @property
    def non_blocking(self) -> bool:
        return self.dataloader_config.non_blocking

    def _mesh_axis_rank(self, *axis_names: str) -> int:
        """This process's coordinate along the mesh dims (row-major over
        several); 0 for a dim the mesh does not have."""
        if self.mesh is None:
            return 0
        rank = 0
        for name in axis_names:
            if name in (self.mesh.mesh_dim_names or ()):
                rank = rank * self.mesh.size(self.mesh.mesh_dim_names.index(name)) \
                    + self.mesh.get_local_rank(name)
        return rank

    @property
    def tensor_parallel_rank(self) -> int:
        return self._mesh_axis_rank("tp")

    @property
    def pipeline_parallel_rank(self) -> int:
        return self._mesh_axis_rank("pp")

    @property
    def context_parallel_rank(self) -> int:
        return self._mesh_axis_rank("cp")

    @property
    def data_parallel_rank(self) -> int:
        return self._mesh_axis_rank("dp_replicate", "dp_shard")

    @property
    def data_parallel_shard_rank(self) -> int:
        return self._mesh_axis_rank("dp_shard")

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

    def wait_for_everyone(self, tag: str = "accelerate_tpu_torch.Accelerator.wait_for_everyone",
                          timeout: Optional[float] = None):
        self.state.wait_for_everyone(tag, timeout=timeout)

    @contextlib.contextmanager
    def main_process_first(self):
        with self.state.main_process_first():
            yield

    @contextlib.contextmanager
    def local_main_process_first(self):
        with self.state.local_main_process_first():
            yield

    @contextlib.contextmanager
    def split_between_processes(self, inputs, apply_padding: bool = False):
        with self.state.split_between_processes(inputs, apply_padding=apply_padding) as part:
            yield part

    def on_main_process(self, function):
        return self.state.on_main_process(function)

    def on_local_main_process(self, function):
        return self.state.on_local_main_process(function)

    def on_last_process(self, function):
        return self.state.on_last_process(function)

    def on_process(self, function=None, process_index: int = None):
        return self.state.on_process(function, process_index=process_index)

    def on_local_process(self, function=None, local_process_index: int = None):
        return self.state.on_local_process(function, local_process_index=local_process_index)

    def __repr__(self) -> str:
        return (f"Accelerator(device={self.device}, mixed_precision={self.mixed_precision!r}, "
                f"num_processes={self.num_processes}, layout={self.layout!r})")

    # ---------------------------------------------------------------- prepare
    def prepare(self, *args, device_placement=None):
        """Prepare each object and return them in order: modules first (the
        optimizer steps their parameters), then optimizers, loaders and
        schedulers (a scheduler wraps the last optimizer prepared; any other
        callable is taken for a schedule ``step -> lr``, as in the JAX
        package). ``device_placement``: one bool (or None: the
        Accelerator's) per object, for the modules and loaders."""
        if device_placement is None:
            device_placement = [None] * len(args)
        elif len(device_placement) != len(args):
            raise ValueError(f"device_placement has {len(device_placement)} entries for "
                             f"{len(args)} objects")
        prepared = {i: self.prepare_model(obj, device_placement=device_placement[i])
                    for i, obj in enumerate(args) if isinstance(obj, nn.Module)}
        result = []
        for i, obj in enumerate(args):
            if i in prepared:
                result.append(prepared[i])
            elif isinstance(obj, (torch.optim.Optimizer, AcceleratedOptimizer)):
                result.append(self.prepare_optimizer(obj))
            elif isinstance(obj, (DataLoaderShard, DataLoaderDispatcher, torch.utils.data.DataLoader)):
                result.append(self.prepare_data_loader(obj, device_placement=device_placement[i]))
            elif isinstance(obj, (AcceleratedScheduler, torch.optim.lr_scheduler.LRScheduler)) \
                    or callable(obj):
                result.append(self.prepare_scheduler(obj))
            else:
                result.append(obj)
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: nn.Module, device_placement: Optional[bool] = None,
                      evaluation_mode: bool = False) -> nn.Module:
        """``model`` on the device, wrapped for mixed precision unless it
        casts per use (``model.prepare_model``), and for the data-parallel
        layout (``parallel/sharding.py``). ``evaluation_mode=True``: for
        inference, each process keeps its own whole copy (no DDP or FSDP2)
        in eval mode. ``device_placement=False`` leaves it where it is."""
        place = self.device_placement if device_placement is None else device_placement
        device = self.device if place else None
        if self.state.mixed_precision == "fp8":
            self._prepare_fp8(model, evaluation_mode)
        if self.layout == "none" or evaluation_mode:
            model = prepare_model(model, self.policy, device)
            if evaluation_mode:
                model.eval()
        else:
            from .parallel.sharding import shard_model

            if self.layout == "ddp":
                model = prepare_model(model, self.policy, device)
            elif device is not None:
                model = model.to(device)
            model, pmap, replicated, tp_replicated = shard_model(
                model, self.layout, self.mesh, self.device, fsdp_plugin=self.fsdp_plugin,
                ddp_handler=self.ddp_handler, policy=self.policy, tp_rules=self._tp_rules())
            self._param_map.update(pmap)
            self._replicated.update(replicated)
            self._tp_replicated.update(tp_replicated)
            self._route_over_data_parallel(model)
        if model not in self._models:
            self._models.append(model)
        return model

    def _route_over_data_parallel(self, model: nn.Module) -> None:
        """Give an MoE model (a config with ``num_experts > 1``) the
        data-parallel ranks its layers route one batch over, as the JAX
        step routes the global batch: a group of their own
        (``ops.collectives.mirror_group``), since the routing's collectives
        run inside the backward beside DDP's and FSDP2's."""
        from .model import unwrap_model
        from .ops.collectives import mirror_group

        inner = unwrap_model(model)
        if getattr(getattr(inner, "config", None), "num_experts", 1) <= 1:
            return
        names = self.mesh.mesh_dim_names
        dims = tuple(d for d in ("dp_replicate", "dp_shard")
                     if d in names and self.mesh.size(names.index(d)) > 1)
        if dims:
            inner.dp_group = mirror_group(self.mesh, dims)

    def _prepare_fp8(self, model: nn.Module, evaluation_mode: bool) -> None:
        """fp8 products (``ops/fp8.py``), before any wrapping: a model with a
        ``use_fp8`` config field (the Llama) turns it on and takes the
        layout's amax groups; any other module is rewritten
        (``fp8_rewrite``). Each scale spans what the JAX amax spans on the
        mesh (``parallel.sharding.fp8_groups``); in evaluation mode each
        process runs its own copy on its own rows, and its scales are its
        own."""
        from .model import unwrap_model
        from .ops.fp8 import Fp8Groups, fp8_rewrite
        from .parallel.sharding import fp8_groups

        if evaluation_mode:
            groups = Fp8Groups()
        else:
            if self._fp8_groups is None:
                self._fp8_groups = fp8_groups(self.layout, self.mesh)
            groups = self._fp8_groups
        inner = unwrap_model(model)
        if hasattr(getattr(inner, "config", None), "use_fp8"):
            inner.config.use_fp8 = True
            inner.fp8_groups = groups
        else:
            fp8_rewrite(inner, amax_group=groups)

    def prepare_optimizer(self, optimizer, device_placement=None) -> AcceleratedOptimizer:
        """Wrap ``optimizer``; under a data-parallel layout, first point it
        at the parameters that took its parameters' place (FSDP2 shards, a
        Llama's per-layer ones), which needs it not to have stepped yet."""
        inner = optimizer.optimizer if isinstance(optimizer, AcceleratedOptimizer) else optimizer
        layout = None
        if self._param_map:
            from .parallel.sharding import remap_optimizer

            layout = remap_optimizer(inner, self._param_map)
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = AcceleratedOptimizer(optimizer, scaler=self.scaler)
        if layout is not None:
            optimizer._ckpt_layout = layout
        optimizer.replicated = [p for p in optimizer.params() if p in self._replicated]
        optimizer.tp_replicated = [p for p in optimizer.params() if p in self._tp_replicated]
        optimizer.tp_group = self.mesh.get_group("tp") if optimizer.tp_replicated else None
        optimizer.dp_groups = self._data_parallel_groups()
        self._optimizers.append(optimizer)
        return optimizer

    def _tp_rules(self) -> list:
        """The user's ``(regex, dim)`` rules, the ``FSDPPlugin``'s in front
        of the ``TensorParallelConfig``'s, as the JAX package orders them."""
        rules = list(getattr(self.parallelism_config.tp_config, "sharding_rules", None) or [])
        if self.fsdp_plugin is not None and self.fsdp_plugin.sharding_rules:
            rules = list(self.fsdp_plugin.sharding_rules) + rules
        from .parallel.sharding import TP_LAYOUTS

        if rules and self.layout not in TP_LAYOUTS:
            raise ValueError(f"sharding_rules place parameters over tp; the layout {self.layout!r} "
                             "has no tp dim (set tp_size or pass a TensorParallelConfig)")
        return rules

    def _data_parallel_groups(self) -> list:
        """The process groups a data-parallel reduction runs over, in turn:
        the world's (None) when every process is its own data-parallel
        rank, else the mesh's ``dp_replicate`` and ``dp_shard`` groups
        above size 1 (the ``tp`` ranks hold the same rows); empty with one
        data-parallel rank."""
        if self.num_processes == 1:
            return []
        if self.mesh is None or self.parallelism_config.data_parallel_size == self.num_processes:
            return [None]
        names = self.mesh.mesh_dim_names
        return [self.mesh.get_group(d) for d in ("dp_replicate", "dp_shard")
                if d in names and self.mesh.size(names.index(d)) > 1]

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
        if self.rng_types is not None:
            kwargs.setdefault("rng_types", self.rng_types)
        prepared = prepare_data_loader(
            dataloader, device=self.device,
            put_on_device=self.device_placement if device_placement is None else device_placement,
            **kwargs)
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
        self._check_comm_hook()
        loss, aux = _split_loss(loss_fn(model, *args, **kwargs))
        scale, loss_out = self._data_parallel_loss(loss_fn, loss, args)
        (loss * (scale * self._loss_scale() / self.gradient_state.num_steps)).backward()
        self._touch_heartbeat()
        return loss_out if aux is None else (loss_out, aux)

    def _touch_heartbeat(self) -> None:
        """The liveness signal of the launch supervisor's watchdog: touch
        ``ACCELERATE_HEARTBEAT_FILE`` (exported by ``launch
        --watchdog_timeout``), ``<file>.<LOCAL_RANK>`` under torchrun, where
        each rank beats on its own and the supervisor reads the oldest.
        Nothing without the variable."""
        hb = os.environ.get("ACCELERATE_HEARTBEAT_FILE")
        if not hb:
            return
        rank = os.environ.get("LOCAL_RANK")
        try:
            os.utime(hb if rank is None else f"{hb}.{rank}", None)  # the supervisor made it
        except OSError:
            pass

    def _data_parallel_loss(self, loss_fn: Callable, loss: torch.Tensor, batch: tuple) -> tuple:
        """(gradient scale, the loss to return) of this rank's ``loss``.
        One process: (1.0, the loss). Several: the JAX step's loss on the
        global batch. A loss function with a ``ce_denominator`` (``llama_loss``)
        divides a masked sum by the valid tokens: this rank's sum is summed
        over the ranks and divided by their summed count (one all-reduce),
        and the gradient scale ``count * n / global count`` makes the
        data-parallel gradient mean the gradient of that global loss. Any
        other loss is taken for a mean over equal rows: the mean of the
        ranks' losses. Every reduction runs over the data-parallel ranks
        only: the ``tp`` ranks of one coordinate hold the same rows and the
        same loss."""
        groups = self._data_parallel_groups()
        if not groups:
            return 1.0, loss.detach()
        import torch.distributed as dist

        n = self.num_processes if groups == [None] else self.parallelism_config.data_parallel_size
        fn = getattr(loss_fn, "func", loss_fn)  # a functools.partial of llama_loss
        den_fn = getattr(fn, "ce_denominator", None)
        if den_fn is None:
            mean = loss.detach().clone()
            for group in groups:
                dist.all_reduce(mean, group=group)
            return 1.0, mean / n
        count = den_fn(*batch, clamp=False).to(device=loss.device, dtype=torch.float32)
        local = count.clamp_min(1)
        sums = torch.stack([loss.detach().float() * local, count])
        for group in groups:
            dist.all_reduce(sums, group=group)
        total = sums[1].clamp_min(1)
        return local * n / total, (sums[0] / total).to(loss.dtype)

    def unscale_gradients(self, optimizer: Optional[AcceleratedOptimizer] = None) -> None:
        """Divide the accumulated gradients by the fp16 loss scale (once)."""
        for opt in [optimizer] if optimizer is not None else self._optimizers:
            opt.unscale_()

    def clip_grad_norm_(self, parameters=None, max_norm: float = 1.0, norm_type: float = 2.0):
        """Clip the accumulated gradients (of the prepared optimizer's
        parameters) by their global L2 norm (over every shard, so every
        rank clips by the same factor); nothing mid-accumulation. Returns
        the norm before clipping. ``norm_type`` must be 2, the only norm the
        JAX package clips by."""
        if float(norm_type) != 2.0:
            raise ValueError(f"norm_type={norm_type}: gradients are clipped by their L2 norm "
                             "(norm_type=2.0), as in the JAX package")
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
        """Per-micro-batch context that sets ``sync_gradients``; on a
        micro-batch that does not update, the data-parallel gradient
        reduction of ``models`` (default: every prepared model) is skipped
        (:meth:`no_sync`) unless the plugin's ``sync_each_batch``."""
        self._do_sync()
        with contextlib.ExitStack() as stack:
            if not self.sync_gradients and not self.gradient_state.plugin_kwargs.get(
                    "sync_each_batch", False):
                for model in models or self._models:
                    stack.enter_context(self.no_sync(model))
            yield

    @contextlib.contextmanager
    def no_sync(self, model: nn.Module):
        """Gradients computed inside stay on this rank and accumulate: DDP's
        ``no_sync``, FSDP2's ``set_requires_gradient_sync(False)``; nothing
        to skip on one process."""
        from torch.distributed.fsdp import FSDPModule
        from torch.nn.parallel import DistributedDataParallel

        if isinstance(model, DistributedDataParallel):
            with model.no_sync():
                yield
        elif isinstance(model, FSDPModule):
            model.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                model.set_requires_gradient_sync(True)
        else:
            yield

    @contextlib.contextmanager
    def autocast(self, autocast_handler=None):
        """A parity context: precision is the policy applied at
        ``prepare`` (or the model's own per-use casts), not toggled here."""
        yield

    def unwrap_model(self, model: nn.Module, keep_fp32_wrapper: bool = True) -> nn.Module:
        """The module inside a DDP wrapper; with ``keep_fp32_wrapper=False``
        also inside the mixed-precision wrapper."""
        from .parallel.sharding import unwrap_data_parallel

        return unwrap_data_parallel(model) if keep_fp32_wrapper else unwrap_model(model)

    def eval_step(self, eval_fn: Callable, model: Optional[nn.Module] = None) -> Callable:
        """A forward-only step: ``step(*batch)`` runs ``eval_fn(model,
        *batch)`` without autograd."""
        model = model or self._models[-1]

        def step(*batch):
            with torch.no_grad():
                return eval_fn(model, *batch)

        return step

    # ------------------------------------------------------------ collectives
    def _row_owners(self) -> Optional[list]:
        """The processes whose rows a gather keeps, in data-parallel order:
        each coordinate's ``tp`` (or ``ep``) rank 0 (its ``tp`` or ``ep``
        ranks hold the same rows), or None where every process holds its
        own."""
        names = (self.mesh.mesh_dim_names or ()) if self.mesh is not None else ()
        dim = next((d for d in ("tp", "ep") if d in names), None)
        if dim is None or self.mesh.size(names.index(dim)) == 1:
            return None
        return self.mesh.mesh.select(names.index(dim), 0).flatten().tolist()

    def gather(self, tensor):
        """Every data-parallel rank's tensors concatenated on dim 0, in
        process order (``ops/operations.py``; one process: the tensors
        themselves): under tensor parallelism each coordinate's rows once."""
        from .ops.operations import gather, recursively_apply

        data, owners = gather(tensor), self._row_owners()
        if owners is None:
            return data
        n = self.num_processes
        return recursively_apply(lambda t: t.unflatten(0, (n, -1))[owners].flatten(0, 1), data)

    def gather_for_metrics(self, input_data, use_gather_object: bool = False):
        """:meth:`gather`, then on the loader's last batch only its
        ``remainder`` real samples (the even-batches padding dropped). Data
        that is not tensors goes through the object gather."""
        from .ops.operations import gather_object

        if use_gather_object or not any(isinstance(t, torch.Tensor)
                                        for t in tree_leaves(input_data)):
            owners = self._row_owners()
            if owners is None:
                data = gather_object(input_data)
            else:
                parts = self.state.gather_object(input_data)
                data = []
                for i in owners:
                    data.extend(parts[i]) if isinstance(parts[i], list) else data.append(parts[i])
        else:
            data = self.gather(input_data)
        gs = self.gradient_state
        if gs.end_of_dataloader and gs.remainder > 0:
            rem = gs.remainder
            data = (data[:rem] if isinstance(data, list) else
                    tree_map(lambda t: t[:rem] if isinstance(t, torch.Tensor) else t, data))
        return data

    def reduce(self, tensor, reduction: str = "sum", scale: float = 1.0):
        """The sum (or mean) of ``tensor`` over the data-parallel ranks,
        times ``scale`` (the ``tp`` ranks of one coordinate count once)."""
        from .ops.operations import reduce

        groups = None if self._row_owners() is None else self._data_parallel_groups()
        return reduce(tensor, reduction=reduction, scale=scale, groups=groups)

    def pad_across_processes(self, tensor, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False):
        """Pad ``dim`` to the largest size over processes."""
        from .ops.operations import pad_across_processes

        return pad_across_processes(tensor, dim=dim, pad_index=pad_index, pad_first=pad_first)

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
        self._touch_heartbeat()  # a long write is progress, not a hang
        result = save_accelerator_state(self, output_dir, **save_kwargs)
        if not save_kwargs.get("async_save"):
            self._last_committed_checkpoint = result
        self._touch_heartbeat()
        return result

    def load_state(self, input_dir: Optional[str] = None, **load_kwargs) -> None:
        """Restore the training state; with no ``input_dir``, the newest
        committed checkpoint under the project directory."""
        from .checkpointing import _resolve_for_load, load_accelerator_state, wait_for_async_saves

        wait_for_async_saves()  # a save still in flight may be the newest
        input_dir = _resolve_for_load(self, input_dir)
        for hook in self._load_state_pre_hooks:
            hook(self._models, input_dir)
        self._touch_heartbeat()
        load_accelerator_state(self, input_dir, **load_kwargs)
        self._touch_heartbeat()

    def resume_from_latest(self, input_dir: Optional[str] = None,
                           elastic: Optional[bool] = None) -> bool:
        """Load the newest committed checkpoint if there is one: True when
        state was restored, False on a first launch, so a script calls it
        unconditionally. Prepared loaders resume their mid-epoch position
        from the checkpoint (do not also ``skip_first_batches`` them). With
        automatic naming the next save goes past every checkpoint on disk.
        ``elastic`` (default ``ACCELERATE_ELASTIC``) loads a checkpoint
        saved by another number of processes (the tensors are whole, and
        are sharded again as this run's layout says; the loaders' positions
        are remapped to the new global batch).

        Several processes resume through consensus (``elastic.py``): every
        process gathers the others' views of the committed tree and all
        load the highest index every non-empty tree holds
        (``CheckpointDivergedError`` when their contents differ). When some
        process lacks it, all fetch it from the ``ReplicationConfig``'s
        replica together; with no checkpoint anywhere but a replica set,
        they restore its newest."""
        if elastic is None:
            elastic = _env_flag("ACCELERATE_ELASTIC")
        load_kwargs = {"elastic": True} if elastic else {}
        pc = self.project_configuration
        try:
            if input_dir is None and self.num_processes > 1 and pc.project_dir:
                self.load_state(self._consensus_checkpoint(), **load_kwargs)
            else:
                self.load_state(input_dir, **load_kwargs)
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

    def _consensus_checkpoint(self) -> str:
        """The checkpoint every process resumes from, present on each
        (``resume_from_latest`` with several processes). Raises
        ``CheckpointNotFoundError`` on a first launch."""
        from . import elastic
        from .utils.fault import CheckpointNotFoundError, ReplicaUnavailableError

        base = os.path.join(self.project_configuration.project_dir, "checkpoints")
        consensus = elastic.resolve_consensus_checkpoint(base)
        if consensus is None:
            # no process holds anything: a first launch, unless a replica
            # set exists (every local disk was lost)
            if self.replication_config is None:
                raise CheckpointNotFoundError(f"No checkpoints under {base} on any process")
            return elastic.ensure_local_checkpoint(self.replication_config, base)
        if not consensus.missing_ranks:
            return consensus.local_path
        # missing_ranks comes from the gathered views, the same on every
        # rank: the whole group enters the collective fetch, holders too
        if self.replication_config is None:
            raise ReplicaUnavailableError(
                f"process(es) {sorted(consensus.missing_ranks)} do not hold the consensus "
                f"checkpoint_{consensus.index} and no ReplicationConfig is active to fetch it")
        return elastic.ensure_local_checkpoint(
            self.replication_config, base, name=f"checkpoint_{consensus.index}",
            expected_digest=consensus.digest)

    def wait_for_async_saves(self) -> None:
        """Join in-flight async saves and run their commits."""
        from .checkpointing import wait_for_async_saves

        wait_for_async_saves()

    # ------------------------------------------------------------ replication
    def _get_replicator(self):
        if self.replication_config is None:
            return None
        if self._replicator is None:
            from .elastic import CheckpointReplicator

            self._replicator = CheckpointReplicator(self.replication_config)
        return self._replicator

    def _submit_replication(self, committed_dir: str) -> None:
        """After a commit (``checkpointing._commit_staged``, the main
        process): hand the checkpoint to the replicator. With
        ``async_replicate=False`` the mirror runs here and its failure
        raises out of ``save_state``; the checkpoint is committed either
        way."""
        if self.replication_config is None or not self.is_main_process:
            return
        self._get_replicator().submit(committed_dir)

    def wait_for_replication(self, timeout: Optional[float] = None) -> None:
        """Wait for every submitted mirror, then raise the first deferred
        failure (``end_training``, the preemption handler and interpreter
        exit call it)."""
        if self._replicator is not None:
            self._replicator.drain(timeout=timeout)

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
        """The model's whole tensors (detached; gathered from the shards
        under FSDP2, the layers restacked) under their checkpoint names."""
        from .checkpointing import full_model_tensors

        return full_model_tensors(model)

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
        if grads is not None and self.num_processes > 1:
            from .optimizer import local_tensor

            grads = tree_map(lambda g: local_tensor(g) if isinstance(g, torch.Tensor) else g, grads)
        summary = telemetry.health_summary(loss, grads, grad_norm)
        if self.num_processes > 1:
            # one verdict for every rank: each checked its own shards
            import torch.distributed as dist

            flags = summary[:2].clone()
            dist.all_reduce(flags, op=dist.ReduceOp.MIN)
            summary = torch.cat([flags, summary[2:]])
        step = self._health_seq
        self._health_seq += 1
        if cfg.sync:
            verdict = self._apply_health_verdict(telemetry.read_summary(summary, step))
            self._pw_note_train(1)
            return verdict
        if self._health_ring is None:
            self._health_ring = telemetry.DeferredReadbackRing(cfg.readback_depth)
        ok = True
        matured_n = 0
        for s, matured in self._health_ring.push((step, telemetry.start_readback(summary))):
            ok = self._apply_health_verdict(telemetry.read_summary(matured, s)) and ok
            matured_n += 1
        self._pw_note_train(matured_n)
        return ok

    def health_drain(self) -> bool:
        """Apply every verdict still on the deferred ring: True when every
        drained step was healthy (and in sync mode)."""
        from . import telemetry

        ok = True
        ring = self._health_ring
        if ring is None:
            return True
        with tracing.span("train.ring_drain", pending=len(ring)):
            while len(ring):
                # one at a time: a restore clears the ring (what is left
                # predates the reload)
                step, summary = ring.popleft()
                ok = self._apply_health_verdict(telemetry.read_summary(summary, step)) and ok
        return ok

    def _pw_note_train(self, verdicts: int) -> None:
        """Bill the time since the previous materialised health verdict to
        the training step (``perfwatch``): the verdicts' readback already
        waited for the card, so this adds a clock read and nothing else.
        ``verdicts == 0`` (the deferred ring still filling) leaves the
        window open."""
        if verdicts <= 0:
            return
        from . import perfwatch

        now = time.monotonic()
        mark, self._pw_mark = self._pw_mark, now
        if mark is None:
            return
        perfwatch.get_watch().record(f"train.{self._pw_variant()}/fused_train_step",
                                     (now - mark) / verdicts, calls=verdicts)

    def _pw_variant(self) -> str:
        """The program variant of this process's layout (dp<n>, fsdp<n>,
        tp<n>, hsdp<r>x<s>), as the JAX package names its baselines."""
        pc = self.parallelism_config
        r = getattr(pc, "dp_replicate_size", 1) or 1
        s = getattr(pc, "dp_shard_size", 1) or 1
        t = getattr(pc, "tp_size", 1) or 1
        if t > 1:
            return f"tp{t}"
        if r > 1 and s > 1:
            return f"hsdp{r}x{s}"
        if s > 1:
            return f"fsdp{s}"
        return f"dp{r}"

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
        """Commit in-flight async saves, drain the replicator (their commits
        feed it), apply pending health verdicts, and flush and finish the
        trackers; every step runs, and the first error is raised after
        them."""
        from .checkpointing import wait_for_async_saves

        try:
            wait_for_async_saves()
        finally:
            try:
                self.wait_for_replication()
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

    def _check_comm_hook(self) -> None:
        """Refuse a comm hook the layout cannot apply: PowerSGD (ROADMAP.md
        A11), and any compression without a cross-process reduction."""
        hook = self.ddp_handler.comm_hook if self.ddp_handler is not None else "no"
        if hook == "powersgd":
            raise NotImplementedError(
                "comm_hook='powersgd' compresses the cross-process gradient reduction; "
                "PowerSGD (ops/powersgd.py) waits for ROADMAP.md A11")
        if hook != "no" and self.layout == "none":
            raise NotImplementedError(
                f"comm_hook={hook!r}: the gradient-compression dtype applies to the "
                "cross-process reduction, and one process without a ParallelismConfig has "
                "none; launch several processes or pass parallelism_config=")

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
        self._check_comm_hook()
        model = model or self._models[-1]
        optimizer = optimizer or self._optimizers[-1]
        k = int(self.gradient_state.num_steps)
        state = {"count": 0}
        each_batch = self.gradient_state.plugin_kwargs.get("sync_each_batch", False)

        def step(*batch):
            state["count"] = state["count"] % k + 1
            sync = state["count"] == k
            self.gradient_state._set_sync_gradients(sync)
            # the host's dispatch (the kernels run on the card's stream),
            # sampled: one step in decode_sample_every
            with tracing.step_span("train.step_dispatch", getattr(optimizer, "_step_count", 0)):
                with contextlib.nullcontext() if sync or each_batch else self.no_sync(model):
                    loss, _ = _split_loss(loss_fn(model, *batch))
                    scale, loss_out = self._data_parallel_loss(loss_fn, loss, batch)
                    (loss * (scale * self._loss_scale() / k)).backward()
                if sync:
                    if max_grad_norm is not None:
                        optimizer.clip_grad_norm_(max_grad_norm)
                    optimizer.step()
                    optimizer.zero_grad()
            self._touch_heartbeat()
            return loss_out

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
