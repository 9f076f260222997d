"""Config dataclasses of the port (counterpart of
``accelerate_tpu/utils/dataclasses.py``).

Training: the kwargs handlers a single-device ``Accelerator`` reads
(``GradientAccumulationPlugin``, ``GradScalerKwargs``,
``MixedPrecisionPolicy``, ``DataLoaderConfiguration``,
``ProjectConfiguration`` for checkpoint and log directories,
``TrainingHealthConfig`` for the non-finite watchdog), and the
data-parallel ones (``DistributedDataParallelKwargs`` with its
gradient-compression hooks, ``FSDPPlugin``, and the
``PipelineParallelConfig`` a ``ParallelismConfig`` reads).

Serving: both modes are ported, with the JAX default ``mode="static"``:
static mode's batching and retry knobs; the continuous slot engine over a
KV backend (dense, paged or the int8 paged pool), with speculative
decoding and chunked prefill; the admission knobs the server reads (queue
bound, default budget and deadline, drain timeout), and JAX's validation.
``ServingConfig`` takes every field of the JAX one; the knobs of what is
still to be ported (the host KV tier, the circuit breaker, the
degradation ladder and periodic metrics) raise at a value other than
their default, naming their ROADMAP.md item.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = [
    "DataLoaderConfiguration",
    "DistributedDataParallelKwargs",
    "FSDPPlugin",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "KwargsHandler",
    "MixedPrecisionPolicy",
    "PipelineParallelConfig",
    "ProjectConfiguration",
    "ReplicationConfig",
    "ServingConfig",
    "TensorParallelConfig",
    "TrainingHealthConfig",
]


class KwargsHandler:
    """Base: the fields that differ from the defaults, as kwargs."""

    def to_dict(self) -> dict:
        return copy.deepcopy(self.__dict__)

    def to_kwargs(self) -> dict:
        default = self.__class__()
        return {k: v for k, v in self.to_dict().items() if getattr(default, k, None) != v}


@dataclass
class GradientAccumulationPlugin(KwargsHandler):
    """Gradient accumulation: ``num_steps`` micro-batches per update;
    ``sync_with_dataloader`` forces an update at the end of the data loader
    even mid-window. ``adjust_scheduler`` is kept for the JAX package's
    field set: there, as here, a prepared scheduler steps once per update
    whatever it says.
    ``sync_each_batch`` reduces gradients across devices on every
    micro-batch instead of deferring the reduction to the update; one
    device has no such reduction, so both settings run the same step."""

    num_steps: int = 1
    adjust_scheduler: bool = True
    sync_with_dataloader: bool = True
    sync_each_batch: bool = False

    def __post_init__(self):
        if self.num_steps < 1:
            raise ValueError(f"num_steps must be >= 1, got {self.num_steps}")


@dataclass
class DistributedDataParallelKwargs(KwargsHandler):
    """Gradient communication of the data-parallel dims, with the JAX
    package's fields. ``comm_hook="bf16"``/``"fp16"`` reduces gradients in
    that dtype: under ``dp_replicate`` alone as DDP's compress hook
    (``bf16_compress_hook``/``fp16_compress_hook``), under ``dp_shard`` as
    FSDP2's ``MixedPrecisionPolicy(reduce_dtype=...)``. ``"powersgd"``
    (low-rank compression, ``ops/powersgd.py`` in the JAX package) waits for
    ROADMAP.md A11; ``comm_wrapper`` and ``powersgd_rank`` are accepted as
    the JAX package accepts them (``comm_wrapper`` must stay ``"no"``).
    Passing this handler to a one-process ``Accelerator`` under a
    ``ParallelismConfig`` wraps the model in DDP even at world size 1."""

    comm_hook: str = "no"  # "no" | "bf16" | "fp16" | "powersgd"
    comm_wrapper: str = "no"
    powersgd_rank: int = 4

    def __post_init__(self):
        if self.comm_hook not in ("no", "bf16", "fp16", "powersgd"):
            raise ValueError(f"comm_hook must be no|bf16|fp16|powersgd, got {self.comm_hook}")
        if self.comm_wrapper != "no":
            raise ValueError("comm_wrapper variants wrap a low-rank reduction the port does not "
                             f"have; got {self.comm_wrapper!r}")
        if self.powersgd_rank < 1:
            raise ValueError(f"powersgd_rank must be >= 1, got {self.powersgd_rank}")

    @property
    def gradient_dtype(self):
        return {"bf16": torch.bfloat16, "fp16": torch.float16}.get(self.comm_hook)


@dataclass
class FSDPPlugin(KwargsHandler):
    """FSDP2 knobs, with the JAX package's fields. ``dp_shard`` shards with
    ``fully_shard``: a Llama per layer (each layer one unit, gathered just
    before it runs), then the root (embedding, final norm, head); another
    module per child whose parameters hold at least ``min_weight_size``
    elements, then the root. ``reshard_after_forward`` frees a unit's
    gathered weights after its forward (gathered again for the backward).
    ``activation_checkpointing`` recomputes each layer in the backward (the
    Llama's ``remat_policy`` already does). ``sharding_rules``: ``(regex,
    dim)`` pairs over the parameter paths, put in front of the tensor-
    parallel rules (and of a ``TensorParallelConfig``'s), as the JAX
    package puts its ``(regex, PartitionSpec)`` pairs; they place leaves
    over ``tp`` (``parallel/tp.py``), while FSDP2 shards every parameter on
    dim 0. ``cpu_offload`` and ``state_dict_type="sharded"`` have no FSDP2
    counterpart in the port: a checkpoint always holds full tensors, and a
    non-default value raises. Passing the plugin to a one-process
    ``Accelerator`` under a ``ParallelismConfig`` shards over a one-rank
    mesh."""

    min_weight_size: int = 2**10
    reshard_after_forward: bool = True
    cpu_offload: bool = False
    state_dict_type: str = "sharded"  # "sharded" | "full"
    activation_checkpointing: bool = False
    sharding_rules: Optional[list] = None

    def __post_init__(self):
        import os

        if os.environ.get("FSDP_MIN_WEIGHT_SIZE"):
            self.min_weight_size = int(os.environ["FSDP_MIN_WEIGHT_SIZE"])
        if os.environ.get("FSDP_ACTIVATION_CHECKPOINTING"):
            self.activation_checkpointing = os.environ["FSDP_ACTIVATION_CHECKPOINTING"].strip(
            ).lower() in ("1", "true", "yes", "on")
        if os.environ.get("FSDP_STATE_DICT_TYPE"):
            self.state_dict_type = os.environ["FSDP_STATE_DICT_TYPE"].lower()
        if self.state_dict_type not in ("sharded", "full"):
            raise ValueError(f"state_dict_type must be sharded|full, got {self.state_dict_type!r}")
        if self.cpu_offload:
            raise NotImplementedError("FSDPPlugin(cpu_offload=True): FSDP2's CPU offload is not "
                                      "ported (ROADMAP.md A11)")
        if self.sharding_rules:
            from ..parallel.tp import check_rules

            check_rules(self.sharding_rules)


@dataclass
class TensorParallelConfig(KwargsHandler):
    """Tensor-parallel knobs, with the JAX package's fields and defaults.
    ``sharding_rules``: ``(regex, dim)`` pairs over the parameter paths
    (``layers/attn/q_proj/kernel``; ``dim`` indexes the leaf as the
    checkpoint holds it, stacked ``(L, ...)`` layer leaves included, or is
    None for a replicated leaf), put in front of
    :func:`~accelerate_tpu_torch.parallel.tp.tensor_parallel_rules`. A rule
    that matches no parameter, or that places a leaf where the tensor-
    parallel forward does not run it, raises by name at ``prepare``.
    ``enable_async_tp`` is accepted as the JAX package accepts it (XLA
    overlaps its collectives itself): the port's collectives run in order
    on the training stream. Given to a ``ParallelismConfig`` at
    ``tp_size=1``, the model is laid out over a one-rank ``tp``."""

    tp_size: int = 1
    enable_async_tp: bool = False
    sharding_rules: Optional[list] = None

    def __post_init__(self):
        if self.tp_size < 1:
            raise ValueError(f"tp_size must be >= 1, got {self.tp_size}")
        if self.sharding_rules:
            from ..parallel.tp import check_rules

            check_rules(self.sharding_rules)


@dataclass
class PipelineParallelConfig(KwargsHandler):
    """The JAX package's pipeline knobs, which ``ParallelismConfig.from_env``
    reads; pipeline parallelism itself waits for ROADMAP.md A11."""

    num_microbatches: int = 4
    schedule: str = "1f1b"
    num_virtual_stages: int = 1

    def __post_init__(self):
        if self.schedule not in ("gpipe", "1f1b"):
            raise ValueError(f"Unknown pipeline schedule {self.schedule}")
        if self.num_virtual_stages < 1:
            raise ValueError("num_virtual_stages must be >= 1")
        if self.num_virtual_stages > 1 and self.schedule != "1f1b":
            raise ValueError("num_virtual_stages > 1 requires the 1f1b schedule")


@dataclass
class GradScalerKwargs(KwargsHandler):
    """Dynamic loss scaling for fp16 (torch GradScaler's defaults);
    ``enabled=False`` trains fp16 without loss scaling, as torch's
    GradScaler does (the JAX package accepts the field and scales anyway)."""

    init_scale: float = 2.0**16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000
    enabled: bool = True


def _cast_floats(tree, dtype):
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, _cast_floats(v, dtype)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    return tree


@dataclass
class MixedPrecisionPolicy(KwargsHandler):
    """Three-dtype policy: parameters stored in ``param_dtype``, cast to
    ``compute_dtype`` for the forward, float outputs cast to
    ``output_dtype``. ``"bf16"`` (and ``"fp8"``) is f32 params, bf16
    compute, f32 outputs."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"

    @classmethod
    def from_mixed_precision(cls, mixed_precision: str) -> "MixedPrecisionPolicy":
        if mixed_precision == "bf16":
            return cls(compute_dtype="bfloat16")
        if mixed_precision == "fp16":
            return cls(compute_dtype="float16")
        if mixed_precision == "fp8":
            # the products' operands are fp8 (ops/fp8.py); everything else,
            # and the products' outputs, in bf16
            return cls(compute_dtype="bfloat16")
        return cls()

    def cast_to_compute(self, tree):
        return _cast_floats(tree, getattr(torch, self.compute_dtype))

    def cast_to_output(self, tree):
        return _cast_floats(tree, getattr(torch, self.output_dtype))


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """Data-loader knobs (the JAX package's field set). ``split_batches``:
    a loader's batch size is the global one, split across processes;
    ``dispatch_batches``: the main process reads every batch and hands it
    out (:class:`~accelerate_tpu_torch.data_loader.DataLoaderDispatcher`);
    ``even_batches``: every process gets as many full batches, the tail
    refilled from the start; ``use_seedable_sampler``: a shuffling torch
    ``DataLoader`` is re-drawn from ``SeedableRandomSampler(data_seed)`` so
    a resumed epoch replays the same order; ``non_blocking``: copies from
    pinned host buffers overlap the step; ``use_stateful_dataloader`` is
    kept for the field set (every prepared loader has ``state_dict``)."""

    split_batches: bool = False
    dispatch_batches: Optional[bool] = None
    even_batches: bool = True
    use_seedable_sampler: bool = True
    data_seed: Optional[int] = None
    non_blocking: bool = True
    use_stateful_dataloader: bool = True


@dataclass
class ProjectConfiguration(KwargsHandler):
    """Checkpoint and log directory layout. ``automatic_checkpoint_naming``
    saves to ``<project_dir>/checkpoints/checkpoint_<iteration>``;
    ``total_limit`` keeps that many committed checkpoints, every
    ``checkpoint_keep_every``-th index exempt."""

    project_dir: Optional[str] = None
    logging_dir: Optional[str] = None
    automatic_checkpoint_naming: bool = False
    total_limit: Optional[int] = None
    iteration: int = 0
    save_on_each_node: bool = False
    checkpoint_keep_every: Optional[int] = None

    def set_directories(self, project_dir: Optional[str] = None):
        self.project_dir = project_dir
        if self.logging_dir is None:
            self.logging_dir = project_dir

    def __post_init__(self):
        if self.logging_dir is None:
            self.logging_dir = self.project_dir
        if self.checkpoint_keep_every is not None and self.checkpoint_keep_every <= 0:
            raise ValueError("checkpoint_keep_every must be a positive integer")


@dataclass
class TrainingHealthConfig(KwargsHandler):
    """Policy of ``Accelerator.check_step_health`` on a non-finite loss (or
    gradients, with ``check_grads``): ``"raise"`` a ``TrainingHealthError``,
    ``"skip"`` the step (drop the gradients) or ``"restore"`` the last
    committed checkpoint. ``max_bad_steps`` consecutive bad steps raise
    under any policy. ``sync=True`` reads each step's verdict back in its
    own call; ``sync=False`` reads the verdict of ``readback_depth`` calls
    earlier from a ring, so the host does not wait for the step it just
    launched (``Accelerator.health_drain`` applies what is left)."""

    nonfinite_policy: str = "raise"
    check_grads: bool = False
    max_bad_steps: int = 10
    sync: bool = True
    readback_depth: int = 2

    def __post_init__(self):
        if self.nonfinite_policy not in ("raise", "skip", "restore"):
            raise ValueError(
                f"nonfinite_policy must be raise|skip|restore, got {self.nonfinite_policy!r}"
            )
        if self.max_bad_steps <= 0:
            raise ValueError("max_bad_steps must be a positive integer")
        if self.readback_depth < 1:
            raise ValueError("readback_depth must be a positive integer")


@dataclass
class ReplicationConfig(KwargsHandler):
    """Checkpoint replication (``accelerate_tpu_torch/elastic.py``): after
    every atomic commit the main process hands the checkpoint to a
    replicator that mirrors it under ``target``, storage that outlives the
    host, verified against the manifest and retried with a doubling
    backoff. A host whose local tree is missing or fails its checksum
    restores from a replica, verified against the replica's own manifest
    first.

    * ``target``: the root of the replicas; ``copies`` independent copies
      live at ``target/r0/...``, ``target/r1/...``.
    * ``async_replicate``: mirror on a background thread (drained by
      ``end_training``, the preemption handler and interpreter exit);
      ``False`` mirrors inside ``save_state`` and raises its failure there.
    * ``max_retries`` / ``retry_backoff_s``: retries of one copy and the
      first backoff (doubled each retry).
    * ``verify``: what a staged replica must pass before its rename,
      ``"size"`` or ``"checksum"``.
    * ``keep``: keep the newest ``keep`` committed replicas a copy slot
      (``None``: all)."""

    target: str = ""
    copies: int = 1
    async_replicate: bool = True
    max_retries: int = 3
    retry_backoff_s: float = 0.25
    verify: str = "checksum"
    keep: Optional[int] = None

    def __post_init__(self):
        if not self.target:
            raise ValueError("ReplicationConfig.target must be a non-empty path")
        if self.copies < 1:
            raise ValueError("copies must be a positive integer")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        if self.verify not in ("size", "checksum"):
            raise ValueError(f"verify must be size|checksum, got {self.verify!r}")
        if self.keep is not None and self.keep < 1:
            raise ValueError("keep must be None or a positive integer")


# the ServingConfig fields of what is not ported yet, by ROADMAP.md item:
# the circuit breaker, the degradation ladder and periodic metrics (A10)
QUEUED_SERVING_FIELDS = dict.fromkeys(
    ("breaker_threshold", "breaker_reset_s", "degrade_queue_fraction", "degrade_hard_fraction",
     "degraded_max_new_tokens", "metrics_interval_s"), "A10")


@dataclass
class ServingConfig:
    """Knobs of :class:`accelerate_tpu_torch.serving.InferenceServer`.

    * ``mode``: ``"static"`` (the default, as in the JAX package) batches
      whole :func:`~accelerate_tpu_torch.inference.generate` calls at
      admission: up to ``max_batch_size`` requests that share a prompt
      length, a token budget and sampling parameters, gathered for up to
      ``batch_window_s``; with ``batch_bucket`` the rows are padded to a
      power of two, and the KV length to a multiple of
      ``pad_total_multiple``, so the program LRU sees few shapes. A failed
      batch is retried ``max_retries`` times after an exponential backoff
      (``retry_backoff_s`` doubling up to ``retry_backoff_max_s``, times
      ``1 + retry_jitter * U[0, 1)``). ``kv_cache`` picks ``generate``'s
      ``kv_backend`` (``engine_block_size`` its block). ``"continuous"``
      runs the slot engine: the ``engine_*`` knobs below, ``attention_impl``,
      ``speculative`` and ``engine_prefill_chunk`` need it.
    * ``engine_slots`` decode slots of ``engine_max_len`` positions each;
      prompts must fit ``engine_prompt_bucket`` (default ``engine_max_len //
      2``) and ``prompt + max_new_tokens <= engine_max_len``.
    * ``engine_readback_lag``: the engine reads a program's tokens back that
      many programs later (0 reads back every step, for deterministic
      tests).
    * ``kv_cache``: ``"dense"`` (one max_len row per slot), ``"paged"``
      (shared block pool + block tables + copy-on-write prefix cache) or
      ``"paged_int8"`` (the same pool in int8 with one f32 scale per
      position). ``engine_block_size`` positions per block (must divide
      ``engine_max_len``); ``engine_pool_blocks`` sizes the pool (``None``:
      every slot's worst case + the null block).
    * ``attention_impl``: ``"reference"`` (plain PyTorch paged attention and
      sort-based sampling) or ``"kernel"`` (the hand-written paged
      flash-decode, flash-verify and fused-sampling kernels; the
      counterpart of the JAX package's ``"pallas"``). ``"kernel"`` needs a
      paged ``kv_cache``.
    * ``speculative="ngram"``: prompt-lookup speculative decoding with up
      to ``spec_draft_len`` drafts per slot and step.
    * ``engine_prefill_chunk``: prompts longer than
      ``engine_prompt_bucket`` are admitted and prefilled in chunks of this
      many positions, one chunk per scheduler tick between decode steps.
    * ``kv_host_tier_bytes``: a host-RAM tier of that many bytes below the
      paged pool's cached blocks: evicted prefix blocks spill there and a
      chunked admission of their prefix restores them. ``kv_prefetch``
      starts a request's host-tier copies to the card at submit.
    * The JAX package's other fields are accepted at their default and
      raise otherwise (``QUEUED_SERVING_FIELDS`` names each one's item).
    """

    mode: str = "static"
    engine_slots: int = 8
    engine_max_len: int = 256
    engine_prompt_bucket: Optional[int] = None
    engine_readback_lag: int = 2
    kv_cache: str = "dense"
    engine_block_size: int = 16
    engine_pool_blocks: Optional[int] = None
    attention_impl: str = "reference"
    speculative: Optional[str] = None
    spec_draft_len: int = 4
    engine_prefill_chunk: Optional[int] = None
    kv_host_tier_bytes: int = 0
    kv_prefetch: bool = True
    max_queue: int = 256
    max_batch_size: int = 8
    batch_window_s: float = 0.002
    batch_bucket: bool = True
    pad_total_multiple: int = 64
    default_max_new_tokens: int = 32
    default_deadline_s: Optional[float] = None
    max_retries: int = 2
    retry_backoff_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    retry_jitter: float = 0.25
    breaker_threshold: int = 5
    breaker_reset_s: float = 5.0
    degrade_queue_fraction: float = 0.5
    degrade_hard_fraction: float = 0.8
    degraded_max_new_tokens: int = 16
    drain_timeout_s: float = 30.0
    metrics_interval_s: Optional[float] = None

    def __post_init__(self):
        for name, item in QUEUED_SERVING_FIELDS.items():
            default = type(self).__dataclass_fields__[name].default
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"ServingConfig({name}={getattr(self, name)!r}): not ported yet "
                    f"(ROADMAP.md {item}); leave it at {default!r}")
        if self.mode not in ("static", "continuous"):
            raise ValueError(f"mode must be 'static' or 'continuous', got {self.mode!r}")
        if self.engine_slots < 1:
            raise ValueError(f"engine_slots must be >= 1, got {self.engine_slots}")
        if self.engine_max_len < 2:
            raise ValueError(f"engine_max_len must be >= 2, got {self.engine_max_len}")
        if self.engine_prompt_bucket is not None and not (
            1 <= self.engine_prompt_bucket <= self.engine_max_len - 1
        ):
            raise ValueError(
                "engine_prompt_bucket must be in [1, engine_max_len-1], got "
                f"{self.engine_prompt_bucket} (engine_max_len={self.engine_max_len})"
            )
        if self.engine_readback_lag < 0:
            raise ValueError(
                f"engine_readback_lag must be >= 0, got {self.engine_readback_lag}"
            )
        if self.kv_cache not in ("dense", "paged", "paged_int8"):
            raise ValueError(
                f"kv_cache must be 'dense', 'paged' or 'paged_int8', got {self.kv_cache!r}"
            )
        if self.engine_block_size < 1:
            raise ValueError(
                f"engine_block_size must be >= 1, got {self.engine_block_size}"
            )
        if self.kv_cache != "dense" and self.engine_max_len % self.engine_block_size:
            raise ValueError(
                f"engine_max_len ({self.engine_max_len}) must be a multiple of "
                f"engine_block_size ({self.engine_block_size}) so a block table "
                "row covers the arena length exactly"
            )
        if self.attention_impl not in ("reference", "kernel"):
            raise ValueError(
                "attention_impl must be 'reference' or 'kernel', got "
                f"{self.attention_impl!r}"
            )
        if self.attention_impl == "kernel" and self.kv_cache == "dense":
            raise ValueError(
                "attention_impl='kernel' requires a paged KV cache (kv_cache="
                "'paged' or 'paged_int8'): the kernels walk block tables, which "
                "the dense arena does not have"
            )
        if self.attention_impl == "kernel" and self.mode != "continuous":
            raise ValueError(
                "attention_impl='kernel' requires mode='continuous' (the static "
                "generate() path has no paged decode hot loop to fuse)"
            )
        if self.engine_pool_blocks is not None and self.engine_pool_blocks < 2:
            raise ValueError(
                "engine_pool_blocks must be None (full provisioning) or >= 2 "
                f"(block 0 is the reserved null block), got {self.engine_pool_blocks}"
            )
        if self.speculative not in (None, "ngram"):
            raise ValueError(f"speculative must be None or 'ngram', got {self.speculative!r}")
        if self.speculative is not None and self.mode != "continuous":
            raise ValueError(
                "speculative decoding requires mode='continuous' (the static "
                "path has no slot engine to verify drafts in)"
            )
        if self.speculative is not None and self.spec_draft_len < 1:
            raise ValueError(
                f"spec_draft_len must be >= 1 when speculative is enabled, got {self.spec_draft_len}"
            )
        if self.engine_prefill_chunk is not None and not (
            1 <= self.engine_prefill_chunk <= self.engine_max_len - 1
        ):
            raise ValueError(
                "engine_prefill_chunk must be in [1, engine_max_len-1], got "
                f"{self.engine_prefill_chunk} (engine_max_len={self.engine_max_len})"
            )
        if self.engine_prefill_chunk is not None and self.mode != "continuous":
            raise ValueError(
                "engine_prefill_chunk requires mode='continuous' (chunked "
                "prefill is a slot-engine scheduling feature)"
            )
        if self.kv_host_tier_bytes < 0:
            raise ValueError(f"kv_host_tier_bytes must be >= 0, got {self.kv_host_tier_bytes}")
        if self.kv_host_tier_bytes > 0 and self.kv_cache not in ("paged", "paged_int8"):
            raise ValueError(
                "kv_host_tier_bytes requires a paged KV cache (the host tier spills and restores "
                "pool blocks, which the dense arena does not have)")
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_batch_size < 1:
            raise ValueError(f"max_batch_size must be >= 1, got {self.max_batch_size}")
        if self.batch_window_s < 0 or self.batch_window_s > 10:
            raise ValueError(f"batch_window_s must be in [0, 10], got {self.batch_window_s}")
        if self.pad_total_multiple < 1:
            raise ValueError(f"pad_total_multiple must be >= 1, got {self.pad_total_multiple}")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.retry_backoff_s < 0 or self.retry_backoff_max_s < self.retry_backoff_s:
            raise ValueError(
                "retry backoff must satisfy 0 <= retry_backoff_s <= retry_backoff_max_s, got "
                f"{self.retry_backoff_s}/{self.retry_backoff_max_s}"
            )
        if not 0 <= self.retry_jitter <= 1:
            raise ValueError(f"retry_jitter must be in [0, 1], got {self.retry_jitter}")
        if self.default_max_new_tokens < 1:
            raise ValueError(
                f"default_max_new_tokens must be >= 1, got {self.default_max_new_tokens}"
            )
        if self.drain_timeout_s < 0:
            raise ValueError(f"drain_timeout_s must be >= 0, got {self.drain_timeout_s}")
