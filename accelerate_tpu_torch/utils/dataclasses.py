"""Config dataclasses of the port (counterpart of
``accelerate_tpu/utils/dataclasses.py``).

Training: the kwargs handlers a single-device ``Accelerator`` reads
(``GradientAccumulationPlugin``, ``GradScalerKwargs``,
``MixedPrecisionPolicy``, the ``DataLoaderConfiguration`` fields of
single-process batching, and ``DistributedDataParallelKwargs``, whose
gradient-compression hooks wait for the distributed slice).

Serving: only ``mode="continuous"`` is ported: the slot engine over a KV
backend (dense, paged or the int8 paged pool), with speculative decoding
and chunked prefill, the continuous-mode knobs and their validation, plus
the admission knobs the server reads (queue bound, default budget and
deadline, drain timeout). Static mode, retry/circuit breaker, the
degradation ladder and the host KV tier are still to be ported
(ROADMAP.md).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = [
    "DataLoaderConfiguration",
    "DistributedDataParallelKwargs",
    "GradScalerKwargs",
    "GradientAccumulationPlugin",
    "KwargsHandler",
    "MixedPrecisionPolicy",
    "ServingConfig",
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
    even mid-window. ``adjust_scheduler`` steps a prepared scheduler once
    per update; ``prepare`` refuses schedulers until ``scheduler.py`` is
    ported (ROADMAP.md A4), so it has nothing to act on yet.
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
    """Gradient communication hooks: ``comm_hook`` ``"bf16"``/``"fp16"``
    (reduce gradients in a compressed dtype) or ``"powersgd"`` (low-rank
    compression). Both act on the cross-device reduction, so a single-device
    ``train_step`` refuses them until the distributed slice (ROADMAP.md A7)."""

    comm_hook: str = "no"  # "no" | "bf16" | "fp16" | "powersgd"

    def __post_init__(self):
        if self.comm_hook not in ("no", "bf16", "fp16", "powersgd"):
            raise ValueError(f"comm_hook must be no|bf16|fp16|powersgd, got {self.comm_hook}")


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
    ``output_dtype``. ``"bf16"`` is f32 params, bf16 compute, f32 outputs."""

    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    output_dtype: str = "float32"

    @classmethod
    def from_mixed_precision(cls, mixed_precision: str) -> "MixedPrecisionPolicy":
        if mixed_precision == "bf16":
            return cls(compute_dtype="bfloat16")
        if mixed_precision == "fp16":
            return cls(compute_dtype="float16")
        return cls()

    def cast_to_compute(self, tree):
        return _cast_floats(tree, getattr(torch, self.compute_dtype))

    def cast_to_output(self, tree):
        return _cast_floats(tree, getattr(torch, self.output_dtype))


@dataclass
class DataLoaderConfiguration(KwargsHandler):
    """The data-loader knobs of single-process batching: ``data_seed`` (the
    shuffling seed), ``non_blocking`` (copies from pinned host buffers
    overlap the step). Splitting and dispatching batches across processes
    wait for the distributed slice."""

    data_seed: Optional[int] = None
    non_blocking: bool = True


@dataclass
class ServingConfig:
    """Knobs of :class:`accelerate_tpu_torch.serving.InferenceServer`.

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
    """

    mode: str = "continuous"
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
    max_queue: int = 256
    default_max_new_tokens: int = 32
    default_deadline_s: Optional[float] = None
    drain_timeout_s: float = 30.0

    def __post_init__(self):
        if self.mode != "continuous":
            raise NotImplementedError(
                f"mode={self.mode!r}: only mode='continuous' is ported; the "
                "static generate() mode is queued in ROADMAP.md"
            )
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
        if self.engine_pool_blocks is not None and self.engine_pool_blocks < 2:
            raise ValueError(
                "engine_pool_blocks must be None (full provisioning) or >= 2 "
                f"(block 0 is the reserved null block), got {self.engine_pool_blocks}"
            )
        if self.speculative not in (None, "ngram"):
            raise ValueError(f"speculative must be None or 'ngram', got {self.speculative!r}")
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
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.default_max_new_tokens < 1:
            raise ValueError(
                f"default_max_new_tokens must be >= 1, got {self.default_max_new_tokens}"
            )
        if self.drain_timeout_s < 0:
            raise ValueError(f"drain_timeout_s must be >= 0, got {self.drain_timeout_s}")
