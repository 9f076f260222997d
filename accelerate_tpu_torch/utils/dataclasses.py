"""Config dataclasses of the port (counterpart of
``accelerate_tpu/utils/dataclasses.py``).

Training: the kwargs handlers a single-device ``Accelerator`` reads
(``GradientAccumulationPlugin``, ``GradScalerKwargs``,
``MixedPrecisionPolicy``, the ``DataLoaderConfiguration`` fields of
single-process batching, and ``DistributedDataParallelKwargs``, whose
gradient-compression hooks wait for the distributed slice).

Serving: only ``mode="continuous"`` is ported: the slot engine over a KV
backend, with the continuous-mode knobs and their validation, plus the
admission knobs the server reads (queue bound, default budget and
deadline, drain timeout). Static mode, retry/circuit breaker, the
degradation ladder, speculative decoding, chunked prefill and the host KV
tier are still to be ported (ROADMAP.md).
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
    even mid-window."""

    num_steps: int = 1
    sync_with_dataloader: bool = True

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
    """Dynamic loss scaling for fp16 (torch GradScaler's defaults)."""

    init_scale: float = 2.0**16
    growth_factor: float = 2.0
    backoff_factor: float = 0.5
    growth_interval: int = 2000


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
    * ``kv_cache``: ``"dense"`` (one max_len row per slot) or ``"paged"``
      (shared block pool + block tables + copy-on-write prefix cache).
      ``engine_block_size`` positions per block (must divide
      ``engine_max_len``); ``engine_pool_blocks`` sizes the pool (``None``:
      every slot's worst case + the null block).
    * ``attention_impl``: ``"reference"`` (plain PyTorch paged attention and
      sort-based sampling) or ``"kernel"`` (the hand-written paged
      flash-decode and fused-sampling kernels; the counterpart of the JAX
      package's ``"pallas"``). ``"kernel"`` needs ``kv_cache="paged"``.
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
        if self.kv_cache not in ("dense", "paged"):
            raise ValueError(
                f"kv_cache must be 'dense' or 'paged', got {self.kv_cache!r} "
                "('paged_int8' is queued in ROADMAP.md)"
            )
        if self.engine_block_size < 1:
            raise ValueError(
                f"engine_block_size must be >= 1, got {self.engine_block_size}"
            )
        if self.kv_cache == "paged" and self.engine_max_len % self.engine_block_size:
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
        if self.attention_impl == "kernel" and self.kv_cache != "paged":
            raise ValueError(
                "attention_impl='kernel' requires kv_cache='paged': the "
                "flash-decode kernel walks block tables, which the dense "
                "arena does not have"
            )
        if self.engine_pool_blocks is not None and self.engine_pool_blocks < 2:
            raise ValueError(
                "engine_pool_blocks must be None (full provisioning) or >= 2 "
                f"(block 0 is the reserved null block), got {self.engine_pool_blocks}"
            )
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.default_max_new_tokens < 1:
            raise ValueError(
                f"default_max_new_tokens must be >= 1, got {self.default_max_new_tokens}"
            )
        if self.drain_timeout_s < 0:
            raise ValueError(f"drain_timeout_s must be >= 0, got {self.drain_timeout_s}")
