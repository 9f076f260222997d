"""Config dataclasses of the port (counterpart of the ``ServingConfig`` in
``accelerate_tpu/utils/dataclasses.py``).

Only ``mode="continuous"`` is ported: the slot engine over a KV backend,
with the continuous-mode knobs and their validation, plus the admission
knobs the server reads (queue bound, default budget and deadline, drain
timeout). Static mode, retry/circuit breaker, the degradation ladder,
speculative decoding, chunked prefill and the host KV tier are still to
be ported (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

__all__ = ["ServingConfig"]


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
