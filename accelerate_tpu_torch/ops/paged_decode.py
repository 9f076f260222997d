"""Paged flash-decode and fused sampling (counterpart of
``accelerate_tpu/ops/paged_decode.py``).

* :func:`paged_flash_decode` — one query token per slot over the paged KV
  pool. A CUDA tensor launches ``csrc/paged_decode.cu`` (replacing the
  Pallas ``_decode_kernel``), which walks each slot's block table inside
  the kernel and never touches the dead tail of the row; a CPU tensor runs
  the plain version, :func:`~accelerate_tpu_torch.ops.attention
  .paged_attention`, which gathers the whole table first.
* :func:`fused_sample` — temperature, top-k, top-p and the categorical draw
  in one kernel (``csrc/fused_sample.cu``, replacing ``_sample_kernel``),
  with the same tie rules and the same noise operand as
  :func:`fused_sample_reference`, so the two agree bitwise.
* :func:`paged_flash_verify` — the speculative-verify kernel — is not
  ported yet (slice 2) and raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build
from .attention import paged_attention

__all__ = [
    "paged_flash_decode",
    "paged_flash_verify",
    "fused_sample",
    "fused_sample_reference",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_flash_decode(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token paged decode attention. ``q`` (B, 1, H, D), pools
    (num_blocks, block_size, H_kv, D), ``block_tables`` (B, blocks_per_row)
    int32, ``pos`` (B,) int32; returns (B, 1, H, D). ``scale`` defaults to
    ``1/sqrt(D)``. Sliding windows are not supported (the engine refuses
    such configs)."""
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "the int8 pool branch (k_scale/v_scale) of paged_flash_decode is "
            "queued for slice 2 with kv_cache='paged_int8' (ROADMAP.md)"
        )
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"paged_flash_decode takes one query token, got {sq}")
    nb, bs, h_kv, d_pool = k_pool.shape
    if v_pool.shape != k_pool.shape or d_pool != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if h % h_kv != 0:
        raise ValueError(f"num heads {h} not divisible by kv heads {h_kv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(
            f"block_tables must be (B, blocks_per_row) and pos (B,), got "
            f"{tuple(block_tables.shape)} and {tuple(pos.shape)}"
        )
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention(q, k_pool, v_pool, block_tables, pos, scale=scale, softcap=softcap)
    tensors = (q, k_pool, v_pool, block_tables, pos)
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_flash_decode: all operands must be on one device")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"paged decode kernel takes float32 or bfloat16 q and pools of one "
            f"dtype, got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}"
        )
    if block_tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("block_tables and pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged decode kernel takes contiguous operands")
    if d not in (64, 128):
        raise ValueError(f"paged decode kernel supports head_dim 64 or 128, got {d}")
    if h // h_kv not in (1, 2, 4, 8):
        raise ValueError(f"paged decode kernel supports GQA groups of 1, 2, 4 or 8, got {h // h_kv}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if q.device.type != "cuda":
        raise ValueError(f"the paged decode kernel runs on CUDA tensors; got {q.device}")
    out = torch.empty_like(q)
    code = _build.entry("paged_decode", 6, 7, 2)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), b, h, h_kv, d, bs, block_tables.shape[1],
        _DTYPE_CODE[q.dtype], float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("paged_decode", code)
    _build.count_launch("paged_decode")
    return out


def paged_flash_verify(*args, **kwargs):
    """The W-token speculative-verify kernel (Pallas ``_verify_kernel``)."""
    raise NotImplementedError(
        "paged_flash_verify is not ported yet: it runs only with spec='ngram', "
        "which is queued for slice 2 (ROADMAP.md)"
    )


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map f32 -> uint32 (held in int64, since torch has
    no full uint32 arithmetic): positive floats flip the sign bit, negative
    floats flip every bit."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where((u >> 31) == 1, (~u) & 0xFFFFFFFF, u | 0x80000000)


def fused_sample_reference(
    logits: torch.Tensor,
    noise: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the fused sampling kernel, row-vectorised. The
    k-th largest value and the top-p cutoff come from 32-step binary
    searches over the float keys (no sort); the draw is the first argmax of
    ``filtered + noise``; greedy (temperature <= 0) the first argmax of the
    raw logits. Returns (S,) int32."""
    s, v = logits.shape
    x = logits.float()
    t = temperature.float()
    tk = top_k.long()
    tp = top_p.float()
    iota = torch.arange(v, device=x.device)
    neg_inf = torch.tensor(float("-inf"), device=x.device)

    m_raw = x.amax(dim=-1, keepdim=True)
    greedy = torch.where(x == m_raw, iota, v).amin(dim=-1)

    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    scaled = x / safe_t[:, None]
    key = _float_key(scaled)

    k_on = (tk > 0) & (tk < v)
    k_eff = tk.clamp(1, v)
    kkey = torch.zeros(s, dtype=torch.int64, device=x.device)
    for bit in range(31, -1, -1):
        cand = kkey | (1 << bit)
        cnt = (key >= cand[:, None]).sum(dim=-1)
        kkey = torch.where(cnt >= k_eff, cand, kkey)
    kth = torch.where(key == kkey[:, None], scaled, neg_inf).amax(dim=-1)
    keep_k = ~k_on[:, None] | (scaled >= kth[:, None])

    m_s = scaled.amax(dim=-1)
    e = torch.exp(scaled - m_s[:, None])
    gt = scaled > kth[:, None]
    cnt_gt = gt.sum(dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    z_k = torch.where(gt, e, zero).sum(dim=-1) + (k_eff - cnt_gt).float() * torch.exp(kth - m_s)
    z = torch.where(k_on, z_k, e.sum(dim=-1))
    p_on = tp < 1.0
    pz = torch.where(p_on, tp, torch.ones_like(tp)) * z
    u1 = torch.zeros(s, dtype=torch.int64, device=x.device)
    for bit in range(31, -1, -1):
        cand = u1 | (1 << bit)
        s_above = torch.where(key > cand[:, None], e, zero).sum(dim=-1)
        u1 = torch.where(s_above >= pz, cand, u1)
    s_at_u1 = torch.where(key > u1[:, None], e, zero).sum(dim=-1)
    u0 = torch.where(s_at_u1 >= pz, (u1 + 1) & 0xFFFFFFFF, u1)
    keep_p = ~p_on[:, None] | (key >= u0[:, None])

    final = torch.where(keep_k & keep_p, scaled, neg_inf)
    g = final + noise.float()
    m_g = g.amax(dim=-1, keepdim=True)
    sampled = torch.where(g == m_g, iota, v).amin(dim=-1)
    return torch.where(t > 0, sampled, greedy).to(torch.int32)


def fused_sample(
    logits: torch.Tensor,
    noise: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Fused sampling epilogue: ``logits``/``noise`` (S, V) f32,
    ``temperature``/``top_p`` (S,) f32, ``top_k`` (S,) int32 (0 or >= V is
    off; top_p >= 1 is off; temperature <= 0 is greedy). ``noise`` is the
    per-row Gumbel noise, so the draw is ``argmax(filtered + noise)``,
    exactly a categorical sample. Returns (S,) int32 token ids."""
    if logits.dim() != 2 or noise.shape != logits.shape:
        raise ValueError(f"logits and noise must be (S, V), got {tuple(logits.shape)} and {tuple(noise.shape)}")
    s, v = logits.shape
    if any(p.shape != (s,) for p in (temperature, top_k, top_p)):
        raise ValueError("temperature, top_k and top_p must be (S,)")
    if logits.device.type == "cpu":
        return fused_sample_reference(logits, noise, temperature, top_k, top_p)
    tensors = (logits, noise, temperature, top_k, top_p)
    if any(t.device != logits.device for t in tensors):
        raise ValueError("fused_sample: all operands must be on one device")
    if (logits.dtype, noise.dtype, temperature.dtype, top_p.dtype, top_k.dtype) != (
        torch.float32, torch.float32, torch.float32, torch.float32, torch.int32
    ):
        raise TypeError("fused sample kernel takes f32 logits/noise/temperature/top_p and int32 top_k")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused sample kernel takes contiguous operands")
    if logits.device.type != "cuda":
        raise ValueError(f"the fused sample kernel runs on CUDA tensors; got {logits.device}")
    out = torch.empty((s,), dtype=torch.int32, device=logits.device)
    code = _build.entry("fused_sample", 6, 2, 0)(
        logits.data_ptr(), noise.data_ptr(), temperature.data_ptr(), top_k.data_ptr(),
        top_p.data_ptr(), out.data_ptr(), s, v,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check("fused_sample", code)
    _build.count_launch("fused_sample")
    return out
