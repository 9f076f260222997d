"""Attention implementations in plain PyTorch, and dispatch (counterpart
of ``accelerate_tpu/ops/attention.py``).

Layouts as in the JAX package: q/k/v are (batch, seq, heads, head_dim);
GQA is n_kv_heads < n_heads. Numerics contract (G402): scores and the
P·V product accumulate in float32 whatever the storage dtype; masks use
the finite ``NEG_INF`` so a fully masked block softmaxes to exact zeros
instead of NaN.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = [
    "NEG_INF",
    "tanh_softcap",
    "repeat_kv",
    "dot_product_attention",
    "blockwise_attention",
    "paged_attention",
    "verify_attention",
    "dispatch_attention",
]

# Finite mask value: exp(-1e6 - m) underflows to exactly 0 for any real
# score m, and a row of all -1e6 stays finite (no inf - inf NaNs).
NEG_INF = -1.0e6


def tanh_softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit capping ``cap * tanh(x / cap)``; identity for None."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*n_rep, D) for grouped-query attention."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _grouped_scores(q, k, softmax_dtype=torch.float32):
    """(B, Sq, H, D) x (B, Sk, Hkv, D) -> f32 scores (B, Hkv, n_rep, Sq, Sk),
    each kv head broadcast over its n_rep query heads (never repeated)."""
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    qg = q.reshape(b, sq, h_kv, h // h_kv, d).to(softmax_dtype)
    return torch.einsum("bqgrd,bkgd->bgrqk", qg, k.to(softmax_dtype))


def _grouped_pv(weights, v, out_shape):
    """f32 P·V of grouped weights (B, Hkv, n_rep, Sq, Sk) and v (B, Sk, Hkv,
    D); weights are rounded to v's dtype first, as the JAX einsum does."""
    w = weights.to(v.dtype).to(torch.float32)
    out = torch.einsum("bgrqk,bkgd->bqgrd", w, v.to(torch.float32))
    return out.to(v.dtype).reshape(out_shape)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference attention with fully materialised scores. ``window`` is the
    Mistral convention ``0 <= q_pos - k_pos < window``; ``softcap`` caps the
    scores before any mask; ``segment_ids`` (B, S) mask scores across packed
    documents."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    scores = _grouped_scores(q, k) * (1.0 / math.sqrt(d))
    scores = tanh_softcap(scores, softcap)
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(sk, device=q.device)[None, :]
    if causal:
        # additive bias, as _causal_mask_bias adds it
        bias = torch.where(q_pos >= k_pos, 0.0, NEG_INF).to(torch.float32)
        scores = scores + bias
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]  # (b, sq, sk)
        scores = torch.where(same[:, None, None], scores, NEG_INF)
    if window is not None:
        diff = q_pos - k_pos
        scores = torch.where((diff >= 0) & (diff < window), scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return _grouped_pv(weights, v, (b, sq, h, d))


def _attend_block(q, k, v, bias, softcap=None):
    """One kv block's unnormalised contribution with its row max and row
    sum-exp; ``q`` arrives pre-scaled, k/v already head-repeated."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = tanh_softcap(scores, softcap)
    if bias is not None:
        scores = scores + bias
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float()).to(v.dtype)
    return out, m, l


def _combine_blocks(out_a, m_a, l_a, out_b, m_b, l_b):
    """Online-softmax merge of two partial results (flash merge rule)."""
    m_new = torch.maximum(m_a, m_b)
    alpha = torch.exp(m_a - m_new)
    beta = torch.exp(m_b - m_new)
    l_new = alpha * l_a + beta * l_b
    a_f = alpha.transpose(1, 2)[..., None].to(out_a.dtype)
    b_f = beta.transpose(1, 2)[..., None].to(out_b.dtype)
    return out_a * a_f + out_b * b_f, m_new, l_new


def blockwise_attention(
    q, k, v, *, causal: bool = True, kv_block: int = 512, q_offset: int = 0,
    window: Optional[int] = None, softcap: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Memory-efficient attention: a loop over kv blocks with online
    softmax (the single-device form of the ring-attention math).
    ``segment_ids`` (B, S) mask scores across packed documents; padding
    past the sequence end gets label -1, which matches no token."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    n_rep = h // k.shape[2]
    k = repeat_kv(k, n_rep)
    v = repeat_kv(v, n_rep)
    q = q * (1.0 / math.sqrt(d))
    out = torch.zeros((b, sq, h, d), dtype=q.dtype, device=q.device)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    q_pos = torch.arange(sq, device=q.device)[:, None] + q_offset
    if segment_ids is not None:
        n_blocks = -(-skv // kv_block)
        kv_segs = torch.nn.functional.pad(segment_ids, (0, n_blocks * kv_block - skv), value=-1)
    for start in range(0, skv, kv_block):
        kv_pos = torch.arange(start, start + kv_block, device=q.device)[None, :]
        bias = torch.where(kv_pos < skv, 0.0, NEG_INF)
        if causal:
            bias = torch.where(q_pos >= kv_pos, bias, NEG_INF)
        if window is not None:
            diff = q_pos - kv_pos
            bias = torch.where((diff >= 0) & (diff < window), bias, NEG_INF)
        bias = bias.to(torch.float32)[None, None]
        if segment_ids is not None:
            same = segment_ids[:, :, None] == kv_segs[:, None, start:start + kv_block]
            bias = torch.where(same[:, None], bias, NEG_INF)
        k_blk = k[:, start:start + kv_block]
        v_blk = v[:, start:start + kv_block]
        pad = kv_block - k_blk.shape[1]
        if pad:
            k_blk = torch.nn.functional.pad(k_blk, (0, 0, 0, 0, 0, pad))
            v_blk = torch.nn.functional.pad(v_blk, (0, 0, 0, 0, 0, pad))
        o_b, m_b, l_b = _attend_block(q, k_blk, v_blk, bias, softcap=softcap)
        out, m, l = _combine_blocks(out, m, l, o_b, m_b, l_b)
    denom = l.transpose(1, 2)[..., None]
    return out / torch.clamp(denom, min=1e-30).to(out.dtype)


def _gather_pool(pool, block_tables, pool_scale=None):
    """(num_blocks, bs, Hkv, D) pool -> (B, bpr * bs, Hkv, D) per-row dense
    context by the block tables; an int8 pool is dequantized in f32 by its
    per-(block, position) ``pool_scale`` (num_blocks, bs)."""
    tables = block_tables.long()
    x = pool[tables]  # (B, bpr, bs, Hkv, D)
    b, bpr, bs = x.shape[:3]
    x = x.reshape(b, bpr * bs, *x.shape[3:])
    if pool_scale is not None:
        x = x.float() * pool_scale[tables].reshape(b, bpr * bs)[:, :, None, None]
    return x


def _write_window(dense, kv, pos):
    """Write a (B, W, Hkv, D) window ``kv`` into a per-row dense context
    (B, S, Hkv, D) at ``pos[b] .. pos[b]+W-1``, in place; positions past
    ``S`` are dropped, never clamped onto live columns."""
    idx = pos.long()[:, None] + torch.arange(kv.shape[1], device=dense.device)[None, :]
    rows, cols = torch.nonzero(idx < dense.shape[1], as_tuple=True)
    dense[rows, idx[rows, cols]] = kv[rows, cols].to(dense.dtype)
    return dense


def _window_attention(q, k, v, pos, scale, softcap):
    """Grouped attention of a W-query window at absolute positions ``pos +
    q_idx`` over a per-row dense context (B, Sk, Hkv, D): keys at ``k_pos <=
    pos + q_idx`` attend, the rest get ``NEG_INF``. Softcap before the mask;
    f32 scores and P·V, weights rounded to v's dtype first."""
    b, w, h, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    scores = _grouped_scores(q, k) * scale  # (B, Hkv, n_rep, W, Sk)
    scores = tanh_softcap(scores, softcap)
    k_pos = torch.arange(k.shape[1], device=q.device)
    q_idx = torch.arange(w, device=q.device)
    live = k_pos[None, None, :] <= pos.long()[:, None, None] + q_idx[None, :, None]  # (B, W, Sk)
    scores = torch.where(live[:, None, None], scores, NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return _grouped_pv(weights, v, (b, w, h, d))


def paged_attention(
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
    """Single-token decode attention over a paged KV pool: the reference
    semantics (and kernel contract) of the paged decode path.

    ``q`` (B, 1, H, D) (a W-query window: :func:`verify_attention`);
    ``k_pool``/``v_pool`` (num_blocks, block_size, Hkv,
    D), int8 with ``k_scale``/``v_scale`` (num_blocks, block_size) f32
    per-position scales, dequantized here in f32 after the gather;
    ``block_tables`` (B, blocks_per_row) int32, released rows pointing at
    the null block 0; ``pos`` (B,) int32, keys strictly after it masked.
    The gather materialises each row's whole table (live or not); masked
    scores hit ``NEG_INF`` and softmax to exact zeros, so recycled block
    content never leaks. ``scale`` defaults to ``1/sqrt(D)``."""
    k = _gather_pool(k_pool, block_tables, k_scale)
    v = _gather_pool(v_pool, block_tables, v_scale)
    return _window_attention(q, k, v, pos, scale, softcap)


def verify_attention(
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
    """Speculative-verify attention over a paged KV pool: as
    :func:`paged_attention` with a W-token window ``q`` (B, W, H, D) whose
    query j sits at ``pos[b] + j`` and attends ``k_pos <= pos + j``. The
    window's own K/V must already be in the pool positions it attends (the
    kernel's plain version writes them into a copy first). Queries past a
    row's real draft produce rows the caller discards; their keys lie after
    every valid query's causal horizon."""
    return paged_attention(q, k_pool, v_pool, block_tables, pos, k_scale=k_scale,
                           v_scale=v_scale, scale=scale, softcap=softcap)


def dispatch_attention(
    impl: str,
    q,
    k,
    v,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_block: int = 512,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
):
    """Select the attention implementation by name: ``"flash"`` (the flash
    kernel wrapper; its plain version on the CPU), ``"blockwise"`` or
    ``"xla"`` (the materialised reference; the name is kept from the JAX
    package). Flash with a shifted q block (``q_offset != 0``) or without a
    causal mask falls back to blockwise, as in the JAX package: the kernel
    anchors its causal mask at position 0. ``segment_ids`` (B, S) keep
    attention inside each packed document on every path."""
    if impl not in ("flash", "blockwise", "xla"):
        raise ValueError(
            f"unknown attention impl {impl!r}; expected 'flash', 'blockwise', or 'xla'"
        )
    if impl == "flash" and q_offset == 0 and causal:
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=True, window=window, softcap=softcap,
                               segment_ids=segment_ids)
    if impl in ("blockwise", "flash"):
        return blockwise_attention(
            q, k, v, causal=causal, kv_block=kv_block, q_offset=q_offset,
            window=window, softcap=softcap, segment_ids=segment_ids,
        )
    return dot_product_attention(
        q, k, v, causal=causal, q_offset=q_offset, window=window, softcap=softcap,
        segment_ids=segment_ids,
    )
