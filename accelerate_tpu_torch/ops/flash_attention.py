"""Flash attention, forward and backward (counterpart of
``accelerate_tpu/ops/flash_attention.py``).

* :func:`flash_attention_reference` and :func:`flash_attention_bwd_reference`
  are the plain PyTorch versions: scores materialised in f32, the kernels'
  masking rules, and for the backward the kernels' recompute math
  (``p = exp(s - lse)``, ``ds = p * (dp - delta)``) with their casts.
* :func:`flash_attention_with_lse` / :func:`flash_attention` are the kernel
  wrappers, differentiable through :class:`_FlashAttention` (the
  ``jax.custom_vjp`` of ``_flash_core`` / ``_flash_core_lse``). A CUDA
  tensor launches the hand-written kernels (``csrc/flash_fwd.cu`` for the
  forward, ``csrc/flash_bwd.cu`` for dq and for dk/dv) or raises; a CPU
  tensor runs the plain versions. Each kernel has two variants, chosen
  from the dtype by :func:`flash_fwd_kernel_for` and
  :func:`flash_bwd_kernel_for`: ``flash_fwd_mma``, ``flash_bwd_dq_mma`` and
  ``flash_bwd_dkv_mma`` (bf16, the products on the tensor cores), and
  ``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` (f32, FMA loops).

Layout (B, S, H, D) for q/out/do, (B, S, H_kv, D) for k/v, lse (B, H, Sq)
f32. ``segment_ids`` (B, Sq) / ``kv_segment_ids`` (B, Skv) are packed-
sequence document labels: a score is masked where the labels differ. The
kernels mask a ragged sequence edge themselves, so unlike the Pallas
kernels any S works.

``delta = rowsum(out * do) - dlse`` is computed here in PyTorch before the
two backward kernels, as the JAX package computes it with ``jnp`` outside
its kernels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF

__all__ = [
    "flash_attention",
    "flash_bwd_kernel_for",
    "flash_fwd_block_q",
    "flash_fwd_kernel_for",
    "flash_attention_with_lse",
    "flash_attention_reference",
    "flash_attention_bwd_reference",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _visible(sq, skv, causal, window, segment_ids, kv_segment_ids, device):
    """Boolean visibility broadcastable to grouped scores (B, Hkv, n_rep,
    Sq, Skv), or None when nothing is masked: causal ``q >= k``, then the
    window ``q - k < window`` (which implies the causal bound), then equal
    segment labels (``_mask_scores``)."""
    vis = None
    if causal or window is not None:
        q_pos = torch.arange(sq, device=device)[:, None]
        k_pos = torch.arange(skv, device=device)[None, :]
        vis = q_pos >= k_pos
        if window is not None:
            vis = vis & (q_pos - k_pos < window)
    if segment_ids is not None:
        same = (segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None, None]
        vis = same if vis is None else vis & same
    return vis


def _grouped_scores(q, k, softcap):
    """f32 scores (B, Hkv, n_rep, Sq, Skv) after the softcap, and the tanh
    term the backward needs (None without a softcap)."""
    b, sq, h, d = q.shape
    h_kv = k.shape[2]
    qg = q.reshape(b, sq, h_kv, h // h_kv, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (1.0 / math.sqrt(d))
    if softcap is None:
        return s, None
    t = torch.tanh(s / softcap)
    return softcap * t, t


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward: the same masks in the same order
    (softcap, then causal, window and segments), f32 scores, P rounded to
    v's dtype before an f32 P·V (as the TPU kernel rounds it; ``l`` sums
    the unrounded P), and the per-row ``lse = m + log(l)``. Returns ``(out
    (B, Sq, H, D), lse (B, H, Sq) f32)``. Differentiable by autograd."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    s, _ = _grouped_scores(q, k, softcap)
    vis = _visible(sq, skv, causal, window, segment_ids, kv_segment_ids, q.device)
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    p_lo = p.to(v.dtype).float()
    out = torch.einsum("bgrqk,bkgd->bqgrd", p_lo, v.float()) / l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out.reshape(b, sq, h, d).to(q.dtype), lse


def _delta(out, do, dlse):
    """``rowsum(out * do)`` in f32 as (B, H, Sq), minus the lse cotangent:
    an lse cotangent adds ``dlse_i * p_ij`` to ``ds_ij``, which folds into
    ``ds = p * (dp - delta)`` as ``delta -= dlse``."""
    delta = (out.float() * do.float()).sum(dim=-1).transpose(1, 2)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels (B2 dq, B3 dk/dv): the
    recompute math, not autograd. ``p = exp(s - lse)`` from the saved lse,
    ``dp = do · vᵀ``, ``ds = p * (dp - delta)`` (times ``1 - t²`` under a
    softcap); ``p`` is rounded to ``do``'s dtype before ``dv = pᵀ · do`` and
    ``ds`` to q/k's dtype before ``dq = ds · k`` and ``dk = dsᵀ · q`` (both
    scaled by ``1/sqrt(D)``), as the Pallas kernels round them. Sums run in
    f32; dk/dv sum over each kv head's group of q heads."""
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    n_rep = h // h_kv
    scale = 1.0 / math.sqrt(d)
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    s, t = _grouped_scores(q, k, softcap)
    vis = _visible(sq, skv, causal, window, segment_ids, kv_segment_ids, q.device)
    if vis is not None:
        s = torch.where(vis, s, NEG_INF)
    p = torch.exp(s - lse.reshape(b, h_kv, n_rep, sq)[..., None])
    delta = _delta(out, do, dlse).reshape(b, h_kv, n_rep, sq)
    dog = do.reshape(b, sq, h_kv, n_rep, d).float()
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, v.float())
    ds = p * (dp - delta[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    p_lo = p.to(do.dtype).float()
    ds_lo = ds.to(q.dtype).float()
    qg = q.reshape(b, sq, h_kv, n_rep, d).float()
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p_lo, dog)
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds_lo, qg) * scale
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds_lo, k.float()) * scale
    return dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_inputs(q, k, v, segment_ids, kv_segment_ids):
    _build.refuse_dtensor("flash attention", q, k, v, segment_ids, kv_segment_ids)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"num heads {q.shape[2]} not divisible by kv heads {k.shape[2]}")
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError("kv_segment_ids needs segment_ids (the q rows' labels)")
    for name, seg, s in (("segment_ids", segment_ids, q.shape[1]),
                         ("kv_segment_ids", kv_segment_ids, k.shape[1])):
        if seg is None:
            continue
        if seg.shape != (q.shape[0], s) or seg.dtype.is_floating_point or seg.dtype == torch.bool:
            raise ValueError(
                f"{name} must be integer labels of shape {(q.shape[0], s)}, got "
                f"{seg.dtype} {tuple(seg.shape)}"
            )
        if seg.device != q.device:
            raise ValueError(f"{name} is on {seg.device}, q on {q.device}")


def _check_launch(q, k, v, extra=()):
    if not all(t.device == q.device for t in (k, v, *extra)):
        raise ValueError("flash attention: all operands must be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernels take float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernels take contiguous (B, S, H, D) tensors")
    if q.shape[3] not in (64, 128):
        raise ValueError(f"flash kernels support head_dim 64 or 128, got {q.shape[3]}")
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernels run on CUDA tensors; got {q.device}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash kernels take 16-byte aligned q, k and v (16-byte copies)")


def _check_options(window, softcap):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")


def _seg_ptr(seg):
    return None if seg is None else seg.data_ptr()


def flash_fwd_kernel_for(dtype: torch.dtype) -> str:
    """The forward kernel (its C entry point and launch counter) that serves
    q/k/v of ``dtype``: ``flash_fwd_mma`` for bf16, whose products run on the
    tensor cores, and ``flash_fwd`` for f32, which keeps f32 products (FMA
    loops; TF32 would be another function)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {dtype}")
    return "flash_fwd_mma" if dtype == torch.bfloat16 else "flash_fwd"


def flash_bwd_kernel_for(dtype: torch.dtype) -> Tuple[str, str]:
    """The backward kernels (dq, then dk/dv; their C entry points and launch
    counters) that serve q/k/v of ``dtype``: ``flash_bwd_dq_mma`` and
    ``flash_bwd_dkv_mma`` for bf16, whose products run on the tensor cores,
    and ``flash_bwd_dq`` and ``flash_bwd_dkv`` for f32 (FMA loops)."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16:
        return "flash_bwd_dq_mma", "flash_bwd_dkv_mma"
    return "flash_bwd_dq", "flash_bwd_dkv"


def flash_fwd_block_q(b: int, h: int, sq: int) -> int:
    """q rows per block of ``flash_fwd_mma``: 128 (32 rows a warp, so each
    K/V fragment feeds two row tiles) where that still gives
    ``_build.FILL_BLOCKS`` blocks, else 64 (serving's B=1 S=512 prefill: 256
    blocks, not 128 on 132 SMs)."""
    return 128 if b * h * -(-sq // 128) >= _build.FILL_BLOCKS else 64


def _launch_fwd(q, k, v, q_seg, kv_seg, causal, window, softcap):
    _check_launch(q, k, v)
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    name = flash_fwd_kernel_for(q.dtype)
    dims = [b, sq, skv, h, h_kv, d, int(bool(causal)), int(window or 0)]
    if name == "flash_fwd_mma":
        dims.append(flash_fwd_block_q(b, h, sq))
    code = _build.entry(name, 7, len(dims), 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        _seg_ptr(q_seg), _seg_ptr(kv_seg), *dims, float(softcap or 0.0), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(name, code)
    _build.count_launch(name)
    return out, lse


def _bwd_launch_args(q, k, v, do, lse, delta, q_seg, kv_seg, causal, window, name):
    """Checked pointers and the integer dimensions of backward kernel
    ``name``: the FMA kernels also take the dtype code."""
    _check_launch(q, k, v, (do, lse, delta))
    if do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous():
        raise ValueError(f"do must be a contiguous {q.dtype} {tuple(q.shape)}, got "
                         f"{do.dtype} {tuple(do.shape)}")
    if do.data_ptr() % 16:
        raise ValueError("flash kernels take a 16-byte aligned do (16-byte copies)")
    b, sq, h, d = q.shape
    for arg, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{arg} must be a contiguous float32 {(b, h, sq)}")
    if name.endswith("_mma") and q.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bfloat16 q/k/v, got {q.dtype}")
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           delta.data_ptr(), _seg_ptr(q_seg), _seg_ptr(kv_seg))
    dims = [b, sq, k.shape[1], h, k.shape[2], d]
    if not name.endswith("_mma"):
        dims.append(_DTYPE_CODE[q.dtype])
    dims += [int(bool(causal)), int(window or 0)]
    return ins, dims


def _launch_bwd_dq(q, k, v, do, lse, delta, q_seg, kv_seg, causal, window, softcap):
    """Kernel B2: dq from the saved lse and the precomputed delta, by the
    variant :func:`flash_bwd_kernel_for` names for q's dtype."""
    name = flash_bwd_kernel_for(q.dtype)[0]
    ins, dims = _bwd_launch_args(q, k, v, do, lse, delta, q_seg, kv_seg, causal, window,
                                  name)
    dq = torch.empty_like(q)
    code = _build.entry(name, 9, len(dims), 2)(
        *ins, dq.data_ptr(), *dims, float(softcap or 0.0), 1.0 / math.sqrt(q.shape[3]),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, code)
    _build.count_launch(name)
    return dq


def _launch_bwd_dkv(q, k, v, do, lse, delta, q_seg, kv_seg, causal, window, softcap):
    """Kernel B3: dk and dv, each kv head summed over its group of q heads,
    by the variant :func:`flash_bwd_kernel_for` names for q's dtype."""
    name = flash_bwd_kernel_for(q.dtype)[1]
    ins, dims = _bwd_launch_args(q, k, v, do, lse, delta, q_seg, kv_seg, causal, window,
                                  name)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    code = _build.entry(name, 10, len(dims), 2)(
        *ins, dk.data_ptr(), dv.data_ptr(), *dims, float(softcap or 0.0),
        1.0 / math.sqrt(q.shape[3]), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(name, code)
    _build.count_launch(name)
    return dk, dv


def _launch_bwd(q, k, v, out, lse, do, q_seg, kv_seg, causal, window, softcap, dlse):
    do = do.contiguous()
    delta = _delta(out, do, dlse)
    opts = (q_seg, kv_seg, causal, window, softcap)
    dq = _launch_bwd_dq(q, k, v, do, lse, delta, *opts)
    dk, dv = _launch_bwd_dkv(q, k, v, do, lse, delta, *opts)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward B1, backward B2 + B3 (the custom VJP of ``_flash_core_lse``):
    the forward saves ``q, k, v, out, lse``; the backward takes cotangents
    of both ``out`` and ``lse`` (the latter folded into ``delta``). CPU
    tensors run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, window, softcap):
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(
                q, k, v, causal=causal, window=window, softcap=softcap,
                segment_ids=q_seg, kv_segment_ids=kv_seg)
        else:
            out, lse = _launch_fwd(q, k, v, q_seg, kv_seg, causal, window, softcap)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.opts = (causal, window, softcap)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        causal, window, softcap = ctx.opts
        if dout is None:
            dout = torch.zeros_like(out)
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, out, lse, dout, causal=causal, window=window, softcap=softcap,
                segment_ids=q_seg, kv_segment_ids=kv_seg, dlse=dlse)
        else:
            dq, dk, dv = _launch_bwd(q, k, v, out, lse, dout, q_seg, kv_seg,
                                     causal, window, softcap, dlse)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Sq, H, D) x (B, Skv, H_kv, D) flash attention returning ``(out,
    lse (B, H, Sq) f32)``, differentiable in both outputs. q and kv lengths
    may differ; ``causal`` anchors both at position 0. ``segment_ids``
    labels the q rows and, unless ``kv_segment_ids`` is given, the kv rows
    too."""
    _check_inputs(q, k, v, segment_ids, kv_segment_ids)
    _check_options(window, softcap)
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg = segment_ids.to(torch.int32).contiguous()
        kv_seg = (q_seg if kv_segment_ids is None
                  else kv_segment_ids.to(torch.int32).contiguous())
    return _FlashAttention.apply(q, k, v, q_seg, kv_seg, bool(causal), window, softcap)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """(B, S, H, D) flash attention; GQA by passing fewer kv heads (shared
    across the group in the kernels, never repeated); ``window`` is the
    Mistral sliding window, whose out-of-window kv tiles the kernels skip;
    ``segment_ids`` (B, S) keep attention inside each packed document."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"flash_attention needs equal q/kv lengths, got {q.shape[1]} and "
            f"{k.shape[1]} (use flash_attention_with_lse)"
        )
    out, _ = flash_attention_with_lse(
        q, k, v, causal=causal, segment_ids=segment_ids, window=window, softcap=softcap
    )
    return out
