"""Flash attention forward (counterpart of
``accelerate_tpu/ops/flash_attention.py``).

* :func:`flash_attention_reference` is the plain PyTorch version: scores
  materialised in f32, the kernel's masking rules, ``(out, lse)``.
* :func:`flash_attention_with_lse` / :func:`flash_attention` are the kernel
  wrappers. A CUDA tensor launches the hand-written kernel
  (``csrc/flash_fwd.cu``, replacing the Pallas ``_fwd_kernel``) or raises;
  a CPU tensor runs the plain version. Forward only: the backward kernels
  (dq, dk/dv) belong to the training slice, so an input that requires grad
  is refused, and so are ``segment_ids`` (the packing slice).

Layout (B, S, H, D) for q/out, (B, S, H_kv, D) for k/v, lse (B, H, Sq) f32.
The kernel masks a ragged sequence edge itself, so unlike the Pallas
kernel any S works.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import _build
from .attention import NEG_INF, tanh_softcap

__all__ = ["flash_attention", "flash_attention_with_lse", "flash_attention_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward: the same masks in the same order
    (softcap, then causal ``q >= k``, then window ``q - k < window``; the
    window implies the causal lower bound), f32 scores and f32 P·V, and the
    per-row ``lse = m + log(l)``. Returns ``(out (B, Sq, H, D), lse (B, H,
    Sq) f32)``."""
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    n_rep = h // h_kv
    qg = q.reshape(b, sq, h_kv, n_rep, d).float()
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * (1.0 / math.sqrt(d))
    s = tanh_softcap(s, softcap)
    if causal or window is not None:
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(skv, device=q.device)[None, :]
        vis = q_pos >= k_pos
        if window is not None:
            vis = vis & (q_pos - k_pos < window)
        s = torch.where(vis, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float()) / l.permute(0, 3, 1, 2)[..., None]
    lse = (m + torch.log(l)).reshape(b, h, sq)
    return out.reshape(b, sq, h, d).to(q.dtype), lse


def _check_inputs(q, k, v, segment_ids):
    if segment_ids is not None:
        raise NotImplementedError(
            "segment_ids (packed sequences) are not ported: the packing masks "
            "belong to the training slice (ROADMAP.md)"
        )
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention is forward-only in the port: the backward kernels "
            "(dq, dk/dv) come with the training slice; call it under "
            "torch.no_grad() or on tensors that do not require grad"
        )
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be (B, S, H, D)")
    if k.shape != v.shape or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"num heads {q.shape[2]} not divisible by kv heads {k.shape[2]}")


def _launch(q, k, v, causal, window, softcap):
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must all be on one device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash kernel takes float32 or bfloat16 q/k/v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash kernel takes contiguous (B, S, H, D) tensors")
    b, sq, h, d = q.shape
    skv, h_kv = k.shape[1], k.shape[2]
    if d not in (64, 128):
        raise ValueError(f"flash kernel supports head_dim 64 or 128, got {d}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    if q.device.type != "cuda":
        raise ValueError(f"the flash kernel runs on CUDA tensors; got {q.device}")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    code = _build.entry("flash_fwd", 5, 9, 2)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b, sq, skv, h, h_kv, d, _DTYPE_CODE[q.dtype], int(bool(causal)),
        int(window or 0), float(softcap or 0.0), 1.0 / math.sqrt(d),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_fwd", code)
    _build.count_launch("flash_fwd")
    return out, lse


def flash_attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids=None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, Sq, H, D) x (B, Skv, H_kv, D) flash attention returning ``(out,
    lse (B, H, Sq) f32)``. q and kv lengths may differ; ``causal`` anchors
    both at position 0."""
    _check_inputs(q, k, v, segment_ids)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, window=window, softcap=softcap)
    return _launch(q, k, v, causal, window, softcap)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    segment_ids=None,
    window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """(B, S, H, D) flash attention; GQA by passing fewer kv heads (shared
    across the group in the kernel, never repeated); ``window`` is the
    Mistral sliding window, whose out-of-window kv tiles the kernel skips."""
    if q.shape[1] != k.shape[1]:
        raise ValueError(
            f"flash_attention needs equal q/kv lengths, got {q.shape[1]} and "
            f"{k.shape[1]} (use flash_attention_with_lse)"
        )
    out, _ = flash_attention_with_lse(
        q, k, v, causal=causal, segment_ids=segment_ids, window=window, softcap=softcap
    )
    return out
