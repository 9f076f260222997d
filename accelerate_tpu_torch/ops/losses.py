"""Memory-efficient cross entropy (counterpart of
``accelerate_tpu/ops/losses.py``).

:func:`chunked_softmax_cross_entropy` fuses the LM head's product with the
loss over vocabulary chunks: an online logsumexp carries each row's
running max, sum of exponentials and label logit, so the (B, S, V) logits
never exist; at Llama-3-8B's vocabulary and a 4 x 2048 batch they are
4.2 GB in f32, a chunk of 4096 columns 134 MB. The backward recomputes
each chunk's logits from the saved hidden states and head (one more head
product) instead of keeping them. Plain PyTorch, as the JAX package
computes it in ``jnp`` outside any Pallas kernel: each chunk is one GEMM
with f32 products and output from operands in the hidden states' dtype,
as the port's LM head computes its logits.

Under tensor parallelism the logits are split over the vocabulary and no
rank holds them whole: :func:`vocab_parallel_nll` (the dense loss) and the
chunked loss with ``tp_group`` take each row's max, sum of exponentials and
label logit over the rank's block and all-reduce them over ``tp``
(Megatron's vocabulary-parallel cross entropy); the backward needs no
collective, since every rank computes the same loss, and the hidden
states' gradient from the rank's block is summed by the collective that
gathered them.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["chunked_softmax_cross_entropy", "vocab_parallel_nll"]

_NEG_BIG = -1e30  # the running max before the first chunk, as in JAX


def _f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with f32 products and output: one cuBLAS GEMM on bf16 (or
    f16) CUDA operands; on the CPU, which has no kernel for that overload,
    f32 operands (a bf16 x bf16 product is exact in f32)."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        return torch.mm(x, w, out_dtype=torch.float32)
    return x.float() @ w.float()


def _capped(raw: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return raw if softcap is None else softcap * torch.tanh(raw / softcap)


class _VocabParallelNLL(torch.autograd.Function):
    """Per-row negative log-likelihood from this rank's (N, V/tp) block of
    f32 logits; ``labels`` are offsets into the block (a row whose label is
    another rank's has none here)."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        from .collectives import all_reduce_

        width = logits.shape[-1]
        m = all_reduce_(logits.amax(dim=-1), group, "max")
        s = all_reduce_(torch.exp(logits - m[..., None]).sum(dim=-1), group)
        inside = (labels >= 0) & (labels < width)
        local = labels.clamp(0, width - 1)
        label_logit = torch.where(inside, logits.gather(-1, local[..., None])[..., 0], 0.0)
        all_reduce_(label_logit, group)
        lse = torch.log(s) + m
        ctx.save_for_backward(logits, lse, local, inside)
        return lse - label_logit

    @staticmethod
    def backward(ctx, grad):
        logits, lse, local, inside = ctx.saved_tensors
        d = torch.exp(logits - lse[..., None]) * grad[..., None]
        d.scatter_add_(-1, local[..., None], -(grad * inside)[..., None])
        return d, None, None


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, vocab_start: int,
                       group) -> torch.Tensor:
    """Per-token ``logsumexp(logits) - logits[label]`` over the whole
    vocabulary from this rank's block (``logits`` (..., V/tp) f32, its first
    column ``vocab_start``), the same value on every rank of ``group``;
    ``labels`` index the whole vocabulary."""
    return _VocabParallelNLL.apply(logits, labels.long() - vocab_start, group)


class _ChunkedNLL(torch.autograd.Function):
    """Per-row negative log-likelihood of ``softmax(hidden @ kernel)`` at
    ``labels``, over vocabulary chunks; saves (hidden, kernel, labels, lse)
    and recomputes each chunk in the backward. With ``group`` the kernel is
    this rank's vocabulary block and ``labels`` offsets into it: the row
    statistics are all-reduced over the group after the last chunk."""

    @staticmethod
    def forward(ctx, hidden, kernel, labels, chunk_size, softcap, group):
        n, v = hidden.shape[0], kernel.shape[1]
        m = torch.full((n,), _NEG_BIG, dtype=torch.float32, device=hidden.device)
        s = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
        label_logit = torch.zeros((n,), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, v, chunk_size):
            c1 = min(c0 + chunk_size, v)
            # Gemma-2's cap applies before anything else sees the chunk
            logits = _capped(_f32_product(hidden, kernel[:, c0:c1]), softcap)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
            m = m_new
            local = (labels - c0).clamp(0, c1 - c0 - 1)
            in_chunk = (labels >= c0) & (labels < c1)
            label_logit = torch.where(in_chunk, logits.gather(1, local[:, None])[:, 0], label_logit)
        if group is not None:
            from .collectives import all_reduce_

            m_all = all_reduce_(m.clone(), group, "max")
            s = all_reduce_(s * torch.exp(m - m_all), group)
            m = m_all
            all_reduce_(label_logit, group)
        lse = m + torch.log(s.clamp_min(1e-30))
        ctx.save_for_backward(hidden, kernel, labels, lse)
        ctx.chunk_size, ctx.softcap = chunk_size, softcap
        return lse - label_logit

    @staticmethod
    def backward(ctx, grad):
        hidden, kernel, labels, lse = ctx.saved_tensors
        chunk_size, softcap = ctx.chunk_size, ctx.softcap
        v = kernel.shape[1]
        grad = grad.float()
        dh = torch.zeros(hidden.shape, dtype=torch.float32, device=hidden.device) \
            if ctx.needs_input_grad[0] else None
        dk = torch.empty_like(kernel) if ctx.needs_input_grad[1] else None
        for c0 in range(0, v, chunk_size):
            c1 = min(c0 + chunk_size, v)
            k_chunk = kernel[:, c0:c1]
            logits = _capped(_f32_product(hidden, k_chunk), softcap)
            # d nll / d logits = softmax - onehot(label), times the row's grad
            d = torch.exp(logits - lse[:, None])
            local = (labels - c0).clamp(0, c1 - c0 - 1)
            in_chunk = (labels >= c0) & (labels < c1)
            d.scatter_add_(1, local[:, None], -in_chunk.float()[:, None])
            d = d * grad[:, None]
            if softcap is not None:
                d = d * (1.0 - (logits / softcap) ** 2)
            # the f32 cotangent in the operands' dtype, as the LM head's
            # backward rounds it: bf16 GEMMs with f32 accumulation
            d = d.to(hidden.dtype)
            if dh is not None:
                dh += _f32_product(d, k_chunk.T)
            if dk is not None:
                dk[:, c0:c1] = hidden.T @ d
        return (None if dh is None else dh.to(hidden.dtype)), dk, None, None, None, None


def chunked_softmax_cross_entropy(
    hidden: torch.Tensor,
    head_kernel: torch.Tensor,
    labels: torch.Tensor,
    *,
    chunk_size: int = 4096,
    loss_mask: Optional[torch.Tensor] = None,
    logit_dtype=torch.float32,
    reduction: str = "mean",
    logit_softcap: Optional[float] = None,
    vocab_start: int = 0,
    tp_group=None,
) -> torch.Tensor:
    """Cross entropy of ``softmax(hidden @ head_kernel)`` against ``labels``
    without the full logits. ``hidden`` (B, S, D), ``head_kernel`` (D, V)
    in ``hidden``'s dtype, ``labels`` (B, S) int. The vocabulary is taken
    ``chunk_size`` columns at a time (the last chunk may be narrower);
    ``logit_softcap`` caps each chunk's f32 logits before the logsumexp.
    Labels < 0 (HF's -100) are left out: without ``loss_mask`` the mask is
    ``labels >= 0``; an explicit ``loss_mask`` wins. Returns the masked
    mean (``reduction="mean"``, divided by ``max(sum(mask), 1)``) or sum
    (``"sum"``) in f32. With ``tp_group``, ``head_kernel`` is this rank's
    (D, V/tp) block of the head from column ``vocab_start`` (tensor
    parallelism): the loss is the whole vocabulary's on every rank, and the
    gradient of ``hidden`` is this block's share."""
    if logit_dtype != torch.float32:
        raise ValueError(f"the chunk logits are f32 (logit_dtype=torch.float32), got {logit_dtype}")
    if reduction not in ("mean", "sum"):
        raise ValueError(f"reduction must be 'mean' or 'sum', got {reduction!r}")
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    b, s, d = hidden.shape
    if head_kernel.shape[0] != d or labels.shape != (b, s):
        raise ValueError(f"hidden (B, S, D) = {tuple(hidden.shape)}, head_kernel (D, V) = "
                         f"{tuple(head_kernel.shape)} and labels (B, S) = {tuple(labels.shape)} "
                         "do not match")
    mask = (labels >= 0).float() if loss_mask is None else loss_mask.float()
    nll = _ChunkedNLL.apply(hidden.reshape(b * s, d), head_kernel,
                            labels.reshape(-1).clamp_min(0).long() - vocab_start, chunk_size,
                            logit_softcap, tp_group)
    total = (nll.reshape(b, s) * mask).sum()
    if reduction == "sum":
        return total
    return total / mask.sum().clamp_min(1)
