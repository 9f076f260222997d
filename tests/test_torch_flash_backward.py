"""The port's flash backward (the plain version of kernels B2 and B3, run
through the ``_FlashAttention`` autograd function on the CPU) against
``jax.grad`` through the JAX package's Pallas flash kernels in interpret
mode, and the packed-sequence masks of the forward.

Inputs come from a numpy seed and go to both sides in float32, with the
JAX suite's block sizes (16). Tolerances: gradients atol 2e-4, the JAX
suite's own for its kernel-vs-reference gradients
(``tests/test_flash_attention.py``): both sides sum f32 products over the
kv (dq) or q (dk, dv) axis in another order, tile by tile against the whole
row. Forward outputs atol = rtol = 1e-5 (one softmax, f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.ops.flash_attention import (
    flash_attention as j_flash,
    flash_attention_with_lse as j_flash_lse,
)
from accelerate_tpu_torch.ops.flash_attention import (
    _FlashAttention,
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_attention_with_lse,
)

GRAD_TOL = dict(atol=2e-4, rtol=0)
FWD_TOL = dict(atol=1e-5, rtol=1e-5)

# name -> (B, S, H, H_kv, D, causal, window, softcap, segment starts per row)
CASES = {
    "causal": (2, 32, 4, 4, 16, True, None, None, None),
    "noncausal": (2, 32, 4, 4, 16, False, None, None, None),
    "gqa_8_2": (1, 64, 8, 2, 16, True, None, None, None),
    "window": (1, 48, 4, 2, 16, True, 12, None, None),
    "softcap": (2, 32, 4, 2, 16, True, None, 5.0, None),
    "segments": (2, 48, 4, 2, 16, True, None, None, ((0, 20, 37), (0, 9))),
}


def _inputs(b, s, h, h_kv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    w = rng.normal(size=(b, s, h, d)).astype(np.float32)  # the output cotangent
    return q, k, v, w


def _segments(starts_per_row, s):
    if starts_per_row is None:
        return None
    return np.stack([np.searchsorted(np.asarray(st[1:]), np.arange(s), side="right")
                     for st in starts_per_row]).astype(np.int32)


def _torch_grads(fn, arrays, extra):
    tensors = [torch.from_numpy(a).requires_grad_() for a in arrays]
    return [g.numpy() for g in torch.autograd.grad(fn(*tensors, **extra), tensors)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_backward_matches_jax_grad(case):
    b, s, h, h_kv, d, causal, window, softcap, starts = CASES[case]
    q, k, v, w = _inputs(b, s, h, h_kv, d)
    seg = _segments(starts, s)

    def j_loss(q, k, v):
        out = j_flash(q, k, v, causal=causal, window=window, softcap=softcap,
                      segment_ids=None if seg is None else jnp.asarray(seg),
                      block_q=16, block_k=16, interpret=True)
        return jnp.sum(out * w)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tseg = None if seg is None else torch.from_numpy(seg)

    def t_loss(q, k, v):
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=softcap, segment_ids=tseg)
        return (out * torch.from_numpy(w)).sum()

    for g, r in zip(_torch_grads(t_loss, (q, k, v), {}), ref):
        np.testing.assert_allclose(g, np.asarray(r), **GRAD_TOL)


@pytest.mark.parametrize("case", ["causal", "gqa_8_2", "softcap", "segments"])
def test_lse_cotangent_matches_jax_grad(case):
    # flash_attention_with_lse is differentiable in both outputs: the lse
    # cotangent folds into delta (delta -= dlse)
    b, s, h, h_kv, d, causal, _, softcap, starts = CASES[case]
    q, k, v, w = _inputs(b, s, h, h_kv, d, seed=1)
    wl = np.random.default_rng(2).normal(size=(b, h, s)).astype(np.float32)
    seg = _segments(starts, s)

    def j_loss(q, k, v):
        out, lse = j_flash_lse(q, k, v, causal=causal, softcap=softcap,
                               segment_ids=None if seg is None else jnp.asarray(seg),
                               block_q=16, block_k=16, interpret=True)
        return jnp.sum(out * w) + jnp.sum(lse * wl)

    ref = jax.grad(j_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def t_loss(q, k, v):
        out, lse = flash_attention_with_lse(
            q, k, v, causal=causal, softcap=softcap,
            segment_ids=None if seg is None else torch.from_numpy(seg))
        return (out * torch.from_numpy(w)).sum() + (lse * torch.from_numpy(wl)).sum()

    for g, r in zip(_torch_grads(t_loss, (q, k, v), {}), ref):
        np.testing.assert_allclose(g, np.asarray(r), **GRAD_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_segment_ids_forward_matches_jax(causal):
    b, s, h, h_kv, d = 2, 40, 4, 2, 16
    q, k, v, _ = _inputs(b, s, h, h_kv, d, seed=3)
    seg = _segments(((0, 13, 30), (0, 1, 25)), s)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                  segment_ids=jnp.asarray(seg), block_q=8, block_k=8, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_kv_segment_ids_forward_matches_jax():
    # q and kv rows labelled independently (the ring-attention layout)
    b, s, h, h_kv, d = 1, 32, 4, 2, 16
    q, k, v, _ = _inputs(b, s, h, h_kv, d, seed=4)
    qseg = np.zeros((b, s), np.int32)
    kseg = (np.arange(s) >= 5).astype(np.int32)[None]
    ref_out, ref_lse = j_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                                   segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg),
                                   block_q=16, block_k=16, interpret=True)
    out, lse = flash_attention_with_lse(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False,
        segment_ids=torch.from_numpy(qseg), kv_segment_ids=torch.from_numpy(kseg))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **FWD_TOL)


# autograd plumbing: _FlashAttention's recompute backward (the plain
# versions of B2/B3) against autograd through the plain forward, same f32
# math in another order: atol = rtol = 1e-5
@pytest.mark.parametrize("opts", [
    dict(),
    dict(window=5, softcap=3.0),
    dict(causal=False),
    dict(segments=((0, 4, 11),)),
])
def test_autograd_function_matches_autograd_through_reference(opts):
    b, s, h, h_kv, d = 1, 17, 4, 2, 8
    q, k, v, w = _inputs(b, s, h, h_kv, d, seed=5)
    wl = np.random.default_rng(6).normal(size=(b, h, s)).astype(np.float32)
    seg = _segments(opts.get("segments"), s)
    kw = dict(causal=opts.get("causal", True), window=opts.get("window"),
              softcap=opts.get("softcap"),
              segment_ids=None if seg is None else torch.from_numpy(seg))

    def loss(fn):
        def inner(q, k, v):
            out, lse = fn(q, k, v, **kw)
            # a non-contiguous output cotangent, as a transpose downstream gives
            wt = torch.from_numpy(w).transpose(1, 2).contiguous().transpose(1, 2)
            return (out * wt).sum() + (lse * torch.from_numpy(wl)).sum()
        return inner

    got = _torch_grads(loss(flash_attention_with_lse), (q, k, v), {})
    ref = _torch_grads(loss(flash_attention_reference), (q, k, v), {})
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-5, rtol=1e-5)


def test_backward_without_lse_cotangent_and_grad_flags():
    # only q requires grad; lse unused: the backward still runs, dk/dv unused
    q, k, v, w = _inputs(1, 16, 4, 2, 8, seed=7)
    qt = torch.from_numpy(q).requires_grad_()
    out = flash_attention(qt, torch.from_numpy(k), torch.from_numpy(v))
    (dq,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (qt,))
    ref_out, ref_lse = flash_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                                 torch.from_numpy(v))
    rdq, _, _ = flash_attention_bwd_reference(torch.from_numpy(q), torch.from_numpy(k),
                                              torch.from_numpy(v), ref_out, ref_lse,
                                              torch.from_numpy(w))
    torch.testing.assert_close(dq, rdq, atol=1e-6, rtol=1e-6)
    assert _FlashAttention.apply is not None


def test_bf16_plain_backward_rounds_like_the_kernels():
    # p is rounded to do's dtype before dv and ds to q's dtype before dq/dk:
    # the bf16 result differs from an f32 backward by bf16 rounding only
    q, k, v, w = (torch.from_numpy(x) for x in _inputs(1, 32, 4, 2, 16, seed=8))
    out, lse = flash_attention_reference(q, k, v)
    f32 = flash_attention_bwd_reference(q, k, v, out, lse, w)
    lo = [x.to(torch.bfloat16) for x in (q, k, v, out, w)]
    bf16 = flash_attention_bwd_reference(lo[0], lo[1], lo[2], lo[3], lse, lo[4])
    for a, b16 in zip(f32, bf16):
        assert b16.dtype == torch.bfloat16
        err = (a - b16.float()).abs().max() / a.abs().max()
        assert 0 < err < 3e-2
