"""The port's flash-attention forward and attention references against the
JAX package (Pallas kernel in interpret mode on the CPU).

Inputs come from a numpy seed and go to both sides in float32. Tolerance
atol = rtol = 1e-5: both sides accumulate scores and P·V in f32, so they
differ only in summation order (the Pallas kernel merges tiles online,
the port's plain version softmaxes the whole row at once).

With bf16 inputs both sides round P to bf16 before P·V; the test of that
bounds the mean and the share of unequal elements instead (see there).

The CUDA kernels themselves are compared with this plain version on the
card (``chip_smoke.py``, and the ``cuda``-marked tests in
``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.ops import attention as jattn
from accelerate_tpu.ops.flash_attention import (
    flash_attention as j_flash,
    flash_attention_with_lse as j_flash_lse,
)
from accelerate_tpu_torch.ops import attention as tattn
from accelerate_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_with_lse,
)

TOL = dict(atol=1e-5, rtol=1e-5)


# name -> (B, S, H, H_kv, D, window, softcap, JAX block)
CASES = {
    "causal": (2, 32, 4, 4, 16, None, None, 16),
    "gqa_4_2": (2, 32, 4, 2, 16, None, None, 16),
    "window": (1, 48, 4, 2, 16, 12, None, 16),
    "softcap": (2, 32, 4, 2, 16, None, 30.0, 16),
    "unaligned": (1, 40, 4, 2, 16, None, None, 16),  # JAX picks block 8
}


def _qkv(b, s, h, h_kv, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, h_kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_matches_jax_kernel(case):
    b, s, h, h_kv, d, window, softcap, blk = CASES[case]
    q, k, v = _qkv(b, s, h, h_kv, d)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                  window=window, softcap=softcap, block_q=blk, block_k=blk, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, window=window, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("case", ["causal", "gqa_4_2", "softcap", "unaligned"])
def test_plain_flash_lse_matches_jax_kernel(case):
    b, s, h, h_kv, d, _, softcap, blk = CASES[case]
    q, k, v = _qkv(b, s, h, h_kv, d, seed=1)
    ref_out, ref_lse = j_flash_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                                   softcap=softcap, block_q=blk, block_k=blk, interpret=True)
    out, lse = flash_attention_with_lse(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), causal=True, softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **TOL)


@pytest.mark.parametrize("impl", ["xla", "blockwise", "flash"])
@pytest.mark.parametrize("window", [None, 12])
def test_dispatch_attention_matches_jax(impl, window):
    q, k, v = _qkv(2, 40, 4, 2, 16, seed=2)
    kw = dict(causal=True, kv_block=16, window=window)
    ref = jattn.dispatch_attention(impl, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   block_q=16, **kw)
    out = tattn.dispatch_attention(impl, torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_flash_with_q_offset_falls_back_to_blockwise():
    # the kernel anchors its causal mask at 0, so a shifted q block must not
    # reach it (the JAX dispatch rule)
    q, k, v = _qkv(1, 16, 4, 2, 16, seed=3)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out = tattn.dispatch_attention("flash", qt, kt, vt, q_offset=8, kv_block=8)
    ref = tattn.blockwise_attention(qt, kt, vt, q_offset=8, kv_block=8)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def test_noncausal_plain_flash_matches_jax_kernel():
    q, k, v = _qkv(1, 32, 4, 2, 16, seed=4)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
                  block_q=16, block_k=16, interpret=True)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# bf16 inputs: the TPU kernel rounds P to v's dtype before P·V and sums l
# from the f32 P; a plain forward that keeps P in f32 differs from it in
# 27-32 % of the bf16 outputs with a mean |diff| of 2.5-3.2e-4 on these
# cases, one that rounds as the kernel does in 5-15 % with 3.1e-5-1.1e-4
# (the rest: f32 summation order, tile by tile against whole rows, moving
# an output across a bf16 rounding boundary). The bounds sit between the two.
BF16_MEAN_DIFF_MAX = 1.8e-4
BF16_UNEQUAL_SHARE_MAX = 0.21


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_flash_bf16_rounds_p_like_jax_kernel(case):
    b, s, h, h_kv, d, window, softcap, blk = CASES[case]
    q, k, v = _qkv(b, s, h, h_kv, d)
    ref = j_flash(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)), causal=True,
                  window=window, softcap=softcap, block_q=blk, block_k=blk, interpret=True)
    out = flash_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                          causal=True, window=window, softcap=softcap)
    diff = np.abs(out.float().numpy() - np.asarray(ref, dtype=np.float32))
    assert diff.mean() <= BF16_MEAN_DIFF_MAX
    assert (diff > 0).mean() <= BF16_UNEQUAL_SHARE_MAX
