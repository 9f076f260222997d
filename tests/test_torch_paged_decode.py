"""The port's paged decode and fused sampling against the JAX package's
Pallas kernels (interpret mode on the CPU).

Inputs come from a numpy seed. Paged decode: f32, atol = rtol = 1e-5 (f32
accumulation on both sides; only the summation order differs); bf16 q over
a bf16 or an int8 pool (the main path's forms, which the card serves with
the tensor-core kernels), 2e-2 absolute and each output row (slot, head)
within 2^-6 of its largest |reference|: both sides accumulate in f32 and
round p and the output to bf16, at other points (the JAX kernel rounds p
per table block, the plain version once over the row), a bf16 ulp or two.
Fused sampling: token ids must agree exactly, with the same Gumbel noise
handed to both sides.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.engine import _sample_rows as j_sample_rows
from accelerate_tpu.ops.paged_decode import fused_sample as j_fused_sample
from accelerate_tpu.ops.paged_decode import paged_flash_decode as j_paged_decode
from accelerate_tpu_torch.engine import _sample_rows
from accelerate_tpu_torch.ops.paged_decode import (
    fused_sample,
    paged_flash_decode,
    paged_flash_verify,
)

B, BPR, BS, H, HKV, D, NB = 3, 4, 4, 4, 2, 8, 12
TOL = dict(atol=1e-5, rtol=1e-5)


def _pools(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    kp = rng.normal(size=(NB, BS, HKV, D)).astype(np.float32)
    vp = rng.normal(size=(NB, BS, HKV, D)).astype(np.float32)
    tables = rng.integers(1, NB, size=(B, BPR)).astype(np.int32)
    return q, kp, vp, tables


def _single_block_tables():
    t = np.zeros((B, BPR), np.int32)
    t[:, 0] = [2, 5, 9]
    return t


# name -> (tables override, pos, softcap)
CASES = {
    "mixed_pos": (None, [0, 5, BPR * BS - 1], None),
    "all_null_pos0": (np.zeros((B, BPR), np.int32), [0, 0, 0], None),
    "single_live_block": (_single_block_tables(), [1, 2, BS - 1], None),
    "exactly_full_last_block": (None, [BPR * BS - 1] * B, None),
    "softcap": (None, [0, 5, BPR * BS - 1], 30.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_paged_decode_matches_jax_kernel(case):
    tables_override, pos, softcap = CASES[case]
    q, kp, vp, tables = _pools(seed=sorted(CASES).index(case))
    if tables_override is not None:
        tables = tables_override
    pos = np.asarray(pos, np.int32)
    ref = j_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
                         jnp.asarray(pos), softcap=softcap, interpret=True)
    out = paged_flash_decode(*(torch.from_numpy(x) for x in (q, kp, vp, tables, pos)), softcap=softcap)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_paged_decode_custom_scale_matches_jax_kernel():
    q, kp, vp, tables = _pools(seed=7)
    pos = np.asarray([3, 9, 14], np.int32)
    ref = j_paged_decode(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
                         jnp.asarray(pos), scale=0.0625, interpret=True)
    out = paged_flash_decode(*(torch.from_numpy(x) for x in (q, kp, vp, tables, pos)), scale=0.0625)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# bf16 q over a bf16 pool and over an int8 pool with per-position scales,
# at a width the kernels take (D = 64, GQA groups of 4, 16-position blocks)
BF16_B, BF16_BPR, BF16_BS, BF16_H, BF16_HKV, BF16_D = 3, 4, 16, 8, 2, 64
BF16_NB = BF16_B * BF16_BPR + 1
BF16_ATOL = 2e-2
BF16_ROW_RTOL = 2.0 ** -6


def _bf16_inputs(seed, pool):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BF16_B, 1, BF16_H, BF16_D)).astype(np.float32)
    shape = (BF16_NB, BF16_BS, BF16_HKV, BF16_D)
    tables = (rng.permutation(BF16_NB - 1)[: BF16_B * BF16_BPR] + 1).reshape(BF16_B, BF16_BPR)
    if pool == "int8":
        kp, vp = (rng.integers(-127, 128, size=shape).astype(np.int8) for _ in range(2))
        scales = [(rng.random((BF16_NB, BF16_BS)) * 0.02 + 1e-3).astype(np.float32) for _ in range(2)]
    else:
        kp, vp = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
        scales = None
    return q, kp, vp, tables.astype(np.int32), scales


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("pool", ["bf16", "int8"])
def test_bf16_paged_decode_matches_jax_kernel(pool, softcap):
    q, kp, vp, tables, scales = _bf16_inputs(seed=11 if pool == "bf16" else 12, pool=pool)
    # a fresh slot, a mid-block one, an exactly full last block
    pos = np.asarray([0, 21, BF16_BPR * BF16_BS - 1], np.int32)
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    if pool == "bf16":
        jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (kp, vp))
        tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (kp, vp))
        jkw, tkw = {}, {}
    else:
        jk, jv, tk, tv = jnp.asarray(kp), jnp.asarray(vp), torch.from_numpy(kp), torch.from_numpy(vp)
        jkw = dict(k_scale=jnp.asarray(scales[0]), v_scale=jnp.asarray(scales[1]))
        tkw = dict(k_scale=torch.from_numpy(scales[0]), v_scale=torch.from_numpy(scales[1]))
    ref = np.asarray(j_paged_decode(jq, jk, jv, jnp.asarray(tables), jnp.asarray(pos),
                                    softcap=softcap, interpret=True, **jkw).astype(jnp.float32))
    out = paged_flash_decode(tq, tk, tv, torch.from_numpy(tables), torch.from_numpy(pos),
                             softcap=softcap, **tkw)
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, atol=BF16_ATOL, rtol=0)
    row_err = np.abs(out - ref).max(-1) / np.abs(ref).max(-1)
    assert row_err.max() <= BF16_ROW_RTOL


def test_int8_pool_and_verify_are_queued():
    # the int8 pool and the verify kernel were queued and are ported now:
    # an int8 pool at unit scales is the f32 pool of its codes, and a
    # one-token window whose key is the pool's own column at pos is decode
    q, kp, vp, tables = _pools(seed=8)
    kq = np.clip(np.round(kp * 40), -127, 127).astype(np.int8)
    vq = np.clip(np.round(vp * 40), -127, 127).astype(np.int8)
    pos = np.asarray([0, 5, BPR * BS - 1], np.int32)
    ones = torch.ones(NB, BS)
    args = [torch.from_numpy(x) for x in (q, kq, vq, tables, pos)]
    out = paged_flash_decode(*args, k_scale=ones, v_scale=ones)
    ref = paged_flash_decode(*(torch.from_numpy(x) for x in (q, kq.astype(np.float32),
                                                               vq.astype(np.float32), tables, pos)))
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    rows = np.arange(B)
    blk, off = tables[rows, pos // BS], pos % BS
    win_k, win_v = (torch.from_numpy(p[blk, off][:, None].copy()) for p in (kp, vp))
    ver = paged_flash_verify(*(torch.from_numpy(x) for x in (q, kp, vp)), win_k, win_v,
                             torch.from_numpy(tables), torch.from_numpy(pos))
    dec = paged_flash_decode(*(torch.from_numpy(x) for x in (q, kp, vp, tables, pos)))
    np.testing.assert_allclose(ver.numpy(), dec.numpy(), **TOL)


def _sample_inputs(seed, s=8, v=64):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(s, v)) * 3).astype(np.float32)
    logits[5] = np.round(logits[5])  # ties: first-index and Z-over-k_eff rules
    temp = np.asarray([0.0, 0.8, 0.8, 0.8, 1.0, 0.7, 1.3, 0.5], np.float32)[:s]
    top_k = np.asarray([0, 5, 0, 5, 1, 7, 0, 64], np.int32)[:s]
    top_p = np.asarray([1.0, 1.0, 0.9, 0.9, 0.5, 0.95, 0.3, 1.0], np.float32)[:s]
    keys = jax.random.split(jax.random.key(seed), s)
    noise = np.array(jax.vmap(lambda kk: jax.random.gumbel(kk, (v,), jnp.float32))(keys))
    return logits, noise, temp, top_k, top_p, keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fused_sample_bitwise_matches_jax_kernel(seed):
    logits, noise, temp, top_k, top_p, keys = _sample_inputs(seed)
    ref = np.asarray(j_fused_sample(*(jnp.asarray(x) for x in (logits, noise, temp, top_k, top_p)),
                                    interpret=True))
    args = [torch.from_numpy(x) for x in (logits, noise, temp, top_k, top_p)]
    np.testing.assert_array_equal(fused_sample(*args).numpy(), ref)
    # the JAX engine's sort-based sampler with the keys that made the noise
    # draws the same tokens (categorical == argmax(filtered + gumbel(key)))
    ref_rows = np.asarray(j_sample_rows(jnp.asarray(logits), keys, jnp.asarray(temp),
                                        jnp.asarray(top_k), jnp.asarray(top_p)))
    np.testing.assert_array_equal(fused_sample(*args).numpy(), ref_rows)
    # and so does the port's own sort-based sampler (the engine's reference path)
    np.testing.assert_array_equal(_sample_rows(*args).numpy(), ref_rows)


@pytest.mark.parametrize("top_p", [0.0, -0.5])
def test_fused_sample_top_p_zero_keeps_every_token_as_jax_does(top_p):
    # p * Z <= 0 reaches no cutoff: every token stays, as with top-p off
    logits, noise, temp, top_k, _, _ = _sample_inputs(4)
    temp = np.maximum(temp, 0.6).astype(np.float32)
    tp = np.full_like(temp, top_p)
    ref = np.asarray(j_fused_sample(*(jnp.asarray(x) for x in (logits, noise, temp, top_k, tp)),
                                    interpret=True))
    args = [torch.from_numpy(x) for x in (logits, noise, temp, top_k)]
    out = fused_sample(*args, torch.from_numpy(tp)).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, fused_sample(*args, torch.ones(8)).numpy())
