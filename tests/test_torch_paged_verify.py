"""The port's int8 KV pool, window commits, paged verify attention and
``llama_verify_step`` against the JAX package (Pallas kernels in interpret
mode on the CPU).

Inputs come from a numpy seed. Tolerances:
* ``kv_quantize``, window commits and block-pool state: exact (integer
  bytes, f32 scales of one IEEE division, copies);
* plain verify and int8 decode attention against the JAX kernels: atol
  1e-5 (f32 accumulation on both sides, only the summation order differs);
* ``llama_verify_step`` logits and window K/V of the 2-layer model: atol =
  rtol = 1e-4, as for the decode step (the projections' f32 matmuls sum in
  another order in XLA and in PyTorch); int8 pools 2e-4, because a
  rounding-size difference of a K/V value can move its int8 code by one
  step of 1/127 of the position's amax before the forward goes on.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.kvcache import PagedBlockPool as JPool
from accelerate_tpu.kvcache import PagedKVLayout as JLayout
from accelerate_tpu.kvcache import kv_dequantize as j_dequantize
from accelerate_tpu.kvcache import kv_quantize as j_quantize
from accelerate_tpu.kvcache import make_kv_backend as j_make_backend
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops.attention import verify_attention as j_verify_attention
from accelerate_tpu.ops.paged_decode import paged_flash_decode as j_paged_decode
from accelerate_tpu.ops.paged_decode import paged_flash_verify as j_paged_verify
from accelerate_tpu_torch.kvcache import (
    PagedBlockPool,
    PagedKVLayout,
    kv_dequantize,
    kv_quantize,
    make_kv_backend,
)
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.ops.attention import paged_attention, verify_attention
from accelerate_tpu_torch.ops.paged_decode import (
    paged_flash_decode,
    paged_flash_verify,
)

NB, BS, BPR, D = 12, 4, 4, 8
KERNEL_TOL = dict(atol=1e-5, rtol=0)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ int8 ops
def test_kv_quantize_is_bitwise_the_jax_quantization():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 8, 2, 16)).astype(np.float32) * 3
    x[0, 1] = 0.0  # all-zero position: amax clamps at 1e-6
    x[1, 2, 3] = np.round(x[1, 2, 3] * 2) / 2  # halves: half-to-even rounding
    jq, js = j_quantize(jnp.asarray(x))
    tq, ts = kv_quantize(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    np.testing.assert_array_equal(_np(kv_dequantize(tq, ts, torch.float32)),
                                  np.asarray(j_dequantize(jq, js, jnp.float32)))
    # bf16 input (the compute dtype the engine commits from)
    xb = jnp.asarray(x, jnp.bfloat16)
    jq, js = j_quantize(xb)
    tq, ts = kv_quantize(_t(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16))
    np.testing.assert_array_equal(_np(tq), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))


def _int8_pools(rng, shape):
    kq = rng.integers(-127, 128, size=shape).astype(np.int8)
    vq = rng.integers(-127, 128, size=shape).astype(np.int8)
    ks = rng.uniform(1e-3, 2e-2, size=shape[:2]).astype(np.float32)
    vs = rng.uniform(1e-3, 2e-2, size=shape[:2]).astype(np.float32)
    # an all-zero-scale block (released / never written) dequantizes to zeros
    ks[3] = 0.0
    vs[3] = 0.0
    return kq, vq, ks, vs


@pytest.mark.parametrize("softcap", [None, 30.0])
def test_plain_int8_paged_decode_matches_jax_kernel(softcap):
    rng = np.random.default_rng(5)
    b, h, h_kv = 3, 4, 2
    q = rng.normal(size=(b, 1, h, D)).astype(np.float32)
    kq, vq, ks, vs = _int8_pools(rng, (NB, BS, h_kv, D))
    tables = rng.integers(1, NB, size=(b, BPR)).astype(np.int32)
    tables[1, 1] = 3  # a live zero-scale block
    pos = np.asarray([0, 5, BPR * BS - 1], np.int32)
    ref = j_paged_decode(*(jnp.asarray(x) for x in (q, kq, vq, tables, pos)),
                         k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), softcap=softcap,
                         interpret=True)
    out = paged_flash_decode(*(_t(x) for x in (q, kq, vq, tables, pos)), k_scale=_t(ks),
                             v_scale=_t(vs), softcap=softcap)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(_np(out), np.asarray(ref), **KERNEL_TOL)


# ------------------------------------------------------------- verify attention
# name -> (W, H, Hkv, pos, softcap, int8)
VERIFY_CASES = {
    "mixed_pos": (3, 4, 2, [0, 6], None, False),
    "overhang": (3, 4, 2, [3, BPR * BS - 2], None, False),
    "softcap": (3, 4, 2, [5, 9], 30.0, False),
    "mha": (4, 2, 2, [7, 0], None, False),
    "gqa4": (2, 8, 2, [1, 12], None, False),
    "int8": (3, 4, 2, [0, 7], None, True),
    "int8_softcap_overhang": (4, 4, 2, [5, BPR * BS - 3], 50.0, True),
}


def _verify_inputs(case):
    w, h, h_kv, pos, softcap, int8 = VERIFY_CASES[case]
    b = len(pos)
    rng = np.random.default_rng(sorted(VERIFY_CASES).index(case))
    q = rng.normal(size=(b, w, h, D)).astype(np.float32)
    # disjoint rows, as the allocator keeps them
    tables = (1 + rng.permutation(NB - 1)[: b * BPR]).reshape(b, BPR).astype(np.int32)
    win_k = rng.normal(size=(b, w, h_kv, D)).astype(np.float32)
    win_v = rng.normal(size=(b, w, h_kv, D)).astype(np.float32)
    if int8:
        kp, vp, ks, vs = _int8_pools(rng, (NB, BS, h_kv, D))
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kp = rng.normal(size=(NB, BS, h_kv, D)).astype(np.float32)
        vp = rng.normal(size=(NB, BS, h_kv, D)).astype(np.float32)
        scales = {}
    return q, kp, vp, win_k, win_v, tables, np.asarray(pos, np.int32), scales, softcap


@pytest.mark.parametrize("case", sorted(VERIFY_CASES))
def test_plain_verify_matches_jax_kernel_and_verify_attention(case):
    q, kp, vp, wk, wv, tables, pos, scales, softcap = _verify_inputs(case)
    args = (q, kp, vp, wk, wv, tables, pos)
    ref = j_paged_verify(*(jnp.asarray(x) for x in args), softcap=softcap, interpret=True,
                         **{k: jnp.asarray(v) for k, v in scales.items()})
    out = paged_flash_verify(*(_t(x) for x in args), softcap=softcap,
                             **{k: _t(v) for k, v in scales.items()})
    assert out.shape == q.shape
    # a query whose position lies past the row is discarded by the engine:
    # the kernel attends its own key in-register, the plain version has
    # dropped that key from the row; only the valid queries are compared
    valid = pos[:, None] + np.arange(q.shape[1])[None, :] < BPR * BS
    assert valid.sum() < valid.size or "overhang" not in case
    out, ref = _np(out)[valid], np.asarray(ref)[valid]
    np.testing.assert_allclose(out, ref, **KERNEL_TOL)
    if scales:
        return
    # the JAX reference semantics: the window committed into a pool copy
    kp_ref, vp_ref = kp.copy(), vp.copy()
    for bb in range(len(pos)):
        for j in range(q.shape[1]):
            ap = int(pos[bb]) + j
            if ap < BPR * BS:
                kp_ref[tables[bb, ap // BS], ap % BS] = wk[bb, j]
                vp_ref[tables[bb, ap // BS], ap % BS] = wv[bb, j]
    jref = j_verify_attention(*(jnp.asarray(x) for x in (q, kp_ref, vp_ref, tables, pos)),
                              softcap=softcap)
    np.testing.assert_allclose(out, np.asarray(jref)[valid], **KERNEL_TOL)
    tref = verify_attention(*(_t(x) for x in (q, kp_ref, vp_ref, tables, pos)), softcap=softcap)
    np.testing.assert_allclose(_np(tref), np.asarray(jref), **KERNEL_TOL)


def test_verify_query0_matches_paged_attention():
    # the first window query sits where decode's single query sits: same
    # mask, same math (f32, 1e-6: the two einsums may block differently)
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 3, 4, 8)).astype(np.float32)
    kp = rng.normal(size=(5, 4, 2, 8)).astype(np.float32)
    vp = rng.normal(size=(5, 4, 2, 8)).astype(np.float32)
    tables = np.asarray([[1, 2], [3, 4]], np.int32)
    pos = np.asarray([5, 2], np.int32)
    ver = verify_attention(*(_t(x) for x in (q, kp, vp, tables, pos)))
    dec = paged_attention(*(_t(x) for x in (q[:, :1], kp, vp, tables, pos)))
    np.testing.assert_allclose(_np(ver[:, :1]), _np(dec), atol=1e-6, rtol=0)


# ------------------------------------------------------------- window commits
def _window(rng, cfg, b=2, w=4):
    shape = (cfg.num_hidden_layers, b, w, cfg.num_key_value_heads, cfg.head_dim)
    return {x: rng.normal(size=shape).astype(np.float32) for x in ("k", "v")}


def _jcfg():
    return jl.LlamaConfig.tiny(compute_dtype=jnp.float32)


def _tcfg():
    return tl.LlamaConfig.tiny(compute_dtype=torch.float32)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


def _assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, b)


def test_commit_window_dense_drops_overhang_like_jax():
    jb = j_make_backend("dense", config=_jcfg(), slots=2, max_len=16, prompt_bucket=8)
    tb = make_kv_backend("dense", config=_tcfg(), slots=2, max_len=16, prompt_bucket=8,
                         device=torch.device("cpu"))
    window = _window(np.random.default_rng(0), _tcfg())
    pos, count = np.asarray([14, 3], np.int32), np.asarray([3, 2], np.int32)
    jout = jb.commit_window(jb.init_device_state(), {k: jnp.asarray(v) for k, v in window.items()},
                            jb.device_tables(), jnp.asarray(pos), jnp.asarray(count))
    tout = tb.commit_window(tb.init_device_state(), {k: _t(v) for k, v in window.items()},
                            tb.device_tables(), _t(pos), _t(count))
    _assert_tree_equal(_tree_np(tout), _tree_np(jout))
    got = _np(tout["k"])
    # slot 0: positions 14, 15 take columns 0, 1; column 2 (position 16) is
    # dropped, not clamped onto 15
    np.testing.assert_array_equal(got[:, 0, 14:16], window["k"][:, 0, :2])
    assert not (got[:, 0, :14] != 0).any() and not (got[:, 1, 5:] != 0).any()


@pytest.mark.parametrize("kind", ["paged", "paged_int8"])
def test_commit_window_paged_routes_overhang_to_null_block_like_jax(kind):
    jb = j_make_backend(kind, config=_jcfg(), slots=2, max_len=16, prompt_bucket=8, block_size=8)
    tb = make_kv_backend(kind, config=_tcfg(), slots=2, max_len=16, prompt_bucket=8,
                         block_size=8, device=torch.device("cpu"))
    for b in (jb, tb):
        b.acquire(0, np.arange(1, 9, dtype=np.int32), 8)
        b.acquire(1, np.arange(10, 18, dtype=np.int32), 4)
    tables = np.asarray(jb.device_tables())
    np.testing.assert_array_equal(_np(tb.device_tables()), tables)
    window = _window(np.random.default_rng(1), _tcfg())
    pos, count = np.asarray([14, 8], np.int32), np.asarray([3, 2], np.int32)
    jout = jb.commit_window(jb.init_device_state(), {k: jnp.asarray(v) for k, v in window.items()},
                            jnp.asarray(tables), jnp.asarray(pos), jnp.asarray(count))
    tout = tb.commit_window(tb.init_device_state(), {k: _t(v) for k, v in window.items()},
                            _t(tables), _t(pos), _t(count))
    got, want = _tree_np(tout), _tree_np(jout)
    # the null block is a garbage sink that several dropped columns hit in
    # no fixed order; every other block must match exactly
    for w in ("k", "v"):
        if kind == "paged":
            _assert_tree_equal(got[w][:, 1:], want[w][:, 1:])
            np.testing.assert_array_equal(got[w][:, tables[0, 1], 6], window[w][:, 0, 0])
            assert not (got[w][:, tables[1, 1], 2:] != 0).any()  # count masks the rest
        else:
            _assert_tree_equal({k: v[:, 1:] for k, v in got[w].items()},
                               {k: v[:, 1:] for k, v in want[w].items()})


def test_block_pool_deferred_registration_matches_jax():
    kw = dict(num_blocks=12, block_size=4, slots=3, blocks_per_row=5)
    jpool, tpool = JPool(**kw), PagedBlockPool(**kw)
    prompt = np.arange(1, 14, dtype=np.int32)  # three full blocks
    ops = [
        ("acquire", 0, prompt, 3, True),
        ("acquire", 1, prompt, 2, False),  # no hit: the prefix is parked
        ("promote", 0, 2),
        ("acquire", 2, prompt, 2, False),  # hits the two promoted blocks
        ("release", 0),  # the parked third registration dies with it
        ("release", 2),
        ("acquire", 0, prompt, 3, True),
        ("release", 1),
        ("promote", 0, None),
        ("release", 0),
    ]
    for op in ops:
        if op[0] == "acquire":
            _, slot, p, budget, defer = op
            jrow, jshared = jpool.acquire(slot, p, budget, defer_register=defer)
            trow, tshared = tpool.acquire(slot, p, budget, defer_register=defer)
            np.testing.assert_array_equal(jrow, trow)
            assert jshared == tshared
        elif op[0] == "promote":
            assert jpool.promote_deferred(op[1], op[2]) == tpool.promote_deferred(op[1], op[2])
        else:
            jpool.release(op[1])
            tpool.release(op[1])
        assert dict(jpool._registry) == dict(tpool._registry)
        assert jpool._deferred == tpool._deferred
        np.testing.assert_array_equal(jpool._ref, tpool._ref)
    assert tpool.stats() == jpool.stats()


# --------------------------------------------------------- llama_verify_step
@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash")
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    jparams = jl.init_llama_params(jcfg, jax.random.key(0))
    tparams = tl.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_apply_rope_window_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    pos = np.asarray([0, 1234], np.int32)
    np.testing.assert_allclose(
        _np(tl.apply_rope_window(_t(x), _t(pos), 500000.0)),
        np.asarray(jl.apply_rope_window(jnp.asarray(x), jnp.asarray(pos), 500000.0)),
        atol=1e-5, rtol=1e-6)  # angles up to ~1.2e3 rad: f32 cos/sin to 1 ulp of the angle


def _prefilled(jcfg, jparams, max_len=32, bs=8):
    """Two prompts' KV as a dense arena and as a block pool (disjoint
    tables), at positions 10 and 16."""
    ids = np.random.default_rng(4).integers(0, 256, size=(2, 16)).astype(np.int32)
    last = np.asarray([9, 15], np.int32)
    _, jcache = jl.llama_prefill_at(jcfg, jparams, jnp.asarray(ids), max_len, jnp.asarray(last))
    dense = {w: np.asarray(jcache[w]) for w in ("k", "v")}
    bpr = max_len // bs
    tables = np.arange(1, 2 * bpr + 1, dtype=np.int32).reshape(2, bpr)
    L, kvh, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    pool = {}
    for w in ("k", "v"):
        p = np.zeros((L, 2 * bpr + 1, bs, kvh, hd), np.float32)
        p[:, tables.reshape(-1)] = dense[w].reshape(L, 2 * bpr, bs, kvh, hd)
        pool[w] = p
    return dense, pool, tables, last + 1


@pytest.mark.parametrize("store,impl", [("dense", None), ("paged", "reference"), ("paged", "kernel"),
                                        ("paged_int8", "reference"), ("paged_int8", "kernel")])
def test_llama_verify_step_matches_jax(model, store, impl):
    jcfg, tcfg, jparams, tparams = model
    dense, pool, tables, pos = _prefilled(jcfg, jparams)
    tokens = np.random.default_rng(5).integers(0, 256, size=(2, 5)).astype(np.int32)
    pos = np.asarray([pos[0], 30], np.int32)  # row 1's window overhangs the 32-position row
    if store == "dense":
        jc = {w: jnp.asarray(dense[w]) for w in dense}
        tc = {w: _t(dense[w].copy()) for w in dense}
        jlay = tlay = None
    else:
        jc = {w: jnp.asarray(pool[w]) for w in pool}
        if store == "paged_int8":
            jc = {w: dict(zip(("q", "s"), j_quantize(jc[w]))) for w in jc}
        tc = {w: ({k: _t(np.asarray(v)) for k, v in jc[w].items()} if isinstance(jc[w], dict)
                  else _t(pool[w].copy())) for w in jc}
        jlay = JLayout(jnp.asarray(tables), 8, jnp.float32,
                       attention_impl="pallas" if impl == "kernel" else "reference")
        tlay = PagedKVLayout(_t(tables), 8, torch.float32, attention_impl=impl)
    before = _tree_np(tc)
    jlog, jwin = jl.llama_verify_step(jcfg, jparams, jc, jnp.asarray(tokens), jnp.asarray(pos),
                                      kv_layout=jlay)
    tlog, twin = tl.llama_verify_step(tcfg, tparams, tc, _t(tokens).long(), _t(pos), kv_layout=tlay)
    tol = dict(atol=2e-4, rtol=2e-4) if store == "paged_int8" else MODEL_TOL
    assert tlog.shape == (2, 5, 256) and tlog.dtype == torch.float32
    # the kernel path's queries past the row (discarded by the engine) see
    # their own keys in the JAX kernel and not in the port's plain version;
    # the reference paths drop those keys on both sides and match in full
    valid = np.ones((2, 5), bool) if impl != "kernel" else pos[:, None] + np.arange(5) < 32
    np.testing.assert_allclose(_np(tlog)[valid], np.asarray(jlog)[valid], **tol)
    for w in ("k", "v"):
        assert twin[w].shape == (tcfg.num_hidden_layers, 2, 5, tcfg.num_key_value_heads, tcfg.head_dim)
        np.testing.assert_allclose(_np(twin[w])[:, valid], np.asarray(jwin[w])[:, valid], **tol)
    _assert_tree_equal(_tree_np(tc), before)  # the cache is read only


def test_int8_decode_step_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    _, pool, tables, pos = _prefilled(jcfg, jparams)
    token = np.asarray([[3], [77]], np.int32)
    jc = {w: dict(zip(("q", "s"), j_quantize(jnp.asarray(pool[w])))) for w in pool}
    for impl, jimpl in (("kernel", "pallas"), ("reference", "reference")):
        tc = {w: {k: _t(np.asarray(v)) for k, v in jc[w].items()} for w in jc}
        jlog, jnew = jl.llama_decode_step(jcfg, jparams, jc, jnp.asarray(token), jnp.asarray(pos),
                                          kv_layout=JLayout(jnp.asarray(tables), 8, jnp.float32,
                                                            attention_impl=jimpl))
        tlog, tnew = tl.llama_decode_step(tcfg, tparams, tc, _t(token).long(), _t(pos),
                                          kv_layout=PagedKVLayout(_t(tables), 8, torch.float32,
                                                                  attention_impl=impl))
        np.testing.assert_allclose(_np(tlog), np.asarray(jlog), atol=2e-4, rtol=2e-4)
        # the committed column's int8 bytes may differ by one code where a
        # value sits on a rounding boundary; its scale by rounding
        for w in ("k", "v"):
            dq = np.abs(_np(tnew[w]["q"]).astype(np.int32) - np.asarray(jnew[w]["q"]).astype(np.int32))
            assert dq.max() <= 1
            np.testing.assert_allclose(_np(tnew[w]["s"]), np.asarray(jnew[w]["s"]), rtol=1e-4)


# ------------------------------------------------------------------ refusals
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


VERIFY_REFUSALS = {
    "window_dtype": (dict(win_dtype=torch.float32), TypeError),
    "int8_without_scales": (dict(pool_dtype=torch.int8), TypeError),
    "one_scale": (dict(scales=("k",)), ValueError),
    "window_shape": (dict(w_win=3), ValueError),
    "not_cuda": (dict(), ValueError),
}


@pytest.mark.parametrize("case", sorted(VERIFY_REFUSALS))
def test_verify_wrapper_refuses_instead_of_falling_back(case):
    opts, exc = VERIFY_REFUSALS[case]
    q = _meta(2, 4, 8, 64)
    pool = _meta(5, 4, 2, 64, dtype=opts.get("pool_dtype", torch.bfloat16))
    win = _meta(2, opts.get("w_win", 4), 2, 64, dtype=opts.get("win_dtype", torch.bfloat16))
    tables = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    pos = torch.zeros((2,), dtype=torch.int32, device="meta")
    scales = {f"{w}_scale": _meta(5, 4, dtype=torch.float32) for w in opts.get("scales", ())}
    with pytest.raises(exc):
        paged_flash_verify(q, pool, pool, win, win, tables, pos, **scales)
