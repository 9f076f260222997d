"""The port's host-RAM KV tier (``kvcache.HostKVTier``, the spill and the
restore program) against the JAX package at ``LlamaConfig.tiny`` size in
float32.

Exact comparisons: the tier's counters and the engine's restore counters
are integers, restored block bytes are the evicted ones bit for bit, and
greedy tokens are argmaxes of logits that agree to ~1e-5, far from any tie
at this size. The JAX engines run once per configuration (module scope).
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.kvcache import HostKVTier as JTier
from accelerate_tpu.kvcache import PagedBlockPool as JPool
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu_torch.engine import ContinuousBatchingEngine
from accelerate_tpu_torch.kvcache import HostKVTier, PagedBlockPool, make_kv_backend
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.serving import InferenceServer
from accelerate_tpu_torch.utils.dataclasses import ServingConfig

# tests/test_longctx.py's _TIER_SHAPE: a small pool, so a few churn rounds
# evict (and spill) registered blocks
TIER_SHAPE = dict(slots=2, max_len=64, prompt_bucket=16, readback_lag=2, kv_cache="paged",
                  block_size=8, pool_blocks=8, prefill_chunk=16, host_tier_bytes=8 << 20)
COUNTERS = ("spill_blocks", "restore_hits", "restore_misses", "host_tier_dropped", "prefetch_hits")


@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash"), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def _long_prompt(n=40, seed=22):
    return np.random.default_rng(seed).integers(1, 255, size=n).astype(np.int32)


def _churn(eng, rounds, seed, length=12):
    """Distinct short prompts that cycle the free list and evict (spill)
    the LRU cached prefix blocks (tests/test_longctx.py's churn)."""
    for i in range(rounds):
        p = np.random.default_rng(9_000 + seed * 100 + i).integers(1, 255, size=length).astype(np.int32)
        eng.insert(p, max_new_tokens=2, pad_token_id=0)
        eng.drain()


def _scenario(eng, prefetch):
    """A 40-token prompt (five full blocks, chunked), churn that evicts it,
    then the prompt again: one restore. Returns both outputs and the
    counters."""
    prompt = _long_prompt()
    occ = eng.insert(prompt, max_new_tokens=4, pad_token_id=0)
    eng.drain()
    first = occ.output_row()
    _churn(eng, rounds=8, seed=2)
    eng._backend.spill_flush()
    if prefetch:
        eng.prefetch(prompt)
    occ2 = eng.insert(prompt, max_new_tokens=4, pad_token_id=0)
    eng.drain()
    eng._backend.spill_flush()  # the last admission's spills land before the counters are read
    kv = eng.stats()["kv"]
    return first, occ2.output_row(), dict(kv_restores=eng.kv_restores,
                                          **{k: kv[k] for k in COUNTERS})


_JAX_RUNS: dict = {}


def _jax_run(jmodel, kv_cache, prefetch, tier_bytes):
    key = (kv_cache, prefetch, tier_bytes)
    if key not in _JAX_RUNS:
        eng = JEngine(jmodel, **{**TIER_SHAPE, "kv_cache": kv_cache, "host_tier_bytes": tier_bytes})
        _JAX_RUNS[key] = _scenario(eng, prefetch)
    return _JAX_RUNS[key]


@pytest.mark.parametrize("kv_cache,prefetch,tier_blocks", [
    ("paged", False, None), ("paged", True, None), ("paged_int8", False, None),
    ("paged_int8", True, None), ("paged", False, 3)])
def test_restore_counters_and_tokens_match_jax(models, kv_cache, prefetch, tier_blocks):
    # tier_blocks=3: a tier of three blocks keeps only the churn's last
    # spills: the prompt's first block is dropped, and nothing is restored
    jmodel, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, device="cpu", **{**TIER_SHAPE, "kv_cache": kv_cache})
    tier_bytes = TIER_SHAPE["host_tier_bytes"] if tier_blocks is None else (
        tier_blocks * eng._backend.host_block_bytes())
    if tier_blocks is not None:
        eng = ContinuousBatchingEngine(tmodel, device="cpu", **{
            **TIER_SHAPE, "kv_cache": kv_cache, "host_tier_bytes": tier_bytes})
    first, second, counters = _scenario(eng, prefetch)
    jfirst, jsecond, jcounters = _jax_run(jmodel, kv_cache, prefetch, tier_bytes)
    assert counters == jcounters
    restored = tier_blocks is None
    assert counters["kv_restores"] == int(restored) and counters["spill_blocks"] > 0
    assert (counters["host_tier_dropped"] > 0) == (not restored)
    assert counters["prefetch_hits"] == (counters["restore_hits"] if prefetch else 0)
    np.testing.assert_array_equal(first, jfirst)
    np.testing.assert_array_equal(second, jsecond)
    np.testing.assert_array_equal(second, first)
    # the restore is JAX's ("restore", blocks_per_row) signature
    assert eng.stats()["programs"] == {"prefill_insert": 2 + restored, "decode_step": 1}
    assert (("restore", 8) in eng._programs["prefill_insert"]) == restored


def _block(eng, prompt, depth=0):
    blk = eng._backend.pool._registry[prompt[: (depth + 1) * 8].tobytes()]

    def take(leaf):
        if isinstance(leaf, dict):
            return {n: t[:, blk].clone() for n, t in leaf.items()}
        return leaf[:, blk].clone()

    return {w: take(eng._cache[w]) for w in ("k", "v")}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for n in a:
            _assert_same(a[n], b[n])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kv_cache", ["paged", "paged_int8"])
def test_spilled_and_restored_bytes_are_the_evicted_ones(models, kv_cache):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, device="cpu", **{**TIER_SHAPE, "kv_cache": kv_cache})
    tier = eng._backend.host_tier
    prompt = _long_prompt(40, seed=23)
    occ = eng.insert(prompt, max_new_tokens=4, pad_token_id=0)
    eng.drain()
    first = occ.output_row()
    before = [_block(eng, prompt, d) for d in range(5)]
    _churn(eng, rounds=8, seed=3)
    eng._backend.spill_flush()
    assert eng._backend.pool._shared_prefix(prompt) == []
    for d, snap in enumerate(before):  # the tier holds the pool's own bytes
        _assert_same(tier.lookup(prompt[: (d + 1) * 8].tobytes()), snap)
    assert tier.stats()["host_tier_bytes"] == len(tier) * eng._backend.host_block_bytes()
    occ2 = eng.insert(prompt, max_new_tokens=4, pad_token_id=0)
    eng.drain()
    for d, snap in enumerate(before):
        _assert_same(_block(eng, prompt, d), snap)
    np.testing.assert_array_equal(occ2.output_row(), first)
    # the registry and its inverse survived the spills and the restore
    pool = eng._backend.pool
    assert {k: b for b, k in pool._key_of.items()} == dict(pool._registry)


def test_host_block_bytes_of_llama3_8b():
    # K + V of one 16-position block over 32 layers and 8 kv heads of 128
    cfg = LlamaConfig.llama3_8b(compute_dtype=torch.bfloat16)
    kw = dict(config=cfg, slots=1, max_len=2048, prompt_bucket=512, device=torch.device("meta"),
              block_size=16, pool_blocks=64, host_tier_bytes=1 << 30)
    bf16 = make_kv_backend("paged", **kw)
    int8 = make_kv_backend("paged_int8", **kw)
    assert bf16.host_block_bytes() == 2 << 20 and bf16.host_tier.capacity_blocks == 512
    assert int8.host_block_bytes() == 1_052_672
    with pytest.raises(ValueError, match="paged"):
        make_kv_backend("dense", **kw)


def _drive_tier(cls):
    tier = cls(capacity_bytes=300, block_bytes=100)
    keys = [bytes([i]) * 4 for i in range(6)]
    for k in keys[:4]:  # the fourth drops the first
        tier.insert(k, {"k": k})
    seen = [tier.lookup(keys[0]) is None, tier.lookup(keys[2]) is not None]
    tier.count_restore(2)
    tier.insert(keys[4], {"k": keys[4]})  # drops keys[1]: keys[2] was refreshed
    seen += [tier.contains(keys[1]), tier.contains(keys[2]), tier.lookup(keys[5]) is None]
    out = dict(stats=tier.stats(), hot=tier.hot_keys(8), hot1=tier.hot_keys(1), len=len(tier),
               used=tier.bytes_used(), seen=seen)
    tier.clear()
    out["cleared"] = (len(tier), tier.stats())
    empty = cls(capacity_bytes=50, block_bytes=100)
    out["empty"] = (empty.insert(b"x", 1), empty.stats())
    return out


def test_host_tier_matches_jax():
    assert _drive_tier(HostKVTier) == _drive_tier(JTier)
    for cls in (HostKVTier, JTier):
        with pytest.raises(ValueError, match="capacity_bytes"):
            cls(-1, 8)
        with pytest.raises(ValueError, match="block_bytes"):
            cls(8, 0)


def _reregister(cls):
    """tests/test_longctx.py's partial prefix re-registration with the
    spill hook armed: superseding an orphan must not spill it."""
    pool = cls(num_blocks=12, block_size=4, slots=4, blocks_per_row=4)
    spilled = []
    pool.spill_fn = lambda key, blk: spilled.append((key, blk))
    prefix = np.arange(1, 9, dtype=np.int32)
    pool.acquire(0, prefix, budget=4)
    pool.release(0)
    pool.acquire(1, np.array([100], np.int32), budget=11)
    pool.acquire(2, np.array([101], np.int32), budget=15)
    pool.acquire(3, np.array([102], np.int32), budget=11)  # evicts depth 0
    steps = [list(spilled), pool.stats()["blocks_cached"]]
    pool.release(1)
    row, shared = pool.acquire(0, prefix, budget=4)
    steps += [shared, len(spilled), pool.stats()["blocks_cached"],
              {k: b for b, k in pool._key_of.items()} == dict(pool._registry)]
    pool.release(0)
    row2, shared2 = pool.acquire(0, prefix, budget=4)
    steps += [shared2, bool((row2[:2] == row[:2]).all())]
    for slot in (0, 2, 3):
        pool.release(slot)
    big = np.arange(50, 54, dtype=np.int32)
    pool.acquire(0, big, budget=12)
    pool.acquire(1, big + 100, budget=12)
    pool.acquire(2, big + 200, budget=8)  # drains the free list, evicts the prefix
    steps += [pool._shared_prefix(prefix), list(spilled), dict(pool._registry),
              {k: b for b, k in pool._key_of.items()} == dict(pool._registry)]
    return steps


def test_partial_prefix_reregistration_with_spill_hook_armed():
    steps = _reregister(PagedBlockPool)
    assert steps == _reregister(JPool)
    prefix = np.arange(1, 9, dtype=np.int32)
    assert [k for k, _ in steps[0]] == [prefix[:4].tobytes()]
    assert steps[2:4] == [0, 1]  # the orphan superseded without a spill
    assert {k for k, _ in steps[-3]} == {prefix[:4].tobytes(), prefix.tobytes()}
    assert steps[-1]


def test_crash_mid_spill_leaves_the_pool_intact(models, monkeypatch, caplog):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, device="cpu", **TIER_SHAPE)
    prompt = _long_prompt(16, seed=24)
    occ = eng.insert(prompt, max_new_tokens=3, pad_token_id=0)
    eng.drain()
    first = occ.output_row()
    monkeypatch.setenv("ACCELERATE_TPU_FAULT_INJECT", "kvcache.spill_mid:raise")
    with caplog.at_level(logging.ERROR):
        _churn(eng, rounds=6, seed=4)
        eng._backend.spill_flush()  # the worker survives its own crash
    assert any("host-tier spill failed" in r.getMessage() for r in caplog.records)
    assert len(eng._backend.host_tier) == 0
    assert eng._backend.host_tier.stats()["spill_blocks"] == 0
    pool = eng._backend.pool
    assert {k: b for b, k in pool._key_of.items()} == dict(pool._registry)
    occ2 = eng.insert(prompt, max_new_tokens=3, pad_token_id=0)
    eng.drain()
    np.testing.assert_array_equal(occ2.output_row(), first)


def test_an_engine_let_go_is_collected_and_its_spill_thread_ends(models):
    # the spill thread holds the backend weakly: a tiered engine that
    # spilled is freed with its store (on the card: its graphs' memory)
    import gc
    import weakref

    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, device="cpu", **TIER_SHAPE)
    eng.insert(_long_prompt(), max_new_tokens=2, pad_token_id=0)
    eng.drain()
    _churn(eng, rounds=4, seed=5)
    eng._backend.spill_flush()
    thread = eng._backend._spill_thread
    assert thread.is_alive() and len(eng.kv_host_tier) > 0
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
    thread.join(timeout=10)
    assert not thread.is_alive()


def test_reset_keeps_the_tier_and_drops_prefetches(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, device="cpu", **TIER_SHAPE)
    prompt = _long_prompt()
    eng.insert(prompt, max_new_tokens=4, pad_token_id=0)
    eng.drain()
    _churn(eng, rounds=8, seed=2)
    eng._backend.spill_flush()
    held = len(eng.kv_host_tier)
    assert held > 0 and eng.kv_host_tier is eng._backend.host_tier
    eng.prefetch(prompt)
    assert eng._backend._prefetched
    eng.reset()
    assert len(eng.kv_host_tier) == held and eng._backend._prefetched == {}
    occ = eng.insert(prompt, max_new_tokens=4, pad_token_id=0)  # restores after the reset
    eng.drain()
    assert eng.kv_restores == 1 and eng.stats()["kv"]["prefetch_hits"] == 0
    assert len(occ.tokens) == 4


@pytest.mark.parametrize("kv_prefetch", [True, False])
def test_server_host_tier_and_prefetch(models, kv_prefetch):
    jmodel, tmodel = models
    cfg = ServingConfig(mode="continuous", engine_slots=2, engine_max_len=64, engine_prompt_bucket=16,
                        engine_readback_lag=2, kv_cache="paged", engine_block_size=8,
                        engine_pool_blocks=8, engine_prefill_chunk=16, kv_host_tier_bytes=8 << 20,
                        kv_prefetch=kv_prefetch)
    prompt = _long_prompt()
    with InferenceServer(tmodel, cfg, device="cpu") as srv:
        first = srv.submit(prompt, max_new_tokens=4, pad_token_id=0).result(timeout=120)
        for i in range(8):  # the churn, one request at a time
            p = np.random.default_rng(9_200 + i).integers(1, 255, size=12).astype(np.int32)
            srv.submit(p, max_new_tokens=2, pad_token_id=0).result(timeout=120)
        srv.engine._backend.spill_flush()
        again = srv.submit(prompt, max_new_tokens=4, pad_token_id=0).result(timeout=120)
        kv = srv.stats()["kv"]
    _, jsecond, jcounters = _jax_run(jmodel, "paged", kv_prefetch, 8 << 20)
    np.testing.assert_array_equal(again.tokens, first.tokens)
    np.testing.assert_array_equal(again.tokens, jsecond)
    assert srv.engine.kv_restores == 1
    assert kv["restore_hits"] == jcounters["restore_hits"]
    assert kv["prefetch_hits"] == (jcounters["restore_hits"] if kv_prefetch else 0)


def test_serving_config_host_tier_validation():
    base = dict(mode="continuous", engine_max_len=64, engine_prompt_bucket=16)
    with pytest.raises(ValueError, match="kv_host_tier_bytes must be >= 0"):
        ServingConfig(**base, kv_host_tier_bytes=-1)
    with pytest.raises(ValueError, match="requires a paged KV cache"):
        ServingConfig(**base, kv_host_tier_bytes=1 << 20)
    cfg = ServingConfig(**base, kv_cache="paged", engine_block_size=8, kv_host_tier_bytes=1 << 20,
                        kv_prefetch=False)
    assert cfg.kv_host_tier_bytes == 1 << 20 and not cfg.kv_prefetch
