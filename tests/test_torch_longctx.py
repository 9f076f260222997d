"""Chunked prefill and the int8 KV pool in the port against the JAX package
at ``LlamaConfig.tiny`` size in float32.

Exact comparisons: greedy tokens (argmaxes of logits that agree to ~1e-5,
far from any tie at this size), chunk counters and block-pool state. The
int8 engine is held to the JAX int8 engine's greedy tokens exactly and, as
the JAX suite holds it (tests/test_kvcache.py), to at least half of the
dense engine's tokens. JAX engines are built once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu_torch.engine import ContinuousBatchingEngine
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.serving import InferenceServer
from accelerate_tpu_torch.utils.dataclasses import ServingConfig

CHUNK_KW = dict(slots=4, max_len=96, prompt_bucket=16, readback_lag=2, block_size=8,
                prefill_chunk=16)


@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash"), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def _long_prompt(n=64, seed=3):
    return np.random.default_rng(seed).integers(1, 255, size=n).astype(np.int32)


def _shorts(n=2, lens=(5, 11), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 255, size=lens[i % len(lens)]).astype(np.int32) for i in range(n)]


def _run(eng, reqs):
    occs = [eng.insert(p, max_new_tokens=b, pad_token_id=0) for p, b in reqs]
    eng.drain()
    return [list(o.tokens) for o in occs]


def _engine(tmodel, **kw):
    return ContinuousBatchingEngine(tmodel, device="cpu", **{**CHUNK_KW, **kw})


@pytest.fixture(scope="module")
def jax_chunked(models):
    jmodel, _ = models
    reqs = [(_long_prompt(64), 8)] + [(s, 8) for s in _shorts()]
    jeng = JEngine(jmodel, **CHUNK_KW)
    return reqs, _run(jeng, reqs), jeng.stats()["prefill_chunks"]


@pytest.mark.parametrize("kv_cache,impl", [("dense", "reference"), ("paged", "reference"),
                                           ("paged", "kernel")])
def test_chunked_prefill_matches_jax_and_single_shot(models, jax_chunked, kv_cache, impl):
    # the long prompt's chunks interleave with the short requests' decode
    # steps; its masked rows in those steps must never be absorbed
    _, tmodel = models
    reqs, jtokens, jchunks = jax_chunked
    eng = _engine(tmodel, kv_cache=kv_cache, attention_impl=impl)
    assert _run(eng, reqs) == jtokens
    assert eng.stats()["prefill_chunks"] == jchunks == 4
    single = ContinuousBatchingEngine(tmodel, device="cpu", **{
        **CHUNK_KW, "prompt_bucket": 64, "prefill_chunk": None, "kv_cache": kv_cache,
        "attention_impl": impl})
    assert _run(single, reqs) == jtokens
    if kv_cache != "dense":
        assert eng.stats()["kv"]["blocks_active"] == 0


def test_chunk_limit_zero_pauses_progress_then_resumes(models, jax_chunked):
    _, tmodel = models
    reqs, jtokens, _ = jax_chunked
    eng = _engine(tmodel, kv_cache="paged")
    occ = eng.insert(reqs[0][0], max_new_tokens=8, pad_token_id=0)
    short = eng.insert(reqs[1][0], max_new_tokens=8, pad_token_id=0)
    eng.set_prefill_chunk_limit(0)
    pending = eng.prefill_chunks_pending()
    assert pending == 3 and occ.prefilling
    for _ in range(4):  # decode goes on; chunk progress is frozen
        eng.step()
        eng.poll()
    assert eng.prefill_chunks_pending() == pending and occ.prefilling and len(short.tokens) > 0
    assert eng.stats()["prefill_chunk_limit"] == 0
    eng.set_prefill_chunk_limit(2)
    eng.drain()
    assert occ.tokens == jtokens[0] and short.tokens == jtokens[1]


def test_cancel_mid_prefill_frees_slot_and_chunk_queue(models):
    _, tmodel = models
    eng = _engine(tmodel, kv_cache="paged")
    eng.set_prefill_chunk_limit(0)
    occ = eng.insert(_long_prompt(64, seed=6), max_new_tokens=6, pad_token_id=0)
    assert eng.prefill_chunks_pending() > 0
    eng.cancel(occ)
    assert occ.finished and not occ.prefilling
    assert eng.prefill_chunks_pending() == 0
    assert eng.live_count() == 0 and eng.free_slots() == 4
    assert eng.stats()["kv"]["blocks_active"] == 0 and eng._backend.pool._deferred == {}
    # the freed slot admits and completes a fresh request
    eng.set_prefill_chunk_limit(1)
    short = _shorts(1)[0]
    got = _run(eng, [(short, 4)])[0]
    assert got == _run(_engine(tmodel), [(short, 4)])[0]


def test_unchunked_engine_rejects_past_bucket(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, slots=2, max_len=96, prompt_bucket=16, device="cpu")
    with pytest.raises(ValueError, match="engine_prefill_chunk"):
        eng.validate_request(64, 8)
    _engine(tmodel).validate_request(64, 8)
    with pytest.raises(ValueError, match="prefill_chunk"):
        ContinuousBatchingEngine(tmodel, max_len=32, prefill_chunk=32, device="cpu")
    with pytest.raises(ValueError, match="engine_prefill_chunk"):
        ServingConfig(engine_max_len=32, engine_prefill_chunk=32)


def test_chunked_prefix_registers_only_after_the_last_chunk(models):
    # a sharer admitted while the first copy is still prefilling must not
    # hit its unwritten blocks; once the last chunk commits, it may
    _, tmodel = models
    eng = _engine(tmodel, kv_cache="paged", readback_lag=0)
    long = _long_prompt(40, seed=8)
    first = eng.insert(long, max_new_tokens=4, pad_token_id=0)
    assert first.prefilling and eng.stats()["kv"]["prefix_hits"] == 0
    early = eng.insert(long, max_new_tokens=4, pad_token_id=0)
    assert eng.stats()["kv"]["prefix_hits"] == 0
    eng.drain()
    late = eng.insert(long, max_new_tokens=4, pad_token_id=0)
    assert eng.stats()["kv"]["prefix_hits"] == 5  # 40 tokens: five full blocks of 8
    eng.drain()
    assert first.tokens == early.tokens == late.tokens
    assert eng.stats()["prefill_chunks"] == 3 + 3 + 1  # the shared prefix's chunks are skipped


def test_server_serves_long_prompts_in_chunks(models, jax_chunked):
    _, tmodel = models
    reqs, jtokens, _ = jax_chunked
    cfg = ServingConfig(engine_slots=2, engine_max_len=96, engine_prompt_bucket=16,
                        engine_readback_lag=1, kv_cache="paged", engine_block_size=8,
                        attention_impl="kernel", engine_prefill_chunk=16)
    with InferenceServer(tmodel, cfg, device="cpu") as srv:
        futs = [srv.submit(p, max_new_tokens=b, pad_token_id=0) for p, b in reqs]
        res = [f.result(timeout=120) for f in futs]
        assert srv.engine.stats()["prefill_chunks"] == 4
    for (p, _), exp, r in zip(reqs, jtokens, res):
        np.testing.assert_array_equal(r.tokens, np.concatenate([p, exp]))


# ------------------------------------------------------------------ int8 pool
INT8_KW = dict(slots=2, max_len=32, prompt_bucket=16, readback_lag=0, kv_cache="paged_int8",
               block_size=8, pool_blocks=9)


def _int8_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(1, 255, size=n).astype(np.int32) for n in (5, 9)]


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_int8_engine_matches_jax_int8_and_stays_close_to_dense(models, impl):
    jmodel, tmodel = models
    reqs = list(zip(_int8_prompts(), (6, 8)))
    jtok = _run(JEngine(jmodel, **INT8_KW), reqs)
    eng = ContinuousBatchingEngine(tmodel, attention_impl=impl, device="cpu", **INT8_KW)
    assert eng.stats()["kv"]["backend"] == "paged_int8"
    first = _run(eng, reqs)
    eng.reset()
    assert _run(eng, reqs) == first  # deterministic
    assert first == jtok
    dense = _run(ContinuousBatchingEngine(tmodel, device="cpu", **{**INT8_KW, "kv_cache": "dense"}),
                 reqs)
    agree = sum(int(a == b) for x, y in zip(first, dense) for a, b in zip(x, y))
    assert agree / sum(b for _, b in reqs) >= 0.5
    # half the bytes of a bf16 pool, plus one f32 scale per position
    paged = ContinuousBatchingEngine(tmodel, device="cpu", **{**INT8_KW, "kv_cache": "paged"})
    cfg = tmodel.config
    per_pos = cfg.num_key_value_heads * cfg.head_dim
    assert eng.stats()["kv"]["hbm_bytes"] * 4 * per_pos == (
        paged.stats()["kv"]["hbm_bytes"] * (per_pos + 4))


def test_int8_chunked_spec_engine_runs_and_matches_its_plain_form(models):
    # spec with the int8 pool attends the window in full precision and
    # quantizes at commit, so it is compared with itself, not with plain
    # int8 decode: two runs agree, and every token is in the vocabulary
    _, tmodel = models
    kw = dict(CHUNK_KW, kv_cache="paged_int8", attention_impl="kernel", spec="ngram")
    unit = np.random.default_rng(0).integers(1, 50, size=4)
    reqs = [(_long_prompt(40), 10), (np.tile(unit, 3).astype(np.int32), 10)]
    eng = _engine(tmodel, **kw)
    a = _run(eng, reqs)
    eng.reset()
    assert _run(eng, reqs) == a
    # lifetime counters, over both runs
    assert eng.stats()["spec"]["verify_steps"] > 0 and eng.stats()["prefill_chunks"] == 2 * 3
    assert all(0 <= t < tmodel.config.vocab_size and len(x) == 10 for x in a for t in x)
