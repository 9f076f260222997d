"""The port's paged KV pool, continuous-batching engine and server against
the JAX package at ``LlamaConfig.tiny`` size in float32.

Exact comparisons only: block tables, reference counts and free lists are
integers, and greedy tokens are argmaxes of logits that agree to ~1e-5
(test_torch_llama.py), far from any tie at these sizes.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.kvcache import PagedBlockPool as JPool
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu_torch.engine import ContinuousBatchingEngine
from accelerate_tpu_torch.kvcache import PagedBlockPool, PagedKVLayout
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.serving import InferenceServer
from accelerate_tpu_torch.utils.dataclasses import ServingConfig
from accelerate_tpu_torch.utils.fault import (
    EngineCapacityError,
    RequestDeadlineExceeded,
    ServerDrainingError,
    ServerOverloaded,
)

PROMPTS = [
    np.asarray([5, 17, 33, 2, 9], np.int32),
    np.arange(1, 17, dtype=np.int32),  # fills the prompt bucket exactly
    np.asarray([200, 1, 7, 7, 7, 42, 99, 3, 12], np.int32),
]
ENGINE_KW = dict(slots=4, max_len=64, prompt_bucket=16, readback_lag=0,
                 kv_cache="paged", block_size=8)


@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash"), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def _pool_state(pool):
    return (pool.tables.copy(), pool._ref.copy(), list(pool._free), list(pool._cached),
            dict(pool._registry), pool.prefix_hits, pool.prefix_misses)


def _assert_same_pool(jpool, tpool):
    for a, b in zip(_pool_state(jpool), _pool_state(tpool)):
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def test_block_pool_matches_jax_through_acquire_release_cow():
    kw = dict(num_blocks=10, block_size=4, slots=3, blocks_per_row=4)
    jpool, tpool = JPool(**kw), PagedBlockPool(**kw)
    sys_prompt = np.arange(1, 9, dtype=np.int32)  # two full shared blocks
    ops = [
        ("acquire", 0, np.concatenate([sys_prompt, [50, 51]]), 4),
        ("acquire", 1, np.concatenate([sys_prompt, [60]]), 3),  # COW hit on 2 blocks
        ("release", 0),
        ("acquire", 2, np.asarray([9, 9, 9, 9, 9], np.int32), 6),
        ("release", 1),  # shared blocks park in the cached LRU
        ("acquire", 0, np.concatenate([sys_prompt, [70, 71, 72]]), 2),  # hit from cache
        ("release", 2),
        ("acquire", 1, np.asarray([3] * 12, np.int32), 4),  # evicts LRU cached
        ("release", 0),
        ("release", 1),
    ]
    for op in ops:
        if op[0] == "acquire":
            _, slot, prompt, budget = op
            assert jpool.can_admit(prompt, budget) == tpool.can_admit(prompt, budget)
            jrow, jshared = jpool.acquire(slot, prompt, budget)
            trow, tshared = tpool.acquire(slot, prompt, budget)
            np.testing.assert_array_equal(jrow, trow)
            assert jshared == tshared
        else:
            jpool.release(op[1])
            tpool.release(op[1])
        _assert_same_pool(jpool, tpool)
    assert tpool.stats() == jpool.stats()
    with pytest.raises(EngineCapacityError):
        tpool.acquire(0, np.arange(20, dtype=np.int32), 1)  # 6 blocks > a row of 4


def test_layout_commit_follows_in_place_pos_updates():
    # the layout keeps each step's (block, offset) for all layers; an
    # in-place update of pos must not reuse the stale answer
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    layout = PagedKVLayout(tables, 4, torch.float32, attention_impl="kernel")
    pool = torch.zeros(5, 4, 1, 2)
    pos = torch.tensor([3, 5], dtype=torch.int32)
    col = torch.ones(2, 1, 1, 2)
    layout.commit_column(pool, col, pos)
    pos += 1
    layout.commit_column(pool, 2 * col, pos)
    assert pool[1, 3, 0, 0] == 1 and pool[2, 0, 0, 0] == 2  # slot 0: 3 -> 4
    assert pool[4, 1, 0, 0] == 1 and pool[4, 2, 0, 0] == 2  # slot 1: 5 -> 6
    assert pool.sum() == 2 * (1 + 2) * 2


def _run(engine, prompts, max_new_tokens, **kw):
    occs = [engine.insert(p, max_new_tokens=max_new_tokens, **kw) for p in prompts]
    engine.drain()
    return [list(o.tokens) for o in occs]


def test_engine_greedy_tokens_match_jax_engine(models):
    jmodel, tmodel = models
    jeng = JEngine(jmodel, attention_impl="pallas", **ENGINE_KW)
    ref = _run(jeng, PROMPTS, 16)
    for impl in ("kernel", "reference"):
        teng = ContinuousBatchingEngine(tmodel, attention_impl=impl, device="cpu", **ENGINE_KW)
        assert _run(teng, PROMPTS, 16) == ref, impl
        assert teng.stats()["kv"]["blocks_active"] == 0  # every block released
    dense = ContinuousBatchingEngine(tmodel, device="cpu", **{**ENGINE_KW, "kv_cache": "dense"})
    assert _run(dense, PROMPTS, 16) == ref


def test_sampled_stream_depends_only_on_its_own_seed(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, attention_impl="kernel", device="cpu", **ENGINE_KW)
    kw = dict(temperature=0.9, top_k=40, top_p=0.9, seed=11)
    alone = _run(eng, PROMPTS[:1], 12, **kw)[0]
    eng.reset()
    occ = eng.insert(PROMPTS[0], max_new_tokens=12, **kw)
    eng.insert(PROMPTS[1], max_new_tokens=12, temperature=1.0, seed=3)
    eng.insert(PROMPTS[2], max_new_tokens=5)
    eng.drain()
    assert occ.tokens == alone
    # the kernel path and the reference path draw the same tokens
    ref = ContinuousBatchingEngine(tmodel, attention_impl="reference", device="cpu", **ENGINE_KW)
    assert _run(ref, PROMPTS[:1], 12, **kw)[0] == alone


def test_engine_eos_budget_and_cancel(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, attention_impl="kernel", device="cpu",
                                   **{**ENGINE_KW, "readback_lag": 2})
    first = _run(eng, PROMPTS[:1], 8)[0]
    eos = first[3]
    occ = eng.insert(PROMPTS[0], max_new_tokens=8, eos_token_id=eos, pad_token_id=0)
    victim = eng.insert(PROMPTS[1], max_new_tokens=20)
    eng.step()
    eng.cancel(victim)
    assert eng.free_slots() == 3
    eng.drain()
    assert occ.tokens == first[: first.index(eos) + 1]
    row = occ.output_row()
    assert row.shape == (len(PROMPTS[0]) + 8,) and (row[len(PROMPTS[0]) + len(occ.tokens):] == 0).all()
    assert eng.live_count() == 0 and eng.free_slots() == 4


def test_engine_refuses_what_it_cannot_do(models):
    _, tmodel = models
    # speculative decoding, chunked prefill and the int8 pool are ported:
    # they construct (their behaviour: test_torch_spec.py, test_torch_longctx.py)
    eng = ContinuousBatchingEngine(tmodel, spec="ngram", prefill_chunk=8, kv_cache="paged_int8",
                                   attention_impl="kernel", device="cpu", **{
                                       k: v for k, v in ENGINE_KW.items() if k != "kv_cache"})
    assert eng.stats()["kv"]["backend"] == "paged_int8" and eng.stats()["spec"]["mode"] == "ngram"
    eng.validate_request(40, 8)  # past the bucket: chunked
    # still queued, each naming its queue
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        ContinuousBatchingEngine(tmodel, kv_cache="paged", host_tier_bytes=1 << 20, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        eng.prefill_remote(PROMPTS[0], max_new_tokens=4)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A3"):
        eng.insert_prefilled(None)
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(tmodel, attention_impl="kernel", kv_cache="dense", device="cpu")
    eng = ContinuousBatchingEngine(tmodel, device="cpu", **ENGINE_KW)
    with pytest.raises(ValueError, match="bucket"):
        eng.validate_request(17, 4)
    with pytest.raises(ValueError, match="arena"):
        eng.validate_request(16, 60)
    # an out-of-range id would be a device-side fault on the card
    with pytest.raises(ValueError, match="token ids"):
        eng.insert(np.asarray([1, 256], np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="token ids"):
        eng.insert(PROMPTS[0], max_new_tokens=2, pad_token_id=-3)
    assert eng.free_slots() == 4


def test_kernel_engine_refuses_sliding_window(models):
    # no quiet downgrade to the plain paged attention and plain sampler
    _, tmodel = models
    wcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", sliding_window=8)
    windowed = LlamaForCausalLM(wcfg, tmodel.params)
    with pytest.raises(ValueError, match="sliding-window"):
        ContinuousBatchingEngine(windowed, attention_impl="kernel", device="cpu", **ENGINE_KW)
    ContinuousBatchingEngine(windowed, attention_impl="reference", device="cpu", **ENGINE_KW)


def _server(tmodel, **kw):
    cfg = ServingConfig(**{**dict(
        engine_slots=2, engine_max_len=64, engine_prompt_bucket=16, engine_readback_lag=1,
        kv_cache="paged", engine_block_size=8, attention_impl="kernel"), **kw})
    return InferenceServer(tmodel, cfg, device="cpu")


def test_server_answers_requests_like_the_engine(models):
    _, tmodel = models
    eng = ContinuousBatchingEngine(tmodel, attention_impl="kernel", device="cpu", **ENGINE_KW)
    expected = _run(eng, PROMPTS, 10)
    with _server(tmodel) as srv:
        futs = [srv.submit(p, max_new_tokens=10) for p in PROMPTS]
        futs.append(srv.submit(PROMPTS[0], max_new_tokens=6, temperature=0.8, top_p=0.9, seed=4))
        results = [f.result(timeout=120) for f in futs]
    for p, exp, res in zip(PROMPTS, expected, results):
        np.testing.assert_array_equal(res.tokens, np.concatenate([p, exp]))
        assert res.ttft_s is not None and res.latency_s >= res.ttft_s
    assert results[-1].tokens.shape == (len(PROMPTS[0]) + 6,)
    snap = srv.metrics.snapshot()
    assert snap["serving/completed"] == 4 and snap["serving/engine_inserts"] == 4


def test_server_backpressure_deadline_and_drain(models):
    _, tmodel = models
    srv = _server(tmodel, max_queue=2)
    gate = threading.Event()
    real_step = srv.engine.step

    def held_step():
        gate.wait(timeout=30)
        return real_step()

    srv.engine.step = held_step
    try:
        first = srv.submit(PROMPTS[0], max_new_tokens=4)
        late = srv.submit(PROMPTS[1], max_new_tokens=4, deadline_s=0.0)
        with pytest.raises(ServerOverloaded):
            for _ in range(4):
                srv.submit(PROMPTS[2], max_new_tokens=4)
        gate.set()
        assert first.result(timeout=120).tokens.shape == (len(PROMPTS[0]) + 4,)
        with pytest.raises(RequestDeadlineExceeded):
            late.result(timeout=120)
    finally:
        gate.set()
        srv.close()
    with pytest.raises(ServerDrainingError):
        srv.submit(PROMPTS[0], max_new_tokens=4)
    assert not srv._worker.is_alive()


def test_serving_config_validation():
    with pytest.raises(NotImplementedError, match="continuous"):
        ServingConfig(mode="static")
    with pytest.raises(ValueError, match="paged"):
        ServingConfig(attention_impl="kernel", kv_cache="dense")
    ServingConfig(attention_impl="kernel", kv_cache="paged_int8", speculative="ngram",
                  engine_prefill_chunk=64)
    with pytest.raises(ValueError, match="kv_cache"):
        ServingConfig(kv_cache="paged_fp8")
    with pytest.raises(ValueError, match="multiple"):
        ServingConfig(kv_cache="paged", engine_max_len=100, engine_block_size=16)
    with pytest.raises(ValueError, match="attention_impl"):
        ServingConfig(attention_impl="pallas")
