"""The port engine's programs against the JAX engine's compiled programs,
at ``LlamaConfig.tiny`` size on the CPU.

The JAX engine compiles "exactly two jitted programs per (slots,
max_len)", ``prefill_insert (bucket,)`` and ``decode_step ()``, plus
``verify_step (k,)`` with ``spec="ngram"`` and ``prefill_insert
("chunk", chunk)`` with ``prefill_chunk``, and reports them in
``stats()["programs"]`` (tests/test_engine.py pins the count under mixed
traffic). The port records the same signatures; on CUDA each is one
captured graph, on the CPU the same bodies run eagerly. The traffic is
tests/test_engine.py's: greedy and sampled requests with several seeds,
temperatures, top-k and top-p, every prompt length and budget.
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

ENGINE_KW = dict(slots=4, max_len=64, prompt_bucket=16, readback_lag=2)


@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32)
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def _mixed_traffic(eng, long_prompts=(), budget=6):
    """tests/test_engine.py::test_mixed_traffic_compiles_exactly_two_programs,
    then ``long_prompts`` (chunked prefill, or drafter-friendly ones) with
    ``budget`` new tokens each."""
    rng = np.random.default_rng(11)
    for i in range(6):
        if eng.free_slots() == 0:
            eng.drain()
        plen = int(rng.integers(1, 16))
        eng.insert(
            rng.integers(1, 255, size=plen).tolist(),
            max_new_tokens=int(rng.integers(1, 12)),
            temperature=float(i % 3) * 0.5,
            top_k=int(rng.integers(0, 50)) or None,
            top_p=0.9 if i % 2 else None,
            seed=i * 17,
            pad_token_id=0,
        )
        if i % 2:
            eng.step()
            eng.poll()
    for p in long_prompts:
        if eng.free_slots() == 0:
            eng.drain()
        eng.insert(p, max_new_tokens=budget, pad_token_id=0)
    eng.drain()
    return eng.stats()


def _both(models, long_prompts=(), budget=6, **kw):
    jmodel, tmodel = models
    jstats = _mixed_traffic(JEngine(jmodel, **{**ENGINE_KW, **kw}), long_prompts, budget)
    tstats = _mixed_traffic(ContinuousBatchingEngine(tmodel, device="cpu", **{**ENGINE_KW, **kw}),
                            long_prompts, budget)
    return jstats, tstats


@pytest.mark.parametrize("kv_cache", ["dense", "paged", "paged_int8"])
def test_mixed_traffic_runs_exactly_two_programs(models, kv_cache):
    jstats, tstats = _both(models, kv_cache=kv_cache)
    assert tstats["programs"] == jstats["programs"] == {"prefill_insert": 1, "decode_step": 1}
    assert tstats["program_count"] == jstats["program_count"] <= 2


def test_spec_adds_the_verify_program(models):
    # drafter-friendly tiled prompts make some steps verify steps
    rng = np.random.default_rng(3)
    tiled = [np.tile(rng.integers(1, 50, size=4), 3).astype(np.int32) for _ in range(3)]
    jstats, tstats = _both(models, long_prompts=tiled, budget=16, spec="ngram", spec_draft_len=3,
                           kv_cache="paged")
    assert tstats["spec"]["verify_steps"] > 0 and jstats["spec"]["verify_steps"] > 0
    assert tstats["programs"] == jstats["programs"] == {
        "prefill_insert": 1, "decode_step": 1, "verify_step": 1}
    assert tstats["program_count"] == jstats["program_count"] == 3


@pytest.mark.parametrize("kv_cache", ["dense", "paged"])
def test_chunked_prefill_adds_the_chunk_signature(models, kv_cache):
    rng = np.random.default_rng(4)
    long = [rng.integers(1, 255, size=n).astype(np.int32) for n in (30, 41)]
    jstats, tstats = _both(models, long_prompts=long, prefill_chunk=8, kv_cache=kv_cache)
    assert tstats["prefill_chunks"] == jstats["prefill_chunks"] > 0
    assert tstats["programs"] == jstats["programs"] == {"prefill_insert": 2, "decode_step": 1}
    assert tstats["program_count"] == jstats["program_count"] == 3


def test_the_server_reports_the_engine_programs(models):
    _, tmodel = models
    cfg = ServingConfig(mode="continuous", engine_slots=2, engine_max_len=32, engine_prompt_bucket=8,
                        kv_cache="paged", engine_block_size=8)
    with InferenceServer(tmodel, cfg, device="cpu") as srv:
        srv.generate(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
        stats = srv.stats()
    assert stats["programs"] == {"prefill_insert": 1, "decode_step": 1}
    assert stats["program_count"] == 2 and stats["serving"]["serving/completed"] == 1
