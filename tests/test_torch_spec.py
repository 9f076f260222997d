"""Speculative decoding in the port against the JAX package at
``LlamaConfig.tiny`` size in float32.

* Greedy tokens: exact. A spec engine's greedy tokens equal the JAX spec
  engine's and the port's plain engine's, on the dense arena, the paged
  pool and the kernel path (the verify kernel's plain version on the CPU),
  and the drafted / accepted / verify-step counters equal the JAX
  engine's (both drafters see the same histories). The logits agree to
  ~1e-5 (test_torch_paged_verify.py), far from any tie at this size.
* Budget, EOS inside a window, a budget of one, the acceptance-EWMA gate
  and the runtime draft limit, as the JAX suite checks them
  (tests/test_spec.py).
* Rejection sampling: the port's per-slot random numbers are not
  ``jax.random``'s, so the sampled path is checked against its target
  instead: over 20,000 draws the first emitted token's frequencies match
  the filtered distribution within 0.02 (5 standard deviations of a
  frequency at 20,000 draws is at most 0.018).
* Reproducibility: a sampled request draws the same tokens alone and
  packed with strangers whose drafts turn steps into verify steps.

JAX engines are built once per module.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu_torch.engine import ContinuousBatchingEngine, _filter_logits, _verify_accept
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.serving import InferenceServer
from accelerate_tpu_torch.utils.dataclasses import ServingConfig

ENGINE_KW = dict(slots=4, max_len=64, prompt_bucket=16, readback_lag=0, block_size=8)


@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash"), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def _rep_prompts(n, seed=0, unit=4, reps=3):
    """Each prompt a random ``unit``-token block tiled ``reps`` times: the
    n-gram drafter's best case."""
    rng = np.random.default_rng(seed)
    return [np.tile(rng.integers(1, 50, size=unit), reps).astype(np.int32) for _ in range(n)]


def _run(eng, prompts, budget, **kw):
    occs = [eng.insert(p, max_new_tokens=budget, pad_token_id=0, **kw) for p in prompts]
    eng.drain()
    return [list(o.tokens) for o in occs]


def _counters(eng):
    s = eng.stats()["spec"]
    return {k: s[k] for k in ("drafted", "accepted", "wasted", "verify_steps")}


def _port(tmodel, **kw):
    return ContinuousBatchingEngine(tmodel, device="cpu", **{**ENGINE_KW, "kv_cache": "paged", **kw})


@pytest.fixture(scope="module")
def jax_spec(models):
    """The JAX spec engine's tokens and counters on the greedy mix."""
    jmodel, _ = models
    prompts = _rep_prompts(3, seed=0) + [np.asarray([5, 17, 33, 2, 9], np.int32)]
    jeng = JEngine(jmodel, spec="ngram", **ENGINE_KW)
    return prompts, _run(jeng, prompts, 20), _counters(jeng)


@pytest.mark.parametrize("kv_cache,impl", [("dense", "reference"), ("paged", "reference"),
                                           ("paged", "kernel"), ("paged_int8", "kernel")])
def test_greedy_spec_tokens_and_counters_match_jax(models, jax_spec, kv_cache, impl):
    _, tmodel = models
    prompts, jtokens, jcounts = jax_spec
    eng = _port(tmodel, spec="ngram", kv_cache=kv_cache, attention_impl=impl)
    toks = _run(eng, prompts, 20)
    plain = _run(_port(tmodel, kv_cache=kv_cache, attention_impl=impl), prompts, 20)
    assert toks == plain  # speculation never changes greedy output
    counts = _counters(eng)
    assert counts["verify_steps"] > 0 and counts["accepted"] > 0
    assert counts["accepted"] + counts["wasted"] == counts["drafted"]
    if kv_cache == "paged_int8":
        return  # the int8 pool is its own model of the KV (test_torch_longctx.py)
    assert toks == jtokens
    assert counts == jcounts


def test_spec_budget_exact_and_eos_inside_window_retires(models):
    _, tmodel = models
    eng = _port(tmodel, spec="ngram", attention_impl="kernel")
    p = _rep_prompts(1, seed=7)[0]
    full = _run(eng, [p], 8)[0]
    assert len(full) == 8  # exact even when drafts overshoot the budget
    eos = full[2]
    stop = full.index(eos)
    eng.reset()
    occ = eng.insert(p, max_new_tokens=8, eos_token_id=eos, pad_token_id=0)
    eng.drain()
    assert occ.tokens == full[: stop + 1]  # up to and including the EOS
    plain = _port(tmodel, attention_impl="kernel")
    ref = plain.insert(p, max_new_tokens=8, eos_token_id=eos, pad_token_id=0)
    plain.drain()
    np.testing.assert_array_equal(occ.output_row(), ref.output_row())


def test_spec_tiny_budget_never_overcommits(models):
    _, tmodel = models
    eng = _port(tmodel, spec="ngram")
    p = _rep_prompts(1, seed=9)[0]
    out = _run(eng, [p], 1)[0]
    assert len(out) == 1 and eng.stats()["spec"]["verify_steps"] == 0
    assert out == _run(_port(tmodel), [p], 1)[0]


def test_acceptance_ewma_gate_falls_back_then_reprobes(models):
    _, tmodel = models
    eng = _port(tmodel, spec="ngram")
    p = _rep_prompts(1, seed=17)[0]
    occ = eng.insert(p, max_new_tokens=16, pad_token_id=0)
    occ.spec_ewma = 0.0  # a collapsed acceptance history
    for _ in range(eng._SPEC_COOLDOWN - 1):
        eng.step()
        eng.poll()
    assert eng.stats()["spec"]["verify_steps"] == 0  # gated: plain decode steps
    eng.drain()
    assert eng.stats()["spec"]["verify_steps"] > 0  # the cooldown ran out: a probe
    assert occ.spec_ewma >= eng._SPEC_MIN_ACCEPT * (1 - eng._SPEC_EWMA_ALPHA)
    assert occ.tokens == _run(_port(tmodel), [p], 16)[0]


def test_set_spec_draft_limit_clamps_at_runtime(models):
    _, tmodel = models
    eng = _port(tmodel, spec="ngram")
    p = _rep_prompts(1, seed=19)[0]
    eng.set_spec_draft_limit(0)
    out = _run(eng, [p], 12)[0]
    assert eng.stats()["spec"]["verify_steps"] == 0
    assert eng.stats()["spec"]["draft_limit"] == 0
    eng.set_spec_draft_limit(99)  # clipped to spec_draft_len
    assert _run(eng, [p], 12)[0] == out
    assert eng.stats()["spec"]["verify_steps"] > 0
    assert eng.stats()["spec"]["draft_limit"] == eng.spec_draft_len


@pytest.mark.parametrize("impl", ["reference", "kernel"])
def test_sampled_seed_reproducible_alone_vs_packed_with_spec(models, impl):
    _, tmodel = models
    p = _rep_prompts(1, seed=11)[0]
    kw = dict(temperature=0.9, top_p=0.95, top_k=40, seed=123)
    alone_eng = _port(tmodel, spec="ngram", attention_impl=impl)
    alone = _run(alone_eng, [p], 10, **kw)[0]
    packed = _port(tmodel, spec="ngram", attention_impl=impl, readback_lag=2)
    packed.insert(np.asarray([7, 7, 7], np.int32), max_new_tokens=12, temperature=1.3, seed=999,
                  pad_token_id=0)
    mine = packed.insert(p, max_new_tokens=10, pad_token_id=0, **kw)
    packed.insert(np.tile([3, 4], 5).astype(np.int32), max_new_tokens=9, pad_token_id=0)
    packed.drain()
    assert packed.stats()["spec"]["verify_steps"] > 0
    assert mine.tokens == alone
    alone_eng.reset()
    assert _run(alone_eng, [p], 10, **kw)[0] == alone


@pytest.mark.parametrize("case", ["plain", "top_k_top_p", "draft_outside_support"])
def test_rejection_sampling_matches_the_target_distribution(case):
    n, v, k = 20000, 8, 2
    gen = torch.Generator().manual_seed(0)
    base = torch.tensor([1.2, 0.3, -0.5, 2.0, 0.0, -1.0, 0.8, 0.1])
    logits = base.expand(n, k + 1, v).contiguous()
    temp = torch.full((n,), 0.7)
    top_k = torch.full((n,), 5 if case != "plain" else 0, dtype=torch.int32)
    top_p = torch.full((n,), 0.9 if case != "plain" else 1.0)
    target = torch.softmax(_filter_logits(base[None], temp[:1], top_k[:1], top_p[:1])[0], dim=-1)
    d0 = 5 if case == "draft_outside_support" else 0  # token 5 is filtered out
    assert (target[d0] == 0) == (case == "draft_outside_support")
    draft = torch.tensor([d0, 3]).expand(n, k)
    dlen = torch.full((n,), k)
    u = torch.rand((n, k), generator=gen)
    noise = -torch.log(-torch.log(torch.rand((n, v), generator=gen).clamp_min(1e-38)))
    emitted, a = _verify_accept(logits, draft, dlen, temp, top_k, top_p, u, noise)
    freq = torch.bincount(emitted[:, 0], minlength=v).float() / n
    assert (freq - target).abs().max().item() <= 0.02
    assert freq[target == 0].sum().item() == 0.0  # never a filtered-out token
    # greedy rows accept exactly the argmax
    g, _ = _verify_accept(logits[:2], torch.tensor([[3, 3], [0, 3]]), dlen[:2], torch.zeros(2),
                          top_k[:2], top_p[:2], u[:2], noise[:2])
    assert g[0].tolist() == [3, 3, 3] and g[1].tolist() == [3, 3, 3]


def test_server_spec_and_engine_agree(models):
    _, tmodel = models
    prompts = _rep_prompts(4, seed=31, unit=2, reps=6)
    budgets = [12, 8, 10, 6]
    expected = [_run(_port(tmodel, attention_impl="kernel"), [p], b)[0] for p, b in zip(prompts, budgets)]
    cfg = ServingConfig(mode="continuous", engine_slots=2, engine_max_len=64,
                        engine_prompt_bucket=16, engine_readback_lag=2, kv_cache="paged", engine_block_size=8,
                        attention_impl="kernel", speculative="ngram", spec_draft_len=3)
    with InferenceServer(tmodel, cfg, device="cpu") as srv:
        res = [srv.submit(p, max_new_tokens=b, pad_token_id=0) for p, b in zip(prompts, budgets)]
        res = [f.result(timeout=120) for f in res]
        spec = srv.engine.stats()["spec"]
    for p, exp, r in zip(prompts, expected, res):
        np.testing.assert_array_equal(r.tokens, np.concatenate([p, exp]))
    assert spec["draft_len"] == 3 and spec["drafted"] > 0 and spec["tokens_per_step"] >= 1.0


def test_spec_stats_and_knob_validation(models):
    _, tmodel = models
    s = _port(tmodel, spec="ngram").stats()["spec"]
    assert s["mode"] == "ngram" and s["draft_len"] == 4
    for key in ("drafted", "accepted", "wasted", "verify_steps", "acceptance_rate",
                "acceptance_ewma", "tokens_per_step", "draft_limit"):
        assert key in s
    off = _port(tmodel).stats()["spec"]
    assert off["mode"] == "off" and off["draft_len"] == 0
    with pytest.raises(ValueError, match="spec must be"):
        ContinuousBatchingEngine(tmodel, slots=1, max_len=8, spec="medusa", device="cpu")
    with pytest.raises(ValueError, match="spec_draft_len"):
        ContinuousBatchingEngine(tmodel, slots=1, max_len=8, spec="ngram", spec_draft_len=0,
                                 device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        ServingConfig(mode="continuous", speculative="eagle")
    with pytest.raises(ValueError, match="spec_draft_len"):
        ServingConfig(mode="continuous", speculative="ngram", spec_draft_len=0)
    ServingConfig(mode="continuous", spec_draft_len=0)  # inert while speculation is off
