"""Static generation of the PyTorch port against the JAX package, at
``LlamaConfig.tiny`` size in float32 (``attention_impl="flash"`` on both
sides: the Pallas kernel in interpret mode, B1's plain version here).

Greedy tokens, caches, pools and the program keys are compared exactly;
prefill logits within 1e-5. Sampled draws come from different generators
in the two packages, so the sampler is held against JAX's on JAX's own
Gumbel noise, and sampled ``generate`` calls against the JAX tests'
properties (determinism by seed, top-k 1 and a tight nucleus equal to
greedy, top-p 1 and top-k 0 unfiltered).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import inference as jinf
from accelerate_tpu.kvcache import pool_from_dense as jpool_from_dense
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu.models.llama import init_kv_cache as jinit_kv_cache
from accelerate_tpu.models.llama import llama_prefill as jllama_prefill
from accelerate_tpu_torch.inference import (
    generate,
    generate_cache_stats,
    last_generate_stats,
    prepare_inference,
    sample_logits,
)
from accelerate_tpu_torch.kvcache import pool_from_dense
from accelerate_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    init_kv_cache,
    llama_apply,
    llama_decode_step,
    llama_prefill,
    params_from_jax,
)

BACKENDS = ("dense", "paged", "paged_int8")


def _pair(seed=0):
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash"), seed=seed)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


@pytest.fixture(scope="module")
def models():
    return _pair()


def _prompts(b, n, seed=0):
    return np.random.default_rng(seed).integers(4, 256, size=(b, n)).astype(np.int32)


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("kv", BACKENDS)
def test_greedy_tokens_equal_jax(models, kv):
    jmodel, tmodel = models
    ids = _prompts(3, 7)
    kw = dict(kv_backend=kv, kv_block_size=4)
    want = np.asarray(jinf.generate(jmodel, ids, 10, **kw))
    got = generate(tmodel, ids, 10, **kw)
    assert got.dtype == torch.int32 and got.shape == (3, 17)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv", BACKENDS)
def test_eos_pad_and_pad_to_equal_jax_with_wasted_steps(models, kv):
    jmodel, tmodel = models
    ids = _prompts(3, 5, seed=1)
    plain = np.asarray(jinf.generate(jmodel, ids, 8))
    eos = int(plain[0, 6])  # row 0's second new token: it freezes after two steps
    kw = dict(eos_token_id=eos, pad_token_id=3, pad_to=24, kv_backend=kv, kv_block_size=8)
    want = np.asarray(jinf.generate(jmodel, ids, 8, **kw))
    got = generate(tmodel, ids, 8, **kw).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0, 7:] == 3).all()
    assert last_generate_stats(tmodel) == jinf.last_generate_stats(jmodel)
    assert last_generate_stats(tmodel)["wasted_decode_steps"] >= 6


def test_prefill_logits_and_cache_match_jax(models):
    jmodel, tmodel = models
    ids = _prompts(2, 9, seed=2)
    jl, jc = jllama_prefill(jmodel.config, jmodel.params, jnp.asarray(ids), 16)
    tl, tc = llama_prefill(tmodel.config, tmodel.params, torch.from_numpy(ids).long(), 16)
    assert tl.dtype == torch.float32 and tl.shape == (2, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    for name in ("k", "v"):
        assert tc[name].shape == (2, 2, 16, 2, 16)
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=1e-5, atol=1e-6)
    empty = init_kv_cache(tmodel.config, 2, 16, device="cpu")
    jempty = jinit_kv_cache(jmodel.config, 2, 16)
    assert empty["k"].shape == jempty["k"].shape and not empty["k"].any()


@pytest.mark.parametrize("quantized", [False, True])
def test_pool_from_dense_equals_jax_bitwise(models, quantized):
    jmodel, _ = models
    _, jc = jllama_prefill(jmodel.config, jmodel.params, jnp.asarray(_prompts(3, 6)), 12)
    jpool, jtables = jpool_from_dense(jc, 4, quantized=quantized)
    pool, tables = pool_from_dense({k: torch.from_numpy(np.array(v)) for k, v in jc.items()}, 4,
                                   quantized=quantized)
    assert tables.dtype == torch.int32
    np.testing.assert_array_equal(tables.numpy(), np.asarray(jtables))
    for name in ("k", "v"):
        want, got = jpool[name], pool[name]
        pairs = [(got[s], want[s]) for s in ("q", "s")] if quantized else [(got, want)]
        for g, w in pairs:
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="multiple"):
        pool_from_dense({k: torch.from_numpy(np.array(v)) for k, v in jc.items()}, 5, False)


def _jax_sample(temp_on, top_k_width, top_p_on):
    """The JAX ``generate``'s own ``sample`` closure, rebuilt from its code
    object with the three structural choices as its free variables."""
    code = next(c for c in jinf.generate.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "sample")
    cells = {"temp_on": temp_on, "top_k_width": top_k_width, "top_p_on": top_p_on}
    closure = tuple(types.CellType(cells[name]) for name in code.co_freevars)
    return types.FunctionType(code, jinf.generate.__globals__, "sample", None, closure)


def _tied_logits(k, rows=6, v=64):
    """Logits where each row ties its k-th largest value with a lower one,
    and row 0 its two largest."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(rows, v)).astype(np.float32) * 2.0
    order = np.argsort(-x, axis=1)
    for r in range(rows):
        x[r, order[r, k + 1 + r % 3]] = x[r, order[r, k - 1]]
    x[0, order[0, 1]] = x[0, order[0, 0]]
    return x


@pytest.mark.parametrize("temp_on,top_k_width,top_p_on", [
    (False, None, False), (True, None, False), (True, 5, False), (True, 1, False),
    (True, None, True), (True, 5, True),
])
def test_sampler_equals_jax_on_jax_noise(temp_on, top_k_width, top_p_on):
    logits = _tied_logits(top_k_width or 5)
    sample = _jax_sample(temp_on, top_k_width, top_p_on)
    temp, top_p = 0.7, 0.6
    for seed in range(16):  # 96 draws a case
        key = jax.random.key(seed)
        gumbel = jax.random.gumbel(key, logits.shape, jnp.float32)
        # jax.random.categorical is the Gumbel argmax, on any logits (-inf too)
        masked = jnp.where(jnp.asarray(logits) < 0.5, -jnp.inf, jnp.asarray(logits))
        np.testing.assert_array_equal(np.asarray(jax.random.categorical(key, masked, axis=-1)),
                                      np.asarray(jnp.argmax(masked + gumbel, axis=-1)))
        want = np.asarray(sample(jnp.asarray(logits), key, jnp.float32(temp), jnp.float32(top_p)))
        got = sample_logits(torch.from_numpy(logits), torch.from_numpy(np.array(gumbel)),
                            torch.tensor(temp), torch.tensor(top_p), temp_on=temp_on,
                            top_k_width=top_k_width, top_p_on=top_p_on)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_program_keys_and_lru_bound_equal_jax(monkeypatch):
    calls = [
        dict(max_new_tokens=4, temperature=0.7, top_p=0.9, eos_token_id=5),
        dict(max_new_tokens=4, temperature=1.3, top_p=0.8, eos_token_id=5, seed=3),
        dict(max_new_tokens=4),
        dict(max_new_tokens=4, seed=7),
        dict(max_new_tokens=4, kv_backend="paged", kv_block_size=4, top_k=3, temperature=0.5),
    ]
    ids = _prompts(1, 6, seed=3)
    jmodel, tmodel = _pair(seed=1)
    for kw in calls:
        jinf.generate(jmodel, ids, **kw)
        generate(tmodel, ids, **kw)
    stats = generate_cache_stats(tmodel)
    assert stats == jinf.generate_cache_stats(jmodel)
    assert stats["size"] == 3 and stats["max"] == 16  # temperature/top_p/seed/eos ids reuse one
    # the bound is read when a model's cache is first attached
    monkeypatch.setenv("ACCELERATE_GENERATE_CACHE_MAX", "1")
    jfresh, fresh = _pair(seed=2)
    for n in (3, 4):
        jinf.generate(jfresh, ids[:, :n], max_new_tokens=2)
        generate(fresh, ids[:, :n], max_new_tokens=2)
    assert generate_cache_stats(fresh) == jinf.generate_cache_stats(jfresh)
    assert generate_cache_stats(fresh)["size"] == 1 and generate_cache_stats(fresh)["max"] == 1
    assert generate_cache_stats(tmodel)["max"] == 16


def test_quantized_model_is_refused_as_jax_fails_on_it():
    from accelerate_tpu.utils.quantization import QuantizationConfig as JQConfig
    from accelerate_tpu.utils.quantization import quantize_model as jquantize
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_model

    jmodel, tmodel = _pair(seed=3)
    jquantize(jmodel, JQConfig(load_in_8bit=True))
    with pytest.raises(ValueError):  # the JAX decode scans float layer trees only
        jinf.generate(jmodel, np.ones((1, 4), np.int32), max_new_tokens=2)
    quantize_model(tmodel, QuantizationConfig(load_in_8bit=True))
    with pytest.raises(NotImplementedError, match="float trees"):
        generate(tmodel, np.ones((1, 4), np.int32), max_new_tokens=2)


# ------------------------------------ the JAX tests' properties, port only
def test_decode_step_from_init_kv_cache_matches_full_forward(models):
    _, tmodel = models
    cfg, params = tmodel.config, tmodel.params
    ids = torch.from_numpy(_prompts(2, 8, seed=4)).long()
    full = llama_apply(cfg, params, ids)
    cache = init_kv_cache(cfg, 2, 8, device="cpu")
    for t in range(8):
        step, cache = llama_decode_step(cfg, params, cache, ids[:, t:t + 1], torch.tensor(t))
        torch.testing.assert_close(step, full[:, t], atol=1e-4, rtol=1e-4)


def test_greedy_first_token_is_the_forward_argmax(models):
    _, tmodel = models
    ids = _prompts(2, 6, seed=1)
    out = generate(tmodel, ids, max_new_tokens=4)
    assert out.shape == (2, 10)
    full = llama_apply(tmodel.config, tmodel.params, torch.from_numpy(ids).long())
    np.testing.assert_array_equal(out[:, 6].numpy(), full[:, -1].argmax(-1).numpy())


def test_dense_and_paged_greedy_tokens_are_bitwise_equal(models):
    _, tmodel = models
    ids = _prompts(4, 9, seed=6)
    dense = generate(tmodel, ids, 12)
    for block in (4, 16):
        paged = generate(tmodel, ids, 12, kv_backend="paged", kv_block_size=block)
        torch.testing.assert_close(paged, dense, rtol=0, atol=0)


def test_sampling_is_deterministic_by_seed(models):
    _, tmodel = models
    ids = np.ones((1, 4), np.int32)
    a = generate(tmodel, ids, max_new_tokens=5, temperature=1.0, seed=3)
    b = generate(tmodel, ids, max_new_tokens=5, temperature=1.0, seed=3)
    c = generate(tmodel, ids, max_new_tokens=5, temperature=1.0, seed=4)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_top_k_one_and_a_tight_nucleus_are_greedy(models):
    _, tmodel = models
    ids = _prompts(2, 6)
    greedy = generate(tmodel, ids, max_new_tokens=6)
    assert torch.equal(generate(tmodel, ids, max_new_tokens=6, temperature=1.5, top_k=1, seed=3),
                       greedy)
    assert torch.equal(generate(tmodel, ids, max_new_tokens=6, temperature=0.8, top_p=1e-6,
                                seed=5), greedy)


def test_top_p_one_and_top_k_zero_are_unfiltered_and_positional_args_bind(models):
    _, tmodel = models
    ids = _prompts(2, 6)
    plain = generate(tmodel, ids, max_new_tokens=6, temperature=0.8, seed=5)
    assert torch.equal(generate(tmodel, ids, max_new_tokens=6, temperature=0.8, top_p=1.0,
                                seed=5), plain)
    assert torch.equal(generate(tmodel, ids, max_new_tokens=6, temperature=0.8, top_k=0, seed=5),
                       plain)
    assert torch.equal(generate(tmodel, ids, 6, 0.8, 5), plain)


def test_eos_freezes_the_sequence(models):
    _, tmodel = models
    ids = _prompts(3, 5)
    eos = int(generate(tmodel, ids, max_new_tokens=1)[0, 5])
    out = generate(tmodel, ids, max_new_tokens=6, eos_token_id=eos, pad_token_id=1).numpy()
    row = out[0, 5:]
    fired = np.where(row == eos)[0]
    assert fired.size > 0 and (row[fired[0] + 1:] == 1).all()
    assert last_generate_stats(tmodel)["wasted_decode_steps"] >= 5


# --------------------------------------------------------------- refusals
def test_device_mesh_and_model_family_refusals(models):
    _, tmodel = models
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            prepare_inference(tmodel)  # the card by default
    assert prepare_inference(tmodel, device="cpu") is tmodel
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md A8\b"):
        prepare_inference(tmodel, mesh=object(), device="cpu")
    other = types.SimpleNamespace(config=types.SimpleNamespace(vocab_size=8))
    with pytest.raises(NotImplementedError, match=r"gpt2.py.*ROADMAP.md A11\b"):
        generate(other, np.ones((1, 2), np.int32))
    with pytest.raises(ValueError, match="kv_backend"):
        generate(tmodel, np.ones((1, 2), np.int32), kv_backend="paged_fp8")
    with pytest.raises(ValueError, match="kv_block_size"):
        generate(tmodel, np.ones((1, 2), np.int32), kv_backend="paged", kv_block_size=0)


def test_concurrent_calls_share_programs_without_clobbering(models):
    # a program's buffers are shared by every call with its key: threads
    # calling at once must each get their own rows back
    import sys
    import threading

    _, tmodel = models
    prompts = [_prompts(2, 5, seed=s) for s in range(4)]
    want = [generate(tmodel, p, 6, kv_backend=kv).numpy()
            for p in prompts for kv in ("dense", "paged")]
    got, errors = {}, []

    def worker(t):
        try:
            for rep in range(3):
                i = (t + rep) % len(want)
                kv = ("dense", "paged")[i % 2]
                got[(t, rep)] = (i, generate(tmodel, prompts[i // 2], 6, kv_backend=kv).numpy())
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(got) == 24
    for i, out in got.values():
        np.testing.assert_array_equal(out, want[i])
