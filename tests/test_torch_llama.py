"""The port's Llama serving path against the JAX package at
``LlamaConfig.tiny`` size in float32: the same parameters (converted with
``params_from_jax``) and the same numpy-seeded tokens go through both.

Tolerances: RoPE and norms atol = rtol = 1e-6 (elementwise f32, same
formula); logits and KV of the 2-layer model atol = rtol = 1e-4, because
the projections' f32 matmuls sum in a different order in XLA and in
PyTorch, and those differences pass through two layers and the head.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.kvcache import PagedKVLayout as JLayout
from accelerate_tpu.models import llama as jl
from accelerate_tpu_torch.kvcache import PagedKVLayout
from accelerate_tpu_torch.models import llama as tl

EXACT_TOL = dict(atol=1e-6, rtol=1e-6)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _configs(**kw):
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash", **kw)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    jparams = jl.init_llama_params(jcfg, jax.random.key(0))
    tparams = tl.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    return jcfg, tcfg, jparams, tparams


def _np(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("scaling", [None, {"rope_type": "llama3", "factor": 8.0,
                                            "original_max_position_embeddings": 64}])
def test_rope_prefill_and_decode_match_jax(scaling):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 4, 16)).astype(np.float32)
    key = None if scaling is None else tuple(sorted(scaling.items()))
    np.testing.assert_allclose(
        _np(tl.apply_rope(torch.from_numpy(x), 3, 500000.0, scaling=key)),
        np.asarray(jl.apply_rope(jnp.asarray(x), 3, 500000.0, scaling=key)), **EXACT_TOL)
    pos = np.asarray([0, 37], np.int32)
    xd = x[:, :1]
    np.testing.assert_allclose(
        _np(tl.apply_rope_at(torch.from_numpy(xd), torch.from_numpy(pos), 500000.0, key)),
        np.asarray(jl.apply_rope_at(jnp.asarray(xd), jnp.asarray(pos), 500000.0, key)), **EXACT_TOL)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    for offset in (False, True):
        np.testing.assert_allclose(
            _np(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5, offset)),
            np.asarray(jl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)), **EXACT_TOL)


def test_init_params_tree_matches_jax():
    jcfg, tcfg = _configs(attention_bias=True)
    jparams = jl.init_llama_params(jcfg, jax.random.key(0))
    tparams = tl.init_llama_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    jflat = {jax.tree_util.keystr(p): v.shape for p, v in jax.tree_util.tree_leaves_with_path(jparams)}
    tflat = {"".join(f"['{k}']" for k in path): tuple(v.shape) for path, v in tl._flatten(tparams)}
    assert jflat == tflat
    emb = tparams["embed_tokens"]["embedding"]
    assert abs(emb.std().item() - 0.02) < 0.002


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_at_logits_and_kv_match_jax(model, impl):
    jcfg, tcfg, jparams, tparams = model
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl=impl)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl=impl)
    ids = np.random.default_rng(2).integers(0, 256, size=(2, 16)).astype(np.int32)
    last = np.asarray([9, 15], np.int32)
    jlog, jcache = jl.llama_prefill_at(jcfg, jparams, jnp.asarray(ids), 32, jnp.asarray(last))
    tlog, tcache = tl.llama_prefill_at(tcfg, tparams, torch.from_numpy(ids).long(), 32, torch.from_numpy(last))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **MODEL_TOL)
    for w in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[w]), np.asarray(jcache[w]), **MODEL_TOL)


def test_llama_apply_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    ids = np.random.default_rng(3).integers(0, 256, size=(1, 12)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tl.LlamaForCausalLM(tcfg, tparams)(torch.from_numpy(ids).long())),
        np.asarray(jl.llama_apply(jcfg, jparams, jnp.asarray(ids))), **MODEL_TOL)


def _paged_setup(jcfg, jparams, tcfg, tparams, bs=8, max_len=32):
    """Prefill two prompts, lay their KV into a block pool through disjoint
    tables, and return everything a decode step needs on both sides."""
    ids = np.random.default_rng(4).integers(0, 256, size=(2, 16)).astype(np.int32)
    last = np.asarray([9, 15], np.int32)
    jlog, jcache = jl.llama_prefill_at(jcfg, jparams, jnp.asarray(ids), max_len, jnp.asarray(last))
    bpr = max_len // bs
    tables = np.arange(1, 2 * bpr + 1, dtype=np.int32).reshape(2, bpr)
    L, kvh, hd = jcfg.num_hidden_layers, jcfg.num_key_value_heads, jcfg.head_dim
    pool = {}
    for w in ("k", "v"):
        p = np.zeros((L, 2 * bpr + 1, bs, kvh, hd), np.float32)
        dense = np.asarray(jcache[w]).reshape(L, 2, bpr, bs, kvh, hd)
        p[:, tables.reshape(-1)] = dense.reshape(L, 2 * bpr, bs, kvh, hd)
        pool[w] = p
    token = np.array(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
    pos = last + 1
    return pool, tables, token, pos


@pytest.mark.parametrize("impl", ["kernel", "reference"])
def test_paged_decode_step_matches_jax(model, impl):
    jcfg, tcfg, jparams, tparams = model
    pool, tables, token, pos = _paged_setup(jcfg, jparams, tcfg, tparams)
    jimpl = "pallas" if impl == "kernel" else "reference"
    jlayout = JLayout(jnp.asarray(tables), 8, jnp.float32, attention_impl=jimpl)
    jlog, jcache = jl.llama_decode_step(
        jcfg, jparams, {w: jnp.asarray(pool[w]) for w in pool}, jnp.asarray(token),
        jnp.asarray(pos), kv_layout=jlayout)
    tlayout = PagedKVLayout(torch.from_numpy(tables), 8, torch.float32, attention_impl=impl)
    tcache = {w: torch.from_numpy(pool[w].copy()) for w in pool}
    tlog, tcache = tl.llama_decode_step(
        tcfg, tparams, tcache, torch.from_numpy(token).long(), torch.from_numpy(pos), kv_layout=tlayout)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **MODEL_TOL)
    for w in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[w]), np.asarray(jcache[w]), **MODEL_TOL)


def test_dense_decode_step_matches_jax(model):
    jcfg, tcfg, jparams, tparams = model
    ids = np.random.default_rng(5).integers(0, 256, size=(2, 8)).astype(np.int32)
    jlog, jcache = jl.llama_prefill(jcfg, jparams, jnp.asarray(ids), 16)
    token = np.array(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
    pos = np.asarray([8, 8], np.int32)
    jlog2, jcache2 = jl.llama_decode_step(jcfg, jparams, jcache, jnp.asarray(token), jnp.asarray(pos))
    tcache = {w: torch.from_numpy(np.array(jcache[w])) for w in ("k", "v")}
    tlog2, tcache2 = tl.llama_decode_step(tcfg, tparams, tcache, torch.from_numpy(token).long(),
                                          torch.from_numpy(pos))
    np.testing.assert_allclose(_np(tlog2), np.asarray(jlog2), **MODEL_TOL)
    np.testing.assert_allclose(_np(tcache2["k"]), np.asarray(jcache2["k"]), **MODEL_TOL)


def test_moe_and_alternating_window_are_queued():
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="MoE"):
        tl.init_llama_params(tl.LlamaConfig.tiny(num_experts=4), gen, device="cpu")
    with pytest.raises(NotImplementedError, match="alternating"):
        tl.init_llama_params(tl.LlamaConfig.gemma2_9b(num_hidden_layers=2), gen, device="cpu")


def test_config_takes_every_field_of_the_jax_config():
    import dataclasses

    jax_fields = {f.name for f in dataclasses.fields(jl.LlamaConfig)}
    assert jax_fields == {f.name for f in dataclasses.fields(tl.LlamaConfig)}
    # the JAX package's defaults, except the dtype fields (jnp against torch)
    jdef, tdef = jl.LlamaConfig(), tl.LlamaConfig()
    for name in jax_fields - {"param_dtype", "compute_dtype"}:
        assert getattr(tdef, name) == getattr(jdef, name), name
    for preset in ("mixtral_8x7b", "llama3_8b", "mistral_7b", "gemma2_9b"):
        jcfg, tcfg = getattr(jl.LlamaConfig, preset)(), getattr(tl.LlamaConfig, preset)()
        for name in jax_fields - {"param_dtype", "compute_dtype"}:
            assert getattr(tcfg, name) == getattr(jcfg, name), (preset, name)


# field overrides -> (what the refusal names, its queue item)
UNPORTED_CONFIGS = {
    "moe": (dict(num_experts=4, num_experts_per_tok=1, expert_capacity_factor=2.0,
                 moe_aux_loss_coef=0.1, router_z_loss_coef=1e-3), "MoE", "A11"),
    "fp8": (dict(use_fp8=True), "use_fp8", "A4"),
    "chunked_ce": (dict(use_chunked_ce=True, ce_chunk_size=64), "use_chunked_ce", "A4"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED_CONFIGS))
def test_unported_config_fields_are_refused_by_item(case):
    overrides, what, item = UNPORTED_CONFIGS[case]
    cfg = tl.LlamaConfig.tiny(**overrides)  # builds, as the JAX config does
    with pytest.raises(NotImplementedError, match=rf"{what}.*ROADMAP.md {item}\b"):
        tl.create_llama(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=rf"ROADMAP.md {item}\b"):
        tl.llama_apply(cfg, {}, torch.zeros((1, 4), dtype=torch.long))


def test_mixtral_preset_builds_and_is_refused_at_model_creation():
    cfg = tl.LlamaConfig.mixtral_8x7b(num_hidden_layers=2)
    assert (cfg.num_experts, cfg.num_experts_per_tok) == (8, 2)
    with pytest.raises(NotImplementedError, match=r"MoE.*ROADMAP.md A11"):
        tl.create_llama(cfg, device="cpu")
    with pytest.raises(ValueError, match="silu"):
        tl.LlamaConfig.mixtral_8x7b(hidden_act="gelu_tanh")


def test_tpu_only_knobs_are_no_ops():
    gen = torch.Generator().manual_seed(0)
    base = tl.LlamaConfig.tiny(compute_dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 256, size=(1, 8)))
    params = tl.init_llama_params(base, gen, device="cpu")
    ref = tl.llama_apply(base, params, ids)
    knobs = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_block_q=16, scan_layers=False)
    torch.testing.assert_close(tl.llama_apply(knobs, params, ids), ref, atol=0, rtol=0)


def test_kernel_decode_refuses_sliding_window(model):
    # the paged flash-decode kernel walks the whole live table: a windowed
    # config must be refused, not quietly sent through the plain attention
    _, tcfg, _, tparams = model
    wcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", sliding_window=4)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    layout = PagedKVLayout(tables, 8, torch.float32, attention_impl="kernel")
    shape = (tcfg.num_hidden_layers, 3, 8, tcfg.num_key_value_heads, tcfg.head_dim)
    cache = {w: torch.zeros(shape) for w in ("k", "v")}
    with pytest.raises(ValueError, match="sliding-window"):
        tl.llama_decode_step(wcfg, tparams, cache, torch.zeros((1, 1), dtype=torch.long),
                             torch.tensor([3], dtype=torch.int32), kv_layout=layout)
