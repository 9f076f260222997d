"""The port's MoE layers (``ops/moe.py`` and the MoE branch of
``models/llama.py``) against the JAX package's, in one process on the CPU:
the same seeded numpy inputs (the JAX package's weights through
``params_from_jax``) through both functions.

Tolerances (f32 unless stated):
* ``route_topk``'s dispatch exactly (0/1 integers), its combine within
  1e-6 (f32 softmax and renormalisation, another summation order);
* ``moe_ffn``'s output and aux within 1e-5 (the index dispatch against
  the dense einsums: only the summation order differs);
* bf16 ``moe_ffn``: the output within 2^-6 of its largest |value| (bf16
  rounds at different places in the two frameworks; the same weights and
  routing), the aux within 1e-5 (the routing is f32 in both), and at most
  one token in 64 routed to another expert;
* ``llama_apply`` logits, ``llama_loss`` and the prefill/decode/verify
  steps ``MODEL_TOL`` (1e-4), the aux 1e-6, every gradient leaf within
  ``GRAD_ATOL`` (1e-5) of the JAX gradient;
* greedy tokens of the continuous engine and of ``generate``: exactly the
  JAX engine's and JAX ``generate``'s;
* the HF ``block_sparse_moe`` converters: exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import moe as jm
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.ops import moe as tm

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_ATOL = 1e-5
MOE = dict(num_experts=4, num_experts_per_tok=2, router_z_loss_coef=1e-3, moe_aux_loss_coef=0.1)


def _np(x):
    return x.detach().float().numpy()


def _configs(**kw):
    fields = {**MOE, **kw}
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla", **fields)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="xla", **fields)
    return jcfg, tcfg


def _params(jcfg, tcfg, seed=0):
    jparams = jl.init_llama_params(jcfg, jax.random.key(seed))
    return jparams, tl.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams),
                                       device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _configs()
    return (jcfg, tcfg, *_params(jcfg, tcfg))


def _ffn_inputs(seed, n_tokens=16, d=16, i=32, e=4):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, n_tokens // 2, d)).astype(np.float32)
    router = rng.normal(size=(d, e)).astype(np.float32)
    wg, wu = (rng.normal(size=(e, d, i)) * 0.1).astype(np.float32), \
        (rng.normal(size=(e, d, i)) * 0.1).astype(np.float32)
    wd = (rng.normal(size=(e, i, d)) * 0.1).astype(np.float32)
    return x, router, wg, wu, wd


# ------------------------------------------------------------------- routing
# (tokens, experts, capacity): dropping, ample, the one-token floor, E = 8
ROUTE_CASES = {"drop": (32, 4, 8), "ample": (16, 4, 16), "one_token": (1, 8, 2),
               "e8_drop": (64, 8, 5), "e8_tight": (40, 8, 10)}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_route_topk_matches_jax(case):
    n, e, capacity = ROUTE_CASES[case]
    logits = np.random.default_rng(n + e).normal(size=(n, e)).astype(np.float32)
    want = jm.route_topk(jnp.asarray(logits), 2, capacity)
    got = tm.route_topk(torch.from_numpy(logits), 2, capacity)
    np.testing.assert_array_equal(got.dispatch.numpy(), np.asarray(want.dispatch))
    np.testing.assert_allclose(got.combine.numpy(), np.asarray(want.combine), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.router_probs.numpy(), np.asarray(want.router_probs), atol=1e-6)
    np.testing.assert_allclose(got.aux_loss.item(), float(want.aux_loss), rtol=1e-6)
    if case == "drop":  # the case drops something, as its name says
        assert got.dispatch.sum() < 2 * n


def test_route_topk_ties_go_to_the_lowest_index():
    logits = np.zeros((4, 4), np.float32)
    logits[1] = [1.0, 3.0, 3.0, 3.0]
    want = jm.route_topk(jnp.asarray(logits), 2, 4)
    got = tm.route_topk(torch.from_numpy(logits), 2, 4)
    np.testing.assert_array_equal(got.dispatch.numpy(), np.asarray(want.dispatch))
    assert got.dispatch[1, 1].sum() == 1 and got.dispatch[1, 2].sum() == 1  # 1 and 2, not 3


# capacity factors: dropping (0.5, 1.0), the JAX default (1.25), dropless (4.0)
FFN_FACTORS = (0.5, 1.0, 1.25, 4.0)


@pytest.mark.parametrize("factor", FFN_FACTORS)
def test_moe_ffn_output_and_aux_match_jax(factor):
    args = _ffn_inputs(1)
    kw = dict(capacity_factor=factor, aux_loss_coef=0.3, router_z_loss_coef=1e-2)
    want, want_aux = jm.moe_ffn(*map(jnp.asarray, args), compute_dtype=jnp.float32, **kw)
    got, got_aux = tm.moe_ffn(*map(torch.from_numpy, args), compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=1e-5, rtol=0)


def test_moe_ffn_gradients_match_jax():
    args = _ffn_inputs(2)
    kw = dict(capacity_factor=1.0, aux_loss_coef=0.3, router_z_loss_coef=1e-2)

    def jloss(*a):
        out, aux = jm.moe_ffn(*a, compute_dtype=jnp.float32, **kw)
        return jnp.sum(jnp.sin(out)) + aux

    want = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out, aux = tm.moe_ffn(*ts, compute_dtype=torch.float32, **kw)
    (torch.sin(out).sum() + aux).backward()
    for t, w in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=0)


def test_moe_ffn_bf16_matches_jax_within_its_rounding():
    x, router, wg, wu, wd = _ffn_inputs(3, n_tokens=64)
    want, want_aux = jm.moe_ffn(*map(jnp.asarray, (x, router, wg, wu, wd)), capacity_factor=1.25)
    got, got_aux = tm.moe_ffn(*map(torch.from_numpy, (x, router, wg, wu, wd)), capacity_factor=1.25)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, atol=2.0 ** -6 * np.abs(want).max(), rtol=0)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=1e-5)
    # the routing is f32 in both: how many of the 64 tokens changed experts
    logits = x.reshape(-1, x.shape[-1]) @ router
    jr = jm.route_topk(jnp.asarray(logits), 2, 40)
    tr = tm.route_topk(torch.from_numpy(logits), 2, 40)
    moved = (tr.dispatch.sum(-1).numpy() != np.asarray(jr.dispatch).sum(-1)).any(-1).sum()
    assert moved <= 1


def test_capacity_floor_and_balanced_decode_drop_nothing():
    # JAX's tests/test_moe.py: a balanced top-2 load at factor 1.25 and a
    # one-token batch equal the dropless (factor E) output
    e, d, i, n = 8, 8, 16, 32
    rng = np.random.default_rng(0)
    onehot = np.eye(d, dtype=np.float32)
    x = (10.0 * onehot[np.arange(n) % e] + 9.0 * onehot[(np.arange(n) + 3) % e]).reshape(2, 16, d)
    router = np.eye(d, e, dtype=np.float32)
    ws = [torch.from_numpy((rng.normal(size=s) * 0.1).astype(np.float32))
          for s in ((e, d, i), (e, d, i), (e, i, d))]
    for xs in (torch.from_numpy(x), torch.from_numpy(rng.normal(size=(1, 1, d)).astype(np.float32))):
        r = torch.from_numpy(router) if xs.shape[1] > 1 else torch.from_numpy(
            rng.normal(size=(d, e)).astype(np.float32))
        real, _ = tm.moe_ffn(xs, r, *ws, capacity_factor=1.25, compute_dtype=torch.float32)
        full, _ = tm.moe_ffn(xs, r, *ws, capacity_factor=float(e), compute_dtype=torch.float32)
        torch.testing.assert_close(real, full, atol=1e-6, rtol=0)
    assert tm.expert_capacity(1, 8, 2, 1.25) == 2


def test_router_z_loss_and_load_balancing_match_jax():
    logits = np.random.default_rng(0).normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(tm.router_z_loss(torch.from_numpy(logits)).item(),
                               float(jm.router_z_loss(jnp.asarray(logits))), rtol=1e-6)
    probs = jax.nn.softmax(jnp.asarray(logits * 5))
    dispatch = jax.nn.one_hot(jnp.argmax(probs, -1), 4)
    np.testing.assert_allclose(
        tm.load_balancing_loss(torch.from_numpy(np.asarray(probs)),
                               torch.from_numpy(np.asarray(dispatch))).item(),
        float(jm.load_balancing_loss(probs, dispatch)), rtol=1e-6)


# --------------------------------------------------------------- the model
def test_llama_apply_logits_and_aux_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    ids = np.random.default_rng(5).integers(0, 256, size=(2, 16)).astype(np.int32)
    jlog, jaux = jl.llama_apply(jcfg, jparams, jnp.asarray(ids), return_aux=True)
    tlog, taux = tl.llama_apply(tcfg, tparams, torch.from_numpy(ids), return_aux=True)
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **MODEL_TOL)
    np.testing.assert_allclose(taux["aux_loss"].item(), float(jaux["aux_loss"]), atol=1e-6)
    # the model's forward returns the aux, as the JAX create_llama's apply does
    m = tl.LlamaForCausalLM(tcfg, tparams)
    assert m.name == jl.create_llama(jcfg).name == "llama-moe"
    out = m(torch.from_numpy(ids))
    assert isinstance(out, tuple) and set(out[1]) == {"aux_loss"}
    # a dense model's aux is zero, as in the JAX package
    dense = tl.LlamaConfig.tiny(compute_dtype=torch.float32)
    dparams = tl.init_llama_params(dense, torch.Generator().manual_seed(0), device="cpu")
    assert tl.llama_apply(dense, dparams, torch.from_numpy(ids), return_aux=True)[1][
        "aux_loss"].item() == 0.0


def test_init_params_tree_and_scales_match_jax():
    jcfg, tcfg = _configs(intermediate_size=256)
    jparams = jax.tree_util.tree_map(np.asarray, jl.init_llama_params(jcfg, jax.random.key(0)))
    tparams = tl.init_llama_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, jax.tree_util.keystr(path)
        if leaf.std() > 0:  # the draw's scale, within sampling noise
            np.testing.assert_allclose(node.std().item(), leaf.std(), rtol=0.1,
                                       err_msg=jax.tree_util.keystr(path))


def _grads_of(jcfg, tcfg, jparams, tparams, batch):
    """(JAX loss, JAX grads by checkpoint key, port loss, port grads)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    view = lambda p: (lambda ids, **kw: jl.llama_apply(jcfg, p, ids, return_aux=True, **kw))
    jloss, jgrads = jax.value_and_grad(lambda p: jl.llama_loss(view(p), jbatch))(jparams)
    flat = {".".join(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_leaves_with_path(jgrads)}
    m = tl.LlamaForCausalLM(tcfg, tparams)
    loss = tl.llama_loss(m, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    return float(jloss), flat, loss.item(), {key: getattr(m, n).grad.numpy()
                                              for key, n in m.checkpoint_keys()}


# the loss variants: dense CE, chunked CE, a dropping capacity, remat "dots"
LOSS_CASES = {"dense": {}, "chunked": dict(use_chunked_ce=True, ce_chunk_size=48),
              "dropping": dict(expert_capacity_factor=0.5),
              "remat_dots": dict(remat_policy="dots")}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_llama_loss_and_every_gradient_match_jax(case):
    jcfg, tcfg = _configs(**LOSS_CASES[case])
    jparams, tparams = _params(jcfg, tcfg, seed=1)
    rng = np.random.default_rng(9)
    mask = np.ones((2, 15), np.float32)
    mask[1, 8:] = 0
    batch = {"input_ids": rng.integers(0, 256, size=(2, 16)).astype(np.int32), "loss_mask": mask}
    jloss, jgrads, loss, grads = _grads_of(jcfg, tcfg, jparams, tparams, batch)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    assert grads.keys() == jgrads.keys()
    for key, want in jgrads.items():
        np.testing.assert_allclose(grads[key], want, atol=GRAD_ATOL, rtol=0, err_msg=key)


def test_router_z_loss_lands_at_its_face_value():
    # JAX's test_router_z_loss, model level: with load balancing off the
    # z-loss still lands, linearly in its coefficient
    batch = {"input_ids": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, size=(2, 16)).astype(np.int32))}
    losses = {}
    for coef in (0.0, 0.5, 1.0):
        cfg = tl.LlamaConfig.tiny(num_experts=4, compute_dtype=torch.float32,
                                  moe_aux_loss_coef=0.0, router_z_loss_coef=coef)
        with torch.no_grad():
            losses[coef] = tl.llama_loss(tl.create_llama(cfg, seed=0, device="cpu"), batch).item()
    assert losses[1.0] > losses[0.0]
    np.testing.assert_allclose(losses[1.0] - losses[0.0], 2 * (losses[0.5] - losses[0.0]),
                               rtol=1e-4)


def test_fp8_runs_only_attention_projections_through_fp8(monkeypatch):
    # the JAX moe_ffn never calls _dot: an MoE layer's experts stay in the
    # compute dtype under use_fp8, q/k/v/o go through fp8_dot
    from accelerate_tpu_torch.ops import fp8 as tf

    cfg = tl.LlamaConfig.tiny(num_experts=4, use_fp8=True, compute_dtype=torch.float32)
    m = tl.create_llama(cfg, device="cpu")
    calls = []
    real = tf.fp8_dot
    monkeypatch.setattr(tf, "fp8_dot", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        logits, aux = m(torch.zeros((1, 4), dtype=torch.long))
    assert torch.isfinite(logits).all() and len(calls) == 4 * cfg.num_hidden_layers


def test_flops_per_token_counts_the_dense_ffn_as_jax_does():
    for preset in ("mixtral_8x7b", "tiny"):
        jcfg = getattr(jl.LlamaConfig, preset)(num_experts=8)
        tcfg = getattr(tl.LlamaConfig, preset)(num_experts=8)
        assert tl.llama_flops_per_token(tcfg, 2048) == jl.llama_flops_per_token(jcfg, 2048)


def test_quantized_moe_forward_matches_jax():
    from accelerate_tpu.utils.quantization import quantize_model as jquantize
    from accelerate_tpu_torch.utils.quantization import quantize_model

    jcfg, tcfg = _configs()
    jm_model = jl.create_llama(jcfg, seed=0)
    params = jax.tree_util.tree_map(np.asarray, jm_model.params)
    jquantize(jm_model)
    m = quantize_model(tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu")))
    assert not isinstance(m.layers__mlp__experts__w_gate, torch.nn.Parameter)
    ids = np.random.default_rng(2).integers(0, 256, size=(2, 12)).astype(np.int32)
    jlog, jaux = jm_model.apply_fn(jm_model.params, jnp.asarray(ids))
    with torch.no_grad():
        tlog, taux = m(torch.from_numpy(ids))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **MODEL_TOL)
    np.testing.assert_allclose(taux["aux_loss"].item(), float(jaux["aux_loss"]), atol=1e-6)


# ------------------------------------------------------------- serving steps
def test_prefill_decode_and_verify_steps_match_jax(model):
    jcfg, tcfg, jparams, tparams = model
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, size=(2, 9)).astype(np.int32)
    last = np.array([8, 5], np.int32)
    jlog, jcache = jl.llama_prefill_at(jcfg, jparams, jnp.asarray(ids), 24, jnp.asarray(last))
    tlog, tcache = tl.llama_prefill_at(tcfg, tparams, torch.from_numpy(ids), 24,
                                       torch.from_numpy(last))
    np.testing.assert_allclose(_np(tlog), np.asarray(jlog), **MODEL_TOL)
    for w in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[w]), np.asarray(jcache[w]), **MODEL_TOL)
    pos = last + 1
    token = np.array(jnp.argmax(jlog, axis=-1), np.int32)[:, None]
    jd, jdc = jl.llama_decode_step(jcfg, jparams, jcache, jnp.asarray(token), jnp.asarray(pos))
    tcache = {w: torch.from_numpy(np.array(jcache[w])) for w in ("k", "v")}
    td, tdc = tl.llama_decode_step(tcfg, tparams, tcache, torch.from_numpy(token).long(),
                                   torch.from_numpy(pos))
    np.testing.assert_allclose(_np(td), np.asarray(jd), **MODEL_TOL)
    for w in ("k", "v"):
        np.testing.assert_allclose(_np(tdc[w]), np.asarray(jdc[w]), **MODEL_TOL)
    window = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    jv, jkv = jl.llama_verify_step(jcfg, jparams, jdc, jnp.asarray(window), jnp.asarray(pos + 1))
    tcache = {w: torch.from_numpy(np.array(jdc[w])) for w in ("k", "v")}
    tv, tkv = tl.llama_verify_step(tcfg, tparams, tcache, torch.from_numpy(window).long(),
                                   torch.from_numpy(pos + 1))
    np.testing.assert_allclose(_np(tv), np.asarray(jv), **MODEL_TOL)
    for w in ("k", "v"):
        np.testing.assert_allclose(_np(tkv[w]), np.asarray(jkv[w]), **MODEL_TOL)


def test_decode_matches_the_full_forward_at_ample_capacity():
    # JAX's test_moe_decode_matches_full_forward: a dropless factor, so the
    # whole-sequence routing and the per-position routing agree
    cfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, num_experts=4,
                              expert_capacity_factor=8.0)
    m = tl.create_llama(cfg, seed=0, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(2, 8)))
    with torch.no_grad():
        full, _ = m(ids)
        cache = tl.init_kv_cache(cfg, 2, 8, device="cpu")
        for t in range(8):
            step, cache = tl.llama_decode_step(cfg, m.params, cache, ids[:, t:t + 1],
                                               torch.tensor(t))
            torch.testing.assert_close(step, full[:, t], atol=2e-3, rtol=2e-3)


ENGINE_KW = dict(slots=3, max_len=48, prompt_bucket=16, readback_lag=1, block_size=8,
                 prefill_chunk=8, spec="ngram", spec_draft_len=3)
NEW = 8
# the int8 pool as the dense models' parity holds it
# (tests/test_torch_longctx.py's INT8_KW and prompts); on the longer mixed
# traffic of the other cases the MoE model's int8 tokens part from JAX's
ENGINE_CASES = {"dense": {}, "paged": {},
                "paged_int8": dict(slots=2, max_len=32, prompt_bucket=16, readback_lag=0,
                                   pool_blocks=9, prefill_chunk=None, spec=None)}


def _requests(chunks=True):
    """Random prompts, one past the bucket (chunked), and a tiled one the
    n-gram drafter matches; five for three slots. Without ``chunks``, the
    int8 case's two."""
    if not chunks:
        rng = np.random.default_rng(11)
        return [rng.integers(1, 255, size=n).astype(np.int32) for n in (5, 9)]
    rng = np.random.default_rng(7)
    tiled = np.tile(rng.integers(1, 50, size=4), 3).astype(np.int32)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in (5, 12, 21, 3)] + [tiled]


def _drive(eng):
    occs, waiting = [], list(_requests(eng.prefill_chunk is not None))
    guard = 500
    while waiting or eng.live_count():
        while waiting and eng.free_slots() and eng.can_admit(waiting[0], NEW):
            occs.append(eng.insert(waiting.pop(0), max_new_tokens=NEW, pad_token_id=0))
        eng.step()
        eng.poll()
        guard -= 1
        assert guard > 0, "the engine did not drain"
    eng.poll(force=True)
    assert (eng.stats()["prefill_chunks"] > 0) == (eng.prefill_chunk is not None)
    return [list(o.tokens) for o in occs]


@pytest.fixture(scope="module")
def engine_runs():
    """Greedy tokens of the JAX engine and the port's on each store, at a
    dropping capacity factor (routing depends on every row of each
    program), and of both ``generate``s."""
    from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
    from accelerate_tpu.inference import generate as jgenerate
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.inference import generate

    jcfg, tcfg = _configs(expert_capacity_factor=1.0)
    jmodel = jl.create_llama(jcfg, seed=0)
    params = jax.tree_util.tree_map(np.asarray, jmodel.params)
    tmodel = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
    out = {}
    for backend, kw in ENGINE_CASES.items():
        impl = "reference" if backend == "dense" else "kernel"
        kw = {**ENGINE_KW, **kw}
        out["jax", backend] = _drive(JEngine(jmodel, kv_cache=backend, **kw))
        with torch.no_grad():
            out["port", backend] = _drive(ContinuousBatchingEngine(
                tmodel, kv_cache=backend, attention_impl=impl, device="cpu", **kw))
    ids = np.random.default_rng(1).integers(0, 256, size=(3, 7)).astype(np.int32)
    out["jax", "generate"] = np.asarray(jgenerate(jmodel, ids, max_new_tokens=6))
    with torch.no_grad():
        out["port", "generate"] = np.asarray(generate(tmodel, ids, max_new_tokens=6))
    return out


@pytest.mark.parametrize("backend", tuple(ENGINE_CASES) + ("generate",))
def test_greedy_tokens_equal_the_jax_engine_and_generate(engine_runs, backend):
    got, want = engine_runs["port", backend], engine_runs["jax", backend]
    assert [list(map(int, r)) for r in got] == [list(map(int, r)) for r in want]


# ------------------------------------------------------------- HF converters
def _hf_moe_tensors(jcfg, seed):
    params = jax.tree_util.tree_map(np.asarray, jl.init_llama_params(jcfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32), params)
    return jl.export_hf_state_dict(jcfg, params)


def test_block_sparse_moe_converters_equal_jax_and_round_trip(tmp_path):
    from accelerate_tpu_torch.utils.serialization import load_sharded_safetensors, save_sharded_safetensors

    jcfg, tcfg = _configs()
    flat = _hf_moe_tensors(jcfg, seed=3)
    assert "model.layers.1.block_sparse_moe.experts.3.w2.weight" in flat
    save_sharded_safetensors({k: torch.from_numpy(v) for k, v in flat.items()}, str(tmp_path))
    on_disk = load_sharded_safetensors(str(tmp_path))
    want = jax.tree_util.tree_map(np.asarray, jl.convert_hf_state_dict(jcfg, flat))
    got = tl.convert_hf_state_dict(tcfg, on_disk, device="cpu")
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = got
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), leaf, err_msg=jax.tree_util.keystr(path))
    assert len(list(tl._flatten(got))) == len(jax.tree_util.tree_leaves(want))
    back = tl.export_hf_state_dict(tcfg, got)
    assert sorted(back) == sorted(flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)
    m = tl.LlamaForCausalLM.from_seed(tcfg, seed=1, device="cpu")
    tl.load_hf_checkpoint(m, str(tmp_path))
    ids = np.random.default_rng(1).integers(0, 256, size=(2, 12)).astype(np.int32)
    jlog, _ = jl.llama_apply(jcfg, jl.convert_hf_state_dict(jcfg, flat), jnp.asarray(ids),
                             return_aux=True)
    np.testing.assert_allclose(_np(m(torch.from_numpy(ids))[0]), np.asarray(jlog), **MODEL_TOL)


def test_moe_under_tp_is_refused_naming_a11():
    from accelerate_tpu_torch.parallel.tp import TensorParallel

    cfg = tl.LlamaConfig.tiny(num_experts=4, compute_dtype=torch.float32)
    params = tl.init_llama_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    fake = TensorParallel.__new__(TensorParallel)
    fake.group, fake.size, fake.rank = None, 2, 0
    with pytest.raises(NotImplementedError, match=r"MoE.*tensor parallelism.*ROADMAP.md A11"):
        tl.llama_apply(cfg, params, torch.zeros((1, 4), dtype=torch.long), tp=fake)
