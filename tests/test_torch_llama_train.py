"""The port's Llama training half against the JAX package at
``LlamaConfig.tiny`` size in float32: the same parameters (converted with
``params_from_jax``) and numpy-seeded batches go through ``llama_loss`` and
its gradient on both sides, and through 4-step ``Accelerator.train_step``
trajectories. The port runs its flash attention (the plain versions of the
kernels on the CPU); the JAX side its materialised ``"xla"`` attention,
whose programs compile fastest, and its train step over the test suite's
8 virtual CPU devices (``dp_shard_size=8``, 8-row batches).

Tolerances:
* loss rtol 1e-5 and every gradient leaf atol 1e-4 x that leaf's largest
  entry: f32 on both sides, the projections' matmuls sum in another order
  in XLA and in PyTorch, through two layers and the head and back;
* SGD trajectories: losses (each step's, and one more after the last
  update) rtol 1e-5, params atol 1e-5 (four updates of those gradients);
* AdamW trajectories: losses rtol 1e-4; params atol 2e-5, except where the
  JAX gradient of some update is within 1e-2 of its leaf's largest entry
  of zero. Adam's update ``m / (sqrt(v) + eps)`` divides by the gradient's
  own size, so a gradient difference of rounding size (about 1e-6 of the
  leaf maximum) moves such an element by up to 2 * lr per update (a sign
  flip), and those elements are held only at that.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.parallelism_config import ParallelismConfig
from accelerate_tpu.state import (
    AcceleratorState as JAcceleratorState,
    GradientState as JGradientState,
    PartialState as JPartialState,
)
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.state import AcceleratorState, GradientState

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _configs(jax_impl="xla", **kw):
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl=jax_impl,
                               attention_kv_block=16, **kw)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def params():
    jcfg, _ = _configs()
    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(jcfg, jax.random.key(0)))


def _batches():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    labels[0, :5] = -100
    labels[1, -3:] = -100
    mask = (rng.random((2, 16)) < 0.7).astype(np.float32)
    seg = np.array([[0] * 6 + [1] * 10, [0] * 3 + [1] * 9 + [2] * 4], np.int32)
    pos = np.concatenate([np.arange(n) for n in (6, 10)] + [np.arange(n) for n in (3, 9, 4)]
                         ).reshape(2, 16).astype(np.int32)
    return {
        "plain": {"input_ids": ids},
        "ignore_index": {"input_ids": ids, "labels": labels},
        "loss_mask": {"input_ids": ids, "loss_mask": mask},
        "packed": {"input_ids": ids, "segment_ids": seg, "position_ids": pos},
    }


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _param(model, path):
    return model.get_parameter("__".join(key.key for key in path))


@pytest.mark.parametrize("case", sorted(_batches()))
def test_llama_loss_and_every_gradient_leaf_match_jax(params, case):
    jcfg, tcfg = _configs()
    batch = _batches()[case]
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jparams = jax.tree_util.tree_map(jnp.asarray, params)

    def j_loss(p):
        return jl.llama_loss(lambda ids, **kw: jl.llama_apply(jcfg, p, ids, **kw), jbatch)

    jvalue, jgrads = jax.value_and_grad(j_loss)(jparams)
    model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
    loss = tl.llama_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jvalue), rtol=LOSS_RTOL)
    for path, jg in jax.tree_util.tree_leaves_with_path(jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(_param(model, path).grad.numpy(), jg, rtol=0,
                                   atol=GRAD_RTOL * np.abs(jg).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_packed_batch_equals_its_documents_trained_alone(params):
    # one row holding two documents (segment ids + restarted positions) has
    # the loss sum of the two documents as separate rows
    _, tcfg = _configs()
    model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 256, size=(1, 14)).astype(np.int64))
    seg = torch.tensor([[0] * 6 + [1] * 8])
    pos = torch.tensor([list(range(6)) + list(range(8))])
    labels = torch.cat([ids[:, 1:], ids[:, :1]], dim=1)
    labels[0, 5] = -100  # no target across the boundary
    labels[0, 13] = -100
    packed = model(ids, segment_ids=seg, position_ids=pos)
    first, second = model(ids[:, :6]), model(ids[:, 6:])
    torch.testing.assert_close(packed, torch.cat([first, second], dim=1), atol=1e-5, rtol=1e-5)
    total = tl._dense_ce_from_logits(packed, labels, None, reduction="sum")
    alone = (tl._dense_ce_from_logits(first, labels[:, :6], None, reduction="sum")
             + tl._dense_ce_from_logits(second, labels[:, 6:], None, reduction="sum"))
    torch.testing.assert_close(total, alone, atol=1e-4, rtol=1e-5)


def test_ce_denominator_and_flops_match_jax():
    for batch in _batches().values():
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        assert float(tl.llama_ce_denominator(tbatch)) == float(jl.llama_ce_denominator(jbatch))
    jcfg = jl.LlamaConfig.llama3_8b(num_hidden_layers=4)
    tcfg = tl.LlamaConfig.llama3_8b(num_hidden_layers=4)
    assert tl.llama_flops_per_token(tcfg, 2048) == jl.llama_flops_per_token(jcfg, 2048)


def test_remat_policies(params):
    # every policy recomputes (part of) each layer in the backward: the same
    # gradients as keeping every activation ("full"), through the flash
    # attention (its plain version here) and through the plain "xla" one,
    # whose batched einsums "dots" saves and "dots_no_batch" does not
    # and the products each policy keeps are not run again in the backward
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountProducts(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    ids = torch.from_numpy(np.random.default_rng(2).integers(0, 256, size=(2, 12)).astype(np.int64))
    for impl in ("flash", "xla"):
        tcfg = dataclasses.replace(_configs()[1], attention_impl=impl)
        grads, products = {}, {}
        for policy in tl.REMAT_POLICIES:
            cfg = dataclasses.replace(tcfg, remat_policy=policy)
            model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
            loss = tl.llama_loss(model, {"input_ids": ids})
            with CountProducts() as count:
                loss.backward()
            grads[policy] = {n: p.grad for n, p in model.named_parameters()}
            products[policy] = count.n
        for policy in tl.REMAT_POLICIES:
            for name, g in grads[policy].items():
                torch.testing.assert_close(g, grads["full"][name], atol=1e-6, rtol=1e-6,
                                           msg=f"{impl} {policy} {name}")
        full, nothing = products["full"], products["nothing"]
        assert products["dots"]["mm"] == products["dots_no_batch"]["mm"] == full["mm"] < nothing["mm"]
        assert full["mm"] < products["minimal"]["mm"] < nothing["mm"]
        if impl == "xla":  # the attention's batched products
            assert products["dots"]["bmm"] == full["bmm"] < products["dots_no_batch"]["bmm"]
    with pytest.raises(ValueError, match="remat_policy"):
        tl.llama_apply(dataclasses.replace(tcfg, remat_policy="everything"), {}, ids)


def test_stacked_parameters_take_every_layer_gradient(params, monkeypatch):
    # the forward splits each stacked (L, ...) parameter by one unbind: the
    # same gradients as slicing it layer by layer, and the serving tree is
    # the parameters' own storage, detached
    _, tcfg = _configs()
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, size=(2, 8)).astype(np.int64))
    grads = []
    for split in ("unbind", "slices"):
        if split == "slices":
            monkeypatch.setattr(tl, "_layer_trees",
                                lambda layers, n: [tl._layer_slice(layers, i) for i in range(n)])
        model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
        tl.llama_loss(model, {"input_ids": ids}).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], atol=0, rtol=0)
    stacked = model.params["layers"]["mlp"]["up_proj"]["kernel"]
    param = model.get_parameter("layers__mlp__up_proj__kernel")
    assert param.requires_grad and not stacked.requires_grad
    assert param.shape[0] == tcfg.num_hidden_layers and stacked.data_ptr() == param.data_ptr()


def test_serving_engine_with_trainable_weights_builds_no_graph():
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    cfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    model = tl.LlamaForCausalLM.from_seed(cfg, seed=0, device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    eng = ContinuousBatchingEngine(model, slots=2, max_len=32, prompt_bucket=16,
                                   kv_cache="paged", block_size=8, readback_lag=0, device="cpu")
    occ = eng.insert(np.arange(1, 9, dtype=np.int32), max_new_tokens=4)
    while eng.live_count():
        eng.step()
        eng.poll()
    assert len(occ.tokens) == 4
    assert all(not t.requires_grad and t.grad_fn is None for t in eng._cache.values())
    logits = tl.llama_apply(cfg, model.params, torch.zeros((1, 4), dtype=torch.long))
    assert logits.grad_fn is None  # the stacked tree is detached
    assert all(p.grad is None for p in model.parameters())


# ------------------------------------------------------------ f32 logits
# The head of the JAX llama_apply (accelerate_tpu/models/llama.py:736-745):
# rms_norm, then einsum(x, head.astype(cdt), preferred_element_type=f32),
# then the final softcap in f32. With bf16 operands every product is exact
# in f32, so the port's f32 logits differ from JAX's by the f32 summation
# order only: HEAD_RTOL of the largest |logit|. Logits rounded to bf16 miss
# it by orders of magnitude (one bf16 ulp of a logit of 4 is 2^-6).
HEAD_RTOL = 1e-5
HEAD_D, HEAD_V = 256, 4096


def _head_inputs(tied):
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 16, HEAD_D)).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=(HEAD_D,))).astype(np.float32)
    w = (rng.normal(size=(HEAD_D, HEAD_V)) / np.sqrt(HEAD_D)).astype(np.float32)
    jparams = {"final_norm": {"scale": scale}}
    if tied:
        jparams["embed_tokens"] = {"embedding": np.ascontiguousarray(w.T)}
    else:
        jparams["lm_head"] = {"kernel": w}
    return x, jparams


def _jax_head(jcfg, jparams, x):
    """Lines 736-745 of the JAX llama_apply on hidden states ``x``."""
    h = jl.rms_norm(jnp.asarray(x).astype(jcfg.compute_dtype),
                    jnp.asarray(jparams["final_norm"]["scale"]), jcfg.rms_norm_eps,
                    jcfg.rms_norm_offset)
    head = (jnp.asarray(jparams["embed_tokens"]["embedding"]).T if jcfg.tie_word_embeddings
            else jnp.asarray(jparams["lm_head"]["kernel"]))
    logits = jnp.einsum("bsd,dv->bsv", h, head.astype(jcfg.compute_dtype),
                        preferred_element_type=jnp.float32)
    return jl._tanh_softcap(logits, jcfg.final_logit_softcap)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_bf16_head_gives_the_f32_logits_of_jax(cap, tied):
    x, jparams = _head_inputs(tied)
    kw = dict(hidden_size=HEAD_D, vocab_size=HEAD_V, final_logit_softcap=cap,
              tie_word_embeddings=tied)
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.bfloat16, **kw)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.bfloat16, **kw)
    ref = np.asarray(_jax_head(jcfg, jparams, x))
    tparams = jax.tree_util.tree_map(torch.from_numpy, jparams)
    got = tl._head(tcfg, tparams, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=HEAD_RTOL * np.abs(ref).max())


def test_bf16_head_product_backward_rounds_the_cotangent_as_the_tpu_does():
    # the JAX backward of the head's product dots the f32 cotangent with a
    # bf16 operand (on the CPU in f32; on a TPU as bf16 passes) and rounds
    # to bf16; the port rounds the cotangent to bf16 first, then one bf16
    # GEMM with f32 sums and a bf16 output. Each gradient entry then
    # differs by the cotangent's rounding (2^-9 of each term) and one
    # output ulp (up to 2^-7 of the entry): 2^-6 of the largest entry
    rng = np.random.default_rng(12)
    h = rng.normal(size=(2, 16, HEAD_D)).astype(np.float32)
    w = (rng.normal(size=(HEAD_D, HEAD_V)) / np.sqrt(HEAD_D)).astype(np.float32)
    cot = rng.normal(size=(2, 16, HEAD_V)).astype(np.float32)
    jh, jw = (jnp.asarray(a).astype(jnp.bfloat16) for a in (h, w))
    out, vjp = jax.vjp(lambda a, b: jnp.einsum("bsd,dv->bsv", a, b,
                                                preferred_element_type=jnp.float32), jh, jw)
    jdh, jdw = vjp(jnp.asarray(cot))
    th, tw = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in (h, w))
    got = tl._f32_product(th, tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0,
                               atol=HEAD_RTOL * np.abs(np.asarray(out)).max())
    got.backward(torch.from_numpy(cot))
    for t, j in ((th, jdh), (tw, jdw)):
        assert t.grad.dtype == torch.bfloat16
        ref = np.asarray(j.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), ref, rtol=0,
                                   atol=2 ** -6 * np.abs(ref).max())


# bf16 through the whole model: bf16 keeps 8 significant bits, so each
# rounding moves a value by up to 2^-9 of it, and the two frameworks round
# at different places (XLA fuses elementwise chains and rounds once;
# PyTorch rounds every op's output). Through two layers that is a few ulps:
# logits 2.5e-2 of the largest |logit| (about 6 ulps of it), the loss rtol
# 2e-4, each gradient leaf 4e-2 of its largest entry (about 10 ulps).
BF16_LOGIT_RTOL = 2.5e-2
BF16_LOSS_RTOL = 2e-4
BF16_GRAD_RTOL = 4e-2


@pytest.mark.parametrize("cap", [None, 30.0])
def test_bf16_apply_and_loss_match_jax(params, cap):
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.bfloat16, attention_impl="xla",
                               attention_kv_block=16, final_logit_softcap=cap)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.bfloat16, attention_impl="xla",
                               final_logit_softcap=cap)
    batch = _batches()["ignore_index"]
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jlogits = np.asarray(jl.llama_apply(jcfg, jparams, jnp.asarray(batch["input_ids"])))
    model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["input_ids"]))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jlogits, rtol=0,
                               atol=BF16_LOGIT_RTOL * np.abs(jlogits).max())
    # both keep f32 logits: almost none of them is a bf16 value
    for lg in (logits, torch.from_numpy(jlogits.copy())):
        assert (lg == lg.to(torch.bfloat16).float()).float().mean().item() < 0.05

    def j_loss(p):
        return jl.llama_loss(lambda ids, **kw: jl.llama_apply(jcfg, p, ids, **kw),
                             {k: jnp.asarray(v) for k, v in batch.items()})

    jvalue, jgrads = jax.value_and_grad(j_loss)(jparams)
    loss = tl.llama_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jvalue), rtol=BF16_LOSS_RTOL)
    for path, jg in jax.tree_util.tree_leaves_with_path(jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(_param(model, path).grad.numpy(), jg, rtol=0,
                                   atol=BF16_GRAD_RTOL * np.abs(jg).max(),
                                   err_msg=jax.tree_util.keystr(path))


# ------------------------------------------------------------ trajectories
LR = {"sgd": 0.1, "adamw": 1e-2}
TRAJ_LOSS_RTOL = {"sgd": 1e-5, "adamw": 1e-4}
ADAM_PARAM_ATOL = 2e-5
ADAM_NEAR_ZERO = 1e-2  # of the leaf's largest |gradient| at that update


@pytest.fixture(scope="module")
def jax_loss_and_grad():
    jcfg, _ = _configs()

    def loss(p, batch):
        return jl.llama_loss(lambda ids, **kw: jl.llama_apply(jcfg, p, ids, **kw), batch)

    return jax.jit(jax.value_and_grad(loss))


def _jax_trajectory(params, batches, accum, opt_name, multi_step=False, **cfg_kw):
    """Each step's loss, the params before each step (host copies; the
    first only with ``multi_step``, whose one call runs every step), and
    the params after the last."""
    JAcceleratorState._reset_state()
    JGradientState._reset_state()
    JPartialState._reset_state()
    jcfg, _ = _configs(**cfg_kw)
    acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=8),
                       gradient_accumulation_steps=accum)
    model = jl.create_llama(jcfg, seed=0)
    model.params = jax.tree_util.tree_map(jnp.asarray, params)
    tx = optax.sgd(LR["sgd"]) if opt_name == "sgd" else optax.adamw(LR["adamw"], weight_decay=0.01)
    model, tx = acc.prepare(model, tx)
    step = acc.train_step(jl.llama_loss, max_grad_norm=1.0, multi_step=multi_step)
    losses, before = [], []
    if multi_step:
        before.append(jax.tree_util.tree_map(np.asarray, model.params))
        stacked = {k: jnp.asarray(np.stack([b[k] for b in batches])) for k in batches[0]}
        losses = [float(x) for x in np.asarray(step(stacked))]
    for batch in batches if not multi_step else ():
        before.append(jax.tree_util.tree_map(np.asarray, model.params))
        losses.append(float(step({k: jnp.asarray(v) for k, v in batch.items()})))
    out = jax.tree_util.tree_map(np.asarray, model.params)
    JAcceleratorState._reset_state()
    JGradientState._reset_state()
    JPartialState._reset_state()
    return losses, before, out


def _adam_near_zero(jax_loss_and_grad, before, batches, accum):
    """True where the JAX gradient of some update (summed over its
    micro-batches) is within ADAM_NEAR_ZERO of its leaf's largest of zero."""
    near = None
    for u in range(0, len(batches), accum):
        grads = [jax_loss_and_grad(before[u], b)[1] for b in batches[u:u + accum]]
        g = jax.tree_util.tree_map(lambda *gs: np.abs(sum(np.asarray(x) for x in gs)), *grads)
        step_near = jax.tree_util.tree_map(lambda x: x <= ADAM_NEAR_ZERO * x.max(), g)
        near = step_near if near is None else jax.tree_util.tree_map(np.logical_or, near, step_near)
    return near


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_train_step_trajectory_matches_jax(params, jax_loss_and_grad, accum, opt_name):
    data = np.random.default_rng(4).integers(0, 256, size=(32, 16)).astype(np.int32)
    batches = [{"input_ids": data[i:i + 8]} for i in range(0, 32, 8)]
    jlosses, jbefore, jparams = _jax_trajectory(params, batches, accum, opt_name)
    # one more loss after the last update, so that update is checked too
    jlosses.append(float(jax_loss_and_grad(jparams, batches[0])[0]))
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        _, tcfg = _configs()
        acc = Accelerator(cpu=True, gradient_accumulation_steps=accum)
        model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
        if opt_name == "sgd":
            opt = torch.optim.SGD(model.parameters(), lr=LR["sgd"])
        else:
            opt = torch.optim.AdamW(model.parameters(), lr=LR["adamw"], betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.01)
        model, opt = acc.prepare(model, opt)
        loader = acc.prepare_data_loader({"input_ids": data}, batch_size=8)
        step = acc.train_step(tl.llama_loss, max_grad_norm=1.0)
        losses = [step(batch).item() for batch in loader]
        with torch.no_grad():
            losses.append(tl.llama_loss(model, {"input_ids": torch.from_numpy(data[:8])}).item())
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJ_LOSS_RTOL[opt_name])
    if opt_name == "adamw":
        near = _adam_near_zero(jax_loss_and_grad, jbefore, batches, accum)
        held = sum(int((~leaf).sum()) for leaf in jax.tree_util.tree_leaves(near))
        assert held >= 0.5 * sum(leaf.size for leaf in jax.tree_util.tree_leaves(near))
    tparams = model.params
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        got, msg = _leaf(tparams, path).numpy(), jax.tree_util.keystr(path)
        if opt_name == "sgd":
            np.testing.assert_allclose(got, leaf, rtol=0, atol=1e-5, err_msg=msg)
            continue
        loose = _leaf(near, path)
        np.testing.assert_allclose(got[~loose], leaf[~loose], rtol=0, atol=ADAM_PARAM_ATOL, err_msg=msg)
        np.testing.assert_allclose(got[loose], leaf[loose], rtol=0,
                                   atol=2 * LR["adamw"] * (4 // accum), err_msg=msg)


def _port_sgd_trajectory(params, data, accum, multi_step=False, **cfg_kw):
    """The port's SGD ``train_step`` over ``data`` in 8-row batches: each
    step's loss (one call with ``multi_step``) and the params after."""
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        _, tcfg = _configs(**cfg_kw)
        acc = Accelerator(cpu=True, gradient_accumulation_steps=accum)
        model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
        model, _ = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR["sgd"]))
        step = acc.train_step(tl.llama_loss, max_grad_norm=1.0, multi_step=multi_step)
        ids = torch.from_numpy(data).reshape(-1, 8, data.shape[1])
        if multi_step:
            losses = step({"input_ids": ids})
            assert losses.shape == (ids.shape[0],)
            losses = losses.tolist()
        else:
            losses = [step({"input_ids": b}).item() for b in ids]
        return losses, {k: v.detach().clone() for k, v in model.named_parameters()}, model.params
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()


def _assert_sgd_params(tparams, jparams):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        np.testing.assert_allclose(_leaf(tparams, path).numpy(), leaf, rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch", "minimal"])
def test_train_step_trajectory_matches_jax_under_remat(params, policy):
    # the same 4-step SGD trajectory as JAX's train_step with the same
    # remat_policy (JAX: checkpoint_dots, ..._with_no_batch_dims,
    # save_only_these_names of the block outputs)
    data = np.random.default_rng(4).integers(0, 256, size=(32, 16)).astype(np.int32)
    batches = [{"input_ids": data[i:i + 8]} for i in range(0, 32, 8)]
    jlosses, _, jparams = _jax_trajectory(params, batches, 1, "sgd", remat_policy=policy)
    losses, _, tparams = _port_sgd_trajectory(params, data, 1, remat_policy=policy)
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJ_LOSS_RTOL["sgd"])
    _assert_sgd_params(tparams, jparams)


def test_multi_step_matches_single_calls_and_jax(params):
    # N = 4 steps in one call with accumulation 2: the losses and params of
    # four single calls, exactly, and of the JAX multi-step train_step
    # (lax.scan) at slice 2's tolerances
    data = np.random.default_rng(6).integers(0, 256, size=(32, 16)).astype(np.int32)
    batches = [{"input_ids": data[i:i + 8]} for i in range(0, 32, 8)]
    jlosses, _, jparams = _jax_trajectory(params, batches, 2, "sgd", multi_step=True)
    losses, named, tparams = _port_sgd_trajectory(params, data, 2, multi_step=True)
    single, named_single, _ = _port_sgd_trajectory(params, data, 2)
    assert losses == single
    for name, p in named.items():
        assert torch.equal(p, named_single[name]), name
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJ_LOSS_RTOL["sgd"])
    _assert_sgd_params(tparams, jparams)
