"""fp8 training of the PyTorch port (``ops/fp8.py``, ``mixed_precision=
"fp8"``, ``LlamaConfig.use_fp8``) against the JAX package's ``ops/fp8.py``
on the same numpy-seeded inputs, on the CPU (the plain products; the card's
``torch._scaled_mm`` path is held against them in ``chip_smoke.py``).

Tolerances, and why. The quantized bytes are compared bitwise. Everything
after a product can differ from JAX by more than the sum order, because a
product's output feeds the next quantization: an output one f32 (or bf16)
ulp away can round to the neighbouring fp8 value there, a step of 6-12 %
of that element (e4m3 keeps 3 mantissa bits). The scales themselves are
steady only to one f32 ulp: JAX computes ``1 / scale`` exactly in eager
mode but not always under ``jit`` (which ``lax.scan`` bodies and
``train_step`` run), and one ulp of a scale can flip a rounding too.
* ``fp8_dot`` alone: ``DOT_RTOL`` of the largest |reference| (f32: the
  f32 sum order; bf16: one bf16 ulp, 2^-7, of the output);
* the rewritten MLP (``fp8_rewrite``): ``REWRITE_RTOL`` of the largest
  |reference| on outputs (one product through fp8, then f32 math), and
  ``REWRITE_GRAD_RTOL`` on gradients: JAX's rewrite runs under ``jit``,
  whose inverse scale of the cotangent was one f32 ulp off the exact one
  and whose cotangent had one element on the other side of an e5m2
  rounding (a step of 25 %); that one element moves a whole column of the
  weight's gradient, by 5e-4 of its largest entry (traced: with JAX's own
  quantized cotangent the port's gradient is JAX's within 2.4e-7);
* the tiny Llama (2 layers) in f32 against JAX run eagerly (exact inverse
  scales, as the port's): logits, loss and each gradient leaf within
  ``LLAMA_RTOL`` (1e-5) of their largest |reference| (observed 6e-7: the
  f32 sum order, and no flipped rounding);
* the tiny Llama in bf16: within ``BF16_BAND`` (1.5) times the distance
  between JAX's own bf16 and f32 runs (see the test: bf16 roundings differ
  between the frameworks, and fp8 amplifies that);
* 3-step trajectories against the compiled JAX ``train_step`` (the first
  loss, before any update, within ``LLAMA_RTOL``). A cotangent element on
  the other side of an e5m2 rounding moves a whole column of a weight's
  gradient by up to a step (25 %) of its share, so the parameters are
  held within ``TRAJ_PARAM_ATOL`` but for at most ``TRAJ_LOOSE_SHARE``
  (1 %) of the elements, and all within ``TRAJ_PARAM_MAX``. SGD (lr 0.1):
  losses 1e-6, parameters 1e-5, at most 1e-3 (observed: losses 8e-8, 0.5 %
  of the elements beyond 1e-5, the largest 2.1e-4). AdamW (lr 1e-3) divides
  each gradient by its own size, so a rounding-sized gradient difference
  can move an element by a share of lr, and a weight moved differently
  quantizes to a neighbouring fp8 value in the next forward: losses 1e-3
  (observed 3e-4 at the third step), parameters 5e-4 (0.5 % beyond it),
  at most Adam's largest difference, ``2 * lr`` an update;
* greedy tokens: exact.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu import inference as jinf
from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops import fp8 as jf
from accelerate_tpu.parallelism_config import ParallelismConfig
from accelerate_tpu.state import (
    AcceleratorState as JAcceleratorState,
    GradientState as JGradientState,
    PartialState as JPartialState,
)
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.inference import generate
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.ops import fp8 as tf
from accelerate_tpu_torch.state import AcceleratorState, GradientState

DOT_RTOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7}
REWRITE_RTOL = 1e-5
REWRITE_GRAD_RTOL = 2e-3
LLAMA_RTOL = 1e-5
BF16_BAND = 1.5
TRAJ_UPDATES = 3
TRAJ_LR = {"sgd": 0.1, "adamw": 1e-3}
TRAJ_LOSS_RTOL = {"sgd": 1e-6, "adamw": 1e-3}
TRAJ_PARAM_ATOL = {"sgd": 1e-5, "adamw": 5e-4}
TRAJ_PARAM_MAX = {"sgd": 1e-3, "adamw": 2 * 1e-3 * TRAJ_UPDATES}
TRAJ_LOOSE_SHARE = 1e-2
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _reset():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _both(a: np.ndarray, dtype):
    """``a`` as a JAX array of ``dtype`` and the same values as a torch tensor."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32)).copy()).to(dtype)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close(got, want, rtol, msg=""):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max(), err_msg=msg)


# ----------------------------------------------------------------- quantize
def _quantize_inputs():
    rng = np.random.default_rng(0)
    cases = [(rng.standard_normal((17, 33)) * 10.0 ** rng.uniform(-6, 6)).astype(np.float32)
             for _ in range(40)]
    cases.append(np.zeros((4, 8), np.float32))  # the 1e-12 clamp
    cases.append(np.array([[448.0, -448.0, 57344.0, -57344.0, 1e-3, -3.0, 0.0, 7.5]], np.float32))
    cases.append(np.array([[448.0, -448.0, 1.0, -0.5]], np.float32))  # at +-max of e4m3
    return cases


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quantized_bytes_are_jax_bytes(fmt, dtype):
    jq, tq = getattr(jf, f"quantize_{fmt}"), getattr(tf, f"quantize_{fmt}")
    want_dtype = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}[fmt]
    for i, a in enumerate(_quantize_inputs()):
        ja, ta = _both(a, dtype)
        before = ta.clone()
        (q1, s1), (q2, s2) = jq(ja), tq(ta)
        assert q2.dtype == want_dtype and s2.dtype == torch.float32 and s2.dim() == 0
        np.testing.assert_array_equal(q2.view(torch.uint8).numpy(), np.asarray(q1).view(np.uint8),
                                      err_msg=f"case {i}")
        assert s2.item() == float(s1), i  # JAX eager divides exactly, as the port does
        assert torch.equal(ta, before)  # the input is not written


# ------------------------------------------------------------------ fp8_dot
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fp8_dot_forward_and_gradients_match_jax_custom_vjp(dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    g = rng.standard_normal((3, 5, 48)).astype(np.float32)
    (jx, tx), (jw, tw), (jg, tg) = _both(x, dtype), _both(w, dtype), _both(g, dtype)
    out, vjp = jax.vjp(jf.fp8_dot, jx, jw)
    jdx, jdw = vjp(jg)
    tx.requires_grad_()
    tw.requires_grad_()
    got = tf.fp8_dot(tx, tw)
    got.backward(tg)
    assert got.dtype == tx.grad.dtype == tw.grad.dtype == dtype
    for name, a, b in (("out", got, out), ("dx", tx.grad, jdx), ("dw", tw.grad, jdw)):
        _close(a, b, DOT_RTOL[dtype], name)


def test_fp8_dot_shared_input_and_groups_count():
    # q/k/v share one quantized input: the same values as quantizing it for
    # each product; with no group no collective is issued
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((32, 16)).astype(np.float32))
    groups = tf.Fp8Groups()
    shared = tf.fp8_dot(x, w, amax_group=groups, quantized_x=tf.quantize_input(x, groups))
    torch.testing.assert_close(shared, tf.fp8_dot(x, w), atol=0, rtol=0)
    assert groups.reductions == 0
    # the plain product is the fp8 values' f32 product times the scales
    (qx, sx), (qw, sw) = tf.quantize_e4m3(x), tf.quantize_e4m3(w)
    torch.testing.assert_close(tf.fp8_dot(x, w), (qx.float() @ qw.float()) * (sx * sw),
                               atol=0, rtol=0)


def test_fp8_config_maybe_dot_honours_min_dim():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    for k, n, fp8 in ((256, 256, True), (256, 255, False), (255, 256, False), (256, 512, True)):
        xk = x[:, :k]
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
        want = tf.fp8_dot(xk, w) if fp8 else xk @ w
        torch.testing.assert_close(tf.Fp8Config().maybe_dot(xk, w), want, atol=0, rtol=0)
        jwant = jf.Fp8Config().maybe_dot(jnp.asarray(xk.numpy()), jnp.asarray(w.numpy()))
        _close(tf.Fp8Config().maybe_dot(xk, w), jwant, DOT_RTOL[torch.float32])
    assert torch.equal(tf.Fp8Config(use_fp8_dots=False).maybe_dot(x, w), x @ w)
    assert torch.equal(tf.Fp8Config(min_dim=1024).maybe_dot(x, w), x @ w)


# --------------------------------------------------------------- fp8_rewrite
def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(256, 512)) * 0.05).astype(np.float32),
            "w2": (rng.normal(size=(512, 8)) * 0.05).astype(np.float32)}


class _Mlp(nn.Module):
    """The JAX test's ``tanh(x @ w1) @ w2`` (256 -> 512 -> 8): the first
    product an ``nn.Linear`` or ``x @ self.w1``."""

    def __init__(self, p, linear: bool):
        super().__init__()
        self.linear = linear
        if linear:
            self.lin = nn.Linear(256, 512, bias=False)
            with torch.no_grad():
                self.lin.weight.copy_(torch.from_numpy(p["w1"].T.copy()))
        else:
            self.w1 = nn.Parameter(torch.from_numpy(p["w1"].copy()))
        self.w2 = nn.Parameter(torch.from_numpy(p["w2"].copy()))

    def w1_grad(self):
        return self.lin.weight.grad.T if self.linear else self.w1.grad

    def forward(self, x):
        x = x.to(self.w2.dtype)  # the compute dtype, under a mixed-precision policy
        h = self.lin(x) if self.linear else x @ self.w1
        return torch.tanh(h) @ self.w2


def _jax_mlp(p, x):
    return jnp.tanh(x @ p["w1"]) @ p["w2"]


@pytest.mark.parametrize("first", ["linear", "matmul"])
def test_fp8_rewrite_matches_jax_rewrite_on_the_mlp(first):
    p = _mlp_params()
    x = np.random.default_rng(1).normal(size=(16, 256)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    fn8 = jf.fp8_rewrite(_jax_mlp)
    jout = fn8(jp, jnp.asarray(x))
    jgrads = jax.grad(lambda q: jnp.sum(fn8(q, jnp.asarray(x)) ** 2))(jp)
    model = tf.fp8_rewrite(_Mlp(p, first == "linear"))
    tx = torch.from_numpy(x)
    out = model(tx)
    (out ** 2).sum().backward()
    _close(out, jout, REWRITE_RTOL, "out")
    _close(model.w1_grad(), jgrads["w1"], REWRITE_GRAD_RTOL, "w1")
    _close(model.w2.grad, jgrads["w2"], REWRITE_GRAD_RTOL, "w2")
    # the first product went through fp8 (K 256, N 512); the second (N 8) not
    w1 = torch.from_numpy(p["w1"])
    with torch.no_grad():
        want = torch.tanh(tf.fp8_dot(tx, w1)) @ model.w2
        assert torch.equal(model(tx), want)
        assert not torch.equal(want, torch.tanh(tx @ w1) @ model.w2)


class _Products(nn.Module):
    """Products the rewrite leaves alone beside one it takes."""

    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.big = nn.Parameter(torch.randn(256, 256, generator=g))
        self.small = nn.Parameter(torch.randn(128, 256, generator=g))

    def forward(self, x, which):
        if which == "batched":  # both operands 3-D: an attention-shaped product
            q = x.reshape(2, -1, 256)
            return torch.matmul(q, q.transpose(1, 2))
        if which == "small_k":
            return x[..., :128] @ self.small
        if which == "function":
            return _PlainProduct.apply(x, self.big)
        return x @ self.big


class _PlainProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return x @ w

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return g @ w.T, x.T @ g


@pytest.mark.parametrize("which", ["batched", "small_k", "function"])
def test_fp8_rewrite_leaves_batched_small_and_function_products(which):
    model = _Products()
    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(1))
    plain = model(x, which)
    rewritten = tf.fp8_rewrite(_Products())
    torch.testing.assert_close(rewritten(x, which), plain, atol=0, rtol=0)
    # while the same module's qualifying product is rewritten
    assert torch.equal(rewritten(x, "big"), tf.fp8_dot(x, model.big))


class _Block(nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(2)
        self.w = nn.Parameter(torch.randn(256, 256, generator=g) / 16)

    def forward(self, x):
        y = torch.tanh(x @ self.w)
        return y * 0.5 if self.training else y


class _Remat(nn.Module):
    def __init__(self, remat: bool):
        super().__init__()
        self.remat = remat
        self.block = _Block()

    def forward(self, x):
        if self.remat:
            return torch.utils.checkpoint.checkpoint(self.block, x, use_reentrant=False)
        return self.block(x)


def test_fp8_rewrite_remat_and_train_flag_pass_through():
    # a checkpointed submodule is rewritten and recomputed rewritten in the
    # backward (the same gradients as without remat); the train/eval flag
    # steers the forward as it does unrewritten
    x = torch.randn(8, 256, generator=torch.Generator().manual_seed(3))
    grads = []
    for remat in (False, True):
        model = tf.fp8_rewrite(_Remat(remat))
        out = model(x)
        assert torch.equal(out, torch.tanh(tf.fp8_dot(x, model.block.w)) * 0.5)
        out.sum().backward()
        grads.append(model.block.w.grad)
        model.eval()
        with torch.no_grad():
            assert torch.equal(model(x), torch.tanh(tf.fp8_dot(x, model.block.w)))
    torch.testing.assert_close(grads[1], grads[0], atol=0, rtol=0)


# -------------------------------------------------------------- Accelerator
def test_accelerator_fp8_sets_use_fp8_rewrites_modules_and_reports_native(tmp_path):
    _reset()
    try:
        acc = Accelerator(cpu=True, mixed_precision="fp8")
        assert acc.mixed_precision == "fp8" and acc.fp8_backend == "NATIVE"
        assert acc.policy.compute_dtype == "bfloat16" and acc.policy.param_dtype == "float32"
        cfg = tl.LlamaConfig.tiny()
        assert not cfg.use_fp8
        model = acc.prepare(tl.create_llama(cfg, device="cpu"))
        assert model.config.use_fp8 and isinstance(model.fp8_groups, tf.Fp8Groups)
        assert model.fp8_groups.act is None and model.fp8_groups.weight is None  # one process
        mlp = acc.prepare(_Mlp(_mlp_params(), linear=True))
        assert isinstance(mlp.module.fp8_rewrite, tf._Fp8Rewrite)
        _reset()
        assert Accelerator(cpu=True, mixed_precision="bf16").fp8_backend is None
        # launch --mixed_precision fp8 reaches the worker as its environment
        _reset()
        os.environ["ACCELERATE_MIXED_PRECISION"] = "fp8"
        try:
            assert Accelerator(cpu=True).fp8_backend == "NATIVE"
        finally:
            del os.environ["ACCELERATE_MIXED_PRECISION"]
        from accelerate_tpu_torch.commands import launch

        assert launch.main(["--mixed_precision", "fp8", "--dry_run", "script.py"]) == 0
    finally:
        _reset()


def test_accelerator_fp8_trains_a_generic_module_with_decreasing_loss():
    # the JAX test_fp8_arbitrary_model_through_accelerator: 256 -> 512 -> 8,
    # SGD, five train_step calls
    _reset()
    try:
        acc = Accelerator(cpu=True, mixed_precision="fp8")
        model = _Mlp(_mlp_params(), linear=False)
        opt = torch.optim.SGD(model.parameters(), lr=1e-2)
        model, opt = acc.prepare(model, opt)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32))
        y = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
        step = acc.train_step(lambda m, b: ((m(b["x"]) - b["y"]) ** 2).mean())
        losses = [step({"x": x, "y": y}).item() for _ in range(5)]
    finally:
        _reset()
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# --------------------------------------------------------------- tiny Llama
@pytest.fixture(scope="module")
def params():
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(jcfg, jax.random.key(0)))


def _configs(dtype, **kw):
    jcfg = jl.LlamaConfig.tiny(compute_dtype=JDT[dtype], attention_impl="xla",
                               attention_kv_block=16, use_fp8=True, **kw)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=dtype, attention_impl="flash", use_fp8=True, **kw)
    return jcfg, tcfg


def _llama_batch():
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    return {"input_ids": ids, "loss_mask": (rng.random((2, 15)) < 0.8).astype(np.float32)}


@pytest.fixture(scope="module")
def jax_llama(params):
    """JAX ``llama_apply`` logits, ``llama_loss`` and its gradients with
    ``use_fp8``, in f32 and in bf16, run eagerly (``jax.disable_jit``):
    eager JAX divides ``1 / scale`` exactly, as the port does, where a
    compiled scan body computes ``amax * (1 / 448)`` (one ulp off at times,
    and one ulp of a scale flips fp8 roundings)."""
    batch = _llama_batch()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        jcfg, _ = _configs(dtype)

        def j_loss(p):
            return jl.llama_loss(lambda i, **kw: jl.llama_apply(jcfg, p, i, **kw),
                                 {k: jnp.asarray(v) for k, v in batch.items()})

        with jax.disable_jit():
            logits = jl.llama_apply(jcfg, jparams, jnp.asarray(batch["input_ids"]))
            value, grads = jax.value_and_grad(j_loss)(jparams)
        out[dtype] = (_np(logits), float(value),
                      {jax.tree_util.keystr(k): _np(g) for k, g in jax.tree_util.tree_leaves_with_path(grads)})
    return out


def _port_llama(params, dtype, **kw):
    """The port's (logits, loss, gradients by key path) of the tiny Llama."""
    _, tcfg = _configs(dtype, **kw)
    batch = _llama_batch()
    model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
    with torch.no_grad():
        logits = model(torch.from_numpy(batch["input_ids"]))
    loss = tl.llama_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    grads = {jax.tree_util.keystr(path): _np(_param(model, path).grad)
             for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    return _np(logits), loss.item(), grads


def _param(model, path):
    return model.get_parameter("__".join(key.key for key in path))


def test_tiny_llama_fp8_f32_apply_loss_and_gradients_match_jax(params, jax_llama):
    jlogits, jloss, jgrads = jax_llama[torch.float32]
    logits, loss, grads = _port_llama(params, torch.float32)
    _close(logits, jlogits, LLAMA_RTOL, "logits")
    np.testing.assert_allclose(loss, jloss, rtol=LLAMA_RTOL)
    for key, jg in jgrads.items():
        _close(grads[key], jg, LLAMA_RTOL, key)
    # fp8 moved them: the same model without it is far outside that
    _, tcfg = _configs(torch.float32)
    plain = tl.LlamaForCausalLM(dataclasses.replace(tcfg, use_fp8=False),
                                tl.params_from_jax(tcfg, params, device="cpu"))
    with torch.no_grad():
        off = _np(plain(torch.from_numpy(_llama_batch()["input_ids"])))
    assert np.abs(off - jlogits).max() > 100 * LLAMA_RTOL * np.abs(jlogits).max()


def _distance(a, b) -> dict:
    """How far run ``a`` (logits, loss, gradients) is from run ``b``: the
    loss's relative difference, the logits' relative Frobenius distance and
    the largest gradient leaf's."""
    fro = lambda x, y: float(np.linalg.norm(x - y) / np.linalg.norm(y))
    return {"loss": abs(a[1] - b[1]) / abs(b[1]), "logits": fro(a[0], b[0]),
            "grads": max(fro(a[2][k], b[2][k]) for k in b[2])}


def test_tiny_llama_fp8_bf16_is_as_close_to_jax_as_bf16_rounding_allows(params, jax_llama):
    # bf16 rounds where XLA and PyTorch round differently (1-2 % apart
    # without fp8, tests/test_torch_llama_train.py), and each product's
    # next quantization turns a one-ulp difference into a neighbouring fp8
    # value a sixteenth of the time, a step of 6-25 %: the JAX bf16 run is
    # itself ~10 % (logits) and ~20 % (gradients) from the JAX f32 run. The
    # port's bf16 run must be no farther from JAX's bf16 run than
    # BF16_BAND times that distance; in f32 the two agree to 1e-5
    port = _port_llama(params, torch.bfloat16)
    band = _distance(jax_llama[torch.bfloat16], jax_llama[torch.float32])
    got = _distance(port, jax_llama[torch.bfloat16])
    for name, value in got.items():
        assert value <= BF16_BAND * band[name], (name, value, band[name])
    assert all(np.isfinite(g).all() for g in port[2].values())


def test_tiny_llama_fp8_remat_policies_give_the_same_gradients(params):
    # recomputing a layer quantizes the same values again: every policy's
    # gradients are those of keeping every activation, bitwise
    _, tcfg = _configs(torch.float32)
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 256, size=(2, 12)).astype(np.int64))
    grads = {}
    for policy in tl.REMAT_POLICIES:
        cfg = dataclasses.replace(tcfg, remat_policy=policy)
        model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
        tl.llama_loss(model, {"input_ids": ids}).backward()
        grads[policy] = {n: p.grad for n, p in model.named_parameters()}
    for policy, leaves in grads.items():
        for name, g in leaves.items():
            torch.testing.assert_close(g, grads["full"][name], atol=0, rtol=0,
                                       msg=f"{policy} {name}")


def _jax_fp8_trajectory(params, batches, opt_name):
    """The compiled JAX ``train_step`` under ``mixed_precision="fp8"`` at
    ``dp_shard_size=8``, its policy kept f32 (the default fp8 policy casts
    the parameters to bf16 for the forward, which the port's Llama leaves
    to its config's compute dtype): each step's loss and the parameters
    after the last."""
    from accelerate_tpu.utils.dataclasses import MixedPrecisionPolicy as JPolicy

    for s in (JAcceleratorState, JGradientState, JPartialState):
        s._reset_state()
    try:
        jcfg, _ = _configs(torch.float32)
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=8),
                           mixed_precision="fp8", kwargs_handlers=[JPolicy()])
        model = jl.create_llama(dataclasses.replace(jcfg, use_fp8=False), seed=0)
        model.params = jax.tree_util.tree_map(jnp.asarray, params)
        tx = (optax.sgd(TRAJ_LR["sgd"]) if opt_name == "sgd"
              else optax.adamw(TRAJ_LR["adamw"], weight_decay=0.01))
        model, tx = acc.prepare(model, tx)
        assert model.config.use_fp8
        step = acc.train_step(jl.llama_loss, max_grad_norm=1.0)
        losses = [float(step({k: jnp.asarray(v) for k, v in b.items()})) for b in batches]
        return losses, jax.tree_util.tree_map(np.asarray, model.params)
    finally:
        for s in (JAcceleratorState, JGradientState, JPartialState):
            s._reset_state()


@pytest.mark.parametrize("opt_name", ["sgd", "adamw"])
def test_fp8_train_step_trajectory_matches_jax(params, opt_name):
    from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy

    data = np.random.default_rng(6).integers(0, 256, size=(8 * TRAJ_UPDATES, 16)).astype(np.int32)
    batches = [{"input_ids": data[i:i + 8]} for i in range(0, len(data), 8)]
    jlosses, jparams = _jax_fp8_trajectory(params, batches, opt_name)
    _reset()
    try:
        acc = Accelerator(cpu=True, mixed_precision="fp8", kwargs_handlers=[MixedPrecisionPolicy()])
        _, tcfg = _configs(torch.float32)
        tcfg = dataclasses.replace(tcfg, use_fp8=False)
        model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
        if opt_name == "sgd":
            opt = torch.optim.SGD(model.parameters(), lr=TRAJ_LR["sgd"])
        else:
            opt = torch.optim.AdamW(model.parameters(), lr=TRAJ_LR["adamw"], betas=(0.9, 0.999),
                                    eps=1e-8, weight_decay=0.01)
        model, opt = acc.prepare(model, opt)
        assert model.config.use_fp8
        step = acc.train_step(tl.llama_loss, max_grad_norm=1.0)
        losses = [step({"input_ids": torch.from_numpy(b["input_ids"])}).item() for b in batches]
    finally:
        _reset()
    np.testing.assert_allclose(losses, jlosses, rtol=TRAJ_LOSS_RTOL[opt_name])
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=LLAMA_RTOL)  # before any update
    tparams, loose, total = model.params, 0, 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        got = tparams
        for key in path:
            got = got[key.key]
        diff = np.abs(got.numpy() - leaf)
        loose += int((diff > TRAJ_PARAM_ATOL[opt_name]).sum())
        total += leaf.size
        assert diff.max() <= TRAJ_PARAM_MAX[opt_name], jax.tree_util.keystr(path)
    assert loose <= TRAJ_LOOSE_SHARE * total, (loose, total)


# ---------------------------------------------------------------- generate
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_greedy_generate_with_fp8_prefill_equals_jax(kv):
    # JAX prefills a use_fp8 model through fp8 and decodes in the compute
    # dtype, as the port does
    jmodel = jl.create_llama(jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash",
                                                 use_fp8=True), seed=0)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", use_fp8=True)
    tmodel = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(
        tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu"))
    ids = np.random.default_rng(7).integers(4, 256, size=(3, 7)).astype(np.int32)
    kw = dict(kv_backend=kv, kv_block_size=4)
    want = np.asarray(jinf.generate(jmodel, ids, 10, **kw))
    got = generate(tmodel, ids, 10, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    # the prefill ran fp8: its logits are fp8_dot's, not the compute dtype's
    with torch.no_grad():
        fp8_logits, _ = tl.llama_prefill(tcfg, tmodel.params, torch.from_numpy(ids).long(), 17)
        plain_logits, _ = tl.llama_prefill(dataclasses.replace(tcfg, use_fp8=False), tmodel.params,
                                           torch.from_numpy(ids).long(), 17)
    assert not torch.equal(fp8_logits, plain_logits)


def test_kernels_in_ranges_reads_a_trace_by_range():
    # the kernels, memsets and copies of the ops inside a range's host
    # interval, on its thread: what phase 16 and train_timing.py sum
    events = [
        {"cat": "user_annotation", "name": "fp8_quantize", "tid": 1, "ts": 0, "dur": 10},
        {"cat": "user_annotation", "name": "fp8_layout", "tid": 1, "ts": 30, "dur": 5},
        {"cat": "cpu_op", "name": "aten::mul_", "tid": 1, "ts": 2, "args": {"External id": 5}},
        {"cat": "cpu_op", "name": "aten::mm", "tid": 1, "ts": 20, "args": {"External id": 6}},
        {"cat": "cpu_op", "name": "aten::copy_", "tid": 2, "ts": 3, "args": {"External id": 7}},
        {"cat": "cpu_op", "name": "aten::copy_", "tid": 1, "ts": 31, "args": {"External id": 8}},
        {"cat": "kernel", "name": "mul", "ts": 100, "dur": 1000, "args": {"External id": 5}},
        {"cat": "gpu_memset", "name": "memset", "ts": 101, "dur": 500, "args": {"External id": 5}},
        {"cat": "kernel", "name": "gemm", "ts": 102, "dur": 9000, "args": {"External id": 6}},
        {"cat": "kernel", "name": "other_thread", "ts": 103, "dur": 7000, "args": {"External id": 7}},
        {"cat": "kernel", "name": "transpose", "ts": 104, "dur": 250, "args": {"External id": 8}},
    ]
    assert tf.kernels_in_ranges(events) == {"fp8_quantize": [("mul", 1.0), ("memset", 0.5)],
                                            "fp8_layout": [("transpose", 0.25)]}
    assert tf.kernels_in_ranges([]) == {"fp8_quantize": [], "fp8_layout": []}
