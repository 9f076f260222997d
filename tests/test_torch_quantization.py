"""The port's weight quantization against the JAX package's
(``accelerate_tpu/utils/quantization.py``) on numpy-seeded inputs.

Tolerances:
* quantized bytes (int8 and int4 ``q`` and scales, per channel and per
  block; NF4 packed codes, absmax, double-quant residuals, group scales and
  offset): exact; both sides divide in f32, round half to even and clip;
* dequantized values: exact (one f32 multiply, or a multiply and an add,
  per element on both sides);
* the tiny Llama forward (f32 compute) through ``quantize_model``: atol =
  rtol = 1e-4, as for the unquantized forward: the projections' f32
  matmuls sum in another order, and a per-channel projection runs as
  ``(y @ q) * scale`` in the port against ``y @ (q * scale)`` in JAX (the
  same function, rounded differently);
* the generic module's forward: atol = rtol = 1e-5 (one dequantized f32
  matmul on each side).
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from accelerate_tpu.model import Model
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils import quantization as tq

EXACT = dict(atol=0, rtol=0)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _weights(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    # one column whose amax is 127 (scale exactly 1.0 in int8) holding
    # halves, so round-half-to-even is exercised, and one all-zero column
    # (amax clamps at 1e-12); a vector, scaled per element, gets a zero
    if x.ndim < 2:
        x[0] = 0.0
        return x
    col = np.zeros(x[..., 0].size, np.float32)
    col[:4] = [127.0, 2.5, -3.5, 0.5]
    x[..., 0] = col.reshape(x[..., 0].shape)
    x[..., 1] = 0.0
    return x


ARRAY_CASES = {
    "int8_2d": ((64, 48), 8, None),
    "int8_stacked": ((3, 64, 48), 8, None),
    "int4_2d": ((64, 48), 4, None),
    "int4_stacked": ((3, 64, 48), 4, None),
    "int8_block_ragged": ((3, 70, 48), 8, 32),
    "int8_block_2d": ((64, 48), 8, 16),
    "int8_vector": ((300,), 8, None),
}


@pytest.mark.parametrize("case", sorted(ARRAY_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_array_bytes_equal_jax(case, dtype):
    shape, bits, block = ARRAY_CASES[case]
    x = _weights(shape)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    q_j, s_j = jq._quantize_array(jax.device_get(jx), bits, block_size=block)
    q_t, s_t = tq._quantize_array(tx, bits, block_size=block)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    assert tuple(s_t.shape) == s_j.shape
    np.testing.assert_array_equal(_np(q_t), q_j)
    np.testing.assert_array_equal(_np(s_t), s_j)
    # dequantize: same bytes in, same values out
    jleaf = jq.QuantizedLeaf(jnp.asarray(q_j), jnp.asarray(s_j), jnp.float32, block)
    tleaf = tq.QuantizedLeaf(q_t, s_t, torch.float32, block)
    np.testing.assert_array_equal(_np(tleaf.dequantize()), np.asarray(jleaf.dequantize()))


NF4_CASES = {
    "2d": ((64, 48), 64),
    "stacked": ((3, 64, 48), 64),
    "odd_ragged": ((3, 7, 5), 16),  # 105 elements: a padded block and an odd count
    "many_groups": ((520, 64), 64),  # 520 blocks: three double-quant groups, the last ragged
}


@pytest.mark.parametrize("case", sorted(NF4_CASES))
@pytest.mark.parametrize("double_quant", [False, True])
def test_nf4_bytes_equal_jax(case, double_quant):
    shape, block = NF4_CASES[case]
    x = _weights(shape, seed=1)
    jleaf = jq.nf4_quantize_leaf(jnp.asarray(x), block=block, double_quant=double_quant)
    tleaf = tq.nf4_quantize_leaf(torch.from_numpy(x), block=block, double_quant=double_quant)
    assert tleaf.packed.dtype == torch.uint8 and tleaf.shape == jleaf.shape
    np.testing.assert_array_equal(_np(tleaf.packed), np.asarray(jleaf.packed))
    np.testing.assert_array_equal(_np(tleaf.absmax), np.asarray(jleaf.absmax))
    assert _np(tleaf.absmax).dtype == np.asarray(jleaf.absmax).dtype
    if double_quant:
        (g_t, off_t), (g_j, off_j) = tleaf.dq, jleaf.dq
        np.testing.assert_array_equal(_np(g_t), np.asarray(g_j))
        np.testing.assert_array_equal(_np(off_t), np.asarray(off_j))
    else:
        assert tleaf.dq is None and jleaf.dq is None
    np.testing.assert_array_equal(_np(tleaf.dequantize()), np.asarray(jleaf.dequantize()))


def test_config_validation_matches_jax():
    for bad in (dict(bnb_4bit_quant_type="fp4"), dict(int8_block_size=0)):
        with pytest.raises(ValueError):
            jq.QuantizationConfig(**bad)
        with pytest.raises(ValueError):
            tq.QuantizationConfig(**bad)
    assert tq.QuantizationConfig(load_in_4bit=True).bits == 4
    assert tq.QuantizationConfig().bits == 8


def _tiny(**kw):
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla", **kw)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="xla", **kw)
    return jcfg, tcfg


QCONFIGS = {
    "int8": dict(load_in_8bit=True),
    "int4": dict(load_in_4bit=True),
    "int8_block": dict(load_in_8bit=True, int8_block_size=16),
    "nf4_dq": dict(load_in_4bit=True, bnb_4bit_quant_type="nf4", bnb_4bit_use_double_quant=True),
}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


@pytest.mark.parametrize("name", ["int8", "int8_block", "nf4_dq"])
def test_quantize_params_selects_the_jax_paths(name):
    jcfg, tcfg = _tiny(attention_bias=True)
    jparams = jl.init_llama_params(jcfg, jax.random.key(0))
    tparams = tl.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jout = jq.quantize_params(jparams, jq.QuantizationConfig(**QCONFIGS[name]))
    tout = tq.quantize_params(tparams, tq.QuantizationConfig(**QCONFIGS[name]))
    is_leaf = lambda x: isinstance(x, (jq.QuantizedLeaf, jq.NF4Leaf))  # noqa: E731
    jflat = {"/".join(str(k.key) for k in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jout, is_leaf=is_leaf)[0]}
    tflat = dict(_leaves(tout))
    assert sorted(jflat) == sorted(tflat)
    jsel = sorted(p for p, v in jflat.items() if is_leaf(v))
    tsel = sorted(p for p, v in tflat.items() if isinstance(v, (tq.QuantizedLeaf, tq.NF4Leaf)))
    assert jsel == tsel
    # the seven stacked projections and the head; biases, norms and the embedding stay float
    assert len(tsel) == 8 and not any("bias" in p or "norm" in p or "embed" in p for p in tsel)
    for path in tsel:
        np.testing.assert_array_equal(_np(tflat[path].dequantize()),
                                      np.asarray(jflat[path].dequantize()))


@pytest.mark.parametrize("name", sorted(QCONFIGS))
def test_quantized_llama_forward_matches_jax(name):
    jcfg, tcfg = _tiny()
    jmodel = jl.create_llama(jcfg, seed=0)
    tparams = tl.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    tmodel = tl.LlamaForCausalLM(tcfg, tparams)
    jq.quantize_model(jmodel, jq.QuantizationConfig(**QCONFIGS[name]))
    tq.quantize_model(tmodel, tq.QuantizationConfig(**QCONFIGS[name]))
    assert isinstance(tmodel.params["lm_head"]["kernel"], (tq.QuantizedLeaf, tq.NF4Leaf))
    assert not any(isinstance(p, nn.Parameter) and "proj" in n for n, p in tmodel.named_parameters())
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 12)).astype(np.int32)
    jlogits = np.asarray(jmodel(jnp.asarray(ids)))
    with torch.no_grad():
        tlogits = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(tlogits), jlogits, **MODEL_TOL)


def test_quantized_leaves_move_with_the_model():
    _, tcfg = _tiny()
    model = tl.LlamaForCausalLM.from_seed(tcfg, seed=0, device="cpu")
    tq.quantize_model(model)  # default: int8
    buffers = dict(model.named_buffers())
    assert buffers["layers__mlp__down_proj__kernel.q"].dtype == torch.int8
    assert buffers["layers__mlp__down_proj__kernel.scales"].shape == (1, 1, tcfg.hidden_size)
    moved = model.to(torch.float64)  # .to() reaches the float buffers, not the int8 codes
    assert moved.params["lm_head"]["kernel"].scales.dtype == torch.float64
    assert moved.params["lm_head"]["kernel"].q.dtype == torch.int8


class _Linear(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w))

    def forward(self, x):
        return x @ self.w


@pytest.mark.parametrize("bits", [8, 4])
def test_generic_module_quantized_forward(bits):
    # tests/test_fp8_quantization.py's generic-model cases, and the JAX forward
    rng = np.random.default_rng(0)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    kw = dict(load_in_8bit=True) if bits == 8 else dict(load_in_4bit=True)
    jmodel = Model(lambda p, v: v @ p["w"], {"w": jnp.asarray(w)})
    jq.quantize_model(jmodel, jq.QuantizationConfig(min_weight_size=1, **kw))
    module = _Linear(w)
    ref = module(torch.from_numpy(x)).detach().numpy()
    out_module = tq.quantize_model(module, tq.QuantizationConfig(min_weight_size=1, **kw))
    assert out_module is module and not list(module.parameters())
    assert module.quantized_leaves["w"].q.dtype == torch.int8  # storage really is int8
    out = module(torch.from_numpy(x)).detach().numpy()
    rel = np.abs(out - ref).mean() / np.abs(ref).mean()
    assert rel < (0.02 if bits == 8 else 0.15)
    np.testing.assert_allclose(out, np.asarray(jmodel(jnp.asarray(x))), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(module(torch.from_numpy(x)).detach().numpy(), out, **EXACT)  # re-entrant


def test_quantize_params_skips_by_pattern_and_size():
    params = {
        "big": {"kernel": torch.ones((128, 64))},
        "norm": {"scale": torch.ones((4096,))},  # skipped by pattern
        "small": torch.ones((4,)),  # too small
        "ints": torch.ones((128, 64), dtype=torch.int32),  # not float
    }
    out = tq.quantize_params(params, tq.QuantizationConfig(load_in_8bit=True, min_weight_size=1024))
    assert isinstance(out["big"]["kernel"], tq.QuantizedLeaf)
    assert out["norm"]["scale"] is params["norm"]["scale"]
    assert out["small"] is params["small"] and out["ints"] is params["ints"]
    assert tq.dequantize_leaf(out["small"]) is params["small"]
