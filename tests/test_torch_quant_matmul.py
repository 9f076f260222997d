"""The port's quantized matmul (kernel B7's plain version, and the kernel on
a card) against the JAX package's ``quantized_matmul`` run through its
Pallas kernel in interpret mode.

Tolerances:
* f32 x: atol = rtol = 1e-5 (both sum the same exact f32 products, in
  another order);
* bf16 and f16 x: one output ulp (rtol 2^-7 for bf16, 2^-10 for f16): both
  round x to bf16, whose products with int8 values are exact in f32, so
  only the f32 summation order differs, and that can move the final
  rounding by one ulp;
* kernel against plain on the card: the same one-ulp bounds (f32: 1e-4 of
  the largest output, the sum running over up to 14,336 terms).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.ops.quant_matmul import quantized_matmul as j_qmm
from accelerate_tpu.utils.quantization import _quantize_array
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops.quant_matmul import quantized_matmul, quantized_matmul_plain

TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=0, rtol=2**-7),
       "float16": dict(atol=0, rtol=2**-10)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


def _np(x):
    return x.detach().cpu().float().numpy()


def _operands(lead, k, n, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(k, n)).astype(np.float32)
    q, scales = _quantize_array(w, bits=8)
    x = (rng.normal(size=(*lead, k)) / np.sqrt(k)).astype(np.float32)
    return x, q, scales.reshape(-1)


# (lead dims of x, K, N): an even shape, ragged M, K and N, a 3-D x
SHAPES = {"even": ((16,), 64, 32), "ragged": ((7,), 100, 20), "batched": ((2, 5), 40, 24)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_plain_matches_jax_interpret_kernel(shape, dtype):
    lead, k, n = SHAPES[shape]
    x, q, scales = _operands(lead, k, n)
    jx = jnp.asarray(x, dtype=dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = j_qmm(jx, jnp.asarray(q), jnp.asarray(scales), interpret=True)
    out = quantized_matmul(tx, torch.from_numpy(q), torch.from_numpy(scales))
    assert out.dtype == tx.dtype and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(_np(out), np.asarray(ref, dtype=np.float32), **TOL[dtype])


@pytest.mark.parametrize("scale_shape", [(-1,), (1, -1), (1, 1, -1)])
def test_scales_of_any_shape_with_n_elements(scale_shape):
    x, q, scales = _operands((6,), 48, 16, seed=1)
    args = (torch.from_numpy(x), torch.from_numpy(q))
    want = quantized_matmul(*args, torch.from_numpy(scales))
    got = quantized_matmul(*args, torch.from_numpy(scales.reshape(scale_shape)))
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    if len(scale_shape) <= 2:  # the JAX function takes (N,) and (1, N)
        ref = j_qmm(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scales.reshape(scale_shape)),
                    interpret=True)
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL["float32"])


def test_inner_dims_mismatch_raises_like_jax():
    with pytest.raises(ValueError, match="Inner dims"):
        j_qmm(jnp.ones((2, 8)), jnp.ones((4, 16), jnp.int8), jnp.ones(16), interpret=True)
    with pytest.raises(ValueError, match="Inner dims"):
        quantized_matmul(torch.ones((2, 8)), torch.ones((4, 16), dtype=torch.int8), torch.ones(16))
    with pytest.raises(ValueError, match="N=16"):
        quantized_matmul(torch.ones((2, 4)), torch.ones((4, 16), dtype=torch.int8), torch.ones(15))


def test_plain_is_the_dequantized_product():
    # column-wise scales fold in after the sum: the same function as x @ (q * s)
    x, q, scales = _operands((9,), 80, 24, seed=2)
    out = quantized_matmul_plain(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(scales))
    np.testing.assert_allclose(_np(out), x @ (q.astype(np.float32) * scales), atol=1e-5, rtol=1e-5)


# the card: the main path's shapes at decode and prefill M, the ragged edge,
# int4-range codes and an f16 x, each against the plain version
CARD_CASES = [
    (8, 4096, 14336, torch.bfloat16), (2048, 14336, 4096, torch.bfloat16),
    (8, 4096, 14336, torch.float32), (7, 4100, 1000, torch.bfloat16),
    (130, 4100, 1000, torch.float32), (64, 512, 384, torch.float16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype", CARD_CASES)
def test_kernel_matches_plain_on_card(cuda_device, m, k, n, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qmax = 7 if n == 384 else 127  # one int4-range case
    q = torch.randint(-qmax, qmax + 1, (k, n), generator=gen, device=cuda_device, dtype=torch.int8)
    scales = (0.5 + torch.rand(n, generator=gen, device=cuda_device)) * 0.3 / (qmax * 0.6 * k ** 0.5)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    before = _build.launch_counts()["quant_matmul"]
    out = quantized_matmul(x, q, scales)
    ref = quantized_matmul_plain(x, q, scales)
    torch.cuda.synchronize()
    assert _build.launch_counts()["quant_matmul"] == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    if dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    else:
        # atol: outputs that cancel to near zero, where f32 order matters more than an ulp
        tol = dict(TOL[str(dtype).removeprefix("torch.")], atol=1e-5)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
