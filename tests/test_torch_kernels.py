"""The port's kernel variants: the routing that picks B1's, B2/B3's and
B7's variant (pure Python, on the CPU), the kernel registry, and every
variant against its plain version on the card (``cuda``-marked).

This file imports no JAX, so its ``cuda``-marked tests also run on a GPU
machine that has none, without the suite's conftest (which imports JAX):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -m cuda

Tolerances on the card (kernel against plain version on the same inputs):
* B1: bf16 out 2e-2 (a few bf16 ulps of outputs of order 1: both round P
  to bf16, from f32 scores summed in another order), f32 out 1e-4; lse
  1e-4 (f32 both ways).
* B2/B3: each gradient within 2e-2 (bf16) or 1e-4 (f32) of its largest
  entry: both sides round p and ds to bf16 before the products (an ulp
  flip where the two f32 sums straddle a rounding boundary moves a
  gradient by up to one bf16 ulp of its largest terms, 2^-8 relative);
  two launches of the same inputs give bitwise equal gradients.
* B7: one output ulp (rtol 2^-7 bf16, 2^-10 f16) with atol 1e-5 for
  outputs that cancel to near zero; f32 1e-4 of the largest output, also
  for the f32 output of a bf16 x (the LM head's logits). bf16 x int8
  products are exact in f32, so only the f32 summation order differs.
"""

import ast
import importlib.util
import math
import re
from pathlib import Path

import pytest
import torch

from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.ops.flash_attention import (
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_attention_with_lse,
    flash_bwd_kernel_for,
    flash_fwd_block_q,
    flash_fwd_kernel_for,
)
from accelerate_tpu_torch.ops._build import FILL_BLOCKS, SMS
from accelerate_tpu_torch.ops.quant_matmul import (
    MMA_BK,
    MMA_BN,
    qmm_plan,
    quantized_matmul,
    quantized_matmul_plain,
)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "accelerate_tpu_torch" / "csrc"

# Llama-3-8B's projections: name -> (K, N)
LLAMA3_8B = {"q_o": (4096, 4096), "k_v": (4096, 1024), "gate_up": (4096, 14336),
             "down": (14336, 4096), "head": (4096, 128256)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------- routing
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(LLAMA3_8B))
def test_decode_projection_takes_split_k_filling_the_card(name, dtype):
    k, n = LLAMA3_8B[name]
    plan = qmm_plan(8, k, n, dtype)
    assert plan.kernel == "quant_matmul_splitk"
    assert plan.slices * math.ceil(n / MMA_BN) >= FILL_BLOCKS
    # slices of whole 64-deep K tiles that cover K, none of them empty
    k_tiles = math.ceil(k / MMA_BK)
    assert plan.k_tiles_per_slice >= 1
    assert (plan.slices - 1) * plan.k_tiles_per_slice < k_tiles <= plan.slices * plan.k_tiles_per_slice


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("name", sorted(LLAMA3_8B))
def test_prefill_projection_takes_tensor_cores(name, dtype):
    k, n = LLAMA3_8B[name]
    plan = qmm_plan(2048, k, n, dtype)
    assert plan.kernel == "quant_matmul_mma"
    # at least one block per SM: k_v's 128-row tiles would be 16 x 8 = 128
    assert math.ceil(2048 / plan.block_m) * math.ceil(n / MMA_BN) >= SMS
    assert plan.block_m == (64 if name == "k_v" else 128)


@pytest.mark.parametrize("m,kernel", [(1, "quant_matmul_splitk"), (16, "quant_matmul_splitk"),
                                      (17, "quant_matmul_mma"), (65, "quant_matmul_mma")])
def test_row_count_picks_the_variant(m, kernel):
    assert qmm_plan(m, 4096, 4096, torch.bfloat16).kernel == kernel


@pytest.mark.parametrize("m,k,n,dtype,aligned", [
    (8, 4096, 4096, torch.float32, True),      # f32 x keeps f32 products
    (2048, 14336, 4096, torch.float32, True),
    (7, 4100, 1000, torch.bfloat16, True),     # x rows of 8,200 bytes, q rows of 1,000
    (130, 4096, 1000, torch.bfloat16, True),   # q rows only
    (130, 4100, 1024, torch.float16, True),    # x rows only
    (2048, 4096, 4096, torch.bfloat16, False),  # an unaligned base address
])
def test_fma_kernel_serves_f32_and_unaligned(m, k, n, dtype, aligned):
    assert qmm_plan(m, k, n, dtype, aligned).kernel == "quant_matmul"


@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "flash_fwd_mma"),
                                          (torch.float32, "flash_fwd")])
def test_flash_forward_variant_by_dtype(dtype, kernel):
    assert flash_fwd_kernel_for(dtype) == kernel


@pytest.mark.parametrize("b,h,sq,block_q", [(4, 32, 2048, 128), (4, 32, 512, 128),
                                            (1, 32, 512, 64), (2, 8, 1000, 64)])
def test_flash_block_rows_fill_the_card(b, h, sq, block_q):
    assert flash_fwd_block_q(b, h, sq) == block_q


def test_flash_forward_refuses_other_dtypes():
    with pytest.raises(TypeError):
        flash_fwd_kernel_for(torch.float16)


@pytest.mark.parametrize("dtype,kernels", [
    (torch.bfloat16, ("flash_bwd_dq_mma", "flash_bwd_dkv_mma")),
    (torch.float32, ("flash_bwd_dq", "flash_bwd_dkv")),
])
def test_flash_backward_variant_by_dtype(dtype, kernels):
    assert flash_bwd_kernel_for(dtype) == kernels
    assert all(name in _build.KERNELS for name in kernels)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32])
def test_flash_backward_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError):
        flash_bwd_kernel_for(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_quantized_matmul_f32_output_is_the_unrounded_sum(dtype):
    # the plain version (what a CPU tensor runs): the f32 output is the f32
    # sum times the scale, which x's-dtype output rounds once
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((5, 64), generator=gen).to(dtype)
    q = torch.randint(-127, 128, (64, 48), generator=gen, dtype=torch.int8)
    scales = torch.rand(48, generator=gen) * 0.01
    f32 = quantized_matmul(x, q, scales, out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    torch.testing.assert_close(f32.to(dtype), quantized_matmul(x, q, scales), atol=0, rtol=0)
    compute = torch.float32 if dtype == torch.float32 else torch.bfloat16
    ref = (x.to(compute).double() @ q.double()) * scales.double()
    torch.testing.assert_close(f32.double(), ref, atol=1e-5 * ref.abs().max().item(), rtol=0)
    with pytest.raises(TypeError, match="float32"):
        quantized_matmul(x, q, scales, out_dtype=torch.float64)


# ------------------------------------------------------------ registry
@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_every_kernel_has_its_source_and_its_line_in_chip_smoke(name):
    source = CSRC / _build.KERNELS[name]
    assert re.search(rf'extern "C" int {name}\(', source.read_text())
    meta = _chip_smoke().KERNEL_META[name]
    assert meta["source"] == f"accelerate_tpu_torch/csrc/{_build.KERNELS[name]}"
    assert meta["route"] == "cuda"


def test_chip_smoke_lists_only_registered_kernels_and_imports_no_jax():
    assert set(_chip_smoke().KERNEL_META) == set(_build.KERNELS)
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    imported = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
                for a in node.names}
    imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                 if isinstance(node, ast.ImportFrom) and node.module}
    assert not imported & {"jax", "jaxlib", "accelerate_tpu"}


# ------------------------------------------------------------ the card
def _segments(bounds_per_row, s, dev):
    rows = []
    for bounds in bounds_per_row:
        starts = torch.tensor(bounds[1:], device=dev)
        rows.append(torch.bucketize(torch.arange(s, device=dev), starts, right=True))
    return torch.stack(rows).to(torch.int32)


# name -> (B, Sq, Skv, H, Hkv, D, causal, window, softcap, document starts)
FLASH_CARD_CASES = {
    "ragged_333_d64_rep1": (1, 333, 333, 4, 4, 64, True, None, None, None),
    "ragged_1000_rep4": (2, 1000, 1000, 8, 2, 128, True, None, None, None),
    "segments_off_grid": (2, 300, 300, 8, 2, 128, True, None, None, [(0, 37, 190), (0, 100, 250)]),
    "window_softcap": (2, 512, 512, 8, 2, 128, True, 100, 30.0, None),
    "window_d64": (1, 333, 333, 4, 1, 64, True, 70, None, None),
    "sq_lt_skv": (1, 200, 520, 8, 8, 64, True, None, None, None),
    "sq_gt_skv_noncausal": (1, 300, 130, 8, 2, 128, False, None, None, None),
    # enough blocks for 128-row tiles (32 rows a warp)
    "rows128_ragged_1000": (4, 1000, 1000, 32, 8, 128, True, None, None, None),
    "rows128_window_softcap_d64": (4, 700, 700, 32, 8, 64, True, 150, 30.0, None),
    "rows128_segments": (4, 600, 600, 32, 8, 128, True, None, None,
                         [(0, 37, 190), (0, 100, 250), (0, 300), (0, 599)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(FLASH_CARD_CASES))
def test_flash_kernel_matches_plain_on_card(cuda_device, case, dtype, tol):
    b, sq, skv, h, h_kv, d, causal, window, softcap, docs = FLASH_CARD_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn((b, sq, h, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((b, skv, h_kv, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((b, skv, h_kv, d), generator=gen, device=cuda_device).to(dtype)
    seg = None if docs is None else _segments(docs, sq, cuda_device)
    opts = dict(causal=causal, window=window, softcap=softcap, segment_ids=seg)
    name = flash_fwd_kernel_for(dtype)
    before = _build.launch_counts()[name]
    out, lse = flash_attention_with_lse(q, k, v, **opts)
    ref, ref_lse = flash_attention_reference(q, k, v, **opts)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (lse - ref_lse).abs().max().item() <= 1e-4


def _qmm_operands(dev, m, k, n, dtype, qmax=127):
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randint(-qmax, qmax + 1, (k, n), generator=gen, device=dev, dtype=torch.int8)
    scales = (0.5 + torch.rand(n, generator=gen, device=dev)) * 0.3 / (qmax * 0.6 * k ** 0.5)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    return x, q, scales


def _check_qmm(x, q, scales):
    m, k = x.shape
    n = q.shape[1]
    kernel = qmm_plan(m, k, n, x.dtype).kernel
    before = _build.launch_counts()[kernel]
    out = quantized_matmul(x, q, scales)
    ref = quantized_matmul_plain(x, q, scales)
    torch.cuda.synchronize()
    assert _build.launch_counts()[kernel] == before + 1
    assert out.dtype == x.dtype and out.shape == (m, n)
    if x.dtype == torch.float32:
        assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    else:
        rtol = 2 ** -7 if x.dtype == torch.bfloat16 else 2 ** -10
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64, 65, 2048])
@pytest.mark.parametrize("name", sorted(LLAMA3_8B))
def test_kernel_matches_plain_on_card(cuda_device, name, m):
    k, n = LLAMA3_8B[name]
    _check_qmm(*_qmm_operands(cuda_device, m, k, n, torch.bfloat16))


# int4-range codes, f16 x, f32 x and the ragged shapes of the FMA kernel
QMM_EDGE_CASES = [
    (8, 4096, 14336, torch.bfloat16, 7), (2048, 4096, 1024, torch.bfloat16, 7),
    (8, 4096, 14336, torch.float16, 127), (100, 512, 384, torch.float16, 7),
    (2048, 14336, 4096, torch.float16, 127), (8, 4096, 14336, torch.float32, 127),
    (7, 4100, 1000, torch.bfloat16, 127), (130, 4100, 1000, torch.float32, 127),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dtype,qmax", QMM_EDGE_CASES)
def test_kernel_edges_match_plain_on_card(cuda_device, m, k, n, dtype, qmax):
    _check_qmm(*_qmm_operands(cuda_device, m, k, n, dtype, qmax))


# name -> (B, Sq, Skv, H, Hkv, D, causal, window, softcap, document starts, lse cotangent)
FLASH_BWD_CARD_CASES = {
    "ragged_200_segments": (2, 200, 200, 8, 2, 128, True, None, None, [(0, 77), (0, 77)], False),
    "ragged_1000_d64_rep1": (1, 1000, 1000, 4, 4, 64, True, None, None, None, False),
    "ragged_1000_rep4_lse": (2, 1000, 1000, 8, 2, 128, True, None, None, None, True),
    "segments_off_grid": (2, 300, 300, 8, 2, 128, True, None, None,
                          [(0, 37, 190), (0, 100, 250)], False),
    "segments_d64_lse": (2, 600, 600, 8, 8, 64, True, None, None, [(0, 1, 333), (0, 599)], True),
    "window_softcap": (2, 512, 512, 8, 2, 128, True, 100, 30.0, None, False),
    "window_softcap_d64_rep4": (1, 333, 333, 4, 1, 64, True, 70, 30.0, None, False),
    "sq_lt_skv": (1, 200, 520, 8, 8, 64, True, None, None, None, False),
    "sq_gt_skv_causal": (1, 300, 130, 8, 2, 128, True, None, None, None, True),
    "sq_gt_skv_noncausal": (1, 300, 130, 8, 2, 128, False, None, None, None, False),
    "noncausal_softcap_rep1": (2, 257, 257, 4, 4, 128, False, None, 30.0, None, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(FLASH_BWD_CARD_CASES))
def test_flash_backward_kernels_match_plain_on_card(cuda_device, case, dtype, tol):
    # the autograd backward (B2 then B3, the variant for the dtype) against
    # the plain backward given the plain forward's out and lse; tolerance
    # relative to each gradient's largest entry; a second backward on the
    # same inputs is bitwise equal (each block owns its output rows)
    b, sq, skv, h, h_kv, d, causal, window, softcap, docs, with_dlse = FLASH_BWD_CARD_CASES[case]
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, do = (torch.randn((b, sq, h, d), generator=gen, device=cuda_device).to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, skv, h_kv, d), generator=gen, device=cuda_device).to(dtype)
            for _ in range(2))
    dlse = torch.randn((b, h, sq), generator=gen, device=cuda_device) if with_dlse else None
    seg = None if docs is None else _segments(docs, sq, cuda_device)
    opts = dict(causal=causal, window=window, softcap=softcap, segment_ids=seg)
    names = flash_bwd_kernel_for(dtype)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = _build.launch_counts()
    runs = []
    for _ in range(2):
        out, lse = flash_attention_with_lse(*leaves, **opts)
        outputs, cots = ((out, lse), (do, dlse)) if with_dlse else ((out,), (do,))
        runs.append(torch.autograd.grad(outputs, leaves, cots))
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert all(after[n] == before[n] + 2 for n in names)
    ref_out, ref_lse = flash_attention_reference(q, k, v, **opts)
    ref = flash_attention_bwd_reference(q, k, v, ref_out, ref_lse, do, dlse=dlse, **opts)
    for g, g2, r in zip(*runs, ref):
        assert g.dtype == dtype and g.shape == r.shape
        assert torch.equal(g, g2)
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 2048])
def test_kernel_f32_output_matches_plain_on_card(cuda_device, m):
    # the LM head's shape: bf16 x, f32 logits from the f32 sums x scales
    k, n = LLAMA3_8B["head"]
    x, q, scales = _qmm_operands(cuda_device, m, k, n, torch.bfloat16)
    kernel = qmm_plan(m, k, n, x.dtype).kernel
    before = _build.launch_counts()[kernel]
    out = quantized_matmul(x, q, scales, out_dtype=torch.float32)
    ref = quantized_matmul_plain(x, q, scales, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert _build.launch_counts()[kernel] == before + 1
    assert out.dtype == torch.float32 and out.shape == (m, n)
    assert (out - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
