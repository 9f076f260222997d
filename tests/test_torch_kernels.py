"""The port's kernel variants: the routing that picks B1's, B2/B3's, B4's,
B5's and B7's variant, B4's, B5's and B6's launch plans and what their
wrappers refuse (pure Python, on the CPU), the kernel registry, and every
variant against its plain version on the card (``cuda``-marked), B4, B5
and B6 among them.

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
* B4 and B5: bf16 q 2e-2 (outputs of order 1: p rounded to bf16 before
  P.V, for an int8 pool too in the tensor-core variants, where the plain
  version keeps f32) and each output row within 2^-6 of its largest
  |reference| (ROW_RTOL), f32 q 1e-4 (f32 throughout, only the summation
  order differs); every variant twice on the same inputs is bitwise equal
  (the tensor-core ones' split partials combine in a fixed order).
* B6: token ids exactly equal to the plain version's, and to a second
  launch's.
"""

import ast
import importlib.util
import math
import re
from pathlib import Path

import numpy as np
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
from accelerate_tpu_torch.ops.attention import paged_attention
from accelerate_tpu_torch.ops.paged_decode import (
    SAMPLE_CLUSTER,
    SAMPLE_SMEM_LIMIT,
    decode_kernel_for,
    decode_plan,
    fused_sample,
    fused_sample_plan,
    fused_sample_reference,
    paged_flash_decode,
    paged_flash_verify,
    paged_flash_verify_reference,
    verify_kernel_for,
    verify_plan,
)
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


@pytest.mark.parametrize("q_dtype,pool_dtype,kernel", [
    (torch.bfloat16, torch.bfloat16, "paged_verify_mma"),
    (torch.bfloat16, torch.int8, "paged_verify_int8_mma"),
    (torch.float32, torch.float32, "paged_verify"),
    (torch.float32, torch.int8, "paged_verify_int8"),
])
def test_verify_variant_by_q_and_pool_dtype(q_dtype, pool_dtype, kernel):
    assert verify_kernel_for(q_dtype, pool_dtype) == kernel
    assert kernel in _build.KERNELS


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float16, torch.float16), (torch.float16, torch.int8),
])
def test_verify_variant_refuses_other_dtype_pairs(q_dtype, pool_dtype):
    with pytest.raises(TypeError):
        verify_kernel_for(q_dtype, pool_dtype)


# the engine's two verify shapes at Llama-3-8B (H = 32, Hkv = 8, 2,048
# positions a row): speculative verify (8 slots, W = 5) and a 512-token chunk
def test_verify_plan_splits_the_spec_shape_to_fill_the_card():
    plan = verify_plan(8, 5, 32, 8, 2048)
    assert (plan.block_rows, plan.key_tile, plan.row_tiles) == (32, 32, 1)
    assert plan.splits > 1
    assert 8 * 8 * plan.row_tiles * plan.splits >= FILL_BLOCKS
    # one head per kv head (n_rep = 1) fills it the same way
    mha = verify_plan(8, 5, 8, 8, 2048)
    assert 8 * 8 * mha.row_tiles * mha.splits >= FILL_BLOCKS


def test_verify_plan_does_not_split_the_chunk_shape():
    plan = verify_plan(1, 512, 32, 8, 2048)
    assert (plan.block_rows, plan.key_tile, plan.row_tiles, plan.splits) == (64, 64, 32, 1)
    assert 8 * plan.row_tiles >= SMS


@pytest.mark.parametrize("max_hist,splits", [(16, 1), (40, 2), (64, 2), (2048, 5)])
def test_verify_plan_never_splits_below_one_key_tile(max_hist, splits):
    assert verify_plan(8, 5, 32, 8, max_hist).splits == splits


def test_split_plans_fit_the_per_device_tickets():
    # the wrappers keep SMS int32 tickets per device, one per split group
    # (decode and verify share them)
    for b in (1, 2, 4, 8, 16, 17, 32):
        for h, h_kv in ((32, 8), (8, 8), (32, 4), (16, 2)):
            for w in (1, 5, 8, 16, 70, 512):
                plan = verify_plan(b, w, h, h_kv, 2048)
                if plan.splits > 1:
                    assert b * h_kv * plan.row_tiles < SMS
            for max_hist in (16, 1024, 2048):
                if decode_plan(b, h, h_kv, max_hist).splits > 1:
                    assert b * h_kv < SMS


@pytest.mark.parametrize("q_dtype,pool_dtype,kernel", [
    (torch.bfloat16, torch.bfloat16, "paged_decode_mma"),
    (torch.bfloat16, torch.int8, "paged_decode_int8_mma"),
    (torch.float32, torch.float32, "paged_decode"),
    (torch.float32, torch.int8, "paged_decode_int8"),
])
def test_decode_variant_by_q_and_pool_dtype(q_dtype, pool_dtype, kernel):
    assert decode_kernel_for(q_dtype, pool_dtype) == kernel
    assert kernel in _build.KERNELS


@pytest.mark.parametrize("q_dtype,pool_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
    (torch.float16, torch.float16), (torch.float16, torch.int8), (torch.int8, torch.int8),
])
def test_decode_variant_refuses_other_dtype_pairs(q_dtype, pool_dtype):
    with pytest.raises(TypeError):
        decode_kernel_for(q_dtype, pool_dtype)


# the engine's decode shape at Llama-3-8B (H = 32, Hkv = 8): 8 slots of
# 1,024 (phase 4) or 2,048 (phase 7) positions
@pytest.mark.parametrize("max_hist", [1024, 2048])
def test_decode_plan_splits_eight_slots_to_fill_the_card(max_hist):
    plan = decode_plan(8, 32, 8, max_hist)
    assert (plan.rows, plan.key_tile) == (4, 64)
    assert plan.splits > 1
    assert 8 * 8 * plan.splits >= FILL_BLOCKS
    # one head per kv head (n_rep = 1) fills it the same way
    mha = decode_plan(8, 8, 8, max_hist)
    assert mha.rows == 1 and 8 * 8 * mha.splits >= FILL_BLOCKS


@pytest.mark.parametrize("b,h,h_kv", [(17, 32, 8), (32, 32, 8), (8, 32, 32), (132, 8, 1)])
def test_decode_plan_does_not_split_a_grid_that_fills_the_card(b, h, h_kv):
    assert b * h_kv >= SMS
    assert decode_plan(b, h, h_kv, 2048).splits == 1


@pytest.mark.parametrize("max_hist,splits", [(16, 1), (64, 1), (65, 2), (128, 2), (200, 4),
                                             (1024, 5), (2048, 5)])
def test_decode_plan_never_splits_below_one_key_tile(max_hist, splits):
    plan = decode_plan(8, 32, 8, max_hist)
    assert plan.splits == splits
    assert plan.splits * plan.key_tile < max_hist + plan.key_tile


@pytest.mark.parametrize("v", [64, 32000, 128256, 152064])
def test_sample_plan_covers_the_row_and_fits_shared_memory(v):
    plan = fused_sample_plan(v)
    assert plan.cluster == 16 and plan.cluster * plan.chunk >= v > (plan.cluster - 1) * plan.chunk
    assert plan.smem_bytes == 8 * plan.chunk <= SAMPLE_SMEM_LIMIT < 232448
    if v == 128256:  # Llama-3's vocabulary: 8,016 logits a block, 64 KB
        assert (plan.chunk, plan.smem_bytes) == (8016, 64128)


def test_sample_plan_refuses_a_row_that_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        fused_sample_plan(16 * SAMPLE_SMEM_LIMIT // 8 + 16)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# name -> (logits shape, top_k dtype, exception, message): what the B6
# wrapper refuses
SAMPLE_REFUSALS = {
    "top_k_int64": ((4, 64), torch.int64, TypeError, "int32"),
    "vocab_too_large": ((4, 500000), torch.int32, ValueError, "shared memory"),
    "not_cuda": ((4, 64), torch.int32, ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(SAMPLE_REFUSALS))
def test_sample_wrapper_refuses_instead_of_falling_back(case):
    shape, k_dtype, exc, message = SAMPLE_REFUSALS[case]
    s = shape[0]
    with pytest.raises(exc, match=message):
        fused_sample(_meta(*shape), _meta(*shape), _meta(s), _meta(s, dtype=k_dtype), _meta(s))


# name -> (q dtype, pool dtype, exception): pairs no verify kernel takes
VERIFY_DTYPE_REFUSALS = {
    "bf16_q_f32_pool": (torch.bfloat16, torch.float32, TypeError),
    "f32_q_bf16_pool": (torch.float32, torch.bfloat16, TypeError),
    "f16_q": (torch.float16, torch.float16, TypeError),
    "bf16_not_cuda": (torch.bfloat16, torch.bfloat16, ValueError),
}


@pytest.mark.parametrize("case", sorted(VERIFY_DTYPE_REFUSALS))
def test_verify_wrapper_refuses_other_dtypes(case):
    q_dtype, pool_dtype, exc = VERIFY_DTYPE_REFUSALS[case]
    q = _meta(2, 5, 8, 64, dtype=q_dtype)
    pool = _meta(5, 4, 2, 64, dtype=pool_dtype)
    win = _meta(2, 5, 2, 64, dtype=q_dtype)
    tables = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    pos = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(exc):
        paged_flash_verify(q, pool, pool, win, win, tables, pos)


def _meta_offset(*shape, dtype, offset):
    """A contiguous meta tensor ``offset`` elements into its storage (its
    data_ptr is offset * itemsize)."""
    return torch.empty(math.prod(shape) + offset, dtype=dtype, device="meta")[offset:].view(shape)


# name -> (q, pool, scales, exception, message): what the B4 wrapper refuses
# (q (2, 1, 8, 64), pools (5, 4, 2, 64) unless the case says otherwise); on
# tensors that are not on the CPU none of them falls back to the plain version
DECODE_REFUSALS = {
    "bf16_q_f32_pool": (torch.bfloat16, torch.float32, False, TypeError, "dtype"),
    "f32_q_bf16_pool": (torch.float32, torch.bfloat16, False, TypeError, "dtype"),
    "f16_q": (torch.float16, torch.float16, False, TypeError, "dtype"),
    "int8_pool_without_scales": (torch.bfloat16, torch.int8, False, TypeError, "dtype"),
    "unaligned_q": (torch.bfloat16, torch.bfloat16, False, ValueError, "16-byte"),
    "unaligned_pool": (torch.bfloat16, torch.int8, True, ValueError, "16-byte"),
    "noncontiguous_pool": (torch.bfloat16, torch.bfloat16, False, ValueError, "contiguous"),
    "head_dim_96": (torch.bfloat16, torch.bfloat16, False, ValueError, "head_dim"),
    "n_rep_3": (torch.bfloat16, torch.bfloat16, False, ValueError, "GQA"),
    "bf16_not_cuda": (torch.bfloat16, torch.bfloat16, False, ValueError, "CUDA"),
    "int8_bf16_not_cuda": (torch.bfloat16, torch.int8, True, ValueError, "CUDA"),
    "f32_not_cuda": (torch.float32, torch.float32, False, ValueError, "CUDA"),
}


@pytest.mark.parametrize("case", sorted(DECODE_REFUSALS))
def test_decode_wrapper_refuses_instead_of_falling_back(case):
    q_dtype, pool_dtype, with_scales, exc, message = DECODE_REFUSALS[case]
    h, d = (6, 64) if case == "n_rep_3" else (8, 96 if case == "head_dim_96" else 64)
    q = _meta_offset(2, 1, h, d, dtype=q_dtype, offset=1 if case == "unaligned_q" else 0)
    pool = _meta_offset(5, 4, 2, d, dtype=pool_dtype, offset=1 if case == "unaligned_pool" else 0)
    if case == "noncontiguous_pool":
        pool = _meta(5, 2, 4, d, dtype=pool_dtype).transpose(1, 2)
    scales = dict(k_scale=_meta(5, 4), v_scale=_meta(5, 4)) if with_scales else {}
    tables = torch.zeros((2, 3), dtype=torch.int32, device="meta")
    pos = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(exc, match=message):
        paged_flash_decode(q, pool, pool, tables, pos, **scales)


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


# ------------------------------------------------- B4, B5 and B6 on the card
def _card_pools(gen, dev, nb, bs, h_kv, d, dtype):
    if dtype == torch.int8:
        kq = torch.randint(-127, 128, (nb, bs, h_kv, d), generator=gen, device=dev, dtype=torch.int8)
        vq = torch.randint(-127, 128, (nb, bs, h_kv, d), generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand((nb, bs), generator=gen, device=dev) * 0.02
        vs = torch.rand((nb, bs), generator=gen, device=dev) * 0.02
        return kq, vq, dict(k_scale=ks, v_scale=vs)
    kp = torch.randn((nb, bs, h_kv, d), generator=gen, device=dev).to(dtype)
    vp = torch.randn((nb, bs, h_kv, d), generator=gen, device=dev).to(dtype)
    return kp, vp, {}


# B4 and B5: bf16 q is held per output row (slot, query, head) as well: its
# largest error within 2^-6 of the row's largest |reference|, 2 to 4 bf16
# ulps of it (kernel and plain version each round p and the output to bf16:
# one ulp apart reads up to 2^-7, and the sound maximum measured on an H100
# was 8.3e-3). Small outputs deep in history are held to their own row's
# scale, not to the absolute 2e-2 alone.
ROW_RTOL = 2.0 ** -6


def _row_rel_err(out, ref, valid):
    """Largest over the compared rows of max |out - ref| / max |ref|, both
    over a row's D outputs; ``valid`` (B, W) marks the compared rows."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1))[valid].max().item()


# (pool dtype, q dtype, tolerance): the tensor-core pair, then the FMA pair
# (B4 and B5 alike)
CARD_DTYPES = {
    "bf16_mma": (torch.bfloat16, torch.bfloat16, 2e-2),
    "int8_bf16q_mma": (torch.int8, torch.bfloat16, 2e-2),
    "f32_fma": (torch.float32, torch.float32, 1e-4),
    "int8_f32q_fma": (torch.int8, torch.float32, 1e-4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", sorted(CARD_DTYPES))
@pytest.mark.parametrize("w,n_rep,d,softcap", [
    (1, 4, 128, None), (1, 1, 64, 30.0), (5, 4, 128, None), (5, 4, 128, 30.0), (5, 1, 128, None),
    (70, 4, 128, 30.0), (70, 1, 128, None), (512, 4, 128, None), (512, 1, 64, 30.0),
])
def test_verify_kernels_match_plain_on_card(cuda_device, dtypes, w, n_rep, d, softcap):
    # 4 slots of 768 positions: a fresh slot (pos 0), one mid-row, one whose
    # window overhangs the table (only its rows inside the row are
    # compared: the engine discards the rest) and a ghost slot (all-null
    # row, reads block 0); W = 1 and 5 take the split history, W = 70 at
    # n_rep 1 the split with 64-row tiles, W = 512 no split
    pool_dtype, q_dtype, tol = CARD_DTYPES[dtypes]
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(w * 10 + n_rep)
    slots, h_kv, bs, bpr = 4, 8, 16, 48
    h = h_kv * n_rep
    nb = slots * bpr + 1
    tables = (torch.randperm(nb - 1, generator=gen, device=dev)[: slots * bpr] + 1)
    tables = tables.reshape(slots, bpr).to(torch.int32)
    tables[3] = 0
    pos = torch.tensor([0, 17, bpr * bs - 3, 200], dtype=torch.int32, device=dev)
    kp, vp, scales = _card_pools(gen, dev, nb, bs, h_kv, d, pool_dtype)
    q = torch.randn((slots, w, h, d), generator=gen, device=dev).to(q_dtype)
    wk, wv = (torch.randn((slots, w, h_kv, d), generator=gen, device=dev).to(q_dtype)
              for _ in range(2))
    args = (q, kp, vp, wk, wv, tables, pos)
    name = verify_kernel_for(q_dtype, pool_dtype)
    before = _build.launch_counts()[name]
    out = paged_flash_verify(*args, softcap=softcap, **scales)
    out2 = paged_flash_verify(*args, softcap=softcap, **scales)
    ref = paged_flash_verify_reference(*args, softcap=softcap, **scales)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 2
    assert torch.equal(out, out2)
    valid = (pos[:, None] + torch.arange(w, device=dev)[None, :]) < bpr * bs
    assert out.dtype == q_dtype and out.shape == q.shape
    assert (out.float() - ref.float())[valid].abs().max().item() <= tol
    if q_dtype == torch.bfloat16:
        assert _row_rel_err(out, ref, valid) <= ROW_RTOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", sorted(CARD_DTYPES))
@pytest.mark.parametrize("n_rep,d,softcap", [
    (4, 128, None), (4, 128, 30.0), (1, 128, None), (1, 64, 30.0), (8, 128, None), (8, 64, 30.0),
    (4, 64, None), (2, 128, None),
])
@pytest.mark.parametrize("slots", [4, 20])
def test_paged_decode_kernel_matches_plain_on_card(cuda_device, dtypes, n_rep, d, softcap, slots):
    # slots x 8 kv heads: 4 slots take the split history (32 groups, 9
    # splits of 12 key tiles), 20 slots fill the card unsplit (160 groups). A fresh slot
    # (pos 0: one live key, most splits empty), a full first block, an
    # exactly full last block of the row, a vacant slot (all-null row with a
    # stale pos: reads block 0), the rest at random positions
    pool_dtype, q_dtype, tol = CARD_DTYPES[dtypes]
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(slots * 100 + n_rep * 10 + d)
    h_kv, bs, bpr = 8, 16, 48
    h = h_kv * n_rep
    nb = slots * bpr + 1
    tables = (torch.randperm(nb - 1, generator=gen, device=dev)[: slots * bpr] + 1)
    tables = tables.reshape(slots, bpr).to(torch.int32)
    tables[3] = 0
    pos = torch.randint(0, bpr * bs, (slots,), generator=gen, device=dev, dtype=torch.int32)
    pos[:4] = torch.tensor([0, 15, bpr * bs - 1, 200], dtype=torch.int32, device=dev)
    kp, vp, scales = _card_pools(gen, dev, nb, bs, h_kv, d, pool_dtype)
    q = torch.randn((slots, 1, h, d), generator=gen, device=dev).to(q_dtype)
    name = decode_kernel_for(q_dtype, pool_dtype)
    if name.endswith("_mma"):
        assert (decode_plan(slots, h, h_kv, bpr * bs).splits > 1) == (slots == 4)
    before = _build.launch_counts()[name]
    out = paged_flash_decode(q, kp, vp, tables, pos, softcap=softcap, **scales)
    out2 = paged_flash_decode(q, kp, vp, tables, pos, softcap=softcap, **scales)
    ref = paged_attention(q, kp, vp, tables, pos, softcap=softcap, **scales)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 2
    assert torch.equal(out, out2)
    assert out.dtype == q_dtype and out.shape == q.shape
    assert (out.float() - ref.float()).abs().max().item() <= tol
    if q_dtype == torch.bfloat16:
        assert _row_rel_err(out, ref, torch.ones((slots, 1), dtype=torch.bool, device=dev)) <= ROW_RTOL


def _sample_inputs(seed, s, v, ties):
    """Seeded (numpy) logits, Gumbel noise and per-row settings: greedy,
    top-k only, top-p only, both, cycling; ``ties`` rounds the logits so
    many values repeat (first-index and Z-over-k_eff rules)."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(s, v)) * 3).astype(np.float32)
    if ties:
        logits[::2] = np.round(logits[::2])
        logits[1::2] = np.round(logits[1::2] * 2) / 2
    noise = rng.gumbel(size=(s, v)).astype(np.float32)
    kind = np.arange(s) % 4
    temp = np.where(kind == 0, 0.0, 0.3 + 1.2 * rng.random(s)).astype(np.float32)
    top_k = np.where(kind % 2 == 1, 1 + rng.integers(0, 200, s), 0).astype(np.int32)
    top_p = np.where(kind >= 2, 0.5 + 0.5 * rng.random(s), 1.0).astype(np.float32)
    # rows 6 and 7 of every 8: top_p = 0 (p * Z = 0 keeps every token), the
    # first without top-k, the second with it
    top_p[np.arange(s) % 8 >= 6] = 0.0
    return logits, noise, temp, top_k, top_p


@pytest.mark.cuda
def test_fused_sample_kernel_bitwise_on_card(cuda_device):
    args = [torch.from_numpy(x).to(cuda_device) for x in _sample_inputs(3, 8, 64, ties=True)]
    assert torch.equal(fused_sample(*args), fused_sample_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 8, 512])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("v", [128256, 152064])
def test_fused_sample_kernel_matches_plain_at_serving_vocabs_on_card(cuda_device, s, ties, v):
    # Llama-3's vocabulary (8,016 logits a block: two-limb mass histograms)
    # and Qwen2's (9,504: three limbs)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in _sample_inputs(s, s, v, ties)]
    if s == 1:
        args[2].fill_(0.9)  # a first token, sampled with top-k and top-p
        args[3].fill_(50)
        args[4].fill_(0.9)
    before = _build.launch_counts()["fused_sample"]
    out = fused_sample(*args)
    out2 = fused_sample(*args)
    ref = fused_sample_reference(*args)
    torch.cuda.synchronize()
    assert _build.launch_counts()["fused_sample"] == before + 2
    assert out.dtype == torch.int32 and out.shape == (s,)
    assert torch.equal(out, out2)
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("top_k", [0, 50])
@pytest.mark.parametrize("top_p", [0.0, -0.5])
def test_fused_sample_keeps_every_token_at_top_p_zero_on_card(cuda_device, top_k, top_p):
    # p * Z <= 0: the top-p cutoff keeps every token, so the draw is the one
    # with top-p off, on the kernel and its plain version alike
    logits, noise, temp, _, _ = _sample_inputs(11, 8, 128256, ties=True)
    args = [torch.from_numpy(x).to(cuda_device) for x in (logits, noise, temp)]
    args[2].fill_(0.8)
    k = torch.full((8,), top_k, dtype=torch.int32, device=cuda_device)
    out = fused_sample(*args, k, torch.full((8,), top_p, device=cuda_device))
    off = fused_sample(*args, k, torch.ones(8, device=cuda_device))
    ref = fused_sample_reference(*args, k, torch.full((8,), top_p, device=cuda_device))
    assert torch.equal(out, ref)
    assert torch.equal(out, off)


@pytest.mark.cuda
def test_sample_plan_limit_is_the_kernels_on_card(cuda_device):
    # the host's SAMPLE_SMEM_LIMIT is the kernel's: the largest row the plan
    # takes launches, and the kernel itself refuses one 16 logits longer
    v = SAMPLE_SMEM_LIMIT // 8 * SAMPLE_CLUSTER
    args = [torch.from_numpy(x[:1]).to(cuda_device) for x in _sample_inputs(5, 2, v, ties=False)]
    args[2].fill_(0.7)
    args[4].fill_(0.9)
    assert torch.equal(fused_sample(*args), fused_sample_reference(*args))
    with pytest.raises(ValueError, match="shared memory"):
        fused_sample_plan(v + SAMPLE_CLUSTER)
    wide = torch.zeros((1, v + SAMPLE_CLUSTER), device=cuda_device)
    out = torch.empty((1,), dtype=torch.int32, device=cuda_device)
    code = _build.entry("fused_sample", 6, 2, 0)(
        wide.data_ptr(), wide.data_ptr(), args[2].data_ptr(), args[3].data_ptr(),
        args[4].data_ptr(), out.data_ptr(), 1, v + SAMPLE_CLUSTER,
        torch.cuda.current_stream(cuda_device).cuda_stream)
    assert code != 0
