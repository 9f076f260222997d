"""Weight-only quantized matmul: float activations times int8 weights with
per-output-channel scales (counterpart of ``accelerate_tpu/ops/quant_matmul
.py``).

The hot op of weight-only quantized inference: the weights stay int8 in
device memory, half the bytes of bf16, and the per-column scale multiplies
the f32 sum after the dot, which for column-wise scales is the same
function as ``x @ dequantize(q)``. A CUDA tensor launches one of the
three variants of ``csrc/quant_matmul.cu`` (replacing the Pallas
``_qmm_kernel``), chosen by :func:`qmm_plan` from the shape and x's dtype;
a CPU tensor runs :func:`quantized_matmul_plain`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import _build

__all__ = ["QmmPlan", "qmm_plan", "quantized_matmul", "quantized_matmul_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# the tensor-core variants' output columns per block and K tile depth
MMA_BN, MMA_BK = 128, 64
# largest M of the split-K variant (one 16-row mma tile)
SPLITK_MAX_M = 16


class QmmPlan(NamedTuple):
    """How B7 runs one product: the kernel (its C entry point and launch
    counter), the rows of ``quant_matmul_mma``'s tiles (128 or 64, by 128
    columns), and the K split of ``quant_matmul_splitk``: ``slices`` slices
    of ``k_tiles_per_slice`` 64-deep K tiles (0 where they do not apply)."""

    kernel: str
    block_m: int = 0
    k_tiles_per_slice: int = 0
    slices: int = 0


def qmm_plan(m: int, k: int, n: int, dtype: torch.dtype, aligned: bool = True) -> QmmPlan:
    """The B7 variant for an (m, k) x (k, n) product with x of ``dtype``.
    ``aligned``: x's and q's base addresses are multiples of 16 bytes.

    * f32 x keeps f32 products: ``quant_matmul`` (FMA loops).
    * Rows that break 16-byte copies (k % 8 for x's bf16 rows, n % 16 for
      q's int8 rows), or unaligned bases: ``quant_matmul`` (masked loads).
    * m <= 16: ``quant_matmul_splitk``, bound by q's bytes; K is cut into
      slices of whole 64-deep tiles so that at least ``_build.FILL_BLOCKS``
      blocks stream q where the shape allows it.
    * otherwise ``quant_matmul_mma``: 128 x 128 tiles, or 64 x 128 where
      128-row tiles would leave SMs without a block (Llama-3-8B's k_v at M
      = 2048: 16 x 8 = 128 tiles on 132 SMs)."""
    if dtype == torch.float32 or not aligned or k % 8 or n % 16:
        return QmmPlan("quant_matmul")
    n_tiles = -(-n // MMA_BN)
    if m <= SPLITK_MAX_M:
        k_tiles = -(-k // MMA_BK)
        per_slice = max(1, k_tiles // -(-_build.FILL_BLOCKS // n_tiles))
        return QmmPlan("quant_matmul_splitk", 0, per_slice, -(-k_tiles // per_slice))
    return QmmPlan("quant_matmul_mma", 128 if -(-m // 128) * n_tiles >= _build.SMS else 64)


def _shapes(x, q, scales):
    *lead, k = x.shape
    kq, n = q.shape
    if kq != k:
        raise ValueError(f"Inner dims mismatch: x K={k} vs q K={kq}")
    if scales.numel() != n:
        raise ValueError(f"scales must hold N={n} elements, got shape {tuple(scales.shape)}")
    return lead, k, n


def _out_dtype(x, out_dtype):
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"quantized_matmul writes x's dtype ({x.dtype}) or float32, got {out_dtype}")
    return out_dtype


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain version of the kernel: the product in f32 of x (rounded to bf16
    unless x is f32) and q, then times the f32 scales, cast to ``out_dtype``
    (x's dtype by default, or float32)."""
    lead, k, n = _shapes(x, q, scales)
    out_dtype = _out_dtype(x, out_dtype)
    compute = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    acc = x.reshape(-1, k).to(compute).float() @ q.float()
    out = acc * scales.reshape(n).float()
    return out.to(out_dtype).reshape(*lead, n)


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ (q * scales)`` with int8 ``q`` read as int8 by the kernel.

    x: (..., K) float32, bfloat16 or float16; q: (K, N) int8; scales: any
    shape with N elements (``(N,)``, ``(1, N)``, a stacked leaf's ``(1, 1,
    N)``), taken as f32. Returns (..., N) in ``out_dtype``: x's dtype by
    default, or float32, which keeps the f32 sums times the scales unrounded
    (an LM head's f32 logits). A non-f32 x is rounded to bf16 before the
    products, as the TPU kernel computes."""
    _build.refuse_dtensor("quantized_matmul", x, q, scales)
    lead, k, n = _shapes(x, q, scales)
    out_dtype = _out_dtype(x, out_dtype)
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, scales, out_dtype)
    if q.device != x.device or scales.device != x.device:
        raise ValueError("quantized_matmul: x, q and scales must be on one device")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantized_matmul kernel takes float32, bfloat16 or float16 x, got {x.dtype}")
    if q.dtype != torch.int8:
        raise TypeError(f"quantized_matmul kernel takes int8 q, got {q.dtype}")
    if not (x.is_contiguous() and q.is_contiguous()):
        raise ValueError("quantized_matmul kernel takes contiguous x and q")
    if x.device.type != "cuda":
        raise ValueError(f"the quantized_matmul kernel runs on CUDA tensors; got {x.device}")
    s = scales.reshape(n).to(torch.float32).contiguous()
    m = math.prod(lead)
    out = torch.empty((*lead, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    aligned = x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    return _launch(qmm_plan(m, k, n, x.dtype, aligned), x, q, s, out)


def _launch(plan: QmmPlan, x, q, s, out):
    """Launch ``plan``'s kernel on checked operands (x (.., K), q (K, N),
    f32 scales (N,), out (.., N) of x's dtype or f32), count it and return
    ``out``."""
    k, n = q.shape
    m = x.numel() // k
    ptrs = (x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr())
    codes = (_DTYPE_CODE[x.dtype], _DTYPE_CODE[out.dtype])
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.kernel == "quant_matmul":
        code = _build.entry(plan.kernel, 4, 5, 0)(*ptrs, m, k, n, *codes, stream)
    elif plan.kernel == "quant_matmul_mma":
        code = _build.entry(plan.kernel, 4, 6, 0)(*ptrs, m, k, n, *codes, plan.block_m, stream)
    else:
        ws = torch.empty((plan.slices, m, n), dtype=torch.float32, device=x.device)
        code = _build.entry(plan.kernel, 5, 7, 0)(
            *ptrs, ws.data_ptr(), m, k, n, *codes, plan.k_tiles_per_slice, plan.slices, stream)
    _build.check(plan.kernel, code)
    _build.count_launch(plan.kernel)
    return out
