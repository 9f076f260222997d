"""Weight-only quantized matmul: float activations times int8 weights with
per-output-channel scales (counterpart of ``accelerate_tpu/ops/quant_matmul
.py``).

The hot op of weight-only quantized inference: the weights stay int8 in
device memory, half the bytes of bf16, and the per-column scale multiplies
the f32 sum after the dot, which for column-wise scales is the same
function as ``x @ dequantize(q)``. A CUDA tensor launches
``csrc/quant_matmul.cu`` (replacing the Pallas ``_qmm_kernel``); a CPU
tensor runs :func:`quantized_matmul_plain`.
"""

from __future__ import annotations

import math

import torch

from . import _build

__all__ = ["quantized_matmul", "quantized_matmul_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _shapes(x, q, scales):
    *lead, k = x.shape
    kq, n = q.shape
    if kq != k:
        raise ValueError(f"Inner dims mismatch: x K={k} vs q K={kq}")
    if scales.numel() != n:
        raise ValueError(f"scales must hold N={n} elements, got shape {tuple(scales.shape)}")
    return lead, k, n


def quantized_matmul_plain(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: the product in f32 of x (rounded to bf16
    unless x is f32) and q, then times the f32 scales, cast to x's dtype."""
    lead, k, n = _shapes(x, q, scales)
    compute = torch.float32 if x.dtype == torch.float32 else torch.bfloat16
    acc = x.reshape(-1, k).to(compute).float() @ q.float()
    out = acc * scales.reshape(n).float()
    return out.to(x.dtype).reshape(*lead, n)


def quantized_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``x @ (q * scales)`` with int8 ``q`` read as int8 by the kernel.

    x: (..., K) float32, bfloat16 or float16; q: (K, N) int8; scales: any
    shape with N elements (``(N,)``, ``(1, N)``, a stacked leaf's ``(1, 1,
    N)``), taken as f32. Returns (..., N) in x's dtype. A non-f32 x is
    rounded to bf16 before the products, as the TPU kernel computes."""
    lead, k, n = _shapes(x, q, scales)
    if x.device.type == "cpu":
        return quantized_matmul_plain(x, q, scales)
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
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0 or k == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _build.entry("quant_matmul", 4, 4, 0)(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(), m, k, n,
        _DTYPE_CODE[x.dtype], stream,
    )
    _build.check("quant_matmul", code)
    _build.count_launch("quant_matmul")
    return out
