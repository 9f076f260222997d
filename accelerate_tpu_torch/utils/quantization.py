"""Weight-only quantization for inference (counterpart of
``accelerate_tpu/utils/quantization.py``): int8 and linear int4 weights with
per-output-channel or per-(block, channel) scales, and NF4 with optional
double quantization; the reference's bitsandbytes surface
(``load_and_quantize_model``, ``BnbQuantizationConfig``).

The arithmetic runs in torch on the weight's device and gives the same
bytes as the JAX package's numpy code: f32 amax, ``max(amax, 1e-12)``, a
true division by ``qmax`` and of the weight by its scale, round half to
even, then clip. Per-channel amax runs over every axis but the last, so a
stacked ``(L, K, N)`` leaf gets ``(1, 1, N)`` scales shared by its L
layers, as in the JAX package.

Quantized leaves are ``nn.Module``s holding their tensors as buffers, so
``.to()`` moves them with the model. :func:`quantize_model` on a
:class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM` puts them in
place of its parameters, and the forward multiplies a per-channel leaf
through the quantized matmul kernel (B7) without dequantizing it; on any
other module the forward dequantizes every leaf and runs the module's own
forward over them, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from .modeling import get_leaf, named_leaves, replace_forward, set_leaf

__all__ = [
    "QuantizationConfig",
    "QuantizedLeaf",
    "quantize_params",
    "dequantize_leaf",
    "quantize_model",
    "load_and_quantize_model",
    "NF4Leaf",
    "nf4_quantize_leaf",
    "NF4_CODEBOOK",
]

# elements per pass of the int8/int4 quantizer: bounds its f32 temporaries
# (a Llama-3-8B stacked projection is 1.9e9 weights) to 256 MB each
_CHUNK = 2**26


@dataclasses.dataclass
class QuantizationConfig:
    """(reference BnbQuantizationConfig, utils/dataclasses.py:3057+).

    4-bit supports the linear symmetric codebook and ``nf4`` (NormalFloat
    quantile codebook with per-block absmax, QLoRA), with optional double
    quantization of the absmax scales."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    min_weight_size: int = 2**12  # leave small params in full precision
    skip_patterns: tuple = ("norm", "bias", "scale", "embed")
    bnb_4bit_quant_type: str = "linear"  # "linear" | "nf4"
    bnb_4bit_use_double_quant: bool = False
    bnb_4bit_block_size: int = 64
    # None keeps per-output-channel scales (one per column); an int chunks
    # the contraction dim (axis -2) into blocks of that size with one scale
    # per (block, column)
    int8_block_size: Optional[int] = None

    def __post_init__(self):
        if self.bnb_4bit_quant_type not in ("linear", "nf4"):
            raise ValueError(
                f"bnb_4bit_quant_type must be linear|nf4, got "
                f"{self.bnb_4bit_quant_type!r}"
            )
        if self.int8_block_size is not None and self.int8_block_size < 1:
            raise ValueError(
                f"int8_block_size must be None or >= 1, got "
                f"{self.int8_block_size}"
            )

    @property
    def bits(self) -> int:
        return 4 if self.load_in_4bit else 8


class QuantizedLeaf(nn.Module):
    """int8-stored tensor ``q`` with per-output-channel ``scales`` (every
    axis but the last reduced, kept as size 1) or, with ``block_size`` set,
    per-(contraction-block, channel) scales ``(..., nblocks, N)``, each
    block covering ``block_size`` rows of axis -2."""

    def __init__(self, q: torch.Tensor, scales: torch.Tensor, orig_dtype, block_size=None):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scales", scales)
        self.orig_dtype = orig_dtype
        self.block_size = block_size

    def dequantize(self) -> torch.Tensor:
        scales = self.scales
        if self.block_size is not None:
            # repeat each block's scale over its rows, then trim the rows
            # the quantizer padded onto the last block
            scales = scales.repeat_interleave(self.block_size, dim=-2)[..., : self.q.shape[-2], :]
        return (self.q.float() * scales).to(self.orig_dtype)

    def layers(self) -> list:
        """Each layer's ``(K, N)`` leaf of a stacked ``(L, K, N)`` one:
        ``q`` unbound into contiguous slices; per-channel ``(1, 1, N)``
        scales shared by every layer, block scales ``(L, nb, N)`` unbound
        with ``q``."""
        qs = self.q.unbind(0)
        scales = [self.scales[0]] * len(qs) if self.block_size is None else self.scales.unbind(0)
        return [QuantizedLeaf(q, s, self.orig_dtype, self.block_size) for q, s in zip(qs, scales)]


def _quantize_array(x: torch.Tensor, bits: int, block_size: Optional[int] = None):
    """(q int8, scales f32) of ``x``, on ``x``'s device."""
    qmax = 127 if bits == 8 else 7
    x = x.detach()
    if block_size is not None and x.dim() >= 2:
        rows, n = x.shape[-2], x.shape[-1]
        nb = -(-rows // block_size)
        lead = x.shape[:-2]
        q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        scales = torch.empty((*lead, nb, n), dtype=torch.float32, device=x.device)
        # one (rows, N) slice at a time; zero pad rows never raise a block's amax
        for xs, qs, ss in zip(x.reshape(-1, rows, n), q.view(-1, rows, n), scales.view(-1, nb, n)):
            xb = torch.nn.functional.pad(xs.float(), (0, 0, 0, nb * block_size - rows))
            xb = xb.view(nb, block_size, n)
            s = xb.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) / qmax
            qs.copy_(torch.round(xb / s).clamp_(-qmax, qmax).view(nb * block_size, n)[:rows])
            ss.copy_(s[:, 0, :])
        return q, scales
    if x.dim() < 2:  # no axis to reduce: one scale per element, as numpy's max over ()
        s = x.float().abs().clamp_min(1e-12) / qmax
        return torch.round(x.float() / s).clamp_(-qmax, qmax).to(torch.int8), s
    # per-output-channel (last dim) symmetric scales, in row chunks
    n = x.shape[-1]
    flat = x.reshape(-1, n)
    rows = max(1, _CHUNK // n)
    amax = torch.zeros(n, dtype=torch.float32, device=x.device)
    for chunk in flat.split(rows):
        torch.maximum(amax, chunk.float().abs().amax(dim=0), out=amax)
    s = amax.clamp_min(1e-12) / qmax
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    for chunk, qc in zip(flat.split(rows), q.view(-1, n).split(rows)):
        qc.copy_(torch.round(chunk.float() / s).clamp_(-qmax, qmax))
    return q, s.reshape((1,) * (x.dim() - 1) + (n,))


def _selected(path: str, leaf, config: QuantizationConfig) -> bool:
    """The JAX package's test: a float leaf of at least ``min_weight_size``
    elements whose lower-cased ``/``-joined path holds no skip pattern."""
    path = path.lower()
    return (
        isinstance(leaf, torch.Tensor)
        and leaf.is_floating_point()
        and math.prod(leaf.shape) >= config.min_weight_size
        and not any(p in path for p in config.skip_patterns)
    )


def _quantize_leaf(leaf: torch.Tensor, config: QuantizationConfig):
    if config.load_in_4bit and config.bnb_4bit_quant_type == "nf4":
        return nf4_quantize_leaf(leaf, block=config.bnb_4bit_block_size,
                                 double_quant=config.bnb_4bit_use_double_quant)
    block = config.int8_block_size
    if block is not None and leaf.dim() < 2:
        block = None  # vectors have no contraction dim to chunk
    q, scales = _quantize_array(leaf, config.bits, block_size=block)
    return QuantizedLeaf(q, scales, leaf.dtype, block)


def quantize_params(params: dict, config: QuantizationConfig) -> dict:
    """A copy of a parameter tree (nested dicts of tensors) with its large
    float leaves replaced by quantized ones."""

    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                out[k] = walk(v, path)
            else:
                out[k] = _quantize_leaf(v, config) if _selected(path, v, config) else v
        return out

    return walk(params, "")


def dequantize_leaf(leaf):
    if isinstance(leaf, (QuantizedLeaf, NF4Leaf)):
        return leaf.dequantize()
    return leaf


def quantize_model(module: nn.Module, config: Optional[QuantizationConfig] = None) -> nn.Module:
    """Quantize a model in place and return it. Each float parameter the
    config selects is quantized on its device and its float copy freed
    before the next. A ``LlamaForCausalLM`` holds the quantized leaves in
    place of the parameters and multiplies by them directly; any other
    module keeps them in ``quantized_leaves`` and its forward runs over
    their dequantized values."""
    from ..models.llama import LlamaForCausalLM

    config = config or QuantizationConfig(load_in_8bit=True)
    selected = [attr for key, attr in named_leaves(module)
                if isinstance(get_leaf(module, attr), nn.Parameter)
                and _selected(key.replace(".", "/"), get_leaf(module, attr), config)]
    if isinstance(module, LlamaForCausalLM):
        for attr in selected:
            set_leaf(module, attr, _quantize_leaf(get_leaf(module, attr).detach(), config))
        return module
    leaves = {}
    for attr in selected:
        leaves[attr] = _quantize_leaf(get_leaf(module, attr).detach(), config)
        owner, _, name = attr.rpartition(".")
        delattr(module.get_submodule(owner), name)
    module.quantized_leaves = nn.ModuleDict({a.replace(".", "__"): leaf for a, leaf in leaves.items()})
    replace_forward(module, lambda: {a: leaf.dequantize() for a, leaf in leaves.items()})
    return module


def load_and_quantize_model(
    model: nn.Module,
    checkpoint: str,
    quantization_config: Optional[QuantizationConfig] = None,
    mesh=None,
    device="cuda",
) -> nn.Module:
    """Load a safetensors checkpoint (non-strict), then quantize
    (reference utils/bnb.py ``load_and_quantize_model``). Leaves still on
    ``meta`` (a model built under ``init_empty_weights``) land on
    ``device``."""
    from ..big_modeling import load_checkpoint_in_model

    load_checkpoint_in_model(model, checkpoint, mesh=mesh, strict=False, device=device)
    return quantize_model(model, quantization_config)


# --------------------------------------------------------------------- NF4
# The 4-bit NormalFloat codebook (QLoRA, Dettmers et al. 2023, the values
# bitsandbytes ships): quantiles of N(0,1) normalized to [-1, 1].
NF4_CODEBOOK = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
        0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

_DQ_GROUP = 256  # absmax values per second-level quantization group


class NF4Leaf(nn.Module):
    """NF4-quantized tensor: two 4-bit codebook indices packed per uint8
    (``packed``, high nibble first), per-block (``block``-element) absmax
    scales, optionally double-quantized: int8 ``absmax`` residuals, one f32
    scale per group of 256 (``group_scales``) and an f32 mean ``offset``."""

    def __init__(self, packed, absmax, dq, shape, orig_dtype, block):
        super().__init__()
        group_scales, offset = dq if dq is not None else (None, None)
        self.register_buffer("packed", packed)
        self.register_buffer("absmax", absmax)
        self.register_buffer("group_scales", group_scales)
        self.register_buffer("offset", offset)
        self.shape = tuple(shape)
        self.orig_dtype = orig_dtype
        self.block = block

    @property
    def dq(self):
        """None, or (group_scales f32, offset f32) of double quantization."""
        return None if self.group_scales is None else (self.group_scales, self.offset)

    def dequantize(self) -> torch.Tensor:
        n = math.prod(self.shape)
        idx = torch.stack([self.packed >> 4, self.packed & 0xF], dim=-1).reshape(-1)[:n].long()
        vals = torch.from_numpy(NF4_CODEBOOK).to(self.packed.device)[idx]
        if self.dq is not None:
            g = self.group_scales.repeat_interleave(_DQ_GROUP)[: self.absmax.numel()]
            absmax = self.absmax.float() * g + self.offset
        else:
            absmax = self.absmax
        scale = absmax.repeat_interleave(self.block)[:n]
        return (vals * scale).reshape(self.shape).to(self.orig_dtype)


def _nf4_quantize_array(x: torch.Tensor, block: int, double_quant: bool):
    x = x.detach().float().reshape(-1)
    n = x.numel()
    pad = (-n) % block
    xb = torch.nn.functional.pad(x, (0, pad)).view(-1, block)
    codebook = torch.from_numpy(NF4_CODEBOOK).to(x.device)
    mids = (codebook[1:] + codebook[:-1]) / 2  # nearest level by midpoint bucketing
    absmax = torch.empty(xb.shape[0], dtype=torch.float32, device=x.device)
    idx = torch.empty(xb.shape, dtype=torch.uint8, device=x.device)
    for xc, ac, ic in zip(xb.split(_CHUNK // block), absmax.split(_CHUNK // block),
                          idx.split(_CHUNK // block)):
        ac.copy_(xc.abs().amax(dim=1).clamp_min(1e-12))
        ic.copy_(torch.searchsorted(mids, xc / ac[:, None]))
    flat = idx.reshape(-1)
    if flat.numel() % 2:
        flat = torch.nn.functional.pad(flat, (0, 1))
    packed = (flat[0::2] << 4) | flat[1::2]
    if not double_quant:
        return packed, absmax, None
    # 8-bit absmax: subtract the mean, then symmetric int8 per group of
    # _DQ_GROUP blocks (the bitsandbytes double-quantization recipe). The
    # mean is numpy's f32 pairwise sum, taken on the host for its bytes.
    offset = torch.tensor(np.float32(absmax.cpu().numpy().mean()), device=x.device)
    resid = absmax - offset
    rg = torch.nn.functional.pad(resid, (0, (-resid.numel()) % _DQ_GROUP)).view(-1, _DQ_GROUP)
    gscale = rg.abs().amax(dim=1).clamp_min(1e-12) / 127.0
    q8 = torch.round(rg / gscale[:, None]).clamp_(-127, 127).to(torch.int8)
    return packed, q8.reshape(-1)[: absmax.numel()], (gscale, offset)


def nf4_quantize_leaf(leaf: torch.Tensor, block: int = 64, double_quant: bool = False) -> NF4Leaf:
    packed, absmax, dq = _nf4_quantize_array(leaf, block, double_quant)
    return NF4Leaf(packed, absmax, dq, leaf.shape, leaf.dtype, block)
