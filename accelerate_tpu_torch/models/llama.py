"""Llama-family decoder (counterpart of ``accelerate_tpu/models/llama.py``):
config presets, parameter init and conversion, the training forward and
loss, the prefill forward, the one-token decode step and the W-token
verify step (speculative decoding and chunked prefill).

Parameters keep the JAX package's pytree: stacked ``(L, ...)`` layer
leaves, projection kernels in ``(in, out)`` layout, so ``params_from_jax``
is a plain tree copy and each function here has a same-named counterpart.
Layers run as a Python loop over the stack (the JAX ``lax.scan``); under
remat ``"nothing"`` each layer is a ``torch.utils.checkpoint`` region.
:class:`LlamaForCausalLM` holds the stacked leaves as its parameters, and
``llama_apply`` splits each one into its layers with one ``unbind`` (see
:func:`_layer_trees`).

RoPE uses the interleaved-pair convention ``x[..., 0::2], x[..., 1::2]``
(not HF's ``rotate_half``). As in the JAX package, prefill rotates with
tables computed in float64 on the host and cast to f32 (``apply_rope``),
while decode computes its angles in f32 on the device from the per-slot
positions (``apply_rope_at``): two paths, each reproduced as it is.

Quantized weights (``utils.quantization.quantize_model``) run through
:func:`llama_apply` and the model's forward only: a per-channel int8 or
int4 projection multiplies through the quantized matmul kernel, other
quantized leaves are dequantized first. The prefill, decode and verify
steps take float trees, as in the JAX package.

Not ported yet (ROADMAP.md): remat ``"dots"``/``"minimal"``, chunked CE,
MoE layers, Gemma-2's alternating sliding window and fp8.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from .._device import resolve_device
from ..ops import quant_matmul as _qmm
from ..ops.attention import NEG_INF, _write_window, dispatch_attention, tanh_softcap
from ..utils.quantization import NF4Leaf, QuantizedLeaf

__all__ = [
    "LlamaConfig",
    "LlamaForCausalLM",
    "create_llama",
    "init_llama_params",
    "params_from_jax",
    "rms_norm",
    "apply_rope",
    "apply_rope_at",
    "apply_rope_window",
    "llama_apply",
    "llama_ce_denominator",
    "llama_flops_per_token",
    "llama_loss",
    "llama_prefill_at",
    "llama_decode_step",
    "llama_verify_step",
]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    sliding_window: Optional[int] = None
    attention_bias: bool = False
    rope_scaling: Optional[dict] = None
    head_dim: Optional[int] = None
    hidden_act: str = "silu"  # "silu" | "gelu_tanh"
    rms_norm_offset: bool = False
    scale_embeddings: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    post_block_norms: bool = False
    alternating_sliding_window: bool = False
    query_pre_attn_scalar: Optional[float] = None
    tie_word_embeddings: bool = False
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    remat_policy: str = "nothing"  # "nothing" | "full" ("dots", "minimal" queued)
    attention_impl: str = "blockwise"  # "xla" | "blockwise" | "flash"
    attention_kv_block: int = 512
    # accepted so that configs written for the JAX package load; no-ops here:
    # the TPU kernels' q-tile rows (the CUDA kernels size their own tiles)
    # and lax.scan over the layers (the port loops over them either way)
    attention_block_q: int = 2048
    scan_layers: bool = True
    # MoE (Mixtral-style): num_experts > 1 is refused (ROADMAP.md A11), and
    # the other MoE fields act only then
    num_experts: int = 1
    num_experts_per_tok: int = 2
    expert_capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    router_z_loss_coef: float = 0.0
    # fp8 projections and the chunked cross entropy: refused when on
    # (ROADMAP.md A4)
    use_fp8: bool = False
    use_chunked_ce: bool = False
    ce_chunk_size: int = 4096

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        if self.num_experts > 1 and self.hidden_act != "silu":
            raise ValueError(
                "hidden_act is silu-only on the MoE path; got "
                f"{self.hidden_act!r} with num_experts={self.num_experts}"
            )
        if self.alternating_sliding_window and self.sliding_window is None:
            raise ValueError(
                "alternating_sliding_window=True needs sliding_window set "
                "(the even layers' local window size)"
            )

    def _rope_scaling_key(self):
        """Hashable form for the host-side rope-table cache."""
        if self.rope_scaling is None:
            return None
        return tuple(sorted(self.rope_scaling.items()))

    @classmethod
    def llama2_7b(cls, **overrides) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        ), **overrides})

    @classmethod
    def mixtral_8x7b(cls, **overrides) -> "LlamaConfig":
        """Mixtral-8x7B shape (HF mistralai/Mixtral-8x7B): 8 experts, 2 per
        token. It builds; a model of it is refused until MoE layers are
        ported (ROADMAP.md A11)."""
        return cls(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=32768, rope_theta=1e6,
            num_experts=8, num_experts_per_tok=2,
            expert_capacity_factor=8.0,  # dropless: every token reaches its top 2
        ), **overrides})

    @classmethod
    def llama3_8b(cls, **overrides) -> "LlamaConfig":
        """Llama-3-8B shape (HF meta-llama/Meta-Llama-3-8B): GQA (8 kv
        heads), 128k vocab, rope_theta=500000."""
        return cls(**{**dict(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=8192, rope_theta=500000.0,
        ), **overrides})

    @classmethod
    def llama3_1_8b(cls, **overrides) -> "LlamaConfig":
        return cls.llama3_8b(**{**dict(
            max_position_embeddings=131072,
            rope_scaling={
                "rope_type": "llama3", "factor": 8.0,
                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192,
            },
        ), **overrides})

    @classmethod
    def qwen2_7b(cls, **overrides) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=152064, hidden_size=3584, intermediate_size=18944,
            num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
            max_position_embeddings=32768, rope_theta=1e6,
            attention_bias=True, rms_norm_eps=1e-6,
        ), **overrides})

    @classmethod
    def gemma_7b(cls, **overrides) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=256000, hidden_size=3072, intermediate_size=24576,
            num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16,
            head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
            hidden_act="gelu_tanh", rms_norm_offset=True,
            scale_embeddings=True, tie_word_embeddings=True,
        ), **overrides})

    @classmethod
    def gemma2_9b(cls, **overrides) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=256000, hidden_size=3584, intermediate_size=14336,
            num_hidden_layers=42, num_attention_heads=16, num_key_value_heads=8,
            head_dim=256, max_position_embeddings=8192, rms_norm_eps=1e-6,
            hidden_act="gelu_tanh", rms_norm_offset=True,
            scale_embeddings=True, tie_word_embeddings=True,
            sliding_window=4096, alternating_sliding_window=True,
            attn_logit_softcap=50.0, final_logit_softcap=30.0,
            post_block_norms=True, query_pre_attn_scalar=256.0,
        ), **overrides})

    @classmethod
    def mistral_7b(cls, **overrides) -> "LlamaConfig":
        return cls(**{**dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
            max_position_embeddings=32768, rope_theta=10000.0,
            sliding_window=4096,
        ), **overrides})

    @classmethod
    def tiny(cls, **overrides) -> "LlamaConfig":
        """Test-size config."""
        return cls(**{**dict(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128,
        ), **overrides})


def _check_supported(config: LlamaConfig, params: Optional[dict] = None) -> None:
    """Refuse what the port does not run yet. ``params``: the tree a
    prefill, decode or verify step (or the engine) is given, which must be
    float: only :func:`llama_apply` takes quantized leaves, as in the JAX
    package, whose engine and ``generate`` take float trees."""
    if params is not None and any(not isinstance(leaf, torch.Tensor) for _, leaf in _flatten(params)):
        raise NotImplementedError(
            "a quantized parameter tree runs only through llama_apply (the model's "
            "forward); the prefill, decode and verify steps and the engine take float "
            "trees, as in the JAX package (static generate over quantized weights: "
            "ROADMAP.md A8)"
        )
    if config.num_experts > 1:
        raise NotImplementedError(
            "MoE layers (num_experts > 1, with num_experts_per_tok, expert_capacity_factor, "
            "moe_aux_loss_coef and router_z_loss_coef) are not ported yet (ROADMAP.md A11)"
        )
    if config.use_fp8:
        raise NotImplementedError(
            "use_fp8 (fp8 projections, ops/fp8.py) is not ported yet (ROADMAP.md A4)"
        )
    if config.use_chunked_ce:
        raise NotImplementedError(
            "use_chunked_ce (the chunked cross entropy, with ce_chunk_size) is not ported "
            "yet (ROADMAP.md A4)"
        )
    if config.alternating_sliding_window:
        raise NotImplementedError(
            "Gemma-2 alternating local/global attention is not ported yet (ROADMAP.md)"
        )


# ------------------------------------------------------------------- params
def _building_empty() -> bool:
    """Inside ``big_modeling.init_empty_weights`` (the default device is
    ``meta``): build shapes and dtypes only."""
    return torch.get_default_device().type == "meta"


def init_llama_params(config: LlamaConfig, generator: torch.Generator,
                      device="cuda") -> dict:
    """Stacked-layer parameter tree, drawn like the JAX ``init_llama_params``:
    each projection ``normal * 1/sqrt(in_dim)``, the embedding ``normal *
    0.02``, norms at one (zero with ``rms_norm_offset``). ``generator`` must
    live on ``device``; the numbers differ from ``jax.random``'s. Under
    ``init_empty_weights`` every leaf is an empty ``meta`` tensor and
    nothing is drawn (``generator`` may be None)."""
    _check_supported(config)
    empty = _building_empty()
    dev = torch.device("meta") if empty else resolve_device(device)
    d, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    h, kvh, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    L = config.num_hidden_layers
    dt = config.param_dtype

    def draw(shape, scale):
        if empty:
            return torch.empty(shape, dtype=dt, device=dev)
        return (torch.randn(shape, generator=generator, device=dev) * scale).to(dt)

    def dense(in_dim, out_dim):
        return draw((in_dim, out_dim), 1.0 / math.sqrt(in_dim))

    def stacked(in_dim, out_dim):
        # one layer at a time keeps the f32 draw's footprint to one layer
        out = torch.empty((L, in_dim, out_dim), dtype=dt, device=dev)
        for layer in range(L):
            out[layer] = dense(in_dim, out_dim)
        return out

    def norm(shape):
        fill = torch.zeros if config.rms_norm_offset else torch.ones
        return fill(shape, dtype=dt, device=dev)

    def proj(in_dim, out_dim):
        entry = {"kernel": stacked(in_dim, out_dim)}
        if config.attention_bias:
            entry["bias"] = torch.zeros((L, out_dim), dtype=dt, device=dev)
        return entry

    params = {
        "embed_tokens": {"embedding": draw((v, d), 0.02)},
        "layers": {
            "attn": {
                "q_proj": proj(d, h * hd),
                "k_proj": proj(d, kvh * hd),
                "v_proj": proj(d, kvh * hd),
                "o_proj": {"kernel": stacked(h * hd, d)},
            },
            "mlp": {
                "gate_proj": {"kernel": stacked(d, i)},
                "up_proj": {"kernel": stacked(d, i)},
                "down_proj": {"kernel": stacked(i, d)},
            },
            "input_norm": {"scale": norm((L, d))},
            "post_attn_norm": {"scale": norm((L, d))},
        },
        "final_norm": {"scale": norm((d,))},
    }
    if config.post_block_norms:
        params["layers"]["attn_out_norm"] = {"scale": norm((L, d))}
        params["layers"]["mlp_out_norm"] = {"scale": norm((L, d))}
    if not config.tie_word_embeddings:
        params["lm_head"] = {"kernel": dense(d, v)}
    return params


def params_from_jax(config: LlamaConfig, params_np: dict, device="cuda") -> dict:
    """The JAX package's Llama parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree_util.tree_map(np.asarray, params)``) as the port's tree
    of ``config.param_dtype`` tensors on ``device``. The layouts are the
    same, so this is a leaf-by-leaf copy; it imports no JAX."""
    dev = resolve_device(device)

    def convert(node):
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        arr = np.asarray(node, dtype=np.float32)  # bf16 numpy has no torch twin
        return torch.from_numpy(arr.copy()).to(device=dev, dtype=config.param_dtype)

    return convert(params_np)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


class LlamaForCausalLM(nn.Module):
    """A Llama parameter tree as trainable module parameters, one per leaf
    (named by its path joined with ``"__"``), stacked ``(L, ...)`` layer
    leaves included. ``params`` is the tree the serving functions take,
    detached (serving builds no graph). ``forward`` returns full-sequence
    f32 logits (B, S, V) and casts the f32 master weights to
    ``config.compute_dtype`` per use (as ``examples/llama_finetune.py`` runs
    with ``model.policy = None``), so
    :func:`~accelerate_tpu_torch.model.prepare_model` leaves it unwrapped.
    ``utils.quantization.quantize_model`` replaces projection parameters by
    quantized leaves (modules under the same names), which ``params`` and
    ``forward`` pass on as they are."""

    casts_per_use = True

    def __init__(self, config: LlamaConfig, params: dict):
        super().__init__()
        _check_supported(config)
        self.config = config
        self._paths = []
        for path, tensor in _flatten(params):
            name = "__".join(path)
            self.register_parameter(name, nn.Parameter(tensor.detach()))
            self._paths.append((path, name))

    @classmethod
    def from_seed(cls, config: LlamaConfig, seed: int = 0, device="cuda") -> "LlamaForCausalLM":
        """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``;
        under ``init_empty_weights``, empty ``meta`` parameters and no draw."""
        if _building_empty():
            return cls(config, init_llama_params(config, None))
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return cls(config, init_llama_params(config, gen, dev))

    def checkpoint_keys(self) -> list:
        """(checkpoint key, attribute name) of every leaf: the key is the
        tree path joined with ``"."``, as the JAX package names it."""
        return [(".".join(path), name) for path, name in self._paths]

    def _tree(self, detach: bool) -> dict:
        tree: dict = {}
        for path, name in self._paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            p = getattr(self, name)
            node[path[-1]] = p.detach() if detach and isinstance(p, torch.Tensor) else p
        return tree

    @property
    def params(self) -> dict:
        return self._tree(detach=True)

    def forward(self, input_ids: torch.Tensor, segment_ids=None, position_ids=None) -> torch.Tensor:
        return llama_apply(self.config, self._tree(detach=False), input_ids,
                           segment_ids=segment_ids, position_ids=position_ids)


def create_llama(config: LlamaConfig, seed: int = 0, device="cuda") -> LlamaForCausalLM:
    """The model :func:`accelerate_tpu_torch.accelerator.Accelerator.prepare`
    takes, with random weights from ``seed`` (the JAX ``create_llama``; the
    numbers differ from ``jax.random``'s)."""
    return LlamaForCausalLM.from_seed(config, seed=seed, device=device)


# ------------------------------------------------------------------ forward
def _mlp_act(config, gate):
    if config.hidden_act == "gelu_tanh":
        return torch.nn.functional.gelu(gate, approximate="tanh")
    if config.hidden_act != "silu":
        raise ValueError(f"unsupported hidden_act {config.hidden_act!r}")
    return torch.nn.functional.silu(gate)


def rms_norm(x, scale, eps, offset: bool = False):
    """``offset=True``: Gemma convention, effective scale ``1 + w``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = scale.float()
    if offset:
        w = 1.0 + w
    return (y * w).to(x.dtype)


def _rope_freqs(head_dim: int, theta: float, scaling=None) -> np.ndarray:
    """Base inverse frequencies (float64, host), optionally rope-scaled;
    ``scaling`` is ``LlamaConfig._rope_scaling_key()``."""
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    if scaling is None:
        return freqs
    cfg = dict(scaling)
    rope_type = cfg.get("rope_type", cfg.get("type"))
    if rope_type is None:
        raise ValueError("rope_scaling needs an explicit 'rope_type' ('linear' or 'llama3')")
    factor = float(cfg.get("factor", 1.0))
    if rope_type == "linear":
        return freqs / factor
    if rope_type == "llama3":
        low = float(cfg.get("low_freq_factor", 1.0))
        high = float(cfg.get("high_freq_factor", 4.0))
        orig = float(cfg.get("original_max_position_embeddings", 8192))
        wavelen = 2 * np.pi / freqs
        smooth = np.clip((orig / wavelen - low) / (high - low), 0.0, 1.0)
        return (1 - smooth) * freqs / factor + smooth * freqs
    raise ValueError(f"unsupported rope_scaling type {rope_type!r} (supported: linear, llama3)")


# Both caches hold device tensors, so a forward never copies a host table
# to the card (a synchronous copy from pageable memory) once warm.
@functools.lru_cache(maxsize=8)
def _rope_tables(seq_len: int, head_dim: int, theta: float, scaling, device):
    """cos/sin (seq_len, head_dim/2) computed in float64 on the host, cast
    to f32 and kept on ``device``."""
    angles = np.outer(np.arange(seq_len), _rope_freqs(head_dim, theta, scaling))
    return (torch.from_numpy(np.cos(angles).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(angles).astype(np.float32)).to(device))


@functools.lru_cache(maxsize=8)
def _rope_freqs_f32(head_dim: int, theta: float, scaling, device):
    return torch.as_tensor(_rope_freqs(head_dim, theta, scaling), dtype=torch.float32, device=device)


def _rotate(x, cos, sin):
    """Interleaved-pair rotation; cos/sin are f32, so the math runs in f32
    and the result is cast back to x's dtype."""
    b, s, h, d = x.shape
    x1, x2 = x[..., 0::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], dim=-1).reshape(b, s, h, d).to(x.dtype)


def apply_rope(x, position_offset: int, theta: float, position_ids=None, scaling=None):
    """Rotary embedding on (B, S, H, D) from the host float64 tables."""
    b, s, h, d = x.shape
    cos_t, sin_t = _rope_tables(s + position_offset, d, theta, scaling, x.device)
    if position_ids is not None:
        cos = cos_t[position_ids][:, :, None, :]
        sin = sin_t[position_ids][:, :, None, :]
    else:
        cos = cos_t[position_offset:position_offset + s][None, :, None, :]
        sin = sin_t[position_offset:position_offset + s][None, :, None, :]
    return _rotate(x, cos, sin)


def _rope_at_tables(pos, head_dim: int, theta: float, scaling, device):
    """cos/sin for decode positions, angles computed on the device in f32,
    shaped to broadcast over (B, 1, H, head_dim/2)."""
    freqs = _rope_freqs_f32(head_dim, theta, scaling, device)
    pos = torch.as_tensor(pos, device=device)
    if pos.dim() == 0:
        angles = (pos.float() * freqs)[None, None, None, :]
    else:
        angles = (pos.float()[:, None] * freqs[None, :])[:, None, None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope_at(x, pos, theta: float, scaling=None):
    """RoPE at a decode position computed on the device in f32: scalar
    ``pos`` rotates every row alike, a (B,) ``pos`` each row at its own."""
    return _rotate(x, *_rope_at_tables(pos, x.shape[-1], theta, scaling, x.device))


def _rope_window_tables(pos, w: int, head_dim: int, theta: float, scaling, device):
    """cos/sin (B, W, 1, head_dim/2) of a window at ``pos[b] + j``, angles
    computed on the device in f32."""
    freqs = _rope_freqs_f32(head_dim, theta, scaling, device)
    abs_pos = pos.float()[:, None] + torch.arange(w, dtype=torch.float32, device=device)[None, :]
    angles = (abs_pos[:, :, None] * freqs[None, None, :])[:, :, None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope_window(x, pos, theta: float, scaling=None):
    """RoPE for a W-token window: ``x`` (B, W, H, D) where offset j of row b
    sits at absolute position ``pos[b] + j``; the angles are computed on the
    device in f32, as :func:`apply_rope_at` does."""
    return _rotate(x, *_rope_window_tables(pos, x.shape[1], x.shape[-1], theta, scaling, x.device))


def _matmul(config, y, w, out_dtype=None):
    """``y @ w`` for a projection weight: a float tensor is cast to the
    compute dtype; a per-channel quantized leaf (int8 or linear int4)
    multiplies as int8 through the quantized matmul kernel, scales after the
    sum (the same function as ``y @ dequantize(w)``); a block-scaled or
    NF4 leaf is dequantized to its original dtype, then cast, as the JAX
    package does. ``out_dtype=torch.float32`` keeps the f32 sums (the LM
    head); by default the product is in the compute dtype."""
    if isinstance(w, QuantizedLeaf) and w.block_size is None:
        return _qmm.quantized_matmul(y, w.q, w.scales, out_dtype=out_dtype)
    if not isinstance(w, torch.Tensor):
        w = w.dequantize()
    if out_dtype == torch.float32:
        return _f32_product(y, w.to(config.compute_dtype))
    return y @ w.to(config.compute_dtype)


class _F32Product(torch.autograd.Function):
    """``x @ w`` of two bf16 (or f16) operands with an f32 output: the JAX
    head's ``einsum(..., preferred_element_type=jnp.float32)``. On CUDA one
    cuBLAS GEMM with bf16 operands, f32 accumulation and an f32 output
    (``aten::mm.dtype``); on the CPU, which has no kernel for that overload,
    f32 operands, which give the same products (a bf16 x bf16 product is
    exact in f32).

    The backward rounds the f32 cotangent to the operands' dtype and runs
    both products as bf16 GEMMs with f32 accumulation. The JAX backward is
    a dot of the f32 cotangent with a bf16 operand, which XLA at its default
    precision runs on the TPU as bf16 passes: the rounding is what the
    reference does on its own chip. An f32 x f32 GEMM here would be ~17
    TFLOP of f32 work a step at Llama-3-8B's vocabulary and batch 4 x 2048."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        if x.device.type == "cuda":
            out = torch.mm(x2, w, out_dtype=torch.float32)
        else:
            out = x2.float() @ w.float()
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1]).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (g @ w.T).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).T @ g
        return dx, dw


def _f32_product(x, w):
    """``x @ w`` with f32 products and an f32 output (f32 operands as they are)."""
    if x.dtype == torch.float32:
        return x @ w.float()
    return _F32Product.apply(x, w)


def _proj(config, layer_params, name, y):
    p = layer_params["attn"][name]
    out = _matmul(config, y, p["kernel"])
    if "bias" in p:
        out = out + p["bias"].to(config.compute_dtype)
    return out


def _mlp_block(config, layer_params, x):
    """Post-attention half of a block: norm, SwiGLU/GeGLU MLP, residual."""
    y = rms_norm(x, layer_params["post_attn_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    mlp = layer_params["mlp"]
    gate = _matmul(config, y, mlp["gate_proj"]["kernel"])
    up = _matmul(config, y, mlp["up_proj"]["kernel"])
    y = _matmul(config, _mlp_act(config, gate) * up, mlp["down_proj"]["kernel"])
    if config.post_block_norms:
        y = rms_norm(y, layer_params["mlp_out_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    return x + y


def _attn_out(config, layer_params, attn, residual):
    b, s = attn.shape[:2]
    attn = _matmul(config, attn.reshape(b, s, -1), layer_params["attn"]["o_proj"]["kernel"])
    if config.post_block_norms:
        attn = rms_norm(attn, layer_params["attn_out_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    return residual + attn


def _layer(config: LlamaConfig, layer_params, x, position_offset: int = 0,
           collect_kv: bool = False, segment_ids=None, position_ids=None):
    """One block on (B, S, D) activations; ``collect_kv=True`` also returns
    the post-RoPE k/v for building the cache. ``segment_ids`` (B, S) keep
    attention inside packed documents; ``position_ids`` (B, S) are per-token
    RoPE positions (restarting at each document)."""
    h, kvh, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    b, s, _ = x.shape
    y = rms_norm(x, layer_params["input_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    q = _proj(config, layer_params, "q_proj", y).reshape(b, s, h, hd)
    k = _proj(config, layer_params, "k_proj", y).reshape(b, s, kvh, hd)
    v = _proj(config, layer_params, "v_proj", y).reshape(b, s, kvh, hd)
    sc = config._rope_scaling_key()
    q = apply_rope(q, position_offset, config.rope_theta, position_ids, sc)
    k = apply_rope(k, position_offset, config.rope_theta, position_ids, sc)
    if config.query_pre_attn_scalar is not None:
        # every impl scales by 1/sqrt(hd); this makes it 1/sqrt(qpas)
        q = q * math.sqrt(hd / config.query_pre_attn_scalar)
    attn = dispatch_attention(
        config.attention_impl, q.contiguous(), k.contiguous(), v.contiguous(),
        causal=True, q_offset=position_offset, kv_block=config.attention_kv_block,
        window=config.sliding_window, softcap=config.attn_logit_softcap,
        segment_ids=segment_ids,
    )
    x = _mlp_block(config, layer_params, _attn_out(config, layer_params, attn, x))
    return (x, (k, v)) if collect_kv else x


def _layer_slice(layers: dict, i: int) -> dict:
    return {k: _layer_slice(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def _layer_trees(layers: dict, n: int) -> list:
    """Every layer's parameters from the stacked tree, by one ``unbind`` per
    leaf. Its backward stacks the ``n`` layer gradients once; ``n`` slices
    (:func:`_layer_slice`) would each write a zero gradient of the whole
    stack, ``n`` times the gradient's bytes per step."""
    split = {k: _layer_trees(v, n) if isinstance(v, dict) else _unbind_leaf(v)
             for k, v in layers.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _unbind_leaf(leaf):
    """Each layer's slice of a stacked leaf: a tensor or quantized leaf is
    split; an NF4 leaf (packed over the whole flattened stack) is
    dequantized first, as the JAX package does every leaf."""
    if isinstance(leaf, NF4Leaf):
        return leaf.dequantize().unbind(0)
    if isinstance(leaf, QuantizedLeaf):
        return leaf.layers()
    return leaf.unbind(0)


def _embed(config, params, ids):
    x = params["embed_tokens"]["embedding"][ids].to(config.compute_dtype)
    if config.scale_embeddings:
        x = x * torch.tensor(config.hidden_size ** 0.5, dtype=config.compute_dtype)
    return x


def _head(config, params, x):
    """Final norm + LM head -> f32 logits, as the JAX ``llama_apply``
    computes them: operands in the compute dtype, f32 products and output
    (``preferred_element_type=jnp.float32``), the final softcap in f32."""
    x = rms_norm(x, params["final_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    if config.tie_word_embeddings:
        logits = _f32_product(x, params["embed_tokens"]["embedding"].to(config.compute_dtype).T)
    else:
        logits = _matmul(config, x, params["lm_head"]["kernel"], out_dtype=torch.float32)
    return tanh_softcap(logits, config.final_logit_softcap)


def _serving_head(config, params, x):
    """Final norm + LM head of the prefill, decode and verify steps, as the
    JAX serving steps compute it (``_prefill_head``): the product and the
    softcap in the compute dtype, then f32."""
    cdt = config.compute_dtype
    x = rms_norm(x, params["final_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    if config.tie_word_embeddings:
        logits = x @ params["embed_tokens"]["embedding"].to(cdt).T
    else:
        logits = _matmul(config, x, params["lm_head"]["kernel"])
    return tanh_softcap(logits, config.final_logit_softcap).float()


def llama_apply(config: LlamaConfig, params: dict, input_ids: torch.Tensor,
                segment_ids=None, position_ids=None) -> torch.Tensor:
    """Causal forward over (B, S) token ids -> f32 logits (B, S, V).
    ``segment_ids`` (B, S): packed-sequence document labels (attention never
    crosses a boundary); ``position_ids`` (B, S): per-token RoPE positions.
    With gradients on and remat ``"nothing"`` (the JAX default) each layer
    is a checkpoint region: its activations are recomputed in the backward,
    so the flash forward runs twice per layer and step."""
    _check_supported(config)
    if config.remat_policy not in ("nothing", "full"):
        raise NotImplementedError(
            f"remat_policy={config.remat_policy!r} is not ported yet (queued in "
            "ROADMAP.md); use 'nothing' (recompute each layer) or 'full' (keep all)"
        )
    remat = config.remat_policy == "nothing" and torch.is_grad_enabled()
    x = _embed(config, params, input_ids)
    for lp in _layer_trees(params["layers"], config.num_hidden_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _layer, config, lp, x, 0, False, segment_ids, position_ids,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x = _layer(config, lp, x, segment_ids=segment_ids, position_ids=position_ids)
    return _head(config, params, x)


# ----------------------------------------------------------------- loss
def _mask_of(labels, mask):
    """HF semantics: an explicit loss_mask wins (sliced to the label
    length), else labels < 0 (the -100 ignore index) are excluded."""
    if mask is None:
        return (labels >= 0).float()
    return mask[:, : labels.shape[1]].float()


def _dense_ce_from_logits(logits, labels, mask, reduction: str = "mean"):
    """Masked cross entropy from full logits: f32 logsumexp minus the label
    logit, summed over the mask, divided by ``max(sum(mask), 1)``
    (``reduction="sum"`` returns the masked sum). The label logit is a
    gather where the JAX package uses a one-hot einsum (a partitioner
    workaround): the same value without a (B, S, V) one-hot."""
    mask = _mask_of(labels, mask)
    labels = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    label_logit = logits.gather(-1, labels[..., None])[..., 0].float()
    total = ((lse - label_logit) * mask).sum()
    if reduction == "sum":
        return total
    return total / mask.sum().clamp_min(1)


def llama_ce_denominator(batch) -> torch.Tensor:
    """The valid-token count :func:`llama_loss` divides by."""
    labels = batch.get("labels")
    if labels is None:
        labels = batch["input_ids"][:, 1:]
    return _mask_of(labels, batch.get("loss_mask")).sum().clamp_min(1)


def llama_loss(model, batch) -> torch.Tensor:
    """Next-token cross entropy; ``batch = {"input_ids": (B, S)}`` with
    optional ``"labels"`` (default: the shifted input_ids), ``"loss_mask"``,
    and ``"segment_ids"``/``"position_ids"`` (forwarded to the model so
    attention never crosses a packed document)."""
    input_ids = batch["input_ids"]
    packed = {k: batch[k] for k in ("segment_ids", "position_ids") if k in batch}
    logits = model(input_ids, **packed)
    labels = batch.get("labels")
    if labels is None:
        labels = input_ids[:, 1:]
        logits = logits[:, :-1]
    return _dense_ce_from_logits(logits, labels, batch.get("loss_mask"))


def llama_flops_per_token(config: LlamaConfig, seq_len: int) -> float:
    """Useful training FLOPs per token for MFU: 3 x (forward matmuls +
    attention upper bound + LM head); the remat recompute is not useful
    work and is not counted."""
    d, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    h, kvh, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    per_layer = 2 * d * (h * hd) + 2 * 2 * d * (kvh * hd) + 2 * (h * hd) * d  # qkvo
    per_layer += 3 * 2 * d * i  # swiglu
    attn = 2 * 2 * seq_len * h * hd  # qk + pv per token (causal is about half)
    fwd = config.num_hidden_layers * (per_layer + attn) + 2 * d * v
    return 3.0 * fwd


def _prefill_stack(config: LlamaConfig, params, input_ids):
    """One full forward over the prompt -> (pre-final-norm hidden (B, S, D),
    stacked K and V (L, B, S, kvh, hd))."""
    _check_supported(config, params)
    x = _embed(config, params, input_ids)
    ks, vs = [], []
    for i in range(config.num_hidden_layers):
        x, (k, v) = _layer(config, _layer_slice(params["layers"], i), x, collect_kv=True)
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def _pad_prefill_cache(ks, vs, max_len: int):
    pad = max_len - ks.shape[2]
    return {
        "k": torch.nn.functional.pad(ks, (0, 0, 0, 0, 0, pad)),
        "v": torch.nn.functional.pad(vs, (0, 0, 0, 0, 0, pad)),
    }


def llama_prefill_at(config: LlamaConfig, params, input_ids, max_len: int, last_index):
    """Prefill a right-padded prompt batch with logits at per-row
    ``last_index`` (B,), the last real prompt position. Padding rows still
    write KV, which is safe: decode masks ``k_pos <= pos`` and overwrites
    each position before it becomes attendable."""
    x, ks, vs = _prefill_stack(config, params, input_ids)
    last_index = torch.as_tensor(last_index, device=x.device).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), last_index]
    return _serving_head(config, params, x_last), _pad_prefill_cache(ks, vs, max_len)


def _write_kv_at(cache, kv, pos):
    """Write one position's rows of a (B, 1, H, D) ``kv`` into a (B,
    max_len, H, D) ``cache`` in place, at scalar ``pos`` or per-row (B,)."""
    pos = torch.as_tensor(pos, device=cache.device).long()
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.expand(cache.shape[0])] = kv[:, 0].to(cache.dtype)
    return cache


def _layer_leaf(leaf, i):
    """Layer ``i`` of a stacked cache leaf: a tensor, or the int8 ``{"q",
    "s"}`` pair (views: in-place writes reach the stacked store)."""
    if isinstance(leaf, dict):
        return {k: v[i] for k, v in leaf.items()}
    return leaf[i]


def _use_kernel_attention(config, kv_layout) -> bool:
    """Whether the decode step routes attention through the paged
    flash-decode kernel: opted in on the layout. A sliding-window config
    is refused there (the kernel walks the whole live table)."""
    if kv_layout is None or getattr(kv_layout, "attention_impl", "reference") != "kernel":
        return False
    if config.sliding_window is not None:
        raise ValueError(
            "the paged flash-decode kernel does not support sliding-window configs "
            f"(sliding_window={config.sliding_window}); use attention_impl='reference'"
        )
    return True


def _attn_scale(config) -> float:
    return float(1.0 / np.sqrt(config.query_pre_attn_scalar or config.head_dim))


def _kernel_decode_override(config, kv_layout, pos, ck_pool, cv_pool):
    """Decode attention through the kernel: commit the rope-rotated new K/V
    column into the pool FIRST, then run the flash-decode kernel over the
    block tables (no dense view is gathered). ``pos`` is (B,) int32."""
    from ..ops.paged_decode import paged_flash_decode

    def override(q, k_new, v_new):
        kv_layout.commit_column(ck_pool, k_new, pos)
        kv_layout.commit_column(cv_pool, v_new, pos)
        k_pool, v_pool, scales = _pool_operands(ck_pool, cv_pool)
        out = paged_flash_decode(
            q.contiguous(), k_pool, v_pool, kv_layout.tables, pos, **scales,
            scale=_attn_scale(config), softcap=config.attn_logit_softcap,
        )
        return out, ck_pool, cv_pool

    return override


def _pool_operands(ck_pool, cv_pool):
    """(k_pool, v_pool, {k_scale, v_scale}) of a layer's pool leaves, for the
    kernel wrappers: int8 ``{"q", "s"}`` pairs pass their scales."""
    if isinstance(ck_pool, dict):
        return ck_pool["q"], cv_pool["q"], {"k_scale": ck_pool["s"], "v_scale": cv_pool["s"]}
    return ck_pool, cv_pool, {}


def _kernel_verify_override(config, kv_layout, pos, ck_pool, cv_pool):
    """Verify attention through the kernel: it walks the committed history
    in the pool (strictly ``k_pos < pos``) and attends the window's fresh
    K/V from its operands; nothing is written, the engine commits the
    accepted prefix afterwards. ``pos`` is (B,) int32."""
    from ..ops.paged_decode import paged_flash_verify

    def override(q, k_win, v_win):
        k_pool, v_pool, scales = _pool_operands(ck_pool, cv_pool)
        return paged_flash_verify(
            q.contiguous(), k_pool, v_pool, k_win.contiguous(), v_win.contiguous(),
            kv_layout.tables, pos, **scales,
            scale=_attn_scale(config), softcap=config.attn_logit_softcap,
        )

    return override


def _decode_layer(config: LlamaConfig, layer_params, x, cache_k, cache_v, pos,
                  attention_override=None, rope=None):
    """One block, one new position per row. ``pos`` is a scalar or (B,)
    tensor. Without an override, the new K/V column is written into the
    dense (B, max_len, kvh, hd) caches in place and attention is the
    grouped masked einsum; ``attention_override(q, k, v) -> (attn, ck, cv)``
    owns both the store and the attention instead (the kernel path).
    ``rope``: the (cos, sin) of ``pos``, when the caller computed them once
    for every layer (:func:`apply_rope_at`'s tables)."""
    h, kvh, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    b, s, _ = x.shape
    cdt = config.compute_dtype
    y = rms_norm(x, layer_params["input_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    q = _proj(config, layer_params, "q_proj", y).reshape(b, s, h, hd)
    k = _proj(config, layer_params, "k_proj", y).reshape(b, s, kvh, hd)
    v = _proj(config, layer_params, "v_proj", y).reshape(b, s, kvh, hd)
    if rope is None:
        rope = _rope_at_tables(pos, hd, config.rope_theta, config._rope_scaling_key(), x.device)
    q = _rotate(q, *rope)
    k = _rotate(k, *rope)
    if attention_override is not None:
        attn, cache_k, cache_v = attention_override(q, k, v)
        attn = attn.to(cdt)
    else:
        cache_k = _write_kv_at(cache_k, k, pos)
        cache_v = _write_kv_at(cache_v, v, pos)
        n_rep = h // kvh
        qg = (q * _attn_scale(config)).reshape(b, s, kvh, n_rep, hd)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), cache_k.to(cdt).float())
        scores = tanh_softcap(scores, config.attn_logit_softcap)
        k_pos = torch.arange(cache_k.shape[1], device=x.device)
        pos_b = pos.long() if pos.dim() == 0 else pos.long()[:, None, None, None, None]
        scores = torch.where(k_pos <= pos_b, scores, NEG_INF)
        if config.sliding_window is not None:
            scores = torch.where(pos_b - k_pos < config.sliding_window, scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        attn = torch.einsum(
            "bgrqk,bkgd->bqgrd", weights.to(cdt).float(), cache_v.to(cdt).float()
        ).to(cdt)
    x = _attn_out(config, layer_params, attn, x)
    return _mlp_block(config, layer_params, x), cache_k, cache_v


def llama_decode_step(config: LlamaConfig, params, cache, token, pos, *, kv_layout=None):
    """One decode step: ``token`` (B, 1) at ``pos`` (scalar or (B,) tensor).
    Returns (f32 logits (B, V), cache). ``cache`` leaves are (L, ...)
    tensors updated in place: the dense arena (L, B, max_len, kvh, hd), or
    with ``kv_layout`` (a :class:`~accelerate_tpu_torch.kvcache
    .PagedKVLayout`) the block pool (L, num_blocks, block_size, kvh, hd)."""
    _check_supported(config, params)
    pos = torch.as_tensor(pos, device=token.device)
    x = _embed(config, params, token)
    # position-only work, done once for all layers
    rope = _rope_at_tables(pos, config.head_dim, config.rope_theta,
                           config._rope_scaling_key(), x.device)
    use_kernel = _use_kernel_attention(config, kv_layout)
    if use_kernel:
        pos_i32 = (pos.expand(token.shape[0]) if pos.dim() == 0 else pos).to(torch.int32).contiguous()
    for i in range(config.num_hidden_layers):
        lp = _layer_slice(params["layers"], i)
        ck, cv = _layer_leaf(cache["k"], i), _layer_leaf(cache["v"], i)
        if use_kernel:
            override = _kernel_decode_override(config, kv_layout, pos_i32, ck, cv)
            x, _, _ = _decode_layer(config, lp, x, None, None, pos, attention_override=override,
                                    rope=rope)
        elif kv_layout is not None:
            view_k, view_v = kv_layout.view(ck), kv_layout.view(cv)
            x, view_k, view_v = _decode_layer(config, lp, x, view_k, view_v, pos, rope=rope)
            kv_layout.commit(ck, view_k, pos)
            kv_layout.commit(cv, view_v, pos)
        else:
            x, _, _ = _decode_layer(config, lp, x, ck, cv, pos, rope=rope)
    return _serving_head(config, params, x)[:, 0], cache


def _verify_layer(config: LlamaConfig, layer_params, x, cache_k, cache_v, pos,
                  attention_override=None, rope=None):
    """One block over a W-token window: ``x`` (B, W, D) at positions ``pos
    .. pos+W-1`` (``pos`` (B,)). The caches are read only: the window's K/V
    are written into copies so the window attends itself causally, and the
    rotated window K and raw V are returned for the caller to commit the
    accepted prefix. ``attention_override(q, k, v) -> attn`` (the kernel
    path) reads the pool and the window itself. ``rope``: the window's
    (cos, sin), when the caller computed them once for every layer."""
    h, kvh, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    b, w, _ = x.shape
    cdt = config.compute_dtype
    y = rms_norm(x, layer_params["input_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    q = _proj(config, layer_params, "q_proj", y).reshape(b, w, h, hd)
    k = _proj(config, layer_params, "k_proj", y).reshape(b, w, kvh, hd)
    v = _proj(config, layer_params, "v_proj", y).reshape(b, w, kvh, hd)
    if rope is None:
        rope = _rope_window_tables(pos, w, hd, config.rope_theta, config._rope_scaling_key(), x.device)
    q = _rotate(q, *rope)
    k = _rotate(k, *rope)
    if attention_override is not None:
        attn = attention_override(q, k, v).to(cdt)
    else:
        ck = _write_window(cache_k.clone(), k, pos)
        cv = _write_window(cache_v.clone(), v, pos)
        n_rep = h // kvh
        qg = (q * _attn_scale(config)).reshape(b, w, kvh, n_rep, hd)
        scores = torch.einsum("bqgrd,bkgd->bgrqk", qg.float(), ck.to(cdt).float())
        scores = tanh_softcap(scores, config.attn_logit_softcap)
        k_pos = torch.arange(ck.shape[1], device=x.device)
        q_abs = (pos.long()[:, None] + torch.arange(w, device=x.device)[None, :])[:, None, None, :, None]
        scores = torch.where(k_pos <= q_abs, scores, NEG_INF)
        if config.sliding_window is not None:
            scores = torch.where(q_abs - k_pos < config.sliding_window, scores, NEG_INF)
        weights = torch.softmax(scores, dim=-1)
        attn = torch.einsum(
            "bgrqk,bkgd->bqgrd", weights.to(cdt).float(), cv.to(cdt).float()
        ).to(cdt)
    x = _attn_out(config, layer_params, attn, x)
    return _mlp_block(config, layer_params, x), k, v


def llama_verify_step(config: LlamaConfig, params, cache, tokens, pos, *, kv_layout=None):
    """Window forward: ``tokens`` (B, W), each row's carried token and its
    W-1 drafts (or a chunk of a prompt), at positions ``pos .. pos+W-1``
    (``pos`` (B,) tensor). Returns (f32 logits (B, W, V), the window KV
    ``{"k", "v"}`` of (L, B, W, kvh, hd)). The cache is read only: the caller
    commits the accepted prefix (``commit_window``), so a rejected draft
    never reaches the store. With ``kv_layout`` the cache is the block pool
    (f32/bf16 or int8 ``{"q", "s"}`` leaves): the reference path gathers
    each layer's dense view, the kernel path runs the verify kernel."""
    _check_supported(config, params)
    pos = torch.as_tensor(pos, device=tokens.device)
    x = _embed(config, params, tokens)
    # position-only work, done once for all layers
    rope = _rope_window_tables(pos, tokens.shape[1], config.head_dim, config.rope_theta,
                               config._rope_scaling_key(), x.device)
    use_kernel = _use_kernel_attention(config, kv_layout)
    if use_kernel:
        pos_i32 = pos.to(torch.int32).contiguous()
    win_k, win_v = [], []
    for i in range(config.num_hidden_layers):
        lp = _layer_slice(params["layers"], i)
        ck, cv = _layer_leaf(cache["k"], i), _layer_leaf(cache["v"], i)
        if use_kernel:
            override = _kernel_verify_override(config, kv_layout, pos_i32, ck, cv)
            x, k, v = _verify_layer(config, lp, x, None, None, pos, attention_override=override,
                                    rope=rope)
        else:
            if kv_layout is not None:
                ck, cv = kv_layout.view(ck), kv_layout.view(cv)
            x, k, v = _verify_layer(config, lp, x, ck, cv, pos, rope=rope)
        win_k.append(k)
        win_v.append(v)
    return _serving_head(config, params, x), {"k": torch.stack(win_k), "v": torch.stack(win_v)}
