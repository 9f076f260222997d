"""Llama-family decoder (counterpart of ``accelerate_tpu/models/llama.py``):
config presets, parameter init and conversion, the training forward and
loss, the prefill forward and the one-token decode step.

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

Not ported yet (ROADMAP.md): remat ``"dots"``/``"minimal"``, chunked CE,
MoE layers, Gemma-2's alternating sliding window, fp8, and the speculative
``llama_verify_step``.
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
from ..ops.attention import NEG_INF, dispatch_attention, tanh_softcap

__all__ = [
    "LlamaConfig",
    "LlamaForCausalLM",
    "create_llama",
    "init_llama_params",
    "params_from_jax",
    "rms_norm",
    "apply_rope",
    "apply_rope_at",
    "llama_apply",
    "llama_ce_denominator",
    "llama_flops_per_token",
    "llama_loss",
    "llama_prefill_at",
    "llama_decode_step",
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
    num_experts: int = 1  # > 1 (MoE) is not ported yet

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
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


def _check_supported(config: LlamaConfig) -> None:
    if config.num_experts > 1:
        raise NotImplementedError(
            "MoE layers (num_experts > 1) are not ported yet (ROADMAP.md)"
        )
    if config.alternating_sliding_window:
        raise NotImplementedError(
            "Gemma-2 alternating local/global attention is not ported yet (ROADMAP.md)"
        )


# ------------------------------------------------------------------- params
def init_llama_params(config: LlamaConfig, generator: torch.Generator,
                      device="cuda") -> dict:
    """Stacked-layer parameter tree, drawn like the JAX ``init_llama_params``:
    each projection ``normal * 1/sqrt(in_dim)``, the embedding ``normal *
    0.02``, norms at one (zero with ``rms_norm_offset``). ``generator`` must
    live on ``device``; the numbers differ from ``jax.random``'s."""
    _check_supported(config)
    dev = resolve_device(device)
    d, i, v = config.hidden_size, config.intermediate_size, config.vocab_size
    h, kvh, hd = config.num_attention_heads, config.num_key_value_heads, config.head_dim
    L = config.num_hidden_layers
    dt = config.param_dtype

    def dense(in_dim, out_dim):
        return (torch.randn((in_dim, out_dim), generator=generator, device=dev)
                * (1.0 / math.sqrt(in_dim))).to(dt)

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

    embedding = (torch.randn((v, d), generator=generator, device=dev) * 0.02).to(dt)
    params = {
        "embed_tokens": {"embedding": embedding},
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
    :func:`~accelerate_tpu_torch.model.prepare_model` leaves it unwrapped."""

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
        """Random weights drawn from ``torch.Generator(device).manual_seed(seed)``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return cls(config, init_llama_params(config, gen, dev))

    def _tree(self, detach: bool) -> dict:
        tree: dict = {}
        for path, name in self._paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            p = getattr(self, name)
            node[path[-1]] = p.detach() if detach else p
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


def _proj(config, layer_params, name, y):
    p = layer_params["attn"][name]
    out = y @ p["kernel"].to(config.compute_dtype)
    if "bias" in p:
        out = out + p["bias"].to(config.compute_dtype)
    return out


def _mlp_block(config, layer_params, x):
    """Post-attention half of a block: norm, SwiGLU/GeGLU MLP, residual."""
    cdt = config.compute_dtype
    y = rms_norm(x, layer_params["post_attn_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    mlp = layer_params["mlp"]
    gate = y @ mlp["gate_proj"]["kernel"].to(cdt)
    up = y @ mlp["up_proj"]["kernel"].to(cdt)
    y = (_mlp_act(config, gate) * up) @ mlp["down_proj"]["kernel"].to(cdt)
    if config.post_block_norms:
        y = rms_norm(y, layer_params["mlp_out_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    return x + y


def _attn_out(config, layer_params, attn, residual):
    b, s = attn.shape[:2]
    attn = attn.reshape(b, s, -1) @ layer_params["attn"]["o_proj"]["kernel"].to(config.compute_dtype)
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
    split = {k: _layer_trees(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in layers.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _embed(config, params, ids):
    x = params["embed_tokens"]["embedding"][ids].to(config.compute_dtype)
    if config.scale_embeddings:
        x = x * torch.tensor(config.hidden_size ** 0.5, dtype=config.compute_dtype)
    return x


def _head(config, params, x):
    """Final norm + LM head -> f32 logits."""
    cdt = config.compute_dtype
    x = rms_norm(x, params["final_norm"]["scale"], config.rms_norm_eps, config.rms_norm_offset)
    if config.tie_word_embeddings:
        logits = x @ params["embed_tokens"]["embedding"].to(cdt).T
    else:
        logits = x @ params["lm_head"]["kernel"].to(cdt)
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
    _check_supported(config)
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
    return _head(config, params, x_last), _pad_prefill_cache(ks, vs, max_len)


def _write_kv_at(cache, kv, pos):
    """Write one position's rows of a (B, 1, H, D) ``kv`` into a (B,
    max_len, H, D) ``cache`` in place, at scalar ``pos`` or per-row (B,)."""
    pos = torch.as_tensor(pos, device=cache.device).long()
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, pos.expand(cache.shape[0])] = kv[:, 0].to(cache.dtype)
    return cache


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
        out = paged_flash_decode(
            q.contiguous(), ck_pool, cv_pool, kv_layout.tables, pos,
            scale=_attn_scale(config), softcap=config.attn_logit_softcap,
        )
        return out, ck_pool, cv_pool

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
    _check_supported(config)
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
        ck, cv = cache["k"][i], cache["v"][i]
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
    return _head(config, params, x)[:, 0], cache
