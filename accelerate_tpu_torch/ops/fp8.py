"""fp8 training (counterpart of ``accelerate_tpu/ops/fp8.py``): the
current-scaling recipe.

Each operand of a product is scaled by ``fmax / amax`` of its own values
(one f32 scale a tensor, no history) and cast: e4m3 for activations and
weights in the forward product, e5m2 for the cotangent in both backward
products. Every product accumulates in f32 and multiplies the two inverse
scales in after the sum (``out * (sx * sw)``), then casts to the
operand's dtype, as the JAX ``fp8_dot`` does.

On a CUDA tensor a product is ``torch._scaled_mm`` on the card's fp8
tensor cores, its one scale ``sx * sw`` as JAX rounds it (the JAX package
computes this dot with ``jnp.einsum`` outside any Pallas kernel). On a CPU
tensor the plain version runs: the fp8 values in f32, ``(qa @ qb) *
scale``. Nothing here synchronises with the host: the scales stay on the
device, so a step can be captured in a CUDA graph.

Mesh-wide scales. Under GSPMD the JAX amax of a sharded array is a global
reduction, so its scales span the whole batch and every ``tp`` block of a
weight. :class:`Fp8Groups` names the process groups that give the port's
local blocks the same scales: ``act`` for activations and cotangents (every
rank of the mesh: the data-parallel ranks hold other rows, the ``tp`` ranks
other columns of a column-parallel output and other rows of a row-parallel
input; where they hold the same values a MAX over them changes nothing),
``weight`` for weights (their ``tp`` blocks; FSDP2 hands the product the
gathered weight). Each amax over a group is one all-reduce (MAX) of an f32
scalar; :attr:`Fp8Groups.reductions` counts them.

:func:`fp8_rewrite` puts the products of any module on this path, as the
JAX ``fp8_rewrite`` does for any traced function.

The quantize passes run under the profiler range ``fp8_quantize`` and the
operands' copies into ``_scaled_mm``'s layouts under ``fp8_layout``, so a
trace gives their device time a step (:func:`kernels_in_ranges`; an
inactive range costs the host a few microseconds).
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

__all__ = [
    "E4M3_MAX",
    "E5M2_MAX",
    "Fp8Config",
    "Fp8Groups",
    "fp8_dot",
    "fp8_rewrite",
    "kernels_in_ranges",
    "quantize_e4m3",
    "quantize_e5m2",
    "quantize_input",
    "scaled_mm",
    "scaled_mm_plain",
    "scaled_mm_count",
]

E4M3_MAX = 448.0
E5M2_MAX = 57344.0

_FLOATS = (torch.float32, torch.bfloat16, torch.float16)

# torch._scaled_mm wants every dim of both operands a multiple of this
_MM_ALIGN = 16

# products launched through torch._scaled_mm (the card path), for a run to
# show that its products went through the fp8 tensor cores
_scaled_mm_launches = [0]


def scaled_mm_count() -> int:
    """Products launched through ``torch._scaled_mm`` in this process."""
    return _scaled_mm_launches[0]


class Fp8Groups:
    """The process groups an fp8 scale's amax spans: ``act`` for
    activations and cotangents, ``weight`` for weights; None: this rank's
    values alone (no collective). ``reductions`` counts the all-reduces
    issued through this object."""

    def __init__(self, act=None, weight=None):
        self.act = act
        self.weight = weight
        self.reductions = 0



def _amax(x: torch.Tensor, group, groups: Optional[Fp8Groups]) -> torch.Tensor:
    """max |x| as an f32 device scalar, all-reduced (MAX) over ``group``."""
    amax = torch.linalg.vector_norm(x.detach(), float("inf"), dtype=torch.float32)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        if groups is not None:
            groups.reductions += 1
    return amax


def _quantize(x: torch.Tensor, fmax: float, dtype, group=None, groups=None):
    with torch.profiler.record_function("fp8_quantize"):
        amax = _amax(x, group, groups)
        # IEEE divisions of f32 tensors, as the JAX functions compute them
        # (``fmax / tensor`` would be a reciprocal and a product: two roundings)
        scale = amax.new_full((), fmax) / amax.clamp_min(1e-12)
        q = x.detach().to(torch.float32, copy=True).mul_(scale).to(dtype)
        return q, scale.new_ones(()) / scale


def quantize_e4m3(x: torch.Tensor, group=None, groups: Optional[Fp8Groups] = None):
    """Returns ``(q, inv_scale)``: ``x ~= q.float() * inv_scale``, ``q`` in
    e4m3 (``float8_e4m3fn``), ``inv_scale`` an f32 device scalar. ``group``:
    the process group the amax spans (counted on ``groups``)."""
    return _quantize(x, E4M3_MAX, torch.float8_e4m3fn, group, groups)


def quantize_e5m2(x: torch.Tensor, group=None, groups: Optional[Fp8Groups] = None):
    """:func:`quantize_e4m3` in e5m2 (``float8_e5m2``), the gradients' format."""
    return _quantize(x, E5M2_MAX, torch.float8_e5m2, group, groups)


# ---------------------------------------------------------------- products
def scaled_mm_plain(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, out_dtype):
    """``(a @ b) * scale`` of two 2-D fp8 operands: their values in f32
    (exact), f32 sums, the scale after the sum, cast to ``out_dtype``."""
    return (torch.mm(a.to(torch.float32), b.to(torch.float32)) * scale).to(out_dtype)


def _padded(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    out = t.new_zeros((rows, cols))
    out[: t.shape[0], : t.shape[1]] = t
    return out


def _up(n: int) -> int:
    return -(-n // _MM_ALIGN) * _MM_ALIGN


def scaled_mm(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor, out_dtype) -> torch.Tensor:
    """``(a @ b) * scale`` of two 2-D fp8 operands, cast to ``out_dtype``.
    On CUDA one ``torch._scaled_mm`` (e4m3 x e4m3, e5m2 x e4m3 or e4m3 x
    e5m2; f32 accumulation; ``scale`` as the first operand's scale, one as
    the second's): ``a`` row-major, ``b`` column-major (copies where they
    are not), every dim zero-padded to a multiple of 16 (zeros add nothing
    to a sum). On the CPU :func:`scaled_mm_plain`."""
    if a.device.type != "cuda":
        return scaled_mm_plain(a, b, scale, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = _up(m), _up(k), _up(n)
    with torch.profiler.record_function("fp8_layout"):
        a = _padded(a, mp, kp).contiguous()
        b = _padded(b, kp, np_)
        if b.stride() != (1, kp):
            b = b.t().contiguous().t()
    _scaled_mm_launches[0] += 1
    out = torch._scaled_mm(a, b, scale_a=scale.reshape(1), scale_b=scale.new_ones(1),
                           out_dtype=out_dtype)
    return out if (mp, np_) == (m, n) else out[:m, :n]


class _Fp8Dot(torch.autograd.Function):
    """``x @ w`` through fp8, the JAX ``fp8_dot``'s custom VJP. The backward
    keeps the forward's quantized operands and scales (JAX quantizes the
    same values again into the same bytes)."""

    @staticmethod
    def forward(ctx, x, w, groups, qx_sx):
        act = groups.act if groups is not None else None
        weight = groups.weight if groups is not None else None
        qx, sx = qx_sx if qx_sx is not None else quantize_e4m3(x, act, groups)
        qw, sw = quantize_e4m3(w, weight, groups)
        x2 = qx.reshape(-1, qx.shape[-1])
        out = scaled_mm(x2, qw, sx * sw, x.dtype)
        ctx.save_for_backward(qx, sx, qw, sw)
        ctx.groups, ctx.act = groups, act
        ctx.dtypes = (x.dtype, w.dtype)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        qx, sx, qw, sw = ctx.saved_tensors
        x_dtype, w_dtype = ctx.dtypes
        qg, sg = quantize_e5m2(g, ctx.act, ctx.groups)
        g2 = qg.reshape(-1, qg.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = scaled_mm(g2, qw.t(), sg * sw, x_dtype).reshape(*qx.shape)
        if ctx.needs_input_grad[1]:
            dw = scaled_mm(qx.reshape(-1, qx.shape[-1]).t(), g2, sg * sx, w_dtype)
        return dx, dw, None, None


def fp8_dot(x: torch.Tensor, w: torch.Tensor, *, amax_group: Optional[Fp8Groups] = None,
            quantized_x=None) -> torch.Tensor:
    """``x @ w`` with e4m3 operands forward and an e5m2 cotangent backward;
    ``x`` (..., K), ``w`` (K, N); the output in x's dtype, the gradients in
    their operands' dtypes. ``amax_group``: the groups the scales span
    (:class:`Fp8Groups`; None: this rank's values). ``quantized_x``: ``x``'s
    ``(q, inv_scale)`` from :func:`quantize_e4m3` over ``amax_group.act``,
    when several products share ``x`` (q/k/v, gate/up): one amax for all."""
    return _Fp8Dot.apply(x, w, amax_group, quantized_x)


def quantize_input(x: torch.Tensor, amax_group: Optional[Fp8Groups] = None):
    """``x``'s e4m3 ``(q, inv_scale)`` over the activation group, for
    :func:`fp8_dot`'s ``quantized_x``."""
    return quantize_e4m3(x, amax_group.act if amax_group is not None else None, amax_group)


class Fp8Config:
    """The JAX ``Fp8Config``: ``use_fp8_dots`` on, and products whose K and N
    are both at least ``min_dim`` (smaller ones cost more to quantize than
    they save)."""

    def __init__(self, use_fp8_dots: bool = True, min_dim: int = 256):
        self.use_fp8_dots = use_fp8_dots
        self.min_dim = min_dim

    def maybe_dot(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.use_fp8_dots and w.shape[0] >= self.min_dim and w.shape[-1] >= self.min_dim:
            return fp8_dot(x, w)
        return x @ w


# ------------------------------------------------------------- fp8_rewrite
# the Python frame of every autograd Function's forward (Function.apply)
_APPLY_CODE = torch.autograd.Function.apply.__func__.__code__
_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.Tensor.mm)


def _inside_autograd_function() -> bool:
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code is _APPLY_CODE:
            return True
        frame = frame.f_back
    return False


class _Fp8Rewrite(TorchFunctionMode):
    """Sends each qualifying product of a module's forward to
    :func:`fp8_dot`: ``F.linear`` as ``fp8_dot(x, W.T)`` (the bias added
    after) and ``matmul``/``@``/``mm`` with a 2-D right operand, where K and
    N are both at least ``min_dim`` and both operands are float tensors.
    Batched products (a right operand of 3 or more dims) and products inside
    an autograd Function's forward (the JAX rewrite leaves ``custom_vjp``
    bodies alone) run as they are."""

    def __init__(self, min_dim: int, groups: Optional[Fp8Groups]):
        super().__init__()
        self.min_dim = min_dim
        self.groups = groups
        self._depth = threading.local()

    def _qualifies(self, x, w) -> bool:
        from torch.distributed.tensor import DTensor

        return (isinstance(x, torch.Tensor) and isinstance(w, torch.Tensor)
                and not isinstance(x, DTensor) and not isinstance(w, DTensor)
                and x.dim() >= 1 and w.dim() == 2 and x.dtype in _FLOATS and w.dtype in _FLOATS
                and w.shape[0] >= self.min_dim and w.shape[1] >= self.min_dim
                and not _inside_autograd_function())

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is F.linear:
            x, weight = args[0], args[1] if len(args) > 1 else kwargs["weight"]
            bias = args[2] if len(args) > 2 else kwargs.get("bias")
            if self._qualifies(x, weight.t() if isinstance(weight, torch.Tensor) else weight):
                out = fp8_dot(x, weight.t(), amax_group=self.groups)
                return out if bias is None else out + bias
        elif func in _MATMULS and len(args) == 2 and not kwargs:
            x, w = args
            if self._qualifies(x, w):
                return fp8_dot(x, w, amax_group=self.groups).to(torch.promote_types(x.dtype, w.dtype))
        return func(*args, **kwargs)

    # entered around every forward of the rewritten module's submodules (a
    # depth count keeps one entry a thread), so a checkpointed submodule's
    # recompute in the backward runs under it too
    def _pre_hook(self, module, args):
        depth = getattr(self._depth, "n", 0)
        if depth == 0:
            self.__enter__()
        self._depth.n = depth + 1

    def _post_hook(self, module, args, output):
        self._depth.n -= 1
        if self._depth.n == 0:
            self.__exit__(None, None, None)


def fp8_rewrite(module: torch.nn.Module, min_dim: int = 256,
                amax_group: Optional[Fp8Groups] = None) -> torch.nn.Module:
    """Put every qualifying float product of ``module``'s forward on the fp8
    path (the JAX ``fp8_rewrite``, which rewrites a traced function's
    ``dot_general``s; the reference's ``convert_model`` swaps ``nn.Linear``
    modules). A ``TorchFunctionMode`` (:class:`_Fp8Rewrite`) is entered
    around the forward of ``module`` and each of its submodules, so it
    reaches ``x @ self.w`` as well as ``nn.Linear``, and a submodule's
    forward recomputed by a non-reentrant ``torch.utils.checkpoint`` in the
    backward runs rewritten as it ran forward (the JAX rewrite re-wraps
    ``remat`` bodies). A product in a checkpointed function that is not a
    module's forward is recomputed outside the mode, and the checkpoint
    raises on the difference. Train and eval flags are the module's own.
    ``amax_group``: the groups the scales span (:class:`Fp8Groups`).
    Returns ``module``, rewritten in place; ``module.fp8_rewrite`` is the
    mode."""
    mode = _Fp8Rewrite(min_dim, amax_group)
    for sub in module.modules():
        sub.register_forward_pre_hook(mode._pre_hook)
        sub.register_forward_hook(mode._post_hook, always_call=True)
    module.fp8_rewrite = mode
    return module


# ------------------------------------------------------------------ traces
RANGES = ("fp8_quantize", "fp8_layout")


def kernels_in_ranges(trace_events, names=RANGES) -> dict:
    """``{range: [(kernel name, device ms), ...]}`` from the events of a
    ``torch.profiler`` Chrome trace: the kernels, memsets and copies
    launched by the ops that ran inside each range's host interval on its
    thread (an op and its kernels share an ``External id``)."""
    spans = {name: [] for name in names}
    for e in trace_events:
        if e.get("cat") == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    owner = {}
    for e in trace_events:
        ext = e.get("args", {}).get("External id")
        if e.get("cat") == "cpu_op" and ext is not None:
            for name, intervals in spans.items():
                if any(tid == e.get("tid") and a <= float(e["ts"]) <= b for tid, a, b in intervals):
                    owner[ext] = name
    out = {name: [] for name in names}
    for e in trace_events:
        if e.get("cat") in ("kernel", "gpu_memset", "gpu_memcpy") and "dur" in e:
            name = owner.get(e.get("args", {}).get("External id"))
            if name is not None:
                out[name].append((e["name"], float(e["dur"]) / 1e3))
    return out
