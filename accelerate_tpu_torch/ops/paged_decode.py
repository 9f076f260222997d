"""Paged flash-decode and fused sampling (counterpart of
``accelerate_tpu/ops/paged_decode.py``).

* :func:`paged_flash_decode` — one query token per slot over the paged KV
  pool. A CUDA tensor launches ``csrc/paged_decode.cu`` (replacing the
  Pallas ``_decode_kernel``), which walks each slot's block table inside
  the kernel and never touches the dead tail of the row: bf16 q takes the
  tensor-core variant, ``paged_decode_mma`` or, for an int8 pool with
  per-position scales, ``paged_decode_int8_mma``; f32 q the FMA variant,
  ``paged_decode`` or ``paged_decode_int8`` (:func:`decode_kernel_for`).
  :func:`decode_plan` splits each slot's history over several blocks
  where the grid would leave SMs idle. A CPU tensor runs the plain
  version, :func:`~accelerate_tpu_torch.ops.attention.paged_attention`,
  which gathers the whole table first.
* :func:`paged_flash_verify` — a W-query window (speculative verify, W =
  draft length + 1, or a chunk of a long prompt) over committed pool
  history plus the window's own K/V, which are not in the pool yet. A CUDA
  tensor launches ``csrc/paged_verify.cu`` (replacing ``_verify_kernel``):
  bf16 q takes the tensor-core variant, ``paged_verify_mma`` or, for an
  int8 pool, ``paged_verify_int8_mma``; f32 q the FMA variant,
  ``paged_verify`` or ``paged_verify_int8`` (:func:`verify_kernel_for`).
  :func:`verify_plan` sizes the tensor-core launch and splits the history
  over several blocks where the grid would leave SMs idle. A CPU tensor
  runs :func:`paged_flash_verify_reference`.
* :func:`fused_sample` — temperature, top-k, top-p and the categorical draw
  in one kernel (``csrc/fused_sample.cu``, replacing ``_sample_kernel``),
  one thread block cluster per row (:func:`fused_sample_plan`), with the
  same tie rules and the same noise operand as
  :func:`fused_sample_reference`, so the two agree bitwise.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from . import _build
from .attention import _gather_pool, _window_attention, _write_window, paged_attention

__all__ = [
    "decode_kernel_for",
    "decode_plan",
    "paged_flash_decode",
    "paged_flash_verify",
    "paged_flash_verify_reference",
    "verify_kernel_for",
    "verify_plan",
    "fused_sample",
    "fused_sample_plan",
    "fused_sample_reference",
]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_pools(q, k_pool, v_pool, k_scale, v_scale, block_tables, pos):
    """Shape checks shared by decode and verify; returns (n_rep, int8)."""
    _build.refuse_dtensor("paged attention", q, k_pool, v_pool, k_scale, v_scale, block_tables, pos)
    b, _, h, d = q.shape
    nb, bs, h_kv, d_pool = k_pool.shape
    if v_pool.shape != k_pool.shape or d_pool != d:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/{tuple(v_pool.shape)} do not match q {tuple(q.shape)}")
    if h % h_kv != 0:
        raise ValueError(f"num heads {h} not divisible by kv heads {h_kv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(
            f"block_tables must be (B, blocks_per_row) and pos (B,), got "
            f"{tuple(block_tables.shape)} and {tuple(pos.shape)}"
        )
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together (an int8 pool has both)")
    quantized = k_scale is not None
    if quantized and (k_scale.shape != (nb, bs) or v_scale.shape != (nb, bs)):
        raise ValueError(f"scales must be (num_blocks, block_size) = {(nb, bs)}, got "
                         f"{tuple(k_scale.shape)} and {tuple(v_scale.shape)}")
    return h // h_kv, quantized


def _check_kernel_operands(name, kernel, q, k_pool, v_pool, scales, others, n_rep, softcap):
    """What the CUDA kernels take; raises on anything else (never falls
    back to the plain version). ``others`` ends with the tables and pos;
    a tensor-core ``kernel`` (``*_mma``) copies q, the pools and the
    operands before the tables in 16-byte pieces, so they must be 16-byte
    aligned."""
    tensors = (q, k_pool, v_pool, *scales, *others)
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device")
    if others[-2].dtype != torch.int32 or others[-1].dtype != torch.int32:
        raise TypeError("block_tables and pos must be int32")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name} kernel takes float32 or bfloat16 q, got {q.dtype}")
    if scales:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError(f"{name} kernel with scales takes int8 pools, got {k_pool.dtype}, {v_pool.dtype}")
        if any(s.dtype != torch.float32 for s in scales):
            raise TypeError(f"{name} kernel takes float32 scales")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(
            f"{name} kernel takes q and pools of one dtype (or int8 pools with "
            f"scales), got {q.dtype}, {k_pool.dtype}, {v_pool.dtype}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous operands")
    d = q.shape[-1]
    if d not in (64, 128):
        raise ValueError(f"{name} kernel supports head_dim 64 or 128, got {d}")
    if n_rep not in (1, 2, 4, 8):
        raise ValueError(f"{name} kernel supports GQA groups of 1, 2, 4 or 8, got {n_rep}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap must be > 0, got {softcap}")
    copied = (q, k_pool, v_pool, *others[:-2])
    if kernel.endswith("_mma") and any(t.data_ptr() % 16 for t in copied):
        raise ValueError(f"the tensor-core {name} kernel takes 16-byte aligned q, pools and window")
    if q.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors; got {q.device}")


def paged_flash_decode(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Single-token paged decode attention. ``q`` (B, 1, H, D), pools
    (num_blocks, block_size, H_kv, D) in q's dtype, or int8 with
    ``k_scale``/``v_scale`` (num_blocks, block_size) f32; ``block_tables``
    (B, blocks_per_row) int32, ``pos`` (B,) int32. Returns (B, 1, H, D) in
    q's dtype. ``scale`` defaults to ``1/sqrt(D)``. Sliding windows are not
    supported (the engine refuses such configs)."""
    b, sq, h, d = q.shape
    if sq != 1:
        raise ValueError(f"paged_flash_decode takes one query token, got {sq}")
    n_rep, quantized = _check_pools(q, k_pool, v_pool, k_scale, v_scale, block_tables, pos)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_attention(q, k_pool, v_pool, block_tables, pos, k_scale=k_scale,
                               v_scale=v_scale, scale=scale, softcap=softcap).to(q.dtype)
    scales = (k_scale, v_scale) if quantized else ()
    name = decode_kernel_for(q.dtype, k_pool.dtype)
    _check_kernel_operands("paged decode", name, q, k_pool, v_pool, scales, (block_tables, pos),
                           n_rep, softcap)
    out = torch.empty_like(q)
    h_kv, bs, bpr = k_pool.shape[2], k_pool.shape[1], block_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name.endswith("_mma"):
        plan = decode_plan(b, h, h_kv, bs * bpr)
        work, tickets = _split_scratch(q.device, b * h_kv, plan.splits, plan.rows, d)
        ptrs = [q, k_pool, v_pool, *scales, block_tables, pos, out, work, tickets]
        dims = (b, h, h_kv, d, bs, bpr, plan.key_tile, plan.splits)
    else:
        ptrs = [q, k_pool, v_pool, *scales, block_tables, pos, out]
        dims = (b, h, h_kv, d, bs, bpr, _DTYPE_CODE[q.dtype])
    code = _build.entry(name, len(ptrs), len(dims), 2)(
        *(None if t is None else t.data_ptr() for t in ptrs), *dims, float(scale),
        float(softcap or 0.0), stream,
    )
    _build.check(name, code)
    _build.count_launch(name)
    return out


def paged_flash_verify_reference(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    win_k: torch.Tensor,
    win_v: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of the verify kernel: gather each row's history from
    the pool (dequantized in f32 for an int8 pool), write the window's K/V
    into that copy at ``pos .. pos+W-1`` (positions past the row are
    dropped), and attend with the :func:`~accelerate_tpu_torch.ops
    .attention.verify_attention` mask ``k_pos <= pos + q_idx``. Returns (B,
    W, H, D) in q's dtype."""
    # the gather is a copy: the window is written there, not into the pool
    k = _write_window(_gather_pool(k_pool, block_tables, k_scale), win_k, pos)
    v = _write_window(_gather_pool(v_pool, block_tables, v_scale), win_v, pos)
    return _window_attention(q, k, v, pos, scale, softcap).to(q.dtype)


def _kernel_for(stem: str, q_dtype: torch.dtype, pool_dtype: torch.dtype) -> str:
    """bf16 q on the tensor cores (``*_mma``), f32 q on the FMA kernels
    (f32 inputs keep f32 products); an int8 pool takes the ``*_int8*``
    entry point. Raises ``TypeError`` for any other pair."""
    int8 = "_int8" if pool_dtype == torch.int8 else ""
    if q_dtype == torch.bfloat16 and pool_dtype in (torch.bfloat16, torch.int8):
        return f"{stem}{int8}_mma"
    if q_dtype == torch.float32 and pool_dtype in (torch.float32, torch.int8):
        return f"{stem}{int8}"
    raise TypeError(f"the {stem.replace('_', ' ')} kernels take f32 or bf16 q over a pool of q's "
                    f"dtype or int8, got q {q_dtype} and pool {pool_dtype}")


def decode_kernel_for(q_dtype: torch.dtype, pool_dtype: torch.dtype) -> str:
    """The decode kernel that serves ``q_dtype`` over a pool of
    ``pool_dtype``: ``paged_decode_mma`` / ``paged_decode_int8_mma`` (bf16
    q), ``paged_decode`` / ``paged_decode_int8`` (f32 q)."""
    return _kernel_for("paged_decode", q_dtype, pool_dtype)


def verify_kernel_for(q_dtype: torch.dtype, pool_dtype: torch.dtype) -> str:
    """The verify kernel that serves ``q_dtype`` over a pool of
    ``pool_dtype``: ``paged_verify_mma`` / ``paged_verify_int8_mma`` (bf16
    q), ``paged_verify`` / ``paged_verify_int8`` (f32 q)."""
    return _kernel_for("paged_verify", q_dtype, pool_dtype)


def _splits(groups: int, max_hist: int, key_tile: int) -> int:
    """History splits per group of a split launch: where ``groups`` blocks
    fall short of the SMs, enough to reach ``FILL_BLOCKS``, never into
    ranges of less than one key tile of the ``max_hist`` positions a row
    can hold. It depends on shapes only, so a CUDA graph can capture the
    launch; each block finds its own share of its row's live range on the
    device."""
    if groups >= _build.SMS:
        return 1
    return max(1, min(-(-_build.FILL_BLOCKS // groups), -(-max_hist // key_tile)))


class DecodePlan(NamedTuple):
    """Launch shape of the tensor-core decode kernel: query rows per
    (slot, kv head) group (its n_rep), keys per tile, history splits."""

    rows: int
    key_tile: int
    splits: int


# keys per tile of the tensor-core decode kernel: its 4 warps take 16 each
# (csrc/paged_decode.cu DCfg; the kernel refuses any other)
DECODE_KEY_TILE = 64


def decode_plan(b: int, h: int, h_kv: int, max_hist: int) -> DecodePlan:
    """One block per (slot, kv head) group and history split: 8 slots x 8
    kv heads (64 groups) take 5 splits, 320 blocks; a grid of ``SMS``
    groups or more is not split."""
    return DecodePlan(h // h_kv, DECODE_KEY_TILE, _splits(b * h_kv, max_hist, DECODE_KEY_TILE))


class VerifyPlan(NamedTuple):
    """Launch shape of the tensor-core verify kernel: query rows and keys
    per block tile, row tiles per (slot, kv head), and history splits."""

    block_rows: int
    key_tile: int
    row_tiles: int
    splits: int


def verify_plan(b: int, w: int, h: int, h_kv: int, max_hist: int) -> VerifyPlan:
    """Rows: R = n_rep * W per (slot, kv head); R <= 32 (the spec shape, 20)
    takes 32-row blocks with 32-key tiles, larger R 64-row blocks with
    64-key tiles (this is the one place that pairs them: the kernel takes
    both and refuses a pair it was not built for). Split (:func:`_splits`)
    over the B * Hkv * row-tile groups; the chunk shape (2,048 rows, 256
    blocks) is not split."""
    rows = w * (h // h_kv)
    block_rows, key_tile = (32, 32) if rows <= 32 else (64, 64)
    row_tiles = -(-rows // block_rows)
    splits = _splits(b * h_kv * row_tiles, max_hist, key_tile)
    return VerifyPlan(block_rows, key_tile, row_tiles, splits)


# per device: the int32 tickets of the split launches' last-block combine
# (decode and verify), one per group, all zero between launches (the last
# block of each group resets its own). A plan splits only grids of fewer
# than SMS groups, so SMS tickets always suffice and the tensor is never
# replaced (a captured CUDA graph keeps using it). Decode and verify share
# it: launches on one stream run one after another, each launch's last
# blocks reset their tickets before it ends, and the next launch starts
# only then. So launches that use it run on one stream at a time.
_tickets: Dict[torch.device, torch.Tensor] = {}


def _split_scratch(device: torch.device, groups: int, splits: int, rows: int, d: int):
    """(work, tickets) of a split launch: f32 partials, ``rows`` x (D + 2)
    a group and split padded to a multiple of 4 (16-byte aligned, as
    ``csrc/split_kv.cuh``'s ``part_floats``), and the device's tickets;
    (None, None) unsplit."""
    if splits == 1:
        return None, None
    tickets = _tickets.get(device)
    if tickets is None:
        tickets = _tickets[device] = torch.zeros(_build.SMS, dtype=torch.int32, device=device)
    part = -(-rows * (d + 2) // 4) * 4
    work = torch.empty(groups * splits * part, dtype=torch.float32, device=device)
    return work, tickets


def paged_flash_verify(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    win_k: torch.Tensor,
    win_v: torch.Tensor,
    block_tables: torch.Tensor,
    pos: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """W-query window attention over the paged pool (the verify kernel).
    ``q`` (B, W, H, D) at absolute positions ``pos[b] + q_idx``; committed
    history comes from the pool (int8 with ``k_scale``/``v_scale``), masked
    strictly ``k_pos < pos``; the window's own K/V, ``win_k``/``win_v`` (B,
    W, H_kv, D) in q's dtype and not yet committed, are attended causally
    (``k_idx <= q_idx``). Together that is ``verify_attention``'s ``k_pos
    <= pos + q_idx``. Returns (B, W, H, D) in q's dtype."""
    b, w, h, d = q.shape
    n_rep, quantized = _check_pools(q, k_pool, v_pool, k_scale, v_scale, block_tables, pos)
    if win_k.shape != (b, w, k_pool.shape[2], d) or win_v.shape != win_k.shape:
        raise ValueError(f"win_k/win_v must be (B, W, H_kv, D) = {(b, w, k_pool.shape[2], d)}, "
                         f"got {tuple(win_k.shape)} and {tuple(win_v.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return paged_flash_verify_reference(q, k_pool, v_pool, win_k, win_v, block_tables, pos,
                                            k_scale=k_scale, v_scale=v_scale, scale=scale,
                                            softcap=softcap)
    if win_k.dtype != q.dtype or win_v.dtype != q.dtype:
        raise TypeError(f"paged verify kernel takes the window K/V in q's dtype {q.dtype}, "
                        f"got {win_k.dtype}, {win_v.dtype}")
    scales = (k_scale, v_scale) if quantized else ()
    name = verify_kernel_for(q.dtype, k_pool.dtype)
    _check_kernel_operands("paged verify", name, q, k_pool, v_pool, scales,
                           (win_k, win_v, block_tables, pos), n_rep, softcap)
    out = torch.empty_like(q)
    h_kv, bs, bpr = k_pool.shape[2], k_pool.shape[1], block_tables.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if name.endswith("_mma"):
        plan = verify_plan(b, w, h, h_kv, bs * bpr)
        work, tickets = _split_scratch(q.device, b * h_kv * plan.row_tiles, plan.splits,
                                       plan.block_rows, d)
        ptrs = [q, k_pool, v_pool, *scales, win_k, win_v, block_tables, pos, out, work, tickets]
        dims = (b, w, h, h_kv, d, bs, bpr, plan.block_rows, plan.key_tile, plan.splits)
    else:
        ptrs = [q, k_pool, v_pool, *scales, win_k, win_v, block_tables, pos, out]
        dims = (b, w, h, h_kv, d, bs, bpr, _DTYPE_CODE[q.dtype])
    code = _build.entry(name, len(ptrs), len(dims), 2)(
        *(None if t is None else t.data_ptr() for t in ptrs), *dims, float(scale),
        float(softcap or 0.0), stream,
    )
    _build.check(name, code)
    _build.count_launch(name)
    return out


def _float_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving map f32 -> uint32 (held in int64, since torch has
    no full uint32 arithmetic): positive floats flip the sign bit, negative
    floats flip every bit."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where((u >> 31) == 1, (~u) & 0xFFFFFFFF, u | 0x80000000)


def fused_sample_reference(
    logits: torch.Tensor,
    noise: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Plain version of the fused sampling kernel, row-vectorised. The
    k-th largest value and the top-p cutoff come from 32-step binary
    searches over the float keys (no sort); the draw is the first argmax of
    ``filtered + noise``; greedy (temperature <= 0) the first argmax of the
    raw logits. Returns (S,) int32."""
    s, v = logits.shape
    x = logits.float()
    t = temperature.float()
    tk = top_k.long()
    tp = top_p.float()
    iota = torch.arange(v, device=x.device)
    neg_inf = torch.tensor(float("-inf"), device=x.device)

    m_raw = x.amax(dim=-1, keepdim=True)
    greedy = torch.where(x == m_raw, iota, v).amin(dim=-1)

    safe_t = torch.where(t > 0, t, torch.ones_like(t))
    scaled = x / safe_t[:, None]
    key = _float_key(scaled)

    k_on = (tk > 0) & (tk < v)
    k_eff = tk.clamp(1, v)
    kkey = torch.zeros(s, dtype=torch.int64, device=x.device)
    for bit in range(31, -1, -1):
        cand = kkey | (1 << bit)
        cnt = (key >= cand[:, None]).sum(dim=-1)
        kkey = torch.where(cnt >= k_eff, cand, kkey)
    kth = torch.where(key == kkey[:, None], scaled, neg_inf).amax(dim=-1)
    keep_k = ~k_on[:, None] | (scaled >= kth[:, None])

    m_s = scaled.amax(dim=-1)
    e = torch.exp(scaled - m_s[:, None])
    gt = scaled > kth[:, None]
    cnt_gt = gt.sum(dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    z_k = torch.where(gt, e, zero).sum(dim=-1) + (k_eff - cnt_gt).float() * torch.exp(kth - m_s)
    z = torch.where(k_on, z_k, e.sum(dim=-1))
    p_on = tp < 1.0
    pz = torch.where(p_on, tp, torch.ones_like(tp)) * z
    u1 = torch.zeros(s, dtype=torch.int64, device=x.device)
    for bit in range(31, -1, -1):
        cand = u1 | (1 << bit)
        s_above = torch.where(key > cand[:, None], e, zero).sum(dim=-1)
        u1 = torch.where(s_above >= pz, cand, u1)
    s_at_u1 = torch.where(key > u1[:, None], e, zero).sum(dim=-1)
    u0 = torch.where(s_at_u1 >= pz, (u1 + 1) & 0xFFFFFFFF, u1)
    keep_p = ~p_on[:, None] | (key >= u0[:, None])

    final = torch.where(keep_k & keep_p, scaled, neg_inf)
    g = final + noise.float()
    m_g = g.amax(dim=-1, keepdim=True)
    sampled = torch.where(g == m_g, iota, v).amin(dim=-1)
    return torch.where(t > 0, sampled, greedy).to(torch.int32)


# the host's copy of fused_sample.cu's geometry, for an early refusal with
# a clear message: its CLUSTER (blocks per row; 16 needs the non-portable
# cluster size, which the H100 allows) and the dynamic shared memory a block
# may use (the H100's 232,448 bytes a block, less the kernel's 30,864 bytes
# of static buffers: the warps' histograms and the cluster's exchange
# slots). The kernel's entry point derives the same and refuses a row that
# does not fit; a card test holds the two limits to each other.
SAMPLE_CLUSTER = 16
SAMPLE_SMEM_LIMIT = 232448 - 30864


class SamplePlan(NamedTuple):
    cluster: int  # blocks per row
    chunk: int  # elements of the row per block
    smem_bytes: int  # dynamic shared memory per block: scaled logits and exp


def fused_sample_plan(v: int) -> SamplePlan:
    """One cluster of ``SAMPLE_CLUSTER`` blocks per row; each block keeps
    its slice of the row twice (x / t and exp(x / t - max), f32) in shared
    memory. Raises ``ValueError`` for a vocabulary whose slices do not fit
    (V above 403,168)."""
    chunk = -(-v // SAMPLE_CLUSTER)
    smem = 2 * 4 * chunk
    if smem > SAMPLE_SMEM_LIMIT:
        raise ValueError(f"fused sample kernel holds at most {SAMPLE_SMEM_LIMIT // 8 * SAMPLE_CLUSTER} "
                         f"logits a row in shared memory, got V = {v}")
    return SamplePlan(SAMPLE_CLUSTER, chunk, smem)


def fused_sample(
    logits: torch.Tensor,
    noise: torch.Tensor,
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """Fused sampling epilogue: ``logits``/``noise`` (S, V) f32,
    ``temperature``/``top_p`` (S,) f32, ``top_k`` (S,) int32 (0 or >= V is
    off; top_p >= 1 is off; temperature <= 0 is greedy). ``noise`` is the
    per-row Gumbel noise, so the draw is ``argmax(filtered + noise)``,
    exactly a categorical sample. Returns (S,) int32 token ids."""
    _build.refuse_dtensor("fused_sample", logits, noise, temperature, top_k, top_p)
    if logits.dim() != 2 or noise.shape != logits.shape:
        raise ValueError(f"logits and noise must be (S, V), got {tuple(logits.shape)} and {tuple(noise.shape)}")
    s, v = logits.shape
    if any(p.shape != (s,) for p in (temperature, top_k, top_p)):
        raise ValueError("temperature, top_k and top_p must be (S,)")
    if logits.device.type == "cpu":
        return fused_sample_reference(logits, noise, temperature, top_k, top_p)
    tensors = (logits, noise, temperature, top_k, top_p)
    if any(t.device != logits.device for t in tensors):
        raise ValueError("fused_sample: all operands must be on one device")
    if (logits.dtype, noise.dtype, temperature.dtype, top_p.dtype, top_k.dtype) != (
        torch.float32, torch.float32, torch.float32, torch.float32, torch.int32
    ):
        raise TypeError("fused sample kernel takes f32 logits/noise/temperature/top_p and int32 top_k")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused sample kernel takes contiguous operands")
    fused_sample_plan(v)
    if logits.device.type != "cuda":
        raise ValueError(f"the fused sample kernel runs on CUDA tensors; got {logits.device}")
    out = torch.empty((s,), dtype=torch.int32, device=logits.device)
    code = _build.entry("fused_sample", 6, 2, 0)(
        logits.data_ptr(), noise.data_ptr(), temperature.data_ptr(), top_k.data_ptr(),
        top_p.data_ptr(), out.data_ptr(), s, v,
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    _build.check("fused_sample", code)
    _build.count_launch("fused_sample")
    return out
