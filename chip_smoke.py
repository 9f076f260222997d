"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels from
this checkout, holds each one against its plain PyTorch version on the
card, and drives the port's two main paths with seeded random weights:
Llama-3-8B continuous-batching serving through ``InferenceServer`` at full
width and depth, and Llama-3-8B training steps through the ``Accelerator``
at full width and 4 layers.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only

Phases (any failure exits non-zero and prints no result):
  1. build the kernels (one nvcc per source, in parallel); print the card
  2. each kernel against its plain version at the main paths' shapes (B1
     also with segment ids; B2/B3 also with segment ids, a ragged S, an lse
     cotangent, softcap and window, non-causal): max abs error against a
     stated tolerance, median kernel / plain / library times and the bound
  3. the engine's kernel path against its reference path at full width and
     2 layers (prefill logits, first decode logits, greedy tokens)
  4. the serving main path: InferenceServer, Llama-3-8B, 32 layers, 16
     requests; launch counters reset just before and read just after
  5. a training step's kernel path against its reference path at full
     width, 2 layers, f32 (loss and every gradient leaf), with a planted
     fault that must exceed the limit
  6. the training main path: Accelerator(mixed_precision="bf16"), prepare,
     prepare_data_loader and train_step(llama_loss, max_grad_norm=1.0) on
     Llama-3-8B at 4 layers, batch 4 x 2048; 2 warm-up and 8 timed steps
     with the launch counters reset just before; tokens/s, step time, MFU,
     peak memory and a profile of one step
The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Long output goes to chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

B1_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
B4_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events (after warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ----------------------------------------------------------------- phase 2
def segments(bounds_per_row, s, dev):
    """(B, S) int32 packed-sequence labels from each row's document starts."""
    rows = []
    for bounds in bounds_per_row:
        starts = torch.tensor(bounds[1:], device=dev)
        rows.append(torch.bucketize(torch.arange(s, device=dev), starts, right=True))
    return torch.stack(rows).to(torch.int32)


def check_flash(dev, gen, results):
    from accelerate_tpu_torch.ops.flash_attention import (
        flash_attention_reference, flash_attention_with_lse,
    )

    h, h_kv, d = 32, 8, 128
    # serving's prefill shape, then the training step's shape (in the line)
    for b, s in ((1, 512), (4, 2048)):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
            out, lse = flash_attention_with_lse(q, k, v, causal=True)
            ref, ref_lse = flash_attention_reference(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            tol = B1_TOL[dtype]
            log(f"B1 flash_fwd {dtype} (B={b}, S={s}, H={h}, Hkv={h_kv}, D={d}) "
                f"max_abs_err={err:.3e} tol={tol:g}")
            if not err <= tol:
                raise AssertionError(f"flash_fwd {dtype} disagrees with its plain version")
            del out, lse, ref, ref_lse
            iters = 20 if s <= 512 else 5
            ms = time_ms(lambda: flash_attention_with_lse(q, k, v, causal=True), iters=iters)
            plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, causal=True),
                               iters=5 if s <= 512 else 2, repeats=3)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), iters=iters)
            item = dtype.itemsize
            nbytes = 2 * b * s * h * d * item + 2 * b * s * h_kv * d * item + b * h * s * 4
            flops = 4.0 * b * h * d * s * (s + 1) / 2  # visible causal pairs
            bms, by = bound_ms(nbytes, flops, dtype)
            log(f"  ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
                f"bound_ms={bms:.5f} ({by})")
            if dtype == torch.bfloat16 and s == 2048:  # the training step's shape
                results["flash_fwd"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, library_ms=lib_ms,
                )
            del q, k, v, qt, kt, vt
    # packed sequences: document boundaries off the 64-row tiles
    b, s, h, h_kv = 2, 1024, 8, 2
    seg = segments([(0, 300, 777), (0, 100, 613, 1000)], s, dev)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
        out, lse = flash_attention_with_lse(q, k, v, causal=True, segment_ids=seg)
        ref, ref_lse = flash_attention_reference(q, k, v, causal=True, segment_ids=seg)
        torch.cuda.synchronize()
        err = max((out.float() - ref.float()).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        log(f"B1 flash_fwd {dtype} segment ids (B={b}, S={s}, documents at 0/300/777 and "
            f"0/100/613/1000) max_abs_err={err:.3e} tol={B1_TOL[dtype]:g}")
        if not err <= B1_TOL[dtype]:
            raise AssertionError(f"flash_fwd {dtype} with segment ids disagrees with its plain version")
        results["flash_fwd"].setdefault("segment_ids_max_abs_err", {})[str(dtype)] = err


# B2/B3: max abs error over the largest |gradient| of the plain version. f32
# sums the same products in another order; bf16 also rounds p and ds to bf16
# before the products (as the plain version does), and an ulp flip of those
# roundings where the two f32 sums straddle a bf16 boundary moves a gradient
# by up to one bf16 ulp of its largest terms (2^-8 relative)
BWD_TOL_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

# name -> (B, S, H, Hkv, D, options): the training step's shape, then packed
# documents off the tile grid, a ragged S with an lse cotangent, softcap with
# a window, and the non-causal form
BWD_CASES = {
    "main": (4, 2048, 32, 8, 128, {}),
    "segments": (2, 1024, 8, 2, 128, dict(segments=[(0, 300, 777), (0, 100, 613, 1000)])),
    "ragged_dlse": (2, 1000, 8, 2, 64, dict(dlse=True)),
    "softcap_window": (2, 512, 8, 2, 128, dict(softcap=30.0, window=200)),
    "noncausal": (1, 333, 4, 4, 64, dict(causal=False)),
}


def check_flash_bwd(dev, gen, results):
    from accelerate_tpu_torch.ops.flash_attention import (
        _delta, _launch_bwd_dkv, _launch_bwd_dq, flash_attention_bwd_reference,
        flash_attention_reference,
    )

    for name, (b, s, h, h_kv, d, opt) in BWD_CASES.items():
        causal, window, softcap = opt.get("causal", True), opt.get("window"), opt.get("softcap")
        seg = segments(opt["segments"], s, dev) if "segments" in opt else None
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
            do = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            dlse = (torch.randn((b, h, s), generator=gen, device=dev)
                    if opt.get("dlse") else None)
            mask = dict(causal=causal, window=window, softcap=softcap, segment_ids=seg)
            out, lse = flash_attention_reference(q, k, v, **mask)
            delta = _delta(out, do, dlse)
            args = (q, k, v, do, lse, delta, seg, seg, causal, window, softcap)
            got = (_launch_bwd_dq(*args), *_launch_bwd_dkv(*args))
            ref = flash_attention_bwd_reference(q, k, v, out, lse, do, dlse=dlse, **mask)
            torch.cuda.synchronize()
            errs, rels = {}, {}
            for grad, g, r in zip(("dq", "dk", "dv"), got, ref):
                errs[grad] = (g.float() - r.float()).abs().max().item()
                big = r.float().abs().max().item()
                rels[grad] = errs[grad] / big
                log(f"B2/B3 flash_bwd {name} {dtype} (B={b}, S={s}, H={h}, Hkv={h_kv}, D={d}, "
                    f"{opt or 'causal'}) {grad}: max_abs_err={errs[grad]:.3e} max |{grad}|={big:.3e} "
                    f"ratio={rels[grad]:.3e} tol {BWD_TOL_REL[dtype]:g}")
                if not rels[grad] <= BWD_TOL_REL[dtype]:
                    raise AssertionError(f"flash backward {name} {dtype}: {grad} disagrees with "
                                         "its plain version")
            del got, ref
            if name == "main":
                time_flash_bwd(dtype, args, out, dlse, mask, errs, rels, results)
            del q, k, v, do, out, lse, delta, args
            torch.cuda.empty_cache()


def time_flash_bwd(dtype, args, out, dlse, mask, errs, rels, results):
    from accelerate_tpu_torch.ops.flash_attention import (
        _launch_bwd_dkv, _launch_bwd_dq, flash_attention_bwd_reference,
    )

    q, k, v, do, lse = args[:5]
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    dq_ms = time_ms(lambda: _launch_bwd_dq(*args), iters=5)
    dkv_ms = time_ms(lambda: _launch_bwd_dkv(*args), iters=5)
    plain_ms = time_ms(lambda: flash_attention_bwd_reference(
        q, k, v, out, lse, do, dlse=dlse, **mask), iters=2, repeats=3)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    with torch.enable_grad():
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = do.transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True),
                         iters=5)
    del o
    item = dtype.itemsize
    n_q, n_kv, n_row = b * s * h * d * item, b * s * h_kv * d * item, b * h * s * 4
    pairs = b * h * s * (s + 1) / 2
    dq_bound = bound_ms(3 * n_q + 2 * n_kv + 2 * n_row, 6.0 * d * pairs, dtype)
    dkv_bound = bound_ms(2 * n_q + 4 * n_kv + 2 * n_row, 8.0 * d * pairs, dtype)
    log(f"  dq ms={dq_ms:.4f} bound_ms={dq_bound[0]:.5f} ({dq_bound[1]}); dk/dv ms={dkv_ms:.4f} "
        f"bound_ms={dkv_bound[0]:.5f} ({dkv_bound[1]}); plain backward (dq, dk, dv) "
        f"ms={plain_ms:.4f}; SDPA backward ms={lib_ms:.4f}")
    if dtype == torch.bfloat16:
        # max_rel_err: max abs error / max |gradient|, what BWD_TOL_REL limits
        results["flash_bwd_dq"] = dict(
            max_abs_err=errs["dq"], max_rel_err=rels["dq"], ms=dq_ms, plain_ms=plain_ms,
            bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=lib_ms)
        results["flash_bwd_dkv"] = dict(
            max_abs_err=max(errs["dk"], errs["dv"]), max_rel_err=max(rels["dk"], rels["dv"]),
            ms=dkv_ms, plain_ms=plain_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
            library_ms=lib_ms)


def check_paged_decode(dev, gen, results):
    from accelerate_tpu_torch.ops.attention import paged_attention
    from accelerate_tpu_torch.ops.paged_decode import paged_flash_decode

    slots, h, h_kv, d, bs, bpr = 8, 32, 8, 128, 16, 64
    nb = slots * bpr + 1
    # fresh slot, exactly-full first block, one past it, mid, exactly-full
    # last block of the row, main-path-like positions
    pos_list = [0, 15, 16, 575, 576, bpr * bs - 1, 300, 47]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    perm = torch.randperm(nb - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = torch.zeros((slots, bpr), dtype=torch.int32, device=dev)
    for i, p in enumerate(pos_list):
        n = p // bs + 1
        tables[i, :n] = perm[i * bpr: i * bpr + n]
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn((slots, 1, h, d), generator=gen, device=dev).to(dtype)
        kp = torch.randn((nb, bs, h_kv, d), generator=gen, device=dev).to(dtype)
        vp = torch.randn((nb, bs, h_kv, d), generator=gen, device=dev).to(dtype)
        out = paged_flash_decode(q, kp, vp, tables, pos)
        ref = paged_attention(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = B4_TOL[dtype]
        log(f"B4 paged_decode {dtype} (slots={slots}, bs={bs}, pos={pos_list}) "
            f"max_abs_err={err:.3e} tol={tol:g}")
        if not err <= tol:
            raise AssertionError(f"paged_decode {dtype} disagrees with its plain version")
        if dtype != torch.bfloat16:
            continue
        ms = time_ms(lambda: paged_flash_decode(q, kp, vp, tables, pos))
        plain_ms = time_ms(lambda: paged_attention(q, kp, vp, tables, pos))
        live = sum(p + 1 for p in pos_list)
        item = dtype.itemsize
        nbytes = (2 * live * h_kv * d * item + 2 * slots * h * d * item
                  + tables.numel() * 4 + slots * 4)
        flops = 4.0 * live * h * d
        bms, by = bound_ms(nbytes, flops, dtype)
        log(f"  ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by})")
        results["paged_decode"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, library_ms=None,
        )


def check_fused_sample(dev, gen, results):
    from accelerate_tpu_torch.ops.paged_decode import fused_sample, fused_sample_reference

    s, v = 8, 128256
    logits = torch.randn((s, v), generator=gen, device=dev) * 3.0
    logits[6] = torch.round(logits[6])  # heavy ties: first-index and Z rules
    logits[7] = torch.round(logits[7] * 2) / 2
    u = torch.rand((s, v), generator=gen, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
    noise = -torch.log(-torch.log(u))
    # greedy, top-k, top-p, combined, and each again at other settings
    temp = torch.tensor([0.0, 0.8, 0.8, 0.8, 1.0, 0.0, 0.7, 1.3], device=dev)
    top_k = torch.tensor([0, 50, 0, 50, 1, 50, 40, 100], dtype=torch.int32, device=dev)
    top_p = torch.tensor([1.0, 1.0, 0.9, 0.9, 0.5, 0.9, 0.95, 0.8], device=dev)
    out = fused_sample(logits, noise, temp, top_k, top_p)
    ref = fused_sample_reference(logits, noise, temp, top_k, top_p)
    torch.cuda.synchronize()
    mismatches = int((out != ref).sum().item())
    log(f"B6 fused_sample (S={s}, V={v}) tokens={out.tolist()} ref={ref.tolist()} "
        f"mismatches={mismatches} (tolerance: exact)")
    if mismatches:
        raise AssertionError("fused_sample disagrees with its plain version")
    sweep_mismatches = check_fused_sample_sweep(dev, gen, v)
    ms = time_ms(lambda: fused_sample(logits, noise, temp, top_k, top_p))
    plain_ms = time_ms(lambda: fused_sample_reference(logits, noise, temp, top_k, top_p), iters=3)
    # the function must read logits and noise once and write one token per
    # row; its least work is a scale, an exp, a noise add and a compare per
    # element, far below the bytes' time
    nbytes = 2 * s * v * 4 + s * 16
    flops = 4.0 * s * v
    bms, by = bound_ms(nbytes, flops, torch.float32)
    log(f"  ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by})")
    results["fused_sample"] = dict(
        max_abs_err=float(mismatches + sweep_mismatches), ms=ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None,
    )


# rows of the wider B6 check: the kernel's block-tree sums (Z and the mass
# above each top-p candidate) add in another order than torch's .sum, so
# the two agree bitwise only while no row's cutoff falls within rounding of
# p * Z; this many seeded rows put that to the test
B6_SWEEP_ROWS = 512


def check_fused_sample_sweep(dev, gen, v) -> int:
    from accelerate_tpu_torch.ops.paged_decode import fused_sample, fused_sample_reference

    n = B6_SWEEP_ROWS
    logits = torch.randn((n, v), generator=gen, device=dev) * 3.0
    u = torch.rand((n, v), generator=gen, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
    noise = -torch.log(-torch.log(u))
    # a quarter each: top-p only, top-k only, both, and greedy-or-both
    r = torch.rand((4, n), generator=gen, device=dev)
    temp = 0.3 + 1.2 * r[0]
    top_p = 0.5 + 0.5 * r[1]
    top_k = (1 + 200 * r[2]).to(torch.int32)
    q = torch.arange(n, device=dev) % 4
    top_k = torch.where(q == 0, torch.zeros_like(top_k), top_k)
    top_p = torch.where(q == 1, torch.ones_like(top_p), top_p)
    temp = torch.where((q == 3) & (r[3] < 0.5), torch.zeros_like(temp), temp)
    out = fused_sample(logits, noise, temp, top_k, top_p)
    ref = fused_sample_reference(logits, noise, temp, top_k, top_p)
    torch.cuda.synchronize()
    mismatches = int((out != ref).sum().item())
    log(f"B6 fused_sample sweep ({n} seeded rows: top-p only, top-k only, both, greedy) "
        f"mismatches={mismatches} (tolerance: exact)")
    if mismatches:
        raise AssertionError(f"fused_sample disagrees with its plain version on {mismatches} rows")
    return mismatches


# ----------------------------------------------------------------- phase 3
# bf16 model with logits of order 1: the kernel path keeps attention
# probabilities in f32 where the reference rounds them to bf16 before P.V,
# and both round activations to bf16 (2^-8 relative) at every layer, so
# two layers and the LM head differ by a few bf16 ulps of the logits
# (about 0.05 measured); the limit is twice that, and phase 3 shows that a
# planted block-table fault in the kernel path exceeds it
LOGIT_TOL = 0.1
# teacher-forced greedy check: the kernel engine's token must be the
# reference forward's argmax at this share of positions, and within
# LOGIT_TOL of it (a near-tie) at every other position
GREEDY_SHARE_MIN = 0.9


def phase_engine_parity(dev, card):
    import dataclasses

    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.kvcache import PagedKVLayout
    from accelerate_tpu_torch.models.llama import (
        LlamaConfig, LlamaForCausalLM, llama_apply, llama_decode_step, llama_prefill_at,
    )

    cfg_k = LlamaConfig.llama3_8b(num_hidden_layers=2, param_dtype=torch.bfloat16,
                                  compute_dtype=torch.bfloat16, attention_impl="flash")
    cfg_r = dataclasses.replace(cfg_k, attention_impl="xla")
    model = LlamaForCausalLM.from_seed(cfg_k, seed=1, device=dev)
    params = model.params
    rng = np.random.default_rng(1)
    lens = (64, 200, 333, 512, 90, 150, 401, 275)
    prompts = [rng.integers(0, cfg_k.vocab_size, size=n).astype(np.int32) for n in lens]

    errs = []
    for p in prompts[:3]:
        ids = np.zeros((1, 512), np.int64)
        ids[0, :len(p)] = p
        ids_t = torch.from_numpy(ids).to(dev)
        lk, _ = llama_prefill_at(cfg_k, params, ids_t, 1024, [len(p) - 1])
        lr, _ = llama_prefill_at(cfg_r, params, ids_t, 1024, [len(p) - 1])
        errs.append((lk - lr).abs().max().item())
    log(f"phase 3 prefill logits (2 layers, full width, bf16), flash kernel vs plain "
        f"attention: max_abs_err={max(errs):.4f} tol={LOGIT_TOL} (logit std {lr.std().item():.3f})")
    if not max(errs) <= LOGIT_TOL:
        raise AssertionError("prefill logits: kernel path disagrees with reference path")

    eng = ContinuousBatchingEngine(model, slots=8, max_len=1024, prompt_bucket=512,
                                   kv_cache="paged", block_size=16, readback_lag=0,
                                   attention_impl="kernel", device=dev)
    occs = [eng.insert(p, max_new_tokens=32) for p in prompts]
    # the first decode step's logits through each attention path, from the
    # same pool and tokens (copies of the engine's, after the prefills)
    tables = eng._backend.device_tables()
    pos_list = eng._pos.tolist()

    def first_logits(impl, tabs=tables, edit=None):
        layout = PagedKVLayout(tabs, 16, cfg_k.compute_dtype, attention_impl=impl)
        cache = {w: t.clone() for w, t in eng._cache.items()}
        if edit is not None:
            edit(cache)
        logits, _ = llama_decode_step(
            cfg_k, params, cache, eng._carried["token"][:, None].long(), eng._pos, kv_layout=layout)
        return logits

    def swap_last_two_keys(cache):
        for i, p in enumerate(pos_list):
            (ba, oa), (bb, ob) = ((int(tables[i, c // 16]), c % 16) for c in (p - 1, p - 2))
            ka = cache["k"][:, ba, oa].clone()
            cache["k"][:, ba, oa] = cache["k"][:, bb, ob]
            cache["k"][:, bb, ob] = ka

    ref = first_logits("reference")
    derr = (first_logits("kernel") - ref).abs().max().item()
    log(f"phase 3 first decode-step logits, paged kernel vs plain paged attention: "
        f"max_abs_err={derr:.4f} tol={LOGIT_TOL}")
    if not derr <= LOGIT_TOL:
        raise AssertionError("decode logits: kernel path disagrees with reference path")
    # planted faults in the kernel path (copies of the pool and tables):
    # each row's first block read from its second, and the keys of each
    # row's last two prompt positions swapped
    bad_tables = tables.clone()
    bad_tables[:, 0] = tables[:, 1]
    block_err = (first_logits("kernel", tabs=bad_tables) - ref).abs().max().item()
    column_err = (first_logits("kernel", edit=swap_last_two_keys) - ref).abs().max().item()
    log(f"phase 3 planted faults, kernel path vs plain: misplaced block max_abs_err="
        f"{block_err:.4f}, two keys swapped max_abs_err={column_err:.4f} (tol {LOGIT_TOL}; "
        f"the misplaced block must exceed it)")
    if not block_err > LOGIT_TOL:
        raise AssertionError("phase 3's logit tolerance cannot see a misplaced KV block")
    eng.drain()

    agree = total = 0
    worst_gap = 0.0
    for p, occ in zip(prompts, occs):
        toks = torch.tensor(occ.tokens, device=dev)
        seq = torch.cat([torch.from_numpy(p).to(dev).long(), toks[:-1].long()])[None]
        ref = llama_apply(cfg_r, params, seq)[0, len(p) - 1:]  # logits that chose each token
        chosen = ref.gather(1, toks.long()[:, None])[:, 0]
        agree += int((ref.argmax(-1) == toks).sum().item())
        total += len(occ.tokens)
        worst_gap = max(worst_gap, (ref.max(-1).values - chosen).max().item())
    share = agree / total
    log(f"phase 3 greedy tokens (kernel engine, teacher-forced reference forward): "
        f"{agree}/{total} positions are the reference argmax (share {share:.3f}, min "
        f"{GREEDY_SHARE_MIN}); largest logit gap at the rest {worst_gap:.4f} (tol {LOGIT_TOL})")
    if not (share >= GREEDY_SHARE_MIN and worst_gap <= LOGIT_TOL):
        raise AssertionError("greedy tokens: kernel path disagrees with reference path")
    del eng, model, params
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 4
def phase_main_path(dev, card, n_layers):
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, llama_prefill_at
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=n_layers, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16, attention_impl="flash")
    t0 = time.perf_counter()
    model = LlamaForCausalLM.from_seed(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"phase 4 model: Llama-3-8B, {n_layers} layers, bf16, seeded random weights, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B params, "
        f"init {time.perf_counter() - t0:.1f}s")
    scfg = ServingConfig(
        engine_slots=8, engine_max_len=1024, engine_prompt_bucket=512, engine_block_size=16,
        kv_cache="paged", attention_impl="kernel", engine_readback_lag=2,
    )
    rng = np.random.default_rng(0)
    n_req, new_tokens = 16, 64
    lens = rng.integers(64, 513, size=n_req)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in lens]
    with InferenceServer(model, scfg, device=dev) as srv:
        srv.submit(prompts[0][:64], max_new_tokens=4).result(timeout=300)  # warm-up
        eng = srv.engine
        steps0 = eng.steps
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            sampled = i % 2 == 1
            futs.append(srv.submit(
                p, max_new_tokens=new_tokens, temperature=0.8 if sampled else 0.0,
                top_k=50 if sampled else None, top_p=0.9 if sampled else None, seed=i))
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()
        steps = eng.steps - steps0
    for p, r in zip(prompts, results):
        new = r.tokens[len(p):]
        if r.tokens.shape != (len(p) + new_tokens,) or not (r.tokens[: len(p)] == p).all():
            raise AssertionError("a result row has the wrong shape or prompt")
        if not ((new >= 0) & (new < cfg.vocab_size)).all():
            raise AssertionError("a generated token is out of the vocabulary")
    expected = {
        "flash_fwd": n_layers * n_req,
        "paged_decode": n_layers * steps,
        "fused_sample": steps + n_req,
    }
    log(f"phase 4 launches during the main path: {launches}; expected {expected}; "
        f"decode steps {steps}")
    for name, n in expected.items():
        if launches[name] <= 0 or launches[name] != n:
            raise AssertionError(f"kernel {name}: {launches[name]} launches on the main path, expected {n}")
    ttft = sorted(r.ttft_s for r in results)
    gen_tokens = n_req * new_tokens
    log(f"phase 4 served {n_req} requests (prompts {int(lens.min())}-{int(lens.max())}, "
        f"{new_tokens} new tokens each, half sampled) in {wall:.3f}s: "
        f"{gen_tokens / wall:.1f} generated tokens/s; TTFT min {ttft[0]:.4f}s "
        f"p50 {ttft[len(ttft) // 2]:.4f}s max {ttft[-1]:.4f}s [{card}]")

    # steady-state decode and prefill times on the same engine (after the run)
    eng.reset()
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts[:8]:
            eng.insert(p[:300], max_new_tokens=200)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 8 * 1e3
        for _ in range(4):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_steps = 32
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n_steps * 1e3
        profile = profile_decode(eng, step_ms, card)
        eng.reset()
        ids = torch.from_numpy(prompts[0][None].astype(np.int64)).to(dev)
        logits, _ = llama_prefill_at(cfg, model.params, ids, 1024, [ids.shape[1] - 1])
        finite = bool(torch.isfinite(logits).all().item())
    log(f"phase 4 decode {step_ms:.3f} ms/step (8 slots at pos 300-340), prefill "
        f"{prefill_ms:.3f} ms/request (bucket 512) [{card}]")
    if not finite:
        raise AssertionError("full-depth prefill logits are not finite")
    return {k: launches[k] for k in expected}, dict(tokens_per_s=gen_tokens / wall, ttft_min_s=ttft[0],
                          ttft_p50_s=ttft[len(ttft) // 2],
                          ttft_max_s=ttft[-1], decode_ms_per_step=step_ms,
                          prefill_ms=prefill_ms, wall_s=wall, decode_steps=steps,
                          decode_profile=profile)


def profile_decode(eng, step_ms, card, n_steps=8):
    """Device time per decode step by kernel group, from torch.profiler
    over ``n_steps`` steps; the busy share divides it by the unprofiled
    ``step_ms``. The full table goes to chiprun_out/profile_decode.txt."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    groups = {"paged_decode": 0.0, "fused_sample": 0.0, "flash_fwd": 0.0, "matmul": 0.0, "other": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        name = e.key.lower()
        for g in ("paged_decode", "fused_sample", "flash_fwd"):
            if g in name:
                groups[g] += us
                break
        else:
            matmul = any(t in name for t in ("gemm", "gemv", "cutlass", "sm90_", "cublas", "nvjet"))
            groups["matmul" if matmul else "other"] += us
    per_step = {g: us / n_steps / 1e3 for g, us in groups.items()}
    device_ms = sum(per_step.values())
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/profile_decode.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    if device_ms == 0.0:
        log("phase 4 profile: the profiler recorded no device time (not measured)")
        return None
    log(f"phase 4 decode profile: device time {device_ms:.3f} ms/step of {step_ms:.3f} ms wall "
        f"(busy share {device_ms / step_ms:.3f}); by group ms/step "
        + ", ".join(f"{g}={v:.3f}" for g, v in per_step.items()) + f" [{card}]")
    return dict(device_ms_per_step=device_ms, busy_share=device_ms / step_ms, groups_ms=per_step)


# ----------------------------------------------------------------- phase 5
# f32 weights and compute on both paths: only attention differs (the flash
# kernels' tiled f32 FMA sums against the materialised reference and its
# autograd softmax backward), so the loss agrees to f32 rounding through two
# layers and the head, and each gradient leaf to well under 1e-3 of its
# largest entry; a planted fault (each kv head's dk taken from its
# neighbour) must exceed the leaf limit
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_RTOL = 1e-3


def phase_train_parity(dev, card):
    import dataclasses

    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, llama_loss
    from accelerate_tpu_torch.ops import flash_attention as fa

    cfg_k = LlamaConfig.llama3_8b(num_hidden_layers=2, param_dtype=torch.float32,
                                  compute_dtype=torch.float32, attention_impl="flash")
    cfg_r = dataclasses.replace(cfg_k, attention_impl="xla")
    model = LlamaForCausalLM.from_seed(cfg_k, seed=2, device=dev)
    ids = np.random.default_rng(2).integers(0, cfg_k.vocab_size, size=(2, 512)).astype(np.int32)
    batch = {"input_ids": torch.from_numpy(ids).to(dev)}

    def loss_and_grads(cfg):
        model.config = cfg
        model.zero_grad(set_to_none=True)
        loss = llama_loss(model, batch)
        loss.backward()
        grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()}
        return loss.item(), grads

    loss_k, grads_k = loss_and_grads(cfg_k)
    loss_r, grads_r = loss_and_grads(cfg_r)

    def worst(grads):
        return max(((grads[n] - grads_r[n]).abs().max() / grads_r[n].abs().max().clamp_min(1e-30)).item()
                   for n in grads_r)

    loss_err = abs(loss_k - loss_r) / abs(loss_r)
    grad_err = worst(grads_k)
    log(f"phase 5 training step (2 layers, full width, f32, B=2 S=512), flash kernels vs plain "
        f"attention: loss {loss_k:.6f} vs {loss_r:.6f} rel_err={loss_err:.3e} (tol "
        f"{TRAIN_LOSS_RTOL:g}); worst gradient leaf max_abs_err / leaf max = {grad_err:.3e} "
        f"(tol {TRAIN_GRAD_RTOL:g})")
    if not (loss_err <= TRAIN_LOSS_RTOL and grad_err <= TRAIN_GRAD_RTOL):
        raise AssertionError("training step: kernel path disagrees with reference path")

    launch_dkv = fa._launch_bwd_dkv

    def wrong_head_dkv(*args):
        dk, dv = launch_dkv(*args)
        return dk.roll(1, dims=2), dv

    fa._launch_bwd_dkv = wrong_head_dkv
    try:
        _, grads_bad = loss_and_grads(cfg_k)
    finally:
        fa._launch_bwd_dkv = launch_dkv
    bad_err = worst(grads_bad)
    log(f"phase 5 planted fault (dk of each kv head taken from its neighbour): worst gradient "
        f"leaf err / leaf max = {bad_err:.3e} (must exceed {TRAIN_GRAD_RTOL:g})")
    if not bad_err > TRAIN_GRAD_RTOL:
        raise AssertionError("phase 5's gradient tolerance cannot see a wrong-head dk")
    del model, grads_k, grads_r, grads_bad
    torch.cuda.empty_cache()
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err, planted_fault_rel_err=bad_err)


# ----------------------------------------------------------------- phase 6
# 32 layers of f32 weights, gradients and AdamW moments (128 GB) do not fit
# one card; 4 layers at full width hold 30.8 GB of that state
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
PEAK_MEMORY_LIMIT = 75e9


def phase_train_main_path(dev, card):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import (
        LlamaConfig, create_llama, llama_flops_per_token, llama_loss,
    )
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(mixed_precision="bf16")
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS, attention_impl="flash")
    t0 = time.perf_counter()
    model = create_llama(cfg, seed=0, device=acc.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    model, optimizer = acc.prepare(model, optimizer)
    step_fn = acc.train_step(llama_loss, max_grad_norm=1.0)
    rng = np.random.default_rng(0)
    data = {"input_ids": rng.integers(0, cfg.vocab_size, size=(4 * TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    loader = acc.prepare_data_loader(data, batch_size=TRAIN_BATCH, drop_last=True)
    batch = next(iter(loader))  # one batch, repeated on every step
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    log(f"phase 6 model: Llama-3-8B width, {TRAIN_LAYERS} layers, f32 master weights, bf16 compute, "
        f"remat {cfg.remat_policy!r}, {n_params / 1e9:.3f}B params, AdamW(lr=3e-4, wd=0.01), "
        f"batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens; init {time.perf_counter() - t0:.1f}s")
    losses = [step_fn(batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [step_fn(batch) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [l.item() for l in losses]
    expected = {"flash_fwd": 2 * TRAIN_LAYERS * TRAIN_STEPS, "flash_bwd_dq": TRAIN_LAYERS * TRAIN_STEPS,
                "flash_bwd_dkv": TRAIN_LAYERS * TRAIN_STEPS}
    log(f"phase 6 launches during {TRAIN_STEPS} steps: "
        f"{ {k: launches[k] for k in expected} }; expected {expected} (remat runs the forward twice)")
    for name, n in expected.items():
        if launches[name] != n:
            raise AssertionError(f"kernel {name}: {launches[name]} launches on the training path, expected {n}")
    log(f"phase 6 losses {[round(l, 4) for l in losses]}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError("training losses are not finite or did not fall")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens_per_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall
    mfu = tokens_per_s * llama_flops_per_token(cfg, TRAIN_SEQ) / PEAK_FLOPS[torch.bfloat16]
    log(f"phase 6 train step {step_ms:.1f} ms, {tokens_per_s:.0f} tokens/s, MFU {mfu:.4f} "
        f"(llama_flops_per_token, 989 TFLOP/s bf16 peak), peak memory "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated) [{card}]")
    if peak > PEAK_MEMORY_LIMIT:
        raise AssertionError(f"peak memory {peak / 1e9:.1f} GB is over {PEAK_MEMORY_LIMIT / 1e9:.0f} GB")
    profile = profile_train_step(step_fn, batch, step_ms, card)
    del model, optimizer, step_fn, batch, loader
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expected}, dict(
        losses=losses, step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu, peak_memory_bytes=peak,
        batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, layers=TRAIN_LAYERS, profile=profile)


TRAIN_GROUPS = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_", "cublas", "nvjet")),
    ("optimizer", ("multi_tensor", "adam")),
)


def device_events(prof):
    """(name, start_us, dur_us) of every kernel, memcpy and memset in a
    profile, from its Chrome trace: annotation ranges (such as
    ``Optimizer.step``) and host-side entries are left out."""
    path = Path("chiprun_out/trace_train.json")
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]


def busy_us(events):
    """Length of the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if ts + dur > end:
            total += ts + dur - max(ts, end)
            end = ts + dur
    return total


def profile_train_step(step_fn, batch, step_ms, card):
    """Device time of one training step by kernel group, from a
    torch.profiler trace of that step; the busy share is the union of the
    kernels' intervals over the profiled step's own wall time. The table
    goes to chiprun_out/profile_train.txt, the trace to trace_train.json."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/profile_train.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=50))
    events = device_events(prof)
    if not events:
        log("phase 6 profile: the profiler recorded no device time (not measured)")
        return None
    groups = dict.fromkeys([g for g, _ in TRAIN_GROUPS] + ["elementwise"], 0.0)
    for name, _, dur in events:
        lower = name.lower()
        group = next((g for g, keys in TRAIN_GROUPS if any(k in lower for k in keys)), "elementwise")
        groups[group] += dur / 1e3
    busy_ms = busy_us(events) / 1e3
    log(f"phase 6 train-step profile: kernels busy {busy_ms:.1f} ms of the profiled step's "
        f"{wall_ms:.1f} ms (busy share {busy_ms / wall_ms:.3f}; unprofiled step {step_ms:.1f} ms); "
        f"by group ms " + ", ".join(f"{g}={v:.1f}" for g, v in groups.items()) + f" [{card}]")
    return dict(busy_ms=busy_ms, profiled_wall_ms=wall_ms, busy_share=busy_ms / wall_ms,
                groups_ms=groups, kernels=len(events))


KERNEL_META = {
    "flash_fwd": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/flash_fwd.cu",
        replaces="accelerate_tpu/ops/flash_attention.py:98",
    ),
    "flash_bwd_dq": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/flash_bwd.cu",
        replaces="accelerate_tpu/ops/flash_attention.py:236",
    ),
    "flash_bwd_dkv": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/flash_bwd.cu",
        replaces="accelerate_tpu/ops/flash_attention.py:281",
    ),
    "paged_decode": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_decode.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:87",
    ),
    "fused_sample": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/fused_sample.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:390",
    ),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", action="store_true",
                        help="build and check the kernels only (phases 1-2)")
    parser.add_argument("--layers", type=int, default=32,
                        help="depth of the serving main path's model (default: the full 32)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
        return 2
    from accelerate_tpu_torch.ops import _build

    # G402-style reference numerics: plain f32 products stay full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"phase 1 build: {time.perf_counter() - t0:.2f}s wall, per source "
        + ", ".join(f"{k}={v:.2f}s" for k, v in secs.items()))
    for name, text in _build.build_logs.items():
        regs = [ln.strip() for ln in text.splitlines() if "registers" in ln]
        spills = sorted({ln.strip() for ln in text.splitlines() if "spill" in ln})
        log(f"  ptxas {name}: {len(regs)} kernels; " + " | ".join(regs[:4])
            + (" || " + " | ".join(spills) if spills else ""))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    with torch.no_grad():
        check_flash(dev, gen, results)
        check_flash_bwd(dev, gen, results)
        check_paged_decode(dev, gen, results)
        check_fused_sample(dev, gen, results)
    launches = dict.fromkeys(KERNEL_META, 0)
    by_path = {}
    summary = {"card": card, "build_s": secs}
    if not args.kernels:
        with torch.no_grad():
            phase_engine_parity(dev, card)
            by_path["serving"], summary["main_path"] = phase_main_path(dev, card, args.layers)
        torch.cuda.empty_cache()
        summary["train_parity"] = phase_train_parity(dev, card)
        by_path["training"], summary["train_main_path"] = phase_train_main_path(dev, card)
        for counts in by_path.values():
            for name, n in counts.items():
                launches[name] += n

    kernels = [
        dict(name=name, **KERNEL_META[name], launches=launches[name],
             launches_by_path={path: counts.get(name, 0) for path, counts in by_path.items()},
             **results[name])
        for name in KERNEL_META
    ]
    summary["kernels"] = kernels
    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    log(card)  # as nvidia-smi prints name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
