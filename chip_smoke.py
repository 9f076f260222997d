"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels from
this checkout, holds each one against its plain PyTorch version on the
card, and drives the port's main paths with seeded random weights:
Llama-3-8B continuous-batching serving through ``InferenceServer`` at full
width and depth, plain and with speculative decoding, chunked prefill and
the int8 KV pool; the same model quantized to int8 weights, and a
checkpoint written, loaded into an empty model and quantized; and
Llama-3-8B training steps through the ``Accelerator`` at full width and 4
layers.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only
    python3 chip_smoke.py --step-ablation  # every phase, and phase 6's
                                           # step with the f32 head and the
                                           # tensor-core B2/B3 taken back

Phases (any failure exits non-zero and prints no result):
  1. build the kernels (one nvcc per source, in parallel); print the card
     and each kernel's registers, spills and shared memory
  2. each kernel, every variant, against its plain version at the main
     paths' shapes (B1's tensor-core variant on bf16 and its FMA variant
     on f32, also with segment ids, a ragged S at D = 64, softcap with a
     window, Sq != Skv, non-causal; B2/B3's tensor-core variants on bf16
     (two launches bitwise equal) and their FMA variants on f32 and on the
     same bf16 inputs, also with segment ids, a ragged S, an lse
     cotangent, softcap and window, non-causal; B4's tensor-core variants
     (bf16 q over the bf16 and the int8 pool; two launches bitwise equal,
     each output row held to its own scale, a planted stale key tile;
     timed in CUDA graphs and eagerly, beside the FMA variant on the same
     inputs and SDPA over K/V gathered beforehand) and its FMA variants on
     f32 q over the f32 and the int8 pool; B5 at the spec shape W=5 and
     the chunk shape W=512, softcap, n_rep=1: its tensor-core variants (bf16 q over the
     bf16 and the int8 pool; two launches bitwise equal; timed in CUDA
     graphs and eagerly) on every case, its FMA variants (f32 q) at the
     spec shape and one chunk; B6 exact on 8 rows with ties and a 512-row
     sweep, two launches equal, timed in CUDA graphs; B7 at every Llama-3-8B
     projection shape, M = 2048 through the tensor-core variant and M = 8
     through split-K, the FMA variant on the same bf16 inputs and on f32 x,
     int4-range codes, ragged M/K/N, f16 x, M = 17 and 65, and each
     variant's f32 output of a bf16 x at the LM head's shape): max abs error
     against a stated tolerance, median kernel / plain / library times, the
     bound and the bound share (B7 at M = 8 on cold weights, rotated over
     copies that exceed the L2, for the kernels and cuBLAS alike)
  3. the engine's kernel path against its reference path at full width and
     2 layers (prefill, first decode, verify W=5 and a 512 chunk, int8
     decode and verify logits; greedy tokens, plain and speculative), with
     planted faults that must exceed the limit
  4. the serving main path: InferenceServer, Llama-3-8B, 32 layers, 16
     requests; launch counters reset just before and read just after
  7. (run right after 4, on its model) InferenceServer with speculative
     decoding and 512-token chunked prefill over 16 requests (12
     drafter-friendly, 4 of 1,025-1,500 tokens), on the paged pool (A) and
     the int8 pool (B): launches against the engine's counters, greedy
     requests teacher-forced, tokens/s, TTFT, acceptance, step and chunk
     times, a profile of a verify step
  8. (run right after 7, on its model) quantized big-model inference: the
     model quantized to int8 in place, its forward over 4 x 512 tokens
     through B7 and B1 (225 B7 launches per forward, the head's with f32
     logits) held against the
     plain-dequantize path, with a planted scale fault that must fail the
     check; then Llama-3-8B at full width and 4 layers written to sharded
     safetensors, loaded into an empty (meta) model and quantized, bitwise
     equal to quantizing the in-memory copy
  5. a training step's kernel path against its reference path at full
     width, 2 layers, f32 (loss and every gradient leaf; B1's FMA variant,
     launches checked), with a planted fault that must exceed the limit
  6. the training main path: Accelerator(mixed_precision="bf16"), prepare,
     prepare_data_loader and train_step(llama_loss, max_grad_norm=1.0) on
     Llama-3-8B at 4 layers, batch 4 x 2048; 2 warm-up and 8 timed steps
     with the launch counters reset just before; tokens/s, step time, MFU,
     peak memory and a profile of one step; with --step-ablation, then
     the step with the f32 head and the tensor-core B2/B3 each taken
     back, in turns
The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Long output goes to chiprun_out/.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import math
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
# B4 and B5, by q's dtype (an int8 pool with f32 q computes in f32 throughout)
B4_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, repeats: int = 5, warmup: int = 3) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` back-to-back
    calls, by CUDA events (after ``warmup`` calls)."""
    for _ in range(warmup):
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


def time_graph_ms(fn, iters: int, repeats: int = 5) -> float:
    """Median over ``repeats`` of the mean time of ``iters`` calls of ``fn``
    captured in one CUDA graph and replayed, by CUDA events: the device
    time of launches that take microseconds, without the host's launch
    overhead (Python, ctypes and allocation take longer than the kernel
    at decode shapes, so an eager loop would time the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    del graph
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
        flash_attention_reference, flash_attention_with_lse, flash_fwd_kernel_for,
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
            log(f"B1 {flash_fwd_kernel_for(dtype)} {dtype} (B={b}, S={s}, H={h}, Hkv={h_kv}, D={d}) "
                f"max_abs_err={err:.3e} tol={tol:g}")
            if not err <= tol:
                raise AssertionError(f"flash_fwd {dtype} disagrees with its plain version")
            del out, lse, ref, ref_lse
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

            def kern():
                return flash_attention_with_lse(q, k, v, causal=True)

            def lib():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)

            if s <= 512:  # tens of microseconds: a graph keeps the host out of the timing
                ms, lib_ms = time_graph_ms(kern, 20), time_graph_ms(lib, 20)
            else:
                ms, lib_ms = time_ms(kern, iters=5), time_ms(lib, iters=5)
            plain_ms = time_ms(lambda: flash_attention_reference(q, k, v, causal=True),
                               iters=5 if s <= 512 else 2, repeats=3)
            item = dtype.itemsize
            nbytes = 2 * b * s * h * d * item + 2 * b * s * h_kv * d * item + b * h * s * 4
            flops = 4.0 * b * h * d * s * (s + 1) / 2  # visible causal pairs
            bms, by = bound_ms(nbytes, flops, dtype)
            log(f"  {flash_fwd_kernel_for(dtype)} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                f"sdpa_ms={lib_ms:.4f} bound_ms={bms:.5f} ({by}); bound share {bms / ms:.4f}, "
                f"{ms / lib_ms:.2f}x SDPA")
            entry = results.setdefault(flash_fwd_kernel_for(dtype), {})
            if s == 2048:  # the training step's shape
                entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=lib_ms,
                             shape=f"B={b} S={s} H={h} Hkv={h_kv} D={d} causal, {dtype}")
            else:  # serving's single-shot prefill
                entry.update(serving_max_abs_err=err, serving_ms=ms, serving_plain_ms=plain_ms,
                             serving_bound_ms=bms, serving_bound_by=by, serving_library_ms=lib_ms)
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
        results[flash_fwd_kernel_for(dtype)]["segment_ids_max_abs_err"] = err
    # the edges: ragged S with D = 64 and no GQA, a window with a softcap,
    # Sq < Skv and Sq > Skv (causal anchored at 0), non-causal
    for name, (b, sq, skv, h, h_kv, d, opts) in B1_EDGE_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, skv, h_kv, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, skv, h_kv, d), generator=gen, device=dev).to(dtype)
            out, lse = flash_attention_with_lse(q, k, v, **opts)
            ref, ref_lse = flash_attention_reference(q, k, v, **opts)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            log(f"B1 {flash_fwd_kernel_for(dtype)} {name} {dtype} (B={b}, Sq={sq}, Skv={skv}, H={h}, "
                f"Hkv={h_kv}, D={d}, {opts}) max_abs_err={err:.3e} tol={B1_TOL[dtype]:g}")
            if not err <= B1_TOL[dtype]:
                raise AssertionError(f"flash forward {name} {dtype} disagrees with its plain version")
            edge = results[flash_fwd_kernel_for(dtype)].setdefault("edge_max_abs_err", 0.0)
            results[flash_fwd_kernel_for(dtype)]["edge_max_abs_err"] = max(edge, err)


# name -> (B, Sq, Skv, H, Hkv, D, options)
B1_EDGE_CASES = {
    "ragged_d64": (1, 333, 333, 4, 4, 64, dict(causal=True)),
    "window_softcap": (2, 1000, 1000, 8, 2, 128, dict(causal=True, window=200, softcap=30.0)),
    "sq_lt_skv": (1, 200, 520, 8, 8, 64, dict(causal=True)),
    "sq_gt_skv_noncausal": (1, 300, 130, 8, 2, 128, dict(causal=False)),
}


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


@contextlib.contextmanager
def bwd_kernels(names):
    """Runs the flash backward by ``names`` (dq, then dk/dv) whatever the
    dtype, by standing in for ``flash_bwd_kernel_for``: the FMA kernels
    (``flash_bwd_kernel_for(torch.float32)``) then run on bf16 too."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    chosen = fa.flash_bwd_kernel_for
    fa.flash_bwd_kernel_for = lambda dtype: names
    try:
        yield
    finally:
        fa.flash_bwd_kernel_for = chosen


def check_flash_bwd(dev, gen, results):
    """B2/B3 against the plain backward on every BWD_CASES case: f32 through
    the FMA kernels; bf16 through the tensor-core kernels, launched twice
    (the gradients must be bitwise equal), and through the FMA kernels on
    the same inputs."""
    from accelerate_tpu_torch.ops.flash_attention import (
        _delta, _launch_bwd_dkv, _launch_bwd_dq, flash_attention_bwd_reference,
        flash_attention_reference, flash_bwd_kernel_for,
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
            ref = flash_attention_bwd_reference(q, k, v, out, lse, do, dlse=dlse, **mask)
            variants = [flash_bwd_kernel_for(dtype)]
            if dtype == torch.bfloat16:
                variants.append(flash_bwd_kernel_for(torch.float32))  # the FMA kernels
            errors = {}
            for dq_name, dkv_name in variants:
                with bwd_kernels((dq_name, dkv_name)):
                    got = (_launch_bwd_dq(*args), *_launch_bwd_dkv(*args))
                torch.cuda.synchronize()
                errs, rels = {}, {}
                for grad, g, r in zip(("dq", "dk", "dv"), got, ref):
                    errs[grad] = (g.float() - r.float()).abs().max().item()
                    big = r.float().abs().max().item()
                    rels[grad] = errs[grad] / big
                    log(f"B2/B3 {dq_name}/{dkv_name} {name} {dtype} (B={b}, S={s}, H={h}, "
                        f"Hkv={h_kv}, D={d}, {opt or 'causal'}) {grad}: max_abs_err={errs[grad]:.3e} "
                        f"max |{grad}|={big:.3e} ratio={rels[grad]:.3e} tol {BWD_TOL_REL[dtype]:g}")
                    if not rels[grad] <= BWD_TOL_REL[dtype]:
                        raise AssertionError(f"flash backward {dq_name}/{dkv_name} {name} {dtype}: "
                                             f"{grad} disagrees with its plain version")
                if dq_name.endswith("_mma"):
                    with bwd_kernels((dq_name, dkv_name)):
                        again = (_launch_bwd_dq(*args), *_launch_bwd_dkv(*args))
                    if not all(torch.equal(x, y) for x, y in zip(got, again)):
                        raise AssertionError(f"{dq_name}/{dkv_name} {name}: two launches differ")
                    log(f"  {dq_name}/{dkv_name} {name}: two launches bitwise equal")
                    del again
                errors[dq_name, dkv_name] = (errs, rels)
                for kname, rel in ((dq_name, rels["dq"]), (dkv_name, max(rels["dk"], rels["dv"]))):
                    entry = results.setdefault(kname, {})
                    if name != "main":  # the worst ratio over the other cases
                        entry["edge_max_rel_err"] = max(entry.get("edge_max_rel_err", 0.0), rel)
                del got
            del ref
            if name == "main":
                time_flash_bwd(dtype, args, out, dlse, mask, errors, results)
            del q, k, v, do, out, lse, delta, args
            torch.cuda.empty_cache()


def time_flash_bwd(dtype, args, out, dlse, mask, errors, results):
    """Times of each backward variant at the training shape against the
    plain backward and SDPA's backward (one autograd call, the yardstick)."""
    from accelerate_tpu_torch.ops import flash_attention as fa

    q, k, v, do, lse = args[:5]
    b, s, h, d = q.shape
    h_kv = k.shape[2]
    plain_ms = time_ms(lambda: fa.flash_attention_bwd_reference(
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
    for (dq_name, dkv_name), (errs, rels) in errors.items():
        slow = not dq_name.endswith("_mma")
        with bwd_kernels((dq_name, dkv_name)):
            dq_ms = time_ms(lambda: fa._launch_bwd_dq(*args), iters=2 if slow else 10)
            dkv_ms = time_ms(lambda: fa._launch_bwd_dkv(*args), iters=2 if slow else 10)
        log(f"  {dq_name} {dtype} ms={dq_ms:.4f} bound_ms={dq_bound[0]:.5f} ({dq_bound[1]}), bound "
            f"share {dq_bound[0] / dq_ms:.4f}; {dkv_name} ms={dkv_ms:.4f} "
            f"bound_ms={dkv_bound[0]:.5f} ({dkv_bound[1]}), bound share {dkv_bound[0] / dkv_ms:.4f}; "
            f"plain backward (dq, dk, dv) ms={plain_ms:.4f}; SDPA backward ms={lib_ms:.4f}; "
            f"dq + dk/dv {(dq_ms + dkv_ms) / lib_ms:.2f}x SDPA")
        if dtype == torch.float32:  # the FMA kernels' own dtype, beside their bf16 row
            results[dq_name].update(f32_ms=dq_ms, f32_library_ms=lib_ms, f32_max_abs_err=errs["dq"])
            results[dkv_name].update(f32_ms=dkv_ms, f32_library_ms=lib_ms,
                                     f32_max_abs_err=max(errs["dk"], errs["dv"]))
            continue
        # max_rel_err: max abs error / max |gradient|, what BWD_TOL_REL limits
        shape = f"B={b} S={s} H={h} Hkv={h_kv} D={d} causal, bf16"
        results[dq_name].update(
            max_abs_err=errs["dq"], max_rel_err=rels["dq"], ms=dq_ms, plain_ms=plain_ms,
            bound_ms=dq_bound[0], bound_by=dq_bound[1], library_ms=lib_ms, shape=shape)
        results[dkv_name].update(
            max_abs_err=max(errs["dk"], errs["dv"]), max_rel_err=max(rels["dk"], rels["dv"]),
            ms=dkv_ms, plain_ms=plain_ms, bound_ms=dkv_bound[0], bound_by=dkv_bound[1],
            library_ms=lib_ms, shape=shape)


def random_tables(gen, dev, slots, bpr, nb, live_blocks):
    """(slots, bpr) int32 tables over disjoint random pool blocks; each row
    holds ``live_blocks[i]`` real blocks, null (0) past them."""
    perm = torch.randperm(nb - 1, generator=gen, device=dev).to(torch.int32) + 1
    tables = torch.zeros((slots, bpr), dtype=torch.int32, device=dev)
    for i, n in enumerate(live_blocks):
        tables[i, :n] = perm[i * bpr: i * bpr + n]
    return tables


def random_pools(gen, dev, nb, bs, h_kv, d, pool_dtype):
    """K/V pools (and, for int8, their per-position scales as kwargs)."""
    if pool_dtype == torch.int8:
        kq, vq = (torch.randint(-127, 128, (nb, bs, h_kv, d), generator=gen, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand((nb, bs), generator=gen, device=dev) * 0.02 + 1e-3 for _ in range(2))
        return kq, vq, dict(k_scale=ks, v_scale=vs)
    kp, vp = (torch.randn((nb, bs, h_kv, d), generator=gen, device=dev).to(pool_dtype)
              for _ in range(2))
    return kp, vp, {}


def pool_bytes_per_pos(h_kv, d, pool_dtype):
    """K and V bytes of one position of the pool, scales included."""
    if pool_dtype == torch.int8:
        return 2 * (h_kv * d + 4)
    return 2 * h_kv * d * pool_dtype.itemsize


# B4 and B5: bf16 q is held per output row (slot, query, head) as well: its
# largest error within 2^-6 of the row's largest |reference|, 2 to 4 bf16
# ulps of it (kernel and plain version each round p and the output to bf16: one
# ulp apart reads up to 2^-7, and the sound maximum measured on an H100
# was 8.8e-3). Small outputs deep in history are held to their own row's
# scale, not to the absolute B4_TOL; a planted stale key tile must exceed
# this limit (b4_planted_fault, b5_planted_fault)
B5_ROW_RTOL = 2.0 ** -6


def row_rel_err(out, ref, valid):
    """Largest over the compared rows of max |out - ref| / max |ref|, both
    over a row's D outputs; ``valid`` (B, W) marks the compared rows."""
    diff = (out.float() - ref.float()).abs().amax(-1)
    return (diff / ref.float().abs().amax(-1))[valid].max().item()


@contextlib.contextmanager
def decode_kernel(name):
    """Runs paged_flash_decode through kernel ``name`` whatever the dtypes,
    by standing in for ``decode_kernel_for``: the FMA pair (the kernels
    before the tensor-core redesign) then runs on bf16 q too."""
    from accelerate_tpu_torch.ops import paged_decode as pd

    chosen = pd.decode_kernel_for
    pd.decode_kernel_for = lambda q_dtype, pool_dtype: name
    try:
        yield
    finally:
        pd.decode_kernel_for = chosen


# B4's shape: 8 slots of a 1,024-position row: a fresh slot, an exactly
# full first block, one past it, mid-row, an exactly full last block of the
# row, main-path-like positions
B4_POS = [0, 15, 16, 575, 576, 1023, 300, 47]
B4_GRAPH_ITERS = 50


def check_paged_decode(dev, gen, results):
    """B4 against its plain version with the bf16, f32 and int8 pools: each
    variant launched twice (bitwise equal), bf16 q also per output row
    (B5_ROW_RTOL), with a planted stale key tile that must exceed that
    limit; timed in CUDA graphs and eagerly, bf16 q also through the FMA
    kernel on the same inputs, and beside SDPA over K/V gathered
    beforehand (a yardstick: not the same function, the gather is left
    out)."""
    from accelerate_tpu_torch.ops.attention import _gather_pool, paged_attention
    from accelerate_tpu_torch.ops.paged_decode import decode_kernel_for, decode_plan, paged_flash_decode

    slots, h, h_kv, d, bs, bpr = 8, 32, 8, 128, 16, 64
    nb = slots * bpr + 1
    pos = torch.tensor(B4_POS, dtype=torch.int32, device=dev)
    tables = random_tables(gen, dev, slots, bpr, nb, [p // bs + 1 for p in B4_POS])
    every = torch.ones((slots, 1), dtype=torch.bool, device=dev)
    plan = decode_plan(slots, h, h_kv, bpr * bs)
    live = sum(p + 1 for p in B4_POS)
    # (pool, q) dtypes: the f32 pool and the int8 pool with f32 q (the FMA
    # pair), then the bf16 and the int8 pool with bf16 q (the main paths'
    # forms, the tensor-core pair)
    for pool_dtype, dtype in ((torch.float32, torch.float32), (torch.int8, torch.float32),
                              (torch.bfloat16, torch.bfloat16), (torch.int8, torch.bfloat16)):
        q = torch.randn((slots, 1, h, d), generator=gen, device=dev).to(dtype)
        kp, vp, scales = random_pools(gen, dev, nb, bs, h_kv, d, pool_dtype)
        args = (q, kp, vp, tables, pos)
        name = decode_kernel_for(dtype, pool_dtype)
        mma = name.endswith("_mma")
        out = paged_flash_decode(*args, **scales)
        out2 = paged_flash_decode(*args, **scales)
        ref = paged_attention(*args, **scales)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        rel = row_rel_err(out, ref, every) if dtype == torch.bfloat16 else None
        same = torch.equal(out, out2)
        tol = B4_TOL[dtype]
        log(f"B4 {name} pool {pool_dtype} q {dtype} (slots={slots}, H={h}, Hkv={h_kv}, D={d}, "
            f"bs={bs}, pos={B4_POS}" + (f", {plan.splits} history splits" if mma else "")
            + f") max_abs_err={err:.3e} tol={tol:g}"
            + (f", row_rel_err={rel:.3e} tol={B5_ROW_RTOL:g}" if rel is not None else "")
            + f", second launch bitwise equal: {same}")
        if not err <= tol or (rel is not None and not rel <= B5_ROW_RTOL):
            raise AssertionError(f"{name} {pool_dtype}/{dtype} disagrees with its plain version")
        if not same:
            raise AssertionError(f"{name} {pool_dtype}/{dtype}: a second launch gave other bits")
        entry = results.setdefault(name, dict(library_ms=None))
        if rel is not None:
            entry.update(row_rel_err=rel, fault_row_rel_err=b4_planted_fault(out, args, scales, pos, bs))

        def kern():
            return paged_flash_decode(*args, **scales)

        ms = time_ms(kern)
        graph_ms = time_graph_ms(kern, B4_GRAPH_ITERS)
        plain_ms = time_ms(lambda: paged_attention(*args, **scales))
        nbytes = (live * pool_bytes_per_pos(h_kv, d, pool_dtype) + 2 * slots * h * d * dtype.itemsize
                  + tables.numel() * 4 + slots * 4)
        bms, by = bound_ms(nbytes, 4.0 * live * h * d, dtype)
        entry.update(max_abs_err=err, ms=graph_ms, eager_ms=ms, plain_ms=plain_ms, bound_ms=bms,
                     bound_by=by, splits=plan.splits if mma else None)
        extra = ""
        if dtype == torch.bfloat16:
            # the FMA kernel on the same bf16 inputs: the kernel before the
            # tensor-core redesign, timed in the same call
            fma = "paged_decode_int8" if scales else "paged_decode"
            with decode_kernel(fma):
                fma_err = (paged_flash_decode(*args, **scales).float() - ref.float()).abs().max().item()
                fma_ms, fma_graph_ms = time_ms(kern), time_graph_ms(kern, B4_GRAPH_ITERS)
            # yardstick: SDPA over K/V gathered beforehand into a dense
            # (B, Hkv, S, D) in bf16 with a length mask
            kd, vd = (_gather_pool(x, tables, sc).to(dtype).transpose(1, 2).contiguous()
                      for x, sc in ((kp, scales.get("k_scale")), (vp, scales.get("v_scale"))))
            qt = q.transpose(1, 2)
            mask = (torch.arange(bpr * bs, device=dev)[None, :] <= pos[:, None])[:, None, None, :]

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    qt, kd, vd, attn_mask=mask, enable_gqa=True)

            sdpa_ms = time_graph_ms(sdpa, B4_GRAPH_ITERS)
            entry.update(fma_ms=fma_ms, fma_graph_ms=fma_graph_ms, fma_max_abs_err=fma_err,
                         sdpa_gathered_ms=sdpa_ms)
            extra = (f" FMA {fma} on the same inputs: graph_ms={fma_graph_ms:.4f} ms={fma_ms:.4f} "
                     f"max_abs_err={fma_err:.3e}; SDPA over pre-gathered K/V (not the same function: "
                     f"the gather is left out) graph_ms={sdpa_ms:.4f}")
            del kd, vd
        log(f"  graph_ms={graph_ms:.4f} ms={ms:.4f} (eager) plain_ms={plain_ms:.4f} "
            f"bound_ms={bms:.5f} ({by}), bound share {bms / graph_ms:.3f};" + extra)
        del q, kp, vp, out, out2, ref
    torch.cuda.empty_cache()


def b4_planted_fault(out, args, scales, pos, bs):
    """The check's power: the plain version over a table whose positions
    256..319 (four pool blocks, one 64-key tile of the kernel) point at
    other blocks, held against the kernel's sound output on the slots with
    >= 320 keys. Raises unless the row check (B5_ROW_RTOL) sees the stale
    tile."""
    from accelerate_tpu_torch.ops.attention import paged_attention

    q, kp, vp, tables, _ = args
    stale = tables.clone()
    cols = slice(256 // bs, 320 // bs)
    stale[:, cols] = (tables[:, cols] + 7) % (kp.shape[0] - 1) + 1
    ref = paged_attention(q, kp, vp, stale, pos, **scales)
    deep = (pos >= 320)[:, None]
    rel = row_rel_err(out, ref, deep)
    err = (out.float() - ref.float())[deep.expand(-1, out.shape[1])].abs().max().item()
    log(f"  planted fault (one stale 64-key tile at positions 256..319): row_rel_err={rel:.3e} "
        f"(limit {B5_ROW_RTOL:g}) max_abs_err={err:.3e} (absolute limit {B4_TOL[torch.bfloat16]:g})")
    if not rel > B5_ROW_RTOL:
        raise AssertionError("B4's row check does not see a stale key tile")
    return rel


# B5 cases: name -> (B, W, H, Hkv, pos per slot, softcap); the spec shape
# (8 slots, W = 5, the row of engine_max_len 2048) with fresh and long
# slots, the chunk shape (one slot, W = 512) at chunk offsets 0, 512 and
# 1024 and a ragged last chunk at 1700 whose window overhangs the row (only
# its rows inside the row are compared: the engine discards the rest), a
# softcap case and an n_rep = 1 case
B5_SPEC_POS = [0, 300, 517, 777, 1024, 1200, 1391, 1500]
B5_CASES = {
    "spec": (8, 5, 32, 8, B5_SPEC_POS, None),
    "chunk_0": (1, 512, 32, 8, [0], None),
    "chunk_512": (1, 512, 32, 8, [512], None),
    "chunk_1024": (1, 512, 32, 8, [1024], None),
    "chunk_ragged_1700": (1, 512, 32, 8, [1700], None),
    "spec_softcap": (8, 5, 32, 8, B5_SPEC_POS, 50.0),
    "spec_mha": (8, 5, 8, 8, B5_SPEC_POS, None),
}
B5_BPR, B5_BS = 128, 16
# graph-replayed launches per timing of the spec shape (tens of us each)
B5_GRAPH_ITERS = {"spec": 50, "chunk": 10}


def check_paged_verify(dev, gen, results):
    from accelerate_tpu_torch.ops.paged_decode import (
        paged_flash_verify, paged_flash_verify_reference, verify_kernel_for, verify_plan)

    d, bs, bpr = 128, B5_BS, B5_BPR
    for case, (b, w, h, h_kv, pos_list, softcap) in B5_CASES.items():
        nb = b * bpr + 1
        pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
        # every slot owns its whole row, as a request of max_len does
        tables = random_tables(gen, dev, b, bpr, nb, [bpr] * b)
        valid = (pos[:, None] + torch.arange(w, device=dev)[None, :]) < bpr * bs
        shape = "spec" if w <= 8 else "chunk"
        plan = verify_plan(b, w, h, h_kv, bpr * bs)
        # every case: both tensor-core variants (bf16 q over the bf16 and
        # the int8 pool, the main paths' forms); the FMA pair (f32 q) at
        # the spec shape and the chunk at offset 512, as before
        combos = [(torch.bfloat16, torch.bfloat16), (torch.int8, torch.bfloat16)]
        if case in ("spec", "chunk_512"):
            combos += [(torch.float32, torch.float32), (torch.int8, torch.float32)]
        for pool_dtype, dtype in combos:
            kp, vp, scales = random_pools(gen, dev, nb, bs, h_kv, d, pool_dtype)
            q = torch.randn((b, w, h, d), generator=gen, device=dev).to(dtype)
            wk = torch.randn((b, w, h_kv, d), generator=gen, device=dev).to(dtype)
            wv = torch.randn((b, w, h_kv, d), generator=gen, device=dev).to(dtype)
            args = (q, kp, vp, wk, wv, tables, pos)
            kw = dict(softcap=softcap, **scales)
            name = verify_kernel_for(dtype, pool_dtype)
            mma = name.endswith("_mma")
            out = paged_flash_verify(*args, **kw)
            out2 = paged_flash_verify(*args, **kw)
            ref = paged_flash_verify_reference(*args, **kw)
            torch.cuda.synchronize()
            err = (out.float() - ref.float())[valid].abs().max().item()
            rel = row_rel_err(out, ref, valid) if mma else None
            same = torch.equal(out, out2)
            tol = B4_TOL[dtype]
            log(f"B5 {name} {case} pool {pool_dtype} q {dtype} (B={b}, W={w}, H={h}, Hkv={h_kv}, "
                f"D={d}, bs={bs}, bpr={bpr}, pos={pos_list}, softcap={softcap}"
                + (f", {plan.block_rows}-row tiles, {plan.splits} history splits" if mma else "")
                + f") max_abs_err={err:.3e} tol={tol:g}"
                + (f", row_rel_err={rel:.3e} tol={B5_ROW_RTOL:g}" if mma else "")
                + f", second launch bitwise equal: {same}")
            if not err <= tol or (mma and not rel <= B5_ROW_RTOL):
                raise AssertionError(f"{name} {case} {pool_dtype}/{dtype} disagrees with its plain version")
            if mma and case == "spec":
                fault_rel, fault_abs = b5_planted_fault(out, args, kw, pos, valid, bs)
                results.setdefault(name, dict(library_ms=None)).update(
                    row_rel_err=rel, fault_row_rel_err=fault_rel)
            if mma and not same:
                raise AssertionError(f"{name} {case}: a second launch gave other bits")
            record = case in (("spec", "chunk_1024") if mma else ("spec", "chunk_512"))
            ms = time_ms(lambda: paged_flash_verify(*args, **kw))
            # the tensor-core kernels take tens of us: an eager loop times
            # the host's launch, so the recorded time replays a CUDA graph
            graph_ms = (time_graph_ms(lambda: paged_flash_verify(*args, **kw), B5_GRAPH_ITERS[shape])
                        if mma and (record or shape == "spec") else None)
            plain_ms = (time_ms(lambda: paged_flash_verify_reference(*args, **kw), iters=5, repeats=3)
                        if record else None)
            item = dtype.itemsize
            hist = sum(min(p, bpr * bs) for p in pos_list)
            nbytes = (2 * b * w * h * d * item + 2 * b * w * h_kv * d * item
                      + hist * pool_bytes_per_pos(h_kv, d, pool_dtype) + tables.numel() * 4 + b * 4)
            flops = sum(4.0 * h * d * w * (p + (w + 1) / 2) for p in pos_list)
            bms, by = bound_ms(nbytes, flops, dtype)
            log(f"  ms={ms:.4f} (eager)" + (f" graph_ms={graph_ms:.4f}" if graph_ms else "")
                + (f" plain_ms={plain_ms:.4f}" if plain_ms else "") + f" bound_ms={bms:.5f} ({by})")
            if record:
                kern_ms = graph_ms if mma else ms
                entry = results.setdefault(name, dict(library_ms=None))
                if shape == "spec":
                    entry.update(max_abs_err=err, ms=kern_ms, eager_ms=ms, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by, splits=plan.splits if mma else None)
                else:
                    entry.update(chunk_max_abs_err=err, chunk_ms=kern_ms, chunk_eager_ms=ms,
                                 chunk_plain_ms=plain_ms, chunk_bound_ms=bms, chunk_bound_by=by)
            del ref, out, out2
        del kp, vp, q, wk, wv
    torch.cuda.empty_cache()


def b5_planted_fault(out, args, kw, pos, valid, bs):
    """The check's power: the plain version over a table whose positions
    256..287 (two pool blocks, one 32-key tile) point at stale blocks, held
    against the kernel's sound output on the rows with >= 300 history keys.
    Raises unless the row check (B5_ROW_RTOL) sees the stale tile."""
    from accelerate_tpu_torch.ops.paged_decode import paged_flash_verify_reference

    q, kp, vp, wk, wv, tables, _ = args
    stale = tables.clone()
    stale[:, 256 // bs: 288 // bs] = tables[:, 1024 // bs: 1056 // bs]
    ref = paged_flash_verify_reference(q, kp, vp, wk, wv, stale, pos, **kw)
    deep = valid & (pos[:, None] >= 300)
    rel = row_rel_err(out, ref, deep)
    err = (out.float() - ref.float())[deep].abs().max().item()
    log(f"  planted fault (one stale 32-key tile at positions 256..287): "
        f"row_rel_err={rel:.3e} (limit {B5_ROW_RTOL:g}) max_abs_err={err:.3e} "
        f"(absolute limit {B4_TOL[torch.bfloat16]:g})")
    if not rel > B5_ROW_RTOL:
        raise AssertionError("B5's row check does not see a stale key tile")
    return rel, err


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
    out2 = fused_sample(logits, noise, temp, top_k, top_p)
    ref = fused_sample_reference(logits, noise, temp, top_k, top_p)
    torch.cuda.synchronize()
    mismatches = int((out != ref).sum().item())
    same = torch.equal(out, out2)
    log(f"B6 fused_sample (S={s}, V={v}) tokens={out.tolist()} ref={ref.tolist()} "
        f"mismatches={mismatches} (tolerance: exact), second launch equal: {same}")
    if mismatches or not same:
        raise AssertionError("fused_sample disagrees with its plain version or with itself")
    sweep_mismatches = check_fused_sample_sweep(dev, gen, v)
    sweep_mismatches += check_fused_sample_edges(dev, gen)
    # tens of us: the recorded time replays a CUDA graph (an eager loop
    # times the host's launch); the eager time stays beside it
    eager_ms = time_ms(lambda: fused_sample(logits, noise, temp, top_k, top_p))
    ms = time_graph_ms(lambda: fused_sample(logits, noise, temp, top_k, top_p), 50)
    first = [t[:1] for t in (logits, noise, temp, top_k, top_p)]  # a greedy first token, S = 1
    first_ms = time_graph_ms(lambda: fused_sample(*first), 50)
    # the same settings on logits without ties (a model's logits): ties put
    # many keys into one histogram bin at every level
    untied = torch.randn((s, v), generator=gen, device=dev) * 3.0
    untied_ms = time_graph_ms(lambda: fused_sample(untied, noise, temp, top_k, top_p), 50)
    plain_ms = time_ms(lambda: fused_sample_reference(logits, noise, temp, top_k, top_p), iters=3)
    # the function must read logits and noise once and write one token per
    # row; its least work is a scale, an exp, a noise add and a compare per
    # element, far below the bytes' time
    nbytes = 2 * s * v * 4 + s * 16
    flops = 4.0 * s * v
    bms, by = bound_ms(nbytes, flops, torch.float32)
    log(f"  ms={ms:.4f} (graph; rows 6-7 tied) eager_ms={eager_ms:.4f} untied_ms={untied_ms:.4f} "
        f"(graph) S=1 greedy ms={first_ms:.4f} (graph) plain_ms={plain_ms:.4f} "
        f"bound_ms={bms:.5f} ({by})")
    results["fused_sample"] = dict(
        max_abs_err=float(mismatches + sweep_mismatches), ms=ms, eager_ms=eager_ms,
        untied_ms=untied_ms, first_token_ms=first_ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=None,
    )


def check_fused_sample_edges(dev, gen) -> int:
    """B6 where the main settings do not reach: top_p <= 0 (p * Z <= 0
    keeps every token, so the draw equals top-p off), with top-k off and
    on, tied and untied; and Qwen2's vocabulary, 152,064 (9,504 logits a
    block: the three-limb mass histograms), at the 8 rows' settings.
    Exact against the plain version and a second launch."""
    from accelerate_tpu_torch.ops.paged_decode import fused_sample, fused_sample_reference

    mismatches = 0
    for v, s in ((128256, 8), (152064, 8)):
        logits = torch.randn((s, v), generator=gen, device=dev) * 3.0
        logits[s // 2:] = torch.round(logits[s // 2:])
        u = torch.rand((s, v), generator=gen, device=dev).clamp_min(torch.finfo(torch.float32).tiny)
        noise = -torch.log(-torch.log(u))
        if v == 128256:
            temp = torch.full((s,), 0.8, device=dev)
            top_k = torch.tensor([0, 50] * (s // 2), dtype=torch.int32, device=dev)
            top_p = torch.tensor([0.0, 0.0, -0.5, -0.5] * (s // 4), device=dev)
        else:
            temp = torch.tensor([0.0, 0.8, 0.8, 0.8, 1.0, 0.0, 0.7, 1.3], device=dev)
            top_k = torch.tensor([0, 50, 0, 50, 1, 50, 40, 100], dtype=torch.int32, device=dev)
            top_p = torch.tensor([1.0, 1.0, 0.9, 0.9, 0.5, 0.9, 0.95, 0.0], device=dev)
        out = fused_sample(logits, noise, temp, top_k, top_p)
        out2 = fused_sample(logits, noise, temp, top_k, top_p)
        ref = fused_sample_reference(logits, noise, temp, top_k, top_p)
        torch.cuda.synchronize()
        bad = int((out != ref).sum().item())
        same = torch.equal(out, out2)
        kept = True
        if v == 128256:  # top_p <= 0 draws what top-p off draws
            kept = torch.equal(out, fused_sample(logits, noise, temp, top_k, torch.ones_like(top_p)))
        log(f"B6 fused_sample edges (S={s}, V={v}, top_p={top_p.tolist()}, top_k={top_k.tolist()}) "
            f"mismatches={bad} (tolerance: exact), second launch equal: {same}"
            + (f", equal to top-p off: {kept}" if v == 128256 else ""))
        if bad or not same or not kept:
            raise AssertionError(f"fused_sample disagrees on its edge rows (V={v})")
        mismatches += bad
    return mismatches


# rows of the wider B6 check: the kernel's fixed-point sums (Z and the mass
# above each top-p candidate) round otherwise than torch's .sum, so the two
# agree bitwise only while no row's cutoff falls within rounding of p * Z;
# this many seeded rows put that to the test
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
    out2 = fused_sample(logits, noise, temp, top_k, top_p)
    ref = fused_sample_reference(logits, noise, temp, top_k, top_p)
    torch.cuda.synchronize()
    mismatches = int((out != ref).sum().item())
    same = torch.equal(out, out2)
    log(f"B6 fused_sample sweep ({n} seeded rows: top-p only, top-k only, both, greedy) "
        f"mismatches={mismatches} (tolerance: exact), second launch equal: {same}")
    if mismatches or not same:
        raise AssertionError(f"fused_sample disagrees with its plain version on {mismatches} rows "
                             f"or with itself")
    return mismatches


# B7: one output ulp. Outputs are kept below 4 (checked), so the bf16 limit
# is one ulp of [2, 4) (2^-6 = 0.0156) and the f16 one 2^-9; an f32 output
# is held to 1e-4 of the largest, the sum running over up to 14,336 terms
B7_TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3}
B7_F32_RTOL = 1e-4
# Llama-3-8B's projections: name -> (K, N, launches per layer or per forward)
B7_SHAPES = {
    "q_o": (4096, 4096, 2), "k_v": (4096, 1024, 2), "gate_up": (4096, 14336, 2),
    "down": (14336, 4096, 1), "head": (4096, 128256, None),
}


def b7_operands(gen, dev, m, k, n, dtype, qmax=127):
    """x (M, K), int8 q (K, N) with |q| <= qmax, per-column scales that keep
    the outputs near 0.3 standard deviation (below 4 everywhere)."""
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    q = torch.randint(-qmax, qmax + 1, (k, n), generator=gen, device=dev, dtype=torch.int8)
    scales = (0.5 + torch.rand(n, generator=gen, device=dev)) * (0.3 * 3 ** 0.5 / (qmax * k ** 0.5))
    return x, q, scales


def b7_error(x, q, scales, label, plan=None, out_dtype=None):
    """Max abs error of B7 against its plain version, held to B7_TOL (bf16,
    f16 outputs) or B7_F32_RTOL (f32 outputs): the variant the wrapper
    picks, or ``plan``'s; ``out_dtype=torch.float32`` asks for the f32
    output (the LM head's logits)."""
    from accelerate_tpu_torch.ops import quant_matmul as qmm

    if plan is None:
        out = qmm.quantized_matmul(x, q, scales, out_dtype=out_dtype)
    else:
        out = torch.empty((x.shape[0], q.shape[1]), dtype=out_dtype or x.dtype, device=x.device)
        qmm._launch(plan, x, q, scales.reshape(-1).float().contiguous(), out)
    ref = qmm.quantized_matmul_plain(x, q, scales, out_dtype=out_dtype)
    torch.cuda.synchronize()
    if out.dtype != ref.dtype:
        raise AssertionError(f"quant_matmul {label}: output {out.dtype}, expected {ref.dtype}")
    err = (out.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    if out.dtype == torch.float32:
        ok, tol = err <= B7_F32_RTOL * top, f"{B7_F32_RTOL:g} x max|out| = {B7_F32_RTOL * top:.3e}"
    else:
        ok, tol = err <= B7_TOL[x.dtype] and top < 4.0, f"{B7_TOL[x.dtype]:g} (max|out| {top:.3f} < 4)"
    log(f"B7 {label} {x.dtype} -> {out.dtype} (M={x.shape[0]}, K={q.shape[0]}, N={q.shape[1]}) "
        f"max_abs_err={err:.3e} tol {tol}")
    if not ok:
        raise AssertionError(f"quant_matmul {label} {x.dtype} disagrees with its plain version")
    return err


# each timed loop over cold weights reads at least this many bytes
COLD_BYTES = 100e6


def cold_copies(t, min_bytes=COLD_BYTES):
    """``t`` and enough clones of it that a loop over all of them reads at
    least ``min_bytes``: twice the 50 MB L2, so each copy comes back from
    device memory, as a decode step finds its weights."""
    return [t] + [t.clone() for _ in range(math.ceil(min_bytes / t.nbytes) - 1)]


def rotating(fn, copies):
    """A call of ``fn`` on the next of ``copies`` per call, and the number of
    calls that visits each once."""
    it = itertools.cycle(copies)
    return (lambda: fn(next(it))), len(copies)


def check_quant_matmul(dev, gen, results):
    """B7 against its plain version at Llama-3-8B's projection shapes, M =
    2048 (the phase-8 forward's 4 x 512 tokens, the tensor-core variant) and
    M = 8 (decode, the split-K variant), bf16 x, and the FMA variant on the
    same bf16 inputs (the earlier design) and on f32 x at the three largest
    shapes; then int4-range codes, a ragged M/K/N and an f16 x. Times per
    32-layer forward (225 launches): each variant, the plain version, and
    the library yardstick cuBLAS ``x @ w_bf16`` with ``w`` dequantized ahead
    (untimed). At M = 8 the weights are cold (rotated over copies that
    exceed the L2) and the loop is a CUDA graph, for the kernels and for
    cuBLAS alike."""
    from accelerate_tpu_torch.ops import quant_matmul as qmm

    per_m = {}
    int8pack = 0.0
    fma_err = 0.0
    for m in (8, 2048):
        sums = dict(ms=0.0, fma_ms=0.0, plain_ms=0.0, library_ms=0.0, t_bytes=0.0, t_ops=0.0,
                    err=0.0, fma_err=0.0)
        for name, (k, n, per_layer) in B7_SHAPES.items():
            count = 1 if per_layer is None else per_layer * 32
            x, q, scales = b7_operands(gen, dev, m, k, n, torch.bfloat16)
            plan = qmm.qmm_plan(m, k, n, x.dtype)
            err = b7_error(x, q, scales, f"{name} {plan.kernel}")
            fma = qmm.QmmPlan("quant_matmul")
            f_err = b7_error(x, q, scales, f"{name} quant_matmul (FMA, the earlier design)", plan=fma)
            s32 = scales.float().contiguous()

            def run(plan_, w):
                return qmm._launch(plan_, x, w, s32, torch.empty((m, n), dtype=x.dtype, device=dev))

            w_bf16 = (q.float() * scales).to(torch.bfloat16)  # dequantized ahead, untimed
            if m == 8:  # bytes-bound: every timed loop reads cold weights, in a graph
                kern, nq = rotating(lambda w: run(plan, w), cold_copies(q))
                kern_fma, _ = rotating(lambda w: run(fma, w), cold_copies(q))
                lib, nw = rotating(lambda w: x @ w, cold_copies(w_bf16))
                iters = max(nq, nw, 20)
                ms, fma_ms, lib_ms = (time_graph_ms(fn, iters) for fn in (kern, kern_fma, lib))
            else:
                iters = 3 if m * n * k > 1e11 else 20
                ms, fma_ms, lib_ms = (time_ms(fn, iters=iters, repeats=3) for fn in (
                    lambda: run(plan, q), lambda: run(fma, q), lambda: x @ w_bf16))
            plain_ms = time_ms(lambda: qmm.quantized_matmul_plain(x, q, scales), iters=3, repeats=3)
            del w_bf16
            nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
            bms, by = bound_ms(nbytes, 2.0 * m * k * n, torch.bfloat16)
            extra = ""
            if m == 8 and int8pack is not None:
                pack_ms = time_int8pack(x, q, scales, iters)
                int8pack = None if pack_ms is None else int8pack + pack_ms * count
                if pack_ms is not None:
                    extra = f" torch._weight_int8pack_mm_ms={pack_ms:.4f} (warm weights)"
            for key, v in (("ms", ms), ("fma_ms", fma_ms), ("plain_ms", plain_ms),
                           ("library_ms", lib_ms), ("t_bytes", nbytes / HBM_BYTES_PER_S * 1e3),
                           ("t_ops", 2.0 * m * k * n / PEAK_FLOPS[torch.bfloat16] * 1e3)):
                sums[key] += v * count
            sums["err"] = max(sums["err"], err)
            sums["fma_err"] = max(sums["fma_err"], f_err)
            log(f"  {plan.kernel} ms={ms:.4f} (bound share {bms / ms:.4f}) FMA ms={fma_ms:.4f} "
                f"plain_ms={plain_ms:.4f} cublas_dequantized_ms={lib_ms:.4f} "
                f"(bound share {bms / lib_ms:.4f}){extra} bound_ms={bms:.5f} ({by}); {plan}; "
                f"{count} per 32-layer forward" + ("; cold weights" if m == 8 else ""))
            if name in ("gate_up", "down", "head"):  # f32 x keeps f32 products: the FMA kernel
                fma_err = max(fma_err, b7_error(x.float(), q, scales, f"{name} quant_matmul"))
            del x, q, scales, s32
            torch.cuda.empty_cache()
        per_m[m] = sums
    gen_case = [("int4_range", 2048, 4096, 14336, torch.bfloat16, 7),
                ("int4_range", 8, 4096, 14336, torch.bfloat16, 7),
                ("ragged", 7, 4100, 1000, torch.bfloat16, 127),
                ("ragged", 7, 4100, 1000, torch.float32, 127),
                ("ragged", 130, 4100, 1000, torch.bfloat16, 127),
                ("f16_x", 8, 4096, 14336, torch.float16, 127),
                ("f16_x", 2048, 4096, 4096, torch.float16, 127),
                ("edge_m", 17, 4096, 1024, torch.bfloat16, 127),
                ("edge_m", 65, 14336, 4096, torch.bfloat16, 127)]
    for label, m, k, n, dtype, qmax in gen_case:
        x, q, scales = b7_operands(gen, dev, m, k, n, dtype, qmax)
        b7_error(x, q, scales, f"{label} {qmm.qmm_plan(m, k, n, dtype).kernel}")
    # the f32 output of the LM head (the training and scoring forward's
    # logits): the same f32 sums times the scales, unrounded; each variant
    # at the head's shape, and the FMA one at a ragged shape
    f32_out = {}
    for m, k, n in ((2048, 4096, 128256), (8, 4096, 128256), (130, 4100, 1000)):
        plan = qmm.qmm_plan(m, k, n, torch.bfloat16)
        x, q, scales = b7_operands(gen, dev, m, k, n, torch.bfloat16)
        f32_out[plan.kernel] = b7_error(x, q, scales, f"f32_out {plan.kernel}",
                                        out_dtype=torch.float32)
        del x, q, scales
    torch.cuda.empty_cache()
    main, decode = per_m[2048], per_m[8]

    def bound(s):
        return (s["t_bytes"], "bytes") if s["t_bytes"] >= s["t_ops"] else (s["t_ops"], "operations")

    (bms, by), (dbms, dby) = bound(main), bound(decode)
    log(f"B7 per 32-layer forward (225 launches, bf16): M=2048 quant_matmul_mma {main['ms']:.3f} ms "
        f"(FMA {main['fma_ms']:.3f}), plain {main['plain_ms']:.3f} ms, cuBLAS on dequantized bf16 "
        f"{main['library_ms']:.3f} ms, bound {bms:.3f} ms ({by}): {main['ms'] / main['library_ms']:.3f}x "
        f"cuBLAS, bound share {bms / main['ms']:.4f}; M=8 (cold weights) quant_matmul_splitk "
        f"{decode['ms']:.3f} ms (FMA {decode['fma_ms']:.3f}), plain {decode['plain_ms']:.3f} ms, cuBLAS "
        f"{decode['library_ms']:.3f} ms, bound {dbms:.3f} ms ({dby}): "
        f"{decode['ms'] / decode['library_ms']:.3f}x cuBLAS, bound share {dbms / decode['ms']:.4f} "
        f"(cuBLAS {dbms / decode['library_ms']:.4f})"
        + (f"; torch._weight_int8pack_mm at M=8 {int8pack:.3f} ms" if int8pack else
           "; torch._weight_int8pack_mm not available on this card's torch"))
    common = dict(plain_ms=main["plain_ms"], bound_ms=bms, bound_by=by, library_ms=main["library_ms"])
    results["quant_matmul_mma"] = dict(
        max_abs_err=main["err"], ms=main["ms"], **common,
        f32_out_max_abs_err=f32_out["quant_matmul_mma"],
        shape="sum over one 32-layer Llama-3-8B forward's 225 launches at M = 2048, bf16 x")
    results["quant_matmul_splitk"] = dict(
        max_abs_err=decode["err"], f32_out_max_abs_err=f32_out["quant_matmul_splitk"],
        ms=decode["ms"], plain_ms=decode["plain_ms"], bound_ms=dbms,
        bound_by=dby, library_ms=decode["library_ms"], int8pack_ms=int8pack or None,
        shape="sum over one forward's 225 launches at M = 8, bf16 x, weights cold for the kernel "
              "and cuBLAS (int8pack warm)")
    results["quant_matmul"] = dict(
        max_abs_err=main["fma_err"], ms=main["fma_ms"], **common, f32_max_abs_err=fma_err,
        f32_out_max_abs_err=f32_out["quant_matmul"],
        decode_ms=decode["fma_ms"], decode_max_abs_err=decode["fma_err"],
        shape="the FMA variant (f32 x, unaligned rows) on the main path's bf16 work: sum over one "
              "forward's 225 launches at M = 2048 (decode_*: M = 8, cold weights)")


def time_int8pack(x, q, scales, iters):
    """ms of ``torch._weight_int8pack_mm`` (int8 weights as (N, K), scales
    in x's dtype) where this torch has it on CUDA, else None: a library call
    of the same function, timed as a yardstick only, at decode shapes (PR
    4 measured it at M = 2048: tens of seconds per forward's worth)."""
    op = getattr(torch, "_weight_int8pack_mm", None)
    if op is None:
        return None
    qt, s = q.t().contiguous(), scales.to(x.dtype)
    try:
        op(x, qt, s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        log(f"  torch._weight_int8pack_mm unavailable: {str(exc).splitlines()[0][:120]}")
        return None
    return time_ms(lambda: op(x, qt, s), iters=iters, repeats=3)


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
# speculative and phase 7 greedy checks: a token that is not the reference
# argmax must be a near-tie, within two bf16 ulps of logits of order 4
NEAR_TIE = 0.0625


def phase_engine_parity(dev, card):
    import dataclasses

    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.kvcache import PagedKVLayout
    from accelerate_tpu_torch.models.llama import (
        LlamaConfig, LlamaForCausalLM, llama_decode_step, llama_prefill_at,
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
        a, n, gap = teacher_forced(cfg_r, params, p, occ.tokens)
        agree, total, worst_gap = agree + a, total + n, max(worst_gap, gap)
    share = agree / total
    log(f"phase 3 greedy tokens (kernel engine, teacher-forced reference forward): "
        f"{agree}/{total} positions are the reference argmax (share {share:.3f}, min "
        f"{GREEDY_SHARE_MIN}); largest logit gap at the rest {worst_gap:.4f} (tol {LOGIT_TOL})")
    if not (share >= GREEDY_SHARE_MIN and worst_gap <= LOGIT_TOL):
        raise AssertionError("greedy tokens: kernel path disagrees with reference path")
    eng.reset()
    occs = [eng.insert(p, max_new_tokens=32) for p in prompts]
    verify_parity(cfg_k, params, eng, prompts)
    del eng, occs
    spec_engine_parity(dev, model, cfg_r, params)
    del model, params
    torch.cuda.empty_cache()


def teacher_forced(cfg_r, params, prompt, tokens):
    """(argmax agreements, positions, largest gap at the rest): the plain
    path's forward over prompt + output, teacher-forced; ``gap`` is how far
    the chosen token's logit sits below the reference argmax's."""
    from accelerate_tpu_torch.models.llama import llama_apply

    dev = params["embed_tokens"]["embedding"].device
    toks = torch.tensor(tokens, device=dev)
    seq = torch.cat([torch.from_numpy(prompt).to(dev).long(), toks[:-1].long()])[None]
    ref = llama_apply(cfg_r, params, seq)[0, len(prompt) - 1:]  # logits that chose each token
    chosen = ref.gather(1, toks.long()[:, None])[:, 0]
    gap = (ref.max(-1).values - chosen).max().item()
    return int((ref.argmax(-1) == toks).sum().item()), len(tokens), gap


def verify_parity(cfg, params, eng, prompts):
    """Verify-step logits through B5 against the plain verify path (W = 5
    with drafts; a 512-wide chunk), and decode and verify logits over an
    int8 copy of the pool through B4-int8/B5-int8 against the plain paths,
    from copies of the engine's pool after its prefills; then two planted
    faults in the kernel path that must exceed the limit."""
    from accelerate_tpu_torch.kvcache import PagedKVLayout, kv_quantize
    from accelerate_tpu_torch.models.llama import llama_decode_step, llama_verify_step
    from accelerate_tpu_torch.ops import paged_decode as pd

    dev = eng.device
    tables = eng._backend.device_tables()
    pos = eng._pos.clone()
    gen = torch.Generator(device=dev).manual_seed(3)
    drafts = torch.randint(0, cfg.vocab_size, (eng.slots, 4), generator=gen, device=dev)
    window = torch.cat([eng._carried["token"][:, None].long(), drafts], dim=1)
    int8_cache = {w: dict(zip(("q", "s"), kv_quantize(t))) for w, t in eng._cache.items()}
    # the chunk: slot 2's next 512 positions, one row
    slot = 2
    chunk = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen, device=dev)

    def layout(impl, tabs=tables):
        return PagedKVLayout(tabs, 16, cfg.compute_dtype, attention_impl=impl)

    def copy(cache):
        return {w: ({k: v.clone() for k, v in t.items()} if isinstance(t, dict) else t.clone())
                for w, t in cache.items()}

    def verify_logits(impl, cache=eng._cache):
        return llama_verify_step(cfg, params, copy(cache), window, pos, kv_layout=layout(impl))[0]

    def chunk_logits(impl):
        return llama_verify_step(cfg, params, copy(eng._cache), chunk, pos[slot: slot + 1],
                                 kv_layout=layout(impl, tables[slot: slot + 1]))[0]

    def decode_logits(impl, cache):
        return llama_decode_step(cfg, params, copy(cache), eng._carried["token"][:, None].long(),
                                 pos, kv_layout=layout(impl))[0]

    errs = {
        "verify W=5": (verify_logits("kernel") - verify_logits("reference")).abs().max().item(),
        "chunk W=512": (chunk_logits("kernel") - chunk_logits("reference")).abs().max().item(),
        "int8 decode": (decode_logits("kernel", int8_cache)
                        - decode_logits("reference", int8_cache)).abs().max().item(),
        "int8 verify W=5": (verify_logits("kernel", int8_cache)
                            - verify_logits("reference", int8_cache)).abs().max().item(),
    }
    log("phase 3 window logits, kernel path vs plain path: " + ", ".join(
        f"{k} max_abs_err={v:.4f}" for k, v in errs.items()) + f" (tol {LOGIT_TOL})")
    if not max(errs.values()) <= LOGIT_TOL:
        raise AssertionError("verify/int8 logits: kernel path disagrees with reference path")
    ref = verify_logits("reference")
    ref8 = decode_logits("reference", int8_cache)
    verify_kernel, decode_kernel = pd.paged_flash_verify, pd.paged_flash_decode

    def window_shifted(q, kp, vp, wk, wv, *a, **kw):  # query j sees key j+1
        return verify_kernel(q, kp, vp, wk.roll(-1, dims=1).contiguous(),
                             wv.roll(-1, dims=1).contiguous(), *a, **kw)

    def neighbour_scales(*a, k_scale=None, v_scale=None, **kw):  # position p reads p-1's scale
        return decode_kernel(*a, k_scale=k_scale.roll(1, dims=1).contiguous(),
                             v_scale=v_scale.roll(1, dims=1).contiguous(), **kw)

    try:
        pd.paged_flash_verify = window_shifted
        shift_err = (verify_logits("kernel") - ref).abs().max().item()
        pd.paged_flash_verify = verify_kernel
        pd.paged_flash_decode = neighbour_scales
        scale_err = (decode_logits("kernel", int8_cache) - ref8).abs().max().item()
    finally:
        pd.paged_flash_verify, pd.paged_flash_decode = verify_kernel, decode_kernel
    log(f"phase 3 planted faults: window mask shifted by one (query j sees key j+1) "
        f"max_abs_err={shift_err:.4f}, int8 scales read from the neighbouring position "
        f"max_abs_err={scale_err:.4f} (each must exceed {LOGIT_TOL})")
    if not (shift_err > LOGIT_TOL and scale_err > LOGIT_TOL):
        raise AssertionError("phase 3's logit tolerance cannot see a planted verify/int8 fault")


def drafter_prompts(rng, n, lo, hi, vocab):
    """``n`` prompts of ``lo``-``hi`` tokens, each a random 8-32-token unit
    tiled: the n-gram drafter's kind of traffic."""
    out = []
    for _ in range(n):
        unit = rng.integers(0, vocab, size=int(rng.integers(8, 33)))
        length = int(rng.integers(lo, hi + 1))
        out.append(np.tile(unit, -(-length // len(unit)))[:length].astype(np.int32))
    return out


def spec_engine_parity(dev, model, cfg_r, params):
    """A greedy spec engine (kernel path, 2 layers) on drafter-friendly
    prompts: its tokens pass the teacher-forced argmax check."""
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, slots=8, max_len=1024, prompt_bucket=512, kv_cache="paged",
                                   block_size=16, readback_lag=2, attention_impl="kernel",
                                   spec="ngram", device=dev)
    prompts = drafter_prompts(np.random.default_rng(5), 8, 64, 400, cfg_r.vocab_size)
    occs = [eng.insert(p, max_new_tokens=48) for p in prompts]
    eng.drain()
    spec = eng.stats()["spec"]
    agree = total = 0
    worst_gap = 0.0
    for p, occ in zip(prompts, occs):
        a, n, gap = teacher_forced(cfg_r, params, p, occ.tokens)
        agree, total, worst_gap = agree + a, total + n, max(worst_gap, gap)
    share = agree / total
    log(f"phase 3 greedy spec engine (kernel path): verify steps {spec['verify_steps']}, drafted "
        f"{spec['drafted']}, accepted {spec['accepted']}; {agree}/{total} tokens are the "
        f"teacher-forced reference argmax (share {share:.3f}, min {GREEDY_SHARE_MIN}); largest "
        f"gap at the rest {worst_gap:.4f} (near-tie limit {NEAR_TIE})")
    if not (spec["verify_steps"] > 0 and share >= GREEDY_SHARE_MIN and worst_gap <= NEAR_TIE):
        raise AssertionError("greedy spec engine: kernel path disagrees with reference path")


# ----------------------------------------------------------------- phase 4
def serving_model(dev, n_layers):
    """Llama-3-8B at full width, bf16, seeded random weights: the model
    phases 4 and 7 serve."""
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=n_layers, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16, attention_impl="flash")
    t0 = time.perf_counter()
    model = LlamaForCausalLM.from_seed(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f"phase 4 model: Llama-3-8B, {n_layers} layers, bf16, seeded random weights, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B params, "
        f"init {time.perf_counter() - t0:.1f}s")
    return model


def phase_main_path(dev, card, model):
    from accelerate_tpu_torch.models.llama import llama_prefill_at
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    cfg = model.config
    n_layers = cfg.num_hidden_layers
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
        "flash_fwd_mma": n_layers * n_req,
        "paged_decode_mma": n_layers * steps,
        "fused_sample": steps + n_req,
    }
    log(f"phase 4 decode steps {steps}")
    check_launches("phase 4", launches, expected)
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


PROFILE_GROUPS = ("paged_verify", "paged_decode", "fused_sample", "flash_fwd", "sort")
MATMUL_KEYS = ("gemm", "gemv", "cutlass", "sm90_", "cublas", "nvjet")


def profile_decode(eng, step_ms, card, n_steps=8, label="phase 4 decode",
                   out="profile_decode.txt"):
    """Device time per engine step by kernel group, from torch.profiler
    over ``n_steps`` steps; the busy share divides it by the unprofiled
    ``step_ms``. The full table goes to ``out`` in the output directory."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
        torch.cuda.synchronize()
    groups = dict.fromkeys((*PROFILE_GROUPS, "matmul", "other"), 0.0)
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        name = e.key.lower()
        for g in PROFILE_GROUPS:
            if g in name:  # paged_decode also names the int8 and tensor-core kernels
                groups[g] += us
                break
        else:
            groups["matmul" if any(t in name for t in MATMUL_KEYS) else "other"] += us
    per_step = {g: us / n_steps / 1e3 for g, us in groups.items()}
    device_ms = sum(per_step.values())
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out", out).write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    if device_ms == 0.0:
        log(f"{label} profile: the profiler recorded no device time (not measured)")
        return None
    log(f"{label} profile: device time {device_ms:.3f} ms/step of {step_ms:.3f} ms wall "
        f"(busy share {device_ms / step_ms:.3f}); by group ms/step "
        + ", ".join(f"{g}={v:.3f}" for g, v in per_step.items()) + f" [{card}]")
    return dict(device_ms_per_step=device_ms, busy_share=device_ms / step_ms, groups_ms=per_step)


# ----------------------------------------------------------------- phase 7
SPEC_SERVING = dict(engine_slots=8, engine_max_len=2048, engine_prompt_bucket=512,
                    engine_block_size=16, attention_impl="kernel", speculative="ngram",
                    spec_draft_len=4, engine_prefill_chunk=512, engine_readback_lag=2)
SPEC_NEW_TOKENS = 64


def spec_traffic(vocab):
    """12 drafter-friendly prompts of 64-512 tokens and 4 of 1,025-1,500
    random tokens (three 512-token chunks each), interleaved; even requests
    greedy, odd ones sampled."""
    rng = np.random.default_rng(0)
    short = drafter_prompts(rng, 12, 64, 512, vocab)
    long = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(1025, 1501, size=4)]
    return short[:3] + long[:1] + short[3:6] + long[1:2] + short[6:9] + long[2:3] + short[9:] + long[3:]


def serve_mix(dev, model, prompts, **overrides):
    """Serve ``prompts`` at once through InferenceServer with the phase 7
    config; launch counters reset just before the mix and read just after.
    Returns (results, wall s, launches, engine counter deltas, engine)."""
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    scfg = ServingConfig(**{**SPEC_SERVING, **overrides})
    with InferenceServer(model, scfg, device=dev) as srv:
        # warm-up: a single-shot and a chunked prompt, unrelated to the mix
        # (a shared prefix would skip the mix's chunks)
        vocab = model.config.vocab_size
        warm = [srv.submit(np.random.default_rng(1).integers(0, vocab, size=n).astype(np.int32),
                           max_new_tokens=8) for n in (64, 1100)]
        for f in warm:
            f.result(timeout=300)
        eng = srv.engine
        before = dict(steps=eng.steps, verify=eng.spec_verify_steps, chunks=eng.prefill_chunks,
                      inserted=eng.inserted, **{k: eng.stats()["spec"][k]
                                                for k in ("drafted", "accepted", "wasted")})
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            sampled = i % 2 == 1
            futs.append(srv.submit(
                p, max_new_tokens=SPEC_NEW_TOKENS, temperature=0.8 if sampled else 0.0,
                top_k=50 if sampled else None, top_p=0.9 if sampled else None, seed=i))
        results = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()
        spec = eng.stats()["spec"]
        delta = dict(steps=eng.steps - before["steps"],
                     verify=eng.spec_verify_steps - before["verify"],
                     chunks=eng.prefill_chunks - before["chunks"],
                     inserted=eng.inserted - before["inserted"],
                     **{k: spec[k] - before[k] for k in ("drafted", "accepted", "wasted")})
        hbm = eng.stats()["kv"]["hbm_bytes"]
    vocab = model.config.vocab_size
    for p, r in zip(prompts, results):
        new = r.tokens[len(p):]
        if r.tokens.shape != (len(p) + SPEC_NEW_TOKENS,) or not (r.tokens[: len(p)] == p).all():
            raise AssertionError("a result row has the wrong shape or prompt")
        if not ((new >= 0) & (new < vocab)).all():
            raise AssertionError("a generated token is out of the vocabulary")
    delta["hbm_bytes"] = hbm
    return results, wall, launches, delta, eng


def expected_launches(n_layers, delta, n_single, n_chunked, suffix=""):
    decode_steps = delta["steps"] - delta["verify"]
    return {
        "flash_fwd_mma": n_layers * n_single,
        "paged_decode" + suffix + "_mma": n_layers * decode_steps,
        "paged_verify" + suffix + "_mma": n_layers * (delta["verify"] + delta["chunks"]),
        "fused_sample": decode_steps + n_single + n_chunked,
    }


def check_launches(label, launches, expected):
    log(f"{label} launches during the mix: { {k: launches[k] for k in launches if launches[k]} }; "
        f"expected {expected}")
    for name, n in expected.items():
        if launches[name] <= 0 or launches[name] != n:
            raise AssertionError(f"kernel {name}: {launches[name]} launches on {label}, expected {n}")
    for name, n in launches.items():
        if name not in expected and n:
            raise AssertionError(f"kernel {name} launched {n} times on {label}, expected none")


def phase_spec_path(dev, card, model):
    """Phase 7: speculative decoding, chunked prefill and the int8 pool
    through InferenceServer on the phase-4 model; returns the launches of
    server A (paged pool) and server B (int8 pool) and the numbers."""
    import dataclasses

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    prompts = spec_traffic(cfg.vocab_size)
    is_long = [len(p) > SPEC_SERVING["engine_prompt_bucket"] for p in prompts]
    n_chunked = sum(is_long)
    n_single = len(prompts) - n_chunked
    results, wall_a, launches, delta, eng = serve_mix(dev, model, prompts, kv_cache="paged")
    expected = expected_launches(n_layers, delta, n_single, n_chunked)
    log(f"phase 7 A (paged, spec ngram/4, chunk 512): engine steps {delta['steps']} (verify "
        f"{delta['verify']}), chunks {delta['chunks']}, admissions {delta['inserted']}")
    check_launches("phase 7 A", launches, expected)
    if delta["chunks"] != 3 * n_chunked or delta["inserted"] != len(prompts):
        raise AssertionError(f"phase 7 A: {delta['chunks']} chunks for {n_chunked} long prompts")
    if not (delta["verify"] > 0 and delta["accepted"] > 0
            and delta["accepted"] + delta["wasted"] == delta["drafted"]):
        raise AssertionError(f"phase 7 A speculation counters are off: {delta}")
    gen_tokens = len(prompts) * SPEC_NEW_TOKENS
    ttft = {k: sorted(r.ttft_s for r, lg in zip(results, is_long) if lg == k) for k in (False, True)}
    spec = eng.stats()["spec"]
    accept_rate = delta["accepted"] / delta["drafted"]
    log(f"phase 7 A served {len(prompts)} requests ({n_single} drafter-friendly of 64-512 tokens, "
        f"{n_chunked} of 1,025-1,500 in 512-token chunks; {SPEC_NEW_TOKENS} new tokens each, half "
        f"sampled) in {wall_a:.3f}s: {gen_tokens / wall_a:.1f} generated tokens/s; TTFT short min/p50/max "
        f"{ttft[False][0]:.4f}/{ttft[False][len(ttft[False]) // 2]:.4f}/{ttft[False][-1]:.4f}s, "
        f"chunked {ttft[True][0]:.4f}/{ttft[True][len(ttft[True]) // 2]:.4f}/{ttft[True][-1]:.4f}s; "
        f"drafted {delta['drafted']}, accepted {delta['accepted']} (rate {accept_rate:.3f}), tokens "
        f"per slot and verify step {spec['tokens_per_step']:.3f} (engine lifetime) [{card}]")
    # every greedy request, teacher-forced through one plain-path forward:
    # each token that is not the reference argmax must be a near-tie; the
    # share of argmax tokens is held over all greedy requests together, as
    # in phase 3 (random weights at 32 layers leave many top-2 gaps within
    # the two paths' rounding, so one request's 64 tokens vary by chance)
    cfg_r = dataclasses.replace(cfg, attention_impl="xla")
    greedy = {}
    for i, (p, r) in enumerate(zip(prompts, results)):
        if i % 2 == 0:
            greedy[i] = teacher_forced(cfg_r, model.params, p, r.tokens[len(p):].tolist())
    share = sum(a for a, _, _ in greedy.values()) / sum(n for _, n, _ in greedy.values())
    worst_gap = max(g for _, _, g in greedy.values())
    log("phase 7 A greedy requests, teacher-forced plain-path forward (argmax tokens/tokens, "
        "largest gap at the rest): " + ", ".join(f"{i}: {a}/{n} {g:.4f}" for i, (a, n, g) in greedy.items())
        + f"; share {share:.3f} (min {GREEDY_SHARE_MIN}), largest gap {worst_gap:.4f} (near-tie "
        f"limit {NEAR_TIE})")
    if not (share >= GREEDY_SHARE_MIN and worst_gap <= NEAR_TIE):
        raise AssertionError("phase 7 greedy tokens: kernel path disagrees with the plain path")
    steady = spec_steady_state(eng, prompts, card)
    a_tokens = [r.tokens for r in results]
    a_launches = {k: launches[k] for k in expected}
    del eng, results
    torch.cuda.empty_cache()

    results, wall_b, launches, delta8, eng = serve_mix(dev, model, prompts, kv_cache="paged_int8")
    expected8 = expected_launches(n_layers, delta8, n_single, n_chunked, suffix="_int8")
    check_launches("phase 7 B", launches, expected8)
    agree = total = 0
    for i, (ta, r) in enumerate(zip(a_tokens, results)):
        if i % 2:
            continue
        new_a, new_b = ta[len(prompts[i]):], r.tokens[len(prompts[i]):]
        diverge = np.flatnonzero(new_a != new_b)
        agree += int(diverge[0]) if len(diverge) else len(new_a)
        total += len(new_a)
    log(f"phase 7 B (paged_int8, same mix): {gen_tokens / wall_b:.1f} generated tokens/s in "
        f"{wall_b:.3f}s; engine steps {delta8['steps']} (verify {delta8['verify']}), accepted "
        f"{delta8['accepted']}/{delta8['drafted']}; pool {delta8['hbm_bytes'] / 1e9:.3f} GB against "
        f"A's {delta['hbm_bytes'] / 1e9:.3f} GB; greedy tokens equal to A's up to the first "
        f"divergence: {agree}/{total} (information only) [{card}]")
    del eng, results
    torch.cuda.empty_cache()
    numbers = dict(
        tokens_per_s=gen_tokens / wall_a, wall_s=wall_a, counters=delta, acceptance_rate=accept_rate,
        tokens_per_verify_step=spec["tokens_per_step"],
        ttft_short_s=ttft[False], ttft_chunked_s=ttft[True], greedy_share=share,
        greedy_worst_gap=worst_gap, **steady,
        int8=dict(tokens_per_s=gen_tokens / wall_b, wall_s=wall_b, counters=delta8,
                  greedy_prefix_agreement=agree / total),
    )
    return a_launches, {k: launches[k] for k in expected8}, numbers


def spec_steady_state(eng, prompts, card):
    """Steady-state verify-step and decode-step ms at 8 slots, ms per
    512-token chunk, and a profile of verify steps, on phase 7 A's engine."""
    with torch.no_grad():
        eng.reset()
        for p in prompts:
            if len(p) <= 512 and eng.free_slots():
                eng.insert(p[:300], max_new_tokens=600)
        for _ in range(4):
            eng.step()
        verify_ms, decode_ms = [], []
        for _ in range(24):
            v0 = eng.spec_verify_steps
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            (verify_ms if eng.spec_verify_steps > v0 else decode_ms).append(
                (time.perf_counter() - t0) * 1e3)
            eng.poll()
        verify_med = statistics.median(verify_ms) if verify_ms else None
        profile = profile_decode(eng, verify_med, card, n_steps=4, label="phase 7 verify step",
                                 out="profile_verify.txt") if verify_med else None
        eng.set_spec_draft_limit(0)
        for _ in range(2):
            eng.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(16):
            eng.step()
            eng.poll()
        torch.cuda.synchronize()
        plain_decode_ms = (time.perf_counter() - t0) / 16 * 1e3
        eng.set_spec_draft_limit(eng.spec_draft_len)
        eng.reset()
        eng.set_prefill_chunk_limit(0)
        long = [p for p in prompts if len(p) > 1024][0]
        eng.insert(long, max_new_tokens=4)  # its first chunk runs here
        chunk_ms = []
        while eng.prefill_chunks_pending():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.prefill_step(limit=1)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
        eng.set_prefill_chunk_limit(1)
        eng.reset()
    log(f"phase 7 steady state at 8 slots (positions 300+): verify step median "
        f"{verify_med if verify_med is None else round(verify_med, 3)} ms over {len(verify_ms)} "
        f"steps, decode step (drafting off) {plain_decode_ms:.3f} ms/step, decode steps taken "
        f"between verify steps {len(decode_ms)}; 512-token chunk at offsets 512 and 1024: "
        + ", ".join(f"{x:.3f}" for x in chunk_ms) + f" ms [{card}]")
    return dict(verify_step_ms=verify_med, verify_steps_timed=len(verify_ms),
                decode_step_ms=plain_decode_ms, chunk_ms=chunk_ms, verify_profile=profile)


# ----------------------------------------------------------------- phase 8
Q_BATCH, Q_SEQ = 4, 512
Q_FORWARDS = 2  # timed forwards, after one warm-up
CKPT_LAYERS = 4


# phase 8's near-tie limit on its f32 logits, in bf16 ulps of the plain
# path's largest |logit| (NEAR_TIE is two such ulps of logits of order 4):
# on an H100 the sound path read 2 ulps on bf16-rounded logits and 2.13 in
# f32, the planted scale fault about 100; the limit is twice the sound
# reading
Q_NEAR_TIE_ULPS = 4.0


def greedy_agreement(logits, ref):
    """(share of positions whose argmax is ``ref``'s, largest gap at the
    rest, that gap in bf16 ulps of ``ref``'s largest |logit|): how far the
    chosen token's ``ref`` logit sits below ``ref``'s argmax, as in phase
    7's teacher-forced check."""
    chosen = logits.argmax(-1)
    share = (chosen == ref.argmax(-1)).float().mean().item()
    gap = (ref.max(-1).values - ref.gather(-1, chosen[..., None])[..., 0]).max().item()
    ulp = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)  # bf16: 8 significant bits
    return share, gap, gap / ulp


def projection_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for n, p in model.named_parameters()
               if "proj" in n or "lm_head" in n)


def phase_quantized(dev, card, model):
    """Phase 8 (a): the phase-4 model (32 layers, bf16) quantized to int8 in
    place; its forward over 4 x 512 tokens runs each projection through B7
    and attention through B1. Returns (launches, numbers)."""
    from accelerate_tpu_torch.models.llama import llama_apply
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.ops import quant_matmul as qmm
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig, dequantize_leaf, quantize_model,
    )

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, size=(Q_BATCH, Q_SEQ))).to(dev)
    bf16_bytes = projection_bytes(model)
    logits_bf16 = model(ids)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quantize_model(model, QuantizationConfig(load_in_8bit=True))
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    int8_bytes = sum(b.numel() * b.element_size() for _, b in model.named_buffers())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model(ids)  # warm-up
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(Q_FORWARDS):
        logits_q = model(ids)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = {"quant_matmul_mma": (7 * n_layers + 1) * Q_FORWARDS,
                "flash_fwd_mma": n_layers * Q_FORWARDS}
    check_launches("phase 8 (7 B7 launches a layer + the head's, whose output is f32)",
                   launches, expected)
    if (logits_q.shape != (Q_BATCH, Q_SEQ, cfg.vocab_size) or logits_q.dtype != torch.float32
            or not torch.isfinite(logits_q).all()):
        raise AssertionError("quantized logits are not finite f32 of the expected shape")

    # the plain path: the same model with B7's plain version in place of
    # the kernel (the same function; the f32 sums run in another order),
    # attention through B1 on both sides; held as phase 7 holds its greedy
    # tokens. A planted fault (each output column scaled by its neighbour's
    # scale) must fail the same check.
    kernel = qmm.quantized_matmul

    def logits_with(matmul):
        qmm.quantized_matmul = matmul
        try:
            return model(ids)
        finally:
            qmm.quantized_matmul = kernel

    logits_p = logits_with(qmm.quantized_matmul_plain)
    share, gap, gap_ulps = greedy_agreement(logits_q, logits_p)
    log(f"phase 8 kernel path (B7) vs plain path (B7's plain version), int8 Llama-3-8B {n_layers} "
        f"layers, {Q_BATCH} x {Q_SEQ} tokens: argmax share {share:.4f} (min {GREEDY_SHARE_MIN}), "
        f"largest gap at the rest {gap:.4f} = {gap_ulps:.3f} bf16 ulps of the largest |logit| "
        f"{logits_p.abs().max().item():.4f} (near-tie limit {Q_NEAR_TIE_ULPS} ulps); max |logit diff| "
        f"{(logits_q - logits_p).abs().max().item():.4f}")
    if not (share >= GREEDY_SHARE_MIN and gap_ulps <= Q_NEAR_TIE_ULPS):
        raise AssertionError("phase 8: the quantized kernel path disagrees with the plain path")
    bad_share, bad_gap, bad_ulps = greedy_agreement(logits_with(
        lambda x, q, sc, out_dtype=None: kernel(x, q, sc.reshape(-1).roll(1).contiguous(),
                                                out_dtype=out_dtype)), logits_p)
    log(f"phase 8 planted fault (each output column scaled by its neighbour's scale): argmax share "
        f"{bad_share:.4f}, largest gap {bad_gap:.4f} = {bad_ulps:.3f} bf16 ulps (the check must fail)")
    if bad_share >= GREEDY_SHARE_MIN and bad_ulps <= Q_NEAR_TIE_ULPS:
        raise AssertionError("phase 8's check cannot see neighbouring scales")
    # the JAX package's way, information only: every leaf dequantized to
    # bf16 (each weight rounded to bf16, which the kernel path never does),
    # then the float forward
    plain_params = map_tree(dequantize_leaf, model.params)
    deq_share, deq_gap, deq_ulps = greedy_agreement(logits_q, llama_apply(cfg, plain_params, ids))
    del plain_params
    log(f"phase 8 kernel path vs dequantize-then-bf16-matmul path (information only): argmax share "
        f"{deq_share:.4f}, largest gap at the rest {deq_gap:.4f} = {deq_ulps:.3f} bf16 ulps")

    agree_bf16 = (logits_q.argmax(-1) == logits_bf16.argmax(-1)).float().mean().item()
    diff = (logits_q - logits_bf16).abs()
    ms = wall / Q_FORWARDS * 1e3
    tokens_per_s = Q_BATCH * Q_SEQ / (ms / 1e3)
    log(f"phase 8 int8 vs bf16 (information only): argmax agreement {agree_bf16:.4f}, |logit diff| max "
        f"{diff.max().item():.4f} mean {diff.mean().item():.5f}; projection weights {int8_bytes / 1e9:.3f} GB "
        f"int8 + scales against {bf16_bytes / 1e9:.3f} GB bf16 ({int8_bytes / bf16_bytes:.4f}); quantize_model "
        f"{quant_s:.2f}s; {ms:.1f} ms per forward, {tokens_per_s:.0f} scored tokens/s, peak memory "
        f"{peak / 1e9:.2f} GB [{card}]")
    del logits_bf16, logits_p, diff
    profile = profile_forward(model, ids, ms, card)
    return {k: launches[k] for k in expected}, dict(
        ms_per_forward=ms, tokens_per_s=tokens_per_s, peak_memory_bytes=peak, quantize_s=quant_s,
        int8_projection_bytes=int8_bytes, bf16_projection_bytes=bf16_bytes, greedy_share=share,
        greedy_worst_gap=gap, greedy_worst_gap_ulps=gap_ulps, planted_fault_share=bad_share,
        planted_fault_gap=bad_gap, planted_fault_gap_ulps=bad_ulps,
        dequantize_path_share=deq_share, dequantize_path_gap=deq_gap,
        argmax_agreement_with_bf16=agree_bf16, profile=profile)


def map_tree(fn, tree):
    return {k: map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def profile_forward(model, ids, ms, card):
    """Busy share of one profiled quantized forward (union of the kernels'
    intervals over its wall) and device time by group."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(ids)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    Path("chiprun_out").mkdir(exist_ok=True)
    Path("chiprun_out/profile_quantized.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=30))
    events = device_events(prof, "chiprun_out/trace_quantized.json")
    if not events:
        log("phase 8 profile: the profiler recorded no device time (not measured)")
        return None
    groups = dict.fromkeys(("quant_matmul", "flash_fwd", "other"), 0.0)
    for name, _, dur in events:
        lower = name.lower()
        groups[next((g for g in ("quant_matmul", "flash_fwd") if g in lower), "other")] += dur / 1e3
    busy = busy_us(events) / 1e3
    log(f"phase 8 forward profile: kernels busy {busy:.1f} ms of the profiled forward's {wall_ms:.1f} ms "
        f"(busy share {busy / wall_ms:.3f}; unprofiled {ms:.1f} ms); by group ms "
        + ", ".join(f"{g}={v:.1f}" for g, v in groups.items()) + f" [{card}]")
    return dict(busy_ms=busy, profiled_wall_ms=wall_ms, busy_share=busy / wall_ms, groups_ms=groups)


def phase_checkpoint(dev, card):
    """Phase 8 (b): Llama-3-8B at full width and 4 layers, seeded bf16
    weights, written with the port's safetensors writer in 1 GB shards, then
    loaded into a model built under init_empty_weights and quantized; the
    int8 bytes and the logits must equal quantize_model's on the in-memory
    copy, bitwise."""
    import os
    import tempfile

    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, create_llama
    from accelerate_tpu_torch.utils.quantization import (
        QuantizationConfig, load_and_quantize_model, quantize_model,
    )
    from accelerate_tpu_torch.utils.serialization import save_sharded_safetensors

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=CKPT_LAYERS, param_dtype=torch.bfloat16,
                                compute_dtype=torch.bfloat16, attention_impl="flash")
    qcfg = QuantizationConfig(load_in_8bit=True)
    src = LlamaForCausalLM.from_seed(cfg, seed=4, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        files = save_sharded_safetensors(src.params, tmp, max_shard_size="1GB")
        write_s = time.perf_counter() - t0
        nbytes = sum(os.path.getsize(f) for f in files)
        torch.cuda.reset_peak_memory_stats()
        with init_empty_weights():
            loaded = create_llama(cfg, seed=0, device=dev)
        if not all(p.is_meta for p in loaded.parameters()):
            raise AssertionError("init_empty_weights left a parameter off the meta device")
        t0 = time.perf_counter()
        load_and_quantize_model(loaded, tmp, qcfg, device=dev)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    quantize_model(src, qcfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    got, want = dict(loaded.named_buffers()), dict(src.named_buffers())
    same = sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    same = same and all(torch.equal(p, src.get_parameter(n)) for n, p in loaded.named_parameters())
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 256))).to(dev)
    logits_equal = torch.equal(loaded(ids), src(ids))
    log(f"phase 8 checkpoint (Llama-3-8B width, {CKPT_LAYERS} layers, bf16): {len(files)} files, "
        f"{nbytes / 1e9:.3f} GB written in {write_s:.2f}s ({nbytes / write_s / 1e9:.2f} GB/s); "
        f"load_and_quantize_model into an empty model {read_s:.2f}s ({nbytes / read_s / 1e9:.2f} GB/s of "
        f"checkpoint; quantize_model alone {quant_s:.2f}s), peak memory {peak / 1e9:.2f} GB; int8 bytes "
        f"and leaves equal to the in-memory quantization: {same}; logits bitwise equal: {logits_equal} "
        f"[{card}]")
    if not (same and logits_equal and len(files) > 1):
        raise AssertionError("phase 8: load-then-quantize differs from quantizing in memory")
    del src, loaded
    torch.cuda.empty_cache()
    return dict(files=len(files), checkpoint_bytes=nbytes, write_s=write_s, load_quantize_s=read_s,
                quantize_s=quant_s, peak_memory_bytes=peak)


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
    from accelerate_tpu_torch.ops import _build
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

    _build.reset_launch_counts()
    loss_k, grads_k = loss_and_grads(cfg_k)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    n_layers = cfg_k.num_hidden_layers
    # f32: the FMA forward; remat runs it twice
    check_launches("phase 5", launches, {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
                                         "flash_bwd_dkv": n_layers})
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
    counts = {k: launches[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    return counts, dict(loss_rel_err=loss_err, grad_rel_err=grad_err, planted_fault_rel_err=bad_err)


# ----------------------------------------------------------------- phase 6
# 32 layers of f32 weights, gradients and AdamW moments (128 GB) do not fit
# one card; 4 layers at full width hold 30.8 GB of that state
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
TRAIN_WARMUP, TRAIN_STEPS = 2, 8
PEAK_MEMORY_LIMIT = 75e9


def phase_train_main_path(dev, card, ablate=False):
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
    expected = {"flash_fwd_mma": 2 * TRAIN_LAYERS * TRAIN_STEPS,
                "flash_bwd_dq_mma": TRAIN_LAYERS * TRAIN_STEPS,
                "flash_bwd_dkv_mma": TRAIN_LAYERS * TRAIN_STEPS}
    check_launches(f"phase 6 ({TRAIN_STEPS} steps; remat runs the forward twice)", launches, expected)
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
    ablation = step_ablation(step_fn, batch, card) if ablate else None
    del model, optimizer, step_fn, batch, loader
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expected}, dict(
        losses=losses, step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu, peak_memory_bytes=peak,
        batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, layers=TRAIN_LAYERS, profile=profile,
        ablation_ms=ablation)


ABLATION_STEPS = 3


def step_ablation(step_fn, batch, card):
    """Step ms on the same model with the f32 head and the tensor-core
    B2/B3 each taken back: the bf16-rounded head (the serving steps' head,
    which ``llama_apply`` used before) and the FMA B2/B3 on bf16. Four
    configurations in turns, A B C D D C B A, ``ABLATION_STEPS`` timed steps
    each after one untimed, so the two changes are told apart in one call
    (``--step-ablation``)."""
    from accelerate_tpu_torch.models import llama
    from accelerate_tpu_torch.ops.flash_attention import flash_bwd_kernel_for

    head, mma, fma = llama._head, flash_bwd_kernel_for(torch.bfloat16), flash_bwd_kernel_for(
        torch.float32)
    configs = {
        "bf16 head + FMA B2/B3": (llama._serving_head, fma),
        "f32 head + FMA B2/B3": (head, fma),
        "bf16 head + tensor-core B2/B3": (llama._serving_head, mma),
        "f32 head + tensor-core B2/B3": (head, mma),
    }
    times = {name: [] for name in configs}
    try:
        for name in [*configs, *reversed(configs)]:
            llama._head, kernels = configs[name]
            with bwd_kernels(kernels):
                step_fn(batch)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(ABLATION_STEPS):
                    step_fn(batch)
                torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / ABLATION_STEPS * 1e3)
    finally:
        llama._head = head
    log("phase 6 step ms, configurations in turns (A B C D D C B A, "
        f"{ABLATION_STEPS} steps each): "
        + "; ".join(f"{n} {t[0]:.1f} / {t[1]:.1f}" for n, t in times.items()) + f" [{card}]")
    return times


# kernel name fragments by group; the first match wins, so each tensor-core
# variant comes before the FMA name it contains
TRAIN_GROUPS = (
    ("flash_fwd", ("flash_fwd",)),
    ("flash_bwd_dq_mma", ("flash_bwd_dq_mma",)),
    ("flash_bwd_dkv_mma", ("flash_bwd_dkv_mma",)),
    ("flash_bwd_dq", ("flash_bwd_dq",)),
    ("flash_bwd_dkv", ("flash_bwd_dkv",)),
    ("matmul", ("gemm", "gemv", "cutlass", "sm90_", "cublas", "nvjet")),
    ("optimizer", ("multi_tensor", "adam")),
)


def device_events(prof, path="chiprun_out/trace_train.json"):
    """(name, start_us, dur_us) of every kernel, memcpy and memset in a
    profile, from its Chrome trace (written to ``path``): annotation ranges
    (such as ``Optimizer.step``) and host-side entries are left out."""
    path = Path(path)
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


# dynamic shared memory of the tensor-core kernels' configurations (the
# sources' MmaCfg): name fragment of the ptxas entry -> bytes per block, or
# (bytes, threads) where a block is not 128 threads
MMA_SMEM = {
    "quant_matmul_mma_kernel<128": 4 * (128 * 128 + 64 * 128),
    "quant_matmul_mma_kernel<64": 4 * (64 * 128 + 64 * 128),
    "quant_matmul_mma_kernel<16": 4 * (16 * 128 + 64 * 128),
    "flash_fwd_mma_kernel<128,1": 64 * 256 + 2 * (2 * 64 * 256 + 256),
    "flash_fwd_mma_kernel<128,2": 128 * 256 + 2 * (2 * 64 * 256 + 256),
    "flash_fwd_mma_kernel<64,1": 64 * 128 + 2 * (2 * 64 * 128 + 256),
    "flash_fwd_mma_kernel<64,2": 128 * 128 + 2 * (2 * 64 * 128 + 256),
    # flash_bwd.cu's DqCfg (Q, dO, two stages of K, V and kv segment ids)
    # and DkvCfg (K, V, two stages of Q, dO, lse, delta, q segment ids)
    "flash_bwd_dq_mma_kernel<128": 2 * 64 * 256 + 2 * (2 * 64 * 256 + 256),
    "flash_bwd_dq_mma_kernel<64": 2 * 64 * 128 + 2 * (2 * 64 * 128 + 256),
    "flash_bwd_dkv_mma_kernel<128": 2 * 64 * 256 + 2 * (2 * 64 * 256 + 3 * 64 * 4),
    "flash_bwd_dkv_mma_kernel<64": 2 * 64 * 128 + 2 * (2 * 64 * 128 + 3 * 64 * 4),
    # paged_verify.cu's VCfg<D, warps, keys, int8> (Q, two stages of K, V
    # and, for an int8 pool, the raw int8 K, V and their scales), with its
    # threads; fused_sample.cu's two f32 slices of 8,016 (V = 128,256)
    "paged_verify_mma_kernel<128,2,32,0": (32 * 256 + 2 * (2 * 32 * 256), 64),
    "paged_verify_mma_kernel<128,2,32,1": (32 * 256 + 2 * (2 * 32 * 256 + 2 * 32 * 128 + 256), 64),
    "paged_verify_mma_kernel<128,4,64,0": (64 * 256 + 2 * (2 * 64 * 256), 128),
    "paged_verify_mma_kernel<128,4,64,1": (64 * 256 + 2 * (2 * 64 * 256 + 2 * 64 * 128 + 512), 128),
    "paged_verify_mma_kernel<64,2,32,0": (32 * 128 + 2 * (2 * 32 * 128), 64),
    "paged_verify_mma_kernel<64,2,32,1": (32 * 128 + 2 * (2 * 32 * 128 + 2 * 32 * 64 + 256), 64),
    "paged_verify_mma_kernel<64,4,64,0": (64 * 128 + 2 * (2 * 64 * 128), 128),
    "paged_verify_mma_kernel<64,4,64,1": (64 * 128 + 2 * (2 * 64 * 128 + 2 * 64 * 64 + 512), 128),
    "fused_sample_kernel": (2 * 8016 * 4, 256),
    # paged_decode.cu's DCfg<D, int8> (a ring of 3 stages of 64-key K and V
    # tiles; int8: raw tiles and their scales, and one widened bf16 pair)
    "paged_decode_mma_kernel<128,0": (3 * 2 * 64 * 256, 128),
    "paged_decode_mma_kernel<128,1": (3 * (2 * 64 * 128 + 512) + 2 * 64 * 256, 128),
    "paged_decode_mma_kernel<64,0": (3 * 2 * 64 * 128, 128),
    "paged_decode_mma_kernel<64,1": (3 * (2 * 64 * 64 + 512) + 2 * 64 * 128, 128),
}


def ptxas_report(text):
    """One entry per kernel of an ``nvcc -Xptxas -v`` log: its name with
    the template's integer arguments, registers, spills, static shared
    memory and, for the tensor-core kernels, the dynamic shared memory and
    the blocks per SM that registers and shared memory allow."""
    import re

    entries, name = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            # _Z[N]<len><identifier>...: the last identifier is the kernel's
            i, ident = (3 if mangled.startswith("_ZN") else 2), mangled[:40]
            while i < len(mangled) and mangled[i].isdigit():
                j = i + len(re.match(r"\d+", mangled[i:]).group())
                ident, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
            args = re.findall(r"L[ib](\d+)E", mangled)
            kind = next((t for t in ("__nv_bfloat16", "__half") if t in mangled), "")
            name = ident + "<" + ",".join(args) + (
                ("," + kind) if kind else "") + ">"
            spill = ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and name:
            regs = int(m.group(1))
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            entry = f"{name} {regs} regs {spill}" + (f" smem {smem.group(1)} B" if smem else "")
            dyn = next((v for k, v in MMA_SMEM.items() if name.startswith(k)), None)
            if dyn is not None:
                dyn, threads = dyn if isinstance(dyn, tuple) else (dyn, 128)
                static = int(smem.group(1)) if smem else 0
                per_sm = min(65536 // (regs * threads), 233472 // (dyn + static + 1024))
                entry += f" dynamic smem {dyn} B, {per_sm} blocks/SM"
            entries.append(entry)
            name = None
    return entries


KERNEL_META = {
    "flash_fwd": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/flash_fwd.cu",
        replaces="accelerate_tpu/ops/flash_attention.py:98",
    ),
    "flash_fwd_mma": dict(
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
    "flash_bwd_dq_mma": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/flash_bwd.cu",
        replaces="accelerate_tpu/ops/flash_attention.py:236",
    ),
    "flash_bwd_dkv_mma": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/flash_bwd.cu",
        replaces="accelerate_tpu/ops/flash_attention.py:281",
    ),
    "paged_decode": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_decode.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:87",
    ),
    "paged_decode_int8": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_decode.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:87",
    ),
    "paged_decode_mma": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_decode.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:87",
    ),
    "paged_decode_int8_mma": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_decode.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:87",
    ),
    "paged_verify": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_verify.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:222",
    ),
    "paged_verify_int8": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_verify.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:222",
    ),
    "paged_verify_mma": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_verify.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:222",
    ),
    "paged_verify_int8_mma": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/paged_verify.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:222",
    ),
    "fused_sample": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/fused_sample.cu",
        replaces="accelerate_tpu/ops/paged_decode.py:390",
    ),
    "quant_matmul": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/quant_matmul.cu",
        replaces="accelerate_tpu/ops/quant_matmul.py:33",
    ),
    "quant_matmul_mma": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/quant_matmul.cu",
        replaces="accelerate_tpu/ops/quant_matmul.py:33",
    ),
    "quant_matmul_splitk": dict(
        route="cuda", source="accelerate_tpu_torch/csrc/quant_matmul.cu",
        replaces="accelerate_tpu/ops/quant_matmul.py:33",
    ),
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels", action="store_true",
                        help="build and check the kernels only (phases 1-2)")
    parser.add_argument("--layers", type=int, default=32,
                        help="depth of the serving main path's model (default: the full 32)")
    parser.add_argument("--step-ablation", action="store_true",
                        help="also time phase 6's step with the f32 head and the tensor-core "
                             "B2/B3 each taken back, four configurations in turns")
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
        log(f"  ptxas {name}: " + "; ".join(ptxas_report(text)))

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    with torch.no_grad():
        check_flash(dev, gen, results)
        check_flash_bwd(dev, gen, results)
        check_paged_decode(dev, gen, results)
        check_paged_verify(dev, gen, results)
        check_fused_sample(dev, gen, results)
        check_quant_matmul(dev, gen, results)
    launches = dict.fromkeys(KERNEL_META, 0)
    by_path = {}
    summary = {"card": card, "build_s": secs}
    if not args.kernels:
        with torch.no_grad():
            phase_engine_parity(dev, card)
            model = serving_model(dev, args.layers)
            by_path["serving"], summary["main_path"] = phase_main_path(dev, card, model)
            by_path["serving_spec"], by_path["serving_int8"], summary["spec_path"] = (
                phase_spec_path(dev, card, model))
            by_path["quantized"], summary["quantized_path"] = phase_quantized(dev, card, model)
            del model
            torch.cuda.empty_cache()
            summary["checkpoint"] = phase_checkpoint(dev, card)
        torch.cuda.empty_cache()
        by_path["training_f32"], summary["train_parity"] = phase_train_parity(dev, card)
        by_path["training"], summary["train_main_path"] = phase_train_main_path(
            dev, card, ablate=args.step_ablation)
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
