"""Times Llama training under the layout the launcher gives (tensor
parallelism, FSDP2, HSDP, DDP): Llama-3-8B's widths, weights drawn from a
seed, bf16 compute over f32 master weights, ``llama_loss``, AdamW and
``max_grad_norm=1.0`` through ``Accelerator.train_step``, one global batch
of seeded token ids repeated on every step:

    python -m accelerate_tpu_torch.commands.launch --num_processes 4 --tp_size 4 \\
        accelerate_tpu_torch/test_utils/scripts/train_timing.py --layers 32

A global batch of 4 rows, 2 untimed warm-up steps, then 8 timed ones
(host clock around steps that end in a synchronise), then a profiled pair
(``torch.profiler``): the main process prints one JSON line (also written
under ``chiprun_out/``) with the card's name and power limit, the mesh,
step ms (and the host's ms to issue a step: near the step's, the step
waits on the host), tokens/s (the global batch's tokens over the step),
MFU (``llama_flops_per_token`` over every card's 989 TFLOP/s bf16 peak),
every rank's peak memory while it trains (and while the whole seeded model
was drawn on it, before ``prepare`` split it), rank 0's device busy share
twice (``busy_share_with_nccl`` counts the NCCL kernels as busy, and their
time includes the wait for the slowest rank; ``compute_busy_share`` leaves
them out), the NCCL kernels' device ms a step, the flash kernels' launches
per step and the losses; rank 0's profile tables, by host and by device
time, go to ``chiprun_out/``. ``--preset tiny --cpu`` rehearses it on gloo
ranks: its times say nothing of a card.

``--mixed_precision fp8`` runs the projections through ``ops/fp8.py``
(``torch._scaled_mm`` on e4m3 operands, scales all-reduced over the mesh)
and adds MFU over the 1,979 TFLOP/s fp8 peak, the amax all-reduces a step
(counted on the model's ``Fp8Groups``), the device ms of the kernels
launched inside the ``fp8_quantize`` ranges (the quantize passes, their
NCCL all-reduces apart) and of the ``fp8_layout`` copies, from rank 0's
profile; the JSON line's file name ends in ``_fp8``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

PEAK_BF16 = 989e12  # H100 SXM, dense, at its 700 W limit
PEAK_FP8 = 1979e12
BATCH, WARMUP, STEPS, PROFILE_STEPS = 4, 2, 8, 2  # global rows a step; steps
OUT = "chiprun_out"


def card_line() -> str:
    """``name, power limit`` as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def _union_us(events) -> float:
    """The time (us) some event of ``(name, ts, dur)`` runs."""
    busy, end = 0.0, float("-inf")
    for _, ts, dur in sorted(events, key=lambda e: e[1]):
        if ts + dur > end:
            busy += ts + dur - max(ts, end)
            end = ts + dur
    return busy


def _range_ms(trace_events, steps: int) -> dict:
    """Device ms a step of the kernels launched inside the ``fp8_quantize``
    and ``fp8_layout`` profiler ranges (``ops.fp8.kernels_in_ranges``), the
    quantize ranges' NCCL kernels (the amax all-reduces) apart."""
    from accelerate_tpu_torch.ops.fp8 import kernels_in_ranges

    ranges = kernels_in_ranges(trace_events)
    quantize = ranges["fp8_quantize"]
    return {"fp8_quantize": sum(ms for n, ms in quantize if "nccl" not in n.lower()) / steps,
            "fp8_amax_all_reduce": sum(ms for n, ms in quantize if "nccl" in n.lower()) / steps,
            "fp8_layout": sum(ms for _, ms in ranges["fp8_layout"]) / steps}


def _busy_and_nccl_ms(prof, steps: int, trace: str) -> tuple:
    """(busy us with the NCCL kernels, busy us without them, NCCL kernels'
    device ms a step, device ms a step, the fp8 ranges' device ms a step)
    from the profile's Chrome trace."""
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        trace_events = json.load(f)["traceEvents"]
    events = [(e["name"], float(e["ts"]), float(e["dur"])) for e in trace_events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    if not events:
        return None, None, None, None, None
    compute = [e for e in events if "nccl" not in e[0].lower()]
    nccl = sum(d for n, _, d in events if "nccl" in n.lower())
    return (_union_us(events), _union_us(compute), nccl / 1e3 / steps,
            sum(d for _, _, d in events) / 1e3 / steps, _range_ms(trace_events, steps))


def main(argv=None) -> dict:
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.model import unwrap_model
    from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama, llama_flops_per_token, llama_loss
    from accelerate_tpu_torch.ops import _build

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="llama3_8b", choices=["llama3_8b", "mixtral_8x7b", "tiny"])
    p.add_argument("--num_experts", type=int, default=None,
                   help="the preset's MoE experts (e.g. 4 with --preset tiny to rehearse --ep_size)")
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--mixed_precision", default="bf16", choices=["bf16", "fp8"])
    args = p.parse_args(argv)

    fp8 = args.mixed_precision == "fp8"
    # the CPU rehearsal keeps f32 compute (no bf16 there); fp8 runs on either
    acc = Accelerator(mixed_precision="fp8" if fp8 else None if args.cpu else "bf16", cpu=args.cpu)
    make = getattr(LlamaConfig, args.preset)
    cfg = make(num_hidden_layers=args.layers, attention_impl="flash",
               **({"compute_dtype": torch.float32} if args.cpu else {}),
               **({} if args.num_experts is None else {"num_experts": args.num_experts}))
    pcfg = acc.parallelism_config
    dp = pcfg.data_parallel_size
    if BATCH % dp:
        raise ValueError(f"the global batch of {BATCH} rows does not split over {dp} data-parallel ranks")
    sync = torch.cuda.synchronize if acc.device.type == "cuda" else (lambda: None)
    if acc.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = create_llama(cfg, seed=0, device=acc.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    model, optimizer = acc.prepare(model, optimizer)
    step = acc.train_step(llama_loss, max_grad_norm=1.0)
    rng = np.random.default_rng(0)
    data = {"input_ids": rng.integers(0, cfg.vocab_size, size=(BATCH, args.seq)).astype(np.int32)}
    batch = next(iter(acc.prepare_data_loader(data, batch_size=BATCH // dp, drop_last=True)))
    sync()
    init_s = time.perf_counter() - t0
    init_peak = 0
    if acc.device.type == "cuda":  # the training's own peak from here on
        init_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    groups = getattr(unwrap_model(model), "fp8_groups", None)
    losses = [step(batch) for _ in range(WARMUP)]
    sync()
    _build.reset_launch_counts()
    reductions = groups.reductions if groups is not None else 0
    t0 = time.perf_counter()
    losses += [step(batch) for _ in range(STEPS)]
    host = time.perf_counter() - t0  # the host's time to issue the steps
    sync()
    wall = time.perf_counter() - t0
    launches = {k: v / STEPS for k, v in _build.launch_counts().items() if v}
    amax_per_step = (groups.reductions - reductions) / STEPS if groups is not None else None
    busy = compute_busy = nccl_ms = device_ms = fp8_ms = None
    if acc.device.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(OUT, exist_ok=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync()
            p0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                step(batch)
            sync()
            p_wall = (time.perf_counter() - p0) * 1e6
        if acc.is_main_process:
            name = f"{acc.layout}_{args.layers}l" + ("_fp8" if fp8 else "")
            trace = os.path.join(OUT, f"trace_timing_{name}.json")
            busy_us, compute_us, nccl_ms, device_ms, fp8_ms = _busy_and_nccl_ms(
                prof, PROFILE_STEPS, trace)
            os.remove(trace)  # tens of MB a run; the tables below keep what it showed
            if busy_us is not None:
                busy, compute_busy = busy_us / p_wall, compute_us / p_wall
            with open(os.path.join(OUT, f"profile_timing_{name}.txt"), "w") as f:
                for key in ("self_cpu_time_total", "self_device_time_total"):
                    f.write(prof.key_averages().table(sort_by=key, row_limit=40) + "\n")
    peak = torch.cuda.max_memory_allocated() if acc.device.type == "cuda" else 0
    peaks = acc.state.gather_object(peak)
    init_peaks = acc.state.gather_object(init_peak)
    step_ms = wall / STEPS * 1e3
    tokens_per_s = BATCH * args.seq * STEPS / wall
    result = dict(
        card=card_line() if acc.device.type == "cuda" else "cpu (rehearsal; no device time)",
        layout=acc.layout, mesh={a: s for a, s in pcfg.axis_sizes.items() if s > 1} or {"world": 1},
        world=acc.num_processes, layers=args.layers, batch=BATCH, seq=args.seq,
        init_s=init_s, steps=STEPS, step_ms=step_ms,
        host_ms_per_step=host / STEPS * 1e3,
        tokens_per_s=tokens_per_s,
        mixed_precision=args.mixed_precision,
        mfu=tokens_per_s * llama_flops_per_token(cfg, args.seq) / (PEAK_BF16 * acc.num_processes),
        mfu_fp8_peak=(tokens_per_s * llama_flops_per_token(cfg, args.seq)
                      / (PEAK_FP8 * acc.num_processes)) if fp8 else None,
        amax_all_reduces_per_step=amax_per_step, fp8_device_ms_per_step=fp8_ms if fp8 else None,
        peak_gb_per_rank=[x / 1e9 for x in peaks], init_peak_gb_per_rank=[x / 1e9 for x in init_peaks],
        busy_share_with_nccl=busy, compute_busy_share=compute_busy, nccl_ms_per_step=nccl_ms,
        device_ms_per_step=device_ms, launches_per_step=launches,
        losses=[float(x) for x in losses])
    if acc.is_main_process:
        os.makedirs(OUT, exist_ok=True)
        line = json.dumps(result)
        suffix = "_fp8" if fp8 else ""
        with open(os.path.join(OUT, f"train_timing_{acc.layout}_{args.layers}l{suffix}.json"),
                  "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
    if not all(np.isfinite(result["losses"])):
        raise AssertionError(f"losses not finite: {result['losses']}")
    acc.wait_for_everyone()
    return result


if __name__ == "__main__":
    main()
