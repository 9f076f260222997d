"""Chip smoke test of the PyTorch/H100 port: builds the CUDA kernels from
this checkout, holds each one against its plain PyTorch version on the
card, and drives the port's main paths with seeded random weights:
Llama-3-8B continuous-batching serving through ``InferenceServer`` at full
width and depth, plain and with speculative decoding, chunked prefill and
the int8 KV pool, with the host-RAM KV tier, disaggregated prefill and the
KV transfer wire; the same model quantized to int8 weights, and a
checkpoint written, loaded into an empty model and quantized; Llama-3-8B
training steps through the ``Accelerator`` at full width and 4 layers,
in bf16 and in fp8; a fine-tune at full width that is interrupted and resumes bitwise; the
same training step under DDP and FSDP2 over NCCL at world size 1, and
under tensor parallelism; static generation (``generate`` and the static
``InferenceServer``) on the serving model; the fine-tune supervised
by the launcher through a crash, a preemption and a hang; static
generation over a mesh (tensor parallelism alone and under FSDP2); and
a fleet of two replicas behind ``FleetRouter`` with failover, the circuit
breaker, the degradation ladder, tracing and perfwatch; the SLO controller
walking its ladder over that fleet through a flash crowd, and the seeded
chaos conductor with its invariant monitors.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # build + kernel checks only

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
     requests, three runs through the engine whose programs are captured
     CUDA graphs (one graph per JAX program signature, asserted against
     JAX's counts in ``stats()["programs"]``; each replay's launches those
     of one eager call), then the same requests once through the eager
     engine (``engine._disable_graphs``): every request's tokens and steps
     bitwise equal; launch counters reset just before each run and read
     just after, the eager run's (counted at the wrappers) equal to the
     graph run's (capture counts times replays); tokens/s and TTFT per run; steady-state decode step and
     prefill times (three repeats) and a profile of replayed decode steps,
     beside the eager engine's times
  7. (run right after 4, on its model) InferenceServer with speculative
     decoding and 512-token chunked prefill over 16 requests (12
     drafter-friendly, 4 of 1,025-1,500 tokens), on the paged pool (A:
     three graph runs) and the int8 pool (B: one), each against the eager
     engine on the same requests (tokens, steps and spec counters bitwise
     equal), programs and launches per replay as in 4, launches against
     the engine's counters, greedy requests teacher-forced, tokens/s,
     TTFT, acceptance, steady-state verify and decode step and chunk
     times (three repeats) with the host's wait for the readbacks before
     drafting, a profile of replayed verify steps; then phase 15 (b)'s
     four requests through its engine on each pool, its references
 17. (run right after 7, on its model) the host KV tier and disaggregation:
     (a) the host-RAM KV tier: an engine at max_len 2048, bucket and
     chunk 512, blocks of 16, a pool of 195 blocks (two long requests)
     and a 1 GiB tier; a 1,536-token greedy prompt P (96 blocks) served
     cold, evicted by two long prompts served together, served again
     (exactly one restore program of 96 blocks, its first block's bytes
     and its tokens bitwise the cold serve's), then from the device's
     prefix cache, then evicted and restored once more; TTFT of each,
     the restore's device ms and host-to-device GB/s, the spills' GB/s,
     and decode ticks with a spill in flight against ticks without; the
     same on the int8 pool (q and s bitwise); launches against the
     engine's counters (host_tier, host_tier_int8); (b) P evicted again
     and served through InferenceServer(kv_prefetch=True): 96 prefetch
     hits, tokens bitwise; (c) phase 4's mix through plain inserts, then
     through prefill_remote on two worker threads and
     submit(prefilled=): every request's tokens bitwise the plain run's,
     programs prefill_forward (512,) and prefill_commit () at JAX's
     counts, no fallback; tokens/s and TTFT of both, the decode step
     alone and beside a remote forward (disagg); (d) 4 requests
     prefilled by a second engine and shipped to a server over (c)'s
     engine in process and over TCP loopback (kvtransfer.py), tokens
     bitwise the local prefill's, bytes, ms and GB/s a ship, a corrupted
     chunk raising TransferCorruptError and a reservation released before
     COMMIT raising TransferStaleEpochError on the sender while requests
     in flight finish bitwise (kvtx)
 18. (run right after 17, on phase 4's model) the serving fleet: two
     continuous servers ("r0", "r1"), each with its own engine and pool
     over the one model, behind a ``FleetRouter``: (a) phase 4's 16
     requests, every one bitwise equal to phase 4's single server, both
     replicas serving, B1/B4/B6 counted (fleet) against the engines'
     counters; tokens/s beside phase 4's, TTFT p50/p99, each replica's
     share; (d) on (a)'s fleet: the mix with tracing off and on, twice
     each (the goodput it costs against tracing_bench.py's 2 %, reported),
     one request's span tree from ``fleet.submit`` to ``engine.retire``,
     a flight dump read back as Chrome JSON, perfwatch's measured
     ``decode_step`` median beside phase 4's steady decode and a baseline
     for the card (the decode's bytes bound: weights and live KV over
     3.35 TB/s), and the exporter's Prometheus text scraped over
     127.0.0.1; (b) failover: first phase 4's mix again on (a)'s fleet
     with r0's worker killed mid-decode through the fault points, every
     request (the moved ones on r1, started again with their seeds)
     bitwise phase 4's; then the same prompts greedy with speculation on
     both replicas and r0's worker killed again: all
     16 complete, the moved ones on r1 with ``failover_count`` > 0, no
     untyped error, the retry budget spent once a ReplicaDeadError, B1,
     B4, B5 and B6 counted (fleet_spec), the greedy tokens held by phase
     12's rule (a slot's logits under speculation depend on its
     neighbours); (c) the static server's breaker on an injected clock and
     the continuous server's ladder on one slot, each against the sequence
     tests/test_torch_serving_control.py holds to the JAX server's. The
     fleets close and the engines are freed before phase 19
 19. (run right after 18, on phase 4's model) the control plane: two
     continuous servers of phase 7's kind ("r0", "r1": speculation, 512-token
     chunks), each engine billing a perfwatch of its own with phase 18's
     H100 baseline, behind a ``FleetRouter`` whose ``replica_factory``
     builds "ctl-N" over the same model (free card memory checked first):
     (a) ``SLOController`` through a seeded ramp -> flash crowd -> drain of
     phase 7's mix (``test_utils/arrivals.py``; rates shares of phase 18's
     tokens/s, the crowd twice it, the TTFT SLO twice phase 18's p99; two
     chunks a tick, so that the longctx rung halves rather than pauses
     them): the rungs
     engage in the JAX order up to scale (a third replica) and release in
     reverse, the added replica drained first, no future dropped, every
     failure typed (``ServerOverloaded`` with its ``retry_after_s``), the
     greedy tokens held by phase 12's rule, r0's and r1's programs and
     graphs unchanged; B1/B4/B5/B6 counted (control) against the engines'
     counters; the rung timeline with its pressure, TTFT p50/p99 by phase,
     tokens/s, replica-seconds against three static replicas over the same
     window, the tick's ms and the seconds the new replica's graph builds
     held the graph lock every engine's replays take; (c) fail-static:
     ``controller_observe:raise`` armed under load freezes actuation with
     one ``ControllerStaleError`` and no actuation, disarming it thaws;
     (d) docs/control_plane.md's chaos plan (r0 straggling 0.45 s an
     admission from the crowd on, ``fleet_probe`` flaky at p = 0.2 in the
     crowd, one raise in r1's admission) over a shorter schedule, under
     ``InvariantMonitors`` (every future, every registry, the traces):
     clean, one kill, the firing sequence replayed twice; goodput and TTFT
     p99 against the same arrivals without chaos, beside chaos_bench.py's
     0.85x and 1.5x (printed: the replicas share one card); (b) drift: r0
     slowed 0.1 s an admission by a ``ChaosRule``, its perfwatch's
     measured-against-baseline ratio past its peers' makes the fleet file
     one brown-out finding naming it, and the controller replaces it: a
     fresh replica up, r0 drained, no future dropped
 12. (run right after 19, on its model, before 8 quantizes it) static
     generation: (a) ``generate`` at B = 8, a 512-token prompt and 128 new
     tokens, greedy, under the dense, paged and paged_int8 KV backends:
     eagerly (``engine._disable_graphs``), then twice through its CUDA
     graph (the first call captures the decode step), the graph runs'
     tokens bitwise equal to the eager run's; teacher-forced against the
     plain forward (argmax share >= 0.9, near-ties <= Q_NEAR_TIE_ULPS); a
     planted fault (the step's position frozen) must fail that check; 32
     B1 launches per call; sampled (temperature 0.8, top-k 50, top-p 0.9)
     equal for one seed twice and different for another; top_k=1 equal to
     greedy up to a tie of the bf16 logits; prefill ms, decode ms per step
     as graph replays and eagerly, B1 counted by the profiler in one
     prefill, peak memory. (b) ``InferenceServer(model)`` at
     ``ServingConfig()``'s defaults (static, dense, 8 rows a batch): 32
     greedy requests (24 of 512 tokens, 8 of 256) with 64 new tokens, two
     runs (the first captures its programs), every reply equal to a direct
     ``generate`` of its batch's rows, one program per batch key; B1
     launches under ``static`` in the kernels line
  8. (run right after 12, on its model) quantized big-model inference: the
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
     peak memory and a profile of one step; then the first step's
     gradients, leaf by leaf, under remat "nothing", "dots" and "minimal",
     each with the chunked cross entropy off and on (the policies bitwise
     equal, chunked against dense within bf16 rounding, a planted zeroed
     dh chunk that must exceed the limit); then the step under each of the
     six: step time, peak memory, the flash forward's launches per step
     (2L under each: the recompute runs it again) and losses that agree
 16. (run right after 6) fp8 training: (a) phase 6's model, seed, batch and
     AdamW under Accelerator(mixed_precision="fp8") (prepare sets
     use_fp8: each layer's seven projections through ops/fp8.py's
     fp8_dot, torch._scaled_mm on e4m3 operands with an e5m2 cotangent),
     2 untimed and 4 timed steps with the launch counters reset just
     before (2L B1, L B2, L B3 and 28L _scaled_mm a step, under
     training_fp8), every gradient norm finite, the first four losses
     within 1e-2 of phase 6's (the fifth and sixth, where the repeated
     batch's memorization amplifies fp8's gradient noise, printed); ms a
     step, tokens/s, MFU over the bf16 and the fp8 peak,
     peak memory and a profile with the quantize passes' and layout
     copies' device ms, beside phase 6's; (d) greedy generate on that
     model (B = 4, 512 + 64): the prefill through fp8 (7L _scaled_mm; B1
     under prefill_fp8, L launches), the tokens teacher-forced through the fp8
     prefill's cache and the bf16 verify step by phase 12's rule, and
     against the same model with use_fp8=False (reported); (b) one
     projection of each Llama-3-8B shape at M = 8192: the card's quantized
     bytes bitwise the CPU's, fp8_dot's forward and both gradients against
     the plain version on the card within 2^-7 of the largest |reference|,
     a planted scale one e4m3 step off that must exceed it, _scaled_mm's
     ms against a bf16 torch.mm; (c) fp8_rewrite through prepare on a
     256 -> 512 -> 8 MLP: five train_step calls lower the loss, its first
     product through _scaled_mm (2 a step), bitwise fp8_dot's
  9. (run after 6) a resumable fine-tune, the port of
     examples/by_feature/fault_tolerance.py and packed_sft.py: seeded
     documents of 64-3000 tokens packed by the native packer
     (csrc/packing.cpp) into 2048-token rows with segment ids, a torch
     DataLoader (2 workers, pinned) unwrapped by prepare_data_loader with
     the seedable shuffle, Llama-3-8B at full width and the deepest of 1-2
     layers whose two checkpoints fit the temporary directory with 20 % to
     spare, f32 master weights, bf16 compute, accumulate/backward, AdamW,
     max_grad_norm=1.0, a warm-up + cosine schedule; (a) 8 uninterrupted
     steps; (b) 4 steps, save_state (automatic naming, total_limit=2), 2
     steps, a save interrupted by a fault point once the model's tensors
     are written (before the optimizer's and the commit), then a
     fresh Accelerator's resume_from_latest and steps 5-8: losses and final
     parameters bitwise equal to (a); (c) the same resume with the
     loader's position discarded, which must differ; (d) check_step_health
     restoring the step-4 checkpoint bitwise on a planted NaN, synchronous
     and with its verdict 2 steps late; (e) the same resume from an async
     save taken while training went on. Save, load and checksum GB/s, the
     step with the loader against a resident batch, the packer, the health
     check and the tracker's host cost; B1-B3 launches counted
 10. (run after 9) data-parallel training at world size 1 over NCCL (an
     in-process group on cuda:0): phase 6's model, seed, batch and step
     through Accelerator(parallelism_config=...).train_step, (a) DDP
     (dp_replicate_size=1, forced by a DistributedDataParallelKwargs) and
     (b) FSDP2 (dp_shard_size=1 with an FSDPPlugin: one fully_shard unit
     per layer, then the root); 2 untimed and 8 timed steps each with the
     launch counters reset just before (2L B1, L B2, L B3 a step); the
     first loss bitwise equal to phase 6's and all ten within 1e-2 of
     them; step ms, tokens/s, MFU, peak memory, busy share beside phase
     6's; a DTensor given to the flash wrapper must raise
 11. (run after 10) tensor parallelism: (a) phase 6's model, seed, batch
     and step over a one-rank NCCL group, forced to the TP layout by a
     TensorParallelConfig: every parameter a DTensor block on the tp mesh,
     the sequence gather/scatter and the vocabulary-parallel loss on the
     path; the first step's gradients kept, 2 untimed and 8 timed steps
     with the launch counters reset just before (2L B1, L B2, L B3 a step,
     counted under training_tp); all ten losses within 1e-2 of phase 6's;
     step ms, tokens/s, MFU, peak memory, busy share beside phase 6's;
     (b) four TP ranks on the one card, threads of this process over
     torch's threaded process group: the same model, weights and batch
     split over tp=4 (B1-B3 at 8 q heads and 2 kv heads, counted under
     training_tp4_threads), three steps whose losses are held within 1e-2
     of (a)'s and whose first-step gradients, gathered whole, within
     TP_GRAD_TOL of a leaf's largest element of (a)'s; a planted fault
     (the norm scales' tp gradient sum left out) must exceed that limit.
     Phase 2 holds B1-B3 at tp=2's and tp=4's local head counts
 13. (run after 11) training that survives failures: phase 9's model and
     step (Llama-3-8B at full width, 1 layer: its checkpoint, the local
     tree, the replica and a staging copy fit the temporary directory
     with 20 % to spare), seeded packed rows a step, through ``python -m
     accelerate_tpu_torch.commands.launch --num_processes 1`` running
     accelerate_tpu_torch/test_utils/scripts/crash_resume_script.py: (e) a
     hang at the end of step 2 on the first attempt, killed by the
     watchdog (40 s), and the restart from step 0, 6 steps uninterrupted
     in a fresh process: the reference (the hung attempt's two losses
     bitwise its first two); (d) --handle_preemption --replicate_to with a
     synchronous replica, SIGTERM to the launcher once the worker trains:
     one emergency checkpoint, mirrored, launcher rc 0 and no restart; (b)
     the relaunch, --max_restarts 1 --watchdog_timeout 150, resumes that
     checkpoint at (d)'s step, its worker killed by a fault point at the
     end of its second step on its first attempt, restarted by the
     supervisor and resumed from the same checkpoint by
     resume_from_latest (the run's one save serves the preemption and the
     crash), ending on (e)'s losses and parameter checksum bit for bit; a
     planted fault: one byte of the replica flipped, which
     restore_from_replica must refuse with the checksum error and
     ReplicaUnavailableError ((c), the local tree wiped and a relaunch
     restoring from the replica, is held on the CPU by
     tests/test_torch_elastic.py). Step ms, the emergency checkpoint's
     seconds and GB/s, the signal-to-exit and restart seconds, the
     resume's GB/s and the watchdog's latency are printed with the card;
     the children's B1-B3 launches, every attempt, are counted under
     training_supervised
 14. (run after 13) serving over a mesh: (a) ``prepare_inference(mesh=,
     rules=tensor_parallel_rules())`` over a one-rank NCCL group forced to
     the TP layout (a TensorParallelConfig), Llama-3-8B at 8 layers, bf16:
     ``generate`` greedy at B = 8, 512 + 128 tokens over the dense and the
     paged cache, eagerly and as graph replays (the decode step captured
     with its NCCL collectives), every run bitwise equal to the unsharded
     model's in the same phase; tokens/s, decode replay ms and the peak
     above the weights beside the unsharded figures; B1 counted under
     static_tp; the same layout with FSDP2 forced on its one-rank dp_shard
     dim (each layer's shards gathered inside the captured step), dense,
     bitwise again (static_tp_fsdp); (d) ``InferenceServer(ServingConfig())`` over that model,
     8 requests of 512 tokens and 64 new, every reply equal to a direct
     ``generate`` (static_tp_server); (b) four tp ranks and (c) dp_shard 2
     x tp 2 as threads over torch's threaded group on the card (it cannot
     be captured: the decode runs eagerly) at 4 layers, 64 new tokens:
     tokens equal on every rank and held against the plain forward by
     phase 12's rule, B1 at 8/2 and 16/4 heads a rank counted
     (static_tp4_threads, static_dp_shard2_tp2_threads), and a planted
     fault (rank 1 sampling with another seed) caught on every rank
 15. (run after 14) the continuous engine over a mesh: (a) phase 4's
     32-layer model laid out by ``prepare_inference(mesh=,
     rules=tensor_parallel_rules())`` over a one-rank NCCL group forced to
     the TP layout, phase 4's 16 requests through
     ``InferenceServer(mode="continuous")`` (the engine's programs
     captured with their NCCL collectives): every request's tokens bitwise
     equal to phase 4's; programs equal to JAX's, launches per replay,
     launches against the engine's counters (continuous_tp); decode
     replay ms and the host's ms a tick beside phase 4's, the pool's bytes;
     (b) 4 of phase 7's requests (2 drafter-friendly greedy, 2 of
     1,025-1,500 tokens sampled) with speculation and 512-token chunks on
     the bf16 and the int8 pool, inserted at once into the engine and
     drained (continuous_tp_spec, continuous_tp_int8): every request's
     tokens bitwise equal to the same run on phase 7's unsharded model (at
     the end of phase 7), programs and launches as in 7, the bf16 pool's
     greedy requests teacher-forced by phase 7's rule; (c) tp 2
     as threads (eager) at 4 layers, the same kind of traffic through the
     engine: B1, B4, B5 and B6 at 16/4 heads a rank (continuous_tp2_threads),
     tokens equal on both ranks and held against the plain forward by
     phase 12's rule
The line before the last is the ``kernels`` JSON; the last line is
``{"ok": true, "device": {...}}``. Long output goes to chiprun_out/.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
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


LOG_FILE = []  # main() opens chiprun_out/chip_smoke.log: every line printed is kept there too


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in LOG_FILE:
        f.write(msg + "\n")
        f.flush()


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


def check_flash_tp_heads(dev, gen):
    """B1 (both variants) at the training step's shape with the heads one
    rank of tp=2 (16 q, 4 kv) and of tp=4 (8 q, 2 kv) holds, against its
    plain version."""
    from accelerate_tpu_torch.ops.flash_attention import (
        flash_attention_reference, flash_attention_with_lse, flash_fwd_kernel_for,
    )

    b, s, d = 4, 2048, 128
    for h, h_kv in ((16, 4), (8, 2)):
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            k = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, h_kv, d), generator=gen, device=dev).to(dtype)
            out, lse = flash_attention_with_lse(q, k, v, causal=True)
            ref, ref_lse = flash_attention_reference(q, k, v, causal=True)
            torch.cuda.synchronize()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (lse - ref_lse).abs().max().item())
            log(f"B1 {flash_fwd_kernel_for(dtype)} {dtype} at tp={32 // h}'s local heads (B={b}, "
                f"S={s}, H={h}, Hkv={h_kv}, D={d}) max_abs_err={err:.3e} tol={B1_TOL[dtype]:g}")
            if not err <= B1_TOL[dtype]:
                raise AssertionError(f"flash_fwd {dtype} at H={h} Hkv={h_kv} disagrees with its "
                                     "plain version")
            del q, k, v, out, lse, ref, ref_lse
    torch.cuda.empty_cache()


def check_flash(dev, gen, results):
    from accelerate_tpu_torch.ops.flash_attention import (
        flash_attention_reference, flash_attention_with_lse, flash_fwd_kernel_for,
    )

    check_flash_tp_heads(dev, gen)
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
    # the training step's heads on one of tp=2 and tp=4 ranks (phase 11)
    "tp2": (4, 2048, 16, 4, 128, {}),
    "tp4": (4, 2048, 8, 2, 128, {}),
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


SERVING = dict(mode="continuous", engine_slots=8, engine_max_len=1024, engine_prompt_bucket=512, engine_block_size=16,
               kv_cache="paged", attention_impl="kernel", engine_readback_lag=2)
SERVING_REPEATS = 3  # timed runs of each mix through the graph engine
# the JAX engine's compiled programs under each mix (accelerate_tpu/engine.py:23-34):
# one graph per signature on the card
JAX_PROGRAMS = {"serving": {"prefill_insert": 1, "decode_step": 1},
                "spec": {"prefill_insert": 2, "decode_step": 1, "verify_step": 1}}


def serve_mix(dev, model, prompts, scfg, new_tokens, engine=None, eager=False, warm=()):
    """Serve ``prompts`` at once through an InferenceServer over ``engine``
    (a new one when None: its programs captured as CUDA graphs, or run
    eagerly with ``eager``, through ``engine._disable_graphs``). ``warm``
    prompts are served first, 8 new tokens each, unrelated to the mix (a
    shared prefix would skip its chunks). Launch counters reset just
    before the mix and read just after. Closing the server resets the
    engine in place, so its graphs serve the next mix. Even requests are
    greedy, odd ones sampled. Returns a dict: results, wall_s, launches,
    delta (the engine's counters over the mix), programs, engine."""
    from accelerate_tpu_torch.engine import _disable_graphs
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer

    with _disable_graphs() if eager else contextlib.nullcontext():
        srv = InferenceServer(model, scfg, engine=engine, device=dev)
    with srv:
        for f in [srv.submit(p, max_new_tokens=8) for p in warm]:
            f.result(timeout=300)
        eng = srv.engine

        def counters():
            spec = eng.stats()["spec"]
            return dict(steps=eng.steps, verify=eng.spec_verify_steps, chunks=eng.prefill_chunks,
                        inserted=eng.inserted, **{k: spec[k] for k in ("drafted", "accepted", "wasted")})

        before = counters()
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        futs = []
        for i, p in enumerate(prompts):
            sampled = i % 2 == 1
            futs.append(srv.submit(
                p, max_new_tokens=new_tokens, temperature=0.8 if sampled else 0.0,
                top_k=50 if sampled else None, top_p=0.9 if sampled else None, seed=i))
        results = [f.result(timeout=900) for f in futs]
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()
        after = counters()
        stats = eng.stats()
    vocab = model.config.vocab_size
    for p, r in zip(prompts, results):
        new = r.tokens[len(p):]
        if r.tokens.shape != (len(p) + new_tokens,) or not (r.tokens[: len(p)] == p).all():
            raise AssertionError("a result row has the wrong shape or prompt")
        if not ((new >= 0) & (new < vocab)).all():
            raise AssertionError("a generated token is out of the vocabulary")
    delta = {k: after[k] - before[k] for k in after}
    delta["hbm_bytes"] = stats["kv"]["hbm_bytes"]
    return dict(results=results, wall_s=wall, launches=launches, delta=delta, engine=eng,
                programs=stats["programs"], program_count=stats["program_count"],
                tokens_per_s=len(prompts) * new_tokens / wall,
                ttft_s=sorted(r.ttft_s for r in results))


def check_programs(label, run, expected):
    """The engine ran JAX's program signatures, each one captured graph."""
    eng = run["engine"]
    graphs = eng.graph_launches()
    log(f"{label} programs {run['programs']} (program_count {run['program_count']}; JAX: {expected}); "
        f"graphs captured: {sorted(graphs)}")
    if run["programs"] != expected or run["program_count"] != sum(expected.values()):
        raise AssertionError(f"{label}: programs {run['programs']}, JAX compiles {expected}")
    if len(graphs) != run["program_count"]:
        raise AssertionError(f"{label}: {len(graphs)} graphs for {run['program_count']} programs")


def check_replay_launches(label, eng, n_layers, bucket, chunk=None, k=None, suffix=""):
    """Each captured graph's launches per replay: those of one eager call."""
    expected = {
        "decode_step ()": {f"paged_decode{suffix}_mma": n_layers, "fused_sample": 1},
        f"prefill_insert ({bucket},)": {"flash_fwd_mma": n_layers, "fused_sample": 1},
        f"verify_step ({k},)": {f"paged_verify{suffix}_mma": n_layers},
        f"prefill_insert ('chunk', {chunk})": {f"paged_verify{suffix}_mma": n_layers, "fused_sample": 1},
    }
    got = eng.graph_launches()
    log(f"{label} launches per replay: {got}")
    for name, counts in got.items():
        if counts != expected.get(name):
            raise AssertionError(f"{label}: graph {name} launches {counts} per replay, "
                                 f"expected {expected.get(name)}")


def check_same_as_eager(label, runs, eager):
    """Every request's tokens and steps, and the spec counters, of each
    graph run bitwise equal to the eager engine's on the same requests."""
    keys = ("drafted", "accepted", "wasted")
    for i, run in enumerate(runs):
        tokens = all(np.array_equal(a.tokens, b.tokens) for a, b in zip(run["results"], eager["results"]))
        steps = [r.decode_steps for r in run["results"]] == [r.decode_steps for r in eager["results"]]
        spec = all(run["delta"][k] == eager["delta"][k] for k in keys)
        if not (tokens and steps and spec):
            raise AssertionError(
                f"{label} graph run {i + 1} differs from the eager engine: tokens equal {tokens}, "
                f"per-request steps equal {steps}, spec counters "
                f"{ {k: (run['delta'][k], eager['delta'][k]) for k in keys} }")
    log(f"{label}: the {len(runs)} graph runs equal the eager engine bitwise: every request's "
        f"tokens and steps, spec counters { {k: eager['delta'][k] for k in keys} }")


def log_run(label, run, card, extra=""):
    ttft = run["ttft_s"]
    log(f"{label}: {run['tokens_per_s']:.1f} generated tokens/s in {run['wall_s']:.3f}s; engine steps "
        f"{run['delta']['steps']} (verify {run['delta']['verify']}, chunks {run['delta']['chunks']}); "
        f"TTFT min {ttft[0]:.4f}s p50 {ttft[len(ttft) // 2]:.4f}s max {ttft[-1]:.4f}s{extra} [{card}]")


def run_numbers(runs):
    return [dict(tokens_per_s=r["tokens_per_s"], wall_s=r["wall_s"], ttft_min_s=r["ttft_s"][0],
                 ttft_p50_s=r["ttft_s"][len(r["ttft_s"]) // 2], ttft_max_s=r["ttft_s"][-1],
                 counters=r["delta"]) for r in runs]


MAIN_NEW_TOKENS = 64


def main_traffic(vocab):
    """Phase 4's mix: 16 random prompts of 64-512 tokens, and one warm-up
    prompt unrelated to it."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=16)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]
    return prompts, [np.random.default_rng(1).integers(0, vocab, size=64).astype(np.int32)]


def main_expected(n_layers, n_req, run):
    """Phase 4's launches from the engine's steps."""
    steps = run["delta"]["steps"]
    return {"flash_fwd_mma": n_layers * n_req, "paged_decode_mma": n_layers * steps,
            "fused_sample": steps + n_req}


def phase_main_path(dev, card, model):
    from accelerate_tpu_torch.models.llama import llama_prefill_at
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    scfg = ServingConfig(**SERVING)
    prompts, warm = main_traffic(cfg.vocab_size)
    n_req, new_tokens = len(prompts), MAIN_NEW_TOKENS
    lens = np.array([len(p) for p in prompts])

    def expected(run):
        return main_expected(n_layers, n_req, run)

    runs, eng = [], None
    for rep in range(SERVING_REPEATS):
        run = serve_mix(dev, model, prompts, scfg, new_tokens, engine=eng, warm=() if eng else warm)
        eng = run["engine"]
        check_launches(f"phase 4 run {rep + 1}", run["launches"], expected(run))
        log_run(f"phase 4 run {rep + 1} (graphs; {n_req} requests, prompts {int(lens.min())}-"
                f"{int(lens.max())}, {new_tokens} new tokens each, half sampled)", run, card)
        runs.append(run)
    check_programs("phase 4", runs[0], JAX_PROGRAMS["serving"])
    check_replay_launches("phase 4", eng, n_layers, SERVING["engine_prompt_bucket"])
    eager = serve_mix(dev, model, prompts, scfg, new_tokens, eager=True, warm=warm)
    log_run("phase 4 eager engine (same requests)", eager, card)
    check_same_as_eager("phase 4", runs, eager)
    # the graph runs' counts come from capture counts times replays; the
    # eager run's are counted at the wrappers, launch by launch
    check_launches("phase 4 eager", eager["launches"], expected(eager))
    if eager["launches"] != runs[0]["launches"]:
        raise AssertionError(f"phase 4: the graph run's launches {runs[0]['launches']} (from its "
                             f"replays) differ from the eager run's {eager['launches']}")
    steady = decode_steady_state(eng, prompts, card, SERVING_REPEATS, profile=True)
    steady_eager = decode_steady_state(eager["engine"], prompts, card, 1, profile=False,
                                       label="phase 4 eager")
    eager_numbers = run_numbers([eager])[0]
    del eager
    with torch.no_grad():
        ids = torch.from_numpy(prompts[0][None].astype(np.int64)).to(dev)
        logits, _ = llama_prefill_at(cfg, model.params, ids, 1024, [ids.shape[1] - 1])
        if not bool(torch.isfinite(logits).all().item()):
            raise AssertionError("full-depth prefill logits are not finite")
    launches = runs[0]["launches"]
    numbers = dict(runs=run_numbers(runs), eager_run=eager_numbers, programs=runs[0]["programs"],
                   per_replay=eng.graph_launches(), steady=steady, steady_eager=steady_eager,
                   tokens=[r.tokens for r in runs[0]["results"]])
    return {k: launches[k] for k in ("flash_fwd_mma", "paged_decode_mma", "fused_sample")}, numbers


PROFILE_GROUPS = ("paged_verify", "paged_decode", "fused_sample", "flash_fwd", "sort")
MATMUL_KEYS = ("gemm", "gemv", "cutlass", "sm90_", "cublas", "nvjet")


def decode_steady_state(eng, prompts, card, repeats, profile, label="phase 4"):
    """Decode ms per step at 8 slots (positions 300+, 32 steps, each
    ``repeats`` times) and prefill ms per 300-token request (8 back to
    back), on ``eng``; a profile of decode steps after the last repeat."""
    decode_ms, prefill_ms, host_ms = [], [], []
    with torch.no_grad():
        for _ in range(repeats):
            eng.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for p in prompts[:8]:
                eng.insert(p[:300], max_new_tokens=200)
            torch.cuda.synchronize()
            prefill_ms.append((time.perf_counter() - t0) / 8 * 1e3)
            for _ in range(4):
                eng.step()
                eng.poll()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(32):
                eng.step()
                eng.poll()
            torch.cuda.synchronize()
            decode_ms.append((time.perf_counter() - t0) / 32 * 1e3)
            host = []
            for _ in range(8):  # the host's own time a step: until step() and poll() return
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.step()
                eng.poll()
                host.append((time.perf_counter() - t0) * 1e3)
            host_ms.append(statistics.median(host))
        prof = profile_decode(eng, statistics.median(decode_ms), card) if profile else None
        eng.reset()
    log(f"{label} steady state: decode ms/step (8 slots at pos 300-340) "
        + ", ".join(f"{x:.3f}" for x in decode_ms) + "; the host's ms a step (median of 8, "
        "from a synchronised start until step() and poll() return) "
        + ", ".join(f"{x:.3f}" for x in host_ms) + "; prefill ms/request (bucket 512) "
        + ", ".join(f"{x:.3f}" for x in prefill_ms) + f" [{card}]")
    return dict(decode_ms_per_step=decode_ms, host_ms_per_step=host_ms, prefill_ms=prefill_ms,
                decode_profile=prof)


def profile_decode(eng, step_ms, card, n_steps=8, label="phase 4 decode",
                   out="profile_decode.txt"):
    """Device time per engine step by kernel group, from torch.profiler
    over ``n_steps`` steps (replays of the captured programs: CUPTI traces
    the graphs' kernels); the busy share divides it by the unprofiled
    ``step_ms``. The full table goes to ``out`` in the output directory."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng.step()
            eng.poll()
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
SPEC_SERVING = dict(mode="continuous", engine_slots=8, engine_max_len=2048, engine_prompt_bucket=512,
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


def spec_warm(vocab):
    """Warm-up prompts unrelated to the mix: a single-shot, a chunked and a
    drafter-friendly one, so every program is captured before the mix."""
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in (64, 1100)] + drafter_prompts(
        np.random.default_rng(2), 1, 200, 200, vocab)


def expected_launches(n_layers, delta, n_single, suffix=""):
    """Launches of a phase 7 mix from its counters: every chunk samples a
    first token (only the last one installs it), as the JAX chunk program
    does."""
    decode_steps = delta["steps"] - delta["verify"]
    return {
        "flash_fwd_mma": n_layers * n_single,
        "paged_decode" + suffix + "_mma": n_layers * decode_steps,
        "paged_verify" + suffix + "_mma": n_layers * (delta["verify"] + delta["chunks"]),
        "fused_sample": decode_steps + n_single + delta["chunks"],
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


def check_spec_run(label, run, prompts, n_layers, n_single, n_chunked, suffix=""):
    delta = run["delta"]
    check_launches(label, run["launches"], expected_launches(n_layers, delta, n_single, suffix))
    if delta["chunks"] != 3 * n_chunked or delta["inserted"] != len(prompts):
        raise AssertionError(f"{label}: {delta['chunks']} chunks for {n_chunked} long prompts")
    if not (delta["verify"] > 0 and delta["accepted"] > 0
            and delta["accepted"] + delta["wasted"] == delta["drafted"]):
        raise AssertionError(f"{label} speculation counters are off: {delta}")


def phase_spec_path(dev, card, model):
    """Phase 7: speculative decoding, chunked prefill and the int8 pool
    through InferenceServer on the phase-4 model, through the graph engine
    (A: three runs) and the eager engine on the same requests; returns the
    launches of server A's first run (paged pool) and of server B (int8
    pool) and the numbers."""
    import dataclasses

    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    prompts = spec_traffic(cfg.vocab_size)
    warm = spec_warm(cfg.vocab_size)
    is_long = [len(p) > SPEC_SERVING["engine_prompt_bucket"] for p in prompts]
    n_chunked = sum(is_long)
    n_single = len(prompts) - n_chunked
    shape = dict(bucket=SPEC_SERVING["engine_prompt_bucket"], chunk=SPEC_SERVING["engine_prefill_chunk"],
                 k=SPEC_SERVING["spec_draft_len"])
    scfg = ServingConfig(**SPEC_SERVING, kv_cache="paged")
    runs, eng = [], None
    for rep in range(SERVING_REPEATS):
        run = serve_mix(dev, model, prompts, scfg, SPEC_NEW_TOKENS, engine=eng, warm=() if eng else warm)
        eng = run["engine"]
        check_spec_run(f"phase 7 A run {rep + 1}", run, prompts, n_layers, n_single, n_chunked)
        d = run["delta"]
        log_run(f"phase 7 A run {rep + 1} (graphs; paged, spec ngram/4, chunk 512; {n_single} "
                f"drafter-friendly of 64-512 tokens, {n_chunked} of 1,025-1,500; {SPEC_NEW_TOKENS} new "
                "tokens each, half sampled)", run, card,
                f"; drafted {d['drafted']}, accepted {d['accepted']} (rate {d['accepted'] / d['drafted']:.3f})")
        runs.append(run)
    check_programs("phase 7 A", runs[0], JAX_PROGRAMS["spec"])
    check_replay_launches("phase 7 A", eng, n_layers, **shape)
    eager = serve_mix(dev, model, prompts, scfg, SPEC_NEW_TOKENS, eager=True, warm=warm)
    check_spec_run("phase 7 A eager", eager, prompts, n_layers, n_single, n_chunked)
    log_run("phase 7 A eager engine (same requests)", eager, card)
    check_same_as_eager("phase 7 A", runs, eager)
    results = runs[0]["results"]
    ttft = {k: sorted(r.ttft_s for r, lg in zip(results, is_long) if lg == k) for k in (False, True)}
    log(f"phase 7 A run 1 TTFT short min/p50/max {ttft[False][0]:.4f}/{ttft[False][len(ttft[False]) // 2]:.4f}/"
        f"{ttft[False][-1]:.4f}s, chunked {ttft[True][0]:.4f}/{ttft[True][len(ttft[True]) // 2]:.4f}/"
        f"{ttft[True][-1]:.4f}s; tokens per slot and verify step "
        f"{eng.stats()['spec']['tokens_per_step']:.3f} (engine lifetime) [{card}]")
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
    steady = spec_steady_state(eng, prompts, card, SERVING_REPEATS, profile=True)
    steady_eager = spec_steady_state(eager["engine"], prompts, card, 1, profile=False,
                                     label="phase 7 eager")
    a_tokens = [r.tokens for r in results]
    eager_numbers = run_numbers([eager])[0]
    a_launches = {k: runs[0]["launches"][k] for k in expected_launches(n_layers, runs[0]["delta"], n_single)}
    del eng, eager, results
    torch.cuda.empty_cache()

    scfg8 = ServingConfig(**SPEC_SERVING, kv_cache="paged_int8")
    run8 = serve_mix(dev, model, prompts, scfg8, SPEC_NEW_TOKENS, warm=warm)
    check_spec_run("phase 7 B", run8, prompts, n_layers, n_single, n_chunked, suffix="_int8")
    check_programs("phase 7 B", run8, JAX_PROGRAMS["spec"])
    check_replay_launches("phase 7 B", run8["engine"], n_layers, suffix="_int8", **shape)
    eager8 = serve_mix(dev, model, prompts, scfg8, SPEC_NEW_TOKENS, eager=True, warm=warm)
    check_same_as_eager("phase 7 B", [run8], eager8)
    agree = total = 0
    for i, (ta, r) in enumerate(zip(a_tokens, run8["results"])):
        if i % 2:
            continue
        new_a, new_b = ta[len(prompts[i]):], r.tokens[len(prompts[i]):]
        diverge = np.flatnonzero(new_a != new_b)
        agree += int(diverge[0]) if len(diverge) else len(new_a)
        total += len(new_a)
    d8 = run8["delta"]
    log_run("phase 7 B (graphs; paged_int8, same mix)", run8, card,
            f"; accepted {d8['accepted']}/{d8['drafted']}; pool {d8['hbm_bytes'] / 1e9:.3f} GB against "
            f"A's {runs[0]['delta']['hbm_bytes'] / 1e9:.3f} GB; greedy tokens equal to A's up to the "
            f"first divergence: {agree}/{total} (information only)")
    log_run("phase 7 B eager engine (same requests)", eager8, card)
    b_launches = {k: run8["launches"][k]
                  for k in expected_launches(n_layers, d8, n_single, suffix="_int8")}
    numbers = dict(
        runs=run_numbers(runs), eager_run=eager_numbers,
        acceptance_rate=runs[0]["delta"]["accepted"] / runs[0]["delta"]["drafted"],
        ttft_short_s=ttft[False], ttft_chunked_s=ttft[True], greedy_share=share,
        greedy_worst_gap=worst_gap, programs=runs[0]["programs"], steady=steady,
        steady_eager=steady_eager,
        int8=dict(run=run_numbers([run8])[0], eager_run=run_numbers([eager8])[0],
                  greedy_prefix_agreement=agree / total),
    )
    del run8, eager8
    torch.cuda.empty_cache()
    # phase 15 (b)'s references: its four requests through this model's
    # engine, on each pool
    numbers["tokens"] = {}
    for kv in ("paged", "paged_int8"):
        ref = spec_engine_run(dev, model, kv)
        numbers["tokens"][kv] = ref["tokens"]
        log(f"phase 7 reference for phase 15 (b) on {kv}: {len(ref['tokens'])} requests in "
            f"{ref['wall_s']:.3f}s, engine steps {ref['delta']}")
        del ref
        torch.cuda.empty_cache()
    return a_launches, b_launches, numbers


def spec_steady_state(eng, prompts, card, repeats, profile, label="phase 7"):
    """Steady-state verify-step and decode-step ms at 8 slots (24 steps a
    repeat, split by kind), the host's wait for the pending readbacks
    before each draft (``_materialize_ring``, timed here by a wrapper),
    ms per 512-token chunk, and a profile of verify steps after the last
    repeat, on phase 7 A's engine."""
    numbers = dict(verify_ms=[], decode_ms=[], wait_ms=[], host_ms=[], plain_decode_ms=[], chunk_ms=[])
    materialize = eng._materialize_ring
    waits = []

    def timed_materialize():
        t0 = time.perf_counter()
        materialize()
        waits.append((time.perf_counter() - t0) * 1e3)

    eng._materialize_ring = timed_materialize
    try:
        with torch.no_grad():
            for rep in range(repeats):
                eng.reset()
                for p in prompts:
                    if len(p) <= 512 and eng.free_slots():
                        eng.insert(p[:300], max_new_tokens=600)
                for _ in range(4):
                    eng.step()
                    eng.poll()
                verify_ms, decode_ms, host_ms = [], [], []
                waits.clear()
                for _ in range(24):
                    v0 = eng.spec_verify_steps
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.step()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    (verify_ms if eng.spec_verify_steps > v0 else decode_ms).append(
                        (time.perf_counter() - t0) * 1e3)
                    if eng.spec_verify_steps > v0:
                        host_ms.append((t1 - t0) * 1e3)
                    eng.poll()
                numbers["verify_ms"].append(statistics.median(verify_ms) if verify_ms else None)
                numbers["decode_ms"].append(statistics.median(decode_ms) if decode_ms else None)
                numbers["wait_ms"].append(statistics.mean(waits) if waits else None)
                numbers["host_ms"].append(statistics.median(host_ms) if host_ms else None)
                if rep == repeats - 1 and profile and verify_ms:
                    numbers["verify_profile"] = profile_decode(
                        eng, statistics.median(verify_ms), card, n_steps=4,
                        label=f"{label} verify step", out="profile_verify.txt")
                eng.set_spec_draft_limit(0)
                for _ in range(2):
                    eng.step()
                    eng.poll()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(16):
                    eng.step()
                    eng.poll()
                torch.cuda.synchronize()
                numbers["plain_decode_ms"].append((time.perf_counter() - t0) / 16 * 1e3)
                eng.set_spec_draft_limit(eng.spec_draft_len)
                eng.reset()
                eng.set_prefill_chunk_limit(0)
                long = [p for p in prompts if len(p) > 1024][0]
                eng.insert(long, max_new_tokens=4)  # its first chunk runs here
                while eng.prefill_chunks_pending():
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    eng.prefill_step(limit=1)
                    torch.cuda.synchronize()
                    numbers["chunk_ms"].append((time.perf_counter() - t0) * 1e3)
                eng.set_prefill_chunk_limit(1)
                eng.reset()
    finally:
        eng._materialize_ring = materialize

    def fmt(xs):
        return ", ".join("-" if x is None else f"{x:.3f}" for x in xs)

    log(f"{label} steady state at 8 slots (positions 300+), per repeat: verify step median "
        f"{fmt(numbers['verify_ms'])} ms (each step synchronised), of it the host's until step() "
        f"returns {fmt(numbers['host_ms'])} ms (drafting, staging, the replay's launch), and in "
        f"that waiting for the readbacks before drafting {fmt(numbers['wait_ms'])} ms; decode step taken between verify steps "
        f"{fmt(numbers['decode_ms'])} ms; decode step with drafting off {fmt(numbers['plain_decode_ms'])} "
        f"ms/step; 512-token chunk at offsets 512 and 1024: {fmt(numbers['chunk_ms'])} ms [{card}]")
    return numbers


# ---------------------------------------------------------------- phase 17
# (a): a pool of about two long requests' blocks, so two long prompts
# served together evict every block of a third (P), and a host tier of
# 1 GiB (512 bf16 blocks of Llama-3-8B)
TIER_ENGINE = dict(slots=4, max_len=2048, prompt_bucket=512, block_size=16, prefill_chunk=512,
                   pool_blocks=195, attention_impl="kernel", readback_lag=2, host_tier_bytes=1 << 30)
TIER_PROMPT, TIER_NEW = 1536, 16  # P: 96 full blocks
TIER_SHORT, TIER_SHORT_NEW = 512, 100  # (a)'s decode ticks with and without a spill in flight
DISAGG_WORKERS = 2
WIRE_REQUESTS = 4
WIRE_CHUNK_BYTES = 1 << 20
TIER_JAX_PROGRAMS = {"prefill_insert": 3, "decode_step": 1}  # bucket, chunk, restore
DISAGG_JAX_PROGRAMS = {"prefill_insert": 1, "decode_step": 1, "prefill_forward": 1,
                       "prefill_commit": 1}


def tier_traffic(vocab):
    """P, the two long prompts that evict it (Q1, Q2), two pairs more that
    evict it again ((a)'s second restore and (b)), and three 512-token
    prompts for the spill ticks."""
    rng = np.random.default_rng(17)
    long = [rng.integers(0, vocab, size=TIER_PROMPT).astype(np.int32) for _ in range(7)]
    short = [rng.integers(0, vocab, size=TIER_SHORT).astype(np.int32) for _ in range(3)]
    return long, short


def leaf_bytes(pre):
    """A RemotePrefill's payload bytes on the wire, its meta left out: the
    KV window, the first token, the seed and the prompt."""
    return (sum(t.numel() * t.element_size() for t in (*pre.cache.values(), pre.t0, pre.next_key))
            + pre.prompt.nbytes)


def wait_for(pre):
    """``pre`` once its forward has run (its event; None on the CPU)."""
    if pre.event is not None:
        pre.event.synchronize()
    return pre


def sync_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def engine_serve(eng, prompts, budgets):
    """Insert ``prompts`` (greedy) at once and tick until all retire;
    returns (tokens per request, seconds from the first insert until the
    first request's first token was read back)."""
    t0 = time.perf_counter()
    occs = [eng.insert(p, max_new_tokens=b) for p, b in zip(prompts, budgets)]
    ttft = None
    while eng.live_count():
        eng.step()
        eng.poll()
        if ttft is None and occs[0].tokens:
            ttft = time.perf_counter() - t0
    eng.poll(force=True)
    if ttft is None:
        ttft = time.perf_counter() - t0
    return [list(o.tokens) for o in occs], ttft


def first_block(eng, prompt):
    """The pool bytes of ``prompt``'s first block (from the registry), on
    the host: ``{"k", "v"}`` of tensors or of int8 ``{"q", "s"}``."""
    blk = eng._backend.pool._registry[prompt[: eng._backend.block_size].tobytes()]

    def take(leaf):
        return {n: t[:, blk].cpu().clone() for n, t in leaf.items()} if isinstance(leaf, dict) \
            else leaf[:, blk].cpu().clone()

    return {w: take(eng._cache[w]) for w in ("k", "v")}


def same_block(a, b):
    if isinstance(a, dict):
        return all(same_block(a[n], b[n]) for n in a)
    return bool(torch.equal(a, b))


def instrument_tier(eng):
    """CUDA events around the next restore (before the plan, after its
    host-to-device copies are enqueued, after the scatter) and the host
    clock of each spill gather: wrappers on the instance only."""
    marks = {"spills": []}
    backend = eng._backend
    plan_fn, restore_fn, flush_fn = backend.restore_plan, eng._dispatch_restore, backend._flush_spills

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def plan(*a, **k):
        start = event()
        out = plan_fn(*a, **k)
        if out is not None:
            marks.update(start=start, copied=event(), blocks=out[0])
        return out

    def insert(*a, **k):
        marks["filed"] = time.perf_counter()
        return insert_fn(*a, **k)

    def restore(*a, **k):
        restore_fn(*a, **k)
        marks["scattered"] = event()

    def flush():
        if backend._spill_batch:
            marks["spills"].append((time.perf_counter(), len(backend._spill_batch)))
        flush_fn()

    insert_fn = backend.host_tier.insert
    backend.restore_plan, eng._dispatch_restore, backend._flush_spills = plan, restore, flush
    backend.host_tier.insert = insert
    return marks


def tier_counters(eng):
    kv = eng.stats()["kv"]
    return dict(steps=eng.steps, verify=0, chunks=eng.prefill_chunks, restores=eng.kv_restores,
                **{k: kv[k] for k in ("spill_blocks", "restore_hits", "restore_misses",
                                      "prefetch_hits", "host_tier_dropped")})


def host_tier_run(dev, card, model, kv, label):
    """(a) on one pool: P cold, P evicted by Q1 + Q2 served together, P
    again (one restore of 96 blocks, one chunk), P once more (a device
    prefix hit); on the bf16 pool also the decode ticks with and without a
    spill in flight. Every check raises. Returns (engine, launches,
    numbers, P's tokens)."""
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.ops import _build

    n_layers = model.config.num_hidden_layers
    long, short = tier_traffic(model.config.vocab_size)
    p, q1, q2 = long[:3]
    eng = ContinuousBatchingEngine(model, kv_cache=kv, device=dev, **TIER_ENGINE)
    backend = eng._backend
    marks = instrument_tier(eng)
    block_bytes = backend.host_block_bytes()
    # warm-up: every program of the mix captured before the counted run
    # (the restore runs eagerly and needs none)
    engine_serve(eng, [long[3][:700], short[0][:200]], [4, 4])
    eng.reset()
    backend.host_tier.clear()
    before = tier_counters(eng)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    (cold,), ttft_cold = engine_serve(eng, [p], [TIER_NEW])
    block0 = first_block(eng, p)
    numbers = {}
    n_single = 0
    if kv == "paged":
        # decode ticks of three 512-token requests with a spill in flight
        # (the third's admission evicts P's oldest blocks) and without
        occs = [eng.insert(s, max_new_tokens=TIER_SHORT_NEW) for s in short[:2]]
        for _ in range(4):
            eng.step()
            eng.poll()
        occs.append(eng.insert(short[2], max_new_tokens=TIER_SHORT_NEW))
        n_single = 3
        spilling = []
        while backend._spill_q is not None and backend._spill_q.unfinished_tasks and len(spilling) < 32:
            spilling.append(sync_ms(lambda: (eng.step(), eng.poll())))
        backend.spill_flush()
        quiet = [sync_ms(lambda: (eng.step(), eng.poll())) for _ in range(8)]
        eng.drain()
        numbers.update(spill_tick_ms=spilling, quiet_tick_ms=quiet)
        log(f"phase 17 (a) {label}: decode ticks of 3 slots with a spill in flight "
            + ", ".join(f"{x:.3f}" for x in spilling) + " ms; after it "
            + ", ".join(f"{x:.3f}" for x in quiet) + f" ms (each tick synchronised) [{card}]")
    def evict(prompts):
        """Serve ``prompts`` together (two long ones take the whole pool):
        every block of P goes to the tier. Returns (blocks spilled,
        seconds from the first gather to the last block filed)."""
        spills0, tier0 = len(marks["spills"]), backend.host_tier.stats()["spill_blocks"]
        engine_serve(eng, prompts, [2] * len(prompts))
        backend.spill_flush()
        if backend.pool._shared_prefix(p):
            raise AssertionError(f"phase 17 (a) {label}: P still has device blocks after the eviction")
        return (backend.host_tier.stats()["spill_blocks"] - tier0,
                marks["filed"] - marks["spills"][spills0][0])

    def restore():
        """P again: one restore of its 96 blocks, then one chunk. Returns
        (TTFT, restore ms, its host-to-device copies' ms) of device time."""
        hits0, restores0 = backend.host_tier.stats()["restore_hits"], eng.kv_restores
        (again,), ttft = engine_serve(eng, [p], [TIER_NEW])
        torch.cuda.synchronize()
        restored = backend.host_tier.stats()["restore_hits"] - hits0
        if eng.kv_restores - restores0 != 1 or restored != TIER_PROMPT // 16 or marks["blocks"] != restored:
            raise AssertionError(f"phase 17 (a) {label}: {eng.kv_restores - restores0} restores of "
                                 f"{restored} blocks, expected one of {TIER_PROMPT // 16}")
        if not same_block(first_block(eng, p), block0):
            raise AssertionError(f"phase 17 (a) {label}: P's first block after the restore is not "
                                 "bitwise its bytes before the eviction")
        if again != cold:
            raise AssertionError(f"phase 17 (a) {label}: P's tokens after the restore {again} differ "
                                 f"from its cold serve's {cold}")
        return (ttft, marks["start"].elapsed_time(marks["scattered"]),
                marks["start"].elapsed_time(marks["copied"]))

    nbytes = TIER_PROMPT // 16 * block_bytes
    spills, restores = [evict([q1, q2])], [restore()]
    (hit,), ttft_device = engine_serve(eng, [p], [TIER_NEW])
    if hit != cold:
        raise AssertionError(f"phase 17 (a) {label}: P's tokens on a device prefix hit differ")
    spills.append(evict(long[3:5]))
    restores.append(restore())
    after = tier_counters(eng)
    launches = _build.launch_counts()
    delta = {k: after[k] - before[k] for k in after}
    expected = expected_launches(n_layers, delta, n_single, "_int8" if kv == "paged_int8" else "")
    expected = {k: n for k, n in expected.items() if n}  # no single-shot prefill on the int8 pool
    check_launches(f"phase 17 (a) {label}", launches, expected)
    programs = eng.stats()["programs"]
    graphs = eng.graph_launches()
    if programs != TIER_JAX_PROGRAMS or len(graphs) != (sum(programs.values()) - 1) * eng._use_graphs:
        raise AssertionError(f"phase 17 (a) {label}: programs {programs} ({len(graphs)} graphs), JAX "
                             f"compiles {TIER_JAX_PROGRAMS}; the restore runs eagerly")
    numbers.update(
        ttft_cold_s=ttft_cold, ttft_host_hit_s=[r[0] for r in restores], ttft_device_hit_s=ttft_device,
        restore_ms=[r[1] for r in restores], h2d_ms=[r[2] for r in restores],
        h2d_gb_s=[nbytes / r[2] / 1e6 for r in restores], restore_bytes=nbytes,
        spill_blocks=[n for n, _ in spills], spill_ms=[t * 1e3 for _, t in spills],
        spill_gb_s=[n * block_bytes / t / 1e9 for n, t in spills],
        counters=delta, programs=programs, block_bytes=block_bytes)
    fmt = lambda xs, f: ", ".join(f.format(x) for x in xs)  # noqa: E731
    log(f"phase 17 (a) {label}: P ({TIER_PROMPT} tokens, {TIER_NEW} new, greedy) cold TTFT "
        f"{ttft_cold:.4f}s, host-tier hit {fmt(numbers['ttft_host_hit_s'], '{:.4f}')}s (two runs: one "
        f"restore of {TIER_PROMPT // 16} blocks, {nbytes / 2**20:.0f} MiB, then one chunk), device "
        f"prefix hit {ttft_device:.4f}s (TTFT includes the readback lag of 2 ticks); restore "
        f"{fmt(numbers['restore_ms'], '{:.3f}')} ms of device time, its host-to-device copies "
        f"{fmt(numbers['h2d_ms'], '{:.3f}')} ms = {fmt(numbers['h2d_gb_s'], '{:.2f}')} GB/s; the "
        f"evictions' spills of {fmt(numbers['spill_blocks'], '{}')} blocks landed in the tier "
        f"{fmt(numbers['spill_ms'], '{:.1f}')} ms after their first gather "
        f"({fmt(numbers['spill_gb_s'], '{:.2f}')} GB/s, beside the evicting prompts' chunks; the "
        "tier's first spill also pins its capacity); P's first block bitwise its bytes before the "
        f"eviction, tokens bitwise the cold serve's; counters {delta}; programs {programs} [{card}]")
    return eng, {k: launches[k] for k in expected}, numbers, cold


def prefetch_run(dev, card, model, eng, cold, ttft_hit):
    """(b): P evicted again, then served through an InferenceServer over
    the same engine with kv_prefetch on: its 96 blocks start their copies
    at submit, on the submitter's thread."""
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    long, _ = tier_traffic(model.config.vocab_size)
    p = long[0]
    engine_serve(eng, long[5:7], [2, 2])
    eng._backend.spill_flush()
    if eng._backend.pool._shared_prefix(p):
        raise AssertionError("phase 17 (b): P still has device blocks")
    hits0 = eng._backend.prefetch_hits
    scfg = ServingConfig(mode="continuous", engine_slots=TIER_ENGINE["slots"],
                         engine_max_len=TIER_ENGINE["max_len"], kv_cache="paged",
                         kv_host_tier_bytes=TIER_ENGINE["host_tier_bytes"], kv_prefetch=True)
    with InferenceServer(model, scfg, engine=eng, device=dev) as srv:
        result = srv.submit(p, max_new_tokens=TIER_NEW).result(timeout=300)
    hits = eng._backend.prefetch_hits - hits0
    if hits != TIER_PROMPT // 16:
        raise AssertionError(f"phase 17 (b): {hits} prefetch hits, expected {TIER_PROMPT // 16}")
    if result.tokens[len(p):].tolist() != cold:
        raise AssertionError("phase 17 (b): P's tokens through the server differ from the cold serve's")
    log(f"phase 17 (b) prefetch: P through InferenceServer(kv_prefetch=True): {hits} prefetch hits, "
        f"TTFT {result.ttft_s:.4f}s (from submit; (a)'s host-tier hit on the engine "
        f"{ttft_hit:.4f}s), tokens bitwise the cold serve's [{card}]")
    return dict(prefetch_hits=hits, ttft_s=result.ttft_s)


def sampling(i):
    """phase 4's mix: even requests greedy, odd ones sampled."""
    if i % 2:
        return dict(temperature=0.8, top_k=50, top_p=0.9, seed=i)
    return dict(temperature=0.0, seed=i)


def disagg_mix(dev, model, prompts, scfg, new_tokens, eng):
    """Each request's prompt forward through ``prefill_remote`` on
    DISAGG_WORKERS threads, then ``submit(prefilled=)`` to a server over
    ``eng``; all requests arrive at once. TTFT counts from that arrival."""
    from concurrent.futures import ThreadPoolExecutor

    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer

    srv = InferenceServer(model, scfg, engine=eng, device=dev)
    with srv:
        before = dict(steps=eng.steps, inserted=eng.inserted, remote=eng.remote_prefills)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()

        def one(i):
            kw = sampling(i)
            pre = eng.prefill_remote(prompts[i], max_new_tokens=new_tokens, **kw)
            return time.perf_counter() - t0, srv.submit(prompts[i], max_new_tokens=new_tokens,
                                                        prefilled=pre, **kw)

        with ThreadPoolExecutor(DISAGG_WORKERS) as pool:
            subs = list(pool.map(one, range(len(prompts))))
        results = [f.result(timeout=900) for _, f in subs]
        wall = time.perf_counter() - t0
        launches = _build.launch_counts()
        fallbacks = srv.metrics["prefill_commit_fallbacks"]
        stats = eng.stats()
    delta = dict(steps=eng.steps - before["steps"], inserted=eng.inserted - before["inserted"],
                 remote=eng.remote_prefills - before["remote"])
    return dict(results=results, wall_s=wall, launches=launches, delta=delta, fallbacks=fallbacks,
                programs=stats["programs"], tokens_per_s=len(prompts) * new_tokens / wall,
                ttft_s=sorted(s + r.ttft_s for (s, _), r in zip(subs, results)))


def decode_beside_remote(eng, prompts, card):
    """Decode ms a step at 8 slots (positions 300+, 32 steps each
    synchronised as a block) alone, and while a worker thread runs
    ``prefill_remote`` forwards of a 512-token prompt back to back."""
    import threading

    eng.reset()
    for p in prompts[:8]:
        eng.insert(p[:300], max_new_tokens=200)
    for _ in range(4):
        eng.step()
        eng.poll()

    def steps():
        for _ in range(32):
            eng.step()
            eng.poll()

    alone = sync_ms(steps) / 32
    stop, forwards = threading.Event(), [0]
    long = [p for p in prompts if len(p) == max(len(q) for q in prompts)][0]

    def remote():
        while not stop.is_set():
            wait_for(eng.prefill_remote(long, max_new_tokens=8))
            forwards[0] += 1

    worker = threading.Thread(target=remote, name="phase17-remote")
    worker.start()
    try:
        while forwards[0] < 1:
            time.sleep(0.001)
        beside = sync_ms(steps) / 32
    finally:
        stop.set()
        worker.join(timeout=120)
    eng.reset()
    log(f"phase 17 (c) decode step at 8 slots: {alone:.3f} ms alone, {beside:.3f} ms while a worker "
        f"thread runs prefill_remote forwards of a {len(long)}-token prompt ({forwards[0]} ran) [{card}]")
    return dict(decode_ms=alone, decode_beside_remote_ms=beside, remote_forwards=forwards[0])


def wire_run(dev, card, model, rx, prompts, plain_tokens):
    """(d): WIRE_REQUESTS prefills from a second engine (one slot, the same
    shape) shipped to a server over ``rx``, in process and over TCP
    loopback, committed with submit(prefilled=): tokens bitwise the local
    prefill's; then a corrupted chunk and a reservation released before
    COMMIT, while the server serves."""
    import json as _json

    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.kvtransfer import (_FRAME_BEGIN, _FRAME_CHUNK, _U32, KVTransferManager,
                                                 _crc, _pack_frame, _raise_on_error_ack,
                                                 encode_remote_prefill)
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig
    from accelerate_tpu_torch.utils.fault import (TransferCorruptError, TransferStaleEpochError,
                                                  install_conductor, uninstall_conductor)

    n_layers = model.config.num_hidden_layers
    tx = ContinuousBatchingEngine(model, slots=1, max_len=SERVING["engine_max_len"],
                                  prompt_bucket=SERVING["engine_prompt_bucket"], kv_cache="paged",
                                  block_size=SERVING["engine_block_size"], attention_impl="kernel",
                                  device=dev)
    numbers = {}
    steps0, forwards0 = rx.steps, tx.remote_prefills
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    with InferenceServer(model, ServingConfig(**SERVING), engine=rx, device=dev) as srv:
        for transport in ("inproc", "tcp"):
            mgr = KVTransferManager(transport=transport, chunk_bytes=WIRE_CHUNK_BYTES)
            try:
                mgr.register("rx", srv)
                ship_ms, nbytes, futs = [], [], []
                for i in range(WIRE_REQUESTS):
                    kw = sampling(i)
                    pre = wait_for(tx.prefill_remote(prompts[i], max_new_tokens=MAIN_NEW_TOKENS, **kw))
                    nbytes.append(leaf_bytes(pre))
                    t0 = time.perf_counter()
                    tid = mgr.ship(pre, "rx", trace_id=f"phase17-{transport}-{i}")
                    ship_ms.append((time.perf_counter() - t0) * 1e3)
                    futs.append(srv.submit(prompts[i], max_new_tokens=MAIN_NEW_TOKENS,
                                           prefilled=mgr.take("rx", tid), **kw))
                nbytes = statistics.median(nbytes)
                results = [f.result(timeout=300) for f in futs]
            finally:
                mgr.close()
            for i, r in enumerate(results):
                if not np.array_equal(r.tokens, plain_tokens[i]):
                    raise AssertionError(f"phase 17 (d) {transport}: request {i}'s tokens differ from "
                                         "the local prefill's")
            if srv.metrics["prefill_commit_fallbacks"]:
                raise AssertionError(f"phase 17 (d) {transport}: a shipped prefill fell back")
            med = statistics.median(ship_ms)
            numbers[transport] = dict(bytes=nbytes, ship_ms=ship_ms, gb_s=nbytes / med / 1e6)
            log(f"phase 17 (d) {transport}: {WIRE_REQUESTS} prefills of {nbytes / 2**20:.1f} MiB each (meta aside) "
                f"(chunks of {WIRE_CHUNK_BYTES >> 20} MiB) shipped in "
                + ", ".join(f"{x:.1f}" for x in ship_ms) + f" ms (median {med:.1f} ms, "
                f"{nbytes / med / 1e6:.2f} GB/s: encode, crc32s, frames, decode and the copy to the "
                f"card), tokens bitwise the local prefill's [{card}]")
        launches = _build.launch_counts()
        forwards, steps = tx.remote_prefills - forwards0, rx.steps - steps0
        # a corrupted chunk dies typed and frees its reservation
        mgr = KVTransferManager(transport="inproc", chunk_bytes=WIRE_CHUNK_BYTES)
        try:
            recv = mgr.register("rx", srv)
            payload = encode_remote_prefill(tx.prefill_remote(prompts[0], max_new_tokens=8))
            meta = {"wire_version": 1, "trace_id": None, "n_chunks": 1, "total_bytes": len(payload),
                    "payload_crc": _crc(payload), "prompt_len": len(prompts[0]), "prefix_crc": 0}
            free = rx.free_slots()
            _raise_on_error_ack(recv.feed(_pack_frame(_FRAME_BEGIN, "corrupt",
                                                      _json.dumps(meta).encode())))
            try:
                _raise_on_error_ack(recv.feed(_pack_frame(
                    _FRAME_CHUNK, "corrupt", _U32.pack(0) + _U32.pack(_crc(payload) ^ 1) + payload)))
                raise AssertionError("phase 17 (d): a corrupted chunk was taken")
            except TransferCorruptError:
                pass
            if rx.free_slots() != free:
                raise AssertionError("phase 17 (d): the corrupted transfer kept its reservation")
            # a reservation released before COMMIT: the sender gets the
            # stale-epoch error, and requests in flight finish unharmed
            busy = [srv.submit(prompts[i], max_new_tokens=MAIN_NEW_TOKENS, **sampling(i))
                    for i in range(4, 6)]

            def release_at_commit(name, context):
                if name == "kvtx.commit":
                    st = recv._inflight[context["transfer"]]
                    rx.release_reservation(st.slot, st.epoch)

            install_conductor(release_at_commit)
            try:
                mgr.ship(tx.prefill_remote(prompts[1], max_new_tokens=8), "rx")
                raise AssertionError("phase 17 (d): a transfer whose reservation was released committed")
            except TransferStaleEpochError:
                pass
            finally:
                uninstall_conductor(release_at_commit)
            for i, f in zip(range(4, 6), busy):
                if not np.array_equal(f.result(timeout=300).tokens, plain_tokens[i]):
                    raise AssertionError("phase 17 (d): a request served beside the stale transfer "
                                         "differs")
            numbers["receiver"] = dict(recv.stats)
        finally:
            mgr.close()
    expected = {"flash_fwd_mma": n_layers * forwards, "paged_decode_mma": n_layers * steps,
                "fused_sample": forwards + steps}
    check_launches("phase 17 (d)", launches, expected)
    log(f"phase 17 (d): a corrupted chunk raised TransferCorruptError and freed its slot; a "
        f"reservation released before COMMIT raised TransferStaleEpochError on the sender while "
        f"2 requests in flight finished bitwise; receiver {numbers['receiver']} [{card}]")
    return {k: launches[k] for k in expected}, numbers


def phase_disaggregated(dev, card, model):
    """Phase 17: the host-RAM KV tier (a) with prefetch (b), disaggregated
    prefill (c) and the KV transfer wire (d), on the phase-4 model."""
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    by_path, numbers = {}, {}
    n_layers = model.config.num_hidden_layers
    eng, by_path["host_tier"], numbers["host_tier"], cold = host_tier_run(
        dev, card, model, "paged", "bf16 pool")
    numbers["prefetch"] = prefetch_run(dev, card, model, eng, cold,
                                       numbers["host_tier"]["ttft_host_hit_s"][-1])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng8, by_path["host_tier_int8"], numbers["host_tier_int8"], _ = host_tier_run(
        dev, card, model, "paged_int8", "int8 pool")
    del eng8
    gc.collect()
    torch.cuda.empty_cache()
    # (c) phase 4's mix through plain inserts, then through prefill_remote
    # on worker threads and submit(prefilled=), on one engine
    scfg = ServingConfig(**SERVING)
    prompts, warm = main_traffic(model.config.vocab_size)
    plain = serve_mix(dev, model, prompts, scfg, MAIN_NEW_TOKENS, warm=warm)
    eng = plain["engine"]
    check_launches("phase 17 (c) plain", plain["launches"],
                   main_expected(n_layers, len(prompts), plain))
    log_run("phase 17 (c) plain inserts (phase 4's mix)", plain, card)
    disagg = disagg_mix(dev, model, prompts, scfg, MAIN_NEW_TOKENS, eng)
    for i, (a, b) in enumerate(zip(plain["results"], disagg["results"])):
        if not np.array_equal(a.tokens, b.tokens):
            raise AssertionError(f"phase 17 (c): request {i}'s tokens through prefill_remote differ "
                                 "from plain insert's")
    if disagg["programs"] != DISAGG_JAX_PROGRAMS or disagg["fallbacks"]:
        raise AssertionError(f"phase 17 (c): programs {disagg['programs']} (JAX: "
                             f"{DISAGG_JAX_PROGRAMS}), fallbacks {disagg['fallbacks']}")
    if len(eng.graph_launches()) != 2 * eng._use_graphs:
        raise AssertionError(f"phase 17 (c): graphs {sorted(eng.graph_launches())}; prefill_forward "
                             "and prefill_commit run eagerly")
    expected = {"flash_fwd_mma": n_layers * len(prompts),
                "paged_decode_mma": n_layers * disagg["delta"]["steps"],
                "fused_sample": disagg["delta"]["steps"] + len(prompts)}
    check_launches("phase 17 (c) disagg", disagg["launches"], expected)
    by_path["disagg"] = {k: disagg["launches"][k] for k in expected}
    cfg = model.config
    window = 2 * n_layers * SERVING["engine_max_len"] * cfg.num_key_value_heads * cfg.head_dim * 2
    ttft = disagg["ttft_s"]
    log(f"phase 17 (c) disaggregated: {disagg['tokens_per_s']:.1f} generated tokens/s in "
        f"{disagg['wall_s']:.3f}s ({DISAGG_WORKERS} prefill threads, {disagg['delta']['remote']} "
        f"remote prefills, engine steps {disagg['delta']['steps']}); TTFT from arrival min "
        f"{ttft[0]:.4f}s p50 {ttft[len(ttft) // 2]:.4f}s max {ttft[-1]:.4f}s; every request's tokens "
        f"bitwise plain insert's; programs {disagg['programs']}; fallbacks 0; each RemotePrefill "
        f"holds a max_len-wide KV window of {window / 2**20:.0f} MiB [{card}]")
    steady = decode_beside_remote(eng, prompts, card)
    numbers["disagg"] = dict(plain=run_numbers([plain])[0], tokens_per_s=disagg["tokens_per_s"],
                             wall_s=disagg["wall_s"], ttft_s=ttft, window_bytes=window,
                             programs=disagg["programs"], steps=disagg["delta"]["steps"], **steady)
    plain_tokens = [r.tokens for r in plain["results"]]
    del plain, disagg
    by_path["kvtx"], numbers["kvtx"] = wire_run(dev, card, model, eng, prompts, plain_tokens)
    del eng
    gc.collect()  # an engine and its store's reader hold each other
    torch.cuda.empty_cache()
    return by_path, numbers



# ---------------------------------------------------------------- phase 12
STATIC_B, STATIC_PROMPT, STATIC_NEW = 8, 512, 128
STATIC_BACKENDS = ("dense", "paged", "paged_int8")
STATIC_SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
# the server's traffic: (requests, prompt length), all greedy, 64 new tokens
STATIC_TRAFFIC = ((24, 512), (8, 256))
STATIC_SERVER_NEW = 64


def static_reference(cfg_r, params, ids, out):
    """Teacher-forced plain forward (attention ``"xla"``) over each row's
    prompt and generated tokens: the f32 logits (B, new, V) that scored
    each generated token."""
    from accelerate_tpu_torch.models.llama import llama_apply

    p = ids.shape[1]
    return llama_apply(cfg_r, params, out[:, :-1].long())[:, p - 1:]


def static_decode_ms(prog, steps, eager_step=None):
    """Mean ms a decode step over ``steps`` steps of a program that just
    ran, its position and output column reset to the prompt's end (so no
    step leaves the cache): graph replays, or ``eager_step`` calls."""
    prog.pos.fill_(prog.prompt_len)
    prog.col.zero_()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        if eager_step is None:
            prog.graph.replay()
        else:
            eager_step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def top1_against_greedy(top1, greedy, cfg_r, params, ids):
    """(rows of ``top1`` equal to ``greedy``, the largest gap, in bf16 ulps
    of the plain forward's largest |logit|, between the two tokens where a
    row first leaves greedy). The logits are bf16 values: two can tie at
    the top, where greedy takes the first index and a top_k=1 draw either;
    past that point the rows differ. Equal prefixes share the teacher-forced
    reference of ``greedy``."""
    ref = static_reference(cfg_r, params, ids, greedy)
    p, same, worst = ids.shape[1], 0, 0.0
    ulp = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    for r in range(top1.shape[0]):
        diff = (top1[r, p:] != greedy[r, p:]).nonzero()
        if diff.numel() == 0:
            same += 1
            continue
        j = int(diff[0, 0])
        gap = (ref[r, j, greedy[r, p + j].long()] - ref[r, j, top1[r, p + j].long()]).abs().item()
        worst = max(worst, gap / ulp)
    return same, worst


def static_programs(model):
    return getattr(model, "_generate_cache", None) or {}


def phase_static(dev, card, model):
    """Phase 12: static generation on phase 4's model (Llama-3-8B, bf16,
    flash prefill). (a) ``generate`` at B = 8, 512 prompt and 128 new
    tokens under each KV backend, greedy: the graph runs bitwise equal to
    the eager run, teacher-forced agreement with the plain forward, a
    planted frozen position that must fail it; sampled determinism by seed
    and top_k=1 against greedy. (b) ``InferenceServer(model)`` at the
    default ``ServingConfig()`` (static, dense, 8 rows a batch) over 32
    greedy requests, each reply equal to a direct ``generate`` of its
    batch's rows. (c) prefill and decode ms, tokens/s, peak memory, B1
    launches. Returns (launches of (b)'s first run, numbers)."""
    import dataclasses
    from types import SimpleNamespace

    from accelerate_tpu_torch import inference
    from accelerate_tpu_torch.engine import _disable_graphs
    from accelerate_tpu_torch.inference import generate, generate_cache_stats
    from accelerate_tpu_torch.models.llama import llama_prefill
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    t_phase = time.perf_counter()
    cfg = model.config
    n_layers = cfg.num_hidden_layers
    cfg_r = dataclasses.replace(cfg, attention_impl="xla")
    params = model.params
    rng = np.random.default_rng(12)
    ids = rng.integers(0, cfg.vocab_size, size=(STATIC_B, STATIC_PROMPT)).astype(np.int32)
    ids_t = torch.from_numpy(ids).to(dev)
    static_programs(model).clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    numbers = dict(backends={})

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def agreement(out):
        return choice_agreement(out[:, STATIC_PROMPT:].long(), static_reference(cfg_r, params, ids_t, out))

    greedy = {}
    for kv in STATIC_BACKENDS:
        kw = dict(kv_backend=kv, kv_block_size=16)
        with _disable_graphs():
            eager, eager_s = timed(lambda: generate(model, ids, STATIC_NEW, **kw))
        first, first_s = timed(lambda: generate(model, ids, STATIC_NEW, **kw))  # captures
        _build.reset_launch_counts()
        out, graph_s = timed(lambda: generate(model, ids, STATIC_NEW, **kw))
        launches = _build.launch_counts()
        check_launches(f"phase 12 generate {kv}", launches, {"flash_fwd_mma": n_layers})
        if not (torch.equal(first, eager) and torch.equal(out, eager)):
            raise AssertionError(f"phase 12 {kv}: the graph runs' tokens differ from the eager run's")
        if out.shape != (STATIC_B, STATIC_PROMPT + STATIC_NEW) or not torch.equal(out[:, :STATIC_PROMPT], ids_t):
            raise AssertionError(f"phase 12 {kv}: wrong shape or prompt")
        share, gap, gap_ulps = agreement(out)
        log(f"phase 12 generate {kv} (B={STATIC_B}, prompt {STATIC_PROMPT}, {STATIC_NEW} new, greedy): "
            f"graph runs bitwise equal to the eager run; teacher-forced against the plain forward: "
            f"argmax share {share:.4f} (min {GREEDY_SHARE_MIN}), largest gap at the rest {gap:.4f} = "
            f"{gap_ulps:.3f} bf16 ulps (limit {Q_NEAR_TIE_ULPS}); wall: eager {eager_s:.3f}s, first "
            f"graph call (captures) {first_s:.3f}s, graph {graph_s:.3f}s = "
            f"{STATIC_B * STATIC_NEW / graph_s:.1f} generated tokens/s [{card}]")
        if not (share >= GREEDY_SHARE_MIN and gap_ulps <= Q_NEAR_TIE_ULPS):
            raise AssertionError(f"phase 12 {kv}: generated tokens disagree with the plain forward")
        greedy[kv] = out
        numbers["backends"][kv] = dict(share=share, gap=gap, gap_ulps=gap_ulps, eager_s=eager_s,
                                       first_graph_s=first_s, graph_s=graph_s,
                                       tokens_per_s=STATIC_B * STATIC_NEW / graph_s)
    dense_key = next(k for k in static_programs(model) if k[9] == "dense" and not k[5])

    # the decode step alone: graph replays against the same step run eagerly
    for kv in STATIC_BACKENDS:
        key = next(k for k in static_programs(model) if k[9] == kv and not k[5])
        numbers["backends"][kv]["decode_ms"] = static_decode_ms(static_programs(model)[key], STATIC_NEW)
    prog = static_programs(model)[dense_key]
    prog.pos.fill_(prog.prompt_len)
    prog.col.zero_()
    numbers["profile"] = profile_decode(
        SimpleNamespace(step=lambda: prog.graph.replay(), poll=lambda: None),
        numbers["backends"]["dense"]["decode_ms"], card, label="phase 12 dense decode (graph)",
        out="profile_static_decode.txt")
    eager_ms = static_decode_ms(prog, 32, eager_step=lambda: prog.step(cfg, params))
    prefill_ms = time_ms(lambda: llama_prefill(cfg, params, ids_t.long(), STATIC_PROMPT + STATIC_NEW),
                         iters=3, repeats=3, warmup=1)
    numbers.update(prefill_ms=prefill_ms, decode_eager_ms=eager_ms)
    log(f"phase 12 B={STATIC_B}: prefill of {STATIC_PROMPT} tokens {prefill_ms:.2f} ms; decode step "
        f"(graph replay) dense {numbers['backends']['dense']['decode_ms']:.3f} ms, paged "
        f"{numbers['backends']['paged']['decode_ms']:.3f}, paged_int8 "
        f"{numbers['backends']['paged_int8']['decode_ms']:.3f}; the dense step eagerly {eager_ms:.3f} ms "
        f"[{card}]")

    # the same prefill under the profiler: B1 once a layer
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        llama_prefill(cfg, params, ids_t.long(), STATIC_PROMPT + STATIC_NEW)
        torch.cuda.synchronize()
    events = device_events(prof, "chiprun_out/trace_static_prefill.json")
    profiled_b1 = sum(1 for name, _, _ in events if "flash_fwd" in name)
    log(f"phase 12 profiled prefill: {profiled_b1} flash_fwd kernels (expected {n_layers}), "
        f"{len(events)} device events")
    if events and profiled_b1 != n_layers:
        raise AssertionError(f"phase 12: the profiler saw {profiled_b1} B1 launches in a prefill")
    numbers["profiled_b1_per_prefill"] = profiled_b1 if events else None

    # planted fault: the step's position frozen, so every step rewrites one
    # cache column at one rotation; the agreement check must fail
    advance = inference._advance
    inference._advance = lambda p: p.col.add_(1)
    static_programs(model).pop(dense_key)
    try:
        bad = generate(model, ids, STATIC_NEW)
    finally:
        inference._advance = advance
        static_programs(model).clear()
    bad_share, bad_gap, bad_ulps = agreement(bad)
    log(f"phase 12 planted fault (position frozen): argmax share {bad_share:.4f}, largest gap "
        f"{bad_gap:.4f} = {bad_ulps:.3f} bf16 ulps (the check must fail)")
    if bad_share >= GREEDY_SHARE_MIN and bad_ulps <= Q_NEAR_TIE_ULPS:
        raise AssertionError("phase 12's agreement check cannot see a frozen position")
    numbers.update(fault_share=bad_share, fault_gap_ulps=bad_ulps)

    # sampled: one seed twice (the first call captures), another seed; top_k=1
    s1 = generate(model, ids, STATIC_NEW, seed=1, **STATIC_SAMPLED)
    s2 = generate(model, ids, STATIC_NEW, seed=1, **STATIC_SAMPLED)
    s3 = generate(model, ids, STATIC_NEW, seed=2, **STATIC_SAMPLED)
    k1 = generate(model, ids, STATIC_NEW, temperature=0.8, top_k=1, seed=3)
    vocab_ok = bool(((s1 >= 0) & (s1 < cfg.vocab_size)).all().item())
    same_rows, tie_ulps = top1_against_greedy(k1, greedy["dense"], cfg_r, params, ids_t)
    log(f"phase 12 sampled ({STATIC_SAMPLED}): seed 1 twice equal {torch.equal(s1, s2)}, seed 2 "
        f"differs {not torch.equal(s1, s3)}; top_k=1: {same_rows}/{STATIC_B} rows equal greedy, the "
        f"others leave it first at a tie of the bf16 logits, {tie_ulps:.3f} bf16 ulps apart in the "
        f"plain forward (limit {Q_NEAR_TIE_ULPS})")
    if not (torch.equal(s1, s2) and not torch.equal(s1, s3) and vocab_ok
            and tie_ulps <= Q_NEAR_TIE_ULPS):
        raise AssertionError("phase 12: sampled generate is not deterministic by seed, or top_k=1 "
                             "is not greedy")
    numbers.update(top1_rows_equal_greedy=same_rows, top1_divergence_ulps=tie_ulps)
    numbers["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    static_programs(model).clear()
    torch.cuda.empty_cache()

    # (b) the static server at its defaults
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for count, n in STATIC_TRAFFIC for _ in range(count)]
    scfg = ServingConfig()
    runs = []
    for rep in range(2):
        with InferenceServer(model, scfg, device=dev) as srv:
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            futs = [srv.submit(p, max_new_tokens=STATIC_SERVER_NEW) for p in prompts]
            results = [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            launches = _build.launch_counts()
            batches = srv.metrics["batches"]
        keys = {(len(p), r.batch_size) for p, r in zip(prompts, results)}
        check_launches(f"phase 12 server run {rep + 1}", launches, {"flash_fwd_mma": n_layers * batches})
        if rep == 0 and generate_cache_stats(model)["size"] != len(keys):
            raise AssertionError(f"phase 12: {generate_cache_stats(model)['size']} programs for the "
                                 f"batches' {len(keys)} keys")
        runs.append(dict(wall_s=wall, tokens_per_s=len(prompts) * STATIC_SERVER_NEW / wall,
                         batches=batches, launches=launches,
                         latency_p50_s=sorted(r.latency_s for r in results)[len(results) // 2],
                         results=results))
        log(f"phase 12 server run {rep + 1} (ServingConfig() defaults: static, dense; "
            f"{len(prompts)} greedy requests, prompts {[n for _, n in STATIC_TRAFFIC]}, "
            f"{STATIC_SERVER_NEW} new each): {batches} batches of sizes "
            f"{sorted(r.batch_size for r in results)[::8]}, {runs[-1]['tokens_per_s']:.1f} generated "
            f"tokens/s in {wall:.3f}s, latency p50 {runs[-1]['latency_p50_s']:.3f}s "
            f"({'captures its programs' if rep == 0 else 'warm'}) [{card}]")
    if any(r.batch_size != STATIC_B for run in runs for r in run["results"]):
        raise AssertionError("phase 12: a server batch did not fill its 8 rows; the replies cannot "
                             "be matched to a direct generate of consecutive rows")
    for g in range(0, len(prompts), STATIC_B):
        rows = np.stack(prompts[g:g + STATIC_B])
        total = rows.shape[1] + STATIC_SERVER_NEW
        direct = generate(model, rows, STATIC_SERVER_NEW, pad_to=-(-total // 64) * 64).cpu().numpy()
        for run in runs:
            for i, r in enumerate(run["results"][g:g + STATIC_B]):
                if not np.array_equal(r.tokens, direct[i]):
                    raise AssertionError(f"phase 12: request {g + i}'s reply differs from a direct "
                                         "generate of its batch")
    log(f"phase 12 server: every reply of both runs equals a direct generate of its batch's rows; "
        f"{generate_cache_stats(model)['size']} programs; phase 12 took "
        f"{time.perf_counter() - t_phase:.1f}s")
    static_programs(model).clear()
    torch.cuda.empty_cache()
    numbers["server"] = [{k: v for k, v in run.items() if k != "results"} for run in runs]
    return {"flash_fwd_mma": runs[0]["launches"]["flash_fwd_mma"]}, numbers


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
    return choice_agreement(logits.argmax(-1), ref)


def choice_agreement(chosen, ref):
    """:func:`greedy_agreement` of chosen token ids (...) against the
    ``ref`` logits (..., V) that scored them."""
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
    # the Accelerator holds the model and optimizer it prepared
    del model, optimizer, step_fn, loader, acc
    gc.collect()
    torch.cuda.empty_cache()
    gradients = variant_gradients(card, cfg, batch)
    variants = train_variants(card, cfg, batch)
    return {k: launches[k] for k in expected}, dict(
        losses=losses, step_ms=step_ms, tokens_per_s=tokens_per_s, mfu=mfu, peak_memory_bytes=peak,
        batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, layers=TRAIN_LAYERS, profile=profile,
        gradients=gradients, variants=variants)


TRAIN_VARIANT_WARMUP, TRAIN_VARIANT_STEPS = 2, 4  # untimed and timed steps of a variant
# the variants' first-step gradients, before any update, leaf by leaf on one
# model and batch: max |g - g_ref| over max |g_ref|, the worst leaf. Remat
# recomputes the same kernels on the same inputs, so each policy's
# gradients equal remat "nothing"'s bitwise at the same chunked-CE setting.
# The chunked CE sums its chunks' f32 products of dh before one bf16
# rounding, where the dense head's backward rounds one GEMM's sum: dh and
# the leaves (bf16 values) apart by a few bf16 ulps (2^-8 each) of a leaf's
# largest element
TRAIN_GRAD_CHUNKED_TOL = 2.0 ** -6
# the variants' losses against remat "nothing" without chunked CE: the same
# first loss (no update yet) up to the loss's f32 summation, then bf16
# steps apart (AdamW normalises each gradient, so a rounding difference
# moves an element by up to lr)
TRAIN_VARIANT_LOSS_RTOL = 1e-2


def variant_gradients(card, cfg0, batch):
    """Phase 6's gradient check of the remat policies and the chunked CE:
    one model from seed 0, the first step's gradients (``backward`` with
    no update) under each of the six variants, each held against remat
    ``"nothing"`` at the same chunked-CE setting (bitwise), and chunked
    against dense at ``TRAIN_GRAD_CHUNKED_TOL``. A planted fault, the first
    vocabulary chunk's term of dh zeroed in the chunked CE's backward, must
    exceed that limit."""
    import dataclasses

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.model import unwrap_model
    from accelerate_tpu_torch.models.llama import create_llama, llama_loss
    from accelerate_tpu_torch.ops import losses
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(mixed_precision="bf16")
    model = create_llama(cfg0, seed=0, device=acc.device)
    params = list(model.named_parameters())
    # backward() accumulates for a prepared optimizer; nothing steps it
    model, optimizer = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.0))

    def grads(policy, chunked):
        unwrap_model(model).config = dataclasses.replace(cfg0, remat_policy=policy,
                                                         use_chunked_ce=chunked)
        for _, p in params:
            p.grad = None
        acc.backward(llama_loss, batch)
        return {n: p.grad for n, p in params}

    out, leaves = {}, {}

    def record(key, g, ref):
        errs = {n: ((g[n] - ref[n]).abs().max() / ref[n].abs().max()).item() for n in ref}
        leaves[key] = max(errs, key=errs.get)
        out[key] = errs[leaves[key]]

    @contextlib.contextmanager
    def zeroed_first_dh_chunk():
        # the backward's head products alternate: chunk c's logits, then
        # its dh term; the second is chunk 0's dh term
        product, backward = losses._f32_product, losses._ChunkedNLL.backward
        calls = []

        def planted_product(x, w):
            out = product(x, w)
            calls.append(None)
            return torch.zeros_like(out) if len(calls) == 2 else out

        def planted_backward(ctx, grad):
            losses._f32_product = planted_product
            try:
                return backward(ctx, grad)
            finally:
                losses._f32_product = product

        losses._ChunkedNLL.backward = staticmethod(planted_backward)
        try:
            yield
        finally:
            losses._ChunkedNLL.backward = staticmethod(backward)

    ref = grads("nothing", False)
    for chunked in (False, True):
        if chunked:
            dense, ref = ref, grads("nothing", True)
            record("chunked CE vs dense", ref, dense)
            with zeroed_first_dh_chunk():
                record("planted fault vs dense", grads("nothing", True), dense)
            del dense
        for policy in ("dots", "minimal"):
            record(f"remat {policy} vs nothing, chunked CE {'on' if chunked else 'off'}",
                   grads(policy, chunked), ref)
    del ref, model, optimizer, params, acc
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 6 first-step gradients, worst leaf's max |g - g_ref| / max |g_ref|: "
        + ", ".join(f"{k} {v:.3e} ({leaves[k]})" for k, v in out.items())
        + f" (remat: bitwise; chunked CE: limit {TRAIN_GRAD_CHUNKED_TOL:.3e}) [{card}]")
    remat = {k: v for k, v in out.items() if k.startswith("remat")}
    if any(v != 0.0 for v in remat.values()):
        raise AssertionError(f"phase 6: a remat policy's gradients differ from remat nothing's: {remat}")
    if not out["chunked CE vs dense"] <= TRAIN_GRAD_CHUNKED_TOL:
        raise AssertionError("phase 6: the chunked CE's gradients differ from the dense loss's "
                             "beyond bf16 rounding")
    if not out["planted fault vs dense"] > TRAIN_GRAD_CHUNKED_TOL:
        raise AssertionError("phase 6's gradient limit cannot see a zeroed dh chunk")
    return out


def train_variants(card, cfg0, batch):
    """Phase 6's step under remat ``"nothing"``, ``"dots"`` and
    ``"minimal"``, each with ``use_chunked_ce`` off and on (chunks of
    ``ce_chunk_size`` = 4096), in two passes, the second in the reverse
    order: each time a fresh model from the same seed, then
    ``TRAIN_VARIANT_WARMUP`` untimed and ``TRAIN_VARIANT_STEPS`` timed
    steps on the same batch. Step ms (one reading a pass), peak memory
    (``torch.cuda.max_memory_allocated`` from a reset just before the model
    is built), the flash forward's launches per step (every policy
    recomputes it: the checkpoint policies cannot see a ctypes launch) and
    the losses, which must agree across variants."""
    import dataclasses

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import create_llama, llama_loss
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    out = {}
    variants = [(p, c) for p in ("nothing", "dots", "minimal") for c in (False, True)]
    for policy, chunked in variants + variants[::-1]:
        name = f"remat {policy}, chunked CE {'on' if chunked else 'off'}"
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        acc = Accelerator(mixed_precision="bf16")
        cfg = dataclasses.replace(cfg0, remat_policy=policy, use_chunked_ce=chunked)
        model = create_llama(cfg, seed=0, device=acc.device)
        optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=0.01)
        model, optimizer = acc.prepare(model, optimizer)
        step_fn = acc.train_step(llama_loss, max_grad_norm=1.0)
        losses = [step_fn(batch) for _ in range(TRAIN_VARIANT_WARMUP)]
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        losses += [step_fn(batch) for _ in range(TRAIN_VARIANT_STEPS)]
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / TRAIN_VARIANT_STEPS * 1e3
        fwd = _build.launch_counts()["flash_fwd_mma"] / TRAIN_VARIANT_STEPS
        entry = out.setdefault(name, dict(step_ms=[], peak_memory_bytes=[], losses=[],
                                          flash_fwd_per_step=fwd))
        entry["step_ms"].append(step_ms)
        entry["peak_memory_bytes"].append(torch.cuda.max_memory_allocated())
        entry["losses"].append([x.item() for x in losses])
        del model, optimizer, step_fn, acc
        gc.collect()
        if fwd != 2 * TRAIN_LAYERS:
            raise AssertionError(f"phase 6 {name}: {fwd} flash forward launches a step, "
                                 f"expected {2 * TRAIN_LAYERS} (the recompute runs it again)")
    torch.cuda.empty_cache()
    base = out["remat nothing, chunked CE off"]["losses"][0]
    worst = max(abs(a - b) / abs(b) for v in out.values() for run in v["losses"]
                for a, b in zip(run, base))
    log(f"phase 6 variants ({TRAIN_VARIANT_STEPS} timed steps each after {TRAIN_VARIANT_WARMUP} "
        "untimed, in two passes; step ms a pass, peak memory GB, flash forward launches a step, "
        "losses): " + "; ".join(
            f"{n}: {' / '.join(f'{x:.1f}' for x in v['step_ms'])} ms, "
            f"{max(v['peak_memory_bytes']) / 1e9:.2f} GB, "
            f"{v['flash_fwd_per_step']:.0f}, {[round(x, 4) for x in v['losses'][0]]}"
            for n, v in out.items())
        + f"; largest relative loss difference {worst:.2e} (limit {TRAIN_VARIANT_LOSS_RTOL}) [{card}]")
    if not worst <= TRAIN_VARIANT_LOSS_RTOL:
        raise AssertionError("phase 6 variants: the losses disagree beyond bf16 steps")
    return out


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


def profile_train_step(step_fn, batch, step_ms, card, label="phase 6", name="train"):
    """Device time of one training step by kernel group, from a
    torch.profiler trace of that step; the busy share is the union of the
    kernels' intervals over the profiled step's own wall time. The table
    goes to chiprun_out/profile_<name>.txt, the trace to trace_<name>.json."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    Path("chiprun_out").mkdir(exist_ok=True)
    Path(f"chiprun_out/profile_{name}.txt").write_text(
        prof.key_averages().table(sort_by="self_device_time_total", row_limit=50))
    events = device_events(prof, path=f"chiprun_out/trace_{name}.json")
    if not events:
        log(f"{label} profile: the profiler recorded no device time (not measured)")
        return None
    groups = dict.fromkeys([g for g, _ in TRAIN_GROUPS] + ["elementwise"], 0.0)
    for name, _, dur in events:
        lower = name.lower()
        group = next((g for g, keys in TRAIN_GROUPS if any(k in lower for k in keys)), "elementwise")
        groups[group] += dur / 1e3
    busy_ms = busy_us(events) / 1e3
    log(f"{label} train-step profile: kernels busy {busy_ms:.1f} ms of the profiled step's "
        f"{wall_ms:.1f} ms (busy share {busy_ms / wall_ms:.3f}; unprofiled step {step_ms:.1f} ms); "
        f"by group ms " + ", ".join(f"{g}={v:.1f}" for g, v in groups.items()) + f" [{card}]")
    return dict(busy_ms=busy_ms, profiled_wall_ms=wall_ms, busy_share=busy_ms / wall_ms,
                groups_ms=groups, kernels=len(events))


# ---------------------------------------------------------------- phase 16
# fp8 training: phase 6's model, seed, batch and optimizer under
# Accelerator(mixed_precision="fp8"): the seven projections of every layer
# through ops.fp8.fp8_dot (torch._scaled_mm on e4m3 operands, an e5m2
# cotangent), the attention through B1-B3, the head in bf16 with f32 logits
FP8_WARMUP, FP8_STEPS = 2, 4
# the losses held within TRAIN_VARIANT_LOSS_RTOL of phase 6's: the first
# four (no update, then three). Phase 6 memorizes its one repeated batch
# (the loss halves a step from the fifth), and a trajectory that does so
# grows a gradient difference tenfold in two steps: phase 6's chunked-CE
# variant, a bf16 rounding apart, moves from 3e-4 to 3e-3 of the loss
# between steps 4 and 6. fp8's gradients differ from bf16's by e5m2 steps
# (12-25 % of an element), so its fifth and sixth losses move by several
# percent (5.3e-2 at the sixth on an H100): they are printed, not held
FP8_HELD_LOSSES = 4
FP8_M = TRAIN_BATCH * TRAIN_SEQ  # the projections' rows at phase 6's batch
# (M, K, N) of each projection of Llama-3-8B at phase 6's batch (q and o, k
# and v, gate and up share theirs), and a product whose dims are no multiple
# of 16 (a generic module's): _scaled_mm takes it zero-padded
FP8_SHAPES = {"q_proj": (FP8_M, 4096, 4096), "k_proj/v_proj": (FP8_M, 4096, 1024),
              "o_proj": (FP8_M, 4096, 4096), "gate_proj/up_proj": (FP8_M, 4096, 14336),
              "down_proj": (FP8_M, 14336, 4096), "unaligned": (37, 300, 260)}
# _scaled_mm against its plain version (the same fp8 operands' f32 product
# on the card, f32 sums, the scale after): both round a sum of exact
# products to bf16, and the tensor cores keep fewer bits of a partial sum
# than f32 before cuBLAS promotes it: on an H100 the outputs and gradients
# were apart by up to 1.6 bf16 ulps of the largest |reference| (6.2e-3).
# FP8_MM_TOL is 2 such ulps, 2^-7; a scale off by one e4m3 step (2^-3) is
# 16 times that
FP8_MM_TOL = 2.0 ** -7
FP8_FAULT_STEP = 2.0 ** -3
FP8_GENERIC_STEPS = 5
FP8_GEN_BATCH, FP8_GEN_PROMPT, FP8_GEN_NEW = 4, 512, 64
FP8_PEAK = 1979e12  # H100 SXM dense fp8 (NVIDIA data sheet, at 700 W)


def fp8_projection_checks(dev, card, gen):
    """Phase 16 (b): one projection of each Llama-3-8B shape at M = 8192
    and one product of unaligned dims:
    the quantized bytes on the card bitwise the CPU's, ``fp8_dot``'s
    forward and both gradients (``_scaled_mm``) against the plain version
    on the same operands, a planted scale fault, and each shape's
    ``_scaled_mm`` ms against a bf16 ``torch.mm`` of the same shape."""
    from accelerate_tpu_torch.ops import fp8

    out = {}
    for name, (m, k, n) in FP8_SHAPES.items():
        x = (torch.randn(m, k, generator=gen, device=dev) * 2.0).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        g = (torch.randn(m, n, generator=gen, device=dev) * 1e-3).to(torch.bfloat16)
        (qx, sx), (qw, sw), (qg, sg) = (fp8.quantize_e4m3(x), fp8.quantize_e4m3(w),
                                        fp8.quantize_e5m2(g))
        for label, (q, s), (qc, sc) in (("x", (qx, sx), fp8.quantize_e4m3(x.cpu())),
                                        ("w", (qw, sw), fp8.quantize_e4m3(w.cpu())),
                                        ("g", (qg, sg), fp8.quantize_e5m2(g.cpu()))):
            if not (torch.equal(q.view(torch.uint8).cpu(), qc.view(torch.uint8))
                    and s.item() == sc.item()):
                raise AssertionError(f"phase 16 (b) {name}: the card's quantized {label} differs "
                                     "from the CPU's")
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = fp8.scaled_mm_count()
        y = fp8.fp8_dot(xr, wr)
        y.backward(g)
        if fp8.scaled_mm_count() - before != 3:
            raise AssertionError(f"phase 16 (b) {name}: {fp8.scaled_mm_count() - before} "
                                 "_scaled_mm launches for a forward and its backward, not 3")
        errs = {}
        y = y.detach()
        for label, got, ref in (
                ("out", y, fp8.scaled_mm_plain(qx, qw, sx * sw, torch.bfloat16)),
                ("dx", xr.grad, fp8.scaled_mm_plain(qg, qw.t(), sg * sw, torch.bfloat16)),
                ("dw", wr.grad, fp8.scaled_mm_plain(qx.t(), qg, sg * sx, torch.bfloat16))):
            errs[label] = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        planted_ref = fp8.scaled_mm_plain(qx, qw, sx * sw * (1 + FP8_FAULT_STEP), torch.bfloat16)
        planted = ((y.float() - planted_ref.float()).abs().max()
                   / planted_ref.float().abs().max()).item()
        if max(errs.values()) > FP8_MM_TOL or planted <= FP8_MM_TOL:
            raise AssertionError(f"phase 16 (b) {name}: errors {errs} (limit {FP8_MM_TOL}), the "
                                 f"planted scale fault {planted}")
        qw_col = qw.t().contiguous().t()
        ms = time_ms(lambda: fp8.scaled_mm(qx, qw_col, sx * sw, torch.bfloat16), iters=10)
        bf16_ms = time_ms(lambda: torch.mm(x, w), iters=10)
        dot_ms = time_ms(lambda: fp8.fp8_dot(x, w), iters=10)
        flops = 2.0 * m * k * n
        t_ops, t_bytes = flops / FP8_PEAK, (m * k + k * n + 2 * m * n) / HBM_BYTES_PER_S
        bound, by = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
        out[name] = dict(m=m, k=k, n=n, errors=errs, planted_scale_fault=planted, scaled_mm_ms=ms,
                         bf16_mm_ms=bf16_ms, fp8_dot_forward_ms=dot_ms, bound_ms=bound,
                         bound_by=by)
        log(f"phase 16 (b) {name} M={m} K={k} N={n}: quantized x, w, g bitwise the CPU's; "
            f"out/dx/dw max err {errs['out']:.2e}/{errs['dx']:.2e}/{errs['dw']:.2e} of the largest "
            f"|ref| (limit {FP8_MM_TOL:.2e}; a scale one e4m3 step off {planted:.2e}); _scaled_mm "
            f"{ms:.4f} ms ({flops / ms / 1e9:.0f} TFLOP/s, bound {bound:.4f}), bf16 torch.mm "
            f"{bf16_ms:.4f} ms ({bf16_ms / ms:.2f}x), fp8_dot forward with its quantize passes "
            f"{dot_ms:.4f} ms [{card}]")
        del x, w, g, xr, wr, y, qx, qw, qg, qw_col
    torch.cuda.empty_cache()
    return out


def fp8_generic_module(dev, card):
    """Phase 16 (c): ``mixed_precision="fp8"`` on a module without a
    ``use_fp8`` field, the JAX test's 256 -> 512 -> 8 MLP: ``prepare``
    rewrites it (``fp8_rewrite``), five ``train_step`` calls lower the loss,
    and the first product runs through ``_scaled_mm`` (two launches a
    step: its forward and its weight's gradient, the input needing none;
    the second product, N = 8, stays)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.ops import fp8
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    class Mlp(torch.nn.Module):
        def __init__(self):
            super().__init__()
            g = torch.Generator().manual_seed(0)
            self.w1 = torch.nn.Parameter(torch.randn(256, 512, generator=g) * 0.05)
            self.w2 = torch.nn.Parameter(torch.randn(512, 8, generator=g) * 0.05)

        def forward(self, x):
            x = x.to(self.w1.dtype)
            return torch.tanh(x @ self.w1) @ self.w2

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(mixed_precision="fp8")
    model = Mlp()
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)
    model, opt = acc.prepare(model, opt)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(16, 256, generator=gen, device=dev)
    y = torch.randn(16, 8, generator=gen, device=dev)
    step = acc.train_step(lambda m, b: ((m(b["x"]) - b["y"]) ** 2).mean())
    before = fp8.scaled_mm_count()
    losses = [step({"x": x, "y": y}).item() for _ in range(FP8_GENERIC_STEPS)]
    launches = fp8.scaled_mm_count() - before
    inner = model.module  # the MixedPrecisionModule's: the forward sees bf16 weights
    with torch.no_grad():
        w1, w2 = inner.w1.to(torch.bfloat16), inner.w2.to(torch.bfloat16)
        first_fp8 = torch.equal(model(x), (torch.tanh(fp8.fp8_dot(x.to(torch.bfloat16), w1))
                                           @ w2).float())
    log(f"phase 16 (c) fp8_rewrite on a 256 -> 512 -> 8 MLP through prepare and train_step: losses "
        f"{[round(l, 5) for l in losses]}, {launches} _scaled_mm launches in "
        f"{FP8_GENERIC_STEPS} steps; the forward bitwise tanh(fp8_dot(x, w1)) @ w2: {first_fp8} "
        f"[{card}]")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0] and first_fp8
            and launches == 2 * FP8_GENERIC_STEPS):
        raise AssertionError(f"phase 16 (c): losses {losses}, {launches} _scaled_mm launches")
    del model, opt, step, acc
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    return dict(losses=losses, scaled_mm_launches=launches, first_product_fp8=first_fp8)


def fp8_generate(dev, card, model):
    """Phase 16 (d): greedy ``generate`` on (a)'s trained model, its prefill
    through fp8 (the decode in bf16, as the JAX package's), B1 launched by
    the prefill alone; the tokens teacher-forced through two references by
    phase 12's rule (argmax share >= GREEDY_SHARE_MIN, the largest gap where
    a token leaves the reference's argmax within Q_NEAR_TIE_ULPS bf16 ulps
    of its largest |logit|): the computation generate ran (the fp8 prefill's
    cache, then the window of generated tokens through the bf16 verify
    step), and the same model with ``use_fp8=False`` (the bf16 forward)."""
    from accelerate_tpu_torch.inference import generate
    from accelerate_tpu_torch.models.llama import llama_prefill, llama_verify_step
    from accelerate_tpu_torch.ops import _build, fp8

    cfg = model.config
    ids_np = np.random.default_rng(16).integers(
        0, cfg.vocab_size, size=(FP8_GEN_BATCH, FP8_GEN_PROMPT)).astype(np.int32)
    ids = torch.from_numpy(ids_np)
    generate(model, ids_np, FP8_GEN_NEW)  # builds the program (and its graph)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    mm0 = fp8.scaled_mm_count()
    out = generate(model, ids_np, FP8_GEN_NEW)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    prefill_mm = fp8.scaled_mm_count() - mm0
    out = out.to(dev)
    p = FP8_GEN_PROMPT
    params = model.params
    cfg_r = dataclasses.replace(cfg, attention_impl="xla")
    with torch.no_grad():
        # the computation generate ran: the fp8 prefill's cache, then the
        # generated tokens as one window through the bf16 verify step
        logits0, cache = llama_prefill(cfg, params, ids.to(dev).long(), p + FP8_GEN_NEW)
        win, _ = llama_verify_step(cfg_r, params, cache, out[:, p:-1].long(),
                                   torch.full((FP8_GEN_BATCH,), p, device=dev, dtype=torch.int32))
        ref_fp8 = torch.cat([logits0[:, None], win], dim=1)
        ref_bf16 = static_reference(dataclasses.replace(cfg_r, use_fp8=False), params, ids.to(dev),
                                    out)
    chosen = out[:, p:].long()
    numbers = {}
    for label, ref in (("fp8 prefill", ref_fp8), ("use_fp8=False", ref_bf16)):
        share, gap, ulps = choice_agreement(chosen, ref)
        numbers[label] = dict(share=share, gap=gap, gap_ulps=ulps)
    held, told = numbers["fp8 prefill"], numbers["use_fp8=False"]
    log(f"phase 16 (d) generate B={FP8_GEN_BATCH} {p} + {FP8_GEN_NEW} greedy on (a)'s model: "
        f"launches {dict((k, v) for k, v in launches.items() if v)}, {prefill_mm} _scaled_mm (the "
        f"prefill's); teacher-forced against the fp8 prefill + bf16 window (held: share >= "
        f"{GREEDY_SHARE_MIN}, gap <= {Q_NEAR_TIE_ULPS} ulps): share {held['share']:.4f}, largest "
        f"gap {held['gap_ulps']:.2f} ulps; against use_fp8=False (reported): share "
        f"{told['share']:.4f}, largest gap {told['gap_ulps']:.2f} ulps [{card}]")
    check_launches("phase 16 (d) (one generate: B1 in the prefill only)", launches,
                   {"flash_fwd_mma": cfg.num_hidden_layers})
    if (prefill_mm != 7 * cfg.num_hidden_layers or held["share"] < GREEDY_SHARE_MIN
            or held["gap_ulps"] > Q_NEAR_TIE_ULPS):
        raise AssertionError(f"phase 16 (d): {prefill_mm} _scaled_mm in the prefill; generate's "
                             f"tokens against the fp8 prefill's computation: {held}")
    return {"flash_fwd_mma": launches["flash_fwd_mma"]}, numbers


def phase_fp8(dev, card, phase6):
    """Phase 16: fp8 training. (a) phase 6's model, seed, batch and AdamW
    under ``Accelerator(mixed_precision="fp8")``: 2 untimed and 4 timed
    steps with the launch counters reset just before (2L B1, L B2, L B3 and
    28 L ``_scaled_mm`` a step: each layer's seven products forward, again
    in the recompute, and two backward), each step's gradient norm finite,
    the first FP8_HELD_LOSSES losses within TRAIN_VARIANT_LOSS_RTOL of phase
    6's, all finite and falling; ms a step,
    tokens/s, MFU over the bf16 and the fp8 peak, peak memory and a profile
    (the quantize passes' and the layout copies' device ms) beside phase
    6's; (b) the projections at their shapes; (c) a generic module;
    (d) generate on (a)'s model."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import (
        LlamaConfig, create_llama, llama_flops_per_token, llama_loss,
    )
    from accelerate_tpu_torch.ops import _build, fp8
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    torch.cuda.reset_peak_memory_stats()
    acc = Accelerator(mixed_precision="fp8")
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS, attention_impl="flash")
    model = create_llama(cfg, seed=0, device=acc.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    model, optimizer = acc.prepare(model, optimizer)
    if not (model.config.use_fp8 and acc.fp8_backend == "NATIVE"):
        raise AssertionError("phase 16: prepare did not turn the model's fp8 projections on")
    kept = []
    clip = optimizer.clip_grad_norm_

    def clip_and_keep(max_norm):  # train_step clips through the optimizer: keep each norm
        kept.append(clip(max_norm))
        return kept[-1]

    optimizer.clip_grad_norm_ = clip_and_keep
    step_fn = acc.train_step(llama_loss, max_grad_norm=1.0)
    rng = np.random.default_rng(0)
    data = {"input_ids": rng.integers(0, cfg.vocab_size, size=(4 * TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    loader = acc.prepare_data_loader(data, batch_size=TRAIN_BATCH, drop_last=True)
    batch = next(iter(loader))  # phase 6's batch, repeated on every step
    losses = [step_fn(batch) for _ in range(FP8_WARMUP)]
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    mm0 = fp8.scaled_mm_count()
    t0 = time.perf_counter()
    losses += [step_fn(batch) for _ in range(FP8_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    mm_per_step = (fp8.scaled_mm_count() - mm0) / FP8_STEPS
    peak = torch.cuda.max_memory_allocated()
    optimizer.clip_grad_norm_ = clip
    losses = [l.item() for l in losses]
    norms = [float(n) for n in kept]
    L = TRAIN_LAYERS
    expected = {"flash_fwd_mma": 2 * L * FP8_STEPS, "flash_bwd_dq_mma": L * FP8_STEPS,
                "flash_bwd_dkv_mma": L * FP8_STEPS}
    check_launches(f"phase 16 (a) ({FP8_STEPS} fp8 steps; remat runs the forward twice)", launches,
                   expected)
    step_ms = wall / FP8_STEPS * 1e3
    tokens_per_s = FP8_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall
    flops = tokens_per_s * llama_flops_per_token(cfg, TRAIN_SEQ)
    mfu, mfu_fp8 = flops / PEAK_FLOPS[torch.bfloat16], flops / FP8_PEAK
    ref = phase6["losses"][:len(losses)]
    rels = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    rel = max(rels[:FP8_HELD_LOSSES])
    log(f"phase 16 (a) losses {[round(l, 4) for l in losses]} against phase 6's "
        f"{[round(l, 4) for l in ref]}: relative differences {[f'{r:.2e}' for r in rels]} (the "
        f"first {FP8_HELD_LOSSES} held within {TRAIN_VARIANT_LOSS_RTOL}); grad norms "
        f"{[round(n, 4) for n in norms]}; _scaled_mm {mm_per_step:.0f} a step (expected {28 * L})")
    log(f"phase 16 (a) fp8 train step {step_ms:.1f} ms, {tokens_per_s:.0f} tokens/s, MFU "
        f"{mfu:.4f} of the 989 TFLOP/s bf16 peak ({mfu_fp8:.4f} of the 1,979 fp8 peak), peak memory "
        f"{peak / 1e9:.2f} GB; phase 6 (bf16) {phase6['step_ms']:.1f} ms, "
        f"{phase6['tokens_per_s']:.0f} tokens/s, MFU {phase6['mfu']:.4f}, "
        f"{phase6['peak_memory_bytes'] / 1e9:.2f} GB [{card}]")
    if (rel > TRAIN_VARIANT_LOSS_RTOL or not all(np.isfinite(norms)) or len(norms) != len(losses)
            or not all(np.isfinite(losses)) or not losses[-1] < losses[0]
            or mm_per_step != 28 * L or peak > PEAK_MEMORY_LIMIT):
        raise AssertionError(f"phase 16 (a): losses {losses} against {ref}, norms {norms}, "
                             f"_scaled_mm {mm_per_step} a step, peak {peak / 1e9:.1f} GB")
    profile = profile_fp8_step(step_fn, batch, step_ms, card)
    del optimizer, step_fn, loader, acc
    gc.collect()
    torch.cuda.empty_cache()
    model.eval()
    by_path = {"training_fp8": {k: launches[k] for k in expected}}
    by_path["prefill_fp8"], greedy = fp8_generate(dev, card, model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    shapes = fp8_projection_checks(dev, card, gen)
    generic = fp8_generic_module(dev, card)
    return by_path, dict(
        losses=losses, grad_norms=norms, step_ms=step_ms, tokens_per_s=tokens_per_s, mfu_bf16_peak=mfu,
        mfu_fp8_peak=mfu_fp8, peak_memory_bytes=peak, scaled_mm_per_step=mm_per_step,
        loss_rel_to_phase6=rels,
        phase6=dict(step_ms=phase6["step_ms"], tokens_per_s=phase6["tokens_per_s"],
                    mfu=phase6["mfu"], peak_memory_bytes=phase6["peak_memory_bytes"]),
        profile=profile, projections=shapes, generic=generic, generate=greedy)


def profile_fp8_step(step_fn, batch, step_ms, card):
    """Phase 6's train-step profile of one fp8 step, and the device ms of
    the kernels launched inside the ``fp8_quantize`` and ``fp8_layout``
    ranges (``ops.fp8.kernels_in_ranges`` on the step's trace)."""
    from accelerate_tpu_torch.ops.fp8 import kernels_in_ranges

    prof = profile_train_step(step_fn, batch, step_ms, card, label="phase 16", name="train_fp8")
    events = json.loads(Path("chiprun_out/trace_train_fp8.json").read_text())["traceEvents"]
    ranges = {name: sum(ms for _, ms in kernels)
              for name, kernels in kernels_in_ranges(events).items()}
    if prof is None or not any(ranges.values()):
        log("phase 16 profile: no kernel of the fp8 ranges in the trace (not measured)")
        return dict(step=prof, ranges_ms=None)
    share = (ranges["fp8_quantize"] + ranges["fp8_layout"]) / prof["profiled_wall_ms"]
    log(f"phase 16 profile: device ms a step of the kernels inside the fp8 ranges: quantize "
        f"{ranges['fp8_quantize']:.1f}, layout copies {ranges['fp8_layout']:.1f}, of the profiled "
        f"step's {prof['profiled_wall_ms']:.1f} ms (share {share:.3f}) [{card}]")
    return dict(step=prof, ranges_ms=ranges, share=share)


# ---------------------------------------------------------------- phase 10
# data-parallel training at world size 1 over NCCL: phase 6's model, seed,
# batch, bf16 compute, f32 logits, AdamW and max_grad_norm=1.0 through
# Accelerator(parallelism_config=...): (a) DDP (dp_replicate_size=1, forced
# by a DistributedDataParallelKwargs), (b) FSDP2 (dp_shard_size=1 with an
# FSDPPlugin: one fully_shard unit per layer, then the root). At world
# size 1 the collectives move nothing between cards; the path, its hooks
# and its copies run as on several. Then a save and a load under FSDP2 at
# phase 9's depth rule, the load bitwise.
DP_LAYOUTS = ("ddp", "fsdp")


def dp_accelerator(layout):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import DistributedDataParallelKwargs, FSDPPlugin

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    if layout == "ddp":
        acc = Accelerator(mixed_precision="bf16", parallelism_config=ParallelismConfig(dp_replicate_size=1),
                          kwargs_handlers=[DistributedDataParallelKwargs()])
    else:
        acc = Accelerator(mixed_precision="bf16", parallelism_config=ParallelismConfig(dp_shard_size=1),
                          fsdp_plugin=FSDPPlugin())
    if acc.layout != layout:
        raise AssertionError(f"phase 10: asked for {layout}, the Accelerator chose {acc.layout}")
    return acc


def dp_model(acc, layers, seed):
    from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers, attention_impl="flash")
    model = create_llama(cfg, seed=seed, device=acc.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    model, optimizer = acc.prepare(model, optimizer)
    return cfg, model, optimizer


def dp_run(layout, card, phase6):
    """One layout: 2 untimed and 8 timed steps, launches counted over the
    timed ones, losses against phase 6's; returns (launches, numbers,
    (acc, model, optimizer))."""
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch.models.llama import llama_flops_per_token, llama_loss
    from accelerate_tpu_torch.ops import _build

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    acc = dp_accelerator(layout)
    t0 = time.perf_counter()
    cfg, model, optimizer = dp_model(acc, TRAIN_LAYERS, seed=0)
    params = list(model.parameters())
    sharded = sum(isinstance(p, DTensor) for p in params)
    if (layout == "fsdp") != (sharded == len(params)) or (layout == "ddp" and sharded):
        raise AssertionError(f"phase 10 {layout}: {sharded} of {len(params)} parameters are DTensors")
    step_fn = acc.train_step(llama_loss, max_grad_norm=1.0)
    rng = np.random.default_rng(0)
    data = {"input_ids": rng.integers(0, cfg.vocab_size, size=(4 * TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    loader = acc.prepare_data_loader(data, batch_size=TRAIN_BATCH, drop_last=True)
    batch = next(iter(loader))  # phase 6's batch
    torch.cuda.synchronize()
    log(f"phase 10 ({layout}): {type(model).__name__} over mesh {acc.mesh}, {len(params)} parameters "
        f"({sharded} DTensors), init {time.perf_counter() - t0:.1f}s")
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
    check_launches(f"phase 10 {layout} ({TRAIN_STEPS} steps)", launches, expected)
    ref = phase6["losses"]
    first_bitwise = losses[0] == ref[0]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    log(f"phase 10 {layout} losses {[round(l, 4) for l in losses]}; phase 6 {[round(l, 4) for l in ref]}; "
        f"first step bitwise equal to phase 6's: {first_bitwise}; largest relative difference over the "
        f"10 steps {worst:.3e} (limit {TRAIN_VARIANT_LOSS_RTOL})")
    if not first_bitwise:
        raise AssertionError(f"phase 10 {layout}: the first step's loss {losses[0]!r} differs from "
                             f"phase 6's {ref[0]!r}, though its arithmetic is the same")
    if not worst <= TRAIN_VARIANT_LOSS_RTOL:
        raise AssertionError(f"phase 10 {layout}: losses {worst:.3e} from phase 6's")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens_per_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall
    mfu = tokens_per_s * llama_flops_per_token(cfg, TRAIN_SEQ) / PEAK_FLOPS[torch.bfloat16]
    profile = profile_train_step(step_fn, batch, step_ms, card, label=f"phase 10 {layout}",
                                 name=f"train_{layout}")
    busy = profile["busy_share"] if profile else None
    log(f"phase 10 {layout} train step {step_ms:.1f} ms, {tokens_per_s:.0f} tokens/s, MFU {mfu:.4f}, "
        f"peak memory {peak / 1e9:.2f} GB, busy share {busy if busy is None else round(busy, 3)}, "
        f"launches {dict((k, launches[k]) for k in expected)}; phase 6 in this call: "
        f"{phase6['step_ms']:.1f} ms, {phase6['tokens_per_s']:.0f} tokens/s, MFU {phase6['mfu']:.4f}, "
        f"peak {phase6['peak_memory_bytes'] / 1e9:.2f} GB, busy share "
        f"{(phase6.get('profile') or {}).get('busy_share')} [{card}]")
    if peak > PEAK_MEMORY_LIMIT:
        raise AssertionError(f"phase 10 {layout}: peak memory {peak / 1e9:.1f} GB")
    del loader, step_fn
    return {k: launches[k] for k in expected}, dict(
        losses=losses, first_loss_bitwise=first_bitwise, worst_loss_rel=worst, step_ms=step_ms,
        tokens_per_s=tokens_per_s, mfu=mfu, peak_memory_bytes=peak, profile=profile), (acc, model, optimizer)


def phase_data_parallel(card, phase6):
    """Phase 10: DDP and FSDP2 at world size 1 over NCCL (an in-process
    group on cuda:0); ends the group. The FSDP2 checkpoint round trip is
    held bitwise by the CPU tests (``tests/test_torch_fsdp_resume.py``)
    and on four cards (``four_card_runs.sh supervise``); its 23 GB save
    here cost the script's time limit about a minute."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    from accelerate_tpu_torch.ops.flash_attention import flash_attention
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    store = tempfile.mkdtemp(prefix="chip_smoke_rdzv_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    launches, out = {}, {}
    try:
        for layout in DP_LAYOUTS:
            launches[layout], out[layout], trained = dp_run(layout, card, phase6)
            if layout != "fsdp":
                del trained
        # a wrapper that meets a DTensor raises; it neither launches nor
        # falls back to the plain version
        acc = trained[0]
        q = torch.zeros((1, 128, 4, 128), dtype=torch.bfloat16, device=acc.device)
        dq = distribute_tensor(q, acc.mesh, [Replicate()])
        assert isinstance(dq, DTensor)
        try:
            flash_attention(dq, dq, dq)
        except TypeError as e:
            log(f"phase 10: a DTensor given to the flash wrapper raised TypeError ({e})")
        else:
            raise AssertionError("phase 10: the flash wrapper took a DTensor")
        del trained, acc
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        gc.collect()
        torch.cuda.empty_cache()
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return launches, out


# ---------------------------------------------------------------- phase 11
# tensor parallelism: (a) phase 6's step at tp=1 over NCCL, the TP layout
# forced by a TensorParallelConfig; (b) four TP ranks as threads on the one
# card. Both run at phase 6's depth, 4 layers.
TP_THREADS = 4
TP_THREAD_STEPS = 3
TP_THREAD_TIMEOUT_S = 300
# (b)'s first-step gradients against (a)'s, leaf by leaf: max |g - g_a| over
# max |g_a|. Tensor parallelism sums each row-parallel product's bf16
# partial sums over the ranks (each rounded to bf16 before the sum) where
# one rank rounds one GEMM's f32 sum, so the residual stream and every
# gradient downstream of it move by a few bf16 ulps (2^-8 each) of the
# largest element; a norm scale's gradient without its tp sum keeps a
# quarter of it, off by 0.75 of it
TP_GRAD_TOL = 2.0 ** -5


class _CallCounter:
    """Counts calls of the module functions it wraps (the tensor-parallel
    collectives and the vocabulary-parallel loss), as the forward calls
    them."""

    def __init__(self, targets):
        self.targets, self.counts, self.saved = targets, {}, []

    def __enter__(self):
        for module, name in self.targets:
            fn = getattr(module, name)
            self.saved.append((module, name, fn))

            def wrapped(*a, _fn=fn, _name=name, **kw):
                self.counts[_name] = self.counts.get(_name, 0) + 1
                return _fn(*a, **kw)

            setattr(module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for module, name, fn in self.saved:
            setattr(module, name, fn)


def tp_counters():
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.ops import losses

    return _CallCounter([(tl, "sequence_all_gather"), (tl, "sequence_reduce_scatter"),
                         (tl, "copy_to_group"), (tl, "reduce_from_group"),
                         (losses, "vocab_parallel_nll")])


def whole_gradients(model, optimizer, to_host=True):
    """Every gradient whole (tp sums done, blocks gathered) under its
    checkpoint key, restacked; on the host."""
    optimizer.grads()
    named = dict(model.named_parameters())

    def whole(name):
        g = named[name].grad
        g = g.full_tensor() if hasattr(g, "full_tensor") else g
        return g.detach().float().cpu() if to_host else g.detach()

    return {key: torch.stack([whole(f) for f in fqns]) if stacked else whole(fqns[0])
            for key, fqns, stacked in model.checkpoint_fqns()}


def tp_run(card, phase6):
    """Phase 11 (a): the TP layout over the one-rank group; returns
    (launches, numbers, first-step gradients on the host, the batch)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama, llama_flops_per_token, llama_loss
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import TensorParallelConfig

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(mixed_precision="bf16",
                      parallelism_config=ParallelismConfig(tp_config=TensorParallelConfig()))
    if acc.layout != "tp":
        raise AssertionError(f"phase 11: asked for the TP layout, the Accelerator chose {acc.layout}")
    t0 = time.perf_counter()
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS, attention_impl="flash")
    model = create_llama(cfg, seed=0, device=acc.device)
    optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    model, optimizer = acc.prepare(model, optimizer)
    params = dict(model.named_parameters())
    split = [n for n, p in params.items() if isinstance(p, DTensor) and isinstance(p.placements[0], Shard)]
    whole = [n for n, p in params.items() if isinstance(p, DTensor) and isinstance(p.placements[0], Replicate)]
    if len(split) + len(whole) != len(params) or model.tp is None or not split or not whole:
        raise AssertionError(f"phase 11 (a): {len(split)} split and {len(whole)} replicated DTensors "
                             f"of {len(params)} parameters, model.tp {model.tp}")
    rng = np.random.default_rng(0)
    data = {"input_ids": rng.integers(0, cfg.vocab_size, size=(4 * TRAIN_BATCH, TRAIN_SEQ)).astype(np.int32)}
    loader = acc.prepare_data_loader(data, batch_size=TRAIN_BATCH, drop_last=True)
    batch = next(iter(loader))  # phase 6's batch
    # the first step's gradients (phase 11 (b) holds its own against them)
    with tp_counters() as calls:
        acc.backward(llama_loss, batch)
    grads = whole_gradients(model, optimizer)
    optimizer.zero_grad()
    step_fn = acc.train_step(llama_loss, max_grad_norm=1.0)
    torch.cuda.synchronize()
    log(f"phase 11 (a) TP layout over mesh {acc.mesh}: {len(split)} parameters split over tp "
        f"(Shard), {len(whole)} replicated; one forward and backward called {calls.counts} "
        f"[{card}]")
    if not calls.counts.get("vocab_parallel_nll") or not calls.counts.get("sequence_all_gather") \
            or not calls.counts.get("sequence_reduce_scatter"):
        raise AssertionError(f"phase 11 (a): the tensor-parallel path did not run ({calls.counts})")
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
    check_launches(f"phase 11 (a) tp ({TRAIN_STEPS} steps)", launches, expected)
    ref = phase6["losses"]
    first_bitwise = losses[0] == ref[0]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    log(f"phase 11 (a) tp losses {[round(l, 4) for l in losses]}; phase 6 {[round(l, 4) for l in ref]}; "
        f"first step bitwise equal to phase 6's: {first_bitwise} (the one-rank gather, scatter and "
        f"vocabulary all-reduces copy; the embedding's masked lookup and the loss's max, sum and "
        f"log are phase 6's operations in its order); largest relative difference over the 10 "
        f"steps {worst:.3e} (limit {TRAIN_VARIANT_LOSS_RTOL})")
    if not worst <= TRAIN_VARIANT_LOSS_RTOL:
        raise AssertionError(f"phase 11 (a): losses {worst:.3e} from phase 6's")
    step_ms = wall / TRAIN_STEPS * 1e3
    tokens_per_s = TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ / wall
    mfu = tokens_per_s * llama_flops_per_token(cfg, TRAIN_SEQ) / PEAK_FLOPS[torch.bfloat16]
    profile = profile_train_step(step_fn, batch, step_ms, card, label="phase 11 (a) tp",
                                 name="train_tp")
    busy = profile["busy_share"] if profile else None
    log(f"phase 11 (a) tp train step {step_ms:.1f} ms, {tokens_per_s:.0f} tokens/s, MFU {mfu:.4f}, "
        f"peak memory {peak / 1e9:.2f} GB, busy share {busy if busy is None else round(busy, 3)}, "
        f"launches {dict((k, launches[k]) for k in expected)}; phase 6 in this call: "
        f"{phase6['step_ms']:.1f} ms, {phase6['tokens_per_s']:.0f} tokens/s, MFU {phase6['mfu']:.4f}, "
        f"peak {phase6['peak_memory_bytes'] / 1e9:.2f} GB, busy share "
        f"{(phase6.get('profile') or {}).get('busy_share')} [{card}]")
    if peak > PEAK_MEMORY_LIMIT:
        raise AssertionError(f"phase 11 (a): peak memory {peak / 1e9:.1f} GB")
    del loader, step_fn, model, optimizer, acc
    return {k: launches[k] for k in expected}, dict(
        losses=losses, first_loss_bitwise=first_bitwise, worst_loss_rel=worst, step_ms=step_ms,
        tokens_per_s=tokens_per_s, mfu=mfu, peak_memory_bytes=peak, profile=profile,
        calls=calls.counts), grads, {k: v.clone() for k, v in batch.items()}


def tp_threads(card, ref_losses, ref_grads, batch, fault=False):
    """Phase 11 (b): TP_THREADS ranks of tp, threads of this process over
    torch's threaded process group on the one card, each holding its blocks
    of the seed-0 model; TP_THREAD_STEPS steps of llama_loss, backward, the
    optimizer's tp sum, clipping at 1.0 and AdamW. Returns (launches, losses,
    worst gradient error over leaves by leaf, its worst leaf)."""
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed import multi_threaded_pg

    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, create_llama, llama_loss
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.optimizer import AcceleratedOptimizer
    from accelerate_tpu_torch.parallel.tp import apply_tensor_parallel

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=TRAIN_LAYERS, attention_impl="flash")
    full = create_llama(cfg, seed=0, device="cuda")  # (a)'s weights
    tree = {key: getattr(full, name).detach() for key, name in full.checkpoint_keys()}
    with init_empty_weights():
        shells = [create_llama(cfg) for _ in range(TP_THREADS)]
    store = dist.HashStore()
    out = {"losses": {}, "grads": {}, "errors": {}}
    world = multi_threaded_pg._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _build.reset_launch_counts()

    def rank(r):
        try:
            dist.init_process_group("threaded", rank=r, world_size=TP_THREADS, store=store)
            mesh = init_device_mesh("cuda", (TP_THREADS,), mesh_dim_names=("tp",))
            model = shells[r]
            model.unstack_layers()
            replicated = apply_tensor_parallel(
                model, mesh, source=lambda key, layer: tree[key] if layer is None else tree[key][layer])
            opt = AcceleratedOptimizer(torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999),
                                                         eps=1e-8, weight_decay=0.01))
            # the planted fault: the replicated parameters' tp sum left out
            opt.tp_replicated = [] if fault else replicated
            opt.tp_group, opt.dp_groups = mesh.get_group(), []
            losses = []
            for step in range(TP_THREAD_STEPS):
                loss = llama_loss(model, batch)
                loss.backward()
                if step == 0:
                    opt.grads()
                    named = dict(model.named_parameters())
                    out["grads"][r] = {key: [named[f].grad.to_local().detach().clone() for f in fqns]
                                       for key, fqns, _ in model.checkpoint_fqns()}
                opt.clip_grad_norm_(1.0)
                opt.step()
                opt.zero_grad()
                losses.append(loss.item())
            out["losses"][r] = losses
            out["placements"] = {key: named[fqns[0]].placements[0] for key, fqns, _ in model.checkpoint_fqns()}
            dist.barrier()
        except BaseException as e:  # handed to the main thread, which raises it
            out["errors"][r] = e
            raise

    # daemons: a rank left waiting in a collective when another failed does
    # not keep the process alive
    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(TP_THREADS)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TP_THREAD_TIMEOUT_S)
        if any(t.is_alive() for t in threads) and not out["errors"]:
            raise AssertionError(f"phase 11 (b): a tp thread still runs after {TP_THREAD_TIMEOUT_S}s")
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        multi_threaded_pg._uninstall_threaded_pg()
        del world
    if out["errors"]:
        raise next(iter(out["errors"].values()))
    launches = _build.launch_counts()
    del full, tree, shells
    # gather each leaf's blocks whole, restacked, and hold them against (a)'s
    worst, worst_key = 0.0, None
    for key, ref in ref_grads.items():
        placement = out["placements"][key]
        parts = [torch.stack(out["grads"][r][key]) if len(out["grads"][r][key]) > 1
                 else out["grads"][r][key][0] for r in range(TP_THREADS)]
        stacked = len(out["grads"][0][key]) > 1
        if hasattr(placement, "dim"):
            got = torch.cat(parts, dim=placement.dim + (1 if stacked else 0))
        else:
            got = parts[0]
        ref_dev = ref.to(got.device)
        err = ((got.float() - ref_dev).abs().max() / ref_dev.abs().max()).item()
        if err > worst:
            worst, worst_key = err, key
    losses = out["losses"]
    if any(losses[r] != losses[0] for r in range(TP_THREADS)):
        raise AssertionError(f"phase 11 (b): the tp ranks computed different losses {losses}")
    return launches, losses[0], worst, worst_key


def phase_tensor_parallel(card, phase6):
    """Phase 11: (a) over a one-rank NCCL group (ended after), then (b) and
    its planted fault over torch's threaded group on the one card."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    store = tempfile.mkdtemp(prefix="chip_smoke_rdzv_")
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        launches_a, out, grads, batch = tp_run(card, phase6)
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        gc.collect()
        torch.cuda.empty_cache()
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    ref = out["losses"][:TP_THREAD_STEPS]
    t0 = time.perf_counter()
    launches_b, losses, err, leaf = tp_threads(card, ref, grads, batch)
    secs = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    _, fault_losses, fault_err, fault_leaf = tp_threads(card, ref, grads, batch, fault=True)
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    expected = {"flash_fwd_mma": 2 * TRAIN_LAYERS * TP_THREAD_STEPS * TP_THREADS,
                "flash_bwd_dq_mma": TRAIN_LAYERS * TP_THREAD_STEPS * TP_THREADS,
                "flash_bwd_dkv_mma": TRAIN_LAYERS * TP_THREAD_STEPS * TP_THREADS}
    check_launches(f"phase 11 (b) {TP_THREADS} tp threads ({TP_THREAD_STEPS} steps, 8 q and 2 kv "
                   "heads a rank)", launches_b, expected)
    log(f"phase 11 (b) {TP_THREADS} tp ranks as threads on one card ({secs:.1f}s): losses "
        f"{[round(l, 4) for l in losses]} against (a)'s {[round(l, 4) for l in ref]}, largest relative "
        f"difference {worst:.3e} (limit {TRAIN_VARIANT_LOSS_RTOL}); first-step gradients gathered "
        f"whole against (a)'s: worst leaf {leaf} at {err:.3e} of its largest element (limit "
        f"{TP_GRAD_TOL:.4g}); planted fault (norm scales' tp gradient sum left out): worst leaf "
        f"{fault_leaf} at {fault_err:.3e}, losses {[round(l, 4) for l in fault_losses]} [{card}]")
    if not worst <= TRAIN_VARIANT_LOSS_RTOL:
        raise AssertionError(f"phase 11 (b): losses {worst:.3e} from (a)'s")
    if not err <= TP_GRAD_TOL:
        raise AssertionError(f"phase 11 (b): gradient of {leaf} {err:.3e} from (a)'s")
    if not fault_err > TP_GRAD_TOL:
        raise AssertionError("phase 11 (b): the gradient check cannot see the norm scales' missing "
                             f"tp sum ({fault_err:.3e})")
    out["threads"] = dict(losses=losses, worst_loss_rel=worst, worst_grad_rel=err, worst_grad_leaf=leaf,
                          fault_worst_grad_rel=fault_err, fault_leaf=fault_leaf, seconds=secs)
    return launches_a, {k: launches_b[k] for k in expected}, out


# ----------------------------------------------------------------- phase 9
# a resumable fine-tune (the port of examples/by_feature/fault_tolerance.py
# and packed_sft.py): seeded documents packed by the native packer into
# 2048-token rows with segment ids, fed through a torch DataLoader (2
# workers, pinned) that prepare_data_loader unwraps with the seedable
# shuffle, Llama-3-8B at full width through accumulate/backward, AdamW,
# max_grad_norm=1.0 and a warm-up + cosine schedule; atomic checkpoints with
# automatic naming and total_limit=2
RESUME_BATCH, RESUME_SEQ = 4, 2048
RESUME_STEPS, RESUME_SAVE_AT, RESUME_NAN_AT = 8, 4, 6
RESUME_DOCS, RESUME_DOC_LEN = 240, (64, 3000)
RESUME_MAX_LAYERS = 2  # the script's time limit holds phase 13 too
RESUME_SPARE = 1.2  # two checkpoints (the committed one and a staging one) and 20 %
RESUME_TIMED = 4  # steps timed with the loader and with a resident batch, each


class PackedRows(torch.utils.data.Dataset):
    """Packed training rows (module level: the loader's worker processes
    take it by fork)."""

    def __init__(self, tokens, segments, positions, masks):
        self.tokens, self.segments, self.positions, self.masks = tokens, segments, positions, masks

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        return {"input_ids": self.tokens[i], "segment_ids": self.segments[i],
                "position_ids": self.positions[i], "loss_mask": self.masks[i]}


def warmup_cosine(step, peak=3e-4, warmup=2, total=RESUME_STEPS):
    if step < warmup:
        return peak * (step + 1) / warmup
    return 0.5 * peak * (1 + math.cos(math.pi * min(1.0, (step - warmup) / (total - warmup))))


def resume_depth(free_disk, free_ram, max_layers=RESUME_MAX_LAYERS):
    """The deepest of 1-max_layers layers whose checkpoint (f32 weights and both
    AdamW moments, 12 B a parameter, from a meta model's parameter count)
    fits twice on the disk with 20 % to spare, and once in host memory
    (the async save's pinned snapshot)."""
    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama

    sizes = {}
    for layers in range(max_layers, 0, -1):
        with init_empty_weights():
            model = create_llama(LlamaConfig.llama3_8b(num_hidden_layers=layers), device="cpu")
        params = sum(p.numel() for p in model.parameters())
        sizes[layers] = (params, 12 * params)
        if 2 * 12 * params * RESUME_SPARE <= free_disk and 12 * params * RESUME_SPARE <= free_ram:
            return layers, sizes
    raise AssertionError(f"phase 9: {free_disk / 1e9:.1f} GB of disk and {free_ram / 1e9:.1f} GB of "
                         f"host memory hold no checkpoint of 1 layer with 20 % to spare: {sizes}")


def packed_rows(vocab, card):
    """Seeded documents packed into rows, with the packer and the
    collation timed per batch on the native and the NumPy paths."""
    from accelerate_tpu_torch.utils import native

    if not native.native_available():
        raise AssertionError("phase 9: the native packer (csrc/packing.cpp) did not build or load")
    rng = np.random.default_rng(9)
    docs = [rng.integers(0, vocab, size=rng.integers(*RESUME_DOC_LEN)).astype(np.int32)
            for _ in range(RESUME_DOCS)]
    times = {}
    for path in ("native", "numpy"):
        lib = native.get_packing_lib
        if path == "numpy":
            native.get_packing_lib = lambda: None
        try:
            t0 = time.perf_counter()
            tokens, segments = native.pack_dataset(docs, seq_len=RESUME_SEQ)
            pack_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            for i in range(0, len(docs), RESUME_BATCH):
                native.collate_padded(docs[i:i + RESUME_BATCH], RESUME_SEQ, 0)
            collate_s = time.perf_counter() - t0
        finally:
            native.get_packing_lib = lib
        batches = len(tokens) // RESUME_BATCH
        times[path] = dict(pack_ms_per_batch=pack_s * 1e3 / batches,
                           collate_ms_per_batch=collate_s * 1e3 / math.ceil(len(docs) / RESUME_BATCH))
        if path == "native":
            want = (tokens, segments)
        elif not (np.array_equal(tokens, want[0]) and np.array_equal(segments, want[1])):
            raise AssertionError("phase 9: the native and the NumPy packer disagree")
    kept = sum(len(d) <= RESUME_SEQ for d in docs)
    fill = float((segments > 0).mean())
    log(f"phase 9 data: {RESUME_DOCS} seeded documents of {RESUME_DOC_LEN[0]}-{RESUME_DOC_LEN[1]} "
        f"tokens, {kept} fit a row (the packer drops longer ones), packed into {len(tokens)} rows of "
        f"{RESUME_SEQ} (fill {fill:.3f}); host ms per batch of {RESUME_BATCH}: pack_dataset native "
        f"{times['native']['pack_ms_per_batch']:.3f} / NumPy {times['numpy']['pack_ms_per_batch']:.3f}, "
        f"collate_padded native {times['native']['collate_ms_per_batch']:.3f} / NumPy "
        f"{times['numpy']['collate_ms_per_batch']:.3f} [{card}]")
    masks = native.packed_loss_mask(segments)
    return PackedRows(tokens, segments, native.packed_position_ids(segments), masks), times


class ResumeRun:
    """One fresh Accelerator (states reset) with the phase's model,
    optimizer, loader and schedule; counts every training step it runs."""

    steps_run = 0

    def __init__(self, project, layers, dataset):
        from accelerate_tpu_torch.accelerator import Accelerator
        from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama
        from accelerate_tpu_torch.state import AcceleratorState, GradientState
        from accelerate_tpu_torch.utils.dataclasses import DataLoaderConfiguration, ProjectConfiguration

        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        self.acc = Accelerator(
            mixed_precision="bf16", dataloader_config=DataLoaderConfiguration(data_seed=0),
            project_config=ProjectConfiguration(project_dir=project, automatic_checkpoint_naming=True,
                                                total_limit=2))
        cfg = LlamaConfig.llama3_8b(num_hidden_layers=layers, attention_impl="flash")
        model = create_llama(cfg, seed=0, device=self.acc.device)
        opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        loader = torch.utils.data.DataLoader(dataset, batch_size=RESUME_BATCH, shuffle=True,
                                             num_workers=2, pin_memory=True, drop_last=True)
        self.model, self.opt, self.loader, self.sched = self.acc.prepare(model, opt, loader,
                                                                         warmup_cosine)
        self.it = None
        self.epoch = 0
        self.losses = []

    def next_batch(self):
        """The loader's next batch (the timing steps run past the epoch)."""
        if self.it is None:
            self.it = iter(self.loader)
        try:
            return next(self.it)
        except StopIteration:
            self.epoch += 1
            self.loader.set_epoch(self.epoch)
            self.it = iter(self.loader)
            return next(self.it)

    def step(self, batch=None, check=None):
        """One optimizer step on the loader's next batch (or ``batch``);
        ``check(loss)`` runs between the backward and the update."""
        from accelerate_tpu_torch.models.llama import llama_loss

        if batch is None:
            batch = self.next_batch()
        acc = self.acc
        with acc.accumulate(self.model):
            loss = acc.backward(llama_loss, batch)
            ok = check(loss) if check is not None else True
            if ok:
                acc.clip_grad_norm_(max_norm=1.0)
                self.opt.step()
                self.sched.step()
            self.opt.zero_grad()
        self.losses.append(loss)
        ResumeRun.steps_run += 1
        return batch

    def timed_steps(self, n, batch=None, first=None):
        """ms of each of ``n`` steps (synchronised after each); ``first``:
        the first step's batch, fetched before the timing (so the loader's
        start on a new epoch, its workers and the resume's skip, is not in
        it)."""
        out = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self.step(first if i == 0 and first is not None else batch)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    def params(self):
        return [p.detach().clone() for p in self.model.parameters()]

    def loss_values(self):
        return [l.item() for l in self.losses]

    def close(self):
        if self.it is not None:
            self.it.close()
        self.acc.end_training()
        self.acc.free_memory()
        del self.model, self.opt, self.loader, self.sched, self.acc, self.it
        gc.collect()
        torch.cuda.empty_cache()


def same_params(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def params_checksum(params):
    """A 64-bit sum of the parameters' bit patterns (for the log)."""
    total = sum(int(p.view(torch.int32).to(torch.int64).sum().item()) for p in params)
    return f"{total & (2 ** 64 - 1):016x}"


def profile_resume_step(run, label, trace_dir):
    """Busy share of one step (the union of kernel intervals over the
    step's wall), profiled; the trace stays in ``trace_dir``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run.step(run.resident if label == "resident" else None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = device_events(prof, path=os.path.join(trace_dir, f"trace_resume_{label}.json"))
    if not events:
        log(f"phase 9 profile ({label}): the profiler recorded no device time (not measured)")
        return None
    busy_ms = busy_us(events) / 1e3
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, busy_share=busy_ms / wall_ms)


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, files in os.walk(path) for f in files)


def phase_resume(card, phase6=None):
    """Phase 9: (a) 8 steps uninterrupted; (b) 4 steps, save_state, 2 steps,
    a save interrupted by a fault point before its commit, then a fresh
    Accelerator's resume_from_latest (rolling back to the step-4
    checkpoint) and steps 5-8, bitwise equal to (a); (c) the same resume
    with the loader's position discarded, which must differ; (d) the
    health watchdog restoring the step-4 checkpoint on a planted NaN,
    synchronous and with a 2-step deferred verdict; (e) the same resume
    from an async save taken while training went on."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import checkpointing
    from accelerate_tpu_torch.models.llama import LlamaConfig
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.utils import fault
    from accelerate_tpu_torch.utils.dataclasses import TrainingHealthConfig

    tmp_root = tempfile.gettempdir()
    free_disk = shutil.disk_usage(tmp_root).free
    free_ram = os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    layers, sizes = resume_depth(free_disk, free_ram)
    params, ckpt_bytes = sizes[layers]
    log(f"phase 9 space: {free_disk / 1e9:.1f} GB free on {tmp_root}, {free_ram / 1e9:.1f} GB of host "
        f"memory free; a checkpoint of L layers is 12 B x params: " + ", ".join(
            f"{l} layers {p / 1e9:.3f}B params {b / 1e9:.1f} GB" for l, (p, b) in sorted(sizes.items()))
        + f"; depth {layers} (two checkpoints + 20 % fit)")
    dataset, host = packed_rows(LlamaConfig.llama3_8b().vocab_size, card)
    out = dict(layers=layers, params=params, free_disk_bytes=free_disk, free_ram_bytes=free_ram,
               host=host)
    ResumeRun.steps_run = 0
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_", dir=tmp_root) as tmp:
        project = os.path.join(tmp, "run")
        ckpt_dir = os.path.join(project, "checkpoints")

        # (a) the reference: 8 uninterrupted steps
        run = ResumeRun(os.path.join(tmp, "reference"), layers, dataset)
        ms = run.timed_steps(RESUME_SAVE_AT)
        ref4 = run.params()
        ms += run.timed_steps(RESUME_STEPS - RESUME_SAVE_AT)
        ref8, ref_losses = run.params(), run.loss_values()
        log(f"phase 9 (a) reference: losses {ref_losses}, final params checksum "
            f"{params_checksum(ref8)}; step ms {[round(m, 1) for m in ms]}")
        # the same model on: the loader against one resident batch, in turns
        loader_ms, resident_ms = [], []
        run.resident = run.step()
        wait0 = run.loader.data_wait_s
        for _ in range(RESUME_TIMED // 2):
            loader_ms += run.timed_steps(1)
            resident_ms += run.timed_steps(1, run.resident)
            loader_ms += run.timed_steps(1)
            resident_ms += run.timed_steps(1, run.resident)
        data_wait_ms = (run.loader.data_wait_s - wait0) * 1e3 / len(loader_ms)
        prof = {k: profile_resume_step(run, k, tmp) for k in ("loader", "resident")}
        out["step"] = dict(reference_ms=ms, loader_ms=loader_ms, resident_ms=resident_ms,
                           data_wait_ms_per_step=data_wait_ms, profile=prof)
        p6 = (phase6 or {}).get("step_ms")
        log(f"phase 9 step (eager loop, {layers} layers, batch {RESUME_BATCH} x {RESUME_SEQ}, segment "
            f"ids): with the loader median {statistics.median(loader_ms):.1f} ms, with a resident batch "
            f"{statistics.median(resident_ms):.1f} ms (in turns); the loop waited "
            f"{data_wait_ms:.3f} ms a step for data; busy share with the loader "
            + (f"{prof['loader']['busy_share']:.3f}" if prof["loader"] else "not measured")
            + ", resident " + (f"{prof['resident']['busy_share']:.3f}" if prof["resident"]
                               else "not measured")
            + (f"; phase 6 (train_step, resident batch, {TRAIN_LAYERS} layers) {p6:.1f} ms" if p6 else "")
            + f" [{card}]")
        # the tracker and the health check's host cost a step
        run.acc.log_with = ["jsonl"]
        run.acc.project_configuration.logging_dir = tmp
        run.acc.async_logging = True
        run.acc.init_trackers("resume")
        log_us = []
        for i, loss in enumerate(run.losses):
            t0 = time.perf_counter()
            run.acc.log({"loss": loss, "lr": run.sched.get_last_lr()[0]}, step=i)
            log_us.append((time.perf_counter() - t0) * 1e6)
        run.acc.flush_trackers()
        out["tracker_log_us"] = log_us
        health_ms = {}
        for sync in (True, False):
            run.acc.health_config = TrainingHealthConfig(sync=sync, readback_depth=2)
            per = []
            for _ in range(3):
                torch.cuda.synchronize()
                run.step()
                t0 = time.perf_counter()
                run.acc.check_step_health(loss=run.losses[-1])
                per.append((time.perf_counter() - t0) * 1e3)
            run.acc.health_drain()
            health_ms["sync" if sync else "ring"] = per
        out["health_host_ms"] = health_ms
        log(f"phase 9 host cost: AsyncTrackerFlusher log() median {statistics.median(log_us):.1f} us; "
            f"check_step_health right after a step's launch: sync "
            f"{statistics.median(health_ms['sync']):.3f} ms (waits for the step), ring "
            f"{statistics.median(health_ms['ring']):.3f} ms [{card}]")
        run.close()
        del run

        # (b) 4 steps, a committed save, 2 steps, a save interrupted before its commit
        run = ResumeRun(project, layers, dataset)
        if run.acc.resume_from_latest():
            raise AssertionError("phase 9: a first launch found a checkpoint")
        for _ in range(RESUME_SAVE_AT):
            run.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt0 = run.acc.save_state()
        save_s = time.perf_counter() - t0
        written = dir_bytes(ckpt0)
        t0 = time.perf_counter()
        checkpointing.verify_checkpoint(ckpt0, level="checksum")
        verify_s = time.perf_counter() - t0
        for _ in range(RESUME_NAN_AT - RESUME_SAVE_AT):
            run.step()
        # interrupted once the model's tensors are written, before the
        # optimizer's and the commit: the staging directory holds a third of
        # a checkpoint (a full one cost ~29 s more of the script's time)
        os.environ[fault.FAULT_INJECT_ENV] = "after_model_save:raise"
        try:
            run.acc.save_state()
            raise AssertionError("phase 9: the armed fault point did not interrupt the save")
        except fault.FaultInjected:
            pass
        finally:
            del os.environ[fault.FAULT_INJECT_ENV]
        staged = sorted(os.listdir(ckpt_dir))
        if staged != ["checkpoint_0", "checkpoint_1.tmp"]:
            raise AssertionError(f"phase 9: after the interrupted save the tree holds {staged}")
        run.close()
        log(f"phase 9 (b) save_state at step {RESUME_SAVE_AT}: {written / 1e9:.3f} GB in {save_s:.2f}s "
            f"({written / save_s / 1e9:.3f} GB/s, files flushed to disk); verify='checksum' "
            f"{verify_s:.2f}s ({written / verify_s / 1e9:.3f} GB/s); a second save at step "
            f"{RESUME_NAN_AT} interrupted before its commit left {staged} [{card}]")

        # (b) resumed: roll back to the step-4 checkpoint, train steps 5-8
        run = ResumeRun(project, layers, dataset)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if not run.acc.resume_from_latest():
            raise AssertionError("phase 9: resume_from_latest found nothing")
        load_s = time.perf_counter() - t0
        if run.acc._last_committed_checkpoint != ckpt0 or run.acc.step != RESUME_SAVE_AT:
            raise AssertionError(f"phase 9: resumed {run.acc._last_committed_checkpoint} at step "
                                 f"{run.acc.step}, not {ckpt0} at step {RESUME_SAVE_AT}")
        if not same_params(run.params(), ref4):
            raise AssertionError("phase 9: the resumed parameters differ from the step-4 reference")
        no_save_ms = run.timed_steps(RESUME_STEPS - RESUME_SAVE_AT, first=run.next_batch())
        resumed, final = run.loss_values(), run.params()
        run.close()
        losses_equal = resumed == ref_losses[RESUME_SAVE_AT:]
        params_equal = same_params(final, ref8)
        log(f"phase 9 (b) resume_from_latest (a fresh Accelerator, past the uncommitted save): "
            f"{load_s:.2f}s ({written / load_s / 1e9:.3f} GB/s); losses 5-8 {resumed} bitwise equal "
            f"to (a): {losses_equal}; final params (checksum {params_checksum(final)}) bitwise equal: "
            f"{params_equal} [{card}]")
        if not (losses_equal and params_equal):
            raise AssertionError("phase 9: the resumed run differs from the uninterrupted one")
        del final

        # (c) planted fault: the same resume with the loader's position discarded
        run = ResumeRun(project, layers, dataset)
        run.acc.resume_from_latest()
        run.loader.load_state_dict({})  # starts again from batch 0 of epoch 0
        for _ in range(RESUME_STEPS - RESUME_SAVE_AT):
            run.step()
        planted, planted_equal = run.loss_values(), same_params(run.params(), ref8)
        run.close()
        log(f"phase 9 (c) planted fault (loader state discarded): losses {planted}; equal to (a): "
            f"{planted == ref_losses[RESUME_SAVE_AT:]}, params equal: {planted_equal}")
        if planted == ref_losses[RESUME_SAVE_AT:] or planted_equal:
            raise AssertionError("phase 9: the planted sampler fault went unseen")

        # (d) the health watchdog: restore on a planted NaN, sync and deferred
        restore = {}
        run = ResumeRun(project, layers, dataset)
        run.acc.resume_from_latest()
        nan_call = RESUME_NAN_AT - RESUME_SAVE_AT  # the call of step 6
        for mode, cfg in (("sync", TrainingHealthConfig(nonfinite_policy="restore")),
                          ("ring2", TrainingHealthConfig(nonfinite_policy="restore", sync=False,
                                                         readback_depth=2))):
            run.acc.health_config = cfg
            verdict_call, calls = None, 0
            while verdict_call is None and calls < nan_call + 4:
                calls += 1
                healthy = []

                def check(loss, planted=calls == nan_call):
                    healthy.append(run.acc.check_step_health(
                        loss=torch.full_like(loss, float("nan")) if planted else loss))
                    return healthy[-1]

                run.step(check=check)
                if not healthy[-1]:
                    verdict_call = calls
            back = run.acc.step == RESUME_SAVE_AT and same_params(run.params(), ref4)
            restore[mode] = dict(nan_at_call=nan_call, verdict_call=verdict_call,
                                 restored_bitwise=back)
            run.acc._bad_step_count = 0
        run.close()
        lateness = (restore["ring2"]["verdict_call"] or 0) - nan_call
        log(f"phase 9 (d) check_step_health(nonfinite_policy='restore'), NaN loss planted at step "
            f"{RESUME_NAN_AT} (call {nan_call} after the resume): sync verdict at call "
            f"{restore['sync']['verdict_call']}, restored the step-{RESUME_SAVE_AT} checkpoint bitwise: "
            f"{restore['sync']['restored_bitwise']}; sync=False readback_depth=2: verdict {lateness} "
            f"calls late, restored bitwise: {restore['ring2']['restored_bitwise']}")
        if not (restore["sync"]["verdict_call"] == nan_call and lateness == 2
                and restore["sync"]["restored_bitwise"] and restore["ring2"]["restored_bitwise"]):
            raise AssertionError(f"phase 9 (d): the watchdog did not restore as expected: {restore}")
        out["restore"] = restore

        # (e) an async save while training goes on, then the same resume from it
        run = ResumeRun(project, layers, dataset)
        run.acc.resume_from_latest()
        t0 = time.perf_counter()  # the next save would remove it first: timed apart
        shutil.rmtree(os.path.join(ckpt_dir, "checkpoint_1.tmp"))
        snap = {"remove_staging_s": time.perf_counter() - t0}
        snapshot = checkpointing._snapshot

        def timed_snapshot(tensors):
            t = time.perf_counter()
            out = snapshot(tensors)
            snap["enqueue_s"] = time.perf_counter() - t
            return out

        checkpointing._snapshot = timed_snapshot
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            ckpt1 = run.acc.save_state(async_save=True)
        finally:
            checkpointing._snapshot = snapshot
        submit_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torch.cuda.synchronize()  # the training stream waits for the snapshot's copy
        snap["copy_wait_s"] = time.perf_counter() - t0
        # the loader's start (workers, the resume's skip) before the timing,
        # as for the steps without a save; a batch handed out before the
        # save would count as consumed by it
        async_ms = run.timed_steps(RESUME_NAN_AT - RESUME_SAVE_AT, first=run.next_batch())
        t0 = time.perf_counter()
        run.acc.wait_for_async_saves()
        join_s = time.perf_counter() - t0
        committed = checkpointing.is_checkpoint_committed(ckpt1)
        run.close()
        run = ResumeRun(project, layers, dataset)
        run.acc.resume_from_latest()
        if run.acc._last_committed_checkpoint != ckpt1:
            raise AssertionError(f"phase 9 (e): resumed {run.acc._last_committed_checkpoint}, not {ckpt1}")
        for _ in range(RESUME_STEPS - RESUME_SAVE_AT):
            run.step()
        async_losses, async_final = run.loss_values(), run.params()
        run.close()
        async_equal = async_losses == ref_losses[RESUME_SAVE_AT:] and same_params(async_final, ref8)
        log(f"phase 9 (e) the interrupted save's staging directory removed in "
            f"{snap['remove_staging_s']:.2f}s; async save_state submitted in {submit_s:.3f}s (the "
            f"pinned snapshot's allocation and enqueue {snap['enqueue_s']:.3f}s), the copy then held "
            f"the training stream "
            f"{snap['copy_wait_s']:.3f}s; {len(async_ms)} steps during the write "
            f"{[round(m, 1) for m in async_ms]} ms against {[round(m, 1) for m in no_save_ms]} without "
            f"(resumed steps of (b); each first batch fetched before the timing), the commit joined {join_s:.2f}s after; committed: {committed}; "
            f"resumed losses and final params bitwise equal to (a): {async_equal} [{card}]")
        if not (committed and async_equal):
            raise AssertionError("phase 9 (e): the async save did not resume the uninterrupted run")
        del async_final, ref4, ref8
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    steps = ResumeRun.steps_run
    expected = {"flash_fwd_mma": 2 * layers * steps, "flash_bwd_dq_mma": layers * steps,
                "flash_bwd_dkv_mma": layers * steps}
    check_launches(f"phase 9 ({steps} steps; remat runs the forward twice)", launches, expected)
    out.update(save=dict(bytes=written, s=save_s, gb_per_s=written / save_s / 1e9),
               load=dict(s=load_s, gb_per_s=written / load_s / 1e9),
               verify_checksum_s=verify_s, async_save=dict(submit_s=submit_s, step_ms=async_ms,
                                                           no_save_step_ms=no_save_ms, join_s=join_s,
                                                           **snap),
               ckpt_bytes=ckpt_bytes, steps=steps, ref_losses=ref_losses)
    torch.cuda.empty_cache()
    return {k: launches[k] for k in expected}, out


# phase 13: the supervised fine-tune (phase 9's model and step, seeded
# packed rows a step) through the real launcher: N steps; the preemption's
# emergency checkpoint (mirrored to a synchronous replica) is the one
# checkpoint the crash then resumes from; faults on the first attempt only
SUP_ROWS, SUP_SEQ, SUP_STEPS = 4, 2048, 6
SUP_KILL_AFTER = 1  # (b): the worker dies at the end of its second step (after=1)
SUP_MAX_LAYERS = 1
SUP_COPIES = 3  # checkpoints on disk at once: the local tree, the replica and a staging copy
SUP_WATCHDOG_S = 150.0  # (b): above a worker's start and its longest save with the mirror
# (e): above the time from a worker's Accelerator to its first step, which
# read 7.5-16.1 s on the card's host (its CPU is shared), and more for the
# worker restarted after the kill
SUP_HANG_WATCHDOG_S = 40.0
SUP_MONITOR_S = 1.0
SUP_PREEMPT_SLEEP_S = 1.0  # (d): the window between steps the signal lands in
SUP_LAUNCH_TIMEOUT_S = 420
SUP_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "accelerate_tpu_torch",
                          "test_utils", "scripts", "crash_resume_script.py")


def supervised_depth(free_disk):
    """The deepest of 1-SUP_MAX_LAYERS layers whose checkpoint (12 B a
    parameter: f32 weights, both AdamW moments) fits SUP_COPIES times on
    the disk with 20 % to spare; the same meta-model count as phase 9."""
    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama

    sizes = {}
    for layers in range(SUP_MAX_LAYERS, 0, -1):
        with init_empty_weights():
            model = create_llama(LlamaConfig.llama3_8b(num_hidden_layers=layers), device="cpu")
        params = sum(p.numel() for p in model.parameters())
        sizes[layers] = 12 * params
        if SUP_COPIES * 12 * params * RESUME_SPARE <= free_disk:
            return layers, sizes
    raise AssertionError(f"phase 13: {free_disk / 1e9:.1f} GB of disk hold no {SUP_COPIES} "
                         f"checkpoints of 1 layer with 20 % to spare: {sizes}")


def supervised_launch(tmp, name, launch_flags, script_args, env_extra=None, cpu=False,
                      preset="llama3_8b", layers=1, signal_at_ready=False):
    """One launch of the crash script through ``python -m
    accelerate_tpu_torch.commands.launch --num_processes 1``; returns
    (returncode, stdout, stderr, the script's summary or None, its events,
    the launcher's exit time, the time the signal was sent or None). The
    launcher runs in a session of its own, killed with its tree on a
    timeout."""
    import signal as _signal

    out, events = os.path.join(tmp, f"{name}.json"), os.path.join(tmp, f"{name}.events")
    ready = os.path.join(tmp, f"{name}.ready")
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.launch", "--num_processes", "1",
           "--monitor_interval", str(SUP_MONITOR_S), *(["--cpu"] if cpu else []), *launch_flags,
           SUP_SCRIPT, *(["--cpu"] if cpu else []), "--preset", preset, "--layers", str(layers),
           "--rows", str(SUP_ROWS), "--seq", str(SUP_SEQ), "--lr", "3e-4",
           "--total_steps", str(SUP_STEPS), "--out", out, "--events", events,
           "--launches_out", os.path.join(tmp, f"launches_{name}"), *script_args]
    if signal_at_ready:
        cmd += ["--ready_file", ready, "--step_sleep", str(SUP_PREEMPT_SLEEP_S)]
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_")}
    env.update(env_extra or {})
    launched = time.time()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    sent = None
    try:
        if signal_at_ready:
            deadline = time.time() + SUP_LAUNCH_TIMEOUT_S
            while not os.path.exists(ready):
                if proc.poll() is not None or time.time() > deadline:
                    raise AssertionError(f"phase 13 ({name}): the worker never reached its first "
                                         f"step (rc {proc.poll()})")
                time.sleep(0.05)
            sent = time.time()
            proc.send_signal(_signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=SUP_LAUNCH_TIMEOUT_S)
    except BaseException:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(proc.pid, _signal.SIGKILL)
        proc.communicate()
        raise
    ended = time.time()
    with open(os.path.join("chiprun_out", f"phase13_{name}.log"), "w") as f:
        f.write(stdout + "\n--- stderr ---\n" + stderr)
    summary = json.load(open(out)) if os.path.exists(out) else None
    evs = [json.loads(line) for line in open(events)] if os.path.exists(events) else []
    starts = [e for e in evs if e["event"] == "start"]
    first_steps = _steps(evs, starts[0]["attempt"]) if starts else []
    if starts and first_steps:  # the first attempt: launcher + torchrun, the script, its beats
        log(f"phase 13 ({name}) launch {ended - launched:.1f}s: the script started "
            f"{starts[0]['process_t'] - launched:.1f}s after the launch, built its Accelerator "
            f"(the first heartbeat) {starts[0]['built_t'] - starts[0]['process_t']:.1f}s later "
            f"and ended its first step {first_steps[0]['t'] - starts[0]['built_t']:.1f}s after "
            "that (the watchdog's first gap: the model, the resume, a step)")
    return proc.returncode, stdout, stderr, summary, evs, ended, sent


def _steps(evs, attempt=None):
    return [e for e in evs if e["event"] == "step" and (attempt is None or e["attempt"] == attempt)]


def phase_supervised(card, cpu=False, preset="llama3_8b"):
    """Phase 13: the supervised fine-tune through the real launcher. (e) a
    hang on the first attempt that the watchdog kills, then a restart from
    step 0 that runs SUP_STEPS steps uninterrupted in a fresh process: the
    reference (the hung attempt's steps bitwise equal to its first ones);
    (d) --handle_preemption and a synchronous replica, SIGTERM to the
    launcher once the worker is training: one emergency checkpoint (the
    run's only save, mirrored), rc 0, no restart; (b) the relaunch with
    --max_restarts 1 and the watchdog resumes that checkpoint, its worker is
    killed at the end of its second step on its first attempt, restarted
    and resumed from the same checkpoint; it ends on (e)'s losses and
    parameters bit for bit, and its first attempt resumed at (d)'s step.
    After (b) a planted fault: one byte of the replica flipped, which the
    restore must refuse. (c), the local tree wiped and a relaunch restoring
    from the replica, is held on the CPU by tests/test_torch_elastic.py
    (``test_resume_restores_bitwise_from_replica_after_tree_wipe``). The
    uninterrupted reference run of PRs 14-18 ((a)) is (e)'s restart."""
    import re
    import shutil
    import tempfile

    from accelerate_tpu_torch import elastic
    from accelerate_tpu_torch.checkpointing import read_commit_manifest
    from accelerate_tpu_torch.utils.dataclasses import ReplicationConfig
    from accelerate_tpu_torch.utils.fault import ReplicaUnavailableError

    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()  # the children need the card's memory
    tmp_root = tempfile.gettempdir()
    free_disk = shutil.disk_usage(tmp_root).free
    layers, sizes = supervised_depth(free_disk) if preset == "llama3_8b" else (1, {1: 0})
    log(f"phase 13 space: {free_disk / 1e9:.1f} GB free on {tmp_root}; a checkpoint of 1 layer is "
        f"{sizes[1] / 1e9:.1f} GB; depth {layers} ({SUP_COPIES} checkpoints + 20 % fit)")
    started = time.perf_counter()
    out = dict(layers=layers)
    kw = dict(cpu=cpu, preset=preset, layers=layers)
    sync = {"ACCELERATE_REPLICATION_SYNC": "1"}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_supervised_", dir=tmp_root) as tmp:
        replica = os.path.join(tmp, "replica")
        project = os.path.join(tmp, "db")

        def bitwise(label, summary, start):
            same = (summary is not None and summary["checksum"] == ref["checksum"]
                    and summary["losses"] == ref["losses"][start:])
            if not same:
                raise AssertionError(f"phase 13 {label}: losses {summary and summary['losses']} "
                                     f"checksum {summary and summary['checksum']} against (e)'s "
                                     f"{ref['losses'][start:]} {ref['checksum']}")
            return same

        # (e) a hang on attempt 0: the watchdog kills, the supervisor restarts
        # from step 0 (no checkpoint yet), and the restart, an uninterrupted
        # run in a fresh process, is the reference the other scenarios end on
        rc, so, se, ref, evs_e, _, _ = supervised_launch(
            tmp, "e", ["--max_restarts", "1", "--watchdog_timeout", str(SUP_HANG_WATCHDOG_S)],
            ["--project_dir", os.path.join(tmp, "e"), "--fault", "train_step_end:hang=3600:after=1"],
            **kw)
        stale = re.search(r"heartbeat stale >([0-9.]+)s \(the oldest rank's last beat ([0-9.]+)s ago\)",
                          se)
        hung = [e["loss"] for e in _steps(evs_e, 0)]
        if rc != 0 or stale is None or "restart 1/1" not in se or ref is None \
                or ref["attempt"] != 1 or ref["start"] != 0 or len(ref["losses"]) != SUP_STEPS:
            raise AssertionError(f"phase 13 (e): rc {rc}, summary {ref}\n{se[-3000:]}")
        if len(hung) != 2 or hung != ref["losses"][:2]:
            raise AssertionError(f"phase 13 (e): the hung attempt's losses {hung} against the "
                                 f"restart's {ref['losses'][:2]}")
        age = float(stale.group(2))
        times = [e["t"] for e in _steps(evs_e, 1)]
        step_ms = [(b - a) * 1e3 for a, b in zip(times, times[1:])]
        out["e"] = dict(watchdog_s=SUP_HANG_WATCHDOG_S, detected_after_s=age,
                        latency_over_timeout_s=age - SUP_HANG_WATCHDOG_S, losses=ref["losses"],
                        checksum=ref["checksum"], step_ms=step_ms)
        log(f"phase 13 (e) hang at the end of step 2 on attempt 0: the watchdog (T = "
            f"{SUP_HANG_WATCHDOG_S:.0f}s, polled every {SUP_MONITOR_S:.0f}s) killed the worker "
            f"{age:.1f}s after its last beat ({age - SUP_HANG_WATCHDOG_S:.1f}s past T), the "
            f"supervisor restarted it from step 0 (no checkpoint yet) and it ran {SUP_STEPS} steps "
            f"uninterrupted, the hung attempt's two losses bitwise equal to its first two: True; the "
            f"reference: losses {ref['losses']}, checksum {ref['checksum']}; step ms (host clock "
            f"between steps, each ending in a loss read) {[round(m, 1) for m in step_ms]} [{card}]")

        # (d) preemption: SIGTERM to the launcher once the worker trains; the
        # emergency checkpoint is mirrored before the rank exits
        rc, so, se, sd, evs_d, ended, sent = supervised_launch(
            tmp, "d", ["--handle_preemption", "--replicate_to", replica],
            ["--project_dir", project], env_extra=sync, signal_at_ready=True, **kw)
        committed = re.search(r"emergency checkpoint committed at (\S+)", so)
        if rc != 0 or committed is None or "restart 1/" in se or sd is not None:
            raise AssertionError(f"phase 13 (d): rc {rc}, summary {sd}\n{so[-2000:]}\n{se[-3000:]}")
        manifest = read_commit_manifest(committed.group(1))
        preempted = next(e for e in evs_d if e["event"] == "preempted")
        emergency_s = manifest["time"] - preempted["t"]
        name = os.path.basename(committed.group(1).rstrip(os.sep))
        mirrored = os.path.join(replica, "r0", name)
        read_commit_manifest(mirrored)  # the replica's copy committed before the exit
        ckpt_bytes = dir_bytes(mirrored)
        out["d"] = dict(at_step=preempted["step"], emergency_save_s=emergency_s,
                        signal_to_exit_s=ended - sent, ckpt_bytes=ckpt_bytes)
        log(f"phase 13 (d) SIGTERM to the launcher after the first step: the rank checkpointed at "
            f"step {preempted['step']} ({ckpt_bytes / 1e9:.3f} GB; the emergency save committed "
            f"{emergency_s:.2f}s after the step boundary that took the signal, "
            f"{ckpt_bytes / emergency_s / 1e9:.3f} GB/s with the files flushed and checksummed; "
            f"{ended - sent:.2f}s from the signal to the launcher's exit, the synchronous mirror "
            f"to the replica included), launcher rc 0, no restart [{card}]")

        # (b) crash -> restart: the relaunch resumes (d)'s checkpoint, dies
        # at the end of its second step, and the restart resumes it again
        rc, so, se, sb, evs_b, _, _ = supervised_launch(
            tmp, "b", ["--max_restarts", "1", "--watchdog_timeout", str(SUP_WATCHDOG_S),
                       "--replicate_to", replica],
            ["--project_dir", project, "--fault", f"train_step_end:kill:after={SUP_KILL_AFTER}"],
            env_extra=sync, **kw)
        starts = {e["attempt"]: e for e in evs_b if e["event"] == "start"}
        at = preempted["step"]
        if rc != 0 or "restart 1/1" not in se or sb is None or sb["attempt"] != 1 \
                or sb["start"] != at or starts.get(0, {}).get("step") != at \
                or len(_steps(evs_b, 0)) != SUP_KILL_AFTER + 1:
            raise AssertionError(f"phase 13 (b): rc {rc}, summary {sb}, starts {starts}\n"
                                 f"{se[-3000:]}")
        bitwise("(d) and (b)", sb, at)
        death = _steps(evs_b, 0)[-1]["t"]
        first_resumed = _steps(evs_b, 1)[0]["t"]
        out["b"] = dict(restart_s=first_resumed - death, resume_load_s=starts[1]["resume_s"],
                        relaunch_load_s=starts[0]["resume_s"],
                        load_gb_per_s=ckpt_bytes / starts[1]["resume_s"] / 1e9)
        log(f"phase 13 (d) relaunch and (b) crash: the relaunch resumed (d)'s checkpoint at step "
            f"{at} ({starts[0]['resume_s']:.2f}s), its worker was killed at the end of step "
            f"{at + SUP_KILL_AFTER} on attempt 0, restarted (restart 1/1) and resumed at step "
            f"{sb['start']} through resume_from_latest: losses {sb['losses']} and checksum bitwise "
            f"equal to (e)'s uninterrupted restart: True; restart {out['b']['restart_s']:.2f}s from the worker's death to "
            f"its first resumed step (resume_from_latest {starts[1]['resume_s']:.2f}s of it, "
            f"{out['b']['load_gb_per_s']:.3f} GB/s) [{card}]")

        # planted fault: one byte of the replica flipped; the restore must refuse it
        victim = max((os.path.join(r, f) for r, _, fs in os.walk(os.path.join(replica, "r0"))
                      for f in fs), key=os.path.getsize)
        with open(victim, "r+b") as f:
            f.seek(os.path.getsize(victim) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        t0 = time.perf_counter()
        try:
            elastic.restore_from_replica(ReplicationConfig(target=replica),
                                         os.path.join(tmp, "planted"), name=name)
            raise AssertionError("phase 13: the flipped replica byte was not refused")
        except ReplicaUnavailableError as exc:
            if "crc32 mismatch" not in str(exc) or os.path.exists(os.path.join(tmp, "planted")):
                raise AssertionError(f"phase 13: the refusal did not name the checksum: {exc}")
            out["planted"] = dict(refused=True, verify_s=time.perf_counter() - t0)
        log(f"phase 13 planted fault: one byte of {os.path.relpath(victim, replica)} flipped; "
            f"restore_from_replica refused the copy (crc32 mismatch) and raised "
            f"ReplicaUnavailableError with no copy left, nothing copied, in "
            f"{out['planted']['verify_s']:.2f}s")
        shutil.rmtree(project)
        shutil.rmtree(replica)

        # the launches of every child, every attempt
        launches = dict.fromkeys(KERNEL_META, 0)
        for name in os.listdir(tmp):
            if name.startswith("launches_") and ".rank" in name:
                for k, v in json.load(open(os.path.join(tmp, name))).items():
                    launches[k] += v
        steps = sum(len(_steps(e)) for e in (evs_e, evs_d, evs_b))
    fwd = "flash_fwd" if cpu else "flash_fwd_mma"
    bwd = ("flash_bwd_dq", "flash_bwd_dkv") if cpu else ("flash_bwd_dq_mma", "flash_bwd_dkv_mma")
    expected = {fwd: 2 * layers * steps, bwd[0]: layers * steps, bwd[1]: layers * steps}
    if not cpu:
        check_launches(f"phase 13 ({steps} steps over every launch and attempt)", launches,
                       expected)
    out.update(steps=steps, seconds=time.perf_counter() - started)
    log(f"phase 13 took {out['seconds']:.1f}s [{card}]")
    return {k: launches[k] for k in expected}, out


# ---------------------------------------------------------------- phase 14
# serving over a mesh: (a) the TP layout forced at tp = 1 over a one-rank
# NCCL group, each generate against the unsharded model's; (b) four tp
# ranks and (c) dp_shard 2 x tp 2 as threads on the one card (torch's
# threaded group, which cannot be captured: the decode runs eagerly);
# (d) the static server over (a)'s model, then (a)'s dense run again on
# that model with FSDP2 forced over its one-rank dp_shard dim. Phase 14's
# depth is cut first when the script's time limit presses.
SERVE_MESH_LAYERS = 8
SERVE_THREAD_LAYERS = 4
SERVE_THREAD_NEW = 64
SERVE_THREAD_TIMEOUT_S = 300
SERVE_THREAD_LAYOUTS = {"tp4": {"tp": 4}, "dp_shard2_tp2": {"dp_shard": 2, "tp": 2}}
SERVE_SERVER_NEW = 64


def serve_generate_runs(model, ids, kv, n_layers, label):
    """``generate`` greedy three times: eagerly, the first graph call (it
    captures) and a graph call, the last with the launch counters reset
    just before. Returns (tokens, seconds of the graph call, its launches,
    the program), raising unless all three are bitwise equal."""
    from accelerate_tpu_torch.engine import _disable_graphs
    from accelerate_tpu_torch.inference import generate
    from accelerate_tpu_torch.ops import _build

    kw = dict(kv_backend=kv, kv_block_size=16)
    with _disable_graphs():
        eager = generate(model, ids, STATIC_NEW, **kw)
    first = generate(model, ids, STATIC_NEW, **kw)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(model, ids, STATIC_NEW, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _build.launch_counts()
    check_launches(f"phase 14 (a) {label} generate {kv}", launches, {"flash_fwd_mma": n_layers})
    if not (torch.equal(first, eager) and torch.equal(out, eager)):
        raise AssertionError(f"phase 14 (a) {label} {kv}: the graph runs' tokens differ from the "
                             "eager run's")
    progs = list(static_programs(model).values())
    if len(progs) != 1 or progs[0].graph is None:
        raise AssertionError(f"phase 14 (a) {label} {kv}: {len(progs)} programs, graph "
                             f"{progs[0].graph if progs else None}")
    return out, secs, launches, progs[0]


def serve_one_rank(dev, card):
    """Phase 14 (a) and (d) over the one-rank NCCL group the caller
    started. Returns (launches of (a)'s dense TP graph call, of its dense
    TP x FSDP2 graph call, of (d)'s server run, numbers)."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch.models.llama import serving_view
    from accelerate_tpu_torch.parallel.mesh import sub_mesh

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.inference import generate, prepare_inference
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig, TensorParallelConfig

    n_layers = SERVE_MESH_LAYERS
    acc = Accelerator(mixed_precision="bf16",
                      parallelism_config=ParallelismConfig(tp_config=TensorParallelConfig()))
    if acc.layout != "tp":
        raise AssertionError(f"phase 14 (a): asked for the TP layout, the Accelerator chose {acc.layout}")
    plain = serving_model(dev, n_layers)
    laid = prepare_inference(serving_model(dev, n_layers), mesh=acc.mesh, rules=tensor_parallel_rules())
    if laid.tp is None or not all(isinstance(p, DTensor) for p in laid.parameters()):
        raise AssertionError("phase 14 (a): prepare_inference(mesh=, rules=) did not lay the model "
                             "over the tp mesh")
    cfg = plain.config
    rng = np.random.default_rng(14)
    ids = rng.integers(0, cfg.vocab_size, size=(STATIC_B, STATIC_PROMPT)).astype(np.int32)
    numbers = {"backends": {}}
    tp_launches = None
    for kv in ("dense", "paged"):
        row = {}
        for label, model in (("unsharded", plain), ("tp", laid)):
            static_programs(model).clear()
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out, secs, launches, prog = serve_generate_runs(model, ids, kv, n_layers, label)
            peak = torch.cuda.max_memory_allocated() - base
            row[label] = dict(tokens=out, seconds=secs, tokens_per_s=STATIC_B * STATIC_NEW / secs,
                              decode_ms=static_decode_ms(prog, STATIC_NEW), peak_bytes=peak)
            if label == "tp" and kv == "dense":
                tp_launches = launches
            static_programs(model).clear()
        same = torch.equal(row["tp"]["tokens"], row["unsharded"]["tokens"])
        u, t = row["unsharded"], row["tp"]
        log(f"phase 14 (a) generate {kv} (B={STATIC_B}, prompt {STATIC_PROMPT}, {STATIC_NEW} new, "
            f"greedy, {n_layers} layers): TP layout at tp=1 over NCCL, decode step captured with its "
            f"collectives, graph runs bitwise equal to the eager run and to the unsharded model's "
            f"tokens: {same}; tokens/s TP {t['tokens_per_s']:.1f} vs unsharded {u['tokens_per_s']:.1f}, "
            f"decode replay {t['decode_ms']:.3f} vs {u['decode_ms']:.3f} ms, generate's peak above the "
            f"weights {t['peak_bytes'] / 1e9:.2f} vs {u['peak_bytes'] / 1e9:.2f} GB [{card}]")
        if not same:
            raise AssertionError(f"phase 14 (a) {kv}: the TP layout's tokens differ from the "
                                 "unsharded model's")
        numbers["backends"][kv] = {label: {k: v for k, v in r.items() if k != "tokens"}
                                   for label, r in row.items()}
        if kv == "dense":
            plain_dense = row["unsharded"]["tokens"]
    del plain
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the static server at its defaults over the laid-out model
    prompts = [rng.integers(0, cfg.vocab_size, size=STATIC_PROMPT).astype(np.int32)
               for _ in range(STATIC_B)]
    with InferenceServer(laid, ServingConfig(), device=dev) as srv:
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        futs = [srv.submit(p, max_new_tokens=SERVE_SERVER_NEW) for p in prompts]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        server_launches = _build.launch_counts()
        batches = srv.metrics["batches"]
    check_launches("phase 14 (d) server", server_launches, {"flash_fwd_mma": n_layers * batches})
    if any(r.batch_size != STATIC_B for r in results):
        raise AssertionError("phase 14 (d): a server batch did not fill its 8 rows")
    total = STATIC_PROMPT + SERVE_SERVER_NEW
    direct = generate(laid, np.stack(prompts), SERVE_SERVER_NEW,
                      pad_to=-(-total // 64) * 64).cpu().numpy()
    same = all(np.array_equal(r.tokens, direct[i]) for i, r in enumerate(results))
    log(f"phase 14 (d) InferenceServer(ServingConfig()) over the TP-laid model: {len(prompts)} greedy "
        f"requests of {STATIC_PROMPT} tokens, {SERVE_SERVER_NEW} new, {batches} batch(es), "
        f"{len(prompts) * SERVE_SERVER_NEW / wall:.1f} generated tokens/s in {wall:.3f}s (captures "
        f"its program); every reply equal to a direct generate of the rows: {same} [{card}]")
    if not same:
        raise AssertionError("phase 14 (d): a reply differs from a direct generate of its batch")
    numbers["server"] = dict(wall_s=wall, batches=batches, launches=server_launches)
    static_programs(laid).clear()

    # (a) again on the same model with FSDP2 forced on its one-rank dp_shard
    # dim: the steps gather each layer's shards (the model's ShardGather)
    # inside the graph and look the embedding up in its shard
    for layer in laid.layers:
        fully_shard(layer, mesh=sub_mesh(acc.mesh, "dp_shard"))
    fully_shard(laid, mesh=sub_mesh(acc.mesh, "dp_shard"), reshard_after_forward=False)
    if serving_view(laid).fsdp_group is None:
        raise AssertionError("phase 14 (a): FSDP2 over dp_shard left no shard to gather")
    out, secs, fsdp_launches, prog = serve_generate_runs(laid, ids, "dense", n_layers, "tp x fsdp")
    same = torch.equal(out, plain_dense)
    decode_ms = static_decode_ms(prog, STATIC_NEW)
    log(f"phase 14 (a) generate dense under TP x FSDP2 at 1 x 1 (each layer's shards gathered "
        f"inside the captured step): graph runs bitwise equal to the eager run and to the "
        f"unsharded model's tokens: {same}; {STATIC_B * STATIC_NEW / secs:.1f} tokens/s, decode "
        f"replay {decode_ms:.3f} ms [{card}]")
    if not same:
        raise AssertionError("phase 14 (a): the TP x FSDP2 layout's tokens differ from the "
                             "unsharded model's")
    numbers["tp_fsdp_dense"] = dict(seconds=secs, tokens_per_s=STATIC_B * STATIC_NEW / secs,
                                    decode_ms=decode_ms)
    static_programs(laid).clear()
    del laid, acc, prog
    return tp_launches, fsdp_launches, server_launches, numbers


def thread_ranks(dims, whole, cfg, work, label):
    """One rank of the ``dims`` mesh a thread of this process over torch's
    threaded group on the one card, each holding its ``tp`` blocks (and
    under ``dp_shard`` its FSDP2 shards) of ``whole`` (checkpoint key ->
    tensor), each running ``work(model, rank)``. Returns ({rank: what work
    returned}, the launches of the run)."""
    import threading

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard
    from torch.testing._internal.distributed import multi_threaded_pg

    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.inference import graphs_supported
    from accelerate_tpu_torch.models.llama import create_llama, serving_view
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.parallel.mesh import sub_mesh
    from accelerate_tpu_torch.parallel.tp import apply_tensor_parallel

    world = math.prod(dims.values())
    with init_empty_weights():
        shells = [create_llama(cfg) for _ in range(world)]
    store = dist.HashStore()
    out = {"results": {}, "errors": {}, "graphs": {}}
    pg = multi_threaded_pg._install_threaded_pg()
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    _build.reset_launch_counts()

    def rank(r):
        try:
            dist.init_process_group("threaded", rank=r, world_size=world, store=store)
            mesh = init_device_mesh("cuda", tuple(dims.values()), mesh_dim_names=tuple(dims))
            model = shells[r]
            model.unstack_layers()
            apply_tensor_parallel(model, sub_mesh(mesh, "tp") if len(dims) > 1 else mesh,
                                  source=lambda key, layer: whole[key] if layer is None else whole[key][layer])
            if "dp_shard" in dims:
                for layer in model.layers:
                    fully_shard(layer, mesh=sub_mesh(mesh, "dp_shard"))
                fully_shard(model, mesh=sub_mesh(mesh, "dp_shard"), reshard_after_forward=False)
            out["graphs"][r] = graphs_supported(serving_view(model))
            out["results"][r] = work(model, r)
            dist.barrier()
        except BaseException as e:  # handed to the main thread, which raises it
            out["errors"][r] = e
            raise

    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(world)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_THREAD_TIMEOUT_S)
        if any(t.is_alive() for t in threads) and not out["errors"]:
            raise AssertionError(f"{label}: a thread still runs after {SERVE_THREAD_TIMEOUT_S}s")
    finally:
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
        multi_threaded_pg._uninstall_threaded_pg()
        del pg
    if out["errors"]:
        raise next(iter(out["errors"].values()))
    if any(out["graphs"].values()):
        raise AssertionError(f"{label}: the threaded group claims a capturable step")
    return out["results"], _build.launch_counts()


def serve_threads(dims, whole, cfg, ids, fault=False):
    """Phase 14 (b) and (c) through :func:`thread_ranks`: each rank runs
    ``generate`` greedy, or with ``fault`` sampled with rank 1's seed
    another. Returns ({rank: tokens}, {rank: what the fault raised}, the
    launches of the run)."""
    from accelerate_tpu_torch.inference import generate

    def work(model, r):
        if not fault:
            return generate(model, ids, SERVE_THREAD_NEW)
        try:
            generate(model, ids, SERVE_THREAD_NEW, **{**STATIC_SAMPLED, "seed": 3 + (r == 1)})
        except ValueError as e:
            return str(e)
        return None

    results, launches = thread_ranks(dims, whole, cfg, work, "phase 14")
    return ({}, results, launches) if fault else (results, {}, launches)


def serve_thread_layouts(dev, card):
    """Phase 14 (b) and (c) on a 4-layer model: greedy tokens held against
    the plain forward by phase 12's rule, equal on every rank; B1 at the
    ranks' heads counted; the planted seed fault caught on every rank.
    Returns ({layout: launches}, numbers)."""
    import dataclasses

    n_layers = SERVE_THREAD_LAYERS
    model = serving_model(dev, n_layers)
    cfg = model.config
    whole = {key: getattr(model, name).detach() for key, name in model.checkpoint_keys()}
    params = model.params
    cfg_r = dataclasses.replace(cfg, attention_impl="xla")
    ids = np.random.default_rng(141).integers(0, cfg.vocab_size,
                                              size=(STATIC_B, STATIC_PROMPT)).astype(np.int32)
    ids_t = torch.from_numpy(ids).to(dev)
    launches, numbers = {}, {}
    for name, dims in SERVE_THREAD_LAYOUTS.items():
        t0 = time.perf_counter()
        tokens, _, counts = serve_threads(dims, whole, cfg, ids)
        secs = time.perf_counter() - t0
        world = math.prod(dims.values())
        heads = (cfg.num_attention_heads // dims["tp"], cfg.num_key_value_heads // dims["tp"])
        check_launches(f"phase 14 {name} ({world} threads, {heads[0]} q and {heads[1]} kv heads a "
                       "rank)", counts, {"flash_fwd_mma": n_layers * world})
        first = tokens[0]
        equal = all(torch.equal(tokens[r], first) for r in tokens)
        share, gap, gap_ulps = choice_agreement(
            first[:, STATIC_PROMPT:].long(), static_reference(cfg_r, params, ids_t, first))
        _, caught, _ = serve_threads(dims, whole, cfg, ids, fault=True)
        fault_caught = len(caught) == world and all(c is not None and "seed" in c
                                                    for c in caught.values())
        log(f"phase 14 {name}: {world} ranks as threads (threaded group: the decode runs eagerly), "
            f"{n_layers} layers, B={STATIC_B}, prompt {STATIC_PROMPT}, {SERVE_THREAD_NEW} new, greedy "
            f"in {secs:.1f}s: tokens equal on every rank {equal}; teacher-forced against the plain "
            f"forward: argmax share {share:.4f} (min {GREEDY_SHARE_MIN}), largest gap {gap:.4f} = "
            f"{gap_ulps:.3f} bf16 ulps (limit {Q_NEAR_TIE_ULPS}); planted fault (rank 1 sampled with "
            f"another seed) caught on every rank: {fault_caught} [{card}]")
        if not (equal and share >= GREEDY_SHARE_MIN and gap_ulps <= Q_NEAR_TIE_ULPS):
            raise AssertionError(f"phase 14 {name}: the ranks' tokens disagree with each other or "
                                 "with the plain forward")
        if not fault_caught:
            raise AssertionError(f"phase 14 {name}: a rank sampling with another seed was not "
                                 f"caught ({caught})")
        launches[name] = {"flash_fwd_mma": counts["flash_fwd_mma"]}
        numbers[name] = dict(seconds=secs, share=share, gap=gap, gap_ulps=gap_ulps,
                             fault_caught=fault_caught)
    del model, whole, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, numbers


def phase_serving_mesh(dev, card):
    """Phase 14: (a) and (d) over a one-rank NCCL group (ended after),
    then (b) and (c) over torch's threaded group. Returns ({path:
    launches}, numbers)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_rdzv_")
    AcceleratorState._reset_state(reset_partial_state=True)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        tp_launches, fsdp_launches, server_launches, numbers = serve_one_rank(dev, card)
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        gc.collect()
        torch.cuda.empty_cache()
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    thread_launches, numbers["threads"] = serve_thread_layouts(dev, card)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"phase 14 took {numbers['seconds']:.1f}s [{card}]")
    paths = {"static_tp": tp_launches, "static_tp_fsdp": fsdp_launches,
             "static_tp_server": server_launches}
    paths.update({f"static_{name}_threads": counts for name, counts in thread_launches.items()})
    return paths, numbers


# ---------------------------------------------------------------- phase 15
# the continuous engine over a mesh: (a) phase 4's model and traffic under
# the TP layout at tp = 1 over a one-rank NCCL group, through the
# continuous InferenceServer; (b) four of phase 7's requests with
# speculation and chunks on the bf16 and the int8 pool; (c) tp 2 as
# threads at 4 layers, eagerly
CONT_SPEC_PICK = (0, 3, 4, 7)  # of spec_traffic: 0, 4 drafter-friendly (greedy), 3, 7 long (sampled)
CONT_THREAD_LAYERS = 4
CONT_THREAD_DIMS = {"tp": 2}


def spec_shape():
    return dict(bucket=SPEC_SERVING["engine_prompt_bucket"], chunk=SPEC_SERVING["engine_prefill_chunk"],
                k=SPEC_SERVING["spec_draft_len"])


def pooled_teacher_forced(cfg_r, params, prompts, tokens):
    """Phase 7's rule over greedy requests: (argmax share pooled over the
    requests, the largest gap at the rest)."""
    agree = total = 0
    worst = 0.0
    for p, t in zip(prompts, tokens):
        a, n, gap = teacher_forced(cfg_r, params, p, list(t))
        agree, total, worst = agree + a, total + n, max(worst, gap)
    return agree / total, worst


def spec_engine_run(dev, model, kv):
    """Phase 15 (b)'s requests (``CONT_SPEC_PICK`` of phase 7's mix, even
    indices greedy, odd ones sampled with their index as seed) inserted at
    once into a fresh engine at phase 7's settings over the ``kv`` pool,
    then drained; the launch counters reset just before. One schedule, so
    two models that compute the same logits give the same tokens."""
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.ops import _build

    sp = spec_traffic(model.config.vocab_size)
    prompts = [sp[i] for i in CONT_SPEC_PICK]
    eng = ContinuousBatchingEngine(
        model, slots=SPEC_SERVING["engine_slots"], max_len=SPEC_SERVING["engine_max_len"],
        prompt_bucket=SPEC_SERVING["engine_prompt_bucket"],
        readback_lag=SPEC_SERVING["engine_readback_lag"], kv_cache=kv,
        block_size=SPEC_SERVING["engine_block_size"], attention_impl="kernel", spec="ngram",
        spec_draft_len=SPEC_SERVING["spec_draft_len"],
        prefill_chunk=SPEC_SERVING["engine_prefill_chunk"], device=dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    occs = []
    for i, p in zip(CONT_SPEC_PICK, prompts):
        sampled = i % 2 == 1
        occs.append(eng.insert(p, max_new_tokens=SPEC_NEW_TOKENS,
                               temperature=0.8 if sampled else 0.0, top_k=50 if sampled else None,
                               top_p=0.9 if sampled else None, seed=i))
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats = eng.stats()
    spec = stats["spec"]
    delta = dict(steps=eng.steps, verify=eng.spec_verify_steps, chunks=eng.prefill_chunks,
                 inserted=eng.inserted, **{k: spec[k] for k in ("drafted", "accepted", "wasted")})
    return dict(tokens=[o.output_row() for o in occs], prompts=prompts, delta=delta,
                launches=_build.launch_counts(), programs=stats["programs"],
                program_count=stats["program_count"], engine=eng, wall_s=wall,
                hbm_bytes=stats["kv"]["hbm_bytes"])


def continuous_one_rank(dev, card, n_layers, reference):
    """Phase 15 (a) and (b) over the one-rank NCCL group the caller
    started. Returns ({path: launches}, numbers)."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.inference import prepare_inference
    from accelerate_tpu_torch.models.llama import serving_view
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig, TensorParallelConfig

    acc = Accelerator(mixed_precision="bf16",
                      parallelism_config=ParallelismConfig(tp_config=TensorParallelConfig()))
    if acc.layout != "tp":
        raise AssertionError(f"phase 15: asked for the TP layout, the Accelerator chose {acc.layout}")
    laid = prepare_inference(serving_model(dev, n_layers), mesh=acc.mesh, rules=tensor_parallel_rules())
    if laid.tp is None or not all(isinstance(p, DTensor) for p in laid.parameters()):
        raise AssertionError("phase 15: prepare_inference(mesh=, rules=) did not lay the model out")
    cfg = laid.config
    paths, numbers = {}, {}

    # (a) phase 4's mix through the continuous server, one run (it captures)
    prompts, warm = main_traffic(cfg.vocab_size)
    run = serve_mix(dev, laid, prompts, ServingConfig(**SERVING), MAIN_NEW_TOKENS, warm=warm)
    eng = run["engine"]
    check_launches("phase 15 (a)", run["launches"], main_expected(n_layers, len(prompts), run))
    check_programs("phase 15 (a)", run, JAX_PROGRAMS["serving"])
    check_replay_launches("phase 15 (a)", eng, n_layers, SERVING["engine_prompt_bucket"])
    same = [np.array_equal(r.tokens, t) for r, t in zip(run["results"], reference["serving"])]
    log_run("phase 15 (a) (the continuous server over the TP layout at tp=1, NCCL collectives in "
            "the captured programs; phase 4's 16 requests, half sampled)", run, card,
            f"; tokens bitwise equal to phase 4's: {sum(same)}/{len(same)}; pool "
            f"{run['delta']['hbm_bytes'] / 1e9:.3f} GB a rank")
    if not all(same):
        raise AssertionError(f"phase 15 (a): requests {[i for i, x in enumerate(same) if not x]} "
                             "differ from phase 4's unsharded engine")
    steady = decode_steady_state(eng, prompts, card, 1, profile=False, label="phase 15 (a)")
    ref_steady = reference["steady"]
    log(f"phase 15 (a) decode replay {steady['decode_ms_per_step'][0]:.3f} ms/step against phase 4's "
        + ", ".join(f"{x:.3f}" for x in ref_steady["decode_ms_per_step"]) + "; the host's ms a tick "
        f"{steady['host_ms_per_step'][0]:.3f} against "
        + ", ".join(f"{x:.3f}" for x in ref_steady["host_ms_per_step"]) + f" [{card}]")
    paths["continuous_tp"] = {k: run["launches"][k] for k in main_expected(n_layers, len(prompts), run)}
    numbers["main"] = dict(run=run_numbers([run])[0], steady=steady, programs=run["programs"],
                           per_replay=eng.graph_launches(), pool_bytes=run["delta"]["hbm_bytes"])
    del eng, run
    torch.cuda.empty_cache()

    # (b) speculation and chunks on the bf16 and the int8 pool, through the
    # engine (one schedule: its tokens are the unsharded engine's bit for bit)
    cfg_r = dataclasses.replace(cfg, attention_impl="xla")
    params = serving_view(laid).params  # at tp = 1 the rank's blocks are the whole leaves
    for kv, suffix, path in (("paged", "", "continuous_tp_spec"),
                             ("paged_int8", "_int8", "continuous_tp_int8")):
        label = f"phase 15 (b) {kv}"
        run = spec_engine_run(dev, laid, kv)
        d, sub = run["delta"], run["prompts"]
        n_single = sum(len(p) <= SPEC_SERVING["engine_prompt_bucket"] for p in sub)
        expected = expected_launches(n_layers, d, n_single, suffix)
        check_launches(label, run["launches"], expected)
        check_programs(label, run, JAX_PROGRAMS["spec"])
        check_replay_launches(label, run["engine"], n_layers, suffix=suffix, **spec_shape())
        if not (d["verify"] > 0 and d["chunks"] == 3 * (len(sub) - n_single)):
            raise AssertionError(f"{label}: the verify or the chunk program did not run: {d}")
        same = [np.array_equal(t, r) for t, r in zip(run["tokens"], reference["spec"][kv])]
        share = gap = None
        if kv == "paged":  # phase 7's rule holds the bf16 pool (the plain forward has no int8)
            greedy = [(p, t[len(p):]) for i, p, t in zip(CONT_SPEC_PICK, sub, run["tokens"])
                      if i % 2 == 0]
            share, gap = pooled_teacher_forced(cfg_r, params, *zip(*greedy))
        log(f"{label} (the engine over the TP layout at tp=1; spec ngram/4, chunk 512; "
            f"{n_single} drafter-friendly greedy, {len(sub) - n_single} of 1,025-1,500 sampled, "
            f"{SPEC_NEW_TOKENS} new): {d} in {run['wall_s']:.3f}s; tokens bitwise equal to the "
            f"unsharded engine's (phase 7's model) {sum(same)}/{len(same)}"
            + ("" if share is None else f"; greedy teacher-forced share {share:.3f} (min "
               f"{GREEDY_SHARE_MIN}), largest gap {gap:.4f} (near-tie limit {NEAR_TIE})")
            + f"; pool {run['hbm_bytes'] / 1e9:.3f} GB a rank [{card}]")
        if not all(same):
            raise AssertionError(f"{label}: requests {[i for i, x in enumerate(same) if not x]} "
                                 "differ from the unsharded engine's")
        if share is not None and not (share >= GREEDY_SHARE_MIN and gap <= NEAR_TIE):
            raise AssertionError(f"{label}: greedy tokens disagree with the plain forward")
        paths[path] = {k: run["launches"][k] for k in expected}
        numbers[kv] = dict(wall_s=run["wall_s"], delta=d, programs=run["programs"],
                           greedy_share=share, greedy_worst_gap=gap, pool_bytes=run["hbm_bytes"])
        del run
        torch.cuda.empty_cache()
    del laid, params, acc
    return paths, numbers


def continuous_threads(dev, card):
    """Phase 15 (c): tp 2 as threads, 4 layers, the engine eagerly over
    (b)'s four prompts, all greedy: B1, B4, B5 and B6 at 16/4 heads a rank.
    Returns (launches, numbers)."""
    import dataclasses

    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    n_layers = CONT_THREAD_LAYERS
    model = serving_model(dev, n_layers)
    cfg = model.config
    whole = {key: getattr(model, name).detach() for key, name in model.checkpoint_keys()}
    params = model.params
    prompts = [spec_traffic(cfg.vocab_size)[i] for i in CONT_SPEC_PICK]
    n_single = sum(len(p) <= SPEC_SERVING["engine_prompt_bucket"] for p in prompts)

    def work(laid, r):
        eng = ContinuousBatchingEngine(
            laid, slots=8, max_len=SPEC_SERVING["engine_max_len"],
            prompt_bucket=SPEC_SERVING["engine_prompt_bucket"], kv_cache="paged", block_size=16,
            attention_impl="kernel", spec="ngram", spec_draft_len=SPEC_SERVING["spec_draft_len"],
            prefill_chunk=SPEC_SERVING["engine_prefill_chunk"], device=dev)
        occs = [eng.insert(p, max_new_tokens=SPEC_NEW_TOKENS) for p in prompts]
        eng.drain()
        return dict(tokens=[list(o.tokens) for o in occs],
                    delta=dict(steps=eng.steps, verify=eng.spec_verify_steps, chunks=eng.prefill_chunks),
                    pool_bytes=eng.stats()["kv"]["hbm_bytes"])

    t0 = time.perf_counter()
    results, counts = thread_ranks(CONT_THREAD_DIMS, whole, cfg, work, "phase 15 (c)")
    secs = time.perf_counter() - t0
    world = math.prod(CONT_THREAD_DIMS.values())
    first = results[0]
    equal = all(res["tokens"] == first["tokens"] and res["delta"] == first["delta"]
                for res in results.values())
    expected = {k: world * n for k, n in expected_launches(n_layers, first["delta"], n_single).items()}
    tp = CONT_THREAD_DIMS["tp"]
    heads = (cfg.num_attention_heads // tp, cfg.num_key_value_heads // tp)
    check_launches(f"phase 15 (c) ({world} threads, {heads[0]} q and {heads[1]} kv heads a rank)",
                   counts, expected)
    cfg_r = dataclasses.replace(cfg, attention_impl="xla")
    shares = [teacher_forced_ulps(cfg_r, params, p, t) for p, t in zip(prompts, first["tokens"])]
    n = sum(k for _, _, k in shares)
    share = sum(a * k for a, _, k in shares) / n
    gap_ulps = max(g for _, g, _ in shares)
    log(f"phase 15 (c): tp {tp} as threads (threaded group: the engine runs eagerly), {n_layers} "
        f"layers, (b)'s 4 prompts greedy, spec ngram/4, chunk 512, {SPEC_NEW_TOKENS} new in "
        f"{secs:.1f}s; engine steps {first['delta']}; tokens and steps equal on every rank {equal}; "
        f"teacher-forced against the plain forward: argmax share {share:.4f} (min "
        f"{GREEDY_SHARE_MIN}), largest gap {gap_ulps:.3f} bf16 ulps (limit {Q_NEAR_TIE_ULPS}); pool "
        f"{first['pool_bytes'] / 1e9:.3f} GB a rank [{card}]")
    if not (equal and share >= GREEDY_SHARE_MIN and gap_ulps <= Q_NEAR_TIE_ULPS):
        raise AssertionError("phase 15 (c): the ranks' tokens disagree with each other or with the "
                             "plain forward")
    if not (first["delta"]["verify"] > 0 and first["delta"]["chunks"] > 0):
        raise AssertionError(f"phase 15 (c): the verify or the chunk program never ran ({first['delta']})")
    del model, whole, params
    gc.collect()
    torch.cuda.empty_cache()
    return ({k: counts[k] for k in expected},
            dict(seconds=secs, share=share, gap_ulps=gap_ulps, delta=first["delta"],
                 pool_bytes=first["pool_bytes"]))


def teacher_forced_ulps(cfg_r, params, prompt, tokens):
    """Phase 12's rule for one request: (argmax share, largest gap in bf16
    ulps of the plain forward's largest |logit|, positions), teacher-forced
    over prompt + output."""
    from accelerate_tpu_torch.models.llama import llama_apply

    dev = params["embed_tokens"]["embedding"].device
    toks = torch.tensor(tokens, device=dev).long()
    seq = torch.cat([torch.from_numpy(prompt).to(dev).long(), toks[:-1]])[None]
    ref = llama_apply(cfg_r, params, seq)[0, len(prompt) - 1:]
    share, _, gap_ulps = choice_agreement(toks, ref)
    return share, gap_ulps, len(tokens)


def phase_continuous_mesh(dev, card, n_layers, reference):
    """Phase 15: (a) and (b) over a one-rank NCCL group (ended after), then
    (c) over torch's threaded group. Returns ({path: launches}, numbers)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    t0 = time.perf_counter()
    store = tempfile.mkdtemp(prefix="chip_smoke_rdzv_")
    AcceleratorState._reset_state(reset_partial_state=True)
    dist.init_process_group("nccl", init_method=f"file://{store}/store", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        paths, numbers = continuous_one_rank(dev, card, n_layers, reference)
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        gc.collect()
        torch.cuda.empty_cache()
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    paths["continuous_tp2_threads"], numbers["threads"] = continuous_threads(dev, card)
    numbers["seconds"] = time.perf_counter() - t0
    log(f"phase 15 took {numbers['seconds']:.1f}s [{card}]")
    return paths, numbers


# ---------------------------------------------------------------- phase 18
# the serving fleet: two continuous replicas of phase 4's model (one set of
# weights, an engine and a pool each) behind a FleetRouter; (a) phase 4's
# mix, (b) the mix again while r0's worker is killed, then the same prompts
# greedy with speculation while it is killed again, (c) the breaker and the
# ladder on one server, (d) tracing and perfwatch
FLEET_REPLICAS = ("r0", "r1")
FLEET_SPEC = dict(SERVING, speculative="ngram", spec_draft_len=4)
FLEET_KILL_TICK = 24  # (b): r0's worker dies at its 24th engine tick of the mix, mid-decode
FLEET_TRACE_RUNS = 2  # (d): mixes with tracing off and on, alternating
# the prober's reads share the host's cores with two engine threads: a
# brown-out (a probe slower than 50 ms) is not what this phase measures,
# and its hedges would run requests twice
FLEET_CONFIG = dict(brownout_probe_ewma_s=5.0, hedge_brownout=False)
TRACING_GATE = 0.02  # benchmarks/tracing_bench.py's bound on the goodput tracing may cost
# (c): the static breaker's sequence, the one tests/test_torch_serving_control.py
# (test_breaker_cycle_through_the_static_server) holds to the JAX server's:
# two failed batches, the refusal with its reset hint, OPEN then HALF_OPEN,
# the failed probe, the probe that closes it, CLOSED
BREAKER_SEQUENCE = [("BatchExecutionError", False, "r0"), ("BatchExecutionError", False, "r0"),
                    ("CircuitOpenError", True, "r0", 5.0), ("health", 1), ("health", 2),
                    ("BatchExecutionError", False, "r0"), ("probe", False, "r0", 0), ("health", 0)]
BREAKER_COUNTS = {"breaker_opens": 2, "rejected_breaker": 1, "batch_failures": 3, "completed": 2,
                  "batches": 2}
# (c): the ladder's scenario of test_continuous_ladder_and_spec_rung_match_jax:
# one slot, the first tick held while three requests queue (3 of 4 places)
LADDER_SERVING = dict(mode="continuous", engine_slots=1, engine_max_len=64, engine_prompt_bucket=16,
                      engine_readback_lag=0, kv_cache="paged", engine_block_size=16,
                      attention_impl="kernel", speculative="ngram", spec_draft_len=4, max_queue=4,
                      degrade_queue_fraction=0.5, degrade_hard_fraction=0.75,
                      degraded_max_new_tokens=4)
LADDER_PROMPTS = ([7, 8, 9, 7, 8, 9, 7, 8], [3, 4, 3, 4, 3, 4, 3, 4, 3], [11, 12, 13, 11, 12, 13],
                  [5, 17, 33, 2, 9])
LADDER_BUDGETS = [12, 2, 4, 12]  # the clamps JAX's server gives them: none, hard, soft, none
LADDER_DEGRADED = [False, True, True, False]


class FakeClock:
    """A monotonic clock advanced by hand (the breaker's reset window)."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


def fleet_servers(dev, model, scfg, warm):
    """One continuous server per replica id over ``model``, each with its
    own engine, warmed one after the other (their graphs captured before
    the mix)."""
    from accelerate_tpu_torch.serving import InferenceServer

    servers = {rid: InferenceServer(model, scfg, replica_id=rid, device=dev)
               for rid in FLEET_REPLICAS}
    for srv in servers.values():
        for f in [srv.submit(p, max_new_tokens=8) for p in warm]:
            f.result(timeout=300)
    return servers


def fleet_mix(router, servers, prompts, new_tokens, sampled=True):
    """Submit ``prompts`` at once through ``router`` (odd ones sampled,
    seed i, as phase 4 serves them, when ``sampled``); launch counters
    reset just before and read just after. Returns results, wall time,
    launches and the engines' counter deltas."""
    from accelerate_tpu_torch.ops import _build

    def counters():
        return {rid: dict(steps=s.engine.steps, verify=s.engine.spec_verify_steps,
                          inserted=s.engine.inserted) for rid, s in servers.items()}

    before = counters()
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    futs = []
    for i, p in enumerate(prompts):
        odd = sampled and i % 2 == 1
        futs.append(router.submit(p, max_new_tokens=new_tokens, temperature=0.8 if odd else 0.0,
                                  top_k=50 if odd else None, top_p=0.9 if odd else None, seed=i))
    results, errors = [], []
    for f in futs:
        exc = f.exception(timeout=900)
        if exc is not None:
            errors.append(f"{type(exc).__name__}: {exc}")
        else:
            results.append(f.result())
    done = time.perf_counter()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if errors:
        raise AssertionError(f"phase 18: {len(errors)} request(s) ended in an error: {errors[:3]}")
    after = counters()
    delta = {k: sum(after[r][k] - before[r][k] for r in servers) for k in ("steps", "verify",
                                                                           "inserted")}
    return dict(results=results, wall_s=done - t0, end_t=done, launches=launches, delta=delta,
                tokens_per_s=len(prompts) * new_tokens / (done - t0),
                ttft_s=sorted(r.ttft_s for r in results))


def fleet_kill_mix(router, servers, prompts, new_tokens, sampled):
    """``fleet_mix`` with r0's serving worker killed at its
    ``FLEET_KILL_TICK``-th engine tick of the mix, through the fault
    points. Adds ``killed_t``, the kill's time (None when r0 never reached
    that tick)."""
    from accelerate_tpu_torch.utils.fault import install_conductor, uninstall_conductor

    ticks, killed = {"n": 0}, {}

    def conductor(name, context):
        if name == "serving_after_batch" and context.get("replica") == "r0":
            ticks["n"] += 1
            if ticks["n"] == FLEET_KILL_TICK:
                killed["t"] = time.perf_counter()
                raise SystemExit("phase 18 (b): r0's serving worker killed")

    install_conductor(conductor)
    try:
        run = fleet_mix(router, servers, prompts, new_tokens, sampled=sampled)
    finally:
        uninstall_conductor(conductor)
    run["killed_t"] = killed.get("t")
    return run


def fleet_expected(n_layers, delta):
    decode = delta["steps"] - delta["verify"]
    out = {"flash_fwd_mma": n_layers * delta["inserted"], "paged_decode_mma": n_layers * decode,
           "fused_sample": decode + delta["inserted"]}
    if delta["verify"]:
        out["paged_verify_mma"] = n_layers * delta["verify"]
    return out


def pct(sorted_values, p):
    return sorted_values[min(len(sorted_values) - 1, int(round(p / 100 * (len(sorted_values) - 1))))]


def perf_family(scfg):
    """The engine's perfwatch family for a serving config (``engine.py``
    ``_pw_flush``)."""
    return "engine.paged_kernel" if scfg["attention_impl"] == "kernel" else "engine.paged"


def fleet_baseline(path, model, prompts, new_tokens):
    """(d)'s baseline for the card: ``decode_step`` at its bytes bound, the
    weights and the live KV of 8 slots at the mix's mean position over
    3.35 TB/s; ``prefill_insert`` at the larger of its bytes and its bf16
    operations (2 per parameter and prompt token, the 512 bucket).
    ``verify_step`` (8 slots of a draft and its token) and ``prefill_chunk``
    (a 512-token chunk) the same way: a window's time is split by the
    predictions of the programs that retired in it, and one without a
    prediction would bill its time to its neighbours."""
    cfg = model.config
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    params = sum(p.numel() for p in model.parameters())
    kv_per_pos = 2 * cfg.num_hidden_layers * cfg.num_key_value_heads * cfg.head_dim * 2
    mean_pos = float(np.mean([len(p) for p in prompts])) + new_tokens / 2
    decode_s = (weights + 8 * mean_pos * kv_per_pos) / HBM_BYTES_PER_S
    bf16 = PEAK_FLOPS[torch.bfloat16]
    bucket = SERVING["engine_prompt_bucket"]
    prefill_s = max(weights / HBM_BYTES_PER_S, 2 * params * bucket / bf16)
    window = 8 * (SPEC_SERVING["spec_draft_len"] + 1)
    verify_s = max(decode_s, 2 * params * window / bf16)
    chunk = SPEC_SERVING["engine_prefill_chunk"]
    chunk_s = max(weights / HBM_BYTES_PER_S, 2 * params * chunk / bf16)
    family = perf_family(SERVING)
    doc = {"chip": "h100", "tolerance": 0.05, "programs": {
        f"{family}/decode_step": {"predicted_s": decode_s, "bound": "hbm", "flops": 2 * params * 8,
                                  "tok_s": 8 / decode_s},
        f"{family}/prefill_insert": {"predicted_s": prefill_s, "bound": "flops",
                                     "flops": 2 * params * bucket},
        f"{family}/verify_step": {"predicted_s": verify_s, "bound": "hbm",
                                  "flops": 2 * params * window},
        f"{family}/prefill_chunk": {"predicted_s": chunk_s, "bound": "flops",
                                    "flops": 2 * params * chunk}}}
    Path(path).write_text(json.dumps(doc))
    return dict(decode_s=decode_s, prefill_s=prefill_s, weights_bytes=weights,
                kv_bytes=8 * mean_pos * kv_per_pos)


def span_tree(tracer):
    """One traced request's spans, by its fleet.submit: their names and
    whether each expected child sits inside its parent on one thread."""
    (root, *_) = tracer.spans(name="fleet.submit")
    trace = tracer.spans(trace_id=root.trace_id)
    names = [s.name for s in trace]

    def inside(child, parent):
        c = [s for s in trace if s.name == child]
        p = [s for s in trace if s.name == parent]
        return bool(c and p) and all(any(q.tid == s.tid and q.t0 <= s.t0 and s.t1 <= q.t1 for q in p)
                                     for s in c)

    nested = {f"{c} in {p}": inside(c, p) for c, p in (("fleet.dispatch", "fleet.submit"),
                                                       ("engine.prefill", "serving.admit"))}
    return names, nested


def breaker_cycle(dev, model):
    """(c): the static server's breaker on an injected clock, the batch
    executor failing until the backend "recovers", then ``generate`` on the
    card."""
    from accelerate_tpu_torch.inference import generate
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    state = {"broken": True}
    clock = FakeClock()

    def fn(m, ids, **kw):
        if state["broken"]:
            raise RuntimeError("backend down")
        return generate(m, ids, **kw)

    cfg = ServingConfig(max_retries=0, breaker_threshold=2, breaker_reset_s=5.0, max_batch_size=1,
                        batch_window_s=0.0)
    seen = []

    def error(fut):
        exc = fut.exception(300)
        return (type(exc).__name__, exc.retriable, exc.replica_id)

    with InferenceServer(model, cfg, generate_fn=fn, clock=clock, replica_id="r0",
                         device=dev) as srv:
        prompt = np.arange(1, 4, dtype=np.int32)
        for _ in range(2):
            seen.append(error(srv.submit(prompt)))
        deadline = time.time() + 30
        while not srv._breaker.rejects_admission and time.time() < deadline:
            time.sleep(0.002)
        try:
            srv.submit(prompt)
            seen.append("admitted")
        except Exception as exc:  # noqa: BLE001 - the sequence holds its type
            seen.append((type(exc).__name__, exc.retriable, exc.replica_id, exc.retry_after_s))
        seen.append(("health", srv.health()["breaker_state"]))
        clock.t += 5.0
        seen.append(("health", srv.health()["breaker_state"]))
        seen.append(error(srv.submit(prompt)))
        while not srv._breaker.rejects_admission and time.time() < deadline:
            time.sleep(0.002)
        state["broken"] = False
        clock.t += 5.0
        res = srv.submit(prompt).result(300)
        seen.append(("probe", res.degraded, res.replica_id, res.failover_count))
        seen.append(("health", srv.health()["breaker_state"]))
        second = srv.submit(prompt).result(300)
        counts = {k: srv.metrics[k] for k in BREAKER_COUNTS}
    vocab = model.config.vocab_size
    valid = all(r.tokens.shape == (3 + 32,) and ((r.tokens >= 0) & (r.tokens < vocab)).all()
                for r in (res, second))
    return seen, counts, valid


def ladder_run(dev, model):
    """(c): the ladder on one continuous server (1 slot, speculation on):
    the first tick held while three requests queue; the spec limits the
    ladder set, each request's budget and ``degraded``."""
    import threading

    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    srv = InferenceServer(model, ServingConfig(**LADDER_SERVING), device=dev)
    eng = srv.engine
    with srv:  # warm: the programs captured before the scenario
        srv.submit(np.asarray(LADDER_PROMPTS[0], np.int32), max_new_tokens=12).result(300)
    srv = InferenceServer(model, ServingConfig(**LADDER_SERVING), engine=eng, device=dev)
    limits, gate, entered = [], threading.Event(), threading.Event()
    real_limit, real_step = eng.set_spec_draft_limit, eng.step

    def record_limit(n):
        limits.append(int(n))
        return real_limit(n)

    def held_step():
        entered.set()
        gate.wait(60)
        return real_step()

    eng.set_spec_draft_limit, eng.step = record_limit, held_step
    try:
        prompts = [np.asarray(p, np.int32) for p in LADDER_PROMPTS]
        first = srv.submit(prompts[0], max_new_tokens=12)
        if not entered.wait(120):
            raise AssertionError("phase 18 (c): the ladder's first tick never ran")
        futs = [first] + [srv.submit(p, max_new_tokens=12) for p in prompts[1:]]
        gate.set()
        results = [f.result(300) for f in futs]
        degraded = srv.metrics["degraded"]
    finally:
        gate.set()
        srv.close()
        eng.set_spec_draft_limit, eng.step = real_limit, real_step
    del eng
    return dict(limits=limits, degraded=[r.degraded for r in results],
                budgets=[len(r.tokens) - len(p) for r, p in zip(results, prompts)],
                counter=degraded)


def phase_fleet(dev, card, model, phase4):
    """Phase 18: A10's serving half on the card. Returns the launches of
    (a) (``fleet``) and (b) (``fleet_spec``) and the numbers."""
    import shutil
    import tempfile
    import urllib.request

    from accelerate_tpu_torch import perfwatch, tracing
    from accelerate_tpu_torch.fleet import FleetRouter
    from accelerate_tpu_torch.utils.dataclasses import (FleetConfig, ObservabilityConfig,
                                                        ServingConfig, TracingConfig)

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    prompts, warm = main_traffic(cfg.vocab_size)
    new_tokens = MAIN_NEW_TOKENS
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fleet_")
    prev_tracing = tracing.get_tracer().config
    out = {}
    try:
        # (d)'s baseline first: every engine of the phase bills its windows
        # to this watch
        base = fleet_baseline(os.path.join(tmp, "baseline.json"), model, prompts, new_tokens)
        watch = perfwatch.configure(ObservabilityConfig(baseline_path=os.path.join(tmp,
                                                                                   "baseline.json")))
        tracing.configure(TracingConfig(dump_dir=tmp))

        # (a) routing: phase 4's mix through the fleet
        servers = fleet_servers(dev, model, ServingConfig(**SERVING), warm)
        router = FleetRouter(dict(servers), FleetConfig(**FLEET_CONFIG))
        run = fleet_mix(router, servers, prompts, new_tokens)
        check_launches("phase 18 (a)", run["launches"], fleet_expected(n_layers, run["delta"]))
        same = [np.array_equal(r.tokens, t) for r, t in zip(run["results"], phase4["tokens"])]
        share = {rid: sum(r.replica_id == rid for r in run["results"]) for rid in FLEET_REPLICAS}
        ttft = run["ttft_s"]
        p4 = phase4["runs"][0]["tokens_per_s"]
        log(f"phase 18 (a) fleet of {len(servers)} continuous replicas of phase 4's model, its 16 "
            f"requests: {sum(same)}/16 bitwise equal to phase 4's single server; "
            f"{run['tokens_per_s']:.1f} tokens/s against phase 4's {p4:.1f}; TTFT p50 "
            f"{pct(ttft, 50):.4f}s p99 {pct(ttft, 99):.4f}s; requests by replica {share}; engine "
            f"steps {run['delta']['steps']} [{card}]")
        if not all(same) or min(share.values()) == 0:
            raise AssertionError(f"phase 18 (a): bitwise {same}, shares {share}")
        a_launches = {k: run["launches"][k] for k in fleet_expected(n_layers, run["delta"])}
        out["a"] = dict(tokens_per_s=run["tokens_per_s"], phase4_tokens_per_s=p4,
                        ttft_p50_s=pct(ttft, 50), ttft_p99_s=pct(ttft, 99), share=share,
                        steps=run["delta"]["steps"])

        # (d) tracing off against on, the span tree, the dump, perfwatch and
        # the exporter, on (a)'s fleet
        rates = {False: [], True: []}
        for _ in range(FLEET_TRACE_RUNS):
            for on in (False, True):
                tracing.configure(TracingConfig(enabled=on, dump_dir=tmp))
                rates[on].append(fleet_mix(router, servers, prompts, new_tokens)["tokens_per_s"])
        tracer = tracing.get_tracer()  # on: the last mix's spans
        names, nested = span_tree(tracer)
        need = {"fleet.submit", "fleet.dispatch", "serving.admit", "engine.prefill", "engine.retire"}
        dump = tracer.dump("phase18")
        doc = json.loads(Path(dump).read_text())
        complete = sum(e["ph"] == "X" for e in doc["traceEvents"])
        off, on = statistics.median(rates[False]), statistics.median(rates[True])
        cost = (off - on) / off
        log(f"phase 18 (d) tracing: tokens/s off {[round(r, 1) for r in rates[False]]} on "
            f"{[round(r, 1) for r in rates[True]]}: {cost * 100:.2f} % of goodput (tracing_bench.py "
            f"gates {TRACING_GATE * 100:.0f} %, reported only); one request's trace "
            f"{names} (nested {nested}); flight dump {complete} spans, "
            f"{len(doc['traceEvents'])} events, valid Chrome JSON [{card}]")
        if not need <= set(names) or names[0] != "fleet.submit" or names[-1] != "engine.retire" \
                or not all(nested.values()) or complete == 0:
            raise AssertionError(f"phase 18 (d): span tree {names}, nested {nested}")
        rows = {r["program"]: r for r in watch.table()}
        program = f"{perf_family(SERVING)}/decode_step"
        dec = rows[program]
        replay = statistics.median(phase4["steady"]["decode_ms_per_step"])
        log(f"phase 18 (d) perfwatch {program}: {dec['samples']} calls, median "
            f"{dec['measured_s'] * 1e3:.3f} ms (a tick, host included) against phase 4's steady "
            f"decode {replay:.3f} ms/step; predicted {dec['predicted_s'] * 1e3:.3f} ms (weights "
            f"{base['weights_bytes'] / 1e9:.2f} GB + live KV {base['kv_bytes'] / 1e9:.3f} GB at "
            f"3.35 TB/s), measured/predicted {dec['ratio']:.3f}, status {dec['status']} [{card}]")
        if not dec["samples"] or dec["measured_s"] is None:
            raise AssertionError("phase 18 (d): perfwatch measured no decode step")
        exporter = perfwatch.MetricsExporter(router.metrics_snapshot, host="127.0.0.1", port=0)
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics",
                                        timeout=30) as resp:
                text = resp.read().decode()
        finally:
            exporter.close()
        Path("chiprun_out", "phase18_metrics.prom").write_text(text)
        lines = text.splitlines()
        shown = [ln for ln in lines if ln.startswith(("accelerate_fleet_completed",
                                                      "accelerate_fleet_routed",
                                                      "accelerate_perf_engine_paged_kernel_decode_step_ratio",
                                                      "accelerate_fleet_replica_serving_completed"))]
        log(f"phase 18 (d) exporter on 127.0.0.1:{exporter.port}/metrics: {len(lines)} samples "
            f"(chiprun_out/phase18_metrics.prom), among them: " + "; ".join(shown))
        if not shown:
            raise AssertionError("phase 18 (d): the exporter served none of the fleet's samples")
        out["d"] = dict(tokens_per_s_off=rates[False], tokens_per_s_on=rates[True],
                        tracing_cost=cost, spans=names, dump_spans=complete,
                        decode_measured_s=dec["measured_s"], decode_predicted_s=dec["predicted_s"],
                        ratio=dec["ratio"], decode_calls=dec["samples"],
                        phase4_decode_ms=replay, exporter_samples=len(lines))

        # (b) failover, first without speculation: phase 4's mix again on
        # (a)'s fleet with r0's worker killed mid-decode through the fault
        # points; a moved request starts again on r1 with its seed, so every
        # request's tokens are phase 4's bitwise, the moved ones too
        tracing.configure(TracingConfig(dump_dir=tmp))
        run_k = fleet_kill_mix(router, servers, prompts, new_tokens, sampled=True)
        check_launches("phase 18 (b) without speculation", run_k["launches"],
                       fleet_expected(n_layers, run_k["delta"]))
        same_k = [np.array_equal(r.tokens, t) for r, t in zip(run_k["results"], phase4["tokens"])]
        moved_k = [r for r in run_k["results"] if r.failover_count]
        alive_k = servers["r0"].health()["worker_alive"]
        kill_to_last_k = None if run_k["killed_t"] is None else run_k["end_t"] - run_k["killed_t"]
        log(f"phase 18 (b) failover without speculation, phase 4's mix on (a)'s fleet: r0 killed at "
            f"its tick {FLEET_KILL_TICK} (worker alive after: {alive_k}); {sum(same_k)}/16 bitwise "
            f"equal to phase 4's single server, none in an error; {len(moved_k)} moved to "
            f"{sorted({r.replica_id for r in moved_k})} with failover_count "
            f"{[r.failover_count for r in moved_k]}; {kill_to_last_k}s from the kill to the last "
            f"result; {run_k['tokens_per_s']:.1f} tokens/s against (a)'s "
            f"{out['a']['tokens_per_s']:.1f} [{card}]")
        if kill_to_last_k is None or alive_k or not all(same_k) or not moved_k \
                or any(r.replica_id != "r1" for r in moved_k):
            raise AssertionError(f"phase 18 (b) without speculation: killed at "
                                 f"{run_k['killed_t']}, alive {alive_k}, bitwise {same_k}, moved "
                                 f"{len(moved_k)}")
        out["b_exact"] = dict(tokens_per_s=run_k["tokens_per_s"], kill_to_last_s=kill_to_last_k,
                              moved=len(moved_k), bitwise=sum(same_k))
        router.close()
        del router, servers, run, run_k
        gc.collect()
        torch.cuda.empty_cache()

        # (b) failover with speculation: the same prompts, greedy, with
        # speculation on both replicas so that B5 runs; r0's worker killed
        # mid-decode again
        warm_b = warm + drafter_prompts(np.random.default_rng(2), 1, 200, 200, cfg.vocab_size)
        servers = fleet_servers(dev, model, ServingConfig(**FLEET_SPEC), warm_b)
        fcfg = FleetConfig(**FLEET_CONFIG, retry_budget_refill_per_s=0.0)  # its spend, exactly
        router = FleetRouter(dict(servers), fcfg)
        run_b = fleet_kill_mix(router, servers, prompts, new_tokens, sampled=False)
        moved = [r for r in run_b["results"] if r.failover_count]
        m = router.metrics
        unplanned = m["failovers"] - m["redistributed"]
        spent = fcfg.retry_budget_capacity - router._budget.available()
        alive = servers["r0"].health()["worker_alive"]
        check_launches("phase 18 (b)", run_b["launches"], fleet_expected(n_layers, run_b["delta"]))
        # speculation makes a slot's logits depend on its neighbours (a step
        # is a verify step when any slot drafted), and the failover moves
        # slots: the greedy tokens are held by phase 12's rule (phase 15
        # (c)'s for speculative traffic), not bitwise
        cfg_r = dataclasses.replace(cfg, attention_impl="xla")
        tf = [teacher_forced_ulps(cfg_r, model.params, p, r.tokens[len(p):].tolist())
              for p, r in zip(prompts, run_b["results"])]
        share_b = sum(a * k for a, _, k in tf) / sum(k for _, _, k in tf)
        gap = max(g for _, g, _ in tf)
        if run_b["killed_t"] is None:
            raise AssertionError("phase 18 (b): r0's worker was never killed")
        kill_to_last = run_b["end_t"] - run_b["killed_t"]
        log(f"phase 18 (b) failover: r0 killed at its tick {FLEET_KILL_TICK} (worker alive after: "
            f"{alive}); {len(run_b['results'])}/16 completed, none in an error; {len(moved)} moved "
            f"to {sorted({r.replica_id for r in moved})} with failover_count "
            f"{[r.failover_count for r in moved]}; failovers {m['failovers']} (planned drains "
            f"{m['redistributed']}), retry budget spent {spent:.0f} = unplanned {unplanned}; "
            f"{kill_to_last:.3f}s from the kill to the last result; {run_b['tokens_per_s']:.1f} "
            f"tokens/s against (a)'s {out['a']['tokens_per_s']:.1f}; "
            f"verify steps {run_b['delta']['verify']} of {run_b['delta']['steps']}; greedy tokens "
            f"teacher-forced against the plain forward: argmax share {share_b:.4f} (min "
            f"{GREEDY_SHARE_MIN}), largest gap {gap:.3f} bf16 ulps (limit {Q_NEAR_TIE_ULPS}) "
            f"[{card}]")
        if alive or not moved or any(r.replica_id != "r1" for r in moved) \
                or round(spent) != unplanned + m["hedges"] or sum(r.failover_count for r in moved) != m["failovers"] \
                or share_b < GREEDY_SHARE_MIN or gap > Q_NEAR_TIE_ULPS:
            raise AssertionError(f"phase 18 (b): alive {alive}, moved "
                                 f"{len(moved)}, spent {spent} of {unplanned} unplanned")
        b_launches = {k: run_b["launches"][k] for k in fleet_expected(n_layers, run_b["delta"])}
        out["b"] = dict(tokens_per_s=run_b["tokens_per_s"], kill_to_last_s=kill_to_last,
                        moved=len(moved), failovers=m["failovers"], redistributed=m["redistributed"],
                        budget_spent=spent, verify_steps=run_b["delta"]["verify"],
                        greedy_share=share_b, greedy_gap_ulps=gap)
        router.close()
        del router, servers, run_b
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the breaker and the ladder, each against the JAX sequence
        seen, counts, valid = breaker_cycle(dev, model)
        ladder = ladder_run(dev, model)
        log(f"phase 18 (c) breaker: {seen} counters {counts}; the probes' tokens valid {valid}; "
            f"ladder: spec limits {ladder['limits']}, budgets {ladder['budgets']}, degraded "
            f"{ladder['degraded']} (counter {ladder['counter']}) [{card}]")
        if seen != BREAKER_SEQUENCE or counts != BREAKER_COUNTS or not valid:
            raise AssertionError(f"phase 18 (c): the breaker's sequence {seen} {counts}, JAX's "
                                 f"{BREAKER_SEQUENCE} {BREAKER_COUNTS}")
        if ladder["degraded"] != LADDER_DEGRADED or ladder["budgets"] != LADDER_BUDGETS \
                or ladder["limits"][0] != 4 or 0 not in ladder["limits"] or ladder["counter"] != 2:
            raise AssertionError(f"phase 18 (c): the ladder {ladder}")
        out["c"] = dict(breaker=seen, counts=counts, ladder=ladder)
    finally:
        tracing.configure(prev_tracing)
        perfwatch.configure(ObservabilityConfig())
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return {"fleet": a_launches, "fleet_spec": b_launches}, out


# ----------------------------------------------------------------- phase 19
# phase 7's server with a bounded queue the admission rung can halve
CONTROL_SERVING = dict(SPEC_SERVING, kv_cache="paged", max_queue=24)
# the hedge rung's knob is set; the brown-out detector's perf term stays
# off until (b) arms it (three engine threads share the card and the host)
CONTROL_FLEET = dict(FLEET_CONFIG, probe_interval_s=0.1, hedge_deadline_fraction=0.5,
                     brownout_residual_ratio=1e9)
CONTROL_LOOP = dict(interval_s=0.2, knob_cooldown_s=0.2, scale_cooldown_s=1.0,
                    actuation_budget_capacity=32, actuation_budget_refill_per_s=5.0,
                    stale_after_s=5.0, min_replicas=2, max_replicas=3, replace_on_drift=False)
# (a)'s rates in shares of phase 18's tokens/s (the crowd: twice it)
CONTROL_SCHEDULE = dict(base=0.3, peak=0.7, crowd=2.0, ramp_s=4.0, flash_s=4.0, drain_s=4.0)
CHAOS_SCHEDULE = dict(base=0.3, peak=0.6, crowd=1.5, ramp_s=3.0, flash_s=3.0, drain_s=3.0)
CONTROL_SEED = 19
# phase 7's long prompts take three chunks a request, phase 4's none: the
# SLO is this many times phase 18's TTFT p99, which the ramp keeps and the
# crowd breaches
CONTROL_SLO_X = 2.0
# chunks a tick: the longctx rung halves 2 to 1 and relaxes back; from the
# engine's default of 1 it would pause chunked prefill, and each paused
# long prompt holds its slot until the rung is released
CONTROL_CHUNK_LIMIT = 2
CONTROL_RELAX_S = 90.0  # the longest wait for the ladder's way back
CONTROL_WINDOW = 8  # each replica's perfwatch reservoir: (b)'s drift shows in 4 windows
DRIFT_SLEEP_S = 0.1
DRIFT_REQUESTS = 48  # at once: placed about evenly before either replica admits any
DRIFT_BURST_S = 0.05
# budgets of 1-12 tokens: slots free at different ticks, so while its
# queue lasts r0 admits (and sleeps) in nearly every window its perfwatch
# bills, and the median of its last CONTROL_WINDOW windows moves
DRIFT_BUDGETS = 12
DRIFT_AFTER_S = 0.3
CHAOS_GATE = (0.85, 1.5)  # benchmarks/chaos_bench.py: goodput >= 0.85x, TTFT p99 <= 1.5x


def wait_until(predicate, timeout_s, interval_s=0.02):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return predicate()


def longest_distinct(pairs):
    """``(prompt index, tokens)`` pairs less the ones whose tokens are a
    prefix of another's for the same prompt (a clamped budget's)."""
    keep = []
    for i, toks in sorted(set(pairs), key=lambda p: -len(p[1])):
        if not any(j == i and other[:len(toks)] == toks for j, other in keep):
            keep.append((i, toks))
    return keep


def phase_control(dev, card, model, phase18):
    """Phase 19: the SLO controller and the chaos conductor over a fleet on
    the card. Returns the launches of (a) (``control``) and the numbers."""
    import shutil
    import tempfile

    from accelerate_tpu_torch import chaos, perfwatch, tracing
    from accelerate_tpu_torch import engine as engine_mod
    from accelerate_tpu_torch.controller import SLOController
    from accelerate_tpu_torch.fleet import FleetRouter
    from accelerate_tpu_torch.ops import _build
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.test_utils import arrivals
    from accelerate_tpu_torch.test_utils.scripts import control_timing as ct
    from accelerate_tpu_torch.utils.dataclasses import (ControllerConfig, FleetConfig,
                                                        ObservabilityConfig, ServingConfig,
                                                        TracingConfig)
    from accelerate_tpu_torch.utils.fault import FAULT_INJECT_ENV, ControllerStaleError

    cfg = model.config
    n_layers = cfg.num_hidden_layers
    prompts, warm = spec_traffic(cfg.vocab_size), spec_warm(cfg.vocab_size)
    bucket = CONTROL_SERVING["engine_prompt_bucket"]
    greedy = [len(p) <= bucket for p in prompts]  # phase 7's: drafter-friendly greedy, long sampled
    tmp = tempfile.mkdtemp(prefix="chip_smoke_control_")
    prev_tracing = tracing.get_tracer().config
    built, single, builds = {}, {}, []
    real_graph_init = engine_mod._Graph.__init__

    def timed_graph_init(self, body, generators):
        # a build holds the one graph lock every engine's replays take
        t0 = time.perf_counter()
        real_graph_init(self, body, generators)
        builds.append(time.perf_counter() - t0)

    def server(rid):
        """A continuous replica over ``model``, warmed: its programs captured
        before traffic. Its single-shot prefills are counted (B1's launches
        are L each)."""
        srv = InferenceServer(model, ServingConfig(**CONTROL_SERVING), replica_id=rid, device=dev)
        eng, single[rid] = srv.engine, 0
        eng.set_prefill_chunk_limit(CONTROL_CHUNK_LIMIT)
        real_insert = eng.insert

        def insert(prompt, *args, **kwargs):
            single[rid] += len(prompt) <= eng.prompt_bucket
            return real_insert(prompt, *args, **kwargs)

        eng.insert = insert
        # one at a time: the random prompts alone step through decode_step;
        # then drafter-friendly prompts until the drafter's first proposal
        # has built verify_step
        for p in warm:
            srv.submit(p, max_new_tokens=8).result(timeout=300)
        for p in [p for p, g in zip(prompts, greedy) if g]:
            if "verify_step" in eng.stats()["programs"]:
                break
            srv.submit(p, max_new_tokens=SPEC_NEW_TOKENS).result(timeout=300)
        have = eng.stats()["programs"]
        if have != JAX_PROGRAMS["spec"]:
            raise AssertionError(f"phase 19: {rid}'s warm-up built {have}, JAX's spec engine "
                                 f"compiles {JAX_PROGRAMS['spec']}")
        # from here the replica bills a watch of its own, which its
        # metrics_snapshot() reports: the warm-up's eager runs and captures
        # are not among its windows
        eng._perfwatch = perfwatch.PerfWatch(obs)
        built[rid] = srv
        return srv

    def counters(rid):
        eng = built[rid].engine
        return dict(steps=eng.steps, verify=eng.spec_verify_steps, chunks=eng.prefill_chunks,
                    single=single[rid])

    def programs(rid):
        eng = built[rid].engine
        return eng.stats()["programs"], sorted(eng.graph_launches())

    kv_bytes = (2 * n_layers * cfg.num_key_value_heads * cfg.head_dim * 2
                * CONTROL_SERVING["engine_slots"] * CONTROL_SERVING["engine_max_len"])
    scaled = {}

    def factory(rid):
        free, total = torch.cuda.mem_get_info(dev)
        if free < 2 * kv_bytes:
            raise AssertionError(f"phase 19: {free / 1e9:.2f} GB free of {total / 1e9:.2f}, a "
                                 f"replica's pool takes {kv_bytes / 1e9:.2f}")
        t0, n0 = time.perf_counter(), len(builds)
        srv = server(rid)
        scaled[rid] = dict(build_s=time.perf_counter() - t0, graphs=len(builds) - n0,
                           graph_lock_s=sum(builds[n0:]), max_graph_s=max(builds[n0:], default=0.0),
                           free_gb=free / 1e9, total_gb=total / 1e9, pool_gb=kv_bytes / 1e9)
        return srv

    out, router = {}, None
    try:
        engine_mod._Graph.__init__ = timed_graph_init
        tracing.configure(TracingConfig(dump_dir=tmp))
        fleet_baseline(os.path.join(tmp, "baseline.json"), model, prompts, SPEC_NEW_TOKENS)
        obs = ObservabilityConfig(baseline_path=os.path.join(tmp, "baseline.json"),
                                  window=CONTROL_WINDOW)
        for rid in FLEET_REPLICAS:
            server(rid)
        # the process's watch: the findings the controller answers
        fleet_watch = perfwatch.configure(obs)
        router = FleetRouter({rid: built[rid] for rid in FLEET_REPLICAS},
                             FleetConfig(**CONTROL_FLEET), replica_factory=factory)

        # (a) the loop through a flash crowd
        cap = phase18["a"]["tokens_per_s"] / SPEC_NEW_TOKENS
        slo = CONTROL_SLO_X * phase18["a"]["ttft_p99_s"]
        cs = CONTROL_SCHEDULE
        sched = arrivals.ramp_flash_crowd_drain(
            base_rps=cs["base"] * cap, peak_rps=cs["peak"] * cap, ramp_s=cs["ramp_s"],
            flash_s=cs["flash_s"], drain_s=cs["drain_s"], flash_multiplier=cs["crowd"] / cs["peak"],
            seed=CONTROL_SEED)
        order = arrivals.prompt_order(len(sched), len(prompts), seed=CONTROL_SEED)
        programs0 = {rid: programs(rid) for rid in FLEET_REPLICAS}
        ctl = SLOController(router, ControllerConfig(ttft_slo_s=slo, **CONTROL_LOOP),
                            watch=fleet_watch)
        ticks = ct.timed_ticks(ctl)
        before = {rid: counters(rid) for rid in built}
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        try:
            with ct.FleetMeter(router, ctl) as meter:
                ctl.start()
                run = ct.drive(router, sched, prompts, order, greedy, new_tokens=SPEC_NEW_TOKENS)
                relaxed = wait_until(lambda: not ctl.engaged_rungs()
                                     and router.replica_ids() == list(FLEET_REPLICAS),
                                     CONTROL_RELAX_S)
        finally:
            ctl.close()
        torch.cuda.synchronize()
        launches = _build.launch_counts()
        delta = {k: sum(counters(rid)[k] - before.get(rid, {}).get(k, 0) for rid in built)
                 for k in ("steps", "verify", "chunks", "single")}
        expected = expected_launches(n_layers, delta, delta["single"])
        check_launches("phase 19 (a)", launches, expected)
        events = ct.ladder_events(meter.timeline)
        problems = ct.ladder_problems(meter.timeline, len(FLEET_REPLICAS))
        reached = any(len(reps) > len(FLEET_REPLICAS) and rungs == tuple(ct.RUNG_ORDER)
                      for _, rungs, reps, _ in meter.timeline)
        ups = [rid for _, kind, rid, _ in events if kind == "up"]
        downs = [rid for _, kind, rid, _ in events if kind == "down"]
        same_programs = {rid: programs(rid) == programs0[rid] for rid in FLEET_REPLICAS}
        cfg_r = dataclasses.replace(cfg, attention_impl="xla")
        pairs = [(r["prompt"], tuple(int(t) for t in r["outcome"].tokens[len(prompts[r["prompt"]]):]))
                 for r in run["requests"]
                 if greedy[r["prompt"]] and not isinstance(r["outcome"], BaseException)]
        tf = [teacher_forced_ulps(cfg_r, model.params, prompts[i], list(toks))
              for i, toks in longest_distinct(pairs)]
        share = sum(a * k for a, _, k in tf) / max(1, sum(k for _, _, k in tf))
        gap = max((g for _, g, _ in tf), default=0.0)
        window = meter.window_s
        new_rid = ups[0] if ups else None
        stall = scaled.get(new_rid, {})
        timeline = [(t, kind, what, None if p is None else round(p, 3)) for t, kind, what, p in events]
        log(f"phase 19 (a) SLOController over r0, r1 (phase 7's servers, max_queue "
            f"{CONTROL_SERVING['max_queue']}) through a seeded ramp -> crowd -> drain of phase 7's "
            f"mix: {len(sched)} arrivals {sched.phase_counts()} at {cs['base']}-{cs['peak']} of "
            f"phase 18's {phase18['a']['tokens_per_s']:.1f} tokens/s, the crowd {cs['crowd']}x; TTFT "
            f"SLO {slo:.4f}s ({CONTROL_SLO_X} x phase 18's p99); chunks a tick "
            f"{CONTROL_CHUNK_LIMIT}; rungs (t s, action, what, pressure): {timeline}; "
            f"{run['completed']} completed ({run['degraded']} degraded), failures {run['typed']}, "
            f"retry_after_s {sorted(set(round(h, 3) for h in run['retry_after_s']))[:6]}, untyped "
            f"{len(run['untyped'])}, dropped {run['dropped']} [{card}]")
        log(f"phase 19 (a) TTFT by phase { {k: {kk: (round(vv, 4) if isinstance(vv, float) else vv) for kk, vv in v.items()} for k, v in run['ttft_by_phase'].items()} }; "
            f"{run['tokens_per_s']:.1f} tokens/s; replica-seconds {meter.replica_seconds:.2f} against "
            f"{3 * window:.2f} for three static replicas over the same {window:.2f}s window "
            f"({meter.replica_seconds / (3 * window):.3f}); controller tick ms p50 "
            f"{ct.pct(ticks, 50):.3f} max {max(ticks):.3f} ({len(ticks)} ticks; the scale tick builds "
            f"the replica); {new_rid}: built in {stall.get('build_s', 0.0):.2f}s, {stall.get('graphs')} "
            f"graph builds held the graph lock {stall.get('graph_lock_s', 0.0):.3f}s (longest "
            f"{stall.get('max_graph_s', 0.0):.3f}s), stalling every other engine's replays that long; "
            f"free memory before it {stall.get('free_gb', 0.0):.2f} of {stall.get('total_gb', 0.0):.2f} "
            f"GB (its pool {stall.get('pool_gb', 0.0):.2f}); programs unchanged {same_programs}; "
            f"greedy tokens teacher-forced: share {share:.4f} (min {GREEDY_SHARE_MIN}), largest gap "
            f"{gap:.3f} bf16 ulps (limit {Q_NEAR_TIE_ULPS}), {len(tf)} distinct sequences [{card}]")
        if problems or not relaxed or not reached or set(downs) != set(ups) \
                or run["dropped"] or run["untyped"] \
                or not all(h is not None and h > 0 for h in run["retry_after_s"]) \
                or not all(same_programs.values()) or share < GREEDY_SHARE_MIN or gap > Q_NEAR_TIE_ULPS:
            raise AssertionError(f"phase 19 (a): problems {problems[:3]}, relaxed {relaxed}, "
                                 f"scale reached {reached}, up {ups}, down {downs}, dropped "
                                 f"{run['dropped']}, untyped {run['untyped'][:3]}, programs "
                                 f"before {programs0} after "
                                 f"{ {rid: programs(rid) for rid in FLEET_REPLICAS} }, share "
                                 f"{share}, gap {gap}")
        a_launches = {k: launches[k] for k in expected}
        out["a"] = dict(ct.summary(run), events=timeline, replica_seconds=meter.replica_seconds,
                        static_replica_seconds=3 * window, window_s=window, slo_s=slo,
                        tick_ms_p50=ct.pct(ticks, 50), tick_ms_max=max(ticks), ticks=len(ticks),
                        scale=stall, greedy_share=share, greedy_gap_ulps=gap, delta=delta)
        for rid in list(built):
            if rid not in router.replica_ids():
                built.pop(rid)  # drained and closed by scale_down
        gc.collect()
        torch.cuda.empty_cache()

        # (c) fail-static under load: the observe path blinded, then not
        ctl = SLOController(router, ControllerConfig(
            ttft_slo_s=None, target_queue_fraction=0.05, knob_cooldown_s=0.0, scale_cooldown_s=0.0,
            min_replicas=2, max_replicas=2, stale_after_s=30.0, replace_on_drift=False),
            watch=fleet_watch)
        ctl.tick()
        futs = [router.submit(p, max_new_tokens=SPEC_NEW_TOKENS, **ct.request_kwargs(g, i))
                for i, (p, g) in enumerate(zip(prompts, greedy))]
        wait_until(lambda: any(s.health()["queue_depth"] for s in router.servers().values()), 30)
        acts = ctl.metrics["actuations"]
        os.environ[FAULT_INJECT_ENV] = "controller_observe:raise"
        try:
            for _ in range(5):
                ctl.tick()
            frozen, findings = ctl.frozen, ctl.stale_findings()
            frozen_acts = ctl.metrics["actuations"] - acts
        finally:
            os.environ.pop(FAULT_INJECT_ENV, None)
        ctl.tick()
        thawed, recoveries = not ctl.frozen, ctl.metrics["recoveries"]
        resumed = ctl.metrics["actuations"] - acts
        outcomes = [f.exception(timeout=300) for f in futs]
        for _ in range(20):  # idle: one rung released a tick
            if not ctl.engaged_rungs():
                break
            ctl.tick()
        ctl.close()
        log(f"phase 19 (c) fail-static: controller_observe:raise armed for 5 ticks under 16 queued "
            f"requests: frozen {frozen}, findings {[type(f).__name__ for f in findings]} "
            f"({findings[0] if findings else None}), actuations while frozen {frozen_acts}; "
            f"disarmed: thawed {thawed}, recoveries {recoveries}, actuations after {resumed}; the "
            f"requests' failures {[type(e).__name__ for e in outcomes if e is not None]}; rungs "
            f"after {ctl.engaged_rungs()} [{card}]")
        if not frozen or len(findings) != 1 or not isinstance(findings[0], ControllerStaleError) \
                or frozen_acts or not thawed or recoveries != 1 or ctl.engaged_rungs() \
                or any(e is not None for e in outcomes):
            raise AssertionError(f"phase 19 (c): frozen {frozen}, findings {findings}, actuations "
                                 f"{frozen_acts}, thawed {thawed}, outcomes {outcomes}")
        out["c"] = dict(findings=len(findings), frozen_actuations=frozen_acts, recoveries=recoveries,
                        actuations_after=resumed)

        # (d) the chaos plan of docs/control_plane.md against the same
        # arrivals without chaos
        ds = CHAOS_SCHEDULE
        sched_d = arrivals.ramp_flash_crowd_drain(
            base_rps=ds["base"] * cap, peak_rps=ds["peak"] * cap, ramp_s=ds["ramp_s"],
            flash_s=ds["flash_s"], drain_s=ds["drain_s"], flash_multiplier=ds["crowd"] / ds["peak"],
            seed=CONTROL_SEED + 1)
        order_d = arrivals.prompt_order(len(sched_d), len(prompts), seed=CONTROL_SEED + 1)
        plain = ct.drive(router, sched_d, prompts, order_d, greedy, new_tokens=SPEC_NEW_TOKENS)
        windows = {name: (t0, t1) for name, t0, t1 in chaos.phase_windows(sched_d.phases)}
        crowd0, crowd1 = windows["flash"]
        plan = chaos.ChaosSchedule(name="gray-failure-storm", seed=4242, rules=(
            chaos.ChaosRule(point="serving_before_batch", action="sleep=0.45",
                            match={"replica": "r0"}, start_s=crowd0, label="straggler"),
            chaos.ChaosRule(point="fleet_probe", action="raise", prob=0.2, start_s=crowd0,
                            end_s=crowd1, label="flaky-probe"),
            chaos.ChaosRule(point="serving_before_batch", action="raise", match={"replica": "r1"},
                            max_fires=1, label="kill"),
        ))
        tracer = tracing.configure(TracingConfig(dump_dir=tmp, ring_capacity=8192))
        mon = chaos.InvariantMonitors(tracer=tracer)
        mon.watch_registry("fleet", router.metrics.registry)
        for rid, srv in router.servers().items():
            mon.watch_registry(rid, srv.metrics.registry)
        with chaos.ChaosConductor(plan) as con:
            stormy = ct.drive(router, sched_d, prompts, order_d, greedy, new_tokens=SPEC_NEW_TOKENS,
                              monitors=mon, on_phase=lambda _: mon.sample())
        submits = [sp for sp in tracer.spans() if sp.name == "fleet.submit"]
        traced = len(submits) == len(stormy["futures"])
        if traced:
            for i, (sp, fut) in enumerate(zip(submits, stormy["futures"])):
                mon.track(f"trace-{i}", fut, trace_id=sp.trace_id)
        violations = mon.check(quiesce_timeout_s=120)
        seq, hits = con.firing_sequence(), con.hit_log()
        replays = [con.replay(hits) == seq, con.replay(hits) == seq]
        goodput = stormy["goodput_rps"] / max(plain["goodput_rps"], 1e-9)
        ttft_x = (stormy["ttft_p99_s"] or 0.0) / max(plain["ttft_p99_s"] or 0.0, 1e-9)
        log(f"phase 19 (d) chaos {plan.name} (seed {plan.seed}) over {len(sched_d)} arrivals "
            f"{sched_d.phase_counts()}: firings {dict(collections.Counter(l for l, _, _ in seq))} of "
            f"{len(hits)} hits, replay equal {replays}; monitors: {len(violations)} violations "
            f"{[str(v) for v in violations[:3]]}, traces verified {traced} ({len(submits)} submit "
            f"spans, {mon.unverified_traces} unverified); goodput {stormy['goodput_rps']:.3f} against "
            f"{plain['goodput_rps']:.3f} req/s without chaos ({goodput:.3f}x; chaos_bench.py gates "
            f"{CHAOS_GATE[0]}x), TTFT p99 {stormy['ttft_p99_s']:.4f}s against "
            f"{plain['ttft_p99_s']:.4f}s ({ttft_x:.3f}x; gate {CHAOS_GATE[1]}x), printed, not held: "
            f"the replicas share one card; failures {stormy['typed']} [{card}]")
        if violations or con.fires("kill") != 1 or not all(replays) or not traced \
                or stormy["dropped"] or stormy["untyped"] or plain["dropped"] or plain["untyped"]:
            raise AssertionError(f"phase 19 (d): violations {violations[:3]}, kills "
                                 f"{con.fires('kill')}, replays {replays}, traced {traced}")
        out["d"] = dict(plain=ct.summary(plain), chaos=ct.summary(stormy), goodput_x=goodput,
                        ttft_p99_x=ttft_x, firings=len(seq), hits=len(hits))

        # (b) drift: r0 slowed at each admission; its perfwatch ratio past its
        # peers' is one brown-out finding naming it, and the controller
        # replaces it. First each replica bills a fresh watch again (its
        # reservoirs held (d)'s windows, the straggler's sleeps among them,
        # and long prompts' chunks that (b) never runs) and sees normal
        # traffic
        for rid, srv in router.servers().items():
            srv.engine._perfwatch = perfwatch.PerfWatch(obs)
        for rid, srv in router.servers().items():
            for f in [srv.submit(p, max_new_tokens=DRIFT_BUDGETS) for p in prompts[:3] * 4]:
                f.result(timeout=300)
        fleet_watch.consume_drift_findings()  # nothing filed before is (b)'s to answer
        router.config.brownout_residual_ratio = FleetConfig().brownout_residual_ratio
        router.config.brownout_drain_after_s = DRIFT_AFTER_S
        time.sleep(5 * CONTROL_FLEET["probe_interval_s"])
        clean = {rid: s["brownout"] for rid, s in router.stats()["replicas"].items()}
        ctl = SLOController(router, ControllerConfig(
            interval_s=0.1, ttft_slo_s=None, escalate_threshold=100.0, relax_threshold=0.0,
            scale_cooldown_s=600.0, min_replicas=1, max_replicas=3, replace_drain_timeout_s=60.0),
            watch=fleet_watch)
        drift = chaos.ChaosSchedule(name="drift", seed=CONTROL_SEED, rules=(
            chaos.ChaosRule(point="serving_before_batch", action=f"sleep={DRIFT_SLEEP_S}",
                            match={"replica": "r0"}, label="drift"),))
        sched_b = arrivals.from_phases(
            [arrivals.Phase("burst", DRIFT_BURST_S, DRIFT_REQUESTS / DRIFT_BURST_S)],
            seed=CONTROL_SEED)
        short = [i for i, g in enumerate(greedy) if g]
        try:
            with chaos.ChaosConductor(drift) as con_b:
                ctl.start()
                run_b = ct.drive(router, sched_b, [prompts[i] for i in short],
                                 arrivals.prompt_order(len(sched_b), len(short), seed=CONTROL_SEED),
                                 [True] * len(short),
                                 new_tokens=lambda k: 1 + k % DRIFT_BUDGETS)
                replaced = wait_until(lambda: ctl.metrics["drift_replacements"] >= 1
                                      and "r0" not in router.replica_ids(), 120)
        finally:
            ctl.close()
        ids = router.replica_ids()
        fresh = [rid for rid in ids if rid not in FLEET_REPLICAS]
        ratios = {rid: {r["program"].rsplit("/", 1)[-1]: None if r["ratio"] is None
                        else round(r["ratio"], 2) for r in built[rid].engine._perfwatch.table()}
                  for rid in FLEET_REPLICAS}
        log(f"phase 19 (b) drift: r0 slowed {DRIFT_SLEEP_S}s an admission ({con_b.fires('drift')} "
            f"firings) under a burst of {len(sched_b)} greedy requests of 1-{DRIFT_BUDGETS} "
            f"tokens; brown-outs before {clean}, after {router.metrics['brownouts']} (measured/"
            f"predicted by program at the end {ratios}); findings filed "
            f"{router.metrics['brownout_findings']}; "
            f"replacements {ctl.metrics['drift_replacements']}, replicas now {ids} (fresh {fresh}, "
            f"built in {scaled.get(fresh[0], {}).get('build_s', 0.0) if fresh else 0.0:.2f}s); "
            f"{run_b['completed']} completed, failures {run_b['typed']}, untyped "
            f"{len(run_b['untyped'])}, dropped {run_b['dropped']} [{card}]")
        if any(clean.values()) or not replaced or ctl.metrics["drift_replacements"] != 1 \
                or len(fresh) != 1 or run_b["dropped"] or run_b["untyped"]:
            raise AssertionError(f"phase 19 (b): clean {clean}, replaced {replaced}, replicas "
                                 f"{ids}, dropped {run_b['dropped']}, untyped {run_b['untyped'][:3]}, "
                                 f"ratios {ratios}")
        out["b"] = dict(ct.summary(run_b), replacements=ctl.metrics["drift_replacements"],
                        replicas=ids, fresh=scaled.get(fresh[0]))
    finally:
        engine_mod._Graph.__init__ = real_graph_init
        os.environ.pop(FAULT_INJECT_ENV, None)
        if router is not None:
            router.close(drain=False)
        tracing.configure(prev_tracing)
        perfwatch.configure(ObservabilityConfig())
        shutil.rmtree(tmp, ignore_errors=True)
        built.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return {"control": a_launches}, out


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
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
        return 2
    Path("chiprun_out").mkdir(exist_ok=True)
    with open("chiprun_out/chip_smoke.log", "w") as log_file:
        LOG_FILE.append(log_file)
        try:
            return run_phases(args)
        finally:
            LOG_FILE.clear()


def run_phases(args) -> int:
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
    summary = {"card": card, "build_s": secs, "phase_seconds": {"1-2": time.perf_counter() - t0}}
    seconds = summary["phase_seconds"]

    @contextlib.contextmanager
    def phase(name):
        start = time.perf_counter()
        yield
        seconds[name] = time.perf_counter() - start

    if not args.kernels:
        with torch.no_grad():
            with phase("3"):
                phase_engine_parity(dev, card)
            with phase("4"):
                model = serving_model(dev, args.layers)
                by_path["serving"], summary["main_path"] = phase_main_path(dev, card, model)
            with phase("7"):
                by_path["serving_spec"], by_path["serving_int8"], summary["spec_path"] = (
                    phase_spec_path(dev, card, model))
            with phase("17"):
                tier_paths, summary["disaggregated"] = phase_disaggregated(dev, card, model)
            by_path.update(tier_paths)
            with phase("18"):
                fleet_paths, summary["fleet"] = phase_fleet(dev, card, model, summary["main_path"])
            by_path.update(fleet_paths)
            with phase("19"):
                control_paths, summary["control"] = phase_control(dev, card, model,
                                                                  summary["fleet"])
            by_path.update(control_paths)
            # phase 12 before 8: phase 8 quantizes the model in place
            with phase("12"):
                by_path["static"], summary["static_path"] = phase_static(dev, card, model)
            with phase("8"):
                by_path["quantized"], summary["quantized_path"] = phase_quantized(dev, card, model)
                del model
                torch.cuda.empty_cache()
                summary["checkpoint"] = phase_checkpoint(dev, card)
        # the tokens phase 15 holds the mesh engine's against (not JSON)
        reference = {"serving": summary["main_path"].pop("tokens"),
                     "steady": summary["main_path"]["steady"],
                     "spec": summary["spec_path"].pop("tokens")}
        torch.cuda.empty_cache()
        with phase("5"):
            by_path["training_f32"], summary["train_parity"] = phase_train_parity(dev, card)
        with phase("6"):
            by_path["training"], summary["train_main_path"] = phase_train_main_path(dev, card)
        with phase("16"):
            fp8_paths, summary["fp8"] = phase_fp8(dev, card, summary["train_main_path"])
        by_path.update(fp8_paths)
        with phase("9"):
            by_path["training_resume"], summary["resume"] = phase_resume(
                card, summary["train_main_path"])
        with phase("10"):
            dp_launches, summary["data_parallel"] = phase_data_parallel(
                card, summary["train_main_path"])
        by_path["training_ddp"], by_path["training_fsdp2"] = dp_launches["ddp"], dp_launches["fsdp"]
        with phase("11"):
            by_path["training_tp"], by_path["training_tp4_threads"], summary["tensor_parallel"] = (
                phase_tensor_parallel(card, summary["train_main_path"]))
        with phase("13"):
            by_path["training_supervised"], summary["supervised"] = phase_supervised(card)
        with torch.no_grad():
            with phase("14"):
                mesh_paths, summary["serving_mesh"] = phase_serving_mesh(dev, card)
            by_path.update(mesh_paths)
            with phase("15"):
                cont_paths, summary["continuous_mesh"] = phase_continuous_mesh(
                    dev, card, args.layers, reference)
            by_path.update(cont_paths)
        log("phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
            + f"; total {sum(seconds.values()):.1f}s [{card}]")
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
