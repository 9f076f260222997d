"""Times static generation of a Llama laid over the launcher's mesh
(tensor parallelism, alone or under FSDP2): Llama-3-8B's widths in bf16,
weights drawn from a seed, ``prepare_inference(mesh=, rules=
tensor_parallel_rules())`` and ``generate`` greedy at B = 8, a 512-token
prompt and 128 new tokens, the decode step one CUDA graph with its NCCL
collectives inside:

    python -m accelerate_tpu_torch.commands.launch --num_processes 4 --tp_size 4 \\
        accelerate_tpu_torch/test_utils/scripts/serve_timing.py --layers 32

Every rank draws the whole seeded model on its card, then keeps its part.
The first ``generate`` captures the step; the second is timed (host clock
around a call that ends in a read of the tokens); then the decode step's
graph is replayed 128 times from the prompt's end (device time by CUDA
events) and 16 more times under ``torch.profiler``, whose NCCL kernels give
rank 0's NCCL device ms a step. A last ``generate`` at half the prompt
makes a second program key: the memory it adds on each rank (its cache
and buffers; the FSDP2 gather buffers are the model's, made once) is
reported beside those buffers' bytes. Rank 0 also draws the unsharded model and
holds the mesh's greedy tokens against it by chip_smoke.py's phase 12
rule: teacher-forced through the plain forward (attention ``"xla"``), the
share of positions whose argmax is the token chosen at least 0.9 and
every other a near-tie of at most 4 bf16 ulps of the largest |logit|; it
also says whether they equal its own ``generate``'s bit for bit. The main
process prints one JSON line (also written under ``chiprun_out/``) with
the card's name and power limit, tokens/s, the decode replay ms, the NCCL
ms a step, every rank's peak memory, the memory a program key adds and the
gather buffers', and the check. ``--preset tiny --cpu``
rehearses it on gloo ranks (eagerly: no graph, no device time).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time

import numpy as np
import torch

from accelerate_tpu_torch.test_utils.scripts.train_timing import OUT, card_line

BATCH, PROMPT, NEW = 8, 512, 128
PROFILE_STEPS = 16
GREEDY_SHARE_MIN, NEAR_TIE_ULPS = 0.9, 4.0


def _agreement(cfg, params, ids, out):
    """(argmax share, largest gap in bf16 ulps of the largest |logit|) of
    ``out``'s new tokens against the plain forward's logits scoring them."""
    from accelerate_tpu_torch.models.llama import llama_apply

    ref = llama_apply(dataclasses.replace(cfg, attention_impl="xla"), params,
                      out[:, :-1].long())[:, ids.shape[1] - 1:]
    chosen = out[:, ids.shape[1]:].long()
    share = (chosen == ref.argmax(-1)).float().mean().item()
    gap = (ref.max(-1).values - ref.gather(-1, chosen[..., None])[..., 0]).max().item()
    ulp = 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7)
    return share, gap / ulp


def main(argv=None) -> dict:
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.inference import generate, prepare_inference
    from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="llama3_8b", choices=["llama3_8b", "tiny"])
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--prompt", type=int, default=PROMPT)
    p.add_argument("--new", type=int, default=NEW)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    acc = Accelerator(cpu=args.cpu)
    cuda = acc.device.type == "cuda"
    dtype = torch.float32 if args.cpu else torch.bfloat16
    cfg = getattr(LlamaConfig, args.preset)(num_hidden_layers=args.layers, attention_impl="flash",
                                            param_dtype=dtype, compute_dtype=dtype)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    rules = tensor_parallel_rules() if acc.parallelism_config.tp_size > 1 else None
    model = prepare_inference(create_llama(cfg, seed=0, device=acc.device), mesh=acc.mesh,
                              rules=rules)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ids = np.random.default_rng(15).integers(0, cfg.vocab_size,
                                             size=(BATCH, args.prompt)).astype(np.int32)
    with torch.no_grad():
        generate(model, ids, args.new)  # captures the decode step
        sync()
        t0 = time.perf_counter()
        out = generate(model, ids, args.new)
        tokens = out.cpu()
        wall = time.perf_counter() - t0
        replay_ms = nccl_ms = None
        prog = next(iter(model._generate_cache.values()))
        if cuda and prog.graph is not None:
            prog.pos.fill_(prog.prompt_len)
            prog.col.zero_()
            sync()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.new):
                prog.graph.replay()
            end.record()
            end.synchronize()
            replay_ms = start.elapsed_time(end) / args.new
            from torch.profiler import ProfilerActivity, profile

            prog.pos.fill_(prog.prompt_len)
            prog.col.zero_()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILE_STEPS):
                    prog.graph.replay()
                sync()
            nccl_us = sum(e.self_device_time_total for e in prof.key_averages()
                          if "nccl" in e.key.lower())
            nccl_ms = nccl_us / 1e3 / PROFILE_STEPS
        peaks = acc.state.gather_object(torch.cuda.max_memory_allocated() if cuda else 0)
        # a second program key: what it keeps resident on each rank
        held = torch.cuda.memory_allocated() if cuda else 0
        generate(model, ids[:, :args.prompt // 2], args.new)
        sync()
        key_bytes = acc.state.gather_object((torch.cuda.memory_allocated() if cuda else 0) - held)
        gather = getattr(model, "_generate_gather", None)
        gather_bytes = acc.state.gather_object(0 if gather is None else sum(
            t.numel() * t.element_size() for pair in gather._buffers.values() for t in pair
            if t is not None))
        nccl = acc.state.gather_object(nccl_ms)
        check = None
        if acc.is_main_process:
            ref_model = create_llama(cfg, seed=0, device=acc.device)
            ref_tokens = generate(ref_model, ids, args.new).cpu()
            share, ulps = _agreement(cfg, ref_model.params, torch.from_numpy(ids).to(acc.device),
                                     out)
            check = dict(argmax_share=share, largest_gap_ulps=ulps,
                         equal_to_unsharded=bool(torch.equal(tokens, ref_tokens)),
                         passed=share >= GREEDY_SHARE_MIN and ulps <= NEAR_TIE_ULPS)
            del ref_model
    pcfg = acc.parallelism_config
    result = dict(
        card=card_line() if cuda else "cpu (rehearsal; no device time)",
        layout=acc.layout, mesh={a: s for a, s in pcfg.axis_sizes.items() if s > 1} or {"world": 1},
        world=acc.num_processes, layers=args.layers, batch=BATCH, prompt=args.prompt,
        new=args.new, graphs=prog.graph is not None, generate_s=wall,
        tokens_per_s=BATCH * args.new / wall, decode_replay_ms=replay_ms,
        nccl_ms_per_step_by_rank=nccl, peak_gb_per_rank=[x / 1e9 for x in peaks],
        second_key_gb_per_rank=[x / 1e9 for x in key_bytes],
        gather_buffers_gb_per_rank=[x / 1e9 for x in gather_bytes], check=check)
    if acc.is_main_process:
        os.makedirs(OUT, exist_ok=True)
        line = json.dumps(result)
        with open(os.path.join(OUT, f"serve_timing_{acc.layout}_{args.layers}l.json"), "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
        if not check["passed"]:
            raise AssertionError(f"the mesh's greedy tokens disagree with the unsharded model: {check}")
    acc.wait_for_everyone()
    return result


if __name__ == "__main__":
    main()
