"""Times serving of a Llama laid over the launcher's mesh (tensor
parallelism, alone or under FSDP2), static (``--mode static``, the
default) or continuous (``--mode continuous``, below). Static: Llama-3-8B's widths in bf16,
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

``--mode continuous``: every rank builds ``InferenceServer(model,
ServingConfig(mode="continuous", ...))`` at ``chip_smoke.py`` phase 4's
settings (8 slots, max_len 1024, bucket 512, paged pool of 16-token
blocks, kernel attention); rank 0 serves phase 4's mix (16 random prompts
of 64-512 tokens, 64 new tokens each, even requests greedy, odd ones
sampled with their index as seed) after one warm-up request, twice: the
first run captures the engine's programs with their NCCL collectives, the
second is timed (tokens/s); the other ranks replay its decisions. Then every
rank drives its engine directly, in step: 8 slots filled with 300-token
prompts, 32 decode steps timed by CUDA events (the decode replay ms), 8
more each timed on the host from a synchronised start until ``step()``
and ``poll()`` return (the host's ms a step), 16 under ``torch.profiler``
(the NCCL ms a step). The controller's own cost is the seconds rank 0
spent broadcasting its decisions (admissions, ticks, beats) during the
timed run, over its engine steps. Rank 0 draws the
unsharded model and serves the same requests through a one-process engine:
the greedy requests are held by phase 12's rule against the plain
forward, and the count of requests equal to the one-process engine's bit
for bit is reported.

``--preset mixtral_8x7b`` (continuous mode, under ``--ep_size``): the MoE
model laid over the launcher's ``ep`` dim (``parallel/ep.py``), each rank
holding ``8 / ep`` experts a layer. At 32 layers it is 93.4 GB in bf16,
more than one card holds, so no rank draws it whole: it is built empty and
each leaf's layer drawn on the card from a generator seeded by the leaf
and the layer (the same values on every rank), of which the rank keeps its
experts. Nor can one card hold the unsharded reference: every rank
teacher-forces the greedy requests through the laid model's plain forward
together (``llama_apply`` with the model's ``ep``), held by phase 21's
bf16 MoE rule (the share at least ``MOE_SHARE_MIN``, the gap reported).
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
# a bf16 MoE's rule (chip_smoke.py MOE_BF16_SHARE_MIN): a token whose router
# logits sit within bf16's rounding of a tie takes other experts on the
# plain forward, so its share is held at a floor and its gap reported
MOE_SHARE_MIN = 0.75
# continuous mode: chip_smoke.py phase 4's server and mix
SERVING = dict(mode="continuous", engine_slots=8, engine_max_len=1024, engine_prompt_bucket=512,
               engine_block_size=16, kv_cache="paged", attention_impl="kernel",
               engine_readback_lag=2)
MIX_NEW = 64


def _mix(vocab, n_req=16):
    """Phase 4's prompts (64-512 random tokens) and its warm-up prompt."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=n_req)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]
    return prompts, np.random.default_rng(1).integers(0, vocab, size=64).astype(np.int32)


def _request_kwargs(i):
    sampled = i % 2 == 1
    return dict(temperature=0.8 if sampled else 0.0, top_k=50 if sampled else None,
                top_p=0.9 if sampled else None, seed=i)


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
    p.add_argument("--preset", default="llama3_8b", choices=["llama3_8b", "mixtral_8x7b", "tiny"])
    p.add_argument("--num_experts", type=int, default=None,
                   help="the preset's MoE experts (e.g. 4 with --preset tiny to rehearse --ep_size)")
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--prompt", type=int, default=PROMPT)
    p.add_argument("--new", type=int, default=NEW)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--mode", default="static", choices=["static", "continuous"])
    p.add_argument("--requests", type=int, default=16, help="continuous: requests of the mix")
    args = p.parse_args(argv)

    acc = Accelerator(cpu=args.cpu)
    cuda = acc.device.type == "cuda"
    dtype = torch.float32 if args.cpu else torch.bfloat16
    # dropless, as the Mixtral preset: the teacher-forced full forward
    # routes a whole sequence at once, decode one position a slot
    experts = {} if args.num_experts is None else {
        "num_experts": args.num_experts, "expert_capacity_factor": float(args.num_experts)}
    cfg = getattr(LlamaConfig, args.preset)(num_hidden_layers=args.layers, attention_impl="flash",
                                            param_dtype=dtype, compute_dtype=dtype, **experts)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cfg.num_experts > 1:
        if args.mode != "continuous" or acc.parallelism_config.ep_size < 2:
            raise ValueError("--preset mixtral_8x7b runs --mode continuous under --ep_size")
        model = _expert_parallel_model(cfg, acc)
    else:
        rules = tensor_parallel_rules() if acc.parallelism_config.tp_size > 1 else None
        model = prepare_inference(create_llama(cfg, seed=0, device=acc.device), mesh=acc.mesh,
                                  rules=rules)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if args.mode == "continuous":
        return _continuous(args, acc, cfg, model, cuda, sync)
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


def _expert_parallel_model(cfg, acc):
    """The MoE model laid over the mesh's ``ep`` dim without drawing it
    whole: built empty, each leaf's layer drawn on this card from a
    generator seeded by the leaf and the layer (norms at one, a projection
    ``normal / sqrt(in)``, the embedding ``normal * 0.02``), the rank's
    experts kept."""
    import zlib

    from accelerate_tpu_torch.big_modeling import init_empty_weights
    from accelerate_tpu_torch.models.llama import create_llama
    from accelerate_tpu_torch.parallel.ep import apply_expert_parallel, expert_parallel_rules
    from accelerate_tpu_torch.parallel.mesh import sub_mesh

    with init_empty_weights():
        model = create_llama(cfg)
    shapes = {key: tuple(getattr(model, name).shape) for key, name in model.checkpoint_keys()}
    model.unstack_layers()

    def source(key, layer):
        shape = shapes[key] if layer is None else shapes[key][1:]
        if key.endswith("norm.scale"):
            return torch.ones(shape, dtype=cfg.param_dtype, device=acc.device)
        gen = torch.Generator(device=acc.device)
        gen.manual_seed(zlib.crc32(f"{key}/{layer}".encode()))
        scale = 0.02 if key.startswith("embed_tokens") else shape[-2] ** -0.5
        return (torch.randn(shape, generator=gen, device=acc.device) * scale).to(cfg.param_dtype)

    apply_expert_parallel(model, sub_mesh(acc.mesh, "ep"), expert_parallel_rules(), defaults=False,
                          source=source)
    return model


def _engine_agreement(cfg, params, prompts, tokens, ep=None):
    """Phase 12's rule over ``prompts``' greedy outputs: (argmax share
    pooled over them, the largest gap in bf16 ulps of a request's largest
    |logit|), each teacher-forced through the plain forward (over ``ep``:
    this rank's experts, every rank of it together)."""
    from accelerate_tpu_torch.models.llama import llama_apply

    plain = dataclasses.replace(cfg, attention_impl="xla")
    agree = total = 0
    worst = 0.0
    for prompt, toks in zip(prompts, tokens):
        emb = params["embed_tokens"]["embedding"]
        dev = (emb.to_local() if hasattr(emb, "to_local") else emb).device
        new = torch.as_tensor(np.asarray(toks[len(prompt):]), device=dev).long()
        seq = torch.cat([torch.from_numpy(prompt).to(dev).long(), new[:-1]])[None]
        ref = llama_apply(plain, params, seq, ep=ep)[0, len(prompt) - 1:]
        agree += int((ref.argmax(-1) == new).sum())
        total += len(new)
        gap = (ref.max(-1).values - ref.gather(-1, new[:, None])[:, 0]).max().item()
        worst = max(worst, gap / 2.0 ** (math.floor(math.log2(ref.abs().max().item())) - 7))
    return agree / total, worst


def _continuous(args, acc, cfg, model, cuda, sync) -> dict:
    """``--mode continuous`` (the module docstring)."""
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.models.llama import create_llama
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    scfg = ServingConfig(**SERVING)
    prompts, warm = _mix(cfg.vocab_size, args.requests)
    new = args.new if args.new != NEW else MIX_NEW
    srv = InferenceServer(model, scfg, device=acc.device)
    wall = steps = messages = send_s = None
    if acc.is_main_process:
        srv.submit(warm, max_new_tokens=8).result(timeout=900)
        runs = []
        for _ in range(2):  # the first captures the programs, the second is timed
            before = srv.stats()
            sync()
            t0 = time.perf_counter()
            futs = [srv.submit(p, max_new_tokens=new, **_request_kwargs(i))
                    for i, p in enumerate(prompts)]
            results = [f.result(timeout=900) for f in futs]
            runs.append(time.perf_counter() - t0)
            after = srv.stats()
        wall = runs[-1]
        steps = after["steps"] - before["steps"]
        messages = after["mesh"]["messages"] - before["mesh"]["messages"]
        send_s = after["mesh"]["seconds"] - before["mesh"]["seconds"]
        tokens = [r.tokens for r in results]
        ttft = sorted(r.ttft_s for r in results)
        engine_stats = srv.engine.stats()
    srv.close()
    eng = srv.engine
    programs = eng.stats()["programs"]
    graphs = sorted(f"{k}" for k in eng.graph_launches())
    # every rank drives its engine in step: the same calls in the same order
    replay_ms = host_ms = nccl_ms = None
    with torch.no_grad():
        eng.reset()
        for p in prompts[:8]:
            eng.insert(p[:300], max_new_tokens=200)
        for _ in range(4):
            eng.step()
            eng.poll()
        sync()
        if cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        for _ in range(32):
            eng.step()
            eng.poll()
        if cuda:
            end.record()
            end.synchronize()
            replay_ms = start.elapsed_time(end) / 32
        host = []
        for _ in range(8):
            sync()
            t0 = time.perf_counter()
            eng.step()
            eng.poll()
            host.append((time.perf_counter() - t0) * 1e3)
        host_ms = sorted(host)[len(host) // 2]
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILE_STEPS):
                    eng.step()
                    eng.poll()
                sync()
            nccl_ms = sum(e.self_device_time_total for e in prof.key_averages()
                          if "nccl" in e.key.lower()) / 1e3 / PROFILE_STEPS
        eng.reset()
    pool_bytes = eng.stats()["kv"]["hbm_bytes"]
    peaks = acc.state.gather_object(torch.cuda.max_memory_allocated() if cuda else 0)
    nccl = acc.state.gather_object(nccl_ms)
    replay = acc.state.gather_object(replay_ms)
    hosts = acc.state.gather_object(host_ms)
    check = None
    if cfg.num_experts > 1:  # every rank teacher-forces rank 0's tokens on the laid model
        import torch.distributed as dist

        shared = [tokens if acc.is_main_process else None]
        dist.broadcast_object_list(shared, src=0)
        greedy = [i for i in range(len(prompts)) if i % 2 == 0]
        with torch.no_grad():
            share, ulps = _engine_agreement(cfg, model._tree(detach=False),
                                            [prompts[i] for i in greedy],
                                            [shared[0][i] for i in greedy], ep=model.ep)
        check = dict(argmax_share=share, largest_gap_ulps=ulps, requests=len(prompts),
                     passed=share >= MOE_SHARE_MIN)
    elif acc.is_main_process:
        with torch.no_grad():
            ref_model = create_llama(cfg, seed=0, device=acc.device)
            ref = ContinuousBatchingEngine(
                ref_model, slots=scfg.engine_slots, max_len=scfg.engine_max_len,
                prompt_bucket=scfg.engine_prompt_bucket, kv_cache=scfg.kv_cache,
                block_size=scfg.engine_block_size, attention_impl=scfg.attention_impl,
                readback_lag=scfg.engine_readback_lag, device=acc.device)
            occs = []
            for i, p in enumerate(prompts):
                while not ref.free_slots():
                    ref.step()
                    ref.poll()
                occs.append(ref.insert(p, max_new_tokens=new, **_request_kwargs(i)))
            ref.drain()
            greedy = [i for i in range(len(prompts)) if i % 2 == 0]
            share, ulps = _engine_agreement(cfg, ref_model.params, [prompts[i] for i in greedy],
                                            [tokens[i] for i in greedy])
            equal = sum(np.array_equal(t, o.output_row()) for t, o in zip(tokens, occs))
            check = dict(argmax_share=share, largest_gap_ulps=ulps, equal_to_unsharded=equal,
                         requests=len(prompts),
                         passed=share >= GREEDY_SHARE_MIN and ulps <= NEAR_TIE_ULPS)
            del ref, ref_model
    pcfg = acc.parallelism_config
    result = dict(
        card=card_line() if cuda else "cpu (rehearsal; no device time)", mode="continuous",
        layout=acc.layout, mesh={a: s for a, s in pcfg.axis_sizes.items() if s > 1} or {"world": 1},
        world=acc.num_processes, layers=args.layers, requests=len(prompts), new=new,
        programs=programs, graphs=graphs, serve_s=wall,
        tokens_per_s=len(prompts) * new / wall if wall else None,
        ttft_p50_s=ttft[len(ttft) // 2] if wall else None, ttft_max_s=ttft[-1] if wall else None,
        engine=None if not acc.is_main_process else dict(
            steps=engine_stats["steps"], inserted=engine_stats["inserted"]),
        timed_steps=steps, messages=messages,
        broadcast_ms_per_step=(send_s / steps * 1e3) if steps else None,
        decode_replay_ms_by_rank=replay, host_ms_per_step_by_rank=hosts,
        nccl_ms_per_step_by_rank=nccl, peak_gb_per_rank=[x / 1e9 for x in peaks],
        pool_gb_per_rank=pool_bytes / 1e9, check=check)
    if acc.is_main_process:
        os.makedirs(OUT, exist_ok=True)
        line = json.dumps(result)
        with open(os.path.join(OUT, f"serve_timing_continuous_{acc.layout}_{args.layers}l.json"),
                  "w") as f:
            f.write(line + "\n")
        print(line, flush=True)
        if not check["passed"]:
            raise AssertionError(f"the mesh's greedy tokens disagree with the plain forward: {check}")
    acc.wait_for_everyone()
    return result


if __name__ == "__main__":
    main()
