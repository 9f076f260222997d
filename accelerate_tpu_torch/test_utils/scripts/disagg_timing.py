"""Times disaggregated prefill across two cards: a prefill process on
``cuda:1`` runs each request's prompt forward (``prefill_remote``) and
ships it over ``TCPTransport`` (``kvtransfer.py``, loopback) to a
continuous ``InferenceServer`` on ``cuda:0``, which commits it
(``submit(prefilled=)``) and decodes. The model and mix are
``chip_smoke.py`` phase 4's: Llama-3-8B at full width in bf16, weights
drawn from seed 0 on each card, 16 prompts of 64-512 random tokens, 64 new
tokens each, even requests greedy, odd ones sampled with their index as
seed:

    python -m accelerate_tpu_torch.test_utils.scripts.disagg_timing --layers 32

The main process is the decode side. It first serves the mix with plain
inserts: the one-card reference, and the run that captures the engine's
programs. Then it starts the prefill process (spawn) and hands it the
receiver's endpoint through a pipe; all requests arrive at once, the
prefill side ships each as soon as its forward has run and sends back
(request, transfer id, ship ms, payload bytes without the meta), and the
decode side takes
each committed prefill and submits it. Every request's tokens must equal
the reference's bit for bit. Prints one JSON line (also written to
``chiprun_out/disagg_timing.json``) with the card's name and power limit,
tokens/s and TTFT (from the mix's start) of both runs, and the ship ms
and GB/s. ``--preset tiny --cpu`` rehearses it on the CPU.

``--tp 2`` serves over tensor parallelism instead, under the launcher
(two processes, cards 0 and 1), with the prefill process on card 2:

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 --tp_size 2 \
        accelerate_tpu_torch/test_utils/scripts/disagg_timing.py --tp 2 --layers 32

Every rank builds the continuous server over the model laid out by
``prepare_inference(mesh=, rules=tensor_parallel_rules())``; rank 0 serves
the mix with local prefills (the reference), then with each prompt forward
run by the one-card prefill process and shipped to it, which commits each
on every rank (the ``"insert_prefilled"`` decision, the window broadcast
from rank 0). One-card and TP 2 prefills round differently, so the
shipped run's greedy requests are held by ``chip_smoke.py`` phase 12's
rule against the plain forward of the unsharded model (teacher-forced:
the argmax share at least 0.9, every other position a near-tie of at most
4 bf16 ulps), and the requests equal to the local-prefill run bit for bit
are counted. Then phase 17 (a)'s tier traffic on a server with a host
tier: P cold, P evicted by two long prompts, P again (restored over the
mesh): P's restored tokens must be its cold run's bit for bit. Writes
``chiprun_out/disagg_tp_timing.json`` with the card's name and power
limit, tokens/s, TTFT, the ms a ship, the window broadcast's ms (CUDA
events on rank 0 around each commit's broadcast) and the restore's ms.
``--preset tiny --cpu`` rehearses it on gloo ranks
(``launch --cpu --num_processes 2 --tp_size 2``).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import statistics
import sys
import time

import numpy as np
import torch

from accelerate_tpu_torch.test_utils.scripts.serve_timing import (MIX_NEW, SERVING, _mix,
                                                                 _request_kwargs)
from accelerate_tpu_torch.test_utils.scripts.train_timing import OUT, card_line

CHUNK_BYTES = 1 << 20
ACK_DEADLINE_S = 60.0


def _model_config(args, dtype):
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return getattr(LlamaConfig, args["preset"])(num_hidden_layers=args["layers"],
                                                attention_impl="flash", param_dtype=dtype,
                                                compute_dtype=dtype)


def _model(args, device):
    from accelerate_tpu_torch.models.llama import LlamaForCausalLM

    dtype = torch.float32 if args["cpu"] else torch.bfloat16
    return LlamaForCausalLM.from_seed(_model_config(args, dtype), seed=0, device=device)


def _prefill_side(conn, endpoint, args) -> None:
    """The prefill process: one engine of the decode engine's shape on its
    card; ships each request's prefill to ``endpoint`` once told to go."""
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.kvtransfer import KVTransferManager

    class Sender(KVTransferManager):
        """Ships to the decode process's listener (its endpoint came over
        the pipe: there is no receiver of its own in this process)."""

        def _endpoint_for(self, replica_id):
            return endpoint

    device = torch.device("cpu") if args["cpu"] else torch.device("cuda", args["prefill_card"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(4)
    with torch.no_grad():
        model = _model(args, device)
        eng = ContinuousBatchingEngine(model, slots=1, max_len=SERVING["engine_max_len"],
                                       prompt_bucket=SERVING["engine_prompt_bucket"],
                                       kv_cache="paged", block_size=SERVING["engine_block_size"],
                                       attention_impl="kernel", device=device)
        prompts, warm = _mix(model.config.vocab_size, args["requests"])
        eng.prefill_remote(warm, max_new_tokens=8)  # builds and warms the forward
        mgr = Sender(transport="tcp", chunk_bytes=CHUNK_BYTES, chunk_deadline_s=ACK_DEADLINE_S)
        conn.send("ready")
        conn.recv()  # go
        for i, p in enumerate(prompts):
            pre = eng.prefill_remote(p, max_new_tokens=MIX_NEW, **_request_kwargs(i))
            if pre.event is not None:
                pre.event.synchronize()
            t0 = time.perf_counter()
            tid = mgr.ship(pre, "decode", trace_id=f"disagg-{i}")
            nbytes = (sum(t.numel() * t.element_size() for t in (*pre.cache.values(), pre.t0,
                                                                   pre.next_key)) + pre.prompt.nbytes)
            conn.send((i, tid, (time.perf_counter() - t0) * 1e3, nbytes))
        mgr.close()
    conn.send(None)


def _serve(srv, prompts, submit):
    """All of ``prompts`` arrive at once; ``submit(i, t0)`` returns (the
    seconds after t0 the request was submitted, its future)."""
    t0 = time.perf_counter()
    subs = [submit(i, t0) for i in range(len(prompts))]
    results = [f.result(timeout=900) for _, f in subs]
    wall = time.perf_counter() - t0
    ttft = sorted(s + r.ttft_s for (s, _), r in zip(subs, results))
    return results, dict(tokens_per_s=len(prompts) * MIX_NEW / wall, wall_s=wall,
                         ttft_p50_s=ttft[len(ttft) // 2], ttft_min_s=ttft[0], ttft_max_s=ttft[-1])


def main(argv=None) -> dict:
    from accelerate_tpu_torch.kvtransfer import KVTransferManager
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--preset", default="llama3_8b", choices=["llama3_8b", "tiny"])
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--tp", type=int, default=1,
                   help="serve over tensor parallelism of this size (under the launcher)")
    args = vars(p.parse_args(argv))
    if args["tp"] > 1:
        return _tp_main(args)
    args["prefill_card"] = 1
    device = torch.device("cpu") if args["cpu"] else torch.device("cuda", 0)
    if device.type == "cuda":
        if torch.cuda.device_count() < 2:
            raise RuntimeError("disagg_timing.py needs two cards (prefill on cuda:1, decode on cuda:0)")
        torch.cuda.set_device(device)
    card = card_line()
    scfg = ServingConfig(**SERVING)
    ctx = mp.get_context("spawn")
    with torch.no_grad():
        model = _model(args, device)
        prompts, warm = _mix(model.config.vocab_size, args["requests"])
        srv = InferenceServer(model, scfg, device=device)
        mgr = KVTransferManager(transport="tcp", chunk_bytes=CHUNK_BYTES,
                                chunk_deadline_s=ACK_DEADLINE_S)
        child = None
        try:
            srv.submit(warm, max_new_tokens=8).result(timeout=300)

            def plain(i, t0):
                return (time.perf_counter() - t0,
                        srv.submit(prompts[i], max_new_tokens=MIX_NEW, **_request_kwargs(i)))

            reference, plain_numbers = _serve(srv, prompts, plain)
            mgr.register("decode", srv)
            parent, child_end = ctx.Pipe()
            child = ctx.Process(target=_prefill_side,
                                args=(child_end, mgr._endpoint_for("decode"), args))
            child.start()
            if parent.recv() != "ready":
                raise RuntimeError("the prefill process did not start")
            ships = []

            def shipped(i, t0):
                if i == 0:
                    parent.send("go")
                msg = parent.recv()
                if msg is None:
                    raise RuntimeError("the prefill process ended early")
                j, tid, ship_ms, nbytes = msg
                ships.append((ship_ms, nbytes))
                pre = mgr.take("decode", tid)
                return (time.perf_counter() - t0,
                        srv.submit(prompts[j], max_new_tokens=MIX_NEW, prefilled=pre,
                                   **_request_kwargs(j)))

            results, disagg_numbers = _serve(srv, prompts, shipped)
            if parent.recv() is not None:
                raise RuntimeError("the prefill process sent more than the mix")
            child.join(timeout=120)
            fallbacks = srv.metrics["prefill_commit_fallbacks"]
            programs = srv.engine.stats()["programs"]
        finally:
            mgr.close()
            srv.close()
            if child is not None and child.is_alive():
                child.kill()
                child.join(timeout=30)
    equal = [bool(np.array_equal(a.tokens, b.tokens)) for a, b in zip(reference, results)]
    bytes_each = statistics.median(n for _, n in ships)
    ship_ms = [s for s, _ in ships]
    summary = {
        "card": card, "layers": args["layers"], "requests": len(prompts),
        "tokens_bitwise_one_card": all(equal), "requests_equal": sum(equal),
        "fallbacks": fallbacks, "programs": programs,
        "plain": plain_numbers, "disaggregated": disagg_numbers,
        "ship_ms": ship_ms, "ship_ms_median": statistics.median(ship_ms),
        "payload_bytes": bytes_each,
        "ship_gb_s": bytes_each / statistics.median(ship_ms) / 1e6,
        "prefill_device": "cpu" if args["cpu"] else "cuda:1",
        "decode_device": str(device),
    }
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "disagg_timing.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    if not (all(equal) and fallbacks == 0):
        raise SystemExit("disaggregated tokens differ from the one-card run's (or a prefill fell back)")
    return summary


# phase 17 (a)'s tier traffic (chip_smoke.py): P, and two prompts that evict it
TIER_SERVING = dict(mode="continuous", engine_slots=4, engine_max_len=2048,
                    engine_prompt_bucket=512, engine_block_size=16, engine_prefill_chunk=512,
                    engine_pool_blocks=195, kv_cache="paged", attention_impl="kernel",
                    engine_readback_lag=2, kv_host_tier_bytes=1 << 30)
TIER_PROMPT, TIER_NEW = 1536, 16


def _tier_prompts(vocab):
    rng = np.random.default_rng(17)
    return [rng.integers(0, vocab, size=TIER_PROMPT).astype(np.int32) for _ in range(3)]


def _events(eng, cuda):
    """CUDA events around each commit's window broadcast and each restore
    (its plan to its scatter) of ``eng``: wrappers on the instance. Returns
    {"share": [(start, end)], "restore": [(start, end)]}."""
    marks = {"share": [], "restore": [], "plan": None}

    def event():
        if not cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    share, plan, restore = eng._share_window, eng._backend.restore_plan, eng._dispatch_restore

    def timed_share(pre):
        start = event()
        out = share(pre)
        marks["share"].append((start, event()))
        return out

    def timed_plan(*a, **k):
        marks["plan"] = event()
        return plan(*a, **k)

    def timed_restore(*a, **k):
        restore(*a, **k)
        marks["restore"].append((marks["plan"], event()))

    eng._share_window, eng._backend.restore_plan = timed_share, timed_plan
    eng._dispatch_restore = timed_restore
    return marks


def _ms(pairs, cuda):
    if cuda:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in pairs]
    return [(b - a) * 1e3 for a, b in pairs]


def _tp_main(args) -> dict:
    """``--tp N`` (the module docstring)."""
    from accelerate_tpu_torch import Accelerator
    from accelerate_tpu_torch.inference import prepare_inference
    from accelerate_tpu_torch.kvtransfer import KVTransferManager
    from accelerate_tpu_torch.models.llama import create_llama
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.test_utils.scripts.serve_timing import _engine_agreement
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    acc = Accelerator(cpu=args["cpu"])
    if acc.parallelism_config.tp_size != args["tp"] or acc.num_processes != args["tp"]:
        raise RuntimeError(f"--tp {args['tp']} runs under the launcher with --num_processes "
                           f"{args['tp']} --tp_size {args['tp']}")
    cuda = acc.device.type == "cuda"
    if cuda and torch.cuda.device_count() < args["tp"] + 1:
        raise RuntimeError(f"--tp {args['tp']} needs {args['tp'] + 1} cards (the prefill process "
                           f"on card {args['tp']})")
    args["prefill_card"] = args["tp"]
    card = card_line() if cuda else "cpu (rehearsal; no device time)"
    ctx = mp.get_context("spawn")
    main_rank = acc.is_main_process
    out = None
    with torch.no_grad():
        dtype = torch.float32 if args["cpu"] else torch.bfloat16
        cfg = _model_config(args, dtype)
        model = prepare_inference(create_llama(cfg, seed=0, device=acc.device), mesh=acc.mesh,
                                  rules=tensor_parallel_rules())
        prompts, warm = _mix(cfg.vocab_size, args["requests"])
        srv = InferenceServer(model, ServingConfig(**SERVING), device=acc.device)
        marks = _events(srv.engine, cuda)
        if main_rank:
            mgr = KVTransferManager(transport="tcp", chunk_bytes=CHUNK_BYTES,
                                    chunk_deadline_s=ACK_DEADLINE_S)
            child = None
            try:
                srv.submit(warm, max_new_tokens=8).result(timeout=900)

                def plain(i, t0):
                    return (time.perf_counter() - t0,
                            srv.submit(prompts[i], max_new_tokens=MIX_NEW, **_request_kwargs(i)))

                _serve(srv, prompts, plain)  # captures the programs
                reference, plain_numbers = _serve(srv, prompts, plain)
                mgr.register("decode", srv)
                parent, child_end = ctx.Pipe()
                child = ctx.Process(target=_prefill_side,
                                    args=(child_end, mgr._endpoint_for("decode"), args))
                child.start()
                if parent.recv() != "ready":
                    raise RuntimeError("the prefill process did not start")
                ships = []

                def shipped(i, t0):
                    if i == 0:
                        parent.send("go")
                    msg = parent.recv()
                    if msg is None:
                        raise RuntimeError("the prefill process ended early")
                    j, tid, ship_ms, nbytes = msg
                    ships.append((ship_ms, nbytes))
                    return (time.perf_counter() - t0,
                            srv.submit(prompts[j], max_new_tokens=MIX_NEW,
                                       prefilled=mgr.take("decode", tid), **_request_kwargs(j)))

                del marks["share"][:]
                results, disagg_numbers = _serve(srv, prompts, shipped)
                if parent.recv() is not None:
                    raise RuntimeError("the prefill process sent more than the mix")
                child.join(timeout=120)
                share_ms = _ms(marks["share"], cuda)
                fallbacks = srv.metrics["prefill_commit_fallbacks"]
                programs = srv.engine.stats()["programs"]
            finally:
                mgr.close()
                srv.close()
                if child is not None and child.is_alive():
                    child.kill()
                    child.join(timeout=30)
        else:
            srv.close()
        # phase 17 (a)'s tier traffic on a server with a host tier
        tier = InferenceServer(model, ServingConfig(**TIER_SERVING), device=acc.device)
        tier_marks = _events(tier.engine, cuda)
        if main_rank:
            p, q1, q2 = _tier_prompts(cfg.vocab_size)
            with tier:
                cold = tier.submit(p, max_new_tokens=TIER_NEW).result(timeout=900).tokens
                for f in [tier.submit(q, max_new_tokens=2) for q in (q1, q2)]:
                    f.result(timeout=900)
                again = tier.submit(p, max_new_tokens=TIER_NEW).result(timeout=900).tokens
            restore_ms = _ms(tier_marks["restore"], cuda)
            kv = tier.engine.stats()["kv"]
            tier_numbers = dict(restored_bitwise_cold=bool(np.array_equal(cold, again)),
                                restores=tier.engine.kv_restores, restore_hits=kv["restore_hits"],
                                restore_ms=restore_ms,
                                restore_bytes=kv["restore_bytes"],  # the whole model's
                                restore_bytes_per_rank=kv["restore_bytes"] // args["tp"])
        else:
            tier.close()
        peaks = acc.state.gather_object(torch.cuda.max_memory_allocated() if cuda else 0)
        if main_rank:
            ref_model = create_llama(cfg, seed=0, device=acc.device)
            greedy = [i for i in range(len(prompts)) if i % 2 == 0]
            share, ulps = _engine_agreement(cfg, ref_model.params, [prompts[i] for i in greedy],
                                            [results[i].tokens for i in greedy])
            equal = [bool(np.array_equal(a.tokens, b.tokens)) for a, b in zip(reference, results)]
            bytes_each = statistics.median(n for _, n in ships)
            ship_ms = [s for s, _ in ships]
            out = {
                "card": card, "tp": args["tp"], "layers": args["layers"],
                "requests": len(prompts), "prefill_device": f"cuda:{args['tp']}" if cuda else "cpu",
                "check": dict(argmax_share=share, largest_gap_ulps=ulps, greedy=len(greedy),
                              passed=share >= 0.9 and ulps <= 4.0),
                "requests_bitwise_local_prefill": sum(equal),
                "fallbacks": fallbacks, "programs": programs,
                "plain": plain_numbers, "disaggregated": disagg_numbers,
                "ship_ms": ship_ms, "ship_ms_median": statistics.median(ship_ms),
                "payload_bytes": bytes_each,
                "ship_gb_s": bytes_each / statistics.median(ship_ms) / 1e6,
                "window_broadcast_ms": share_ms,
                "window_broadcast_ms_median": statistics.median(share_ms),
                "tier": tier_numbers, "peak_gb_per_rank": [x / 1e9 for x in peaks],
            }
            os.makedirs(OUT, exist_ok=True)
            with open(os.path.join(OUT, "disagg_tp_timing.json"), "w") as f:
                json.dump(out, f, indent=1)
            print(json.dumps(out), flush=True)
    ok = not main_rank or (out["check"]["passed"] and fallbacks == 0
                           and out["tier"]["restored_bitwise_cold"] and out["tier"]["restores"] == 1)
    if not ok:
        print("TP 2 disaggregation failed its check (phase 12's rule, a fallback, or the restored "
              "tokens)", file=sys.stderr, flush=True)
    # every collective is done (the gather above); the servers' process
    # groups and daemon threads are left to the exit, which on four cards
    # waited past the run's time limit after the summary was written
    sys.stdout.flush()
    os._exit(0 if ok else 1)


if __name__ == "__main__":
    main()
