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
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import statistics
import time

import numpy as np
import torch

from accelerate_tpu_torch.test_utils.scripts.serve_timing import (MIX_NEW, SERVING, _mix,
                                                                 _request_kwargs)
from accelerate_tpu_torch.test_utils.scripts.train_timing import OUT, card_line

CHUNK_BYTES = 1 << 20
ACK_DEADLINE_S = 60.0


def _model(args, device):
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    dtype = torch.float32 if args["cpu"] else torch.bfloat16
    cfg = getattr(LlamaConfig, args["preset"])(num_hidden_layers=args["layers"],
                                               attention_impl="flash", param_dtype=dtype,
                                               compute_dtype=dtype)
    return LlamaForCausalLM.from_seed(cfg, seed=0, device=device)


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

    device = torch.device("cpu") if args["cpu"] else torch.device("cuda", 1)
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
    args = vars(p.parse_args(argv))
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


if __name__ == "__main__":
    main()
