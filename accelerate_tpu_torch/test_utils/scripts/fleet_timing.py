"""Times a serving fleet across four cards: one continuous
``InferenceServer`` a card (``chip_smoke.py`` phase 4's server), each over
its own copy of Llama-3-8B at full width in bf16, weights drawn from seed 0
on its card, behind one ``FleetRouter`` in this process:

    python -m accelerate_tpu_torch.test_utils.scripts.fleet_timing --layers 32

The mix is phase 4's kind of traffic, ``--requests`` prompts of 64-512
random tokens (default 64: 16 a replica), 64 new tokens each, even requests
greedy, odd ones sampled with their index as seed. First the mix through
one server on ``cuda:0`` (the reference tokens), then through the fleet
(tokens bitwise the reference's; tokens/s, TTFT, each replica's share),
then again with r0's serving worker killed mid-decode through the fault
points (every request finished on the other cards, none in an error, the
moved ones' ``failover_count``, the retry budget spent once a dead slot's
request; the seconds from the kill to the last result). Prints one JSON
line (also written to ``chiprun_out/fleet_timing.json``) with the card's
name and power limit. ``--preset tiny --cpu`` rehearses it with four
replicas on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from accelerate_tpu_torch.test_utils.scripts.serve_timing import MIX_NEW, SERVING, _request_kwargs
from accelerate_tpu_torch.test_utils.scripts.train_timing import OUT, card_line

REPLICAS = 4
KILL_TICK = 24  # r0's worker dies at its 24th engine tick of the mix, mid-decode
# the prober's reads share the host's cores with four engine threads: a
# brown-out is not what this run measures, and its hedges would run
# requests twice
FLEET = dict(brownout_probe_ewma_s=5.0, hedge_brownout=False, retry_budget_refill_per_s=0.0)


def _mix(vocab, n_req):
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, size=n_req)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32) for n in lens]
    return prompts, np.random.default_rng(1).integers(0, vocab, size=64).astype(np.int32)


def _serve(submit, prompts):
    """Submit every prompt at once; (results, errors, seconds to the last
    result, the clock at it)."""
    t0 = time.perf_counter()
    futs = [submit(p, max_new_tokens=MIX_NEW, **_request_kwargs(i)) for i, p in enumerate(prompts)]
    results, errors = [], []
    for f in futs:
        exc = f.exception(timeout=300)
        if exc is None:
            results.append(f.result())
        else:
            errors.append(f"{type(exc).__name__}: {exc}")
    end = time.perf_counter()
    return results, errors, end - t0, end


def _numbers(results, wall, n):
    ttft = sorted(r.ttft_s for r in results)
    return dict(tokens_per_s=n * MIX_NEW / wall, wall_s=wall, ttft_p50_s=ttft[len(ttft) // 2],
                ttft_p99_s=ttft[min(len(ttft) - 1, round(0.99 * (len(ttft) - 1)))])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="llama3_8b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from accelerate_tpu_torch.fleet import FleetRouter
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import FleetConfig, ServingConfig
    from accelerate_tpu_torch.utils.fault import install_conductor, uninstall_conductor

    dtype = torch.float32 if args.cpu else torch.bfloat16
    cfg = getattr(LlamaConfig, args.preset)(num_hidden_layers=args.layers, attention_impl="flash",
                                            param_dtype=dtype, compute_dtype=dtype)
    devices = ([torch.device("cpu")] * REPLICAS if args.cpu
               else [torch.device("cuda", i) for i in range(REPLICAS)])
    card = "cpu" if args.cpu else card_line()
    scfg = ServingConfig(**dict(SERVING, attention_impl="reference" if args.cpu else "kernel"))
    out = {"card": card, "replicas": REPLICAS, "layers": args.layers, "requests": args.requests}
    with torch.no_grad():
        models = [LlamaForCausalLM.from_seed(cfg, seed=0, device=d) for d in devices]
        prompts, warm = _mix(cfg.vocab_size, args.requests)

        def servers():
            made = {f"r{i}": InferenceServer(m, scfg, replica_id=f"r{i}", device=d)
                    for i, (m, d) in enumerate(zip(models, devices))}
            for srv in made.values():  # one after the other: their programs captured first
                srv.submit(warm, max_new_tokens=8).result(timeout=120)
            return made

        with InferenceServer(models[0], scfg, device=devices[0]) as one:
            one.submit(warm, max_new_tokens=8).result(timeout=120)
            ref, errors, wall, _ = _serve(one.submit, prompts)
        if errors:
            raise AssertionError(f"the one-card reference: {errors[:3]}")
        out["one_card"] = _numbers(ref, wall, len(prompts))

        with FleetRouter(servers(), FleetConfig(**FLEET)) as router:
            res, errors, wall, _ = _serve(router.submit, prompts)
        same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(res, ref))
        if errors or same != len(prompts):
            raise AssertionError(f"the fleet: {same}/{len(prompts)} bitwise, errors {errors[:3]}")
        out["fleet"] = dict(_numbers(res, wall, len(prompts)), bitwise=same, share={
            rid: sum(r.replica_id == rid for r in res) for rid in sorted({r.replica_id for r in res})})

        ticks, killed = {"n": 0}, {}

        def conductor(name, context):
            if name == "serving_after_batch" and context.get("replica") == "r0":
                ticks["n"] += 1
                if ticks["n"] == KILL_TICK:
                    killed["t"] = time.perf_counter()
                    raise SystemExit("fleet_timing: r0's serving worker killed")

        fcfg = FleetConfig(**FLEET)
        router = FleetRouter(servers(), fcfg)
        install_conductor(conductor)
        try:
            res, errors, wall, end = _serve(router.submit, prompts)
        finally:
            uninstall_conductor(conductor)
            router.close(drain=False)
        moved = [r for r in res if r.failover_count]
        m = router.metrics
        spent = fcfg.retry_budget_capacity - router._budget.available()
        same = sum(np.array_equal(a.tokens, b.tokens) for a, b in zip(res, ref))
        if errors or not killed or not moved or any(r.replica_id == "r0" for r in moved) \
                or same != len(prompts) or round(spent) != m["failovers"] - m["redistributed"]:
            raise AssertionError(f"the failover: killed {bool(killed)}, moved {len(moved)}, "
                                 f"{same}/{len(prompts)} bitwise, errors {errors[:3]}")
        out["failover"] = dict(_numbers(res, wall, len(prompts)), bitwise=same, moved=len(moved),
                               failovers=m["failovers"], redistributed=m["redistributed"],
                               budget_spent=spent, kill_to_last_s=end - killed["t"], share={
                                   rid: sum(r.replica_id == rid for r in res)
                                   for rid in sorted({r.replica_id for r in res})})
    os.makedirs(OUT, exist_ok=True)
    line = json.dumps(out)
    with open(os.path.join(OUT, "fleet_timing.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
