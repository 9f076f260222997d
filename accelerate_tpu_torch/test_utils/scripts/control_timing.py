"""Drives a serving fleet under the SLO controller through a seeded ramp ->
flash crowd -> drain, across four cards:

    python -m accelerate_tpu_torch.test_utils.scripts.control_timing --layers 32

Each card holds its own copy of Llama-3-8B at full width in bf16, weights
drawn from seed 0 on it. The servers are ``chip_smoke.py`` phase 7's
(speculation ``ngram``, 512-token chunked prefill, 8 slots), the traffic
phase 7's kind of mix: drafter-friendly prompts of 64-512 tokens, greedy,
and 1,025-1,500-token prompts, sampled, 64 new tokens each.

First one server on ``cuda:0`` serves the mix's 16 prompts at once: its
tokens/s sets the rates (the ramp climbs from 0.3 to 0.9 of it, the crowd
is ``--crowd`` times it) and its TTFT p99 the SLO. Then two runs of the
same arrivals and a quiet tail:

* **controlled**: one replica on ``cuda:0`` under ``SLOController``
  (``max_replicas`` 4); its ``replica_factory`` builds each new replica
  on the next idle card;
* **static**: four replicas, one a card, the whole time.

For each: replica-seconds (the replica count integrated over the run's
wall window), TTFT p50/p99 by phase and overall against the SLO, tokens/s,
the typed failures (none untyped, no future dropped); for the controlled
run also the rung timeline with its pressure and the controller's tick
ms. Prints one JSON line (also ``chiprun_out/control_timing.json``) with
the card's name and power limit. ``--preset tiny --cpu`` rehearses it with
four replicas on the CPU.

The drive's parts (:class:`FleetMeter`, :func:`drive`,
:func:`ladder_problems`) also serve ``chip_smoke.py`` phase 19.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import threading
import time

import numpy as np
import torch

from accelerate_tpu_torch.controller import _RUNG_ORDER as RUNG_ORDER

NEW_TOKENS = 64
SERVING = dict(mode="continuous", engine_slots=8, engine_max_len=2048, engine_prompt_bucket=512,
               engine_block_size=16, kv_cache="paged", attention_impl="kernel",
               speculative="ngram", spec_draft_len=4, engine_prefill_chunk=512,
               engine_readback_lag=2, max_queue=32)
# chunks a tick: the longctx rung halves 2 to 1 rather than pausing long
# prompts (each paused one holds its slot until the rung is released)
CHUNK_LIMIT = 2
SEED = 20
REPLICAS = 4


def pct(values, p):
    """The ``p``-th percentile of ``values`` (nearest rank), None when empty."""
    if not len(values):
        return None
    s = sorted(values)
    return s[min(len(s) - 1, int(round(p / 100 * (len(s) - 1))))]


def drafter_prompts(rng, n, lo, hi, vocab):
    """``n`` prompts of ``lo``-``hi`` tokens, each a random 8-32-token unit
    tiled: the n-gram drafter's kind of traffic."""
    out = []
    for _ in range(n):
        unit = rng.integers(0, vocab, size=int(rng.integers(8, 33)))
        length = int(rng.integers(lo, hi + 1))
        out.append(np.tile(unit, -(-length // len(unit)))[:length].astype(np.int32))
    return out


def control_mix(vocab, seed=0):
    """12 drafter-friendly prompts and 4 long ones (three 512-token chunks
    each), and whether each is served greedy (the drafter-friendly ones)."""
    rng = np.random.default_rng(seed)
    short = drafter_prompts(rng, 12, 64, 512, vocab)
    long = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
            for n in rng.integers(1025, 1501, size=4)]
    return short + long, [True] * len(short) + [False] * len(long)


def request_kwargs(greedy, seed):
    return dict(temperature=0.0 if greedy else 0.8, top_k=None if greedy else 50,
                top_p=None if greedy else 0.9, seed=seed)


class FleetMeter:
    """Samples a fleet (and its controller) every ``dt`` on a thread: the
    replica count integrated over wall time (``replica_seconds``) and the
    timeline of the controller's engaged rungs and the fleet's replicas,
    one entry a change, each with the pressure gauge."""

    def __init__(self, router, controller=None, dt: float = 0.01):
        self.router, self.controller, self.dt = router, controller, dt
        self.replica_seconds = 0.0
        self.max_replicas = 0
        self.timeline = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="fleet-meter", daemon=True)
        self.t0 = None
        self.window_s = None

    def _state(self):
        rungs = tuple(self.controller.engaged_rungs()) if self.controller is not None else ()
        pressure = (self.controller.metrics["pressure"] if self.controller is not None
                    else None)
        return rungs, tuple(self.router.replica_ids()), pressure

    def _run(self):
        last = time.perf_counter()
        while not self._stop.is_set():
            self._stop.wait(self.dt)
            now = time.perf_counter()
            rungs, replicas, pressure = self._state()
            self.replica_seconds += len(replicas) * (now - last)
            self.max_replicas = max(self.max_replicas, len(replicas))
            last = now
            if not self.timeline or self.timeline[-1][1:3] != (rungs, replicas):
                self.timeline.append((now - self.t0, rungs, replicas, pressure))

    def __enter__(self):
        self.t0 = time.perf_counter()
        rungs, replicas, pressure = self._state()
        self.timeline.append((0.0, rungs, replicas, pressure))
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.window_s = time.perf_counter() - self.t0
        return False


def timed_ticks(controller) -> list:
    """Record the milliseconds of every ``tick()`` the controller's thread
    runs (the thread calls ``self.tick``). Returns the list it fills."""
    ms, real = [], controller.tick

    def tick():
        t0 = time.perf_counter()
        try:
            real()
        finally:
            ms.append((time.perf_counter() - t0) * 1e3)

    controller.tick = tick
    return ms


def drive(router, schedule, prompts, order, greedy, new_tokens=NEW_TOKENS, monitors=None,
          on_phase=None, timeout_s=600.0):
    """Replay ``schedule`` against ``router.submit``: arrival ``k`` sends
    ``prompts[order[k]]`` (greedy or sampled with seed ``k``) for
    ``new_tokens`` tokens (or ``new_tokens(k)``). Waits for
    every future, then sorts the outcomes: results, typed
    (``ServingError``) failures by type, untyped ones and futures still
    unresolved after ``timeout_s`` (dropped). ``monitors``
    (``chaos.InvariantMonitors``) track every future; ``futures`` keeps
    them in submission order (a typed error where ``submit`` raised)."""
    from accelerate_tpu_torch.utils.fault import ServerOverloaded, ServingError

    sent = []
    start = time.perf_counter()

    def submit(phase):
        k = len(sent)
        i = order[k]
        t = time.perf_counter() - start
        try:
            budget = new_tokens(k) if callable(new_tokens) else new_tokens
            fut = router.submit(prompts[i], max_new_tokens=budget, **request_kwargs(greedy[i], k))
        except ServingError as exc:  # the router closed: typed, at once
            sent.append((k, i, phase, t, exc))
            return
        if monitors is not None:
            monitors.track(f"req-{k}", fut)
        sent.append((k, i, phase, t, fut))

    counts = schedule.replay(submit, on_phase=on_phase)
    deadline = time.perf_counter() + timeout_s
    requests, typed, untyped, dropped, hints = [], collections.Counter(), [], 0, []
    end = start
    for k, i, phase, t, fut in sent:
        if isinstance(fut, BaseException):
            outcome = fut
        else:
            try:
                outcome = fut.result(timeout=max(0.0, deadline - time.perf_counter()))
            except TimeoutError:
                dropped += 1
                continue
            except BaseException as exc:  # noqa: BLE001 - sorted below
                outcome = exc
            end = max(end, time.perf_counter())
        if isinstance(outcome, ServingError):
            typed[type(outcome).__name__] += 1
            if isinstance(outcome, ServerOverloaded):
                hints.append(outcome.retry_after_s)
        elif isinstance(outcome, BaseException):
            untyped.append(f"{type(outcome).__name__}: {outcome}")
        requests.append(dict(k=k, prompt=i, phase=phase, t=t, outcome=outcome))
    done = [r for r in requests if not isinstance(r["outcome"], BaseException)]
    wall = max(end - start, schedule.duration_s)
    new = sum(len(r["outcome"].tokens) - len(prompts[r["prompt"]]) for r in done)
    ttft = {ph.name: [r["outcome"].ttft_s for r in done if r["phase"] == ph.name]
            for ph in schedule.phases}
    return dict(
        requests=requests, futures=[fut for *_, fut in sent], offered=counts,
        completed=len(done), typed=dict(typed),
        untyped=untyped, dropped=dropped, retry_after_s=hints, wall_s=wall,
        tokens_per_s=new / wall, goodput_rps=len(done) / schedule.duration_s,
        degraded=sum(bool(r["outcome"].degraded) for r in done),
        ttft_by_phase={name: dict(n=len(v), p50_s=pct(v, 50), p99_s=pct(v, 99))
                       for name, v in ttft.items()},
        ttft_p50_s=pct([r["outcome"].ttft_s for r in done], 50),
        ttft_p99_s=pct([r["outcome"].ttft_s for r in done], 99))


def ladder_problems(timeline, base_replicas, order=RUNG_ORDER):
    """What breaks the ladder's order in a :class:`FleetMeter` timeline:
    the engaged rungs always a prefix of ``order``, a replica beyond the
    ``base_replicas`` only while every rung is engaged, and a rung
    released only once the added replicas are gone. Empty when it held."""
    problems = []
    for t, rungs, replicas, _ in timeline:
        if tuple(order[:len(rungs)]) != rungs:
            problems.append(f"t={t:.3f}: rungs {rungs} are not a prefix of {order}")
        if len(replicas) > base_replicas and rungs != tuple(order):
            problems.append(f"t={t:.3f}: {len(replicas)} replicas with rungs {rungs}")
    return problems


def ladder_events(timeline):
    """The timeline as events: ``(t, "engage"/"release", rung, pressure)``
    and ``(t, "up"/"down", replica, pressure)``."""
    events = []
    for (_, r0, p0, _), (t, r1, p1, pressure) in zip(timeline, timeline[1:]):
        for rung in r1[len(r0):]:
            events.append((round(t, 3), "engage", rung, pressure))
        for rung in reversed(r0[len(r1):]):
            events.append((round(t, 3), "release", rung, pressure))
        for rid in sorted(set(p1) - set(p0)):
            events.append((round(t, 3), "up", rid, pressure))
        for rid in sorted(set(p0) - set(p1)):
            events.append((round(t, 3), "down", rid, pressure))
    return events


def summary(run):
    """A :func:`drive` result without its per-request parts (JSON-ready)."""
    return {k: v for k, v in run.items() if k not in ("requests", "futures")}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="llama3_8b")
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--ramp_s", type=float, default=10.0)
    ap.add_argument("--crowd_s", type=float, default=20.0)
    ap.add_argument("--drain_s", type=float, default=10.0)
    ap.add_argument("--tail_s", type=float, default=10.0)
    ap.add_argument("--crowd", type=float, default=3.0,
                    help="the crowd's rate in multiples of one card's tokens/s")
    args = ap.parse_args()

    from accelerate_tpu_torch.controller import SLOController
    from accelerate_tpu_torch.fleet import FleetRouter
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.test_utils import arrivals
    from accelerate_tpu_torch.test_utils.scripts.train_timing import OUT, card_line
    from accelerate_tpu_torch.utils.dataclasses import ControllerConfig, FleetConfig, ServingConfig

    dtype = torch.float32 if args.cpu else torch.bfloat16
    cfg = getattr(LlamaConfig, args.preset)(num_hidden_layers=args.layers, attention_impl="flash",
                                            param_dtype=dtype, compute_dtype=dtype)
    devices = ([torch.device("cpu")] * REPLICAS if args.cpu
               else [torch.device("cuda", i) for i in range(REPLICAS)])
    card = "cpu" if args.cpu else card_line()
    serving = dict(SERVING, attention_impl="reference" if args.cpu else "kernel")
    out = {"card": card, "layers": args.layers, "replicas_max": REPLICAS}
    with torch.no_grad():
        models = [LlamaForCausalLM.from_seed(cfg, seed=0, device=d) for d in devices]
        prompts, greedy = control_mix(cfg.vocab_size)
        warm = [np.random.default_rng(1).integers(0, cfg.vocab_size, size=n).astype(np.int32)
                for n in (64, 1100)]

        def server(i, rid):
            """A replica on card ``i``, its programs captured before traffic:
            the random prompts alone step through decode_step, then
            drafter-friendly ones until the drafter's first proposal."""
            srv = InferenceServer(models[i], ServingConfig(**serving), replica_id=rid,
                                  device=devices[i])
            srv.engine.set_prefill_chunk_limit(CHUNK_LIMIT)
            for p in warm:
                srv.submit(p, max_new_tokens=8).result(timeout=300)
            for p in [p for p, g in zip(prompts, greedy) if g]:
                if "verify_step" in srv.engine.stats()["programs"]:
                    break
                srv.submit(p, max_new_tokens=NEW_TOKENS).result(timeout=300)
            return srv

        # one card: the rates' and the SLO's measure
        one = server(0, "calibration")
        t0 = time.perf_counter()
        futs = [one.submit(p, max_new_tokens=NEW_TOKENS, **request_kwargs(g, i))
                for i, (p, g) in enumerate(zip(prompts, greedy))]
        res = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        one.close()
        capacity = len(prompts) / wall  # one card's requests/s
        slo = pct([r.ttft_s for r in res], 99)
        out["one_card"] = dict(tokens_per_s=capacity * NEW_TOKENS, ttft_p99_s=slo, wall_s=wall)
        schedule = arrivals.ramp_flash_crowd_drain(
            base_rps=0.3 * capacity, peak_rps=0.9 * capacity, ramp_s=args.ramp_s,
            flash_s=args.crowd_s, drain_s=args.drain_s, flash_multiplier=args.crowd / 0.9,
            seed=SEED)
        order = arrivals.prompt_order(len(schedule), len(prompts), seed=SEED)
        out["schedule"] = dict(arrivals=len(schedule), by_phase=schedule.phase_counts(),
                               duration_s=schedule.duration_s, tail_s=args.tail_s,
                               capacity_rps=capacity, crowd_x=args.crowd)

        # controlled: one replica, the factory takes the next idle card
        idle = collections.deque(range(1, REPLICAS))
        placed = {}

        def factory(rid):
            i = idle.popleft()
            placed[rid] = i
            return server(i, rid)

        router = FleetRouter({"r0": server(0, "r0")},
                             FleetConfig(probe_interval_s=0.1, hedge_deadline_fraction=0.5,
                                         brownout_probe_ewma_s=5.0, hedge_brownout=False),
                             replica_factory=factory)
        ctl = SLOController(router, ControllerConfig(
            interval_s=0.25, ttft_slo_s=slo, knob_cooldown_s=0.25, scale_cooldown_s=1.0,
            actuation_budget_capacity=32, actuation_budget_refill_per_s=4.0, stale_after_s=5.0,
            min_replicas=1, max_replicas=REPLICAS, replace_on_drift=False))
        ticks = timed_ticks(ctl)
        released = []
        real_down = router.scale_down

        def scale_down(rid, timeout=None):
            ok = real_down(rid, timeout=timeout)
            idle.append(placed.pop(rid))  # the card is idle again
            released.append(rid)
            return ok

        router.scale_down = scale_down
        try:
            with FleetMeter(router, ctl) as meter:
                ctl.start()
                run = drive(router, schedule, prompts, order, greedy)
                time.sleep(args.tail_s)  # the relax path hands the cards back
        finally:
            ctl.close()
            router.close(drain=False)
        out["controlled"] = dict(
            summary(run), replica_seconds=meter.replica_seconds, max_replicas=meter.max_replicas,
            window_s=meter.window_s,
            events=ladder_events(meter.timeline), ladder_problems=ladder_problems(meter.timeline, 1),
            tick_ms=dict(n=len(ticks), p50=pct(ticks, 50), max=max(ticks, default=None)),
            escalations=ctl.metrics["escalations"], relaxations=ctl.metrics["relaxations"])

        # static peak: four replicas over the same arrivals and tail
        router = FleetRouter({f"r{i}": server(i, f"r{i}") for i in range(REPLICAS)},
                             FleetConfig(probe_interval_s=0.1, hedge_deadline_fraction=0.5,
                                         brownout_probe_ewma_s=5.0, hedge_brownout=False))
        try:
            with FleetMeter(router) as meter:
                static = drive(router, schedule, prompts, order, greedy)
                time.sleep(args.tail_s)
        finally:
            router.close(drain=False)
        out["static"] = dict(summary(static), replica_seconds=meter.replica_seconds,
                             window_s=meter.window_s)
    ctl_rs, static_rs = out["controlled"]["replica_seconds"], out["static"]["replica_seconds"]
    out["replica_seconds_ratio"] = ctl_rs / static_rs
    out["slo_s"] = slo
    for name in ("controlled", "static"):
        row = out[name]
        if row["untyped"] or row["dropped"]:
            raise AssertionError(f"{name}: untyped {row['untyped'][:3]}, dropped {row['dropped']}")
    os.makedirs(OUT, exist_ok=True)
    line = json.dumps(out)
    with open(os.path.join(OUT, "control_timing.json"), "w") as f:
        f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
