"""The port's ``FleetRouter`` beside the JAX package's.

Each case is one of the JAX fleet tests (``tests/test_fleet.py``) written
as a scenario over static servers with a fake ``generate_fn``; it runs on
both packages' routers and returns what it observed: which replica served
each request, ``failover_count``, the ``FleetMetrics`` counters and the
typed errors. Where the scenario fixes the order of events (sequential
submits, round-robin placement, a prober that does not run), the two
observations are equal exactly; where host scheduling decides how many
requests a dying replica takes with it, both hold the JAX test's claims
(nothing dropped, typed and retriable, the counters' relations) and those
claims are compared. Last, a fleet of two continuous replicas over one
tiny Llama (2 layers, hidden 64, float32, the JAX model's weights), with
and without disaggregated prefill: greedy tokens bitwise JAX's.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import elastic as jelastic
from accelerate_tpu import fleet as jfleet
from accelerate_tpu import perfwatch as jperf
from accelerate_tpu import serving as jserving
from accelerate_tpu.models.llama import LlamaConfig as JLlamaConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu.utils import fault as jfault
from accelerate_tpu_torch import elastic as telastic
from accelerate_tpu_torch import fleet as tfleet
from accelerate_tpu_torch import perfwatch as tperf
from accelerate_tpu_torch import serving as tserving
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.utils import dataclasses as tdc
from accelerate_tpu_torch.utils import fault as tfault


class Side:
    def __init__(self, name, fleet, serving, dc, fault, elastic, perf):
        self.name, self.fleet, self.serving, self.dc = name, fleet, serving, dc
        self.fault, self.elastic, self.perf = fault, elastic, perf

    def server(self, gen, replica_id=None, model=None, **cfg_kw):
        cfg_kw.setdefault("max_queue", 128)
        cfg_kw.setdefault("max_batch_size", 4)
        cfg_kw.setdefault("batch_window_s", 0.001)
        cfg_kw.setdefault("max_retries", 0)
        kw = {"device": "cpu"} if self.name == "torch" else {}
        return self.serving.InferenceServer(object() if model is None else model,
                                            self.dc.ServingConfig(**cfg_kw), generate_fn=gen,
                                            replica_id=replica_id, **kw)

    def fleet_of(self, n=3, gen=None, fleet_kw=None, server_kw=None, **router_kw):
        gens = gen if isinstance(gen, (list, tuple)) else [gen or echo_gen()] * n
        servers = {f"r{i}": self.server(gens[i], replica_id=f"r{i}", **(server_kw or {}))
                   for i in range(n)}
        cfg = self.dc.FleetConfig(**{"probe_interval_s": 5.0, **(fleet_kw or {})})
        return self.fleet.FleetRouter(servers, cfg, **router_kw)


SIDES = {"jax": Side("jax", jfleet, jserving, jdc, jfault, jelastic, jperf),
         "torch": Side("torch", tfleet, tserving, tdc, tfault, telastic, tperf)}


@pytest.fixture(scope="module", autouse=True)
def _port_dumps_to_tmp(tmp_path_factory):
    """The port's flight dumps (worker deaths) land in a temporary
    directory, as the suite's conftest sends the JAX package's."""
    from accelerate_tpu_torch import tracing

    prev = tracing.get_tracer().config
    tracing.configure(tdc.TracingConfig(dump_dir=str(tmp_path_factory.mktemp("port_dumps"))))
    yield
    tracing.configure(prev)


def _side_by_side(scenario):
    seen = {name: scenario(SIDES[name]) for name in ("jax", "torch")}
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def echo_gen(delay=0.0):
    def fn(model, ids, max_new_tokens=8, **kw):
        if delay:
            time.sleep(delay)
        return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)

    return fn


def killable_gen(kill_event, delay=0.0):
    """Dies with SystemExit (the serving thread ends mid-batch) while
    ``kill_event`` is set; serves otherwise."""

    def fn(model, ids, max_new_tokens=8, **kw):
        if kill_event.is_set():
            kill_event.clear()
            raise SystemExit(1)
        if delay:
            time.sleep(delay)
        return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)

    return fn


def gated_gen(gate):
    def fn(model, ids, max_new_tokens=8, **kw):
        gate.wait(timeout=10)
        return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)

    return fn


def wait_until(predicate, timeout=10.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _counts(router, *names):
    return {n: router.metrics[n] for n in names}


PROMPT = np.arange(1, 6, dtype=np.int32)


# ----------------------------------------------------------------- placement
def test_round_robin_places_each_request_as_jax_does():
    def scenario(side):
        with side.fleet_of(3, fleet_kw={"placement": "round_robin"}) as router:
            res = [router.submit(PROMPT, max_new_tokens=2).result(10) for _ in range(9)]
            return ([(r.replica_id, r.failover_count, r.tokens.tolist()) for r in res],
                    _counts(router, "submitted", "completed", "routed", "failovers"))

    served, counts = _side_by_side(scenario)
    assert [r for r, _, _ in served] == ["r1", "r2", "r0"] * 3
    assert counts == {"submitted": 9, "completed": 9, "routed": 9, "failovers": 0}


HEALTH_GRID = [
    # (queue_depth, inflight, batch_ewma_s) of r0, r1, r2
    ((0, 0, 0.0), (0, 0, 0.0), (0, 0, 0.0)),
    ((3, 1, 0.01), (0, 0, 0.01), (1, 0, 0.01)),
    ((0, 0, 0.5), (2, 2, 0.01), (0, 1, 0.02)),
    ((1, 0, 0.0), (0, 0, 2e-4), (5, 0, 1e-5)),
]


@pytest.mark.parametrize("brownout", [None, "r1"])
@pytest.mark.parametrize("affinity", [False, True])
def test_least_loaded_order_over_health_samples(brownout, affinity):
    """The placement order (``_order``) over synthetic health samples: load
    times the batch-time EWMA, the brown-out penalty, and KV affinity (r2's
    gossiped digest holds the request's first block)."""

    def scenario(side):
        with side.fleet_of(3, fleet_kw={"kv_affinity": affinity}) as router:
            handles = router._handles
            if brownout:
                handles[brownout].brownout = True
            prompt = np.arange(1, 12, dtype=np.int32)
            handles["r2"].prefix_block = 8
            handles["r2"].prefix_digest = router._prefix_crcs(prompt, 8)
            freq = side.fleet._FleetRequest(
                input_ids=prompt, max_new_tokens=2, deadline=None, temperature=0.0, top_k=None,
                top_p=None, eos_token_id=None, pad_token_id=None, seed=0, submitted_at=0.0)
            orders = []
            for sample in HEALTH_GRID:
                cands = [(handles[f"r{i}"], dict(queue_depth=q, inflight=f, batch_ewma_s=e))
                         for i, (q, f, e) in enumerate(sample)]
                orders.append([h.replica_id for h, _ in router._order(cands, freq)])
            return orders

    orders = _side_by_side(scenario)
    # all idle: a tie, broken by affinity (r2) or by the replicas' order
    assert orders[0][0] == ("r2" if affinity else "r0")
    if brownout:
        assert orders[0][-1] == "r1"


def test_a_busy_replica_is_skipped():
    """A replica holding a gated batch and a queue (its health's
    ``queue_depth``) scores above an idle one: the next request goes to
    the idle one."""

    def scenario(side):
        gate = threading.Event()
        router = side.fleet_of(2, gen=[gated_gen(gate), echo_gen()],
                               server_kw={"max_batch_size": 1, "batch_window_s": 0.0})
        try:
            r0 = router.servers()["r0"]
            blocked = [r0.submit(PROMPT, max_new_tokens=2) for _ in range(3)]
            assert wait_until(lambda: r0.queue_depth() == 2)  # one in the gated batch
            fast = router.submit(PROMPT, max_new_tokens=2).result(10).replica_id
            gate.set()
            return fast, [f.result(10).replica_id for f in blocked]
        finally:
            gate.set()
            router.close()

    assert _side_by_side(scenario) == ("r1", ["r0"] * 3)


def test_retry_after_hint_backs_a_replica_out_of_placement():
    def scenario(side):
        with side.fleet_of(2, fleet_kw={"placement": "round_robin"}) as router:
            handle = router._handles["r0"]
            router._note_backoff(handle, side.fault.ServerOverloaded("full", retry_after_s=30.0))
            parked = handle.backoff_until_s > router._clock()
            during = [router.submit(PROMPT, max_new_tokens=2).result(10).replica_id
                      for _ in range(4)]
            handle.backoff_until_s = 0.0
            after = [router.submit(PROMPT, max_new_tokens=2).result(10).replica_id
                     for _ in range(4)]
            router._note_backoff(handle, side.fault.ServerOverloaded("d", retry_after_s=0.0))
            for h in router._handles.values():  # every replica backed off: still served
                router._note_backoff(h, side.fault.ServerOverloaded("full", retry_after_s=30.0))
            last = router.submit(PROMPT, max_new_tokens=2).result(10).replica_id
            return parked, during, after, handle.backoff_until_s > 0, last

    parked, during, after, _, last = _side_by_side(scenario)
    assert parked and during == ["r1"] * 4 and set(after) == {"r0", "r1"} and last in {"r0", "r1"}


def test_admission_edges_are_typed():
    """An empty fleet fails the future with a retriable
    NoHealthyReplicaError; a closed one raises ServerDrainingError; a bad
    prompt raises ValueError; a result names its replica."""

    def scenario(side):
        out = []
        empty = side.fleet.FleetRouter({}, side.dc.FleetConfig(probe_interval_s=5.0))
        try:
            exc = empty.submit(PROMPT).exception(5)
            out.append((type(exc).__name__, exc.retriable, empty.metrics["rejected_no_replica"]))
        finally:
            empty.close()
        router = side.fleet_of(1)
        for bad in (np.zeros((2, 3), np.int32), np.zeros((0,), np.int32)):
            try:
                router.submit(bad)
            except ValueError:
                out.append("ValueError")
        out.append(router.submit(PROMPT, max_new_tokens=2).result(10).replica_id)
        router.close()
        try:
            router.submit(PROMPT)
        except side.fault.ServingError as exc:
            out.append(type(exc).__name__)
        return out

    assert _side_by_side(scenario) == [("NoHealthyReplicaError", True, 1), "ValueError",
                                       "ValueError", "r0", "ServerDrainingError"]


# ------------------------------------------------------------------ failover
def test_replica_death_fails_over_in_order():
    """Round robin, one request at a time: the request that lands on r0
    kills its worker; it fails over (one budget token) to the next replica
    in the rotation, and r0 is never placed again."""

    def scenario(side):
        kill = threading.Event()
        kill.set()
        router = side.fleet_of(3, gen=[killable_gen(kill), echo_gen(), echo_gen()],
                               server_kw={"max_batch_size": 1, "batch_window_s": 0.0},
                               fleet_kw={"placement": "round_robin",
                                         "retry_budget_refill_per_s": 0.0})
        def one():
            r = router.submit(PROMPT, max_new_tokens=2).result(10)
            return r.replica_id, r.failover_count

        try:
            served = [one() for _ in range(3)]
            # the third request killed r0's worker; its thread ends a moment
            # after the request moved, and until it has, r0 still looks
            # alive to a placement
            assert wait_until(lambda: not router.servers()["r0"].health()["worker_alive"])
            served += [one() for _ in range(3)]
            budget = router._budget.available()
            return served, _counts(router, "failovers", "redistributed", "completed", "failed",
                                   "routed"), round(budget)
        finally:
            router.close(drain=False)

    served, counts, budget = _side_by_side(scenario)
    # the rotation reaches r0 with the third request
    assert [f for _, f in served] == [0, 0, 1, 0, 0, 0]
    assert "r0" not in {r for r, _ in served} and counts["failovers"] == 1
    assert budget == 63  # one token of 64, the refill off


def test_replica_death_under_load_drops_nothing():
    def scenario(side):
        kill = threading.Event()
        router = side.fleet_of(3, gen=[killable_gen(kill), echo_gen(0.002), echo_gen(0.002)])
        try:
            futs = [router.submit(PROMPT, max_new_tokens=2) for _ in range(10)]
            kill.set()
            futs += [router.submit(PROMPT, max_new_tokens=2) for _ in range(30)]
            res = [f.result(15) for f in futs]
            moved = [r.failover_count for r in res if r.failover_count]
            return dict(n=len(res), replicas=set(r.replica_id for r in res) <= {"r0", "r1", "r2"},
                        moved=bool(moved), failovers=router.metrics["failovers"] >= 1,
                        consistent=router.metrics["failovers"] >= len(moved),
                        failed=router.metrics["failed"])
        finally:
            router.close(drain=False)

    assert _side_by_side(scenario) == dict(n=40, replicas=True, moved=True, failovers=True,
                                           consistent=True, failed=0)


def test_single_replica_death_ends_typed_and_retriable():
    def scenario(side):
        kill = threading.Event()
        kill.set()
        router = side.fleet_of(1, gen=killable_gen(kill))
        try:
            exc = router.submit(PROMPT, max_new_tokens=2).exception(10)
            return exc.retriable, type(exc).__name__ in (
                "FailoverExhaustedError", "NoHealthyReplicaError", "ReplicaDeadError")
        finally:
            router.close(drain=False)

    assert _side_by_side(scenario) == (True, True)


@pytest.mark.parametrize("capacity", [0, 1, 2])
def test_retry_budget_denies_an_unplanned_failover_storm(capacity):
    """With the budget drained, the dead replica's request ends in
    FailoverExhaustedError chaining the ReplicaDeadError, naming r0."""

    def scenario(side):
        kill = threading.Event()
        router = side.fleet_of(1, gen=killable_gen(kill), fleet_kw={
            "retry_budget_capacity": capacity, "retry_budget_refill_per_s": 0.001})
        try:
            while router._budget.try_acquire():
                pass
            kill.set()
            exc = router.submit(PROMPT, max_new_tokens=2).exception(10)
            return (type(exc).__name__, exc.retriable, type(exc.__cause__).__name__,
                    exc.replica_id, _counts(router, "failover_denied_budget", "failovers",
                                            "failed", "failover_denied_cap"))
        finally:
            router.close(drain=False)

    assert _side_by_side(scenario) == (
        "FailoverExhaustedError", True, "ReplicaDeadError", "r0",
        {"failover_denied_budget": 1, "failovers": 0, "failed": 1, "failover_denied_cap": 0})


def test_failover_cap_is_per_request():
    """``max_failovers=0``: the first retriable failure ends the request
    (denied by the cap, not the budget)."""

    def scenario(side):
        kill = threading.Event()
        kill.set()
        router = side.fleet_of(2, gen=[killable_gen(kill), echo_gen()],
                               fleet_kw={"max_failovers": 0})
        try:
            exc = router.submit(PROMPT, max_new_tokens=2).exception(10)
            return type(exc).__name__, _counts(router, "failover_denied_cap", "failovers")
        finally:
            router.close(drain=False)

    assert _side_by_side(scenario) == ("FailoverExhaustedError",
                                       {"failover_denied_cap": 1, "failovers": 0})


# -------------------------------------------------------- elastic lifecycle
@pytest.mark.parametrize("drained_budget", [False, True], ids=["budget", "empty-budget"])
def test_scale_down_redistributes_queued_work_zero_drop(drained_budget):
    def scenario(side):
        gate = threading.Event()
        router = side.fleet_of(2, gen=[gated_gen(gate), echo_gen(0.002)], fleet_kw={
            "retry_budget_capacity": 1, "retry_budget_refill_per_s": 0.001})
        try:
            if drained_budget:
                while router._budget.try_acquire():
                    pass
            v0 = router.membership.version
            futs = [router.submit(PROMPT, max_new_tokens=2) for _ in range(8)]
            assert wait_until(lambda: router.stats()["replicas"]["r0"]["outstanding"] >= 1)
            gate.set()
            ok = router.scale_down("r0")
            res = [f.result(15) for f in futs]
            return dict(ok=ok, n=len(res), ids=router.replica_ids(),
                        bumped=router.membership.version > v0,
                        gone="r0" not in router.membership.members(),
                        planned=router.metrics["redistributed"] == router.metrics["failovers"],
                        denied=router.metrics["failover_denied_budget"],
                        removed=router.metrics["replicas_removed"])
        finally:
            gate.set()
            router.close()

    assert _side_by_side(scenario) == dict(ok=True, n=8, ids=["r1"], bumped=True, gone=True,
                                           planned=True, denied=0, removed=1)


def test_drain_during_failover_lands_on_a_survivor():
    def scenario(side):
        kill, gate = threading.Event(), threading.Event()
        router = side.fleet_of(3, gen=[killable_gen(kill), gated_gen(gate), echo_gen(0.002)])
        try:
            parked = [router.submit(PROMPT, max_new_tokens=2) for _ in range(4)]
            assert wait_until(lambda: router.stats()["replicas"]["r1"]["outstanding"] >= 1)
            kill.set()
            futs = [router.submit(PROMPT, max_new_tokens=2) for _ in range(12)]

            def drain_r1():
                gate.set()
                router.scale_down("r1")

            threading.Thread(target=drain_r1, daemon=True).start()
            res = [f.result(15) for f in futs + parked]
            return len(res), router.metrics["failed"]
        finally:
            gate.set()
            router.close(drain=False)

    assert _side_by_side(scenario) == (16, 0)


def test_scale_up_registers_and_serves():
    def scenario(side):
        calls = []

        def factory(replica_id):
            calls.append(replica_id)
            return side.server(echo_gen(), replica_id=replica_id)

        with side.fleet_of(1, fleet_kw={"placement": "round_robin"},
                           replica_factory=factory) as router:
            router.scale_up("r9")
            res = [router.submit(PROMPT, max_new_tokens=2).result(10).replica_id
                   for _ in range(4)]
            return (calls, router.replica_ids(), sorted(router.membership.members()), res,
                    router.can_scale, router.metrics["replicas_added"])

    assert _side_by_side(scenario) == (["r9"], ["r0", "r9"], ["r0", "r9"],
                                       ["r9", "r0", "r9", "r0"], True, 2)


def test_probe_detects_death_and_auto_respawns():
    def scenario(side):
        kill = threading.Event()

        def factory(replica_id):
            return side.server(echo_gen(), replica_id=replica_id)

        router = side.fleet_of(1, gen=killable_gen(kill), fleet_kw={
            "auto_respawn": True, "respawn_backoff_s": 0.01, "probe_interval_s": 0.03},
            replica_factory=factory)
        try:
            kill.set()
            first = type(router.submit(PROMPT, max_new_tokens=2).exception(10)).__name__
            assert wait_until(lambda: router.metrics["respawns"] >= 1)
            assert wait_until(lambda: router.stats()["replicas"]["r0"]["health"].get(
                "worker_alive"))
            res = router.submit(PROMPT, max_new_tokens=2).result(10)
            return (first in ("FailoverExhaustedError", "NoHealthyReplicaError",
                              "ReplicaDeadError"), res.replica_id,
                    router.stats()["replicas"]["r0"]["generation"] >= 1,
                    router.membership.members()["r0"]["generation"] >= 1,
                    router.metrics["probe_failures"] >= 1)
        finally:
            router.close(drain=False)

    assert _side_by_side(scenario) == (True, "r0", True, True, True)


def test_respawn_factory_failures_are_visible_then_reset():
    def scenario(side):
        kill, fail = threading.Event(), threading.Event()
        fail.set()

        def factory(replica_id):
            if fail.is_set():
                raise RuntimeError("allocator out of capacity")
            return side.server(echo_gen(), replica_id=replica_id)

        router = side.fleet_of(1, gen=killable_gen(kill), fleet_kw={
            "auto_respawn": True, "respawn_backoff_s": 0.01, "probe_interval_s": 0.03},
            replica_factory=factory)
        try:
            kill.set()
            router.submit(PROMPT, max_new_tokens=2).exception(10)
            assert wait_until(lambda: router.metrics["respawn_failures"] >= 2)
            failing = (router.metrics["replica/r0/respawn_failing"],
                       router.stats()["replicas"]["r0"]["respawn_failures"] >= 2)
            fail.clear()
            assert wait_until(lambda: router.metrics["respawns"] >= 1)
            assert wait_until(lambda: router.stats()["replicas"]["r0"]["health"].get(
                "worker_alive"))
            return (failing, router.metrics["replica/r0/respawn_failing"],
                    router.stats()["replicas"]["r0"]["respawn_failures"],
                    router.submit(PROMPT, max_new_tokens=2).result(10).replica_id)
        finally:
            router.close(drain=False)

    assert _side_by_side(scenario) == ((1.0, True), 0.0, 0, "r0")


# ------------------------------------------------------------------ hedging
def test_hedged_dispatch_first_result_wins():
    def scenario(side):
        router = side.fleet_of(2, gen=[echo_gen(delay=0.6), echo_gen(delay=0.005)],
                               fleet_kw={"hedge_deadline_fraction": 10_000.0})
        try:
            t0 = time.monotonic()
            res = router.submit(PROMPT, max_new_tokens=2, deadline_s=0.5).result(10)
            fast = time.monotonic() - t0 < 0.55
            assert wait_until(lambda: router.metrics["hedge_wins"] >= 1)
            return res.replica_id, fast, _counts(router, "hedges", "hedge_wins", "completed")
        finally:
            router.close(drain=False)

    assert _side_by_side(scenario) == ("r1", True, {"hedges": 1, "hedge_wins": 1, "completed": 1})


# ----------------------------------------------------------------- brown-out
def test_brownout_residual_is_peer_relative():
    def scenario(side):
        router = side.fleet_of(3)
        solo = side.fleet_of(1)
        try:
            h = router._handles
            h["r0"].perf_ratio = 3.2e6
            scores = [router._brownout_score(h["r0"])]
            for handle in h.values():
                handle.perf_ratio = 3.2e6
            scores.append(router._brownout_score(h["r0"]))
            h["r0"].perf_ratio = 3.2e7
            scores.append(router._brownout_score(h["r0"]))
            h["r0"].probe_hung = True
            scores.append(router._brownout_score(h["r0"]))
            solo._handles["r0"].perf_ratio = 8.0
            scores.append(solo._brownout_score(solo._handles["r0"]))
            return scores
        finally:
            router.close(drain=False)
            solo.close(drain=False)

    scores = _side_by_side(scenario)
    assert scores[0] < 1.0 and scores[1] < 1.0 and scores[2] >= 1.0 and scores[3] == 2.0


def test_hung_probe_is_a_brownout_with_one_typed_finding():
    """A replica whose ``health()`` hangs becomes a brown-out on that
    replica alone: placement goes to the healthy one, the prober keeps
    stamping, and one ReplicaBrownoutError naming it reaches perfwatch."""

    def scenario(side):
        release = threading.Event()
        router = side.fleet_of(2, fleet_kw={
            "probe_interval_s": 0.03, "probe_timeout_s": 0.15, "brownout_drain_after_s": 0.0,
            "brownout_probe_ewma_s": 5.0})
        watch = side.perf.get_watch()
        watch.consume_drift_findings()
        try:
            assert wait_until(lambda: router.metrics["probes"] >= 4)
            assert wait_until(lambda: not any(
                s["brownout"] for s in router.stats()["replicas"].values()))
            server = router.servers()["r0"]
            real = server.health

            def hung():
                release.wait(30.0)
                return real()

            server.health = hung
            assert wait_until(lambda: router.stats()["replicas"]["r0"]["brownout"])
            assert wait_until(lambda: router.metrics["replica/r0/brownout"] == 1.0)
            before = router.metrics["last_probe_s"]
            assert wait_until(lambda: router.metrics["last_probe_s"] > before)
            served = router.submit(PROMPT, max_new_tokens=2).result(10).replica_id
            assert wait_until(lambda: router.metrics["brownout_findings"] >= 1, timeout=15)
            named = [(type(f).__name__, f.replica_id, f.program)
                     for f in watch.consume_drift_findings()
                     if getattr(f, "replica_id", None) == "r0"]
            return (served, named, router.metrics["probe_timeouts"] >= 1,
                    router.stats()["replicas"]["r0"]["brownout_score"] >= 1.0)
        finally:
            release.set()
            router.close(drain=False)

    assert _side_by_side(scenario) == (
        "r1", [("ReplicaBrownoutError", "r0", "fleet/replica/r0")], True, True)


# ------------------------------------------------------------------- units
def test_token_bucket_refills_at_rate():
    def scenario(side):
        now = {"t": 0.0}
        bucket = side.fleet._TokenBucket(2, 1.0, lambda: now["t"])
        out = [bucket.try_acquire(), bucket.try_acquire(), bucket.try_acquire()]
        for t in (0.5, 1.1, 100.0):
            now["t"] = t
            out += [bucket.try_acquire(), bucket.available()]
        return out

    assert _side_by_side(scenario) == [True, True, False, False, 0.5, True, 0.10000000000000009,
                                       True, 1.0]


def test_fleet_membership_versions_and_subscribers():
    def scenario(side):
        m = side.elastic.FleetMembership()
        events = []
        m.subscribe(lambda ev, rid, version: events.append((ev, rid, version)))
        m.subscribe(lambda *a: 1 / 0)  # a failing subscriber never wedges the ledger
        out = [m.join("a", {"zone": 1}), m.join("b"), m.join("a", {"zone": 2}), m.leave("a"),
               m.leave("a"), m.members(), m.snapshot(), m.version]
        return out, events

    out, events = _side_by_side(scenario)
    assert [e[0] for e in events] == ["join", "join", "join", "leave"]


@pytest.mark.parametrize("bad", [
    dict(placement="random"), dict(probe_interval_s=0.0), dict(max_failovers=-1),
    dict(retry_budget_capacity=-1), dict(hedge_deadline_fraction=0.0), dict(prefill_workers=0),
    dict(kv_transfer="udp"), dict(kv_affinity_weight=0.0), dict(brownout_residual_ratio=1.0),
])
def test_fleet_config_validation(bad):
    for dc in (jdc, tdc):
        with pytest.raises(ValueError):
            dc.FleetConfig(**bad)


def test_sequence_replicas_stats_and_metrics_namespace():
    def scenario(side):
        named = side.server(echo_gen(), replica_id="east-1")
        anon = side.server(echo_gen())
        router = side.fleet.FleetRouter([named, anon], side.dc.FleetConfig(probe_interval_s=5.0))
        try:
            ids = sorted(router.stats()["replicas"])
            router.submit(PROMPT, max_new_tokens=2).result(10)
            st = router.stats()
            shape = (sorted(st), all(k.startswith("fleet/") for k in st["metrics"]),
                     st["metrics"]["fleet/completed"], st["membership"]["version"],
                     sorted(st["replicas"]["east-1"]))
            ok = router.scale_down("east-1", timeout=5.0)
            return ids, shape, ok, sorted(router.stats()["replicas"])
        finally:
            router.close()

    assert _side_by_side(scenario)[0] == ["east-1", "replica-1"]


def test_disaggregation_falls_back_without_an_engine():
    def scenario(side):
        with side.fleet_of(2, fleet_kw={"disaggregate_prefill": True,
                                        "prefill_workers": 2}) as router:
            res = [router.submit(PROMPT, max_new_tokens=2).result(10) for _ in range(6)]
            return len(res), _counts(router, "prefills", "prefill_fallback/unavailable")

    # a replica without an engine never reaches the prefill workers
    assert _side_by_side(scenario) == (6, {"prefills": 0, "prefill_fallback/unavailable": 0})


def test_metrics_snapshot_aggregates_replicas():
    """One prober pass folds each replica's health and snapshot into the
    router's registry (``fleet/replica/<id>/...``), which the exporter
    serves as one metric family with a replica label."""

    def scenario(side):
        with side.fleet_of(2, fleet_kw={"probe_interval_s": 0.02}) as router:
            router.submit(PROMPT, max_new_tokens=2).result(10)
            assert wait_until(lambda: "fleet/replica/r1/health/queue_depth"
                              in router.metrics_snapshot())
            snap = router.metrics_snapshot()
            text = side.perf.prometheus_text(snap)
            keys = sorted(k for k in snap if k.startswith("fleet/replica/r0/health/"))
            return keys, 'accelerate_fleet_replica_health_worker_alive{replica="r0"} 1' in text

    keys, labelled = _side_by_side(scenario)
    assert labelled and "fleet/replica/r0/health/breaker_state" in keys


# --------------------------------------------- a continuous fleet, tiny Llama
@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JLlamaConfig.tiny(compute_dtype=jnp.float32), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32)
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return {"jax": jmodel, "torch": LlamaForCausalLM(tcfg, params)}


PROMPTS = [np.asarray([5, 17, 33, 2, 9], np.int32), np.arange(1, 17, dtype=np.int32),
           np.asarray([200, 1, 7, 7, 7, 42, 99, 3, 12], np.int32),
           np.asarray([3, 4, 3, 4, 3, 4], np.int32), np.arange(40, 52, dtype=np.int32),
           np.asarray([9, 9, 1], np.int32)]


@pytest.mark.parametrize("disaggregate", [False, True], ids=["inline", "disaggregated"])
def test_continuous_fleet_greedy_tokens_are_jaxs(models, disaggregate):
    """Two continuous replicas over one model (each its own engine and
    pool), six greedy requests through the router: every token equals the
    JAX fleet's, both replicas answer, and with disaggregated prefill every
    prompt forward ran on a prefill worker."""

    def scenario(side):
        cfg = side.dc.ServingConfig(mode="continuous", engine_slots=2, engine_max_len=64,
                                    engine_prompt_bucket=16, engine_readback_lag=1,
                                    kv_cache="paged", engine_block_size=8)
        kw = {"device": "cpu"} if side.name == "torch" else {}
        servers = {rid: side.serving.InferenceServer(models[side.name], cfg, replica_id=rid, **kw)
                   for rid in ("r0", "r1")}
        fcfg = side.dc.FleetConfig(probe_interval_s=5.0, placement="round_robin",
                                   disaggregate_prefill=disaggregate, prefill_workers=1)
        with side.fleet.FleetRouter(servers, fcfg) as router:
            futs = [router.submit(p, max_new_tokens=8) for p in PROMPTS]
            res = [f.result(120) for f in futs]
            return ([r.tokens.tolist() for r in res], sorted({r.replica_id for r in res}),
                    _counts(router, "completed", "prefills", "failovers"))

    tokens, replicas, counts = _side_by_side(scenario)
    assert replicas == ["r0", "r1"] and counts["completed"] == 6
    assert counts["prefills"] == (6 if disaggregate else 0)
