"""The port's SLO controller beside the JAX package's, in lockstep.

Each of ``tests/test_controller.py``'s cases runs both controllers at once:
a copy of that file's fakes for each package (``FakeWatch``,
``FakeSpecEngine``, ``FakeChunkEngine``, ``FakeServer``, ``FakeRouter``,
each side's ``ServingConfig``/``FleetConfig``/``PerfDriftError``), one
injected clock and the same scripted snapshots. After every ``tick()`` the
two must agree on the actuations (the fleet's scale log and every knob),
the engaged rungs, ``frozen``, the fail-static findings' types and
messages and the whole ``controller/...`` snapshot; each case then holds
the JAX test's claims. Then the JAX fleet test of a hung replica on the
port's fleet, and the slice as a whole: two continuous servers of a tiny
Llama (the JAX model's weights) under the controller through a seeded
flash crowd, every token the JAX engine's greedy token.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import controller as jcontroller
from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.models.llama import LlamaConfig as JLlamaConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu.utils import fault as jfault
from accelerate_tpu_torch import controller as tcontroller
from accelerate_tpu_torch import perfwatch as tperf
from accelerate_tpu_torch.fleet import FleetRouter
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.serving import InferenceServer
from accelerate_tpu_torch.test_utils import arrivals
from accelerate_tpu_torch.utils import dataclasses as tdc
from accelerate_tpu_torch.utils import fault as tfault

QUEUE_CAP = 256
PACKAGES = {"jax": (jcontroller, jdc, jfault), "torch": (tcontroller, tdc, tfault)}


@pytest.fixture(autouse=True)
def _disarmed():
    """No fault spec or conductor leaks into or out of a case (both
    packages read the one environment variable)."""
    for key in (jfault.FAULT_INJECT_ENV, jfault.FAULT_SEED_ENV):
        os.environ.pop(key, None)
    yield
    for key in (jfault.FAULT_INJECT_ENV, jfault.FAULT_SEED_ENV):
        os.environ.pop(key, None)
    jfault.reset_fault_state()
    tfault.reset_fault_state()


# ------------------------------------------- the JAX suite's fakes, per side
class FakeWatch:
    def __init__(self, findings=()):
        self.findings = list(findings)

    def consume_drift_findings(self):
        out, self.findings = self.findings, []
        return out


class FakeSpecEngine:
    spec = object()  # the spec rung applies

    def __init__(self):
        self.limits = []

    def set_spec_draft_limit(self, n):
        self.limits.append(n)


class FakeChunkEngine:
    spec = None
    prefill_chunk = 16

    def __init__(self, limit=4):
        self.prefill_chunk_limit = limit
        self.limits = []

    def set_prefill_chunk_limit(self, n):
        self.prefill_chunk_limit = max(0, int(n))
        self.limits.append(self.prefill_chunk_limit)


class FakeServer:
    def __init__(self, dc, engine=None, **cfg_overrides):
        self.config = dc.ServingConfig(**cfg_overrides)
        self.engine = engine


class FakeRouter:
    """The surface SLOController uses, with scripted queue depth, breakers,
    unreadable replicas, probe stamps and TTFT stream."""

    def __init__(self, dc, n=2, clock=None, hedge=0.5, can_scale=True, **srv_kw):
        self.dc = dc
        self._servers = {f"r{i}": FakeServer(dc, **srv_kw) for i in range(n)}
        self.config = dc.FleetConfig(hedge_deadline_fraction=hedge)
        self.extra_metrics = []
        self.can_scale = can_scale
        self.scaled = []
        self.clock = clock or (lambda: 0.0)
        self.depth = 0
        self.breaker_open = set()
        self.unreadable = set()
        self.ttft_p99 = None
        self.ttft_count = 0

    def replica_ids(self):
        return sorted(self._servers)

    def servers(self):
        return dict(self._servers)

    def refresh_replica_metrics(self):
        return {rid: {"queue_depth": self.depth, "queue_free": QUEUE_CAP - self.depth,
                      "breaker_state": 1 if rid in self.breaker_open else 0,
                      "batch_ewma_s": 0.01 * (1 + i)}
                for i, rid in enumerate(self.replica_ids()) if rid not in self.unreadable}

    def metrics_snapshot(self):
        snap = {"fleet/last_probe_s": self.clock()}
        if self.ttft_p99 is not None:
            snap["fleet/replica/r0/serving/ttft_p99"] = self.ttft_p99
            snap["fleet/replica/r0/serving/ttft_count"] = self.ttft_count
        for fn in list(self.extra_metrics):
            snap.update(fn())
        return snap

    def scale_up(self, rid):
        self._servers[rid] = FakeServer(self.dc)
        self.scaled.append(("up", rid))
        return self._servers[rid]

    def scale_down(self, rid, timeout=None):
        self._servers.pop(rid)
        self.scaled.append(("down", rid))
        return True


class Side:
    def __init__(self, name, ctl, router, watch, engines):
        self.name, self.ctl, self.router, self.watch, self.engines = (name, ctl, router, watch,
                                                                      engines)


def observe(side):
    """Everything a tick may have changed, comparable across packages."""
    r, ctl = side.router, side.ctl
    knobs = {rid: (s.config.spec_draft_len, s.config.max_queue, s.config.degrade_queue_fraction,
                   s.config.degrade_hard_fraction, s.config.degraded_max_new_tokens,
                   getattr(s.engine, "limits", None),
                   getattr(s.engine, "prefill_chunk_limit", None))
             for rid, s in r.servers().items()}
    return dict(scaled=list(r.scaled), replicas=r.replica_ids(), rungs=ctl.engaged_rungs(),
                frozen=ctl.frozen, hedge=r.config.hedge_deadline_fraction, knobs=knobs,
                findings=[(type(f).__name__, str(f), f.reason, f.age_s, f.coverage)
                          for f in ctl.stale_findings()],
                snapshot=ctl.metrics.snapshot(), watch_left=len(side.watch.findings))


class Lockstep:
    """Both controllers over their own fakes, one clock, compared after
    every tick. ``engines(name)`` gives a side its engines by replica id;
    ``findings(fault_module)`` its watch's drift findings."""

    def __init__(self, engines=None, findings=None, router_kw=None, **cfg):
        self.clock = {"t": 100.0}
        self.sides = {}
        for name, (ctl_mod, dc, fault) in PACKAGES.items():
            router = FakeRouter(dc, clock=lambda: self.clock["t"], **(router_kw or {}))
            eng = engines(name) if engines else {}
            for rid, e in eng.items():
                router._servers[rid].engine = e
            watch = FakeWatch(findings(fault) if findings else ())
            defaults = dict(knob_cooldown_s=0.0, scale_cooldown_s=0.0,
                            actuation_budget_capacity=100, actuation_budget_refill_per_s=10.0)
            defaults.update(cfg)
            ctl = ctl_mod.SLOController(router, dc.ControllerConfig(**defaults), watch=watch,
                                        clock=lambda: self.clock["t"])
            self.sides[name] = Side(name, ctl, router, watch, eng)
        self.seen = []

    @property
    def torch(self):
        return self.sides["torch"]

    def set(self, **attrs):
        for side in self.sides.values():
            for key, value in attrs.items():
                setattr(side.router, key, value)

    def tick(self, dt=1.0):
        self.clock["t"] += dt
        for side in self.sides.values():
            side.router.clock = lambda: self.clock["t"]
        return self.tick_as_is()

    def tick_as_is(self):
        """One tick of each controller, clocks as they are; the two
        observations must be equal."""
        obs = {}
        for name, side in self.sides.items():
            side.ctl.tick()
            obs[name] = observe(side)
        assert obs["torch"] == obs["jax"], len(self.seen)
        self.seen.append(obs["torch"])
        return obs["torch"]

    def metric(self, name):
        return self.torch.ctl.metrics[name]


def arm(spec):
    os.environ[jfault.FAULT_INJECT_ENV] = spec


# ------------------------------------------------------------------- ladder
def test_escalates_rungs_in_order_then_scales():
    ls = Lockstep(engines=lambda name: dict.fromkeys(("r0", "r1"), FakeSpecEngine()),
                  router_kw=dict(spec_draft_len=8))
    ls.set(depth=int(0.9 * QUEUE_CAP))
    for _ in range(4):
        ls.tick()
    t = ls.torch
    assert t.ctl.engaged_rungs() == ["spec", "degrade", "admission", "hedge"]
    srv = t.router._servers["r0"]
    assert srv.config.spec_draft_len == 4 and 4 in t.engines["r0"].limits
    assert srv.config.max_queue == tdc.ServingConfig().max_queue // 2
    assert t.router.config.hedge_deadline_fraction is None
    ls.tick()
    assert t.router.scaled == [("up", "ctl-1")]


def test_longctx_rung_halves_chunk_schedule_then_relaxes():
    ls = Lockstep(engines=lambda name: {"r0": FakeChunkEngine(limit=4),
                                        "r1": FakeChunkEngine(limit=1)})
    ls.set(depth=int(0.9 * QUEUE_CAP))
    ls.tick()
    t = ls.torch
    assert t.ctl.engaged_rungs() == ["longctx"]
    assert t.engines["r0"].prefill_chunk_limit == 2 and t.engines["r1"].prefill_chunk_limit == 0
    for _ in range(3):
        ls.tick()
    assert t.ctl.engaged_rungs() == ["longctx", "degrade", "admission", "hedge"]
    ls.set(depth=0)
    for _ in range(10):
        ls.tick()
    assert t.ctl.engaged_rungs() == []
    assert t.engines["r0"].prefill_chunk_limit == 4 and t.engines["r1"].prefill_chunk_limit == 1


def test_relax_restores_baseline_and_drains_added_replicas_first():
    ls = Lockstep()
    t = ls.torch
    orig_queue = t.router._servers["r0"].config.max_queue
    ls.set(depth=int(0.9 * QUEUE_CAP))
    for _ in range(6):
        ls.tick()
    assert any(op == "up" for op, _ in t.router.scaled)
    ls.set(depth=0)
    for _ in range(10):
        ls.tick()
    downs = [rid for op, rid in t.router.scaled if op == "down"]
    assert downs and all(rid.startswith("ctl-") for rid in downs)
    assert t.ctl.engaged_rungs() == []
    assert t.router._servers["r0"].config.max_queue == orig_queue
    assert t.router.config.hedge_deadline_fraction == 0.5
    assert t.router.replica_ids() == ["r0", "r1"]


def test_relax_respects_min_replicas():
    ls = Lockstep(min_replicas=2)
    for _ in range(5):
        ls.tick()
    assert ls.torch.router.scaled == []


def test_ttft_slo_breach_escalates():
    ls = Lockstep(ttft_slo_s=0.5, target_queue_fraction=0.9)
    ls.set(ttft_p99=1.0, ttft_count=10)
    ls.tick()
    assert ls.metric("escalations") == 0
    ls.set(ttft_count=20)
    ls.tick()
    assert ls.metric("escalations") == 1


def test_stale_latency_window_does_not_pin_pressure():
    ls = Lockstep(ttft_slo_s=0.5, target_queue_fraction=0.9)
    ls.set(ttft_p99=1.0, ttft_count=10)
    ls.tick()
    ls.set(ttft_count=20)
    ls.tick()
    assert ls.metric("escalations") == 1
    ls.set(depth=0)
    for _ in range(3):
        ls.tick()
    assert ls.metric("relaxations") >= 1


# --------------------------------------------------------------- hysteresis
def test_oscillating_load_inside_dead_band_zero_actuations():
    ls = Lockstep(escalate_threshold=1.0, relax_threshold=0.5, target_queue_fraction=0.5)
    for i in range(40):
        ls.set(depth=int(QUEUE_CAP * (0.3 if i % 2 else 0.45)))
        ls.tick()
    assert (ls.metric("actuations"), ls.metric("escalations"), ls.metric("relaxations")) == (0, 0, 0)
    assert ls.torch.router.scaled == []


def test_knob_cooldown_blocks_repeat_actuation():
    ls = Lockstep(scale_cooldown_s=100.0, knob_cooldown_s=100.0)
    ls.set(depth=int(0.9 * QUEUE_CAP))
    for _ in range(6):
        ls.tick()
    assert ls.metric("actuations") <= len(ls.torch.ctl.engaged_rungs()) + 1
    assert ls.metric("actuation_denied_cooldown") >= 1


def test_token_bucket_bounds_actuation_rate():
    ls = Lockstep(actuation_budget_capacity=1, actuation_budget_refill_per_s=0.0)
    ls.set(depth=int(0.9 * QUEUE_CAP))
    for _ in range(6):
        ls.tick()
    assert ls.metric("actuations") == 1 and ls.metric("actuation_denied_budget") >= 1


# --------------------------------------------------------------- fail-static
def test_observe_fault_freezes_with_exactly_one_typed_finding():
    ls = Lockstep()
    ls.set(depth=int(0.9 * QUEUE_CAP))
    ls.tick()
    acts = ls.metric("actuations")
    arm("controller_observe:raise")
    for _ in range(8):
        ls.tick()
    t = ls.torch
    findings = t.ctl.stale_findings()
    assert t.ctl.frozen and len(findings) == 1
    assert isinstance(findings[0], tfault.ControllerStaleError) and "fail-static" in str(findings[0])
    assert ls.metric("actuations") == acts and ls.metric("stale_ticks") == 8


def test_recovery_after_observe_fault():
    ls = Lockstep()
    ls.tick()
    arm("controller_observe:raise")
    ls.tick()
    assert ls.torch.ctl.frozen
    os.environ.pop(jfault.FAULT_INJECT_ENV, None)
    ls.tick()
    assert not ls.torch.ctl.frozen and ls.metric("recoveries") == 1
    ls.set(depth=int(0.9 * QUEUE_CAP))
    ls.tick()
    assert ls.metric("escalations") == 1


def test_partial_coverage_freezes():
    ls = Lockstep(min_coverage=1.0)
    ls.tick()
    for side in ls.sides.values():
        side.router.unreadable.add("r1")
    for _ in range(3):
        ls.tick()
    findings = ls.torch.ctl.stale_findings()
    assert ls.torch.ctl.frozen and len(findings) == 1 and findings[0].coverage == 0.5


def test_stale_probe_stamp_freezes_and_second_episode_gets_new_finding():
    ls = Lockstep(stale_after_s=2.0)
    ls.tick()
    stamp = ls.clock["t"]  # the prober stops stamping here
    now = stamp + 3.0
    for side in ls.sides.values():
        side.router.clock = lambda: stamp
        side.ctl._clock = lambda: now
    ls.tick_as_is()
    ls.tick_as_is()
    t = ls.torch
    assert t.ctl.frozen and len(t.ctl.stale_findings()) == 1
    assert t.ctl.stale_findings()[0].age_s == pytest.approx(3.0)
    for side in ls.sides.values():
        side.router.clock = lambda: now  # the prober catches up
    ls.tick_as_is()
    assert not t.ctl.frozen
    for side in ls.sides.values():
        side.router.clock = lambda: now - 3.0  # and wedges again
    ls.tick_as_is()
    assert t.ctl.frozen and len(t.ctl.stale_findings()) == 2


# -------------------------------------------------------------------- drift
def test_drift_finding_replaces_exactly_one_replica():
    ls = Lockstep(findings=lambda fault: [fault.PerfDriftError("p", 2.0, 1.0, 0.25)],
                  scale_cooldown_s=1000.0)
    ls.tick()
    ls.tick()
    t = ls.torch
    assert t.router.scaled == [("up", "ctl-1"), ("down", "r1")]
    assert ls.metric("drift_replacements") == 1 and t.router.replica_ids() == ["ctl-1", "r0"]


def test_drift_without_factory_logs_not_replaces():
    ls = Lockstep(findings=lambda fault: [fault.PerfDriftError("p", 2.0, 1.0, 0.25)],
                  router_kw=dict(can_scale=False))
    ls.tick()
    assert ls.torch.router.scaled == [] and ls.metric("drift_replacements") == 0


def test_drift_findings_not_consumed_while_frozen():
    ls = Lockstep(findings=lambda fault: [fault.PerfDriftError("p", 2.0, 1.0, 0.25)])
    arm("controller_observe:raise")
    ls.tick()
    assert ls.torch.watch.findings and ls.torch.router.scaled == []


# ------------------------------------------------------------------ dry run
def test_dry_run_counts_decisions_but_touches_nothing():
    ls = Lockstep(dry_run=True)
    t = ls.torch
    orig_queue = t.router._servers["r0"].config.max_queue
    ls.set(depth=int(0.9 * QUEUE_CAP))
    for _ in range(6):
        ls.tick()
    assert ls.metric("dry_run_actions") >= 1 and ls.metric("actuations") == 0
    assert t.router.scaled == [] and t.router._servers["r0"].config.max_queue == orig_queue
    assert t.router.config.hedge_deadline_fraction == 0.5


# ------------------------------------------------------------ observability
def test_controller_metrics_ride_the_router_snapshot():
    ls = Lockstep()
    ls.tick()
    t = ls.torch
    snap = t.router.metrics_snapshot()
    assert snap["controller/ticks"] == 1 and "controller/pressure" in snap
    for side in ls.sides.values():
        side.ctl.close()
    assert t.ctl.metrics.snapshot not in t.router.extra_metrics
    assert ls.sides["jax"].router.extra_metrics == t.router.extra_metrics == []


@pytest.mark.parametrize("bad", [dict(relax_threshold=1.5, escalate_threshold=1.0),
                                 dict(min_replicas=5, max_replicas=2), dict(interval_s=0.0),
                                 dict(ttft_slo_s=0.0), dict(target_queue_fraction=1.5),
                                 dict(knob_cooldown_s=-1.0), dict(actuation_budget_capacity=0),
                                 dict(stale_after_s=0.0), dict(min_coverage=0.0),
                                 dict(replace_drain_timeout_s=-1.0),
                                 dict(transfer_pressure_weight=-1.0)])
def test_config_validation(bad):
    """The JAX checks, message for message; the defaults are JAX's."""
    messages = []
    for dc in (jdc, tdc):
        with pytest.raises(ValueError) as info:
            dc.ControllerConfig(**bad)
        messages.append(str(info.value))
    assert messages[0] == messages[1]
    assert vars(tdc.ControllerConfig()) == vars(jdc.ControllerConfig())


# ------------------------------------------------- the hung replica, for real
def _echo_gen(model, ids, max_new_tokens=8, **kw):
    return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)


def _static_server(replica_id):
    cfg = tdc.ServingConfig(max_queue=128, max_batch_size=4, batch_window_s=0.001, max_retries=0)
    return InferenceServer(object(), cfg, generate_fn=_echo_gen, replica_id=replica_id,
                           device="cpu")


def wait_until(predicate, timeout=10.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return predicate()


def test_one_hung_replica_never_freezes_controller():
    """``tests/test_fleet.py``'s gray-failure loop on the port's fleet: a
    hung ``health()`` -> brown-out -> one typed finding -> the controller
    (not frozen: the cached sample keeps the replica covered) drains and
    replaces the replica."""
    release = threading.Event()
    router = FleetRouter({rid: _static_server(rid) for rid in ("r0", "r1")},
                         tdc.FleetConfig(probe_interval_s=0.03, probe_timeout_s=0.15,
                                         brownout_drain_after_s=0.0, brownout_probe_ewma_s=5.0),
                         replica_factory=_static_server)
    tperf.get_watch().consume_drift_findings()  # leftovers of other tests
    ctl = tcontroller.SLOController(router, tdc.ControllerConfig(min_coverage=1.0))
    try:
        assert wait_until(lambda: router.metrics["probes"] >= 4)
        assert wait_until(lambda: not any(s["brownout"]
                                          for s in router.stats()["replicas"].values()))
        server = router.servers()["r0"]
        real = server.health

        def hung():
            release.wait(30.0)
            return real()

        server.health = hung
        assert wait_until(lambda: router.metrics["brownout_findings"] >= 1, timeout=15.0)
        ctl.tick()
        assert not ctl.frozen and ctl.stale_findings() == []
        assert ctl.metrics["drift_replacements"] == 1
        assert wait_until(lambda: "r0" not in router.replica_ids())
        assert any(r.startswith("ctl-") for r in router.replica_ids())
        res = router.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2).result(10)
        assert res.replica_id in router.replica_ids()
    finally:
        release.set()
        ctl.close()
        router.close(drain=False)


# ----------------------------------------------- the slice: a fleet of Llamas
ENGINE = dict(mode="continuous", engine_slots=2, engine_max_len=64, engine_prompt_bucket=16,
              engine_readback_lag=1, kv_cache="paged", engine_block_size=8)
NEW_TOKENS = 8
CROWD_PROMPTS = [np.asarray([5, 17, 33, 2, 9], np.int32), np.arange(1, 17, dtype=np.int32),
                 np.asarray([200, 1, 7, 7, 7, 42, 99, 3, 12], np.int32),
                 np.asarray([3, 4, 3, 4, 3, 4], np.int32), np.arange(40, 52, dtype=np.int32),
                 np.asarray([9, 9, 1], np.int32)]


@pytest.fixture(scope="module")
def llamas():
    jmodel = create_llama(JLlamaConfig.tiny(compute_dtype=jnp.float32), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32)
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params),
                             device="cpu")
    eng = JEngine(jmodel, slots=2, max_len=64, prompt_bucket=16, readback_lag=1, kv_cache="paged",
                  block_size=8)
    greedy = []
    for prompt in CROWD_PROMPTS:
        occ = eng.insert(prompt, max_new_tokens=NEW_TOKENS)
        eng.drain()
        greedy.append([int(t) for t in occ.tokens])
    return LlamaForCausalLM(tcfg, params), greedy


def test_controlled_llama_fleet_through_a_flash_crowd(llamas):
    """Two continuous servers of a tiny Llama (2 layers, the JAX model's
    weights) under ``SLOController``, a seeded ramp -> flash crowd -> drain
    of greedy requests without speculation: every future resolves, every
    failure is typed, each completed request's tokens are the JAX engine's
    greedy tokens for its prompt (their prefix where the degrade rung
    clamped the budget), the ladder moves and relaxes back to two
    replicas, and the controller's registry rides the router's snapshot."""
    model, greedy = llamas
    cfg = tdc.ServingConfig(max_queue=4, **ENGINE)

    def factory(rid):
        return InferenceServer(model, tdc.ServingConfig(max_queue=4, **ENGINE), replica_id=rid,
                               device="cpu")

    servers = {rid: InferenceServer(model, cfg, replica_id=rid, device="cpu")
               for rid in ("r0", "r1")}
    router = FleetRouter(servers, tdc.FleetConfig(probe_interval_s=0.02,
                                                  hedge_deadline_fraction=0.5,
                                                  brownout_probe_ewma_s=5.0),
                         replica_factory=factory)
    ctl = tcontroller.SLOController(router, tdc.ControllerConfig(
        interval_s=0.02, ttft_slo_s=0.001, knob_cooldown_s=0.0, scale_cooldown_s=0.05,
        actuation_budget_capacity=64, actuation_budget_refill_per_s=50.0, max_replicas=3,
        stale_after_s=5.0, replace_on_drift=False), watch=tperf.PerfWatch())
    schedule = arrivals.ramp_flash_crowd_drain(base_rps=20.0, peak_rps=40.0, ramp_s=0.4,
                                               flash_s=0.6, drain_s=0.4, seed=7)
    order = arrivals.prompt_order(len(schedule), len(CROWD_PROMPTS), seed=7)
    sent, typed = [], []
    try:
        ctl.start()

        def submit(phase):
            i = order[len(sent) + len(typed)]
            try:
                sent.append((i, router.submit(CROWD_PROMPTS[i], max_new_tokens=NEW_TOKENS)))
            except tfault.ServingError as exc:
                typed.append(exc)

        schedule.replay(submit)
        outcomes = []
        for i, fut in sent:
            exc = fut.exception(timeout=120)
            outcomes.append((i, exc if exc is not None else fut.result()))
        # the crowd is gone: the ladder hands everything back
        assert wait_until(lambda: ctl.engaged_rungs() == [] and len(router.replica_ids()) == 2,
                          timeout=30.0), (ctl.engaged_rungs(), router.replica_ids())
        snap = router.metrics_snapshot()
    finally:
        ctl.close()
        router.close(drain=False)
    failures = [o for _, o in outcomes if isinstance(o, BaseException)] + typed
    assert all(isinstance(e, tfault.ServingError) for e in failures), failures
    done = [(i, o) for i, o in outcomes if not isinstance(o, BaseException)]
    assert done
    for i, res in done:
        new = [int(t) for t in res.tokens[len(CROWD_PROMPTS[i]):]]
        assert 1 <= len(new) <= NEW_TOKENS and new == greedy[i][:len(new)], (i, new, greedy[i])
        assert len(new) == NEW_TOKENS or res.degraded
    assert snap["controller/ticks"] >= 1 and snap["controller/escalations"] >= 1
    assert snap["controller/relaxations"] >= 1 and snap["controller/frozen"] == 0.0
    assert any(k.startswith("fleet/replica/") for k in snap)


def test_a_replica_reports_the_perfwatch_its_engine_bills(llamas):
    """Replicas of one process built each under a perfwatch of its own
    report their own programs' numbers in ``metrics_snapshot()`` (what the
    fleet's brown-out detector reads), as replicas in their own processes
    do; a static server reports the process's watch."""
    model, _ = llamas
    cfg = tdc.ServingConfig(**ENGINE)
    prev = tperf.get_watch()
    watches, servers = [], []
    try:
        for rid in ("r0", "r1"):
            watches.append(tperf.configure(tdc.ObservabilityConfig()))
            servers.append(InferenceServer(model, cfg, replica_id=rid, device="cpu"))
        process = tperf.configure(tdc.ObservabilityConfig())
        servers[0].submit(CROWD_PROMPTS[0], max_new_tokens=NEW_TOKENS).result(60)
        calls = [{k: v for k, v in srv.metrics_snapshot().items()
                  if k.startswith("perf/") and k.endswith("/calls")} for srv in servers]
        assert calls[0] and sum(calls[0].values()) > 0 and not calls[1]
        assert watches[0].snapshot() == {**watches[0].snapshot(), **calls[0]}
        assert not any(k.endswith("/calls") for k in process.snapshot())
        static = InferenceServer(object(), tdc.ServingConfig(), generate_fn=_echo_gen,
                                 replica_id="s", device="cpu")
        servers.append(static)
        assert not any(k.startswith("perf/") and k.endswith("/calls")
                       for k in static.metrics_snapshot())
    finally:
        for srv in servers:
            srv.close(drain=False)
        tperf._DEFAULT = prev
