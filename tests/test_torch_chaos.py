"""The port's chaos conductor and invariant monitors beside the JAX
package's.

Each case is one of ``tests/test_chaos.py``'s, written as a scenario that
runs on both packages (their ``fault_point`` grammar, ``ChaosConductor``,
``InvariantMonitors`` and, for the last, a static fleet with a fake
``generate_fn``) and returns what it observed; the two observations must be
equal, and each holds the JAX test's claims. Firing decisions are a pure
function of (seed, each rule's hit ordinals, the hits' times): for the same
seed and hit log, the port's ``firing_sequence`` and ``replay`` equal the
JAX conductor's exactly, whichever package recorded the log. The seeded
arrival schedules of ``test_utils/arrivals.py`` equal
``benchmarks/loadgen.py``'s.
"""

import os
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from accelerate_tpu import chaos as jchaos
from accelerate_tpu import fleet as jfleet
from accelerate_tpu import serving as jserving
from accelerate_tpu import tracing as jtracing
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu.utils import fault as jfault
from accelerate_tpu_torch import chaos as tchaos
from accelerate_tpu_torch import fleet as tfleet
from accelerate_tpu_torch import serving as tserving
from accelerate_tpu_torch import tracing as ttracing
from accelerate_tpu_torch.test_utils import arrivals
from accelerate_tpu_torch.utils import dataclasses as tdc
from accelerate_tpu_torch.utils import fault as tfault


class Side:
    def __init__(self, name, chaos, fault, tracing, fleet, serving, dc):
        self.name, self.chaos, self.fault, self.tracing = name, chaos, fault, tracing
        self.fleet, self.serving, self.dc = fleet, serving, dc


SIDES = {"jax": Side("jax", jchaos, jfault, jtracing, jfleet, jserving, jdc),
         "torch": Side("torch", tchaos, tfault, ttracing, tfleet, tserving, tdc)}


@pytest.fixture(autouse=True)
def _fault_state():
    """Both packages' fault state clean before and after each case (the
    environment variables they read are shared)."""

    def clear():
        for key in (jfault.FAULT_INJECT_ENV, jfault.FAULT_SEED_ENV):
            os.environ.pop(key, None)
        for side in SIDES.values():
            side.fault.reset_fault_state()
            side.fault.uninstall_conductor()

    clear()
    yield
    clear()


def _side_by_side(scenario):
    """Run ``scenario(side)`` on each package, state reset between them;
    the observations must be equal."""
    seen = {}
    for name in ("jax", "torch"):
        os.environ.pop(jfault.FAULT_INJECT_ENV, None)
        os.environ.pop(jfault.FAULT_SEED_ENV, None)
        SIDES[name].fault.reset_fault_state()
        seen[name] = scenario(SIDES[name])
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def _arm(spec, seed=None):
    os.environ[jfault.FAULT_INJECT_ENV] = spec
    if seed is not None:
        os.environ[jfault.FAULT_SEED_ENV] = seed


def _firing_pattern(side, point, n=80, **context):
    out = []
    for _ in range(n):
        try:
            side.fault.fault_point(point, **context)
            out.append(0)
        except side.fault.FaultInjected:
            out.append(1)
    return out


# ------------------------------------------------------------ the grammar
def test_flaky_is_seeded_and_bit_reproducible():
    def scenario(side):
        _arm("fleet_probe:raise:flaky=0.3", seed="1234")
        first = _firing_pattern(side, "fleet_probe")
        side.fault.reset_fault_state()
        return first, _firing_pattern(side, "fleet_probe")

    first, second = _side_by_side(scenario)
    assert first == second and 0 < sum(first) < len(first)


def test_flaky_sequence_changes_with_seed():
    def scenario(side):
        _arm("fleet_probe:raise:flaky=0.5", seed="1")
        first = _firing_pattern(side, "fleet_probe")
        side.fault.reset_fault_state()
        _arm("fleet_probe:raise:flaky=0.5", seed="2")
        return first, _firing_pattern(side, "fleet_probe")

    first, second = _side_by_side(scenario)
    assert first != second


def test_modifier_only_entry_defaults_to_raise():
    def scenario(side):
        _arm("fleet_probe:flaky=1.0")
        with pytest.raises(side.fault.FaultInjected):
            side.fault.fault_point("fleet_probe")
        return True

    _side_by_side(scenario)


def test_after_and_every_hit_counters():
    def scenario(side):
        _arm("fleet_route:raise:after=3:every=2")
        return _firing_pattern(side, "fleet_route", 9)

    assert _side_by_side(scenario) == [0, 0, 0, 1, 0, 1, 0, 1, 0]


def test_counters_are_per_entry_not_per_point():
    def scenario(side):
        _arm("fleet_route:raise:after=2,fleet_route:raise:after=4")
        return _firing_pattern(side, "fleet_route", 5)

    assert _side_by_side(scenario) == [0, 0, 1, 1, 1]


def test_hang_blocks_until_released():
    def scenario(side):
        _arm("fleet_probe:hang=30")
        passed = threading.Event()

        def hit():
            side.fault.fault_point("fleet_probe")
            passed.set()

        t = threading.Thread(target=hit, daemon=True)
        t.start()
        time.sleep(0.1)
        parked = not passed.is_set()
        released = side.fault.release_hang("fleet_probe")
        t.join(2.0)
        return parked, released, passed.is_set()

    assert _side_by_side(scenario) == (True, True, True)


def test_hang_cap_bounds_the_block():
    def scenario(side):
        _arm("fleet_probe:hang=0.05")
        t0 = time.monotonic()
        side.fault.fault_point("fleet_probe")
        return 0.04 <= time.monotonic() - t0 < 2.0

    assert _side_by_side(scenario) is True


def test_unknown_action_and_double_action_are_typed_errors():
    def scenario(side):
        messages = []
        for spec, match in (("fleet_probe:explode", "unknown fault action"),
                            ("fleet_probe:raise:sleep", "second action")):
            _arm(spec)
            with pytest.raises(ValueError, match=match) as info:
                side.fault.fault_point("fleet_probe")
            messages.append(str(info.value))
        return messages

    _side_by_side(scenario)


# ------------------------------------------------------------- conductor
def test_conductor_scopes_rules_by_context():
    def scenario(side):
        c = side.chaos
        sched = c.ChaosSchedule(rules=(c.ChaosRule(point="fleet_probe", action="raise",
                                                   match={"replica": "r1"}, label="r1-only"),),
                                seed=3)
        with c.ChaosConductor(sched) as con:
            side.fault.fault_point("fleet_probe", replica="r0")
            with pytest.raises(side.fault.FaultInjected):
                side.fault.fault_point("fleet_probe", replica="r1")
            side.fault.fault_point("fleet_probe")
        return con.fires("r1-only"), con.firing_sequence(), [h[1:] for h in con.hit_log()]

    fires, _, _ = _side_by_side(scenario)
    assert fires == 1


def test_conductor_phase_windows_follow_the_clock():
    def scenario(side):
        c = side.chaos
        now = [0.0]
        sched = c.ChaosSchedule(rules=(c.ChaosRule(point="fleet_route", action="raise",
                                                   start_s=1.0, end_s=2.0, label="windowed"),))
        con = c.ChaosConductor(sched, clock=lambda: now[0]).start()
        try:
            side.fault.fault_point("fleet_route")
            now[0] = 1.5
            with pytest.raises(side.fault.FaultInjected):
                side.fault.fault_point("fleet_route")
            now[0] = 2.5
            side.fault.fault_point("fleet_route")
        finally:
            con.stop()
        return con.fires("windowed"), con.hit_log(), con.firing_sequence()

    fires, hits, _ = _side_by_side(scenario)
    assert fires == 1 and [t for t, _, _ in hits] == [0.0, 1.5, 2.5]


def test_conductor_max_fires_caps_a_kill_style_rule():
    def scenario(side):
        c = side.chaos
        sched = c.ChaosSchedule(rules=(c.ChaosRule(point="fleet_route", action="raise",
                                                   max_fires=1, label="once"),))
        with c.ChaosConductor(sched) as con:
            with pytest.raises(side.fault.FaultInjected):
                side.fault.fault_point("fleet_route")
            for _ in range(5):
                side.fault.fault_point("fleet_route")
        return con.fires("once"), con.firing_sequence()

    fires, seq = _side_by_side(scenario)
    assert fires == 1 and seq == (("once", 1, "raise"),)


REPLAY_RULES = dict(seed=99, rules=(
    dict(point="fleet_probe", action="raise", prob=0.4, label="flaky-probe"),
    dict(point="fleet_route", action="sleep=0", prob=0.7, every=2, label="slow-route"),
))


def _schedule(side, spec):
    c = side.chaos
    return c.ChaosSchedule(rules=tuple(c.ChaosRule(**r) for r in spec["rules"]),
                           seed=spec["seed"], name=spec.get("name", "chaos"))


def test_conductor_replay_reproduces_firing_log_bit_for_bit():
    """The JAX case on each package, and across them: the port's replay of
    the JAX conductor's hit log is the JAX firing log, and the other way
    round."""
    logs = {}

    def scenario(side):
        con = side.chaos.ChaosConductor(_schedule(side, REPLAY_RULES)).start()
        try:
            for i in range(60):
                try:
                    side.fault.fault_point("fleet_probe", replica=f"r{i % 3}")
                except side.fault.FaultInjected:
                    pass
                side.fault.fault_point("fleet_route")
        finally:
            con.stop()
        live = con.firing_sequence()
        logs[side.name] = (con, con.hit_log())
        return live, con.replay(con.hit_log()) == live, con.replay(con.hit_log()) == live

    live, once, twice = _side_by_side(scenario)
    assert len(live) > 0 and once and twice
    (jcon, jhits), (tcon, thits) = logs["jax"], logs["torch"]
    assert tcon.replay(jhits) == jcon.firing_sequence() == jcon.replay(thits)


@pytest.mark.parametrize("seed", [0, 7, 99, 4242])
def test_firing_sequence_is_jaxs_for_a_seed_and_hit_log(seed):
    """A scripted hit log over every rule feature (context match, window,
    after/every, max_fires, prob, two rules on one point): the port's
    conductor decides it exactly as the JAX one does."""
    spec = dict(seed=seed, name="storm", rules=(
        dict(point="serving_before_batch", action="sleep=0.45", match={"replica": "r0"},
             start_s=2.0, label="straggler"),
        dict(point="fleet_probe", action="raise", prob=0.2, start_s=2.0, end_s=5.0,
             label="flaky-probe"),
        dict(point="serving_before_batch", action="raise", match={"replica": "r1"},
             max_fires=1, label="kill"),
        dict(point="fleet_route", action="raise", prob=0.5, after=3, every=2, label="route"),
        dict(point="fleet_probe", action="hang=0", prob=0.3, label="wedge"),
    ))
    rng = np.random.default_rng(seed)
    points = ["serving_before_batch", "fleet_probe", "fleet_route", "controller_observe"]
    hits, t = [], 0.0
    for _ in range(400):
        t += float(rng.exponential(0.02))
        name = points[int(rng.integers(len(points)))]
        ctx = {"replica": f"r{int(rng.integers(3))}"} if name != "fleet_route" else {}
        hits.append((t, name, tuple(sorted(ctx.items()))))
    seqs = {name: side.chaos.ChaosConductor(_schedule(side, spec)).replay(hits)
            for name, side in SIDES.items()}
    assert seqs["torch"] == seqs["jax"]
    labels = {lab for lab, _, _ in seqs["torch"]}
    assert {"straggler", "flaky-probe", "kill", "route"} <= labels
    assert sum(lab == "kill" for lab, _, _ in seqs["torch"]) == 1


def test_conductor_hang_rule_released_by_stop():
    def scenario(side):
        c = side.chaos
        sched = c.ChaosSchedule(rules=(c.ChaosRule(point="fleet_probe", action="hang=30",
                                                   label="wedge"),))
        con = c.ChaosConductor(sched).start()
        passed = threading.Event()

        def hit():
            side.fault.fault_point("fleet_probe")
            passed.set()

        t = threading.Thread(target=hit, daemon=True)
        t.start()
        time.sleep(0.1)
        parked = not passed.is_set()
        con.stop()
        t.join(2.0)
        return parked, passed.is_set()

    assert _side_by_side(scenario) == (True, True)


def test_conductor_stop_fully_uninstalls_the_hook():
    def scenario(side):
        c = side.chaos
        sched = c.ChaosSchedule(rules=(c.ChaosRule(point="fleet_probe", action="raise",
                                                   label="leak"),))
        with c.ChaosConductor(sched):
            installed = side.fault._CONDUCTOR is not None
            with pytest.raises(side.fault.FaultInjected):
                side.fault.fault_point("fleet_probe")
        side.fault.fault_point("fleet_probe")  # nothing armed, nothing installed
        return installed, side.fault._CONDUCTOR is None

    assert _side_by_side(scenario) == (True, True)


def test_phase_windows_cumulative():
    def scenario(side):
        phases = [arrivals.Phase("ramp", 2.0, 1.0), arrivals.Phase("crowd", 1.0, 1.0),
                  arrivals.Phase("drain", 3.0, 1.0)]
        return side.chaos.phase_windows(phases)

    assert _side_by_side(scenario) == [("ramp", 0.0, 2.0), ("crowd", 2.0, 3.0),
                                       ("drain", 3.0, 6.0)]


def test_rule_validation_is_typed():
    def scenario(side):
        c = side.chaos
        messages = []
        for kw, match in ((dict(prob=1.5), "prob"), (dict(action="explode"),
                                                     "unknown chaos action"),
                          (dict(after=-1), "after"), (dict(every=0), "every")):
            with pytest.raises(ValueError, match=match) as info:
                c.ChaosRule(point="fleet_probe", **kw)
            messages.append(str(info.value))
        rule = c.ChaosRule(point="fleet_probe", match={"replica": "r1", "a": 1})
        return messages, rule.match, rule.label

    _side_by_side(scenario)


# ---------------------------------------------------- invariant monitors
def _kinds(violations):
    return [(v.kind, v.detail) for v in violations]


def test_monitor_flags_dropped_future():
    def scenario(side):
        mon = side.chaos.InvariantMonitors()
        mon.track("req-0", Future())
        first = _kinds(mon.check(quiesce_timeout_s=0.05))
        with pytest.raises(side.chaos.InvariantViolation, match="dropped_future"):
            mon.assert_clean(quiesce_timeout_s=0.05)
        return first

    assert [k for k, _ in _side_by_side(scenario)] == ["dropped_future"]


def test_monitor_flags_untyped_error_but_accepts_taxonomy():
    def scenario(side):
        mon = side.chaos.InvariantMonitors()
        bad, ok, cancelled, misuse = Future(), Future(), Future(), Future()
        bad.set_exception(RuntimeError("guts leaked"))
        ok.set_exception(side.fault.ServerOverloaded("backpressure"))
        misuse.set_exception(ValueError("bad prompt"))
        cancelled.cancel()
        for rid, fut in (("bad", bad), ("ok", ok), ("cancelled", cancelled), ("misuse", misuse)):
            mon.track(rid, fut)
        return _kinds(mon.check(quiesce_timeout_s=0.05))

    seen = _side_by_side(scenario)
    assert [k for k, _ in seen] == ["untyped_error"] and "bad" in seen[0][1]


def test_monitor_flags_counter_regression():
    def scenario(side):
        mon = side.chaos.InvariantMonitors()
        values = {"completed": 5}
        mon.watch_registry("fake", lambda: dict(values))
        first = mon.sample()
        values["completed"] = 3
        regressions = _kinds(mon.sample())
        mon.watch_registry("broken", lambda: 1 / 0)
        return first, regressions, _kinds(mon.sample())

    first, regressions, broken = _side_by_side(scenario)
    assert first == [] and [k for k, _ in regressions] == ["counter_regression"]
    assert "fake:completed" in regressions[0][1] and "broken" in broken[0][1]


def test_monitor_flags_incomplete_trace():
    def scenario(side):
        tracer = side.tracing.Tracer(side.dc.TracingConfig(enabled=True))
        delivered = Future()
        delivered.set_result(object())
        mon = side.chaos.InvariantMonitors(tracer=tracer, max_traces=1)
        mon.track("req-0", delivered, trace_id="trace-with-no-spans")
        mon.track("req-1", delivered, trace_id="over-the-bound")
        return _kinds(mon.check(quiesce_timeout_s=0.05)), mon.unverified_traces

    kinds, overflow = _side_by_side(scenario)
    assert [k for k, _ in kinds] == ["incomplete_trace"] and overflow == 1


def _echo_gen(model, ids, max_new_tokens=8, **kw):
    return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)


def test_monitor_clean_on_healthy_fleet_run():
    def scenario(side):
        cfg = side.dc.ServingConfig(max_queue=128, max_batch_size=4, batch_window_s=0.001,
                                    max_retries=0)
        kw = {"device": "cpu"} if side.name == "torch" else {}
        servers = {f"r{i}": side.serving.InferenceServer(object(), cfg, generate_fn=_echo_gen,
                                                         replica_id=f"r{i}", **kw)
                   for i in range(2)}
        tracer = side.tracing.get_tracer()
        router = side.fleet.FleetRouter(servers, side.dc.FleetConfig(probe_interval_s=0.05))
        mon = side.chaos.InvariantMonitors(tracer=tracer)
        mon.watch_registry("fleet", router.metrics.registry)
        prompt = np.arange(1, 6, dtype=np.int32)
        try:
            futs = []
            for i in range(8):
                with side.tracing.span("client", trace_id=f"{side.name}-req-{i}"):
                    futs.append(mon.track(f"req-{i}", router.submit(prompt, max_new_tokens=2)))
            tokens = [f.result(10).tokens.tolist() for f in futs]
            mon.sample()
        finally:
            router.close()
        return tokens, _kinds(mon.check(quiesce_timeout_s=2.0))

    tokens, violations = _side_by_side(scenario)
    assert violations == [] and len(tokens) == 8


# ------------------------------------------------------------- arrivals
@pytest.mark.parametrize("seed", [0, 1234])
def test_arrival_schedule_is_loadgens(seed):
    """The port's seeded ramp -> flash crowd -> drain equals the JAX
    repository's ``benchmarks/loadgen.py`` offset for offset, and its
    replay paces them in order, calling the phase hook at each boundary."""
    from benchmarks import loadgen

    kw = dict(base_rps=20.0, peak_rps=60.0, ramp_s=1.0, flash_s=0.5, drain_s=1.0,
              flash_multiplier=2.0, seed=seed)
    ours, theirs = arrivals.ramp_flash_crowd_drain(**kw), loadgen.ramp_flash_crowd_drain(**kw)
    assert ours.arrivals == theirs.arrivals and ours.phase_counts() == theirs.phase_counts()
    assert ours.duration_s == theirs.duration_s == 2.5
    clock, seen, phases = [0.0], [], []

    def sleep(dt):
        clock[0] += dt

    counts = ours.replay(lambda phase: seen.append((clock[0], phase)), clock=lambda: clock[0],
                         sleep=sleep, on_phase=phases.append)
    assert counts == ours.phase_counts() and phases == ["ramp", "flash", "drain"]
    assert [p for _, p in seen] == [p for _, p in ours.arrivals]
    assert all(t >= off for (t, _), off in zip(seen, ours.offsets())) and clock[0] >= 2.5
    order = arrivals.prompt_order(len(ours), 5, seed=seed)
    assert order == arrivals.prompt_order(len(ours), 5, seed=seed)
    assert set(order) <= set(range(5))
