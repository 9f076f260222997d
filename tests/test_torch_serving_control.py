"""The port's serving control plane beside the JAX package's: the circuit
breaker, the degradation ladder, ``ServingResult``'s fields, ``health()``,
``metrics_snapshot()`` and the tracker flush.

Each case is a scenario that runs against one package's server (or
breaker) and returns what it observed; it runs on the JAX package's and on
the port's with the same fake ``generate_fn``, the same injected clock and
the same failure script, and the two observations must be equal
(integers, state codes, type names and token ids: bitwise). Continuous mode
runs over a tiny Llama (2 layers, hidden 64) whose weights the port takes
from the JAX model, in float32: greedy tokens are bitwise JAX's.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import serving as jserving
from accelerate_tpu.models.llama import LlamaConfig as JLlamaConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import serving as tserving
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.utils import dataclasses as tdc


class FakeClock:
    """A monotonic clock the test advances by hand (thread-safe)."""

    def __init__(self, t=100.0):
        self.t = t
        self._lock = threading.Lock()

    def __call__(self):
        with self._lock:
            return self.t

    def advance(self, dt):
        with self._lock:
            self.t += dt


def _jax_server(model, cfg, **kw):
    return jserving.InferenceServer(model, cfg, **kw)


def _torch_server(model, cfg, **kw):
    return tserving.InferenceServer(model, cfg, device="cpu", **kw)


SIDES = {"jax": (jserving, jdc, _jax_server), "torch": (tserving, tdc, _torch_server)}


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
    """``scenario(serving_module, dataclasses_module, make_server)`` on both
    packages; returns the port's observation after asserting it equals the
    JAX package's."""
    seen = {name: scenario(*SIDES[name]) for name in ("jax", "torch")}
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def wait_until(predicate, timeout=10.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _error(future, timeout=10):
    exc = future.exception(timeout)
    return None if exc is None else (type(exc).__name__, exc.retriable, exc.replica_id)


def echo_gen(batches=None):
    def fn(model, ids, max_new_tokens=4, **kw):
        if batches is not None:
            batches.append((ids.shape[0], max_new_tokens))
        return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)

    return fn


# ------------------------------------------------------------------ breaker
def _breaker_script(seed):
    """A seeded script of breaker operations over a fake clock."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(40):
        r = rng.random()
        if r < 0.45:
            ops.append(("fail",))
        elif r < 0.6:
            ops.append(("success",))
        else:
            ops.append(("advance", float(rng.choice([0.1, 0.4, 0.6, 1.2]))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_breaker_state_sequence_matches_jax(seed):
    """Every transition of the three-state machine (threshold 3, reset 1 s)
    under one failure script: the state, whether admission is refused, the
    seconds to the probe and the open count after each step (exact:
    the clock's steps are binary fractions away from any rounding)."""
    ops = _breaker_script(seed)

    def scenario(serving, _dc, _make):
        clock = FakeClock()
        br = serving._CircuitBreaker(3, 1.0, clock)
        seen = []
        for op in ops:
            if op[0] == "fail":
                out = br.record_failure()
            elif op[0] == "success":
                out = br.record_success()
            else:
                out = clock.advance(op[1])
            seen.append((op[0], out, br.state(), br.rejects_admission,
                         round(br.seconds_until_probe(), 9), br.opens))
        return seen

    seen = _side_by_side(scenario)
    states = {s[2] for s in seen}
    assert {0, 1} <= states  # the script opens the breaker and closes it


def test_breaker_cycle_through_the_static_server():
    """JAX's open -> half-open -> close cycle on the static server, on an
    injected clock: two failed batches open it, submit fails fast with a
    retriable CircuitOpenError and its reset hint, the half-open probe that
    fails reopens it, the one that succeeds closes it."""

    def scenario(serving, dc, make):
        state = {"broken": True}
        clock = FakeClock()

        def fn(model, ids, max_new_tokens=4, **kw):
            if state["broken"]:
                raise RuntimeError("backend down")
            return np.concatenate([ids, np.ones((ids.shape[0], max_new_tokens), np.int32)], axis=1)

        cfg = dc.ServingConfig(max_retries=0, breaker_threshold=2, breaker_reset_s=5.0,
                               max_batch_size=1, batch_window_s=0.0)
        seen = []
        with make(object(), cfg, generate_fn=fn, clock=clock, replica_id="r0") as srv:
            for _ in range(2):
                seen.append(_error(srv.submit(np.arange(3))))
            assert wait_until(lambda: srv._breaker.rejects_admission)
            try:
                srv.submit(np.arange(3))
            except Exception as exc:  # noqa: BLE001 - observed
                seen.append((type(exc).__name__, exc.retriable, exc.replica_id, exc.retry_after_s))
            seen.append(("health", srv.health()["breaker_state"]))
            clock.advance(5.0)
            seen.append(("health", srv.health()["breaker_state"]))  # half-open
            seen.append(_error(srv.submit(np.arange(3))))  # the probe fails: reopen
            assert wait_until(lambda: srv._breaker.rejects_admission)
            state["broken"] = False
            clock.advance(5.0)
            res = srv.submit(np.arange(3)).result(10)
            seen.append(("probe", res.tokens.tolist(), res.degraded, res.replica_id,
                         res.failover_count))
            seen.append(("health", srv.health()["breaker_state"]))
            seen.append(srv.submit(np.arange(3)).result(10).tokens.shape)
            seen.append({k: srv.metrics[k] for k in (
                "breaker_opens", "rejected_breaker", "batch_failures", "completed", "batches")})
        return seen

    seen = _side_by_side(scenario)
    assert seen[0] == ("BatchExecutionError", False, "r0")
    assert seen[2] == ("CircuitOpenError", True, "r0", 5.0)
    assert seen[3:5] == [("health", 1), ("health", 2)]
    assert seen[-1] == {"breaker_opens": 2, "rejected_breaker": 1, "batch_failures": 3,
                        "completed": 2, "batches": 2}


# ------------------------------------------------------------------- ladder
LADDER_CONFIGS = [
    dict(max_queue=10, degrade_queue_fraction=0.5, degrade_hard_fraction=0.9,
         degraded_max_new_tokens=4),
    dict(max_queue=7, degrade_queue_fraction=0.3, degrade_hard_fraction=0.3,
         degraded_max_new_tokens=1),
    dict(max_queue=256, degrade_queue_fraction=0.5, degrade_hard_fraction=0.8,
         degraded_max_new_tokens=16),
]


@pytest.mark.parametrize("knobs", LADDER_CONFIGS, ids=["q10", "q7", "default"])
def test_degrade_level_and_clamp_over_queue_depths(knobs):
    """``_degrade_level`` over every depth to the queue's bound and
    ``_clamp_budget`` at each level for budgets around the clamp, exactly
    the JAX server's."""
    depths = range(0, knobs["max_queue"] + 1)
    budgets = (1, 2, 3, 8, 16, 32, 100)

    def scenario(serving, dc, make):
        with make(object(), dc.ServingConfig(**knobs), generate_fn=echo_gen()) as srv:
            levels = [srv._degrade_level(d) for d in depths]
            clamps = []
            for level in (0, 1, 2):
                for budget in budgets:
                    req = serving._Request(
                        input_ids=np.arange(3, dtype=np.int32), max_new_tokens=budget,
                        deadline=None, temperature=0.0, top_k=None, top_p=None, eos_token_id=None,
                        pad_token_id=None, seed=0, submitted_at=0.0)
                    srv._clamp_budget(req, level)
                    clamps.append((level, budget, req.effective_max_new_tokens, req.degraded))
            hints = [round(srv._retry_after_hint(d), 9) for d in depths]
        return levels, clamps, hints

    levels, clamps, _ = _side_by_side(scenario)
    assert levels[0] == 0 and levels[-1] == 2


def test_pressure_clamps_static_budgets_before_shedding():
    """JAX's pressure test: a gated batch holds the worker while six
    requests queue past the 50% watermark; the budgets clamp (to
    ``degraded_max_new_tokens``) before anything is shed."""

    def scenario(serving, dc, make):
        gate = threading.Event()
        batches = []

        def gated(model, ids, max_new_tokens=4, **kw):
            if gate.is_set():
                batches.append((ids.shape[0], max_new_tokens))
            else:
                gate.wait(10)
            return np.concatenate([ids, np.ones((ids.shape[0], max_new_tokens), np.int32)], axis=1)

        cfg = dc.ServingConfig(max_queue=10, degrade_queue_fraction=0.5, degrade_hard_fraction=0.9,
                               degraded_max_new_tokens=4, max_batch_size=8, batch_window_s=0.0)
        with make(object(), cfg, generate_fn=gated) as srv:
            blocker = srv.submit(np.arange(3), max_new_tokens=32)
            assert wait_until(lambda: srv.queue_depth() == 0)
            futs = [srv.submit(np.arange(3), max_new_tokens=32) for _ in range(6)]
            gate.set()
            results = [f.result(10) for f in futs]
            blocker.result(10)
            counts = {k: srv.metrics[k] for k in ("degraded", "shed_deadline", "rejected_queue_full",
                                                  "completed")}
        return (batches, [(r.degraded, r.decode_steps, len(r.tokens)) for r in results], counts)

    batches, results, counts = _side_by_side(scenario)
    assert any(budget == 4 for _, budget in batches)
    assert counts == {"degraded": 2, "shed_deadline": 0, "rejected_queue_full": 0, "completed": 7}


def test_serving_result_fields_are_the_jax_packages():
    ours = [(f.name, f.default) for f in dataclasses.fields(tserving.ServingResult)]
    theirs = [(f.name, f.default) for f in dataclasses.fields(jserving.ServingResult)]
    assert ours == theirs
    assert tserving.ServingMetrics._COUNTERS == jserving.ServingMetrics._COUNTERS


# --------------------------------------------------------- health, metrics
class _Tracker:
    name = "collect"

    def __init__(self):
        self.entries = []

    def log_batch(self, entries):
        self.entries.extend(entries)


def _serving_keys(snap):
    # serving/engine/... folds each package's engine.stats() (the port's has
    # keys of its own); perf/... is the process's observatory
    return sorted(k for k in snap if k.startswith("serving/") and not k.startswith("serving/engine/"))


def test_health_snapshot_and_tracker_flushes_static():
    """``health()`` and ``metrics_snapshot()`` keys and values, and the
    periodic tracker flush on an injected clock: one flush per
    ``metrics_interval_s`` the clock passes, one forced at close."""

    def scenario(serving, dc, make):
        clock = FakeClock()
        tracker = _Tracker()
        cfg = dc.ServingConfig(metrics_interval_s=2.0, max_queue=8, batch_window_s=0.0)
        srv = make(object(), cfg, generate_fn=echo_gen(), clock=clock, trackers=[tracker],
                   replica_id="r1")
        try:
            for i in range(3):
                srv.submit(np.full(4, i + 1), max_new_tokens=2).result(10)
            health = srv.health()
            flushes = [len(tracker.entries)]
            clock.advance(2.5)
            assert wait_until(lambda: len(tracker.entries) > flushes[0])
            flushes.append(len(tracker.entries))
            time.sleep(0.15)  # a few idle wakes: no second flush before the interval
            flushes.append(len(tracker.entries))
            snap = srv.metrics_snapshot()
            logged = srv.log_metrics(step=3)
        finally:
            srv.close()
        values, step, _ = tracker.entries[-1]
        latency_keys = sorted(k for k in snap if k.startswith("serving/latency"))
        return dict(
            health={k: v for k, v in health.items() if k != "batch_ewma_s"},
            health_keys=sorted(health), flushes=flushes, total=len(tracker.entries),
            keys=_serving_keys(snap), latency_keys=latency_keys,
            counters={k: snap[k] for k in ("serving/submitted", "serving/completed",
                                           "serving/batches", "serving/queue_depth",
                                           "serving/breaker_state")},
            logged=logged["serving/completed"], last_step=step,
            last_keys=_serving_keys(values),
        )

    seen = _side_by_side(scenario)
    # one periodic flush, then log_metrics's, the worker's at its end and
    # close()'s
    assert seen["flushes"] == [0, 1, 1] and seen["total"] == 4
    assert seen["health"]["replica_id"] == "r1" and seen["health"]["worker_alive"]
    assert seen["counters"]["serving/completed"] == 3


# ----------------------------------------------------------- continuous mode
@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JLlamaConfig.tiny(compute_dtype=jnp.float32), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32)
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return {"jax": jmodel, "torch": LlamaForCausalLM(tcfg, params)}


def _continuous_cfg(dc, **kw):
    return dc.ServingConfig(**{**dict(
        mode="continuous", engine_slots=1, engine_max_len=64, engine_prompt_bucket=16,
        engine_readback_lag=0, kv_cache="paged", engine_block_size=8), **kw})


# prompts whose greedy continuations the n-gram drafter can match
SPEC_PROMPTS = [np.asarray([7, 8, 9, 7, 8, 9, 7, 8], np.int32),
                np.asarray([3, 4, 3, 4, 3, 4, 3, 4, 3], np.int32),
                np.asarray([11, 12, 13, 11, 12, 13], np.int32),
                np.asarray([5, 17, 33, 2, 9], np.int32)]


def test_continuous_ladder_and_spec_rung_match_jax(models):
    """One slot, a held first step, and three requests queued behind it
    (3 of 4 places: the hard rung). JAX's ``set_spec_draft_limit`` calls
    (the ladder's first rung), each request's clamped budget, its greedy
    tokens (bitwise), the counters and the metric keys must be the port's."""

    def scenario(serving, dc, make):
        side = "jax" if serving is jserving else "torch"
        cfg = _continuous_cfg(dc, speculative="ngram", spec_draft_len=4, max_queue=4,
                              degrade_queue_fraction=0.5, degrade_hard_fraction=0.75,
                              degraded_max_new_tokens=4)
        srv = make(models[side], cfg)
        eng = srv.engine
        limits = []
        real_limit, real_step = eng.set_spec_draft_limit, eng.step
        gate, entered = threading.Event(), threading.Event()

        def record_limit(n):
            limits.append(int(n))
            return real_limit(n)

        def held_step():
            entered.set()
            gate.wait(30)
            return real_step()

        eng.set_spec_draft_limit = record_limit
        eng.step = held_step
        try:
            first = srv.submit(SPEC_PROMPTS[0], max_new_tokens=12)
            assert entered.wait(60)  # the first tick is inside its step
            futs = [first] + [srv.submit(p, max_new_tokens=12) for p in SPEC_PROMPTS[1:]]
            gate.set()
            results = [f.result(120) for f in futs]
            snap = srv.metrics_snapshot()
            health = srv.health()
        finally:
            gate.set()
            srv.close()
        return dict(
            limits=limits,
            results=[(r.tokens.tolist(), r.degraded, r.decode_steps, r.replica_id,
                      r.failover_count) for r in results],
            counters={k: srv.metrics[k] for k in ("degraded", "engine_inserts", "completed",
                                                  "engine_retired", "shed_deadline")},
            keys=_serving_keys(snap),
            health=sorted(health), inflight=health["inflight"],
        )

    seen = _side_by_side(scenario)
    assert 0 in seen["limits"] and 4 in seen["limits"]  # drafting stopped, then restored
    # admitted at depths 3 and 2 of 4 (hard and soft rungs), then at 1
    assert [r[1] for r in seen["results"]] == [False, True, True, False]
    assert seen["counters"]["degraded"] == 2 and seen["counters"]["completed"] == 4


def test_continuous_breaker_opens_on_engine_failures_and_probe_closes(models):
    """Two failed engine steps (threshold 2) fail their requests and open
    the breaker; submit then raises CircuitOpenError; after the reset window
    (injected clock) the half-open probe admits one request, which
    completes with JAX's greedy tokens and closes the breaker."""

    def scenario(serving, dc, make):
        side = "jax" if serving is jserving else "torch"
        clock = FakeClock()
        cfg = _continuous_cfg(dc, breaker_threshold=2, breaker_reset_s=3.0)
        srv = make(models[side], cfg, clock=clock, replica_id="c0")
        eng = srv.engine
        real_step = eng.step
        fails = {"left": 2}

        def flaky_step():
            if fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("device lost")
            return real_step()

        eng.step = flaky_step
        seen = []
        try:
            for _ in range(2):
                seen.append(_error(srv.submit(SPEC_PROMPTS[3], max_new_tokens=5)))
            assert wait_until(lambda: srv._breaker.rejects_admission)
            try:
                srv.submit(SPEC_PROMPTS[3], max_new_tokens=5)
            except Exception as exc:  # noqa: BLE001 - observed
                seen.append((type(exc).__name__, exc.retriable, exc.retry_after_s))
            clock.advance(3.0)
            seen.append(srv.health()["breaker_state"])
            res = srv.submit(SPEC_PROMPTS[3], max_new_tokens=5).result(60)
            seen.append((res.tokens.tolist(), res.replica_id))
            seen.append(srv.health()["breaker_state"])
            seen.append({k: srv.metrics[k] for k in ("breaker_opens", "rejected_breaker",
                                                     "batch_failures", "completed")})
        finally:
            srv.close()
        return seen

    seen = _side_by_side(scenario)
    assert seen[0] == ("BatchExecutionError", False, "c0")
    assert seen[2] == ("CircuitOpenError", True, 3.0)
    assert seen[3] == 2 and seen[5] == 0
