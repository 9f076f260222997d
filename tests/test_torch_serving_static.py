"""The port's static-mode ``InferenceServer`` beside the JAX package's.

Each case is one of the JAX static-mode serving tests
(``tests/test_serving.py``) written as a scenario that runs against a
server class and returns what it observed: the batch shapes the executor
saw, which request got which row, the typed errors, the counters and the
``ServingResult`` fields other than times. The scenario runs on the JAX
server and on the port's with the same fake ``generate_fn``; the two
observations must be equal, and the port's must hold the JAX test's own
claims. Time-based windows make exact batch counts depend on the host's
scheduling, so the cases hold what the JAX tests hold (rows route back,
power-of-two padding, incompatible heads split), not wall times.
"""

import threading
import time

import numpy as np
import pytest
import torch

from accelerate_tpu.serving import InferenceServer as JServer
from accelerate_tpu.utils.dataclasses import ServingConfig as JConfig
from accelerate_tpu_torch.serving import InferenceServer, ServingResult
from accelerate_tpu_torch.utils.dataclasses import ServingConfig


def _jax_server(model, cfg, **kw):
    return JServer(model, cfg, **kw)


def _torch_server(model, cfg, **kw):
    return InferenceServer(model, cfg, device="cpu", **kw)


SIDES = {"jax": (_jax_server, JConfig), "torch": (_torch_server, ServingConfig)}


def _side_by_side(scenario):
    """``scenario(make_server, config_cls)`` on both servers; returns the
    port's observation after asserting it equals the JAX server's."""
    seen = {name: scenario(*SIDES[name]) for name in ("jax", "torch")}
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


def echo_gen(batches=None, delay=0.0):
    """Fake generate_fn: appends ``max_new_tokens`` copies of each row's
    first token; records every executed batch's (shape, budget)."""

    def fn(model, ids, max_new_tokens=8, **kw):
        if batches is not None:
            batches.append((ids.shape, max_new_tokens))
        if delay:
            time.sleep(delay)
        return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)

    return fn


def gated_gen(gate):
    def fn(model, ids, max_new_tokens=4, **kw):
        gate.wait(10)
        return np.concatenate([ids, np.ones((ids.shape[0], max_new_tokens), np.int32)], axis=1)

    return fn


def wait_until(predicate, timeout=5.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


def _error(future, timeout=5):
    """The type name and retriability of the error a future ends with."""
    exc = future.exception(timeout)
    return None if exc is None else (type(exc).__name__, getattr(exc, "retriable", None))


def _result(res):
    """A ServingResult's fields other than times, and its time invariants."""
    return dict(tokens=res.tokens.tolist(), batch_size=res.batch_size,
                decode_steps=res.decode_steps, ttft_is_latency=res.ttft_s == res.latency_s,
                queue_wait_ok=res.queue_wait_s is not None and 0.0 <= res.queue_wait_s <= res.latency_s)


def _counts(srv, *names):
    return {name: srv.metrics[name] for name in names}


# ------------------------------------------------------------------ batching
def test_batches_coalesce_and_rows_route_back():
    def scenario(make, Config):
        batches = []
        cfg = Config(max_batch_size=4, batch_window_s=0.05, batch_bucket=False)
        with make(object(), cfg, generate_fn=echo_gen(batches)) as srv:
            futs = [srv.submit(np.full(5, i, dtype=np.int32), max_new_tokens=3) for i in range(4)]
            results = [f.result(5) for f in futs]
        return dict(batches=batches, results=[_result(r) for r in results],
                    counts=_counts(srv, "completed", "batches"))

    seen = _side_by_side(scenario)
    assert seen["batches"] == [((4, 5), 3)]  # one batch, each request its own row
    for i, res in enumerate(seen["results"]):
        assert res == dict(tokens=[i] * 8, batch_size=4, decode_steps=3, ttft_is_latency=True,
                           queue_wait_ok=True)
    assert seen["counts"] == {"completed": 4, "batches": 1}


def test_batch_rows_padded_to_pow2_bucket():
    def scenario(make, Config):
        batches = []
        cfg = Config(max_batch_size=8, batch_window_s=0.05)
        with make(object(), cfg, generate_fn=echo_gen(batches)) as srv:
            futs = [srv.submit(np.arange(4), max_new_tokens=2) for _ in range(3)]
            results = [f.result(5) for f in futs]
        return dict(batches=batches, sizes=[r.batch_size for r in results],
                    counts=_counts(srv, "completed"))

    seen = _side_by_side(scenario)
    # 3 live rows run as a 4-row bucket, and only the live rows reply
    assert seen == dict(batches=[((4, 4), 2)], sizes=[3, 3, 3], counts={"completed": 3})


def test_incompatible_requests_split_batches():
    def scenario(make, Config):
        batches = []
        cfg = Config(max_batch_size=8, batch_window_s=0.05, batch_bucket=False)
        with make(object(), cfg, generate_fn=echo_gen(batches)) as srv:
            f1 = srv.submit(np.arange(4), max_new_tokens=2)
            f2 = srv.submit(np.arange(6), max_new_tokens=2)  # another prompt length
            rows = [f1.result(5).tokens.tolist(), f2.result(5).tokens.tolist()]
        return dict(batches=sorted(batches), rows=rows)

    seen = _side_by_side(scenario)
    assert seen["batches"] == [((1, 4), 2), ((1, 6), 2)]
    assert seen["rows"] == [[0, 1, 2, 3, 0, 0], [0, 1, 2, 3, 4, 5, 0, 0]]


def test_sampled_requests_batch_only_with_matching_seed():
    def scenario(make, Config):
        gate = threading.Event()
        recorded = []

        def fn(model, ids, max_new_tokens=4, seed=0, **kw):
            if not gate.is_set():
                gate.wait(10)
            recorded.append((ids.shape[0], seed))
            return np.concatenate([ids, np.ones((ids.shape[0], max_new_tokens), np.int32)], axis=1)

        cfg = Config(max_batch_size=4, batch_window_s=0.0, batch_bucket=False)
        srv = make(object(), cfg, generate_fn=fn)
        try:
            blocker = srv.submit(np.arange(4))
            assert wait_until(lambda: srv.queue_depth() == 0)
            futs = [srv.submit(np.arange(4), temperature=0.7, seed=1),
                    srv.submit(np.arange(4), temperature=0.7, seed=1),
                    srv.submit(np.arange(4), temperature=0.7, seed=2),
                    srv.submit(np.arange(4), seed=5),  # greedy: the seed is not read
                    srv.submit(np.arange(4), seed=6)]
            gate.set()
            blocker.result(5)
            sizes = [f.result(5).batch_size for f in futs]
        finally:
            gate.set()
            srv.close()
        return dict(recorded=recorded[1:], sizes=sizes)

    seen = _side_by_side(scenario)
    assert seen == dict(recorded=[(2, 1), (1, 2), (2, 5)], sizes=[2, 2, 1, 2, 2])


# -------------------------------------------------------------- backpressure
def test_queue_full_rejects_with_typed_error():
    def scenario(make, Config):
        gate = threading.Event()
        srv = make(object(), Config(max_queue=2, max_batch_size=1, batch_window_s=0.0),
                   generate_fn=gated_gen(gate))
        try:
            first = srv.submit(np.arange(3))
            assert wait_until(lambda: srv.queue_depth() == 0)  # `first` is in flight
            queued = [srv.submit(np.arange(3)) for _ in range(2)]
            try:
                srv.submit(np.arange(3))
                overload = None
            except Exception as exc:  # noqa: BLE001 - compared below
                overload = (type(exc).__name__, exc.retriable)
            gate.set()
            # a full queue is full occupancy: the degradation ladder may
            # clamp the budgets, but every admitted request completes
            completed = [f.result(5).tokens.shape[0] >= 3 for f in [first, *queued]]
        finally:
            gate.set()
            srv.close()
        return dict(overload=overload, completed=completed,
                    counts=_counts(srv, "rejected_queue_full", "completed"))

    seen = _side_by_side(scenario)
    assert seen == dict(overload=("ServerOverloaded", True), completed=[True] * 3,
                        counts={"rejected_queue_full": 1, "completed": 3})


def test_submit_validates_shapes():
    def scenario(make, Config):
        errors = []
        with make(object(), Config(), generate_fn=echo_gen()) as srv:
            for bad in (np.zeros((2, 4), np.int32), np.zeros((0,), np.int32)):
                with pytest.raises(ValueError):
                    srv.submit(bad)
                errors.append("ValueError")
            res = srv.submit(np.zeros((1, 4), np.int32)).result(5)  # a (1, L) prompt
        return dict(errors=errors, result=_result(res), engine=srv.engine)

    seen = _side_by_side(scenario)
    assert seen["result"]["tokens"] == [0] * 36 and seen["engine"] is None


def test_serving_config_validation_equals_jax():
    bad = [dict(mode="batch"), dict(max_queue=0), dict(max_batch_size=0), dict(max_retries=-1),
           dict(retry_backoff_s=1.0, retry_backoff_max_s=0.5), dict(retry_jitter=1.5),
           dict(batch_window_s=-1), dict(batch_window_s=11), dict(pad_total_multiple=0),
           dict(speculative="ngram"), dict(engine_prefill_chunk=16),
           dict(attention_impl="kernel", kv_cache="paged")]
    for kw in bad:
        jkw = {**kw, "attention_impl": "pallas"} if kw.get("attention_impl") else kw
        with pytest.raises(ValueError) as jerr:
            JConfig(**jkw)
        with pytest.raises(ValueError) as terr:
            ServingConfig(**kw)
        assert str(terr.value) == str(jerr.value).replace("pallas", "kernel"), kw
    assert ServingConfig().mode == JConfig().mode == "static"


# ------------------------------------------------------------------ deadlines
def test_deadline_shed_at_dequeue():
    def scenario(make, Config):
        gate = threading.Event()
        srv = make(object(), Config(max_batch_size=1, batch_window_s=0.0),
                   generate_fn=gated_gen(gate))
        try:
            blocker = srv.submit(np.arange(3))  # holds the worker
            assert wait_until(lambda: srv.queue_depth() == 0)
            doomed = srv.submit(np.arange(3), deadline_s=0.001)
            time.sleep(0.05)  # its deadline passes while it waits behind the blocker
            gate.set()
            err = _error(doomed)
            ok = blocker.result(5).tokens is not None
        finally:
            gate.set()
            srv.close()
        # the shed request never reached the executor
        return dict(err=err, ok=ok, counts=_counts(srv, "shed_deadline", "batches"))

    seen = _side_by_side(scenario)
    assert seen == dict(err=("RequestDeadlineExceeded", False), ok=True,
                        counts={"shed_deadline": 1, "batches": 1})


def test_deadline_enforced_at_completion():
    def scenario(make, Config):
        cfg = Config(max_batch_size=1, batch_window_s=0.0)
        with make(object(), cfg, generate_fn=echo_gen(delay=0.08)) as srv:
            # no batch time yet, so it is not shed at dequeue: it finishes late
            err = _error(srv.submit(np.arange(3), deadline_s=0.02))
        return dict(err=err, counts=_counts(srv, "completed_late", "completed"))

    seen = _side_by_side(scenario)
    assert seen == dict(err=("RequestDeadlineExceeded", False),
                        counts={"completed_late": 1, "completed": 0})


def test_cancelled_request_does_not_kill_worker():
    def scenario(make, Config):
        gate = threading.Event()
        srv = make(object(), Config(max_batch_size=1, batch_window_s=0.0),
                   generate_fn=gated_gen(gate))
        try:
            blocker = srv.submit(np.arange(3))
            assert wait_until(lambda: srv.queue_depth() == 0)
            doomed = srv.submit(np.arange(3), deadline_s=0.001)
            cancelled = doomed.cancel()  # the client gave up while it was queued
            time.sleep(0.05)
            gate.set()
            alive = [blocker.result(5).tokens is not None,
                     srv.submit(np.arange(3)).result(5).tokens is not None]
        finally:
            gate.set()
            srv.close()
        return dict(cancelled=cancelled, alive=alive, counts=_counts(srv, "shed_deadline"))

    seen = _side_by_side(scenario)
    assert seen == dict(cancelled=True, alive=[True, True], counts={"shed_deadline": 0})


# ---------------------------------------------------------------- retries
def test_retry_recovers_after_transient_failures():
    def scenario(make, Config):
        state = {"fails": 2}

        def flaky(model, ids, max_new_tokens=4, **kw):
            if state["fails"] > 0:
                state["fails"] -= 1
                raise RuntimeError("RESOURCE_EXHAUSTED: transient")
            return np.concatenate([ids, np.ones((ids.shape[0], max_new_tokens), np.int32)], axis=1)

        cfg = Config(max_retries=3, retry_backoff_s=0.002, retry_backoff_max_s=0.01)
        with make(object(), cfg, generate_fn=flaky) as srv:
            res = srv.submit(np.arange(3), max_new_tokens=4).result(5)
        return dict(result=_result(res),
                    counts=_counts(srv, "retries", "batch_failures", "completed", "batches"))

    seen = _side_by_side(scenario)
    assert seen["result"]["tokens"] == [0, 1, 2, 1, 1, 1, 1]
    assert seen["counts"] == {"retries": 2, "batch_failures": 2, "completed": 1, "batches": 1}


def test_retry_gives_up_after_budget():
    def scenario(make, Config):
        def broken(model, ids, **kw):
            raise RuntimeError("permanently broken")

        cfg = Config(max_retries=1, retry_backoff_s=0.002, retry_backoff_max_s=0.01)
        with make(object(), cfg, generate_fn=broken) as srv:
            exc = srv.submit(np.arange(3)).exception(5)
        return dict(err=(type(exc).__name__, exc.retriable, "2 attempt(s)" in str(exc),
                         type(exc.__cause__).__name__),
                    counts=_counts(srv, "retries", "batch_failures", "completed"))

    seen = _side_by_side(scenario)
    assert seen == dict(err=("BatchExecutionError", False, True, "RuntimeError"),
                        counts={"retries": 1, "batch_failures": 2, "completed": 0})


def test_failed_batches_retry_at_the_default_ladder():
    # at their defaults both servers retry a failed batch twice; the
    # breaker stays closed at 3 failures of 5
    def scenario(make, Config):
        calls = []

        def broken(model, ids, **kw):
            calls.append(ids.shape)
            raise RuntimeError("down")

        cfg = Config(retry_backoff_s=0.001, retry_backoff_max_s=0.002)
        with make(object(), cfg, generate_fn=broken) as srv:
            err = _error(srv.submit(np.arange(3)))
        return dict(calls=calls, err=err, counts=_counts(srv, "retries", "batch_failures"))

    seen = _side_by_side(scenario)
    assert seen == dict(calls=[(1, 3)] * 3, err=("BatchExecutionError", False),
                        counts={"retries": 2, "batch_failures": 3})


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_fails_fast_instead_of_hanging():
    def scenario(make, Config):
        def lethal(model, ids, **kw):
            raise SystemExit(3)  # not retried: it ends the worker thread

        srv = make(object(), Config(max_batch_size=1, batch_window_s=0.0), generate_fn=lethal)
        err = _error(srv.submit(np.arange(3)))
        assert srv._drained.wait(5)
        try:
            srv.submit(np.arange(3))
            late = None
        except Exception as exc:  # noqa: BLE001 - compared below
            late = (type(exc).__name__, exc.retriable, "worker died" in str(exc))
        return dict(err=err, late=late)

    seen = _side_by_side(scenario)
    assert seen == dict(err=("ReplicaDeadError", True), late=("ServerDrainingError", True, True))


# ------------------------------------------------------------------- drain
def test_drain_completes_inflight_and_rejects_queued():
    def scenario(make, Config):
        gate = threading.Event()
        srv = make(object(), Config(max_batch_size=1, batch_window_s=0.0, max_queue=16),
                   generate_fn=gated_gen(gate))
        inflight = srv.submit(np.arange(3))
        assert wait_until(lambda: srv.queue_depth() == 0)
        queued = [srv.submit(np.arange(3)) for _ in range(3)]
        t = threading.Thread(target=lambda: (time.sleep(0.05), gate.set()))
        t.start()
        drained = srv.close(drain=True, timeout=5)
        t.join()
        try:
            srv.submit(np.arange(3))
            late = None
        except Exception as exc:  # noqa: BLE001 - compared below
            late = type(exc).__name__
        return dict(drained=drained, inflight=inflight.result(1).tokens.shape,
                    queued=[_error(f, 1) for f in queued], late=late,
                    counts=_counts(srv, "rejected_draining"))

    seen = _side_by_side(scenario)
    assert seen == dict(drained=True, inflight=(35,), queued=[("ServerDrainingError", True)] * 3,
                        late="ServerDrainingError", counts={"rejected_draining": 4})


# ------------------------------------------------------------- real model
def test_real_model_end_to_end_matches_direct_generate():
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.inference import generate as jgenerate
    from accelerate_tpu.inference import generate_cache_stats as jstats
    from accelerate_tpu.models.llama import LlamaConfig as JLlama
    from accelerate_tpu.models.llama import create_llama
    from accelerate_tpu_torch.inference import generate, generate_cache_stats
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax

    jmodel = create_llama(JLlama.tiny(compute_dtype=jnp.float32), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32)
    tmodel = LlamaForCausalLM(
        tcfg, params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu"))
    prompts = np.random.default_rng(0).integers(0, 256, size=(2, 6)).astype(np.int32)
    models = {"jax": (jmodel, jgenerate, jstats), "torch": (tmodel, generate, generate_cache_stats)}

    def scenario(make, Config):
        model, gen, stats = models["jax" if make is _jax_server else "torch"]
        cfg = Config(max_batch_size=2, batch_window_s=0.5, pad_total_multiple=16, batch_bucket=True)
        with make(model, cfg) as srv:
            futs = [srv.submit(p, max_new_tokens=4) for p in prompts]
            results = [f.result(60) for f in futs]
        direct = np.asarray(gen(model, prompts, max_new_tokens=4, pad_to=16))
        rows = np.stack([r.tokens for r in results])
        return dict(rows=rows.tolist(), direct=direct.tolist(), results=[_result(r) for r in results],
                    batches=srv.metrics["batches"], programs=stats(model)["keys"])

    seen = _side_by_side(scenario)
    assert seen["rows"] == seen["direct"]  # each row is the direct generate's
    assert seen["batches"] == 1 and len(seen["programs"]) == 1  # one shared execution
    assert seen["results"][0]["batch_size"] == 2 and seen["results"][0]["decode_steps"] == 4


def test_default_server_is_static_and_checks_the_model_device():
    from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

    model = LlamaForCausalLM.from_seed(LlamaConfig.tiny(compute_dtype=torch.float32), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            InferenceServer(model)  # the card by default
    with InferenceServer(model, device="cpu") as srv:
        assert srv.config.mode == "static" and srv.engine is None
        res = srv.submit(np.arange(1, 5), max_new_tokens=3).result(60)
    assert isinstance(res, ServingResult) and res.tokens.shape == (7,)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="parameters are on"):
            InferenceServer(model, device="cuda")
