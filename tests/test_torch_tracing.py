"""The port's span tracer, flight recorder and metrics registry beside the
JAX package's (``accelerate_tpu_torch/tracing.py``).

Each case runs one scenario on both packages' tracers (each configured
with its own private ``TracingConfig``, dumping into ``tmp_path``) and
compares what they recorded, bitwise: span names, the tree their nesting
makes, attributes other than times, ring drop counts, the flight dump's
JSON schema and event names, and registry snapshots. The request trace
runs through a ``FleetRouter`` over one continuous server of a tiny Llama
(2 layers, hidden 64, float32, the JAX model's weights): the port's tree
from ``fleet.submit`` to ``engine.retire`` must be JAX's.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import fleet as jfleet
from accelerate_tpu import serving as jserving
from accelerate_tpu import tracing as jtracing
from accelerate_tpu.models.llama import LlamaConfig as JLlamaConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import fleet as tfleet
from accelerate_tpu_torch import serving as tserving
from accelerate_tpu_torch import tracing as ttracing
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.utils import dataclasses as tdc

SIDES = {"jax": (jtracing, jdc, jserving, jfleet), "torch": (ttracing, tdc, tserving, tfleet)}


def _side_by_side(scenario):
    seen = {name: scenario(*SIDES[name]) for name in ("jax", "torch")}
    assert seen["torch"] == seen["jax"]
    return seen["torch"]


@pytest.fixture
def configured(tmp_path):
    """Each package's default tracer enabled, dumping under its own
    directory of ``tmp_path``; the previous defaults come back after."""
    prev = {name: side[0].get_tracer().config for name, side in SIDES.items()}

    def configure(tracing, dc, **kw):
        sub = tmp_path / ("jax" if tracing is jtracing else "torch")
        sub.mkdir(exist_ok=True)
        cfg = dict(enabled=True, ring_capacity=4096, retain_s=60.0, dump_dir=str(sub), max_dumps=4)
        cfg.update(kw)
        return tracing.configure(dc.TracingConfig(**cfg)), sub

    yield configure
    for name, side in SIDES.items():
        side[0].configure(prev[name])


def _server(serving, dc, model, **kw):
    if serving is tserving:
        kw["device"] = "cpu"
    return serving.InferenceServer(model, kw.pop("config"), **kw)


def _tree(spans):
    """(name, parent name, thread index) for each span, oldest first: the
    parent is the latest-opened span of the same thread that encloses it
    (spans nest by their ``with`` blocks); threads are numbered in the order
    their first span opened."""
    spans = sorted(spans, key=lambda s: (s.t0, -s.t1))
    threads = {}
    out = []
    for i, sp in enumerate(spans):
        threads.setdefault(sp.tid, len(threads))
        parent = None
        for other in reversed(spans[:i]):
            if other.tid == sp.tid and other.t0 <= sp.t0 and sp.t1 <= other.t1:
                parent = other.name
                break
        out.append((sp.name, parent, threads[sp.tid]))
    return out


# --------------------------------------------------------- one request's tree
@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JLlamaConfig.tiny(compute_dtype=jnp.float32), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32)
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return {"jax": jmodel, "torch": LlamaForCausalLM(tcfg, params)}


def test_request_span_tree_from_fleet_submit_to_retire(configured, models):
    """One greedy request through a fleet of one continuous replica: the
    spans under its trace id (names, parents, threads, the attributes other
    than times), the sampled decode-step spans (every step, at
    ``decode_sample_every=1``) and the tokens are the JAX package's."""

    def scenario(tracing, dc, serving, fleet):
        side = "jax" if tracing is jtracing else "torch"
        tracer, _ = configured(tracing, dc, decode_sample_every=1)
        cfg = dc.ServingConfig(mode="continuous", engine_slots=2, engine_max_len=64,
                               engine_prompt_bucket=16, engine_readback_lag=0, kv_cache="paged",
                               engine_block_size=8)
        srv = _server(serving, dc, models[side], config=cfg, replica_id="r0")
        router = fleet.FleetRouter({"r0": srv}, dc.FleetConfig(probe_interval_s=5.0))
        try:
            res = router.submit(np.asarray([5, 17, 33, 2, 9], np.int32),
                                max_new_tokens=6).result(60)
        finally:
            router.close()
        tids = {s.trace_id for s in tracer.spans(name="fleet.submit")}
        assert len(tids) == 1 and None not in tids
        (tid,) = tids
        trace = tracer.spans(trace_id=tid)
        attrs = {s.name: {k: v for k, v in s.attrs.items() if not k.endswith("_s")} for s in trace}
        decode = tracer.spans(name="engine.decode_step")
        return dict(tree=_tree(trace), attrs=attrs, tokens=res.tokens.tolist(),
                    decode_steps=len(decode), decode_live=[s.attrs["live"] for s in decode],
                    dropped=tracer.dropped_spans())

    seen = _side_by_side(scenario)
    names = [n for n, _, _ in seen["tree"]]
    assert names[0] == "fleet.submit" and names[-1] == "engine.retire"
    assert ("fleet.dispatch", "fleet.submit", 0) in seen["tree"]
    assert ("engine.prefill", "serving.admit", 1) in seen["tree"]
    assert seen["decode_steps"] == 5 and seen["dropped"] == 0


def test_failover_is_one_trace_with_both_dispatches(configured):
    """JAX's failover trace: r0's worker dies mid-batch; the moved request's
    trace holds the dispatch to r0, the typed failover decision (its error
    event: type, retriable, replica) and the dispatch to r1."""

    def scenario(tracing, dc, serving, fleet):
        tracer, _ = configured(tracing, dc)
        kill = threading.Event()
        kill.set()

        def killable(model, ids, max_new_tokens=8, **kw):
            if kill.is_set():
                kill.clear()
                raise SystemExit(1)
            return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)

        def echo(model, ids, max_new_tokens=8, **kw):
            return np.concatenate([ids, np.repeat(ids[:, :1], max_new_tokens, axis=1)], axis=1)

        cfg = dc.ServingConfig(max_batch_size=1, batch_window_s=0.0, max_retries=0)
        servers = {"r0": _server(serving, dc, object(), config=cfg, generate_fn=killable,
                                 replica_id="r0"),
                   "r1": _server(serving, dc, object(), config=cfg, generate_fn=echo,
                                 replica_id="r1")}
        router = fleet.FleetRouter(servers, dc.FleetConfig(probe_interval_s=5.0,
                                                           placement="round_robin"))
        try:
            # round robin starts at the second candidate: the first request
            # goes to r1, the second to r0, whose worker dies
            results = [router.submit(np.arange(1, 6), max_new_tokens=2).result(30)
                       for _ in range(2)]
        finally:
            router.close(drain=False)
        (failover,) = tracer.spans(name="fleet.failover")
        trace = tracer.spans(trace_id=failover.trace_id)
        events = [(n, a) for _, n, a in failover.events]
        return dict(
            served=[(r.replica_id, r.failover_count) for r in results],
            names=[s.name for s in trace if s.name.startswith("fleet.")],
            replicas=[s.attrs.get("replica") for s in trace if s.name == "fleet.dispatch"],
            outcome=failover.attrs["outcome"], events=events,
        )

    seen = _side_by_side(scenario)
    assert seen["served"] == [("r1", 0), ("r1", 1)]
    assert seen["replicas"] == ["r0", "r1"] and seen["outcome"] == "resubmitted"
    assert seen["events"][0] == ("error", {"type": "ReplicaDeadError", "retriable": True,
                                           "replica_id": "r0", "cause": "SystemExit"})


# ------------------------------------------------------------- flight dumps
def _schema(node):
    """A JSON document's shape: dict keys and value types, recursively (one
    list element stands for all)."""
    if isinstance(node, dict):
        return {k: _schema(v) for k, v in sorted(node.items())}
    if isinstance(node, list):
        return [_schema(node[0])] if node else []
    return type(node).__name__


def test_worker_death_dump_schema_and_events(configured):
    """A static server's worker dies mid-batch: the flight dump it writes
    has JAX's schema (keys and value types of the document, an ``X`` event
    and an ``i`` event), its reason, and the same events in the same order
    (the batch span, its SystemExit error event, thread metadata)."""

    def scenario(tracing, dc, serving, fleet):
        tracer, sub = configured(tracing, dc)

        def dying(model, ids, max_new_tokens=8, **kw):
            raise SystemExit(1)

        cfg = dc.ServingConfig(max_batch_size=1, batch_window_s=0.0)
        srv = _server(serving, dc, object(), config=cfg, generate_fn=dying)
        try:
            err = srv.submit(np.arange(1, 6), max_new_tokens=2).exception(30)
            srv._worker.join(10)
        finally:
            srv.close()
        (name,) = [f for f in os.listdir(sub) if f.startswith("flight-worker_death-")]
        doc = json.loads((sub / name).read_text())
        events = doc["traceEvents"]
        by_ph = {ph: _schema(next(e for e in events if e["ph"] == ph)) for ph in ("M", "X", "i")}
        top = _schema({k: v for k, v in doc.items() if k != "traceEvents"})
        return dict(error=type(err).__name__, top=top, by_ph=by_ph,
                    names=[(e["ph"], e["name"]) for e in events],
                    reason=doc["otherData"]["reason"],
                    error_args={k: v for k, v in next(e for e in events if e["ph"] == "i")[
                        "args"].items() if k != "trace_id"})

    seen = _side_by_side(scenario)
    assert seen["reason"] == "worker_death" and seen["error"] == "ReplicaDeadError"
    assert seen["error_args"]["type"] == "SystemExit"


@pytest.mark.parametrize("reason", ["budget", "sigusr1"])
def test_dump_budget_and_document(configured, reason):
    def scenario(tracing, dc, serving, fleet):
        tracer, sub = configured(tracing, dc)
        with tracer.span("outer", "t1", k=1) as sp:
            sp.event("mark", n=2)
            with tracer.span("inner", "t1"):
                pass
        paths = [tracer.dump(reason) for _ in range(6)]
        doc = json.loads(open(paths[0]).read())
        strip = [{k: v for k, v in e.items() if k not in ("ts", "dur", "tid", "pid")}
                 for e in doc["traceEvents"]]
        return dict(written=sum(p is not None for p in paths), files=len(os.listdir(sub)),
                    events=strip, other=sorted(doc["otherData"]))

    seen = _side_by_side(scenario)
    assert seen["written"] == 4 and seen["files"] == 4


# ------------------------------------------------------------ ring and no-op
@pytest.mark.parametrize("n", [10, 16, 40, 100])
def test_ring_drops_oldest_and_counts(n):
    def scenario(tracing, dc, serving, fleet):
        t = tracing.Tracer(dc.TracingConfig(enabled=True, ring_capacity=16))
        for i in range(n):
            with t.span("s", None, i=i):
                pass
        return t.dropped_spans(), sorted(s.attrs["i"] for s in t.spans(name="s"))

    dropped, kept = _side_by_side(scenario)
    assert dropped == max(0, n - 16) and kept == list(range(max(0, n - 16), n))


def test_disabled_tracer_is_one_shared_noop(tmp_path):
    """A disabled span is one attribute check: every call hands back the one
    shared context manager, records nothing and never dumps; a sampled
    ``step_span`` off its period is that object too."""

    def scenario(tracing, dc, serving, fleet):
        t = tracing.Tracer(dc.TracingConfig(enabled=False, dump_dir=str(tmp_path)))
        cms = {id(t.span("a")), id(t.span("b", "tid", k=1))}
        with t.span("a") as sp:
            sp.set("k", 1)
            sp.event("e")
        prev = tracing.get_tracer().config
        tracing.configure(dc.TracingConfig(enabled=True, decode_sample_every=4,
                                           dump_dir=str(tmp_path)))
        try:
            for step in range(8):
                with tracing.step_span("hot", step):
                    pass
            sampled = len(tracing.get_tracer().spans(name="hot"))
            shared = tracing.step_span("hot", 1) is tracing.step_span("hot", 2)
        finally:
            tracing.configure(prev)
        return dict(cms=len(cms), spans=t.spans(), dropped=t.dropped_spans(),
                    dump=t.dump("x"), maybe=t.maybe_dump("x"), sampled=sampled, shared=shared,
                    noop=type(t.span("a")).__name__)

    seen = _side_by_side(scenario)
    assert seen["cms"] == 1 and seen["sampled"] == 2 and seen["shared"]
    assert os.listdir(tmp_path) == []
    assert ttracing.Tracer(tdc.TracingConfig(enabled=False)).span("a") is ttracing._NULL_CM


def test_span_records_exception_as_typed_event():
    def scenario(tracing, dc, serving, fleet):
        t = tracing.Tracer(dc.TracingConfig(enabled=True))
        with pytest.raises(serving.ServerDrainingError if hasattr(serving, "ServerDrainingError")
                           else Exception):
            with t.span("boom"):
                raise serving.ServerDrainingError("gone", replica_id="r9")
        (sp,) = t.spans(name="boom")
        return [(n, a) for _, n, a in sp.events]

    (event,) = _side_by_side(scenario)
    assert event == ("error", {"type": "ServerDrainingError", "retriable": True,
                               "replica_id": "r9", "cause": None})


# --------------------------------------------------------- metrics registry
class _Tracker:
    name = "fake"

    def __init__(self):
        self.batches = []

    def log_batch(self, entries):
        self.batches.append(entries)


def test_registry_snapshot_ingest_and_flush():
    def scenario(tracing, dc, serving, fleet):
        clock = [100.0]
        reg = tracing.MetricsRegistry(prefix="t/", counters=("a",), clock=lambda: clock[0])
        reg.bump("a")
        reg.bump("a", 2)
        reg.gauge("g", 1.5)
        reg.ingest({"kv": {"hbm_bytes": 42, "blocks": {"free": 7}}, "live": 3, "note": "x"},
                   prefix="engine")
        for v in range(100):
            reg.observe("lat", v / 100.0)
        tracker = _Tracker()
        flow = [reg.due(5.0), reg.maybe_flush([tracker], 5.0)]
        clock[0] += 6.0
        flow += [reg.due(5.0), reg.maybe_flush([tracker], 5.0, step=7), reg.due(5.0),
                 reg.due(None)]
        (values, step, _), = tracker.batches[0]
        return reg.snapshot(), reg.counters(), flow, step, sorted(values)

    snap, counters, flow, step, keys = _side_by_side(scenario)
    assert snap["t/a"] == 3 and snap["t/engine/kv/blocks/free"] == 7
    assert flow == [False, False, True, True, False, False] and step == 7


def test_trace_ids_are_process_unique():
    ids = [ttracing.new_trace_id() for _ in range(100)]
    assert len(set(ids)) == 100 and all(i.startswith(f"t{os.getpid():x}-") for i in ids)
    env = ttracing._env_config()
    assert env.enabled == jtracing._env_config().enabled
