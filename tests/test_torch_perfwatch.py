"""The port's perf observatory beside the JAX package's
(``accelerate_tpu_torch/perfwatch.py``).

The same records, windows and clock go through both packages' ``PerfWatch``
over one synthetic baseline (an ``"h100"`` file: the port refuses any
other chip, and the JAX package is given the H100's peaks under that name
for the comparison); splits, EWMAs, medians, drift strikes, findings and
table rows must agree within 1e-12 relative (the same float operations in
the same order), Prometheus text byte for byte, and the exporter's bodies
on an ephemeral loopback port byte for byte. The engine's window
(``poll()``) bills the same programs the same number of calls as the JAX
engine's on a tiny Llama.
"""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import perfwatch as jperf
from accelerate_tpu import tracing as jtracing
from accelerate_tpu.analysis import lowering as jlowering
from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.models.llama import LlamaConfig as JLlamaConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import perfwatch as tperf
from accelerate_tpu_torch import tracing as ttracing
from accelerate_tpu_torch.engine import ContinuousBatchingEngine
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.utils import dataclasses as tdc

SIDES = {"jax": (jperf, jtracing, jdc), "torch": (tperf, ttracing, tdc)}


@pytest.fixture(autouse=True)
def jax_knows_the_card(monkeypatch):
    """The JAX package's roofline table gets the card's peaks under the
    port's name, so both packages compute measured MFU on one chip."""
    monkeypatch.setitem(jlowering.CHIPS, "h100", dict(tperf.CHIPS["h100"], ici_bw=0.0))


def _close(a, b):
    """Equal, floats within 1e-12 relative, recursively."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or abs(a - b) <= 1e-12 * max(abs(a), abs(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_close(x, y) for x, y in zip(a, b))
    return a == b


def _side_by_side(scenario):
    seen = {name: scenario(*SIDES[name]) for name in ("jax", "torch")}
    assert _close(seen["torch"], seen["jax"]), (seen["torch"], seen["jax"])
    return seen["torch"]


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


PROGRAMS = {
    "engine.paged/decode_step": {"predicted_s": 3e-3, "mfu": 0.2, "tok_s": 1000.0,
                                 "flops": 1e9, "bound": "hbm"},
    "engine.paged/prefill_insert": {"predicted_s": 1e-3, "mfu": 0.3, "flops": 5e8,
                                    "bound": "flops"},
}


def _baseline(tmp_path, chip="h100", programs=PROGRAMS, tolerance=0.05, name="baseline.json"):
    doc = {"tolerance": tolerance, "programs": programs}
    if chip is not None:
        doc["chip"] = chip
    path = tmp_path / name
    path.write_text(json.dumps(doc))
    return str(path)


@pytest.fixture
def tracers(tmp_path):
    """Both default tracers dump into tmp_path (the drift dumps)."""
    prev = {n: s[1].get_tracer().config for n, s in SIDES.items()}
    for name, (_, tracing, dc) in SIDES.items():
        (tmp_path / name).mkdir()
        tracing.configure(dc.TracingConfig(dump_dir=str(tmp_path / name), max_dumps=8))
    yield tmp_path
    for name, side in SIDES.items():
        side[1].configure(prev[name])


# --------------------------------------------------------------- windows
@pytest.mark.parametrize("counts,dt", [
    ({"decode_step": 2, "prefill_insert": 1}, 7e-3),
    ({"decode_step": 14, "prefill_insert": 2, "verify_step": 3}, 0.05),
    ({"decode_step": 1}, 2.5e-3),
    ({"prefill_chunk": 4, "decode_step": 0}, 0.01),
])
@pytest.mark.parametrize("with_baseline", [True, False], ids=["weighted", "equal"])
def test_record_window_splits(tmp_path, counts, dt, with_baseline):
    """A window's time split by the baseline's predictions (programs without
    one get nothing), or equally per call in measured-only mode."""
    path = _baseline(tmp_path) if with_baseline else None

    def scenario(perf, tracing, dc):
        w = perf.PerfWatch(dc.ObservabilityConfig(baseline_path=path or str(tmp_path / "none")),
                           clock=FakeClock())
        w.record_window("engine.paged", counts, dt)
        w.record_window("engine.paged", counts, dt / 2)
        return {p: w.measured(f"engine.paged/{p}") for p in sorted(counts)}

    seen = _side_by_side(scenario)
    if not with_baseline:
        live = [p for p, n in counts.items() if n]
        assert all(seen[p]["calls"] == 2 * counts[p] for p in live)


def test_table_statuses_and_roofline_columns(tmp_path):
    path = _baseline(tmp_path)

    def scenario(perf, tracing, dc):
        w = perf.PerfWatch(dc.ObservabilityConfig(baseline_path=path), clock=FakeClock())
        for _ in range(5):
            w.record("engine.paged/decode_step", 3e-3)
        w.record("serving.static/batch", 0.5)
        first = w.table()
        for _ in range(9):
            w.record("engine.paged/decode_step", 9e-3)
        snap = {k: v for k, v in w.snapshot().items() if "_p" not in k.split("/")[-1]}
        return first, w.table(), snap, w.drift_tolerance

    first, later, snap, tol = _side_by_side(scenario)
    rows = {r["program"]: r for r in first}
    assert rows["engine.paged/decode_step"]["status"] == "ok"
    assert rows["engine.paged/decode_step"]["measured_mfu"] == pytest.approx(
        tperf.predicted_mfu(1e9, 3e-3, chip="h100"))
    assert rows["serving.static/batch"]["status"] == "no-baseline"
    assert {r["program"]: r["status"] for r in later}["engine.paged/decode_step"] == "drift"
    assert tol == 0.05


# ----------------------------------------------------------- drift sentinel
@pytest.mark.parametrize("slowdown,consecutive", [(2.0, 2), (1.03, 1), (3.0, 3)])
def test_drift_strikes_findings_and_one_dump(tracers, slowdown, consecutive):
    path = _baseline(tracers)

    def scenario(perf, tracing, dc):
        clk = FakeClock()
        w = perf.PerfWatch(dc.ObservabilityConfig(
            baseline_path=path, drift_enabled=True, drift_min_samples=4,
            drift_consecutive=consecutive, drift_interval_s=1.0), clock=clk)
        strikes = []
        for _ in range(12):
            clk.advance(1.5)
            w.record("engine.paged/decode_step", 3e-3 * slowdown)
            strikes.append(dict(w._strikes))
        findings = [(type(e).__name__, e.program, e.measured_s, e.predicted_s, e.tolerance, str(e))
                    for e in w.drift_findings()]
        side = "jax" if perf is jperf else "torch"
        dumps = sorted(f.split("-")[0] for f in os.listdir(tracers / side))
        consumed = len(w.consume_drift_findings())
        return strikes, findings, dumps, consumed, len(w.drift_findings())

    strikes, findings, dumps, consumed, left = _side_by_side(scenario)
    if slowdown > 1.05:
        assert len(findings) == 1 and findings[0][0] == "PerfDriftError"
        assert dumps == ["flight", "perfdrift"] and consumed == 1 and left == 0
    else:
        assert findings == [] and dumps == []


# ------------------------------------------------------ Prometheus, exporter
SNAPSHOT = {
    "serving/completed": 7,
    "serving/latency_p50": 0.0123,
    "serving/breaker_state": 0.0,
    "serving/draining": False,
    "serving/mode": "continuous",
    "fleet/replica/r0/serving/completed": 3,
    'fleet/replica/we"ird\\id/health/queue_depth': 2,
    "perf/engine_paged/decode_step/ewma_s": 3.1e-05,
    "perf/x.y-z/w": 1e20,
    "fleet/replica/r1/perf/engine_paged/decode_step/ratio": 1.25,
}


def test_prometheus_text_byte_for_byte():
    assert tperf.prometheus_text(SNAPSHOT) == jperf.prometheus_text(SNAPSHOT)
    assert tperf.prometheus_text({}) == jperf.prometheus_text({})


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_exporter_on_an_ephemeral_loopback_port():
    def scenario(perf, tracing, dc):
        ex = perf.MetricsExporter(lambda: dict(SNAPSHOT), host="127.0.0.1", port=0)
        try:
            base = f"http://127.0.0.1:{ex.port}"
            out = [_get(base + p) for p in ("/metrics", "/snapshot.json", "/nope")]
        finally:
            ex.close()
        return out, ex._thread.is_alive()

    (metrics, snapshot, missing), alive = _side_by_side(scenario)
    assert metrics[0] == 200 and metrics[2].decode() == tperf.prometheus_text(SNAPSHOT)
    assert json.loads(snapshot[2]) == SNAPSHOT and missing[0] == 404 and not alive


def test_maybe_exporter_arming(monkeypatch):
    def scenario(perf, tracing, dc):
        monkeypatch.delenv(perf.METRICS_PORT_ENV, raising=False)
        off = perf.maybe_exporter(dict)
        monkeypatch.setenv(perf.METRICS_PORT_ENV, "not-a-port")
        bad = perf.maybe_exporter(dict)
        monkeypatch.setenv(perf.METRICS_PORT_ENV, "70000")
        huge = perf.maybe_exporter(dict)
        monkeypatch.delenv(perf.METRICS_PORT_ENV)
        return off, bad, huge, perf.METRICS_PORT_ENV, perf.PERFWATCH_ENV, perf.RING_KIND_PROGRAM

    assert _side_by_side(scenario)[:3] == (None, None, None)


# ----------------------------------------------------------------- refusals
@pytest.mark.parametrize("chip", ["v5p", "v5e", None])
def test_a_baseline_for_other_hardware_is_refused(tmp_path, chip):
    """A TPU's predictions (or a file naming no chip) are never read with
    the card's times: the port refuses the file where the watch is built,
    naming the chip. Its default is measured-only (no baseline at all)."""
    path = _baseline(tmp_path, chip=chip)
    with pytest.raises(ValueError, match=repr(chip)):
        tperf.PerfWatch(tdc.ObservabilityConfig(baseline_path=path))
    assert tdc.ObservabilityConfig().baseline_path is None
    assert tperf.PerfWatch().baseline() == {}
    # the JAX package's committed baseline is such a file
    jax_file = os.path.join(os.path.dirname(jperf.__file__), "..", "runs", "perf_baseline.json")
    if os.path.exists(jax_file) and chip == "v5p":
        with pytest.raises(ValueError, match="v5p"):
            tperf.PerfWatch(tdc.ObservabilityConfig(baseline_path=jax_file))


def test_missing_or_corrupt_baseline_is_measured_only(tmp_path):
    corrupt = tmp_path / "bad.json"
    corrupt.write_text("{not json")
    for path in (str(tmp_path / "absent.json"), str(corrupt)):
        w = tperf.PerfWatch(tdc.ObservabilityConfig(baseline_path=path))
        assert w.baseline() == {} and w.drift_tolerance == 0.05


# ------------------------------------------------------- the engine's window
@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JLlamaConfig.tiny(compute_dtype=jnp.float32), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32)
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def test_engine_poll_bills_the_jax_engines_programs(models):
    """Both engines, one watch each (measured-only), the same prompts: the
    programs billed and their call counts agree, under the family each
    engine names for a paged pool."""
    jmodel, tmodel = models
    kw = dict(slots=2, max_len=64, prompt_bucket=16, readback_lag=1, kv_cache="paged", block_size=8)
    prompts = [np.asarray([5, 17, 33, 2, 9], np.int32), np.arange(1, 12, dtype=np.int32)]
    calls = {}
    for name, make in (("jax", lambda: JEngine(jmodel, **kw)),
                       ("torch", lambda: ContinuousBatchingEngine(tmodel, device="cpu", **kw))):
        perf, _, dc = SIDES[name]
        eng = make()
        eng._perfwatch = perf.PerfWatch(dc.ObservabilityConfig())
        for p in prompts:
            eng.insert(p, max_new_tokens=6)
        eng.drain()
        # the JAX config's default baseline adds its programs' empty rows
        calls[name] = {r["program"]: r["samples"] for r in eng._perfwatch.table() if r["samples"]}
    assert calls["torch"] == calls["jax"]
    assert calls["torch"]["engine.paged/decode_step"] > 0
