"""The port's step telemetry (``accelerate_tpu_torch/telemetry.py``) and the
``Accelerator``'s health watchdog and async logging, as
``tests/test_telemetry.py`` holds the JAX package's.

* ``health_summary`` equals the JAX summary for the same loss and
  gradients (the finiteness flags exactly, the f32 norm within 1e-6
  relative: both sum f32 squares, in another order), and one health check
  reads one tensor back however many gradients it covers.
* The deferred ring: verdicts arrive exactly ``readback_depth`` calls late,
  the restore policy fires late and clears the ring, ``health_drain`` and
  ``end_training`` apply what is left.
* ``AsyncTrackerFlusher``: no read on the training loop's thread, errors
  deferred to ``flush``/``end_training`` while the other trackers are still
  written; ``LatencyReservoir`` against the JAX one.
"""

import json
import threading

import numpy as np
import pytest
import torch
from torch import nn

import jax.numpy as jnp

from accelerate_tpu import telemetry as jtelemetry
from accelerate_tpu_torch import telemetry
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.tracking import GeneralTracker, JSONLTracker, register_tracker_class
from accelerate_tpu_torch.utils.dataclasses import TrainingHealthConfig
from accelerate_tpu_torch.utils.fault import ComponentClosedError, TrainingHealthError

NAN = torch.tensor(float("nan"))
OK = torch.tensor(0.5)


class Regression(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(()))
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return self.a * x + self.b


def regression_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


@pytest.fixture(autouse=True)
def fresh_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _fresh(tmp_path, **kwargs):
    return Accelerator(cpu=True, project_dir=str(tmp_path), **kwargs)


def _prepared(acc):
    model = Regression()
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    rng = np.random.default_rng(0)
    x = rng.normal(size=32).astype(np.float32)
    loader = acc.prepare_data_loader({"x": x, "y": 2 * x + 3}, batch_size=16, drop_last=True)
    model, opt = acc.prepare(model, opt)
    return model, opt, loader


def _one_step(acc, model, opt, batch):
    with acc.accumulate(model):
        acc.backward(regression_loss, batch)
        opt.step()
        opt.zero_grad()


class _FetchCounter:
    def __init__(self, monkeypatch):
        self.calls = []
        real = telemetry._fetch

        def counting(value):
            self.calls.append(threading.current_thread())
            return real(value)

        monkeypatch.setattr(telemetry, "_fetch", counting)

    @property
    def count(self):
        return len(self.calls)

    @property
    def main_thread_count(self):
        return sum(1 for t in self.calls if t is threading.main_thread())


# ------------------------------------------------------------ fused summary
SUMMARY_CASES = {
    "healthy": (0.5, {"a": np.float32(1.0), "b": np.ones(3, np.float32), "i": np.int32(7)}, None),
    "nan_grad": (0.5, {"a": np.float32(1.0), "b": np.array([1.0, np.nan, 1.0], np.float32)}, None),
    "inf_grad": (0.5, {"a": np.array([[np.inf, 2.0]], np.float32)}, None),
    "nan_loss": (np.nan, {"a": np.float32(2.0)}, None),
    "given_norm": (0.5, {"a": np.float32(3.0)}, 9.0),
    "no_grads": (0.5, None, None),
    "no_loss": (None, {"w": np.random.default_rng(0).normal(size=(17, 5)).astype(np.float32)}, None),
}


@pytest.mark.parametrize("case", sorted(SUMMARY_CASES))
def test_health_summary_equals_jax(case):
    loss, grads, norm = SUMMARY_CASES[case]
    theirs = np.asarray(jtelemetry.health_summary(
        None if loss is None else jnp.float32(loss),
        None if grads is None else {k: jnp.asarray(v) for k, v in grads.items()},
        None if norm is None else jnp.float32(norm)))
    ours = telemetry.health_summary(
        None if loss is None else torch.tensor(loss, dtype=torch.float32),
        None if grads is None else {k: torch.from_numpy(np.asarray(v)) for k, v in grads.items()},
        None if norm is None else torch.tensor(norm)).numpy()
    np.testing.assert_array_equal(ours[:2], theirs[:2])
    np.testing.assert_allclose(ours[2], theirs[2], rtol=1e-6)
    got = telemetry.read_summary(torch.from_numpy(ours), 3)
    want = jtelemetry.read_summary(jnp.asarray(theirs), 3)
    assert got[:3] == want[:3] and got.healthy == want.healthy
    assert (got.grad_norm is None) == (want.grad_norm is None)
    if got.grad_norm is not None:
        np.testing.assert_allclose(got.grad_norm, want.grad_norm, rtol=1e-6)


def test_sync_health_reads_back_once_for_many_gradients(tmp_path, monkeypatch):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(check_grads=True))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    counter = _FetchCounter(monkeypatch)
    grads = {f"g{i}": torch.ones(4) for i in range(8)}
    assert acc.check_step_health(loss=OK, grads=grads) is True
    assert counter.count == 1 and acc.last_health.grad_norm == pytest.approx(np.sqrt(32))


# ------------------------------------------------------- ring verdict latency
def test_ring_rejects_bad_depth_and_keeps_order():
    with pytest.raises(ValueError):
        telemetry.DeferredReadbackRing(0)
    with pytest.raises(ValueError):
        TrainingHealthConfig(readback_depth=0)
    ring = telemetry.DeferredReadbackRing(2)
    assert [ring.push(x) for x in "abcd"] == [[], [], ["a"], ["b"]]
    assert len(ring) == 2 and ring.drain() == ["c", "d"] and len(ring) == 0


def test_deferred_verdict_arrives_exactly_k_steps_late(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(
        nonfinite_policy="skip", sync=False, readback_depth=2, max_bad_steps=10))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    verdicts = [acc.check_step_health(loss=loss) for loss in (OK, OK, NAN, OK, OK)]
    assert verdicts == [True, True, True, True, False]
    assert acc.last_health.step == 2 and not acc.last_health.healthy


def test_sync_mode_is_immediate(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    assert acc.check_step_health(loss=OK) is True
    with pytest.raises(TrainingHealthError):
        acc.check_step_health(loss=NAN)


def test_restore_policy_fires_k_steps_late_and_restores(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(
        nonfinite_policy="restore", sync=False, readback_depth=2))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    acc.save_state(str(tmp_path / "good"))
    a_good = model.a.item()
    with torch.no_grad():
        model.a.fill_(999.0)
    assert acc.check_step_health(loss=NAN) is True
    assert acc.check_step_health(loss=OK) is True
    assert model.a.item() == 999.0
    assert acc.check_step_health(loss=OK) is False
    assert model.a.item() == a_good and len(acc._health_ring) == 0


def test_health_drain_applies_pending_verdicts(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(
        nonfinite_policy="skip", sync=False, readback_depth=4))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    assert acc.check_step_health(loss=OK) is True
    assert acc.check_step_health(loss=NAN) is True
    assert acc.health_drain() is False and acc.health_drain() is True


def test_end_training_drains_the_ring_and_raises(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(sync=False, readback_depth=4))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    acc.check_step_health(loss=NAN)
    with pytest.raises(TrainingHealthError):
        acc.end_training()


def test_grad_norm_reused_from_clipping(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(check_grads=True))
    model, opt, loader = _prepared(acc)
    with acc.accumulate(model):
        acc.backward(regression_loss, next(iter(loader)))
        norm = acc.clip_grad_norm_(max_norm=10.0).item()
        assert acc.check_step_health(loss=OK) is True
        assert acc.last_health.grad_norm == pytest.approx(norm, rel=1e-6)
        opt.step()
        opt.zero_grad()
    assert opt._last_grad_norm is None  # consumed by the step


# ------------------------------------------------------------- async logging
def test_async_log_reads_nothing_on_the_training_thread(tmp_path, monkeypatch):
    counter = _FetchCounter(monkeypatch)
    acc = _fresh(tmp_path, log_with="jsonl", async_logging=True)
    acc.init_trackers("async_run")
    for i in range(5):
        acc.log({"loss": torch.tensor(i / 10)}, step=i)
    acc.end_training()
    assert counter.count == 5 and counter.main_thread_count == 0
    lines = [json.loads(line) for line in open(tmp_path / "async_run" / "metrics.jsonl")]
    assert [line["_step"] for line in lines] == list(range(5))
    assert lines[3]["loss"] == pytest.approx(0.3)


def test_sync_log_passes_values_through(tmp_path):
    logged = []

    class EagerTracker(GeneralTracker):
        name = "eager"

        @property
        def tracker(self):
            return logged

        def log(self, values, step=None, **kwargs):
            logged.append((step, values))

    register_tracker_class("eager", EagerTracker)
    acc = _fresh(tmp_path, log_with="eager")
    acc.init_trackers("run")
    acc.log({"x": 1}, step=5)
    assert logged == [(5, {"x": 1})]


def test_flusher_defers_errors_other_trackers_still_written(tmp_path):
    records, finished = [], []

    class GoodTracker(GeneralTracker):
        name = "good"

        def log(self, values, step=None, **kwargs):
            records.append((step, values))

        def finish(self):
            finished.append("good")

    class BadTracker(GeneralTracker):
        name = "bad"

        def log(self, values, step=None, **kwargs):
            raise RuntimeError("backend down")

        def finish(self):
            finished.append("bad")

    register_tracker_class("good", GoodTracker)
    register_tracker_class("bad", BadTracker)
    acc = _fresh(tmp_path, log_with=["bad", "good"], async_logging=True)
    acc.init_trackers("run")
    for i in range(3):
        acc.log({"v": i}, step=i)
    with pytest.raises(RuntimeError, match="backend down"):
        acc.end_training()
    assert [s for s, _ in records] == [0, 1, 2] and sorted(finished) == ["bad", "good"]


def test_flusher_flush_blocks_until_written():
    writes = []

    class Slow(GeneralTracker):
        name = "slow"

        def __init__(self):
            pass

        def log(self, values, step=None, **kwargs):
            writes.append(step)

    flusher = telemetry.AsyncTrackerFlusher([Slow()])
    try:
        for i in range(20):
            flusher.submit({"x": i}, step=i)
        flusher.flush()
        assert writes == list(range(20))
    finally:
        flusher.close()
    with pytest.raises(ComponentClosedError):
        flusher.submit({"x": 99}, step=99)
    flusher.close()


def test_jsonl_log_batch_single_write(tmp_path):
    t = JSONLTracker("runb", logging_dir=str(tmp_path))
    t.start()
    t.log_batch([({"a": 1.0}, 0, {}), ({"a": 2.0}, 1, {})])
    t.log_batch([])
    t.finish()
    lines = [json.loads(line) for line in open(tmp_path / "runb" / "metrics.jsonl")]
    assert len(lines) == 2 and lines[1]["a"] == 2.0 and lines[1]["_step"] == 1


def test_latency_reservoir_equals_jax():
    values = np.random.default_rng(1).exponential(size=500)
    ours, theirs = telemetry.LatencyReservoir(64), jtelemetry.LatencyReservoir(64)
    for v in values:
        ours.add(v)
        theirs.add(v)
    assert ours.snapshot("lat_") == theirs.snapshot("lat_") and ours.count == 500
    assert [ours.percentile(p) for p in (0, 50, 99, 100)] == [theirs.percentile(p) for p in (0, 50, 99, 100)]
    assert telemetry.LatencyReservoir().percentile(50) is None


def test_materialize_metrics_reads_tensors_only():
    out = telemetry.materialize_metrics({"t": torch.tensor(2.5), "v": torch.arange(3), "s": "x"})
    assert out["t"] == 2.5 and out["v"].tolist() == [0, 1, 2] and out["s"] == "x"
