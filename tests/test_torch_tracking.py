"""The port's trackers (``accelerate_tpu_torch/tracking.py``) against the JAX
package's (``accelerate_tpu/tracking.py``): the JSONL tracker's lines equal
the JAX tracker's for the same logged values, ``_time`` masked; the
registry (``filter_trackers``, ``register_tracker_class``), the
``Accelerator``'s ``init_trackers``/``log``/``get_tracker``/``end_training``,
TensorBoard where its package imports, and the third-party wrappers' call
surface through faked modules, as ``tests/test_tracking.py`` holds them."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from accelerate_tpu import tracking as jtracking
from accelerate_tpu_torch import tracking
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import AcceleratorState, GradientState, PartialState
from accelerate_tpu_torch.tracking import GeneralTracker, JSONLTracker, filter_trackers, register_tracker_class


@pytest.fixture(autouse=True)
def fresh_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _fresh(tmp_path, **kwargs):
    return Accelerator(cpu=True, project_dir=str(tmp_path), **kwargs)


def _lines(path):
    return [json.loads(line) for line in open(path)]


def _masked(lines):
    return [{k: v for k, v in line.items() if k != "_time"} for line in lines]


RECORDS = [({"loss": 1.5, "acc": 0.7}, 0), ({"loss": np.float32(1.25), "n": 3}, 1),
           ({"lr": 1e-3, "name": "warmup"}, 2), ({"loss": 0.5}, None)]


def test_jsonl_lines_equal_jax(tmp_path):
    ours = JSONLTracker("run", logging_dir=str(tmp_path / "ours"))
    theirs = jtracking.JSONLTracker("run", logging_dir=str(tmp_path / "jax"))
    for t in (ours, theirs):
        t.start()
        for values, step in RECORDS:
            t.log(values, step=step)
        t.log_batch([({"batched": 2.0}, 4, {}), ({"batched": 3.0}, 5, {})])
        t.store_init_configuration({"lr": 0.1, "layers": [1, 2]})
        t.finish()
    got = _lines(tmp_path / "ours" / "run" / "metrics.jsonl")
    want = _lines(tmp_path / "jax" / "run" / "metrics.jsonl")
    assert _masked(got) == _masked(want) and len(got) == 6
    assert all(isinstance(line["_time"], float) for line in got)
    assert (json.load(open(tmp_path / "ours" / "run" / "config.json"))
            == json.load(open(tmp_path / "jax" / "run" / "config.json")))


def test_jsonl_tracker_end_to_end(tmp_path):
    acc = _fresh(tmp_path, log_with="jsonl")
    acc.init_trackers("myrun", config={"lr": 0.1, "epochs": 2})
    acc.log({"loss": torch.tensor(1.5), "acc": 0.7}, step=0)
    acc.log({"loss": 1.2}, step=1)
    acc.end_training()
    assert json.load(open(tmp_path / "myrun" / "config.json"))["lr"] == 0.1
    lines = _lines(tmp_path / "myrun" / "metrics.jsonl")
    assert lines[0]["loss"] == 1.5 and lines[1]["_step"] == 1


def test_get_tracker(tmp_path):
    acc = _fresh(tmp_path, log_with="jsonl")
    acc.init_trackers("run2")
    assert isinstance(acc.get_tracker("jsonl"), JSONLTracker)
    assert acc.get_tracker("jsonl", unwrap=True).endswith("metrics.jsonl")
    with pytest.raises(ValueError):
        acc.get_tracker("wandb")


def test_filter_trackers_unknown_and_logging_dir():
    with pytest.raises(ValueError, match="Unknown tracker"):
        filter_trackers(["nope"], None)
    with pytest.raises(ValueError, match="requires a logging_dir"):
        filter_trackers(["jsonl"], None)
    assert filter_trackers([], None) == []


BUILT_IN = ("jsonl", "tensorboard", "wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive",
            "swanlab", "trackio")


@pytest.mark.parametrize("name", BUILT_IN)
def test_a_tracker_is_available_where_the_jax_one_is(name):
    cls, avail = tracking._TRACKERS[name]
    assert cls.name == name and avail() == jtracking._TRACKERS[name][1]()
    selected = {c.name for c in filter_trackers(["all"], "/nowhere")}
    assert (name in selected) == avail() and "jsonl" in selected


def test_register_custom_tracker(tmp_path):
    logged = []

    class MyTracker(GeneralTracker):
        name = "mytracker"
        requires_logging_directory = False

        @property
        def tracker(self):
            return logged

        def log(self, values, step=None, **kwargs):
            logged.append((step, values))

    register_tracker_class("mytracker", MyTracker)
    acc = _fresh(tmp_path, log_with="mytracker")
    acc.init_trackers("run3")
    acc.log({"x": 1}, step=5)
    assert logged == [(5, {"x": 1})]


def test_log_registry_hands_a_snapshot_to_every_tracker():
    batches = []

    class Collect(GeneralTracker):
        name = "collect"

        def log_batch(self, entries):
            batches.append(entries)

    class Registry:
        def snapshot(self):
            return {"requests": 3}

    class Broken(GeneralTracker):
        name = "broken"

        def log_batch(self, entries):
            raise OSError("gone")

    tracking.log_registry([Broken("r"), Collect("r")], Registry(), step=7)
    assert batches == [[({"requests": 3}, 7, {})]]


def test_tensorboard_tracker(tmp_path):
    if not tracking._TRACKERS["tensorboard"][1]():
        pytest.skip("neither tensorboard nor tensorboardX imports here")
    acc = _fresh(tmp_path, log_with="tensorboard")
    acc.init_trackers("tbrun")
    acc.log({"loss": 0.5}, step=0)
    acc.end_training()
    assert any(f.startswith("events") for f in os.listdir(tmp_path / "tbrun"))


def test_main_process_only_guard(monkeypatch):
    calls = []
    guarded = tracking.on_main_process(lambda: calls.append(1))
    guarded()
    PartialState(cpu=True)
    monkeypatch.setitem(PartialState._shared_state, "process_index", 1)
    guarded()
    assert calls == [1]


def test_wandb_tracker_contract(tmp_path, monkeypatch):
    calls = []
    fake_run = types.SimpleNamespace(
        log=lambda values, step=None, **kw: calls.append(("log", values, step)),
        finish=lambda: calls.append(("finish",)))
    fake = types.SimpleNamespace(
        init=lambda project, **kw: calls.append(("init", project)) or fake_run,
        config=types.SimpleNamespace(update=lambda values, **kw: calls.append(("config", values))),
        Image=lambda img, **kw: ("img", img))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    monkeypatch.setitem(tracking._TRACKERS, "wandb", (tracking.WandBTracker, lambda: True))
    acc = _fresh(tmp_path, log_with="wandb")
    acc.init_trackers("proj", config={"lr": 0.1})
    acc.log({"loss": 1.5}, step=3)
    acc.get_tracker("wandb").log_images({"sample": ["fake-image"]}, step=3)
    acc.end_training()
    assert ("init", "proj") in calls and ("config", {"lr": 0.1}) in calls
    assert ("log", {"loss": 1.5}, 3) in calls and ("finish",) in calls


def test_mlflow_tracker_contract(tmp_path, monkeypatch):
    calls = []
    fake = types.SimpleNamespace(
        set_experiment=lambda name: calls.append(("exp", name)) or types.SimpleNamespace(
            experiment_id="7"),
        start_run=lambda experiment_id, **kw: calls.append(("run", experiment_id)) or "run",
        log_param=lambda k, v: calls.append(("param", k, v)),
        log_metrics=lambda values, step=None: calls.append(("metrics", values, step)),
        end_run=lambda: calls.append(("end",)))
    monkeypatch.setitem(sys.modules, "mlflow", fake)
    monkeypatch.setitem(tracking._TRACKERS, "mlflow", (tracking.MLflowTracker, lambda: True))
    acc = _fresh(tmp_path, log_with="mlflow")
    acc.init_trackers("proj", config={"lr": 0.1})
    acc.log({"loss": 1.5, "name": "x"}, step=2)
    acc.end_training()
    assert calls == [("exp", "proj"), ("run", "7"), ("param", "lr", 0.1),
                     ("metrics", {"loss": 1.5}, 2), ("end",)]
