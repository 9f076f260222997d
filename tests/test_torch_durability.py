"""Durable checkpoints of the port, case by case as ``tests/test_durability.py``
holds the JAX package's: the atomic commit and its manifest, the verify
levels, the error taxonomy, rolling back past interrupted saves, ``.old``
recovery, retention with ``keep_every``, the async commit, a SIGKILL in a
subprocess mid-save (the previous checkpoint restored bit-identically), a
SIGTERM emergency checkpoint, and the health watchdog's raise, skip and
restore policies with ``max_bad_steps``. The JAX file's supervisor tests
(crash-loop breaker, restart budget and backoff of ``accelerate-tpu
launch``) are ``tests/test_torch_supervisor.py``, held against the JAX
supervisor itself.

The model is a two-parameter regression ``a * x + b`` in f32 on the CPU
(``Accelerator(cpu=True)``), trained by Adam through the eager loop.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch import nn

from accelerate_tpu_torch import checkpointing as ckpt_mod
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils import fault
from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration, TrainingHealthConfig
from accelerate_tpu_torch.utils.fault import (
    CheckpointComponentMissingError,
    CheckpointCorruptError,
    CheckpointNotFoundError,
    CheckpointUncommittedError,
    FaultInjected,
    TrainingHealthError,
    fault_point,
)

REPO = Path(__file__).resolve().parents[1]


class Regression(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(()))
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return self.a * x + self.b


def regression_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def make_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    return {"x": x, "y": (2.0 * x + 3.0 + 0.1 * rng.normal(size=n)).astype(np.float32)}


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    monkeypatch.delenv(fault.FAULT_INJECT_ENV, raising=False)
    monkeypatch.delenv("ACCELERATE_CHECKPOINT_VERIFY", raising=False)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _fresh(project_dir, **kwargs):
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    return Accelerator(cpu=True, project_dir=str(project_dir), **kwargs)


def _prepared(acc):
    model = Regression()
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    loader = acc.prepare_data_loader(make_data(32), batch_size=16, drop_last=True)
    model, opt = acc.prepare(model, opt)
    return model, opt, loader


def _one_step(acc, model, opt, batch):
    with acc.accumulate(model):
        acc.backward(regression_loss, batch)
        opt.step()
        opt.zero_grad()


# ------------------------------------------------------------ kill mid-save
_FAULT_SCRIPT = textwrap.dedent('''
    import os, sys
    import numpy as np, torch
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    from test_torch_durability import Regression, make_data, regression_loss
    from accelerate_tpu_torch.accelerator import Accelerator

    phase, project, out, spec = sys.argv[1:5]
    acc = Accelerator(cpu=True, project_dir=project)
    acc.project_configuration.automatic_checkpoint_naming = True
    model = Regression()
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    loader = acc.prepare_data_loader(make_data(32), batch_size=16, drop_last=True)
    model, opt = acc.prepare(model, opt)

    def flat():
        return np.concatenate([p.detach().numpy().ravel() for p in model.parameters()]
                              + [s[k].numpy().ravel() for s in opt.optimizer.state.values()
                                 for k in sorted(s)])

    if phase == "verify":
        print(f"resumed={{acc.resume_from_latest()}}", flush=True)
        np.save(out, flat())
        sys.exit(0)
    batches = list(loader)
    for i, batch in enumerate(batches):
        with acc.accumulate(model):
            acc.backward(regression_loss, batch)
            opt.step()
            opt.zero_grad()
        if i == 0:
            acc.save_state()
            np.save(out, flat())
            print("committed checkpoint_0", flush=True)
            os.environ["ACCELERATE_TPU_FAULT_INJECT"] = spec
    acc.save_state()
    print("save unexpectedly survived", flush=True)
''')


def _script(tmp_path, body):
    path = tmp_path / "drive.py"
    path.write_text(body.format(repo=str(REPO), tests=str(REPO / "tests")))
    return str(path)


def _env():
    env = {k: v for k, v in os.environ.items() if k != fault.FAULT_INJECT_ENV}
    env["JAX_PLATFORMS"] = "cpu"
    return env


@pytest.mark.parametrize("point", ["after_model_save", "before_commit", "before_rename"])
def test_sigkill_mid_save_rolls_back_bit_identical(tmp_path, point):
    """SIGKILL at any point of a save leaves the previous committed
    checkpoint, and a new process restores it bit-identically (parameters
    and Adam's moments)."""
    script = _script(tmp_path, _FAULT_SCRIPT)
    project, ref, got = str(tmp_path / "proj"), str(tmp_path / "ref.npy"), str(tmp_path / "got.npy")
    train = subprocess.run([sys.executable, script, "train", project, ref, point], env=_env(),
                           capture_output=True, text=True, timeout=240)
    assert train.returncode == -signal.SIGKILL, f"{train.returncode}\n{train.stdout}\n{train.stderr}"
    assert "committed checkpoint_0" in train.stdout
    verify = subprocess.run([sys.executable, script, "verify", project, got, ""], env=_env(),
                            capture_output=True, text=True, timeout=240)
    assert verify.returncode == 0, f"{verify.stdout}\n{verify.stderr}"
    assert "resumed=True" in verify.stdout
    np.testing.assert_array_equal(np.load(ref), np.load(got))


# ---------------------------------------------------------- fault_point
def test_fault_point_actions(monkeypatch):
    fault_point("unarmed")
    monkeypatch.setenv(fault.FAULT_INJECT_ENV, "mypoint:raise")
    fault_point("other")
    with pytest.raises(FaultInjected):
        fault_point("mypoint")
    monkeypatch.setenv(fault.FAULT_INJECT_ENV, "a:raise,b:raise")
    with pytest.raises(FaultInjected):
        fault_point("b")
    monkeypatch.setenv(fault.FAULT_INJECT_ENV, "mypoint:bogus")
    with pytest.raises(ValueError):
        fault_point("mypoint")


def test_fault_point_modifiers_and_conductor(monkeypatch):
    fault.reset_fault_state()
    monkeypatch.setenv(fault.FAULT_INJECT_ENV, "p:raise:after=2:every=2")
    fired = []
    for i in range(7):
        try:
            fault_point("p")
        except FaultInjected:
            fired.append(i)
    assert fired == [2, 4, 6]
    monkeypatch.setenv(fault.FAULT_INJECT_ENV, "q:flaky=0.5")
    runs = []
    for _ in range(2):
        fault.reset_fault_state()
        hits = []
        for i in range(40):
            try:
                fault_point("q")
            except FaultInjected:
                hits.append(i)
        runs.append(hits)
    assert runs[0] == runs[1] and 5 < len(runs[0]) < 35  # seeded: the same sequence
    monkeypatch.delenv(fault.FAULT_INJECT_ENV)
    seen = []
    conductor = lambda name, ctx: seen.append((name, ctx))  # noqa: E731
    fault.install_conductor(conductor)
    try:
        fault_point("r", replica="x")
    finally:
        fault.uninstall_conductor(conductor)
    fault_point("r")
    assert seen == [("r", {"replica": "x"})]


# ------------------------------------------------------ commit + verify
def test_save_writes_committed_manifest(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    ckpt = acc.save_state(str(tmp_path / "ckpt"))
    manifest = ckpt_mod.read_commit_manifest(ckpt)
    assert manifest["format"] == 1 and manifest["num_processes"] == 1
    files = manifest["files"]
    assert "model/model.safetensors" in files and "optimizer/model.safetensors" in files
    assert {"sampler.json", "optimizer_meta.json", "random_states_0.pkl"} <= set(files)
    for rel, meta in files.items():
        assert meta["size"] == os.path.getsize(os.path.join(ckpt, rel))
    assert not os.path.exists(ckpt + ".tmp") and not os.path.exists(ckpt + ".old")
    for level in ("off", "marker", "size", "checksum"):
        ckpt_mod.verify_checkpoint(ckpt, level=level)
    with pytest.raises(ValueError, match="verify level"):
        ckpt_mod.verify_checkpoint(ckpt, level="bogus")


def test_verify_detects_truncation_and_bitflips(tmp_path, monkeypatch):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    ckpt = acc.save_state(str(tmp_path / "ckpt"))
    victim = os.path.join(ckpt, "sampler.json")
    original = open(victim, "rb").read()
    open(victim, "wb").write(b"X" * len(original))  # same size: only the checksum sees it
    ckpt_mod.verify_checkpoint(ckpt, level="size")
    with pytest.raises(CheckpointCorruptError, match="crc32"):
        ckpt_mod.verify_checkpoint(ckpt, level="checksum")
    with pytest.raises(CheckpointCorruptError):
        acc.load_state(ckpt, verify="checksum")
    monkeypatch.setenv("ACCELERATE_CHECKPOINT_VERIFY", "checksum")
    with pytest.raises(CheckpointCorruptError):
        acc.load_state(ckpt)
    monkeypatch.delenv("ACCELERATE_CHECKPOINT_VERIFY")
    open(victim, "wb").write(original[:-3])
    with pytest.raises(CheckpointCorruptError, match="size"):
        ckpt_mod.verify_checkpoint(ckpt, level="size")
    open(victim, "wb").write(original)
    ckpt_mod.verify_checkpoint(ckpt, level="checksum")
    os.unlink(victim)
    with pytest.raises(CheckpointCorruptError, match="missing"):
        ckpt_mod.verify_checkpoint(ckpt, level="size")
    ckpt_mod.read_commit_manifest(ckpt)


def test_error_taxonomy(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    with pytest.raises(CheckpointNotFoundError):
        acc.load_state(str(tmp_path / "never_saved"))
    assert issubclass(CheckpointNotFoundError, FileNotFoundError)
    ckpt = acc.save_state(str(tmp_path / "ckpt"))
    marker = os.path.join(ckpt, "COMMITTED")
    os.rename(marker, marker + ".hidden")
    with pytest.raises(CheckpointUncommittedError):
        acc.load_state(ckpt)
    acc.load_state(ckpt, verify="off")  # a tree without a manifest, on request
    os.rename(marker + ".hidden", marker)
    with open(marker, "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointCorruptError):
        acc.load_state(ckpt)
    shutil.rmtree(os.path.join(ckpt, "model"))
    with open(marker, "w") as f:
        json.dump({"format": 1, "files": {"sampler.json": {"size": 1, "crc32": "0"}}}, f)
    with pytest.raises(CheckpointComponentMissingError):
        acc.load_state(ckpt)


def test_resolve_rolls_back_past_uncommitted(tmp_path):
    proj = tmp_path / "proj"
    acc = _fresh(proj)
    acc.project_configuration.automatic_checkpoint_naming = True
    model, opt, loader = _prepared(acc)
    batch = next(iter(loader))
    _one_step(acc, model, opt, batch)
    acc.save_state()
    _one_step(acc, model, opt, batch)
    acc.save_state()
    base = proj / "checkpoints"
    os.makedirs(base / "checkpoint_2")
    os.makedirs(base / "checkpoint_3.tmp")
    acc.load_state()
    assert acc._last_committed_checkpoint.endswith("checkpoint_1")
    assert ckpt_mod.list_checkpoints(str(base), committed_only=True)[-1].endswith("checkpoint_1")
    assert [ckpt_mod.checkpoint_index(n) for n in ("checkpoint_7", "checkpoint_3.tmp", "x")] == [
        7, None, None]
    acc2 = _fresh(proj)
    acc2.project_configuration.automatic_checkpoint_naming = True
    _prepared(acc2)
    assert acc2.resume_from_latest() is True
    assert acc2.project_configuration.iteration == 3
    acc3 = _fresh(tmp_path / "empty")
    _prepared(acc3)
    assert acc3.resume_from_latest() is False  # a first launch


def test_old_parking_dir_recovery(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    ckpt = acc.save_state(str(tmp_path / "ckpt"))
    a_saved = model.a.item()
    os.rename(ckpt, ckpt + ".old")  # died between the overwrite's two renames
    with torch.no_grad():
        model.a.fill_(-7.0)
    acc.load_state(ckpt)
    assert model.a.item() == a_saved
    assert os.path.isdir(ckpt) and not os.path.exists(ckpt + ".old")


def test_same_name_overwrite_replaces_the_checkpoint(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    batch = next(iter(loader))
    _one_step(acc, model, opt, batch)
    ckpt = acc.save_state(str(tmp_path / "ckpt"))
    _one_step(acc, model, opt, batch)
    a_second = model.a.item()
    assert acc.save_state(str(tmp_path / "ckpt")) == ckpt
    with torch.no_grad():
        model.a.fill_(0.0)
    acc.load_state(ckpt)
    assert model.a.item() == a_second and not os.path.exists(ckpt + ".old")


# ------------------------------------------------------------ retention
def test_retention_gc_committed_only_and_keep_every(tmp_path):
    pc = ProjectConfiguration(project_dir=str(tmp_path), automatic_checkpoint_naming=True,
                              total_limit=2, checkpoint_keep_every=3)
    acc = _fresh(tmp_path, project_config=pc)
    model, opt, loader = _prepared(acc)
    batch = next(iter(loader))
    base = tmp_path / "checkpoints"
    os.makedirs(base / "checkpoint_100")  # an interrupted save: never counted or deleted
    for _ in range(5):
        _one_step(acc, model, opt, batch)
        acc.save_state()
    assert sorted(os.listdir(base)) == ["checkpoint_0", "checkpoint_100", "checkpoint_2",
                                        "checkpoint_3", "checkpoint_4"]


def test_keep_every_validation():
    with pytest.raises(ValueError):
        ProjectConfiguration(checkpoint_keep_every=0)


# ------------------------------------------------------- async commits
def test_async_save_commits_on_join(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    a_saved = model.a.item()
    out = str(tmp_path / "async_ckpt")
    acc.save_state(out, async_save=True)
    assert os.path.isdir(out + ".tmp") and not os.path.exists(out)  # staged, not committed
    _one_step(acc, model, opt, next(iter(loader)))  # the snapshot is not changed by training on
    acc.wait_for_async_saves()
    assert ckpt_mod._ASYNC_SAVES == [] and ckpt_mod._PENDING_COMMITS == []
    assert os.path.isfile(os.path.join(out, "COMMITTED")) and not os.path.exists(out + ".tmp")
    acc.load_state(out, verify="checksum")
    assert model.a.item() == a_saved


def test_a_failed_async_write_raises_at_the_join_and_is_not_committed(tmp_path, monkeypatch):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))

    def broken(tensors, directory):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod, "_write_tree", broken)
    out = str(tmp_path / "async_ckpt")
    acc.save_state(out, async_save=True)
    with pytest.raises(OSError, match="disk full"):
        acc.wait_for_async_saves()
    assert not os.path.exists(out) and ckpt_mod._PENDING_COMMITS == []


# -------------------------------------------------------- health watchdog
def test_health_raise_policy(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    assert acc.check_step_health(loss=torch.tensor(0.5)) is True
    with pytest.raises(TrainingHealthError):
        acc.check_step_health(loss=torch.tensor(float("nan")))


def test_health_skip_policy_and_max_bad_steps(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(nonfinite_policy="skip",
                                                              max_bad_steps=3))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    bad = torch.tensor(float("inf"))
    assert acc.check_step_health(loss=bad) is False
    assert acc.check_step_health(loss=bad) is False
    assert acc.check_step_health(loss=torch.tensor(1.0)) is True  # resets the count
    assert acc.check_step_health(loss=bad) is False
    assert acc.check_step_health(loss=bad) is False
    with pytest.raises(TrainingHealthError, match="max_bad_steps"):
        acc.check_step_health(loss=bad)


def test_health_skip_drops_the_gradients(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(nonfinite_policy="skip"))
    model, opt, loader = _prepared(acc)
    with acc.accumulate(model):
        acc.backward(regression_loss, next(iter(loader)))
        assert opt.grads()
        assert acc.check_step_health(loss=torch.tensor(float("nan"))) is False
        assert opt.grads() == []


def test_health_restore_policy_reloads_last_committed(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(nonfinite_policy="restore"))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    acc.save_state(str(tmp_path / "good"))
    a_good = model.a.item()
    with torch.no_grad():
        model.a.fill_(999.0)
    assert acc.check_step_health(loss=torch.tensor(float("nan"))) is False
    assert model.a.item() == a_good


def test_health_checks_grad_tree(tmp_path):
    acc = _fresh(tmp_path, health_config=TrainingHealthConfig(check_grads=True))
    model, opt, loader = _prepared(acc)
    _one_step(acc, model, opt, next(iter(loader)))
    good = {"a": torch.tensor(0.1), "b": torch.tensor(0.2)}
    assert acc.check_step_health(loss=torch.tensor(0.5), grads=good) is True
    bad = {"a": torch.tensor(0.1), "b": torch.tensor(float("nan"))}
    with pytest.raises(TrainingHealthError):
        acc.check_step_health(loss=torch.tensor(0.5), grads=bad)


def test_health_config_validation():
    with pytest.raises(ValueError):
        TrainingHealthConfig(nonfinite_policy="explode")
    with pytest.raises(ValueError):
        TrainingHealthConfig(max_bad_steps=0)


# ----------------------------------------------------------- preemption
_PREEMPT_SCRIPT = textwrap.dedent('''
    import sys, time
    import torch
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    from test_torch_durability import Regression, make_data, regression_loss
    from accelerate_tpu_torch.accelerator import Accelerator

    project, ready = sys.argv[1:3]
    acc = Accelerator(cpu=True, project_dir=project)
    acc.project_configuration.automatic_checkpoint_naming = True
    model = Regression()
    opt = torch.optim.Adam(model.parameters(), lr=0.1)
    loader = acc.prepare_data_loader(make_data(32), batch_size=16, drop_last=True)
    model, opt = acc.prepare(model, opt)
    batch = next(iter(loader))
    for step in range(600):
        with acc.accumulate(model):
            acc.backward(regression_loss, batch)
            opt.step()
            opt.zero_grad()
        if step == 0:
            open(ready, "w").write("ready")
        time.sleep(0.05)
    print("finished without preemption", flush=True)
''')


def test_sigterm_produces_committed_emergency_checkpoint(tmp_path):
    """SIGTERM during training writes a committed emergency checkpoint and
    exits with the preemption code (the handler is armed by
    ``ACCELERATE_HANDLE_PREEMPTION``, as the JAX launcher arms it)."""
    script = _script(tmp_path, _PREEMPT_SCRIPT)
    project, ready = str(tmp_path / "proj"), str(tmp_path / "ready")
    env = dict(_env(), ACCELERATE_HANDLE_PREEMPTION="1")
    proc = subprocess.Popen([sys.executable, script, project, ready], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 120
        while not os.path.exists(ready):
            assert proc.poll() is None, proc.communicate()
            assert time.time() < deadline, "the worker never reached step 1"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == fault.PREEMPTION_EXIT_CODE, f"{proc.returncode}\n{stdout}\n{stderr}"
    assert "emergency checkpoint committed at" in stdout
    committed = ckpt_mod.list_checkpoints(os.path.join(project, "checkpoints"), committed_only=True)
    assert committed
    ckpt_mod.verify_checkpoint(committed[-1], level="checksum")


_FINALIZER_SCRIPT = textwrap.dedent('''
    import io, os, signal, sys
    import torch
    sys.path.insert(0, {repo!r})
    from accelerate_tpu_torch.accelerator import Accelerator

    class CloseRunsPython(io.RawIOBase):
        """The interpreter calls close() from the object's finalizer and
        clears whatever it raises, as a file object's flush does."""

        def writable(self):
            return True

        def close(self):
            os.kill(os.getpid(), signal.SIGTERM)
            for _ in range(1000):
                pass  # the handler runs at a bytecode boundary in here
            super().close()

    acc = Accelerator(cpu=True, project_dir=sys.argv[1])
    acc.project_configuration.automatic_checkpoint_naming = True
    model = torch.nn.Linear(2, 2)
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=0.1))
    CloseRunsPython()  # dropped at once: the signal lands inside its finalizer
    print("training went on after the emergency checkpoint", flush=True)
''')


def test_sigterm_inside_a_finalizer_still_exits_with_the_preemption_code(tmp_path):
    """A signal handled inside a frame that drops exceptions (here a
    stream's finalizer, as the flush of a just-written file is) still ends
    the process with the preemption code after the emergency checkpoint:
    the loop never goes on past it."""
    script = _script(tmp_path, _FINALIZER_SCRIPT)
    project = str(tmp_path / "proj")
    env = dict(_env(), ACCELERATE_HANDLE_PREEMPTION="1")
    proc = subprocess.run([sys.executable, script, project], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == fault.PREEMPTION_EXIT_CODE, f"{proc.returncode}\n{proc.stdout}\n{proc.stderr}"
    assert "emergency checkpoint committed at" in proc.stdout
    assert "training went on" not in proc.stdout
    committed = ckpt_mod.list_checkpoints(os.path.join(project, "checkpoints"), committed_only=True)
    assert len(committed) == 1
    ckpt_mod.verify_checkpoint(committed[0], level="checksum")
