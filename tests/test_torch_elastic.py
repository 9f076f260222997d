"""Recovery across host loss and world changes (``accelerate_tpu_torch/
elastic.py``) against the JAX package's ``accelerate_tpu/elastic.py``, case
by case as ``tests/test_elastic.py`` holds the JAX one:

* the loader remap (C6): ``remap_sampler_state`` equal to JAX's on a grid
  of positions and global batches, dividing and not; a checkpoint written
  by two gloo processes at global batch 2b and loaded with ``elastic=True``
  by one at b resumes at the position JAX's function gives;
* ``ReplicationConfig``'s fields and validation, ``manifest_digest`` on the
  same manifests, ``_consensus_from_views`` on the same view tables (the
  index, digest, local path and missing ranks, or the error class);
* replication on tiny-Llama checkpoints (one process, the CPU): a
  synchronous mirror, copies and retention, the async drain by
  ``end_training``, the latest-wins backlog, retries that end in an error,
  a degraded slot, a bitwise resume after the tree is wiped, a corrupt
  replica skipped for the second copy, every replica corrupt, a corrupt
  local tree healed, and the kill points between the commit and the mirror
  and during a mirror (``elastic_recovery_script.py`` in a subprocess);
  a save killed before its commit rolled back (``fault_save_script.py``).
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

from accelerate_tpu_torch import elastic
from accelerate_tpu_torch.checkpointing import is_checkpoint_committed, verify_checkpoint
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import ReplicationConfig
from accelerate_tpu_torch.utils.fault import (
    CheckpointDivergedError,
    CheckpointError,
    CheckpointNotFoundError,
    ReplicaUnavailableError,
)

REPO = Path(__file__).resolve().parents[1]
ELASTIC_SCRIPT = REPO / "accelerate_tpu_torch" / "test_utils" / "scripts" / "elastic_recovery_script.py"


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    for var in ("ACCELERATE_TPU_FAULT_INJECT", "ACCELERATE_REPLICATION_TARGET",
                "ACCELERATE_REPLICATION_SYNC", "ACCELERATE_CHECKPOINT_VERIFY"):
        monkeypatch.delenv(var, raising=False)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


# --------------------------------------------------------------- C6: remap
REMAP_BATCHES = [(16, 16), (16, 8), (16, 12), (8, 32), (4, 2), (2, 4), (6, 4), (3, 5)]


@pytest.mark.parametrize("old,new", REMAP_BATCHES)
def test_remap_sampler_state_matches_jax(old, new):
    from accelerate_tpu import elastic as jel

    for position in (0, 1, 3, 5, 7):
        for skip in (0, 2):
            sd = {"position": position, "skip_batches": skip, "total_batch_size": old,
                  "epoch": 1}
            ours, theirs = elastic.remap_sampler_state(sd, old, new), jel.remap_sampler_state(
                dict(sd), old, new)
            assert ours == theirs
            assert (ours is sd) == (old == new)
    assert elastic.remap_sampler_state({"epoch": 2}, old, new) == {"epoch": 2}


def _two_process_save(ckpt):
    """Two gloo ranks: a loader of 2 rows a process (global 4) consumed for
    3 batches, a regression step each, then ``save_state``."""
    from accelerate_tpu_torch.accelerator import Accelerator

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True)
    model, opt, loader = _regression(acc)
    it = iter(loader)
    for _ in range(3):
        batch = next(it)
        with acc.accumulate(model):
            acc.backward(lambda m, b: ((m(b["x"]) - b["y"]) ** 2).mean(), batch)
            opt.step()
            opt.zero_grad()
    it.close()
    acc.save_state(ckpt)
    return acc.num_processes, loader.total_batch_size


def _regression(acc):
    import torch
    from torch import nn

    class Regression(nn.Module):
        def __init__(self):
            super().__init__()
            self.a = nn.Parameter(torch.zeros(()))
            self.b = nn.Parameter(torch.zeros(()))

        def forward(self, x):
            return self.a * x + self.b

    x = np.arange(32, dtype=np.float32)
    loader = acc.prepare_data_loader({"x": x, "y": 2 * x + 1}, batch_size=2, drop_last=True)
    model = Regression()
    model, opt = acc.prepare(model, torch.optim.Adam(model.parameters(), lr=0.1))
    return model, opt, loader


def test_two_process_checkpoint_resumes_one_process_at_the_jax_position(tmp_path):
    """C6: the saved position counts batches of the global batch 2b; one
    process at b must skip twice as many (the samples consumed), as JAX's
    ``remap_sampler_state`` says, and its first batch is the next unseen
    sample."""
    from accelerate_tpu import elastic as jel
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.launchers import debug_launcher

    ckpt = str(tmp_path / "ckpt")
    results = debug_launcher(_two_process_save, args=(ckpt,), num_processes=2,
                             init_method=f"file://{tmp_path}/store")
    assert [r[:2] for r in results] == [(2, 4), (2, 4)]
    saved = json.load(open(os.path.join(ckpt, "sampler.json")))["dataloaders"][0]
    assert saved["position"] == 3 and saved["total_batch_size"] == 4

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True)
    model, opt, loader = _regression(acc)
    assert loader.total_batch_size == 2
    acc.load_state(ckpt, elastic=True)
    want = jel.remap_sampler_state(dict(saved), 4, 2)["position"]
    assert want == 6
    assert loader.state_dict()["position"] == want
    first = next(iter(loader))["x"].tolist()
    assert first == [12.0, 13.0]  # 3 global batches of 4 samples were consumed


# ------------------------------------------------------- config and digests
def test_replication_config_fields_and_validation():
    import dataclasses

    from accelerate_tpu.utils import dataclasses as jdc

    ours = {f.name: f.default for f in dataclasses.fields(ReplicationConfig)}
    assert ours == {f.name: f.default for f in dataclasses.fields(jdc.ReplicationConfig)}
    for bad in (dict(target=""), dict(target="/r", copies=0), dict(target="/r", max_retries=-1),
                dict(target="/r", retry_backoff_s=-0.1), dict(target="/r", verify="bogus"),
                dict(target="/r", keep=0)):
        with pytest.raises(ValueError):
            ReplicationConfig(**bad)
        with pytest.raises(ValueError):
            jdc.ReplicationConfig(**bad)
    assert ReplicationConfig(target="/r", copies=2, keep=3).keep == 3


BASE_MANIFEST = {
    "format": 1, "step": 7, "time": 1111.0,
    "files": {"model/a.safetensors": {"size": 10, "crc32": "aa"},
              "sampler.json": {"size": 5, "crc32": "bb"},
              "random_states_0.pkl": {"size": 99, "crc32": "cc"}},
}


def _variant(kind):
    m = json.loads(json.dumps(BASE_MANIFEST))
    if kind == "time":
        m["time"] = 2222.0
    elif kind == "rng":
        del m["files"]["random_states_0.pkl"]
        m["files"]["random_states_3.pkl"] = {"size": 1, "crc32": "zz"}
    elif kind == "crc":
        m["files"]["model/a.safetensors"]["crc32"] = "XX"
    elif kind == "step":
        m["step"] = 8
    elif kind == "size":
        m["files"]["sampler.json"]["size"] = 6
    elif kind == "format":
        m["format"] = 2
    elif kind == "extra_file":
        m["files"]["optimizer/b.safetensors"] = {"size": 3, "crc32": "dd"}
    elif kind == "empty":
        m = {}
    return m


@pytest.mark.parametrize("kind", ["base", "time", "rng", "crc", "step", "size", "format",
                                  "extra_file", "empty"])
def test_manifest_digest_matches_jax(kind):
    from accelerate_tpu import elastic as jel

    m = _variant(kind)
    assert elastic.manifest_digest(m) == jel.manifest_digest(m)
    same = elastic.manifest_digest(m) == elastic.manifest_digest(BASE_MANIFEST)
    assert same == (kind in ("base", "time", "rng"))


VIEWS = {
    "laggard": ([{0: "a", 1: "b"}, {0: "a", 1: "b"}, {0: "a"}], 0),
    "laggard_rank2": ([{0: "a", 1: "b"}, {0: "a", 1: "b"}, {0: "a"}], 2),
    "empty_host": ([{}, {1: "d"}], 0),
    "empty_host_holder": ([{}, {1: "d"}], 1),
    "lagging_and_wiped": ([{0: "a", 1: "b"}, {0: "a"}, {}], 1),
    "all_hold": ([{1: "b"}, {1: "b"}], 1),
    "digest_mismatch": ([{1: "x"}, {1: "y"}], 0),
    "no_common_index": ([{0: "a"}, {1: "b"}], 0),
    "all_empty": ([{}, {}], 0),
    "rank_past_views": ([{2: "c"}], 3),
}


@pytest.mark.parametrize("case", list(VIEWS))
def test_consensus_matches_jax(case, tmp_path):
    from accelerate_tpu import elastic as jel

    views, rank = VIEWS[case]

    def outcome(fn):
        try:
            res = fn(views, str(tmp_path), rank)
        except Exception as exc:  # noqa: BLE001 - the class is compared
            return type(exc).__name__,
        return None if res is None else (res.index, res.digest, res.local_path, res.missing_ranks)

    ours, theirs = outcome(elastic._consensus_from_views), outcome(jel._consensus_from_views)
    assert ours == theirs
    if case in ("digest_mismatch", "no_common_index"):
        assert ours[0] == CheckpointDivergedError.__name__
        assert issubclass(CheckpointDivergedError, CheckpointError)


# ------------------------------------------------------------ tiny Llama runs
def _run(project, replication=None, **kw):
    from accelerate_tpu_torch.test_utils.training import Finetune, add_finetune_args

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    ap = argparse.ArgumentParser()
    add_finetune_args(ap)
    args = ap.parse_args(["--cpu", "--project_dir", str(project)])
    for k, v in kw.items():
        setattr(args, k, v)
    return Finetune(args, replication_config=replication)


def _sync(tmp_path, **kw):
    return ReplicationConfig(target=str(tmp_path / "replica"), async_replicate=False, **kw)


def _trained(tmp_path, replication, steps=1):
    run = _run(tmp_path / "proj", replication)
    for step in range(steps):
        run.step(run.batch(step))
    return run


def _params(run):
    return run.whole_params()


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_digest_of_port_checkpoints_ignores_rng_files_and_time(tmp_path):
    run = _trained(tmp_path, None)
    ckpt = run.acc.save_state()
    digest = elastic.checkpoint_digest(ckpt)
    marker = os.path.join(ckpt, "COMMITTED")
    manifest = json.load(open(marker))
    assert any(k.startswith("random_states_") for k in manifest["files"])
    manifest["time"] += 100
    manifest["files"]["random_states_0.pkl"]["crc32"] = "00000000"
    json.dump(manifest, open(marker, "w"))
    assert elastic.checkpoint_digest(ckpt) == digest
    key = next(k for k in manifest["files"] if k.startswith("model/"))
    manifest["files"][key]["crc32"] = "00000000"
    json.dump(manifest, open(marker, "w"))
    assert elastic.checkpoint_digest(ckpt) != digest


def test_resolve_consensus_single_process(tmp_path):
    run = _trained(tmp_path, None)
    base = os.path.join(str(tmp_path / "proj"), "checkpoints")
    assert elastic.resolve_consensus_checkpoint(base) is None
    run.acc.save_state()
    run.step(run.batch(1))
    run.acc.save_state()
    res = elastic.resolve_consensus_checkpoint(base)
    assert res.index == 1 and res.local_path == os.path.join(base, "checkpoint_1")
    assert res.missing_ranks == () and elastic.local_checkpoint_views(base)[1] == res.digest


def test_sync_replication_mirrors_checkpoint(tmp_path):
    run = _trained(tmp_path, _sync(tmp_path))
    local = run.acc.save_state()
    replica = str(tmp_path / "replica" / "r0" / "checkpoint_0")
    assert os.path.isfile(os.path.join(replica, "COMMITTED"))
    verify_checkpoint(replica, level="checksum")
    assert elastic.checkpoint_digest(replica) == elastic.checkpoint_digest(local)
    assert not os.path.exists(replica + ".tmp") and not os.path.exists(replica + ".old")


def test_replication_multiple_copies_and_retention(tmp_path):
    run = _trained(tmp_path, _sync(tmp_path, copies=2, keep=1))
    run.acc.save_state()
    run.step(run.batch(1))
    run.acc.save_state()
    for slot in ("r0", "r1"):
        root = tmp_path / "replica" / slot
        assert not (root / "checkpoint_0").exists()
        assert (root / "checkpoint_1" / "COMMITTED").is_file()


def test_async_replication_drained_by_end_training(tmp_path):
    run = _trained(tmp_path, ReplicationConfig(target=str(tmp_path / "replica")))
    run.acc.save_state()
    run.acc.end_training()
    assert (tmp_path / "replica" / "r0" / "checkpoint_0" / "COMMITTED").is_file()
    assert run.acc._replicator.pending == 0


def test_replicator_backlog_drops_oldest_latest_wins():
    rep = elastic.CheckpointReplicator(ReplicationConfig(target="/nowhere"))
    gate = threading.Event()
    mirrored = []

    def slow_mirror(src):
        gate.wait(10)
        mirrored.append(src)

    rep._mirror_with_retry = slow_mirror
    for name in ("c0", "c1", "c2", "c3"):
        rep.submit(name)
    assert rep.pending <= 3  # one in flight, at most _MAX_PENDING waiting
    gate.set()
    rep.drain(timeout=10)
    rep.close()
    assert mirrored[-1] == "c3" and len(mirrored) <= 3


def test_sync_replication_failure_raises_after_retries(tmp_path, monkeypatch):
    run = _trained(tmp_path, _sync(tmp_path, max_retries=1, retry_backoff_s=0.0))
    attempts = []

    def boom(src, dst, config):
        attempts.append(dst)
        raise OSError("target volume gone")

    monkeypatch.setattr(elastic, "_mirror_one", boom)
    with pytest.raises(OSError, match="target volume gone"):
        run.acc.save_state()
    assert len(attempts) == 2  # the first and max_retries more
    # the local checkpoint is committed whatever the replica's fate
    assert is_checkpoint_committed(str(tmp_path / "proj" / "checkpoints" / "checkpoint_0"))


def test_degraded_slot_does_not_cost_healthy_slots_their_copy(tmp_path, monkeypatch):
    run = _trained(tmp_path, _sync(tmp_path, copies=2, max_retries=0, retry_backoff_s=0.0))
    real = elastic._mirror_one

    def r0_down(src, dst, config):
        if f"{os.sep}r0{os.sep}" in dst:
            raise OSError("r0 volume gone")
        real(src, dst, config)

    monkeypatch.setattr(elastic, "_mirror_one", r0_down)
    with pytest.raises(CheckpointError, match=r"1/2 copy slot"):
        run.acc.save_state()
    assert is_checkpoint_committed(str(tmp_path / "replica" / "r1" / "checkpoint_0"))
    assert not (tmp_path / "replica" / "r0" / "checkpoint_0").is_dir()


def test_resume_restores_bitwise_from_replica_after_tree_wipe(tmp_path):
    run = _trained(tmp_path, _sync(tmp_path))
    run.acc.save_state()
    saved = _params(run)
    run.step(run.batch(1))
    after = _params(run)
    shutil.rmtree(tmp_path / "proj" / "checkpoints")  # the host's disk is gone
    run2 = _run(tmp_path / "proj", _sync(tmp_path))
    assert run2.acc.resume_from_latest() is True
    _assert_same(_params(run2), saved)
    assert (tmp_path / "proj" / "checkpoints" / "checkpoint_0" / "COMMITTED").is_file()
    run2.step(run2.batch(run2.acc.step))
    _assert_same(_params(run2), after)


def test_first_launch_without_replicas_returns_false(tmp_path):
    run = _run(tmp_path / "proj", _sync(tmp_path))
    assert run.acc.resume_from_latest() is False


def _flip(path):
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF  # same size: only the checksum sees it
    open(path, "wb").write(bytes(data))


def test_corrupt_replica_skipped_for_second_copy(tmp_path):
    run = _trained(tmp_path, _sync(tmp_path, copies=2))
    run.acc.save_state()
    saved = _params(run)
    _flip(tmp_path / "replica" / "r0" / "checkpoint_0" / "sampler.json")
    shutil.rmtree(tmp_path / "proj" / "checkpoints")
    run2 = _run(tmp_path / "proj", _sync(tmp_path, copies=2))
    assert run2.acc.resume_from_latest() is True  # r0 refused, r1 restored
    _assert_same(_params(run2), saved)


def test_all_replicas_corrupt_raises_checksum_refusal(tmp_path):
    run = _trained(tmp_path, _sync(tmp_path))
    run.acc.save_state()
    _flip(tmp_path / "replica" / "r0" / "checkpoint_0" / "sampler.json")
    shutil.rmtree(tmp_path / "proj" / "checkpoints")
    run2 = _run(tmp_path / "proj", _sync(tmp_path))
    with pytest.raises(ReplicaUnavailableError, match="crc32 mismatch"):
        run2.acc.resume_from_latest()


def test_corrupt_local_checkpoint_healed_from_replica(tmp_path):
    run = _trained(tmp_path, _sync(tmp_path))
    ckpt = run.acc.save_state()
    saved = _params(run)
    run.step(run.batch(1))
    model_file = next(p for p in Path(ckpt, "model").iterdir() if p.suffix == ".safetensors")
    _flip(model_file)
    run.acc.load_state(ckpt, verify="checksum")  # parks the damage, pulls the replica
    _assert_same(_params(run), saved)
    assert os.path.isdir(ckpt + ".corrupt")
    verify_checkpoint(ckpt, level="checksum")


def test_restore_from_replica_without_any_replica_raises_not_found(tmp_path):
    with pytest.raises(CheckpointNotFoundError):
        elastic.restore_from_replica(_sync(tmp_path), str(tmp_path / "local"))


def _script(env, *argv):
    return subprocess.run([sys.executable, str(ELASTIC_SCRIPT), "--cpu", *argv], env=env,
                          capture_output=True, text=True, timeout=120)


def _script_env(replica):
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu",
               ACCELERATE_REPLICATION_TARGET=str(replica), ACCELERATE_REPLICATION_SYNC="1")
    return env


@pytest.mark.parametrize("point,replica_left", [("before_replicate", None),
                                                ("during_replicate", "checkpoint_1.tmp")])
def test_kill_between_commit_and_mirror_and_mid_mirror(tmp_path, point, replica_left):
    """A death after the local commit: before any replica byte, the replica
    set lacks checkpoint_1; during a mirror, it holds an uncommitted
    ``.tmp`` a restore never considers. With the local tree, the resume
    loads checkpoint_1; with it wiped, the replica's checkpoint_0 restores
    bit for bit."""
    project, replica, ref = tmp_path / "proj", tmp_path / "replica", str(tmp_path / "ref")
    env = _script_env(replica)
    train = _script(env, "--phase", "train", "--project_dir", str(project), "--ref_out", ref,
                    "--fault", f"{point}:kill")
    assert train.returncode == -signal.SIGKILL, f"{train.stdout}\n{train.stderr}"
    assert "committed checkpoint_0" in train.stdout
    root = replica / "r0"
    assert (root / "checkpoint_0" / "COMMITTED").is_file()
    assert not (root / "checkpoint_1" / "COMMITTED").exists()
    if replica_left:
        assert (root / replica_left).is_dir()
    got = str(tmp_path / "got.npz")
    expect = {"local": ref + ".step2.npz", "wiped": ref + ".step1.npz"}
    for tree in ("local", "wiped"):
        if tree == "wiped":
            shutil.rmtree(project / "checkpoints")
        verify = _script(env, "--phase", "verify", "--project_dir", str(project), "--ref_out", got)
        assert verify.returncode == 0, f"{verify.stdout}\n{verify.stderr}"
        assert "resumed=True" in verify.stdout
        with np.load(expect[tree]) as want, np.load(got) as have:
            _assert_same(dict(have), dict(want))


def test_fault_save_script_rolls_back_to_the_committed_checkpoint(tmp_path):
    """``fault_save_script.py``: a save killed before its commit leaves the
    first checkpoint, which a fresh process resumes bit for bit."""
    script = str(ELASTIC_SCRIPT).replace("elastic_recovery_script", "fault_save_script")
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    ref, got, project = str(tmp_path / "ref.npz"), str(tmp_path / "got.npz"), str(tmp_path / "p")
    train = subprocess.run([sys.executable, script, "--cpu", "--phase", "train", "--project_dir",
                            project, "--ref_out", ref, "--fault", "before_commit:kill"],
                           env=env, capture_output=True, text=True, timeout=120)
    assert train.returncode == -signal.SIGKILL, train.stderr[-3000:]
    assert "committed checkpoint_0" in train.stdout
    assert sorted(os.listdir(os.path.join(project, "checkpoints"))) == ["checkpoint_0",
                                                                        "checkpoint_1.tmp"]
    verify = subprocess.run([sys.executable, script, "--cpu", "--phase", "verify", "--project_dir",
                             project, "--ref_out", got], env=env, capture_output=True, text=True,
                            timeout=120)
    assert verify.returncode == 0 and "resumed=True" in verify.stdout, verify.stderr[-3000:]
    with np.load(ref) as want, np.load(got) as have:
        _assert_same(dict(have), dict(want))
