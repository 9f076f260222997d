"""Host loss with a world change on the CPU (the counterpart of JAX
``tests/test_elastic.py::test_host_loss_with_world_size_change_resumes_via_replica``
at 2 -> 1 processes), through ``launch --cpu`` (torchrun, gloo) over
``elastic_recovery_script.py`` on a tiny Llama whose rows come from a
prepared loader (2 rows a process): a synchronous replica, rank 1
SIGKILLed after the commit, the local tree wiped; a relaunch at one
process with ``--elastic`` restores through the replica and remaps the
loader's position (the global batch halves, the position doubles: C6),
and its losses equal, bit for bit, those of a one-process run that loads
the same checkpoint directly. Two ranks on one wiped tree restore it once
(the main process first, as in JAX). A first launch with replication and
no replica returns False on every rank.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

from test_torch_supervised_training import SCRIPTS, SEQ, _env, _launch


def _elastic_args(tmp, project, *extra):
    return ["--project_dir", str(tmp / project), "--rows", "4", "--seq", str(SEQ),
            "--loader_batches", "8", "--per_process_rows", "2", *extra]


@pytest.fixture(scope="module")
def host_loss(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host_loss")
    replica = str(tmp / "replica")
    sync = _env(ACCELERATE_REPLICATION_SYNC="1")
    out = {"tmp": tmp, "replica": replica}
    # first launch with replication and no replica anywhere
    out["first"] = _launch(["--num_processes", "2", "--replicate_to", replica],
                           "elastic_recovery_script.py",
                           _elastic_args(tmp, "first", "--phase", "first_launch"), env=sync)
    # two ranks train 2 steps of 2 rows each, save with a synchronous replica;
    # rank 1 is lost after the commit
    out["train"] = _launch(["--num_processes", "2", "--replicate_to", replica],
                           "elastic_recovery_script.py",
                           _elastic_args(tmp, "proj", "--phase", "host_loss", "--steps", "2"),
                           env=sync)
    shutil.copytree(tmp / "proj", tmp / "proj_shared")
    shutil.rmtree(tmp / "proj" / "checkpoints")  # the whole local tree is gone
    out["resume"] = _launch(["--num_processes", "1", "--elastic", "--replicate_to", replica],
                            "elastic_recovery_script.py",
                            _elastic_args(tmp, "proj", "--phase", "resume", "--steps", "3",
                                          "--out", str(tmp / "resume.json")), env=sync)
    out["direct"] = subprocess.run(
        [sys.executable, str(SCRIPTS / "elastic_recovery_script.py"), "--cpu",
         *_elastic_args(tmp, "direct", "--phase", "resume", "--steps", "3", "--load_dir",
                        os.path.join(replica, "r0", "checkpoint_0"),
                        "--out", str(tmp / "direct.json"))],
        env=_env(), capture_output=True, text=True, timeout=120)
    # two ranks on one wiped tree: restored once, by the main process
    shutil.rmtree(tmp / "proj_shared" / "checkpoints")
    out["shared"] = _launch(["--num_processes", "2", "--replicate_to", replica],
                            "elastic_recovery_script.py",
                            _elastic_args(tmp, "proj_shared", "--phase", "resume", "--steps", "1",
                                          "--out", str(tmp / "shared.json")),
                            env=_env(ACCELERATE_REPLICATION_SYNC="1",
                                     ACCELERATE_LOG_ON_ALL_PROCESSES="1"))
    return out


def test_first_launch_with_replication_returns_false_on_every_rank(host_loss):
    proc = host_loss["first"]
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert sorted(line for line in proc.stdout.splitlines() if "resumed=" in line) == [
        "rank 0 resumed=False", "rank 1 resumed=False"]


def test_host_loss_resumes_at_one_process_through_the_replica(host_loss):
    from accelerate_tpu_torch.elastic import remap_sampler_state

    train = host_loss["train"]
    assert train.returncode != 0  # rank 1 was SIGKILLed
    assert "rank 0 committed checkpoint_0" in train.stdout
    assert "rank 1 committed checkpoint_0" in train.stdout
    assert os.path.isfile(os.path.join(host_loss["replica"], "r0", "checkpoint_0", "COMMITTED"))
    resume, direct = host_loss["resume"], host_loss["direct"]
    assert resume.returncode == 0, resume.stderr[-4000:]
    assert direct.returncode == 0, direct.stderr[-4000:]
    assert "from replica" in resume.stderr and "saved by 2 processes" in resume.stderr
    got = json.loads((host_loss["tmp"] / "resume.json").read_text())
    want = json.loads((host_loss["tmp"] / "direct.json").read_text())
    assert got["resumed"] and got["num_processes"] == 1 and got["step"] == 2
    # C6: 2 batches of 4 samples consumed = 4 batches of 2
    assert got["position"] == remap_sampler_state({"position": 2}, 4, 2)["position"] == 4
    assert got["losses"] == want["losses"] and got["position"] == want["position"]


def test_two_ranks_on_one_tree_restore_it_once(host_loss):
    proc = host_loss["shared"]
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("resumed=True") == 2
    assert proc.stderr.count("restored ") == 1  # the main process's restore; rank 1 finds it
    tree = host_loss["tmp"] / "proj_shared" / "checkpoints"
    assert sorted(os.listdir(tree)) == ["checkpoint_0"]
    got = json.loads((host_loss["tmp"] / "shared.json").read_text())
    assert got["position"] == 2 and got["num_processes"] == 2
