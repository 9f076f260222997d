"""The port's launch supervisor against the JAX package's, case by case as
``tests/test_durability.py`` holds the JAX one: both ``_supervise``
functions run the same bare children (``python -S -c ...``: a clean exit,
a fast-failing child, a budget of one restart, a child that lives past
``min_uptime`` and then fails, a child that stops beating, a child that
exits 143 after a forwarded SIGTERM, one that SIGTERM kills) and must
give equal return codes, equal launch counts, equal ``restart i/n`` lines
and equal backoff sleeps (``time.sleep`` recorded in each module, not
slept). Then the port's own: the elastic topology file's keys and the
JAX file's aliases, the command rebuilt from them, the flags and what
``--dry_run`` prints, and a preemption through the real launcher on the
CPU (rc 0 and a committed emergency checkpoint, the counterpart of the
JAX file's ``test_sigterm_produces_committed_emergency_checkpoint``).
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import pytest

from accelerate_tpu_torch.commands import launch as port_launch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "accelerate_tpu_torch" / "test_utils" / "scripts"


def _bare(code):
    return [sys.executable, "-S", "-c", code]


HB_THEN_STOP = ("import os, time\n"
                "f = os.environ['ACCELERATE_HEARTBEAT_FILE']\n"
                "for _ in range(3):\n"
                "    os.utime(f, None); time.sleep(0.05)\n"
                "time.sleep(60)\n")
TERM_143 = ("import signal, sys, time, os\n"
            "signal.signal(signal.SIGTERM, lambda *a: sys.exit(143))\n"
            "open(os.environ['READY'], 'w').close()\n"
            "time.sleep(60)\n")
TERM_DIES = ("import time, os\n"
             "open(os.environ['READY'], 'w').close()\n"
             "time.sleep(60)\n")

# name -> (child code, _supervise keyword arguments, ACCELERATE_RESTART_BACKOFF, signal the
# supervisor once the child is ready)
CASES = {
    "clean_exit": ("pass", dict(max_restarts=5), "0.01", False),
    "fast_fail_crash_loop": ("import sys; sys.exit(7)",
                             dict(max_restarts=50, min_uptime=30.0, crash_loop_limit=3), "0.01",
                             False),
    "backoff_grows": ("import sys; sys.exit(7)",
                      dict(max_restarts=50, min_uptime=30.0, crash_loop_limit=3), "0.2", False),
    "budget_of_one": ("import sys; sys.exit(13)",
                      dict(max_restarts=1, min_uptime=30.0, crash_loop_limit=10), "0.01", False),
    "lives_past_min_uptime": ("import sys, time; time.sleep(0.3); sys.exit(5)",
                              dict(max_restarts=2, min_uptime=0.1, crash_loop_limit=2), "0.01",
                              False),
    "stale_heartbeat": (HB_THEN_STOP, dict(max_restarts=1, watchdog_timeout=0.5, min_uptime=0.1),
                        "0.01", False),
    "exit_143_after_sigterm": (TERM_143, dict(max_restarts=3), "0.01", True),
    "killed_by_sigterm": (TERM_DIES, dict(max_restarts=3), "0.01", True),
}


def _run(module, case, tmp_path, monkeypatch, capsys):
    """(rc, launches, restart lines, recorded sleeps) of ``module._supervise``."""
    code, kwargs, backoff, signal_it = CASES[case]
    for var in [v for v in os.environ if v.startswith("ACCELERATE_")]:
        monkeypatch.delenv(var)
    monkeypatch.setenv("ACCELERATE_RESTART_BACKOFF", backoff)
    sleeps, launches = [], []
    real_popen = subprocess.Popen

    def popen(*args, **kw):
        launches.append(args[0])
        return real_popen(*args, **kw)

    monkeypatch.setattr(module, "time", types.SimpleNamespace(time=time.time, sleep=sleeps.append,
                                                              monotonic=time.monotonic))
    monkeypatch.setattr(module, "subprocess", types.SimpleNamespace(
        Popen=popen, TimeoutExpired=subprocess.TimeoutExpired, call=subprocess.call))
    ready = tmp_path / f"ready_{module.__name__.split('.')[0]}"
    env = dict(os.environ, READY=str(ready))
    sender = None
    if signal_it:
        def send():
            deadline = time.time() + 30
            while not ready.exists() and time.time() < deadline:
                time.sleep(0.02)
            os.kill(os.getpid(), signal.SIGTERM)

        sender = threading.Thread(target=send, daemon=True)
        sender.start()
    capsys.readouterr()
    kw = {"monitor_interval": 0.05, "watchdog_timeout": 0.0, **kwargs}
    rc = module._supervise(_bare(code), env, kw.pop("max_restarts"), kw.pop("monitor_interval"),
                           kw.pop("watchdog_timeout"), **kw)
    if sender is not None:
        sender.join(timeout=30)
    err = capsys.readouterr().err
    return rc, len(launches), re.findall(r"restart \d+/\d+", err), sleeps, err


@pytest.mark.parametrize("case", list(CASES))
def test_supervisor_matches_jax(case, tmp_path, monkeypatch, capsys):
    from accelerate_tpu.commands import launch as jax_launch

    theirs = _run(jax_launch, case, tmp_path, monkeypatch, capsys)
    ours = _run(port_launch, case, tmp_path, monkeypatch, capsys)
    assert ours[:4] == theirs[:4], (ours, theirs)
    rc, launches, restarts, sleeps, err = ours
    expected = {  # what each case is there to show, beside the parity
        "clean_exit": (0, 1, [], []),
        "fast_fail_crash_loop": (7, 3, ["restart 1/50", "restart 2/50"], [0.01, 0.02]),
        "backoff_grows": (7, 3, ["restart 1/50", "restart 2/50"], [0.2, 0.4]),
        "budget_of_one": (13, 2, ["restart 1/1"], [0.01]),
        "lives_past_min_uptime": (5, 3, ["restart 1/2", "restart 2/2"], []),
        "stale_heartbeat": (1, 2, ["restart 1/1"], []),
        "exit_143_after_sigterm": (0, 1, [], []),
        "killed_by_sigterm": (0, 1, [], []),
    }[case]
    assert (rc, launches, restarts, sleeps) == expected
    if case == "stale_heartbeat":
        assert "heartbeat stale" in err
    if case.endswith("sigterm"):
        assert "preemption" in err and "shut down cleanly" in err


def test_elastic_topology_keys_and_jax_aliases(tmp_path, capsys):
    topo = tmp_path / "topology.json"
    topo.write_text(json.dumps({"num_processes": 2, "process_id": 1,
                                "coordinator_address": "10.0.0.5:1234", "num_machines": 3}))
    env = {"ACCELERATE_ELASTIC_TOPOLOGY_FILE": str(topo), "ACCELERATE_NUM_PROCESSES": "4"}
    port_launch._apply_elastic_topology(env, attempt=1)
    assert env["ACCELERATE_NUM_PROCESSES"] == "2"
    assert env["ACCELERATE_NUM_MACHINES"] == "3"
    assert env["ACCELERATE_MACHINE_RANK"] == "1"
    assert env["ACCELERATE_MAIN_PROCESS_IP"] == "10.0.0.5"
    assert env["ACCELERATE_MAIN_PROCESS_PORT"] == "1234"
    assert "elastic relaunch" in capsys.readouterr().err
    # the next command is built from them
    args = port_launch.parser().parse_args(["--num_processes", "4", "train.py", "--x", "1"])
    cmd = port_launch._torchrun_command(args)(env)
    assert cmd[cmd.index("--nproc_per_node") + 1] == "2"
    assert cmd[cmd.index("--nnodes") + 1] == "3" and cmd[cmd.index("--node_rank") + 1] == "1"
    assert cmd[cmd.index("--master_addr") + 1] == "10.0.0.5"
    assert cmd[cmd.index("--master_port") + 1] == "1234" and cmd[-3:] == ["train.py", "--x", "1"]
    # no file: a fixed-topology restart is untouched
    env2 = {"ACCELERATE_NUM_PROCESSES": "4"}
    port_launch._apply_elastic_topology(env2, attempt=1)
    assert env2 == {"ACCELERATE_NUM_PROCESSES": "4"}


def test_dry_run_prints_the_supervision(capsys):
    assert port_launch.main(["--cpu", "--num_processes", "2", "--max_restarts", "2",
                             "--watchdog_timeout", "30", "--handle_preemption", "--elastic",
                             "--replicate_to", "/r", "--replicate_copies", "2", "--monitor_interval",
                             "1", "--min_uptime", "5", "--crash_loop_limit", "4", "--dry_run",
                             "train.py"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].endswith("-m torch.distributed.run --nproc_per_node 2 --standalone train.py")
    assert lines[1:] == ["  ACCELERATE_ELASTIC=1", "  ACCELERATE_HANDLE_PREEMPTION=1",
                         "  ACCELERATE_REPLICATION_COPIES=2", "  ACCELERATE_REPLICATION_TARGET=/r",
                         "  ACCELERATE_USE_CPU=1",
                         "  supervisor: max_restarts=2 watchdog_timeout=30.0 monitor_interval=1.0 "
                         "min_uptime=5.0 crash_loop_limit=4"]
    with pytest.raises(NotImplementedError, match="--pod"):
        port_launch.main(["--pod", "p", "--dry_run", "train.py"])


def _launch_env(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return env


def test_sigterm_to_the_launcher_commits_an_emergency_checkpoint(tmp_path):
    """SIGTERM to ``launch --handle_preemption`` over torchrun's two ranks:
    each rank writes the emergency checkpoint and leaves its marker,
    torchrun exits 1, the supervisor reads the markers and exits 0 without
    a restart; the checkpoint is committed and a relaunch resumes it."""
    from accelerate_tpu_torch.checkpointing import is_checkpoint_committed, list_checkpoints

    project, ready = tmp_path / "proj", tmp_path / "ready"
    script = str(SCRIPTS / "preemption_script.py")
    proc = subprocess.Popen(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.launch", "--cpu", "--num_processes",
         "2", "--handle_preemption", "--max_restarts", "2", "--monitor_interval", "0.2", script,
         "--cpu", "--project_dir", str(project), "--ready_file", str(ready)],
        env=_launch_env(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.time() + 90
        while not ready.exists():
            assert proc.poll() is None, proc.communicate()
            assert time.time() < deadline, "the workers never reached their first step"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        stdout, stderr = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, f"rc={proc.returncode}\n{stdout}\n{stderr}"
    assert "emergency checkpoint committed at" in stdout
    assert "preemption" in stderr and "restart 1/" not in stderr
    assert "finished without preemption" not in stdout
    ckpts = list_checkpoints(str(project / "checkpoints"), committed_only=True)
    assert ckpts and is_checkpoint_committed(ckpts[-1])
