"""Launch a training script on several processes, under a supervisor that
restarts it (counterpart of ``accelerate_tpu/commands/launch.py``).

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        [--dp_shard_size 2] [--mixed_precision bf16] [--cpu] \\
        [--max_restarts 1] [--watchdog_timeout 120] [--handle_preemption] \\
        [--replicate_to /durable/replica] [--elastic] script.py [args]

runs ``python -m torch.distributed.run`` (torchrun) with one process per
card (``--cpu``: gloo processes on the CPU) and the environment the port
reads: ``PARALLELISM_CONFIG_*_SIZE`` (``ParallelismConfig.from_env``),
``ACCELERATE_MIXED_PRECISION``, ``ACCELERATE_GRADIENT_ACCUMULATION_STEPS``,
``ACCELERATE_USE_CPU``, ``ACCELERATE_ELASTIC``,
``ACCELERATE_HANDLE_PREEMPTION`` and ``ACCELERATE_REPLICATION_TARGET``/
``_COPIES``; torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``MASTER_ADDR``/``MASTER_PORT``. ``--num_machines``/``--machine_rank``/
``--main_process_ip``/``--main_process_port`` span hosts. ``--dry_run``
prints the command and the environment it adds instead of running.
``--pod`` fans out over a TPU pod, which has no counterpart here: one
launch per machine takes its place.

Supervision (:func:`_supervise`, the JAX package's, always on: with no
restarts it still forwards a preemption signal). ``--max_restarts N``
relaunches the whole torchrun group when it dies, with
``ACCELERATE_RESTART_COUNT`` set; a worker that dies within
``--min_uptime`` seconds is a fast failure, ``--crash_loop_limit`` of
them in a row stop the restarts, and they back off exponentially
(``ACCELERATE_RESTART_BACKOFF`` base seconds, doubling, at most 60;
``ACCELERATE_RESTART_DELAY`` fixes the delay). torchrun itself runs with
its default ``--max-restarts 0``: the supervisor alone restarts, and it
restarts every rank. ``--watchdog_timeout T`` kills the group when a rank
stops beating for T seconds. ``--handle_preemption`` makes every rank
checkpoint and exit on SIGTERM/SIGINT, which the supervisor forwards.
``--replicate_to`` mirrors every committed checkpoint there
(``--replicate_copies``); ``--elastic`` lets a relaunch at another world
size resume (``resume_from_latest(elastic=True)``).

Three decisions that torchrun forces:

* **Exit codes.** torchrun exits 1 both when a worker exits 143 (the
  preemption handler's code) and when it is itself signalled, so the JAX
  rule (a planned shutdown is rc 0, 143, -SIGTERM or -SIGINT) cannot be
  read off its exit code. The supervisor exports
  ``ACCELERATE_PREEMPTION_DIR``; a rank whose handler committed the
  emergency checkpoint leaves ``preempted.<LOCAL_RANK>`` there before it
  exits, and the shutdown is clean when every rank of this machine left
  one (or the JAX rule holds). The signal goes to the workers themselves,
  not to torchrun, which would kill them 30 s after passing it on, before
  a large emergency checkpoint is written.
* **Heartbeats.** A machine runs several ranks, and one stuck outside a
  collective would be hidden by the others' beats in one file. Each rank
  touches ``<ACCELERATE_HEARTBEAT_FILE>.<LOCAL_RANK>`` (when its
  Accelerator is built, after every step and around a save and a load)
  and the supervisor reads the oldest. ``T`` must exceed a worker's start
  up to its Accelerator, the time from there to its first step (the
  model, a replica restore) and the longest save with its mirror. A hang
  inside an NCCL collective is also seen by NCCL's own watchdog (10
  minutes by default); with a smaller ``T`` the supervisor fires first.
  A kill takes the whole tree: torchrun, and each worker's process group
  (torchrun starts every worker in a session of its own).
* **Elastic topology.** Before every launch the supervisor reads the JSON
  file named by ``ACCELERATE_ELASTIC_TOPOLOGY_FILE`` and rebuilds the
  torchrun command from it: ``num_processes`` (processes on this machine,
  ``--num_processes``), ``num_machines`` (``--num_machines``),
  ``machine_rank`` (``--machine_rank``), ``main_process_ip`` and
  ``main_process_port``. The JAX file's ``process_id`` is read as
  ``machine_rank`` and its ``coordinator_address`` (``host:port``) as
  ``main_process_ip`` and ``main_process_port``; its ``num_processes``
  counts hosts, one JAX process a host, which is ``num_machines`` here.
  The values are exported as ``ACCELERATE_NUM_PROCESSES``,
  ``ACCELERATE_NUM_MACHINES``, ``ACCELERATE_MACHINE_RANK``,
  ``ACCELERATE_MAIN_PROCESS_IP`` and ``ACCELERATE_MAIN_PROCESS_PORT``.
  The JAX package's ``config`` file waits for ROADMAP.md A11: flags alone
  set the supervision here.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional, Sequence

from ..utils.fault import PREEMPTION_DIR_ENV, PREEMPTION_EXIT_CODE

__all__ = ["launch_command", "launch_env", "main", "parser"]

AXES = ("dp_replicate", "dp_shard", "pp", "cp", "sp", "tp", "ep")

# the cap of the exponential backoff between restarts after fast failures
_MAX_BACKOFF = 60.0

# topology keys -> the launcher's flags; the JAX file's keys are aliases
TOPOLOGY_KEYS = ("num_processes", "num_machines", "machine_rank", "main_process_ip",
                 "main_process_port")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m accelerate_tpu_torch.commands.launch",
                                description="launch a training script on several processes")
    p.add_argument("--num_processes", type=int, default=1, help="processes per machine")
    p.add_argument("--num_machines", type=int, default=1)
    p.add_argument("--machine_rank", type=int, default=0)
    p.add_argument("--main_process_ip", default=None)
    p.add_argument("--main_process_port", type=int, default=None)
    p.add_argument("--mixed_precision", default=None, choices=["no", "bf16", "fp16", "fp8"])
    p.add_argument("--gradient_accumulation_steps", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="gloo processes on the CPU")
    for axis in AXES:
        p.add_argument(f"--{axis}_size", type=int, default=None)
    p.add_argument("--elastic", action="store_true",
                   help="resume_from_latest loads a checkpoint of another world size")
    p.add_argument("--max_restarts", type=int, default=None,
                   help="relaunch every rank up to N times when the group dies")
    p.add_argument("--monitor_interval", type=float, default=5.0,
                   help="seconds between liveness polls")
    p.add_argument("--watchdog_timeout", type=float, default=None,
                   help=">0: kill the group when a rank has not beaten for this many seconds "
                        "(a beat when the Accelerator is built, after every step and around a "
                        "save and a load: set it above a worker's start and its longest save)")
    p.add_argument("--min_uptime", type=float, default=10.0,
                   help="a worker dying within this many seconds of its launch is a fast failure")
    p.add_argument("--crash_loop_limit", type=int, default=3,
                   help="stop after this many fast failures in a row, restarts left or not")
    p.add_argument("--handle_preemption", action="store_true",
                   help="ranks checkpoint and exit on SIGTERM/SIGINT, which the supervisor "
                        "forwards; such a shutdown is not restarted")
    p.add_argument("--replicate_to", default=None,
                   help="mirror every committed checkpoint under this path (durable storage)")
    p.add_argument("--replicate_copies", type=int, default=None,
                   help="copies under --replicate_to (default 1)")
    p.add_argument("--pod", default=None)
    p.add_argument("--dry_run", action="store_true", help="print the command and env, don't run")
    p.add_argument("training_script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def _refuse_queued(args) -> None:
    if args.pod:
        raise NotImplementedError("--pod fans a command out over a TPU pod; one torchrun per "
                                  "machine (--num_machines, --machine_rank) takes its place")


def launch_env(args) -> dict:
    """The variables the launch adds for the script."""
    env = {}
    for axis in AXES:
        size = getattr(args, f"{axis}_size")
        if size is not None and size != 1:
            env[f"PARALLELISM_CONFIG_{axis.upper()}_SIZE"] = str(size)
    if args.mixed_precision is not None:
        env["ACCELERATE_MIXED_PRECISION"] = args.mixed_precision
    if args.gradient_accumulation_steps is not None:
        env["ACCELERATE_GRADIENT_ACCUMULATION_STEPS"] = str(args.gradient_accumulation_steps)
    if args.cpu:
        env["ACCELERATE_USE_CPU"] = "1"
    if args.elastic:
        env["ACCELERATE_ELASTIC"] = "1"
    if args.handle_preemption:
        env["ACCELERATE_HANDLE_PREEMPTION"] = "1"
    if args.replicate_to:
        env["ACCELERATE_REPLICATION_TARGET"] = args.replicate_to
        if args.replicate_copies is not None:
            env["ACCELERATE_REPLICATION_COPIES"] = str(args.replicate_copies)
    return env


def _topology_env(args) -> dict:
    """The launch's topology as the supervisor exports it (and reads it
    back, changed by an elastic topology file, to rebuild the command)."""
    env = {f"ACCELERATE_{k.upper()}": str(getattr(args, k)) for k in TOPOLOGY_KEYS
           if getattr(args, k) is not None}
    return env


def launch_command(args) -> list:
    """The torchrun command line."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
           str(args.num_processes)]
    if args.num_machines > 1:
        if not args.main_process_ip:
            raise ValueError("--num_machines > 1 needs --main_process_ip (the first machine)")
        cmd += ["--nnodes", str(args.num_machines), "--node_rank", str(args.machine_rank),
                "--master_addr", args.main_process_ip,
                "--master_port", str(args.main_process_port or 29500)]
    else:
        cmd += ["--standalone"]
    return cmd + [args.training_script, *args.script_args]


def _torchrun_command(args):
    """``env -> torchrun command`` with the topology ``env`` holds."""
    def build(env: dict) -> list:
        live = copy.copy(args)
        for key in TOPOLOGY_KEYS:
            value = env.get(f"ACCELERATE_{key.upper()}")
            if value is not None:
                setattr(live, key, value if key == "main_process_ip" else int(value))
        return launch_command(live)

    return build


# ------------------------------------------------------------------ supervisor
def _children(pid: int) -> list:
    """The processes whose parent is ``pid`` (torchrun's workers)."""
    out = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat[stat.rfind(")") + 2:].split()[1]) == pid:
            out.append(int(entry))
    return out


def _kill_tree(proc: subprocess.Popen) -> None:
    """SIGKILL the child's process group and each of its children's (a
    torchrun worker leads a session of its own), then reap the child."""
    workers = _children(proc.pid)
    for pgid in [proc.pid, *workers]:
        try:
            os.killpg(pgid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    proc.wait()


def _stale_age(hb_files: list) -> float:
    """Seconds since the oldest of ``hb_files`` was touched."""
    now = time.time()
    return max(now - os.path.getmtime(f) if os.path.exists(f) else float("inf") for f in hb_files)


def _supervise(cmd, env, max_restarts: int, monitor_interval: float, watchdog_timeout: float,
               min_uptime: float = 10.0, crash_loop_limit: int = 3) -> int:
    """Run ``cmd`` under a restart supervisor; return the final exit code
    (the JAX package's ``_supervise``).

    ``cmd`` a list runs as it is: one worker, read by the JAX rule. A
    callable ``cmd(env)`` builds a torchrun command at each launch (after
    the elastic topology file is applied) for ``ACCELERATE_NUM_PROCESSES``
    ranks on this machine. The child is polled every ``monitor_interval``
    seconds. With ``watchdog_timeout > 0`` a heartbeat file is exported as
    ``ACCELERATE_HEARTBEAT_FILE`` (under torchrun each rank beats on
    ``<file>.<LOCAL_RANK>``); when the oldest beat is older than the
    timeout, the child's whole tree is killed and counted as a failure.

    SIGTERM/SIGINT sent to the supervisor are forwarded to the worker(s)
    (under torchrun, to each rank, not to torchrun) so they can write an
    emergency checkpoint; the shutdown is clean, the supervisor returns 0
    and does not restart, when the child exits 0, 143, -SIGTERM or -SIGINT
    or every rank left its ``preempted.<LOCAL_RANK>`` marker in
    ``ACCELERATE_PREEMPTION_DIR``.

    The crash-loop breaker: a worker that dies within ``min_uptime``
    seconds is a fast failure; ``crash_loop_limit`` in a row stop the
    restarts, budget left or not. Fast failures in a row back off
    exponentially (``ACCELERATE_RESTART_BACKOFF`` base seconds, default
    1.0, doubling, capped at 60); a worker that lived past ``min_uptime``
    resets both. Across machines (``ACCELERATE_NUM_MACHINES`` > 1) with the
    watchdog on, a relaunch waits until the last beat plus the watchdog's
    horizon, the same instant on every machine, so the whole job comes
    down before it comes back."""
    work = tempfile.mkdtemp(prefix="accelerate_supervise_")
    hb_file = None
    if watchdog_timeout > 0:
        hb_file = os.path.join(work, "heartbeat")
        open(hb_file, "w").close()
        env["ACCELERATE_HEARTBEAT_FILE"] = hb_file
    env[PREEMPTION_DIR_ENV] = work
    attempt = 0
    fast_fails = 0
    backoff_base = float(os.environ.get("ACCELERATE_RESTART_BACKOFF", "1.0"))
    child: dict = {"proc": None, "terminating": False, "ranks": 0}
    prev_handlers = {}

    def _forward(signum, frame):
        child["terminating"] = True
        proc = child["proc"]
        if proc is not None and proc.poll() is None:
            print(f"[launch] forwarding signal {signum} to worker for a preemption checkpoint",
                  file=sys.stderr)
            targets = (_children(proc.pid) if child["ranks"] else []) or [proc.pid]
            for pid in targets:
                try:
                    os.kill(pid, signum)
                except OSError:
                    pass

    # handlers can be installed from the main thread only; driven from
    # another thread the forwarding is off
    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            prev_handlers[sig] = signal.signal(sig, _forward)
    proc = None
    try:
        while True:
            env["ACCELERATE_RESTART_COUNT"] = str(attempt)
            _apply_elastic_topology(env, attempt)
            argv = cmd(env) if callable(cmd) else cmd
            ranks = int(env.get("ACCELERATE_NUM_PROCESSES", "0") or 0) if callable(cmd) else 0
            child["ranks"] = ranks
            for name in os.listdir(work):
                if name.startswith("preempted."):
                    os.unlink(os.path.join(work, name))
            hb_files = []
            if hb_file:
                hb_files = [f"{hb_file}.{i}" for i in range(ranks)] if ranks else [hb_file]
                for f in hb_files:
                    open(f, "a").close()
                    os.utime(f, None)
            started = time.time()
            proc = subprocess.Popen(argv, env=env, start_new_session=True)
            child["proc"] = proc
            rc = None
            while rc is None:
                try:
                    rc = proc.wait(timeout=monitor_interval)
                except subprocess.TimeoutExpired:
                    if not hb_files:
                        continue
                    age = _stale_age(hb_files)
                    if age > watchdog_timeout:
                        print(f"[launch] heartbeat stale >{watchdog_timeout}s (the oldest rank's "
                              f"last beat {age:.1f}s ago); killing hung worker", file=sys.stderr)
                        _kill_tree(proc)
                        rc = 1
            uptime = time.time() - started
            if child["terminating"]:
                # a forwarded preemption: checkpoint and exit is the plan
                marked = ranks > 0 and all(
                    os.path.exists(os.path.join(work, f"preempted.{i}")) for i in range(ranks))
                if marked or rc in (0, PREEMPTION_EXIT_CODE, -signal.SIGTERM, -signal.SIGINT):
                    print("[launch] worker shut down cleanly after preemption signal",
                          file=sys.stderr)
                    return 0
                return rc
            if rc == 0:
                return 0
            fast_fails = fast_fails + 1 if uptime < min_uptime else 0
            if fast_fails >= crash_loop_limit:
                print(f"[launch] crash loop: worker died within {min_uptime}s of launch "
                      f"{fast_fails} times in a row; aborting (rc={rc})", file=sys.stderr)
                return rc
            if attempt >= max_restarts:
                return rc
            attempt += 1
            print(f"[launch] worker exited rc={rc}; restart {attempt}/{max_restarts}",
                  file=sys.stderr)
            # across machines one rank's death leaves the others failing or
            # hung at different times; each supervisor waits until its last
            # beat plus the watchdog's horizon, the same instant everywhere
            multi_machine = int(env.get("ACCELERATE_NUM_MACHINES", "1") or 1) > 1
            backoff = (min(backoff_base * (2 ** (fast_fails - 1)), _MAX_BACKOFF)
                       if fast_fails > 0 else 0.0)
            if "ACCELERATE_RESTART_DELAY" in os.environ:
                delay = float(os.environ["ACCELERATE_RESTART_DELAY"])
            elif multi_machine and hb_files and watchdog_timeout > 0:
                last_beat = max(os.path.getmtime(f) for f in hb_files)
                deadline = last_beat + watchdog_timeout + 2 * monitor_interval + 2
                delay = max(0.0, deadline - time.time(), backoff)
            else:
                delay = backoff
            if delay:
                print(f"[launch] waiting {delay:.1f}s before relaunching"
                      + (f" (backoff after {fast_fails} fast failures)" if backoff and backoff >= delay
                         else " for the whole job to come down"), file=sys.stderr)
                time.sleep(delay)
    finally:
        if proc is not None and proc.poll() is None:
            _kill_tree(proc)
        for sig, handler in prev_handlers.items():
            try:
                signal.signal(sig, handler)
            except (OSError, ValueError):
                pass
        shutil.rmtree(work, ignore_errors=True)


def _apply_elastic_topology(env: dict, attempt: int) -> None:
    """Before every launch: read ``ACCELERATE_ELASTIC_TOPOLOGY_FILE`` (JSON;
    the keys in the module docstring) and export its values, from which
    the next torchrun command is built. An orchestrator that lost a host
    or a card rewrites the file; at the next whole-group restart the ranks
    come back at the new world size and ``resume_from_latest(elastic=True)``
    loads the consensus checkpoint into it. Without the variable or the
    file nothing changes."""
    topo_file = env.get("ACCELERATE_ELASTIC_TOPOLOGY_FILE") or os.environ.get(
        "ACCELERATE_ELASTIC_TOPOLOGY_FILE")
    if not topo_file or not os.path.exists(topo_file):
        return
    try:
        with open(topo_file) as f:
            topo = dict(json.load(f))
    except (json.JSONDecodeError, OSError, TypeError, ValueError) as exc:
        print(f"[launch] unreadable elastic topology file {topo_file}: {exc}", file=sys.stderr)
        return
    if "process_id" in topo:
        topo.setdefault("machine_rank", topo.pop("process_id"))
    if "coordinator_address" in topo:
        host, _, port = str(topo.pop("coordinator_address")).rpartition(":")
        topo.setdefault("main_process_ip", host)
        topo.setdefault("main_process_port", port)
    changed = []
    for key in TOPOLOGY_KEYS:
        if key in topo:
            var, val = f"ACCELERATE_{key.upper()}", str(topo[key])
            if env.get(var) != val:
                changed.append(f"{var}={val}")
            env[var] = val
    if changed and attempt:
        print(f"[launch] elastic relaunch with {' '.join(changed)}", file=sys.stderr)


def _supervision_settings(args) -> tuple:
    """(restarts, watchdog seconds): an explicit 0 and an absent flag both
    turn them off (the JAX package reads its config file here too, which
    waits for ROADMAP.md A11)."""
    return int(args.max_restarts or 0), float(args.watchdog_timeout or 0.0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    _refuse_queued(args)
    cmd, extra = launch_command(args), launch_env(args)
    max_restarts, watchdog = _supervision_settings(args)
    if args.dry_run:
        print(" ".join(shlex.quote(c) for c in cmd))
        for key, value in sorted(extra.items()):
            print(f"  {key}={value}")
        if max_restarts or watchdog:
            print(f"  supervisor: max_restarts={max_restarts} watchdog_timeout={watchdog} "
                  f"monitor_interval={args.monitor_interval} min_uptime={args.min_uptime} "
                  f"crash_loop_limit={args.crash_loop_limit}")
        return 0
    # the script imports this package as the launcher did, installed or not
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    env = {**os.environ, **extra, **_topology_env(args), "PYTHONPATH": path}
    # supervised even with no restarts: a preemption signal is forwarded
    return _supervise(_torchrun_command(args), env, max_restarts, args.monitor_interval, watchdog,
                      min_uptime=args.min_uptime, crash_loop_limit=args.crash_loop_limit)


if __name__ == "__main__":
    sys.exit(main())
