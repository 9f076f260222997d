"""Launch a training script on several processes (counterpart of
``accelerate_tpu/commands/launch.py``).

    python -m accelerate_tpu_torch.commands.launch --num_processes 2 \\
        [--dp_shard_size 2] [--mixed_precision bf16] [--cpu] script.py [args]

runs ``python -m torch.distributed.run`` (torchrun) with one process per
card (``--cpu``: gloo processes on the CPU) and the environment the port
reads: ``PARALLELISM_CONFIG_*_SIZE`` (``ParallelismConfig.from_env``),
``ACCELERATE_MIXED_PRECISION``, ``ACCELERATE_GRADIENT_ACCUMULATION_STEPS``,
``ACCELERATE_USE_CPU`` and ``ACCELERATE_ELASTIC``; torchrun sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``.
``--num_machines``/``--machine_rank``/``--main_process_ip``/
``--main_process_port`` span hosts. ``--dry_run`` prints the command and
the environment it adds instead of running. The JAX launcher's restart
supervisor (``--max_restarts``, ``--watchdog_timeout``,
``--handle_preemption``) and replication (``--replicate_to``) wait for
ROADMAP.md A7; ``--pod`` fans out over a TPU pod, which has no
counterpart here.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
from typing import Optional, Sequence

__all__ = ["launch_command", "launch_env", "main", "parser"]

AXES = ("dp_replicate", "dp_shard", "pp", "cp", "sp", "tp", "ep")


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
    p.add_argument("--max_restarts", type=int, default=None)
    p.add_argument("--watchdog_timeout", type=float, default=None)
    p.add_argument("--handle_preemption", action="store_true")
    p.add_argument("--replicate_to", default=None)
    p.add_argument("--pod", default=None)
    p.add_argument("--dry_run", action="store_true", help="print the command and env, don't run")
    p.add_argument("training_script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def _refuse_queued(args) -> None:
    if args.max_restarts or args.watchdog_timeout or args.handle_preemption:
        raise NotImplementedError(
            "--max_restarts/--watchdog_timeout/--handle_preemption: the launch supervisor "
            "(restarts, the crash-loop breaker, the heartbeat watchdog, preemption) waits for "
            "ROADMAP.md A7")
    if args.replicate_to:
        raise NotImplementedError("--replicate_to: checkpoint replication waits for ROADMAP.md A7")
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parser().parse_args(argv)
    _refuse_queued(args)
    cmd, extra = launch_command(args), launch_env(args)
    if args.dry_run:
        print(" ".join(shlex.quote(c) for c in cmd))
        for key, value in sorted(extra.items()):
            print(f"  {key}={value}")
        return 0
    # the script imports this package as the launcher did, installed or not
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
    return subprocess.call(cmd, env={**os.environ, **extra, "PYTHONPATH": path})


if __name__ == "__main__":
    sys.exit(main())
