"""Start a function in several processes from one (counterpart of
``accelerate_tpu/launchers.py``).

``notebook_launcher(function, num_processes=N)`` spawns N fresh
interpreters, one per card (NCCL, ``cuda:<rank>``) or, with ``cpu=True``,
N gloo ranks on the CPU, sets the launcher environment ``PartialState``
reads (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous), runs
``function(*args)`` on every rank and raises the workers' tracebacks in
the caller. The rendezvous is a ``file://`` store in a fresh temporary
directory (no port to collide on) unless ``use_port`` asks for
``tcp://127.0.0.1:<port>``. With ``num_processes`` None or 1 the function
runs in this process. ``debug_launcher`` is the test harness's: gloo ranks
on the CPU.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import tempfile
import traceback
from typing import Callable, Optional, Tuple

__all__ = ["debug_launcher", "notebook_launcher"]


def _worker(rank: int, world: int, init_method: str, cpu: bool, payload: str, queue,
            extra_env: dict) -> None:
    try:
        with open(payload, "rb") as f:
            function, args = pickle.load(f)
        os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                           "LOCAL_WORLD_SIZE": str(world), "ACCELERATE_INIT_METHOD": init_method,
                           **extra_env})
        if cpu:
            os.environ["ACCELERATE_USE_CPU"] = "1"
        result = function(*args)
        queue.put((rank, None, result))
    except BaseException:  # noqa: BLE001 - reported to the parent
        queue.put((rank, traceback.format_exc(), None))
    finally:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _spawn(function, args, num_processes: int, cpu: bool, use_port: Optional[str] = None,
           extra_env: Optional[dict] = None, timeout: Optional[float] = None,
           init_method: Optional[str] = None) -> list:
    """Run ``function(*args)`` on ``num_processes`` spawned ranks and
    return what each returned (picklable), in rank order; raise if any
    failed or did not report within ``timeout`` seconds (default
    ``ACCELERATE_DEBUG_LAUNCHER_TIMEOUT`` or 600)."""
    if not cpu:
        import torch

        if torch.cuda.device_count() < num_processes:
            raise RuntimeError(
                f"num_processes={num_processes} processes on the card need as many CUDA devices; "
                f"this host has {torch.cuda.device_count()}. Pass cpu=True for gloo processes "
                "on the CPU")
    work_dir = tempfile.mkdtemp(prefix="accelerate_launch_")
    if init_method is None:
        init_method = (f"tcp://127.0.0.1:{int(use_port)}" if use_port
                       else "file://" + os.path.join(work_dir, "store"))
    # the function and its arguments go through a file: a pipe holds 64 KB,
    # and a larger write would hold each start until that child had read it
    payload = os.path.join(work_dir, "payload.pkl")
    with open(payload, "wb") as f:
        pickle.dump((function, args), f)
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, num_processes, init_method, cpu, payload, queue,
                                                dict(extra_env or {})))
             for r in range(num_processes)]
    timeout = timeout or float(os.environ.get("ACCELERATE_DEBUG_LAUNCHER_TIMEOUT", 600))
    errors, results = [], [None] * num_processes
    try:
        for p in procs:
            p.start()
        for _ in procs:
            try:
                rank, err, result = queue.get(timeout=timeout)
            except Exception:  # noqa: BLE001 - queue.Empty: a rank died or hangs
                dead = [f"rank {r} exitcode={p.exitcode}" for r, p in enumerate(procs)
                        if p.exitcode is not None]
                raise RuntimeError(
                    f"launcher worker gave no result within {timeout:.0f}s "
                    f"({', '.join(dead) or 'all workers still alive'})"
                    + ("\nreported failures so far:\n" + "\n".join(errors) if errors else "")
                ) from None
            results[rank] = result
            if err is not None:
                errors.append(f"--- rank {rank} ---\n{err}")
                break  # the others may wait for it in a collective
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(work_dir, ignore_errors=True)
    if errors:
        raise RuntimeError("launcher worker failure:\n" + "\n".join(errors))
    return results


def notebook_launcher(function: Callable, args: Tuple = (), num_processes: Optional[int] = None,
                      mixed_precision: str = "no", use_port: Optional[str] = None,
                      local_devices: int = 1, cpu: bool = False, **kwargs) -> None:
    """Run ``function(*args)`` on ``num_processes`` processes (see the
    module docstring); in this process when ``num_processes`` is None or
    1. ``local_devices`` is the JAX package's devices per process: here a
    process has one."""
    if local_devices != 1:
        raise ValueError(f"local_devices={local_devices}: a process drives one device here")
    extra_env = {} if mixed_precision == "no" else {"ACCELERATE_MIXED_PRECISION": mixed_precision}
    if num_processes is None or num_processes <= 1:
        if mixed_precision != "no":
            os.environ.setdefault("ACCELERATE_MIXED_PRECISION", mixed_precision)
        function(*args)
        return
    _spawn(function, args, num_processes, cpu=cpu, use_port=use_port, extra_env=extra_env)


def debug_launcher(function: Callable, args: Tuple = (), num_processes: int = 2,
                   local_devices: int = 1, init_method: Optional[str] = None) -> list:
    """Run ``function(*args)`` on ``num_processes`` gloo ranks on the CPU
    and return each rank's result; ``init_method`` (default: a ``file://``
    store in a temporary directory) is the rendezvous."""
    if local_devices != 1:
        raise ValueError(f"local_devices={local_devices}: a process drives one device here")
    return _spawn(function, args, num_processes, cpu=True, init_method=init_method)
