"""The supervised fine-tune: train ``--total_steps`` steps, save after
each step listed in ``--save_at``, and resume from the latest checkpoint
when the supervisor restarts the script (counterpart of
``accelerate_tpu/test_utils/scripts/crash_resume_script.py``).

    python -m accelerate_tpu_torch.commands.launch --cpu --num_processes 2 \\
        --max_restarts 1 accelerate_tpu_torch/test_utils/scripts/crash_resume_script.py \\
        --cpu --project_dir /tmp/run --total_steps 6 --save_at 2 \\
        --fault train_step_end:kill:after=3 --fault_rank 1 --out /tmp/out.json

``--fault`` arms ``ACCELERATE_TPU_FAULT_INJECT`` on the first attempt
only (``ACCELERATE_RESTART_COUNT`` 0) and on ``--fault_rank`` (-1: every
rank); the script passes the point ``train_step_end`` after every step
(``kill`` at ``after=N``: SIGKILL at the end of step N, counting from 0;
``hang=S``: a hung rank the watchdog has to find). The restart resumes
with ``resume_from_latest`` (consensus with several processes) and must
end on the parameters of an uninterrupted run. The main process writes
``--out``: the losses of the steps this attempt ran, the step it resumed
at, every rank's checksum of its parameters and, with ``--params_out``,
every parameter whole (npz). See ``accelerate_tpu_torch/test_utils/training.py`` for the
model, the data and the event and launch files.
"""

from __future__ import annotations

import time

PROCESS_T = time.time()  # the script's start, before its imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))))

import numpy as np


def main() -> None:
    from accelerate_tpu_torch.test_utils.training import Finetune, add_finetune_args
    from accelerate_tpu_torch.utils.fault import FAULT_INJECT_ENV, fault_point

    ap = argparse.ArgumentParser()
    add_finetune_args(ap)
    ap.add_argument("--total_steps", type=int, default=6)
    ap.add_argument("--save_at", default="", help="comma-separated steps (from 1) after which to save")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--fault_rank", type=int, default=-1)
    ap.add_argument("--ready_file", default=None, help="touched after the first step of an attempt")
    ap.add_argument("--step_sleep", type=float, default=0.0,
                    help="seconds between steps (a preemption test's window)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--params_out", default=None)
    args = ap.parse_args()
    save_at = {int(s) for s in args.save_at.split(",") if s}

    run = Finetune(args)
    acc = run.acc
    if args.fault and run.attempt == 0 and args.fault_rank in (-1, acc.process_index):
        os.environ[FAULT_INJECT_ENV] = args.fault
    t0 = time.perf_counter()
    resumed = acc.resume_from_latest()
    start = acc.step
    run.event("start", resumed=resumed, step=start, resume_s=time.perf_counter() - t0,
              process_t=PROCESS_T, built_t=run.accelerator_t)
    losses = []
    with run.train():
        for step in range(start, args.total_steps):
            loss = run.step(run.batch(step))
            losses.append(loss.item())
            run.write_launches()
            run.event("step", step=step, loss=losses[-1])
            if step + 1 in save_at:
                t0 = time.perf_counter()
                path = acc.save_state()
                replicator = acc._replicator
                run.event("saved", step=step, path=path, save_s=time.perf_counter() - t0,
                          mirror_s=replicator.last_mirror_s if replicator is not None else None)
            if args.ready_file and step == start:
                open(args.ready_file, "w").close()
            fault_point("train_step_end", step=step)
            if args.step_sleep:
                time.sleep(args.step_sleep)
            run.boundary()
    params = run.whole_params() if args.params_out else None
    # every rank's digest of its parameters (its shards under FSDP2)
    checksum = "-".join(acc.state.gather_object(run.checksum()))
    if acc.is_main_process:
        if params is not None:
            np.savez(args.params_out, **params)
        with open(args.out, "w") as f:
            json.dump({"resumed": resumed, "start": start, "losses": losses,
                       "checksum": checksum, "attempt": run.attempt,
                       "num_processes": acc.num_processes}, f)
    run.close()
    print(f"done: resumed={resumed} start={start} attempt={run.attempt}", flush=True)


if __name__ == "__main__":
    main()
