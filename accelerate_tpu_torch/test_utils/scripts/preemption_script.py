"""Train slowly until SIGTERM arrives: the preemption handler writes a
committed emergency checkpoint and the process exits cleanly
(counterpart of ``accelerate_tpu/test_utils/scripts/preemption_script.py``).

Run under ``launch --handle_preemption``: the launcher forwards its own
SIGTERM to every rank, the ranks agree at the next step boundary and
each writes its part of one emergency checkpoint, leaves its marker for
the supervisor and exits 143; the test signals the launcher once
``--ready_file`` appears and expects

* "emergency checkpoint committed at ..." on stdout,
* the launcher's exit code 0 (a planned shutdown: no restart),
* a committed checkpoint that a fresh process loads.

The model and the data are ``accelerate_tpu_torch/test_utils/training.py``'s.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))))


def main() -> None:
    from accelerate_tpu_torch.test_utils.training import Finetune, add_finetune_args

    ap = argparse.ArgumentParser()
    add_finetune_args(ap)
    ap.add_argument("--ready_file", required=True,
                    help="touched after the first step: the test's cue to send SIGTERM")
    ap.add_argument("--max_steps", type=int, default=600)
    ap.add_argument("--step_sleep", type=float, default=0.05,
                    help="a slow cadence, so that the signal lands between steps")
    args = ap.parse_args()

    run = Finetune(args)
    run.acc.resume_from_latest()
    with run.train():
        for step in range(run.acc.step, args.max_steps):
            run.step(run.batch(step))
            if not os.path.exists(args.ready_file):
                open(args.ready_file, "w").close()
                print("training started", flush=True)
            time.sleep(args.step_sleep)
            run.boundary()
    run.close()
    print("finished without preemption", flush=True)


if __name__ == "__main__":
    main()
