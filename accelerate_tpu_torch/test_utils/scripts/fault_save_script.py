"""Die at a named point inside ``save_state``, then prove that the
previous committed checkpoint survived bit for bit (counterpart of
``accelerate_tpu/test_utils/scripts/fault_save_script.py``). Each phase
is a process of its own:

* ``--phase train``: one step, a committed ``save_state``
  (``checkpoint_0``), the parameters after it to ``--ref_out`` (npz); then
  ``ACCELERATE_TPU_FAULT_INJECT=<--fault>`` armed in this process, a
  second step and a second save, which dies at the point (SIGKILL by
  default) and leaves whatever the death left.
* ``--phase verify``: a fresh process's ``resume_from_latest()`` must roll
  back to ``checkpoint_0``; the restored parameters go to ``--ref_out``.

The model and the data are ``accelerate_tpu_torch/test_utils/training.py``'s.
"""

from __future__ import annotations

import argparse
import os
import sys

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))))

import numpy as np


def main() -> None:
    from accelerate_tpu_torch.test_utils.training import Finetune, add_finetune_args, say
    from accelerate_tpu_torch.utils.fault import FAULT_INJECT_ENV

    ap = argparse.ArgumentParser()
    add_finetune_args(ap)
    ap.add_argument("--phase", choices=["train", "verify"], required=True)
    ap.add_argument("--ref_out", required=True)
    ap.add_argument("--fault", default="before_commit",
                    help="the fault spec armed before the second save (point[:action])")
    args = ap.parse_args()

    run = Finetune(args)
    if args.phase == "verify":
        say(f"resumed={run.acc.resume_from_latest()}")
        np.savez(args.ref_out, **run.whole_params())
        run.close()
        return
    run.step(run.batch(0))
    run.acc.save_state()
    np.savez(args.ref_out, **run.whole_params())
    say("committed checkpoint_0")
    run.step(run.batch(1))
    os.environ[FAULT_INJECT_ENV] = args.fault
    run.acc.save_state()
    say("save unexpectedly survived")


if __name__ == "__main__":
    main()
