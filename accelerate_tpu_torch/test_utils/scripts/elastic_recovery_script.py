"""Replication kill points, host loss and a resume at another world size,
each phase a process (or a launch) of its own (counterpart of
``accelerate_tpu/test_utils/scripts/elastic_recovery_script.py``).
Replication is armed by the caller through ``ACCELERATE_REPLICATION_TARGET``
and ``ACCELERATE_REPLICATION_SYNC`` (or ``launch --replicate_to``).

* ``--phase train``: step 1, a committed and replicated ``save_state``
  (``checkpoint_0``), the parameters to ``<ref_out>.step1.npz``; step 2, the
  parameters to ``<ref_out>.step2.npz``, ``--fault`` armed and a second save,
  whose replication dies at the point.
* ``--phase verify``: ``resume_from_latest()`` (``--elastic``) must restore
  a committed checkpoint, locally or from a replica when the caller wiped
  the tree; the parameters go to ``--ref_out``.
* ``--phase host_loss``: ``--steps`` steps from the loader, a save (with a
  synchronous replica, mirrored before ``save_state`` returns), a barrier,
  then ``--kill_rank`` SIGKILLs itself: a host lost after the commit.
* ``--phase resume``: ``resume_from_latest(elastic=True)``, or with
  ``--load_dir`` a direct ``load_state(load_dir, elastic=True)``, then
  ``--steps`` steps from the loader; the losses, the step and the loader's
  position after the load go to ``--out`` (JSON), the parameters to
  ``--ref_out``.
* ``--phase first_launch``: ``resume_from_latest()`` on every rank; each
  prints ``rank <r> resumed=<bool>``.

The model and the data are ``accelerate_tpu_torch/test_utils/training.py``'s
(``--loader_batches``: the rows come from a prepared loader).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys

if __package__ in (None, ""):  # run as a file: the repository root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))))

import numpy as np


def main() -> None:
    from accelerate_tpu_torch.test_utils.training import Finetune, add_finetune_args
    from accelerate_tpu_torch.utils.fault import FAULT_INJECT_ENV

    ap = argparse.ArgumentParser()
    add_finetune_args(ap)
    ap.add_argument("--phase", required=True,
                    choices=["train", "verify", "host_loss", "resume", "first_launch"])
    ap.add_argument("--ref_out", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default="none")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--kill_rank", type=int, default=1)
    ap.add_argument("--load_dir", default=None)
    ap.add_argument("--elastic", action="store_true")
    args = ap.parse_args()

    run = Finetune(args)
    acc = run.acc

    def dump(path):
        params = run.whole_params()
        if acc.is_main_process:
            np.savez(path, **params)

    if args.phase == "first_launch":
        print(f"rank {acc.process_index} resumed={acc.resume_from_latest()}", flush=True)
    elif args.phase == "verify":
        print(f"resumed={acc.resume_from_latest(elastic=args.elastic or None)}", flush=True)
        dump(args.ref_out)
    elif args.phase == "train":
        run.step(run.batch(0))
        acc.save_state()
        dump(args.ref_out + ".step1.npz")
        print("committed checkpoint_0", flush=True)
        run.step(run.batch(1))
        dump(args.ref_out + ".step2.npz")
        if args.fault != "none":
            os.environ[FAULT_INJECT_ENV] = args.fault
        acc.save_state()
        print("second save finished", flush=True)
    elif args.phase == "host_loss":
        for step in range(args.steps):
            run.step(run.batch(step))
        path = acc.save_state()
        acc.wait_for_everyone()  # the main process's mirror has landed
        print(f"rank {acc.process_index} committed {os.path.basename(path)}", flush=True)
        if acc.process_index == args.kill_rank:
            os.kill(os.getpid(), signal.SIGKILL)
    else:  # resume
        if args.load_dir:
            acc.load_state(args.load_dir, elastic=True)
            resumed = True
        else:
            resumed = acc.resume_from_latest(elastic=True)
        position = run.loader.state_dict()["position"] if run.loader is not None else None
        step0 = acc.step
        losses = [run.step(run.batch(step0 + i)).item() for i in range(args.steps)]
        if args.ref_out:
            dump(args.ref_out)
        if acc.is_main_process and args.out:
            with open(args.out, "w") as f:
                json.dump({"resumed": resumed, "step": step0, "position": position,
                           "losses": losses, "num_processes": acc.num_processes}, f)
        print(f"resumed={resumed}", flush=True)
    run.close()


if __name__ == "__main__":
    main()
