"""A resume under FSDP2 continues bit for bit: two gloo ranks train a
2-layer tiny Llama (per-layer FSDP2 units) two steps straight, and again
one step, ``save_state``, a fresh load and the second step; every shard
of every parameter and optimizer tensor, AdamW's step counters included,
must be equal. A 0-dim step counter loaded into L per-layer parameters
was one tensor shared by all L, so AdamW's in-place increment counted it
L times an update and the layers after the first took a wrong bias
correction.
"""

import argparse
import os

import numpy as np


def _body(project, mode):
    os.environ["PARALLELISM_CONFIG_DP_SHARD_SIZE"] = "2"
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.test_utils.training import Finetune, add_finetune_args

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    ap = argparse.ArgumentParser()
    add_finetune_args(ap)
    run = Finetune(ap.parse_args(["--cpu", "--project_dir", project, "--layers", "2"]))
    assert run.acc.is_fsdp2
    if mode == "resume":
        assert run.acc.resume_from_latest()
    else:
        run.step(run.batch(0))
        if mode == "save":
            run.acc.save_state()
            run.close()
            return None
    run.step(run.batch(1))

    def local(t):
        return (t.to_local() if hasattr(t, "to_local") else t).detach().numpy().copy()

    names = {p: n for n, p in run.model.named_parameters()}
    out = {f"{n}|param": local(p) for n, p in run.model.named_parameters()}
    for p, state in run.opt.optimizer.state.items():
        out.update({f"{names[p]}|{k}": local(v) for k, v in state.items()})
    run.close()
    return out


def test_fsdp2_resume_continues_bitwise(tmp_path):
    from accelerate_tpu_torch.launchers import debug_launcher

    def launch(mode, project):
        return debug_launcher(_body, args=(str(tmp_path / project), mode), num_processes=2,
                              init_method=f"file://{tmp_path}/store_{mode}")

    straight = launch("straight", "a")
    launch("save", "b")
    resumed = launch("resume", "b")
    for rank, (want, got) in enumerate(zip(straight, resumed)):
        assert want.keys() == got.keys()
        assert any(k.endswith("|step") for k in want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"rank {rank} {key}")
