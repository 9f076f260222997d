"""The slice as a whole on the CPU: ``launch --cpu`` (torchrun, gloo)
over the port's durability scripts on a tiny Llama with the JAX
package's weights.

* Crash and restart: ``--num_processes 2 --max_restarts 1``, rank 1 killed
  at the end of step 2 on the first attempt; the supervisor restarts both
  ranks, they resume through consensus from the checkpoint after step 2
  and end on the uninterrupted two-process run's parameters bit for bit.
  That uninterrupted run is held to the JAX ``train_step`` trajectory on
  the same global batches within ``tests/test_torch_distributed_train.py``'s
  tolerances (losses rtol 1e-4; parameters atol 2e-5, an element whose
  JAX gradient of some update is within 1e-2 of its leaf's largest of
  zero at 2 * lr per update).
* A hang: rank 1 hangs at the end of step 2 (rank 0 then waits in the
  next step's all-reduce); both stop beating, the watchdog (45 s: above a
  worker's start on a loaded CPU, far below gloo's own 30-minute timeout,
  so the supervisor fires first) kills torchrun and every worker's process
  group, and the restart ends on the same parameters.

Host loss with a world change is ``tests/test_torch_host_loss.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = REPO / "accelerate_tpu_torch" / "test_utils" / "scripts"
ROWS, SEQ, STEPS, SAVE_AT, LR = 8, 32, 5, 2, 1e-4
ADAM_PARAM_ATOL = 2e-5
ADAM_NEAR_ZERO = 1e-2
JAX_LOSS_RTOL = 1e-4


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("ACCELERATE_")}
    env.update(PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu", ACCELERATE_RESTART_BACKOFF="0.1",
               **extra)
    return env


def _launch(flags, script, args, env=None, timeout=180):
    return subprocess.run(
        [sys.executable, "-m", "accelerate_tpu_torch.commands.launch", "--cpu", *flags,
         str(SCRIPTS / script), "--cpu", *args],
        env=env or _env(), capture_output=True, text=True, timeout=timeout)


def _jax_config():
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    return jl.LlamaConfig.tiny(num_hidden_layers=1, compute_dtype=jnp.float32,
                               attention_impl="xla", attention_kv_block=16)


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    import jax

    from accelerate_tpu.models import llama as jl
    from accelerate_tpu_torch.test_utils.training import save_tree

    params = jax.tree_util.tree_map(np.asarray, jl.init_llama_params(_jax_config(),
                                                                     jax.random.key(0)))
    path = str(tmp_path_factory.mktemp("weights") / "jax.npz")
    save_tree(path, params)
    return params, path


def _crash_args(tmp, name, weights, *extra):
    return ["--project_dir", str(tmp / name), "--weights", weights, "--rows", str(ROWS),
            "--seq", str(SEQ), "--lr", str(LR), "--total_steps", str(STEPS),
            "--save_at", str(SAVE_AT), "--out", str(tmp / f"{name}.json"),
            "--params_out", str(tmp / f"{name}.npz"), *extra]


@pytest.fixture(scope="module")
def runs(jax_weights, tmp_path_factory):
    """The uninterrupted two-process run, the crashed one and the hung one."""
    tmp = tmp_path_factory.mktemp("supervised")
    _, weights = jax_weights
    out = {}
    ref = _launch(["--num_processes", "2"], "crash_resume_script.py",
                  _crash_args(tmp, "ref", weights))
    assert ref.returncode == 0, ref.stderr[-4000:]
    crash = _launch(["--num_processes", "2", "--max_restarts", "1", "--monitor_interval", "0.5",
                     "--min_uptime", "1"], "crash_resume_script.py",
                    _crash_args(tmp, "crash", weights, "--fault", "train_step_end:kill:after=2",
                                "--fault_rank", "1"))
    hang = _launch(["--num_processes", "2", "--max_restarts", "1", "--monitor_interval", "0.5",
                    "--watchdog_timeout", "45", "--min_uptime", "1"], "crash_resume_script.py",
                   _crash_args(tmp, "hang", weights, "--fault",
                               "train_step_end:hang=600:after=2", "--fault_rank", "1"))
    for name, proc in (("ref", ref), ("crash", crash), ("hang", hang)):
        with np.load(tmp / f"{name}.npz") as z:
            out[name] = (proc, json.loads((tmp / f"{name}.json").read_text()), dict(z))
    return out


@pytest.mark.parametrize("name", ["crash", "hang"])
def test_restarted_run_ends_bitwise_on_the_uninterrupted_one(runs, name):
    proc, summary, params = runs[name]
    _, ref_summary, ref_params = runs["ref"]
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "restart 1/1" in proc.stderr
    if name == "hang":
        assert "heartbeat stale" in proc.stderr
    # the restart resumed the checkpoint after step 2 on both ranks
    assert summary["attempt"] == 1 and summary["resumed"] and summary["start"] == SAVE_AT
    assert summary["losses"] == ref_summary["losses"][SAVE_AT:]
    assert summary["checksum"] == ref_summary["checksum"]
    assert params.keys() == ref_params.keys()
    for key, ref in ref_params.items():
        np.testing.assert_array_equal(params[key], ref, err_msg=key)


def _global_batches():
    from accelerate_tpu_torch.test_utils.training import DOC_LEN, seeded_rows

    return [seeded_rows(step, ROWS, SEQ, 256, DOC_LEN["tiny"]) for step in range(STEPS)]


def _jax_trajectory(params):
    """JAX ``train_step`` at ``dp_shard_size=8`` on the global batches:
    (losses, params before each step, final params)."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu.parallelism_config import ParallelismConfig
    from accelerate_tpu.state import AcceleratorState, GradientState, PartialState

    for cls in (AcceleratorState, GradientState, PartialState):
        cls._reset_state()
    try:
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=8))
        model = jl.create_llama(_jax_config(), seed=0)
        model.params = jax.tree_util.tree_map(jnp.asarray, params)
        model, _ = acc.prepare(model, optax.adamw(LR, weight_decay=0.01))
        step = acc.train_step(jl.llama_loss, max_grad_norm=1.0)
        losses, before = [], []
        for batch in _global_batches():
            before.append(jax.tree_util.tree_map(np.asarray, model.params))
            losses.append(float(step({k: jnp.asarray(v) for k, v in batch.items()})))
        return losses, before, jax.tree_util.tree_map(np.asarray, model.params)
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()


def _near_zero(before):
    """Per leaf: where the JAX gradient of some update is within
    ADAM_NEAR_ZERO of the leaf's largest of zero."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    jcfg = _jax_config()
    grad = jax.jit(jax.grad(lambda p, b: jl.llama_loss(
        lambda ids, **kw: jl.llama_apply(jcfg, p, ids, **kw), b)))
    near = None
    for params, batch in zip(before, _global_batches()):
        g = jax.tree_util.tree_map(np.abs, grad(params, {k: jnp.asarray(v)
                                                        for k, v in batch.items()}))
        step = jax.tree_util.tree_map(lambda x: np.asarray(x) <= ADAM_NEAR_ZERO * np.max(x), g)
        near = step if near is None else jax.tree_util.tree_map(np.logical_or, near, step)
    return {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(near)}


def test_uninterrupted_run_matches_jax_train_step(runs, jax_weights):
    import jax

    params, _ = jax_weights
    _, summary, state = runs["ref"]
    losses, before, final = _jax_trajectory(params)
    np.testing.assert_allclose(summary["losses"], losses, rtol=JAX_LOSS_RTOL)
    near = _near_zero(before)
    flat = {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(final)}
    assert state.keys() == flat.keys()
    for key, leaf in flat.items():
        loose = near[key]
        np.testing.assert_allclose(state[key][~loose], leaf[~loose], rtol=0, atol=ADAM_PARAM_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(state[key][loose], leaf[loose], rtol=0, atol=2 * LR * STEPS,
                                   err_msg=key)
