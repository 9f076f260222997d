"""Data-parallel training of the port across gloo processes on the CPU:
DDP (2 processes), FSDP2 (2) and HSDP 2 x 2 (4) against the port's one
process (``cpu=True``) and against the JAX ``train_step`` at
``ParallelismConfig(dp_shard_size=8)`` on the same 8-row global batches;
then FSDP2 checkpoints reloaded at the same and at another world size.

Every layout is launched once (``debug_launcher``, a ``file://`` store in
the test's temporary directory: no port to collide on) in a module-scoped
fixture that returns what each check needs (both accumulations; the DDP
launch also trains on each rank's own mean, the FSDP2 launch saves and
reloads); each check is its own case.

The model is a 2-layer tiny Llama in f32 (the JAX package's weights,
``params_from_jax``), AdamW (lr 1e-4, weight decay 0.01), ``max_grad_norm=
1.0``, 3 updates, with and without ``gradient_accumulation_steps=2``. Each
rank takes its block of every global batch's rows, and the ``loss_mask``
gives the ranks different valid-token counts (the second half of the rows
keeps 4 of 15 tokens), so a mean of per-rank means would differ from the
global mean: ``test_per_rank_means_differ`` holds that it does.

Tolerances:
* against one process: ``training_check``'s atol and rtol 1e-6 on every
  loss and final parameter. The ranks sum their rows' gradients in another
  order; Adam divides each gradient by its own running size, so a
  rounding-size difference moves an element by a share of lr: at lr 1e-4
  that stays below 1e-7 (the largest seen: 1.3e-7, HSDP with accumulation);
* against JAX: ``tests/test_torch_llama_train.py``'s AdamW tolerances
  (losses rtol 1e-4, parameters atol 2e-5, an element whose JAX gradient of
  some update is within 1e-2 of its leaf's largest of zero at 2 * lr per
  update).
"""

import os

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

ROWS, SEQ, UPDATES, LR = 8, 16, 3, 1e-4
LAYOUTS = {  # name -> (processes, ParallelismConfig fields)
    "ddp": (2, dict(dp_replicate_size=2)),
    "fsdp": (2, dict(dp_shard_size=2)),
    "hsdp": (4, dict(dp_replicate_size=2, dp_shard_size=2)),
}
ACCUMS = (1, 2)
ADAM_PARAM_ATOL = 2e-5
ADAM_NEAR_ZERO = 1e-2
JAX_LOSS_RTOL = 1e-4


def _batches(accum):
    """``UPDATES * accum`` global batches of ROWS rows, int32 ids and an
    uneven loss mask."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(UPDATES * accum):
        mask = np.ones((ROWS, SEQ - 1), np.float32)
        mask[ROWS // 2:, 4:] = 0
        mask[1, 9:] = 0
        out.append({"input_ids": rng.integers(0, 256, size=(ROWS, SEQ)).astype(np.int32),
                    "loss_mask": mask})
    return out


def _port_config():
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")


def _train(params, accum, pcfg=None, loss_fn=None, save_to=None, comm_hook="no", eager=False):
    """The port's trajectory on this process's rows: (losses, whole
    parameters by checkpoint key, the layout, per-rank valid-token counts
    of the first batch, and with ``save_to`` the whole optimizer tensors as
    saved). ``pcfg`` None: one process, no ParallelismConfig. ``comm_hook``:
    the gradient reduction's dtype (``DistributedDataParallelKwargs``).
    ``eager``: the ``accumulate``/``backward``/``clip_grad_norm_``/``step``
    loop instead of ``train_step``."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import DistributedDataParallelKwargs

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    cfg = _port_config()
    kw = {} if pcfg is None else {"parallelism_config": ParallelismConfig(**pcfg)}
    if comm_hook != "no":
        kw["kwargs_handlers"] = [DistributedDataParallelKwargs(comm_hook=comm_hook)]
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accum, **kw)
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    step = acc.train_step(loss_fn or tl.llama_loss, max_grad_norm=1.0)

    def eager_step(batch):
        with acc.accumulate(model):
            loss = acc.backward(tl.llama_loss, batch)
            if acc.sync_gradients:
                acc.clip_grad_norm_(model.parameters(), 1.0)
            opt.step()
            opt.zero_grad()
        return loss

    n, r = acc.num_processes, acc.process_index
    per = ROWS // n
    losses, counts = [], []
    for batch in _batches(accum):
        mine = {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in batch.items()}
        counts.append(float(mine["loss_mask"].sum()))
        losses.append((eager_step if eager else step)(mine).item())
    moments = None
    if save_to is not None:
        acc.save_state(save_to)
        moments = {k: v.numpy().copy() for k, v in _optimizer_tensors(acc, model, opt).items()}
    state = {k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()}
    return losses, state, acc.layout, acc.state.gather_object(counts[0]), moments


def _optimizer_tensors(acc, model, opt):
    """The optimizer's tensors as a checkpoint holds them (whole,
    restacked; gathered onto the main process under FSDP2)."""
    from accelerate_tpu_torch import checkpointing as ck

    sharded = any(ck._has_dtensor(m) for m in acc._models)
    return (ck._full_optimizer_parts(opt, model) if sharded else ck._optimizer_parts(opt))[0]


def _mean_of_means(model, batch):
    """``llama_loss`` without its ``ce_denominator``: each rank's own mean."""
    from accelerate_tpu_torch.models import llama as tl

    return tl.llama_loss(model, batch)


def _layout_body(params, pcfg, name, ckpt):
    """One launch per layout: both accumulations' trajectories; DDP also
    trains with each rank's own mean; FSDP2 saves its first run's state and
    loads it into a fresh model at the same world size."""
    out = {accum: _train(params, accum, pcfg, save_to=ckpt if name == "fsdp" and accum == 1
                         else None) for accum in ACCUMS}
    out["eager"] = _train(params, 2, pcfg, eager=True)
    if name == "ddp":
        out["mean_of_means"] = _train(params, 1, pcfg, loss_fn=_mean_of_means)
        # gloo has no bf16 all-reduce (DDP's bf16 hook needs NCCL): fp16 here
        out["fp16_hook"] = _train(params, 1, pcfg, comm_hook="fp16")
    if name == "fsdp":
        out["reload"] = _load(params, ckpt, pcfg, elastic=False)
        out["bf16_hook"] = _train(params, 1, pcfg, comm_hook="bf16")
    return out


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from accelerate_tpu.models import llama as jl

    jcfg = _jax_config()
    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(jcfg, jax.random.key(0)))


def _jax_config():
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    return jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla",
                               attention_kv_block=16)


@pytest.fixture(scope="module")
def runs(jax_params, tmp_path_factory):
    """Every layout's trajectories, one launch per layout."""
    tmp = tmp_path_factory.mktemp("dp_train")
    out = {"ckpt": str(tmp / "fsdp_ckpt")}
    try:
        for accum in ACCUMS:
            out[("one", accum)] = _train(jax_params, accum)
        for name, (procs, pcfg) in LAYOUTS.items():
            res = debug_launcher(_layout_body, args=(jax_params, pcfg, name, out["ckpt"]),
                                 num_processes=procs, init_method=f"file://{tmp}/store_{name}")[0]
            for accum in ACCUMS:
                out[(name, accum)] = res[accum]
            out.update({k: v for k, v in res.items() if isinstance(k, str) and k != "eager"})
            out[("eager", name)] = res["eager"]
    finally:
        from accelerate_tpu_torch.state import AcceleratorState, GradientState

        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return out


CASES = [(name, accum) for accum in ACCUMS for name in LAYOUTS]


@pytest.mark.parametrize("name,accum", CASES)
def test_trajectory_matches_one_process(runs, name, accum):
    losses, state, layout, _, _ = runs[(name, accum)]
    ref_losses, ref_state, ref_layout, _, _ = runs[("one", accum)]
    assert layout == name and ref_layout == "none"
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6, atol=1e-6)
    assert state.keys() == ref_state.keys()
    for key, ref in ref_state.items():
        np.testing.assert_allclose(state[key], ref, rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_eager_loop_matches_train_step(runs, name):
    # accumulate (no_sync on the micro-step that does not update), backward,
    # clip_grad_norm_, step: the same updates as train_step, accumulation 2
    losses, state = runs[("eager", name)][:2]
    ref_losses, ref_state = runs[(name, 2)][:2]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6, atol=1e-6)
    for key, ref in ref_state.items():
        np.testing.assert_allclose(state[key], ref, rtol=1e-6, atol=1e-6, err_msg=key)


def test_per_rank_means_differ(runs):
    # the ranks saw different valid-token counts, and the mean of their
    # means is not the global mean: the denominator is all-reduced
    counts = runs[("ddp", 1)][3]
    assert counts[0] != counts[1]
    losses = runs["mean_of_means"][0]
    ref = runs[("one", 1)][0]
    assert abs(losses[0] - ref[0]) > 1e-3 * abs(ref[0])


@pytest.mark.parametrize("hook", ["fp16_hook", "bf16_hook"])
def test_comm_hook_reduces_in_the_compressed_dtype(runs, hook):
    # DDP's fp16 compress hook and FSDP2's bf16 reduce_dtype: the first loss
    # (before any update) is the same, the updates differ by the rounding of
    # the reduced gradients, the losses within that dtype's precision
    losses, state = runs[hook][:2]
    ref_losses, ref_state = runs[("one", 1)][:2]
    assert losses[0] == pytest.approx(ref_losses[0], rel=1e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-2)
    assert any(not np.array_equal(state[k], ref_state[k]) for k in ref_state)
    for key, ref in ref_state.items():
        np.testing.assert_allclose(state[key], ref, rtol=0, atol=1e-2, err_msg=key)


def _jax_trajectory(params, accum):
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
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=8),
                           gradient_accumulation_steps=accum)
        model = jl.create_llama(_jax_config(), seed=0)
        model.params = jax.tree_util.tree_map(jnp.asarray, params)
        model, _ = acc.prepare(model, optax.adamw(LR, weight_decay=0.01))
        step = acc.train_step(jl.llama_loss, max_grad_norm=1.0)
        losses, before = [], []
        for batch in _batches(accum):
            before.append(jax.tree_util.tree_map(np.asarray, model.params))
            losses.append(float(step({k: jnp.asarray(v) for k, v in batch.items()})))
        return losses, before, jax.tree_util.tree_map(np.asarray, model.params)
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()


def _near_zero(before, accum):
    """Per leaf: where the JAX gradient of some update (summed over its
    micro-batches) is within ADAM_NEAR_ZERO of the leaf's largest of zero."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    jcfg = _jax_config()
    grad = jax.jit(jax.grad(lambda p, b: jl.llama_loss(
        lambda ids, **kw: jl.llama_apply(jcfg, p, ids, **kw), b)))
    batches = _batches(accum)
    near = None
    for u in range(0, len(batches), accum):
        gs = [grad(before[u], {k: jnp.asarray(v) for k, v in b.items()})
              for b in batches[u:u + accum]]
        g = jax.tree_util.tree_map(lambda *x: np.abs(sum(np.asarray(y) for y in x)), *gs)
        step = jax.tree_util.tree_map(lambda x: x <= ADAM_NEAR_ZERO * x.max(), g)
        near = step if near is None else jax.tree_util.tree_map(np.logical_or, near, step)
    return {".".join(k.key for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(near)}


@pytest.fixture(scope="module")
def jax_runs(jax_params):
    out = {}
    for accum in ACCUMS:
        losses, before, final = _jax_trajectory(jax_params, accum)
        import jax

        flat = {".".join(k.key for k in path): leaf
                for path, leaf in jax.tree_util.tree_leaves_with_path(final)}
        out[accum] = (losses, flat, _near_zero(before, accum))
    return out


@pytest.mark.parametrize("name,accum", [(n, a) for a in ACCUMS for n in ("ddp", "fsdp")])
def test_trajectory_matches_jax(runs, jax_runs, name, accum):
    losses, state = runs[(name, accum)][:2]
    jlosses, jstate, near = jax_runs[accum]
    np.testing.assert_allclose(losses, jlosses, rtol=JAX_LOSS_RTOL)
    assert state.keys() == jstate.keys()
    for key, leaf in jstate.items():
        loose = near[key]
        np.testing.assert_allclose(state[key][~loose], leaf[~loose], rtol=0, atol=ADAM_PARAM_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(state[key][loose], leaf[loose], rtol=0,
                                   atol=2 * LR * UPDATES, err_msg=key)


# ------------------------------------------------------------ checkpoints
def _load(params, path, pcfg, elastic):
    """A fresh model (the saved run's parameter order, other values) and
    optimizer loading ``path``: (whole parameters, whole optimizer tensors)
    or the error's type and text."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    kw = {} if pcfg is None else {"parallelism_config": ParallelismConfig(**pcfg)}
    acc = Accelerator(cpu=True, **kw)
    cfg = _port_config()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(
        cfg, _map(lambda a: a + 1.0, params), device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    try:
        acc.load_state(path, **({"elastic": True} if elastic else {}))
    except Exception as e:  # noqa: BLE001 - returned to the test
        return f"{type(e).__name__}: {e}"
    return ({k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()},
            {k: v.numpy().copy() for k, v in _optimizer_tensors(acc, model, opt).items()})


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def reloads(runs, jax_params):
    out = {"same": runs["reload"]}
    try:
        out["strict"] = _load(jax_params, runs["ckpt"], None, False)
        out["elastic"] = _load(jax_params, runs["ckpt"], None, True)
    finally:
        from accelerate_tpu_torch.state import AcceleratorState, GradientState

        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
    return out


def test_fsdp_checkpoint_is_one_file_set_of_whole_tensors(runs):
    from accelerate_tpu_torch.utils.serialization import SafetensorsReader

    files = sorted(os.listdir(runs["ckpt"]))
    assert files == ["COMMITTED", "model", "optimizer", "optimizer_meta.json",
                     "random_states_0.pkl", "random_states_1.pkl", "sampler.json"]
    with SafetensorsReader(os.path.join(runs["ckpt"], "model")) as reader:
        assert tuple(reader.get("layers.attn.q_proj.kernel").shape) == (2, 64, 64)


@pytest.mark.parametrize("case", ["same", "elastic"])
def test_fsdp_checkpoint_reloads_bitwise(runs, reloads, case):
    # the saved run's parameters (as trained) and its moments (as a one-
    # process save would write them) come back bitwise, at world size 2
    # and, with elastic=True, at 1
    params, moments = reloads[case]
    _, saved, _, _, saved_moments = runs[("fsdp", 1)]
    assert params.keys() == saved.keys()
    for key in saved:
        assert np.array_equal(params[key], saved[key]), key
    # AdamW's exp_avg, exp_avg_sq and step of every stacked leaf
    assert moments.keys() == saved_moments.keys() and len(moments) == 3 * len(saved)
    for key in saved_moments:
        assert np.array_equal(moments[key], saved_moments[key]), key


def test_fsdp_checkpoint_of_another_world_needs_elastic(reloads):
    assert reloads["strict"].startswith("CheckpointTopologyError")
    assert "num_processes 2 (saved) != 1 (live)" in reloads["strict"]
    assert "elastic=True" in reloads["strict"]
