"""Tensor-parallel training of the port across gloo processes on the CPU:
``tp_size=2`` (2 processes), ``dp_shard_size=2 x tp_size=2`` (4) and
``dp_replicate_size=2 x tp_size=2`` (4) against the port's one process
(``cpu=True``) and against the JAX ``train_step`` at
``ParallelismConfig(dp_shard_size=4, tp_size=2)`` on the suite's 8 virtual
devices, on the same 8-row global batches; the tensor-parallel forward and
gradients with every Llama knob, the all-reduce path of a sequence ``tp``
does not divide, a planted fault, the rows each rank reads, checkpoints
across layouts and big-model loading over a mesh.

Every layout is launched once (``debug_launcher``, a ``file://`` store in
the test's temporary directory) in a module-scoped fixture that returns
what each check needs; each check is its own case.

The model is a 2-layer tiny Llama in f32 (the JAX package's weights,
``params_from_jax``), AdamW (lr 1e-4, weight decay 0.01), ``max_grad_norm=
1.0``, 3 updates, with and without ``gradient_accumulation_steps=2``; the
data-parallel ranks take their blocks of every global batch's rows and the
``loss_mask`` gives them different valid-token counts (the ``tp`` ranks of
one data-parallel coordinate read the same rows).

Tolerances:
* against one process: 1e-6 (atol and rtol) on every loss and on every
  parameter element whose one-process gradient is zero or above
  ``ADAM_EPS_BAND`` (1e-6, a hundred times AdamW's epsilon) at every
  update. Tensor parallelism sums each row-parallel product's partial
  sums, and the sequence gather's gradient, in another order than one
  process's GEMM: the gradients agree to rounding. AdamW divides each
  gradient by its own running size, so an element whose gradient is
  itself rounding-sized (observed: 4e-8, 5e-7 of its leaf's largest)
  moves by a share of lr; it is held at ``2 * lr`` an update, Adam's
  largest difference, and such elements must be under 0.1 % of all;
* against JAX: ``tests/test_torch_llama_train.py``'s AdamW tolerances;
* gradients of one backward (the knobs): ``GRAD_ATOL`` 1e-6 absolute and
  ``GRAD_RTOL`` 1e-5 on every element, the losses 1e-6;
* big-model logits: ``LOGIT_ATOL`` 1e-5 (f32 logits of order 1).
"""

import os

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

ROWS, SEQ, UPDATES, LR = 8, 16, 3, 1e-4
LAYOUTS = {  # name -> (processes, ParallelismConfig fields)
    "tp": (2, dict(tp_size=2)),
    "tp_fsdp": (4, dict(dp_shard_size=2, tp_size=2)),
    "tp_hsdp": (4, dict(dp_replicate_size=2, tp_size=2)),
}
ACCUMS = (1, 2)
ADAM_EPS_BAND = 1e-6
ADAM_PARAM_ATOL = 2e-5
ADAM_NEAR_ZERO = 1e-2
JAX_LOSS_RTOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-5
LOGIT_ATOL = 1e-5
# every knob of LlamaConfig the tensor-parallel forward runs (Gemma, Qwen)
KNOBS = dict(attention_bias=True, tie_word_embeddings=True, post_block_norms=True,
             attn_logit_softcap=20.0, final_logit_softcap=15.0, query_pre_attn_scalar=32.0,
             rms_norm_offset=True, scale_embeddings=True, hidden_act="gelu_tanh")
GRAD_CASES = {  # name -> (config fields, sequence length, chunked CE)
    "dense": ({}, SEQ, False),
    "chunked": ({}, SEQ, True),
    "seq15": ({}, 15, False),
    "knobs": (KNOBS, SEQ, False),
    "knobs_chunked_seq15": (KNOBS, 15, True),
}


def _batches(accum, seq=SEQ):
    """``UPDATES * accum`` global batches of ROWS rows, int32 ids and an
    uneven loss mask."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(UPDATES * accum):
        mask = np.ones((ROWS, SEQ - 1), np.float32)
        mask[ROWS // 2:, 4:] = 0
        mask[1, 9:] = 0
        out.append({"input_ids": rng.integers(0, 256, size=(ROWS, SEQ)).astype(np.int32)[:, :seq],
                    "loss_mask": mask[:, :seq - 1]})
    return out


def _port_config(**kw):
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", **kw)


def _reset():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _accelerator(pcfg, accum=1):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    _reset()
    kw = {} if pcfg is None else {"parallelism_config": ParallelismConfig(**pcfg)}
    return Accelerator(cpu=True, gradient_accumulation_steps=accum, **kw)


def _rows(acc, batch):
    """This data-parallel rank's block of a global batch."""
    n = acc.parallelism_config.data_parallel_size if acc.mesh is not None else 1
    r, per = acc.data_parallel_rank, ROWS // n
    return {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in batch.items()}


def _train(params, accum, pcfg=None, save_to=None, eager=False, fault=False):
    """The port's trajectory on this rank's rows: (losses, whole parameters
    by checkpoint key, the layout, with ``save_to`` the whole optimizer
    tensors as saved). ``pcfg`` None: one process. ``eager``: the
    ``accumulate``/``backward``/``clip_grad_norm_``/``step`` loop.
    ``fault``: the ``tp`` sum of the replicated parameters' gradients left
    out."""
    from accelerate_tpu_torch.models import llama as tl

    acc = _accelerator(pcfg, accum)
    cfg = _port_config()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    if fault:
        opt.tp_replicated = []
    step = acc.train_step(tl.llama_loss, max_grad_norm=1.0)

    def eager_step(batch):
        with acc.accumulate(model):
            loss = acc.backward(tl.llama_loss, batch)
            if acc.sync_gradients:
                acc.clip_grad_norm_(model.parameters(), 1.0)
            opt.step()
            opt.zero_grad()
        return loss

    losses = [(eager_step if eager else step)(_rows(acc, b)).item() for b in _batches(accum)]
    moments = None
    if save_to is not None:
        acc.save_state(save_to)
        moments = _optimizer_tensors(acc, model, opt)
    state = {k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()}
    return losses, state, acc.layout, moments


def _optimizer_tensors(acc, model, opt):
    """The optimizer's tensors as a checkpoint holds them (whole,
    restacked; gathered onto the main process under a sharded layout)."""
    from accelerate_tpu_torch import checkpointing as ck

    sharded = any(ck._has_dtensor(m) for m in acc._models)
    parts = (ck._full_optimizer_parts(opt, model) if sharded else ck._optimizer_parts(opt))[0]
    return {k: v.numpy().copy() for k, v in parts.items()}


def _whole_grads(model, opt) -> dict:
    """Every gradient whole (``tp`` sums done, blocks gathered), restacked
    under its checkpoint key."""
    opt.grads()  # the update's tp sum of the replicated parameters' gradients
    named = dict(model.named_parameters())

    def whole(name):
        g = named[name].grad
        return (g.full_tensor() if hasattr(g, "full_tensor") else g).detach()

    return {key: torch.stack([whole(f) for f in fqns]).numpy() if stacked
            else whole(fqns[0]).numpy() for key, fqns, stacked in model.checkpoint_fqns()}


def _grad_case(name, pcfg):
    """One backward of ``GRAD_CASES[name]`` on the whole first batch:
    (loss, whole gradients)."""
    from accelerate_tpu_torch.models import llama as tl

    fields, seq, chunked = GRAD_CASES[name]
    acc = _accelerator(pcfg)
    cfg = _port_config(use_chunked_ce=chunked, ce_chunk_size=48, **fields)
    model = tl.create_llama(cfg, seed=3, device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    model, opt = acc.prepare(model, opt)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1, seq)[0].items()}
    loss = acc.backward(tl.llama_loss, batch)
    if pcfg is None:
        grads = {key: getattr(model, n).grad.numpy().copy() for key, n in model.checkpoint_keys()}
    else:
        grads = _whole_grads(model, opt)
    return loss.item(), grads


def _mesh_logits(params, ckpt):
    """The tiny Llama's f32 logits on the first batch through
    ``dispatch_model``, ``load_checkpoint_and_dispatch`` (a model built
    empty) and ``cpu_offload(execution_mesh=)`` over the ``tp`` mesh."""
    from accelerate_tpu_torch.big_modeling import (
        cpu_offload,
        dispatch_model,
        init_empty_weights,
        load_checkpoint_and_dispatch,
    )
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules

    acc = _accelerator(dict(tp_size=2))
    cfg = _port_config()
    ids = torch.from_numpy(_batches(1)[0]["input_ids"])
    out = {}
    with torch.no_grad():
        model = dispatch_model(tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu")),
                               mesh=acc.mesh, rules=tensor_parallel_rules())
        out["dispatch"] = (model(ids).numpy(), model.tp is not None)
        with init_empty_weights():
            empty = tl.create_llama(cfg)
        model = load_checkpoint_and_dispatch(empty, ckpt, mesh=acc.mesh, rules=tensor_parallel_rules())
        out["load"] = (model(ids).numpy(), model.tp is not None)
        model = cpu_offload(tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu")),
                            execution_mesh=acc.mesh)
        out["offload"] = (model(ids).numpy(), model.tp is not None)
    return out


def _rows_seen(pcfg):
    """(``data_shard_info()``, this rank's data-parallel coordinate, the
    rows a prepared loader gives it) on the layout's mesh."""
    from accelerate_tpu_torch.data_loader import data_shard_info

    acc = _accelerator(pcfg)
    loader = acc.prepare_data_loader({"x": np.arange(16.0)[:, None]}, batch_size=2)
    rows = [b["x"].ravel().tolist() for b in loader]
    return data_shard_info(), acc.data_parallel_rank, rows


def _metrics(pcfg):
    """What ``gather_for_metrics`` gives over a loader of 11 rows, 2 a
    rank a batch (the last global batch short: a nonzero remainder), for
    tensors and through the object gather; and ``reduce`` of each
    data-parallel rank's ``rank + 1``, summed and averaged."""
    acc = _accelerator(pcfg)
    loader = acc.prepare_data_loader({"x": np.arange(11.0)[:, None]}, batch_size=2)
    tensors, objects = [], []
    for batch in loader:
        tensors.append(acc.gather_for_metrics(batch["x"]).ravel().tolist())
        objects.append(acc.gather_for_metrics(batch["x"].ravel().tolist(), use_gather_object=True))
    mine = torch.tensor([float(acc.data_parallel_rank + 1)])
    return (tensors, objects, acc.reduce(mine).item(), acc.reduce(mine, reduction="mean").item())


def _plan_bytes(pcfg):
    """``{checkpoint key: bytes one rank holds}`` of Llama-3-8B's shapes at
    2 layers, built empty, over the layout's mesh with the tensor-parallel
    rules; and ``get_max_memory(mesh=)``."""
    from accelerate_tpu_torch.big_modeling import get_max_memory, init_empty_weights, plan_shardings
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules

    acc = _accelerator(pcfg)
    with init_empty_weights():
        model = tl.create_llama(tl.LlamaConfig.llama3_8b(num_hidden_layers=2))
    plan = plan_shardings(model, acc.mesh, rules=tensor_parallel_rules(), hbm_budget_bytes=2**40)
    try:
        plan_shardings(model, acc.mesh, rules=tensor_parallel_rules(), hbm_budget_bytes=2**30)
        too_small = None
    except MemoryError as e:
        too_small = str(e)
    return {k: p.rank_bytes for k, p in plan.items()}, get_max_memory(acc.mesh), too_small


def _load(params, path, pcfg):
    """A fresh model (other values) and optimizer loading ``path`` with
    ``elastic=True``: (whole parameters, whole optimizer tensors)."""
    from accelerate_tpu_torch.models import llama as tl

    acc = _accelerator(pcfg)
    cfg = _port_config()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(
        cfg, _map(lambda a: a + 1.0, params), device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    acc.load_state(path, elastic=True)
    return ({k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()},
            _optimizer_tensors(acc, model, opt))


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _layout_body(params, pcfg, name, paths):
    """One launch per layout: both accumulations' trajectories and the eager
    loop; ``tp`` also the planted fault, the gradient cases and big-model
    loading; ``tp_fsdp`` the rows, the plan and both checkpoints."""
    out = {accum: _train(params, accum, pcfg, save_to=paths["tp_fsdp"]
                         if name == "tp_fsdp" and accum == 1 else None) for accum in ACCUMS}
    out["eager"] = _train(params, 2, pcfg, eager=True)
    out["freed"] = _replaced_parameters_freed(params, pcfg)
    if name == "tp":
        out["fault"] = _train(params, 1, pcfg, fault=True)
        out["grads"] = {case: _grad_case(case, pcfg) for case in GRAD_CASES}
        out["mesh_logits"] = _mesh_logits(params, paths["model"])
    if name == "tp_fsdp":
        out["rows"] = _rows_seen(pcfg)
        out["metrics"] = _metrics(pcfg)
        out["plan"] = _plan_bytes(pcfg)
        out["from_fsdp"] = _load(params, paths["fsdp"], pcfg)
    return out


def _replaced_parameters_freed(params, pcfg):
    """Whether, once ``prepare`` pointed the optimizer at the parameters
    that took their place, nothing keeps the model's original (whole,
    stacked) parameters alive."""
    import gc
    import weakref

    from accelerate_tpu_torch.models import llama as tl

    acc = _accelerator(pcfg)
    cfg = _port_config()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR)
    refs = [weakref.ref(p) for p in model.parameters()]
    model, opt = acc.prepare(model, opt)
    gc.collect()
    return sum(r() is not None for r in refs), len(refs)


def _fsdp_body(params, path):
    """FSDP-2 trains and saves the checkpoint the tensor-parallel layout
    restores."""
    return _train(params, 1, dict(dp_shard_size=2), save_to=path)


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from accelerate_tpu.models import llama as jl

    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(_jax_config(), jax.random.key(0)))


def _jax_config():
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    return jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla",
                               attention_kv_block=16)


def _near_adam_eps(params, accum):
    """By checkpoint key: where the one-process trajectory's gradient of
    some update (summed over its micro-batches) is nonzero but below
    ADAM_EPS_BAND. An exact zero (an embedding row no token of the batch
    looks up) is one on every layout and is held at 1e-6."""
    from accelerate_tpu_torch.models import llama as tl

    acc = _accelerator(None, accum)
    cfg = _port_config()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    near = {}
    for batch in _batches(accum):
        with acc.accumulate(model):
            acc.backward(tl.llama_loss, {k: torch.from_numpy(v) for k, v in batch.items()})
            if acc.sync_gradients:
                for key, n in model.checkpoint_keys():
                    g = getattr(model, n).grad.abs().numpy()
                    near[key] = near.get(key, False) | ((g > 0) & (g < ADAM_EPS_BAND))
                acc.clip_grad_norm_(model.parameters(), 1.0)
            opt.step()
            opt.zero_grad()
    return near


@pytest.fixture(scope="module")
def runs(jax_params, tmp_path_factory):
    """Every layout's results, one launch per layout, and the one-process
    references."""
    from accelerate_tpu_torch.checkpointing import save_model_checkpoint
    from accelerate_tpu_torch.models import llama as tl

    tmp = tmp_path_factory.mktemp("tp_train")
    paths = {"fsdp": str(tmp / "fsdp_ckpt"), "tp_fsdp": str(tmp / "tp_fsdp_ckpt"),
             "model": str(tmp / "model")}
    out = {"paths": paths}
    try:
        for accum in ACCUMS:
            out[("one", accum)] = _train(jax_params, accum)
            out[("near_eps", accum)] = _near_adam_eps(jax_params, accum)
        out["one_grad_cases"] = {case: _grad_case(case, None) for case in GRAD_CASES}
        cfg = _port_config()
        model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, jax_params, device="cpu"))
        save_model_checkpoint(model, paths["model"])
        with torch.no_grad():
            out["one_logits"] = model(torch.from_numpy(_batches(1)[0]["input_ids"])).numpy()
        out["one_metrics"] = _metrics(None)
        out["fsdp"] = debug_launcher(_fsdp_body, args=(jax_params, paths["fsdp"]), num_processes=2,
                                     init_method=f"file://{tmp}/store_fsdp")[0]
        for name, (procs, pcfg) in LAYOUTS.items():
            res = debug_launcher(_layout_body, args=(jax_params, pcfg, name, paths),
                                 num_processes=procs, init_method=f"file://{tmp}/store_{name}")
            out[name] = res[0]
            if name == "tp_fsdp":
                out["rows"] = [r["rows"] for r in res]
        out["one_from_tp_fsdp"] = _load(jax_params, paths["tp_fsdp"], None)
    finally:
        _reset()
    return out


CASES = [(name, accum) for accum in ACCUMS for name in LAYOUTS]


def _assert_params_close(state, ref, near):
    """1e-6 on every element whose one-process gradient was never nonzero
    and below ADAM_EPS_BAND; 2 * lr an update on the others, which must be
    few."""
    assert state.keys() == ref.keys()
    loose_total = 0
    for key, want in ref.items():
        loose = near[key]
        loose_total += int(loose.sum())
        np.testing.assert_allclose(state[key][~loose], want[~loose], rtol=1e-6, atol=1e-6,
                                   err_msg=key)
        np.testing.assert_allclose(state[key][loose], want[loose], rtol=0, atol=2 * LR * UPDATES,
                                   err_msg=key)
    assert loose_total <= 1e-3 * sum(v.size for v in ref.values())


@pytest.mark.parametrize("name,accum", CASES)
def test_trajectory_matches_one_process(runs, name, accum):
    losses, state, layout, _ = runs[name][accum]
    ref_losses, ref_state, ref_layout, _ = runs[("one", accum)]
    assert layout == name and ref_layout == "none"
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6, atol=1e-6)
    _assert_params_close(state, ref_state, runs[("near_eps", accum)])


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_eager_loop_matches_train_step(runs, name):
    # accumulate, backward, clip_grad_norm_, step: the updates of
    # train_step, accumulation 2
    losses, state = runs[name]["eager"][:2]
    ref_losses, ref_state = runs[name][2][:2]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-6, atol=1e-6)
    for key, ref in ref_state.items():
        np.testing.assert_allclose(state[key], ref, rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_prepare_frees_the_replaced_parameters(runs, name):
    # the optimizer follows the per-layer blocks; the whole stacked f32
    # weights they were cut from (a model's worth on each rank) are freed
    alive, total = runs[name]["freed"]
    assert total > 0 and alive == 0


def test_norm_gradients_left_unsummed_over_tp_differ(runs):
    # the planted fault: each tp rank keeps its sequence block's share of
    # the norm scales' gradients; the check's tolerance must see it
    losses, state = runs["tp"]["fault"][:2]
    ref_losses, ref_state = runs[("one", 1)][:2]
    norms = [k for k in ref_state if k.endswith("norm.scale")]
    worst = max(float(np.abs(state[k] - ref_state[k]).max()) for k in norms)
    assert worst > 100 * 1e-6, worst
    good = runs["tp"][1][1]
    assert max(float(np.abs(good[k] - ref_state[k]).max()) for k in norms) <= 1e-6


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_forward_and_gradients_match_one_process(runs, case):
    # Qwen biases, tied embeddings, Gemma's post-block norms, offset norms
    # and embedding scale, both softcaps, query_pre_attn_scalar, GeGLU;
    # chunked CE; 15 tokens over tp=2 (the all-reduce path)
    loss, grads = runs["tp"]["grads"][case]
    ref_loss, ref_grads = runs["one_grad_cases"][case]
    assert loss == pytest.approx(ref_loss, rel=1e-6, abs=1e-6)
    assert grads.keys() == ref_grads.keys()
    for key, ref in ref_grads.items():
        np.testing.assert_allclose(grads[key], ref, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)


def test_chunked_loss_matches_dense_under_tp(runs):
    loss, grads = runs["tp"]["grads"]["chunked"]
    dense_loss, dense_grads = runs["tp"]["grads"]["dense"]
    assert loss == pytest.approx(dense_loss, rel=1e-6)
    for key, ref in dense_grads.items():
        np.testing.assert_allclose(grads[key], ref, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=key)


# ------------------------------------------------------------------ JAX
def _jax_trajectory(params, accum):
    """JAX ``train_step`` at ``dp_shard_size=4, tp_size=2``: (losses,
    params before each step, final params)."""
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
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=4, tp_size=2),
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
    import jax

    out = {}
    for accum in ACCUMS:
        losses, before, final = _jax_trajectory(jax_params, accum)
        flat = {".".join(k.key for k in path): leaf
                for path, leaf in jax.tree_util.tree_leaves_with_path(final)}
        out[accum] = (losses, flat, _near_zero(before, accum))
    return out


@pytest.mark.parametrize("name,accum", CASES)
def test_trajectory_matches_jax(runs, jax_runs, name, accum):
    losses, state = runs[name][accum][:2]
    jlosses, jstate, near = jax_runs[accum]
    np.testing.assert_allclose(losses, jlosses, rtol=JAX_LOSS_RTOL)
    assert state.keys() == jstate.keys()
    for key, leaf in jstate.items():
        loose = near[key]
        np.testing.assert_allclose(state[key][~loose], leaf[~loose], rtol=0, atol=ADAM_PARAM_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(state[key][loose], leaf[loose], rtol=0,
                                   atol=2 * LR * UPDATES, err_msg=key)


# ------------------------------------------------------------------ rows
def test_tp_ranks_read_the_rows_of_their_data_parallel_coordinate(runs):
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from accelerate_tpu.data_loader import data_shard_info as jax_data_shard_info

    # JAX's shard math on a dp_shard x tp mesh, one device a process
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp_shard", "tp"))
    sharding = NamedSharding(mesh, P(("dp_shard",)))
    order = {d.id: i for i, d in enumerate(mesh.devices.flatten())}
    want = [jax_data_shard_info(sharding, process_index=p, num_processes=4,
                                process_of_device=lambda d: order[d.id]) for p in range(4)]
    got = [info for info, _, _ in runs["rows"]]
    assert got == want == [(2, 0, 1), (2, 0, 1), (2, 1, 1), (2, 1, 1)]
    rows = [r for _, _, r in runs["rows"]]
    assert rows[0] == rows[1] and rows[2] == rows[3] and rows[0] != rows[2]
    assert sorted(x for r in (rows[0], rows[2]) for b in r for x in b) == list(np.arange(16.0))


def test_gather_for_metrics_and_reduce_count_each_data_parallel_rank_once(runs):
    # TP 2 x FSDP2 2: the tp ranks of one coordinate hold the same rows;
    # each row comes back once, the last batch's remainder keeps the real
    # samples of both data-parallel ranks, and reduce sums dp ranks 1 + 2
    tensors, objects, total, mean = runs["tp_fsdp"]["metrics"]
    one_tensors, one_objects, one_total, one_mean = runs["one_metrics"]
    assert [x for b in tensors for x in b] == [x for b in one_tensors for x in b] \
        == list(np.arange(11.0))
    assert tensors[-1] == [8.0, 9.0, 10.0]
    assert objects == tensors and one_objects == one_tensors
    assert (total, mean) == (3.0, 1.5) and (one_total, one_mean) == (1.0, 1.0)


# ------------------------------------------------------------ checkpoints
def test_fsdp_checkpoint_restores_bitwise_under_tp_fsdp(runs):
    # JAX's test_cross_layout_restore: saved by FSDP-2, restored into
    # TP-2 x FSDP-2 (elastic: another world size), parameters and moments
    params, moments = runs["tp_fsdp"]["from_fsdp"]
    _, saved, _, saved_moments = runs["fsdp"]
    assert params.keys() == saved.keys()
    for key in saved:
        assert np.array_equal(params[key], saved[key]), key
    assert moments.keys() == saved_moments.keys() and len(moments) == 3 * len(saved)
    for key in saved_moments:
        assert np.array_equal(moments[key], saved_moments[key]), key


def test_tp_fsdp_checkpoint_loads_bitwise_into_one_process(runs):
    from accelerate_tpu_torch.utils.serialization import SafetensorsReader

    params, moments = runs["one_from_tp_fsdp"]
    _, saved, _, saved_moments = runs["tp_fsdp"][1]
    for key in saved:
        assert np.array_equal(params[key], saved[key]), key
    for key in saved_moments:
        assert np.array_equal(moments[key], saved_moments[key]), key
    # whole tensors under the JAX stacked keys, as one process writes them
    _, ref_state = runs[("one", 1)][:2]
    with SafetensorsReader(os.path.join(runs["paths"]["tp_fsdp"], "model")) as reader:
        assert sorted(reader.keys()) == sorted(ref_state)
        for key, ref in ref_state.items():
            assert tuple(reader.get(key).shape) == ref.shape and reader.get(key).dtype == torch.float32


# ------------------------------------------------------------ big models
@pytest.mark.parametrize("how", ["dispatch", "load", "offload"])
def test_big_model_loading_over_a_tp_mesh_matches_one_process(runs, how):
    logits, split = runs["tp"]["mesh_logits"][how]
    assert split  # the tensor-parallel forward ran
    np.testing.assert_allclose(logits, runs["one_logits"], rtol=0, atol=LOGIT_ATOL)


def test_plan_bytes_per_rank_match_the_jax_plan(runs):
    import jax

    from accelerate_tpu.big_modeling import plan_shardings as jax_plan
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu.parallel.tp import tensor_parallel_rules as jax_rules
    from jax.sharding import Mesh

    got, budgets, too_small = runs["tp_fsdp"]["plan"]
    jcfg = jl.LlamaConfig.llama3_8b(num_hidden_layers=2)
    abstract = jax.eval_shape(lambda k: jl.init_llama_params(jcfg, k), jax.random.key(0))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp_shard", "tp"))
    plan = jax_plan(abstract, mesh, rules=jax_rules(), hbm_budget_bytes=2**40)
    want = {".".join(k.key for k in path): int(np.prod(s.shard_shape(leaf.shape))) * 4
            for (path, leaf), s in zip(jax.tree_util.tree_leaves_with_path(abstract),
                                       jax.tree_util.tree_leaves(plan))}
    assert got == want
    assert sorted(budgets, key=int) == ["0", "1", "2", "3"] and min(budgets.values()) > 0
    assert too_small is not None and "GiB per rank" in too_small


# ------------------------------------------------------------ user rules
USER_RULES = {  # name -> (TensorParallelConfig rules, FSDPPlugin rules, error or None)
    "restated": ([(r"q_proj/kernel", 2)], [(r"norm/scale", None)], None),
    "misplaced": ([(r"o_proj/kernel", 2)], None, r"o_proj/kernel.*split on dim 1"),
    "unmatched": (None, [(r"no_such_leaf", 0)], r"matches no parameter"),
}


@pytest.mark.parametrize("case", sorted(USER_RULES))
def test_user_sharding_rules_go_in_front_of_the_defaults(jax_params, case):
    # one process laid out over a one-rank tp by a TensorParallelConfig: a
    # rule that restates where the forward runs a leaf trains as one
    # process does; one that places a leaf elsewhere, or matches nothing,
    # raises at prepare by name (FSDPPlugin's rules in front, as in JAX)
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.utils.dataclasses import FSDPPlugin, TensorParallelConfig

    tp_rules, fsdp_rules, error = USER_RULES[case]
    try:
        _reset()
        acc = Accelerator(cpu=True, parallelism_config=ParallelismConfig(
            tp_config=TensorParallelConfig(sharding_rules=tp_rules)),
            fsdp_plugin=FSDPPlugin(sharding_rules=fsdp_rules) if fsdp_rules else None)
        assert acc.layout == ("tp_fsdp" if fsdp_rules else "tp")
        cfg = _port_config()
        model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, jax_params, device="cpu"))
        opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=0.01)
        if error is not None:
            with pytest.raises(ValueError, match=error):
                acc.prepare(model, opt)
            return
        model, opt = acc.prepare(model, opt)
        step = acc.train_step(tl.llama_loss, max_grad_norm=1.0)
        batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
        losses = [step(batch).item() for _ in range(2)]
        _reset()
        ref = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, jax_params, device="cpu"))
        ref_acc = Accelerator(cpu=True)
        ref, ref_opt = ref_acc.prepare(ref, torch.optim.AdamW(ref.parameters(), lr=LR,
                                                              weight_decay=0.01))
        ref_step = ref_acc.train_step(tl.llama_loss, max_grad_norm=1.0)
        ref_losses = [ref_step(batch).item() for _ in range(2)]
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-6, atol=1e-6)
    finally:
        _reset()
