"""Expert parallelism (``parallel/ep.py``) of the port's MoE Llama across
gloo processes on the CPU: ``ep_size=2`` (2 processes), ``dp_shard_size=2
x ep_size=2`` (4) and ``dp_replicate_size=2 x ep_size=2`` (4), against
the port's one process (``cpu=True``) and against the JAX ``train_step``
at ``ParallelismConfig(dp_shard_size=4, ep_size=2)`` on the suite's 8
virtual devices.

Every layout is launched once (``debug_launcher``, a ``file://`` store in
the test's temporary directory) in a module-scoped fixture; each check is
its own case. The model is a 2-layer tiny MoE Llama in f32 (4 experts, 2 a
token, capacity factor 1.0, so capacity drops tokens and the routing
depends on every row of the global batch) with the JAX package's weights
(``params_from_jax``), AdamW (lr 1e-3, weight decay 0.01),
``max_grad_norm=1.0``, 3 updates of 8-row global batches whose
``loss_mask`` gives the data-parallel ranks different valid-token counts.

Held:
* ``moe_ffn`` at ``ep`` 2 (each rank its two experts) against one process
  on the same inputs, output and aux; at ``dp_shard`` 2 (each rank its
  rows, ``dp_group``) against one process's call on all the rows;
* every leaf's gradient of one backward at ``ep`` 2 against one
  process's (the router's too: the gates' gradient summed over ``ep``);
* each layout's trajectory against one process's and, at ``dp_shard 2 x
  ep 2``, against JAX's at ``dp_shard 4 x ep 2``;
* the continuous engine's and ``generate``'s greedy tokens over ``ep`` 2
  and ``dp_shard 2 x ep 2`` (``prepare_inference(mesh=, rules=
  expert_parallel_rules())``) equal one process's;
* a checkpoint saved at ``ep`` 2 holds whole expert leaves and loads at
  ``ep`` 1 into the same parameters;
* ``plan_shardings`` of Mixtral's shapes (2 layers, built empty) with
  ``expert_parallel_rules()`` over ``dp_shard 2 x ep 2``: each leaf's
  bytes a rank equal the JAX plan's on the same mesh of 4 devices;
* MoE under ``tp`` and the ``pp`` layer axis are refused, naming A11.

Tolerances: against one process 1e-6 (atol and rtol) on losses,
gradients, outputs and parameters: ``ep`` sums each token's expert rows in
f32 over ranks that hold at most one of them each, and the data-parallel
routing takes the global batch's counts, so only the data-parallel
gradient reduction's order differs. As in
``tests/test_torch_tensor_parallel.py``, a parameter element whose
one-process gradient is nonzero and below ``ADAM_EPS_BAND`` (1e-6) at some
update is held at ``2 * lr`` an update (AdamW divides a rounding-sized
gradient by its own size), and such elements must be under 0.5 % of all
(305 of 254,784 here, 0.12 %: experts that few tokens reach have more
rounding-sized gradients than a dense model's 0.1 % budget there allows);
against JAX
``tests/test_torch_tensor_parallel.py``'s AdamW tolerances (losses 1e-4
relative, parameters 2e-5, near-zero-gradient elements ``2 * lr`` an
update).
"""

import os

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

ROWS, SEQ, UPDATES, LR = 8, 16, 3, 1e-3
LAYOUTS = {  # name -> (processes, ParallelismConfig fields)
    "ep": (2, dict(ep_size=2)),
    "ep_fsdp": (4, dict(dp_shard_size=2, ep_size=2)),
    "ep_hsdp": (4, dict(dp_replicate_size=2, ep_size=2)),
}
MOE = dict(num_experts=4, num_experts_per_tok=2, expert_capacity_factor=1.0,
           moe_aux_loss_coef=0.1, router_z_loss_coef=1e-3)
TOL = dict(rtol=1e-6, atol=1e-6)
ADAM_EPS_BAND = 1e-6
JAX_LOSS_RTOL, ADAM_PARAM_ATOL, ADAM_NEAR_ZERO = 1e-4, 2e-5, 1e-2
ENGINE_KW = dict(slots=3, max_len=48, prompt_bucket=16, readback_lag=1, block_size=8,
                 prefill_chunk=8)
NEW = 6


def _batches():
    rng = np.random.default_rng(7)
    out = []
    for _ in range(UPDATES):
        mask = np.ones((ROWS, SEQ - 1), np.float32)
        mask[ROWS // 2:, 4:] = 0
        mask[1, 9:] = 0
        out.append({"input_ids": rng.integers(0, 256, size=(ROWS, SEQ)).astype(np.int32),
                    "loss_mask": mask})
    return out


def _port_config(**kw):
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", **{**MOE, **kw})


def _reset():
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _accelerator(pcfg):
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    _reset()
    kw = {} if pcfg is None else {"parallelism_config": ParallelismConfig(**pcfg)}
    return Accelerator(cpu=True, **kw)


def _rows(acc, batch):
    n = acc.parallelism_config.data_parallel_size if acc.mesh is not None else 1
    r, per = acc.data_parallel_rank, ROWS // n
    return {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in batch.items()}


def _model(params):
    from accelerate_tpu_torch.models import llama as tl

    cfg = _port_config()
    return tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))


def _train(params, pcfg=None, save_to=None):
    """(losses, whole parameters by checkpoint key, layout) of the
    trajectory on this rank's rows."""
    from accelerate_tpu_torch.models import llama as tl

    acc = _accelerator(pcfg)
    model = _model(params)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    step = acc.train_step(tl.llama_loss, max_grad_norm=1.0)
    losses = [step(_rows(acc, b)).item() for b in _batches()]
    if save_to is not None:
        acc.save_state(save_to)
    state = {k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()}
    return losses, state, acc.layout


def _near_adam_eps(params):
    """By checkpoint key: where the one-process gradient of some update is
    nonzero but below ADAM_EPS_BAND (the eager loop, train_step's updates)."""
    from accelerate_tpu_torch.models import llama as tl

    acc = _accelerator(None)
    model = _model(params)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    near = {}
    for batch in _batches():
        with acc.accumulate(model):
            acc.backward(tl.llama_loss, {k: torch.from_numpy(v) for k, v in batch.items()})
            for key, n in model.checkpoint_keys():
                g = getattr(model, n).grad.abs().numpy()
                near[key] = near.get(key, False) | ((g > 0) & (g < ADAM_EPS_BAND))
            acc.clip_grad_norm_(model.parameters(), 1.0)
            opt.step()
            opt.zero_grad()
    return near


def _grads(params, pcfg=None):
    """(loss, every gradient whole by checkpoint key) of one backward on
    the first batch's rows of this rank."""
    from accelerate_tpu_torch.models import llama as tl

    acc = _accelerator(pcfg)
    model = _model(params)
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = acc.backward(tl.llama_loss, _rows(acc, _batches()[0]))
    named = dict(model.named_parameters())

    def whole(name):
        g = named[name].grad
        return (g.full_tensor() if hasattr(g, "full_tensor") else g).detach()

    grads = {key: torch.stack([whole(f) for f in fqns]).numpy() if stacked else whole(fqns[0]).numpy()
             for key, fqns, stacked in model.checkpoint_fqns()}
    return loss.item(), grads


def _ffn_inputs():
    rng = np.random.default_rng(3)
    d, i, e = 16, 32, 4
    return (rng.normal(size=(4, 8, d)).astype(np.float32), rng.normal(size=(d, e)).astype(np.float32),
            (rng.normal(size=(e, d, i)) * 0.1).astype(np.float32),
            (rng.normal(size=(e, d, i)) * 0.1).astype(np.float32),
            (rng.normal(size=(e, i, d)) * 0.1).astype(np.float32))


def _ffn(pcfg):
    """``moe_ffn`` on this rank's experts (``ep``) and rows (the
    data-parallel ranks): (output of its rows, aux, gradient of the router)."""
    from accelerate_tpu_torch.ops.moe import moe_ffn
    from accelerate_tpu_torch.parallel.ep import ExpertParallel
    from accelerate_tpu_torch.parallel.mesh import sub_mesh

    acc = _accelerator(pcfg)
    x, router, wg, wu, wd = map(torch.from_numpy, _ffn_inputs())
    ep = ExpertParallel(sub_mesh(acc.mesh, "ep"))
    n = acc.parallelism_config.data_parallel_size
    per, r = x.shape[0] // n, acc.data_parallel_rank
    experts = [w.chunk(ep.size)[ep.rank] for w in (wg, wu, wd)]
    router = router.clone().requires_grad_()
    dp, names = None, acc.mesh.mesh_dim_names
    if n > 1:
        from accelerate_tpu_torch.ops.collectives import mirror_group

        dp = mirror_group(acc.mesh, tuple(d for d in ("dp_replicate", "dp_shard")
                                         if acc.mesh.size(names.index(d)) > 1))
    out, aux = moe_ffn(x[r * per:(r + 1) * per], router, *experts, capacity_factor=1.0,
                       compute_dtype=torch.float32, aux_loss_coef=0.3, router_z_loss_coef=1e-2,
                       ep=ep, dp_group=dp)
    (out.sum() + aux).backward()
    return out.detach().numpy(), aux.item(), router.grad.numpy()


def _requests():
    rng = np.random.default_rng(5)
    return [rng.integers(1, 256, size=n).astype(np.int32) for n in (5, 12, 21, 3, 9)]


def _drive(eng):
    occs, waiting = [], list(_requests())
    guard = 500
    while waiting or eng.live_count():
        while waiting and eng.free_slots() and eng.can_admit(waiting[0], NEW):
            occs.append(eng.insert(waiting.pop(0), max_new_tokens=NEW, pad_token_id=0))
        eng.step()
        eng.poll()
        guard -= 1
        assert guard > 0, "the engine did not drain"
    eng.poll(force=True)
    return [list(map(int, o.tokens)) for o in occs]


def _serve(params, pcfg=None):
    """Greedy tokens of the continuous engine (dense and paged stores) and
    of ``generate``, over the layout's mesh (one process: unlaid)."""
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.inference import generate, prepare_inference
    from accelerate_tpu_torch.parallel.ep import expert_parallel_rules

    model = _model(params)
    if pcfg is not None:
        acc = _accelerator(pcfg)
        model = prepare_inference(model, mesh=acc.mesh, rules=expert_parallel_rules())
        assert model.ep is not None and model.ep.size == 2
    out = {}
    with torch.no_grad():
        for backend in ("dense", "paged"):
            impl = "reference" if backend == "dense" else "kernel"
            out[backend] = _drive(ContinuousBatchingEngine(
                model, kv_cache=backend, attention_impl=impl, device="cpu", **ENGINE_KW))
        ids = np.random.default_rng(1).integers(0, 256, size=(3, 7)).astype(np.int32)
        out["generate"] = np.asarray(generate(model, ids, max_new_tokens=NEW)).tolist()
    return out


def _plan_bytes(pcfg):
    """``{checkpoint key: bytes one rank holds}`` of Mixtral's shapes at 2
    layers, built empty, over the layout's mesh with the expert-parallel
    rules."""
    from accelerate_tpu_torch.big_modeling import init_empty_weights, plan_shardings
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.ep import expert_parallel_rules

    acc = _accelerator(pcfg)
    with init_empty_weights():
        model = tl.create_llama(tl.LlamaConfig.mixtral_8x7b(num_hidden_layers=2))
    plan = plan_shardings(model, acc.mesh, rules=expert_parallel_rules(), hbm_budget_bytes=2**40)
    return {k: (p.rank_bytes, p.ep_dim) for k, p in plan.items()}


def _load_at_one(params, path):
    """A fresh one-process model (other values) loading ``path``."""
    acc = _accelerator(None)
    model = _model(params)
    opt = torch.optim.AdamW(model.parameters(), lr=LR, weight_decay=0.01)
    model, opt = acc.prepare(model, opt)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    acc.load_state(path, elastic=True)
    return {k: v.numpy().copy() for k, v in acc.get_state_dict(model).items()}


def _layout_body(params, pcfg, name, path):
    """One launch per layout: the trajectory; ``ep`` also the FFN, the
    gradients, serving and the checkpoint; ``ep_fsdp`` the FFN over its
    data-parallel rows and serving."""
    torch.set_num_threads(1)
    out = {"train": _train(params, pcfg, save_to=path if name == "ep" else None)}
    if name in ("ep", "ep_fsdp"):
        out["ffn"] = _ffn(pcfg)
        out["serve"] = _serve(params, pcfg)
    if name == "ep_fsdp":
        out["plan"] = _plan_bytes(pcfg)
    if name == "ep":
        out["grads"] = _grads(params, pcfg)
        sizes = {}
        import torch.distributed as dist

        from accelerate_tpu_torch.checkpointing import full_model_tensors

        acc = _accelerator(pcfg)
        model = acc.prepare(_model(params))
        named = dict(model.named_parameters())
        sizes["local"] = tuple(named["layers.0.mlp__experts__w_gate"].to_local().shape)
        sizes["whole"] = tuple(full_model_tensors(model)["layers.mlp.experts.w_gate"].shape)
        out["sizes"] = sizes
        out["rank"] = dist.get_rank()
    return out


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from accelerate_tpu.models import llama as jl

    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(_jax_config(), jax.random.key(0)))


def _jax_config():
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    return jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla", **MOE)


@pytest.fixture(scope="module")
def runs(jax_params, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep")
    path = str(tmp / "ep_ckpt")
    out = {"path": path}
    try:
        torch.set_num_threads(2)
        out["one"] = _train(jax_params)
        out["near_eps"] = _near_adam_eps(jax_params)
        out["one_grads"] = _grads(jax_params)
        out["one_serve"] = _serve(jax_params)
        from accelerate_tpu_torch.ops.moe import moe_ffn

        args = [torch.from_numpy(a) for a in _ffn_inputs()]
        args[1].requires_grad_()
        o, a = moe_ffn(*args, capacity_factor=1.0, compute_dtype=torch.float32, aux_loss_coef=0.3,
                       router_z_loss_coef=1e-2)
        (o.sum() + a).backward()
        out["one_ffn"] = (o.detach().numpy(), a.item(), args[1].grad.numpy())
        for name, (procs, pcfg) in LAYOUTS.items():
            out[name] = debug_launcher(_layout_body, args=(jax_params, pcfg, name, path),
                                       num_processes=procs, init_method=f"file://{tmp}/store_{name}")
        out["loaded"] = _load_at_one(jax_params, path)
    finally:
        _reset()
    return out


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_trajectory_matches_one_process(runs, name):
    ref_losses, ref_state, _ = runs["one"]
    near = runs["near_eps"]
    for losses, state, layout in (r["train"] for r in runs[name]):
        assert layout == name
        np.testing.assert_allclose(losses, ref_losses, **TOL)
        assert state.keys() == ref_state.keys()
        loose_total = 0
        for key, want in ref_state.items():
            loose = near[key]
            loose_total += int(loose.sum())
            np.testing.assert_allclose(state[key][~loose], want[~loose], **TOL, err_msg=key)
            np.testing.assert_allclose(state[key][loose], want[loose], rtol=0,
                                       atol=2 * LR * UPDATES, err_msg=key)
        assert loose_total <= 5e-3 * sum(v.size for v in ref_state.values())


@pytest.mark.parametrize("name", ["ep", "ep_fsdp"])
def test_moe_ffn_over_the_mesh_matches_one_process(runs, name):
    out, aux, grad = runs["one_ffn"]
    n = LAYOUTS[name][1].get("dp_shard_size", 1)
    per = out.shape[0] // n
    for rank, r in enumerate(runs[name]):
        got, got_aux, got_grad = r["ffn"]
        dp = rank // 2 if n > 1 else 0  # (dp_shard, ep) row-major
        np.testing.assert_allclose(got, out[dp * per:(dp + 1) * per], **TOL)
        np.testing.assert_allclose(got_aux, aux, **TOL)
        if n == 1:  # one rank's router gradient is the whole one (its rows are all rows)
            np.testing.assert_allclose(got_grad, grad, **TOL)


def test_every_gradient_at_ep2_matches_one_process(runs):
    loss, grads = runs["one_grads"]
    for r in runs["ep"]:
        got_loss, got = r["grads"]
        np.testing.assert_allclose(got_loss, loss, **TOL)
        assert got.keys() == grads.keys()
        for key, want in grads.items():
            np.testing.assert_allclose(got[key], want, **TOL, err_msg=key)
        assert np.abs(got["layers.mlp.router.kernel"]).max() > 0


@pytest.mark.parametrize("name", ["ep", "ep_fsdp"])
def test_engine_and_generate_tokens_over_ep_equal_one_process(runs, name):
    for r in runs[name]:
        assert r["serve"] == runs["one_serve"]


def test_ep_checkpoint_holds_whole_experts_and_loads_at_ep1(runs):
    from accelerate_tpu_torch.utils.serialization import SafetensorsReader

    sizes = runs["ep"][0]["sizes"]
    assert sizes["local"] == (2, 64, 128) and sizes["whole"] == (2, 4, 64, 128)
    ep_state = runs["ep"][0]["train"][1]
    with SafetensorsReader(os.path.join(runs["path"], "model")) as reader:
        assert tuple(reader.get("layers.mlp.experts.w_down").shape) == (2, 4, 128, 64)
    for key, want in ep_state.items():
        np.testing.assert_array_equal(runs["loaded"][key], want, err_msg=key)


def _jax_trajectory(params):
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
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=4, ep_size=2))
        model = jl.create_llama(_jax_config(), seed=0)
        model.params = jax.tree_util.tree_map(jnp.asarray, params)
        model, _ = acc.prepare(model, optax.adamw(LR, weight_decay=0.01))
        assert "ep" in str(model.shardings["layers"]["mlp"]["experts"]["w_gate"].spec)
        step = acc.train_step(jl.llama_loss, max_grad_norm=1.0)
        grad = jax.jit(jax.grad(lambda p, b: jl.llama_loss(
            lambda ids, **kw: jl.llama_apply(_jax_config(), p, ids, return_aux=True, **kw), b)))
        losses, near = [], None
        for batch in _batches():
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            g = jax.tree_util.tree_map(lambda x: np.abs(np.asarray(x)), grad(model.params, jb))
            now = jax.tree_util.tree_map(lambda x: x <= ADAM_NEAR_ZERO * x.max(), g)
            near = now if near is None else jax.tree_util.tree_map(np.logical_or, near, now)
            losses.append(float(step(jb)))
        flat = lambda t: {".".join(k.key for k in path): np.asarray(leaf)
                          for path, leaf in jax.tree_util.tree_leaves_with_path(t)}
        return losses, flat(model.params), flat(near)
    finally:
        for cls in (AcceleratorState, GradientState, PartialState):
            cls._reset_state()


def test_dp_shard2_ep2_trajectory_matches_jax_dp_shard4_ep2(runs, jax_params):
    jlosses, jstate, near = _jax_trajectory(jax_params)
    losses, state, _ = runs["ep_fsdp"][0]["train"]
    np.testing.assert_allclose(losses, jlosses, rtol=JAX_LOSS_RTOL)
    assert state.keys() == jstate.keys()
    for key, leaf in jstate.items():
        loose = near[key]
        np.testing.assert_allclose(state[key][~loose], leaf[~loose], rtol=0, atol=ADAM_PARAM_ATOL,
                                   err_msg=key)
        np.testing.assert_allclose(state[key][loose], leaf[loose], rtol=0,
                                   atol=2 * LR * UPDATES, err_msg=key)


def test_plan_bytes_per_rank_match_the_jax_plan(runs):
    import jax
    from jax.sharding import Mesh

    from accelerate_tpu.big_modeling import plan_shardings as jax_plan
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu.parallel.ep import expert_parallel_rules as jax_rules

    got = runs["ep_fsdp"][0]["plan"]
    jcfg = jl.LlamaConfig.mixtral_8x7b(num_hidden_layers=2)
    abstract = jax.eval_shape(lambda k: jl.init_llama_params(jcfg, k), jax.random.key(0))
    # the JAX rules name tp on the experts' intermediate dim: a size-1 tp axis
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2, 1), ("dp_shard", "ep", "tp"))
    plan = jax_plan(abstract, mesh, rules=jax_rules(), hbm_budget_bytes=2**40)
    want = {".".join(k.key for k in path): int(np.prod(s.shard_shape(leaf.shape))) * 4
            for (path, leaf), s in zip(jax.tree_util.tree_leaves_with_path(abstract),
                                       jax.tree_util.tree_leaves(plan))}
    assert {k: b for k, (b, _) in got.items()} == want
    assert got["layers.mlp.experts.w_gate"][1] == 1 and got["layers.mlp.router.kernel"][1] is None


def test_moe_under_tp_and_pp_layers_are_refused_naming_a11():
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.ep import expert_parallel_rules
    from accelerate_tpu_torch.parallel.sharding import data_parallel_layout
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_plan
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    cfg = ParallelismConfig(tp_size=2, ep_size=2)
    cfg._infer_and_validate(4)
    with pytest.raises(NotImplementedError, match=r"MoE under tensor parallelism.*ROADMAP.md A11"):
        data_parallel_layout(cfg)
    model = tl.create_llama(_port_config(), device="cpu")
    with pytest.raises(NotImplementedError, match=r"MoE.*tensor parallelism.*ROADMAP.md A11"):
        tensor_parallel_plan(model, 1)
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md A11"):
        expert_parallel_rules(layer_axis="pp")
    for sizes, layout in ((dict(ep_size=2), "ep"), (dict(ep_size=2, dp_shard_size=2), "ep_fsdp"),
                          (dict(ep_size=2, dp_replicate_size=2), "ep_hsdp")):
        cfg = ParallelismConfig(**sizes)
        cfg._infer_and_validate(cfg.total_size)
        assert data_parallel_layout(cfg) == layout
