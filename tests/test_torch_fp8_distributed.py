"""fp8 training of the port across gloo processes on the CPU, with the JAX
package's mesh-wide scales: DDP 2, FSDP2 2, TP 2 and TP 2 x FSDP2 2 against
the JAX ``train_step`` under ``mixed_precision="fp8"`` over its meshes
(``dp_shard_size=8``; ``dp_shard_size=4, tp_size=2`` for the tensor-parallel
layouts) on the same 8-row global batches.

Under GSPMD the JAX amax of a sharded array is a global reduction: an
activation's and a cotangent's scale span the whole batch and every ``tp``
block, a weight's every ``tp`` block. The port's ranks hold blocks, and
``prepare`` hands ``fp8_dot`` the groups those reductions span
(``parallel.sharding.fp8_groups``): each layout must give JAX's losses and
gradients, and the same layout with each rank's local amax (no all-reduce,
``Fp8Groups()``) must not.

Every layout is launched once (``debug_launcher``, a ``file://`` store), in
a module-scoped fixture; each check is its own case. The model is the
2-layer tiny Llama in f32 (the JAX package's weights), SGD (lr 0.1),
``max_grad_norm=1.0``, 3 updates; the Accelerators keep an f32 policy on
both sides (``kwargs_handlers=[MixedPrecisionPolicy()]``: JAX's default fp8
policy would cast the parameters to bf16 for the forward).

Tolerances (``tests/test_torch_fp8.py`` says why fp8 needs these):
* the first step's gradients, gathered whole, against JAX's eager
  ``value_and_grad`` (exact inverse scales, as the port's): ``GRAD_RTOL``
  1e-5 of each leaf's largest entry. The ranks sum partial products and
  gradients in another order than one process: f32 rounding;
* the mutation (local amaxes) must miss that by ``MUTATION_FACTOR`` (10x)
  on some leaf: a rank's own scale puts its values on other fp8 grids;
* losses of the 3-step trajectory against the compiled JAX ``train_step``:
  ``LOSS_RTOL`` 1e-5 (one process: 8e-8);
* the amax all-reduces a step: exactly the count the layers issue (see
  ``_expected_reductions``).
"""


import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

ROWS, SEQ, UPDATES, LR = 8, 16, 3, 0.1
LAYOUTS = {  # name -> (processes, ParallelismConfig fields, the JAX mesh)
    "ddp": (2, dict(dp_replicate_size=2), dict(dp_shard_size=8)),
    "fsdp": (2, dict(dp_shard_size=2), dict(dp_shard_size=8)),
    "tp": (2, dict(tp_size=2), dict(dp_shard_size=4, tp_size=2)),
    "tp_fsdp": (4, dict(dp_shard_size=2, tp_size=2), dict(dp_shard_size=4, tp_size=2)),
}
GRAD_RTOL = 1e-5
MUTATION_FACTOR = 10
LOSS_RTOL = 1e-5
LAYERS = 2


def _batches():
    rng = np.random.default_rng(9)
    return [{"input_ids": rng.integers(0, 256, size=(ROWS, SEQ)).astype(np.int32)}
            for _ in range(UPDATES)]


def _expected_reductions(tp: bool) -> int:
    """All-reduces one step issues: per layer four activation amaxes (the
    q/k/v input, o_proj's, the gate/up input, down_proj's) in the forward
    and again in its recompute (remat ``"nothing"``), seven cotangent
    amaxes in the backward; under ``tp`` seven weight amaxes in each
    forward as well."""
    per_layer = 4 + 4 + 7 + (14 if tp else 0)
    return LAYERS * per_layer


def _whole_grads(model, opt) -> dict:
    """Every gradient whole (``tp`` sums done, blocks and shards gathered),
    by checkpoint key, stacked layers restacked."""
    from accelerate_tpu_torch.model import unwrap_model

    opt.grads()  # the update's tp sum of the replicated parameters' gradients
    inner = unwrap_model(model)
    named = dict(inner.named_parameters())

    def whole(name):
        g = named[name].grad
        return (g.full_tensor() if hasattr(g, "full_tensor") else g).detach()

    return {key: torch.stack([whole(f) for f in fqns]).numpy() if stacked
            else whole(fqns[0]).numpy() for key, fqns, stacked in inner.checkpoint_fqns()}


def _body(params, pcfg):
    """One rank: the first batch's gradients with the layout's groups and
    with each rank's local amax, then the 3-step trajectory (losses and the
    amax all-reduces a step)."""
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.model import unwrap_model
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.ops.fp8 import Fp8Groups
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig
    from accelerate_tpu_torch.state import AcceleratorState, GradientState
    from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy

    torch.set_num_threads(1)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True, mixed_precision="fp8", parallelism_config=ParallelismConfig(**pcfg),
                      kwargs_handlers=[MixedPrecisionPolicy()])
    cfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    model, opt = acc.prepare(model, opt)
    inner = unwrap_model(model)
    groups = inner.fp8_groups
    n = acc.parallelism_config.data_parallel_size
    r, per = acc.data_parallel_rank, ROWS // n

    def rows(batch):
        return {k: torch.from_numpy(v[r * per:(r + 1) * per]) for k, v in batch.items()}

    batches = _batches()
    out = {"use_fp8": inner.config.use_fp8, "layout": acc.layout,
           "groups": (groups.act is not None, groups.weight is not None)}
    for name, g in (("grads", groups), ("local", Fp8Groups())):
        inner.fp8_groups = g
        loss = acc.backward(tl.llama_loss, rows(batches[0]))
        out[name] = (loss.item(), _whole_grads(model, opt))
        opt.zero_grad()
    inner.fp8_groups = groups
    step = acc.train_step(tl.llama_loss, max_grad_norm=1.0)
    before = groups.reductions
    out["losses"] = [step(rows(b)).item() for b in batches]
    out["reductions_per_step"] = (groups.reductions - before) / len(batches)
    return out


def _jax_config(**kw):
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    return jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla",
                               attention_kv_block=16, **kw)


def _jax_runs(params):
    """JAX's eager first-step loss and gradients on the whole batch, and its
    compiled trajectory's losses over each mesh."""
    import jax
    import jax.numpy as jnp
    import optax

    from accelerate_tpu import Accelerator as JAccelerator
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu.parallelism_config import ParallelismConfig as JPcfg
    from accelerate_tpu.state import AcceleratorState, GradientState, PartialState
    from accelerate_tpu.utils.dataclasses import MixedPrecisionPolicy as JPolicy

    batches = _batches()
    jcfg = _jax_config(use_fp8=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    first = {k: jnp.asarray(v) for k, v in batches[0].items()}
    with jax.disable_jit():
        value, grads = jax.value_and_grad(lambda p: jl.llama_loss(
            lambda i, **kw: jl.llama_apply(jcfg, p, i, **kw), first))(jparams)
    out = {"grads": (float(value), {".".join(k.key for k in path): np.asarray(g) for path, g
                                    in jax.tree_util.tree_leaves_with_path(grads)})}
    for mesh in {tuple(sorted(m.items())) for _, _, m in LAYOUTS.values()}:
        for s in (AcceleratorState, GradientState, PartialState):
            s._reset_state()
        try:
            acc = JAccelerator(parallelism_config=JPcfg(**dict(mesh)), mixed_precision="fp8",
                               kwargs_handlers=[JPolicy()])
            model = jl.create_llama(_jax_config(), seed=0)
            model.params = jax.tree_util.tree_map(jnp.asarray, params)
            model, _ = acc.prepare(model, optax.sgd(LR))
            step = acc.train_step(jl.llama_loss, max_grad_norm=1.0)
            out[mesh] = [float(step({k: jnp.asarray(v) for k, v in b.items()})) for b in batches]
        finally:
            for s in (AcceleratorState, GradientState, PartialState):
                s._reset_state()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from accelerate_tpu.models import llama as jl

    params = jax.tree_util.tree_map(np.asarray, jl.init_llama_params(_jax_config(),
                                                                       jax.random.key(0)))
    tmp = tmp_path_factory.mktemp("fp8_dist")
    out = {"jax": _jax_runs(params)}
    for name, (procs, pcfg, _) in LAYOUTS.items():
        out[name] = debug_launcher(_body, args=(params, pcfg), num_processes=procs,
                                   init_method=f"file://{tmp}/store_{name}")
    return out


def _grad_misses(grads, ref) -> float:
    """The largest leaf's max |difference| over its largest |reference|."""
    assert grads.keys() == ref.keys()
    return max(float(np.abs(grads[k] - ref[k]).max() / np.abs(ref[k]).max()) for k in ref)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_gradients_match_jax_mesh_wide_scales(runs, name):
    loss, grads = runs[name][0]["grads"]
    jloss, jgrads = runs["jax"]["grads"]
    assert runs[name][0]["use_fp8"] and runs[name][0]["layout"] == name
    np.testing.assert_allclose(loss, jloss, rtol=GRAD_RTOL)
    for key, ref in jgrads.items():
        np.testing.assert_allclose(grads[key], ref, rtol=0, atol=GRAD_RTOL * np.abs(ref).max(),
                                   err_msg=key)
    # every rank computed the same whole gradients
    for rank in runs[name][1:]:
        assert _grad_misses(rank["grads"][1], grads) == 0.0


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_each_rank_local_amax_misses_jax(runs, name):
    _, local = runs[name][0]["local"]
    assert _grad_misses(local, runs["jax"]["grads"][1]) > MUTATION_FACTOR * GRAD_RTOL


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_trajectory_matches_jax_train_step(runs, name):
    mesh = tuple(sorted(LAYOUTS[name][2].items()))
    for rank in runs[name]:
        np.testing.assert_allclose(rank["losses"], runs["jax"][mesh], rtol=LOSS_RTOL)
    assert runs[name][0]["losses"][-1] < runs[name][0]["losses"][0]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_amax_all_reduces_a_step(runs, name):
    tp = "tp" in name
    for rank in runs[name]:
        assert rank["groups"] == (True, tp)
        assert rank["reductions_per_step"] == _expected_reductions(tp)
