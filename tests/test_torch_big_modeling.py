"""The port's big-model inference helpers against the JAX package's, at
``LlamaConfig.tiny`` size: empty (meta) models, checkpoint loads from
JAX-written files, load-then-quantize, CPU and disk offload, the size
estimates, tied parameters, and the refusals (meshes, quantized trees in
the serving steps).

Tolerances: logits atol = rtol = 1e-4 (the slice-1 forward tolerance: the
projections' f32 matmuls sum in another order in XLA and in PyTorch);
loaded and quantized bytes, offload files and size estimates exact.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from accelerate_tpu import big_modeling as jbm
from accelerate_tpu.models import llama as jl
from accelerate_tpu.utils import modeling as jmod
from accelerate_tpu.utils import offload as joff
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu.utils import serialization as jser
from accelerate_tpu_torch import big_modeling as tbm
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.utils import modeling as tmod
from accelerate_tpu_torch.utils import offload as toff
from accelerate_tpu_torch.utils import quantization as tq

MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


def _configs():
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla")
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="xla")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A sharded checkpoint of the JAX tiny Llama, written by the JAX package."""
    jcfg, tcfg = _configs()
    jmodel = jl.create_llama(jcfg, seed=3)
    path = tmp_path_factory.mktemp("ckpt")
    jser.save_sharded_safetensors(jax.tree_util.tree_map(np.asarray, jmodel.params), str(path),
                                  max_shard_size="64KB")
    ids = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, 10)).astype(np.int32)
    return str(path), jmodel, ids


def _np(x):
    return x.detach().cpu().float().numpy()


def test_init_empty_weights_builds_on_meta_without_drawing():
    _, tcfg = _configs()
    with tbm.init_empty_weights():
        # the default device is the card: it is neither resolved nor drawn on
        model = tl.create_llama(tcfg, seed=0)
        linear = nn.Linear(4, 3)
    assert all(p.is_meta for p in model.parameters()) and linear.weight.is_meta
    assert torch.get_default_device().type == "cpu"  # the context is undone
    sizes = tmod.compute_module_sizes(model)  # meta leaves size by shape and dtype
    assert sizes[""] == sum(p.numel() * 4 for p in model.parameters())


def test_abstract_params_shapes_match_jax():
    jcfg, tcfg = _configs()
    jtree = jbm.abstract_params(lambda: jl.init_llama_params(jcfg, jax.random.key(0)))
    ttree = tbm.abstract_params(tl.init_llama_params, tcfg, None)
    jflat = {"/".join(str(k.key) for k in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = dict(tmod._flat(ttree))
    assert sorted(jflat) == sorted(tflat)
    for path, leaf in tflat.items():
        assert leaf.is_meta and tuple(leaf.shape) == jflat[path].shape


def test_load_jax_checkpoint_into_an_empty_model(jax_checkpoint):
    path, jmodel, ids = jax_checkpoint
    _, tcfg = _configs()
    with tbm.init_empty_weights():
        model = tl.create_llama(tcfg)
    tbm.load_checkpoint_in_model(model, path, device="cpu")
    assert not any(p.is_meta for p in model.parameters())
    for key, attr in model.checkpoint_keys():
        np.testing.assert_array_equal(_np(model.get_parameter(attr)),
                                      np.asarray(_jax_leaf(jmodel.params, key)))
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(logits), np.asarray(jmodel(jnp.asarray(ids))), **MODEL_TOL)


def _jax_leaf(tree, key):
    for part in key.split("."):
        tree = tree[part]
    return tree


def test_load_and_quantize_matches_jax_and_in_memory_quantization(jax_checkpoint):
    path, jmodel, ids = jax_checkpoint
    jcfg, tcfg = _configs()
    qcfg = dict(load_in_8bit=True)
    jloaded = jl.create_llama(jcfg, abstract=True)
    jq.load_and_quantize_model(jloaded, path, jq.QuantizationConfig(**qcfg))
    with tbm.init_empty_weights():
        model = tl.create_llama(tcfg)
    out = tq.load_and_quantize_model(model, path, tq.QuantizationConfig(**qcfg), device="cpu")
    assert out is model
    # bitwise the quantization of the same weights held in memory
    in_memory = tl.LlamaForCausalLM(
        tcfg, tl.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu"))
    tq.quantize_model(in_memory, tq.QuantizationConfig(**qcfg))
    loaded_bufs, memory_bufs = dict(model.named_buffers()), dict(in_memory.named_buffers())
    assert sorted(loaded_bufs) == sorted(memory_bufs) and len(loaded_bufs) == 16
    for name, buf in loaded_bufs.items():
        assert torch.equal(buf, memory_bufs[name])
    with torch.no_grad():
        logits = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(_np(logits), np.asarray(jloaded(jnp.asarray(ids))), **MODEL_TOL)


def _tiny_model(seed=0):
    _, tcfg = _configs()
    return tl.LlamaForCausalLM.from_seed(tcfg, seed=seed, device="cpu")


def test_cpu_offload_forward_unchanged():
    model = _tiny_model()
    ids = torch.randint(0, 256, (2, 9), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = model(ids)
        assert tbm.cpu_offload(model, execution_device="cpu") is model
        assert not list(model.parameters())  # held on the host, outside the module
        torch.testing.assert_close(model(ids), ref, atol=0, rtol=0)
        torch.testing.assert_close(model(ids), ref, atol=0, rtol=0)


def test_disk_offload_forward_unchanged_and_files_interchange(tmp_path):
    model = _tiny_model(seed=1)
    params = {k: v.clone() for k, v in tmod._flat(model.params)}
    ids = torch.randint(0, 256, (2, 9), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(ids)
        toff.disk_offload(model, str(tmp_path / "port"), execution_device="cpu")
        assert not list(model.parameters())
        torch.testing.assert_close(model(ids), ref, atol=0, rtol=0)
    # the port's files read by the JAX loader, and the JAX package's by the port's
    jloader = joff.OffloadedWeightsLoader(str(tmp_path / "port"))
    for path, value in params.items():
        np.testing.assert_array_equal(np.asarray(jloader[path.replace("/", ".")]), value.numpy())
    jparams = {"a": {"w": jnp.asarray(np.arange(6, dtype=np.float32).reshape(2, 3))},
               "b": jnp.asarray(np.asarray([1, -2], np.int8)), "c": jnp.asarray(3.5, jnp.bfloat16)}
    joff.offload_state_dict(str(tmp_path / "jax"), jparams)
    loader = toff.OffloadedWeightsLoader(str(tmp_path / "jax"))
    assert sorted(loader.keys()) == ["a.w", "b", "c"] and len(loader) == 3 and "b" in loader
    assert torch.equal(loader["a.w"], torch.arange(6, dtype=torch.float32).reshape(2, 3))
    assert torch.equal(loader["b"], torch.tensor([1, -2], dtype=torch.int8))
    assert loader["c"].dtype == torch.bfloat16 and loader["c"].shape == () and float(loader["c"]) == 3.5


def test_size_estimates_match_jax():
    jcfg, tcfg = _configs()
    jparams = jl.init_llama_params(jcfg, jax.random.key(0))
    tparams = tl.params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jsizes = jmod.compute_module_sizes(jparams)
    assert tmod.compute_module_sizes(tparams) == jsizes
    assert tmod.compute_module_sizes(tl.LlamaForCausalLM(tcfg, tparams)) == jsizes
    assert tmod.compute_module_sizes(tparams, dtype=torch.bfloat16) == jmod.compute_module_sizes(
        jparams, dtype="bfloat16")
    assert tmod.calculate_maximum_sizes(tparams) == jmod.calculate_maximum_sizes(jparams)
    for kw in (dict(), dict(dtype="float32", optimizer="sgd"), dict(optimizer="adafactor")):
        assert tmod.estimate_training_memory(8e9, **kw) == jmod.estimate_training_memory(8e9, **kw)
    for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32, np.float32), (torch.int8, "int8")):
        assert tmod.dtype_byte_size(dt) == jmod.dtype_byte_size(name)
    assert tmod.dtype_byte_size("int4") == 0.5


def test_find_tied_parameters():
    w = torch.ones((4, 4))
    tied = tmod.find_tied_parameters({"a": {"k": w}, "b": {"k": w}, "c": torch.zeros(2)})
    jw = jnp.ones((4, 4))
    assert tied == jmod.find_tied_parameters({"a": {"k": jw}, "b": {"k": jw}, "c": jnp.zeros(2)})
    assert tied == [["a/k", "b/k"]]
    # a view shares the storage too (a tied head is the embedding transposed)
    assert tmod.find_tied_parameters({"embed": w, "head": w.T, "other": w.clone()}) == [["embed", "head"]]


def test_meshes_and_sharding_plans_raise():
    # meshes landed with tensor parallelism (tests/test_torch_tensor_parallel.py
    # holds them across processes); over a one-rank (dp_shard, tp) mesh, what
    # still raises: a rule that places a leaf where the tensor-parallel
    # forward does not run it, rules for a model without that forward, a
    # share over the budget, and FSDP over dims that are not ported
    from accelerate_tpu_torch.parallel.mesh import build_mesh
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.state import AcceleratorState, PartialState

    AcceleratorState._reset_state(reset_partial_state=True)
    try:
        PartialState(cpu=True)
        mesh = build_mesh((1, 1), ("dp_shard", "tp"), "cpu")
        model = _tiny_model()
        with pytest.raises(ValueError, match=r"o_proj/kernel.*split on dim 1"):
            tbm.plan_shardings(model, mesh, rules=[(r"o_proj/kernel", 2)] + tensor_parallel_rules())
        with pytest.raises(ValueError, match="no tensor-parallel forward"):
            tbm.plan_shardings(nn.Linear(4, 4), mesh, rules=[("weight", 0)])
        with pytest.raises(MemoryError, match="GiB per rank"):
            tbm.plan_shardings(model, mesh, rules=tensor_parallel_rules(), hbm_budget_bytes=1024)
        plan = tbm.plan_shardings(model, mesh, rules=tensor_parallel_rules())
        assert plan["layers.attn.q_proj.kernel"].tp_dim == 2
        assert plan["layers.attn.o_proj.kernel"].tp_dim == 1
        assert plan["layers.input_norm.scale"].tp_dim is None
        ids = torch.arange(12).reshape(2, 6)
        with torch.no_grad():
            want = model(ids)
            got = tbm.dispatch_model(model, mesh=mesh, rules=tensor_parallel_rules())(ids)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        import torch.distributed as dist

        if dist.is_initialized():  # build_mesh started a one-rank group
            dist.destroy_process_group()
    model = _tiny_model()
    assert tbm.dispatch_model(model, device="cpu") is model


def test_get_max_memory_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        tbm.get_max_memory()


def test_quantized_tree_is_refused_by_the_serving_steps_and_engine():
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    model = _tiny_model()
    tq.quantize_model(model, tq.QuantizationConfig(load_in_8bit=True))
    cfg, params = model.config, model.params
    token = torch.zeros((2, 1), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="quantized"):
        tl.llama_prefill_at(cfg, params, torch.zeros((2, 4), dtype=torch.long), 16, [3, 3])
    with pytest.raises(NotImplementedError, match="quantized"):
        tl.llama_decode_step(cfg, params, {"k": None, "v": None}, token, 0)
    with pytest.raises(NotImplementedError, match="quantized"):
        tl.llama_verify_step(cfg, params, {"k": None, "v": None}, token, torch.zeros(2))
    with pytest.raises(NotImplementedError, match="quantized"):
        ContinuousBatchingEngine(model, device="cpu")
    with torch.no_grad():  # the forward still runs
        assert model(token).shape == (2, 1, cfg.vocab_size)
