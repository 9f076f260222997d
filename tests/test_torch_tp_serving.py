"""Serving a model laid over a mesh in the port, across gloo processes on
the CPU: ``prepare_inference(mesh=, rules=)``, ``generate`` and the static
``InferenceServer`` at ``tp_size=2`` (2 processes), ``dp_shard_size=2``
(2) and ``dp_shard_size=2 x tp_size=2`` (4), each rank holding only its
``tp`` blocks and FSDP2 shards.

Each layout is launched once (``debug_launcher``, a ``file://`` store in
the test's temporary directory) in a module-scoped fixture that returns
what each check needs; each check is its own case. The model is the tiny
Llama in f32 (4 q heads, 2 kv heads, 2 layers, ``attention_impl="flash"``:
B1's plain version here) with the JAX package's weights
(``params_from_jax``), as ``tests/test_torch_tensor_parallel.py``
configures it.

Held:
* ``generate`` over the dense, paged and paged_int8 caches, greedy,
  sampled (``top_k``, ``top_p``) and greedy with ``eos_token_id``: the
  tokens of every rank equal each other bit for bit, and equal the
  one-process port's. Greedy tokens follow the near-tie rule: where a row
  first differs, the one-process logits' top-two gap at that step must be
  under ``LOGIT_ATOL`` (the test prints it), and the logits are compared
  instead (below). Sampled tokens must be equal: every rank draws the
  one-process noise on logits within ``LOGIT_ATOL`` of its logits.
* The prefill's logits and the decode logits of every step, teacher-forced
  on the one-process greedy tokens through each cache, within
  ``LOGIT_ATOL`` (1e-5 absolute; f32 logits of order 1, each
  row-parallel product's partial sums summed in another order).
* Greedy tokens against JAX ``generate`` on the same weights and ids at
  ``ParallelismConfig(tp_size=4, dp_shard_size=2)`` with
  ``tensor_parallel_rules()`` and at ``dp_shard_size=8`` (the inputs of
  JAX ``tests/test_inference.py::test_generate_tp_sharded`` and
  ``::test_generate_sharded``) on the suite's 8 virtual devices, under the
  same near-tie rule.
* Each rank's KV cache and logits buffer hold only its kv heads and
  vocabulary block; the parameters it holds are its blocks; one program
  per key and layout on every rank, reused with the parameter addresses it
  read (the leaves are read in place, not restacked).
* The static server over ``tp`` 2 returns the unsharded server's
  ``ServingResult``s from rank 0; ``submit`` on rank 1 raises, and rank
  1's ``close`` returns once rank 0's has ended it.
* A planted fault: rank 1 called with another seed is caught on every
  rank. ``load_checkpoint_and_dispatch`` into ``tp`` 2 then ``generate``
  gives the one-process tokens; the continuous engine, which refused a
  model laid over a mesh until it was ported, runs it on every rank and
  gives the one-process ``generate``'s greedy tokens
  (``tests/test_torch_tp_engine.py`` holds it in full).
"""

import os

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

LAYOUTS = {  # name -> (processes, ParallelismConfig fields)
    "tp": (2, dict(tp_size=2)),
    "dp_shard": (2, dict(dp_shard_size=2)),
    "tp_dp_shard": (4, dict(dp_shard_size=2, tp_size=2)),
}
JAX_LAYOUTS = {"tp4_dp_shard2": dict(tp_size=4, dp_shard_size=2), "dp_shard8": dict(dp_shard_size=8)}
BACKENDS = ("dense", "paged", "paged_int8")
MODES = ("greedy", "sampled", "eos")
ROWS, PROMPT, NEW, BLOCK = 3, 7, 6, 4
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)
LOGIT_ATOL = 1e-5
# the JAX static real-model serving test's traffic, and one request more
# that starts a second batch
SERVER_PROMPTS = [(0, 2, 6), (1, 1, 5)]  # (rng seed, requests, prompt length)
SERVER_NEW = 4
# every LlamaConfig knob the serving steps run under tp (Gemma, Qwen), as
# tests/test_torch_tensor_parallel.py sets them: the tied head is the
# embedding's vocabulary block, the final softcap runs on it
KNOBS = dict(attention_bias=True, tie_word_embeddings=True, post_block_norms=True,
             attn_logit_softcap=20.0, final_logit_softcap=15.0, query_pre_attn_scalar=32.0,
             rms_norm_offset=True, scale_embeddings=True, hidden_act="gelu_tanh")


def _port_config(**kw):
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash", **kw)


def _knobs_model():
    """The knobs' tiny Llama, the same seeded weights in every process."""
    from accelerate_tpu_torch.models import llama as tl

    return tl.create_llama(_port_config(**KNOBS), seed=3, device="cpu")


def _ids():
    return np.random.default_rng(11).integers(4, 256, size=(ROWS, PROMPT)).astype(np.int32)


def _call(backend, mode, eos):
    kw = dict(kv_backend=backend, kv_block_size=BLOCK)
    if mode == "sampled":
        kw.update(SAMPLED)
    elif mode == "eos":
        kw.update(eos_token_id=eos, pad_token_id=3)
    return kw


def _scores(cfg, params, ids, tokens, backend, tp=None, fsdp=None):
    """The f32 logits (B, NEW, V) that score each of ``tokens``' new
    positions: the prefill's last logits, then one decode step a position
    fed the token before it, through ``backend``'s cache."""
    from accelerate_tpu_torch.kvcache import PagedKVLayout, pool_from_dense
    from accelerate_tpu_torch.models.llama import llama_decode_step, llama_prefill

    total = -(-(PROMPT + NEW) // BLOCK) * BLOCK
    group = tp.group if tp is not None else None
    with torch.no_grad():
        logits, cache = llama_prefill(cfg, params, torch.from_numpy(ids).long(), total, tp=tp,
                                      fsdp=fsdp)
        layout = None
        if backend != "dense":
            cache, tables = pool_from_dense(cache, BLOCK, quantized=backend == "paged_int8",
                                            group=group)
            layout = PagedKVLayout(tables, BLOCK, cfg.compute_dtype, tp_group=group)
        out = [logits]
        toks = torch.from_numpy(np.ascontiguousarray(tokens)).long()
        for j in range(NEW - 1):
            step, _ = llama_decode_step(cfg, params, cache, toks[:, PROMPT + j:PROMPT + j + 1],
                                        torch.tensor(PROMPT + j), kv_layout=layout, tp=tp, fsdp=fsdp)
            out.append(step)
    return torch.stack(out, dim=1).numpy()


def _server_prompts():
    return [p for seed, n, length in SERVER_PROMPTS
            for p in np.random.default_rng(seed).integers(0, 256, size=(n, length)).astype(np.int32)]


def _server_config():
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    return ServingConfig(max_batch_size=2, batch_window_s=0.5, pad_total_multiple=16,
                         batch_bucket=True)


def _result(res):
    return dict(tokens=res.tokens.tolist(), batch_size=res.batch_size,
                decode_steps=res.decode_steps)


def _serve(model, rank=0):
    """Rank 0 submits the traffic and returns its results; any other rank
    returns what its ``submit`` raised and whether its ``close`` returned
    once rank 0's server ended it."""
    from accelerate_tpu_torch.serving import InferenceServer

    srv = InferenceServer(model, _server_config(), device="cpu")
    if rank:
        try:
            srv.submit(np.arange(1, 5), max_new_tokens=SERVER_NEW)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        return dict(refused=refused, closed=srv.close(), replayed=srv.metrics["batches"])
    with srv:
        futs = [srv.submit(p, max_new_tokens=SERVER_NEW) for p in _server_prompts()]
        results = [_result(f.result(120)) for f in futs]
    return dict(results=results, batches=srv.metrics["batches"])


def _one_process(params, eos_probe=False):
    """The one-process port's tokens, teacher-forced logits and server
    results (with ``eos_probe``, only the greedy tokens that pick the eos
    id)."""
    from accelerate_tpu_torch.inference import generate
    from accelerate_tpu_torch.models import llama as tl

    cfg = _port_config()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    ids = _ids()
    greedy = generate(model, ids, NEW).numpy()
    if eos_probe:
        return greedy
    eos = int(greedy[0, PROMPT + 1])
    out = {"eos": eos, "tokens": {}, "scores": {}}
    for backend in BACKENDS:
        for mode in MODES:
            out["tokens"][backend, mode] = generate(model, ids, NEW, **_call(backend, mode, eos)).numpy()
        out["scores"][backend] = _scores(cfg, model.params, ids, out["tokens"][backend, "greedy"],
                                         backend)
    out["greedy"] = {backend: out["tokens"][backend, "greedy"] for backend in BACKENDS}
    out["server"] = _serve(model)
    knobs = _knobs_model()
    tokens = generate(knobs, ids, NEW).numpy()
    out["knobs"] = (tokens, _scores(knobs.config, knobs.params, ids, tokens, "dense"))
    return out


def _mesh_model(params, pcfg, rules=True):
    from accelerate_tpu_torch.inference import prepare_inference
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    cfg = _port_config()
    mesh = ParallelismConfig(**pcfg).build_device_mesh()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    tp_rules = tensor_parallel_rules() if rules and pcfg.get("tp_size", 1) > 1 else None
    return prepare_inference(model, mesh=mesh, rules=tp_rules), mesh, tp_rules


def _layout_facts(model, mesh, tp_rules, params, pcfg):
    """What a rank holds: its programs' cache and logits shapes, its
    parameters' elements against the whole model's, and whether
    ``dispatch_model`` lays a fresh model out the same."""
    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch.big_modeling import dispatch_model
    from accelerate_tpu_torch.models import llama as tl

    progs = list(model._generate_cache.values())
    caches = sorted({tuple((p.cache["k"]["q"] if isinstance(p.cache["k"], dict)
                            else p.cache["k"]).shape) for p in progs})
    logits = sorted({tuple(p.logits.shape) for p in progs})
    held = sum(p.to_local().numel() for p in model.parameters())
    # each parameter's elements over the ranks of the dims that split it
    share = sum(p.numel() // int(np.prod([p.device_mesh.size(i) for i, pl in enumerate(p.placements)
                                          if getattr(pl, "dim", None) is not None]))
                for p in model.parameters())
    whole = sum(p.numel() for p in model.parameters())
    cfg = _port_config()
    other = dispatch_model(tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu")),
                           mesh=mesh, rules=tp_rules)
    theirs = dict(other.named_parameters())
    same = all(isinstance(p, DTensor) and p.placements == theirs[n].placements
               and torch.equal(p.to_local(), theirs[n].to_local())
               for n, p in model.named_parameters())
    gather = getattr(model, "_generate_gather", None)
    return dict(caches=caches, logits=logits, held=held, share=share, whole=whole,
                same_as_dispatch=same,
                all_dtensor=all(isinstance(p, DTensor) for p in model.parameters()),
                programs=len(progs), gather=gather is not None,
                gather_shared=all(p.fsdp is gather for p in progs),
                gathered=sorted(gather._buffers) if gather is not None else [])


def _programs(model, ids):
    """The program keys, and whether a second call with one key reuses its
    program and reads the same parameter addresses, which are the model's
    own local blocks."""
    from accelerate_tpu_torch.inference import _param_ptrs, generate, generate_cache_stats
    from accelerate_tpu_torch.models.llama import serving_view

    before = dict(model._generate_cache)
    ptrs = _param_ptrs(serving_view(model).params)
    generate(model, ids, NEW)
    after = dict(model._generate_cache)
    own = {p.to_local().data_ptr() for p in model.parameters()}
    return dict(stats=generate_cache_stats(model),
                reused=all(after[k] is before[k] for k in before) and after.keys() == before.keys(),
                stable=_param_ptrs(serving_view(model).params) == ptrs,
                in_place=set(ptrs) <= own)


def _lru_bound(params, pcfg):
    """A fresh mesh model under ``ACCELERATE_GENERATE_CACHE_MAX=1`` after
    calls with two keys: its LRU."""
    from accelerate_tpu_torch.inference import generate, generate_cache_stats

    os.environ["ACCELERATE_GENERATE_CACHE_MAX"] = "1"
    try:
        model, _, _ = _mesh_model(params, pcfg)
        for n in (3, 4):
            generate(model, _ids()[:, :n], max_new_tokens=2)
    finally:
        del os.environ["ACCELERATE_GENERATE_CACHE_MAX"]
    return generate_cache_stats(model)


def _knobs_run(pcfg, ids, greedy):
    """The knobs' model laid over the mesh: greedy tokens, and the dense
    logits teacher-forced on the one process's tokens."""
    from accelerate_tpu_torch.inference import generate, prepare_inference
    from accelerate_tpu_torch.models.llama import serving_view
    from accelerate_tpu_torch.ops.collectives import ShardGather
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    rules = tensor_parallel_rules() if pcfg.get("tp_size", 1) > 1 else None
    model = prepare_inference(_knobs_model(), mesh=ParallelismConfig(**pcfg).build_device_mesh(),
                              rules=rules)
    tokens = generate(model, ids, NEW).numpy()
    view = serving_view(model)
    fsdp = ShardGather(view.fsdp_group) if view.fsdp_group is not None else None
    return tokens, _scores(model.config, view.params, ids, greedy, "dense", tp=view.tp, fsdp=fsdp)


def _layout_body(params, pcfg, name, eos, greedy, knobs_greedy, ckpt):
    """One launch per layout: every call's tokens, the teacher-forced
    logits, what the rank holds, its programs, the planted fault; ``tp``
    also the static server, the LRU bound, loading and the engine's
    refusal."""
    import torch.distributed as dist

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.inference import generate
    from accelerate_tpu_torch.models.llama import serving_view
    from accelerate_tpu_torch.ops.collectives import ShardGather

    Accelerator(cpu=True)
    rank = dist.get_rank()
    model, mesh, tp_rules = _mesh_model(params, pcfg)
    ids = _ids()
    out = {"tokens": {}, "scores": {}}
    for backend in BACKENDS:
        for mode in MODES:
            out["tokens"][backend, mode] = generate(model, ids, NEW,
                                                    **_call(backend, mode, eos)).numpy()
        view = serving_view(model)
        fsdp = ShardGather(view.fsdp_group) if view.fsdp_group is not None else None
        out["scores"][backend] = _scores(model.config, view.params, ids, greedy[backend], backend,
                                         tp=view.tp, fsdp=fsdp)
    out["facts"] = _layout_facts(model, mesh, tp_rules, params, pcfg)
    out["programs"] = _programs(model, ids)
    # the planted fault: rank 1 samples with another seed
    try:
        seed = SAMPLED["seed"] + (rank == 1)
        generate(model, ids, NEW, **{**SAMPLED, "seed": seed})
        out["fault"] = None
    except ValueError as e:
        out["fault"] = str(e)
    out["knobs"] = _knobs_run(pcfg, ids, knobs_greedy)
    if name == "tp":
        out["lru"] = _lru_bound(params, pcfg)
        out["server"] = _serve(model, rank)
        out["load"] = _load_and_generate(ckpt, mesh, tp_rules)
        out["engine"] = _engine_tokens(model)
        out["leader"] = _leader_beats_then_goes_quiet(model, rank)
    return out


def _leader_beats_then_goes_quiet(model, rank):
    """Two static servers with the bound ``_leader_lost_after`` gives a
    short config: the first stays idle past that bound (rank 0's beats keep
    rank 1 replaying) and then serves a request; under the second rank 0
    sends nothing at all, as a killed process would. Rank 1 returns how
    each server ended and how long its ``close`` waited."""
    import contextlib
    import time
    from unittest import mock

    import torch.distributed as dist

    from accelerate_tpu_torch.serving import InferenceServer, _leader_lost_after, _MeshControl
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    cfg = ServingConfig(drain_timeout_s=1.0, retry_backoff_max_s=0.1)
    bound = _leader_lost_after(cfg)
    out = {"bound": bound}
    srv = InferenceServer(model, cfg, device="cpu")
    time.sleep(bound + 1.0)
    if rank == 0:
        srv.submit(_ids()[0], max_new_tokens=2).result(60)
    else:
        out["alive"] = dict(closed=srv.close(), replayed=srv.metrics["batches"],
                            error=repr(srv._worker_error))
    srv.close()
    dist.barrier()
    quiet = (mock.patch.object(_MeshControl, "send", lambda self, message: None) if rank == 0
             else contextlib.nullcontext())
    with quiet:
        srv = InferenceServer(model, cfg, device="cpu")
        t0 = time.monotonic()
        closed = srv.close()
        out["quiet"] = dict(closed=closed, waited=time.monotonic() - t0,
                            error=repr(srv._worker_error))
    dist.barrier()
    return out


def _load_and_generate(ckpt, mesh, tp_rules):
    from accelerate_tpu_torch.big_modeling import init_empty_weights, load_checkpoint_and_dispatch
    from accelerate_tpu_torch.inference import generate
    from accelerate_tpu_torch.models import llama as tl

    with init_empty_weights():
        empty = tl.create_llama(_port_config())
    model = load_checkpoint_and_dispatch(empty, ckpt, mesh=mesh, rules=tp_rules)
    return generate(model, _ids(), NEW).numpy()


def _engine_tokens(model):
    """The continuous engine on the mesh model: every row of ``_ids()``
    greedy, as prompt + new tokens."""
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(model, slots=ROWS, max_len=32, device="cpu")
    occs = [eng.insert(row, max_new_tokens=NEW) for row in _ids()]
    eng.drain()
    return np.stack([o.output_row() for o in occs])


def _jax_config():
    import jax.numpy as jnp

    from accelerate_tpu.models import llama as jl

    return jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla",
                               attention_kv_block=16)


@pytest.fixture(scope="module")
def jax_params():
    import jax

    from accelerate_tpu.models import llama as jl

    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(_jax_config(), jax.random.key(0)))


@pytest.fixture(scope="module")
def jax_tokens(jax_params):
    """JAX ``generate``'s greedy tokens over each of its meshes, and the
    seconds each took (its ``tp_size=4`` test is slow-marked in the JAX
    suite)."""
    import time

    import jax
    import jax.numpy as jnp

    from accelerate_tpu.inference import generate, prepare_inference
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu.parallel.tp import tensor_parallel_rules
    from accelerate_tpu.parallelism_config import ParallelismConfig

    out = {}
    for name, pcfg in JAX_LAYOUTS.items():
        t0 = time.perf_counter()
        model = jl.create_llama(_jax_config(), seed=0)
        model.params = jax.tree_util.tree_map(jnp.asarray, jax_params)
        rules = tensor_parallel_rules() if "tp_size" in pcfg else None
        model = prepare_inference(model, mesh=ParallelismConfig(**pcfg).build_device_mesh(),
                                  rules=rules)
        out[name] = (np.asarray(generate(model, _ids(), NEW)), time.perf_counter() - t0)
    return out


@pytest.fixture(scope="module")
def runs(jax_params, tmp_path_factory):
    """Every layout's per-rank results, one launch per layout, and the one
    process's."""
    from accelerate_tpu_torch.checkpointing import save_model_checkpoint
    from accelerate_tpu_torch.models import llama as tl

    from accelerate_tpu_torch.state import AcceleratorState, PartialState

    tmp = tmp_path_factory.mktemp("tp_serving")
    one = _one_process(jax_params)
    cfg = _port_config()
    ckpt = str(tmp / "model")
    PartialState(cpu=True)
    try:
        save_model_checkpoint(
            tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, jax_params, device="cpu")), ckpt)
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
    out = {"one": one}
    for name, (procs, pcfg) in LAYOUTS.items():
        out[name] = debug_launcher(
            _layout_body, args=(jax_params, pcfg, name, one["eos"], one["greedy"],
                                one["knobs"][0], ckpt),
            num_processes=procs, init_method=f"file://{tmp}/store_{name}")
    return out


def _near_tie_held(got, want, scores, label):
    """Greedy rows equal, or first differing at a step whose top-two logit
    gap in ``scores`` (the one-process logits scoring ``want``) is under
    ``LOGIT_ATOL``; returns the near-ties seen."""
    ties = []
    for r in range(want.shape[0]):
        diff = np.nonzero(got[r, PROMPT:] != want[r, PROMPT:])[0]
        if diff.size == 0:
            continue
        j = int(diff[0])
        top = np.sort(scores[r, j])[-2:]
        assert top[1] - top[0] < LOGIT_ATOL, (
            f"{label}: row {r} step {j} gives {got[r, PROMPT + j]} for {want[r, PROMPT + j]}, "
            f"top-two gap {top[1] - top[0]:.3e}")
        ties.append((r, j, float(top[1] - top[0])))
    if ties:
        print(f"{label}: near-ties (row, step, gap) {ties}: compared by their logits")
    return ties


CASES = [(name, backend, mode) for name in LAYOUTS for backend in BACKENDS for mode in MODES]


@pytest.mark.parametrize("name,backend,mode", CASES)
def test_tokens_equal_on_every_rank(runs, name, backend, mode):
    ranks = [r["tokens"][backend, mode] for r in runs[name]]
    assert ranks[0].shape == (ROWS, PROMPT + NEW) and (ranks[0][:, :PROMPT] == _ids()).all()
    for r, tokens in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(tokens, ranks[0], err_msg=f"rank {r}")


@pytest.mark.parametrize("name,backend,mode", CASES)
def test_tokens_equal_one_process(runs, name, backend, mode):
    got = runs[name][0]["tokens"][backend, mode]
    want = runs["one"]["tokens"][backend, mode]
    if mode == "sampled":
        np.testing.assert_array_equal(got, want)
    else:
        _near_tie_held(got, want, runs["one"]["scores"][backend], f"{name} {backend} {mode}")
    if mode == "eos":  # row 0 freezes at its eos: the pad id after it
        row = want[0, PROMPT:]
        fired = np.nonzero(row == runs["one"]["eos"])[0]
        assert fired.size and (row[fired[0] + 1:] == 3).all()


@pytest.mark.parametrize("name,backend", [(n, b) for n in LAYOUTS for b in BACKENDS])
def test_prefill_and_decode_logits_within_tolerance(runs, name, backend):
    want = runs["one"]["scores"][backend]
    assert want.shape == (ROWS, NEW, 256)
    for r, res in enumerate(runs[name]):
        np.testing.assert_allclose(res["scores"][backend], want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_every_knob_tied_head_and_softcaps_over_the_mesh(runs, name):
    want_tokens, want_scores = runs["one"]["knobs"]
    for r, res in enumerate(runs[name]):
        tokens, scores = res["knobs"]
        np.testing.assert_allclose(scores, want_scores, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"rank {r}")
        _near_tie_held(tokens, want_tokens, want_scores, f"{name} knobs rank {r}")


@pytest.mark.parametrize("jax_layout", list(JAX_LAYOUTS))
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_greedy_tokens_equal_jax_over_its_meshes(runs, jax_tokens, jax_layout, name):
    want, seconds = jax_tokens[jax_layout]
    print(f"JAX generate over {jax_layout}: {seconds:.1f}s")
    _near_tie_held(runs[name][0]["tokens"]["dense", "greedy"], want,
                   runs["one"]["scores"]["dense"], f"{name} against JAX {jax_layout}")


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_each_rank_holds_only_its_part(runs, name):
    procs, pcfg = LAYOUTS[name]
    tp = pcfg.get("tp_size", 1)
    cfg = _port_config()
    total = -(-(PROMPT + NEW) // BLOCK) * BLOCK
    for res in runs[name]:
        facts = res["facts"]
        # the dense cache and the pools (whole blocks of BLOCK positions)
        assert facts["caches"] == sorted({
            (2, ROWS, PROMPT + NEW, cfg.num_key_value_heads // tp, cfg.head_dim),
            (2, ROWS * total // BLOCK, BLOCK, cfg.num_key_value_heads // tp, cfg.head_dim)})
        assert facts["logits"] == [(ROWS, cfg.vocab_size // tp)]
        assert facts["all_dtensor"] and facts["same_as_dispatch"]
        assert facts["held"] == facts["share"] < facts["whole"]
        # one gather a model over dp_shard, shared by its programs: one
        # layer's leaves and the root's, never the untied embedding
        assert facts["programs"] == 3 * len(BACKENDS) and facts["gather_shared"]
        assert facts["gather"] == ("dp_shard_size" in pcfg)
        if facts["gather"]:
            assert "embed_tokens/embedding" not in facts["gathered"]
            assert all(n.startswith(("layers/", "lm_head/", "final_norm/"))
                       for n in facts["gathered"]), facts["gathered"]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_one_program_per_key_and_layout_reads_the_leaves_in_place(runs, name):
    procs, pcfg = LAYOUTS[name]
    layout = ("tp", pcfg.get("tp_size", 1), "dp_shard", pcfg.get("dp_shard_size", 1))
    stats = [r["programs"]["stats"] for r in runs[name]]
    assert all(s == stats[0] for s in stats)
    keys = stats[0]["keys"]
    # greedy and eos share no key (eos_on); sampled has its own: 3 a backend
    assert stats[0]["size"] == len(set(keys)) == 3 * len(BACKENDS) and stats[0]["max"] == 16
    assert all(k[-1] == layout for k in keys)
    for r in runs[name]:
        assert r["programs"]["reused"] and r["programs"]["stable"] and r["programs"]["in_place"]


def test_lru_bound_holds_per_layout(runs):
    for res in runs["tp"]:
        assert res["lru"]["size"] == 1 and res["lru"]["max"] == 1
        assert res["lru"]["keys"][0][-1] == ("tp", 2, "dp_shard", 1)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_a_rank_called_with_another_seed_is_caught(runs, name):
    for r, res in enumerate(runs[name]):
        assert res["fault"] is not None and "seed" in res["fault"], f"rank {r}: {res['fault']}"


def test_static_server_over_tp_returns_the_unsharded_servers_results(runs):
    got, want = runs["tp"][0]["server"], runs["one"]["server"]
    assert got == want
    assert got["batches"] == 2 and len(got["results"]) == sum(n for _, n, _ in SERVER_PROMPTS)
    assert runs["tp"][1]["server"]["replayed"] == got["batches"]


def test_submit_on_another_rank_raises_and_names_the_first(runs):
    refused = runs["tp"][1]["server"]["refused"]
    assert refused is not None and "first rank (0)" in refused


def test_close_on_rank0_ends_the_other_ranks(runs):
    assert runs["tp"][1]["server"]["closed"] is True


def test_replaying_rank_stays_alive_on_beats_and_fails_when_the_first_goes_quiet(runs):
    leader = runs["tp"][1]["leader"]
    bound = leader["bound"]
    alive = leader["alive"]  # idle past the bound, then one batch replayed
    assert alive["closed"] is True and alive["replayed"] == 1 and alive["error"] == "None"
    quiet = leader["quiet"]
    assert quiet["closed"] is True and bound <= quiet["waited"] < bound + 10, quiet
    assert "ReplicaDeadError" in quiet["error"] and "first rank (0)" in quiet["error"]
    assert runs["tp"][0]["leader"]["quiet"]["error"] == "None"


def test_load_checkpoint_and_dispatch_then_generate(runs):
    for res in runs["tp"]:
        _near_tie_held(res["load"], runs["one"]["tokens"]["dense", "greedy"],
                       runs["one"]["scores"]["dense"], "loaded over tp")


def test_continuous_engine_refuses_a_model_laid_over_a_mesh(runs):
    """It no longer refuses (ROADMAP.md A8-bis landed): on every rank of
    ``tp`` 2 the engine's greedy tokens are the one-process ``generate``'s."""
    for r, res in enumerate(runs["tp"]):
        _near_tie_held(res["engine"], runs["one"]["tokens"]["dense", "greedy"],
                       runs["one"]["scores"]["dense"], f"engine over tp rank {r}")
