"""The continuous engine over a model laid over a mesh, across gloo
processes on the CPU: ``ContinuousBatchingEngine`` and
``InferenceServer(mode="continuous")`` at ``tp_size=2`` (2 processes),
``dp_shard_size=2`` (2) and ``dp_shard_size=2 x tp_size=2`` (4), each rank
holding only its ``tp`` blocks and FSDP2 shards, under the dense arena, the
paged pool and the int8 pool.

Each layout is launched once (``debug_launcher``, a ``file://`` store in
the test's temporary directory) in a module-scoped fixture; each check is
its own case. The model is the tiny Llama in f32 (4 q heads, 2 kv heads, 2
layers) with the JAX package's weights (``params_from_jax``). The paged
engines run ``attention_impl="kernel"``: the plain versions of B4, B5 and
B6 here, at the rank's heads.

The traffic makes every program run: drafter-friendly prompts (spec verify
steps), prompts longer than the bucket (chunked prefill), greedy and
sampled rows, and more requests than slots (admissions after
retirements). Held:

* Greedy tokens equal the JAX engine's exactly, on every rank, against
  the JAX engine over its meshes (``tp_size=2 x dp_shard_size=4`` with
  ``tensor_parallel_rules()`` and ``dp_shard_size=8``; GSPMD on the
  suite's 8 virtual devices); verify steps and chunk dispatches both ran
  on both sides; ``stats()["programs"]`` equals JAX's.
* Sampled tokens equal the one-process port's exactly, on every rank (a
  slot's stream depends only on its request's seed).
* ``llama_verify_step`` (a 5-token spec window and an 8-token chunk) and
  ``llama_decode_step`` logits within ``LOGIT_ATOL`` of the one process's
  on every rank, and the window K/V each rank returns equal to its kv
  heads of the one process's within the same bound.
* Each rank's store is the one process's over ``tp``: the same blocks,
  its kv heads (an int8 pool keeps its per-position scales whole).
* The continuous server over ``tp`` 2 returns the one-process server's
  tokens, and the replaying rank's engine took the same steps; a deadline
  rank 0's clock runs out mid-decode is cancelled on rank 1 at the same
  point; ``submit`` on rank 1 raises; ``close`` on rank 0 ends rank 1; a
  replaying rank fails with ``ReplicaDeadError`` when rank 0 goes quiet.
* A planted fault: rank 1 built with another ``block_size`` raises on
  every rank, naming it.
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

LAYOUTS = {  # name -> (processes, ParallelismConfig fields)
    "tp": (2, dict(tp_size=2)),
    "dp_shard": (2, dict(dp_shard_size=2)),
    "tp_dp_shard": (4, dict(dp_shard_size=2, tp_size=2)),
}
JAX_LAYOUTS = {"tp2_dp_shard4": dict(tp_size=2, dp_shard_size=4), "dp_shard8": dict(dp_shard_size=8)}
BACKENDS = ("dense", "paged", "paged_int8")
ENGINE_KW = dict(slots=4, max_len=64, prompt_bucket=16, readback_lag=1, block_size=8,
                 spec="ngram", prefill_chunk=8)
NEW = 12
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)
LOGIT_ATOL = 1e-5


def _requests():
    """(prompt, sampling kwargs) of the traffic: tiled prompts the n-gram
    drafter matches, prompts longer than the bucket (chunked), a short
    random one; greedy and sampled; six for four slots."""
    def tiled(seed):  # seeds whose greedy continuation the drafter matches
        return np.tile(np.random.default_rng(seed).integers(1, 50, size=4), 3).astype(np.int32)

    rng = np.random.default_rng(7)

    def rand(n):
        return rng.integers(1, 256, size=n).astype(np.int32)

    return [(tiled(0), {}), (tiled(28), dict(SAMPLED, seed=1)), (rand(27), {}),
            (rand(5), dict(SAMPLED, seed=3)), (tiled(24), {}), (rand(21), dict(SAMPLED, seed=5))]


def _greedy(i) -> bool:
    return "temperature" not in _requests()[i][1]


def _drive(eng, requests):
    """Admit in order as slots and blocks free up, step until every request
    retired; each request's tokens."""
    occs, waiting = [], list(requests)
    guard = 1000
    while waiting or eng.live_count():
        while waiting and eng.free_slots() and eng.can_admit(waiting[0][0], NEW):
            prompt, kw = waiting.pop(0)
            occs.append(eng.insert(prompt, max_new_tokens=NEW, pad_token_id=0, **kw))
        eng.step()
        eng.poll()
        guard -= 1
        assert guard > 0, "the engine did not drain"
    eng.poll(force=True)
    return [list(o.tokens) for o in occs]


def _port_config():
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(compute_dtype=torch.float32)


def _engine(model, backend, **kw):
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    impl = "reference" if backend == "dense" else "kernel"
    return ContinuousBatchingEngine(model, kv_cache=backend, attention_impl=impl, device="cpu",
                                    **{**ENGINE_KW, **kw})


def _facts(eng, tokens):
    s = eng.stats()
    return dict(tokens=tokens, programs=s["programs"], verify_steps=s["spec"]["verify_steps"],
                chunks=s["prefill_chunks"], hbm_bytes=s["kv"]["hbm_bytes"],
                pool_blocks=s["kv"].get("pool_blocks"),
                store=[tuple(t.shape) for t in _store_leaves(eng._cache)])


def _store_leaves(tree):
    for w in ("k", "v"):
        leaf = tree[w]
        yield from ((leaf["q"], leaf["s"]) if isinstance(leaf, dict) else (leaf,))


def _windows(cfg, params, backend, tp=None, fsdp=None):
    """The logits (whole) and window K/V of a 5-token spec window and an
    8-token chunk through ``llama_verify_step``, and one decode step's
    logits, over a cache prefilled with two prompts, through ``backend``'s
    store at the rank's heads."""
    from accelerate_tpu_torch.kvcache import PagedKVLayout, pool_from_dense
    from accelerate_tpu_torch.models.llama import (llama_decode_step, llama_prefill,
                                                   llama_verify_step)

    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(1, 256, size=(2, 9))).long()
    group = tp.group if tp is not None else None
    out = {}
    with torch.no_grad():
        _, cache = llama_prefill(cfg, params, prompt, 32, tp=tp, fsdp=fsdp)
        layout = None
        if backend != "dense":
            cache, tables = pool_from_dense(cache, 8, quantized=backend == "paged_int8",
                                            group=group)
            layout = PagedKVLayout(tables, 8, cfg.compute_dtype, attention_impl="kernel",
                                   tp_group=group)
        pos = torch.tensor([9, 6], dtype=torch.int32)
        for w in (5, 8):
            tokens = torch.from_numpy(rng.integers(1, 256, size=(2, w))).long()
            logits, kv = llama_verify_step(cfg, params, cache, tokens, pos, kv_layout=layout,
                                           tp=tp, fsdp=fsdp)
            out[w] = (logits.numpy(), kv["k"].numpy(), kv["v"].numpy())
        token = torch.from_numpy(rng.integers(1, 256, size=(2, 1))).long()
        logits, _ = llama_decode_step(cfg, params, cache, token, pos, kv_layout=layout, tp=tp,
                                      fsdp=fsdp)
        out["decode"] = logits.numpy()
    return out


def _one_process(params):
    """The one-process port: each backend's engine on the traffic, its
    windows, and the continuous server's results."""
    from accelerate_tpu_torch.models import llama as tl

    cfg = _port_config()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    out = {}
    for backend in BACKENDS:
        eng = _engine(model, backend)
        out[backend] = _facts(eng, _drive(eng, _requests()))
        out[backend]["windows"] = _windows(cfg, model.params, backend)
    out["server"] = _serve(model)
    return out


def _server_config(**kw):
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    return ServingConfig(mode="continuous", engine_slots=4, engine_max_len=64,
                         engine_prompt_bucket=16, kv_cache="paged", engine_block_size=8,
                         attention_impl="kernel", speculative="ngram", engine_prefill_chunk=8,
                         **kw)


def _serve(model, rank=0):
    """Rank 0 submits the traffic and returns its tokens and its engine's
    counters; another rank returns what its ``submit`` raised, whether its
    ``close`` returned once rank 0's server ended it, and its counters."""
    from accelerate_tpu_torch.serving import InferenceServer

    srv = InferenceServer(model, _server_config(), device="cpu")
    if rank:
        try:
            srv.submit(np.arange(1, 5), max_new_tokens=NEW)
            refused = None
        except RuntimeError as e:
            refused = str(e)
        closed = srv.close()
        return dict(refused=refused, closed=closed, counters=_counters(srv),
                    error=repr(srv._worker_error))
    with srv:
        futs = [srv.submit(p, max_new_tokens=NEW, pad_token_id=0, **kw) for p, kw in _requests()]
        tokens = [f.result(120).tokens.tolist() for f in futs]
    return dict(tokens=tokens, counters=_counters(srv), mesh=srv.stats().get("mesh"))


def _counters(srv):
    s = srv.engine.stats()
    return dict(inserted=s["inserted"], retired=s["retired"], steps=s["steps"],
                chunks=s["prefill_chunks"], verify_steps=s["spec"]["verify_steps"],
                programs=s["programs"])


def _mesh_model(params, pcfg):
    from accelerate_tpu_torch.inference import prepare_inference
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    cfg = _port_config()
    mesh = ParallelismConfig(**pcfg).build_device_mesh()
    model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))
    rules = tensor_parallel_rules() if pcfg.get("tp_size", 1) > 1 else None
    return prepare_inference(model, mesh=mesh, rules=rules)


def _layout_body(params, pcfg, name):
    """One launch per layout: each backend's engine on the traffic and its
    windows, the planted fault; ``tp`` also the server and a quiet first
    rank."""
    import torch.distributed as dist

    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.models.llama import serving_view

    # one intra-op thread a rank: up to four ranks share the host's cores,
    # and the tiny model's ops are too small to split
    torch.set_num_threads(1)
    Accelerator(cpu=True)
    rank = dist.get_rank()
    model = _mesh_model(params, pcfg)
    out = {}
    view = serving_view(model)
    for backend in BACKENDS:
        eng = _engine(model, backend)
        out[backend] = _facts(eng, _drive(eng, _requests()))
        out[backend]["gather_shared"] = eng._fsdp is getattr(model, "_generate_gather", None)
        out[backend]["windows"] = _windows(model.config, view.params, backend, tp=view.tp,
                                           fsdp=eng._fsdp)
    try:  # the planted fault: rank 1 builds its pool of other blocks
        _engine(model, "paged", block_size=4 if rank == 1 else 8)
        out["fault"] = None
    except ValueError as e:
        out["fault"] = str(e)
    if name == "tp":
        out["server"] = _serve(model, rank)
        out["deadline"] = _deadline_mid_decode(model, rank)
        out["quiet"] = _leader_goes_quiet(model, rank)
    return out


def _deadline_mid_decode(model, rank):
    """A continuous server whose rank 0 clock (a counter, 1 ms a call) runs
    out one request's deadline while it decodes beside another request
    without one: rank 0 returns how each ended; every rank its engine's
    counters."""
    import itertools

    from accelerate_tpu_torch.serving import InferenceServer

    calls = itertools.count()
    clock = (lambda: next(calls) * 1e-3) if rank == 0 else None
    kw = {} if clock is None else {"clock": clock}
    srv = InferenceServer(model, _server_config(), device="cpu", **kw)
    out = {}
    if rank == 0:
        with srv:
            (late_ids, _), (ok_ids, _) = _requests()[0], _requests()[2]
            late = srv.submit(late_ids, max_new_tokens=NEW, pad_token_id=0, deadline_s=0.005)
            ok = srv.submit(ok_ids, max_new_tokens=NEW, pad_token_id=0)
            try:
                late.result(120)
                out["late"] = None
            except Exception as e:  # noqa: BLE001 - the test reads which
                out["late"] = f"{type(e).__name__}: {e}"
            out["ok"] = ok.result(120).tokens.tolist()
        out["shed"] = srv.metrics["shed_deadline"]
    else:
        srv.close()
    out["counters"] = _counters(srv)
    return out


def _leader_goes_quiet(model, rank):
    """A continuous server under a short ``_leader_lost_after`` bound whose
    rank 0 sends nothing at all, as a killed process would: rank 1 returns
    how it ended and how long its ``close`` waited."""
    import contextlib
    import time
    from unittest import mock

    import torch.distributed as dist

    from accelerate_tpu_torch.serving import InferenceServer, _leader_lost_after, _MeshControl

    cfg = _server_config(drain_timeout_s=1.0, retry_backoff_max_s=0.1)
    quiet = (mock.patch.object(_MeshControl, "send", lambda self, message: None) if rank == 0
             else contextlib.nullcontext())
    with quiet:
        srv = InferenceServer(model, cfg, device="cpu")
        t0 = time.monotonic()
        closed = srv.close()
        out = dict(bound=_leader_lost_after(cfg), closed=closed, waited=time.monotonic() - t0,
                   error=repr(srv._worker_error))
    dist.barrier()
    return out


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
def jax_runs(jax_params):
    """The JAX engine over each of its meshes and each store: the tokens,
    programs and counters on the same traffic."""
    import jax
    import jax.numpy as jnp

    from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
    from accelerate_tpu.inference import prepare_inference
    from accelerate_tpu.models import llama as jl
    from accelerate_tpu.parallel.tp import tensor_parallel_rules
    from accelerate_tpu.parallelism_config import ParallelismConfig

    out = {}
    for name, pcfg in JAX_LAYOUTS.items():
        model = jl.create_llama(_jax_config(), seed=0)
        model.params = jax.tree_util.tree_map(jnp.asarray, jax_params)
        rules = tensor_parallel_rules() if "tp_size" in pcfg else None
        model = prepare_inference(model, mesh=ParallelismConfig(**pcfg).build_device_mesh(),
                                  rules=rules)
        for backend in BACKENDS:
            eng = JEngine(model, kv_cache=backend, **ENGINE_KW)
            tokens = _drive(eng, _requests())
            s = eng.stats()
            out[name, backend] = dict(tokens=tokens, programs=s["programs"],
                                      verify_steps=s["spec"]["verify_steps"],
                                      chunks=s["prefill_chunks"])
    return out


@pytest.fixture(scope="module")
def runs(jax_params, tmp_path_factory):
    """Every layout's per-rank results, one launch per layout, and the one
    process's."""
    import time

    tmp = tmp_path_factory.mktemp("tp_engine")
    t0 = time.perf_counter()
    out = {"one": _one_process(jax_params)}
    seconds = {"one": time.perf_counter() - t0}
    for name, (procs, pcfg) in LAYOUTS.items():
        t0 = time.perf_counter()
        out[name] = debug_launcher(_layout_body, args=(jax_params, pcfg, name),
                                   num_processes=procs, init_method=f"file://{tmp}/store_{name}")
        seconds[name] = time.perf_counter() - t0
    print(f"seconds: {seconds}")
    return out


@pytest.mark.parametrize("jax_layout", list(JAX_LAYOUTS))
@pytest.mark.parametrize("name,backend", [(n, b) for n in LAYOUTS for b in BACKENDS])
def test_greedy_tokens_equal_the_jax_engine_over_its_meshes(runs, jax_runs, name, backend,
                                                            jax_layout):
    want = jax_runs[jax_layout, backend]
    assert want["verify_steps"] > 0 and want["chunks"] > 0
    greedy = [i for i in range(len(_requests())) if _greedy(i)]
    for r, res in enumerate(runs[name]):
        got = res[backend]
        assert got["verify_steps"] > 0 and got["chunks"] > 0, f"rank {r}"
        assert [got["tokens"][i] for i in greedy] == [want["tokens"][i] for i in greedy], f"rank {r}"
        assert all(len(t) == NEW for t in got["tokens"])
        assert got["programs"] == want["programs"], f"rank {r}"


@pytest.mark.parametrize("name,backend", [(n, b) for n in LAYOUTS for b in BACKENDS])
def test_sampled_tokens_equal_the_one_process_port(runs, name, backend):
    want = runs["one"][backend]["tokens"]
    for r, res in enumerate(runs[name]):
        assert res[backend]["tokens"] == want, f"rank {r}"
        assert res[backend]["programs"] == runs["one"][backend]["programs"]


@pytest.mark.parametrize("name,backend", [(n, b) for n in LAYOUTS for b in BACKENDS])
def test_verify_and_decode_logits_within_tolerance_at_the_rank_heads(runs, name, backend):
    tp = LAYOUTS[name][1].get("tp_size", 1)
    want = runs["one"][backend]["windows"]
    for r, res in enumerate(runs[name]):
        got = res[backend]["windows"]
        np.testing.assert_allclose(got["decode"], want["decode"], rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"rank {r} decode")
        heads = 2 // tp  # kv heads a rank; rank r of tp holds block r
        first = (r % tp) * heads
        for w in (5, 8):
            logits, k, v = got[w]
            assert logits.shape == (2, w, 256)
            np.testing.assert_allclose(logits, want[w][0], rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"rank {r} window {w}")
            for mine, whole in ((k, want[w][1]), (v, want[w][2])):
                assert mine.shape[3] == heads
                np.testing.assert_allclose(mine, whole[:, :, :, first:first + heads], rtol=0,
                                           atol=LOGIT_ATOL, err_msg=f"rank {r} window {w} kv")


@pytest.mark.parametrize("name,backend", [(n, b) for n in LAYOUTS for b in BACKENDS])
def test_each_rank_store_is_the_one_process_store_over_tp(runs, name, backend):
    tp = LAYOUTS[name][1].get("tp_size", 1)
    one = runs["one"][backend]
    cfg = _port_config()
    for r, res in enumerate(runs[name]):
        got = res[backend]
        assert got["pool_blocks"] == one["pool_blocks"]
        assert got["gather_shared"], f"rank {r}: the engine made a second shard gather"
        for mine, whole in zip(got["store"], one["store"]):
            if len(whole) == 5:  # (L, blocks or slots, positions, kv heads, head dim)
                assert mine == whole[:3] + (whole[3] // tp, whole[4])
            else:  # an int8 pool's scales: one per position, whole
                assert mine == whole
        if backend == "paged_int8":  # the scales are whole on every rank
            scales = 2 * one["pool_blocks"] * cfg.num_hidden_layers * ENGINE_KW["block_size"] * 4
            assert got["hbm_bytes"] == (one["hbm_bytes"] - scales) // tp + scales
        else:
            assert got["hbm_bytes"] * tp == one["hbm_bytes"]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_a_rank_built_with_another_block_size_is_caught_on_every_rank(runs, name):
    for r, res in enumerate(runs[name]):
        fault = res["fault"]
        # rank 1 is mesh index 1 in each layout (row-major over dp_shard, tp)
        assert fault is not None and "block_size" in fault and "mesh index [1]" in fault, (
            f"rank {r}: {fault}")


def test_continuous_server_over_tp_returns_the_one_process_servers_tokens(runs):
    got, want = runs["tp"][0]["server"], runs["one"]["server"]
    assert got["tokens"] == want["tokens"]
    assert got["counters"]["inserted"] == len(_requests()) == got["counters"]["retired"]
    assert got["counters"]["verify_steps"] > 0 and got["counters"]["chunks"] > 0
    # the replaying rank made the same engine calls
    assert runs["tp"][1]["server"]["counters"] == got["counters"]
    assert got["mesh"]["ranks"] == 2 and got["mesh"]["messages"] >= got["counters"]["steps"]


def test_a_deadline_the_first_rank_cancels_mid_decode_is_replayed(runs):
    first, other = runs["tp"][0]["deadline"], runs["tp"][1]["deadline"]
    assert first["late"] is not None and "mid-decode" in first["late"], first["late"]
    assert first["shed"] == 1
    # the other request is served as without the cancelled one
    assert first["ok"] == runs["one"]["server"]["tokens"][2]
    # the replaying rank cancelled it at the same point: the same engine calls
    assert other["counters"] == first["counters"]
    assert first["counters"]["inserted"] == 2 == first["counters"]["retired"]


def test_submit_on_another_rank_raises_and_names_the_first(runs):
    refused = runs["tp"][1]["server"]["refused"]
    assert refused is not None and "first rank (0)" in refused


def test_close_on_rank0_ends_the_other_ranks(runs):
    other = runs["tp"][1]["server"]
    assert other["closed"] is True and other["error"] == "None"


def test_replaying_rank_fails_when_the_first_goes_quiet(runs):
    quiet = runs["tp"][1]["quiet"]
    assert quiet["closed"] is True and quiet["bound"] <= quiet["waited"] < quiet["bound"] + 10, quiet
    assert "ReplicaDeadError" in quiet["error"] and "first rank (0)" in quiet["error"]
    assert runs["tp"][0]["quiet"]["error"] == "None"


def test_the_server_worker_runs_on_its_engine_card(monkeypatch):
    """Over a mesh each rank's engine lives on its own card, and a new
    thread starts on the first: the server's worker makes the engine's
    card its current device before any work (CUDA events and streams
    follow the current device)."""
    import threading

    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    seen = []
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: seen.append(
        (threading.current_thread().name, torch.device(d))))

    class IdleEngine:  # what the worker reads of an engine on the second card
        device = torch.device("cuda", 1)

        def live_count(self):
            return 0

        def occupants(self):
            return []

        def reset(self):
            return []

    srv = InferenceServer(torch.nn.Linear(2, 2), ServingConfig(mode="continuous"),
                          engine=IdleEngine(), device="cpu")
    assert srv.close() is True
    assert seen == [("inference-server", torch.device("cuda", 1))]
