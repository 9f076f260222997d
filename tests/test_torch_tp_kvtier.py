"""The host-RAM KV tier, disaggregated prefill and the KV wire on engines,
servers and fleet replicas laid over a mesh, across gloo processes on the
CPU: ``tp_size=2`` (2 processes) and ``dp_shard_size=2 x tp_size=2`` (4).

Each layout is launched once (``debug_launcher``, a ``file://`` store in
the test's temporary directory) in a module-scoped fixture; each check is
its own case. The model is the tiny Llama in f32 (4 q heads, 2 kv heads, 2
layers) with the JAX package's weights (``params_from_jax``); the paged
engines run ``attention_impl="kernel"``: the plain versions of B4, B5 and
B6 here, at the rank's heads. Held:

* The tier: a 40-token prompt served, evicted into the tier by churn,
  then admitted again and restored before its chunks. Greedy tokens equal
  the JAX engine's over its meshes (``tp_size=2 x dp_shard_size=4`` with
  ``tensor_parallel_rules()``, and ``dp_shard_size=8``) on every rank, and
  so do the restores, the tier's counters (spills, hits, misses, drops, the
  whole model's bytes) and the programs; sampled tokens equal the one
  process's. With ``kvcache.spill_mid`` armed on rank 1 alone (some of its
  spills are lost), no rank hangs, every rank restores the same blocks and
  the tokens are equal on every rank.
* Disaggregated prefill in process: ``prefill_remote`` then
  ``insert_prefilled`` on every rank gives ``insert``'s tokens bitwise; the
  gathered window is within ``LOGIT_ATOL`` of the one process's and of the
  JAX engine's over its mesh.
* The server over ``tp`` 2 (``tp`` layout only): ``submit(prefilled=)``
  and a ``FleetRouter(disaggregate_prefill=True)`` with the mesh replica,
  by reference and over the KV wire, return the one-process server's
  tokens, and the replaying rank took the same steps in the same slots; a
  one-process engine's prefill shipped over ``InProcTransport`` and
  ``TCPTransport`` returns the server's local prefill's tokens; the mesh's
  ``to_bytes`` commits on a one-process engine; a reservation released
  before COMMIT raises ``TransferStaleEpochError`` on the sender while
  requests in flight finish.
* Planted faults: rank 1 taking its own next free slot instead of the one
  named raises ``EngineInvariantError``; rank 1 committing the other
  rank's heads of a window changes the tokens.
"""

import numpy as np
import pytest
import torch

from accelerate_tpu_torch.launchers import debug_launcher

LAYOUTS = {  # name -> (processes, ParallelismConfig fields)
    "tp": (2, dict(tp_size=2)),
    "tp_dp_shard": (4, dict(dp_shard_size=2, tp_size=2)),
}
JAX_LAYOUTS = {"tp2_dp_shard4": dict(tp_size=2, dp_shard_size=4), "dp_shard8": dict(dp_shard_size=8)}
TIER_BACKENDS = ("paged", "paged_int8")
COMMIT_BACKENDS = ("dense", "paged")
# tests/test_torch_kvtier.py's shape: a small pool, so the churn evicts
TIER_SHAPE = dict(slots=2, max_len=64, prompt_bucket=16, readback_lag=2, block_size=8,
                  pool_blocks=8, prefill_chunk=16, host_tier_bytes=8 << 20)
TIER_COUNTERS = ("spill_blocks", "restore_hits", "restore_misses", "host_tier_dropped",
                 "host_tier_bytes", "host_tier_blocks", "host_tier_capacity_bytes")
DISAGG_KW = dict(slots=2, max_len=32, prompt_bucket=8, readback_lag=2, block_size=8)
PROMPTS = [np.asarray([3, 1, 4, 1, 5], np.int32), np.asarray([11, 2, 9, 4, 6, 1, 7], np.int32)]
CASES = [dict(temperature=0.0), dict(temperature=0.8, top_k=40, top_p=0.9, seed=13)]
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)
# kvcache.spill_mid fires on rank 1's spill batches after the first two:
# its tier keeps a prefix of the prompt's chain, the other ranks all of it
LOST_SPILLS = "kvcache.spill_mid:raise:after=2"
NEW = 6
LOGIT_ATOL = 1e-5


def _long_prompt(n=40, seed=22):
    return np.random.default_rng(seed).integers(1, 255, size=n).astype(np.int32)


def _tier_scenario(eng, **kw):
    """tests/test_torch_kvtier.py's traffic: a 40-token prompt (five full
    blocks, chunked), churn that evicts it into the tier, the prompt again
    (one restore). Returns both outputs, the counters and the programs."""
    prompt = _long_prompt()
    occ = eng.insert(prompt, max_new_tokens=4, pad_token_id=0, **kw)
    eng.drain()
    first = occ.output_row().tolist()
    for i in range(8):
        p = np.random.default_rng(9_000 + 200 + i).integers(1, 255, size=12).astype(np.int32)
        eng.insert(p, max_new_tokens=2, pad_token_id=0)
        eng.drain()
    eng._backend.spill_flush()
    occ2 = eng.insert(prompt, max_new_tokens=4, pad_token_id=0, **kw)
    eng.drain()
    eng._backend.spill_flush()  # the last admission's spills land before the counters are read
    kv = eng.stats()["kv"]
    return dict(first=first, second=occ2.output_row().tolist(), kv_restores=eng.kv_restores,
                **{k: kv[k] for k in TIER_COUNTERS}, programs=eng.stats()["programs"],
                restore_sig=("restore", 8) in getattr(eng, "_programs", {}).get("prefill_insert", ()))


def _port_config():
    from accelerate_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig.tiny(compute_dtype=torch.float32)


def _tier_engine(model, backend):
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    return ContinuousBatchingEngine(model, kv_cache=backend, attention_impl="kernel", device="cpu",
                                    **TIER_SHAPE)


def _disagg_engine(model, backend, **kw):
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    impl = "reference" if backend == "dense" else "kernel"
    return ContinuousBatchingEngine(model, kv_cache=backend, attention_impl=impl, device="cpu",
                                    **{**DISAGG_KW, **kw})


def _run(eng, prompt, **kw):
    occ = eng.insert(prompt, max_new_tokens=NEW, pad_token_id=0, **kw)
    eng.drain()
    return occ.output_row().tolist()


def _commit(eng, pre, **kw):
    occ = eng.insert_prefilled(pre, **kw)
    eng.drain()
    return occ.output_row().tolist()


def _disagg(model):
    """Each commit backend: insert's rows, then prefill_remote +
    insert_prefilled's, and the (whole) windows."""
    out = {}
    for backend in COMMIT_BACKENDS:
        eng = _disagg_engine(model, backend)
        plain = [_run(eng, p, **kw) for p, kw in zip(PROMPTS, CASES)]
        pres = [eng.prefill_remote(p, max_new_tokens=NEW, pad_token_id=0, **kw)
                for p, kw in zip(PROMPTS, CASES)]
        windows = [{w: t.clone().numpy() for w, t in pre.cache.items()} for pre in pres]
        split = [_commit(eng, pre) for pre in pres]
        out[backend] = dict(plain=plain, split=split, windows=windows,
                            programs=eng.stats()["programs"])
    return out


def _one_model(params):
    from accelerate_tpu_torch.models import llama as tl

    cfg = _port_config()
    return tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, params, device="cpu"))


def _one_process(params):
    """The one-process port: the tier scenario greedy and sampled, the
    disaggregated commits and windows, and the server's tokens."""
    model = _one_model(params)
    out = {"tier": {b: _tier_scenario(_tier_engine(model, b)) for b in TIER_BACKENDS},
           "tier_sampled": _tier_scenario(_tier_engine(model, "paged"), **SAMPLED),
           "disagg": _disagg(model)}
    from accelerate_tpu_torch.serving import InferenceServer

    with InferenceServer(model, _server_config(), device="cpu") as srv:
        out["server"] = [f.result(120).tokens.tolist() for f in
                         [srv.submit(p, max_new_tokens=NEW, pad_token_id=0, **kw)
                          for p, kw in _traffic()]]
    with InferenceServer(model, _tier_server_config(), device="cpu") as srv:
        out["tier_server"] = _serve_tier(srv)
    return out


def _traffic():
    """The server's requests: the two prompts greedy and sampled."""
    return [(p, kw) for kw in CASES for p in PROMPTS]


def _server_config(**kw):
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    return ServingConfig(mode="continuous", engine_slots=4, engine_max_len=32,
                         engine_prompt_bucket=8, kv_cache="paged", engine_block_size=8,
                         attention_impl="kernel", **kw)


def _mesh_model(params, pcfg):
    from accelerate_tpu_torch.inference import prepare_inference
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules
    from accelerate_tpu_torch.parallelism_config import ParallelismConfig

    mesh = ParallelismConfig(**pcfg).build_device_mesh()
    return prepare_inference(_one_model(params), mesh=mesh, rules=tensor_parallel_rules())


def _lost_spills(model, rank):
    """The tier scenario with rank 1's spills lost after its first two
    batches: the restored blocks and the tokens on this rank."""
    import os

    from accelerate_tpu_torch.utils.fault import FAULT_INJECT_ENV

    if rank == 1:
        os.environ[FAULT_INJECT_ENV] = LOST_SPILLS
    try:
        eng = _tier_engine(model, "paged")
        local = []
        plan = eng._backend.restore_plan

        def spy(*a, agree=None, **k):  # the chain this rank held before the agreement
            def mine(n):
                local.append(n)
                return agree(n)
            return plan(*a, agree=mine, **k)

        eng._backend.restore_plan = spy
        res = _tier_scenario(eng)
    finally:
        os.environ.pop(FAULT_INJECT_ENV, None)
    return dict(res, local_chain=local)


def _slot_fault(model, rank):
    """Two engine-level replays of admissions that name their slots. Rank
    0 reserves a slot for a transfer and admits a request, telling the
    others the reservation and the slot it took as it takes it; then every
    rank runs a remote prefill. The control: the other ranks take the
    named slot, and every rank commits the prefill into the reserved one.
    The fault: rank 1 takes its own next free slot for the admission, which
    is the slot rank 0 reserved, so the commit that names that slot must
    raise on rank 1 before any collective (only rank 1 tries it)."""
    import torch.distributed as dist

    from accelerate_tpu_torch.utils.fault import EngineInvariantError

    out = {}
    for fault in (False, True):
        eng = _disagg_engine(model, "paged")
        kw = dict(max_new_tokens=NEW, pad_token_id=0)
        if rank == 0:
            reserved = eng.reserve_slot()
            occ = eng.insert(PROMPTS[0], on_slot=lambda slot: dist.broadcast_object_list(
                [(reserved, slot)], src=0), **kw)
        else:
            box = [None]
            dist.broadcast_object_list(box, src=0)
            reserved, named = box[0]
            occ = eng.insert(PROMPTS[0], slot=None if fault and rank == 1 else named, **kw)
        pre = eng.prefill_remote(PROMPTS[1], max_new_tokens=NEW, pad_token_id=0)
        if fault:
            out["fault"] = None
            if rank == 1:
                try:
                    eng.insert_prefilled(pre, slot=reserved[0])
                except EngineInvariantError as e:
                    out["fault"] = str(e)
            continue
        if rank == 0:
            pre.reservation = reserved
        row = _commit(eng, pre, slot=None if rank == 0 else reserved[0])
        out["control"] = dict(row=row, slots=(occ.slot, reserved[0]), first=list(occ.tokens))
    dist.barrier()
    return out


def _heads_fault(model, rank):
    """Rank 1 commits rank 0's kv heads of the first rank's window: the
    committed requests' tokens on this rank."""
    from unittest import mock

    from accelerate_tpu_torch.models import llama as tl

    real = tl.kv_window_heads

    def other_heads(window, tp):
        n = window["k"].shape[3] // tp.size
        r = (tp.rank + 1) % tp.size
        return {w: t[:, :, :, r * n:(r + 1) * n] for w, t in window.items()}

    eng = _disagg_engine(model, "paged")
    with mock.patch.object(tl, "kv_window_heads", other_heads if rank == 1 else real):
        return [_commit(eng, eng.prefill_remote(p, max_new_tokens=NEW, pad_token_id=0, **kw))
                for p, kw in zip(PROMPTS, CASES)]


def _record_slots(eng):
    """Wrap the engine's admissions to record each occupant's slot."""
    slots = []
    for name in ("insert", "insert_prefilled"):
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, **k):
            occ = _fn(*a, **k)
            slots.append(occ.slot)
            return occ

        setattr(eng, name, wrapped)
    return slots


def _counters(srv):
    s = srv.engine.stats()
    return dict(inserted=s["inserted"], retired=s["retired"], steps=s["steps"],
                remote=s["remote_prefills"], programs=s["programs"])


def _serve(model, rank, params):
    """The tp server's runs: rank 0 submits, the other rank replays. Each
    run returns rank 0's tokens and every rank's counters and slots."""
    import torch.distributed as dist

    from accelerate_tpu_torch.engine import RemotePrefill
    from accelerate_tpu_torch.fleet import FleetRouter
    from accelerate_tpu_torch.kvtransfer import KVTransferManager
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import FleetConfig
    from accelerate_tpu_torch.utils.fault import (TransferStaleEpochError, install_conductor,
                                                  uninstall_conductor)

    out = {}

    def server():
        srv = InferenceServer(model, _server_config(), device="cpu")
        slots = _record_slots(srv.engine)
        dist.barrier()  # every rank records before rank 0 submits
        return srv, slots

    def submit_all(target, prefilled=None):
        futs = [target.submit(p, max_new_tokens=NEW, pad_token_id=0, **kw,
                              **({} if prefilled is None else {"prefilled": prefilled(p, kw)}))
                for p, kw in _traffic()]
        return [f.result(120).tokens.tolist() for f in futs]

    # (a) local prefill, then submit(prefilled=) of remote forwards run in
    # the decision stream
    srv, slots = server()
    if rank == 0:
        with srv:
            local = submit_all(srv)
            pres = [srv._prefill_in_stream(p, max_new_tokens=NEW, pad_token_id=0, **kw).result(120)
                    for p, kw in _traffic()]
            it = iter(pres)
            prefilled = submit_all(srv, lambda p, kw: next(it))
            fallbacks = srv.metrics["prefill_commit_fallbacks"]
            # a mesh's window decodes and commits on a one-process engine
            data = srv._prefill_in_stream(PROMPTS[1], max_new_tokens=NEW, pad_token_id=0,
                                          **CASES[1]).result(120).to_bytes()
        one = _disagg_engine(_one_model(params), "paged")
        to_one = (_commit(one, RemotePrefill.from_bytes(data, engine=one)),
                  _run(one, PROMPTS[1], **CASES[1]))
        out["submit"] = dict(local=local, prefilled=prefilled, fallbacks=fallbacks, to_one=to_one)
    else:
        srv.close()
        out["submit"] = {}
    out["submit"].update(counters=_counters(srv), slots=slots)

    # (b) the fleet: remote prefill in the replica's decision stream, by
    # reference and over the in-process wire
    for name, kv in (("fleet", None), ("fleet_wire", "inproc")):
        srv, slots = server()
        if rank == 0:
            router = FleetRouter({"m": srv}, FleetConfig(disaggregate_prefill=True,
                                                         prefill_workers=1, kv_transfer=kv))
            try:
                tokens = submit_all(router)
                m = router.metrics
                fallbacks = {k: m[f"prefill_fallback/{k}"] for k in (
                    "unavailable", "stale_epoch", "transfer_failed") if m[f"prefill_fallback/{k}"]}
                out[name] = dict(tokens=tokens, prefills=m["prefills"], transfers=m["kv_transfers"],
                                 fallbacks=fallbacks)
            finally:
                router.close()
        else:
            srv.close()
            out[name] = {}
        out[name].update(counters=_counters(srv), slots=slots)

    # (c) the wire: a one-process engine's prefills shipped to the server
    srv, slots = server()
    if rank == 0:
        tx = _disagg_engine(_one_model(params), "paged", slots=1)
        res = {}
        with srv:
            for transport in ("inproc", "tcp"):
                mgr = KVTransferManager(transport=transport, chunk_bytes=4096)
                try:
                    mgr.register("rx", srv)

                    def shipped(p, kw):
                        pre = tx.prefill_remote(p, max_new_tokens=NEW, pad_token_id=0, **kw)
                        return mgr.take("rx", mgr.ship(pre, "rx"))

                    res[transport] = submit_all(srv, shipped)
                finally:
                    mgr.close()
            mgr = KVTransferManager(transport="inproc", chunk_bytes=4096)
            try:
                recv = mgr.register("rx", srv)
                busy = [srv.submit(p, max_new_tokens=NEW, pad_token_id=0, **kw)
                        for p, kw in _traffic()[:2]]

                def release_at_commit(name, context):
                    if name == "kvtx.commit":
                        st = recv._inflight[context["transfer"]]
                        srv.engine.release_reservation(st.slot, st.epoch)

                install_conductor(release_at_commit)
                try:
                    mgr.ship(tx.prefill_remote(PROMPTS[0], max_new_tokens=NEW), "rx")
                    res["stale"] = None
                except TransferStaleEpochError as e:
                    res["stale"] = type(e).__name__
                finally:
                    uninstall_conductor(release_at_commit)
                res["busy"] = [f.result(120).tokens.tolist() for f in busy]
            finally:
                mgr.close()
            res["fallbacks"] = srv.metrics["prefill_commit_fallbacks"]
        out["wire"] = res
    else:
        srv.close()
        out["wire"] = {}
    out["wire"].update(counters=_counters(srv), slots=slots)

    # (d) the host tier and prefetch through the server: the tier
    # scenario's prompt, churn that evicts it, the prompt again
    srv = InferenceServer(model, _tier_server_config(), device="cpu")
    slots = _record_slots(srv.engine)
    dist.barrier()
    if rank == 0:
        with srv:
            out["tier"] = dict(tokens=_serve_tier(srv))
    else:
        srv.close()
        out["tier"] = {}
    out["tier"].update(counters=_counters(srv), slots=slots, restores=srv.engine.kv_restores,
                       hits=srv.engine.stats()["kv"]["restore_hits"])
    return out


def _tier_server_config():
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    return ServingConfig(mode="continuous", engine_slots=2, engine_max_len=64,
                         engine_prompt_bucket=16, engine_block_size=8, engine_pool_blocks=8,
                         engine_prefill_chunk=16, kv_cache="paged", attention_impl="kernel",
                         kv_host_tier_bytes=8 << 20, kv_prefetch=True)


def _serve_tier(srv):
    """The tier scenario through a server (one request at a time, as the
    engine scenario admits them): every request's tokens."""
    prompt = _long_prompt()
    churn = [np.random.default_rng(9_000 + 200 + i).integers(1, 255, size=12).astype(np.int32)
             for i in range(8)]
    rows = []
    for p, new in ((prompt, 4), *((c, 2) for c in churn), (prompt, 4)):
        rows.append(srv.submit(p, max_new_tokens=new, pad_token_id=0).result(120).tokens.tolist())
    return rows


def _layout_body(params, pcfg, name):
    """One launch per layout: the tier (greedy on both pools, sampled, lost
    spills), the in-process commits, the planted faults; ``tp`` also the
    server, the fleet and the wire."""
    import torch.distributed as dist

    from accelerate_tpu_torch.accelerator import Accelerator

    torch.set_num_threads(1)  # up to four ranks share the host's cores
    Accelerator(cpu=True)
    rank = dist.get_rank()
    model = _mesh_model(params, pcfg)
    out = {"tier": {b: _tier_scenario(_tier_engine(model, b)) for b in TIER_BACKENDS},
           "tier_sampled": _tier_scenario(_tier_engine(model, "paged"), **SAMPLED),
           "lost": _lost_spills(model, rank),
           "disagg": _disagg(model),
           "slot_fault": _slot_fault(model, rank),
           "heads_fault": _heads_fault(model, rank)}
    if name == "tp":
        out["serve"] = _serve(model, rank, params)
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
    """The JAX engine over each of its meshes: the tier scenario on each
    pool, and (first mesh) the remote prefill windows."""
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
        for backend in TIER_BACKENDS:
            out[name, backend] = _tier_scenario(JEngine(model, kv_cache=backend, **TIER_SHAPE))
        if name == "tp2_dp_shard4":
            eng = JEngine(model, kv_cache="paged", **DISAGG_KW)
            pres = [eng.prefill_remote(p, max_new_tokens=NEW, pad_token_id=0, **kw)
                    for p, kw in zip(PROMPTS, CASES)]
            out["windows"] = [{w: np.asarray(t) for w, t in pre.cache.items()} for pre in pres]
            out["split"] = [_commit(eng, pre) for pre in pres]
    return out


@pytest.fixture(scope="module")
def runs(jax_params, tmp_path_factory):
    """Every layout's per-rank results, one launch per layout, and the one
    process's."""
    import time

    tmp = tmp_path_factory.mktemp("tp_kvtier")
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
@pytest.mark.parametrize("name,backend", [(n, b) for n in LAYOUTS for b in TIER_BACKENDS])
def test_tier_greedy_tokens_and_counters_equal_the_jax_engine_over_its_meshes(
        runs, jax_runs, name, backend, jax_layout):
    want = jax_runs[jax_layout, backend]
    assert want["kv_restores"] == 1 and want["spill_blocks"] > 0 and want["restore_hits"] > 0
    for r, res in enumerate(runs[name]):
        got = res["tier"][backend]
        assert got["restore_sig"], f"rank {r}: no ('restore', 8) program"
        for key in ("first", "second", "kv_restores", *TIER_COUNTERS, "programs"):
            assert got[key] == want[key], f"rank {r} {key}: {got[key]} != {want[key]}"
        assert got["second"] == got["first"]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_tier_sampled_tokens_equal_the_one_process_port(runs, name):
    want = runs["one"]["tier_sampled"]
    assert want["kv_restores"] == 1
    for r, res in enumerate(runs[name]):
        got = res["tier_sampled"]
        assert (got["first"], got["second"], got["kv_restores"]) == (
            want["first"], want["second"], want["kv_restores"]), f"rank {r}"
    for backend in TIER_BACKENDS:  # the one process's greedy counters are the mesh's too
        for key in ("kv_restores", *TIER_COUNTERS):
            assert runs[name][0]["tier"][backend][key] == runs["one"]["tier"][backend][key]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_spills_lost_on_one_rank_restore_the_same_blocks_on_every_rank(runs, name):
    ranks = runs[name]
    lost = [res["lost"] for res in ranks]
    # rank 1 held a shorter chain than the others, and every rank restored
    # rank 1's: the same restores, hits and tokens everywhere
    assert lost[1]["local_chain"][-1] < lost[0]["local_chain"][-1], [x["local_chain"] for x in lost]
    assert lost[1]["spill_blocks"] < lost[0]["spill_blocks"]  # lost before the tier saw them
    assert lost[1]["host_tier_blocks"] < lost[0]["host_tier_blocks"]
    for r, res in enumerate(lost):
        assert res["kv_restores"] == lost[0]["kv_restores"] == 1, f"rank {r}"
        assert res["restore_hits"] == lost[1]["local_chain"][-1] > 0, f"rank {r}"
        assert (res["first"], res["second"]) == (lost[0]["first"], lost[0]["second"]), f"rank {r}"
    assert lost[0]["second"] == runs["one"]["tier"]["paged"]["second"]


@pytest.mark.parametrize("name,backend", [(n, b) for n in LAYOUTS for b in COMMIT_BACKENDS])
def test_remote_prefill_commits_bitwise_insert_and_its_window_is_whole(runs, jax_runs, name,
                                                                         backend):
    one = runs["one"]["disagg"][backend]
    for r, res in enumerate(runs[name]):
        got = res["disagg"][backend]
        assert got["split"] == got["plain"] == one["plain"], f"rank {r}"
        assert got["programs"] == one["programs"], f"rank {r}"
        for mine, whole, jax_win in zip(got["windows"], one["windows"], jax_runs["windows"]):
            for w in ("k", "v"):
                assert mine[w].shape == whole[w].shape == (2, 1, 32, 2, 16)
                np.testing.assert_allclose(mine[w], whole[w], rtol=0, atol=LOGIT_ATOL,
                                           err_msg=f"rank {r} {w}")
                np.testing.assert_allclose(mine[w], jax_win[w], rtol=0, atol=LOGIT_ATOL,
                                           err_msg=f"rank {r} {w} against JAX")
    greedy = [0]
    assert [runs[name][0]["disagg"][backend]["split"][i] for i in greedy] == [
        jax_runs["split"][i] for i in greedy]


def test_submit_prefilled_over_tp_returns_the_one_process_servers_tokens(runs):
    first, other = (res["serve"]["submit"] for res in runs["tp"])
    want = runs["one"]["server"]
    assert first["local"] == first["prefilled"] == want
    assert first["fallbacks"] == 0
    assert first["counters"] == other["counters"] and first["slots"] == other["slots"]
    assert first["counters"]["remote"] == len(_traffic()) + 1
    assert first["counters"]["programs"] == {"prefill_insert": 1, "decode_step": 1,
                                             "prefill_forward": 1, "prefill_commit": 1}
    # the mesh's bytes commit on one process as its own insert
    assert first["to_one"][0] == first["to_one"][1] == runs["one"]["disagg"]["paged"]["plain"][1]


@pytest.mark.parametrize("run", ["fleet", "fleet_wire"])
def test_fleet_disaggregates_onto_the_mesh_replica(runs, run):
    first, other = (res["serve"][run] for res in runs["tp"])
    assert first["tokens"] == runs["one"]["server"]
    assert first["prefills"] == len(_traffic()) and not first["fallbacks"], first
    assert first["transfers"] == (len(_traffic()) if run == "fleet_wire" else 0)
    assert first["counters"] == other["counters"] and first["slots"] == other["slots"]
    assert first["counters"]["programs"] == {"decode_step": 1, "prefill_forward": 1,
                                             "prefill_commit": 1}


def test_the_wire_to_the_tp_server_gives_its_local_prefills_tokens(runs):
    first, other = (res["serve"]["wire"] for res in runs["tp"])
    want = runs["tp"][0]["serve"]["submit"]["local"]
    assert first["inproc"] == first["tcp"] == want
    assert first["fallbacks"] == 0
    assert first["stale"] == "TransferStaleEpochError"
    assert first["busy"] == want[:2]
    assert first["counters"] == other["counters"] and first["slots"] == other["slots"]


def test_the_tp_server_with_a_host_tier_and_prefetch_restores_on_every_rank(runs):
    first, other = (res["serve"]["tier"] for res in runs["tp"])
    assert first["tokens"] == runs["one"]["tier_server"]
    assert first["tokens"][-1] == first["tokens"][0]
    # rank 0 prefetched at submit, rank 1 copied at admission: one restore each
    assert first["restores"] == other["restores"] == 1 and first["hits"] == other["hits"] > 0
    assert first["counters"] == other["counters"] and first["slots"] == other["slots"]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_a_rank_taking_another_slot_than_the_named_one_raises(runs, name):
    ranks = runs[name]
    control = [res["slot_fault"]["control"] for res in ranks]
    for r, c in enumerate(control):
        assert c == control[0], f"rank {r}"
    assert control[0]["slots"][0] != control[0]["slots"][1]
    assert control[0]["row"] == runs["one"]["server"][1]  # P1 greedy
    fault = ranks[1]["slot_fault"]["fault"]
    assert fault is not None and "is not free" in fault, fault
    assert ranks[0]["slot_fault"]["fault"] is None


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_committing_the_other_ranks_heads_is_caught_by_the_tokens(runs, name):
    want = runs["one"]["disagg"]["paged"]["plain"]
    for r, res in enumerate(runs[name]):
        assert res["heads_fault"] != want, f"rank {r}: the planted fault went unseen"
