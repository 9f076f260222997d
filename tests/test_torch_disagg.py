"""Disaggregated prefill in the port (``prefill_remote``,
``insert_prefilled``, the slot-epoch reservations, ``submit(prefilled=)``)
against the JAX package at ``LlamaConfig.tiny`` size in float32, the
prefix-registry digest, the launch counts of a capture beside another
thread's launches, and the refusals over a mesh.

Exact comparisons: the split path is held bitwise to :meth:`insert`
(greedy and sampled, the same generator draws), greedy tokens are argmaxes
of logits that agree with JAX's to ~1e-5, far from any tie at this size.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu_torch.engine import ContinuousBatchingEngine, RemotePrefill
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.ops import _build
from accelerate_tpu_torch.serving import InferenceServer
from accelerate_tpu_torch.utils.dataclasses import ServingConfig
from accelerate_tpu_torch.utils.fault import (
    EngineCapacityError,
    KVTransferError,
    TransferStaleEpochError,
)

KW = dict(slots=2, max_len=32, prompt_bucket=8, readback_lag=2, block_size=8)
PROMPTS = [np.asarray([3, 1, 4, 1, 5], np.int32), np.asarray([11, 2, 9, 4, 6, 1, 7], np.int32)]
CASES = [dict(temperature=0.0), dict(temperature=0.8, top_k=40, top_p=0.9, seed=13)]


@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash"), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def _engine(tmodel, **kw):
    return ContinuousBatchingEngine(tmodel, device="cpu", **{**KW, **kw})


def _insert(eng, p, budget=6, **kw):
    occ = eng.insert(p, max_new_tokens=budget, pad_token_id=0, **kw)
    eng.drain()
    return occ.output_row()


def _commit(eng, pre, **kw):
    occ = eng.insert_prefilled(pre, **kw)
    eng.drain()
    return occ.output_row()


@pytest.mark.parametrize("kv_cache,impl", [("dense", "reference"), ("paged", "reference"),
                                           ("paged", "kernel"), ("paged_int8", "reference")])
def test_remote_prefill_is_bitwise_insert_and_jax(models, kv_cache, impl):
    jmodel, tmodel = models
    eng = _engine(tmodel, kv_cache=kv_cache, attention_impl=impl)
    for p, kw in zip(PROMPTS, CASES):
        want = _insert(eng, p, **kw)
        pre = eng.prefill_remote(p, max_new_tokens=6, pad_token_id=0, **kw)
        assert eng.accepts_prefill(pre) and pre.engine_config is eng.config
        assert pre.cache["k"].shape == (2, 1, 32, 2, 16)  # the max_len-wide window
        np.testing.assert_array_equal(_commit(eng, pre, tag="rp"), want)
    # a budget lowered at commit is a plain insert with that budget
    p, kw = PROMPTS[0], CASES[0]
    want3 = _insert(eng, p, budget=3, **kw)
    pre = eng.prefill_remote(p, max_new_tokens=6, pad_token_id=0, **kw)
    with pytest.raises(ValueError, match="cannot exceed"):
        eng.insert_prefilled(pre, max_new_tokens=7)
    np.testing.assert_array_equal(_commit(eng, pre, max_new_tokens=3), want3)
    stats = eng.stats()
    assert stats["remote_prefills"] == 3 and stats["programs"] == {
        "prefill_insert": 1, "decode_step": 1, "prefill_forward": 1, "prefill_commit": 1}
    # greedy tokens and the split path's programs equal the JAX engine's
    jeng = JEngine(jmodel, **{**KW, "kv_cache": kv_cache})
    jpre = jeng.prefill_remote(PROMPTS[0], max_new_tokens=6, pad_token_id=0)
    jrow = _commit(jeng, jpre)
    fresh = _engine(tmodel, kv_cache=kv_cache, attention_impl=impl)
    row = _commit(fresh, fresh.prefill_remote(PROMPTS[0], max_new_tokens=6, pad_token_id=0))
    np.testing.assert_array_equal(row, jrow)
    assert fresh.stats()["programs"] == jeng.stats()["programs"]
    assert fresh.stats()["remote_prefills"] == jeng.stats()["remote_prefills"] == 1


def test_remote_prefill_refusals(models):
    _, tmodel = models
    eng = _engine(tmodel, kv_cache="paged")
    with pytest.raises(ValueError, match="chunked"):
        _engine(tmodel, kv_cache="paged", prefill_chunk=8).prefill_remote(
            np.arange(1, 12, dtype=np.int32), max_new_tokens=4)
    with pytest.raises(ValueError, match="bucket"):  # past the bucket, without chunks
        eng.prefill_remote(np.arange(1, 12, dtype=np.int32), max_new_tokens=4)
    pre = eng.prefill_remote(PROMPTS[0], max_new_tokens=4)
    other = _engine(tmodel, kv_cache="paged", prompt_bucket=16)
    assert not other.accepts_prefill(pre)
    with pytest.raises(ValueError, match="not compatible"):
        other.insert_prefilled(pre)
    with pytest.raises(ValueError, match="not compatible"):
        eng.insert_prefilled(None)
    with pytest.raises(ValueError, match="cannot exceed"):
        eng.insert_prefilled(pre, max_new_tokens=5)
    # the refusals took no slot
    assert eng.free_slots() == 2 and other.free_slots() == 2


def test_reservation_lifecycle(models):
    _, tmodel = models
    clock = [0.0]
    eng = ContinuousBatchingEngine(tmodel, device="cpu", clock=lambda: clock[0],
                                   **{**KW, "kv_cache": "paged"})
    slot, epoch = eng.reserve_slot(ttl_s=1.0)
    assert eng.free_slots() == 1 and eng.slot_epoch(slot) == epoch
    assert eng.release_reservation(slot, epoch)
    assert not eng.release_reservation(slot, epoch)  # idempotent
    assert eng.free_slots() == 2 and eng.slot_epoch(slot) == epoch + 1
    # the TTL reaper (poll's backstop) gives an abandoned reservation back
    slot, epoch = eng.reserve_slot(ttl_s=1.0)
    clock[0] = 0.5
    eng.poll()
    assert eng.free_slots() == 1
    clock[0] = 2.0
    eng.poll()
    assert eng.free_slots() == 2 and eng.slot_epoch(slot) == epoch + 1
    # a committed reservation takes its slot; a stale one raises typed
    pre = eng.prefill_remote(PROMPTS[0], max_new_tokens=6, pad_token_id=0)
    pre.reservation = eng.reserve_slot()
    assert eng.accepts_prefill(pre)
    occ = eng.insert_prefilled(pre)
    assert occ.slot == pre.reservation[0]
    eng.drain()  # its retirement bumps the epoch again
    assert eng.slot_epoch(occ.slot) == pre.reservation[1] + 1
    stale = eng.prefill_remote(PROMPTS[1], max_new_tokens=6, pad_token_id=0)
    stale.reservation = eng.reserve_slot()
    assert eng.release_reservation(*stale.reservation)
    eng.insert(PROMPTS[0], max_new_tokens=4, pad_token_id=0)  # the slot is recycled
    assert not eng.accepts_prefill(stale)
    with pytest.raises(TransferStaleEpochError, match="stale"):
        eng.insert_prefilled(stale)
    assert isinstance(TransferStaleEpochError("x"), KVTransferError) and TransferStaleEpochError.retriable
    eng.drain()
    # reset fences every reservation
    slot, epoch = eng.reserve_slot()
    eng.reset()
    assert eng.free_slots() == 2 and eng.slot_epoch(slot) == epoch + 1
    assert not eng.release_reservation(slot, epoch)
    eng.reserve_slot()
    eng.reserve_slot()
    with pytest.raises(EngineCapacityError, match="reserve"):
        eng.reserve_slot()


def _server(tmodel, **kw):
    cfg = ServingConfig(mode="continuous", engine_slots=2, engine_max_len=32, engine_prompt_bucket=8,
                        engine_readback_lag=2, kv_cache="paged", engine_block_size=8, **kw)
    return InferenceServer(tmodel, cfg, device="cpu")


def test_server_commits_prefilled_and_falls_back(models):
    _, tmodel = models
    with _server(tmodel) as srv:
        eng = srv.engine
        plain = [srv.submit(p, max_new_tokens=6, pad_token_id=0, **kw).result(timeout=60)
                 for p, kw in zip(PROMPTS, CASES)]
        split = []
        for p, kw in zip(PROMPTS, CASES):
            pre = eng.prefill_remote(p, max_new_tokens=6, pad_token_id=0, **kw)
            split.append(srv.submit(p, max_new_tokens=6, pad_token_id=0, prefilled=pre, **kw)
                         .result(timeout=60))
        assert eng.stats()["programs"]["prefill_commit"] == 1
        inserted = eng.inserted
        # a stale reservation: the commit raises typed, the server counts a
        # fallback and runs the prompt forward itself
        pre = eng.prefill_remote(PROMPTS[0], max_new_tokens=6, pad_token_id=0)
        pre.reservation = eng.reserve_slot()
        real = eng.accepts_prefill
        eng.accepts_prefill = lambda p: True  # the race: the check passed, then it went stale
        try:
            eng.release_reservation(*pre.reservation)
            fell = srv.submit(PROMPTS[0], max_new_tokens=6, pad_token_id=0, prefilled=pre)
            fell = fell.result(timeout=60)
        finally:
            eng.accepts_prefill = real
        assert srv.metrics["prefill_commit_fallbacks"] == 1
        greedy1 = srv.submit(PROMPTS[1], max_new_tokens=6, pad_token_id=0).result(timeout=60)
        inserted = eng.inserted
        # a budget above the prefill's: not taken, its reservation released
        pre = eng.prefill_remote(PROMPTS[1], max_new_tokens=3, pad_token_id=0)
        pre.reservation = eng.reserve_slot()
        over = srv.submit(PROMPTS[1], max_new_tokens=6, pad_token_id=0, prefilled=pre).result(timeout=60)
        assert eng.inserted == inserted + 1 and eng.free_slots() == 2
        assert srv.metrics["prefill_commit_fallbacks"] == 1
    for a, b in zip(plain, split):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(fell.tokens, plain[0].tokens)
    np.testing.assert_array_equal(over.tokens, greedy1.tokens)
    with pytest.raises(ValueError, match="mode='continuous'"):
        with InferenceServer(tmodel, ServingConfig(), device="cpu") as static:
            static.submit(PROMPTS[0], prefilled=object())


def test_kv_prefix_digest_matches_jax(models):
    jmodel, tmodel = models
    prompts = [np.arange(1, 20, dtype=np.int32), np.arange(1, 12, dtype=np.int32),
               np.asarray([9] * 17, np.int32)]
    kw = dict(slots=2, max_len=64, prompt_bucket=32, readback_lag=2, kv_cache="paged", block_size=8)
    jeng = JEngine(jmodel, **kw)
    teng = ContinuousBatchingEngine(tmodel, device="cpu", **kw)
    for eng in (jeng, teng):
        for p in prompts:
            eng.insert(p, max_new_tokens=2, pad_token_id=0)
            eng.drain()
    digest = teng.kv_prefix_digest()
    assert digest == jeng.kv_prefix_digest() and len(digest["crcs"]) == 4
    assert teng.kv_prefix_digest(limit=2)["crcs"] == digest["crcs"][:2]
    dense = ContinuousBatchingEngine(tmodel, device="cpu", **{**kw, "kv_cache": "dense"})
    assert dense.kv_prefix_digest() == {"block_size": 0, "crcs": []}
    with _server(tmodel) as srv:
        assert srv.kv_prefix_digest() == {"block_size": 8, "crcs": []}
    with InferenceServer(tmodel, ServingConfig(), device="cpu") as static:
        assert static.kv_prefix_digest() is None


def test_capture_counts_only_its_own_thread():
    # a worker thread's launch during another thread's capture is not
    # booked into that capture, and stays in the totals
    _build.reset_launch_counts()
    started, go = threading.Event(), threading.Event()

    def worker():
        started.set()
        go.wait(timeout=10)
        _build.count_launch("flash_fwd_mma")

    t = threading.Thread(target=worker)
    t.start()
    started.wait(timeout=10)
    with _build.capture_launches() as captured:
        _build.count_launch("fused_sample")
        go.set()
        t.join(timeout=10)
        _build.count_launch("fused_sample")
    assert not t.is_alive()
    assert captured == {"fused_sample": 2}
    counts = _build.launch_counts()
    assert counts["flash_fwd_mma"] == 1 and counts["fused_sample"] == 0
    _build.add_launches(captured)  # a replay
    assert _build.launch_counts()["fused_sample"] == 2
    _build.reset_launch_counts()


def test_refusals_over_a_mesh_name_a3_bis(models, tmp_path):
    """A3-bis landed: on a one-rank mesh the host tier, ``prefill_remote``,
    ``reserve_slot`` and ``insert_prefilled`` run, and every request's
    tokens are the unsharded engine's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from accelerate_tpu_torch.big_modeling import dispatch_model
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules

    # a one-rank group of this test's own, unless one is running already
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    assert dist.get_world_size() == 1
    try:
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("dp_replicate", "dp_shard", "tp"))
        tiny = LlamaConfig.tiny(compute_dtype=torch.float32)
        laid = dispatch_model(LlamaForCausalLM.from_seed(tiny, device="cpu"), mesh=mesh,
                              rules=tensor_parallel_rules())

        def run(model):
            eng = ContinuousBatchingEngine(model, kv_cache="paged", host_tier_bytes=1 << 20,
                                           device="cpu", **KW)
            rows = [_insert(eng, p, **kw) for p, kw in zip(PROMPTS, CASES)]
            slot, epoch = eng.reserve_slot()
            assert eng.release_reservation(slot, epoch)
            for p, kw in zip(PROMPTS, CASES):
                pre = eng.prefill_remote(p, max_new_tokens=6, pad_token_id=0, **kw)
                assert pre.cache["k"].shape == (2, 1, 32, 2, 16)  # the whole window
                rows.append(_commit(eng, pre))
            assert eng.free_slots() == 2
            return rows, eng.stats()["programs"]

        got, want = run(laid), run(LlamaForCausalLM.from_seed(tiny, device="cpu"))
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got[0][2:], got[0][:2]):  # commits are inserts
            np.testing.assert_array_equal(a, b)
        assert got[1] == want[1]
    finally:
        if started:
            dist.destroy_process_group()
