"""The port's KV transfer wire (``kvtransfer.py``) against the JAX
package's: frames and acks byte for byte, the codec's round trips over the
port's tensors, typed deaths of corrupt payloads and frames, and shipped
prefills that commit to bitwise the tokens of a local prefill, over the
in-process oracle and TCP loopback, at ``LlamaConfig.tiny`` size in f32.
"""

import json
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu import kvtransfer as jkvtx
from accelerate_tpu.engine import ContinuousBatchingEngine as JEngine
from accelerate_tpu.models.llama import LlamaConfig as JConfig
from accelerate_tpu.models.llama import create_llama
from accelerate_tpu.utils import fault as jfault
from accelerate_tpu_torch import kvtransfer as kvtx
from accelerate_tpu_torch.engine import ContinuousBatchingEngine, RemotePrefill
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM, params_from_jax
from accelerate_tpu_torch.utils.fault import (
    TransferAbortedError,
    TransferCorruptError,
    TransferStaleEpochError,
)

KW = dict(slots=2, max_len=32, prompt_bucket=8, readback_lag=2, block_size=8)
PROMPT = np.asarray([11, 2, 9, 4, 6, 1], np.int32)


@pytest.fixture(scope="module")
def models():
    jmodel = create_llama(JConfig.tiny(compute_dtype=jnp.float32, attention_impl="flash"), seed=0)
    tcfg = LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    params = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jmodel.params), device="cpu")
    return jmodel, LlamaForCausalLM(tcfg, params)


def _engine(tmodel, **kw):
    return ContinuousBatchingEngine(tmodel, device="cpu", **{**KW, "kv_cache": "paged", **kw})


def _prefill(eng, prompt=PROMPT, **kw):
    return eng.prefill_remote(prompt, max_new_tokens=5, pad_token_id=0, **kw)


def _commit(eng, pre):
    occ = eng.insert_prefilled(pre)
    eng.drain()
    return occ.output_row()


def _ok(ack):
    return kvtx._raise_on_error_ack(ack)


# ------------------------------------------------------------------ frames
FRAMES = [(kvtx._FRAME_BEGIN, "kvtx-1", json.dumps({"wire_version": 1, "n_chunks": 2}).encode()),
          (kvtx._FRAME_CHUNK, "kvtx-1-r2", kvtx._U32.pack(1) + kvtx._U32.pack(77) + bytes(range(40))),
          (kvtx._FRAME_COMMIT, "t" * 255, kvtx._U32.pack(0xDEADBEEF)),
          (kvtx._FRAME_ABORT, "", b"{}"), (9, "é", b"")]
ACKS = [(True, None), (True, {"transfer": "x"}),
        (False, {"error": "TransferStaleEpochError", "message": "stale", "transfer": "x"}),
        (False, {"error": "TransferCorruptError", "message": "crc"}), (False, {"error": "Other"})]


@pytest.mark.parametrize("i", range(len(FRAMES)))
def test_frames_are_bitwise_jax(i):
    frame = FRAMES[i]
    packed = kvtx._pack_frame(*frame)
    assert packed == jkvtx._pack_frame(*frame)
    assert kvtx._parse_frame(packed) == jkvtx._parse_frame(packed)
    for short in (b"", b"\x01", b"\x01\x05ab"):
        with pytest.raises(TransferCorruptError, match="short frame"):
            kvtx._parse_frame(short)
        with pytest.raises(jfault.TransferCorruptError, match="short frame"):
            jkvtx._parse_frame(short)


@pytest.mark.parametrize("i", range(len(ACKS)))
def test_acks_are_bitwise_jax(i):
    ok, detail = ACKS[i]
    ack = kvtx._pack_ack(ok, detail)
    assert ack == jkvtx._pack_ack(ok, detail)
    if ok:
        assert _ok(ack) == jkvtx._raise_on_error_ack(ack) == (detail or {})
        return
    with pytest.raises(Exception) as ours:
        _ok(ack)
    with pytest.raises(Exception) as theirs:
        jkvtx._raise_on_error_ack(ack)
    assert type(ours.value).__name__ == type(theirs.value).__name__
    assert str(ours.value) == str(theirs.value)


def test_wire_constants_and_errors_match_jax():
    assert (kvtx._MAGIC, kvtx.WIRE_VERSION) == (jkvtx._MAGIC, jkvtx.WIRE_VERSION)
    assert [kvtx._FRAME_BEGIN, kvtx._FRAME_CHUNK, kvtx._FRAME_COMMIT, kvtx._FRAME_ABORT,
            kvtx._FRAME_ACK] == [jkvtx._FRAME_BEGIN, jkvtx._FRAME_CHUNK, jkvtx._FRAME_COMMIT,
                                 jkvtx._FRAME_ABORT, jkvtx._FRAME_ACK]
    assert sorted(kvtx._ERROR_TYPES) == sorted(jkvtx._ERROR_TYPES)
    for name in ("KVTransferError", "TransferAbortedError", "TransferStaleEpochError",
                 "TransferCorruptError"):
        ours = getattr(kvtx, name, None) or getattr(__import__(
            "accelerate_tpu_torch.utils.fault", fromlist=[name]), name)
        assert ours.retriable == getattr(jfault, name).retriable is True
        assert [c.__name__ for c in ours.__mro__[:3]] == [
            c.__name__ for c in getattr(jfault, name).__mro__[:3]]
    with pytest.raises(TransferCorruptError, match="too long"):
        kvtx._pack_frame(kvtx._FRAME_BEGIN, "x" * 256, b"")


# ------------------------------------------------------------------- codec
def _leaves(pre):
    return [pre.cache["k"], pre.cache["v"], pre.t0, pre.next_key, torch.from_numpy(pre.prompt)]


@pytest.mark.parametrize("kv_cache", ["dense", "paged", "paged_int8"])
def test_codec_roundtrip_is_bitwise(models, kv_cache):
    _, tmodel = models
    eng = _engine(tmodel, kv_cache=kv_cache)
    want = _commit(eng, _prefill(eng))
    pre = _prefill(eng, temperature=0.7, top_k=5, top_p=0.8, seed=3, eos_token_id=9)
    data = pre.to_bytes()
    assert data[:4] == b"ATKV"
    back = RemotePrefill.from_bytes(data, engine=eng)
    assert back.engine_config is eng.config and back.reservation is None
    for name in ("max_new_tokens", "temperature", "top_k", "top_p", "eos_token_id", "pad_token_id",
                 "seed", "prompt_bucket", "max_len"):
        assert getattr(back, name) == getattr(pre, name)
    for a, b in zip(_leaves(pre), _leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert RemotePrefill.from_bytes(data).engine_config is None  # no engine: no stamp check
    np.testing.assert_array_equal(_commit(eng, RemotePrefill.from_bytes(_prefill(eng).to_bytes(),
                                                                        engine=eng)), want)


def test_bf16_leaves_roundtrip():
    t = torch.randn(3, 5).to(torch.bfloat16)
    leaves = []
    tree = kvtx._flatten({"a": t, "b": [torch.arange(3, dtype=torch.int8)], "c": None, "d": 2}, leaves)
    data = b"".join(kvtx._leaf_bytes(x) for x in leaves)
    assert len(data) == 3 * 5 * 2 + 3
    back = kvtx._unflatten(json.loads(json.dumps(tree)), leaves)
    assert torch.equal(back["a"], t) and back["c"] is None and back["d"] == 2


def test_corrupt_payloads_die_typed(models):
    jmodel, tmodel = models
    eng = _engine(tmodel)
    data = _prefill(eng, prompt=np.asarray([7, 7, 7], np.int32)).to_bytes()
    with pytest.raises(TransferCorruptError, match="magic"):
        RemotePrefill.from_bytes(b"NOPE" + data[4:])
    with pytest.raises(TransferCorruptError, match="version"):
        RemotePrefill.from_bytes(data[:4] + b"\x00\x63" + data[6:])
    with pytest.raises(TransferCorruptError, match="truncated"):
        RemotePrefill.from_bytes(data[:-8])
    with pytest.raises(TransferCorruptError, match="trailing"):
        RemotePrefill.from_bytes(data + b"\x00")
    with pytest.raises(TransferCorruptError, match="meta"):
        RemotePrefill.from_bytes(data[:10] + b"\xff" + data[11:])
    # the structural stamp: another bucket, or a KV window of another shape
    alien = types.SimpleNamespace(prompt_bucket=999, max_len=7, config=eng.config, device=eng.device)
    with pytest.raises(TransferAbortedError, match="stamp mismatch"):
        RemotePrefill.from_bytes(data, engine=alien)
    wide = ContinuousBatchingEngine(LlamaForCausalLM.from_seed(
        LlamaConfig.tiny(compute_dtype=torch.float32, num_hidden_layers=3), device="cpu"),
        device="cpu", **{**KW, "kv_cache": "paged"})
    with pytest.raises(TransferAbortedError, match="stamp mismatch"):
        RemotePrefill.from_bytes(data, engine=wide)
    # a payload the JAX package encoded: its leaves are not the port's
    jeng = JEngine(jmodel, **{**KW, "kv_cache": "paged"})
    jdata = jkvtx.encode_remote_prefill(jeng.prefill_remote([7, 7, 7], max_new_tokens=5, pad_token_id=0))
    assert jdata[:10] == data[:4] + data[4:6] + jdata[6:10]  # the same magic and version
    with pytest.raises(TransferCorruptError, match="leaf_format"):
        RemotePrefill.from_bytes(jdata, engine=eng)


# -------------------------------------------------------------------- wire
@pytest.mark.parametrize("transport", ["inproc", "tcp"])
def test_shipped_prefill_commits_bitwise_a_local_one(models, transport):
    _, tmodel = models
    tx, rx = _engine(tmodel), _engine(tmodel)
    want = _commit(rx, _prefill(rx))
    local = rx.insert(PROMPT, max_new_tokens=5, pad_token_id=0)
    rx.drain()
    np.testing.assert_array_equal(local.output_row(), want)
    mgr = kvtx.KVTransferManager(transport=transport, chunk_bytes=1024)
    try:
        recv = mgr.register("rx", types.SimpleNamespace(engine=rx))
        frames = []
        feed = recv.feed
        recv.feed = lambda frame, conn_id=None: (frames.append(frame), feed(frame, conn_id))[1]
        pre = _prefill(tx)
        tid = mgr.ship(pre, "rx", trace_id="trace-kvtx-hop")
        wire = mgr.take("rx", tid)
        assert wire.engine_config is rx.config and wire.reservation is not None
        assert rx.accepts_prefill(wire) and rx.free_slots() == 1  # the reservation holds a slot
        np.testing.assert_array_equal(_commit(rx, wire), want)
        assert mgr.stats == {"shipped": 1, "retries": 0, "failed": 0, "stale": 0}
        begin = kvtx._parse_frame(frames[0])
        assert begin[0] == kvtx._FRAME_BEGIN and begin[1] == tid
        meta = json.loads(begin[2])
        assert meta["trace_id"] == "trace-kvtx-hop" and meta["n_chunks"] == len(frames) - 2
        assert recv.stats == {"begun": 1, "committed": 1, "aborted": 0, "corrupt": 0, "stale": 0}
        with pytest.raises(TransferAbortedError, match="no committed prefill"):
            mgr.take("rx", tid)
    finally:
        mgr.close()
    assert rx.free_slots() == 2
    # closing ends the listener's thread, which holds the receiving server
    import threading

    for t in [t for t in threading.enumerate() if t.name == "kvtx-listen-rx"]:
        t.join(timeout=10)
        assert not t.is_alive()


def _begin(recv, tid, payload, n_chunks=1):
    meta = {"wire_version": 1, "trace_id": None, "n_chunks": n_chunks, "total_bytes": len(payload),
            "payload_crc": kvtx._crc(payload), "prompt_len": 3, "prefix_crc": 0}
    _ok(recv.feed(kvtx._pack_frame(kvtx._FRAME_BEGIN, tid, json.dumps(meta).encode())))


def test_corrupt_chunk_and_unknown_transfer_die_typed(models):
    _, tmodel = models
    rx = _engine(tmodel)
    recv = kvtx.KVReceiver(types.SimpleNamespace(engine=rx))
    payload = _prefill(rx, prompt=np.asarray([9, 9, 2], np.int32)).to_bytes()
    _begin(recv, "t-corrupt", payload)
    assert rx.free_slots() == 1
    with pytest.raises(TransferCorruptError, match="crc32"):
        _ok(recv.feed(kvtx._pack_frame(kvtx._FRAME_CHUNK, "t-corrupt",
                                       kvtx._U32.pack(0) + kvtx._U32.pack(kvtx._crc(payload) ^ 1)
                                       + payload)))
    assert rx.free_slots() == 2 and recv.stats["corrupt"] == 1  # the reservation was released
    with pytest.raises(TransferAbortedError, match="unknown transfer"):
        _ok(recv.feed(kvtx._pack_frame(kvtx._FRAME_CHUNK, "t-never-began",
                                       kvtx._U32.pack(0) + kvtx._U32.pack(kvtx._crc(b"x")) + b"x")))
    _begin(recv, "t-dup", payload)
    with pytest.raises(TransferCorruptError, match="duplicate BEGIN"):
        _begin(recv, "t-dup", payload)
    with pytest.raises(TransferCorruptError, match="unknown frame type"):
        _ok(recv.feed(kvtx._pack_frame(9, "t-x", b"")))
    recv.close()
    assert rx.free_slots() == 2


def test_late_commit_after_the_reservation_was_reaped(models):
    # the reservation is reaped mid-stream and the slot given to a new
    # request: COMMIT raises the stale-epoch error, staging is freed, and
    # the new occupant's tokens are those of a clean run
    _, tmodel = models
    tx = _engine(tmodel)
    clock = [0.0]
    rx = ContinuousBatchingEngine(tmodel, device="cpu", clock=lambda: clock[0],
                                  **{**KW, "slots": 1, "kv_cache": "paged"})
    survivor = np.asarray([5, 3, 8], np.int32)
    clean = rx.insert(survivor, max_new_tokens=4, pad_token_id=0)
    rx.drain()
    recv = kvtx.KVReceiver(types.SimpleNamespace(engine=rx), reservation_ttl_s=1.0)
    payload = _prefill(tx).to_bytes()
    half = len(payload) // 2
    chunks = [payload[:half], payload[half:]]
    _begin(recv, "t-fence", payload, n_chunks=2)
    _ok(recv.feed(kvtx._pack_frame(kvtx._FRAME_CHUNK, "t-fence", kvtx._U32.pack(0)
                                   + kvtx._U32.pack(kvtx._crc(chunks[0])) + chunks[0])))
    assert rx.free_slots() == 0
    clock[0] = 2.0
    rx.poll()
    assert rx.free_slots() == 1
    occ = rx.insert(survivor, max_new_tokens=4, pad_token_id=0)
    _ok(recv.feed(kvtx._pack_frame(kvtx._FRAME_CHUNK, "t-fence", kvtx._U32.pack(1)
                                   + kvtx._U32.pack(kvtx._crc(chunks[1])) + chunks[1])))
    with pytest.raises(TransferStaleEpochError):
        _ok(recv.feed(kvtx._pack_frame(kvtx._FRAME_COMMIT, "t-fence",
                                       kvtx._U32.pack(kvtx._crc(payload)))))
    assert recv.stats["stale"] == 1 and recv.stats["committed"] == 0
    rx.drain()
    assert occ.tokens == clean.tokens and rx.free_slots() == 1
    kv = rx.stats()["kv"]
    assert kv["blocks_free"] + kv["blocks_cached"] + kv["blocks_active"] == kv["blocks_total"] - 1
    with pytest.raises(TransferAbortedError):
        recv.take("t-fence")


def test_released_reservation_raises_on_the_sender(models):
    _, tmodel = models
    tx, rx = _engine(tmodel), _engine(tmodel, slots=1)
    mgr = kvtx.KVTransferManager(transport="inproc", chunk_bytes=1024)
    try:
        mgr.register("rx", types.SimpleNamespace(engine=rx))
        wire = mgr.take("rx", mgr.ship(_prefill(tx), "rx"))
        assert rx.release_reservation(*wire.reservation)
        occ = rx.insert(np.asarray([5, 3, 8], np.int32), max_new_tokens=4, pad_token_id=0)
        assert not rx.accepts_prefill(wire)
        with pytest.raises(TransferStaleEpochError):
            rx.insert_prefilled(wire)
        rx.drain()
        assert len(occ.tokens) == 4 and rx.free_slots() == 1
        # released at COMMIT: the sender gets the typed error, unretried
        from accelerate_tpu_torch.utils.fault import install_conductor, uninstall_conductor

        recv = mgr._receiver_for("rx")

        def release(name, context):
            if name == "kvtx.commit":
                st = recv._inflight[context["transfer"]]
                rx.release_reservation(st.slot, st.epoch)

        install_conductor(release)
        try:
            with pytest.raises(TransferStaleEpochError):
                mgr.ship(_prefill(tx), "rx")
        finally:
            uninstall_conductor(release)
        assert mgr.stats["stale"] == 1 and mgr.stats["retries"] == 0 and rx.free_slots() == 1
    finally:
        mgr.close()


def test_transfer_faults_retry_then_die_typed(models, monkeypatch):
    _, tmodel = models
    tx, rx = _engine(tmodel), _engine(tmodel)
    mgr = kvtx.KVTransferManager(transport="inproc", chunk_bytes=1024, retries=1,
                                 sleep=lambda s: None)
    try:
        mgr.register("rx", types.SimpleNamespace(engine=rx))
        monkeypatch.setenv("ACCELERATE_TPU_FAULT_INJECT", "kvtx.send_chunk:raise")
        with pytest.raises(TransferAbortedError, match="died on sender"):
            mgr.ship(_prefill(tx), "rx")
        assert mgr.stats["retries"] == 1 and mgr.stats["failed"] == 1
        monkeypatch.setenv("ACCELERATE_TPU_FAULT_INJECT", "kvtx.receive:raise")
        with pytest.raises(TransferAbortedError):
            mgr.ship(_prefill(tx), "rx")
        assert rx.free_slots() == 2  # every failed attempt released its reservation
    finally:
        mgr.close()
    with pytest.raises(ValueError, match="unknown KV transport"):
        kvtx.KVTransferManager(transport="rdma")
