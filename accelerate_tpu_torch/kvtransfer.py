"""The KV transfer wire of disaggregated prefill (counterpart of
``accelerate_tpu/kvtransfer.py``): a :class:`~accelerate_tpu_torch.engine
.RemotePrefill` computed by one engine crosses a transport into another
engine's slot.

* **Transactional framing**: a transfer is ``BEGIN -> CHUNK* -> COMMIT``
  (or ``ABORT``), every frame acknowledged. Each chunk carries its crc32
  and COMMIT the whole payload's; the receiver assembles the chunks in
  host staging and publishes the prefill at COMMIT only, so a sender that
  dies mid-stream leaves the receiving pool untouched and the request
  falls back to a local prefill.
* **Epoch fence**: BEGIN reserves a slot on the receiving engine
  (:meth:`~accelerate_tpu_torch.engine.ContinuousBatchingEngine
  .reserve_slot`), a ``(slot, epoch)`` pair; the engine bumps a slot's
  epoch whenever the slot is freed, so a late or duplicate stream never
  lands in a recycled slot. COMMIT checks the epoch, and
  ``insert_prefilled`` checks it again, raising
  :class:`~accelerate_tpu_torch.utils.fault.TransferStaleEpochError`.
* **Typed failures**: every way a transfer dies is a
  :class:`TransferAbortedError`, a :class:`TransferStaleEpochError` or a
  :class:`TransferCorruptError`, all ``retriable``; an ACK names the
  class, and the sender raises the same class.
* **Two transports, one interface**: :class:`InProcTransport` (the same
  frames and state machine, no sockets) and :class:`TCPTransport`
  (length-prefixed frames over sockets, loopback here).

Wire format (integers big-endian), byte for byte the JAX package's::

    frame     := u32 length | u8 type | u8 tid_len | tid | body
    BEGIN(1)  body := meta JSON  {wire_version, trace_id, n_chunks,
                                  total_bytes, payload_crc, prompt_len,
                                  prefix_crc}
    CHUNK(2)  body := u32 idx | u32 crc32 | raw bytes
    COMMIT(3) body := u32 payload_crc
    ABORT(4)  body := reason JSON
    ACK(5)    body := u8 ok | detail JSON   (detail.error = the error
                                             class name when ok == 0)

The payload is :func:`encode_remote_prefill`'s encoding, ``b"ATKV" | u16
version | u32 meta_len | meta JSON | raw leaf bytes``, with the JAX
package's magic, version and layout; its leaves are this package's
tensors (``leaf_format`` ``"torch"`` in the meta, each leaf's torch dtype
name and shape), so a payload the JAX package wrote, or one from an engine
of another shape, is refused with a typed error. The receiver rebinds
``engine_config`` to its own after checking the structural stamp (prompt
bucket, ``max_len`` and the KV window's shape and dtype).

Fault points (``ACCELERATE_TPU_FAULT_INJECT``): ``kvtx.send_chunk``
(sender, before each chunk), ``kvtx.receive`` (receiver, before folding an
arrived frame) and ``kvtx.commit`` (receiver, at COMMIT, before the
checks and the publish).
"""

from __future__ import annotations

import itertools
import json
import socket
import struct
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import tracing
from .utils.fault import (
    EngineCapacityError,
    FaultInjected,
    KVTransferError,
    TransferAbortedError,
    TransferCorruptError,
    TransferStaleEpochError,
    fault_point,
)

__all__ = [
    "encode_remote_prefill",
    "decode_remote_prefill",
    "KVReceiver",
    "KVTransferManager",
    "InProcTransport",
    "TCPTransport",
    "WIRE_VERSION",
]

WIRE_VERSION = 1
_MAGIC = b"ATKV"
_LEAF_FORMAT = "torch"

_FRAME_BEGIN = 1
_FRAME_CHUNK = 2
_FRAME_COMMIT = 3
_FRAME_ABORT = 4
_FRAME_ACK = 5

_U32 = struct.Struct(">I")
_U16 = struct.Struct(">H")

# an ACK names the error class; the sender raises the same one
_ERROR_TYPES = {
    "TransferAbortedError": TransferAbortedError,
    "TransferStaleEpochError": TransferStaleEpochError,
    "TransferCorruptError": TransferCorruptError,
}

# the leaf dtypes a payload may carry, by torch name
_DTYPES = {str(d).split(".")[-1]: d for d in (
    torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.int32, torch.int64)}


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


# ===================================================================== codec
def _flatten(tree: Any, leaves: List[torch.Tensor]) -> Any:
    """A payload tree (dicts, lists, tuples, tensors, scalars) as a JSON
    template plus its ordered leaves: a tensor becomes ``{"__leaf__": i}``
    (a host copy, contiguous), a dict ordered pairs."""
    if tree is None:
        return {"__none__": True}
    if isinstance(tree, dict):
        return {"__dict__": [[k, _flatten(v, leaves)] for k, v in tree.items()]}
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return {"__seq__": kind, "items": [_flatten(v, leaves) for v in tree]}
    if isinstance(tree, (bool, int, float, str)):
        return {"__py__": tree}
    t = torch.as_tensor(tree).detach().cpu().contiguous()
    if str(t.dtype).split(".")[-1] not in _DTYPES:
        raise TransferCorruptError(f"cannot encode a {t.dtype} leaf")
    leaves.append(t)
    return {"__leaf__": len(leaves) - 1}


def _unflatten(node: Any, leaves: List[torch.Tensor]) -> Any:
    if "__none__" in node:
        return None
    if "__dict__" in node:
        return {k: _unflatten(v, leaves) for k, v in node["__dict__"]}
    if "__seq__" in node:
        items = [_unflatten(v, leaves) for v in node["items"]]
        return items if node["__seq__"] == "list" else tuple(items)
    if "__py__" in node:
        return node["__py__"]
    return leaves[node["__leaf__"]]


def _leaf_bytes(t: torch.Tensor) -> bytes:
    return t.reshape(-1).view(torch.uint8).numpy().tobytes()


def encode_remote_prefill(pre) -> bytes:
    """The versioned wire encoding of a :class:`~accelerate_tpu_torch
    .engine.RemotePrefill` (the module docstring). Every leaf ships its
    dtype and raw bytes, so decoding on an engine of the same shape and
    committing gives the same KV bytes, first token and generator seed as
    the prefill handed over in one process. Waits for the prefill's
    forward first (its ``event``)."""
    if getattr(pre, "event", None) is not None:
        pre.event.synchronize()
    leaves: List[torch.Tensor] = []
    tree = _flatten({"prompt": torch.from_numpy(np.asarray(pre.prompt, dtype=np.int32)),
                     "cache": pre.cache, "t0": pre.t0, "next_key": pre.next_key}, leaves)
    meta = {
        "leaf_format": _LEAF_FORMAT,
        "tree": tree,
        "leaves": [{"dtype": str(t.dtype).split(".")[-1], "shape": list(t.shape)} for t in leaves],
        "max_new_tokens": int(pre.max_new_tokens),
        "temperature": float(pre.temperature),
        "top_k": pre.top_k,
        "top_p": pre.top_p,
        "eos_token_id": pre.eos_token_id,
        "pad_token_id": pre.pad_token_id,
        "seed": int(pre.seed),
        "prompt_bucket": int(pre.prompt_bucket),
        "max_len": int(pre.max_len),
    }
    meta_bytes = json.dumps(meta, separators=(",", ":")).encode()
    parts = [_MAGIC, _U16.pack(WIRE_VERSION), _U32.pack(len(meta_bytes)), meta_bytes]
    parts.extend(_leaf_bytes(t) for t in leaves)
    return b"".join(parts)


def _check_stamp(meta: dict, tree: dict, engine) -> None:
    """Raise :class:`TransferAbortedError` unless the prefill was computed
    for ``engine``'s shape: prompt bucket, ``max_len``, and the KV window
    (L, 1, max_len, kv heads, head_dim) in the compute dtype."""
    cfg = engine.config
    want = (cfg.num_hidden_layers, 1, engine.max_len, cfg.num_key_value_heads, cfg.head_dim)
    cache = tree.get("cache")
    got = ({w: (tuple(t.shape), t.dtype) for w, t in cache.items() if isinstance(t, torch.Tensor)}
           if isinstance(cache, dict) else None)
    if (meta["prompt_bucket"] != engine.prompt_bucket or meta["max_len"] != engine.max_len
            or got != {w: (want, cfg.compute_dtype) for w in ("k", "v")}):
        raise TransferAbortedError(
            f"RemotePrefill structural stamp mismatch: computed for bucket={meta['prompt_bucket']}/"
            f"max_len={meta['max_len']} with a KV window {got}, the receiver is bucket="
            f"{engine.prompt_bucket}/max_len={engine.max_len} with {want} in {cfg.compute_dtype}; "
            "recompute locally")


def decode_remote_prefill(data: bytes, *, engine=None):
    """Decode an :func:`encode_remote_prefill` payload into a
    :class:`~accelerate_tpu_torch.engine.RemotePrefill`. ``engine`` (the
    receiving one) checks the structural stamp (a mismatch is a
    :class:`TransferAbortedError`: the request is recomputed locally),
    rebinds ``engine_config`` to its own and takes the leaves to its
    device. A payload that is not this package's encoding dies as a
    :class:`TransferCorruptError`."""
    from .engine import RemotePrefill

    if len(data) < 10 or data[:4] != _MAGIC:
        raise TransferCorruptError("RemotePrefill payload is not ATKV-framed (bad magic)")
    (version,) = _U16.unpack_from(data, 4)
    if version != WIRE_VERSION:
        raise TransferCorruptError(
            f"RemotePrefill wire version {version} unsupported (this build speaks v{WIRE_VERSION})")
    (meta_len,) = _U32.unpack_from(data, 6)
    try:
        meta = json.loads(data[10: 10 + meta_len].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise TransferCorruptError(f"RemotePrefill meta header unparseable: {exc}") from exc
    if not isinstance(meta, dict) or meta.get("leaf_format") != _LEAF_FORMAT:
        raise TransferCorruptError(
            "RemotePrefill payload's leaves are not this package's tensors (leaf_format "
            f"{meta.get('leaf_format') if isinstance(meta, dict) else None!r}); it cannot commit here")
    try:
        leaves: List[torch.Tensor] = []
        offset = 10 + meta_len
        for desc in meta["leaves"]:
            dtype = _DTYPES.get(desc["dtype"])
            if dtype is None:
                raise TransferCorruptError(f"RemotePrefill leaf dtype {desc['dtype']!r} unsupported")
            shape = tuple(int(d) for d in desc["shape"])
            nbytes = dtype.itemsize * int(np.prod(shape, dtype=np.int64))
            if offset + nbytes > len(data):
                raise TransferCorruptError(
                    "RemotePrefill payload truncated mid-leaf "
                    f"(need {nbytes} bytes at offset {offset}, have {len(data)})")
            raw = np.frombuffer(data, dtype=np.uint8, count=nbytes, offset=offset).copy()
            leaves.append(torch.from_numpy(raw).view(dtype).reshape(shape))
            offset += nbytes
        if offset != len(data):
            raise TransferCorruptError(f"RemotePrefill payload has {len(data) - offset} trailing bytes")
        tree = _unflatten(meta["tree"], leaves)
        fields = {k: meta[k] for k in ("max_new_tokens", "temperature", "top_k", "top_p",
                                       "eos_token_id", "pad_token_id", "seed", "prompt_bucket",
                                       "max_len")}
        prompt = tree["prompt"].numpy()
        cache, t0, next_key = tree["cache"], tree["t0"], tree["next_key"]
    except (KeyError, TypeError, ValueError, IndexError, RuntimeError) as exc:
        raise TransferCorruptError(
            f"RemotePrefill payload malformed: {type(exc).__name__}: {exc}") from exc
    engine_config = event = None
    if engine is not None:
        _check_stamp(meta, tree, engine)
        engine_config = engine.config
        dev = engine.device
        cache = {w: t.to(dev) for w, t in cache.items()}
        t0 = t0.to(dev)
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
    return RemotePrefill(prompt=prompt, cache=cache, t0=t0, next_key=next_key,
                         engine_config=engine_config, event=event, **fields)


# ==================================================================== frames
def _pack_frame(ftype: int, tid: str, body: bytes) -> bytes:
    tid_b = tid.encode()
    if len(tid_b) > 255:
        raise TransferCorruptError(f"transfer id too long ({len(tid_b)} bytes)")
    return bytes([ftype, len(tid_b)]) + tid_b + body


def _parse_frame(frame: bytes) -> Tuple[int, str, bytes]:
    if len(frame) < 2:
        raise TransferCorruptError("short frame (no type/tid header)")
    ftype, tid_len = frame[0], frame[1]
    if len(frame) < 2 + tid_len:
        raise TransferCorruptError("short frame (truncated transfer id)")
    tid = frame[2 : 2 + tid_len].decode(errors="replace")
    return ftype, tid, frame[2 + tid_len :]


def _pack_ack(ok: bool, detail: Optional[dict] = None) -> bytes:
    body = bytes([1 if ok else 0]) + json.dumps(
        detail or {}, separators=(",", ":")
    ).encode()
    return _pack_frame(_FRAME_ACK, "", body)


def _raise_on_error_ack(ack: bytes) -> dict:
    """Parse an ACK frame; re-raise the receiver's typed error locally
    when ok=0. Returns the detail dict on success."""
    ftype, _tid, body = _parse_frame(ack)
    if ftype != _FRAME_ACK or not body:
        raise TransferCorruptError("peer response is not an ACK frame")
    ok = body[0] == 1
    try:
        detail = json.loads(body[1:].decode() or "{}")
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise TransferCorruptError(f"ACK detail unparseable: {exc}") from exc
    if ok:
        return detail
    cls = _ERROR_TYPES.get(detail.get("error"), TransferAbortedError)
    raise cls(detail.get("message", "transfer failed on receiver"))


# ================================================================== receiver
class _TransferState:
    __slots__ = ("meta", "chunks", "slot", "epoch", "conn_id", "started_s")

    def __init__(self, meta: dict, slot: int, epoch: int,
                 conn_id: Optional[int], started_s: float):
        self.meta = meta
        self.chunks: Dict[int, bytes] = {}
        self.slot = slot
        self.epoch = epoch
        self.conn_id = conn_id
        self.started_s = started_s


class KVReceiver:
    """Receiving half of the transfer protocol, bound to one decode
    replica. :meth:`feed` is the transport-agnostic state machine: both
    the in-process oracle and the TCP handler threads push raw frames
    through it and relay the ACK bytes it returns. Committed prefills
    wait in a completion table until :meth:`take` hands them to the
    caller that will ``submit(prefilled=...)`` them.

    Thread-safety: ``feed`` may be called from any transport thread. The
    receiver's own lock guards only its staging/completion tables and is
    never held across engine calls (the engine's admission lock is a
    separate leaf lock — no ordering edge between the two)."""

    def __init__(self, server, *, clock: Callable[[], float] = time.monotonic,
                 reservation_ttl_s: float = 30.0):
        self._server = server
        self._engine = server.engine
        if self._engine is None:
            raise TransferAbortedError(
                "KV transfer requires a continuous-mode replica "
                "(no slot engine to reserve against)"
            )
        self._clock = clock
        self._ttl = float(reservation_ttl_s)
        self._lock = threading.Lock()
        self._inflight: Dict[str, _TransferState] = {}
        self._completed: Dict[str, Any] = {}
        self.stats: Dict[str, int] = {
            "begun": 0, "committed": 0, "aborted": 0, "corrupt": 0,
            "stale": 0,
        }

    # ------------------------------------------------------------ frame pump
    def feed(self, frame: bytes, conn_id: Optional[int] = None) -> bytes:
        """Fold one arrived frame into staging; returns the ACK bytes to
        relay to the sender. Never raises: every failure — injected,
        corrupt, or capacity — cleans up the transfer's staging +
        reservation and reports a taxonomy class name in the ACK."""
        tid = ""
        try:
            ftype, tid, body = _parse_frame(frame)
            fault_point("kvtx.receive", transfer=tid, frame=ftype)
            if ftype == _FRAME_BEGIN:
                self._begin(tid, body, conn_id)
            elif ftype == _FRAME_CHUNK:
                self._chunk(tid, body)
            elif ftype == _FRAME_COMMIT:
                self._commit(tid, body)
            elif ftype == _FRAME_ABORT:
                self._fail(tid, "aborted")
            else:
                raise TransferCorruptError(f"unknown frame type {ftype}")
            return _pack_ack(True, {"transfer": tid})
        except KVTransferError as exc:
            self._fail(tid, self._bucket(exc))
            return _pack_ack(
                False, {"error": type(exc).__name__, "message": str(exc),
                        "transfer": tid},
            )
        except Exception as exc:  # noqa: BLE001 — typed at the wire boundary
            # FaultInjected (kill-mid-stream chaos) and programmer errors
            # both land here: the transfer dies typed, the receiver lives.
            self._fail(tid, "aborted")
            return _pack_ack(
                False,
                {"error": "TransferAbortedError",
                 "message": f"{type(exc).__name__}: {exc}", "transfer": tid},
            )

    @staticmethod
    def _bucket(exc: KVTransferError) -> str:
        if isinstance(exc, TransferStaleEpochError):
            return "stale"
        if isinstance(exc, TransferCorruptError):
            return "corrupt"
        return "aborted"

    # --------------------------------------------------------- frame handlers
    def _begin(self, tid: str, body: bytes, conn_id: Optional[int]) -> None:
        try:
            meta = json.loads(body.decode())
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            raise TransferCorruptError(f"BEGIN meta unparseable: {exc}") from exc
        if meta.get("wire_version") != WIRE_VERSION:
            raise TransferCorruptError(
                f"wire version {meta.get('wire_version')} unsupported "
                f"(receiver speaks v{WIRE_VERSION})"
            )
        with self._lock:
            duplicate = tid in self._inflight or tid in self._completed
        if duplicate:
            raise TransferCorruptError(
                f"duplicate BEGIN for transfer {tid} — replays must use a "
                "fresh transfer id"
            )
        try:
            slot, epoch = self._engine.reserve_slot(ttl_s=self._ttl)
        except EngineCapacityError as exc:
            raise TransferAbortedError(
                f"receiver has no free slot for transfer {tid}: {exc}"
            ) from exc
        with self._lock:
            self._inflight[tid] = _TransferState(
                meta, slot, epoch, conn_id, self._clock()
            )
            self.stats["begun"] += 1

    def _chunk(self, tid: str, body: bytes) -> None:
        if len(body) < 8:
            raise TransferCorruptError(f"short CHUNK frame for {tid}")
        (idx,) = _U32.unpack_from(body, 0)
        (crc,) = _U32.unpack_from(body, 4)
        data = body[8:]
        with self._lock:
            st = self._inflight.get(tid)
        if st is None:
            raise TransferAbortedError(
                f"CHUNK for unknown transfer {tid} (BEGIN missing or "
                "already failed)"
            )
        if idx >= st.meta["n_chunks"]:
            raise TransferCorruptError(
                f"chunk index {idx} out of range for {tid} "
                f"(n_chunks={st.meta['n_chunks']})"
            )
        if _crc(data) != crc:
            raise TransferCorruptError(
                f"chunk {idx} of {tid} failed crc32 verification"
            )
        with self._lock:
            st.chunks[idx] = data

    def _commit(self, tid: str, body: bytes) -> None:
        fault_point("kvtx.commit", transfer=tid)
        if len(body) < 4:
            raise TransferCorruptError(f"short COMMIT frame for {tid}")
        (commit_crc,) = _U32.unpack_from(body, 0)
        with self._lock:
            st = self._inflight.get(tid)
        if st is None:
            raise TransferAbortedError(
                f"COMMIT for unknown transfer {tid} (BEGIN missing or "
                "already failed)"
            )
        n = st.meta["n_chunks"]
        if len(st.chunks) != n:
            raise TransferAbortedError(
                f"COMMIT for {tid} with {len(st.chunks)}/{n} chunks staged"
            )
        payload = b"".join(st.chunks[i] for i in range(n))
        crc = _crc(payload)
        if crc != commit_crc or crc != st.meta["payload_crc"]:
            raise TransferCorruptError(
                f"payload crc mismatch at COMMIT for {tid}"
            )
        # Epoch fence, receiver side: the slot we reserved at BEGIN may
        # have been reclaimed (TTL reaper, engine reset) while chunks were
        # in flight. insert_prefilled re-checks authoritatively; fencing
        # here too means the sender learns *before* it reports success.
        if self._engine.slot_epoch(st.slot) != st.epoch:
            raise TransferStaleEpochError(
                f"transfer {tid} lost its slot reservation mid-stream "
                f"(slot {st.slot} epoch advanced past {st.epoch}) — "
                "fall back to a local prefill, do not replay"
            )
        pre = decode_remote_prefill(payload, engine=self._engine)
        pre.reservation = (st.slot, st.epoch)
        with self._lock:
            self._inflight.pop(tid, None)
            self._completed[tid] = pre
            self.stats["committed"] += 1

    def _fail(self, tid: str, bucket: str) -> None:
        """Discard a transfer's staging and release its slot reservation.
        Idempotent: a transfer already failed/committed is a no-op."""
        if not tid:
            return
        with self._lock:
            st = self._inflight.pop(tid, None)
            if st is not None:
                self.stats[bucket] = self.stats.get(bucket, 0) + 1
        if st is not None:
            # outside the receiver lock: engine admission lock is a leaf
            self._engine.release_reservation(st.slot, st.epoch)

    def fail_connection(self, conn_id: int) -> None:
        """A transport connection died: fail every transfer it had begun
        but not committed (crash-mid-stream semantics)."""
        with self._lock:
            dead = [t for t, s in self._inflight.items() if s.conn_id == conn_id]
        for tid in dead:
            self._fail(tid, "aborted")

    # ------------------------------------------------------------- delivery
    def take(self, tid: str):
        """Pop a committed transfer's reconstructed ``RemotePrefill``.
        Raises :class:`TransferAbortedError` when the transfer never
        committed (or was already taken)."""
        with self._lock:
            pre = self._completed.pop(tid, None)
        if pre is None:
            raise TransferAbortedError(
                f"transfer {tid} has no committed prefill to take"
            )
        return pre

    def close(self) -> None:
        with self._lock:
            dead = list(self._inflight)
        for tid in dead:
            self._fail(tid, "aborted")


# ================================================================ transports
class InProcTransport:
    """Zero-copy oracle transport: frames go straight into the target
    receiver's :meth:`KVReceiver.feed` on the sender's thread. Exercises
    the exact framing/state machine the socket path uses — the bitwise
    parity baseline every wire transport is judged against."""

    name = "inproc"

    def __init__(self, resolve: Callable[[Any], KVReceiver]):
        self._resolve = resolve

    def serve(self, replica_id: str, receiver: KVReceiver) -> Tuple[str, Any]:
        return ("inproc", replica_id)

    def stop(self, replica_id: str) -> None:
        pass

    def connect(self, endpoint: Tuple[str, Any], deadline_s: float):
        return _InProcConn(self._resolve(endpoint[1]))

    def close(self) -> None:
        pass


class _InProcConn:
    def __init__(self, receiver: KVReceiver):
        self._receiver = receiver
        self._conn_id = id(self)

    def roundtrip(self, frame: bytes) -> bytes:
        return self._receiver.feed(frame, conn_id=self._conn_id)

    def close(self) -> None:
        pass


class TCPTransport:
    """Length-prefixed loopback/LAN socket transport: each frame and each
    ACK is ``u32 length | bytes``. One listener per registered replica;
    one handler thread per accepted connection. A connection that drops
    before COMMIT fails its in-flight transfers (staging freed, slot
    reservation released) — the sender sees a timeout or reset and
    retries with a fresh transfer id."""

    name = "tcp"

    def __init__(self, host: str = "127.0.0.1"):
        self._host = host
        self._lock = threading.Lock()
        self._servers: Dict[str, socket.socket] = {}
        self._conn_ids = itertools.count(1)

    def serve(self, replica_id: str, receiver: KVReceiver) -> Tuple[str, Any]:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind((self._host, 0))
        sock.listen(16)
        with self._lock:
            self._servers[replica_id] = sock
        t = threading.Thread(
            target=self._accept_loop, args=(sock, receiver),
            name=f"kvtx-listen-{replica_id}", daemon=True,
        )
        t.start()
        return ("tcp", sock.getsockname())

    def stop(self, replica_id: str) -> None:
        with self._lock:
            sock = self._servers.pop(replica_id, None)
        if sock is not None:
            # closing alone does not wake a thread blocked in accept(), which
            # would hold the receiver (and its server and model) for ever;
            # shutting the listener down does, and the loop exits on OSError
            for end in (lambda: sock.shutdown(socket.SHUT_RDWR), sock.close):
                try:
                    end()
                except OSError:
                    pass

    def close(self) -> None:
        with self._lock:
            ids = list(self._servers)
        for rid in ids:
            self.stop(rid)

    def connect(self, endpoint: Tuple[str, Any], deadline_s: float):
        try:
            sock = socket.create_connection(
                tuple(endpoint[1]), timeout=deadline_s
            )
        except OSError as exc:
            raise TransferAbortedError(
                f"cannot connect to KV receiver at {endpoint[1]}: {exc}"
            ) from exc
        return _TCPConn(sock, deadline_s)

    # -------------------------------------------------------- receiver side
    def _accept_loop(self, sock: socket.socket, receiver: KVReceiver) -> None:
        while True:
            try:
                conn, _addr = sock.accept()
            except OSError:
                return  # listener closed — replica unregistered
            t = threading.Thread(
                target=self._handle, args=(conn, receiver, next(self._conn_ids)),
                name="kvtx-conn", daemon=True,
            )
            t.start()

    def _handle(self, conn: socket.socket, receiver: KVReceiver,
                conn_id: int) -> None:
        try:
            while True:
                frame = _recv_framed(conn)
                if frame is None:
                    return  # orderly EOF
                ack = receiver.feed(frame, conn_id=conn_id)
                conn.sendall(_U32.pack(len(ack)) + ack)
        except OSError:
            return  # peer reset — fail_connection below cleans up
        finally:
            receiver.fail_connection(conn_id)
            try:
                conn.close()
            except OSError:
                pass


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            return None
        buf.extend(part)
    return bytes(buf)


def _recv_framed(sock: socket.socket) -> Optional[bytes]:
    header = _recv_exact(sock, 4)
    if header is None:
        return None
    (length,) = _U32.unpack(header)
    if length == 0 or length > (1 << 30):
        raise OSError(f"insane frame length {length}")
    return _recv_exact(sock, length)


class _TCPConn:
    def __init__(self, sock: socket.socket, deadline_s: float):
        self._sock = sock
        self._deadline_s = deadline_s
        sock.settimeout(deadline_s)

    def roundtrip(self, frame: bytes) -> bytes:
        try:
            self._sock.sendall(_U32.pack(len(frame)) + frame)
            ack = _recv_framed(self._sock)
        except socket.timeout as exc:
            raise TransferAbortedError(
                f"ACK deadline ({self._deadline_s}s) passed — receiver "
                "hung or network stalled"
            ) from exc
        except OSError as exc:
            raise TransferAbortedError(
                f"connection lost mid-transfer: {exc}"
            ) from exc
        if ack is None:
            raise TransferAbortedError(
                "connection closed by receiver before ACK"
            )
        return ack

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


# =================================================================== manager
class KVTransferManager:
    """Sender-side orchestrator + receiver registry for one fleet.

    ``register``/``unregister`` bind decode replicas to the chosen
    transport (starting/stopping TCP listeners as needed); :meth:`ship`
    runs the transactional send with per-chunk fault injection and
    deadline, exponential backoff, and the fleet's shared token-bucket
    retry budget — a transfer storm cannot inject unbounded extra work
    into surviving replicas. A stale-epoch verdict is terminal by
    design: that transfer id's slot is gone, so the caller must fall
    back to a local prefill rather than replay."""

    def __init__(
        self,
        *,
        transport: str = "inproc",
        chunk_bytes: int = 65536,
        chunk_deadline_s: float = 2.0,
        retries: int = 2,
        backoff_s: float = 0.05,
        budget=None,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        on_retry: Optional[Callable[[], None]] = None,
    ):
        if transport == "inproc":
            self._transport = InProcTransport(self._receiver_for)
        elif transport == "tcp":
            self._transport = TCPTransport()
        else:
            raise ValueError(
                f"unknown KV transport {transport!r} (want 'inproc' or 'tcp')"
            )
        self.transport_name = transport
        self._chunk_bytes = int(chunk_bytes)
        self._chunk_deadline_s = float(chunk_deadline_s)
        self._retries = int(retries)
        self._backoff_s = float(backoff_s)
        self._budget = budget
        self._clock = clock
        self._sleep = sleep
        self._on_retry = on_retry
        self._lock = threading.Lock()
        self._receivers: Dict[str, KVReceiver] = {}
        self._endpoints: Dict[str, Tuple[str, Any]] = {}
        self._seq = itertools.count(1)
        self.stats: Dict[str, int] = {
            "shipped": 0, "retries": 0, "failed": 0, "stale": 0,
        }

    # ------------------------------------------------------------- registry
    def register(self, replica_id: str, server) -> KVReceiver:
        receiver = KVReceiver(server, clock=self._clock)
        endpoint = self._transport.serve(replica_id, receiver)
        with self._lock:
            self._receivers[replica_id] = receiver
            self._endpoints[replica_id] = endpoint
        return receiver

    def unregister(self, replica_id: str) -> None:
        with self._lock:
            receiver = self._receivers.pop(replica_id, None)
            self._endpoints.pop(replica_id, None)
        self._transport.stop(replica_id)
        if receiver is not None:
            receiver.close()

    def close(self) -> None:
        with self._lock:
            ids = list(self._receivers)
        for rid in ids:
            self.unregister(rid)
        self._transport.close()

    def _receiver_for(self, replica_id: str) -> KVReceiver:
        with self._lock:
            receiver = self._receivers.get(replica_id)
        if receiver is None:
            raise TransferAbortedError(
                f"no KV receiver registered for replica {replica_id}"
            )
        return receiver

    def _endpoint_for(self, replica_id: str) -> Tuple[str, Any]:
        with self._lock:
            endpoint = self._endpoints.get(replica_id)
        if endpoint is None:
            raise TransferAbortedError(
                f"no KV endpoint registered for replica {replica_id}"
            )
        return endpoint

    # ----------------------------------------------------------------- send
    def ship(self, pre, replica_id: str, *,
             trace_id: Optional[str] = None) -> str:
        """Ship one :class:`~accelerate_tpu_torch.engine.RemotePrefill` to
        ``replica_id``'s receiver; returns the transfer id to :meth:`take`
        the rebuilt prefill under. ``trace_id`` rides BEGIN's meta and
        names the ``kvtx.send`` span the attempts run in.
        Raises the error that ended the transfer once retries or the
        budget are spent, and :class:`TransferStaleEpochError` at once,
        never retried."""
        payload = encode_remote_prefill(pre)
        payload_crc = _crc(payload)
        step = max(1, self._chunk_bytes)
        chunks = [payload[i: i + step] for i in range(0, len(payload), step)] or [b""]
        base = f"kvtx-{next(self._seq)}"
        delay = self._backoff_s
        attempt = 0
        with tracing.span("kvtx.send", trace_id=trace_id, replica=replica_id, transfer=base,
                          bytes=len(payload), chunks=len(chunks),
                          transport=self.transport_name) as sp:
            while True:
                # a fresh id per attempt: a half-dead earlier attempt may still
                # hold the receiver's staging under its id, and a duplicate
                # BEGIN is refused
                tid = base if attempt == 0 else f"{base}-r{attempt}"
                try:
                    self._attempt(replica_id, tid, trace_id, chunks, payload_crc, len(payload), pre)
                    self.stats["shipped"] += 1
                    sp.set("attempts", attempt + 1)
                    return tid
                except TransferStaleEpochError:
                    self.stats["stale"] += 1
                    raise
                except (KVTransferError, FaultInjected, OSError) as exc:
                    typed = exc if isinstance(exc, KVTransferError) else TransferAbortedError(
                        f"transfer {tid} died on sender: {type(exc).__name__}: {exc}")
                    attempt += 1
                    if attempt > self._retries or (
                            self._budget is not None and not self._budget.try_acquire()):
                        self.stats["failed"] += 1
                        raise typed from exc
                    self.stats["retries"] += 1
                    if self._on_retry is not None:
                        self._on_retry()
                    self._sleep(delay)
                    delay *= 2.0

    def _attempt(self, replica_id: str, tid: str, trace_id: Optional[str],
                 chunks: List[bytes], payload_crc: int, total_bytes: int,
                 pre) -> None:
        meta = {
            "wire_version": WIRE_VERSION,
            "trace_id": trace_id,
            "n_chunks": len(chunks),
            "total_bytes": total_bytes,
            "payload_crc": payload_crc,
            "prompt_len": int(np.asarray(pre.prompt).shape[0]),
            "prefix_crc": _crc(
                np.ascontiguousarray(
                    np.asarray(pre.prompt, dtype=np.int32)
                ).tobytes()
            ),
        }
        conn = self._transport.connect(
            self._endpoint_for(replica_id), self._chunk_deadline_s
        )
        try:
            _raise_on_error_ack(conn.roundtrip(_pack_frame(
                _FRAME_BEGIN, tid,
                json.dumps(meta, separators=(",", ":")).encode(),
            )))
            for i, data in enumerate(chunks):
                fault_point("kvtx.send_chunk", transfer=tid, chunk=i)
                _raise_on_error_ack(conn.roundtrip(_pack_frame(
                    _FRAME_CHUNK, tid,
                    _U32.pack(i) + _U32.pack(_crc(data)) + data,
                )))
            _raise_on_error_ack(conn.roundtrip(_pack_frame(
                _FRAME_COMMIT, tid, _U32.pack(payload_crc),
            )))
        except BaseException:
            # best-effort prompt cleanup so the receiver's slot
            # reservation frees NOW instead of at TTL expiry; the reaper
            # remains the backstop when the connection itself is dead
            try:
                conn.roundtrip(_pack_frame(
                    _FRAME_ABORT, tid,
                    json.dumps({"reason": "sender abort"}).encode(),
                ))
            except Exception:  # noqa: BLE001 — abort is advisory
                pass
            raise
        finally:
            conn.close()

    # ------------------------------------------------------------- delivery
    def take(self, replica_id: str, tid: str):
        """The committed prefill on the receiving side (both halves live in
        one process here, so the hand-off is a table pop)."""
        return self._receiver_for(replica_id).take(tid)
