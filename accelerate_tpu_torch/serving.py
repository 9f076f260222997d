"""Serving (counterpart of ``accelerate_tpu/serving.py``): static and
continuous modes (``ServingConfig.mode``).

One daemon worker thread owns dispatch, so any number of client threads
can ``submit`` while the device stream stays single-controller; ``submit``
only validates and enqueues.

* ``"static"`` (the default, as in the JAX package): admission-time
  batching of whole :func:`~accelerate_tpu_torch.inference.generate` calls.
  The worker takes the queue's head, gathers the requests behind it that
  share its group key (prompt length, token budget, sampling parameters,
  and the seed of sampled traffic) for up to ``batch_window_s``, pads the
  rows to a power of two and the KV length to a multiple of
  ``pad_total_multiple``, runs one ``generate`` and routes each row back.
  A failed batch is retried with exponential backoff and jitter
  (``max_retries``); a request's latency is its TTFT (the batch
  materialises at once). ``generate_fn`` replaces the executor.
* ``"continuous"``: admit queued requests into free engine slots (each
  admission runs the prompt forward, or the first chunk of a long prompt,
  or commits a prompt forward already run off the decode loop:
  ``submit(prefilled=)``), run one engine tick over every slot (pending
  chunks, then a decode or speculative verify step), read back the
  matured results, reply to retired requests, and shed requests past
  their deadline. ``kv_host_tier_bytes`` gives the engine a host-RAM KV
  tier, and ``kv_prefetch`` starts a request's host-tier copies at submit.

A model laid out over a mesh (``inference.prepare_inference(mesh=,
rules=)``) is served by one controller, as the JAX package's one process
serves it: every rank of the mesh builds the server, and the mesh's first
rank admits, schedules and retries requests (its results are the
unsharded server's), while every other rank replays its decisions, in
order, over a gloo group of the mesh's ranks, and a beat each second the
first rank waits for requests. Static mode sends each batch's rows and
``generate`` arguments before the batch runs. Continuous mode sends each
decision before it runs: an admission with the request's arguments and
seed, and each engine tick with the chunk and spec limits; either
carries the slots the first rank's clock cancelled since the last
decision (deadlines), which the others cancel first. Every rank thus
makes the same engine calls in the same order. A replaying rank never
reads its clock to decide, and the message of a tick overlaps the
device's work on the ticks before it, which nothing waits for.
``submit`` on another rank raises; ``close`` or ``drain`` there waits
until the first rank's ends them, or until the first rank has sent
nothing for ``drain_timeout_s`` beyond its longest quiet: it is then
taken as lost and the replaying server fails (:class:`ReplicaDeadError`).
In both modes a failure on one replaying rank alone leaves the first
rank inside a collective until the process group's own timeout.

Robustness that is ported: a bounded admission queue
(:class:`ServerOverloaded`), deadlines at admission, mid-decode and at
completion (:class:`RequestDeadlineExceeded`), graceful drain (in-flight
work finishes, queued requests get :class:`ServerDrainingError`), and a
failure failing only the requests it held (:class:`BatchExecutionError`).
Not ported yet (ROADMAP.md A10): the circuit breaker, the degradation
ladder, trackers and the metrics exporter.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ._device import resolve_device
from .logging import get_logger
from .utils.dataclasses import ServingConfig
from .utils.fault import (
    BatchExecutionError,
    KVTransferError,
    ReplicaDeadError,
    RequestDeadlineExceeded,
    ServerDrainingError,
    ServerOverloaded,
    fault_point,
)

logger = get_logger(__name__)

__all__ = ["InferenceServer", "ServingResult", "ServingMetrics", "resolve_future"]


@dataclass
class _Request:
    input_ids: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    deadline: Optional[float]  # absolute, server clock
    temperature: float
    top_k: Optional[int]
    top_p: Optional[float]
    eos_token_id: Optional[int]
    pad_token_id: Optional[int]
    seed: int
    submitted_at: float
    future: Future = field(default_factory=Future)
    # the token budget a static batch runs (set at dequeue; the degradation
    # ladder that would clamp it, and set ``degraded``, waits for A10)
    effective_max_new_tokens: int = 0
    degraded: bool = False
    # continuous: a prompt forward run off the decode loop (an
    # engine.RemotePrefill), committed at admission when the engine takes it
    prefill: object = None

    def group_key(self) -> tuple:
        """Requests sharing this key can ride one static ``generate()``
        batch: the shapes and the batch-uniform sampling operands. ``seed``
        joins only for sampled traffic: greedy decoding never reads it, and
        a sampled request's draws must come from its own seed."""
        return (
            self.input_ids.shape[-1],
            self.effective_max_new_tokens,
            self.temperature,
            self.top_k,
            self.top_p,
            self.eos_token_id,
            self.pad_token_id,
            self.seed if self.temperature > 0.0 else None,
        )


@dataclass
class ServingResult:
    """What a completed request's Future resolves to."""

    tokens: np.ndarray  # (prompt_len + max_new_tokens,) int32
    latency_s: float
    batch_size: int  # static: the batch's requests; continuous: slots live when it retired
    # continuous: submit -> first token read back; static: the latency (the
    # batch materialises at once)
    ttft_s: Optional[float] = None
    queue_wait_s: Optional[float] = None
    prefill_s: Optional[float] = None
    decode_steps: int = 0


def _engine_args(req: _Request) -> tuple:
    """What a replaying rank needs of an admitted request: its engine
    arguments (no future, no deadline)."""
    return (req.input_ids, req.max_new_tokens, req.temperature, req.top_k, req.top_p,
            req.eos_token_id, req.pad_token_id, req.seed)


def resolve_future(future: Future, *, result=None, exception: Optional[BaseException] = None) -> bool:
    """Resolve a client Future exactly once, tolerating a concurrent
    ``cancel()``. Returns True when this call delivered the outcome."""
    if future.done():
        return False
    try:
        if exception is not None:
            future.set_exception(exception)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


class ServingMetrics:
    """Thread-safe counters and recent latency samples (seconds)."""

    _COUNTERS = (
        "submitted", "completed", "rejected_queue_full", "rejected_draining",
        "shed_deadline", "completed_late", "retries", "batch_failures", "batches",
        "engine_inserts", "engine_steps", "engine_retired", "prefill_commit_fallbacks",
    )

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self._COUNTERS, 0)
        self.latency: collections.deque = collections.deque(maxlen=window)
        self.ttft: collections.deque = collections.deque(maxlen=window)

    def bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] += by

    def __getitem__(self, name: str) -> int:
        with self._lock:
            return self._counts[name]

    def add(self, latency_s: float, ttft_s: float) -> None:
        with self._lock:
            self.latency.append(latency_s)
            self.ttft.append(ttft_s)

    def snapshot(self) -> dict:
        with self._lock:
            out = {f"serving/{k}": v for k, v in self._counts.items()}
            for name, samples in (("latency", self.latency), ("ttft", self.ttft)):
                if samples:
                    arr = np.asarray(samples)
                    out[f"serving/{name}_p50_s"] = float(np.percentile(arr, 50))
                    out[f"serving/{name}_p99_s"] = float(np.percentile(arr, 99))
        return out


# the longest the mesh's first rank stays quiet while it waits for
# requests: it then sends a beat to the replaying ranks
_BEAT_S = 1.0


def _leader_lost_after(cfg: ServingConfig) -> float:
    """How long a replaying rank waits for the first rank's next message
    before it takes the first rank as lost: ``drain_timeout_s`` beyond the
    longest quiet the first rank keeps while alive (a beat interval, a
    batch window, a retry's backoff)."""
    return (cfg.drain_timeout_s + 2 * _BEAT_S + cfg.batch_window_s
            + cfg.retry_backoff_max_s * (1 + cfg.retry_jitter))


class _MeshControl:
    """The server's one controller over a mesh: the first rank broadcasts
    each batch (static: rows and ``generate`` arguments) or decision
    (continuous: an admission or a tick), a beat when it has been quiet for
    ``_BEAT_S``, and the stop, over a gloo group of the mesh's ranks whose
    timeout is ``lost_after_s``; the others receive them, and take the
    first rank as lost when nothing came in that time. ``seconds`` and
    ``messages`` count the host time the first rank spends sending (a
    replaying rank: receiving, which includes its wait for the first)."""

    def __init__(self, ranks: list, lost_after_s: float):
        import datetime

        import torch.distributed as dist

        if len(ranks) != dist.get_world_size():
            raise NotImplementedError(
                f"a server over a mesh of {len(ranks)} of the {dist.get_world_size()} "
                "processes: every process of the group must be a rank of the model's mesh")
        self.leader = ranks[0]
        self.size = len(ranks)
        self.rank = dist.get_rank()
        self.lost_after_s = lost_after_s
        self.group = dist.new_group(ranks, backend="gloo",
                                    timeout=datetime.timedelta(seconds=lost_after_s))
        self.last_sent = time.monotonic()
        self.seconds = 0.0
        self.messages = 0

    @property
    def is_leader(self) -> bool:
        return self.rank == self.leader

    def send(self, message) -> None:
        import torch.distributed as dist

        t0 = time.perf_counter()
        dist.broadcast_object_list([message], src=self.leader, group=self.group)
        self.seconds += time.perf_counter() - t0
        self.messages += 1
        self.last_sent = time.monotonic()

    def beat_due(self) -> bool:
        return time.monotonic() - self.last_sent >= _BEAT_S

    def receive(self):
        """The first rank's next message; raises :class:`ReplicaDeadError`
        when none came within ``lost_after_s``."""
        import torch.distributed as dist

        box = [None]
        t0 = time.perf_counter()
        try:
            dist.broadcast_object_list(box, src=self.leader, group=self.group)
        except Exception as e:  # noqa: BLE001 - gloo's timeout, or a closed peer
            raise ReplicaDeadError(
                f"rank {self.rank}: the mesh's first rank ({self.leader}) sent no message and "
                f"no beat for {self.lost_after_s:.1f}s ({type(e).__name__}); taken as lost, "
                "this rank stops replaying") from e
        self.seconds += time.perf_counter() - t0
        self.messages += 1
        return box[0]

    def stats(self) -> dict:
        return {"ranks": self.size, "leader": self.leader, "rank": self.rank,
                "messages": self.messages, "seconds": self.seconds}


class InferenceServer:
    """Static or continuous batching server (``config.mode``).

    ``model`` is a :class:`~accelerate_tpu_torch.models.llama
    .LlamaForCausalLM` on ``device`` (default ``"cuda"``; raises without a
    GPU). Static mode: ``generate_fn`` replaces the batch executor (the
    signature of :func:`~accelerate_tpu_torch.inference.generate`,
    returning ``(batch, prompt + new)`` tokens; ``None`` runs ``generate``,
    which needs the model's parameters on ``device``). Continuous mode:
    ``engine`` injects a pre-built
    :class:`~accelerate_tpu_torch.engine.ContinuousBatchingEngine` (tests),
    ``None`` builds one from the ``engine_*`` knobs; ``generate_fn`` is
    inert there, as the engine owns the device programs. Construction
    starts the worker; use it as a context manager or call :meth:`close`.

    Over a model laid out over a mesh, in either mode: every rank builds
    the server; the mesh's first rank serves, the others replay its
    batches or decisions (see the module docstring).
    """

    def __init__(self, model, config: Optional[ServingConfig] = None, *, generate_fn=None,
                 engine=None, device="cuda", clock: Callable[[], float] = time.monotonic):
        self.model = model
        self.config = config or ServingConfig()
        self._clock = clock
        self._generate_fn = generate_fn or self._default_generate
        self._control = None
        from .models.llama import mesh_ranks

        ranks = mesh_ranks(model)
        if ranks is not None and len(ranks) > 1:
            self._control = _MeshControl(ranks, _leader_lost_after(self.config))
        if self.config.mode == "static":
            engine = None
            dev = resolve_device(device)
            if generate_fn is None and ranks is None:  # over a mesh, each rank on its own card
                param = next(iter(model.parameters()), None)
                if param is not None and param.device != dev:
                    raise ValueError(
                        f"the model's parameters are on {param.device}, the server's device is "
                        f"{dev}: place the model there first (prepare_inference(model, device=...))")
        elif engine is None:
            from .engine import ContinuousBatchingEngine

            engine = ContinuousBatchingEngine(
                model,
                slots=self.config.engine_slots,
                max_len=self.config.engine_max_len,
                prompt_bucket=self.config.engine_prompt_bucket,
                readback_lag=self.config.engine_readback_lag,
                kv_cache=self.config.kv_cache,
                block_size=self.config.engine_block_size,
                pool_blocks=self.config.engine_pool_blocks,
                attention_impl=self.config.attention_impl,
                spec=self.config.speculative,
                spec_draft_len=self.config.spec_draft_len,
                prefill_chunk=self.config.engine_prefill_chunk,
                host_tier_bytes=self.config.kv_host_tier_bytes,
                device=device,
                clock=clock,
            )
        self._engine = engine
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._draining = False
        self._closed = False
        self._worker_error: Optional[BaseException] = None
        self._drained = threading.Event()
        self.metrics = ServingMetrics()
        self._batch_time_ewma = 0.0  # static: seconds a batch, for shedding at dequeue
        # continuous over a mesh: the slots cancelled since the last decision sent
        self._cancelled: list = []
        self._rng = random.Random(0)  # backoff jitter only
        self._worker = threading.Thread(target=self._serve_loop, name="inference-server", daemon=True)
        self._worker.start()

    @property
    def engine(self):
        """The continuous mode's slot engine (``None`` in static mode)."""
        return self._engine

    def stats(self) -> dict:
        """The engine's host counters (:meth:`~accelerate_tpu_torch.engine
        .ContinuousBatchingEngine.stats`), ``programs`` and
        ``program_count`` among them (continuous mode), with the server's
        counters under ``"serving"`` and, over a mesh, the controller's
        messages and the host seconds they took under ``"mesh"``."""
        engine = self._engine.stats() if self._engine is not None else {}
        out = {**engine, "serving": self.metrics.snapshot()}
        if self._control is not None:
            out["mesh"] = self._control.stats()
        return out

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def kv_prefix_digest(self) -> Optional[dict]:
        """The engine's prefix-registry digest
        (:meth:`~accelerate_tpu_torch.engine.ContinuousBatchingEngine
        .kv_prefix_digest`); None in static mode."""
        if self._engine is None:
            return None
        fn = getattr(self._engine, "kv_prefix_digest", None)
        return fn() if fn is not None else None

    # ------------------------------------------------------------ admission
    def submit(self, input_ids, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_token_id: Optional[int] = None, pad_token_id: Optional[int] = None,
               seed: int = 0, prefilled=None) -> Future:
        """Admit one request; returns a Future resolving to
        :class:`ServingResult` or raising the typed error that ended it.
        Raises at once (before queueing) when the server is draining, the
        queue is full, or the request cannot fit the engine.
        ``deadline_s`` is relative (``None``: ``config.default_deadline_s``);
        ``seed`` drives a sampled request's draws (``temperature > 0``).
        ``prefilled`` (continuous mode): the request's
        :class:`~accelerate_tpu_torch.engine.RemotePrefill`, committed at
        admission instead of running the prompt forward on the serving
        thread; a prefill the engine cannot take (another shape, a budget
        below the request's, a stale reservation) falls back to that
        forward. With ``config.kv_prefetch`` the request's host-tier
        blocks start their copies to the card here, on this thread.
        Over a mesh, only its first rank admits requests."""
        if self._control is not None and not self._control.is_leader:
            raise RuntimeError(
                f"submit on rank {self._control.rank}: the model is served over a mesh, whose "
                f"first rank ({self._control.leader}) admits every request; this rank replays "
                "its decisions")
        if self._closed or self._draining:
            self.metrics.bump("rejected_draining")
            raise ServerDrainingError(self._drain_reason(), retry_after_s=0.0)
        ids = np.asarray(input_ids, dtype=np.int32)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1 or ids.shape[0] == 0:
            raise ValueError(f"input_ids must be a non-empty 1-D prompt, got shape {ids.shape}")
        budget = max_new_tokens or self.config.default_max_new_tokens
        if prefilled is not None and self._engine is None:
            raise ValueError("prefilled= requires mode='continuous' (no slot engine to commit the "
                             "precomputed prefill into)")
        if prefilled is not None and self._control is not None:
            raise NotImplementedError(
                "submit(prefilled=) on a server over a mesh is queued in ROADMAP.md A3-bis")
        if self._engine is not None:
            self._engine.validate_request(ids.shape[0], budget)
            self._engine.validate_tokens(ids)
            if self.config.kv_prefetch:
                self._engine.prefetch(ids)
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        req = _Request(
            input_ids=ids, max_new_tokens=budget,
            deadline=(now + deadline_s) if deadline_s is not None else None,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=seed,
            submitted_at=now, prefill=prefilled,
        )
        with self._wake:
            if self._draining or self._closed:
                self.metrics.bump("rejected_draining")
                raise ServerDrainingError(self._drain_reason(), retry_after_s=0.0)
            if len(self._queue) >= self.config.max_queue:
                self.metrics.bump("rejected_queue_full")
                raise ServerOverloaded(
                    f"admission queue full ({self.config.max_queue}); back off and resubmit",
                )
            self._queue.append(req)
            self.metrics.bump("submitted")
            self._wake.notify()
        return req.future

    def generate(self, input_ids, *, timeout: Optional[float] = None, **kwargs) -> np.ndarray:
        """Blocking convenience: ``submit(...).result().tokens``."""
        return self.submit(input_ids, **kwargs).result(timeout=timeout).tokens

    # ------------------------------------------------------------ lifecycle
    def _drain_reason(self) -> str:
        if self._worker_error is not None:
            return (f"serving worker died ({type(self._worker_error).__name__}: "
                    f"{self._worker_error}); resubmit to another replica")
        return "server is draining; resubmit to another replica"

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission, let in-flight slots finish, reject everything
        still queued. True when the worker exited within ``timeout``
        (default ``config.drain_timeout_s``). On a rank that replays the
        first rank's batches, wait until the first rank's drain ends them,
        or until the first rank is taken as lost (``timeout`` None: however
        long that takes, at most a quiet of ``drain_timeout_s`` beyond the
        first rank's longest)."""
        if self._control is not None and not self._control.is_leader:
            return self._drained.wait(timeout)
        with self._wake:
            self._draining = True
            self._wake.notify_all()
        timeout = self.config.drain_timeout_s if timeout is None else timeout
        done = self._drained.wait(timeout)
        if not done:
            logger.warning("serving drain did not finish within %.1fs", timeout)
        return done

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Drain (or, with ``drain=False``, stop without waiting) and join
        the worker. Idempotent."""
        done = self.drain(timeout if drain else 0.0)
        self._closed = True
        if self._worker is not threading.current_thread():
            self._worker.join(timeout=self.config.drain_timeout_s)
        return done

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ---------------------------------------------------------- worker loop
    def _work_device(self):
        """The card this server's device work runs on: the engine's, or in
        static mode the model's parameters' (over a mesh, this rank's)."""
        if self._engine is not None:
            return self._engine.device
        params = getattr(self.model, "parameters", None)
        param = next(iter(params()), None) if callable(params) else None
        return None if param is None else param.device

    def _serve_loop(self) -> None:
        replaying = self._control is not None and not self._control.is_leader
        try:
            # a thread starts on the first card: over a mesh each rank works
            # on its own, and CUDA events and streams follow the current one
            device = self._work_device()
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            if self._engine is not None:
                self._loop_replay_continuous() if replaying else self._loop_continuous()
            elif replaying:
                self._loop_replay()
            else:
                self._loop_static()
        except BaseException as exc:  # a dead worker must not hang clients
            with self._lock:
                self._worker_error = exc
                self._draining = True
            logger.exception("serving worker died; failing in-flight and queued requests")
            raise
        finally:
            with self._lock:
                self._draining = True
            orphans = self._engine.occupants() if self._engine is not None else ()
            if self._engine is not None:
                try:
                    self._engine.reset()
                except Exception:  # noqa: BLE001 - the requests below must still be failed
                    logger.exception("could not reset the engine as the worker ended")
            for occ in orphans:
                resolve_future(occ.tag.future, exception=ReplicaDeadError(
                    "serving worker exited with this request still in a decode slot",
                ))
            self._reject_queued()
            if self._control is not None and self._control.is_leader:
                try:
                    self._control.send(("stop",))  # ends the replaying ranks' loops
                except Exception:  # noqa: BLE001 - a lost peer must not hang this drain
                    logger.exception("could not end the replaying ranks")
            self._drained.set()

    # ------------------------------------------------------ static batching
    def _loop_static(self) -> None:
        """Admission-time batching of whole ``generate()`` calls. Draining
        returns once the in-flight batch has replied; the finally rejects
        what is still queued."""
        control = self._control
        while True:
            with self._wake:
                while not self._queue and not self._draining:
                    if control is not None and control.beat_due():
                        break
                    self._wake.wait(timeout=0.05)
                if self._draining:
                    return
                idle = not self._queue
            if idle:  # over a mesh: tell the replaying ranks this rank is alive
                control.send(("beat",))
                continue
            batch = self._collect_batch()
            if batch:
                self._execute(batch)

    def _loop_replay(self) -> None:
        """A rank other than the mesh's first: run each batch the first rank
        sends, in order, until its stop. A failed batch fails there too (the
        same call over the same collectives), which retries or gives up; a
        failure on this rank alone leaves the first rank in a collective
        until the process group's own timeout, and this rank, hearing
        nothing, takes it as lost. Raises :class:`ReplicaDeadError` when the
        first rank is lost (the worker's end fails this server)."""
        while True:
            message = self._control.receive()
            if message[0] == "stop":
                return
            if message[0] == "beat":
                continue
            _, rows, kwargs = message
            try:
                self._generate_fn(self.model, rows, **kwargs)
                self.metrics.bump("batches")
            except Exception:  # noqa: BLE001 - the first rank sees the batch fail and decides
                self.metrics.bump("batch_failures")
                logger.exception("replayed batch failed")

    def _clamp_budget(self, req: _Request) -> None:
        # the degradation ladder's clamp waits for A10: the whole budget runs
        req.effective_max_new_tokens = req.max_new_tokens
        req.degraded = False

    def _shed(self, req: _Request, now: float) -> None:
        if resolve_future(req.future, exception=RequestDeadlineExceeded(
                f"deadline passed {now - req.deadline:.3f}s ago at dequeue (estimated batch "
                f"time {self._batch_time_ewma:.3f}s); shed instead of wasting a batch slot")):
            self.metrics.bump("shed_deadline")

    def _collect_batch(self) -> list:
        """Head-of-line batching: shed heads that cannot make their deadline
        (the estimate is the EWMA of recent batch times), take the first
        live request, then the compatible requests behind it, waiting up to
        ``batch_window_s`` for more. An incompatible head ends the batch."""
        cfg = self.config
        with self._wake:
            first = None
            while self._queue:
                now = self._clock()
                req = self._queue.popleft()
                if req.deadline is not None and now + self._batch_time_ewma > req.deadline:
                    self._shed(req, now)
                    continue
                self._clamp_budget(req)
                first = req
                break
            if first is None:
                return []
            batch = [first]
            key = first.group_key()
            window_end = self._clock() + cfg.batch_window_s
            while len(batch) < cfg.max_batch_size and not self._draining:
                if self._queue:
                    now = self._clock()
                    head = self._queue[0]
                    if head.deadline is not None and now + self._batch_time_ewma > head.deadline:
                        self._shed(self._queue.popleft(), now)
                        continue
                    self._clamp_budget(head)
                    if head.group_key() != key:
                        break  # it heads the next batch
                    batch.append(self._queue.popleft())
                    continue
                remaining = window_end - self._clock()
                if remaining <= 0:
                    break
                self._wake.wait(timeout=remaining)
        return batch

    def _bucket_rows(self, n: int) -> int:
        if not self.config.batch_bucket:
            return n
        b = 1
        while b < n:
            b *= 2
        return min(b, max(self.config.max_batch_size, n))

    def _default_generate(self, model, ids, **kwargs):
        from .inference import generate

        return generate(model, ids, **kwargs)

    def _run_batch(self, batch: list) -> np.ndarray:
        cfg = self.config
        first = batch[0]
        rows = np.stack([r.input_ids for r in batch])
        target = self._bucket_rows(len(batch))
        if target > len(batch):  # pad rows so the program LRU sees pow-2 batch shapes
            rows = np.concatenate([rows, np.repeat(rows[:1], target - len(batch), axis=0)], axis=0)
        total = rows.shape[1] + first.effective_max_new_tokens
        pad_to = -(-total // cfg.pad_total_multiple) * cfg.pad_total_multiple
        kv_kwargs = {}
        if cfg.kv_cache != "dense":  # dense is generate()'s default
            kv_kwargs = {"kv_backend": cfg.kv_cache, "kv_block_size": cfg.engine_block_size}
        kwargs = dict(
            max_new_tokens=first.effective_max_new_tokens, temperature=first.temperature,
            seed=first.seed, pad_to=pad_to, top_k=first.top_k, top_p=first.top_p,
            eos_token_id=first.eos_token_id, pad_token_id=first.pad_token_id, **kv_kwargs,
        )
        if self._control is not None:  # the other ranks run the same call
            self._control.send(("batch", rows, kwargs))
        out = self._generate_fn(self.model, rows, **kwargs)
        # read back here: a transfer error is a batch failure, not the client's
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        return np.asarray(out)[: len(batch)]

    def _execute(self, batch: list) -> None:
        """Run one batch, retrying a failure ``max_retries`` times with
        exponential backoff and jitter (a drain cuts the wait and the
        ladder), then reply to each request with its row."""
        cfg = self.config
        attempt = 0
        while True:
            try:
                t0 = self._clock()
                fault_point("serving_before_batch")
                out = self._run_batch(batch)
                dt = self._clock() - t0
                fault_point("serving_after_batch")
            except BaseException as exc:  # classified below
                if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                    # the worker is about to die: never leave the batch unresolved
                    self._fail_batch(batch, exc, "worker interrupted mid-batch",
                                     err_cls=ReplicaDeadError)
                    raise
                attempt += 1
                self.metrics.bump("batch_failures")
                if attempt > cfg.max_retries or self._draining:
                    self._fail_batch(batch, exc,
                                     f"batch failed permanently after {attempt} attempt(s)")
                    return
                self.metrics.bump("retries")
                backoff = min(cfg.retry_backoff_s * (2 ** (attempt - 1)), cfg.retry_backoff_max_s)
                backoff *= 1.0 + cfg.retry_jitter * self._rng.random()
                logger.warning("batch attempt %d/%d failed (%s: %s); retrying in %.3fs",
                               attempt, cfg.max_retries + 1, type(exc).__name__, exc, backoff)
                with self._wake:  # a drain request cuts the wait short
                    self._wake.wait(timeout=backoff)
                continue
            break
        # the batch ran: any failure from here fails this batch's futures
        # instead of escaping with them unresolved
        try:
            self.metrics.bump("batches")
            self._batch_time_ewma = (dt if self._batch_time_ewma == 0.0
                                     else 0.8 * self._batch_time_ewma + 0.2 * dt)
            fault_point("serving_before_reply")
            now = self._clock()
            for i, req in enumerate(batch):
                if req.deadline is not None and now > req.deadline:
                    if resolve_future(req.future, exception=RequestDeadlineExceeded(
                            f"batch completed {now - req.deadline:.3f}s past the deadline")):
                        self.metrics.bump("completed_late")
                    continue
                latency = now - req.submitted_at
                result = ServingResult(
                    tokens=out[i], latency_s=latency, batch_size=len(batch), ttft_s=latency,
                    queue_wait_s=max(0.0, latency - dt),
                    decode_steps=req.effective_max_new_tokens,
                )
                if resolve_future(req.future, result=result):
                    self.metrics.bump("completed")
                    self.metrics.add(latency, latency)
        except BaseException as exc:
            self._fail_batch(batch, exc, "batch executed but the reply failed")
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                raise
            logger.exception("serving reply epilogue failed; the batch's futures were failed")

    def _fail_batch(self, batch: list, cause: BaseException, reason: str,
                    err_cls: type = BatchExecutionError) -> None:
        err = err_cls(f"{reason}: {type(cause).__name__}: {cause}")
        err.__cause__ = cause
        for req in batch:
            resolve_future(req.future, exception=err)

    # ------------------------------------------------- continuous batching
    def _loop_continuous(self) -> None:
        """Each pass: admit into free slots, one engine tick, read back,
        reply, shed. Draining stops admission but keeps stepping until every
        in-flight slot retires. Over a mesh each decision goes to the
        replaying ranks before it runs (:meth:`_decide`), and a beat after
        each idle ``_BEAT_S``."""
        eng, control = self._engine, self._control
        while True:
            with self._wake:
                while not self._queue and eng.live_count() == 0 and not self._draining:
                    if control is not None and control.beat_due():
                        break
                    self._wake.wait(timeout=0.05)
                if self._draining and eng.live_count() == 0:
                    return  # the finally rejects what is still queued
                idle = not self._queue and eng.live_count() == 0
            if idle:  # over a mesh: tell the replaying ranks this rank is alive
                control.send(("beat",))
                continue
            if not self._draining:
                self._admit_slots()
            self._decide("tick", (eng.prefill_chunk_limit, eng.spec_draft_limit))
            self._engine_tick()

    def _decide(self, kind: str, payload) -> None:
        """Over a mesh, send one decision to the replaying ranks before this
        rank runs it (an ``"insert"`` with the request's engine arguments,
        or a ``"tick"`` with the chunk and spec limits), with the slots this
        rank's clock cancelled since the last decision, which they cancel
        first."""
        if self._control is not None:
            cancels, self._cancelled = self._cancelled, []
            self._control.send((kind, cancels, payload))

    def _admit_slots(self) -> None:
        eng = self._engine
        while eng.free_slots() > 0:
            with self._wake:
                if not self._queue:
                    return
                req = self._queue.popleft()
            now = self._clock()
            if req.deadline is not None and now > req.deadline:
                if resolve_future(req.future, exception=RequestDeadlineExceeded(
                        f"deadline passed {now - req.deadline:.3f}s ago while queued")):
                    self.metrics.bump("shed_deadline")
                continue
            # paged KV: a free slot is not enough, the blocks must be free
            # too; requeue at the head and retry after retirements
            if not eng.can_admit(req.input_ids, req.max_new_tokens):
                with self._wake:
                    self._queue.appendleft(req)
                return
            self._decide("insert", _engine_args(req))
            if not self._insert(req):
                return

    def _insert(self, req: _Request) -> bool:
        """Admit ``req`` into a slot; False when the engine failed (its
        requests failed, its state rebuilt)."""
        try:
            if not self._insert_prefilled(req):
                self._engine.insert(
                    req.input_ids, max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                    eos_token_id=req.eos_token_id, pad_token_id=req.pad_token_id,
                    seed=req.seed, tag=req,
                )
        except Exception as exc:  # the engine failed: fail its requests, rebuild
            self._engine_failure(exc, also_fail=req)
            return False
        self.metrics.bump("engine_inserts")
        return True

    def _insert_prefilled(self, req: _Request) -> bool:
        """Commit ``req``'s prefill when the engine takes it and its budget
        covers the request's; True when it did. A transfer error (the
        reservation went stale since the check) counts a fallback; a
        reservation still held is released, so the slot does not wait for
        its TTL."""
        pre, eng = req.prefill, self._engine
        if pre is None:
            return False
        if req.max_new_tokens <= pre.max_new_tokens and eng.accepts_prefill(pre):
            try:
                eng.insert_prefilled(pre, max_new_tokens=req.max_new_tokens, tag=req)
                return True
            except KVTransferError:
                self.metrics.bump("prefill_commit_fallbacks")
        if getattr(pre, "reservation", None) is not None:
            eng.release_reservation(*pre.reservation)
        return False

    def _loop_replay_continuous(self) -> None:
        """A rank other than the mesh's first in continuous mode: apply each
        decision the first rank sends, in order, until its stop: its
        cancels, then the admission (a request without a deadline) or the
        tick (the limits, then :meth:`_engine_tick`). An engine failure here
        is the first rank's too (the same calls over the same collectives),
        which rebuilds its engine as this one does; a failure on this rank
        alone leaves the first rank inside a collective until the process
        group's own timeout, and this rank, hearing nothing, takes it as
        lost. Raises :class:`ReplicaDeadError` when the first rank is
        lost."""
        eng = self._engine
        while True:
            message = self._control.receive()
            if message[0] == "stop":
                return
            if message[0] == "beat":
                continue
            kind, cancels, payload = message
            live = {occ.slot: occ for occ in eng.occupants()}
            for slot in cancels:
                eng.cancel(live[slot])
                self.metrics.bump("engine_retired")
            if kind == "insert":
                ids, budget, temp, top_k, top_p, eos, pad, seed = payload
                self._insert(_Request(input_ids=ids, max_new_tokens=budget, deadline=None,
                                      temperature=temp, top_k=top_k, top_p=top_p,
                                      eos_token_id=eos, pad_token_id=pad, seed=seed,
                                      submitted_at=0.0))
            else:
                eng.set_prefill_chunk_limit(payload[0])
                eng.set_spec_draft_limit(payload[1])
                self._engine_tick()

    def _engine_tick(self) -> None:
        eng = self._engine
        if eng.live_count() == 0:
            self._reply_retired(eng.poll(force=True))
            return
        try:
            eng.step()
            retired = eng.poll()
        except Exception as exc:
            self._engine_failure(exc)
            return
        self.metrics.bump("engine_steps")
        self._reply_retired(retired)
        if self._control is not None and not self._control.is_leader:
            return  # the first rank's clock cancels, sent with its next decision
        now = self._clock()
        for occ in eng.occupants():
            req = occ.tag
            if req.deadline is not None and now > req.deadline:
                eng.cancel(occ)
                if self._control is not None:
                    self._cancelled.append(occ.slot)
                self.metrics.bump("engine_retired")
                if resolve_future(req.future, exception=RequestDeadlineExceeded(
                        f"deadline passed {now - req.deadline:.3f}s ago mid-decode")):
                    self.metrics.bump("shed_deadline")

    def _reply_retired(self, retired: list) -> None:
        if not retired:
            return
        now = self._clock()
        occupancy = self._engine.live_count() + len(retired)
        for occ in retired:
            req = occ.tag
            self.metrics.bump("engine_retired")
            if req.deadline is not None and now > req.deadline:
                if resolve_future(req.future, exception=RequestDeadlineExceeded(
                        f"decode finished {now - req.deadline:.3f}s past the deadline")):
                    self.metrics.bump("completed_late")
                continue
            latency = now - req.submitted_at
            ttft = (occ.first_token_s - req.submitted_at) if occ.first_token_s is not None else latency
            result = ServingResult(
                tokens=occ.output_row(), latency_s=latency, batch_size=occupancy,
                ttft_s=max(0.0, ttft), queue_wait_s=max(0.0, occ.inserted_s - req.submitted_at),
                prefill_s=(max(0.0, occ.first_token_s - occ.inserted_s)
                           if occ.first_token_s is not None else None),
                decode_steps=occ.decode_steps,
            )
            if resolve_future(req.future, result=result):
                self.metrics.bump("completed")
                self.metrics.add(latency, max(0.0, ttft))

    def _engine_failure(self, exc: BaseException, also_fail=None) -> None:
        """An engine program raised: its in-flight state cannot be trusted,
        so fail every request it held and rebuild the engine state."""
        self.metrics.bump("batch_failures")
        victims = [o.tag for o in self._engine.reset()]
        if also_fail is not None:
            victims.append(also_fail)
        for req in victims:
            err = BatchExecutionError(
                f"engine program failed ({type(exc).__name__}: {exc}); "
                f"{len(victims)} in-flight request(s) lost"
            )
            err.__cause__ = exc
            resolve_future(req.future, exception=err)
        logger.warning("engine failure reset the KV store: %s: %s", type(exc).__name__, exc)

    def _reject_queued(self) -> None:
        with self._lock:
            queued, self._queue = list(self._queue), collections.deque()
        for req in queued:
            if resolve_future(req.future, exception=ServerDrainingError(
                    self._drain_reason(), retry_after_s=0.0)):
                self.metrics.bump("rejected_draining")
