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
seed and the slot it takes, and each engine tick with the chunk and spec
limits; either carries the slots the first rank's clock cancelled since
the last decision (deadlines), which the others cancel first. Every rank
thus makes the same engine calls in the same order, in the same slots
(the first rank's free list also lends slots to the KV wire's
reservations, which the others never see: a replaying rank takes the
slot it is told). A committed remote prefill (``submit(prefilled=)``,
the KV wire) is an ``"insert_prefilled"`` decision: the slot, the
prefill's scalars and its window's shape, after which the engine
broadcasts the first rank's window over the model's groups (not this
control channel, which pickles; a Llama-3-8B window is 128 MiB at
``max_len`` 2048). A fleet's remote prompt forward for this server is a
``"prefill"`` decision, run by every rank in the decision stream
(:meth:`InferenceServer._prefill_in_stream`): over a mesh a forward
beside the decode loop would meet the ranks' collectives in another
order. ``kv_prefetch`` prefetches on the first rank only, at submit: a
replaying rank hears of a request only with its admission, which
restores at once, and the agreed restore length keeps the ranks'
restores equal whatever each rank holds prefetched. A replaying rank never
reads its clock to decide, and the message of a tick overlaps the
device's work on the ticks before it, which nothing waits for.
``submit`` on another rank raises; ``close`` or ``drain`` there waits
until the first rank's ends them, or until the first rank has sent
nothing for ``drain_timeout_s`` beyond its longest quiet: it is then
taken as lost and the replaying server fails (:class:`ReplicaDeadError`).
In both modes a failure on one replaying rank alone leaves the first
rank inside a collective until the process group's own timeout.

Robustness, as in the JAX package: a bounded admission queue
(:class:`ServerOverloaded`, with a ``retry_after_s`` hint), deadlines at
admission, mid-decode and at completion (:class:`RequestDeadlineExceeded`),
graceful drain (in-flight work finishes, queued requests get
:class:`ServerDrainingError`; also once the training side's preemption
handler has taken a SIGTERM), a failure failing only the
requests it held (:class:`BatchExecutionError`), and the control plane:

* **Circuit breaker**: ``breaker_threshold`` consecutive failed batch
  attempts (continuous: engine failures) open it; ``submit`` then raises
  :class:`CircuitOpenError` until ``breaker_reset_s`` has passed, when one
  half-open probe (a batch of one, or one admission) closes or reopens it.
* **Degradation ladder**: under queue pressure new budgets are clamped
  (``degrade_queue_fraction``, ``degrade_hard_fraction``,
  ``degraded_max_new_tokens``; ``ServingResult.degraded``) before anything
  is shed; in continuous mode the speculative draft limit is halved, then
  drafting stops, first.
* **Metrics**: :class:`ServingMetrics` over a
  :class:`~accelerate_tpu_torch.tracing.MetricsRegistry`, flushed to
  ``trackers`` every ``metrics_interval_s``; :meth:`InferenceServer.health`
  and :meth:`InferenceServer.metrics_snapshot` for the fleet router and the
  exporter (``perfwatch.py``, armed by ``ACCELERATE_METRICS_PORT``).
* **Spans**: ``serving.batch`` and ``serving.admit`` under the request's
  trace id (``submit(trace_id=)``, or a new one), and a flight-recorder
  dump when the worker dies (``tracing.py``).

Over a mesh only the first rank's breaker reads its clock: its state
travels in each batch and tick it sends, and the replaying ranks adopt it,
so every rank reports one verdict; the ladder's spec rung is the spec limit
each tick already carries, and a clamped budget is the admission's.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from . import perfwatch, tracing
from ._device import resolve_device
from .logging import get_logger
from .telemetry import LatencyReservoir
from .tracing import MetricsRegistry
from .utils.dataclasses import ServingConfig
from .utils.fault import (
    BatchExecutionError,
    CircuitOpenError,
    KVTransferError,
    ReplicaDeadError,
    RequestDeadlineExceeded,
    ServerDrainingError,
    ServerOverloaded,
    fault_point,
    preemption_requested,
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
    # the token budget after the degradation ladder's clamp (set at dequeue)
    effective_max_new_tokens: int = 0
    degraded: bool = False
    # continuous: a prompt forward run off the decode loop (an
    # engine.RemotePrefill), committed at admission when the engine takes it
    prefill: Any = None
    # the request's trace id, carried fleet -> server -> engine
    trace_id: Optional[str] = None

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

    tokens: np.ndarray  # (prompt_len + new,) int32
    latency_s: float
    batch_size: int  # static: the batch's requests; continuous: slots live when it retired
    degraded: bool  # the ladder clamped the token budget
    # continuous: submit -> first token read back; static: the latency (the
    # batch materialises at once)
    ttft_s: Optional[float] = None
    replica_id: Optional[str] = None  # the server that answered (None outside a fleet)
    queue_wait_s: Optional[float] = None
    prefill_s: Optional[float] = None
    decode_steps: int = 0
    # dispatches before the one that answered (set by the fleet router)
    failover_count: int = 0


def _engine_args(req: _Request) -> tuple:
    """What a replaying rank needs of an admitted request: its engine
    arguments, the clamped budget among them (no future, no deadline)."""
    return (req.input_ids, req.effective_max_new_tokens, req.temperature, req.top_k, req.top_p,
            req.eos_token_id, req.pad_token_id, req.seed)


def _prefilled_args(req: _Request) -> tuple:
    """What a replaying rank needs of a committed remote prefill:
    :func:`_engine_args`, then the prefill's budget, its generator seed
    (``next_key``) and its window's and first token's shapes and dtypes
    (the window itself comes by the engine's broadcast)."""
    pre = req.prefill
    return (*_engine_args(req), pre.max_new_tokens, int(pre.next_key[0]),
            {w: (tuple(t.shape), t.dtype) for w, t in pre.cache.items()},
            (tuple(pre.t0.shape), pre.t0.dtype))


def _window_receiver(eng, args: tuple):
    """A replaying rank's :class:`~accelerate_tpu_torch.engine
    .RemotePrefill` for an ``"insert_prefilled"`` decision: the first
    rank's scalars and empty tensors of its window's shapes, which the
    engine's broadcast fills."""
    from .engine import RemotePrefill

    ids, _, temp, top_k, top_p, eos, pad, seed, budget, next_key, window, t0 = args
    empty = lambda spec: torch.empty(spec[0], dtype=spec[1], device=eng.device)  # noqa: E731
    return RemotePrefill(
        prompt=ids, max_new_tokens=budget, temperature=temp, top_k=top_k, top_p=top_p,
        eos_token_id=eos, pad_token_id=pad, seed=seed,
        cache={w: empty(spec) for w, spec in window.items()}, t0=empty(t0),
        next_key=torch.tensor([next_key], dtype=torch.int64), engine_config=eng.config,
        prompt_bucket=eng.prompt_bucket, max_len=eng.max_len)


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
    """Thread-safe serving counters and latency reservoirs, over one
    :class:`~accelerate_tpu_torch.tracing.MetricsRegistry` (prefix
    ``serving/``), which owns the lock, the flush cadence and the tracker
    bridge. :meth:`snapshot` flattens everything into one ``serving/...``
    dict; the reservoirs' percentiles appear as ``<name>_p50`` etc."""

    _COUNTERS = (
        "submitted",
        "completed",
        "rejected_queue_full",
        "rejected_breaker",
        "rejected_draining",
        "shed_deadline",
        "completed_late",
        "retries",
        "batch_failures",
        "batches",
        "breaker_opens",
        "degraded",
        # continuous mode only
        "engine_inserts",
        "engine_steps",
        "engine_retired",
        # a prefill from the wire lost its reservation between the check
        # and the commit: the prompt forward ran locally instead
        "prefill_commit_fallbacks",
    )

    def __init__(self, clock=time.monotonic):
        self.registry = MetricsRegistry(prefix="serving/", counters=self._COUNTERS, clock=clock)
        self.latency = LatencyReservoir()  # seconds, completed requests
        self.queue_wait = LatencyReservoir()  # seconds queued
        # a short window, so p99 follows the current service
        self.ttft = LatencyReservoir(size=256)
        self.registry.attach_reservoir("latency", self.latency)
        self.registry.attach_reservoir("queue_wait", self.queue_wait)
        self.registry.attach_reservoir("ttft", self.ttft)
        for name in ("queue_depth", "breaker_state", "kv_hbm_bytes", "kv_utilization",
                     "prefix_hit_rate", "spec_acceptance_rate", "spec_tokens_per_step"):
            self.registry.gauge(name, 0.0)

    def bump(self, name: str, by: int = 1) -> None:
        self.registry.bump(name, by)

    def gauge(self, name: str, value: float) -> None:
        self.registry.gauge(name, value)

    def __getitem__(self, name: str) -> int:
        return self.registry[name]

    def snapshot(self) -> dict:
        return self.registry.snapshot()


class _CircuitBreaker:
    """Three states over consecutive failed batch attempts: CLOSED ->
    (``threshold`` failures) -> OPEN -> (``reset_s``) -> HALF_OPEN (one
    probe) -> CLOSED on success, OPEN on failure. Transitions happen on the
    worker thread; ``submit`` only reads."""

    CLOSED, OPEN, HALF_OPEN = 0, 1, 2

    def __init__(self, threshold: int, reset_s: float, clock: Callable[[], float]):
        self.threshold = threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._failures = 0
        self._opened_at = 0.0
        self.opens = 0

    def state(self) -> int:
        """The state; an OPEN breaker whose window has passed reports (and
        becomes) HALF_OPEN."""
        with self._lock:
            if self._state == self.OPEN and self._clock() - self._opened_at >= self.reset_s:
                self._state = self.HALF_OPEN
            return self._state

    @property
    def rejects_admission(self) -> bool:
        return self.state() == self.OPEN

    def seconds_until_probe(self) -> float:
        with self._lock:
            if self._state != self.OPEN:
                return 0.0
            return max(0.0, self.reset_s - (self._clock() - self._opened_at))

    def record_failure(self) -> bool:
        """Count one failed attempt; True when it opened (or reopened) the
        breaker."""
        with self._lock:
            self._failures += 1
            was_open = self._state == self.OPEN
            if self._state == self.HALF_OPEN or self._failures >= self.threshold:
                self._state = self.OPEN
                self._opened_at = self._clock()
                if not was_open:
                    self.opens += 1
                    return True
            return False

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._state = self.CLOSED

    # the port's addition, for a server over a mesh: the first rank's
    # verdict travels in its messages, and the replaying ranks adopt it
    # instead of reading their own clocks
    def _verdict(self) -> tuple:
        with self._lock:
            return (self._state, self._failures, self.opens)

    def _adopt(self, verdict: tuple) -> None:
        with self._lock:
            self._state, self._failures, self.opens = verdict


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
    :class:`~accelerate_tpu_torch.engine.ContinuousBatchingEngine` (tests,
    or replicas sharing one model), ``None`` builds one from the
    ``engine_*`` knobs; ``generate_fn`` is inert there, as the engine owns
    the device programs. ``trackers`` receive a metrics snapshot every
    ``config.metrics_interval_s`` and at drain; ``replica_id`` names the
    server inside a fleet and is stamped on its typed errors and results;
    ``clock`` is the monotonic time source. Construction starts the
    worker; use it as a context manager or call :meth:`close`.

    Over a model laid out over a mesh, in either mode: every rank builds
    the server; the mesh's first rank serves, the others replay its
    batches or decisions (see the module docstring).
    """

    def __init__(self, model, config: Optional[ServingConfig] = None, *,
                 generate_fn: Optional[Callable[..., Any]] = None, trackers: Sequence = (),
                 clock: Callable[[], float] = time.monotonic, engine=None,
                 replica_id: Optional[str] = None, device="cuda"):
        self.model = model
        self.config = config or ServingConfig()
        self.replica_id = replica_id
        self.trackers = list(trackers)
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
        self.metrics = ServingMetrics(clock=clock)
        self._breaker = _CircuitBreaker(self.config.breaker_threshold,
                                        self.config.breaker_reset_s, clock)
        # seconds a batch (static) or a tick (continuous), for shedding at
        # dequeue, the overload hint and the fleet's placement
        self._batch_time_ewma = 0.0
        # continuous over a mesh: the slots cancelled since the last decision sent
        self._cancelled: list = []
        # continuous: remote prompt forwards queued for the decision stream
        # (prompt, prefill_remote's arguments, future)
        self._prefills: collections.deque = collections.deque()
        self._rng = random.Random(0)  # backoff jitter only
        self._worker = threading.Thread(target=self._serve_loop, name="inference-server", daemon=True)
        self._worker.start()
        # the pull endpoint (ACCELERATE_METRICS_PORT), on a standalone
        # server only: a fleet's replicas are exported by the router
        self._exporter = (perfwatch.maybe_exporter(self.metrics_snapshot)
                          if replica_id is None else None)

    @property
    def _replaying(self) -> bool:
        return self._control is not None and not self._control.is_leader

    @property
    def engine(self):
        """The continuous mode's slot engine (``None`` in static mode). The
        fleet's prefill workers reach ``prefill_remote`` through it;
        everything else on the engine belongs to the serving thread."""
        return self._engine

    @property
    def draining(self) -> bool:
        return self._draining or self._closed

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
        .kv_prefix_digest`), which the fleet's prober gossips for
        KV-affinity placement; None in static mode."""
        if self._engine is None:
            return None
        fn = getattr(self._engine, "kv_prefix_digest", None)
        return fn() if fn is not None else None

    def health(self) -> dict:
        """One cheap health sample for routers and probers (no device work,
        no tracker I/O): ``draining``, ``worker_alive``, ``worker_error``
        (the type name that killed the worker), ``breaker_state`` (0 CLOSED,
        1 OPEN, 2 HALF_OPEN), ``queue_depth``/``queue_free``, ``inflight``
        (live engine slots; 0 in static mode), ``batch_ewma_s`` (the
        placement's cost estimate), ``mode`` and ``replica_id``."""
        depth = self.queue_depth()
        return {
            "replica_id": self.replica_id,
            "mode": self.config.mode,
            "draining": self.draining or preemption_requested(),
            "worker_alive": self._worker.is_alive(),
            "worker_error": (type(self._worker_error).__name__
                             if self._worker_error is not None else None),
            "breaker_state": self._breaker.state(),
            "queue_depth": depth,
            "queue_free": max(0, self.config.max_queue - depth),
            "inflight": self._engine.live_count() if self._engine is not None else 0,
            "batch_ewma_s": self._batch_time_ewma,
        }

    def metrics_snapshot(self) -> dict:
        """One flat metrics dict for exporters and the fleet: the registry's
        snapshot with the engine's gauges read again (``engine.stats()``
        reads host counters only), and the perf observatory
        (``perf/<program>/...``): the one the engine bills (the process's
        when the engine was built), else the process's. Replicas of one
        process built each under a watch of its own (``perfwatch.configure``)
        so report their own measured-vs-predicted ratios, as replicas in
        processes of their own do, and the fleet's brown-out detector can
        tell one slow replica from its peers."""
        watch = perfwatch.get_watch()
        if self._engine is not None:
            self._sync_kv_gauges()
            watch = self._engine._perfwatch
        out = self.metrics.registry.snapshot()
        out.update(watch.snapshot())
        return out

    # ------------------------------------------------------------ admission
    def submit(self, input_ids, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_token_id: Optional[int] = None, pad_token_id: Optional[int] = None,
               seed: int = 0, prefilled=None, arrival_s: Optional[float] = None,
               trace_id: Optional[str] = None) -> Future:
        """Admit one request; returns a Future resolving to
        :class:`ServingResult` or raising the typed error that ended it.
        Raises at once (before queueing) when the server is draining
        (:class:`ServerDrainingError`), its breaker is open
        (:class:`CircuitOpenError`), the queue is full
        (:class:`ServerOverloaded`), or the request cannot fit the engine.
        ``deadline_s`` is relative (``None``: ``config.default_deadline_s``);
        ``seed`` drives a sampled request's draws (``temperature > 0``).
        ``prefilled`` (continuous mode): the request's
        :class:`~accelerate_tpu_torch.engine.RemotePrefill`, committed at
        admission instead of running the prompt forward on the serving
        thread; a prefill the engine cannot take (another shape, a budget
        below the request's, a stale reservation) falls back to that
        forward. With ``config.kv_prefetch`` the request's host-tier
        blocks start their copies to the card here, on this thread.
        ``arrival_s`` back-dates the request's arrival on this server's
        clock (a fleet's failover or remote prefill keeps the client's
        latency honest); ``trace_id`` joins an existing trace, else one is
        made when the tracer is on. Over a mesh, only its first rank admits
        requests."""
        if self._replaying:
            raise RuntimeError(
                f"submit on rank {self._control.rank}: the model is served over a mesh, whose "
                f"first rank ({self._control.leader}) admits every request; this rank replays "
                "its decisions")
        fault_point("serving_submit", replica=self.replica_id)
        if self._closed or self._draining or preemption_requested():
            self.metrics.bump("rejected_draining")
            raise ServerDrainingError(self._drain_reason(), replica_id=self.replica_id,
                                      retry_after_s=0.0)
        if self._breaker.rejects_admission:
            self.metrics.bump("rejected_breaker")
            wait = self._breaker.seconds_until_probe()
            raise CircuitOpenError(
                f"circuit breaker open after repeated batch failures; retry in {wait:.2f}s",
                replica_id=self.replica_id, retry_after_s=wait)
        ids = np.asarray(input_ids, dtype=np.int32)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1 or ids.shape[0] == 0:
            raise ValueError(f"input_ids must be a non-empty 1-D prompt, got shape {ids.shape}")
        budget = max_new_tokens or self.config.default_max_new_tokens
        if prefilled is not None and self._engine is None:
            raise ValueError("prefilled= requires mode='continuous' (no slot engine to commit the "
                             "precomputed prefill into)")
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
            submitted_at=arrival_s if arrival_s is not None else now, prefill=prefilled,
            trace_id=trace_id or (tracing.new_trace_id() if tracing.get_tracer().enabled else None),
        )
        with self._wake:
            if self._draining or self._closed:
                self.metrics.bump("rejected_draining")
                raise ServerDrainingError(self._drain_reason(), replica_id=self.replica_id,
                                          retry_after_s=0.0)
            if len(self._queue) >= self.config.max_queue:
                self.metrics.bump("rejected_queue_full")
                hint = self._retry_after_hint(len(self._queue))
                raise ServerOverloaded(
                    f"admission queue full ({self.config.max_queue}); back off and resubmit in "
                    f"~{hint:.2f}s", replica_id=self.replica_id, retry_after_s=hint)
            self._queue.append(req)
            self.metrics.bump("submitted")
            self.metrics.gauge("queue_depth", len(self._queue))
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
        if self._replaying:
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
        """Drain (or, with ``drain=False``, stop without waiting), join the
        worker, stop the exporter and flush the trackers. Idempotent."""
        done = self.drain(timeout if drain else 0.0)
        self._closed = True
        if self._worker is not threading.current_thread():
            self._worker.join(timeout=self.config.drain_timeout_s)
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        if self.trackers:
            self._flush_metrics(force=True)
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
        replaying = self._replaying
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
            # admission stops first: nothing consumes the queue any more
            with self._lock:
                self._worker_error = exc
                self._draining = True
            logger.exception("serving worker died; failing in-flight and queued requests")
            # the last seconds of spans, for a postmortem of the death
            tracing.flight_dump("worker_death")
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
                    replica_id=self.replica_id))
            self._reject_queued()
            if self._control is not None and self._control.is_leader:
                try:
                    self._control.send(("stop",))  # ends the replaying ranks' loops
                except Exception:  # noqa: BLE001 - a lost peer must not hang this drain
                    logger.exception("could not end the replaying ranks")
            self._drained.set()
            self._flush_metrics(force=True)

    def _beat(self) -> None:
        """Over a mesh: tell the replaying ranks this rank is alive when it
        has been quiet for ``_BEAT_S``."""
        if self._control is not None and self._control.beat_due():
            self._control.send(("beat",))

    def _wait_for_breaker(self) -> None:
        """The breaker is open: shed the queued requests that cannot make
        their deadline before the probe, and wait a little."""
        self._shed_expired()
        self._beat()
        time.sleep(min(0.01, max(self._breaker.seconds_until_probe(), 0.001)))

    # ------------------------------------------------------ static batching
    def _loop_static(self) -> None:
        """Admission-time batching of whole ``generate()`` calls. Draining
        returns once the in-flight batch has replied; the finally rejects
        what is still queued."""
        control = self._control
        while True:
            with self._wake:
                while not self._queue and not self._draining:
                    if preemption_requested():
                        self._draining = True
                        break
                    if control is not None and control.beat_due():
                        break
                    if self._flush_due():
                        break  # flushed below, with the lock released
                    self._wake.wait(timeout=0.05)
                if self._draining or preemption_requested():
                    self._draining = True
                    return
                idle = not self._queue
            # a slow tracker must never stall submit() or a wakeup
            self._flush_metrics()
            if idle:
                self._beat()
                continue
            st = self._breaker.state()
            if st == _CircuitBreaker.OPEN:
                # failing fast is submit()'s; here shed what cannot wait
                self._wait_for_breaker()
                continue
            batch = self._collect_batch(probe=(st == _CircuitBreaker.HALF_OPEN))
            if batch:
                self._execute(batch)

    def _loop_replay(self) -> None:
        """A rank other than the mesh's first: run each batch the first rank
        sends, in order, until its stop, adopting the first rank's breaker
        verdict. A failed batch fails there too (the same call over the same
        collectives), which retries or gives up; a failure on this rank
        alone leaves the first rank in a collective until the process
        group's own timeout, and this rank, hearing nothing, takes it as
        lost. Raises :class:`ReplicaDeadError` when the first rank is lost
        (the worker's end fails this server)."""
        while True:
            message = self._control.receive()
            if message[0] == "stop":
                return
            if message[0] == "beat":
                continue
            _, rows, kwargs, verdict = message
            self._breaker._adopt(verdict)
            try:
                self._generate_fn(self.model, rows, **kwargs)
                self.metrics.bump("batches")
            except Exception:  # noqa: BLE001 - the first rank sees the batch fail and decides
                self.metrics.bump("batch_failures")
                logger.exception("replayed batch failed")

    def _estimated_batch_s(self) -> float:
        return self._batch_time_ewma

    def _retry_after_hint(self, depth: int) -> float:
        """The ``retry_after_s`` of :class:`ServerOverloaded`: the estimated
        time until a queue place frees, from the batch-time EWMA and the
        depth (static: ``max_batch_size`` requests a batch; continuous: a
        slot every ``engine_slots``-th of a degraded budget's steps). A cold
        EWMA falls back to the batch window; clamped to [1 ms, 5 s]."""
        ewma = self._batch_time_ewma
        if self._engine is not None:
            per_free = (ewma or 0.01) * max(1, self.config.degraded_max_new_tokens)
            per_free /= max(1, self.config.engine_slots)
        else:
            waves = (max(1, depth) + self.config.max_batch_size - 1) // max(
                1, self.config.max_batch_size)
            per_free = (ewma or self.config.batch_window_s or 0.01) * waves
        return float(min(5.0, max(1e-3, per_free)))

    def _degrade_level(self, depth: int) -> int:
        frac = depth / self.config.max_queue
        if frac >= self.config.degrade_hard_fraction:
            return 2
        if frac >= self.config.degrade_queue_fraction:
            return 1
        return 0

    def _apply_spec_degradation(self, level: int) -> None:
        """The continuous ladder's first rung: under queue pressure shrink
        the speculative draft limit before anyone's budget (level 1 halves
        it, level 2 stops drafting; the verify program keeps its width, so
        nothing is recaptured), and restore it when the pressure goes."""
        eng = self._engine
        if eng is None or getattr(eng, "spec", None) is None:
            return
        full = self.config.spec_draft_len
        if level >= 2:
            eng.set_spec_draft_limit(0)
        elif level == 1:
            eng.set_spec_draft_limit(max(1, full // 2))
        else:
            eng.set_spec_draft_limit(full)

    def _clamp_budget(self, req: _Request, level: int) -> None:
        budget = req.max_new_tokens
        if level == 1:
            budget = min(budget, self.config.degraded_max_new_tokens)
        elif level == 2:
            budget = min(budget, max(1, self.config.degraded_max_new_tokens // 2))
        req.degraded = budget < req.max_new_tokens
        req.effective_max_new_tokens = budget

    def _shed(self, req: _Request, now: float) -> None:
        if resolve_future(req.future, exception=RequestDeadlineExceeded(
                f"deadline passed {now - req.deadline:.3f}s ago at dequeue (estimated batch "
                f"time {self._estimated_batch_s():.3f}s); shed instead of wasting a batch slot",
                replica_id=self.replica_id)):
            self.metrics.bump("shed_deadline")

    def _shed_expired(self) -> None:
        """Drop the queued requests that can no longer make their deadline
        (while the breaker is open, so their clients hear at once)."""
        now = self._clock()
        with self._lock:
            keep: collections.deque = collections.deque()
            while self._queue:
                req = self._queue.popleft()
                if req.deadline is not None and now + self._estimated_batch_s() > req.deadline:
                    self._shed(req, now)
                else:
                    keep.append(req)
            self._queue = keep
            self.metrics.gauge("queue_depth", len(self._queue))

    def _collect_batch(self, probe: bool = False) -> list:
        """Head-of-line batching: shed heads that cannot make their deadline
        (the estimate is the EWMA of recent batch times), clamp the first
        live request's budget by the ladder, then take the compatible
        requests behind it, waiting up to ``batch_window_s`` for more. An
        incompatible head ends the batch. ``probe`` (a half-open breaker)
        takes one request."""
        cfg = self.config
        max_size = 1 if probe else cfg.max_batch_size
        with self._wake:
            first = None
            while self._queue:
                now = self._clock()
                req = self._queue.popleft()
                level = self._degrade_level(len(self._queue) + 1)
                if req.deadline is not None and now + self._estimated_batch_s() > req.deadline:
                    self._shed(req, now)
                    continue
                self._clamp_budget(req, level)
                first = req
                break
            if first is None:
                self.metrics.gauge("queue_depth", len(self._queue))
                return []
            batch = [first]
            key = first.group_key()
            window_end = self._clock() + cfg.batch_window_s
            while len(batch) < max_size and not self._draining:
                if self._queue:
                    now = self._clock()
                    head = self._queue[0]
                    if head.deadline is not None and now + self._estimated_batch_s() > head.deadline:
                        self._shed(self._queue.popleft(), now)
                        continue
                    self._clamp_budget(head, self._degrade_level(len(self._queue)))
                    if head.group_key() != key:
                        break  # it heads the next batch
                    batch.append(self._queue.popleft())
                    continue
                remaining = window_end - self._clock()
                if remaining <= 0:
                    break
                self._wake.wait(timeout=remaining)
            self.metrics.gauge("queue_depth", len(self._queue))
        self.metrics.bump("degraded", sum(1 for r in batch if r.degraded))
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
            self._control.send(("batch", rows, kwargs, self._breaker._verdict()))
        out = self._generate_fn(self.model, rows, **kwargs)
        # read back here: a transfer error is a batch failure, not the client's
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        return np.asarray(out)[: len(batch)]

    def _execute(self, batch: list) -> None:
        """Run one batch, retrying a failure ``max_retries`` times with
        exponential backoff and jitter (a drain cuts the wait and the
        ladder), each failed attempt counted by the breaker, then reply to
        each request with its row."""
        cfg = self.config
        attempt = 0
        while True:
            try:
                # the clock first: an armed serving_before_batch sleep lands
                # inside the measured window, as a slow batch would
                t0 = self._clock()
                fault_point("serving_before_batch", replica=self.replica_id)
                with tracing.span("serving.batch", trace_id=batch[0].trace_id,
                                  batch_size=len(batch), attempt=attempt):
                    out = self._run_batch(batch)
                dt = self._clock() - t0
                fault_point("serving_after_batch", replica=self.replica_id)
            except BaseException as exc:  # classified below
                if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                    # the worker is about to die: never leave the batch unresolved
                    self._fail_batch(batch, exc, "worker interrupted mid-batch",
                                     err_cls=ReplicaDeadError)
                    raise
                attempt += 1
                self.metrics.bump("batch_failures")
                if self._breaker.record_failure():
                    self.metrics.bump("breaker_opens")
                    logger.warning("circuit breaker OPEN after %d consecutive batch failures "
                                   "(last: %s)", cfg.breaker_threshold, exc)
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
            self._breaker.record_success()
            self.metrics.bump("batches")
            self._batch_time_ewma = (dt if self._batch_time_ewma == 0.0
                                     else 0.8 * self._batch_time_ewma + 0.2 * dt)
            # no baseline program: a measured-only row; dt is the time this
            # loop measured, the tokens' readback its synchronisation
            perfwatch.get_watch().record("serving.static/batch", dt)
            fault_point("serving_before_reply", replica=self.replica_id)
            now = self._clock()
            for i, req in enumerate(batch):
                if req.deadline is not None and now > req.deadline:
                    if resolve_future(req.future, exception=RequestDeadlineExceeded(
                            f"batch completed {now - req.deadline:.3f}s past the deadline",
                            replica_id=self.replica_id)):
                        self.metrics.bump("completed_late")
                    continue
                latency = now - req.submitted_at
                result = ServingResult(
                    tokens=out[i], latency_s=latency, batch_size=len(batch),
                    degraded=req.degraded, ttft_s=latency, replica_id=self.replica_id,
                    queue_wait_s=max(0.0, latency - dt), decode_steps=req.effective_max_new_tokens,
                )
                if resolve_future(req.future, result=result):
                    self.metrics.bump("completed")
                    self.metrics.latency.add(latency)
                    self.metrics.ttft.add(latency)  # the batch materialises at once
                    self.metrics.queue_wait.add(max(0.0, latency - dt))
        except BaseException as exc:
            self._fail_batch(batch, exc, "batch executed but the reply failed")
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                raise
            logger.exception("serving reply epilogue failed; the batch's futures were failed")

    def _fail_batch(self, batch: list, cause: BaseException, reason: str,
                    err_cls: type = BatchExecutionError) -> None:
        err = err_cls(f"{reason}: {type(cause).__name__}: {cause}", replica_id=self.replica_id)
        err.__cause__ = cause
        for req in batch:
            resolve_future(req.future, exception=err)

    # ------------------------------------------------- continuous batching
    def _loop_continuous(self) -> None:
        """Each pass: admit into free slots (one, as the probe, when the
        breaker is half-open; none while it is open), one engine tick, read
        back, reply, shed. Draining stops admission but keeps stepping until
        every in-flight slot retires. Over a mesh each decision goes to the
        replaying ranks before it runs (:meth:`_decide`), and a beat after
        each idle ``_BEAT_S``."""
        eng, control = self._engine, self._control
        while True:
            with self._wake:
                while (not self._queue and not self._prefills and eng.live_count() == 0
                       and not self._draining and not preemption_requested()
                       and not self._flush_due()):
                    if control is not None and control.beat_due():
                        break
                    self._wake.wait(timeout=0.05)
                if self._draining or preemption_requested():
                    self._draining = True
                    if eng.live_count() == 0:
                        return  # the finally rejects what is still queued
                idle = not self._queue and not self._prefills and eng.live_count() == 0
            self._flush_metrics()
            self._run_prefills()
            if idle:
                self._beat()
                continue
            st = self._breaker.state()
            if st == _CircuitBreaker.OPEN:
                # an engine failure resets the engine, so an open breaker
                # has no live slots: wait out the probe window
                if eng.live_count() == 0:
                    self._wait_for_breaker()
                    continue
                self._shed_expired()
            elif not self._draining:
                self._admit_slots(probe=(st == _CircuitBreaker.HALF_OPEN))
            if eng.live_count() > 0:
                with self._wake:
                    depth = len(self._queue)
                self._apply_spec_degradation(self._degrade_level(depth))
            self._decide("tick", (eng.prefill_chunk_limit, eng.spec_draft_limit,
                                  self._breaker._verdict()))
            self._engine_tick()

    def _decide(self, kind: str, payload) -> None:
        """Over a mesh, send one decision to the replaying ranks before this
        rank runs it (an ``"insert"`` or ``"insert_prefilled"`` with its
        slot and the request's engine arguments, a ``"prefill"`` with
        ``prefill_remote``'s, or a ``"tick"`` with the chunk and spec limits
        and the breaker's verdict), with the slots this rank's clock
        cancelled since the last decision, which they cancel first."""
        if self._control is not None:
            cancels, self._cancelled = self._cancelled, []
            self._control.send((kind, cancels, payload))

    def _on_slot(self, kind: str, payload: Callable[[], tuple]):
        """The engine's ``on_slot`` hook of an admission on the first rank
        over a mesh: the decision with the slot the engine just took and
        ``payload()`` (None elsewhere: a one-process server or a replaying
        rank sends none)."""
        if self._control is None or self._replaying:
            return None
        return lambda slot: self._decide(kind, (slot, payload()))

    # ------------------------------------------------- remote prefill jobs
    def _prefill_in_stream(self, input_ids, **kwargs) -> Future:
        """Queue a remote prompt forward (``engine.prefill_remote`` with
        ``kwargs``) for the serving thread, which runs it between its
        decisions, over a mesh as a ``"prefill"`` decision on every rank.
        The Future resolves to the :class:`~accelerate_tpu_torch.engine
        .RemotePrefill`, or to the error that ended it (a drain fails it
        with :class:`ServerDrainingError`). The fleet's prefill workers
        use it for a replica over a mesh; over a mesh only its first rank
        takes them."""
        if self._replaying:
            raise RuntimeError(
                f"remote prefill on rank {self._control.rank}: the model is served over a mesh, "
                f"whose first rank ({self._control.leader}) runs every remote prefill")
        future: Future = Future()
        with self._wake:
            if self._draining or self._closed or self._engine is None:
                raise ServerDrainingError(self._drain_reason(), replica_id=self.replica_id,
                                          retry_after_s=0.0)
            self._prefills.append((np.asarray(input_ids, np.int32).reshape(-1), kwargs, future))
            self._wake.notify()
        return future

    def _run_prefills(self) -> None:
        """Run the queued remote prompt forwards in order (each a
        ``"prefill"`` decision over a mesh); while draining, fail them."""
        while True:
            with self._wake:
                if not self._prefills:
                    return
                ids, kwargs, future = self._prefills.popleft()
                draining = self._draining
            if draining:
                resolve_future(future, exception=ServerDrainingError(
                    self._drain_reason(), replica_id=self.replica_id, retry_after_s=0.0))
                continue
            try:
                self._decide("prefill", (ids, kwargs))
            except BaseException as exc:  # the worker dies; its waiter must not
                resolve_future(future, exception=exc)
                raise
            try:
                pre = self._engine.prefill_remote(ids, **kwargs)
            except Exception as exc:  # noqa: BLE001 - the caller falls back to a local prefill
                resolve_future(future, exception=exc)
                continue
            resolve_future(future, result=pre)

    def _estimated_completion_s(self, budget: int) -> float:
        """Continuous mode: the EWMA is a tick's time, so a request's
        completion estimate scales with its budget."""
        return self._batch_time_ewma * max(1, budget)

    def _admit_slots(self, probe: bool = False) -> None:
        """Admit queued requests into free slots, each budget clamped by the
        ladder; ``probe`` (a half-open breaker) admits at most one."""
        eng = self._engine
        limit = 1 if probe else eng.free_slots()
        admitted = 0
        while admitted < limit and eng.free_slots() > 0:
            with self._wake:
                if not self._queue:
                    return
                now = self._clock()
                req = self._queue.popleft()
                level = self._degrade_level(len(self._queue) + 1)
                self.metrics.gauge("queue_depth", len(self._queue))
            if (req.deadline is not None
                    and now + self._estimated_completion_s(req.max_new_tokens) > req.deadline):
                self._shed(req, now)
                continue
            # the clamp is this request's slot budget alone: degradation
            # never touches a slot already decoding
            self._clamp_budget(req, level)
            # paged KV: a free slot is not enough, the blocks must be free
            # too; requeue at the head and retry after retirements
            if not eng.can_admit(req.input_ids, req.effective_max_new_tokens):
                with self._wake:
                    self._queue.appendleft(req)
                    self.metrics.gauge("queue_depth", len(self._queue))
                return
            if req.degraded:
                self.metrics.bump("degraded")
            if not self._insert(req, now):
                return
            admitted += 1

    def _insert(self, req: _Request, now: float = 0.0, slot: Optional[int] = None) -> bool:
        """Admit ``req`` into a slot (on a replaying rank, ``slot``: the one
        the first rank named); False when the engine failed (its requests
        failed, its state rebuilt)."""
        try:
            fault_point("serving_before_batch", replica=self.replica_id)
            with tracing.span("serving.admit", trace_id=req.trace_id,
                              queue_wait_s=max(0.0, now - req.submitted_at),
                              degraded=req.degraded) as sp:
                if self._insert_prefilled(req, slot):
                    sp.set("path", "insert_prefilled")
                else:
                    sp.set("path", "insert")
                    self._engine.insert(
                        req.input_ids, max_new_tokens=req.effective_max_new_tokens,
                        temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                        eos_token_id=req.eos_token_id, pad_token_id=req.pad_token_id,
                        seed=req.seed, tag=req, slot=slot,
                        on_slot=self._on_slot("insert", lambda: _engine_args(req)),
                    )
        except BaseException as exc:  # classified below
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                self._fail_batch([req], exc, "worker interrupted mid-insert",
                                 err_cls=ReplicaDeadError)
                raise
            self._engine_failure(exc, also_fail=req)
            return False
        self.metrics.bump("engine_inserts")
        return True

    def _insert_prefilled(self, req: _Request, slot: Optional[int] = None) -> bool:
        """Commit ``req``'s prefill when the engine takes it and its budget
        covers the request's clamped one; True when it did. A transfer
        error (the reservation went stale since the check) counts a
        fallback; a reservation still held is released, so the slot does
        not wait for its TTL. Over a mesh the commit is an
        ``"insert_prefilled"`` decision (:func:`_prefilled_args`)."""
        pre, eng = req.prefill, self._engine
        if pre is None:
            return False
        if req.effective_max_new_tokens <= pre.max_new_tokens and eng.accepts_prefill(pre):
            try:
                eng.insert_prefilled(
                    pre, max_new_tokens=req.effective_max_new_tokens, tag=req, slot=slot,
                    on_slot=self._on_slot("insert_prefilled", lambda: _prefilled_args(req)))
                return True
            except KVTransferError:
                self.metrics.bump("prefill_commit_fallbacks")
        if getattr(pre, "reservation", None) is not None:
            eng.release_reservation(*pre.reservation)
        return False

    def _loop_replay_continuous(self) -> None:
        """A rank other than the mesh's first in continuous mode: apply each
        decision the first rank sends, in order, until its stop: its
        cancels, then the admission (a request without a deadline, with the
        first rank's clamped budget) or the tick (the limits and the
        breaker's verdict, then :meth:`_engine_tick`). An engine failure
        here is the first rank's too (the same calls over the same
        collectives), which rebuilds its engine as this one does; a failure
        on this rank alone leaves the first rank inside a collective until
        the process group's own timeout, and this rank, hearing nothing,
        takes it as lost. Raises :class:`ReplicaDeadError` when the first
        rank is lost."""
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
            if kind in ("insert", "insert_prefilled"):
                slot, args = payload
                ids, budget, temp, top_k, top_p, eos, pad, seed = args[:8]
                self._insert(_Request(input_ids=ids, max_new_tokens=budget, deadline=None,
                                      temperature=temp, top_k=top_k, top_p=top_p,
                                      eos_token_id=eos, pad_token_id=pad, seed=seed,
                                      submitted_at=0.0, effective_max_new_tokens=budget,
                                      prefill=(_window_receiver(eng, args)
                                               if kind == "insert_prefilled" else None)),
                             slot=slot)
            elif kind == "prefill":
                ids, kwargs = payload
                try:  # the first rank's result is the one its fleet takes
                    eng.prefill_remote(ids, **kwargs)
                except Exception:  # noqa: BLE001 - the first rank fails it alike
                    logger.exception("replayed remote prefill failed")
            else:
                eng.set_prefill_chunk_limit(payload[0])
                eng.set_spec_draft_limit(payload[1])
                self._breaker._adopt(payload[2])
                self._engine_tick()

    def _engine_tick(self) -> None:
        """One engine step (pending chunks, then a decode or verify step),
        the ring's readback, the retirements' replies and the mid-decode
        deadline shed."""
        eng = self._engine
        if eng.live_count() == 0:
            # nothing decoding: read back what the ring still holds
            self._reply_retired(eng.poll(force=True))
            return
        try:
            t0 = self._clock()
            eng.step()
            retired = eng.poll()
            dt = self._clock() - t0
            fault_point("serving_after_batch", replica=self.replica_id)
        except BaseException as exc:  # classified below
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                self._fail_batch([o.tag for o in eng.reset()], exc, "worker interrupted mid-step",
                                 err_cls=ReplicaDeadError)
                raise
            self._engine_failure(exc)
            return
        self.metrics.bump("engine_steps")
        self._sync_kv_gauges()
        if not self._replaying:
            self._breaker.record_success()
        self._batch_time_ewma = (dt if self._batch_time_ewma == 0.0
                                 else 0.8 * self._batch_time_ewma + 0.2 * dt)
        self._reply_retired(retired)
        if self._replaying:
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
                        f"deadline passed {now - req.deadline:.3f}s ago mid-decode; slot freed",
                        replica_id=self.replica_id)):
                    self.metrics.bump("shed_deadline")

    def _reply_retired(self, retired: list) -> None:
        """Resolve the futures of the occupants the ring just retired. The
        tokens exist, so a failure here fails these requests instead of
        stranding them."""
        if not retired:
            return
        reqs = [occ.tag for occ in retired]
        try:
            fault_point("serving_before_reply", replica=self.replica_id)
            now = self._clock()
            occupancy = self._engine.live_count() + len(retired)
            for occ in retired:
                req = occ.tag
                self.metrics.bump("engine_retired")
                if req.deadline is not None and now > req.deadline:
                    if resolve_future(req.future, exception=RequestDeadlineExceeded(
                            f"decode finished {now - req.deadline:.3f}s past the deadline",
                            replica_id=self.replica_id)):
                        self.metrics.bump("completed_late")
                    continue
                latency = now - req.submitted_at
                ttft = ((occ.first_token_s - req.submitted_at) if occ.first_token_s is not None
                        else latency)
                queued = max(0.0, occ.inserted_s - req.submitted_at)
                result = ServingResult(
                    tokens=occ.output_row(), latency_s=latency, batch_size=occupancy,
                    degraded=req.degraded, ttft_s=max(0.0, ttft), replica_id=self.replica_id,
                    queue_wait_s=queued,
                    prefill_s=(max(0.0, occ.first_token_s - occ.inserted_s)
                               if occ.first_token_s is not None else None),
                    decode_steps=occ.decode_steps,
                )
                if resolve_future(req.future, result=result):
                    self.metrics.bump("completed")
                    self.metrics.latency.add(latency)
                    self.metrics.ttft.add(max(0.0, ttft))
                    self.metrics.queue_wait.add(queued)
        except BaseException as exc:  # never strand a retiree
            self._fail_batch(reqs, exc, "decode finished but the reply failed")
            if isinstance(exc, (KeyboardInterrupt, SystemExit)):
                raise
            logger.exception("continuous reply epilogue failed; the retired slots' futures "
                             "were failed")

    def _sync_kv_gauges(self) -> None:
        """Publish the engine's KV health (pool bytes, token utilisation,
        prefix hit rate, the host tier's traffic) and speculative acceptance
        as serving gauges, with the whole ``engine.stats()`` tree folded in
        under ``serving/engine/...``."""
        stats = self._engine.stats()
        self.metrics.registry.ingest(stats, prefix="engine")
        kv = stats.get("kv")
        if kv:
            self.metrics.gauge("kv_hbm_bytes", kv.get("hbm_bytes", 0))
            self.metrics.gauge("kv_utilization", kv.get("utilization", 0.0))
            hits = kv.get("prefix_hits", 0)
            misses = kv.get("prefix_misses", 0)
            if hits + misses:
                self.metrics.gauge("prefix_hit_rate", hits / (hits + misses))
            if "host_tier_bytes" in kv:
                self.metrics.gauge("kv_host_tier_bytes", kv["host_tier_bytes"])
                self.metrics.gauge("kv_host_tier_blocks", kv.get("host_tier_blocks", 0))
                self.metrics.gauge("kv_restore_hits", kv.get("restore_hits", 0))
                self.metrics.gauge("kv_restore_bytes", kv.get("restore_bytes", 0))
                self.metrics.gauge("kv_spill_bytes", kv.get("spill_bytes", 0))
        if "prefill_chunks_pending" in stats:
            self.metrics.gauge("prefill_chunks_pending", stats["prefill_chunks_pending"])
        spec = stats.get("spec")
        if spec and spec.get("mode") != "off":
            self.metrics.gauge("spec_acceptance_rate", spec.get("acceptance_rate", 0.0))
            self.metrics.gauge("spec_tokens_per_step", spec.get("tokens_per_step", 0.0))

    def _engine_failure(self, exc: BaseException, also_fail=None) -> None:
        """An engine program raised: its in-flight state cannot be trusted,
        so fail every request it held, rebuild the engine state, and let the
        breaker gate admission (over a mesh, the first rank's breaker)."""
        self.metrics.bump("batch_failures")
        if not self._replaying and self._breaker.record_failure():
            self.metrics.bump("breaker_opens")
            logger.warning("circuit breaker OPEN after %d consecutive engine failures (last: %s)",
                           self.config.breaker_threshold, exc)
        victims = [o.tag for o in self._engine.reset()]
        if also_fail is not None:
            victims.append(also_fail)
        if victims:
            self._fail_batch(victims, exc,
                             f"engine program failed; {len(victims)} in-flight request(s) lost")
        logger.warning("engine failure reset the KV store (%d in-flight request(s) failed): %s: %s",
                       len(victims), type(exc).__name__, exc)

    def _reject_queued(self) -> None:
        with self._lock:
            queued, self._queue = list(self._queue), collections.deque()
            prefills, self._prefills = list(self._prefills), collections.deque()
            self.metrics.gauge("queue_depth", 0)
        for _, _, future in prefills:
            resolve_future(future, exception=ServerDrainingError(
                self._drain_reason(), replica_id=self.replica_id, retry_after_s=0.0))
        for req in queued:
            if resolve_future(req.future, exception=ServerDrainingError(
                    self._drain_reason(), replica_id=self.replica_id, retry_after_s=0.0)):
                self.metrics.bump("rejected_draining")

    # -------------------------------------------------------------- metrics
    def _flush_due(self) -> bool:
        return bool(self.trackers) and self.metrics.registry.due(self.config.metrics_interval_s)

    def _flush_metrics(self, force: bool = False) -> None:
        """The periodic tracker flush (the registry keeps the cadence and
        the ``log_batch`` bridge), always with the server lock released."""
        if not self.trackers:
            return
        reg = self.metrics.registry
        if force or reg.due(self.config.metrics_interval_s):
            self.metrics.gauge("breaker_state", self._breaker.state())
            reg.flush(self.trackers)

    def log_metrics(self, step: Optional[int] = None, trackers: Optional[Sequence] = None):
        """Push one metrics snapshot through ``GeneralTracker.log_batch``
        (beside the periodic flush); returns the snapshot."""
        self.metrics.gauge("breaker_state", self._breaker.state())
        snapshot = self.metrics.snapshot()
        for tracker in trackers if trackers is not None else self.trackers:
            tracker.log_batch([(snapshot, step, {})])
        return snapshot

