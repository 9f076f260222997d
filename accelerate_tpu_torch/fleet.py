"""Multi-replica serving fleet: health-probed routing, transparent
failover and zero-drop scale-down (counterpart of
``accelerate_tpu/fleet.py``).

One :class:`~accelerate_tpu_torch.serving.InferenceServer` is one replica;
:class:`FleetRouter` spreads ``submit()`` across several and turns every
single-replica failure the serving layer types into something a client
never sees. Replicas may share one card and one model: each continuous
server has its own engine (its own pool, programs and serving thread) over
the same weights.

* **Placement**: least loaded and deadline-aware: each routable replica is
  scored by its queued and in-flight work times its recent batch-time
  EWMA (from one cheap ``health()`` sample), with KV affinity (a replica
  whose gossiped prefix digest holds the request's prefix scores lower).
  Draining, dead and breaker-open replicas are never candidates.
* **Probes and per-replica breakers**: a prober thread samples every
  replica each ``probe_interval_s``, each read bounded by
  ``probe_timeout_s`` on a thread of its own; the router keeps its own
  :class:`~accelerate_tpu_torch.serving._CircuitBreaker` per replica over
  replica-level failures.
* **Transparent failover**: a replica's death
  (:class:`~accelerate_tpu_torch.utils.fault.ReplicaDeadError`), drain
  (:class:`~accelerate_tpu_torch.utils.fault.ServerDrainingError`) or open
  breaker resubmits the request to a survivor, deciding on the errors'
  ``retriable``/``replica_id`` attributes, never their messages. An
  unplanned failover spends a token of a fleet-wide retry budget, so a
  full outage ends in typed
  :class:`~accelerate_tpu_torch.utils.fault.FailoverExhaustedError`
  answers instead of a retry storm; planned drains spend none, which makes
  scale-down zero-drop.
* **Hedging**: a near-deadline request, or one placed on a browned-out
  replica, is dispatched to a second replica too (first result wins, the
  loser is cancelled); hedges spend budget tokens too.
* **Brown-out**: slow or hanging probes, or a perfwatch ratio well above
  the peers', deprioritise a replica and hedge its in-flight requests; a
  sustained one files a :class:`~accelerate_tpu_torch.utils.fault
  .ReplicaBrownoutError` with perfwatch.
* **Elastic lifecycle**: :meth:`FleetRouter.scale_down` drains a replica
  and redistributes its queue; :meth:`FleetRouter.add_replica`,
  :meth:`FleetRouter.scale_up` and ``auto_respawn`` with a
  ``replica_factory`` add one. Every change goes through a
  :class:`~accelerate_tpu_torch.elastic.FleetMembership` ledger.
* **Disaggregated prefill**: with ``FleetConfig(disaggregate_prefill=
  True)`` prefill worker threads run each continuous-mode request's prompt
  forward (:meth:`~accelerate_tpu_torch.engine.ContinuousBatchingEngine
  .prefill_remote`, on the thread's own CUDA stream) and hand the replica
  the result (``submit(prefilled=)``), by reference or over a KV transport
  (``kvtransfer.py``). A replica over a mesh runs the forward in its
  server's decision stream instead (``InferenceServer._prefill_in_stream``:
  every rank runs it there, in one order with the decode loop's
  collectives), and its receiver runs on its first rank. Its host tier
  takes no replicated hot prefixes: the router reaches only the first
  rank's tier, and a block there alone restores on no rank (the ranks
  restore the chain they all hold).

Fault points (``ACCELERATE_TPU_FAULT_INJECT``, or a conductor):
``fleet_route`` (placement), ``fleet_failover`` (a retriable failure is
about to be resubmitted), ``fleet_probe`` (the prober is about to read one
replica), ``fleet_scale_down`` (a replica is about to be drained out).
"""

from __future__ import annotations

import queue
import threading
import time
import zlib
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np

from . import perfwatch, tracing
from .elastic import FleetMembership
from .logging import get_logger
from .serving import InferenceServer, _CircuitBreaker, resolve_future
from .tracing import MetricsRegistry
from .utils.dataclasses import FleetConfig
from .utils.fault import (
    FailoverExhaustedError,
    NoHealthyReplicaError,
    ReplicaBrownoutError,
    RequestDeadlineExceeded,
    ServerDrainingError,
    ServingError,
    TransferStaleEpochError,
    fault_point,
)

logger = get_logger(__name__)

__all__ = ["FleetRouter", "FleetMetrics", "ReplicaHandle"]


def _over_mesh(engine) -> bool:
    """Whether a replica's engine runs a model laid over a mesh."""
    return getattr(engine, "_view", None) is not None


def _detached_block(payload):
    """A host-tier payload's copy in memory of its own (no slab slot)."""
    from .kvcache import _HostBlock, _map_leaves

    return _HostBlock(_map_leaves(lambda t: t.clone(), payload))


# --------------------------------------------------------------- retry budget
class _TokenBucket:
    """Fleet-wide retry/hedge budget: ``capacity`` tokens refilled at
    ``refill_per_s``. A failover or hedge that cannot take a token is
    denied — the storm-control backstop that bounds how much *extra* work
    an outage can inject into the surviving replicas."""

    def __init__(self, capacity: int, refill_per_s: float, clock: Callable[[], float]):
        self.capacity = float(capacity)
        self.refill_per_s = float(refill_per_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = float(capacity)
        self._last = clock()

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(
            self.capacity, self._tokens + (now - self._last) * self.refill_per_s
        )
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def available(self) -> float:
        with self._lock:
            self._refill_locked()
            return self._tokens


# -------------------------------------------------------------------- metrics
class FleetMetrics:
    """Thread-safe fleet counters (monotonic) + gauges; :meth:`snapshot`
    flattens everything into one ``fleet/...`` dict, the router-level twin
    of :class:`~accelerate_tpu_torch.serving.ServingMetrics` — and, like it, a
    thin facade over one :class:`~accelerate_tpu_torch.tracing.MetricsRegistry`
    (which owns the lock and the periodic tracker-flush cadence, so that
    logic lives in exactly one place)."""

    _COUNTERS = (
        "submitted",
        "completed",
        "failed",
        "routed",
        "rejected_no_replica",
        "failovers",
        "redistributed",  # failovers caused by planned drains (scale-down)
        "failover_denied_budget",
        "failover_denied_cap",
        "hedges",
        "hedge_wins",
        "probes",
        "probe_failures",
        "probe_timeouts",  # a health() read overran probe_timeout_s
        "brownouts",  # healthy -> brown-out transitions
        "brownout_clears",  # brown-out -> healthy transitions (hysteresis)
        "brownout_findings",  # sustained brown-out filed for replacement
        "respawns",
        "respawn_failures",  # replica_factory raised (crash-looping factory)
        "replicas_added",
        "replicas_removed",
        "prefills",  # prompt forwards run on dedicated prefill workers
        # disaggregation fallbacks, split by typed reason so a silent
        # transfer regression can't hide inside one aggregate:
        "prefill_fallback/unavailable",  # no engine / no prefill_remote
        "prefill_fallback/transfer_failed",  # wire transfer died (typed)
        "prefill_fallback/stale_epoch",  # slot recycled mid-transfer
        "kv_transfers",  # RemotePrefills shipped over a transport
        "kv_transfer_retries",  # re-attempts (budget-gated)
        "kv_affinity_hits",  # placements that landed on a prefix holder
        "hot_prefix_replicas",  # hot prefix blocks copied across tiers
    )

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self.registry = MetricsRegistry(
            prefix="fleet/", counters=self._COUNTERS, clock=clock
        )
        for name in ("replicas", "routable_replicas", "retry_budget"):
            self.registry.gauge(name, 0.0)

    def bump(self, name: str, by: int = 1) -> None:
        self.registry.bump(name, by)

    def gauge(self, name: str, value: float) -> None:
        self.registry.gauge(name, value)

    def __getitem__(self, name: str) -> int:
        return self.registry[name]

    def snapshot(self) -> dict:
        return self.registry.snapshot()


# ------------------------------------------------------------ replica handles
@dataclass
class ReplicaHandle:
    """Router-side record of one replica: the server, the router's breaker
    over replica-level failures, and load/lifecycle bookkeeping."""

    replica_id: str
    server: InferenceServer
    breaker: _CircuitBreaker
    outstanding: int = 0  # requests routed here and not yet resolved
    generation: int = 0  # bumped on every supervisor respawn
    leaving: bool = False  # scale-down in progress; never a candidate
    last_respawn_s: float = float("-inf")
    completed: int = 0
    failed: int = 0
    # the replica's own ``retry_after_s`` hint (ServerOverloaded /
    # CircuitOpenError): not a placement candidate until this clock time,
    # while any alternative exists — the replica told us when to come back
    backoff_until_s: float = 0.0
    # --- gray-failure / brown-out state.
    # Written by the prober (and the controller's timeout-bounded health
    # reads), read by placement/hedging under the router lock.
    brownout: bool = False  # quarantined: slow/flaky, not dead
    brownout_since_s: float = 0.0  # router-clock time the episode began
    brownout_score: float = 0.0  # >= 1.0 engages; hysteresis clears
    brownout_reported: bool = False  # one drain finding per episode
    probe_ewma_s: float = 0.0  # EWMA of health() wall latency
    probe_hung: bool = False  # the in-flight probe overran its timeout
    perf_ratio: float = 0.0  # worst perf/<prog>/ratio in its last snapshot
    last_health: Optional[dict] = None  # last completed health sample
    probe_state: Any = None  # in-flight _Probe (single-flight)
    respawn_failures: int = 0  # consecutive factory failures
    # gossiped KV prefix-registry digest (crc32s of the replica's cached
    # block-aligned prefixes, from its last probe) — the KV-affinity
    # placement signal. A set for O(1) membership in _score.
    prefix_digest: frozenset = frozenset()
    prefix_block: int = 0  # the replica's KV block size (digest slicing)
    # live _FleetRequests routed here (keyed by object id — the request
    # dataclass is by-value-eq, hence unhashable) — the brown-out hedge
    # source
    inflight: dict = field(default_factory=dict)


@dataclass
class _FleetRequest:
    """One request's router-side lifetime (the client holds ``future``)."""

    input_ids: np.ndarray
    max_new_tokens: Optional[int]
    deadline: Optional[float]  # absolute, router clock domain
    temperature: float
    top_k: Optional[int]
    top_p: Optional[float]
    eos_token_id: Optional[int]
    pad_token_id: Optional[int]
    seed: int
    submitted_at: float
    future: Future = field(default_factory=Future)
    lock: threading.Lock = field(default_factory=threading.Lock)
    failovers: int = 0
    hedged: bool = False
    # replica ids that FAILED this request (excluded from re-placement
    # while any alternative exists)
    tried: set = field(default_factory=set)
    # pending (handle, inner_future) pairs — losers cancelled on delivery
    inner: list = field(default_factory=list)
    # root trace ID minted at router admission; every dispatch (including
    # failover re-dispatches and remote prefills) submits under it, so one
    # trace shows the request's whole fleet lifetime
    trace_id: Optional[str] = None

    def submit_kwargs(
        self, remaining_deadline: Optional[float], arrival_s: Optional[float]
    ) -> dict:
        return dict(
            max_new_tokens=self.max_new_tokens,
            deadline_s=remaining_deadline,
            temperature=self.temperature,
            top_k=self.top_k,
            top_p=self.top_p,
            eos_token_id=self.eos_token_id,
            pad_token_id=self.pad_token_id,
            seed=self.seed,
            arrival_s=arrival_s,
            trace_id=self.trace_id,
        )


class _Probe:
    """One single-flight, timeout-bounded health read of one replica.

    The actual ``health()`` + ``metrics_snapshot()`` calls run on a
    dedicated daemon thread; waiters block on :attr:`done` with a
    deadline. A hung replica leaves its probe thread parked (released by
    the hang latch or the replica's eventual answer) while every waiter
    moves on with the cached sample — the prober pass and the SLO
    controller's observation tick are bounded by ``probe_timeout_s`` no
    matter what one replica does. Single-flight: a still-running probe is
    joined, never duplicated, so a wedged replica accumulates exactly one
    parked thread, not one per tick."""

    __slots__ = (
        "done", "health", "snap", "digest", "error", "started_s", "elapsed_s",
    )

    def __init__(self):
        self.done = threading.Event()
        self.health: Optional[dict] = None
        self.snap: Optional[dict] = None
        self.digest: Optional[dict] = None  # kv_prefix_digest() gossip
        self.error: Optional[BaseException] = None
        # real wall clock, not the injected router clock: probe latency is
        # a measured property of the replica, not of simulated time
        self.started_s = time.monotonic()
        self.elapsed_s = 0.0


# --------------------------------------------------------------------- router
class FleetRouter:
    """Spread ``submit()`` across N :class:`~accelerate_tpu_torch.serving
    .InferenceServer` replicas with health-probed, least-loaded +
    deadline-aware placement, transparent failover under a fleet-wide
    retry budget, optional hedged dispatch, and zero-drop elastic
    scale-down (the module docstring).

    Parameters
    ----------
    replicas:
        ``{replica_id: InferenceServer}`` (or a sequence of servers, keyed
        by each server's own ``replica_id`` when set, else
        ``replica-0..N-1``). May be empty — add replicas later via
        :meth:`add_replica`.
    config:
        :class:`~accelerate_tpu_torch.utils.dataclasses.FleetConfig`.
    membership:
        A shared :class:`~accelerate_tpu_torch.elastic.FleetMembership` ledger
        (``None`` builds a private one). Every add/remove/respawn goes
        through it.
    replica_factory:
        ``factory(replica_id) -> InferenceServer`` used by ``auto_respawn``
        to relaunch a replica whose worker died (supervisor-style
        scale-up) and by :meth:`scale_up`.
    clock:
        Monotonic time source (injectable for deterministic tests).

    ``submit()`` always returns a Future (placement, prefill, hedging and
    failover all complete asynchronously); admission-time failures resolve
    it with the typed error instead of raising — except structural
    ``ValueError`` (bad prompt shape), which raises synchronously when
    placement happens inline.
    """

    def __init__(
        self,
        replicas=None,
        config: Optional[FleetConfig] = None,
        *,
        membership: Optional[FleetMembership] = None,
        replica_factory: Optional[Callable[[str], InferenceServer]] = None,
        clock: Callable[[], float] = time.monotonic,
        trackers=(),
    ):
        self.config = config or FleetConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._handles: Dict[str, ReplicaHandle] = {}
        self._closed = False
        self._rr = 0
        self._replica_factory = replica_factory
        self._membership = membership if membership is not None else FleetMembership()
        self.trackers = list(trackers)
        self.metrics = FleetMetrics(clock=clock)
        self._budget = _TokenBucket(
            self.config.retry_budget_capacity,
            self.config.retry_budget_refill_per_s,
            clock,
        )
        # the KV wire (kvtransfer.py): transfers spend the
        # SAME retry budget as failovers — a transfer storm and an outage
        # storm draw down one shared allowance
        self._kvtx = None
        if self.config.kv_transfer is not None:
            from .kvtransfer import KVTransferManager

            self._kvtx = KVTransferManager(
                transport=self.config.kv_transfer,
                chunk_bytes=self.config.kv_transfer_chunk_bytes,
                chunk_deadline_s=self.config.kv_transfer_chunk_deadline_s,
                retries=self.config.kv_transfer_retries,
                backoff_s=self.config.kv_transfer_backoff_s,
                budget=self._budget,
                clock=clock,
                on_retry=lambda: self.metrics.bump("kv_transfer_retries"),
            )
        if isinstance(replicas, dict):
            items = list(replicas.items())
        elif replicas:
            # A server that already carries a replica_id keeps it as its
            # handle key — otherwise results/typed errors would attribute
            # to a name scale_down()/stats() has never heard of.
            items = [
                (getattr(srv, "replica_id", None) or f"replica-{i}", srv)
                for i, srv in enumerate(replicas)
            ]
        else:
            items = []
        for replica_id, server in items:
            self.add_replica(replica_id, server)
        self._stop = threading.Event()
        # extra flat-dict sources merged into metrics_snapshot() — the SLO
        # controller attaches its controller/... registry here so one
        # scrape (and one flight dump) carries decisions + telemetry
        self.extra_metrics: list = []
        self._prefill_q: "queue.Queue" = queue.Queue()
        self._prefill_threads: list = []
        if self.config.disaggregate_prefill:
            for i in range(self.config.prefill_workers):
                t = threading.Thread(
                    target=self._prefill_loop, name=f"fleet-prefill-{i}",
                    daemon=True,
                )
                t.start()
                self._prefill_threads.append(t)
        self._prober = threading.Thread(
            target=self._probe_loop, name="fleet-probe", daemon=True
        )
        self._prober.start()
        # the fleet-wide metrics endpoint (perfwatch.py): the prober
        # aggregates every replica's snapshot into this router's registry,
        # so ONE scrape carries goodput, per-class latency percentiles, KV
        # utilization, prefix hit rate, spec acceptance, breaker states and
        # the retry-budget level for the whole fleet. Armed only by
        # ACCELERATE_METRICS_PORT (off by default).
        self._exporter = perfwatch.maybe_exporter(self.metrics_snapshot)

    # ------------------------------------------------------------- lifecycle
    @property
    def membership(self) -> FleetMembership:
        return self._membership

    def replica_ids(self) -> list:
        with self._lock:
            return sorted(self._handles)

    def add_replica(self, replica_id: str, server: InferenceServer) -> None:
        """Register a replica (scale-up). The server is stamped with the
        ``replica_id`` if it does not already carry one, so its typed
        errors and results attribute correctly."""
        if self._closedf():
            raise ServerDrainingError("fleet router is closed")
        if getattr(server, "replica_id", None) is None:
            server.replica_id = replica_id
        handle = ReplicaHandle(
            replica_id=replica_id,
            server=server,
            breaker=_CircuitBreaker(
                self.config.breaker_threshold,
                self.config.breaker_reset_s,
                self._clock,
            ),
        )
        with self._lock:
            if replica_id in self._handles:
                raise ValueError(f"replica {replica_id!r} already registered")
            self._handles[replica_id] = handle
        if self._kvtx is not None and server.engine is not None:
            self._kvtx.register(replica_id, server)
        self.metrics.bump("replicas_added")
        self._membership.join(
            replica_id,
            {"mode": server.config.mode, "generation": handle.generation},
        )

    @property
    def can_scale(self) -> bool:
        """Whether replica-count actuations (``scale_up``, the SLO
        controller's surge/replace moves) are possible — i.e. a
        ``replica_factory`` was provided."""
        return self._replica_factory is not None

    def scale_up(self, replica_id: str) -> InferenceServer:
        """Launch a replica via ``replica_factory`` and register it."""
        if self._replica_factory is None:
            raise ValueError("scale_up requires a replica_factory")
        server = self._replica_factory(replica_id)
        self.add_replica(replica_id, server)
        return server

    def scale_down(self, replica_id: str, timeout: Optional[float] = None) -> bool:
        """Elastic scale-down with ZERO dropped work: stop placing onto the
        replica, record the membership leave, then drain it — in-flight
        requests finish and reply; queued-but-unbatched requests fail with
        retriable :class:`~accelerate_tpu_torch.utils.fault.ServerDrainingError`,
        which the per-request callbacks transparently resubmit to the
        surviving replicas (exempt from the retry budget: an orderly drain
        fails each request exactly once). Returns True when the drain
        finished within ``timeout`` (default ``config.drain_timeout_s``)."""
        fault_point("fleet_scale_down", replica=replica_id)
        with self._lock:
            handle = self._handles.get(replica_id)
            if handle is None:
                raise ValueError(f"unknown replica {replica_id!r}")
            handle.leaving = True
        self._membership.leave(replica_id)
        self.metrics.bump("replicas_removed")
        ok = handle.server.drain(
            self.config.drain_timeout_s if timeout is None else timeout
        )
        handle.server.close(drain=False)
        if self._kvtx is not None:
            # after close: a late in-flight transfer fails typed on the
            # sender and falls back, never lands in a dead replica
            self._kvtx.unregister(replica_id)
        with self._lock:
            self._handles.pop(replica_id, None)
        return ok

    def _closedf(self) -> bool:
        with self._lock:
            return self._closed

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> None:
        """Stop routing, stop the prober and prefill workers, and close
        every replica (draining by default). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            handles = list(self._handles.values())
        self._stop.set()
        for _ in self._prefill_threads:
            self._prefill_q.put(None)
        for t in self._prefill_threads:
            t.join(timeout=5.0)
        self._prober.join(timeout=5.0)
        if self._kvtx is not None:
            self._kvtx.close()
        if self._exporter is not None:
            self._exporter.close()
            self._exporter = None
        for handle in handles:
            try:
                handle.server.close(drain=drain, timeout=timeout)
            except Exception as exc:  # noqa: BLE001 — close every replica regardless
                logger.warning(
                    "fleet close: replica %s close failed: %s: %s",
                    handle.replica_id, type(exc).__name__, exc,
                )
            self._membership.leave(handle.replica_id)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ------------------------------------------------------------- admission
    def submit(
        self,
        input_ids,
        *,
        max_new_tokens: Optional[int] = None,
        deadline_s: Optional[float] = None,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_token_id: Optional[int] = None,
        pad_token_id: Optional[int] = None,
        seed: int = 0,
    ) -> Future:
        """Route one request into the fleet; returns a Future resolving to
        :class:`~accelerate_tpu_torch.serving.ServingResult` (its ``replica_id``
        names the replica that served it) or raising the typed serving
        error that ended it. Unlike a single server's ``submit``, placement
        failures (no healthy replica, every queue full) resolve the Future
        instead of raising — failover, hedging, and disaggregated prefill
        all complete asynchronously, so the Future is the one uniform
        contract."""
        if self._closedf():
            raise ServerDrainingError("fleet router is closed")
        self.metrics.bump("submitted")
        ids = np.asarray(input_ids, dtype=np.int32)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1 or ids.shape[0] == 0:
            raise ValueError(
                f"input_ids must be a non-empty 1-D prompt, got {ids.shape}"
            )
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        freq = _FleetRequest(
            input_ids=ids,
            max_new_tokens=max_new_tokens,
            deadline=(now + deadline_s) if deadline_s is not None else None,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            eos_token_id=eos_token_id,
            pad_token_id=pad_token_id,
            seed=seed,
            submitted_at=now,
            trace_id=(
                tracing.new_trace_id() if tracing.get_tracer().enabled else None
            ),
        )
        try:
            with tracing.span(
                "fleet.submit", trace_id=freq.trace_id,
                prompt_len=int(ids.shape[0]),
            ):
                self._dispatch(freq)
        except ServingError as exc:
            if isinstance(exc, NoHealthyReplicaError):
                self.metrics.bump("rejected_no_replica")
            if self._finish(freq, exception=exc):
                self.metrics.bump("failed")
        return freq.future

    def generate(self, input_ids, *, timeout: Optional[float] = None, **kwargs):
        """Blocking convenience wrapper: ``submit(...).result().tokens``."""
        return self.submit(input_ids, **kwargs).result(timeout=timeout).tokens

    # ------------------------------------------------------------- placement
    def _candidates(self, exclude=frozenset()) -> list:
        """Routable replicas (with their health samples): not leaving, not
        draining, worker alive, router breaker not OPEN, replica's own
        breaker not OPEN, not in ``exclude``, not inside a
        ``retry_after_s`` backoff window it asked for. A replica sitting
        out its hinted backoff is preferred over rejecting outright: when
        honoring every hint would leave NO candidate, the backed-off set
        is returned instead (an overloaded replica beats
        NoHealthyReplicaError)."""
        now = self._clock()
        with self._lock:
            handles = list(self._handles.values())
        out, backed_off = [], []
        for h in handles:
            if h.leaving or h.replica_id in exclude:
                continue
            if h.breaker.rejects_admission:
                continue
            # Route on the prober's cached sample, NEVER an inline
            # health() call: a wedged health endpoint must park only the
            # timeout-bounded probe thread, not whoever is placing work
            # (including the prober's own routable gauge — an inline call
            # here raced the hang once and froze brown-out detection).
            # Staleness is one probe interval and is absorbed by the
            # admission-refusal spillover and failover paths; the ONE
            # blocking touch is bootstrap, before the first probe lands.
            hh = h.last_health
            if hh is None:
                if h.probe_hung:
                    continue  # hung before ever answering: unroutable
                try:
                    hh = h.server.health()
                except Exception:  # noqa: BLE001 — an unprobeable replica is unroutable
                    continue
            if hh["draining"] or not hh["worker_alive"]:
                continue
            if hh["breaker_state"] == _CircuitBreaker.OPEN:
                continue
            if h.backoff_until_s > now:
                backed_off.append((h, hh))
                continue
            out.append((h, hh))
        return out or backed_off

    def _score(self, handle: ReplicaHandle, health: dict) -> float:
        """Estimated completion cost: outstanding work × recent batch-time
        EWMA. With no deadline this still orders by load (the EWMA floor
        keeps the product monotonic in load). A browned-out replica's
        score is multiplied by ``brownout_placement_penalty`` — still
        routable (it is not dead, and it may be the only replica) but
        last resort while any healthy candidate exists."""
        load = max(handle.outstanding, health["queue_depth"] + health["inflight"])
        score = (load + 1) * max(health["batch_ewma_s"], 1e-4)
        if handle.brownout:
            score *= self.config.brownout_placement_penalty
        return score

    def _prefix_crcs(self, prompt: np.ndarray, block: int) -> frozenset:
        """crc32 of every full block-aligned prefix of ``prompt``, sliced
        exactly like :class:`~accelerate_tpu_torch.kvcache.PagedBlockPool`'s
        registry keys (``prompt[:(d+1)*B].tobytes()``) — the request-side
        half of the KV-affinity match."""
        ids = np.ascontiguousarray(np.asarray(prompt, dtype=np.int32))
        return frozenset(
            zlib.crc32(ids[: (d + 1) * block].tobytes()) & 0xFFFFFFFF
            for d in range(len(ids) // block)
        )

    def _has_affinity(self, handle: ReplicaHandle, freq: _FleetRequest,
                      cache: dict) -> bool:
        if not handle.prefix_digest or handle.prefix_block <= 0:
            return False
        crcs = cache.get(handle.prefix_block)
        if crcs is None:
            crcs = cache[handle.prefix_block] = self._prefix_crcs(
                freq.input_ids, handle.prefix_block
            )
        return bool(crcs & handle.prefix_digest)

    def _order(self, cands: list, freq: _FleetRequest) -> list:
        if self.config.placement == "round_robin":
            with self._lock:
                self._rr += 1
                rot = self._rr % len(cands)
            return cands[rot:] + cands[:rot]
        if self.config.kv_affinity:
            # KV-affinity: a replica whose gossiped prefix registry
            # already holds this request's block-aligned prefix gets its
            # load score multiplied DOWN by kv_affinity_weight — the
            # request lands where its KV lives (prefix blocks dedup via
            # COW instead of recomputing), unless that replica is
            # overloaded enough for raw load to win anyway
            cache: dict = {}
            return sorted(
                cands,
                key=lambda ch: self._score(ch[0], ch[1]) * (
                    self.config.kv_affinity_weight
                    if self._has_affinity(ch[0], freq, cache) else 1.0
                ),
            )
        return sorted(cands, key=lambda ch: self._score(ch[0], ch[1]))

    def _dispatch(self, freq: _FleetRequest) -> None:
        """Place (or re-place, on failover) one request. Synchronous
        admission rejections walk down the candidate order — spillover is
        routing, not retry, so it spends no budget; it is bounded by the
        candidate count. Raises a typed ServingError when nobody admits."""
        fault_point("fleet_route")
        now = self._clock()
        if freq.deadline is not None and now >= freq.deadline:
            raise RequestDeadlineExceeded(
                f"deadline passed {now - freq.deadline:.3f}s ago before "
                "placement"
            )
        cands = self._candidates(exclude=freq.tried)
        if not cands and freq.tried:
            # every survivor already failed this request once — a replica
            # may have healed (transient overload); retry the full set
            # rather than failing work we could still place
            cands = self._candidates()
        if not cands:
            raise NoHealthyReplicaError(
                "no routable replica (all draining, dead, or breaker-open); "
                "back off and resubmit"
            )
        ordered = self._order(cands, freq)
        last_exc: Optional[ServingError] = None
        for i, (handle, health) in enumerate(ordered):
            try:
                self._submit_to(handle, freq)
            except ServingError as exc:
                self._note_backoff(handle, exc)
                last_exc = exc
                continue
            if self.config.kv_affinity and self._has_affinity(
                handle, freq, {}
            ):
                self.metrics.bump("kv_affinity_hits")
            if i == 0:
                self._maybe_hedge(freq, ordered)
            return
        raise last_exc if last_exc is not None else NoHealthyReplicaError(
            "every routable replica refused admission"
        )

    def _note_backoff(self, handle: ReplicaHandle, exc: BaseException) -> None:
        """Honor a replica's ``retry_after_s`` hint: keep it out of
        placement until the clock time it named (instead of the fixed
        jittered guessing a hint-less error falls back to). A zero hint
        (draining — go elsewhere now) clears any earlier window."""
        hint = getattr(exc, "retry_after_s", None)
        if hint is None:
            return
        until = self._clock() + max(0.0, hint)
        with self._lock:
            handle.backoff_until_s = until if hint > 0 else 0.0

    def _remaining(self, freq: _FleetRequest) -> Optional[float]:
        if freq.deadline is None:
            return None
        return max(1e-3, freq.deadline - self._clock())

    def _arrival(self, freq: _FleetRequest) -> Optional[float]:
        """Back-date the replica's ``submitted_at`` to the router-side
        arrival, so latency/TTFT cover prefill hand-off and failover hops —
        only valid when router and replicas share the monotonic clock
        domain (always true outside clock-injected tests)."""
        return freq.submitted_at if self._clock is time.monotonic else None

    def _use_prefill(self, handle: ReplicaHandle) -> bool:
        if not self.config.disaggregate_prefill:
            return False
        eng = getattr(handle.server, "engine", None)
        return eng is not None and hasattr(eng, "prefill_remote")

    def _submit_to(
        self, handle: ReplicaHandle, freq: _FleetRequest, hedge: bool = False
    ) -> None:
        if self._use_prefill(handle) and not hedge:
            with self._lock:
                handle.outstanding += 1
            self._prefill_q.put((freq, handle))
            return
        # one span per dispatch attempt: a failed-over request shows BOTH
        # attempts under one trace (admission refusals exit this span with
        # the typed error recorded; async failures land on fleet.failover)
        with tracing.span(
            "fleet.dispatch", trace_id=freq.trace_id,
            replica=handle.replica_id, hedge=hedge, attempt=freq.failovers,
        ):
            inner = handle.server.submit(
                freq.input_ids,
                **freq.submit_kwargs(self._remaining(freq), self._arrival(freq)),
            )
        self._track(freq, handle, inner, hedge=hedge)

    def _track(
        self, freq: _FleetRequest, handle: ReplicaHandle, inner: Future,
        hedge: bool = False,
    ) -> None:
        with freq.lock:
            freq.inner.append((handle, inner))
        with self._lock:
            handle.outstanding += 1
            handle.inflight[id(freq)] = freq
        self.metrics.bump("routed")
        inner.add_done_callback(
            lambda f, h=handle, hg=hedge: self._on_inner_done(freq, h, f, hg)
        )

    def _maybe_hedge(self, freq: _FleetRequest, ordered: list) -> None:
        """Hedged dispatch, two triggers: (1) near-deadline — the
        remaining deadline is under ``hedge_deadline_fraction`` × the
        primary's estimated completion; (2) brown-out — placement had to
        put the request on a quarantined replica (every healthy candidate
        refused or scored worse) while a healthy second choice exists,
        so the request is not left stranded on the gray replica. Either
        way: dispatch to the runner-up too, first result wins. Spends a
        retry-budget token so hedging is bounded by the same storm
        control as failover."""
        if freq.hedged or len(ordered) < 2:
            return
        primary, runner_up = ordered[0][0], ordered[1][0]
        if not (
            self.config.hedge_brownout
            and primary.brownout
            and not runner_up.brownout
        ):
            frac = self.config.hedge_deadline_fraction
            if frac is None or freq.deadline is None:
                return
            remaining = freq.deadline - self._clock()
            est = self._score(ordered[0][0], ordered[0][1])
            if remaining >= frac * est:
                return
        if not self._budget.try_acquire():
            return
        freq.hedged = True
        handle = ordered[1][0]
        try:
            with tracing.span(
                "fleet.hedge", trace_id=freq.trace_id,
                replica=handle.replica_id,
            ):
                self._submit_to(handle, freq, hedge=True)
        except ServingError:
            return  # the primary dispatch stands; hedging is best-effort
        self.metrics.bump("hedges")

    # -------------------------------------------------------------- failover
    def _on_inner_done(
        self, freq: _FleetRequest, handle: ReplicaHandle, fut: Future,
        hedge: bool = False,
    ) -> None:
        with self._lock:
            handle.outstanding = max(0, handle.outstanding - 1)
            handle.inflight.pop(id(freq), None)
        if fut.cancelled():
            return  # hedge loser, or client-side cancel
        exc = fut.exception()
        if exc is None:
            handle.breaker.record_success()
            handle.completed += 1
            if self._finish(freq, result=fut.result(), winner=fut):
                self.metrics.bump("completed")
                if hedge:
                    self.metrics.bump("hedge_wins")
            return
        handle.failed += 1
        self._handle_replica_failure(freq, handle, exc)

    def _handle_replica_failure(
        self, freq: _FleetRequest, handle: ReplicaHandle, exc: BaseException
    ) -> None:
        """The machine-readable failover decision (never message prose):
        a retriable typed error from a replica is resubmitted to a
        survivor, under the per-request cap and — for unplanned failures —
        the fleet-wide token bucket. Planned drains are budget-exempt so
        scale-down redistribution can never be starved by outage retries."""
        self._note_backoff(handle, exc)
        if isinstance(exc, ServingError):
            failed_on = exc.replica_id or handle.replica_id
            if not isinstance(exc, (ServerDrainingError, RequestDeadlineExceeded)):
                # drain is lifecycle and deadline is the client's clock —
                # neither says the replica malfunctioned; everything else
                # (dead worker, failed batch, open breaker, overload)
                # counts toward the router's per-replica breaker
                handle.breaker.record_failure()
        else:
            failed_on = handle.replica_id
            handle.breaker.record_failure()
        retriable = isinstance(exc, ServingError) and exc.retriable
        exhausted = False
        # the failover decision is itself a span: its "error" event carries
        # the typed taxonomy (class name, retriable, __cause__ chain), so a
        # flight dump of this trace explains WHY the request moved replicas
        with tracing.span(
            "fleet.failover", trace_id=freq.trace_id,
            replica=failed_on, retriable=retriable,
        ) as sp:
            sp.event(
                "error",
                type=type(exc).__name__,
                retriable=retriable,
                replica_id=failed_on,
                cause=(
                    type(exc.__cause__).__name__
                    if exc.__cause__ is not None
                    else None
                ),
            )
            if not retriable or self._closedf():
                sp.set("outcome", "failed")
                if self._finish(freq, exception=exc):
                    self.metrics.bump("failed")
            elif freq.future.done():
                sp.set("outcome", "hedge_delivered")  # a sibling delivered
            else:
                planned = isinstance(exc, ServerDrainingError)
                with freq.lock:
                    freq.tried.add(failed_on)
                    if freq.failovers >= self.config.max_failovers:
                        denied = "cap"
                    elif planned or self._budget.try_acquire():
                        freq.failovers += 1
                        denied = None
                    else:
                        denied = "budget"
                if denied is not None:
                    sp.set("outcome", f"denied_{denied}")
                    self.metrics.bump(f"failover_denied_{denied}")
                    err = FailoverExhaustedError(
                        f"failover denied ({denied}) after {freq.failovers} "
                        f"attempt(s); last error from replica "
                        f"{failed_on!r}: {type(exc).__name__}: {exc}",
                        replica_id=failed_on,
                    )
                    err.__cause__ = exc
                    if self._finish(freq, exception=err):
                        self.metrics.bump("failed")
                    exhausted = True
                else:
                    fault_point("fleet_failover")
                    sp.set("outcome", "resubmitted")
                    self.metrics.bump("failovers")
                    if planned:
                        self.metrics.bump("redistributed")
                    try:
                        self._dispatch(freq)
                    except (ServingError, ValueError) as exc2:
                        if isinstance(exc2, ServingError):
                            exc2.__cause__ = exc
                        if self._finish(freq, exception=exc2):
                            self.metrics.bump("failed")
        if exhausted:
            # dump AFTER the span closed so the recorder has the error event
            tracing.flight_dump("failover_exhausted")

    def _finish(
        self, freq: _FleetRequest, *, result=None,
        exception: Optional[BaseException] = None, winner: Optional[Future] = None,
    ) -> bool:
        """Resolve the client Future exactly once (race-safe against client
        cancel and hedge siblings); on delivery, cancel every still-pending
        inner future so a hedge loser stops consuming replica capacity as
        soon as it can."""
        if result is not None and hasattr(result, "failover_count"):
            # router-only knowledge: the replica that served the request
            # cannot know how many hops preceded it
            result.failover_count = freq.failovers
        delivered = resolve_future(
            freq.future, result=result, exception=exception
        )
        if delivered and exception is None:
            with freq.lock:
                pending = [f for _h, f in freq.inner if f is not winner]
            for f in pending:
                if not f.done():
                    f.cancel()
        return delivered

    # -------------------------------------------------- prefill worker threads
    def _prefill_loop(self) -> None:
        """Dedicated prefill worker: run the compute-bound prompt forward
        off the decode loop (``prefill_remote``), then hand the decode
        replica a precomputed KV window (``submit(prefilled=...)``) —
        by reference, or over the configured KV transport
        (``config.kv_transfer``) as an epoch-fenced transactional chunk
        stream. Any prefill OR transfer problem falls back to a plain
        submit with a typed reason counter — disaggregation is an
        optimization, never a new failure mode."""
        while True:
            item = self._prefill_q.get()
            if item is None:
                return
            freq, handle = item
            with self._lock:
                handle.outstanding = max(0, handle.outstanding - 1)
            if freq.future.done():
                continue
            pre = None
            eng = getattr(handle.server, "engine", None)
            if eng is not None and hasattr(eng, "prefill_remote"):
                budget = (
                    freq.max_new_tokens
                    if freq.max_new_tokens is not None
                    else handle.server.config.default_max_new_tokens
                )
                kwargs = dict(
                    max_new_tokens=budget,
                    temperature=freq.temperature,
                    top_k=freq.top_k,
                    top_p=freq.top_p,
                    eos_token_id=freq.eos_token_id,
                    pad_token_id=freq.pad_token_id,
                    seed=freq.seed,
                    trace_id=freq.trace_id,
                )
                try:
                    with tracing.span(
                        "fleet.prefill_remote", trace_id=freq.trace_id,
                        replica=handle.replica_id,
                        prompt_len=int(freq.input_ids.shape[0]),
                    ):
                        if _over_mesh(eng):
                            pre = handle.server._prefill_in_stream(
                                freq.input_ids, **kwargs).result()
                        else:
                            pre = eng.prefill_remote(freq.input_ids, **kwargs)
                    self.metrics.bump("prefills")
                except Exception as exc:  # noqa: BLE001 — fall back to plain submit
                    pre = None
                    self.metrics.bump("prefill_fallback/unavailable")
                    logger.warning(
                        "remote prefill failed on %s (%s: %s); falling back "
                        "to in-loop prefill",
                        handle.replica_id, type(exc).__name__, exc,
                    )
                if pre is not None and self._kvtx is not None:
                    pre = self._ship_prefill(pre, freq, handle)
            else:
                self.metrics.bump("prefill_fallback/unavailable")
            try:
                inner = handle.server.submit(
                    freq.input_ids,
                    prefilled=pre,
                    **freq.submit_kwargs(
                        self._remaining(freq), self._arrival(freq)
                    ),
                )
            except ServingError as exc:
                # the replica started draining (or filled up) between
                # placement and prefill completion — the drain-during-
                # failover race; route through the normal failover decision
                self._handle_replica_failure(freq, handle, exc)
            except ValueError as exc:
                if self._finish(freq, exception=exc):
                    self.metrics.bump("failed")
            else:
                self._track(freq, handle, inner)

    def _ship_prefill(self, pre, freq, handle):
        """Push one committed ``RemotePrefill`` through the configured KV
        transport to ``handle``'s receiver and hand back the RECEIVER's
        reconstructed copy (reservation attached, engine_config re-bound)
        for the normal ``submit(prefilled=...)`` path. Any transfer death
        — aborted, corrupt, stale epoch, even an injected fault that
        escapes typed handling — returns ``None``: the request falls back
        to a local prefill with a reason-labeled counter, never a dropped
        future or a dead prefill worker."""
        try:
            tid = self._kvtx.ship(
                pre, handle.replica_id, trace_id=freq.trace_id
            )
            wire_pre = self._kvtx.take(handle.replica_id, tid)
            self.metrics.bump("kv_transfers")
            return wire_pre
        except TransferStaleEpochError as exc:
            self.metrics.bump("prefill_fallback/stale_epoch")
            logger.warning(
                "KV transfer to %s fenced stale (%s); falling back to "
                "in-loop prefill", handle.replica_id, exc,
            )
        except Exception as exc:  # noqa: BLE001 — transfer death must not kill the worker
            self.metrics.bump("prefill_fallback/transfer_failed")
            logger.warning(
                "KV transfer to %s failed (%s: %s); falling back to "
                "in-loop prefill",
                handle.replica_id, type(exc).__name__, exc,
            )
        return None

    # ------------------------------------------------------------ health probes
    def _probe_loop(self) -> None:
        while not self._stop.wait(self.config.probe_interval_s):
            self._probe_pass()
            self._replicate_hot_prefixes()
            # the freshness stamp the SLO controller's fail-static rule
            # reads (controller.py).
            # Stamped EVERY pass: probes are timeout-bounded and
            # concurrent, so one hung replica degrades into a brown-out
            # finding on THAT replica instead of staling this gauge and
            # fail-static-freezing the controller for the whole fleet.
            self.metrics.gauge("last_probe_s", self._clock())
            self.metrics.gauge("retry_budget", self._budget.available())
            with self._lock:
                total = len(self._handles)
            self.metrics.gauge("replicas", total)
            self.metrics.gauge("routable_replicas", len(self._candidates()))
            # same single periodic-flush implementation the serving layer
            # uses: the prober thread, no router lock held
            self.metrics.registry.maybe_flush(
                self.trackers, self.config.metrics_interval_s
            )

    def _replicate_hot_prefixes(self) -> None:
        """Fan each replica's N hottest host-tier prefix blocks out to its
        siblings' tiers (``config.replicate_hot_prefixes``; 0 = off). A
        popular prefix (shared system prompt) then restores WARM on every
        replica, so KV-affinity routing degrades gracefully under
        failover: losing the prefix's home replica does not cold-start the
        prefix fleet-wide. Payloads are immutable committed block bytes —
        sharing the same object across tiers is safe by construction."""
        n = self.config.replicate_hot_prefixes
        if n <= 0:
            return
        with self._lock:
            handles = [h for h in self._handles.values() if not h.leaving]
        tiers = []
        for h in handles:
            eng = getattr(h.server, "engine", None)
            tier = getattr(eng, "kv_host_tier", None)
            if tier is not None and not _over_mesh(eng):
                tiers.append(tier)
        if len(tiers) < 2:
            return
        for src in tiers:
            for key in src.hot_keys(n):
                payload = None
                for dst in tiers:
                    if (
                        dst is src
                        or dst.block_bytes != src.block_bytes
                        or dst.contains(key)
                    ):
                        continue
                    if payload is None:
                        payload = src.lookup(key)
                        if payload is None:
                            break  # evicted between hot_keys and here
                        # the port's tier keeps a spilled block in a slot of
                        # its own pinned slabs, which it recycles once it
                        # drops the block: a sibling gets a copy of its own
                        payload = _detached_block(payload)
                    if dst.insert(key, payload):
                        self.metrics.bump("hot_prefix_replicas")

    def _probe_worker(self, handle: ReplicaHandle, probe: _Probe) -> None:
        """Body of one probe thread: the only place the prober actually
        touches the replica. Runs off the prober loop so a hung
        ``health()`` parks THIS thread, never the pass."""
        try:
            fault_point("fleet_probe", replica=handle.replica_id)
            probe.health = handle.server.health()
            snap_fn = getattr(handle.server, "metrics_snapshot", None)
            if snap_fn is not None:
                probe.snap = snap_fn()
            digest_fn = getattr(handle.server, "kv_prefix_digest", None)
            if digest_fn is not None:
                probe.digest = digest_fn()
        except BaseException as exc:  # noqa: BLE001 — typed triage happens at the collector
            probe.error = exc
        finally:
            probe.elapsed_s = time.monotonic() - probe.started_s
            probe.done.set()

    def _start_probe(self, handle: ReplicaHandle):
        """Start (or join) the single-flight probe of one replica.
        Returns ``(probe, started)``; ``started=False`` means a previous
        probe is still in flight — the wedged-replica case — and the
        caller should not pay a fresh timeout for it."""
        with self._lock:
            probe = handle.probe_state
            if probe is not None and not probe.done.is_set():
                return probe, False
            probe = _Probe()
            handle.probe_state = probe
        self.metrics.bump("probes")
        # never joined: a wedged health() can block forever, and joining it
        # would bring back the stall the timeout bounds
        threading.Thread(
            target=self._probe_worker, args=(handle, probe),
            name=f"fleet-probe-{handle.replica_id}", daemon=True,
        ).start()
        return probe, True

    def _note_probe(self, handle: ReplicaHandle, probe: _Probe) -> None:
        """Fold one COMPLETED, successful probe into the handle: latency
        EWMA, cached health, worst perfwatch measured-vs-predicted ratio
        from the replica's own snapshot, and the registry ingest the
        exporter serves."""
        rid = handle.replica_id
        with self._lock:
            handle.probe_hung = False
            handle.last_health = probe.health
            handle.probe_ewma_s = (
                probe.elapsed_s
                if handle.probe_ewma_s == 0.0
                else 0.6 * handle.probe_ewma_s + 0.4 * probe.elapsed_s
            )
            if probe.snap:
                ratios = [
                    v for k, v in probe.snap.items()
                    if k.startswith("perf/") and k.endswith("/ratio")
                    and isinstance(v, (int, float))
                ]
                handle.perf_ratio = max(ratios) if ratios else 0.0
            if probe.digest is not None:
                # KV-affinity gossip: the replica's prefix-registry crcs
                # ride the probe, not the metrics registry (hash-valued
                # names would break the metric-name charset)
                handle.prefix_digest = frozenset(probe.digest.get("crcs", ()))
                handle.prefix_block = int(probe.digest.get("block_size", 0))
        # fold this replica's health + full metrics snapshot into the
        # router registry (fleet/replica/<id>/...): the fleet-wide
        # aggregation the exporter serves. The snapshot path re-ingests
        # engine gauges, so an IDLE replica's KV state still reaches the
        # scrape. No router lock held.
        self.metrics.registry.ingest(probe.health, prefix=f"replica/{rid}/health")
        if probe.snap is not None:
            self.metrics.registry.ingest(probe.snap, prefix=f"replica/{rid}")
        self.metrics.gauge(f"replica/{rid}/probed_at_s", self._clock())

    def _probe_pass(self) -> None:
        """One concurrent, timeout-bounded sweep over every live replica.
        All probes are started first, then collected against ONE shared
        deadline — the pass costs at most ``probe_timeout_s`` regardless
        of how many replicas hang. A timed-out probe marks its replica
        brown-out (gray: it answers slowly or not at all, but liveness is
        unknown — it is NOT respawned); a completed probe feeds the
        brown-out score and the classic dead-replica path."""
        with self._lock:
            handles = [h for h in self._handles.values() if not h.leaving]
        probes = [(h, *self._start_probe(h)) for h in handles]
        deadline = time.monotonic() + self.config.probe_timeout_s
        for handle, probe, started in probes:
            if not started and handle.probe_hung:
                # known-wedged: check without re-paying the timeout
                remaining = 0.0
            else:
                remaining = deadline - time.monotonic()
            probe.done.wait(max(0.0, remaining))
            dead = False
            if not probe.done.is_set():
                if not handle.probe_hung:
                    self.metrics.bump("probe_timeouts")
                    logger.warning(
                        "health probe of replica %s overran %.3fs — "
                        "marking brown-out",
                        handle.replica_id, self.config.probe_timeout_s,
                    )
                handle.probe_hung = True
            elif probe.error is not None:
                dead = True
            else:
                self._note_probe(handle, probe)
                dead = not probe.health["worker_alive"]
            if dead:
                self.metrics.bump("probe_failures")
                handle.breaker.record_failure()
                if self.config.auto_respawn and self._replica_factory:
                    self._respawn(handle)
            else:
                self._update_brownout(handle)

    # ------------------------------------------------------- brown-out scoring
    def _brownout_score(self, handle: ReplicaHandle) -> float:
        """Gray-failure score; >= 1.0 engages quarantine. Terms: probe
        latency EWMA vs ``brownout_probe_ewma_s``, the replica's worst
        perfwatch measured-vs-predicted ratio vs
        ``brownout_residual_ratio`` (the signal no external system has:
        committed predictions), and an outright hung probe (instant
        quarantine — the strongest gray signal there is).

        The residual term is PEER-RELATIVE in a multi-replica fleet:
        gray failure means THIS replica is sick while its siblings are
        fine, so the term measures the EXCESS of the replica's ratio
        over the fleet's peer median — zero at parity, 1.0 (engage) at
        ``brownout_residual_ratio`` times the median. A fleet-wide
        elevated ratio (miscommitted baseline, whole-pod slowdown, or —
        in-process — the shared perfwatch observatory) is the drift
        sentinel's problem and must not quarantine every replica at
        once; and until the peers have reported a ratio at all there is
        no differential signal, not an absolute one (the bootstrap
        probe must not quarantine whoever happens to be probed first).
        Only a single-replica fleet, which has nobody to deviate from,
        uses the absolute ratio."""
        cfg = self.config
        if handle.probe_hung:
            return 2.0
        score = handle.probe_ewma_s / cfg.brownout_probe_ewma_s
        ratio = handle.perf_ratio
        if ratio > 0.0:
            with self._lock:
                multi = len(self._handles) > 1
                peers = sorted(
                    h.perf_ratio for h in self._handles.values()
                    if h is not handle and h.perf_ratio > 0.0
                )
            if not multi:
                score = max(score, ratio / cfg.brownout_residual_ratio)
            elif peers:
                rel = ratio / max(peers[len(peers) // 2], 1e-9)
                score = max(
                    score,
                    (rel - 1.0) / (cfg.brownout_residual_ratio - 1.0),
                )
        return score

    def _update_brownout(self, handle: ReplicaHandle) -> None:
        """Advance one replica's healthy/brown-out state machine
        (hysteresis: engage at score >= 1, clear below
        ``brownout_clear_fraction``); on engagement hedge its in-flight
        requests elsewhere, and after ``brownout_drain_after_s`` of
        sustained quarantine file ONE typed
        :class:`~accelerate_tpu_torch.utils.fault.ReplicaBrownoutError` into
        perfwatch so the controller's drift path drains and replaces it."""
        cfg = self.config
        score = self._brownout_score(handle)
        now = self._clock()
        rid = handle.replica_id
        engaged = cleared = False
        with self._lock:
            handle.brownout_score = score
            if not handle.brownout and score >= 1.0:
                handle.brownout = True
                handle.brownout_since_s = now
                handle.brownout_reported = False
                engaged = True
            elif handle.brownout and score < cfg.brownout_clear_fraction:
                handle.brownout = False
                handle.brownout_reported = False
                cleared = True
            sustained = now - handle.brownout_since_s
            file_finding = (
                handle.brownout
                and not handle.brownout_reported
                and sustained >= cfg.brownout_drain_after_s
            )
            if file_finding:
                handle.brownout_reported = True
        if engaged:
            self.metrics.bump("brownouts")
            logger.warning(
                "replica %s browned out (score %.2f, probe ewma %.4fs, "
                "perf ratio %.2f) — deprioritized and hedging in-flight",
                rid, score, handle.probe_ewma_s, handle.perf_ratio,
            )
            if cfg.hedge_brownout:
                self._hedge_inflight(handle)
        elif cleared:
            self.metrics.bump("brownout_clears")
            logger.warning(
                "replica %s brown-out cleared (score %.2f)", rid, score
            )
        if file_finding:
            err = ReplicaBrownoutError(
                rid,
                score=score,
                probe_ewma_s=handle.probe_ewma_s,
                threshold_s=cfg.brownout_probe_ewma_s,
                sustained_s=sustained,
            )
            perfwatch.get_watch().add_finding(err)
            self.metrics.bump("brownout_findings")
            logger.error(str(err))
        self.metrics.gauge(f"replica/{rid}/brownout", 1.0 if handle.brownout else 0.0)
        self.metrics.gauge(f"replica/{rid}/brownout_score", score)
        self.metrics.gauge(f"replica/{rid}/probe_ewma_s", handle.probe_ewma_s)

    def _hedge_inflight(self, handle: ReplicaHandle) -> None:
        """A replica entering brown-out becomes the preferred hedge
        *source*: every request still in flight on it is dispatched to a
        healthy replica too (first result wins, loser cancelled), each
        hedge spending one retry-budget token — quarantine accelerates
        the requests already trapped on the slow replica instead of only
        protecting future ones."""
        with self._lock:
            freqs = list(handle.inflight.values())
        for freq in freqs:
            if freq.future.done() or freq.hedged:
                continue
            with freq.lock:
                exclude = set(freq.tried) | {handle.replica_id}
            cands = [
                (h, hh)
                for h, hh in self._candidates(exclude=exclude)
                if not h.brownout
            ]
            if not cands:
                continue
            if not self._budget.try_acquire():
                return  # budget empty: storm control outranks quarantine
            freq.hedged = True
            target = self._order(cands, freq)[0][0]
            try:
                with tracing.span(
                    "fleet.hedge", trace_id=freq.trace_id,
                    replica=target.replica_id, source=handle.replica_id,
                ):
                    self._submit_to(target, freq, hedge=True)
            except ServingError:
                continue  # the original dispatch stands; hedging is best-effort
            self.metrics.bump("hedges")

    def _respawn(self, handle: ReplicaHandle) -> None:
        """Supervisor-style scale-up: relaunch a dead replica via the
        factory (bounded by ``respawn_backoff_s``), swap it into the
        handle, and bump the membership generation."""
        now = self._clock()
        if now - handle.last_respawn_s < self.config.respawn_backoff_s:
            return
        handle.last_respawn_s = now
        try:
            server = self._replica_factory(handle.replica_id)
        except Exception as exc:  # noqa: BLE001 — a failed respawn retries next probe
            # a crash-looping factory must be visible in one scrape, not
            # buried in a log line: monotonic counter + per-replica gauge
            handle.respawn_failures += 1
            self.metrics.bump("respawn_failures")
            self.metrics.gauge(
                f"replica/{handle.replica_id}/respawn_failing", 1.0
            )
            logger.warning(
                "respawn of replica %s failed (%d consecutive): %s: %s",
                handle.replica_id, handle.respawn_failures,
                type(exc).__name__, exc,
            )
            return
        handle.respawn_failures = 0
        self.metrics.gauge(f"replica/{handle.replica_id}/respawn_failing", 0.0)
        if getattr(server, "replica_id", None) is None:
            server.replica_id = handle.replica_id
        old = handle.server
        with self._lock:
            handle.server = server
            handle.generation += 1
        handle.breaker.record_success()  # fresh replica, fresh breaker state
        try:
            old.close(drain=False, timeout=0.0)
        except Exception:  # noqa: BLE001 — the old worker is already dead
            pass
        self.metrics.bump("respawns")
        self._membership.join(
            handle.replica_id,
            {"mode": server.config.mode, "generation": handle.generation},
        )
        logger.warning(
            "replica %s respawned (generation %d)",
            handle.replica_id, handle.generation,
        )

    # --------------------------------------------------------------- stats
    def servers(self) -> Dict[str, InferenceServer]:
        """Live ``{replica_id: server}`` view (excluding replicas mid
        scale-down) — the SLO controller actuates in-place knobs (spec
        clamp, degradation thresholds, admission quotas) through this."""
        with self._lock:
            return {
                rid: h.server
                for rid, h in self._handles.items()
                if not h.leaving
            }

    def refresh_replica_metrics(self) -> Dict[str, dict]:
        """Re-ingest every live replica's health + full metrics snapshot
        (which itself re-reads ``engine.stats()``, so KV utilization and
        spec acceptance are CURRENT, not the exporter's last scrape) into
        the fleet registry, exactly as one prober pass would. Called by
        the SLO controller at each observation tick so a scale decision
        never reads a stale KV picture off an idle exporter. Returns
        ``{replica_id: health}`` for the replicas that answered —
        a missing replica is the caller's partial-telemetry signal."""
        with self._lock:
            handles = [h for h in self._handles.values() if not h.leaving]
        out: Dict[str, dict] = {}
        for h in handles:
            # single-flight, timeout-bounded read (shared with the prober)
            # — the controller's observation tick is bounded no matter
            # what one replica does. Three outcomes: fresh sample (fold +
            # covered), typed error (unreadable = NOT covered, the
            # partial-telemetry fail-static signal), hang (brown-out; the
            # cached sample keeps the replica covered so the controller
            # keeps actuating while the quarantine handles it).
            probe, started = self._start_probe(h)
            timeout = (
                0.0 if (not started and h.probe_hung)
                else self.config.probe_timeout_s
            )
            done = probe.done.wait(timeout)
            if done and probe.error is None and probe.health is not None:
                self._note_probe(h, probe)
                self._update_brownout(h)
                out[h.replica_id] = probe.health
            elif done:
                continue  # noqa — unreadable replica = not covered
            else:
                if not h.probe_hung:
                    self.metrics.bump("probe_timeouts")
                    logger.warning(
                        "health read of replica %s overran %.3fs — "
                        "marking brown-out",
                        h.replica_id, self.config.probe_timeout_s,
                    )
                h.probe_hung = True
                self._update_brownout(h)
                if h.last_health is not None:
                    out[h.replica_id] = h.last_health
        return out

    def metrics_snapshot(self) -> dict:
        """The fleet-wide flat metrics dict the exporter serves: router
        counters/gauges/percentiles, every replica's aggregated snapshot
        (``fleet/replica/<id>/...``, refreshed by the prober), this
        process's perf observatory (``perf/<program>/...``), and any
        attached extra sources (the SLO controller publishes its
        ``controller/...`` registry here, so ONE scrape carries the
        decisions next to the telemetry that drove them)."""
        out = self.metrics.registry.snapshot()
        out.update(perfwatch.get_watch().snapshot())
        for fn in list(self.extra_metrics):
            try:
                out.update(fn())
            except Exception:  # noqa: BLE001 — a broken attachment must not kill scrapes
                continue
        return out

    def stats(self) -> dict:
        """Router + per-replica observability: metrics snapshot, membership
        snapshot, retry-budget level, and each replica's handle state."""
        with self._lock:
            handles = list(self._handles.values())
        replicas = {}
        for h in handles:
            # cached sample, same rule as _candidates: only the prober's
            # timeout-bounded threads ever block on a replica, so a gray
            # replica can never wedge a stats caller (or the controller's
            # observe phase, which reads this)
            health = h.last_health
            if health is None and not h.probe_hung:
                try:
                    health = h.server.health()
                except Exception:  # noqa: BLE001 — report what is reportable
                    health = None
            if health is None:
                health = {"worker_alive": False}
            replicas[h.replica_id] = {
                "outstanding": h.outstanding,
                "completed": h.completed,
                "failed": h.failed,
                "generation": h.generation,
                "leaving": h.leaving,
                "breaker_state": h.breaker.state(),
                "brownout": h.brownout,
                "brownout_score": h.brownout_score,
                "respawn_failures": h.respawn_failures,
                "health": health,
            }
        return {
            "replicas": replicas,
            "metrics": self.metrics.snapshot(),
            "membership": self._membership.snapshot(),
            "retry_budget": self._budget.available(),
        }
