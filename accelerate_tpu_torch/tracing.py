"""Span tracer, flight recorder and metrics registry (counterpart of
``accelerate_tpu/tracing.py``).

One span spine from the fleet router to the decode step: the serving
stack (``fleet.py`` -> ``serving.py`` -> ``engine.py``, and the KV wire of
``kvtransfer.py``) and the training loop (data wait, the step's dispatch,
the health ring's drain, checkpoint commit and replication) open spans
through the one context-manager API of this module, so one trace id
strings a request's placement, queue wait, admission, prefill, sampled
decode steps, speculative verify, failover hops and retirement into one
timeline.

* **Context manager only**: ``with span("name", trace_id=tid) as sp:``.
  A span that cannot leak open has a trustworthy duration.
* **Host time only**: spans time dispatch, queue waits and host control
  flow. None is opened inside a captured CUDA graph's body (``engine.py``
  opens them around ``_run``, outside the body a graph records): a graph
  replays its kernels, never the Python around them, so a clock read
  there would run once, at capture.
* **Near-zero cost when disabled**: ``span()`` returns a shared no-op
  context manager after one attribute check: no allocation, no clock
  read. ``ACCELERATE_TRACING=0`` (or ``TracingConfig(enabled=False)``)
  turns the spine off.
* **Bounded memory**: spans land in per-thread rings of ``ring_capacity``
  entries, the oldest dropped and counted (``dropped_spans``). The rings
  are the flight recorder: the last ``retain_s`` seconds of spans are in
  memory, and a typed failure (worker death, ``FailoverExhaustedError``,
  checkpoint rollback) or SIGUSR1 dumps them as Chrome/Perfetto
  trace-event JSON under ``dump_dir``.

Clocks: spans read ``time.monotonic()`` only. The tracer records one
``(monotonic, unix)`` epoch pair when it is built, the offset that aligns
host spans with a ``torch.profiler`` trace taken beside it (its events
carry the CUDA timeline; :func:`epoch`, and ``otherData.epoch_unix`` in
every dump).

Thread safety: each ring is appended to by its own thread only (no lock
on the hot path; a list element write is atomic under the GIL); a dump
copies each ring before it serialises.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import threading
import time
from typing import Any, Dict, List, Optional

from .logging import get_logger
from .utils.dataclasses import TracingConfig

logger = get_logger(__name__)

TRACING_ENV = "ACCELERATE_TRACING"

__all__ = [
    "TRACING_ENV",
    "TracingConfig",
    "Tracer",
    "MetricsRegistry",
    "span",
    "step_span",
    "flight_dump",
    "new_trace_id",
    "get_tracer",
    "configure",
    "install_signal_handlers",
    "epoch",
]

_TRACE_COUNTER = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique request trace ID (cheap: one counter increment)."""
    return f"t{os.getpid():x}-{next(_TRACE_COUNTER):06x}"


# ------------------------------------------------------------------ spans
class Span:
    """One closed (or in-flight) span. Mutated only through the context
    manager that created it — see :meth:`Tracer.span`."""

    __slots__ = ("name", "trace_id", "t0", "t1", "tid", "attrs", "events")

    def __init__(self, name: str, trace_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.t0 = 0.0
        self.t1 = 0.0
        self.tid = 0
        self.attrs = attrs
        self.events: List[tuple] = []

    def set(self, key: str, value: Any) -> None:
        self.attrs[key] = value

    def event(self, name: str, **attrs: Any) -> None:
        self.events.append((time.monotonic(), name, attrs))


class _NullSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def set(self, key: str, value: Any) -> None:
        pass

    def event(self, name: str, **attrs: Any) -> None:
        pass


class _NullSpanCM:
    __slots__ = ()

    def __enter__(self) -> _NullSpan:
        return NULL_SPAN

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


NULL_SPAN = _NullSpan()
_NULL_CM = _NullSpanCM()


class _SpanCM:
    """The one way to open a span. ``__exit__`` stamps the end time, records an in-flight
    exception as a typed ``error`` event (type name, ``retriable``,
    ``replica_id``, ``__cause__`` chain — taxonomy attributes, never
    prose), and commits the span to the owner thread's ring. Exceptions
    always propagate."""

    __slots__ = ("_tracer", "_span")

    def __init__(self, tracer: "Tracer", span_obj: Span):
        self._tracer = tracer
        self._span = span_obj

    def __enter__(self) -> Span:
        sp = self._span
        sp.tid = threading.get_ident()
        sp.t0 = time.monotonic()
        return sp

    def __exit__(self, exc_type, exc, tb) -> bool:
        sp = self._span
        sp.t1 = time.monotonic()
        if exc is not None:
            cause = getattr(exc, "__cause__", None)
            sp.events.append((sp.t1, "error", {
                "type": exc_type.__name__,
                "retriable": getattr(exc, "retriable", None),
                "replica_id": getattr(exc, "replica_id", None),
                "cause": type(cause).__name__ if cause is not None else None,
            }))
        self._tracer._append(sp)
        return False


class _Ring:
    """Bounded per-thread span buffer: drop-oldest, drops counted."""

    __slots__ = ("capacity", "spans", "pos", "dropped", "thread_name")

    def __init__(self, capacity: int, thread_name: str):
        self.capacity = capacity
        self.spans: List[Span] = []
        self.pos = 0
        self.dropped = 0
        self.thread_name = thread_name

    def append(self, sp: Span) -> None:
        if len(self.spans) < self.capacity:
            self.spans.append(sp)
        else:
            self.spans[self.pos] = sp
            self.pos = (self.pos + 1) % self.capacity
            self.dropped += 1


# ----------------------------------------------------------------- tracer
class Tracer:
    """Span sink + flight recorder for one process. Components share the
    module default (:func:`get_tracer`); tests construct their own with a
    private :class:`TracingConfig`."""

    def __init__(self, config: Optional[TracingConfig] = None):
        self._config = config if config is not None else TracingConfig()
        self._local = threading.local()
        self._rings: List[_Ring] = []
        self._rings_lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._dump_count = 0
        self._epoch_monotonic = time.monotonic()
        self._epoch_unix = time.time()

    # -- introspection
    @property
    def config(self) -> TracingConfig:
        return self._config

    @property
    def enabled(self) -> bool:
        return self._config.enabled

    @property
    def sample_every(self) -> int:
        """Decode-step span sampling period (engine hot loop)."""
        return self._config.decode_sample_every

    def epoch(self) -> Dict[str, float]:
        """The shared ``(monotonic, unix)`` epoch pair: the offset that
        aligns host spans with a ``torch.profiler`` trace started beside
        the tracer's construction."""
        return {"monotonic": self._epoch_monotonic, "unix": self._epoch_unix}

    def dropped_spans(self) -> int:
        with self._rings_lock:
            return sum(r.dropped for r in self._rings)

    # -- recording
    def span(self, name: str, trace_id: Optional[str] = None, **attrs: Any):
        """Open a span as a context manager (the only way). While disabled
        this is one attribute check and a shared no-op object."""
        if not self._config.enabled:
            return _NULL_CM
        return _SpanCM(self, Span(name, trace_id, attrs))

    def _ring(self) -> _Ring:
        ring = getattr(self._local, "ring", None)
        if ring is None:
            ring = _Ring(self._config.ring_capacity,
                         threading.current_thread().name)
            self._local.ring = ring
            with self._rings_lock:
                self._rings.append(ring)
        return ring

    def _append(self, sp: Span) -> None:
        self._ring().append(sp)

    # -- reading (tests, dumps)
    def spans(self, trace_id: Optional[str] = None,
              name: Optional[str] = None) -> List[Span]:
        """Snapshot of recorded spans across every thread's ring,
        oldest-first, optionally filtered by trace ID and/or span name."""
        with self._rings_lock:
            rings = list(self._rings)
        out: List[Span] = []
        for ring in rings:
            out.extend(list(ring.spans))
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        out.sort(key=lambda s: s.t0)
        return out

    def to_chrome_trace(self, reason: str = "") -> dict:
        """The retained window as a Chrome/Perfetto trace-event document
        (``ph:"X"`` complete events + ``ph:"i"`` instants; microsecond
        timestamps relative to the shared epoch)."""
        horizon = time.monotonic() - self._config.retain_s
        base = self._epoch_monotonic
        events: List[dict] = []
        pid = os.getpid()
        with self._rings_lock:
            rings = list(self._rings)
        thread_names = {}
        for ring in rings:
            for sp in list(ring.spans):
                if sp.t1 < horizon:
                    continue
                thread_names.setdefault(sp.tid, ring.thread_name)
                args = {"trace_id": sp.trace_id}
                args.update(sp.attrs)
                events.append({
                    "name": sp.name, "ph": "X", "pid": pid, "tid": sp.tid,
                    "ts": (sp.t0 - base) * 1e6,
                    "dur": max(sp.t1 - sp.t0, 0.0) * 1e6,
                    "args": args,
                })
                for t, ev_name, ev_attrs in sp.events:
                    ev_args = {"trace_id": sp.trace_id, "span": sp.name}
                    ev_args.update(ev_attrs)
                    events.append({
                        "name": ev_name, "ph": "i", "s": "t", "pid": pid,
                        "tid": sp.tid, "ts": (t - base) * 1e6,
                        "args": ev_args,
                    })
        events.sort(key=lambda e: e["ts"])
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}}
            for tid, tname in sorted(thread_names.items())
        ]
        return {
            "displayTimeUnit": "ms",
            "otherData": {
                "reason": reason,
                "epoch_unix": self._epoch_unix,
                "epoch_monotonic": self._epoch_monotonic,
                "retain_s": self._config.retain_s,
                "dropped_spans": self.dropped_spans(),
            },
            "traceEvents": meta + events,
        }

    # -- flight dumps
    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Serialize the retained window to ``path`` (default: a fresh
        ``flight-<reason>-*.json`` under ``dump_dir``, at most
        ``max_dumps`` per process). Returns the written path, or None
        when tracing is disabled / the dump budget is spent."""
        if not self._config.enabled:
            return None
        with self._dump_lock:
            if path is None:
                if self._dump_count >= self._config.max_dumps:
                    return None
                stamp = time.strftime("%Y%m%d-%H%M%S")
                os.makedirs(self._config.dump_dir, exist_ok=True)
                path = os.path.join(
                    self._config.dump_dir,
                    f"flight-{reason}-{stamp}-{os.getpid()}"
                    f"-{self._dump_count}.json",
                )
            self._dump_count += 1
            doc = self.to_chrome_trace(reason)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        n = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
        logger.warning(
            f"flight recorder: dumped {n} span(s) to {path} (reason: {reason})"
        )
        return path

    def dump_payload(self, reason: str, payload: Any,
                     prefix: str = "metrics") -> Optional[str]:
        """Write an arbitrary JSON-serializable document under
        ``dump_dir`` with the SAME atomic tmp+rename discipline and the
        SAME per-process ``max_dumps`` budget as :meth:`dump` — the
        perfwatch SIGUSR2 snapshot and drift-sentinel table land through
        here, so a metrics-dump loop cannot fill the disk any more than
        a crash loop can. Returns the written path, or None when tracing
        is disabled / the budget is spent."""
        if not self._config.enabled:
            return None
        with self._dump_lock:
            if self._dump_count >= self._config.max_dumps:
                return None
            stamp = time.strftime("%Y%m%d-%H%M%S")
            os.makedirs(self._config.dump_dir, exist_ok=True)
            path = os.path.join(
                self._config.dump_dir,
                f"{prefix}-{reason}-{stamp}-{os.getpid()}"
                f"-{self._dump_count}.json",
            )
            self._dump_count += 1
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True, default=str)
            os.replace(tmp, path)
        logger.warning(f"perf observatory: dumped {prefix} to {path} "
                       f"(reason: {reason})")
        return path

    def maybe_dump(self, reason: str) -> Optional[str]:
        """The typed-failure hook (worker death, failover exhaustion,
        checkpoint rollback): dump iff enabled and ``dump_on_failure``."""
        if not (self._config.enabled and self._config.dump_on_failure):
            return None
        try:
            return self.dump(reason)
        except OSError as exc:  # a full disk must never mask the failure
            logger.error(f"flight recorder dump failed: {exc}")
            return None


# ------------------------------------------------------- module-level API
_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def _env_config() -> TracingConfig:
    raw = os.environ.get(TRACING_ENV, "").strip().lower()
    enabled = raw not in ("0", "false", "off", "no")
    return TracingConfig(enabled=enabled)


def get_tracer() -> Tracer:
    """The process-default tracer (lazily built from ``ACCELERATE_TRACING``;
    :func:`configure` replaces it)."""
    global _DEFAULT
    tracer = _DEFAULT
    if tracer is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Tracer(_env_config())
            tracer = _DEFAULT
    return tracer


def configure(config: TracingConfig) -> Tracer:
    """Install a new default tracer built from ``config`` and return it."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = Tracer(config)
        return _DEFAULT


def span(name: str, trace_id: Optional[str] = None, **attrs: Any):
    """``with tracing.span("serving.admit", trace_id=tid) as sp: ...`` —
    the module-level shorthand over the default tracer."""
    return get_tracer().span(name, trace_id, **attrs)


def step_span(name: str, step: int, **attrs: Any):
    """Sampled span for per-step hot loops (engine decode, train step):
    records every ``decode_sample_every``-th step and hands back the
    shared no-op context manager otherwise, so the steady-state cost is
    one modulo. Same context-manager discipline as :func:`span`."""
    tracer = get_tracer()
    cfg = tracer.config
    if not cfg.enabled or step % cfg.decode_sample_every:
        return _NULL_CM
    return tracer.span(name, None, **attrs)


def flight_dump(reason: str) -> Optional[str]:
    """Typed-failure dump hook on the default tracer (see
    :meth:`Tracer.maybe_dump`)."""
    return get_tracer().maybe_dump(reason)


def epoch() -> Dict[str, float]:
    return get_tracer().epoch()


def install_signal_handlers(tracer: Optional[Tracer] = None) -> bool:
    """Install a chaining SIGUSR1 handler that dumps the flight recorder
    (``kill -USR1 <pid>`` = free postmortem of a live process). Main
    thread only (signal module restriction); returns False elsewhere or
    on platforms without SIGUSR1."""
    target = tracer if tracer is not None else get_tracer()
    if not hasattr(signal, "SIGUSR1"):
        return False
    try:
        prev = signal.getsignal(signal.SIGUSR1)

        def _handler(signum, frame):
            target.dump("sigusr1")
            if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGUSR1, _handler)
        return True
    except ValueError:  # not the main thread
        return False


# ------------------------------------------------------- metrics registry
class MetricsRegistry:
    """One ``snapshot()``-able surface of counters, gauges and latency
    reservoirs, shared by ``ServingMetrics``, ``FleetMetrics`` and
    ``perfwatch``.

    * ``bump``/``gauge``/``observe`` are thread-safe and cheap (one small
      lock, no I/O — safe under the server lock).
    * ``snapshot()`` returns a flat ``{prefix/name: value}`` dict with
      reservoir percentiles expanded (``LatencyReservoir.snapshot``).
    * ``ingest()`` folds a nested stats dict (``engine.stats()``) into
      namespaced gauges.
    * ``maybe_flush()`` is the ONE periodic tracker-flush implementation
      (previously duplicated between serving and fleet): call it from a
      worker/probe loop outside any server lock and it pushes a
      snapshot through ``GeneralTracker.log_batch`` every
      ``interval_s``.
    """

    def __init__(self, prefix: str = "", counters: tuple = (),
                 clock=time.monotonic):
        self._prefix = prefix
        self._lock = threading.Lock()
        self._clock = clock
        self._counters: Dict[str, int] = {name: 0 for name in counters}
        self._gauges: Dict[str, Any] = {}
        self._reservoirs: Dict[str, Any] = {}
        self._last_flush = clock()

    # -- writes
    def bump(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: Any) -> None:
        with self._lock:
            self._gauges[name] = value

    def attach_reservoir(self, name: str, reservoir) -> None:
        """Adopt an existing ``LatencyReservoir`` so its percentiles appear
        in ``snapshot()`` as ``<prefix><name>_p50`` etc."""
        with self._lock:
            self._reservoirs[name] = reservoir

    def observe(self, name: str, value: float, window: int = 512) -> None:
        """Record one latency/size sample into the named sliding-window
        reservoir (p50/p99/max appear in ``snapshot()``)."""
        with self._lock:
            res = self._reservoirs.get(name)
            if res is None:
                from .telemetry import LatencyReservoir

                res = self._reservoirs[name] = LatencyReservoir(size=window)
        res.add(value)

    def ingest(self, stats: Dict[str, Any], prefix: str = "") -> None:
        """Fold a (possibly nested) stats dict into gauges:
        ``{"kv": {"free_blocks": 3}}`` -> gauge ``kv/free_blocks``."""
        flat: Dict[str, Any] = {}

        def _flatten(node, key):
            if isinstance(node, dict):
                for k, v in node.items():
                    _flatten(v, f"{key}/{k}" if key else str(k))
            elif isinstance(node, (int, float, bool)):
                flat[key] = node

        _flatten(stats, prefix)
        with self._lock:
            self._gauges.update(flat)

    # -- reads
    def __getitem__(self, name: str) -> Any:
        with self._lock:
            if name in self._counters:
                return self._counters[name]
            return self._gauges[name]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = {f"{self._prefix}{k}": v for k, v in self._counters.items()}
            out.update(
                {f"{self._prefix}{k}": v for k, v in self._gauges.items()}
            )
            reservoirs = list(self._reservoirs.items())
        for name, res in reservoirs:
            out.update(res.snapshot(prefix=f"{self._prefix}{name}_"))
        return out

    # -- the ONE periodic tracker flush (serving worker + fleet prober)
    def due(self, interval_s: Optional[float],
            now: Optional[float] = None) -> bool:
        if interval_s is None:
            return False
        now = self._clock() if now is None else now
        return (now - self._last_flush) >= interval_s

    def flush(self, trackers, step: Optional[int] = None) -> None:
        """Snapshot and push to every tracker via ``log_batch``. The
        registry lock is released before any tracker I/O runs: call
        this outside the server lock."""
        self._last_flush = self._clock()
        if not trackers:
            return
        from .tracking import log_registry

        log_registry(trackers, self, step=step)

    def maybe_flush(self, trackers, interval_s: Optional[float],
                    step: Optional[int] = None) -> bool:
        if not self.due(interval_s):
            return False
        self.flush(trackers, step=step)
        return True
