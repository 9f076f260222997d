"""Perf observatory: measured-against-predicted program times, a drift
sentinel and a metrics exporter (counterpart of
``accelerate_tpu/perfwatch.py``).

It measures what the hot programs cost (the engine's ``decode_step``,
``prefill_insert``, ``verify_step`` and ``prefill_chunk``, the static
server's batch, the training step), publishes the measurements beside a
baseline's predictions under one ``perf/<program>/...`` namespace, watches
for sustained drift, and serves the whole metrics surface to scrapers.

* **No new synchronisation**: a program's wall time is read only where
  the port already waits for the card: the engine's :meth:`poll` (its
  readback ring's events), the static server's batch (its tokens come back
  to the host) and the training loop's health verdicts. The time between
  two such points is split across the programs that retired in it,
  weighted by their predicted seconds, or equally in measured-only mode:
  a throughput measurement.
* **One roofline**: measured MFU and tokens/s come from this module's
  :func:`predicted_mfu` / :func:`predicted_tokens_per_s` over
  :data:`CHIPS`, which holds the card this port runs on and nothing
  else: ``"h100"`` (989e12 bf16 dense FLOP/s, 80e9 bytes, 3.35e12 B/s of
  HBM, the figures ``PERF.md``'s kernel bounds use). A baseline names its
  chip, and one for a chip outside the table (a TPU's ``"v5p"``, the JAX
  package's ``runs/perf_baseline.json``) is refused: a TPU's predicted
  seconds are never set against the card's.
* **Measured-only by default**: ``ObservabilityConfig.baseline_path`` is
  ``None`` in the port (the JAX default points at that TPU file), so
  every program's row says ``no-baseline`` until a baseline for the card
  is given.
* **Bounded and cheap**: per program one EWMA and one
  ``LatencyReservoir``; a disabled watch makes ``record`` one attribute
  check; drift is evaluated from the record path on an interval.
* **Drift is a typed, dumped event**: ``drift_consecutive`` evaluations
  outside the tolerance band file a :class:`~accelerate_tpu_torch.utils
  .fault.PerfDriftError` finding and one flight-recorder dump per program.

:class:`MetricsExporter` is a stdlib ``http.server`` daemon thread, off by
default, serving ``/metrics`` (Prometheus text) and ``/snapshot.json``;
``ACCELERATE_METRICS_PORT`` arms it on a standalone ``InferenceServer`` or
on the ``FleetRouter``, which folds every replica's snapshot into its own.
``kill -USR2 <pid>`` (after :func:`install_signal_handlers`) dumps the
snapshot and the measured-against-predicted table through the tracer's
dump budget.
"""

from __future__ import annotations

import json
import os
import re
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .logging import get_logger
from .utils.dataclasses import ObservabilityConfig
from .utils.fault import PerfDriftError

logger = get_logger(__name__)

PERFWATCH_ENV = "ACCELERATE_PERFWATCH"
METRICS_PORT_ENV = "ACCELERATE_METRICS_PORT"

__all__ = [
    "CHIPS",
    "PERFWATCH_ENV",
    "METRICS_PORT_ENV",
    "ObservabilityConfig",
    "PerfDriftError",
    "PerfWatch",
    "MetricsExporter",
    "prometheus_text",
    "get_watch",
    "configure",
    "maybe_exporter",
    "install_signal_handlers",
    "predicted_mfu",
    "predicted_tokens_per_s",
]

# The card's peaks, the only chip a baseline may name: bf16 dense tensor-core
# FLOP/s, HBM bytes and HBM bytes/s of one H100 SXM.
CHIPS = {
    "h100": dict(peak_bf16=989e12, hbm_bytes=80e9, hbm_bw=3.35e12),
}


# The port's copy of the JAX package's ``analysis/lowering.py`` helpers (its
# ``analysis`` package is not ported), over this module's chip table.
def predicted_mfu(useful_flops: float, step_time_s: float,
                  chip: str = "h100") -> float:
    """Model FLOPs utilisation against the chip's bf16 peak."""
    if step_time_s <= 0.0:
        return 0.0
    return useful_flops / (step_time_s * CHIPS[chip]["peak_bf16"])


def predicted_tokens_per_s(tokens: float, step_time_s: float) -> float:
    if step_time_s <= 0.0:
        return 0.0
    return tokens / step_time_s

# Engine ring entry kind -> the program a baseline predicts (its
# "programs" keys are "<family>/<program>", e.g. "engine.paged/decode_step").
RING_KIND_PROGRAM = {
    "prefill": "prefill_insert",
    "decode": "decode_step",
    "verify": "verify_step",
    # chunked-prefill progress entries (one per prompt chunk / KV restore);
    # billed as their own program so long-prompt admission cost is visible
    "chunk": "prefill_chunk",
}

_FINDINGS_CAP = 32


def _norm(program: str) -> str:
    """Baseline program key -> registry metric key: dots become
    underscores so ``engine.dense/decode_step`` publishes under
    ``perf/engine_dense/decode_step/...`` (a ``[a-z0-9_/]+`` charset,
    Prometheus-mappable)."""
    return program.replace(".", "_")


class _ProgramStats:
    """Per-program accumulator: EWMA + sliding-window reservoir."""

    __slots__ = ("ewma_s", "last_s", "calls", "reservoir")

    def __init__(self, window: int):
        from .telemetry import LatencyReservoir

        self.ewma_s: Optional[float] = None
        self.last_s = 0.0
        self.calls = 0
        self.reservoir = LatencyReservoir(size=window)


class PerfWatch:
    """The process-wide program-timer surface. Components share the
    module default (:func:`get_watch`); tests construct their own with a
    private :class:`ObservabilityConfig`."""

    def __init__(self, config: Optional[ObservabilityConfig] = None,
                 clock=time.monotonic):
        self._config = config if config is not None else ObservabilityConfig()
        self._clock = clock
        self._lock = threading.Lock()
        from .tracing import MetricsRegistry

        self.registry = MetricsRegistry(prefix="perf/")
        self._programs: Dict[str, _ProgramStats] = {}
        self._baseline: Optional[Dict[str, Any]] = None
        self._baseline_loaded = False
        # drift sentinel state
        self._strikes: Dict[str, int] = {}
        self._findings: List[PerfDriftError] = []
        self._drift_dumped: set = set()
        self._last_drift_check = clock()
        # a baseline for other hardware is refused here, where the watch is
        # configured, not first on a serving thread's record path
        self.baseline()

    # -- introspection
    @property
    def config(self) -> ObservabilityConfig:
        return self._config

    @property
    def enabled(self) -> bool:
        return self._config.enabled

    # -- baseline (committed roofline predictions)
    def baseline(self) -> Dict[str, Any]:
        """The per-program predictions (``programs`` of the baseline file).
        No path, or a missing or unreadable file: measured-only mode ({}),
        never an error. A file for a chip outside :data:`CHIPS`, or naming
        none, raises ``ValueError``: its seconds were predicted for other
        hardware."""
        if not self._baseline_loaded:
            progs: Dict[str, Any] = {}
            tol = None
            chip = "h100"
            path = self._config.baseline_path
            doc = None
            if path:
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    doc = None
            if isinstance(doc, dict):
                chip = doc.get("chip")
                if chip not in CHIPS:
                    raise ValueError(
                        f"perf baseline {path} is for chip {chip!r}, not one of "
                        f"{sorted(CHIPS)}: its predictions model other hardware and "
                        "are never set against this card's times")
                progs = dict(doc.get("programs", {}))
                tol = doc.get("tolerance")
            with self._lock:
                self._baseline = progs
                self._baseline_tol = tol
                self._baseline_chip = chip
                self._baseline_loaded = True
        return self._baseline or {}

    @property
    def drift_tolerance(self) -> float:
        """The armed band: config override, else the baseline file's
        committed ``tolerance``, else 5%."""
        if self._config.drift_tolerance is not None:
            return self._config.drift_tolerance
        self.baseline()
        tol = getattr(self, "_baseline_tol", None)
        return float(tol) if tol else 0.05

    # -- recording
    def record(self, program: str, seconds: float, calls: int = 1) -> None:
        """Record one measured per-call wall time for ``program`` (a
        baseline key like ``engine.dense/decode_step``). ``calls`` is how
        many program executions the sample averaged over (window
        accounting). Cheap: one small lock, no I/O — and one attribute
        check when disabled."""
        if not self._config.enabled or seconds <= 0.0 or calls < 1:
            return
        key = _norm(program)
        with self._lock:
            st = self._programs.get(program)
            if st is None:
                st = self._programs[program] = _ProgramStats(self._config.window)
                self.registry.attach_reservoir(f"{key}/t_s", st.reservoir)
            al = self._config.ewma_alpha
            st.ewma_s = (
                seconds if st.ewma_s is None
                else (1 - al) * st.ewma_s + al * seconds
            )
            st.last_s = seconds
            st.calls += calls
        st.reservoir.add(seconds)
        self.registry.bump(f"{key}/calls", calls)
        self.registry.gauge(f"{key}/last_s", seconds)
        self.registry.gauge(f"{key}/ewma_s", st.ewma_s)
        if self._config.drift_enabled:
            now = self._clock()
            if now - self._last_drift_check >= self._config.drift_interval_s:
                self.check_drift(now=now)

    def record_window(self, family: str, counts: Dict[str, int],
                      dt: float) -> None:
        """Split a synchronizing window's wall time ``dt`` across the
        programs that retired in it (``counts``: program-short-name ->
        executions, e.g. ``{"decode_step": 14, "prefill_insert": 2}``),
        weighted by each program's committed ``predicted_s`` so a cheap
        prefill is not billed a decode-sized share. Falls back to equal
        per-execution weights when a program has no baseline entry."""
        if not self._config.enabled or dt <= 0.0:
            return
        counts = {k: n for k, n in counts.items() if n > 0}
        if not counts:
            return
        base = self.baseline()
        weights: Dict[str, float] = {}
        for short, n in counts.items():
            pred = base.get(f"{family}/{short}", {}).get("predicted_s", 0.0)
            weights[short] = n * (pred if pred and pred > 0 else 0.0)
        if not any(weights.values()):  # no baseline at all: equal split
            weights = {short: float(n) for short, n in counts.items()}
        total_w = sum(weights.values())
        for short, n in counts.items():
            w = weights.get(short, 0.0)
            if w <= 0.0:
                continue
            share = dt * (w / total_w)
            self.record(f"{family}/{short}", share / n, calls=n)

    # -- reads
    def measured(self, program: str) -> Dict[str, Any]:
        """Measured summary for one program: median/ewma/last seconds and
        the total execution count (empty dict when nothing landed)."""
        with self._lock:
            st = self._programs.get(program)
        if st is None:
            return {}
        return {
            "median_s": st.reservoir.percentile(50),
            "ewma_s": st.ewma_s,
            "last_s": st.last_s,
            "calls": st.calls,
        }

    def table(self) -> List[Dict[str, Any]]:
        """The measured-vs-predicted rows, one per program in the union
        of baseline and measured sets. Measured MFU and tokens/s come from
        this module's roofline helpers over the baseline's chip."""
        base = self.baseline()
        chip = getattr(self, "_baseline_chip", "h100")
        tol = self.drift_tolerance
        with self._lock:
            measured = dict(self._programs)
        rows: List[Dict[str, Any]] = []
        for prog in sorted(set(base) | set(measured)):
            entry = base.get(prog, {})
            st = measured.get(prog)
            median = st.reservoir.percentile(50) if st is not None else None
            pred = entry.get("predicted_s")
            row: Dict[str, Any] = {
                "program": prog,
                "samples": st.calls if st is not None else 0,
                "measured_s": median,
                "ewma_s": st.ewma_s if st is not None else None,
                "predicted_s": pred,
                "bound": entry.get("bound"),
                "predicted_mfu": entry.get("mfu"),
                "measured_mfu": None,
                "predicted_tok_s": entry.get("tok_s"),
                "measured_tok_s": None,
                "ratio": None,
            }
            if median is not None and entry:
                row["measured_mfu"] = predicted_mfu(
                    entry.get("flops", 0.0), median, chip=chip
                )
                tok_s = entry.get("tok_s")
                if tok_s and pred:
                    # tokens per execution is the model's invariant; the
                    # measured rate re-divides them by the measured time
                    row["measured_tok_s"] = predicted_tokens_per_s(
                        tok_s * pred, median
                    )
            if median is not None and pred:
                row["ratio"] = median / pred
            if median is None:
                row["status"] = "no-data"
            elif not entry:
                row["status"] = "no-baseline"
            elif row["ratio"] is not None and abs(row["ratio"] - 1.0) > tol:
                row["status"] = "drift"
            else:
                row["status"] = "ok"
            rows.append(row)
        return rows

    def render_table(self) -> str:
        """The :meth:`table` as aligned text (SIGUSR2 dumps, bench
        output, humans)."""
        cols = ("program", "samples", "measured_s", "predicted_s", "ratio",
                "measured_mfu", "predicted_mfu", "status")

        def fmt(v):
            if v is None:
                return "-"
            if isinstance(v, float):
                return f"{v:.3e}" if abs(v) < 1e-2 else f"{v:.3f}"
            return str(v)

        rows = [[fmt(r.get(c)) for c in cols] for r in self.table()]
        widths = [
            max(len(c), *(len(r[i]) for r in rows)) if rows else len(c)
            for i, c in enumerate(cols)
        ]
        lines = ["  ".join(c.ljust(w) for c, w in zip(cols, widths))]
        for r in rows:
            lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
        return "\n".join(lines)

    def refresh_derived(self) -> None:
        """Fold the table's derived columns (measured MFU, tokens/s,
        drift ratio, prediction) into registry gauges — called lazily at
        snapshot time, never on the record path."""
        for row in self.table():
            key = _norm(row["program"])
            for col in ("predicted_s", "ratio", "measured_mfu",
                        "predicted_mfu", "measured_tok_s", "predicted_tok_s"):
                v = row.get(col)
                if v is not None:
                    self.registry.gauge(f"{key}/{col}", v)
        self.registry.gauge("drift_active", float(len(self._strikes)))

    def snapshot(self) -> Dict[str, Any]:
        """``MetricsRegistry.snapshot()`` with derived gauges refreshed:
        the ``perf/<program>/...`` namespace the exporter serves."""
        self.refresh_derived()
        return self.registry.snapshot()

    # -- drift sentinel
    def check_drift(self, now: Optional[float] = None) -> List[PerfDriftError]:
        """Compare every sufficiently-sampled program's measured median
        against its committed prediction. A median outside the tolerance
        band scores a strike; ``drift_consecutive`` strikes in a row
        promote the program to a typed :class:`PerfDriftError` finding
        and trigger ONE budgeted flight dump. Returns the new findings
        raised by this evaluation."""
        self._last_drift_check = self._clock() if now is None else now
        base = self.baseline()
        tol = self.drift_tolerance
        new: List[PerfDriftError] = []
        for prog, entry in base.items():
            pred = entry.get("predicted_s")
            if not pred:
                continue
            key = _norm(prog)
            with self._lock:
                st = self._programs.get(prog)
            if st is None or st.calls < self._config.drift_min_samples:
                continue
            median = st.reservoir.percentile(50)
            if median is None:
                continue
            if abs(median / pred - 1.0) <= tol:
                self._strikes.pop(prog, None)
                continue
            strikes = self._strikes.get(prog, 0) + 1
            self._strikes[prog] = strikes
            if strikes < self._config.drift_consecutive:
                continue
            if prog in self._drift_dumped:
                continue
            self._drift_dumped.add(prog)
            err = PerfDriftError(prog, median, pred, tol)
            with self._lock:
                if len(self._findings) < _FINDINGS_CAP:
                    self._findings.append(err)
            new.append(err)
            self.registry.bump("drift_findings")
            self.registry.gauge(f"{key}/drift", 1.0)
            logger.error(str(err))
            from . import tracing

            tracing.flight_dump("perf_drift")
            tracing.get_tracer().dump_payload(
                "perf_drift",
                {"finding": {
                    "program": err.program,
                    "measured_s": err.measured_s,
                    "predicted_s": err.predicted_s,
                    "tolerance": err.tolerance,
                }, "table": self.table()},
                prefix="perfdrift",
            )
        return new

    def drift_findings(self) -> List[PerfDriftError]:
        """Accumulated typed findings (bounded), oldest first."""
        with self._lock:
            return list(self._findings)

    def consume_drift_findings(self) -> List[PerfDriftError]:
        """Drain the findings list (oldest first): the handoff to a
        consumer that acts on drift (``controller.py``'s SLO controller
        replaces the replica). A drained finding is handled:
        it will not be re-delivered, and the per-program dump budget
        (``_drift_dumped``) is left intact so a recurrence after the
        consumer's remediation still cannot storm dumps."""
        with self._lock:
            out = list(self._findings)
            self._findings.clear()
        return out

    def add_finding(self, err: PerfDriftError) -> None:
        """Record an externally-produced typed drift finding into the same
        bounded findings list the sentinel feeds. The fleet's brown-out
        detector files its
        :class:`~accelerate_tpu_torch.utils.fault.ReplicaBrownoutError` (a
        :class:`PerfDriftError` subclass) here, so whatever drains
        ``consume_drift_findings()`` retires a gray-failed replica the way
        it retires a drifting program. Same cap, same counter as sentinel
        findings."""
        with self._lock:
            if len(self._findings) >= _FINDINGS_CAP:
                return
            self._findings.append(err)
        self.registry.bump("drift_findings")


# ------------------------------------------------------------ exporter
def _escape_label(value: str) -> str:
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")
# fleet-aggregated per-replica keys: fleet/replica/<rid>/<rest> — the
# replica id becomes a label so one metric family spans the fleet
_REPLICA_KEY = re.compile(r"^(fleet)/replica/([^/]+)/(.+)$")


def prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render a flat ``MetricsRegistry.snapshot()`` dict as Prometheus
    text exposition format (one untyped sample per numeric entry).
    Metric names map ``/`` and every other illegal character to ``_``
    under an ``accelerate_`` prefix; ``fleet/replica/<id>/...`` keys
    become one metric family with a ``replica`` label (label values
    escaped per the exposition spec). Non-numeric values are skipped —
    Prometheus samples are floats."""
    lines: List[str] = []
    for key in sorted(snapshot):
        value = snapshot[key]
        if isinstance(value, bool):
            value = float(value)
        if not isinstance(value, (int, float)):
            continue
        labels = ""
        m = _REPLICA_KEY.match(key)
        if m:
            key = f"{m.group(1)}/replica/{m.group(3)}"
            labels = f'{{replica="{_escape_label(m.group(2))}"}}'
        name = "accelerate_" + _NAME_BAD.sub("_", key)
        lines.append(f"{name}{labels} {float(value):g}")
    return "\n".join(lines) + "\n"


class MetricsExporter:
    """Pull-based metrics endpoint: a stdlib ``ThreadingHTTPServer`` on
    a daemon thread serving ``GET /metrics`` (Prometheus text) and
    ``GET /snapshot.json`` from a caller-provided snapshot function.
    Scrapes never touch component locks beyond the registry's own small
    lock. ``close()`` shuts the server down and joins the thread."""

    def __init__(self, snapshot_fn: Callable[[], Dict[str, Any]],
                 host: str = "127.0.0.1", port: int = 0):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = prometheus_text(exporter._snapshot_fn()).encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                    elif self.path.split("?")[0] == "/snapshot.json":
                        body = json.dumps(
                            exporter._snapshot_fn(), sort_keys=True,
                            default=str,
                        ).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as exc:  # scrape must not kill the server
                    self.send_error(500, str(exc))
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # no stderr per scrape
                logger.debug("exporter: " + fmt % args)

        self._snapshot_fn = snapshot_fn
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        logger.info(f"metrics exporter serving on {host}:{self.port} "
                    "(/metrics, /snapshot.json)")

    @property
    def port(self) -> int:
        """The actually-bound port (useful with ``port=0``)."""
        return self._server.server_address[1]

    def close(self) -> None:
        """Shut down and JOIN the serve thread (a dangling exporter
        thread would hold the socket past the component's close)."""
        self._server.shutdown()
        self._thread.join(timeout=5.0)
        self._server.server_close()


def maybe_exporter(snapshot_fn: Callable[[], Dict[str, Any]],
                   config: Optional[ObservabilityConfig] = None,
                   ) -> Optional[MetricsExporter]:
    """Start an exporter iff one is configured: an explicit
    ``ObservabilityConfig.exporter_port``, else ``ACCELERATE_METRICS_PORT``.
    Returns None when neither is set (the default) or the bind fails
    (the port race between components is logged, never fatal)."""
    port = 0
    host = "127.0.0.1"
    if config is not None and config.exporter_port:
        port, host = config.exporter_port, config.exporter_host
    else:
        raw = os.environ.get(METRICS_PORT_ENV, "").strip()
        if raw:
            try:
                port = int(raw)
            except ValueError:
                logger.warning(
                    f"ignoring non-integer {METRICS_PORT_ENV}={raw!r}"
                )
        if config is not None:
            host = config.exporter_host
    if not port or not (0 < port <= 65535):
        return None
    try:
        return MetricsExporter(snapshot_fn, host=host, port=port)
    except OSError as exc:
        logger.warning(f"metrics exporter bind failed on {host}:{port}: "
                       f"{exc} (another component holds it?)")
        return None


# ------------------------------------------------------- module-level API
_DEFAULT: Optional[PerfWatch] = None
_DEFAULT_LOCK = threading.Lock()


def _env_config() -> ObservabilityConfig:
    raw = os.environ.get(PERFWATCH_ENV, "").strip().lower()
    enabled = raw not in ("0", "false", "off", "no")
    return ObservabilityConfig(enabled=enabled)


def get_watch() -> PerfWatch:
    """The process-default watch (lazily built from
    ``ACCELERATE_PERFWATCH``; :func:`configure` replaces it)."""
    global _DEFAULT
    watch = _DEFAULT
    if watch is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = PerfWatch(_env_config())
            watch = _DEFAULT
    return watch


def configure(config: ObservabilityConfig) -> PerfWatch:
    """Install a new default watch built from ``config`` and return it."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        _DEFAULT = PerfWatch(config)
        return _DEFAULT


def install_signal_handlers(watch: Optional[PerfWatch] = None) -> bool:
    """Install a chaining SIGUSR2 handler that dumps the full metrics
    snapshot + the measured-vs-predicted table to the tracer's ``dump_dir`` (atomic
    tmp+rename, the SAME per-process ``max_dumps`` budget as the
    SIGUSR1 trace dump). Main thread only; returns False elsewhere or
    on platforms without SIGUSR2."""
    target = watch if watch is not None else get_watch()
    if not hasattr(signal, "SIGUSR2"):
        return False
    try:
        prev = signal.getsignal(signal.SIGUSR2)

        def _handler(signum, frame):
            from . import tracing

            tracing.get_tracer().dump_payload(
                "sigusr2",
                {"snapshot": target.snapshot(), "table": target.table()},
            )
            if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
                prev(signum, frame)

        signal.signal(signal.SIGUSR2, _handler)
        return True
    except ValueError:  # not the main thread
        return False
