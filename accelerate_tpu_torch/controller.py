"""Closed-loop SLO control over a fleet (counterpart of
``accelerate_tpu/controller.py``).

:class:`SLOController` is a control thread that each ``interval_s``

1. **observes**: refreshes every replica's ``engine.stats()`` gauges
   (``FleetRouter.refresh_replica_metrics``) and reads the router's one
   ``metrics_snapshot()``: TTFT and latency percentiles, queue occupancy,
   breaker states, the KV wire's fallbacks;
2. **decides**: folds them into one *pressure*, the worst
   measured/objective ratio, and compares it with a hysteresis band: at or
   above ``escalate_threshold`` one rung is engaged, at or below
   ``relax_threshold`` one is released, and in between nothing moves;
3. **actuates**: walks a fixed ladder of knobs that all move without a new
   program or a new CUDA graph, cheapest shed first:

   =========  =========================================================
   rung       knob
   =========  =========================================================
   spec       halve ``spec_draft_len`` and clamp the engine at once
              (``set_spec_draft_limit``, an operand the verify graph
              reads at replay)
   longctx    halve the chunks a tick (``set_prefill_chunk_limit``;
              1 -> 0 pauses long prompts' prefill)
   degrade    halve ``degrade_queue_fraction``,
              ``degrade_hard_fraction`` and ``degraded_max_new_tokens``
   admission  halve ``max_queue``: queueing becomes typed
              ``ServerOverloaded`` with a ``retry_after_s`` hint
   hedge      turn hedged dispatch off
              (``FleetConfig.hedge_deadline_fraction = None``)
   scale      ``FleetRouter.scale_up`` through its ``replica_factory``,
              repeatable up to ``max_replicas``; relaxing drains the
              added replicas first, each by a zero-drop ``scale_down``
   =========  =========================================================

It guards against itself: a dead band and per-knob cooldowns against
flapping, a token bucket against actuation storms, and **fail-static**:
stale (the prober has not finished a pass within ``stale_after_s``) or
partial (replica coverage below ``min_coverage``) telemetry freezes
actuation and records one
:class:`~accelerate_tpu_torch.utils.fault.ControllerStaleError` an
episode. Perfwatch's drift findings are an input: a finding is answered by
replacing one replica (a fresh one up, the drifted one drained). Every
actuation is a ``fleet.control`` span, and the ``controller/...`` registry
rides the router's ``metrics_snapshot()``. ``dry_run`` decides and counts
without touching the fleet.

The controller touches engines only through the servers' host-side knobs:
it moves no tensor and owns no card. Fault point: ``controller_observe``
(each tick, before the fleet is read).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from . import perfwatch, tracing
from .fleet import _TokenBucket
from .logging import get_logger
from .serving import _CircuitBreaker
from .tracing import MetricsRegistry
from .utils.dataclasses import ControllerConfig
from .utils.fault import ControllerStaleError, PerfDriftError, fault_point

logger = get_logger(__name__)

__all__ = ["SLOController", "ControlSignals"]

_FINDINGS_CAP = 32

# the in-place rungs in escalation order; "scale" comes after them and is
# the only repeatable rung (one replica an actuation). "longctx" sheds
# long prompts' prefill work before any output budget is clamped.
_RUNG_ORDER = ("spec", "longctx", "degrade", "admission", "hedge")


class ControlSignals:
    """What one tick's decision saw."""

    def __init__(self, *, pressure: float, queue_fraction: float,
                 ttft_p99_s: Optional[float], latency_p99_s: Optional[float],
                 breaker_open_fraction: float, kv_utilization: float,
                 replicas: int, transfer_failure_fraction: float = 0.0):
        self.pressure = pressure
        self.queue_fraction = queue_fraction
        self.ttft_p99_s = ttft_p99_s
        self.latency_p99_s = latency_p99_s
        self.breaker_open_fraction = breaker_open_fraction
        self.kv_utilization = kv_utilization
        self.replicas = replicas
        # this tick's share of KV transfers that fell back to local prefill
        # (0.0 while the wire is idle)
        self.transfer_failure_fraction = transfer_failure_fraction


class SLOController:
    """The closed loop over a :class:`~accelerate_tpu_torch.fleet
    .FleetRouter` (module docstring).

    ``router``: only its public surface is used (``refresh_replica_metrics``,
    ``metrics_snapshot``, ``servers``, ``replica_ids``, ``scale_up``,
    ``scale_down``, ``can_scale``, ``config``, ``extra_metrics``), so a
    narrow fake stands in for it in tests. ``watch``: the perfwatch whose
    drift findings are consumed (None: :func:`perfwatch.get_watch`).
    ``clock``: the monotonic time source.

    ``start()`` runs ticks on a thread; ``tick()`` runs one observe ->
    decide -> actuate cycle on the caller's (what deterministic tests
    drive)."""

    def __init__(
        self,
        router,
        config: Optional[ControllerConfig] = None,
        *,
        watch=None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.router = router
        self.config = config or ControllerConfig()
        self._watch = watch
        self._clock = clock
        self._lock = threading.Lock()  # findings and ladder bookkeeping only
        self.metrics = MetricsRegistry(
            prefix="controller/",
            counters=(
                "ticks",
                "tick_errors",
                "actuations",
                "escalations",
                "relaxations",
                "stale_findings",
                "stale_ticks",
                "recoveries",
                "drift_replacements",
                "actuation_denied_budget",
                "actuation_denied_cooldown",
                "actuation_errors",
                "dry_run_actions",
            ),
            clock=clock,
        )
        for name in ("pressure", "rung", "frozen", "replicas", "queue_fraction",
                     "actuation_budget", "transfer_failure_fraction"):
            self.metrics.gauge(name, 0.0)
        self._bucket = _TokenBucket(self.config.actuation_budget_capacity,
                                    self.config.actuation_budget_refill_per_s, clock)
        self._frozen = False
        self._stale_findings: List[ControllerStaleError] = []
        self._first_tick_s: Optional[float] = None
        self._sample_counts: Dict[str, float] = {}  # previous totals of the event streams
        self._last_act: Dict[str, float] = {}
        self._engaged: List[str] = []  # in-place rungs, in engage order
        self._saved: Dict[str, dict] = {}  # rung -> what releasing it restores
        self._added: List[str] = []  # replicas this controller launched
        self._seq = 0  # suffix of the next launched replica's id
        self._trace_id = tracing.new_trace_id() if tracing.get_tracer().enabled else None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # controller/... rides the router's one-scrape snapshot
        hook = getattr(router, "extra_metrics", None)
        if hook is not None:
            hook.append(self.metrics.snapshot)

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "SLOController":
        """Start the control thread (idempotent)."""
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, name="slo-controller", daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        """Stop the thread and leave the router's snapshot. The knobs stay
        where the ladder put them: relaxing is the next owner's decision."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        hook = getattr(self.router, "extra_metrics", None)
        if hook is not None and self.metrics.snapshot in hook:
            hook.remove(self.metrics.snapshot)

    def __enter__(self) -> "SLOController":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop outlives one bad tick
                self.metrics.bump("tick_errors")
                logger.exception("controller tick failed; loop continues")

    # ----------------------------------------------------------- observation
    def stale_findings(self) -> List[ControllerStaleError]:
        """The fail-static findings (bounded), oldest first: one an
        episode, however long it lasts."""
        with self._lock:
            return list(self._stale_findings)

    @property
    def frozen(self) -> bool:
        """Whether fail-static holds actuation now."""
        return self._frozen

    def engaged_rungs(self) -> List[str]:
        """The engaged in-place rungs, oldest first (added replicas count
        in ``controller/rung``)."""
        with self._lock:
            return list(self._engaged)

    def tick(self) -> None:
        """One observe -> decide -> actuate cycle. Safe against the fleet's
        threads; not to be called concurrently with itself."""
        cfg = self.config
        now = self._clock()
        if self._first_tick_s is None:
            self._first_tick_s = now  # one ticker: the thread or a test, never both
        self.metrics.bump("ticks")
        try:
            fault_point("controller_observe")
            # every replica's engine gauges read now, not whatever an
            # exporter last scraped
            fresh = self.router.refresh_replica_metrics()
            snap = self.router.metrics_snapshot()
            stale = self._staleness(snap, fresh, now)
        except Exception as exc:  # noqa: BLE001 - unreadable telemetry: fail static
            stale = ControllerStaleError(f"observation failed: {type(exc).__name__}: {exc}")
        if stale is not None:
            self._freeze(stale)
            return
        self._thaw()
        sig = self._signals(snap, fresh)
        self.metrics.gauge("pressure", sig.pressure)
        self.metrics.gauge("queue_fraction", sig.queue_fraction)
        self.metrics.gauge("replicas", sig.replicas)
        self.metrics.gauge("transfer_failure_fraction", sig.transfer_failure_fraction)
        self.metrics.gauge("actuation_budget", self._bucket.available())
        watch = self._watch if self._watch is not None else perfwatch.get_watch()
        if cfg.replace_on_drift:
            findings = watch.consume_drift_findings()
            if findings:
                self._replace_drifted(findings, fresh, now)
        if sig.pressure >= cfg.escalate_threshold:
            self._escalate(sig, now)
        elif sig.pressure <= cfg.relax_threshold:
            self._relax(sig, now)
        # inside the band: the dead band, no actuation

    def _staleness(self, snap: dict, fresh: Dict[str, dict],
                   now: float) -> Optional[ControllerStaleError]:
        """Stale (the prober stuck) or partial (replicas unreadable)
        telemetry: the snapshot cannot be trusted."""
        replicas = list(self.router.replica_ids())
        if not replicas:
            return None  # nothing to control
        coverage = len(fresh) / len(replicas)
        if coverage < self.config.min_coverage:
            return ControllerStaleError("partial telemetry — replicas unreadable",
                                        coverage=coverage)
        probed = snap.get("fleet/last_probe_s")
        if probed is None:
            # the prober has not finished its first pass: its age counts
            # from this controller's first tick
            age = max(0.0, now - (self._first_tick_s or now))
        else:
            age = max(0.0, now - probed)
        if age > self.config.stale_after_s:
            return ControllerStaleError("stale telemetry — prober has not completed a pass",
                                        age_s=None if probed is None else age)
        return None

    def _freeze(self, finding: ControllerStaleError) -> None:
        self.metrics.bump("stale_ticks")
        self.metrics.gauge("frozen", 1.0)
        if self._frozen:
            return  # one finding an episode
        self._frozen = True
        with self._lock:
            if len(self._stale_findings) < _FINDINGS_CAP:
                self._stale_findings.append(finding)
        self.metrics.bump("stale_findings")
        logger.error(str(finding))
        with tracing.span("fleet.control", trace_id=self._trace_id, action="freeze",
                          reason=finding.reason):
            pass

    def _thaw(self) -> None:
        self.metrics.gauge("frozen", 0.0)
        if not self._frozen:
            return
        self._frozen = False
        self.metrics.bump("recoveries")
        logger.warning("controller telemetry fresh again; actuation resumed")
        with tracing.span("fleet.control", trace_id=self._trace_id, action="thaw"):
            pass

    def _signals(self, snap: dict, fresh: Dict[str, dict]) -> ControlSignals:
        """The pressure: the worst of queue occupancy over its target, the
        TTFT and latency p99s over their objectives, twice the open
        breakers' share and the weighted transfer-failure share. KV
        utilization is gauged but is no pressure: a full pool is a
        well-packed fleet's steady state."""
        cfg = self.config
        queue_fraction = 0.0
        open_breakers = 0
        for health in fresh.values():
            depth = health.get("queue_depth", 0)
            free = health.get("queue_free", 0)
            cap = depth + free
            if cap > 0:
                queue_fraction = max(queue_fraction, depth / cap)
            if health.get("breaker_state") == _CircuitBreaker.OPEN:
                open_breakers += 1
        breaker_frac = open_breakers / max(1, len(fresh))
        ttft = self._worst(snap, "/serving/ttft_p99")
        latency = self._worst(snap, "/serving/latency_p99")
        kv = self._worst(snap, "/serving/kv_utilization") or 0.0
        # a percentile's window outlives its traffic: it counts only while
        # its stream gains samples, else a gone peak would pin the fleet
        ttft_live = self._stream_active(snap, "/serving/ttft_count")
        latency_live = self._stream_active(snap, "/serving/latency_count")
        terms = [queue_fraction / cfg.target_queue_fraction]
        if cfg.ttft_slo_s is not None and ttft is not None and ttft_live:
            terms.append(ttft / cfg.ttft_slo_s)
        if cfg.latency_slo_s is not None and latency is not None and latency_live:
            terms.append(latency / cfg.latency_slo_s)
        terms.append(2.0 * breaker_frac)  # half the breakers open is overload
        # a failing KV wire falls back to local prefill: the requests still
        # complete, so this term escalates before the queues show it
        transfer_frac = self._transfer_failure_fraction(snap)
        if self.config.transfer_pressure_weight > 0:
            terms.append(self.config.transfer_pressure_weight * transfer_frac)
        return ControlSignals(
            pressure=max(terms),
            queue_fraction=queue_fraction,
            ttft_p99_s=ttft,
            latency_p99_s=latency,
            breaker_open_fraction=breaker_frac,
            kv_utilization=kv,
            replicas=len(self.router.replica_ids()),
            transfer_failure_fraction=transfer_frac,
        )

    @staticmethod
    def _worst(snap: dict, suffix: str) -> Optional[float]:
        vals = [v for k, v in snap.items() if k.endswith(suffix) and isinstance(v, (int, float))]
        return max(vals) if vals else None

    def _transfer_failure_fraction(self, snap: dict) -> float:
        """Transfer-caused prefill fallbacks since the previous tick over
        the transfer attempts (shipped + failed) since then; 0.0 while the
        wire is idle."""
        failed = sum(v for k, v in snap.items() if isinstance(v, (int, float)) and (
            k.endswith("prefill_fallback/transfer_failed")
            or k.endswith("prefill_fallback/stale_epoch")))
        shipped = sum(v for k, v in snap.items()
                      if isinstance(v, (int, float)) and k.endswith("/kv_transfers"))
        prev_f = self._sample_counts.get("kvtx_failed")
        prev_a = self._sample_counts.get("kvtx_attempts")
        attempts = shipped + failed
        self._sample_counts["kvtx_failed"] = failed
        self._sample_counts["kvtx_attempts"] = attempts
        if prev_f is None or prev_a is None:
            return 0.0
        d_attempts = attempts - prev_a
        if d_attempts <= 0:
            return 0.0
        return max(0.0, (failed - prev_f) / d_attempts)

    def _stream_active(self, snap: dict, suffix: str) -> bool:
        """Whether the stream behind a percentile gained samples since the
        previous tick (the first sighting has no delta: idle)."""
        total = sum(v for k, v in snap.items()
                    if k.endswith(suffix) and isinstance(v, (int, float)))
        prev = self._sample_counts.get(suffix)
        self._sample_counts[suffix] = total
        return prev is not None and total > prev

    # -------------------------------------------------------------- actuation
    def _actuate(self, knob: str, fn: Callable[[], None], now: float, **attrs) -> bool:
        """The one gate of every fleet mutation: the knob's cooldown, then
        ``dry_run``, then the token bucket, then ``fn`` inside a
        ``fleet.control`` span. True only when the fleet changed."""
        cooldown = (self.config.scale_cooldown_s if knob in ("scale", "replace")
                    else self.config.knob_cooldown_s)
        if now - self._last_act.get(knob, float("-inf")) < cooldown:
            self.metrics.bump("actuation_denied_cooldown")
            return False
        if self.config.dry_run:
            self._last_act[knob] = now
            self.metrics.bump("dry_run_actions")
            logger.warning("controller dry_run: would actuate %s (%s)", knob, attrs)
            with tracing.span("fleet.control", trace_id=self._trace_id, knob=knob, dry_run=True,
                              **attrs):
                pass
            return False
        if not self._bucket.try_acquire():
            self.metrics.bump("actuation_denied_budget")
            return False
        self._last_act[knob] = now
        try:
            with tracing.span("fleet.control", trace_id=self._trace_id, knob=knob, dry_run=False,
                              **attrs):
                fn()
        except Exception as exc:  # noqa: BLE001 - a failed actuation does not end the loop
            self.metrics.bump("actuation_errors")
            logger.warning("controller actuation %s failed: %s: %s", knob, type(exc).__name__,
                           exc)
            return False
        self.metrics.bump("actuations")
        return True

    def _can_scale(self) -> bool:
        return getattr(self.router, "can_scale", False)

    def _next_rung(self) -> Optional[str]:
        servers = self.router.servers()
        with self._lock:
            engaged = set(self._engaged)
        for rung in _RUNG_ORDER:
            if rung not in engaged and self._applicable(rung, servers):
                return rung
        if self._can_scale() and len(self.router.replica_ids()) < self.config.max_replicas:
            return "scale"
        return None

    def _applicable(self, rung: str, servers: dict) -> bool:
        if rung == "spec":
            return any(getattr(getattr(s, "engine", None), "spec", None) is not None
                       and s.config.spec_draft_len > 1 for s in servers.values())
        if rung == "longctx":
            return any(getattr(getattr(s, "engine", None), "prefill_chunk", None) is not None
                       and getattr(s.engine, "prefill_chunk_limit", 0) > 0
                       for s in servers.values())
        if rung == "degrade":
            return bool(servers)
        if rung == "admission":
            return any(s.config.max_queue > 1 for s in servers.values())
        if rung == "hedge":
            return self.router.config.hedge_deadline_fraction is not None
        return False

    def _escalate(self, sig: ControlSignals, now: float) -> None:
        rung = self._next_rung()
        if rung is None:
            return  # fully escalated
        if rung == "scale":
            acted = self._actuate("scale", self._scale_up_action(), now, action="scale_up",
                                  pressure=round(sig.pressure, 3))
        else:
            acted = self._actuate(rung, lambda r=rung: self._engage(r), now, action="engage",
                                  pressure=round(sig.pressure, 3))
            if acted:
                with self._lock:
                    self._engaged.append(rung)
        if acted:
            self.metrics.bump("escalations")
            self.metrics.gauge("rung", len(self._engaged) + len(self._added))

    def _relax(self, sig: ControlSignals, now: float) -> None:
        if self._added:
            if len(self.router.replica_ids()) <= self.config.min_replicas:
                return
            acted = self._actuate("scale", self._scale_down_action(), now, action="scale_down",
                                  pressure=round(sig.pressure, 3))
        else:
            with self._lock:
                rung = self._engaged[-1] if self._engaged else None
            if rung is None:
                return  # at baseline
            acted = self._actuate(rung, lambda r=rung: self._disengage(r), now,
                                  action="disengage", pressure=round(sig.pressure, 3))
            if acted:
                with self._lock:
                    if self._engaged and self._engaged[-1] == rung:
                        self._engaged.pop()
        if acted:
            self.metrics.bump("relaxations")
            self.metrics.gauge("rung", len(self._engaged) + len(self._added))

    # -- in-place rungs
    def _engage(self, rung: str) -> None:
        servers = self.router.servers()
        saved: dict = {}
        if rung == "spec":
            for rid, srv in servers.items():
                eng = getattr(srv, "engine", None)
                if eng is None or getattr(eng, "spec", None) is None:
                    continue
                orig = srv.config.spec_draft_len
                if orig <= 1:
                    continue
                saved[rid] = orig
                srv.config.spec_draft_len = max(1, orig // 2)
                eng.set_spec_draft_limit(srv.config.spec_draft_len)
        elif rung == "longctx":
            for rid, srv in servers.items():
                eng = getattr(srv, "engine", None)
                if eng is None or getattr(eng, "prefill_chunk", None) is None:
                    continue
                orig = eng.prefill_chunk_limit
                if orig <= 0:
                    continue
                saved[rid] = orig
                # 1 -> 0 pauses chunked prefill: admitted long prompts keep
                # their slots and stop taking ticks
                eng.set_prefill_chunk_limit(orig // 2)
        elif rung == "degrade":
            for rid, srv in servers.items():
                c = srv.config
                saved[rid] = (c.degrade_queue_fraction, c.degrade_hard_fraction,
                              c.degraded_max_new_tokens)
                c.degrade_queue_fraction = max(0.05, c.degrade_queue_fraction * 0.5)
                c.degrade_hard_fraction = max(c.degrade_queue_fraction,
                                              c.degrade_hard_fraction * 0.5)
                c.degraded_max_new_tokens = max(1, c.degraded_max_new_tokens // 2)
        elif rung == "admission":
            for rid, srv in servers.items():
                saved[rid] = srv.config.max_queue
                srv.config.max_queue = max(1, srv.config.max_queue // 2)
        elif rung == "hedge":
            saved["hedge_deadline_fraction"] = self.router.config.hedge_deadline_fraction
            self.router.config.hedge_deadline_fraction = None
        with self._lock:
            self._saved[rung] = saved

    def _disengage(self, rung: str) -> None:
        with self._lock:
            saved = self._saved.pop(rung, {})
        if rung == "hedge":
            self.router.config.hedge_deadline_fraction = saved.get("hedge_deadline_fraction")
            return
        servers = self.router.servers()
        for rid, orig in saved.items():
            srv = servers.get(rid)
            if srv is None:
                continue  # the replica left the fleet while the rung held
            if rung == "spec":
                srv.config.spec_draft_len = orig
                eng = getattr(srv, "engine", None)
                if eng is not None:
                    eng.set_spec_draft_limit(orig)
            elif rung == "longctx":
                eng = getattr(srv, "engine", None)
                if eng is not None:
                    eng.set_prefill_chunk_limit(orig)
            elif rung == "degrade":
                (srv.config.degrade_queue_fraction, srv.config.degrade_hard_fraction,
                 srv.config.degraded_max_new_tokens) = orig
            elif rung == "admission":
                srv.config.max_queue = orig

    # -- replica count
    def _scale_up_action(self) -> Callable[[], None]:
        def act() -> None:
            self._seq += 1
            rid = f"ctl-{self._seq}"
            self.router.scale_up(rid)
            self._added.append(rid)
            logger.warning("controller scaled up replica %s", rid)

        return act

    def _scale_down_action(self) -> Callable[[], None]:
        def act() -> None:
            rid = self._added.pop()
            try:
                self.router.scale_down(rid, timeout=self.config.replace_drain_timeout_s)
            except Exception:
                self._added.append(rid)
                raise
            logger.warning("controller scaled down replica %s", rid)

        return act

    def _replace_drifted(self, findings: List[PerfDriftError], fresh: Dict[str, dict],
                         now: float) -> None:
        """Answer drift by replacing one replica: a fresh one up first,
        then the drifted one drained (its queued work fails over)."""
        if not self._can_scale() or not fresh:
            logger.warning("perf drift finding(s) received (%s) but the fleet cannot replace "
                           "replicas (no replica_factory)",
                           ", ".join(f.program for f in findings))
            return
        # a finding that names its replica (the fleet's brown-out) picks the
        # victim; a program-level finding takes the slowest batch EWMA
        named = [rid for rid in (getattr(f, "replica_id", None) for f in findings)
                 if rid in fresh]
        victim = named[0] if named else max(
            fresh, key=lambda rid: fresh[rid].get("batch_ewma_s", 0.0))

        def act() -> None:
            self._seq += 1
            rid = f"ctl-{self._seq}"
            self.router.scale_up(rid)
            try:
                self.router.scale_down(victim, timeout=self.config.replace_drain_timeout_s)
            finally:
                if victim in self._added:
                    # a surge replica's replacement drains on relax as it
                    # would have; a baseline replica's stays baseline
                    self._added.remove(victim)
                    self._added.append(rid)
            logger.warning("controller replaced drifted replica %s with %s (programs: %s)",
                           victim, rid, ", ".join(f.program for f in findings))

        if self._actuate("replace", act, now, action="replace", victim=victim,
                         programs=",".join(f.program for f in findings)):
            self.metrics.bump("drift_replacements")
