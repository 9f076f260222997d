"""A seeded chaos conductor and the invariants that must hold under it
(counterpart of ``accelerate_tpu/chaos.py``).

``ACCELERATE_TPU_FAULT_INJECT`` expresses one-shot faults ("kill the
process at ``before_commit``"). The gray weather a fleet lives in needs
more: a straggler that is slow for a while, a probe that fails one time in
five, a hang that starts with a flash crowd. This module adds:

* :class:`ChaosRule` / :class:`ChaosSchedule`: a seeded, declarative plan
  over the :func:`~accelerate_tpu_torch.utils.fault.fault_point` registry:
  an action (``raise``, ``sleep[=s]``, ``hang[=cap_s]``, ``kill``,
  ``exit``), a seeded firing probability, ``after``/``every`` counters,
  time windows (:func:`phase_windows` lines them up with a load schedule's
  phases) and a context match that scopes a rule to one replica.
* :class:`ChaosConductor`: installs the schedule as the process's
  conductor hook (:func:`~accelerate_tpu_torch.utils.fault
  .install_conductor`), logs every hit and every firing, and
  :meth:`~ChaosConductor.replay` feeds a hit log through a fresh
  conductor: firing decisions are a pure function of (seed, each rule's
  hit ordinals, the hits' times), so one seed gives one firing sequence.
* :class:`InvariantMonitors`: what any chaos run must hold, checked while
  it runs: no client future left unresolved, no untyped error reaching a
  client, no traced request without its span tree, no counter going
  backwards.

Standard library only: no torch, no card.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
import zlib
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .utils.fault import FaultInjected, ServingError, install_conductor, uninstall_conductor

__all__ = [
    "ChaosRule",
    "ChaosSchedule",
    "ChaosConductor",
    "InvariantViolation",
    "InvariantMonitors",
    "phase_windows",
]


# ------------------------------------------------------------------ schedule
@dataclass(frozen=True)
class ChaosRule:
    """One rule over a named fault point.

    * ``point``: the :func:`~accelerate_tpu_torch.utils.fault.fault_point`
      name (``fleet_probe``, ``serving_before_batch``, ...).
    * ``action``: ``raise`` (the default; a typed
      :class:`~accelerate_tpu_torch.utils.fault.FaultInjected`),
      ``sleep[=seconds]`` (the straggler), ``hang[=cap_seconds]`` (parked
      until the conductor stops or the cap passes), ``kill``, ``exit``.
    * ``prob``: the firing probability of each eligible hit, drawn from the
      rule's own seeded stream.
    * ``after``/``every``: skip the first ``after`` hits, then fire on every
      ``every``-th.
    * ``start_s``/``end_s``: the window, in seconds from
      :meth:`ChaosConductor.start` (None: unbounded).
    * ``max_fires``: at most this many firings ("one kill" stays one).
    * ``match``: context the call site must pass (``{"replica": "r1"}``
      fires only on ``fault_point(..., replica="r1")``).
    * ``label``: the rule's name in the firing log (``point:action``)."""

    point: str
    action: str = "raise"
    prob: float = 1.0
    after: int = 0
    every: int = 1
    start_s: Optional[float] = None
    end_s: Optional[float] = None
    max_fires: Optional[int] = None
    match: Optional[Tuple[Tuple[str, Any], ...]] = None
    label: str = ""

    def __post_init__(self):
        if not (0.0 <= self.prob <= 1.0):
            raise ValueError(f"prob must be in [0, 1], got {self.prob}")
        if self.after < 0 or self.every < 1:
            raise ValueError(
                f"need after >= 0 and every >= 1, got after={self.after} every={self.every}")
        base = self.action.partition("=")[0]
        if base not in ("raise", "sleep", "hang", "kill", "exit"):
            raise ValueError(f"unknown chaos action {self.action!r} "
                             "(expected raise|sleep[=s]|hang[=s]|kill|exit)")
        # frozen and hashable: a dict match becomes a sorted item tuple
        if isinstance(self.match, dict):
            object.__setattr__(self, "match", tuple(sorted(self.match.items())))
        if not self.label:
            object.__setattr__(self, "label", f"{self.point}:{self.action}")

    def matches(self, name: str, context: Dict[str, Any]) -> bool:
        if name != self.point:
            return False
        if self.match:
            for key, value in self.match:
                if context.get(key) != value:
                    return False
        return True

    def in_window(self, t_rel: float) -> bool:
        if self.start_s is not None and t_rel < self.start_s:
            return False
        if self.end_s is not None and t_rel >= self.end_s:
            return False
        return True


@dataclass(frozen=True)
class ChaosSchedule:
    """A named, seeded set of :class:`ChaosRule`: one run's whole plan."""

    rules: Tuple[ChaosRule, ...]
    seed: int = 0
    name: str = "chaos"

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(self.rules))


def phase_windows(phases: Sequence) -> List[Tuple[str, float, float]]:
    """The cumulative ``(name, start_s, end_s)`` of a sequence of phases
    (anything with ``name`` and ``duration_s``, such as
    ``test_utils/arrivals.py``'s ``Phase``): chaos that starts when the
    flash crowd does."""
    out, t = [], 0.0
    for ph in phases:
        out.append((ph.name, t, t + ph.duration_s))
        t += ph.duration_s
    return out


# ----------------------------------------------------------------- conductor
class _RuleState:
    __slots__ = ("hits", "fires", "rng")

    def __init__(self, seed: int, index: int, rule: ChaosRule):
        self.hits = 0
        self.fires = 0
        # crc32, not hash(): string hashes are salted per process
        self.rng = random.Random(zlib.crc32(f"{seed}|{index}|{rule.label}".encode()))


class ChaosConductor:
    """Runs one :class:`ChaosSchedule` against the process.

    ``start()`` installs it behind every
    :func:`~accelerate_tpu_torch.utils.fault.fault_point`; ``stop()``
    uninstalls it and releases whatever a ``hang`` rule parked. A context
    manager too.

    Each hit goes to the hit log ``(t_rel, point, context)`` and each
    firing to the firing log ``(rule_label, rule_hit_index, action)``,
    both under one lock, so each rule's hit ordinals are defined when
    probes hit at once. :meth:`replay` decides a recorded hit log again on
    a fresh conductor of the same schedule: it gives back the live firing
    log exactly."""

    def __init__(self, schedule: ChaosSchedule, *, clock: Callable[[], float] = time.monotonic):
        self.schedule = schedule
        self._clock = clock
        self._lock = threading.Lock()
        self._states = [_RuleState(schedule.seed, i, r) for i, r in enumerate(schedule.rules)]
        self._hang_event = threading.Event()
        # one bound method kept: uninstall_conductor compares identity, and
        # each `self._hook` builds a new one
        self._installed_hook = self._hook
        self._t0: Optional[float] = None
        self._hit_log: List[Tuple[float, str, Tuple[Tuple[str, Any], ...]]] = []
        self._firing_log: List[Tuple[str, int, str]] = []

    # -- lifecycle
    def start(self) -> "ChaosConductor":
        self._t0 = self._clock()
        install_conductor(self._installed_hook)
        return self

    def stop(self) -> None:
        uninstall_conductor(self._installed_hook)
        self._hang_event.set()  # release whatever a hang rule parked

    def __enter__(self) -> "ChaosConductor":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    # -- what happened
    def firing_sequence(self) -> Tuple[Tuple[str, int, str], ...]:
        """``(rule_label, rule_hit_index, action)`` of each firing, in
        order: what two runs of one seed and one hit log agree on."""
        with self._lock:
            return tuple(self._firing_log)

    def hit_log(self) -> Tuple[Tuple[float, str, Tuple[Tuple[str, Any], ...]], ...]:
        with self._lock:
            return tuple(self._hit_log)

    def fires(self, label: Optional[str] = None) -> int:
        with self._lock:
            if label is None:
                return len(self._firing_log)
            return sum(1 for lab, _h, _a in self._firing_log if lab == label)

    def replay(self, hit_log) -> Tuple[Tuple[str, int, str], ...]:
        """Decide ``hit_log`` again on a fresh conductor of the same
        schedule (same seed, counters and streams at zero), performing
        nothing, and return its firing sequence."""
        twin = ChaosConductor(self.schedule, clock=self._clock)
        for t_rel, name, ctx in hit_log:
            twin._decide(name, dict(ctx), t_rel)
        return twin.firing_sequence()

    # -- the hook
    def _hook(self, name: str, context: Dict[str, Any]) -> None:
        if self._t0 is None:
            return
        t_rel = self._clock() - self._t0
        action = self._decide(name, context, t_rel)
        if action is not None:
            self._perform(name, action)

    def _decide(self, name: str, context: Dict[str, Any], t_rel: float) -> Optional[str]:
        """The decision, with no effect but the logs and counters: the
        action to perform, or None. One lock a hit keeps each rule's
        ordinals and draws in order."""
        fired_action: Optional[str] = None
        with self._lock:
            self._hit_log.append((t_rel, name, tuple(sorted(context.items()))))
            for rule, state in zip(self.schedule.rules, self._states):
                if not rule.matches(name, context) or not rule.in_window(t_rel):
                    continue
                state.hits += 1
                if rule.max_fires is not None and state.fires >= rule.max_fires:
                    continue
                if state.hits <= rule.after or (state.hits - rule.after - 1) % rule.every != 0:
                    continue
                # drawn on every counter-eligible hit, whether or not an
                # earlier rule fired: the stream's position depends on this
                # rule's own ordinals only
                if rule.prob < 1.0 and state.rng.random() >= rule.prob:
                    continue
                state.fires += 1
                self._firing_log.append((rule.label, state.hits, rule.action))
                if fired_action is None:
                    fired_action = rule.action
        return fired_action

    def _perform(self, name: str, action: str) -> None:
        base, _, arg = action.partition("=")
        if base == "raise":
            raise FaultInjected(f"{name} (chaos: {self.schedule.name})")
        if base == "sleep":
            time.sleep(float(arg) if arg else 0.05)
            return
        if base == "hang":
            self._hang_event.wait(float(arg) if arg else 30.0)
            return
        if base == "exit":
            os._exit(17)
        os.kill(os.getpid(), signal.SIGKILL)


# ---------------------------------------------------------------- invariants
class InvariantViolation(RuntimeError):
    """An invariant broke during a chaos run. ``kind``: ``dropped_future``,
    ``untyped_error``, ``incomplete_trace`` or ``counter_regression``."""

    def __init__(self, kind: str, detail: str):
        self.kind = kind
        self.detail = detail
        super().__init__(f"invariant violated [{kind}]: {detail}")


class InvariantMonitors:
    """The four invariants of any chaos run:

    1. **No dropped future**: every tracked client future resolves (a
       result, a typed error or a cancel).
    2. **No untyped error**: a tracked future that fails carries a
       :class:`~accelerate_tpu_torch.utils.fault.ServingError` (or a
       ``ValueError`` for misuse).
    3. **Complete trace trees**: a tracked request's trace holds its
       ``fleet.submit`` root and, when a result came, a ``fleet.dispatch``.
    4. **Monotonic counters**: between two :meth:`sample` calls no counter
       of a watched registry decreases.

    :meth:`check` returns every violation, :meth:`assert_clean` raises the
    first. At most ``max_traces`` traces are tracked
    (:attr:`unverified_traces` counts the rest)."""

    def __init__(self, *, tracer=None,
                 typed_errors: Tuple[type, ...] = (ServingError, ValueError),
                 max_traces: int = 256):
        self._tracer = tracer
        self._typed = typed_errors
        self._max_traces = max_traces
        self._lock = threading.Lock()
        self._futures: List[Tuple[str, Future]] = []
        self._traces: List[Tuple[str, Future]] = []
        self._trace_overflow = 0
        self._registries: List[Tuple[str, Callable[[], Dict[str, int]]]] = []
        self._last_counters: Dict[str, Dict[str, int]] = {}
        self._violations: List[InvariantViolation] = []

    # -- registration
    def watch_registry(self, label: str, registry) -> None:
        """Watch a counters source: a ``MetricsRegistry`` (its
        ``counters()``) or a callable returning ``{name: int}``."""
        fn = registry.counters if hasattr(registry, "counters") else registry
        with self._lock:
            self._registries.append((label, fn))

    def track(self, request_id: str, future: Future, trace_id: Optional[str] = None) -> Future:
        """Track one client future (and its trace id); returns the future."""
        with self._lock:
            self._futures.append((request_id, future))
            if trace_id is not None:
                if len(self._traces) < self._max_traces:
                    self._traces.append((trace_id, future))
                else:
                    self._trace_overflow += 1
        return future

    # -- sampling (at phase boundaries and after quiesce)
    def sample(self) -> List[InvariantViolation]:
        """Read every watched registry and compare with the previous
        sample: a decrease is a ``counter_regression``. Returns the new
        violations."""
        new: List[InvariantViolation] = []
        with self._lock:
            registries = list(self._registries)
        for label, fn in registries:
            try:
                counters = dict(fn())
            except Exception as exc:  # noqa: BLE001 - an unreadable source is a finding
                new.append(InvariantViolation(
                    "counter_regression",
                    f"registry {label!r} unreadable: {type(exc).__name__}: {exc}"))
                continue
            with self._lock:
                prev = self._last_counters.get(label, {})
                for key, value in counters.items():
                    if key in prev and value < prev[key]:
                        new.append(InvariantViolation(
                            "counter_regression",
                            f"{label}:{key} went backwards ({prev[key]} -> {value})"))
                self._last_counters[label] = counters
        with self._lock:
            self._violations.extend(new)
        return new

    # -- verdict
    def check(self, quiesce_timeout_s: float = 10.0) -> List[InvariantViolation]:
        """Wait up to ``quiesce_timeout_s`` for the tracked futures, then
        judge all four invariants. Returns every violation, earlier
        samples' included."""
        deadline = time.monotonic() + quiesce_timeout_s
        with self._lock:
            futures = list(self._futures)
            traces = list(self._traces)
        out: List[InvariantViolation] = []
        for rid, fut in futures:
            remaining = deadline - time.monotonic()
            if not fut.done() and remaining > 0:
                try:
                    fut.exception(timeout=remaining)
                except Exception:  # noqa: BLE001 - judged below
                    pass
            if not fut.done():
                out.append(InvariantViolation("dropped_future",
                                              f"request {rid} unresolved after quiesce"))
                continue
            if fut.cancelled():
                continue  # a cancel resolves
            exc = fut.exception()
            if exc is not None and not isinstance(exc, self._typed):
                out.append(InvariantViolation(
                    "untyped_error",
                    f"request {rid} failed with untyped {type(exc).__name__}: {exc}"))
        out.extend(self._check_traces(traces))
        out.extend(self.sample())
        with self._lock:
            self._violations.extend(v for v in out if v not in self._violations)
            return list(self._violations)

    def _check_traces(self, traces) -> List[InvariantViolation]:
        out: List[InvariantViolation] = []
        if not traces:
            return out
        tracer = self._tracer
        if tracer is None:
            from . import tracing

            tracer = tracing.get_tracer()
        if not getattr(tracer, "enabled", False):
            return out
        by_trace: Dict[str, List[str]] = {}
        for sp in tracer.spans():
            if sp.trace_id is not None:
                by_trace.setdefault(sp.trace_id, []).append(sp.name)
        for trace_id, fut in traces:
            names = by_trace.get(trace_id, [])
            if "fleet.submit" not in names:
                out.append(InvariantViolation(
                    "incomplete_trace",
                    f"trace {trace_id} has no fleet.submit root "
                    f"(spans present: {sorted(set(names))})"))
                continue
            delivered = fut.done() and not fut.cancelled() and fut.exception() is None
            if delivered and "fleet.dispatch" not in names:
                out.append(InvariantViolation(
                    "incomplete_trace",
                    f"trace {trace_id} delivered a result but shows no fleet.dispatch span "
                    f"({sorted(set(names))})"))
        return out

    @property
    def unverified_traces(self) -> int:
        """Traces past ``max_traces``: report it beside the verdict."""
        with self._lock:
            return self._trace_overflow

    def assert_clean(self, quiesce_timeout_s: float = 10.0) -> None:
        violations = self.check(quiesce_timeout_s)
        if violations:
            raise violations[0]

    @property
    def violations(self) -> List[InvariantViolation]:
        with self._lock:
            return list(self._violations)
