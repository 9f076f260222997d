"""Seeded arrival schedules for driving a serving fleet (the port's own
copy of what the controller's drives need from the JAX repository's
``benchmarks/loadgen.py``; the same seed and phases give the same
offsets).

A :class:`Schedule` is a list of absolute submit offsets, each tagged with
its phase, built from a piecewise rate profile by a seeded Poisson process
(:func:`from_phases`). :func:`ramp_flash_crowd_drain` is the controller's
scenario: a linear climb, a step to a multiple of the peak (the flash
crowd), a linear fall. :meth:`Schedule.replay` paces wall time through the
offsets open-loop: a slow submit delays the later arrivals, it does not
lower the offered load. :func:`prompt_order` picks, seeded, which prompt
of a mix each arrival sends.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

__all__ = ["Arrival", "Phase", "Schedule", "from_phases", "prompt_order",
           "ramp_flash_crowd_drain"]

Arrival = Tuple[float, str]  # (seconds from the start, phase name)


class Phase:
    """One segment of a rate profile: ``rate_rps`` a float, or a callable
    of the position ``u`` in [0, 1) within the segment (a ramp), read at
    each arrival."""

    def __init__(self, name: str, duration_s: float, rate_rps):
        if duration_s <= 0:
            raise ValueError(f"phase {name!r}: duration_s must be > 0")
        self.name = name
        self.duration_s = float(duration_s)
        self.rate_rps = rate_rps

    def rate_at(self, u: float) -> float:
        r = self.rate_rps(u) if callable(self.rate_rps) else self.rate_rps
        return max(float(r), 0.0)


class Schedule:
    """A deterministic arrival schedule that can be replayed."""

    def __init__(self, arrivals: Sequence[Arrival], phases: Sequence[Phase], seed: int):
        self.arrivals: List[Arrival] = list(arrivals)
        self.phases: List[Phase] = list(phases)
        self.seed = seed
        self.duration_s = sum(p.duration_s for p in phases)

    def __len__(self) -> int:
        return len(self.arrivals)

    def offsets(self) -> List[float]:
        return [t for t, _ in self.arrivals]

    def phase_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {p.name: 0 for p in self.phases}
        for _, name in self.arrivals:
            out[name] = out.get(name, 0) + 1
        return out

    def replay(self, submit: Callable[[str], None], *,
               clock: Callable[[], float] = time.perf_counter,
               sleep: Callable[[float], None] = time.sleep,
               on_phase: Optional[Callable[[str], None]] = None) -> Dict[str, int]:
        """Call ``submit(phase_name)`` at each offset in wall time, and
        ``on_phase(name)`` once as each phase begins; then wait out the
        schedule's duration. Returns the submits per phase. What ``submit``
        raises propagates."""
        counts: Dict[str, int] = {p.name: 0 for p in self.phases}
        start = clock()
        current = None
        for t, name in self.arrivals:
            if name != current:
                current = name
                if on_phase is not None:
                    on_phase(name)
            while True:
                lag = start + t - clock()
                if lag <= 0:
                    break
                sleep(min(lag, 0.01))
            submit(name)
            counts[name] = counts.get(name, 0) + 1
        # a quiet tail still elapses: the caller's rates divide by it
        while clock() - start < self.duration_s:
            sleep(min(0.01, self.duration_s - (clock() - start)))
        return counts


def from_phases(phases: Sequence[Phase], *, seed: int = 0) -> Schedule:
    """Poisson arrivals over a piecewise rate profile, seeded."""
    rng = random.Random(seed)
    arrivals: List[Arrival] = []
    t0 = 0.0
    for phase in phases:
        t = 0.0
        while True:
            rate = phase.rate_at(t / phase.duration_s)
            if rate <= 0.0:
                break  # a zero rate is silence
            t += rng.expovariate(rate)
            if t >= phase.duration_s:
                break
            arrivals.append((t0 + t, phase.name))
        t0 += phase.duration_s
    return Schedule(arrivals, phases, seed)


def ramp_flash_crowd_drain(*, base_rps: float, peak_rps: float, ramp_s: float, flash_s: float,
                           drain_s: float, flash_multiplier: float = 2.0,
                           seed: int = 0) -> Schedule:
    """``ramp`` (``base_rps`` up to ``peak_rps``), ``flash`` (a step to
    ``flash_multiplier`` times the peak: the crowd that drives the ladder to
    its scale rung) and ``drain`` (the peak back down to ``base_rps``: the
    controller hands capacity back)."""
    if base_rps <= 0 or peak_rps < base_rps:
        raise ValueError("need 0 < base_rps <= peak_rps")
    span = peak_rps - base_rps
    return from_phases([
        Phase("ramp", ramp_s, lambda u: base_rps + span * u),
        Phase("flash", flash_s, flash_multiplier * peak_rps),
        Phase("drain", drain_s, lambda u: peak_rps - span * u),
    ], seed=seed)


def prompt_order(n: int, n_prompts: int, *, seed: int = 0) -> List[int]:
    """Which of ``n_prompts`` prompts each of ``n`` arrivals sends: a seeded
    uniform draw."""
    rng = random.Random(seed)
    return [rng.randrange(n_prompts) for _ in range(n)]
