"""Fault-tolerance primitives of the port (counterpart of
``accelerate_tpu/utils/fault.py``), kept as a copy, not an import: the port
never imports the JAX package.

* The checkpoint error taxonomy: "no checkpoint yet" (a first launch),
  "a save was interrupted" (roll back) and "the bytes on disk disagree
  with the manifest" (refuse to load) are different exceptions.
* ``TrainingHealthError``, raised by the training health watchdog.
* Fault injection (``ACCELERATE_TPU_FAULT_INJECT``): named points in the
  checkpoint lifecycle where a test kills, fails, slows or hangs the
  process, and a programmatic conductor hook for seeded schedules.
* A preemption handler: SIGTERM/SIGINT join in-flight async saves, write
  one committed emergency checkpoint, drain the checkpoint replicator and
  exit with :data:`PREEMPTION_EXIT_CODE` (``os._exit``: nothing can swallow
  it); a signal during a save waits for its commit. Before it exits, the rank leaves a marker in
  ``ACCELERATE_PREEMPTION_DIR`` (exported by the launch supervisor): under
  torchrun, which exits 1 whatever its workers' codes, the markers are how
  the supervisor tells a planned shutdown from a crash.
* The serving errors the ported engine and server raise. ``retriable`` and
  ``replica_id`` are the routing contract a caller reads instead of
  parsing the message.

* The KV transfer errors of disaggregated prefill (``kvtransfer.py``):
  :class:`KVTransferError` and its three kinds, each ``retriable`` (the
  decode side can always recompute the prompt forward itself).
* The serving control plane's and the fleet's: :class:`CircuitOpenError`
  (the server's breaker is open), :class:`NoHealthyReplicaError` and
  :class:`FailoverExhaustedError` (``fleet.py``), and the findings of the
  perf observatory (``perfwatch.py``): :class:`PerfDriftError` and its
  fleet kind :class:`ReplicaBrownoutError`; the SLO controller's
  fail-static finding :class:`ControllerStaleError` (``controller.py``).
"""

from __future__ import annotations

import contextlib
import logging
import os
import random
import signal
import sys
import threading
import time
import zlib
from typing import Optional

__all__ = [
    "CheckpointError",
    "CheckpointNotFoundError",
    "CheckpointUncommittedError",
    "CheckpointCorruptError",
    "CheckpointComponentMissingError",
    "CheckpointDivergedError",
    "CheckpointTopologyError",
    "ReplicaUnavailableError",
    "BarrierTimeoutError",
    "TrainingHealthError",
    "ComponentClosedError",
    "FaultInjected",
    "fault_point",
    "install_conductor",
    "uninstall_conductor",
    "release_hang",
    "release_all_hangs",
    "reset_fault_state",
    "install_preemption_handler",
    "preemption_requested",
    "preemption_deferred",
    "emergency_exit",
    "mark_save_started",
    "mark_save_finished",
    "PREEMPTION_EXIT_CODE",
    "PREEMPTION_DIR_ENV",
    "FAULT_INJECT_ENV",
    "FAULT_SEED_ENV",
    "ServingError",
    "ServerOverloaded",
    "RequestDeadlineExceeded",
    "CircuitOpenError",
    "ServerDrainingError",
    "BatchExecutionError",
    "ReplicaDeadError",
    "NoHealthyReplicaError",
    "FailoverExhaustedError",
    "EngineCapacityError",
    "PerfDriftError",
    "ReplicaBrownoutError",
    "ControllerStaleError",
    "EngineInvariantError",
    "KVTransferError",
    "TransferAbortedError",
    "TransferStaleEpochError",
    "TransferCorruptError",
]

# 128 + SIGTERM: "terminated on request"
PREEMPTION_EXIT_CODE = 143

# the directory where each rank leaves ``preempted.<LOCAL_RANK>`` when its
# preemption handler has committed the emergency checkpoint and exits
PREEMPTION_DIR_ENV = "ACCELERATE_PREEMPTION_DIR"

FAULT_INJECT_ENV = "ACCELERATE_TPU_FAULT_INJECT"
# seed of the per-entry random streams behind ``flaky=p`` specs: the same
# seed fires the same sequence
FAULT_SEED_ENV = "ACCELERATE_TPU_FAULT_SEED"


# ------------------------------------------------------------ error taxonomy
class CheckpointError(RuntimeError):
    """Base class of checkpoint load and save failures."""


class CheckpointNotFoundError(CheckpointError, FileNotFoundError):
    """The checkpoint directory does not exist (nothing was saved there).
    A ``FileNotFoundError``, so ``resume_from_latest`` reads it as a first
    launch."""


class CheckpointUncommittedError(CheckpointError):
    """The directory exists but has no ``COMMITTED`` manifest: a save was
    interrupted before its atomic commit. Load a committed checkpoint."""


class CheckpointCorruptError(CheckpointError):
    """The ``COMMITTED`` manifest is there but the bytes on disk disagree
    with it (a missing file, another size, a checksum mismatch) or the
    manifest itself does not parse."""


class CheckpointComponentMissingError(CheckpointError):
    """A component the live training state needs (a prepared model) has no
    counterpart in the checkpoint directory."""


class CheckpointDivergedError(CheckpointError):
    """Consensus resume found hosts whose manifests disagree about the
    content of one checkpoint index, or whose committed histories share no
    index: resuming would fork the replicas, so it is refused."""


class CheckpointTopologyError(CheckpointError):
    """The checkpoint's commit manifest records another world size than
    the live one and the load was not asked for with ``elastic=True``;
    raised before any tensor is read, naming both."""


class ReplicaUnavailableError(CheckpointError):
    """A replica restore was needed (the local tree is missing or corrupt)
    and no replica copy passed its checksum verification."""


class BarrierTimeoutError(RuntimeError):
    """``PartialState.wait_for_everyone`` gave up waiting at a barrier (a
    ``timeout`` or ``ACCELERATE_BARRIER_TIMEOUT``): a peer process is dead
    or stuck. Names the barrier's tag."""


class TrainingHealthError(RuntimeError):
    """Raised by the training health watchdog when its non-finite policy is
    ``"raise"`` or ``max_bad_steps`` consecutive bad steps are reached."""


class ComponentClosedError(RuntimeError):
    """A method was called on a closed component (``AsyncTrackerFlusher``)."""


class ServingError(RuntimeError):
    """Base class of the server's failures. ``retry_after_s`` is the
    raiser's estimate of when a retry could succeed (``None``: no
    estimate)."""

    retriable: bool = False

    def __init__(self, *args, replica_id: Optional[str] = None,
                 retry_after_s: Optional[float] = None):
        super().__init__(*args)
        self.replica_id = replica_id
        self.retry_after_s = retry_after_s


class ServerOverloaded(ServingError):
    """The bounded admission queue is full: backpressure, resubmit later."""

    retriable = True


class RequestDeadlineExceeded(ServingError):
    """The request's deadline passed before it finished."""

    retriable = False


class CircuitOpenError(ServingError):
    """The server's circuit breaker is open after consecutive failed batch
    attempts: it fails fast instead of queueing onto a broken backend.
    Resubmit after the breaker's reset window (``retry_after_s``)."""

    retriable = True


class ServerDrainingError(ServingError):
    """The server is draining or closed; queued requests are rejected."""

    retriable = True


class BatchExecutionError(ServingError):
    """The engine program this request rode in failed. ``__cause__``
    carries the underlying exception."""

    retriable = False


class ReplicaDeadError(BatchExecutionError):
    """The serving worker died with this request still in a slot. The
    request itself is fine, so it may be retried elsewhere."""

    retriable = True


class NoHealthyReplicaError(ServingError):
    """The fleet router found no replica able to take the request now:
    every one is draining, dead, breaker-open or refused admission.
    Replicas heal, respawn and drain their queues: back off and resubmit."""

    retriable = True


class FailoverExhaustedError(ServingError):
    """Failover gave up on the request: its per-request cap was reached or
    the fleet-wide retry budget was empty, the backstop that keeps an
    outage from turning into a retry storm. ``__cause__`` carries the last
    replica's error. Retriable by the client after a backoff (the budget
    refills); the router itself retries no further."""

    retriable = True


class EngineCapacityError(ServingError):
    """No free slot or KV block for this request right now (callers gate
    on ``free_slots()`` / ``can_admit()``)."""

    retriable = True


class KVTransferError(ServingError):
    """Base class of the KV transfer failures (``kvtransfer.py``, the wire
    of disaggregated prefill). Each kind is retriable: a failed transfer
    never dooms the request, whose prompt forward the decode side can run
    itself."""

    retriable = True


class TransferAbortedError(KVTransferError):
    """The transfer died mid-stream: the sender or the connection was
    lost, a deadline passed, the receiver had no slot, or a fault was
    injected. The receiver drops its staging and releases the slot
    reservation; nothing reached the pool, so a retry (fresh transfer id,
    fresh reservation) or a local prefill are both safe."""

    retriable = True


class TransferStaleEpochError(KVTransferError):
    """The transfer's slot reservation is stale: the slot was released
    (deadline, reservation TTL, engine reset) and perhaps given to another
    request while the stream was in flight, so the late prefill must never
    land. The request may be retried with a fresh transfer; this transfer
    id must not be replayed."""

    retriable = True


class TransferCorruptError(KVTransferError):
    """A frame or payload failed verification: a chunk's crc32, the whole
    payload's at COMMIT, the framing, or the payload's encoding. Staging
    is dropped; a retry re-sends from the sender's copy."""

    retriable = True


class EngineInvariantError(RuntimeError):
    """An engine-internal invariant broke; the engine state cannot be
    trusted and the caller should ``reset()``."""


class PerfDriftError(RuntimeError):
    """A program's measured time sat outside the tolerance band around its
    committed prediction for ``drift_consecutive`` evaluations in a row
    (the perfwatch drift sentinel). Carries the program and both sides of
    the comparison."""

    def __init__(self, program: str, measured_s: float, predicted_s: float,
                 tolerance: float):
        self.program = program
        self.measured_s = measured_s
        self.predicted_s = predicted_s
        self.tolerance = tolerance
        super().__init__(
            f"perf drift on {program}: measured {measured_s:.6f}s vs "
            f"predicted {predicted_s:.6f}s (tolerance {tolerance:.0%})"
        )


class ReplicaBrownoutError(PerfDriftError):
    """A replica has been browned out (slow or hanging health probes, or a
    perfwatch residual past its band, while it still answers as alive) for
    longer than ``FleetConfig.brownout_drain_after_s``. Filed, never
    raised, by the fleet router into perfwatch's findings, so a consumer of
    :class:`PerfDriftError` findings drains and replaces it;
    ``replica_id`` names it (``program``/``measured_s``/``predicted_s``
    keep the drift finding's shape)."""

    def __init__(self, replica_id: str, *, score: float,
                 probe_ewma_s: float, threshold_s: float,
                 sustained_s: float):
        self.replica_id = replica_id
        self.score = score
        self.sustained_s = sustained_s
        self.program = f"fleet/replica/{replica_id}"
        self.measured_s = probe_ewma_s
        self.predicted_s = threshold_s
        self.tolerance = 0.0
        RuntimeError.__init__(
            self,
            f"replica {replica_id} browned out for {sustained_s:.1f}s "
            f"(score {score:.2f}, probe ewma {probe_ewma_s:.4f}s vs "
            f"threshold {threshold_s:.4f}s); drain and replace"
        )


class ControllerStaleError(RuntimeError):
    """The SLO controller's telemetry was stale or partial at a tick: the
    prober has not refreshed the fleet snapshot within ``stale_after_s``,
    or fewer than ``min_coverage`` of the live replicas answered a health
    read. Recorded, never raised across the control loop, by
    :class:`accelerate_tpu_torch.controller.SLOController` as its
    fail-static finding: actuation freezes until telemetry is fresh again.
    Carries the evidence (``reason``, ``age_s``, ``coverage``)."""

    def __init__(self, reason: str, *, age_s: Optional[float] = None,
                 coverage: Optional[float] = None):
        self.reason = reason
        self.age_s = age_s
        self.coverage = coverage
        detail = []
        if age_s is not None:
            detail.append(f"snapshot age {age_s:.3f}s")
        if coverage is not None:
            detail.append(f"replica coverage {coverage:.0%}")
        suffix = f" ({', '.join(detail)})" if detail else ""
        super().__init__(
            f"controller telemetry unusable: {reason}{suffix} — "
            "actuation frozen (fail-static)"
        )


class FaultInjected(RuntimeError):
    """Raised by :func:`fault_point` for ``point:raise`` specs."""


# ------------------------------------------------------------ fault injection
# Per-entry state, keyed by the raw spec entry, so two entries arming the
# same point keep their own hit counters and random streams. Process-wide,
# as the signals and the environment variable they serve are.
_FAULT_LOCK = threading.Lock()
_FAULT_HITS: dict = {}
_FAULT_RNGS: dict = {}
_HANG_EVENTS: dict = {}
_HANG_DEFAULT_CAP_S = 30.0
_CONDUCTOR = None


def install_conductor(fn) -> None:
    """Install a hook ``fn(name, context)`` that every :func:`fault_point`
    hit consults before the environment's spec (seeded, phase-windowed
    schedules a string cannot express). One at a time."""
    global _CONDUCTOR
    _CONDUCTOR = fn


def uninstall_conductor(fn=None) -> None:
    """Remove the hook; with ``fn``, only if it is still the one installed."""
    global _CONDUCTOR
    if fn is None or _CONDUCTOR is fn:
        _CONDUCTOR = None


def release_hang(name: str) -> bool:
    """Release threads blocked at a ``hang``-armed point. Returns whether
    one was armed at ``name``."""
    with _FAULT_LOCK:
        event = _HANG_EVENTS.get(name)
    if event is None:
        return False
    event.set()
    return True


def release_all_hangs() -> None:
    with _FAULT_LOCK:
        events = list(_HANG_EVENTS.values())
    for event in events:
        event.set()


def reset_fault_state() -> None:
    """Reset hit counters, ``flaky`` streams and hang latches."""
    release_all_hangs()
    with _FAULT_LOCK:
        _FAULT_HITS.clear()
        _FAULT_RNGS.clear()
        _HANG_EVENTS.clear()


def _entry_rng(key: str) -> random.Random:
    # crc32, not hash(): hash() is salted per process
    seed = os.environ.get(FAULT_SEED_ENV, "0")
    return random.Random(zlib.crc32(f"{seed}|{key}".encode()))


def _fire_action(name: str, action: str) -> None:
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif action == "exit":
        os._exit(17)
    elif action == "raise":
        raise FaultInjected(name)
    elif action == "sleep" or action.startswith("sleep="):
        _, _, dur = action.partition("=")
        time.sleep(float(dur) if dur else 0.05)
    elif action == "hang" or action.startswith("hang="):
        _, _, cap = action.partition("=")
        with _FAULT_LOCK:
            event = _HANG_EVENTS.setdefault(name, threading.Event())
        event.wait(float(cap) if cap else _HANG_DEFAULT_CAP_S)
    else:
        raise ValueError(
            f"unknown fault action {action!r} for point {name!r} "
            "(expected kill|exit|raise|sleep[=s]|hang[=s])"
        )


_FAULT_MODIFIERS = ("flaky", "after", "every")


def fault_point(name: str, **context) -> None:
    """Fault-injection hook: if ``ACCELERATE_TPU_FAULT_INJECT`` names this
    point, act here. The spec is a comma-separated list of
    ``point[:action][:modifier...]`` entries. Actions: ``kill`` (the
    default; SIGKILL, as a host loss: nothing else runs), ``exit``
    (``os._exit(17)``), ``raise`` (:class:`FaultInjected`),
    ``sleep[=s]`` and ``hang[=cap_s]`` (until :func:`release_hang`).
    Modifiers: ``flaky=p`` (fire with probability p from a stream seeded by
    ``ACCELERATE_TPU_FAULT_SEED`` and the entry; alone it implies
    ``raise``), ``after=N`` (skip the first N hits), ``every=N``.
    ``context`` goes to an installed conductor only.

    Checkpointing calls it at ``after_model_save``,
    ``after_optimizer_save``, ``before_commit``, ``before_rename`` and
    ``before_gc``; replication (``elastic.py``) at ``before_replicate``
    (after the commit, before any mirror work), ``during_replicate``
    (between the file copies into a replica's staging directory),
    ``after_replicate`` (after a replica's commit) and
    ``before_replica_restore`` (before a verified replica is copied back).
    The variable is read at each call, so a script can arm a point between
    two saves."""
    conductor = _CONDUCTOR
    if conductor is not None:
        conductor(name, context)
    spec = os.environ.get(FAULT_INJECT_ENV)
    if not spec:
        return
    for item in spec.split(","):
        entry = item.strip()
        point, _, tail = entry.partition(":")
        if point != name:
            continue
        action = None
        flaky = None
        after = 0
        every = 1
        for token in filter(None, tail.split(":")):
            mod, _, value = token.partition("=")
            if mod in _FAULT_MODIFIERS:
                if mod == "flaky":
                    flaky = float(value)
                elif mod == "after":
                    after = int(value)
                else:
                    every = max(1, int(value))
            elif action is None:
                action = token
            else:
                raise ValueError(
                    f"fault entry {entry!r}: second action {token!r} (one action per "
                    f"entry; modifiers are {'/'.join(_FAULT_MODIFIERS)})"
                )
        if action is None:
            action = "kill" if flaky is None and tail == "" else "raise"
        with _FAULT_LOCK:
            hits = _FAULT_HITS.get(entry, 0) + 1
            _FAULT_HITS[entry] = hits
            if flaky is not None and entry not in _FAULT_RNGS:
                _FAULT_RNGS[entry] = _entry_rng(entry)
            rng = _FAULT_RNGS.get(entry)
            if hits <= after or (hits - after - 1) % every != 0:
                continue
            # drawn inside the lock and only on eligible hits: the stream's
            # position is a function of (seed, entry, eligible hit)
            if flaky is not None and rng.random() >= flaky:
                continue
        _fire_action(name, action)


# ---------------------------------------------------------------- preemption
_PREEMPTION = {
    "requested": False,  # a handled signal arrived
    "in_save": False,  # a save_state is in flight: the exit waits for it
    "in_handler": False,  # the handler's own emergency save is running
    "installed": False,
    "deferred": 0,  # inside preemption_deferred(): the caller saves at a point it chooses
}


def preemption_requested() -> bool:
    """Whether a handled SIGTERM/SIGINT has arrived in this process."""
    return _PREEMPTION["requested"]


@contextlib.contextmanager
def preemption_deferred():
    """Inside, a handled signal only records the request
    (:func:`preemption_requested`). Several ranks whose emergency save is
    collective must save at one point: a rank that saved from the handler
    in the middle of a step would meet its peers' step collectives with the
    save's. The caller agrees on a step boundary (a gather of the flags)
    and calls :func:`emergency_exit` there on every rank."""
    _PREEMPTION["deferred"] += 1
    try:
        yield
    finally:
        _PREEMPTION["deferred"] -= 1


def emergency_exit(accelerator, exit_code: int = PREEMPTION_EXIT_CODE) -> None:
    """What the handler does, called where the caller chose: join async
    saves, write the committed emergency checkpoint, drain the replicator,
    leave the rank's marker and exit with ``exit_code``."""
    _PREEMPTION["requested"] = True
    _PREEMPTION["in_handler"] = True  # a later signal is absorbed
    _emergency_save(accelerator, signal.SIGTERM)
    _report_preempted()
    _exit_committed(exit_code)


def install_preemption_handler(accelerator, signals: tuple = (signal.SIGTERM, signal.SIGINT),
                               exit_code: int = PREEMPTION_EXIT_CODE) -> bool:
    """On the first handled signal: join in-flight async saves, write one
    committed ``save_state``, finish the trackers and exit with
    ``exit_code``. A signal during a ``save_state`` only sets the flag: the
    save finishes its commit and exits right after
    (:func:`mark_save_finished`). Handlers can be installed from the main
    thread only: elsewhere this returns False."""
    if threading.current_thread() is not threading.main_thread():
        return False

    def _handler(signum, frame):
        _PREEMPTION["requested"] = True
        if _PREEMPTION["in_save"] or _PREEMPTION["in_handler"] or _PREEMPTION["deferred"]:
            return
        _PREEMPTION["in_handler"] = True
        try:
            _emergency_save(accelerator, signum)
        except BaseException:
            _PREEMPTION["in_handler"] = False
            raise
        # in_handler stays set: a signal that arrives on the way out (torchrun
        # passes one on to the ranks still running) is absorbed
        _report_preempted()
        _exit_committed(exit_code)

    for sig in signals:
        signal.signal(sig, _handler)
    _PREEMPTION["installed"] = True
    return True


def _emergency_save(accelerator, signum: int) -> None:
    from ..checkpointing import wait_for_async_saves
    from ..logging import get_logger

    logger = get_logger(__name__)
    logger.warning("received signal %d: writing an emergency checkpoint before exit", signum)
    wait_for_async_saves()
    try:
        path = accelerator.save_state()
        logger.warning("emergency checkpoint committed at %s", path)
        print(f"emergency checkpoint committed at {path}", flush=True)
        # the emergency checkpoint's mirror lands too: a half-mirrored
        # replica would stay an uncommitted staging directory
        drain = getattr(accelerator, "wait_for_replication", None)
        if drain is not None:
            drain()
    finally:
        accelerator.end_training()


def _report_preempted() -> None:
    """Leave ``preempted.<LOCAL_RANK>`` in ``ACCELERATE_PREEMPTION_DIR``:
    this rank committed its emergency checkpoint and exits on purpose."""
    directory = os.environ.get(PREEMPTION_DIR_ENV)
    if not directory:
        return
    try:
        with open(os.path.join(directory, f"preempted.{os.environ.get('LOCAL_RANK', '0')}"),
                  "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass


def mark_save_started() -> None:
    """A ``save_state`` enters its critical section: a signal now waits."""
    _PREEMPTION["in_save"] = True


def mark_save_finished(accelerator=None, path: Optional[str] = None,
                       exit_code: Optional[int] = None) -> None:
    """A ``save_state`` committed (or, async, staged). If a signal waited
    behind it, that checkpoint is the emergency checkpoint: land any
    deferred async commit, report it and exit."""
    _PREEMPTION["in_save"] = False
    if (not (_PREEMPTION["requested"] and _PREEMPTION["installed"]) or _PREEMPTION["in_handler"]
            or _PREEMPTION["deferred"]):
        return
    from ..checkpointing import wait_for_async_saves
    from ..logging import get_logger

    get_logger(__name__).warning(
        "a preemption signal arrived during save_state; the committed checkpoint is the "
        "emergency checkpoint: exiting")
    try:
        wait_for_async_saves()
        drain = getattr(accelerator, "wait_for_replication", None)
        if drain is not None:
            try:
                drain()
            except Exception:  # noqa: BLE001 - exiting; a replica gap heals on resume
                pass
        if path is not None:
            print(f"emergency checkpoint committed at {path}", flush=True)
    finally:
        if accelerator is not None:
            accelerator.end_training()
    _report_preempted()
    _exit_committed(exit_code if exit_code is not None else PREEMPTION_EXIT_CODE)


def _exit_committed(exit_code: int) -> None:
    """End the process with ``exit_code`` once its emergency checkpoint is
    committed. Not ``sys.exit``: the handler runs in whatever frame the
    signal interrupted, and some frames drop what is raised in them. A
    file object's finalizer flushes its buffer, checks for signals there
    and clears the handler's ``SystemExit``; the training loop then went on
    past its emergency checkpoint and exited 0. What the interpreter's exit
    would still do for the port, ``end_training`` has done (async saves
    joined, the replicator drained, trackers finished); the standard
    streams and the logging handlers are flushed here."""
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):  # closed or gone: nothing left to flush
            pass
    logging.shutdown()
    os._exit(exit_code)


def _save_failed() -> None:
    """A ``save_state`` raised: leave the critical section, so a later
    signal is not deferred behind a save that will never finish."""
    _PREEMPTION["in_save"] = False
