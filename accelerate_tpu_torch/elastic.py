"""Recovery that survives host loss and a change of world size
(counterpart of ``accelerate_tpu/elastic.py``).

``checkpointing.py`` makes one host's checkpoints atomic and verified;
this module makes a resume survive the loss of a host's disk and a
relaunch at another number of processes:

* **Consensus resume.** Each process contributes its view of the committed
  tree, ``{index: manifest digest}`` (:func:`local_checkpoint_views`);
  every process loads the highest index committed on every process that
  holds any. Two processes holding different bytes for one index raise
  :class:`CheckpointDivergedError` instead of training from skewed state.
* **Replication.** :class:`CheckpointReplicator` mirrors every committed
  checkpoint under ``ReplicationConfig.target``: staged copies verified
  against the manifest, an atomic rename, retries with a doubling backoff,
  a bounded queue where the newest checkpoint wins. A host whose local
  tree is missing or corrupt proves a replica against the replica's own
  manifest before copying it back (:func:`restore_from_replica`).
* **Loader positions across a world change.** A checkpoint's loader
  positions count global batches; :func:`remap_sampler_state` turns them
  into batches of the new global size, conserving samples.

Fault points (``ACCELERATE_TPU_FAULT_INJECT``, ``utils/fault.py``):
``before_replicate``, ``during_replicate``, ``after_replicate`` and
``before_replica_restore``.

A mirror runs inside an ``elastic.replicate`` span (``tracing.py``).
:class:`FleetMembership` is the serving fleet's ledger of replicas
(``fleet.py``). The JAX module's topology block belongs to orbax's
resharding: the port's manifest records the topology in
``checkpointing._topology``.
"""

from __future__ import annotations

import atexit
import collections
import hashlib
import json
import os
import shutil
import threading
import time
from dataclasses import dataclass
from typing import Optional

from . import tracing
from .logging import get_logger
from .state import PartialState
from .utils.constants import (
    CHECKPOINT_COMMITTED_MARKER,
    CHECKPOINT_DIR_PREFIX,
    CHECKPOINT_OLD_SUFFIX,
    CHECKPOINT_STAGING_SUFFIX,
    RNG_STATE_NAME,
)
from .utils.dataclasses import ReplicationConfig
from .utils.fault import (
    CheckpointDivergedError,
    CheckpointError,
    CheckpointNotFoundError,
    ComponentClosedError,
    ReplicaUnavailableError,
    fault_point,
)

logger = get_logger(__name__)

__all__ = [
    "CheckpointReplicator",
    "ConsensusResult",
    "FleetMembership",
    "ReplicationConfig",
    "checkpoint_digest",
    "ensure_local_checkpoint",
    "local_checkpoint_views",
    "manifest_digest",
    "remap_sampler_state",
    "resolve_consensus_checkpoint",
    "restore_from_replica",
]


# ---------------------------------------------------------- manifest digests
def manifest_digest(manifest: dict) -> str:
    """The content fingerprint of a commit manifest, comparable across
    hosts: the sorted (path, size, crc32) triples, the step and the format,
    leaving out the per-rank ``random_states_*.pkl`` files (each process
    writes its own) and the wall-clock ``time``. Two hosts with one index
    and different digests hold different training state."""
    entries = sorted(
        (rel, meta.get("size"), meta.get("crc32"))
        for rel, meta in manifest.get("files", {}).items()
        if not os.path.basename(rel).startswith(RNG_STATE_NAME)
    )
    payload = json.dumps(
        {"files": entries, "step": manifest.get("step"), "format": manifest.get("format")},
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def checkpoint_digest(ckpt_dir: str) -> str:
    """:func:`manifest_digest` of a committed checkpoint directory."""
    from .checkpointing import read_commit_manifest

    return manifest_digest(read_commit_manifest(ckpt_dir))


def local_checkpoint_views(base: str) -> dict:
    """This process's view of the committed tree: ``{index: digest}``."""
    from .checkpointing import checkpoint_index, list_checkpoints

    views = {}
    for path in list_checkpoints(base, committed_only=True):
        idx = checkpoint_index(os.path.basename(path))
        if idx is None:
            continue
        try:
            views[idx] = checkpoint_digest(path)
        except CheckpointError:
            continue  # raced a retention or a commit: absent
    return views


# ------------------------------------------------------------------ consensus
@dataclass
class ConsensusResult:
    """What consensus resolved for one process. ``local_path`` is None when
    this process's tree lacks the consensus checkpoint (empty or behind) and
    must fetch it from a replica. ``missing_ranks``, every rank whose tree
    lacks it, comes from the gathered views and so is the same on every
    rank: whether anyone fetches is decided by all together (the fetch runs
    collectives)."""

    index: int
    digest: str
    local_path: Optional[str]
    missing_ranks: tuple = ()


def _consensus_from_views(views: list, base: str, rank: int) -> Optional[ConsensusResult]:
    """The consensus rule over the gathered views (``views[r]`` is rank r's
    ``{index: digest}``). A rank with an empty view (a wiped disk) does not
    veto: it fetches from a replica later. The index is the highest present
    on every non-empty rank, so a rank one checkpoint behind pulls the
    others back rather than forking. A digest disagreement at that index,
    or non-empty ranks without a common index, raise
    :class:`CheckpointDivergedError`. None when every view is empty."""
    nonempty = [(r, v) for r, v in enumerate(views) if v]
    if not nonempty:
        return None
    common = set(nonempty[0][1])
    for _r, v in nonempty[1:]:
        common &= set(v)
    if not common:
        summary = ", ".join(f"rank {r}: {sorted(v)}" for r, v in nonempty)
        raise CheckpointDivergedError(
            f"no committed checkpoint index is shared by every host under {base}: the hosts' "
            f"histories have diverged ({summary}). Refusing to resume from skewed steps; restore "
            "the replica set or clear the stale trees.")
    index = max(common)
    digests = {v[index] for _r, v in nonempty}
    if len(digests) > 1:
        detail = ", ".join(f"rank {r}: {v[index]}" for r, v in nonempty)
        raise CheckpointDivergedError(
            f"checkpoint_{index} under {base} has DIFFERENT content across hosts (manifest "
            f"digests {detail}). Same index, different bytes: training forked. Refusing to resume.")
    digest = digests.pop()
    mine = views[rank] if rank < len(views) else {}
    local_path = os.path.join(base, f"{CHECKPOINT_DIR_PREFIX}_{index}") if index in mine else None
    missing = tuple(r for r, v in enumerate(views) if index not in v)
    return ConsensusResult(index=index, digest=digest, local_path=local_path,
                           missing_ranks=missing)


def resolve_consensus_checkpoint(base: str) -> Optional[ConsensusResult]:
    """Gather every process's view of ``base`` and apply the consensus rule.
    A collective: every process calls it. None when no process has a
    committed checkpoint (a first launch)."""
    state = PartialState()
    views = state.gather_object(local_checkpoint_views(base))
    result = _consensus_from_views(views, base, state.process_index)
    if result is not None and state.is_main_process:
        holders = sum(1 for v in views if result.index in v)
        logger.info(f"consensus resume: checkpoint_{result.index} (digest {result.digest}, held "
                    f"by {holders}/{len(views)} processes)")
    return result


# ---------------------------------------------------------------- replication
def _copy_roots(config: ReplicationConfig) -> list:
    """The copy slots ``target/r0`` ... ``target/r{copies-1}``."""
    return [os.path.join(config.target, f"r{k}") for k in range(config.copies)]


def _mirror_one(src: str, dst: str, config: ReplicationConfig) -> None:
    """Mirror one committed checkpoint into one slot as a save commits:
    stage a full copy, verify the staged bytes against the manifest, rename.
    A death at any point leaves no replica or a whole verified one."""
    from .checkpointing import read_commit_manifest, verify_checkpoint

    manifest = read_commit_manifest(src)  # src must be committed
    staging = dst + CHECKPOINT_STAGING_SUFFIX
    if os.path.exists(staging):
        shutil.rmtree(staging, ignore_errors=True)
    os.makedirs(staging)
    for rel in sorted(manifest.get("files", {})):
        out = os.path.join(staging, rel)
        os.makedirs(os.path.dirname(out), exist_ok=True)
        shutil.copy2(os.path.join(src, rel), out)
        fault_point("during_replicate")
    # the marker goes last: a staging directory is never committed before
    # every file it lists is on the target
    shutil.copy2(os.path.join(src, CHECKPOINT_COMMITTED_MARKER),
                 os.path.join(staging, CHECKPOINT_COMMITTED_MARKER))
    verify_checkpoint(staging, level=config.verify)
    old = dst + CHECKPOINT_OLD_SUFFIX
    if os.path.exists(dst):
        if os.path.exists(old):
            shutil.rmtree(old, ignore_errors=True)
        os.rename(dst, old)
    os.rename(staging, dst)
    shutil.rmtree(old, ignore_errors=True)


def _gc_replicas(root: str, keep: int) -> None:
    from .checkpointing import list_checkpoints

    for victim in list_checkpoints(root, committed_only=True)[:-keep] if keep else []:
        logger.info(f"replica retention: removing {victim}")
        shutil.rmtree(victim, ignore_errors=True)


class CheckpointReplicator:
    """The mirror of committed checkpoints. ``submit(ckpt_dir)`` (the main
    process, after a commit) queues a mirror job that a daemon thread copies
    into every slot, with retries and a doubling backoff. At most two jobs
    wait: a replicator that falls behind drops the oldest waiting one (the
    newest committed state is the one a recovery wants) and never blocks
    the training loop. ``drain()`` waits for the jobs and raises the first
    deferred failure (``Accelerator.end_training``, the preemption handler
    and interpreter exit call it). With ``async_replicate=False`` the mirror
    runs inside ``submit`` and raises there."""

    _MAX_PENDING = 2

    def __init__(self, config: ReplicationConfig):
        self.config = config
        self._cond = threading.Condition()
        self._pending: collections.deque = collections.deque()
        self._inflight: Optional[str] = None
        self._errors: list = []
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self.last_mirror_s: Optional[float] = None  # seconds of the last whole mirror

    def submit(self, ckpt_dir: str) -> None:
        fault_point("before_replicate")
        if not self.config.async_replicate:
            self._mirror_with_retry(ckpt_dir)
            return
        with self._cond:
            if self._closed:
                raise ComponentClosedError("CheckpointReplicator is closed")
            self._ensure_thread()
            while len(self._pending) >= self._MAX_PENDING:
                dropped = self._pending.popleft()
                logger.warning(f"replication backlog: dropping {dropped} in favor of newer "
                               f"checkpoint {ckpt_dir} (latest-wins)")
            self._pending.append(ckpt_dir)
            self._cond.notify_all()

    def drain(self, timeout: Optional[float] = None) -> None:
        """Wait until every submitted mirror has finished (or ``timeout``
        seconds; None: ``ACCELERATE_BARRIER_TIMEOUT``, unset or 0 waits
        without bound), then raise the first deferred failure."""
        if timeout is None:
            raw = os.environ.get("ACCELERATE_BARRIER_TIMEOUT", "")
            env_timeout = float(raw) if raw else 0.0
            timeout = env_timeout if env_timeout > 0 else None
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._pending or self._inflight is not None:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        logger.warning(f"replication drain timed out with {len(self._pending)} "
                                       "pending mirror(s)")
                        break
                self._cond.wait(remaining)
            errors, self._errors = self._errors, []
        if errors:
            raise errors[0]

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        # joined outside the condition, which the thread needs to finish
        # the mirrors still queued
        if t is not None and t is not threading.current_thread():
            t.join(timeout=30.0)

    @property
    def pending(self) -> int:
        with self._cond:
            return len(self._pending) + (1 if self._inflight else 0)

    def _ensure_thread(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._thread = threading.Thread(target=self._run, name="checkpoint-replicator",
                                        daemon=True)
        self._thread.start()
        atexit.register(self._drain_quietly)

    def _drain_quietly(self) -> None:
        try:
            self.drain()
        except Exception as exc:  # noqa: BLE001 - at exit there is no caller to raise to
            logger.error(f"checkpoint replication failed during exit: {exc}")

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    # a periodic wake: a lost notify delays the exit by one tick
                    self._cond.wait(timeout=1.0)
                if not self._pending:
                    return  # closed and drained
                self._inflight = job = self._pending.popleft()
            try:
                self._mirror_with_retry(job)
            except Exception as exc:  # noqa: BLE001 - raised by drain()
                with self._cond:
                    self._errors.append(exc)
            finally:
                with self._cond:
                    self._inflight = None
                    self._cond.notify_all()

    def _mirror_with_retry(self, src: str) -> None:
        with tracing.span("elastic.replicate", src=src) as sp:
            self._mirror_with_retry_inner(src, sp)

    def _mirror_with_retry_inner(self, src: str, sp) -> None:
        started = time.perf_counter()
        name = os.path.basename(src.rstrip(os.sep))
        failures: list = []
        succeeded = 0
        for root in _copy_roots(self.config):
            os.makedirs(root, exist_ok=True)
            dst = os.path.join(root, name)
            last: Optional[BaseException] = None
            for attempt in range(self.config.max_retries + 1):
                try:
                    _mirror_one(src, dst, self.config)
                    last = None
                    break
                except Exception as exc:  # noqa: BLE001 - retried, then reported
                    last = exc
                    if attempt == self.config.max_retries:
                        break
                    backoff = self.config.retry_backoff_s * (2 ** attempt)
                    logger.warning(f"replica mirror {src} -> {dst} failed (attempt "
                                   f"{attempt + 1}): {exc}; retrying in {backoff:.2f}s")
                    time.sleep(backoff)
            if last is not None:
                # a slot out of retries must not cost the other slots their
                # copy: that would take redundancy away when a target degrades
                logger.warning(f"replica slot {dst} exhausted retries: {last}")
                failures.append((dst, last))
                continue
            succeeded += 1
            if self.config.keep:
                _gc_replicas(root, self.config.keep)
        sp.set("succeeded", succeeded)
        sp.set("failed", len(failures))
        if failures:
            if len(failures) == 1 and succeeded == 0:
                raise failures[0][1]
            detail = "; ".join(f"{dst}: {exc}" for dst, exc in failures)
            raise CheckpointError(
                f"replica mirror of {src} failed for {len(failures)}/{self.config.copies} copy "
                f"slot(s) ({succeeded} succeeded): {detail}") from failures[0][1]
        fault_point("after_replicate")
        self.last_mirror_s = time.perf_counter() - started
        logger.info(f"replicated {src} to {succeeded} cop{'y' if succeeded == 1 else 'ies'} under "
                    f"{self.config.target} in {self.last_mirror_s:.4f}s")


# ------------------------------------------------------------ replica restore
def _replica_candidates(config: ReplicationConfig, name: Optional[str]) -> list:
    """Replica directories, best first: with ``name``, that checkpoint in
    each slot that has it; else every committed replica, newest index
    first, the slots interleaved."""
    from .checkpointing import checkpoint_index, list_checkpoints

    if name is not None:
        return [os.path.join(root, name) for root in _copy_roots(config)
                if os.path.isdir(os.path.join(root, name))]
    ranked = []
    for slot, root in enumerate(_copy_roots(config)):
        for path in list_checkpoints(root, committed_only=True):
            idx = checkpoint_index(os.path.basename(path))
            ranked.append((-(idx if idx is not None else -1), slot, path))
    ranked.sort()
    return [path for _neg, _slot, path in ranked]


def restore_from_replica(config: ReplicationConfig, local_base: str, name: Optional[str] = None,
                         expected_digest: Optional[str] = None) -> str:
    """Copy a verified replica into the local tree and return its path.
    Each candidate is checksum-verified against its own manifest before a
    byte lands locally: a corrupt copy is refused and the next slot tried,
    and :class:`ReplicaUnavailableError` raised when none is left.
    ``expected_digest`` (from consensus) also pins the content. The copy is
    staged and renamed, so a death leaves an ignored ``.tmp``."""
    from .checkpointing import verify_checkpoint

    candidates = _replica_candidates(config, name)
    if not candidates and name is None:
        raise CheckpointNotFoundError(f"no committed replica under {config.target} "
                                      f"({config.copies} copy slot(s) checked)")
    failures = []
    for replica in candidates:
        try:
            verify_checkpoint(replica, level="checksum")
            if expected_digest is not None:
                got = checkpoint_digest(replica)
                if got != expected_digest:
                    raise CheckpointDivergedError(
                        f"replica {replica} digest {got} != consensus digest {expected_digest}")
        except CheckpointError as exc:
            logger.warning(f"replica {replica} refused: {exc}")
            failures.append(f"{replica}: {exc}")
            continue
        fault_point("before_replica_restore")
        started = time.perf_counter()
        dest = os.path.join(local_base, os.path.basename(replica))
        staging = dest + CHECKPOINT_STAGING_SUFFIX
        if os.path.exists(staging):
            shutil.rmtree(staging, ignore_errors=True)
        os.makedirs(local_base, exist_ok=True)
        shutil.copytree(replica, staging)
        verify_checkpoint(staging, level="checksum")
        if os.path.exists(dest):
            shutil.rmtree(dest, ignore_errors=True)
        os.rename(staging, dest)
        logger.warning(f"restored {dest} from replica {replica} (copied and verified in "
                       f"{time.perf_counter() - started:.4f}s)")
        return dest
    raise ReplicaUnavailableError(
        f"no usable replica for {name if name is not None else 'the latest checkpoint'} under "
        f"{config.target}: " + ("; ".join(failures) if failures else "none found"))


def _rehydrate_error(kind: str, msg: str) -> CheckpointError:
    """A peer's checkpoint error rebuilt from its gathered (class name,
    message), so every rank raises the same class (a
    ``CheckpointNotFoundError`` stays a ``FileNotFoundError``, which
    ``resume_from_latest`` reads as a first launch on every rank)."""
    from .utils import fault as _fault

    cls = getattr(_fault, kind, None)
    if not (isinstance(cls, type) and issubclass(cls, CheckpointError)):
        cls = ReplicaUnavailableError
    return cls(msg)


def ensure_local_checkpoint(config: ReplicationConfig, local_base: str, name: Optional[str] = None,
                            expected_digest: Optional[str] = None) -> str:
    """Make checkpoint ``name`` (None: the newest committed replica)
    present and committed under ``local_base``, fetching it from a replica
    when missing. A collective: every process calls it, those that hold the
    tree too. The main process restores first and its outcome, the name or
    a typed failure, reaches every rank as data through a gather (a first
    launch with replication and no replica raises the same error on every
    rank instead of leaving peers at a rendezvous). Then each rank fetches
    its own copy (host-local disks) or finds the main process's (one tree
    shared, as under one machine: restored once), and a second gather
    raises any rank's failure on all."""
    from .checkpointing import is_checkpoint_committed

    state = PartialState()

    def _local(nm: str) -> Optional[str]:
        path = os.path.join(local_base, nm)
        return path if is_checkpoint_committed(path) else None

    if state.num_processes <= 1:
        if name is not None and _local(name):
            return os.path.join(local_base, name)
        return restore_from_replica(config, local_base, name=name, expected_digest=expected_digest)

    verdict: dict = {}
    if state.is_main_process:
        try:
            if name is not None and _local(name):
                restored = os.path.join(local_base, name)
            else:
                restored = restore_from_replica(config, local_base, name=name,
                                                expected_digest=expected_digest)
            verdict = {"name": os.path.basename(restored)}
        except CheckpointError as exc:
            verdict = {"error": type(exc).__name__, "msg": str(exc)}
    verdict = state.gather_object(verdict)[0]
    if "error" in verdict:
        raise _rehydrate_error(verdict["error"], verdict["msg"])
    target_name = verdict["name"]

    # the gather was also the rendezvous after the main process's restore:
    # on a shared tree its copy is committed and visible here
    failure: Optional[tuple] = None
    restored_path = _local(target_name)
    if restored_path is None:
        try:
            restored_path = restore_from_replica(config, local_base, name=target_name,
                                                 expected_digest=expected_digest)
        except CheckpointError as exc:
            failure = (type(exc).__name__, str(exc))
    outcomes = state.gather_object(failure)
    bad = [(r, f) for r, f in enumerate(outcomes) if f is not None]
    if bad:
        detail = "; ".join(f"rank {r}: {kind}: {msg}" for r, (kind, msg) in bad)
        raise ReplicaUnavailableError(f"replica restore of {target_name} failed on {len(bad)}/"
                                      f"{state.num_processes} process(es): {detail}")
    return restored_path


# -------------------------------------------------------------- sampler remap
def remap_sampler_state(sd: dict, old_total_batch: int, new_total_batch: int) -> dict:
    """One loader's saved position across a change of the global batch.
    ``position`` and ``skip_batches`` count global batches of this epoch;
    when the world resizes at a fixed per-process batch, the global batch
    changes and a batch count no longer means the same samples. This
    conserves samples: the resumed loader skips
    ``floor(old_position * old_total_batch / new_total_batch)`` batches of
    the new size. Exact when the samples divide the new global batch; else
    up to ``new_total_batch - 1`` samples are replayed (with a warning),
    the safe direction, as nothing unseen is skipped. An unchanged global
    batch returns ``sd`` itself."""
    if old_total_batch == new_total_batch or old_total_batch <= 0 or new_total_batch <= 0:
        return sd
    out = dict(sd)
    for key in ("position", "skip_batches"):
        if key not in sd:
            continue
        old = int(sd[key])
        samples = old * old_total_batch
        new = samples // new_total_batch
        if samples % new_total_batch:
            logger.warning(
                f"elastic sampler remap: {key}={old} x global batch {old_total_batch} = {samples} "
                f"samples does not divide the new global batch {new_total_batch}; resuming at "
                f"{key}={new} replays {samples - new * new_total_batch} sample(s)")
        out[key] = new
    return out


# ----------------------------------------------------------- fleet membership
class FleetMembership:
    """Replica membership ledger for the serving fleet — the serving twin of
    the training gang's consensus machinery above. Where training elasticity
    is collective (every host votes, then everyone moves together), serving
    elasticity is incremental: replicas join (supervisor relaunch =
    scale-up) and leave (graceful drain = zero-drop scale-down) one at a
    time while the router keeps placing traffic. This ledger makes those
    transitions *observable state changes* instead of silent router-internal
    mutations:

    * a monotonic ``version`` bumped by every join/leave, so pollers can
      cheaply detect "the fleet changed since I last looked";
    * :meth:`snapshot` — a consistent ``{version, members}`` view;
    * :meth:`subscribe` — callbacks ``(event, replica_id, version)`` fired
      on every transition (``event`` is ``"join"`` or ``"leave"``), invoked
      OUTSIDE the ledger lock so a slow subscriber can never wedge a
      scale-down.

    Thread-safe; used by :class:`accelerate_tpu_torch.fleet.FleetRouter` for
    every replica lifecycle change.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._members: dict = {}
        self._version = 0
        self._subscribers: list = []

    @property
    def version(self) -> int:
        with self._lock:
            return self._version

    def join(self, replica_id: str, meta: Optional[dict] = None) -> int:
        """Record a replica joining (idempotent per id — rejoining updates
        its metadata); returns the new membership version."""
        with self._lock:
            self._members[replica_id] = dict(meta or {})
            self._version += 1
            version = self._version
            subscribers = list(self._subscribers)
        self._notify(subscribers, "join", replica_id, version)
        return version

    def leave(self, replica_id: str) -> int:
        """Record a replica leaving (idempotent — a double leave does not
        bump the version); returns the membership version."""
        with self._lock:
            if replica_id not in self._members:
                return self._version
            del self._members[replica_id]
            self._version += 1
            version = self._version
            subscribers = list(self._subscribers)
        self._notify(subscribers, "leave", replica_id, version)
        return version

    def members(self) -> dict:
        """Current ``{replica_id: metadata}`` membership view."""
        with self._lock:
            return {k: dict(v) for k, v in sorted(self._members.items())}

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "version": self._version,
                "members": {k: dict(v) for k, v in self._members.items()},
            }

    def subscribe(self, callback) -> None:
        """Register ``callback(event, replica_id, version)`` for future
        membership transitions."""
        with self._lock:
            self._subscribers.append(callback)

    @staticmethod
    def _notify(subscribers, event: str, replica_id: str, version: int) -> None:
        for cb in subscribers:
            try:
                cb(event, replica_id, version)
            except Exception as exc:  # noqa: BLE001 — observers never wedge lifecycle
                logger.warning(
                    "fleet membership subscriber failed on %s(%s): %s: %s",
                    event, replica_id, type(exc).__name__, exc,
                )
