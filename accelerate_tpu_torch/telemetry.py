"""Step telemetry that keeps the host ahead of the card (counterpart of
``accelerate_tpu/telemetry.py``).

* :func:`health_summary`: the finiteness of the loss and of every float
  gradient, and the global gradient norm, reduced on the device into one
  f32[3] tensor ``[loss_finite, grads_finite, grad_norm]``, so a health
  check reads one small tensor back, never one per gradient.
* :class:`DeferredReadbackRing`: each step's summary is copied into pinned
  host memory as soon as the card computes it (a non-blocking copy and an
  event, :func:`start_readback`), and only the summary ``depth`` steps old
  is read: the host waits for that copy's event, not for the step it just
  launched. Verdicts arrive ``depth`` steps late.
* :class:`AsyncTrackerFlusher`: a thread that reads logged device values
  back and writes tracker batches off the training loop.
* :class:`LatencyReservoir`: a bounded window of samples and its
  percentiles.

Every telemetry read goes through :func:`_fetch`, so a test counts
device-to-host reads by replacing that one function.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import tracing
from .logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "AsyncTrackerFlusher",
    "DeferredReadbackRing",
    "LatencyReservoir",
    "StepHealth",
    "health_summary",
    "materialize_metrics",
    "read_summary",
    "start_readback",
]

# "no gradient norm in this summary": a real norm is >= 0, and a NaN norm
# is data (non-finite gradients)
_NORM_UNSET = -1.0


class _Readback(NamedTuple):
    """A device value's copy into pinned host memory and the event after
    it."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event]


def start_readback(value: torch.Tensor) -> _Readback:
    """Start copying ``value`` to the host without waiting: on the card, a
    non-blocking copy into pinned memory on the current stream and an
    event recorded after it."""
    if not value.is_cuda:
        return _Readback(value.detach().clone(), None)
    host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
    host.copy_(value.detach(), non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(value.device))
    return _Readback(host, event)


def _fetch(value) -> np.ndarray:
    """The telemetry's device-to-host read: a started readback waits for
    its own event only; a tensor is copied (waiting for its stream)."""
    if isinstance(value, _Readback):
        if value.event is not None:
            value.event.synchronize()
        return value.host.numpy()
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _float_leaves(grads):
    if grads is None:
        return []
    if isinstance(grads, dict):
        leaves = list(grads.values())
    elif isinstance(grads, (list, tuple)):
        leaves = list(grads)
    else:
        leaves = [grads]
    out = []
    for g in leaves:
        if isinstance(g, (dict, list, tuple)):
            out.extend(_float_leaves(g))
        elif isinstance(g, torch.Tensor) and g.is_floating_point():
            out.append(g.detach())
    return out


def health_summary(loss=None, grads=None, grad_norm=None) -> torch.Tensor:
    """``[loss_finite, grads_finite, grad_norm]`` as one f32[3] tensor on the
    device: ``grads`` (a tensor, or a dict/list tree of them; non-float
    leaves are ignored) is finite when every element's magnitude is (one
    per-tensor max per leaf, NaN-propagating); the norm is ``grad_norm``
    when given (the clipping's), else the f32 global L2 norm of the float
    leaves, else -1. Nothing is read back: pair with :func:`read_summary`
    or the ring."""
    leaves = _float_leaves(grads)
    device = next((t.device for t in ([loss] if isinstance(loss, torch.Tensor) else []) + leaves),
                  torch.device("cpu"))
    one = torch.ones((), dtype=torch.float32, device=device)
    if loss is None:
        loss_ok = one
    else:
        loss_ok = torch.isfinite(torch.as_tensor(loss, dtype=torch.float32, device=device)).all()
    if leaves:
        amax = torch.stack([t.float() for t in torch._foreach_norm(leaves, float("inf"))])
        grads_ok = torch.isfinite(amax).all()
    else:
        grads_ok = one
    if grad_norm is not None:
        norm = torch.as_tensor(grad_norm, dtype=torch.float32, device=device).reshape(())
    elif leaves:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g, dtype=torch.float32) for g in leaves]))
    else:
        norm = torch.full((), _NORM_UNSET, dtype=torch.float32, device=device)
    return torch.stack([loss_ok.float(), grads_ok.float(), norm])


class StepHealth(NamedTuple):
    """The host's verdict on one step's summary."""

    step: int
    loss_finite: bool
    grads_finite: bool
    grad_norm: Optional[float]

    @property
    def healthy(self) -> bool:
        return self.loss_finite and self.grads_finite


def read_summary(summary, step: int) -> StepHealth:
    """Read a :func:`health_summary` (or its started readback) on the host
    and decode it."""
    vals = _fetch(summary)
    norm = float(vals[2])
    return StepHealth(step=step, loss_finite=bool(vals[0] != 0.0),
                      grads_finite=bool(vals[1] != 0.0),
                      grad_norm=None if norm == _NORM_UNSET else norm)


class DeferredReadbackRing:
    """A bounded FIFO of in-flight values: ``push`` returns the entries that
    matured (pushed ``depth`` pushes ago)."""

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"ring depth must be >= 1, got {depth}")
        self.depth = depth
        self._entries: collections.deque = collections.deque()

    def push(self, entry) -> list:
        self._entries.append(entry)
        matured = []
        while len(self._entries) > self.depth:
            matured.append(self._entries.popleft())
        return matured

    def popleft(self):
        return self._entries.popleft()

    def drain(self) -> list:
        out = list(self._entries)
        self._entries.clear()
        return out

    def clear(self) -> None:
        self._entries.clear()

    def __len__(self) -> int:
        return len(self._entries)


class LatencyReservoir:
    """The last ``size`` samples and their percentiles; thread-safe."""

    def __init__(self, size: int = 2048):
        if size < 1:
            raise ValueError(f"reservoir size must be >= 1, got {size}")
        self._samples: collections.deque = collections.deque(maxlen=size)
        self._lock = threading.Lock()
        self._count = 0

    def add(self, value: float) -> None:
        with self._lock:
            self._samples.append(float(value))
            self._count += 1

    @property
    def count(self) -> int:
        """Samples ever recorded."""
        return self._count

    def percentile(self, p: float) -> Optional[float]:
        with self._lock:
            if not self._samples:
                return None
            data = sorted(self._samples)
        return data[min(len(data) - 1, max(0, int(round(p / 100.0 * (len(data) - 1)))))]

    def snapshot(self, prefix: str = "") -> dict:
        """``<prefix>count``, ``p50``, ``p99`` and ``max`` over the window."""
        with self._lock:
            data = sorted(self._samples)
            count = self._count
        if not data:
            return {f"{prefix}count": count}

        def pick(p):
            return data[min(len(data) - 1, int(round(p / 100.0 * (len(data) - 1))))]

        return {f"{prefix}count": count, f"{prefix}p50": pick(50), f"{prefix}p99": pick(99),
                f"{prefix}max": data[-1]}


def materialize_metrics(values: dict) -> dict:
    """Tensor values as host scalars or arrays (one :func:`_fetch` each);
    other values pass through as logged."""
    out = {}
    for key, val in values.items():
        if isinstance(val, torch.Tensor):
            host = _fetch(val)
            out[key] = host.item() if host.size == 1 else host
        else:
            out[key] = val
    return out


_STOP = object()


class AsyncTrackerFlusher:
    """Tracker writes off the training loop: :meth:`submit` only enqueues
    (values may be device tensors: no read, no wait); a thread reads them
    back and hands each tracker the batch that accumulated
    (``log_batch``: one write and flush per wakeup). A tracker's error is
    recorded, the other trackers still get the batch, and the first error
    is raised by :meth:`flush` or :meth:`close`."""

    # after the first record, wait this long for more before writing
    COALESCE_S = 0.05
    # flush and close give up after this long, or at once when the thread
    # is dead: end_training must not hang on a wedged tracker
    DRAIN_TIMEOUT_S = 60.0

    def __init__(self, trackers, name: str = "tracker-flush"):
        self.trackers = trackers
        self._queue: queue.Queue = queue.Queue()
        self._errors: list = []
        self._closed = False
        self._draining = threading.Event()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    def submit(self, values: dict, step=None, log_kwargs: Optional[dict] = None) -> None:
        if self._closed:
            from .utils.fault import ComponentClosedError

            raise ComponentClosedError("AsyncTrackerFlusher is closed")
        self._queue.put((values, step, log_kwargs or {}))

    def _loop(self):
        while True:
            item = self._queue.get()
            if item is not _STOP and not self._draining.is_set():
                self._draining.wait(self.COALESCE_S)
            batch = [item]
            while True:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            entries = [e for e in batch if e is not _STOP]
            if entries:
                self._write(entries)
            for _ in batch:
                self._queue.task_done()
            if any(e is _STOP for e in batch):
                return

    def _write(self, entries):
        with tracing.span("telemetry.flush_drain", batches=len(entries),
                          trackers=len(self.trackers)):
            self._write_entries(entries)

    def _write_entries(self, entries):
        materialized = []
        for values, step, log_kwargs in entries:
            try:
                materialized.append((materialize_metrics(values), step, log_kwargs))
            except Exception as exc:  # noqa: BLE001 - recorded, raised by flush/close
                self._record(exc)
        for tracker in self.trackers:
            per_tracker = [(values, step, kw.get(tracker.name, {}))
                           for values, step, kw in materialized]
            try:
                tracker.log_batch(per_tracker)
            except Exception as exc:  # noqa: BLE001 - recorded, raised by flush/close
                self._record(exc)

    def _record(self, exc: BaseException) -> None:
        if not self._errors:
            self._errors.append(exc)
        logger.warning(f"async tracker flush failed: {type(exc).__name__}: {exc}")

    def _raise_pending(self):
        if self._errors:
            raise self._errors.pop(0)

    def _drain_queue(self) -> bool:
        """``queue.join()`` with a deadline: True when every record was
        processed, False on timeout or a dead thread."""
        deadline = time.monotonic() + self.DRAIN_TIMEOUT_S
        q = self._queue
        with q.all_tasks_done:
            while q.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._thread.is_alive():
                    return False
                q.all_tasks_done.wait(min(remaining, 0.2))
        return True

    def flush(self) -> None:
        """Wait (bounded) until every submitted record was written or
        failed; raise the first deferred tracker error."""
        self._draining.set()
        try:
            if not self._drain_queue():
                logger.warning(f"tracker flush gave up after {self.DRAIN_TIMEOUT_S:.0f}s with "
                               f"{self._queue.unfinished_tasks} record(s) unwritten")
        finally:
            self._draining.clear()
        self._raise_pending()

    def close(self) -> None:
        """Flush, stop the thread, raise deferred errors. Idempotent."""
        if not self._closed:
            self._closed = True
            self._draining.set()
            self._queue.put(_STOP)
            if not self._drain_queue():
                logger.warning(f"tracker close gave up after {self.DRAIN_TIMEOUT_S:.0f}s with "
                               f"{self._queue.unfinished_tasks} record(s) unwritten")
            self._thread.join(timeout=30)
        self._raise_pending()
