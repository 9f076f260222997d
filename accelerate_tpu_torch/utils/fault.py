"""The error types the ported engine and server raise (counterpart of the
serving half of ``accelerate_tpu/utils/fault.py``). Kept as a copy, not an
import: the port never imports the JAX package.

``retriable`` and ``replica_id`` are the routing contract a caller reads
instead of parsing the message: load and lifecycle conditions are
retriable, a passed deadline or a failed batch is not."""

from __future__ import annotations

from typing import Optional

__all__ = [
    "ServingError",
    "ServerOverloaded",
    "RequestDeadlineExceeded",
    "ServerDrainingError",
    "BatchExecutionError",
    "ReplicaDeadError",
    "EngineCapacityError",
    "EngineInvariantError",
]


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


class EngineCapacityError(ServingError):
    """No free slot or KV block for this request right now (callers gate
    on ``free_slots()`` / ``can_admit()``)."""

    retriable = True


class EngineInvariantError(RuntimeError):
    """An engine-internal invariant broke; the engine state cannot be
    trusted and the caller should ``reset()``."""
