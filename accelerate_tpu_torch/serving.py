"""Serving in continuous mode (counterpart of ``accelerate_tpu/serving.py``
``mode="continuous"``).

One daemon worker thread owns the engine and the whole dispatch cycle:
admit queued requests into free slots (each admission runs the prompt
forward, or the first chunk of a long prompt), run one engine tick over
every slot (pending chunks, then a decode or speculative verify step),
read back the matured results, reply to retired requests, and shed
requests past their deadline. ``submit`` only validates and enqueues, so any number of client
threads can submit while the device stream stays single-controller.

Robustness that is ported: a bounded admission queue
(:class:`ServerOverloaded`), deadlines at admission and mid-decode
(:class:`RequestDeadlineExceeded`), graceful drain (in-flight slots finish,
queued requests get :class:`ServerDrainingError`), and an engine failure
failing only the requests it held (:class:`BatchExecutionError`) before
the engine state is rebuilt. Not ported yet (ROADMAP.md): static mode, the
circuit breaker, the degradation ladder, trackers and the metrics
exporter.
"""

from __future__ import annotations

import collections
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .logging import get_logger
from .utils.dataclasses import ServingConfig
from .utils.fault import (
    BatchExecutionError,
    ReplicaDeadError,
    RequestDeadlineExceeded,
    ServerDrainingError,
    ServerOverloaded,
)

logger = get_logger(__name__)

__all__ = ["InferenceServer", "ServingResult", "ServingMetrics", "resolve_future"]


@dataclass
class _Request:
    input_ids: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    deadline: Optional[float]  # absolute, server clock
    temperature: float
    top_k: Optional[int]
    top_p: Optional[float]
    eos_token_id: Optional[int]
    pad_token_id: Optional[int]
    seed: int
    submitted_at: float
    future: Future = field(default_factory=Future)


@dataclass
class ServingResult:
    """What a completed request's Future resolves to."""

    tokens: np.ndarray  # (prompt_len + max_new_tokens,) int32
    latency_s: float
    batch_size: int  # slots live when it retired
    ttft_s: Optional[float] = None  # submit -> first token read back
    queue_wait_s: Optional[float] = None
    prefill_s: Optional[float] = None
    decode_steps: int = 0


def resolve_future(future: Future, *, result=None, exception: Optional[BaseException] = None) -> bool:
    """Resolve a client Future exactly once, tolerating a concurrent
    ``cancel()``. Returns True when this call delivered the outcome."""
    if future.done():
        return False
    try:
        if exception is not None:
            future.set_exception(exception)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


class ServingMetrics:
    """Thread-safe counters and recent latency samples (seconds)."""

    _COUNTERS = (
        "submitted", "completed", "rejected_queue_full", "rejected_draining",
        "shed_deadline", "completed_late", "batch_failures",
        "engine_inserts", "engine_steps", "engine_retired",
    )

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._counts = dict.fromkeys(self._COUNTERS, 0)
        self.latency: collections.deque = collections.deque(maxlen=window)
        self.ttft: collections.deque = collections.deque(maxlen=window)

    def bump(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] += by

    def add(self, latency_s: float, ttft_s: float) -> None:
        with self._lock:
            self.latency.append(latency_s)
            self.ttft.append(ttft_s)

    def snapshot(self) -> dict:
        with self._lock:
            out = {f"serving/{k}": v for k, v in self._counts.items()}
            for name, samples in (("latency", self.latency), ("ttft", self.ttft)):
                if samples:
                    arr = np.asarray(samples)
                    out[f"serving/{name}_p50_s"] = float(np.percentile(arr, 50))
                    out[f"serving/{name}_p99_s"] = float(np.percentile(arr, 99))
        return out


class InferenceServer:
    """Continuous-batching server over a
    :class:`~accelerate_tpu_torch.engine.ContinuousBatchingEngine`.

    ``model`` is a :class:`~accelerate_tpu_torch.models.llama
    .LlamaForCausalLM` on ``device`` (default ``"cuda"``); ``engine`` injects
    a pre-built engine instead (tests). Construction starts the worker;
    use it as a context manager or call :meth:`close`.
    """

    def __init__(self, model, config: Optional[ServingConfig] = None, *, engine=None,
                 device="cuda", clock: Callable[[], float] = time.monotonic):
        self.config = config or ServingConfig()
        self._clock = clock
        if engine is None:
            from .engine import ContinuousBatchingEngine

            engine = ContinuousBatchingEngine(
                model,
                slots=self.config.engine_slots,
                max_len=self.config.engine_max_len,
                prompt_bucket=self.config.engine_prompt_bucket,
                readback_lag=self.config.engine_readback_lag,
                kv_cache=self.config.kv_cache,
                block_size=self.config.engine_block_size,
                pool_blocks=self.config.engine_pool_blocks,
                attention_impl=self.config.attention_impl,
                spec=self.config.speculative,
                spec_draft_len=self.config.spec_draft_len,
                prefill_chunk=self.config.engine_prefill_chunk,
                device=device,
                clock=clock,
            )
        self._engine = engine
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._draining = False
        self._closed = False
        self._worker_error: Optional[BaseException] = None
        self._drained = threading.Event()
        self.metrics = ServingMetrics()
        self._worker = threading.Thread(target=self._serve_loop, name="inference-server", daemon=True)
        self._worker.start()

    @property
    def engine(self):
        return self._engine

    # ------------------------------------------------------------ admission
    def submit(self, input_ids, *, max_new_tokens: Optional[int] = None,
               deadline_s: Optional[float] = None, temperature: float = 0.0,
               top_k: Optional[int] = None, top_p: Optional[float] = None,
               eos_token_id: Optional[int] = None, pad_token_id: Optional[int] = None,
               seed: int = 0) -> Future:
        """Admit one request; returns a Future resolving to
        :class:`ServingResult` or raising the typed error that ended it.
        Raises at once (before queueing) when the server is draining, the
        queue is full, or the request cannot fit the engine.
        ``deadline_s`` is relative (``None``: ``config.default_deadline_s``);
        ``seed`` drives a sampled request's draws (``temperature > 0``)."""
        if self._closed or self._draining:
            self.metrics.bump("rejected_draining")
            raise ServerDrainingError(self._drain_reason(), retry_after_s=0.0)
        ids = np.asarray(input_ids, dtype=np.int32)
        if ids.ndim == 2 and ids.shape[0] == 1:
            ids = ids[0]
        if ids.ndim != 1 or ids.shape[0] == 0:
            raise ValueError(f"input_ids must be a non-empty 1-D prompt, got shape {ids.shape}")
        budget = max_new_tokens or self.config.default_max_new_tokens
        self._engine.validate_request(ids.shape[0], budget)
        self._engine.validate_tokens(ids)
        now = self._clock()
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        req = _Request(
            input_ids=ids, max_new_tokens=budget,
            deadline=(now + deadline_s) if deadline_s is not None else None,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=seed,
            submitted_at=now,
        )
        with self._wake:
            if self._draining or self._closed:
                self.metrics.bump("rejected_draining")
                raise ServerDrainingError(self._drain_reason(), retry_after_s=0.0)
            if len(self._queue) >= self.config.max_queue:
                self.metrics.bump("rejected_queue_full")
                raise ServerOverloaded(
                    f"admission queue full ({self.config.max_queue}); back off and resubmit",
                )
            self._queue.append(req)
            self.metrics.bump("submitted")
            self._wake.notify()
        return req.future

    def generate(self, input_ids, *, timeout: Optional[float] = None, **kwargs) -> np.ndarray:
        """Blocking convenience: ``submit(...).result().tokens``."""
        return self.submit(input_ids, **kwargs).result(timeout=timeout).tokens

    # ------------------------------------------------------------ lifecycle
    def _drain_reason(self) -> str:
        if self._worker_error is not None:
            return (f"serving worker died ({type(self._worker_error).__name__}: "
                    f"{self._worker_error}); resubmit to another replica")
        return "server is draining; resubmit to another replica"

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Stop admission, let in-flight slots finish, reject everything
        still queued. True when the worker exited within ``timeout``
        (default ``config.drain_timeout_s``)."""
        with self._wake:
            self._draining = True
            self._wake.notify_all()
        timeout = self.config.drain_timeout_s if timeout is None else timeout
        done = self._drained.wait(timeout)
        if not done:
            logger.warning("serving drain did not finish within %.1fs", timeout)
        return done

    def close(self, drain: bool = True, timeout: Optional[float] = None) -> bool:
        """Drain (or, with ``drain=False``, stop without waiting) and join
        the worker. Idempotent."""
        done = self.drain(timeout if drain else 0.0)
        self._closed = True
        if self._worker is not threading.current_thread():
            self._worker.join(timeout=self.config.drain_timeout_s)
        return done

    def __enter__(self) -> "InferenceServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # ---------------------------------------------------------- worker loop
    def _serve_loop(self) -> None:
        try:
            self._loop_continuous()
        except BaseException as exc:  # a dead worker must not hang clients
            with self._lock:
                self._worker_error = exc
                self._draining = True
            logger.exception("serving worker died; failing in-flight and queued requests")
            raise
        finally:
            with self._lock:
                self._draining = True
            for occ in self._engine.reset():
                resolve_future(occ.tag.future, exception=ReplicaDeadError(
                    "serving worker exited with this request still in a decode slot",
                ))
            self._reject_queued()
            self._drained.set()

    def _loop_continuous(self) -> None:
        """Each pass: admit into free slots, one decode step, read back,
        reply, shed. Draining stops admission but keeps stepping until every
        in-flight slot retires."""
        eng = self._engine
        while True:
            with self._wake:
                while not self._queue and eng.live_count() == 0 and not self._draining:
                    self._wake.wait(timeout=0.05)
                if self._draining and eng.live_count() == 0:
                    return  # the finally rejects what is still queued
            if not self._draining:
                self._admit_slots()
            self._engine_tick()

    def _admit_slots(self) -> None:
        eng = self._engine
        while eng.free_slots() > 0:
            with self._wake:
                if not self._queue:
                    return
                req = self._queue.popleft()
            now = self._clock()
            if req.deadline is not None and now > req.deadline:
                if resolve_future(req.future, exception=RequestDeadlineExceeded(
                        f"deadline passed {now - req.deadline:.3f}s ago while queued")):
                    self.metrics.bump("shed_deadline")
                continue
            # paged KV: a free slot is not enough, the blocks must be free
            # too; requeue at the head and retry after retirements
            if not eng.can_admit(req.input_ids, req.max_new_tokens):
                with self._wake:
                    self._queue.appendleft(req)
                return
            try:
                eng.insert(
                    req.input_ids, max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature, top_k=req.top_k, top_p=req.top_p,
                    eos_token_id=req.eos_token_id, pad_token_id=req.pad_token_id,
                    seed=req.seed, tag=req,
                )
            except Exception as exc:  # the engine failed: fail its requests, rebuild
                self._engine_failure(exc, also_fail=req)
                return
            self.metrics.bump("engine_inserts")

    def _engine_tick(self) -> None:
        eng = self._engine
        if eng.live_count() == 0:
            self._reply_retired(eng.poll(force=True))
            return
        try:
            eng.step()
            retired = eng.poll()
        except Exception as exc:
            self._engine_failure(exc)
            return
        self.metrics.bump("engine_steps")
        self._reply_retired(retired)
        now = self._clock()
        for occ in eng.occupants():
            req = occ.tag
            if req.deadline is not None and now > req.deadline:
                eng.cancel(occ)
                self.metrics.bump("engine_retired")
                if resolve_future(req.future, exception=RequestDeadlineExceeded(
                        f"deadline passed {now - req.deadline:.3f}s ago mid-decode")):
                    self.metrics.bump("shed_deadline")

    def _reply_retired(self, retired: list) -> None:
        if not retired:
            return
        now = self._clock()
        occupancy = self._engine.live_count() + len(retired)
        for occ in retired:
            req = occ.tag
            self.metrics.bump("engine_retired")
            if req.deadline is not None and now > req.deadline:
                if resolve_future(req.future, exception=RequestDeadlineExceeded(
                        f"decode finished {now - req.deadline:.3f}s past the deadline")):
                    self.metrics.bump("completed_late")
                continue
            latency = now - req.submitted_at
            ttft = (occ.first_token_s - req.submitted_at) if occ.first_token_s is not None else latency
            result = ServingResult(
                tokens=occ.output_row(), latency_s=latency, batch_size=occupancy,
                ttft_s=max(0.0, ttft), queue_wait_s=max(0.0, occ.inserted_s - req.submitted_at),
                prefill_s=(max(0.0, occ.first_token_s - occ.inserted_s)
                           if occ.first_token_s is not None else None),
                decode_steps=occ.decode_steps,
            )
            if resolve_future(req.future, result=result):
                self.metrics.bump("completed")
                self.metrics.add(latency, max(0.0, ttft))

    def _engine_failure(self, exc: BaseException, also_fail=None) -> None:
        """An engine program raised: its in-flight state cannot be trusted,
        so fail every request it held and rebuild the engine state."""
        self.metrics.bump("batch_failures")
        victims = [o.tag for o in self._engine.reset()]
        if also_fail is not None:
            victims.append(also_fail)
        for req in victims:
            err = BatchExecutionError(
                f"engine program failed ({type(exc).__name__}: {exc}); "
                f"{len(victims)} in-flight request(s) lost"
            )
            err.__cause__ = exc
            resolve_future(req.future, exception=err)
        logger.warning("engine failure reset the KV store: %s: %s", type(exc).__name__, exc)

    def _reject_queued(self) -> None:
        with self._lock:
            queued, self._queue = list(self._queue), collections.deque()
        for req in queued:
            if resolve_future(req.future, exception=ServerDrainingError(
                    self._drain_reason(), retry_after_s=0.0)):
                self.metrics.bump("rejected_draining")
