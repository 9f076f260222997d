"""Continuous-batching decode engine: slot-based KV store plus
iteration-level scheduling state (counterpart of
``accelerate_tpu/engine.py``).

* **Slots over a KV backend** (:mod:`~accelerate_tpu_torch.kvcache`):
  per-slot ``pos/done/budget/token`` and sampling parameters live on the
  device, so mixed greedy and sampled traffic shares one decode step.
* **Device programs**, with the JAX package's names and signatures:
  ``prefill_insert (bucket,)`` runs the bucketed prompt forward
  (``llama_prefill_at``), samples the first token and writes the prompt's
  KV into the slot; ``decode_step ()`` runs one decode step over every
  slot, vacant and finished slots riding along masked; ``verify_step
  (k,)`` and ``prefill_insert ("chunk", chunk)`` below. Each reads and
  writes only tensors that live as long as the engine (the KV store, the
  block tables, the per-slot state, the inputs staged from the host by
  non-blocking copies, the outputs the readback copies), so on CUDA each
  signature is one captured ``torch.cuda.CUDAGraph``: its first call runs
  eagerly (it builds the kernels and allocates what lives outside the
  graph), then it is captured once and replayed from then on. A capture
  that fails raises. On the CPU the same bodies run eagerly and the same
  signatures are recorded, so ``stats()["programs"]`` counts what JAX
  compiles: two programs per (slots, max_len), three with ``spec``, and
  the chunk program with ``prefill_chunk``.
* **Speculative decoding** (``spec="ngram"``): a host drafter proposes up
  to ``spec_draft_len`` tokens per slot from n-gram matches in the slot's
  own history, and one verify step (``llama_verify_step`` over W =
  ``spec_draft_len + 1`` positions) scores them: greedy rows accept a draft
  iff it is the argmax, sampled rows by rejection sampling against the
  filtered distribution; only the accepted prefix's KV is committed. An
  acceptance EWMA per slot stops drafting where drafts keep failing.
* **Chunked prefill** (``prefill_chunk``): prompts longer than the bucket
  are fed one chunk per :meth:`step`, each a window forward over that one
  slot (``llama_verify_step``, B = 1) at the slot's offset, interleaved
  with the other slots' decode steps; the last chunk samples the first
  token exactly as a single-shot prefill does.
* **Deferred readback**: each program's (token, done) vectors are copied
  to pinned host buffers (kept for reuse) with non-blocking copies and a
  CUDA event, and read ``readback_lag`` programs later at :meth:`poll`, so
  the decode loop never waits on the device (no ``.item()`` on the decode
  path).
* **Sampling**: ``attention_impl="kernel"`` (the JAX package's
  ``"pallas"``) sends decode attention through the paged flash-decode
  kernel and both decode's draw and prefill's first-token draw through
  the fused sampling kernel; ``"reference"`` uses the plain paged
  attention and the sort-based :func:`_sample_rows`. Both draw as
  ``argmax(filtered + gumbel)`` with the same Gumbel noise, drawn on the
  device from one ``torch.Generator`` per slot seeded by the request's
  ``seed`` at its first token: a slot's stream depends only on its own
  request. Every decode or verify step takes the same numbers from every
  slot's generator (V Gumbel uniforms, then ``spec_draft_len`` acceptance
  uniforms when ``spec`` is on), so the step has one shape and a slot's
  draws never depend on whether another slot's drafts turned the step
  into a verify step; with ``spec`` off the stream is the plain one. The
  generators are registered with each captured graph, so a replay
  advances each stream exactly as an eager step does.

* **A model laid over a mesh** (``inference.prepare_inference(mesh=,
  rules=)``: ``tp`` blocks, FSDP2 shards over ``dp_shard``): every rank of
  the mesh builds the engine and makes the same host calls in the same
  order, and each runs the same programs on its part of the model
  (``models.llama.serving_view``): the store holds the rank's ``kv_heads /
  tp`` heads in as many blocks as one process's (an int8 scale is taken
  over every rank's heads), the ``dp_shard`` shards are gathered one layer
  at a time into the buffers of the model's one
  :class:`~accelerate_tpu_torch.ops.collectives.ShardGather`, and every
  program runs under the model's run lock, which ``generate``'s programs
  share, so the ranks' collectives keep one order. The logits are gathered
  whole over ``tp`` before sampling: every rank samples the same row with
  its own generator, seeded alike, and draws the same token; the host's
  drafts read only token histories, which are equal on every rank. The
  construction arguments are checked equal on every rank first (a
  difference raises on every rank). The programs are captured with their
  NCCL collectives after their first eager run, on the decision
  ``inference.graphs_supported`` makes; torch's threaded process group
  runs them eagerly.

* **Host-RAM KV tier** (``host_tier_bytes``, paged stores): evicted
  prefix blocks spill to host memory (:mod:`~accelerate_tpu_torch.kvcache`)
  and a chunked admission of their prefix restores them before its first
  chunk, so the chunks start past the restored tokens. The restore is
  recorded as JAX's ``prefill_insert ("restore", R)``, R =
  ``blocks_per_row``, and runs eagerly: one ``index_copy_`` per pool leaf
  over the restored blocks. Its operands are fresh tensors each time (the
  host payloads on the device), so a captured graph would need a static
  staging buffer of R blocks (256 MiB in bf16 for Llama-3-8B at max_len
  2048) and one more copy of every block into it; the eager scatter moves
  each byte once. JAX pads the batch to R blocks with the null block as
  target, which the eager scatter has no need of. :meth:`prefetch` starts
  the host-to-device copies at submit time.
* **Disaggregated prefill**: :meth:`prefill_remote` runs a request's
  bucketed prompt forward and its first-token draw off the decode loop, on
  the calling thread's own CUDA stream, into fresh tensors
  (``prefill_forward (bucket,)``, eager: the decode thread may be
  replaying or capturing meanwhile); :meth:`insert_prefilled` commits the
  :class:`RemotePrefill` into a slot (``prefill_commit ()``, eager: its
  inputs are that prefill's tensors), after the engine's stream waits on
  the event the prefill carries. The result is bitwise :meth:`insert`'s.
  The slot epochs fence a prefill that arrives over the wire
  (``kvtransfer.py``): :meth:`reserve_slot` takes a slot out of the free
  list for a transfer, and every return of a slot bumps its epoch, so a
  late commit into a recycled slot raises
  :class:`~accelerate_tpu_torch.utils.fault.TransferStaleEpochError`.

* **The host tier and disaggregated prefill over a mesh.** Each rank's
  tier files its own heads of each block on its own spill thread, so two
  ranks may hold different chains of a prompt (a spill still queued, one
  lost, a block the LRU dropped): a chunked admission first waits for
  this rank's queued spills (``spill_flush``, bounded) and then takes the
  smallest of the ranks' chain lengths (a MIN over ``tp`` and
  ``dp_shard`` under the run lock), so every rank restores the same
  blocks and starts its chunks at the same offset. :meth:`prefill_remote`
  is an SPMD call, as every other call over a mesh: every rank makes it in
  the same order relative to :meth:`insert` and :meth:`step`, and it runs
  under the run lock on the calling thread's current stream, gathering
  the window's kv heads over ``tp``, so its :class:`RemotePrefill` is the
  whole window (its ``to_bytes`` is one process's, and a one-card engine
  commits it). :meth:`insert_prefilled` takes the first rank's window
  and first token on every rank (a broadcast over the model's groups
  under the run lock) and commits this rank's kv heads of it; a replaying
  rank passes a window of the right shape to receive into. Slots,
  reservations and the epoch fence are the first rank's state: an
  admission may name its slot (``slot=``, which must be free here, else
  :class:`~accelerate_tpu_torch.utils.fault.EngineInvariantError`), and
  ``on_slot`` hears the slot an admission took before anything runs, so
  the first rank's server can send it to the others. Not here: a remote
  forward beside the decode loop on a mesh, which would need a second
  communicator on a stream of its own; over a mesh a server runs remote
  forwards in its decision stream (``serving.py``).

Spans (``tracing.py``), each around the host side of a program, never
inside a captured graph's body: ``engine.prefill`` (an admission's prompt
forward, or ``prefill_remote``'s with ``remote=True``),
``engine.prefill_chunk``, ``engine.kv_restore``,
``engine.insert_prefilled``, ``engine.retire``, and the sampled
``engine.decode_step`` and ``engine.spec_verify`` (one step in
``TracingConfig.decode_sample_every``). :meth:`poll`, which waits for the
ring's events, bills the time since the last poll to the programs that
retired in it (``perfwatch.PerfWatch.record_window``, family
``engine.dense``, ``engine.paged``, ``engine.paged_kernel`` (the kernels'
route, the JAX package's ``engine.paged_pallas``) or ``engine.spec``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from . import perfwatch, tracing
from ._device import resolve_device
from .kvcache import HostStage, make_kv_backend
from .ops import _build
from .utils.fault import EngineCapacityError, EngineInvariantError, TransferStaleEpochError

__all__ = ["ContinuousBatchingEngine", "SlotOccupant", "RemotePrefill"]

_graphs_disabled = False
# the graphs of one process (the engines' and static generate's) capture
# and replay one at a time: a fleet's replicas on one card each run their
# programs from their own serving thread, torch allows one capture at a
# time in a process, and a capture (its eager warm-up, the graph's
# recording and the collector switched off around it) must not meet
# another thread's replay or capture
_GRAPH_LOCK = threading.Lock()


@contextlib.contextmanager
def _disable_graphs():
    """Private hook, in the spirit of ``jax.disable_jit``: engines built
    inside run every program eagerly on CUDA too, kernel by kernel, through
    the same bodies the graphs capture. It exists to hold the captured
    programs against the eager ones in one process (``chip_smoke.py``, the
    card tests); the engine never falls back to it."""
    global _graphs_disabled
    prev, _graphs_disabled = _graphs_disabled, True
    try:
        yield
    finally:
        _graphs_disabled = prev


def _leaves(tree):
    """The tensors of a KV store (float leaves or int8 ``{"q", "s"}`` pairs)."""
    for leaf in tree.values():
        yield from (_leaves(leaf) if isinstance(leaf, dict) else (leaf,))


_CAPTURE_STREAMS: dict = {}  # card index -> the stream its captures run on


def _capture_stream():
    """The stream captures on the current card run on: one a card, made at
    its first capture and kept (called under ``_GRAPH_LOCK``). A new stream
    each capture would come round torch's stream pool to one that other
    work uses."""
    card = torch.cuda.current_device()
    if card not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[card] = torch.cuda.Stream(card)
    return _CAPTURE_STREAMS[card]


class _Graph:
    """One program captured as a CUDA graph. Building it runs ``body`` once
    eagerly (the program's first call is a real one, and builds what lives
    outside the graph), then records it; the capture records each kernel
    launch of ``body`` (the wrappers' counts go to ``launches``, added once
    per :meth:`replay`) and advances no generator: the registered ones
    advance at each replay, as an eager call would. The build and every
    replay hold ``_GRAPH_LOCK``."""

    def __init__(self, body: Callable[[], None], generators):
        with _GRAPH_LOCK:
            body()
            self.graph = torch.cuda.CUDAGraph()
            for gen in generators:
                self.graph.register_generator_state(gen)
            # the collector runs no finalizer inside the capture: freeing
            # cyclic garbage there (a dropped engine's pinned readback
            # buffers) makes the host allocator query events, which ends
            # the capture
            gc.collect()
            was_enabled = gc.isenabled()
            gc.disable()
            try:
                # thread_local: the serving worker captures while other
                # threads may use the card; a synchronising call in this
                # thread still fails
                with _build.capture_launches() as launches, \
                        torch.cuda.graph(self.graph, stream=_capture_stream(),
                                         capture_error_mode="thread_local"):
                    body()
            finally:
                if was_enabled:
                    gc.enable()
        self.launches = launches

    def replay(self) -> None:
        with _GRAPH_LOCK:
            self.graph.replay()
        _build.add_launches(self.launches)


@dataclass
class SlotOccupant:
    """Host-side record of one request living in a slot."""

    slot: int
    tag: Any  # opaque (the server's request); never inspected here
    prompt: np.ndarray  # (prompt_len,) int32, unpadded
    budget: int  # exact number of new tokens owed
    pad_id: int
    eos_id: Optional[int]
    inserted_s: float
    tokens: List[int] = field(default_factory=list)
    finished: bool = False
    first_token_s: Optional[float] = None
    # chunked prefill: a PREFILLING slot rides every decode step masked
    # until its last chunk commits; ``prefill_pos`` is the next chunk's
    # offset, ``chunk_args`` what the last chunk needs to sample
    prefilling: bool = False
    prefill_pos: int = 0
    chunk_args: Optional[dict] = None
    # speculative decoding: acceptance EWMA (starts above the gate floor so
    # a fresh slot drafts at once), steps skipped while gated, and the
    # cooldown before a re-probe (doubles on every all-rejected verify up to
    # _SPEC_COOLDOWN_MAX, resets once a draft lands)
    spec_ewma: float = 0.3
    spec_skips: int = 0
    spec_cooldown: int = 8
    # the request's trace id (the tag's, at admission) and the programs that
    # emitted tokens for it (``ServingResult.decode_steps``)
    trace_id: Optional[str] = None
    decode_steps: int = 0

    def output_row(self) -> np.ndarray:
        """prompt + emitted tokens, padded with ``pad_id`` to the budget."""
        out = np.full(len(self.prompt) + self.budget, self.pad_id, dtype=np.int32)
        out[: len(self.prompt)] = self.prompt
        out[len(self.prompt): len(self.prompt) + len(self.tokens)] = self.tokens
        return out


@dataclass
class RemotePrefill:
    """A prompt forward run off the decode loop
    (:meth:`ContinuousBatchingEngine.prefill_remote`): the bucketed
    prefill's ``max_len``-wide KV window, the first sampled token and what
    the slot's generator needs, ready for :meth:`ContinuousBatchingEngine
    .insert_prefilled`. Committing it is bitwise :meth:`~
    ContinuousBatchingEngine.insert`: the same forward, the same draw.

    ``cache`` is ``{"k", "v"}`` of (L, 1, max_len, kv heads, head_dim)
    and ``t0`` a (1,) int32 tensor, on the engine's device; ``next_key``
    is the port's counterpart of the JAX package's advanced key: a (1,)
    int64 CPU tensor holding the seed the slot's generator is reseeded
    with, after which the commit draws the first token's V uniforms again
    (the generator is registered with the captured graphs, so it must be
    left as :meth:`~ContinuousBatchingEngine.insert` leaves it). ``event``
    (CUDA) is recorded after the forward on the stream that ran it: the
    commit's stream waits on it. ``engine_config``, ``prompt_bucket`` and
    ``max_len`` are the structural stamp a receiving engine checks;
    ``reservation`` is the ``(slot, epoch)`` a wire transfer reserved
    (``kvtransfer.py``), None for a hand-off in one process."""

    prompt: np.ndarray  # (prompt_len,) int32, unpadded
    max_new_tokens: int
    temperature: float
    top_k: Optional[int]
    top_p: Optional[float]
    eos_token_id: Optional[int]
    pad_token_id: Optional[int]
    seed: int
    cache: Any
    t0: Any
    next_key: Any
    engine_config: Any = None
    prompt_bucket: int = 0
    max_len: int = 0
    reservation: Optional[Tuple[int, int]] = None
    event: Any = None

    def to_bytes(self) -> bytes:
        """The versioned wire encoding
        (:func:`~accelerate_tpu_torch.kvtransfer.encode_remote_prefill`)."""
        from .kvtransfer import encode_remote_prefill

        return encode_remote_prefill(self)

    @classmethod
    def from_bytes(cls, data: bytes, *, engine=None) -> "RemotePrefill":
        """Decode :meth:`to_bytes`; ``engine`` (the receiving one) checks
        the structural stamp, rebinds ``engine_config`` to its own and
        takes the leaves to its device."""
        from .kvtransfer import decode_remote_prefill

        return decode_remote_prefill(data, engine=engine)


def _filter_logits(logits, temp, top_k, top_p):
    """Per-row temperature, top-k and top-p over (N, V) logits by one
    descending sort -> filtered scaled logits, suppressed entries at -inf
    (the plain counterpart of the fused sampling kernel's filter)."""
    n, v = logits.shape
    safe_t = torch.where(temp > 0, temp, torch.ones_like(temp))
    scaled = logits / safe_t[:, None]
    sorted_l = torch.sort(scaled, dim=-1, descending=True).values
    k_on = (top_k > 0) & (top_k < v)
    k_eff = top_k.long().clamp(1, v)
    rank = torch.arange(v, device=logits.device)[None, :]
    neg_inf = torch.full((), float("-inf"), device=logits.device)
    sorted_f = torch.where(~k_on[:, None] | (rank < k_eff[:, None]), sorted_l, neg_inf)
    kth = torch.gather(sorted_l, 1, (k_eff - 1)[:, None])
    filtered = torch.where(k_on[:, None] & (scaled < kth), neg_inf, scaled)
    # nucleus: smallest prefix with cumulative probability >= p; the
    # exclusive cumsum keeps the top token, p >= 1 keeps everything
    probs = torch.softmax(sorted_f, dim=-1)
    cum = torch.cumsum(probs, dim=-1) - probs
    p_eff = torch.where(top_p < 1.0, top_p, torch.ones_like(top_p))
    cutoff_idx = ((cum < p_eff[:, None]).sum(dim=-1) - 1).clamp(min=0)
    cutoff = torch.gather(sorted_f, 1, cutoff_idx[:, None])
    return torch.where(filtered < cutoff, neg_inf, filtered)


def _prompt_lookup(hist: np.ndarray, limit: int, ngram: int, ngram_min: int) -> np.ndarray:
    """Prompt-lookup n-gram draft: match the longest suffix n-gram of
    ``hist`` (n = ``ngram`` down to ``ngram_min``) against an earlier
    occurrence and propose the tokens that followed it, preferring the most
    recent match with a full ``limit``-token continuation, else the earliest
    match (whose continuation is longest; the latest match of a cyclic
    history ends right before the suffix). Depends on the slot's history
    only, which keeps per-slot streams reproducible alone and packed."""
    n = len(hist)
    if limit <= 0 or n < 2:
        return np.zeros(0, np.int32)
    for g in range(min(ngram, n - 1), ngram_min - 1, -1):
        pat = hist[n - g:]
        body = hist[: n - 1]  # the suffix's own occurrence at the end is excluded
        if len(body) < g:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(body, g)
        matches = np.nonzero((windows == pat[None, :]).all(axis=1))[0]
        if len(matches) == 0:
            continue
        ends = matches + g - 1  # n - 1 - end tokens follow each match
        full = ends[n - 1 - ends >= limit]
        end = int(full[-1]) if len(full) else int(ends[0])
        cont = hist[end + 1: end + 1 + limit]
        if len(cont):
            return cont.astype(np.int32)
    return np.zeros(0, np.int32)


def _verify_accept(logits, draft, dlen, temp, top_k, top_p, u, noise):
    """Acceptance of a verify step's drafts. ``logits`` (S, W, V) f32 (row
    j: the distribution after window token j), ``draft`` (S, k) long,
    ``dlen`` (S,) the real draft lengths, ``u`` (S, k) acceptance uniforms,
    ``noise`` (S, V) Gumbel noise. Greedy rows (temp 0) accept a draft iff it
    is the argmax; sampled rows accept draft ``d`` with probability ``p(d)``
    of the filtered distribution ``p`` (:func:`_filter_logits`), and draw
    the token after the accepted prefix as ``argmax(resid + noise)``:
    ``resid`` is ``p``'s logits with the rejected draft removed, or
    unchanged when every draft was accepted (the bonus position). Returns
    ``(emitted (S, W), a (S,))``: the accepted drafts, then the final token
    at index ``a`` (repeated after it)."""
    s, w, v = logits.shape
    k = w - 1
    dev = logits.device
    finals = _filter_logits(
        logits.reshape(s * w, v), temp.repeat_interleave(w),
        top_k.repeat_interleave(w), top_p.repeat_interleave(w),
    ).reshape(s, w, v)
    greedy = logits.argmax(dim=-1)  # (S, W)
    idx_k = torch.arange(k, device=dev)
    p_draft = torch.softmax(finals[:, :k], dim=-1).gather(2, draft[..., None])[..., 0]
    acc = torch.where(temp[:, None] > 0, u < p_draft, draft == greedy[:, :k])
    acc = acc & (idx_k[None, :] < dlen[:, None])
    a = acc.long().cumprod(dim=1).sum(dim=1)  # longest accepted prefix
    finals_a = finals.gather(1, a[:, None, None].expand(s, 1, v))[:, 0]
    draft_ext = torch.cat([draft, draft[:, :1]], dim=1)  # (S, W)
    d_rej = draft_ext.gather(1, a[:, None])[:, 0]
    vocab = torch.arange(v, device=dev)
    resid = torch.where((a < dlen)[:, None] & (vocab[None, :] == d_rej[:, None]),
                        torch.full((), float("-inf"), device=dev), finals_a)
    t_final = torch.where(temp > 0, (resid + noise).argmax(dim=-1), greedy.gather(1, a[:, None])[:, 0])
    jw = torch.arange(w, device=dev)[None, :]
    return torch.where(jw < a[:, None], draft_ext, t_final[:, None]), a


def _sample_rows(logits, noise, temp, top_k, top_p):
    """Per-row sampling over (N, V) logits: temperature 0 is the greedy
    argmax of the raw logits, otherwise ``argmax(filtered + noise)`` with
    per-row Gumbel ``noise`` (a categorical draw). First index at ties."""
    final = _filter_logits(logits, temp, top_k, top_p)
    sampled = torch.argmax(final + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    return torch.where(temp > 0, sampled, greedy).to(torch.int32)


# the construction arguments every rank of a mesh must share, in the order
# _check_same_engine gathers them
_ENGINE_FIELDS = ("slots", "max_len", "prompt_bucket", "readback_lag", "kv_cache", "block_size",
                  "pool_blocks", "attention_impl", "prefill_chunk", "spec", "spec_draft_len",
                  "spec_ngram", "spec_ngram_min")


def _check_same_engine(values: dict, groups, device) -> None:
    """Raise on every rank unless every rank of the mesh built its engine
    with the same ``values`` (:data:`_ENGINE_FIELDS`): a rank with another
    store, bucket or drafter would run other programs against its peers'
    collectives."""
    from .inference import _check_same

    def code(v):
        if v is None:
            return -1
        if isinstance(v, str):
            return zlib.crc32(v.encode())
        return int(v)

    vec = torch.tensor([code(values[name]) for name in _ENGINE_FIELDS], dtype=torch.int64,
                       device=device)
    _check_same(vec, groups, _ENGINE_FIELDS, "ContinuousBatchingEngine over a mesh",
                "every rank must build the engine with the same arguments")


class ContinuousBatchingEngine:
    """Persistent slot-based decode state for one model.

    Host API (single-threaded: the serving worker owns the engine):
    :meth:`insert` admits a request into a free slot, :meth:`step` runs one
    scheduler tick (pending prompt chunks, then one decode or verify step
    over every slot), :meth:`poll` reads back matured results and returns
    the occupants it retired, :meth:`cancel` force-retires one,
    :meth:`drain` steps until every occupant retires, :meth:`reset` drops
    all state and returns the orphans.

    ``attention_impl``: ``"reference"`` or ``"kernel"`` (the counterpart of
    the JAX package's ``"pallas"``; needs a paged ``kv_cache``).
    ``spec="ngram"`` turns on prompt-lookup speculative decoding with
    ``spec_draft_len`` drafts per slot; drafting needs each slot's true
    history, so a spec step first waits for the pending readbacks
    (retirement still happens at :meth:`poll`). ``prefill_chunk`` admits
    prompts longer than the bucket, fed in chunks of that many positions.
    ``device`` defaults to ``"cuda"`` and must be where the model's
    parameters are. Over a mesh (a model from ``prepare_inference(mesh=,
    rules=)``) every rank builds the engine with the same arguments and
    makes the same calls in the same order (the module docstring); the
    continuous ``InferenceServer`` does that for its callers.
    """

    # acceptance-EWMA gate: a slot whose EWMA falls below the floor stops
    # drafting (every wasted draft costs a wider forward) and re-probes
    # after its cooldown
    _SPEC_EWMA_ALPHA = 0.2
    _SPEC_MIN_ACCEPT = 0.1
    _SPEC_COOLDOWN = 8
    _SPEC_COOLDOWN_MAX = 128
    # over a mesh: the longest a restore's plan waits for this rank's
    # queued spills to be filed
    _SPILL_FLUSH_S = 30.0

    def __init__(
        self,
        model,
        *,
        slots: int = 8,
        max_len: int = 256,
        prompt_bucket: Optional[int] = None,
        readback_lag: int = 2,
        kv_cache: str = "dense",
        block_size: int = 16,
        pool_blocks: Optional[int] = None,
        attention_impl: str = "reference",
        prefill_chunk: Optional[int] = None,
        host_tier_bytes: int = 0,
        spec: Optional[str] = None,
        spec_draft_len: int = 4,
        spec_ngram: int = 3,
        spec_ngram_min: int = 2,
        device="cuda",
        clock: Callable[[], float] = time.monotonic,
    ):
        from .inference import _model_mesh_state, graphs_supported
        from .models.llama import (_check_supported, _Shard, llama_decode_step, llama_prefill_at,
                                   llama_verify_step, mesh_ranks, serving_view)

        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if readback_lag < 0:
            raise ValueError(f"readback_lag must be >= 0, got {readback_lag}")
        if spec not in (None, "ngram"):
            raise ValueError(f"spec must be None or 'ngram', got {spec!r}")
        if spec is not None and spec_draft_len < 1:
            raise ValueError(f"spec_draft_len must be >= 1 when spec is enabled, got {spec_draft_len}")
        if spec is not None and spec_ngram < 1:
            raise ValueError(f"spec_ngram must be >= 1, got {spec_ngram}")
        if spec is not None and not 1 <= spec_ngram_min <= spec_ngram:
            raise ValueError(
                f"spec_ngram_min must be in [1, spec_ngram], got {spec_ngram_min} (spec_ngram={spec_ngram})"
            )
        if prefill_chunk is not None and not 1 <= prefill_chunk <= max_len - 1:
            raise ValueError(
                f"prefill_chunk must be None or in [1, max_len-1], got {prefill_chunk} (max_len={max_len})"
            )
        if attention_impl not in ("reference", "kernel"):
            raise ValueError(f"attention_impl must be 'reference' or 'kernel', got {attention_impl!r}")
        self.device = resolve_device(device)
        self.model = model
        self.config = model.config
        # laid over a mesh: the rank's leaves in place, its tp handle, and
        # the model's one shard gather and run lock
        self._view = serving_view(model) if mesh_ranks(model) is not None else None
        view_params = self._view.params if self._view is not None else model.params
        _check_supported(self.config, view_params)  # float trees only
        embedding = view_params["embed_tokens"]["embedding"]
        params_dev = (embedding.local if isinstance(embedding, _Shard) else embedding).device
        if params_dev != self.device:
            raise ValueError(f"model parameters are on {params_dev}, engine device is {self.device}")
        self._tp = self._ep = self._fsdp = self._mesh_lock = None
        if self._view is not None:
            self._tp, self._ep = self._view.tp, self._view.ep
            self._mesh_lock, self._fsdp = _model_mesh_state(model, self._view.fsdp_group)
            _check_same_engine(
                dict(slots=slots, max_len=max_len, prompt_bucket=prompt_bucket,
                     readback_lag=readback_lag, kv_cache=kv_cache, block_size=block_size,
                     pool_blocks=pool_blocks, attention_impl=attention_impl,
                     prefill_chunk=prefill_chunk, spec=spec, spec_draft_len=spec_draft_len,
                     spec_ngram=spec_ngram, spec_ngram_min=spec_ngram_min),
                [self._view.model_group, self._view.fsdp_group], self.device)
        self.slots = slots
        self.max_len = max_len
        self.prompt_bucket = prompt_bucket if prompt_bucket is not None else max(1, max_len // 2)
        if not 1 <= self.prompt_bucket <= max_len - 1:
            raise ValueError(
                f"prompt_bucket must be in [1, max_len-1], got {self.prompt_bucket} (max_len={max_len})"
            )
        self.prefill_chunk = prefill_chunk
        self.readback_lag = readback_lag
        self._clock = clock
        if attention_impl == "kernel" and self.config.sliding_window is not None:
            # the paged kernels walk the whole live table; a window would
            # need per-block skips they do not implement
            raise ValueError(
                "attention_impl='kernel' does not support sliding-window configs "
                f"(sliding_window={self.config.sliding_window}); use attention_impl='reference'"
            )
        self.attention_impl = attention_impl
        self._backend = make_kv_backend(
            kv_cache, config=self.config, slots=slots, max_len=max_len,
            prompt_bucket=self.prompt_bucket, device=self.device, block_size=block_size,
            pool_blocks=pool_blocks, attention_impl=attention_impl,
            tp_group=self._tp.group if self._tp is not None else None,
            host_tier_bytes=host_tier_bytes,
        )
        if hasattr(self._backend, "bind_cache_reader"):
            # the spill gather reads the store, which is updated in place
            self._backend.bind_cache_reader(lambda: self._cache)
        self._prefill_at_fn, self._decode_fn = llama_prefill_at, llama_decode_step
        self._verify_fn = llama_verify_step
        self.spec = spec
        self.spec_draft_len = spec_draft_len if spec is not None else 0
        self.spec_ngram = spec_ngram
        # precision floor: 1-gram matches on incompressible traffic are noise
        self.spec_ngram_min = spec_ngram_min
        # host-side draft clamp in [0, spec_draft_len]; 0 = plain decode steps
        self._spec_limit = self.spec_draft_len
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.spec_wasted = 0
        self.spec_verify_steps = 0
        self.spec_emitted = 0
        self.spec_slot_steps = 0
        self.spec_ewma = 1.0  # engine-wide acceptance EWMA (optimistic)
        self._gens = [torch.Generator(device=self.device) for _ in range(slots)]
        # program name -> the signatures it ran with (JAX: the jitted
        # programs compiled); on CUDA each signature is one captured graph
        self._programs: dict = {}
        self._use_graphs = (self.device.type == "cuda" and not _graphs_disabled
                            and (self._view is None or graphs_supported(self._view)))
        self._graphs: dict = {}
        self._init_state()
        self._occupants: List[Optional[SlotOccupant]] = [None] * slots
        self._free: List[int] = list(range(slots))
        # the slot-epoch fence of wire-shipped prefills: every return of a
        # slot to the free list bumps its epoch, and a reservation is
        # honoured only under its epoch. The lock covers the free list, the
        # epochs and the reservations (transfer receivers reserve and
        # release from their threads); no device work runs under it
        self._admission_lock = threading.Lock()
        self._epochs: List[int] = [0] * slots
        self._reservations: dict = {}  # slot -> expiry on the engine's clock
        # prefill_remote's CUDA stream, one per calling thread
        self._remote = threading.local()
        self._ring: collections.deque = collections.deque()
        # round-robin queue of PREFILLING occupants and the per-tick chunk
        # clamp (0 pauses chunked prefill)
        self._prefill_queue: collections.deque = collections.deque()
        self._prefill_chunk_limit = 1
        self.prefill_chunks = 0
        self.kv_restores = 0
        self._tick = 0
        self.peak_live = 0
        self.inserted = 0
        self.remote_prefills = 0
        self.steps = 0
        self.retired = 0
        # the perf observatory's window: wall time is read at poll(), which
        # waits for the ring's events anyway, and split across the programs
        # that retired since the last one
        self._perfwatch = perfwatch.get_watch()
        self._pw_mark = self._clock()

    # ----------------------------------------------------------- state
    # the per-call scalar operands of the prefill and chunk programs, in
    # order (``_args``, int64 on the device): the slot, the last prompt
    # position (a chunk: its offset), the chunk's length, the column of the
    # last prompt position in the chunk, whether it is the last chunk, and
    # the request's budget
    _ARGS = ("slot", "pos", "count", "col", "last", "budget")

    # the carried per-slot state of a vacant slot: permanently done, it
    # rides every step masked
    _CARRIED = {"token": (torch.int32, 0), "done": (torch.bool, True), "budget": (torch.int32, 0),
                "temp": (torch.float32, 0.0), "top_k": (torch.int32, 0), "top_p": (torch.float32, 1.0),
                "eos": (torch.int32, -1), "pad": (torch.int32, 0)}

    def _init_state(self) -> None:
        """Every tensor the programs read or write, allocated once: a
        captured graph keeps their addresses (:meth:`reset` refills them in
        place)."""
        s, dev, k = self.slots, self.device, max(self.spec_draft_len, 1)
        self._cache = self._backend.init_device_state()
        self._tables = self._backend.device_tables()
        self._pos = torch.zeros((s,), dtype=torch.int32, device=dev)
        self._carried = {name: torch.full((s,), value, dtype=dtype, device=dev)
                         for name, (dtype, value) in self._CARRIED.items()}
        # uniforms for the Gumbel noise and for draft acceptance
        self._uniform = torch.full((s, self.config.vocab_size), 0.5, device=dev)
        self._accept_u = torch.full((s, k), 0.5, device=dev)
        # inputs staged from the host before a program runs
        self._args = torch.zeros((len(self._ARGS),), dtype=torch.int64, device=dev)
        self._prompt_ids = torch.zeros((1, self.prompt_bucket), dtype=torch.int64, device=dev)
        # an MoE model's chunk runs every slot's row, as the JAX chunk program
        # does: its layers route the S x chunk token set, idle rows included
        self._chunk_rows = s if self.config.num_experts > 1 else 1
        self._chunk_ids = torch.zeros((self._chunk_rows, self.prefill_chunk or 1), dtype=torch.int64,
                                      device=dev)
        self._draft = torch.zeros((s, k), dtype=torch.int64, device=dev)
        self._dlen = torch.zeros((s,), dtype=torch.int64, device=dev)
        self._stages = {name: HostStage(t) for name, t in (
            ("args", self._args), ("prompt", self._prompt_ids), ("chunk", self._chunk_ids),
            ("draft", self._draft), ("dlen", self._dlen))}
        # outputs that are not carried state, read back after a program
        self._out = {
            "t0": torch.zeros((1,), dtype=torch.int32, device=dev),
            "done0": torch.zeros((1,), dtype=torch.bool, device=dev),
            "emitted": torch.zeros((s, k + 1), dtype=torch.int32, device=dev),
            "m": torch.zeros((s,), dtype=torch.int32, device=dev),
            "a": torch.zeros((s,), dtype=torch.int32, device=dev),
        }

    def _stage_args(self, **fields) -> None:
        self._stages["args"].write([fields.get(name, 0) for name in self._ARGS])

    def _arg(self, name: str) -> torch.Tensor:
        """Operand ``name`` of ``_args``, a (1,) int64 view on the device."""
        i = self._ARGS.index(name)
        return self._args[i:i + 1]

    def _run(self, name: str, sig: tuple, body: Callable[[], None]) -> None:
        """Run program ``name`` with signature ``sig``: on CUDA the first
        call runs ``body`` eagerly and captures it, later calls replay the
        graph; eagerly on the CPU (and under :func:`_disable_graphs`). The
        host's block table reaches the device first."""
        self._programs.setdefault(name, set()).add(sig)
        self._backend.device_tables()
        with self._mesh_lock or contextlib.nullcontext():
            if not self._use_graphs:
                body()
                return
            graph = self._graphs.get((name, sig))
            if graph is None:
                self._graphs[(name, sig)] = _Graph(body, self._gens)
                return
            graph.replay()

    def _params(self):
        """The tree the bodies read: the model's, or over a mesh the
        rank's leaves in place."""
        return self._view.params if self._view is not None else self.model.params

    def _mesh(self) -> dict:
        """The step functions' mesh arguments (none without a mesh)."""
        if self._view is None:
            return {}
        return dict(tp=self._tp, fsdp=self._fsdp, ep=self._ep)

    def graph_launches(self) -> dict:
        """Kernel launches of one replay of each captured program:
        ``{"decode_step ()": {kernel: n, ...}, ...}`` (empty without graphs)."""
        return {f"{name} {sig}": dict(g.launches) for (name, sig), g in self._graphs.items()}

    @staticmethod
    def _gumbel(u: torch.Tensor) -> torch.Tensor:
        """Gumbel noise of uniforms, like ``jax.random.gumbel``:
        ``-log(-log(u))`` with ``u`` kept above the smallest normal float."""
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def _draw(self):
        """One step's numbers for every slot, each from its slot's
        generator: V Gumbel uniforms, then (with ``spec``)
        ``spec_draft_len`` acceptance uniforms. A slot that is not decoding
        draws too (its generator is reseeded at its next request's first
        token), so the step has one shape. Returns (Gumbel noise (S, V),
        acceptance uniforms (S, k))."""
        v = self.config.vocab_size
        for i in range(self.slots):
            torch.rand(v, generator=self._gens[i], device=self.device, out=self._uniform[i])
            if self.spec is not None:
                torch.rand(self.spec_draft_len, generator=self._gens[i], device=self.device,
                           out=self._accept_u[i])
        return self._gumbel(self._uniform), self._accept_u

    def _seed_first_token(self, slot: int, seed: int) -> None:
        """Seed the slot's generator with the request's seed and draw its
        first token's V uniforms, eagerly: the generator is picked on the
        host. The same for a single-shot prefill and for the last chunk."""
        self._gens[slot].manual_seed(seed)
        torch.rand(self.config.vocab_size, generator=self._gens[slot], device=self.device,
                   out=self._uniform[slot])

    def _install_first(self, logits, slot: torch.Tensor, is_last=None) -> None:
        """Device half of a request's first token: sample it from its last
        prompt position's (1, V) logits with the uniforms
        :meth:`_seed_first_token` drew, and install the slot's carried
        state. ``is_last`` ((1,) bool, chunks): a chunk before the last
        installs a ghost (pad token, done, no budget) instead."""
        c = self._carried
        pick = {name: c[name].index_select(0, slot) for name in ("temp", "top_k", "top_p")}
        t0 = self._sample(logits, self._gumbel(self._uniform.index_select(0, slot)),
                          pick["temp"], pick["top_k"], pick["top_p"])
        self._install(t0, slot, is_last)

    def _install(self, t0, slot: torch.Tensor, is_last=None) -> None:
        """The slot's carried state after its first token ``t0`` ((1,)
        int32): done at EOS or when the budget (``_args``) is spent."""
        c = self._carried
        eos, pad = c["eos"].index_select(0, slot), c["pad"].index_select(0, slot)
        budget = self._arg("budget").to(torch.int32)
        done0 = ((t0 == eos) & (eos >= 0)) | (budget <= 1)
        budget = budget - 1
        if is_last is not None:
            t0 = torch.where(is_last, t0, pad)
            done0 = done0 | ~is_last
            budget = torch.where(is_last, budget, 0)
        c["token"].index_copy_(0, slot, t0)
        c["done"].index_copy_(0, slot, done0)
        c["budget"].index_copy_(0, slot, budget)
        self._out["t0"].copy_(t0)
        self._out["done0"].copy_(done0)

    def _sample(self, logits, noise, temp, top_k, top_p):
        if self.attention_impl == "kernel":
            from .ops.paged_decode import fused_sample

            return fused_sample(logits.contiguous(), noise.contiguous(), temp.contiguous(),
                                top_k.contiguous(), top_p.contiguous())
        return _sample_rows(logits, noise, temp, top_k, top_p)

    def _readback(self, *tensors):
        """Start non-blocking device->host copies into pinned buffers
        (PyTorch's caching host allocator reuses their blocks); returns
        (host tensors, event) to be read once the event has completed."""
        if self.device.type != "cuda":
            return tuple(t.clone() for t in tensors), None
        hosts = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors)
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return hosts, event

    # --------------------------------------------------------- host API
    def free_slots(self) -> int:
        return len(self._free)

    def _take_slot(self, slot: Optional[int] = None) -> int:
        """A slot out of the free list: the next one, or ``slot``, which
        must be free (a rank that replays the first rank's admissions takes
        the slot that rank named; another would give the ranks different
        block tables)."""
        with self._admission_lock:
            if slot is None:
                if not self._free:
                    raise EngineCapacityError("no free slot (caller must gate on free_slots())")
                return self._free.pop()
            if slot not in self._free:
                raise EngineInvariantError(
                    f"slot {slot} was named for this admission but is not free on this engine "
                    f"(free: {sorted(self._free)}): the ranks' slots diverged")
            self._free.remove(slot)
            return slot

    def _groups(self) -> list:
        """The model's process groups over a mesh, ``dp_shard`` then ``tp``
        or ``ep`` (those it has)."""
        return [g for g in (self._view.fsdp_group, self._view.model_group) if g is not None]

    def _agree_min(self, n: int) -> int:
        """The smallest ``n`` of every rank of the mesh (a MIN over each of
        the model's groups, under the run lock)."""
        from .ops.collectives import all_reduce_

        t = torch.full((1,), n, dtype=torch.int64, device=self.device)
        with self._mesh_lock:
            for group in self._groups():
                all_reduce_(t, group, "min")
        return int(t.item())

    def _return_slot(self, slot: int) -> None:
        """Back to the free list, with an epoch bump: a reservation or a
        transfer under the old epoch is stale from now on."""
        with self._admission_lock:
            self._epochs[slot] += 1
            self._reservations.pop(slot, None)
            self._free.append(slot)

    # ------------------------------------------------ slot-epoch reservations
    def slot_epoch(self, slot: int) -> int:
        """The slot's epoch: bumped each time the slot returns to the free
        list. A transfer receiver fences its COMMIT against it."""
        with self._admission_lock:
            return self._epochs[slot]

    def reserve_slot(self, ttl_s: float = 30.0) -> Tuple[int, int]:
        """Take a free slot out of the free list for an incoming KV
        transfer and return ``(slot, epoch)``. :meth:`insert_prefilled`
        takes the reservation while the epoch is current;
        :meth:`release_reservation` or, after ``ttl_s`` on the engine's
        clock, :meth:`poll` gives the slot back with an epoch bump. Safe
        from any thread. Over a mesh only the first rank reserves: the
        slot reaches the others with the commit that names it."""
        with self._admission_lock:
            if not self._free:
                raise EngineCapacityError(
                    "no free slot to reserve for an incoming KV transfer "
                    "(slots free as occupants retire)")
            slot = self._free.pop()
            self._reservations[slot] = self._clock() + ttl_s
            return slot, self._epochs[slot]

    def release_reservation(self, slot: int, epoch: int) -> bool:
        """Give a reserved slot back (its epoch bumps, so a late COMMIT of
        the old epoch is refused). False when the reservation is already
        gone. Safe from any thread."""
        with self._admission_lock:
            if slot not in self._reservations or self._epochs[slot] != epoch:
                return False
            del self._reservations[slot]
            self._epochs[slot] += 1
            self._free.append(slot)
            return True

    def _reap_reservations(self) -> None:
        """Give back reservations past their TTL (a sender that died after
        BEGIN sends no ABORT)."""
        if not self._reservations:
            return
        now = self._clock()
        with self._admission_lock:
            for slot in [s for s, expiry in self._reservations.items() if now >= expiry]:
                del self._reservations[slot]
                self._epochs[slot] += 1
                self._free.append(slot)

    def kv_prefix_digest(self, limit: int = 512) -> dict:
        """``{"block_size": B, "crcs": [...]}``: crc32 of each registered
        block-aligned prefix key (at most ``limit``), for placing requests
        where their prefix is warm; empty for the dense store."""
        fn = getattr(self._backend, "prefix_digest", None)
        return {"block_size": getattr(self._backend, "block_size", 0),
                "crcs": fn(limit) if fn is not None else []}

    @property
    def kv_host_tier(self):
        """The backend's :class:`~accelerate_tpu_torch.kvcache.HostKVTier`
        (None without a host tier)."""
        return getattr(self._backend, "host_tier", None)

    def prefetch(self, prompt) -> None:
        """Start the host-to-device copies of the host-tier blocks
        ``prompt`` would restore (on a side stream), so they run while the
        request waits. Safe from any thread; nothing without a host tier."""
        if hasattr(self._backend, "prefetch"):
            self._backend.prefetch(np.asarray(prompt, np.int32).reshape(-1))

    def live_count(self) -> int:
        return sum(1 for o in self._occupants if o is not None and not o.finished)

    def occupants(self) -> List[SlotOccupant]:
        """Live (unfinished) occupants, for scheduler policy passes."""
        return [o for o in self._occupants if o is not None and not o.finished]

    def _decoding_slots(self) -> List[int]:
        return [i for i, o in enumerate(self._occupants)
                if o is not None and not o.finished and not o.prefilling]

    def _decoding_count(self) -> int:
        return len(self._decoding_slots())

    def validate_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """Raise ValueError when a request cannot fit this engine."""
        if prompt_len < 1:
            raise ValueError(f"prompt length must be >= 1, got {prompt_len}")
        if prompt_len > self.prompt_bucket and self.prefill_chunk is None:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the engine prompt bucket "
                f"({self.prompt_bucket}); raise ServingConfig.engine_prompt_bucket, "
                "enable chunked prefill (engine_prefill_chunk), or shorten the prompt"
            )
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if prompt_len + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens ({max_new_tokens}) exceeds "
                f"the KV arena length ({self.max_len}); raise ServingConfig."
                "engine_max_len or lower the budget"
            )
        self._backend.validate_request(prompt_len, max_new_tokens)

    def validate_tokens(self, ids) -> None:
        """Raise ValueError for a token id outside the vocabulary: on the
        card an out-of-range embedding index is a device-side assert that
        poisons the CUDA context instead of raising."""
        ids = np.asarray(ids).reshape(-1)
        v = self.config.vocab_size
        if ids.size and (ids.min() < 0 or ids.max() >= v):
            raise ValueError(f"token ids must be in [0, {v}), got [{ids.min()}, {ids.max()}]")

    def can_admit(self, prompt, max_new_tokens: int) -> bool:
        """True when a slot and the request's KV blocks are free now."""
        if not self._free:
            return False
        return self._backend.can_admit(np.asarray(prompt, dtype=np.int32).reshape(-1), max_new_tokens)

    @torch.no_grad()
    def insert(
        self,
        prompt,
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_token_id: Optional[int] = None,
        pad_token_id: Optional[int] = None,
        seed: int = 0,
        tag: Any = None,
        slot: Optional[int] = None,
        on_slot: Optional[Callable[[int], None]] = None,
    ) -> SlotOccupant:
        """Admit one request into a free slot: bucketed prompt forward,
        first token sampled on the device, prompt KV written into the
        slot's blocks. A prompt longer than the bucket (``prefill_chunk``
        set) takes the chunked path: its first chunk runs here, the rest
        one per :meth:`step`. ``slot`` names the slot (it must be free);
        ``on_slot(slot)`` runs once the slot is taken, before anything
        else (over a mesh, the module docstring)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.validate_request(len(prompt), max_new_tokens)
        pad_id = pad_token_id if pad_token_id is not None else (
            eos_token_id if eos_token_id is not None else 0)
        # finished slots feed their pad token to the next steps' embedding
        self.validate_tokens(np.append(prompt, pad_id))
        chunked = len(prompt) > self.prompt_bucket
        slot = self._take_slot(slot)
        try:
            if on_slot is not None:
                on_slot(slot)
            row, shared = self._backend.acquire(slot, prompt, max_new_tokens,
                                                defer_register=chunked)
        except BaseException:
            self._return_slot(slot)
            raise
        eos = eos_token_id if eos_token_id is not None else -1
        c = self._carried
        c["temp"][slot] = float(temperature)
        c["top_k"][slot] = int(top_k if top_k is not None else 0)
        c["top_p"][slot] = float(top_p if top_p is not None else 1.0)
        c["eos"][slot] = eos
        c["pad"][slot] = pad_id
        trace_id = getattr(tag, "trace_id", None)
        occ = SlotOccupant(
            slot=slot, tag=tag, prompt=prompt, budget=max_new_tokens, pad_id=pad_id,
            eos_id=eos_token_id, inserted_s=self._clock(), prefilling=chunked, trace_id=trace_id,
        )
        self._occupants[slot] = occ
        self.inserted += 1
        self.peak_live = max(self.peak_live, self.live_count())
        if chunked:
            # consecutive host-tier blocks past the shared ones come back in
            # one restore; their content is the original bytes, so their
            # registrations serve prefix hits at once
            restored = 0
            if hasattr(self._backend, "restore_plan"):
                agree = None
                if self._view is not None and self.kv_host_tier is not None:
                    # every rank plans against its spills filed, and
                    # restores the chain every rank holds
                    self._backend.spill_flush(self._SPILL_FLUSH_S)
                    agree = self._agree_min
                plan = self._backend.restore_plan(slot, prompt, shared, row, agree=agree)
                if plan is not None:
                    n, payloads, ids = plan
                    self._dispatch_restore(occ, payloads, ids)
                    self._backend.promote_deferred(slot, n)
                    restored = n
            # chunks start at the first one not covered by shared prefix
            # blocks; min(.., P-1) keeps the last position in the last chunk
            shared_tokens = (shared + restored) * getattr(self._backend, "block_size", 0)
            chunk = self.prefill_chunk
            occ.prefill_pos = (min(shared_tokens, len(prompt) - 1) // chunk) * chunk
            occ.chunk_args = dict(seed=seed, budget=max_new_tokens, eos=eos)
            self._prefill_queue.append(occ)
            # the first chunk runs inside the admission, installing the
            # slot's position and ghost mask before any decode step
            self._dispatch_chunk(occ)
            return occ
        length = len(prompt)
        padded = np.zeros((1, self.prompt_bucket), np.int64)
        padded[0, :length] = prompt
        self._stages["prompt"].write(padded)
        self._stage_args(slot=slot, pos=length - 1, budget=max_new_tokens)
        self._seed_first_token(slot, seed)
        # the span times the host's dispatch (a replay, or the first call's
        # eager run and capture), outside the body a graph records
        with tracing.span("engine.prefill", trace_id=trace_id, slot=slot, prompt_len=length):
            self._run("prefill_insert", (self.prompt_bucket,), self._prefill_body)
        self._tick += 1
        self._ring.append((self._tick, "prefill", occ, *self._readback(self._out["t0"], self._out["done0"])))
        return occ

    @torch.no_grad()
    def _dispatch_restore(self, occ: SlotOccupant, payloads, ids) -> None:
        """``prefill_insert ("restore", blocks_per_row)``: the host-tier
        payloads scattered into the slot's fresh blocks ``ids``, eagerly,
        one ``index_copy_`` per pool leaf (the module docstring)."""
        self._programs.setdefault("prefill_insert", set()).add(
            ("restore", self._backend.blocks_per_row))
        target = torch.tensor(ids, dtype=torch.long).to(self.device)

        def scatter(leaf, parts):
            leaf.index_copy_(1, target, torch.stack(parts, dim=1).to(leaf.dtype))

        with tracing.span("engine.kv_restore", trace_id=occ.trace_id, slot=occ.slot,
                          blocks=len(payloads)):
            for w in ("k", "v"):
                leaf = self._cache[w]
                if isinstance(leaf, dict):
                    for part in ("q", "s"):
                        scatter(leaf[part], [p[w][part] for p in payloads])
                else:
                    scatter(leaf, [p[w] for p in payloads])
        self.kv_restores += 1
        self._tick += 1
        self._ring.append((self._tick, "chunk", occ, (), None))

    def _prefill_body(self) -> None:
        """``prefill_insert (bucket,)``: the prompt's forward, its KV into
        the slot's blocks, the slot's position, and the first token. Every
        operand is on the device: the prompt, the slot and the last prompt
        position (``_args``), the slot's table row."""
        slot, last = self._arg("slot"), self._arg("pos")
        logits, new_cache = self._prefill_at_fn(
            self.config, self._params(), self._prompt_ids, self.max_len, last, **self._mesh())
        self._backend.prefill_write(self._cache, new_cache, slot, self._tables.index_select(0, slot)[0])
        self._pos.index_copy_(0, slot, (last + 1).to(torch.int32))
        self._install_first(logits, slot)

    # ------------------------------------------------------- chunked prefill
    @torch.no_grad()
    def _dispatch_chunk(self, occ: SlotOccupant) -> None:
        """One chunk of a long prompt: a window forward over the slot alone
        (B = 1; an MoE model's over every slot, the others' rows zeros at
        their positions, as the JAX program routes them) at its offset,
        teacher-forced on the prompt, committing every real column. The
        slot's masked decode writes land at the next chunk's first
        position, which that chunk rewrites before anything attends it. The
        last chunk samples the first token; the prompt's parked prefix
        registrations are installed then."""
        slot, chunk = occ.slot, self.prefill_chunk
        length = len(occ.prompt)
        offset = occ.prefill_pos
        chunk_len = min(chunk, length - offset)
        is_last = offset + chunk_len >= length
        tokens = np.zeros((self._chunk_rows, chunk), np.int64)
        row = slot if self._chunk_rows > 1 else 0
        tokens[row, :chunk_len] = occ.prompt[offset: offset + chunk_len]
        self._stages["chunk"].write(tokens)
        args = occ.chunk_args
        self._stage_args(slot=slot, pos=offset, count=chunk_len, col=min(length - 1 - offset, chunk - 1),
                         last=int(is_last), budget=args["budget"])
        if is_last:
            self._seed_first_token(slot, args["seed"])
        with tracing.span("engine.prefill_chunk", trace_id=occ.trace_id, slot=slot, offset=offset,
                          chunk_len=chunk_len):
            self._run("prefill_insert", ("chunk", chunk), self._chunk_body)
        self.prefill_chunks += 1
        occ.prefill_pos = offset + chunk_len
        self._tick += 1
        if not is_last:
            self._ring.append((self._tick, "chunk", occ, (), None))
            return
        occ.prefilling = False
        occ.chunk_args = None
        if occ in self._prefill_queue:
            self._prefill_queue.remove(occ)
        # the prompt's content now exists: later requests may share it
        if hasattr(self._backend, "promote_deferred"):
            self._backend.promote_deferred(slot)
        self._ring.append((self._tick, "prefill", occ, *self._readback(self._out["t0"], self._out["done0"])))

    def _chunk_body(self) -> None:
        """``prefill_insert ("chunk", chunk)``: the window forward over one
        slot at its offset, its first ``count`` columns committed, the
        slot's position, and the first token, which only the last chunk
        installs (a chunk before it leaves the slot a ghost, even if a
        cancelled predecessor left its done flag off)."""
        slot = self._arg("slot")
        pos, count = self._arg("pos").to(torch.int32), self._arg("count").to(torch.int32)
        if self._chunk_rows > 1:  # every slot's row at its position, only the slot's committed
            rows_pos = self._pos.index_copy(0, slot, pos)
            logits, win_kv = self._verify_fn(
                self.config, self._params(), self._cache, self._chunk_ids, rows_pos,
                kv_layout=self._backend.make_layout(self._tables), **self._mesh(),
            )
            self._backend.commit_window(self._cache, win_kv, self._tables, rows_pos,
                                        torch.zeros_like(rows_pos).index_copy_(0, slot, count))
            logits = logits.index_select(0, slot)
        else:
            cache, tables = self._backend.rows(self._cache, self._tables, slot)
            logits, win_kv = self._verify_fn(
                self.config, self._params(), cache, self._chunk_ids, pos,
                kv_layout=self._backend.make_layout(tables), **self._mesh(),
            )
            self._backend.commit_window(self._cache, win_kv, tables, pos, count, rows=slot)
        self._pos.index_copy_(0, slot, pos + count)
        last_col = logits.index_select(1, self._arg("col"))[:, 0]
        self._install_first(last_col, slot, is_last=self._arg("last").bool())

    def prefill_step(self, limit: Optional[int] = None) -> bool:
        """Dispatch up to ``limit`` (default: the clamp of
        :meth:`set_prefill_chunk_limit`) pending chunks, round-robin over the
        PREFILLING slots. True when anything was dispatched."""
        n = self._prefill_chunk_limit if limit is None else limit
        dispatched = False
        for _ in range(n):
            if not self._prefill_queue:
                break
            occ = self._prefill_queue[0]
            self._prefill_queue.rotate(-1)
            self._dispatch_chunk(occ)
            dispatched = True
        return dispatched

    def set_prefill_chunk_limit(self, n: int) -> None:
        """Chunks each :meth:`step` may dispatch; 0 pauses chunked prefill
        (admitted long prompts keep their slots but burn no compute)."""
        self._prefill_chunk_limit = max(0, int(n))

    @property
    def prefill_chunk_limit(self) -> int:
        return self._prefill_chunk_limit

    def prefill_chunks_pending(self) -> int:
        """Chunks still owed across all PREFILLING slots."""
        chunk = self.prefill_chunk or self.prompt_bucket
        return sum(-(-(len(o.prompt) - o.prefill_pos) // chunk) for o in self._prefill_queue)

    # ------------------------------------------------- disaggregated prefill
    def _remote_stream(self):
        """The calling thread's stream for :meth:`prefill_remote` (a side
        stream of its own, made at its first call)."""
        stream = getattr(self._remote, "stream", None)
        if stream is None:
            stream = self._remote.stream = torch.cuda.Stream(self.device)
        return stream

    @torch.no_grad()
    def prefill_remote(
        self,
        prompt,
        *,
        max_new_tokens: int,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
        eos_token_id: Optional[int] = None,
        pad_token_id: Optional[int] = None,
        seed: int = 0,
        trace_id: Optional[str] = None,
    ) -> RemotePrefill:
        """Run a request's bucketed prompt forward and draw its first
        token without admitting it (``prefill_forward (bucket,)``): safe
        from any thread, it reads the model and writes only tensors of its
        own, eagerly, on the calling thread's own CUDA stream. The first
        token's V uniforms come from a generator of its own seeded with
        ``seed``, as :meth:`insert` draws them. Commit the result with
        :meth:`insert_prefilled` on the serving thread. The forward runs in
        an ``engine.prefill`` span (``remote=True``) under ``trace_id``.
        Over a mesh it is an SPMD call on every rank, under the run lock on
        the current stream, and returns the whole window (the module
        docstring)."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.validate_request(len(prompt), max_new_tokens)
        if len(prompt) > self.prompt_bucket:
            raise ValueError(
                "prefill_remote cannot disaggregate a chunked (long) prompt; admit it "
                "with insert() so its chunks interleave with decode")
        pad_id = pad_token_id if pad_token_id is not None else (
            eos_token_id if eos_token_id is not None else 0)
        self.validate_tokens(np.append(prompt, pad_id))
        self._programs.setdefault("prefill_forward", set()).add((self.prompt_bucket,))
        cuda = self.device.type == "cuda"
        mesh = self._view is not None
        with torch.cuda.device(self.device) if cuda else contextlib.nullcontext(), \
                torch.cuda.stream(self._remote_stream()) if cuda and not mesh \
                else contextlib.nullcontext():
            padded = np.zeros((1, self.prompt_bucket), np.int64)
            padded[0, :len(prompt)] = prompt
            ids = torch.from_numpy(padded).to(self.device)
            with tracing.span("engine.prefill", trace_id=trace_id, remote=True,
                              prompt_len=len(prompt)), \
                    self._mesh_lock or contextlib.nullcontext():
                logits, cache = self._prefill_at_fn(self.config, self._params(), ids,
                                                    self.max_len, [len(prompt) - 1], **self._mesh())
                if self._tp is not None:
                    from .models.llama import gather_kv_window

                    cache = gather_kv_window(cache, self._tp)
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            uniform = torch.rand((1, self.config.vocab_size), generator=gen, device=self.device)
            operand = lambda v, dtype: torch.full((1,), v, dtype=dtype, device=self.device)  # noqa: E731
            t0 = self._sample(logits, self._gumbel(uniform), operand(temperature, torch.float32),
                              operand(top_k if top_k is not None else 0, torch.int32),
                              operand(top_p if top_p is not None else 1.0, torch.float32))
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
        self.remote_prefills += 1
        return RemotePrefill(
            prompt=prompt, max_new_tokens=max_new_tokens, temperature=temperature, top_k=top_k,
            top_p=top_p, eos_token_id=eos_token_id, pad_token_id=pad_token_id, seed=seed,
            cache=cache, t0=t0, next_key=torch.tensor([seed], dtype=torch.int64),
            engine_config=self.config, prompt_bucket=self.prompt_bucket, max_len=self.max_len,
            event=event,
        )

    def _structurally_accepts(self, pre) -> bool:
        return (isinstance(pre, RemotePrefill) and pre.engine_config is self.config
                and pre.prompt_bucket == self.prompt_bucket and pre.max_len == self.max_len)

    def accepts_prefill(self, pre) -> bool:
        """Whether :meth:`insert_prefilled` can commit ``pre``: computed for
        this model config, prompt bucket and ``max_len``, and, if it came
        over the wire, its reservation still current (else the caller
        falls back to :meth:`insert`)."""
        if not self._structurally_accepts(pre):
            return False
        if pre.reservation is not None:
            slot, epoch = pre.reservation
            with self._admission_lock:
                if slot not in self._reservations or self._epochs[slot] != epoch:
                    return False
        return True

    def _share_window(self, pre: RemotePrefill):
        """Over a mesh: the first rank's window and first token on every
        rank, broadcast in place over the model's groups under the run
        lock (``pre``'s tensors on a replaying rank are the receiving
        buffers); returns this rank's kv heads of the window and the first
        token."""
        from .models.llama import kv_window_heads
        from .ops.collectives import broadcast_first_

        cache = {w: pre.cache[w].contiguous() for w in ("k", "v")}
        t0 = pre.t0.contiguous()
        with self._mesh_lock:
            for leaf in (cache["k"], cache["v"], t0):
                broadcast_first_(leaf, self._groups())
        return kv_window_heads(cache, self._tp), t0

    @torch.no_grad()
    def insert_prefilled(self, pre: RemotePrefill, *, max_new_tokens: Optional[int] = None,
                         tag: Any = None, slot: Optional[int] = None,
                         on_slot: Optional[Callable[[int], None]] = None) -> SlotOccupant:
        """Admit a :class:`RemotePrefill` into a slot (``prefill_commit
        ()``): its KV window into the slot's blocks and its first token
        installed, bitwise what :meth:`insert` with that budget leaves.
        ``max_new_tokens`` may lower the prefill's budget, never raise it.
        A prefill from the wire commits into the slot its transfer reserved,
        and only under the epoch it reserved
        (:class:`~accelerate_tpu_torch.utils.fault.TransferStaleEpochError`
        otherwise). The slot's generator is reseeded and draws the first
        token's uniforms again, as :meth:`insert` leaves it. ``slot`` and
        ``on_slot`` as in :meth:`insert`; over a mesh every rank commits
        the first rank's window (the module docstring)."""
        if not self._structurally_accepts(pre):
            raise ValueError(
                "RemotePrefill is not compatible with this engine (model config / prompt_bucket "
                "/ max_len mismatch); recompute it with prefill_remote or fall back to insert()")
        budget = pre.max_new_tokens if max_new_tokens is None else max_new_tokens
        if budget > pre.max_new_tokens:
            raise ValueError(f"insert_prefilled budget ({budget}) cannot exceed the prefill's "
                             f"budget ({pre.max_new_tokens})")
        prompt = np.asarray(pre.prompt, dtype=np.int32).reshape(-1)
        self.validate_request(len(prompt), budget)
        if pre.reservation is not None:
            slot, epoch = pre.reservation
            with self._admission_lock:
                fresh = slot in self._reservations and self._epochs[slot] == epoch
                if fresh:
                    del self._reservations[slot]
            if not fresh:
                raise TransferStaleEpochError(
                    f"KV transfer reservation for slot {slot} is stale (transfer epoch {epoch}, "
                    f"current {self.slot_epoch(slot)}): the slot was released while the stream "
                    "was in flight; fall back to a local prefill")
        else:
            slot = self._take_slot(slot)
        try:
            if on_slot is not None:
                on_slot(slot)
            self._backend.acquire(slot, prompt, budget)
        except BaseException:
            self._return_slot(slot)
            raise
        pad_id = pre.pad_token_id if pre.pad_token_id is not None else (
            pre.eos_token_id if pre.eos_token_id is not None else 0)
        c = self._carried
        c["temp"][slot] = float(pre.temperature)
        c["top_k"][slot] = int(pre.top_k if pre.top_k is not None else 0)
        c["top_p"][slot] = float(pre.top_p if pre.top_p is not None else 1.0)
        c["eos"][slot] = pre.eos_token_id if pre.eos_token_id is not None else -1
        c["pad"][slot] = pad_id
        trace_id = getattr(tag, "trace_id", None)
        occ = SlotOccupant(slot=slot, tag=tag, prompt=prompt, budget=budget, pad_id=pad_id,
                           eos_id=pre.eos_token_id, inserted_s=self._clock(), trace_id=trace_id)
        self._occupants[slot] = occ
        self.inserted += 1
        self.peak_live = max(self.peak_live, self.live_count())
        self._stage_args(slot=slot, pos=len(prompt) - 1, budget=budget)
        self._seed_first_token(slot, int(pre.next_key[0]))
        self._programs.setdefault("prefill_commit", set()).add(())
        tables = self._backend.device_tables()
        if pre.event is not None:
            # the forward ran on its own stream: wait for it, and keep its
            # tensors from that stream's reuse until this one is past them
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(pre.event)
            for leaf in (*pre.cache.values(), pre.t0):
                leaf.record_stream(stream)
        slot_t, last = self._arg("slot"), self._arg("pos")
        with tracing.span("engine.insert_prefilled", trace_id=trace_id, slot=slot,
                          prompt_len=len(prompt)):
            window, t0 = (pre.cache, pre.t0) if self._view is None else self._share_window(pre)
            # an int8 store's scales are taken over the tp group
            with self._mesh_lock or contextlib.nullcontext():
                self._backend.prefill_write(self._cache, window, slot_t,
                                            tables.index_select(0, slot_t)[0])
            self._pos.index_copy_(0, slot_t, (last + 1).to(torch.int32))
            self._install(t0.to(torch.int32), slot_t)
        self._tick += 1
        self._ring.append((self._tick, "prefill", occ, *self._readback(self._out["t0"], self._out["done0"])))
        return occ

    # ------------------------------------------------------------- steps
    def step(self) -> bool:
        """One scheduler tick: up to the clamp of pending prompt chunks,
        then one step over every decoding slot (vacant, finished and
        PREFILLING slots ride masked): a verify step when some slot drafted,
        else a decode step. False when nothing was dispatched."""
        dispatched = self.prefill_step()
        if self._decoding_count() == 0:
            return dispatched
        if self.spec is not None:
            return self._step_spec() or dispatched
        return self._dispatch_decode() or dispatched

    def _ring_occupants(self) -> tuple:
        """Occupant snapshot for a decode/verify ring entry; a PREFILLING
        slot rode the step masked, so it is None here (absorbing its pad row
        would retire the request)."""
        return tuple(None if (o is not None and o.prefilling) else o for o in self._occupants)

    @torch.no_grad()
    def _dispatch_decode(self) -> bool:
        # sampled: a span every decode_sample_every steps, the host's
        # dispatch only (the replayed graph never sees the tracer)
        with tracing.step_span("engine.decode_step", self.steps, live=self.live_count(),
                               tick=self._tick):
            self._run("decode_step", (), self._decode_body)
        self.steps += 1
        self._tick += 1
        c = self._carried
        self._ring.append((self._tick, "decode", self._ring_occupants(),
                           *self._readback(c["token"], c["done"])))
        return True

    def _decode_body(self) -> None:
        """``decode_step ()``: one token for every slot, the carried state
        updated in place."""
        c = self._carried
        logits, _ = self._decode_fn(
            self.config, self._params(), self._cache, c["token"][:, None].long(),
            self._pos, kv_layout=self._backend.make_layout(self._tables), **self._mesh(),
        )
        noise, _ = self._draw()
        nxt = self._sample(logits, noise, c["temp"], c["top_k"], c["top_p"])
        emitting = ~c["done"]
        nxt = torch.where(emitting, nxt, c["pad"])
        budget = c["budget"] - emitting.to(torch.int32)
        hit_eos = (c["eos"] >= 0) & (nxt == c["eos"])
        done = c["done"] | (emitting & (hit_eos | (budget <= 0)))
        self._pos += emitting.to(torch.int32)
        c["token"].copy_(nxt)
        c["budget"].copy_(budget)
        c["done"].copy_(done)

    @torch.no_grad()
    def _dispatch_verify(self, draft_np: np.ndarray, dlen_np: np.ndarray) -> None:
        self._stages["draft"].write(draft_np)
        self._stages["dlen"].write(dlen_np)
        with tracing.step_span("engine.spec_verify", self.steps, drafted=int(dlen_np.sum()),
                               live=self.live_count()):
            self._run("verify_step", (self.spec_draft_len,), self._verify_body)
        self.steps += 1
        self.spec_verify_steps += 1
        self._tick += 1
        o = self._out
        self._ring.append((self._tick, "verify", (self._ring_occupants(), dlen_np),
                           *self._readback(o["emitted"], o["m"], o["a"], self._carried["done"])))

    def _verify_body(self) -> None:
        """``verify_step (k,)`` over every slot: window ``[token, drafts]``
        at ``pos .. pos+k``, drafts accepted by :func:`_verify_accept` with
        this step's noise, so a row without drafts draws exactly what decode
        draws. Emission stops at the budget and at the first EOS; exactly
        ``m`` window columns are committed (the last emitted token is
        carried, as after decode)."""
        k = self.spec_draft_len
        w = k + 1
        c, dev = self._carried, self.device
        draft, dlen = self._draft, self._dlen
        tokens = torch.cat([c["token"][:, None].long(), draft], dim=1)
        logits, win_kv = self._verify_fn(
            self.config, self._params(), self._cache, tokens, self._pos,
            kv_layout=self._backend.make_layout(self._tables), **self._mesh(),
        )
        noise, u = self._draw()
        emitted, a = _verify_accept(logits, draft, dlen, c["temp"], c["top_k"], c["top_p"],
                                    u[:, :k], noise)
        # stop at the budget and at the first EOS
        jw = torch.arange(w, device=dev)[None, :]
        eos = c["eos"].long()
        is_eos = (eos[:, None] >= 0) & (emitted == eos[:, None]) & (jw <= a[:, None])
        first_eos = torch.where(is_eos, jw, w + 1).amin(dim=1)
        done = c["done"]
        emitting = ~done
        m = torch.minimum(torch.minimum(a + 1, c["budget"].long()), first_eos + 1)
        m = torch.where(emitting, m, torch.zeros_like(m))
        pad = c["pad"].long()
        emitted = torch.where(jw < m[:, None], emitted, pad[:, None])
        self._backend.commit_window(self._cache, win_kv, self._tables, self._pos, m)
        last = emitted.gather(1, (m - 1).clamp_min(0)[:, None])[:, 0]
        budget = c["budget"] - m.to(torch.int32)
        self._pos += m.to(torch.int32)
        c["token"].copy_(torch.where(emitting, last, pad))
        c["done"].copy_(done | (emitting & ((first_eos < m) | (budget <= 0))))
        c["budget"].copy_(budget)
        o = self._out
        o["emitted"].copy_(emitted)
        o["m"].copy_(m)
        o["a"].copy_(a)

    def set_spec_draft_limit(self, n: int) -> None:
        """Clamp the drafter's proposal length at runtime, in [0,
        spec_draft_len]; 0 sends every step down the plain decode path."""
        self._spec_limit = int(np.clip(n, 0, self.spec_draft_len))

    @property
    def spec_draft_limit(self) -> int:
        return self._spec_limit

    def _materialize_ring(self) -> None:
        """Wait for every pending readback, so the drafter sees each slot's
        true history. Absorption and retirement still happen at
        :meth:`poll`, ``readback_lag`` steps late."""
        for entry in self._ring:
            if entry[4] is not None:
                entry[4].synchronize()

    def _pending_tokens(self, occ: SlotOccupant):
        """Tokens emitted for ``occ`` that sit in the (materialized) ring but
        are not absorbed yet, and whether a pending entry already marked the
        slot done. Entries of an earlier occupant of the slot are skipped."""
        toks: List[int] = []
        done = False
        for _, kind, payload, hosts, _ in self._ring:
            if kind == "chunk":
                continue
            if kind == "prefill":
                if payload is occ:
                    toks.append(int(hosts[0][0]))
                    done = done or bool(hosts[1][0])
                continue
            occs = payload if kind == "decode" else payload[0]
            if occs[occ.slot] is not occ:
                continue
            if kind == "decode":
                toks.append(int(hosts[0][occ.slot]))
                done = done or bool(hosts[1][occ.slot])
            else:
                emitted, ms, _, dones = hosts
                toks.extend(int(t) for t in emitted[occ.slot, : int(ms[occ.slot])])
                done = done or bool(dones[occ.slot])
        return toks, done

    def _step_spec(self) -> bool:
        """Draft for every decoding slot, then one step: a verify step when
        anyone drafted, the plain decode step when nobody did."""
        # every decoding slot is in its EWMA cooldown, so nobody can draft:
        # skip the blocking readback and keep the pipeline as deep as plain
        # decoding
        gated = []
        for occ in self._occupants:
            if occ is None or occ.finished or occ.prefilling:
                continue
            if not (occ.spec_ewma < self._SPEC_MIN_ACCEPT and occ.spec_skips + 1 < occ.spec_cooldown):
                gated = None
                break
            gated.append(occ)
        if gated:
            for occ in gated:
                occ.spec_skips += 1
            return self._dispatch_decode()
        self._materialize_ring()
        k = self.spec_draft_len
        draft = np.zeros((self.slots, k), np.int32)
        dlen = np.zeros((self.slots,), np.int32)
        for occ in self._occupants:
            if occ is None or occ.finished or occ.prefilling:
                continue
            pending, pending_done = self._pending_tokens(occ)
            if pending_done:
                continue
            # gated slots skip drafting; after the cooldown the EWMA resets
            # to the floor so one probe can rehabilitate the slot
            if occ.spec_ewma < self._SPEC_MIN_ACCEPT:
                occ.spec_skips += 1
                if occ.spec_skips < occ.spec_cooldown:
                    continue
                occ.spec_skips = 0
                occ.spec_ewma = self._SPEC_MIN_ACCEPT
            emitted_count = len(occ.tokens) + len(pending)
            # the last budgeted token is sampled by the step itself, hence
            # -1; this also keeps every real window position inside the row
            limit = min(self._spec_limit, occ.budget - emitted_count - 1)
            if limit <= 0:
                continue
            hist = np.concatenate([occ.prompt, np.asarray(occ.tokens + pending, np.int32)])
            d = _prompt_lookup(hist, limit, self.spec_ngram, self.spec_ngram_min)
            if len(d) == 0:
                # nothing to propose is evidence of incompressible traffic:
                # decay the EWMA (and back off once below the floor)
                occ.spec_ewma *= 1 - self._SPEC_EWMA_ALPHA
                if occ.spec_ewma < self._SPEC_MIN_ACCEPT:
                    occ.spec_cooldown = min(2 * occ.spec_cooldown, self._SPEC_COOLDOWN_MAX)
                continue
            draft[occ.slot, : len(d)] = d
            dlen[occ.slot] = len(d)
        total = int(dlen.sum())
        if total == 0:
            return self._dispatch_decode()
        self._dispatch_verify(draft, dlen)
        self.spec_drafted += total
        return True

    def poll(self, force: bool = False) -> List[SlotOccupant]:
        """Read back every ring entry at least ``readback_lag`` steps old
        (all with ``force=True``) and return the occupants retired."""
        self._reap_reservations()  # the TTL of abandoned KV transfers
        retired: List[SlotOccupant] = []
        popped: collections.Counter = collections.Counter()
        while self._ring and (force or self._tick - self._ring[0][0] >= self.readback_lag):
            _, kind, payload, hosts, event = self._ring.popleft()
            popped[kind] += 1
            if event is not None:
                event.synchronize()  # the ring IS the readback point
            self._absorb_entry(kind, payload, hosts, retired)
        if popped:
            self._pw_flush(popped)
        elif not self._ring:
            # an idle poll moves the mark: the time between requests is
            # never billed to the next window's programs
            self._pw_mark = self._clock()
        return retired

    def _pw_flush(self, popped: "collections.Counter") -> None:
        """Bill the wall time since the previous poll to the programs that
        retired from the ring in it (``perfwatch`` splits it by their
        predictions, or equally without a baseline)."""
        now = self._clock()
        dt, self._pw_mark = now - self._pw_mark, now
        if self.attention_impl == "kernel":
            family = "engine.paged_kernel"
        elif self.spec is not None:
            family = "engine.spec"
        elif self._backend.kind.startswith("paged"):
            family = "engine.paged"
        else:
            family = "engine.dense"
        self._perfwatch.record_window(
            family, {perfwatch.RING_KIND_PROGRAM[k]: n for k, n in popped.items()}, dt)

    def _absorb_entry(self, kind, payload, hosts, retired: list) -> None:
        if kind == "chunk":
            return  # progress only: the last chunk's entry carries t0
        if kind == "prefill":
            self._absorb(payload, int(hosts[0][0]), bool(hosts[1][0]), retired)
            return
        if kind == "decode":
            toks, dones = (h.numpy() for h in hosts)
            for occ in payload:
                if occ is None or occ.finished:
                    continue
                occ.decode_steps += 1
                self._absorb(occ, int(toks[occ.slot]), bool(dones[occ.slot]), retired)
            return
        # verify: up to W tokens per slot; done applies to the last
        occs, dlens = payload
        emitted, ms, accs, dones = (h.numpy() for h in hosts)
        for occ in occs:
            if occ is None or occ.finished:
                continue
            occ.decode_steps += 1
            i = occ.slot
            if dlens[i] > 0:
                self._account_spec(occ, int(accs[i]), int(dlens[i]), int(ms[i]))
            m = int(ms[i])
            for j in range(m):
                if occ.finished:
                    break
                self._absorb(occ, int(emitted[i, j]), bool(dones[i]) and j == m - 1, retired)

    def _account_spec(self, occ: SlotOccupant, acc: int, dl: int, m: int) -> None:
        self.spec_accepted += acc
        self.spec_wasted += dl - acc
        self.spec_emitted += m
        self.spec_slot_steps += 1
        rate = acc / dl
        al = self._SPEC_EWMA_ALPHA
        occ.spec_ewma = (1 - al) * occ.spec_ewma + al * rate
        self.spec_ewma = (1 - al) * self.spec_ewma + al * rate
        # exponential probe backoff: an all-rejected verify doubles the
        # slot's cooldown, any accepted draft resets it
        if acc == 0:
            occ.spec_cooldown = min(2 * occ.spec_cooldown, self._SPEC_COOLDOWN_MAX)
        else:
            occ.spec_cooldown = self._SPEC_COOLDOWN

    def _absorb(self, occ: SlotOccupant, token: int, done: bool, retired: list) -> None:
        if occ.finished:
            return
        if occ.first_token_s is None:
            occ.first_token_s = self._clock()
        occ.tokens.append(token)
        # the device done mask is authoritative; the budget guard backs it up
        if done or len(occ.tokens) >= occ.budget:
            self._retire(occ)
            retired.append(occ)

    def _retire(self, occ: SlotOccupant) -> None:
        with tracing.span("engine.retire", trace_id=occ.trace_id, slot=occ.slot,
                          tokens=len(occ.tokens), decode_steps=occ.decode_steps):
            occ.finished = True
            self._occupants[occ.slot] = None
            self._return_slot(occ.slot)  # the epoch bump fences late transfers
            # frees the blocks and points the row at the null block, so the
            # ghost slot's masked writes land in the sink
            self._backend.release(occ.slot)
        self.retired += 1

    def cancel(self, occ: SlotOccupant) -> None:
        """Force-retire (deadline shed): the slot frees now; the device keeps
        masking it until the next admission resets it, and stale ring
        entries for it are skipped. A cancel mid-prefill drops its pending
        chunks and its parked prefix registrations."""
        if occ.finished:
            return
        if occ.prefilling:
            occ.prefilling = False
            occ.chunk_args = None
            if occ in self._prefill_queue:
                self._prefill_queue.remove(occ)
        if self._occupants[occ.slot] is occ:
            self._retire(occ)
        else:
            occ.finished = True

    def drain(self) -> List[SlotOccupant]:
        """Step until every occupant retires (bounded by the budgets and the
        chunks owed)."""
        retired: List[SlotOccupant] = []
        guard = 2 * self.max_len + self.readback_lag + 4 + 2 * self.prefill_chunks_pending()
        while self.live_count() > 0:
            if guard <= 0:
                raise EngineInvariantError(
                    "engine drain did not converge (device done mask never caught up)"
                )
            guard -= 1
            # converge even when chunked prefill is paused (limit 0)
            if self._prefill_queue and self._prefill_chunk_limit < 1:
                self.prefill_step(limit=1)
            self.step()
            retired.extend(self.poll())
        retired.extend(self.poll(force=True))
        return retired

    def reset(self) -> List[SlotOccupant]:
        """Drop all device state after a failure: a cleared store and
        per-slot state (refilled in place, so the captured programs stay
        valid), an empty ring. Returns the orphaned occupants so the caller
        can fail their requests."""
        orphans = [o for o in self._occupants if o is not None and not o.finished]
        for occ in orphans:
            occ.finished = True
        self.peak_live = 0
        self._occupants = [None] * self.slots
        with self._admission_lock:
            # every epoch bumps: a transfer reserved against the old state
            # is fenced for good
            self._epochs = [e + 1 for e in self._epochs]
            self._reservations.clear()
            self._free = list(range(self.slots))
        self._ring.clear()
        self._prefill_queue.clear()
        self._backend.reset()
        self._backend.device_tables()
        for leaf in _leaves(self._cache):
            leaf.zero_()
        self._pos.zero_()
        for name, (_, value) in self._CARRIED.items():
            self._carried[name].fill_(value)
        self._uniform.fill_(0.5)
        self._accept_u.fill_(0.5)
        return orphans

    def live_tokens(self) -> int:
        return sum((o.prefill_pos if o.prefilling else len(o.prompt)) + len(o.tokens)
                   for o in self.occupants())

    def stats(self) -> dict:
        """Host counters only (no device readback). ``programs``: each
        program's number of signatures, as the JAX engine reports its
        compiled programs; on CUDA each signature is one captured graph."""
        kv = self._backend.stats()
        programs = {name: len(sigs) for name, sigs in self._programs.items()}
        live_tok = self.live_tokens()
        if self._backend.kind == "dense":
            reserved = self.live_count() * self.max_len
        else:
            reserved = self._backend.reserved_tokens()
        kv.update(live_tokens=live_tok, utilization=(live_tok / reserved) if reserved else 0.0)
        return {
            "slots": self.slots,
            "max_len": self.max_len,
            "prompt_bucket": self.prompt_bucket,
            "attention_impl": self.attention_impl,
            "live": self.live_count(),
            "peak_live": self.peak_live,
            "free": len(self._free),
            "inserted": self.inserted,
            "remote_prefills": self.remote_prefills,
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunk_limit": self._prefill_chunk_limit,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunks_pending": self.prefill_chunks_pending(),
            "kv_restores": self.kv_restores,
            "steps": self.steps,
            "retired": self.retired,
            "programs": programs,
            "program_count": sum(programs.values()),
            "kv": kv,
            "spec": {
                "mode": self.spec or "off",
                "draft_len": self.spec_draft_len,
                "draft_limit": self._spec_limit,
                "drafted": self.spec_drafted,
                "accepted": self.spec_accepted,
                "wasted": self.spec_wasted,
                "acceptance_rate": (self.spec_accepted / self.spec_drafted) if self.spec_drafted else 0.0,
                "acceptance_ewma": self.spec_ewma,
                "verify_steps": self.spec_verify_steps,
                # emitted tokens per (slot, verify step) that drafted: 1.0 =
                # verify never beat decode, k+1 = every draft landed
                "tokens_per_step": (self.spec_emitted / self.spec_slot_steps)
                if self.spec_slot_steps else 0.0,
            },
        }
