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

Not ported yet (ROADMAP.md A3): disaggregated prefill
(``prefill_remote``/``insert_prefilled``), the host KV tier
(``host_tier_bytes``) and the perfwatch/tracing hooks.
"""

from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ._device import resolve_device
from .kvcache import HostStage, make_kv_backend
from .ops import _build
from .utils.fault import EngineCapacityError, EngineInvariantError

__all__ = ["ContinuousBatchingEngine", "SlotOccupant"]

_graphs_disabled = False


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


class _Graph:
    """One program captured as a CUDA graph. The capture records each
    kernel launch of ``body`` (the wrappers' counts go to ``launches``,
    added once per :meth:`replay`) and advances no generator: the
    registered ones advance at each replay, as an eager call would."""

    def __init__(self, body: Callable[[], None], generators):
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)
        # thread_local: the serving worker captures while other threads
        # may use the card; a synchronising call in this thread still fails
        with _build.capture_launches() as launches, \
                torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            body()
        self.launches = launches

    def replay(self) -> None:
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
    decode_steps: int = 0

    def output_row(self) -> np.ndarray:
        """prompt + emitted tokens, padded with ``pad_id`` to the budget."""
        out = np.full(len(self.prompt) + self.budget, self.pad_id, dtype=np.int32)
        out[: len(self.prompt)] = self.prompt
        out[len(self.prompt): len(self.prompt) + len(self.tokens)] = self.tokens
        return out


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
    parameters are.
    """

    # acceptance-EWMA gate: a slot whose EWMA falls below the floor stops
    # drafting (every wasted draft costs a wider forward) and re-probes
    # after its cooldown
    _SPEC_EWMA_ALPHA = 0.2
    _SPEC_MIN_ACCEPT = 0.1
    _SPEC_COOLDOWN = 8
    _SPEC_COOLDOWN_MAX = 128

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
        from .models.llama import _check_supported, llama_decode_step, llama_prefill_at, llama_verify_step

        if host_tier_bytes:
            raise NotImplementedError(
                "the host-RAM KV tier (host_tier_bytes) is queued in ROADMAP.md A3 "
                "(HostKVTier, restore_plan and the restore program are not ported)"
            )
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
        _check_supported(self.config, model.params)  # float trees only
        params_dev = model.params["embed_tokens"]["embedding"].device
        if params_dev != self.device:
            raise ValueError(f"model parameters are on {params_dev}, engine device is {self.device}")
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
        )
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
        self._use_graphs = self.device.type == "cuda" and not _graphs_disabled
        self._graphs: dict = {}
        self._init_state()
        self._occupants: List[Optional[SlotOccupant]] = [None] * slots
        self._free: List[int] = list(range(slots))
        self._ring: collections.deque = collections.deque()
        # round-robin queue of PREFILLING occupants and the per-tick chunk
        # clamp (0 pauses chunked prefill)
        self._prefill_queue: collections.deque = collections.deque()
        self._prefill_chunk_limit = 1
        self.prefill_chunks = 0
        self._tick = 0
        self.peak_live = 0
        self.inserted = 0
        self.steps = 0
        self.retired = 0

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
        self._chunk_ids = torch.zeros((1, self.prefill_chunk or 1), dtype=torch.int64, device=dev)
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
        if not self._use_graphs:
            body()
            return
        graph = self._graphs.get((name, sig))
        if graph is None:
            body()  # the warm-up is the real call
            self._graphs[(name, sig)] = _Graph(body, self._gens)
            return
        graph.replay()

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
        pick = {name: c[name].index_select(0, slot) for name in ("temp", "top_k", "top_p", "eos", "pad")}
        t0 = self._sample(logits, self._gumbel(self._uniform.index_select(0, slot)),
                          pick["temp"], pick["top_k"], pick["top_p"])
        budget = self._arg("budget").to(torch.int32)
        eos = pick["eos"]
        done0 = ((t0 == eos) & (eos >= 0)) | (budget <= 1)
        budget = budget - 1
        if is_last is not None:
            t0 = torch.where(is_last, t0, pick["pad"])
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
    ) -> SlotOccupant:
        """Admit one request into a free slot: bucketed prompt forward,
        first token sampled on the device, prompt KV written into the
        slot's blocks. A prompt longer than the bucket (``prefill_chunk``
        set) takes the chunked path: its first chunk runs here, the rest
        one per :meth:`step`."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.validate_request(len(prompt), max_new_tokens)
        pad_id = pad_token_id if pad_token_id is not None else (
            eos_token_id if eos_token_id is not None else 0)
        # finished slots feed their pad token to the next steps' embedding
        self.validate_tokens(np.append(prompt, pad_id))
        if not self._free:
            raise EngineCapacityError("no free slot (caller must gate on free_slots())")
        chunked = len(prompt) > self.prompt_bucket
        slot = self._free.pop()
        try:
            _, shared = self._backend.acquire(slot, prompt, max_new_tokens,
                                              defer_register=chunked)
        except BaseException:
            self._free.append(slot)
            raise
        eos = eos_token_id if eos_token_id is not None else -1
        c = self._carried
        c["temp"][slot] = float(temperature)
        c["top_k"][slot] = int(top_k if top_k is not None else 0)
        c["top_p"][slot] = float(top_p if top_p is not None else 1.0)
        c["eos"][slot] = eos
        c["pad"][slot] = pad_id
        occ = SlotOccupant(
            slot=slot, tag=tag, prompt=prompt, budget=max_new_tokens, pad_id=pad_id,
            eos_id=eos_token_id, inserted_s=self._clock(), prefilling=chunked,
        )
        self._occupants[slot] = occ
        self.inserted += 1
        self.peak_live = max(self.peak_live, self.live_count())
        if chunked:
            # chunks start at the first one not covered by shared prefix
            # blocks; min(.., P-1) keeps the last position in the last chunk
            shared_tokens = shared * getattr(self._backend, "block_size", 0)
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
        self._run("prefill_insert", (self.prompt_bucket,), self._prefill_body)
        self._tick += 1
        self._ring.append((self._tick, "prefill", occ, *self._readback(self._out["t0"], self._out["done0"])))
        return occ

    def _prefill_body(self) -> None:
        """``prefill_insert (bucket,)``: the prompt's forward, its KV into
        the slot's blocks, the slot's position, and the first token. Every
        operand is on the device: the prompt, the slot and the last prompt
        position (``_args``), the slot's table row."""
        slot, last = self._arg("slot"), self._arg("pos")
        logits, new_cache = self._prefill_at_fn(
            self.config, self.model.params, self._prompt_ids, self.max_len, last)
        self._backend.prefill_write(self._cache, new_cache, slot, self._tables.index_select(0, slot)[0])
        self._pos.index_copy_(0, slot, (last + 1).to(torch.int32))
        self._install_first(logits, slot)

    # ------------------------------------------------------- chunked prefill
    @torch.no_grad()
    def _dispatch_chunk(self, occ: SlotOccupant) -> None:
        """One chunk of a long prompt: a window forward over the slot alone
        (B = 1) at its offset, teacher-forced on the prompt, committing every
        real column. The slot's masked decode writes land at the next
        chunk's first position, which that chunk rewrites before anything
        attends it. The last chunk samples the first token; the prompt's
        parked prefix registrations are installed then."""
        slot, chunk = occ.slot, self.prefill_chunk
        length = len(occ.prompt)
        offset = occ.prefill_pos
        chunk_len = min(chunk, length - offset)
        is_last = offset + chunk_len >= length
        tokens = np.zeros((1, chunk), np.int64)
        tokens[0, :chunk_len] = occ.prompt[offset: offset + chunk_len]
        self._stages["chunk"].write(tokens)
        args = occ.chunk_args
        self._stage_args(slot=slot, pos=offset, count=chunk_len, col=min(length - 1 - offset, chunk - 1),
                         last=int(is_last), budget=args["budget"])
        if is_last:
            self._seed_first_token(slot, args["seed"])
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
        cache, tables = self._backend.rows(self._cache, self._tables, slot)
        logits, win_kv = self._verify_fn(
            self.config, self.model.params, cache, self._chunk_ids, pos,
            kv_layout=self._backend.make_layout(tables),
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

    def prefill_remote(self, *args, **kwargs):
        """Prefill off the decode loop (disaggregated serving)."""
        raise NotImplementedError(
            "prefill_remote/insert_prefilled (disaggregated prefill) are queued in ROADMAP.md A3"
        )

    insert_prefilled = prefill_remote

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
            self.config, self.model.params, self._cache, c["token"][:, None].long(),
            self._pos, kv_layout=self._backend.make_layout(self._tables),
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
            self.config, self.model.params, self._cache, tokens, self._pos,
            kv_layout=self._backend.make_layout(self._tables),
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
        retired: List[SlotOccupant] = []
        while self._ring and (force or self._tick - self._ring[0][0] >= self.readback_lag):
            _, kind, payload, hosts, event = self._ring.popleft()
            if event is not None:
                event.synchronize()  # the ring IS the readback point
            self._absorb_entry(kind, payload, hosts, retired)
        return retired

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
        occ.finished = True
        self._occupants[occ.slot] = None
        self._free.append(occ.slot)
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
            "prefill_chunk": self.prefill_chunk,
            "prefill_chunk_limit": self._prefill_chunk_limit,
            "prefill_chunks": self.prefill_chunks,
            "prefill_chunks_pending": self.prefill_chunks_pending(),
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
