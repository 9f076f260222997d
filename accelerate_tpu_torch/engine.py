"""Continuous-batching decode engine: slot-based KV store plus
iteration-level scheduling state (counterpart of
``accelerate_tpu/engine.py``).

* **Slots over a KV backend** (:mod:`~accelerate_tpu_torch.kvcache`):
  per-slot ``pos/done/budget/token`` and sampling parameters live on the
  device, so mixed greedy and sampled traffic shares one decode step.
* **Two device programs**: ``insert`` runs the bucketed prompt forward
  (``llama_prefill_at``), samples the first token and writes the prompt's
  KV into the slot; ``step`` runs one decode step over every slot, vacant
  and finished slots riding along masked. PyTorch runs them eagerly; the
  KV store is updated in place.
* **Deferred readback**: each program's (token, done) vectors are copied
  to pinned host buffers with non-blocking copies and a CUDA event, and
  read ``readback_lag`` programs later at :meth:`poll`, so the decode loop
  never waits on the device (no ``.item()`` on the decode path).
* **Sampling**: ``attention_impl="kernel"`` (the JAX package's
  ``"pallas"``) sends decode attention through the paged flash-decode
  kernel and both decode's draw and prefill's first-token draw through
  the fused sampling kernel; ``"reference"`` uses the plain paged
  attention and the sort-based :func:`_sample_rows`. Both draw as
  ``argmax(filtered + gumbel)`` with the same Gumbel noise, drawn on the
  device from one ``torch.Generator`` per slot seeded by the request's
  ``seed``: a slot's stream depends only on its own request.

Not ported yet (ROADMAP.md): speculative decoding (``spec``), chunked
prefill (``prefill_chunk``), disaggregated prefill
(``prefill_remote``/``insert_prefilled``), the host KV tier
(``host_tier_bytes``) and the perfwatch/tracing hooks.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ._device import resolve_device
from .kvcache import host_to_device, make_kv_backend
from .utils.fault import EngineCapacityError, EngineInvariantError

__all__ = ["ContinuousBatchingEngine", "SlotOccupant"]


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
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
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
    decode step over every slot, :meth:`poll` reads back matured results and
    returns the occupants it retired, :meth:`cancel` force-retires one,
    :meth:`drain` steps until every occupant retires, :meth:`reset` drops
    all state and returns the orphans.

    ``attention_impl``: ``"reference"`` or ``"kernel"`` (the counterpart of
    the JAX package's ``"pallas"``; needs ``kv_cache="paged"``).
    ``device`` defaults to ``"cuda"`` and must be where the model's
    parameters are.
    """

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
        spec: Optional[str] = None,
        prefill_chunk: Optional[int] = None,
        host_tier_bytes: int = 0,
        device="cuda",
        clock: Callable[[], float] = time.monotonic,
    ):
        from .models.llama import llama_decode_step, llama_prefill_at

        if spec is not None:
            raise NotImplementedError("speculative decoding (spec='ngram') is queued for slice 2 (ROADMAP.md)")
        if prefill_chunk is not None:
            raise NotImplementedError("chunked prefill (prefill_chunk) is queued for slice 2 (ROADMAP.md)")
        if host_tier_bytes:
            raise NotImplementedError("the host-RAM KV tier (host_tier_bytes) is not ported yet (ROADMAP.md)")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {max_len}")
        if readback_lag < 0:
            raise ValueError(f"readback_lag must be >= 0, got {readback_lag}")
        if attention_impl not in ("reference", "kernel"):
            raise ValueError(f"attention_impl must be 'reference' or 'kernel', got {attention_impl!r}")
        self.device = resolve_device(device)
        self.model = model
        self.config = model.config
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
        self.readback_lag = readback_lag
        self._clock = clock
        if attention_impl == "kernel" and self.config.sliding_window is not None:
            # the flash-decode kernel walks the whole live table; a window
            # would need per-block skips it does not implement
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
        self._gens = [torch.Generator(device=self.device) for _ in range(slots)]
        self._init_state()
        self._occupants: List[Optional[SlotOccupant]] = [None] * slots
        self._free: List[int] = list(range(slots))
        self._ring: collections.deque = collections.deque()
        self._tick = 0
        self.peak_live = 0
        self.inserted = 0
        self.steps = 0
        self.retired = 0

    # ----------------------------------------------------------- state
    def _init_state(self) -> None:
        s, dev = self.slots, self.device
        self._cache = self._backend.init_device_state()
        self._pos = torch.zeros((s,), dtype=torch.int32, device=dev)
        # vacant slots are permanently done: they ride every step masked
        self._carried = {
            "token": torch.zeros((s,), dtype=torch.int32, device=dev),
            "done": torch.ones((s,), dtype=torch.bool, device=dev),
            "budget": torch.zeros((s,), dtype=torch.int32, device=dev),
            "temp": torch.zeros((s,), dtype=torch.float32, device=dev),
            "top_k": torch.zeros((s,), dtype=torch.int32, device=dev),
            "top_p": torch.ones((s,), dtype=torch.float32, device=dev),
            "eos": torch.full((s,), -1, dtype=torch.int32, device=dev),
            "pad": torch.zeros((s,), dtype=torch.int32, device=dev),
        }
        # uniforms for the Gumbel noise; vacant rows keep 0.5 (unused)
        self._uniform = torch.full((s, self.config.vocab_size), 0.5, device=dev)

    def _gumbel(self, rows: List[int]) -> torch.Tensor:
        """Gumbel noise for ``rows`` (each from its slot's generator) in an
        (S, V) buffer, like ``jax.random.gumbel``: ``-log(-log(u))`` with
        ``u`` kept above the smallest normal float."""
        for i in rows:
            torch.rand(self.config.vocab_size, generator=self._gens[i],
                       device=self.device, out=self._uniform[i])
        u = self._uniform.clamp_min(torch.finfo(torch.float32).tiny)
        return -torch.log(-torch.log(u))

    def _sample(self, logits, noise, temp, top_k, top_p):
        if self.attention_impl == "kernel":
            from .ops.paged_decode import fused_sample

            return fused_sample(logits.contiguous(), noise.contiguous(), temp.contiguous(),
                                top_k.contiguous(), top_p.contiguous())
        return _sample_rows(logits, noise, temp, top_k, top_p)

    def _readback(self, *tensors):
        """Start non-blocking device->host copies; returns (host tensors,
        event) to be read once the event has completed."""
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

    def validate_request(self, prompt_len: int, max_new_tokens: int) -> None:
        """Raise ValueError when a request cannot fit this engine."""
        if prompt_len < 1:
            raise ValueError(f"prompt length must be >= 1, got {prompt_len}")
        if prompt_len > self.prompt_bucket:
            raise ValueError(
                f"prompt length {prompt_len} exceeds the engine prompt bucket "
                f"({self.prompt_bucket}); raise ServingConfig.engine_prompt_bucket "
                "or shorten the prompt (chunked prefill is not ported yet)"
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
        slot's blocks."""
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        self.validate_request(len(prompt), max_new_tokens)
        pad_id = pad_token_id if pad_token_id is not None else (
            eos_token_id if eos_token_id is not None else 0)
        # finished slots feed their pad token to the next steps' embedding
        self.validate_tokens(np.append(prompt, pad_id))
        if not self._free:
            raise EngineCapacityError("no free slot (caller must gate on free_slots())")
        slot = self._free.pop()
        try:
            table_row, _shared = self._backend.acquire(slot, prompt, max_new_tokens)
        except BaseException:
            self._free.append(slot)
            raise
        dev = self.device
        length = len(prompt)
        padded = np.zeros((1, self.prompt_bucket), np.int32)
        padded[0, :length] = prompt
        eos =eos_token_id if eos_token_id is not None else -1
        c = self._carried
        c["temp"][slot] = float(temperature)
        c["top_k"][slot] = int(top_k if top_k is not None else 0)
        c["top_p"][slot] = float(top_p if top_p is not None else 1.0)
        c["eos"][slot] = eos
        c["pad"][slot] = pad_id

        logits, new_cache = self._prefill_at_fn(
            self.config, self.model.params, host_to_device(padded, dev).long(),
            self.max_len, [length - 1],
        )
        self._gens[slot].manual_seed(seed)
        noise = self._gumbel([slot])[slot: slot + 1]
        t0 = self._sample(logits, noise, c["temp"][slot: slot + 1],
                          c["top_k"][slot: slot + 1], c["top_p"][slot: slot + 1])
        done0 = ((t0 == eos) & (eos >= 0)) | (max_new_tokens - 1 <= 0)
        self._backend.prefill_write(self._cache, new_cache, slot, host_to_device(table_row, dev))
        self._pos[slot] = length
        c["token"][slot: slot + 1] = t0
        c["done"][slot: slot + 1] = done0
        c["budget"][slot] = max_new_tokens - 1

        occ = SlotOccupant(
            slot=slot, tag=tag, prompt=prompt, budget=max_new_tokens, pad_id=pad_id,
            eos_id=eos_token_id, inserted_s=self._clock(),
        )
        self._occupants[slot] = occ
        self.inserted += 1
        self.peak_live = max(self.peak_live, self.live_count())
        self._tick += 1
        self._ring.append((self._tick, "prefill", occ, *self._readback(t0, done0)))
        return occ

    @torch.no_grad()
    def step(self) -> bool:
        """One decode step over every slot (vacant and finished slots ride
        masked). Returns False when no slot is decoding."""
        if self.live_count() == 0:
            return False
        c = self._carried
        tables = self._backend.device_tables()
        layout = self._backend.make_layout(tables)
        logits, self._cache = self._decode_fn(
            self.config, self.model.params, self._cache, c["token"][:, None].long(),
            self._pos, kv_layout=layout,
        )
        live = [i for i, o in enumerate(self._occupants) if o is not None and not o.finished]
        noise = self._gumbel(live)
        nxt = self._sample(logits, noise, c["temp"], c["top_k"], c["top_p"])
        done = c["done"]
        emitting = ~done
        nxt = torch.where(emitting, nxt, c["pad"])
        budget = c["budget"] - emitting.to(torch.int32)
        hit_eos = (c["eos"] >= 0) & (nxt == c["eos"])
        c["done"] = done | (emitting & (hit_eos | (budget <= 0)))
        c["token"] = nxt
        c["budget"] = budget
        self._pos += emitting.to(torch.int32)
        self.steps += 1
        self._tick += 1
        self._ring.append((self._tick, "decode", tuple(self._occupants),
                           *self._readback(nxt, c["done"])))
        return True

    def poll(self, force: bool = False) -> List[SlotOccupant]:
        """Read back every ring entry at least ``readback_lag`` programs old
        (all with ``force=True``) and return the occupants retired."""
        retired: List[SlotOccupant] = []
        while self._ring and (force or self._tick - self._ring[0][0] >= self.readback_lag):
            _, kind, occ_or_occs, hosts, event = self._ring.popleft()
            if event is not None:
                event.synchronize()  # the ring IS the readback point
            toks, dones = (h.numpy() for h in hosts)
            if kind == "prefill":
                self._absorb(occ_or_occs, int(toks.reshape(-1)[0]), bool(dones.reshape(-1)[0]), retired)
                continue
            for occ in occ_or_occs:
                if occ is None or occ.finished:
                    continue
                occ.decode_steps += 1
                self._absorb(occ, int(toks[occ.slot]), bool(dones[occ.slot]), retired)
        return retired

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
        masking it until the next prefill resets it, and stale ring entries
        for it are skipped."""
        if occ.finished:
            return
        if self._occupants[occ.slot] is occ:
            self._retire(occ)
        else:
            occ.finished = True

    def drain(self) -> List[SlotOccupant]:
        """Step until every occupant retires (bounded by the budgets)."""
        retired: List[SlotOccupant] = []
        guard = 2 * self.max_len + self.readback_lag + 4
        while self.live_count() > 0:
            if guard <= 0:
                raise EngineInvariantError(
                    "engine drain did not converge (device done mask never caught up)"
                )
            guard -= 1
            self.step()
            retired.extend(self.poll())
        retired.extend(self.poll(force=True))
        return retired

    def reset(self) -> List[SlotOccupant]:
        """Drop all device state after a failure: fresh store, empty ring.
        Returns the orphaned occupants so the caller can fail their
        requests."""
        orphans = [o for o in self._occupants if o is not None and not o.finished]
        for occ in orphans:
            occ.finished = True
        self.peak_live = 0
        self._occupants = [None] * self.slots
        self._free = list(range(self.slots))
        self._ring.clear()
        self._backend.reset()
        self._init_state()
        return orphans

    def live_tokens(self) -> int:
        return sum(len(o.prompt) + len(o.tokens) for o in self.occupants())

    def stats(self) -> dict:
        kv = self._backend.stats()
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
            "steps": self.steps,
            "retired": self.retired,
            "kv": kv,
        }
