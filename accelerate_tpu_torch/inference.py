"""Static generation (counterpart of ``accelerate_tpu/inference.py``):
``generate``, ``prepare_inference``, ``generate_cache_stats`` and
``last_generate_stats``.

``generate`` runs one full-forward prefill (:func:`~accelerate_tpu_torch
.models.llama.llama_prefill`: the flash kernel under
``attention_impl="flash"``), then exactly ``max_new_tokens`` decode steps,
each: count the rows already frozen, sample (the greedy argmax, or
temperature, top-k and top-p, then ``argmax(filtered + gumbel)``), freeze
rows at their eos, one ``llama_decode_step``. The JAX package compiles the
whole loop once per structural key (one ``lax.scan``); here a key holds
one :class:`_Program`: the step's buffers (the KV cache or block pool, the
logits, the position, the output, the done mask, the sampling operands and
a ``torch.Generator``) and, on CUDA, the step captured as one CUDA graph
(the engine's :class:`~accelerate_tpu_torch.engine._Graph`). The step
advances its position and output column itself, so a call is one eager
prefill and ``max_new_tokens`` replays, with no host read. Temperature,
top-p and the eos and pad ids are device operands of the graph: calls that
vary them reuse it, as they reuse JAX's program. On the CPU, and under the
engine's ``_disable_graphs``, the same step runs eagerly.

The programs of a model live in an LRU bounded by
``ACCELERATE_GENERATE_CACHE_MAX`` (read when the model's cache is first
attached), as in the JAX package; eviction drops a graph with its buffers
and its memory pool. A graph reads the parameters at the addresses it was
captured with: a call whose parameters moved captures the step again.

Sampled draws come from the program's generator, seeded with ``seed``:
they do not reproduce ``jax.random``. :func:`sample_logits` takes its
Gumbel noise as an operand, so it can be held against JAX's sampler on
JAX's noise.

A model laid over a mesh (:func:`prepare_inference` with ``mesh``: ``tp``
blocks by the rules, FSDP2 shards over ``dp_shard``) is generated by every
rank of the mesh at once, each on its part: the steps read the leaves in
place (``models.llama.serving_view``), the ``dp_shard`` shards gathered
one layer at a time into buffers the model's programs share (they run
under one lock a model, which also keeps the ranks' collectives in one
order), the cache holds the rank's kv heads and the logits buffer its
vocabulary block, gathered whole before each sampling. The JAX package runs one controller; here each rank
runs the same steps, so ``generate`` first checks that every rank was
called with the same ids and sampling arguments (one all-gather of a
small vector over ``tp`` and one over ``dp_shard``) and raises on a
difference: a rank that drew other noise, or decoded other ids, would
write other tokens into its cache and no collective would notice. Every
rank seeds its generator with the same seed, so every draw is the same.
The decode step stays one CUDA graph per program key with its collectives
inside, captured by every rank together after the first step ran eagerly
(which also starts the communicators). A process group that cannot be
captured (torch's threaded one) runs the step eagerly
(:func:`graphs_supported`). Over more than one rank the key ends with
the layout (``tp`` and ``dp_shard`` sizes): one program per layout and
key.
"""

from __future__ import annotations

import contextlib
import os
import threading
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

__all__ = [
    "generate",
    "prepare_inference",
    "generate_cache_stats",
    "last_generate_stats",
    "sample_logits",
]

# the LRU's bound when ACCELERATE_GENERATE_CACHE_MAX is unset or not an int
_GENERATE_CACHE_MAX = 16


def _generate_cache_max() -> int:
    raw = os.environ.get("ACCELERATE_GENERATE_CACHE_MAX")
    if raw is None:
        return _GENERATE_CACHE_MAX
    try:
        return max(1, int(raw))
    except ValueError:
        return _GENERATE_CACHE_MAX


# guards the lazy attach of a model's LRU and lock; the model's lock then
# guards its OrderedDict
_CACHE_ATTACH_LOCK = threading.Lock()


def _model_generate_cache(model):
    cache = getattr(model, "_generate_cache", None)
    lock = getattr(model, "_generate_cache_lock", None)
    if cache is None or lock is None:
        with _CACHE_ATTACH_LOCK:
            cache = getattr(model, "_generate_cache", None)
            lock = getattr(model, "_generate_cache_lock", None)
            if lock is None:
                lock = model._generate_cache_lock = threading.Lock()
            if cache is None:
                model._generate_cache_max = _generate_cache_max()
                cache = model._generate_cache = OrderedDict()
    return cache, lock


def _model_mesh_state(model, fsdp_group):
    """A model laid over a mesh: its one run lock and its one
    :class:`~accelerate_tpu_torch.ops.collectives.ShardGather` over
    ``fsdp_group`` (None without). Every program of the model runs under
    the lock, so the ranks' collectives keep one order and the programs
    share the gather's buffers (one layer's leaves and the head, not one
    copy a program key)."""
    from .ops.collectives import ShardGather

    with _CACHE_ATTACH_LOCK:
        lock = getattr(model, "_generate_mesh_lock", None)
        if lock is None:
            lock = model._generate_mesh_lock = threading.Lock()
        gather = getattr(model, "_generate_gather", None)
        if fsdp_group is None:
            gather = None
        elif gather is None or gather.group is not fsdp_group:
            gather = model._generate_gather = ShardGather(fsdp_group)
    return lock, gather


def sample_logits(logits, noise, temp, p_threshold, *, temp_on: bool,
                  top_k_width: Optional[int], top_p_on: bool):
    """The JAX ``generate``'s sampler over (B, V) f32 ``logits``. Without
    ``temp_on``, the greedy argmax. Otherwise ``logits / temp``; with
    ``top_k_width`` every logit below the k-th largest drops out (ties at
    the k-th stay); with ``top_p_on`` every logit below the nucleus cutoff,
    the sorted logit where the exclusive cumulative probability reaches
    ``p_threshold`` (the top token always stays); then ``argmax(filtered +
    noise)`` with (B, V) Gumbel ``noise``, which is what
    ``jax.random.categorical`` draws. ``temp`` and ``p_threshold`` are
    0-dim tensors. First index at ties. Returns (B,) int32."""
    if not temp_on:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / temp
    if top_k_width is not None:
        kth = torch.topk(logits, top_k_width, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p_on:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1) - probs
        cutoff_idx = ((cum < p_threshold).sum(dim=-1) - 1).clamp_min(0)
        cutoff = sorted_logits.gather(-1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return torch.argmax(logits + noise, dim=-1).to(torch.int32)


def _copy_tree(dst, src) -> None:
    for name, leaf in dst.items():
        if isinstance(leaf, dict):
            _copy_tree(leaf, src[name])
        else:
            leaf.copy_(src[name])


def _param_ptrs(params) -> tuple:
    """The addresses of a serving tree's leaves (FSDP2 shards by their
    local blocks, a per-layer list in order)."""
    from .models.llama import _Shard

    out = []
    nodes = params if isinstance(params, (list, tuple)) else params.values()
    for leaf in nodes:
        if isinstance(leaf, (dict, list)):
            out.extend(_param_ptrs(leaf))
        else:
            out.append((leaf.local if isinstance(leaf, _Shard) else leaf).data_ptr())
    return tuple(out)


def _group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def graphs_supported(view) -> bool:
    """Whether the decode step of a model with this ``serving_view`` can be
    captured: on one process, or over NCCL; torch's threaded process group
    (several ranks as threads of one process) cannot be, and runs eagerly."""
    import torch.distributed as dist

    groups = [g for g in (view.model_group, view.fsdp_group) if g is not None]
    return all(dist.get_backend(g) == "nccl" for g in groups)


# the sampling and shape arguments every rank of a mesh must share, in
# the order _check_same_call gathers them
_CALL_FIELDS = ("batch", "prompt_len", "total_len", "max_new_tokens", "temperature", "seed",
                "top_k", "top_p", "eos_token_id", "pad_token_id", "kv_backend", "kv_block_size",
                "input_ids")


def _call_vector(ids, values: dict) -> torch.Tensor:
    """The call's arguments as int64 (floats by their bits, the ids by a
    position-weighted sum, which differs for any single changed id)."""
    out = []
    for name in _CALL_FIELDS[:-1]:
        v = values[name]
        if isinstance(v, float):
            v = int(np.float64(v).view(np.int64))
        out.append(-1 if v is None else int(v))
    flat = ids.reshape(-1).long()
    weights = torch.arange(1, flat.numel() + 1, device=flat.device, dtype=torch.int64) * 2654435761
    return torch.cat([torch.tensor(out, dtype=torch.int64, device=ids.device),
                      (flat * weights).sum().reshape(1)])


def _gather_over_mesh(vec: torch.Tensor, groups) -> torch.Tensor:
    """Every rank's 1-D ``vec``, (ranks, len) on the host, row-major over
    ``groups`` reversed. The vectors are gathered over each group in turn
    (``tp``, then ``dp_shard``, each gathering the blocks the last one
    gathered), so every rank sees every rank's and reaches the same
    verdict on them."""
    import torch.distributed as dist

    seen = vec[None]
    for group in groups:
        n = _group_size(group)
        if n <= 1:
            continue
        block = seen.contiguous()
        out = block.new_empty(n * block.numel())
        dist.all_gather_into_tensor(out, block.reshape(-1), group=group)
        seen = out.view(n * block.shape[0], block.shape[1])
    return seen.cpu()


def _check_same(vec: torch.Tensor, groups, names, what: str, should: str) -> None:
    """Raise on every rank unless every rank of the mesh holds the same
    1-D ``vec`` (:func:`_gather_over_mesh`): the message names the
    differing ``names`` (one a column) and the mesh indices of the ranks
    that differ from the first; ``what`` opens it, ``should`` ends it."""
    seen = _gather_over_mesh(vec, groups)
    bad = (seen != seen[0]).any(dim=0).nonzero().flatten().tolist()
    if bad:
        ranks = [r for r in range(seen.shape[0]) if not torch.equal(seen[r], seen[0])]
        raise ValueError(
            f"{what}: the rank(s) at mesh index {ranks} (row-major over dp_shard, tp) differ "
            f"from the first in {', '.join(names[i] for i in bad)}; {should}")


def _check_same_call(ids, values: dict, groups) -> None:
    """Raise on every rank unless every rank of the mesh passed the same
    ``values`` and ids (:func:`_check_same`)."""
    _check_same(_call_vector(ids, values), groups, _CALL_FIELDS, "generate over a mesh",
                "every rank must generate the same ids with the same arguments")


def _advance(prog) -> None:
    """The step's last act: the next position and the next output column."""
    prog.pos.add_(1)
    prog.col.add_(1)


class _Program:
    """One structural key's decode step: the buffers it reads and writes,
    which live as long as the program, and its captured graph (CUDA).
    Under ``tp`` the cache holds this rank's kv heads and ``logits`` its
    vocabulary block; under FSDP2 ``fsdp`` is the model's
    :class:`~accelerate_tpu_torch.ops.collectives.ShardGather`, shared by
    its programs."""

    def __init__(self, config, b: int, prompt_len: int, total_len: int, max_new_tokens: int, *,
                 temp_on: bool, top_k_width: Optional[int], top_p_on: bool, eos_on: bool,
                 kv_backend: str, block_size: int, device: torch.device, tp=None, fsdp=None,
                 ep=None):
        from .kvcache import PagedKVLayout, pool_from_dense
        from .models.llama import init_kv_cache

        self.lock = threading.Lock()
        self.prompt_len, self.max_new_tokens = prompt_len, max_new_tokens
        self.temp_on, self.top_k_width, self.top_p_on, self.eos_on = (
            temp_on, top_k_width, top_p_on, eos_on)
        self.tp = tp
        self.fsdp = fsdp
        self.ep = ep
        tp_size = tp.size if tp is not None else 1
        self.tp_group = tp.group if tp is not None else None
        self.cache = init_kv_cache(config, b, total_len, device=device, tp_size=tp_size)
        self.layout = None
        if kv_backend != "dense":
            self.cache, tables = pool_from_dense(self.cache, block_size,
                                                 quantized=kv_backend == "paged_int8",
                                                 group=self.tp_group)
            self.layout = PagedKVLayout(tables, block_size, config.compute_dtype,
                                        tp_group=self.tp_group)
        v = config.vocab_size
        self.logits = torch.zeros((b, v // tp_size), dtype=torch.float32, device=device)
        self.uniform = torch.zeros((b, v), dtype=torch.float32, device=device) if temp_on else None
        self.pos = torch.zeros((), dtype=torch.int64, device=device)
        self.col = torch.zeros((1,), dtype=torch.int64, device=device)
        self.out = torch.zeros((b, max_new_tokens), dtype=torch.int32, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.wasted = torch.zeros((), dtype=torch.int32, device=device)
        self.temp = torch.ones((), dtype=torch.float32, device=device)
        self.top_p = torch.ones((), dtype=torch.float32, device=device)
        self.eos = torch.full((), -1, dtype=torch.int32, device=device)
        self.pad = torch.zeros((), dtype=torch.int32, device=device)
        self.gen = torch.Generator(device=device)
        self.graph = None
        self.graph_params = None  # the parameter addresses the graph reads

    def load(self, logits, cache, *, seed: int, temp: float, top_p: float, eos: int, pad: int):
        """A call's inputs into the program's buffers (device copies and
        fills, nothing read back)."""
        self.logits.copy_(logits)
        _copy_tree(self.cache, cache)
        self.pos.fill_(self.prompt_len)
        self.col.zero_()
        self.done.zero_()
        self.wasted.zero_()
        self.temp.fill_(temp)
        self.top_p.fill_(top_p)
        self.eos.fill_(eos)
        self.pad.fill_(pad)
        self.gen.manual_seed(seed)

    def whole_logits(self):
        """The (B, V) logits the sampler reads: the buffer, or under ``tp``
        every rank's vocabulary block gathered."""
        from .ops.collectives import gather_last_dim

        return self.logits if self.tp is None else gather_last_dim(self.logits, self.tp_group)

    def step(self, config, params) -> None:
        """One decode step on the buffers, in place: what a CUDA graph
        captures."""
        from .engine import ContinuousBatchingEngine
        from .models.llama import llama_decode_step

        # rows already frozen still ride the step: count them
        self.wasted.add_(self.done.sum(dtype=torch.int32))
        noise = None
        if self.temp_on:
            torch.rand(self.uniform.shape, generator=self.gen, device=self.uniform.device,
                       out=self.uniform)
            noise = ContinuousBatchingEngine._gumbel(self.uniform)
        token = sample_logits(self.whole_logits(), noise, self.temp, self.top_p,
                              temp_on=self.temp_on, top_k_width=self.top_k_width,
                              top_p_on=self.top_p_on)
        if self.eos_on:
            token = torch.where(self.done, self.pad, token)
            self.done.logical_or_(token == self.eos)
        self.out.index_copy_(1, self.col, token[:, None])
        logits, _ = llama_decode_step(config, params, self.cache, token[:, None].long(), self.pos,
                                      kv_layout=self.layout, tp=self.tp, fsdp=self.fsdp, ep=self.ep,
                                      vocab_shard=True)
        self.logits.copy_(logits)
        _advance(self)

    def run(self, config, params, use_graphs: bool) -> None:
        """``max_new_tokens`` steps: eagerly, or as replays of the graph. A
        program's first call on CUDA runs its first step eagerly (it builds
        what lives outside the graph), then captures the step."""
        from .engine import _Graph

        n = self.max_new_tokens
        if not use_graphs:
            for _ in range(n):
                self.step(config, params)
            return
        ptrs = _param_ptrs(params)
        if self.graph is not None and self.graph_params != ptrs:
            self.graph = None
        done = 0
        if self.graph is None and n:
            done = 1  # building the graph runs the first step
            self.graph = _Graph(lambda: self.step(config, params),
                                [self.gen] if self.temp_on else [])
            self.graph_params = ptrs
        for _ in range(done, n):
            self.graph.replay()


def generate(
    model,
    input_ids,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    seed: int = 0,
    pad_to: Optional[int] = None,
    *,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    eos_token_id: Optional[int] = None,
    pad_token_id: Optional[int] = None,
    kv_backend: str = "dense",
    kv_block_size: int = 16,
):
    """Greedy (``temperature=0``) or sampled generation for a
    :class:`~accelerate_tpu_torch.models.llama.LlamaForCausalLM`, on the
    device that holds its parameters. ``input_ids`` (B, prompt_len).
    Returns (B, prompt_len + max_new_tokens) int32 token ids on that device.

    ``top_k`` (``None`` or 0: unfiltered) and ``top_p`` (nucleus) filter the
    sampled distribution; ``eos_token_id`` freezes a finished row (its later
    positions emit ``pad_token_id``, which defaults to the eos id, else 0).
    ``pad_to`` sizes the KV cache to at least that many positions (one
    program for prompts that differ in length only below it).
    ``kv_backend``: ``"dense"`` (in-place writes at the batch's position),
    ``"paged"`` (the prefill cache re-laid as a block pool with identity
    tables, :func:`~accelerate_tpu_torch.kvcache.pool_from_dense`, and
    decoded through the engine's view/commit ops; greedy tokens equal
    dense's in f32) or ``"paged_int8"`` (the pool in int8 with one scale
    per position). Paged rounds the cache up to whole ``kv_block_size``
    blocks; the decode always runs exactly ``max_new_tokens`` steps."""
    from . import engine as _engine
    from .kvcache import KV_BACKENDS, pool_from_dense
    from .models.llama import LlamaConfig, _check_supported, _Shard, llama_prefill, serving_view

    if kv_backend not in KV_BACKENDS:
        raise ValueError(f"kv_backend must be one of {KV_BACKENDS}, got {kv_backend!r}")
    paged = kv_backend != "dense"
    if paged and kv_block_size < 1:
        raise ValueError(f"kv_block_size must be >= 1, got {kv_block_size}")
    config = model.config
    if not isinstance(config, LlamaConfig):
        raise NotImplementedError(
            f"generate for {type(config).__name__}: only the Llama family is ported; GPT-2's "
            "generate waits for gpt2.py (ROADMAP.md A11)")
    view = serving_view(model)
    params, tp = view.params, view.tp
    _check_supported(config, params)
    embedding = params["embed_tokens"]["embedding"]
    device = (embedding.local if isinstance(embedding, _Shard) else embedding).device
    if isinstance(input_ids, torch.Tensor):
        ids = input_ids.to(device=device, dtype=torch.int32)
    else:
        ids = torch.from_numpy(np.asarray(input_ids, dtype=np.int32)).to(device)
    b, prompt_len = ids.shape
    total_len = prompt_len + max_new_tokens
    if pad_to is not None:
        total_len = max(total_len, pad_to)
    if paged:  # the pool relay needs whole blocks
        total_len = -(-total_len // kv_block_size) * kv_block_size
    if pad_token_id is None:
        pad_token_id = eos_token_id if eos_token_id is not None else 0

    # the key holds only structural choices (shapes and which sampling
    # branches exist), as the JAX package's does
    temp_on = temperature > 0.0
    top_k_width = (
        top_k if (temp_on and top_k is not None and 0 < top_k < config.vocab_size) else None
    )
    top_p_on = temp_on and top_p is not None and top_p < 1.0
    eos_on = eos_token_id is not None
    groups = [view.model_group, view.fsdp_group]
    laid = any(g is not None for g in groups)
    mesh_lock, fsdp = _model_mesh_state(model, view.fsdp_group) if laid else (None, None)
    # a laid model's calls run one at a time from the same-call check on:
    # every collective in one order on every rank
    with mesh_lock if laid else contextlib.nullcontext():
        if any(_group_size(g) > 1 for g in groups):  # the same call on every rank
            _check_same_call(ids, dict(
                batch=b, prompt_len=prompt_len, total_len=total_len, max_new_tokens=max_new_tokens,
                temperature=float(temperature), seed=seed, top_k=top_k,
                top_p=None if top_p is None else float(top_p), eos_token_id=eos_token_id,
                pad_token_id=pad_token_id, kv_backend=KV_BACKENDS.index(kv_backend),
                kv_block_size=kv_block_size), groups)
        cache_key = (
            type(config).__name__, b, prompt_len, total_len, max_new_tokens,
            temp_on, top_k_width, top_p_on, eos_on,
            kv_backend, kv_block_size if paged else None,
        )
        layout = ("tp", _group_size(tp.group if tp is not None else None),
                  "dp_shard", _group_size(groups[1]))
        if view.ep is not None:
            layout += ("ep", view.ep.size)
        if layout != ("tp", 1, "dp_shard", 1):  # one device's keys are the JAX package's
            cache_key += (layout,)
        programs, cache_lock = _model_generate_cache(model)
        with cache_lock:
            prog = programs.get(cache_key)
            if prog is not None:
                programs.move_to_end(cache_key)
        if prog is None:
            prog = _Program(config, b, prompt_len, total_len, max_new_tokens, temp_on=temp_on,
                            top_k_width=top_k_width, top_p_on=top_p_on, eos_on=eos_on,
                            kv_backend=kv_backend, block_size=kv_block_size, device=device, tp=tp,
                            fsdp=fsdp, ep=view.ep)
            with cache_lock:
                programs[cache_key] = prog
                cache_max = getattr(model, "_generate_cache_max", _GENERATE_CACHE_MAX)
                while len(programs) > cache_max:
                    programs.popitem(last=False)
        use_graphs = (device.type == "cuda" and not _engine._graphs_disabled
                      and graphs_supported(view))
        with torch.no_grad(), contextlib.nullcontext() if laid else prog.lock:
            logits, cache = llama_prefill(config, params, ids.long(), total_len, tp=tp,
                                          fsdp=prog.fsdp, vocab_shard=True, ep=prog.ep)
            if paged:
                cache, _ = pool_from_dense(cache, kv_block_size,
                                           quantized=kv_backend == "paged_int8",
                                           group=prog.tp_group)
            prog.load(logits, cache, seed=seed, temp=temperature if temp_on else 1.0,
                      top_p=top_p if top_p_on else 1.0, eos=eos_token_id if eos_on else -1,
                      pad=pad_token_id)
            del logits, cache
            prog.run(config, params, use_graphs)
            out = torch.cat([ids, prog.out], dim=1)
            # a device scalar, read only by last_generate_stats
            model._last_generate_wasted = prog.wasted.clone()
        return out


def generate_cache_stats(model) -> dict:
    """The model's program LRU: ``{"size", "max", "keys"}``, the structural
    keys it holds, oldest first."""
    cache = getattr(model, "_generate_cache", None)
    lock = getattr(model, "_generate_cache_lock", None)
    cache_max = getattr(model, "_generate_cache_max", _GENERATE_CACHE_MAX)
    if cache is None:
        return {"size": 0, "max": cache_max, "keys": []}
    if lock is not None:
        with lock:
            keys = list(cache.keys())
    else:
        keys = list(cache.keys())
    return {"size": len(keys), "max": cache_max, "keys": keys}


def last_generate_stats(model) -> dict:
    """``{"wasted_decode_steps"}`` of the model's last ``generate``: the
    (row, step) pairs that ran while the row was already frozen at its
    eos. The count stays on the device until this call reads it."""
    wasted = getattr(model, "_last_generate_wasted", None)
    if wasted is None:
        return {"wasted_decode_steps": 0}
    return {"wasted_decode_steps": int(wasted.item())}


def prepare_inference(model, mesh=None, rules=None, *, device="cuda"):
    """The model laid out for inference as the JAX package's
    ``dispatch_model`` lays it. Without ``mesh``: placed on ``device``
    (default ``"cuda"``; raises without a GPU). With ``mesh`` (every rank
    of it calls this, each holding the same values): on this rank's
    device, a Llama split over the mesh's ``tp`` dim by ``rules``
    (``parallel.tp.tensor_parallel_rules()``; an MoE Llama's experts over
    the mesh's ``ep`` dim by ``parallel.ep.expert_parallel_rules()``) and
    sharded per layer by FSDP2 over ``dp_shard``
    (``big_modeling.dispatch_model``); with no
    ``rules`` a mesh of ``dp_shard`` alone shards the parameters and
    nothing else. :func:`generate` and the static ``InferenceServer`` then
    run on every rank of the mesh."""
    from .big_modeling import dispatch_model

    if mesh is None and rules is not None:
        raise ValueError("prepare_inference: rules split a model over a mesh's tp dim; pass the "
                         "mesh too")
    return dispatch_model(model, mesh=mesh, rules=rules, device=device)
