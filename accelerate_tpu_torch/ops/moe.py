"""Mixture-of-Experts routing and the expert FFN (counterpart of
``accelerate_tpu/ops/moe.py``).

The routing is the JAX package's, step for step: the f32 softmax of f32
router logits; the top k by repeated argmax (a tie goes to the lowest
index, as ``jnp.argmax`` and ``torch.argmax`` both give it); each expert's
capacity ``max(k, ceil(capacity_factor * k * N / E))``; slots handed out
first come, first served in token order, both choices of a token counting
at that token; an assignment past capacity dropped; the surviving gates
renormalised over ``max(sum, 1e-9)``; the Switch load-balancing loss over
the dispatch before capacity; the ST-MoE router z-loss.

The JAX package runs the experts on a dense ``(N, E, C)`` one-hot dispatch
tensor through two einsums. Here the dispatch is by index: each kept
(token, expert, slot) is added into an ``(E, C, D)`` capacity buffer, the
SwiGLU experts run on that buffer as batched products (``torch.bmm``), and
each token gathers its k rows back with its gates. Empty slots stay zero
and SwiGLU without biases maps zero to zero, so the result is the dense
einsums' up to summation order, without their ``(N, E*C) x (N, D)``
products (at Mixtral's dropless capacity factor 8.0, C = 2N, those alone
cost more than the experts). :func:`route_topk` still returns the dense
dispatch and combine tensors, for tests at small N. Nothing here reads a
value back to the host: C is a Python int from the static N, so a CUDA
graph captures the layer (the engine's decode, verify and prefill
programs).

As in the JAX package the expert products are plain products in the
compute dtype (no Pallas kernel there, none here); the combine takes the
gates in the compute dtype and sums a token's k expert rows in f32.

Under data parallelism the JAX step routes the global batch as one token
set: capacity from the global N, slot order over every rank's rows in
rank order, the losses over all of them. ``moe_ffn(dp_group=)`` does the
same across the data-parallel ranks of the group: each rank's slots start
after the earlier ranks' counts (one all-gather of E counts), capacity
counts every rank's tokens, and the aux terms are sums over the group
whose backward sums the cotangents too, so each rank's loss holds the
global aux and the data-parallel mean of the gradients is its gradient.
A rank's buffer holds ``min(C, N)`` slots an expert: one token reaches an
expert at most once, so that is every slot its own tokens can fill (at
factor 8.0 it halves the buffer and changes nothing).

Expert parallelism (``parallel/ep.py``): the rank holds ``E / ep``
consecutive experts and every rank of the ``ep`` group holds the same
tokens, as ranks of a ``tp`` group do. Each rank routes all tokens (the
router is replicated), runs its own experts on their slots, and the
partial outputs are summed over ``ep`` in f32 (the backward passes the
gradient through); the tokens and the gates enter the experts through an
identity whose backward sums their gradients over ``ep``, so the router
and everything before it see every expert's share on every rank.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

__all__ = ["Routing", "route_topk", "moe_ffn", "load_balancing_loss", "router_z_loss"]


class Routing(NamedTuple):
    dispatch: torch.Tensor  # (N, E, C) 0/1: token n to expert e at slot c
    combine: torch.Tensor  # (N, E, C) f32 gates for the way back
    aux_loss: torch.Tensor  # scalar load-balancing loss
    router_probs: torch.Tensor  # (N, E)


class _Assignments(NamedTuple):
    """The routing by index: each token's k choices in choice order."""

    expert: torch.Tensor  # (N, k) int64
    slot: torch.Tensor  # (N, k) int64, the position in the expert's queue
    kept: torch.Tensor  # (N, k) bool, within capacity
    gate: torch.Tensor  # (N, k) f32 renormalised gates, 0 where dropped
    probs: torch.Tensor  # (N, E) f32
    dispatch: torch.Tensor  # (N, E) f32, before capacity


def _route(router_logits: torch.Tensor, num_selected: int, capacity: int,
           jitter_key: Optional[torch.Generator] = None, dp_group=None) -> _Assignments:
    """``dp_group``: the rows are this rank's block of the data-parallel
    ranks' rows, whose queues come first in rank order. ``slot`` is then
    the position among this rank's tokens, and ``kept`` the global
    position's test against ``capacity``."""
    n, e = router_logits.shape
    if jitter_key is not None:
        router_logits = router_logits + 1e-2 * torch.randn(
            router_logits.shape, generator=jitter_key, device=router_logits.device)
    probs = torch.softmax(router_logits.float(), dim=-1)
    experts = torch.arange(e, device=probs.device)
    dispatch = torch.zeros_like(probs)
    gates = torch.zeros_like(probs)
    remaining = probs
    choices = []
    for _ in range(num_selected):
        choice = torch.argmax(remaining, dim=-1)
        # a comparison, not one_hot: one_hot checks its range on the host
        onehot = (choice[:, None] == experts[None, :]).float()
        dispatch = dispatch + onehot
        gates = gates + onehot * probs
        remaining = remaining * (1.0 - onehot)
        choices.append(choice)
    position = (torch.cumsum(dispatch, dim=0) - dispatch) * dispatch
    earlier = 0.0
    if dp_group is not None:
        import torch.distributed as dist

        counts = dispatch.sum(dim=0)
        every = counts.new_empty(dist.get_world_size(dp_group) * e)
        dist.all_gather_into_tensor(every, counts.contiguous(), group=dp_group)
        earlier = every.view(-1, e)[:dist.get_rank(dp_group)].sum(dim=0)
    within = (position + earlier < capacity).float() * dispatch
    gates = gates * within
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    expert = torch.stack(choices, dim=1)
    return _Assignments(expert, position.gather(1, expert).long(),
                        within.gather(1, expert) > 0, gates.gather(1, expert), probs, dispatch)


def route_topk(router_logits: torch.Tensor, num_selected: int, capacity: int, *,
               jitter_key: Optional[torch.Generator] = None) -> Routing:
    """Top-k token-to-expert assignment with per-expert capacity, as dense
    ``(N, E, C)`` dispatch and combine tensors (the JAX package's form; the
    FFN itself dispatches by index). ``router_logits``: (N, E).
    ``jitter_key``: a ``torch.Generator`` on the logits' device, whose
    normal draw times 1e-2 is added to the logits (the JAX key's role;
    the numbers differ from ``jax.random``'s)."""
    n, e = router_logits.shape
    a = _route(router_logits, num_selected, capacity, jitter_key)
    rows = torch.arange(n, device=a.probs.device)[:, None].expand_as(a.expert)
    slot = torch.where(a.kept, a.slot, capacity)  # a dropped choice lands past the buffer
    dispatch = torch.zeros((n, e, capacity + 1), dtype=torch.float32, device=a.probs.device)
    combine = torch.zeros_like(dispatch)
    dispatch[rows, a.expert, slot] = 1.0
    combine[rows, a.expert, slot] = a.gate
    return Routing(dispatch[..., :capacity], combine[..., :capacity],
                   load_balancing_loss(a.probs, a.dispatch), a.probs)


def router_z_loss(router_logits: torch.Tensor) -> torch.Tensor:
    """ST-MoE router z-loss: the mean of ``logsumexp(logits)²`` in f32."""
    z = torch.logsumexp(router_logits.float(), dim=-1)
    return torch.mean(torch.square(z))


def load_balancing_loss(router_probs: torch.Tensor, dispatch_mask: torch.Tensor) -> torch.Tensor:
    """Switch-Transformer aux loss: ``E * sum_e fraction_e * mean_prob_e``,
    least for a uniform assignment."""
    e = router_probs.shape[-1]
    fraction = torch.mean(dispatch_mask, dim=0)
    mean_prob = torch.mean(router_probs, dim=0)
    return e * torch.sum(fraction * mean_prob)


def expert_capacity(n: int, num_experts: int, num_selected: int, capacity_factor: float) -> int:
    """Slots per expert for ``n`` tokens: rounded up, and at least
    ``num_selected``, so a small decode batch routed evenly drops nothing."""
    return max(num_selected, math.ceil(capacity_factor * num_selected * n / num_experts))


def moe_ffn(x: torch.Tensor, router_kernel: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, *, num_selected: int = 2,
            capacity_factor: float = 1.25, compute_dtype=torch.bfloat16,
            aux_loss_coef: float = 1.0, router_z_loss_coef: float = 0.0, ep=None,
            dp_group=None) -> tuple:
    """SwiGLU expert FFN with top-k routing: ``(output (B, S, D) in the
    compute dtype, aux scalar)``. Shapes: x (B, S, D), router (D, E), the
    experts w_gate/w_up (E', D, I) and w_down (E', I, D), where E' is E, or
    under ``ep`` (an ``parallel.ep.ExpertParallel``: its group, size and
    this rank's index) the rank's ``E / ep.size`` experts from expert
    ``ep.rank * E'``. The aux is pre-scaled: ``aux_loss_coef *
    load_balance + router_z_loss_coef * z_loss``, each at face value.
    ``dp_group``: ``x`` is this rank's block of a batch split over the
    group's data-parallel ranks (every rank's of one shape), routed and
    its aux taken as one batch (see the module docstring)."""
    b, s, d = x.shape
    e = router_kernel.shape[1]
    e_local = w_gate.shape[0]
    n = b * s
    tokens = x.reshape(n, d)
    n_dp = 1
    if dp_group is not None:
        import torch.distributed as dist

        n_dp = dist.get_world_size(dp_group)
    capacity = expert_capacity(n * n_dp, e, num_selected, capacity_factor)
    router_logits = tokens.float() @ router_kernel.float()
    a = _route(router_logits, num_selected, capacity, dp_group=dp_group if n_dp > 1 else None)
    if n_dp > 1:
        from .collectives import all_reduce_, sum_over_group

        fraction = all_reduce_(a.dispatch.sum(dim=0), dp_group) / (n * n_dp)
        mean_prob = sum_over_group(a.probs.sum(dim=0), dp_group) / (n * n_dp)
        aux = aux_loss_coef * (e * torch.sum(fraction * mean_prob))
        if router_z_loss_coef:
            z = torch.logsumexp(router_logits.float(), dim=-1)
            aux = aux + router_z_loss_coef * (
                sum_over_group(torch.square(z).sum(), dp_group) / (n * n_dp))
    else:
        aux = aux_loss_coef * load_balancing_loss(a.probs, a.dispatch)
        if router_z_loss_coef:
            aux = aux + router_z_loss_coef * router_z_loss(router_logits)

    first = 0
    gate, expert_in = a.gate, tokens
    parallel = ep is not None and ep.size > 1
    if parallel:
        from .collectives import copy_to_group

        first = ep.rank * e_local
        expert_in, gate = copy_to_group(tokens, ep.group), copy_to_group(gate, ep.group)
    local = a.expert - first
    mine = a.kept & (local >= 0) & (local < e_local)
    slots = min(capacity, n)  # an expert takes at most one of a token's choices
    dummy = e_local * slots  # the row every dropped or other rank's choice lands on
    index = torch.where(mine, local * slots + a.slot, dummy).reshape(-1)
    src = expert_in.to(compute_dtype)[:, None, :].expand(n, num_selected, d).reshape(-1, d)
    buffer = torch.zeros((dummy + 1, d), dtype=compute_dtype, device=x.device).index_add(0, index, src)
    h = buffer[:dummy].view(e_local, slots, d)
    # a profiler range: a trace attributes the experts' kernels to it
    with torch.profiler.record_function("moe_experts"):
        g = torch.bmm(h, w_gate.to(compute_dtype))
        u = torch.bmm(h, w_up.to(compute_dtype))
        out = torch.bmm(torch.nn.functional.silu(g) * u, w_down.to(compute_dtype)).reshape(dummy, d)
    out = torch.cat([out, out.new_zeros((1, d))])
    rows = out.index_select(0, index).view(n, num_selected, d)
    y = (gate.to(compute_dtype).float()[..., None] * rows.float()).sum(dim=1)
    if parallel:
        from .collectives import reduce_from_group

        y = reduce_from_group(y, ep.group)
    return y.to(compute_dtype).reshape(b, s, d), aux
