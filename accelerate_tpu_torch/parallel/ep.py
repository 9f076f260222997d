"""Expert parallelism (counterpart of ``accelerate_tpu/parallel/ep.py``).

The JAX package writes EP as ``PartitionSpec`` rules that put the expert
dim of the stacked ``(L, E, in, out)`` expert leaves over the ``ep`` mesh
axis, and XLA lowers the dispatch einsums to all-to-alls. Here a rule is
``(regex, dim)``, as in ``parallel/tp.py``: :func:`expert_parallel_rules`
splits the expert leaves on dim 1 (E) and keeps the router replicated.

:func:`apply_expert_parallel` makes each expert leaf a ``DTensor`` holding
this rank's ``E / ep`` consecutive experts (``Shard`` on its expert dim)
on the ``ep`` sub-mesh, every other leaf a replicated one, and gives the
model an :class:`ExpertParallel` handle. Every rank of an ``ep`` group
holds the same tokens (the batch is sharded over the data-parallel dims
only, as under ``tp``): each routes all of them, runs its own experts, and
the partial outputs are summed over ``ep`` (``ops/moe.py``), so the
gradient of every replicated leaf is whole on each rank and only the
expert leaves' differ. The data-parallel reductions (DDP's or FSDP2's)
then run over the ranks of one ``ep`` index, as FSDP2 composes with a
``DTensor`` on another dim of the mesh.

MoE under ``tp`` (the JAX rules put ``tp`` on the experts' intermediate
dim) and the stacked layer dim over ``pp`` wait for ROADMAP.md A11.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

from torch import nn

from .tp import TensorParallel, lay_out, parameter_plan, plan_by_rules

__all__ = ["ExpertParallel", "apply_expert_parallel", "check_ep_divides",
           "expert_parallel_plan", "expert_parallel_rules", "plan_expert_parallel"]


def expert_parallel_rules(ep_axis: str = "ep", tp_axis: str = "tp",
                          layer_axis: Optional[str] = None) -> list:
    """``(regex, dim)`` rules: the JAX package's regexes, the expert leaves
    split on their expert dim (1 of a stacked ``(L, E, in, out)`` leaf),
    the router replicated. ``tp_axis`` names the dim the JAX rules put on
    the experts' intermediate dim; MoE under ``tp`` and ``layer_axis="pp"``
    wait for ROADMAP.md A11."""
    if layer_axis is not None:
        raise NotImplementedError(f"layer_axis={layer_axis!r}: pipeline stages over the stacked "
                                  "layer dim wait for ROADMAP.md A11")
    if ep_axis != "ep" or tp_axis != "tp":
        raise ValueError(f"ep_axis={ep_axis!r}, tp_axis={tp_axis!r}: the port's meshes name these "
                         "dims 'ep' and 'tp'")
    return [
        (r"experts/(w_gate|w_up)$", 1),
        (r"experts/w_down$", 1),
        (r"router/kernel$", None),
    ]


def plan_expert_parallel(leaves: dict, rules: Optional[Sequence] = None,
                         defaults: bool = True) -> dict:
    """``{path: dim or None}`` for a Llama's ``leaves`` (``{"/"-joined
    path: shape}``): the expert leaves on their expert dim, everything else
    replicated, the expert-parallel forward's one plan. ``rules`` and
    ``defaults`` as in ``parallel.tp.plan_tensor_parallel``."""
    return plan_by_rules(leaves, rules, expert_parallel_rules(), "ep", defaults)


def check_ep_divides(config, n: int) -> None:
    """Raise unless ``n`` divides the experts (each rank holds as many)."""
    if getattr(config, "num_experts", 1) <= 1:
        raise ValueError("expert parallelism needs an MoE model (num_experts > 1); this one has "
                         "no experts to split over ep")
    if config.num_experts % n:
        raise ValueError(f"expert parallelism over {n} ranks splits num_experts "
                         f"({config.num_experts}), which {n} does not divide")


class ExpertParallel(TensorParallel):
    """The ``ep`` dim an MoE forward runs over: its 1-D sub-mesh, process
    group, size and this rank's index along it."""

    def __repr__(self) -> str:
        return f"ExpertParallel(size={self.size}, rank={self.rank})"


def expert_parallel_plan(model: nn.Module, size: int, rules: Optional[Sequence] = None,
                         defaults: bool = True) -> dict:
    """``{parameter name: (checkpoint key, layer index or None, dim or
    None)}`` of an MoE Llama over ``size`` ``ep`` ranks: the dim of the
    parameter (as it is registered) split over ``ep``, None for a
    replicated one."""
    check_ep_divides(model.config, size)
    return parameter_plan(model, functools.partial(plan_expert_parallel, rules=rules,
                                                   defaults=defaults))


def apply_expert_parallel(model: nn.Module, mesh, rules: Optional[Sequence] = None,
                          defaults: bool = True, source=None) -> list:
    """Lay an MoE ``model`` over the ``ep`` sub-mesh ``mesh``: each expert
    leaf a ``DTensor`` of this rank's experts, every other leaf a
    replicated one, and ``model.ep`` the :class:`ExpertParallel` its
    forward runs over. The whole values come from the parameters (every
    rank holding the same) or from ``source(checkpoint key, layer index or
    None)``, of which only the rank's experts are copied. Returns the
    replicated parameters (their gradients are whole on every rank: no sum
    over ``ep``)."""
    if not getattr(model, "tensor_parallel_forward", False):
        raise ValueError(f"{type(model).__name__} has no expert-parallel forward (the Llama "
                         "port's MoE layers have)")
    ep = ExpertParallel(mesh)
    replicated = lay_out(model, mesh, expert_parallel_plan(model, ep.size, rules, defaults), source)
    model.ep = ep
    return replicated
