"""Tensor parallelism (counterpart of ``accelerate_tpu/parallel/tp.py``).

The JAX package writes TP as ``(regex, PartitionSpec)`` rules over the
``tp`` mesh axis and lets XLA place Megatron's collectives. Here a rule is
``(regex, dim)``: the first rule whose regex is found in a leaf's path
(``layers/attn/q_proj/kernel``) says on which dim of the leaf, as the
checkpoint holds it (stacked ``(L, in, out)`` layer leaves), the leaf is
split over ``tp``; ``None`` replicates it. :func:`tensor_parallel_rules`
carries the JAX package's regexes with the dim of each of its specs:
column-parallel leaves (q/k/v, gate/up and their biases) split their
output dim, row-parallel ones (o_proj, down_proj) their input dim, the
embedding and the LM head their vocabulary dim.

:func:`apply_tensor_parallel` makes each split leaf a ``DTensor`` with a
``Shard(d)`` placement on the ``tp`` sub-mesh (every rank keeps its own
block of the whole tensor it holds, as FSDP2 keeps its shard: no
collective) and every other leaf a ``Replicate()`` one, and gives the model
a :class:`TensorParallel` handle, which its forward runs over
(``models/llama.py``): local head counts from the local weights, the
sequence-parallel residual, the vocabulary-parallel embedding and loss.
The forward has one plan; a rule that places a leaf elsewhere, or that
matches no parameter, raises by name. A module without a tensor-parallel
forward is replicated over ``tp`` (the JAX rules match none of its leaves)
and any rule given for it raises.

Under sequence parallelism a ``tp``-replicated parameter (every norm
scale) gets a partial gradient on each rank, from its block of the
sequence: the optimizer sums those over ``tp`` before anything reads them
(``optimizer.py``). On the path that keeps the residual whole (``tp`` does
not divide the sequence) each rank computes that gradient whole, and the
forward takes the parameter through ``grad_share`` so the same sum is
right.
"""

from __future__ import annotations

import functools
import re
from typing import Optional, Sequence

import torch
from torch import nn

__all__ = ["TensorParallel", "apply_tensor_parallel", "check_rules", "check_tp_divides",
           "plan_tensor_parallel", "tensor_parallel_plan", "tensor_parallel_rules"]


def tensor_parallel_rules(tp_axis: str = "tp", layer_axis: Optional[str] = None) -> list:
    """``(regex, dim)`` rules: the JAX package's regexes, each with the dim
    its ``PartitionSpec`` puts ``tp`` on. ``layer_axis="pp"`` (the stacked
    layer dim over pipeline stages) waits for ROADMAP.md A11."""
    if layer_axis is not None:
        raise NotImplementedError(f"layer_axis={layer_axis!r}: pipeline stages over the stacked "
                                  "layer dim wait for ROADMAP.md A11")
    if tp_axis != "tp":
        raise ValueError(f"tp_axis={tp_axis!r}: the port's meshes name the tensor-parallel dim 'tp'")
    return [
        # column parallel (the output dim of a stacked (L, in, out) kernel)
        (r"(q_proj|k_proj|v_proj|qkv|query|key|value|c_attn_[qkv])/kernel", 2),
        (r"(gate_proj|up_proj|wi|fc1|w1|w3|c_fc)/kernel", 2),
        # row parallel (the input dim)
        (r"(o_proj|out_proj|wo|fc2|w2|down_proj|c_proj)/kernel", 1),
        # column-parallel biases ride the split output dim
        (r"(q_proj|k_proj|v_proj|c_attn_[qkv]|c_fc)/bias", 1),
        # the vocabulary dim of the (V, D) table and the (D, V) head
        (r"(embed_tokens|wte|word_embeddings)/(embedding|weight)", 0),
        (r"lm_head/kernel", 1),
    ]


def check_rules(rules: Sequence) -> None:
    """Raise unless every rule is a ``(regex, dim)`` pair: a compilable
    pattern and an int or None."""
    for rule in rules:
        if not (isinstance(rule, (tuple, list)) and len(rule) == 2 and isinstance(rule[0], str)
                and (rule[1] is None or isinstance(rule[1], int))):
            raise TypeError(f"sharding rule {rule!r}: the port's rules are (regex, dim) pairs, dim "
                            "an int (the leaf's dim split over tp) or None (replicated)")
        try:
            re.compile(rule[0])
        except re.error as e:
            raise ValueError(f"sharding rule {rule!r}: {e}") from None


def _resolve(rules: Sequence, path: str):
    for i, (pattern, dim) in enumerate(rules):
        if re.search(pattern, path):
            return i, dim
    return None, None


def plan_tensor_parallel(leaves: dict, rules: Optional[Sequence] = None,
                         defaults: bool = True) -> dict:
    """``{path: dim or None}`` for a Llama's ``leaves`` (``{"/"-joined
    path: shape}``), which the tensor-parallel forward runs with one plan:
    each leaf where :func:`tensor_parallel_rules` puts it. ``defaults``:
    the user ``rules`` go in front of those, and a user rule that matches no
    leaf raises; else ``rules`` are the whole list (as the JAX package's
    ``dispatch_model`` takes them). Either way a rule that places a leaf
    elsewhere than the forward runs it raises by name."""
    return plan_by_rules(leaves, rules, tensor_parallel_rules(), "tp", defaults)


def plan_by_rules(leaves: dict, rules, forward: list, axis: str, defaults: bool = True) -> dict:
    """``{path: dim or None}``: where ``rules`` (in front of ``forward``,
    the forward's own rules, with ``defaults``) put each leaf over the mesh
    dim ``axis``; a rule that places a leaf elsewhere than ``forward`` does
    raises, and with ``defaults`` so does a user rule that matches none."""
    user = list(rules or [])
    check_rules(user)
    every = user + forward if defaults else user
    plan, used = {}, set()
    for path, shape in leaves.items():
        idx, dim = _resolve(every, path)
        if dim is not None and not -len(shape) <= dim < len(shape):
            raise ValueError(f"sharding rule {every[idx]!r} names dim {dim} of {path}, which has "
                             f"{len(shape)} dims")
        if dim is not None and dim < 0:
            dim += len(shape)
        want = _resolve(forward, path)[1]
        if idx is not None and idx < len(user):
            used.add(idx)
        if dim != want:
            rule = every[idx] if idx is not None else "no rule"
            where = "replicated" if want is None else f"split on dim {want}"
            raise ValueError(
                f"sharding rule {rule!r} puts {path} "
                f"{'replicated' if dim is None else f'on dim {dim}'} over {axis}; the "
                f"{_FORWARD_NAMES[axis]} forward runs it {where}")
        plan[path] = dim
    unused = [user[i] for i in range(len(user)) if i not in used]
    if defaults and unused:
        raise ValueError(f"sharding rule {unused[0]!r} matches no parameter")
    return plan


_FORWARD_NAMES = {"tp": "tensor-parallel", "ep": "expert-parallel"}


def check_tp_divides(config, n: int) -> None:
    """Raise unless ``n`` divides the dims the tensor-parallel forward
    splits: the query and key/value heads, the MLP width and the
    vocabulary (the JAX package takes any; ROADMAP.md A11 lists the gap)."""
    dims = {"num_attention_heads": config.num_attention_heads,
            "num_key_value_heads": config.num_key_value_heads,
            "intermediate_size": config.intermediate_size, "vocab_size": config.vocab_size}
    bad = {k: v for k, v in dims.items() if v % n}
    if bad:
        raise ValueError(f"tensor parallelism over {n} ranks splits {', '.join(bad)} "
                         f"({', '.join(str(v) for v in bad.values())}), which {n} does not divide "
                         "(ROADMAP.md A11: uneven splits are not ported)")


class TensorParallel:
    """The ``tp`` dim a model's forward runs over: its 1-D sub-mesh, process
    group, size and this rank's index along it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.group = mesh.get_group()
        self.size = mesh.size()
        self.rank = mesh.get_local_rank()

    def __repr__(self) -> str:
        return f"TensorParallel(size={self.size}, rank={self.rank})"


def _leaf_paths(model) -> dict:
    """``{parameter name: ("/"-joined checkpoint path, dim offset)}``: the
    offset is 1 for a per-layer parameter of a stacked leaf."""
    out = {}
    for key, fqns, stacked in model.checkpoint_fqns():
        for fqn in fqns:
            out[fqn] = (key.replace(".", "/"), 1 if stacked else 0)
    return out


def tensor_parallel_plan(model: nn.Module, size: int, rules: Optional[Sequence] = None,
                         defaults: bool = True) -> dict:
    """``{parameter name: (checkpoint key, layer index or None, dim or
    None)}`` of a model with a tensor-parallel forward over ``size`` ranks:
    the dim of the parameter (as it is registered: per-layer or stacked)
    split over ``tp``, None for a replicated one."""
    check_tp_divides(model.config, size)
    if getattr(model.config, "num_experts", 1) > 1:
        raise NotImplementedError(
            "MoE layers under tensor parallelism (tp on the experts' intermediate dim) are not "
            "ported yet (ROADMAP.md A11): lay an MoE model over ep and the data-parallel dims")
    return parameter_plan(model, functools.partial(plan_tensor_parallel, rules=rules,
                                                   defaults=defaults))


def parameter_plan(model: nn.Module, plan_leaves) -> dict:
    """``{parameter name: (checkpoint key, layer index or None, dim or
    None)}`` from ``plan_leaves({path: shape})`` (``{path: dim}`` on the
    stacked leaves), each dim moved to the parameter as it is registered."""
    paths = _leaf_paths(model)
    named = dict(model.named_parameters())
    leaves = {}
    for fqn, (path, offset) in paths.items():
        leaves.setdefault(path, (None,) * offset + tuple(named[fqn].shape))
    plan = plan_leaves(leaves)
    out = {}
    for fqn, (path, offset) in paths.items():
        layer = int(fqn.split(".")[1]) if offset else None
        dim = plan[path]
        out[fqn] = (path.replace("/", "."), layer, None if dim is None else dim - offset)
    return out


def apply_tensor_parallel(model: nn.Module, mesh, rules: Optional[Sequence] = None,
                          defaults: bool = True, source=None) -> list:
    """Lay ``model`` over the ``tp`` sub-mesh ``mesh``: each parameter the
    plan splits becomes a ``DTensor`` holding this rank's block
    (``Shard(d)``), every other a replicated one, and ``model.tp`` the
    :class:`TensorParallel` the forward runs over. The whole values come
    from the parameters (every rank holding the same), or from
    ``source(checkpoint key, layer index or None)`` (a host tensor: only the
    rank's block is copied, to ``mesh``'s device). Returns the replicated
    parameters (their gradients are summed over ``tp`` by the optimizer).
    A model without a tensor-parallel forward (no
    ``tensor_parallel_forward``) is left as it is: replicated over ``tp``;
    rules given for it raise."""
    tp = TensorParallel(mesh)
    if not getattr(model, "tensor_parallel_forward", False):
        if rules and defaults:
            raise ValueError(f"sharding rule {list(rules)[0]!r}: {type(model).__name__} has no "
                             "tensor-parallel forward (the Llama port has); it is replicated "
                             "over tp")
        return []
    replicated = lay_out(model, mesh, tensor_parallel_plan(model, tp.size, rules, defaults), source)
    model.tp = tp
    return replicated


def lay_out(model: nn.Module, mesh, plan: dict, source=None) -> list:
    """Make each parameter of ``plan`` (:func:`parameter_plan`) a
    ``DTensor`` on the 1-D ``mesh``: this rank's block where the plan
    splits it (``Shard(dim)``), else replicated; the whole values from the
    parameters or from ``source(checkpoint key, layer index or None)``.
    Returns the replicated parameters."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    size, rank = mesh.size(), mesh.get_local_rank()
    replicated = []
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    for fqn, (key, layer, dim) in plan.items():
        owner, _, name = fqn.rpartition(".")
        module = model.get_submodule(owner)
        p = getattr(module, name)
        whole = p.detach() if source is None else source(key, layer)
        local = whole if dim is None else whole.chunk(size, dim)[rank]
        if source is not None:  # a copy of the block alone, never a view of the source
            local = local.to(device=device, dtype=p.dtype, copy=True)
        elif dim is not None:  # a view would keep the whole tensor alive
            local = local.clone()
        placement = Replicate() if dim is None else Shard(dim)
        dt = DTensor.from_local(local.contiguous(), mesh, [placement], run_check=False)
        new = nn.Parameter(dt, requires_grad=p.requires_grad)
        setattr(module, name, new)
        if dim is None:
            replicated.append(new)
    return replicated
