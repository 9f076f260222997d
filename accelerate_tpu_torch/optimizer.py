"""Optimizer wrapper with gradient accumulation and loss scaling
(counterpart of ``accelerate_tpu/optimizer.py``).

The JAX package wraps an optax transformation over functional pytrees; here
:class:`AcceleratedOptimizer` wraps a ``torch.optim.Optimizer`` and the
gradients accumulate in each parameter's ``.grad``. The observable
semantics are the JAX package's: ``step`` runs only when
``GradientState.sync_gradients`` is set and, under fp16 loss scaling, skips
on non-finite gradients; ``zero_grad`` does nothing mid-accumulation;
``clip_grad_norm_`` scales by ``min(1, max_norm / (norm + 1e-6))`` over the
f32 global norm.

Under FSDP2 the gradients are ``DTensor`` shards: the norm is the
global one (each rank's local squares summed over the sharded mesh dims),
so every rank clips by the same factor, and the fp16 finite check is
agreed by every process; the returned norm is a plain tensor.

Under tensor parallelism with a sequence-parallel residual a parameter
replicated over ``tp`` (every norm scale) holds on each ``tp`` rank the
gradient of its block of the sequence: once an update, before anything
reads them, those are summed over ``tp`` (``tp_replicated``), while the
data-parallel mean stays FSDP2's. The norm then counts such a gradient
once (its placement is ``Replicate``) and sums the squares of split ones
over ``tp`` and ``dp_shard``.

``state_dict``/``load_state_dict`` round-trip the wrapped optimizer's
state (torch AdamW's moments and step counters), the update count and
the fp16 loss scale; a checkpoint (``checkpointing.py``) writes the
tensors through the safetensors writer and the rest as JSON.

``optax.adamw(lr, weight_decay=wd)`` maps to ``torch.optim.AdamW(lr,
betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)``: both decay decoupled, on
every parameter. Their default ``weight_decay`` differs (1e-4 against
1e-2), so pass it explicitly.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional

import torch

from .state import GradientState

__all__ = ["AcceleratedOptimizer", "DynamicScale", "clip_grads_by_norm", "global_grad_norm",
           "local_tensor"]


class DynamicScale:
    """fp16 dynamic loss scaling: the loss is multiplied by ``scale`` before
    the backward; a step with non-finite gradients is skipped and the scale
    multiplied by ``backoff_factor``; after ``growth_interval`` finite steps
    in a row it is multiplied by ``growth_factor``. The state lives on the
    host: skipping a step needs the finite check there anyway."""

    def __init__(self, init_scale: float = 2.0**16, growth_factor: float = 2.0,
                 backoff_factor: float = 0.5, growth_interval: int = 2000):
        self.growth_factor = growth_factor
        self.backoff_factor = backoff_factor
        self.growth_interval = growth_interval
        self.state = {"scale": float(init_scale), "good_steps": 0}

    @property
    def scale(self) -> float:
        return self.state["scale"]

    def unscale_(self, grads: List[torch.Tensor]) -> None:
        inv = 1.0 / self.state["scale"]
        for g in grads:
            local_tensor(g).mul_(inv)

    @staticmethod
    def grads_finite(grads: List[torch.Tensor]) -> bool:
        """One host readback for the whole gradient set; with several
        processes, every process's verdict together (one all-reduce)."""
        from .state import PartialState, process_layout

        local = [local_tensor(g) for g in grads]
        if process_layout()[1] == 1:
            return not local or bool(torch.stack([torch.isfinite(g).all() for g in local]).all().item())
        import torch.distributed as dist

        device = PartialState().device
        flag = torch.ones((), dtype=torch.int32, device=device)
        if local:
            flag = torch.stack([torch.isfinite(g).all() for g in local]).all().to(device, torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    def state_dict(self) -> dict:
        return {"scale": float(self.state["scale"]), "good_steps": int(self.state["good_steps"])}

    def load_state_dict(self, sd: dict) -> None:
        self.state = {"scale": float(sd["scale"]), "good_steps": int(sd["good_steps"])}

    def update(self, is_finite: bool) -> None:
        scale, good = self.state["scale"], self.state["good_steps"]
        if not is_finite:
            self.state = {"scale": scale * self.backoff_factor, "good_steps": 0}
        elif good + 1 >= self.growth_interval:
            self.state = {"scale": scale * self.growth_factor, "good_steps": 0}
        else:
            self.state = {"scale": scale, "good_steps": good + 1}


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a ``DTensor``, else ``t``."""
    return t.to_local() if _is_dtensor(t) else t


def _sharded_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The global L2 norm of gradients some of which are ``DTensor``
    shards: each shard's squares summed over the mesh dims it is sharded
    on (a replicated dim holds copies), then the plain ones added."""
    import torch.distributed as dist

    buckets: dict = {}
    for g in grads:
        if _is_dtensor(g):
            # a split dim: Shard, or FSDP2's strided shard of a dim tp splits too
            dims = tuple(i for i, pl in enumerate(g.placements)
                         if not (pl.is_replicate() or pl.is_partial()))
            key = (id(g.device_mesh), dims)
            mesh = g.device_mesh
            g = g.to_local()
        else:
            key, mesh, dims = None, None, ()
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square()
        entry = buckets.setdefault(key, [mesh, dims, torch.zeros_like(sq)])
        entry[2] = entry[2] + sq
    total = None
    for mesh, dims, sq in buckets.values():
        for d in dims:
            dist.all_reduce(sq, group=mesh.get_group(d))
        total = sq if total is None else total + sq
    return total.sqrt()


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every gradient, on the device, summed in f32 (or
    the gradients' wider dtype); over the whole of sharded ones."""
    if not grads:
        return torch.zeros(())
    if any(_is_dtensor(g) for g in grads):
        return _sharded_norm(grads)
    norms = [torch.linalg.vector_norm(g, dtype=torch.promote_types(g.dtype, torch.float32))
             for g in grads]
    dtype = functools.reduce(torch.promote_types, (n.dtype for n in norms))
    return torch.linalg.vector_norm(torch.stack([n.to(dtype) for n in norms]))


def clip_grads_by_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-6))``;
    returns the norm before clipping. No host readback."""
    norm = global_grad_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    for g in grads:
        local_tensor(g).mul_(factor.to(g.dtype))
    return norm


class AcceleratedOptimizer:
    """Wraps a ``torch.optim.Optimizer``.

    * ``accelerator.backward(...)`` accumulates into the parameters' ``.grad``;
    * :meth:`step` updates iff ``GradientState.sync_gradients`` (and, under
      fp16, the unscaled gradients are finite);
    * :meth:`zero_grad` drops the gradients once synced.
    """

    def __init__(self, optimizer: torch.optim.Optimizer, scaler: Optional[DynamicScale] = None):
        if isinstance(optimizer, AcceleratedOptimizer):
            raise ValueError("optimizer is already wrapped by AcceleratedOptimizer")
        if not isinstance(optimizer, torch.optim.Optimizer):
            raise TypeError(f"Expected a torch.optim.Optimizer, got {type(optimizer)}")
        self.optimizer = optimizer
        self.scaler = scaler
        self.gradient_state = GradientState()
        self.step_was_skipped = False
        self._step_count = 0
        self._unscaled = False
        self._last_grad_norm: Optional[torch.Tensor] = None
        # parameters left whole under FSDP2: their gradients are averaged
        # over the data-parallel groups (None: the world) once an update,
        # before any use
        self.replicated: List[torch.Tensor] = []
        self.dp_groups: list = [None]
        # parameters replicated over tp: their gradients are summed over
        # tp_group once an update
        self.tp_replicated: List[torch.Tensor] = []
        self.tp_group = None
        self._replicated_synced = False

    def params(self) -> List[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def grads(self) -> List[torch.Tensor]:
        self._sync_replicated()
        return [p.grad for p in self.params() if p.grad is not None]

    def _sync_replicated(self) -> None:
        """Sum the ``tp``-replicated parameters' gradients over ``tp`` and
        average the ones FSDP2 left whole over the data-parallel ranks,
        once per update and only on the step that updates."""
        if (not (self.replicated or self.tp_replicated) or self._replicated_synced
                or not self.gradient_state.sync_gradients):
            return
        import torch.distributed as dist

        for p in self.tp_replicated:
            if p.grad is not None:
                dist.all_reduce(local_tensor(p.grad), group=self.tp_group)
        for p in self.replicated:
            if p.grad is not None:
                g = local_tensor(p.grad)
                for group in self.dp_groups:
                    dist.all_reduce(g, group=group)
                g.div_(math.prod(dist.get_world_size(group) for group in self.dp_groups))
        self._replicated_synced = True

    def unscale_(self) -> None:
        """Divide the gradients by the loss scale, once per update."""
        if self.scaler is not None and not self._unscaled:
            self.scaler.unscale_(self.grads())
            self._unscaled = True

    def clip_grad_norm_(self, max_norm: float) -> torch.Tensor:
        grads = self.grads()
        if not grads:
            return torch.zeros(())
        self.unscale_()
        self._last_grad_norm = clip_grads_by_norm(grads, max_norm)
        return self._last_grad_norm

    def clip_grad_value_(self, clip_value: float) -> None:
        grads = self.grads()
        if not grads:
            return
        self.unscale_()
        for g in grads:
            local_tensor(g).clamp_(-clip_value, clip_value)

    def step(self, closure=None) -> None:
        if not self.gradient_state.sync_gradients or not self.grads():
            self.step_was_skipped = True
            self._unscaled = False
            return
        if self.scaler is not None:
            self.unscale_()
            finite = self.scaler.grads_finite(self.grads())
            self.scaler.update(finite)
            if not finite:
                self.step_was_skipped = True
                self.optimizer.zero_grad(set_to_none=True)
                self._unscaled = False
                self._replicated_synced = False
                return
        self.optimizer.step(closure)
        self._unscaled = False
        self._replicated_synced = False
        self._last_grad_norm = None
        self.step_was_skipped = False
        self._step_count += 1

    def zero_grad(self, set_to_none: bool = True) -> None:
        """A no-op mid-accumulation: the gradients are still being summed."""
        if self.gradient_state.sync_gradients:
            self.optimizer.zero_grad(set_to_none=set_to_none)
            self._unscaled = False
            self._replicated_synced = False
            self._last_grad_norm = None

    def state_dict(self) -> dict:
        sd = {"optimizer": self.optimizer.state_dict(), "step_count": self._step_count}
        if self.scaler is not None:
            sd["scaler"] = self.scaler.state_dict()
        return sd

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict` through torch's ``load_state_dict``
        (tensors already on their parameter's device and dtype are kept, not
        copied)."""
        inner = sd["optimizer"]
        # JSON holds tuples (AdamW's betas) as lists: take the live type back
        groups = [{k: tuple(v) if isinstance(group.get(k), tuple) else v for k, v in saved.items()}
                  for group, saved in zip(self.optimizer.param_groups, inner["param_groups"])]
        self.optimizer.load_state_dict({**inner, "param_groups": groups
                                        + inner["param_groups"][len(groups):]})
        self._step_count = sd.get("step_count", 0)
        if self.scaler is not None and "scaler" in sd:
            self.scaler.load_state_dict(sd["scaler"])

    def __repr__(self) -> str:
        return f"AcceleratedOptimizer({type(self.optimizer).__name__}, steps={self._step_count})"

