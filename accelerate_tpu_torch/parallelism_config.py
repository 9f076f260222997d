"""N-D parallelism configuration (counterpart of
``accelerate_tpu/parallelism_config.py``).

The same named dims (``dp_replicate``, ``dp_shard``, ``pp``, ``cp``, ``sp``,
``tp``, ``ep``), the same size inference (``dp_shard_size=-1`` or
``dp_replicate_size=-1`` takes what the others leave of the world), the same
validation and the same ``PARALLELISM_CONFIG_*`` environment protocol, so one
configuration reads the same in both packages. Here a device is a process:
one process drives one card (or, with ``cpu=True``, one CPU rank), so the
total a configuration must match is the world size.

The data-parallel dims run: ``dp_replicate`` as DDP, ``dp_shard`` as FSDP2
(``fully_shard``), both as HSDP. ``tp`` runs Megatron tensor parallelism
with a sequence-parallel residual (``parallel/tp.py``), alone or under
FSDP2 and HSDP, on the ``(dp_replicate, dp_shard, tp)`` mesh with ``tp``
innermost: one ``tp`` group is neighbouring ranks, the cards of one host.
``ep`` runs expert parallelism for MoE models (``parallel/ep.py``), alone
or under FSDP2 and HSDP, on the ``(dp_replicate, dp_shard, ep)`` mesh with
``ep`` innermost; ``ep`` with ``tp`` (MoE under tensor parallelism) waits
for ROADMAP.md A11. ``cp``, ``sp`` and ``pp`` above 1 wait for ROADMAP.md
A11. The configuration itself accepts them (its arithmetic is the JAX
package's); building their mesh raises.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional

from .utils.constants import JOINT_AXES, MESH_AXIS_ORDER

__all__ = ["ParallelismConfig"]

_ENV_PREFIX = "PARALLELISM_CONFIG_"
_AXIS_TO_FIELD = {
    "dp_replicate": "dp_replicate_size",
    "dp_shard": "dp_shard_size",
    "pp": "pp_size",
    "cp": "cp_size",
    "sp": "sp_size",
    "tp": "tp_size",
    "ep": "ep_size",
}
# the dims whose mesh is not ported yet, and the queue item that owns each
QUEUED_DIMS = {"cp": "A11", "sp": "A11", "pp": "A11"}


def refuse_queued_dims(sizes: dict) -> None:
    """Raise for a dim above 1 whose parallelism is not ported yet, and for
    ``ep`` beside ``tp`` (MoE under tensor parallelism)."""
    for axis, item in QUEUED_DIMS.items():
        if sizes.get(axis, 1) > 1:
            raise NotImplementedError(
                f"{_AXIS_TO_FIELD[axis]}={sizes[axis]}: {axis} parallelism is not ported yet "
                f"(ROADMAP.md {item}); the port runs dp_replicate (DDP), dp_shard (FSDP2), "
                "both (HSDP), tp (tensor parallelism) and ep (expert parallelism), tp or ep "
                "alone or with them")
    if sizes.get("ep", 1) > 1 and sizes.get("tp", 1) > 1:
        raise NotImplementedError(
            f"ep_size={sizes['ep']} with tp_size={sizes['tp']}: MoE under tensor parallelism "
            "is not ported yet (ROADMAP.md A11); use ep with the data-parallel dims")


@dataclass
class ParallelismConfig:
    """Sizes for each mesh dim; ``-1`` on ``dp_shard`` or ``dp_replicate``
    takes the world size left by the others.

    * ``dp_replicate``: data-parallel replicas (DDP).
    * ``dp_shard``: parameter, gradient and optimizer-state sharding (FSDP2).
    * ``tp``: Megatron tensor parallelism with a sequence-parallel
      residual; ``tp_config`` (a ``TensorParallelConfig``) adds sharding
      rules and, at ``tp_size=1``, forces the layout (a one-rank ``tp``).
    * ``ep``: expert parallelism of an MoE model (each rank holds
      ``num_experts / ep_size`` experts), not beside ``tp``.
    * ``pp``, ``cp``, ``sp``: pipeline, context and sequence parallelism
      (not ported yet: their mesh raises).
    """

    dp_replicate_size: int = 1
    dp_shard_size: int = 1
    pp_size: int = 1
    cp_size: int = 1
    sp_size: int = 1
    tp_size: int = 1
    ep_size: int = 1
    cp_config: Optional[object] = None
    tp_config: Optional[object] = None
    pp_config: Optional[object] = None
    allow_cp_with_sp: bool = False
    # the JAX package places dp_replicate across TPU slices with it; one
    # process per card has no slices, and HSDP's 2-D mesh is always built
    hybrid_dcn_replicate: bool = False
    _total_devices: Optional[int] = field(default=None, repr=False)

    # ------------------------------------------------------------ properties
    @property
    def axis_sizes(self) -> dict:
        return {axis: getattr(self, name) for axis, name in _AXIS_TO_FIELD.items()}

    @property
    def dp_dim_names(self) -> tuple:
        """Dims a data batch is sharded over."""
        return tuple(n for n in JOINT_AXES["dp"] if self.axis_sizes[n] > 1)

    @property
    def fsdp_dim_names(self) -> tuple:
        """Dims parameters are sharded over."""
        return tuple(n for n in JOINT_AXES["fsdp"] if self.axis_sizes[n] > 1)

    @property
    def loss_dim_names(self) -> tuple:
        """Dims a scalar loss is averaged over."""
        return tuple(n for n in JOINT_AXES["dp_cp"] if self.axis_sizes[n] > 1)

    @property
    def batch_dim_names(self) -> tuple:
        return tuple(n for n in ("dp_replicate", "dp_shard") if self.axis_sizes[n] > 1)

    @property
    def seq_dim_names(self) -> tuple:
        return tuple(n for n in ("cp", "sp") if self.axis_sizes[n] > 1)

    @property
    def dcn_axis_names(self) -> tuple:
        if self.hybrid_dcn_replicate and self.dp_replicate_size > 1:
            return ("dp_replicate",)
        return ()

    @property
    def data_parallel_size(self) -> int:
        return self.dp_replicate_size * self.dp_shard_size

    @property
    def non_data_parallel_size(self) -> int:
        return self.pp_size * self.cp_size * self.sp_size * self.tp_size * self.ep_size

    @property
    def total_size(self) -> int:
        return self.data_parallel_size * self.non_data_parallel_size

    @property
    def dp_enabled(self) -> bool:
        return self.data_parallel_size > 1

    @property
    def fsdp_enabled(self) -> bool:
        return self.dp_shard_size > 1

    @property
    def hsdp_enabled(self) -> bool:
        return self.dp_replicate_size > 1 and self.dp_shard_size > 1

    @property
    def tp_enabled(self) -> bool:
        return self.tp_size > 1

    @property
    def cp_enabled(self) -> bool:
        return self.cp_size > 1

    @property
    def sp_enabled(self) -> bool:
        return self.sp_size > 1

    @property
    def pp_enabled(self) -> bool:
        return self.pp_size > 1

    @property
    def ep_enabled(self) -> bool:
        return self.ep_size > 1

    @property
    def active_mesh_dims(self) -> tuple:
        return tuple(n for n in MESH_AXIS_ORDER if self.axis_sizes[n] > 1)

    # ------------------------------------------------------------ validation
    def _infer_and_validate(self, total_devices: int) -> None:
        sizes = self.axis_sizes
        inferable = ("dp_shard", "dp_replicate")
        for axis, size in sizes.items():
            if axis in inferable and size == -1:
                continue
            if size < 1:
                raise ValueError(f"{axis} size must be >= 1, got {size}")
        if self.dp_shard_size == -1 and self.dp_replicate_size == -1:
            raise ValueError("only one of dp_shard/dp_replicate may be -1 (inferred)")
        for axis in inferable:
            if sizes[axis] != -1:
                continue
            rest = math.prod(s for a, s in self.axis_sizes.items() if a != axis)
            if total_devices % rest != 0:
                raise ValueError(
                    f"Cannot infer {axis}: {total_devices} devices not divisible by "
                    f"product of other axes {rest}")
            setattr(self, f"{axis}_size", total_devices // rest)
        if self.cp_enabled and self.sp_enabled and not self.allow_cp_with_sp:
            raise ValueError(
                "cp_size>1 and sp_size>1 are mutually exclusive by default; pass "
                "allow_cp_with_sp=True to compose them on one mesh.")
        if self.total_size != total_devices:
            raise ValueError(
                f"ParallelismConfig total size {self.total_size} ({self.axis_sizes}) != "
                f"available devices {total_devices}")
        self._total_devices = total_devices

    # ------------------------------------------------------------ construction
    @classmethod
    def from_env(cls, total_devices: Optional[int] = None) -> "ParallelismConfig":
        """Read the ``PARALLELISM_CONFIG_*`` variables the launcher sets; with
        none set and ``total_devices`` given, data parallel over every device
        (``dp_replicate``, DDP)."""
        kwargs = {}
        for axis, name in _AXIS_TO_FIELD.items():
            key = f"{_ENV_PREFIX}{axis.upper()}_SIZE"
            if key in os.environ:
                kwargs[name] = int(os.environ[key])
        pp_keys = {"PP_MICROBATCHES": ("num_microbatches", int), "PP_SCHEDULE": ("schedule", str),
                   "PP_VIRTUAL_STAGES": ("num_virtual_stages", int)}
        if int(kwargs.get("pp_size", 1)) > 1 and any(f"{_ENV_PREFIX}{k}" in os.environ
                                                     for k in pp_keys):
            from .utils.dataclasses import PipelineParallelConfig

            kwargs["pp_config"] = PipelineParallelConfig(**{
                field_name: cast(os.environ[f"{_ENV_PREFIX}{k}"])
                for k, (field_name, cast) in pp_keys.items() if f"{_ENV_PREFIX}{k}" in os.environ})
        if not kwargs and total_devices is not None:
            kwargs["dp_replicate_size"] = total_devices
        cfg = cls(**kwargs)
        if total_devices is not None:
            cfg._infer_and_validate(total_devices)
        return cfg

    @property
    def tp_layout(self) -> bool:
        """Whether the model is laid out over ``tp``: ``tp_size > 1``, or a
        ``tp_config`` given at ``tp_size=1``."""
        return self.tp_size > 1 or self.tp_config is not None

    @property
    def model_dim(self) -> Optional[str]:
        """The dim a model is split over besides the data-parallel ones:
        ``"tp"`` under :attr:`tp_layout`, ``"ep"`` with ``ep_size > 1``,
        else None."""
        if self.tp_layout:
            return "tp"
        return "ep" if self.ep_enabled else None

    def build_device_mesh(self, device_type: Optional[str] = None):
        """A ``torch.distributed.device_mesh.DeviceMesh`` over the active dims
        in canonical order (``init_device_mesh``), on the state's device
        type; a configuration with no dim above 1 gets a one-rank
        ``("dp_shard",)`` mesh. Under tensor or expert parallelism the mesh
        is always the 3-D ``(dp_replicate, dp_shard, tp)`` or
        ``(dp_replicate, dp_shard, ep)``, size-1 dims kept, so FSDP2 and
        HSDP take their sub-mesh of it. Needs the process group (the state
        starts it); a dim that is not ported yet raises."""
        from .parallel.mesh import build_mesh, model_mesh_dims
        from .state import PartialState

        state = PartialState()
        self._infer_and_validate(self._total_devices or state.num_processes)
        refuse_queued_dims(self.axis_sizes)
        names = (model_mesh_dims(self.model_dim) if self.model_dim
                 else (self.active_mesh_dims or ("dp_shard",)))
        return build_mesh([self.axis_sizes[n] for n in names], names,
                          device_type=device_type or state.device.type)

    def get_device_mesh(self, device_type: Optional[str] = None):
        return self.build_device_mesh(device_type)

    def to_json(self) -> dict:
        return dict(self.axis_sizes)

    def __repr__(self) -> str:
        active = ", ".join(f"{a}={s}" for a, s in self.axis_sizes.items() if s != 1)
        return f"ParallelismConfig({active or 'single-device'})"
