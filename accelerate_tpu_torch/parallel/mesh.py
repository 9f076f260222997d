"""Device meshes (counterpart of ``accelerate_tpu/parallel/mesh.py``).

The JAX package lays its mesh over the TPU interconnect with
``mesh_utils``; here one process drives one card, and a mesh is
``torch.distributed.device_mesh.init_device_mesh`` over the world's ranks
in row-major order (the last dim varies fastest, so ``dp_shard`` groups are
neighbouring ranks, the ranks of one host). HSDP's mesh is the 2-D
``(dp_replicate, dp_shard)`` one: FSDP2 replicates over the first dim and
shards over the second.

Tensor parallelism lays every rank on the 3-D ``(dp_replicate, dp_shard,
tp)`` mesh, ``tp`` innermost (a ``tp`` group is neighbouring ranks on one
host's NVLink), size-1 dims kept; a parameter's ``tp`` shard lives on the
``tp`` sub-mesh and FSDP2 shards over the ``dp_shard`` sub-mesh (or HSDP's
``(dp_replicate, dp_shard)``) of the same root (:func:`sub_mesh`). Expert
parallelism lays its ranks the same way on ``(dp_replicate, dp_shard,
ep)``, ``ep`` innermost.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from ..utils.constants import MESH_AXIS_ORDER

__all__ = ["build_hybrid_mesh", "build_mesh", "canonical_axis_sizes", "model_mesh_dims", "sub_mesh",
           "tp_mesh_dims"]

TP_MESH_DIMS = ("dp_replicate", "dp_shard", "tp")


def tp_mesh_dims() -> tuple:
    """The dims of a tensor-parallel layout's mesh, in ``MESH_AXIS_ORDER``."""
    return model_mesh_dims("tp")


def model_mesh_dims(dim: str) -> tuple:
    """The dims of a layout whose model is split over ``dim`` (``"tp"`` or
    ``"ep"``) besides the data-parallel dims, in ``MESH_AXIS_ORDER``."""
    return tuple(n for n in MESH_AXIS_ORDER if n in ("dp_replicate", "dp_shard", dim))


def build_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str],
               device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``axis_sizes`` named ``axis_names`` over every
    rank of the process group (whose size must be their product), on
    ``device_type`` (default: the state's device)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..state import PartialState

    state = PartialState()
    state.ensure_process_group()
    total = math.prod(axis_sizes)
    if total != dist.get_world_size():
        raise ValueError(f"Mesh axis sizes {tuple(axis_sizes)} (product {total}) do not match "
                         f"the world size {dist.get_world_size()}")
    return init_device_mesh(device_type or state.device.type, tuple(int(s) for s in axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def build_hybrid_mesh(dcn_axis_sizes: Sequence[int], ici_axis_sizes: Sequence[int],
                      axis_names: Sequence[str], device_type: Optional[str] = None):
    """A mesh whose axis ``i`` has ``dcn_axis_sizes[i] * ici_axis_sizes[i]``
    ranks, the across-host (DCN) part outermost: ranks are laid out host by
    host, so an axis of ``ici`` size stays on one host. HSDP's is
    ``((dp_replicate, 1), (1, dp_shard), ("dp_replicate", "dp_shard"))``:
    replicas across hosts, shards within one."""
    sizes = [d * i for d, i in zip(dcn_axis_sizes, ici_axis_sizes)]
    return build_mesh(sizes, axis_names, device_type)


def canonical_axis_sizes(sizes: dict) -> tuple:
    """``{axis: size}`` as (sizes, names) in the canonical order, size-1
    axes kept."""
    names = tuple(MESH_AXIS_ORDER)
    return tuple(int(sizes.get(n, 1)) for n in names), names


def sub_mesh(mesh, names):
    """The sub-mesh of ``mesh`` over the dims ``names`` (a name or a tuple,
    in the mesh's order): its ranks are this rank's neighbours along those
    dims."""
    names = (names,) if isinstance(names, str) else tuple(names)
    missing = [n for n in names if n not in (mesh.mesh_dim_names or ())]
    if missing:
        raise ValueError(f"the mesh {mesh.mesh_dim_names} has no dim {missing[0]!r}")
    return mesh[names[0]] if len(names) == 1 else mesh[names]
