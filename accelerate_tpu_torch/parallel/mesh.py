"""Device meshes (counterpart of ``accelerate_tpu/parallel/mesh.py``).

The JAX package lays its mesh over the TPU interconnect with
``mesh_utils``; here one process drives one card, and a mesh is
``torch.distributed.device_mesh.init_device_mesh`` over the world's ranks
in row-major order (the last dim varies fastest, so ``dp_shard`` groups are
neighbouring ranks, the ranks of one host). HSDP's mesh is the 2-D
``(dp_replicate, dp_shard)`` one: FSDP2 replicates over the first dim and
shards over the second.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

from ..utils.constants import MESH_AXIS_ORDER

__all__ = ["build_hybrid_mesh", "build_mesh", "canonical_axis_sizes"]


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
