"""Checkpoint file names (counterpart of ``accelerate_tpu/utils/constants.py``,
the part the port reads and writes): a checkpoint written by either package
keeps the same names, and ``save_state`` lays out its directory under them.

The atomic-commit protocol (``checkpointing.py``) stages a save into
``<dir>.tmp``, writes the ``COMMITTED`` manifest (per-file sizes and crc32)
and renames the staging directory to ``<dir>``; a same-name overwrite parks
the previous checkpoint at ``<dir>.old`` until the rename lands."""

MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
RNG_STATE_NAME = "random_states"
CUSTOM_STATE_PATTERN = "custom_checkpoint_{}"

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
SAFE_WEIGHTS_PATTERN_NAME = "model{suffix}.safetensors"

CHECKPOINT_DIR_PREFIX = "checkpoint"
CHECKPOINT_COMMITTED_MARKER = "COMMITTED"
CHECKPOINT_STAGING_SUFFIX = ".tmp"
CHECKPOINT_OLD_SUFFIX = ".old"

# the mesh's axes in their canonical order, and the joint (flattened)
# logical axes a batch is sharded and a loss averaged over (the JAX
# package's names, so a ParallelismConfig reads the same in both)
MESH_AXIS_ORDER = ("dp_replicate", "dp_shard", "pp", "cp", "sp", "tp", "ep")
JOINT_AXES = {
    "dp": ("dp_replicate", "dp_shard"),
    "dp_shard_cp": ("dp_shard", "cp"),
    "dp_cp": ("dp_replicate", "dp_shard", "cp"),
    "batch": ("dp_replicate", "dp_shard", "cp", "sp"),
    "fsdp": ("dp_shard", "cp"),
}
