"""Checkpoint file names (counterpart of ``accelerate_tpu/utils/constants.py``,
the part the port reads and writes): a checkpoint written by either package
loads into the other."""

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
SAFE_WEIGHTS_PATTERN_NAME = "model{suffix}.safetensors"
