"""Test helpers of the port: the self-launch helpers and the scripts they
run (counterpart of ``accelerate_tpu/test_utils``)."""
