"""Config dataclasses, the serving error taxonomy, checkpoint files,
model sizes, offload and weight quantization of the port."""
