"""accelerate_tpu_torch — the PyTorch/CUDA port of ``accelerate_tpu``.

A second package beside the JAX one, written for an NVIDIA H100. It keeps
the JAX package's module names and tensor layouts at every public function
((B, S, H, D) attention, (num_blocks, block_size, kv_heads, head_dim) KV
pool, (L, ...) stacked layer parameters) so each function has a findable
counterpart and the parity tests compare like with like. Every Pallas
kernel on a ported path is a hand-written Hopper kernel (``csrc/*.cu``,
built with nvcc at first use) sitting beside a plain PyTorch version of
the same function; the plain version runs only for tensors on the CPU.

This package never imports ``jax`` or ``accelerate_tpu``. Entry points take
``device=`` and default to ``"cuda"``; they raise when no GPU is present.

Ported so far: Llama continuous-batching serving over a paged KV pool
(``InferenceServer(mode="continuous")``), and one-device Llama training
through the ``Accelerator`` (``prepare``, ``prepare_data_loader``,
``train_step`` or the eager ``backward`` loop) with the flash backward
kernels. Distributed training, speculative decoding, chunked prefill and
the serving control plane are still to be ported (ROADMAP.md).
"""

__version__ = "0.1.0"

__all__ = [
    "Accelerator",
    "ContinuousBatchingEngine",
    "InferenceServer",
    "LlamaConfig",
    "LlamaForCausalLM",
    "ServingConfig",
    "ServingResult",
    "create_llama",
    "get_logger",
    "init_llama_params",
    "llama_loss",
    "resolve_device",
]

_LAZY = {
    "Accelerator": ("accelerator", "Accelerator"),
    "AcceleratedOptimizer": ("optimizer", "AcceleratedOptimizer"),
    "AcceleratorState": ("state", "AcceleratorState"),
    "GradientState": ("state", "GradientState"),
    "PartialState": ("state", "PartialState"),
    "prepare_data_loader": ("data_loader", "prepare_data_loader"),
    "create_llama": ("models.llama", "create_llama"),
    "llama_loss": ("models.llama", "llama_loss"),
    "resolve_device": ("_device", "resolve_device"),
    "get_logger": ("logging", "get_logger"),
    "LlamaConfig": ("models.llama", "LlamaConfig"),
    "LlamaForCausalLM": ("models.llama", "LlamaForCausalLM"),
    "init_llama_params": ("models.llama", "init_llama_params"),
    "params_from_jax": ("models.llama", "params_from_jax"),
    "ContinuousBatchingEngine": ("engine", "ContinuousBatchingEngine"),
    "SlotOccupant": ("engine", "SlotOccupant"),
    "KVCacheBackend": ("kvcache", "KVCacheBackend"),
    "DenseKVBackend": ("kvcache", "DenseKVBackend"),
    "PagedKVBackend": ("kvcache", "PagedKVBackend"),
    "PagedBlockPool": ("kvcache", "PagedBlockPool"),
    "PagedKVLayout": ("kvcache", "PagedKVLayout"),
    "make_kv_backend": ("kvcache", "make_kv_backend"),
    "InferenceServer": ("serving", "InferenceServer"),
    "ServingResult": ("serving", "ServingResult"),
    "ServingMetrics": ("serving", "ServingMetrics"),
    "ServingConfig": ("utils.dataclasses", "ServingConfig"),
    "ServingError": ("utils.fault", "ServingError"),
    "EngineCapacityError": ("utils.fault", "EngineCapacityError"),
    "EngineInvariantError": ("utils.fault", "EngineInvariantError"),
}


def __getattr__(name):
    # lazy so `import accelerate_tpu_torch` does not import torch's model code
    if name in _LAZY:
        import importlib

        module_name, attr = _LAZY[name]
        module = importlib.import_module(f".{module_name}", __name__)
        return getattr(module, attr)
    raise AttributeError(f"module 'accelerate_tpu_torch' has no attribute {name!r}")
