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
(``InferenceServer(mode="continuous")``) with speculative decoding,
chunked prefill and the int8 pool; one-device Llama training through the
``Accelerator`` (``prepare``, ``prepare_data_loader``, ``train_step`` or the
eager ``backward`` loop) with the flash backward kernels; and big-model
inference on one device: ``init_empty_weights``, safetensors checkpoints
read and written without the ``safetensors`` package,
``load_checkpoint_in_model``, CPU and disk offload, and int8/int4/NF4
weight quantization (``quantize_model``, ``load_and_quantize_model``) with
the quantized matmul kernel. The serving engine's step programs run as
captured CUDA graphs; training has ``train_step(multi_step=True)``,
schedulers, the selective remat policies and the chunked cross entropy.
A training job resumes: the data path (torch ``DataLoader`` unwrapping,
sharded samplers, exact mid-epoch ``state_dict``, the native packer of
``csrc/packing.cpp``), atomic checkpoints with ``resume_from_latest``,
the ``check_step_health`` watchdog, trackers, and the HF Llama
converters. Data-parallel training across processes: DDP, FSDP2 and HSDP
under a ``ParallelismConfig``, the collectives, loaders and checkpoints
of several processes, ``notebook_launcher`` and ``python -m
accelerate_tpu_torch.commands.launch``; tensor parallelism (Megatron, a
sequence-parallel residual) alone and under FSDP2/HSDP, and big-model
loading over a mesh. Replication, the launch supervisor, the host KV
tier and the serving control plane are still to be ported (ROADMAP.md).
"""

__version__ = "0.1.0"

__all__ = [
    "AcceleratedScheduler",
    "Accelerator",
    "DistributedDataParallelKwargs",
    "FSDPPlugin",
    "ParallelismConfig",
    "ProjectConfiguration",
    "TensorParallelConfig",
    "TrainingHealthConfig",
    "ContinuousBatchingEngine",
    "InferenceServer",
    "LlamaConfig",
    "LlamaForCausalLM",
    "QuantizationConfig",
    "ServingConfig",
    "ServingResult",
    "create_llama",
    "debug_launcher",
    "find_executable_batch_size",
    "get_logger",
    "init_empty_weights",
    "init_llama_params",
    "llama_loss",
    "load_and_quantize_model",
    "notebook_launcher",
    "load_checkpoint_in_model",
    "quantize_model",
    "quantized_matmul",
    "release_memory",
    "skip_first_batches",
    "resolve_device",
    "set_seed",
    "synchronize_rng_states",
]

_LAZY = {
    "Accelerator": ("accelerator", "Accelerator"),
    "AcceleratedOptimizer": ("optimizer", "AcceleratedOptimizer"),
    "AcceleratedScheduler": ("scheduler", "AcceleratedScheduler"),
    "set_seed": ("utils.random", "set_seed"),
    "synchronize_rng_states": ("utils.random", "synchronize_rng_states"),
    "find_executable_batch_size": ("utils.memory", "find_executable_batch_size"),
    "release_memory": ("utils.memory", "release_memory"),
    "chunked_softmax_cross_entropy": ("ops.losses", "chunked_softmax_cross_entropy"),
    "AcceleratorState": ("state", "AcceleratorState"),
    "GradientState": ("state", "GradientState"),
    "PartialState": ("state", "PartialState"),
    "prepare_data_loader": ("data_loader", "prepare_data_loader"),
    "skip_first_batches": ("data_loader", "skip_first_batches"),
    "DataLoaderConfiguration": ("utils.dataclasses", "DataLoaderConfiguration"),
    "DistributedDataParallelKwargs": ("utils.dataclasses", "DistributedDataParallelKwargs"),
    "FSDPPlugin": ("utils.dataclasses", "FSDPPlugin"),
    "ParallelismConfig": ("parallelism_config", "ParallelismConfig"),
    "TensorParallelConfig": ("utils.dataclasses", "TensorParallelConfig"),
    "notebook_launcher": ("launchers", "notebook_launcher"),
    "debug_launcher": ("launchers", "debug_launcher"),
    "ProjectConfiguration": ("utils.dataclasses", "ProjectConfiguration"),
    "TrainingHealthConfig": ("utils.dataclasses", "TrainingHealthConfig"),
    "GeneralTracker": ("tracking", "GeneralTracker"),
    "wait_for_async_saves": ("checkpointing", "wait_for_async_saves"),
    "list_checkpoints": ("checkpointing", "list_checkpoints"),
    "verify_checkpoint": ("checkpointing", "verify_checkpoint"),
    "is_checkpoint_committed": ("checkpointing", "is_checkpoint_committed"),
    "CheckpointError": ("utils.fault", "CheckpointError"),
    "CheckpointNotFoundError": ("utils.fault", "CheckpointNotFoundError"),
    "CheckpointUncommittedError": ("utils.fault", "CheckpointUncommittedError"),
    "CheckpointCorruptError": ("utils.fault", "CheckpointCorruptError"),
    "CheckpointComponentMissingError": ("utils.fault", "CheckpointComponentMissingError"),
    "TrainingHealthError": ("utils.fault", "TrainingHealthError"),
    "install_preemption_handler": ("utils.fault", "install_preemption_handler"),
    "health_summary": ("telemetry", "health_summary"),
    "StepHealth": ("telemetry", "StepHealth"),
    "DeferredReadbackRing": ("telemetry", "DeferredReadbackRing"),
    "AsyncTrackerFlusher": ("telemetry", "AsyncTrackerFlusher"),
    "convert_hf_state_dict": ("models.llama", "convert_hf_state_dict"),
    "export_hf_state_dict": ("models.llama", "export_hf_state_dict"),
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
    "init_empty_weights": ("big_modeling", "init_empty_weights"),
    "abstract_params": ("big_modeling", "abstract_params"),
    "load_checkpoint_in_model": ("big_modeling", "load_checkpoint_in_model"),
    "load_checkpoint_and_dispatch": ("big_modeling", "load_checkpoint_and_dispatch"),
    "dispatch_model": ("big_modeling", "dispatch_model"),
    "cpu_offload": ("big_modeling", "cpu_offload"),
    "disk_offload": ("utils.offload", "disk_offload"),
    "get_max_memory": ("big_modeling", "get_max_memory"),
    "QuantizationConfig": ("utils.quantization", "QuantizationConfig"),
    "QuantizedLeaf": ("utils.quantization", "QuantizedLeaf"),
    "NF4Leaf": ("utils.quantization", "NF4Leaf"),
    "quantize_model": ("utils.quantization", "quantize_model"),
    "quantize_params": ("utils.quantization", "quantize_params"),
    "load_and_quantize_model": ("utils.quantization", "load_and_quantize_model"),
    "quantized_matmul": ("ops.quant_matmul", "quantized_matmul"),
    "save_sharded_safetensors": ("utils.serialization", "save_sharded_safetensors"),
    "load_sharded_safetensors": ("utils.serialization", "load_sharded_safetensors"),
}


def __getattr__(name):
    # lazy so `import accelerate_tpu_torch` does not import torch's model code
    if name in _LAZY:
        import importlib

        module_name, attr = _LAZY[name]
        module = importlib.import_module(f".{module_name}", __name__)
        return getattr(module, attr)
    raise AttributeError(f"module 'accelerate_tpu_torch' has no attribute {name!r}")
