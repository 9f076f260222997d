"""Import hygiene and device discipline of the PyTorch port.

* Importing every ``accelerate_tpu_torch`` module and ``chip_smoke`` must
  not import ``jax``, the JAX package ``accelerate_tpu`` or ``safetensors``
  (the card's machine has none of them; the port reads and writes the
  format itself); checked in a fresh interpreter.
* Entry points default to the card and raise when it is absent: nothing
  carries on silently on the CPU.
* Kernel wrappers given a tensor that is not on the CPU either launch the
  kernel or raise; they never fall back to the plain version. Meta tensors
  stand in for CUDA ones here: they reach the kernel path and must be
  refused, in the forward and in the backward.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from accelerate_tpu_torch._device import resolve_device
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_reference,
    flash_attention_with_lse,
)
from accelerate_tpu_torch.ops.paged_decode import fused_sample, paged_flash_decode

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
before = set(sys.modules)
import accelerate_tpu_torch
names = ["accelerate_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(accelerate_tpu_torch.__path__, "accelerate_tpu_torch.")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
new = sorted(set(sys.modules) - before)
print(json.dumps({"modules": names, "new": new}))
"""


def test_port_and_chip_smoke_import_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("engine", "serving", "state", "optimizer", "accelerator", "data_loader", "model",
                 "big_modeling", "ops.quant_matmul", "utils.quantization", "utils.serialization",
                 "utils.modeling", "utils.offload", "utils.constants", "checkpointing", "telemetry",
                 "tracking", "logging", "scheduler", "utils.native", "utils.fault", "utils.random",
                 "utils.dataclasses", "models.llama", "parallelism_config", "parallel.mesh",
                 "parallel.sharding", "ops.collectives", "ops.operations", "launchers",
                 "commands.launch", "test_utils.testing", "test_utils.scripts.test_script",
                 "parallel.tp", "test_utils.scripts.train_timing", "inference", "elastic",
                 "test_utils.training", "test_utils.scripts.crash_resume_script",
                 "test_utils.scripts.preemption_script", "test_utils.scripts.elastic_recovery_script",
                 "test_utils.scripts.fault_save_script", "test_utils.scripts.serve_timing",
                 "kvtransfer", "test_utils.scripts.disagg_timing"):
        assert f"accelerate_tpu_torch.{name}" in report["modules"]
    leaked = [m for m in report["new"]
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "accelerate_tpu" or m.startswith("accelerate_tpu.")
              or m == "safetensors" or m.startswith("safetensors.")]
    assert leaked == []


def test_no_silent_cpu_fallback_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="cuda"):
        LlamaForCausalLM.from_seed(LlamaConfig.tiny())  # default device is the card
    assert resolve_device("cpu") == torch.device("cpu")


def test_engine_and_server_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    from accelerate_tpu_torch.engine import ContinuousBatchingEngine
    from accelerate_tpu_torch.serving import InferenceServer

    model = LlamaForCausalLM.from_seed(LlamaConfig.tiny(compute_dtype=torch.float32), device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatchingEngine(model)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceServer(model)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


FLASH_REFUSALS = {
    "wrong_dtype": (lambda: (_meta(1, 8, 4, 64, dtype=torch.float16),) * 3, {}, TypeError),
    "mixed_dtype": (lambda: (_meta(1, 8, 4, 64), _meta(1, 8, 4, 64, dtype=torch.float32),
                             _meta(1, 8, 4, 64)), {}, TypeError),
    "non_contiguous": (lambda: (_meta(1, 4, 8, 64).transpose(1, 2),) * 3, {}, ValueError),
    "head_dim_96": (lambda: (_meta(1, 8, 4, 96),) * 3, {}, ValueError),
    "not_cuda": (lambda: (_meta(1, 8, 4, 64),) * 3, {}, ValueError),
    "segment_ids": (lambda: (_meta(1, 8, 4, 64),) * 3,
                    {"segment_ids": torch.zeros(1, 7, dtype=torch.int32, device="meta")}, ValueError),
}


@pytest.mark.parametrize("case", sorted(FLASH_REFUSALS))
def test_flash_wrapper_refuses_instead_of_falling_back(case):
    make, kw, exc = FLASH_REFUSALS[case]
    with pytest.raises(exc):
        flash_attention(*make(), **kw)


def test_flash_wrapper_refuses_requires_grad():
    # inputs that require grad: on the CPU the gradients flow through the
    # plain backward and match autograd through the plain forward (f32
    # recompute vs autograd, 1e-5); on another device the kernel path is
    # taken and refused, never the plain one
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(1, 8, 4, 16)), dtype=torch.float32, requires_grad=True)
               for _ in range(3))
    out, lse = flash_attention_with_lse(q, k, v)
    grads = torch.autograd.grad(out.square().sum() + lse.sum(), (q, k, v))
    ref_out, ref_lse = flash_attention_reference(q, k, v)
    ref = torch.autograd.grad(ref_out.square().sum() + ref_lse.sum(), (q, k, v))
    for g, r in zip(grads, ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5)
    qm = _meta(1, 8, 4, 64).requires_grad_()
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_with_lse(qm, _meta(1, 8, 4, 64), _meta(1, 8, 4, 64))


def test_flash_wrapper_honours_segment_ids_on_cpu():
    # two packed documents in one row give each document's own attention
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=(1, 10, 4, 16)), dtype=torch.float32) for _ in range(3))
    seg = torch.tensor([[0] * 4 + [1] * 6], dtype=torch.int32)
    packed = flash_attention(q, k, v, segment_ids=seg)
    first = flash_attention(q[:, :4], k[:, :4], v[:, :4])
    second = flash_attention(q[:, 4:], k[:, 4:], v[:, 4:])
    torch.testing.assert_close(packed, torch.cat([first, second], dim=1), atol=1e-6, rtol=1e-6)


def test_accelerator_needs_the_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a GPU")
    from accelerate_tpu_torch.accelerator import Accelerator
    from accelerate_tpu_torch.state import AcceleratorState, GradientState

    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    try:
        with pytest.raises(RuntimeError, match="cuda"):
            Accelerator()
        AcceleratorState._reset_state(reset_partial_state=True)
        assert Accelerator(cpu=True).device == torch.device("cpu")
    finally:
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()


PAGED_REFUSALS = {
    "wrong_dtype": (dict(dtype=torch.float16), TypeError),
    "int64_tables": (dict(table_dtype=torch.int64), TypeError),
    "group_of_3": (dict(h=6, h_kv=2), ValueError),
    "not_cuda": (dict(), ValueError),
}


@pytest.mark.parametrize("case", sorted(PAGED_REFUSALS))
def test_paged_decode_wrapper_refuses_instead_of_falling_back(case):
    opts, exc = PAGED_REFUSALS[case]
    dtype, h, h_kv = opts.get("dtype", torch.bfloat16), opts.get("h", 8), opts.get("h_kv", 2)
    q = _meta(2, 1, h, 64, dtype=dtype)
    pool = _meta(5, 4, h_kv, 64, dtype=dtype)
    tables = torch.zeros((2, 3), dtype=opts.get("table_dtype", torch.int32), device="meta")
    pos = torch.zeros((2,), dtype=torch.int32, device="meta")
    with pytest.raises(exc):
        paged_flash_decode(q, pool, pool, tables, pos)


@pytest.mark.parametrize("bad", ["bf16_logits", "int64_top_k", "not_cuda"])
def test_fused_sample_wrapper_refuses_instead_of_falling_back(bad):
    logits = _meta(2, 16, dtype=torch.bfloat16 if bad == "bf16_logits" else torch.float32)
    noise = _meta(2, 16, dtype=logits.dtype)
    t = _meta(2, dtype=torch.float32)
    k = _meta(2, dtype=torch.int64 if bad == "int64_top_k" else torch.int32)
    with pytest.raises(TypeError if bad != "not_cuda" else ValueError):
        fused_sample(logits, noise, t, k, t)


QMM_REFUSALS = {
    "int32_q": (dict(q_dtype=torch.int32), TypeError),
    "float64_x": (dict(x_dtype=torch.float64), TypeError),
    "non_contiguous_x": (dict(transpose=True), ValueError),
    "not_cuda": (dict(), ValueError),
}


@pytest.mark.parametrize("case", sorted(QMM_REFUSALS))
def test_quant_matmul_wrapper_refuses_instead_of_falling_back(case):
    from accelerate_tpu_torch.ops.quant_matmul import quantized_matmul

    opts, exc = QMM_REFUSALS[case]
    x = _meta(8, 64, dtype=opts.get("x_dtype", torch.bfloat16))
    if opts.get("transpose"):
        x = _meta(64, 8).T
    q = _meta(64, 32, dtype=opts.get("q_dtype", torch.int8))
    with pytest.raises(exc):
        quantized_matmul(x, q, _meta(32, dtype=torch.float32))
