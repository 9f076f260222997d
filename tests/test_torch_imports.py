"""Import hygiene and device discipline of the PyTorch port.

* Importing every ``accelerate_tpu_torch`` module and ``chip_smoke`` must
  not import ``jax`` or the JAX package ``accelerate_tpu`` (the card's
  machine has neither); checked in a fresh interpreter.
* Entry points default to the card and raise when it is absent: nothing
  carries on silently on the CPU.
* Kernel wrappers given a tensor that is not on the CPU either launch the
  kernel or raise; they never fall back to the plain version. Meta tensors
  stand in for CUDA ones here: they reach the kernel path and must be
  refused.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from accelerate_tpu_torch._device import resolve_device
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.ops.flash_attention import flash_attention, flash_attention_with_lse
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
    assert "accelerate_tpu_torch.engine" in report["modules"]
    assert "accelerate_tpu_torch.serving" in report["modules"]
    leaked = [m for m in report["new"]
              if m == "jax" or m.startswith(("jax.", "jaxlib"))
              or m == "accelerate_tpu" or m.startswith("accelerate_tpu.")]
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
                    {"segment_ids": torch.zeros(1, 8, dtype=torch.int32)}, NotImplementedError),
}


@pytest.mark.parametrize("case", sorted(FLASH_REFUSALS))
def test_flash_wrapper_refuses_instead_of_falling_back(case):
    make, kw, exc = FLASH_REFUSALS[case]
    with pytest.raises(exc):
        flash_attention(*make(), **kw)


def test_flash_wrapper_refuses_requires_grad():
    q = torch.zeros(1, 8, 4, 16, requires_grad=True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        flash_attention_with_lse(q, q.detach(), q.detach())


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
