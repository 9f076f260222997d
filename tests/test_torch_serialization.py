"""The port's safetensors reader and writer (no ``safetensors`` package)
against the JAX package's, which write and read through the real package:
checkpoints interchange bitwise in both directions, single-file and
sharded, for f32, bf16, int8 and int32 leaves; and the streamed load's
release, missing-key and shape checks.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from accelerate_tpu.utils import serialization as jser
from accelerate_tpu_torch.big_modeling import load_checkpoint_in_model
from accelerate_tpu_torch.utils import serialization as tser
from accelerate_tpu_torch.utils.constants import SAFE_WEIGHTS_INDEX_NAME, SAFE_WEIGHTS_NAME


def _flat_np(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "layers.attn.q_proj.kernel": rng.normal(size=(3, 16, 24)).astype(np.float32),
        "embed_tokens.embedding": np.asarray(
            jnp.asarray(rng.normal(size=(40, 16)), dtype=jnp.bfloat16)),
        "lm_head.q": rng.integers(-127, 128, size=(16, 40)).astype(np.int8),
        "step": np.asarray(7, dtype=np.int32),
        "positions": rng.integers(0, 1000, size=(5,)).astype(np.int32),
    }


def _bits(x):
    """The raw bytes of a numpy array or tensor, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return x.reshape(-1).view(torch.uint8).numpy().tobytes(), tuple(x.shape)
    x = np.ascontiguousarray(x)
    return x.tobytes(), x.shape


def _files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))


@pytest.mark.parametrize("shard", [None, "2KB"])
def test_jax_written_checkpoint_reads_bitwise(tmp_path, shard):
    flat = _flat_np()
    kw = {} if shard is None else {"max_shard_size": shard}
    jser.save_sharded_safetensors(flat, str(tmp_path), **kw)
    assert (len(_files(tmp_path)) > 1) == (shard is not None)
    with tser.SafetensorsReader(str(tmp_path)) as reader:
        assert sorted(reader.keys()) == sorted(flat)
        for key, arr in flat.items():
            got = reader.get(key)
            assert got.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16,
                                 "int8": torch.int8, "int32": torch.int32}[str(arr.dtype)]
            assert _bits(got) == _bits(arr)
    loaded = tser.load_sharded_safetensors(str(tmp_path))
    assert {k: _bits(v) for k, v in loaded.items()} == {k: _bits(v) for k, v in flat.items()}


@pytest.mark.parametrize("shard", [None, "2KB"])
def test_port_written_checkpoint_reads_bitwise_in_jax(tmp_path, shard):
    flat = _flat_np(seed=1)
    tree = tser.unflatten_dict({k: torch.from_numpy(v.astype(np.float32)).bfloat16()
                                if v.dtype == jnp.bfloat16 else torch.from_numpy(v)
                                for k, v in flat.items()})
    kw = {} if shard is None else {"max_shard_size": shard}
    written = tser.save_sharded_safetensors(tree, str(tmp_path), **kw)
    assert [os.path.basename(p) for p in written] == _files(tmp_path)
    if shard is None:
        assert _files(tmp_path) == [SAFE_WEIGHTS_NAME]
    else:
        with open(tmp_path / SAFE_WEIGHTS_INDEX_NAME) as f:
            index = json.load(f)
        assert sorted(index["weight_map"]) == sorted(flat)
        assert index["metadata"]["total_size"] == sum(v.nbytes for v in flat.values())
    with jser.SafetensorsReader(str(tmp_path)) as reader:
        for key, arr in flat.items():
            got = reader.get(key)
            assert got.dtype == arr.dtype and _bits(got) == _bits(arr)
    loaded = jser.load_sharded_safetensors(str(tmp_path))
    assert {k: _bits(v) for k, v in loaded.items()} == {k: _bits(v) for k, v in flat.items()}


def test_header_layout(tmp_path):
    # u64 little-endian length, a JSON header padded to 8 bytes with
    # __metadata__, each tensor aligned to its element size
    tser.save_sharded_safetensors({"a": torch.ones(3, dtype=torch.int8), "b": torch.ones(2)},
                                  str(tmp_path))
    raw = (tmp_path / SAFE_WEIGHTS_NAME).read_bytes()
    n = int.from_bytes(raw[:8], "little")
    assert n % 8 == 0
    header = json.loads(raw[8:8 + n])
    assert header["__metadata__"] == {"format": "pt"}
    assert header["b"] == {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    assert header["a"] == {"dtype": "I8", "shape": [3], "data_offsets": [8, 11]}
    assert len(raw) == 8 + n + 11


def test_parse_size_and_flatten_match_jax():
    for s in ("10GB", "1.5 MB", "64KB", "123"):
        assert tser.parse_size(s) == jser.parse_size(s)
    with pytest.raises(ValueError):
        tser.parse_size("ten")
    tree = {"a": {"b": 1, "c": [2, {"d": 3}]}, "e": 4}
    assert tser.flatten_dict(tree) == jser.flatten_dict(tree)
    flat = tser.flatten_dict(tree)
    assert tser.unflatten_dict(flat) == jser.unflatten_dict(flat)


def test_release_file_and_reopen(tmp_path):
    jser.save_sharded_safetensors(_flat_np(), str(tmp_path), max_shard_size="2KB")
    with tser.SafetensorsReader(str(tmp_path)) as reader:
        key = "layers.attn.q_proj.kernel"
        first = reader.get(key).clone()
        path = reader.file_of(key)
        reader.release_file(path)
        assert path not in reader._handles
        assert torch.equal(reader.get(key), first)  # reopened on demand
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tser.SafetensorsReader(str(empty))


class _Two(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(4, 3)
        self.register_buffer("steps", torch.zeros((), dtype=torch.int32))


def test_load_streams_per_file_and_releases_each(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    flat = {"fc.weight": rng.normal(size=(3, 4)).astype(np.float32),
            "fc.bias": rng.normal(size=(3,)).astype(np.float32),
            "steps": np.asarray(5, np.int32)}
    # the port's writer: the JAX one stores a scalar as shape (1,) (np.ascontiguousarray)
    tser.save_sharded_safetensors({k: torch.from_numpy(v) for k, v in flat.items()},
                                  str(tmp_path), max_shard_size="10")
    assert len(_files(tmp_path)) == 3
    released = []
    orig = tser.SafetensorsReader.release_file
    monkeypatch.setattr(tser.SafetensorsReader, "release_file",
                        lambda self, p: (released.append(p), orig(self, p))[1])
    model = _Two()
    load_checkpoint_in_model(model, str(tmp_path), device="cpu")
    assert len(set(released)) == 3
    np.testing.assert_array_equal(model.fc.weight.detach().numpy(), flat["fc.weight"])
    np.testing.assert_array_equal(model.fc.bias.detach().numpy(), flat["fc.bias"])
    assert isinstance(model.fc.weight, torch.nn.Parameter) and int(model.steps) == 5


def test_missing_keys_and_shape_mismatch_leave_the_model_unchanged(tmp_path):
    model = _Two()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tser.save_sharded_safetensors({"fc": {"weight": torch.ones(3, 4)}}, str(tmp_path / "partial"))
    with pytest.raises(KeyError, match="fc.bias"):
        load_checkpoint_in_model(model, str(tmp_path / "partial"), device="cpu")
    tser.save_sharded_safetensors({"fc": {"weight": torch.ones(4, 3), "bias": torch.ones(3)},
                                   "steps": torch.tensor(1, dtype=torch.int32)},
                                  str(tmp_path / "wrong"))
    with pytest.raises(ValueError, match="Shape mismatch for fc.weight"):
        load_checkpoint_in_model(model, str(tmp_path / "wrong"), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])
    # not strict: the keys present load, the rest stay
    load_checkpoint_in_model(model, str(tmp_path / "partial"), strict=False, device="cpu")
    assert torch.equal(model.fc.weight, torch.ones(3, 4))
    assert torch.equal(model.fc.bias, before["fc.bias"])
