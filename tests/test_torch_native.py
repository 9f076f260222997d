"""The port's packing bridge (``accelerate_tpu_torch/utils/native.py``)
against the JAX package's (``accelerate_tpu/utils/native.py``): both load
the same ``csrc/packing.cpp``, and each has a NumPy version. Every entry
point's output must be bitwise equal to the JAX package's on both paths
(native on both sides; NumPy on both sides), and the port's native and
NumPy paths must agree with each other. The port builds its library into
``build/native/`` of the checkout."""

import numpy as np
import pytest

from accelerate_tpu.utils import native as jnative
from accelerate_tpu_torch.utils import native


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_packing_lib", lambda: None)
        monkeypatch.setattr(jnative, "get_packing_lib", lambda: None)
    else:
        assert native.get_packing_lib() is not None and jnative.get_packing_lib() is not None
    return request.param


def _docs(seed, n, lo, hi, vocab=1000):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=rng.integers(lo, hi)).astype(np.int32) for _ in range(n)]


def test_native_library_builds_in_the_checkout():
    assert native.native_available()
    assert native._BUILD_DIR.parts[-2:] == ("build", "native")
    assert (native._BUILD_DIR / "libaccel_packing.so").exists()
    assert native._SOURCE == native._REPO / "csrc" / "packing.cpp"


@pytest.mark.parametrize("capacity", [64, 512, 2048])
def test_pack_ffd_equals_jax(path, capacity):
    lengths = np.random.default_rng(capacity).integers(1, capacity + 40, size=300)
    ids, n = native.pack_ffd(lengths, capacity)
    jids, jn = jnative.pack_ffd(lengths, capacity)
    np.testing.assert_array_equal(ids, jids)
    assert n == jn and ids.dtype == np.int64
    assert (ids[lengths > capacity] == -1).all()


@pytest.mark.parametrize("capacity", [64, 512])
def test_pack_contiguous_equals_jax(path, capacity):
    lengths = np.random.default_rng(7).integers(1, capacity + 10, size=200)
    ids, n = native.pack_contiguous(lengths, capacity)
    jids, jn = jnative.pack_contiguous(lengths, capacity)
    np.testing.assert_array_equal(ids, jids)
    assert n == jn


def test_fill_packed_equals_jax(path):
    docs = _docs(1, 80, 1, 60)
    lengths = np.array([len(d) for d in docs], np.int64)
    starts = np.zeros(len(docs) + 1, np.int64)
    np.cumsum(lengths, out=starts[1:])
    tokens = np.concatenate(docs)
    ids, n = jnative.pack_ffd(lengths, 128)
    got = native.fill_packed(tokens, starts, ids, 128, n, pad_id=3)
    want = jnative.fill_packed(tokens, starts, ids, 128, n, pad_id=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype == np.int32


@pytest.mark.parametrize("seq_len", [None, 32])
def test_collate_padded_equals_jax(path, seq_len):
    # 2048 documents: the native kernel's threaded branch
    docs = _docs(2, 2048, 1, 40, vocab=100)
    got = native.collate_padded(docs, seq_len=seq_len, pad_id=7)
    want = jnative.collate_padded(docs, seq_len=seq_len, pad_id=7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("preserve_order", [False, True])
def test_pack_dataset_equals_jax(path, preserve_order):
    docs = _docs(3, 120, 64, 3000, vocab=128256)
    got = native.pack_dataset(docs, seq_len=2048, preserve_order=preserve_order)
    want = jnative.pack_dataset(docs, seq_len=2048, preserve_order=preserve_order)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    tokens, segments = got
    # every document that fits a row is packed whole; longer ones are dropped
    kept = np.concatenate([d for d in docs if len(d) <= 2048])
    assert sorted(tokens[segments > 0].tolist()) == sorted(kept.tolist())
    np.testing.assert_array_equal(native.packed_loss_mask(segments), jnative.packed_loss_mask(segments))
    np.testing.assert_array_equal(native.packed_position_ids(segments),
                                  jnative.packed_position_ids(segments))


def test_native_and_numpy_paths_agree(monkeypatch):
    docs = _docs(4, 200, 1, 300)
    lengths = np.array([len(d) for d in docs])
    results = []
    for lib in (native.get_packing_lib(), None):
        monkeypatch.setattr(native, "get_packing_lib", lambda lib=lib: lib)
        results.append((native.pack_ffd(lengths, 512), native.pack_contiguous(lengths, 512),
                        native.pack_dataset(docs, 512), native.collate_padded(docs, 64, 0)))
    (a, b) = results
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
