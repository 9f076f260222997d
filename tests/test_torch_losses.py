"""The port's chunked cross entropy (``ops/losses.py``) against the JAX
package's ``chunked_softmax_cross_entropy`` and against the port's dense
loss, in f32 on the CPU: the same numpy-seeded hidden states, head and
labels on both sides.

Tolerances: the loss rtol 1e-5 and each gradient leaf atol 1e-4 x its
largest entry, the f32 tolerances of the port's other loss tests; the
chunks' products and the online logsumexp sum in another order than the
dense logits' and than XLA's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from accelerate_tpu.models import llama as jl
from accelerate_tpu.ops.losses import chunked_softmax_cross_entropy as jax_chunked_ce
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.ops.losses import chunked_softmax_cross_entropy

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _inputs(seed, b=2, s=6, d=16, v=100, ignore=False, mask=False):
    rng = np.random.default_rng(seed)
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    kernel = (rng.normal(size=(d, v)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, s)).astype(np.int64)
    if ignore:
        labels[0, :2] = -100
        labels[-1, -1] = -100
    m = (rng.random((b, s)) > 0.4).astype(np.float32) if mask else None
    return hidden, kernel, labels, m


def _port(fn, hidden, kernel, labels, mask, **kw):
    h = torch.from_numpy(hidden).requires_grad_()
    k = torch.from_numpy(kernel).requires_grad_()
    m = None if mask is None else torch.from_numpy(mask)
    loss = fn(h, k, torch.from_numpy(labels), m, **kw)
    loss.backward()
    return loss.item(), (h.grad.numpy(), k.grad.numpy())


def _jax(hidden, kernel, labels, mask, chunk, **kw):
    lab = jnp.maximum(jnp.asarray(labels), 0).astype(jnp.int32)
    m = (jnp.asarray(labels) >= 0).astype(jnp.float32) if mask is None else jnp.asarray(mask)

    def f(h, k):
        return jax_chunked_ce(h, k, lab, chunk_size=chunk, loss_mask=m, **kw)

    value, grads = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(kernel))
    return float(value), tuple(np.asarray(g) for g in grads)


def _assert_close(got, ref):
    (loss, grads), (rloss, rgrads) = got, ref
    np.testing.assert_allclose(loss, rloss, rtol=LOSS_RTOL)
    for g, r in zip(grads, rgrads):
        np.testing.assert_allclose(g, r, rtol=0, atol=GRAD_RTOL * np.abs(r).max())


def _chunked(chunk, **kw):
    def fn(h, k, labels, mask, **extra):
        return chunked_softmax_cross_entropy(h, k, labels, chunk_size=chunk, loss_mask=mask,
                                             **kw, **extra)
    return fn


def _dense_fn(softcap=None, reduction="mean"):
    def fn(h, k, labels, mask):
        logits = h @ k
        if softcap is not None:
            logits = softcap * torch.tanh(logits / softcap)
        return tl._dense_ce_from_logits(logits, labels, mask, reduction=reduction)
    return fn


@pytest.mark.parametrize("v,chunk", [(100, 32), (128, 32), (64, 64), (50, 7), (100, 4096)])
def test_chunked_ce_matches_jax_and_the_dense_loss(v, chunk):
    # a vocabulary that is a multiple of the chunk, one that is not, one
    # chunk, and a chunk wider than the vocabulary
    hidden, kernel, labels, _ = _inputs(0, v=v)
    got = _port(_chunked(chunk), hidden, kernel, labels, None)
    _assert_close(got, _jax(hidden, kernel, labels, None, chunk))
    _assert_close(got, _port(_dense_fn(), hidden, kernel, labels, None))


@pytest.mark.parametrize("case", ["ignore_index", "loss_mask", "softcap", "sum"])
def test_chunked_ce_options_match_jax_and_the_dense_loss(case):
    hidden, kernel, labels, mask = _inputs(1, s=8, v=96, ignore=case == "ignore_index",
                                           mask=case == "loss_mask")
    kw = {"softcap": dict(logit_softcap=5.0), "sum": dict(reduction="sum")}.get(case, {})
    got = _port(_chunked(32, **kw), hidden, kernel, labels, mask)
    _assert_close(got, _jax(hidden, kernel, labels, mask, 32, **kw))
    dense = _dense_fn(softcap=kw.get("logit_softcap"), reduction=kw.get("reduction", "mean"))
    _assert_close(got, _port(dense, hidden, kernel, labels, mask))


def test_ignore_index_without_a_mask_leaves_the_rows_out():
    # labels < 0 with no loss_mask: the rows count neither in the sum nor
    # in the denominator, as in JAX
    hidden, kernel, labels, _ = _inputs(2, s=8, v=96, ignore=True)
    keep = labels >= 0
    loss, _ = _port(_chunked(32), hidden, kernel, labels, None)
    ref, _ = _port(_chunked(32), hidden[keep][None], kernel, labels[keep][None], None)
    np.testing.assert_allclose(loss, ref, rtol=LOSS_RTOL)


def test_chunked_ce_keeps_no_full_logits():
    # what the backward keeps: the inputs and one f32 per row, not (N, V)
    hidden, kernel, labels, _ = _inputs(3, b=2, s=8, d=16, v=1000)
    saved = []
    h = torch.from_numpy(hidden).requires_grad_()
    k = torch.from_numpy(kernel).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t, lambda t: t):
        chunked_softmax_cross_entropy(h, k, torch.from_numpy(labels), chunk_size=64)
    assert max(saved) <= kernel.size and sum(saved) < 2 * 16 * 1000


def test_bf16_chunks_match_the_dense_bf16_loss():
    # bf16 operands with f32 chunk logits, as the port's head computes its
    # logits: the loss of the dense f32-logit head within f32 summation
    # order, the gradients within the bf16 rounding of the cotangent
    hidden, kernel, labels, _ = _inputs(4, s=8, d=32, v=300)
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    k = torch.from_numpy(kernel).to(torch.bfloat16)
    lab = torch.from_numpy(labels)
    got, grads = {}, {}
    for name in ("chunked", "dense"):
        hh, kk = h.clone().requires_grad_(), k.clone().requires_grad_()
        if name == "chunked":
            loss = chunked_softmax_cross_entropy(hh, kk, lab, chunk_size=64)
        else:
            loss = tl._dense_ce_from_logits(tl._f32_product(hh, kk), lab, None)
        loss.backward()
        got[name], grads[name] = loss.item(), (hh.grad.float(), kk.grad.float())
        assert hh.grad.dtype == kk.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(got["chunked"], got["dense"], rtol=LOSS_RTOL)
    for g, r in zip(grads["chunked"], grads["dense"]):
        torch.testing.assert_close(g, r, rtol=0, atol=2 ** -6 * r.abs().max().item())


@pytest.fixture(scope="module")
def params():
    cfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla")
    return jax.tree_util.tree_map(np.asarray, jl.init_llama_params(cfg, jax.random.key(0)))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("cap", [None, 30.0])
def test_llama_loss_with_chunked_ce_matches_jax_and_the_dense_loss(params, tied, cap):
    kw = dict(final_logit_softcap=cap, tie_word_embeddings=tied)
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla",
                               use_chunked_ce=True, **kw)
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="xla",
                               use_chunked_ce=True, ce_chunk_size=100, **kw)
    jparams = dict(params)
    if tied:
        jparams = {k: v for k, v in params.items() if k != "lm_head"}
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 256, size=(2, 16)).astype(np.int32)
    labels = np.concatenate([ids[:, 1:], ids[:, :1]], axis=1)
    labels[0, :5] = -100
    batch = {"input_ids": ids, "labels": labels}

    def j_loss(p):
        return jl.llama_loss(lambda i, **k: jl.llama_apply(jcfg, p, i, **k),
                             {k: jnp.asarray(v) for k, v in batch.items()}, ce_chunk_size=100)

    jvalue, jgrads = jax.value_and_grad(j_loss)(jax.tree_util.tree_map(jnp.asarray, jparams))
    losses = {}
    for chunked in (True, False):
        cfg = dataclasses.replace(tcfg, use_chunked_ce=chunked)
        model = tl.LlamaForCausalLM(cfg, tl.params_from_jax(cfg, jparams, device="cpu"))
        out = model(torch.from_numpy(ids))
        assert isinstance(out, dict) == chunked
        loss = tl.llama_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss.backward()
        losses[chunked] = loss.item()
        np.testing.assert_allclose(loss.item(), float(jvalue), rtol=LOSS_RTOL)
        named = dict(model.named_parameters())
        for path, jg in jax.tree_util.tree_leaves_with_path(jgrads):
            name = "__".join(str(getattr(p, "key", p)) for p in path)
            jg = np.asarray(jg)
            np.testing.assert_allclose(named[name].grad.numpy(), jg, rtol=0,
                                       atol=GRAD_RTOL * np.abs(jg).max(), err_msg=name)
    np.testing.assert_allclose(losses[True], losses[False], rtol=LOSS_RTOL)
