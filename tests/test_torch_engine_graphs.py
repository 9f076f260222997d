"""The engine's programs as CUDA graphs.

On the CPU (no JAX imported, so the ``cuda``-marked tests also run on the
card's machine without the suite's conftest): the launch counts a capture
takes, the one lock graph builds and replays hold, the static block
tables, the engine state that keeps its tensors
across a reset (a captured graph keeps their addresses), the private
eager hook, and the fixed-shape draw that advances every slot's generator.

On the card (``cuda``-marked): an engine whose programs are captured and
replayed against the eager engine (``engine._disable_graphs``) on the same
requests: every request's tokens and the spec counters bitwise equal, one
graph per program signature, and the launches of each replay those of one
eager call. Run there with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_engine_graphs.py -m cuda
"""

import contextlib

import numpy as np
import pytest
import torch

from accelerate_tpu_torch import engine as engine_mod
from accelerate_tpu_torch.engine import ContinuousBatchingEngine
from accelerate_tpu_torch.kvcache import make_kv_backend
from accelerate_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from accelerate_tpu_torch.ops import _build


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _model(device, dtype=torch.float32):
    # head_dim 64 and GQA groups of 2: shapes the card's kernels take
    cfg = LlamaConfig.tiny(vocab_size=512, hidden_size=256, intermediate_size=512,
                           num_attention_heads=4, num_key_value_heads=2, param_dtype=dtype,
                           compute_dtype=dtype, attention_impl="flash")
    return LlamaForCausalLM.from_seed(cfg, seed=0, device=device)


def test_capture_launches_takes_the_counts_and_restores_the_totals():
    _build.reset_launch_counts()
    _build.count_launch("fused_sample")
    with _build.capture_launches() as captured:
        _build.count_launch("paged_decode_mma")
        _build.count_launch("paged_decode_mma")
        _build.count_launch("fused_sample")
    assert captured == {"paged_decode_mma": 2, "fused_sample": 1}
    counts = _build.launch_counts()
    assert counts["fused_sample"] == 1 and counts["paged_decode_mma"] == 0
    for _ in range(3):
        _build.add_launches(captured)
    counts = _build.launch_counts()
    assert counts["fused_sample"] == 4 and counts["paged_decode_mma"] == 6
    _build.reset_launch_counts()


def test_graph_builds_and_replays_hold_one_lock(monkeypatch):
    """Two static servers (or a static and a continuous replica) on one
    card build and replay ``_Graph``s from their own threads: a build (the
    eager warm-up and the capture, the collector off) holds the process's
    one graph lock, and another thread's replay waits for it. torch's CUDA
    graph is faked, so this runs on the CPU."""
    import gc
    import threading

    class FakeGraph:
        replays = 0

        def register_generator_state(self, gen):
            pass

        def replay(self):
            FakeGraph.replays += 1

    @contextlib.contextmanager
    def fake_capture(graph, stream=None, capture_error_mode=None):
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", fake_capture)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Stream", lambda card: f"stream {card}")
    monkeypatch.setattr(engine_mod, "_CAPTURE_STREAMS", {})
    _build.reset_launch_counts()

    calls = []

    def body():
        assert engine_mod._GRAPH_LOCK.locked()
        calls.append(gc.isenabled())
        _build.count_launch("fused_sample")

    built = engine_mod._Graph(body, [])
    assert calls == [True, False]  # the warm-up, then the capture with the collector off
    assert built.launches == {"fused_sample": 1} and gc.isenabled()
    assert engine_mod._CAPTURE_STREAMS == {0: "stream 0"}

    inside, release, replayed = threading.Event(), threading.Event(), threading.Event()

    def slow_body():
        if len(calls) == 3:  # the capture: wait inside it
            inside.set()
            assert release.wait(10)
        body()

    def replay_other():
        built.replay()
        replayed.set()

    builder = threading.Thread(target=engine_mod._Graph, args=(slow_body, []))
    builder.start()
    assert inside.wait(10)
    replayer = threading.Thread(target=replay_other)
    replayer.start()
    assert not replayed.wait(0.2)  # the replay waits for the other thread's capture
    release.set()
    builder.join(10)
    replayer.join(10)
    assert replayed.is_set() and FakeGraph.replays == 1
    assert _build.launch_counts()["fused_sample"] == 3  # two warm-ups and the one replay
    _build.reset_launch_counts()


@pytest.mark.parametrize("kind", ["paged", "paged_int8"])
def test_paged_tables_are_one_static_tensor(kind):
    cfg = LlamaConfig.tiny()
    backend = make_kv_backend(kind, config=cfg, slots=3, max_len=32, prompt_bucket=16,
                              device=torch.device("cpu"), block_size=8)
    tables = backend.device_tables()
    backend.acquire(1, np.arange(1, 12, dtype=np.int32), 5)
    assert backend.device_tables() is tables
    np.testing.assert_array_equal(tables.numpy(), backend.pool.tables)
    assert (tables[1] != 0).sum() == 2
    backend.release(1)
    assert backend.device_tables() is tables and int(tables.abs().sum()) == 0
    backend.reset()
    assert backend.device_tables() is tables


def _state_tensors(eng):
    return [eng._pos, eng._uniform, eng._accept_u, eng._args, eng._prompt_ids,
            *eng._carried.values(), *eng._out.values(), *engine_mod._leaves(eng._cache)]


@pytest.mark.parametrize("kind", ["dense", "paged", "paged_int8"])
def test_reset_refills_the_state_in_place(kind):
    eng = ContinuousBatchingEngine(_model("cpu"), slots=2, max_len=32, prompt_bucket=8,
                                   kv_cache=kind, block_size=8, readback_lag=0, device="cpu")
    fresh = [t.clone() for t in _state_tensors(eng)]
    ptrs = [t.data_ptr() for t in _state_tensors(eng)]
    eng.insert(np.arange(1, 7, dtype=np.int32), max_new_tokens=3, temperature=0.7, seed=3)
    eng.step()
    assert int(eng._pos[1 if eng._occupants[1] else 0]) == 7
    eng.reset()
    assert [t.data_ptr() for t in _state_tensors(eng)] == ptrs
    for t, f in zip(_state_tensors(eng)[:2] + _state_tensors(eng)[5:13], fresh[:2] + fresh[5:13]):
        assert torch.equal(t, f)
    assert all(int(leaf.abs().sum()) == 0 for leaf in engine_mod._leaves(eng._cache))


def test_disable_graphs_is_a_private_scoped_hook():
    assert not engine_mod._graphs_disabled
    with engine_mod._disable_graphs():
        assert engine_mod._graphs_disabled
        eng = ContinuousBatchingEngine(_model("cpu"), slots=1, max_len=16, prompt_bucket=8,
                                       device="cpu")
    assert not engine_mod._graphs_disabled and not eng._use_graphs
    # the CPU engine runs eagerly, records the signatures, captures nothing
    eng.insert([1, 2, 3], max_new_tokens=2)
    eng.drain()
    assert eng.stats()["programs"] == {"prefill_insert": 1, "decode_step": 1}
    assert eng.graph_launches() == {}


def test_every_step_draws_for_every_slot():
    # the step has one shape: a vacant slot's generator advances too (it is
    # reseeded at its next request's first token), and a request's draws
    # do not depend on its neighbours
    model = _model("cpu")
    eng = ContinuousBatchingEngine(model, slots=3, max_len=32, prompt_bucket=8, kv_cache="paged",
                                   block_size=8, readback_lag=0, device="cpu")
    occ = eng.insert([5, 6, 7], max_new_tokens=6, temperature=1.0, seed=11)
    states = [g.get_state() for g in eng._gens]
    eng.step()
    assert all(not torch.equal(s, g.get_state()) for s, g in zip(states, eng._gens))
    eng.drain()
    packed = ContinuousBatchingEngine(model, slots=3, max_len=32, prompt_bucket=8,
                                      kv_cache="paged", block_size=8, readback_lag=0, device="cpu")
    other = packed.insert([9, 9, 9, 9], max_new_tokens=3, temperature=1.0, seed=1)
    packed.step()
    again = packed.insert([5, 6, 7], max_new_tokens=6, temperature=1.0, seed=11)
    packed.drain()
    assert again.tokens == occ.tokens and len(other.tokens) == 3


# ------------------------------------------------------------------ card
def _serve(model, device, graphs, prompts, **kw):
    ctx = engine_mod._disable_graphs() if not graphs else contextlib.nullcontext()
    with ctx:
        eng = ContinuousBatchingEngine(model, device=device, attention_impl="kernel",
                                       readback_lag=2, **kw)
    _build.reset_launch_counts()
    occs = []
    for i, p in enumerate(prompts):
        if eng.free_slots() == 0 or not eng.can_admit(p, 24):
            eng.drain()
        sampled = i % 2 == 1
        occs.append(eng.insert(p, max_new_tokens=24, temperature=0.9 if sampled else 0.0,
                               top_k=40 if sampled else None, top_p=0.9 if sampled else None,
                               seed=i))
        eng.step()
        eng.poll()
    eng.drain()
    torch.cuda.synchronize()
    spec = eng.stats()["spec"]
    counters = {k: spec[k] for k in ("drafted", "accepted", "wasted")}
    return eng, [list(o.tokens) for o in occs], [o.decode_steps for o in occs], counters, \
        _build.launch_counts()


def _prompts(vocab, n=10):
    rng = np.random.default_rng(0)
    tiled = [np.tile(rng.integers(0, vocab, size=5), 6).astype(np.int32) for _ in range(n // 2)]
    plain = [rng.integers(0, vocab, size=int(m)).astype(np.int32)
             for m in rng.integers(3, 33, size=n - n // 2)]
    return [p for pair in zip(tiled, plain) for p in pair]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,spec,chunk", [
    ("paged", None, None), ("paged", "ngram", 16), ("paged_int8", "ngram", 16)])
def test_graph_engine_equals_the_eager_engine_on_card(cuda_device, kind, spec, chunk):
    model = _model(cuda_device, torch.bfloat16)
    layers = model.config.num_hidden_layers
    prompts = _prompts(model.config.vocab_size)
    if chunk:
        rng = np.random.default_rng(1)
        prompts += [rng.integers(0, model.config.vocab_size, size=n).astype(np.int32) for n in (40, 57)]
    kw = dict(slots=4, max_len=128, prompt_bucket=32, kv_cache=kind, block_size=16, spec=spec,
              spec_draft_len=3, prefill_chunk=chunk)
    geng, gtok, gsteps, gcount, glaunch = _serve(model, cuda_device, True, prompts, **kw)
    eeng, etok, esteps, ecount, elaunch = _serve(model, cuda_device, False, prompts, **kw)
    assert gtok == etok and gsteps == esteps and gcount == ecount
    assert all(len(t) == 24 for t in gtok)
    programs = geng.stats()["programs"]
    assert programs == eeng.stats()["programs"]
    assert geng.stats()["program_count"] == len(geng._graphs) and not eeng._graphs
    suffix = "_int8" if kind == "paged_int8" else ""
    per_replay = {
        "decode_step ()": {f"paged_decode{suffix}_mma": layers, "fused_sample": 1},
        "prefill_insert (32,)": {"flash_fwd_mma": layers, "fused_sample": 1},
        "verify_step (3,)": {f"paged_verify{suffix}_mma": layers},
        "prefill_insert ('chunk', 16)": {f"paged_verify{suffix}_mma": layers, "fused_sample": 1},
    }
    got = geng.graph_launches()
    assert got == {k: v for k, v in per_replay.items() if k in got}
    if spec:
        assert "verify_step (3,)" in got and gcount["drafted"] > 0
    # a replay counts the launches an eager call makes: the same totals
    assert glaunch == elaunch
    decode_steps = geng.steps - geng.spec_verify_steps
    assert glaunch[f"paged_decode{suffix}_mma"] == layers * decode_steps
    assert glaunch[f"paged_verify{suffix}_mma"] == layers * (geng.spec_verify_steps + geng.prefill_chunks)


@pytest.mark.cuda
def test_servers_on_two_cards_serve_from_one_process():
    """Continuous servers on cuda:0 and cuda:1, built on this thread and
    run by their own serving threads (a fleet across cards): each engine's
    staging events and graph captures follow its card, not the building
    or the first-capturing thread's, and both cards' greedy tokens are the
    same bits."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: one server a card in one process")
    from accelerate_tpu_torch.serving import InferenceServer
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    cfg = ServingConfig(mode="continuous", engine_slots=4, engine_max_len=128,
                        engine_prompt_bucket=32, kv_cache="paged", attention_impl="kernel",
                        engine_readback_lag=1)
    devices = [torch.device("cuda", 0), torch.device("cuda", 1)]
    prompts = _prompts(512, n=6)
    tokens = []
    for dev in devices:
        with InferenceServer(_model(dev, torch.bfloat16), cfg, device=dev) as srv:
            tokens.append([srv.submit(p, max_new_tokens=12).result(timeout=300).tokens.tolist()
                           for p in prompts])
            assert len(srv.engine._graphs) == 2
    assert tokens[0] == tokens[1]
