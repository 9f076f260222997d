"""The port's training-state checkpoints (``accelerate_tpu_torch/checkpointing.py``)
on the CPU, case by case as ``tests/test_checkpointing.py`` holds the JAX
package's, and the resume against JAX.

* Save, perturb, load and train on: identical to training through.
* Automatic naming with ``total_limit``, custom objects, pre-hooks,
  ``save_model``'s safetensors round trip, torch AdamW's state (moments and
  step counters) and the fp16 scale round-tripped bitwise, the scheduler
  and the loader position restored.
* Resume against JAX: a tiny Llama (2 layers, width 64) from the same
  weights (``params_from_jax``) and numpy-seeded batches; the JAX
  ``Accelerator`` trains 4 steps, saves, loads into a fresh accelerator and
  trains 4 more, and the port does the same. Their losses agree within the
  AdamW trajectory tolerance of ``tests/test_torch_llama_train.py`` (rtol
  1e-4: f32 on both sides, the matmuls sum in another order), and the
  port's resumed run is bitwise equal to its uninterrupted one.
* A checkpoint of another world size loads only with ``elastic=True``
  (``CheckpointTopologyError`` otherwise); with a ``ReplicationConfig`` a
  save is mirrored (``tests/test_torch_elastic.py`` holds replication).
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.parallelism_config import ParallelismConfig
from accelerate_tpu.state import (
    AcceleratorState as JAcceleratorState,
    GradientState as JGradientState,
    PartialState as JPartialState,
)
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.checkpointing import load_model_checkpoint
from accelerate_tpu_torch.models import llama as tl
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import ProjectConfiguration
from accelerate_tpu_torch.utils.fault import CheckpointTopologyError
from accelerate_tpu_torch.utils.serialization import load_sharded_safetensors, save_sharded_safetensors

LR = 0.1
ADAMW_LR = 1e-2
TRAJ_LOSS_RTOL = 1e-4  # the AdamW trajectory tolerance of test_torch_llama_train.py


class Regression(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(()))
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return self.a * x + self.b


def regression_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def make_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    return {"x": x, "y": (2.0 * x + 3.0 + 0.1 * rng.normal(size=n)).astype(np.float32)}


@pytest.fixture(autouse=True)
def fresh_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


def _fresh(tmp_path, **kwargs):
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    kwargs.setdefault("project_dir", str(tmp_path))
    return Accelerator(cpu=True, **kwargs)


def _train(acc, model, opt, loader, epochs=1):
    for _ in range(epochs):
        for batch in loader:
            with acc.accumulate(model):
                acc.backward(regression_loss, batch)
                opt.step()
                opt.zero_grad()


def _regression(acc, optimizer=torch.optim.Adam):
    model = Regression()
    opt = optimizer(model.parameters(), lr=LR)
    loader = acc.prepare_data_loader(make_data(32), batch_size=16, drop_last=True)
    model, opt = acc.prepare(model, opt)
    return model, opt, loader


def test_save_load_state_roundtrip(tmp_path):
    acc = _fresh(tmp_path)
    model, opt, loader = _regression(acc)
    _train(acc, model, opt, loader)
    a_after, b_after = model.a.item(), model.b.item()
    ckpt = acc.save_state(str(tmp_path / "ckpt"))
    assert os.path.isdir(ckpt)
    with torch.no_grad():
        model.a.fill_(-5.0)
        model.b.fill_(-5.0)
    acc.load_state(ckpt)
    assert (model.a.item(), model.b.item()) == (a_after, b_after)
    _train(acc, model, opt, loader)
    resumed = (model.a.item(), model.b.item())
    acc2 = _fresh(tmp_path)
    model2, opt2, loader2 = _regression(acc2)
    _train(acc2, model2, opt2, loader2, epochs=2)
    assert resumed == (model2.a.item(), model2.b.item())  # the Adam moments came back exactly


def test_automatic_checkpoint_naming_and_total_limit(tmp_path):
    acc = _fresh(tmp_path, project_dir=None, project_config=ProjectConfiguration(
        project_dir=str(tmp_path), automatic_checkpoint_naming=True, total_limit=2))
    _regression(acc, torch.optim.SGD)
    for _ in range(3):
        acc.save_state()
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["checkpoint_1", "checkpoint_2"]
    assert acc.save_iteration == 3
    acc.load_state()
    assert acc._last_committed_checkpoint.endswith("checkpoint_2")


def test_register_for_checkpointing_and_pre_hooks(tmp_path):
    acc = _fresh(tmp_path)

    class Counter:
        def __init__(self):
            self.value = 0

        def state_dict(self):
            return {"value": self.value, "t": torch.arange(3)}

        def load_state_dict(self, sd):
            self.value = sd["value"]
            assert torch.equal(sd["t"], torch.arange(3))

    c = Counter()
    c.value = 41
    acc.register_for_checkpointing(c)
    calls = []
    acc.register_save_state_pre_hook(lambda models, weights, out: calls.append(("save", out)))
    acc.register_load_state_pre_hook(lambda models, inp: calls.append(("load", inp)))
    _regression(acc, torch.optim.SGD)
    out = str(tmp_path / "ckpt")
    acc.save_state(out)
    c.value = 0
    acc.load_state(out)
    assert c.value == 41 and calls == [("save", out), ("load", out)]
    with pytest.raises(ValueError):
        acc.register_for_checkpointing(object())


def test_save_model_safetensors_roundtrip(tmp_path):
    acc = _fresh(tmp_path)

    class Layer(nn.Module):
        def __init__(self):
            super().__init__()
            self.w = nn.Parameter(torch.arange(32.0).reshape(8, 4))
            self.b = nn.Parameter(torch.ones(4, dtype=torch.bfloat16))

    model = acc.prepare(Layer())
    acc.save_model(model, str(tmp_path / "export"))
    assert os.path.exists(tmp_path / "export" / "model.safetensors")
    assert sorted(acc.get_state_dict(model)) == ["b", "w"]
    with torch.no_grad():
        model.w.zero_()
        model.b.zero_()
    load_model_checkpoint(model, str(tmp_path / "export"))
    assert torch.equal(model.w, torch.arange(32.0).reshape(8, 4))
    assert model.b.dtype == torch.bfloat16 and torch.equal(model.b, torch.ones(4, dtype=torch.bfloat16))


def test_sharded_safetensors_index(tmp_path):
    params = {f"w{i}": torch.full((128, 16), float(i)) for i in range(4)}
    written = save_sharded_safetensors(params, str(tmp_path), max_shard_size="10KB")
    assert len(written) == 4 and os.path.exists(tmp_path / "model.safetensors.index.json")
    flat = load_sharded_safetensors(str(tmp_path))
    assert set(flat) == set(params) and torch.equal(flat["w3"], params["w3"])


@pytest.mark.parametrize("fresh_optimizer", [False, True])
def test_adamw_state_round_trips_bitwise(tmp_path, fresh_optimizer):
    acc = _fresh(tmp_path)
    model, opt, loader = _regression(acc, torch.optim.AdamW)
    _train(acc, model, opt, loader)
    want = {k: v.clone() for k, v in opt.optimizer.state[model.a].items()}
    steps, groups = opt._step_count, opt.optimizer.param_groups[0]["betas"]
    acc.save_state(str(tmp_path / "ckpt"))
    if fresh_optimizer:  # a new process: the optimizer has no state yet
        acc = _fresh(tmp_path)
        model, opt, loader = _regression(acc, torch.optim.AdamW)
    else:
        for state in opt.optimizer.state.values():
            for v in state.values():
                v.zero_()
    acc.load_state(str(tmp_path / "ckpt"))
    got = opt.optimizer.state[model.a]
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
    assert got["step"].device.type == "cpu" and opt._step_count == steps
    assert opt.optimizer.param_groups[0]["betas"] == groups


def test_fp16_scale_round_trips(tmp_path):
    acc = _fresh(tmp_path, mixed_precision="fp16")
    _regression(acc)
    acc.scaler.state = {"scale": 1024.0, "good_steps": 17}
    acc.save_state(str(tmp_path / "ckpt"))
    acc.scaler.state = {"scale": 2.0, "good_steps": 0}
    acc.load_state(str(tmp_path / "ckpt"))
    assert acc.scaler.state_dict() == {"scale": 1024.0, "good_steps": 17}
    assert json.load(open(tmp_path / "ckpt" / "scaler.json")) == {"scale": 1024.0, "good_steps": 17}


def test_scheduler_and_loader_position_resume(tmp_path):
    acc = _fresh(tmp_path)
    model = Regression()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    loader = acc.prepare_data_loader(make_data(64), batch_size=8, shuffle=True, seed=3)
    model, opt, sched = acc.prepare(model, opt, lambda n: LR / (1 + n))
    it = iter(loader)
    for _ in range(3):
        batch = next(it)
        with acc.accumulate(model):
            acc.backward(regression_loss, batch)
            opt.step()
            sched.step()
            opt.zero_grad()
    acc.save_state(str(tmp_path / "ckpt"))
    rest = [b["x"].tolist() for b in it]
    acc2 = _fresh(tmp_path)
    model2 = Regression()
    opt2 = torch.optim.SGD(model2.parameters(), lr=LR)
    loader2 = acc2.prepare_data_loader(make_data(64), batch_size=8, shuffle=True, seed=3)
    model2, opt2, sched2 = acc2.prepare(model2, opt2, lambda n: LR / (1 + n))
    acc2.load_state(str(tmp_path / "ckpt"))
    assert sched2.step_count == 3 and opt2.optimizer.param_groups[0]["lr"] == LR / 4
    assert acc2.step == 3 and [b["x"].tolist() for b in loader2] == rest


def test_what_waits_for_the_distributed_slice_is_refused(tmp_path):
    acc = _fresh(tmp_path)
    _regression(acc)
    ckpt = acc.save_state(str(tmp_path / "ckpt"))
    # elastic loads landed: at the same world size elastic=True changes nothing
    acc.load_state(ckpt, elastic=True)
    assert acc.resume_from_latest(ckpt, elastic=True) is True
    marker = os.path.join(ckpt, "COMMITTED")
    manifest = json.load(open(marker))
    manifest["num_processes"] = 4
    json.dump(manifest, open(marker, "w"))
    # another world size: refused without elastic=True, as in the JAX package
    with pytest.raises(CheckpointTopologyError, match=r"num_processes 4 \(saved\) != 1.*elastic=True"):
        acc.load_state(ckpt)
    acc.load_state(ckpt, elastic=True)
    # replicas landed (A7's durability half): a save is mirrored
    from accelerate_tpu_torch.utils.dataclasses import ReplicationConfig

    replica = tmp_path / "replica"
    acc = _fresh(tmp_path, replication_config=ReplicationConfig(target=str(replica),
                                                               async_replicate=False))
    _regression(acc)
    acc.save_state(str(tmp_path / "mirrored"))
    assert (replica / "r0" / "mirrored" / "COMMITTED").is_file()


# ------------------------------------------------------------ resume vs JAX
STEPS = 4


def _llama_batches():
    data = np.random.default_rng(4).integers(0, 256, size=(8 * 2 * STEPS, 16)).astype(np.int32)
    return [{"input_ids": data[i:i + 8]} for i in range(0, len(data), 8)]


def _jax_reset():
    JAcceleratorState._reset_state()
    JGradientState._reset_state()
    JPartialState._reset_state()


def _jax_resumed_losses(params, batches, ckpt_dir):
    losses = []
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla", attention_kv_block=16)
    for half in range(2):
        _jax_reset()
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=8))
        model = jl.create_llama(jcfg, seed=1)  # other weights: the checkpoint replaces them
        if half == 0:
            model.params = jax.tree_util.tree_map(jnp.asarray, params)
        model, tx = acc.prepare(model, optax.adamw(ADAMW_LR, weight_decay=0.01))
        if half == 1:
            acc.load_state(ckpt_dir)
        step = acc.train_step(jl.llama_loss, max_grad_norm=1.0)
        for batch in batches[half * STEPS:(half + 1) * STEPS]:
            losses.append(float(step({k: jnp.asarray(v) for k, v in batch.items()})))
        if half == 0:
            acc.save_state(ckpt_dir)
    _jax_reset()
    return losses


def _port_run(params, batches, ckpt_dir=None):
    """The port's 2 x STEPS AdamW steps: straight through, or with a save
    after STEPS and a load into a fresh accelerator and model."""
    tcfg = tl.LlamaConfig.tiny(compute_dtype=torch.float32, attention_impl="flash")
    losses = []
    halves = [(0, 2 * STEPS)] if ckpt_dir is None else [(0, STEPS), (STEPS, 2 * STEPS)]
    for n, (lo, hi) in enumerate(halves):
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        acc = Accelerator(cpu=True)
        model = tl.LlamaForCausalLM(tcfg, tl.params_from_jax(tcfg, params, device="cpu"))
        if n == 1:
            with torch.no_grad():
                for p in model.parameters():
                    p.zero_()  # the checkpoint must replace every weight
        opt = torch.optim.AdamW(model.parameters(), lr=ADAMW_LR, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        model, opt = acc.prepare(model, opt)
        if n == 1:
            acc.load_state(ckpt_dir)
        step = acc.train_step(tl.llama_loss, max_grad_norm=1.0)
        for batch in batches[lo:hi]:
            losses.append(step({k: torch.from_numpy(v) for k, v in batch.items()}).item())
        if ckpt_dir is not None and n == 0:
            acc.save_state(ckpt_dir)
    return losses, [p.detach().clone() for p in model.parameters()]


def test_llama_save_load_train_matches_jax_and_resumes_bitwise(tmp_path):
    jcfg = jl.LlamaConfig.tiny(compute_dtype=jnp.float32, attention_impl="xla", attention_kv_block=16)
    params = jax.tree_util.tree_map(np.asarray, jl.init_llama_params(jcfg, jax.random.key(0)))
    batches = _llama_batches()
    jlosses = _jax_resumed_losses(params, batches, str(tmp_path / "jax_ckpt"))
    resumed, resumed_params = _port_run(params, batches, str(tmp_path / "torch_ckpt"))
    straight, straight_params = _port_run(params, batches)
    np.testing.assert_allclose(resumed, jlosses, rtol=TRAJ_LOSS_RTOL)
    assert resumed == straight
    assert all(torch.equal(a, b) for a, b in zip(resumed_params, straight_params))
    files = set(os.listdir(tmp_path / "torch_ckpt"))
    assert {"model", "optimizer", "optimizer_meta.json", "sampler.json", "random_states_0.pkl",
            "COMMITTED"} <= files
