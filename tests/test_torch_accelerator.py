"""The port's ``Accelerator`` semantics on the CPU (``cpu=True``): the eager
``backward``/``step``/``zero_grad`` loop against ``train_step``, the
``sync_gradients`` pattern of gradient accumulation and the forced sync at
the end of the data loader (the JAX package's ``tests/test_accelerator.py``
pins the same patterns), gradient clipping, fp16 loss scaling skipping a
step on non-finite gradients, the mixed-precision wrapper, the data loader,
the refusals of what still waits (tensor parallelism, PowerSGD, replicas),
the C4 arguments the JAX package takes, and the multi-step
``train_step``, schedulers and data path that took the place of earlier
refusals.

A two-parameter regression ``y = a * x + b`` in f64 keeps the arithmetic
exact enough to compare the eager loop, ``train_step`` and a hand-rolled
SGD at atol 1e-12.
"""

import numpy as np
import pytest
import torch
from torch import nn

import dataclasses

from accelerate_tpu.data_loader import SeedableRandomSampler as JSampler
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.data_loader import SeedableRandomSampler, prepare_data_loader
from accelerate_tpu_torch.model import MixedPrecisionModule, unwrap_model
from accelerate_tpu_torch.optimizer import DynamicScale
from accelerate_tpu_torch.parallel.sharding import data_parallel_layout
from accelerate_tpu_torch.parallelism_config import ParallelismConfig
from accelerate_tpu_torch.scheduler import AcceleratedScheduler
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import (
    DistributedDataParallelKwargs,
    GradScalerKwargs,
    GradientAccumulationPlugin,
)

LR = 0.1
ATOL = 1e-12


@pytest.fixture(autouse=True)
def fresh_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


class Regression(nn.Module):
    def __init__(self, dtype=torch.float64):
        super().__init__()
        self.a = nn.Parameter(torch.zeros((), dtype=dtype))
        self.b = nn.Parameter(torch.zeros((), dtype=dtype))

    def forward(self, x):
        return self.a * x + self.b


def regression_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def make_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    return {"x": x, "y": 2.0 * x + 3.0 + 0.1 * rng.normal(size=n)}


def reference_sgd(data, bs, accum, n_batches, max_norm=None):
    """Hand-rolled SGD with accumulation (and the JAX clip factor)."""
    a = b = 0.0
    ga = gb = 0.0
    for i in range(n_batches):
        x, y = data["x"][i * bs:(i + 1) * bs], data["y"][i * bs:(i + 1) * bs]
        r = a * x + b - y
        ga += (2 * r * x).mean() / accum
        gb += (2 * r).mean() / accum
        if (i + 1) % accum == 0 or i == n_batches - 1:
            if max_norm is not None:
                factor = min(1.0, max_norm / (np.hypot(ga, gb) + 1e-6))
                ga, gb = ga * factor, gb * factor
            a, b = a - LR * ga, b - LR * gb
            ga = gb = 0.0
    return a, b


def _setup(accum=1, n=64, **kw):
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accum, **kw)
    model = Regression()
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    data = make_data(n)
    loader = acc.prepare_data_loader(data, batch_size=16, drop_last=True)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt, data, loader


@pytest.mark.parametrize("n,expected", [(64, [False, True, False, True]), (48, [False, True, True])])
def test_eager_loop_sync_pattern_and_end_of_dataloader(n, expected):
    # accumulation 2: sync every second batch, and on the last batch of the
    # loader whatever the count
    acc, model, opt, data, loader = _setup(accum=2, n=n)
    flags = []
    for batch in loader:
        with acc.accumulate(model):
            acc.backward(regression_loss, batch)
            flags.append(acc.sync_gradients)
            opt.step()
            opt.zero_grad()
    assert flags == expected
    a, b = reference_sgd(data, 16, 2, len(expected))
    assert abs(model.a.item() - a) < ATOL and abs(model.b.item() - b) < ATOL


@pytest.mark.parametrize("accum", [1, 2])
def test_eager_loop_matches_train_step(accum):
    acc, model, opt, data, loader = _setup(accum=accum)
    for batch in loader:
        with acc.accumulate(model):
            acc.backward(regression_loss, batch)
            acc.clip_grad_norm_(model.parameters(), max_norm=1.0)
            opt.step()
            opt.zero_grad()
    eager = (model.a.item(), model.b.item())
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc, model, opt, data, loader = _setup(accum=accum)
    step = acc.train_step(regression_loss, max_grad_norm=1.0)
    losses, flags = [], []
    for batch in loader:
        losses.append(step(batch))
        flags.append(acc.sync_gradients)
    assert all(not l.requires_grad for l in losses)
    assert flags == [(i + 1) % accum == 0 for i in range(4)]
    a, b = reference_sgd(data, 16, accum, 4, max_norm=1.0)
    for got in (eager, (model.a.item(), model.b.item())):
        assert abs(got[0] - a) < ATOL and abs(got[1] - b) < ATOL


def test_clip_grad_norm_uses_the_jax_factor():
    acc, model, opt, data, loader = _setup()
    batch = next(iter(loader))
    acc.backward(regression_loss, batch)
    grads = torch.stack([model.a.grad, model.b.grad]).clone()
    norm = acc.clip_grad_norm_(model.parameters(), max_norm=0.5)
    torch.testing.assert_close(norm, grads.norm().to(norm.dtype))
    factor = min(1.0, 0.5 / (grads.norm().item() + 1e-6))
    torch.testing.assert_close(torch.stack([model.a.grad, model.b.grad]), grads * factor)
    acc.clip_grad_value_(model.parameters(), clip_value=0.1)
    assert model.a.grad.abs().item() <= 0.1 and model.b.grad.abs().item() <= 0.1


def test_zero_grad_is_a_no_op_mid_accumulation():
    acc, model, opt, data, loader = _setup(accum=2)
    batches = iter(loader)
    with acc.accumulate(model):
        acc.backward(regression_loss, next(batches))
        opt.step()
        opt.zero_grad()
    assert not acc.sync_gradients and opt.step_was_skipped
    first = model.a.grad.clone()
    with acc.accumulate(model):
        acc.backward(regression_loss, next(batches))
        assert acc.sync_gradients
        assert not torch.equal(model.a.grad, first)  # summed onto the first micro-batch


def _fp16_setup(**kw):
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      kwargs_handlers=[GradScalerKwargs(init_scale=2.0 ** 4, growth_interval=2)], **kw)
    model = Regression(dtype=torch.float32)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    model, opt = acc.prepare(model, opt)
    return acc, model, opt


def _fp16_batch(bad=False):
    x = torch.tensor([1.0, 2.0, float("inf") if bad else 3.0])
    return {"x": x, "y": 2.0 * x + 3.0}


def test_fp16_dynamic_scale_skips_a_step_on_inf_eager():
    acc, model, opt = _fp16_setup()
    assert isinstance(model, MixedPrecisionModule) and unwrap_model(model).a.dtype == torch.float32
    acc.backward(regression_loss, _fp16_batch(bad=True))
    opt.step()
    opt.zero_grad()
    assert opt.step_was_skipped and model.module.a.item() == 0.0
    assert acc.scaler.scale == 2.0 ** 3  # backoff
    for _ in range(2):
        acc.backward(regression_loss, _fp16_batch())
        opt.step()
        opt.zero_grad()
    assert not opt.step_was_skipped and model.module.a.item() != 0.0
    assert acc.scaler.scale == 2.0 ** 4  # two finite steps: growth


def test_fp16_dynamic_scale_skips_a_step_on_inf_train_step():
    acc, model, opt = _fp16_setup()
    step = acc.train_step(regression_loss, max_grad_norm=1.0)
    step(_fp16_batch(bad=True))
    assert opt.step_was_skipped and model.module.a.item() == 0.0 and not opt.optimizer.state
    assert acc.scaler.scale == 2.0 ** 3
    loss = step(_fp16_batch())
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert not opt.step_was_skipped and model.module.a.item() != 0.0
    assert model.module.a.grad is None  # zeroed after the update


def test_dynamic_scale_rule():
    scale = DynamicScale(init_scale=8.0, growth_factor=2.0, backoff_factor=0.5, growth_interval=3)
    for finite, expected in [(True, 8.0), (True, 8.0), (True, 16.0), (False, 8.0), (True, 8.0)]:
        scale.update(finite)
        assert scale.scale == expected


def test_bf16_policy_wraps_plain_modules_and_keeps_f32_masters():
    acc = Accelerator(cpu=True, mixed_precision="bf16")
    lin = nn.Linear(4, 3)
    opt = torch.optim.SGD(lin.parameters(), lr=LR)
    model, opt = acc.prepare(lin, opt)
    assert isinstance(model, MixedPrecisionModule) and acc.unwrap_model(model, keep_fp32_wrapper=False) is lin
    x = torch.randn(2, 4)
    out = model(x.to(torch.bfloat16))
    assert out.dtype == torch.float32  # outputs in the policy's output dtype
    torch.testing.assert_close(out, lin(x).to(torch.bfloat16).float(), atol=3e-2, rtol=3e-2)
    out.sum().backward()
    assert lin.weight.dtype == torch.float32 and lin.weight.grad.dtype == torch.float32


def test_llama_casts_per_use_and_is_not_wrapped():
    from accelerate_tpu_torch.models.llama import LlamaConfig, create_llama

    acc = Accelerator(cpu=True, mixed_precision="bf16")
    model = create_llama(LlamaConfig.tiny(), seed=0, device="cpu")
    assert acc.prepare(model) is model


def test_data_loader_shuffles_like_the_jax_sampler_and_flags_the_end():
    assert list(SeedableRandomSampler(20, seed=3)) == list(JSampler(20, seed=3))
    data = {"ids": np.arange(20, dtype=np.int32).reshape(10, 2)}
    loader = prepare_data_loader(data, device="cpu", batch_size=4, shuffle=True, seed=3)
    order = list(SeedableRandomSampler(10, seed=3))
    seen, ends = [], []
    for batch in loader:
        assert isinstance(batch["ids"], torch.Tensor) and batch["ids"].dtype == torch.int32
        seen.extend((batch["ids"][:, 0] // 2).tolist())
        ends.append(loader.end_of_dataloader)
        assert GradientState().active_dataloader is loader
    assert seen == order and ends == [False, False, True] and len(loader) == 3
    assert GradientState().active_dataloader is None


def test_what_waits_for_the_distributed_slice_raises():
    # the data-parallel dims, tensor and expert parallelism landed
    # (tests/test_torch_distributed_train.py, test_torch_tensor_parallel.py,
    # test_torch_ep.py); cp/sp/pp wait for A11
    for axis, item in (("cp", "A11"), ("sp", "A11"), ("pp", "A11")):
        cfg = ParallelismConfig(**{f"{axis}_size": 2})
        cfg._infer_and_validate(2)
        with pytest.raises(NotImplementedError, match=rf"ROADMAP.md {item}\b"):
            data_parallel_layout(cfg)
    for sizes, layout in ((dict(tp_size=2), "tp"), (dict(tp_size=2, dp_shard_size=2), "tp_fsdp"),
                          (dict(tp_size=2, dp_replicate_size=2), "tp_hsdp"),
                          (dict(ep_size=2), "ep"), (dict(ep_size=2, dp_shard_size=2), "ep_fsdp"),
                          (dict(ep_size=2, dp_replicate_size=2), "ep_hsdp")):
        cfg = ParallelismConfig(**sizes)
        cfg._infer_and_validate(cfg.total_size)
        assert data_parallel_layout(cfg) == layout
    for hook, match in (("powersgd", r"PowerSGD.*ROADMAP.md A11"), ("bf16", "gradient-compression")):
        AcceleratorState._reset_state(reset_partial_state=True)
        acc = Accelerator(cpu=True, kwargs_handlers=[DistributedDataParallelKwargs(comm_hook=hook)])
        model = Regression()
        acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR))
        with pytest.raises(NotImplementedError, match=match):
            acc.train_step(regression_loss)
    # the multi-step callable keeps the comm-hook refusal of the single step
    with pytest.raises(NotImplementedError, match="gradient-compression"):
        acc.train_step(regression_loss, multi_step=True)
    # the data path (A5) landed: a torch DataLoader is unwrapped, not refused
    prepared = acc.prepare_data_loader(torch.utils.data.DataLoader(range(8), batch_size=4))
    assert [b.tolist() for b in prepared] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    # A7's durability half landed: replicas are configured, and elastic
    # resume too (a missing directory is a first launch)
    from accelerate_tpu_torch.utils.dataclasses import ReplicationConfig

    AcceleratorState._reset_state(reset_partial_state=True)
    replicated = Accelerator(cpu=True, replication_config=ReplicationConfig(target="/r"))
    assert replicated.replication_config.target == "/r" and replicated._get_replicator() is not None
    assert acc.resume_from_latest("/nonexistent", elastic=True) is False
    # a scheduler is one device's business: prepared, not refused
    assert isinstance(acc.prepare(torch.optim.lr_scheduler.StepLR(
        torch.optim.SGD(model.parameters(), lr=LR), 1)), AcceleratedScheduler)


def test_refusals_name_their_queue_items(tmp_path):
    acc = Accelerator(cpu=True)
    model = Regression()
    _, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR))
    # A9 (multi_step) landed: N steps in one call, one loss each
    data = make_data(8)
    losses = acc.train_step(regression_loss, multi_step=True)(
        {k: torch.from_numpy(v).reshape(4, 2) for k, v in data.items()})
    assert losses.shape == (4,) and bool(torch.isfinite(losses).all()) and opt._step_count == 4
    # A5 (the data path) landed: a torch DataLoader and an iterable of ready
    # batches are prepared, and no refusal in the port names A5 or A6 any more
    loader = prepare_data_loader(torch.utils.data.DataLoader(range(8), batch_size=4), device="cpu")
    assert [b.tolist() for b in loader] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    ready = prepare_data_loader(iter([{"x": np.zeros(2)}]), batch_size=2, device="cpu")
    assert [b["x"].tolist() for b in ready] == [[0.0, 0.0]]
    import pathlib

    port = pathlib.Path(__file__).resolve().parents[1] / "accelerate_tpu_torch"
    named = [str(f) for f in port.rglob("*.py")
             if "ROADMAP.md A5" in f.read_text() or "ROADMAP.md A6" in f.read_text()]
    assert named == []
    # A4's scheduler landed: it wraps the prepared optimizer and steps with it
    sched = acc.prepare(torch.optim.lr_scheduler.StepLR(opt.optimizer, 1, gamma=0.5))
    assert isinstance(sched, AcceleratedScheduler) and sched.optimizer is opt
    acc.train_step(regression_loss)({k: torch.from_numpy(v[:2]) for k, v in data.items()})
    sched.step()
    assert sched.step_count == 1 and sched.get_last_lr() == [LR * 0.5]
    # A7 landed (data parallelism, tensor parallelism, the launch
    # supervisor, replicas); what stays names A11, and --pod has no
    # counterpart
    from accelerate_tpu_torch.commands import launch
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.parallel import tp as ttp
    from accelerate_tpu_torch.parallelism_config import refuse_queued_dims
    from accelerate_tpu_torch.utils.dataclasses import FSDPPlugin, ServingConfig

    refuse_queued_dims({"tp": 2})
    refuse_queued_dims({"ep": 2})
    for axis, item in (("cp", "A11"), ("sp", "A11"), ("pp", "A11")):
        with pytest.raises(NotImplementedError, match=rf"ROADMAP.md {item}\b"):
            refuse_queued_dims({axis: 2})
    with pytest.raises(NotImplementedError, match=r"MoE under tensor parallelism.*ROADMAP.md A11\b"):
        refuse_queued_dims({"ep": 2, "tp": 2})
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md A11\b"):
        ttp.tensor_parallel_rules(layer_axis="pp")
    with pytest.raises(ValueError, match=r"num_key_value_heads.*ROADMAP.md A11\b"):
        ttp.check_tp_divides(tl.LlamaConfig.tiny(), 4)
    with pytest.raises(NotImplementedError, match=r"alternating.*ROADMAP.md A11\b"):
        tl.LlamaForCausalLM(tl.LlamaConfig.gemma2_9b(num_hidden_layers=1), {})
    for argv in (["--max_restarts", "1"], ["--watchdog_timeout", "5"], ["--handle_preemption"],
                 ["--replicate_to", "/r"], ["--replicate_copies", "2"]):
        assert launch.main([*argv, "--dry_run", "script.py"]) == 0
    with pytest.raises(NotImplementedError, match="--pod"):
        launch.main(["--pod", "p", "--dry_run", "script.py"])
    from accelerate_tpu_torch.utils.dataclasses import ReplicationConfig

    AcceleratorState._reset_state(reset_partial_state=True)
    assert Accelerator(cpu=True, kwargs_handlers=[ReplicationConfig(target="/r", copies=2)]
                       ).replication_config.copies == 2
    port = pathlib.Path(__file__).resolve().parents[1] / "accelerate_tpu_torch"
    assert [str(f) for f in port.rglob("*.py") if "ROADMAP.md A7" in f.read_text()] == []
    # sharding rules landed with tensor parallelism: (regex, dim) pairs
    assert FSDPPlugin(sharding_rules=[(".*norm", None)]).sharding_rules == [(".*norm", None)]
    with pytest.raises(TypeError, match=r"\(regex, dim\)"):
        FSDPPlugin(sharding_rules=[(".*", object())])
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md A11\b"):
        FSDPPlugin(cpu_offload=True)
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, kwargs_handlers=[DistributedDataParallelKwargs(comm_hook="powersgd")])
    model = Regression()
    acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR))
    with pytest.raises(NotImplementedError, match=r"PowerSGD.*ROADMAP.md A11\b"):
        acc.train_step(regression_loss)
    # C5: ServingConfig takes every JAX field: the breaker, the ladder and
    # the tracker interval take any valid value (and refuse an invalid one
    # as the JAX config does); nothing refuses as "not ported"
    for name, value in CONTROL_SERVING.items():
        assert getattr(ServingConfig(**{name: value}), name) == value
        if name == "metrics_interval_s":
            continue  # any value: the JAX config checks none
        bad = 0.1 if name == "degrade_hard_fraction" else 0
        for config_cls in (ServingConfig, jdc.ServingConfig):
            with pytest.raises(ValueError, match=name):
                config_cls(**{name: bad})
    # static mode landed with A8: its batching and retry knobs take any
    # valid value, and the slot engine's options name the mode they need
    lifted = dict(max_batch_size=3, batch_window_s=0.5, batch_bucket=False,
                  pad_total_multiple=7, max_retries=5, retry_backoff_s=0.5,
                  retry_backoff_max_s=4.0, retry_jitter=1.0)
    assert dataclasses.asdict(ServingConfig(mode="static", **lifted)).items() >= lifted.items()
    with pytest.raises(ValueError, match="requires mode='continuous'"):
        ServingConfig(speculative="ngram")
    ServingConfig(mode="continuous", speculative="ngram")
    # A8 landed (prepare_inference(mesh=, rules=), generate and the static
    # server over a mesh), and A8-bis (the continuous engine over a model
    # laid out over a mesh): no refusal names either, and the engine runs
    # a laid model as it runs the model itself
    import re

    from accelerate_tpu_torch.engine import ContinuousBatchingEngine

    assert [str(f) for f in port.rglob("*.py")
            if re.search(r"ROADMAP\.md A8\b", f.read_text())] == []
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from accelerate_tpu_torch.big_modeling import dispatch_model
    from accelerate_tpu_torch.parallel.tp import tensor_parallel_rules

    # a one-rank group of this test's own, unless one is running already
    started = not dist.is_initialized()
    if started:
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    assert dist.get_world_size() == 1
    try:  # a one-rank mesh: tp blocks of one, as dispatch_model lays them
        mesh = init_device_mesh("cpu", (1, 1, 1), mesh_dim_names=("dp_replicate", "dp_shard", "tp"))
        tiny = tl.LlamaConfig.tiny(compute_dtype=torch.float32)
        laid = dispatch_model(tl.LlamaForCausalLM.from_seed(tiny, device="cpu"), mesh=mesh,
                              rules=tensor_parallel_rules())
        prompt = np.arange(3, 10, dtype=np.int32)

        def engine_tokens(model):
            eng = ContinuousBatchingEngine(model, slots=2, max_len=32, device="cpu")
            occ = eng.insert(prompt, max_new_tokens=5)
            eng.drain()
            return occ.tokens

        assert engine_tokens(laid) == engine_tokens(
            tl.LlamaForCausalLM.from_seed(tiny, device="cpu"))
        # A3-bis landed (A3 over a mesh): the host tier, remote prefill,
        # reservations and commits run on a laid model as on the model itself
        def a3_tokens(model):
            eng = ContinuousBatchingEngine(model, slots=2, max_len=32, kv_cache="paged",
                                           host_tier_bytes=1 << 20, device="cpu")
            slot, epoch = eng.reserve_slot()
            assert eng.release_reservation(slot, epoch)
            occ = eng.insert_prefilled(eng.prefill_remote(prompt, max_new_tokens=4))
            eng.drain()
            return occ.tokens, eng.stats()["kv"]["host_tier_capacity_bytes"]

        assert a3_tokens(laid) == a3_tokens(tl.LlamaForCausalLM.from_seed(tiny, device="cpu"))
        assert [str(f) for f in port.rglob("*.py") if "A3-bis" in f.read_text()] == []
    finally:
        if started:
            dist.destroy_process_group()
    # A3's ServingConfig fields take any valid value now, and no refusal in
    # the port names A3 itself
    assert ServingConfig(mode="continuous", kv_cache="paged", kv_host_tier_bytes=1 << 20,
                         kv_prefetch=False).kv_host_tier_bytes == 1 << 20
    assert [str(f) for f in port.rglob("*.py") if re.search(r"ROADMAP\.md A3\b(?!-bis)",
                                                            f.read_text())] == []
    # A4's fp8 landed: mixed_precision="fp8" runs (ops/fp8.py), and no
    # refusal names A4
    AcceleratorState._reset_state(reset_partial_state=True)
    acc = Accelerator(cpu=True, mixed_precision="fp8")
    assert acc.mixed_precision == "fp8" and acc.fp8_backend == "NATIVE"
    model = acc.prepare(tl.create_llama(tl.LlamaConfig.tiny(compute_dtype=torch.float32),
                                        device="cpu"))
    assert model.config.use_fp8
    assert [str(f) for f in port.rglob("*.py") if re.search(r"ROADMAP\.md A4\b", f.read_text())] == []
    # A10 landed whole (the serving half, then the SLO controller and the
    # chaos conductor): nothing in the port names it
    assert [str(f) for f in port.rglob("*.py") if re.search(r"\bA10\b", f.read_text())] == []


# C5's serving control-plane fields, each with a valid value other than its
# default
CONTROL_SERVING = {"breaker_threshold": 7, "breaker_reset_s": 0.5, "degrade_queue_fraction": 0.25,
               "degrade_hard_fraction": 0.9, "degraded_max_new_tokens": 4,
               "metrics_interval_s": 0.5}


def test_serving_config_takes_every_field_of_the_jax_config():
    from accelerate_tpu_torch.utils.dataclasses import ServingConfig

    jax_fields = {f.name: f.default for f in dataclasses.fields(jdc.ServingConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(ServingConfig)}
    # the defaults too: mode="static", as in the JAX package, since A8
    assert ours == jax_fields and ours["mode"] == "static"


# ------------------------------------------------------- C4: JAX's arguments
def test_device_placement_rng_types_and_evaluation_mode():
    acc = Accelerator(cpu=True, device_placement=False, rng_types=["torch"])
    data = make_data(8)
    model = Regression()
    model, opt, loader = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR),
                                     torch.utils.data.DataLoader(range(8), batch_size=4))
    assert loader.device is None  # batches stay on the host
    assert acc.prepare_data_loader(data, batch_size=4).device is None
    placed = acc.prepare_data_loader(data, batch_size=4, device_placement=True)
    assert placed.device == torch.device("cpu") and placed.rng_types == ["torch"]
    m2 = Regression()
    m2, dl = acc.prepare(m2, torch.utils.data.DataLoader(range(4), batch_size=2),
                         device_placement=[True, True])
    assert dl.device == torch.device("cpu")
    with pytest.raises(ValueError, match="device_placement"):
        acc.prepare(Regression(), device_placement=[True, False])
    evaluated = acc.prepare_model(Regression(), evaluation_mode=True)
    assert not evaluated.training
    wrapped = acc.prepare_optimizer(torch.optim.SGD(m2.parameters(), lr=LR), device_placement=True)
    assert wrapped.optimizer.param_groups[0]["params"][0] is m2.a


def test_clip_grad_norm_takes_the_l2_norm_type():
    acc = Accelerator(cpu=True)
    model = Regression()
    model, opt = acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR))
    batch = {k: torch.from_numpy(v) for k, v in make_data(4).items()}
    acc.backward(regression_loss, batch)
    grads = [p.grad.clone() for p in (model.a, model.b)]
    norm = acc.clip_grad_norm_(model.parameters(), max_norm=1e-3, norm_type=2.0)
    assert torch.isclose(norm, torch.linalg.vector_norm(torch.stack(grads)))
    with pytest.raises(ValueError, match="norm_type"):
        acc.clip_grad_norm_(model.parameters(), max_norm=1.0, norm_type=1.0)


def test_init_empty_weights_include_buffers_and_sampler_generator():
    from accelerate_tpu_torch.big_modeling import init_empty_weights

    with init_empty_weights(include_buffers=False):
        norm = nn.BatchNorm1d(4)
    assert norm.weight.device.type == "meta" and norm.running_mean.device.type == "cpu"
    with init_empty_weights():
        norm = nn.BatchNorm1d(4)
    assert norm.weight.device.type == "meta" and norm.running_mean.device.type == "meta"
    gen = torch.Generator().manual_seed(1)
    assert list(SeedableRandomSampler(20, seed=3, generator=gen)) == list(JSampler(20, seed=3))


# a JAX argument the port does not take, by function, and why: TPU-only
# knobs (block sizes, interpret mode, buffer donation, flat buffers), the
# queue item that brings it, or the port's name for the same argument
TPU = "TPU-only"
SIGNATURE_EXEMPT = {
    "accelerator:Accelerator.train_step": {"donate": TPU, "flatten_params": TPU},
    "kvcache:PagedKVLayout.commit_window": {"layer_cache": "renamed cache_leaf"},
    "models.llama:create_llama": {"abstract": "init_empty_weights builds it empty"},
    "models.llama:init_llama_params": {"key": "renamed generator (a torch.Generator)"},
    "models.llama:llama_apply": {"position_offset": "A11", "attention_fn": "A11",
                                 "layer_stack_fn": "A11"},
    "models.llama:llama_flops_per_token": {"include_remat": "a no-op in the JAX package"},
    "models.llama:llama_loss": {"model_view": "renamed model"},
    "ops.attention:dispatch_attention": {"block_q": TPU},
    "parallel.mesh:build_mesh": {"devices": "a mesh spans the process group, one device a rank",
                                 "allow_split_physical_axes": TPU},
    "ops.attention:dot_product_attention": {"bias": "A11", "kv_offset": "A11",
                                            "softmax_dtype": "f32 always, the JAX default"},
    "ops.attention:paged_attention": {"softmax_dtype": "f32 always, the JAX default"},
    "ops.attention:verify_attention": {"softmax_dtype": "f32 always, the JAX default"},
    "ops.fp8:fp8_rewrite": {"fn": "renamed module (a torch module, rewritten in place)"},
    "ops.flash_attention:flash_attention": {"block_q": TPU, "block_k": TPU, "interpret": TPU},
    "ops.flash_attention:flash_attention_with_lse": {"block_q": TPU, "block_k": TPU,
                                                     "interpret": TPU},
    "ops.paged_decode:fused_sample": {"interpret": TPU},
    "ops.paged_decode:paged_flash_decode": {"interpret": TPU},
    "ops.paged_decode:paged_flash_verify": {"interpret": TPU},
    "ops.quant_matmul:quantized_matmul": {"block_m": TPU, "block_n": TPU, "interpret": TPU},
    "utils.quantization:quantize_model": {"model": "renamed module"},
}


def _shared_signatures():
    """``{"module:qualname": (port function, JAX function)}`` of every
    public function and method both packages define under one name."""
    import importlib
    import inspect
    import pkgutil

    import accelerate_tpu_torch

    pairs = {}
    for info in pkgutil.walk_packages(accelerate_tpu_torch.__path__, "accelerate_tpu_torch."):
        short = info.name[len("accelerate_tpu_torch."):]
        if short.split(".")[0] in ("commands", "test_utils"):
            continue  # the JAX package's need jax and a TPU config
        try:
            jmod = importlib.import_module("accelerate_tpu." + short)
        except ImportError:
            continue
        tmod = importlib.import_module(info.name)
        for name, obj in vars(tmod).items():
            jobj = getattr(jmod, name, None)
            if name.startswith("_") or jobj is None or getattr(obj, "__module__", None) != info.name:
                continue
            if inspect.isfunction(obj) and callable(jobj):
                pairs[f"{short}:{name}"] = (obj, jobj)
            elif inspect.isclass(obj) and inspect.isclass(jobj):
                for meth, fn in vars(obj).items():
                    jfn = getattr(jobj, meth, None)
                    if (meth == "__init__" or not meth.startswith("_")) and inspect.isfunction(fn) \
                            and inspect.isfunction(jfn):
                        pairs[f"{short}:{name}.{meth}"] = (fn, jfn)
    return pairs


def test_shared_functions_take_every_argument_of_the_jax_package():
    import inspect

    pairs = _shared_signatures()
    assert len(pairs) > 150 and set(SIGNATURE_EXEMPT) <= set(pairs)
    # the control plane's modules are held too: the SLO controller, the
    # chaos conductor and monitors, their config and fail-static finding
    assert {"controller:SLOController.__init__", "controller:SLOController.tick",
            "controller:ControlSignals.__init__", "chaos:ChaosRule.__init__",
            "chaos:ChaosSchedule.__init__", "chaos:ChaosConductor.__init__",
            "chaos:ChaosConductor.replay", "chaos:InvariantMonitors.__init__",
            "chaos:InvariantMonitors.check", "chaos:phase_windows",
            "utils.dataclasses:ControllerConfig.__init__",
            "utils.fault:ControllerStaleError.__init__"} <= set(pairs)
    for label, (fn, jfn) in sorted(pairs.items()):
        ours = inspect.signature(fn).parameters
        if any(p.kind == p.VAR_KEYWORD for p in ours.values()):
            continue  # **kwargs takes any name
        theirs = inspect.signature(jfn).parameters
        missing = {n for n, p in theirs.items() if n not in ours and not n.startswith("_")
                   and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)}
        exempt = SIGNATURE_EXEMPT.get(label, {})
        assert missing == set(exempt), (label, missing)
        for arg, why in exempt.items():
            if why.startswith("renamed "):
                assert why.split()[1] in ours, (label, arg)


@pytest.mark.parametrize("name", ["GradientAccumulationPlugin", "GradScalerKwargs"])
def test_kwargs_classes_take_every_field_of_the_jax_package(name):
    jax_fields = {f.name: f.default for f in dataclasses.fields(getattr(jdc, name))}
    ours = {f.name: f.default for f in dataclasses.fields(GradientAccumulationPlugin if name ==
                                                           "GradientAccumulationPlugin"
                                                           else GradScalerKwargs)}
    assert ours == jax_fields


def test_accumulation_fields_of_one_device():
    # sync_each_batch: one device has no cross-device reduction to defer,
    # so both settings give the same parameters; adjust_scheduler changes
    # nothing, as in the JAX package (tests/test_torch_scheduler.py)
    finals = []
    for sync_each_batch in (False, True):
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        plugin = GradientAccumulationPlugin(num_steps=2, sync_each_batch=sync_each_batch,
                                            adjust_scheduler=False)
        acc = Accelerator(cpu=True, gradient_accumulation_plugin=plugin)
        model = Regression()
        opt = torch.optim.SGD(model.parameters(), lr=LR)
        model, opt = acc.prepare(model, opt)
        step = acc.train_step(regression_loss)
        data = make_data(8)
        for i in range(4):
            step({k: torch.from_numpy(v[2 * i:2 * i + 2]) for k, v in data.items()})
        finals.append((model.a.item(), model.b.item()))
    assert finals[0] == finals[1] and finals[0] != (0.0, 0.0)


def test_grad_scaler_disabled_trains_fp16_without_scaling():
    acc, model, opt = _fp16_setup()
    assert acc.scaler is not None
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      kwargs_handlers=[GradScalerKwargs(init_scale=2.0 ** 4, enabled=False)])
    model = Regression(dtype=torch.float32)
    opt = torch.optim.SGD(model.parameters(), lr=LR)
    model, opt = acc.prepare(model, opt)
    assert acc.scaler is None
    loss = acc.train_step(regression_loss)(_fp16_batch())
    assert torch.isfinite(loss) and not opt.step_was_skipped and model.module.a.item() != 0.0
