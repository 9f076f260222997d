"""The port's ``Accelerator`` semantics on the CPU (``cpu=True``): the eager
``backward``/``step``/``zero_grad`` loop against ``train_step``, the
``sync_gradients`` pattern of gradient accumulation and the forced sync at
the end of the data loader (the JAX package's ``tests/test_accelerator.py``
pins the same patterns), gradient clipping, fp16 loss scaling skipping a
step on non-finite gradients, the mixed-precision wrapper, the data loader,
and the refusals of what waits for the distributed slice.

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
    with pytest.raises(NotImplementedError, match="distributed slice"):
        Accelerator(cpu=True, parallelism_config=object())
    for hook, match in (("powersgd", "PowerSGD"), ("bf16", "gradient-compression")):
        AcceleratorState._reset_state(reset_partial_state=True)
        acc = Accelerator(cpu=True, kwargs_handlers=[DistributedDataParallelKwargs(comm_hook=hook)])
        model = Regression()
        acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR))
        with pytest.raises(NotImplementedError, match=match):
            acc.train_step(regression_loss)
    with pytest.raises(NotImplementedError, match="multi_step"):
        acc.train_step(regression_loss, multi_step=True)
    with pytest.raises(NotImplementedError, match="torch DataLoader"):
        acc.prepare_data_loader(torch.utils.data.DataLoader(range(8), batch_size=4))
    with pytest.raises(NotImplementedError):
        acc.prepare(torch.optim.lr_scheduler.StepLR(torch.optim.SGD(model.parameters(), lr=LR), 1))


def test_refusals_name_their_queue_items():
    acc = Accelerator(cpu=True)
    model = Regression()
    acc.prepare(model, torch.optim.SGD(model.parameters(), lr=LR))
    with pytest.raises(NotImplementedError, match=r"CUDA graphs \(ROADMAP.md A9\)"):
        acc.train_step(regression_loss, multi_step=True)
    with pytest.raises(NotImplementedError, match=r"data path \(ROADMAP.md A5\)"):
        prepare_data_loader(torch.utils.data.DataLoader(range(8), batch_size=4), device="cpu")
    with pytest.raises(NotImplementedError, match=r"data path \(ROADMAP.md A5\)"):
        prepare_data_loader(iter([{"x": np.zeros(2)}]), batch_size=2, device="cpu")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md A4"):
        acc.prepare(torch.optim.lr_scheduler.StepLR(torch.optim.SGD(model.parameters(), lr=LR), 1))


@pytest.mark.parametrize("name", ["GradientAccumulationPlugin", "GradScalerKwargs"])
def test_kwargs_classes_take_every_field_of_the_jax_package(name):
    jax_fields = {f.name: f.default for f in dataclasses.fields(getattr(jdc, name))}
    ours = {f.name: f.default for f in dataclasses.fields(GradientAccumulationPlugin if name ==
                                                           "GradientAccumulationPlugin"
                                                           else GradScalerKwargs)}
    assert ours == jax_fields


def test_accumulation_fields_of_one_device():
    # sync_each_batch: one device has no cross-device reduction to defer,
    # so both settings give the same parameters; adjust_scheduler is
    # accepted and has nothing to act on while prepare refuses schedulers
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
