"""The port's ``AcceleratedScheduler`` against the JAX package's, on the
CPU: it steps only when the optimizer updated (gradient accumulation, fp16
skipped steps), a callable schedule sets the groups' ``lr`` the way an
optax optimizer built on it reads it, and an AdamW trajectory under a
schedule equals the JAX package's (optax) at slice 2's tolerances: losses
rtol 1e-4, parameters atol 2e-5 (a two-parameter regression in f32 keeps
every gradient far from zero, so no element needs Adam's looser hold).
"""

import numpy as np
import pytest
import torch
from torch import nn

import optax

from accelerate_tpu import Accelerator as JAccelerator
from accelerate_tpu.parallelism_config import ParallelismConfig
from accelerate_tpu.state import (
    AcceleratorState as JAcceleratorState,
    GradientState as JGradientState,
    PartialState as JPartialState,
)
from accelerate_tpu.test_utils.training import RegressionModel, make_regression_data
from accelerate_tpu.test_utils.training import regression_loss as j_regression_loss
from accelerate_tpu.utils.dataclasses import GradientAccumulationPlugin as JGradientAccumulationPlugin
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.scheduler import AcceleratedScheduler
from accelerate_tpu_torch.state import AcceleratorState, GradientState
from accelerate_tpu_torch.utils.dataclasses import GradientAccumulationPlugin, GradScalerKwargs

LOSS_RTOL = 1e-4
PARAM_ATOL = 2e-5


@pytest.fixture(autouse=True)
def fresh_state():
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    yield
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()


class Regression(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Parameter(torch.zeros(()))
        self.b = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return self.a * x + self.b


def regression_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def _loop(acc, model, optimizer, scheduler, loader):
    losses = []
    for batch in loader:
        with acc.accumulate(model):
            losses.append(acc.backward(regression_loss, batch).item())
            optimizer.step()
            optimizer.zero_grad()
            scheduler.step()
    return losses


def test_scheduler_steps_with_optimizer():
    # tests/test_accelerator.py::test_scheduler_steps_with_optimizer: 4
    # batches, accumulation 2 -> 2 updates -> the schedule stepped twice
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    model = Regression()
    schedule = optax.linear_schedule(0.1, 0.0, 10)
    optimizer = torch.optim.SGD(model.parameters(), lr=1.0)
    loader = acc.prepare_data_loader(make_regression_data(64), batch_size=16, drop_last=True)
    model, optimizer, scheduler = acc.prepare(model, optimizer, schedule)
    assert isinstance(scheduler, AcceleratedScheduler)
    assert optimizer.optimizer.param_groups[0]["lr"] == pytest.approx(float(schedule(0)))
    _loop(acc, model, optimizer, scheduler, loader)
    assert scheduler.step_count == 2
    assert scheduler.get_last_lr()[0] == pytest.approx(float(schedule(2)))
    assert optimizer.optimizer.param_groups[0]["lr"] == pytest.approx(float(schedule(2)))


def test_torch_lr_scheduler_steps_with_optimizer():
    acc = Accelerator(cpu=True, gradient_accumulation_steps=2)
    model = Regression()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda n: 0.5 ** n)
    loader = acc.prepare_data_loader(make_regression_data(64), batch_size=16, drop_last=True)
    model, optimizer, scheduler = acc.prepare(model, optimizer, sched)
    _loop(acc, model, optimizer, scheduler, loader)
    assert scheduler.step_count == 2 and sched.last_epoch == 2
    assert scheduler.get_last_lr() == pytest.approx([0.1 * 0.25])
    state = scheduler.state_dict()
    assert state["step_count"] == 2 and state["inner"]["last_epoch"] == 2


def _jax_schedule_run(schedule, data, adjust, with_optimizer):
    """The JAX package's scheduler under the same plugin, on the same data:
    its ``step_count`` and last learning rate."""
    JAcceleratorState._reset_state()
    JGradientState._reset_state()
    JPartialState._reset_state()
    try:
        plugin = JGradientAccumulationPlugin(num_steps=2, adjust_scheduler=adjust)
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=8),
                           gradient_accumulation_plugin=plugin,
                           step_scheduler_with_optimizer=with_optimizer)
        model, tx = RegressionModel(), optax.sgd(schedule)
        loader = acc.prepare_data_loader(data, batch_size=16, drop_last=True)
        model, tx, scheduler = acc.prepare(model, tx, schedule)
        for batch in loader:
            with acc.accumulate(model):
                acc.backward(j_regression_loss, batch)
                tx.step()
                tx.zero_grad()
                scheduler.step()
        return scheduler.step_count, scheduler.get_last_lr()[0]
    finally:
        JAcceleratorState._reset_state()
        JGradientState._reset_state()
        JPartialState._reset_state()


@pytest.mark.parametrize("adjust,with_optimizer", [(True, True), (False, True), (True, False)])
def test_adjust_scheduler_and_step_with_optimizer(adjust, with_optimizer):
    # the JAX package steps the schedule once per update whatever
    # adjust_scheduler says, and on every call without
    # step_scheduler_with_optimizer: the port must count the same steps
    schedule = lambda n: 0.1 / (1 + n)  # noqa: E731
    data = make_regression_data(64)
    jcount, jlr = _jax_schedule_run(schedule, data, adjust, with_optimizer)
    plugin = GradientAccumulationPlugin(num_steps=2, adjust_scheduler=adjust)
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=plugin,
                      step_scheduler_with_optimizer=with_optimizer)
    model = Regression()
    optimizer = torch.optim.SGD(model.parameters(), lr=1.0)
    loader = acc.prepare_data_loader(data, batch_size=16, drop_last=True)
    model, optimizer, scheduler = acc.prepare(model, optimizer, schedule)
    _loop(acc, model, optimizer, scheduler, loader)
    assert scheduler.step_count == jcount == (2 if with_optimizer else 4)
    assert scheduler.get_last_lr()[0] == pytest.approx(jlr)
    assert optimizer.optimizer.param_groups[0]["lr"] == pytest.approx(jlr)


def test_fp16_skipped_step_does_not_step_the_scheduler():
    acc = Accelerator(cpu=True, mixed_precision="fp16",
                      kwargs_handlers=[GradScalerKwargs(init_scale=2.0 ** 4)])
    model = Regression()
    optimizer = torch.optim.SGD(model.parameters(), lr=1.0)
    model, optimizer, scheduler = acc.prepare(model, optimizer, lambda n: 0.1 / (1 + n))
    for bad in (True, False):
        x = torch.tensor([1.0, 2.0, float("inf") if bad else 3.0])
        acc.backward(regression_loss, {"x": x, "y": 2.0 * x + 3.0})
        optimizer.step()
        optimizer.zero_grad()
        scheduler.step()
        assert optimizer.step_was_skipped == bad and scheduler.step_count == (0 if bad else 1)


def _jax_adamw_trajectory(schedule, data, accum):
    JAcceleratorState._reset_state()
    JGradientState._reset_state()
    JPartialState._reset_state()
    try:
        acc = JAccelerator(parallelism_config=ParallelismConfig(dp_shard_size=8),
                           gradient_accumulation_steps=accum)
        model, tx = RegressionModel(), optax.adamw(schedule, weight_decay=0.01)
        loader = acc.prepare_data_loader(data, batch_size=16, drop_last=True)
        model, tx, scheduler = acc.prepare(model, tx, schedule)
        losses = []
        for batch in loader:
            with acc.accumulate(model):
                losses.append(float(acc.backward(j_regression_loss, batch)))
                tx.step()
                tx.zero_grad()
                scheduler.step()
        return losses, (float(model.params["a"]), float(model.params["b"])), scheduler.step_count
    finally:
        JAcceleratorState._reset_state()
        JGradientState._reset_state()
        JPartialState._reset_state()


@pytest.mark.parametrize("accum", [1, 2])
def test_adamw_trajectory_under_a_schedule_matches_jax(accum):
    schedule = optax.warmup_cosine_decay_schedule(0.0, 0.2, 2, 8, end_value=0.01)
    data = make_regression_data(128, seed=3)
    jlosses, jparams, jcount = _jax_adamw_trajectory(schedule, data, accum)
    acc = Accelerator(cpu=True, gradient_accumulation_steps=accum)
    model = Regression()
    optimizer = torch.optim.AdamW(model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=0.01)
    loader = acc.prepare_data_loader(data, batch_size=16, drop_last=True)
    model, optimizer, scheduler = acc.prepare(model, optimizer, lambda n: float(schedule(n)))
    losses = _loop(acc, model, optimizer, scheduler, loader)
    assert scheduler.step_count == jcount == 8 // accum
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    np.testing.assert_allclose((model.a.item(), model.b.item()), jparams, rtol=0, atol=PARAM_ATOL)
