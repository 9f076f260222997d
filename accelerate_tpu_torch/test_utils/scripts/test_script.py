"""End-to-end sanity script (counterpart of
``accelerate_tpu/test_utils/scripts/test_script.py``): process control,
loader sharding, seedable shuffling, training parity and triggers, on
however many processes it was launched with:

    python -m accelerate_tpu_torch.commands.launch --cpu --num_processes 2 \\
        accelerate_tpu_torch/test_utils/scripts/test_script.py

``training_check`` is the reference's (atol 1e-6): a regression trained
through ``prepare``/``accumulate``/``backward`` on every process's rows,
against the same SGD by hand on the whole batch in one process;
``llama_check`` holds a tiny Llama's ``train_step`` under the launched
layout (DDP, FSDP2 or HSDP) to the same bound, with uneven token counts.
"""

from __future__ import annotations

import numpy as np
import torch

ATOL = 1e-6


def process_control_check(accelerator):
    assert accelerator.process_index < accelerator.num_processes
    accelerator.wait_for_everyone("accelerate_tpu_torch.test_script.process_control")
    # ceil(10 / n) items a process, the last ones padded with the last item
    with accelerator.split_between_processes(list(range(10)), apply_padding=True) as chunk:
        assert len(chunk) == -(-10 // accelerator.num_processes), chunk
    accelerator.print("process control ok")


def dl_shard_check(accelerator):
    rows = 8 * accelerator.num_processes
    data = {"x": np.arange(float(rows))[:, None]}
    loader = accelerator.prepare_data_loader(data, batch_size=4, drop_last=True)
    seen = [batch["x"] for batch in loader]
    assert len(seen) == 2 and all(b.shape[0] == 4 for b in seen)
    total = accelerator.gather(torch.cat(seen)).ravel().tolist()
    assert sorted(total) == list(np.arange(float(rows))), total
    accelerator.print("dataloader sharding ok")


def seedable_sampler_check(accelerator):
    from accelerate_tpu_torch.data_loader import SeedableRandomSampler

    a = list(SeedableRandomSampler(32, seed=1, epoch=0))
    assert accelerator.state.gather_object(a) == [a] * accelerator.num_processes
    accelerator.print("seedable sampler ok")


class _Regression(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Parameter(torch.zeros((), dtype=torch.float64))
        self.b = torch.nn.Parameter(torch.zeros((), dtype=torch.float64))

    def forward(self, x):
        return self.a * x + self.b


def _regression_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def training_check(accelerator):
    """Data-parallel training equals one process's SGD on the whole batch
    (atol 1e-6): 16-row global batches, split evenly over the processes."""
    if 16 % accelerator.num_processes:
        accelerator.print(f"training parity skipped: 16 rows do not split over "
                          f"{accelerator.num_processes} processes")
        return
    rng = np.random.default_rng(0)
    x = rng.normal(size=64)
    data = {"x": x, "y": 2.0 * x + 3.0 + 0.1 * rng.normal(size=64)}
    model = _Regression()
    optimizer = torch.optim.SGD(model.parameters(), lr=0.1)
    loader = accelerator.prepare_data_loader(data, batch_size=16 // accelerator.num_processes,
                                             drop_last=True)
    model, optimizer = accelerator.prepare(model, optimizer)
    for batch in loader:
        with accelerator.accumulate(model):
            accelerator.backward(_regression_loss, batch)
            optimizer.step()
            optimizer.zero_grad()
    a, b = 0.0, 0.0
    for i in range(0, 64, 16):
        bx, by = x[i:i + 16], data["y"][i:i + 16]
        r = a * bx + b - by
        a, b = a - 0.1 * np.mean(2 * r * bx), b - 0.1 * np.mean(2 * r)
    inner = accelerator.unwrap_model(model, keep_fp32_wrapper=False)
    got = (inner.a.item(), inner.b.item())
    assert abs(got[0] - a) < ATOL and abs(got[1] - b) < ATOL, (got, (a, b))
    accelerator.print("training parity ok")


def llama_check(accelerator):
    """A 2-layer f32 Llama's data-parallel ``train_step`` (3 updates of SGD
    with momentum, ``max_grad_norm=1.0``, ranks given different valid-token
    counts) equals the same updates by hand on the whole batch in this
    process (atol and rtol 1e-6): the global loss, its gradient and one
    clipping factor. SGD keeps the ranks' other summation order at rounding
    size; AdamW divides each gradient by its own size, and on four cards
    moved one embedding element whose gradient was near its epsilon by
    2e-6."""
    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.optimizer import clip_grads_by_norm

    n, rank = accelerator.num_processes, accelerator.process_index
    rows = 2 * n
    # head_dim 64: the flash kernels take 64 or 128 on the card
    cfg = tl.LlamaConfig.tiny(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
                              compute_dtype=torch.float32, attention_impl="flash")
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(3):
        mask = np.ones((rows, 15), np.float32)
        mask[rows // 2:, 4:] = 0  # the later ranks' rows keep 4 of 15 tokens
        batches.append({"input_ids": torch.from_numpy(rng.integers(0, 256, (rows, 16))),
                        "loss_mask": torch.from_numpy(mask)})
    ref = tl.create_llama(cfg, seed=2, device=accelerator.device)
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1, momentum=0.9)
    ref_losses = []
    for batch in batches:
        loss = tl.llama_loss(ref, {k: v.to(accelerator.device) for k, v in batch.items()})
        loss.backward()
        clip_grads_by_norm([p.grad for p in ref.parameters()], 1.0)
        ref_opt.step()
        ref_opt.zero_grad()
        ref_losses.append(loss.item())
    model = tl.create_llama(cfg, seed=2, device=accelerator.device)
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    model, opt = accelerator.prepare(model, opt)
    step = accelerator.train_step(tl.llama_loss, model=model, optimizer=opt, max_grad_norm=1.0)
    losses = [step({k: v[2 * rank:2 * rank + 2].to(accelerator.device) for k, v in b.items()}).item()
              for b in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=ATOL, atol=ATOL)
    state = accelerator.get_state_dict(model)
    for key, want in accelerator.get_state_dict(ref).items():
        np.testing.assert_allclose(state[key].cpu().numpy(), want.cpu().numpy(), rtol=ATOL,
                                   atol=ATOL, err_msg=key)
    accelerator.print(f"llama parity ok ({accelerator.layout}, losses {losses})")
    checkpoint_check(accelerator, model, opt, cfg)


def checkpoint_check(accelerator, model, opt, cfg):
    """``save_state`` of the trained Llama and ``load_state`` into a fresh
    one under the same layout: parameters and optimizer state bitwise."""
    import shutil
    import tempfile

    from accelerate_tpu_torch.models import llama as tl
    from accelerate_tpu_torch.ops.operations import broadcast_object_list

    path = [tempfile.mkdtemp(prefix="test_script_") if accelerator.is_main_process else None]
    path = broadcast_object_list(path, from_process=0)[0]
    accelerator.save_state(path)
    fresh = tl.create_llama(cfg, seed=3, device=accelerator.device)
    fresh_opt = torch.optim.SGD(fresh.parameters(), lr=0.1, momentum=0.9)
    fresh, fresh_opt = accelerator.prepare(fresh, fresh_opt)
    accelerator._models.remove(model)
    accelerator._optimizers.remove(opt)
    accelerator.load_state(path)
    want, got = accelerator.get_state_dict(model), accelerator.get_state_dict(fresh)
    assert all(torch.equal(want[k], got[k]) for k in want), "parameters differ after load_state"
    for a, b in zip(opt.params(), fresh_opt.params()):
        sa, sb = opt.optimizer.state[a], fresh_opt.optimizer.state[b]
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    accelerator.wait_for_everyone()
    if accelerator.is_main_process:
        shutil.rmtree(path, ignore_errors=True)
    accelerator.print("checkpoint ok")


def trigger_check(accelerator):
    if accelerator.is_main_process:
        accelerator.set_trigger()
    assert accelerator.check_trigger()
    assert not accelerator.check_trigger()
    accelerator.print("trigger ok")


def main():
    from accelerate_tpu_torch import Accelerator

    accelerator = Accelerator()
    accelerator.print(f"Running sanity checks on {accelerator!r}")
    process_control_check(accelerator)
    dl_shard_check(accelerator)
    seedable_sampler_check(accelerator)
    training_check(accelerator)
    llama_check(accelerator)
    trigger_check(accelerator)
    accelerator.print("All checks passed")


if __name__ == "__main__":
    main()
