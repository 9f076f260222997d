"""The fine-tune that the durability scripts drive (``scripts/
crash_resume_script.py``, ``preemption_script.py``,
``elastic_recovery_script.py``, ``fault_save_script.py``): a Llama at the
tiny test size (``--preset tiny``, the default, on the CPU with ``--cpu``)
or at Llama-3-8B's widths (``--preset llama3_8b --layers L``, on the card:
bf16 compute over f32 master weights, B1-B3 on every step), AdamW,
``max_grad_norm=1.0`` through the eager loop (``accumulate``, ``backward``,
``clip_grad_norm_``, ``step``), automatic checkpoint naming under
``--project_dir``. Each step's global batch is ``--rows`` packed rows of
``--seq`` tokens from seeded documents (the native packer; segment ids,
positions that restart per document and the loss mask), the same for
every world size: each process takes its block of rows, so an
interrupted run and an uninterrupted one see the same data at each step.

``--weights`` loads the JAX package's parameter tree saved by
:func:`save_tree` (the tests hold a run against the JAX ``train_step`` on
the same weights); without it the weights come from ``--seed``.

Events, one JSON line each, go to ``--events`` from the main process
(``{"event": "step", "step", "attempt", "loss", "t"}`` after every step,
``{"event": "start", "attempt", "resumed", "step", "t"}``). With
``--launches_out`` every process writes its B1-B3 launch counts after each
step to ``<launches_out>.rank<r>.attempt<a>``, so a killed attempt's
counts up to its last step stay.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

DOC_LEN = {"tiny": (4, 40), "llama3_8b": (64, 3000)}
TRACKED = ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma", "flash_fwd", "flash_bwd_dq",
           "flash_bwd_dkv")


def add_finetune_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--project_dir", required=True)
    ap.add_argument("--cpu", action="store_true", help="gloo processes on the CPU, f32")
    ap.add_argument("--preset", choices=sorted(DOC_LEN), default="tiny")
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--rows", type=int, default=4, help="rows of a global batch")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights", default=None, help="npz of the JAX package's parameter tree")
    ap.add_argument("--events", default=None, help="JSON lines of steps and starts (main process)")
    ap.add_argument("--launches_out", default=None)
    ap.add_argument("--total_limit", type=int, default=None)
    ap.add_argument("--loader_batches", type=int, default=0,
                    help=">0: the rows come from a prepared loader over this many global batches "
                         "(its position is saved and restored), not from the step's seed")
    ap.add_argument("--per_process_rows", type=int, default=0,
                    help="the loader's rows a process (default --rows over the processes: the "
                         "global batch kept); fixed, the global batch follows the world size")


def restart_count() -> int:
    return int(os.environ.get("ACCELERATE_RESTART_COUNT", "0"))


def finetune_config(args):
    from ..models.llama import LlamaConfig

    if args.preset == "tiny":
        return LlamaConfig.tiny(num_hidden_layers=args.layers, compute_dtype=torch.float32,
                                attention_impl="flash", max_position_embeddings=max(128, args.seq))
    return LlamaConfig.llama3_8b(num_hidden_layers=args.layers, attention_impl="flash")


def seeded_rows(step: int, rows: int, seq: int, vocab: int, doc_len=(4, 90), seed: int = 0) -> dict:
    """Step ``step``'s global batch: ``rows`` packed rows of seeded
    documents (numpy, int32 ids, segment ids and positions, f32 loss
    mask)."""
    from ..utils import native

    rng = np.random.default_rng([seed, step])
    docs = []
    tokens = segments = None
    while tokens is None or len(tokens) < rows:
        docs += [rng.integers(1, vocab, size=rng.integers(*doc_len)).astype(np.int32)
                 for _ in range(2 * rows)]
        tokens, segments = native.pack_dataset(docs, seq_len=seq)
    tokens, segments = np.asarray(tokens[:rows]), np.asarray(segments[:rows])
    return {"input_ids": tokens.astype(np.int32), "segment_ids": segments.astype(np.int32),
            "position_ids": native.packed_position_ids(segments).astype(np.int32),
            "loss_mask": native.packed_loss_mask(segments)}


def save_tree(path: str, tree: dict) -> None:
    """A nested dict of arrays as one npz, keys joined with ``/``."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = np.asarray(v)

    walk(tree, ())
    np.savez(path, **flat)


def load_tree(path: str) -> dict:
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


class Finetune:
    """The Accelerator, model, optimizer and step of one process."""

    def __init__(self, args, **accelerator_kwargs):
        from ..accelerator import Accelerator
        from ..models import llama as tl
        from ..utils.dataclasses import ProjectConfiguration

        self.args = args
        self.acc = Accelerator(
            cpu=args.cpu, mixed_precision=None if args.cpu else "bf16",
            project_config=ProjectConfiguration(project_dir=args.project_dir,
                                                automatic_checkpoint_naming=True,
                                                total_limit=args.total_limit),
            **accelerator_kwargs)
        self.accelerator_t = time.time()  # its first heartbeat
        self.cfg = finetune_config(args)
        if args.weights:
            params = tl.params_from_jax(self.cfg, load_tree(args.weights), device=self.acc.device)
            model = tl.LlamaForCausalLM(self.cfg, params)
        else:
            model = tl.create_llama(self.cfg, seed=args.seed, device=self.acc.device)
        opt = torch.optim.AdamW(model.parameters(), lr=args.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=0.01)
        self.model, self.opt = self.acc.prepare(model, opt)
        self.attempt = restart_count()
        self.loader = self._it = None
        if args.loader_batches:
            # one seeded pool of rows; a global batch is --rows of them in
            # order, each process's block of it from the loader's shard
            rows = seeded_rows(1 << 20, args.rows * args.loader_batches, args.seq, self.cfg.vocab_size,
                               DOC_LEN[args.preset], args.seed)
            self.loader = self.acc.prepare_data_loader(
                rows, batch_size=args.per_process_rows or args.rows // self.acc.num_processes,
                drop_last=True)

    def batch(self, step: int) -> dict:
        """Step ``step``'s rows of this process: the loader's next batch,
        or the block of the step's seeded global batch."""
        a = self.args
        if self.loader is not None:
            if self._it is None:
                self._it = iter(self.loader)
            return {k: v.to(self.acc.device) for k, v in next(self._it).items()}
        full = seeded_rows(step, a.rows, a.seq, self.cfg.vocab_size, DOC_LEN[a.preset], a.seed)
        n, r = self.acc.num_processes, self.acc.process_index
        per = a.rows // n
        return {k: torch.from_numpy(v[r * per:(r + 1) * per]).to(self.acc.device)
                for k, v in full.items()}

    def step(self, batch) -> torch.Tensor:
        from ..models.llama import llama_loss

        acc = self.acc
        with acc.accumulate(self.model):
            loss = acc.backward(llama_loss, batch)
            acc.clip_grad_norm_(max_norm=1.0)
            self.opt.step()
            self.opt.zero_grad()
        return loss

    def boundary(self) -> None:
        """A step boundary: with ``--handle_preemption`` (the handler
        deferred, see :meth:`train`), every rank learns whether any rank
        was signalled, and all write the emergency checkpoint here and
        exit."""
        from ..utils import fault

        if fault._PREEMPTION["installed"] and any(
                self.acc.state.gather_object(fault.preemption_requested())):
            self.event("preempted", step=self.acc.step)
            fault.emergency_exit(self.acc)

    def train(self):
        """The context of a training loop: a preemption signal is recorded,
        and acted on at :meth:`boundary`."""
        from ..utils.fault import preemption_deferred

        return preemption_deferred()

    def close(self) -> None:
        if self._it is not None:
            self._it.close()
            self._it = None
        self.acc.end_training()

    def event(self, kind: str, **fields) -> None:
        if self.args.events and self.acc.is_main_process:
            with open(self.args.events, "a") as f:
                f.write(json.dumps({"event": kind, "attempt": self.attempt, "t": time.time(),
                                    **fields}) + "\n")

    def write_launches(self) -> None:
        if not self.args.launches_out:
            return
        from ..ops import _build

        counts = {k: v for k, v in _build.launch_counts().items() if k in TRACKED}
        path = f"{self.args.launches_out}.rank{self.acc.process_index}.attempt{self.attempt}"
        with open(path + ".part", "w") as f:
            json.dump(counts, f)
        os.replace(path + ".part", path)

    def whole_params(self) -> dict:
        """Every parameter whole, by checkpoint key (all processes call it)."""
        return {k: v.detach().float().cpu().numpy().copy() for k, v in
                self.acc.get_state_dict(self.model).items()}

    def checksum(self) -> str:
        """A digest of the parameters' bit patterns, taken on the device:
        two 64-bit sums, plain and position-weighted, over every local
        parameter (a whole tree on one process)."""
        s1 = s2 = 0
        chunk = 1 << 26
        for p in self.model.parameters():
            flat = getattr(p, "to_local", lambda: p)().detach().reshape(-1).view(torch.int32)
            for start in range(0, flat.numel(), chunk):
                bits = flat[start:start + chunk].to(torch.int64)
                weights = torch.arange(start, start + bits.numel(), device=bits.device,
                                       dtype=torch.int64) % 65521 + 1
                s1 += int(bits.sum().item())
                s2 += int((bits * weights).sum().item())
        return f"{s1 & (2 ** 64 - 1):016x}{s2 & (2 ** 64 - 1):016x}"
