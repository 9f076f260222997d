"""Seeding and RNG synchronization (counterpart of
``accelerate_tpu/utils/random.py``).

One process holds the whole run (``PartialState`` refuses a launch of
several), so there is nothing to synchronize: :func:`synchronize_rng_state`
and :func:`synchronize_rng_states` are no-ops, as the JAX package's are on
one process, and the process index ``device_specific`` adds is 0.
Broadcasting the main process's states waits for the distributed slice
(ROADMAP.md A7).

:func:`_collect_rng_state` and :func:`_restore_rng_state` are what a
checkpoint saves per process (``random_states_{rank}.pkl``): Python's,
NumPy's and torch's CPU generator, and every CUDA device's default
generator once CUDA is initialised."""

from __future__ import annotations

import random
from typing import Iterable, Optional

import numpy as np
import torch

__all__ = ["set_seed", "synchronize_rng_state", "synchronize_rng_states"]


def _collect_rng_state() -> dict:
    state = {
        "python": random.getstate(),
        "numpy": np.random.get_state(),
        "torch": torch.get_rng_state(),
    }
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        state["torch_cuda"] = torch.cuda.get_rng_state_all()
    return state


def _restore_rng_state(state: dict) -> None:
    random.setstate(state["python"])
    np.random.set_state(state["numpy"])
    torch.set_rng_state(state["torch"])
    if "torch_cuda" in state and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(state["torch_cuda"])


def set_seed(seed: int, device_specific: bool = False, deterministic: bool = False) -> None:
    """Seed Python's ``random``, NumPy's global generator and torch's (the
    CPU generator and every CUDA device's default generator).
    ``device_specific=True`` adds the process index (0 on one process);
    ``deterministic=True`` asks torch for deterministic algorithms."""
    # device_specific: seed + the process index, which is 0 on one process
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)  # seeds the CUDA generators too, lazily without a card
    if deterministic:
        torch.use_deterministic_algorithms(True)


def synchronize_rng_state(generator: Optional[torch.Generator] = None) -> None:
    """Broadcast the main process's RNG states to the other processes: a
    no-op on one process."""


def synchronize_rng_states(rng_types: Iterable[str] = ("python", "numpy"),
                           generator: Optional[torch.Generator] = None) -> None:
    """:func:`synchronize_rng_state` under the name the JAX package exports."""
    synchronize_rng_state(generator=generator)
