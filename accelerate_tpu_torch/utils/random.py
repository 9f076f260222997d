"""Seeding and RNG synchronization (counterpart of
``accelerate_tpu/utils/random.py``).

:func:`synchronize_rng_state` broadcasts the main process's Python, NumPy
and torch CPU generator states (and a given ``torch.Generator``'s) to every
process, as the JAX package's does; with one process it does nothing.
``set_seed(device_specific=True)`` adds the process index.

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
    if device_specific:
        from ..state import process_layout

        seed += process_layout()[0]
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)  # seeds the CUDA generators too, lazily without a card
    if deterministic:
        torch.use_deterministic_algorithms(True)


def synchronize_rng_state(generator: Optional[torch.Generator] = None) -> None:
    """Broadcast the main process's RNG states (Python, NumPy, torch CPU,
    and ``generator``'s) to the other processes: a no-op on one process."""
    from ..state import PartialState, process_layout

    if process_layout()[1] <= 1:
        return
    from ..ops.operations import broadcast_object_list

    payload = None
    if PartialState().is_main_process:
        payload = {"python": random.getstate(), "numpy": np.random.get_state(),
                   "torch": torch.get_rng_state()}
        if generator is not None:
            payload["generator"] = generator.get_state()
    payload = broadcast_object_list([payload], from_process=0)[0]
    random.setstate(payload["python"])
    np.random.set_state(payload["numpy"])
    torch.set_rng_state(payload["torch"])
    if generator is not None and "generator" in payload:
        generator.set_state(payload["generator"])


def synchronize_rng_states(rng_types: Iterable[str] = ("python", "numpy"),
                           generator: Optional[torch.Generator] = None) -> None:
    """:func:`synchronize_rng_state` under the name the JAX package exports."""
    synchronize_rng_state(generator=generator)
