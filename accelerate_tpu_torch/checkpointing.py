"""Training-state checkpoints (counterpart of ``accelerate_tpu/checkpointing.py``).

A checkpoint directory holds, under the JAX package's names:

    model/, model_1/ ...       each prepared model's tensors (safetensors)
    optimizer/, optimizer_1/   each optimizer's state tensors (safetensors)
    optimizer_meta.json        update counts, param groups, non-tensor state
    scheduler.json             each ``AcceleratedScheduler``'s state
    sampler.json               each prepared loader's resume position, and
                               ``Accelerator.step``
    scaler.json                the fp16 loss scale
    random_states_{rank}.pkl   Python, NumPy, torch CPU and CUDA generators
    custom_checkpoint_{i}.pkl  objects given to ``register_for_checkpointing``
    COMMITTED                  the commit manifest (per-file sizes and crc32)

Tensors go through the port's own safetensors writer
(``utils/serialization.py``); the JAX package writes orbax trees there, whose
internal files are not reproduced.

The atomic protocol: a save is staged into ``<dir>.tmp`` (every file
flushed to disk), then the ``COMMITTED`` manifest is written and the
staging directory renamed to ``<dir>``. A same-name overwrite parks the
previous checkpoint at ``<dir>.old`` until the rename lands, and a load
finds it there if the save died between the two renames. A crash at any
point leaves the previous committed checkpoint loadable; loads resolve
committed checkpoints only, rolling back past interrupted saves. Retention
(``total_limit``, ``checkpoint_keep_every``) runs after the commit and
deletes committed checkpoints only.

``async_save=True`` snapshots the tensors into pinned host memory on a
side CUDA stream (the training stream waits for the copy before it may
write the parameters again) and writes them on a background thread; the
commit waits for :func:`wait_for_async_saves` (the next save or load,
``end_training`` and interpreter exit call it), which raises a failed
snapshot, write or commit.

Several processes: the checkpoint is the same one file set, of whole
tensors under the same keys. A model sharded by FSDP2 is gathered with
``torch.distributed.checkpoint.state_dict.get_model_state_dict`` /
``get_optimizer_state_dict`` (``full_state_dict=True, cpu_offload=True``),
a Llama's per-layer units restacked under the stacked keys and each
parameter's optimizer state under its stacked parameter's index; a DDP
model's tensors are whole on every rank already. The main process writes
and commits; the others wait at the protocol's barriers, and each writes
its ``random_states_{rank}.pkl``. A load reads on the main process and
hands the tensors out with ``set_model_state_dict`` /
``set_optimizer_state_dict`` (``broadcast_from_rank0=True``), each rank
keeping its shards. A checkpoint saved by another number of processes
raises ``CheckpointTopologyError`` unless the load is asked for with
``elastic=True``, which loads it into this run's layout (the tensors are
whole, so nothing else changes).
"""

from __future__ import annotations

import atexit
import json
import os
import pickle
import re
import shutil
import threading
import time
import zlib
from typing import Optional

import numpy as np
import torch

from . import tracing
from .logging import get_logger
from .model import unwrap_model
from .state import PartialState
from .utils import fault as _fault
from .utils.constants import (
    CHECKPOINT_COMMITTED_MARKER,
    CHECKPOINT_DIR_PREFIX,
    CHECKPOINT_OLD_SUFFIX,
    CHECKPOINT_STAGING_SUFFIX,
    CUSTOM_STATE_PATTERN,
    MODEL_NAME,
    OPTIMIZER_NAME,
    RNG_STATE_NAME,
    SAMPLER_NAME,
    SCHEDULER_NAME,
)
from .utils.fault import (
    CheckpointComponentMissingError,
    CheckpointCorruptError,
    CheckpointError,
    CheckpointNotFoundError,
    CheckpointUncommittedError,
    fault_point,
)
from .utils.random import _collect_rng_state, _restore_rng_state
from .utils.serialization import SafetensorsReader, save_sharded_safetensors

logger = get_logger(__name__)

__all__ = [
    "checkpoint_index",
    "is_checkpoint_committed",
    "list_checkpoints",
    "load_accelerator_state",
    "load_model_checkpoint",
    "read_commit_manifest",
    "save_accelerator_state",
    "save_model_checkpoint",
    "verify_checkpoint",
    "wait_for_async_saves",
]

_CKPT_NAME_RE = re.compile(rf"^{CHECKPOINT_DIR_PREFIX}_(\d+)$")

# in-flight async writes, and the commits that wait for them: process-wide,
# as the atexit join and the preemption handler that drain them are
_ASYNC_SAVES: list = []
_PENDING_COMMITS: list = []
_ATEXIT_REGISTERED = False


# ------------------------------------------------------------------ tensors
def model_tensors(model) -> dict:
    """A prepared model's live tensors under their checkpoint names: a
    model with ``checkpoint_keys`` (the Llama port: tree paths joined with
    ``"."``, as the JAX package names its leaves) by those, any other by
    its ``state_dict`` keys. In the Llama's per-layer layout a layer
    leaf's value is the list of its L per-layer tensors."""
    module = unwrap_model(model)
    if hasattr(module, "checkpoint_fqns"):
        live = dict(module.named_parameters())
        return {key: [live[f] for f in fqns] if stacked else live[fqns[0]]
                for key, fqns, stacked in module.checkpoint_fqns()}
    if hasattr(module, "checkpoint_keys"):
        return {key: getattr(module, name) for key, name in module.checkpoint_keys()}
    return dict(module.state_dict(keep_vars=True))


def _has_dtensor(model) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in unwrap_model(model).parameters())


def _key_layout(module) -> list:
    """``(checkpoint key, module names, stacked)`` of every tensor of a
    checkpoint of ``module``."""
    if hasattr(module, "checkpoint_fqns"):
        return module.checkpoint_fqns()
    return [(k, [k], False) for k in module.state_dict().keys()]


def full_model_tensors(model, cpu_offload: bool = False) -> dict:
    """The model's whole tensors (detached) under their checkpoint names, a
    Llama's layers restacked. A model with ``DTensor`` parameters (FSDP2)
    is gathered by every process together (``get_model_state_dict``); with
    ``cpu_offload`` only the main process receives them (the others get
    ``{}``)."""
    module = unwrap_model(model)
    if _has_dtensor(module):
        from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

        sd = get_model_state_dict(model, options=StateDictOptions(full_state_dict=True,
                                                                    cpu_offload=cpu_offload))
        if not sd:
            return {}
        return {key: torch.stack([sd[f] for f in fqns]) if stacked else sd[fqns[0]]
                for key, fqns, stacked in _key_layout(module)}
    return {k: (torch.stack(v) if isinstance(v, list) else v).detach()
            for k, v in model_tensors(model).items()}


def _owner(accelerator, opt):
    """The prepared model whose parameters ``opt`` steps."""
    first = next(iter(opt.params()), None)
    for model in accelerator._models:
        if any(p is first for p in model.parameters()):
            return model
    raise ValueError("the optimizer steps no prepared model's parameters")


def _opt_layout(opt, model) -> tuple:
    """(per original parameter ``(module names, stacked)``, the original
    param groups as index lists) of an optimizer prepared under a layout;
    without one, its parameters' own names."""
    layout = getattr(opt, "_ckpt_layout", None)
    if layout is not None:
        return layout
    names = {p: n for n, p in unwrap_model(model).named_parameters()}
    entries, groups = [], []
    for group in opt.optimizer.param_groups:
        groups.append([len(entries) + i for i in range(len(group["params"]))])
        entries += [([names[p]], False) for p in group["params"]]
    return entries, groups


def _full_optimizer_parts(opt, model) -> tuple:
    """:func:`_optimizer_parts` of an optimizer of a sharded model: the
    state gathered whole onto the main process (``get_optimizer_state_dict``)
    and each per-layer parameter's state stacked under its stacked
    parameter's index, so the file set is the one a single process writes.
    Every process calls it; the others get ``({}, {})``."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, get_optimizer_state_dict

    osd = get_optimizer_state_dict(model, opt.optimizer, options=StateDictOptions(
        full_state_dict=True, cpu_offload=True))
    if not PartialState().is_main_process:
        return {}, {}
    layout, groups = _opt_layout(opt, model)
    state = osd.get("state", {})
    tensors, scalars, on_param = {}, {}, []
    for i, (fqns, stacked) in enumerate(layout):
        entries = [state.get(f) for f in fqns]
        if any(e is None for e in entries):
            continue
        for key, first in entries[0].items():
            name = f"state.{i}.{key}"
            if not isinstance(first, torch.Tensor):
                scalars[name] = first
            elif stacked and first.dim() > 0:
                tensors[name] = torch.stack([e[key] for e in entries])
                on_param.append(name)
            else:
                tensors[name] = first
                if first.dim() > 0:
                    on_param.append(name)
    hyper = [{k: v for k, v in g.items() if k != "params"} for g in osd["param_groups"]]
    meta = {"step_count": opt._step_count,
            "param_groups": [{**h, "params": idx} for h, idx in zip(hyper, groups)],
            "scalars": scalars, "on_param_device": on_param}
    return tensors, meta


def _optimizer_parts(opt) -> tuple:
    """(tensors, meta) of an ``AcceleratedOptimizer``: its state tensors as
    ``state.<param index>.<key>`` and, as JSON, the update count, the
    param groups, the non-tensor state and which tensors live with their
    parameter (the others, like AdamW's step counters, on the CPU)."""
    sd = opt.optimizer.state_dict()
    params = opt.params()
    tensors, scalars, on_param = {}, {}, []
    for idx, entry in sd["state"].items():
        for key, value in entry.items():
            name = f"state.{idx}.{key}"
            if isinstance(value, torch.Tensor):
                tensors[name] = value
                if value.device == params[int(idx)].device:
                    on_param.append(name)
            else:
                scalars[name] = value
    meta = {"step_count": opt._step_count, "param_groups": sd["param_groups"],
            "scalars": scalars, "on_param_device": on_param}
    return tensors, meta


def _snapshot(tensors: dict) -> tuple:
    """Host copies of ``tensors`` that later writes to them cannot change:
    CUDA tensors copied into pinned memory on a side stream, after the work
    already queued and before anything queued later on the current stream
    (which waits on the copy's event); host tensors cloned. Returns
    (copies, event or None)."""
    out = {k: t.detach().clone() for k, t in tensors.items() if not t.is_cuda}
    cuda = {k: t.detach() for k, t in tensors.items() if t.is_cuda}
    if not cuda:
        return out, None
    device = next(iter(cuda.values())).device
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        for k, t in cuda.items():
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            t.record_stream(side)
            out[k] = host
    event = torch.cuda.Event()
    event.record(side)
    current.wait_event(event)
    return out, event


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_tree(tensors: dict, directory: str) -> None:
    """``tensors`` (host copies, flat names) as safetensors under
    ``directory``, every file and the directory flushed to disk."""
    files = save_sharded_safetensors(tensors, directory)
    for path in files:
        _fsync_path(path)
    for name in os.listdir(directory):
        if name.endswith(".json"):
            _fsync_path(os.path.join(directory, name))
    _fsync_path(directory)


class _AsyncWrite:
    """One async save's tensor writes on a background thread, after the
    snapshot's event. ``error`` holds what failed (raised by
    :func:`wait_for_async_saves`)."""

    def __init__(self, jobs: list, event, error: Optional[BaseException] = None):
        self.jobs = jobs
        self.event = event
        self.error = error
        self.thread = None
        if error is None:
            self.thread = threading.Thread(target=self._run, daemon=True, name="async-save")
            self.thread.start()

    def _run(self):
        try:
            if self.event is not None:
                self.event.synchronize()
            for tensors, directory in self.jobs:
                _write_tree(tensors, directory)
        except BaseException as exc:  # noqa: BLE001 - raised by wait_for_async_saves
            self.error = exc
        finally:
            self.jobs = []  # drop the pinned copies as soon as they are written

    def join(self) -> None:
        if self.thread is not None:
            self.thread.join()
        if self.error is not None:
            raise self.error


def _register_atexit() -> None:
    global _ATEXIT_REGISTERED
    if not _ATEXIT_REGISTERED:
        # a staged save whose commit never ran is discarded by every load:
        # join and commit at exit
        atexit.register(_join_async_saves_at_exit)
        _ATEXIT_REGISTERED = True


def wait_for_async_saves() -> None:
    """Wait for every in-flight async write, then run the commits that
    waited for them. Each write is joined once; the first failure is
    raised after all are joined, and then no waiting commit runs (a save
    whose data is suspect is never committed)."""
    first_error: Optional[BaseException] = None
    while _ASYNC_SAVES:
        write = _ASYNC_SAVES.pop(0)
        try:
            write.join()
        except BaseException as exc:  # noqa: BLE001 - raised below
            if first_error is None:
                first_error = exc
    if first_error is not None:
        _PENDING_COMMITS.clear()
        raise first_error
    while _PENDING_COMMITS:
        staging, final, accelerator = _PENDING_COMMITS.pop(0)
        _commit_staged(staging, final, accelerator)
        logger.info(f"Saved state to {final}")


def _join_async_saves_at_exit() -> None:
    try:
        wait_for_async_saves()
    except Exception as exc:  # noqa: BLE001 - at exit there is no caller left to raise to
        logger.error(f"async checkpoint save failed during interpreter exit: {exc}")


# ------------------------------------------------------ commit protocol
def _file_crc32(path: str) -> str:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 22), b""):
            crc = zlib.crc32(chunk, crc)
    return f"{crc & 0xFFFFFFFF:08x}"


def _build_manifest(ckpt_dir: str) -> dict:
    files = {}
    for root, _dirs, names in os.walk(ckpt_dir):
        for name in names:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, ckpt_dir)
            if rel == CHECKPOINT_COMMITTED_MARKER:
                continue
            files[rel] = {"size": os.path.getsize(full), "crc32": _file_crc32(full)}
    return files


def checkpoint_index(name: str) -> Optional[int]:
    """The N of a ``checkpoint_N`` directory name; None for anything else
    (staging ``.tmp`` and parking ``.old`` directories, other files)."""
    m = _CKPT_NAME_RE.match(name)
    return int(m.group(1)) if m else None


def list_checkpoints(base: str, committed_only: bool = False) -> list:
    """The ``checkpoint_N`` directories under ``base`` by N."""
    if not os.path.isdir(base):
        return []
    entries = []
    for name in os.listdir(base):
        idx = checkpoint_index(name)
        path = os.path.join(base, name)
        if idx is None or not os.path.isdir(path):
            continue
        if committed_only and not is_checkpoint_committed(path):
            continue
        entries.append((idx, path))
    return [path for _, path in sorted(entries)]


def is_checkpoint_committed(ckpt_dir: str) -> bool:
    try:
        read_commit_manifest(ckpt_dir)
    except CheckpointError:
        return False
    return True


def read_commit_manifest(ckpt_dir: str) -> dict:
    """The parsed ``COMMITTED`` manifest, or the taxonomy's error."""
    if not os.path.isdir(ckpt_dir):
        raise CheckpointNotFoundError(f"checkpoint directory {ckpt_dir} does not exist")
    marker = os.path.join(ckpt_dir, CHECKPOINT_COMMITTED_MARKER)
    if not os.path.isfile(marker):
        raise CheckpointUncommittedError(
            f"{ckpt_dir} has no {CHECKPOINT_COMMITTED_MARKER} manifest: the save that wrote "
            "it was interrupted before the atomic commit. Load a committed checkpoint, or "
            "pass verify='off' to load it anyway.")
    try:
        with open(marker) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as exc:
        raise CheckpointCorruptError(
            f"{CHECKPOINT_COMMITTED_MARKER} manifest in {ckpt_dir} is unreadable: {exc}") from exc


def verify_checkpoint(ckpt_dir: str, level: str = "marker") -> None:
    """Check a checkpoint at one of four levels: ``"off"`` (the directory
    exists), ``"marker"`` (a parseable ``COMMITTED`` manifest), ``"size"``
    (every listed file exists with its size: catches truncation),
    ``"checksum"`` (and its crc32 matches: reads every byte)."""
    if level not in ("off", "marker", "size", "checksum"):
        raise ValueError(f"unknown verify level {level!r} (expected off|marker|size|checksum)")
    if level == "off":
        if not os.path.isdir(ckpt_dir):
            raise CheckpointNotFoundError(f"checkpoint directory {ckpt_dir} does not exist")
        return
    manifest = read_commit_manifest(ckpt_dir)
    if level == "marker":
        return
    problems = []
    for rel, meta in manifest.get("files", {}).items():
        full = os.path.join(ckpt_dir, rel)
        if not os.path.isfile(full):
            problems.append(f"{rel}: missing")
            continue
        size = os.path.getsize(full)
        if size != meta.get("size"):
            problems.append(f"{rel}: size {size} != recorded {meta.get('size')}")
        elif level == "checksum" and _file_crc32(full) != meta.get("crc32"):
            problems.append(f"{rel}: crc32 mismatch")
    if problems:
        raise CheckpointCorruptError(
            f"checkpoint {ckpt_dir} fails {level} verification: " + "; ".join(problems[:10])
            + ("" if len(problems) <= 10 else f" (+{len(problems) - 10} more)"))


def _verify_level(override: Optional[str]) -> str:
    return override if override is not None else os.environ.get("ACCELERATE_CHECKPOINT_VERIFY",
                                                                "marker")


def _topology() -> dict:
    from .state import AcceleratorState

    state = PartialState()
    mesh = AcceleratorState._shared_state.get("device_mesh")
    axes = ({n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
            if mesh is not None else {})
    return {"num_processes": state.num_processes, "num_devices": state.num_processes,
            "device": str(state.device), "mesh_axes": axes}


def _commit_staged(staging: str, final: str, accelerator) -> None:
    """Write the manifest into the staging directory, rename it into place
    (parking a same-name predecessor at ``<final>.old`` until the rename
    lands), then run retention."""
    with tracing.span("ckpt.commit", step=int(getattr(accelerator, "step", 0) or 0), final=final):
        _commit_staged_inner(staging, final, accelerator)


def _commit_staged_inner(staging: str, final: str, accelerator) -> None:
    state = PartialState()
    state.wait_for_everyone("accelerate_tpu_torch.checkpointing.pre_commit")
    fault_point("before_commit")
    if state.is_main_process:
        manifest = {
            "format": 1,
            "files": _build_manifest(staging),
            "step": getattr(accelerator, "step", 0),
            "iteration": accelerator.project_configuration.iteration,
            "num_processes": state.num_processes,
            "topology": _topology(),
            "time": time.time(),
        }
        marker = os.path.join(staging, CHECKPOINT_COMMITTED_MARKER)
        with open(marker + ".part", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(marker + ".part", marker)
        _fsync_path(staging)
        fault_point("before_rename")
        old = final + CHECKPOINT_OLD_SUFFIX
        if os.path.exists(final):
            os.rename(final, old)
        os.rename(staging, final)
        _fsync_path(os.path.dirname(final))
        shutil.rmtree(old, ignore_errors=True)
    state.wait_for_everyone("accelerate_tpu_torch.checkpointing.post_commit_rename")
    fault_point("before_gc")
    _gc_checkpoints(accelerator)
    # the checkpoint is durable here: the main process hands it to the
    # replicator (elastic.py), which mirrors it under ReplicationConfig.target
    if state.is_main_process:
        submit = getattr(accelerator, "_submit_replication", None)
        if submit is not None:
            submit(final)


def _gc_checkpoints(accelerator) -> None:
    """Keep the newest ``total_limit`` committed checkpoints, every
    ``checkpoint_keep_every``-th index exempt; uncommitted directories are
    never counted or deleted."""
    pc = accelerator.project_configuration
    if not PartialState().is_main_process:
        return
    if not (pc.automatic_checkpoint_naming and pc.total_limit is not None and pc.project_dir):
        return
    keep_every = pc.checkpoint_keep_every
    candidates = []
    for path in list_checkpoints(os.path.join(pc.project_dir, "checkpoints"), committed_only=True):
        idx = checkpoint_index(os.path.basename(path))
        if keep_every and idx % keep_every == 0:
            continue
        candidates.append(path)
    while len(candidates) > pc.total_limit:
        victim = candidates.pop(0)
        logger.info(f"retention: removing committed checkpoint {victim}")
        shutil.rmtree(victim, ignore_errors=True)


def _json_safe(obj):
    """numpy scalars and arrays, tensors, tuples and sets as plain JSON
    types; anything else as its repr."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return np.asarray(obj.detach().cpu() if isinstance(obj, torch.Tensor) else obj).tolist()
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return repr(obj)


# ----------------------------------------------------------------- save/load
def _resolve_dir(accelerator, output_dir: Optional[str], for_save: bool) -> str:
    pc = accelerator.project_configuration
    if output_dir is not None:
        return output_dir
    if pc.project_dir is None:
        raise ValueError("No output_dir given and no project_dir configured")
    base = os.path.join(pc.project_dir, "checkpoints")
    if for_save:
        if pc.automatic_checkpoint_naming:
            return os.path.join(base, f"{CHECKPOINT_DIR_PREFIX}_{pc.iteration}")
        return base
    return _latest_committed(base)


def _resolve_for_load(accelerator, input_dir: Optional[str]) -> str:
    """:func:`_resolve_dir` for a load, with the replica fallback: when the
    local tree holds no committed checkpoint and a ``ReplicationConfig`` is
    active, the newest verified replica is restored into it first (a host
    whose disk is gone). With no local checkpoint and no replica,
    ``CheckpointNotFoundError`` as before: ``resume_from_latest`` reads a
    first launch."""
    try:
        return _resolve_dir(accelerator, input_dir, for_save=False)
    except CheckpointNotFoundError:
        rc = getattr(accelerator, "replication_config", None)
        pc = accelerator.project_configuration
        if rc is None or input_dir is not None or pc.project_dir is None:
            raise
        from .elastic import ensure_local_checkpoint

        base = os.path.join(pc.project_dir, "checkpoints")
        logger.warning(f"no committed checkpoint under {base}; attempting replica restore from "
                       f"{rc.target}")
        return ensure_local_checkpoint(rc, base)


def _latest_committed(base: str) -> str:
    """The newest committed ``checkpoint_N`` under ``base``, rolling back
    past newer uncommitted ones (with a warning); the newest of all when
    none carries a manifest (a tree written without the protocol)."""
    entries = list_checkpoints(base)
    if not entries:
        raise CheckpointNotFoundError(f"No checkpoints under {base}")
    committed = [p for p in entries if is_checkpoint_committed(p)]
    if committed:
        chosen = committed[-1]
        rolled_back = entries[entries.index(chosen) + 1:]
        for newer in rolled_back:
            logger.warning(
                f"ignoring uncommitted checkpoint {newer} (interrupted save: no "
                f"{CHECKPOINT_COMMITTED_MARKER} manifest); rolling back to the last committed "
                f"checkpoint {chosen}")
        if rolled_back:
            # the spans that led to the interrupted save, for a postmortem
            tracing.flight_dump("checkpoint_rollback")
        return chosen
    logger.warning(f"no checkpoint under {base} carries a {CHECKPOINT_COMMITTED_MARKER} manifest; "
                   "loading the newest one unverified")
    return entries[-1]


def save_accelerator_state(accelerator, output_dir: Optional[str] = None,
                           safe_serialization: bool = True, async_save: bool = False) -> str:
    """Save the whole training state under the atomic protocol (see the
    module docstring). Returns the checkpoint directory. With
    ``async_save`` the tensors are written in the background and the
    commit waits for :func:`wait_for_async_saves`."""
    state = PartialState()
    pc = accelerator.project_configuration
    wait_for_async_saves()  # join and commit the previous async save first
    output_dir = os.path.abspath(_resolve_dir(accelerator, output_dir, for_save=True))
    staging = output_dir + CHECKPOINT_STAGING_SUFFIX

    _fault.mark_save_started()
    try:
        if state.is_main_process:
            for leftover in (staging, output_dir + CHECKPOINT_OLD_SUFFIX):
                if os.path.exists(leftover):
                    shutil.rmtree(leftover, ignore_errors=True)
        state.wait_for_everyone("accelerate_tpu_torch.checkpointing.pre_stage")
        os.makedirs(staging, exist_ok=True)

        def suffix(i):
            return "" if i == 0 else f"_{i}"

        tensors, jobs, opt_meta = {}, [], []
        for i, model in enumerate(accelerator._models):
            # FSDP2: gathered onto the main process by every process
            live = (full_model_tensors(model, cpu_offload=True) if _has_dtensor(model)
                    else model_tensors(model))
            jobs.append((f"{MODEL_NAME}{suffix(i)}", {
                k: torch.stack([t.detach() for t in v]) if isinstance(v, list) else v
                for k, v in live.items()}))
        for i, opt in enumerate(accelerator._optimizers):
            opt_tensors, meta = (_full_optimizer_parts(opt, _owner(accelerator, opt))
                                 if any(_has_dtensor(m) for m in accelerator._models)
                                 else _optimizer_parts(opt))
            opt_meta.append(meta)
            if opt_tensors:
                jobs.append((f"{OPTIMIZER_NAME}{suffix(i)}", opt_tensors))
        if not state.is_main_process:
            jobs = []  # the main process writes the tensors, whole on it
        for name, group in jobs:
            tensors.update({f"{name}/{k}": t for k, t in group.items()})
        error, event = None, None
        try:
            snapshot, event = _snapshot(tensors)
        except BaseException as exc:  # noqa: BLE001 - async: raised by wait_for_async_saves
            if not async_save:
                raise
            snapshot, error = {}, exc
        writes = [({k: snapshot.pop(f"{name}/{k}") for k in group} if error is None else {},
                   os.path.join(staging, name)) for name, group in jobs]
        if async_save:
            _register_atexit()
            _ASYNC_SAVES.append(_AsyncWrite(writes, event, error))
            fault_point("after_model_save")
            fault_point("after_optimizer_save")
        else:
            if event is not None:
                event.synchronize()
            for is_model in (True, False):
                for (name, _), (host, directory) in zip(jobs, writes):
                    if name.startswith(MODEL_NAME) == is_model:
                        _write_tree(host, directory)
                fault_point("after_model_save" if is_model else "after_optimizer_save")
        del snapshot, writes

        if state.is_main_process:
            for i, sched in enumerate(accelerator._schedulers):
                _write_json(os.path.join(staging, f"{SCHEDULER_NAME}{suffix(i)}.json"),
                            sched.state_dict())
            samplers = [dl.state_dict() if hasattr(dl, "state_dict") else {}
                        for dl in accelerator._dataloaders]
            _write_json(os.path.join(staging, f"{SAMPLER_NAME}.json"),
                        {"dataloaders": samplers, "step": accelerator.step})
            if accelerator.scaler is not None:
                _write_json(os.path.join(staging, "scaler.json"), accelerator.scaler.state_dict())
            _write_json(os.path.join(staging, "optimizer_meta.json"), opt_meta)
        with open(os.path.join(staging, f"{RNG_STATE_NAME}_{state.process_index}.pkl"), "wb") as f:
            pickle.dump(_collect_rng_state(), f)
            f.flush()
            os.fsync(f.fileno())
        for i, obj in enumerate(accelerator._custom_objects):
            with open(os.path.join(staging, CUSTOM_STATE_PATTERN.format(i) + ".pkl"), "wb") as f:
                pickle.dump(_to_host(obj.state_dict()), f)
                f.flush()
                os.fsync(f.fileno())

        if pc.automatic_checkpoint_naming:
            pc.iteration += 1
        if async_save:
            _PENDING_COMMITS.append((staging, output_dir, accelerator))
            _fault.mark_save_finished(accelerator, path=output_dir)
            logger.info(f"staged async state at {staging}; the commit waits for "
                        "wait_for_async_saves()")
            return output_dir
        _commit_staged(staging, output_dir, accelerator)
    except BaseException:
        _fault._save_failed()
        raise
    _fault.mark_save_finished(accelerator, path=output_dir)
    logger.info(f"Saved state to {output_dir}")
    return output_dir


def _remap_loader_state(dl, sd: dict, saved_topology: dict) -> dict:
    """A loader's saved position in batches of the live global batch: the
    saved ``total_batch_size`` against the loader's, or, for a checkpoint
    without it, the saved ``num_processes`` times the loader's per-process
    batch (the per-process batch taken as unchanged)."""
    new_total = getattr(dl, "total_batch_size", None)
    old_total = sd.get("total_batch_size")
    if old_total is None:
        saved_procs = saved_topology.get("num_processes")
        per_process = getattr(dl, "batch_size", None) or getattr(
            getattr(dl, "batch_sampler", None), "batch_size", None)
        if saved_procs and per_process:
            old_total = per_process * saved_procs
    if old_total and new_total and int(old_total) != int(new_total):
        from .elastic import remap_sampler_state

        sd = remap_sampler_state(sd, int(old_total), int(new_total))
    return sd


def _write_json(path: str, payload) -> None:
    with open(path, "w") as f:
        json.dump(_json_safe(payload), f)
        f.flush()
        os.fsync(f.fileno())


def _to_host(tree):
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def _copy_in(live, src: torch.Tensor) -> None:
    """Copy a host tensor (a view of a mapped file) into ``live``; into the
    card through a pinned buffer (the copy from pageable memory runs at a
    fraction of the pinned rate). ``live`` a list: its tensors take
    ``src``'s slices along dim 0 (a stacked key into per-layer ones)."""
    if isinstance(live, list):
        if len(live) != src.shape[0]:
            raise ValueError(f"checkpoint tensor stacks {src.shape[0]} slices, the live model "
                             f"{len(live)}")
        for t, part in zip(live, src.unbind(0)):
            _copy_in(t, part)
        return
    if live.shape != src.shape:
        raise ValueError(f"checkpoint tensor has shape {tuple(src.shape)}, the live one "
                         f"{tuple(live.shape)}")
    with torch.no_grad():
        if live.is_cuda:
            staged = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            staged.copy_(src)
            live.copy_(staged, non_blocking=True)
        else:
            live.copy_(src)


def _load_tensors(live: dict, path: str, what: str) -> None:
    """Copy every tensor of the safetensors tree at ``path`` into ``live``
    (name -> tensor), one file at a time."""
    with SafetensorsReader(path) as reader:
        missing = [k for k in live if k not in reader]
        if missing:
            raise CheckpointComponentMissingError(
                f"{path} has no tensor {missing[0]!r} for {what}"
                + (f" (+{len(missing) - 1} more)" if len(missing) > 1 else ""))
        by_file: dict = {}
        for name in live:
            by_file.setdefault(reader.file_of(name), []).append(name)
        for file, names in by_file.items():
            for name in names:
                _copy_in(live[name], reader.get(name))
            reader.release_file(file)
    if any(t.is_cuda for v in live.values() for t in (v if isinstance(v, list) else [v])):
        torch.cuda.synchronize()


def _load_optimizer(opt, path: Optional[str], meta: dict) -> None:
    """Rebuild an optimizer's state dict from its tensors at ``path`` and
    its JSON ``meta`` and load it. A tensor the live optimizer already
    holds (same shape and dtype) is copied into in place, so a restore in
    the middle of training needs no second copy of the moments; the others
    are placed where they lived (with their parameter, or on the CPU)."""
    params = opt.params()
    state: dict = {}
    if path is not None:
        on_param = set(meta.get("on_param_device", []))
        with SafetensorsReader(path) as reader:
            for name in reader.keys():
                _, idx, key = name.split(".", 2)
                src = reader.get(name)
                param = params[int(idx)]
                dst = opt.optimizer.state.get(param, {}).get(key)
                if not (isinstance(dst, torch.Tensor) and dst.shape == src.shape
                        and dst.dtype == src.dtype):
                    device = param.device if name in on_param else torch.device("cpu")
                    dst = torch.empty(src.shape, dtype=src.dtype, device=device)
                _copy_in(dst, src)
                state.setdefault(int(idx), {})[key] = dst
        if any(p.is_cuda for p in params):
            torch.cuda.synchronize()
    for name, value in meta.get("scalars", {}).items():
        _, idx, key = name.split(".", 2)
        state.setdefault(int(idx), {})[key] = value
    opt.load_state_dict({"optimizer": {"state": state, "param_groups": meta["param_groups"]},
                         "step_count": meta.get("step_count", 0)})


def _recover_parked(input_dir: str) -> None:
    """A same-name overwrite that died between its two renames left the
    previous committed checkpoint at ``<dir>.old``: move it back."""
    parked = input_dir + CHECKPOINT_OLD_SUFFIX
    if not os.path.isdir(input_dir) and os.path.isdir(parked) and is_checkpoint_committed(parked):
        logger.warning(f"{input_dir} missing but committed {parked} found (a save was interrupted "
                       "between its renames); recovering it")
        os.rename(parked, input_dir)


def _ensure_present(accelerator, input_dir: str) -> None:
    """Make ``input_dir`` present on every process before it is read. The
    presence of a tree is a fact of one host (host-local disks are what a
    replica is for), but every recovery path runs collectives: the verdict
    is gathered first and all processes take the same branch. A parked
    ``.old`` is recovered (the main process first, then each other host its
    own); what is still missing somewhere is fetched from a replica."""
    state = PartialState()
    many = state.num_processes > 1
    if all(state.gather_object(os.path.isdir(input_dir))) if many else os.path.isdir(input_dir):
        return
    if state.is_main_process:
        _recover_parked(input_dir)
    if many:
        state.wait_for_everyone("accelerate_tpu_torch.checkpointing.recover_parked")
        if not state.is_main_process:
            _recover_parked(input_dir)
    if all(state.gather_object(os.path.isdir(input_dir))) if many else os.path.isdir(input_dir):
        return
    rc = getattr(accelerator, "replication_config", None)
    if rc is None:
        raise CheckpointNotFoundError(
            f"checkpoint directory {input_dir} does not exist" if not os.path.isdir(input_dir)
            else f"checkpoint directory {input_dir} is missing on a peer host and no "
                 "ReplicationConfig is active to fetch it")
    from .elastic import ensure_local_checkpoint

    logger.warning(f"{input_dir} missing on at least one host; attempting replica restore from "
                   f"{rc.target}")
    ensure_local_checkpoint(rc, os.path.dirname(input_dir), name=os.path.basename(input_dir))


def _verify_or_heal(accelerator, input_dir: str, level: str) -> None:
    """Verify ``input_dir`` on every process, then decide together: a tree
    whose bytes are corrupt on some host is parked at ``<dir>.corrupt`` there
    and a checksum-verified replica restored under its name (with a
    ``ReplicationConfig``); any other failure raises on every process. No
    rename happens before every process has verified (the gather is the
    rendezvous)."""
    state = PartialState()
    error: Optional[CheckpointError] = None
    try:
        verify_checkpoint(input_dir, level=level)
    except CheckpointError as exc:
        error = exc
    mine = None if error is None else (isinstance(error, CheckpointCorruptError),
                                       f"{type(error).__name__}: {error}")
    failed = [(r, v) for r, v in enumerate(
        state.gather_object(mine) if state.num_processes > 1 else [mine]) if v is not None]
    if not failed:
        return
    rc = getattr(accelerator, "replication_config", None)
    all_corrupt = all(corrupt for _r, (corrupt, _m) in failed)
    if rc is None or not all_corrupt:
        if error is not None:
            raise error
        detail = "; ".join(f"rank {r}: {m}" for r, (_c, m) in failed)
        raise (CheckpointCorruptError if all_corrupt else CheckpointError)(
            f"checkpoint {input_dir} failed verification on peer host(s): {detail}")
    from .elastic import ensure_local_checkpoint

    logger.warning(f"local checkpoint {input_dir} is corrupt on {len(failed)}/"
                   f"{state.num_processes} host(s); restoring from replica {rc.target}")

    def park():
        if error is not None and os.path.isdir(input_dir):
            corrupt = input_dir + ".corrupt"
            shutil.rmtree(corrupt, ignore_errors=True)
            os.rename(input_dir, corrupt)

    if state.is_main_process:
        park()
    if state.num_processes > 1:
        state.wait_for_everyone("accelerate_tpu_torch.elastic.park_corrupt")
        if not state.is_main_process:
            park()
    ensure_local_checkpoint(rc, os.path.dirname(input_dir), name=os.path.basename(input_dir))
    verify_checkpoint(input_dir, level=level)


def _saved_topology(input_dir: str) -> dict:
    """The topology a manifest records (``{}`` without one), its
    ``num_processes`` the top-level one the gate has always read."""
    try:
        manifest = read_commit_manifest(input_dir)
    except CheckpointError:
        return {}
    topo = dict(manifest.get("topology") or {})
    if "num_processes" in manifest:
        topo["num_processes"] = manifest["num_processes"]
    return topo


def _topology_gate(input_dir: str, elastic: bool) -> dict:
    """A checkpoint saved by another number of processes loads only with
    ``elastic=True`` (the JAX package's contract); raised before any tensor
    is read. Returns the saved topology."""
    from .utils.fault import CheckpointTopologyError

    topo = _saved_topology(input_dir)  # verify="off": a tree without a manifest records no world
    saved = topo.get("num_processes")
    live = PartialState().num_processes
    if saved is None or saved == live:
        return topo
    if not elastic:
        raise CheckpointTopologyError(
            f"checkpoint {input_dir} was saved on a different topology: num_processes {saved} "
            f"(saved) != {live} (live). Pass elastic=True to load_state/resume_from_latest to "
            "load it into this run's layout.")
    logger.warning(f"elastic load: {input_dir} was saved by {saved} processes, loading into {live}")
    return topo


def _load_sharded_model(model, path: str, what: str) -> None:
    """Load whole tensors into a model with ``DTensor`` parameters: the
    main process reads them (a Llama's stacked keys split into its
    per-layer names) and ``set_model_state_dict`` hands every rank its
    shards."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict

    module = unwrap_model(model)
    opts = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True)
    if not PartialState().is_main_process:
        set_model_state_dict(model, {}, options=opts)
        return
    with SafetensorsReader(path) as reader:
        sd = {}
        for key, fqns, stacked in _key_layout(module):
            if key not in reader:
                raise CheckpointComponentMissingError(f"{path} has no tensor {key!r} for {what}")
            t = reader.get(key)
            sd.update(zip(fqns, t.unbind(0)) if stacked else [(fqns[0], t)])
        set_model_state_dict(model, sd, options=opts)


def _load_sharded_optimizer(opt, model, path: Optional[str], meta: dict) -> None:
    """:func:`_load_optimizer` for an optimizer of a sharded model: the
    main process splits each stacked parameter's state into its per-layer
    parameters' and ``set_optimizer_state_dict`` hands out the shards."""
    from torch.distributed.checkpoint.state_dict import StateDictOptions, set_optimizer_state_dict

    opts = StateDictOptions(full_state_dict=True, broadcast_from_rank0=True)
    osd: dict = {}
    reader = None
    if PartialState().is_main_process:
        layout, _ = _opt_layout(opt, model)
        state: dict = {}

        def put(name, value):
            _, idx, key = name.split(".", 2)
            fqns, stacked = layout[int(idx)]
            split = stacked and isinstance(value, torch.Tensor) and value.dim() > 0
            for i, f in enumerate(fqns):
                # each layer its own tensor: AdamW steps a 0-dim step
                # counter in place, and one shared by L layers would count L
                # times an update
                state.setdefault(f, {})[key] = (value[i] if split else value.clone()
                                                if isinstance(value, torch.Tensor) else value)

        if path is not None:
            reader = SafetensorsReader(path)
            for name in reader.keys():
                put(name, reader.get(name))
        for name, value in meta.get("scalars", {}).items():
            put(name, value)
        groups = [{**{k: v for k, v in g.items() if k != "params"},
                   "params": [f for i in g["params"] for f in layout[i][0]]}
                  for g in meta["param_groups"]]
        osd = {"state": state, "param_groups": groups}
    try:
        set_optimizer_state_dict(model, opt.optimizer, osd, options=opts)
    finally:
        if reader is not None:
            reader.close()
    opt._step_count = meta.get("step_count", 0)


def load_accelerator_state(accelerator, input_dir: Optional[str] = None,
                           verify: Optional[str] = None, elastic: bool = False, **kwargs) -> None:
    """Restore the training state. With no ``input_dir``: the newest
    committed ``checkpoint_N`` under the project directory. The directory
    is verified at ``verify`` (default ``ACCELERATE_CHECKPOINT_VERIFY``,
    else ``"marker"``) and a failure raises the taxonomy's error:
    ``CheckpointNotFoundError``, ``CheckpointUncommittedError``,
    ``CheckpointCorruptError`` or ``CheckpointComponentMissingError``.

    With a ``ReplicationConfig`` (``elastic.py``) a tree missing or corrupt
    on some process is restored from a checksum-verified replica first.
    With ``elastic=True`` each loader's position is remapped from the
    saved global batch to the live one (``remap_sampler_state``)."""
    state = PartialState()
    wait_for_async_saves()
    input_dir = _resolve_for_load(accelerator, input_dir)
    _ensure_present(accelerator, input_dir)
    _verify_or_heal(accelerator, input_dir, _verify_level(verify))
    saved_topology = _topology_gate(input_dir, elastic)

    def suffix(i):
        return "" if i == 0 else f"_{i}"

    for i, model in enumerate(accelerator._models):
        path = os.path.join(input_dir, f"{MODEL_NAME}{suffix(i)}")
        if not os.path.isdir(path):
            raise CheckpointComponentMissingError(
                f"checkpoint {input_dir} has no '{MODEL_NAME}{suffix(i)}' component for prepared "
                f"model {i}")
        if _has_dtensor(model):
            _load_sharded_model(model, path, what=f"prepared model {i}")
        else:
            _load_tensors(model_tensors(model), path, what=f"prepared model {i}")

    meta_path = os.path.join(input_dir, "optimizer_meta.json")
    metas = []
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            metas = json.load(f)
    for i, opt in enumerate(accelerator._optimizers):
        path = os.path.join(input_dir, f"{OPTIMIZER_NAME}{suffix(i)}")
        if i >= len(metas):
            logger.warning(f"checkpoint {input_dir} has no state for optimizer {i}; it keeps "
                           "its live state")
            continue
        path = path if os.path.isdir(path) else None
        owner = _owner(accelerator, opt)
        if _has_dtensor(owner):
            _load_sharded_optimizer(opt, owner, path, metas[i])
        else:
            _load_optimizer(opt, path, metas[i])

    for i, sched in enumerate(accelerator._schedulers):
        p = os.path.join(input_dir, f"{SCHEDULER_NAME}{suffix(i)}.json")
        if os.path.exists(p):
            with open(p) as f:
                sched.load_state_dict(json.load(f))

    p = os.path.join(input_dir, f"{SAMPLER_NAME}.json")
    if os.path.exists(p):
        with open(p) as f:
            payload = json.load(f)
        accelerator.step = payload.get("step", 0)
        for dl, sd in zip(accelerator._dataloaders, payload.get("dataloaders", [])):
            if not hasattr(dl, "load_state_dict"):
                continue
            if elastic and sd:
                sd = _remap_loader_state(dl, sd, saved_topology)
            dl.load_state_dict(sd)

    p = os.path.join(input_dir, "scaler.json")
    if accelerator.scaler is not None and os.path.exists(p):
        with open(p) as f:
            accelerator.scaler.load_state_dict(json.load(f))

    rng_path = os.path.join(input_dir, f"{RNG_STATE_NAME}_{state.process_index}.pkl")
    if not os.path.exists(rng_path):
        rng_path = os.path.join(input_dir, f"{RNG_STATE_NAME}_0.pkl")
    if os.path.exists(rng_path):
        with open(rng_path, "rb") as f:
            _restore_rng_state(pickle.load(f))

    for i, obj in enumerate(accelerator._custom_objects):
        p = os.path.join(input_dir, CUSTOM_STATE_PATTERN.format(i) + ".pkl")
        if os.path.exists(p):
            with open(p, "rb") as f:
                obj.load_state_dict(pickle.load(f))
    accelerator._last_committed_checkpoint = input_dir
    logger.info(f"Loaded state from {input_dir}")


# ------------------------------------------------------- interchange format
def save_model_checkpoint(model, save_directory: str, max_shard_size: str = "10GB") -> None:
    """A model's tensors as sharded safetensors with an index: the
    interchange format (``Accelerator.save_model``)."""
    os.makedirs(save_directory, exist_ok=True)
    state = PartialState()
    tensors = full_model_tensors(model, cpu_offload=True)
    if state.is_main_process:
        save_sharded_safetensors(tensors, save_directory, max_shard_size=max_shard_size)
    state.wait_for_everyone("accelerate_tpu_torch.checkpointing.save_model_checkpoint")


def load_model_checkpoint(model, load_directory: str) -> None:
    """Load a safetensors checkpoint of the model's tensors into it (a
    sharded model on every process together)."""
    if _has_dtensor(model):
        _load_sharded_model(model, load_directory, what="the model")
    else:
        _load_tensors(model_tensors(model), load_directory, what="the model")
