"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/kernels/<name>-<hash>.so`` at the repository root,
then loaded with :mod:`ctypes` (no PyTorch headers, so a build takes
seconds). The file name carries a hash of the source and flags, so an
edited source is rebuilt and a stale library is never loaded.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Nothing here runs at import time: the first launch of a kernel builds it.
``CUDA_HOME`` names the toolkit when it is not in ``/usr/local/cuda``.

Launch counters: every kernel wrapper calls :func:`count_launch` exactly
where it launches its kernel, and nowhere else, so a run can show which
kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = [
    "KERNELS",
    "build_all",
    "count_launch",
    "launch_counts",
    "load",
    "reset_launch_counts",
    "check",
    "entry",
]

# kernel name -> source file under accelerate_tpu_torch/csrc
KERNELS = {
    "flash_fwd": "flash_fwd.cu",
    "paged_decode": "paged_decode.cu",
    "fused_sample": "fused_sample.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, object] = {}  # kernel name -> bound C entry point
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# nvcc's stderr (ptxas register/shared-memory report) of the last build
build_logs: Dict[str, str] = {}


def count_launch(name: str) -> None:
    _launches[name] += 1


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels are built on the machine with the card"
        )
    return found


def _so_path(name: str) -> Path:
    src = (_CSRC / KERNELS[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build every kernel in ``names`` (default: all) that is not built yet,
    one ``nvcc`` process per source, all started together. Returns the
    build seconds per kernel (0.0 for a library already on disk). Raises
    ``RuntimeError`` with nvcc's output if any build fails."""
    names = list(KERNELS if names is None else names)
    out_dir = _BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    with _lock:
        for name in names:
            so = _so_path(name)
            if so.exists():
                seconds[name] = 0.0
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / KERNELS[name])]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                time.perf_counter(), tmp, so,
            )
        failed = []
        for name, (proc, t0, tmp, so) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(_so_path(name)))
    return lib


def entry(name: str, n_ptr: int, n_int: int, n_float: int):
    """The C entry point ``name`` of kernel ``name``, with its ctypes
    signature: ``n_ptr`` pointers, ``n_int`` ints, ``n_float`` floats, then
    the stream (a pointer), returning an int error code. Every pointer is a
    ``c_void_p``: undeclared, ctypes would pass a Python int as a 32-bit
    int and cut the address."""
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(load(name), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        _entries[name] = fn
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code (the C entry points
    return ``cudaGetLastError()`` right after the launch: a refused launch
    never runs, and a later synchronize would not report it)."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name!r} launch failed with cudaError_t {code}")
