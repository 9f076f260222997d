"""Build and load the port's CUDA kernels, and count their launches.

Each ``csrc/<source>.cu`` has a plain C interface and is compiled on its
own with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/kernels/<source>-<hash>.so`` at the
repository root, then loaded with :mod:`ctypes` (no PyTorch headers, so a
build takes seconds). The file name carries a hash of the source and
flags, so an edited source is rebuilt and a stale library is never loaded.
One source may hold several kernels, each with its own C entry point of
the kernel's name; headers shared by the sources (``csrc/*.cuh``) are part
of every source's hash. :func:`build_all` starts one ``nvcc`` per source, all
at once.

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
    "FILL_BLOCKS",
    "KERNELS",
    "SMS",
    "build_all",
    "count_launch",
    "launch_counts",
    "load",
    "reset_launch_counts",
    "check",
    "entry",
]

# kernel name (its C entry point) -> source file under accelerate_tpu_torch/csrc
KERNELS = {
    "flash_fwd": "flash_fwd.cu",
    "flash_fwd_mma": "flash_fwd.cu",
    "flash_bwd_dq": "flash_bwd.cu",
    "flash_bwd_dkv": "flash_bwd.cu",
    "flash_bwd_dq_mma": "flash_bwd.cu",
    "flash_bwd_dkv_mma": "flash_bwd.cu",
    "paged_decode": "paged_decode.cu",
    "paged_decode_int8": "paged_decode.cu",
    "paged_decode_mma": "paged_decode.cu",
    "paged_decode_int8_mma": "paged_decode.cu",
    "paged_verify": "paged_verify.cu",
    "paged_verify_int8": "paged_verify.cu",
    "paged_verify_mma": "paged_verify.cu",
    "paged_verify_int8_mma": "paged_verify.cu",
    "fused_sample": "fused_sample.cu",
    "quant_matmul": "quant_matmul.cu",
    "quant_matmul_mma": "quant_matmul.cu",
    "quant_matmul_splitk": "quant_matmul.cu",
}

# the card the kernels are built for (H100 SXM, sm_90a): its SMs, and the
# blocks that fill it at two per SM (the tile choices aim for that)
SMS = 132
FILL_BLOCKS = 2 * SMS

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}  # source file -> loaded library
_entries: Dict[str, object] = {}  # kernel name -> bound C entry point
_launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
# source file -> nvcc's stderr (ptxas register/shared-memory report) of its build
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


def _so_path(source: str) -> Path:
    # the shared headers are part of every source's build
    src = b"".join(p.read_bytes() for p in [_CSRC / source, *sorted(_CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the sources of every kernel in ``names`` (default: all) that
    are not built yet, one ``nvcc`` process per source, all started
    together. Returns the build seconds per source file (0.0 for a library
    already on disk). Raises ``RuntimeError`` with nvcc's output if any
    build fails."""
    sources = sorted({KERNELS[n] for n in (KERNELS if names is None else names)})
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    with _lock:
        for source in sources:
            so = _so_path(source)
            if so.exists():
                seconds[source] = 0.0
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / source)]
            procs[source] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                time.perf_counter(), tmp, so,
            )
        failed = []
        for source, (proc, t0, tmp, so) in procs.items():
            log, _ = proc.communicate()
            seconds[source] = time.perf_counter() - t0
            build_logs[source] = log
            if proc.returncode != 0:
                failed.append(f"--- {source} (nvcc exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library holding kernel ``name``, built first if needed."""
    source = KERNELS[name]
    lib = _libs.get(source)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = _libs[source] = ctypes.CDLL(str(_so_path(source)))
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
