"""Build and load the port's hand-written CUDA kernels.

The sources in ``vis_tpu_torch/csrc/*.cu`` expose plain ``extern "C"``
entry points; on first use each is compiled by its own ``nvcc`` for
``sm_90a`` (all started together), and the objects are linked into one
shared library under ``build/vis_tpu_torch/`` (next to the package) and
bound with ctypes.  The library's file name carries a hash of
the sources, so an edited source builds anew.  Nothing here runs at import
time: CPU-only processes (the tests) import this module freely and never
build anything.

Every entry point returns a ``cudaError_t``; ``check`` raises on any
non-zero value, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "vis_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# name -> argtypes; every entry point returns int (cudaError_t).
_SIGNATURES = {
    "vt_q4_matmul": (_P, _P, _P, _P, _I, _I, _I, _P),
    "vt_q4_matmul_stacked": (_P, _P, _P, _P, _I, _I, _I, _P),
    "vt_flash_attention": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    "vt_q8_matmul": (_P, _P, _P, _P, _I, _I, _I, _P),
    "vt_q8_swiglu": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "vt_q4_matmul_folded": (_P, _P, _P, _P, _I, _I, _I, _P),
    "vt_q4_matmul_stacked_folded": (_P, _P, _P, _P, _I, _I, _I, _P),
    "vt_i4_matmul": (_P, _P, _P, _P, _I, _I, _I, _P),
    "vt_q4_fused_mlp": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libvis_tpu_torch_{digest.hexdigest()[:16]}.so"


def _run(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}")


def _build(target: Path) -> None:
    """One nvcc per source, all at once, then one link into ``target``."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{target.stem}.{os.getpid()}"
    objects, compiles = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objects.append(obj)
        compiles.append([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
    start = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(compiles)) as pool:
        for done in [pool.submit(_run, cmd) for cmd in compiles]:
            done.result()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    _run([nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objects]])
    os.replace(tmp, target)
    for obj in objects:
        obj.unlink()
    build_seconds = time.perf_counter() - start


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_of(tensor) -> ctypes.c_void_p:
    """The current stream of the tensor's own device (never the thread's)."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


__all__ = ["library", "library_path", "check", "stream_of", "BUILD_DIR"]
