"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into the package's
``_build/`` directory (listed in ``.gitignore``), and rebuilt whenever a
source is newer than the library. The library is loaded with ``ctypes``:
every pointer and the stream travel as ``c_void_p``. Nothing here runs at
import time, so machines without ``nvcc`` import the package freely.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libsketchformer_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points of csrc/encoder_stack.cu: (argtypes, restype)
SIGNATURES = {
    "sk_linear": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "sk_encoder_attention": (
        [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _P],
        _I),
    "sk_layernorm_rows": ([_I, _P, _P, _P, _P, _I, _I, _P], _I),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def build(force: bool = False) -> dict:
    """Compile the kernels if the library is missing or stale.

    Returns ``{"path", "seconds", "built", "log"}``; ``log`` holds nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel).
    """
    out = BUILD_DIR / LIB_NAME
    srcs = sources()
    newest = max(p.stat().st_mtime for p in srcs)
    if not force and out.exists() and out.stat().st_mtime >= newest:
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *(str(p) for p in srcs if p.suffix == ".cu")]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stderr[-8000:]}")
    os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
    log = res.stdout + res.stderr
    (BUILD_DIR / "build.log").write_text(log)
    return {"path": str(out), "seconds": seconds, "built": True, "log": log}


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once per process)."""
    lib = ctypes.CDLL(build()["path"])
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point reported a CUDA error after its launch."""
    if err != 0:
        raise RuntimeError(f"{kernel}: launch failed with cudaError_t {err}")
