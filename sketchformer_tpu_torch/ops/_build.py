"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into the package's
``_build/`` directory (listed in ``.gitignore``), and rebuilt whenever a
source is newer than the library. The library is loaded with ``ctypes``:
every pointer and the stream travel as ``c_void_p``. Nothing here runs at
import time, so machines without ``nvcc`` import the package freely. The
helpers at the end are what every kernel wrapper checks and passes before
a launch.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
LIB_NAME = "libsketchformer_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
_DROP = [_P, _U, _I, _I, _I]
# C entry points of csrc/*.cu: (argtypes, restype)
SIGNATURES = {
    # a dropout operand is (bytes ptr, seed, layer, site, T): _DROP
    "sk_linear": ([_I, _P, _P, _P, _P, *_DROP, _I, _F, _P, _I, _I, _I, _I,
                   _P], _I),
    "sk_linear_nt": ([_I, _I, _P, _P, *_DROP, _I, _F, _P, _P, _I, _P, _I, _I,
                      _I, _P], _I),
    "sk_linear_tn": ([_I, _I, _P, _P, *_DROP, _I, _F, _P, _I, _I, _I, _I, _P],
                     _I),
    "sk_attention_fwd": ([_I, _P, _L, _I, _P, _L, _I, _P, _L, _I, _P, _P, _P,
                          _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                          _P], _I),
    "sk_attention_bwd": ([_I, _I, _P, _L, _I, _P, _L, _I, _P, _L, _I, _P, _P,
                          _P, _P, _P, _P, _L, _I, _P, _P, _L, _I, _P, _L, _I,
                          _P, _L, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
                         _I),
    "sk_layernorm_bwd": ([_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
                         _I),
    "sk_sum_rows": ([_I, _P, *_DROP, _I, _F, _P, _I, _I, _I, _P], _I),
    "sk_emit_dropout_bits": ([_U, _P, _I, _I, _I, _I, _P], _I),
    "sk_token_ce_fwd": ([_I] + [_P] * 7 + [_I] * 4 + [_P], _I),
    "sk_token_ce_bwd": ([_I] + [_P] * 9 + [_I] * 5 + [_P], _I),
    "sk_encoder_attention": (
        [_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P], _I),
    "sk_layernorm_rows": ([_I, _P, _P, _P, _P, _I, _I, _P], _I),
    "sk_decode_attention": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
                            _I),
    "sk_decode_chunk": ([_I, _I] + [_P] * 21, _I),
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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

    Every ``.cu`` source compiles in its own ``nvcc`` process, all started
    together, and the objects link into one library. Returns ``{"path",
    "seconds", "built", "log"}``; ``log`` holds nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills per kernel).
    """
    out = BUILD_DIR / LIB_NAME
    srcs = sources()
    newest = max(p.stat().st_mtime for p in srcs)
    if not force and out.exists() and out.stat().st_mtime >= newest:
        return {"path": str(out), "seconds": 0.0, "built": False, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in (p for p in srcs if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for cmd, obj, proc in jobs:   # wait for every compile, failed or not
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{logs[-1][-8000:]}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr[-8000:]}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
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


# ---------------------------------------------------------------------------
# what every wrapper checks and passes before a launch
# ---------------------------------------------------------------------------


def stream(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, device, dtype, shape) -> None:
    """Raise unless ``t`` has this device, dtype and shape and is
    contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dtype_code(t: torch.Tensor) -> int:
    """The kernels' dtype code of ``t`` (float32 0, bfloat16 1)."""
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()
