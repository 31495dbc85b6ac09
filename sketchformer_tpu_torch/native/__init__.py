"""Native (C) host-side batch assembly with transparent build + fallback.

``get_batcher()`` returns the compiled ``_batcher`` extension module, building
it on first use with the system toolchain (no pip). If the toolchain or
build fails, callers fall back to the numpy implementations in
data/tokenizer.py / data/pipeline.py — identical semantics, slower host path
(equivalence pinned by tests/test_native.py).
"""

from __future__ import annotations

import os
import subprocess
import sys
import sysconfig
from typing import Optional

_cached = None
_build_attempted = False


def _build_dir() -> str:
    return os.path.join(os.path.dirname(__file__), "_build")


def _so_path() -> str:
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(_build_dir(), f"_batcher{suffix}")


def build(verbose: bool = False) -> str:
    """Compile batcher.c into the package-local _build dir; returns .so path."""
    import numpy as np

    src = os.path.join(os.path.dirname(__file__), "batcher.c")
    out = _so_path()
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(_build_dir(), exist_ok=True)
    cc = os.environ.get("CC", "cc")
    cmd = [
        cc, "-O3", "-shared", "-fPIC", "-std=c99",
        f"-I{sysconfig.get_paths()['include']}",
        f"-I{np.get_include()}",
        src, "-o", out,
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"native batcher build failed:\n{res.stderr[:2000]}")
    if verbose:
        print(f"built {out}")
    return out


def get_batcher() -> Optional[object]:
    """The compiled extension module, or None if unavailable."""
    global _cached, _build_attempted
    if _cached is not None:
        return _cached
    if _build_attempted:
        return None
    _build_attempted = True
    if os.environ.get("SKETCHFORMER_TPU_NO_NATIVE"):
        return None
    try:
        so = build()
    except Exception:
        return None
    import importlib.util

    spec = importlib.util.spec_from_file_location("_batcher", so)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    except Exception:
        return None
    _cached = mod
    return mod
