"""Each C entry point of the kernel library is declared to ``ctypes`` as the
CUDA source defines it (``ops/_build.py::SIGNATURES`` against
``csrc/*.cu``): a missing, extra or mistyped argument would shift every
argument after it, which no CPU test of a wrapper could see."""

import ctypes
import re

import pytest

from sketchformer_tpu_torch.ops import _build

C_TYPES = {"int": ctypes.c_int, "float": ctypes.c_float,
           "double": ctypes.c_double, "long long": ctypes.c_longlong,
           "unsigned long long": ctypes.c_ulonglong}


def _source() -> str:
    return "".join(p.read_text() for p in _build.sources()
                   if p.suffix == ".cu")


def _c_argtypes(src: str, name: str):
    m = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", src)
    assert m, f"{name} is not defined in csrc"
    out = []
    for param in m.group(1).split(","):
        kind = re.sub(r"\w+$", "", " ".join(param.split())).strip()
        out.append(ctypes.c_void_p if "*" in kind else C_TYPES[kind])
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_the_cuda_source(name):
    argtypes, restype = _build.SIGNATURES[name]
    assert restype is ctypes.c_int
    assert argtypes == _c_argtypes(_source(), name)
