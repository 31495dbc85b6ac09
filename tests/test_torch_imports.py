"""The port stands alone: no module of ``sketchformer_tpu_torch`` and no
line of ``chip_smoke.py`` imports the JAX package, JAX itself or the
repo-root ``tools`` package (the JAX side's scripts), and the port's own
``tools`` import neither TensorFlow nor protobuf (the card's host has
neither); and the port's own copy of the data path gives the JAX package's
batches bit for bit, from the same arguments."""

import ast
import pathlib

import numpy as np
import pytest

import sketchformer_tpu.native as jax_native
import sketchformer_tpu_torch.native as port_native
from sketchformer_tpu.data.registry import get_dataloader_by_name as jax_loader
from sketchformer_tpu_torch.data.registry import (
    get_dataloader_by_name as port_loader,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")
FILES = sorted((ROOT / "sketchformer_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# the port's tools read TF2 checkpoints themselves (data/tfrecord.py keeps
# its lazy TensorFlow import, as the JAX package's copy does)
TOOLS = sorted((ROOT / "sketchformer_tpu_torch" / "tools").glob("*.py"))
TOOLS_FORBIDDEN = ("tensorflow", "google.protobuf")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def _forbidden(name):
    top = name.split(".")[0]
    return top in FORBIDDEN or top in ("sketchformer_tpu", "tools")


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_package_imports(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {name}"
           for line, name in _imports(path) if _forbidden(name)]
    assert not bad, bad


@pytest.mark.parametrize("path", TOOLS,
                         ids=[str(p.relative_to(ROOT)) for p in TOOLS])
def test_port_tools_import_no_tensorflow(path):
    bad = [f"{path.relative_to(ROOT)}:{line} imports {name}"
           for line, name in _imports(path)
           if _forbidden(name) or any(name == m or name.startswith(m + ".")
                                      for m in TOOLS_FORBIDDEN)
           or name == "google"]
    assert not bad, bad


def test_the_walk_sees_the_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "pipeline.py", "encoder_stack_train.py",
            "decoder_stack_train.py", "cli.py", "token_ce.py",
            "dropout_prng.py", "multiprocess.py", "registry.py",
            "basic_usage.py", "import_reference_weights.py",
            "tf_bundle.py"} <= names
    assert ROOT / "sketchformer_tpu_torch" / "parallel" / "__init__.py" in FILES
    assert {p.name for p in TOOLS} == {"__init__.py",
                                       "import_reference_weights.py",
                                       "tf_bundle.py"}


def _batches(get_loader, token_mode, split, n=3):
    loader = get_loader("synthetic")(
        num_classes=7, sketches_per_epoch=200, batch_size=16,
        buckets=(48, 96), token_mode=token_mode, seed=3)
    it = (loader.batch_iterator("train", epoch=1) if split == "train"
          else iter(loader.get_validation_set(max_batches=n)))
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("token_mode", [True, False], ids=["tok", "cont"])
@pytest.mark.parametrize("split", ["train", "valid"])
def test_synthetic_batches_bit_equal(monkeypatch, native, token_mode, split):
    if native:
        if jax_native.get_batcher() is None:
            pytest.skip("no C toolchain for the native batch builder")
        assert port_native.get_batcher() is not None
    else:
        monkeypatch.setattr(jax_native, "get_batcher", lambda: None)
        monkeypatch.setattr(port_native, "get_batcher", lambda: None)
    want = _batches(jax_loader, token_mode, split)
    got = _batches(port_loader, token_mode, split)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
