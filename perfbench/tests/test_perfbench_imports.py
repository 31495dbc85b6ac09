"""What the harness loads: no module whose whole top-level name is
``jax``, ``jaxlib``, ``flax`` or ``sketchformer_tpu`` (the program's name
begins with the last and is allowed), and the reference loads nothing of
the program. Each check runs in a fresh interpreter."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "sketchformer_tpu"}
METRICS = sorted(p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py"))


def loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_nothing_forbidden():
    mods = loaded_after(
        "from perfbench import control, devtrace, harness, paths, run, work\n"
        + "".join(f"harness.load_reader({m!r})\n" for m in METRICS)
        + "import sketchformer_tpu_torch.infer.encode\n"
          "import sketchformer_tpu_torch.infer.decode\n"
          "import sketchformer_tpu_torch.infer.fast_decode\n"
          "import sketchformer_tpu_torch.train.step\n")
    assert {m.split(".")[0] for m in mods} & FORBIDDEN == set()
    assert "sketchformer_tpu_torch" in {m.split(".")[0] for m in mods}


def test_reference_loads_nothing_of_the_program():
    mods = loaded_after("import perfbench.reference.model\n"
                        "import perfbench.reference.philox\n")
    tops = {m.split(".")[0] for m in mods}
    assert tops & (FORBIDDEN | {"sketchformer_tpu_torch"}) == set()


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in (ROOT / "perfbench").rglob("*.py")
    if p.name != Path(__file__).name))
def test_no_source_reads_the_jax_benchmark(path):
    """No file of the benchmark names the JAX package's benchmark or its
    result files."""
    text = (ROOT / path).read_text()
    assert "BENCH_" not in text
    assert "import bench" not in text and "bench.py" not in text
