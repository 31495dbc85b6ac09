"""The port's ``bench`` subcommand, which runs the benchmark's cells
(``BENCHMARK.json``), and the port's two benchmark tools against the JAX
side's ``tools/``: the tools' constants, the decoded-length statistics and
the gallery's shards."""

import importlib.util
import json
import pathlib
import subprocess

import numpy as np
import pytest

from sketchformer_tpu.data import synthetic as jax_synthetic
from sketchformer_tpu.data.shards import write_shards as jax_write_shards
from sketchformer_tpu_torch import cli
from sketchformer_tpu_torch.tools import (
    bench_decode_realistic,
    bench_embed_pipeline,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def record_calls(monkeypatch, rcs):
    """Replace ``subprocess.call`` by a recorder of its arguments that
    returns ``rcs`` in turn; returns the list of recorded calls."""
    calls = []

    def call(argv, **kw):
        calls.append((list(argv), kw))
        return rcs[len(calls) - 1]

    monkeypatch.setattr(subprocess, "call", call)
    return calls


def test_bench_runs_every_cell_in_order(monkeypatch):
    """One process of the benchmark's command per cell, in the order of
    ``workloads``, from the repo root, its output not captured."""
    calls = record_calls(monkeypatch, [0] * len(SPEC["workloads"]))
    assert cli.main(["bench"]) == 0
    assert [argv for argv, _ in calls] == [
        [*SPEC["command"], "--workload", w["name"], "--seed", "0",
         "--seconds", str(SPEC["run_seconds"])] for w in SPEC["workloads"]]
    for _, kw in calls:
        assert kw == {"cwd": str(ROOT)}


@pytest.mark.parametrize("failing,want", [
    ((), 0), ((1,), 1), ((0,), 1), ((0, 1, 2, 3), 1),
], ids=["none", "second", "first", "every"])
def test_bench_runs_every_cell_and_fails_if_one_did(monkeypatch, failing,
                                                    want):
    n = len(SPEC["workloads"])
    calls = record_calls(monkeypatch,
                         [3 if i in failing else 0 for i in range(n)])
    assert cli.main(["bench"]) == want
    assert [argv[argv.index("--workload") + 1] for argv, _ in calls] == \
        [w["name"] for w in SPEC["workloads"]]


def test_bench_takes_no_option(monkeypatch):
    record_calls(monkeypatch, [])
    with pytest.raises(SystemExit):
        cli.main(["bench", "--device", "cpu"])


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,constants", [
    ("bench_decode_realistic", ("RECIPE", "RECIPE_HASH", "EOS_ID", "DEC_T",
                                "DEC_B", "TRAIN_B")),
    ("bench_embed_pipeline", ("GALLERY_N", "BATCH", "BUCKET")),
])
def test_tool_constants_equal_the_jax_tools(name, constants):
    jtool = _jax_tool(name)
    port = {"bench_decode_realistic": bench_decode_realistic,
            "bench_embed_pipeline": bench_embed_pipeline}[name]
    for k in constants:
        assert getattr(port, k) == getattr(jtool, k), k
    if name == "bench_decode_realistic":
        assert json.dumps(port.RECIPE) == json.dumps(jtool.RECIPE)


EOS = bench_decode_realistic.EOS_ID


def test_length_stats():
    ids = np.full((4, 10), 5, np.int32)
    ids[0, 4] = EOS             # length 5
    ids[1, 0] = EOS             # EOS at step 1: length 1
    ids[1, 5] = EOS             # a later EOS does not count
    # rows 2 and 3 never emit EOS: the whole horizon, 10
    got = bench_decode_realistic.length_stats(ids)
    assert got == {"terminated_frac": 0.5, "len_mean": 6.5,
                   "len_p90": 10}
    # the 90th percentile of lengths 5 and 1 is 4.6, kept as an int
    assert bench_decode_realistic.length_stats(ids[:2]) == {
        "terminated_frac": 1.0, "len_mean": 3.0, "len_p90": 4}
    assert bench_decode_realistic.length_stats(ids[2:])["len_mean"] == 10.0


def test_gallery_shards_equal_the_jax_tools(tmp_path):
    n = 640
    port_dir = bench_embed_pipeline.prepare_gallery(n, out=str(tmp_path / "p"))
    # the JAX tool's prepare_gallery, into another directory
    jax_dir = tmp_path / "j"
    sketches, labels = jax_synthetic.generate_dataset(64, n // 64, seed=11)
    jax_write_shards(str(jax_dir), sketches, np.asarray(labels),
                     [f"c{i}" for i in range(64)],
                     splits=(0.98, 0.01, 0.01), shard_size=8192, seed=5)
    names = sorted(p.name for p in jax_dir.iterdir())
    assert sorted(p.name for p in pathlib.Path(port_dir).iterdir()) == names
    assert "meta.npz" in names and "train_0000.npz" in names
    for f in names:
        with np.load(jax_dir / f) as a, np.load(pathlib.Path(port_dir) / f) \
                as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    # a second call finds the gallery and writes nothing
    assert bench_embed_pipeline.prepare_gallery(n, out=port_dir) == port_dir
