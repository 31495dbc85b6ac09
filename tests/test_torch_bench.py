"""The port's benchmark (``sketchformer_tpu_torch/bench.py``) and its two
tools against the repo-root ``bench.py`` and ``tools/`` of the JAX side:
the result line's keys, the CPU run's JSON lines, a failing section, the
encode FLOPs, the tools' constants, the decoded-length statistics and the
gallery's shards."""

import ast
import importlib.util
import json
import pathlib

import numpy as np
import pytest

from sketchformer_tpu.data import synthetic as jax_synthetic
from sketchformer_tpu.data.shards import write_shards as jax_write_shards
from sketchformer_tpu_torch import bench
from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.tools import (
    bench_decode_realistic,
    bench_embed_pipeline,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
# the JAX benchmark's keys the port leaves out (the last three record its
# tools' fresh-subprocess retries, which are not ported), and those it
# must add
DROPPED = {"vs_baseline", "mfu_encode_note", "link_rtt_ms", "backend",
           "embed_pipeline_attempts", "decode_realistic_attempts",
           "decode_realistic_degraded"}
ADDED = {"gpu", "torch", "cuda", "nvcc"}
CPU_SECTION_KEYS = ("encode_ms_per_batch", "mfu_encode",
                    "train_sketches_per_sec", "decode_p50_ms",
                    "decode_sketches_per_sec")


def _key_names(node):
    """The key(s) a subscript or dict key writes: a string, or an f-string
    with ``{tag}`` taking T96 / T192 (other fields stay as ``{name}``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, ast.JoinedStr):
        text = "".join(v.value if isinstance(v, ast.Constant)
                       else "{" + ast.unparse(v.value) + "}"
                       for v in node.values)
        if "{tag}" in text:
            return {text.replace("{tag}", t) for t in ("T96", "T192")}
        return {text}
    return set()


def _is_result(node):
    return (isinstance(node, ast.Name) and node.id in ("result", "extras")
            or isinstance(node, ast.Attribute)
            and node.attr in ("result", "extras"))


def written_keys(path):
    """Every key a benchmark file writes to its result line: subscript
    assignments to ``result`` / ``extras`` and the keys of the dicts
    assigned to them."""
    keys = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Subscript) and _is_result(t.value):
                keys |= _key_names(t.slice)
            elif _is_result(t) and isinstance(node.value, ast.Dict):
                for k in node.value.keys:
                    keys |= _key_names(k)
    return keys


def test_result_keys_are_the_jax_benchmarks():
    jax_keys = written_keys(ROOT / "bench.py")
    port_keys = written_keys(ROOT / "sketchformer_tpu_torch" / "bench.py")
    assert {"encode_T96_h8_sketches_per_sec",
            "encode_T192_h8_sketches_per_sec", "{name}_error", "mfu_encode",
            "train_B1024_sketches_per_sec"} <= jax_keys
    assert DROPPED <= jax_keys
    assert set(bench.DROPPED_KEYS) == DROPPED
    assert ADDED <= set(bench.ADDED_KEYS)
    assert port_keys == (jax_keys - DROPPED) | set(bench.ADDED_KEYS)


def _lines(capsys):
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines and all(line.startswith("{") for line in lines), out[:500]
    return [json.loads(line) for line in lines]


# keys whose values change as the run goes on
MOVING = {"bench_elapsed_s", "section_s", "skipped"}


def test_cpu_run_prints_only_cumulative_json_lines(capsys, monkeypatch):
    monkeypatch.delenv(bench.BUDGET_ENV, raising=False)
    assert bench.main(["--device", "cpu"]) == 0
    lines = _lines(capsys)
    # one line after the headline, train and decode, and the final one
    assert len(lines) == 4
    for a, b in zip(lines, lines[1:]):
        assert set(a) == set(b) == {"metric", "value", "unit", "extras"}
        assert set(a["extras"]) <= set(b["extras"])
        for k, v in a["extras"].items():
            if k not in MOVING:
                assert b["extras"][k] == v, k
    last = lines[-1]
    ex = last["extras"]
    assert last["value"] > 0 and last["metric"] == \
        "encode_sketches_per_sec_per_chip"
    assert all(k in ex for k in CPU_SECTION_KEYS)
    assert ex["train_sketches_per_sec"] > 0 and ex["decode_p50_ms"] > 0
    assert ex["device"] == "cpu" and ex["mfu_encode"] is None
    assert ex["skipped"] == [] and not any(k.endswith("_error") for k in ex)
    assert set(ex["section_s"]) == {"headline", "train", "decode"}


def test_a_failing_section_is_recorded_and_fails_the_run(capsys,
                                                         monkeypatch):
    def broken(run):
        raise RuntimeError("kernel disagreed")

    def cheap_headline(run):
        run.result["value"] = 1.0

    monkeypatch.setattr(bench, "sec_train", broken)
    monkeypatch.setattr(bench, "sec_headline", cheap_headline)
    assert bench.main(["--device", "cpu"]) == 1
    lines = _lines(capsys)
    ex = lines[-1]["extras"]
    assert ex["train_error"] == "RuntimeError: kernel disagreed"
    assert "train_sketches_per_sec" not in ex
    # the run went on past the failure
    assert ex["decode_p50_ms"] > 0
    assert [k for k in ex if k.endswith("_error")] == ["train_error"]


@pytest.mark.parametrize("estimates,budget,ran", [
    # after the first section that does not fit, every later one is
    # skipped too, however small
    ((1.0, 100.0, 0.2), 10.0, ["headline"]),
    # the budget spent is the estimates of the sections run, however fast
    # they ran: 10 + 4 is more than 13.5
    ((10.0, 4.0, 0.8), 13.5, ["headline"]),
    ((10.0, 4.0, 0.8), 14.8, ["headline", "b", "c"]),
], ids=["prefix", "planned", "fits"])
def test_the_budget_yields_a_prefix(estimates, budget, ran, capsys,
                                    monkeypatch):
    """A section runs when its estimate and those of the sections run
    before it fit in the budget, whatever the clock."""
    done = []

    def section(name):
        def fn(run):
            done.append(name)
            run.result["value"] = 1.0
        return fn

    names = ("headline", "b", "c")
    monkeypatch.setattr(bench, "sections", lambda: [
        (n, e, section(n)) for n, e in zip(names, estimates)])
    monkeypatch.setenv(bench.BUDGET_ENV, str(budget))
    assert bench.main(["--device", "cpu"]) == 0
    ex = _lines(capsys)[-1]["extras"]
    assert done == ran
    assert ex["skipped"] == [n for n in names if n not in ran]
    assert ex["budget_s"] == budget and set(ex["section_s"]) == set(ran)


def test_prefix_budget_runs_the_first_sections(capsys, monkeypatch):
    """``prefix_budget(n)`` runs the real table's first n sections and
    skips the rest, as the chip smoke's bench phase sets it."""
    done = []
    table = bench.sections()

    def section(name):
        def fn(run):
            done.append(name)
            run.result["value"] = 1.0
        return fn

    monkeypatch.setattr(bench, "sections", lambda: [
        (n, e, section(n)) for n, e, _ in table])
    for n in (1, 2, 3):
        done.clear()
        monkeypatch.setenv(bench.BUDGET_ENV, str(bench.prefix_budget(n)))
        assert bench.main(["--device", "cpu"]) == 0
        assert done == [name for name, _, _ in table[:n]]
        capsys.readouterr()


def test_grad_errors_floor_and_nan():
    """The worst leaf's relative error, a leaf's norm floored at
    GRAD_FLOOR of the whole gradient's, a NaN the worst whatever follows."""
    import torch

    from sketchformer_tpu_torch.utils import checks

    want = {"w": torch.ones(100), "key_bias": torch.full((4,), 1e-9),
            "b": torch.ones(4)}
    got = {k: v.clone() for k, v in want.items()}
    got["key_bias"] += 1e-5        # rounding on a leaf whose gradient is ~0
    got["b"][0] += 0.5             # one wrong leaf: 0.5 / 2
    worst, leaf, whole = checks.grad_errors(got, want)
    assert leaf == "b" and worst == pytest.approx(0.25)
    assert whole == pytest.approx(0.5 / np.sqrt(104), rel=1e-6)
    # the key bias alone is 2e-5 / (1e-3 * sqrt(104)), far below 0.25
    got["b"] = want["b"].clone()
    assert checks.grad_errors(got, want)[1] == "key_bias"
    assert checks.grad_errors(got, want)[0] < 2e-3
    got["w"][0] = float("nan")
    worst, leaf, _ = checks.grad_errors(got, want)
    assert leaf == "w" and np.isnan(worst)


def test_embed_flops_per_sketch():
    cfg = SketchformerConfig(d_model=256, num_layers=8, dff=512)
    assert bench.embed_flops_per_sketch(cfg, 96) == 880_803_840


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
