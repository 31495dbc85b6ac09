"""The port's ``prep-data`` against the JAX CLI's: the same per-class inputs
(the sketch-rnn release's npz layout, or QuickDraw ndjson) give the same
shards, array for array, the same dictionary and the same JSON line."""

import json
import os

import numpy as np
import pytest

from sketchformer_tpu import cli as jax_cli
from sketchformer_tpu.data import synthetic
from sketchformer_tpu_torch import cli


def write_npz_classes(in_dir):
    rng = np.random.default_rng(0)
    for ci, name in enumerate(["cat", "dog"]):
        sks = [synthetic.generate_sketch(ci, rng) for _ in range(12)]
        np.savez(
            in_dir / f"{name}.npz",
            train=np.asarray(sks[:8], dtype=object),
            valid=np.asarray(sks[8:10], dtype=object),
            test=np.asarray(sks[10:], dtype=object),
        )


def write_ndjson_classes(in_dir):
    rng = np.random.default_rng(0)
    for name in ("apple", "bus"):
        with open(in_dir / f"{name}.ndjson", "w") as f:
            for _ in range(10):
                n1, n2 = rng.integers(3, 8, 2)
                drawing = [
                    [rng.integers(0, 255, n1).tolist(),
                     rng.integers(0, 255, n1).tolist()],
                    [rng.integers(0, 255, n2).tolist(),
                     rng.integers(0, 255, n2).tolist()],
                ]
                f.write(json.dumps({"drawing": drawing, "word": name}) + "\n")


CASES = {
    "npz_dictionary": (write_npz_classes,
                       ["--shard-size", "8", "--fit-dictionary",
                        "--dict-size", "16"]),
    "npz_limit_rdp": (write_npz_classes,
                      ["--shard-size", "5", "--per-class-limit", "3",
                       "--rdp-epsilon", "0.5", "--seed", "3"]),
    "ndjson_rdp": (write_ndjson_classes,
                   ["--shard-size", "8", "--rdp-epsilon", "2.0"]),
    "ndjson_format_limit": (write_ndjson_classes,
                            ["--format", "ndjson", "--per-class-limit", "4",
                             "--fit-dictionary", "--dict-size", "8"]),
}


def run(main, argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_prep_data_equals_jax(case, tmp_path, capsys):
    write, flags = CASES[case]
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    write(in_dir)
    outs = {}
    for tag, main in (("jax", jax_cli.main), ("port", cli.main)):
        out_dir = str(tmp_path / tag)
        rc, line = run(main, ["prep-data", "--input-dir", str(in_dir),
                              "--out-dir", out_dir, *flags], capsys)
        assert rc == 0
        assert line.pop("out_dir") == out_dir
        outs[tag] = line
    assert outs["jax"] == outs["port"]
    assert outs["port"]["classes"] == 2
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert ("dictionary.npz" in names) == ("--fit-dictionary" in flags)
    assert any(n.startswith("train_") for n in names)
    for name in names:
        with np.load(tmp_path / "jax" / name) as a, \
                np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)


@pytest.mark.parametrize("fmt", ["auto", "npz", "ndjson"])
def test_prep_data_without_inputs_returns_1(fmt, tmp_path, capsys):
    in_dir = tmp_path / "empty"
    in_dir.mkdir()
    (in_dir / "notes.txt").write_text("not a sketch file")
    argv = ["prep-data", "--input-dir", str(in_dir), "--out-dir",
            str(tmp_path / "out"), "--format", fmt]
    assert jax_cli.main(argv) == 1
    assert cli.main(argv) == 1
    assert not (tmp_path / "out").exists()
