"""CPU rehearsals of the benchmark: every cell's driver at tiny widths on
the kernels' plain versions, the result line's shape, the harness finding
a new configuration, traffic mix and metric by name, the output check
failing on a broken timed path, and the control failing it at a size a
test run holds."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from perfbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def rehearse(root: Path, cell: str, trace: int, seconds: float = 1.0):
    out = subprocess.run(
        [sys.executable, str(root / "perfbench" / "run.py"), "--workload",
         cell, "--seed", str(2**31 + 12345), "--seconds", str(seconds),
         "--trace", str(trace), "--rehearse"],
        capture_output=True, text=True, timeout=600, cwd=root,
        env={**_env(), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


def _env():
    import os
    return dict(os.environ)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_prints_a_result_line(cell):
    res, err = rehearse(ROOT, cell, 0)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0
    want = {m["name"] for m in BENCH["end_to_end"]
            if cell in m.get("workloads", CELLS)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    last = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in last)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_rehearsal_reports_only_per_layer_metrics(cell):
    res, _ = rehearse(ROOT, cell, 1)
    names = {m["name"] for m in BENCH["per_layer"]
             if cell in m.get("workloads", CELLS)}
    assert set(res["metrics"]) <= names
    assert res["correct"] is True


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, a limits file and a per-layer metric
    added as new files, and entries in BENCHMARK.json, need no edit of the
    harness."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "perfbench"
    cfg = json.loads((pb / "configs" / "tok_h8.json").read_text())
    cfg["name"] = "tok_small"
    (pb / "configs" / "tok_small.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "embed_b2048_t192.json")
                         .read_text())
    traffic.update(batch=8, seq_len=16, len_max=15, pool=2)
    (pb / "traffic" / "embed_b8_t16.json").write_text(json.dumps(traffic))
    (pb / "limits" / "tok_small.embed_b8_t16.json").write_text(
        json.dumps({"z_err": 0.035}))
    (pb / "metrics" / "window_ms_per_batch.embed.py").write_text(
        "def read(ctx):\n"
        "    t = ctx.trace\n"
        "    return 1e3 * t.window_s / t.units if t else None\n")
    # found by its stem: ``units.tiny`` is read by ``metrics/units.py``
    (pb / "metrics" / "units.py").write_text(
        "def read(ctx):\n"
        "    return float(len(ctx.traced)) if ctx.trace else None\n")
    bench = json.loads(json.dumps(BENCH))
    cell = "tok_small.embed_b8_t16"
    bench["configs"].append({"name": "tok_small", "source": "x",
                             "file": "perfbench/configs/tok_small.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": cell, "config": "tok_small",
                               "traffic": "embed_b8_t16", "chips": 1,
                               "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "embed_sketches_per_s":
            m["workloads"].append(cell)
    bench["per_layer"] += [
        {"name": "window_ms_per_batch.embed", "unit": "ms", "better": "lower",
         "source": "device_trace", "layer": "Embed path", "moves":
         "embed_sketches_per_s", "workloads": [cell]},
        {"name": "units.tiny", "unit": "batches", "better": "higher",
         "source": "device_trace", "layer": "Embed path", "moves":
         "embed_sketches_per_s", "workloads": [cell]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    res, _ = rehearse(tmp_path, cell, 0)
    assert set(res["metrics"]) == {"embed_sketches_per_s", "setup_s"}
    res, _ = rehearse(tmp_path, cell, 1)
    assert res["metrics"]["window_ms_per_batch.embed"]["value"] > 0
    assert res["metrics"]["units.tiny"]["value"] == 2


# ---------------------------------------------------------------------------
# the timed path broken underneath: the check must see it
# ---------------------------------------------------------------------------


def _alter_embed(monkeypatch):
    from sketchformer_tpu_torch.infer import encode

    real = encode.make_embed_fn

    def make(model, fast=True):
        fn = real(model, fast)

        def embed(enc, enc_mask=None):
            z = fn(enc, enc_mask).clone()
            z[0] = -z[0]       # an answer altered where it is produced
            return z
        return embed
    monkeypatch.setattr(encode, "make_embed_fn", make)


def _alter_decode(monkeypatch):
    from sketchformer_tpu_torch.infer import decode

    real = decode.make_token_decoder

    def make(model, *a, **kw):
        fn = real(model, *a, **kw)

        def dec(enc):
            ids = fn(enc).clone()
            ids[0, 1:] = (ids[0, 1:] + 17) % 60 + 3   # tokens altered
            return ids
        return dec
    monkeypatch.setattr(decode, "make_token_decoder", make)


def _unchanged_state(monkeypatch):
    from sketchformer_tpu_torch.train import schedule

    def step(self, grads, grad_norm):
        self.count += 1            # reports an update, moves nothing
        return True
    monkeypatch.setattr(schedule.NoamAdam, "step", step)


def _half_batch(monkeypatch):
    from sketchformer_tpu_torch.train import step

    real = step._forward_loss

    def forward_loss(model, batch, w_recon, w_cls):
        half = batch["enc"].shape[0] // 2
        return real(model, {k: v[:half] for k, v in batch.items()},
                    w_recon, w_cls)
    monkeypatch.setattr(step, "_forward_loss", forward_loss)


FAULTS = [
    ("tok_h8.embed_b2048_t192", _alter_embed),
    ("tok_h8.decode_b64_t192", _alter_decode),
    ("tok_h8.train_b1024_t96", _unchanged_state),
    ("tok_h8.train_b1024_t96", _half_batch),
    ("cont_mdn.train_b1024_t96", _unchanged_state),
    ("cont_mdn.train_b1024_t96", _half_batch),
]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch, capsys):
    from perfbench import run

    fault(monkeypatch)
    assert run.main(["--workload", cell, "--seed", "77", "--seconds",
                     "1", "--rehearse"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is False and res["failed"] == 0
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


# ---------------------------------------------------------------------------
# the control, at a size a test run holds
# ---------------------------------------------------------------------------

TEST_SIZE = dict(d_model=128, dff=256, max_len=64, lowerdim=128,
                 vocab_size=1024, num_layers=2)
TEST_TRAFFIC = dict(batch=16, seq_len=64, decode_len=64, len_max=62,
                    len_min=8)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(cell, seed):
    c = harness.load_cell(cell, rehearse=True)
    c.cfg.update(TEST_SIZE)
    c.traffic.update({k: v for k, v in TEST_TRAFFIC.items()
                      if k in c.traffic})
    got = control.readings(c, seed, torch.device("cpu"), 0.5)
    limits = {k: v for k, v in c.limits.items() if k != "control"}
    assert all(v <= limits[k] for k, v in got["program"].items()
               if k in limits)
    assert any(got["control"][k] > limits[k] for k in limits)
