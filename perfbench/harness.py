"""What every cell shares: finding its files by name, the seeded weights,
the program's configuration, the per-layer metric readers and the result
line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
harness reads ``perfbench/configs/<config>.json``, ``perfbench/traffic/
<traffic>.json`` and ``perfbench/limits/<cell>.json`` (the limits of its
output check, and the control they were set against), and each per-layer metric's reader
``perfbench/metrics/<metric>.py`` (or the reader of the metric's stem,
``perfbench/metrics/<stem>.py``). The traffic file's ``path`` names the
driver (``paths.py``) that generates its inputs from the seed and drives
the program.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from perfbench.reference import model as ref_model

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCHMARK = ROOT / "BENCHMARK.json"

# the shrink of a CPU rehearsal (``run.py --rehearse``): tiny widths in
# float32 on the kernels' plain versions, dropout off (the CPU draws its
# dropout from another generator than the card's Philox)
REHEARSAL_CONFIG = dict(d_model=32, num_layers=2, num_heads=4, dff=64,
                        lowerdim=32, vocab_size=64, num_classes=16,
                        max_len=24, dtype="float32", dropout=0.0)
REHEARSAL_TRAFFIC = dict(batch=4, seq_len=24, decode_len=24, pool=3,
                         len_max=22, len_min=4, trace_units=2, trace_at=1)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files."""

    name: str
    bench: dict
    workload: dict
    cfg: dict
    traffic: dict
    limits: dict

    @property
    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    @property
    def per_layer(self) -> List[dict]:
        moved = {m["name"] for m in self.end_to_end}
        return [m for m in self.bench["per_layer"]
                if self.name in m.get("workloads", [self.name])
                and m["moves"] in moved]


def load_cell(name: str, rehearse: bool = False) -> Cell:
    bench = load_json(BENCHMARK)
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise SystemExit(f"no workload {name!r} in {BENCHMARK}")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    cfg = load_json(ROOT / conf["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    if rehearse:
        cfg = {**cfg, **REHEARSAL_CONFIG}
        traffic = {**traffic, **{k: v for k, v in REHEARSAL_TRAFFIC.items()
                                 if k in traffic}}
    return Cell(name, bench, w, cfg, traffic, limits)


# ---------------------------------------------------------------------------
# weights and the program's model
# ---------------------------------------------------------------------------


def make_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter of the configuration, drawn on ``device`` from
    ``seed`` in one call (f32, the type the program keeps its parameters
    in): drawn parameters are slices of one normal draw times their std;
    biases are zero and LayerNorm scales one."""
    specs = ref_model.param_specs(cfg)
    n = sum(_numel(s) for _, s, kind, _ in specs if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=gen, device=device)
    out, at = {}, 0
    for name, shape, kind, std in specs:
        if kind == "normal":
            k = _numel(shape)
            out[name] = flat[at:at + k].view(shape) * std
            at += k
        elif kind == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def program_model(cfg: dict, params: Dict[str, torch.Tensor], device):
    """The program's model of ``cfg`` on ``device`` holding ``params``."""
    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    fields = {f.name for f in dataclasses.fields(SketchformerConfig)}
    pc = SketchformerConfig(**{k: v for k, v in cfg.items() if k in fields})
    model = Sketchformer(pc).to(device)
    model.load_state_dict(params, strict=True)
    return model


# ---------------------------------------------------------------------------
# per-layer metric readers
# ---------------------------------------------------------------------------


def load_reader(name: str) -> Callable:
    """``read(ctx)`` of ``metrics/<name>.py``, or else of the reader its
    stem names (``metrics/idle_share.py`` for ``idle_share.embed``, with
    the cell's traffic in ``ctx``): the metric's value, or None where the
    run gave it nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Context:
    """What a reader reads: the cell, its traced sub-window (``trace``,
    None where nothing was traced) and each traced unit's inputs
    (``traced``: dicts of its lengths)."""

    cell: Cell
    trace: Optional[Any]
    traced: List[dict]

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


# ---------------------------------------------------------------------------
# the result line
# ---------------------------------------------------------------------------


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
