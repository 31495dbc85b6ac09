"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout: finds the cell in ``BENCHMARK.json``, makes
its inputs and weights from ``--seed``, builds the program's entry (the
program's kernel library builds into the checkout at first use), warms up
the cell's shapes, measures for ``--seconds`` and then holds a sample of
what the window produced to the plain reference. ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics from a
profiled sub-window. The last line of stdout is the JSON result; the
numbers the check compared, each beside its limit, are the last lines of
stderr. It exits non-zero, printing no result, when the card the cell
needs is missing or a module of JAX or of the JAX package was loaded.
``--rehearse`` runs the cell at tiny widths on the CPU's plain routes (a
rehearsal of the control flow: no number it prints is a device number).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sketchformer_tpu")
CACHE = ROOT / ".perfbench_cache"
HOST_THREADS = 2


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help="tiny widths on the CPU's plain routes")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # load from one process with few threads: the host's side of the
    # program is launches and copies, and idle pool threads only add jitter
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, str(HOST_THREADS))
    # every cache a library might keep goes under the checkout, at a
    # fixed path (the program's own kernel build is in its package)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(CACHE / sub))
    # the checkout's root, not this script's folder, leads the import path
    sys.path[:] = [str(ROOT)] + [p for p in sys.path
                                 if Path(p or ".").resolve()
                                 != ROOT / "perfbench"]

    import torch

    from perfbench import harness, paths

    cell = harness.load_cell(args.workload, rehearse=args.rehearse)
    if args.rehearse:
        dev = torch.device("cpu")
    else:
        need = cell.workload["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"perfbench: {args.workload} needs {need} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)

    drv = paths.PATHS[cell.traffic["path"]](cell, args.seed, dev)
    drv.setup()
    tracer = drv.new_tracer(args.trace == 1)
    setup_s = time.perf_counter() - T_START
    drv.window(args.seconds, tracer)

    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device = harness.device_info(dev)
    result = {"correct": False, "attempted": drv.attempted,
              "failed": drv.failed, "metrics": {}, "device": device}
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]
             + cell.bench["per_layer"]}
    if args.trace == 0:
        values = dict(drv.metrics, setup_s=setup_s)
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    else:
        t = tracer.trace
        ctx = harness.Context(cell, t, drv.traced_inputs())
        for m in cell.per_layer:
            v = harness.load_reader(m["name"])(ctx)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": units[m["name"]]}
        if t is not None:
            print(f"perfbench: trace of {t.units} units: {len(t.kernels)} "
                  f"kernel events, {t.launches} launches, "
                  f"{len(t.device)} device events, host waiting "
                  f"{t.waiting_s():.6f} s of {t.window_s:.6f}",
                  file=sys.stderr)
            device["busy_s"] = t.busy_s
            device["window_s"] = t.window_s
            result["breakdown"] = {"device_ops": t.device_ops(),
                                   "idle_gaps": t.idle_gaps()}
        if tracer.refused:
            print(f"perfbench: {tracer.refused} trace(s) refused: lost "
                  f"device events", file=sys.stderr)
    result["card"] = card_line() if dev.type == "cuda" else "cpu"

    drv.release()
    paths.set_reference_precision()
    readings = drv.check()
    # a number with no limit in the cell's limits file is read, printed
    # and not compared (PERF.md gives the readings that left it out)
    for k, v in readings.items():
        if k not in cell.limits:
            print(f"reading {k} {v!r} not compared", file=sys.stderr)
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in readings.items() if k in cell.limits}
    result["correct"] = (drv.failed == 0 and drv.attempted > 0
                         and all(c["value"] <= c["limit"]
                                 for c in checks.values()))
    result["checks"] = checks
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
