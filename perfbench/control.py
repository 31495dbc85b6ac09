"""The readings the output checks' limits are set from, at a cell's own
size: for each seed, the program's numbers (the lower readings), the
control's (the plain reference put in the program's place with every
product's operands in a precision below the configurations' bfloat16, as
the cell's limits file names it under ``"control"``: ``float8`` e4m3, or
``int8`` where float8 separates no number from the program's own
readings, with float8's readings beside it) and, for a training cell,
those of its faults (a step that leaves out half of its batch, taking the
mean over the rest; a step that returns its state unchanged), with the
reference in bfloat16 beside them (what the configurations' rounding
alone moves: a witness for the program's readings). A training cell runs
its window (``--seconds``, the benchmark's ``run_seconds`` by default)
before the step after it that the check holds to the reference.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

One JSON line a seed on stdout. The benchmark's own runs do not run it;
it needs the card, as the cells do (``--rehearse``: tiny widths on the
CPU, as ``run.py --rehearse``).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell, seed: int, dev, seconds: float) -> dict:
    """{"program": ..., "control": ..., "faults": ...} of one seed."""
    import torch

    from perfbench import paths
    from perfbench.reference import model as R

    kind = cell.traffic["path"]
    drv = paths.PATHS[kind](cell, seed, dev)
    k = cell.traffic.get("check_units", 0)
    out = {"seed": seed}
    q = R.CONTROLS[cell.limits["control"]]
    if kind == "embed":
        drv.setup()
        Z, _ = drv.embed_dataset(drv.prog_model, iter(drv.host[:k]))
        drv.release()
        paths.set_reference_precision()
        P = drv.reference_params()
        ref, ctl = R.Reference(cell.cfg, P), R.Reference(cell.cfg, P, q)
        B = cell.traffic["batch"]
        prog = ctrl = 0.0
        with torch.no_grad():
            for i in range(k):
                z_ref = paths.embed_reference(ref, drv.pool[i], dev)
                z = torch.as_tensor(Z[i * B:(i + 1) * B]).to(dev)
                prog = max(prog, paths.row_gap(z, z_ref))
                ctrl = max(ctrl, paths.row_gap(
                    paths.embed_reference(ctl, drv.pool[i], dev), z_ref))
        out.update(program={"z_err": prog}, control={"z_err": ctrl})
    elif kind == "decode":
        drv.setup()
        served = [drv.request(i) for i in range(k)]
        drv.release()
        paths.set_reference_precision()
        P = drv.reference_params()
        ref, ctl = R.Reference(cell.cfg, P), R.Reference(cell.cfg, P, q)
        prog = ctrl = 0.0
        with torch.no_grad():
            for i in range(k):
                prompt = torch.as_tensor(drv.pool[i]["enc"]).to(dev)
                s = served[i].to(dev).long()
                prog = max(prog, paths.decode_gap(ref, prompt, s))
                ctrl = max(ctrl, paths.decode_gap(ref, prompt, s, ctl))
        out.update(program={"logit_gap": prog}, control={"logit_gap": ctrl})
    else:
        drv.setup()
        drv.window(seconds, paths.Tracer(False, 0, 0))
        got = drv.program_steps()
        drv.release()
        paths.set_reference_precision()
        want = paths.reference_pair(drv)
        frozen = {k: dict(v, after=v["start"]) for k, v in want.items()}
        out.update(
            program=paths.train_numbers(got, want, True),
            control=paths.train_numbers(paths.reference_pair(drv, q),
                                        want, True),
            bf16=paths.train_numbers(paths.reference_pair(drv, R.bf16),
                                     want, True),
            faults={"half_batch": paths.train_numbers(
                        paths.reference_pair(drv, half=True), want, True),
                    "unchanged": paths.train_numbers(frozen, want)})
        if q is not R.fp8:
            out["float8"] = paths.train_numbers(
                paths.reference_pair(drv, R.fp8), want, True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    sys.path[:] = [str(ROOT)] + [q for q in sys.path
                                 if Path(q or ".").resolve()
                                 != ROOT / "perfbench"]
    import torch

    from perfbench import harness

    cell = harness.load_cell(args.workload, rehearse=args.rehearse)
    if args.rehearse:
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("perfbench/control.py needs a CUDA device", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
    seconds = args.seconds
    if seconds is None:
        seconds = cell.bench["run_seconds"]
    for s in args.seeds.split(","):
        print(json.dumps(readings(cell, int(s), dev, seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
