"""The metrics that read the program's own spans (``perfbench/spans.py``
and its six readers): the interval arithmetic on hand-built traces, a
traced CPU rehearsal of each cell holding one root span per traced unit,
and, on the card, each cell's traced spans on the device trace's clock."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from perfbench import devtrace, harness, paths, spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
READERS = ["pin_ms_per_batch.embed", "pin_idle_ms_per_batch.embed",
           "chunk_turnaround_ms.decode",
           "prologue_idle_ms_per_request.decode",
           "guard_idle_ms_per_step.train", "launch_idle_ms_per_step.train"]
ROOTS = {"embed": "sk.embed.batch", "decode": "sk.decode.request",
         "train": "sk.train.step"}
CHUNK_KERNELS = ("decode_cluster_kernel", "decode_chunk_kernel")


def _trace(host=(), busy=(), kernels=(), w0=0.0, w1=100.0, units=1):
    """A trace of the given events, as ``devtrace.Trace`` holds them
    (``busy`` sorted, disjoint and inside the window)."""
    t = devtrace.Trace.__new__(devtrace.Trace)
    t.host, t.busy, t.kernels = list(host), list(busy), list(kernels)
    t.w0, t.w1, t.units = w0, w1, units
    return t


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------


def test_idle_inside_spans():
    # idle: [0, 10), [30, 50), [60, 100); the span covers [0, 40)
    t = _trace(host=[("sk.a", 0.0, 40.0), ("sk.b", 0.0, 100.0)],
               busy=[(10.0, 30.0), (50.0, 60.0)], units=2)
    assert spans.idle(t) == [(0.0, 10.0), (30.0, 50.0), (60.0, 100.0)]
    assert spans.idle_ms_per_unit(t, ("sk.a",)) == pytest.approx(0.01)
    assert spans.ms_per_unit(t, ("sk.a",)) == pytest.approx(0.02)


def test_overlapping_spans_count_once():
    t = _trace(host=[("sk.a", 0.0, 20.0), ("sk.a", 10.0, 30.0),
                     ("sk.b", 25.0, 35.0), ("sk.b", 26.0, 27.0)])
    assert spans.named(t, ("sk.a", "sk.b")) == [(0.0, 35.0)]
    assert spans.ms_per_unit(t, ("sk.a", "sk.b")) == pytest.approx(0.035)
    assert spans.idle_ms_per_unit(t, ("sk.a", "sk.b")) == pytest.approx(
        0.035)


def test_spans_are_clipped_to_the_window():
    t = _trace(host=[("sk.a", -10.0, 5.0), ("sk.a", 95.0, 120.0)],
               busy=[(0.0, 2.0), (99.0, 100.0)], w0=0.0, w1=100.0)
    assert spans.named(t, ("sk.a",)) == [(0.0, 5.0), (95.0, 100.0)]
    assert spans.idle(t) == [(2.0, 99.0)]
    assert spans.idle_ms_per_unit(t, ("sk.a",)) == pytest.approx(0.007)


def test_turnaround_stops_at_a_request_boundary():
    k = "void decode_cluster_kernel<8>(Params)"
    t = _trace(host=[("sk.decode.request", 0.0, 40.0),
                     ("sk.decode.request", 50.0, 100.0)],
               kernels=[(k, 1.0, 10.0), (k, 12.0, 20.0), (k, 23.0, 30.0),
                        ("void other_kernel", 31.0, 32.0),
                        (k, 55.0, 60.0), (k, 61.0, 70.0)])
    # gaps 2, 3 in the first request, 1 in the second; not 25 across them
    assert spans.turnaround_ms(t, "sk.decode.request",
                               CHUNK_KERNELS) == pytest.approx(0.002)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_spans(name):
    reader = harness.load_reader(name)
    bare = _trace(host=[("aten::copy_", 0.0, 50.0)],
                  kernels=[("void decode_cluster_kernel", 1.0, 2.0),
                           ("void decode_cluster_kernel", 3.0, 4.0)])
    assert reader(SimpleNamespace(trace=None)) is None
    assert reader(SimpleNamespace(trace=bare)) is None


# ---------------------------------------------------------------------------
# traced runs of the cells
# ---------------------------------------------------------------------------


def traced_run(name: str, device, rehearse: bool, seed: int,
               seconds: float):
    """A cell's driver run for ``seconds`` and to the end of its traced
    sub-window; its cell, driver and trace."""
    cell = harness.load_cell(name, rehearse=rehearse)
    drv = paths.PATHS[cell.traffic["path"]](cell, seed, device)
    drv.setup()
    tracer = drv.new_tracer(True)
    drv.window(seconds, tracer)
    assert tracer.trace is not None
    return cell, drv, tracer.trace


def read_new(cell, drv, trace) -> dict:
    ctx = harness.Context(cell, trace, drv.traced_inputs())
    names = [m["name"] for m in cell.per_layer if m["name"] in READERS]
    return {n: harness.load_reader(n)(ctx) for n in names}


@pytest.mark.parametrize("name", CELLS)
def test_traced_rehearsal_holds_one_root_span_a_unit(name):
    cell, drv, trace = traced_run(name, torch.device("cpu"), True,
                                  2**31 + 9, 1.0)
    root = ROOTS[cell.traffic["path"]]
    assert sum(n == root for n, _, _ in trace.host) == trace.units
    got = read_new(cell, drv, trace)
    assert got
    # the CPU has no chunk kernel to time; every other reader reads
    assert all(v is not None and v >= 0 for k, v in got.items()
               if not k.startswith("chunk_turnaround"))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the cells' full-size traced runs)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_card_spans_share_the_device_clock(name, card):
    """Every new metric of the cell reads; the idle its readers attribute
    fits in the window's idle time; every chunk kernel lies inside the
    request span that launched it."""
    torch.cuda.set_device(card)
    # long enough for a second sub-window where the first lost events
    cell, drv, trace = traced_run(name, card, False, 2**31 + 77, 8.0)
    got = read_new(cell, drv, trace)
    drv.release()
    idle_ms = (trace.window_s - trace.busy_s) * 1e3
    attributed = sum(v for k, v in got.items() if "_idle_ms_per_" in k)
    attributed *= trace.units
    chunks = [(s, t) for n, s, t in trace.kernels
              if any(p in n for p in CHUNK_KERNELS)]
    requests = [(s, t) for n, s, t in trace.host if n == "sk.decode.request"]
    outside = [k for k in chunks
               if not any(r[0] <= k[0] and k[1] <= r[1] for r in requests)]
    print(json.dumps({"cell": name, "metrics": got, "units": trace.units,
                      "window_ms": trace.window_s * 1e3, "idle_ms": idle_ms,
                      "attributed_idle_ms": attributed,
                      "chunk_kernels": len(chunks),
                      "chunk_kernels_outside_requests": len(outside)}))
    assert all(v is not None for v in got.values())
    assert attributed <= idle_ms + 1e-6
    assert not outside
    if cell.traffic["path"] == "decode":
        assert chunks
