"""The program's spans (``sketchformer_tpu_torch/utils/trace.py``) on the
CPU's plain routes at a tiny width: none outside a profiler, the span
catalogue's nesting and counts inside one (an embed batch, a decode
request and its chunks, a training step and its parts), outputs bit-equal
with and without the profiler, ``note_engine``'s marks (the training
loop's ``profile_steps`` trace: ``test_torch_public_names.py``), and the
benchmark's reader of the embed drain's span
(``perfbench/metrics/drain_wait_ms_per_batch.embed.py``) on a hand-built
trace and on a profiled ``embed_dataset``."""

import logging
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler

from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.data.registry import get_dataloader_by_name
from sketchformer_tpu_torch.data.tokenizer import EOS_ID
from sketchformer_tpu_torch.infer import decode as decode_mod
from sketchformer_tpu_torch.infer import fast_decode
from sketchformer_tpu_torch.infer.encode import embed_dataset
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.train.step import (
    create_train_state,
    make_train_step,
)
from sketchformer_tpu_torch.utils import engines, trace

TINY = dict(vocab_size=64, num_classes=4, max_len=24, d_model=32,
            num_layers=2, num_heads=4, dff=64, lowerdim=16, num_queries=2,
            attn_impl="pallas")
CONT = dict(use_continuous=True, num_mixtures=3, qk_norm=True)
CPU = [torch.profiler.ProfilerActivity.CPU]
B, T = 4, 24


def _model(cont: bool = False, **over):
    torch.manual_seed(0)
    kw = dict(TINY, dropout=0.0, **(CONT if cont else {}))
    return Sketchformer(SketchformerConfig(**dict(kw, **over)))


def _profiled(fn):
    """fn()'s result and the ``sk.`` events its run recorded, as (name,
    start, end) in start order."""
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    events = sorted(((e.name, e.time_range.start, e.time_range.end)
                     for e in prof.events()
                     if e.name.startswith(trace.PREFIX)),
                    key=lambda e: (e[1], -e[2]))
    return out, events


def _named(events, name):
    return [e for e in events if e[0] == "sk." + name]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _host_batches(cont: bool, n: int = 3, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = rng.integers(0, TINY["num_classes"], B).astype(np.int32)
        if cont:
            enc = rng.standard_normal((B, T, 3)).astype(np.float32)
            mask = np.ones((B, T), np.float32)
            mask[:, T - 5:] = 0.0
            out.append({"enc": enc * mask[..., None], "enc_mask": mask,
                        "label": label})
        else:
            ids = rng.integers(4, TINY["vocab_size"], (B, T)).astype(np.int32)
            ids[:, T - 5] = EOS_ID
            ids[:, T - 4:] = 0
            out.append({"enc": ids, "label": label})
    return out


def _train_setup(cont: bool):
    """(the step, its state, a host batch of the synthetic loader), at
    dropout 0.1."""
    loader = get_dataloader_by_name("synthetic")(
        num_classes=TINY["num_classes"], sketches_per_epoch=32, batch_size=B,
        buckets=(T,), token_mode=not cont)
    model = _model(cont, dropout=0.1, vocab_size=loader.vocab_size)
    state = create_train_state(model, 3, 5, 2.0)
    return make_train_step(state), state, next(loader.batch_iterator("train"))


def _token_model_without_eos():
    """A token model whose head never picks EOS: no row finishes, so the
    chunk loop runs to its horizon."""
    model = _model().eval()
    with torch.no_grad():
        model.out_head.proj.bias[EOS_ID] = -1e9
    return model


# ---------------------------------------------------------------------------
# outside a profiler
# ---------------------------------------------------------------------------

NAMES = ["embed.batch", "embed.drain", "decode.request", "train.step"]


@pytest.mark.parametrize("name", NAMES)
def test_span_is_the_shared_null_context_outside_a_profiler(name):
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span(name) is trace.span("other") is trace._OFF
    with torch.profiler.profile(activities=CPU):
        assert autograd_profiler._is_profiler_enabled
        on = trace.span(name)
        assert on is not trace._OFF
        with on:
            pass
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span(name) is trace._OFF


def _run_embed(cont):
    return embed_dataset(_model(cont).eval(), iter(_host_batches(cont)))


def _run_decode(cont):
    model = _model(cont).eval()
    enc = torch.as_tensor(_host_batches(cont, 1)[0]["enc"])
    if cont:
        return fast_decode.make_fast_cont_decoder(model)(enc)
    return fast_decode.make_fast_token_decoder(model)(enc)


def _run_train(cont):
    step, _, batch = _train_setup(cont)
    return step(batch)


RUNS = {"embed": _run_embed, "decode": _run_decode, "train": _run_train}


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
@pytest.mark.parametrize("path", sorted(RUNS))
def test_no_profiler_range_is_opened_outside_a_profiler(path, cont,
                                                        monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name!r} opened outside a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    RUNS[path](cont)


# ---------------------------------------------------------------------------
# inside a profiler: the catalogue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_embed_dataset_spans_a_batch_and_its_host_copies(cont):
    model = _model(cont).eval()
    host = _host_batches(cont)
    _, ev = _profiled(lambda: embed_dataset(model, iter(host)))
    batches, pins = _named(ev, "embed.batch"), _named(ev, "embed.pin")
    assert len(batches) == len(host)
    for b in batches:
        assert sum(_inside(p, b) for p in pins) >= 1
    assert all(any(_inside(p, b) for b in batches) for p in pins)


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_embed_dataset_spans_the_packing_of_each_batch(cont, monkeypatch):
    from sketchformer_tpu_torch.infer import fast_encode

    # packed as on a card (the CPU takes the padded batch otherwise)
    monkeypatch.setattr(fast_encode, "packed_support",
                        lambda model, device: (True, ""))
    model = _model(cont).eval()
    host = _host_batches(cont)
    _, ev = _profiled(lambda: embed_dataset(model, iter(host)))
    batches, packs = _named(ev, "embed.batch"), _named(ev, "embed.pack")
    assert len(packs) == len(batches) == len(host)
    assert all(_inside(p, b) for p, b in zip(packs, batches))
    packed = _named(ev, "engine.embed.fused-encoder-kernel-packed")
    assert len(packed) == len(host)
    assert not _named(ev, "engine.embed.fused-encoder-kernel")


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_embed_dataset_spans_the_drain_of_each_batch(cont):
    from sketchformer_tpu_torch.infer.encode import READBACK_DEPTH

    model = _model(cont).eval()
    host = _host_batches(cont, n=5)
    _, ev = _profiled(lambda: embed_dataset(model, iter(host)))
    batches, drains = _named(ev, "embed.batch"), _named(ev, "embed.drain")
    assert len(drains) == len(batches) == len(host)
    # a batch that fills the readback queue drains the one two behind it;
    # the queue's last two drain after the loop
    ahead = READBACK_DEPTH - 1
    for b, d in zip(batches[ahead:], drains):
        assert _inside(d, b)
    assert all(d[1] >= batches[-1][2] for d in drains[-ahead:])
    assert not any(_inside(d, b) for d in drains for b in batches[:ahead])


def _reader(name):
    from perfbench import harness

    return harness.load_reader(name)


def test_drain_wait_metric_reads_the_drains_alone():
    from perfbench import devtrace

    # two traced batches; the second's drain and the loop's last two
    # (after the batches) are 6 + 4 + 1 us, the device busy throughout
    t = devtrace.Trace.__new__(devtrace.Trace)
    t.host = [("sk.embed.batch", 0.0, 40.0), ("sk.embed.pin", 2.0, 5.0),
              ("sk.embed.batch", 40.0, 80.0), ("sk.embed.pin", 42.0, 45.0),
              ("sk.embed.drain", 70.0, 76.0), ("sk.embed.drain", 80.0, 84.0),
              ("sk.embed.drain", 84.0, 85.0)]
    t.busy, t.kernels, t.w0, t.w1, t.units = [(0.0, 100.0)], [], 0.0, 100.0, 2
    ctx = SimpleNamespace(trace=t)
    assert _reader("drain_wait_ms_per_batch.embed")(ctx) == pytest.approx(
        0.0055)
    assert _reader("pin_ms_per_batch.embed")(ctx) == pytest.approx(0.003)
    # a trace without the span (a program that does not record it) and
    # no trace at all read nothing
    t.host = [h for h in t.host if h[0] != "sk.embed.drain"]
    assert _reader("drain_wait_ms_per_batch.embed")(ctx) is None
    assert _reader("drain_wait_ms_per_batch.embed")(
        SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_drain_wait_metric_reads_a_profiled_embed_dataset(cont):
    from perfbench import devtrace

    model = _model(cont).eval()
    host = _host_batches(cont, n=5)
    window = devtrace.SubWindow()
    window.start()
    embed_dataset(model, iter(host))
    window.stop()
    t = devtrace.Trace(window.prof, units=len(host))
    drains = [h for h in t.host if h[0] == "sk.embed.drain"]
    assert len(drains) == len(host)
    got = _reader("drain_wait_ms_per_batch.embed")(SimpleNamespace(trace=t))
    assert got == pytest.approx(
        sum(e - s for _, s, e in drains) / 1e3 / len(host))
    assert 0 < got * len(host) <= t.window_s * 1e3


def _decoder(kind):
    """(decoder, its input, chunks to the horizon, whether a row may
    finish early) of each fast decoder."""
    if kind.startswith("tok"):
        model, K = _token_model_without_eos(), 8
        if kind == "tok":
            dec = fast_decode.make_fast_token_decoder(model,
                                                      steps_per_call=K)
            arg = torch.as_tensor(_host_batches(False, 1)[0]["enc"])
        else:
            K = fast_decode.DEFAULT_STEPS_PER_CALL
            dec = fast_decode.make_fast_token_decoder_from_z(model)
            arg = torch.randn(B, TINY["lowerdim"])
        return dec, arg, math.ceil(T / K), False
    model, K = _model(True).eval(), fast_decode.DEFAULT_STEPS_PER_CALL
    if kind == "cont":
        dec = fast_decode.make_fast_cont_decoder(model)
        arg = torch.as_tensor(_host_batches(True, 1)[0]["enc"])
    else:
        dec = fast_decode.make_fast_cont_decoder_from_z(model)
        arg = torch.randn(B, TINY["lowerdim"])
    return dec, arg, math.ceil(T / K), True


@pytest.mark.parametrize("kind", ["tok", "tok_from_z", "cont",
                                  "cont_from_z"])
def test_fast_decoder_spans_a_request_and_its_chunks(kind):
    dec, arg, horizon, may_exit = _decoder(kind)
    _, ev = _profiled(lambda: dec(arg))
    (req,) = _named(ev, "decode.request")
    (pro,) = _named(ev, "decode.prologue")
    chunks = _named(ev, "decode.chunk")
    reads = _named(ev, "decode.exit_read")
    exits = _named(ev, "decode.early_exit")
    assert all(_inside(e, req) for e in [pro] + chunks + reads + exits)
    assert len(chunks) == len(reads) >= 1
    assert pro[2] <= chunks[0][1]
    # each chunk, then its read, in turn
    order = [e[0] for e in sorted(chunks + reads, key=lambda e: e[1])]
    assert order == ["sk.decode.chunk", "sk.decode.exit_read"] * len(chunks)
    if not may_exit:
        assert len(chunks) == horizon and not exits
    else:
        assert len(exits) == (len(chunks) < horizon)


@pytest.mark.parametrize("early_exit", [True, False])
def test_composed_decoder_reads_its_flags_in_a_span(early_exit):
    model = _model().eval()
    dec = decode_mod.make_token_decoder(model, fast=False,
                                        early_exit=early_exit)
    enc = torch.as_tensor(_host_batches(False, 1)[0]["enc"])
    ids, ev = _profiled(lambda: dec(enc))
    reads = _named(ev, "decode.exit_read")
    exits = _named(ev, "decode.early_exit")
    if not early_exit:
        assert not reads and not exits
        return
    finished = np.cumsum(ids.numpy() == EOS_ID, axis=1).astype(bool)
    steps = (int(np.argmax(finished.all(axis=0))) + 1
             if finished[:, -1].all() else T)
    assert len(reads) == steps
    assert len(exits) == (steps < T)


PARTS = ["h2d", "forward", "backward", "guard", "update"]


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_train_step_spans_its_parts_in_order(cont):
    step, _, batch = _train_setup(cont)
    _, ev = _profiled(lambda: step(batch))
    (root,) = _named(ev, "train.step")
    parts = [e for e in ev if e[0] != "sk.train.step"]
    assert all(_inside(e, root) for e in parts)
    firsts = [min(e[1] for e in _named(ev, "train." + p)) for p in PARTS]
    assert firsts == sorted(firsts)
    # one span each: the guard is the norm's launch, no host read follows
    assert [e[0] for e in parts] == ["sk.train." + p for p in PARTS]


# ---------------------------------------------------------------------------
# the same outputs with and without a profiler
# ---------------------------------------------------------------------------


def _embed_out(cont):
    return [_run_embed(cont)[0]]


def _decode_out(cont):
    out = _run_decode(cont)
    return list(out) if cont else [out]


def _train_out(cont):
    step, state, batch = _train_setup(cont)
    m = step(batch)
    return [m["loss"], m["grad_norm"]] + [p.detach().clone()
                                          for p in state.model.parameters()]


OUTS = {"embed": _embed_out, "decode": _decode_out, "train": _train_out}


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
@pytest.mark.parametrize("path", sorted(OUTS))
def test_outputs_are_bit_equal_under_the_profiler(path, cont):
    plain = OUTS[path](cont)
    traced, ev = _profiled(lambda: OUTS[path](cont))
    assert ev
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


# ---------------------------------------------------------------------------
# note_engine's marks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine,reason,level", [
    ("fused-chunk-kernel", "", logging.INFO),
    ("composed", "post-LN config", logging.WARNING),
])
def test_note_engine_marks_every_call_and_logs_once(engine, reason, level,
                                                    caplog):
    engines.reset_seen()
    with caplog.at_level(logging.INFO, logger=engines.log.name):
        _, ev = _profiled(lambda: [engines.note_engine("decode", engine,
                                                       reason)
                                   for _ in range(3)])
        engines.note_engine("decode", engine, reason)
    assert [e[0] for e in ev] == [f"sk.engine.decode.{engine}"] * 3
    logged = [r for r in caplog.records
              if r.name == engines.log.name]
    assert len(logged) == 1 and logged[0].levelno == level
    engines.reset_seen()
