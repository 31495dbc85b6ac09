"""The operation counts of ``work.py`` against ``FlopCounterMode`` on the
plain reference at small sizes, and its byte counts against hand counts
and against the calls the program's training step makes."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import harness, work
from perfbench.reference import model as R

CFG = dict(vocab_size=50, num_classes=7, max_len=16, d_model=32,
           num_layers=2, num_heads=4, dff=64, dropout=0.0, lowerdim=16,
           bottleneck_mode="attn", num_queries=4, num_mixtures=3,
           attn_impl="pallas", norm_first=True, qk_norm=False,
           dtype="bfloat16")
B, T = 3, 16


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def setup(cont):
    cfg = dict(CFG, use_continuous=cont)
    P = harness.make_params(cfg, 0, torch.device("cpu"))
    if cont:
        enc = torch.randn(B, T, 3)
        dec_in = torch.randn(B, T, 5)
    else:
        enc = torch.randint(4, 50, (B, T))
        dec_in = torch.randint(4, 50, (B, T))
    return cfg, R.Reference(cfg, P), enc, dec_in


@pytest.mark.parametrize("cont", [False, True])
def test_encoder_flops(cont):
    cfg, ref, enc, _ = setup(cont)
    keys = torch.ones(B, T, dtype=torch.bool)
    got = counted(lambda: ref.encode(enc, keys))
    # encode also expands z into the memory, which work counts with the
    # decoder
    expand = 2 * B * cfg["lowerdim"] * cfg["num_queries"] * cfg["d_model"]
    assert got == work.encoder_flops(cfg, T, [T] * B) + expand


@pytest.mark.parametrize("cont", [False, True])
def test_decoder_flops(cont):
    cfg, ref, enc, dec_in = setup(cont)
    keys = torch.ones(B, T, dtype=torch.bool)
    _, memory = ref.encode(enc, keys)
    got = counted(lambda: ref.head(ref.decode(dec_in, memory, keys)))
    # the reference computes every (query, key) pair and masks the causal
    # half; work counts only the pairs attended
    d, L = cfg["d_model"], cfg["num_layers"]
    masked = 4 * d * L * (B * T * T - work.attention_pairs(T, [T] * B, True))
    expand = 2 * B * cfg["lowerdim"] * cfg["num_queries"] * d
    assert got == work.decoder_flops(cfg, T, [T] * B) - expand + masked


def test_classifier_flops():
    cfg, ref, _, _ = setup(False)
    z = torch.randn(B, cfg["lowerdim"])
    assert counted(lambda: ref.classify(z)) == work.classifier_flops(cfg, B)


def test_decode_steps_sum_to_the_teacher_forced_decoder():
    cfg = dict(CFG, use_continuous=False)
    steps = sum(work.decode_step_flops(cfg, B, t) for t in range(T))
    d, L, nq, low = cfg["d_model"], cfg["num_layers"], \
        cfg["num_queries"], cfg["lowerdim"]
    cross_kv = L * 2 * B * nq * d * 2 * d
    expand = 2 * B * low * nq * d
    assert steps == work.decoder_flops(cfg, T, [T] * B) - cross_kv - expand


def test_attention_pairs_by_hand():
    assert work.attention_pairs(4, [2, 4], causal=False) == 4 * 2 + 4 * 4
    # row of 2 valid keys: queries see 1, 2, 2, 2; row of 4: 1, 2, 3, 4
    assert work.attention_pairs(4, [2, 4], causal=True) == 7 + 10


def test_byte_counts_by_hand():
    # a (4, 8) x (8, 16) with a residual: a, w, out, residual in bf16,
    # the bias in f32
    assert work.linear_call(4, 8, 16, True) == (
        2 * 4 * 8 * 16, (32 + 128 + 64 + 64) * 2 + 16 * 4)
    assert work.linear_tn_call(4, 8, 16, 4) == (
        2 * 4 * 8 * 16, 32 * 2 + 64 * 4 + (128 + 16) * 4)
    cfg = dict(CFG, use_continuous=False)
    flops, nbytes = work.encoder_attention_call(cfg, 4, [2, 4])
    assert flops == 4 * 32 * (8 + 16)
    assert nbytes == 2 * 4 * 4 * 32 * 2 + 2 * 4 * 4
    # one step of a chunk at t0 = 0: weights (bf16 products; f32 biases
    # of the self QKV, self out, cross q, cross out, FFN in and out, and
    # three LayerNorms), head, token and position rows, cross K/V, one
    # cache row read, one written, the ids
    d, dff, L, V, nq = 32, 64, 2, 50, 4
    _, got = work.decode_chunk_call(cfg, 1, 0, 1)
    biases = 3 * d + d + d + d + dff + d + 3 * 2 * d
    weights = L * ((6 * d * d + 2 * d * dff) * 2 + biases * 4)
    want = (weights + d * V * 2 + V * 4 + 2 * d * 2 + L * nq * 2 * d * 2
            + L * 2 * d * 2 + L * 2 * d * 2 + 4)
    assert got == want


def test_linear_tn_calls_are_the_programs():
    """The calls ``work.linear_tn_calls`` counts are those a training step
    of the program's fused stacks makes: shapes and the dtype of dy."""
    from sketchformer_tpu_torch.ops import decoder_stack_train as dst
    from sketchformer_tpu_torch.ops import encoder_stack as es
    from sketchformer_tpu_torch.ops import encoder_stack_train as est
    from sketchformer_tpu_torch.train.step import (
        create_train_state,
        make_train_step,
    )

    calls = []

    def rec(x, y, **kw):
        calls.append((x.shape[0], x.shape[1], y.shape[1],
                      y.element_size()))
        return es.linear_tn(x, y, **kw)

    saved = []
    for f in (est.fused_encoder_stack_train, dst.fused_decoder_stack_train):
        saved.append((f, dict(f.__kwdefaults__)))
        kd = dict(f.__kwdefaults__)
        kd["ops"] = kd["ops"]._replace(linear_tn=rec)
        f.__kwdefaults__ = kd
    try:
        cfg = dict(CFG, use_continuous=False, dropout=0.1)
        model = harness.program_model(
            cfg, harness.make_params(cfg, 0, torch.device("cpu")),
            torch.device("cpu"))
        step = make_train_step(create_train_state(model, 0, 10, 1.0))
        enc = np.random.default_rng(0).integers(4, 50, (B, T)).astype(
            np.int32)
        step({"enc": enc, "label": np.zeros(B, np.int32)})
    finally:
        for f, kd in saved:
            f.__kwdefaults__ = kd
    assert sorted(calls) == sorted(work.linear_tn_calls(cfg, B, T))
