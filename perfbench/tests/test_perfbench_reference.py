"""The plain reference against the program's composed float32 route at a
small size on the CPU: the embedding, the teacher-forced logits, a
training step's loss and gradients at dropout 0, the optimizer's update,
and the dropout draw's bytes and seeds. The tests import both sides; the
reference itself imports nothing of the program."""

import numpy as np
import pytest
import torch

from perfbench import harness, paths
from perfbench.reference import model as R
from perfbench.reference import philox

SMALL = dict(vocab_size=64, num_classes=7, max_len=24, d_model=32,
             num_layers=2, num_heads=4, dff=64, dropout=0.0, lowerdim=16,
             bottleneck_mode="attn", num_queries=4, num_mixtures=3,
             attn_impl="xla", norm_first=True, dtype="float32")


def small_cfg(cont: bool, qk: bool) -> dict:
    return dict(SMALL, use_continuous=cont, qk_norm=qk)


def params(cfg, seed=0):
    """The benchmark's weights, with small random biases and LayerNorm
    parameters so that every term shows."""
    P = harness.make_params(cfg, seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed + 1)
    for n, t in P.items():
        if n.endswith((".bias", ".scale")):
            t += 0.1 * torch.randn(t.shape, generator=g)
    return P


def program(cfg, P):
    return harness.program_model(cfg, P, torch.device("cpu"))


def batch(cfg, seed=0, B=3, T=24):
    traffic = dict(pool=1, batch=B, seq_len=T, len_min=4, len_max=T - 2)
    b = paths.sketches(cfg, traffic, np.random.default_rng(seed))[0]
    return {k: torch.as_tensor(v) for k, v in b.items()
            if k in ("enc", "n", "label")}


@pytest.mark.parametrize("cont,qk", [(False, False), (True, True)])
def test_embedding_matches_program(cont, qk):
    cfg = small_cfg(cont, qk)
    P = params(cfg)
    m = program(cfg, P).eval()
    b = R.full_batch(batch(cfg), cont)
    with torch.no_grad():
        z, _ = R.Reference(cfg, P).encode(b["enc"], b["enc_key"])
        zp = m.embed(b["enc"], b["enc_key"].float() if cont else None)
    torch.testing.assert_close(z, zp, rtol=1e-5, atol=1e-5)


def test_teacher_forced_logits_match_program():
    cfg = small_cfg(False, False)
    P = params(cfg)
    m = program(cfg, P).eval()
    b = R.full_batch(batch(cfg), False)
    with torch.no_grad():
        ref = R.Reference(cfg, P)
        _, memory = ref.encode(b["enc"], b["enc_key"])
        logits = ref.head(ref.decode(b["dec_in"], memory, b["dec_key"]))
        want = m(b["enc"], b["dec_in"])["recon"]
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cont,qk", [(False, False), (True, True)])
def test_train_loss_and_gradients_match_program(cont, qk):
    from sketchformer_tpu_torch.data.packed import unpack_batch
    from sketchformer_tpu_torch.train.step import _forward_loss

    cfg = small_cfg(cont, qk)
    P = params(cfg)
    m = program(cfg, P).train()
    packed = batch(cfg)
    total, _ = _forward_loss(m, unpack_batch(dict(packed)), 1.0, 1.0)
    total.backward()
    want = {n: p.grad for n, p in m.named_parameters()}
    Pr = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    full = R.full_batch(packed, cont)
    loss = R.train_loss(R.Reference(cfg, Pr), full, R.denominators(full, cont))
    loss.backward()
    torch.testing.assert_close(loss, total, rtol=1e-5, atol=1e-6)
    for n, p in Pr.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        torch.testing.assert_close(g, want[n], rtol=1e-4, atol=1e-6,
                                   msg=lambda s, n=n: f"{n}: {s}")


def test_adam_matches_program_optimizer():
    from sketchformer_tpu_torch.train.schedule import global_norm, NoamAdam

    g = torch.Generator().manual_seed(3)
    P = {f"p{i}": torch.randn(5, 7, generator=g) for i in range(3)}
    mine = {k: v.clone() for k, v in P.items()}
    theirs = [v.clone() for v in P.values()]
    ref = R.Adam(mine, 32, warmup=10, peak=2.0)
    opt = NoamAdam(theirs, 32, warmup_steps=10, peak_scale=2.0)
    for step in range(3):
        grads = {k: torch.randn(5, 7, generator=g) * (step + 1) for k in P}
        gl = list(grads.values())
        ref.update(mine, grads)
        opt.step(gl, global_norm(gl))
    for a, b in zip(mine.values(), theirs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_philox_bytes_match_program_draw():
    from sketchformer_tpu_torch.ops import dropout_prng as dp

    seed, B, T, d = 0x1234_5678_9ABC, 3, 5, 8
    rows = torch.arange(B)
    for layer in (0, 2):
        for k in range(3):
            want = dp.site_bytes_reference(dp.PrngSite(seed, layer, k, T),
                                           B * T, d, "cpu")
            got = philox.site_bytes(seed, layer, k, rows, T, d)
            assert torch.equal(got.reshape(B * T, d), want)
    emit = dp.emit_dropout_bits_reference(seed, 1, 1, B, T, d)
    assert torch.equal(philox.site_bytes(seed, 0, 0, rows, T, d),
                       emit.reshape(B, T, d))


def test_call_seeds_match_program_keys():
    from sketchformer_tpu_torch.models import dropout as md

    key = (2**31 + 77, 2, 0)
    with md.use_generator(None, seed_key=key):
        want = [md.next_seed() for _ in range(6)]
    assert [philox.call_seed(key, i) for i in range(6)] == want


def test_dropout_keeps_and_scales_as_program():
    from sketchformer_tpu_torch.models.dropout import dropout

    x = torch.randn(2, 3, 8)
    bits = torch.randint(0, 256, x.shape, dtype=torch.uint8)
    torch.testing.assert_close(philox.apply(x, bits, 0.1),
                               dropout(x, 0.1, bits=bits))
