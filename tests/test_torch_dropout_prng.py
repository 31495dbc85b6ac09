"""The port's in-kernel dropout draw (K7, ``ops/dropout_prng.py``) on the
CPU: the plain Philox against the Random123 known answers, the stream
layout (a byte depends only on seed, layer, batch row, t and c), the kept
share, the 'prng' stacks against the 'bits' stacks fed the emitted bytes
(value and every gradient, bit for bit), and the JAX package's bits-mode
stack fed the same bytes (the tolerances of tests/test_torch_train_stacks.py:
value rtol 1e-4, gradients rtol 1e-3 / atol 1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.models.transformer import Encoder as JaxEncoder
from sketchformer_tpu.ops.pallas_encoder import stack_encoder_weights as jsw
from sketchformer_tpu.ops.pallas_encoder_train import (
    apply_final_ln as jax_final_ln,
    fused_encoder_stack_train as jax_stack_train,
)
from sketchformer_tpu_torch.convert import params_from_flax
from sketchformer_tpu_torch.models.dropout import (
    dropout,
    next_seed,
    use_generator,
)
from sketchformer_tpu_torch.models.transformer import Decoder, Encoder
from sketchformer_tpu_torch.ops import decoder_stack_train as dst
from sketchformer_tpu_torch.ops import dropout_prng as dp
from sketchformer_tpu_torch.ops import encoder_stack_train as est


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_plain_philox_known_answers(ctr, key, want):
    """Philox-4x32-10 of Random123's known-answer vectors."""
    c = [torch.tensor([v], dtype=torch.int64) for v in ctr]
    got = dp.philox4x32_10(*c, key[0] | (key[1] << 32))
    assert tuple(int(w[0]) for w in got) == want


def test_emit_is_deterministic_and_keyed_by_the_seed():
    a = dp.emit_dropout_bits(7, 2, 3, 3, 5, 12)
    assert a.shape == (6, 3, 5, 12) and a.dtype == torch.uint8
    assert torch.equal(a, dp.emit_dropout_bits(7, 2, 3, 3, 5, 12))
    assert not torch.equal(a, dp.emit_dropout_bits(8, 2, 3, 3, 5, 12))
    # sites of a layer are distinct bytes of one word
    assert not torch.equal(a[0], a[1])


def test_a_byte_depends_only_on_seed_layer_row_t_and_c():
    """Emitting fewer rows, fewer positions or fewer layers gives the same
    bytes where they overlap; a site drawn alone equals its emitted plane
    at any row count."""
    seed, d = 2 ** 40 + 3, 20
    big = dp.emit_dropout_bits(seed, 3, 2, 6, 9, d)
    small = dp.emit_dropout_bits(seed, 2, 2, 4, 5, d)
    assert torch.equal(big[:4, :4, :5], small)
    for layer, k, B in ((2, 1, 6), (1, 0, 3)):
        site = dp.site_bytes_reference(dp.PrngSite(seed, layer, k, 9),
                                       B * 9, d, "cpu")
        assert torch.equal(site, big[2 * layer + k, :B].reshape(B * 9, d))


@pytest.mark.parametrize("rate", [0.1, 0.25])
def test_kept_share(rate):
    thresh = round(rate * 256)
    byt = dp.emit_dropout_bits(11, 2, 3, 16, 64, 64)
    kept = (byt >= thresh).double().mean().item()
    np.testing.assert_allclose(kept, 1 - thresh / 256, atol=2e-3)


def _stack(decoder, seed=0, L=2, H=2, d=32, dff=48, qk=True):
    gen = torch.Generator().manual_seed(seed)
    mod = (Decoder if decoder else Encoder)(L, H, d, dff, torch.float32,
                                           "pallas", True, qk, 0.1)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            base = 1.0 if name.endswith("scale") else 0.0
            p.copy_(base + 0.1 * torch.randn(p.shape, generator=gen))
    return mod


@pytest.mark.parametrize("decoder", [False, True], ids=["encoder",
                                                         "decoder"])
def test_prng_stack_equals_bits_stack_fed_the_emitted_bytes(decoder):
    mod = _stack(decoder)
    B, T, d, L, seed = 3, 10, 32, 2, 99
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(B, T, d, generator=gen)
    mem = torch.randn(B, 4, d, generator=gen)
    gy = torch.randn(B, T, d, generator=gen)
    km = torch.arange(T)[None] < torch.tensor([T, 7, 4])[:, None]
    byt = dp.emit_dropout_bits(seed, L, 3 if decoder else 2, B, T, d)

    def run(**drop):
        w = mod.stacked_weights(grad=True)
        xi = x.clone().requires_grad_(True)
        mi = mem.clone().requires_grad_(True)
        if decoder:
            y = dst.fused_decoder_stack_train(xi, mi, km, None, w,
                                              num_heads=2, qk_norm=True,
                                              dropout_rate=0.1, **drop)
            inputs = [xi, mi]
        else:
            y = est.fused_encoder_stack_train(xi, km, w, num_heads=2,
                                              qk_norm=True, dropout_rate=0.1,
                                              **drop)
            inputs = [xi]
        grads = torch.autograd.grad((y * gy).sum(),
                                    inputs + list(mod.parameters()),
                                    allow_unused=True)
        return [y] + [g for g in grads if g is not None]

    est.DRAWS["draw_dropout_bytes"] = 0
    got = run(dropout_impl="prng", seed=seed)
    assert est.DRAWS["draw_dropout_bytes"] == 0
    want = run(dropout_bytes=byt)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # and the draw matters: another seed gives another output
    assert not torch.equal(got[0], run(dropout_impl="prng", seed=seed + 1)[0])
    # 'auto' is 'bits' on the CPU: bytes drawn from the generator
    run(generator=torch.Generator().manual_seed(0))
    assert est.DRAWS["draw_dropout_bytes"] == 1


def test_jax_bits_stack_fed_the_emitted_bytes_matches_the_prng_stack(
        monkeypatch):
    """The JAX package's bits-mode encoder stack, its dropout draw replaced
    by the port's emitted bytes, against the port's 'prng' stack."""
    B, T, L, d, H, seed = 3, 12, 2, 64, 2, 12345
    enc = JaxEncoder(num_layers=L, num_heads=H, d_model=d, dff=64,
                     dropout=0.0, dtype=jnp.float32, attn_impl="xla",
                     qk_norm=True)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    gy = rng.standard_normal((B, T, d)).astype(np.float32)
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)
    byt = dp.emit_dropout_bits(seed, L, 2, B, T, d)
    real_bits = jax.random.bits

    def emitted(key, shape, dtype=None):
        if tuple(shape) == tuple(byt.shape):
            return jnp.asarray(byt.numpy())
        return real_bits(key, shape, dtype)

    monkeypatch.setattr(jax.random, "bits", emitted)

    def jax_loss(p, xx):
        w = jsw(p, num_layers=L, compute_dtype=jnp.float32)
        y = jax_stack_train(xx, None, w, num_heads=H, qk_norm=True,
                            dropout_rate=0.1, dropout_impl="bits",
                            dropout_rng=jax.random.PRNGKey(0))
        return (jax_final_ln(y, w) * gy).sum()

    want, (gp, gx) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    port = Encoder(L, H, d, 64, torch.float32, "pallas", True, True, 0.1)
    sd = params_from_flax({"encoder": params})
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    w = port.stacked_weights(grad=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = est.fused_encoder_stack_train(xt, None, w, num_heads=H, qk_norm=True,
                                      dropout_rate=0.1, dropout_impl="prng",
                                      seed=seed)
    got = (est.apply_final_ln(y, w) * torch.from_numpy(gy)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4)
    ref = {k[len("encoder."):]: v.numpy()
           for k, v in params_from_flax({"encoder": gp}).items()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_seeds_come_from_the_seed_key_and_the_call_index():
    """Inside a keyed context each call's seed is a function of (key, call
    index) only; composed sites on the CPU still draw from the generator."""
    with use_generator(None, seed_key=(0, 5, 1)):
        a = [next_seed() for _ in range(3)]
    with use_generator(None, seed_key=(0, 5, 1)):
        b = [next_seed() for _ in range(3)]
    with use_generator(None, seed_key=(0, 6, 1)):
        c = next_seed()
    assert a == b and len(set(a)) == 3 and c != a[0]
    x = torch.ones(4, 8, 16)
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    with use_generator(g1, seed_key=(1, 2, 0)):
        y1 = dropout(x, 0.1)
    assert torch.equal(y1, dropout(x, 0.1, generator=g2))
