"""The port's differentiable encoder stack (K3) against the JAX package's
``fused_encoder_stack_train`` in Pallas interpret mode, f32 on the CPU:
the value and the gradients of the input and of every weight, through the
plain versions of the port's kernels. Dropout bytes are drawn as the JAX
wrapper draws them and handed to the port. Tolerances are the JAX tests'
(tests/test_pallas_encoder_train.py): value rtol 1e-4, gradients rtol 1e-3
/ atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.models.transformer import Encoder as JaxEncoder
from sketchformer_tpu.ops.pallas_encoder import stack_encoder_weights as jsw
from sketchformer_tpu.ops.pallas_encoder_train import (
    _layer_bwd,
    _row,
    apply_final_ln as jax_final_ln,
    fused_encoder_stack_train as jax_stack_train,
)
from sketchformer_tpu_torch.convert import params_from_flax
from sketchformer_tpu_torch.models.transformer import Encoder
from sketchformer_tpu_torch.ops import encoder_stack_train as est
from sketchformer_tpu_torch.ops.encoder_stack import stack_encoder_weights

B, T, L, DFF = 4, 16, 2, 64


def _setup(d, H, qk, masked, seed=0):
    enc = JaxEncoder(num_layers=L, num_heads=H, d_model=d, dff=DFF,
                     dropout=0.0, dtype=jnp.float32, attn_impl="xla",
                     qk_norm=qk)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    km = None
    if masked:
        km = np.ones((B, T), bool)
        km[:, -5:] = False
        km[1, 3:] = False
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      key_mask=None if km is None else jnp.asarray(km))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params["params"])
    port = Encoder(L, H, d, DFF, torch.float32, "pallas", True, qk)
    sd = params_from_flax({"encoder": params})
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    gy = rng.standard_normal((B, T, d)).astype(np.float32)
    return params, port, x, km, gy


def _flat(tree):
    """A JAX gradient tree under the port's keys (``params_from_flax``)."""
    sd = params_from_flax({"encoder": tree})
    return {k[len("encoder."):]: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("d,H,qk,masked,rate", [
    pytest.param(64, 2, False, True, 0.0, id="dh32-masked"),
    pytest.param(64, 8, True, False, 0.0, id="h8-qknorm-unmasked"),
    pytest.param(128, 4, True, True, 0.0, id="dh32-packed-qknorm"),
    pytest.param(128, 2, False, True, 0.0, id="dh64"),
    pytest.param(64, 2, True, True, 0.25, id="dropout"),
])
def test_encoder_stack_train_matches_jax(d, H, qk, masked, rate):
    params, port, x, km, gy = _setup(d, H, qk, masked)
    key = jax.random.PRNGKey(3)
    jkm = None if km is None else jnp.asarray(km)

    def jax_loss(p, xx):
        w = jsw(p, num_layers=L, compute_dtype=jnp.float32)
        y = jax_stack_train(xx, jkm, w, num_heads=H, qk_norm=qk,
                            dropout_rate=rate,
                            dropout_rng=key if rate else None)
        return (jax_final_ln(y, w) * gy).sum()

    want, (gp, gx) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        params, jnp.asarray(x))
    drop = None
    if rate:   # the bytes the JAX wrapper draws from the same key
        drop = torch.from_numpy(np.array(jax.random.bits(
            key, (2 * L, B, T, d), dtype=jnp.uint8)))
    xt = torch.from_numpy(x).requires_grad_(True)
    w = stack_encoder_weights(port.state_dict(keep_vars=True), num_layers=L,
                              compute_dtype=torch.float32, grad=True)
    y = est.fused_encoder_stack_train(
        xt, None if km is None else torch.from_numpy(km), w, num_heads=H,
        qk_norm=qk, dropout_rate=rate, dropout_bytes=drop)
    got = (est.apply_final_ln(y, w) * torch.from_numpy(gy)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4)
    ref = _flat(gp)
    assert set(ref) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-3,
                                   atol=1e-4, err_msg=name)


def test_dropout_bytes_from_a_generator_are_reproducible():
    _, port, x, km, _ = _setup(64, 2, False, True)
    w = port.stacked_weights()
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        outs.append(est.fused_encoder_stack_train(
            torch.from_numpy(x), torch.from_numpy(km), w, num_heads=2,
            dropout_rate=0.1, generator=gen))
    assert torch.equal(outs[0], outs[1])
    plain = est.fused_encoder_stack_train(torch.from_numpy(x),
                                          torch.from_numpy(km), w,
                                          num_heads=2)
    assert not torch.equal(outs[0], plain)


@pytest.mark.parametrize("qk", [False, True])
def test_encoder_layer_bwd_matches_jax(qk):
    """One layer's backward, plain version against the JAX ``_layer_bwd``
    kernel, dropout on."""
    d, H = 64, 2
    params, port, x, km, gy = _setup(d, H, qk, True, seed=1)
    wj = jsw(params, num_layers=L, compute_dtype=jnp.float32)
    wl = {k: _row(a[1]) for k, a in wj.items() if k not in ("lnfs", "lnfb")}
    bias = jnp.where(jnp.asarray(km), 0.0, -1e9).astype(
        jnp.float32)[:, None, :]
    thresh = 64
    bits = np.random.default_rng(5).integers(0, 256, (2, B, T, d),
                                             dtype=np.uint8)
    dx, dw = _layer_bwd(jnp.asarray(x), jnp.asarray(gy), bias,
                        jnp.asarray(bits), wl, H=H, Dh=d // H,
                        scale=1.0 / (d // H) ** 0.5, use_mask=True,
                        qk_norm=qk, drop_thresh=thresh)
    wp = port.stacked_weights()
    wlp = {k: v[1] for k, v in wp.items() if k not in ("lnfs", "lnfb")}
    got_dx, got_dw = est.encoder_layer_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(gy),
        est.key_bias_from_mask(torch.from_numpy(km)),
        torch.from_numpy(bits), wlp, num_heads=H, qk_norm=qk, thresh=thresh)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(dx), rtol=1e-3,
                               atol=1e-4)
    for k in est.WKEYS:
        np.testing.assert_allclose(
            got_dw[k].numpy().reshape(-1), np.asarray(dw[k]).reshape(-1),
            rtol=1e-3, atol=1e-4, err_msg=k)
