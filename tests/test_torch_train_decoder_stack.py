"""The port's decoder stack (K4) against the JAX package's
``fused_decoder_stack_train`` / ``fused_decoder_stack`` in Pallas interpret
mode, f32 on the CPU: the value and the gradients of the input, of the
memory and of every weight, with shared dropout bytes; the eval forward;
and one layer's backward against ``_dec_layer_bwd``. Tolerances as
tests/test_pallas_decoder_train.py: value rtol 1e-4, gradients rtol 1e-3 /
atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.models.transformer import Decoder as JaxDecoder
from sketchformer_tpu.ops.pallas_decoder_train import (
    _biases,
    _dec_layer_bwd,
    fused_decoder_stack as jax_stack,
    fused_decoder_stack_train as jax_stack_train,
    stack_decoder_weights as jsw,
)
from sketchformer_tpu.ops.pallas_encoder_train import (
    _row,
    apply_final_ln as jax_final_ln,
)
from sketchformer_tpu_torch.convert import params_from_flax
from sketchformer_tpu_torch.models.transformer import Decoder
from sketchformer_tpu_torch.ops import decoder_stack_train as dst
from sketchformer_tpu_torch.ops.encoder_stack_train import (
    apply_final_ln,
    key_bias_from_mask,
)

B, T, L, DFF, MQ = 4, 16, 2, 64, 4


def _setup(d, H, qk, cross_mask, seed=0, self_mask=True):
    dec = JaxDecoder(num_layers=L, num_heads=H, d_model=d, dff=DFF,
                     dropout=0.0, dtype=jnp.float32, attn_impl="xla",
                     qk_norm=qk)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    mem = rng.standard_normal((B, MQ, d)).astype(np.float32)
    sm = None
    if self_mask:
        sm = np.ones((B, T), bool)
        sm[:, -5:] = False
    cm = None
    if cross_mask:
        cm = np.ones((B, MQ), bool)
        cm[1, 2:] = False
    params = dec.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mem),
                      causal=True)["params"]
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
            a.shape).astype(np.float32), params)
    port = Decoder(L, H, d, DFF, torch.float32, "pallas", True, qk)
    sd = params_from_flax({"decoder": params})
    port.load_state_dict({k[len("decoder."):]: v for k, v in sd.items()})
    gy = rng.standard_normal((B, T, d)).astype(np.float32)
    return params, port, x, mem, sm, cm, gy


def _flat(tree):
    """A JAX gradient tree under the port's keys (``params_from_flax``)."""
    sd = params_from_flax({"decoder": tree})
    return {k[len("decoder."):]: v.numpy() for k, v in sd.items()}


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("d,H,qk,cross_mask,self_mask,rate", [
    pytest.param(64, 2, False, False, False, 0.0, id="dh32-unmasked"),
    pytest.param(128, 4, True, True, True, 0.0,
                 id="dh32-packed-qknorm-masked"),
    pytest.param(128, 2, True, True, True, 0.25, id="dh64-masked-dropout"),
])
def test_decoder_stack_train_matches_jax(d, H, qk, cross_mask, self_mask,
                                         rate):
    params, port, x, mem, sm, cm, gy = _setup(d, H, qk, cross_mask,
                                              self_mask=self_mask)
    key = jax.random.PRNGKey(3)
    jcm = None if cm is None else jnp.asarray(cm)
    jsm = None if sm is None else jnp.asarray(sm)

    def jax_loss(p, xx, mm):
        w = jsw(p, num_layers=L, compute_dtype=jnp.float32)
        y = jax_stack_train(xx, mm, jsm, jcm, w, num_heads=H,
                            qk_norm=qk, dropout_rate=rate,
                            dropout_rng=key if rate else None)
        return (jax_final_ln(y, w) * gy).sum()

    want, (gp, gx, gm) = jax.value_and_grad(jax_loss, argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(mem))
    drop = None
    if rate:   # the bytes the JAX wrapper draws from the same key
        drop = torch.from_numpy(np.array(jax.random.bits(
            key, (3 * L, B, T, d), dtype=jnp.uint8)))
    xt = torch.from_numpy(x).requires_grad_(True)
    mt = torch.from_numpy(mem).requires_grad_(True)
    w = port.stacked_weights(grad=True)
    y = dst.fused_decoder_stack_train(xt, mt, _t(sm), _t(cm), w,
                                      num_heads=H, qk_norm=qk,
                                      dropout_rate=rate, dropout_bytes=drop)
    got = (apply_final_ln(y, w) * torch.from_numpy(gy)).sum()
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(gm), rtol=1e-3,
                               atol=1e-4)
    ref = _flat(gp)
    assert set(ref) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name], rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    # the eval forward with the final LayerNorm (fused_decoder_stack)
    wj = jsw(params, num_layers=L, compute_dtype=jnp.float32)
    ye = jax_stack(jnp.asarray(x), jnp.asarray(mem), jsm, jcm, wj,
                   num_heads=H, qk_norm=qk)
    with torch.no_grad():
        yp = dst.fused_decoder_stack(_t(x), _t(mem), _t(sm), _t(cm),
                                     port.stacked_weights(), num_heads=H,
                                     qk_norm=qk)
    np.testing.assert_allclose(yp.numpy(), np.asarray(ye), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("qk", [False, True])
def test_decoder_layer_bwd_matches_jax(qk):
    """One layer's backward, plain version against the JAX
    ``_dec_layer_bwd`` kernel, dropout on."""
    d, H = 64, 2
    params, port, x, mem, sm, cm, gy = _setup(d, H, qk, True, seed=1)
    wj = jsw(params, num_layers=L, compute_dtype=jnp.float32)
    wl = {k: _row(wj[k][0]) for k in dst.DWKEYS}
    sbias, cbias = _biases(jnp.asarray(sm), jnp.asarray(cm))
    thresh = 64
    bits = np.random.default_rng(5).integers(0, 256, (3, B, T, d),
                                             dtype=np.uint8)
    dx, dmem, dw = _dec_layer_bwd(
        jnp.asarray(x), jnp.asarray(mem), jnp.asarray(gy), sbias, cbias,
        jnp.asarray(bits), wl, H=H, Dh=d // H, scale=1.0 / (d // H) ** 0.5,
        use_smask=True, use_cmask=True, qk_norm=qk, drop_thresh=thresh)
    wp = port.stacked_weights()
    got_dx, got_dmem, got_dw = dst.decoder_layer_bwd_reference(
        _t(x), _t(mem), _t(gy), key_bias_from_mask(_t(sm)),
        key_bias_from_mask(_t(cm)), _t(bits),
        {k: wp[k][0] for k in dst.DWKEYS}, num_heads=H, qk_norm=qk,
        thresh=thresh)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(dx), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(got_dmem.numpy(), np.asarray(dmem),
                               rtol=1e-3, atol=1e-4)
    for k in dst.DWKEYS:
        np.testing.assert_allclose(
            got_dw[k].numpy().reshape(-1), np.asarray(dw[k]).reshape(-1),
            rtol=1e-3, atol=1e-4, err_msg=k)
