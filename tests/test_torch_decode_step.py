"""The port's whole-step decode (``ops/decode_step.py``, K13) against the
JAX package's ``fused_decode_step`` (Pallas, interpret mode on the CPU), in
float32: the final LayerNorm's output and the new k/v rows for cache
positions t = 0, 5 and 15 of 16, with and without qk-norm, at two head
geometries; and the step loop's greedy ids against the JAX composed
decoder's. On the CPU the wrapper runs the plain version; the CUDA kernel
is held to it on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.infer import decode as jdec
from sketchformer_tpu.ops.pallas_decode_stack import (
    fused_decode_step as jax_step,
    precompute_cross_kv as jax_cross_kv,
)
from sketchformer_tpu.ops.pallas_decoder_train import stack_decoder_weights
from sketchformer_tpu_torch.infer import fast_decode
from sketchformer_tpu_torch.ops import decode_step as ds
from torch_port_util import jax_model_and_params, port_model, token_batch

B, TMAX, MQ = 4, 16, 2
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("t", [0, 5, 15])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qknorm"])
@pytest.mark.parametrize("H", [2, 4])
def test_decode_step_matches_jax(H, qk_norm, t):
    """h, k_new and v_new within 1e-5 (rtol and atol) of the JAX kernel
    on the same converted weights, caches, cross K/V and input."""
    model, params = jax_model_and_params(num_heads=H, qk_norm=qk_norm)
    cfg = model.config
    d, L = cfg.d_model, cfg.num_layers
    Dh = d // H
    jw = stack_decoder_weights(params["decoder"], num_layers=L,
                               compute_dtype=jnp.float32)
    rng = np.random.default_rng(t)
    memory = rng.standard_normal((B, MQ, d)).astype(np.float32)
    ck, cv = (np.asarray(a) for a in jax_cross_kv(
        jnp.asarray(memory), jw, num_heads=H, qk_norm=qk_norm))
    kc, vc = (rng.standard_normal((L, B * H, TMAX, Dh)).astype(np.float32)
              for _ in range(2))
    x = rng.standard_normal((B, d)).astype(np.float32)
    want = jax_step(jnp.asarray(x), jnp.asarray(kc), jnp.asarray(vc),
                    jnp.asarray(ck), jnp.asarray(cv), jw, jnp.asarray(t),
                    num_heads=H, qk_norm=qk_norm)
    port = port_model(model, params)
    w = port.decoder.stacked_weights()
    ds.reset_launches()
    got = ds.fused_decode_step(
        *(torch.from_numpy(np.array(a)) for a in (x, kc, vc, ck, cv)), w, t,
        num_heads=H, qk_norm=qk_norm)
    assert ds.LAUNCHES == {"decode_step": 0}     # the CPU runs plain
    for name, g, wnt in zip(("h", "k_new", "v_new"), got, want):
        assert tuple(g.shape) == tuple(wnt.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("over", [
    pytest.param(dict(num_heads=4), id="H4"),
    pytest.param(dict(num_heads=2, qk_norm=True), id="H2-qknorm"),
])
def test_step_loop_ids_match_jax_composed_decode(over):
    """The step loop's greedy ids, one fused_decode_step per position,
    equal JAX ``make_token_decoder(fast=False)``'s exactly (T=24)."""
    model, params = jax_model_and_params(max_len=24, **over)
    enc = token_batch(model.config)
    want = np.asarray(jdec.make_token_decoder(model, fast=False)(
        params, jnp.asarray(enc)))
    port = port_model(model, params)
    got = fast_decode.make_step_token_decoder(port)(torch.from_numpy(enc))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_step_loop_declines_post_ln():
    model, params = jax_model_and_params(norm_first=False)
    with pytest.raises(ValueError, match="post-LN"):
        fast_decode.make_step_token_decoder(port_model(model, params))
