"""The port's greedy AR decode == the JAX package's, in float32.

Whole decodes: the port's chunk engine (``infer/fast_decode.py``, its
kernels' plain versions on the CPU) and its composed decoder against the
JAX composed decoders, ids exactly equal, MDN xy within 1e-5 and pen/valid
exactly. One chunk: ``decode_chunk_reference`` / ``decode_cont_chunk_reference``
against the JAX kernels ``fused_decode_chunk`` / ``fused_decode_cont_chunk``
and their lane-packed variants, run in interpret mode as the JAX package's
own tests run them on the CPU; ``decode_attention_reference`` against
``pallas_decode.decode_attention``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.infer import decode as jdec
from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models.embeddings import sinusoidal_position_encoding
from sketchformer_tpu.ops import pallas_decode_packed as jpk
from sketchformer_tpu.ops.pallas_decode import decode_attention as jax_attn
from sketchformer_tpu.ops.pallas_decode_loop import (
    fused_decode_chunk,
    fused_decode_cont_chunk,
)
from sketchformer_tpu.ops.pallas_decode_stack import (
    precompute_cross_kv as jax_cross_kv,
)
from sketchformer_tpu.ops.pallas_decoder_train import stack_decoder_weights
from sketchformer_tpu_torch.infer import decode as tdec
from sketchformer_tpu_torch.infer import fast_decode
from sketchformer_tpu_torch.ops import decode_chunk as dc
from sketchformer_tpu_torch.ops.decode_attention import (
    decode_attention_reference,
)
from torch_port_util import (
    cont_batch,
    jax_model_and_params,
    port_model,
    token_batch,
)

EOS_ID = 2


def _jax_z(model, params, *enc):
    z, _, _ = model.apply({"params": params}, *(jnp.asarray(a) for a in enc),
                          method=JaxSketchformer.encode)
    return np.array(z)


@pytest.mark.parametrize("over", [
    pytest.param(dict(num_heads=4), id="H4"),
    pytest.param(dict(num_heads=2, qk_norm=True), id="H2-qknorm"),
])
def test_token_decode_matches_jax(over):
    """Ids exactly equal to JAX ``make_token_decoder(fast=False)``, from
    sketches and from z, with T=24 not a multiple of the chunk K."""
    model, params = jax_model_and_params(max_len=24, **over)
    enc = token_batch(model.config)
    want = np.asarray(jdec.make_token_decoder(model, fast=False)(
        params, jnp.asarray(enc)))
    port = port_model(model, params)
    enc_t = torch.from_numpy(enc)
    for K in (None, 5, 7):           # None: min(16, T)
        got = tdec.make_token_decoder(port, steps_per_call=K)(enc_t)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"K={K}")
    got = tdec.make_token_decoder(port, fast=False)(enc_t)
    np.testing.assert_array_equal(got.numpy(), want)

    z = _jax_z(model, params, enc)
    want_z = np.asarray(jdec.make_token_decoder_from_z(model, fast=False)(
        params, jnp.asarray(z)))
    got_z = tdec.make_token_decoder_from_z(port)(torch.from_numpy(z))
    np.testing.assert_array_equal(got_z.numpy(), want_z)


@pytest.mark.parametrize("over", [
    pytest.param(dict(num_heads=4), id="H4"),
    pytest.param(dict(num_heads=2, qk_norm=True), id="H2-qknorm"),
])
def test_cont_greedy_decode_matches_jax(over):
    """MDN greedy: xy within 1e-5, pen and valid exactly equal to JAX
    ``make_cont_decoder(early_exit=False)``, chunk engine and composed."""
    model, params = jax_model_and_params(max_len=24, use_continuous=True,
                                         num_mixtures=3, **over)
    rows, mask = cont_batch(model.config)
    want = jdec.make_cont_decoder(model, early_exit=False)(
        params, jnp.asarray(rows), jnp.asarray(mask), jax.random.PRNGKey(0))
    port = port_model(model, params)
    args = (torch.from_numpy(rows), torch.from_numpy(mask))
    for got in (tdec.make_cont_decoder(port)(*args),
                tdec.make_cont_decoder(port, early_exit=False)(*args)):
        xy, pen, valid = (g.numpy() for g in got)
        np.testing.assert_allclose(xy, np.asarray(want[0]), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(pen, np.asarray(want[1]))
        np.testing.assert_array_equal(valid, np.asarray(want[2]))


def test_decode_stops_at_the_first_chunk_where_every_row_ended(monkeypatch):
    """EOS early exit at chunk granularity: with the EOS logit raised, the
    chunk loop launches exactly up to the chunk holding the last row's
    EOS, and the ids are still the JAX decoder's."""
    model, params = jax_model_and_params(max_len=24, num_heads=2)
    bias = params["out_head"]["proj"]["bias"]
    enc = token_batch(model.config)
    calls = []
    real = fast_decode.decode_chunk

    def counting(*args, **kw):
        calls.append(args[11])            # the chunk start t0
        return real(*args, **kw)

    monkeypatch.setattr(fast_decode, "decode_chunk", counting)
    K, T = 5, 24
    for boost in (40.0, 0.8):
        params["out_head"]["proj"]["bias"] = bias.copy()
        params["out_head"]["proj"]["bias"][EOS_ID] += boost
        want = np.asarray(jdec.make_token_decoder(model, fast=False)(
            params, jnp.asarray(enc)))
        calls.clear()
        got = tdec.make_token_decoder(port_model(model, params),
                                      steps_per_call=K)(torch.from_numpy(enc))
        np.testing.assert_array_equal(got.numpy(), want)
        ended = (want == EOS_ID).any(axis=1)
        assert ended.all(), f"boost {boost}: not every row reached EOS"
        last = int((want == EOS_ID).argmax(axis=1).max())
        assert calls == list(range(0, last // K * K + 1, K)), (boost, last)
        assert calls[-1] + K < T        # the loop did stop early
    assert last >= K                    # the milder boost ran > 1 chunk


@pytest.mark.parametrize("over", [
    pytest.param(dict(norm_first=False), id="post-ln"),
    pytest.param(dict(bottleneck_mode="direct", qk_norm=True), id="direct"),
])
def test_declined_configs_decode_composed(over, monkeypatch):
    """Configurations the chunk engine declines (as the JAX engine does)
    decode on the composed path, with the JAX decoder's ids."""
    model, params = jax_model_and_params(max_len=24, num_heads=2, **over)
    ok, why = fast_decode.fast_decode_support(port_model(model, params))
    assert not ok and why
    monkeypatch.setattr(fast_decode, "decode_chunk", None)   # never called
    enc = token_batch(model.config)
    want = np.asarray(jdec.make_token_decoder(model, fast=False)(
        params, jnp.asarray(enc)))
    port = port_model(model, params)
    got = tdec.make_token_decoder(port)(torch.from_numpy(enc))
    np.testing.assert_array_equal(got.numpy(), want)
    got = fast_decode.make_fast_token_decoder(port)(torch.from_numpy(enc))
    np.testing.assert_array_equal(got.numpy(), want)


def _chunk_setup(qk_norm, cont):
    model, params = jax_model_and_params(
        max_len=32, num_heads=2, qk_norm=qk_norm, use_continuous=cont,
        num_mixtures=3)
    cfg = model.config
    L, H, d = cfg.num_layers, cfg.num_heads, cfg.d_model
    Dh = d // H
    B, K, Tmax, t0, Mq = 3, 4, 16, 5, cfg.num_queries
    rng = np.random.default_rng(0)
    mem = rng.standard_normal((B, Mq, d)).astype(np.float32)
    kc, vc = (np.zeros((L, B * H, Tmax, Dh), np.float32) for _ in range(2))
    kc[:, :, :t0] = rng.standard_normal((L, B * H, t0, Dh))
    vc[:, :, :t0] = rng.standard_normal((L, B * H, t0, Dh))
    pos = sinusoidal_position_encoding(cfg.max_len, d)[t0:t0 + K]
    fin = np.array([0, 1, 0], np.int32)
    head = params["out_head"]["proj"]
    if cont:
        emb = params["dec_embed"]["proj"]
        prev = np.concatenate([rng.standard_normal((B, 2)),
                               np.eye(3)[[0, 1, 2]]], 1).astype(np.float32)
        ins = (emb["kernel"], emb["bias"])
    else:
        prev = np.array([5, 7, 1], np.int32)
        ins = (params["dec_embed"]["embed"]["embedding"],)
    return (model, params, dict(H=H, Dh=Dh, B=B, K=K, Tmax=Tmax, t0=t0),
            mem, kc, vc, pos, prev, fin, ins, (head["kernel"], head["bias"]))


def _pack(c, B, H):
    """Folded (L, B*H, T, Dh) -> the packed kernels' (L, B, T, H*Dh)."""
    L, _, T, Dh = c.shape
    return c.reshape(L, B, H, T, Dh).transpose(0, 1, 3, 2, 4).reshape(
        L, B, T, H * Dh)


def _unpack(c, H):
    L, B, T, HD = c.shape
    return c.reshape(L, B, T, H, HD // H).transpose(0, 1, 3, 2, 4).reshape(
        L, B * H, T, HD // H)


@pytest.mark.parametrize("cont", [False, True], ids=["token", "mdn"])
@pytest.mark.parametrize("packed", [False, True], ids=["folded", "packed"])
def test_chunk_reference_matches_jax_kernel(cont, packed):
    """One chunk of K steps from t0 > 0 with a finished row: the plain
    version against the JAX TPU kernel (interpret mode), f32."""
    qk = cont != packed
    (model, params, g, mem, kc, vc, pos, prev, fin, ins,
     head) = _chunk_setup(qk, cont)
    H, B, K, t0 = g["H"], g["B"], g["K"], g["t0"]
    L = model.config.num_layers
    w = stack_decoder_weights(params["decoder"], num_layers=L,
                              compute_dtype=jnp.float32)
    port = port_model(model, params)
    wt = port.decoder.stacked_weights()
    ck, cv = dc.precompute_cross_kv(torch.from_numpy(mem), wt, num_heads=H,
                                    qk_norm=qk)
    jck, jcv = jax_cross_kv(jnp.asarray(mem), w, num_heads=H, qk_norm=qk)
    np.testing.assert_allclose(ck.numpy(), np.asarray(jck), atol=1e-5)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jcv), atol=1e-5)

    jprev = prev if cont else prev[:, None]
    jargs = [jnp.asarray(a) for a in (jprev, fin[:, None], kc, vc)]
    if packed:
        w = jpk.stack_packed_qk_norms(w, H)
        jck, jcv = jpk.precompute_cross_kv_packed(jnp.asarray(mem), w,
                                                  num_heads=H, qk_norm=qk)
        jargs[2:] = [jnp.asarray(_pack(c, B, H)) for c in (kc, vc)]
        kernel = (jpk.fused_decode_cont_chunk_packed if cont
                  else jpk.fused_decode_chunk_packed)
    else:
        kernel = fused_decode_cont_chunk if cont else fused_decode_chunk
    kw = dict(num_heads=H, qk_norm=qk)
    if cont:
        kw["num_mixtures"] = model.config.num_mixtures
    *want, kn, vn = kernel(
        *jargs, jck, jcv, *(jnp.asarray(a) for a in (*ins, pos, *head)), w,
        jnp.int32(t0), **kw)
    if packed:
        kn, vn = _unpack(np.asarray(kn), H), _unpack(np.asarray(vn), H)

    kct, vct = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    ref = (dc.decode_cont_chunk_reference if cont
           else dc.decode_chunk_reference)
    got = ref(torch.from_numpy(prev), torch.from_numpy(fin), kct, vct, ck, cv,
              *(torch.from_numpy(np.asarray(a)) for a in (*ins, pos, *head)),
              wt, t0, **kw)
    want[-1] = np.asarray(want[-1])[:, 0]            # finished (B, 1)
    for gv, wv in zip(got, want):
        if gv.is_floating_point():
            np.testing.assert_allclose(gv.numpy(), np.asarray(wv),
                                       rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    for got_c, new in ((kct, kn), (vct, vn)):
        np.testing.assert_allclose(got_c[:, :, t0:t0 + K].numpy(),
                                   np.asarray(new), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(kct[:, :, :t0].numpy(), kc[:, :, :t0])


def test_decode_attention_reference_matches_pallas():
    rng = np.random.default_rng(3)
    BH, Tmax, Dh = 6, 16, 8
    q = rng.standard_normal((BH, 1, Dh)).astype(np.float32)
    k, v = (rng.standard_normal((BH, Tmax, Dh)).astype(np.float32)
            for _ in range(2))
    for cache_len in (1, 7, Tmax):
        want = jax_attn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.int32(cache_len))
        got = decode_attention_reference(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v), cache_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
