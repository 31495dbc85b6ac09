"""The port's ``embed`` and classifier == the JAX package's, in float32.

Same seeded numpy inputs, same (perturbed flax-init) weights converted with
``convert.params_from_flax``. The JAX side runs ``fast_embed`` (the Pallas
encoder kernel, interpret mode on CPU) and ``model.apply(...,
method=Sketchformer.embed)``; the port runs its kernel engine (the plain
path on CPU tensors) and its composed model.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.infer.fast_encode import fast_embed as jax_fast_embed
from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu.models.embeddings import (
    sinusoidal_position_encoding as jax_posenc,
)
from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.convert import (
    init_params,
    load_npz,
    params_from_flax,
    save_npz,
)
from sketchformer_tpu_torch.infer.fast_encode import fast_embed, supports_fast_path
from sketchformer_tpu_torch.models.embeddings import sinusoidal_position_encoding
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from torch_port_util import (
    assert_close,
    cont_batch,
    jax_model_and_params,
    port_model,
    token_batch,
)

CASES = [
    pytest.param(dict(), id="tok-attn"),
    pytest.param(dict(qk_norm=True), id="tok-attn-qknorm"),
    pytest.param(dict(bottleneck_mode="mean"), id="tok-mean"),
    pytest.param(dict(bottleneck_mode="direct"), id="tok-direct"),
    pytest.param(dict(use_continuous=True), id="cont-attn"),
    pytest.param(dict(use_continuous=True, bottleneck_mode="mean"),
                 id="cont-mean"),
]


def _inputs(cfg):
    if cfg.use_continuous:
        rows, mask = cont_batch(cfg)
        return (jnp.asarray(rows), jnp.asarray(mask)), (
            torch.from_numpy(rows), torch.from_numpy(mask))
    ids = token_batch(cfg)
    return (jnp.asarray(ids), None), (torch.from_numpy(ids), None)


@pytest.mark.parametrize("over", CASES)
def test_embed_and_logits_match_jax(over):
    model, params = jax_model_and_params(**over)
    (enc_j, mask_j), (enc_t, mask_t) = _inputs(model.config)
    want_fast = jax_fast_embed(model, params, enc_j, mask_j)
    want = model.apply({"params": params}, enc_j, mask_j,
                       method=JaxSketchformer.embed)
    want_logits = model.apply({"params": params}, want,
                              method=lambda m, z: m.classifier(z))

    port = port_model(model, params)
    assert supports_fast_path(port)
    with torch.no_grad():
        got_fast = fast_embed(port, enc_t, mask_t)
        got = port.embed(enc_t, mask_t)
        got_logits = port.classify(got)
    assert got.dtype == torch.float32
    assert got.shape == (enc_t.shape[0], model.config.lowerdim)
    assert_close(got_fast, want_fast)
    assert_close(got_fast, want)
    assert_close(got, want)
    assert got_logits.shape == (enc_t.shape[0], model.config.num_classes)
    assert_close(got_logits, want_logits)


def test_post_ln_embed_declines_fast_path_and_matches_jax():
    model, params = jax_model_and_params(norm_first=False)
    (enc_j, _), (enc_t, _) = _inputs(model.config)
    want = model.apply({"params": params}, enc_j, method=JaxSketchformer.embed)
    port = port_model(model, params)
    assert not supports_fast_path(port)
    with torch.no_grad():
        assert_close(fast_embed(port, enc_t), want)


def test_sinusoidal_table_matches_jax():
    for max_len, d in ((1, 2), (48, 32), (192, 256), (7, 10)):
        np.testing.assert_array_equal(sinusoidal_position_encoding(max_len, d),
                                      jax_posenc(max_len, d))


@pytest.mark.parametrize("over", [
    pytest.param(dict(), id="tok-attn"),
    pytest.param(dict(use_continuous=True, bottleneck_mode="direct",
                      qk_norm=True), id="cont-direct-qknorm"),
])
def test_init_params_shapes_match_flax_init(over):
    kw = dict(vocab_size=64, num_classes=5, max_len=48, d_model=32,
              num_layers=2, num_heads=4, dff=64, lowerdim=16, num_queries=2)
    kw.update(over)
    jcfg = JaxConfig(**kw)
    if jcfg.use_continuous:
        enc, dec_in = (np.zeros((2, 48, 3), np.float32),
                       np.zeros((2, 48, 5), np.float32))
    else:
        enc = dec_in = np.ones((2, 48), np.int32)
    flax_params = jax.device_get(JaxSketchformer(jcfg).init(
        jax.random.PRNGKey(0), enc, dec_in)["params"])
    state = params_from_flax(flax_params)

    cfg = SketchformerConfig(**kw)
    init = init_params(cfg, seed=3)
    assert {k: tuple(v.shape) for k, v in init.items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    again = init_params(cfg, seed=3)
    assert all(torch.equal(init[k], again[k]) for k in init)
    kernel = init["encoder.layer_0.ffn.in.kernel"]
    assert kernel.abs().max() <= 2.0 / 0.8796 / np.sqrt(32) + 1e-6
    assert torch.all(init["encoder.layer_0.ln1.scale"] == 1.0)
    assert torch.all(init["encoder.layer_0.ffn.in.bias"] == 0.0)
    Sketchformer(cfg).load_state_dict(init)      # strict: every key fits


def test_npz_round_trip(tmp_path):
    model, params = jax_model_and_params()
    state = params_from_flax(params)
    path = str(tmp_path / "w.npz")
    save_npz(path, state)
    with np.load(path) as data:
        assert "encoder/layer_0/self_attn/query/kernel" in data.files
    back = load_npz(path)
    assert back.keys() == state.keys()
    assert all(torch.equal(back[k], state[k]) for k in state)
    cfg = SketchformerConfig(**dataclasses.asdict(model.config))
    Sketchformer(cfg).load_state_dict(back)


@pytest.mark.parametrize("kind", ["tok", "cont"])
def test_golden_fixture_embedding_and_logits(kind):
    """The committed golden fixtures (tests/test_golden.py): the flax init
    at PRNGKey(7), converted, gives the pinned embedding and class logits."""
    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                f"golden_{kind}.npz"))
    kw = dict(num_classes=5, max_len=16, d_model=16, num_layers=2,
              num_heads=2, dff=32, dropout=0.0, lowerdim=8, num_queries=2)
    if kind == "tok":
        kw.update(vocab_size=68)
        args = (data["enc"], data["dec_in"])
        enc_mask = None
    else:
        kw.update(vocab_size=1, use_continuous=True, num_mixtures=3)
        args = (data["enc"], data["dec_in"], data["mask"], data["mask"])
        enc_mask = torch.from_numpy(data["mask"])
    params = JaxSketchformer(JaxConfig(**kw)).init(
        jax.random.PRNGKey(7), *(jnp.asarray(a) for a in args))["params"]
    port = Sketchformer(SketchformerConfig(**kw))
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        z = port.embed(torch.from_numpy(data["enc"]), enc_mask)
        logits = port.classify(z)
    np.testing.assert_allclose(z.numpy(), data["embedding"], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(logits.numpy(), data["cls"], atol=1e-5,
                               rtol=1e-5)
