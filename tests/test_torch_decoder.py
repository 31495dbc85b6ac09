"""The port's decoder side == the JAX package's, in float32.

Same seeded numpy inputs, same (perturbed flax-init) weights converted with
``convert.params_from_flax``: the cached ``decode_step`` over several steps
against the JAX ``Sketchformer.decode_step`` (composed, ``attn_impl='xla'``),
the teacher-forced ``forward`` against the JAX ``__call__`` and the committed
golden fixtures, the decoder weight bridge, and the MDN helpers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.models import Sketchformer as JaxSketchformer
from sketchformer_tpu.models import SketchformerConfig as JaxConfig
from sketchformer_tpu.ops import mdn as jax_mdn
from sketchformer_tpu.ops.pallas_decoder_train import stack_decoder_weights
from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.convert import (
    params_from_flax,
    stacked_decoder_weights,
)
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.ops import mdn
from torch_port_util import (
    assert_close,
    cont_batch,
    dec_rows,
    jax_model_and_params,
    port_model,
    token_batch,
)

STEPS = 4
DECODE_CASES = [
    pytest.param(dict(num_heads=2), id="tok-H2"),
    pytest.param(dict(num_heads=4, qk_norm=True), id="tok-H4-qknorm"),
    pytest.param(dict(num_heads=2, qk_norm=True, use_continuous=True,
                      num_mixtures=3), id="cont-H2-qknorm"),
    pytest.param(dict(num_heads=4, use_continuous=True, num_mixtures=3),
                 id="cont-H4"),
]


def _step_inputs(cfg, B, seed=1):
    """STEPS decoder inputs per row: token ids, or 5-feature stroke rows."""
    rng = np.random.default_rng(seed)
    if cfg.use_continuous:
        rows = rng.standard_normal((B, STEPS, 3)).astype(np.float32)
        return dec_rows(rows)
    return rng.integers(1, cfg.vocab_size, (B, STEPS)).astype(np.int32)


@pytest.mark.parametrize("over", DECODE_CASES)
def test_decode_step_matches_jax(over):
    model, params = jax_model_and_params(max_len=16, **over)
    cfg = model.config
    if cfg.use_continuous:
        rows, mask = cont_batch(cfg)
        enc_j, enc_t = (jnp.asarray(rows), jnp.asarray(mask)), (
            torch.from_numpy(rows), torch.from_numpy(mask))
    else:
        ids = token_batch(cfg)
        enc_j, enc_t = (jnp.asarray(ids), None), (torch.from_numpy(ids), None)
    B = enc_t[0].shape[0]
    steps = _step_inputs(cfg, B)

    _, memory, memory_mask = model.apply({"params": params}, *enc_j,
                                         method=JaxSketchformer.encode)
    _, cache = model.apply({"params": params}, B, memory, memory_mask,
                           method=JaxSketchformer.init_cache,
                           mutable=["cache"])
    cache = cache["cache"]

    @jax.jit
    def jax_step(cache, x, t):
        out, upd = model.apply(
            {"params": params, "cache": cache}, x, memory, memory_mask, t,
            method=JaxSketchformer.decode_step, mutable=["cache"])
        return out, upd["cache"]

    port = port_model(model, params)
    with torch.no_grad():
        _, mem_t, mask_t = port.encode(*enc_t)
        caches = port.init_cache(B)
        for t in range(STEPS):
            x = steps[:, t:t + 1]
            want, cache = jax_step(cache, jnp.asarray(x), jnp.int32(t))
            got = port.decode_step(torch.from_numpy(x), mem_t, mask_t, t,
                                   caches)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    assert all(c.index == STEPS for c in caches)


@pytest.mark.parametrize("over", [
    pytest.param(dict(), id="tok"),
    pytest.param(dict(qk_norm=True, bottleneck_mode="direct"),
                 id="tok-qknorm-direct"),
    pytest.param(dict(norm_first=False), id="tok-post-ln"),
    pytest.param(dict(use_continuous=True, num_mixtures=3), id="cont"),
])
def test_teacher_forced_forward_matches_jax(over):
    model, params = jax_model_and_params(**over)
    cfg = model.config
    if cfg.use_continuous:
        rows, mask = cont_batch(cfg)
        dec_in = dec_rows(rows)
        args = (rows, dec_in, mask, mask)
    else:
        ids = token_batch(cfg)
        args = (ids, np.roll(ids, 1, axis=1))
    want = model.apply({"params": params}, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = port_model(model, params)(*(torch.from_numpy(a) for a in args))
    assert set(got) == {"recon", "cls", "embedding"}
    for key in got:
        assert got[key].dtype == torch.float32
        assert_close(got[key], want[key])


@pytest.mark.parametrize("kind", ["tok", "cont"])
def test_golden_fixture_recon(kind):
    """The committed golden fixtures (tests/test_golden.py): the flax init
    at PRNGKey(7), converted, gives the pinned teacher-forced ``recon``."""
    data = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                f"golden_{kind}.npz"))
    kw = dict(num_classes=5, max_len=16, d_model=16, num_layers=2,
              num_heads=2, dff=32, dropout=0.0, lowerdim=8, num_queries=2)
    if kind == "tok":
        kw.update(vocab_size=68)
        args = (data["enc"], data["dec_in"])
    else:
        kw.update(vocab_size=1, use_continuous=True, num_mixtures=3)
        args = (data["enc"], data["dec_in"], data["mask"], data["mask"])
    params = JaxSketchformer(JaxConfig(**kw)).init(
        jax.random.PRNGKey(7), *(jnp.asarray(a) for a in args))["params"]
    port = Sketchformer(SketchformerConfig(**kw))
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    with torch.no_grad():
        out = port.eval()(*(torch.from_numpy(a) for a in args))
    for key in ("recon", "cls", "embedding"):
        np.testing.assert_allclose(out[key].numpy(), data[key], atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("over", [
    pytest.param(dict(), id="tok"),
    pytest.param(dict(use_continuous=True, qk_norm=True), id="cont-qknorm"),
])
def test_params_from_flax_ports_every_subtree(over):
    """Every flax leaf lands in the port's state_dict, which loads strictly,
    and the decoder stacks as the JAX ``stack_decoder_weights`` does."""
    model, params = jax_model_and_params(**over)
    state = params_from_flax(params)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert len(state) == len(leaves)
    assert {k.split(".")[0] for k in state} == set(params)
    port = port_model(model, params)       # load_state_dict(strict=True)
    cfg = model.config
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = stack_decoder_weights(params["decoder"],
                                     num_layers=cfg.num_layers,
                                     compute_dtype=jdt)
        got = stacked_decoder_weights(port.decoder.state_dict(),
                                      num_layers=cfg.num_layers,
                                      compute_dtype=dt)
        assert set(got) == set(want)
        for key, arr in want.items():
            assert got[key].dtype == (
                dt if arr.dtype == jdt else torch.float32), key
            np.testing.assert_array_equal(got[key].float().numpy(),
                                          np.asarray(arr, np.float32),
                                          err_msg=key)
            assert got[key].is_contiguous()


def test_mdn_split_and_greedy_sample_match_jax():
    rng = np.random.default_rng(0)
    M = 4
    raw = (rng.standard_normal((3, 5, 6 * M + 3)) * 4).astype(np.float32)
    want = jax_mdn.split_params(jnp.asarray(raw), M)
    got = mdn.split_params(torch.from_numpy(raw), M)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    assert float(got.log_sigma.max()) <= mdn.LOG_SIGMA_MAX
    assert float(got.rho.abs().max()) <= np.float32(mdn.RHO_MAX)
    wxy, wpen = jax_mdn.sample(want, jax.random.PRNGKey(0), greedy=True)
    gxy, gpen = mdn.sample(got, greedy=True)
    np.testing.assert_array_equal(gxy.numpy(), np.asarray(wxy))
    np.testing.assert_array_equal(gpen.numpy(), np.asarray(wpen))
    gen = torch.Generator().manual_seed(0)
    sxy, spen = mdn.sample(got, gen, temperature=0.7)
    assert sxy.shape == (3, 5, 2) and torch.isfinite(sxy).all()
    assert spen.shape == (3, 5) and int(spen.min()) >= 0 and int(
        spen.max()) <= 2
