"""The port's encoder stack == the JAX package's, in float32.

``encoder_stack_reference`` (the plain torch version of the Hopper kernels,
and what ``fused_encoder_stack`` runs on CPU tensors) is held to the JAX
``fused_encoder_stack`` (Pallas, interpret mode on CPU) and to the JAX
composed ``Encoder``; the port's composed ``Encoder`` is held to the JAX
composed one, pre-LN and post-LN. Geometries: d=64/H=2 takes the JAX
kernel's per-head loop; d=128/H=4 (head_dim 32) its packed
``group_attn_fwd`` / ``ln_blocks_fwd32`` path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.models.transformer import Encoder as JaxEncoder
from sketchformer_tpu.ops import pallas_packed
from sketchformer_tpu.ops.pallas_encoder import (
    fused_encoder_stack as jax_fused_encoder_stack,
    stack_encoder_weights as jax_stack_encoder_weights,
)
from sketchformer_tpu_torch.convert import params_from_flax
from sketchformer_tpu_torch.models.transformer import Encoder
from sketchformer_tpu_torch.ops.encoder_stack import (
    encoder_stack_reference,
    fused_encoder_stack,
)
from torch_port_util import assert_close, perturb

B, T, L = 4, 32, 2


def _setup(d, H, qk_norm, masked, norm_first=True, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    km = None
    if masked:
        lengths = np.array([0, T, T // 2, 5])    # row 0: every key is PAD
        km = np.arange(T)[None, :] < lengths[:, None]
    jax_enc = JaxEncoder(L, H, d, 2 * d, 0.0, jnp.float32, "xla", norm_first,
                         qk_norm)
    params = jax_enc.init(
        {"params": jax.random.PRNGKey(seed)}, jnp.asarray(x),
        key_mask=None if km is None else jnp.asarray(km))["params"]
    params = perturb(params, seed + 1)
    port = Encoder(L, H, d, 2 * d, torch.float32, "xla", norm_first, qk_norm)
    state = params_from_flax({"encoder": params})
    port.load_state_dict({k[len("encoder."):]: v for k, v in state.items()})
    return x, km, jax_enc, params, port.eval()


GEOMETRIES = [pytest.param(64, 2, id="d64-H2-per-head"),
              pytest.param(128, 4, id="d128-H4-packed")]


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["plain", "qknorm"])
@pytest.mark.parametrize("d,H", GEOMETRIES)
def test_stack_matches_jax_kernel_and_composed(d, H, qk_norm, masked):
    x, km, jax_enc, params, port = _setup(d, H, qk_norm, masked)
    assert pallas_packed.packed_supported(d, H) == (H == 4)
    w_jax = jax_stack_encoder_weights(params, num_layers=L,
                                      compute_dtype=jnp.float32)
    km_j = None if km is None else jnp.asarray(km)
    want_kernel = jax_fused_encoder_stack(jnp.asarray(x), km_j, w_jax,
                                          num_heads=H, qk_norm=qk_norm)
    want_composed = jax_enc.apply({"params": params}, jnp.asarray(x),
                                  key_mask=km_j)

    xt = torch.from_numpy(x)
    kmt = None if km is None else torch.from_numpy(km)
    with torch.no_grad():
        w = port.stacked_weights()
        got = encoder_stack_reference(xt, kmt, w, num_heads=H,
                                      qk_norm=qk_norm)
        got_fused = fused_encoder_stack(xt, kmt, w, num_heads=H,
                                        qk_norm=qk_norm)
        got_composed = port(xt, key_mask=kmt)
    assert torch.isfinite(got).all()
    assert_close(got, want_kernel)
    assert_close(got, want_composed)
    assert torch.equal(got_fused, got)       # CPU tensors: the plain path
    assert_close(got_composed, want_composed)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_post_ln_composed_matches_jax(masked):
    x, km, jax_enc, params, port = _setup(64, 2, False, masked,
                                          norm_first=False)
    want = jax_enc.apply({"params": params}, jnp.asarray(x),
                         key_mask=None if km is None else jnp.asarray(km))
    with torch.no_grad():
        got = port(torch.from_numpy(x),
                   key_mask=None if km is None else torch.from_numpy(km))
    assert_close(got, want)


def test_pallas_impl_takes_the_stack_and_post_ln_declines(caplog):
    """attn_impl='pallas' runs the kernel stack where the JAX Encoder takes
    its fused path, and logs the decline for post-LN."""
    x, km, _, _, port = _setup(64, 2, True, True)
    port.attn_impl = "pallas"
    xt, kmt = torch.from_numpy(x), torch.from_numpy(km)
    with torch.no_grad():
        got = port(xt, key_mask=kmt)
        want = encoder_stack_reference(xt, kmt, port.stacked_weights(),
                                       num_heads=2, qk_norm=True)
    assert torch.equal(got, want)

    from sketchformer_tpu_torch.utils.engines import reset_seen

    reset_seen()
    x, km, _, _, post = _setup(64, 2, False, True, norm_first=False)
    post.attn_impl = "pallas"
    with caplog.at_level("WARNING", logger="sketchformer_tpu_torch.engines"):
        with torch.no_grad():
            post(torch.from_numpy(x), key_mask=torch.from_numpy(km))
    assert "post-LN config" in caplog.text
