"""The port's K8 (``ops/flash_attention.py``) against the JAX package's
``flash_attention`` (Pallas, interpret mode on the CPU), on the same
numpy-seeded inputs: outputs and dq / dk / dv in f32 for every mask mode
(none, key mask, key mask + causal, a full per-batch and a shared bias
pane, a legacy key mask demoted to the vector form), both layouts and two
head geometries, with fully masked rows; the mask/key_mask error; the
T > 1024 decline to the composed math; and the bf16 forward, equal to the
JAX kernel's rounding sites and apart from the composed formulation's.

On the CPU the wrapper runs the plain versions, so this holds their
arithmetic; ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` hold
the CUDA kernels to them on the card."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.models.attention import (
    dot_product_attention as jax_composed,
)
from sketchformer_tpu.ops.pallas_attention import (
    flash_attention as jax_flash,
)
from sketchformer_tpu_torch.ops import flash_attention as fa
from sketchformer_tpu_torch.utils.engines import reset_seen

# f32: the two sides sum in different orders
RTOL, ATOL = 1e-5, 1e-6
B, T = 3, 12
MODES = ["none", "key", "key_causal", "full_batch", "full_shared",
         "legacy_key"]


def _masks(mode, rng):
    """(mask, key_mask, causal) as numpy, with fully masked rows: batch
    element 1 attends to no key, and the full panes hold a query row that
    attends to nothing."""
    km = np.ones((B, T), bool)
    km[0, T - 3:] = False
    km[1, :] = False
    if mode == "none":
        return None, None, False
    if mode == "key":
        return None, km, False
    if mode == "key_causal":
        return None, km, True
    if mode == "legacy_key":
        return km[:, None, None, :], None, False
    pane = rng.random((B if mode == "full_batch" else 1, 1, T, T)) < 0.7
    pane[0, 0, 4, :] = False
    return pane, None, False


def _inputs(H, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, T, H, Dh)).astype(np.float32)
                  for _ in range(4))
    return rng, q, k, v, g


def _heads(x, head_major):
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)) if head_major else x


@pytest.mark.parametrize("H,Dh", [(2, 64), (4, 16)])
@pytest.mark.parametrize("head_major", [False, True],
                         ids=["bthd", "head_major"])
@pytest.mark.parametrize("mode", MODES)
def test_flash_attention_matches_jax(mode, head_major, H, Dh):
    """Output and the gradients of sum(out * g) within rtol 1e-5 / atol
    1e-6 of the JAX kernel (interpret mode) and its custom VJP."""
    rng, q, k, v, g = _inputs(H, Dh)
    mask, km, causal = _masks(mode, rng)
    q, k, v, g = (_heads(x, head_major) for x in (q, k, v, g))
    kw = dict(head_major=head_major, causal=causal)

    def jf(q, k, v):
        return jax_flash(q, k, v, mask=None if mask is None
                         else jnp.asarray(mask),
                         key_mask=None if km is None else jnp.asarray(km),
                         **kw)

    want = jf(q, k, v)
    want_g = jax.grad(lambda *a: jnp.sum(jf(*a) * g), argnums=(0, 1, 2))(
        q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    fa.reset_launches()
    got = fa.flash_attention(
        qt, kt, vt, mask=None if mask is None else torch.from_numpy(mask),
        key_mask=None if km is None else torch.from_numpy(km), **kw)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)
    for name, t, w in zip("qkv", (qt, kt, vt), want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"d{name}")
    # CPU tensors run the plain versions: no kernel launch is counted
    assert fa.LAUNCHES == {"flash_attention_fwd": 0,
                           "flash_attention_bwd": 0}


def test_fully_masked_rows_attend_uniformly():
    """A batch element whose keys are all masked softmaxes s - 1e9 over
    every key: the output is the mean of v (|s| stays below the ulp of
    1e9), under the causal where too, as in the JAX kernel."""
    rng, q, k, v, _ = _inputs(2, 16)
    _, km, _ = _masks("key", rng)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    for causal in (False, True):
        out = fa.flash_attention(qt, kt, vt, key_mask=torch.from_numpy(km),
                                 causal=causal)
        torch.testing.assert_close(out[1], vt[1].mean(0, keepdim=True)
                                   .expand_as(out[1]), rtol=1e-5, atol=1e-6)


def test_mask_and_key_mask_together_raise():
    _, q, k, v, _ = _inputs(2, 16)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    mask = torch.ones((B, 1, 1, T), dtype=torch.bool)
    with pytest.raises(ValueError, match="either mask or key_mask"):
        fa.flash_attention(qt, kt, vt, mask=mask,
                           key_mask=torch.ones((B, T), dtype=torch.bool))
    with pytest.raises(ValueError, match="4D"):
        fa.flash_attention(qt, kt, vt, mask=mask[:, 0])


def test_long_sequence_declines_to_the_composed_math(caplog):
    """Past MAX_FUSED_LEN the JAX function computes the composed XLA
    attention; so does the port, with an engine note (rtol 1e-5)."""
    Tl = fa.MAX_FUSED_LEN + 16
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, Tl, 1, 4)).astype(np.float32)
               for _ in range(3))
    km = np.ones((1, Tl), bool)
    km[0, Tl - 100:] = False
    want = jax_flash(q, k, v, key_mask=jnp.asarray(km), causal=True)
    reset_seen()
    with caplog.at_level(logging.WARNING,
                         logger="sketchformer_tpu_torch.engines"):
        got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                                 key_mask=torch.from_numpy(km), causal=True)
    assert f"T={Tl} > fused limit" in caplog.text
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("H,Dh", [(2, 64), (4, 16)])
def test_bf16_forward_rounds_where_the_kernel_does(H, Dh):
    """bf16: the port's K8 forward equals the JAX kernel's to within one
    bf16 ulp of the output's largest value (the same rounding sites: f32
    scores scaled after the sum, the unnormalised e rounded, the division
    after); the composed formulation (q * scale in bf16, the normalised
    weights rounded) lies up to a few ulps away, in the port and in JAX
    alike, and no further than 4."""
    rng, q, k, v, _ = _inputs(H, Dh, seed=5)
    _, km, _ = _masks("key", rng)
    km[1, :5] = True
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tb = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)]
    want = np.asarray(jax_flash(*jb, key_mask=jnp.asarray(km), causal=True)
                      .astype(jnp.float32))
    full = km[:, None, None, :] & np.tril(np.ones((T, T), bool))[None, None]
    composed = np.asarray(jax_composed(*jb, mask=jnp.asarray(full))
                          .astype(jnp.float32))
    got = fa.flash_attention(*tb, key_mask=torch.from_numpy(km),
                             causal=True).float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp
    assert np.abs(got - composed).max() <= 4 * ulp


SMEM_LIMIT = 232448   # bytes of shared memory a block may opt into (H100)


@pytest.mark.parametrize("Dh", [8, 16, 32, 40, 64, 72, 128])
def test_backward_blocks_fit_shared_memory(Dh):
    """The bf16 backward's tiles do not grow with T; the f32 passes keep
    16 query rows' score and dp rows, T long: both fit up to T = 1024."""
    assert fa.flash_bwd_smem(Dh) <= SMEM_LIMIT
    for T in (1, 96, 192, 1000, fa.MAX_FUSED_LEN):
        assert fa.flash_bwd_f32_smem(T, T, Dh) <= SMEM_LIMIT
