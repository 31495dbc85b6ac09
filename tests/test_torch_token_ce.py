"""The port's fused vocab-CE head (K6) against the JAX package on the CPU:
``ops/token_ce.py::token_ce_rows`` (its plain version, which a CPU tensor
runs) against ``sketchformer_tpu/ops/pallas_ce.py::token_ce_rows`` in
Pallas interpret mode, and ``TokenHead.fused_ce`` (both impls) against the
JAX head. Inputs are seeded numpy arrays handed to both. Tolerances are the
JAX tests' (tests/test_pallas_ce.py): values and gradients 2e-5 in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.models.heads import TokenHead as JaxTokenHead
from sketchformer_tpu.ops import pallas_ce
from sketchformer_tpu_torch.models.heads import TokenHead
from sketchformer_tpu_torch.ops import token_ce as tce


def _case(M, d, V, seed, x_dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, d)).astype(np.float32)
    w = (rng.standard_normal((d, V)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32)
    tgt = rng.integers(0, V, M).astype(np.int32)
    mask = (rng.random(M) > 0.25).astype(np.float32)
    return x, w, b, tgt, mask


def _jax_values_and_grads(x, w, b, tgt, mask, dtype=jnp.float32):
    def loss(xx, ww, bb):
        ll, _ = pallas_ce.token_ce_rows(xx, ww, bb, jnp.asarray(tgt))
        m = jnp.asarray(mask)
        return -(ll * m).sum() / jnp.maximum(m.sum(), 1.0)

    xj = jnp.asarray(x, dtype)
    ll, corr = pallas_ce.token_ce_rows(xj, jnp.asarray(w), jnp.asarray(b),
                                       jnp.asarray(tgt))
    grads = jax.grad(loss, argnums=(0, 1, 2))(xj, jnp.asarray(w),
                                              jnp.asarray(b))
    return ll, corr, grads


def _port_values_and_grads(x, w, b, tgt, mask, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    ll, corr = tce.token_ce_rows(xt, wt, bt, torch.from_numpy(tgt))
    m = torch.from_numpy(mask)
    (-(ll * m).sum() / torch.clamp(m.sum(), min=1.0)).backward()
    return ll, corr, (xt.grad, wt.grad, bt.grad)


@pytest.mark.parametrize("M,d,V", [(48, 32, 50), (37, 64, 131), (8, 16, 7)])
def test_token_ce_rows_matches_jax(M, d, V):
    """ll, corr and the x / W / b gradients of a masked mean, f32, 2e-5;
    V not a multiple of 128 (the JAX kernel pads it, the port does not)."""
    case = _case(M, d, V, M + V)
    jll, jcorr, jg = _jax_values_and_grads(*case)
    tce.reset_launches()
    pll, pcorr, pg = _port_values_and_grads(*case)
    np.testing.assert_allclose(pll.detach().numpy(), np.asarray(jll),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(pcorr.numpy(), np.asarray(jcorr))
    for got, want, name in zip(pg, jg, ("dx", "dW", "db")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
    assert tce.LAUNCHES == {"token_ce_fwd": 0, "token_ce_dx": 0,
                            "token_ce_dw": 0}


def test_token_ce_rows_bf16_semantics():
    """bf16 rows: the logits stay f32 (bf16 operands, f32 accumulation, f32
    bias), so ll matches the JAX kernel within 2e-6 and corr exactly; dx is
    bf16 (within one bf16 rounding of the JAX kernel's), dW / db f32; and
    ll sits within 0.02 of the composed head that rounds logits to bf16."""
    x, w, b, tgt, mask = _case(24, 32, 77, 7)
    jll, jcorr, jg = _jax_values_and_grads(x, w, b, tgt, mask, jnp.bfloat16)
    pll, pcorr, pg = _port_values_and_grads(x, w, b, tgt, mask,
                                            torch.bfloat16)
    np.testing.assert_allclose(pll.detach().numpy(), np.asarray(jll),
                               rtol=2e-6, atol=2e-6)
    np.testing.assert_array_equal(pcorr.numpy(), np.asarray(jcorr))
    assert pg[0].dtype == torch.bfloat16 and pg[1].dtype == torch.float32
    for got, want in zip(pg, jg):
        want = np.asarray(want, np.float32)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= 1e-2 * np.abs(want).max(), err
    # the composed flax rounding (dot and bias add in bf16)
    xb = torch.from_numpy(x).bfloat16()
    lbf = (xb @ torch.from_numpy(w).bfloat16()
           + torch.from_numpy(b).bfloat16()).float()
    llbf = lbf.gather(-1, torch.from_numpy(tgt).long()[:, None])[:, 0] \
        - torch.logsumexp(lbf, -1)
    np.testing.assert_allclose(pll.detach().numpy(), llbf.numpy(), atol=0.02)


def _heads(d, V, seed):
    rng = np.random.default_rng(seed)
    params = {"proj": {
        "kernel": (rng.standard_normal((d, V)) * 0.2).astype(np.float32),
        "bias": (rng.standard_normal(V) * 0.1).astype(np.float32)}}
    head = TokenHead(V, d)
    head.proj.kernel.data = torch.from_numpy(params["proj"]["kernel"])
    head.proj.bias.data = torch.from_numpy(params["proj"]["bias"])
    return params, head


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_fused_ce_matches_jax(impl):
    """TokenHead.fused_ce with row weights and an all-PAD row: loss and
    accuracy (rtol 2e-5) and the gradients of x, kernel and bias (rtol
    5e-4, atol 5e-5, the JAX test's) against the JAX head's same impl; and
    the port's two impls against each other."""
    B, T, d, V = 4, 12, 16, 37
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    ids = rng.integers(3, V, (B, T)).astype(np.int32)
    ids[:, -3:] = 0
    ids[2] = 0                                        # an all-PAD row
    rw = np.array([1.0, 0.0, 1.0, 1.0], np.float32)   # a duplicate row
    params, head = _heads(d, V, 4)

    def jloss(p, xx):
        return JaxTokenHead(V).apply({"params": p}, xx, jnp.asarray(ids),
                                     row_weights=jnp.asarray(rw), impl=impl,
                                     target_chunk=4,
                                     method=JaxTokenHead.fused_ce)

    (jl, ja), vjp = jax.vjp(jloss, params, jnp.asarray(x))
    jgp, jgx = vjp((jnp.float32(1.0), jnp.float32(0.0)))

    def port(which):
        xt = torch.from_numpy(x).requires_grad_(True)
        head.zero_grad()
        loss, acc = head.fused_ce(xt, torch.from_numpy(ids),
                                  row_weights=torch.from_numpy(rw),
                                  impl=which, target_chunk=4)
        loss.backward()
        return loss, acc, xt.grad, head.proj.kernel.grad.clone(), \
            head.proj.bias.grad.clone()

    got = port(impl)
    np.testing.assert_allclose(got[0].item(), float(jl), rtol=2e-5)
    np.testing.assert_allclose(got[1].item(), float(ja), rtol=2e-5)
    for g, w in ((got[2], jgx), (got[3], jgp["proj"]["kernel"]),
                 (got[4], jgp["proj"]["bias"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=5e-4,
                                   atol=5e-5)
    other = port("xla" if impl == "pallas" else "pallas")
    for g, w in zip(got, other):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(),
                                   rtol=2e-5, atol=1e-6)


def test_fused_ce_matches_full_logits_loss():
    """fused_ce (pallas) equals the full-logits token loss of the JAX
    package's train/loss.py on the head's logits."""
    from sketchformer_tpu.train.loss import token_reconstruction_loss
    B, T, d, V = 3, 10, 8, 21
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, T)).astype(np.int32)
    params, head = _heads(d, V, 6)
    logits = JaxTokenHead(V).apply({"params": params}, jnp.asarray(x))
    want = token_reconstruction_loss(logits, jnp.asarray(ids))
    with torch.no_grad():
        got = head.fused_ce(torch.from_numpy(x), torch.from_numpy(ids),
                            impl="pallas")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=2e-5)


def test_token_ce_wrappers_raise_on_other_devices():
    z = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tce.token_ce_fwd(z, torch.zeros(8, 5, device="meta"),
                         torch.zeros(5, device="meta"),
                         torch.zeros(4, dtype=torch.int32, device="meta"))
