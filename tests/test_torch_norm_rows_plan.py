"""The host side of ``layernorm_rows`` (``ops/encoder_stack.py``,
``csrc/encoder_stack.cu``): its launch plan, on the CPU (no launch), and
its plain version against the JAX kernels' ``_ln``.

The plan's persistent grid hands groups of rows (32 / lanes rows a warp) to
warps with a grid stride and a row's 16-byte vectors to lanes; these tests
hold it to covering every row and every vector once, to a grid within the
blocks an SM the kernel's launch bounds keep resident, and to declining
the geometries its registers cannot hold. A plain emulation of the
kernel's statistics (each lane's sums of its vectors, then the lanes of a
row added by an xor tree) is held to the plain version; the card tests
hold the kernel itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.ops.pallas_encoder import _ln
from sketchformer_tpu_torch.models.layers import LN_EPS
from sketchformer_tpu_torch.ops import encoder_stack as es
from torch_port_util import ATOL, RTOL

SMS = 132                 # H100 SXM
DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]
ROWS = (1, 7, 63, 64, 1001, 12288, 49152 + 3)
WIDTHS = (8, 24, 96, 128, 256, 384, 512)


def _vw(dtype):
    return 16 // (torch.finfo(dtype).bits // 8)


def _groups(M, plan):
    """{(block, warp): the rows of each group it walks, in order}."""
    per = 32 // plan.lanes
    stride = plan.blocks * plan.warps
    G = -(-M // per)
    return {(b, w): [[r for r in range(g * per, (g + 1) * per) if r < M]
                     for g in range(b * plan.warps + w, G, stride)]
            for b in range(plan.blocks) for w in range(plan.warps)}


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("D,dtype", [
    pytest.param(D, dt, id=f"{D}-{name}")
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16"))
    for D in WIDTHS if D // _vw(dt) <= 32 * es.LN_ROWS_MAX_VECS])
def test_plan_covers_every_row_and_vector_once(M, D, dtype):
    """Every row is in exactly one group of one warp, and every 16-byte
    vector of a row is held by exactly one lane; the grid stays within
    the blocks the kernel's launch bounds keep resident an SM
    (LN_ROWS_BLOCKS_PER_SM, by vectors a lane) and has no block without a
    group."""
    plan = es.layernorm_rows_plan(M, D, dtype, SMS)
    n = D // _vw(dtype)
    assert plan.vecs in (1, 2) and plan.warps == es.LN_ROWS_WARPS
    assert 1 <= plan.lanes <= 32 and plan.lanes & (plan.lanes - 1) == 0
    assert plan.lanes * plan.vecs >= n and plan.lanes < 2 * n
    held = sorted(li + c * plan.lanes for li in range(plan.lanes)
                  for c in range(plan.vecs) if li + c * plan.lanes < n)
    assert held == list(range(n))
    seen = np.zeros(M, dtype=np.int64)
    for groups in _groups(M, plan).values():
        for rows in groups:
            seen[rows] += 1
    assert (seen == 1).all()
    groups = -(-M // (32 // plan.lanes))
    assert 1 <= plan.blocks <= SMS * es.LN_ROWS_BLOCKS_PER_SM[plan.vecs - 1]
    assert (plan.blocks - 1) * plan.warps < groups


@pytest.mark.parametrize("M", [12288, 49152])
def test_main_path_rows_fill_the_card(M):
    """At the main paths' rows (bf16, D=256) a lane holds one vector of a
    row, every SM runs four blocks and each warp walks
    at least two rows, so its loads of the next are in flight."""
    plan = es.layernorm_rows_plan(M, 256, torch.bfloat16, SMS)
    assert (plan.lanes, plan.vecs) == (32, 1)
    assert plan.blocks == SMS * es.LN_ROWS_BLOCKS_PER_SM[0]
    assert M // (plan.blocks * plan.warps) >= 2


@pytest.mark.parametrize("M,D,dtype,aligned", [
    (301, 50, torch.float32, True),        # no whole 16-byte vectors
    (301, 50, torch.bfloat16, True),
    (300, 100, torch.bfloat16, True),
    (16, 512, torch.float32, True),        # 128 vectors: past the registers
    (16, 1024, torch.bfloat16, True),
    (12288, 256, torch.bfloat16, False),   # a misaligned row
])
def test_plan_declines_what_the_registers_cannot_hold(M, D, dtype, aligned):
    plan = es.layernorm_rows_plan(M, D, dtype, SMS, aligned)
    assert plan.vecs == 0
    assert plan.blocks == -(-M // 8)       # the one-warp-a-row kernel


def _emulate(x, scale, bias, plan):
    """The register plan's statistics in plain f32: lane li sums its
    vectors li, li + lanes, .. element by element, the row's lanes are
    added by an xor tree (offsets lanes / 2, .., 1), then _ln's formula."""
    M, D = x.shape
    vw = _vw(x.dtype)
    n = D // vw
    x32 = x.float().reshape(M, n, vw)
    lane_sum = torch.zeros(M, plan.lanes)
    lane_ss = torch.zeros(M, plan.lanes)
    for li in range(plan.lanes):
        for c in range(plan.vecs):
            v = li + c * plan.lanes
            for i in range(vw if v < n else 0):
                f = x32[:, v, i]
                lane_sum[:, li] += f
                lane_ss[:, li] += f * f
    o = plan.lanes // 2
    while o:
        idx = torch.arange(plan.lanes) ^ o
        lane_sum = lane_sum + lane_sum[:, idx]
        lane_ss = lane_ss + lane_ss[:, idx]
        o //= 2
    mu = lane_sum[:, :1] / D
    var = torch.clamp(lane_ss[:, :1] / D - mu * mu, min=0.0)
    rstd = 1.0 / torch.sqrt(var + LN_EPS)
    y = (x.float() - mu) * rstd * scale + bias
    return y.to(x.dtype)


def _rows(rng, M, D, near):
    """M rows of D: standard normal ones, and ``near`` near-constant ones
    (a value c in [0.5, 1) plus 0-3 of its f32 ulps per element), whose
    one-pass variance E[x^2] - mu^2 is rounding and often negative, so the
    clamp acts."""
    x = rng.standard_normal((M, D)).astype(np.float32)
    c = rng.uniform(0.5, 1.0, (near, 1)).astype(np.float32)
    x[:near] = c + rng.integers(0, 4, (near, D)) * np.spacing(c)
    return x, c


@pytest.mark.parametrize("D,dtype", [
    pytest.param(96, torch.float32, id="96-f32"),
    pytest.param(256, torch.float32, id="256-f32"),
    pytest.param(96, torch.bfloat16, id="96-bf16"),
    pytest.param(128, torch.bfloat16, id="128-bf16"),
    pytest.param(384, torch.bfloat16, id="384-bf16")])
def test_emulated_plan_statistics_equal_the_plain_version(D, dtype):
    rng = np.random.default_rng(D)
    x, _ = _rows(rng, 40, D, 0)
    xt = torch.from_numpy(x).to(dtype)
    s = torch.from_numpy(1 + 0.1 * rng.standard_normal(D).astype(np.float32))
    b = torch.from_numpy(0.1 * rng.standard_normal(D).astype(np.float32))
    got = _emulate(xt, s, b, es.layernorm_rows_plan(40, D, dtype, SMS))
    want = es.layernorm_rows_reference(xt, s, b)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    rel = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert rel <= tol, rel


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [96, 256])
def test_reference_matches_jax_ln(D, dtype):
    """``layernorm_rows_reference`` == JAX ``pallas_encoder._ln`` on the
    same rows and parameters: normal rows at the f32 tolerance of the
    port's tests (bf16: equal after the one rounding, up to one bf16 ulp);
    near-constant rows, where the variance clamp acts, within the error
    their conditioning allows: each mean is within (D - 1) * 2^-24 * max|x|
    of the exact one (a recursive sum's rounding bound; another summation
    order stays within it), x - mu is at most a few ulps of c, and both
    reach the output times rstd, at most 1 / sqrt(eps), times the scale."""
    rng = np.random.default_rng(7 + D)
    near = 24
    x, c = _rows(rng, 64, D, near)
    s = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32)
    xt = torch.from_numpy(x).to(dtype)
    x32 = xt.float()
    mu = x32.mean(-1, keepdim=True)
    assert ((x32 * x32).mean(-1, keepdim=True) - mu * mu)[:near].min() < 0 \
        or dtype == torch.bfloat16     # bf16 rounds them to constant rows
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(_ln(jnp.asarray(x32.numpy()).astype(jdt),
                          jnp.asarray(s)[None], jnp.asarray(b)[None], 0,
                          jdt).astype(jnp.float32))
    got = es.layernorm_rows_reference(xt, torch.from_numpy(s),
                                      torch.from_numpy(b)).float().numpy()
    if dtype == torch.bfloat16:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)
        return
    np.testing.assert_allclose(got[near:], want[near:], rtol=RTOL, atol=ATOL)
    dmu = 2 * (D - 1) * 2.0 ** -24 * np.abs(x[:near]).max(-1, keepdims=True)
    bound = (dmu + 4 * np.spacing(c)) / np.sqrt(LN_EPS) * np.abs(s).max()
    assert (np.abs(got[:near] - want[:near]) <= bound).all()
