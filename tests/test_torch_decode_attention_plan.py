"""The host side of K12 ``decode_attention`` (``ops/decode_attention.py``,
``csrc/decode_attention.cu``): its launch plan, on the CPU (no launch), and
a plain emulation of the bulk kernel's split softmax.

The plan gives a block ``rows`` folded rows, each split over ``splits``
warps of ``span`` consecutive cache positions whose k and v spans land by
bulk copies; these tests hold it to covering every row and every filled
position once, to threads and shared memory within a block's limits, to
at least one block an SM at the decode's B*H = 512, and to declining the
geometries the bulk copies and vectors cannot take. The emulation computes
each split's (max, sum, e.v) and merges them as the kernel does; it is held
to ``decode_attention_reference`` for every split the plan picks, and to
JAX ``pallas_decode.decode_attention`` (interpret mode) at small sizes.
The card tests hold the kernel itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sketchformer_tpu.ops.pallas_decode import decode_attention as jax_attn
from sketchformer_tpu_torch.ops import decode_attention as da
from torch_port_util import ATOL, RTOL

SMS = 132                 # H100 SXM
SMEM_LIMIT = 232448       # bytes of shared memory a block may opt into
DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]
# (B*H, Tmax, Dh): the decode's H=8 / 4 / 2 at B=64, a B*H that is not a
# multiple of the rows a block, a batch below the SM count, a long cache
GEOMETRIES = [(512, 192, 32), (256, 192, 64), (128, 192, 128),
              (511, 192, 32), (40, 33, 32), (8, 1024, 64)]


def _lens(Tmax):
    return sorted(n for n in {1, 2, 15, 16, 17, 31, 33, Tmax // 2, Tmax - 1,
                              Tmax} if 1 <= n <= Tmax)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("BH,Tmax,Dh", GEOMETRIES)
def test_plan_covers_every_row_and_position_once(BH, Tmax, Dh, dtype):
    """For every cache_len a decode passes: each row in one block, each
    filled position in one split of its row (no split empty), a block of at
    most 8 warps and at most SMEM_LIMIT bytes, the size the kernel asks
    for."""
    esize = torch.finfo(dtype).bits // 8
    for n in _lens(Tmax):
        p = da.decode_attention_plan(BH, Tmax, Dh, n, dtype, SMS)
        if p.rows == 0:       # only a row past shared memory is declined
            assert da.bulk_smem_bytes(1, 1, n, Dh, esize) > SMEM_LIMIT
            continue
        assert 1 <= p.rows * p.splits <= da.BULK_WARPS
        assert 1 <= p.splits <= da.MAX_SPLITS
        assert p.blocks == -(-BH // p.rows)
        rows = np.zeros(BH, dtype=np.int64)
        for b in range(p.blocks):
            rows[b * p.rows:min(BH, (b + 1) * p.rows)] += 1
        assert (rows == 1).all()
        seen = np.zeros(n, dtype=np.int64)
        for s in range(p.splits):
            span = range(s * p.span, min(n, (s + 1) * p.span))
            assert len(span) > 0
            seen[span.start:span.stop] += 1
        assert (seen == 1).all()
        assert p.smem == da.bulk_smem_bytes(p.rows, p.splits, p.span, Dh,
                                            esize) <= SMEM_LIMIT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 31, 96, 191, 192])
def test_decode_geometry_gives_every_sm_a_block(n, dtype):
    """At the decode's B*H = 512, Dh = 32 every SM gets a block, and all of
    them are resident at once (by threads, 2,048 an SM, and by shared
    memory, 228 KB an SM with 1 KB reserved a block); a B*H of four
    one-row blocks an SM and more takes several rows a block."""
    p = da.decode_attention_plan(512, 192, 32, n, dtype, SMS)
    assert p.rows > 0 and p.blocks >= SMS
    big = da.decode_attention_plan(8 * da.ROW_BLOCKS * SMS, 192, 32, n,
                                   dtype, SMS)
    assert big.rows == da.BULK_WARPS // big.splits
    per_sm = min(2048 // (32 * p.rows * p.splits),
                 228 * 1024 // (p.smem + 1024))
    assert p.blocks <= SMS * per_sm


@pytest.mark.parametrize("Dh,dtype,aligned", [
    (24, torch.bfloat16, True),     # three 16-byte vectors: no power of two
    (24, torch.float32, True),      # six
    (48, torch.bfloat16, True),
    (20, torch.bfloat16, True),     # no whole vectors
    (32, torch.bfloat16, False),    # a misaligned operand
    (128, torch.float32, True),     # 1 MB of k and v a row at cache_len 1024
])
def test_plan_declines_what_the_bulk_kernel_cannot_take(Dh, dtype, aligned):
    p = da.decode_attention_plan(64, 1024, Dh, 1024, dtype, SMS, aligned)
    assert p.rows == 0 and p.blocks == -(-64 // 8)


def split_merge(q, k, v, cache_len, splits, span):
    """The bulk kernel's softmax in plain f32: split s takes positions
    [s * span, min(len, (s + 1) * span)) and keeps its max m_s, sum l_s of
    e = exp(score - m_s) and o_s = e . v; the splits are merged in order,
    each rescaled by exp(m_s - M) (M the row's max), and the merged o is
    divided by the merged sum once."""
    Dh = q.shape[-1]
    qf, kf, vf = q.float(), k.float(), v.float()
    parts = []
    for s in range(splits):
        lo, hi = s * span, min(cache_len, (s + 1) * span)
        sc = torch.matmul(qf, kf[:, lo:hi].transpose(1, 2)) * (1.0 / Dh ** 0.5)
        m = sc.amax(dim=-1, keepdim=True)
        e = torch.exp(sc - m)
        parts.append((m, e.sum(dim=-1, keepdim=True),
                      torch.matmul(e, vf[:, lo:hi])))
    mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    total = torch.zeros_like(mx)
    o = torch.zeros_like(parts[0][2])
    for m, l, os_ in parts:
        w = torch.exp(m - mx)
        total = total + l * w
        o = o + os_ * w
    return (o / total).to(q.dtype)


def _draw(rng, BH, Tmax, Dh, scale=1.0):
    q = rng.standard_normal((BH, 1, Dh)).astype(np.float32) * scale
    k, v = (rng.standard_normal((BH, Tmax, Dh)).astype(np.float32)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("Dh,scale", [(32, 1.0), (64, 4.0), (128, 1.0)])
def test_split_merge_equals_the_plain_version(Dh, scale):
    """For every cache_len of a T=192 decode (so every split count and
    span the plan picks there, one to four splits), the emulated merge
    equals ``decode_attention_reference`` at f32 1e-6 (max error over max
    value); ``scale`` 4 sharpens the softmax, so the splits' maxima
    differ more."""
    rng = np.random.default_rng(Dh)
    BH, Tmax = 16, 192
    q, k, v = (torch.from_numpy(a) for a in _draw(rng, BH, Tmax, Dh, scale))
    picked = set()
    for n in range(1, Tmax + 1):
        p = da.decode_attention_plan(512, Tmax, Dh, n, torch.float32, SMS)
        picked.add(p.splits)
        got = split_merge(q, k, v, n, p.splits, p.span)
        want = da.decode_attention_reference(q, k, v, n)
        rel = (got - want).abs().max() / want.abs().max()
        assert rel <= 1e-6, (n, p, rel)
    assert picked == set(range(1, da.MAX_SPLITS + 1))


@pytest.mark.parametrize("Dh", [8, 32])
def test_split_merge_matches_jax_decode_attention(Dh):
    """The emulated merge against the JAX kernel (interpret mode) on the
    same inputs, at the plan's splits, in f32."""
    rng = np.random.default_rng(5 + Dh)
    BH, Tmax = 6, 40
    q, k, v = _draw(rng, BH, Tmax, Dh)
    for n in (1, 17, 33, Tmax):
        p = da.decode_attention_plan(BH, Tmax, Dh, n, torch.float32, SMS)
        assert p.rows > 0
        want = np.asarray(jax_attn(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.int32(n)))
        got = split_merge(*(torch.from_numpy(a) for a in (q, k, v)), n,
                          p.splits, p.span)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
