"""The host side of the bf16 tensor-core kernels of K6's ``ce_dx`` and of
the attention forward (the stacks' ``attention_fwd`` and K8's forward):
their launch plans, the shapes they take, and the vocab padding, on the CPU
(no launch)."""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.ops import attention_train as at
from sketchformer_tpu_torch.ops import token_ce as tce

SMEM_LIMIT = 232448   # bytes of shared memory a block may opt into (H100)


@pytest.mark.parametrize("dp", [64, 128, 192, 256])
def test_ce_dx_block_fits_shared_memory(dp):
    """The x slab and the W ring of a 128-row block: 197,704 bytes at the
    train width (dp = 256)."""
    assert tce.dx_plan(49152, dp)[1] <= SMEM_LIMIT


@pytest.mark.parametrize("M", [1, 9, 127, 128, 129, 1000, 49152, 98305])
def test_ce_dx_blocks_cover_every_row_once(M):
    blocks = tce.dx_plan(M, 256)[0]
    assert blocks * tce.DX_ROWS >= M > (blocks - 1) * tce.DX_ROWS


@pytest.mark.parametrize("d,V", [(16, 7), (64, 64), (200, 2003),
                                 (256, 10004)])
def test_vocab_padding_keeps_columns_past_v_out(d, V):
    """W is padded to whole 64-column tiles with zero columns, x to whole
    64-column groups with zeros; walking the padded vocab tile by tile, as
    ``ce_dx`` does, with columns >= V excluded by index, gives the plain
    version's dl on the vocab, zero past it, and its dx."""
    rng = np.random.default_rng(d + V)
    M = 70
    x = torch.from_numpy(rng.standard_normal((M, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((d, V)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(V).astype(np.float32))
    tgt = torch.from_numpy(rng.integers(0, V, M).astype(np.int32))
    gll = torch.from_numpy(rng.standard_normal(M).astype(np.float32))
    xp, wp = tce.padded_operands(x, w)
    dp, Vp = wp.shape
    assert dp % tce.TILE == 0 and dp - tce.TILE < d <= dp
    assert Vp % tce.TILE == 0 and Vp - tce.TILE < V <= Vp
    assert torch.equal(wp[:d, :V], w) and not wp[d:].any() and \
        not wp[:, V:].any()
    assert torch.equal(xp[:, :d], x) and not xp[:, d:].any()
    lse = tce.token_ce_fwd_reference(x, w, b, tgt)[2]
    dx = torch.zeros(M, dp)
    dls = []
    for n0 in range(0, V, tce.TILE):
        n = torch.arange(n0, n0 + tce.TILE)
        inside = n < V
        bias = torch.where(inside, b[n.clamp(max=V - 1)], 0.0)
        p = torch.exp(xp @ wp[:, n0:n0 + tce.TILE] + bias - lse[:, None])
        hit = (n[None] == tgt[:, None].long()).float()
        dl = torch.where(inside, (hit - p) * gll[:, None], 0.0)
        dls.append(dl)
        dx += dl @ wp[:, n0:n0 + tce.TILE].t()
    dl = torch.cat(dls, dim=1)
    assert dl.shape == (M, Vp) and not dl[:, V:].any()
    l = x @ w + b
    want_dl = (torch.nn.functional.one_hot(tgt.long(), V).float()
               - torch.exp(l - lse[:, None])) * gll[:, None]
    torch.testing.assert_close(dl[:, :V], want_dl, rtol=1e-5, atol=1e-6)
    want = tce.token_ce_bwd_reference(x, w, b, tgt, lse, gll)[0]
    torch.testing.assert_close(dx[:, :d], want, rtol=1e-5, atol=1e-5)
    assert not dx[:, d:].any()


@pytest.mark.parametrize("Dh", [16, 32, 48, 64, 80, 96, 112, 128])
def test_attention_fwd_block_fits_shared_memory(Dh):
    """The 64-row query tile and the double-buffered 32-row K and V tiles do
    not grow with T: 52,224 bytes at Dh = 128."""
    assert at.fwd_mma_plan(1, 1024, 1024, 1, Dh)[2] <= SMEM_LIMIT


@pytest.mark.parametrize("Tq,Tk", [(1, 1), (1, 4), (40, 33), (63, 64),
                                   (64, 65), (65, 192), (192, 4), (96, 96),
                                   (1024, 1024)])
def test_attention_fwd_tiles_cover_every_row_and_key_once(Tq, Tk):
    (rows, H, B), key_tiles, _ = at.fwd_mma_plan(64, Tq, Tk, 8, 32)
    assert (H, B) == (8, 64)
    assert rows * at.MMA_ROWS >= Tq > (rows - 1) * at.MMA_ROWS
    assert key_tiles * at.MMA_KEYS >= Tk > (key_tiles - 1) * at.MMA_KEYS


@pytest.mark.parametrize("Dh,built", [(16, 32), (32, 32), (48, 64), (64, 64),
                                      (80, 128), (128, 128), (8, None),
                                      (40, None), (72, None), (144, None)])
def test_bf16_kernels_take_head_dims_in_multiples_of_16(Dh, built):
    if built is None:
        with pytest.raises(ValueError, match="multiple of 16"):
            at.mma_head_dim(Dh)
    else:
        assert at.mma_head_dim(Dh) == built


def test_bf16_rows_must_be_16_byte_aligned():
    """Slices of a fused pane at whole heads pass; a view that starts one
    element in, or has an odd row stride, raises."""
    pane = torch.zeros(2, 8, 3 * 64, dtype=torch.bfloat16)
    at.check_mma_rows(pane[..., :64], pane[..., 64:128], pane[..., 128:])
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.check_mma_rows(pane[..., 1:65])
    odd = torch.zeros(2, 8, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16-byte aligned"):
        at.check_mma_rows(odd)


def test_cpu_tensors_take_the_plain_version_at_any_head_dim():
    """Off the card the wrappers run the plain version, which takes a bf16
    head_dim the tensor-core kernel does not (no launch)."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 8, 2 * 40))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    before = at.LAUNCHES["attention_fwd"]
    got = at.attention_fwd(q, k, v, None, num_heads=2)
    assert at.LAUNCHES["attention_fwd"] == before
    assert torch.equal(got, at.attention_fwd_reference(q, k, v, None,
                                                       num_heads=2))
