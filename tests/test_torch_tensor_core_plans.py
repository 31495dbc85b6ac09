"""The host side of the bf16 tensor-core kernels of K6's ``ce_dx`` and
``ce_dw``, of the stacks' input-gradient product ``linear_nt`` and of the
attention forward (the stacks' ``attention_fwd`` and K8's forward): their
launch plans, the shapes they take, the vocab and row padding, and the
order in which ``ce_dw`` adds its split partials, on the CPU (no
launch)."""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.ops import attention_train as at
from sketchformer_tpu_torch.ops import encoder_stack as es
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


@pytest.mark.parametrize("dp,stages", [(64, 8), (128, 8), (192, 7),
                                       (256, 5)])
def test_ce_dw_block_fits_shared_memory(dp, stages):
    """The W tile, the ring of 64-row x slabs (5 at dp = 256), the two
    warpgroups' dl tiles and the db rows: 216,216 bytes at dp = 256; the
    ring also holds warpgroup 1's dW tile at the end."""
    got, smem = tce.dw_smem(dp)
    assert got == stages and smem <= SMEM_LIMIT
    assert stages * tce.TILE * dp * 2 >= dp * tce.TILE * 4


@pytest.mark.parametrize("M", [1, 63, 64, 65, 127, 128, 129, 12288, 49152,
                               98305])
def test_ce_dw_grid_covers_every_tile_and_row_once(M):
    """Each (vocab tile, M slice) block; the slices are whole 64-row slabs
    that cover the rows once, each one non-empty."""
    V = 10004
    tiles, splits, rps = tce.dw_plan(M, V)
    assert tiles * tce.TILE >= V > (tiles - 1) * tce.TILE
    assert rps % tce.TILE == 0 and 1 <= splits <= tce.DW_MAX_SPLITS
    covered = np.zeros(M, dtype=np.int64)
    for z in range(splits):
        lo, hi = z * rps, min(M, (z + 1) * rps)
        assert lo < hi
        covered[lo:hi] += 1
    assert (covered == 1).all()


def test_ce_dw_grid_fills_whole_waves_at_the_train_shape():
    """157 vocab tiles alone fill 1.19 waves of 132 SMs; 5 M slices make
    785 blocks, 5.95 waves."""
    tiles, splits, _ = tce.dw_plan(49152, 10004)
    blocks = tiles * splits
    assert (tiles, splits) == (157, 5)
    assert blocks / (-(-blocks // 132) * 132) > 0.99


@pytest.mark.parametrize("M,d,V", [(300, 64, 1000), (517, 256, 2003),
                                   (129, 192, 131)])
def test_ce_dw_split_partials_sum_to_the_plain_dw_and_db(M, d, V):
    """``ce_dw`` as the plan runs it, emulated in torch: per vocab tile and
    M slice, dl from the slice's recomputed logits (columns >= V excluded
    by index), the partial dW = x^T . round(dl) and db = the sum of the
    unrounded dl; the partials added in the order z = 0..S-1 give the plain
    version's dW and db within f32 rounding, and nothing past V."""
    rng = np.random.default_rng(M + d + V)
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    x = f32(M, d).to(torch.bfloat16)
    w, b = f32(d, V) * d ** -0.5, f32(V) * 0.1
    tgt = torch.from_numpy(rng.integers(0, V, M).astype(np.int32))
    gll = f32(M)
    lse = tce.token_ce_fwd_reference(x, w, b, tgt)[2]
    want = tce.token_ce_bwd_reference(x, w, b, tgt, lse, gll)
    xp, wp = tce.padded_operands(x, w)
    dp, Vp = wp.shape
    tiles, splits, rps = tce.dw_plan(M, V, sms=12)
    assert splits > 1
    dw, db = torch.zeros(dp, Vp), torch.zeros(Vp)
    for t in range(tiles):
        cols = slice(t * tce.TILE, (t + 1) * tce.TILE)
        n = torch.arange(cols.start, cols.stop)
        inside = n < V
        bias = torch.where(inside, b[n.clamp(max=V - 1)], 0.0)
        parts = []
        for z in range(splits):
            rows = slice(z * rps, min(M, (z + 1) * rps))
            xs = xp[rows].float()
            p = torch.exp(xs @ wp[:, cols].float() + bias - lse[rows, None])
            hit = (n[None] == tgt[rows, None].long()).float()
            dl = torch.where(inside, (hit - p) * gll[rows, None], 0.0)
            parts.append((xs.t() @ dl.to(torch.bfloat16).float(),
                          dl.sum(dim=0)))
        for pw, pb in parts:   # z = 0 .. S-1
            dw[:, cols] += pw
            db[cols] += pb
    assert not dw[:, V:].any() and not db[V:].any() and not dw[d:].any()
    torch.testing.assert_close(dw[:d, :V], want[1], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db[:V], want[2], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", [256, 512, 768])
@pytest.mark.parametrize("K", [256, 512])
def test_linear_nt_block_fits_shared_memory(N, K):
    """Three stages of the bf16 A slab, W's 128 rows, the raw f32 rows of
    a and their mask bytes: 222,280 bytes, whatever N and K are."""
    assert es.nt_plan(12288, K)[2] <= SMEM_LIMIT


@pytest.mark.parametrize("M", [1, 127, 128, 129, 12288, 49152, 49153])
@pytest.mark.parametrize("K", [8, 80, 256, 512, 520])
def test_linear_nt_grid_covers_every_output_element_once(M, K):
    cols, rows, _ = es.nt_plan(M, K)
    seen = np.zeros((M, K), dtype=np.int8) if M * K < 2 ** 22 else None
    assert cols * es.NT_TILE >= K > (cols - 1) * es.NT_TILE
    assert rows * es.NT_TILE >= M > (rows - 1) * es.NT_TILE
    if seen is not None:
        for r in range(rows):
            for c in range(cols):
                seen[r * es.NT_TILE:(r + 1) * es.NT_TILE,
                     c * es.NT_TILE:(c + 1) * es.NT_TILE] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("N,a_dtype", [(36, torch.float32),
                                       (96, torch.float32),
                                       (100, torch.bfloat16),
                                       (768, torch.bfloat16)])
def test_linear_nt_operands_pad_to_one_tma_pitch(N, a_dtype):
    """a and w share one pitch of whole 16-byte bf16 rows, the mask bytes
    rows of a multiple of 16; the zero columns leave the product and the
    masked values as they were."""
    rng = np.random.default_rng(N)
    M, K = 70, 40
    a = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)
                         ).to(a_dtype)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                         ).to(torch.bfloat16)
    byt = torch.from_numpy(rng.integers(0, 256, (M, N), dtype=np.uint8))
    ap, wp, bp, pitch, d_pitch = es.nt_operands(a, w, byt)
    assert pitch % 8 == 0 and pitch - 8 < N <= pitch
    assert d_pitch % 16 == 0 and d_pitch - 16 < N <= d_pitch
    assert ap.shape == (M, pitch) and wp.shape == (K, pitch)
    assert torch.equal(ap[:, :N], a) and not ap[:, N:].any()
    assert torch.equal(wp[:, :N], w) and not wp[:, N:].any()
    assert torch.equal(bp[:, :N], byt)
    kw = dict(thresh=26, keep_scale=1.11)
    torch.testing.assert_close(
        es.linear_nt_reference(ap, wp, drop=bp[:, :pitch], **kw),
        es.linear_nt_reference(a, w, drop=byt, **kw), rtol=1e-6, atol=1e-6)


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
