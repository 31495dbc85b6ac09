"""The host side of the bf16 tensor-core kernels of K6's ``ce_fwd``,
``ce_dx`` and ``ce_dw``, of the stacks' products ``linear`` and
``linear_nt``, of the
attention forward (the stacks' ``attention_fwd``, K8's forward and the
serving ``encoder_attention``) and of the stacks' attention backward (K5):
their launch plans, the shapes they take, the vocab and row padding, and
the order in which ``ce_dw`` and K5 add their partials, on the CPU (no
launch)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


SM_SMEM = 233472       # shared memory of an SM (H100), 1 KB of it a block's


@pytest.mark.parametrize("dp,stages", [(64, 8), (128, 8), (192, 7),
                                       (256, 5)])
def test_ce_fwd_block_fits_shared_memory(dp, stages):
    """The x slab and as many W tiles (and their two barriers) as fit beside
    it: 5 at the train width (dp = 256), 230,488 bytes."""
    blocks, got, smem = tce.fwd_plan(49152, dp)
    assert (got, blocks) == (stages, 384)
    assert smem <= SMEM_LIMIT and stages >= 2
    assert smem == 1024 + 128 * dp * 2 + stages * dp * 128 + \
        (2 * stages + 1) * 8
    assert smem + dp * tce.TILE * 2 + 16 > SMEM_LIMIT or \
        stages == tce.FWD_STAGES_MAX


@pytest.mark.parametrize("M", [1, 9, 127, 128, 129, 1000, 49152, 98305])
def test_ce_fwd_blocks_cover_every_row_once(M):
    blocks = tce.fwd_plan(M, 256)[0]
    assert blocks * tce.DX_ROWS >= M > (blocks - 1) * tce.DX_ROWS


@pytest.mark.parametrize("N", [64, 192, 256, 512, 768])
@pytest.mark.parametrize("K", [256, 512])
def test_linear_block_fits_two_to_an_sm(N, K):
    """Three stages of a's 128 x 64 box and w's two 64 x 64 boxes and two
    tiles' bias: 101,424 bytes a block, whatever N and K are, so two blocks
    share an SM."""
    _, _, _, stages, _, smem = es.linear_plan(12288, N, K)
    assert (stages, smem) == (3, 101424) and smem <= SMEM_LIMIT
    assert es.LINEAR_BLOCKS_PER_SM * (smem + 1024) <= SM_SMEM


@pytest.mark.parametrize("M", [1, 127, 128, 129, 12288, 12293, 49152])
@pytest.mark.parametrize("N", [33, 64, 192, 256, 768])
def test_linear_blocks_cover_every_output_element_once(M, N):
    """The persistent blocks' tiles (block b: b, b + blocks, ...) cover the
    output once; two blocks an SM, or one a tile."""
    cols, rows, _, _, blocks, _ = es.linear_plan(M, N, 256)
    tiles = cols * rows
    assert blocks == min(tiles, 2 * 132)
    assert cols * es.LINEAR_TILE >= N > (cols - 1) * es.LINEAR_TILE
    assert rows * es.LINEAR_TILE >= M > (rows - 1) * es.LINEAR_TILE
    taken = np.zeros(tiles, dtype=np.int64)
    for b in range(blocks):
        taken[b::blocks] += 1
    assert (taken == 1).all()
    if M * N < 2 ** 22:
        seen = np.zeros((M, N), dtype=np.int8)
        for tile in range(tiles):
            r, c = divmod(tile, cols)
            seen[r * es.LINEAR_TILE:(r + 1) * es.LINEAR_TILE,
                 c * es.LINEAR_TILE:(c + 1) * es.LINEAR_TILE] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("M,N,K,tiles,slabs", [
    (12288, 768, 256, 576, 4), (12288, 256, 256, 192, 4),
    (12288, 512, 256, 384, 4), (12288, 256, 512, 192, 8),
    (49152, 256, 256, 768, 4), (49152, 768, 256, 2304, 4)])
def test_linear_tiles_at_the_main_path_shapes(M, N, K, tiles, slabs):
    """The stacks' four products at the sbir (M 12,288) and train (M
    49,152) shapes: 128 x 128 tiles, K in 64-deep slabs, 264 persistent
    blocks on 132 SMs (at N = 256 and M = 12,288 one a tile)."""
    cols, rows, got_slabs, _, blocks, _ = es.linear_plan(M, N, K)
    assert (cols * rows, got_slabs) == (tiles, slabs)
    assert blocks == min(tiles, 264)


@pytest.mark.parametrize("K,N", [(100, 70), (256, 33), (36, 256)])
def test_linear_operands_pad_to_whole_16_byte_rows(K, N):
    """bf16 a and w whose rows are not whole 16-byte vectors get zero
    columns (the wrapper's TMA pitch), which leave the product as it was:
    a's extra columns meet w's rows past K, which the TMA reads as zeros."""
    rng = np.random.default_rng(K + N)
    M = 40
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(torch.bfloat16)
    a, w, b = f(M, K), f(K, N), torch.from_numpy(
        rng.standard_normal(N).astype(np.float32))
    ap, a_pitch = es._tma_rows(a, 8)
    wp, w_pitch = es._tma_rows(w, 8)
    assert a_pitch % 8 == 0 and a_pitch - 8 < K <= a_pitch
    assert w_pitch % 8 == 0 and w_pitch - 8 < N <= w_pitch
    assert torch.equal(ap[:, :K], a) and not ap[:, K:].any()
    assert torch.equal(wp[:, :N], w) and not wp[:, N:].any()
    w_tma = torch.zeros(a_pitch, w_pitch, dtype=torch.bfloat16)
    w_tma[:K] = wp
    got = es.linear_reference(ap, w_tma, F.pad(b, (0, w_pitch - N)),
                              relu=True)[:, :N]
    assert torch.equal(got, es.linear_reference(a, w, b, relu=True))


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


@pytest.mark.parametrize("Dh,limit", [(16, 224), (32, 224), (48, 96),
                                      (64, 96), (96, 32), (128, 32)])
def test_attention_fwd_resident_keys_fit_their_budget(Dh, limit):
    """Under qk-norm the forward stages the head's whole K and V (each key
    normalised once a block) up to a key count set by RESIDENT_SMEM, and
    streams 32-key tiles above it and without qk-norm."""
    assert at.fwd_resident(limit, Dh, True) <= at.RESIDENT_SMEM
    assert at.fwd_resident(limit + 1, Dh, True) is None
    assert at.fwd_resident(limit, Dh, False) is None
    assert at.fwd_mma_plan(64, 192, limit, 8, Dh, qk_norm=True)[2] == \
        at.fwd_resident(limit, Dh, True)
    assert at.fwd_mma_plan(64, 192, limit + 1, 8, Dh, qk_norm=True)[2] == \
        at.fwd_mma_plan(64, 192, limit + 1, 8, Dh)[2]


@pytest.mark.parametrize("Dh", [16, 32, 48, 64, 80, 96, 112, 128])
def test_attention_bwd_mma_block_fits_shared_memory(Dh):
    """The two owned tiles (64 or 96 rows) and the double-buffered 32-row
    tiles of the swept side do not grow with T: 69,632 bytes at Dh = 128
    (64 rows), 46,080 at Dh = 64 with 96 rows."""
    (rows, _), _, smem, _ = at.bwd_mma_plan(1, 96, 1024, 1, Dh)
    assert rows == (96 if at.mma_head_dim(Dh) <= 64 else 64)
    assert smem[0] <= SMEM_LIMIT
    assert smem[0] == (2 * rows + 4 * 32) * (at.mma_head_dim(Dh) + 8) * 2


@pytest.mark.parametrize("T,rows", [(1, 64), (4, 64), (40, 64), (64, 64),
                                    (65, 96), (96, 96), (150, 64),
                                    (192, 64), (1000, 64), (1024, 64)])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_attention_bwd_owner_rows_leave_the_fewest_rows_past_t(T, rows, Dh):
    """96 owned rows a block where that computes fewer rows past T than 64
    and Dh <= 64, else 64 (ties included): at T = 96 one block a head with
    none past it, where 64-row blocks computed a quarter of their rows past
    T."""
    want = rows if Dh <= 64 else 64
    assert at.bwd_owner_rows(T, Dh) == want
    past = {r: -(-T // r) * r - T for r in (64, 96)}
    assert past[want] == min(past.values()) or Dh > 64


@pytest.mark.parametrize("Tq,Tk", [(1, 1), (1, 4), (40, 33), (63, 64),
                                   (64, 65), (96, 96), (192, 4), (192, 192),
                                   (1024, 1024)])
def test_attention_bwd_mma_grids_cover_every_row_once(Tq, Tk):
    """The dq pass owns every query row once, the dk / dv pass every key
    row once, each block 64 or 96 rows of one head of one batch
    element."""
    B, H = 5, 8
    plan_q, plan_kv, _, ws = at.bwd_mma_plan(B, Tq, Tk, H, 32)
    for (rows, grid), T in ((plan_q, Tq), (plan_kv, Tk)):
        assert grid[1:] == (H, B) and rows in (64, 96)
        seen = np.zeros(T, dtype=np.int64)
        for x in range(grid[0]):
            seen[x * rows:(x + 1) * rows] += 1
        assert (seen == 1).all()
    # a partial row pair a block and one a batch element
    blocks = max(plan_q[1][0], plan_kv[1][0]) * H * B
    assert ws == (blocks + B) * 2 * 32


def _pre_norm_grads(q, k, v, dout, bias, H, causal, qk_norm):
    """The plain backward's dq and dk ahead of the qk-norm backward, with
    the xhat of the rows they belong to, as (B, H, T, Dh)."""
    dt, scale, vh, (qn, qxh, _), (kn, kxh, _), s = at._recompute(
        q, k, v, bias, H, causal, qk_norm)
    p = torch.softmax(s, dim=-1)
    dp = at._heads(dout, H).to(dt).float() @ vh.float().transpose(-1, -2)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    return ((ds @ kn.float() * scale, qxh),
            (ds.transpose(-1, -2) @ qn.float() * scale, kxh))


@pytest.mark.parametrize("Tq,Tk,causal", [(150, 150, True), (96, 96, False),
                                          (70, 4, False)])
def test_attention_bwd_mma_norm_partials_sum_to_the_plain_gradients(
        Tq, Tk, causal):
    """The bf16 backward's qk-norm parameter gradients split as its plan
    splits them: each block's partial rows (dy * xhat and dy over its 64
    or 96 owned rows), the blocks of a batch element, then the B sums, add
    up (to 1e-4) to the plain version's gradients of both passes. This
    holds the plan's blocks to covering every row once; it does not pin
    the kernel's float order, whose re-runs the card tests hold
    bit-equal."""
    rng = np.random.default_rng(Tq + Tk)
    B, H, Dh = 3, 2, 32
    f32 = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(
        np.float32))
    q = f32(B, Tq, H * Dh).to(torch.bfloat16)
    k, v = (f32(B, Tk, H * Dh).to(torch.bfloat16) for _ in range(2))
    dout = f32(B, Tq, H * Dh)
    bias = torch.where(torch.arange(Tk)[None] < torch.tensor(
        [[Tk], [Tk // 2], [1]]), 0.0, at.NEG_INF)
    norms = (1 + 0.1 * f32(Dh), 0.1 * f32(Dh), 1 + 0.1 * f32(Dh),
             0.1 * f32(Dh))
    kw = dict(num_heads=H, causal=causal, qk_norm=norms)
    want_q = at.attention_bwd_q_reference(q, k, v, dout, bias, **kw)
    want_kv = at.attention_bwd_kv_reference(q, k, v, dout, bias, want_q[1],
                                            **kw)
    plan_q, plan_kv, _, _ = at.bwd_mma_plan(B, Tq, Tk, H, Dh)
    for (dy, xhat), (own, grid), want in zip(
            _pre_norm_grads(q, k, v, dout, bias, H, causal, norms),
            (plan_q, plan_kv), (want_q[2:], want_kv[2:])):
        sums = []
        for b in range(B):
            level1 = torch.zeros(2, Dh)
            for h in range(H):              # z = h * grid[0] + x
                for x in range(grid[0]):
                    rows = slice(x * own, (x + 1) * own)
                    level1 += torch.stack([
                        (dy[b, h, rows] * xhat[b, h, rows]).sum(dim=0),
                        dy[b, h, rows].sum(dim=0)])
            sums.append(level1)
        got = torch.zeros(2, Dh)
        for level1 in sums:
            got += level1
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("qk", [False, True], ids=["plain", "qk_norm"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_attention_is_the_stacks_forward_on_the_qkv_slices(
        qk, masked, dtype):
    """The two plain versions the bf16 route joins: ``encoder_attention``'s
    over a fused (B, T, 3 H Dh) pane equals the stacks' forward with the
    unnormalised exponentials rounded (norm_p false) on its q, k and v
    column slices, bit for bit."""
    rng = np.random.default_rng(int(qk) + 2 * int(masked))
    B, T, H, Dh = 3, 37, 4, 16
    HD = H * Dh
    qkv = torch.from_numpy(rng.standard_normal((B, T, 3 * HD)).astype(
        np.float32)).to(dtype)
    bias = None
    if masked:
        lengths = torch.tensor([[0], [T], [T - 9]])   # row 0: every key PAD
        bias = torch.where(torch.arange(T)[None] < lengths, 0.0, es.NEG_INF)
    norms = tuple(torch.from_numpy((rng.standard_normal(Dh) * 0.1 + (
        1.0 if i % 2 == 0 else 0.0)).astype(np.float32)) for i in range(4)) \
        if qk else None
    got = es.attention_reference(qkv, bias, num_heads=H, qk_norm=norms)
    want = at.attention_fwd_reference(
        qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:], bias,
        num_heads=H, qk_norm=norms, norm_p=False)
    assert torch.equal(got, want)
    before = dict(es.ROUTES)
    assert torch.equal(es.encoder_attention(qkv, bias, num_heads=H,
                                            qk_norm=norms), got)
    assert es.ROUTES == before       # a CPU tensor launches nothing
