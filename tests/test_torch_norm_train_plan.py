"""The host side of ``layernorm_bwd`` and ``sum_rows`` (``ops/norm_train.py``,
``csrc/norm_train.cu``): their launch plans, on the CPU (no launch).

Each kernel is one launch whose blocks write partial rows (layernorm_bwd:
to the split scratch, its last block adding them; sum_rows: to shared
memory, block 0 of each cluster adding them); these tests hold the plans
to covering every row (and column) once, to room that holds every partial
row, and to a grouping whose sums, taken group by group in the plan's
order, give the plain gradients within f32 rounding. They do not pin the
kernels' float order: the card tests hold re-runs bit-equal.
"""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.ops import norm_train as nt

SMS = 132                 # H100 SXM
SMEM_LIMIT = 232448       # bytes of shared memory a block may opt into
LN_SHAPES = [(M, D) for M in (1, 63, 64, 6144, 12288, 49152)
             for D in (96, 128, 256)]
SUM_SHAPES = [(1, 1, 4), (63, 70, 4), (64, 64, 2), (6144, 64, 4),
              (12288, 768, 4), (9000, 256, 2), (49152, 300, 2)]


def _ln_warp_rows(M, blocks, warps):
    """{(block, warp): its rows, in the order the warp walks them}."""
    stride = blocks * warps
    return {(b, w): range(b * warps + w, M, stride)
            for b in range(blocks) for w in range(warps)}


def _sum_block_rows(R, cluster, rows, lanes, warps):
    """{(block, warp, row group): its rows, in order}: block z of a column
    tile's cluster reads the slice [z * rows, ...), a warp G = 32 / lanes
    rows at once, row group g the g-th of them."""
    G = 32 // lanes
    return {(z, w, g): range(z * rows + w * G + g, min(R, (z + 1) * rows),
                             warps * G)
            for z in range(cluster) for w in range(warps) for g in range(G)}


@pytest.mark.parametrize("M,D", LN_SHAPES)
def test_ln_bwd_plan_covers_every_row_once(M, D):
    """Every row of M is walked by exactly one warp; the grid is at most
    one block an SM, a block at most 512 threads, and D = 96 (no whole
    vector a lane) takes the column loop."""
    blocks, warps, cols, _ = nt.ln_bwd_plan(M, D, SMS)
    assert 1 <= blocks <= SMS and 1 <= warps * 32 <= 512
    seen = np.zeros(M, dtype=np.int64)
    for rows in _ln_warp_rows(M, blocks, warps).values():
        seen[rows.start:rows.stop:rows.step] += 1
    assert (seen == 1).all()
    assert cols == {96: 0, 128: 4, 256: 8}[D]
    assert nt.ln_bwd_plan(M, D, SMS, aligned=False)[2] == 0


@pytest.mark.parametrize("M,D", LN_SHAPES)
def test_ln_bwd_plan_scratch_holds_every_partial_row(M, D):
    """Block b writes its partial row (D sums of dy * xhat, then D of dy)
    at [b * 2D, (b + 1) * 2D) of the scratch the plan asks for, and the
    warps' sums fit the block's shared memory."""
    blocks, warps, _, scratch = nt.ln_bwd_plan(M, D, SMS)
    assert blocks * 2 * D <= scratch
    assert warps * 2 * D * 4 <= min(nt.LN_RED_BYTES, SMEM_LIMIT)


@pytest.mark.parametrize("M", [1, 63, 64, 300])
@pytest.mark.parametrize("D", [96, 128, 256])
def test_ln_bwd_plan_grouping_sums_to_plain_gradients(M, D):
    """dscale and dbias summed as the plan groups the rows (each warp's
    rows, the block's warps in order, then the blocks cut into the last
    block's parts of consecutive blocks, each part in order, the parts in
    order; a 4-SM card, on which at M = 300 a warp walks several rows)
    equal the plain version's to f32 rounding."""
    rng = np.random.default_rng(M + D)
    x = torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((M, D)).astype(np.float32))
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(D).astype(
        np.float32))
    _, want_s, want_b = nt.layernorm_bwd_reference(x, dy, scale)
    xhat, _ = nt.ln_stats(x)
    blocks, warps, _, _ = nt.ln_bwd_plan(M, D, 4)
    groups = _ln_warp_rows(M, blocks, warps)
    rows = []
    for b in range(blocks):
        block = torch.zeros(2, D)
        for w in range(warps):
            warp = torch.zeros(2, D)
            for r in groups[b, w]:
                warp += torch.stack([dy[r] * xhat[r], dy[r]])
            block += warp
        rows.append(block)
    parts = max(1, min(blocks, warps * 32 // (2 * D // 4),
                       warps * 2 * D // (2 * D)))
    got = torch.zeros(2, D)
    for k in range(parts):
        part = torch.zeros(2, D)
        for b in range(k * blocks // parts, (k + 1) * blocks // parts):
            part += rows[b]
        got += part
    for g, w in zip(got, (want_s, want_b)):
        assert torch.allclose(g, w, rtol=0, atol=1e-5 * w.abs().max() +
                              1e-6 * M)


@pytest.mark.parametrize("R,N,elem", SUM_SHAPES)
def test_sum_rows_plan_covers_every_element_once(R, N, elem):
    """Each (row, column) of x is read by exactly one lane of one block:
    each column by one lane of one column tile (``lanes`` lanes x 16
    bytes, a power of two up to 32), each row by one row group of one warp
    of one block of the tile's cluster (no block without rows). A tile
    narrower than 32 lanes leaves ``SUM_MIN_TILES`` tiles or keeps a
    block's input within ``SUM_BLOCK_BYTES``; the cluster is at most 8
    blocks (the portable size)."""
    lanes, tile, col_blocks, warps, cluster, rows = nt.sum_rows_plan(
        R, N, elem)
    V = 16 // elem
    assert lanes in (1, 2, 4, 8, 16, 32) and tile == lanes * V
    assert warps in (16, 32) and 1 <= cluster <= 8
    if lanes < 32:
        assert -(-N // (2 * tile)) < nt.SUM_MIN_TILES or \
            -(-R // nt.SUM_CLUSTER) * 2 * lanes * 16 > nt.SUM_BLOCK_BYTES
    assert (cluster - 1) * rows < R <= cluster * rows
    cols = np.zeros(col_blocks * tile, dtype=np.int64)
    for c in range(col_blocks):
        for lane in range(lanes):
            c0 = c * tile + lane * V
            cols[c0:c0 + V] += 1
    assert (cols[:N] == 1).all()
    rows_seen = np.zeros(R, dtype=np.int64)
    for got in _sum_block_rows(R, cluster, rows, lanes, warps).values():
        rows_seen[got.start:got.stop:got.step] += 1
    assert (rows_seen == 1).all()


@pytest.mark.parametrize("R,N,elem", SUM_SHAPES)
def test_sum_rows_plan_scratch_holds_every_partial_row(R, N, elem):
    """The partial rows live in shared memory: a block's warps' sums
    (warps x tile), its partial row (tile) and, in block 0, the cluster's
    gathered rows (cluster x tile) fit the 48 KB a block gets without
    opting in."""
    _, tile, _, warps, cluster, _ = nt.sum_rows_plan(R, N, elem)
    assert (warps + 1 + cluster) * tile * 4 <= 48 * 1024


@pytest.mark.parametrize("R,N,elem", [(600, 70, 4), (1300, 130, 4),
                                      (2100, 64, 2), (3000, 300, 2)])
def test_sum_rows_plan_grouping_sums_to_plain(R, N, elem):
    """Sums taken as the plan groups the rows (each row group's rows in
    order, a warp's row groups, the block's warps in order, then block 0
    adding the cluster's partial rows in order) equal the plain version's
    to f32 rounding."""
    rng = np.random.default_rng(R + N)
    x = torch.from_numpy(rng.standard_normal((R, N)).astype(np.float32))
    if elem == 2:
        x = x.to(torch.bfloat16)
    want = nt.sum_rows_reference(x)
    lanes, _, _, warps, cluster, rows = nt.sum_rows_plan(R, N, elem)
    assert cluster > 1
    groups = _sum_block_rows(R, cluster, rows, lanes, warps)
    got = torch.zeros(N)
    for z in range(cluster):
        block = torch.zeros(N)
        for w in range(warps):
            warp = torch.zeros(N)
            for g in range(32 // lanes):
                group = torch.zeros(N)
                for r in groups[z, w, g]:
                    group += x[r].float()
                warp += group
            block += warp
        got += block
    assert torch.allclose(got, want, rtol=0, atol=1e-5 * R)
