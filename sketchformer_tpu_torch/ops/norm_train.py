"""LayerNorm backward and fixed-order row sums on hand-written kernels.

Kernels of ``csrc/norm_train.cu``, with a plain torch version beside each
wrapper (``*_reference``); a wrapper given CPU tensors runs the plain
version, given CUDA tensors it launches the kernel or raises. Each is one
launch a call whose blocks' partial rows are added in a fixed order in
that launch, so re-runs are bit-stable.

- :func:`layernorm_bwd`: the backward of the row LayerNorm (``_ln_bwd32``
  of ``sketchformer_tpu/ops/pallas_encoder_train.py``) plus the residual
  gradient, and the LayerNorm's parameter gradients summed in the same
  launch: its blocks write partial rows to the shared split scratch
  (``_build.split_scratch``) and the last block to finish adds them.
  :func:`ln_bwd_plan` sizes its grid to the card.
- :func:`sum_rows`: sum over rows in a fixed order (the f32 attention
  backward's qk-norm partial rows): :func:`sum_rows_plan` cuts the
  columns into narrow tiles and each tile's rows into the slices of one
  thread block cluster, whose first block adds the slices' partial rows
  from distributed shared memory. The bias gradients come with their
  weight gradients from ``encoder_stack.linear_tn``.
"""

from __future__ import annotations

from typing import Optional

import torch

from sketchformer_tpu_torch.models.layers import LN_EPS
from sketchformer_tpu_torch.ops import _build

LAUNCHES = {"layernorm_bwd": 0, "sum_rows": 0}
LN_MAX_WARPS = 16          # a block of layernorm_bwd (one an SM)
LN_RED_BYTES = 64 * 1024   # its warps' partial sums in shared memory, at most
LN_VECTOR_COLS = (4, 8)    # columns a lane held in registers (D = 32 * C)
SUM_CLUSTER = 8            # sum_rows' row slices a column tile (a cluster)
SUM_MIN_TILES = 8          # its column tiles, at least (lanes allowing)
SUM_BLOCK_BYTES = 256 * 1024   # the input a block reads, at most (idem)
SUM_ROWS_A_THREAD = 8      # past this, 32 warps a block instead of 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ln_bwd_plan(M: int, D: int, sms: int, aligned: bool = True):
    """(blocks, warps, cols, scratch) of one ``layernorm_bwd`` launch over
    M rows of width D on a card of ``sms`` SMs: at most one block of
    ``warps`` warps an SM (fewer warps when their partial sums, 2 x D f32
    each, would pass ``LN_RED_BYTES`` of shared memory); warp w of block b
    walks rows b * warps + w + k * blocks * warps. ``cols`` is each lane's
    share of a row held in registers (D = 32 * cols, every row operand
    16-byte ``aligned``), or 0: the kernel's column loop. ``scratch``: the
    f32 of split scratch it needs, one partial row (dscale's sums, then
    dbias's) a block."""
    warps = max(1, min(LN_MAX_WARPS, LN_RED_BYTES // (8 * D)))
    blocks = max(1, min(sms, -(-M // warps)))
    cols = D // 32 if aligned and D % 32 == 0 and \
        D // 32 in LN_VECTOR_COLS else 0
    return blocks, warps, cols, blocks * 2 * D


def sum_rows_plan(R: int, N: int, elem_bytes: int):
    """(lanes, tile, col_blocks, warps, cluster, rows_per_block) of one
    ``sum_rows`` launch over (R, N) rows of ``elem_bytes`` bytes: a row's
    columns go to tiles of ``lanes`` lanes of 16 bytes each (``tile``
    columns; the most lanes, a power of two up to 32, that still give
    ``SUM_MIN_TILES`` tiles and at most ``SUM_BLOCK_BYTES`` of input a
    block), so a warp reads G = 32 / lanes rows at once; each column tile
    is a cluster of ``cluster`` blocks of ``warps`` warps, block z the row
    slice [z * rows_per_block, ...), warp w reading its rows w * G,
    w * G + warps * G, ... (lane l the row l // lanes further); 32 warps
    when 16 would read more than ``SUM_ROWS_A_THREAD`` rows a thread."""
    V = 16 // elem_bytes
    cluster = SUM_CLUSTER
    lanes = 32
    while lanes > 1 and (-(-N // (lanes * V)) < SUM_MIN_TILES or
                         -(-R // cluster) * lanes * 16 > SUM_BLOCK_BYTES):
        lanes //= 2
    tile = lanes * V
    G = 32 // lanes
    warps = 16
    if -(-R // cluster) > warps * G * SUM_ROWS_A_THREAD:
        warps = 32
    cluster = max(1, min(cluster, -(-R // (warps * G))))
    return lanes, tile, -(-N // tile), warps, cluster, -(-R // cluster)


def ln_stats(x):
    """(xhat, rstd) of the row LayerNorm in f32, as the forward has them."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(dim=-1, keepdim=True) - mu * mu,
                      min=0.0)
    rstd = torch.rsqrt(var + LN_EPS)
    return (x32 - mu) * rstd, rstd


def ln_backward(dy, xhat, rstd, scale):
    """``_ln_bwd32``: dx (f32) and the (dscale, dbias) sums over every
    leading axis."""
    dxhat = dy * scale
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dxhat - m1 - xhat * m2)
    lead = tuple(range(dy.dim() - 1))
    return dx, (dy * xhat).sum(dim=lead), dy.sum(dim=lead)


def layernorm_bwd_reference(x, dy, scale, *, resid=None,
                            out_dtype=torch.float32):
    xhat, rstd = ln_stats(x)
    dx, ds, db = ln_backward(dy.float(), xhat, rstd, scale.float())
    if resid is not None:
        dx = resid.float() + dx
    return dx.to(out_dtype), ds, db


def sum_rows_reference(x):
    return x.float().sum(dim=0)


def layernorm_bwd(x, dy, scale, *, resid: Optional[torch.Tensor] = None,
                  out_dtype=torch.float32):
    """x (M, D) in the compute dtype (its LayerNorm is recomputed), dy (M, D)
    f32, scale (D,) f32, resid (M, D) f32 or compute dtype, added to dx.
    Returns (dx in ``out_dtype``, dscale (D,), dbias (D,)), all from one
    launch."""
    if x.device.type == "cpu":
        return layernorm_bwd_reference(x, dy, scale, resid=resid,
                                       out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_bwd: unsupported device {x.device}")
    code = _build.dtype_code(x)
    M, D = x.shape
    dev = x.device
    _build.require(x, "x", dev, x.dtype, (M, D))
    _build.require(dy, "dy", dev, torch.float32, (M, D))
    _build.require(scale, "scale", dev, torch.float32, (D,))
    resid_code = 0
    if resid is not None:
        if resid.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"layernorm_bwd: resid is {resid.dtype}")
        _build.require(resid, "resid", dev, resid.dtype, (M, D))
        resid_code = int(resid.dtype != torch.float32)
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"layernorm_bwd: out_dtype {out_dtype}")
    aligned = all(t is None or t.data_ptr() % 16 == 0
                  for t in (x, dy, scale, resid))
    blocks, warps, cols, scratch = ln_bwd_plan(M, D, _build.sm_count(dev),
                                               aligned)
    dx = torch.empty((M, D), dtype=out_dtype, device=dev)
    grads = torch.empty((2, D), dtype=torch.float32, device=dev)
    counter, ws = _build.split_scratch(dev, 1, scratch)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_layernorm_bwd(
            code, resid_code, int(out_dtype == torch.float32), _build.ptr(x),
            _build.ptr(dy), _build.ptr(scale), _build.ptr(resid),
            _build.ptr(dx), _build.ptr(grads), _build.ptr(ws),
            _build.ptr(counter), M, D, blocks, warps, cols, _build.stream(x))
    _build.check(err, "layernorm_bwd")
    LAUNCHES["layernorm_bwd"] += 1
    return dx, grads[0], grads[1]


def sum_rows(x):
    """(R, N) f32 or compute-dtype rows -> (N,) f32 sums, in one launch:
    a cluster of row slices a column tile, whose partial rows its first
    block adds in a fixed order."""
    if x.device.type == "cpu":
        return sum_rows_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"sum_rows: unsupported device {x.device}")
    R, N = x.shape
    dev = x.device
    in_code = 0 if x.dtype == torch.float32 else _build.dtype_code(x)
    _build.require(x, "x", dev, x.dtype, (R, N))
    lanes, tile, _, warps, cluster, rows = sum_rows_plan(R, N,
                                                         x.element_size())
    vec = int(N % (tile // lanes) == 0 and x.data_ptr() % 16 == 0)
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_sum_rows(in_code, _build.ptr(x), _build.ptr(out), R, N,
                              lanes, warps, cluster, rows, vec,
                              _build.stream(x))
    _build.check(err, "sum_rows")
    LAUNCHES["sum_rows"] += 1
    return out
