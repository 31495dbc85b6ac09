"""LayerNorm backward and fixed-order row sums on hand-written kernels.

Kernels of ``csrc/norm_train.cu``, with a plain torch version beside each
wrapper (``*_reference``); a wrapper given CPU tensors runs the plain
version, given CUDA tensors it launches the kernel or raises.

- :func:`layernorm_bwd`: the backward of the row LayerNorm (``_ln_bwd32``
  of ``sketchformer_tpu/ops/pallas_encoder_train.py``) plus the residual
  gradient, and the LayerNorm's parameter gradients.
- :func:`sum_rows`: sum over rows, optionally times a dropout mask: the
  bias gradients, and the second pass of every partial-row reduction.
"""

from __future__ import annotations

from typing import Optional

import torch

from sketchformer_tpu_torch.models.layers import LN_EPS
from sketchformer_tpu_torch.ops import _build
from sketchformer_tpu_torch.ops import dropout_prng as dp
from sketchformer_tpu_torch.ops.encoder_stack import dropout_mask

LAUNCHES = {"layernorm_bwd": 0, "sum_rows": 0}
LN_ROWS_PER_BLOCK = 64     # 8 warps x 8 rows (csrc/norm_train.cu)
SUM_ROWS_PER_SPLIT = 64    # sum_rows' row slice per block, at least


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def sum_rows_reference(x, *, drop=None, thresh=0, keep_scale=1.0):
    v = x.float()
    if drop is not None:
        v = v * dropout_mask(drop, thresh, keep_scale, v)
    return v.sum(dim=0)


def layernorm_bwd(x, dy, scale, *, resid: Optional[torch.Tensor] = None,
                  out_dtype=torch.float32):
    """x (M, D) in the compute dtype (its LayerNorm is recomputed), dy (M, D)
    f32, scale (D,) f32, resid (M, D) f32 or compute dtype, added to dx.
    Returns (dx in ``out_dtype``, dscale (D,), dbias (D,))."""
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
    blocks = -(-M // LN_ROWS_PER_BLOCK)
    dx = torch.empty((M, D), dtype=out_dtype, device=dev)
    parts = torch.empty((2, blocks, D), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_layernorm_bwd(
            code, resid_code, int(out_dtype == torch.float32), _build.ptr(x),
            _build.ptr(dy), _build.ptr(scale), _build.ptr(resid),
            _build.ptr(dx), _build.ptr(parts[0]), _build.ptr(parts[1]), M, D,
            _build.stream(x))
    _build.check(err, "layernorm_bwd")
    LAUNCHES["layernorm_bwd"] += 1
    sums = sum_rows(parts.transpose(0, 1).reshape(blocks, 2 * D))
    return dx, sums[:D], sums[D:]


def sum_rows(x, *, drop=None, thresh=0, keep_scale=1.0):
    """(R, N) f32 or compute-dtype rows -> (N,) f32 sums, each row times its
    dropout mask when ``drop`` (u8 (R, N) bytes, or a ``PrngSite`` drawn
    in-kernel) is given. Large R runs as
    parallel row slices whose partial rows a second launch adds."""
    if x.device.type == "cpu":
        return sum_rows_reference(x, drop=drop, thresh=thresh,
                                  keep_scale=keep_scale)
    if x.device.type != "cuda":
        raise ValueError(f"sum_rows: unsupported device {x.device}")
    R, N = x.shape
    dev = x.device
    in_code = 0 if x.dtype == torch.float32 else _build.dtype_code(x)
    _build.require(x, "x", dev, x.dtype, (R, N))
    dbytes, *prng = dp.kernel_args(drop, R, N, dev)
    col_blocks = -(-N // 32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # about eight blocks per SM: each warp walks its rows one load at a time
    splits = max(1, min(R // SUM_ROWS_PER_SPLIT, -(-8 * sms // col_blocks)))
    out = torch.empty((splits, N), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_sum_rows(in_code, _build.ptr(x), _build.ptr(dbytes),
                              *prng, int(thresh), float(keep_scale),
                              _build.ptr(out), R, N, splits, _build.stream(x))
    _build.check(err, "sum_rows")
    LAUNCHES["sum_rows"] += 1
    dp.note_launch(drop)
    if splits == 1:
        return out[0]
    return sum_rows(out)
