"""Pre-LN encoder stack forward on hand-written Hopper kernels.

Port of ``sketchformer_tpu/ops/pallas_encoder.py::fused_encoder_stack``
(body ``_stack_kernel``), the kernel that carries embedding extraction. The
TPU kernel runs all L layers in one call with the activations resident in
VMEM; on the card the layer runs as three kernels from
``csrc/encoder_stack.cu`` (see the note at the top of that file for why):

    linear             QKV, out-proj + x, FFN-in -> ReLU, FFN-out + x,
                       with an optional dropout epilogue (the training
                       stacks' forward)
    encoder_attention  optional qk-norm, key-masked softmax, P.V (in
                       bf16 on the tensor cores: the training stacks'
                       forward kernel of ``attention_train``, for head
                       widths that are a multiple of 16)
    layernorm_rows     LN1, LN2 and the final LayerNorm

and the two products of the training stacks' backward (``linear_nt``:
dX = dY . W^T, ``linear_tn``: dW = X^T . dY summed over every row). In
bf16 the three products are wgmma kernels fed by TMA, their tiles from
:func:`linear_plan`, :func:`nt_plan` and :func:`tn_plan`. A
dropout operand is a u8 byte tensor ('bits' mode) or a
``dropout_prng.PrngSite``, whose bytes the kernel draws itself ('prng'
mode; the plain versions materialise them with the plain Philox).

Each kernel has a wrapper here and a plain torch version beside it
(``*_reference``) that computes the same math in the same rounding order.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. ``encoder_stack_reference`` is the whole
stack on the plain versions; it is the oracle the CPU tests hold to the JAX
kernel and that ``chip_smoke.py`` holds the kernels to on the card.

The inference stack also runs on packed rows
(:func:`fused_encoder_stack_packed`): a padded (B, T) batch's valid rows,
gathered back to back (:class:`PackedRows`, built on the host by
:func:`pack_rows`), run the same layers with each sketch attending over its
own rows (:func:`ragged_attention`), and the result is scattered back into
a zero-filled (B, T, d) batch. No row that a valid row's output depends on
is left out, so each valid row's output is the padded stack's; the
padding's rows are not computed.

``LAUNCHES`` counts kernel launches per wrapper (only where a kernel is
actually launched), so a run can show that its path went through them;
``ROUTES`` counts which kernel ``encoder_attention`` and ``layernorm_rows``
launched, and which stack, padded or packed, ran on the card;
``RAGGED_ROUTES`` which kernel ``ragged_attention`` launched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sketchformer_tpu_torch.models.layers import layer_norm
from sketchformer_tpu_torch.ops import _build
from sketchformer_tpu_torch.ops import attention_train as at
from sketchformer_tpu_torch.ops import dropout_prng as dp
from sketchformer_tpu_torch.utils.engines import note_engine

NEG_INF = -1e9
MAX_FUSED_LEN = 1024    # the JAX engine's limit (pallas_encoder.py)
MAX_HEAD_DIM = 128      # encoder_attention's kernels keep head rows in
                        # registers

LAUNCHES = {"linear": 0, "encoder_attention": 0, "ragged_attention": 0,
            "layernorm_rows": 0, "linear_nt": 0, "linear_tn": 0}
# launches by kernel: encoder_attention's on the tensor cores' forward
# (bf16, head_dim a multiple of 16) or its own FMA kernel (f32, other bf16
# widths); layernorm_rows' on the persistent register plan
# (:func:`layernorm_rows_plan`) or, for a geometry the plan declines, on
# the one-warp-a-row kernel; the stacks: fused_encoder_stack ("padded") or
# fused_encoder_stack_packed ("packed")
ROUTES = {"mma": 0, "fma": 0, "ln_rows": 0, "ln_declined": 0, "padded": 0,
          "packed": 0}
# ragged_attention's launches by kernel (:func:`ragged_route`): the
# persistent walk over (sketch, head) items, or the grid of 64-row query
# blocks
RAGGED_ROUTES = {"persistent": 0, "tiles": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, RAGGED_ROUTES):
        for k in counts:
            counts[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def dropout_mask(drop, thresh, keep_scale, like):
    """f32 multiplier of the u8-threshold dropout of the (M, N) tensor
    ``like``: ``keep_scale`` where the byte is >= ``thresh``, else 0.
    ``drop`` is the (M, N) u8 bytes or a ``dropout_prng.PrngSite``, whose
    bytes the plain Philox draws."""
    M, N = like.shape
    drop = dp.as_bytes(drop, M, N, like.device)
    return torch.where(drop >= thresh, keep_scale, 0.0).float()


def linear_reference(a, w, bias, *, relu=False, residual=None, drop=None,
                     thresh=0, keep_scale=1.0):
    """``epilogue(a @ w)``: the product accumulates in f32 and is rounded to
    ``a.dtype`` before the (rounded) bias is added; then ReLU, then dropout
    (``drop`` u8 bytes of the output's shape or a ``PrngSite``: kept values
    times ``keep_scale``, rounded), then the residual."""
    dt = a.dtype
    y = torch.matmul(a, w).to(dt) + bias.to(dt)
    if relu:
        y = torch.relu(y)
    if drop is not None:
        y = (y.float() * dropout_mask(drop, thresh, keep_scale, y)).to(dt)
    if residual is not None:
        y = residual + y
    return y


def linear_nt_reference(a, w, *, drop=None, thresh=0, keep_scale=1.0,
                        gate=None, residual=None, out_dtype=torch.float32):
    """``a @ w^T`` (dX = dY . W^T): ``a`` (f32 or dt) times its dropout mask
    is rounded to ``w.dtype``; the f32 product is gated by ``gate > 0`` and
    returned in ``out_dtype``, or rounded to the compute dtype and added to
    ``residual`` (a running sum in the compute dtype)."""
    dt = w.dtype
    av = a.float()
    if drop is not None:
        av = av * dropout_mask(drop, thresh, keep_scale, av)
    y = torch.matmul(av.to(dt).float(), w.float().t())
    if gate is not None:
        y = torch.where(gate > 0, y, 0.0)
    if residual is not None:
        return residual + y.to(dt)
    return y.to(out_dtype)


def linear_tn_reference(x, y, *, drop=None, thresh=0, keep_scale=1.0,
                        bias_grad=False):
    """``x^T @ y`` over all rows (dW = X^T . dY) in f32; ``y`` times its
    dropout mask is rounded to ``x.dtype`` first. ``bias_grad``: also the
    f32 column sums of the masked ``y`` before that rounding (db, what
    ``sum_rows_reference`` gives), returned as (dW, db)."""
    yv = y.float()
    if drop is not None:
        yv = yv * dropout_mask(drop, thresh, keep_scale, yv)
    dw = torch.matmul(x.float().t(), yv.to(x.dtype).float())
    return (dw, yv.sum(dim=0)) if bias_grad else dw


def attention_reference(qkv, key_bias, *, num_heads, qk_norm=None):
    """Encoder self-attention over a (B, T, 3*H*Dh) fused qkv pane.

    ``qk_norm`` is ``(q_scale, q_bias, k_scale, k_bias)`` (each (Dh,),
    shared by every head) or None. Scores and softmax are f32; the
    unnormalised exponentials are rounded to the compute dtype for the
    P.V product, whose f32 result is divided by the f32 sum.
    """
    B, T, three_hd = qkv.shape
    dt = qkv.dtype
    HD = three_hd // 3
    H = num_heads
    Dh = HD // H

    def heads(x):   # (B, T, HD) -> (B, H, T, Dh)
        return x.reshape(B, T, H, Dh).transpose(1, 2)

    q, k, v = (heads(p) for p in qkv.split(HD, dim=-1))
    if qk_norm is not None:
        qs, qb, ks, kb = qk_norm
        q = layer_norm(q, qs, qb, dt)
        k = layer_norm(k, ks, kb, dt)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / Dh ** 0.5)
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    o = torch.matmul(e.to(dt).float(), v.float()) / denom
    return o.to(dt).transpose(1, 2).reshape(B, T, HD)


def ragged_attention_reference(qkv, rows, *, num_heads, qk_norm=None):
    """:func:`attention_reference` of each sketch's packed rows over its own
    rows, with no mask: the (M, 3*H*Dh) pane of every sketch's valid rows
    back to back, laid out by ``rows`` (:class:`PackedRows`)."""
    out = qkv.new_empty((qkv.shape[0], qkv.shape[1] // 3))
    for s, n in zip(rows.starts.tolist(), rows.lengths.tolist()):
        out[s:s + n] = attention_reference(qkv[None, s:s + n], None,
                                           num_heads=num_heads,
                                           qk_norm=qk_norm)[0]
    return out


def layernorm_rows_reference(x, scale, bias):
    return layer_norm(x, scale, bias, x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


LINEAR_TILE = 128         # bf16 linear: 128 x 128 output tiles
LINEAR_SLAB = 64          # contraction depth a stage (csrc: kLnSlab)
LINEAR_STAGES = 3
LINEAR_BLOCKS_PER_SM = 2  # the kernel's __launch_bounds__


def linear_plan(M, N, K, sms=132):
    """(column tiles, row tiles, K slabs, stages, blocks, shared-memory
    bytes a block) of a bf16 linear call, which launches with them: 128 x
    128 tiles of the (M, N) output, numbered row slab by row slab (the
    column tiles of a row slab neighbours); K streams through a ring of
    three 64-deep stages, each a's 128 x 64 box and w's two 64 x 64 boxes,
    small enough for two blocks an SM. The blocks are persistent, two an SM
    (or one a tile), block b taking tiles b, b + blocks, ..., so a block's
    next tile starts loading while it runs this one's epilogue. A block's
    shared memory: the stages, 1024 bytes to align the swizzle atoms, two
    barriers a stage and each consumer warpgroup's copy of two tiles' bias
    (f32); the launcher refuses a size below
    csrc/encoder_stack.cu::linear_smem_bytes."""
    cols, rows = -(-N // LINEAR_TILE), -(-M // LINEAR_TILE)
    smem = LINEAR_STAGES * ((LINEAR_TILE + 2 * LINEAR_SLAB) * 128 + 2 * 8) \
        + 1024 + 4 * LINEAR_TILE * 4
    return (cols, rows, -(-K // LINEAR_SLAB), LINEAR_STAGES,
            min(cols * rows, LINEAR_BLOCKS_PER_SM * sms), smem)


LN_ROWS_WARPS = 8          # a layernorm_rows block (csrc: kThreads / 32)
LN_ROWS_MAX_VECS = 2       # 16-byte vectors of a row a lane holds, at most
# resident blocks an SM by vectors a lane (1, 2): its __launch_bounds__
# (csrc: ln_rows_blocks_per_sm)
LN_ROWS_BLOCKS_PER_SM = (4, 2)


class LnRowsPlan(NamedTuple):
    """One ``layernorm_rows`` launch: ``blocks`` blocks of ``warps`` warps,
    a row held by ``lanes`` lanes of ``vecs`` 16-byte vectors each; ``vecs``
    0: declined, the one-warp-a-row kernel (``blocks`` blocks of 8 rows)."""
    blocks: int
    warps: int
    lanes: int
    vecs: int


def layernorm_rows_plan(M: int, D: int, dtype: torch.dtype, sms: int,
                        aligned: bool = True) -> LnRowsPlan:
    """The launch of a (M, D) LayerNorm on a card of ``sms`` SMs.

    A row of n = D / (16 / element size) whole 16-byte vectors (x and y
    16-byte ``aligned``) is held by ``lanes`` = the power of two at or above
    n, at most 32, lanes (a warp holds 32 / lanes rows at once: a group),
    lane l its vectors l, l + lanes, ..; at most ``LN_ROWS_MAX_VECS`` a
    lane. The grid is persistent: at most ``LN_ROWS_BLOCKS_PER_SM[vecs -
    1]`` blocks an SM, none without a group, warp w of block b walking the
    groups b * warps + w + k * blocks * warps. A D that is not whole
    vectors, a misaligned row or a D past 2 x 32 vectors is declined."""
    vw = 16 // (torch.finfo(dtype).bits // 8)
    n = D // vw
    if not aligned or D % vw or not 1 <= n <= 32 * LN_ROWS_MAX_VECS:
        return LnRowsPlan(-(-M // LN_ROWS_WARPS), LN_ROWS_WARPS, 32, 0)
    lanes = min(32, 1 << (n - 1).bit_length())
    vecs = -(-n // lanes)
    groups = -(-M // (32 // lanes))
    blocks = max(1, min(sms * LN_ROWS_BLOCKS_PER_SM[vecs - 1],
                        -(-groups // LN_ROWS_WARPS)))
    return LnRowsPlan(blocks, LN_ROWS_WARPS, lanes, vecs)


def linear(a, w, bias, *, relu=False, residual=None, drop=None, thresh=0,
           keep_scale=1.0):
    """(M, K) x (K, N) with the fused bias / ReLU / dropout / residual
    epilogue. In bf16, a and w whose rows are not whole 16-byte vectors (or
    whose base is not 16-byte aligned) get zero columns first, which add
    nothing to the product."""
    if a.device.type == "cpu":
        return linear_reference(a, w, bias, relu=relu, residual=residual,
                                drop=drop, thresh=thresh,
                                keep_scale=keep_scale)
    if a.device.type != "cuda":
        raise ValueError(f"linear: unsupported device {a.device}")
    code = _build.dtype_code(a)
    M, K = a.shape
    N = w.shape[-1]
    dev = a.device
    _build.require(a, "a", dev, a.dtype, (M, K))
    _build.require(w, "w", dev, a.dtype, (K, N))
    _build.require(bias, "bias", dev, torch.float32, (N,))
    if residual is not None:
        _build.require(residual, "residual", dev, a.dtype, (M, N))
    dbytes, *prng = dp.kernel_args(drop, M, N, dev)
    a_pitch, w_pitch, plan = K, N, (0,) * 6
    if a.dtype == torch.bfloat16:
        a, a_pitch = _tma_rows(a, 8)
        w, w_pitch = _tma_rows(w, 8)
        plan = linear_plan(M, N, K, _build.sm_count(dev))
    out = torch.empty((M, N), dtype=a.dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_linear(code, _build.ptr(a), _build.ptr(w),
                            _build.ptr(bias), _build.ptr(residual),
                            _build.ptr(dbytes), *prng, int(thresh),
                            float(keep_scale), _build.ptr(out), M, N, K,
                            a_pitch, w_pitch, *plan, int(relu),
                            _build.stream(a))
    _build.check(err, "linear")
    LAUNCHES["linear"] += 1
    dp.note_launch(drop)
    return out


NT_TILE = 128             # bf16 linear_nt: 128 x 128 output tiles
NT_SLAB = 64              # contraction columns a stage (csrc: kNtSlab)
# bf16 linear_nt's dynamic shared memory (csrc: kNtSmem): 3 stages of the
# bf16 A slab, W's rows, the raw rows of a (f32 at most) and their mask
# bytes, 1024 to align the swizzle atoms, 9 mbarriers
NT_SMEM = 3 * (4 * NT_TILE * 128 + NT_TILE * NT_SLAB) + 1024 + 9 * 8


def nt_plan(M, K):
    """(column tiles, row tiles, shared-memory bytes a block) of a bf16
    linear_nt call: one block a 128 x 128 tile of the (M, K) output, the
    column tiles of a row slab neighbours in the grid; the contraction
    streams through a fixed ring, whatever N is."""
    return -(-K // NT_TILE), -(-M // NT_TILE), NT_SMEM


def nt_operands(a, w, dbytes):
    """(a, w, mask bytes, pitch, d_pitch) as bf16 linear_nt's TMA boxes
    read them: a and w with one row pitch of whole 16-byte bf16 rows, the
    bytes with rows of a multiple of 16, all from 16-byte aligned bases;
    other shapes get zero columns, which add nothing to the product."""
    a, pitch = _tma_rows(a, 8)
    w, _ = _tma_rows(w, 8)
    d_pitch = a.shape[1]
    if dbytes is not None:
        dbytes, d_pitch = _tma_rows(dbytes, 16)
    return a, w, dbytes, pitch, d_pitch


def linear_nt(a, w, *, drop=None, thresh=0, keep_scale=1.0, gate=None,
              residual=None, out_dtype=torch.float32):
    """(M, N) x (K, N)^T -> (M, K): the input-gradient product of a layer's
    backward, with the dropout mask of ``a``'s site, the ReLU gate and the
    f32 or rounded output of :func:`linear_nt_reference`."""
    if a.device.type == "cpu":
        return linear_nt_reference(a, w, drop=drop, thresh=thresh,
                                   keep_scale=keep_scale, gate=gate,
                                   residual=residual, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"linear_nt: unsupported device {a.device}")
    code = _build.dtype_code(w)
    M, N = a.shape
    K = w.shape[0]
    dev = a.device
    if a.dtype not in (torch.float32, w.dtype):
        raise TypeError(f"linear_nt: a is {a.dtype}, expected float32 or "
                        f"{w.dtype}")
    if out_dtype not in (torch.float32, w.dtype):
        raise TypeError(f"linear_nt: out_dtype {out_dtype}")
    _build.require(a, "a", dev, a.dtype, (M, N))
    _build.require(w, "w", dev, w.dtype, (K, N))
    dbytes, *prng = dp.kernel_args(drop, M, N, dev)
    if gate is not None:
        _build.require(gate, "gate", dev, w.dtype, (M, K))
    if residual is not None:
        if out_dtype != w.dtype:
            raise ValueError("linear_nt: a residual needs out_dtype "
                             f"{w.dtype}")
        _build.require(residual, "residual", dev, w.dtype, (M, K))
    pitch = d_pitch = N
    if w.dtype == torch.bfloat16:
        a, w, dbytes, pitch, d_pitch = nt_operands(a, w, dbytes)
    out = torch.empty((M, K), dtype=out_dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_linear_nt(
            code, int(a.dtype == torch.float32), _build.ptr(a), _build.ptr(w),
            pitch, _build.ptr(dbytes), d_pitch, *prng, int(thresh),
            float(keep_scale), _build.ptr(gate), _build.ptr(residual),
            int(out_dtype == torch.float32), _build.ptr(out), M, N, K,
            _build.stream(a))
    _build.check(err, "linear_nt")
    LAUNCHES["linear_nt"] += 1
    dp.note_launch(drop)
    return out


TN_SLAB = 64                 # linear_tn's split unit (csrc: kTnSlab)
TN_TILE = {torch.bfloat16: 128, torch.float32: 64}   # square output tiles
TN_SMEM = 3 * 9 * 64 * 64 * 2 + 1024 + 72 + 16      # bf16 (csrc: kTnSmem)


def tn_plan(M, K, N, dtype, sms=132):
    """(tiles, column tiles, splits, rows_per_split) of a linear_tn call:
    about one block a SM, each split a whole number of TN_SLAB rows."""
    tile = TN_TILE[dtype]
    cols = -(-N // tile)
    tiles = -(-K // tile) * cols
    slabs = max(1, -(-M // TN_SLAB))
    splits = max(1, min(slabs, -(-sms // tiles)))
    rps = -(-slabs // splits) * TN_SLAB
    return tiles, cols, -(-max(M, 1) // rps), rps


def _tma_rows(t, mult):
    """(t, its row pitch): the TMA boxes read rows of a multiple of 16
    bytes from a 16-byte aligned base; other shapes get zero columns."""
    n = t.shape[1]
    if n % mult == 0 and t.data_ptr() % 16 == 0:
        return t, n
    t = torch.nn.functional.pad(t, (0, (-n) % mult))
    return t, t.shape[1]


def linear_tn(x, y, *, drop=None, thresh=0, keep_scale=1.0, bias_grad=False):
    """(M, K)^T x (M, N) -> (K, N) f32 over all M rows: the weight-gradient
    product of a layer's backward; with ``bias_grad``, (dW, db) where db
    (N,) f32 sums the masked ``y`` before rounding. One launch: M is cut
    into slices whose partial tiles the last block of each tile adds in a
    fixed order."""
    if x.device.type == "cpu":
        return linear_tn_reference(x, y, drop=drop, thresh=thresh,
                                   keep_scale=keep_scale, bias_grad=bias_grad)
    if x.device.type != "cuda":
        raise ValueError(f"linear_tn: unsupported device {x.device}")
    code = _build.dtype_code(x)
    M, K = x.shape
    N = y.shape[1]
    dev = x.device
    if y.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"linear_tn: y is {y.dtype}")
    _build.require(x, "x", dev, x.dtype, (M, K))
    _build.require(y, "y", dev, y.dtype, (M, N))
    dbytes, *prng = dp.kernel_args(drop, M, N, dev)
    Kp, y_pitch, d_pitch = K, N, N
    if x.dtype == torch.bfloat16:
        x, Kp = _tma_rows(x, 8)
        y, y_pitch = _tma_rows(y, 16 // y.element_size())
        if dbytes is not None:
            dbytes, d_pitch = _tma_rows(dbytes, 16)
    tiles, cols, splits, rps = tn_plan(M, Kp, N, x.dtype,
                                       _build.sm_count(dev))
    tile = TN_TILE[x.dtype]
    out = torch.empty((Kp * N + (N if bias_grad else 0),),
                      dtype=torch.float32, device=dev)
    db = out[Kp * N:] if bias_grad else None
    out = out[:Kp * N].view(Kp, N)
    parts = tiles * splits * tile * tile
    counters, ws = _build.split_scratch(dev, tiles,
                                        parts + cols * splits * tile)
    ws_db = ws[parts:] if bias_grad else None
    with torch.cuda.device(dev):
        err = _build.library().sk_linear_tn(
            code, int(y.dtype == torch.float32), _build.ptr(x),
            _build.ptr(y), y_pitch, _build.ptr(dbytes), d_pitch, *prng,
            int(thresh), float(keep_scale), _build.ptr(out), _build.ptr(db),
            _build.ptr(ws), _build.ptr(ws_db), _build.ptr(counters), M, Kp,
            N, splits, rps, _build.stream(x))
    _build.check(err, "linear_tn")
    LAUNCHES["linear_tn"] += 1
    dp.note_launch(drop)
    dw = out if Kp == K else out[:K]
    return (dw, db) if bias_grad else dw


def encoder_attention(qkv, key_bias, *, num_heads, qk_norm=None):
    """Key-masked multi-head self-attention over a (B, T, 3*H*Dh) pane.

    A dispatch on dtype and shape: in bf16 with a head_dim that is a
    multiple of 16, the q, k and v column slices of the pane go to the
    training stacks' tensor-core forward with the unnormalised exponentials
    rounded (``attention_train.launch_fwd``, ``norm_p`` false: the same
    numerics as :func:`attention_reference`); f32, and bf16 head widths
    that kernel does not take, run this module's FMA kernel."""
    if qkv.device.type == "cpu":
        return attention_reference(qkv, key_bias, num_heads=num_heads,
                                   qk_norm=qk_norm)
    if qkv.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {qkv.device}")
    code = _build.dtype_code(qkv)
    B, T, three_hd = qkv.shape
    HD = three_hd // 3
    H = num_heads
    Dh = HD // H
    if three_hd != 3 * H * Dh:
        raise ValueError(f"qkv width {three_hd} is not 3 * {H} heads")
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh} outside the kernel's 1..{MAX_HEAD_DIM}")
    if T > MAX_FUSED_LEN:
        raise ValueError(f"T={T} exceeds the kernel's limit {MAX_FUSED_LEN}")
    dev = qkv.device
    _build.require(qkv, "qkv", dev, qkv.dtype, (B, T, three_hd))
    if key_bias is not None:
        _build.require(key_bias, "key_bias", dev, torch.float32, (B, T))
    norms = [None] * 4
    if qk_norm is not None:
        for p in qk_norm:
            _build.require(p, "qk-norm param", dev, torch.float32, (Dh,))
        norms = list(qk_norm)
    if qkv.dtype == torch.bfloat16 and Dh % 16 == 0:
        out = at.launch_fwd(qkv[..., :HD], qkv[..., HD:2 * HD],
                            qkv[..., 2 * HD:], key_bias, num_heads=H,
                            causal=False, qk_norm=qk_norm, norm_p=False)
        ROUTES["mma"] += 1
    else:
        out = torch.empty((B, T, HD), dtype=qkv.dtype, device=dev)
        lib = _build.library()
        with torch.cuda.device(dev):
            err = lib.sk_encoder_attention(
                code, _build.ptr(qkv), _build.ptr(key_bias),
                *(_build.ptr(p) for p in norms), _build.ptr(out), B, T, H,
                Dh, 1.0 / Dh ** 0.5, _build.stream(qkv))
        _build.check(err, "encoder_attention")
        ROUTES["fma"] += 1
    LAUNCHES["encoder_attention"] += 1
    return out


def ragged_declines(device: torch.device, dtype: torch.dtype,
                    head_dim: int) -> str:
    """Why :func:`ragged_attention`'s kernel cannot take sketches of this
    compute dtype and head width on ``device``, or "" where it can: a
    card, bf16, a head_dim that is a multiple of 16 up to
    ``MAX_HEAD_DIM``."""
    if device.type != "cuda":
        return f"{device.type}: the ragged attention kernel runs on a card"
    if dtype != torch.bfloat16:
        return f"{dtype}: the ragged attention kernel is bf16"
    if head_dim % 16 or not 0 < head_dim <= MAX_HEAD_DIM:
        return (f"head_dim {head_dim}: the ragged attention kernel takes a "
                f"multiple of 16 up to {MAX_HEAD_DIM}")
    return ""


RAGGED_STAGE_ROWS = 192   # the persistent kernel's stage (csrc: kRpRows)
RAGGED_HEAD_DIM = 32      # the persistent kernel's head width (csrc: kRpDh)


def ragged_route(T: int, head_dim: int, qk_norm: bool) -> Tuple[str, str]:
    """(route, why) of a :func:`ragged_attention` call whose longest sketch
    has ``T`` rows: ``"persistent"`` and "" where the persistent walk over
    (sketch, head) items takes it (head_dim ``RAGGED_HEAD_DIM``, no
    qk-norm, every sketch within a stage's ``RAGGED_STAGE_ROWS`` rows);
    else ``"tiles"``, the grid of 64-row query blocks, and why the
    persistent kernel declined. Both give the same bits."""
    if qk_norm:
        return "tiles", "qk-norm: the persistent kernel has none"
    if head_dim != RAGGED_HEAD_DIM:
        return "tiles", (f"head_dim {head_dim}: the persistent kernel is "
                         f"built for {RAGGED_HEAD_DIM}")
    if T > RAGGED_STAGE_ROWS:
        return "tiles", (f"a sketch longer than the persistent kernel's "
                         f"stage of {RAGGED_STAGE_ROWS} rows")
    return "persistent", ""


@functools.cache
def ragged_fit(device_index: int) -> Tuple[int, int]:
    """(SMs, resident blocks an SM of the persistent ragged kernel) of the
    card, by cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    n = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _build.check(_build.library().sk_ragged_fit(ctypes.byref(n)),
                     "ragged_fit")
    return _build.sm_count(torch.device("cuda", device_index)), n.value


def ragged_attention(qkv, rows, *, num_heads, qk_norm=None):
    """Each sketch's self-attention over its own packed rows: ``qkv`` the
    (M, 3*H*Dh) fused pane of every sketch's valid rows back to back, laid
    out by ``rows`` (:class:`PackedRows`); the output (M, H*Dh).

    On a card the kernel :func:`ragged_route` picks from the longest sketch
    (``rows.lengths``, on the host), the head width and qk-norm, noted at
    site ``ragged-attention`` (:func:`ragged_attention_on`). CPU tensors
    run :func:`ragged_attention_reference`."""
    if qkv.device.type == "cpu":
        return ragged_attention_reference(qkv, rows, num_heads=num_heads,
                                          qk_norm=qk_norm)
    route, why = ragged_route(int(rows.lengths.max()),
                              qkv.shape[-1] // 3 // num_heads,
                              qk_norm is not None)
    note_engine("ragged-attention", route, why)
    return ragged_attention_on(route, qkv, rows, num_heads=num_heads,
                               qk_norm=qk_norm)


def ragged_attention_on(route, qkv, rows, *, num_heads, qk_norm=None):
    """:func:`ragged_attention` on the kernel ``route`` names: the
    tensor-core forward of ``attention_train`` with the numerics of
    :func:`encoder_attention` (unnormalised exponentials rounded, the
    division after), each sketch reading its own keys in 32-key tiles from
    its first row, so a valid row's output is the padded call's bit for
    bit. ``"persistent"``: a grid of the card's resident blocks walks the
    (sketch, head) items of ``rows.items``, staging each item's q, K and V
    once; ``"tiles"``: a block a 64-row query block of ``rows.work``. What
    the kernel does not take (:func:`ragged_declines`, and for
    ``"persistent"`` :func:`ragged_route`) raises."""
    M, three_hd = qkv.shape
    H = num_heads
    HD = three_hd // 3
    Dh = HD // H
    if three_hd != 3 * H * Dh:
        raise ValueError(f"qkv width {three_hd} is not 3 * {H} heads")
    why = ragged_declines(qkv.device, qkv.dtype, Dh)
    if why:
        raise ValueError(f"ragged_attention: {why}")
    dev = qkv.device
    _build.require(qkv, "qkv", dev, qkv.dtype, (M, three_hd))
    if qkv.data_ptr() % 16:
        raise ValueError("ragged_attention: qkv must be 16-byte aligned")
    T = int(rows.lengths.max())
    if T > MAX_FUSED_LEN:
        raise ValueError(f"a sketch of {T} rows exceeds {MAX_FUSED_LEN}")
    norms = [None] * 4
    if qk_norm is not None:
        for p in qk_norm:
            _build.require(p, "qk-norm param", dev, torch.float32, (Dh,))
        norms = list(qk_norm)
    out = torch.empty((M, HD), dtype=qkv.dtype, device=dev)
    lib = _build.library()
    panes = (_build.ptr(qkv), _build.ptr(qkv[:, HD:]),
             _build.ptr(qkv[:, 2 * HD:]))
    if route == "persistent":
        why = ragged_route(T, Dh, qk_norm is not None)[1]
        if why:
            raise ValueError(f"ragged_attention: {why}")
        B = len(rows.lengths)
        _build.require(rows.items, "items", dev, torch.int32, (B, 2))
        sms, fit = ragged_fit(dev.index)
        grid = max(1, min(B * H, sms * fit))
        with torch.cuda.device(dev):
            err = lib.sk_attention_fwd_ragged_persistent(
                *panes, three_hd, _build.ptr(rows.items), B,
                _build.ptr(out), HD, T, H, Dh, 1.0 / Dh ** 0.5, grid,
                _build.stream(qkv))
    elif route == "tiles":
        W = rows.work.shape[0]
        _build.require(rows.work, "work", dev, torch.int32, (W, 3))
        resident = at.fwd_resident(T, Dh, qk_norm is not None) is not None
        with torch.cuda.device(dev):
            err = lib.sk_attention_fwd_ragged(
                panes[0], three_hd, panes[1], three_hd, panes[2], three_hd,
                *(_build.ptr(p) for p in norms), _build.ptr(rows.work), W,
                _build.ptr(out), HD, T, H, Dh, int(resident),
                1.0 / Dh ** 0.5, _build.stream(qkv))
    else:
        raise ValueError(f"ragged_attention: no route {route!r}")
    _build.check(err, "ragged_attention")
    LAUNCHES["ragged_attention"] += 1
    RAGGED_ROUTES[route] += 1
    return out


def layernorm_rows(x, scale, bias):
    """Row LayerNorm of a (M, D) tensor, output in ``x.dtype``, on the
    kernel :func:`layernorm_rows_plan` picks."""
    if x.device.type == "cpu":
        return layernorm_rows_reference(x, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm_rows: unsupported device {x.device}")
    code = _build.dtype_code(x)
    M, D = x.shape
    dev = x.device
    _build.require(x, "x", dev, x.dtype, (M, D))
    _build.require(scale, "scale", dev, torch.float32, (D,))
    _build.require(bias, "bias", dev, torch.float32, (D,))
    out = torch.empty_like(x)
    plan = layernorm_rows_plan(M, D, x.dtype, _build.sm_count(dev),
                               x.data_ptr() % 16 == 0 and
                               out.data_ptr() % 16 == 0)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_layernorm_rows(code, _build.ptr(x), _build.ptr(scale),
                                    _build.ptr(bias), _build.ptr(out), M, D,
                                    *plan, _build.stream(x))
    _build.check(err, "layernorm_rows")
    LAUNCHES["layernorm_rows"] += 1
    ROUTES["ln_rows" if plan.vecs else "ln_declined"] += 1
    return out


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def _layers(h, w, *, qk_norm, attend: Callable, lin: Callable,
            norm: Callable):
    """The L pre-LN layers and the final LayerNorm over the (R, d) rows
    ``h``; ``attend(qkv, norms)`` is the attention of the (R, 3*H*Dh) fused
    pane."""
    for i in range(w["wqkv"].shape[0]):
        qkv = lin(norm(h, w["ln1s"][i], w["ln1b"][i]), w["wqkv"][i],
                  w["bqkv"][i])
        norms = ((w["qns"][i], w["qnb"][i], w["kns"][i], w["knb"][i])
                 if qk_norm else None)
        h = lin(attend(qkv, norms), w["wo"][i], w["bo"][i], residual=h)
        f = lin(norm(h, w["ln2s"][i], w["ln2b"][i]), w["w1"][i], w["b1"][i],
                relu=True)
        h = lin(f, w["w2"][i], w["b2"][i], residual=h)
    return norm(h, w["lnfs"].reshape(-1), w["lnfb"].reshape(-1))


def _run_stack(x, key_mask, w, *, num_heads, qk_norm, lin: Callable,
               attn: Callable, norm: Callable):
    B, T, d = x.shape
    if T > MAX_FUSED_LEN:
        raise ValueError(f"T={T} exceeds fused limit {MAX_FUSED_LEN}")
    key_bias = None
    if key_mask is not None:
        key_bias = torch.where(
            key_mask.to(torch.bool),
            torch.zeros((), dtype=torch.float32, device=x.device),
            torch.full((), NEG_INF, dtype=torch.float32, device=x.device))

    def attend(qkv, norms):
        return attn(qkv.reshape(B, T, -1), key_bias, num_heads=num_heads,
                    qk_norm=norms).reshape(B * T, -1)

    y = _layers(x.contiguous().reshape(B * T, d), w, qk_norm=qk_norm,
                attend=attend, lin=lin, norm=norm)
    return y.reshape(B, T, d)


def _run_packed(x, rows, w, *, num_heads, qk_norm, lin: Callable,
                attn: Callable, norm: Callable):
    B, T, d = x.shape
    if T > MAX_FUSED_LEN:
        raise ValueError(f"T={T} exceeds fused limit {MAX_FUSED_LEN}")
    index = rows.index.long()
    h = x.contiguous().reshape(B * T, d).index_select(0, index)
    y = _layers(h, w, qk_norm=qk_norm, lin=lin, norm=norm,
                attend=lambda qkv, norms: attn(qkv, rows, num_heads=num_heads,
                                               qk_norm=norms))
    # zeros, not empty: the pooling's weights of masked rows are exact zeros,
    # and 0 x NaN would be NaN
    out = y.new_zeros((B * T, d))
    return out.index_copy_(0, index, y).reshape(B, T, d)


def fused_encoder_stack(x: torch.Tensor, key_mask: Optional[torch.Tensor],
                        w: Mapping[str, torch.Tensor], *, num_heads: int,
                        qk_norm: bool = False) -> torch.Tensor:
    """The full pre-LN encoder stack plus final LN, on the kernels.

    ``x`` (B, T, d) in the compute dtype; ``key_mask`` (B, T) bool, True =
    attend, or None; ``w`` from :func:`stack_encoder_weights`. CPU tensors
    run the plain versions (same result as :func:`encoder_stack_reference`).
    """
    if x.device.type == "cuda":
        ROUTES["padded"] += 1
    return _run_stack(x, key_mask, w, num_heads=num_heads, qk_norm=qk_norm,
                      lin=linear, attn=encoder_attention,
                      norm=layernorm_rows)


def encoder_stack_reference(x, key_mask, w, *, num_heads, qk_norm=False):
    """:func:`fused_encoder_stack` on the plain torch versions, any device."""
    return _run_stack(x, key_mask, w, num_heads=num_heads, qk_norm=qk_norm,
                      lin=linear_reference, attn=attention_reference,
                      norm=layernorm_rows_reference)


class PackedRows(NamedTuple):
    """Where a padded (B, T) batch's valid rows lie once packed back to
    back, sketch by sketch, in row-major order (:func:`pack_rows`).

    ``index`` (M,) int32: each packed row's flat position b * T + t in the
    padded batch; ``work`` (W, 3) int32: one row a 64-row query block of a
    sketch, (its first query row, the sketch's first row, the sketch's
    length) in packed rows, the work list of the ragged attention's
    ``"tiles"`` kernel; ``items`` (B, 2) int32: each sketch's (first row,
    length), longest first (ties in batch order), the walk of its
    ``"persistent"`` kernel, whose item i is head i % H of sketch i // H of
    this list. All three on the stack's device. ``starts`` and ``lengths``
    (B,) int64 numpy: each sketch's first packed row and number of rows,
    on the host."""
    index: torch.Tensor
    work: torch.Tensor
    items: torch.Tensor
    starts: np.ndarray
    lengths: np.ndarray

    def to(self, device) -> "PackedRows":
        """The same layout with its tensors on ``device``."""
        return self._replace(index=self.index.to(device),
                             work=self.work.to(device),
                             items=self.items.to(device))


def pack_rows(valid: np.ndarray) -> Tuple[Optional[PackedRows], str]:
    """The :class:`PackedRows` (CPU tensors) of a (B, T) bool host mask,
    True = a valid row, and ""; or None and why the packed stack would not
    give the padded stack's output: a sketch with no valid row (the padded
    stack attends over its masked keys, and pools them), or one whose valid
    rows are not the first of its positions (packed, its keys would sit in
    other tiles, and their sums run in another order)."""
    B, T = valid.shape
    # each sketch's first invalid position (T for none): its length, if no
    # valid position lies past it
    first = np.argmin(valid, axis=1)
    lengths = np.where(valid[np.arange(B), first], T, first)
    if np.count_nonzero(valid) != lengths.sum():
        return None, "a sketch whose valid positions are not a prefix"
    if not lengths.all():
        return None, "a sketch with no valid position"
    starts = np.cumsum(lengths) - lengths
    blocks = -(-lengths // at.MMA_ROWS)
    sketch = np.repeat(np.arange(B), blocks)
    nth = np.arange(len(sketch)) - np.repeat(np.cumsum(blocks) - blocks,
                                             blocks)
    s0 = starts[sketch]
    work = np.stack([s0 + at.MMA_ROWS * nth, s0, lengths[sketch]],
                    axis=1).astype(np.int32)
    order = np.argsort(-lengths, kind="stable")
    items = np.stack([starts[order], lengths[order]], axis=1).astype(np.int32)
    index = np.flatnonzero(valid).astype(np.int32)
    return PackedRows(torch.from_numpy(index), torch.from_numpy(work),
                      torch.from_numpy(items), starts, lengths), ""


def fused_encoder_stack_packed(x: torch.Tensor, rows: PackedRows,
                               w: Mapping[str, torch.Tensor], *,
                               num_heads: int,
                               qk_norm: bool = False) -> torch.Tensor:
    """:func:`fused_encoder_stack` of the valid rows alone: ``x`` (B, T, d)
    in the compute dtype, ``rows`` its valid rows (:func:`pack_rows`, its
    tensors on ``x``'s device). The rows are gathered, run through the
    layers with :func:`ragged_attention` and scattered back: (B, T, d) with
    each valid row the padded stack's and every other row zero. CPU tensors
    run the plain versions."""
    if x.device.type == "cuda":
        ROUTES["packed"] += 1
    return _run_packed(x, rows, w, num_heads=num_heads, qk_norm=qk_norm,
                       lin=linear, attn=ragged_attention, norm=layernorm_rows)


def encoder_stack_packed_reference(x, rows, w, *, num_heads, qk_norm=False):
    """:func:`fused_encoder_stack_packed` on the plain torch versions, any
    device."""
    return _run_packed(x, rows, w, num_heads=num_heads, qk_norm=qk_norm,
                       lin=linear_reference, attn=ragged_attention_reference,
                       norm=layernorm_rows_reference)


def stack_encoder_weights(enc_state: Mapping[str, torch.Tensor], *,
                          num_layers: int, compute_dtype: torch.dtype,
                          grad: bool = False) -> dict:
    """Encoder ``state_dict`` (keys ``layer_{i}.…``, ``ln_out.…``) ->
    stacked kernel operands, as the JAX ``stack_encoder_weights`` builds
    them: products' weights (L, ...) in the compute dtype, LN params and
    biases f32, ``lnfs``/``lnfb`` shaped (1, d). ``grad=True`` keeps the
    autograd graph back to the parameters (pass
    ``state_dict(keep_vars=True)``), so a training stack's weight gradients
    reach them; otherwise the operands are detached."""
    f32 = torch.float32

    def leaf(t):
        return t if grad else t.detach()

    def stk(suffix, dtype, shape=None):
        arrs = [enc_state[f"layer_{i}.{suffix}"] for i in range(num_layers)]
        out = torch.stack([leaf(a).to(dtype) for a in arrs])
        return out if shape is None else out.reshape(num_layers, *shape)

    d = enc_state["layer_0.ln1.scale"].shape[0]
    qkv_k, qkv_b = [], []
    for i in range(num_layers):
        p = f"layer_{i}.self_attn."
        qkv_k.append(torch.cat(
            [enc_state[p + n + ".kernel"].reshape(d, -1)
             for n in ("query", "key", "value")], dim=-1))
        qkv_b.append(torch.cat(
            [enc_state[p + n + ".bias"].reshape(-1)
             for n in ("query", "key", "value")], dim=-1))
    w = {
        "ln1s": stk("ln1.scale", f32),
        "ln1b": stk("ln1.bias", f32),
        "wqkv": leaf(torch.stack(qkv_k)).to(compute_dtype).contiguous(),
        "bqkv": leaf(torch.stack(qkv_b)).to(f32).contiguous(),
        "wo": stk("self_attn.out.kernel", compute_dtype, (-1, d)).contiguous(),
        "bo": stk("self_attn.out.bias", f32),
        "ln2s": stk("ln2.scale", f32),
        "ln2b": stk("ln2.bias", f32),
        "w1": stk("ffn.in.kernel", compute_dtype),
        "b1": stk("ffn.in.bias", f32),
        "w2": stk("ffn.out.kernel", compute_dtype),
        "b2": stk("ffn.out.bias", f32),
    }
    if "layer_0.self_attn.q_norm.scale" in enc_state:
        for key, name in (("qns", "q_norm.scale"), ("qnb", "q_norm.bias"),
                          ("kns", "k_norm.scale"), ("knb", "k_norm.bias")):
            w[key] = stk(f"self_attn.{name}", f32)
    else:
        # unused (L, head_dim) panes, as in the JAX dict
        head_dim = enc_state["layer_0.self_attn.query.kernel"].shape[-1]
        dev = w["ln1s"].device
        for key, fill in (("qns", 1.0), ("qnb", 0.0), ("kns", 1.0),
                          ("knb", 0.0)):
            w[key] = torch.full((num_layers, head_dim), fill, dtype=f32,
                                device=dev)
    w["lnfs"] = leaf(enc_state["ln_out.scale"]).to(f32).reshape(1, d)
    w["lnfb"] = leaf(enc_state["ln_out.bias"]).to(f32).reshape(1, d)
    return w
