"""Attention of the training stacks on hand-written kernels.

Kernels of ``csrc/attention_train.cu`` (see the note at the top of that
file), with a plain torch version beside each wrapper (``*_reference``); a
wrapper given CPU tensors runs the plain version, given CUDA tensors it
launches the kernel or raises.

Every function takes ``q`` (B, Tq, H*Dh) and ``k``, ``v`` (B, Tk, H*Dh) in
the compute dtype, as views whose last axis is contiguous (slices of a
fused qkv or kv pane are fine), the pre-norm projections when ``qk_norm``
is given as ``(q_scale, q_bias, k_scale, k_bias)`` (each (Dh,) f32, shared
by the heads). ``key_bias`` is (B, Tk) f32, 0 to attend and -1e9 to mask;
``causal`` adds -1e9 above the diagonal (Tq == Tk).

- :func:`attention_fwd`: the output (B, Tq, H*Dh) in the compute dtype;
  ``norm_p`` rounds the normalised p before P.V (else the unnormalised e,
  dividing after). In bf16 it runs on the tensor cores (mma.sync, 64 query
  rows a block, two sweeps over 32-key tiles), which take a head_dim that
  is a multiple of 16 and 16-byte-aligned rows (:func:`mma_head_dim`); a
  bf16 call outside those raises.
- :func:`attention_bwd_q`: dq (B, Tq, H*Dh) f32 (through the qk-norm
  backward), the per-row statistics (B, H, Tq, 3) = (max, sum, delta) for
  the second pass, and the q-norm parameter gradients.
- :func:`attention_bwd_kv`: dk, dv (B, Tk, H*Dh) f32 and the k-norm
  parameter gradients.

``dout`` is (B, Tq, H*Dh) in f32 or the compute dtype (the kernels round it
to the compute dtype first, so both give the same gradients). In bf16 the
two backward passes run on the tensor cores too (mma.sync, 64 or 96 owned
rows a block, :func:`bwd_mma_plan`) and add their qk-norm parameter
gradients in the same launch; in f32 the FMA passes write per-block partial rows that
``norm_train.sum_rows`` adds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sketchformer_tpu_torch.models.layers import layer_norm
from sketchformer_tpu_torch.ops import _build
from sketchformer_tpu_torch.ops.norm_train import ln_backward, ln_stats

NEG_INF = -1e9
MAX_HEAD_DIM = 128
MAX_KEYS = 1024             # the f32 kernels keep a block's score rows in
                            # shared memory

LAUNCHES = {"attention_fwd": 0, "attention_bwd_q": 0, "attention_bwd_kv": 0}

# rows or key columns per block of the f32 kernels (csrc/attention_train.cu);
# the bf16 (tensor-core) kernels: owned rows a block and rows a swept tile
FWD_ROWS, BWD_Q_ROWS, BWD_KV_COLS = 32, 16, 32
MMA_ROWS, MMA_KEYS = 64, 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _heads(x, H):
    """(B, T, H*Dh) -> (B, H, T, Dh)."""
    B, T, HD = x.shape
    return x.reshape(B, T, H, HD // H).transpose(1, 2)


def _merge(x):
    """(B, H, T, Dh) -> (B, T, H*Dh)."""
    B, H, T, Dh = x.shape
    return x.transpose(1, 2).reshape(B, T, H * Dh)


def _scores(q, k, key_bias, causal, scale):
    """f32 (B, H, Tq, Tk) scores: (q . k) * scale + causal + key bias."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        Tq, Tk = s.shape[-2:]
        t = torch.arange(Tq, device=s.device)[:, None]
        j = torch.arange(Tk, device=s.device)[None, :]
        s = s + torch.where(j <= t, 0.0, NEG_INF)
    if key_bias is not None:
        s = s + key_bias[:, None, None, :]
    return s


def _normed(x, params, dt):
    """qk-norm of (B, H, T, Dh) heads, rounded to dt; also (xhat, rstd)."""
    if params is None:
        return x, None, None
    s, b = params
    xhat, rstd = ln_stats(x)
    return layer_norm(x, s, b, dt), xhat, rstd


def attention_fwd_reference(q, k, v, key_bias, *, num_heads, causal=False,
                            qk_norm=None, norm_p=True):
    dt = q.dtype
    H = num_heads
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)
    scale = 1.0 / (qh.shape[-1] ** 0.5)
    if qk_norm is not None:
        qh = _normed(qh, qk_norm[:2], dt)[0]
        kh = _normed(kh, qk_norm[2:], dt)[0]
    s = _scores(qh, kh, key_bias, causal, scale)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    if norm_p:
        o = torch.matmul((e / denom).to(dt).float(), vh.float())
    else:
        o = torch.matmul(e.to(dt).float(), vh.float()) / denom
    return _merge(o.to(dt))


def _recompute(q, k, v, key_bias, H, causal, qk_norm):
    dt = q.dtype
    qh, kh, vh = _heads(q, H), _heads(k, H), _heads(v, H)
    scale = 1.0 / (qh.shape[-1] ** 0.5)
    qn, qxh, qrs = _normed(qh, None if qk_norm is None else qk_norm[:2], dt)
    kn, kxh, krs = _normed(kh, None if qk_norm is None else qk_norm[2:], dt)
    s = _scores(qn, kn, key_bias, causal, scale)
    return dt, scale, vh, (qn, qxh, qrs), (kn, kxh, krs), s


def attention_bwd_q_reference(q, k, v, dout, key_bias, *, num_heads,
                              causal=False, qk_norm=None):
    H = num_heads
    dt, scale, vh, (qn, qxh, qrs), (kn, _, _), s = _recompute(
        q, k, v, key_bias, H, causal, qk_norm)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    p = e / l
    dp = torch.matmul(_heads(dout, H).to(dt).float(),
                      vh.float().transpose(-1, -2))
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta)).to(dt).float()
    dq = torch.matmul(ds, kn.float()) * scale
    dqs = dqb = None
    if qk_norm is not None:
        dq, dqs, dqb = ln_backward(dq, qxh, qrs, qk_norm[0])
    stats = torch.cat([m, l, delta], dim=-1)
    return _merge(dq), stats, dqs, dqb


def attention_bwd_kv_reference(q, k, v, dout, key_bias, stats, *, num_heads,
                               causal=False, qk_norm=None):
    H = num_heads
    dt, scale, vh, (qn, _, _), (kn, kxh, krs), s = _recompute(
        q, k, v, key_bias, H, causal, qk_norm)
    m, l, delta = (stats[..., i:i + 1] for i in range(3))
    p = torch.exp(s - m) / l
    do = _heads(dout, H).to(dt).float()
    dp = torch.matmul(do, vh.float().transpose(-1, -2))
    ds = (p * (dp - delta)).to(dt).float()
    dv = torch.matmul(p.to(dt).float().transpose(-1, -2), do)
    dk = torch.matmul(ds.transpose(-1, -2), qn.float()) * scale
    dks = dkb = None
    if qk_norm is not None:
        dk, dks, dkb = ln_backward(dk, kxh, krs, qk_norm[2])
    return _merge(dk), _merge(dv), dks, dkb


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def mma_head_dim(Dh: int) -> int:
    """The head width the bf16 tensor-core kernels are built for (32, 64
    or 128; the columns past Dh zero), or ValueError for a Dh they do not
    take (not a multiple of 16, or above 128)."""
    if Dh % 16 or not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh}: the bf16 kernel takes a multiple "
                         f"of 16 up to {MAX_HEAD_DIM}")
    return 32 if Dh <= 32 else 64 if Dh <= 64 else 128


def fwd_mma_plan(B: int, Tq: int, Tk: int, H: int, Dh: int,
                 qk_norm: bool = False):
    """(grid, key tiles, shared-memory bytes a block) of the bf16 forward
    (csrc/attention_train.cu::launch_fwd_mma_dh): a 64-row query tile and a
    double buffer of 32-row K and V tiles, rows padded by 8 elements; or,
    where :func:`fwd_resident` takes it, the head's whole K and V."""
    dhp = mma_head_dim(Dh)
    smem = fwd_resident(Tk, Dh, qk_norm) or \
        (MMA_ROWS + 4 * MMA_KEYS) * (dhp + 8) * 2
    return (-(-Tq // MMA_ROWS), H, B), -(-Tk // MMA_KEYS), smem


# shared memory of the bf16 forward's whole-head variant, at most (the
# kernel takes the choice from launch_fwd)
RESIDENT_SMEM = 40 * 1024


def fwd_resident(Tk: int, Dh: int, qk_norm: bool) -> Optional[int]:
    """Shared-memory bytes a block of the bf16 forward's whole-head variant
    takes (every key and value row of the head staged and normalised once,
    both sweeps from shared memory), or None where the forward streams its
    K / V tiles instead: without qk-norm, or when the head's K and V and the
    query tile exceed RESIDENT_SMEM."""
    smem = (MMA_ROWS + 2 * -(-Tk // MMA_KEYS) * MMA_KEYS) * \
        (mma_head_dim(Dh) + 8) * 2
    return smem if qk_norm and smem <= RESIDENT_SMEM else None


def bwd_owner_rows(T: int, Dh: int) -> int:
    """Rows a block of the bf16 backward owns along a side of length T: 96
    (6 warps of 16 rows) where that leaves fewer rows past T than 64 (4
    warps) and Dh <= 64, else 64 (the kernel is built for no other pair).
    Measured on an H100 (PERF.md): at T = 96, Dh = 32 96 rows took 9-16%
    less time; on a tie (T = 192) and at Dh = 128, whose registers fit one
    6-warp block an SM, 64 took less."""
    return 96 if -T % 96 < -T % 64 and mma_head_dim(Dh) <= 64 else 64


def bwd_mma_plan(B: int, Tq: int, Tk: int, H: int, Dh: int):
    """The bf16 backward's two launches (csrc/attention_train.cu::
    attention_bwd_mma_kernel): ((owned rows, grid) of the dq pass, (owned
    rows, grid) of the dk / dv pass, shared-memory bytes a block of each,
    f32 scratch of the qk-norm sums). A block owns 64 or 96 query (key)
    rows of one head (:func:`bwd_owner_rows`) and sweeps the keys
    (queries) in 32-row tiles through a double buffer; its qk-norm partial
    rows (2, padded Dh) and, per batch element, their sums take the
    scratch."""
    dhp = mma_head_dim(Dh)
    passes, smem, blocks = [], [], 0
    for T in (Tq, Tk):
        rows = bwd_owner_rows(T, Dh)
        grid = (-(-T // rows), H, B)
        passes.append((rows, grid))
        smem.append((2 * rows + 4 * MMA_KEYS) * (dhp + 8) * 2)
        blocks = max(blocks, grid[0] * H * B)
    return passes[0], passes[1], tuple(smem), (blocks + B) * 2 * dhp


def check_mma_rows(*tensors) -> None:
    """Raise unless each (B, T, ...) operand's rows start 16-byte aligned:
    the bf16 kernels copy them with 16-byte cp.async."""
    for t in tensors:
        if t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8:
            raise ValueError(f"bf16 operand {tuple(t.shape)} stride "
                             f"{t.stride()}: rows must be 16-byte aligned")


def _geometry(q, k, v, key_bias, num_heads, qk_norm, causal):
    """Check the operands; returns (B, Tq, Tk, H, Dh, norm pointers)."""
    dev = q.device
    B, Tq, HD = q.shape
    Tk = k.shape[1]
    H = num_heads
    Dh = HD // H
    if HD != H * Dh:
        raise ValueError(f"width {HD} is not {H} heads")
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh} outside the kernels' 1..{MAX_HEAD_DIM}")
    if Tk > MAX_KEYS or Tq > MAX_KEYS:
        raise ValueError(f"T={max(Tq, Tk)} exceeds the kernels' {MAX_KEYS}")
    if causal and Tq != Tk:
        raise ValueError("causal attention needs Tq == Tk")
    for t, name, shape in ((q, "q", (B, Tq, HD)), (k, "k", (B, Tk, HD)),
                           (v, "v", (B, Tk, HD))):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name}: {t.device} {t.dtype}, expected "
                             f"{dev} {q.dtype}")
        if tuple(t.shape) != shape or t.stride(-1) != 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)} stride "
                             f"{t.stride()}, expected {shape} with a "
                             f"contiguous last axis")
    if key_bias is not None:
        _build.require(key_bias, "key_bias", dev, torch.float32, (B, Tk))
    if q.dtype == torch.bfloat16:
        mma_head_dim(Dh)
        check_mma_rows(q, k, v)
    norms = [None] * 4
    if qk_norm is not None:
        for p in qk_norm:
            _build.require(p, "qk-norm param", dev, torch.float32, (Dh,))
        norms = list(qk_norm)
    return B, Tq, Tk, H, Dh, norms


def _operands(q, k, v, key_bias, norms):
    return (_build.ptr(q), q.stride(0), q.stride(1),
            _build.ptr(k), k.stride(0), k.stride(1),
            _build.ptr(v), v.stride(0), v.stride(1),
            _build.ptr(key_bias), *(_build.ptr(p) for p in norms))


def launch_fwd(q, k, v, key_bias, *, num_heads, causal, qk_norm, norm_p):
    """One launch of the forward kernel on CUDA operands (no count): the
    wrappers of the stacks' attention_fwd and of encoder_stack's
    encoder_attention share it."""
    code = _build.dtype_code(q)
    B, Tq, Tk, H, Dh, norms = _geometry(q, k, v, key_bias, num_heads,
                                        qk_norm, causal)
    resident = q.dtype == torch.bfloat16 and \
        fwd_resident(Tk, Dh, qk_norm is not None) is not None
    out = torch.empty((B, Tq, H * Dh), dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.sk_attention_fwd(
            code, *_operands(q, k, v, key_bias, norms), _build.ptr(out),
            out.stride(0), out.stride(1), B, Tq, Tk, H, Dh, int(causal),
            int(norm_p), int(resident), 1.0 / Dh ** 0.5, _build.stream(q))
    _build.check(err, "attention_fwd")
    return out


def attention_fwd(q, k, v, key_bias: Optional[torch.Tensor], *,
                  num_heads: int, causal: bool = False,
                  qk_norm: Optional[Sequence[torch.Tensor]] = None,
                  norm_p: bool = True) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, key_bias, num_heads=num_heads,
                                       causal=causal, qk_norm=qk_norm,
                                       norm_p=norm_p)
    if q.device.type != "cuda":
        raise ValueError(f"attention_fwd: unsupported device {q.device}")
    out = launch_fwd(q, k, v, key_bias, num_heads=num_heads, causal=causal,
                     qk_norm=qk_norm, norm_p=norm_p)
    LAUNCHES["attention_fwd"] += 1
    return out


def _bwd(pass_, q, k, v, dout, key_bias, stats, num_heads, causal, qk_norm):
    from sketchformer_tpu_torch.ops.norm_train import sum_rows

    code = _build.dtype_code(q)
    B, Tq, Tk, H, Dh, norms = _geometry(q, k, v, key_bias, num_heads,
                                        qk_norm, causal)
    dev = q.device
    mma = q.dtype == torch.bfloat16
    _build.require(dout, "dout", dev, dout.dtype, (B, Tq, H * Dh))
    if dout.dtype not in (torch.float32, q.dtype):
        raise TypeError(f"dout has dtype {dout.dtype}, expected float32 or "
                        f"{q.dtype}")
    if mma and dout.data_ptr() % 16:
        raise ValueError("bf16 attention backward: dout must be 16-byte "
                         "aligned")
    if pass_ == 1:
        stats = torch.empty((B, H, Tq, 3), dtype=torch.float32, device=dev)
        dq = torch.empty((B, Tq, H * Dh), dtype=torch.float32, device=dev)
        dk = dv = dq
        blocks = B * H * -(-Tq // BWD_Q_ROWS)
    else:
        _build.require(stats, "stats", dev, torch.float32, (B, H, Tq, 3))
        dk = torch.empty((B, Tk, H * Dh), dtype=torch.float32, device=dev)
        dv = torch.empty_like(dk)
        dq = dk
        blocks = B * H * -(-Tk // BWD_KV_COLS)
    parts = grads = ws = counters = None
    rows = 0
    if mma:
        plan = bwd_mma_plan(B, Tq, Tk, H, Dh)
        rows = plan[pass_ - 1][0]
    if qk_norm is not None and mma:
        # summed in the launch (split_reduce.cuh): B + 1 counters and the
        # plan's scratch
        grads = torch.empty((2, Dh), dtype=torch.float32, device=dev)
        counters, ws = _build.split_scratch(dev, B + 1, plan[3])
    elif qk_norm is not None:
        parts = torch.empty((2, blocks, Dh), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_attention_bwd(
            code, pass_, *_operands(q, k, v, key_bias, norms),
            _build.ptr(dout), dout.stride(0), dout.stride(1),
            int(dout.dtype == q.dtype), _build.ptr(stats), _build.ptr(dq),
            dq.stride(0), dq.stride(1), _build.ptr(dk), dk.stride(0),
            dk.stride(1), _build.ptr(dv), dv.stride(0), dv.stride(1),
            None if parts is None else _build.ptr(parts[0]),
            None if parts is None else _build.ptr(parts[1]),
            _build.ptr(grads), _build.ptr(ws), _build.ptr(counters), rows,
            B, Tq, Tk, H, Dh, int(causal), 1.0 / Dh ** 0.5, _build.stream(q))
    name = "attention_bwd_q" if pass_ == 1 else "attention_bwd_kv"
    _build.check(err, name)
    LAUNCHES[name] += 1
    ds = db = None
    if parts is not None:
        grads = sum_rows(parts.transpose(0, 1).reshape(blocks, 2 * Dh))
        grads = grads.reshape(2, Dh)
    if grads is not None:
        ds, db = grads[0], grads[1]
    if pass_ == 1:
        return dq, stats, ds, db
    return dk, dv, ds, db


def attention_bwd_q(q, k, v, dout, key_bias, *, num_heads, causal=False,
                    qk_norm=None):
    """dq, row statistics and q-norm gradients; ``dout`` (B, Tq, H*Dh) in
    f32 or the compute dtype."""
    if q.device.type == "cpu":
        return attention_bwd_q_reference(q, k, v, dout, key_bias,
                                         num_heads=num_heads, causal=causal,
                                         qk_norm=qk_norm)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_q: unsupported device {q.device}")
    return _bwd(1, q, k, v, dout, key_bias, None, num_heads, causal, qk_norm)


def attention_bwd_kv(q, k, v, dout, key_bias, stats, *, num_heads,
                     causal=False, qk_norm=None):
    """dk, dv and k-norm gradients, from the statistics of
    :func:`attention_bwd_q`."""
    if q.device.type == "cpu":
        return attention_bwd_kv_reference(q, k, v, dout, key_bias, stats,
                                          num_heads=num_heads, causal=causal,
                                          qk_norm=qk_norm)
    if q.device.type != "cuda":
        raise ValueError(f"attention_bwd_kv: unsupported device {q.device}")
    return _bwd(2, q, k, v, dout, key_bias, stats, num_heads, causal, qk_norm)
