"""The token head fused with its cross-entropy, on hand-written kernels.

Port of ``sketchformer_tpu/ops/pallas_ce.py::token_ce_rows`` (K6). The
vocab head is the token train step's largest tensor: the (B*T, V) f32
logits are about 2 GB at the JAX benchmark's ``train`` shape (B=512, T=96,
V=10,004). The kernels of ``csrc/token_ce.cu`` compute each 64 x 64 logits
tile in shared memory and reduce it there, so the logits never reach device
memory:

- ``token_ce_fwd``: per row the target log-likelihood ``ll``, the
  argmax-correct indicator ``corr`` (first index on ties) and the
  logsumexp ``lse`` (the backward's softmax residual);
- ``token_ce_bwd``: ``dx`` (the ``ce_dx`` kernel, row tiles), ``dW`` and
  ``db`` (the ``ce_dw`` kernel, vocab tiles over M slices, whose f32
  partials ``sum_rows`` adds in a fixed order).

Numerics are the TPU kernel's: the logits stay f32 end to end (the product
of the compute-dtype operands accumulated in f32, the f32 bias added in
f32), never rounded to the compute dtype as the composed flax head
(``TokenHead.proj``) rounds them; dl is rounded to the compute dtype for the
two backward products and db sums the f32 dl. f32 configs match the
composed CE; in bf16 the two sit within about one bf16 ulp a logit.

Each wrapper has its plain torch version beside it (``*_reference``), which
materialises the logits. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernels or raises.
:func:`token_ce_rows` is the differentiable function (``corr`` gets no
gradient); the masked mean over rows is the caller's (``models/heads.py``).

``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from sketchformer_tpu_torch.ops import _build

LAUNCHES = {"token_ce_fwd": 0, "token_ce_dx": 0, "token_ce_dw": 0}
TILE = 64                  # the kernels' row and vocab tile (csrc/token_ce.cu)
MAX_WIDTH = 4 * TILE       # d_model the backward keeps in registers
DW_BLOCKS_PER_SM = 4       # ce_dw's M slices aim at about this many blocks


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def logits_reference(x, w, b):
    """f32 logits of the compute-dtype operands: x . W (W rounded to x's
    dtype) accumulated in f32, plus the f32 bias."""
    return torch.matmul(x.float(), w.to(x.dtype).float()) + b.float()


def token_ce_fwd_reference(x, w, b, tgt):
    """(ll, corr, lse), each (M,) f32, of rows x (M, d), W (d, V), b (V,)
    and int targets (M,)."""
    l = logits_reference(x, w, b)
    mx = l.amax(dim=-1, keepdim=True)
    lse = mx[:, 0] + torch.log(torch.exp(l - mx).sum(dim=-1))
    V = l.shape[-1]
    t = tgt.long()
    inside = (t >= 0) & (t < V)
    lt = torch.where(inside, l.gather(-1, t.clamp(0, V - 1)[:, None])[:, 0],
                     0.0)
    corr = (l.argmax(dim=-1) == t).float()
    return lt - lse, corr, lse


def token_ce_bwd_reference(x, w, b, tgt, lse, gll):
    """(dx in x's dtype, dW (d, V) f32, db (V,) f32) for the gradient
    ``gll`` (M,) of ``ll``."""
    dt = x.dtype
    wd = w.to(dt).float()
    l = torch.matmul(x.float(), wd) + b.float()
    p = torch.exp(l - lse[:, None])
    hit = torch.arange(l.shape[-1], device=l.device)[None] == \
        tgt.long()[:, None]
    dl = torch.where(hit, 1.0 - p, -p) * gll.float()[:, None]
    dlp = dl.to(dt).float()
    dx = torch.matmul(dlp, wd.t()).to(dt)
    return dx, torch.matmul(x.float().t(), dlp), dl.sum(dim=0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _pad64(n: int) -> int:
    return -(-n // TILE) * TILE


def _operands(x, w, b, tgt):
    """The kernels' operands: x (M, dp) and W (dp, Vp) in the compute
    dtype, zero-padded to multiples of 64 and 16-byte aligned; b f32; tgt
    int32."""
    M, d = x.shape
    V = w.shape[1]
    dev = x.device
    if x.device.type != "cuda":
        raise ValueError(f"token_ce: unsupported device {x.device}")
    code = _build.dtype_code(x)
    if w.shape[0] != d or tuple(b.shape) != (V,) or tuple(tgt.shape) != (M,):
        raise ValueError(f"token_ce: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}, tgt {tuple(tgt.shape)}")
    for t, name in ((w, "w"), (b, "b"), (tgt, "tgt")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    dp, Vp = _pad64(d), _pad64(V)
    if dp > MAX_WIDTH:
        raise ValueError(f"token_ce: d={d} above the kernels' {MAX_WIDTH}")
    xp = x.contiguous() if dp == d else F.pad(x, (0, dp - d))
    if xp.data_ptr() % 16:
        xp = xp.clone()
    wp = torch.zeros((dp, Vp), dtype=x.dtype, device=dev)
    wp[:d, :V] = w
    return (code, xp, wp, b.float().contiguous(),
            tgt.to(torch.int32).contiguous(), M, d, V, dp, Vp)


def token_ce_fwd(x, w, b, tgt) -> Tuple[torch.Tensor, ...]:
    """(ll, corr, lse) of :func:`token_ce_fwd_reference`, on the kernel."""
    if x.device.type == "cpu":
        return token_ce_fwd_reference(x, w, b, tgt)
    code, xp, wp, bp, tp, M, _, V, dp, Vp = _operands(x, w, b, tgt)
    out = torch.empty((3, M), dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sk_token_ce_fwd(code, _build.ptr(xp), _build.ptr(wp),
                                  _build.ptr(bp), _build.ptr(tp),
                                  _build.ptr(out[0]), _build.ptr(out[1]),
                                  _build.ptr(out[2]), M, dp, V, Vp,
                                  _build.stream(x))
    _build.check(err, "token_ce_fwd")
    LAUNCHES["token_ce_fwd"] += 1
    return out[0], out[1], out[2]


def dw_splits(M: int, V: int, sms: int = 132) -> int:
    """How many M slices ``ce_dw`` runs: about DW_BLOCKS_PER_SM blocks per
    SM over the vocab tiles, each slice at least 8 row tiles."""
    tiles = -(-V // TILE)
    return max(1, min(-(-M // (8 * TILE)), -(-DW_BLOCKS_PER_SM * sms // tiles)))


def token_ce_bwd(x, w, b, tgt, lse, gll):
    """(dx, dW, db) of :func:`token_ce_bwd_reference`, on the kernels."""
    if x.device.type == "cpu":
        return token_ce_bwd_reference(x, w, b, tgt, lse, gll)
    from sketchformer_tpu_torch.ops.norm_train import sum_rows

    code, xp, wp, bp, tp, M, d, V, dp, Vp = _operands(x, w, b, tgt)
    dev = x.device
    _build.require(lse, "lse", dev, torch.float32, (M,))
    _build.require(gll, "gll", dev, torch.float32, (M,))
    splits = dw_splits(M, V, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    dx = torch.empty((M, dp), dtype=x.dtype, device=dev)
    dw = torch.empty((splits, dp, Vp), dtype=torch.float32, device=dev)
    db = torch.empty((splits, Vp), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_token_ce_bwd(code, _build.ptr(xp), _build.ptr(wp),
                                  _build.ptr(bp), _build.ptr(tp),
                                  _build.ptr(lse), _build.ptr(gll),
                                  _build.ptr(dx), _build.ptr(dw),
                                  _build.ptr(db), M, dp, V, Vp, splits,
                                  _build.stream(x))
    _build.check(err, "token_ce_bwd")
    LAUNCHES["token_ce_dx"] += 1
    LAUNCHES["token_ce_dw"] += 1
    if splits > 1:
        dw = sum_rows(dw.reshape(splits, dp * Vp)).reshape(dp, Vp)
        db = sum_rows(db)
    else:
        dw, db = dw[0], db[0]
    return dx[:, :d], dw[:d, :V], db[:V]


class _TokenCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, tgt):
        ll, corr, lse = token_ce_fwd(x, w, b, tgt)
        ctx.save_for_backward(x, w, b, tgt, lse)
        ctx.mark_non_differentiable(corr)
        return ll, corr

    @staticmethod
    def backward(ctx, gll, _gcorr):
        x, w, b, tgt, lse = ctx.saved_tensors
        if gll is None:
            return None, None, None, None
        dx, dw, db = token_ce_bwd(x, w, b, tgt, lse,
                                  gll.float().contiguous())
        return dx, dw.to(w.dtype), db.to(b.dtype), None


def token_ce_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tgt: torch.Tensor):
    """Per-row token CE statistics without the logits in device memory.

    ``x`` (M, d) rows in the compute dtype; ``w`` (d, V) the head kernel
    (f32 parameter, rounded to the compute dtype inside); ``b`` (V,) f32
    bias; ``tgt`` (M,) int targets. Returns (ll, corr): (M,) f32 target
    log-likelihood and argmax == target indicator; ``corr`` carries no
    gradient. dW comes back f32 and db f32, as the parameters are.
    """
    return _TokenCE.apply(x, w, b, tgt)
