"""The token head fused with its cross-entropy, on hand-written kernels.

Port of ``sketchformer_tpu/ops/pallas_ce.py::token_ce_rows`` (K6). The
vocab head is the token train step's largest tensor: the (B*T, V) f32
logits are about 2 GB at the JAX benchmark's ``train`` shape (B=512, T=96,
V=10,004). The kernels of ``csrc/token_ce.cu`` compute each 64-column
logits tile on chip and reduce it there, so the logits never reach device
memory:

- ``token_ce_fwd``: per row the target log-likelihood ``ll``, the
  argmax-correct indicator ``corr`` (first index on ties) and the
  logsumexp ``lse`` (the backward's softmax residual); in bf16 a wgmma
  kernel fed by a TMA ring of W's vocab tiles, 128 rows a block
  (:func:`fwd_plan`), the row statistics kept in registers;
- ``token_ce_bwd``: ``dx`` (the ``ce_dx`` kernel, row tiles; in bf16 a
  wgmma kernel fed by a TMA ring, 128 rows a block), ``dW`` and ``db`` (the
  ``ce_dw`` kernel, vocab tiles over M slices, whose f32 partials the last
  block of each tile adds in a fixed order in the same launch; in bf16 a
  wgmma kernel fed by a TMA ring of 64-row x slabs, its two consumer
  warpgroups taking alternate slabs).

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
DX_ROWS, DX_STAGES = 128, 4  # bf16 ce_dx: rows a block, W tiles in flight
DW_MAX_SPLITS = 8          # ce_dw: M slices (of whole 64-row slabs) at most
DW_STAGES_MAX = 8          # bf16 ce_dw: x slabs in flight at most
SMEM_MAX = 232448          # shared memory a block may opt into (H100)


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


def padded_operands(x, w):
    """x (M, dp) and W (dp, Vp) as the kernels read them: in x's dtype,
    zero-padded to multiples of 64 (the padded columns of W are zero, and
    the kernels exclude columns >= V by index) and 16-byte aligned."""
    d, V = w.shape
    dp, Vp = _pad64(d), _pad64(V)
    if dp > MAX_WIDTH:
        raise ValueError(f"token_ce: d={d} above the kernels' {MAX_WIDTH}")
    xp = x.contiguous() if dp == d else F.pad(x, (0, dp - d))
    if xp.data_ptr() % 16:
        xp = xp.clone()
    wp = torch.zeros((dp, Vp), dtype=x.dtype, device=x.device)
    wp[:d, :V] = w
    return xp, wp


def dx_plan(M: int, dp: int) -> Tuple[int, int]:
    """(blocks, shared-memory bytes a block) of the bf16 ``ce_dx`` kernel:
    128-row blocks; 1024 bytes to align the swizzle atoms, the block's x
    slab, DX_STAGES W tiles of dp x 64 and their barriers
    (csrc/token_ce.cu::dx_smem_bytes)."""
    smem = 1024 + DX_ROWS * dp * 2 + DX_STAGES * dp * TILE * 2 + \
        (2 * DX_STAGES + 1) * 8
    return -(-M // DX_ROWS), smem


FWD_STAGES_MAX = 8         # bf16 ce_fwd: W tiles in flight at most


def fwd_plan(M: int, dp: int) -> Tuple[int, int, int]:
    """(blocks, W tiles in flight, shared-memory bytes a block) of the bf16
    ``ce_fwd`` kernel, which launches with them: 128-row blocks
    (``ce_dx``'s), each with 1024 bytes to align the swizzle atoms, its x
    slab and as many dp x 64 W tiles as fit beside it, at most
    FWD_STAGES_MAX, with two barriers a tile and one for the slab (the
    launcher refuses a size below csrc/token_ce.cu::fwd_smem_bytes)."""
    fixed = 1024 + DX_ROWS * dp * 2 + 8
    tile = dp * TILE * 2 + 2 * 8
    stages = min(FWD_STAGES_MAX, (SMEM_MAX - fixed) // tile)
    return -(-M // DX_ROWS), stages, fixed + stages * tile


def _operands(x, w, b, tgt):
    """The kernels' operands (:func:`padded_operands`), b f32 and tgt
    int32, checked."""
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
    xp, wp = padded_operands(x, w)
    return (code, xp, wp, b.float().contiguous(),
            tgt.to(torch.int32).contiguous(), M, d, V, *wp.shape)


def token_ce_fwd(x, w, b, tgt) -> Tuple[torch.Tensor, ...]:
    """(ll, corr, lse) of :func:`token_ce_fwd_reference`, on the kernel."""
    if x.device.type == "cpu":
        return token_ce_fwd_reference(x, w, b, tgt)
    code, xp, wp, bp, tp, M, _, V, dp, Vp = _operands(x, w, b, tgt)
    out = torch.empty((3, M), dtype=torch.float32, device=x.device)
    blocks, stages, smem = fwd_plan(M, dp)   # bf16 only
    lib = _build.library()
    with torch.cuda.device(x.device):
        err = lib.sk_token_ce_fwd(code, _build.ptr(xp), _build.ptr(wp),
                                  _build.ptr(bp), _build.ptr(tp),
                                  _build.ptr(out[0]), _build.ptr(out[1]),
                                  _build.ptr(out[2]), M, dp, V, Vp, blocks,
                                  stages, smem, _build.stream(x))
    _build.check(err, "token_ce_fwd")
    LAUNCHES["token_ce_fwd"] += 1
    return out[0], out[1], out[2]


def dw_smem(dp: int) -> Tuple[int, int]:
    """(x slabs in flight, shared-memory bytes) of a bf16 ``ce_dw`` block
    (csrc/token_ce.cu::dw_smem_bytes): 1024 to align the swizzle atoms, the
    W tile (dp x 64), the two warpgroups' dl tiles (64 x 64), the db
    reduction rows (8 x 64 f32), 17 mbarriers and the flag, then as many
    64-row x slabs as fit, at most DW_STAGES_MAX."""
    fixed = 1024 + dp * TILE * 2 + 2 * TILE * TILE * 2 + 8 * TILE * 4 + \
        (2 * DW_STAGES_MAX + 1) * 8 + 16
    slab = TILE * dp * 2
    stages = min(DW_STAGES_MAX, (SMEM_MAX - fixed) // slab)
    return stages, fixed + stages * slab


def dw_plan(M: int, V: int, sms: int = 132) -> Tuple[int, int, int]:
    """(vocab tiles, splits, rows_per_split) of ``ce_dw``: one block a
    (64-column vocab tile, M slice), one block an SM; of the split counts
    up to DW_MAX_SPLITS (each slice a whole number of 64-row slabs) the one
    whose grid fills its last wave of ``sms`` best, the fewest on a tie."""
    tiles = -(-V // TILE)
    slabs = max(1, -(-M // TILE))

    def fill(s):
        blocks = tiles * s
        return blocks / (-(-blocks // sms) * sms)

    best = max(range(1, min(slabs, DW_MAX_SPLITS) + 1),
               key=lambda s: (fill(s), -s))
    rps = -(-slabs // best) * TILE
    return tiles, -(-max(M, 1) // rps), rps


def token_ce_bwd(x, w, b, tgt, lse, gll):
    """(dx, dW, db) of :func:`token_ce_bwd_reference`, on the kernels."""
    if x.device.type == "cpu":
        return token_ce_bwd_reference(x, w, b, tgt, lse, gll)
    code, xp, wp, bp, tp, M, d, V, dp, Vp = _operands(x, w, b, tgt)
    dev = x.device
    _build.require(lse, "lse", dev, torch.float32, (M,))
    _build.require(gll, "gll", dev, torch.float32, (M,))
    tiles, splits, rps = dw_plan(M, V, _build.sm_count(dev))
    dx = torch.empty((M, dp), dtype=x.dtype, device=dev)
    out = torch.empty((d * V + V,), dtype=torch.float32, device=dev)
    dw, db = out[:d * V].view(d, V), out[d * V:]
    parts = tiles * splits * dp * TILE
    counters, ws = _build.split_scratch(dev, tiles,
                                        parts + tiles * splits * TILE)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_token_ce_bwd(code, _build.ptr(xp), _build.ptr(wp),
                                  _build.ptr(bp), _build.ptr(tp),
                                  _build.ptr(lse), _build.ptr(gll),
                                  _build.ptr(dx), _build.ptr(dw),
                                  _build.ptr(db), _build.ptr(ws),
                                  _build.ptr(ws[parts:]),
                                  _build.ptr(counters), M, d, dp, V, Vp,
                                  splits, rps, _build.stream(x))
    _build.check(err, "token_ce_bwd")
    LAUNCHES["token_ce_dx"] += 1
    LAUNCHES["token_ce_dw"] += 1
    return dx[:, :d], dw, db


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
