"""Per-op attention, forward and backward, on hand-written Hopper kernels.

Port of ``sketchformer_tpu/ops/pallas_attention.py::flash_attention`` (K8),
the attention of the composed layers when ``attn_impl='pallas'`` and the
fused stacks decline: the post-LN model's encoder and teacher-forced
decoder self-attention, and any caller with a legacy 4-D mask. The kernels
are in ``csrc/attention_train.cu``: the forward is ``attention_fwd``
through its K8 entry point ``sk_flash_attention_fwd`` (in bf16 the
tensor-core forward, which takes a head_dim that is a multiple of 16); the
backward
(``sk_flash_attention_bwd``) is a kernel of its own on the tensor cores in
bf16 (``flash_bwd_mma_kernel``) and ``attention_bwd_q`` / ``_kv`` in f32
(see the notes in that file); ``flash_attention_reference`` and
``flash_attention_bwd_reference``
are their plain torch versions, with the TPU kernel's rounding sites:

- scores ``(q . k)`` in f32, scaled by the Python ``1/sqrt(Dh)`` after the
  sum (no ``q * scale`` in the compute dtype, as flax's formulation has);
- the structured mask: a key mask is an additive -1e9 on the f32 scores,
  a full (B or 1, Tq, Tk) pane the same, and ``causal`` a ``where`` to
  -1e9 after it (a fully masked row softmaxes ``s - 1e9``);
- the forward rounds the unnormalised ``e`` to the compute dtype before
  ``e . v`` and divides by the f32 sum after;
- the backward recomputes the softmax with ``p = e * (1 / sum)``, forms
  ``ds = p * (dp - sum(dp * p))`` on the f32 p, rounds ``p`` and ``ds``
  before their products and the gradients at the end.

:func:`flash_attention` takes (B, T, H, Dh) tensors, or (B, H, T, Dh) with
``head_major``, as the JAX function does, and is differentiable (a
``torch.autograd.Function`` saving q, k, v and the bias, as the custom
VJP's residuals). Past ``MAX_FUSED_LEN`` positions it computes the composed
``dot_product_attention``, as the JAX function does, and notes the decline
with ``note_engine``. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel or raises. ``LAUNCHES`` counts
kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from sketchformer_tpu_torch.ops import _build
from sketchformer_tpu_torch.ops.attention_train import (
    check_mma_rows,
    mma_head_dim,
)
from sketchformer_tpu_torch.utils.engines import note_engine

NEG_INF = -1e9
MAX_FUSED_LEN = 1024        # a block's f32 score rows stay in shared memory
MAX_HEAD_DIM = 128

LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def structure_mask(mask: Optional[torch.Tensor],
                   key_mask: Optional[torch.Tensor], B: int, Tq: int,
                   Tk: int) -> Optional[torch.Tensor]:
    """Resolve (``mask`` | ``key_mask``) into the f32 bias the kernels add:
    (B, 1, Tk) for a key mask, (B or 1, Tq, Tk) for an irreducible 4-D
    mask, or None (the JAX ``_structure_mask``). A 4-D mask is read at head
    0 (it must be head-invariant); a pure key mask is demoted to the
    vector form, broadcast to B rows."""
    if mask is not None:
        if key_mask is not None:
            raise ValueError("pass either mask or key_mask, not both")
        if mask.ndim != 4:
            raise ValueError("mask must be 4D (B, H, Tq, Tk)-broadcastable")
        mask = mask[:, 0]
        if mask.shape[1] == 1:
            key_mask = mask[:, 0]
        else:
            full = mask.expand(mask.shape[0], Tq, Tk)
            return torch.where(full, 0.0, NEG_INF).float().contiguous()
    if key_mask is not None:
        if key_mask.ndim != 2:
            raise ValueError("key_mask must be (B, Tk)")
        bias = torch.where(key_mask, 0.0, NEG_INF).float()[:, None, :]
        return bias.expand(B, 1, Tk).contiguous()
    return None


# ---------------------------------------------------------------------------
# plain versions, on (B, T, H, Dh) tensors
# ---------------------------------------------------------------------------


def _scores(q, k, bias, causal):
    """f32 (B, H, Tq, Tk): (q . k) * scale + bias, then the causal where."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / q.shape[-1] ** 0.5)
    if bias is not None:
        s = s + bias[:, None]
    if causal:
        Tq, Tk = s.shape[-2:]
        t = torch.arange(Tq, device=s.device)[:, None]
        j = torch.arange(Tk, device=s.device)[None, :]
        s = torch.where(j <= t, s, NEG_INF)
    return s


def flash_attention_reference(q, k, v, bias=None, causal=False):
    """Forward: (B, Tq, H, Dh) output in q's dtype; ``bias`` as returned
    by :func:`structure_mask`."""
    s = _scores(q, k, bias, causal)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(q.dtype).float(), v.float())
    return (o / e.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)


def flash_attention_bwd_reference(q, k, v, bias, g, causal=False):
    """Backward from the output gradient ``g`` (B, Tq, H, Dh): (dq, dk,
    dv) in the inputs' dtypes."""
    dt = q.dtype
    s = _scores(q, k, bias, causal)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e * (1.0 / e.sum(dim=-1, keepdim=True))
    g32 = g.to(dt).float()
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dt).float(), g32)
    dp = torch.einsum("bqhd,bkhd->bhqk", g32, v.float())
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(dt).float()
    scale = 1.0 / q.shape[-1] ** 0.5
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    return dq.to(dt), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _rows(x):
    """x (B, T, H, Dh) as the kernels read it: heads side by side in a row
    and Dh contiguous (a copy only for another layout)."""
    B, T, H, Dh = x.shape
    if x.stride(3) != 1 or x.stride(2) != Dh:
        x = x.contiguous()
    return x


def _operands(q, k, v, bias, causal):
    """Checked kernel operands: (q, k, v, bias, bias strides, dims)."""
    B, Tq, H, Dh = q.shape
    Tk = k.shape[1]
    dev, dt = q.device, q.dtype
    _build.dtype_code(q)
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh} outside the kernels' "
                         f"1..{MAX_HEAD_DIM}")
    if max(Tq, Tk) > MAX_FUSED_LEN:
        raise ValueError(f"T={max(Tq, Tk)} exceeds the kernels' "
                         f"{MAX_FUSED_LEN}")
    for t, name, shape in ((k, "k", (B, Tk, H, Dh)),
                           (v, "v", (B, Tk, H, Dh))):
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: {t.device} {t.dtype} "
                             f"{tuple(t.shape)}, expected {dev} {dt} {shape}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    bs = rs = 0
    if bias is not None:
        Bb, R = bias.shape[:2]
        if bias.ndim != 3 or Bb not in (1, B) or R not in (1, Tq) or (
                R == 1 and Bb != B):
            raise ValueError(f"bias {tuple(bias.shape)} is neither a (B, 1, "
                             f"Tk) key mask nor a (B or 1, Tq, Tk) pane")
        _build.require(bias, "bias", dev, torch.float32, (Bb, R, Tk))
        bs = 0 if Bb == 1 else R * Tk
        rs = 0 if R == 1 else Tk
    return q, k, v, bias, bs, rs, (B, Tq, Tk, H, Dh, int(bool(causal)))


def _strided(x):
    return _build.ptr(x), x.stride(0), x.stride(1)


def flash_attention_fwd(q, k, v, bias=None, causal=False):
    """:func:`flash_attention_reference` on the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    q, k, v, bias, bs, rs, dims = _operands(q, k, v, bias, causal)
    if q.dtype == torch.bfloat16:
        mma_head_dim(dims[4])
        check_mma_rows(q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.sk_flash_attention_fwd(
            _build.dtype_code(q), *_strided(q), *_strided(k), *_strided(v),
            _build.ptr(bias), bs, rs, *_strided(out), *dims,
            1.0 / dims[4] ** 0.5, _build.stream(q))
    _build.check(err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def flash_bwd_smem(Dh: int) -> int:
    """Shared memory of a block of the bf16 backward kernel (bytes): two
    64-row owned tiles and two double-buffered 32-row swept tiles of
    Dh + 8 columns, Dh taken up to 32, 64 or 128; it does not grow with T."""
    dhp = 32 if Dh <= 32 else 64 if Dh <= 64 else 128
    return (2 * 64 + 4 * 32) * (dhp + 8) * 2


def flash_bwd_f32_smem(Tq: int, Tk: int, Dh: int) -> int:
    """Shared memory of the f32 backward's larger pass (``attention_bwd_q``:
    16 query rows' f32 score and dp rows, T long, in csrc's launch_bwd_q)."""
    return 4 * (2 * 16 * Dh + max(16 * Tk * 2, 2 * 8 * Dh) + 64 * (Dh + 1))


def _pad8(x, Dh):
    """The bf16 kernel reads 16-byte rows: Dh taken up to a multiple of 8
    (zero columns add nothing to any product)."""
    if Dh % 8 == 0 and x.data_ptr() % 16 == 0 and x.stride(1) % 8 == 0 \
            and x.stride(0) % 8 == 0:
        return x
    return torch.nn.functional.pad(x, (0, (-Dh) % 8)).contiguous()


def flash_attention_bwd(q, k, v, bias, g, causal=False):
    """:func:`flash_attention_bwd_reference` on the kernels for CUDA
    tensors: in bf16 the tensor-core backward (a dq sweep that saves each
    row's (max, sum, delta), then a dk / dv sweep), in f32 the FMA passes;
    one launch count for either."""
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(q, k, v, bias, g, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    q, k, v, bias, bs, rs, dims = _operands(q, k, v, bias, causal)
    B, Tq, Tk, H, Dh, _ = dims
    g = _rows(g.to(q.dtype))
    if tuple(g.shape) != tuple(q.shape) or g.device != q.device:
        raise ValueError(f"gradient {tuple(g.shape)} on {g.device}, "
                         f"expected {tuple(q.shape)} on {q.device}")
    scale = 1.0 / Dh ** 0.5
    if q.dtype == torch.bfloat16:
        q, k, v, g = (_pad8(x, Dh) for x in (q, k, v, g))
    Dp = q.shape[-1]
    stats = torch.empty((B, H, Tq, 3), dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Tq, H, Dp), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Tk, H, Dp), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.sk_flash_attention_bwd(
            _build.dtype_code(q), *_strided(q), *_strided(k), *_strided(v),
            _build.ptr(bias), bs, rs, *_strided(g), _build.ptr(stats),
            *_strided(dq), *_strided(dk), *_strided(dv), B, Tq, Tk, H, Dp,
            dims[5], scale, _build.stream(q))
    _build.check(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    if Dp != Dh:
        dq, dk, dv = (x[..., :Dh] for x in (dq, dk, dv))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The custom VJP: the residuals are q, k, v and the bias; the backward
    recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, k, v, bias, causal):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, bias)
        return flash_attention_fwd(q, k, v, bias, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, bias, g, ctx.causal)
        return dq, dk, dv, None, None


def _composed(q, k, v, mask, key_mask, causal):
    """The JAX function's fallback past MAX_FUSED_LEN: the composed
    attention of (B, T, H, Dh) tensors under the combined boolean mask."""
    from sketchformer_tpu_torch.models.attention import (
        causal_mask,
        combine_masks,
        dot_product_attention,
    )

    full = combine_masks(
        mask, None if key_mask is None else key_mask[:, None, None, :],
        causal_mask(q.shape[1], q.device) if causal else None)
    return dot_product_attention(q, k, v, mask=full)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    head_major: bool = False,
                    key_mask: Optional[torch.Tensor] = None,
                    causal: bool = False) -> torch.Tensor:
    """Fused attention (True = attend). Prefer the structured masks,
    ``key_mask`` (B, Tk) and ``causal``; the legacy ``mask`` broadcasts
    against (B, H, Tq, Tk) and is demoted to a key mask where it is one.
    ``head_major=False``: (B, T, H, Dh) tensors; ``True``: (B, H, T, Dh)."""
    if head_major:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    B, Tq = q.shape[:2]
    Tk = k.shape[1]
    if max(Tq, Tk) > MAX_FUSED_LEN:
        note_engine("flash-attention", "composed",
                    f"T={max(Tq, Tk)} > fused limit {MAX_FUSED_LEN}")
        out = _composed(q, k, v, mask, key_mask, causal)
    else:
        bias = structure_mask(mask, key_mask, B, Tq, Tk)
        out = _FlashAttention.apply(q, k, v, bias, bool(causal))
    return out.transpose(1, 2) if head_major else out
