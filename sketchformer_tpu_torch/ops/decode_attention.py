"""Single-position attention against a head-folded KV cache.

Port of ``sketchformer_tpu/ops/pallas_decode.py::decode_attention``, the
self-attention of the composed AR decode path when ``attn_impl='pallas'``
(``models/attention.py::cached_decode_attention``): every sampled decode
and every post-LN decode. The kernels are ``csrc/decode_attention.cu``;
``decode_attention_reference`` is their plain torch version, in the same
f32 math as the TPU kernel. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches a kernel or raises.
:func:`decode_attention_plan` picks the kernel and its geometry for each
call: the bulk kernel (each row's filled k and v spans fetched into shared
memory by 1-D bulk copies, a row's positions split over warps whose partial
softmaxes are merged) or, for the geometries it declines, the per-row
kernel. ``LAUNCHES`` counts kernel launches, ``ROUTES`` which kernel each
took.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sketchformer_tpu_torch.ops import _build

NEG_INF = -1e9
MAX_HEAD_DIM = 128      # the kernels keep a head row in registers
BULK_WARPS = 8          # a bulk block's rows x splits warps, at most
MAX_SPLITS = 4          # warps a row's positions are split over, at most
SPLIT_STEPS = 2         # a split's positions, at least this many warp steps
ROW_BLOCKS = 4          # one-row blocks an SM before a block takes more
SMEM_LIMIT = 232448     # bytes of shared memory a block may opt into
PER_ROW_WARPS = 8       # the per-row kernel: one row a warp

LAUNCHES = {"decode_attention": 0}
# launches by kernel: the bulk kernel on the plan, or the per-row kernel
# for a geometry the plan declines
ROUTES = {"bulk": 0, "declined": 0}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0
    for k in ROUTES:
        ROUTES[k] = 0


class Plan(NamedTuple):
    """One launch: ``rows`` folded rows a block, each row's filled positions
    split over ``splits`` warps of ``span`` positions (the last one's
    shorter), ``blocks`` blocks of ``smem`` bytes of shared memory. ``rows``
    0: declined, the per-row kernel (one row a warp, ``blocks`` blocks of
    eight)."""
    rows: int
    splits: int
    span: int
    blocks: int
    smem: int


def bulk_smem_bytes(rows: int, splits: int, span: int, Dh: int,
                    esize: int) -> int:
    """csrc/decode_attention.cu::bulk_smem_bytes: the barriers (16 bytes a
    warp, rounded up to 128), each row's staged k and v spans, its f32
    scores and each split's (max, sum, o[Dh]) in f32."""
    n = splits * span
    bars = -(-16 * rows * splits // 128) * 128
    return bars + rows * (2 * n * Dh * esize + n * 4 + splits * (Dh + 2) * 4)


def decode_attention_plan(BH: int, Tmax: int, Dh: int, cache_len: int,
                          dtype: torch.dtype, sms: int,
                          aligned: bool = True) -> Plan:
    """The launch of one call at (B*H, Tmax, Dh), ``cache_len`` filled
    positions, on a card of ``sms`` SMs.

    The bulk kernel takes a head row of whole 16-byte vectors, a power of
    two of them (Dh 32, 64 and 128 in bf16 and f32), and 16-byte
    ``aligned`` operands. A row's positions go to the fewest splits, at most
    ``MAX_SPLITS``, that leave each at least ``SPLIT_STEPS`` warp steps
    (a step: 32 / vectors-a-row positions), in equal consecutive spans. A
    block holds one row, or more where B*H gives every SM ``ROW_BLOCKS``
    blocks of one: at most B*H / (ROW_BLOCKS * sms) and what its eight
    warps and ``SMEM_LIMIT`` take, so there is a block an SM wherever B*H
    reaches the SM count. A geometry it cannot take (a Dh of another
    width, misaligned operands, a row past shared memory) is declined to
    the per-row kernel."""
    esize = torch.finfo(dtype).bits // 8
    vw = 16 // esize
    nv = Dh // vw
    declined = Plan(0, 0, 0, -(-BH // PER_ROW_WARPS), 0)
    if not aligned or Dh % vw or not 1 <= nv <= 32 or nv & (nv - 1):
        return declined
    step = 32 // nv
    splits = max(1, min(MAX_SPLITS, -(-cache_len // (SPLIT_STEPS * step))))
    span = -(-cache_len // splits)
    splits = -(-cache_len // span)        # no split left empty
    rows = max(1, min(BULK_WARPS // splits, BH // (ROW_BLOCKS * sms)))
    while rows > 1 and bulk_smem_bytes(rows, splits, span, Dh,
                                       esize) > SMEM_LIMIT:
        rows -= 1
    smem = bulk_smem_bytes(rows, splits, span, Dh, esize)
    if smem > SMEM_LIMIT:
        return declined
    return Plan(rows, splits, span, -(-BH // rows), smem)


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               cache_len: int) -> torch.Tensor:
    """(B*H, 1, Dh) queries against (B*H, Tmax, Dh) caches whose first
    ``cache_len`` positions are filled: f32 scores, scaled after the sum,
    an f32 softmax normalised before it multiplies v in f32, the output in
    ``q.dtype``."""
    Dh = q.shape[-1]
    s = torch.matmul(q.float(), k_cache.float().transpose(1, 2)) * (
        1.0 / Dh ** 0.5)
    filled = torch.arange(k_cache.shape[1], device=q.device) < cache_len
    s = torch.where(filled[None, None, :], s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.matmul(p, v_cache.float()).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: int) -> torch.Tensor:
    """:func:`decode_attention_reference` on a kernel for CUDA tensors
    (the one :func:`decode_attention_plan` picks); ``1 <= cache_len <=
    Tmax``."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, cache_len)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    code = _build.dtype_code(q)
    BH, _, Dh = q.shape
    Tmax = k_cache.shape[1]
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh} outside the kernel's "
                         f"1..{MAX_HEAD_DIM}")
    cache_len = int(cache_len)
    if not 1 <= cache_len <= Tmax:
        raise ValueError(f"cache_len {cache_len} outside 1..{Tmax}")
    dev = q.device
    _build.require(q, "q", dev, q.dtype, (BH, 1, Dh))
    _build.require(k_cache, "k_cache", dev, q.dtype, (BH, Tmax, Dh))
    _build.require(v_cache, "v_cache", dev, q.dtype, (BH, Tmax, Dh))
    out = torch.empty_like(q)
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k_cache, v_cache, out))
    plan = decode_attention_plan(BH, Tmax, Dh, cache_len, q.dtype,
                                 _build.sm_count(dev), aligned)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_decode_attention(
            code, _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
            _build.ptr(out), BH, Tmax, Dh, cache_len, 1.0 / Dh ** 0.5,
            plan.rows, plan.splits, plan.span, plan.smem, _build.stream(q))
    _build.check(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    ROUTES["bulk" if plan.rows else "declined"] += 1
    return out
