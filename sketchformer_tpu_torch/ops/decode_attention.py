"""Single-position attention against a head-folded KV cache.

Port of ``sketchformer_tpu/ops/pallas_decode.py::decode_attention``, the
self-attention of the composed AR decode path when ``attn_impl='pallas'``
(``models/attention.py::cached_decode_attention``). The kernel is
``csrc/decode_attention.cu``; ``decode_attention_reference`` is its plain
torch version, in the same f32 math as the TPU kernel. A wrapper given CPU
tensors runs the plain version; given CUDA tensors it launches the kernel
or raises. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import torch

from sketchformer_tpu_torch.ops import _build

NEG_INF = -1e9
MAX_HEAD_DIM = 128      # the kernel keeps a head row in registers

LAUNCHES = {"decode_attention": 0}


def reset_launches() -> None:
    LAUNCHES["decode_attention"] = 0


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
    """:func:`decode_attention_reference` on the kernel for CUDA tensors;
    ``1 <= cache_len <= Tmax``."""
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
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_decode_attention(
            code, _build.ptr(q), _build.ptr(k_cache), _build.ptr(v_cache),
            _build.ptr(out), BH, Tmax, Dh, cache_len, 1.0 / Dh ** 0.5,
            _build.stream(q))
    _build.check(err, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
