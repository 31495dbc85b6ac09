"""Differentiable pre-LN decoder stack on hand-written Hopper kernels.

Port of ``sketchformer_tpu/ops/pallas_decoder_train.py`` (K4):
``fused_decoder_stack_train`` (the teacher-forced stack without its final
LayerNorm, as a ``torch.autograd.Function``) and ``fused_decoder_stack``
(the forward with the final LayerNorm, for eval). Per pre-LN layer: causal
self-attention, cross-attention to the Mq bottleneck memory rows, FFN; three
dropout sites (after each projection back to d_model) from one (3L, B, T, d)
byte tensor.

- forward: ``layernorm_rows`` and ``linear`` (``ops/encoder_stack.py``) and
  ``attention_fwd`` (``ops/attention_train.py``, causal with the key mask
  for self-attention, the memory rows for cross-attention; the normalised p
  is rounded before P.V, as ``_dec_stack_kernel``); each layer's input is
  kept for the backward.
- backward: one layer at a time, newest first (``_dec_layer_bwd_kernel``):
  the layer's forward is recomputed from its input, then ``linear_tn`` /
  ``linear_nt``, ``attention_bwd_q`` / ``attention_bwd_kv`` (self and
  cross) and ``layernorm_bwd``. The gradient of the memory is
  each layer's cross K/V backward rounded to the compute dtype and added,
  in the compute dtype, over the layers (``pallas_decoder_train.py:786``).

Dropout (three sites a layer, 'prng' or 'bits' mode), rounding sites and
weight-gradient dtypes follow ``ops/encoder_stack_train.py``.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from sketchformer_tpu_torch.ops import attention_train as at
from sketchformer_tpu_torch.ops import dropout_prng as dp
from sketchformer_tpu_torch.ops.encoder_stack_train import (
    KERNELS,
    PLAIN,
    StackOps,
    _site,
    keep_scales,
    key_bias_from_mask,
    stack_dropout,
)

DWKEYS = (
    "ln1s", "ln1b", "s_wqkv", "s_bqkv", "s_qns", "s_qnb", "s_kns", "s_knb",
    "s_wo", "s_bo",
    "ln2s", "ln2b", "c_wq", "c_bq", "c_wkv", "c_bkv", "c_qns", "c_qnb",
    "c_kns", "c_knb", "c_wo", "c_bo",
    "ln3s", "ln3b", "w1", "b1", "w2", "b2",
)


def _norms(wl, qk_norm, a):
    if not qk_norm:
        return None
    return tuple(wl[f"{a}_{k}"] for k in ("qns", "qnb", "kns", "knb"))


def _layer_fwd(h, mem, sbias, cbias, drop, wl, *, B, T, num_heads, qk_norm,
               thresh, keep_scale, ops, layer=0):
    """One decoder layer forward on (B*T, d) rows (``drop`` the stack's
    dropout source, this layer's sites at 3 * ``layer`` + k); returns (out,
    parts) with the intermediates the backward reuses."""
    H = num_heads
    dargs = dict(thresh=thresh, keep_scale=keep_scale)
    Mq = mem.shape[0] // B
    h1 = ops.layernorm(h, wl["ln1s"], wl["ln1b"])
    qkv = ops.linear(h1, wl["s_wqkv"], wl["s_bqkv"]).reshape(B, T, -1)
    HD = qkv.shape[-1] // 3
    q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]
    so = ops.attention_fwd(q, k, v, sbias, num_heads=H, causal=True,
                           qk_norm=_norms(wl, qk_norm, "s"),
                           norm_p=True).reshape(B * T, HD)
    x1 = ops.linear(so, wl["s_wo"], wl["s_bo"], residual=h,
                    drop=_site(drop, 3, layer, 0), **dargs)
    h2 = ops.layernorm(x1, wl["ln2s"], wl["ln2b"])
    cq = ops.linear(h2, wl["c_wq"], wl["c_bq"]).reshape(B, T, HD)
    ckv = ops.linear(mem, wl["c_wkv"], wl["c_bkv"]).reshape(B, Mq, 2 * HD)
    ck, cv = ckv[..., :HD], ckv[..., HD:]
    co = ops.attention_fwd(cq, ck, cv, cbias, num_heads=H,
                           qk_norm=_norms(wl, qk_norm, "c"),
                           norm_p=True).reshape(B * T, HD)
    x2 = ops.linear(co, wl["c_wo"], wl["c_bo"], residual=x1,
                    drop=_site(drop, 3, layer, 1), **dargs)
    h3 = ops.layernorm(x2, wl["ln3s"], wl["ln3b"])
    f1 = ops.linear(h3, wl["w1"], wl["b1"], relu=True)
    out = ops.linear(f1, wl["w2"], wl["b2"], residual=x2,
                     drop=_site(drop, 3, layer, 2), **dargs)
    parts = dict(h1=h1, q=q, k=k, v=v, so=so, x1=x1, h2=h2, cq=cq, ck=ck,
                 cv=cv, co=co, x2=x2, h3=h3, f1=f1)
    return out, parts


def decoder_stack_fwd(x, mem, sbias, cbias, drop, w, *, num_heads, qk_norm,
                      thresh, ops: StackOps = KERNELS):
    """The L-layer forward without the final LN: (y (B*T, d), inputs)."""
    B, T, d = x.shape
    L = w["s_wqkv"].shape[0]
    ks_fwd, _ = keep_scales(thresh, x.dtype)
    h = x.contiguous().reshape(B * T, d)
    m = mem.contiguous().reshape(-1, d)
    xins = []
    for i in range(L):
        xins.append(h)
        wl = {k: w[k][i] for k in DWKEYS}
        h, _ = _layer_fwd(h, m, sbias, cbias, drop, wl, B=B, T=T,
                          num_heads=num_heads, qk_norm=qk_norm, thresh=thresh,
                          keep_scale=ks_fwd, ops=ops, layer=i)
    return h, xins


def decoder_layer_bwd(x, mem, g, sbias, cbias, drop, wl, *, num_heads,
                      qk_norm, thresh, dmem=None, layer=0,
                      ops: StackOps = KERNELS):
    """One layer's backward (``_dec_layer_bwd_kernel``): ``x`` (B, T, d) and
    ``g`` (B, T, d) in the compute dtype, ``mem`` (B, Mq, d), ``drop`` the
    stack's dropout source (bytes with this layer's sites at 3 * ``layer``
    + k, a ``PrngDrop``, or None). ``dmem`` is the running memory gradient of the
    later layers (compute dtype) or None. Returns (dx, dmem + this layer's,
    {key: f32 gradient})."""
    B, T, d = x.shape
    M = B * T
    H = num_heads
    Mq = mem.shape[1]
    _, ks = keep_scales(thresh, x.dtype)
    dargs = dict(thresh=thresh, keep_scale=ks)
    masks = [_site(drop, 3, layer, s) for s in range(3)]
    x = x.reshape(M, d)
    g = g.reshape(M, d)
    m = mem.reshape(B * Mq, d)
    # recompute the forward (the recompute scales kept values in f32)
    _, p = _layer_fwd(x, m, sbias, cbias, drop, wl, B=B, T=T, num_heads=H,
                      qk_norm=qk_norm, thresh=thresh, keep_scale=ks, ops=ops,
                      layer=layer)
    HD = p["so"].shape[-1]
    dw = {}
    # FFN: y = x2 + drop(f1 W2 + b2)
    dw["w2"], dw["b2"] = ops.linear_tn(p["f1"], g, drop=masks[2],
                                       bias_grad=True, **dargs)
    dpre1 = ops.linear_nt(g, wl["w2"], drop=masks[2], gate=p["f1"], **dargs)
    dw["w1"], dw["b1"] = ops.linear_tn(p["h3"], dpre1, bias_grad=True)
    dh3 = ops.linear_nt(dpre1, wl["w1"])
    dx2, dw["ln3s"], dw["ln3b"] = ops.layernorm_bwd(p["x2"], dh3, wl["ln3s"],
                                                    resid=g)
    # cross-attention: x2 = x1 + drop(co cWo + cbo)
    dw["c_wo"], dw["c_bo"] = ops.linear_tn(p["co"], dx2, drop=masks[1],
                                           bias_grad=True, **dargs)
    # dO in the compute dtype: the attention backward rounds it so first
    dco = ops.linear_nt(dx2, wl["c_wo"], drop=masks[1], out_dtype=x.dtype,
                        **dargs).reshape(B, T, HD)
    cn = _norms(wl, qk_norm, "c")
    dcq, stats, dw["c_qns"], dw["c_qnb"] = ops.attention_bwd_q(
        p["cq"], p["ck"], p["cv"], dco, cbias, num_heads=H, qk_norm=cn)
    dck, dcv, dw["c_kns"], dw["c_knb"] = ops.attention_bwd_kv(
        p["cq"], p["ck"], p["cv"], dco, cbias, stats, num_heads=H,
        qk_norm=cn)
    dcq = dcq.reshape(M, HD)
    dckv = torch.cat([dck, dcv], dim=-1).reshape(B * Mq, 2 * HD)
    dw["c_wq"], dw["c_bq"] = ops.linear_tn(p["h2"], dcq, bias_grad=True)
    dw["c_wkv"], dw["c_bkv"] = ops.linear_tn(m, dckv, bias_grad=True)
    dmem = ops.linear_nt(dckv, wl["c_wkv"], out_dtype=x.dtype,
                         residual=None if dmem is None
                         else dmem.reshape(B * Mq, d))
    dh2 = ops.linear_nt(dcq, wl["c_wq"])
    dx1, dw["ln2s"], dw["ln2b"] = ops.layernorm_bwd(p["x1"], dh2, wl["ln2s"],
                                                    resid=dx2)
    # self-attention: x1 = x + drop(so sWo + sbo)
    dw["s_wo"], dw["s_bo"] = ops.linear_tn(p["so"], dx1, drop=masks[0],
                                           bias_grad=True, **dargs)
    dso = ops.linear_nt(dx1, wl["s_wo"], drop=masks[0], out_dtype=x.dtype,
                        **dargs).reshape(B, T, HD)
    sn = _norms(wl, qk_norm, "s")
    dq, stats, dw["s_qns"], dw["s_qnb"] = ops.attention_bwd_q(
        p["q"], p["k"], p["v"], dso, sbias, num_heads=H, causal=True,
        qk_norm=sn)
    dk, dv, dw["s_kns"], dw["s_knb"] = ops.attention_bwd_kv(
        p["q"], p["k"], p["v"], dso, sbias, stats, num_heads=H, causal=True,
        qk_norm=sn)
    dqkv = torch.cat([dq, dk, dv], dim=-1).reshape(M, 3 * HD)
    dw["s_wqkv"], dw["s_bqkv"] = ops.linear_tn(p["h1"], dqkv,
                                               bias_grad=True)
    dh1 = ops.linear_nt(dqkv, wl["s_wqkv"])
    dx, dw["ln1s"], dw["ln1b"] = ops.layernorm_bwd(x, dh1, wl["ln1s"],
                                                   resid=dx1,
                                                   out_dtype=x.dtype)
    if not qk_norm:
        for key in ("s_qns", "s_qnb", "s_kns", "s_knb", "c_qns", "c_qnb",
                    "c_kns", "c_knb"):
            dw[key] = torch.zeros_like(wl[key], dtype=torch.float32)
    return dx.reshape(B, T, d), dmem.reshape(B, Mq, d), dw


def decoder_layer_bwd_reference(x, mem, g, sbias, cbias, drop, wl, **kw):
    """:func:`decoder_layer_bwd` on the plain versions, any device."""
    return decoder_layer_bwd(x, mem, g, sbias, cbias, drop, wl, ops=PLAIN,
                             **kw)


class _DecoderStackTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mem, sbias, cbias, drop, meta, *wlist):
        num_heads, qk_norm, thresh, ops = meta
        w = dict(zip(DWKEYS, wlist))
        y, xins = decoder_stack_fwd(x, mem, sbias, cbias, drop, w,
                                    num_heads=num_heads, qk_norm=qk_norm,
                                    thresh=thresh, ops=ops)
        ctx.meta = meta
        ctx.shape = x.shape
        ctx.num_layers = len(xins)
        ctx.prng = drop if isinstance(drop, dp.PrngDrop) else None
        ctx.save_for_backward(mem, sbias, cbias, None if ctx.prng else drop,
                              *xins, *wlist)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, gy):
        num_heads, qk_norm, thresh, ops = ctx.meta
        saved = ctx.saved_tensors
        mem, sbias, cbias, drop = saved[:4]
        drop = ctx.prng or drop
        L = ctx.num_layers
        xins = saved[4:4 + L]
        w = dict(zip(DWKEYS, saved[4 + L:]))
        B, T, d = ctx.shape
        g = gy.to(xins[0].dtype).contiguous().reshape(B, T, d)
        mem = mem.contiguous()
        dmem = None
        dws = [None] * L
        for i in reversed(range(L)):
            wl = {k: w[k][i] for k in DWKEYS}
            g, dmem, dws[i] = decoder_layer_bwd(
                xins[i].reshape(B, T, d), mem, g, sbias, cbias, drop, wl,
                num_heads=num_heads, qk_norm=qk_norm, thresh=thresh,
                dmem=dmem, layer=i, ops=ops)
        grads = [torch.stack([dw[k] for dw in dws]).to(w[k].dtype)
                 for k in DWKEYS]
        return (g, dmem.to(mem.dtype), None, None, None, None, *grads)


def fused_decoder_stack_train(
    x: torch.Tensor,
    memory: torch.Tensor,
    self_key_mask: Optional[torch.Tensor],
    cross_key_mask: Optional[torch.Tensor],
    w: Mapping[str, torch.Tensor],
    *,
    num_heads: int,
    qk_norm: bool = False,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    dropout_bytes: Optional[torch.Tensor] = None,
    dropout_impl: str = "auto",
    seed: Optional[int] = None,
    ops: StackOps = KERNELS,
) -> torch.Tensor:
    """Differentiable causal decoder stack WITHOUT the final LayerNorm
    (apply ``encoder_stack_train.apply_final_ln`` after). ``memory`` (B, Mq,
    d); masks (B, T) / (B, Mq) bool or None; ``w`` from
    ``convert.stacked_decoder_weights(..., grad=True)``; dropout as
    ``fused_encoder_stack_train`` ((3L, B, T, d) bytes given, 'prng' from
    ``seed`` or 'bits' from ``generator``)."""
    B, T, d = x.shape
    L = w["s_wqkv"].shape[0]
    if T > at.MAX_KEYS:
        raise ValueError(f"T={T} exceeds the fused limit {at.MAX_KEYS}")
    thresh, drop = stack_dropout(dropout_rate, dropout_impl, seed, generator,
                                 dropout_bytes, (3 * L, B, T, d), x.device)
    return _DecoderStackTrain.apply(
        x, memory, key_bias_from_mask(self_key_mask),
        key_bias_from_mask(cross_key_mask), drop,
        (num_heads, qk_norm, thresh, ops), *[w[k] for k in DWKEYS])


def fused_decoder_stack(x, memory, self_key_mask, cross_key_mask, w, *,
                        num_heads, qk_norm=False, ops: StackOps = KERNELS):
    """Forward-only decoder stack WITH the final LayerNorm (the eval loss;
    ``fused_decoder_stack`` of the JAX package)."""
    B, T, d = x.shape
    if T > at.MAX_KEYS:
        raise ValueError(f"T={T} exceeds the fused limit {at.MAX_KEYS}")
    y, _ = decoder_stack_fwd(x, memory, key_bias_from_mask(self_key_mask),
                             key_bias_from_mask(cross_key_mask), None, w,
                             num_heads=num_heads, qk_norm=qk_norm, thresh=0,
                             ops=ops)
    y = ops.layernorm(y, w["lnfs"].reshape(-1), w["lnfb"].reshape(-1))
    return y.reshape(B, T, d)

