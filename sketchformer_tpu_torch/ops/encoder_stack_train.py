"""Differentiable pre-LN encoder stack on hand-written Hopper kernels.

Port of ``sketchformer_tpu/ops/pallas_encoder_train.py::
fused_encoder_stack_train`` (K3): the stack without its final LayerNorm,
as a ``torch.autograd.Function``.

- forward: the inference stack's kernels (``ops/encoder_stack.py``:
  ``layernorm_rows``, ``linear``, ``encoder_attention``, as the TPU forward
  reuses ``_stack_kernel``) with the two dropout sites per layer in
  ``linear``'s epilogue. The only saved activations are each layer's input
  x_i (the tensors the loop already holds) and the dropout bytes.
- backward: one layer at a time, newest first (``_layer_bwd`` of the TPU
  kernel). Each layer recomputes LN / QKV / attention / FFN from x_i on the
  kernels, then runs the backward on ``linear_tn`` (each weight gradient
  with its bias gradient in one launch) / ``linear_nt``
  (``ops/encoder_stack.py``), ``attention_bwd_q`` / ``attention_bwd_kv``
  (``ops/attention_train.py``) and ``layernorm_bwd``
  (``ops/norm_train.py``).
- the final ``ln_out`` stays outside the Function: :func:`apply_final_ln`,
  a plain differentiable torch LayerNorm.

Dropout: the u8-threshold semantics of ``models/dropout.py``, two sites a
layer (after the attention and after the FFN), in one of the JAX package's
two modes (``dropout_impl``):

- 'prng' (the default on the card): every kernel that reads a site draws
  its bytes itself from the stack's 64-bit seed (``ops/dropout_prng.py``,
  K7), so no byte tensor exists; on the CPU the plain versions draw the
  same bytes with the plain Philox.
- 'bits' (the default on the CPU): one (2L, B, T, d) byte tensor, drawn
  from a ``torch.Generator`` or handed in by the caller, read by the
  forward and the backward. A 'prng' stack equals the 'bits' stack fed
  ``emit_dropout_bits`` of its seed, bit for bit.

The forward scales kept values by the keep scale rounded to the compute
dtype, the recompute and the gradient masks by the f32 one, as the TPU
kernels do.

Weight gradients come back from the kernels in f32 and are returned in the
dtype of the weights the Function was given (the compute dtype for the
products' matrices), which is where the JAX VJP rounds them
(``pallas_encoder_train.py:537``); autograd widens them to the f32
parameters.

``StackOps`` names the kernels a stack runs; :data:`KERNELS` are the
wrappers (which run their plain versions on CPU tensors) and :data:`PLAIN`
the plain versions on any device, which is how ``chip_smoke.py`` holds the
whole stack to its plain version on the card.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple, Optional

import torch

from sketchformer_tpu_torch.models.layers import layer_norm
from sketchformer_tpu_torch.ops import attention_train as at
from sketchformer_tpu_torch.ops import dropout_prng as dp
from sketchformer_tpu_torch.ops import encoder_stack as es
from sketchformer_tpu_torch.ops import norm_train as nt

WKEYS = ("ln1s", "ln1b", "wqkv", "bqkv", "qns", "qnb", "kns", "knb",
         "wo", "bo", "ln2s", "ln2b", "w1", "b1", "w2", "b2")


class StackOps(NamedTuple):
    linear: Callable
    layernorm: Callable
    encoder_attention: Callable
    attention_fwd: Callable
    attention_bwd_q: Callable
    attention_bwd_kv: Callable
    linear_nt: Callable
    linear_tn: Callable
    layernorm_bwd: Callable


KERNELS = StackOps(es.linear, es.layernorm_rows, es.encoder_attention,
                   at.attention_fwd, at.attention_bwd_q, at.attention_bwd_kv,
                   es.linear_nt, es.linear_tn, nt.layernorm_bwd)
PLAIN = StackOps(es.linear_reference, es.layernorm_rows_reference,
                 es.attention_reference, at.attention_fwd_reference,
                 at.attention_bwd_q_reference, at.attention_bwd_kv_reference,
                 es.linear_nt_reference, es.linear_tn_reference,
                 nt.layernorm_bwd_reference)


def keep_scales(thresh: int, dtype: torch.dtype):
    """(forward scale rounded to the compute dtype, f32 scale) of the
    u8-threshold dropout: 1 / (1 - thresh / 256)."""
    ks = 1.0 / (1.0 - thresh / 256.0)
    return float(torch.tensor(ks, dtype=torch.float32).to(dtype)), ks


# calls of draw_dropout_bytes (a 'prng' stack on the card makes none)
DRAWS = {"draw_dropout_bytes": 0}


def draw_dropout_bytes(generator: torch.Generator, shape, device):
    """Uniform u8 bytes from ``generator`` (PyTorch's default generator of
    the device when None), one tensor for every site of a 'bits' stack."""
    DRAWS["draw_dropout_bytes"] += 1
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                         generator=generator, device=device)


def stack_dropout(rate, dropout_impl, seed, generator, dropout_bytes, shape,
                  device):
    """(thresh, the stack's dropout source): None, the (L * nsites, B, T,
    d) bytes (given, or drawn from ``generator`` in 'bits' mode), or a
    ``dropout_prng.PrngDrop`` of ``seed`` in 'prng' mode (a seed drawn
    from PyTorch's CPU generator when None)."""
    thresh = int(round(rate * 256))
    if thresh <= 0:
        return 0, None
    if dropout_bytes is None and dp.resolve_impl(dropout_impl,
                                                 device) == "prng":
        if seed is None:
            seed = int(torch.randint(0, 2 ** 62, (1,)).item())
        return thresh, dp.PrngDrop(int(seed), shape[2])
    if dropout_bytes is None:
        dropout_bytes = draw_dropout_bytes(generator, shape, device)
    if tuple(dropout_bytes.shape) != tuple(shape):
        raise ValueError(f"dropout_bytes {tuple(dropout_bytes.shape)}, "
                         f"expected {tuple(shape)}")
    return thresh, dropout_bytes


def key_bias_from_mask(key_mask: Optional[torch.Tensor]):
    """(B, T) bool key mask -> (B, T) f32 additive bias (0 / -1e9)."""
    if key_mask is None:
        return None
    return torch.where(key_mask.to(torch.bool), 0.0, es.NEG_INF).float()


def _norms(wl, qk_norm, prefix=""):
    if not qk_norm:
        return None
    return tuple(wl[prefix + k] for k in ("qns", "qnb", "kns", "knb"))


def _site(drop, nsites, layer, k):
    """Site k of ``layer``'s dropout operand: a (B*T, d) view of the bytes,
    a ``PrngSite``, or None."""
    if drop is None:
        return None
    if isinstance(drop, dp.PrngDrop):
        return drop.site(layer, k)
    return drop[layer * nsites + k].reshape(-1, drop.shape[-1])


# ---------------------------------------------------------------------------
# one layer
# ---------------------------------------------------------------------------


def encoder_stack_fwd(x, key_bias, drop, w, *, num_heads, qk_norm, thresh,
                      ops: StackOps = KERNELS):
    """The L-layer forward without the final LN (``_stack_kernel`` with
    ``collect_inputs``): returns (y (B*T, d), [x_0 .. x_{L-1}])."""
    B, T, d = x.shape
    L = w["wqkv"].shape[0]
    ks_fwd, _ = keep_scales(thresh, x.dtype)
    h = x.contiguous().reshape(B * T, d)
    xins = []
    for i in range(L):
        xins.append(h)
        qkv = ops.linear(ops.layernorm(h, w["ln1s"][i], w["ln1b"][i]),
                         w["wqkv"][i], w["bqkv"][i])
        o = ops.encoder_attention(
            qkv.reshape(B, T, -1), key_bias, num_heads=num_heads,
            qk_norm=_norms({k: w[k][i] for k in ("qns", "qnb", "kns", "knb")},
                           qk_norm))
        h = ops.linear(o.reshape(B * T, -1), w["wo"][i], w["bo"][i],
                       residual=h, drop=_site(drop, 2, i, 0), thresh=thresh,
                       keep_scale=ks_fwd)
        f = ops.linear(ops.layernorm(h, w["ln2s"][i], w["ln2b"][i]),
                       w["w1"][i], w["b1"][i], relu=True)
        h = ops.linear(f, w["w2"][i], w["b2"][i], residual=h,
                       drop=_site(drop, 2, i, 1), thresh=thresh,
                       keep_scale=ks_fwd)
    return h, xins


def encoder_layer_bwd(x, g, key_bias, drop, wl, *, num_heads, qk_norm,
                      thresh, layer=0, ops: StackOps = KERNELS):
    """One layer's backward (``_layer_bwd_kernel``): ``x`` (B, T, d) the
    layer's input, ``g`` (B, T, d) the gradient of its output, both in the
    compute dtype; ``drop`` the stack's dropout source (bytes with the
    layer's two sites at 2 * ``layer`` + k, a ``PrngDrop``, or None);
    ``wl`` this layer's weights (1-D parameters as (n,) rows). Returns (dx
    in the compute dtype, {key: f32 gradient})."""
    B, T, d = x.shape
    M = B * T
    H = num_heads
    _, ks = keep_scales(thresh, x.dtype)
    dargs = dict(thresh=thresh, keep_scale=ks)
    m_attn, m_ffn = _site(drop, 2, layer, 0), _site(drop, 2, layer, 1)
    norms = _norms(wl, qk_norm)
    x = x.reshape(M, d)
    g = g.reshape(M, d)
    # recompute the forward
    h1 = ops.layernorm(x, wl["ln1s"], wl["ln1b"])
    qkv = ops.linear(h1, wl["wqkv"], wl["bqkv"]).reshape(B, T, -1)
    HD = qkv.shape[-1] // 3
    q, k, v = qkv[..., :HD], qkv[..., HD:2 * HD], qkv[..., 2 * HD:]
    o = ops.attention_fwd(q, k, v, key_bias, num_heads=H, qk_norm=norms,
                          norm_p=True).reshape(M, HD)
    x1 = ops.linear(o, wl["wo"], wl["bo"], residual=x, drop=m_attn, **dargs)
    h2 = ops.layernorm(x1, wl["ln2s"], wl["ln2b"])
    f1 = ops.linear(h2, wl["w1"], wl["b1"], relu=True)
    dw = {}
    # FFN: y = x1 + drop(relu(LN2(x1) W1 + b1) W2 + b2)
    dw["w2"], dw["b2"] = ops.linear_tn(f1, g, drop=m_ffn, bias_grad=True,
                                       **dargs)
    dpre1 = ops.linear_nt(g, wl["w2"], drop=m_ffn, gate=f1, **dargs)
    dw["w1"], dw["b1"] = ops.linear_tn(h2, dpre1, bias_grad=True)
    dh2 = ops.linear_nt(dpre1, wl["w1"])
    dx1, dw["ln2s"], dw["ln2b"] = ops.layernorm_bwd(x1, dh2, wl["ln2s"],
                                                    resid=g)
    # attention: x1 = x + drop(attn Wo + bo)
    dw["wo"], dw["bo"] = ops.linear_tn(o, dx1, drop=m_attn, bias_grad=True,
                                       **dargs)
    # dO in the compute dtype: the attention backward rounds it so first
    do = ops.linear_nt(dx1, wl["wo"], drop=m_attn, out_dtype=x.dtype,
                       **dargs).reshape(B, T, HD)
    dq, stats, dw["qns"], dw["qnb"] = ops.attention_bwd_q(
        q, k, v, do, key_bias, num_heads=H, qk_norm=norms)
    dk, dv, dw["kns"], dw["knb"] = ops.attention_bwd_kv(
        q, k, v, do, key_bias, stats, num_heads=H, qk_norm=norms)
    dqkv = torch.cat([dq, dk, dv], dim=-1).reshape(M, 3 * HD)
    dw["wqkv"], dw["bqkv"] = ops.linear_tn(h1, dqkv, bias_grad=True)
    dh1 = ops.linear_nt(dqkv, wl["wqkv"])
    dx, dw["ln1s"], dw["ln1b"] = ops.layernorm_bwd(x, dh1, wl["ln1s"],
                                                   resid=dx1,
                                                   out_dtype=x.dtype)
    if not qk_norm:
        for key in ("qns", "qnb", "kns", "knb"):
            dw[key] = torch.zeros_like(wl[key], dtype=torch.float32)
    return dx.reshape(B, T, d), dw


def encoder_layer_bwd_reference(x, g, key_bias, drop, wl, *, num_heads,
                                qk_norm, thresh, layer=0):
    """:func:`encoder_layer_bwd` on the plain versions, any device."""
    return encoder_layer_bwd(x, g, key_bias, drop, wl, num_heads=num_heads,
                             qk_norm=qk_norm, thresh=thresh, layer=layer,
                             ops=PLAIN)


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------


class _EncoderStackTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, key_bias, drop, meta, *wlist):
        num_heads, qk_norm, thresh, ops = meta
        w = dict(zip(WKEYS, wlist))
        y, xins = encoder_stack_fwd(x, key_bias, drop, w,
                                    num_heads=num_heads, qk_norm=qk_norm,
                                    thresh=thresh, ops=ops)
        ctx.meta = meta
        ctx.shape = x.shape
        ctx.prng = drop if isinstance(drop, dp.PrngDrop) else None
        ctx.save_for_backward(key_bias, None if ctx.prng else drop, *xins,
                              *wlist)
        ctx.num_layers = len(xins)
        return y.reshape(x.shape)

    @staticmethod
    def backward(ctx, gy):
        num_heads, qk_norm, thresh, ops = ctx.meta
        saved = ctx.saved_tensors
        key_bias, drop = saved[0], ctx.prng or saved[1]
        L = ctx.num_layers
        xins = saved[2:2 + L]
        wlist = saved[2 + L:]
        w = dict(zip(WKEYS, wlist))
        B, T, d = ctx.shape
        g = gy.to(xins[0].dtype).contiguous().reshape(B, T, d)
        dws = [None] * L
        for i in reversed(range(L)):
            wl = {k: w[k][i] for k in WKEYS}
            g, dws[i] = encoder_layer_bwd(
                xins[i].reshape(B, T, d), g, key_bias, drop, wl,
                num_heads=num_heads, qk_norm=qk_norm, thresh=thresh, layer=i,
                ops=ops)
        grads = [torch.stack([dw[k] for dw in dws]).to(w[k].dtype)
                 for k in WKEYS]
        return (g, None, None, None, *grads)


def fused_encoder_stack_train(
    x: torch.Tensor,
    key_mask: Optional[torch.Tensor],
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
    """Differentiable encoder stack WITHOUT the final LayerNorm.

    ``x`` (B, T, d) in the compute dtype; ``key_mask`` (B, T) bool (True =
    attend) or None; ``w`` from ``stack_encoder_weights(..., grad=True)``.
    With ``dropout_rate > 0``: given ``dropout_bytes`` ((2L, B, T, d) u8)
    run 'bits' mode; otherwise ``dropout_impl`` ('auto' = 'prng' on the
    card, 'bits' on the CPU) draws the bytes in the kernels from ``seed``
    ('prng') or from ``generator`` (the device's default generator when
    None; 'bits'). Apply :func:`apply_final_ln` after.
    """
    B, T, d = x.shape
    L = w["wqkv"].shape[0]
    thresh, drop = stack_dropout(dropout_rate, dropout_impl, seed, generator,
                                 dropout_bytes, (2 * L, B, T, d), x.device)
    if T > at.MAX_KEYS:
        raise ValueError(f"T={T} exceeds the fused limit {at.MAX_KEYS}")
    return _EncoderStackTrain.apply(
        x, key_bias_from_mask(key_mask), drop, (num_heads, qk_norm, thresh,
                                                ops),
        *[w[k] for k in WKEYS])


def apply_final_ln(y: torch.Tensor, w: Mapping[str, torch.Tensor]):
    """The stack's ``ln_out`` as a plain differentiable LayerNorm (f32
    statistics), to pair with the train stacks."""
    return layer_norm(y, w["lnfs"].reshape(-1), w["lnfb"].reshape(-1),
                      y.dtype)
