"""Pre-LN encoder stack forward on hand-written Hopper kernels.

Port of ``sketchformer_tpu/ops/pallas_encoder.py::fused_encoder_stack``
(body ``_stack_kernel``), the kernel that carries embedding extraction. The
TPU kernel runs all L layers in one call with the activations resident in
VMEM; on the card the layer runs as three kernels from
``csrc/encoder_stack.cu`` (see the note at the top of that file for why):

    linear             QKV, out-proj + x, FFN-in -> ReLU, FFN-out + x,
                       with an optional dropout epilogue (the training
                       stacks' forward)
    encoder_attention  optional qk-norm, key-masked softmax, P.V
    layernorm_rows     LN1, LN2 and the final LayerNorm

and the two products of the training stacks' backward (``linear_nt``:
dX = dY . W^T, ``linear_tn``: dW = X^T . dY summed over every row). A
dropout operand is a u8 byte tensor ('bits' mode) or a
``dropout_prng.PrngSite``, whose bytes the kernel draws itself ('prng'
mode; the plain versions materialise them with the plain Philox).

Each kernel has a wrapper here and a plain torch version beside it
(``*_reference``) that computes the same math in the same rounding order.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. ``encoder_stack_reference`` is the whole
stack on the plain versions; it is the oracle the CPU tests hold to the JAX
kernel and that ``chip_smoke.py`` holds the kernels to on the card.

``LAUNCHES`` counts kernel launches per wrapper (only where a kernel is
actually launched), so a run can show that its path went through them.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch

from sketchformer_tpu_torch.models.layers import layer_norm
from sketchformer_tpu_torch.ops import _build
from sketchformer_tpu_torch.ops import dropout_prng as dp

NEG_INF = -1e9
MAX_FUSED_LEN = 1024    # the JAX engine's limit (pallas_encoder.py)
MAX_HEAD_DIM = 128      # encoder_attention keeps head rows in registers

LAUNCHES = {"linear": 0, "encoder_attention": 0, "layernorm_rows": 0,
            "linear_nt": 0, "linear_tn": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def linear_tn_reference(x, y, *, drop=None, thresh=0, keep_scale=1.0):
    """``x^T @ y`` over all rows (dW = X^T . dY) in f32; ``y`` times its
    dropout mask is rounded to ``x.dtype`` first."""
    yv = y.float()
    if drop is not None:
        yv = yv * dropout_mask(drop, thresh, keep_scale, yv)
    return torch.matmul(x.float().t(), yv.to(x.dtype).float())


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


def layernorm_rows_reference(x, scale, bias):
    return layer_norm(x, scale, bias, x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def linear(a, w, bias, *, relu=False, residual=None, drop=None, thresh=0,
           keep_scale=1.0):
    """(M, K) x (K, N) with the fused bias / ReLU / dropout / residual
    epilogue."""
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
    out = torch.empty((M, N), dtype=a.dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_linear(code, _build.ptr(a), _build.ptr(w),
                            _build.ptr(bias), _build.ptr(residual),
                            _build.ptr(dbytes), *prng, int(thresh),
                            float(keep_scale), _build.ptr(out), M, N, K,
                            int(relu), _build.stream(a))
    _build.check(err, "linear")
    LAUNCHES["linear"] += 1
    dp.note_launch(drop)
    return out


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
    out = torch.empty((M, K), dtype=out_dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_linear_nt(
            code, int(a.dtype == torch.float32), _build.ptr(a), _build.ptr(w),
            _build.ptr(dbytes), *prng, int(thresh), float(keep_scale),
            _build.ptr(gate), _build.ptr(residual),
            int(out_dtype == torch.float32), _build.ptr(out), M, N, K,
            _build.stream(a))
    _build.check(err, "linear_nt")
    LAUNCHES["linear_nt"] += 1
    dp.note_launch(drop)
    return out


TN_ROWS_PER_SPLIT = 512   # linear_tn's M slice per block, at least


def tn_splits(M, K, N, sms=132):
    """How many M slices linear_tn runs: enough blocks for about two waves
    of the card's SMs, each slice at least TN_ROWS_PER_SPLIT rows."""
    tiles = -(-K // 64) * -(-N // 64)
    return max(1, min(M // TN_ROWS_PER_SPLIT, -(-2 * sms // tiles)))


def linear_tn(x, y, *, drop=None, thresh=0, keep_scale=1.0):
    """(M, K)^T x (M, N) -> (K, N) f32 over all M rows: the weight-gradient
    product of a layer's backward. M is cut into slices that run in
    parallel; ``sum_rows`` adds their partial products in a fixed order."""
    if x.device.type == "cpu":
        return linear_tn_reference(x, y, drop=drop, thresh=thresh,
                                   keep_scale=keep_scale)
    if x.device.type != "cuda":
        raise ValueError(f"linear_tn: unsupported device {x.device}")
    from sketchformer_tpu_torch.ops.norm_train import sum_rows

    code = _build.dtype_code(x)
    M, K = x.shape
    N = y.shape[1]
    dev = x.device
    if y.dtype not in (torch.float32, x.dtype):
        raise TypeError(f"linear_tn: y is {y.dtype}")
    _build.require(x, "x", dev, x.dtype, (M, K))
    _build.require(y, "y", dev, y.dtype, (M, N))
    dbytes, *prng = dp.kernel_args(drop, M, N, dev)
    splits = tn_splits(M, K, N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = torch.empty((splits, K, N), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_linear_tn(
            code, int(y.dtype == torch.float32), _build.ptr(x), _build.ptr(y),
            _build.ptr(dbytes), *prng, int(thresh), float(keep_scale),
            _build.ptr(out), M, K, N, splits, _build.stream(x))
    _build.check(err, "linear_tn")
    LAUNCHES["linear_tn"] += 1
    dp.note_launch(drop)
    if splits == 1:
        return out[0]
    return sum_rows(out.reshape(splits, K * N)).reshape(K, N)


def encoder_attention(qkv, key_bias, *, num_heads, qk_norm=None):
    """Key-masked multi-head self-attention over a (B, T, 3*H*Dh) pane."""
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
    out = torch.empty((B, T, HD), dtype=qkv.dtype, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_encoder_attention(
            code, _build.ptr(qkv), _build.ptr(key_bias),
            *(_build.ptr(p) for p in norms), _build.ptr(out), B, T, H, Dh,
            1.0 / Dh ** 0.5, _build.stream(qkv))
    _build.check(err, "encoder_attention")
    LAUNCHES["encoder_attention"] += 1
    return out


def layernorm_rows(x, scale, bias):
    """Row LayerNorm of a (M, D) tensor, output in ``x.dtype``."""
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
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_layernorm_rows(code, _build.ptr(x), _build.ptr(scale),
                                    _build.ptr(bias), _build.ptr(out), M, D,
                                    _build.stream(x))
    _build.check(err, "layernorm_rows")
    LAUNCHES["layernorm_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# the stack
# ---------------------------------------------------------------------------


def _run_stack(x, key_mask, w, *, num_heads, qk_norm, lin: Callable,
               attn: Callable, norm: Callable):
    B, T, d = x.shape
    if T > MAX_FUSED_LEN:
        raise ValueError(f"T={T} exceeds fused limit {MAX_FUSED_LEN}")
    L = w["wqkv"].shape[0]
    key_bias = None
    if key_mask is not None:
        key_bias = torch.where(
            key_mask.to(torch.bool),
            torch.zeros((), dtype=torch.float32, device=x.device),
            torch.full((), NEG_INF, dtype=torch.float32, device=x.device))
    h = x.contiguous().reshape(B * T, d)
    for i in range(L):
        qkv = lin(norm(h, w["ln1s"][i], w["ln1b"][i]), w["wqkv"][i],
                  w["bqkv"][i])
        norms = ((w["qns"][i], w["qnb"][i], w["kns"][i], w["knb"][i])
                 if qk_norm else None)
        o = attn(qkv.reshape(B, T, -1), key_bias, num_heads=num_heads,
                 qk_norm=norms)
        h = lin(o.reshape(B * T, -1), w["wo"][i], w["bo"][i], residual=h)
        f = lin(norm(h, w["ln2s"][i], w["ln2b"][i]), w["w1"][i], w["b1"][i],
                relu=True)
        h = lin(f, w["w2"][i], w["b2"][i], residual=h)
    y = norm(h, w["lnfs"].reshape(-1), w["lnfb"].reshape(-1))
    return y.reshape(B, T, d)


def fused_encoder_stack(x: torch.Tensor, key_mask: Optional[torch.Tensor],
                        w: Mapping[str, torch.Tensor], *, num_heads: int,
                        qk_norm: bool = False) -> torch.Tensor:
    """The full pre-LN encoder stack plus final LN, on the kernels.

    ``x`` (B, T, d) in the compute dtype; ``key_mask`` (B, T) bool, True =
    attend, or None; ``w`` from :func:`stack_encoder_weights`. CPU tensors
    run the plain versions (same result as :func:`encoder_stack_reference`).
    """
    return _run_stack(x, key_mask, w, num_heads=num_heads, qk_norm=qk_norm,
                      lin=linear, attn=encoder_attention,
                      norm=layernorm_rows)


def encoder_stack_reference(x, key_mask, w, *, num_heads, qk_norm=False):
    """:func:`fused_encoder_stack` on the plain torch versions, any device."""
    return _run_stack(x, key_mask, w, num_heads=num_heads, qk_norm=qk_norm,
                      lin=linear_reference, attn=attention_reference,
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
