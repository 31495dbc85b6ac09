"""The plain Sketchformer the benchmark holds the program to.

Written from the model's equations in plain torch, in float32 unless a
lower precision is asked for (the control of the output checks). It
imports nothing of the program: the parameters are a flat dict keyed by
the names :func:`param_specs` lists, which are the program's
``state_dict`` names, and the benchmark makes them and hands the same dict
to both sides.

The model (pre-LN, as the configurations state ``norm_first``):

- input: token lookup, or a dense projection of stroke rows, times
  sqrt(d), plus the sinusoidal position table;
- encoder: L layers of x += drop(MHA(LN1 x)); x += drop(FFN(LN2 x)), then
  a final LayerNorm; keys masked where the token is PAD (or the row is
  past the sketch's length);
- bottleneck: num_queries learned queries attend to the encoder output,
  the result flattened and projected to z (lowerdim); the decoder memory
  is z projected back to (num_queries, d);
- decoder: L layers of causal self-attention, cross-attention to the
  memory and the FFN, each pre-LN with a residual, then a final LayerNorm;
- heads: token logits, or the raw MDN parameters (6M + 3); a classifier
  MLP on z (ReLU, dropout) over the classes;
- LayerNorm: eps 1e-6, variance E[x^2] - mu^2 clamped at 0; the qk-norm
  is a LayerNorm over a head's width with one scale and bias for all
  heads; attention logits are q k^T / sqrt(Dh), masked to -1e9.

Departures from the program, by design: everything is float32 (the
program rounds every product's operands to bfloat16 and keeps LayerNorm
statistics and losses in float32), dropout's kept values are scaled by
the float32 1 / keep (the program's fused forward rounds that scale to the
compute dtype), and the attention softmax is taken over whole rows.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

NEG_INF = -1e9
LN_EPS = 1e-6
PAD_ID, SOS_ID, EOS_ID = 0, 1, 2
PEN_END = 2
SOS_ROW = (0.0, 0.0, 0.0, 1.0, 0.0)
LOG_SIGMA_MIN, LOG_SIGMA_MAX, RHO_MAX = -6.0, 4.0, 0.99

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# precision of the products
# ---------------------------------------------------------------------------


def exact(x: torch.Tensor) -> torch.Tensor:
    return x


class _Fp8Round(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale that maps the largest
    magnitude to 448; the gradient is rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 448.0 / amax
    return ((x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale)


class _Bf16Round(torch.autograd.Function):
    """Round to bfloat16; the gradient is rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Every product's operands in bfloat16, the configurations' precision
    (a witness of what that rounding alone moves)."""
    return _Bf16Round.apply(x)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Every product's operands in float8."""
    return _Fp8Round.apply(x)


def int8_round(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = 127.0 / amax
    return torch.round(x * scale).clamp(-127, 127) / scale


class _Int8Round(torch.autograd.Function):
    """Round to int8 with a per-tensor scale that maps the largest
    magnitude to 127; the gradient is rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return int8_round(x)

    @staticmethod
    def backward(ctx, g):
        return int8_round(g)


def int8(x: torch.Tensor) -> torch.Tensor:
    """Every product's operands in int8."""
    return _Int8Round.apply(x)


# the controls a cell's limits file can name (``"control"``)
CONTROLS = {"float8": fp8, "int8": int8}


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def param_specs(cfg: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, kind, std) of every parameter: kind 'normal' (drawn,
    times std), 'zeros' or 'ones'. Kernels have std 1/sqrt(fan_in), the
    token tables 1/sqrt(d), the bottleneck queries 0.02."""
    d, H, L, dff = cfg["d_model"], cfg["num_heads"], cfg["num_layers"], \
        cfg["dff"]
    Dh = d // H
    low, nq, V, C = cfg["lowerdim"], cfg["num_queries"], cfg["vocab_size"], \
        cfg["num_classes"]
    out: List[Tuple[str, Tuple[int, ...], str, float]] = []

    def dense(name, i, o):
        out.append((name + ".kernel", (i, o), "normal", i ** -0.5))
        out.append((name + ".bias", (o,), "zeros", 0.0))

    def ln(name, n):
        out.append((name + ".scale", (n,), "ones", 0.0))
        out.append((name + ".bias", (n,), "zeros", 0.0))

    def mha(name, qk_norm):
        for p in ("query", "key", "value"):
            out.append((f"{name}.{p}.kernel", (d, H, Dh), "normal", d ** -0.5))
            out.append((f"{name}.{p}.bias", (H, Dh), "zeros", 0.0))
        if qk_norm:
            ln(name + ".q_norm", Dh)
            ln(name + ".k_norm", Dh)
        out.append((name + ".out.kernel", (H, Dh, d), "normal", d ** -0.5))
        out.append((name + ".out.bias", (d,), "zeros", 0.0))

    if cfg["use_continuous"]:
        dense("enc_embed.proj", 3, d)
        dense("dec_embed.proj", 5, d)
        dense("out_head.proj", d, 6 * cfg["num_mixtures"] + 3)
    else:
        out.append(("enc_embed.embed.embedding", (V, d), "normal", d ** -0.5))
        out.append(("dec_embed.embed.embedding", (V, d), "normal", d ** -0.5))
        dense("out_head.proj", d, V)
    qk = cfg["qk_norm"]
    for i in range(L):
        p = f"encoder.layer_{i}"
        ln(p + ".ln1", d)
        mha(p + ".self_attn", qk)
        ln(p + ".ln2", d)
        dense(p + ".ffn.in", d, dff)
        dense(p + ".ffn.out", dff, d)
    ln("encoder.ln_out", d)
    out.append(("bottleneck.queries", (nq, d), "normal", 0.02))
    mha("bottleneck.pool_attn", False)
    dense("bottleneck.to_z", nq * d, low)
    dense("bottleneck.expand", low, nq * d)
    for i in range(L):
        p = f"decoder.layer_{i}"
        ln(p + ".ln1", d)
        mha(p + ".self_attn", qk)
        ln(p + ".ln2", d)
        mha(p + ".cross_attn", qk)
        ln(p + ".ln3", d)
        dense(p + ".ffn.in", d, dff)
        dense(p + ".ffn.out", dff, d)
    ln("decoder.ln_out", d)
    dense("classifier.fc1", low, low)
    dense("classifier.fc2", low, C)
    return out


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def layer_norm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def position_table(T: int, d: int, device) -> torch.Tensor:
    pos = np.arange(T, dtype=np.float32)[:, None]
    i = np.arange(d, dtype=np.float32)[None, :]
    angles = pos / np.power(10000.0, (2 * (i // 2)) / d)
    table = np.zeros((T, d), dtype=np.float32)
    table[:, 0::2] = np.sin(angles[:, 0::2])
    table[:, 1::2] = np.cos(angles[:, 1::2])
    return torch.from_numpy(table).to(device)


class Reference:
    """The model over the parameters ``P`` in the precision ``q`` (a
    rounding of every product's operands). ``drop`` is a
    ``philox.StepDropout`` in training, None in serving."""

    def __init__(self, cfg: dict, P: Params, q: Callable = exact,
                 drop=None) -> None:
        self.cfg = cfg
        self.P = P
        self.q = q
        self.drop = drop
        self.d = cfg["d_model"]
        self.H = cfg["num_heads"]

    # --- pieces --------------------------------------------------------------

    def mm(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def dense(self, x, name):
        k = self.P[name + ".kernel"]
        return self.mm(x, k.reshape(k.shape[0], -1)) + \
            self.P[name + ".bias"].reshape(-1)

    def ln(self, x, name):
        return layer_norm(x, self.P[name + ".scale"], self.P[name + ".bias"])

    def mha(self, name, xq, xkv, key_mask=None, causal=False, qk_norm=False):
        B, Tq, _ = xq.shape
        Tk = xkv.shape[1]
        H, Dh = self.H, self.d // self.H

        def heads(x, p, T):
            return self.dense(x, f"{name}.{p}").reshape(B, T, H, Dh)

        q, k, v = heads(xq, "query", Tq), heads(xkv, "key", Tk), \
            heads(xkv, "value", Tk)
        if qk_norm:
            q = self.ln(q, name + ".q_norm")
            k = self.ln(k, name + ".k_norm")
        q = q * (1.0 / math.sqrt(Dh))
        logits = torch.einsum("bqhd,bkhd->bhqk", self.q(q), self.q(k))
        mask = None
        if key_mask is not None:
            mask = key_mask[:, None, None, :]
        if causal:
            tri = torch.ones((Tq, Tk), dtype=torch.bool,
                             device=xq.device).tril()[None, None]
            mask = tri if mask is None else mask & tri
        if mask is not None:
            logits = torch.where(mask, logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", self.q(p), self.q(v))
        out = self.mm(o.reshape(B, Tq, H * Dh),
                      self.P[name + ".out.kernel"].reshape(H * Dh, self.d))
        return out + self.P[name + ".out.bias"]

    def ffn(self, x, name):
        return self.dense(torch.relu(self.dense(x, name + ".in")),
                          name + ".out")

    def embed(self, x, name):
        T = x.shape[1]
        if self.cfg["use_continuous"]:
            e = self.dense(x, name + ".proj")
        else:
            e = self.P[name + ".embed.embedding"][x.long()]
        return e * math.sqrt(self.d) + position_table(T, self.d, e.device)

    # --- the model -----------------------------------------------------------

    def encode(self, enc, enc_key):
        """(z, memory) of a sketch batch; ``enc_key`` (B, T) bool."""
        cfg = self.cfg
        x = self.embed(enc, "enc_embed")
        stack = None
        if self.drop is not None:
            x = self.drop.composed(x)
            stack = self.drop.stack()
        for i in range(cfg["num_layers"]):
            p = f"encoder.layer_{i}"
            h = self.ln(x, p + ".ln1")
            a = self.mha(p + ".self_attn", h, h, key_mask=enc_key,
                         qk_norm=cfg["qk_norm"])
            x = x + (a if stack is None else stack.site(a, i, 0))
            f = self.ffn(self.ln(x, p + ".ln2"), p + ".ffn")
            x = x + (f if stack is None else stack.site(f, i, 1))
        x = self.ln(x, "encoder.ln_out")
        B = x.shape[0]
        nq = cfg["num_queries"]
        queries = self.P["bottleneck.queries"].expand(B, nq, self.d)
        pooled = self.mha("bottleneck.pool_attn", queries, x, key_mask=enc_key)
        if self.drop is not None:
            pooled = self.drop.composed(pooled)
        z = self.dense(pooled.reshape(B, nq * self.d), "bottleneck.to_z")
        memory = self.dense(z, "bottleneck.expand").reshape(B, nq, self.d)
        return z, memory

    def decode(self, dec_in, memory, dec_key):
        """Teacher-forced decoder output (B, T, d); ``dec_key`` (B, T)."""
        cfg = self.cfg
        x = self.embed(dec_in, "dec_embed")
        stack = None
        if self.drop is not None:
            x = self.drop.composed(x)
            stack = self.drop.stack()
        for i in range(cfg["num_layers"]):
            p = f"decoder.layer_{i}"
            h = self.ln(x, p + ".ln1")
            a = self.mha(p + ".self_attn", h, h, key_mask=dec_key,
                         causal=True, qk_norm=cfg["qk_norm"])
            x = x + (a if stack is None else stack.site(a, i, 0))
            c = self.mha(p + ".cross_attn", self.ln(x, p + ".ln2"), memory,
                         qk_norm=cfg["qk_norm"])
            x = x + (c if stack is None else stack.site(c, i, 1))
            f = self.ffn(self.ln(x, p + ".ln3"), p + ".ffn")
            x = x + (f if stack is None else stack.site(f, i, 2))
        return self.ln(x, "decoder.ln_out")

    def head(self, y):
        return self.dense(y, "out_head.proj")

    def classify(self, z):
        h = torch.relu(self.dense(z, "classifier.fc1"))
        if self.drop is not None:
            h = self.drop.composed(h)
        return self.dense(h, "classifier.fc2")


# ---------------------------------------------------------------------------
# batches and losses
# ---------------------------------------------------------------------------


def full_batch(packed: Dict[str, torch.Tensor], continuous: bool
               ) -> Dict[str, torch.Tensor]:
    """The training batch a packed one stands for: token ids shifted right
    behind SOS, or stroke rows with their masks, pen targets and the
    decoder's input rows (SOS row, then each row's (dx, dy) and one-hot
    pen state, zeroed past the END target)."""
    enc = packed["enc"]
    out = dict(packed)
    if not continuous:
        out["dec_in"] = torch.cat(
            [torch.full_like(enc[:, :1], SOS_ID), enc[:, :-1]], dim=1)
        out["dec_tgt"] = enc
        out["enc_key"] = enc != PAD_ID
        out["dec_key"] = out["dec_in"] != PAD_ID
        return out
    n = packed["n"].long()
    B, T = enc.shape[:2]
    pos = torch.arange(T, device=enc.device)[None, :]
    real = pos < n[:, None]
    dec_mask = (pos < (n + 1)[:, None]).float()
    tgt_xy = enc[..., :2].float()
    tgt_pen = torch.where(real, (enc[..., 2] >= 0.5).long(),
                          torch.full_like(pos, PEN_END))
    pen_oh = torch.nn.functional.one_hot(tgt_pen[:, :-1], 3).float()
    pen_oh = pen_oh * dec_mask[:, :-1, None]
    sos = torch.tensor(SOS_ROW, device=enc.device).expand(B, 1, 5)
    out.update(
        enc_key=real, dec_key=dec_mask > 0.5, dec_mask=dec_mask,
        tgt_xy=tgt_xy, tgt_pen=tgt_pen,
        dec_in=torch.cat([sos, torch.cat([tgt_xy[:, :-1], pen_oh], -1)], 1))
    return out


def denominators(batch, continuous: bool) -> Tuple[float, float]:
    """The weight sums the batch's means divide by (reconstruction,
    classification), clamped at 1."""
    if continuous:
        m = batch["dec_mask"].sum()
    else:
        m = (batch["dec_tgt"] != PAD_ID).sum()
    return max(float(m), 1.0), max(float(batch["enc"].shape[0]), 1.0)


def mdn_nll(raw, M, tgt_xy, tgt_pen, mask):
    """Summed (GMM NLL, pen CE) over the masked positions."""
    mu = torch.stack([raw[..., M:2 * M], raw[..., 2 * M:3 * M]], dim=-1)
    log_sigma = torch.stack([raw[..., 3 * M:4 * M], raw[..., 4 * M:5 * M]],
                            dim=-1).clamp(LOG_SIGMA_MIN, LOG_SIGMA_MAX)
    log_pi = torch.log_softmax(raw[..., :M], dim=-1)
    rho = RHO_MAX * torch.tanh(raw[..., 5 * M:6 * M])
    norm = (tgt_xy[..., None, :] - mu) * torch.exp(-log_sigma)
    nx, ny = norm[..., 0], norm[..., 1]
    one_m = torch.clamp(1.0 - rho ** 2, min=1e-6)
    zq = nx * nx + ny * ny - 2.0 * rho * nx * ny
    comp = (-zq / (2.0 * one_m) - log_sigma.sum(-1) - 0.5 * torch.log(one_m)
            - math.log(2.0 * math.pi))
    nll_xy = -torch.logsumexp(log_pi + comp, dim=-1)
    pen_ll = torch.log_softmax(raw[..., 6 * M:], dim=-1)
    nll_pen = -pen_ll.gather(-1, tgt_pen[..., None])[..., 0]
    return (nll_xy * mask).sum(), (nll_pen * mask).sum()


def train_loss(ref: Reference, b: Dict[str, torch.Tensor],
               denoms: Tuple[float, float]) -> torch.Tensor:
    """This block of rows' share of the step's loss: reconstruction and
    classification sums over the whole batch's denominators."""
    cfg = ref.cfg
    z, memory = ref.encode(b["enc"], b["enc_key"])
    y = ref.decode(b["dec_in"], memory, b["dec_key"])
    raw = ref.head(y)
    if cfg["use_continuous"]:
        xy, pen = mdn_nll(raw, cfg["num_mixtures"], b["tgt_xy"], b["tgt_pen"],
                          b["dec_mask"])
        recon = xy + pen
    else:
        mask = (b["dec_tgt"] != PAD_ID).float()
        ll = torch.log_softmax(raw, dim=-1).gather(
            -1, b["dec_tgt"].long()[..., None])[..., 0]
        recon = -(ll * mask).sum()
    logits = ref.classify(z)
    cls = -torch.log_softmax(logits, dim=-1).gather(
        -1, b["label"].long()[:, None])[:, 0].sum()
    return recon / denoms[0] + cls / denoms[1]


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def noam_rate(count: int, d_model: int, warmup: int, peak: float) -> float:
    step = torch.tensor(max(float(count), 1.0), dtype=torch.float32)
    return float(peak * d_model ** -0.5 * torch.minimum(
        step ** -0.5, step * warmup ** -1.5))


class Adam:
    """Global-norm clipping (at 1), then Adam (0.9, 0.98, 1e-9) at the Noam
    rate of the count before the update."""

    def __init__(self, params: Params, d_model: int, warmup: int,
                 peak: float) -> None:
        self.d_model, self.warmup, self.peak = d_model, warmup, peak
        self.count = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def update(self, params: Params, grads: Params) -> Params:
        """The clipped gradients the moments took; updates ``params`` in
        place."""
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())
                          ).float()
        lr = noam_rate(self.count, self.d_model, self.warmup, self.peak)
        self.count += 1
        b1, b2, eps = 0.9, 0.98, 1e-9
        clipped = {}
        for k, p in params.items():
            g = grads[k]
            g = g if norm < 1.0 else g / norm
            clipped[k] = g
            self.m[k].mul_(b1).add_(g * (1 - b1))
            self.v[k].mul_(b2).add_(g * g * (1 - b2))
            m_hat = self.m[k] / (1 - b1 ** self.count)
            v_hat = self.v[k] / (1 - b2 ** self.count)
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + eps))
        return clipped
