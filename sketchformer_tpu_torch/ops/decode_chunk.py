"""Greedy AR decode, K whole steps per launch, on hand-written Hopper kernels.

Port of ``sketchformer_tpu/ops/pallas_decode_loop.py``
(``fused_decode_chunk``, ``fused_decode_cont_chunk``) and of their
lane-packed small-head variants in ``pallas_decode_packed.py``, which fold
into the same kernels here (head_dim is a template width of
``csrc/decode_chunk.cu``). Beside each wrapper is its plain torch version
(``*_reference``) with the same rounding sites; ``precompute_cross_kv`` is
the port of ``pallas_decode_stack.precompute_cross_kv`` (plain torch, as it
is plain jnp in the JAX package).

Interface, for a batch of B rows and a chunk of K steps from position
``t0``: ``k_cache``/``v_cache`` are head-folded ``(L, B*H, Tmax, Dh)`` in the
compute dtype; the K new rows of each layer, at positions ``[t0, t0 + K)``,
are written into them in place (the TPU kernel returns them for the
caller to scatter). ``prev``/``finished`` are ``(B,)`` int32. A wrapper
given CPU tensors runs the plain version; given CUDA tensors it launches
the kernel or raises. ``LAUNCHES`` counts kernel launches and ``ROUTES``
which kernel took them: in bfloat16 the cluster kernel on the plan of
:func:`cluster_plan` (the batch as the products' rows, a thread block
cluster a row group, the products on the tensor cores), and the per-row
FMA kernel for float32 and for what :func:`cluster_decline` names (among
it a head not padded once to whole 16-column tiles by :func:`pad_head`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F

from sketchformer_tpu_torch.models.layers import layer_norm
from sketchformer_tpu_torch.ops import _build

NEG_INF = -1e9
MAX_HEAD_DIM = 128      # the kernel keeps a head row in registers

# stacked decoder weights in the order the kernel's Trunk struct reads them
# (the JAX kernel's _LOOP_WKEYS)
TRUNK_KEYS = ("ln1s", "ln1b", "s_wqkv", "s_bqkv", "s_qns", "s_qnb",
              "s_kns", "s_knb", "s_wo", "s_bo",
              "ln2s", "ln2b", "c_wq", "c_bq", "c_qns", "c_qnb",
              "c_wo", "c_bo", "ln3s", "ln3b", "w1", "b1", "w2", "b2",
              "lnfs", "lnfb")
_PRODUCT_KEYS = ("s_wqkv", "s_wo", "c_wq", "c_wo", "w1", "w2")

LAUNCHES = {"decode_chunk": 0, "decode_cont_chunk": 0}
ROUTES = {"cluster": 0, "rows": 0}
# the cluster kernel's kinds (csrc/decode_chunk.cu): a token chunk, an MDN
# chunk, a whole decoder step (ops/decode_step.py)
KIND_TOKEN, KIND_MDN, KIND_STEP = 0, 1, 2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in ROUTES:
        ROUTES[k] = 0


def precompute_cross_kv(memory: torch.Tensor, w: Mapping[str, torch.Tensor],
                        *, num_heads: int, qk_norm: bool = False):
    """(B, Mq, d) bottleneck memory -> folded (L, B*H, Mq, Dh) cross K and
    V in the compute dtype, K already qk-normed (as MultiHeadAttention
    computes them): ``dt(memory @ W) + dt(bias)``."""
    L = w["c_wkv"].shape[0]
    B, Mq, d = memory.shape
    HD = w["c_wkv"].shape[2] // 2
    H = num_heads
    Dh = HD // H
    dt = memory.dtype
    ks, vs = [], []
    for i in range(L):
        kv = (torch.matmul(memory.reshape(B * Mq, d), w["c_wkv"][i])
              + w["c_bkv"][i].to(dt)).reshape(B, Mq, 2 * HD)
        k = kv[..., :HD].reshape(B, Mq, H, Dh)
        v = kv[..., HD:].reshape(B, Mq, H, Dh)
        if qk_norm:
            k = layer_norm(k, w["c_kns"][i], w["c_knb"][i], dt)
        ks.append(k.transpose(1, 2).reshape(B * H, Mq, Dh))
        vs.append(v.transpose(1, 2).reshape(B * H, Mq, Dh))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _mm(a, b):
    """f32 product of compute-dtype values (exact products, f32 sums)."""
    return torch.matmul(a.float(), b.float())


def _attend(q, k, v, *, scale, normalized):
    """(B, H, Dh) f32 queries over (B, H, n, Dh) dt keys/values; products
    of dtype values rounded to the dtype, f32 sums. Self-attention rounds
    the unnormalised exponentials and divides after P.V; cross-attention
    (``normalized``) rounds the normalised weights."""
    dt = k.dtype
    s = (k * q.to(dt)[:, :, None, :]).float().sum(-1) * scale
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    denom = e.sum(dim=-1, keepdim=True)
    p = e / denom if normalized else e
    o = (p.to(dt)[..., None] * v).float().sum(-2)
    return o if normalized else o / denom


def _attend_new(q, kn, vn, k, v, *, scale):
    """decode_step's self-attention: (B, H, Dh) f32 queries over the (B, H,
    t, Dh) dt cache rows, as :func:`_attend`, and the new position's f32
    key and value ``kn`` / ``vn``, entered before any rounding."""
    dt = k.dtype
    s = (k * q.to(dt)[:, :, None, :]).float().sum(-1) * scale
    s_new = (q * kn).sum(-1, keepdim=True) * scale
    m = s_new if s.shape[-1] == 0 else torch.maximum(
        s.amax(dim=-1, keepdim=True), s_new)
    e = torch.exp(s - m)
    e_new = torch.exp(s_new - m)
    ctx = (e.to(dt)[..., None] * v).float().sum(-2)
    return (ctx + e_new * vn) / (e.sum(dim=-1, keepdim=True) + e_new)


def _trunk_reference(x, t, k_cache, v_cache, cross_k, cross_v, w, *,
                     num_heads, qk_norm, new_rows=None):
    """One position ``t`` of a (B, d) dt batch through the L layers and the
    final LayerNorm. Writes each layer's k/v row at ``t`` into the caches
    and attends to it there; with a list ``new_rows`` (decode_step), reads
    the caches' rows [0, t) only, attends to the new row in f32 and appends
    each layer's (k, v) row, in the compute dtype, to the list."""
    B, d = x.shape
    dt = x.dtype
    f32 = torch.float32
    L = w["s_wqkv"].shape[0]
    HD = w["s_wqkv"].shape[2] // 3
    H = num_heads
    Dh = HD // H
    Tmax = k_cache.shape[2]
    scale = 1.0 / Dh ** 0.5
    for i in range(L):
        kc = k_cache[i].view(B, H, Tmax, Dh)
        vc = v_cache[i].view(B, H, Tmax, Dh)
        h = layer_norm(x, w["ln1s"][i], w["ln1b"][i], dt)
        qkv = _mm(h, w["s_wqkv"][i]) + w["s_bqkv"][i]
        q, kn, vn = (p.reshape(B, H, Dh) for p in qkv.split(HD, dim=-1))
        if qk_norm:
            q = layer_norm(q, w["s_qns"][i], w["s_qnb"][i], f32)
            kn = layer_norm(kn, w["s_kns"][i], w["s_knb"][i], f32)
        if new_rows is None:
            kc[:, :, t] = kn.to(dt)
            vc[:, :, t] = vn.to(dt)
            o = _attend(q, kc[:, :, :t + 1], vc[:, :, :t + 1], scale=scale,
                        normalized=False)
        else:
            new_rows.append((kn.to(dt), vn.to(dt)))
            o = _attend_new(q, kn, vn, kc[:, :, :t], vc[:, :, :t],
                            scale=scale)
        x = x + (_mm(o.reshape(B, HD).to(dt), w["s_wo"][i])
                 + w["s_bo"][i]).to(dt)
        h = layer_norm(x, w["ln2s"][i], w["ln2b"][i], dt)
        cq = (_mm(h, w["c_wq"][i]) + w["c_bq"][i]).reshape(B, H, Dh)
        if qk_norm:
            cq = layer_norm(cq, w["c_qns"][i], w["c_qnb"][i], f32)
        Mq = cross_k.shape[2]
        o = _attend(cq, cross_k[i].view(B, H, Mq, Dh),
                    cross_v[i].view(B, H, Mq, Dh), scale=scale,
                    normalized=True)
        x = x + (_mm(o.reshape(B, HD).to(dt), w["c_wo"][i])
                 + w["c_bo"][i]).to(dt)
        h = layer_norm(x, w["ln3s"][i], w["ln3b"][i], dt)
        f = torch.relu(_mm(h, w["w1"][i]) + w["b1"][i]).to(dt)
        x = x + (_mm(f, w["w2"][i]) + w["b2"][i]).to(dt)
    return layer_norm(x, w["lnfs"][0], w["lnfb"][0], dt)


def _masked_head_bias(head_b, pad_id, sos_id):
    """The PAD/SOS logit mask folded into the f32 head bias (as the TPU
    kernel's wrapper does): those lanes read logit - 1e9."""
    lane = torch.arange(head_b.shape[0], device=head_b.device)
    return torch.where((lane == pad_id) | (lane == sos_id),
                       head_b.float() + NEG_INF, head_b.float())


def tie_margin(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The gap between the two largest values of each row of ``x`` over the
    gap below which a kernel and its plain version may pick differently:
    1e-3 in float32, one bfloat16 ulp of the row's largest value in
    bfloat16. A margin below 1 marks a near tie."""
    top = x.float().topk(2, dim=-1).values
    gap = top[..., 0] - top[..., 1]
    if dtype == torch.float32:
        return gap / 1e-3
    # |v| in [2^(e-1), 2^e) has a bf16 ulp of 2^(e-8)
    ulp = torch.ldexp(torch.ones_like(gap),
                      torch.frexp(top[..., 0]).exponent - 8)
    return gap / ulp


def decode_chunk_reference(prev, finished, k_cache, v_cache, cross_k,
                           cross_v, emb, pos_chunk, head_w, head_b, w, t0, *,
                           num_heads, qk_norm=False, pad_id=0, sos_id=1,
                           eos_id=2, return_margins=False):
    """K greedy token steps (K = ``pos_chunk.shape[0]``) from position
    ``t0``. Returns ``(ids (B, K) int32, finished (B,) int32)``, plus each
    step's (B, K) :func:`tie_margin` of the logits with
    ``return_margins``."""
    K, d = pos_chunk.shape
    B = prev.shape[0]
    dt = emb.dtype
    sqrt_d = torch.tensor(d ** 0.5, dtype=dt, device=emb.device)
    hb = _masked_head_bias(head_b, pad_id, sos_id)
    hw = head_w.float()
    ids = torch.empty((B, K), dtype=torch.int32, device=prev.device)
    margins = torch.empty((B, K), dtype=torch.float32, device=prev.device)
    fin = finished.clone()
    for j in range(K):
        x = emb[prev.long()] * sqrt_d + pos_chunk[j]
        h = _trunk_reference(x, t0 + j, k_cache, v_cache, cross_k, cross_v,
                             w, num_heads=num_heads, qk_norm=qk_norm)
        logits = torch.matmul(h.float(), hw).to(dt).float() + hb
        margins[:, j] = tie_margin(logits, dt)
        nxt = logits.argmax(dim=-1).to(torch.int32)   # first index of max
        nxt = torch.where(fin != 0, pad_id, nxt)
        fin = torch.where(nxt == eos_id, 1, fin)
        ids[:, j] = nxt
        prev = nxt
    return (ids, fin, margins) if return_margins else (ids, fin)


def decode_cont_chunk_reference(prev_row, finished, k_cache, v_cache,
                                cross_k, cross_v, in_w, in_b, pos_chunk,
                                head_w, head_b, w, t0, *, num_heads,
                                num_mixtures, qk_norm=False, pen_end=2,
                                return_margins=False):
    """K greedy MDN steps from position ``t0``: the argmax component's mean
    and the argmax pen state. ``prev_row`` is the (B, 5) f32 last stroke
    row. Returns ``(xy (B, K, 2) f32, pen (B, K) int32, valid (B, K) int32,
    finished (B,) int32)``, plus the (B, K) smaller of the component and
    pen :func:`tie_margin` with ``return_margins``."""
    K, d = pos_chunk.shape
    B = prev_row.shape[0]
    M = num_mixtures
    dt = in_w.dtype
    dev = prev_row.device
    sqrt_d = torch.tensor(d ** 0.5, dtype=dt, device=dev)
    hw = head_w.float()
    xy = torch.empty((B, K, 2), dtype=torch.float32, device=dev)
    pens = torch.empty((B, K), dtype=torch.int32, device=dev)
    valid = torch.empty((B, K), dtype=torch.int32, device=dev)
    margins = torch.empty((B, K), dtype=torch.float32, device=dev)
    fin = finished.clone()
    row = prev_row.float()
    for j in range(K):
        x = _mm(row.to(dt), in_w).to(dt) + in_b.to(dt)
        x = x * sqrt_d + pos_chunk[j]
        h = _trunk_reference(x, t0 + j, k_cache, v_cache, cross_k, cross_v,
                             w, num_heads=num_heads, qk_norm=qk_norm)
        raw = (torch.matmul(h.float(), hw).to(dt) + head_b.to(dt)).float()
        margins[:, j] = torch.minimum(tie_margin(raw[:, :M], dt),
                                      tie_margin(raw[:, 6 * M:6 * M + 3], dt))
        comp = raw[:, :M].argmax(dim=-1)
        pen = raw[:, 6 * M:6 * M + 3].argmax(dim=-1).to(torch.int32)
        mu = raw.gather(1, torch.stack([M + comp, 2 * M + comp], dim=1))
        done = fin != 0
        pen = torch.where(done, pen_end, pen)
        mu = torch.where(done[:, None], 0.0, mu)
        fin = torch.where(pen == pen_end, 1, fin)
        xy[:, j] = mu
        pens[:, j] = pen
        valid[:, j] = (~done).to(torch.int32)
        row = torch.cat([mu, F.one_hot(pen.long(), 3).float()], dim=-1)
    out = (xy, pens, valid, fin)
    return out + (margins,) if return_margins else out


# ---------------------------------------------------------------------------
# the bf16 cluster kernel's plan (csrc/decode_chunk.cu, decode_cluster_kernel)
# ---------------------------------------------------------------------------

# bytes of dynamic shared memory a block may use: 232,448 less the static
# ring mbarriers
SMEM_LIMIT = 232_448 - 128
CLUSTER_SIZES = (16, 8)  # blocks a cluster, in order of preference
MAX_CLUSTER = 16
MAX_GROUP = 64           # rows a cluster (its buffers fit a block at d=256)
WARPS = 8
TILE = 16                # columns and rows of one mma tile
MAX_TILES = 16           # 16-column tiles of one slice (a 256-column box)
# the kernel's CPlan struct: these ints in order, then ``ldw`` (the six
# products' slice widths), ``cols`` (column boundaries of the C blocks'
# slices, MAX_CLUSTER + 1 a kind: the six products, then the head) and
# ``split`` (inner-dimension ways by tiles of a slice, MAX_TILES + 1 a
# depth: d, then dff)
PLAN_KEYS = ("C", "G", "NS", "slot", "pofs", "bmax", "hcols", "Np",
             "ld_hs", "ld_act", "slots", "o_xs", "o_hs", "o_act", "o_own",
             "o_state", "o_sc", "o_ring", "o_lbuf", "o_cand", "o_mdn",
             "total")
PLAN_INTS = len(PLAN_KEYS) + 6 + 7 * (MAX_CLUSTER + 1) + 2 * (MAX_TILES + 1)


def product_shapes(d: int, dff: int):
    """(inner dimension, columns) of a layer's six products in the
    kernel's order: QKV, out-projection, cross q, cross out-projection,
    FFN in, FFN out."""
    return ((d, 3 * d), (d, d), (d, d), (d, d), (d, dff), (dff, d))


def split_columns(N: int, C: int):
    """Block c's columns of an N-wide product (N a multiple of 16):
    ``(start, count)`` for c < C, whole 16-column tiles, as even as the
    tiles allow (a block may get none)."""
    units = N // TILE
    return [(TILE * (c * units // C),
             TILE * ((c + 1) * units // C - c * units // C))
            for c in range(C)]


def plan_slices(plan: Mapping, kind: int):
    """The blocks' ``(start, count)`` columns of product ``kind`` (6: the
    head) as the kernel reads them from the plan."""
    cols = plan["cols"][kind]
    return [(cols[c], cols[c + 1] - cols[c]) for c in range(plan["C"])]


def split_ways(G: int, nc: int, Kd: int) -> int:
    """How many ways the kernel splits the inner dimension Kd of a G x nc
    slice: doubling while the 16 x 16 tiles times the ways stay within the
    warps and the ways divide Kd's 16-row steps."""
    items, ks, S = (G // TILE) * (nc // TILE), Kd // TILE, 1
    while items and 2 * S * items <= WARPS and ks % (2 * S) == 0:
        S *= 2
    return S


def pair_owner(r: int, h: int, H: int, C: int):
    """(block, slot) of the group's (row r, head h) pair: the block that
    gets the pair's q, k and v values in f32, applies qk-norm, writes its
    k/v cache row and attends, one warp a slot."""
    p = r * H + h
    return p % C, p // C


def _align(n: int, to: int = 128) -> int:
    return -(-n // to) * to


def _layout(C, G, NS, *, d, H, dff, Np, Tmax, Mq, cont):
    """The plan's strides, ring, slices and shared-memory offsets (bytes)
    for clusters of C blocks holding G rows with an NS-slot weight ring;
    Np = 0 lays out the step kind, which has no head (hcols 0), no head
    buffers and no pick state."""
    Dh = d // H
    shapes = product_shapes(d, dff)
    slices = [split_columns(N, C) for _, N in shapes] + [
        split_columns(Np, C)]
    ldw = [max(nc for _, nc in s) for s in slices[:6]]

    # a ring slot holds the largest (K, ldw) bf16 slice of the six
    # products as its TMA boxes land, then from pofs its f32 parameters:
    # the bias slice (bmax floats), the LayerNorm before the product (2 d)
    # and the qk-norm's (4 Dh); slots 128-byte aligned
    trunk = max(K * w for (K, _), w in zip(shapes, ldw))
    hcols = min(max(nc for _, nc in slices[6]), 256,
                max(TILE, TILE * (trunk // d // TILE)))
    pofs = _align(max(trunk, d * hcols), 64)
    bmax = max(*ldw, hcols)
    # the partial tiles of a split product: S ways of a slice's tiles
    split = [[split_ways(G, TILE * n, K) for n in range(MAX_TILES + 1)]
             for K in (d, dff)]
    partials = max((S * (G // TILE) * n * TILE * TILE * 4
                    for row in split for n, S in enumerate(row)
                    if S > 1 and TILE * n <= bmax), default=0)
    plan = dict(C=C, G=G, NS=NS,
                slot=_align(pofs + 2 * (bmax + 2 * d + 4 * Dh), 64),
                pofs=pofs, bmax=bmax, hcols=hcols, Np=Np, ld_hs=d + 8,
                ld_act=max(d, dff) + 8, slots=-(-G * H // C), ldw=ldw,
                cols=[[c0 for c0, _ in s] + [s[-1][0] + s[-1][1]]
                      * (MAX_CLUSTER + 1 - C) for s in slices],
                split=split)
    token = not cont and Np > 0
    lbuf = G * hcols * 4 if token else 0          # a head chunk's logits
    cand = C * G * 8 if token else 0              # the blocks' argmaxes
    mdn = G * Np * 2 if cont else 0               # the MDN head rows
    # the head's buffers share act, which no block writes in the head phase
    act = max(G * plan["ld_act"] * 2, _align(lbuf) + cand, mdn)
    sizes = (("o_xs", G * d * 2), ("o_hs", G * plan["ld_hs"] * 2),
             # own: the pairs' f32 q, k, v; in the broadcast products'
             # phases the block's staged output tile (G x bmax bf16)
             ("o_act", act),
             ("o_own", max(plan["slots"] * 3 * Dh * 4, G * bmax * 2)),
             # prev, fin, the stroke row (5), the head's best (value, index)
             ("o_state", G * 9 * 4 if Np else 0),
             # the attention's score and output rows, or a split product's
             # partial tiles
             ("o_sc", max(WARPS * (max(Tmax, Mq) + Dh) * 4, partials)),
             ("o_ring", NS * plan["slot"] * 2))
    off = 0
    for key, size in sizes:
        plan[key] = off
        off += _align(size)
    plan["o_lbuf"] = plan["o_mdn"] = plan["o_act"]
    plan["o_cand"] = plan["o_act"] + _align(lbuf)
    plan["total"] = off
    return plan


def plan_ints(plan: Mapping) -> list:
    """The plan as the kernel's CPlan ints."""
    out = [plan[k] for k in PLAN_KEYS] + list(plan["ldw"])
    for row in (*plan["cols"], *plan["split"]):
        out += row
    assert len(out) == PLAN_INTS
    return out


def cluster_plan(B: int, *, d: int, H: int, dff: int, N: int, Tmax: int,
                 Mq: int, cont: bool, max_clusters: Mapping[int, int]
                 ) -> Optional[dict]:
    """The cluster kernel's plan for a batch of B rows, or None if no
    plan fits a block's shared memory.

    ``max_clusters[C]`` is how many clusters of C blocks the card runs at
    once (``cluster_fit``). The rows go in groups of G (a multiple of 16,
    at most MAX_GROUP), one cluster a group: the first cluster size in
    CLUSTER_SIZES whose smallest G that runs the whole batch in one wave
    fits the shared memory, with a three-slot ring where it fits, else
    two; failing that, the largest G that fits, in several waves. Np is
    the head's width N in whole 16-column tiles (the kernel takes the head
    so padded: :func:`pad_head`); N = 0 plans the step kind (one decoder
    step, no head: ``decode_step``)."""
    Np = _align(N, TILE)
    geo = dict(d=d, H=H, dff=dff, Np=Np, Tmax=Tmax, Mq=Mq, cont=cont)

    def fitting(C, G):
        for NS in (3, 2):
            plan = _layout(C, G, NS, **geo)
            if plan["total"] <= SMEM_LIMIT:
                return plan
        return None

    def usable(C):    # clusters the card runs, slices a TMA box holds
        return (max_clusters.get(C, 0) > 0
                and max(nc for _, nc in split_columns(3 * d, C)) <= 256)

    for C in filter(usable, CLUSTER_SIZES):
        G = TILE * -(-B // (TILE * max_clusters[C]))
        plan = fitting(C, G) if G <= MAX_GROUP else None
        if plan is not None:
            return plan
    for C in filter(usable, CLUSTER_SIZES):
        for G in range(min(MAX_GROUP, TILE * -(-B // TILE)), 0, -TILE):
            plan = fitting(C, G)
            if plan is not None:
                return plan
    return None


def cluster_decline(dtype, *, d: int, H: int, dff: int, N: int,
                    aligned: bool) -> Optional[str]:
    """Why a chunk stays on the per-row kernel, or None when the cluster
    kernel takes it (a head_dim above MAX_HEAD_DIM raises for both)."""
    if dtype != torch.bfloat16:
        return "float32 keeps the per-row FMA kernel"
    if N % TILE:
        return ("the head's width must be a multiple of 16 (pad it once "
                "with pad_head)")
    if d % TILE or dff % TILE:
        return "d and dff must be multiples of 16 (the mma tiles)"
    if any(k > 512 or (k > 256 and k % 256) for k in (d, dff)):
        return "d and dff must be at most 256, or 512 (two TMA boxes)"
    Dh = d // H
    if Dh % 8 or (Dh // 8) & (Dh // 8 - 1):
        return "head_dim must be 8 times a power of two (16-byte k/v rows)"
    if not aligned:
        return "an operand is not 16-byte aligned"
    return None


def pad_head(head_w: torch.Tensor, head_b: torch.Tensor, *, cont: bool):
    """The (d, N) head and its (N,) bias padded to whole 16-column tiles,
    once, as the cluster kernel takes them: zero weight columns, and bias
    lanes that no pick reads (-inf on the token head, whose argmax then
    never takes them; 0 on the MDN head, whose picks read only its first
    6M+3 columns)."""
    pad = _align(head_b.shape[0], TILE) - head_b.shape[0]
    return (F.pad(head_w, (0, pad)),
            F.pad(head_b, (0, pad), value=0.0 if cont else -math.inf))


@functools.cache
def cluster_fit(device_index: int, kind: int) -> dict:
    """{C: clusters of C blocks at the most shared memory that the card
    runs at once} for the cluster kernel of ``kind`` (KIND_TOKEN, KIND_MDN,
    KIND_STEP), by cudaOccupancyMaxActiveClusters. A card may refuse the non-portable size
    16 (then 0); an error at a portable size raises."""
    lib = _build.library()
    out = {}
    with torch.cuda.device(device_index):
        for C in CLUSTER_SIZES:
            n = ctypes.c_int(0)
            err = lib.sk_decode_cluster_fit(int(kind), C, SMEM_LIMIT,
                                            ctypes.byref(n))
            if C <= 8:
                _build.check(err, "decode_cluster_fit")
            out[C] = n.value if err == 0 else 0
    return out


def cluster_barrier_probe(device, C: int, clusters: int, iters: int) -> None:
    """Launch ``iters`` back-to-back cluster barriers in each of
    ``clusters`` clusters of C blocks on ``device`` (no counter: a probe
    that times one barrier of the cluster kernel's chain)."""
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.sk_cluster_barrier_probe(
            C, clusters, iters, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "cluster_barrier_probe")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def check_trunk(w, k_cache, v_cache, cross_k, cross_v, *, B, d, t0, K,
                num_heads, dtype, device):
    """Check the trunk's operands (stacked weights, caches, cross K/V)
    against the kernels' contract for K steps from ``t0``; returns the
    kernels' first 10 int dims (the caller appends the rest), the weight
    pointer array and the f32 attention scale."""
    dev, dt = device, dtype
    L, BH, Tmax, Dh = k_cache.shape
    H = num_heads
    Mq = cross_k.shape[2]
    dff = w["w1"].shape[2]
    HD = H * Dh
    if BH != B * H or HD != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fold B={B} "
                         f"rows of H={H} heads of d={d}")
    if not 0 < Dh <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {Dh} outside the kernel's "
                         f"1..{MAX_HEAD_DIM}")
    if not 0 <= t0 <= Tmax - K:
        raise ValueError(f"steps [{t0}, {t0 + K}) outside the cache of "
                         f"{Tmax} positions")
    shapes = {"s_wqkv": (L, d, 3 * HD), "s_bqkv": (L, 3 * HD),
              "s_wo": (L, HD, d), "c_wq": (L, d, HD), "c_bq": (L, HD),
              "c_wo": (L, HD, d), "w1": (L, d, dff), "b1": (L, dff),
              "w2": (L, dff, d), "lnfs": (1, d), "lnfb": (1, d)}
    for key in ("s_qns", "s_qnb", "s_kns", "s_knb", "c_qns", "c_qnb"):
        shapes[key] = (L, Dh)
    for key in TRUNK_KEYS:
        _build.require(w[key], key, dev,
                       dt if key in _PRODUCT_KEYS else torch.float32,
                       shapes.get(key, (L, d)))
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        _build.require(t, name, dev, dt, (L, BH, Tmax, Dh))
    for name, t in (("cross_k", cross_k), ("cross_v", cross_v)):
        _build.require(t, name, dev, dt, (L, BH, Mq, Dh))
    wptrs = (ctypes.c_void_p * len(TRUNK_KEYS))(
        *(w[key].data_ptr() for key in TRUNK_KEYS))
    return [B, L, H, Dh, d, dff, Tmax, Mq, K, t0], wptrs, 1.0 / Dh ** 0.5


def _launch(kernel, *, cont, prev, finished, k_cache, v_cache, cross_k,
            cross_v, in_w, in_b, pos_chunk, head_w, head_b, w, t0, num_heads,
            qk_norm, outs, ints):
    """Check every operand against the kernel's contract and launch."""
    dev = prev.device
    dt = pos_chunk.dtype
    code = _build.dtype_code(pos_chunk)
    B = prev.shape[0]
    K, d = pos_chunk.shape
    dims, wptrs, scale = check_trunk(
        w, k_cache, v_cache, cross_k, cross_v, B=B, d=d, t0=t0, K=K,
        num_heads=num_heads, dtype=dt, device=dev)
    _build.require(pos_chunk, "pos_chunk", dev, dt, (K, d))
    _build.require(head_w, "head_w", dev, dt, (d, head_b.shape[0]))
    _build.require(head_b, "head_b", dev, torch.float32, head_b.shape)
    _build.require(in_w, "in_w", dev, dt, (in_w.shape[0], d))
    if in_b is not None:
        _build.require(in_b, "in_b", dev, torch.float32, (d,))
    _build.require(finished, "finished", dev, torch.int32, (B,))
    N = head_b.shape[0]
    plan = None
    # 16-byte loads: the product weights, the embedding table or input
    # kernel, the position rows, the k/v rows and the head
    aligned = all(t.data_ptr() % 16 == 0 for t in
                  (*(w[k] for k in _PRODUCT_KEYS), in_w, pos_chunk, k_cache,
                   v_cache, cross_k, cross_v, head_w, head_b))
    if cluster_decline(dt, d=d, H=num_heads, dff=dims[5], N=N,
                       aligned=aligned) is None:
        plan = cluster_plan(B, d=d, H=num_heads, dff=dims[5], N=N,
                            Tmax=dims[6], Mq=dims[7], cont=cont,
                            max_clusters=cluster_fit(
                                dev.index, KIND_MDN if cont else KIND_TOKEN))
    plan_arr = None
    if plan is not None:
        plan_arr = (ctypes.c_int * PLAN_INTS)(*plan_ints(plan))
    dims = (ctypes.c_int * 17)(*dims, N, int(qk_norm), *ints)
    fdims = (ctypes.c_float * 2)(
        scale, float(torch.tensor(d ** 0.5, dtype=dt)))
    prev_tok = None if cont else prev
    prev_row = prev if cont else None
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_decode_chunk(
            code, int(cont), ctypes.addressof(wptrs), _build.ptr(k_cache),
            _build.ptr(v_cache), _build.ptr(cross_k), _build.ptr(cross_v),
            _build.ptr(pos_chunk), _build.ptr(head_w), _build.ptr(head_b),
            _build.ptr(in_w), _build.ptr(in_b), _build.ptr(prev_tok),
            _build.ptr(prev_row), _build.ptr(finished),
            *(_build.ptr(o) for o in outs), ctypes.addressof(dims),
            ctypes.addressof(fdims),
            None if plan_arr is None else ctypes.addressof(plan_arr),
            _build.stream(prev))
    _build.check(err, kernel)
    LAUNCHES[kernel] += 1
    ROUTES["rows" if plan is None else "cluster"] += 1


def decode_chunk(prev, finished, k_cache, v_cache, cross_k, cross_v, emb,
                 pos_chunk, head_w, head_b, w, t0, *, num_heads,
                 qk_norm=False, pad_id=0, sos_id=1, eos_id=2):
    """K greedy token steps from position ``t0`` (the port of
    ``fused_decode_chunk``). ``emb`` (V, d) and ``head_w`` (d, N) in the
    compute dtype, ``head_b`` (N,) f32, N = V or V padded by
    :func:`pad_head` (the bf16 cluster kernel takes only a head of whole
    16-column tiles), ``w`` from ``convert.stacked_decoder_weights``.
    Returns ``(ids (B, K) int32, finished (B,) int32)``; the caches get
    rows ``[t0, t0 + K)``."""
    if prev.device.type == "cpu":
        return decode_chunk_reference(
            prev, finished, k_cache, v_cache, cross_k, cross_v, emb,
            pos_chunk, head_w, head_b, w, t0, num_heads=num_heads,
            qk_norm=qk_norm, pad_id=pad_id, sos_id=sos_id, eos_id=eos_id)
    if prev.device.type != "cuda":
        raise ValueError(f"decode_chunk: unsupported device {prev.device}")
    B = prev.shape[0]
    K = pos_chunk.shape[0]
    _build.require(prev, "prev", prev.device, torch.int32, (B,))
    ids = torch.empty((B, K), dtype=torch.int32, device=prev.device)
    fin = torch.empty((B,), dtype=torch.int32, device=prev.device)
    _launch("decode_chunk", cont=False, prev=prev, finished=finished,
            k_cache=k_cache, v_cache=v_cache, cross_k=cross_k,
            cross_v=cross_v, in_w=emb, in_b=None, pos_chunk=pos_chunk,
            head_w=head_w, head_b=_masked_head_bias(head_b, pad_id, sos_id),
            w=w, t0=t0, num_heads=num_heads, qk_norm=qk_norm,
            outs=(ids, None, None, None, fin),
            ints=(pad_id, eos_id, 0, 0, emb.shape[0]))
    return ids, fin


def decode_cont_chunk(prev_row, finished, k_cache, v_cache, cross_k, cross_v,
                      in_w, in_b, pos_chunk, head_w, head_b, w, t0, *,
                      num_heads, num_mixtures, qk_norm=False, pen_end=2):
    """K greedy MDN steps from position ``t0`` (the port of
    ``fused_decode_cont_chunk``). ``in_w`` (5, d) and ``head_w`` (d, N) in
    the compute dtype, ``in_b``/``head_b`` f32, N = 6M+3 or padded by
    :func:`pad_head` (the picks read only the first 6M+3 columns). Returns
    ``(xy (B, K, 2)
    f32, pen (B, K) int32, valid (B, K) int32, finished (B,) int32)``; the
    caches get rows ``[t0, t0 + K)``."""
    if prev_row.device.type == "cpu":
        return decode_cont_chunk_reference(
            prev_row, finished, k_cache, v_cache, cross_k, cross_v, in_w,
            in_b, pos_chunk, head_w, head_b, w, t0, num_heads=num_heads,
            num_mixtures=num_mixtures, qk_norm=qk_norm, pen_end=pen_end)
    if prev_row.device.type != "cuda":
        raise ValueError(
            f"decode_cont_chunk: unsupported device {prev_row.device}")
    dev = prev_row.device
    B = prev_row.shape[0]
    K = pos_chunk.shape[0]
    P = 6 * num_mixtures + 3
    _build.require(prev_row, "prev_row", dev, torch.float32, (B, 5))
    if head_b.dim() != 1 or head_b.shape[0] < P:
        raise ValueError(f"head_b has shape {tuple(head_b.shape)}, expected "
                         f"at least ({P},) for {num_mixtures} mixtures")
    xy = torch.empty((B, K, 2), dtype=torch.float32, device=dev)
    pen = torch.empty((B, K), dtype=torch.int32, device=dev)
    valid = torch.empty((B, K), dtype=torch.int32, device=dev)
    fin = torch.empty((B,), dtype=torch.int32, device=dev)
    _launch("decode_cont_chunk", cont=True, prev=prev_row, finished=finished,
            k_cache=k_cache, v_cache=v_cache, cross_k=cross_k,
            cross_v=cross_v, in_w=in_w, in_b=in_b, pos_chunk=pos_chunk,
            head_w=head_w, head_b=head_b, w=w, t0=t0, num_heads=num_heads,
            qk_norm=qk_norm, outs=(None, xy, pen, valid, fin),
            ints=(0, 0, num_mixtures, pen_end, 0))
    return xy, pen, valid, fin
