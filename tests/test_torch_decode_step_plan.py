"""K13's bf16 route: the cluster kernel's step kind and its plan
(``ops/decode_chunk.py::cluster_plan`` with no head, N = 0, as
``ops/decode_step.py::fused_decode_step`` builds it).

Nothing here launches a kernel. The step's plan must fit a block's shared
memory with no head buffer and no pick state, and give every (row, head)
pair of each group one owner; a plain-torch emulation of the owner warp's
self-attention, in the kernel's order (``csrc/decode_chunk.cu::attend``
with the new position's f32 key and value), must equal ``_attend_new`` at
f32 1e-6, t = 0 included; and an emulation of the whole step's split
(each block's column slice of every product, the pair owners' attention)
must give the plain step's h and new k/v rows, in float32 on the CPU.
"""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.models.layers import layer_norm
from sketchformer_tpu_torch.ops import decode_chunk as dc
from sketchformer_tpu_torch.ops import decode_step as ds

AR = dict(d=256, dff=512, Tmax=192, Mq=4)
FITS = ({16: 8, 8: 16}, {16: 7, 8: 16}, {16: 0, 8: 16})
LANES = torch.arange(32)


def _plan(B, H, fits, **over):
    g = dict(AR, **over)
    return dc.cluster_plan(B, d=g["d"], H=H, dff=g["dff"], N=0,
                           Tmax=g["Tmax"], Mq=g["Mq"], cont=False,
                           max_clusters=fits), g


@pytest.mark.parametrize("fits", FITS, ids=["c16x8", "c16x7", "c8only"])
@pytest.mark.parametrize("B,H", [(64, 8), (64, 2), (40, 8), (512, 8)])
def test_step_plan_fits_without_a_head(B, H, fits):
    p, g = _plan(B, H, fits)
    assert p is not None
    d, C, G = g["d"], p["C"], p["G"]
    assert p["total"] <= dc.SMEM_LIMIT and len(dc.plan_ints(p)) == \
        dc.PLAN_INTS
    # no head: no columns, no chunk width, no logits, argmax or MDN rows,
    # no pick state
    assert p["Np"] == 0 and p["hcols"] == 0
    assert p["cols"][6] == [0] * (dc.MAX_CLUSTER + 1)
    assert p["o_lbuf"] == p["o_cand"] == p["o_mdn"] == p["o_act"]
    assert p["o_state"] == p["o_sc"]
    chunk = dc.cluster_plan(B, d=d, H=H, dff=g["dff"], N=10004,
                            Tmax=g["Tmax"], Mq=g["Mq"], cont=False,
                            max_clusters=fits)
    assert (chunk["C"], chunk["G"]) == (C, G) and chunk["total"] > p["total"]
    # the six products' slices: the chunk plan's
    for kind in range(6):
        assert dc.plan_slices(p, kind) == dc.plan_slices(chunk, kind)
    # rows: cluster k holds [k G, k G + G); B=40 ends in a part-empty group
    clusters = -(-B // G)
    assert clusters * G >= B > (clusters - 1) * G
    if B == 40:
        assert clusters * G > B
    # pairs: every (row, head) of a group to one slot of one block
    owners = {dc.pair_owner(r, h, H, C) for r in range(G) for h in range(H)}
    assert len(owners) == G * H
    assert all(0 <= rank < C and 0 <= slot < p["slots"]
               for rank, slot in owners)


def test_step_declines_like_the_chunks():
    """With no head (N = 0) the chunks' rule decides the route: bf16 at the
    ar_decode geometries takes the cluster kernel; f32 and the geometries
    ``cluster_decline`` names keep the per-row kernel, and so does a card
    that runs no cluster of the kernel."""
    bf, ok = torch.bfloat16, dict(d=256, H=8, dff=512, N=0, aligned=True)
    assert dc.cluster_decline(bf, **ok) is None
    assert dc.cluster_decline(bf, **dict(ok, H=2)) is None
    assert "float32" in dc.cluster_decline(torch.float32, **ok)
    assert "aligned" in dc.cluster_decline(bf, **dict(ok, aligned=False))
    assert "head_dim" in dc.cluster_decline(bf, **dict(ok, d=192, H=16))
    assert "multiples of 16" in dc.cluster_decline(bf, **dict(ok, dff=520))
    assert _plan(64, 8, {16: 0, 8: 0})[0] is None


def test_cpu_tensors_count_no_route():
    ds.reset_launches()
    assert ds.ROUTES == {"cluster": 0, "rows": 0}
    assert ds.LAUNCHES == {"decode_step": 0}


# ---------------------------------------------------------------------------
# the owner warp's self-attention, in the kernel's order
# ---------------------------------------------------------------------------


def _butterfly(v, offsets):
    """A warp's xor-shuffle sum over ``offsets`` of (32, ...) lane values:
    each lane adds its partner's value, offset by offset."""
    for off in offsets:
        v = v + v[LANES ^ off]
    return v


def owner_attention(q, kn, vn, k, v, scale):
    """``csrc/decode_chunk.cu::attend<bf16, 2, 8, true, true>`` with the
    new position (f32; the dtype roundings are the identity): (Dh,) f32
    q, kn, vn over the (t, Dh) cache rows, one warp of 32 lanes."""
    t, Dh = k.shape
    VW = 8                                    # 16-byte vectors of bf16
    sc = torch.empty(t)
    for p in range(t):                        # lane p % 32 scores row p
        s = s2 = torch.zeros(())
        for d0 in range(0, Dh, VW):
            f = q[d0:d0 + VW] * k[p, d0:d0 + VW]
            for c in range(VW // 2):          # even and odd in two chains
                s = s + f[2 * c]
                s2 = s2 + f[2 * c + 1]
        sc[p] = (s + s2) * scale
    acc = torch.zeros(32)                     # the new position's score
    for dd in range(Dh):
        acc[dd % 32] += q[dd] * kn[dd]
    s_new = _butterfly(acc, (16, 8, 4, 2, 1))[0] * scale
    lane_max = torch.full((32,), -torch.inf)
    for p in range(t):
        lane_max[p % 32] = torch.maximum(lane_max[p % 32], sc[p])
    for off in (16, 8, 4, 2, 1):
        lane_max = torch.maximum(lane_max, lane_max[LANES ^ off])
    m = torch.maximum(lane_max[0], s_new)
    e = torch.exp(sc - m)
    lane_sum = torch.zeros(32)
    for p in range(t):
        lane_sum[p % 32] += e[p]
    total = _butterfly(lane_sum, (16, 8, 4, 2, 1))[0]
    e_new = torch.exp(s_new - m)
    total = total + e_new
    LP = Dh // VW                             # lanes a value row
    pv = torch.zeros(32, VW)
    for lane in range(32):
        g, c0 = lane // LP, (lane % LP) * VW
        for p in range(g, t, 32 // LP):
            pv[lane] += e[p] * v[p, c0:c0 + VW]
    off = LP
    while off < 32:
        pv = pv + pv[LANES ^ off]
        off <<= 1
    o = torch.empty(Dh)
    for lane in range(LP):                    # the lanes of group 0
        c0 = lane * VW
        o[c0:c0 + VW] = (pv[lane] + e_new * vn[c0:c0 + VW]) / total
    return o


@pytest.mark.parametrize("Dh", [32, 64, 128])
@pytest.mark.parametrize("t", [0, 1, 17, 40, 191])
def test_owner_attention_equals_attend_new(t, Dh):
    rng = np.random.default_rng(100 * t + Dh)

    def r(*s, scale=1.0):
        return torch.from_numpy((rng.standard_normal(s) * scale)
                                .astype(np.float32))
    q, kn, vn = r(Dh), r(Dh), r(Dh)
    k, v = r(t, Dh, scale=1.5), r(t, Dh)
    scale = Dh ** -0.5
    got = owner_attention(q, kn, vn, k, v, scale)
    want = dc._attend_new(q[None, None], kn[None, None], vn[None, None],
                          k[None, None], v[None, None], scale=scale)[0, 0]
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)
    if t == 0:       # only the new position: its value
        assert torch.allclose(got, vn, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the whole step's split, f32
# ---------------------------------------------------------------------------


def _sliced(h, W, b, p, kind):
    out = torch.empty(h.shape[0], W.shape[1])
    for c0, nc in dc.plan_slices(p, kind):
        out[:, c0:c0 + nc] = dc._mm(h, W[:, c0:c0 + nc]) + b[c0:c0 + nc]
    return out


def emulate_step(x, kc, vc, ck, cv, w, t, p, *, H, qk):
    """One decoder step as the step kind moves it: each block's column
    slice of every product, each (row, head) pair's q, k, v (f32) at its
    owner, which writes the rounded new row and attends to the cache rows
    [0, t) and the new position; the final LayerNorm. Returns h, k_new,
    v_new."""
    f32 = torch.float32
    L, d, _ = w["s_wqkv"].shape
    B = x.shape[0]
    Dh = d // H
    Tmax, Mq = kc.shape[2], ck.shape[2]
    G, C = p["G"], p["C"]
    k_new = torch.full((L, B * H, Dh), torch.nan)
    v_new = torch.full((L, B * H, Dh), torch.nan)
    for i in range(L):
        h = layer_norm(x, w["ln1s"][i], w["ln1b"][i], f32)
        q, k, v = _sliced(h, w["s_wqkv"][i], w["s_bqkv"][i], p, 0).split(
            d, dim=-1)
        o = torch.full((B, d), torch.nan)
        owned = set()
        for b in range(B):
            for hh in range(H):
                owner = (b // G,) + dc.pair_owner(b % G, hh, H, C)
                assert owner not in owned
                owned.add(owner)
                sl = slice(hh * Dh, (hh + 1) * Dh)
                qq, kk = q[b, sl], k[b, sl]
                if qk:
                    qq = layer_norm(qq, w["s_qns"][i], w["s_qnb"][i], f32)
                    kk = layer_norm(kk, w["s_kns"][i], w["s_knb"][i], f32)
                k_new[i, b * H + hh] = kk
                v_new[i, b * H + hh] = v[b, sl]
                o[b, sl] = owner_attention(
                    qq, kk, v[b, sl], kc[i, b * H + hh, :t],
                    vc[i, b * H + hh, :t], Dh ** -0.5)
        x = x + _sliced(o, w["s_wo"][i], w["s_bo"][i], p, 1)
        h = layer_norm(x, w["ln2s"][i], w["ln2b"][i], f32)
        cq = _sliced(h, w["c_wq"][i], w["c_bq"][i], p, 2).reshape(B, H, Dh)
        if qk:
            cq = layer_norm(cq, w["c_qns"][i], w["c_qnb"][i], f32)
        o = dc._attend(cq, ck[i].view(B, H, Mq, Dh), cv[i].view(B, H, Mq, Dh),
                       scale=Dh ** -0.5, normalized=True)
        x = x + _sliced(o.reshape(B, d), w["c_wo"][i], w["c_bo"][i], p, 3)
        h = layer_norm(x, w["ln3s"][i], w["ln3b"][i], f32)
        f = torch.relu(_sliced(h, w["w1"][i], w["b1"][i], p, 4))
        x = x + _sliced(f, w["w2"][i], w["b2"][i], p, 5)
    return layer_norm(x, w["lnfs"][0], w["lnfb"][0], f32), k_new, v_new


def _step_operands(B, L, d, H, dff, Tmax, Mq, t, seed):
    rng = np.random.default_rng(seed)

    def r(*s, scale=0.1):
        return torch.from_numpy((rng.standard_normal(s) * scale)
                                .astype(np.float32))
    Dh = d // H
    w = {"s_wqkv": r(L, d, 3 * d, scale=d ** -0.5), "s_bqkv": r(L, 3 * d),
         "s_wo": r(L, d, d, scale=d ** -0.5), "s_bo": r(L, d),
         "c_wq": r(L, d, d, scale=d ** -0.5), "c_bq": r(L, d),
         "c_wo": r(L, d, d, scale=d ** -0.5), "c_bo": r(L, d),
         "w1": r(L, d, dff, scale=d ** -0.5), "b1": r(L, dff),
         "w2": r(L, dff, d, scale=dff ** -0.5), "b2": r(L, d),
         "lnfs": 1 + r(1, d), "lnfb": r(1, d)}
    for s, b, n in (("ln1s", "ln1b", d), ("ln2s", "ln2b", d),
                    ("ln3s", "ln3b", d), ("s_qns", "s_qnb", Dh),
                    ("s_kns", "s_knb", Dh), ("c_qns", "c_qnb", Dh)):
        w[s], w[b] = 1 + r(L, n), r(L, n)
    kc = torch.full((L, B * H, Tmax, Dh), torch.nan)    # rows >= t unread
    vc = torch.full((L, B * H, Tmax, Dh), torch.nan)
    kc[:, :, :t] = r(L, B * H, t, Dh, scale=1.0)
    vc[:, :, :t] = r(L, B * H, t, Dh, scale=1.0)
    return (r(B, d, scale=1.0), kc, vc, r(L, B * H, Mq, Dh, scale=1.0),
            r(L, B * H, Mq, Dh, scale=1.0), w)


@pytest.mark.parametrize("qk", [False, True], ids=["plain", "qknorm"])
@pytest.mark.parametrize("t", [0, 5])
def test_emulated_step_equals_the_plain_step(t, qk):
    """B=20 at G=16: two groups, the second part-empty."""
    B, L, d, H, dff, Tmax, Mq = 20, 2, 64, 4, 128, 8, 3
    x, kc, vc, ck, cv, w = _step_operands(B, L, d, H, dff, Tmax, Mq, t,
                                          seed=7 + t + qk)
    p = dc.cluster_plan(B, d=d, H=H, dff=dff, N=0, Tmax=Tmax, Mq=Mq,
                        cont=False, max_clusters={16: 8, 8: 16})
    assert (p["C"], p["G"]) == (16, 16)
    got = emulate_step(x, kc, vc, ck, cv, w, t, p, H=H, qk=qk)
    want = ds.fused_decode_step(x, kc, vc, ck, cv, w, t, num_heads=H,
                                qk_norm=qk)
    for name, a, b in zip(("h", "k_new", "v_new"), got, want):
        assert torch.isfinite(a).all(), name
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-5), name
