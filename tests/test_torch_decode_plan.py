"""The bf16 cluster kernel's launch plan and work split (ops/decode_chunk.py).

Nothing here launches a kernel. The plan must fit a block's shared memory
and cover every row, every column of every product and of the head, and
every (row, head) pair exactly once, in the tables the kernel reads (its
slices' column boundaries, box widths and inner-dimension splits); a
plain-torch emulation of the kernel's split (each block's column slice of
every product from those tables, q/k/v moved to the block that owns their
pair, the head's argmax per slice and then across the slices by the
first-index rule) must give the plain versions' ids, xy, pens and cache
rows, in float32 on the CPU.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sketchformer_tpu_torch.models.layers import layer_norm
from sketchformer_tpu_torch.ops import decode_chunk as dc

AR = dict(d=256, dff=512, V=10004, Tmax=192, Mq=4)
M = 20                                  # cont2cont_mdn's mixtures
FITS = ({16: 8, 8: 16}, {16: 7, 8: 16}, {16: 0, 8: 16})


def _plan(B, H, cont, fits, **over):
    geo = dict(AR, **over)
    N = 6 * M + 3 if cont else geo["V"]
    return dc.cluster_plan(B, d=geo["d"], H=H, dff=geo["dff"], N=N,
                           Tmax=geo["Tmax"], Mq=geo["Mq"], cont=cont,
                           max_clusters=fits), N, geo


def _covers(splits, N):
    """(start, count) slices: whole 16-column tiles, in order, covering
    [0, N) once."""
    at = 0
    for c0, nc in splits:
        assert c0 == at and nc >= 0 and c0 % 16 == 0 and nc % 16 == 0
        at += nc
    assert at == N


@pytest.mark.parametrize("fits", FITS, ids=["c16x8", "c16x7", "c8only"])
@pytest.mark.parametrize("cont", [False, True], ids=["token", "mdn"])
@pytest.mark.parametrize("H", [8, 4, 2])
@pytest.mark.parametrize("B", [1, 17, 64, 137, 512])
def test_plan_fits_and_covers_everything_once(B, H, cont, fits):
    p, N, g = _plan(B, H, cont, fits)
    assert p is not None
    d, dff, Dh, C, G = g["d"], g["dff"], g["d"] // H, p["C"], p["G"]
    assert p["total"] <= dc.SMEM_LIMIT and 1 <= C <= 16
    assert G % 16 == 0 and 16 <= G <= dc.MAX_GROUP
    # rows: cluster k holds rows [k G, k G + G), the last part-empty
    clusters = -(-B // G)
    rows = [b for k in range(clusters) for b in range(k * G, (k + 1) * G)
            if b < B]
    assert rows == list(range(B))
    # columns: each product's and the padded head's, once, as the kernel
    # reads them from the plan; every slice in its TMA box and a ring slot
    assert p["Np"] == 16 * -(-N // 16)
    assert len(dc.plan_ints(p)) == dc.PLAN_INTS
    shapes = (*dc.product_shapes(d, dff), (d, p["Np"]))
    for kind, (K, width) in enumerate(shapes):
        splits = dc.plan_slices(p, kind)
        assert splits == dc.split_columns(width, C)
        _covers(splits, width)
        assert p["cols"][kind][C:] == [width] * (dc.MAX_CLUSTER + 1 - C)
        if kind < 6:             # the slice's TMA boxes: widest columns
            ldw = p["ldw"][kind]
            assert ldw == max(nc for _, nc in splits)
            assert K * ldw <= p["pofs"] and ldw <= 256 and ldw <= p["bmax"]
    assert d * p["hcols"] <= p["pofs"] and p["hcols"] % 16 == 0
    # each slot's parameters: the bias slice, a LayerNorm, the qk-norms;
    # slots 128-byte aligned
    assert p["hcols"] <= min(p["bmax"], 256) and p["pofs"] % 64 == 0
    assert p["slot"] >= p["pofs"] + 2 * (p["bmax"] + 2 * d + 4 * Dh)
    assert p["slot"] % 64 == 0 and p["o_ring"] % 128 == 0
    for h0, hn in dc.split_columns(p["Np"], C):   # the head's chunks
        chunks = [(c, min(p["hcols"], h0 + hn - c))
                  for c in range(h0, h0 + hn, p["hcols"])]
        _covers([(0, h0)] + chunks, h0 + hn)
    # pairs: every (row, head) of a group to one slot of one block, which
    # gets all Dh values of the head's q, k and v (qk-norm's statistics)
    seen = set()
    for r in range(G):
        for h in range(H):
            rank, slot = dc.pair_owner(r, h, H, C)
            assert 0 <= rank < C and 0 <= slot < p["slots"]
            seen.add((rank, slot))
    assert len(seen) == G * H
    # shared memory: 16-byte aligned regions that do not overlap; the
    # head's buffers inside act
    size = {"o_xs": G * d * 2, "o_hs": G * p["ld_hs"] * 2,
            "o_own": max(p["slots"] * 3 * Dh * 4, G * p["bmax"] * 2),
            "o_state": G * 36,
            "o_ring": p["NS"] * p["slot"] * 2,
            "o_act": G * p["ld_act"] * 2,
            "o_sc": 8 * (max(g["Tmax"], g["Mq"]) + Dh) * 4}
    spans = sorted((p[k], p[k] + n) for k, n in size.items())
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= p["total"]
    assert all(p[k] % 128 == 0 for k in dc.PLAN_KEYS if k.startswith("o_"))
    act_end = min(o for o in (p["o_own"], p["o_state"], p["o_sc"],
                              p["o_ring"], p["total"]) if o > p["o_act"])
    if cont:
        assert p["o_mdn"] == p["o_act"]
        assert p["o_act"] + G * p["Np"] * 2 <= act_end
    else:
        assert p["o_lbuf"] == p["o_act"]
        assert p["o_lbuf"] + G * p["hcols"] * 4 <= p["o_cand"]
        assert p["o_cand"] + C * G * 8 <= act_end
    # the split products' partial tiles share the score rows' region: S
    # ways of a slice's tiles (S x tiles <= 8 warps), the plan's split
    sc_end = min(o for o in (p["o_ring"], p["total"]) if o > p["o_sc"])
    for nc in range(16, p["bmax"] + 1, 16):
        for row, K in zip(p["split"], (d, dff)):
            items, S = (G // 16) * (nc // 16), row[nc // 16]
            assert S == dc.split_ways(G, nc, K) and (K // 16) % S == 0
            assert S == 1 or (S * items <= 8
                              and p["o_sc"] + S * items * 1024 <= sc_end)


def test_plan_takes_one_wave_where_the_card_allows():
    """With eight 16-block clusters at once, B=64 is four 16-row groups
    and B=512 eight of 64; with seven, B=512 goes to 8-block clusters of
    32 rows (one wave) rather than a second wave."""
    p, *_ = _plan(64, 8, False, {16: 8, 8: 16})
    assert (p["C"], p["G"], p["NS"]) == (16, 16, 3)
    p, *_ = _plan(512, 8, False, {16: 8, 8: 16})
    assert (p["C"], p["G"], p["NS"]) == (16, 64, 2)
    p, *_ = _plan(512, 8, True, {16: 7, 8: 16})
    assert (p["C"], p["G"]) == (8, 32)
    p, *_ = _plan(4096, 8, False, {16: 8, 8: 16})     # waves
    assert (p["C"], p["G"]) == (16, 64)
    assert dc.cluster_plan(64, d=256, H=8, dff=512, N=10004, Tmax=192, Mq=4,
                           cont=False, max_clusters={16: 0, 8: 0}) is None


def test_cluster_decline_rules():
    bf = torch.bfloat16
    ok = dict(d=256, H=8, dff=512, N=10016, aligned=True)
    assert dc.cluster_decline(bf, **ok) is None
    assert dc.cluster_decline(bf, **dict(ok, H=2)) is None      # Dh 128
    assert dc.cluster_decline(bf, **dict(ok, H=4)) is None      # Dh 64
    assert "float32" in dc.cluster_decline(torch.float32, **ok)
    assert "multiples of 16" in dc.cluster_decline(bf, **dict(ok, d=264,
                                                               H=11))
    assert "multiples of 16" in dc.cluster_decline(bf, **dict(ok, dff=520))
    assert "head_dim" in dc.cluster_decline(bf, **dict(ok, d=192, H=16))
    assert "head_dim" in dc.cluster_decline(bf, **dict(ok, d=192, H=4))
    assert "aligned" in dc.cluster_decline(bf, **dict(ok, aligned=False))
    assert dc.cluster_decline(bf, **dict(ok, dff=256)) is None
    assert "TMA" in dc.cluster_decline(bf, **dict(ok, dff=1024))
    assert "TMA" in dc.cluster_decline(bf, **dict(ok, dff=384))
    assert "pad_head" in dc.cluster_decline(bf, **dict(ok, N=10004))
    assert "pad_head" in dc.cluster_decline(bf, **dict(ok, N=123))
    assert dc.cluster_decline(bf, **dict(ok, N=128)) is None


@pytest.mark.parametrize("cont", [False, True], ids=["token", "mdn"])
def test_padded_head_leaves_the_plain_chunk_unchanged(cont):
    """pad_head's columns (zero weights; -inf token bias lanes, 0 MDN
    lanes) change no pick, xy or cache row of the plain chunk, and the
    wrappers take the padded head on the CPU."""
    ops = _operands(cont, seed=7)
    want = _reference(ops, cont, 4, True, 3)
    head_w, head_b = dc.pad_head(ops["head_w"], ops["head_b"], cont=cont)
    assert head_w.shape[1] == head_b.shape[0] == 16 * -(
        -ops["head_b"].shape[0] // 16) > ops["head_b"].shape[0]
    padded = dict(ops, head_w=head_w, head_b=head_b,
                  k_cache=ops["k_cache"].clone(),
                  v_cache=ops["v_cache"].clone())
    got = _reference(padded, cont, 4, True, 3)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    args = (padded["prev"], padded["finished"], padded["k_cache"].clone(),
            padded["v_cache"].clone(), padded["cross_k"], padded["cross_v"])
    if cont:
        out = dc.decode_cont_chunk(
            *args, padded["in_w"], padded["in_b"], padded["pos_chunk"],
            head_w, head_b, padded["w"], 3, num_heads=4, num_mixtures=M,
            qk_norm=True)
    else:
        out = dc.decode_chunk(*args, padded["emb"], padded["pos_chunk"],
                              head_w, head_b, padded["w"], 3, num_heads=4,
                              qk_norm=True)
    for g, w_ in zip(out, want):
        assert torch.equal(g, w_)


def test_cpu_tensors_count_no_route():
    dc.reset_launches()
    assert dc.ROUTES == {"cluster": 0, "rows": 0}


# ---------------------------------------------------------------------------
# a plain-torch emulation of the cluster kernel's split, f32 on the CPU
# ---------------------------------------------------------------------------

def better(v, i, bv, bi):
    """The kernel's (value, index) order: larger value, then smaller
    index."""
    return v > bv or (v == bv and i < bi)


def split_argmax(logits, splits):
    """Per row: each slice's first-index argmax, then the slices' by
    ``better`` (the cluster's reduction)."""
    out = []
    for row in logits.tolist():
        bv, bi = -math.inf, 2 ** 31 - 1
        for c0, nc in splits:
            if nc == 0:
                continue
            sl = row[c0:c0 + nc]
            k = max(range(nc), key=lambda n: (sl[n], -n))
            if better(sl[k], c0 + k, bv, bi):
                bv, bi = sl[k], c0 + k
        out.append(bi)
    return torch.tensor(out, dtype=torch.int32)


@pytest.mark.parametrize("G", [16, 32, 48, 64])
def test_split_ways_fill_the_warps(G):
    """The inner dimension is split while a slice's tiles leave warps
    idle: at most 8 warps' items, and only where the split divides it."""
    for nc in range(0, 257, 16):
        for K in (64, 128, 256, 512):
            S = dc.split_ways(G, nc, K)
            items = (G // 16) * (nc // 16)
            assert S in (1, 2, 4, 8) and (K // 16) % S == 0
            if items == 0 or items > 4:
                assert S == 1
            else:
                assert S * items <= 8 and (
                    2 * S * items > 8 or (K // 16) % (2 * S))


def test_split_argmax_is_the_first_index_argmax():
    rng = np.random.default_rng(3)
    for C in (1, 3, 8, 16):
        x = torch.from_numpy(rng.integers(0, 4, (40, 96)).astype(np.float32))
        assert torch.equal(split_argmax(x, dc.split_columns(96, C)),
                           x.argmax(-1).int())


def _sliced(h, W, b, p, kind):
    """Each block's column slice (the plan's, product ``kind``) of
    dt(h) . W + b, assembled."""
    out = torch.empty(h.shape[0], W.shape[1])
    for c0, nc in dc.plan_slices(p, kind):
        out[:, c0:c0 + nc] = dc._mm(h, W[:, c0:c0 + nc]) + b[c0:c0 + nc]
    return out


def _owner_attention(q, k, v, p, H, *, cross, kc=None, vc=None, t=None):
    """Each (row, head) pair attended by its owner, as the kernel's warps
    do, from the values the owner holds; the outputs assembled into rows."""
    B, HD = q.shape
    Dh = HD // H
    G, C = p["G"], p["C"]
    o = torch.full((B, HD), math.nan)
    done = set()
    for b in range(B):
        for h in range(H):
            owner = (b // G,) + dc.pair_owner(b % G, h, H, C)
            assert owner not in done
            done.add(owner)
            sl = slice(h * Dh, (h + 1) * Dh)
            qq = q[b, sl][None, None]
            if cross:
                kk, vv = k[b:b + 1, h:h + 1], v[b:b + 1, h:h + 1]
            else:
                kc[b, h, t] = k[b, sl]
                vc[b, h, t] = v[b, sl]
                kk, vv = kc[b:b + 1, h:h + 1, :t + 1], vc[b:b + 1, h:h + 1,
                                                         :t + 1]
            o[b, sl] = dc._attend(qq, kk, vv, scale=Dh ** -0.5,
                                  normalized=cross)[0, 0]
    return o


def emulate_chunk(ops, p, *, cont, H, qk, t0, K):
    """K steps of the cluster kernel's data flow (f32): returns ids and
    finished (token) or xy, pen, valid, finished (MDN); the caches get the
    new rows."""
    w = ops["w"]
    dt = torch.float32
    L, d, _ = w["s_wqkv"].shape
    HD, Dh = d, d // H
    B = ops["finished"].shape[0]
    Tmax = ops["k_cache"].shape[2]
    head_w, hb = dc.pad_head(ops["head_w"], ops["head_b"], cont=cont)
    assert head_w.shape[1] == p["Np"]
    if not cont:
        hb = dc._masked_head_bias(hb, 0, 1)
    fin = ops["finished"].clone()
    prev = ops["prev"].clone()
    outs = []
    for j in range(K):
        t = t0 + j
        if cont:
            x = dc._mm(prev, ops["in_w"]) + ops["in_b"]
        else:
            x = ops["emb"][prev.long()]
        x = x * d ** 0.5 + ops["pos_chunk"][j]
        for i in range(L):
            kc = ops["k_cache"][i].view(B, H, Tmax, Dh)
            vc = ops["v_cache"][i].view(B, H, Tmax, Dh)
            h = layer_norm(x, w["ln1s"][i], w["ln1b"][i], dt)
            qkv = _sliced(h, w["s_wqkv"][i], w["s_bqkv"][i], p, 0)
            q, k, v = qkv.split(HD, dim=-1)
            if qk:       # by the owner, over the head's Dh values
                q = layer_norm(q.reshape(B, H, Dh), w["s_qns"][i],
                               w["s_qnb"][i], dt).reshape(B, HD)
                k = layer_norm(k.reshape(B, H, Dh), w["s_kns"][i],
                               w["s_knb"][i], dt).reshape(B, HD)
            o = _owner_attention(q, k, v, p, H, cross=False, kc=kc, vc=vc,
                                 t=t)
            x = x + _sliced(o, w["s_wo"][i], w["s_bo"][i], p, 1)
            h = layer_norm(x, w["ln2s"][i], w["ln2b"][i], dt)
            cq = _sliced(h, w["c_wq"][i], w["c_bq"][i], p, 2)
            if qk:
                cq = layer_norm(cq.reshape(B, H, Dh), w["c_qns"][i],
                                w["c_qnb"][i], dt).reshape(B, HD)
            Mq = ops["cross_k"].shape[2]
            o = _owner_attention(cq, ops["cross_k"][i].view(B, H, Mq, Dh),
                                 ops["cross_v"][i].view(B, H, Mq, Dh), p, H,
                                 cross=True)
            x = x + _sliced(o, w["c_wo"][i], w["c_bo"][i], p, 3)
            h = layer_norm(x, w["ln3s"][i], w["ln3b"][i], dt)
            f = torch.relu(_sliced(h, w["w1"][i], w["b1"][i], p, 4))
            x = x + _sliced(f, w["w2"][i], w["b2"][i], p, 5)
        h = layer_norm(x, w["lnfs"][0], w["lnfb"][0], dt)
        if cont:         # the head's rows gathered whole, then the pick
            raw = _sliced(h, head_w, hb, p, 6)
            comp = raw[:, :M].argmax(-1)
            pen = raw[:, 6 * M:6 * M + 3].argmax(-1).int()
            mu = raw.gather(1, torch.stack([M + comp, 2 * M + comp], 1))
            done = fin != 0
            pen = torch.where(done, 2, pen)
            mu = torch.where(done[:, None], 0.0, mu)
            fin = torch.where(pen == 2, 1, fin)
            outs.append((mu, pen, (~done).int()))
            prev = torch.cat([mu, F.one_hot(pen.long(), 3).float()], -1)
        else:            # each block's slice argmax, then the cluster's
            nxt = split_argmax(dc._mm(h, head_w) + hb, dc.plan_slices(p, 6))
            nxt = torch.where(fin != 0, 0, nxt)
            fin = torch.where(nxt == 2, 1, fin)
            outs.append((nxt,))
            prev = nxt
    cols = [torch.stack(c, 1) for c in zip(*outs)]
    return (*cols, fin)


def _operands(cont, B=17, L=2, d=64, H=4, dff=128, V=67, Tmax=16, Mq=3, K=4,
              t0=3, seed=0):
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
    kc = torch.zeros(L, B * H, Tmax, Dh)
    vc = torch.zeros(L, B * H, Tmax, Dh)
    kc[:, :, :t0] = r(L, B * H, t0, Dh, scale=1.0)
    vc[:, :, :t0] = r(L, B * H, t0, Dh, scale=1.0)
    N = 6 * M + 3 if cont else V
    ops = dict(k_cache=kc, v_cache=vc, cross_k=r(L, B * H, Mq, Dh, scale=1),
               cross_v=r(L, B * H, Mq, Dh, scale=1),
               pos_chunk=r(K, d, scale=1.0), head_w=r(d, N, scale=d ** -0.5),
               head_b=r(N), w=w, finished=torch.from_numpy(
                   (np.arange(B) % 5 == 1).astype(np.int32)))
    if cont:
        ops.update(in_w=r(5, d, scale=0.5), in_b=r(d), prev=torch.cat(
            [r(B, 2, scale=1.0), F.one_hot(torch.arange(B) % 3, 3).float()],
            -1))
    else:
        ops.update(emb=r(N, d, scale=d ** -0.5), prev=torch.from_numpy(
            rng.integers(4, N, B).astype(np.int32)))
    return ops


def _reference(ops, cont, H, qk, t0):
    args = (ops["prev"], ops["finished"], ops["k_cache"], ops["v_cache"],
            ops["cross_k"], ops["cross_v"])
    if cont:
        return dc.decode_cont_chunk_reference(
            *args, ops["in_w"], ops["in_b"], ops["pos_chunk"], ops["head_w"],
            ops["head_b"], ops["w"], t0, num_heads=H, num_mixtures=M,
            qk_norm=qk, return_margins=True)
    return dc.decode_chunk_reference(
        *args, ops["emb"], ops["pos_chunk"], ops["head_w"], ops["head_b"],
        ops["w"], t0, num_heads=H, qk_norm=qk, return_margins=True)


def _plant_ties(ops, p, cont):
    """Exact ties across slice boundaries: zero head columns whose bias
    tops every logit, so both columns read the same value; the picks
    must take the first."""
    splits = dc.plan_slices(p, 6)
    if cont:     # two component columns (gathered whole before the pick)
        cols = (3, 11)
    else:        # the last column of one slice and the first of the next
        full = [(c0, nc) for c0, nc in splits if nc]
        cols = (full[1][0] - 1, full[1][0])
    for c in cols:
        ops["head_w"][:, c] = 0.0
        ops["head_b"][c] = 40.0
    return cols


@pytest.mark.parametrize("plant", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("qk", [False, True], ids=["plain", "qknorm"])
@pytest.mark.parametrize("cont", [False, True], ids=["token", "mdn"])
def test_emulated_split_equals_the_plain_chunk(cont, qk, plant):
    H, t0, K = 4, 3, 4
    ops = _operands(cont, seed=1 + 2 * qk + cont)
    N = ops["head_w"].shape[1]
    p = dc.cluster_plan(17, d=64, H=H, dff=128, N=N, Tmax=16, Mq=3,
                        cont=cont, max_clusters={16: 8, 8: 16})
    assert (p["C"], p["G"]) == (16, 16)      # two groups, one of a row
    cols = _plant_ties(ops, p, cont) if plant else None
    ref_ops = {k: (v.clone() if torch.is_tensor(v) else v)
               for k, v in ops.items()}
    *want, margins = _reference(ref_ops, cont, H, qk, t0)
    got = emulate_chunk(ops, p, cont=cont, H=H, qk=qk, t0=t0, K=K)
    if plant:        # every live pick is the first of the tied columns
        if cont:
            assert margins.max() < 1
        else:
            live = got[0] != 0
            assert bool(live.any())
            assert torch.all(got[0][live] == cols[0])
    # margins below 1 are near ties where two f32 summation orders may
    # pick differently; the planted ties are exact, so every step compares
    checked = (margins >= 1) | plant
    assert int(checked.sum()) >= checked.numel() // 2
    for g, w_ in zip(got, want):
        if g.is_floating_point():
            assert torch.allclose(g[checked], w_[checked], atol=1e-5,
                                  rtol=1e-5)
        elif g.dim() == 2:
            assert torch.equal(g[checked], w_[checked])
        else:
            assert torch.equal(g, w_)
    for a_, b_ in ((ops["k_cache"], ref_ops["k_cache"]),
                   (ops["v_cache"], ref_ops["v_cache"])):
        assert torch.allclose(a_, b_, atol=1e-5, rtol=1e-5)
