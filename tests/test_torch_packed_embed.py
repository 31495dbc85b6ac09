"""The embed path's packed stack on the CPU's plain versions: the encoder
stack of a batch's valid rows against the padded stack, the host's layout
of those rows and what it declines, and ``fast_embed`` / ``embed_dataset``
with and without the layout. The kernels themselves are held to the padded
ones on the card (``test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.config import SketchformerConfig
from sketchformer_tpu_torch.infer import fast_encode
from sketchformer_tpu_torch.infer.encode import embed_dataset
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.ops import encoder_stack as es
from sketchformer_tpu_torch.utils import engines

# the ragged attention's tile edges (64-row query blocks, 32-key tiles),
# one row and a whole sketch of T = 192
LENGTHS = [1, 31, 32, 33, 63, 64, 65, 191, 192]
T = 192
TINY = dict(vocab_size=64, num_classes=4, max_len=24, d_model=32,
            num_layers=2, num_heads=2, dff=64, lowerdim=16, num_queries=2,
            dropout=0.0, attn_impl="pallas")
CONT = dict(use_continuous=True, num_mixtures=3, qk_norm=True)


def _prefix(lengths, T):
    return np.arange(T)[None, :] < np.asarray(lengths)[:, None]


def _weights(gen, L, d, H, dff):
    def r(*s, scale=0.1):
        return torch.randn(s, generator=gen) * scale

    w = {"wqkv": r(L, d, 3 * d, scale=d ** -0.5), "bqkv": r(L, 3 * d),
         "wo": r(L, d, d, scale=d ** -0.5), "bo": r(L, d),
         "w1": r(L, d, dff, scale=d ** -0.5), "b1": r(L, dff),
         "w2": r(L, dff, d, scale=dff ** -0.5), "b2": r(L, d),
         "lnfs": 1 + r(1, d), "lnfb": r(1, d)}
    for s, b, n in (("ln1s", "ln1b", d), ("ln2s", "ln2b", d),
                    ("qns", "qnb", d // H), ("kns", "knb", d // H)):
        w[s], w[b] = 1 + r(L, n), r(L, n)
    return w


def _model(cont, **over):
    torch.manual_seed(0)
    kw = dict(TINY, **(CONT if cont else {}))
    return Sketchformer(SketchformerConfig(**dict(kw, **over))).eval()


def _batch(cont, lengths, seed=0):
    """(enc, enc_mask or None) of sketches of these numbers of valid
    positions, at the tiny model's T."""
    rng = np.random.default_rng(seed)
    Tm = TINY["max_len"]
    valid = _prefix(lengths, Tm)
    if cont:
        rows = rng.standard_normal((len(lengths), Tm, 3)).astype(np.float32)
        return rows * valid[..., None], valid.astype(np.float32)
    ids = rng.integers(4, TINY["vocab_size"], (len(lengths), Tm))
    return np.where(valid, ids, 0).astype(np.int32), None


@pytest.mark.parametrize("qk", [False, True], ids=["plain", "qk-norm"])
def test_packed_stack_equals_the_padded_stack_on_every_valid_row(qk):
    gen = torch.Generator().manual_seed(0)
    d, H = 64, 2
    w = _weights(gen, 2, d, H, 128)
    valid = _prefix(LENGTHS, T)
    x = torch.randn(len(LENGTHS), T, d, generator=gen)
    rows, why = es.pack_rows(valid)
    assert why == "" and rows.index.shape == (sum(LENGTHS),)
    got = es.encoder_stack_packed_reference(x, rows, w, num_heads=H,
                                            qk_norm=qk)
    km = torch.from_numpy(valid)
    want = es.encoder_stack_reference(x, km, w, num_heads=H, qk_norm=qk)
    torch.testing.assert_close(got[km], want[km], rtol=1e-6, atol=1e-6)
    assert not got[~km].any()      # the padding's rows are zeros
    # given CPU tensors, the kernel route runs the same plain versions
    assert torch.equal(es.fused_encoder_stack_packed(
        x, rows, w, num_heads=H, qk_norm=qk), got)


def test_ragged_attention_reference_is_each_sketch_alone():
    gen = torch.Generator().manual_seed(1)
    H, Dh = 2, 16
    rows, _ = es.pack_rows(_prefix([5, 1, 9], 12))
    qkv = torch.randn(15, 3 * H * Dh, generator=gen)
    got = es.ragged_attention(qkv, rows, num_heads=H)
    for s, n in ((0, 5), (5, 1), (6, 9)):
        want = es.attention_reference(qkv[None, s:s + n], None, num_heads=H)
        assert torch.equal(got[s:s + n], want[0])


def test_pack_rows_lays_out_each_sketch_and_its_query_blocks():
    valid = _prefix([3, 70, 1], 80)
    rows, why = es.pack_rows(valid)
    assert why == ""
    np.testing.assert_array_equal(rows.starts, [0, 3, 73])
    np.testing.assert_array_equal(rows.lengths, [3, 70, 1])
    assert rows.index.dtype == rows.work.dtype == torch.int32
    np.testing.assert_array_equal(rows.index.numpy(), np.flatnonzero(valid))
    # (first query row, the sketch's first row, its length) a 64-row block
    np.testing.assert_array_equal(
        rows.work.numpy(), [[0, 0, 3], [3, 3, 70], [67, 3, 70], [73, 73, 1]])


def test_pack_rows_lists_the_persistent_walks_items_longest_first():
    lengths = [3, 70, 1, 70, 12]
    rows, _ = es.pack_rows(_prefix(lengths, 80))
    assert rows.items.dtype == torch.int32
    # each sketch's (first row, length), longest first, ties in batch order
    np.testing.assert_array_equal(
        rows.items.numpy(),
        [[3, 70], [74, 70], [144, 12], [0, 3], [73, 1]])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_the_persistent_walk_covers_every_sketch_head_once(seed):
    rng = np.random.default_rng(seed)
    B, T, H = 37, 192, 8
    lengths = rng.integers(1, T + 1, B)
    rows, _ = es.pack_rows(_prefix(lengths, T))
    items = rows.items.numpy()
    assert (np.diff(items[:, 1]) <= 0).all()
    # item i is head i % H of sketch i // H of the list
    walked = [(int(items[i // H, 0]), int(items[i // H, 1]), i % H)
              for i in range(B * H)]
    assert sorted(walked) == sorted(
        (int(s), int(n), h) for s, n in zip(rows.starts, rows.lengths)
        for h in range(H))


@pytest.mark.parametrize("T,head_dim,qk,route,why", [
    (192, 32, False, "persistent", ""),
    (1, 32, False, "persistent", ""),
    (193, 32, False, "tiles", "stage of 192 rows"),
    (1024, 32, False, "tiles", "stage of 192 rows"),
    (192, 32, True, "tiles", "qk-norm"),
    (64, 64, False, "tiles", "head_dim 64"),
    (64, 128, False, "tiles", "head_dim 128"),
    (64, 16, False, "tiles", "head_dim 16"),
], ids=["stage", "one-row", "past-stage", "max-len", "qk-norm", "dh64",
        "dh128", "dh16"])
def test_ragged_route_is_persistent_exactly_where_the_stage_fits(
        T, head_dim, qk, route, why):
    got, reason = es.ragged_route(T, head_dim, qk)
    assert got == route
    assert (reason == "") if not why else (why in reason)


def _walk_item(qkv, start, n, h, H, Dh):
    """Head h of the sketch of n packed rows from ``start`` as the
    persistent kernel computes it, in f32: 16-row query slices of the
    stage (zero rows past n), 32-key tiles from the sketch's first row,
    sweep 1 every tile's scores (keys past n -inf) and the row max, sweep 2
    exp(s - max) and its sum tile by tile with P.V, then the division."""
    HD = H * Dh
    pane = qkv[start:start + n].float()
    nsl, ntiles = -(-n // 16), -(-n // 32)
    q, k, v = (torch.zeros(rows, Dh) for rows in (16 * nsl, 32 * ntiles,
                                                   32 * ntiles))
    q[:n] = pane[:, h * Dh:(h + 1) * Dh]
    k[:n] = pane[:, HD + h * Dh:HD + (h + 1) * Dh]
    v[:n] = pane[:, 2 * HD + h * Dh:2 * HD + (h + 1) * Dh]
    out = torch.empty(n, Dh)
    for sl in range(nsl):
        qs = q[16 * sl:16 * sl + 16]
        scores, mx = [], torch.full((16,), -torch.inf)
        for t in range(ntiles):
            s = (qs @ k[32 * t:32 * t + 32].t()) * (1.0 / Dh ** 0.5)
            s[:, torch.arange(32 * t, 32 * t + 32) >= n] = -torch.inf
            scores.append(s)
            mx = torch.maximum(mx, s.amax(1))
        o, es_ = torch.zeros(16, Dh), torch.zeros(16)
        for t, s in enumerate(scores):
            e = torch.exp(s - mx[:, None])
            es_ += e.sum(1)
            o += e @ v[32 * t:32 * t + 32]
        keep = min(16, n - 16 * sl)
        out[16 * sl:16 * sl + keep] = (o / es_[:, None])[:keep]
    return out


def test_the_persistent_walks_tile_order_equals_the_plain_attention():
    gen = torch.Generator().manual_seed(4)
    H, Dh = 2, 32
    lengths = [1, 15, 16, 17, 31, 32, 33, 100, 192]
    rows, _ = es.pack_rows(_prefix(lengths, 192))
    qkv = torch.randn(sum(lengths), 3 * H * Dh, generator=gen)
    got = torch.full((sum(lengths), H * Dh), torch.nan)
    items = rows.items.numpy()
    for i in range(len(lengths) * H):
        start, n = (int(x) for x in items[i // H])
        h = i % H
        assert got[start:start + n, h * Dh:(h + 1) * Dh].isnan().all()
        got[start:start + n, h * Dh:(h + 1) * Dh] = _walk_item(
            qkv, start, n, h, H, Dh)
    want = es.ragged_attention_reference(qkv, rows, num_heads=H)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lengths,hole,why", [
    ([3, 0, 5], None, "no valid position"),
    ([3, 4, 5], (1, 1), "not a prefix"),
], ids=["empty-sketch", "hole"])
def test_pack_rows_declines_what_would_change_z(lengths, hole, why):
    valid = _prefix(lengths, 8)
    if hole:
        valid[hole] = False
    rows, reason = es.pack_rows(valid)
    assert rows is None and why in reason


@pytest.mark.parametrize("over,device,ok", [
    (dict(dtype="bfloat16"), "cuda", True),
    (dict(dtype="bfloat16", d_model=64, num_heads=4), "cuda", True),
    (dict(dtype="float32"), "cuda", False),
    (dict(dtype="bfloat16", d_model=48), "cuda", False),   # head_dim 24
    (dict(dtype="bfloat16", norm_first=False), "cuda", False),
    (dict(dtype="bfloat16"), "cpu", False),
    (dict(dtype="float32"), "cpu", False),
], ids=["bf16", "bf16-dh16", "f32", "dh24", "post-ln", "cpu-bf16",
        "cpu-f32"])
def test_packed_support_is_the_ragged_kernels_geometry(over, device, ok):
    model = _model(False, **over)
    assert fast_encode.packed_support(model, torch.device(device))[0] is ok


@pytest.mark.parametrize("device,dtype,head_dim,why", [
    ("cuda", torch.bfloat16, 32, ""),
    ("cuda", torch.bfloat16, 128, ""),
    ("cuda", torch.bfloat16, 144, "up to 128"),
    ("cuda", torch.bfloat16, 24, "multiple of 16"),
    ("cuda", torch.float32, 32, "bf16"),
    ("cpu", torch.bfloat16, 32, "runs on a card"),
], ids=["dh32", "dh128", "dh144", "dh24", "f32", "cpu"])
def test_ragged_declines_is_the_one_rule_of_the_kernels_geometry(
        device, dtype, head_dim, why):
    got = es.ragged_declines(torch.device(device), dtype, head_dim)
    assert (got == "") if not why else (why in got)


@pytest.mark.parametrize("lengths,packed", [
    ([21, 21, 21], True),          # 0.875 valid: the largest share packed
    ([22, 21, 21], False),
    ([24, 24, 24], False),
], ids=["at-the-share", "above", "full"])
def test_a_nearly_full_batch_takes_the_padded_stack(lengths, packed, caplog):
    model = _model(False, dtype="bfloat16")
    enc, mask = _batch(False, lengths)
    engines.reset_seen()
    with caplog.at_level("INFO", logger="sketchformer_tpu_torch.engines"):
        rows = fast_encode.packed_rows(model, enc, mask,
                                       torch.device("cuda"))
    assert (rows is not None) is packed
    levels = {r.levelname for r in caplog.records
              if "embed-pack" in r.getMessage()}
    assert levels == (set() if packed else {"INFO"})


def test_a_model_the_fused_engine_declines_is_noted_once(caplog):
    model = _model(False, dtype="bfloat16", norm_first=False)
    enc, mask = _batch(False, [7, 24, 12])
    engines.reset_seen()
    with caplog.at_level("INFO", logger="sketchformer_tpu_torch.engines"):
        assert fast_encode.packed_rows(model, enc, mask,
                                       torch.device("cuda")) is None
        fast_encode.fast_embed(model, torch.from_numpy(enc))
    notes = [r.getMessage() for r in caplog.records]
    assert "embed: using composed path — post-LN config" in notes
    assert not [n for n in notes if n.startswith("embed-pack")]


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_fast_embed_with_the_host_layout_equals_without(cont):
    model = _model(cont)
    enc, mask = _batch(cont, [1, 5, 23, 24, 12])     # one of one position
    rows, why = es.pack_rows(model.enc_key_mask(enc, mask))
    assert why == ""
    enc_t = torch.from_numpy(enc)
    mask_t = None if mask is None else torch.from_numpy(mask)
    embed = fast_encode.make_fast_embed_fn(model)
    got = embed(enc_t, mask_t, rows)
    want = embed(enc_t, mask_t)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(want, model.embed(enc_t, mask_t), rtol=1e-5,
                               atol=1e-5)


def _on_the_card_route(monkeypatch):
    """The packed stack's support as on a card, so that ``embed_dataset``
    packs on the CPU's plain versions (its control flow rehearsed)."""
    monkeypatch.setattr(fast_encode, "packed_support",
                        lambda model, device: (True, ""))


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_packed_rows_takes_the_host_mask_of_the_models_rule(cont):
    model = _model(cont, dtype="bfloat16")
    enc, mask = _batch(cont, [7, 24, 1])
    rows = fast_encode.packed_rows(model, enc, mask, torch.device("cuda"))
    np.testing.assert_array_equal(rows.lengths, [7, 24, 1])
    np.testing.assert_array_equal(
        rows.index.numpy(),
        np.flatnonzero(model.enc_key_mask(torch.from_numpy(enc), None if
                                          mask is None else
                                          torch.from_numpy(mask)).numpy()))


@pytest.mark.parametrize("device,why", [("cuda", "not a prefix"),
                                        ("cpu", "runs on a card")])
@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_a_declined_batch_takes_the_padded_route(cont, device, why, caplog):
    model = _model(cont, dtype="bfloat16")
    enc, mask = _batch(cont, [7, 24, 12])
    if cont:
        mask[0, 3] = 0.0
    else:
        enc[0, 3] = 0
    engines.reset_seen()
    with caplog.at_level("INFO", logger="sketchformer_tpu_torch.engines"):
        assert fast_encode.packed_rows(model, enc, mask,
                                       torch.device(device)) is None
    assert "embed-pack: using padded path" in caplog.text
    noted = [r for r in caplog.records if "embed-pack" in r.getMessage()]
    if device == "cpu":
        # the CPU's own engine, noted at INFO; the reason is documented
        assert [r.levelname for r in noted] == ["INFO"]
        assert why in fast_encode.packed_support(model,
                                                 torch.device(device))[1]
    else:
        assert [r.levelname for r in noted] == ["WARNING"]
        assert why in caplog.text


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_a_non_prefix_batch_embeds_as_the_padded_stack(cont, monkeypatch):
    model = _model(cont)
    enc, mask = _batch(cont, [7, 24, 12])
    if cont:
        mask[0, 3] = 0.0
    else:
        enc[0, 3] = 0
    _on_the_card_route(monkeypatch)
    batch = {"enc": enc, "label": np.arange(3, dtype=np.int32)}
    if cont:
        batch["enc_mask"] = mask
    Z, _ = embed_dataset(model, [batch])
    enc_t = torch.from_numpy(enc)
    want = fast_encode.make_fast_embed_fn(model)(
        enc_t, None if mask is None else torch.from_numpy(mask))
    assert torch.equal(torch.from_numpy(Z), want)


@pytest.mark.parametrize("cont", [False, True], ids=["tok", "cont"])
def test_embed_dataset_packed_equals_padded(cont, monkeypatch):
    model = _model(cont)
    batches = []
    for seed, lengths in enumerate(([1, 24, 9, 16], [24, 2, 3, 20])):
        enc, mask = _batch(cont, lengths, seed)
        b = {"enc": enc, "label": np.arange(4, dtype=np.int32),
             "is_real": np.array([1, 1, 1, seed == 0], np.float32)}
        if cont:
            b["enc_mask"] = mask
        batches.append(b)
    padded = embed_dataset(model, batches)       # the CPU: padded
    _on_the_card_route(monkeypatch)
    before = dict(es.LAUNCHES)
    packed = embed_dataset(model, batches)
    assert es.LAUNCHES == before   # no kernel on a CPU
    assert packed[0].shape == (7, TINY["lowerdim"])
    np.testing.assert_array_equal(packed[1], padded[1])
    np.testing.assert_allclose(packed[0], padded[0], rtol=1e-6, atol=1e-6)
