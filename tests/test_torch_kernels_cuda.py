"""The hand-written CUDA kernels against their plain torch versions.

The tests marked ``cuda`` need an NVIDIA GPU and nvcc (the kernels build
for sm_90a at first use) and skip elsewhere; run them on the card with
``python -m pytest tests/test_torch_kernels_cuda.py -q``. The unmarked
tests pin, on any machine, what a wrapper does with tensors it does not
launch on: CPU tensors take the plain version, without counting a launch;
other devices raise.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sketchformer_tpu_torch.ops import decode_attention as da
from sketchformer_tpu_torch.ops import decode_chunk as dc
from sketchformer_tpu_torch.ops import encoder_stack as es

# max |kernel - plain| / max |plain|, as chip_smoke.py
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _rand(gen, device, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(shape, generator=gen, device=device)
            * scale).to(dtype)


def _close(got, want, dtype, scale=None):
    """max |got - want| <= TOL * max |want| (or * ``scale``, for a tensor
    that is zero up to rounding)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    ref = want.abs().max().item() if scale is None else scale
    rel = (got - want).abs().max().item() / ref
    assert rel <= TOL[dtype], rel


def _weights(gen, dev, L, d, H, dff, dtype):
    r = lambda *s, scale=0.1, dt=torch.float32: _rand(gen, dev, *s,
                                                       scale=scale, dtype=dt)
    Dh = d // H
    w = {"wqkv": r(L, d, 3 * d, scale=d ** -0.5, dt=dtype),
         "bqkv": r(L, 3 * d), "wo": r(L, d, d, scale=d ** -0.5, dt=dtype),
         "bo": r(L, d), "w1": r(L, d, dff, scale=d ** -0.5, dt=dtype),
         "b1": r(L, dff), "w2": r(L, dff, d, scale=dff ** -0.5, dt=dtype),
         "b2": r(L, d), "lnfs": 1 + r(1, d), "lnfb": r(1, d)}
    for s, b, n in (("ln1s", "ln1b", d), ("ln2s", "ln2b", d),
                    ("qns", "qnb", Dh), ("kns", "knb", Dh)):
        w[s], w[b] = 1 + r(L, n), r(L, n)
    return w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,relu,res", [
    (384, 64, 192, False, False),
    (384, 64, 64, False, True),
    (384, 128, 64, True, True),
    (77, 50, 33, True, True),
])
def test_linear(cuda, dtype, M, K, N, relu, res):
    gen = torch.Generator(device=cuda).manual_seed(0)
    r = lambda *s, **kw: _rand(gen, cuda, *s, **kw)
    a, w = r(M, K, dtype=dtype), r(K, N, scale=K ** -0.5, dtype=dtype)
    kw = dict(relu=relu, residual=r(M, N, dtype=dtype) if res else None)
    b = r(N, scale=0.1)
    before = es.LAUNCHES["linear"]
    got = es.linear(a, w, b, **kw)
    assert es.LAUNCHES["linear"] == before + 1
    _close(got, es.linear_reference(a, w, b, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 127, 12288 + 5])
@pytest.mark.parametrize("K,N", [(256, 64), (256, 192), (256, 256),
                                 (512, 512), (256, 768), (100, 70)])
@pytest.mark.parametrize("epi", [(), ("relu",), ("residual",), ("bits",),
                                 ("prng",), ("relu", "residual", "bits"),
                                 ("relu", "residual", "prng")],
                         ids=lambda e: "+".join(e) or "none")
def test_linear_bf16_modes(cuda, M, K, N, epi):
    """The bf16 wgmma kernel against the plain version at ragged M, widths
    that are and are not a multiple of 128, an unaligned K and N (zero
    columns added by the wrapper), every epilogue alone and together; a
    second run is bit-equal, and 'prng' equals 'bits' fed the plain
    Philox's bytes of the same site."""
    if "prng" in epi and N % 4:
        pytest.skip("in-kernel dropout needs N a multiple of 4")
    gen = torch.Generator(device=cuda).manual_seed(M + K + N)
    r = lambda *s, **kw: _rand(gen, cuda, *s, **kw)
    dt = torch.bfloat16
    a, w = r(M, K, dtype=dt), r(K, N, scale=K ** -0.5, dtype=dt)
    b = r(N, scale=0.1)
    kw = dict(relu="relu" in epi, thresh=26, keep_scale=1.0 / (1 - 26 / 256))
    if "residual" in epi:
        kw["residual"] = r(M, N, dtype=dt)
    site = dp.PrngSite(0x5EED, 1, 1, M)
    if "bits" in epi:
        kw["drop"] = _bytes(gen, cuda, M, N)
    if "prng" in epi:
        kw["drop"] = site
    before = es.LAUNCHES["linear"]
    got = es.linear(a, w, b, **kw)
    assert es.LAUNCHES["linear"] == before + 1
    assert torch.equal(got, es.linear(a, w, b, **kw))
    _close(got, es.linear_reference(a, w, b, **kw), dt)
    if "prng" in epi:
        kw["drop"] = dp.site_bytes_reference(site, M, N, cuda)
        assert torch.equal(got, es.linear(a, w, b, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,T,H,Dh,qk", [
    (4, 48, 4, 32, False), (4, 48, 4, 32, True), (2, 40, 2, 128, True),
    (3, 33, 2, 64, False),
])
def test_encoder_attention(cuda, dtype, B, T, H, Dh, qk):
    gen = torch.Generator(device=cuda).manual_seed(1)
    r = lambda *s, **kw: _rand(gen, cuda, *s, **kw)
    qkv = r(B, T, 3 * H * Dh, dtype=dtype)
    lengths = torch.tensor([0] + [T - 3 * i for i in range(1, B)],
                           device=cuda)      # row 0: every key masked
    km = torch.arange(T, device=cuda)[None, :] < lengths[:, None]
    bias = torch.where(km, 0.0, es.NEG_INF).float()
    norms = tuple(1 + r(Dh, scale=0.1) if i % 2 == 0 else r(Dh, scale=0.1)
                  for i in range(4)) if qk else None
    got = es.encoder_attention(qkv, bias, num_heads=H, qk_norm=norms)
    want = es.attention_reference(qkv, bias, num_heads=H, qk_norm=norms)
    _close(got, want, dtype)
    # a fully masked row attends uniformly, as the plain version
    assert torch.isfinite(got[0]).all()


# (M, D, x's offset in elements from a 16-byte boundary, route in f32, in
# bf16): the main paths' rows, D=128 (bf16: half a warp a row) at an M that
# is not a multiple of a warp's rows, widths with idle lanes, and the
# declined geometries: a D of no whole 16-byte vectors, a D past the
# registers (f32 512: 128 vectors), a misaligned view
LN_ROWS_CASES = [(12288, 256, 0, "ln_rows", "ln_rows"),
                 (49152, 256, 0, "ln_rows", "ln_rows"),
                 (1000, 128, 0, "ln_rows", "ln_rows"),
                 (1001, 128, 0, "ln_rows", "ln_rows"),
                 (300, 96, 0, "ln_rows", "ln_rows"),
                 (301, 50, 0, "ln_declined", "ln_declined"),
                 (16, 512, 0, "ln_declined", "ln_rows"),
                 (300, 256, 1, "ln_declined", "ln_declined")]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D,offset,route32,route16", LN_ROWS_CASES)
def test_layernorm_rows(cuda, dtype, M, D, offset, route32, route16):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _rand(gen, cuda, M * D + offset, dtype=dtype)[offset:].view(M, D)
    s, b = 1 + _rand(gen, cuda, D, scale=0.1), _rand(gen, cuda, D, scale=0.1)
    route = route32 if dtype == torch.float32 else route16
    before = dict(es.ROUTES)
    got = es.layernorm_rows(x, s, b)
    assert es.ROUTES == {**before, route: before[route] + 1}
    _close(got, es.layernorm_rows_reference(x, s, b), dtype)
    # near-constant rows, where the variance clamp acts: c in [0.5, 1) plus
    # 0-3 of its f32 ulps an element (bf16 rounds most to constant rows).
    # In f32 they are held within their conditioning: each mean is within
    # (D - 1) 2^-24 max|x| of the exact one, x - mu within a few ulps of c,
    # and both reach y times rstd <= 1 / sqrt(eps) times the scale
    n = M // 2
    c = 0.5 + 0.5 * torch.rand((n, 1), generator=gen, device=cuda)
    ulp = torch.nextafter(c, torch.full_like(c, 2.0)) - c
    near = c + torch.randint(0, 4, (n, D), generator=gen, device=cuda) * ulp
    x[:n] = near.to(dtype)
    got = es.layernorm_rows(x, s, b)
    want = es.layernorm_rows_reference(x, s, b)
    if dtype == torch.bfloat16:
        _close(got, want, dtype)
        return
    _close(got[n:], want[n:], dtype)
    bound = ((2 * (D - 1) * 2.0 ** -24 * near.abs().amax(1, keepdim=True)
              + 4 * ulp) * 1e3 * s.abs().max())
    assert ((got[:n] - want[:n]).abs() <= bound).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,qk", [(8, False), (8, True), (2, True)])
def test_fused_encoder_stack(cuda, dtype, H, qk):
    gen = torch.Generator(device=cuda).manual_seed(3)
    B, T, d, dff, L = 6, 64, 256, 512, 3
    w = _weights(gen, cuda, L, d, H, dff, dtype)
    x = _rand(gen, cuda, B, T, d, dtype=dtype)
    km = torch.arange(T, device=cuda)[None, :] < torch.tensor(
        [0, T, 40, 17, 1, 63], device=cuda)[:, None]
    es.reset_launches()
    got = es.fused_encoder_stack(x, km, w, num_heads=H, qk_norm=qk)
    assert es.LAUNCHES == {"linear": 4 * L, "encoder_attention": L,
                           "ragged_attention": 0,
                           "layernorm_rows": 2 * L + 1, "linear_nt": 0,
                           "linear_tn": 0}
    ref = es.encoder_stack_reference(x, km, w, num_heads=H, qk_norm=qk)
    if dtype == torch.float32:
        _close(got, ref, dtype)
        return
    # bf16 through L layers: as accurate as the plain path, against the
    # float32 computation of the same inputs (chip_smoke.py's rule)
    ref32 = es.encoder_stack_reference(
        x.float(), km, {k: v.float() for k, v in w.items()}, num_heads=H,
        qk_norm=qk)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err_k = (got.float() - ref32).abs().max().item()
    err_p = (ref.float() - ref32).abs().max().item()
    assert err_k <= 2.0 * err_p, (err_k, err_p)


# the ragged attention's tile edges (64-row query blocks, 32-key tiles),
# one row and a whole sketch, in one T = 192 batch
RAGGED_LENGTHS = [1, 31, 32, 33, 63, 64, 65, 191, 192]


def _on(rows, dev):
    """:class:`es.PackedRows` with its tensors on ``dev``."""
    return rows.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("H,Dh", [(8, 32), (4, 64), (2, 128)])
@pytest.mark.parametrize("qk", [False, True], ids=["plain", "qk-norm"])
def test_ragged_attention_equals_the_padded_kernel_on_valid_rows(cuda, H, Dh,
                                                                 qk):
    gen = torch.Generator(device=cuda).manual_seed(11)
    r = lambda *s, **kw: _rand(gen, cuda, *s, **kw)
    B, T = len(RAGGED_LENGTHS), 192
    qkv = r(B, T, 3 * H * Dh, dtype=torch.bfloat16)
    valid = np.arange(T)[None, :] < np.array(RAGGED_LENGTHS)[:, None]
    bias = torch.where(torch.from_numpy(valid).to(cuda), 0.0,
                       es.NEG_INF).float()
    norms = tuple(1 + r(Dh, scale=0.1) if i % 2 == 0 else r(Dh, scale=0.1)
                  for i in range(4)) if qk else None
    rows, _ = es.pack_rows(valid)
    rows = _on(rows, cuda)
    index = rows.index.long()
    padded = es.encoder_attention(qkv, bias, num_heads=H, qk_norm=norms)
    before, routes = dict(es.LAUNCHES), dict(es.ROUTES)
    ragged = dict(es.RAGGED_ROUTES)
    got = es.ragged_attention(
        qkv.reshape(B * T, -1).index_select(0, index), rows, num_heads=H,
        qk_norm=norms)
    # its own counter: encoder_attention's count and routes are the padded
    # kernel's launches alone; the persistent walk takes the embed path's
    # heads (Dh 32, no qk-norm), the 64-row query blocks the rest
    assert es.LAUNCHES == {**before,
                           "ragged_attention": before["ragged_attention"] + 1}
    assert es.ROUTES == routes
    route = "persistent" if (Dh, qk) == (32, False) else "tiles"
    assert es.RAGGED_ROUTES == {**ragged, route: ragged[route] + 1}
    torch.cuda.synchronize()
    assert torch.equal(got, padded.reshape(B * T, -1).index_select(0, index))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 2024])
def test_ragged_persistent_equals_tiles_at_the_embed_cells_batch(cuda, seed):
    """The embed cell's batch (B = 2048 sketches of 16-191 tokens and their
    EOS, permuted by the seed; tok_h8's heads): the persistent walk's
    output is the query-block grid's bit for bit, and a re-run's."""
    B, T, H, Dh = 2048, 192, 8, 32
    rng = np.random.default_rng(seed)
    lengths = rng.permutation(np.arange(B) % 176 + 17)
    valid = np.arange(T)[None, :] < lengths[:, None]
    rows = _on(es.pack_rows(valid)[0], cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    qkv = _rand(gen, cuda, int(lengths.sum()), 3 * H * Dh,
                dtype=torch.bfloat16)
    assert es.ragged_route(int(lengths.max()), Dh, False)[0] == "persistent"
    got = es.ragged_attention_on("persistent", qkv, rows, num_heads=H)
    again = es.ragged_attention_on("persistent", qkv, rows, num_heads=H)
    want = es.ragged_attention_on("tiles", qkv, rows, num_heads=H)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got, again)


@pytest.mark.cuda
def test_a_sketch_longer_than_the_stage_takes_the_tiles_route(cuda):
    H, Dh, T = 8, 32, 256
    lengths = np.array([es.RAGGED_STAGE_ROWS + 1, 40, 192, 7])
    valid = np.arange(T)[None, :] < lengths[:, None]
    gen = torch.Generator(device=cuda).manual_seed(3)
    qkv = _rand(gen, cuda, len(lengths), T, 3 * H * Dh,
                dtype=torch.bfloat16)
    bias = torch.where(torch.from_numpy(valid).to(cuda), 0.0,
                       es.NEG_INF).float()
    rows = _on(es.pack_rows(valid)[0], cuda)
    index = rows.index.long()
    padded = es.encoder_attention(qkv, bias, num_heads=H)
    ragged = dict(es.RAGGED_ROUTES)
    got = es.ragged_attention(qkv.reshape(-1, 3 * H * Dh).index_select(
        0, index), rows, num_heads=H)
    assert es.RAGGED_ROUTES == {**ragged, "tiles": ragged["tiles"] + 1}
    with pytest.raises(ValueError, match="stage"):
        es.ragged_attention_on("persistent", qkv.reshape(
            -1, 3 * H * Dh).index_select(0, index), rows, num_heads=H)
    torch.cuda.synchronize()
    assert torch.equal(got, padded.reshape(-1, H * Dh).index_select(0, index))


def _cell_batches(cont, B, n, T=192, seed=5):
    """n host batches of the embed cell's traffic: lengths 16-191, then
    EOS and PAD (tokens), or stroke rows then zeros with their mask."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = rng.integers(16, 192, B)
        pos = np.arange(T)[None, :]
        b = {"label": rng.integers(0, 345, B).astype(np.int32)}
        if cont:
            valid = pos < lengths[:, None]
            rows = rng.standard_normal((B, T, 3)).astype(np.float32)
            b["enc"] = rows * valid[..., None]
            b["enc_mask"] = valid.astype(np.float32)
        else:
            ids = rng.integers(4, 10004, (B, T)).astype(np.int32)
            ids[pos == lengths[:, None]] = 2           # EOS
            ids[pos > lengths[:, None]] = 0            # PAD
            b["enc"] = ids
        out.append(b)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("cont,B", [(False, 2048), (True, 256)],
                         ids=["tok-cell", "cont"])
def test_embed_dataset_packed_equals_padded(cuda, cont, B, monkeypatch):
    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.infer import fast_encode
    from sketchformer_tpu_torch.infer.encode import embed_dataset
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    torch.manual_seed(0)
    cfg = SketchformerConfig(
        vocab_size=10004, num_classes=345, max_len=192, d_model=256,
        num_layers=8, num_heads=8, dff=512, lowerdim=256, num_queries=4,
        dropout=0.0, attn_impl="pallas", dtype="bfloat16",
        use_continuous=cont, qk_norm=cont, num_mixtures=20)
    model = Sketchformer(cfg).to(cuda).eval()
    batches = _cell_batches(cont, B, 2)
    es.reset_launches()
    before = dict(es.ROUTES)
    Z, labels = embed_dataset(model, batches)
    assert es.ROUTES["packed"] == before["packed"] + 2
    assert es.ROUTES["padded"] == before["padded"]
    assert es.LAUNCHES["ragged_attention"] == 2 * cfg.num_layers
    assert es.LAUNCHES["encoder_attention"] == 0
    monkeypatch.setattr(fast_encode, "packed_rows", lambda *a: None)
    Z_pad, labels_pad = embed_dataset(model, batches)
    assert es.ROUTES["padded"] == before["padded"] + 2
    assert Z.shape == (2 * B, 256) and np.isfinite(Z).all()
    np.testing.assert_array_equal(labels, labels_pad)
    np.testing.assert_array_equal(Z, Z_pad)


def _tok_h8_model(dev):
    """The embed cell's model (tok_h8's widths, bf16, seeded weights) on
    ``dev``."""
    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.convert import init_params
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    cfg = SketchformerConfig(
        vocab_size=10004, num_classes=345, max_len=192, d_model=256,
        num_layers=8, num_heads=8, dff=512, lowerdim=256, num_queries=4,
        dropout=0.0, attn_impl="pallas", dtype="bfloat16")
    model = Sketchformer(cfg)
    model.load_state_dict(init_params(cfg, seed=3))
    return model.to(dev).eval()


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "padded"])
def test_embed_dataset_waits_on_the_device_only_in_its_drain(cuda, packed,
                                                             monkeypatch):
    """Every call of the loop's body (the pack, the pinned input copy,
    ``fast_embed``, the pinned z copy) runs under
    ``set_sync_debug_mode("error")``; the drain's event wait alone is let
    through."""
    from sketchformer_tpu_torch.infer import fast_encode
    from sketchformer_tpu_torch.infer.encode import embed_dataset

    model = _tok_h8_model(cuda)
    batches = _cell_batches(False, 2048, 4)
    if not packed:
        monkeypatch.setattr(fast_encode, "packed_rows", lambda *a: None)
    want, _ = embed_dataset(model, batches)   # builds the kernels, warms
    torch.cuda.synchronize()
    waits = []
    event_sync = torch.cuda.Event.synchronize

    def drain_wait(event):
        waits.append(event)
        torch.cuda.set_sync_debug_mode(0)
        try:
            event_sync(event)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(torch.cuda.Event, "synchronize", drain_wait)
    route = "packed" if packed else "padded"
    before = es.ROUTES[route]
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):   # a pageable scalar copy syncs
            torch.tensor(1.0, device=cuda)
        Z, _ = embed_dataset(model, batches)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(waits) == len(batches)
    assert es.ROUTES[route] == before + len(batches)
    np.testing.assert_array_equal(Z, want)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "padded"])
def test_fast_embed_z_equals_the_device_scalar_formula(cuda, packed,
                                                       monkeypatch):
    """z with sqrt(d_model) and 1/sqrt(head_dim) as 0-d CPU tensors equals,
    bit for bit, z with each made as a 0-d tensor on the card."""
    from sketchformer_tpu_torch.infer import fast_encode
    from sketchformer_tpu_torch.models import attention

    model = _tok_h8_model(cuda)
    (b,) = _cell_batches(False, 2048, 1, seed=9)
    enc = torch.from_numpy(b["enc"]).to(cuda)
    rows = None
    if packed:
        rows = _on(fast_encode.packed_rows(model, b["enc"], None, cuda),
                   cuda)
    embed = fast_encode.make_fast_embed_fn(model)
    z = embed(enc, None, rows)
    host_scalar = attention._scale

    def device_scale(q):
        return host_scalar(q).to(q.device)

    monkeypatch.setattr(attention, "_scale", device_scale)
    monkeypatch.setattr(model.enc_embed, "sqrt_d",
                        model.enc_embed.sqrt_d.to(cuda))
    z_device = embed(enc, None, rows)
    torch.cuda.synchronize()
    assert model.enc_embed.sqrt_d.device.type == "cuda"
    assert torch.isfinite(z).all() and z.abs().max() > 0
    assert torch.equal(z, z_device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("BH,Tmax,Dh,offset,route", [
    (48, 40, 32, 0, "bulk"), (6, 33, 128, 0, "bulk"), (10, 20, 64, 0, "bulk"),
    (512, 192, 32, 0, "bulk"), (512, 192, 64, 0, "bulk"),
    (512, 192, 128, 0, "bulk"), (511, 192, 32, 0, "bulk"),
    (5, 9, 24, 0, "declined"), (48, 40, 32, 1, "declined")])
def test_decode_attention(cuda, dtype, BH, Tmax, Dh, offset, route):
    """The decode's B*H = 512 at the first, an early, the middle and the
    last step of a T=192 decode; a B*H that is not a multiple of the bulk
    kernel's rows a block; the declined geometries on the per-row kernel
    (a head of three 16-byte vectors, a cache 2 bytes off its 16-byte
    boundary)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _rand(gen, cuda, BH, 1, Dh, dtype=dtype)
    k, v = (_rand(gen, cuda, BH * Tmax * Dh + offset, dtype=dtype)[offset:]
            .view(BH, Tmax, Dh) for _ in range(2))
    lens = (1, 31, 96, 191) if Tmax == 192 else (1, 17 % Tmax + 1, Tmax)
    for cache_len in lens:
        before = da.LAUNCHES["decode_attention"]
        routes = dict(da.ROUTES)
        got = da.decode_attention(q, k, v, cache_len)
        assert da.LAUNCHES["decode_attention"] == before + 1
        assert da.ROUTES == {**routes, route: routes[route] + 1}
        _close(got, da.decode_attention_reference(q, k, v, cache_len), dtype)


def _chunk_operands(gen, dev, *, B, L, d, H, dff, N, Tmax, Mq, K, t0, dtype,
                    cont):
    """Random operands of one decode chunk: stacked trunk weights, cross
    K/V, caches filled below ``t0``, the input embedding, the head and the
    carried state (a third of the rows already finished)."""
    r = lambda *s, scale=0.1, dt=torch.float32: _rand(gen, dev, *s,
                                                       scale=scale, dtype=dt)
    Dh = d // H
    w = {"s_wqkv": r(L, d, 3 * d, scale=d ** -0.5, dt=dtype),
         "s_bqkv": r(L, 3 * d),
         "s_wo": r(L, d, d, scale=d ** -0.5, dt=dtype), "s_bo": r(L, d),
         "c_wq": r(L, d, d, scale=d ** -0.5, dt=dtype), "c_bq": r(L, d),
         "c_wo": r(L, d, d, scale=d ** -0.5, dt=dtype), "c_bo": r(L, d),
         "w1": r(L, d, dff, scale=d ** -0.5, dt=dtype), "b1": r(L, dff),
         "w2": r(L, dff, d, scale=dff ** -0.5, dt=dtype), "b2": r(L, d),
         "lnfs": 1 + r(1, d), "lnfb": r(1, d)}
    for s, b, n in (("ln1s", "ln1b", d), ("ln2s", "ln2b", d),
                    ("ln3s", "ln3b", d), ("s_qns", "s_qnb", Dh),
                    ("s_kns", "s_knb", Dh), ("c_qns", "c_qnb", Dh)):
        w[s], w[b] = 1 + r(L, n), r(L, n)
    kc, vc = (torch.zeros(L, B * H, Tmax, Dh, dtype=dtype, device=dev)
              for _ in range(2))
    kc[:, :, :t0] = r(L, B * H, t0, Dh, scale=1.0, dt=dtype)
    vc[:, :, :t0] = r(L, B * H, t0, Dh, scale=1.0, dt=dtype)
    ops = dict(k_cache=kc, v_cache=vc,
               cross_k=r(L, B * H, Mq, Dh, scale=1.0, dt=dtype),
               cross_v=r(L, B * H, Mq, Dh, scale=1.0, dt=dtype),
               pos_chunk=r(K, d, scale=1.0, dt=dtype),
               head_w=r(d, N, scale=d ** -0.5, dt=dtype), head_b=r(N),
               w=w, t0=t0,
               finished=(torch.arange(B, device=dev) % 3 == 1).int())
    if cont:
        ops.update(in_w=r(5, d, scale=0.5, dt=dtype), in_b=r(d),
                   prev_row=torch.cat([r(B, 2, scale=1.0), F.one_hot(
                       torch.arange(B, device=dev) % 2, 3).float()], -1))
    else:
        ops.update(emb=r(N, d, scale=d ** -0.5, dt=dtype),
                   prev=torch.randint(4, N, (B,), generator=gen,
                                      device=dev).int())
    return ops


def _agreeing_steps(margins):
    """Per row, the steps before the plain version's first near tie."""
    K = margins.shape[1]
    tie = margins < 1
    return torch.where(tie.any(1), tie.int().argmax(1), K)


def _check_chunk(got, want, n, got_kv, want_kv, t0, dtype):
    """Picks equal and k/v rows close for each row's agreeing steps: the
    k/v row of step j reads step j-1's pick, so the rows go one further."""
    K = got[0].shape[1]
    steps = torch.arange(K, device=n.device)
    before = steps[None] < n[:, None]                       # (B, K)
    for g, w in zip(got, want):
        if g.is_floating_point():
            _close(g[before], w[before], dtype)
        else:
            assert torch.equal(g[before], w[before])
    for g, w in zip(got_kv, want_kv):
        L, BH, _, Dh = g.shape
        B = n.shape[0]
        rows = (steps[None] <= n[:, None])[None, :, None, :, None].expand(
            L, B, BH // B, K, Dh)
        g = g[:, :, t0:t0 + K].reshape(L, B, BH // B, K, Dh)[rows]
        w = w[:, :, t0:t0 + K].reshape(L, B, BH // B, K, Dh)[rows]
        _close(g, w, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,qk,t0,rows", [
    (4, False, 0, 1), (4, True, 8, 1), (1, True, 24, 1), (2, False, 8, 1),
    (4, True, 8, 2), (4, False, 16, 512), (2, True, 8, 512),
    (4, True, 8, "unpadded"), (2, False, 16, "pos8")])
@pytest.mark.parametrize("cont", [False, True], ids=["token", "mdn"])
def test_decode_chunk(cuda, dtype, H, qk, t0, rows, cont):
    """``rows`` 1: B=7, one part-empty row group of the bf16 cluster kernel;
    2: a batch above the SM count, which the f32 kernel runs two rows per
    block (the last block half empty) and the cluster kernel in groups of
    32 (the last part-empty); 512: B=512, the cluster kernel's largest
    groups. The head is padded by ``pad_head``, and bf16 launches the
    cluster kernel, f32 the per-row one; bf16 geometries that
    ``cluster_decline`` names take the per-row kernel: "unpadded" (B=7, the
    head left at its width) and "pos8" (B=7, position rows 8 bytes off a
    16-byte boundary)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B = {1: 7, 512: 512, "unpadded": 7, "pos8": 7}.get(
        rows, torch.cuda.get_device_properties(cuda).multi_processor_count
        + 3)
    L, d, dff, K, Tmax = 2, 128, 256, 8, 32
    N = 6 * 5 + 3 if cont else 517
    ops = _chunk_operands(gen, cuda, B=B, L=L, d=d, H=H, dff=dff, N=N,
                          Tmax=Tmax, Mq=3, K=K, t0=t0, dtype=dtype,
                          cont=cont)
    if rows != "unpadded":
        ops["head_w"], ops["head_b"] = dc.pad_head(
            ops["head_w"], ops["head_b"], cont=cont)
    if rows == "pos8":
        off = 8 // ops["pos_chunk"].element_size()
        pos = torch.empty(K * d + off, dtype=dtype, device=cuda)[off:]
        ops["pos_chunk"] = pos.view(K, d).copy_(ops["pos_chunk"])
    kv_ref = (ops["k_cache"].clone(), ops["v_cache"].clone())
    name = "decode_cont_chunk" if cont else "decode_chunk"
    before = dc.LAUNCHES[name]
    routes = dict(dc.ROUTES)
    if cont:
        kw = dict(num_heads=H, num_mixtures=5, qk_norm=qk)
        args = lambda kc, vc: (
            ops["prev_row"], ops["finished"], kc, vc, ops["cross_k"],
            ops["cross_v"], ops["in_w"], ops["in_b"], ops["pos_chunk"],
            ops["head_w"], ops["head_b"], ops["w"], t0)
        got = dc.decode_cont_chunk(*args(ops["k_cache"], ops["v_cache"]),
                                   **kw)
        *want, margins = dc.decode_cont_chunk_reference(
            *args(*kv_ref), **kw, return_margins=True)
        assert torch.isfinite(got[0]).all()
    else:
        kw = dict(num_heads=H, qk_norm=qk)
        args = lambda kc, vc: (
            ops["prev"], ops["finished"], kc, vc, ops["cross_k"],
            ops["cross_v"], ops["emb"], ops["pos_chunk"], ops["head_w"],
            ops["head_b"], ops["w"], t0)
        got = dc.decode_chunk(*args(ops["k_cache"], ops["v_cache"]), **kw)
        *want, margins = dc.decode_chunk_reference(
            *args(*kv_ref), **kw, return_margins=True)
    assert dc.LAUNCHES[name] == before + 1
    declined = rows in ("unpadded", "pos8")
    route = ("cluster" if dtype == torch.bfloat16 and not declined
             else "rows")
    assert dc.ROUTES == {**routes, route: routes[route] + 1}
    n = _agreeing_steps(margins)
    assert int(n.sum()) >= B * K // 2      # most steps are compared
    _check_chunk(got[:-1], want[:-1], n, (ops["k_cache"], ops["v_cache"]),
                 kv_ref, t0, dtype)
    # the cache below t0 is untouched
    assert torch.equal(ops["k_cache"][:, :, :t0], kv_ref[0][:, :, :t0])
    if bool((n == K).all()):
        assert torch.equal(got[-1], want[-1])


@pytest.mark.cuda
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    a = torch.zeros(8, 16, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        es.linear(a, torch.zeros(16, 8, dtype=torch.float16, device=cuda),
                  torch.zeros(8, device=cuda))
    qkv = torch.zeros(1, 8, 3 * 2 * 256, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        es.encoder_attention(qkv, None, num_heads=2)
    q = torch.zeros(4, 1, 32, device=cuda)
    with pytest.raises(ValueError, match="cache_len"):
        da.decode_attention(q, torch.zeros(4, 8, 32, device=cuda),
                            torch.zeros(4, 8, 32, device=cuda), 9)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32))
    b = torch.zeros(6)
    es.reset_launches()
    assert torch.equal(es.linear(a, w, b, relu=True),
                       es.linear_reference(a, w, b, relu=True))
    assert torch.equal(es.layernorm_rows(a, torch.ones(8), b[:1].expand(8)),
                       es.layernorm_rows_reference(a, torch.ones(8),
                                                   b[:1].expand(8)))
    assert es.LAUNCHES == {"linear": 0, "encoder_attention": 0,
                           "ragged_attention": 0,
                           "layernorm_rows": 0, "linear_nt": 0,
                           "linear_tn": 0}
    q = torch.from_numpy(rng.standard_normal((6, 1, 8)).astype(np.float32))
    kv = torch.from_numpy(rng.standard_normal((6, 5, 8)).astype(np.float32))
    da.reset_launches()
    assert torch.equal(da.decode_attention(q, kv, kv, 3),
                       da.decode_attention_reference(q, kv, kv, 3))
    assert da.LAUNCHES == {"decode_attention": 0}


def test_other_devices_raise():
    a = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        es.linear(a, a, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        es.encoder_attention(torch.zeros(1, 4, 6, device="meta"), None,
                             num_heads=1)
    with pytest.raises(ValueError, match="unsupported device"):
        es.layernorm_rows(a, a[0], a[0])
    with pytest.raises(ValueError, match="unsupported device"):
        da.decode_attention(torch.zeros(2, 1, 4, device="meta"), a[None],
                            a[None], 1)
    z = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dc.decode_chunk(z, z, *(None,) * 9, 0, num_heads=1)
    with pytest.raises(ValueError, match="unsupported device"):
        dc.decode_cont_chunk(z, z, *(None,) * 10, 0, num_heads=1,
                             num_mixtures=1)


# ---------------------------------------------------------------------------
# the training stacks' kernels
# ---------------------------------------------------------------------------

from sketchformer_tpu_torch.ops import attention_train as at  # noqa: E402
from sketchformer_tpu_torch.ops import decoder_stack_train as dst  # noqa: E402
from sketchformer_tpu_torch.ops import encoder_stack_train as est  # noqa: E402
from sketchformer_tpu_torch.ops import norm_train as nt  # noqa: E402
from sketchformer_tpu_torch.ops import dropout_prng as dp  # noqa: E402


def _bytes(gen, dev, *shape):
    return torch.randint(0, 256, shape, dtype=torch.uint8, generator=gen,
                         device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_dropout_epilogue(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = _rand(gen, cuda, 300, 64, dtype=dtype)
    w = _rand(gen, cuda, 64, 96, scale=0.125, dtype=dtype)
    b, res = _rand(gen, cuda, 96, scale=0.1), _rand(gen, cuda, 300, 96,
                                                      dtype=dtype)
    kw = dict(residual=res, drop=_bytes(gen, cuda, 300, 96), thresh=26,
              keep_scale=est.keep_scales(26, dtype)[0])
    _close(es.linear(a, w, b, **kw), es.linear_reference(a, w, b, **kw),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("a_f32,gate,out_dt", [(True, False, False),
                                               (False, True, False),
                                               (True, False, True)])
def test_linear_nt(cuda, dtype, a_f32, gate, out_dt):
    gen = torch.Generator(device=cuda).manual_seed(7)
    M, N, K = 333, 96, 80
    a = _rand(gen, cuda, M, N, dtype=torch.float32 if a_f32 else dtype)
    w = _rand(gen, cuda, K, N, scale=N ** -0.5, dtype=dtype)
    kw = dict(drop=_bytes(gen, cuda, M, N), thresh=26, keep_scale=1.11)
    if gate:
        kw["gate"] = torch.relu(_rand(gen, cuda, M, K, dtype=dtype))
    if out_dt:
        kw.update(out_dtype=dtype, residual=_rand(gen, cuda, M, K,
                                                  dtype=dtype))
    before = es.LAUNCHES["linear_nt"]
    got = es.linear_nt(a, w, **kw)
    assert es.LAUNCHES["linear_nt"] == before + 1
    _close(got, es.linear_nt_reference(a, w, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,y_f32,mode,bias", [
    (1000, 72, 130, True, "bits", True),     # ragged, a few splits
    (4100, 72, 132, False, "prng", True),
    (77, 50, 36, True, None, False),         # ragged K: bf16 pads the rows
    (12288, 256, 768, True, "bits", True),   # the main path's QKV shape
    (12288, 512, 256, False, "prng", False),
])
def test_linear_tn(cuda, dtype, M, K, N, y_f32, mode, bias):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _rand(gen, cuda, M, K, dtype=dtype)
    y = _rand(gen, cuda, M, N, dtype=torch.float32 if y_f32 else dtype)
    kw = dict(thresh=26, keep_scale=1.11, bias_grad=bias)
    if mode == "bits":
        kw["drop"] = _bytes(gen, cuda, M, N)
    elif mode == "prng":
        kw["drop"] = dp.PrngSite(1234567, 1, 2, M // 4 if M % 4 == 0 else M)
    before = es.LAUNCHES["linear_tn"]
    got = es.linear_tn(x, y, **kw)
    assert es.LAUNCHES["linear_tn"] == before + 1
    want = es.linear_tn_reference(x, y, **kw)
    again = es.linear_tn(x, y, **kw)
    got, want, again = ((t,) if not bias else t for t in (got, want, again))
    for g, w, a in zip(got, want, again):
        assert g.dtype == torch.float32
        _close(g, w, dtype)
        assert torch.equal(g, a)    # a fixed order of the split partials
    assert es.tn_plan(M, K, N, dtype)[2] > 1 or M < 1000


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,N", [(50, 70), (9000, 256), (6144, 64),
                                 (12288, 768), (49152, 128)])
def test_sum_rows(cuda, dtype, R, N):
    """One launch, within f32 rounding of the plain sum, and equal across
    two runs (the slices' partial rows are added in a fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = _rand(gen, cuda, R, N, dtype=dtype)
    before = nt.LAUNCHES["sum_rows"]
    got = nt.sum_rows(x)
    assert nt.LAUNCHES["sum_rows"] == before + 1
    _close(got, nt.sum_rows_reference(x), torch.float32)
    assert torch.equal(got, nt.sum_rows(x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D,resid_dt,out_dt", [(300, 96, True, False),
                                                 (1000, 256, False, True),
                                                 (1000, 128, True, True),
                                                 (777, 128, None, False),
                                                 (49152, 256, True, False)])
def test_layernorm_bwd(cuda, dtype, M, D, resid_dt, out_dt):
    """dx, dscale and dbias from one launch (no sum_rows), within TOL of
    the plain version and equal across two runs; ``resid_dt`` None: no
    residual."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = _rand(gen, cuda, M, D, dtype=dtype)
    dy = _rand(gen, cuda, M, D)
    s = 1 + _rand(gen, cuda, D, scale=0.1)
    kw = dict(resid=None if resid_dt is None else
              _rand(gen, cuda, M, D,
                    dtype=dtype if resid_dt else torch.float32),
              out_dtype=dtype if out_dt else torch.float32)
    launches = dict(nt.LAUNCHES)
    got = nt.layernorm_bwd(x, dy, s, **kw)
    assert nt.LAUNCHES == dict(launches,
                               layernorm_bwd=launches["layernorm_bwd"] + 1)
    again = nt.layernorm_bwd(x, dy, s, **kw)
    for i, (g, w, a) in enumerate(zip(
            got, nt.layernorm_bwd_reference(x, dy, s, **kw), again)):
        _close(g, w, dtype if out_dt and i == 0 else torch.float32)
        assert torch.equal(g, a)


def _attn_case(gen, dev, dtype, B, Tq, Tk, H, Dh, qk, masked):
    q = _rand(gen, dev, B, Tq, 3 * H * Dh, dtype=dtype)[..., :H * Dh]
    kv = _rand(gen, dev, B, Tk, 2 * H * Dh, dtype=dtype)
    k, v = kv[..., :H * Dh], kv[..., H * Dh:]
    bias = None
    if masked:
        lengths = torch.tensor([Tk - 2 * i for i in range(B)], device=dev)
        bias = torch.where(torch.arange(Tk, device=dev)[None] <
                           lengths[:, None], 0.0, at.NEG_INF).float()
    norms = tuple(1 + _rand(gen, dev, Dh, scale=0.1) if i % 2 == 0
                  else _rand(gen, dev, Dh, scale=0.1)
                  for i in range(4)) if qk else None
    return q, k, v, bias, norms


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Tq,Tk,H,Dh,causal,qk,norm_p", [
    (3, 40, 40, 4, 32, True, True, True),
    (3, 40, 40, 2, 128, False, False, False),
    (3, 37, 4, 4, 32, False, True, True),
    (2, 70, 70, 2, 64, True, False, True),
])
def test_attention_fwd_and_bwd(cuda, dtype, B, Tq, Tk, H, Dh, causal, qk,
                               norm_p):
    gen = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, bias, norms = _attn_case(gen, cuda, dtype, B, Tq, Tk, H, Dh,
                                      qk, masked=True)
    kw = dict(num_heads=H, causal=causal, qk_norm=norms)
    _close(at.attention_fwd(q, k, v, bias, norm_p=norm_p, **kw),
           at.attention_fwd_reference(q, k, v, bias, norm_p=norm_p, **kw),
           dtype)
    do = _rand(gen, cuda, B, Tq, H * Dh)
    got = at.attention_bwd_q(q, k, v, do, bias, **kw)
    want = at.attention_bwd_q_reference(q, k, v, do, bias, **kw)
    _close(got[0], want[0], dtype)
    _close(got[1], want[1], torch.float32 if dtype == torch.float32
           else dtype)
    got_kv = at.attention_bwd_kv(q, k, v, do, bias, want[1], **kw)
    want_kv = at.attention_bwd_kv_reference(q, k, v, do, bias, want[1], **kw)
    for g, w in zip(got_kv[:2], want_kv[:2]):
        _close(g, w, dtype)
    if qk:
        _close(got[2], want[2], dtype)
        _close(got[3], want[3], dtype)
        _close(got_kv[2], want_kv[2], dtype)
        # the k-norm bias shifts every key of a row alike, so its gradient
        # is zero up to rounding: held at the k-norm scale's magnitude
        _close(got_kv[3], want_kv[3], dtype,
               scale=want_kv[2].abs().max().item())


def _train_stack_case(gen, dev, decoder, H, qk, B=4, T=48, d=128, L=2,
                      dff=256):
    """A stack module with random parameters, its differentiable operands,
    an input and a key mask."""
    from sketchformer_tpu_torch.models.transformer import Decoder, Encoder

    mod = (Decoder if decoder else Encoder)(L, H, d, dff, torch.float32,
                                           "pallas", True, qk).to(dev)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            base = 1.0 if name.endswith("scale") else 0.0
            p.copy_(base + _rand(gen, dev, *p.shape,
                                 scale=0.05 if "kernel" in name else 0.1))
    x = _rand(gen, dev, B, T, d).requires_grad_(True)
    km = torch.arange(T, device=dev)[None] < torch.tensor(
        [T, T - 5, 20, 1], device=dev)[:, None]
    return mod, mod.stacked_weights(grad=True), x, km


@pytest.mark.cuda
@pytest.mark.parametrize("decoder", [False, True], ids=["encoder",
                                                         "decoder"])
@pytest.mark.parametrize("H,qk", [(4, True), (1, False)])
def test_train_stack_fwd_bwd(cuda, decoder, H, qk):
    """Whole stack forward + backward in f32, kernels against the plain
    versions, dropout on."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    mod, w, x, km = _train_stack_case(gen, cuda, decoder, H, qk)
    B, T, d = x.shape
    L = 2
    drop = _bytes(gen, cuda, (3 if decoder else 2) * L, B, T, d)
    gy = _rand(gen, cuda, B, T, d)
    mem = _rand(gen, cuda, B, 4, d).requires_grad_(True)

    def run(ops):
        if decoder:
            y = dst.fused_decoder_stack_train(
                x, mem, km, None, w, num_heads=H, qk_norm=qk,
                dropout_rate=0.1, dropout_bytes=drop, ops=ops)
            inputs = [x, mem]
        else:
            y = est.fused_encoder_stack_train(
                x, km, w, num_heads=H, qk_norm=qk, dropout_rate=0.1,
                dropout_bytes=drop, ops=ops)
            inputs = [x]
        names = ["x", "mem"][:len(inputs)] + [
            n for n, _ in mod.named_parameters()]
        grads = torch.autograd.grad((y.float() * gy).sum(),
                                    inputs + list(mod.parameters()),
                                    allow_unused=True)
        return [("y", y)] + [(n, g) for n, g in zip(names, grads)
                             if g is not None]

    got, want = run(est.KERNELS), run(est.PLAIN)
    torch.cuda.synchronize()
    top = max(g.abs().max().item() for _, g in want[1:])
    for (name, g), (_, r) in zip(got, want):
        # chip_smoke.py's rule: relative L2 within 1e-3, since a ReLU
        # pre-activation within rounding of zero is gated differently by two
        # summation orders; a key bias (projection or k-norm) shifts every
        # key of a row alike, so its gradient is zero up to rounding, held
        # at the largest gradient's scale
        assert torch.isfinite(g).all(), name
        if name.endswith(("key.bias", "k_norm.bias")):
            assert (g - r).abs().max().item() <= TOL[torch.float32] * top, \
                name
            continue
        assert (g - r).norm().item() <= 1e-3 * r.norm().item(), name


# ---------------------------------------------------------------------------
# K6: the fused vocab-CE head; K7: the in-kernel dropout draw
# ---------------------------------------------------------------------------

from sketchformer_tpu_torch.ops import token_ce as tce  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,d,V", [(300, 64, 1000), (517, 256, 2003),
                                   (70, 32, 131), (9, 16, 7)])
def test_token_ce_fwd_bwd(cuda, dtype, M, d, V):
    """ll, lse, dx, dW, db against the plain version within TOL; corr equal
    wherever the plain version's top two f32 logits are 1e-3 apart."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = _rand(gen, cuda, M, d, dtype=dtype)
    w = _rand(gen, cuda, d, V, scale=d ** -0.5)
    b = _rand(gen, cuda, V, scale=0.1)
    tgt = torch.randint(0, V, (M,), generator=gen, device=cuda).int()
    gll = _rand(gen, cuda, M)
    tce.reset_launches()
    got = tce.token_ce_fwd(x, w, b, tgt)
    want = tce.token_ce_fwd_reference(x, w, b, tgt)
    _close(got[0], want[0], dtype)
    _close(got[2], want[2], dtype)
    top2 = tce.logits_reference(x, w, b).topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-3
    assert torch.equal(got[1][clear], want[1][clear])
    gb = tce.token_ce_bwd(x, w, b, tgt, want[2], gll)
    wb = tce.token_ce_bwd_reference(x, w, b, tgt, want[2], gll)
    for g, r in zip(gb, wb):
        _close(g, r, dtype)
    assert tce.LAUNCHES == {"token_ce_fwd": 1, "token_ce_dx": 1,
                            "token_ce_dw": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 300])
@pytest.mark.parametrize("d", [64, 128, 192, 256])
@pytest.mark.parametrize("V", [65, 10004])
def test_token_ce_fwd_bf16_modes(cuda, M, d, V):
    """The bf16 wgmma forward against the plain version: ll and lse within
    TOL, a second run bit-equal; three columns planted to give equal logits
    in every row (one across lanes, one across vocab tiles), so the rows
    they top tie exactly: there corr is 1 only for the first of them, and
    elsewhere corr is equal wherever the top two logits are 1e-3 apart."""
    gen = torch.Generator(device=cuda).manual_seed(M + d + V)
    dt = torch.bfloat16
    x = _rand(gen, cuda, M, d, dtype=dt)
    w = _rand(gen, cuda, d, V, scale=d ** -0.5)
    b = _rand(gen, cuda, V, scale=0.1)
    tie = [3, 60, 64]
    w[:, tie] = w[:, tie[:1]]
    b[tie] = 3.0
    rows = torch.arange(M, device=cuda)
    tgt = torch.where(rows % 2 == 0, torch.tensor(tie, device=cuda)[rows % 3],
                      torch.randint(0, V, (M,), generator=gen, device=cuda))
    tce.reset_launches()
    got = tce.token_ce_fwd(x, w, b, tgt)
    assert tce.LAUNCHES["token_ce_fwd"] == 1
    for g, a in zip(got, tce.token_ce_fwd(x, w, b, tgt)):
        assert torch.equal(g, a)
    want = tce.token_ce_fwd_reference(x, w, b, tgt)
    _close(got[0], want[0], dt)
    _close(got[2], want[2], dt)
    top2 = tce.logits_reference(x, w, b).topk(2, dim=-1).values
    planted = top2[:, 0] == top2[:, 1]
    clear = ((top2[:, 0] - top2[:, 1]) > 1e-3) | planted
    assert torch.equal(got[1][clear], want[1][clear])
    first = planted & (tgt == tie[0])
    assert (got[1][first] == 1).all()
    assert (got[1][planted & (tgt != tie[0])] == 0).all()


@pytest.mark.cuda
def test_token_ce_rows_autograd(cuda):
    """The autograd Function: dx, dW (f32, the parameter's dtype), db."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    x = _rand(gen, cuda, 96, 64, dtype=torch.bfloat16).requires_grad_(True)
    w = _rand(gen, cuda, 64, 300, scale=0.125).requires_grad_(True)
    b = _rand(gen, cuda, 300, scale=0.1).requires_grad_(True)
    tgt = torch.randint(0, 300, (96,), generator=gen, device=cuda)
    ll, corr = tce.token_ce_rows(x, w, b, tgt)
    assert not corr.requires_grad
    gx, gw, gb = torch.autograd.grad(ll.sum(), (x, w, b))
    assert gx.dtype == torch.bfloat16 and gw.dtype == torch.float32
    lse = tce.token_ce_fwd_reference(x, w, b, tgt)[2]
    want = tce.token_ce_bwd_reference(x.detach(), w, b, tgt, lse,
                                      torch.ones(96, device=cuda))
    for g, r in zip((gx, gw, gb), want):
        _close(g, r, torch.bfloat16)


@pytest.mark.cuda
def test_token_ce_raises_above_its_width(cuda):
    x = torch.zeros(8, 320, device=cuda)
    with pytest.raises(ValueError, match="above the kernels"):
        tce.token_ce_fwd(x, torch.zeros(320, 10, device=cuda),
                         torch.zeros(10, device=cuda),
                         torch.zeros(8, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("L,nsites,B,T,d", [(3, 3, 5, 7, 9), (2, 2, 16, 96, 256),
                                            (1, 1, 3, 1, 6)])
def test_emit_dropout_bits_equals_the_plain_philox(cuda, L, nsites, B, T, d):
    seed = 0x1234_5678_9ABC_DEF0
    got = dp.emit_dropout_bits(seed, L, nsites, B, T, d, cuda)
    assert torch.equal(got, dp.emit_dropout_bits_reference(seed, L, nsites, B,
                                                           T, d, cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_prng_kernels_equal_bits_kernels(cuda, dtype):
    """Each kernel drawing its site in-kernel gives exactly what it gives
    when fed the emitted bytes of the same site."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    B, T, d, dff = 3, 40, 64, 96
    M = B * T
    site = dp.PrngSite(987654321, 2, 1, T)
    byt = dp.emit_dropout_bits(site.seed, 3, 3, B, T, d, cuda)[
        site.layer * 3 + site.site].reshape(M, d)
    a = _rand(gen, cuda, M, dff, dtype=dtype)
    w = _rand(gen, cuda, dff, d, scale=dff ** -0.5, dtype=dtype)
    bias, res = _rand(gen, cuda, d, scale=0.1), _rand(gen, cuda, M, d,
                                                       dtype=dtype)
    g = _rand(gen, cuda, M, d)
    kw = dict(thresh=26, keep_scale=1.11)
    dp.reset_launches()
    for drop_a, drop_b in ((site, byt),):
        assert torch.equal(
            es.linear(a, w, bias, residual=res, drop=drop_a, **kw),
            es.linear(a, w, bias, residual=res, drop=drop_b, **kw))
        assert torch.equal(
            es.linear_nt(g, w, drop=drop_a, gate=a, **kw),
            es.linear_nt(g, w, drop=drop_b, gate=a, **kw))
        for got, want in zip(
                es.linear_tn(a, g, drop=drop_a, bias_grad=True, **kw),
                es.linear_tn(a, g, drop=drop_b, bias_grad=True, **kw)):
            assert torch.equal(got, want)
    assert dp.LAUNCHES["prng_draw"] == 3
    # and the plain versions draw the same bytes with the plain Philox
    _close(es.linear_reference(a, w, bias, residual=res, drop=site, **kw),
           es.linear(a, w, bias, residual=res, drop=site, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("decoder", [False, True], ids=["encoder",
                                                         "decoder"])
def test_prng_stack_equals_bits_stack(cuda, dtype, decoder):
    """A 'prng' train stack equals the 'bits' stack fed emit_dropout_bits of
    its seed: output and every gradient, bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    mod, _, x, km = _train_stack_case(gen, cuda, decoder, 4, True)
    B, T, d = x.shape
    L, seed = 2, 424242
    gy = _rand(gen, cuda, B, T, d)
    mem = _rand(gen, cuda, B, 4, d)
    mod = mod.to(dtype=torch.float32)
    for m in mod.modules():
        if hasattr(m, "dtype"):
            m.dtype = dtype
    nsites = 3 if decoder else 2
    byt = dp.emit_dropout_bits(seed, L, nsites, B, T, d, cuda)

    def run(**drop):
        w = mod.stacked_weights(grad=True)
        xi = x.detach().to(dtype).requires_grad_(True)
        inputs = [xi]
        if decoder:
            mi = mem.to(dtype).requires_grad_(True)
            inputs.append(mi)
            y = dst.fused_decoder_stack_train(
                xi, mi, km, None, w, num_heads=4, qk_norm=True,
                dropout_rate=0.1, **drop)
        else:
            y = est.fused_encoder_stack_train(
                xi, km, w, num_heads=4, qk_norm=True, dropout_rate=0.1,
                **drop)
        return [y] + list(torch.autograd.grad(
            (y.float() * gy).sum(), inputs + list(mod.parameters()),
            allow_unused=True))

    est.DRAWS["draw_dropout_bytes"] = 0
    got = run(dropout_impl="prng", seed=seed)
    want = run(dropout_bytes=byt)
    assert est.DRAWS["draw_dropout_bytes"] == 0
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        assert (g is None) == (r is None)
        if g is not None:
            assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# K8: per-op attention (ops/flash_attention.py), and K13: the whole decode
# step (ops/decode_step.py)
# ---------------------------------------------------------------------------

from sketchformer_tpu_torch.ops import decode_step as dstep  # noqa: E402
from sketchformer_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _flash_case(gen, dev, dtype, mode, B, Tq, Tk, H, Dh):
    """(q, k, v) (B, T, H, Dh) with q a strided view, a structured bias
    with fully masked rows, and causal."""
    q = _rand(gen, dev, B, Tq, 2 * H, Dh, dtype=dtype)[:, :, :H]
    k, v = (_rand(gen, dev, B, Tk, H, Dh, dtype=dtype) for _ in range(2))
    km = torch.arange(Tk, device=dev)[None] < torch.tensor(
        [Tk - 3 * i for i in range(B)], device=dev)[:, None]
    km[-1] = False                      # a batch element with no key
    mask = None
    if mode.startswith("full"):
        mask = torch.rand((B if mode == "full" else 1, 1, Tq, Tk),
                          generator=gen, device=dev) < 0.7
        mask[0, 0, min(1, Tq - 1)] = False  # a query row with no key
        km = None
    elif mode == "none":
        km = None
    return q, k, v, fa.structure_mask(mask, km, B, Tq, Tk), \
        mode == "key_causal"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["none", "key", "key_causal", "full",
                                  "full_shared"])
@pytest.mark.parametrize("B,T,H,Dh", [(3, 40, 4, 32), (2, 70, 2, 128),
                                      (2, 33, 3, 64)])
def test_flash_attention_fwd_bwd(cuda, dtype, mode, B, T, H, Dh):
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v, bias, causal = _flash_case(gen, cuda, dtype, mode, B, T, T, H,
                                        Dh)
    before = dict(fa.LAUNCHES)
    _close(fa.flash_attention_fwd(q, k, v, bias, causal),
           fa.flash_attention_reference(q, k, v, bias, causal), dtype)
    g = _rand(gen, cuda, B, T, H, Dh, dtype=dtype)
    got = fa.flash_attention_bwd(q, k, v, bias, g, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, bias, g, causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        _close(a, b, dtype)
    assert fa.LAUNCHES == {"flash_attention_fwd":
                           before["flash_attention_fwd"] + 1,
                           "flash_attention_bwd":
                           before["flash_attention_bwd"] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Tq,Tk,H,Dh,mode", [
    (2, 1, 1, 2, 32, "key_causal"),
    (2, 1, 1, 2, 128, "key"),
    (4, 192, 192, 8, 32, "key"),
    (4, 192, 192, 8, 32, "full_shared"),
    (3, 96, 96, 2, 128, "key_causal"),
    (2, 50, 70, 2, 64, "full"),
    (2, 70, 33, 3, 64, "key"),
    (2, 40, 90, 2, 32, "none"),
    (1, 1024, 1024, 2, 128, "key_causal"),
    (1, 1024, 1024, 8, 32, "full"),
])
def test_flash_attention_bwd_shapes(cuda, dtype, B, Tq, Tk, H, Dh, mode):
    """The backward at T = 1, 192 and 1024, Tq != Tk, Dh 32 / 64 / 128,
    with fully masked rows, against the plain version; and bit-stable from
    run to run (every gradient row has one owner)."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    q, k, v, bias, causal = _flash_case(gen, cuda, dtype, mode, B, Tq, Tk,
                                        H, Dh)
    g = _rand(gen, cuda, B, Tq, H, Dh, dtype=dtype)
    got = fa.flash_attention_bwd(q, k, v, bias, g, causal)
    again = fa.flash_attention_bwd(q, k, v, bias, g, causal)
    want = fa.flash_attention_bwd_reference(q, k, v, bias, g, causal)
    # with one key, dq and dk are zero: they are held at dv's scale
    top = max(w.float().abs().max().item() for w in want)
    for a, b, c in zip(got, want, again):
        assert a.dtype == dtype and a.shape == b.shape
        _close(a, b, dtype, scale=b.float().abs().max().item() or top)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_autograd_and_t1024(cuda, dtype):
    """The autograd Function through head-major views at T = 1024, the
    kernels' longest rows (f32 score rows of 128 KB in shared memory)."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    B, T, H, Dh = 1, fa.MAX_FUSED_LEN, 2, 128
    q, k, v = (_rand(gen, cuda, B, H, T, Dh, dtype=dtype).requires_grad_(True)
               for _ in range(3))
    km = torch.arange(T, device=cuda)[None] < 1000
    g = _rand(gen, cuda, B, H, T, Dh, dtype=dtype)
    out = fa.flash_attention(q, k, v, head_major=True, key_mask=km,
                             causal=True)
    grads = torch.autograd.grad(out, (q, k, v), g)
    bias = fa.structure_mask(None, km, B, T, T)
    qs, ks, vs, gs = (x.detach().transpose(1, 2) for x in (q, k, v, g))
    _close(out.transpose(1, 2),
           fa.flash_attention_reference(qs, ks, vs, bias, True), dtype)
    for a, b in zip(grads, fa.flash_attention_bwd_reference(
            qs, ks, vs, bias, gs, True)):
        _close(a.transpose(1, 2), b, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,qk,t,rows", [(4, False, 0, 1), (4, True, 9, 1),
                                         (1, True, 31, 1), (2, False, 17, 2)])
def test_decode_step(cuda, dtype, H, qk, t, rows):
    """h and the new k/v rows against the plain version; the caches are
    not written."""
    gen = torch.Generator(device=cuda).manual_seed(14)
    B = 7 if rows == 1 else torch.cuda.get_device_properties(
        cuda).multi_processor_count + 3
    L, d, dff, Tmax = 2, 128, 256, 32
    ops = _chunk_operands(gen, cuda, B=B, L=L, d=d, H=H, dff=dff, N=8,
                          Tmax=Tmax, Mq=3, K=1, t0=t, dtype=dtype, cont=False)
    ops["k_cache"][:, :, t:] = 7.0      # rows the step must not read
    kc = ops["k_cache"].clone()
    x = _rand(gen, cuda, B, d, dtype=dtype)
    args = (x, ops["k_cache"], ops["v_cache"], ops["cross_k"],
            ops["cross_v"], ops["w"], t)
    before = dstep.LAUNCHES["decode_step"]
    got = dstep.fused_decode_step(*args, num_heads=H, qk_norm=qk)
    want = dstep.fused_decode_step_reference(*args, num_heads=H, qk_norm=qk)
    assert dstep.LAUNCHES["decode_step"] == before + 1
    for a, b in zip(got, want):
        _close(a, b, dtype)
    assert torch.equal(ops["k_cache"], kc)


@pytest.mark.cuda
def test_step_loop_picks_equal_the_plain_loop(cuda):
    """f32: 12 greedy steps, one kernel launch each, against the plain
    step loop from the same caches, up to each row's first near tie."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    B, L, d, H, N, K = 7, 2, 128, 4, 517, 12
    ops = _chunk_operands(gen, cuda, B=B, L=L, d=d, H=H, dff=256, N=N,
                          Tmax=32, Mq=3, K=K, t0=4, dtype=torch.float32,
                          cont=False)
    kv = (ops["k_cache"].clone(), ops["v_cache"].clone())
    args = lambda kc, vc: (ops["prev"], ops["finished"], kc, vc,
                           ops["cross_k"], ops["cross_v"], ops["emb"],
                           ops["pos_chunk"], ops["head_w"], ops["head_b"],
                           ops["w"], 4)
    before = dstep.LAUNCHES["decode_step"]
    got, _ = dstep.greedy_steps(*args(ops["k_cache"], ops["v_cache"]),
                                num_heads=H)
    assert dstep.LAUNCHES["decode_step"] == before + K
    *_, margins = dc.decode_chunk_reference(*args(*(t.clone() for t in kv)),
                                            num_heads=H, return_margins=True)
    want, _ = dstep.greedy_steps(*args(*kv), num_heads=H,
                                 step=dstep.fused_decode_step_reference)
    n = _agreeing_steps(margins)
    before = torch.arange(K, device=cuda)[None] < n[:, None]
    assert int(before.sum()) >= B * K // 2
    assert torch.equal(got[before], want[before])


def test_flash_attention_and_decode_step_other_devices_raise():
    a = torch.zeros(1, 4, 1, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_fwd(a, a, a)
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bwd(a, a, a, None, a)
    with pytest.raises(ValueError, match="unsupported device"):
        dstep.fused_decode_step(torch.zeros(2, 8, device="meta"), *(None,) * 5,
                                0, num_heads=1)


# ---------------------------------------------------------------------------
# the tensor-core redesigns of K6's dx and of the attention forward (bf16)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("M", [9, 127, 129, 49152])
@pytest.mark.parametrize("dp", [64, 128, 192, 256])
@pytest.mark.parametrize("V", [7, 2003, 10004])
def test_token_ce_dx_wgmma(cuda, M, dp, V):
    """bf16 ``ce_dx`` (wgmma, a TMA ring, 128-row blocks): dx within TOL of
    the plain version at ragged M, every width the kernel is built for and
    vocabularies below, across and far beyond one 64-column tile; equal
    across two runs (one fixed summation order, no atomics)."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    x = _rand(gen, cuda, M, dp, dtype=torch.bfloat16)
    w = _rand(gen, cuda, dp, V, scale=dp ** -0.5)
    b = _rand(gen, cuda, V, scale=0.1)
    tgt = torch.randint(0, V, (M,), generator=gen, device=cuda).int()
    gll = _rand(gen, cuda, M)
    lse = tce.token_ce_fwd_reference(x, w, b, tgt)[2]
    before = tce.LAUNCHES["token_ce_dx"]
    dx = tce.token_ce_bwd(x, w, b, tgt, lse, gll)[0]
    again = tce.token_ce_bwd(x, w, b, tgt, lse, gll)[0]
    assert tce.LAUNCHES["token_ce_dx"] == before + 2
    want = tce.token_ce_bwd_reference(x, w, b, tgt, lse, gll)[0]
    assert dx.dtype == torch.bfloat16 and dx.shape == (M, dp)
    _close(dx, want, torch.bfloat16)
    assert torch.equal(dx, again)


def _stack_attn_case(gen, dev, B, Tq, Tk, H, Dh, masked):
    """q a strided view of a fused pane, k / v of a kv pane, and a key bias
    whose last batch element has no key (a fully masked row set)."""
    q = _rand(gen, dev, B, Tq, 3 * H * Dh, dtype=torch.bfloat16)[..., :H * Dh]
    kv = _rand(gen, dev, B, Tk, 2 * H * Dh, dtype=torch.bfloat16)
    bias = None
    if masked:
        lengths = torch.tensor([Tk, (Tk + 1) // 2, 0][:B], device=dev)
        bias = torch.where(torch.arange(Tk, device=dev)[None] <
                           lengths[:, None], 0.0, at.NEG_INF).float()
    norms = tuple(1 + _rand(gen, dev, Dh, scale=0.1) if i % 2 == 0
                  else _rand(gen, dev, Dh, scale=0.1) for i in range(4))
    return q, kv[..., :H * Dh], kv[..., H * Dh:], bias, norms


@pytest.mark.cuda
@pytest.mark.parametrize("Tq", [1, 40, 65, 192])
@pytest.mark.parametrize("Tk", [4, 33, 192])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_attention_fwd_mma_modes(cuda, Tq, Tk, Dh):
    """The stacks' bf16 forward (mma.sync): with and without the key bias
    (fully masked rows included), qk-norm and norm_p, causal where Tq ==
    Tk, within TOL of the plain version and equal across two runs."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    B, H = 3, 2
    for masked in (False, True):
        q, k, v, bias, norms = _stack_attn_case(gen, cuda, B, Tq, Tk, H, Dh,
                                                masked)
        for causal in ((False, True) if Tq == Tk else (False,)):
            for qk in (None, norms):
                for norm_p in (True, False):
                    kw = dict(num_heads=H, causal=causal, qk_norm=qk,
                              norm_p=norm_p)
                    before = at.LAUNCHES["attention_fwd"]
                    got = at.attention_fwd(q, k, v, bias, **kw)
                    again = at.attention_fwd(q, k, v, bias, **kw)
                    assert at.LAUNCHES["attention_fwd"] == before + 2
                    _close(got, at.attention_fwd_reference(q, k, v, bias,
                                                           **kw),
                           torch.bfloat16)
                    assert torch.equal(got, again)


FLASH_FWD_CASES = [(mode, Tq, Tk)
                   for Tq, Tk in ((1, 4), (40, 33), (65, 192), (192, 192),
                                  (192, 4), (1024, 1024))
                   for mode in ("none", "key", "key_causal", "full",
                                "full_shared")
                   if mode != "key_causal" or Tq == Tk]


@pytest.mark.cuda
@pytest.mark.parametrize("mode,Tq,Tk", FLASH_FWD_CASES)
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_flash_attention_fwd_mma_modes(cuda, mode, Tq, Tk, Dh):
    """K8's bf16 forward on the mma.sync kernel: a key row, a per-batch or
    shared pane (fully masked rows in each), causal as a where() where Tq ==
    Tk, up to T = 1024; within TOL of the plain version, equal across two
    runs."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    B = 1 if Tq == 1024 else 3
    H = 2
    q, k, v, bias, causal = _flash_case(gen, cuda, torch.bfloat16, mode, B,
                                        Tq, Tk, H, Dh)
    before = fa.LAUNCHES["flash_attention_fwd"]
    got = fa.flash_attention_fwd(q, k, v, bias, causal)
    again = fa.flash_attention_fwd(q, k, v, bias, causal)
    assert fa.LAUNCHES["flash_attention_fwd"] == before + 2
    _close(got, fa.flash_attention_reference(q, k, v, bias, causal),
           torch.bfloat16)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_bf16_forward_raises_off_its_shapes(cuda):
    """A bf16 head_dim that is not a multiple of 16 raises on both entry
    points, with no launch; f32 still takes it (the FMA kernel)."""
    gen = torch.Generator(device=cuda).manual_seed(24)
    before = (at.LAUNCHES["attention_fwd"], fa.LAUNCHES["flash_attention_fwd"])
    q, k, v, _, _ = _stack_attn_case(gen, cuda, 2, 8, 8, 2, 40, False)
    with pytest.raises(ValueError, match="multiple of 16"):
        at.attention_fwd(q, k, v, None, num_heads=2)
    q4 = _rand(gen, cuda, 2, 8, 2, 40, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention_fwd(q4, q4, q4)
    assert (at.LAUNCHES["attention_fwd"],
            fa.LAUNCHES["flash_attention_fwd"]) == before
    q, k, v = (t.float() for t in (q, k, v))
    _close(at.attention_fwd(q, k, v, None, num_heads=2),
           at.attention_fwd_reference(q, k, v, None, num_heads=2),
           torch.float32)


# ---------------------------------------------------------------------------
# the tensor-core redesigns of K6's dW and of the stacks' linear_nt (bf16)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 127, 129, 49152])
@pytest.mark.parametrize("dp", [64, 128, 192, 256])
@pytest.mark.parametrize("V", [2003, 10004])
def test_token_ce_dw_wgmma(cuda, M, dp, V):
    """bf16 ``ce_dw`` (wgmma on a TMA ring of 128-row x slabs, the split
    partials added by the last block of each vocab tile): dW and db within
    TOL of the plain version at ragged M, every width and vocabularies that
    are not a multiple of 64; equal across two runs; one launch a call and
    no ``sum_rows``."""
    gen = torch.Generator(device=cuda).manual_seed(25)
    x = _rand(gen, cuda, M, dp, dtype=torch.bfloat16)
    w = _rand(gen, cuda, dp, V, scale=dp ** -0.5)
    b = _rand(gen, cuda, V, scale=0.1)
    tgt = torch.randint(0, V, (M,), generator=gen, device=cuda).int()
    gll = _rand(gen, cuda, M)
    lse = tce.token_ce_fwd_reference(x, w, b, tgt)[2]
    before = (tce.LAUNCHES["token_ce_dw"], nt.LAUNCHES["sum_rows"])
    got = tce.token_ce_bwd(x, w, b, tgt, lse, gll)
    again = tce.token_ce_bwd(x, w, b, tgt, lse, gll)
    assert (tce.LAUNCHES["token_ce_dw"], nt.LAUNCHES["sum_rows"]) == \
        (before[0] + 2, before[1])
    want = tce.token_ce_bwd_reference(x, w, b, tgt, lse, gll)
    for g, r, a in zip(got[1:], want[1:], again[1:]):
        assert g.dtype == torch.float32 and g.shape == r.shape
        _close(g, r, torch.bfloat16)
        assert torch.equal(g, a)


NT_SHAPES = [(333, 96, 80), (50, 36, 20), (100, 64, 33), (1000, 256, 512),
             (12288, 512, 256), (4100, 256, 256), (777, 768, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", NT_SHAPES)
@pytest.mark.parametrize("mode", [None, "bits", "prng"])
@pytest.mark.parametrize("a_f32", [True, False], ids=["a_f32", "a_bf16"])
@pytest.mark.parametrize("epi", ["f32", "gate", "residual"])
def test_linear_nt_wgmma_modes(cuda, M, N, K, mode, a_f32, epi):
    """bf16 ``linear_nt`` (wgmma, TMA, a converter warpgroup; bf16 a with no
    mask lands by TMA as it is): every mask mode, a f32 or bf16, the f32
    output, the ReLU gate and the bf16 residual, at ragged M, N and K and at
    each (N, K) of the stacks (an odd K takes the element-wise epilogue);
    within TOL of the plain version and equal across two runs."""
    gen = torch.Generator(device=cuda).manual_seed(26)
    dt = torch.bfloat16
    a = _rand(gen, cuda, M, N, dtype=torch.float32 if a_f32 else dt)
    w = _rand(gen, cuda, K, N, scale=N ** -0.5, dtype=dt)
    kw = dict(thresh=26, keep_scale=1.11)
    if mode == "bits":
        kw["drop"] = _bytes(gen, cuda, M, N)
    elif mode == "prng":
        kw["drop"] = dp.PrngSite(24681357, 1, 2, M)
    if epi == "gate":
        kw["gate"] = torch.relu(_rand(gen, cuda, M, K, dtype=dt))
    elif epi == "residual":
        kw.update(out_dtype=dt, residual=_rand(gen, cuda, M, K, dtype=dt))
    before = es.LAUNCHES["linear_nt"]
    got = es.linear_nt(a, w, **kw)
    again = es.linear_nt(a, w, **kw)
    assert es.LAUNCHES["linear_nt"] == before + 2
    want = es.linear_nt_reference(a, w, **kw)
    assert got.dtype == want.dtype and got.shape == (M, K)
    _close(got, want, dt)
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# the tensor-core redesigns of the stacks' attention backward (K5) and of the
# serving encoder_attention (bf16)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B,Tq,Tk", [(2, 1, 1), (3, 96, 96), (3, 192, 192),
                                     (3, 40, 4), (3, 65, 33),
                                     (1, 1024, 1024)])
@pytest.mark.parametrize("Dh", [32, 64, 128])
def test_attention_bwd_mma_modes(cuda, B, Tq, Tk, Dh):
    """The stacks' bf16 backward (mma.sync, both passes): self-attention
    with and without causal, cross-attention (Tq != Tk), with and without
    the key bias (a fully masked batch element) and qk-norm, dO in f32 and
    bf16, at ragged T up to 1024; dq, dk, dv, the row statistics and the
    qk-norm gradients within TOL of the plain version and equal across two
    runs; two launches a pass a call, and no sum_rows."""
    gen = torch.Generator(device=cuda).manual_seed(27)
    H, bf = 2, torch.bfloat16
    for masked in (False, True):
        q, k, v, bias, norms = _stack_attn_case(gen, cuda, B, Tq, Tk, H, Dh,
                                                masked)
        do32 = _rand(gen, cuda, B, Tq, H * Dh)
        for causal in ((False, True) if Tq == Tk else (False,)):
            for qk in (None, norms):
                for do in (do32, do32.to(bf)):
                    kw = dict(num_heads=H, causal=causal, qk_norm=qk)
                    before = (at.LAUNCHES["attention_bwd_q"],
                              at.LAUNCHES["attention_bwd_kv"],
                              nt.LAUNCHES["sum_rows"])
                    got = at.attention_bwd_q(q, k, v, do, bias, **kw)
                    again = at.attention_bwd_q(q, k, v, do, bias, **kw)
                    want = at.attention_bwd_q_reference(q, k, v, do, bias,
                                                        **kw)
                    got_kv = at.attention_bwd_kv(q, k, v, do, bias, want[1],
                                                 **kw)
                    again_kv = at.attention_bwd_kv(q, k, v, do, bias,
                                                   want[1], **kw)
                    want_kv = at.attention_bwd_kv_reference(
                        q, k, v, do, bias, want[1], **kw)
                    assert (at.LAUNCHES["attention_bwd_q"],
                            at.LAUNCHES["attention_bwd_kv"],
                            nt.LAUNCHES["sum_rows"]) == \
                        (before[0] + 2, before[1] + 2, before[2])
                    # at T = 1 every p is 1 and dq, dk and the norm
                    # gradients are exactly 0: held at a scale of 1
                    size = lambda w: w.abs().max().item() or 1.0
                    for g, w in zip(got[:3] + got_kv[:3],
                                    want[:3] + want_kv[:3]):
                        if w is not None:
                            assert g.dtype == torch.float32
                            _close(g, w, bf, scale=size(w))
                    if qk is not None:
                        _close(got[3], want[3], bf, scale=size(want[3]))
                        # the k-norm bias gradient is zero up to rounding
                        _close(got_kv[3], want_kv[3], bf,
                               scale=size(want_kv[2]))
                    for g, a in zip(got + got_kv, again + again_kv):
                        assert (g is None) == (a is None)
                        if g is not None:
                            assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("Dh,route", [(32, "mma"), (48, "mma"), (64, "mma"),
                                      (128, "mma"), (8, "fma"), (24, "fma"),
                                      (40, "fma"), (100, "fma")])
def test_encoder_attention_bf16_route(cuda, Dh, route):
    """bf16 encoder_attention: a head_dim that is a multiple of 16 runs the
    stacks' tensor-core forward on the pane's q, k and v slices, any other
    width its own FMA kernel (a dispatch on shape); both within TOL of the
    plain version, with and without qk-norm, an all-PAD row 0 finite, and
    equal across two runs."""
    gen = torch.Generator(device=cuda).manual_seed(28)
    B, T, H, bf = 3, 50, 2, torch.bfloat16
    qkv = _rand(gen, cuda, B, T, 3 * H * Dh, dtype=bf)
    lengths = torch.tensor([0, T, T - 7], device=cuda)
    bias = torch.where(torch.arange(T, device=cuda)[None, :] <
                       lengths[:, None], 0.0, es.NEG_INF).float()
    norms = tuple(1 + _rand(gen, cuda, Dh, scale=0.1) if i % 2 == 0
                  else _rand(gen, cuda, Dh, scale=0.1) for i in range(4))
    for qk in (None, norms):
        before = dict(es.ROUTES)
        got = es.encoder_attention(qkv, bias, num_heads=H, qk_norm=qk)
        again = es.encoder_attention(qkv, bias, num_heads=H, qk_norm=qk)
        assert es.ROUTES == {**before, route: before[route] + 2}
        _close(got, es.attention_reference(qkv, bias, num_heads=H,
                                           qk_norm=qk), bf)
        assert torch.isfinite(got[0]).all()
        assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# K13's bf16 step kind of the cluster kernel; K7's emit on its persistent
# grid of 16-byte runs
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 40])
@pytest.mark.parametrize("H", [8, 2])
@pytest.mark.parametrize("qk", [False, True], ids=["plain", "qknorm"])
@pytest.mark.parametrize("t", [0, 17, 191])
def test_decode_step_cluster_kind(cuda, t, qk, H, B):
    """bf16 at the ar_decode width (d=256, dff=512, Tmax=192; 2 layers) on
    the cluster route: h and the new k/v rows held to the float32
    computation of the same inputs within 2x the plain bf16 path's error;
    the caches unread past t and unwritten. B=40 ends in a part-empty row
    group."""
    gen = torch.Generator(device=cuda).manual_seed(1400 + t + 7 * H + B)
    L, d, dff, Tmax = 2, 256, 512, 192
    ops = _chunk_operands(gen, cuda, B=B, L=L, d=d, H=H, dff=dff, N=16,
                          Tmax=Tmax, Mq=4, K=1, t0=t, dtype=torch.bfloat16,
                          cont=False)
    ops["k_cache"][:, :, t:] = float("nan")     # rows the step must not read
    ops["v_cache"][:, :, t:] = float("nan")
    kc, vc = ops["k_cache"].clone(), ops["v_cache"].clone()
    x = _rand(gen, cuda, B, d, dtype=torch.bfloat16)
    args = (x, ops["k_cache"], ops["v_cache"], ops["cross_k"],
            ops["cross_v"], ops["w"], t)
    routes = dict(dstep.ROUTES)
    got = dstep.fused_decode_step(*args, num_heads=H, qk_norm=qk)
    assert dstep.ROUTES == {**routes, "cluster": routes["cluster"] + 1}
    want = dstep.fused_decode_step_reference(*args, num_heads=H, qk_norm=qk)
    ref = dstep.fused_decode_step_reference(
        *(a.float() for a in args[:5]),
        {k: v.float() for k, v in ops["w"].items()}, t, num_heads=H,
        qk_norm=qk)
    torch.cuda.synchronize()
    for a, b, r in zip(got, want, ref):
        assert torch.isfinite(a).all()
        err_k = (a.float() - r).abs().max().item()
        err_p = (b.float() - r).abs().max().item()
        assert err_k <= 2.0 * err_p, (err_k, err_p)
    assert torch.equal(ops["k_cache"].nan_to_num(), kc.nan_to_num())
    assert torch.equal(ops["v_cache"].nan_to_num(), vc.nan_to_num())


@pytest.mark.cuda
def test_decode_step_f32_keeps_the_rows_kernel(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1401)
    ops = _chunk_operands(gen, cuda, B=40, L=2, d=256, H=8, dff=512, N=16,
                          Tmax=32, Mq=4, K=1, t0=9, dtype=torch.float32,
                          cont=False)
    args = (_rand(gen, cuda, 40, 256), ops["k_cache"], ops["v_cache"],
            ops["cross_k"], ops["cross_v"], ops["w"], 9)
    routes = dict(dstep.ROUTES)
    got = dstep.fused_decode_step(*args, num_heads=8)
    assert dstep.ROUTES == {**routes, "rows": routes["rows"] + 1}
    for a, b in zip(got, dstep.fused_decode_step_reference(*args,
                                                           num_heads=8)):
        _close(a, b, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,route", [
    ((1, 1, 256, 192, 256), "vec16"),          # pretrain_full's site
    ((1, 1, 64, 192, 512), "vec16"),           # a post-LN FFN site
    ((8, 2, 16, 96, 256), "vec16"),            # a whole stack's tensor
    ((1, 1, 3, 7, 10), "bytes"),               # TD = 70
    ((3, 4, 5, 1, 10), "bytes"),               # TD = 10
])
def test_emit_dropout_bits_routes(cuda, shape, route):
    """The emit kernel bit-equal to the plain Philox on the route each
    shape takes."""
    L, nsites, B, T, d = shape
    seed = 0x0F1E_2D3C_4B5A_6978
    routes = dict(dp.ROUTES)
    got = dp.emit_dropout_bits(seed, L, nsites, B, T, d, cuda)
    assert dp.ROUTES == {**routes, route: routes[route] + 1}
    torch.cuda.synchronize()
    assert torch.equal(got, dp.emit_dropout_bits_reference(seed, L, nsites, B,
                                                           T, d, cuda))


# ---------------------------------------------------------------------------
# the optimizer step: the global norm, the guard and the update
# ---------------------------------------------------------------------------

import ctypes  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

from sketchformer_tpu_torch.ops import optimizer as opt_ops  # noqa: E402
from sketchformer_tpu_torch.train import schedule  # noqa: E402

CONFIGS = Path(__file__).resolve().parent.parent / "perfbench" / "configs"
OPT_HYPER = dict(warmup_steps=10, peak_scale=2.0)
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7


def _config_shapes(name):
    """The parameter shapes of a benchmark configuration's model, in the
    order of ``model.parameters()``."""
    from sketchformer_tpu_torch.config import SketchformerConfig
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    cfg = json.loads((CONFIGS / f"{name}.json").read_text())
    fields = {f.name for f in dataclasses.fields(SketchformerConfig)}
    model = Sketchformer(SketchformerConfig(
        **{k: v for k, v in cfg.items() if k in fields}))
    return [tuple(p.shape) for p in model.parameters()]


class _PlainTwin:
    """The plain route's state beside a kernel optimizer: its own copies of
    the parameters, moments and count on the card."""

    def __init__(self, opt):
        self.opt = opt
        self.params = [p.clone() for p in opt.params]
        self.mu = [m.clone() for m in opt.mu]
        self.nu = [v.clone() for v in opt.nu]
        self.count = torch.tensor(opt.count, device=opt.params[0].device)

    def step(self, grads):
        norm = opt_ops.global_norm_reference(grads)
        applied = opt_ops.adam_update_reference(
            self.params, grads, self.mu, self.nu, norm, self.count,
            **self.opt.hyper())
        return norm, applied

    def check(self, label):
        torch.cuda.synchronize()
        assert self.opt.count == int(self.count), label
        for name, got, want in (("params", self.opt.params, self.params),
                                ("mu", self.opt.mu, self.mu),
                                ("nu", self.opt.nu, self.nu)):
            for i, (a, b) in enumerate(zip(got, want)):
                torch.testing.assert_close(
                    a, b, rtol=OPT_RTOL, atol=OPT_ATOL,
                    msg=lambda s, i=i, n=name: f"{label} {n}[{i}]: {s}")


def _kernel_walk(starts, n):
    """Each chunk's (tensor, first, last) segments as the kernels walk
    them (``csrc/optimizer.cu``: find_tensor, then the tensors that start
    before the chunk's end), over a group's rebased starts."""
    total = starts[n]
    for c0 in range(0, total, opt_ops.CHUNK):
        c1 = min(c0 + opt_ops.CHUNK, total)
        lo, hi = 0, n - 1
        while lo < hi:
            mid = (lo + hi + 1) >> 1
            lo, hi = (mid, hi) if starts[mid] <= c0 else (lo, mid - 1)
        t = lo
        while t < n and starts[t] < c1:
            yield t, max(c0, starts[t]) - starts[t], \
                min(c1, starts[t + 1]) - starts[t]
            t += 1


@pytest.mark.parametrize("numels", [
    [5000, 1, 0, 3, 4096, 8191, 0],
    [0, 0, 7] + [13] * 600 + [0],
    [1] * (opt_ops.MAX_TENSORS + 1),
], ids=["ragged", "split", "one_element_each"])
def test_optimizer_table_walk_covers_every_element_once(numels):
    """The tables' launch groups (at most MAX_TENSORS tensors, starts
    rebased to the group's first) and the kernels' chunk walk over them
    cover every element of every tensor exactly once."""
    table = opt_ops.TensorTable(torch.device("cpu"), numels,
                                [1000 * (i + 1) for i in range(len(numels))])
    seen = [np.zeros(k, np.int64) for k in numels]
    first = 0
    for n, (ptrs,), starts, total in table.groups():
        assert 1 <= n <= opt_ops.MAX_TENSORS
        st = (ctypes.c_longlong * (n + 1)).from_address(starts)
        base = [st[i] - st[0] for i in range(n + 1)]
        assert base[n] == total == sum(numels[first:first + n])
        assert ctypes.c_void_p.from_address(ptrs).value == 1000 * (first + 1)
        for t, a, b in _kernel_walk(base, n):
            assert 0 <= a <= b <= numels[first + t]
            seen[first + t][a:b] += 1
        first += n
    assert first == len(numels)
    assert all((s == 1).all() for s in seen)


def _kernel_step(opt, grads):
    norm = schedule.global_norm(grads)
    return norm, opt.step(grads, norm)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["tok_h8", "cont_mdn"])
def test_optimizer_kernels_match_the_plain_route(cuda, config):
    """The norm and update kernels against the plain route on a benchmark
    configuration's whole parameter list, over four steps: one under the
    clip, one clipped, one with a NaN gradient (skipped by both), and one
    after a state_dict round trip to count 5,000. Norms and state within
    rtol 1e-6, atol 1e-7; three launches a step."""
    gen = torch.Generator(device=cuda).manual_seed(2100)
    shapes = _config_shapes(config)
    params = [_rand(gen, cuda, *s, scale=0.05) for s in shapes]
    opt = schedule.NoamAdam(params, 256, **OPT_HYPER)
    twin = _PlainTwin(opt)
    scales = (1e-5, 1e-2, 1e-3, 1e-4)   # norms under 1, ~35-45, NaN, under 1
    for k, scale in enumerate(scales):
        grads = [_rand(gen, cuda, *s, scale=scale) for s in shapes]
        if k == 2:
            grads[len(grads) // 2].view(-1)[0] = float("nan")
        if k == 3:   # a round trip, to a count past the warmup's start
            state = opt.state_dict()
            state["count"] = 5000
            opt.load_state_dict(state)
            twin.count.fill_(5000)
        opt_ops.reset_launches()
        norm, applied = _kernel_step(opt, grads)
        assert opt_ops.LAUNCHES == {"global_sumsq": 1, "adam_prepare": 1,
                                    "adam_update": 1}
        want_norm, want_applied = twin.step(grads)
        torch.cuda.synchronize()
        if k == 2:
            assert not torch.isfinite(norm).item()
        else:
            assert (norm.item() >= 1.0) == (k == 1), norm.item()
            torch.testing.assert_close(norm, want_norm, rtol=OPT_RTOL,
                                       atol=OPT_ATOL)
        assert applied.item() == want_applied.item() == float(k != 2)
        twin.check(f"step {k}")
    assert opt.count == 5001


@pytest.mark.cuda
def test_optimizer_kernels_take_unaligned_views(cuda):
    """Gradients as views into one flat buffer at an odd offset (as the
    data-parallel all-reduce leaves them), and parameters at a shared odd
    offset: the element loops instead of the vectors, the same results."""
    gen = torch.Generator(device=cuda).manual_seed(2101)
    shapes = _config_shapes("cont_mdn")[:40] + [(3,), (1,), (4099,)]
    sizes = [int(np.prod(s)) for s in shapes]
    total = sum(sizes)

    def views(flat, at):
        out = []
        for s, n in zip(shapes, sizes):
            out.append(flat[at:at + n].view(s))
            at += n
        return out

    params = views(_rand(gen, cuda, total + 3, scale=0.05), 3)
    opt = schedule.NoamAdam(params, 256, **OPT_HYPER)
    twin = _PlainTwin(opt)
    for k, scale in enumerate((1e-3, 1.0)):
        grads = views(_rand(gen, cuda, total + 1, scale=scale), 1)
        norm, _ = _kernel_step(opt, grads)
        want, _ = twin.step(grads)
        torch.testing.assert_close(norm, want, rtol=OPT_RTOL, atol=OPT_ATOL)
        twin.check(f"step {k}")


@pytest.mark.cuda
def test_optimizer_kernels_split_a_long_list(cuda):
    """More tensors than one launch's table holds: two norm launches (the
    last adding both's partials) and two update launches."""
    gen = torch.Generator(device=cuda).manual_seed(2103)
    shapes = [(7 + i % 13,) for i in range(opt_ops.MAX_TENSORS + 88)]
    opt = schedule.NoamAdam([_rand(gen, cuda, *s) for s in shapes], 256,
                            **OPT_HYPER)
    twin = _PlainTwin(opt)
    for k, scale in enumerate((1e-3, 1.0)):
        grads = [_rand(gen, cuda, *s, scale=scale) for s in shapes]
        opt_ops.reset_launches()
        norm, _ = _kernel_step(opt, grads)
        assert opt_ops.LAUNCHES == {"global_sumsq": 2, "adam_prepare": 1,
                                    "adam_update": 2}
        want, _ = twin.step(grads)
        torch.testing.assert_close(norm, want, rtol=OPT_RTOL, atol=OPT_ATOL)
        twin.check(f"step {k}")


@pytest.mark.cuda
def test_optimizer_rate_on_the_card_is_the_schedule(cuda):
    """The prepare launch's rate equals noam_schedule's within 1 ulp."""
    params = [torch.zeros(5, device=cuda)]
    opt = schedule.NoamAdam(params, 256, **OPT_HYPER)
    sched = schedule.noam_schedule(256, **OPT_HYPER)
    grads = [torch.ones(5, device=cuda)]
    for c in (0, 1, 2, 9, 10, 11, 100, 4000, 10_000):
        opt.count = c
        _kernel_step(opt, grads)
        got = np.float32(opt._scalars[1].item())
        want = np.float32(sched(c))
        assert abs(int(got.view(np.int32)) - int(want.view(np.int32))) <= 1
        assert opt.count == c + 1


def _optimizer_pair(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2102)
    shapes = _config_shapes("tok_h8")
    opt = schedule.NoamAdam([_rand(gen, cuda, *s) for s in shapes], 256,
                            **OPT_HYPER)
    grads = [_rand(gen, cuda, *s, scale=1e-3) for s in shapes]
    _kernel_step(opt, grads)       # builds, loads and sizes the scratch
    torch.cuda.synchronize()
    return opt, grads


@pytest.mark.cuda
def test_optimizer_step_makes_no_host_sync(cuda):
    """global_norm + step under the sync debug mode 'error': no call of
    either waits for the card."""
    opt, grads = _optimizer_pair(cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            _kernel_step(opt, grads)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert opt.count == 3


@pytest.mark.cuda
def test_optimizer_step_launches_three_kernels(cuda):
    """A profiler's count of the device work of global_norm + step: at most
    three kernels (the norm, the prepare, the update), no copy or fill."""
    opt, grads = _optimizer_pair(cuda)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _kernel_step(opt, grads)
        torch.cuda.synchronize()
    # among the device events the profiler also shows its own buffer
    # requests and the program's spans (utils/trace.py), which launch nothing
    names = [e.name for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and not e.name.startswith(("Activity Buffer", "sk."))]
    assert 1 <= len(names) <= 3, names
    assert all("sumsq" in n or "adam" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("big", [1e19, 1e20])
def test_optimizer_guard_skips_where_the_f32_sum_overflows(cuda, big):
    """One gradient element at 1e20 squares past f32's range: the norm
    kernel, which sums in f64, reads inf as optax's f32 sum of squares
    does, and the step is skipped; at 1e19 the norm stays finite and the
    clipped step applies. Both as the plain route."""
    gen = torch.Generator(device=cuda).manual_seed(2104)
    shapes = [(3, 4), (5,), (1,), (4099,)]
    opt = schedule.NoamAdam([_rand(gen, cuda, *s, scale=0.05)
                             for s in shapes], 256, **OPT_HYPER)
    twin = _PlainTwin(opt)
    grads = [_rand(gen, cuda, *s, scale=1e-3) for s in shapes]
    grads[2][0] = big
    norm, applied = _kernel_step(opt, grads)
    want, want_applied = twin.step(grads)
    torch.cuda.synchronize()
    finite = big < 1.8e19
    assert torch.isfinite(norm).item() == torch.isfinite(want).item() \
        == finite
    torch.testing.assert_close(norm, want, rtol=OPT_RTOL, atol=OPT_ATOL)
    assert applied.item() == want_applied.item() == float(finite)
    twin.check(f"a gradient element at {big}")
    assert opt.count == int(finite)


@pytest.mark.cuda
def test_optimizer_kernels_refuse_what_they_cannot_take(cuda):
    """On the card the optimizer has no plain fallback: gradients the
    kernels cannot take (a non-contiguous view, float16, another size than
    the parameter's, on the CPU) raise, and the state stays as it was."""
    params = [torch.zeros(4, 6, device=cuda)]
    opt = schedule.NoamAdam(params, 256, **OPT_HYPER)
    good = torch.ones(4, 6, device=cuda)
    norm = schedule.global_norm([good])
    for bad in (torch.ones(6, 4, device=cuda).t(), good.half(),
                torch.ones(5, 6, device=cuda), good.cpu()):
        with pytest.raises((ValueError, TypeError)):
            opt.step([bad], norm)
    with pytest.raises(ValueError):
        schedule.global_norm([torch.ones(6, 4, device=cuda).t()])
    torch.cuda.synchronize()
    assert opt.count == 0 and bool((params[0] == 0).all())
