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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D", [(300, 96), (301, 50), (16, 512)])
def test_layernorm_rows(cuda, dtype, M, D):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = _rand(gen, cuda, M, D, dtype=dtype)
    s, b = 1 + _rand(gen, cuda, D, scale=0.1), _rand(gen, cuda, D, scale=0.1)
    _close(es.layernorm_rows(x, s, b), es.layernorm_rows_reference(x, s, b),
           dtype)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("BH,Tmax,Dh", [(48, 40, 32), (6, 33, 128),
                                        (10, 20, 64), (5, 9, 24)])
def test_decode_attention(cuda, dtype, BH, Tmax, Dh):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q = _rand(gen, cuda, BH, 1, Dh, dtype=dtype)
    k, v = (_rand(gen, cuda, BH, Tmax, Dh, dtype=dtype) for _ in range(2))
    for cache_len in (1, 17 % Tmax + 1, Tmax):
        before = da.LAUNCHES["decode_attention"]
        got = da.decode_attention(q, k, v, cache_len)
        assert da.LAUNCHES["decode_attention"] == before + 1
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
    (4, True, 8, 2)])
@pytest.mark.parametrize("cont", [False, True], ids=["token", "mdn"])
def test_decode_chunk(cuda, dtype, H, qk, t0, rows, cont):
    """``rows`` 2: a batch above the SM count, which the kernel runs two
    rows per block (the last block half empty)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B = 7 if rows == 1 else torch.cuda.get_device_properties(
        cuda).multi_processor_count + 3
    L, d, dff, K, Tmax = 2, 128, 256, 8, 32
    N = 6 * 5 + 3 if cont else 517
    ops = _chunk_operands(gen, cuda, B=B, L=L, d=d, H=H, dff=dff, N=N,
                          Tmax=Tmax, Mq=3, K=K, t0=t0, dtype=dtype,
                          cont=cont)
    kv_ref = (ops["k_cache"].clone(), ops["v_cache"].clone())
    name = "decode_cont_chunk" if cont else "decode_chunk"
    before = dc.LAUNCHES[name]
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
@pytest.mark.parametrize("M,y_f32", [(1000, True), (4100, False)])
def test_linear_tn(cuda, dtype, M, y_f32):
    gen = torch.Generator(device=cuda).manual_seed(8)
    x = _rand(gen, cuda, M, 72, dtype=dtype)
    y = _rand(gen, cuda, M, 130, dtype=torch.float32 if y_f32 else dtype)
    kw = dict(drop=_bytes(gen, cuda, M, 130), thresh=26, keep_scale=1.11)
    _close(es.linear_tn(x, y, **kw), es.linear_tn_reference(x, y, **kw),
           dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,N,drop", [(50, 70, False), (9000, 256, True)])
def test_sum_rows(cuda, dtype, R, N, drop):
    gen = torch.Generator(device=cuda).manual_seed(9)
    x = _rand(gen, cuda, R, N, dtype=dtype)
    kw = dict(drop=_bytes(gen, cuda, R, N), thresh=26, keep_scale=1.11) \
        if drop else {}
    _close(nt.sum_rows(x, **kw), nt.sum_rows_reference(x, **kw),
           torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,D,resid_dt,out_dt", [(300, 96, True, False),
                                                 (1000, 256, False, True)])
def test_layernorm_bwd(cuda, dtype, M, D, resid_dt, out_dt):
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = _rand(gen, cuda, M, D, dtype=dtype)
    dy = _rand(gen, cuda, M, D)
    s = 1 + _rand(gen, cuda, D, scale=0.1)
    kw = dict(resid=_rand(gen, cuda, M, D,
                          dtype=dtype if resid_dt else torch.float32),
              out_dtype=dtype if out_dt else torch.float32)
    for g, w in zip(nt.layernorm_bwd(x, dy, s, **kw),
                    nt.layernorm_bwd_reference(x, dy, s, **kw)):
        _close(g, w, dtype if out_dt else torch.float32)


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

from sketchformer_tpu_torch.ops import dropout_prng as dp  # noqa: E402
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
        assert torch.equal(es.linear_tn(a, g, drop=drop_a, **kw),
                           es.linear_tn(a, g, drop=drop_b, **kw))
        assert torch.equal(nt.sum_rows(g, drop=drop_a, **kw),
                           nt.sum_rows(g, drop=drop_b, **kw))
    assert dp.LAUNCHES["prng_draw"] == 4
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
