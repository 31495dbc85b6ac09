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


def _close(got, want, dtype):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    rel = (got - want).abs().max().item() / want.abs().max().item()
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
                           "layernorm_rows": 2 * L + 1}
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
def test_cuda_wrappers_raise_instead_of_falling_back(cuda):
    a = torch.zeros(8, 16, dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        es.linear(a, torch.zeros(16, 8, dtype=torch.float16, device=cuda),
                  torch.zeros(8, device=cuda))
    qkv = torch.zeros(1, 8, 3 * 2 * 256, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        es.encoder_attention(qkv, None, num_heads=2)


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
                           "layernorm_rows": 0}


def test_other_devices_raise():
    a = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        es.linear(a, a, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        es.encoder_attention(torch.zeros(1, 4, 6, device="meta"), None,
                             num_heads=1)
    with pytest.raises(ValueError, match="unsupported device"):
        es.layernorm_rows(a, a[0], a[0])
