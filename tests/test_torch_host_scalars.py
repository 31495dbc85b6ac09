"""The two scalars of the model's forward held on the host: sqrt(d_model)
of the input embeddings and 1/sqrt(head_dim) of the composed attention.

Each is a 0-d CPU tensor in the compute dtype, which a CUDA op takes as a
kernel argument (no copy to the card, no wait on it). These tests pin, on
the CPU, that each value is the one a tensor of that dtype made on the
input's device holds, that neither is a buffer (``model.to(cuda)`` would
move one to the card), and that the outputs equal, bit for bit, the
formulas with the scalar made on the input's device. On the card, that a
whole embed batch makes no synchronising call and that z is bit-equal:
``test_torch_kernels_cuda.py``."""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.models import attention
from sketchformer_tpu_torch.models.embeddings import (
    ContinuousEmbed,
    TokenEmbed,
)

DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]
D_MODELS = [96, 128, 256, 384, 512]
HEAD_DIMS = [16, 32, 48, 64, 128]
T, VOCAB = 12, 40


def _device_sqrt_d(d, dt, device):
    """sqrt(d_model) in ``dt``, made on ``device``."""
    return torch.tensor(np.sqrt(d), dtype=dt, device=device)


def _device_scale(q):
    """1/sqrt(Dh) in q's dtype, computed in f32, made on q's device."""
    depth = np.float32(q.shape[-1])
    return torch.tensor(float(np.float32(1.0) / np.sqrt(depth)),
                        dtype=q.dtype, device=q.device)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[x.dtype])


@pytest.mark.parametrize("Dh", HEAD_DIMS)
@pytest.mark.parametrize("d", D_MODELS)
@pytest.mark.parametrize("dt", DTYPES)
def test_host_scalars_equal_the_device_formulas_bit_for_bit(dt, d, Dh):
    gen = torch.Generator().manual_seed(d * 1000 + Dh)
    tok = TokenEmbed(VOCAB, d, T, dt)
    cont = ContinuousEmbed(d, T, 3, dt)
    with torch.no_grad():
        for p in list(tok.parameters()) + list(cont.parameters()):
            p.copy_(torch.randn(p.shape, generator=gen))

    # the values: 0-d, on the host, the rounded value, and no buffer
    for m in (tok, cont):
        s = m.sqrt_d
        assert s.shape == () and s.device.type == "cpu" and s.dtype == dt
        assert torch.equal(_bits(s), _bits(torch.tensor(np.sqrt(d),
                                                        dtype=dt)))
        assert all(b is not s for b in m.buffers())
        assert not any(k.endswith("sqrt_d") for k in m.state_dict())
    q = torch.randn(2, T, 2, Dh, generator=gen).to(dt)
    k = torch.randn(2, T, 2, Dh, generator=gen).to(dt)
    v = torch.randn(2, T, 2, Dh, generator=gen).to(dt)
    s = attention._scale(q)
    assert s.shape == () and s.device.type == "cpu" and s.dtype == dt
    assert torch.equal(_bits(s), _bits(_device_scale(q)))

    # the outputs: the same formulas with the scalar made on the device
    ids = torch.randint(0, VOCAB, (2, T), generator=gen)
    rows = torch.randn(2, T, 3, generator=gen)
    for m, x, pos in ((tok, ids, None), (tok, ids[:, :1], 5),
                      (cont, rows, None), (cont, rows[:, :1], 7)):
        emb = m.embed(x) if m is tok else m.proj(x)
        start = pos or 0
        want = (emb * _device_sqrt_d(d, dt, x.device)
                + m.table[start:start + x.shape[1]].to(dt))
        assert torch.equal(_bits(m(x, pos)), _bits(want))
    mask = torch.rand(2, 1, 1, T, generator=gen) > 0.3
    mask[..., 0] = True
    logits = torch.einsum("bqhd,bkhd->bhqk", q * _device_scale(q), k).float()
    weights = torch.softmax(torch.where(mask, logits, attention.NEG_INF),
                            dim=-1).to(dt)
    want = torch.einsum("bhqk,bkhd->bqhd", weights, v)
    got = attention.dot_product_attention(q, k, v, mask=mask)
    assert torch.equal(_bits(got), _bits(want))
