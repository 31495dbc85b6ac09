"""The host side of ``linear_tn``: the weight gradient with its bias
gradient (``bias_grad=True``), the split planner, and the wrapper on CPU
tensors (the plain version, no launch)."""

import numpy as np
import pytest
import torch

from sketchformer_tpu_torch.ops import encoder_stack as es
from sketchformer_tpu_torch.ops import norm_train as nt

SMEM_LIMIT = 232448   # bytes of shared memory a block may opt into (H100)


def _case(dtype, M, K, N, y_f32, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32))
    drop = torch.from_numpy(rng.integers(0, 256, (M, N), dtype=np.uint8))
    return x.to(dtype), (y if y_f32 else y.to(dtype)), drop


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("y_f32", [True, False], ids=["y_f32", "y_dt"])
@pytest.mark.parametrize("masked", [True, False], ids=["bits", "nomask"])
def test_bias_grad_is_the_masked_column_sum(dtype, y_f32, masked):
    x, y, drop = _case(dtype, 77, 24, 40, y_f32)
    kw = dict(drop=drop, thresh=26, keep_scale=1.11) if masked else {}
    es.reset_launches()
    dw, db = es.linear_tn(x, y, bias_grad=True, **kw)
    assert es.LAUNCHES["linear_tn"] == 0
    assert torch.equal(dw, es.linear_tn_reference(x, y, **kw))
    yv = y.float()
    if masked:
        yv = yv * es.dropout_mask(drop, 26, 1.11, yv)
    assert torch.equal(db, nt.sum_rows_reference(yv))
    assert dw.dtype == db.dtype == torch.float32
    assert torch.equal(es.linear_tn(x, y, **kw), dw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plan_covers_every_row_once(dtype):
    for M in (1, 63, 64, 65, 1000, 4100, 12288, 49152, 98304):
        for K, N in ((72, 130), (256, 768), (512, 256), (256, 256),
                     (256, 512), (3, 5)):
            tiles, cols, splits, rps = es.tn_plan(M, K, N, dtype)
            tile = es.TN_TILE[dtype]
            assert tiles == -(-K // tile) * cols and cols == -(-N // tile)
            assert rps % es.TN_SLAB == 0 and rps > 0
            assert splits * rps >= M > (splits - 1) * rps
            assert tiles * splits <= max(tiles, 2 * 132)


def test_bf16_stages_fit_shared_memory():
    assert es.TN_SMEM <= SMEM_LIMIT
