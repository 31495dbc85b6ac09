"""One whole decoder step per launch, on a hand-written Hopper kernel.

Port of ``sketchformer_tpu/ops/pallas_decode_stack.py::fused_decode_step``
(K13): the L-layer pre-LN decoder step of an embedded (B, d) input at
position ``t`` (cached causal self-attention, cross-attention to the
precomputed bottleneck K/V, FFN, every LayerNorm) and the final LayerNorm.
The kernel is ``decode_step`` of ``csrc/decode_chunk.cu``, with the new
position attended from its f32 values, as ``_step_kernel`` does: in
bfloat16 the cluster kernel's step kind (the batch as the products' rows, a
thread block cluster a row group, on the plan of
``decode_chunk.cluster_plan`` with no head, N = 0), in float32 and for what
``decode_chunk.cluster_decline`` names the per-row kernel's trunk.
``ROUTES`` counts which took each launch. ``fused_decode_step_reference``
is its plain torch version. The caches are head-folded ``(L, B*H, Tmax,
Dh)`` post-qk-norm rows in the compute dtype, of which ``[0, t)`` are read;
the new rows come back as ``(L, B*H, Dh)`` for the caller to scatter (the
kernel does not write the cache). Weights are
``convert.stacked_decoder_weights``; cross K/V come from
``decode_chunk.precompute_cross_kv``.

The chunk kernels (``ops/decode_chunk.py``) superseded this step on the TPU
and serve every decode of the CLI; :func:`greedy_steps` is the step loop
that drives it (the port of ``tools/bench_decode_probe.py``'s), one launch
per step. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches the kernel or raises. ``LAUNCHES`` counts launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping

import torch

from sketchformer_tpu_torch.ops import _build
from sketchformer_tpu_torch.ops.decode_chunk import (
    KIND_STEP,
    PLAN_INTS,
    _PRODUCT_KEYS,
    _masked_head_bias,
    _trunk_reference,
    check_trunk,
    cluster_decline,
    cluster_fit,
    cluster_plan,
    plan_ints,
    tie_margin,
)

LAUNCHES = {"decode_step": 0}
ROUTES = {"cluster": 0, "rows": 0}


def reset_launches() -> None:
    LAUNCHES["decode_step"] = 0
    for k in ROUTES:
        ROUTES[k] = 0


@functools.lru_cache(maxsize=16)
def _step_plan(B, d, H, dff, Tmax, Mq, device_index):
    """The cluster kernel's plan of one step as its C ints, or None where no
    plan fits: ``cluster_plan`` with no head (N = 0: no head buffer, no pick
    state). Cached by geometry: a step loop launches the same one at every
    position."""
    plan = cluster_plan(B, d=d, H=H, dff=dff, N=0, Tmax=Tmax, Mq=Mq,
                        cont=False,
                        max_clusters=cluster_fit(device_index, KIND_STEP))
    return None if plan is None else (ctypes.c_int * PLAN_INTS)(
        *plan_ints(plan))


def fused_decode_step_reference(x, k_cache, v_cache, cross_k, cross_v, w, t,
                                *, num_heads, qk_norm=False):
    """``(h (B, d), k_new, v_new (L, B*H, Dh))`` in x's dtype."""
    rows = []
    h = _trunk_reference(x, int(t), k_cache, v_cache, cross_k, cross_v, w,
                         num_heads=num_heads, qk_norm=qk_norm, new_rows=rows)
    B = x.shape[0]
    k_new, v_new = (torch.stack([r[i].reshape(B * num_heads, -1)
                                 for r in rows]) for i in (0, 1))
    return h, k_new, v_new


def fused_decode_step(x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cross_k: torch.Tensor,
                      cross_v: torch.Tensor, w: Mapping[str, torch.Tensor],
                      t: int, *, num_heads: int, qk_norm: bool = False):
    """One full decoder-stack AR step at position ``t`` (the number of
    valid cache rows): :func:`fused_decode_step_reference` on the kernel
    for CUDA tensors."""
    if x.device.type == "cpu":
        return fused_decode_step_reference(x, k_cache, v_cache, cross_k,
                                           cross_v, w, t, num_heads=num_heads,
                                           qk_norm=qk_norm)
    if x.device.type != "cuda":
        raise ValueError(f"fused_decode_step: unsupported device {x.device}")
    dev, dt = x.device, x.dtype
    code = _build.dtype_code(x)
    B, d = x.shape
    _build.require(x, "x", dev, dt, (B, d))
    dims, wptrs, scale = check_trunk(
        w, k_cache, v_cache, cross_k, cross_v, B=B, d=d, t0=int(t), K=1,
        num_heads=num_heads, dtype=dt, device=dev)
    L, BH, Tmax, Dh = k_cache.shape
    h = torch.empty((B, d), dtype=dt, device=dev)
    k_new = torch.empty((L, BH, Dh), dtype=dt, device=dev)
    v_new = torch.empty_like(k_new)
    # 16-byte loads: the product weights, the input rows and the k/v rows
    aligned = all(t.data_ptr() % 16 == 0 for t in
                  (*(w[k] for k in _PRODUCT_KEYS), x, k_cache, v_cache,
                   cross_k, cross_v))
    plan_arr = None
    if cluster_decline(dt, d=d, H=num_heads, dff=dims[5], N=0,
                       aligned=aligned) is None:
        plan_arr = _step_plan(B, d, num_heads, dims[5], Tmax, dims[7],
                              dev.index)
    cdims = (ctypes.c_int * 17)(*dims, 0, int(qk_norm), 0, 0, 0, 0, 0)
    fdims = (ctypes.c_float * 2)(scale, 0.0)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.sk_decode_step(
            code, ctypes.addressof(wptrs), _build.ptr(k_cache),
            _build.ptr(v_cache), _build.ptr(cross_k), _build.ptr(cross_v),
            _build.ptr(x), _build.ptr(h), _build.ptr(k_new),
            _build.ptr(v_new), ctypes.addressof(cdims),
            ctypes.addressof(fdims),
            None if plan_arr is None else ctypes.addressof(plan_arr),
            _build.stream(x))
    _build.check(err, "decode_step")
    LAUNCHES["decode_step"] += 1
    ROUTES["rows" if plan_arr is None else "cluster"] += 1
    return h, k_new, v_new


def greedy_steps(prev, finished, k_cache, v_cache, cross_k, cross_v, emb,
                 pos, head_w, head_b, w, t0, *, num_heads, qk_norm=False,
                 pad_id=0, sos_id=1, eos_id=2, step=fused_decode_step,
                 return_margins=False):
    """``pos.shape[0]`` greedy token steps from position ``t0``, one
    :func:`fused_decode_step` each, with the operands and results of
    ``decode_chunk``: each step embeds the previous pick (``emb[prev] *
    sqrt(d) + pos[j]`` in the compute dtype), scatters the new k/v rows
    into the caches at ``t0 + j``, and picks the argmax of ``dt(h.W) +
    bias`` with PAD and SOS masked; finished rows emit PAD, EOS finishes a
    row. Returns ``(ids (B, K) int32, finished (B,) int32)``, plus each
    step's (B, K) ``tie_margin`` of the logits with ``return_margins``."""
    K, d = pos.shape
    dt = emb.dtype
    sqrt_d = torch.tensor(d ** 0.5, dtype=dt, device=emb.device)
    hb = _masked_head_bias(head_b, pad_id, sos_id)
    hw = head_w.float()
    ids = torch.empty((prev.shape[0], K), dtype=torch.int32,
                      device=prev.device)
    margins = torch.empty(ids.shape, dtype=torch.float32, device=prev.device)
    fin = finished.clone()
    for j in range(K):
        t = t0 + j
        x = emb[prev.long()] * sqrt_d + pos[j]
        h, k_new, v_new = step(x, k_cache, v_cache, cross_k, cross_v, w, t,
                               num_heads=num_heads, qk_norm=qk_norm)
        k_cache[:, :, t] = k_new
        v_cache[:, :, t] = v_new
        logits = torch.matmul(h.float(), hw).to(dt).float() + hb
        if return_margins:
            margins[:, j] = tie_margin(logits, dt)
        nxt = logits.argmax(dim=-1).to(torch.int32)   # first index of max
        nxt = torch.where(fin != 0, pad_id, nxt)
        fin = torch.where(nxt == eos_id, 1, fin)
        ids[:, j] = nxt
        prev = nxt
    return (ids, fin, margins) if return_margins else (ids, fin)
