"""Batched autoregressive reconstruction with KV-cached greedy decode.

Port of ``sketchformer_tpu/infer/decode.py``. The composed decoders run one
``Sketchformer.decode_step`` per position (the self-attention against the
per-layer :class:`KVCache`, through the decode-attention kernel when
``attn_impl='pallas'``) and stop as soon as every row has finished, read
back once per step; ``early_exit=False`` runs all T steps (the outputs are
the same). Greedy token and greedy MDN decoding from raw sketches route to
the chunk-kernel engine (``infer/fast_decode.py``) where it supports the
configuration, as the JAX decoders route; decoding from z routes the token
decoder only, as in the JAX package. MDN temperature sampling draws from a
``torch.Generator``.

``tokens_to_sketches`` / ``cont_to_sketches`` turn the outputs back into
stroke-3 on the host. Under a profiler each read of the finished flags is
the span ``decode.exit_read`` and a loop that stops before its horizon
marks ``decode.early_exit`` (``utils/trace.py``).
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from sketchformer_tpu_torch.data.pipeline import PEN_END
from sketchformer_tpu_torch.data.tokenizer import EOS_ID, PAD_ID, SOS_ID
from sketchformer_tpu_torch.utils.engines import note_engine
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.ops import mdn
from sketchformer_tpu_torch.utils.trace import mark, span

NEG_INF = -1e9


def check_len(cfg, max_len: Optional[int]) -> int:
    """The decode horizon: ``max_len``, default the model's, at most the
    model's (the position table is sized by the model config)."""
    max_len = max_len or cfg.max_len
    if max_len > cfg.max_len:
        raise ValueError(
            f"decode max_len={max_len} exceeds model max_len={cfg.max_len} "
            "(the posenc table is sized by the model config)")
    return max_len


def all_finished(finished: torch.Tensor, stop: int, horizon: int) -> bool:
    """The host's read of whether every row of ``finished`` (bool) has
    finished, for a loop that would stop after step ``stop`` of
    ``horizon``; an exit before the horizon is marked."""
    with span("decode.exit_read"):
        done = bool(finished.all())
    if done and stop < horizon:
        mark("decode.early_exit")
    return done


# ---------------------------------------------------------------------------
# token mode
# ---------------------------------------------------------------------------


def make_token_decoder(model: Sketchformer, max_len: Optional[int] = None,
                       early_exit: bool = True, fast: bool = True,
                       steps_per_call: Optional[int] = None) -> Callable:
    """``decode(enc) -> (B, max_len) int32 ids``.

    ``fast=True`` routes supported configs through the chunk kernel
    (``infer/fast_decode.py``; identical ids). Emitted rows are ``[t_1 ..
    EOS PAD ...]`` (SOS stripped), the pipeline's ``dec_tgt`` layout.
    """
    cfg = model.config
    T = check_len(cfg, max_len)
    if fast and early_exit:
        from sketchformer_tpu_torch.infer.fast_decode import (
            fast_decode_support,
            make_fast_token_decoder,
        )

        ok, why = fast_decode_support(model)
        if ok:
            note_engine("decode", "fused-chunk-kernel")
            return make_fast_token_decoder(model, max_len=T,
                                           steps_per_call=steps_per_call)
        note_engine("decode", "composed", why)
    if steps_per_call is not None:
        warnings.warn(
            "steps_per_call applies only to the chunk decode kernel; the "
            "composed path already early-exits per step, so the knob has "
            "no effect here", stacklevel=2)

    @torch.inference_mode()
    def decode(enc):
        _, memory, memory_mask = model.encode(enc)
        return _decode_tokens_from_memory(model, memory, memory_mask, T,
                                          early_exit)

    return decode


def make_token_decoder_from_z(model: Sketchformer,
                              max_len: Optional[int] = None,
                              early_exit: bool = True,
                              fast: bool = True) -> Callable:
    """``decode(z) -> ids`` from stored embeddings."""
    cfg = model.config
    T = check_len(cfg, max_len)
    if fast and early_exit:
        from sketchformer_tpu_torch.infer.fast_decode import (
            fast_decode_support,
            make_fast_token_decoder_from_z,
        )

        ok, why = fast_decode_support(model)
        if ok:
            return make_fast_token_decoder_from_z(model, max_len=T)
        note_engine("decode", "composed", why)

    @torch.inference_mode()
    def decode(z):
        return _decode_tokens_from_memory(model, model.memory_from_z(z),
                                          None, T, early_exit)

    return decode


def _decode_tokens_from_memory(model, memory, memory_mask, T,
                               early_exit=True):
    B = memory.shape[0]
    dev = memory.device
    cache = model.init_cache(B, T)
    prev = torch.full((B,), SOS_ID, dtype=torch.int32, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    out = torch.full((B, T), PAD_ID, dtype=torch.int32, device=dev)
    for t in range(T):
        logits = model.decode_step(prev[:, None], memory, memory_mask, t,
                                   cache)[:, 0]
        logits[:, PAD_ID] = NEG_INF
        logits[:, SOS_ID] = NEG_INF
        nxt = logits.argmax(dim=-1).to(torch.int32)
        nxt = torch.where(finished, PAD_ID, nxt)
        finished = finished | (nxt == EOS_ID)
        out[:, t] = nxt
        prev = nxt
        if early_exit and all_finished(finished, t + 1, T):
            break
    return out


# ---------------------------------------------------------------------------
# continuous (MDN) mode
# ---------------------------------------------------------------------------


def make_cont_decoder(model: Sketchformer, max_len: Optional[int] = None,
                      temperature: float = 0.0,
                      early_exit: bool = True) -> Callable:
    """``decode(enc, enc_mask=None, generator=None) -> (xy (B, T, 2) f32,
    pen (B, T) int32, valid (B, T) bool)``.

    ``temperature == 0``: greedy (argmax component mean and pen state),
    routed through the MDN chunk kernel where supported. Otherwise samples
    at that temperature from ``generator``.
    """
    cfg = model.config
    T = check_len(cfg, max_len)
    greedy = temperature <= 0.0
    if greedy and early_exit:
        from sketchformer_tpu_torch.infer.fast_decode import (
            fast_cont_decode_support,
            make_fast_cont_decoder,
        )

        ok, why = fast_cont_decode_support(model, greedy=True)
        if ok:
            note_engine("cont-decode", "fused-chunk-kernel")
            return make_fast_cont_decoder(model, max_len=T)
        note_engine("cont-decode", "composed", why)

    @torch.inference_mode()
    def decode(enc, enc_mask=None, generator=None):
        _, memory, memory_mask = model.encode(enc, enc_mask)
        return _decode_cont_from_memory(model, memory, memory_mask, T,
                                        generator, greedy, temperature,
                                        early_exit)

    return decode


def make_cont_decoder_from_z(model: Sketchformer,
                             max_len: Optional[int] = None,
                             temperature: float = 0.0,
                             early_exit: bool = True) -> Callable:
    """``decode(z, generator=None) -> (xy, pen, valid)``, composed."""
    cfg = model.config
    T = check_len(cfg, max_len)
    greedy = temperature <= 0.0

    @torch.inference_mode()
    def decode(z, generator=None):
        return _decode_cont_from_memory(model, model.memory_from_z(z), None,
                                        T, generator, greedy, temperature,
                                        early_exit)

    return decode


def _decode_cont_from_memory(model, memory, memory_mask, T, generator,
                             greedy, temperature, early_exit=True):
    cfg = model.config
    B = memory.shape[0]
    dev = memory.device
    cache = model.init_cache(B, T)
    row = torch.zeros((B, 5), dtype=torch.float32, device=dev)
    row[:, 3] = 1.0
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    xy = torch.zeros((B, T, 2), dtype=torch.float32, device=dev)
    pen = torch.full((B, T), PEN_END, dtype=torch.int32, device=dev)
    valid = torch.zeros((B, T), dtype=torch.bool, device=dev)
    for t in range(T):
        raw = model.decode_step(row[:, None], memory, memory_mask, t,
                                cache)[:, 0]
        xy_t, pen_t = mdn.sample(mdn.split_params(raw, cfg.num_mixtures),
                                 generator, temperature=temperature,
                                 greedy=greedy)
        pen_t = torch.where(finished, PEN_END, pen_t).to(torch.int32)
        xy_t = torch.where(finished[:, None], 0.0, xy_t)
        xy[:, t] = xy_t
        pen[:, t] = pen_t
        valid[:, t] = ~finished
        finished = finished | (pen_t == PEN_END)
        row = torch.cat([xy_t, F.one_hot(pen_t.long(), 3).float()], dim=-1)
        if early_exit and all_finished(finished, t + 1, T):
            break
    return xy, pen, valid


# ---------------------------------------------------------------------------
# host-side conversion back to stroke-3
# ---------------------------------------------------------------------------


def tokens_to_sketches(tokenizer, ids) -> list:
    """(B, T) decoded ids -> list of stroke-3 arrays."""
    return [tokenizer.decode(row) for row in np.asarray(ids)]


def cont_to_sketches(xy, pen, valid, scale: float = 1.0) -> list:
    """MDN decode outputs (numpy) -> list of denormalized stroke-3 arrays:
    each row up to its first invalid or PEN_END step, its last point
    closing the final stroke."""
    out = []
    for i in range(xy.shape[0]):
        stop = np.flatnonzero(~np.asarray(valid[i], bool)
                              | (np.asarray(pen[i]) == PEN_END))
        n = int(stop[0]) if len(stop) else xy.shape[1]
        sk = np.concatenate([xy[i, :n] * scale,
                             np.asarray(pen[i, :n], np.float32)[:, None]],
                            axis=1).astype(np.float32).reshape(-1, 3)
        if len(sk):
            sk[-1, 2] = 1.0  # close the final stroke
        out.append(sk)
    return out
