"""Fast batched greedy decode: K whole AR steps per kernel launch.

Port of ``sketchformer_tpu/infer/fast_decode.py``. The decode is a host loop
over chunks: each chunk is one launch of ``ops/decode_chunk.py`` (token) or
``decode_cont_chunk`` (MDN), which runs K steps of the whole decoder, the
head and the greedy pick for every row and writes the K new k/v rows into
the caches. After each chunk the loop reads back whether every row has
finished and stops if so: the JAX ``while_loop``'s early exit, at chunk
granularity. Token semantics are those of ``infer/decode.py``'s composed
decoder (SOS start, PAD/SOS logits masked, EOS finishes a row, finished
rows emit PAD); MDN greedy semantics those of its greedy composed decoder.

Under a profiler (``utils/trace.py``) a call of a decoder is the span
``decode.request``; inside it ``decode.prologue`` (the encoder or the
memory from z, the cross K/V, the zeroed caches and the position table),
then per chunk ``decode.chunk`` (the launch and its output writes) and
``decode.exit_read`` (the host's read of the finished flags), and the
mark ``decode.early_exit`` where the loop stops before its horizon.

The configurations declined are the JAX engine's (post-LN, the ``direct``
bottleneck, d_model not divisible by num_heads), logged once through
``note_engine`` and served by the composed decoder. The decode cache holds
``ceil(T / K) * K`` positions.

:func:`make_step_token_decoder` is the same greedy token decode as a step
loop on the whole-step kernel (``ops/decode_step.py``, K13, one launch per
step and no early exit), which the chunk kernels superseded; no CLI path
runs it.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from sketchformer_tpu_torch.data.pipeline import PEN_END
from sketchformer_tpu_torch.data.tokenizer import EOS_ID, PAD_ID, SOS_ID
from sketchformer_tpu_torch.utils.engines import note_engine
from sketchformer_tpu_torch.utils.trace import span
from sketchformer_tpu_torch.infer import decode as composed
from sketchformer_tpu_torch.models.embeddings import (
    sinusoidal_position_encoding,
)
from sketchformer_tpu_torch.models.sketchformer import Sketchformer
from sketchformer_tpu_torch.ops.decode_chunk import (
    decode_chunk,
    decode_cont_chunk,
    pad_head,
    precompute_cross_kv,
)
from sketchformer_tpu_torch.ops.decode_step import greedy_steps

# Steps per launch: K launches per decode of ceil(T / K) * K steps, and the
# early exit can stop only on a chunk boundary (the JAX engine's default).
DEFAULT_STEPS_PER_CALL = 16


def fast_cont_decode_support(model: Sketchformer, greedy: bool = True):
    """(supported, reason-declined) for the MDN chunk engine."""
    cfg = model.config
    if not cfg.use_continuous:
        return False, "token mode (use fast_decode_support)"
    if not greedy:
        return False, "temperature sampling (greedy only in-kernel)"
    return _structural_support(cfg)


def fast_decode_support(model: Sketchformer):
    """(supported, reason-declined) for the token chunk engine."""
    if model.config.use_continuous:
        return False, "continuous/MDN mode"
    return _structural_support(model.config)


def supports_fast_decode(model: Sketchformer) -> bool:
    """Whether greedy token decode of ``model`` runs on the chunk engine."""
    return fast_decode_support(model)[0]


def _structural_support(cfg):
    if not cfg.norm_first:
        return False, "post-LN config"
    if cfg.bottleneck_mode not in ("attn", "mean"):
        return False, f"bottleneck_mode={cfg.bottleneck_mode!r}"
    if cfg.d_model % cfg.num_heads:
        return False, "d_model not divisible by num_heads"
    return True, ""


def decoder_operands(model: Sketchformer) -> dict:
    """The model's decode-kernel operands, built once per decoder: the
    stacked trunk, the input embedding and the head in the kernel's
    dtypes, the head padded to whole 16-column tiles (:func:`pad_head`)."""
    cfg = model.config
    dt = cfg.compute_dtype
    head_w, head_b = pad_head(model.out_head.proj.kernel.detach().to(dt),
                              model.out_head.proj.bias.detach().float(),
                              cont=cfg.use_continuous)
    ops = {"w": model.decoder.stacked_weights(), "head_w": head_w,
           "head_b": head_b}
    if cfg.use_continuous:
        ops["in_w"] = model.dec_embed.proj.kernel.detach().to(dt)
        ops["in_b"] = model.dec_embed.proj.bias.detach().float()
    else:
        ops["emb"] = model.dec_embed.embed.embedding.detach().to(dt)
    return ops


def _chunk_state(model, ops, memory, T, steps_per_call):
    """(K, Tp, cross K/V, zeroed caches, position table) for a decode of T
    steps from ``memory``."""
    cfg = model.config
    dt = cfg.compute_dtype
    B = memory.shape[0]
    H, d = cfg.num_heads, cfg.d_model
    K = steps_per_call or min(DEFAULT_STEPS_PER_CALL, T)
    Tp = -(-T // K) * K                      # chunk-aligned horizon
    ck, cv = precompute_cross_kv(memory, ops["w"], num_heads=H,
                                 qk_norm=cfg.qk_norm)
    kc = torch.zeros((cfg.num_layers, B * H, Tp, d // H), dtype=dt,
                     device=memory.device)
    pos = torch.from_numpy(sinusoidal_position_encoding(
        max(cfg.max_len, Tp), d)).to(memory.device, dt)
    return K, Tp, ck, cv, kc, torch.zeros_like(kc), pos


def _decode_ids(model, ops, memory_of, T, steps_per_call=None):
    """Token ids of a decode of T steps from the memory ``memory_of()``
    gives."""
    cfg = model.config
    with span("decode.prologue"):
        memory = memory_of()
        K, Tp, ck, cv, kc, vc, pos = _chunk_state(model, ops, memory, T,
                                                  steps_per_call)
    B = memory.shape[0]
    dev = memory.device
    prev = torch.full((B,), SOS_ID, dtype=torch.int32, device=dev)
    fin = torch.zeros((B,), dtype=torch.int32, device=dev)
    out = torch.full((B, Tp), PAD_ID, dtype=torch.int32, device=dev)
    for t in range(0, Tp, K):
        with span("decode.chunk"):
            ids, fin = decode_chunk(
                prev, fin, kc, vc, ck, cv, ops["emb"], pos[t:t + K],
                ops["head_w"], ops["head_b"], ops["w"], t,
                num_heads=cfg.num_heads, qk_norm=cfg.qk_norm, pad_id=PAD_ID,
                sos_id=SOS_ID, eos_id=EOS_ID)
            out[:, t:t + K] = ids
            prev = ids[:, K - 1].contiguous()
        if composed.all_finished(fin != 0, t + K, Tp):
            break
    return out[:, :T]


def make_fast_token_decoder(model: Sketchformer,
                            max_len: Optional[int] = None,
                            steps_per_call: Optional[int] = None
                            ) -> Callable:
    """``decode(enc) -> (B, T) int32`` ids on the chunk kernel; the
    composed decoder for declined configurations.

    ``steps_per_call`` (chunk K) bounds the early exit's granularity: the
    loop can stop only on a K boundary."""
    ok, why = fast_decode_support(model)
    if not ok:
        note_engine("decode", "composed", why)
        if steps_per_call is not None:
            warnings.warn(
                "steps_per_call has no effect on the composed decode "
                "fallback (config unsupported by the chunk kernel); early "
                "exit there is per-step already", stacklevel=2)
        return composed.make_token_decoder(model, max_len=max_len,
                                           fast=False)
    T = composed.check_len(model.config, max_len)
    ops = decoder_operands(model)

    @torch.inference_mode()
    def decode(enc):
        with span("decode.request"):
            return _decode_ids(model, ops, lambda: model.encode(enc)[1], T,
                               steps_per_call)

    return decode


def make_step_token_decoder(model: Sketchformer,
                            max_len: Optional[int] = None) -> Callable:
    """``decode(enc) -> (B, T) int32`` ids, one whole-step kernel launch
    per position (:func:`greedy_steps`); the configurations the chunk
    engine declines raise."""
    ok, why = fast_decode_support(model)
    if not ok:
        raise ValueError(f"the step kernel does not serve this model: {why}")
    cfg = model.config
    T = composed.check_len(cfg, max_len)
    ops = decoder_operands(model)

    @torch.inference_mode()
    def decode(enc):
        _, memory, _ = model.encode(enc)
        _, _, ck, cv, kc, vc, pos = _chunk_state(model, ops, memory, T, T)
        B = memory.shape[0]
        prev = torch.full((B,), SOS_ID, dtype=torch.int32,
                          device=memory.device)
        ids, _ = greedy_steps(
            prev, torch.zeros_like(prev), kc, vc, ck, cv, ops["emb"],
            pos[:T], ops["head_w"], ops["head_b"], ops["w"], 0,
            num_heads=cfg.num_heads, qk_norm=cfg.qk_norm, pad_id=PAD_ID,
            sos_id=SOS_ID, eos_id=EOS_ID)
        return ids

    return decode


def make_fast_token_decoder_from_z(model: Sketchformer,
                                   max_len: Optional[int] = None
                                   ) -> Callable:
    """``decode(z) -> (B, T) int32`` ids from stored embeddings."""
    ok, why = fast_decode_support(model)
    if not ok:
        note_engine("decode", "composed", why)
        return composed.make_token_decoder_from_z(model, max_len=max_len,
                                                  fast=False)
    T = composed.check_len(model.config, max_len)
    ops = decoder_operands(model)

    @torch.inference_mode()
    def decode(z):
        with span("decode.request"):
            return _decode_ids(model, ops, lambda: model.memory_from_z(z), T)

    return decode


# ---------------------------------------------------------------------------
# continuous (MDN) greedy engine
# ---------------------------------------------------------------------------


def _decode_cont_fast(model, ops, memory_of, T, steps_per_call=None):
    """(xy, pen, valid) of a greedy decode of T steps from the memory
    ``memory_of()`` gives."""
    cfg = model.config
    with span("decode.prologue"):
        memory = memory_of()
        K, Tp, ck, cv, kc, vc, pos = _chunk_state(model, ops, memory, T,
                                                  steps_per_call)
    B = memory.shape[0]
    dev = memory.device
    # the composed decoder's start row
    prev = torch.zeros((B, 5), dtype=torch.float32, device=dev)
    prev[:, 3] = 1.0
    fin = torch.zeros((B,), dtype=torch.int32, device=dev)
    xy = torch.zeros((B, Tp, 2), dtype=torch.float32, device=dev)
    pen = torch.full((B, Tp), PEN_END, dtype=torch.int32, device=dev)
    valid = torch.zeros((B, Tp), dtype=torch.int32, device=dev)
    for t in range(0, Tp, K):
        with span("decode.chunk"):
            xy_c, pen_c, valid_c, fin = decode_cont_chunk(
                prev, fin, kc, vc, ck, cv, ops["in_w"], ops["in_b"],
                pos[t:t + K], ops["head_w"], ops["head_b"], ops["w"], t,
                num_heads=cfg.num_heads, num_mixtures=cfg.num_mixtures,
                qk_norm=cfg.qk_norm, pen_end=PEN_END)
            xy[:, t:t + K] = xy_c
            pen[:, t:t + K] = pen_c
            valid[:, t:t + K] = valid_c
            prev = torch.cat([xy_c[:, K - 1],
                              F.one_hot(pen_c[:, K - 1].long(), 3).float()],
                             dim=-1)
        if composed.all_finished(fin != 0, t + K, Tp):
            break
    return xy[:, :T], pen[:, :T], valid[:, :T].bool()


def make_fast_cont_decoder(model: Sketchformer,
                           max_len: Optional[int] = None,
                           temperature: float = 0.0,
                           early_exit: bool = True) -> Callable:
    """Greedy ``decode(enc, enc_mask=None, generator=None) -> (xy, pen,
    valid)`` on the MDN chunk kernel; the composed decoder otherwise."""
    ok, why = fast_cont_decode_support(model, greedy=temperature <= 0.0)
    if not ok:
        note_engine("cont-decode", "composed", why)
        return composed.make_cont_decoder(model, max_len=max_len,
                                          temperature=temperature,
                                          early_exit=early_exit)
    T = composed.check_len(model.config, max_len)
    ops = decoder_operands(model)

    @torch.inference_mode()
    def decode(enc, enc_mask=None, generator=None):
        del generator  # greedy: deterministic
        with span("decode.request"):
            return _decode_cont_fast(
                model, ops, lambda: model.encode(enc, enc_mask)[1], T)

    return decode


def make_fast_cont_decoder_from_z(model: Sketchformer,
                                  max_len: Optional[int] = None,
                                  temperature: float = 0.0,
                                  early_exit: bool = True) -> Callable:
    """Greedy ``decode(z, generator=None) -> (xy, pen, valid)`` from
    stored embeddings on the MDN chunk kernel."""
    ok, why = fast_cont_decode_support(model, greedy=temperature <= 0.0)
    if not ok:
        note_engine("cont-decode", "composed", why)
        return composed.make_cont_decoder_from_z(model, max_len=max_len,
                                                 temperature=temperature,
                                                 early_exit=early_exit)
    T = composed.check_len(model.config, max_len)
    ops = decoder_operands(model)

    @torch.inference_mode()
    def decode(z, generator=None):
        del generator
        with span("decode.request"):
            return _decode_cont_fast(model, ops,
                                     lambda: model.memory_from_z(z), T)

    return decode
