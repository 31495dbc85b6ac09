"""Checks of a kernel path's output against the plain route, for the runs
on the card: ``chip_smoke.py`` and the two benchmark tools
(``tools/bench_embed_pipeline.py``, ``tools/bench_decode_realistic.py``).
The tolerances, the embedding against the plain encoder stack, and a whole
greedy decode against the teacher-forced forward of its own output. A
failed check raises :class:`CheckFailed`.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

# max |kernel - plain| / max |plain| allowed, by dtype
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# a bf16 decode held to the float32 teacher-forced forward: a pick is
# compared where the float32 logits' top two are at least this many bf16
# ulps of the top value apart. The bf16 kernels round every layer's output,
# so their logits stray from the float32 ones by a few ulps: the widest
# margin at which a pick differed was 2.92 (H=2) and 3.21 (H=8) of 12,288
# steps each, at B=64, T=192 on an NVIDIA H100 80GB HBM3, 700 W
# (PERF.md §6), so this is about twice that
BF16_DECODE_TIE_ULPS = 6
# the kernels an embedding launches
ENCODE_KERNELS = ("linear", "encoder_attention", "layernorm_rows")


class CheckFailed(RuntimeError):
    """An output disagrees with its plain route."""


def dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def set_attn_impl(model, impl):
    """Every module's attention implementation (the stacks' gates and each
    layer's attention): 'xla' makes the model the plain composed one."""
    for m in model.modules():
        if hasattr(m, "attn_impl"):
            m.attn_impl = impl


def launched(names, fn, on_card: bool, cluster_only: bool = False):
    """``fn()`` with every kernel launch count reset just before. On the
    card each kernel in ``names`` must have launched (a declined engine
    would run the plain route unseen), and with ``cluster_only`` every
    decode chunk on the cluster kernel."""
    from sketchformer_tpu_torch import ops
    from sketchformer_tpu_torch.ops import decode_chunk

    ops.reset_launches()
    out = fn()
    if on_card:
        got = ops.launch_counts()
        missing = [k for k in names if not got.get(k)]
        if missing:
            raise CheckFailed(f"kernels {missing} did not launch")
        if cluster_only and decode_chunk.ROUTES["rows"]:
            raise CheckFailed(f"decode chunks off the cluster kernel: "
                              f"{decode_chunk.ROUTES}")
    return out


def plain_f32_copy(model):
    """The composed float32 model with ``model``'s weights, on its device,
    in eval mode: the judge of a decode's picks."""
    from sketchformer_tpu_torch.models.sketchformer import Sketchformer

    cfg = dataclasses.replace(model.config, dtype="float32", attn_impl="xla")
    ref = Sketchformer(cfg)
    ref.load_state_dict(model.state_dict())
    return ref.to(next(model.parameters()).device).eval()


def embed_check(name, model, enc, mask=None, weights=None) -> float:
    """The kernel path's z (``fast_embed``) against the same embedding
    through ``ops/encoder_stack.py::encoder_stack_reference``, within TOL of
    max |plain| in the model's compute dtype; returns the relative error."""
    from sketchformer_tpu_torch.infer.fast_encode import fast_embed
    from sketchformer_tpu_torch.ops.encoder_stack import (
        encoder_stack_reference,
    )

    cfg = model.config
    with torch.inference_mode():
        if weights is None:
            weights = model.encoder.stacked_weights()
        z_kernel = fast_embed(model, enc, mask, weights)
        km = model.enc_key_mask(enc, mask)
        enc_out = encoder_stack_reference(
            model.embed_input(enc), km, weights, num_heads=cfg.num_heads,
            qk_norm=cfg.qk_norm)
        z_plain = model.bottleneck.pooled_z(enc_out, km).float()
    if not torch.isfinite(z_kernel).all():
        raise CheckFailed(f"{name}: z not finite")
    err = (z_kernel.float() - z_plain).abs().max().item()
    rel = err / max(z_plain.abs().max().item(), 1e-30)
    tol = TOL[dtype_name(cfg.compute_dtype)]
    print(f"check {name}: z max_abs_err {err:.3e} rel {rel:.3e} (tol "
          f"{tol:.0e})", flush=True)
    if not rel <= tol:
        raise CheckFailed(f"{name}: z rel err {rel:.3e} above {tol:.0e}")
    return rel


def teacher_forced_check(name, model, enc, mask, out, dtype=torch.float32):
    """Every emitted greedy pick of a whole decode must be the argmax of
    the plain teacher-forced forward of ``model`` given the decoded prefix,
    except at near ties; the MDN xy must be that step's component mean.
    ``dtype`` is the decode's compute dtype: a float32 decode is held where
    the top two values are 1e-3 apart, a bf16 one (judged by a float32
    ``model``, :func:`plain_f32_copy`) where they are BF16_DECODE_TIE_ULPS
    bf16 ulps of the top value apart, its xy within TOL."""
    from sketchformer_tpu_torch.data.pipeline import PEN_END
    from sketchformer_tpu_torch.data.tokenizer import EOS_ID, PAD_ID, SOS_ID
    from sketchformer_tpu_torch.ops.decode_chunk import NEG_INF, tie_margin

    cfg = model.config
    ties = 1 if dtype == torch.float32 else BF16_DECODE_TIE_ULPS
    if cfg.use_continuous:
        xy, pen, valid = out
        B, T = pen.shape
        prev = torch.cat([xy, F.one_hot(pen.long(), 3).float()], -1)
        sos = torch.zeros((B, 1, 5), device=xy.device)
        sos[..., 3] = 1.0
        dec_in = torch.cat([sos, prev[:, :-1]], 1)
        with torch.inference_mode():
            raw = model(enc, dec_in, mask)["recon"].float()
        M = cfg.num_mixtures
        comp = raw[..., :M].argmax(-1)
        want_pen = raw[..., 6 * M:].argmax(-1)
        margins = torch.minimum(tie_margin(raw[..., :M], dtype),
                                tie_margin(raw[..., 6 * M:], dtype))
        want_xy = torch.stack([raw.gather(-1, (M + comp)[..., None])[..., 0],
                               raw.gather(-1, (2 * M + comp)[..., None])
                               [..., 0]], -1)
        live = valid.bool()
        picks, want_picks = pen, want_pen
    else:
        ids = out
        B, T = ids.shape
        dec_in = torch.cat([torch.full((B, 1), SOS_ID, dtype=ids.dtype,
                                       device=ids.device), ids[:, :-1]], 1)
        with torch.inference_mode():
            logits = model(enc, dec_in)["recon"].float()
        lane = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where((lane == PAD_ID) | (lane == SOS_ID), NEG_INF,
                             logits)
        want_picks = logits.argmax(-1)
        margins = tie_margin(logits, dtype)
        ended = torch.cumsum((ids == EOS_ID).int(), 1)
        live = (ended == 0) | ((ended == 1) & (ids == EOS_ID))
        if not torch.all(ids[~live] == PAD_ID):
            raise CheckFailed(f"{name}: a finished row emitted something "
                              "other than PAD")
        picks = ids
    # the forward reads the decode's own prefix, so a near tie leaves only
    # its own step undecided
    checked = live & (margins >= ties)
    differ = live & (picks.long() != want_picks.long())
    widest = margins[differ].max().item() if differ.any() else 0.0
    msg = ""
    if cfg.use_continuous:
        err = (xy[checked] - want_xy[checked]).abs().max().item() \
            if checked.any() else 0.0
        scale = want_xy[checked].abs().max().item() if checked.any() else 0.0
        if not err <= TOL[dtype_name(dtype)] * scale:
            raise CheckFailed(f"{name}: xy differs from the component mean "
                              f"by {err:.3e}")
        if not torch.all(pen[~live] == PEN_END):
            raise CheckFailed(f"{name}: a finished row emitted a pen other "
                              "than PEN_END")
        msg = f", xy max_abs_err {err:.3e}"
    print(f"check {name}: {int(checked.sum())} of {int(live.sum())} live "
          f"row-steps held to the teacher-forced argmax (the rest are near "
          f"ties, below {ties} in tie_margin; "
          f"{int((live & (margins < 4)).sum())} below 4, "
          f"{int((live & (margins < 8)).sum())} below 8); "
          f"{int(differ.sum())} picks differ, the widest at margin "
          f"{widest:.2f}{msg}", flush=True)
    if not torch.equal(picks[checked].long(), want_picks[checked].long()):
        raise CheckFailed(f"{name}: a pick is not the teacher-forced argmax")
    if int(checked.sum()) < int(live.sum()) // 2:
        raise CheckFailed(f"{name}: fewer than half the live steps were "
                          "checked")
