"""Model FLOPs utilisation of a cell: the model FLOPs of each traced unit
over the traced window's time and the H100's dense bf16 peak. A unit's
FLOPs follow the cell's path (``work.py``): a batch's encoder and
bottleneck (embed); a request's encoder, memory and greedy steps (decode);
three forward passes of a training step's model, the fused stacks'
recompute not counted (train)."""

from perfbench import work


def _embed(ctx, u):
    return work.encoder_flops(ctx.cfg, ctx.traffic["seq_len"], u["keys"])


def _decode(ctx, u):
    return work.decode_request_flops(ctx.cfg, ctx.traffic["seq_len"],
                                     u["keys"], ctx.traffic["decode_len"])


def _train(ctx, u):
    return work.train_step_flops(ctx.cfg, ctx.traffic["seq_len"], u["keys"],
                                 u["dec_keys"])


UNIT_FLOPS = {"embed": _embed, "decode": _decode, "train": _train}


def read(ctx):
    t = ctx.trace
    if t is None or not t.busy_s:
        return None
    flops = sum(UNIT_FLOPS[ctx.traffic["path"]](ctx, u) for u in ctx.traced)
    return 100.0 * flops / t.window_s / work.PEAK_BF16
