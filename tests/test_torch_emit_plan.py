"""K7's emit kernel: its persistent grid and walk
(``ops/dropout_prng.py::emit_plan``), emulated in plain torch.

Nothing here launches a kernel. The emulation follows
``csrc/dropout_prng.cu::emit_dropout_bits_kernel`` step by step: each
thread's first (layer, b, run) item by division, then the grid stride by
additions and two carries; an item's four Philox calls; byte k of their 16
words packed as the kernel's ``__byte_perm`` does; one 16-byte store a site,
or byte stores (the ``bytes`` route) where a row's length is not a multiple
of 16 or the output is off a 16-byte boundary. The walk must visit every
item once and cover every byte once, and the emulated bytes must equal
``emit_dropout_bits_reference`` bit for bit.
"""

import pytest
import torch

from sketchformer_tpu_torch.ops import dropout_prng as dp

SEED = 0x1234_5678_9ABC_DEF0
H100 = (132, 8)          # SMs, resident emit blocks an SM (256 threads)


def walk(plan, num_layers, B):
    """The items of every thread, as the kernel visits them: a (threads,
    iterations) int64 tensor of item indices, -1 past the last."""
    g = torch.arange(plan["stride"], dtype=torch.int64)
    runs = plan["runs"]
    run, row = g % runs, g // runs
    layer, b = row // B, row % B
    cols = []
    while bool((layer < num_layers).any()):
        cols.append(torch.where(layer < num_layers,
                                (layer * B + b) * runs + run, -1))
        run = run + plan["dr"]
        b = b + plan["db"]
        layer = layer + plan["dl"]
        carry = run >= runs
        run = torch.where(carry, run - runs, run)
        b = torch.where(carry, b + 1, b)
        carry = b >= B
        b = torch.where(carry, b - B, b)
        layer = torch.where(carry, layer + 1, layer)
    return torch.stack(cols, 1)


def byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 values held in int64 tensors: byte i
    of the result is byte (sel >> 4i) & 7 of the 8 bytes y:x."""
    both = (y << 32) | x
    out = torch.zeros_like(x)
    for i in range(4):
        n = (sel >> (4 * i)) & 7
        out |= ((both >> (8 * n)) & 255) << (8 * i)
    return out


def emulate(num_layers, nsites, B, T, d, fit, offset=0):
    """The bytes the kernel writes, its route and the walk."""
    TD = T * d
    plan = dp.emit_plan(num_layers, B, TD, *fit)
    items = walk(plan, num_layers, B)
    runs = plan["runs"]
    vec = TD % dp.EMIT_RUN == 0 and offset % 16 == 0
    live = items[items >= 0]
    run, row = live % runs, live // runs
    layer, b = row // B, row % B
    stream = layer * dp.LAYER_STRIDE + b
    zero = torch.zeros((), dtype=torch.int64)
    w = [dp.philox4x32_10(4 * run + j, stream, zero, zero, SEED)
         for j in range(4)]
    buf = torch.full((offset + num_layers * nsites * B * TD,), 7,
                     dtype=torch.uint8)
    for k in range(nsites):
        sel = k | (k + 4) << 4
        words = [byte_perm(byte_perm(c[0], c[1], sel),
                           byte_perm(c[2], c[3], sel), 0x5410) for c in w]
        base = offset + ((layer * nsites + k) * B + b) * TD + 16 * run
        for e in range(dp.EMIT_RUN):
            keep = 16 * run + e < TD
            val = (words[e // 4] >> (8 * (e % 4))) & 255
            buf[base[keep] + e] = val[keep].to(torch.uint8)
    return buf[offset:].view(num_layers * nsites, B, T, d), vec, plan, items


@pytest.mark.parametrize("shape,fit", [
    ((1, 1, 256, 192, 256), H100),          # pretrain_full's site
    ((1, 1, 64, 192, 512), H100),           # a post-LN FFN site
    ((2, 3, 7, 1000, 1), (1, 1)),           # a stride that wraps runs
    ((40, 2, 3, 7, 10), (1, 1)),            # ... and layers: TD = 4k + 2
    ((3, 4, 5, 1, 10), H100),               # TD = 10
])
def test_walk_covers_every_item_once(shape, fit):
    num_layers, nsites, B, T, d = shape
    plan = dp.emit_plan(num_layers, B, T * d, *fit)
    assert plan["grid"] <= fit[0] * fit[1]
    assert plan["stride"] == plan["grid"] * dp.EMIT_THREADS
    assert plan["items"] == num_layers * B * -(-T * d // 16)
    items = walk(plan, num_layers, B)
    # the walk is the grid stride: thread g's items g, g + stride, ...
    g = torch.arange(plan["stride"])[:, None]
    it = torch.arange(items.shape[1])[None, :]
    want = g + it * plan["stride"]
    assert torch.equal(items, torch.where(want < plan["items"], want, -1))
    live = items[items >= 0]
    assert torch.equal(live.sort().values, torch.arange(plan["items"]))


@pytest.mark.parametrize("shape,fit,offset", [
    ((1, 1, 256, 192, 256), H100, 0),       # the main-path site, vec16
    ((2, 2, 16, 96, 16), (1, 1), 0),        # wrapped walk, vec16
    ((3, 3, 5, 7, 10), H100, 0),            # TD = 70 = 4k + 2, bytes
    ((1, 1, 3, 1, 10), H100, 0),            # TD = 10, bytes
    ((2, 2, 7, 4, 8), (1, 1), 3),           # TD = 32, the base 3 bytes off
    ((40, 2, 3, 7, 10), (1, 1), 0),         # layers wrap, bytes
])
def test_emulated_emit_equals_the_plain_philox(shape, fit, offset):
    num_layers, nsites, B, T, d = shape
    got, vec, _, _ = emulate(num_layers, nsites, B, T, d, fit, offset)
    assert vec == ((T * d) % 16 == 0 and offset == 0)
    want = dp.emit_dropout_bits_reference(SEED, num_layers, nsites, B, T, d)
    assert torch.equal(got, want)


def test_emulated_bytes_cover_every_byte_once():
    """Each item's byte range, [16 run, 16 run + 16) of its row clipped to
    TD, for every site: together every byte of the tensor once."""
    num_layers, nsites, B, T, d = 3, 2, 5, 7, 10
    TD = T * d
    plan = dp.emit_plan(num_layers, B, TD, 1, 1)
    items = walk(plan, num_layers, B)
    live = items[items >= 0]
    count = torch.zeros(num_layers * nsites * B * TD, dtype=torch.int64)
    run, row = live % plan["runs"], live // plan["runs"]
    layer, b = row // B, row % B
    for k in range(nsites):
        base = ((layer * nsites + k) * B + b) * TD
        for e in range(16):
            keep = 16 * run + e < TD
            count.index_add_(0, (base + 16 * run + e)[keep],
                             torch.ones(int(keep.sum()), dtype=torch.int64))
    assert bool((count == 1).all())


def test_cpu_emit_counts_no_route():
    dp.reset_launches()
    got = dp.emit_dropout_bits(SEED, 1, 2, 3, 4, 5, "cpu")
    assert torch.equal(got, dp.emit_dropout_bits_reference(SEED, 1, 2, 3, 4,
                                                           5))
    assert dp.ROUTES == {"vec16": 0, "bytes": 0}
    assert dp.LAUNCHES["emit_dropout_bits"] == 0
