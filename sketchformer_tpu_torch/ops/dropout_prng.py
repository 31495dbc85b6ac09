"""In-kernel dropout: a Philox generator the training kernels draw from.

Port of ``sketchformer_tpu/ops/pallas_dropout.py`` (K7). The TPU stacks draw
their dropout bytes inside the kernels from the chip's hardware PRNG, so the
(L * nsites, B, T, d) byte tensor of the 'bits' mode never exists: at the
JAX benchmark's ``train`` shape that tensor is about 500 MB a step, written
once and read by every kernel of each site. The card has no hardware PRNG a
kernel can seed, so the kernels compute a counter-based generator instead,
Philox-4x32-10 (``csrc/dropout_prng.cuh``). Its streams are not the TPU's,
and need not be: the requirement (``pallas_dropout.py:1-35``) is that the
forward, the recompute and the backward kernels regenerate the same byte
for the same element whatever their tiling. The byte of element (row
m = b * T + t, column c) of site k of a layer is byte k of

    word(seed, layer * LAYER_STRIDE + b, t * d + c)
      = Philox4x32-10(key = seed, counter = (idx >> 2, stream, 0, 0))[idx & 3]

with idx = t * d + c. The same draw in plain torch (uint32 arithmetic in
int64 tensors) is here too, and gives the same bytes on any device.

- :class:`PrngSite` names one site drawn in-kernel. The kernel wrappers of
  the training stacks (``linear``, ``linear_nt``, ``linear_tn``,
  ``sum_rows``) take it in place of a byte tensor: on a CUDA tensor the
  kernel draws the bytes itself; on the CPU, and in every plain version,
  :func:`site_bytes_reference` materialises the site's bytes and the bits
  path runs.
- :func:`emit_dropout_bits` writes the same bytes out in the JAX layout,
  ``(num_layers * nsites, B, T, d)`` u8 with site s = layer * nsites + k: a
  kernel on the card (``csrc/dropout_prng.cu``), the plain Philox on the
  CPU. A 'prng' stack equals the 'bits' stack fed these bytes, bit for bit.
  The composed dropout sites (``models/dropout.py``) draw their bytes with
  it on the card.

``LAUNCHES["emit_dropout_bits"]`` counts the emit kernel's launches;
``LAUNCHES["prng_draw"]`` counts launches of training kernels that drew a
site in-kernel (each also counts under its own kernel's name).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sketchformer_tpu_torch.ops import _build

# distinct (layer, batch row) streams: layer * LAYER_STRIDE + b is injective
# for batches below 2^20 rows (pallas_dropout.py)
LAYER_STRIDE = 1 << 20
MAX_SITES = 4            # one 32-bit word serves up to four sites a layer

LAUNCHES = {"emit_dropout_bits": 0, "prng_draw": 0}

_M0, _M1 = 0xD2511F53, 0xCD9E8D57     # Philox-4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85     # Weyl key increments
_MASK = 0xFFFFFFFF


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PrngSite(NamedTuple):
    """One dropout site drawn in-kernel: byte ``site`` of the words of
    layer ``layer`` under ``seed`` (64-bit), rows m = b * T + t."""

    seed: int
    layer: int
    site: int
    T: int


class PrngDrop(NamedTuple):
    """A stack's dropout in 'prng' mode: every site's bytes come from
    ``seed``; :meth:`site` names one of them."""

    seed: int
    T: int

    def site(self, layer: int, k: int) -> PrngSite:
        return PrngSite(self.seed, layer, k, self.T)


def resolve_impl(dropout_impl: str, device) -> str:
    """'auto' -> 'prng' for a CUDA tensor, 'bits' otherwise (a stack on the
    CPU runs its plain versions, which read bytes either way)."""
    if dropout_impl == "auto":
        return "prng" if torch.device(device).type == "cuda" else "bits"
    if dropout_impl not in ("bits", "prng"):
        raise ValueError(f"unknown dropout_impl {dropout_impl!r}")
    return dropout_impl


# ---------------------------------------------------------------------------
# the plain Philox
# ---------------------------------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit halves of the 64-bit product of the constant ``a``
    and the uint32 values of the int64 tensor ``b``, without overflow."""
    p_lo = a * (b & 0xFFFF)                 # < 2^48
    p_hi = a * (b >> 16)                    # < 2^48
    low = (p_lo & _MASK) + ((p_hi & 0xFFFF) << 16)
    return (p_lo >> 32) + (p_hi >> 16) + (low >> 32), low & _MASK


def philox4x32_10(c0, c1, c2, c3, seed: int):
    """Philox-4x32-10 of the counters (uint32 values in int64 tensors,
    broadcast together) under the 64-bit key ``seed``: four int64 tensors
    of uint32 words."""
    k0, k1 = seed & _MASK, (seed >> 32) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def words_reference(seed: int, streams: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) int64 tensor of the uint32 words of positions 0 .. n-1 of each
    of the S ``streams`` (int64)."""
    groups = torch.arange((n + 3) // 4, dtype=torch.int64,
                          device=streams.device)
    c1 = streams.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=streams.device)
    w = philox4x32_10(groups[None, :], c1, zero, zero, seed)
    return torch.stack([x.expand(c1.shape[0], -1) for x in w],
                       dim=-1).reshape(c1.shape[0], -1)[:, :n]


def _bytes(words: torch.Tensor, k: int) -> torch.Tensor:
    return ((words >> (8 * k)) & 255).to(torch.uint8)


def site_bytes_reference(site: PrngSite, M: int, N: int,
                         device) -> torch.Tensor:
    """The (M, N) u8 bytes of one site as the kernels draw them."""
    if M % site.T:
        raise ValueError(f"{M} rows are not whole batch rows of T={site.T}")
    B = M // site.T
    streams = site.layer * LAYER_STRIDE + torch.arange(
        B, dtype=torch.int64, device=device)
    return _bytes(words_reference(site.seed, streams, site.T * N),
                  site.site).reshape(M, N)


def as_bytes(drop, M: int, N: int, device) -> Optional[torch.Tensor]:
    """A dropout operand (None, (M, N) u8 bytes or a :class:`PrngSite`) as
    bytes: what the plain versions read."""
    if isinstance(drop, PrngSite):
        return site_bytes_reference(drop, M, N, device)
    return drop


def emit_dropout_bits_reference(seed: int, num_layers: int, nsites: int,
                                B: int, T: int, d: int,
                                device="cpu") -> torch.Tensor:
    """:func:`emit_dropout_bits` in plain torch (one layer at a time)."""
    _check_sites(nsites)
    out = torch.empty((num_layers, nsites, B, T * d), dtype=torch.uint8,
                      device=device)
    rows = torch.arange(B, dtype=torch.int64, device=device)
    for li in range(num_layers):
        words = words_reference(seed, li * LAYER_STRIDE + rows, T * d)
        for k in range(nsites):
            out[li, k] = _bytes(words, k)
    return out.reshape(num_layers * nsites, B, T, d)


def _check_sites(nsites):
    if not 1 <= nsites <= MAX_SITES:
        raise ValueError(f"nsites {nsites} outside 1..{MAX_SITES}")


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def emit_dropout_bits(seed: int, num_layers: int, nsites: int, B: int,
                      T: int, d: int, device="cpu") -> torch.Tensor:
    """The bytes every 'prng' site of a stack draws, as a (num_layers *
    nsites, B, T, d) u8 tensor on ``device``: site s = layer * nsites + k.
    A CUDA device launches the kernel; the CPU runs the plain Philox."""
    device = torch.device(device)
    if device.type == "cpu":
        return emit_dropout_bits_reference(seed, num_layers, nsites, B, T, d,
                                           device)
    if device.type != "cuda":
        raise ValueError(f"emit_dropout_bits: unsupported device {device}")
    _check_sites(nsites)
    if not (0 < B < min(LAYER_STRIDE, 65536) and 0 < num_layers < 65536):
        raise ValueError(f"emit_dropout_bits: B={B}, num_layers={num_layers}")
    out = torch.empty((num_layers * nsites, B, T, d), dtype=torch.uint8,
                      device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.sk_emit_dropout_bits(
            seed & 0xFFFFFFFFFFFFFFFF, _build.ptr(out), num_layers, nsites, B,
            T * d, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "emit_dropout_bits")
    LAUNCHES["emit_dropout_bits"] += 1
    return out


def kernel_args(drop, M: int, N: int, dev):
    """The dropout operand of a training kernel's C entry point: (bytes
    tensor or None, seed, layer, site, T); T > 0 draws in-kernel."""
    if isinstance(drop, PrngSite):
        if drop.T <= 0 or M % drop.T:
            raise ValueError(f"{M} rows are not whole batch rows of "
                             f"T={drop.T}")
        if N % 4:
            raise ValueError(f"in-kernel dropout needs a row width that is "
                             f"a multiple of 4, got {N}")
        if not 0 <= drop.site < MAX_SITES:
            raise ValueError(f"site {drop.site} outside 0..{MAX_SITES - 1}")
        if M // drop.T >= LAYER_STRIDE:
            raise ValueError(f"{M // drop.T} batch rows exceed the stream "
                             f"stride {LAYER_STRIDE}")
        return None, drop.seed & 0xFFFFFFFFFFFFFFFF, drop.layer, drop.site, \
            drop.T
    if drop is not None:
        _build.require(drop, "drop", dev, torch.uint8, (M, N))
    return drop, 0, 0, 0, 0


def note_launch(drop) -> None:
    """Count a launched training kernel that drew its site in-kernel."""
    if isinstance(drop, PrngSite):
        LAUNCHES["prng_draw"] += 1
