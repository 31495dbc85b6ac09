"""The optimizer step on hand-written multi-tensor kernels.

Kernels of ``csrc/optimizer.cu``, with a plain torch version beside each
wrapper (``*_reference``). They replace no TPU kernel: the JAX package's
optax chain (global-norm clip, Adam at the Noam rate) and its non-finite
guard compile under jit into XLA's fused loops, with the guard a select on
the device. Eagerly on the card the same step took a launch or four a
parameter tensor and a chain of multi-tensor ops, queued only after the
host had read whether the norm was finite. Here it is three launches and
no host read:

- :func:`global_norm`: one launch over every tensor; blocks take fixed
  chunks of the tensors' concatenated elements, sum the squares in f64,
  and the last block adds the blocks' partials in a fixed order into the
  f32 norm (bit-stable re-runs);
- :func:`adam_update`: a one-thread launch that computes, from the norm
  and the step count on the device, the finite flag, the Noam rate of the
  count before the increment, the bias corrections of the count after it,
  the applied flag and the increment (when finite); then one launch over
  every (param, grad, mu, nu) quadruple that applies the clip and the Adam
  update in f32, every rounding where :func:`adam_update_reference` has
  it, or returns at once where the norm was not finite.

The tensors' pointers travel in the kernels' parameters (a
:class:`TensorTable`, at most ``MAX_TENSORS`` a launch; a longer list
takes more launches), so no table is copied to the card. Both kernels are
bound by memory: the norm reads 4 bytes an element, the update 16 and
writes 12. The wrappers take a table of CUDA tensors (:func:`tensor_table`
builds it, and raises for tensors the kernels cannot take) and launch;
the callers (``train/schedule.py``) take the plain versions for CPU
tensors alone.

The guard skips the steps optax skips: the norm reads inf where the sum
of squares overflows f32 (optax sums the squares in f32), although the
kernel sums them in f64.

``LAUNCHES`` counts kernel launches per kernel.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from sketchformer_tpu_torch.ops import _build

LAUNCHES = {"global_sumsq": 0, "adam_prepare": 0, "adam_update": 0}
MAX_TENSORS = 512      # tensors a launch (csrc/optimizer.cu kMaxTensors)
CHUNK = 4096           # elements a chunk of the concatenated space (kChunk)
NORM_BLOCKS_AN_SM = 4  # global_sumsq's grid, at most
SCALARS = 4            # the update's device scalars: flag, lr, bc1, bc2


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def noam_rate(step: torch.Tensor, scale: float, warm: float) -> torch.Tensor:
    """The Noam rate of f32 ``step`` (clamped to >= 1 by the caller), in
    f32: ``scale * min(step^-0.5, step * warm)`` with ``scale`` = peak_scale
    * d_model^-0.5 and ``warm`` = warmup_steps^-1.5 (reference:
    models/sketchformer.py ``CustomSchedule``)."""
    return scale * torch.minimum(step ** -0.5, step * warm)


class TensorTable:
    """Parallel lists of f32 tensors on one card as the kernels take them:
    one array of data pointers a list and the lists' start offsets in the
    concatenated element space (``starts[n]`` the elements of all)."""

    def __init__(self, device: torch.device, numels: Sequence[int],
                 *pointers: Sequence[int]) -> None:
        self.device, self.numels, self.n = device, list(numels), len(numels)
        starts = [0]
        for k in numels:
            starts.append(starts[-1] + k)
        self.total = starts[-1]
        self.starts = (ctypes.c_longlong * (self.n + 1))(*starts)
        self.pointers = [(ctypes.c_void_p * self.n)(*p) for p in pointers]

    def groups(self):
        """(n, pointer arrays, starts) of each launch: at most
        MAX_TENSORS tensors, their arrays as addresses into this table's
        (the kernels take a group's starts from its first)."""
        for i in range(0, self.n, MAX_TENSORS):
            n = min(MAX_TENSORS, self.n - i)
            yield (n, [ctypes.addressof(a) + 8 * i for a in self.pointers],
                   ctypes.addressof(self.starts) + 8 * i,
                   self.starts[i + n] - self.starts[i])


def tensor_table(device: torch.device, *lists: Sequence[torch.Tensor]
                 ) -> TensorTable:
    """The kernels' table of parallel lists of tensors on ``device``:
    f32, contiguous, the lists' tensors of equal sizes in turn. Raises
    where they are not."""
    numels, pointers = None, []
    for tensors in lists:
        if not tensors:
            raise ValueError("the optimizer kernels take no empty list")
        info = [(t.get_device(), t.dtype, t.is_contiguous(), t.numel(),
                 t.data_ptr()) for t in tensors]
        devs, dtypes, contiguous, sizes, ptrs = zip(*info)
        if set(devs) != {device.index}:
            raise ValueError(f"the optimizer kernels take tensors on "
                             f"{device} alone")
        if set(dtypes) != {torch.float32}:
            raise TypeError(f"the optimizer kernels take float32 tensors, "
                            f"not {sorted(map(str, set(dtypes)))}")
        if not all(contiguous):
            raise ValueError("the optimizer kernels take contiguous tensors")
        if numels is None:
            numels = list(sizes)
        elif numels != list(sizes):
            raise ValueError("the optimizer kernels' lists differ in their "
                             "tensors' sizes")
        pointers.append(ptrs)
    return TensorTable(device, numels, *pointers)


def norm_blocks(elements: int, sms: int) -> int:
    """``global_sumsq``'s grid over ``elements``: one block a chunk, at
    most NORM_BLOCKS_AN_SM an SM (each block walks its chunks in turn)."""
    return max(1, min(-(-elements // CHUNK), NORM_BLOCKS_AN_SM * sms))


def global_norm_reference(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    a 0-d f32 tensor: inf where that sum overflows f32, as optax's does."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))
    square = norm * norm
    return torch.where(torch.isfinite(square), norm, square)


def global_norm(table: TensorTable) -> torch.Tensor:
    """:func:`global_norm_reference` of ``table``'s first list: one
    ``global_sumsq`` launch a MAX_TENSORS tensors; a new 0-d f32 tensor
    on the card."""
    dev = table.device
    groups = list(table.groups())
    blocks = [norm_blocks(total, _build.sm_count(dev))
              for *_, total in groups]
    parts = sum(blocks)
    ticket, ws = _build.split_scratch(dev, 1, 2 * parts)  # f64 partials
    norm = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.library()
    base = 0
    with torch.cuda.device(dev):
        for i, ((n, (g,), starts, _), b) in enumerate(zip(groups, blocks)):
            err = lib.sk_global_sumsq(
                n, g, starts, b, _build.ptr(ws), base, parts,
                _build.ptr(ticket), _build.ptr(norm),
                int(i == len(groups) - 1), _build.stream(norm))
            _build.check(err, "global_sumsq")
            LAUNCHES["global_sumsq"] += 1
            base += b
    return norm


def rate_scalars(count: torch.Tensor, b1: float, b2: float,
                 rate_scale: float, rate_warm: float):
    """(lr, bc1, bc2) on the device, as f32: the Noam rate of the count
    before the increment, the bias corrections 1 - b^count of the count
    after it (f64 powers rounded to f32)."""
    lr = noam_rate(count.clamp_min(1).float(), rate_scale, rate_warm)
    after = (count + 1).double()
    return (lr, (1.0 - torch.pow(b1, after)).float(),
            (1.0 - torch.pow(b2, after)).float())


@torch.no_grad()
def adam_update_reference(params, grads, mu, nu, grad_norm: torch.Tensor,
                          count: torch.Tensor, *, clip: float, b1: float,
                          b2: float, eps: float, rate_scale: float,
                          rate_warm: float) -> torch.Tensor:
    """The plain update, in place and under the guard without a host read:
    where ``grad_norm`` is finite, g <- g / |g| * clip where |g| >= clip,
    then Adam (moments at b1, b2; the bias corrections at the count after
    the increment; -lr m_hat / (sqrt(v_hat) + eps) at the Noam rate of the
    count before it) and ``count`` + 1; else nothing changes. Returns a 0-d
    f32 tensor, 1 where the update applied."""
    finite = torch.isfinite(grad_norm)
    lr, bc1, bc2 = rate_scalars(count, b1, b2, rate_scale, rate_warm)
    g = [torch.where(grad_norm < clip, t, t / grad_norm * clip)
         for t in grads]
    m = torch._foreach_add(torch._foreach_mul(mu, b1),
                           torch._foreach_mul(g, 1.0 - b1))
    v = torch._foreach_add(torch._foreach_mul(nu, b2), torch._foreach_mul(
        torch._foreach_mul(g, g), 1.0 - b2))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(v, bc2)),
                             eps)
    p = torch._foreach_add(params, torch._foreach_mul(
        torch._foreach_div(torch._foreach_div(m, bc1), den), -lr))
    for dst, new in zip((*params, *mu, *nu), (*p, *m, *v)):
        dst.copy_(torch.where(finite, new, dst))
    count.add_(finite)
    return finite.float()


def adam_update(table: TensorTable, grad_norm: torch.Tensor,
                count: torch.Tensor, scalars: torch.Tensor, *, clip: float,
                b1: float, b2: float, eps: float, rate_scale: float,
                rate_warm: float) -> torch.Tensor:
    """:func:`adam_update_reference` on ``table``'s (grad, param, mu, nu)
    lists, in their order: one ``adam_prepare`` launch (``count``, an int64
    on the card, and ``scalars``, SCALARS f32 of scratch), then one
    ``adam_update`` launch a MAX_TENSORS quadruples. ``grad_norm`` is a
    0-d f32 tensor on the card. Returns the applied flag (a new 0-d f32
    tensor)."""
    dev = table.device
    for t, name, dtype, shape in ((grad_norm, "grad_norm", torch.float32, ()),
                                  (count, "count", torch.int64, ()),
                                  (scalars, "scalars", torch.float32,
                                   (SCALARS,))):
        _build.require(t, name, dev, dtype, shape)
    applied = torch.empty((), dtype=torch.float32, device=dev)
    lib = _build.library()
    stream = _build.stream(applied)
    with torch.cuda.device(dev):
        err = lib.sk_adam_prepare(
            _build.ptr(grad_norm), _build.ptr(count), _build.ptr(scalars),
            _build.ptr(applied), rate_scale, rate_warm, b1, b2, stream)
        _build.check(err, "adam_prepare")
        LAUNCHES["adam_prepare"] += 1
        for n, (g, p, m, v), starts, _ in table.groups():
            err = lib.sk_adam_update(
                n, g, p, m, v, starts, _build.ptr(grad_norm),
                _build.ptr(scalars), clip, b1, 1.0 - b1, b2, 1.0 - b2, eps,
                stream)
            _build.check(err, "adam_update")
            LAUNCHES["adam_update"] += 1
    return applied
