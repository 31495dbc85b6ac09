"""The optimizer: global-norm clipping, then Adam with the Noam rate.

Port of ``sketchformer_tpu/train/schedule.py``, written as explicit tensor
updates equal to ``optax.chain(optax.clip_by_global_norm(clip),
optax.adam(noam_schedule(...), b1, b2, eps))``:

- clip: g <- g / |g| * clip where |g| >= clip, |g| the global L2 norm;
- Adam: m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2, the bias
  corrections use the count after the increment, and the update is
  -lr * m_hat / (sqrt(v_hat) + eps);
- the rate reads the count BEFORE the increment (optax's
  ``scale_by_learning_rate``), and Noam clamps the step to >= 1.

All state is f32 and lives beside the parameters, which are updated in
place; the step count lives there too, so the norm, the non-finite guard,
the rate and the update run on the device without a host read. On the card
they are the multi-tensor kernels of ``ops/optimizer.py`` (three launches
a step; CUDA tensors they cannot take raise); on the CPU the same
arithmetic in plain torch. Under a profiler (``utils/trace.py``) the update
is the span ``train.update``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from sketchformer_tpu_torch.ops import optimizer
from sketchformer_tpu_torch.utils.engines import note_engine
from sketchformer_tpu_torch.utils.trace import span


def noam_schedule(d_model: int, warmup_steps: int = 4000,
                  peak_scale: float = 1.0) -> Callable[[int], float]:
    """The Noam rate as a function of the step count, in f32:
    peak_scale * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5), the
    step clamped to >= 1 (``ops/optimizer.py::noam_rate``, which the
    update computes on the device)."""

    def schedule(count: int) -> float:
        step = torch.tensor(max(float(count), 1.0), dtype=torch.float32)
        return float(optimizer.noam_rate(step, peak_scale * d_model ** -0.5,
                                         warmup_steps ** -1.5))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    a 0-d f32 tensor on the tensors' device: one kernel launch on the card
    (``ops/optimizer.py::global_norm``)."""
    if tensors and tensors[0].device.type == "cuda":
        return optimizer.global_norm(
            optimizer.tensor_table(tensors[0].device, tensors))
    return optimizer.global_norm_reference(tensors)


class NoamAdam:
    """Clip-by-global-norm + Adam with the Noam schedule (the reference
    optimizer), updating the parameters in place. The step count lives on
    the parameters' device; ``count`` reads it as an ``int`` (a host read)
    and sets it. ``state_dict`` / ``load_state_dict`` keep the count (an
    ``int``) and the f32 moments."""

    def __init__(self, params: List[torch.Tensor], d_model: int,
                 warmup_steps: int = 4000, peak_scale: float = 1.0,
                 beta1: float = 0.9, beta2: float = 0.98, eps: float = 1e-9,
                 clip_norm: float = 1.0) -> None:
        self.params = list(params)
        if any(p.dtype != torch.float32 for p in self.params):
            raise TypeError("NoamAdam keeps f32 parameters, as flax does")
        self.rate = noam_schedule(d_model, warmup_steps, peak_scale)
        self.b1, self.b2, self.eps = beta1, beta2, eps
        self.clip_norm = clip_norm
        self._rate_args = dict(rate_scale=peak_scale * d_model ** -0.5,
                               rate_warm=warmup_steps ** -1.5)
        dev = self.params[0].device if self.params else torch.device("cpu")
        self._count = torch.zeros((), dtype=torch.int64, device=dev)
        self._scalars = torch.zeros(optimizer.SCALARS, dtype=torch.float32,
                                    device=dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @property
    def count(self) -> int:
        """The updates applied so far (read from the device)."""
        return int(self._count)

    @count.setter
    def count(self, value: int) -> None:
        self._count.fill_(int(value))

    def hyper(self) -> Dict:
        """The update's settings as ``ops/optimizer.py`` takes them."""
        return dict(clip=self.clip_norm, b1=self.b1, b2=self.b2, eps=self.eps,
                    **self._rate_args)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor],
             grad_norm: torch.Tensor) -> torch.Tensor:
        """One update from ``grads`` (f32, one per parameter) and their
        global norm, on the device and without a host read. An update
        whose norm is not finite is skipped, leaving parameters, moments
        and count as they were. Returns a 0-d f32 tensor on the device, 1
        where the update applied, else 0. On the card, tensors the kernels
        cannot take (``ops/optimizer.py::tensor_table``) raise."""
        hyper = self.hyper()
        with span("train.update"):
            dev = self._count.device
            if dev.type == "cuda":
                table = optimizer.tensor_table(dev, grads, self.params,
                                               self.mu, self.nu)
                note_engine("train-update", "kernels")
                return optimizer.adam_update(
                    table, grad_norm, self._count, self._scalars, **hyper)
            return optimizer.adam_update_reference(
                self.params, grads, self.mu, self.nu, grad_norm, self._count,
                **hyper)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        for dst, src in zip(self.mu, state["mu"]):
            dst.copy_(src)
        for dst, src in zip(self.nu, state["nu"]):
            dst.copy_(src)


def make_optimizer(params: List[torch.Tensor], d_model: int,
                   warmup_steps: int = 4000, peak_scale: float = 1.0,
                   beta1: float = 0.9, beta2: float = 0.98, eps: float = 1e-9,
                   clip_norm: float = 1.0) -> NoamAdam:
    """Adam with Noam warmup + global-norm clipping (the reference
    optimizer), with the JAX package's defaults. Its signature differs from
    the JAX ``make_optimizer`` only by ``params``: an optax transformation
    is stateless and takes the parameters at each update, while this
    optimizer keeps its moments beside the parameters it updates."""
    return NoamAdam(params, d_model, warmup_steps=warmup_steps,
                    peak_scale=peak_scale, beta1=beta1, beta2=beta2, eps=eps,
                    clip_norm=clip_norm)
