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
place by multi-tensor ops. Under a profiler (``utils/trace.py``) the read
of the norm is the span ``train.guard`` and the update ``train.update``.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from sketchformer_tpu_torch.utils.trace import span


def noam_schedule(d_model: int, warmup_steps: int = 4000,
                  peak_scale: float = 1.0) -> Callable[[int], float]:
    """The Noam rate as a function of the step count, in f32:
    peak_scale * d_model^-0.5 * min(step^-0.5, step * warmup^-1.5), the
    step clamped to >= 1 (reference: models/sketchformer.py
    ``CustomSchedule``)."""

    def schedule(count: int) -> float:
        step = torch.tensor(max(float(count), 1.0), dtype=torch.float32)
        return float(peak_scale * d_model ** -0.5 * torch.minimum(
            step ** -0.5, step * warmup_steps ** -1.5))

    return schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    a 0-d f32 tensor."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(tensors)))


class NoamAdam:
    """Clip-by-global-norm + Adam with the Noam schedule (the reference
    optimizer), as multi-tensor (``torch._foreach``) updates of the
    parameters in place. ``state_dict`` / ``load_state_dict`` keep the step
    count and the f32 moments."""

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
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor], grad_norm: torch.Tensor) -> bool:
        """One update from ``grads`` (f32, one per parameter) and their
        global norm. An update whose norm is not finite is skipped, leaving
        parameters, moments and count as they were (the norm is read on the
        host). Returns whether it was applied."""
        with span("train.guard"):
            finite = bool(torch.isfinite(grad_norm))
        if not finite:
            return False
        with span("train.update"):
            lr = self.rate(self.count)
            self.count += 1
            clip = self.clip_norm
            g = [torch.where(grad_norm < clip, t, t / grad_norm * clip)
                 for t in grads]
            torch._foreach_mul_(self.mu, self.b1)
            torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - self.b1))
            torch._foreach_mul_(self.nu, self.b2)
            torch._foreach_add_(self.nu, torch._foreach_mul(
                torch._foreach_mul(g, g), 1.0 - self.b2))
            m_hat = torch._foreach_div(self.mu, 1.0 - self.b1 ** self.count)
            v_hat = torch._foreach_div(self.nu, 1.0 - self.b2 ** self.count)
            denom = torch._foreach_add(torch._foreach_sqrt(v_hat), self.eps)
            torch._foreach_add_(self.params, torch._foreach_div(m_hat, denom),
                                alpha=-lr)
        return True

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
