"""Mixture-density head math for decoding: split the raw head output, sample.

Port of ``split_params`` and ``sample`` from ``sketchformer_tpu/ops/mdn.py``
(the loss functions come with the training slice). Everything runs in f32.
Layout of a raw head output (``6*M + 3`` features)::

    [pi_logits(M) | mu_x(M) | mu_y(M) | log_sigma_x(M) | log_sigma_y(M)
     | rho_raw(M) | pen_logits(3)]

Sampling draws from a ``torch.Generator``, so its streams differ from
``jax.random``'s; greedy decoding draws nothing and matches exactly.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

LOG_SIGMA_MIN = -6.0
LOG_SIGMA_MAX = 4.0
RHO_MAX = 0.99


class MDNParams(NamedTuple):
    log_pi: torch.Tensor      # (..., M) log mixture weights (normalized)
    mu: torch.Tensor          # (..., M, 2)
    log_sigma: torch.Tensor   # (..., M, 2) clamped
    rho: torch.Tensor         # (..., M) in (-RHO_MAX, RHO_MAX)
    pen_logits: torch.Tensor  # (..., 3)


def split_params(raw: torch.Tensor, num_mixtures: int) -> MDNParams:
    raw = raw.float()
    M = num_mixtures
    if raw.shape[-1] != 6 * M + 3:
        raise ValueError(f"expected {6 * M + 3} features, got {raw.shape[-1]}")
    mu = torch.stack([raw[..., M:2 * M], raw[..., 2 * M:3 * M]], dim=-1)
    log_sigma = torch.stack([raw[..., 3 * M:4 * M], raw[..., 4 * M:5 * M]],
                            dim=-1).clamp(LOG_SIGMA_MIN, LOG_SIGMA_MAX)
    return MDNParams(
        log_pi=torch.log_softmax(raw[..., :M], dim=-1),
        mu=mu,
        log_sigma=log_sigma,
        rho=RHO_MAX * torch.tanh(raw[..., 5 * M:6 * M]),
        pen_logits=raw[..., 6 * M:],
    )


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``logits`` (Gumbel-max, as jax.random does)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return (logits + gumbel).argmax(dim=-1)


def sample(params: MDNParams, generator: Optional[torch.Generator] = None,
           temperature: float = 1.0,
           greedy: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw ((..., 2) xy, (...) pen class) from the mixture.

    ``greedy`` takes the argmax component's mean and the argmax pen state
    (the deterministic reconstruction) and draws nothing.
    """
    if greedy:
        comp = params.log_pi.argmax(dim=-1)
        pen = params.pen_logits.argmax(dim=-1)
        idx = comp[..., None, None].expand(*comp.shape, 1, 2)
        return params.mu.gather(-2, idx)[..., 0, :], pen
    t = max(temperature, 1e-6)
    comp = _categorical(params.log_pi / t, generator)
    idx2 = comp[..., None, None].expand(*comp.shape, 1, 2)
    mu = params.mu.gather(-2, idx2)[..., 0, :]
    log_sigma = params.log_sigma.gather(-2, idx2)[..., 0, :]
    rho = params.rho.gather(-1, comp[..., None])[..., 0]
    sigma = torch.exp(log_sigma) * t ** 0.5
    eps = torch.randn(mu.shape, generator=generator, device=mu.device)
    dx = mu[..., 0] + sigma[..., 0] * eps[..., 0]
    dy = mu[..., 1] + sigma[..., 1] * (
        rho * eps[..., 0]
        + torch.sqrt(torch.clamp(1 - rho ** 2, min=1e-6)) * eps[..., 1])
    pen = _categorical(params.pen_logits / t, generator)
    return torch.stack([dx, dy], dim=-1), pen
