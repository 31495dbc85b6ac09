"""Mixture-density head math: split the raw head output, the loss, sample.

Port of ``sketchformer_tpu/ops/mdn.py``: ``split_params``,
``component_log_prob``, ``gmm_log_likelihood``, ``mdn_loss`` and ``sample``,
as plain torch (the JAX package has no kernel here). Everything runs in
f32, with log-sigma clamped to [-6, 4] and |rho| <= 0.99.
Layout of a raw head output (``6*M + 3`` features)::

    [pi_logits(M) | mu_x(M) | mu_y(M) | log_sigma_x(M) | log_sigma_y(M)
     | rho_raw(M) | pen_logits(3)]

Sampling draws from a ``torch.Generator``, so its streams differ from
``jax.random``'s; greedy decoding draws nothing and matches exactly.
"""

from __future__ import annotations

import math
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


def component_log_prob(params: MDNParams, xy: torch.Tensor) -> torch.Tensor:
    """Log N_m(xy) for every mixture component; xy (..., 2) -> (..., M)."""
    xy = xy.float()[..., None, :]                          # (..., 1, 2)
    norm = (xy - params.mu) * torch.exp(-params.log_sigma)
    nx, ny = norm[..., 0], norm[..., 1]
    one_m_rho2 = torch.clamp(1.0 - params.rho ** 2, min=1e-6)
    zq = nx * nx + ny * ny - 2.0 * params.rho * nx * ny
    log_det = params.log_sigma.sum(dim=-1)
    return (-zq / (2.0 * one_m_rho2) - log_det - 0.5 * torch.log(one_m_rho2)
            - math.log(2.0 * math.pi))


def gmm_log_likelihood(params: MDNParams, xy: torch.Tensor) -> torch.Tensor:
    """Log p(xy) under the mixture; (..., 2) -> (...)."""
    return torch.logsumexp(params.log_pi + component_log_prob(params, xy),
                           dim=-1)


def mdn_loss(raw: torch.Tensor, num_mixtures: int, tgt_xy: torch.Tensor,
             tgt_pen: torch.Tensor,
             mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked mean (GMM NLL, pen CE) over the batch: raw (B, T, 6M+3),
    tgt_xy (B, T, 2), tgt_pen (B, T) int, mask (B, T)."""
    params = split_params(raw, num_mixtures)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    nll_xy = -gmm_log_likelihood(params, tgt_xy)
    pen_ll = torch.log_softmax(params.pen_logits, dim=-1)
    nll_pen = -pen_ll.gather(-1, tgt_pen.long()[..., None])[..., 0]
    return (nll_xy * mask).sum() / denom, (nll_pen * mask).sum() / denom


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
