"""White-box PGD attacks against differentiable detector scores
(``nawc_tpu/attacks/pgd.py``): sign-PGD on an additive perturbation with
||delta||_inf <= eps, and the variant that penalises the perturbation's
latent change inside a protected subspace every few steps.

The JAX attacks are jitted ``fori_loop``s; here they are plain loops under
``torch.enable_grad()``, so that they run under a ``no_grad`` caller too.
Through the spread-spectrum ``score`` or the chunked ``score_soft``, each
step runs the ``whiten_correlate`` kernel forward and its plain VJP
backward on the card.
"""

from __future__ import annotations

from typing import Callable

import torch

ScoreFn = Callable[[torch.Tensor], torch.Tensor]  # (B, T) -> (B,) score


def _grad(loss_fn: Callable[[torch.Tensor], torch.Tensor], delta: torch.Tensor) -> torch.Tensor:
    d = delta.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss_fn(d), d)
    return g


def pgd_attack(score_fn: ScoreFn, wav: torch.Tensor, steps: int = 100, eps: float = 0.02,
               lr: float = 0.001, sign_update: bool = True) -> torch.Tensor:
    """Minimise `score_fn` over an additive perturbation with
    ||delta||_inf <= eps; -> the attacked audio, clipped to [-1, 1]."""
    wav = wav.detach()
    delta = torch.zeros_like(wav)
    with torch.enable_grad():
        for _ in range(steps):
            g = _grad(lambda d: score_fn(wav + d).sum(), delta)
            step = torch.sign(g) if sign_update else g / (g.abs().max() + 1e-9)
            delta = torch.clamp(delta - lr * step, -eps, eps)
    return torch.clamp(wav + delta, -1.0, 1.0)


def project_to_nullspace(delta_latent: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Remove the component of `delta_latent` (..., D) in the span of the
    orthonormal rows of `basis` (K, D)."""
    return delta_latent - (delta_latent @ basis.T) @ basis


def subspace_loss(score_fn: ScoreFn, latent_fn: Callable[[torch.Tensor], torch.Tensor],
                  wav: torch.Tensor, z0: torch.Tensor, basis: torch.Tensor, delta: torch.Tensor,
                  protect_weight: float = 1.0, use_penalty: bool = True) -> torch.Tensor:
    """The summed score of ``wav + delta`` plus, with `use_penalty`,
    ``protect_weight * ||(latent(wav + delta) - z0) @ basis.T||^2``."""
    loss = score_fn(wav + delta).sum()
    if use_penalty:
        head = (latent_fn(wav + delta) - z0) @ basis.T
        loss = loss + protect_weight * (head * head).sum()
    return loss


def subspace_pgd_attack(score_fn: ScoreFn, latent_fn: Callable[[torch.Tensor], torch.Tensor],
                        wav: torch.Tensor, basis: torch.Tensor, steps: int = 100,
                        eps: float = 0.02, lr: float = 0.001, project_every: int = 5,
                        protect_weight: float = 1.0) -> torch.Tensor:
    """Sign-PGD on :func:`subspace_loss`, with the penalty on every
    `project_every`-th step from step 0.  On the other steps JAX multiplies
    the penalty by 0; the port leaves it out, which changes no gradient."""
    wav = wav.detach()
    delta = torch.zeros_like(wav)
    with torch.enable_grad():
        z0 = latent_fn(wav).detach()
        for i in range(steps):
            g = _grad(lambda d: subspace_loss(score_fn, latent_fn, wav, z0, basis, d, protect_weight,
                                              i % project_every == 0), delta)
            delta = torch.clamp(delta - lr * torch.sign(g), -eps, eps)
    return torch.clamp(wav + delta, -1.0, 1.0)
