"""Latent-space PCA analysis and PCA-based attacks
(``nawc_tpu/interp/latent_pca.py``): PCA of clean codec latents, the
attack family (PCA amputation, PCA jamming, latent rounding), the
watermark's latent-delta metrics, the top-K reconstruction sweep and the
head/tail energy split of a PGD perturbation.

``fit_pca`` is one ``torch.linalg.svd`` on the latents' device: a
component's sign is LAPACK's on the CPU and cuSOLVER's on the card, and may
differ from JAX's.  Amputation, the K-sweep and the head/tail energy do not
depend on the signs; jamming does, through the noise it reconstructs.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..attacks.codec import latent_transform_attack
from ..models.base import score_payload
from ..eval.metrics import si_snr
from ..ops import jaxrand as keyed


def fit_pca(latents: torch.Tensor, n_components: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(N, D) (or (B, T, D), flattened) -> (mean (D,), components (k, D),
    explained variance (k,))."""
    x = latents.reshape(-1, latents.shape[-1])
    mean = x.mean(dim=0)
    _, s, vh = torch.linalg.svd(x - mean, full_matrices=False)
    var = s**2 / (x.shape[0] - 1)
    return mean, vh[:n_components], var[:n_components]


def pca_project(z: torch.Tensor, mean: torch.Tensor, comps: torch.Tensor) -> torch.Tensor:
    return (z - mean) @ comps.T


def pca_reconstruct(coeff: torch.Tensor, mean: torch.Tensor, comps: torch.Tensor) -> torch.Tensor:
    return coeff @ comps + mean


def amputation_fn(mean: torch.Tensor, comps: torch.Tensor, keep_k: int) -> Callable:
    """Zero every component beyond the first keep_k (PCA Amputation); the
    residual outside the subspace is added back, as the JAX package writes
    it."""

    def fn(z):
        c = pca_project(z, mean, comps)
        c[..., keep_k:] = 0.0
        return pca_reconstruct(c, mean, comps) + (z - pca_reconstruct(pca_project(z, mean, comps), mean, comps))

    return fn


def jamming_fn(mean: torch.Tensor, comps: torch.Tensor, keep_k: int, key: np.ndarray,
               scale: float = 2.0) -> Callable:
    """Replace the tail coefficients by scale * sigma Gaussian noise (PCA
    Jamming); the noise is ``jax.random.normal(key, c.shape)``."""

    def fn(z):
        c = pca_project(z, mean, comps)
        sigma = c.std(dim=tuple(range(c.ndim - 1)), keepdim=True, correction=0)
        noise = keyed.normal(key, c.shape, c.device) * sigma * scale
        mask = (torch.arange(c.shape[-1], device=c.device) >= keep_k).to(c.dtype)
        return pca_reconstruct(c * (1 - mask) + noise * mask, mean, comps)

    return fn


def rounding_fn(scale: float = 5.0) -> Callable:
    """Quantise latents at `scale` (Latent Rounding), half to even as
    ``jnp.round``."""

    def fn(z):
        return torch.round(z * scale) / scale

    return fn


def latent_delta_metrics(z_clean: torch.Tensor, z_marked: torch.Tensor,
                         n_pca: int = 10) -> dict[str, np.ndarray]:
    """Per-clip watermark delta norms, cosine to content, latent SNR, and the
    cumulative PCA variance of the deltas."""
    d = z_marked - z_clean  # (B, T, D)
    d_flat = d.reshape(d.shape[0], -1)
    z_flat = z_clean.reshape(z_clean.shape[0], -1)
    l2 = d_flat.norm(dim=-1)
    cos = (d_flat * z_flat).sum(dim=-1) / (l2 * z_flat.norm(dim=-1) + 1e-9)
    snr = 10.0 * torch.log10(((z_flat**2).sum(-1) + 1e-9) / ((d_flat**2).sum(-1) + 1e-9))
    dm = d.reshape(-1, d.shape[-1])
    _, _, var = fit_pca(dm, min(n_pca, dm.shape[-1]))
    total_var = (dm - dm.mean(0)).var(dim=0, correction=0).sum()
    cumvar = torch.cumsum(var, 0) / (total_var + 1e-12)
    return {k: v.cpu().numpy() for k, v in (("delta_l2", l2), ("cos_to_content", cos),
                                             ("latent_snr_db", snr), ("pca_cumvar", cumvar))}


@torch.no_grad()
def reconstruction_attack_sweep(
    codec,
    wm,
    marked: torch.Tensor,
    mean: torch.Tensor,
    comps: torch.Tensor,
    keep_ks: Sequence[int] = (10, 20, 50, 80, 100, 128),
    msg=None,
) -> list[dict]:
    """Keep the top-K PCA components of the watermarked latents, decode,
    re-detect: -> rows (keep_k, score_mean, sisnr_mean)."""
    rows = []
    for k in keep_ks:
        att = latent_transform_attack(codec, marked, amputation_fn(mean, comps, int(k)))
        score = score_payload(wm, att, msg).cpu().numpy()
        s = si_snr(marked, att).cpu().numpy()
        rows.append({"keep_k": int(k), "score_mean": float(score.mean()), "sisnr_mean": float(s.mean())})
    return rows


def head_tail_energy(dz: torch.Tensor, comps: torch.Tensor, head_k: int = 60) -> tuple[float, float]:
    """PGD noise energy split into the protected head and the tail."""
    c = dz.reshape(-1, dz.shape[-1]) @ comps.T
    head = float((c[:, :head_k] ** 2).sum())
    total = float((dz**2).sum())
    return head, max(total - head, 0.0)
