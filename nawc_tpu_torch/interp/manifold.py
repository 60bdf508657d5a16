"""Manifold analysis (``nawc_tpu/interp/manifold.py``): a data-driven
latent axis from per-clip latent deltas, and the projection statistics of
the clean / watermarked / attacked triplet.

``estimate_axis`` runs its SVD in numpy float32 on the host, as the JAX
package does, so that the axis and its sign come from the same LAPACK call.
Tables are lists of row dicts; the per-clip triplet plots are left out (the
port does not use matplotlib).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..codec.api import CodecState
from ..models.base import embed_payload
from ..utils import jaxrand
from .probe import get_latent, get_mean_latent


def estimate_axis(codec: CodecState, clean: torch.Tensor, watermarked: torch.Tensor) -> torch.Tensor:
    """Leading PCA direction of per-clip latent deltas (wm - clean):
    (B, T) x2 -> (D,) unit axis; clips with a non-finite delta are left
    out."""
    d = (get_mean_latent(codec, watermarked) - get_mean_latent(codec, clean)).cpu().numpy()
    d = d[np.isfinite(d).all(axis=-1)]
    d = d - d.mean(axis=0, keepdims=True)
    _, _, vh = np.linalg.svd(d, full_matrices=False)
    axis = vh[0]
    return torch.from_numpy(axis / (np.linalg.norm(axis) + 1e-9)).to(clean.device)


def projection_stats(proj: torch.Tensor, prefix: str) -> dict[str, np.ndarray]:
    """(B, T') projections -> per-clip stat columns."""
    p = proj.detach().cpu().numpy()
    return {
        f"{prefix}_proj_mean": p.mean(axis=-1),
        f"{prefix}_proj_std": p.std(axis=-1),
        f"{prefix}_proj_min": p.min(axis=-1),
        f"{prefix}_proj_max": p.max(axis=-1),
    }


def trajectory_stats(
    codec: CodecState,
    axis: torch.Tensor,
    clean: torch.Tensor,
    watermarked: torch.Tensor,
    attacked: torch.Tensor,
    project: Callable[[torch.Tensor], torch.Tensor] | None = None,
) -> dict[str, np.ndarray]:
    """Projection statistics of the clean/wm/attacked triplet onto `axis`
    and the delta columns; `project` (wav -> (B, T')) replaces the latent
    projection (the semantic watermarks project in their own space)."""
    out: dict[str, np.ndarray] = {}
    proj_fn = project or (lambda wav: get_latent(codec, wav) @ axis)
    for prefix, wav in (("clean", clean), ("wm", watermarked), ("att", attacked)):
        out.update(projection_stats(proj_fn(wav), prefix))
    out["delta_wm"] = out["wm_proj_mean"] - out["clean_proj_mean"]
    out["delta_att"] = out["att_proj_mean"] - out["wm_proj_mean"]
    return out


@torch.no_grad()
def run_manifold_analysis(
    codec: CodecState,
    watermarkers: dict[str, object],
    clean: torch.Tensor,
    attack_fn: Callable[[torch.Tensor], torch.Tensor],
) -> list[dict]:
    """The per-watermarker manifold table: a row per (watermark, clip) with
    the triplet's projection statistics and the clean, marked and attacked
    scores.  Semantic watermarkers project through their own axis and
    space; the others onto the axis estimated from their latent deltas."""
    rows = []
    for name, wm in watermarkers.items():
        marked, _ = embed_payload(wm, clean, jaxrand.prng_key(0))
        attacked = attack_fn(marked)
        if hasattr(wm, "projections"):
            stats = trajectory_stats(codec, wm.axis, clean, marked, attacked, project=wm.projections)
        else:
            axis = estimate_axis(codec, clean, marked)
            stats = trajectory_stats(codec, axis, clean, marked, attacked)
        stats.update({f"score_{k}": wm.score(w).cpu().numpy()
                      for k, w in (("clean", clean), ("wm", marked), ("att", attacked))})
        for i in range(clean.shape[0]):
            rows.append({"watermark": name, "clip": i, **{k: float(v[i]) for k, v in stats.items()}})
    return rows
