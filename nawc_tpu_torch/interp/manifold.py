"""Manifold analysis (``nawc_tpu/interp/manifold.py``): a data-driven
latent axis from per-clip latent deltas, and the projection statistics of
the clean / watermarked / attacked triplet.

``estimate_axis`` runs its SVD in numpy float32 on the host, as the JAX
package does, so that the axis and its sign come from the same LAPACK call.
Tables are lists of row dicts; the per-clip triplet plots are
:func:`..eval.figures.plot_proj_triplet`'s.
"""

from __future__ import annotations

from pathlib import Path
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
    return_projs: bool = False,
):
    """Projection statistics of the clean/wm/attacked triplet onto `axis`
    and the delta columns; `project` (wav -> (B, T')) replaces the latent
    projection (the semantic watermarks project in their own space).  With
    `return_projs`, also the {clean, wm, att} -> (B, T') numpy
    trajectories (for the per-file triplet plots)."""
    out: dict[str, np.ndarray] = {}
    projs: dict[str, np.ndarray] = {}
    proj_fn = project or (lambda wav: get_latent(codec, wav) @ axis)
    for prefix, wav in (("clean", clean), ("wm", watermarked), ("att", attacked)):
        proj = proj_fn(wav)
        if return_projs:
            projs[prefix] = proj.detach().cpu().numpy()
        out.update(projection_stats(proj, prefix))
    out["delta_wm"] = out["wm_proj_mean"] - out["clean_proj_mean"]
    out["delta_att"] = out["att_proj_mean"] - out["wm_proj_mean"]
    return (out, projs) if return_projs else out


@torch.no_grad()
def run_manifold_analysis(
    codec: CodecState,
    watermarkers: dict[str, object],
    clean: torch.Tensor,
    attack_fn: Callable[[torch.Tensor], torch.Tensor],
    triplet_dir: str | Path | None = None,
) -> list[dict]:
    """The per-watermarker manifold table: a row per (watermark, clip) with
    the triplet's projection statistics and the clean, marked and attacked
    scores.  Semantic watermarkers project through their own axis and
    space; the others onto the axis estimated from their latent deltas.
    With `triplet_dir`, draws each clip's clean/wm/attacked projection plot
    under ``<triplet_dir>/<wm>/`` (:func:`triplet_paths`)."""
    rows = []
    for name, wm in watermarkers.items():
        marked, _ = embed_payload(wm, clean, jaxrand.prng_key(0))
        attacked = attack_fn(marked)
        axis = wm.axis if hasattr(wm, "projections") else estimate_axis(codec, clean, marked)
        stats, projs = trajectory_stats(codec, axis, clean, marked, attacked,
                                        project=getattr(wm, "projections", None), return_projs=True)
        if triplet_dir is not None:
            from ..eval.figures import plot_proj_triplet

            for i, path in enumerate(triplet_paths(triplet_dir, name, clean.shape[0])):
                plot_proj_triplet(path, projs["clean"][i], projs["wm"][i], projs["att"][i], name)
        stats.update({f"score_{k}": wm.score(w).cpu().numpy()
                      for k, w in (("clean", clean), ("wm", marked), ("att", attacked))})
        for i in range(clean.shape[0]):
            rows.append({"watermark": name, "clip": i, **{k: float(v[i]) for k, v in stats.items()}})
    return rows


def triplet_paths(triplet_dir: str | Path, name: str, n_clips: int) -> list[Path]:
    """The per-file triplet PNGs of watermark `name`."""
    return [Path(triplet_dir) / name / f"clip_{i}_proj_{name}.png" for i in range(n_clips)]
