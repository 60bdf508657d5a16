"""Codebook-layer ablation sweeps (``nawc_tpu/interp/ablation.py``): for
every mask of the full_all / drop_last_k / keep_only_i families, decode the
masked codes and re-detect every watermark, one batched score per (mask,
watermarker).  Each ablation encodes through the fused residual-VQ kernel.

Tables are lists of row dicts (the JAX package returns DataFrames).
"""

from __future__ import annotations

import torch

from ..attacks.codec import ablation_masks, layer_ablation
from ..codec.api import CodecState
from ..eval.figures import pivot_mean
from ..models.base import embed_payload, score_payload
from ..utils import jaxrand


@torch.no_grad()
def run_layer_ablation(
    codec: CodecState,
    watermarkers: dict[str, object],
    clean: torch.Tensor,
    in_sr: int | None = None,
) -> list[dict]:
    """-> rows (mask, watermark, clip, score), watermarker by watermarker,
    mask by mask, clip by clip."""
    masks = ablation_masks(codec.cfg.num_levels, device=clean.device)
    rows = []
    key = jaxrand.prng_key(0)
    for wname, wm in watermarkers.items():
        marked, msg = embed_payload(wm, clean, key)
        for mname, mask in masks.items():
            score = score_payload(wm, layer_ablation(codec, marked, mask, in_sr=in_sr), msg).cpu().numpy()
            rows += [{"mask": mname, "watermark": wname, "clip": i, "score": float(score[i])}
                     for i in range(clean.shape[0])]
    return rows


def ablation_heatmap(rows: list[dict]) -> list[dict]:
    """The (mask x watermark) pivot of mean scores, as pandas'
    ``pivot_table(index="mask", columns="watermark", aggfunc="mean")``:
    one row per mask, masks and watermarks in sorted order."""
    masks, wms, means = pivot_mean(rows, "mask", "watermark", "score")
    return [{"mask": m, **{w: float(means[i, j]) for j, w in enumerate(wms)}} for i, m in enumerate(masks)]
