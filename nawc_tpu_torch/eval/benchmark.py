"""Benchmark harness (``nawc_tpu/eval/benchmark.py``): the detector
self-check, survivability (embed -> attack -> detect) and the combined
optimal-threshold search, with the reference's per-method thresholds
0.5 / 0.99 / 0.85.

All clips go through as one batch per (watermarker, attack) pair.  Errors
are isolated per method, as in the reference: a failing watermarker gives
rows with an ``error`` column instead of ending the run, so a caller that
must not hide a failure checks for that column.  Tables are lists of row
dicts.
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Callable

import numpy as np
import torch

from ..interp.feature_importance import Row
from ..models.base import embed_payload, score_payload
from ..utils import jaxrand
from ..utils.device import resolve_device
from .metrics import si_snr

# the reference's decision thresholds, keyed by CLI names and class names
DEFAULT_THRESHOLDS = {
    "spread_spectrum": 0.5,
    "SpreadSpectrum": 0.5,
    "neural": 0.5,
    "chunked": 0.85,
    "psychoacoustic": 0.99,
    "semantic_pca": 0.85,
    "semantic_cluster": 0.85,
    "semantic_random": 0.85,
    "SemanticPCA": 0.85,
    "SemanticCluster": 0.85,
    "SemanticRandom": 0.85,
    "token_green": 0.75,
}
FALLBACK_THRESHOLD = 0.5


def _threshold_for(name: str, thresholds: dict[str, float] | None) -> float:
    return {**DEFAULT_THRESHOLDS, **(thresholds or {})}.get(name, FALLBACK_THRESHOLD)


def _release_device_memory() -> None:
    """Free the buffers of the method just run before the next one: a
    garbage collection, as in JAX (the caching allocator keeps the blocks
    for reuse)."""
    gc.collect()


def _score(wm, wav: torch.Tensor, msg) -> np.ndarray:
    return score_payload(wm, wav, msg).detach().cpu().numpy()


def _batch(wav, device) -> torch.Tensor:
    return torch.as_tensor(wav, dtype=torch.float32, device=resolve_device(device))


@torch.no_grad()
def run_detector_checker(
    watermarkers: dict[str, object],
    wav,
    thresholds: dict[str, float] | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> list[Row]:
    """Embed -> detect, no attack.  -> rows (watermark, clip_index,
    score_before, score_after, threshold, detector_works)."""
    wav = _batch(wav, device)
    rows: list[Row] = []
    key = jaxrand.prng_key(seed)
    for name, wm in watermarkers.items():
        th = _threshold_for(name, thresholds)
        try:
            marked, msg = embed_payload(wm, wav, key)
            before = _score(wm, wav, msg)
            after = _score(wm, marked, msg)
            for i in range(wav.shape[0]):
                rows.append({
                    "watermark": name, "clip_index": i,
                    "score_before": float(before[i]), "score_after": float(after[i]),
                    "threshold": th,
                    "detector_works": bool(after[i] > th),
                })
            del marked
        except Exception as e:  # per-method error isolation, as the reference
            rows.append({"watermark": name, "clip_index": -1, "error": repr(e)})
        _release_device_memory()
    return rows


@torch.no_grad()
def run_survivability(
    watermarkers: dict[str, object],
    attacks: dict[str, Callable],
    wav,
    thresholds: dict[str, float] | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> list[Row]:
    """Embed -> attack -> detect over the (watermarker x attack) grid.
    -> rows with per-clip scores, survived at the threshold, and the
    watermark's SI-SNR."""
    wav = _batch(wav, device)
    rows: list[Row] = []
    key = jaxrand.prng_key(seed)
    for wname, wm in watermarkers.items():
        th = _threshold_for(wname, thresholds)
        try:
            marked, msg = embed_payload(wm, wav, key)
            wm_snr = si_snr(wav, marked).cpu().numpy()
        except Exception as e:
            rows.append({"watermark": wname, "attack": "-", "clip_index": -1, "error": repr(e)})
            continue
        for aname, attack in attacks.items():
            try:
                score = _score(wm, attack(marked, key), msg)
                for i in range(wav.shape[0]):
                    rows.append({
                        "watermark": wname, "attack": aname, "clip_index": i,
                        "score": float(score[i]), "threshold": th,
                        "survived": bool(score[i] > th),
                        "sisnr_wm": float(wm_snr[i]),
                    })
            except Exception as e:
                rows.append({"watermark": wname, "attack": aname, "clip_index": -1,
                             "error": repr(e)})
        _release_device_memory()
    return rows


def find_optimal_threshold(scores: np.ndarray, labels: np.ndarray) -> tuple[float, float]:
    """The threshold of best accuracy on proper labels (the reference's
    combined-mode variant).  -> (best_threshold, best_accuracy)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    cands = np.unique(scores)
    if len(cands) > 512:
        cands = np.quantile(cands, np.linspace(0, 1, 512))
    best_t, best_acc = 0.5, 0.0
    for t in cands:
        acc = ((scores > t) == labels).mean()
        if acc > best_acc:
            best_t, best_acc = float(t), float(acc)
    return best_t, best_acc


def detection_auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank AUC of the scores for the labels."""
    s = np.asarray(scores, np.float64)
    y = np.asarray(labels)
    if y.min() == y.max():
        return float("nan")
    order = np.argsort(s)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(s) + 1)
    n1 = y.sum()
    n0 = len(y) - n1
    return float((ranks[y == 1].sum() - n1 * (n1 + 1) / 2) / (n0 * n1))


@dataclasses.dataclass
class CombinedReport:
    per_method: list[Row]  # the detector-check rows, then the survivability rows
    summary: list[Row]


def _col(rows: list[Row], name: str) -> np.ndarray:
    return np.array([r[name] for r in rows], np.float64)


def run_combined(
    watermarkers: dict[str, object],
    attacks: dict[str, Callable],
    wav,
    thresholds: dict[str, float] | None = None,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> CombinedReport:
    """Detector check + survivability + each method's optimal threshold from
    {clean scores: 0} against {marked and attacked scores: 1}, and beside
    the fixed thresholds a calibrated gate at a Gaussian 5% false-positive
    rate of the clean scores (mean + 1.645 sd)."""
    det = run_detector_checker(watermarkers, wav, thresholds, seed, device)
    srv = run_survivability(watermarkers, attacks, wav, thresholds, seed, device)
    summaries = []
    for name in watermarkers:
        d = [r for r in det if r["watermark"] == name and r["clip_index"] >= 0]
        s = [r for r in srv if r["watermark"] == name and r["clip_index"] >= 0]
        if not d:
            continue
        before, after, attacked = _col(d, "score_before"), _col(d, "score_after"), _col(s, "score")
        scores = np.concatenate([before, after, attacked])
        labels = np.concatenate([np.zeros(len(d)), np.ones(len(d)), np.ones(len(s))])
        t, acc = find_optimal_threshold(scores, labels)
        cal_t = float(before.mean() + 1.645 * before.std())
        summaries.append({
            "watermark": name, "optimal_threshold": t, "accuracy_at_optimal": acc,
            "auc": detection_auc(scores, labels),
            "detector_pass_rate": float(np.mean([r["detector_works"] for r in d])),
            "survival_rate": float(np.mean([r["survived"] for r in s])) if s else float("nan"),
            "calibrated_threshold": cal_t,
            "fpr_at_calibrated": float((before > cal_t).mean()),
            "survival_rate_calibrated": float((attacked > cal_t).mean()) if s else float("nan"),
        })
    return CombinedReport(per_method=det + srv, summary=summaries)
