"""Monte-Carlo uncertainty of detectors and calibration analysis
(``nawc_tpu/interp/uncertainty.py``): the detector re-run on noisy copies
of each clip, then the reliability curve, ECE and whether the MC variance
predicts errors (numpy, as in the JAX package).

The noise is ``jax.random.normal(key, (n_samples,) + wav.shape)``, drawn
on the waveform's device by :mod:`..ops.jaxrand` (the draw kernel on the
card); the samples are scored one after another, as ``lax.map`` scores
them (a batch of another size rounds differently).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops import jaxrand as keyed


def monte_carlo_scores(
    score_fn: Callable[[torch.Tensor], torch.Tensor],
    wav: torch.Tensor,
    key: np.ndarray,
    n_samples: int = 20,
    sigma: float = 1e-3,
) -> torch.Tensor:
    """(B, T) -> (n_samples, B) scores under input Gaussian noise."""
    noise = keyed.normal(key, (n_samples,) + tuple(wav.shape), wav.device) * float(np.float32(sigma))
    return torch.stack([score_fn(wav + n) for n in noise])


def mc_statistics(
    score_fn,
    wav: torch.Tensor,
    key: np.ndarray,
    labels: np.ndarray | None = None,
    n_samples: int = 20,
    sigma: float = 1e-3,
    threshold: float = 0.5,
) -> dict[str, np.ndarray]:
    """Per-clip mc_mean_prob / mc_var_prob / correct@threshold."""
    scores = monte_carlo_scores(score_fn, wav, key, n_samples, sigma).detach().cpu().numpy()
    out = {
        "mc_mean_prob": scores.mean(axis=0),
        "mc_var_prob": scores.var(axis=0),
    }
    if labels is not None:
        pred = (out["mc_mean_prob"] > threshold).astype(np.int32)
        out["correct"] = (pred == np.asarray(labels)).astype(np.int32)
    return out


def reliability_curve(probs: np.ndarray, labels: np.ndarray, n_bins: int = 10):
    """Calibration curve: per-prob-bin (mean predicted prob, empirical
    accuracy, count); empty bins are left out."""
    probs = np.asarray(probs)
    labels = np.asarray(labels)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    centers, accs, counts = [], [], []
    for i in range(n_bins):
        m = (probs >= edges[i]) & (probs < edges[i + 1] if i < n_bins - 1 else probs <= edges[i + 1])
        if m.sum() == 0:
            continue
        centers.append(probs[m].mean())
        accs.append(labels[m].mean())
        counts.append(int(m.sum()))
    return np.array(centers), np.array(accs), np.array(counts)


def variance_error_auc(variances: np.ndarray, correct: np.ndarray) -> float:
    """Does MC variance predict errors?  AUC of var as a score for
    (1 - correct); NaN when every clip is right or every clip wrong."""
    v = np.asarray(variances, dtype=np.float64)
    err = 1 - np.asarray(correct)
    if err.min() == err.max():
        return float("nan")
    order = np.argsort(v)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(v) + 1)
    n1 = err.sum()
    n0 = len(err) - n1
    return float((ranks[err == 1].sum() - n1 * (n1 + 1) / 2) / (n0 * n1))


def expected_calibration_error(probs: np.ndarray, labels: np.ndarray, n_bins: int = 10) -> float:
    centers, accs, counts = reliability_curve(probs, labels, n_bins)
    if len(counts) == 0:
        return float("nan")
    w = counts / counts.sum()
    return float(np.sum(w * np.abs(accs - centers)))
