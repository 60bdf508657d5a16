"""Saliency and attribution over detector inputs
(``nawc_tpu/interp/saliency.py``): input gradients as one backward per
batch, integrated gradients along the straight path, and the aggregation
of waveform attributions into a time-frequency map.

Through the spread-spectrum score on the card, each gradient runs the
``whiten_correlate`` kernel forward and its plain VJP backward.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..dsp.stft import stft
from ..utils.config import StftConfig

ScoreFn = Callable[[torch.Tensor], torch.Tensor]  # (B, T) -> (B,)


def input_gradient(score_fn: ScoreFn, wav: torch.Tensor) -> torch.Tensor:
    """d score_i / d wav_i for every clip in one backward (B, T): the VJP
    of `score_fn` with ones."""
    x = wav.detach().requires_grad_(True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(score_fn(x), x, grad_outputs=torch.ones(
            wav.shape[0], dtype=wav.dtype, device=wav.device))
    return g


def integrated_gradients(
    score_fn: ScoreFn,
    wav: torch.Tensor,
    baseline: torch.Tensor | None = None,
    steps: int = 16,
) -> torch.Tensor:
    """IG along the straight path baseline -> wav at the midpoints
    ``(i + 0.5) / steps``: one batched gradient per step, in turn, as
    ``lax.map`` runs them."""
    base = torch.zeros_like(wav) if baseline is None else baseline
    alphas = (np.arange(steps, dtype=np.float32) + np.float32(0.5)) / np.float32(steps)
    grads = torch.stack([input_gradient(score_fn, base + float(a) * (wav - base)) for a in alphas])
    return (wav - base) * grads.mean(dim=0)


def saliency_spectrogram(wav: torch.Tensor, sal: torch.Tensor,
                         cfg: StftConfig = StftConfig()) -> torch.Tensor:
    """(B, T') x F magnitude spectrogram of the attribution `sal` (`wav` is
    unused, as in the JAX package)."""
    return stft(sal, cfg).abs()


def topk_salient_frames(sal_spec: torch.Tensor, k: int = 10) -> torch.Tensor:
    """(B, T', F) -> (B, k) indices of the most attributed frames, the
    lower index first on ties (as ``lax.top_k``)."""
    energy = (sal_spec**2).sum(dim=-1)
    return torch.sort(energy, dim=-1, descending=True, stable=True).indices[..., :k]
