"""Polyphase windowed-sinc resampler as one strided convolution
(``nawc_tpu/dsp/resample.py``): the same numpy filterbank, then ``conv1d``
with stride o and the phases interleaved."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling


@functools.lru_cache(maxsize=64)
def _polyphase_kernel(
    orig: int, new: int, lowpass_filter_width: int = 6, rolloff: float = 0.99
) -> tuple[np.ndarray, int, int, int]:
    """Build the (new', 1, 2*width + orig') bank of windowed-sinc filters:
    phase i of the output is channel i of a stride-o convolution."""
    g = math.gcd(orig, new)
    o, n = orig // g, new // g
    base_freq = min(o, n) * rolloff
    width = int(math.ceil(lowpass_filter_width * o / base_freq))
    karr = np.arange(-width, width + o, dtype=np.float64)[None, :] / o
    phase = -np.arange(n, dtype=np.float64)[:, None] / n
    t = (phase + karr) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2.0) ** 2
    tpi = t * np.pi
    kern = np.where(tpi == 0.0, 1.0, np.sin(tpi) / np.where(tpi == 0.0, 1.0, tpi))
    kern = kern * window * (base_freq / o)
    return kern[:, None, :].astype(np.float32), o, n, width


def resample(
    x: torch.Tensor,
    orig: int,
    new: int,
    lowpass_filter_width: int = 6,
    rolloff: float = 0.99,
) -> torch.Tensor:
    """Resample (..., T) from `orig` Hz to `new` Hz; length ceil(T*new/orig)."""
    if orig == new:
        return x
    kern_np, o, n, width = _polyphase_kernel(orig, new, lowpass_filter_width, rolloff)
    kern = profiling.to_device(kern_np, x.device, x.dtype)
    lead = x.shape[:-1]
    t_in = x.shape[-1]
    xb = F.pad(x.reshape(-1, 1, t_in), (width, width + o))
    y = F.conv1d(xb, kern, stride=o)  # (B, n, Q)
    y = y.transpose(1, 2).reshape(xb.shape[0], -1)  # interleave phases
    target = int(math.ceil(t_in * n / o))
    return y[:, :target].reshape(lead + (target,))


def resample_length(t_in: int, orig: int, new: int) -> int:
    """Output length of :func:`resample`."""
    g = math.gcd(orig, new)
    return int(math.ceil(t_in * (new // g) / (orig // g)))
