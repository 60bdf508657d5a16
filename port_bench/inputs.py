"""Inputs of the benchmark, all from the run's seed.

* :func:`speech_clip`: a speech-like clip, five harmonics of a gliding f0
  under a syllable-rate envelope plus a noise floor (a frozen copy of the
  generator in ``chip_smoke.py``; seeded noise is not what users mark).
* :func:`messages`: payload bits.

Every draw takes a ``numpy.random.Generator``; :func:`rng` makes one from
the seed and a stream name, so that two streams of one run never share
draws.
"""

from __future__ import annotations

import zlib

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**63, zlib.crc32(stream.encode())])


def speech_clip(r: np.random.Generator, n_samples: int, sr: int) -> np.ndarray:
    tt = np.arange(n_samples) / sr
    f0 = r.uniform(100, 220) * (1 + 0.1 * np.sin(2 * np.pi * r.uniform(0.3, 1.0) * tt))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    env = np.clip(np.sin(2 * np.pi * r.uniform(3, 5) * tt + r.uniform(0, 6)), 0, None) ** 2
    tone = sum(np.sin(h * phase) / h for h in range(1, 6)) * env
    return (0.25 * tone + 0.005 * r.normal(size=tt.size)).astype(np.float32)


def speech_clips(r: np.random.Generator, n: int, n_samples: int, sr: int) -> np.ndarray:
    """(n, n_samples) float32."""
    return np.stack([speech_clip(r, n_samples, sr) for _ in range(n)])


def messages(r: np.random.Generator, n: int, n_bits: int) -> np.ndarray:
    """(n, n_bits) int32 in {0, 1}."""
    return r.integers(0, 2, (n, n_bits)).astype(np.int32)
