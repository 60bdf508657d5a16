"""Attack registry (``nawc_tpu/attacks/__init__.py``).

:func:`build_suite` returns ``{name: fn(wav, key) -> wav}`` for the raw_bench
families, with the JAX package's names, order and severities (anchored to
the reference benchmark's per-attack SI-SNR, ``docs/surrogates.md``).  `key`
is a :mod:`..utils.jaxrand` key; the keyed attacks draw what ``jax.random``
draws for it.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import dsp
from .codec import (
    ablation_masks,
    codec_roundtrip,
    latent_roundtrip,
    latent_transform_attack,
    layer_ablation,
)
from .pgd import pgd_attack, project_to_nullspace, subspace_pgd_attack

AttackFn = Callable[[torch.Tensor, np.ndarray], torch.Tensor]


def build_suite(sr: int = 16_000, codec=None) -> dict[str, AttackFn]:
    """The named attack suite at sample rate `sr`.  A `codec`
    (:class:`~nawc_tpu_torch.codec.CodecState`) adds the neural-codec
    round-trips: ``encodec`` (quantizer bypass, mild) and ``dac`` (the full
    residual-VQ round-trip, destructive)."""
    suite: dict[str, AttackFn] = {
        "identity": lambda w, k: w,
        "gain": lambda w, k: dsp.gain(w, 2.0),
        "polarity": lambda w, k: dsp.polarity(w),
        "gaussian_noise": lambda w, k: dsp.gaussian_noise(w, k, snr_db=51.0),
        "background_noise": lambda w, k: dsp.background_noise(w, k, snr_db=47.0),
        "lowpass": lambda w, k: dsp.lowpass(w, 5000.0, sr),
        "highpass": lambda w, k: dsp.highpass(w, 650.0, sr),
        "eq": lambda w, k: dsp.eq(w, k, sr, depth_db=10.0),
        "quantization": lambda w, k: dsp.quantization(w, 14),
        "dynamic_range_compression": lambda w, k: dsp.dynamic_range_compression(
            w, thresh_db=-18.0, ratio=2.0
        ),
        "dynamic_range_expansion": lambda w, k: dsp.dynamic_range_expansion(w),
        "limiter": lambda w, k: dsp.limiter(w, 0.27),
        "phase_shift": lambda w, k: dsp.phase_shift(w, 1.498),
        "time_jitter": lambda w, k: dsp.time_jitter(w, k, 0.008, sr),
        "time_stretch": lambda w, k: dsp.time_stretch(w, 9999),
        "reverb": lambda w, k: dsp.reverb(w, k, 300.0, sr, wet=0.3),
        "mp3": lambda w, k: dsp.mp3(w, sr),
        "aac": lambda w, k: dsp.aac(w, sr),
        "vorbis": lambda w, k: dsp.vorbis(w, k, sr),
    }
    if codec is not None:
        suite["encodec"] = lambda w, k: latent_roundtrip(codec, w, in_sr=sr)
        suite["dac"] = lambda w, k: codec_roundtrip(codec, w, in_sr=sr)
    return suite


__all__ = [
    "build_suite",
    "dsp",
    "codec_roundtrip",
    "layer_ablation",
    "ablation_masks",
    "latent_roundtrip",
    "latent_transform_attack",
    "pgd_attack",
    "project_to_nullspace",
    "subspace_pgd_attack",
]
