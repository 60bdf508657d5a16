"""Rate-adapting watermarker wrapper (``nawc_tpu/models/resampled.py``).

``ResampledWM`` presents a watermarker of native rate ``inner.sample_rate``
at an outer rate: ``embed`` resamples the audio to the inner rate, embeds,
resamples back and trims or pads to the input length; ``detect`` and
``score`` resample to the inner rate first.  ``projections`` is not
forwarded: codec-latent methods already run at the codec rate.
"""

from __future__ import annotations

import dataclasses

import torch

from ..dsp.resample import resample
from ..utils.padding import fix_length


@dataclasses.dataclass(frozen=True)
class ResampledWM:
    """Present ``inner`` (native ``inner.sample_rate``) at ``sample_rate``."""

    inner: object
    sample_rate: int

    @property
    def name(self) -> str:
        return self.inner.name

    @property
    def n_bits(self) -> int:
        return getattr(self.inner, "n_bits", 0)

    def _down(self, wav: torch.Tensor) -> torch.Tensor:
        return resample(wav, self.sample_rate, self.inner.sample_rate)

    def embed(self, wav: torch.Tensor, msg=None, key=None) -> torch.Tensor:
        down = self._down(wav)
        if self.n_bits > 0:
            if msg is None:
                raise ValueError(f"{self.name} carries bits; msg is required")
            marked = self.inner.embed(down, msg, key) if key is not None else self.inner.embed(down, msg)
        else:
            marked = self.inner.embed(down)
        return fix_length(resample(marked, self.inner.sample_rate, self.sample_rate), wav.shape[-1])

    def detect(self, wav: torch.Tensor):
        return self.inner.detect(self._down(wav))

    def score(self, wav: torch.Tensor, msg=None) -> torch.Tensor:
        if msg is None:
            return self.inner.score(self._down(wav))
        return self.inner.score(self._down(wav), msg)


def at_rate(wm, sample_rate: int):
    """``wm`` if already native at ``sample_rate``, else wrapped."""
    return wm if wm.sample_rate == sample_rate else ResampledWM(wm, sample_rate)
