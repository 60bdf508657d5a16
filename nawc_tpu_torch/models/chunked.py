"""Chunked multi-bit watermark, the WavMark-capability analogue
(``nawc_tpu/models/chunked.py``).

The clip is framed into fixed 1 s chunks (as one batch, not a loop); each
chunk carries the same payload through the spread-spectrum core, and detect
sums the per-chunk statistics, so redundancy across chunks buys robustness.
``score`` is 1 - BER against the known payload.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils.config import SpreadSpectrumConfig
from .base import register
from .spread_spectrum import SpreadSpectrumWM


@dataclasses.dataclass(frozen=True)
class ChunkedWM:
    """16-bit payload repeated over 1 s chunks; score = 1 - BER."""

    cfg: SpreadSpectrumConfig = SpreadSpectrumConfig(alpha=0.14, mask_quantile=0.85)
    seed: int = 1  # a default key distinct from the plain spread-spectrum one
    chunk_seconds: float = 1.0
    name: str = "chunked"

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def n_bits(self) -> int:
        return self.cfg.n_bits

    @property
    def _chunk(self) -> int:
        return int(self.chunk_seconds * self.cfg.sample_rate)

    @property
    def _core(self) -> SpreadSpectrumWM:
        return SpreadSpectrumWM(cfg=self.cfg, seed=self.seed)

    def _frame(self, wav: torch.Tensor) -> tuple[torch.Tensor, int]:
        b, t = wav.shape
        c = self._chunk
        n = max(t // c, 1)
        return wav[..., : n * c].reshape(b * n, c), n

    def embed(self, wav: torch.Tensor, msg: torch.Tensor, key=None) -> torch.Tensor:
        b, _ = wav.shape
        x, n = self._frame(wav)
        marked = self._core.embed(x, torch.repeat_interleave(msg, n, dim=0))
        out = marked.reshape(b, n * self._chunk)
        return torch.cat([out, wav[..., n * self._chunk:]], dim=-1)

    def _zsum(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, n_bits): the per-chunk statistics, independent
        N(0, 1) on unmarked audio, summed over chunks / sqrt(n_chunks)."""
        b, _ = wav.shape
        x, n = self._frame(wav)
        z = self._core._correlate(x).reshape(b, n, self.n_bits)
        return z.sum(dim=1) / math.sqrt(float(n))

    @staticmethod
    def _presence(zsum: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(4.0 * (zsum.abs().mean(dim=-1) - 1.3))

    def detect(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        zsum = self._zsum(wav)
        return self._presence(zsum), (zsum > 0).to(torch.int32)

    def score(self, wav: torch.Tensor, msg: torch.Tensor | None = None) -> torch.Tensor:
        """1 - BER against the known payload; without one, presence."""
        presence, bits = self.detect(wav)
        if msg is None:
            return presence
        return (bits == msg).float().mean(dim=-1)

    def score_soft(self, wav: torch.Tensor, msg: torch.Tensor | None = None) -> torch.Tensor:
        """A differentiable surrogate of :meth:`score`: the sigmoid of the
        summed statistics."""
        zsum = self._zsum(wav)
        if msg is None:
            return self._presence(zsum)
        s = 2.0 * msg.to(torch.float32) - 1.0
        return torch.sigmoid(3.0 * ((zsum * s).mean(dim=-1) - 0.8))


@register("chunked")
def _build(cfg: SpreadSpectrumConfig | None = None, seed: int = 1) -> ChunkedWM:
    return ChunkedWM(cfg=cfg, seed=seed) if cfg is not None else ChunkedWM(seed=seed)
