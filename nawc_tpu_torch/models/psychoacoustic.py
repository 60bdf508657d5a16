"""Psychoacoustic high-rate watermark, the SilentCipher-capability analogue
(``nawc_tpu/models/psychoacoustic.py``).

At 44.1 kHz the message is k 8-bit symbols, each protected by a
Hamming(12,8) code, carried by the spread-spectrum core in the 0.8-10 kHz
band.  Detect decodes each symbol by soft maximum likelihood and ``score``
is the exact-match indicator; :meth:`PsychoacousticWM.discover_message_length`
finds k without being told.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils.config import SpreadSpectrumConfig
from ..utils.ecc import hamming_encode, hamming_soft_decode
from .base import register
from .spread_spectrum import SpreadSpectrumWM

_DEFAULT_MESSAGE = (1, 2, 3, 4, 5)  # the reference's integer message
_CODED_BITS = 12  # Hamming(12,8) codeword width per 8-bit symbol


def ints_to_bits(msg_ints: torch.Tensor, bits_per_symbol: int = 8) -> torch.Tensor:
    """(B, k) ints -> (B, k*bits) {0,1}, big-endian per symbol."""
    shifts = torch.arange(bits_per_symbol - 1, -1, -1, device=msg_ints.device)
    bits = (msg_ints[..., None] >> shifts) & 1
    return bits.reshape(msg_ints.shape[0], -1).to(torch.int32)


def bits_to_ints(bits: torch.Tensor, bits_per_symbol: int = 8) -> torch.Tensor:
    """(B, k*bits) -> (B, k) ints."""
    b = bits.reshape(bits.shape[0], -1, bits_per_symbol)
    weights = 2 ** torch.arange(bits_per_symbol - 1, -1, -1, device=bits.device)
    return (b * weights).sum(dim=-1)


@dataclasses.dataclass(frozen=True)
class PsychoacousticWM:
    """44.1 kHz, k-symbol message, Hamming-protected exact-match detection."""

    n_symbols: int = 5
    bits_per_symbol: int = 8
    seed: int = 2
    alpha: float = 0.22
    mask_quantile: float = 0.85
    ecc: bool = True
    name: str = "psychoacoustic"

    @property
    def coded_bits_per_symbol(self) -> int:
        return _CODED_BITS if self.ecc else self.bits_per_symbol

    @property
    def cfg(self) -> SpreadSpectrumConfig:
        return SpreadSpectrumConfig(
            sample_rate=44_100,
            n_bits=self.n_symbols * self.coded_bits_per_symbol,
            n_fft=2048,
            hop=512,
            band_lo_hz=800.0,
            band_hi_hz=10_000.0,
            alpha=self.alpha,
            mask_quantile=self.mask_quantile,
        )

    @property
    def sample_rate(self) -> int:
        return 44_100

    @property
    def n_bits(self) -> int:
        """User-facing payload size (data bits; the parity is internal)."""
        return self.n_symbols * self.bits_per_symbol

    @property
    def _core(self) -> SpreadSpectrumWM:
        return SpreadSpectrumWM(cfg=self.cfg, seed=self.seed)

    def default_message(self, batch: int, device: str | torch.device = "cuda") -> torch.Tensor:
        m = torch.tensor(_DEFAULT_MESSAGE[: self.n_symbols], dtype=torch.int32, device=device)
        return m[None, :].repeat(batch, 1)

    def _data_bits(self, msg: torch.Tensor) -> torch.Tensor:
        """(B, k) ints or (B, n_bits) bits -> (B, k, 8) data bits."""
        bits = msg if msg.shape[-1] == self.n_bits else ints_to_bits(msg, self.bits_per_symbol)
        return bits.reshape(bits.shape[0], self.n_symbols, self.bits_per_symbol)

    def embed(self, wav: torch.Tensor, msg: torch.Tensor | None = None, key=None) -> torch.Tensor:
        """`msg` is (B, n_symbols) ints in [0, 256) or (B, n_bits) data bits."""
        if msg is None:
            msg = self.default_message(wav.shape[0], wav.device)
        data = self._data_bits(msg)
        coded = hamming_encode(data) if self.ecc else data
        return self._core.embed(wav, coded.reshape(wav.shape[0], -1))

    def detect(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (presence, corrected DATA bits (B, n_bits)), each symbol decoded
        by soft maximum likelihood over its 12 statistics."""
        core = self._core
        z = core._correlate(wav)  # (B, coded bits)
        presence = core._presence(z)
        if self.ecc:
            data, _ = hamming_soft_decode(z.reshape(z.shape[0], self.n_symbols, _CODED_BITS))
        else:
            data = (z > 0).to(torch.int32)
        return presence, data.reshape(z.shape[0], -1)

    def decode_message(self, wav: torch.Tensor) -> torch.Tensor:
        _, bits = self.detect(wav)
        return bits_to_ints(bits, self.bits_per_symbol)

    def score(self, wav: torch.Tensor, msg: torch.Tensor | None = None) -> torch.Tensor:
        """Exact match: 1.0 iff every symbol decodes correctly."""
        if msg is None:
            msg = self.default_message(wav.shape[0], wav.device)
        want = msg if msg.shape[-1] == self.n_bits else self._data_bits(msg).reshape(-1, self.n_bits)
        _, bits = self.detect(wav)
        sym_got = bits_to_ints(bits, self.bits_per_symbol)
        sym_want = bits_to_ints(want, self.bits_per_symbol)
        return (sym_got == sym_want).all(dim=-1).to(torch.float32)

    def discover_message_length(self, wav: torch.Tensor, max_symbols: int = 64) -> int:
        """How many symbols are embedded, found in one pass: the coded
        symbols that carry payload have mean |z| well above 1, the unused
        pattern slots sit at the N(0, 1) null (the PN patterns are
        prefix-stable).  At the default 64 symbols the detector runs with
        K = 768 patterns."""
        probe = PsychoacousticWM(
            n_symbols=max_symbols, bits_per_symbol=self.bits_per_symbol, seed=self.seed,
            alpha=self.alpha, ecc=self.ecc,
        )
        z = probe._core._correlate(wav).abs()
        per_symbol = z.reshape(z.shape[0], -1, self.coded_bits_per_symbol).mean(dim=(0, 2))
        n = 0
        for live in (per_symbol > 2.0).tolist():
            if not live:
                break
            n += 1
        return n


@register("psychoacoustic")
def _build(n_symbols: int = 5, seed: int = 2) -> PsychoacousticWM:
    return PsychoacousticWM(n_symbols=n_symbols, seed=seed)
