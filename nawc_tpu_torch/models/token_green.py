"""Green-list token watermark (``nawc_tpu/models/token_green.py``): bias the
codec's level-0 tokens toward a keyed half of the codebook.

A seed-42 ``jax.random.permutation`` splits the vocabulary in half (the
green list).  The embed optimises a silence-masked waveform delta with Adam
so that every frame's projected latent is nearer (in cosine) to its best
green code than to its best red one, by a margin; the budget is the
semantic family's L2 ball and peak cap.  Detect encodes to codes with the
fused residual-VQ kernel (``codec.encode``) and calibrates the green ratio
against 64 wrong-key splits of the same codes.

Like the semantic embed, the embed opens ``torch.enable_grad()`` itself and
runs its steps as one loop (JAX's ``max_steps_per_dispatch`` is a TPU crash
workaround).  Its cosine scores against all codes are a plain ``torch``
product, as in JAX, where they are outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..codec.api import CodecState
from ..utils import jaxrand
from ..utils.padding import pad_to_multiple
from .base import register


def green_mask(vocab_size: int, seed: int = 42, device: str | torch.device = "cpu") -> torch.Tensor:
    """(vocab,) bool: the first half of ``jax.random.permutation(PRNGKey(seed),
    vocab)`` is green."""
    mask = np.zeros(vocab_size, bool)
    mask[jaxrand.permutation(jaxrand.prng_key(seed), vocab_size)[: vocab_size // 2]] = True
    return torch.as_tensor(mask, device=device)


@functools.lru_cache(maxsize=8)
def _null_mask_matrix(vocab_size: int, seed: int, k: int = 64) -> np.ndarray:
    """(k, vocab) float32 numpy matrix of wrong-key half splits, the
    permutation null of the detection z (numpy ``default_rng``, as in JAX)."""
    rows = np.zeros((k, vocab_size), np.float32)
    for i in range(k):
        rng = np.random.default_rng(1_000_003 * (seed + 1) + i)
        rows[i, rng.permutation(vocab_size)[: vocab_size // 2]] = 1.0
    return rows


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-8)


def _projected(codec: CodecState, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T', codebook_dim): level 0's in_proj of the latents."""
    return codec.project_latent(codec.encode_latent(wav))


def _hinge_loss(codec: CodecState, mask: torch.Tensor, margin: float, x: torch.Tensor,
                silence: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Mean over frames of relu(margin - (best green - best red cosine))."""
    sims = _normalize(_projected(codec, x + delta * silence)) @ _normalize(
        codec.projected_codebook).T  # (B, T', K)
    low = torch.full_like(sims, -2.0)
    best_green = torch.where(mask, sims, low).amax(dim=-1)
    best_red = torch.where(mask, low, sims).amax(dim=-1)
    return torch.relu(margin - (best_green - best_red)).mean()


def green_embed(codec: CodecState, mask: torch.Tensor, wav: torch.Tensor, steps: int = 300,
                lr: float = 5e-3, target_sdr_db: float = 31.0, margin: float = 0.1) -> torch.Tensor:
    """Push every frame's projected latent across the green/red boundary
    with margin, under the target-SDR L2 ball and a peak cap of 6 amp."""
    x = pad_to_multiple(wav.detach(), codec.cfg.chunk, axis=-1)
    rms = torch.sqrt((x * x).mean(dim=-1, keepdim=True))
    amp = rms * 10.0 ** (-target_sdr_db / 20.0)
    r2 = amp * np.float32(np.sqrt(x.shape[-1]))
    cap = 6.0 * amp
    silence = (x.abs() > amp).to(x.dtype)
    mask = mask.to(x.device)

    delta = torch.zeros_like(x, requires_grad=True)
    opt = torch.optim.Adam([delta], lr=lr)
    with torch.enable_grad():
        for _ in range(steps):
            opt.zero_grad()
            _hinge_loss(codec, mask, margin, x, silence, delta).backward()
            delta.grad.mul_(silence)
            opt.step()
            with torch.no_grad():
                norm = torch.sqrt((delta * delta).sum(dim=-1, keepdim=True)) + 1e-12
                delta.copy_(torch.clamp(delta * torch.clamp(r2 / norm, max=1.0), -cap, cap))
    return (x + delta.detach() * silence)[..., : wav.shape[-1]]


@dataclasses.dataclass(frozen=True)
class TokenGreenWM:
    """Presence-only token-space watermark.  score = z / 4 of the green
    ratio against its permutation null."""

    codec: CodecState
    seed: int = 42
    steps: int = 300
    lr: float = 5e-3
    target_sdr_db: float = 31.0
    margin: float = 0.1
    name: str = "token_green"
    n_bits: int = 0

    @property
    def sample_rate(self) -> int:
        return self.codec.cfg.sample_rate

    @property
    def mask(self) -> torch.Tensor:
        return green_mask(self.codec.cfg.codebook_size, self.seed, self.codec.device)

    def embed(self, wav: torch.Tensor, msg=None, key=None) -> torch.Tensor:
        return green_embed(self.codec, self.mask, wav, steps=self.steps, lr=self.lr,
                           target_sdr_db=self.target_sdr_db, margin=self.margin)

    def _codes(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T0) level-0 codes, by the fused residual-VQ kernel."""
        return self.codec.encode(pad_to_multiple(wav, self.codec.cfg.chunk, axis=-1))[0].long()

    def green_ratio(self, wav: torch.Tensor) -> torch.Tensor:
        """The reference's raw statistic: the green share of level-0 codes."""
        return self.mask[self._codes(wav)].float().mean(dim=-1)

    def score(self, wav: torch.Tensor, msg=None) -> torch.Tensor:
        """z / 4 of the green ratio against the clip's own 64 wrong-key
        ratios (population std, floored at the iid binomial sd)."""
        codes = self._codes(wav)
        r_true = self.mask[codes].float().mean(dim=-1)
        nm = torch.as_tensor(_null_mask_matrix(self.codec.cfg.codebook_size, self.seed),
                             device=codes.device)
        r_null = nm[:, codes].mean(dim=-1)  # (K, B)
        mu = r_null.mean(dim=0)
        sd_floor = 0.5 * torch.rsqrt(torch.tensor(float(codes.shape[-1]), device=codes.device))
        sd = torch.maximum(r_null.std(dim=0, correction=0), sd_floor)
        return (r_true - mu) / sd / 4.0

    def detect(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        presence = torch.sigmoid(12.0 * (self.score(wav) - 0.75))
        return presence, torch.zeros((wav.shape[0], 0), dtype=torch.int32, device=wav.device)


@register("token_green")
def _build(codec: CodecState, seed: int = 42) -> TokenGreenWM:
    return TokenGreenWM(codec, seed)
