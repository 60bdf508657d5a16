"""The codec-latent (semantic PCA) embed's loss and Adam step from their
definitions, in plain PyTorch and numpy.

The embed optimises a perturbation delta of the chunk-padded clip x:

* axis: the first right singular vector of the centred level-0 codebook
  (float64 SVD); the projections of the level-0 in_proj of the encoder's
  latents on it, in units of the codebook's own projections (mean, and
  population std + 1e-6);
* loss: minus the summed z of the clips over 10, z = mean(s r) /
  (std(r) / sqrt(T') + 1e-9), r the projection track less its centred
  moving average over ma_window frames (edge padding), s the +-1 PN
  sequence ``bernoulli(PRNGKey(pn_seed), 0.5, (T',))``;
* budget: amp = rms(x) 10^(-target_sdr_db / 20) per clip; the mask
  |x| > amp; delta scaled into the L2 ball of radius amp sqrt(T), then
  clamped to +-cap_mult amp;
* a step: the gradient of the loss at x + delta mask, times the mask;
  Adam (betas 0.9 / 0.999, eps 1e-8 outside the square root, both bias
  corrections); the budget;
* after each of n_proj_phases equal phases: |STFT(delta mask)| capped at
  10^(-headroom / 20) |STFT(x)| per bin below proj_free_above_hz (Hann
  1024 / 256), back by the inverse STFT, then the budget;
* the output x + delta mask, cut to the clip's length.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import threefry
from .codec import Codec, pad_to, chunk
from .spread_spectrum import istft, stft


def pca_axis(codebook: torch.Tensor) -> torch.Tensor:
    cb = codebook.detach().cpu().double().numpy()
    _, _, vh = np.linalg.svd(cb - cb.mean(axis=0, keepdims=True), full_matrices=False)
    return torch.as_tensor(vh[0].astype(np.float32), device=codebook.device)


def pn(n: int, seed: int, device) -> torch.Tensor:
    bits = threefry.bernoulli(threefry.prng_key(seed), 0.5, (n,))
    return torch.as_tensor(2.0 * bits.astype(np.float32) - 1.0, device=device)


class Embed:
    """One batch's embed problem: the padded clips, the mask, the budget,
    the PN sequence and the axis, worked out from the clips, the weights
    and the configuration's ``semantic`` block."""

    def __init__(self, codec: Codec, scfg: dict, wav: torch.Tensor):
        self.codec, self.s = codec, scfg
        self.t_in = wav.shape[-1]
        x = pad_to(wav, chunk(codec.cfg))
        self.x = x
        rms = torch.sqrt((x * x).mean(dim=-1, keepdim=True))
        self.amp = rms * 10.0 ** (-scfg["target_sdr_db"] / 20.0)
        self.r2 = self.amp * math.sqrt(x.shape[-1])
        self.cap = scfg["cap_mult"] * self.amp
        self.mask = (x.abs() > self.amp).float()
        cb = codec.w["quantizer.level_0.codebook"]
        self.axis = pca_axis(cb)
        proj = cb @ self.axis
        self.mu, self.sd = proj.mean(), proj.std(correction=0) + 1e-6
        hop = math.prod(codec.cfg["encoder_rates"])
        self.pn = pn(x.shape[-1] // hop, scfg["pn_seed"], x.device)
        self.x_mag = stft(x, 1024, 256).abs()

    def zstat(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, padded T) -> (B,) z of the PN correlation."""
        c = self.codec
        proj = (c.project(c.encode_latent(wav)) @ c.wide(self.axis) - self.mu) / self.sd
        w = self.s["ma_window"]
        padded = F.pad(proj[:, None, :], (w // 2, w // 2), mode="replicate")[:, 0]
        r = proj - padded.unfold(-1, w, 1).mean(dim=-1)
        corr = (r * self.pn).mean(dim=-1)
        return corr / (r.std(dim=-1, correction=0) / math.sqrt(r.shape[-1]) + 1e-9)

    def grad(self, delta: torch.Tensor) -> torch.Tensor:
        """The masked gradient of the loss at `delta`."""
        d = delta.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            loss = -self.zstat(self.x + d * self.mask).sum() / 10.0
            (g,) = torch.autograd.grad(loss, d)
        return g * self.mask

    def budget(self, d: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt((d * d).sum(dim=-1, keepdim=True)) + 1e-12
        d = d * torch.clamp(self.r2 / norm, max=1.0)
        return torch.maximum(torch.minimum(d, self.cap), -self.cap)

    def adam(self, delta, g, m, v, t: int, lr: float):
        """One Adam step from the state after t steps -> (delta, m, v)."""
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        t += 1
        denom = v.sqrt() / math.sqrt(1.0 - 0.999 ** t) + 1e-8
        return delta - lr / (1.0 - 0.9 ** t) * m / denom, m, v

    def projection(self, d: torch.Tensor) -> torch.Tensor:
        spec = stft(d * self.mask, 1024, 256)
        freqs = torch.linspace(0.0, self.codec.cfg["sample_rate"] / 2.0, spec.shape[-1],
                               device=d.device)
        c = 10.0 ** (-self.s["proj_headroom_db"] / 20.0)
        scale = torch.clamp(c * self.x_mag / (spec.abs() + 1e-12), max=1.0)
        scale = torch.maximum(scale, (freqs >= self.s["proj_free_above_hz"]).float())
        return istft(spec * scale, 1024, 256, d.shape[-1])

    def phase_end(self, k: int) -> bool:
        """Whether the projection follows step k (1-based)."""
        n = self.s["steps"] // self.s["n_proj_phases"]
        return k % n == 0

    def after_step(self, delta, g, m, v, t: int, k: int) -> torch.Tensor:
        """Step k from the program's state before it (delta, its masked
        gradient g, Adam's m, v after t steps) -> delta after step k, its
        budget and, at a phase end, the projection and the budget again."""
        d, _, _ = self.adam(delta, g, m, v, t, self.s["lr"])
        d = self.budget(d)
        if self.phase_end(k):
            d = self.budget(self.projection(d))
        return d

    def output(self, delta: torch.Tensor) -> torch.Tensor:
        return (self.x + delta * self.mask)[..., : self.t_in]
