"""Adversarial (HiFi-GAN-style) fine-tune of the codec DECODER
(``nawc_tpu/train/adversarial.py``).

Only the decoder moves: the encoder, projections and codebooks are the host
space of the semantic watermarks and must not (the JAX trainer pins their
updates to zero with ``optax.multi_transform``; here they are not given to
the optimiser and their gradients stay off).  Multi-period (2/3/5/7/11) and
multi-scale (x1/x2/x4) discriminators with LSGAN losses and feature
matching; one step updates D, then G against the updated D.  Both codec
round-trips of a step run the nearest-codebook kernel on the card.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..codec.convert import flax_init_tree, flax_to_state_dict
from ..codec.layers import SameConv1d
from ..codec.model import SnacCodec
from ..utils import jaxrand
from ..utils.config import CodecConfig
from ..utils.device import resolve_device
from ..eval.metrics import si_snr
from .codec_train import mel_l1, multires_stft_loss
from .optim import AdamW

PERIODS = (2, 3, 5, 7, 11)
SCALES = (1, 2, 4)
_PAD_MULTIPLE = 4620  # lcm(2, 3, 5, 7, 11, 4): every reshape/pool is exact


def _leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """flax's ``leaky_relu(x, 0.1)``: slope 1 at x = 0, where
    ``F.leaky_relu`` takes 0.1 (the zero padding of a period view meets
    zero biases exactly there)."""
    return torch.where(x >= 0, x, 0.1 * x)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax's "SAME" padding, per spatial axis."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(reversed(x.shape[-2:]), reversed(self.kernel_size), reversed(self.stride)):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        return F.conv2d(F.pad(x, pads), self.weight, self.bias, self.stride)


class PeriodDiscriminator(nn.Module):
    """Views the waveform as a (T/p, p) image; convs stride over time only."""

    def __init__(self, period: int):
        super().__init__()
        self.period = period
        dims = (1, 16, 64, 256, 256)
        for i in range(4):
            self.add_module(f"Conv_{i}", SameConv2d(dims[i], dims[i + 1], (5, 1), stride=(3, 1)))
        self.Conv_4 = SameConv2d(256, 1, (3, 1))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        b, t = x.shape
        h = x.reshape(b, 1, t // self.period, self.period)
        feats = []
        for i in range(4):
            h = _leaky_relu(getattr(self, f"Conv_{i}")(h))
            feats.append(h)
        return self.Conv_4(h).reshape(b, -1), feats


class ScaleDiscriminator(nn.Module):
    """1-D grouped-conv discriminator over a (possibly pooled) waveform."""

    LAYERS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16), (256, 5, 1, 1))

    def __init__(self):
        super().__init__()
        in_dim = 1
        for i, (dim, k, s, g) in enumerate(self.LAYERS):
            self.add_module(f"Conv_{i}", SameConv1d(in_dim, dim, k, stride=s, groups=g))
            in_dim = dim
        self.Conv_4 = SameConv1d(256, 1, 3)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, list[torch.Tensor]]:
        h = x[:, None, :]
        feats = []
        for i in range(4):
            h = _leaky_relu(getattr(self, f"Conv_{i}")(h))
            feats.append(h)
        return self.Conv_4(h).reshape(x.shape[0], -1), feats


def _avg_pool_same(x: torch.Tensor, s: int) -> torch.Tensor:
    """flax ``avg_pool(x, (s,), (s,), "SAME")`` over time; padding counts."""
    t = x.shape[-1]
    total = max((-(-t // s) - 1) * s + s - t, 0)
    return F.avg_pool1d(F.pad(x[:, None, :], (total // 2, total - total // 2)), s, s)[:, 0]


class Discriminators(nn.Module):
    """All MPD + MSD heads; returns per-head (logits, feature list)."""

    def __init__(self):
        super().__init__()
        for p in PERIODS:
            self.add_module(f"mpd_{p}", PeriodDiscriminator(p))
        for s in SCALES:
            self.add_module(f"msd_{s}", ScaleDiscriminator())

    def forward(self, x: torch.Tensor) -> list[tuple[torch.Tensor, list[torch.Tensor]]]:
        outs = [getattr(self, f"mpd_{p}")(x) for p in PERIODS]
        for s in SCALES:
            outs.append(getattr(self, f"msd_{s}")(_avg_pool_same(x, s) if s > 1 else x))
        return outs


def pad_for_periods(t: int) -> int:
    """Smallest length >= t divisible by every period view and scale pool."""
    return -(-t // _PAD_MULTIPLE) * _PAD_MULTIPLE


def d_loss_fn(outs_real, outs_fake) -> torch.Tensor:
    """LSGAN discriminator loss: (D(x)-1)^2 + D(G)^2, averaged over heads."""
    total = 0.0
    for (lr_, _), (lf_, _) in zip(outs_real, outs_fake):
        total = total + torch.mean((lr_ - 1.0) ** 2) + torch.mean(lf_**2)
    return total / len(outs_real)


def g_adv_loss_fn(outs_fake) -> torch.Tensor:
    """LSGAN generator loss: (D(G)-1)^2 averaged over heads."""
    total = 0.0
    for lf_, _ in outs_fake:
        total = total + torch.mean((lf_ - 1.0) ** 2)
    return total / len(outs_fake)


def feature_match_fn(outs_real, outs_fake) -> torch.Tensor:
    """L1 between real-input and generated-input conv taps, every head."""
    total, n = 0.0, 0
    for (_, fr), (_, ff) in zip(outs_real, outs_fake):
        for a, b in zip(fr, ff):
            total = total + torch.mean(torch.abs(a - b))
            n += 1
    return total / max(n, 1)


def decoder_only_mask(model: SnacCodec) -> dict[str, bool]:
    """Parameter name -> True for the decoder's, False for the encoder's and
    the quantizer's (the semantic-watermark host space must not move)."""
    return {name: name.split(".")[0] == "decoder" for name, _ in model.named_parameters()}


def decoder_only_tx(model: SnacCodec, **adamw_kwargs) -> AdamW:
    """``decoder_only_tx(chain(clip, adamw), params)``: an optimiser over the
    decoder's parameters only, with the gradients of the rest turned off, so
    their update is exactly zero and no clipping or decay reaches them."""
    mask = decoder_only_mask(model)
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    return AdamW([p for name, p in model.named_parameters() if mask[name]], **adamw_kwargs)


def init_discriminators(seed: int, device: str | torch.device = "cuda") -> Discriminators:
    """JAX's ``init_discriminators(PRNGKey(seed), example_len)``."""
    disc = Discriminators()
    disc.load_state_dict(flax_to_state_dict(flax_init_tree(disc, jaxrand.prng_key(seed)), disc),
                         strict=True)
    return disc.to(resolve_device(device))


def recon_losses(cfg: CodecConfig, wav: torch.Tensor, recon: torch.Tensor,
                 sisnr_weight: float) -> tuple[torch.Tensor, dict]:
    """The decoder-relevant subset of ``codec_train.codec_loss``."""
    l1 = torch.mean(torch.abs(recon - wav))
    mel_l = mel_l1(wav, recon, cfg.sample_rate)
    stft_l = multires_stft_loss(wav, recon)
    sisnr = si_snr(wav, recon).mean()
    loss = l1 + mel_l + stft_l - sisnr_weight * sisnr
    return loss, {"l1": l1, "mel": mel_l, "stft": stft_l, "si_snr": sisnr}


def make_gan_train_step(cfg: CodecConfig, sisnr_weight: float = 0.05, adv_weight: float = 1.0,
                        fm_weight: float = 2.0):
    """-> step(codec, disc, g_opt, d_opt, wav) -> metrics: the D update,
    then the decoder update against the updated D, in place.  `g_opt`
    comes from :func:`decoder_only_tx`."""

    def step(codec: SnacCodec, disc: Discriminators, g_opt: AdamW, d_opt: AdamW,
             wav: torch.Tensor) -> dict:
        pad = pad_for_periods(wav.shape[-1]) - wav.shape[-1]
        real = F.pad(wav, (0, pad))

        # discriminator update (no generator gradients)
        with torch.no_grad():
            fake0 = F.pad(codec.roundtrip(wav), (0, pad))
        d_opt.zero_grad()
        d_l = d_loss_fn(disc(real), disc(fake0))
        d_l.backward()
        d_opt.step()

        # generator (decoder) update against the updated discriminator
        disc.requires_grad_(False)
        try:
            with torch.no_grad():
                outs_real = disc(real)
            g_opt.zero_grad()
            recon = codec.roundtrip(wav)
            rec_loss, metrics = recon_losses(cfg, wav, recon, sisnr_weight)
            outs_fake = disc(F.pad(recon, (0, pad)))
            adv = g_adv_loss_fn(outs_fake)
            fm = feature_match_fn(outs_real, outs_fake)
            loss = rec_loss + adv_weight * adv + fm_weight * fm
            loss.backward()
            g_opt.step()
        finally:
            disc.requires_grad_(True)
        metrics = dict(metrics, adv=adv, fm=fm, d_loss=d_l, loss=loss)
        return {k: v.detach() for k, v in metrics.items()}

    return step
