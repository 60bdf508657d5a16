"""Joint training of the neural watermark generator and detector
(``nawc_tpu/train/wm_train.py``).

Recipe: presence cross-entropy per sample (marked and attacked -> 1, clean
-> 0), bit BCE per frame and on time-averaged logits, L1 + multi-scale mel
imperceptibility, and a differentiable attack before the detector: a
round-robin of 12 DSP augmentations by ``step % 12``, or, on the codec
branch, the STE round-trip through a frozen codec, whose lookups run the
nearest-codebook kernel on the card.  Random draws are ``jax.random``'s
(:mod:`..utils.jaxrand`), from the key the JAX trainer would use; the
noise, scale and reverb draws are made on the batch's device
(:mod:`..ops.jaxrand`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..attacks.dsp import lossy_codec_surrogate
from ..dsp.resample import resample, resample_length
from ..models.neural import NeuralWM, init_neural_wm
from ..ops import jaxrand as keyed
from ..utils import jaxrand
from ..utils.config import NeuralWMConfig
from ..utils.padding import fix_length, pad_to_multiple
from .codec_train import MEL_SCALES, mel_l1
from .optim import AdamW

_F32 = np.float32


@dataclasses.dataclass
class WMTrainState:
    wm: NeuralWM
    opt: AdamW
    step: int


def _bce_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean of ``optax.sigmoid_binary_cross_entropy``, in its form: its
    gradient takes sigmoid(-x) where ``binary_cross_entropy_with_logits``
    takes sigmoid(x) - 1, which cancels for confident logits."""
    return torch.mean(-target * F.logsigmoid(logits) - (1 - target) * F.logsigmoid(-logits))


def _pow2_fft(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    nfft = 1 << (w.shape[-1] - 1).bit_length()
    return torch.fft.rfft(w, n=nfft, dim=-1), nfft


def _diff_attack(wav: torch.Tensor, key: np.ndarray, step: int, sev: np.float32) -> torch.Tensor:
    """Round-robin differentiable augmentation by ``step % 12`` with a
    severity curriculum (`sev` ramps 0 -> 1): none / gaussian noise /
    smoothing / amplitude scale / time roll / quantisation (STE) / fft
    lowpass / reverb / lossy-codec surrogate / rate warp / phase rotation /
    fft highpass.  `key` is split in 4 as the JAX trainer splits it."""
    k1, k2, k3, k4 = jaxrand.split(key, 4)
    dev = wav.device
    sev = _F32(sev)

    def none(w):
        return w

    def noise(w):
        return w + float(1e-3 + 4e-3 * sev) * keyed.normal(k1, w.shape, dev)

    def smooth(w):
        f = w.reshape(-1, 1, w.shape[-1])
        out = F.conv1d(f, torch.full((1, 1, 9), 1.0 / 9.0, device=dev), padding=4)
        return w + float(sev) * (out.reshape(w.shape) - w)

    def scale(w):
        lo, hi = _F32(1.0) - _F32(0.4) * sev, _F32(1.0) + _F32(0.4) * sev
        return w * keyed.uniform(k2, (w.shape[0], 1), dev, lo, hi)

    def roll(w):
        return torch.roll(w, int(jaxrand.randint(k3, (), -400, 400)), dims=-1)

    def quantize(w):
        levels = float(_F32(512.0) - _F32(384.0) * sev)  # anneals 512 -> 128
        q = torch.round(w * levels) / levels
        return w + (q - w).detach()  # STE through the rounding

    def fft_lowpass(w):
        f, nfft = _pow2_fft(w)
        n = f.shape[-1]
        cut = float((_F32(1.0) - _F32(0.5) * sev) * _F32(n))
        ramp = torch.arange(n, device=dev, dtype=torch.float32)[None, :]
        mask = torch.sigmoid((cut - ramp) / (0.02 * n))
        return torch.fft.irfft(f * mask, n=nfft, dim=-1)[..., : w.shape[-1]]

    def phase_rot(w):
        f, nfft = _pow2_fft(w)
        phi = sev * jaxrand.uniform(k2, (), -1.5, 1.5)
        rot = torch.complex(torch.tensor(np.cos(phi), device=dev), torch.tensor(np.sin(phi), device=dev))
        return torch.fft.irfft(f * rot, n=nfft, dim=-1)[..., : w.shape[-1]]

    def warp(w):
        t = w.shape[-1]
        rate = float(_F32(1.0) + _F32(0.02) * sev * jaxrand.uniform(k3, (), -1.0, 1.0))
        pos = torch.clamp(torch.arange(t, device=dev, dtype=torch.float32) * rate, 0.0, float(_F32(t - 1.001)))
        i0 = torch.clamp(torch.floor(pos).to(torch.int64), max=t - 2)
        frac = torch.clamp(pos - i0.float(), 0.0, 1.0)
        return w[..., i0] * (1 - frac) + w[..., i0 + 1] * frac

    def reverb(w):
        t = torch.arange(400, device=dev, dtype=torch.float32)
        ir = keyed.normal(k4, (400,), dev) * torch.exp(-t / 80.0)
        ir[0] = float(_F32(1.0) / (_F32(0.15) * sev + _F32(1e-3)))
        ir = ir / torch.sqrt(torch.sum(ir * ir))
        f = F.pad(w.reshape(-1, 1, w.shape[-1]), (199, 200))  # SAME for 400 taps
        out = F.conv1d(f, ir.reshape(1, 1, -1))
        return out.reshape(w.shape)

    def codec_surrogate(w):
        sr = 16_000
        return lossy_codec_surrogate(w, sr, bandwidth_hz=float((_F32(0.95) - _F32(0.15) * sev) * _F32(sr / 2)),
                                     step_db=float(_F32(4.5) * sev + _F32(0.25)))

    def fft_highpass(w):
        f, nfft = _pow2_fft(w)
        n = f.shape[-1]
        cut = float(sev * _F32(750.0 / 8000.0) * _F32(n))
        ramp = torch.arange(n, device=dev, dtype=torch.float32)[None, :]
        mask = torch.sigmoid((ramp - cut) / (0.005 * n))
        return torch.fft.irfft(f * mask, n=nfft, dim=-1)[..., : w.shape[-1]]

    fns = [none, noise, smooth, scale, roll, quantize, fft_lowpass, reverb,
           codec_surrogate, warp, phase_rot, fft_highpass]
    return fns[step % len(fns)](wav)


def codec_roundtrip_attack(codec, wav: torch.Tensor, sev) -> torch.Tensor:
    """Differentiable neural-codec round-trip: resample -> pad -> encode ->
    STE quantise -> decode -> resample back.  Gradients reach the input
    through the straight-through quantiser."""
    sr_in, sr_c = 16_000, codec.cfg.sample_rate
    x = pad_to_multiple(resample(wav, sr_in, sr_c), codec.cfg.chunk, axis=-1)
    rt = codec.roundtrip(x)
    y = resample(rt[..., : resample_length(wav.shape[-1], sr_in, sr_c)], sr_c, sr_in)
    return wav + float(sev) * (fix_length(y, wav.shape[-1]) - wav)


def severity(step: int) -> np.float32:
    """The attack-strength curriculum: mild for 2k steps, full by 10k."""
    return _F32(np.clip((_F32(step) - _F32(2000.0)) / _F32(8000.0), 0.0, 1.0))


def wm_loss(cfg: NeuralWMConfig, wm: NeuralWM, wav: torch.Tensor, msg: torch.Tensor,
            key: np.ndarray, step: int, codec=None):
    """-> (scalar loss, metrics dict) of one joint step."""
    delta = wm.gen(wav, msg)
    marked = wav + cfg.alpha * delta
    sev = severity(step)
    attacked = (codec_roundtrip_attack(codec, marked, sev) if codec is not None
                else _diff_attack(marked, key, step, sev))
    lg_att, lg_marked, lg_clean = wm.det(attacked), wm.det(marked), wm.det(wav)

    # presence: per-sample 2-class CE (attacked counts as present)
    ce_marked = F.cross_entropy(lg_att[..., :2].reshape(-1, 2),
                                torch.ones(lg_att.shape[0] * lg_att.shape[1], dtype=torch.long,
                                           device=wav.device))
    ce_clean = F.cross_entropy(lg_clean[..., :2].reshape(-1, 2),
                               torch.zeros(lg_clean.shape[0] * lg_clean.shape[1], dtype=torch.long,
                                           device=wav.device))
    # bits: per-frame supervision plus the pooled decode-time statistic, on
    # the marked and the attacked channels
    tgt = msg.float()[:, None, :]
    bit_frame = 0.5 * (_bce_logits(lg_att[..., 2:], tgt) + _bce_logits(lg_marked[..., 2:], tgt))
    bit_logits = lg_att[..., 2:].mean(dim=-2)
    bit_pool = 0.5 * (_bce_logits(bit_logits, tgt[:, 0])
                      + _bce_logits(lg_marked[..., 2:].mean(dim=-2), tgt[:, 0]))
    bit_loss = bit_pool + bit_frame

    l1 = torch.mean(torch.abs(marked - wav))
    mel_l = mel_l1(wav, marked, cfg.sample_rate, MEL_SCALES[:2])
    # the perceptual weight ramps in over the first 1k steps
    pw = float(min(_F32(step) / _F32(1000.0), _F32(1.0)))
    loss = ce_marked + ce_clean + 3.0 * bit_loss + pw * (0.5 * mel_l + 5.0 * l1)

    bit_acc = torch.mean(((bit_logits > 0).to(torch.int32) == msg).float())
    metrics = {"loss": loss, "ce_marked": ce_marked, "ce_clean": ce_clean,
               "bit_loss": bit_loss, "bit_acc": bit_acc, "mel": mel_l, "l1": l1,
               "sev": torch.tensor(float(sev)), "delta_rms": torch.sqrt(torch.mean(delta**2))}
    return loss, metrics


def init_wm_train(seed: int, cfg: NeuralWMConfig, lr: float = 2e-4, weight_decay: float = 1e-5,
                  device: str | torch.device = "cuda", **opt_kwargs) -> WMTrainState:
    """JAX's ``init_wm_train(PRNGKey(seed), cfg, tx)`` with ``cli/train_wm.py``'s
    ``tx``: clip 1.0, then AdamW at a constant `lr` (betas 0.9, 0.999)."""
    wm = init_neural_wm(seed, cfg, device)
    wm.gen.requires_grad_(True)
    wm.det.requires_grad_(True)
    params = list(wm.gen.parameters()) + list(wm.det.parameters())
    return WMTrainState(wm, AdamW(params, lr, weight_decay=weight_decay, **opt_kwargs), 0)


def make_wm_train_step(cfg: NeuralWMConfig, codec=None):
    """-> step(state, wav, msg, key, step) -> metrics: one joint update of
    ``state`` in place; with `codec` the attack channel is the codec
    round-trip (``cli/train_wm.py`` alternates the two)."""

    def step_fn(state: WMTrainState, wav: torch.Tensor, msg: torch.Tensor, key: np.ndarray,
                step: int) -> dict:
        state.opt.zero_grad()
        loss, metrics = wm_loss(cfg, state.wm, wav, msg, key, step, codec)
        loss.backward()
        state.opt.step()
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step_fn
