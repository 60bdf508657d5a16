"""Trainable neural additive watermark: a conv generator and a frame-wise
conv detector (``nawc_tpu/models/neural.py``, the AudioSeal-capability
analogue).

The generator maps (wav, msg) to an additive delta: conv encoder ->
bottleneck plus a message embedding -> transposed-conv decoder.  The
detector maps wav to per-sample (2 + n_bits) logits: conv encoder ->
repeat-upsample -> convs.  Convolutions run in (B, C, T); the public
methods keep the JAX package's layouts, (B, T) waveforms and (B, T, 2 + n)
logits.  Submodules are named as flax names them, so a flax tree maps onto
the modules by path (``codec/convert.py``) and back.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..codec.convert import flax_init_tree, flax_to_state_dict, state_dict_to_flax
from ..codec.layers import SameConv1d, SameConvTranspose1d, Snake
from ..utils import flaxinit, jaxrand
from ..utils.checkpoint import load_params
from ..utils.config import NeuralWMConfig
from ..utils.device import resolve_device
from .base import register


class _ConvBlock(nn.Module):
    def __init__(self, in_dim: int, dim: int, stride: int):
        super().__init__()
        self.Snake_0 = Snake(in_dim)
        self.Conv_0 = SameConv1d(in_dim, dim, 2 * stride, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(self.Snake_0(x))


class _DeconvBlock(nn.Module):
    def __init__(self, in_dim: int, dim: int, stride: int):
        super().__init__()
        self.Snake_0 = Snake(in_dim)
        self.ConvTranspose_0 = SameConvTranspose1d(in_dim, dim, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ConvTranspose_0(self.Snake_0(x))


def _encoder(module: nn.Module, cfg: NeuralWMConfig) -> int:
    """Adds ``Conv_0`` and the ``_ConvBlock_i`` of the down path -> width."""
    module.Conv_0 = SameConv1d(1, cfg.dim, 7)
    dim = cfg.dim
    for i, s in enumerate(cfg.strides):
        module.add_module(f"_ConvBlock_{i}", _ConvBlock(dim, dim * 2, s))
        dim *= 2
    return dim


class WMGenerator(nn.Module):
    """(wav (B, T), msg (B, n_bits)) -> additive delta (B, T)."""

    def __init__(self, cfg: NeuralWMConfig):
        super().__init__()
        self.n_down = len(cfg.strides)
        dim = _encoder(self, cfg)
        self.Conv_1 = SameConv1d(dim, cfg.bottleneck_dim, 3)
        # one embedding per (bit, value), summed and broadcast over time
        self.msg_embedding = nn.Parameter(torch.zeros(cfg.n_bits, 2, cfg.bottleneck_dim))
        in_dim = cfg.bottleneck_dim
        for i, s in enumerate(reversed(cfg.strides)):
            dim //= 2
            self.add_module(f"_DeconvBlock_{i}", _DeconvBlock(in_dim, dim, s))
            in_dim = dim
        self.Snake_0 = Snake(dim)
        self.Conv_2 = SameConv1d(dim, 1, 7)  # zero at init: the mark starts silent

    def forward(self, wav: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(wav[:, None, :])
        for i in range(self.n_down):
            h = getattr(self, f"_ConvBlock_{i}")(h)
        h = self.Conv_1(h)
        n_bits = self.msg_embedding.shape[0]
        bit = torch.arange(n_bits, device=msg.device)
        msg_vec = self.msg_embedding[bit[None, :], msg.long()].sum(dim=1)  # (B, D)
        h = h + msg_vec[:, :, None]
        for i in range(self.n_down):
            h = getattr(self, f"_DeconvBlock_{i}")(h)
        delta = self.Conv_2(self.Snake_0(h))[:, 0]
        return delta[:, : wav.shape[-1]]


class WMDetector(nn.Module):
    """wav (B, T) -> per-sample logits (B, T, 2 + n_bits): channels 0:2 are
    absent/present (softmax), 2: the bit logits."""

    def __init__(self, cfg: NeuralWMConfig):
        super().__init__()
        self.n_down = len(cfg.strides)
        self.total = int(np.prod(cfg.strides))
        dim = _encoder(self, cfg)
        self.Snake_0 = Snake(dim)
        self.Conv_1 = SameConv1d(dim, cfg.bottleneck_dim, 3)
        self.Conv_2 = SameConv1d(cfg.bottleneck_dim, cfg.bottleneck_dim // 2, 7)
        self.Snake_1 = Snake(cfg.bottleneck_dim // 2)
        self.Conv_3 = SameConv1d(cfg.bottleneck_dim // 2, 2 + cfg.n_bits, 3)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(wav[:, None, :])
        for i in range(self.n_down):
            h = getattr(self, f"_ConvBlock_{i}")(h)
        h = self.Conv_1(self.Snake_0(h))
        # upsample back to the sample rate (repeat, then refine)
        h = torch.repeat_interleave(h, self.total, dim=-1)[..., : wav.shape[-1]]
        h = self.Conv_3(self.Snake_1(self.Conv_2(h)))
        return h.transpose(1, 2)


def presence_prob(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, 2+n) -> (B,) mean class-1 probability (reference semantic)."""
    return torch.softmax(logits[..., :2], dim=-1)[..., 1].mean(dim=-1)


def decode_bits(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, 2+n) -> (B, n) hard bits from time-averaged logits."""
    return (logits[..., 2:].mean(dim=-2) > 0).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class NeuralWM:
    """Watermarker API over a generator and a detector.

    Embed and detect run on windows of ``cfg.window`` samples (the training
    length): the generator's message pattern lives on its 320-sample stride
    lattice, so both sides cut the stream at the same window boundaries.
    Presence is lattice-free and averages over everything."""

    cfg: NeuralWMConfig
    gen: WMGenerator
    det: WMDetector
    name: str = "neural"

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def n_bits(self) -> int:
        return self.cfg.n_bits

    def _chunk(self, wav: torch.Tensor) -> tuple[torch.Tensor, int]:
        """(B, T) -> (B * nc, W) zero-padded windows."""
        b, t = wav.shape
        w = self.cfg.window
        nc = max(1, -(-t // w))
        return F.pad(wav, (0, nc * w - t)).reshape(b * nc, w), nc

    def embed(self, wav: torch.Tensor, msg: torch.Tensor, key=None) -> torch.Tensor:
        b, t = wav.shape
        x, nc = self._chunk(wav)
        delta = self.gen(x, torch.repeat_interleave(msg, nc, dim=0))
        marked = torch.clamp(x + self.cfg.alpha * delta, -1.0, 1.0)
        return marked.reshape(b, nc * self.cfg.window)[:, :t]

    def logits(self, wav: torch.Tensor) -> torch.Tensor:
        """Whole-input detector logits (B, T, 2+n), anchored at sample 0."""
        return self.det(wav)

    def detect(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Polarity-invariant detect: the additive delta flips sign with the
        waveform, so both polarities run and each clip keeps the one with
        the higher presence."""
        pres_p, bits_p, _ = self._detect_one(wav)
        pres_n, bits_n, _ = self._detect_one(-wav)
        use_n = pres_n > pres_p
        return torch.where(use_n, pres_n, pres_p), torch.where(use_n[:, None], bits_n, bits_p)

    def _detect_one(self, wav: torch.Tensor):
        b, t = wav.shape
        w = self.cfg.window
        x, nc = self._chunk(wav)
        lg = self.det(x)  # (b*nc, W, 2+n)
        # mask the padding so that silence in the last window does not vote
        valid = (torch.arange(nc * w, device=wav.device) < t).reshape(nc, w)
        valid = valid.repeat(b, 1)[..., None].to(lg.dtype)  # (b*nc, W, 1)
        lg = lg * valid
        n_valid = torch.clamp(valid.sum(dim=(1, 2)), min=1.0)[:, None]
        pres = torch.softmax(lg[..., :2], dim=-1)[..., 1]
        v = valid[..., 0].reshape(b, -1)
        pres = (pres * valid[..., 0]).reshape(b, -1).sum(-1) / torch.clamp(v.sum(-1), min=1.0)
        # per-window mean bit logits, summed over windows (soft majority)
        bl = lg[..., 2:].sum(dim=-2) / n_valid
        bl_sum = bl.reshape(b, nc, -1).sum(dim=1)
        return pres, (bl_sum > 0).to(torch.int32), bl_sum

    def score(self, wav: torch.Tensor, msg: torch.Tensor | None = None) -> torch.Tensor:
        """Mean presence probability (AudioSeal's semantic); differentiable."""
        return presence_prob(self.logits(wav))

    def detect_sync(self, wav: torch.Tensor, step: int = 8, group: int = 4):
        """Shift-robust detect: search the generator's stride-lattice phase.

        Candidates are both parities stepped by `step` within the 320-sample
        period, times both polarities (160 by default), scored on the first
        window by the mean |pooled bit logit|, `group` candidates per
        detector call.  A sign moves off offset 0 only where its best
        candidate stands 2.5 standard deviations above the mean of all
        candidates; then the full detector runs once per sign at the chosen
        offset, and each clip keeps the sign with the higher presence.

        Returns (presence, bits, best_offset_samples)."""
        b, t = wav.shape
        period = int(np.prod(self.cfg.strides))
        offsets = np.sort(np.concatenate([np.arange(0, period, step, dtype=np.int32),
                                          np.arange(1, period, step, dtype=np.int32)]))
        w = self.cfg.window
        prefix = wav[:, :w] if t >= w else F.pad(wav, (0, w - t))
        cand_off = np.concatenate([offsets] * 2)
        cand_sign = np.concatenate([np.ones(len(offsets), np.float32),
                                    -np.ones(len(offsets), np.float32)])
        confs = []
        for g in range(0, len(cand_off), group):
            x = torch.stack([float(s) * torch.roll(prefix, -int(o), dims=-1)
                             for o, s in zip(cand_off[g:g + group], cand_sign[g:g + group])])
            bl = self.det(x.reshape(-1, w))[..., 2:].mean(dim=-2).reshape(x.shape[0], b, -1)
            confs.append(bl.abs().mean(dim=-1))
        confs = torch.cat(confs)  # (C, B)
        half = len(offsets)
        offs = torch.as_tensor(offsets, device=wav.device, dtype=torch.int64)
        mu = confs.mean(dim=0)
        sd = confs.std(dim=0, correction=0) + 1e-9

        def pick(conf_s):  # (half, B) -> gated best offset (B,)
            best = torch.argmax(conf_s, dim=0)
            peak_z = (conf_s.max(dim=0).values - mu) / sd
            return torch.where(peak_z >= 2.5, offs[best], torch.zeros_like(best))

        off_p, off_n = pick(confs[:half]), pick(confs[half:])

        def realign(off):
            idx = (torch.arange(t, device=wav.device)[None, :] + off[:, None]) % t
            return torch.gather(wav, -1, idx)

        pres_p, bits_p, _ = self._detect_one(realign(off_p))
        pres_n, bits_n, _ = self._detect_one(-realign(off_n))
        use_n = pres_n > pres_p
        return (torch.where(use_n, pres_n, pres_p), torch.where(use_n[:, None], bits_n, bits_p),
                torch.where(use_n, off_n, off_p))


def init_trees(seed: int, cfg: NeuralWMConfig = NeuralWMConfig()) -> tuple[dict, dict]:
    """-> the (generator, detector) flax trees that the JAX package's
    ``init_neural_wm(jax.random.PRNGKey(seed), cfg)`` draws: LeCun kernels,
    zero biases and Snake alphas, ``normal(0.02)`` message embedding, the
    generator's output conv zero."""
    kg, kd = jaxrand.split(jaxrand.prng_key(seed))

    def embedding(path, mod):
        if isinstance(mod, WMGenerator):
            emb = jaxrand.normal(flaxinit.param_key(kg, path), tuple(mod.msg_embedding.shape))
            return {"msg_embedding": emb * np.float32(0.02)}
        return None

    gen = flax_init_tree(WMGenerator(cfg), kg, zero_kernels={("Conv_2",)}, own=embedding)
    return gen, flax_init_tree(WMDetector(cfg), kd)


def neural_from_flax(gen_tree: dict, det_tree: dict, cfg: NeuralWMConfig = NeuralWMConfig(),
                     device: str | torch.device = "cuda") -> NeuralWM:
    """A NeuralWM whose weights are converted from flax variables trees.
    The weights are frozen; a trainer turns their gradients back on."""
    dev = resolve_device(device)
    gen, det = WMGenerator(cfg), WMDetector(cfg)
    gen.load_state_dict(flax_to_state_dict(gen_tree, gen), strict=True)
    det.load_state_dict(flax_to_state_dict(det_tree, det), strict=True)
    return NeuralWM(cfg, gen.to(dev).requires_grad_(False), det.to(dev).requires_grad_(False))


def neural_to_flax(wm: NeuralWM) -> dict:
    """-> the ``{"gen": ..., "det": ...}`` tree that ``cli/train_wm.py``
    saves and the JAX package's ``load_params`` restores."""
    return {"det": state_dict_to_flax(wm.det), "gen": state_dict_to_flax(wm.gen)}


def init_neural_wm(seed: int = 0, cfg: NeuralWMConfig = NeuralWMConfig(),
                   device: str | torch.device = "cuda") -> NeuralWM:
    """The JAX package's ``init_neural_wm(jax.random.PRNGKey(seed), cfg)``."""
    return neural_from_flax(*init_trees(seed, cfg), cfg, device)


def load_neural_wm(path: str | Path, cfg: NeuralWMConfig = NeuralWMConfig(),
                   device: str | torch.device = "cuda") -> NeuralWM:
    """Read a ``{"gen", "det"}`` checkpoint (``checkpoints/neural_wm.msgpack``)."""
    blob = load_params(path)
    return neural_from_flax(blob["gen"], blob["det"], cfg, device)


@register("neural")
def _build(cfg: NeuralWMConfig = NeuralWMConfig(), seed: int = 0,
           device: str | torch.device = "cuda") -> NeuralWM:
    return init_neural_wm(seed, cfg, device)
