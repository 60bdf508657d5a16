"""Codec training (``nawc_tpu/train/codec_train.py``): L1 + multi-scale
log-mel + multi-resolution STFT + VQ losses, AdamW on one device.

The codec trains as a :class:`~nawc_tpu_torch.codec.model.SnacCodec`
module whose weights require gradients; every residual-VQ lookup of its
training forward runs the nearest-codebook kernel on the card, against a
codebook that the optimiser moves in place after each step.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..codec.api import flax_init_tree
from ..codec.convert import flax_to_state_dict
from ..codec.model import SnacCodec
from ..dsp.mel import mel_spectrogram
from ..dsp.stft import stft
from ..eval.metrics import si_snr
from ..utils.config import CodecConfig, MelConfig, StftConfig
from ..utils.device import resolve_device
from .optim import AdamW, warmup_cosine_decay_schedule

MEL_SCALES = (
    (StftConfig(512, 128, 512), MelConfig(n_fft=512, n_mels=40)),
    (StftConfig(1024, 256, 1024), MelConfig(n_fft=1024, n_mels=80)),
    (StftConfig(2048, 512, 2048), MelConfig(n_fft=2048, n_mels=120)),
)


@dataclasses.dataclass
class CodecTrainState:
    model: SnacCodec
    opt: AdamW
    step: int


class _GroupSum(torch.autograd.Function):
    """The sum of a tensor over a process group; each process's input gets
    the sum of the group's output gradients."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def multires_stft_loss(ref: torch.Tensor, est: torch.Tensor, group=None) -> torch.Tensor:
    """Multi-resolution STFT loss: spectral convergence + log-magnitude L1.

    With a process `group` whose processes each hold an equal shard of the
    batch, the spectral convergence's two norms are taken over the whole
    batch (a differentiable all-reduce): the group's mean of the loss and of
    its gradient is then the whole batch's."""
    total = 0.0
    for scfg, _ in MEL_SCALES:
        s_ref = stft(ref, scfg).abs()
        s_est = stft(est, scfg).abs()
        if group is None:
            sc = torch.linalg.norm(s_ref - s_est) / (torch.linalg.norm(s_ref) + 1e-6)
        else:
            sq = _GroupSum.apply(torch.stack([((s_ref - s_est) ** 2).sum(), (s_ref ** 2).sum()]), group)
            sc = sq[0].sqrt() / (sq[1].sqrt() + 1e-6)
        logmag = torch.mean(torch.abs(torch.log(s_ref + 1e-5) - torch.log(s_est + 1e-5)))
        total = total + sc + logmag
    return total / len(MEL_SCALES)


def mel_l1(wav: torch.Tensor, est: torch.Tensor, sample_rate: int, scales=MEL_SCALES) -> torch.Tensor:
    """Mean over `scales` of the L1 distance of the log-mel spectrograms."""
    total = 0.0
    for stft_cfg, mel_cfg in scales:
        mc = dataclasses.replace(mel_cfg, sample_rate=sample_rate)
        total = total + torch.mean(torch.abs(mel_spectrogram(wav, stft_cfg, mc, log=True)
                                             - mel_spectrogram(est, stft_cfg, mc, log=True)))
    return total / len(scales)


def codec_loss(cfg: CodecConfig, model: SnacCodec, wav: torch.Tensor, sisnr_weight: float = 0.0,
               group=None):
    """wav (B, T) at cfg.sample_rate -> (scalar loss, metrics dict); the
    metrics hold each level's codebook usage histogram (``usage_i``).
    `group`: see :func:`multires_stft_loss`."""
    out = model(wav)
    recon = out["recon"]
    l1 = torch.mean(torch.abs(recon - wav))
    mel_l = mel_l1(wav, recon, cfg.sample_rate)
    stft_l = multires_stft_loss(wav, recon, group)
    sisnr = si_snr(wav, recon).mean()
    loss = (1.0 * l1 + 1.0 * mel_l + 1.0 * stft_l
            + 0.25 * out["commit_loss"] + 1.0 * out["codebook_loss"] - sisnr_weight * sisnr)
    metrics = {"loss": loss, "l1": l1, "mel": mel_l, "stft": stft_l,
               "commit": out["commit_loss"], "codebook": out["codebook_loss"], "si_snr": sisnr}
    for i, c in enumerate(out["codes"]):
        metrics[f"usage_{i}"] = torch.bincount(c.reshape(-1).long(), minlength=cfg.codebook_size)
    return loss, metrics


def make_optimizer(params, lr: float = 3e-4, warmup: int = 500, total: int = 100_000,
                   **kwargs) -> AdamW:
    """The JAX trainer's ``make_optimizer``: clip 1.0, AdamW (0.9, 0.95,
    decay 1e-4) under a warmup-cosine schedule down to 0.05 lr."""
    warmup = min(warmup, max(total // 10, 1))
    sched = warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1), lr * 0.05)
    return AdamW(params, sched, b1=0.9, b2=0.95, weight_decay=1e-4, **kwargs)


def trainable_codec(cfg: CodecConfig, seed: int = 0, device: str | torch.device = "cuda",
                    tree: dict | None = None) -> SnacCodec:
    """A SnacCodec module with gradients on: JAX's seeded init
    (``SnacCodec(cfg).init(PRNGKey(seed), ...)``), or the flax `tree`."""
    model = SnacCodec(cfg)
    model.load_state_dict(flax_to_state_dict(tree if tree is not None else flax_init_tree(model, seed),
                                             model), strict=True)
    return model.to(resolve_device(device))


def init_codec_train(seed: int, cfg: CodecConfig, device: str | torch.device = "cuda",
                     **opt_kwargs) -> CodecTrainState:
    """JAX's ``init_codec_train(PRNGKey(seed), cfg, make_optimizer(...))``;
    `opt_kwargs` go to :func:`make_optimizer`."""
    model = trainable_codec(cfg, seed, device)
    return CodecTrainState(model, make_optimizer(model.parameters(), **opt_kwargs), 0)


def make_codec_train_step(cfg: CodecConfig, sisnr_weight: float = 0.0, mesh=None):
    """-> step(state, wav) -> metrics: one forward, backward and update of
    ``state`` in place.

    With a :class:`~nawc_tpu_torch.parallel.Mesh`, ``wav`` is the whole
    batch and each process trains on its "data" shard of it, the model
    wrapped in ``DistributedDataParallel`` over the "data" group: the
    averaged gradient, the update and the metrics (averaged over the group,
    the usage histograms summed) are the whole batch's, as on one device."""
    if mesh is None:
        def step(state: CodecTrainState, wav: torch.Tensor) -> dict:
            return _train_step(cfg, state, state.model, wav, sisnr_weight)

        return step

    from ..parallel.mesh import shard_batch

    group, n = mesh.group("data"), mesh.shape["data"]
    wrapped: dict = {}

    def dp_step(state: CodecTrainState, wav: torch.Tensor) -> dict:
        if wrapped.get("model") is not state.model:
            wrapped["model"] = state.model
            wrapped["ddp"] = DistributedDataParallel(
                state.model, device_ids=[mesh.device.index] if mesh.device.type == "cuda" else None,
                process_group=group)
        metrics = _train_step(cfg, state, wrapped["ddp"], shard_batch(wav, mesh), sisnr_weight, group)
        for k, v in metrics.items():
            dist.all_reduce(v, group=group)
            if not k.startswith("usage_"):
                v /= n
        return metrics

    return dp_step


def _train_step(cfg: CodecConfig, state: CodecTrainState, model, wav: torch.Tensor,
                sisnr_weight: float, group=None) -> dict:
    state.opt.zero_grad()
    loss, metrics = codec_loss(cfg, model, wav, sisnr_weight, group)
    loss.backward()
    state.opt.step()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def make_codec_eval_fn(cfg: CodecConfig):
    """Held-out evaluator: (model, wav) -> {val_si_snr, val_lsd, val_stoi}."""
    from ..eval.metrics import lsd, stoi

    @torch.no_grad()
    def ev(model: SnacCodec, wav: torch.Tensor) -> dict:
        recon = model.roundtrip(wav)
        return {"val_si_snr": torch.mean(si_snr(wav, recon)),
                "val_lsd": torch.mean(lsd(wav, recon)),
                "val_stoi": torch.mean(stoi(wav, recon, cfg.sample_rate))}

    return ev


@torch.no_grad()
def revive_dead_codes(model: SnacCodec, usage: dict[int, np.ndarray], cfg: CodecConfig,
                      rng: np.random.Generator, noise_scale: float = 0.05) -> list[int]:
    """Dead-code revival (SoundStream/Jukebox-style codebook restarts):
    codes with zero recent usage are re-seeded as noised copies of used
    codes, drawn by usage.  The same numpy draws as the JAX package's; the
    codebooks are written in place (``copy_``, which moves the tensor's
    version, so a kernel's cached table of the codebook is rebuilt).
    -> dead codes per level."""
    dead_counts = []
    for i in range(cfg.num_levels):
        counts = usage[i]
        param = getattr(model.quantizer, f"level_{i}").codebook
        cb = param.detach().cpu().numpy().copy()
        dead = np.where(counts == 0)[0]
        dead_counts.append(len(dead))
        if len(dead) == 0:
            continue
        alive = np.where(counts > 0)[0]
        if len(alive) == 0:
            continue
        probs = counts[alive] / counts[alive].sum()
        src = rng.choice(alive, size=len(dead), p=probs)
        scale = np.abs(cb[src]).mean() + 1e-4
        cb[dead] = cb[src] + noise_scale * scale * rng.standard_normal(
            (len(dead), cb.shape[1])).astype(cb.dtype)
        param.copy_(torch.from_numpy(cb))
    return dead_counts


def speech_batches(files: list[str], batch: int, seconds: float, sample_rate: int,
                   seed: int = 0, loop: bool = True) -> Iterator[np.ndarray]:
    """Host-side loader: random fixed-length crops of WAV files, resampled to
    `sample_rate`, peak-normalised to 0.7.  Yields (batch, T) float32."""
    from ..dsp.resample import resample
    from ..utils import audio_io

    rng = np.random.default_rng(seed)
    t = int(seconds * sample_rate)
    cache: dict[str, np.ndarray] = {}

    def load(f: str) -> np.ndarray:
        if f not in cache:
            a, sr = audio_io.read_wav(f)
            x = a.mean(axis=0)
            if sr != sample_rate:
                x = resample(torch.from_numpy(np.ascontiguousarray(x, np.float32)), sr,
                             sample_rate).numpy()
            peak = np.abs(x).max() + 1e-9
            cache[f] = (0.7 * x / peak).astype(np.float32)
        return cache[f]

    while True:
        out = np.zeros((batch, t), np.float32)
        for i in range(batch):
            x = load(files[int(rng.integers(len(files)))])
            if len(x) <= t:
                out[i, : len(x)] = x
            else:
                o = int(rng.integers(len(x) - t))
                out[i] = x[o: o + t]
        yield out
        if not loop:
            return
