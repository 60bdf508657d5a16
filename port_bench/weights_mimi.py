"""Seeded weights of the Mimi codec, drawn on the device in a few large
calls: LeCun normal conv, transposed-conv and linear weights (std 1 /
sqrt(fan-in), fan-in the inputs one output sums: C_in / groups x k for a
conv, C_in / groups x k / s for a transposed conv, C_in for a linear
layer), zero biases, LayerNorms at weight 1 and bias 0, LayerScales at
their published 0.01 init.

Codebooks are drawn at the scale of what they meet, so that no lookup is
degenerate (a codebook far larger than its input would pick the same
smallest code for every frame, one far smaller the code most aligned with
the frame whatever its norm): standard normals scaled, level by level, to
the rms of the residual that level meets, read from the latent that the
plain reference (``reference/mimi.py``, float32, TF32 off) gives for two
4 s speech-like clips drawn from the seed (peak 0.7, as the attack scales
its input), each level's residual taken after the levels before it (every
held level, the unused ones too).  The program under test has no part in
the scales.
"""

from __future__ import annotations

import math

import torch

from port_bench import inputs
from port_bench.reference import mimi as ref_mimi
from port_bench.reference import precision
from port_bench.weights import codec_config

CALIBRATION = (2, 96_000)  # clips x samples (4 s at 24 kHz: 50 frames of 1920)


def _fan_in(module, shape) -> int:
    if isinstance(module, torch.nn.ConvTranspose1d):
        return shape[0] // module.groups * shape[2] // module.stride[0]
    return math.prod(shape[1:])


def draw(model, seed: int, device) -> dict[str, torch.Tensor]:
    """-> name -> tensor for every parameter of `model` (a module on any
    device, the meta device too), drawn on `device` from `seed`; codebooks
    standard normal (:func:`scale_codebooks` scales them)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    normal, const = [], []
    for name, p in model.named_parameters():
        mod = model.get_submodule(name.rpartition(".")[0])
        shape = tuple(p.shape)
        if isinstance(mod, torch.nn.LayerNorm):
            const.append((name, shape, 1.0 if name.endswith("weight") else 0.0))
        elif name.endswith(".scale"):
            const.append((name, shape, 0.01))
        elif name.endswith(".bias"):
            const.append((name, shape, 0.0))
        elif name.endswith("codebook"):
            normal.append((name, shape, 1.0))
        else:
            normal.append((name, shape, 1.0 / math.sqrt(_fan_in(mod, shape))))
    sizes = [math.prod(s) for _, s, _ in normal]
    g = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out = {name: (c * std).reshape(shape) for (name, shape, std), c in zip(normal, torch.split(g, sizes))}
    out.update({name: torch.full(shape, v, device=device) for name, shape, v in const})
    return out


def scale_codebooks(weights: dict, latent: torch.Tensor) -> list[float]:
    """Scale each codebook of `weights` in place to the rms of the residual
    it meets from `latent` (B, T', D) float32 -> the scales, semantic levels
    first."""
    scales = []
    for q in ("semantic", "acoustic"):
        r = latent.reshape(-1, latent.shape[-1]) @ weights[f"quantizer.{q}.in_proj.weight"].T
        i = 0
        while f"quantizer.{q}.levels.{i}.codebook" in weights:
            cb = weights[f"quantizer.{q}.levels.{i}.codebook"]
            s = float(r.pow(2).mean().sqrt())
            cb.mul_(s)
            d = cb.pow(2).sum(-1) - 2.0 * r @ cb.T
            r = r - cb[d.argmin(-1)]
            scales.append(s)
            i += 1
    return scales


def make_codec(codec_block: dict, seed: int, device):
    """-> (the program's ``CodecState`` on `device`; the state dict it was
    loaded from, its codebooks scaled on the reference's latent)."""
    from nawc_tpu_torch.codec.api import CodecState
    from nawc_tpu_torch.codec.mimi import MimiCodec

    cfg = codec_config(codec_block)
    with torch.device("meta"):
        model = MimiCodec(cfg)
    weights = draw(model, seed, device)
    n, t = CALIBRATION
    wav = torch.from_numpy(inputs.speech_clips(inputs.rng(seed, "codebook scale"), n, t, cfg.sample_rate))
    wav = wav.to(device)
    wav = wav * (0.7 / wav.abs().amax(dim=-1, keepdim=True).clamp(min=1e-4))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    precision.no_tf32()
    try:
        with torch.no_grad():
            ref = ref_mimi.Mimi(weights, codec_block, precision.get("float32"))
            scale_codebooks(weights, ref.encode_latent(wav)["latent"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    model.eval().requires_grad_(False)
    return CodecState(cfg=cfg, model=model), weights
