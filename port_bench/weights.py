"""Seeded codec weights, drawn on the device in a few large calls.

The scales are those of the flax init the JAX package uses: LeCun
truncated-normal kernels (a standard normal cut at +-2, scaled by
1 / (0.8796 sqrt(fan_in))), fan-in normal codebooks (flax's fan-in of a
(K, C) codebook is K), zero biases and Snake ``log_alpha``.  Two
departures, both in the configuration files: the decoder's last conv is
drawn too (flax's init zeroes it, which would make every decoded waveform
tanh(0) = 0), and the draws come from a ``torch.Generator`` on the card,
not from the JAX package's threefry keys.

The state dict is keyed by the codec module's parameter names; the
program's codec and the reference are handed the same tensors.
"""

from __future__ import annotations

import math

import torch

_TRUNC2_STD = 0.87962566103423978  # std of a standard normal cut to (-2, 2)


def codec_config(block: dict):
    from nawc_tpu_torch.utils.config import CodecConfig

    return CodecConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in block.items()})


def _fan_in(name: str, module, shape) -> int:
    if isinstance(module, torch.nn.ConvTranspose1d):
        return shape[0] * shape[2]  # (in, out, k)
    if isinstance(module, torch.nn.Conv1d):
        return shape[1] * shape[2]  # (out, in, k)
    if name.endswith("codebook"):
        return shape[0]  # (K, C): flax's fan-in is every axis but the last
    return shape[1]  # Linear (out, in)


def draw(model, seed: int, device) -> dict[str, torch.Tensor]:
    """-> name -> tensor for every parameter of `model` (a module on any
    device, the meta device too), drawn on `device` from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    trunc, normal, zero = [], [], []
    for name, p in model.named_parameters():
        mod = model.get_submodule(name.rpartition(".")[0])
        shape = tuple(p.shape)
        if name.endswith(".bias") or name.endswith("log_alpha"):
            zero.append((name, shape))
        elif name.endswith("codebook"):
            normal.append((name, shape, 1.0 / math.sqrt(_fan_in(name, mod, shape))))
        else:
            std = 1.0 / math.sqrt(_fan_in(name, mod, shape)) / _TRUNC2_STD
            trunc.append((name, shape, std))
    out: dict[str, torch.Tensor] = {}
    n = sum(math.prod(s) for _, s, _ in trunc)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    tn = math.sqrt(2) * torch.erfinv(lo + u * (hi - lo))
    tn = tn.clamp_(-2.0, 2.0)
    for (name, shape, std), chunk in zip(trunc, torch.split(tn, [math.prod(s) for _, s, _ in trunc])):
        out[name] = (chunk * std).reshape(shape)
    n = sum(math.prod(s) for _, s, _ in normal)
    g = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    for (name, shape, std), chunk in zip(normal, torch.split(g, [math.prod(s) for _, s, _ in normal])):
        out[name] = (chunk * std).reshape(shape)
    for name, shape in zero:
        out[name] = torch.zeros(shape, device=device)
    return out


def make_codec(codec_block: dict, seed: int, device):
    """-> (the program's ``CodecState`` on `device`, the state dict it was
    loaded from)."""
    from nawc_tpu_torch.codec.api import CodecState
    from nawc_tpu_torch.codec.model import SnacCodec

    cfg = codec_config(codec_block)
    with torch.device("meta"):
        model = SnacCodec(cfg)
    weights = draw(model, seed, device)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    model.eval().requires_grad_(False)
    return CodecState(cfg=cfg, model=model), weights
