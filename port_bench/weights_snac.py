"""Seeded weights of the SNAC codec, drawn on the device in a few large
calls, at the scales of ``weights.py`` (the flax init's): LeCun
truncated-normal kernels of conv, transposed-conv and linear layers (a
depthwise kernel's fan-in is its k taps), fan-in normal codebooks, zero
biases and Snake ``log_alpha``; SNAC's LayerNorms at weight 1 and bias 0.
The departures are those of ``weights.py``: the decoder's last conv is
drawn, and the draws come from a ``torch.Generator`` on the card.

``weights.draw`` reads a second axis of every parameter that is neither a
conv's nor a codebook, which a LayerNorm's (C,) weight lacks: so this file.
"""

from __future__ import annotations

import math

import torch

from port_bench.weights import _TRUNC2_STD, _fan_in, codec_config


def draw(model, seed: int, device) -> dict[str, torch.Tensor]:
    """-> name -> tensor for every parameter of `model` (a module on any
    device, the meta device too), drawn on `device` from `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    trunc, normal, const = [], [], []
    for name, p in model.named_parameters():
        mod = model.get_submodule(name.rpartition(".")[0])
        shape = tuple(p.shape)
        if isinstance(mod, torch.nn.LayerNorm):
            const.append((name, shape, 1.0 if name.endswith("weight") else 0.0))
        elif name.endswith(".bias") or name.endswith("log_alpha"):
            const.append((name, shape, 0.0))
        elif name.endswith("codebook"):
            normal.append((name, shape, 1.0 / math.sqrt(_fan_in(name, mod, shape))))
        else:
            trunc.append((name, shape, 1.0 / math.sqrt(_fan_in(name, mod, shape)) / _TRUNC2_STD))
    sizes = [math.prod(s) for _, s, _ in trunc]
    u = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    lo, hi = math.erf(-2 / math.sqrt(2)), math.erf(2 / math.sqrt(2))
    tn = (math.sqrt(2) * torch.erfinv(lo + u * (hi - lo))).clamp_(-2.0, 2.0)
    out = {name: (c * std).reshape(shape)
           for (name, shape, std), c in zip(trunc, torch.split(tn, sizes))}
    sizes = [math.prod(s) for _, s, _ in normal]
    g = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out.update({name: (c * std).reshape(shape)
                for (name, shape, std), c in zip(normal, torch.split(g, sizes))})
    out.update({name: torch.full(shape, v, device=device) for name, shape, v in const})
    return out


def make_codec(codec_block: dict, seed: int, device):
    """-> (the program's ``CodecState`` on `device`, its noise keys started
    from `seed`; the state dict it was loaded from)."""
    from nawc_tpu_torch.codec.api import CodecState
    from nawc_tpu_torch.codec.model import SnacCodec

    cfg = codec_config(codec_block)
    with torch.device("meta"):
        model = SnacCodec(cfg)
    weights = draw(model, seed, device)
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    model.eval().requires_grad_(False)
    model.seed_noise(seed)
    return CodecState(cfg=cfg, model=model), weights
