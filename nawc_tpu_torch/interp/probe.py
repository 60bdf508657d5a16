"""Latent probing (``nawc_tpu/interp/probe.py``): per-clip codec-encoder
latents, padded to the codec chunk as the JAX probe pads them."""

from __future__ import annotations

import torch

from ..codec.api import CodecState


def get_latent(codec: CodecState, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, T', D) encoder latents (probe space)."""
    return codec.encode_latent(codec.pad(wav))


def get_mean_latent(codec: CodecState, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, D) time-averaged latents (the reference's per-file
    ``mean_z``)."""
    return get_latent(codec, wav).mean(dim=-2)


def project_on_axis(codec: CodecState, wav: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """(B, T) x (D,) -> (B, T') per-frame projections in latent space."""
    return get_latent(codec, wav) @ axis
