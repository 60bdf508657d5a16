"""Functional convenience API around :class:`SnacCodec`
(``nawc_tpu/codec/api.py``) and :class:`~.mimi.MimiCodec`.

:class:`CodecState` bundles the config with the module that holds the
weights.  ``encode`` runs the fused residual-VQ kernel, as the JAX
package's ``_encode`` does, where it takes the strides (up to 8 levels whose
strides divide its 24-frame tile; others, and Mimi's split Euclidean RVQ,
run the module path); ``roundtrip`` runs the module path, whose lookups go
through the nearest-codebook kernel (Mimi's through
``ops.rvq.nearest_euclidean``).  :data:`MODELS` gives each layout's module
and its seeded draws; Mimi has no flax form, so no flax checkpoint loads
into it.

The weights are frozen (``requires_grad=False``), so inference builds no
autograd graph.  Callers who want float32 results on the card turn off TF32
(``torch.backends.cudnn.allow_tf32 = False``): cuDNN convolutions run in
TF32 by default, which would break parity with the JAX reference.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..ops import rvq_fused
from ..ops.rvq_fused import rvq_encode_fused
from ..utils import flaxinit, jaxrand
from ..utils.checkpoint import load_params
from ..utils.config import CodecConfig
from ..utils.device import resolve_device
from ..utils.padding import pad_to_multiple
from . import convert, mimi
from .convert import flax_to_state_dict
from .model import ResidualVQ, SnacCodec, VQLevel


@dataclasses.dataclass(frozen=True)
class CodecState:
    """A codec definition and the module that holds its weights."""

    cfg: CodecConfig
    model: SnacCodec | mimi.MimiCodec

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def encode_latent(self, wav: torch.Tensor) -> torch.Tensor:
        return self.model.encode_latent(wav)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.model.decode_latent(z)

    def encode(self, wav: torch.Tensor) -> list[torch.Tensor]:
        """(B, T) -> per-level codes, by the fused residual-VQ kernel where
        it takes the strides, else by ``ResidualVQ.encode``."""
        z = self.model.encode_latent(wav)
        if isinstance(self.model.quantizer, ResidualVQ) and rvq_fused.takes(self.cfg.vq_strides):
            return rvq_encode_fused(z, self.model.quantizer, self.cfg.vq_strides)
        return self.model.quantizer.encode(z)

    def decode(
        self, codes: Sequence[torch.Tensor], level_mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        return self.model.decode(codes, level_mask)

    def roundtrip(self, wav: torch.Tensor) -> torch.Tensor:
        return self.model.roundtrip(wav)

    def forward(self, wav: torch.Tensor) -> dict:
        return self.model(wav)

    def pad(self, wav: torch.Tensor) -> torch.Tensor:
        """Right-pad (..., T) to the codec chunk multiple (pad-to-4096 rule)."""
        return pad_to_multiple(wav, self.cfg.chunk, axis=-1)

    @property
    def projected_codebook(self) -> torch.Tensor:
        """(K, codebook_dim) first-level codebook."""
        return self.model.projected_codebook

    def project_latent(self, z: torch.Tensor) -> torch.Tensor:
        """The first VQ level's input projection (latent -> codebook_dim)."""
        return self.model.project_latent(z)


def _frozen(model: torch.nn.Module, device: torch.device, cfg: CodecConfig) -> CodecState:
    model = model.to(device).eval()
    model.requires_grad_(False)
    return CodecState(cfg=cfg, model=model)


def flax_init_tree(model: SnacCodec, seed: int) -> dict:
    """The flax variables tree (numpy, flax layout) that the JAX package's
    ``make_codec(jax.random.PRNGKey(seed), cfg)`` initialises for this
    model's config: LeCun truncated-normal kernels, fan-in normal codebooks,
    zero biases and Snake ``log_alpha``, and the decoder's output conv zero;
    SNAC's LayerNorms (no flax counterpart) at weight 1 and bias 0."""
    root = jaxrand.prng_key(seed)

    def codebook(path, mod):
        if isinstance(mod, VQLevel):
            return {"codebook": flaxinit.fan_in_normal(flaxinit.param_key(root, path),
                                                       tuple(mod.codebook.shape))}
        if isinstance(mod, torch.nn.LayerNorm):
            return {"weight": np.ones(mod.normalized_shape, np.float32),
                    "bias": np.zeros(mod.normalized_shape, np.float32)}
        return None

    return convert.flax_init_tree(model, root, zero_kernels={("decoder", "Conv_1")}, own=codebook)


def seeded_snac(cfg: CodecConfig, seed: int) -> SnacCodec:
    """A :class:`SnacCodec` on the CPU with the random weights of the JAX
    package's ``make_codec(jax.random.PRNGKey(seed), cfg)``, its noise
    blocks' keys (SNAC's) started from `seed` too."""
    model = SnacCodec(cfg)
    model.load_state_dict(flax_to_state_dict(flax_init_tree(model, seed), model), strict=True)
    model.seed_noise(seed)
    return model


class Layout(NamedTuple):
    module: type[torch.nn.Module]  # the codec module, built from a CodecConfig
    seeded: Callable[[CodecConfig, int], torch.nn.Module]  # the module with its seeded draws, on the CPU


# the codec of each ``CodecConfig.layout``
MODELS = {"nawc": Layout(SnacCodec, seeded_snac), "snac": Layout(SnacCodec, seeded_snac),
          "mimi": Layout(mimi.MimiCodec, mimi.make_model)}


def make_codec(cfg: CodecConfig = CodecConfig(), device: str | torch.device = "cuda",
               seed: int = 0) -> CodecState:
    """A codec with its layout's random weights drawn from `seed` on the
    CPU (:data:`MODELS`): the JAX package's
    ``make_codec(jax.random.PRNGKey(seed), cfg)`` for SNAC's layouts,
    ``mimi.init_weights`` for Mimi's."""
    return _frozen(MODELS[cfg.layout].seeded(cfg, seed), resolve_device(device), cfg)


def codec_from_flax(tree: dict, cfg: CodecConfig = CodecConfig(),
                    device: str | torch.device = "cuda") -> CodecState:
    """A codec whose weights are converted from a flax variables tree
    (SNAC's layouts; Mimi has no flax form)."""
    dev = resolve_device(device)
    model = SnacCodec(cfg)
    model.load_state_dict(flax_to_state_dict(tree, model), strict=True)
    return _frozen(model, dev, cfg)


def load_codec(path: str | Path, cfg: CodecConfig = CodecConfig(),
               device: str | torch.device = "cuda") -> CodecState:
    """Read a flax msgpack checkpoint (``checkpoints/codec_24k.msgpack``)
    with the port's own reader and convert it in memory."""
    return codec_from_flax(load_params(path), cfg, device)
