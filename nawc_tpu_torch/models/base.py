"""Watermarker API (``nawc_tpu/models/base.py``).

Batched: every method takes (B, T) waveforms at the watermarker's native
rate; ``embed(wav, msg) -> marked``, ``detect(wav) -> (presence, bits)``,
``score(wav, msg=None) -> (B,)``.  Random payloads are drawn from a
``jax.random`` key reproduced by :mod:`..utils.jaxrand`, so that a seed
gives the JAX package's bits.
"""

from __future__ import annotations

from typing import Callable, Protocol, runtime_checkable

import numpy as np
import torch

from ..utils import jaxrand
from ..utils.device import resolve_device


@runtime_checkable
class Watermarker(Protocol):
    """Batched watermark embedder/detector."""

    name: str
    sample_rate: int
    n_bits: int

    def embed(self, wav: torch.Tensor, msg: torch.Tensor, key=None) -> torch.Tensor:
        """(B, T) @ sample_rate, (B, n_bits) in {0,1} -> (B, T) watermarked."""
        ...

    def detect(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, T) -> (presence_prob (B,), bits (B, n_bits) in {0,1})."""
        ...

    def score(self, wav: torch.Tensor, msg: torch.Tensor | None = None) -> torch.Tensor:
        """(B,) scalar detection score with the method's reference semantic."""
        ...


def random_message(key: np.ndarray, batch: int, n_bits: int,
                   device: str | torch.device = "cuda") -> torch.Tensor:
    """Random payload bits (B, n_bits) int32: ``jax.random.bernoulli(key,
    0.5, (batch, n_bits))`` bit for bit, for a key of
    :func:`~nawc_tpu_torch.utils.jaxrand.prng_key` or ``fold_in``."""
    dev = resolve_device(device)
    bits = jaxrand.bernoulli(key, 0.5, (batch, n_bits)).astype(np.int32)
    return torch.from_numpy(bits).to(dev)


def embed_payload(wm, wav: torch.Tensor, key: np.ndarray) -> tuple[torch.Tensor, torch.Tensor | None]:
    """-> (marked, msg): a payload-carrying `wm` embeds
    ``random_message(key, B, n_bits)`` with `key`; the others embed no
    payload (msg None)."""
    if getattr(wm, "n_bits", 0) > 0:
        msg = random_message(key, wav.shape[0], wm.n_bits, device=wav.device)
        return wm.embed(wav, msg, key), msg
    return wm.embed(wav), None


def score_payload(wm, wav: torch.Tensor, msg: torch.Tensor | None) -> torch.Tensor:
    """`wm`'s score of `wav`, against `msg` where it carries one."""
    return wm.score(wav, msg) if msg is not None else wm.score(wav)


def bit_accuracy(bits: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """(B, n_bits) x (B, n_bits) -> (B,) fraction of matching bits."""
    return (bits == msg).float().mean(dim=-1)


# registry: name -> factory(...) -> Watermarker; populated by submodules
_REGISTRY: dict[str, Callable] = {}


def register(name: str):
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available() -> list[str]:
    return sorted(_REGISTRY)


def build(name: str, *args, **kwargs) -> "Watermarker":
    if name not in _REGISTRY:
        raise KeyError(f"unknown watermarker {name!r}; have {available()}")
    return _REGISTRY[name](*args, **kwargs)
