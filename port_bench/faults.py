"""Faults planted under the timed path, for the checks that a broken run
comes out not correct: ``with planted(name): ...`` runs the program with
the fault in place.  The tests plant each on the CPU at a small size, and
``tools/readings.py --fault`` reads one on the card at a cell's own size.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


@contextlib.contextmanager
def _replaced(owner, attr: str, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def flip_strongest_bit():
    """An answer altered where it is produced: detect returns the bit its
    statistic reads most surely, flipped, for the first clip."""
    from nawc_tpu_torch.models.spread_spectrum import SpreadSpectrumWM

    def make(orig):
        def detect(self, wav):
            presence, bits = orig(self, wav)
            k = int(self._correlate(wav)[0].abs().argmax())
            bits = bits.clone()
            bits[0, k] = 1 - bits[0, k]
            return presence, bits
        return detect

    return _replaced(SpreadSpectrumWM, "detect", make)


def half_batch_roundtrip():
    """Half the batch left out: the codec round trip runs the first half
    and hands its result to the second half too."""
    from nawc_tpu_torch import entry as entry_mod

    def make(orig):
        def roundtrip(codec, wav, in_sr=None):
            h = wav.shape[0] // 2
            y = orig(codec, wav[:h], in_sr)
            return torch.cat([y, y], dim=0)[: wav.shape[0]]
        return roundtrip

    return _replaced(entry_mod, "codec_roundtrip", make)


def altered_code():
    """A code altered where it is produced: each lookup returns the next
    index for its first frame."""
    from nawc_tpu_torch.codec import model

    def make(orig):
        def lookup(z, codebook):
            codes = orig(z, codebook).clone()
            codes[0] = (codes[0] + 1) % codebook.shape[0]
            return codes
        return lookup

    return _replaced(model, "nearest_codebook", make)


def adam_unchanged():
    """A step that returns its state unchanged: Adam's update leaves the
    parameter and the moments as they were."""
    adam_module = importlib.import_module("torch.optim.adam")  # torch.optim.adam is the class's
    return _replaced(adam_module, "adam", lambda orig: lambda *args, **kwargs: None)


def half_batch_loss():
    """Half of the batch left out, the mean taken over the rest: the embed's
    loss sees the first half of the clips, scaled to the whole."""
    from nawc_tpu_torch.models import semantic

    def make(orig):
        def loss(codec, scfg, axis, s, x, mask, delta):
            h = x.shape[0] // 2
            return orig(codec, scfg, axis, s, x[:h], mask[:h], delta[:h]) * x.shape[0] / h
        return loss

    return _replaced(semantic, "_loss", make)


def altered_output():
    """An answer altered where it is produced: the marked audio's first
    sample moved by 0.01."""
    from nawc_tpu_torch.models import semantic

    def make(orig):
        def embed(*args):
            out = orig(*args).clone()
            out[0, 0] += 0.01
            return out
        return embed

    return _replaced(semantic, "semantic_embed", make)


FAULTS = {f.__name__: f for f in (flip_strongest_bit, half_batch_roundtrip, altered_code,
                                   adam_unchanged, half_batch_loss, altered_output)}


def planted(name: str):
    return FAULTS[name]()
