"""Faults of the SNAC codec planted under the timed path, as ``faults.py``
plants its own: ``with planted(name): ...`` runs the program with the
fault in place.  ``tests/test_bench_snac.py`` plants each at a small size
on the CPU; ``planted`` takes the names of ``faults.py`` too."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import faults
from port_bench.faults import _replaced


def whole_sequence_attention():
    """Attention over every frame of the clip, not window by window."""
    from nawc_tpu_torch.codec.layers import LocalMHA

    def make(orig):
        def forward(self, x):
            window, self.window = self.window, x.shape[-1]
            try:
                return orig(self, x)
            finally:
                self.window = window
        return forward

    return _replaced(LocalMHA, "forward", make)


def rotary_left_out():
    """Every frame at rotary position 0: no rotation."""
    from nawc_tpu_torch.codec.layers import LocalMHA

    return _replaced(LocalMHA, "positions", lambda orig: lambda self, t, device: torch.zeros(
        t // self.window, self.window, device=device))


def noise_left_out():
    """The noise blocks pass their input on."""
    from nawc_tpu_torch.codec.layers import NoiseBlock

    return _replaced(NoiseBlock, "forward", lambda orig: lambda self, x: x)


def noise_key_ignored():
    """Every noise draw from one key, whatever key the block holds."""
    from nawc_tpu_torch.codec.layers import NoiseDraw

    fixed = np.array([0, 7], np.uint32)
    return _replaced(NoiseDraw, "forward",
                     lambda orig: lambda self, key, shape, device: orig(self, fixed, shape, device))


def flax_padding_at_stride_3():
    """The strided convs padded by flax's SAME rule (1 and 2 at stride 3)."""
    from nawc_tpu_torch.codec.layers import SameConv1d

    def pads(self, t):
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        total = max((-(-t // s) - 1) * s + d * (k - 1) + 1 - t, 0)
        return total // 2, total - total // 2

    return _replaced(SameConv1d, "pads", lambda orig: pads)


FAULTS = {f.__name__: f for f in (whole_sequence_attention, rotary_left_out, noise_left_out,
                                   noise_key_ignored, flax_padding_at_stride_3)}


def planted(name: str):
    return FAULTS[name]() if name in FAULTS else faults.planted(name)
