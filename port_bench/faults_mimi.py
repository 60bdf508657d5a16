"""Faults of the Mimi codec planted under the timed path, as ``faults.py``
plants its own: ``with planted(name): ...`` runs the program with the
fault in place.  ``tests/test_bench_mimi.py`` plants each at a small size
on the CPU, with a window that binds; ``planted`` takes the names of
``faults.py`` too."""

from __future__ import annotations

import contextlib

from port_bench import faults
from port_bench.faults import _replaced


def whole_clip_attention():
    """Causal attention over every frame before, without the window."""
    from nawc_tpu_torch.codec import mimi

    return _replaced(mimi, "window_mask", lambda orig: lambda t, context, device: orig(t, t, device))


def same_padding_in_residual_convs():
    """The residual blocks' k3 convs padded as SAME (one frame each side),
    not causally."""
    import torch.nn.functional as F

    from nawc_tpu_torch.codec.mimi import ResBlock
    from nawc_tpu_torch.ops.conv import conv1d

    def make(orig):
        def forward(self, x):
            c = self.Conv_0
            p = c.dilation[0] * (c.kernel_size[0] - 1) // 2
            h = conv1d(F.elu(x), c.weight, c.bias, 1, lambda t: (p, p), c.dilation[0], 1)
            return self.Conv_1(F.elu(h), residual=x)
        return forward

    return _replaced(ResBlock, "forward", make)


def acoustic_fed_semantic_residual():
    """The acoustic quantizer fed the latent less the semantic level's
    contribution, not the latent."""
    import torch.nn.functional as F

    from nawc_tpu_torch.codec.mimi import SplitRVQ

    def make(orig):
        def forward(self, z):
            sem, c_sem, l_sem = self.semantic.quantize(z, self.n_semantic)
            sem_out = F.linear(sem, self.semantic.out_proj.weight)
            aco, c_aco, l_aco = self.acoustic.quantize(z - sem_out, self.n_q - self.n_semantic)
            return sem_out + F.linear(aco, self.acoustic.out_proj.weight), c_sem + c_aco, l_sem + l_aco, \
                z.new_zeros(())
        return forward

    return _replaced(SplitRVQ, "forward", make)


@contextlib.contextmanager
def layer_scale_left_out():
    """Every LayerScale left out: the sublayers' outputs added whole."""
    import torch

    from nawc_tpu_torch.codec import mimi

    def unscaled(orig):
        def forward(self, *args):
            scale = self.scale
            self.scale = torch.nn.Parameter(torch.ones_like(scale), requires_grad=False)
            try:
                return orig(self, *args)
            finally:
                self.scale = scale
        return forward

    with _replaced(mimi.SelfAttention, "forward", unscaled), _replaced(mimi.FeedForward, "forward", unscaled):
        yield


def rotary_left_out():
    """Every frame at RoPE position 0: no rotation."""
    import torch

    from nawc_tpu_torch.codec import mimi

    return _replaced(mimi, "rotary_tables", lambda orig: lambda positions, dim: orig(
        torch.zeros_like(positions), dim))


FAULTS = {f.__name__: f for f in (whole_clip_attention, same_padding_in_residual_convs,
                                   acoustic_fed_semantic_residual, layer_scale_left_out, rotary_left_out)}


def planted(name: str):
    return FAULTS[name]() if name in FAULTS else faults.planted(name)
