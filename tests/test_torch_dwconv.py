"""The convolution op (``ops.conv``) on the CPU at the convs that the
depthwise kernel (``ops.dwconv``) takes, and the routes of a depthwise
``SameConv1d``.

On the CPU the op must be, bit for bit at every geometry of SNAC's depthwise
convs, the arithmetic written out in :func:`_want` (a float32 grouped conv
of the bfloat16 values at padding d (k - 1) / 2, rounded once, the bias
added in bfloat16), so that a SNAC codec encodes and decodes on the CPU as
it did.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nawc_tpu_torch.codec import layers
from nawc_tpu_torch.codec.model import SnacCodec
from nawc_tpu_torch.ops import conv as conv_op
from nawc_tpu_torch.ops import dwconv as dw
from nawc_tpu_torch.tools.conv_layers import depthwise_geometries
from nawc_tpu_torch.utils import profiling
from nawc_tpu_torch.utils.config import CodecConfig

# SNAC 44 kHz's depthwise channel counts (encoder, then decoder) and dilations
CHANNELS = [64, 128, 256, 512, 1024, 768, 384, 192, 96]
DILATIONS = [1, 3, 9]


def _case(c, k, b, t, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((b, c, t)), dtype=torch.float32).to(dtype)
    w = torch.as_tensor(rng.standard_normal((c, 1, k)) / np.sqrt(k), dtype=torch.float32)
    bias = torch.as_tensor(rng.standard_normal(c) * 0.1, dtype=torch.float32)
    return x, w, bias


def _want(x, w, bias, stride, padding, d, groups):
    """The conv at `padding` (an int inside the conv, a pair by F.pad
    before it): in bfloat16 a float32 conv of the bfloat16 values, rounded
    once, then the bias added in bfloat16; in float32 and float64 the conv
    with its bias."""
    if isinstance(padding, tuple):
        x, padding = F.pad(x, padding), 0
    wx, bx = w.to(x.dtype), None if bias is None else bias.to(x.dtype)
    if x.dtype == torch.bfloat16:
        y = F.conv1d(x.float(), wx.float(), None, stride, padding, d, groups).to(x.dtype)
        return y if bx is None else y + bx[:, None]
    return F.conv1d(x, wx, bx, stride, padding, d, groups)


def _depthwise(x, w, bias, d):
    """A depthwise conv at SAME padding d (k - 1) / 2 on both sides."""
    return _want(x, w, bias, 1, d * (w.shape[-1] - 1) // 2, d, w.shape[0])


class _Taken:
    """Records what ``dwconv.takes`` answers ``ops.conv.conv1d``: True where
    the op routes the conv to the depthwise kernel (on the CPU, to its plain
    version)."""

    def __init__(self, monkeypatch):
        self.answers = []
        takes = dw.takes

        def spy(*args):
            self.answers.append(takes(*args))
            return self.answers[-1]

        monkeypatch.setattr(dw, "takes", spy)


@pytest.mark.parametrize("length", ["ragged", "within the padding", "one sample"])
@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("c", CHANNELS)
def test_reference_is_the_codec_path_bit_for_bit(c, d, length):
    """At a ragged T off a multiple of 8 (B 2), T equal to the padding 3d
    (B 1) and T = 1 (B 1); with and without a bias; through the module."""
    b, t = {"ragged": (2, 37), "within the padding": (1, 3 * d), "one sample": (1, 1)}[length]
    x, w, bias = _case(c, 7, b, t, seed=c + d + t)
    for bi in (bias, None):
        want = _depthwise(x, w, bi, d)
        got = conv_op.conv1d(x, w, bi, 1, 3 * d, d, c)
        assert got.dtype == torch.bfloat16 and got.shape == (b, c, t)
        assert torch.equal(got, want)
        assert torch.equal(conv_op._KernelConv.apply(x, w, bi, None, dw, 3 * d, d, c), want)
    conv = layers.SameConv1d(c, c, 7, dilation=d, groups=c)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(bias)
        assert torch.equal(conv(x), _depthwise(x, w, bias, d))


@pytest.mark.parametrize("case", ["float32", "stride 2", "groups 1", "groups 2", "even k", "padding 33",
                                  "k 5", "dilation 2"])
def test_dispatch_leaves_the_rest_on_the_old_path(monkeypatch, case):
    """Float32, strided, dense, two-group, even-k and over-padded convs, and
    depthwise convs off k 7 at dilation 1, 3 or 9, take the route of no
    kernel; their outputs are the arithmetic written out in ``_want``: a
    depthwise conv at stride 1 padded d (k - 1) // 2 on both sides inside
    the conv (even k too), any other conv by SAME padding before it."""
    kw = dict(c=48, k=7, stride=1, groups=48, d=1, dtype=torch.bfloat16)
    kw.update({"float32": dict(dtype=torch.float32), "stride 2": dict(stride=2, k=4),
               "groups 1": dict(groups=1), "groups 2": dict(groups=2), "even k": dict(k=4),
               "padding 33": dict(d=11), "k 5": dict(k=5), "dilation 2": dict(d=2)}[case])
    torch.manual_seed(1)
    conv = layers.SameConv1d(kw["c"], kw["c"], kw["k"], stride=kw["stride"], dilation=kw["d"],
                             groups=kw["groups"])
    x = torch.randn(2, kw["c"], 41).to(kw["dtype"])
    s, k, d, groups = kw["stride"], kw["k"], kw["d"], kw["groups"]
    if groups == kw["c"] and s == 1:
        padding = d * (k - 1) // 2
    else:
        total = max((-(-41 // s) - 1) * s + d * (k - 1) + 1 - 41, 0)
        padding = (total // 2, total - total // 2)
    want = _want(x, conv.weight, conv.bias, s, padding, d, groups)
    taken = _Taken(monkeypatch)
    before = profiling.total("launches.dwconv")
    with torch.no_grad():
        y = conv(x)
    assert not any(taken.answers) and profiling.total("launches.dwconv") == before
    assert torch.equal(y, want)


def test_cpu_bfloat16_takes_the_op_and_launches_nothing(monkeypatch):
    taken = _Taken(monkeypatch)
    conv = layers.SameConv1d(64, 64, 7, dilation=9, groups=64)
    x = torch.randn(1, 64, 20).to(torch.bfloat16)
    before = profiling.total("launches.dwconv")
    with torch.no_grad():
        conv(x)
    assert taken.answers == [True] and profiling.total("launches.dwconv") == before


@pytest.mark.parametrize("c,k,d,with_bias", [(16, 7, 3, True), (8, 3, 1, False), (12, 5, 2, True)])
def test_function_gradient_is_autograd_of_the_plain_path(c, k, d, with_bias):
    """The autograd Function's backward (PyTorch's convolution backward at
    padding d (k - 1) / 2 and C groups) against autograd of the plain path,
    in float64, on the CPU where its forward is the plain version."""
    x, w, bias = _case(c, k, 2, 23, seed=7, dtype=torch.float64)
    w, bias = w.double(), bias.double()
    g = torch.randn(2, c, 23, dtype=torch.float64)
    ins = [x, w] + ([bias] if with_bias else [])

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fn(leaves[0], leaves[1], leaves[2] if with_bias else None, d)
        return out, torch.autograd.grad(out, leaves, g)

    out, got = grads(lambda x, w, b, d: conv_op._KernelConv.apply(x, w, b, None, dw, d * (k - 1) // 2, d, c))
    want_out, want = grads(_depthwise)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_takes_names_the_kernel_domain():
    x = torch.zeros(1, 16, 4, dtype=torch.bfloat16)
    assert dw.takes(x, 64, 64, 7, 1, 9, 64, (27, 27))
    assert dw.takes(x, 96, 96, 7, 1, 3, 96, (9, 9))
    assert dw.takes(x, 5, 5, 7, 1, 1, 5, (3, 3))         # any channel count
    assert not dw.takes(x, 96, 96, 3, 1, 32, 96, (32, 32))  # k 3
    assert not dw.takes(x, 5, 5, 1, 1, 1, 5, (0, 0))      # k 1
    assert not dw.takes(x, 64, 64, 7, 1, 2, 64, (6, 6))   # dilation 2
    assert not dw.takes(x, 64, 64, 7, 1, 11, 64, (33, 33))  # dilation 11
    assert not dw.takes(x, 64, 64, 9, 1, 1, 64, (4, 4))   # k > 7
    assert not dw.takes(x, 64, 64, 6, 1, 1, 64, (2, 3))   # even k
    assert not dw.takes(x, 64, 64, 7, 2, 1, 64, (3, 3))   # stride 2
    assert not dw.takes(x, 64, 64, 7, 1, 1, 1, (3, 3))    # one group
    assert not dw.takes(x, 64, 64, 7, 1, 1, 2, (3, 3))    # two groups
    assert not dw.takes(x, 64, 128, 7, 1, 1, 64, (3, 3))  # a channel multiplier
    assert not dw.takes(x.float(), 64, 64, 7, 1, 1, 64, (3, 3))


def test_bound_bytes_are_the_benchmark_counts():
    """The op's bytes at SNAC 44 kHz's 26 depthwise layers of a 16 x 4 s call
    are ``counts_snac.dwconv_bytes``: 16.106 GB."""
    from port_bench import counts_snac

    geo = depthwise_geometries()
    assert len(geo) == 26 and sorted({(c, d) for c, _, d, _ in geo if (c, d) != (1024, 1)}) == sorted(
        (c, d) for c in CHANNELS if c != 1024 for d in DILATIONS)
    cfg = {"encoder_dim": 64, "encoder_rates": [2, 3, 8, 8], "attn_window": 32, "decoder_dim": 1536,
           "decoder_rates": [8, 8, 3, 2]}
    enc, dec = counts_snac.codec_layers(cfg, 16, 184_320)
    want = counts_snac.dwconv_bytes(enc + dec, "bfloat16")
    assert sum(dw.bound_bytes(16, c, t, k) for c, k, _, t in geo) == want
    assert want / 1e9 == pytest.approx(16.106, abs=1e-3)


# hop 24, chunk 192: channels 8-128 in the encoder, 128-16 in the decoder
SMALL = dict(encoder_dim=8, encoder_rates=(2, 3, 2, 2), latent_dim=128, decoder_dim=256,
             decoder_rates=(2, 2, 3, 2), codebook_size=64, codebook_dim=8, vq_strides=(8, 4, 2, 1),
             attn_window=4, compute_dtype="bfloat16")


def test_snac_codec_encodes_and_decodes_as_before(monkeypatch):
    """A bfloat16 SNAC codec at a test size: its encode and decode through
    the op (26 depthwise convs that the kernel takes) equal, bit for bit,
    those of the codec whose depthwise convs are ``_depthwise``."""
    torch.manual_seed(3)
    model = SnacCodec(CodecConfig.snac_44khz(**SMALL)).eval()
    for p in model.parameters():  # biases and Snake alphas off zero too
        p.data.add_(0.05 * torch.randn_like(p))
    wav = 0.2 * torch.randn(2, 768)

    def roundtrip():
        model.seed_noise(5)
        with torch.no_grad():
            z = model.encoder(wav)
            return z, model.decoder(z)

    forward = layers.SameConv1d.forward

    def written_out(self, x, residual=None):
        if self.groups > 1 and self.groups == self.in_channels == self.out_channels:
            return _depthwise(x, self.weight, self.bias, self.dilation[0])
        return forward(self, x, residual)

    with monkeypatch.context() as m:
        m.setattr(layers.SameConv1d, "forward", written_out)
        z0, y0 = roundtrip()
    taken = _Taken(monkeypatch)
    z, y = roundtrip()
    assert sum(taken.answers) == 26
    assert torch.equal(z, z0) and torch.equal(y, y0)
