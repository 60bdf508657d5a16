"""The plain version of the depthwise convolution op (``ops.dwconv``)
against the codec's own path, and the dispatch of ``SameConv1d`` to the op.

``dwconv_reference`` is the arithmetic that ``SameConv1d`` had for a
depthwise conv before the op (``layers._conv`` at padding d (k - 1) / 2): on
the CPU the two must agree bit for bit at every geometry of SNAC's depthwise
convs, so that a SNAC codec encodes and decodes on the CPU as it did.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nawc_tpu_torch.codec import layers
from nawc_tpu_torch.codec.model import SnacCodec
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


def _old_path(x, w, bias, d):
    """SameConv1d's depthwise body before the op."""
    k = w.shape[-1]
    return layers._conv(F.conv1d, x, w, bias, 1, d * (k - 1) // 2, d, w.shape[0])


@pytest.mark.parametrize("length", ["ragged", "within the padding", "one sample"])
@pytest.mark.parametrize("d", DILATIONS)
@pytest.mark.parametrize("c", CHANNELS)
def test_reference_is_the_codec_path_bit_for_bit(c, d, length):
    """At a ragged T off a multiple of 8 (B 2), T equal to the padding 3d
    (B 1) and T = 1 (B 1); with and without a bias; through the module."""
    b, t = {"ragged": (2, 37), "within the padding": (1, 3 * d), "one sample": (1, 1)}[length]
    x, w, bias = _case(c, 7, b, t, seed=c + d + t)
    for bi in (bias, None):
        want = _old_path(x, w, bi, d)
        got = dw.dwconv_reference(x, w, bi, d)
        assert got.dtype == torch.bfloat16 and got.shape == (b, c, t)
        assert torch.equal(got, want)
        assert torch.equal(dw.dwconv(x, w, bi, d), want)
    conv = layers.SameConv1d(c, c, 7, dilation=d, groups=c)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(bias)
        assert torch.equal(conv(x), _old_path(x, w, bias, d))


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = 0
        real = dw.dwconv

        def spy(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(dw, "dwconv", spy)


@pytest.mark.parametrize("case", ["float32", "stride 2", "groups 1", "groups 2", "even k", "padding 33",
                                  "k 5", "dilation 2"])
def test_dispatch_leaves_the_rest_on_the_old_path(monkeypatch, case):
    """Float32, strided, dense, two-group, even-k and over-padded convs, and
    depthwise convs off k 7 at dilation 1, 3 or 9, never reach the op;
    their outputs are those of the path without it."""
    kw = dict(c=48, k=7, stride=1, groups=48, d=1, dtype=torch.bfloat16)
    kw.update({"float32": dict(dtype=torch.float32), "stride 2": dict(stride=2, k=4),
               "groups 1": dict(groups=1), "groups 2": dict(groups=2), "even k": dict(k=4),
               "padding 33": dict(d=11), "k 5": dict(k=5), "dilation 2": dict(d=2)}[case])
    torch.manual_seed(1)
    conv = layers.SameConv1d(kw["c"], kw["c"], kw["k"], stride=kw["stride"], dilation=kw["d"],
                             groups=kw["groups"])
    x = torch.randn(2, kw["c"], 41).to(kw["dtype"])
    with torch.no_grad(), monkeypatch.context() as m:
        m.setattr(dw, "takes", lambda *a: False)
        want = conv(x)
    spy = _Spy(monkeypatch)
    before = profiling.total("launches.dwconv")
    with torch.no_grad():
        y = conv(x)
    assert spy.calls == 0 and profiling.total("launches.dwconv") == before
    assert torch.equal(y, want)


def test_cpu_bfloat16_takes_the_op_and_launches_nothing(monkeypatch):
    spy = _Spy(monkeypatch)
    conv = layers.SameConv1d(64, 64, 7, dilation=9, groups=64)
    x = torch.randn(1, 64, 20).to(torch.bfloat16)
    before = profiling.total("launches.dwconv")
    with torch.no_grad():
        conv(x)
    assert spy.calls == 1 and profiling.total("launches.dwconv") == before


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

    out, got = grads(dw._DwConvFunction.apply)
    want_out, want = grads(_old_path)
    assert torch.equal(out, want_out)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_takes_names_the_kernel_domain():
    x = torch.zeros(1, 16, 4, dtype=torch.bfloat16)
    assert dw.takes(x, 64, 64, 7, 1, 9, 64)
    assert dw.takes(x, 96, 96, 7, 1, 3, 96)
    assert dw.takes(x, 5, 5, 7, 1, 1, 5)         # any channel count
    assert not dw.takes(x, 96, 96, 3, 1, 32, 96)  # k 3
    assert not dw.takes(x, 5, 5, 1, 1, 1, 5)      # k 1
    assert not dw.takes(x, 64, 64, 7, 1, 2, 64)   # dilation 2
    assert not dw.takes(x, 64, 64, 7, 1, 11, 64)  # dilation 11
    assert not dw.takes(x, 64, 64, 9, 1, 1, 64)   # k > 7
    assert not dw.takes(x, 64, 64, 6, 1, 1, 64)   # even k
    assert not dw.takes(x, 64, 64, 7, 2, 1, 64)   # stride 2
    assert not dw.takes(x, 64, 64, 7, 1, 1, 1)    # one group
    assert not dw.takes(x, 64, 64, 7, 1, 1, 2)    # two groups
    assert not dw.takes(x, 64, 128, 7, 1, 1, 64)  # a channel multiplier
    assert not dw.takes(x.float(), 64, 64, 7, 1, 1, 64)


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
    the op (26 calls) equal, bit for bit, those of the path without it."""
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

    with monkeypatch.context() as m:
        m.setattr(dw, "takes", lambda *a: False)
        z0, y0 = roundtrip()
    spy = _Spy(monkeypatch)
    z, y = roundtrip()
    assert spy.calls == 26
    assert torch.equal(z, z0) and torch.equal(y, y0)
