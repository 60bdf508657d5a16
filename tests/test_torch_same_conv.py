"""The plain version of the stride-1 convolution op (``ops.same_conv``)
against the codec's own path, and the dispatch of ``SameConv1d`` to the op.

``same_conv_reference`` is the arithmetic that ``SameConv1d`` (F.pad, then
``_conv``) and ``ResidualUnit`` (``x + y``) had before the op: on the CPU
the two must agree bit for bit at every geometry of the codec's stride-1
convolutions, so that the JAX parity tests of the bfloat16 codec hold
through the op as they held before it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nawc_tpu_torch.codec import layers
from nawc_tpu_torch.ops import same_conv as sc
from nawc_tpu_torch.utils import profiling

# (C_in, C_out, k, dilation, residual): the ResidualUnits' Conv_0 at d = 1,
# 3, 9 and Conv_1 (k 1, with the unit's residual), the encoder's Conv_1 (k 3)
# and the decoder's Conv_0 (768 -> 768, k 7)
GEOMETRIES = [(48, 48, 7, 1, False), (96, 96, 7, 3, False), (192, 192, 7, 9, False),
              (48, 48, 1, 1, True), (768, 768, 3, 1, False), (768, 768, 7, 1, False)]
# (B, T): a ragged T, and T shorter than the widest padding at B = 1
LENGTHS = [(2, 37), (1, 5)]


def _case(c_in, c_out, k, b, t, seed, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((b, c_in, t)), dtype=torch.float32).to(dtype)
    w = torch.as_tensor(rng.standard_normal((c_out, c_in, k)) / np.sqrt(c_in * k), dtype=torch.float32)
    bias = torch.as_tensor(rng.standard_normal(c_out) * 0.1, dtype=torch.float32)
    res = torch.as_tensor(rng.standard_normal((b, c_out, t)), dtype=torch.float32).to(dtype)
    return x, w, bias, res


def _old_path(x, w, bias, d, res):
    """SameConv1d's body before the op, then ResidualUnit's x + y."""
    k = w.shape[-1]
    total = d * (k - 1)
    xp = F.pad(x, (total // 2, total - total // 2)) if total else x
    y = layers._conv(F.conv1d, xp, w, bias, 1, 0, d, 1)
    return y if res is None else res + y


@pytest.mark.parametrize("b,t", LENGTHS)
@pytest.mark.parametrize("c_in,c_out,k,d,residual", GEOMETRIES)
def test_reference_is_the_codec_path_bit_for_bit(c_in, c_out, k, d, residual, b, t):
    x, w, bias, res = _case(c_in, c_out, k, b, t, seed=c_in + k + d + t)
    res = res if residual else None
    want = _old_path(x, w, bias, d, res)
    got = sc.same_conv_reference(x, w, bias, d, res)
    assert got.dtype == torch.bfloat16 and got.shape == (b, c_out, t)
    assert torch.equal(got, want)
    # the module routes to the op and gives the same bits
    conv = layers.SameConv1d(c_in, c_out, k, dilation=d)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(bias)
        assert torch.equal(conv(x, residual=res), want)


def test_residual_unit_folds_its_add_into_the_conv():
    """ResidualUnit's output is x + Conv_1(...) as before, in bfloat16 and
    float32 alike."""
    torch.manual_seed(0)
    unit = layers.ResidualUnit(48, dilation=3)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(2, 48, 40).to(dtype)
        with torch.no_grad():
            h = unit.Snake_1(unit.Conv_0(unit.Snake_0(x)))
            want = x + layers._conv(F.conv1d, h, unit.Conv_1.weight, unit.Conv_1.bias, 1, 0, 1, 1)
            assert torch.equal(unit(x), want)


class _Spy:
    def __init__(self, monkeypatch):
        self.calls = 0
        real = sc.same_conv

        def spy(*args, **kwargs):
            self.calls += 1
            return real(*args, **kwargs)

        monkeypatch.setattr(sc, "same_conv", spy)


@pytest.mark.parametrize("case", ["float32", "stride 2", "groups 2", "C_in 1", "even k", "C_out 8"])
def test_dispatch_leaves_the_rest_on_the_plain_path(monkeypatch, case):
    """Float32, strided, grouped, single-input-channel, even-k and narrow
    convs never reach the op; their outputs are today's."""
    kw = dict(c_in=48, c_out=48, k=7, stride=1, groups=1, dtype=torch.bfloat16)
    kw.update({"float32": dict(dtype=torch.float32), "stride 2": dict(stride=2, k=4),
               "groups 2": dict(groups=2), "C_in 1": dict(c_in=1), "even k": dict(k=4),
               "C_out 8": dict(c_out=8)}[case])
    spy = _Spy(monkeypatch)
    torch.manual_seed(1)
    conv = layers.SameConv1d(kw["c_in"], kw["c_out"], kw["k"], stride=kw["stride"], groups=kw["groups"])
    x = torch.randn(2, kw["c_in"], 33).to(kw["dtype"])
    before = profiling.total("launches.same_conv")
    with torch.no_grad():
        y = conv(x)
    assert spy.calls == 0 and profiling.total("launches.same_conv") == before
    s, k = kw["stride"], kw["k"]
    total = max((-(-33 // s) - 1) * s + k - 33, 0)
    want = layers._conv(F.conv1d, F.pad(x, (total // 2, total - total // 2)), conv.weight, conv.bias,
                        s, 0, 1, kw["groups"])
    assert torch.equal(y, want)


def test_cpu_bfloat16_takes_the_op_and_launches_nothing(monkeypatch):
    spy = _Spy(monkeypatch)
    conv = layers.SameConv1d(48, 48, 7, dilation=9)
    x = torch.randn(1, 48, 20).to(torch.bfloat16)
    before = profiling.total("launches.same_conv")
    with torch.no_grad():
        conv(x)
    assert spy.calls == 1 and profiling.total("launches.same_conv") == before


@pytest.mark.parametrize("c_in,c_out,k,d,residual", [(16, 32, 7, 3, False), (32, 32, 1, 1, True)])
def test_function_gradient_is_autograd_of_the_plain_path(c_in, c_out, k, d, residual):
    """The autograd Function's backward (PyTorch's convolution backward at
    padding d (k - 1) / 2) against autograd of pad + conv + add, in float64,
    on the CPU where its forward is the plain version."""
    x, w, bias, res = _case(c_in, c_out, k, 2, 23, seed=7, dtype=torch.float64)
    w, bias = w.double(), bias.double()
    res = res if residual else None
    g = torch.randn(2, c_out, 23, dtype=torch.float64)
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)] + ([res.clone().requires_grad_()] if residual else [])
    out = sc._SameConvFunction.apply(leaves[0], leaves[1], leaves[2], leaves[3] if residual else None, d)
    got = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_() for t in (x, w, bias)] + ([res.clone().requires_grad_()] if residual else [])
    want = torch.autograd.grad(_old_path(plain[0], plain[1], plain[2], d, plain[3] if residual else None),
                               plain, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_takes_names_the_kernel_domain():
    x = torch.zeros(1, 16, 4, dtype=torch.bfloat16)
    assert sc.takes(x, 48, 48, 7, 1, 9, 1)
    assert not sc.takes(x, 48, 48, 7, 1, 11, 1)   # padding 33 > 32
    assert not sc.takes(x, 48, 48, 9, 1, 1, 1)    # k > 7
    assert not sc.takes(x.float(), 48, 48, 7, 1, 1, 1)
    assert not sc.takes(x, 40, 48, 7, 1, 1, 1)
