"""The convolution op (``ops.conv``) on the CPU at the convs that the
stride-1 kernel (``ops.same_conv``) takes, and the routes of ``SameConv1d``.

On the CPU the op must be, bit for bit at every geometry of the codec's
stride-1 convolutions, the arithmetic written out in :func:`_want` (F.pad,
a float32 conv of the bfloat16 values rounded once, the bias added in
bfloat16, then the residual's ``x + y``), so that the JAX parity tests of
the bfloat16 codec hold through the op.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nawc_tpu_torch.codec import layers
from nawc_tpu_torch.ops import _lib, dwconv
from nawc_tpu_torch.ops import conv as conv_op
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


def _want(x, w, bias, stride, pads, d, groups, res):
    """F.pad by `pads`; in bfloat16 a float32 conv of the bfloat16 values,
    rounded once, then the bias added in bfloat16; in float32 and float64
    the conv with its bias; then ``res + y``."""
    xp = F.pad(x, pads)
    wx, bx = w.to(x.dtype), bias.to(x.dtype)
    if x.dtype == torch.bfloat16:
        y = F.conv1d(xp.float(), wx.float(), None, stride, 0, d, groups).to(x.dtype) + bx[:, None]
    else:
        y = F.conv1d(xp, wx, bx, stride, 0, d, groups)
    return y if res is None else res + y


def _same(k, d):
    """SAME padding at stride 1 as a function of T, as ``conv1d`` takes it."""
    return lambda t: (d * (k - 1) // 2, d * (k - 1) - d * (k - 1) // 2)


class _Route:
    """Records the route ``ops.conv.conv1d`` takes on the CPU: ``"plain"``
    where a kernel takes the conv, ``"native"`` where none does."""

    def __init__(self, monkeypatch):
        self.taken = []
        real = conv_op._padded

        def spy(conv, *args):
            self.taken.append("plain" if conv is conv_op.conv_plain else "native")
            return real(conv, *args)

        monkeypatch.setattr(conv_op, "_padded", spy)


@pytest.mark.parametrize("b,t", LENGTHS)
@pytest.mark.parametrize("c_in,c_out,k,d,residual", GEOMETRIES)
def test_reference_is_the_codec_path_bit_for_bit(c_in, c_out, k, d, residual, b, t):
    x, w, bias, res = _case(c_in, c_out, k, b, t, seed=c_in + k + d + t)
    res = res if residual else None
    k_pad = d * (k - 1) // 2
    want = _want(x, w, bias, 1, (k_pad, k_pad), d, 1, res)
    got = conv_op.conv1d(x, w, bias, 1, _same(k, d), d, 1, res)
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
            want = _want(h, unit.Conv_1.weight, unit.Conv_1.bias, 1, (0, 0), 1, 1, x)
            assert torch.equal(unit(x), want)


@pytest.mark.parametrize("case", ["float32", "stride 2", "groups 2", "C_in 1", "even k", "C_out 8"])
def test_dispatch_leaves_the_rest_on_the_plain_path(monkeypatch, case):
    """Float32, strided, grouped, single-input-channel, even-k and narrow
    convs take the route of no kernel; their outputs are the arithmetic
    written out in ``_want``."""
    kw = dict(c_in=48, c_out=48, k=7, stride=1, groups=1, dtype=torch.bfloat16)
    kw.update({"float32": dict(dtype=torch.float32), "stride 2": dict(stride=2, k=4),
               "groups 2": dict(groups=2), "C_in 1": dict(c_in=1), "even k": dict(k=4),
               "C_out 8": dict(c_out=8)}[case])
    route = _Route(monkeypatch)
    torch.manual_seed(1)
    conv = layers.SameConv1d(kw["c_in"], kw["c_out"], kw["k"], stride=kw["stride"], groups=kw["groups"])
    x = torch.randn(2, kw["c_in"], 33).to(kw["dtype"])
    before = profiling.total("launches.same_conv")
    with torch.no_grad():
        y = conv(x)
    assert route.taken == ["native"] and profiling.total("launches.same_conv") == before
    s, k = kw["stride"], kw["k"]
    total = max((-(-33 // s) - 1) * s + k - 33, 0)
    want = _want(x, conv.weight, conv.bias, s, (total // 2, total - total // 2), 1, kw["groups"], None)
    assert torch.equal(y, want)


def test_cpu_bfloat16_takes_the_op_and_launches_nothing(monkeypatch):
    route = _Route(monkeypatch)
    conv = layers.SameConv1d(48, 48, 7, dilation=9)
    x = torch.randn(1, 48, 20).to(torch.bfloat16)
    before = profiling.total("launches.same_conv")
    with torch.no_grad():
        conv(x)
    assert route.taken == ["plain"] and profiling.total("launches.same_conv") == before


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
    out = conv_op._KernelConv.apply(leaves[0], leaves[1], leaves[2], leaves[3] if residual else None, sc,
                                    _same(k, d), d, 1)
    got = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_() for t in (x, w, bias)] + ([res.clone().requires_grad_()] if residual else [])
    p = d * (k - 1) // 2
    want = torch.autograd.grad(_want(plain[0], plain[1], plain[2], 1, (p, p), d, 1, plain[3] if residual else None),
                               plain, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


@pytest.mark.parametrize("where,kernel,grad,route", [
    ("cpu", "same_conv", False, "plain"), ("cpu", "dwconv", False, "plain"), ("cpu", None, False, "native"),
    ("cpu", "same_conv", True, "plain"), ("card", "same_conv", False, "launch"),
    ("card", "dwconv", True, "function"),
])
def test_conv1d_takes_the_route_of_its_table(monkeypatch, where, kernel, grad, route):
    """``ops.conv.conv1d``'s table: on the CPU, a conv that a kernel takes
    runs the plain version (autograd of it where a gradient is wanted) and
    one that no kernel takes the native route; on the card (here: the
    kernel's ``launch`` stubbed and ``use_kernel`` made true) the kernel's
    launch, through ``_KernelConv`` where a gradient is wanted."""
    c, groups, k, dtype = {"same_conv": (48, 1, 7, torch.bfloat16), "dwconv": (64, 64, 7, torch.bfloat16),
                           None: (48, 1, 7, torch.float32)}[kernel]
    torch.manual_seed(2)
    x = torch.randn(2, c, 30).to(dtype)
    w = (torch.randn(c, c // groups, k) / 8).requires_grad_(grad)
    bias = torch.randn(c) * 0.1
    taken = _Route(monkeypatch)
    launched = []
    if where == "card":
        monkeypatch.setattr(_lib, "use_kernel", lambda x: True)
        binding = {"same_conv": sc, "dwconv": dwconv}[kernel]
        monkeypatch.setattr(binding, "launch", lambda *a: launched.append(a) or torch.zeros(2, c, 30, dtype=dtype))
    y = conv_op.conv1d(x, w, bias, 1, _same(k, 3), 3, groups)
    assert y.shape == (2, c, 30) and y.dtype == dtype
    assert (taken.taken, len(launched)) == {"plain": (["plain"], 0), "native": (["native"], 0),
                                             "launch": ([], 1), "function": ([], 1)}[route]
    node = type(y.grad_fn).__name__ if y.grad_fn is not None else None
    assert (node == "_KernelConvBackward") == (route == "function") and (node is not None) == grad
    if where == "cpu":
        want = _want(x, w, bias, 1, (9, 9), 3, groups, None)
        assert torch.equal(y, want)
        if grad:
            g = torch.randn_like(want)
            assert torch.equal(torch.autograd.grad(y, w, g)[0], torch.autograd.grad(want, w, g)[0])


def test_takes_names_the_kernel_domain():
    x = torch.zeros(1, 16, 4, dtype=torch.bfloat16)
    assert sc.takes(x, 48, 48, 7, 1, 9, 1)
    assert not sc.takes(x, 48, 48, 7, 1, 11, 1)   # padding 33 > 32
    assert not sc.takes(x, 48, 48, 9, 1, 1, 1)    # k > 7
    assert not sc.takes(x.float(), 48, 48, 7, 1, 1, 1)
    assert not sc.takes(x, 40, 48, 7, 1, 1, 1)
