"""The convolution op (``ops.conv``) on the CPU at the convs that the
stride-1 kernel (``ops.same_conv``) takes, and the routes of ``SameConv1d``;
the binding's choice between the stencil kernel and the k = 1 GEMM path, on
the CPU with the launch stubbed and, marked ``cuda``, on the card.

On the CPU the op must be, bit for bit at every geometry of the codec's
stride-1 convolutions, the arithmetic written out in :func:`_want` (F.pad,
a float32 conv of the bfloat16 values rounded once, the bias added in
bfloat16, then the residual's ``x + y``), so that the JAX parity tests of
the bfloat16 codec hold through the op.
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nawc_tpu_torch.codec import layers
from nawc_tpu_torch.codec.model import SnacCodec
from nawc_tpu_torch.ops import _lib, dwconv
from nawc_tpu_torch.ops import conv as conv_op
from nawc_tpu_torch.ops import same_conv as sc
from nawc_tpu_torch.codec import mimi
from nawc_tpu_torch.tools.conv_layers import causal_geometries, k1_geometries
from nawc_tpu_torch.utils import profiling
from nawc_tpu_torch.utils.config import CodecConfig

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
    assert sc.takes(x, 48, 48, 7, 1, 9, 1, (27, 27))
    assert not sc.takes(x, 48, 48, 7, 1, 11, 1, (33, 33))   # padding 33 > 32
    assert not sc.takes(x, 48, 48, 9, 1, 1, 1, (4, 4))      # k > 7
    assert not sc.takes(x.float(), 48, 48, 7, 1, 1, 1, (3, 3))
    assert not sc.takes(x, 40, 48, 7, 1, 1, 1, (3, 3))


# ---------------------------------------------------------------- causal padding (Mimi)

def _causal(k, d):
    """Causal padding at stride 1 as a function of T: d (k - 1) zeros on the left."""
    return lambda t: (d * (k - 1), 0)


@pytest.mark.parametrize("c_in,c_out,k,d,residual", [(64, 32, 3, 1, False), (512, 1024, 7, 1, False),
                                                     (48, 48, 7, 9, True), (32, 64, 1, 1, True)])
def test_causal_conv_is_the_left_padded_arithmetic_bit_for_bit(c_in, c_out, k, d, residual):
    """``conv1d`` at a causal padding and Mimi's ``CausalConv1d`` on the
    CPU: F.pad by d (k - 1) on the left, then the arithmetic of ``_want``."""
    x, w, bias, res = _case(c_in, c_out, k, 2, 37, seed=c_out + k)
    res = res if residual else None
    want = _want(x, w, bias, 1, (d * (k - 1), 0), d, 1, res)
    assert torch.equal(conv_op.conv1d(x, w, bias, 1, _causal(k, d), d, 1, res), want)
    conv = mimi.CausalConv1d(c_in, c_out, k, dilation=d)
    with torch.no_grad():
        conv.weight.copy_(w)
        conv.bias.copy_(bias)
        assert torch.equal(conv(x, residual=res), want)
    # and not the SAME conv
    assert not torch.equal(want, _want(x, w, bias, 1, (d * (k - 1) // 2,) * 2, d, 1, res)) or k == 1


@pytest.mark.parametrize("k,d,left", [(3, 1, 2), (7, 1, 6), (7, 9, 54)])
def test_causal_conv_hands_the_stencil_its_left_pad(stubbed_card, k, d, left):
    """On the card's route (the C entries stubbed) a causal conv reaches the
    stencil kernel with its left pad, and no padded copy is made."""
    x, w, bias, _ = _case(48, 64, k, 2, 64, seed=k)
    pads = []
    real_pad = F.pad
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(F, "pad", lambda *a, **kw: pads.append(a) or real_pad(*a, **kw))
        y = conv_op.conv1d(x, w, bias, 1, _causal(k, d), d, 1)
    assert y.shape == (2, 64, 64) and not pads
    entry, args = stubbed_card[0]
    assert entry == "same_conv" and args[9:12] == (k, d, left)


@pytest.mark.parametrize("c_in,c_out,k,d,residual", [(16, 32, 3, 1, False), (32, 16, 7, 3, True)])
def test_function_gradient_at_causal_padding_is_autograd_of_the_plain_path(c_in, c_out, k, d, residual):
    """The autograd Function's backward at a causal padding (the backward of
    the conv of the left-padded x, cut to x) against autograd of pad + conv
    + add, in float64, on the CPU where its forward is the plain version."""
    x, w, bias, res = _case(c_in, c_out, k, 2, 23, seed=11, dtype=torch.float64)
    w, bias = w.double(), bias.double()
    res = res if residual else None
    g = torch.randn(2, c_out, 23, dtype=torch.float64)
    extra = [res.clone().requires_grad_()] if residual else []
    leaves = [t.clone().requires_grad_() for t in (x, w, bias)] + extra
    out = conv_op._KernelConv.apply(leaves[0], leaves[1], leaves[2], leaves[3] if residual else None, sc,
                                    _causal(k, d), d, 1)
    got = torch.autograd.grad(out, leaves, g)
    plain = [t.clone().requires_grad_() for t in (x, w, bias)] + ([res.clone().requires_grad_()] if residual else [])
    want = torch.autograd.grad(_want(plain[0], plain[1], plain[2], 1, (d * (k - 1), 0), d, 1,
                                     plain[3] if residual else None), plain, g)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_takes_admits_a_padding_that_keeps_t_within_the_halo():
    x = torch.zeros(1, 16, 4, dtype=torch.bfloat16)
    assert sc.takes(x, 64, 32, 3, 1, 1, 1, (2, 0)) and sc.takes(x, 512, 1024, 7, 1, 1, 1, (6, 0))
    assert sc.takes(x, 48, 48, 5, 1, 16, 1, (64, 0))          # the widest causal pad: 64
    assert not sc.takes(x, 48, 48, 7, 1, 11, 1, (66, 0))      # 72 rows of halo
    assert sc.takes(x, 48, 48, 7, 1, 10, 1, (30, 30))
    assert not sc.takes(x, 48, 48, 7, 1, 10, 1, (34, 26))     # 40 + 32 rows of halo
    assert not sc.takes(x, 48, 48, 7, 1, 1, 1, (6, 6))        # T would grow
    assert not sc.takes(x, 48, 48, 7, 1, 1, 1, (-1, 7))
    assert not dwconv.takes(x, 64, 64, 7, 1, 1, 64, (6, 0))   # the depthwise kernel pads SAME only
    assert dwconv.takes(x, 64, 64, 7, 1, 1, 64, (3, 3))


def test_mimis_geometries_are_its_stride1_convs():
    """``causal_geometries`` and ``k1_geometries`` at ``CodecConfig.mimi()``:
    the 10 causal k3/k7 convs the stencil takes and the 8 residual k 1
    convs, and their left pads."""
    causal = causal_geometries()
    assert len(causal) == 10 and {g[4] for g in causal} == {2, 6} and all(g[3] == 1 for g in causal)
    assert sorted({g[:2] for g in causal}) == [(64, 32), (128, 64), (256, 128), (512, 256), (512, 1024),
                                               (1024, 512)]
    k1 = k1_geometries(CodecConfig.mimi(), 720_000)
    assert len(k1) == 8 and all(r and b and t % 8 == 0 for _, _, r, b, t in k1)


# ---------------------------------------------------------------- the k = 1 GEMM path

# (case, k, T, x's offset in elements, the residual's offset, residual) -> the GEMM path?
# TMA reads rows of 16 bytes: T a multiple of 8, x, the residual and the output 16-byte aligned
K1_ROUTES = [("k 1", 1, 64, 0, 0, True, True), ("k 1 T 8 no residual", 1, 8, 0, 0, False, True),
             ("k 7", 7, 64, 0, 0, True, False), ("k 3", 3, 64, 0, 0, False, False),
             ("T 37", 1, 37, 0, 0, True, False), ("T 60", 1, 60, 0, 0, False, False),
             ("x off 2 bytes", 1, 64, 1, 0, True, False), ("residual off 8 bytes", 1, 64, 0, 4, True, False),
             ("x 16 bytes on", 1, 64, 8, 0, False, True)]


def _offset(t: torch.Tensor, offset: int) -> torch.Tensor:
    """`t`'s values in a contiguous tensor `offset` elements into a flat buffer."""
    buf = torch.zeros(t.numel() + offset, dtype=t.dtype)
    buf[offset:] = t.reshape(-1)
    return buf[offset:].view(t.shape)


@pytest.fixture
def stubbed_card(monkeypatch):
    """``ops.conv.conv1d`` on the card's route with both C entries of
    ``csrc/same_conv.cu`` stubbed: -> the list of (entry, args) they were
    called with.  The entries' launch counting runs as on the card."""
    calls = []
    monkeypatch.setattr(_lib, "use_kernel", lambda x: True)
    monkeypatch.setattr(sc, "_check", lambda *a: None)
    monkeypatch.setattr(_lib, "stream", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    for entry in (sc._KERNEL, sc._K1):
        monkeypatch.setattr(entry, "_fn", lambda *a, _e=entry.name: calls.append((_e, a)) or 0)
    return calls


@pytest.mark.parametrize("case,k,t,x_off,r_off,residual,gemm", K1_ROUTES, ids=[r[0] for r in K1_ROUTES])
def test_launch_takes_the_gemm_path_by_shape_and_counts_both(stubbed_card, case, k, t, x_off, r_off, residual,
                                                             gemm):
    """The binding's route by shape and alignment, the launch stubbed: the
    GEMM path's entry takes k 1 convs with T a multiple of 8 and 16-byte
    aligned x and residual, the stencil's every other conv; each entry
    counts its own launches: ``launches.k1conv`` the GEMM path's,
    ``launches.same_conv`` the stencil's."""
    x, w, bias, res = _case(48, 64, k, 2, t, seed=t + k)
    x, res = _offset(x, x_off), _offset(res, r_off) if residual else None
    assert sc.gemm_path(x, res, torch.empty(2, 64, t), k) == gemm
    before = {n: profiling.total(f"launches.{n}") for n in ("same_conv", "k1conv")}
    with torch.no_grad():
        y = conv_op.conv1d(x, w, bias, 1, _same(k, 1), 1, 1, res)
    assert y.shape == (2, 64, t) and y.dtype == torch.bfloat16
    entry, args = stubbed_card[0]
    assert [c[0] for c in stubbed_card] == ["k1conv" if gemm else "same_conv"]
    assert args[5:9] == (2, 48, 64, t) and len(args) == (10 if gemm else 13)
    assert gemm or args[9:12] == (k, 1, (k - 1) // 2)  # k, dilation, SAME's left pad
    assert (args[3].value is None) == (res is None)
    assert {n: profiling.total(f"launches.{n}") - before[n] for n in before} == {"same_conv": int(not gemm),
                                                                                 "k1conv": int(gemm)}


def test_gemm_path_refuses_nothing_of_the_stencils_domain_it_does_not_take():
    """k 1 at each T in 1..40 and at the codecs' own lengths: the GEMM path
    exactly where T % 8 == 0."""
    lengths = list(range(1, 41)) + sorted({g[4] for cfg, n in CODECS for g in k1_geometries(cfg, n)})
    for t in lengths:
        x = torch.zeros(1, 16, t, dtype=torch.bfloat16)
        assert sc.gemm_path(x, None, torch.zeros(1, 16, t, dtype=torch.bfloat16), 1) == (t % 8 == 0)


CODECS = [(CodecConfig(), 98_304), (CodecConfig.snac_44khz(), 184_320)]
# small widths of both layouts: (config, samples of one encode)
SMALL_CODECS = [(CodecConfig(encoder_dim=8, encoder_rates=(2, 4, 8, 8), latent_dim=64, decoder_dim=64,
                            decoder_rates=(8, 8, 4, 2), codebook_size=128, codebook_dim=8, vq_strides=(4, 2, 1)),
                 4096),
                (CodecConfig.snac_44khz(encoder_dim=8, encoder_rates=(2, 3, 2, 2), latent_dim=128,
                                        decoder_dim=256, decoder_rates=(2, 2, 3, 2), codebook_size=64,
                                        codebook_dim=8, vq_strides=(8, 4, 2, 1), attn_window=4), 768)]


@pytest.mark.parametrize("cfg,samples", SMALL_CODECS, ids=["codec24k layout", "snac layout"])
def test_k1_geometries_are_the_codecs_k1_convs_in_order(cfg, samples):
    """``tools.conv_layers.k1_geometries`` against the k 1 stride-1 convs
    that an encode and decode of a small codec of each layout runs (forward
    hooks), and the counts at the benchmark's sizes: 24 and 29."""
    model = SnacCodec(cfg).eval()
    seen = []
    for m in model.modules():
        if isinstance(m, layers.SameConv1d) and m.kernel_size[0] == m.stride[0] == m.groups == 1:
            m.register_forward_hook(lambda mod, a, kw, out: seen.append(
                (mod.in_channels, mod.out_channels, kw.get("residual") is not None, mod.bias is not None,
                 a[0].shape[-1])), with_kwargs=True)
    with torch.no_grad():
        model.decoder(model.encoder(torch.zeros(2, samples)))
    assert seen == k1_geometries(cfg, samples)
    assert [len(k1_geometries(c, n)) for c, n in CODECS] == [24, 29]


@pytest.fixture
def recorder():
    """The span recorder, cleared and on; off and cleared after the test."""
    profiling.disable()
    profiling.snapshot()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.snapshot()


@pytest.mark.parametrize("case,k,stride,groups,dtype,spans", [
    ("k 1", 1, 1, 1, torch.bfloat16, ["codec.k1conv"]), ("k 1 float32", 1, 1, 1, torch.float32, ["codec.k1conv"]),
    ("k 7", 7, 1, 1, torch.bfloat16, []), ("depthwise k 7", 7, 1, 16, torch.bfloat16, ["codec.dwconv"]),
    ("k 1 stride 2", 1, 2, 1, torch.bfloat16, []), ("k 1 groups 2", 1, 1, 2, torch.bfloat16, []),
])
def test_k1conv_span_wraps_the_k1_convs_alone(recorder, case, k, stride, groups, dtype, spans):
    """``SameConv1d`` opens ``codec.k1conv`` around each stride-1, one-group
    k 1 conv, in either type, and around no other conv."""
    conv = layers.SameConv1d(16, 16, k, stride=stride, groups=groups)
    with torch.no_grad():
        conv(torch.randn(2, 16, 40).to(dtype), **({"residual": torch.randn(2, 16, 40).to(dtype)}
                                                 if stride == 1 else {}))
    assert [s["name"] for s in recorder.snapshot()["spans"]] == spans


def test_k1conv_span_opens_inside_the_noise_blocks_and_residual_units(recorder):
    """A ResidualUnit's Conv_1 and a noise block's conv each run in a span
    ``codec.k1conv`` (the noise block's inside its ``codec.noise``)."""
    unit = layers.ResidualUnit(16, dilation=3, depthwise=True)
    noise = layers.NoiseBlock(16, layers.NoiseKey(0))
    with torch.no_grad():
        noise(unit(torch.randn(2, 16, 40).to(torch.bfloat16)))
    spans = recorder.snapshot()["spans"]
    assert [s["name"] for s in spans] == ["codec.dwconv", "codec.k1conv", "codec.noise", "codec.k1conv"]
    assert spans[3]["parent"] == spans[2]["id"] and spans[1]["parent"] is None


# ---------------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card_helpers():
    """``_sc_case`` and ``_sc_check`` of the kernel tests: the stencil
    kernel's bar."""
    import test_torch_kernels_cuda as kc

    return kc._sc_case, kc._sc_check


def _k1_on_card(dev, c_in, c_out, residual, bias, b, t, seed):
    """The op at a k 1 conv on the card against the stencil kernel's bar
    (``_sc_check``; without a bias: the zero bias it adds, bit for bit);
    two runs bit for bit; one GEMM launch each, and none of the stencil
    kernel."""
    case, check = _card_helpers()
    x, w, bias_t, res = case(c_in, c_out, 1, b, t, dev, seed=seed)
    res = res if residual else None
    bias_t = bias_t if bias else None
    n1, n = sc._K1.launches, sc._KERNEL.launches
    got = conv_op.conv1d(x, w, bias_t, 1, 0, 1, 1, res)
    again = conv_op.conv1d(x, w, bias_t, 1, 0, 1, 1, res)
    torch.cuda.synchronize()
    assert (sc._K1.launches - n1, sc._KERNEL.launches - n) == (2, 0)
    assert got.dtype == torch.bfloat16 and got.shape == (b, c_out, t) and torch.equal(got, again)
    zero = torch.zeros(c_out, device=dev)
    if not bias:
        assert torch.equal(got, conv_op.conv1d(x, w, zero, 1, 0, 1, 1, res))
    return check(got, x, w, bias_t if bias else zero, 1, res)


_K1_GEOMETRIES = sorted({g for cfg, n in CODECS for g in k1_geometries(cfg, n)})


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,residual,bias,t", _K1_GEOMETRIES)
def test_k1_path_is_the_plain_version_at_every_codec_geometry(dev, c_in, c_out, residual, bias, t):
    """Each of SNAC 44 kHz's 29 and codec24k's 24 k 1 convs (13 and 4
    geometries) at its own T on two clips, held to the plain version by the
    stencil kernel's bar; the noise blocks' convs without bias or residual."""
    _k1_on_card(dev, c_in, c_out, residual, bias, 2, t, seed=c_in + t)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,residual,bias,t", [(64, 64, True, True, 184_320), (96, 96, False, False, 184_320),
                                                        (768, 768, True, True, 3840), (1024, 1536, False, True, 480)])
def test_k1_path_at_the_full_batch(dev, c_in, c_out, residual, bias, t):
    """The narrowest, the widest and the head's k 1 convs of SNAC at its 16 x
    4 s batch."""
    _k1_on_card(dev, c_in, c_out, residual, bias, 16, t, seed=t + c_in)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,residual,b,t", [(64, 64, True, 1, 8), (48, 80, True, 1, 480),
                                                     (192, 176, False, 3, 1000), (1024, 208, True, 2, 136),
                                                     (96, 1552, False, 1, 24)])
def test_k1_path_at_b1_and_a_c_out_off_its_tiles(dev, c_in, c_out, residual, b, t):
    """B = 1, C_out not a multiple of the 64- or 128-channel tiles, C_in not
    of the 64-channel stages, T one stage long or ragged in its tile."""
    _k1_on_card(dev, c_in, c_out, residual, True, b, t, seed=c_out + t)


@pytest.mark.cuda
@pytest.mark.parametrize("t,offset", [(301, 0), (100, 0), (704, 1)])
def test_k1_conv_off_tmas_rows_runs_on_the_stencil_kernel(dev, t, offset):
    """A k 1 conv with T % 8 != 0, or x off 16 bytes, runs on the stencil
    kernel: one ``same_conv`` launch, no ``k1conv`` one, within its bar."""
    case, check = _card_helpers()
    x, w, bias, res = case(96, 96, 1, 2, t, dev, seed=t, offset=offset)
    n1, n = sc._K1.launches, sc._KERNEL.launches
    got = conv_op.conv1d(x, w, bias, 1, 0, 1, 1, res)
    torch.cuda.synchronize()
    assert (sc._K1.launches - n1, sc._KERNEL.launches - n) == (0, 1)
    check(got, x, w, bias, 1, res)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,k,d,left,t", sorted(set(causal_geometries())))
def test_causal_stencil_is_the_plain_version_at_every_mimi_geometry(dev, c_in, c_out, k, d, left, t):
    """Each of Mimi's 10 causal k3/k7 convs (6 geometries) at its own T on
    two clips, one stencil launch, held to the plain version by the stencil
    kernel's bar at the causal padding; bit for bit on a second call."""
    case, check = _card_helpers()
    x, w, bias, _ = case(c_in, c_out, k, 2, t, dev, seed=c_in + k + t)
    n, n1 = sc._KERNEL.launches, sc._K1.launches
    got = conv_op.conv1d(x, w, bias, 1, _causal(k, d), d, 1)
    again = conv_op.conv1d(x, w, bias, 1, _causal(k, d), d, 1)
    torch.cuda.synchronize()
    assert (sc._KERNEL.launches - n, sc._K1.launches - n1) == (2, 0)
    assert got.shape == (2, c_out, t) and torch.equal(got, again)
    check(got, x, w, bias, d, None, pads=(left, 0))


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_out,residual,bias,t", sorted(set(k1_geometries(CodecConfig.mimi(), 720_000))))
def test_k1_path_at_mimis_residual_convs(dev, c_in, c_out, residual, bias, t):
    """Mimi's 8 residual k 1 convs (4 geometries) on the GEMM path."""
    _k1_on_card(dev, c_in, c_out, residual, bias, 2, t, seed=c_out + t)


@pytest.mark.cuda
@pytest.mark.parametrize("k,d,pads", [(3, 1, (2, 0)), (7, 1, (6, 0)), (7, 9, (54, 0)), (5, 16, (64, 0)),
                                      (3, 8, (10, 6))])
def test_stencil_at_a_left_pad_off_same(dev, k, d, pads):
    """The stencil at pads other than SAME's, up to the widest halo, on a
    ragged T read from a misaligned address."""
    case, check = _card_helpers()
    x, w, bias, res = case(48, 96, k, 3, 301, dev, seed=k + d, offset=1)
    assert sc.takes(x, 48, 96, k, 1, d, 1, pads)
    got = conv_op.conv1d(x, w, bias, 1, lambda t: pads, d, 1, res)
    check(got, x, w, bias, d, res, pads=pads)


@pytest.mark.cuda
def test_causal_gradient_on_the_card_against_plain_autograd(dev):
    """x, weight, bias and residual gradients of a causal k3 conv through the
    kernel's Function against autograd of the plain version, within one
    bfloat16 ulp of the largest of each."""
    case, _ = _card_helpers()
    x, w, bias, res = case(64, 32, 3, 2, 333, dev, seed=9)
    g = torch.randn(2, 32, 333, device=dev).to(torch.bfloat16)

    def grads(plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias, res)]
        ctx = _lib.plain_versions() if plain else contextlib.nullcontext()
        with ctx:
            out = conv_op.conv1d(leaves[0], leaves[1], leaves[2], 1, _causal(3, 1), 1, 1, leaves[3])
        return torch.autograd.grad(out, leaves, g)

    n = sc._KERNEL.launches
    got = grads(False)
    assert sc._KERNEL.launches == n + 1
    for a, b in zip(got, grads(True)):
        ulp = 2.0 ** (np.floor(np.log2(float(b.float().abs().max()))) - 7)
        assert a.shape == b.shape and float((a.float() - b.float()).abs().max()) <= ulp
