"""The decoders' last conv, C channels to one in float32 (``ops.conv.conv1d``
with ``widen``), on the CPU: the domain of its kernel (``ops.outconv``), its
plain version, the decoders through it, its gradient and its route to the
kernel with the C entry stubbed.

The plain version is the chain the decoders ran before they had the kernel:
``x.float()``, then the float32 conv at its padding.  On the CPU every codec
must decode bit for bit as through that chain, so that the JAX parity tests
hold.  The kernel itself is held against a float64 sum on the card
(``test_torch_kernels_cuda.py``).
"""

import contextlib
import ctypes

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from nawc_tpu_torch.codec import layers, mimi
from nawc_tpu_torch.codec.model import SnacCodec
from nawc_tpu_torch.ops import _lib
from nawc_tpu_torch.ops import conv as conv_op
from nawc_tpu_torch.ops import outconv
from nawc_tpu_torch.utils import profiling
from nawc_tpu_torch.utils.config import CodecConfig

# the four roundtrip cells' tails: (x's type, C, k, (left, right))
TAILS = {"codec24k bf16": (torch.bfloat16, 48, 7, (3, 3)), "snac44k bf16": (torch.bfloat16, 96, 7, (3, 3)),
         "mimi bf16": (torch.bfloat16, 64, 3, (2, 0)), "codec24k f32": (torch.float32, 48, 7, (3, 3))}
# small widths of the three layouts: (config, samples of one encode)
SMALL_CODECS = {
    "codec24k": (dict(encoder_dim=8, encoder_rates=(2, 4, 8, 8), latent_dim=64, decoder_dim=64,
                      decoder_rates=(8, 8, 4, 2), codebook_size=128, codebook_dim=8, vq_strides=(4, 2, 1)),
                 CodecConfig, 4096),
    "snac44k": (dict(encoder_dim=8, encoder_rates=(2, 3, 2, 2), latent_dim=128, decoder_dim=256,
                     decoder_rates=(2, 2, 3, 2), codebook_size=64, codebook_dim=8, vq_strides=(8, 4, 2, 1),
                     attn_window=4), CodecConfig.snac_44khz, 768),
    "mimi": (dict(encoder_dim=8, encoder_rates=(2, 2, 2, 2), decoder_rates=(2, 2, 2, 2), latent_dim=32,
                  decoder_dim=128, tfm_layers=2, tfm_heads=2, tfm_ffn=64, tfm_context=8, codebook_size=64,
                  codebook_dim=16, vq_strides=(1,) * 4, semantic_levels=1, n_q=4), CodecConfig.mimi, 1280),
}


def _case(c, k, b, t, seed, dtype):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.standard_normal((b, c, t)), dtype=torch.float32).to(dtype)
    w = torch.as_tensor(rng.standard_normal((1, c, k)) / np.sqrt(c * k), dtype=torch.float32)
    bias = torch.as_tensor(rng.standard_normal(1) * 0.1, dtype=torch.float32)
    return x, w, bias


def _chain(x, w, bias, pads):
    """The decoders' last conv before the kernel: x.float(), F.pad, the
    float32 conv."""
    return F.conv1d(F.pad(x.float(), pads), w, bias)


def _widened(x, w, bias, pads, residual=None):
    return conv_op.conv1d(x, w, bias, 1, lambda t: pads, 1, 1, residual, widen=True)


@pytest.mark.parametrize("tail", list(TAILS))
def test_takes_admits_the_four_tails(tail):
    dtype, c, k, pads = TAILS[tail]
    x, w, bias = _case(c, k, 1, 16, 0, dtype)
    assert outconv.takes(x, w, bias, 1, 1, 1, pads)
    assert outconv.takes(x, w, None, 1, 1, 1, pads)


@pytest.mark.parametrize("case", ["C_out 2", "stride 2", "groups 2", "k 9", "k 5", "k 1", "pads 3/2 at k 7",
                                  "pads 1/1 at k 7", "pads 0/1 at k 3", "dilation 2", "float16 x",
                                  "bfloat16 weight", "bfloat16 bias", "C_in 1025", "T 20", "x at an offset",
                                  "strided x"])
def test_takes_refuses_the_rest(case):
    x, w, bias = _case(48, 7, 1, 16, 0, torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    kw = dict(x=x, w=w, bias=bias, stride=1, dilation=1, groups=1, pads=(3, 3))
    kw.update({"C_out 2": dict(w=torch.zeros(2, 48, 7)), "stride 2": dict(stride=2),
               "groups 2": dict(w=torch.zeros(1, 24, 7), groups=2), "k 9": dict(w=torch.zeros(1, 48, 9),
                                                                                 pads=(4, 4)),
               "pads 3/2 at k 7": dict(pads=(3, 2)), "pads 1/1 at k 7": dict(pads=(1, 1)),
               "pads 0/1 at k 3": dict(w=torch.zeros(1, 48, 3), pads=(0, 1)), "dilation 2": dict(dilation=2),
               "float16 x": dict(x=x.half()), "bfloat16 weight": dict(w=w.to(torch.bfloat16)),
               "bfloat16 bias": dict(bias=bias.to(torch.bfloat16)),
               "C_in 1025": dict(x=torch.zeros(1, 1025, 16), w=torch.zeros(1, 1025, 7)),
               "k 5": dict(w=torch.zeros(1, 48, 5), pads=(2, 2)), "k 1": dict(w=torch.zeros(1, 48, 1), pads=(0, 0)),
               "T 20": dict(x=_case(48, 7, 1, 20, 0, torch.bfloat16)[0]),
               "x at an offset": dict(x=torch.zeros(48 * 16 + 1, dtype=torch.bfloat16)[1:].view(1, 48, 16)),
               "strided x": dict(x=torch.zeros(1, 16, 48, dtype=torch.bfloat16).transpose(1, 2))}[case])
    assert not outconv.takes(kw["x"], kw["w"], kw["bias"], kw["stride"], kw["dilation"], kw["groups"], kw["pads"])


@pytest.mark.parametrize("b,t", [(2, 37), (1, 2), (3, 64)])
@pytest.mark.parametrize("tail", list(TAILS))
def test_plain_route_is_the_old_chain_bit_for_bit(tail, b, t):
    """On the CPU the widened conv is ``x.float()`` and the float32 conv at
    its padding, bit for bit, with and without a bias, the padding given as
    a function of T or (SAME) as an int; float32 out."""
    dtype, c, k, pads = TAILS[tail]
    x, w, bias = _case(c, k, b, t, seed=c + k + t, dtype=dtype)
    before = outconv._KERNEL.launches
    for bi in (bias, None):
        want = _chain(x, w, bi, pads)
        got = _widened(x, w, bi, pads)
        assert got.dtype == torch.float32 and got.shape == (b, 1, t)
        assert torch.equal(got, want)
        if pads[0] == pads[1]:
            assert torch.equal(conv_op.conv1d(x, w, bi, 1, pads[0], 1, 1, widen=True), want)
    assert outconv._KERNEL.launches == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("codec", list(SMALL_CODECS))
def test_decoders_decode_as_through_the_old_chain(codec, dtype):
    """Each layout's decoder at a small width hands its last conv the
    activation in the compute type, unwidened, and returns bit for bit
    what the old chain (x.float(), F.pad, the float32 conv; then tanh in
    the SNAC-style layouts) gives on that activation."""
    widths, make, samples = SMALL_CODECS[codec]
    cfg = make(**widths, compute_dtype="bfloat16" if dtype == torch.bfloat16 else "float32")
    torch.manual_seed(3)
    model = (mimi.MimiCodec(cfg) if cfg.layout == "mimi" else SnacCodec(cfg)).eval()
    conv = model.decoder.seanet.Conv_1 if cfg.layout == "mimi" else model.decoder.Conv_1
    assert conv.widen and conv.out_channels == 1
    seen = []
    conv.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    wav = torch.randn(2, samples) * 0.1
    with torch.no_grad():
        y = model.decoder(model.encoder(wav))
    (h,) = seen
    assert h.dtype == dtype
    want = _chain(h, conv.weight, conv.bias, conv.pads(h.shape[-1]))[:, 0]
    want = want if cfg.layout == "mimi" else torch.tanh(want)
    assert y.dtype == torch.float32 and torch.equal(y, want)


@pytest.mark.parametrize("tail", list(TAILS))
def test_gradient_is_autograd_of_the_old_chain(tail):
    """x's, the weight's and the bias's gradients through the widened conv
    (through the op, the module and the kernel's autograd Function, which
    computes the backward on the card) equal autograd of the old chain, dx
    in x's type."""
    dtype, c, k, pads = TAILS[tail]
    x, w, bias = _case(c, k, 2, 41, seed=7, dtype=dtype)
    g = torch.randn(2, 1, 41)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        return torch.autograd.grad(fn(*leaves), leaves, g)

    want = grads(lambda a, b_, c_: _chain(a, b_, c_, pads))
    conv = (layers.SameConv1d if pads[0] == pads[1] else mimi.CausalConv1d)(c, 1, k, widen=True)
    assert conv.pads(41) == pads

    def module(a, b_, c_):
        return torch.func.functional_call(conv, {"weight": b_, "bias": c_}, (a,))

    def function(a, b_, c_):  # the kernel's autograd wiring, its forward the plain chain on the CPU
        return conv_op._WidenedConv.apply(a, b_, c_, lambda t: pads)

    for got in (grads(lambda a, b_, c_: _widened(a, b_, c_, pads)), grads(module), grads(function)):
        assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
        for a, b_ in zip(got, want):
            assert torch.equal(a, b_)


@pytest.fixture
def stubbed_card(monkeypatch):
    """``ops.conv.conv1d`` on the card's route with the C entry of
    ``csrc/outconv.cu`` stubbed: -> the argument tuples it was called with.
    The launch counting runs as on the card; the process's count of
    ``launches.outconv`` is put back after the test, so that no other test
    of the worker sees a launch."""
    calls = []
    monkeypatch.setitem(profiling._REC.totals, "launches.outconv", profiling.total("launches.outconv"))
    monkeypatch.setattr(_lib, "use_kernel", lambda x: not _lib._force_plain.get())
    monkeypatch.setattr(outconv, "_check", lambda *a: None)
    monkeypatch.setattr(_lib, "stream", lambda t: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(outconv._KERNEL, "_fn", lambda *a: calls.append(a) or 0)
    return calls


@pytest.mark.parametrize("tail", list(TAILS))
def test_widened_conv_launches_the_kernel_at_its_left_pad(stubbed_card, tail):
    """Without a gradient the widened conv is one launch of the kernel on
    x in place: its element size, the shape, k and the left pad; a float32
    (B, 1, T) output; one ``launches.outconv``."""
    dtype, c, k, pads = TAILS[tail]
    x, w, bias = _case(c, k, 2, 40, 0, dtype)
    before = profiling.total("launches.outconv")
    with torch.no_grad():
        y = _widened(x, w, bias, pads)
    assert y.dtype == torch.float32 and y.shape == (2, 1, 40)
    (args,) = stubbed_card
    assert args[0].value == x.data_ptr() and args[1] == x.element_size()
    assert args[5:10] == (2, c, 40, k, pads[0])
    assert args[3].value == bias.data_ptr()
    assert profiling.total("launches.outconv") == before + 1


@pytest.mark.parametrize("case", ["gradient of x", "gradient of the weight", "gradient of the bias"])
def test_widened_conv_with_a_gradient_launches_the_kernel(stubbed_card, case):
    """Where a gradient is wanted the widened conv is one launch of the
    kernel too, through ``_WidenedConv``, whose backward gives autograd of
    the old chain: dx in x's type, dw and db float32."""
    x, w, bias = _case(48, 7, 2, 40, 0, torch.bfloat16)
    leaves = [t.clone().requires_grad_(case == name) for t, name in
              ((x, "gradient of x"), (w, "gradient of the weight"), (bias, "gradient of the bias"))]
    y = _widened(*leaves, (3, 3))
    (args,) = stubbed_card
    assert args[5:10] == (2, 48, 40, 7, 3) and type(y.grad_fn).__name__ == "_WidenedConvBackward"
    g = torch.randn(2, 1, 40)
    (got,) = torch.autograd.grad(y, [t for t in leaves if t.requires_grad], g)
    chain_leaves = [t.detach().clone().requires_grad_(t.requires_grad) for t in leaves]
    (want,) = torch.autograd.grad(_chain(*chain_leaves, (3, 3)), [t for t in chain_leaves if t.requires_grad], g)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("case", ["k 9", "k 5", "dilation 2", "T 44", "x at an offset", "plain versions",
                                  "not widened"])
def test_widened_conv_keeps_the_old_chain_where_the_kernel_does_not_run(stubbed_card, case):
    """A conv outside ``takes`` (k, dilation, a T not a multiple of 8, x
    not 16-byte aligned), the plain versions and a conv not asked to widen
    take the old route: no launch; the widened result is the old chain's."""
    k, d = {"k 9": (9, 1), "k 5": (5, 1), "dilation 2": (7, 2)}.get(case, (7, 1))
    t = 44 if case == "T 44" else 40
    x, w, bias = _case(48, k, 2, t, 0, torch.bfloat16)
    if case == "x at an offset":
        x = torch.cat([torch.zeros(1, dtype=x.dtype), x.flatten()])[1:].view(x.shape)
    p = d * (k - 1) // 2
    ctx = _lib.plain_versions() if case == "plain versions" else contextlib.nullcontext()
    with ctx:
        y = conv_op.conv1d(x, w, bias, 1, lambda t: (p, p), d, 1, widen=case != "not widened")
    assert stubbed_card == []
    if case != "not widened":
        want = F.conv1d(F.pad(x.float(), (p, p)), w, bias, dilation=d)
        assert y.dtype == torch.float32 and torch.equal(y, want)


def test_widened_conv_takes_no_residual():
    """A residual handed to a widened conv raises, on either route."""
    x, w, bias = _case(48, 7, 2, 40, 0, torch.bfloat16)
    with pytest.raises(ValueError, match="no residual"):
        conv_op.conv1d(x, w, bias, 1, 3, 1, 1, torch.zeros(2, 1, 40), widen=True)


def test_launch_refuses_what_the_kernel_does_not_take():
    """k 9, a left pad past k - 1, a T not a multiple of 8, a weight of
    other channels and a CPU x raise before any launch."""
    x, w, bias = _case(48, 7, 1, 16, 0, torch.bfloat16)
    before = outconv._KERNEL.launches
    for xi, wi, left, why in ((x, torch.zeros(1, 48, 9), 4, "does not take"), (x, w, 7, "does not take"),
                              (x[..., :12], w, 3, "does not take"), (x, w[:, :40], 3, "weight"),
                              (x, w, 3, "CUDA")):
        with pytest.raises(ValueError, match=why):
            outconv.launch(xi, wi, bias, left)
    assert outconv._KERNEL.launches == before


@pytest.fixture
def recorder():
    """The span recorder, cleared and on; off and cleared after the test."""
    profiling.disable()
    profiling.snapshot()
    profiling.enable()
    yield profiling
    profiling.disable()
    profiling.snapshot()


@pytest.mark.parametrize("codec", list(SMALL_CODECS))
def test_outconv_span_wraps_the_last_conv_once_a_decode(recorder, codec):
    """One decode opens ``codec.outconv`` once, inside ``codec.decode``."""
    widths, make, samples = SMALL_CODECS[codec]
    cfg = make(**widths, compute_dtype="bfloat16")
    torch.manual_seed(3)
    model = (mimi.MimiCodec(cfg) if cfg.layout == "mimi" else SnacCodec(cfg)).eval()
    with torch.no_grad():
        z = model.encoder(torch.randn(2, samples) * 0.1)
        recorder.snapshot()
        model.decoder(z)
    spans = recorder.snapshot()["spans"]
    mine = [s for s in spans if s["name"] == "codec.outconv"]
    decode = [s for s in spans if s["name"] == "codec.decode"]
    assert len(mine) == 1 and len(decode) == 1
    parents = {s["id"]: s["parent"] for s in spans}
    up = mine[0]["parent"]
    while up is not None and up != decode[0]["id"]:
        up = parents[up]
    assert up == decode[0]["id"]


def test_bound_bytes_is_x_once_and_the_output_once():
    """Mimi's 16 x 30 s tail: 1.47 GB of bfloat16 read, 46 MB of float32
    written, 0.454 ms at 3.35 TB/s."""
    n = outconv.bound_bytes(16, 64, 720_000, 3, 2)
    assert n == 16 * 64 * 720_000 * 2 + 16 * 720_000 * 4 + 4 * (64 * 3 + 1)
    assert round(n / 3.35e12 * 1e3, 3) == 0.454
