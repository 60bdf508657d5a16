"""The CUDA kernels of nawc_tpu_torch against their plain versions, on the
card.  Every test carries the ``cuda`` marker and skips without a GPU; the
decision is taken inside the fixture, so every worker collects the same
tests.  On the card (``tests/conftest.py`` imports JAX, which that machine
lacks, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from nawc_tpu_torch.codec.model import ResidualVQ
from nawc_tpu_torch.ops import _lib, parity, rvq, rvq_fused, sswm
from nawc_tpu_torch.ops.conv import conv1d
from nawc_tpu_torch.tools.conv_layers import depthwise_geometries, stride1_geometries
from nawc_tpu_torch.utils.config import CodecConfig

pytestmark = pytest.mark.cuda
_OFFS = (17, 23, 29, 37, 47, 53)
_Z_TOL = 1e-4  # sswm z against plain: the 3xTF32 split holds it, one TF32 pass would not


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _g(rng, shape, dev, scale=1.0):
    return torch.as_tensor(rng.standard_normal(shape) * scale, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("shape", [(16, 126, 367, 16), (16, 376, 367, 16), (3, 77, 130, 16),
                                   (8, 250, 450, 60),
                                   # the psychoacoustic detector at 44.1 kHz on 4 s clips,
                                   # and its message-length discovery (64 symbols x 12 bits)
                                   (8, 346, 427, 60), (2, 346, 427, 768)])
def test_whiten_correlate_kernel(dev, shape):
    b, t, w, k = shape
    rng = np.random.default_rng(0)
    r = _g(rng, (b, t, w), dev, 0.3)
    p = torch.sign(_g(rng, (k, t, w), dev))
    before = sswm._KERNEL.launches
    got = sswm.whiten_correlate(r, p, _OFFS)
    torch.cuda.synchronize()
    assert sswm._KERNEL.launches == before + 1
    with _lib.plain_versions():
        want = sswm.whiten_correlate(r, p, _OFFS)
    assert float((got - want).abs().max()) <= _Z_TOL
    sure = want.abs() > 1e-2
    assert bool(((got > 0) == (want > 0))[sure].all())


@pytest.mark.parametrize("b,t,w,k,patterns", [
    (16, 40, 367, 16, "sign"),    # T below the largest roll: offsets mod T
    (1, 376, 367, 16, "sign"),
    (3, 376, 367, 16, "gauss"),
    (16, 376, 367, 64, "gauss"),  # four k-tiles
    (20, 20, 9, 3, "gauss"),      # two b-tiles, T and W below one unit
    (5, 10, 30, 16, "sign"),      # T below the statistics' 16 rows
    (3, 1, 50, 8, "gauss"),       # T = 1: every roll is 0 and rs is 0
    (4, 1001, 40, 16, "gauss"),   # T past 512: the statistics' long-T loop
])
def test_whiten_correlate_kernel_odd_shapes(dev, b, t, w, k, patterns):
    rng = np.random.default_rng(b * t + k)
    r = _g(rng, (b, t, w), dev, 0.3)
    p = _g(rng, (k, t, w), dev)
    if patterns == "sign":
        p = torch.sign(p)
    got = sswm.whiten_correlate(r, p, _OFFS)
    with _lib.plain_versions():
        want = sswm.whiten_correlate(r, p, _OFFS)
    assert got.shape == want.shape == (b, k)
    assert float((got - want).abs().max()) <= _Z_TOL


@pytest.mark.parametrize("shape", [(16, 376, 367, 16), (3, 77, 130, 16)])
def test_whiten_correlate_kernel_gradient_is_the_plain_one(dev, shape):
    """d(sum z * w)/dr and /dp through the kernel's route equal those of the
    plain version: both run the plain backward on the same r, p and w, so
    they must be equal, not merely close."""
    b, t, w, k = shape
    rng = np.random.default_rng(16)
    r0, p0, wt = _g(rng, (b, t, w), dev, 0.3), torch.sign(_g(rng, (k, t, w), dev)), _g(rng, (b, k), dev)

    def grads():
        r, p = r0.clone().requires_grad_(True), p0.clone().requires_grad_(True)
        z = sswm.whiten_correlate(r, p, _OFFS)
        (z * wt).sum().backward()
        return z, r.grad, p.grad

    n = sswm._KERNEL.launches
    z_k, gr_k, gp_k = grads()
    assert sswm._KERNEL.launches == n + 1 and z_k.grad_fn is not None
    with _lib.plain_versions():
        _, gr_p, gp_p = grads()
    assert torch.equal(gr_k, gr_p) and torch.equal(gp_k, gp_p)


def test_whiten_correlate_kernel_is_deterministic(dev):
    rng = np.random.default_rng(11)
    r = _g(rng, (16, 376, 367), dev, 0.3)
    p = _g(rng, (16, 376, 367), dev)
    a = sswm.whiten_correlate(r, p, _OFFS)
    b = sswm.whiten_correlate(r, p, _OFFS)
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,k,d", [(768, 4096, 8), (3072, 4096, 8), (1001, 300, 5), (64, 128, 32),
                                   (1, 4096, 8), (1001, 4096, 16)])
def test_nearest_codebook_kernel(dev, n, k, d):
    rng = np.random.default_rng(n)
    z, cb = _g(rng, (n, d), dev), _g(rng, (k, d), dev)
    got = rvq.nearest_codebook(z, cb)
    with _lib.plain_versions():
        want = rvq.nearest_codebook(z, cb)
    assert torch.equal(want, rvq.nearest_codebook_reference(z, cb))
    mism, frames, _ = parity.compare_lookup(got, z, cb)
    parity.check_share(mism, frames, "nearest_codebook")


def test_nearest_codebook_follows_a_changed_codebook(dev):
    """The normalised codebook is kept per codebook tensor, and made anew
    once the codebook changes in place."""
    rng = np.random.default_rng(9)
    z, cb = _g(rng, (500, 8), dev), _g(rng, (256, 8), dev)
    rvq.nearest_codebook(z, cb)
    cb.mul_(-1.0)
    mism, frames, _ = parity.compare_lookup(rvq.nearest_codebook(z, cb), z, cb)
    parity.check_share(mism, frames, "nearest_codebook")


def test_nearest_codebook_ties_take_first_index(dev):
    cb = torch.tensor([[1, 0], [0, 1], [1, 0], [2, 0]], dtype=torch.float32, device=dev)
    z = torch.tensor([[3, 0], [0, 5], [-1, 0]], dtype=torch.float32, device=dev)
    assert rvq.nearest_codebook(z, cb).tolist() == [0, 1, 1]


def _random_vq(rng, dev, **cfg):
    """A residual VQ with numpy-drawn float32 tables (fan-in scaled)."""
    q = ResidualVQ(CodecConfig(**cfg))
    with torch.no_grad():
        for prm in q.parameters():
            fan = prm.shape[-1] if prm.ndim > 1 else 1
            prm.copy_(torch.as_tensor(rng.standard_normal(tuple(prm.shape)) / np.sqrt(fan)))
    return q.to(dev).requires_grad_(False)


def _check_rvq(q, z, strides=(4, 2, 1)):
    got = rvq_fused.rvq_encode_fused(z, q, strides)
    with _lib.plain_versions():
        want = rvq_fused.rvq_encode_fused(z, q, strides)
    for w, w_ref in zip(want, rvq_fused.rvq_encode_reference(z, q, strides)):
        assert torch.equal(w, w_ref)
    parity.compare_rvq(got, z, q, strides)
    return got


# (16, 188) is bench.py's unpadded encode; 100 and 188 end in a ragged tile
@pytest.mark.parametrize("b,t_lat", [(4, 256), (4, 768), (16, 192), (3, 100), (16, 188)])
def test_rvq_encode_fused_kernel(dev, b, t_lat):
    rng = np.random.default_rng(t_lat)
    q = _random_vq(rng, dev)
    _check_rvq(q, _g(rng, (b, t_lat, 768), dev))


# ragged code slices (K = 300), a padded width (C = 5 -> 8), C = 16 and 32
# with slices too large to stay in shared memory (K = 4096), ragged channel
# slices (Dl = 100, 5), and one and four levels
@pytest.mark.parametrize("dl,k,c,strides", [
    (768, 300, 8, (4, 2, 1)), (768, 300, 32, (4, 2, 1)), (768, 300, 5, (4, 2, 1)),
    (768, 4096, 16, (4, 2, 1)), (768, 4096, 32, (4, 2, 1)), (100, 4096, 8, (4, 2, 1)),
    (5, 64, 8, (2, 1)), (64, 128, 8, (1,)), (96, 512, 8, (8, 4, 2, 1)),
])
def test_rvq_encode_fused_kernel_odd_tables(dev, dl, k, c, strides):
    rng = np.random.default_rng(dl + k + c)
    q = _random_vq(rng, dev, latent_dim=dl, codebook_size=k, codebook_dim=c, vq_strides=strides)
    _check_rvq(q, _g(rng, (3, 72, dl), dev), strides)


@pytest.mark.parametrize("dl,strides,t_lat", [(768, (5,), 10), (768, (16, 1), 32), (4096, (4, 2, 1), 24)])
def test_rvq_encode_fused_refuses_what_it_does_not_take(dev, dl, strides, t_lat):
    """A stride that does not divide the 24-frame tile, or a tile of Dl
    channels beyond shared memory, raises; nothing falls back."""
    rng = np.random.default_rng(17)
    q = _random_vq(rng, dev, latent_dim=dl, vq_strides=strides)
    with pytest.raises(RuntimeError, match="rvq_encode_fused"):
        rvq_fused.rvq_encode_fused(_g(rng, (2, t_lat, dl), dev), q, strides)


def test_rvq_encode_fused_is_deterministic(dev):
    rng = np.random.default_rng(14)
    q = _random_vq(rng, dev)
    z = _g(rng, (16, 188, 768), dev)
    a = rvq_fused.rvq_encode_fused(z, q, (4, 2, 1))
    b = rvq_fused.rvq_encode_fused(z, q, (4, 2, 1))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rvq_encode_fused_tie_across_slices_takes_first_index(dev):
    """Codes 100 and 3000 lie in different codebook slices of the cluster.
    Every level's bias is made to dominate z_e and both rows point along it,
    so every frame scores them equal and highest: every code must be 100."""
    rng = np.random.default_rng(15)
    q = _random_vq(rng, dev)
    with torch.no_grad():
        for lvl in q.levels:
            v = _g(rng, (8,), dev)
            lvl.in_proj.bias.copy_(v * 1e3)
            lvl.codebook[100] = v
            lvl.codebook[3000] = v
    z = _g(rng, (4, 96, 768), dev)
    got = rvq_fused.rvq_encode_fused(z, q, (4, 2, 1))
    with _lib.plain_versions():
        want = rvq_fused.rvq_encode_fused(z, q, (4, 2, 1))
    for g, w in zip(got, want):
        assert bool((w == 100).all()) and torch.equal(g, w)


def test_nearest_codebook_tie_across_slices_takes_first_index(dev):
    """Codes 100 and 3000 lie in different slices of the split codebook;
    equal scores must give 100, as argmax does."""
    rng = np.random.default_rng(12)
    cb = _g(rng, (4096, 8), dev)
    cb[3000] = cb[100]
    z = cb[100][None, :].repeat(40, 1) * torch.linspace(0.5, 3.0, 40, device=dev)[:, None]
    assert rvq.nearest_codebook(z, cb).tolist() == [100] * 40


def test_nearest_codebook_identical_rows_give_index_zero(dev):
    rng = np.random.default_rng(13)
    cb = _g(rng, (1, 8), dev).repeat(4096, 1)
    z = _g(rng, (300, 8), dev)
    assert rvq.nearest_codebook(z, cb).tolist() == [0] * 300


def test_rvq_encode_fused_repacks_changed_tables(dev):
    """The packed tables are kept per quantizer, and packed anew once a
    table changes in place."""
    rng = np.random.default_rng(5)
    q = ResidualVQ(CodecConfig()).to(dev).requires_grad_(False)
    with torch.no_grad():
        for prm in q.parameters():
            prm.copy_(_g(rng, tuple(prm.shape), dev))
    z = _g(rng, (2, 64, 768), dev)
    strides = (4, 2, 1)
    rvq_fused.rvq_encode_fused(z, q, strides)
    with torch.no_grad():
        q.level_0.codebook.mul_(-1.0)
    parity.compare_rvq(rvq_fused.rvq_encode_fused(z, q, strides), z, q, strides)


def test_cuda_tensor_never_falls_back(dev):
    """A CUDA tensor launches the kernel; the plain version runs only when
    asked for."""
    r = torch.randn(2, 64, 40, device=dev)
    p = torch.sign(torch.randn(4, 64, 40, device=dev))
    n = sswm._KERNEL.launches
    sswm.whiten_correlate(r, p, _OFFS)
    with _lib.plain_versions():
        sswm.whiten_correlate(r, p, _OFFS)
    assert sswm._KERNEL.launches == n + 1


@pytest.mark.parametrize("form", ["default", "foreach", "fused", "for-loop", "revival"])
def test_nearest_codebook_follows_a_trained_codebook(dev, form):
    """The lookup after the codebook is moved in place by a training step
    (``torch.optim.AdamW`` in its default, foreach, fused and for-loop
    forms, through the port's optax-order wrapper, which moves the versions
    that the fused form leaves) or by the dead-code revival's ``copy_``: the
    codebook's version moves and the codes equal plain on the new table
    (the kernel's normalised table is rebuilt)."""
    from nawc_tpu_torch.codec.model import SnacCodec
    from nawc_tpu_torch.train.codec_train import revive_dead_codes
    from nawc_tpu_torch.train.optim import AdamW

    cfg = CodecConfig(encoder_dim=8, latent_dim=64, decoder_dim=64, codebook_size=128, codebook_dim=8)
    rng = np.random.default_rng(5)
    quant = SnacCodec(cfg).quantizer.to(dev)
    for lvl in quant.levels:
        lvl.codebook.data = _g(rng, tuple(lvl.codebook.shape), dev)
    z = _g(rng, (4, 32, 64), dev)
    codes0 = [c.clone() for c in quant(z)[1]]  # warms the cached tables
    versions = [lvl.codebook._version for lvl in quant.levels]
    if form == "revival":
        usage = {i: np.where(np.arange(128) % 3 == 0, 0, 5).astype(np.int64) for i in range(3)}
        assert revive_dead_codes(SimpleNamespace(quantizer=quant), usage, cfg, np.random.default_rng(7))[0] > 0
    else:
        kw = {"default": {}, "foreach": {"foreach": True}, "fused": {"fused": True},
              "for-loop": {"foreach": False}}[form]
        opt = AdamW(quant.parameters(), 0.05, weight_decay=1e-4, **kw)
        for _ in range(3):
            opt.zero_grad()
            _, _, commit, cb_loss = quant(z)
            (commit + cb_loss).backward()
            opt.step()
    assert all(lvl.codebook._version > v for lvl, v in zip(quant.levels, versions)), form
    before = rvq._KERNEL.launches
    _, got, _, _ = quant(z)
    torch.cuda.synchronize()
    assert rvq._KERNEL.launches == before + 3
    with _lib.plain_versions():
        _, want, _, _ = quant(z)
    assert any(not torch.equal(a, b) for a, b in zip(codes0, want)), "the codebook did not move the codes"
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_codec_training_step_codes_equal_plain(dev):
    """A codec training step at full width (4 x 32768 samples): the codes of
    its three lookups, on the kernel, equal the plain codes of the same
    step from a copy of the same state, before and after an update."""
    import copy

    from nawc_tpu_torch.train.codec_train import init_codec_train, make_codec_train_step

    cfg = CodecConfig()
    state = init_codec_train(0, cfg, device=dev)
    step = make_codec_train_step(cfg)
    wav = _g(np.random.default_rng(6), (4, 32_768), dev, 0.1)
    for _ in range(2):
        ref = copy.deepcopy(state)
        with _lib.plain_versions():
            want = step(ref, wav)
        got = step(state, wav)
        for i in range(cfg.num_levels):
            assert torch.equal(got[f"usage_{i}"], want[f"usage_{i}"]), i
        assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(float(want["loss"]))


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint32)


@pytest.mark.parametrize("draw,shape,key,lohi", [
    # the uncertainty run's noise: 20 MC passes over 32 clips of 2 s at 16 kHz
    ("normal", (20, 32, 32_000), (0, 1), None),
    ("uniform", (20, 32, 32_000), (0, 1), (-0.5, 0.5)),
    # the sweep's noise attacks on 32 chunks of 2 s at 16 kHz
    ("normal", (32, 32_000), (0, 0), None),
    ("uniform", (32, 32_000), (0, 0), (0.0, 1.0)),
])
def test_jaxrand_kernel_is_the_replica_bit_for_bit(dev, draw, shape, key, lohi):
    """Over 10^7 draws and more: one contracted multiply-add in the kernel
    would show as a few differing draws per million."""
    from nawc_tpu_torch.ops import jaxrand as keyed
    from nawc_tpu_torch.utils import jaxrand

    key = np.array(key, np.uint32)
    before = keyed._KERNEL.launches
    if draw == "normal":
        got, want = keyed.normal(key, shape, dev), jaxrand.normal(key, shape)
    else:
        got, want = keyed.uniform(key, shape, dev, *lohi), jaxrand.uniform(key, shape, *lohi)
    torch.cuda.synchronize()
    assert keyed._KERNEL.launches == before + 1
    assert got.shape == want.shape and got.device.type == "cuda"
    diff = _bits(got.cpu().numpy()) != _bits(want)
    assert not diff.any(), f"{int(diff.sum())} of {diff.size} draws differ, first at {np.argwhere(diff)[:3]}"


def test_jaxrand_normal_of_every_uniform_is_the_replica(dev):
    """The normal draw's device code over its whole domain: every 23-bit
    mantissa (the low 9 bits, which the draw drops, set in a few), bit for
    bit the replica's ``normal_from_bits``; the draw's float32 fmas stand
    in for the replica's twice-rounded steps only because they agree on
    all of these."""
    from nawc_tpu_torch.ops import jaxrand as keyed
    from nawc_tpu_torch.utils import jaxrand

    bits = np.arange(2**23, dtype=np.uint32) << np.uint32(9)
    bits[::7] |= np.uint32(0x1FF)
    before = keyed._BITS_KERNEL.launches
    got = keyed.normal_of_bits(torch.from_numpy(bits.view(np.int32)).to(dev))
    torch.cuda.synchronize()
    assert keyed._BITS_KERNEL.launches == before + 1 and got.device.type == "cuda"
    diff = _bits(got.cpu().numpy()) != _bits(jaxrand.normal_from_bits(bits))
    assert not diff.any(), f"{int(diff.sum())} of {diff.size} normals differ, first at {np.flatnonzero(diff)[:3]}"


# ---------------------------------------------------------------- the Snake

_ENCODER_SHAPES = [(16, 48, 96_000), (16, 96, 48_000), (16, 192, 12_000), (16, 384, 1_500),
                   (16, 768, 188)]
_ODD_SHAPES = [(2, 5, 1), (3, 7, 3), (4, 768, 188), (2, 3, 1001), (3, 1, 1001), (1, 1, 1)]
# short rows, one warp each: the codec-latent embed's last Snake, the
# trainers' and a mid-encoder one, at offsets that misalign the rows
_SHORT_ROWS = [((4, 768, 94), 0), ((4, 768, 94), 1), ((16, 768, 64), 3), ((3, 384, 750), 0),
               ((3, 384, 750), 5)]


def _snake_ops():
    import sys

    import nawc_tpu_torch.ops  # noqa: F401

    return sys.modules["nawc_tpu_torch.ops.snake"]


def _snake_case(shape, dtype, dev, seed=0, offset=0):
    """x at 2 sigma (from element `offset` of a flat buffer, so that its
    address need not be 16-byte aligned), log alpha at 0.3 sigma, g at 1."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    buf = torch.as_tensor(rng.standard_normal(n + offset) * 2, dtype=torch.float32).to(dev, dtype)
    x = buf[offset:].view(shape)
    la = torch.as_tensor(rng.standard_normal(shape[1]) * 0.3, dtype=torch.float32, device=dev)
    g = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32).to(dev, dtype)
    return x, la, g


def _bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [(s, 0) for s in _ENCODER_SHAPES + _ODD_SHAPES]
                         + [((2, 3, 1001), 1), ((3, 7, 3), 3), ((4, 5, 188), 2)] + _SHORT_ROWS)
def test_snake_forward_is_the_plain_version_bit_for_bit(dev, shape, offset, dtype):
    """The plain version divides truly on the card too, so the kernel's
    one-rounding steps give its values bit for bit, in both types."""
    so = _snake_ops()
    x, la, _ = _snake_case(shape, dtype, dev, offset=offset)
    n = so._FORWARD.launches
    got = so.snake(x, la)
    torch.cuda.synchronize()
    assert so._FORWARD.launches == n + 1 and got.dtype == dtype and got.shape == x.shape
    want = so.snake_reference(x, la)
    diff = got != want
    assert not bool(diff.any()), (f"{int(diff.sum())} of {diff.numel()} differ, max "
                                  f"{float((got.float() - want.float()).abs().max())}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [(s, 0) for s in _ENCODER_SHAPES[2:] + _ODD_SHAPES]
                         + [((2, 3, 1001), 1), ((4, 5, 188), 2)] + _SHORT_ROWS)
def test_snake_backward_against_plain_autograd(dev, shape, offset, dtype):
    """dx and d log_alpha of the kernel against autograd of the plain
    forward (float32: 1e-6 of the largest |dx|, 1e-5 relative; bfloat16:
    one bfloat16 ulp of the largest of each), and dx bit for bit the
    formula ``snake_backward_reference`` on the same inputs."""
    so = _snake_ops()
    x, la, g = _snake_case(shape, dtype, dev, seed=1, offset=offset)
    xk, lk = x.clone().requires_grad_(), la.clone().requires_grad_()
    n = so._BACKWARD.launches
    dx, dla = torch.autograd.grad(so.snake(xk, lk), (xk, lk), g)
    torch.cuda.synchronize()
    assert so._BACKWARD.launches == n + 1 and dx.dtype == dtype and dla.dtype == torch.float32
    xp, lp = x.clone().requires_grad_(), la.clone().requires_grad_()
    want_dx, want_dla = torch.autograd.grad(so.snake_reference(xp, lp), (xp, lp), g)
    err_dx = float((dx.float() - want_dx.float()).abs().max())
    err_dla = float((dla - want_dla).abs().max())
    top_dx, top_dla = float(want_dx.float().abs().max()), float(want_dla.abs().max())
    if dtype == torch.float32:
        assert err_dx <= 1e-6 * top_dx and err_dla <= 1e-5 * top_dla, (err_dx, top_dx, err_dla, top_dla)
    else:
        assert err_dx <= _bf16_ulp(top_dx) and err_dla <= _bf16_ulp(top_dla), (err_dx, top_dx, err_dla, top_dla)
    fdx, _ = so.snake_backward_reference(x, torch.exp(la).to(dtype).float(), g)
    assert torch.equal(dx, fdx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [((16, 48, 96_000), 0)] + _SHORT_ROWS[1:3])
def test_snake_backward_is_deterministic(dev, shape, offset, dtype):
    """Two runs give the same dx and d alpha bits; dx alone (d alpha not
    wanted: the other instantiation) is the same dx."""
    so = _snake_ops()
    x, la, g = _snake_case(shape, dtype, dev, seed=2, offset=offset)
    alpha = torch.exp(la).to(dtype).float()
    a = so._backward_cuda(x, alpha, g, True, True)
    b = so._backward_cuda(x, alpha, g, True, True)
    only_dx, none = so._backward_cuda(x, alpha, g, True, False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))
    assert torch.equal(only_dx, a[0]) and none is None


def test_snake_backward_of_an_empty_batch(dev):
    """No launch for an empty activation: d alpha is zeros, not the
    uninitialised memory the kernel would otherwise overwrite."""
    so = _snake_ops()
    x = torch.zeros(0, 3, 8, device=dev)
    n = so._BACKWARD.launches
    dx, dalpha = so._backward_cuda(x, torch.ones(3, device=dev), x, True, True)
    assert so._BACKWARD.launches == n and dx.shape == x.shape and torch.equal(dalpha, torch.zeros(3, device=dev))


@pytest.mark.parametrize("d", [6, 20, 42])
def test_snake_division_check_on_a_strided_subset(dev, d):
    """The kernel's division by d, through its check entry, over 2^24
    float32 patterns 257 apart (every binade's share, subnormals, zeros,
    infinities and NaNs among them), equals __fdiv_rn; the two-constant
    sequence alone differs only below 2^-94, where the guard hands over."""
    so = _snake_ops()
    n = so.check_constant_division(d, dev, first=12345, step=257, count=2**24)
    torch.cuda.synchronize()
    assert n["differ"] == 0 and n["fast"] > 2**23, n
    assert n["fast_alone_max"] < 2.0**-94, n


def test_snake_channel_division_check(dev):
    """The kernel's division by a + 1e-9 through its check entry equals
    __fdiv_rn over all 2^32 numerators for three dens, one of them outside
    the Markstein sequence's range (the IEEE fallback), and the bfloat16
    kernels' sequence over all bfloat16 numerators for four bfloat16 dens."""
    so = _snake_ops()
    dens = torch.tensor([1.0 + 1e-9, 0.7071068, 2.0**-21], device=dev)
    n = so.check_channel_division(dens)
    torch.cuda.synchronize()
    assert n["differ"] == 0 and n["pairs"] == 3 * 2**32 and 0 < n["fast"] < 2 * 2**32, n
    every_bf16 = (torch.arange(2**16, dtype=torch.int32, device=dev) << 16).view(torch.float32)
    dens = torch.tensor([1.0, 0.70703125, 3.40625, 2.0**-21], device=dev)  # bfloat16 values
    n = so.check_channel_division(dens, every_bf16, bfloat16=True)
    torch.cuda.synchronize()
    assert n["differ"] == 0 and n["pairs"] == 4 * 2**16 and n["fast"] > 0, n


def test_snake_refuses_what_it_does_not_take(dev):
    """A non-contiguous or float64 CUDA tensor raises; it never falls back."""
    so = _snake_ops()
    la = torch.zeros(3, device=dev)
    n = so._FORWARD.launches
    for bad in (torch.zeros(2, 8, 3, device=dev).transpose(1, 2),
                torch.zeros(2, 3, 8, device=dev, dtype=torch.float64)):
        with pytest.raises(ValueError):
            so.snake(bad, la)
    with pytest.raises(ValueError):
        so.snake(torch.zeros(2, 3, 8, device=dev), torch.zeros(4, device=dev))
    assert so._FORWARD.launches == n


def test_snake_under_no_grad_launches_the_forward_only(dev):
    so = _snake_ops()
    x, la, g = _snake_case((2, 4, 500), torch.float32, dev)
    la.requires_grad_()
    f, b = so._FORWARD.launches, so._BACKWARD.launches
    with torch.no_grad():
        so.snake(x, la)
    assert (so._FORWARD.launches, so._BACKWARD.launches) == (f + 1, b)
    # x needs no gradient: the backward computes d log_alpha alone
    (dla,) = torch.autograd.grad(so.snake(x, la), (la,), g)
    assert (so._FORWARD.launches, so._BACKWARD.launches) == (f + 2, b + 1)
    (want,) = torch.autograd.grad(so.snake_reference(x, la), (la,), g)
    assert float((dla - want).abs().max()) <= 1e-5 * float(want.abs().max())


# ---------------------------------------------------------------- the stride-1 convolutions

_SC_GEOMETRIES = sorted(set(g[:5] for g in stride1_geometries()))
_SC_FULL = [g for g in set(stride1_geometries()) if g[0] in (48, 768)]


def _same_conv_ops():
    from nawc_tpu_torch.ops import same_conv as sc

    return sc


def _sc_op(x, w, bias, d, res=None, pads=None):
    """The conv op at a conv in the stride-1 kernel's domain, padded by
    `pads` (left, right) or SAME's: on the card the kernel."""
    p = d * (w.shape[-1] - 1) // 2
    return conv1d(x, w, bias, 1, lambda t: pads or (p, p), d, 1, res)


def _sc_plain(x, w, bias, d, res=None, pads=None):
    """The op's plain version, on the card."""
    with _lib.plain_versions():
        return _sc_op(x, w, bias, d, res, pads)


def _sc_case(c_in, c_out, k, b, t, dev, seed, offset=0):
    """x at 1 sigma from element `offset` of a flat buffer (so that its
    address and rows need not be aligned), the flax init's weight scale, a
    bias at 0.1 and a residual at 1 sigma, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(b * c_in * t + offset, generator=gen, device=dev).to(torch.bfloat16)
    x = buf[offset:].view(b, c_in, t)
    w = torch.randn((c_out, c_in, k), generator=gen, device=dev) / (c_in * k) ** 0.5
    bias = torch.randn(c_out, generator=gen, device=dev) * 0.1
    rbuf = torch.randn(b * c_out * t + offset, generator=gen, device=dev).to(torch.bfloat16)
    return x, w, bias, rbuf[offset:].view(b, c_out, t)


def _sc_check(got, x, w, bias, d, res, pads=None) -> float:
    """The kernel's output `got` against the plain version.  With acc the
    float32 sum of the K = C_in k products and E = K 2^-22 sum |products|
    (twice the worst-case error of a float32 sum of K terms, in any order,
    rounded or truncated), asserted: the kernel's convolution alone (zero
    bias, no residual) lies within one bfloat16 ulp of |acc| plus E of
    RN(acc); `got` is, bit for bit, the plain bias and residual adds applied
    to that convolution; and `got` lies within two ulps of the largest of
    |acc|, |y| and |out| (y the conv with its bias) plus E of the plain
    version, the two adds after a flip of RN(acc) adding one more at ties.
    -> the largest |got - plain| in those ulps, E left out.  `pads`:
    (left, right), SAME's where None."""
    k = w.shape[-1]
    p = d * (k - 1) // 2
    xp, wb = torch.nn.functional.pad(x, pads or (p, p)).float(), w.to(torch.bfloat16).float()
    acc = torch.nn.functional.conv1d(xp, wb, None, 1, 0, d)
    err = torch.nn.functional.conv1d(xp.abs(), wb.abs(), None, 1, 0, d) * (x.shape[1] * k * 2.0**-22)

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(v.clamp_min(2.0**-126))) - 7)

    conv = _sc_op(x, w, torch.zeros_like(bias), d, pads=pads)
    rounded = acc.to(torch.bfloat16)
    off = (conv.float() - rounded.float()).abs()
    bar = ulp(torch.maximum(acc.abs(), rounded.float().abs())) + err
    assert bool((off <= bar).all()), f"the convolution is off RN(acc) by {float((off - bar).max())} past its bar"
    y_k = conv + bias.to(torch.bfloat16)[:, None]
    assert torch.equal(got, y_k if res is None else res + y_k)
    want = _sc_plain(x, w, bias, d, res, pads)
    y = _sc_plain(x, w, bias, d, pads=pads) if res is not None else want
    u = ulp(torch.maximum(torch.maximum(acc.abs(), y.float().abs()), want.float().abs()))
    off = (got.float() - want.float()).abs()
    assert bool((off <= 2 * u + err).all())
    return float((off / u).max())


@pytest.mark.parametrize("c_in,c_out,k,d,residual", _SC_GEOMETRIES)
@pytest.mark.parametrize("b,t,offset", [(2, 704, 0), (3, 301, 1)])
def test_same_conv_is_the_plain_version_within_one_ulp(dev, c_in, c_out, k, d, residual, b, t, offset):
    """Every codec geometry at a short T (copied in 16-byte pieces) and at a
    ragged one read from
    misaligned addresses, held to the plain version by ``_sc_check``; bit
    for bit on a second call; one launch each of the kernel its route takes
    (the GEMM path at k 1 on 16-byte rows, else the stencil kernel)."""
    sc = _same_conv_ops()
    x, w, bias, res = _sc_case(c_in, c_out, k, b, t, dev, seed=c_in + k + d, offset=offset)
    res = res if residual else None
    mine, other = (sc._K1, sc._KERNEL) if k == 1 and t % 8 == 0 and offset == 0 else (sc._KERNEL, sc._K1)
    n, m = mine.launches, other.launches
    got = _sc_op(x, w, bias, d, res)
    again = _sc_op(x, w, bias, d, res)
    torch.cuda.synchronize()
    assert (mine.launches - n, other.launches - m) == (2, 0)
    assert got.dtype == torch.bfloat16 and got.shape == (b, c_out, t)
    assert torch.equal(got, again)
    _sc_check(got, x, w, bias, d, res)


@pytest.mark.parametrize("c_in,c_out,k,d,residual,t", sorted(_SC_FULL))
def test_same_conv_at_the_full_batch(dev, c_in, c_out, k, d, residual, t):
    """The narrowest and the widest layers at the 16 x 4 s batch's T."""
    x, w, bias, res = _sc_case(c_in, c_out, k, 16, t, dev, seed=t + k + d)
    res = res if residual else None
    got = _sc_op(x, w, bias, d, res)
    _sc_check(got, x, w, bias, d, res)
    assert torch.equal(got, _sc_op(x, w, bias, d, res))


@pytest.mark.parametrize("t", [1, 5, 27, 64])
def test_same_conv_with_t_within_the_padding(dev, t):
    """T at or below the padding (27 at k 7, d 9): every tap but the centre
    reads zeros somewhere."""
    x, w, bias, res = _sc_case(48, 48, 7, 1, t, dev, seed=t)
    got = _sc_op(x, w, bias, 9, res)
    _sc_check(got, x, w, bias, 9, res)


def test_same_conv_refuses_what_it_does_not_take(dev):
    """float32, an even k, channel counts off 16 and a padding past 32
    raise; nothing launches."""
    sc = _same_conv_ops()
    x, w, bias, _ = _sc_case(48, 48, 7, 1, 50, dev, seed=0)
    n = sc._KERNEL.launches + sc._K1.launches
    bad = [(x.float(), w, 1), (x, w[..., :6], 1), (x[:, :40], w[:, :40], 1), (x, w[:40], 1), (x, w, 11)]
    for xi, wi, d in bad:
        with pytest.raises(ValueError):
            sc.launch(xi, wi, bias[: wi.shape[0]], None, d, d * (wi.shape[-1] - 1) // 2)
    assert sc._KERNEL.launches + sc._K1.launches == n


@pytest.mark.parametrize("c_in,c_out,k,d,residual", [(48, 48, 7, 3, False), (96, 96, 1, 1, True),
                                                     (32, 64, 3, 1, False)])
def test_same_conv_gradient_against_plain_autograd(dev, c_in, c_out, k, d, residual):
    """x, weight, bias and residual gradients through the op against
    autograd of the plain version, within one bfloat16 ulp of the largest
    of each."""
    sc = _same_conv_ops()
    x, w, bias, res = _sc_case(c_in, c_out, k, 3, 333, dev, seed=5)
    g = torch.randn(3, c_out, 333, device=dev).to(torch.bfloat16)
    ins = [x, w, bias] + ([res] if residual else [])

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = fn(leaves[0], leaves[1], leaves[2], d, leaves[3] if residual else None)
        return torch.autograd.grad(out, leaves, g)

    n = sc._KERNEL.launches
    got = grads(_sc_op)
    assert sc._KERNEL.launches == n + 1
    want = grads(_sc_plain)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= _bf16_ulp(float(b.float().abs().max()))


def test_same_conv_under_no_grad_keeps_no_graph(dev):
    """Under no_grad the op launches one kernel of ``csrc/same_conv.cu``
    alone, the stencil kernel at a k 7 conv and the GEMM path at a k 1
    conv: no autograd node, no other device operation."""
    sc = _same_conv_ops()
    for k, entry, name in ((7, sc._KERNEL, "same_conv"), (1, sc._K1, "k1conv")):
        x, w, bias, res = _sc_case(96, 96, k, 2, 512, dev, seed=3)
        w.requires_grad_()
        _sc_op(x, w, bias, 1, res)  # the weight tables, built once
        torch.cuda.synchronize()
        n, n_all = entry.launches, sc._KERNEL.launches + sc._K1.launches
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = _sc_op(x, w, bias, 1, res)
            torch.cuda.synchronize()
        assert out.grad_fn is None and not out.requires_grad
        assert entry.launches == n + 1 and sc._KERNEL.launches + sc._K1.launches == n_all + 1
        names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        assert names and all(name in key for key in names), (k, names)


def test_bf16_codec_launches_the_kernel_fifty_times(dev):
    """One bfloat16 encode and decode: 25 launches each, the 12 k 1 convs
    of each on the GEMM path and the 13 others on the stencil kernel; the
    latent and the waveform within 5% rms of the plain versions' (the
    kernels move roundings only; 5% is the benchmark's limit on the
    bfloat16 decode against float32)."""
    from nawc_tpu_torch.codec.model import SnacCodec

    sc = _same_conv_ops()
    torch.manual_seed(0)
    model = SnacCodec(CodecConfig(compute_dtype="bfloat16")).to(dev).eval()
    wav = torch.randn(2, 24_576, device=dev) * 0.1
    with torch.no_grad():
        n, n1 = sc._KERNEL.launches, sc._K1.launches
        z = model.encoder(wav)
        assert (sc._KERNEL.launches - n, sc._K1.launches - n1) == (13, 12)
        y = model.decoder(z)
        assert (sc._KERNEL.launches - n, sc._K1.launches - n1) == (26, 24)
        with _lib.plain_versions():
            z_p = model.encoder(wav)
            y_p = model.decoder(z)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    assert rel(z, z_p) < 0.05 and rel(y, y_p) < 0.05, (rel(z, z_p), rel(y, y_p))


# ---------------------------------------------------------------- the depthwise convolutions

# SNAC 44 kHz's (C, k, d): k 7 at d 1, 3 and 9, the kernel's whole domain
_DW_GEOMETRIES = sorted(set(g[:3] for g in depthwise_geometries()))


def _dw_ops():
    from nawc_tpu_torch.ops import dwconv as dw

    return dw


def _dw_op(x, w, bias, d):
    """The conv op at a depthwise conv in the kernel's domain, padded as
    ``SameConv1d`` pads one: on the card the kernel."""
    return conv1d(x, w, bias, 1, d * (w.shape[-1] - 1) // 2, d, w.shape[0])


def _dw_plain(x, w, bias, d):
    """The op's plain version, on the card."""
    with _lib.plain_versions():
        return _dw_op(x, w, bias, d)


def _dw_case(c, k, b, t, dev, seed, offset=0):
    """x at 1 sigma from element `offset` of a flat buffer (so that its
    address and rows need not be aligned), the flax init's depthwise weight
    scale (fan-in k) and a bias at 0.1, drawn on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn(b * c * t + offset, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((c, 1, k), generator=gen, device=dev) / k ** 0.5
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    return buf[offset:].view(b, c, t), w, bias


def _dw_check(got, x, w, bias, d) -> float:
    """The kernel's output `got` against the float64 sum and the plain
    version.  With acc the float64 sum of the k exact products and E = k
    2^-22 sum |products| (twice the worst-case error of a float32 sum of k
    terms, in any order), asserted: the kernel's convolution alone (no
    bias) lies within one bfloat16 ulp of |acc| plus E of RN(acc); `got` is,
    bit for bit, the plain bfloat16 bias add applied to that convolution;
    and `got` lies within two ulps of the largest of |acc|, |y| and |got|
    plus E of the plain version (a flip of RN(acc) and the add after it).
    -> the largest |got - plain| in those ulps, E left out."""
    c, k = w.shape[0], w.shape[-1]
    p = d * (k - 1) // 2
    xd, wd = x.double(), w.to(torch.bfloat16).double()
    acc = torch.nn.functional.conv1d(xd, wd, None, 1, p, d, c)
    err = torch.nn.functional.conv1d(xd.abs(), wd.abs(), None, 1, p, d, c) * (k * 2.0**-22)
    del xd

    def ulp(v):
        return torch.exp2(torch.floor(torch.log2(v.clamp_min(2.0**-126))) - 7)

    conv = _dw_op(x, w, None, d)
    rounded = acc.float().to(torch.bfloat16).double()
    off = (conv.double() - rounded).abs()
    bar = ulp(torch.maximum(acc.abs(), rounded.abs())) + err
    assert bool((off <= bar).all()), f"the convolution is off RN(acc) by {float((off - bar).max())} past its bar"
    del off, bar, rounded
    assert torch.equal(got, conv + bias.to(torch.bfloat16)[:, None])
    want = _dw_plain(x, w, bias, d).double()
    u = ulp(torch.maximum(torch.maximum(acc.abs(), want.abs()), got.double().abs()))
    off = (got.double() - want).abs()
    assert bool((off <= 2 * u + err).all())
    return float((off / u).max())


@pytest.mark.parametrize("c,k,d", _DW_GEOMETRIES)
@pytest.mark.parametrize("b,t,offset", [(2, 704, 0), (3, 301, 1)])
def test_dwconv_is_the_plain_version_within_one_ulp(dev, c, k, d, b, t, offset):
    """Every SNAC geometry at a short T (copied in
    16-byte pieces) and at a ragged one read from misaligned addresses,
    held to the float64 sum and the plain version by ``_dw_check``; bit for
    bit on a second call; one launch each."""
    dw = _dw_ops()
    x, w, bias = _dw_case(c, k, b, t, dev, seed=c + k + d, offset=offset)
    n = dw._KERNEL.launches
    got = _dw_op(x, w, bias, d)
    again = _dw_op(x, w, bias, d)
    torch.cuda.synchronize()
    assert dw._KERNEL.launches == n + 2 and got.dtype == torch.bfloat16 and got.shape == (b, c, t)
    assert torch.equal(got, again)
    _dw_check(got, x, w, bias, d)


@pytest.mark.parametrize("c,d,t", [(96, 1, 184_320), (96, 9, 184_320), (1024, 1, 480), (768, 9, 3840)])
def test_dwconv_at_the_full_batch(dev, c, d, t):
    """The largest layer, and the shortest rows, at the 16 x 4 s batch's T."""
    x, w, bias = _dw_case(c, 7, 16, t, dev, seed=t + d)
    got = _dw_op(x, w, bias, d)
    _dw_check(got, x, w, bias, d)
    assert torch.equal(got, _dw_op(x, w, bias, d))


@pytest.mark.parametrize("t", [1, 5, 8, 24, 27, 64])
def test_dwconv_with_t_within_the_padding(dev, t):
    """T at or below the padding (27 at k 7, d 9): every tap but the centre
    reads zeros somewhere; T 8 and 24 through the 16-byte copies."""
    x, w, bias = _dw_case(64, 7, 2, t, dev, seed=t)
    got = _dw_op(x, w, bias, 9)
    _dw_check(got, x, w, bias, 9)


def test_dwconv_refuses_what_it_does_not_take(dev):
    """float32, an even k, k 9, k 5, dilations 11 and 2, a channel
    multiplier and a weight of other channels raise; nothing launches."""
    dw = _dw_ops()
    x, w, bias = _dw_case(64, 7, 1, 50, dev, seed=0)
    n = dw._KERNEL.launches
    w2 = torch.randn(64, 2, 7, device=dev)
    bad = [(x.float(), w, 1), (x, w[..., :6], 1), (x, torch.randn(64, 1, 9, device=dev), 1),
           (x, w[..., :5], 1), (x, w, 11), (x, w, 2), (x, w2, 1), (x[:, :40], w, 1)]
    for xi, wi, d in bad:
        with pytest.raises(ValueError):
            dw.launch(xi, wi, bias, None, d, d * (wi.shape[-1] - 1) // 2)
    assert dw._KERNEL.launches == n


@pytest.mark.parametrize("c,k,d", [(64, 7, 3), (96, 7, 9), (48, 7, 1)])
def test_dwconv_gradient_against_plain_autograd(dev, c, k, d):
    """x, weight and bias gradients through the op against autograd of the
    plain version, within one bfloat16 ulp of the largest of each."""
    dw = _dw_ops()
    x, w, bias = _dw_case(c, k, 3, 333, dev, seed=5)
    g = torch.randn(3, c, 333, device=dev).to(torch.bfloat16)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        return torch.autograd.grad(fn(leaves[0], leaves[1], leaves[2], d), leaves, g)

    n = dw._KERNEL.launches
    got = grads(_dw_op)
    assert dw._KERNEL.launches == n + 1
    want = grads(_dw_plain)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert float((a.float() - b.float()).abs().max()) <= _bf16_ulp(float(b.float().abs().max()))


def test_dwconv_under_no_grad_keeps_no_graph(dev):
    """Under no_grad the op launches the kernel alone: no autograd node, no
    other device operation.  The profiler window idles 0.1 s before the
    call, and is opened again (up to three windows) where it recorded no
    device operation at all: on the card a window now and then loses its
    first records."""
    dw = _dw_ops()
    x, w, bias = _dw_case(128, 7, 2, 4096, dev, seed=3)
    w.requires_grad_()
    _dw_op(x, w, bias, 3)  # the taps, laid out once
    torch.cuda.synchronize()
    for _ in range(3):
        n = dw._KERNEL.launches
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.1)
            out = _dw_op(x, w, bias, 3)
            torch.cuda.synchronize()
        assert out.grad_fn is None and not out.requires_grad and dw._KERNEL.launches == n + 1
        names = [e.key for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert names and all("dwconv" in k for k in names), names


def test_snac_codec_launches_the_kernel_twenty_six_times(dev):
    """One SNAC 44 kHz bfloat16 encode and decode: 13 launches each; the
    latent and the waveform within 5% rms of the plain versions' (the kernel
    moves roundings only)."""
    from nawc_tpu_torch.codec.model import SnacCodec

    dw = _dw_ops()
    torch.manual_seed(0)
    model = SnacCodec(CodecConfig.snac_44khz(compute_dtype="bfloat16")).to(dev).eval()
    wav = torch.randn(2, 12_288, device=dev) * 0.1
    with torch.no_grad():
        n = dw._KERNEL.launches
        z = model.encoder(wav)
        assert dw._KERNEL.launches == n + 13
        model.seed_noise(1)
        y = model.decoder(z)
        assert dw._KERNEL.launches == n + 26
        with _lib.plain_versions():
            z_p = model.encoder(wav)
            model.seed_noise(1)
            y_p = model.decoder(z)
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    assert rel(z, z_p) < 0.05 and rel(y, y_p) < 0.05, (rel(z, z_p), rel(y, y_p))



# ---------------------------------------------------------------- the output conv

# the four roundtrip cells' tails: (x's type, C, k, left pad, the cell's T)
_OUT_TAILS = {"codec24k bf16": (torch.bfloat16, 48, 7, 3, 98_304), "snac44k bf16": (torch.bfloat16, 96, 7, 3, 184_320),
              "mimi bf16": (torch.bfloat16, 64, 3, 2, 720_000), "codec24k f32": (torch.float32, 48, 7, 3, 98_304)}


def _out_ops():
    from nawc_tpu_torch.ops import outconv as oc

    return oc


def _out_op(x, w, bias, left):
    """The widened conv op at `left` zeros on the left and k - 1 - `left`
    on the right: on the card the kernel."""
    k = w.shape[-1]
    return conv1d(x, w, bias, 1, lambda t: (left, k - 1 - left), 1, 1, widen=True)


@pytest.mark.parametrize("length", ["the cell's T", "T 4000", "T 8"])
@pytest.mark.parametrize("tail", list(_OUT_TAILS))
def test_outconv_is_the_float64_sum_within_a_float32_bound(dev, tail, length):
    """Each tail at the full batch of 16, at the cell's T, at a T that is
    not a multiple of a block's 1,984 outputs, and at one unit of 8: every
    output within (C k + 1) 2^-23 (sum |w x| + |bias|) of the float64 sum
    (twice the worst-case error of a float32 sum of C k + 1 terms in any
    order); two runs bit for bit; one launch each, none of cuDNN."""
    oc = _out_ops()
    dtype, c, k, left, t_cell = _OUT_TAILS[tail]
    t = {"the cell's T": t_cell, "T 4000": 4000, "T 8": 8}[length]
    gen = torch.Generator(device=dev).manual_seed(c + k + t)
    x = torch.randn((16, c, t), generator=gen, device=dev).to(dtype)
    w = torch.randn((1, c, k), generator=gen, device=dev) / (c * k) ** 0.5
    bias = torch.randn(1, generator=gen, device=dev) * 0.1
    n = oc._KERNEL.launches
    with torch.no_grad():
        got = _out_op(x, w, bias, left)
        again = _out_op(x, w, bias, left)
    torch.cuda.synchronize()
    assert oc._KERNEL.launches == n + 2
    assert got.dtype == torch.float32 and got.shape == (16, 1, t) and torch.equal(got, again)
    pads = (left, k - 1 - left)
    xd = torch.nn.functional.pad(x.double(), pads)
    acc = torch.nn.functional.conv1d(xd, w.double(), bias.double())
    bar = (torch.nn.functional.conv1d(xd.abs(), w.double().abs()) + abs(float(bias))) * ((c * k + 1) * 2.0**-23)
    del xd
    off = (got.double() - acc).abs()
    assert bool((off <= bar).all()), f"{float((off - bar).max())} past the bar"


@pytest.mark.parametrize("case", ["T 4001", "x at an offset"])
def test_outconv_leaves_the_rest_to_the_float32_route(dev, case):
    """A T that is not a multiple of 8, or an x not 16-byte aligned, takes
    the old chain on the card: no launch, the plain version's result."""
    oc = _out_ops()
    t, offset = (4001, 0) if case == "T 4001" else (4000, 1)
    buf = torch.randn(2 * 48 * t + offset, device=dev).to(torch.bfloat16)
    x = buf[offset:].view(2, 48, t)
    w = torch.randn(1, 48, 7, device=dev) / 18
    n = oc._KERNEL.launches
    with torch.no_grad():
        got = _out_op(x, w, None, 3)
        with _lib.plain_versions():
            want = _out_op(x, w, None, 3)
    assert oc._KERNEL.launches == n and torch.equal(got, want)


@pytest.mark.parametrize("tail", list(_OUT_TAILS))
def test_outconv_gradient_is_autograd_of_the_chain(dev, tail):
    """With a gradient wanted the kernel runs too (one launch); its output
    the no-gradient launch's bit for bit, and dx (in x's type), dw and db
    autograd of the plain chain's, by the same cuDNN backward: within 1e-5
    of the largest value in float32, one bfloat16 ulp of it in bfloat16
    (cuDNN may pick a weight-gradient algorithm that sums the B T products
    in another order from one call to the next)."""
    oc = _out_ops()
    dtype, c, k, left, _ = _OUT_TAILS[tail]
    gen = torch.Generator(device=dev).manual_seed(c + k)
    x = torch.randn((4, c, 4000), generator=gen, device=dev).to(dtype)
    w = torch.randn((1, c, k), generator=gen, device=dev) / (c * k) ** 0.5
    bias = torch.randn(1, generator=gen, device=dev) * 0.1
    g = torch.randn((4, 1, 4000), generator=gen, device=dev)

    def grads():
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        y = _out_op(*leaves, left)
        return y.detach(), torch.autograd.grad(y, leaves, g)

    n = oc._KERNEL.launches
    y, got = grads()
    assert oc._KERNEL.launches == n + 1
    with torch.no_grad():
        assert torch.equal(y, _out_op(x, w, bias, left))
    with _lib.plain_versions():
        _, want = grads()
    assert oc._KERNEL.launches == n + 2
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32]
    for a, b in zip(got, want):
        ulp = 2.0**-7 if a.dtype == torch.bfloat16 else 1e-5
        assert float((a.float() - b.float()).abs().max()) <= ulp * float(b.float().abs().max())


def test_outconv_without_a_bias_adds_nothing(dev):
    """No bias: the sum alone, the bias's add left out."""
    x = torch.randn(2, 64, 1000, device=dev).to(torch.bfloat16)
    w = torch.randn(1, 64, 3, device=dev) / 14
    zero = torch.zeros(1, device=dev)
    assert torch.equal(_out_op(x, w, None, 2), _out_op(x, w, zero, 2))


@pytest.mark.parametrize("layout", ["codec24k", "snac44k", "mimi"])
def test_one_decode_launches_outconv_once(dev, layout):
    """The bfloat16 decoder of each layout, at small widths, launches the
    kernel once a decode (none in the encoder); the waveform within 1e-5 of
    the plain chain's on the same activation (the kernel moves the float32
    summation order alone)."""
    from test_torch_outconv import SMALL_CODECS

    from nawc_tpu_torch.codec import mimi
    from nawc_tpu_torch.codec.model import SnacCodec

    oc = _out_ops()
    widths, make, samples = SMALL_CODECS[layout]
    cfg = make(**widths, compute_dtype="bfloat16")
    torch.manual_seed(0)
    model = (mimi.MimiCodec(cfg) if cfg.layout == "mimi" else SnacCodec(cfg)).to(dev).eval()
    conv = model.decoder.seanet.Conv_1 if cfg.layout == "mimi" else model.decoder.Conv_1
    seen = []
    conv.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    wav = torch.randn(2, samples, device=dev) * 0.1
    with torch.no_grad():
        n = oc._KERNEL.launches
        z = model.encoder(wav)
        assert oc._KERNEL.launches == n
        y = model.decoder(z)
        assert oc._KERNEL.launches == n + 1 and seen[0].dtype == torch.bfloat16
        with _lib.plain_versions():
            want = conv(seen[0])[:, 0]
    assert oc._KERNEL.launches == n + 1
    want = want if cfg.layout == "mimi" else torch.tanh(want)
    assert float((y - want).abs().max()) <= 1e-5
