"""The plain versions in nawc_tpu_torch.ops against nawc_tpu.ops, whose
Pallas kernels run here in interpret mode, as nawc_tpu's own tests run them
(tests/test_sswm_kernel.py, tests/test_codec.py, tests/test_rvq_fused.py).
On CPU tensors every op of the port takes its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_codes_match, t, tiny_codecs, TINY
from nawc_tpu.ops.rvq import _nearest_codebook_pallas, nearest_codebook_reference as jax_nn_ref
from nawc_tpu.ops.rvq_fused import _l2n, _rvq_encode_pallas, level_params as jax_level_params
from nawc_tpu.ops.rvq_fused import rvq_encode_reference as jax_rvq_ref
from nawc_tpu.ops.sswm import _whiten_correlate_pallas, whiten_correlate_reference as jax_wc_ref
from nawc_tpu.ops.sswm import whiten_correlate as jax_whiten_correlate
from nawc_tpu_torch.ops import _lib, rvq, rvq_fused, sswm

_OFFS = (17, 23, 29, 37, 47, 53)


def _case(b, t_, w, k, seed=0):
    rng = np.random.default_rng(seed)
    r = (rng.standard_normal((b, t_, w)) * 0.3).astype(np.float32)
    p = np.sign(rng.standard_normal((k, t_, w))).astype(np.float32)
    return r, p


# the last two: T below 16 rows and the largest roll, and T past 512
@pytest.mark.parametrize("shape", [(5, 126, 358, 16), (3, 77, 130, 16), (2, 64, 128, 60),
                                   (5, 10, 30, 16), (4, 1001, 40, 16)])
def test_whiten_correlate_matches_pallas_interpret(shape):
    r, p = _case(*shape)
    want = np.asarray(_whiten_correlate_pallas(jnp.asarray(r), jnp.asarray(p), _OFFS, interpret=True))
    ref = np.asarray(jax_wc_ref(jnp.asarray(r), jnp.asarray(p), _OFFS))
    got = sswm.whiten_correlate(t(r), t(p), _OFFS).numpy()
    got_ref = sswm.whiten_correlate_reference(t(r), t(p), _OFFS).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    np.testing.assert_allclose(got_ref, ref, atol=1e-3)
    sure = np.abs(ref) > 1e-2
    np.testing.assert_array_equal((got > 0)[sure], (ref > 0)[sure])


def test_whiten_correlate_cancellation_identity():
    """The scaling-only path equals the full whitening math (the patterns
    are time-centred, so the mean subtractions cancel)."""
    r, p = _case(4, 100, 90, 8, seed=3)
    a = sswm.whiten_correlate(t(r), t(p), _OFFS).numpy()
    b = sswm.whiten_correlate_reference(t(r), t(p), _OFFS).numpy()
    np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("shape,patterns", [((16, 376, 367, 16), "sign"), ((16, 40, 367, 16), "sign"),
                                            ((3, 40, 50, 5), "gauss"), ((5, 10, 30, 16), "sign"),
                                            ((4, 1001, 40, 16), "gauss")])
def test_raw_patterns_give_the_same_z(shape, patterns):
    """The kernel reads the raw patterns: the scaled residual has zero
    time-sum per bin, so the uncentred rolled stack gives the plain z."""
    r, p = _case(*shape)
    if patterns == "gauss":
        p = np.random.default_rng(8).standard_normal(p.shape).astype(np.float32)
    r, p = t(r), t(p)
    offs = tuple(o % shape[1] for o in _OFFS)
    raw = torch.stack([p] + [torch.roll(p, o, dims=-2) for o in offs])
    scale, shift = sswm._scale_shift(r)
    z_raw = sswm._calibrate(torch.einsum("btw,jktw->bjk", r * scale - shift, raw))
    np.testing.assert_allclose(z_raw.numpy(), sswm._whiten_correlate_plain(r, p, _OFFS).numpy(),
                               atol=1e-5)


def test_plain_switch_on_cpu_is_the_plain_version():
    r, p = _case(2, 64, 40, 4, seed=4)
    a = sswm.whiten_correlate(t(r), t(p), _OFFS)
    with _lib.plain_versions():
        b = sswm.whiten_correlate(t(r), t(p), _OFFS)
    c = sswm._whiten_correlate_plain(t(r), t(p), _OFFS)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert all(k.launches == 0 for k in _lib.KERNELS.values())


def _grad_case(seed=6):
    r, p = _case(3, 64, 40, 8, seed=seed)
    w = np.random.default_rng(seed + 1).standard_normal((3, 8)).astype(np.float32)
    return r, p, w


def _port_grads(r, p, w):
    r_, p_ = t(r).requires_grad_(True), t(p).requires_grad_(True)
    (sswm.whiten_correlate(r_, p_, _OFFS) * t(w)).sum().backward()
    return r_.grad, p_.grad


def test_whiten_correlate_gradient_matches_jax():
    """d(sum z * w)/dr and /dp of the port's CPU route against ``jax.grad``
    of the JAX package's XLA path.  Tolerance 1e-4 of the largest |grad|:
    each gradient cell sums NV = 7 pattern terms scaled by per-bin and
    per-batch statistics that both packages reduce over T x W cells in
    their own float32 order."""
    r, p, w = _grad_case()
    g_r, g_p = _port_grads(r, p, w)
    want_r, want_p = jax.grad(
        lambda r_, p_: jnp.sum(jax_whiten_correlate(r_, p_, _OFFS, use_pallas=False) * w),
        argnums=(0, 1))(jnp.asarray(r), jnp.asarray(p))
    for got, want in ((g_r, want_r), (g_p, want_p)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_kernel_route_carries_the_plain_gradient(monkeypatch):
    """The kernel's autograd wrapper, run here with the plain forward in the
    kernel's place (a result without a graph, as the kernel's is): z
    carries the plain version's gradient, for r, p or both; without grad
    it builds no graph."""
    def gradless(r, p, offs):
        with torch.no_grad():
            return sswm._whiten_correlate_plain(r, p, offs)

    r, p, w = _grad_case(seed=9)
    want_r, want_p = _port_grads(r, p, w)
    monkeypatch.setattr(sswm, "_whiten_correlate_cuda", gradless)
    monkeypatch.setattr(sswm._lib, "use_kernel", lambda x: True)
    got_r, got_p = _port_grads(r, p, w)
    assert torch.equal(got_r, want_r) and torch.equal(got_p, want_p)
    p_ = t(p).requires_grad_(True)
    (sswm.whiten_correlate(t(r), p_, _OFFS) * t(w)).sum().backward()
    assert torch.equal(p_.grad, want_p)
    assert sswm.whiten_correlate(t(r), t(p), _OFFS).grad_fn is None


@pytest.mark.parametrize("n,k,d", [(300, 256, 8), (1001, 4096, 8), (77, 64, 5)])
def test_nearest_codebook_matches_pallas_interpret(n, k, d):
    rng = np.random.default_rng(n)
    z = rng.normal(size=(n, d)).astype(np.float32)
    cb = rng.normal(size=(k, d)).astype(np.float32)
    want = np.asarray(_nearest_codebook_pallas(jnp.asarray(z), jnp.asarray(cb), interpret=True))
    np.testing.assert_array_equal(want, np.asarray(jax_nn_ref(jnp.asarray(z), jnp.asarray(cb))))
    got = rvq.nearest_codebook(t(z), t(cb))
    assert got.dtype == torch.int32
    assert_codes_match(got.numpy(), want, z, cb)


def test_nearest_codebook_ties_take_first_index():
    cb = np.array([[1, 0], [0, 1], [1, 0], [2, 0]], np.float32)  # rows 0, 2, 3 tie
    z = np.array([[3, 0], [0, 5], [-1, 0]], np.float32)
    got = rvq.nearest_codebook(t(z), t(cb)).numpy()
    np.testing.assert_array_equal(got, [0, 1, 1])
    np.testing.assert_array_equal(got, np.asarray(jax_nn_ref(jnp.asarray(z), jnp.asarray(cb))))


def test_nearest_codebook_leading_shape_and_normalisation():
    rng = np.random.default_rng(2)
    z = rng.normal(size=(2, 5, 8)).astype(np.float32)
    cb = rng.normal(size=(64, 8)).astype(np.float32)
    assert rvq.nearest_codebook(t(z), t(cb)).shape == (2, 5)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    # rsqrt may differ by an ulp between the two libraries
    np.testing.assert_allclose(
        rvq._l2_normalize(t(x)).numpy(), np.asarray(_l2n(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs()


def _pack(params, strides):
    cols = [jax_level_params(params, i) for i in range(len(strides))]
    st = lambda j, f=lambda x: x: jnp.stack([f(c[j]) for c in cols])  # noqa: E731
    return (st(0), st(1), st(2), st(3), st(4, lambda x: _l2n(x).T), st(4, lambda x: x.T))


@pytest.mark.parametrize("t_lat", [256, 320, 64])
def test_rvq_encode_matches_pallas_interpret(codecs, t_lat):
    jc, tc = codecs
    strides = TINY["vq_strides"]
    z = np.random.default_rng(t_lat).normal(size=(2, t_lat, TINY["latent_dim"])).astype(np.float32)
    want = _rvq_encode_pallas(jnp.asarray(z), *_pack(jc.params, strides), strides, interpret=True)
    want_ref = jax_rvq_ref(jnp.asarray(z), jc.params, strides)
    got = rvq_fused.rvq_encode_fused(t(z), tc.model.quantizer, strides)
    got_ref = rvq_fused.rvq_encode_reference(t(z), tc.model.quantizer, strides)
    for g, gr, w, wr in zip(got, got_ref, want, want_ref):
        np.testing.assert_array_equal(np.asarray(w), np.asarray(wr))
        assert torch.equal(g, gr)
        assert_codes_match(g.numpy(), np.asarray(w))


def test_rvq_level_params_layout(codecs):
    jc, tc = codecs
    for i in range(len(TINY["vq_strides"])):
        for a, b in zip(rvq_fused.level_params(tc.model.quantizer, i), jax_level_params(jc.params, i)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bound_counts_scale_with_the_work():
    nb, fl, fl_tc = sswm.bound_counts(16, 376, 367, 16, 7)
    assert abs(nb - 17.7e6) < 0.1e6  # r and the patterns dominate
    cells = 16 * 376 * 367
    assert fl == 3 * cells  # the per-bin statistics, f32
    assert fl_tc == 3 * 2 * 7 * 16 * cells  # three TF32 passes of the contraction
    nb2, fl2 = rvq.bound_counts(768, 4096, 8)
    assert fl2 == 2 * 768 * 4096 * 8
    nb3, fl3 = rvq_fused.bound_counts(16, 192, 768, 8, 4096, (4, 2, 1))
    # only the work the codes need: pooling for strides 4 and 2, in_proj and
    # scores for 5376 pooled frames, out_proj and the subtract for the first
    # two levels (768 + 1536 frames), and one copy of each codebook
    full = 16 * 192 * 768
    assert fl3 == 2 * full + 2 * 5376 * (768 * 8 + 4096 * 8) + 2 * 2304 * 8 * 768 + 2 * full
    assert nb3 == 4 * (full + 5376 + 3 * (768 * 8 + 8 + 4096 * 8) + 2 * (8 * 768 + 768))


def test_derived_value_follows_its_sources():
    owner = torch.arange(6.0)
    calls = []

    def make():
        calls.append(1)
        return owner.sum().item()

    assert _lib.derived(owner, "sum", [owner], make) == 15.0
    assert _lib.derived(owner, "sum", [owner], make) == 15.0 and len(calls) == 1
    owner.add_(1.0)  # in place
    assert _lib.derived(owner, "sum", [owner], make) == 21.0 and len(calls) == 2
    owner.data = torch.zeros(6)  # replaced
    assert _lib.derived(owner, "sum", [owner], make) == 0.0 and len(calls) == 3
    assert _lib.derived(owner, "other", [owner], lambda: "b") == "b"


def test_packed_tables_kept_until_a_table_changes(codecs):
    _, tc = codecs
    q = tc.model.quantizer
    n = len(TINY["vq_strides"])
    first = rvq_fused.packed_tables(q, n)
    assert rvq_fused.packed_tables(q, n) is first
    for a, b in zip(first, rvq_fused.pack_tables(q, n)):
        assert torch.equal(a, b)
    w = q.level_1.in_proj.weight
    old = w.detach().clone()
    with torch.no_grad():
        w.add_(1.0)  # in place: the version counter moves
    try:
        second = rvq_fused.packed_tables(q, n)
        assert second is not first
        ink = second[0][1]  # level 1's in_proj as float4 planes (Cp/4, D, 4)
        assert torch.equal(ink.permute(1, 0, 2).reshape(ink.shape[1], -1)[:, :w.shape[0]], w.T)
        w.data = w.detach().clone()  # a new tensor at a new address
        assert rvq_fused.packed_tables(q, n) is not second
    finally:
        with torch.no_grad():
            w.copy_(old)
