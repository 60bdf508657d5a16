"""The keyed draws of ``nawc_tpu_torch.ops.jaxrand`` on the CPU: on a CPU
device they are the numpy replica's values bit for bit (the replica is the
draw kernel's plain version, held against ``jax.random`` in
``test_torch_utils.py``), and every call site that moved to them draws
what it drew before: the noise attacks, ``monte_carlo_scores``, the PCA
jamming noise and the watermark trainer's augmentations, each against its
JAX counterpart at the bar its own test holds it to (1e-5 for the
elementwise and FIR attacks and the augmentations, 1e-4 for reverb's FFT
and for jamming, 1e-6 for the MC scores of a linear score function).
The kernel itself is held against the replica on the card in
``test_torch_kernels_cuda.py``."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nawc_tpu.attacks.dsp as jax_dsp
from _torch_port import fma_once as _fma_once, t
from nawc_tpu.interp import latent_pca as jl
from nawc_tpu.interp import uncertainty as juq
from nawc_tpu.train import wm_train as jwt
from nawc_tpu_torch.attacks import dsp
from nawc_tpu_torch.interp import latent_pca as tl
from nawc_tpu_torch.interp import uncertainty as tuq
from nawc_tpu_torch.ops import _lib
from nawc_tpu_torch.ops import jaxrand as keyed
from nawc_tpu_torch.train import wm_train as twt
from nawc_tpu_torch.utils import jaxrand


def _bits(x) -> np.ndarray:
    return np.ascontiguousarray(x).view(np.uint32)


@contextlib.contextmanager
def recorded(monkeypatch):
    """Every keyed draw made inside, as (kind, key, shape, args, tensor)."""
    calls = []
    for kind in ("normal", "uniform"):
        orig = getattr(keyed, kind)

        def record(key, shape, device, *args, _orig=orig, _kind=kind):
            out = _orig(key, shape, device, *args)
            calls.append((_kind, np.array(key), tuple(shape), args, out))
            return out

        monkeypatch.setattr(keyed, kind, record)
    yield calls


def _assert_replica(calls, n: int) -> None:
    assert len(calls) == n
    for kind, key, shape, args, out in calls:
        want = jaxrand.normal(key, shape) if kind == "normal" else jaxrand.uniform(key, shape, *args)
        assert out.dtype == torch.float32 and out.device.type == "cpu"
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))


KEYS = [jaxrand.prng_key(0), jaxrand.split(jaxrand.prng_key(3), 3)[2],
        jaxrand.fold_in(jaxrand.prng_key(7), 59)]


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("shape", [(2, 126, 513), (1001,), (3, 7, 5), (0, 4)])
def test_keyed_draws_on_the_cpu_are_the_replicas(key, shape):
    got = keyed.normal(key, shape, "cpu")
    assert got.shape == shape and got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jaxrand.normal(key, shape)))
    for lo, hi in [(0.0, 1.0), (0.05, 0.9), (-1.0, 1.0), (-0.5, 0.5), (-6.0, 6.0)]:
        got = keyed.uniform(key, shape, torch.device("cpu"), lo, hi)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(jaxrand.uniform(key, shape, lo, hi)))
        with _lib.plain_versions():
            again = keyed.uniform(key, shape, "cpu", lo, hi)
        assert torch.equal(got, again)


def test_keyed_draws_equal_jax_random():
    key = jaxrand.fold_in(jaxrand.prng_key(5), 2)
    jkey = jax.random.fold_in(jax.random.PRNGKey(5), 2)
    shape = (4, 3001)
    want = np.asarray(jax.random.uniform(jkey, shape, minval=-0.5, maxval=0.5))
    np.testing.assert_array_equal(keyed.uniform(key, shape, "cpu", -0.5, 0.5).numpy(), want)
    got = keyed.normal(key, shape, "cpu").numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64)
                 - np.asarray(jax.random.normal(jkey, shape)).view(np.int32).astype(np.int64))
    assert ulp.max() <= 2


def test_keyed_draws_do_not_fall_back_to_the_host_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((RuntimeError, AssertionError)):
        keyed.normal(jaxrand.prng_key(0), (4,), "cuda")


def test_bound_counts_scale_with_the_draws():
    """A uniform spends the float64 multiply and add of its rounded-once
    step; a normal draw float32 FMA-unit instructions only."""
    nb, i32, f64, f32 = keyed.bound_counts(1000)
    assert (nb, i32, f64, f32) == (4000.0, 75_000.0, 2000.0, 1000.0)
    _, i32_n, f64_n, f32_n = keyed.bound_counts(1000, normal=True, n_log1p_rational=1000)
    _, _, f64_l, f32_l = keyed.bound_counts(1000, normal=True, n_log1p_rational=0)
    assert i32_n == 75_000.0 and f64_n == f64_l == 0.0
    assert f32_n == 35 * 1000 and f32_l == 39 * 1000


# ---- the normal draw's transform over its whole domain: its 2^23 uniforms

_ALL_BITS = np.arange(2**23, dtype=np.uint32) << np.uint32(9)  # every 23-bit mantissa
_FMA_STEPS_PER_NORMAL = 31  # uniform 1, erf_inv 9, log1p's rational 15, its log 6 (numpy runs both)


def _normals_of_every_input() -> np.ndarray:
    """The replica's normal of each of the 2^23 inputs, in chunks of 2^21."""
    return np.concatenate([jaxrand.normal_from_bits(_ALL_BITS[i:i + 2**21])
                           for i in range(0, _ALL_BITS.size, 2**21)])


def test_fma_once_rounds_once_where_float64_rounds_twice():
    """a b = 1 + 2^-24 exactly (97 x 257 x 673 = 2^24 + 1), the float32
    midpoint between 1 and 1 + 2^-23; c = +-2^-80 puts the exact sum just
    above or below it.  float64 rounds the sum onto the midpoint, which then
    ties to even (1); one rounding goes to the exact sum's side."""
    a, b = np.float32(97 * 257 / 2**14), np.float32(673 / 2**10)
    assert np.float64(a) * np.float64(b) == 1 + 2**-24
    up, down = np.float32(2**-80), np.float32(-(2**-80))
    assert _fma_once(a, b, up) == np.float32(1 + 2**-23)
    assert jaxrand._fma(a, b, up) == np.float32(1.0)
    assert _fma_once(a, b, down) == jaxrand._fma(a, b, down) == np.float32(1.0)
    assert _fma_once(a, b, np.float32(0.0)) == np.float32(1.0)  # an exact tie, to even


@pytest.fixture(scope="module")
def every_normal():
    """The replica over all 2^23 inputs of the normal transform, each of its
    ``_fma`` steps checked against one rounding -> (steps, steps whose two
    roundings differ, the 2^23 normals)."""
    tally = {"steps": 0, "differ": 0}
    twice = jaxrand._fma

    def checked(a, b, c):
        got = twice(a, b, c)
        once = _fma_once(a, b, c)
        tally["steps"] += got.size
        tally["differ"] += int((np.asarray(got).view(np.uint32) != once.view(np.uint32)).sum())
        return got

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jaxrand, "_fma", checked)
        normals = _normals_of_every_input()
    return tally["steps"], tally["differ"], normals


def test_normal_fma_steps_round_once_over_every_input(every_normal):
    """Every multiply-add the replica rounds twice (float64, then float32)
    gives the bits of one rounding over the normal's whole domain: the
    card's normal draw may use a float32 fma and stay bit for bit."""
    steps, differ, normals = every_normal
    assert steps == _FMA_STEPS_PER_NORMAL * 2**23 == 260_046_848
    assert differ == 0
    assert normals.dtype == np.float32 and bool(np.isfinite(normals).all())
    assert np.array_equal(normals[:4099].view(np.uint32),
                          jaxrand.normal_from_bits(_ALL_BITS[:4099]).view(np.uint32))


def _log_p1_fused(v):
    """``jaxrand._log`` with its unfused ``p1`` contracted into two fmas."""
    lp = jaxrand._LOG_P
    m, e = np.frexp(v)
    m, e = m.astype(np.float32), e.astype(np.float32)
    small = m < np.float32(0.707106781186547524)
    e = e - small.astype(np.float32)
    x = (m - np.float32(1)) + np.where(small, m, np.float32(0))
    x2 = x * x
    x3 = x2 * x
    p = (x * lp[0] + lp[1]) * x + lp[2]
    p1 = jaxrand._fma(jaxrand._fma(x, lp[3], lp[4]), x, lp[5])
    p2 = jaxrand._fma(jaxrand._fma(x, lp[6], lp[7]), x, lp[8])
    y = jaxrand._fma(p * x3 + p1, x3, p2)
    y = jaxrand._fma(y, x3, np.float32(-2.12194440e-4) * e)
    return jaxrand._fma(np.float32(0.693359375), e, jaxrand._fma(np.float32(-0.5), x2, x) + y)


def test_contracting_an_unfused_step_changes_a_normal(every_normal, monkeypatch):
    """The negative control: the steps the replica leaves unfused must stay
    so; fusing ``_log``'s p1 moves some of the 2^23 normals."""
    *_, normals = every_normal
    monkeypatch.setattr(jaxrand, "_log", _log_p1_fused)
    fused = _normals_of_every_input()
    assert int((fused.view(np.uint32) != normals.view(np.uint32)).sum()) >= 1


@pytest.mark.parametrize("bits", [_ALL_BITS[::4099],
                                  np.array([0, 511, 512, 0xFFFFFFFF, 0x80000000], np.uint32)])
def test_normal_of_bits_on_the_cpu_is_the_replica(bits):
    got = keyed.normal_of_bits(torch.from_numpy(bits.view(np.int32)))
    assert got.dtype == torch.float32 and got.shape == bits.shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(jaxrand.normal_from_bits(bits)))


def _clips(n=2, t_len=16_000, seed=0):
    rng = np.random.default_rng(seed)
    tt = np.arange(t_len) / 16_000
    tone = np.sin(2 * np.pi * 220 * tt) * (0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * tt))
    return (0.3 * tone[None] + 0.05 * rng.normal(size=(n, t_len))).astype(np.float32)


@pytest.mark.parametrize("name,args,n_draws,tol", [
    ("gaussian_noise", (), 1, 1e-5), ("background_noise", (), 1, 1e-5), ("eq", (), 3, 1e-5),
    ("time_jitter", (0.008, 16_000), 1, 1e-5), ("reverb", (), 1, 1e-4),
])
def test_noise_attacks_draw_the_replica(monkeypatch, name, args, n_draws, tol):
    """At the suite's settings (``build_suite``: time_jitter at 0.008 ms)."""
    wav = _clips()
    key, jkey = jaxrand.prng_key(5), jax.random.PRNGKey(5)
    with recorded(monkeypatch) as calls:
        got = getattr(dsp, name)(t(wav), key, *args).numpy()
    _assert_replica(calls, n_draws)
    want = np.asarray(getattr(jax_dsp, name)(jnp.asarray(wav), jkey, *args))
    np.testing.assert_allclose(got, want, atol=tol)


def test_monte_carlo_scores_draw_the_replica(monkeypatch):
    """A linear score function, so that the scores differ from JAX's only
    by the float32 rounding of the noise sum."""
    wav = _clips(3, 4000, seed=1)
    w = np.random.default_rng(2).normal(size=4000).astype(np.float32) / 4000

    with recorded(monkeypatch) as calls:
        got = tuq.monte_carlo_scores(lambda x: x @ t(w), t(wav), jaxrand.prng_key(1), n_samples=4)
    _assert_replica(calls, 1)
    assert calls[0][2] == (4, 3, 4000)
    want = juq.monte_carlo_scores(lambda x: x @ jnp.asarray(w), jnp.asarray(wav), jax.random.PRNGKey(1),
                                  n_samples=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_pca_jamming_draws_the_replica(monkeypatch):
    rng = np.random.default_rng(4)
    z = (rng.normal(size=(2, 30, 16)) * np.linspace(2.0, 0.1, 16)).astype(np.float32)
    mean = z.reshape(-1, 16).mean(0)
    comps = np.linalg.qr(rng.normal(size=(16, 16)))[0].T.astype(np.float32)
    with recorded(monkeypatch) as calls:
        got = tl.jamming_fn(t(mean), t(comps), 6, jaxrand.prng_key(0))(t(z)).numpy()
    _assert_replica(calls, 1)
    want = jl.jamming_fn(jnp.asarray(mean), jnp.asarray(comps), 6, jax.random.PRNGKey(0))(jnp.asarray(z))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.fixture(scope="module")
def jax_diff_attack():
    """JAX's ``_diff_attack`` jitted, with the traceable surrogate (as in
    ``test_torch_train.py``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dsp, "lossy_codec_surrogate", jax_dsp.lossy_codec_surrogate.__wrapped__)
        fn = jax.jit(jwt._diff_attack)
        fn(jnp.zeros((2, 16_000), jnp.float32), jax.random.PRNGKey(0), jnp.asarray(0), jnp.float32(0.0))
    return fn


@pytest.mark.parametrize("branch,draw", [(1, "normal"), (3, "uniform"), (7, "normal")])
def test_wm_train_augmentations_draw_the_replica(monkeypatch, jax_diff_attack, branch, draw):
    """The noise, amplitude-scale and reverb branches of the trainer's
    round-robin augmentation."""
    wav = _clips(2, 16_000, seed=3)
    sev = np.float32(0.6)
    with recorded(monkeypatch) as calls:
        got = twt._diff_attack(t(wav), jaxrand.prng_key(5), 12 + branch, sev).numpy()
    _assert_replica(calls, 1)
    assert calls[0][0] == draw
    want = np.asarray(jax_diff_attack(jnp.asarray(wav), jax.random.PRNGKey(5), jnp.asarray(12 + branch),
                                      jnp.float32(sev)))
    np.testing.assert_allclose(got, want, atol=1e-5)
