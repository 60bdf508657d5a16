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
from _torch_port import t
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
    nb, i32, f64, f32 = keyed.bound_counts(1000)
    assert (nb, i32, f64) == (4000.0, 75_000.0, 2000.0)
    _, _, f64_n, _ = keyed.bound_counts(1000, normal=True, n_log1p_rational=1000)
    _, _, f64_l, _ = keyed.bound_counts(1000, normal=True, n_log1p_rational=0)
    assert f64_n == 50 * 1000 and f64_l == 32 * 1000


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
