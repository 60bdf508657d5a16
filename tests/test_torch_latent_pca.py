"""The port's latent-PCA toolkit against nawc_tpu's on the CPU: the PCA fit,
the three latent attacks, the latent-delta metrics, the top-K
reconstruction sweep and the head/tail energy split, on synthetic data and
on the tiny codec's latents (``tests/_torch_port.py``).

Tolerances: components within 1e-4 once each component's sign is aligned
to JAX's (a component's sign is the LAPACK or cuSOLVER call's own), means and variances within
1e-4 relative; the amputation, jamming and rounding attacks within 1e-4
given JAX's own mean and components (jamming's noise is JAX's draw); the
latent-delta metrics within 1e-4 relative; the sweep's scores within 1e-3
and its SI-SNRs within 1e-3 dB."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import speech, t, tiny_codecs
from nawc_tpu.interp import get_latent as jax_get_latent
from nawc_tpu.interp import latent_pca as jl
from nawc_tpu.models import SpreadSpectrumWM as JaxSS
from nawc_tpu.models import random_message as jax_random_message
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu_torch.interp import latent_pca as tl
from nawc_tpu_torch.models import SpreadSpectrumWM
from nawc_tpu_torch.utils import jaxrand
from nawc_tpu_torch.utils.config import SpreadSpectrumConfig


@pytest.fixture(scope="module")
def anisotropic():
    """(500, 8) data with two dominant directions (``tests/test_latent_pca.py``)."""
    rng = np.random.default_rng(0)
    basis = np.linalg.qr(rng.normal(size=(8, 8)))[0]
    scales = np.array([10, 5, 1, 0.5, 0.2, 0.1, 0.05, 0.01])
    return ((rng.normal(size=(500, 8)) * scales) @ basis.T).astype(np.float32)


@pytest.fixture(scope="module")
def latents():
    """(JAX codec, port codec, clean 16 kHz clips, JAX's latents of them
    (2, 32, 64) and of the spread-spectrum-marked clips, the message)."""
    jc, tc = tiny_codecs()
    wav = speech(16_000, 2, 1.0, seed=1)
    msg = jax_random_message(jax.random.PRNGKey(0), 2, 16)
    marked = np.asarray(JaxSS(cfg=JaxSSCfg(alpha=0.1)).embed(jnp.asarray(wav), msg))
    z = np.asarray(jax_get_latent(jc, jnp.asarray(wav)))
    zm = np.asarray(jax_get_latent(jc, jnp.asarray(marked)))
    return jc, tc, wav, marked, z, zm, np.asarray(msg)


def _fit_both(x: np.ndarray, k: int):
    jm, jcomp, jvar = (np.asarray(a) for a in jl.fit_pca(jnp.asarray(x), k))
    tm, tcomp, tvar = (a.numpy() for a in tl.fit_pca(t(x), k))
    return (jm, jcomp, jvar), (tm, tcomp, tvar)


@pytest.mark.parametrize("which,k", [("anisotropic", 8), ("latents", 16), ("latents", 48)])
def test_fit_pca_matches_up_to_sign(anisotropic, latents, which, k):
    x = anisotropic if which == "anisotropic" else latents[4]
    (jm, jcomp, jvar), (tm, tcomp, tvar) = _fit_both(x, k)
    assert tcomp.shape == jcomp.shape == (k, x.shape[-1]) and tvar.shape == (k,)
    np.testing.assert_allclose(tm, jm, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-4, atol=1e-4 * jvar.max())
    sign = np.sign(np.sum(tcomp * jcomp, axis=-1))
    np.testing.assert_allclose(tcomp * sign[:, None], jcomp, atol=1e-4)


def test_project_and_reconstruct_match(anisotropic):
    (jm, jcomp, _), _ = _fit_both(anisotropic, 8)
    c = tl.pca_project(t(anisotropic), t(jm), t(jcomp))
    np.testing.assert_allclose(c.numpy(), np.asarray(jl.pca_project(
        jnp.asarray(anisotropic), jnp.asarray(jm), jnp.asarray(jcomp))), atol=1e-4)
    np.testing.assert_allclose(tl.pca_reconstruct(c, t(jm), t(jcomp)).numpy(), anisotropic, atol=1e-3)


@pytest.mark.parametrize("attack", ["amputation", "jamming", "rounding"])
def test_latent_attacks_match_given_jaxs_pca(latents, attack):
    _, _, _, _, z, _, _ = latents
    (jm, jcomp, _), _ = _fit_both(z, 16)
    key = jax.random.PRNGKey(0)
    fns = {
        "amputation": (tl.amputation_fn(t(jm), t(jcomp), 8),
                       jl.amputation_fn(jnp.asarray(jm), jnp.asarray(jcomp), 8)),
        "jamming": (tl.jamming_fn(t(jm), t(jcomp), 8, jaxrand.prng_key(0)),
                    jl.jamming_fn(jnp.asarray(jm), jnp.asarray(jcomp), 8, key)),
        "rounding": (tl.rounding_fn(5.0), jl.rounding_fn(5.0)),
    }
    got_fn, want_fn = fns[attack]
    got, want = got_fn(t(z)).numpy(), np.asarray(want_fn(jnp.asarray(z)))
    assert got.shape == z.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    if attack == "rounding":  # half to even, as jnp.round
        halves = np.array([0.1, 0.3, -0.1, 0.5], np.float32)
        np.testing.assert_array_equal(tl.rounding_fn(5.0)(t(halves)).numpy(),
                                      np.asarray(jl.rounding_fn(5.0)(jnp.asarray(halves))))


def test_latent_delta_metrics_match(latents):
    _, _, _, _, z, zm, _ = latents
    got = tl.latent_delta_metrics(t(z), t(zm))
    want = jl.latent_delta_metrics(jnp.asarray(z), jnp.asarray(zm))
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6)


def test_reconstruction_sweep_and_head_tail_match(latents):
    jc, tc, _, marked, z, zm, msg = latents
    (jm, jcomp, _), _ = _fit_both(z, 16)
    jw, tw = JaxSS(cfg=JaxSSCfg(alpha=0.1)), SpreadSpectrumWM(cfg=SpreadSpectrumConfig(alpha=0.1))
    got = tl.reconstruction_attack_sweep(tc, tw, t(marked), t(jm), t(jcomp), (4, 16), t(msg))
    want = jl.reconstruction_attack_sweep(jc, jw, jnp.asarray(marked), jnp.asarray(jm),
                                          jnp.asarray(jcomp), (4, 16), jnp.asarray(msg))
    want = want.to_dict("records")
    assert [list(r) for r in got] == [list(r) for r in want]
    for g, w in zip(got, want):
        assert g["keep_k"] == w["keep_k"]
        assert abs(g["score_mean"] - w["score_mean"]) <= 1e-3
        assert abs(g["sisnr_mean"] - w["sisnr_mean"]) <= 1e-3
    dz = zm - z
    head, tail = tl.head_tail_energy(t(dz), t(jcomp), 8)
    jhead, jtail = jl.head_tail_energy(jnp.asarray(dz), jnp.asarray(jcomp), 8)
    assert head == pytest.approx(jhead, rel=1e-4) and tail == pytest.approx(jtail, rel=1e-4)
