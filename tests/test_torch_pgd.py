"""The port's PGD attacks against nawc_tpu's on the CPU, through the
spread-spectrum detector's signed-correlation score (and, for the subspace
attack, the tiny codec's latents).

Tolerances: gradients within 1e-4 of the largest |gradient| in all but
1% of the samples and within 1e-3 of it everywhere.  The detector's
gradient is ill-conditioned at quiet samples (its log-magnitude divides by
|X|): JAX's own gradient moves by 1.5e-4 of its largest value in 0.13% of
the samples when the input moves by one float32 ulp.  The first step of
``pgd_attack`` recovers the gradient from the normalised update (float32
resolution there is about 2e-5 of it).  A 20-step sign attack must
lower the score and keep |delta| <= eps in both packages; after the first
sign step the two may part where a tiny gradient takes the other sign, so
they are not held sample by sample."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_gradient_close as _assert_gradient_close
from _torch_port import speech as _speech
from _torch_port import t, tiny_codecs
from nawc_tpu.attacks import pgd as jpgd
from nawc_tpu.models import SpreadSpectrumWM as JaxSS
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu_torch.attacks import pgd, pgd_attack, project_to_nullspace, subspace_pgd_attack
from nawc_tpu_torch.models import SpreadSpectrumWM
from nawc_tpu_torch.utils.config import SpreadSpectrumConfig

EPS, LR = 0.02, 0.001


@pytest.fixture(scope="module")
def marked():
    """(JAX wm, port wm, marked 16 kHz clips, message) for 2 x 1 s."""
    jw, tw = JaxSS(cfg=JaxSSCfg(alpha=0.1)), SpreadSpectrumWM(cfg=SpreadSpectrumConfig(alpha=0.1))
    wav = _speech(16_000, 2, 1.0, seed=1)
    msg = np.random.default_rng(2).integers(0, 2, (2, 16)).astype(np.int32)
    return jw, tw, np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg))), msg


def test_first_step_gradient_matches_jax_grad(marked):
    jw, tw, x, msg = marked
    want = np.asarray(jax.grad(lambda d: jnp.sum(jw.score(jnp.asarray(x) + d, jnp.asarray(msg))))(
        jnp.zeros_like(jnp.asarray(x))))
    with torch.no_grad():  # the attack opens its own grad mode
        attacked = pgd_attack(lambda w: tw.score(w, t(msg)), t(x), steps=1, eps=EPS, lr=LR,
                              sign_update=False).numpy()
    got = -(attacked - x) / LR * np.abs(want).max()
    _assert_gradient_close(got, want)
    # JAX's one normalised step lands on the same audio
    jatt = np.asarray(jpgd.pgd_attack(lambda w: jw.score(w, jnp.asarray(msg)), jnp.asarray(x),
                                      steps=1, eps=EPS, lr=LR, sign_update=False))
    np.testing.assert_allclose(attacked, jatt, atol=1e-3 * LR)


def test_twenty_step_attack_lowers_the_score_within_eps(marked):
    jw, tw, x, msg = marked
    got = pgd_attack(lambda w: tw.score(w, t(msg)), t(x), steps=20, eps=EPS, lr=LR)
    want = jpgd.pgd_attack(lambda w: jw.score(w, jnp.asarray(msg)), jnp.asarray(x), steps=20,
                           eps=EPS, lr=LR)
    before = tw.score(t(x), t(msg)).numpy()
    for attacked, score in [(got.numpy(), tw.score(got, t(msg)).numpy()),
                            (np.asarray(want), np.asarray(jw.score(want, jnp.asarray(msg))))]:
        assert (score < before).all(), (before, score)
        assert np.abs(attacked - x).max() <= EPS + 1e-7
        assert np.abs(attacked).max() <= 1.0
    # the first sign steps move every sample by lr alike: the two stay close
    assert np.abs(got.numpy() - np.asarray(want)).mean() < 0.1 * LR * 20


@pytest.fixture(scope="module")
def subspace_setup():
    """A 24 kHz spread-spectrum score, the tiny codec's latents and an
    orthonormal 6-row basis of its 64-dim latent space."""
    jc, tc = tiny_codecs()
    cfg = dict(sample_rate=24_000, band_hi_hz=9000.0, alpha=0.1)
    jw, tw = JaxSS(cfg=JaxSSCfg(**cfg)), SpreadSpectrumWM(cfg=SpreadSpectrumConfig(**cfg))
    wav = _speech(24_000, 2, 4096 / 24_000, seed=3)
    basis = np.linalg.qr(np.random.default_rng(4).normal(size=(64, 6)))[0].T.astype(np.float32)
    return jc, tc, jw, tw, wav, basis


def test_subspace_penalty_gradient_matches_jax(subspace_setup):
    jc, tc, jw, tw, wav, basis = subspace_setup
    delta = (np.random.default_rng(5).normal(size=wav.shape) * 3e-3).astype(np.float32)
    z0_j = jc.encode_latent(jnp.asarray(wav))

    def jax_total(d):  # nawc_tpu's subspace_pgd_attack loss, penalty on
        dz = jc.encode_latent(jnp.asarray(wav) + d) - z0_j
        head = dz @ jnp.asarray(basis).T
        return jnp.sum(jw.score(jnp.asarray(wav) + d)) + 1.0 * jnp.sum(head * head)

    want = np.asarray(jax.grad(jax_total)(jnp.asarray(delta)))
    d = t(delta).requires_grad_(True)
    z0 = tc.encode_latent(t(wav))
    pgd.subspace_loss(tw.score, tc.encode_latent, t(wav), z0, t(basis), d).backward()
    _assert_gradient_close(d.grad.numpy(), want)
    # the penalty carries gradient of its own: without it the gradient differs
    d0 = t(delta).requires_grad_(True)
    pgd.subspace_loss(tw.score, tc.encode_latent, t(wav), z0, t(basis), d0, use_penalty=False).backward()
    assert not torch.allclose(d0.grad, d.grad)


def test_subspace_attack_shape_bounds_and_nullspace(subspace_setup):
    _, tc, _, tw, wav, basis = subspace_setup
    with torch.no_grad():
        out = subspace_pgd_attack(tw.score, tc.encode_latent, t(wav), t(basis), steps=6,
                                  eps=EPS, lr=LR, project_every=5)
    assert out.shape == wav.shape and torch.isfinite(out).all()
    assert float((out - t(wav)).abs().max()) <= EPS + 1e-7
    z = torch.as_tensor(np.random.default_rng(6).normal(size=(3, 5, 64)), dtype=torch.float32)
    got = project_to_nullspace(z, t(basis))
    np.testing.assert_allclose(got.numpy(), np.asarray(jpgd.project_to_nullspace(
        jnp.asarray(z.numpy()), jnp.asarray(basis))), atol=1e-5)
    assert float((got @ t(basis).T).abs().max()) < 1e-5
