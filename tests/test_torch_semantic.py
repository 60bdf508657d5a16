"""The port's semantic manifold watermarks against nawc_tpu's on the CPU,
with the tiny codec's weights in both.

Tolerances: axes 1e-5 (the PCA axis sign for sign); PN sequences equal;
residual, z and projections 1e-5 (relative to their scale); the embed
loss's gradient within 1e-4 of the largest |gradient|; Adam updates
within 2e-5 relative of optax's (optax rounds 1 - 0.999^t to float32,
1.3e-5 relative off, which reaches the update as 6.4e-6; torch forms it in
float64); scores 1e-4.  The finished embed is held
by its statistic (score within 1e-3), its budget, its mask and its
samples: Adam's first steps move every unmasked sample by about lr whatever
the size of its gradient, so a sample whose gradient is tiny may take the
other sign in one package; such samples (off by more than 1e-4) are
counted and must stay under 0.1% of the clip."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import t, tiny_codecs
from nawc_tpu.models import semantic as js
from nawc_tpu.utils.config import SemanticWMConfig as JaxSemCfg
from nawc_tpu_torch.models import SemanticWM, build, semantic
from nawc_tpu_torch.utils.config import SemanticWMConfig

STEPS = 8
FAST = dict(steps=STEPS, dynamic_eps=True, target_sdr_db=31.0, pn_seed=701, lsd_weight=1.0,
            proj_headroom_db=0.0, n_proj_phases=3, proj_free_above_hz=8000.0)


def _speech(n: int, length: int, seed: int) -> np.ndarray:
    """Harmonic tones under a syllable-rate envelope (with silent gaps, so
    that the silence mask matters), plus a faint noise floor."""
    rng = np.random.default_rng(seed)
    tt = np.arange(length) / 24_000
    f0 = rng.uniform(110, 220, (n, 1))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5, (n, 1)) * tt), 0, None) ** 2
    tone = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)) * env
    return (0.2 * tone + 0.002 * rng.normal(size=(n, length))).astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs()


@pytest.fixture(scope="module")
def wav():
    return _speech(2, 2 * 4096, seed=5)


def _axes(jc, tc):
    return {"pca": (js.pca_axis(jc.projected_codebook), semantic.pca_axis(tc.projected_codebook)),
            "kmeans": (js.kmeans_axis(jc.projected_codebook),
                       semantic.kmeans_axis(tc.projected_codebook)),
            "random": (js.random_axis(8), semantic.random_axis(8, device="cpu"))}


@pytest.mark.parametrize("kind", ["pca", "kmeans", "random"])
def test_axes_match(codecs, kind):
    want, got = _axes(*codecs)[kind]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(torch.linalg.vector_norm(got)) == pytest.approx(1.0, abs=1e-5)


def test_pn_is_jaxs():
    for n, seed in [(16, 701), (96, 702), (200, 42), (1, 7)]:
        np.testing.assert_array_equal(semantic._pn(n, seed).numpy(), np.asarray(js._pn(n, seed)))


def test_residual_zstat_and_projections_match(codecs, wav):
    jc, tc = codecs
    rng = np.random.default_rng(0)
    proj = rng.normal(size=(3, 40)).astype(np.float32)
    s = np.asarray(js._pn(40, 701))
    np.testing.assert_allclose(semantic._residual(t(proj), 9).numpy(),
                               np.asarray(js._residual(jnp.asarray(proj), 9)), atol=1e-5)
    np.testing.assert_allclose(semantic._zstat(t(proj), t(s), 9).numpy(),
                               np.asarray(js._zstat(jnp.asarray(proj), jnp.asarray(s), 9)), atol=1e-5)
    jaxis, taxis = _axes(jc, tc)["kmeans"]
    for standardize in (True, False):
        want = np.asarray(js._projections(jc.cfg, jc.params, jnp.asarray(wav), jaxis, standardize))
        got = semantic._projections(tc, t(wav), taxis, standardize).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5 * max(1.0, np.abs(want).max()))


def _jax_loss(jc, scfg, axis, x, mask):
    """The loss of nawc_tpu's ``_embed_phase``, from its public pieces."""
    def loss(delta):
        proj = js._projections(jc.cfg, jc.params, x + delta * mask, axis)
        return -jnp.sum(js._zstat(proj, js._pn(proj.shape[-1], scfg.pn_seed), scfg.ma_window)) / 10.0
    return loss


def test_loss_gradient_matches_jax_grad(codecs, wav):
    jc, tc = codecs
    jaxis, taxis = _axes(jc, tc)["pca"]
    mask = (np.abs(wav) > 0.01).astype(np.float32)
    delta = (np.random.default_rng(1).normal(size=wav.shape) * 1e-3).astype(np.float32)
    scfg = SemanticWMConfig(**FAST)
    want = np.asarray(jax.grad(_jax_loss(jc, JaxSemCfg(**FAST), jaxis, jnp.asarray(wav),
                                         jnp.asarray(mask)))(jnp.asarray(delta)))
    d = t(delta).requires_grad_(True)
    s = semantic._pn(wav.shape[-1] // tc.cfg.hop, scfg.pn_seed)
    semantic._loss(tc, scfg, taxis, s, t(wav), t(mask), d).backward()
    np.testing.assert_allclose(d.grad.numpy(), want, atol=1e-4 * np.abs(want).max())
    assert np.abs(want).max() > 0


def test_adam_update_is_optaxs():
    """torch.optim.Adam: eps outside the square root, both bias
    corrections, as optax.adam; three updates on the same gradients, within
    the float32 rounding of optax's bias corrections."""
    rng = np.random.default_rng(2)
    grads = [rng.normal(size=(2, 64)).astype(np.float32) * s for s in (1.0, 1e-3, 10.0)]
    opt = optax.adam(5e-3)
    p_j = jnp.zeros((2, 64), jnp.float32)
    state = opt.init(p_j)
    p_t = torch.zeros(2, 64, requires_grad=True)
    topt = torch.optim.Adam([p_t], lr=5e-3)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, p_j)
        p_j = optax.apply_updates(p_j, upd)
        p_t.grad = t(g)
        topt.step()
        np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), rtol=2e-5, atol=1e-10)


@pytest.fixture(scope="module")
def embedded(codecs, wav):
    jc, tc = codecs
    jaxis, taxis = _axes(jc, tc)["kmeans"]
    want = np.asarray(js.semantic_embed(jc.cfg, JaxSemCfg(**FAST), jc.params, jaxis, jnp.asarray(wav)))
    with torch.no_grad():  # the embed opens its own grad mode, as the runners call it
        got = semantic.semantic_embed(tc, SemanticWMConfig(**FAST), taxis, t(wav)).numpy()
    return want, got


def test_embed_matches_jax_by_its_statistic_budget_and_mask(codecs, wav, embedded):
    jc, tc = codecs
    want, got = embedded
    jaxis, taxis = _axes(jc, tc)["kmeans"]
    scfg = SemanticWMConfig(**FAST)
    s_got = semantic.semantic_score(tc, scfg, taxis, t(got)).numpy()
    s_want = np.asarray(js.semantic_score(jc.cfg, JaxSemCfg(**FAST), jc.params, jaxis, jnp.asarray(want)))
    s_clean = semantic.semantic_score(tc, scfg, taxis, t(wav)).numpy()
    np.testing.assert_allclose(s_got, s_want, atol=1e-3)
    assert (s_got > s_clean).all()
    # budget: the L2 ball of the target SDR and the peak cap; silence untouched
    delta = got - wav
    amp = np.sqrt(np.mean(wav ** 2, axis=-1)) * 10 ** (-scfg.target_sdr_db / 20)
    assert (np.linalg.norm(delta, axis=-1) <= amp * np.sqrt(wav.shape[-1]) * 1.001).all()
    assert (np.abs(delta).max(axis=-1) <= scfg.cap_mult * amp * 1.001).all()
    assert (delta[np.abs(wav) <= amp[:, None]] == 0).all()
    excused = int((np.abs(got - want) > 1e-4).sum())
    assert excused <= 1e-3 * got.size, f"{excused} samples differ from JAX's by more than 1e-4"


def test_static_eps_embed_keeps_eps_and_silence(codecs, wav):
    jc, tc = codecs
    scfg = SemanticWMConfig(steps=3, eps=5e-3, dynamic_eps=False)
    got = semantic.semantic_embed(tc, scfg, semantic.random_axis(8, device="cpu"), t(wav)).numpy()
    delta = np.abs(got - wav)
    assert delta.max() <= 5e-3 * 1.001 and delta.max() > 0
    assert delta[np.abs(wav) <= scfg.silence_threshold].max() == 0.0


def test_score_and_wrapper_match_jax(codecs, wav, embedded):
    jc, tc = codecs
    marked = embedded[0]
    for name, kind in [("semantic_pca", "pca"), ("semantic_cluster", "kmeans"),
                       ("semantic_random", "random")]:
        jw, tw = js.SemanticWM(jc, kind, cfg=JaxSemCfg(**FAST)), SemanticWM(tc, kind, cfg=SemanticWMConfig(**FAST))
        assert tw.name == jw.name and tw.sample_rate == jw.sample_rate == 24_000
        # the operating point: 300 steps, SDR 31 dB, PN seeds 701/702/703
        assert dataclasses.asdict(build(name, tc).scfg) == dataclasses.asdict(js._DEFAULT_CFGS[kind])
        for x in (marked, wav):
            np.testing.assert_allclose(tw.score(t(x)).numpy(), np.asarray(jw.score(jnp.asarray(x))),
                                       atol=1e-4)
        p_t, bits = tw.detect(t(marked))
        p_j, _ = jw.detect(jnp.asarray(marked))
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-4)
        assert bits.shape == (2, 0)
        np.testing.assert_allclose(tw.projections(t(wav)).numpy(),
                                   np.asarray(jw.projections(jnp.asarray(wav))), atol=1e-4)
