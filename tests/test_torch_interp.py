"""The port's interpretability layer against nawc_tpu's on the CPU: latent
probes, the spectral footprint, saliency, MC uncertainty, the layer
ablation, the manifold analysis and the feature importance, on the tiny
codec (``tests/_torch_port.py``, the same weights in both packages) and
2 speech-like clips of 1 s.

Tolerances: latents 5e-4 (the codec bar, ``tests/test_codec.py:85``);
the spectral footprint 1e-4; scores (ablation and manifold rows, MC means)
1e-3; the numpy functions of the uncertainty analysis and the feature
importance equal on identical inputs; ``estimate_axis`` 1e-4, sign
included; saliency and IG by the excused-sample rule of the PGD tests
(ROADMAP.md C); ``topk_salient_frames`` equal, ties included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from _torch_port import assert_gradient_close, speech, t, tiny_codecs
from nawc_tpu import interp as jinterp
from nawc_tpu.interp import feature_importance as jfi
from nawc_tpu.models import SpreadSpectrumWM as JaxSS
from nawc_tpu.models import random_message as jax_random_message
from nawc_tpu.models import semantic as jax_semantic
from nawc_tpu.attacks.codec import codec_roundtrip as jax_codec_roundtrip
from nawc_tpu.models.semantic import SemanticWM as JaxSemanticWM
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu_torch import interp
from nawc_tpu_torch.attacks import codec_roundtrip
from nawc_tpu_torch.interp import feature_importance as fi
from nawc_tpu_torch.models import SemanticWM, SpreadSpectrumWM, semantic
from nawc_tpu_torch.models.base import embed_payload
from nawc_tpu_torch.utils import jaxrand
from nawc_tpu_torch.utils.config import SpreadSpectrumConfig


@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs()


@pytest.fixture(scope="module")
def marked16():
    """(JAX wm, port wm, clean, marked, msg): the spread-spectrum watermark
    at 16 kHz on 2 x 1 s, marked by JAX with PRNGKey(0)'s message."""
    jw, tw = JaxSS(cfg=JaxSSCfg(alpha=0.1)), SpreadSpectrumWM(cfg=SpreadSpectrumConfig(alpha=0.1))
    wav = speech(16_000, 2, 1.0, seed=1)
    msg = jax_random_message(jax.random.PRNGKey(0), 2, 16)
    return jw, tw, wav, np.asarray(jw.embed(jnp.asarray(wav), msg)), np.asarray(msg)


def test_latent_probes_match(codecs, marked16):
    jc, tc = codecs
    _, _, wav, _, _ = marked16
    axis = np.random.default_rng(2).normal(size=64).astype(np.float32)
    for got, want in [(interp.get_latent(tc, t(wav)), jinterp.get_latent(jc, jnp.asarray(wav))),
                      (interp.get_mean_latent(tc, t(wav)), jinterp.get_mean_latent(jc, jnp.asarray(wav))),
                      (interp.project_on_axis(tc, t(wav), t(axis)),
                       jinterp.project_on_axis(jc, jnp.asarray(wav), jnp.asarray(axis)))]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4)


def test_spectral_footprint_matches(marked16):
    _, _, wav, marked, _ = marked16
    for n_bands in (8, 16):
        got = interp.residual_report(t(wav), t(marked), n_bands)
        want = jinterp.residual_report(jnp.asarray(wav), jnp.asarray(marked), n_bands)
        assert got["band_energy"].shape == (2, n_bands)
        np.testing.assert_allclose(got["snr_db"], want["snr_db"], atol=1e-4)
        np.testing.assert_allclose(got["band_energy"], want["band_energy"], rtol=1e-4, atol=1e-10)


def test_saliency_and_integrated_gradients_match(marked16):
    jw, tw, _, marked, msg = marked16
    x = jnp.asarray(marked)
    got = interp.input_gradient(lambda w: tw.score(w, t(msg)), t(marked)).numpy()
    want = np.asarray(jinterp.input_gradient(lambda w: jw.score(w, jnp.asarray(msg)), x))
    assert_gradient_close(got, want)
    got = interp.integrated_gradients(lambda w: tw.score(w, t(msg)), t(marked), steps=4).numpy()
    want = np.asarray(jinterp.integrated_gradients(lambda w: jw.score(w, jnp.asarray(msg)), x, steps=4))
    assert_gradient_close(got, want)
    spec = interp.saliency_spectrogram(t(marked), t(got))
    jspec = np.asarray(jinterp.saliency_spectrogram(x, jnp.asarray(got)))
    np.testing.assert_allclose(spec.numpy(), jspec, rtol=1e-4, atol=1e-4 * jspec.max())
    np.testing.assert_array_equal(interp.topk_salient_frames(t(jspec), 5).numpy(),
                                  np.asarray(jinterp.topk_salient_frames(jnp.asarray(jspec), 5)))


def test_topk_salient_frames_orders_ties_as_lax_top_k():
    energy = np.array([[1.0, 3.0, 3.0, 0.5, 3.0, 2.0, 2.0],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    spec = np.repeat(np.sqrt(energy)[..., None], 1, axis=-1)
    got = interp.topk_salient_frames(t(spec), 5).numpy()
    want = np.asarray(jinterp.topk_salient_frames(jnp.asarray(spec), 5))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[1, 2, 4, 5, 6], [0, 1, 2, 3, 4]])


def test_monte_carlo_scores_match(marked16):
    jw, tw, wav, marked, _ = marked16
    both = np.concatenate([marked, wav])
    labels = np.array([1, 1, 0, 0], np.int32)
    key = jax.random.PRNGKey(1)
    got = interp.mc_statistics(tw.score, t(both), jaxrand.prng_key(1), labels=labels, n_samples=3)
    want = jinterp.mc_statistics(jw.score, jnp.asarray(both), key, labels=labels, n_samples=3)
    assert list(got) == list(want)
    np.testing.assert_allclose(got["mc_mean_prob"], want["mc_mean_prob"], atol=1e-3)
    np.testing.assert_allclose(got["mc_var_prob"], want["mc_var_prob"], atol=1e-3)
    np.testing.assert_array_equal(got["correct"], want["correct"])
    # the noise is jax.random.normal's, sample by sample
    scores = interp.monte_carlo_scores(tw.score, t(both), jaxrand.prng_key(1), n_samples=3)
    jscores = jinterp.monte_carlo_scores(jw.score, jnp.asarray(both), key, n_samples=3)
    assert scores.shape == (3, 4)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores), atol=1e-3)


def test_uncertainty_numpy_functions_equal_jaxs():
    rng = np.random.default_rng(3)
    probs = np.concatenate([rng.uniform(size=40), [0.0, 0.1, 0.5, 1.0]]).astype(np.float32)
    labels = (rng.uniform(size=probs.size) < probs).astype(np.int32)
    var = rng.uniform(size=probs.size).astype(np.float32) * 1e-3
    correct = ((probs > 0.5) == labels).astype(np.int32)
    for n_bins in (5, 10):
        for g, w in zip(interp.reliability_curve(probs, labels, n_bins),
                        jinterp.reliability_curve(probs, labels, n_bins)):
            np.testing.assert_array_equal(g, w)
        assert interp.expected_calibration_error(probs, labels, n_bins) == \
            jinterp.expected_calibration_error(probs, labels, n_bins)
    assert interp.variance_error_auc(var, correct) == jinterp.variance_error_auc(var, correct)
    assert np.isnan(interp.variance_error_auc(var, np.ones_like(correct)))


def _rows_close(got: list[dict], want: pd.DataFrame, tol: float) -> None:
    want = want.to_dict("records")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, float):
                assert abs(g[k] - v) <= tol, (k, g, w)
            else:
                assert g[k] == v, (k, g, w)


def test_layer_ablation_rows_and_heatmap_match(codecs, marked16):
    jc, tc = codecs
    jw, tw, wav, _, _ = marked16
    got = interp.run_layer_ablation(tc, {"spread_spectrum": tw}, t(wav), in_sr=16_000)
    want = jinterp.run_layer_ablation(jc, {"spread_spectrum": jw}, jnp.asarray(wav), in_sr=16_000)
    assert len(got) == 6 * 2
    _rows_close(got, want, 1e-3)
    heat = interp.ablation_heatmap(got)
    jheat = jinterp.ablation_heatmap(want)
    assert [r["mask"] for r in heat] == list(jheat.index)
    for r in heat:
        assert abs(r["spread_spectrum"] - jheat.loc[r["mask"], "spread_spectrum"]) <= 1e-3


def test_estimate_axis_matches_sign_included(codecs):
    jc, tc = codecs
    jw = JaxSS(cfg=JaxSSCfg(sample_rate=24_000, band_hi_hz=9000.0, alpha=0.1))
    wav = speech(24_000, 3, 4096 / 24_000, seed=4)
    marked = np.asarray(jw.embed(jnp.asarray(wav), jax_random_message(jax.random.PRNGKey(0), 3, 16)))
    got = interp.estimate_axis(tc, t(wav), t(marked)).numpy()
    want = np.asarray(jinterp.estimate_axis(jc, jnp.asarray(wav), jnp.asarray(marked)))
    assert got.shape == (64,)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.fixture(scope="module")
def two_steps():
    """The semantic PCA operating point with 2 Adam steps, in both packages."""
    mp = pytest.MonkeyPatch()
    for mod in (semantic, jax_semantic):
        mp.setitem(mod._DEFAULT_CFGS, "pca", dataclasses.replace(mod._DEFAULT_CFGS["pca"], steps=2))
    yield
    mp.undo()


def test_manifold_rows_match(codecs, two_steps):
    """The codec round-trip as the attack; the spread-spectrum watermark on
    the estimated axis, the semantic one through its own projections."""
    jc, tc = codecs
    cfg = dict(sample_rate=24_000, band_hi_hz=9000.0, alpha=0.1)
    wav = speech(24_000, 2, 4096 / 24_000, seed=5)
    got = interp.run_manifold_analysis(
        tc, {"spread_spectrum": SpreadSpectrumWM(cfg=SpreadSpectrumConfig(**cfg)),
             "semantic_pca": SemanticWM(tc, "pca")}, t(wav), lambda w: codec_roundtrip(tc, w))
    want = jinterp.run_manifold_analysis(
        jc, {"spread_spectrum": JaxSS(cfg=JaxSSCfg(**cfg)), "semantic_pca": JaxSemanticWM(jc, "pca")},
        jnp.asarray(wav), lambda w: jax_codec_roundtrip(jc, w))
    _rows_close(got, want, 1e-3)


def test_embed_payload_draws_jaxs_message(marked16):
    _, tw, wav, marked, msg = marked16
    got, got_msg = embed_payload(tw, t(wav), jaxrand.prng_key(0))
    np.testing.assert_array_equal(got_msg.numpy(), msg)
    np.testing.assert_allclose(got.numpy(), marked, atol=1e-5)


def _mixed_table() -> list[dict]:
    rng = np.random.default_rng(6)
    n = 40
    x = rng.normal(size=n)
    rows = []
    for i in range(n):
        rows.append({
            "attack_type": ["mp3", "noise", "gain"][i % 3],
            "a": float(x[i]),
            "a_copy": float(x[i]),  # ties a in |pearson|: the column order decides
            "b": float(-2 * x[i] + 0.1 * rng.normal()),
            "c": float(rng.normal()) if i % 7 else float("nan"),
            "k": int(rng.integers(0, 5)),
            "flag": bool(i % 2),
            "const": 1.0,
            "target": float(x[i] + 0.05 * rng.normal()),
        })
    return rows


def test_feature_importance_equals_jaxs():
    rows = _mixed_table()
    df = pd.DataFrame(rows)
    got = fi.compute_feature_importance(rows, "target")
    want = jfi.compute_feature_importance(df, "target").to_dict("records")
    assert got == want
    assert [r["feature"] for r in got][:3] == ["a", "a_copy", "b"]
    for col in ("flag", "attack_type", "const", "target"):
        assert col not in [r["feature"] for r in got]
    x = np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0])
    np.testing.assert_array_equal(fi._rankdata(x), jfi._rankdata(x))
    with pytest.raises(KeyError):
        fi.compute_feature_importance(rows, "flag")


def test_exports_are_jaxs():
    assert interp.__all__ == jinterp.__all__
    assert all(callable(getattr(interp, n)) for n in interp.__all__)
    assert torch.is_tensor(interp.band_energies(torch.zeros(1, 4096)))
