"""The port's audio-quality evaluation against nawc_tpu's on the CPU: exact
STOI and the PESQ proxy (the same float64 inputs, equal within 1e-12, and
the cases of ``tests/test_stoi_exact.py`` and ``test_pesq_proxy.py``),
``pesq_host``, ``evaluate_pair_batch`` under the 16 kHz protocol (dB
columns within 1e-3, LSD and the approximate STOI within 1e-4, exact STOI
1e-4, PESQ 1e-3), the artifact tree, ``make_pairs`` and ``evaluate_pairs``
(``tests/test_quality_files.py``, without the plot), and the quality-results
rows."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from _torch_port import speech, t
from nawc_tpu.eval import evaluate_pair_batch as jax_evaluate_pair_batch
from nawc_tpu.eval import evaluate_pairs as jax_evaluate_pairs
from nawc_tpu.eval import make_pairs as jax_make_pairs
from nawc_tpu.eval import reporting as jax_reporting
from nawc_tpu.eval.metrics import pesq_host as jax_pesq_host
from nawc_tpu.eval.metrics import pesq_impl as jax_pesq_impl
from nawc_tpu.eval.pesq_proxy import bark_disturbance as jax_bark
from nawc_tpu.eval.pesq_proxy import pesq_proxy as jax_pesq_proxy
from nawc_tpu.eval.stoi_exact import stoi_exact as jax_stoi_exact
from nawc_tpu.eval.stoi_exact import stoi_exact_batch as jax_stoi_exact_batch
from nawc_tpu_torch.eval import evaluate_pair_batch, evaluate_pairs, figures, make_pairs, pesq_host, reporting
from nawc_tpu_torch.eval.metrics import pesq_impl
from nawc_tpu_torch.eval.pesq_proxy import bark_disturbance, pesq_proxy
from nawc_tpu_torch.eval.stoi_exact import stoi_exact, stoi_exact_batch
from nawc_tpu_torch.models import SpreadSpectrumWM
from nawc_tpu_torch.utils import audio_io

EXACT = 1e-12


def _speech_like(n, seed=0, sr=16_000):
    """``tests/test_stoi_exact.py``'s noise under a 3 Hz envelope."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 0.1
    env = np.abs(np.sin(np.arange(n) * 2 * np.pi * 3 / sr)) + 0.1
    return x * env


def _speechlike(n=32000, sr=16000, seed=0):
    """``tests/test_pesq_proxy.py``'s harmonic signal with noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / sr
    f0 = 120 + 30 * np.sin(2 * np.pi * 1.3 * tt)
    x = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / sr) / k for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 2.7 * tt)) + 0.05
    return (x * env + 0.01 * rng.standard_normal(n)).astype(np.float64)


def _stoi(ref, est, sr):
    """The port's exact STOI, held to JAX's on the same inputs."""
    got, want = stoi_exact(ref, est, sr), jax_stoi_exact(ref, est, sr)
    assert (np.isnan(got) and np.isnan(want)) or abs(got - want) <= EXACT, (got, want)
    return got


def _pesq(ref, deg, sr):
    got, want = pesq_proxy(ref, deg, sr), jax_pesq_proxy(ref, deg, sr)
    assert abs(got - want) <= EXACT, (got, want)
    return got


@pytest.mark.parametrize("sr", [16_000, 24_000])
def test_host_metrics_equal_jax_on_float64(sr):
    x = np.stack([_speechlike(2 * sr, sr, seed=s) for s in range(2)])
    y = x + 0.02 * np.std(x) * np.random.default_rng(9).standard_normal(x.shape)
    np.testing.assert_allclose(stoi_exact_batch(x, y, sr), jax_stoi_exact_batch(x, y, sr),
                               rtol=0, atol=EXACT)
    for i in range(2):
        _pesq(x[i], y[i], sr)
        np.testing.assert_allclose(bark_disturbance(x[i], y[i], sr), jax_bark(x[i], y[i], sr),
                                   rtol=0, atol=EXACT)


def test_stoi_identical_is_one():
    x = _speech_like(3 * 16_000)
    assert _stoi(x, x, 16_000) == pytest.approx(1.0, abs=1e-9)


def test_stoi_monotone_in_snr():
    x = _speech_like(3 * 16_000)
    noise = np.random.default_rng(1).standard_normal(len(x))
    rms = np.sqrt((x**2).mean())
    vals = [_stoi(x, x + noise * rms * 10 ** (-snr / 20.0), 16_000) for snr in (30, 15, 0)]
    assert vals[0] > vals[1] > vals[2] and vals[0] > 0.99


def test_stoi_silent_frames_removed():
    sr = 16_000
    x = np.concatenate([_speech_like(sr), np.zeros(sr), _speech_like(sr, 2)])
    y = x.copy()
    y[sr + sr // 4: sr + 3 * sr // 4] += np.random.default_rng(3).standard_normal(sr // 2) * 1e-3
    assert _stoi(x, y, sr) > 0.999


def test_stoi_too_short_is_nan():
    x = _speech_like(1000)
    assert np.isnan(_stoi(x, x, 16_000))


def test_stoi_batch_matches_scalar():
    x = np.stack([_speech_like(2 * 16_000, s) for s in range(2)])
    y = x + 0.01 * np.random.default_rng(4).standard_normal(x.shape)
    b = stoi_exact_batch(x, y, 16_000)
    assert b.shape == (2,) and b[0] == pytest.approx(_stoi(x[0], y[0], 16_000))


def test_stoi_24k_input_resampled():
    x = _speech_like(3 * 24_000, sr=24_000)
    v = _stoi(x, x + 1e-4 * np.random.default_rng(5).standard_normal(len(x)), 24_000)
    assert 0.9 < v <= 1.0


def test_pesq_identity_scores_max():
    x = _speechlike()
    assert _pesq(x, x, 16000) > 4.55


def test_pesq_monotone_under_noise():
    x = _speechlike()
    noise = np.random.default_rng(1).standard_normal(x.size)
    scores = [_pesq(x, x + lvl * noise * np.std(x), 16000) for lvl in (0.0, 0.03, 0.1, 0.3)]
    assert all(a >= b - 1e-9 for a, b in zip(scores, scores[1:])), scores
    assert scores[0] - scores[-1] > 0.5 and all(1.0 <= s <= 4.64 for s in scores)


def test_pesq_gain_and_mild_filtering_forgiven():
    x = _speechlike()
    assert _pesq(x, 0.5 * x, 16000) > 4.5
    assert _pesq(x, np.convolve(x, [0.9, 0.1], mode="same"), 16000) > 4.0


def test_pesq_resamples_other_rates():
    x = _speechlike(48000, 24000)
    y = x + 0.001 * np.std(x) * np.random.default_rng(2).standard_normal(x.size)
    assert 3.5 < _pesq(x, y, 24000) <= 4.64


def test_pesq_asym_feature_fires_on_additive_noise():
    x = _speechlike()
    y = x + 0.2 * np.std(x) * np.random.default_rng(3).standard_normal(x.size)
    _, _, da_clean = bark_disturbance(x, x, 16000)
    _, _, da_noisy = bark_disturbance(x, y, 16000)
    assert da_noisy > da_clean + 1e-4


def test_pesq_host_fills_column_and_reports_proxy():
    x = _speechlike()
    y = x + 0.05 * np.std(x) * np.random.default_rng(4).standard_normal(x.size)
    v = pesq_host(x, y, 16000)
    assert np.isfinite(v) and 1.0 <= v <= 4.64
    assert abs(v - jax_pesq_host(x, y, 16000)) <= EXACT
    assert pesq_impl() == jax_pesq_impl() == "proxy"
    assert np.isnan(pesq_host(x[:100], y[:100], 16000))  # too short: NaN, as JAX


# dB columns within 1e-3, LSD and the on-device STOI within 1e-4, exact
# STOI within 1e-4 and PESQ within 1e-3
BARS = {"si_snr_clean": 1e-3, "si_snr_watermarked": 1e-3, "delta_si_snr": 1e-3, "snr": 1e-3,
        "lsd": 1e-4, "lsd_native": 1e-4, "stoi_dev": 1e-4, "stoi": 1e-4, "pesq": 1e-3}


@pytest.mark.parametrize("sr,with_pesq", [(16_000, False), (16_000, True), (24_000, False),
                                          (24_000, True)])
def test_evaluate_pair_batch_matches_jax(sr, with_pesq):
    clean = speech(sr, 3, 2.0, seed=sr)
    marked = (clean + 0.003 * np.random.default_rng(1).standard_normal(clean.shape)).astype(np.float32)
    got = evaluate_pair_batch(t(clean), t(marked), sr, with_pesq=with_pesq)
    want = jax_evaluate_pair_batch(jnp.asarray(clean), jnp.asarray(marked), sr, with_pesq=with_pesq)
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == np.asarray(w).dtype, k
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=0, atol=BARS[k], err_msg=k)


@pytest.fixture(scope="module")
def artifact_tree(tmp_path_factory):
    """Two clips of 2 s at 16 kHz and their spread-spectrum marks, written
    by the port's ``save_artifacts``."""
    root = tmp_path_factory.mktemp("artifacts")
    wm = SpreadSpectrumWM()
    clean = speech(16_000, 2, 2.0, seed=7)
    msg = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (2, wm.n_bits)).astype(np.int32))
    marked = wm.embed(t(clean), msg).numpy()
    attacked = 0.9 * marked
    for i in range(2):
        reporting.save_artifacts(root, f"clip_{i}", clean[i], marked[i], attacked[i], 16_000)
    return root, (clean, marked, attacked)


def test_artifacts_written_as_jax_writes_them(artifact_tree, tmp_path):
    root, clips = artifact_tree
    a, sr = audio_io.read_wav(root / "clip_1" / "2_watermarked.wav")
    assert sr == 16_000 and a.shape == (1, 32_000)
    jax_reporting.save_artifacts(tmp_path, "clip_1", *(x[1] for x in clips), 16_000)
    for name in ("1_original.wav", "2_watermarked.wav", "3_attacked.wav"):
        assert (root / "clip_1" / name).read_bytes() == (tmp_path / "clip_1" / name).read_bytes()
    # the comparison PNG is drawn where matplotlib imports (here it does)
    assert figures.available() and (root / "clip_1" / "comparison.png").stat().st_size > 0


@pytest.mark.parametrize("with_pesq", [False, True])
def test_make_pairs_and_evaluate_pairs_match_jax(artifact_tree, with_pesq):
    pairs = make_pairs(artifact_tree[0])
    assert pairs == jax_make_pairs(artifact_tree[0]) and len(pairs) == 2
    rows = evaluate_pairs(pairs, sr=16_000, with_pesq=with_pesq, device="cpu")
    df = jax_evaluate_pairs(pairs, sr=16_000, with_pesq=with_pesq)
    assert list(rows[0]) == list(df.columns)
    for col in df.columns:
        got = [r[col] for r in rows]
        if col in BARS:
            np.testing.assert_allclose(got, df[col].to_numpy(), rtol=0, atol=BARS[col], err_msg=col)
        else:
            assert got == df[col].tolist(), col
    # the watermark at ~22 dB survives the 16-bit WAV round trip
    assert all(r["si_snr_watermarked"] > 15 and r["stoi"] > 0.85 for r in rows)


def test_quality_results_frame_matches_jax():
    metrics = [{"snr": 20.5, "stoi": 0.99}, {"snr": 18.25, "stoi": 0.98}]
    rows = reporting.quality_results_frame(["a.wav", "b.wav"], ["a_m.wav", "b_m.wav"], metrics)
    df = jax_reporting.quality_results_frame(["a.wav", "b.wav"], ["a_m.wav", "b_m.wav"], metrics)
    assert rows == df.to_dict("records")
    assert list(rows[0]) == list(df.columns)


def test_evaluate_pairs_defaults_to_cuda_and_raises_without_it(artifact_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_pairs(make_pairs(artifact_tree[0]))
