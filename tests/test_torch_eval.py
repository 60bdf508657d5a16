"""nawc_tpu_torch.eval against nawc_tpu.eval on the CPU: the metrics, the
chunking, the threshold search, the robustness and combined runners row for
row (pandas only on the JAX side, as ``to_dict("records")``), and the stats
tables.

Tolerances: metrics 1e-4 relative; bit accuracies and hard decisions equal;
SI-SNR columns and scores 1e-4 relative (1e-3 dB absolute); the stats
tables of the same rows 1e-9 relative."""

import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from _torch_port import t, tiny_codecs
from nawc_tpu.attacks import build_suite as jax_build_suite
from nawc_tpu.eval import benchmark as jbench
from nawc_tpu.eval import metrics as jmetrics
from nawc_tpu.eval import robustness as jrob
from nawc_tpu.models import ChunkedWM as JaxChunked
from nawc_tpu.models import SpreadSpectrumWM as JaxSS
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu_torch.attacks import build_suite
from nawc_tpu_torch.eval import benchmark, metrics, robustness
from nawc_tpu_torch.models import ChunkedWM, SpreadSpectrumWM
from nawc_tpu_torch.utils.config import SpreadSpectrumConfig

REL = 1e-4
ATTACKS = ["gaussian_noise", "quantization", "time_stretch", "vorbis", "mp3", "dac", "encodec"]


def _speech(sr, seconds, n, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    f0 = rng.uniform(110, 220, (n, 1))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5, (n, 1)) * tt), 0, None) ** 2
    tone = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)) * env
    return (0.2 * tone + 0.01 * rng.normal(size=(n, tt.size))).astype(np.float32)


def _assert_rows_match(got: list[dict], want: list[dict]):
    """Equal keys (a JAX record's NaN is a key the row lacks) and values;
    SI-SNRs, scores and thresholds within REL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = {k: v for k, v in w.items() if not (isinstance(v, float) and math.isnan(v))}
        assert sorted(g) == sorted(w), (list(g), list(w))
        for k in g:
            if k.startswith(("sisnr", "score")) or k.endswith("threshold"):
                assert g[k] == pytest.approx(w[k], rel=REL, abs=1e-3), (k, g, w)
            else:
                assert g[k] == w[k] and type(g[k]) is type(w[k]) or (
                    isinstance(g[k], (int, float)) and g[k] == w[k]), (k, g[k], w[k])


# ------------------------------------------------------------------ metrics

@pytest.mark.parametrize("name,sr", [("si_snr", 16_000), ("snr", 16_000), ("lsd", 16_000),
                                     ("stoi", 16_000), ("stoi", 44_100), ("si_sdr", 16_000)])
def test_metric_matches_jax(name, sr):
    ref = _speech(sr, 1.1, 3, seed=1)
    est = ref + 0.02 * np.random.default_rng(2).normal(size=ref.shape).astype(np.float32)
    kw = {"sample_rate": sr} if name == "stoi" else {}
    want = np.asarray(getattr(jmetrics, name)(jnp.asarray(ref), jnp.asarray(est), **kw))
    got = getattr(metrics, name)(t(ref), t(est), **kw).numpy()
    assert got.shape == want.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=REL)


def test_third_octave_matrix_is_jax_s():
    for sr, n_fft in [(16_000, 512), (44_100, 1024)]:
        np.testing.assert_array_equal(metrics._third_octave_matrix(sr, n_fft),
                                      jmetrics._third_octave_matrix(sr, n_fft))


@pytest.mark.parametrize("n", [10, 32_000, 70_000])
def test_chunk_audio_matches(n):
    wav = np.arange(n, dtype=np.float32)
    for a, b in zip(robustness.chunk_audio(wav, 16_000), jrob.chunk_audio(wav, 16_000)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [40, 2000])
def test_threshold_search_and_auc_are_jax_s(n):
    rng = np.random.default_rng(n)
    scores = rng.uniform(size=n)
    labels = (rng.uniform(size=n) < scores).astype(float)
    assert benchmark.find_optimal_threshold(scores, labels) == jbench.find_optimal_threshold(scores, labels)
    assert benchmark.detection_auc(scores, labels) == jbench.detection_auc(scores, labels)
    assert math.isnan(benchmark.detection_auc(scores, np.ones(n)))


# ------------------------------------------------------------------ runners

@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs(seed=3)


def _ss():
    kw = dict(alpha=0.1)
    return JaxSS(cfg=JaxSSCfg(**kw)), SpreadSpectrumWM(cfg=SpreadSpectrumConfig(**kw))


def _suites(codecs, names):
    js, ts = jax_build_suite(16_000, codecs[0]), build_suite(16_000, codecs[1])
    return {n: js[n] for n in names}, {n: ts[n] for n in names}


@pytest.mark.parametrize("sync", [False, True])
def test_run_robustness_matches_jax_row_for_row(codecs, sync):
    jw, tw = _ss()
    js, ts = _suites(codecs, ATTACKS if not sync else ["identity", "time_stretch", "aac"])
    clips = [_speech(16_000, 1.2, 1, seed=4)[0], _speech(16_000, 2.1, 1, seed=5)[0]]
    want = jrob.run_robustness(jw, js, clips, 16_000, chunk_seconds=1.0, sync=sync,
                               detect_batch=2)
    got = robustness.run_robustness(tw, ts, clips, 16_000, chunk_seconds=1.0, sync=sync,
                                    detect_batch=2, device="cpu")
    assert len(got) == 3 * len(ts)
    _assert_rows_match(got, want.to_dict("records"))
    assert {r["bitwise/clean"] for r in got} == {1.0}


def test_stats_tables_match_pandas_on_the_same_rows():
    """overall_stats and stats_by_attack of one table, against the JAX
    package's pandas versions of the same rows: the columns in order, the
    groups sorted, std at ddof 1 and NaN for a group of one."""
    rng = np.random.default_rng(7)
    rows = [{"clip_index": int(i % 3), "chunk_index": int(i % 2), "attack_type": a,
             "bitwise/clean": float(rng.uniform()), "hard/clean": float(rng.integers(0, 2)),
             "sisnr_wm": float(rng.normal(30, 3))}
            for i, a in enumerate(["vorbis", "aac", "aac", "mp3", "aac", "vorbis", "zz"])]
    df = pd.DataFrame(rows)
    for ours, theirs in [(robustness.overall_stats(rows), jrob.overall_stats(df)),
                         (robustness.stats_by_attack(rows), jrob.stats_by_attack(df))]:
        want = theirs.to_dict("records")
        assert [list(r) for r in ours] == [list(r) for r in want]
        for o, w in zip(ours, want):
            for k in o:
                if isinstance(w[k], float) and math.isnan(w[k]):
                    assert math.isnan(o[k]), k
                else:
                    assert o[k] == pytest.approx(w[k], rel=1e-9), k
    assert [r["attack_type"] for r in robustness.stats_by_attack(rows)] == ["aac", "mp3", "vorbis", "zz"]


def test_run_combined_matches_jax_row_for_row(codecs):
    jss, tss = _ss()
    jws = {"spread_spectrum": jss, "chunked": JaxChunked()}
    tws = {"spread_spectrum": tss, "chunked": ChunkedWM()}
    js, ts = _suites(codecs, ["gain", "reverb", "dac"])
    wav = _speech(16_000, 2.0, 3, seed=6)
    want = jbench.run_combined(jws, js, jnp.asarray(wav))
    got = benchmark.run_combined(tws, ts, wav, device="cpu")
    _assert_rows_match(got.per_method, want.per_method.to_dict("records"))
    _assert_rows_match(got.summary, want.summary.to_dict("records"))
    assert not any("error" in r for r in got.per_method)


def test_failing_method_gives_error_rows(codecs):
    class Broken(SpreadSpectrumWM):
        def embed(self, wav, msg, key=None):
            raise ValueError("broken embed")

    _, ts = _suites(codecs, ["gain"])
    rows = benchmark.run_survivability({"broken": Broken()}, ts, np.zeros((2, 16_000), np.float32),
                                       device="cpu")
    assert rows == [{"watermark": "broken", "attack": "-", "clip_index": -1,
                     "error": "ValueError('broken embed')"}]


def test_runners_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tw = _ss()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        robustness.run_robustness(tw, {"gain": build_suite()["gain"]},
                                  [np.zeros(16_000, np.float32)], 16_000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.run_combined({"spread_spectrum": tw}, {}, np.zeros((1, 16_000), np.float32))


def test_csv_roundtrip(tmp_path):
    rows = [{"a": 1, "b": 0.1 + 0.2, "c": "x|y"}, {"a": 2, "c": "z", "b": math.nan}]
    robustness.write_results_csv(rows, tmp_path / "r.csv")
    text = (tmp_path / "r.csv").read_text().splitlines()
    assert text[0] == "a|b|c" and text[1] == '1|0.30000000000000004|"x|y"' and text[2] == "2||z"
    back = robustness.read_csv(tmp_path / "r.csv", sep="|")
    assert back[0] == rows[0] and back[1]["a"] == 2 and math.isnan(back[1]["b"])
    assert pd.read_csv(tmp_path / "r.csv", sep="|", float_precision="round_trip").to_dict("records")[0] == rows[0]
