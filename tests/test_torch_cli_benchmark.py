"""The port's benchmark and watermark CLIs against nawc_tpu's on the CPU:
two wavs written by the test, the small codec with the tiny codec's weights
(``tests/_torch_port.py``) from a checkpoint the test writes, the spread-spectrum
watermark at 16 kHz beside the semantic PCA watermark at the codec's 24 kHz
(the CLI resamples the clips for it), and three attacks.  The semantic
operating point is cut to 2 Adam steps in both packages to keep the run
short.

The CSVs must carry the JAX CLI's columns in its order and its rows: equal
strings, integers and decisions, and scores and SI-SNRs within 1e-3
(relative for SI-SNR)."""

import dataclasses
import json
import math

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_same_pngs, tiny_codecs
from nawc_tpu.cli import benchmark as jax_cli
from nawc_tpu.cli import watermark as jax_wm_cli
from nawc_tpu.models import semantic as jax_semantic
from nawc_tpu.utils.checkpoint import save_params
from nawc_tpu_torch.cli import benchmark as cli
from nawc_tpu_torch.cli import watermark as wm_cli
from nawc_tpu_torch.cli.benchmark import _error_only_methods
from nawc_tpu_torch.eval.robustness import read_csv
from nawc_tpu_torch.models import semantic
from nawc_tpu_torch.utils import audio_io

SR = 16_000
CSVS = {"detector": ["detector_checker_results.csv"], "benchmark": ["qwen_benchmark_results.csv"],
        "both": ["combined_results.csv", "threshold_summary.csv"]}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("bench")
    rng = np.random.default_rng(0)
    (root / "ds1").mkdir()
    for i, seconds in enumerate((1.4, 1.1)):
        tt = np.arange(int(SR * seconds)) / SR
        x = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * tt) * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * tt))
        audio_io.write_wav(root / "ds1" / f"clip{i}.wav", x + 0.02 * rng.normal(size=tt.size), SR)
    # the tiny codec's weights keep the latents near the trained codec's
    # range; the random init of --codec_size small grows them to ~100, where
    # the embed's sign-like steps part after the first (test_torch_semantic.py)
    save_params(root / "tiny.msgpack", tiny_codecs()[0].params)
    return root


@pytest.fixture(scope="module")
def two_steps():
    """The semantic operating point with 2 Adam steps, in both packages."""
    mp = pytest.MonkeyPatch()
    for mod in (semantic, jax_semantic):
        mp.setitem(mod._DEFAULT_CFGS, "pca", dataclasses.replace(mod._DEFAULT_CFGS["pca"], steps=2))
    yield
    mp.undo()


def _argv(root, out, mode):
    return ["--mode", mode, "--audio_glob", str(root / "ds1" / "*.wav"), "--filecount", "2",
            "--seconds", "1.0", "--watermarks", "spread_spectrum", "semantic_pca",
            "--attacks", "identity", "gain", "dac", "--codec_size", "small",
            "--codec_ckpt", str(root / "tiny.msgpack"), "--out_dir", str(out)]


@pytest.mark.parametrize("mode", ["detector", "benchmark", "both"])
def test_benchmark_cli_writes_the_jax_csvs(data, two_steps, tmp_path, mode):
    cli.main(_argv(data, tmp_path / "port", mode) + ["--device", "cpu"])
    jax_cli.main(_argv(data, tmp_path / "jax", mode))
    for name in CSVS[mode]:
        want = pd.read_csv(tmp_path / "jax" / name)
        head = (tmp_path / "port" / name).read_text().splitlines()[0]
        assert head == ",".join(want.columns), name
        got = read_csv(tmp_path / "port" / name)
        assert len(got) == len(want) > 0 and not any("error" in r for r in got)
        for g, w in zip(got, want.to_dict("records")):
            for k, v in w.items():
                if isinstance(v, float) and math.isnan(v):
                    assert math.isnan(g[k]), (name, k)
                elif isinstance(v, (bool, np.bool_, str)) or k in ("clip_index",):
                    assert g[k] == v or str(g[k]) == str(v), (name, k, g[k], v)
                elif k.startswith("sisnr"):
                    assert g[k] == pytest.approx(v, rel=1e-3, abs=1e-3), (name, k)
                else:
                    assert g[k] == pytest.approx(v, abs=1e-3), (name, k)
    assert assert_same_pngs(tmp_path) == (["survival_rates.png"] if mode == "benchmark" else [])


def test_benchmark_cli_datasets_and_artifacts(data, two_steps, tmp_path):
    argv = _argv(data, tmp_path, "detector") + ["--device", "cpu", "--data_root", str(data),
                                                "--datasets", "ds1", "--artifacts", "1"]
    cli.main(argv)
    rows = read_csv(tmp_path / "ds1" / "detector_checker_results.csv")
    assert {r["watermark"] for r in rows} == {"spread_spectrum", "semantic_pca"}
    art = tmp_path / "ds1" / "artifacts" / "spread_spectrum_0"
    for f in ("1_original.wav", "2_watermarked.wav", "3_attacked.wav"):
        audio, sr = audio_io.read_wav(art / f)
        assert sr == SR and audio.shape == (1, SR)
    # the JAX CLI's artifact set: the three WAVs and the 6-panel comparison
    assert (art / "comparison.png").stat().st_size > 0


def test_error_only_methods_fail_the_run():
    rows = [{"watermark": "a", "clip_index": -1, "error": "boom"},
            {"watermark": "b", "clip_index": 0, "score": 1.0},
            {"watermark": "b", "clip_index": -1, "error": "one failed attack"}]
    assert _error_only_methods(rows, ["a", "b"]) == ["a"]
    assert _error_only_methods(rows[1:], ["b"]) == []


def test_watermark_cli_embeds_and_detects_as_jax(data, tmp_path, capsys):
    src = str(data / "ds1" / "clip0.wav")
    outs = {}
    for label, main, extra in [("port", wm_cli.main, ["--device", "cpu"]), ("jax", jax_wm_cli.main, [])]:
        out = str(tmp_path / f"{label}.wav")
        main(["embed", "--input", src, "--output", out, "--message", "0xBEEF"] + extra)
        emb = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        main(["detect", "--input", out] + extra)
        det = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        main(["detect", "--input", out, "--sync"] + extra)
        sync = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        outs[label] = (emb, det, sync, audio_io.read_wav(out)[0])
    (e_t, d_t, s_t, a_t), (e_j, d_j, s_j, a_j) = outs["port"], outs["jax"]
    assert e_t["payload"] == e_j["payload"] == "0xbeef" and e_t["sample_rate"] == SR
    np.testing.assert_allclose(a_t, a_j, atol=2 / 32767)  # 16-bit PCM files
    assert d_t == d_j and d_t["payload"] == "0xbeef" and d_t["detected"]
    assert s_t == s_j and "lag_frames" in s_t
    assert wm_cli._msg_bits("0xBEEF", 16).tolist() == jax_wm_cli._msg_bits("0xBEEF", 16).tolist()
    with pytest.raises(SystemExit):
        wm_cli._msg_bits("0101", 16)


def test_watermark_cli_runs_a_codec_latent_method(data, two_steps, tmp_path, capsys):
    src, out = str(data / "ds1" / "clip1.wav"), str(tmp_path / "sem.wav")
    args = ["--method", "semantic_pca", "--codec_size", "small", "--codec_ckpt",
            str(tmp_path / "none"), "--device", "cpu"]
    wm_cli.main(["embed", "--input", src, "--output", out] + args)
    emb = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert emb["payload"] == "(presence-only)" and emb["sample_rate"] == SR
    a, sr = audio_io.read_wav(out)
    assert sr == SR and a.shape == audio_io.read_wav(src)[0].shape
    wm_cli.main(["detect", "--input", out] + args)
    det = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert det["method"] == "semantic_pca" and 0.0 <= det["presence"] <= 1.0 and "payload" not in det
