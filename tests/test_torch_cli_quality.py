"""The port's quality and sample_data CLIs against nawc_tpu's on the CPU:
``python -m nawc_tpu_torch.cli quality --device cpu`` in its three modes
(``--results_dir`` over an artifact tree, ``--watermark spread_spectrum``
with a padded embed sub-batch, ``--summarize_dir``) against
``nawc_tpu.cli.quality``'s CSVs, with the bars of
``tests/test_torch_quality.py``; and ``sample_data``'s tree against
JAX's."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from _torch_port import speech
from nawc_tpu.cli import quality as jax_quality
from nawc_tpu.cli import sample_data as jax_sample_data
from nawc_tpu_torch.cli import sample_data
from nawc_tpu_torch.cli.quality import summarize_quality_dir
from nawc_tpu_torch.eval.reporting import save_artifacts
from nawc_tpu_torch.utils import audio_io

REPO = Path(__file__).resolve().parent.parent
BARS = {"si_snr_clean": 1e-3, "si_snr_watermarked": 1e-3, "delta_si_snr": 1e-3, "snr": 1e-3,
        "lsd": 1e-4, "lsd_native": 1e-4, "stoi_dev": 1e-4, "stoi": 1e-4, "pesq": 1e-3,
        "si_snr_wm_db": 1e-3, "snr_db": 1e-3, "lsd_native_sr": 1e-4}


def port_cli(*argv: str) -> str:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-m", "nawc_tpu_torch.cli", "quality", "--device", "cpu",
                           *argv], cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def assert_csv_matches(got_path: Path, want_path: Path, exact: bool = False) -> None:
    got, want = pd.read_csv(got_path), pd.read_csv(want_path)
    assert list(got.columns) == list(want.columns)
    assert got.shape == want.shape
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if not pd.api.types.is_numeric_dtype(want[col]):
            assert (g == w).all(), col
        else:
            tol = 1e-12 if exact or col not in BARS else BARS[col]
            both_nan = np.isnan(g.astype(np.float64)) & np.isnan(w.astype(np.float64))
            assert (both_nan | (np.abs(g - w) <= tol)).all(), (col, g, w)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """Three speech-like wavs of 1 s at 16 kHz, and an artifact tree of two
    clips (original, marked by a quiet tone and noise, attacked)."""
    root = tmp_path_factory.mktemp("quality")
    clips = speech(16_000, 3, 1.0, seed=21)
    for i, c in enumerate(clips):
        audio_io.write_wav(root / "wav" / f"clip{i}.wav", c, 16_000)
    rng = np.random.default_rng(2)
    for i in range(2):
        marked = clips[i] + 0.004 * rng.standard_normal(clips[i].shape).astype(np.float32)
        save_artifacts(root / "tree", f"clip_{i}", clips[i], marked, 0.8 * marked, 16_000)
    return root


def test_results_dir_mode_matches_jax(cli_data, tmp_path):
    out = port_cli("--results_dir", str(cli_data / "tree"), "--out_csv",
                   str(tmp_path / "port" / "tree_quality_results.csv"))
    jax_quality.main(["--results_dir", str(cli_data / "tree"), "--out_csv",
                      str(tmp_path / "jax" / "tree_quality_results.csv")])
    assert_csv_matches(tmp_path / "port" / "tree_quality_results.csv",
                       tmp_path / "jax" / "tree_quality_results.csv")
    assert "pesq" in out and "stoi_dev" in out


def test_watermark_and_summarize_modes_match_jax(cli_data, tmp_path):
    """Three clips embedded in sub-batches of 2 (the last one padded by
    repeating its clip), then the summary of the directory."""
    argv = ["--watermark", "spread_spectrum", "--audio_glob", str(cli_data / "wav" / "*.wav"),
            "--filecount", "3", "--seconds", "1.0", "--embed_batch", "2"]
    name = "spread_spectrum_quality_results.csv"
    port_cli(*argv, "--out_csv", str(tmp_path / "port" / name))
    jax_quality.main(argv + ["--out_csv", str(tmp_path / "jax" / name)])
    assert_csv_matches(tmp_path / "port" / name, tmp_path / "jax" / name)
    rows = pd.read_csv(tmp_path / "port" / name)
    assert list(rows["clean"]) == ["clip_0", "clip_1", "clip_2"] and (rows["si_snr_watermarked"] > 15).all()

    out = port_cli("--summarize_dir", str(tmp_path / "port"))
    jax_quality.summarize_quality_dir(str(tmp_path / "jax"))
    assert_csv_matches(tmp_path / "port" / "quality_summary.csv", tmp_path / "jax" / "quality_summary.csv")
    assert "pesq_impl: proxy" in out


def test_summary_of_jax_tables_is_jaxs(tmp_path, capsys):
    """``tests/test_quality_files.py``'s two-method table with an empty PESQ
    column, summarised by both CLIs: equal within 1e-12."""
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
        for name, si in [("AudioSeal", 26.4), ("SilentCipher", 48.7)]:
            pd.DataFrame({
                "si_snr_watermarked": [si, si + 1.0], "snr": [si, si], "lsd": [9.0, 9.2],
                "stoi": [0.99, 0.999], "pesq": [float("nan")] * 2,
            }).to_csv(tmp_path / d / f"{name}_quality_results.csv", index=False)
    summarize_quality_dir(str(tmp_path / "port"))
    jax_quality.summarize_quality_dir(str(tmp_path / "jax"))
    assert_csv_matches(tmp_path / "port" / "quality_summary.csv", tmp_path / "jax" / "quality_summary.csv",
                       exact=True)
    out = pd.read_csv(tmp_path / "port" / "quality_summary.csv")
    assert list(out["method"]) == ["AudioSeal", "SilentCipher"] and out["pesq"].isna().all()
    np.testing.assert_allclose(out["si_snr_wm_db"], [26.9, 49.2])


def test_summarize_of_an_empty_dir_exits(tmp_path):
    with pytest.raises(SystemExit, match="no \\*_quality_results.csv"):
        summarize_quality_dir(str(tmp_path))


@pytest.mark.parametrize("zip_", [False, True])
def test_sample_data_tree_matches_jax(tmp_path, zip_):
    src = tmp_path / "src"
    for ds, n in (("LibriSpeech", 3), ("MUSDB", 1)):
        for i in range(n):
            audio_io.write_wav(src / ds / f"f{i}.wav", speech(8_000, 1, 0.1, seed=i)[0], 8_000)
    (src / "README.txt").write_text("not a dataset")
    for mod, d in ((sample_data, "port"), (jax_sample_data, "jax")):
        mod.main(["--src", str(src), "--count", "2", "--out", str(tmp_path / d)] + ["--zip"] * zip_)
    files = {d: sorted(p.relative_to(tmp_path / d) for p in (tmp_path / d).rglob("*")) for d in ("port", "jax")}
    assert files["port"] == files["jax"] and len([f for f in files["port"] if f.suffix == ".wav"]) == 3
    for f in files["port"]:
        if (tmp_path / "port" / f).is_file():
            assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()
    assert (tmp_path / "port.zip").exists() == (tmp_path / "jax.zip").exists() == zip_
