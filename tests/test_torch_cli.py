"""The port's robustness CLI on the CPU: two wavs written with the port's
``audio_io``, the small random codec, the full attack suite.  It writes the
four CSVs with the JAX package's headers, and its rows match nawc_tpu's
``run_robustness`` on the same clips (SI-SNRs within 1e-4 relative, the
bit accuracies and hard decisions equal)."""

import math

import numpy as np
import pandas as pd
import pytest

from nawc_tpu.attacks import build_suite as jax_build_suite
from nawc_tpu.cli.common import build_watermarkers as jax_build_watermarkers
from nawc_tpu.cli.common import load_audio_clips as jax_load_audio_clips
from nawc_tpu.cli.common import load_codec as jax_load_codec
from nawc_tpu.eval import robustness as jrob
from nawc_tpu.utils import audio_io as jax_audio_io
from nawc_tpu_torch.cli import robustness as cli
from nawc_tpu_torch.cli.common import WM_CHOICES, build_watermarkers, load_audio_clips
from nawc_tpu_torch.eval.robustness import read_csv, write_csv
from nawc_tpu_torch.utils import audio_io

SR = 16_000


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    for i, seconds in enumerate((1.4, 2.3)):
        tt = np.arange(int(SR * seconds)) / SR
        x = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * tt) * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * tt))
        audio_io.write_wav(root / f"clip{i}.wav", (x + 0.02 * rng.normal(size=tt.size)), SR)
    out = root / "out"
    argv = ["--audio_glob", str(root / "*.wav"), "--filecount", "2", "--seconds", "2.0",
            "--chunk_seconds", "1.0", "--codec_size", "small", "--codec_ckpt", str(root / "none"),
            "--out_dir", str(out), "--device", "cpu"]
    cli.main(argv)
    return root, out, argv


def test_cli_writes_the_jax_schema_and_rows(run):
    root, out, _ = run
    glob = str(root / "*.wav")
    clips = jax_load_audio_clips(glob, 2, SR, 2.0)
    for a, b in zip(load_audio_clips(glob, 2, SR, 2.0), clips):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)
    codec = jax_load_codec(None, "small")
    wm = jax_build_watermarkers(["spread_spectrum"], codec)["spread_spectrum"]
    suite = jax_build_suite(SR, codec)
    suite.pop("identity")
    df = jrob.run_robustness(wm, suite, clips, SR, 1.0)
    got = read_csv(out / "test_results.csv", sep="|")
    want = df.to_dict("records")
    assert (out / "test_results.csv").read_text().splitlines()[0] == "|".join(df.columns)
    assert len(got) == len(want) == 3 * 20
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if k.startswith("sisnr"):
                assert g[k] == pytest.approx(v, rel=1e-4, abs=1e-3), (k, g, w)
            else:
                assert g[k] == v, (k, g, w)
    for name, table in [("overall_stats", jrob.overall_stats(df)),
                        ("stats_by_attack", jrob.stats_by_attack(df))]:
        assert (out / f"{name}.csv").read_text().splitlines()[0] == ",".join(table.columns)
        ours = pd.read_csv(out / f"{name}.csv").to_dict("records")
        for o, w in zip(ours, table.to_dict("records"), strict=True):
            for k, v in w.items():
                if isinstance(v, float) and math.isnan(v):
                    assert math.isnan(o[k])
                elif not isinstance(v, str):
                    assert o[k] == pytest.approx(v, rel=1e-3, abs=1e-3), (name, k)
    assert sorted(p.stem for p in (out / "shards").glob("*.csv")) == sorted(suite)


def test_cli_resume_reads_the_shards(run, capsys):
    """With --resume the shards on disk are read back, not recomputed: a
    value edited in one shard comes through to test_results.csv."""
    _, out, argv = run
    before = read_csv(out / "test_results.csv", sep="|")
    shard = out / "shards" / "gain.csv"
    rows = read_csv(shard)
    rows[0]["sisnr_attack"] = 123.5
    write_csv(rows, shard)
    cli.main(argv + ["--resume"])
    after = read_csv(out / "test_results.csv", sep="|")
    i = next(i for i, r in enumerate(before) if r["attack_type"] == "gain")
    assert after[i]["sisnr_attack"] == 123.5
    assert after[:i] + after[i + 1:] == before[:i] + before[i + 1:]
    table = capsys.readouterr().out
    assert "attack_type" in table and "bitwise/clean_mean" in table and "vorbis" in table


def test_cli_draws_the_jax_figure(run):
    """The JAX CLI's one PNG, the SI-SNR box plot by attack."""
    _, out, _ = run
    assert sorted(p.name for p in out.rglob("*.png")) == ["sisnr_by_attack.png"]
    assert (out / "sisnr_by_attack.png").stat().st_size > 0


def test_port_refuses_the_families_it_lacks():
    """Every family of the JAX CLI builds (``neural`` from the trained
    checkpoint, the codec-latent ones on a codec, which they require, as in
    the JAX CLI); an unknown name is refused."""
    from _torch_port import tiny_codecs
    from nawc_tpu_torch.models import NeuralWM

    assert set(WM_CHOICES) >= {"spread_spectrum", "chunked", "psychoacoustic", "neural"}
    _, tc = tiny_codecs(seed=1)
    built = build_watermarkers(list(WM_CHOICES), tc, device="cpu")
    assert list(built) == list(WM_CHOICES)
    assert isinstance(built["neural"], NeuralWM)
    for name in ("semantic_pca", "semantic_cluster", "semantic_random", "token_green"):
        with pytest.raises(SystemExit, match="requires"):
            build_watermarkers([name])
    with pytest.raises(SystemExit, match="unknown"):
        build_watermarkers(["nope"])


def test_audio_io_reads_what_jax_reads(tmp_path):
    x = np.random.default_rng(1).uniform(-1, 1, (2, 999)).astype(np.float32)
    audio_io.write_wav(tmp_path / "a.wav", x, 22_050)
    (a, sr), (b, jsr) = audio_io.read_wav(tmp_path / "a.wav"), jax_audio_io.read_wav(tmp_path / "a.wav")
    assert sr == jsr == 22_050
    np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(a, x, atol=2 / 32767)  # 16-bit PCM, truncated on write
