"""The port's interpretability CLIs against nawc_tpu's on the CPU: probe
(in process, and spawned by ``preflight_probe`` and the benchmark CLI's
``--probe``), perturbation, uncertainty, ablation, manifold and stats
(the PGD CLI's six modes: ``tests/test_torch_cli_pgd.py``); and the
dispatcher, which refuses none of the JAX dispatcher's commands now.

The data of ``tests/_torch_port.write_cli_data`` (two wavs and the small
codec with the tiny codec's weights), and the semantic operating point cut
to 2 Adam steps in both packages.  The JAX CLIs get the tiny codec's
CodecState in place of their ``load_codec`` (``jax_tiny_codec``).  Each CSV
must carry the JAX CLI's columns in its order, and its values within the
module's bar: the spectral footprint 1e-4, scores and projections 1e-3.
The stats CLI is held against JAX's pandas output on the same pipe- or
comma-delimited table, cell for cell."""

import dataclasses
import math
import re
import sys

import numpy as np
import pandas as pd
import pytest

from _torch_port import (assert_csv_close, assert_same_figures, assert_same_pngs, cli_common, drawn,
                         jax_tiny_codec, run_both, write_cli_data)
from nawc_tpu.cli import ablation as jax_ablation
from nawc_tpu.cli import manifold as jax_manifold
from nawc_tpu.cli import perturbation as jax_perturbation
from nawc_tpu.cli import probe as jax_probe
from nawc_tpu.cli import stats as jax_stats
from nawc_tpu.cli import uncertainty as jax_uncertainty
from nawc_tpu.models import semantic as jax_semantic
from nawc_tpu_torch.cli import __main__ as dispatcher
from nawc_tpu_torch.cli import ablation, benchmark, manifold, perturbation, probe, stats, uncertainty
from nawc_tpu_torch.cli.common import preflight_probe
from nawc_tpu_torch.models import semantic



@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_cli_data(tmp_path_factory.mktemp("interp_cli"))


@pytest.fixture(scope="module", autouse=True)
def jax_codec():
    with jax_tiny_codec():
        yield


@pytest.fixture(scope="module")
def two_steps():
    """The semantic PCA operating point with 2 Adam steps, in both packages."""
    mp = pytest.MonkeyPatch()
    for mod in (semantic, jax_semantic):
        mp.setitem(mod._DEFAULT_CFGS, "pca", dataclasses.replace(mod._DEFAULT_CFGS["pca"], steps=2))
    yield
    mp.undo()


@pytest.mark.parametrize("wm", ["spread_spectrum", "semantic_pca"])
def test_probe_cli_matches_jax(data, two_steps, capsys, wm):
    argv = ["--watermark", wm] + cli_common(data)
    probe.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    jax_probe.main(argv)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    pat = re.compile(r"probe ok (\S+) n=(\d+) presence=(\S+)")
    g, w = pat.fullmatch(got), pat.fullmatch(want)
    assert g and w, (got, want)
    assert g.group(1, 2) == w.group(1, 2) == (wm, "2")
    assert abs(float(g.group(3)) - float(w.group(3))) <= 1e-3


def test_benchmark_probe_spawns_the_port_probe(data, tmp_path, capsys):
    """--probe runs ``python -m nawc_tpu_torch.cli.probe`` on the run's clips
    before the stage; a probe that fails ends the run."""
    benchmark.main(["--probe", "--mode", "detector", "--watermarks", "spread_spectrum",
                    "--attacks", "identity", "--out_dir", str(tmp_path), "--device", "cpu"]
                   + cli_common(data))
    out = capsys.readouterr().out
    assert re.search(r"\[probe\] probe ok spread_spectrum n=2 presence=\S+", out), out
    assert (tmp_path / "detector_checker_results.csv").exists()
    with pytest.raises(SystemExit, match="preflight FAILED"):
        preflight_probe(["spread_spectrum"], audio_glob=str(data / "none" / "*.wav"), device="cpu")


def test_perturbation_cli_matches_jax(data, tmp_path):
    run_both(perturbation.main, jax_perturbation.main, cli_common(data), tmp_path)
    assert_csv_close(tmp_path, "perturbation_analysis.csv", 1e-10, rel=1e-4)
    assert len(pd.read_csv(tmp_path / "port" / "perturbation_analysis.csv").columns) == 2 + 16
    assert assert_same_pngs(tmp_path) == ["snr_histogram.png", "spectral_footprint.png"]


def test_uncertainty_cli_matches_jax(data, tmp_path, capsys):
    argv = cli_common(data) + ["--mc_samples", "3"]
    uncertainty.main(argv + ["--out_dir", str(tmp_path / "port"), "--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    jax_uncertainty.main(argv + ["--out_dir", str(tmp_path / "jax")])
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert_csv_close(tmp_path, "uncertainty_results.csv", 1e-3)
    assert_csv_close(tmp_path, "reliability_curve.csv", 1e-3)
    assert assert_same_pngs(tmp_path) == ["mc_var_prob_correct_vs_wrong_hist.png", "mc_var_prob_roc.png",
                                          "reliability_curve_mc_mean_prob.png", "variance_boxplots.png"]
    nums = [re.findall(r"(\w+)=(\S+)", s) for s in (got, want)]
    assert [k for k, _ in nums[0]] == [k for k, _ in nums[1]] == ["accuracy", "var_error_auc", "ece"]
    for (_, g), (_, w) in zip(*nums):
        assert (g == w == "nan") or abs(float(g) - float(w)) <= 1e-3


def test_ablation_cli_matches_jax(data, tmp_path):
    argv = cli_common(data) + ["--watermarks", "spread_spectrum", "chunked"]
    run_both(ablation.main, jax_ablation.main, argv, tmp_path)
    assert_csv_close(tmp_path, "layer_ablation.csv", 1e-3)
    assert len(pd.read_csv(tmp_path / "port" / "layer_ablation.csv")) == 2 * 6 * 2
    assert assert_same_pngs(tmp_path) == ["ablation_heatmap.png", "snac_layer_ablation_chunked.png",
                                          "snac_layer_ablation_spread_spectrum.png"]


def test_manifold_cli_matches_jax(data, two_steps, tmp_path):
    argv = cli_common(data) + ["--watermarks", "spread_spectrum", "semantic_pca"]
    run_both(manifold.main, jax_manifold.main, argv, tmp_path)
    assert_csv_close(tmp_path, "manifold_analysis.csv", 1e-3)
    assert assert_same_pngs(tmp_path) == sorted(
        [f"manifold_global_{k}_all.png" for k in ("3d", "delta", "delta_bar")]
        + [f"plots/{w}/clip_{i}_proj_{w}.png" for w in ("semantic_pca", "spread_spectrum") for i in range(2)])


def _write_table(path, sep: str) -> None:
    """A results table with every kind of column pandas types: ints,
    floats, NaN cells, booleans, strings with and without empty cells, a
    column of numbers and text, and tied correlations."""
    rng = np.random.default_rng(7)
    lines = [sep.join(["attack_type", "clip_index", "bitwise/distorted", "sisnr", "sisnr_copy",
                       "k", "flag", "note", "mixed", "blank"])]
    for i in range(24):
        x = rng.normal()
        lines.append(sep.join([
            ["mp3", "noise", "gain"][i % 3], str(i), repr(float(0.5 + 0.1 * x)),
            "" if i == 5 else repr(float(20 + 3 * x + rng.normal())),
            "" if i == 5 else repr(float(20 + 3 * x + rng.normal())) if i % 2 else "1.5",
            str(int(rng.integers(0, 3))), "True" if i % 2 else "False",
            "" if i % 4 == 0 else "ok", "3" if i % 5 else "n/a?", ""]))
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("sep", ["|", ","])
def test_stats_cli_matches_jax_pandas(tmp_path, sep, capsys):
    table = tmp_path / "test_results.csv"
    _write_table(table, sep)
    argv = ["--results", str(table)]
    with drawn(tmp_path / "port") as got_fig:
        stats.main(argv + ["--out_dir", str(tmp_path / "port")])
    with drawn(tmp_path / "jax") as want_fig:
        jax_stats.main(argv + ["--out_dir", str(tmp_path / "jax")])
    assert assert_same_pngs(tmp_path) == ["feature_importance.png"]
    assert_same_figures(got_fig, want_fig)
    for name in ("stats_by_group.csv", "overall_stats.csv", "feature_importance.csv"):
        got, want = (pd.read_csv(tmp_path / s / name) for s in ("port", "jax"))
        assert list(got.columns) == list(want.columns), name
        pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=1e-12, atol=1e-12)
    rows = stats.load_table(str(table))
    df = jax_stats.load_table(str(table))
    assert list(rows[0]) == list(df.columns)
    for col in df.columns:
        for g, w in zip((r[col] for r in rows), df[col]):
            # pandas' default float parser may round a decimal 1 ulp off; the
            # port's is correctly rounded
            assert (isinstance(w, float) and math.isnan(w) and math.isnan(g)) or g == w or \
                math.isclose(g, w, rel_tol=2.0**-52), (col, g, w)
            assert isinstance(g, bool) == isinstance(w, (bool, np.bool_)), (col, g, w)


def test_dispatcher_refuses_only_quality_and_sample_data(monkeypatch, capsys):
    """Since the quality slice the dispatcher refuses none of the JAX
    dispatcher's commands: each one runs (here its --help), and only an
    unknown command exits non-zero with the usage."""
    from nawc_tpu.cli import __main__ as jax_dispatcher

    assert set(jax_dispatcher.COMMANDS) <= set(dispatcher.COMMANDS)
    assert not hasattr(dispatcher, "QUEUED")
    monkeypatch.setattr(sys, "argv", ["nawc_tpu_torch.cli", "no_such_command"])
    with pytest.raises(SystemExit) as exc:
        dispatcher.main()
    assert exc.value.code == 1 and "usage" in capsys.readouterr().out
    for cmd in ("quality", "sample_data", "probe", "perturbation", "uncertainty", "ablation",
                "manifold", "pgd", "stats"):
        assert cmd in dispatcher.COMMANDS
        monkeypatch.setattr(sys, "argv", ["nawc_tpu_torch.cli", cmd, "--help"])
        with pytest.raises(SystemExit) as exc:
            dispatcher.main()
        assert exc.value.code == 0
        assert "usage" in capsys.readouterr().out
