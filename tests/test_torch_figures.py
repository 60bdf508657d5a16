"""The port's figures (``nawc_tpu_torch.eval.figures`` and the plots of
``eval.reporting``) against nawc_tpu's on the CPU: the same seeded numpy
inputs go to JAX as a DataFrame and to the port as row dicts, and both
draw with matplotlib's Agg backend.  Recorded at ``Figure.savefig``
(``_torch_port.drawn``): the same files, titles, axis, tick, legend and
annotation texts equal, the data of lines, bars, histogram bins, scatter
points and images within 1e-6; the returned ROC AUC within 1e-12.  The
tables' row order is shuffled and holds NaN scores and missing cells, so
that the groups, pivots and means must come out as pandas' do.  Without
matplotlib a CLI still writes its CSVs and names the PNGs it did not
draw."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from _torch_port import assert_same_figures, drawn, write_cli_data
from nawc_tpu.eval import figures as jfig
from nawc_tpu.eval import reporting as jrep
from nawc_tpu_torch.eval import figures as tfig
from nawc_tpu_torch.eval import reporting as trep

REPO = Path(__file__).resolve().parent.parent
WMS = ["spread_spectrum", "chunked", "semantic_pca"]
MASKS = ["full_all", "drop_last_1", "drop_last_2", "keep_only_0", "keep_only_1", "keep_only_2"]


def _both(tmp_path, port, jax) -> tuple[list, list]:
    """`port(dir)` and `jax(dir)` into their own directories -> their
    recordings, after checking that every file is a non-empty PNG."""
    out = []
    for name, fn in (("port", port), ("jax", jax)):
        d = tmp_path / name
        with drawn(d) as rec:
            fn(d)
        for path, _ in rec:
            assert (d / path).stat().st_size > 0 and (d / path).read_bytes()[:4] == b"\x89PNG"
        out.append(rec)
    return out[0], out[1]


def _shuffled(rows, seed):
    return [rows[i] for i in np.random.default_rng(seed).permutation(len(rows))]


def test_available_sees_matplotlib():
    assert tfig.available()


def test_manifold_global(tmp_path):
    rng = np.random.default_rng(0)
    rows = _shuffled([{"watermark": w, "clip": i, **{c: float(rng.normal()) for c in (
        "clean_proj_mean", "wm_proj_mean", "att_proj_mean", "delta_wm", "delta_att")}}
        for w in WMS for i in range(5)], 1)
    got_paths = []
    got, want = _both(tmp_path, lambda d: got_paths.extend(tfig.plot_manifold_global(rows, d)),
                      lambda d: jfig.plot_manifold_global(pd.DataFrame(rows), d))
    assert_same_figures(got, want)
    assert [p.name for p in got_paths] == [p.name for p in tfig.manifold_global_paths(tmp_path)]


def test_proj_triplet(tmp_path):
    rng = np.random.default_rng(1)
    sigs = [rng.normal(size=40).astype(np.float32) for _ in range(3)]
    got, want = _both(tmp_path, lambda d: tfig.plot_proj_triplet(d / "a" / "clip_0.png", *sigs, "chunked"),
                      lambda d: jfig.plot_proj_triplet(d / "a" / "clip_0.png", *sigs, "chunked"))
    assert_same_figures(got, want)


def test_order_masks():
    masks = _shuffled(MASKS + ["drop_last_10", "other"], 2)
    assert tfig._order_masks(masks) == jfig._order_masks(masks)


def test_ablation_per_wm_bars(tmp_path):
    rng = np.random.default_rng(3)
    rows = [{"mask": m, "watermark": w, "clip": i, "score": float(rng.uniform())}
            for w in WMS[:2] for m in MASKS for i in range(3)]
    rows[4]["score"] = float("nan")
    rows = _shuffled(rows, 4)
    got, want = _both(tmp_path, lambda d: tfig.plot_ablation_per_wm_bars(rows, d),
                      lambda d: jfig.plot_ablation_per_wm_bars(pd.DataFrame(rows), d))
    assert_same_figures(got, want)


@pytest.mark.parametrize("wrong", [True, False])
def test_uncertainty_hist_and_roc(tmp_path, wrong):
    rng = np.random.default_rng(5)
    n = 32
    var = (rng.uniform(size=n) * 1e-3).astype(np.float32)
    correct = (rng.uniform(size=n) < 0.7).astype(np.int32) if wrong else np.ones(n, np.int32)
    rows = [{"mc_mean_prob": np.float32(0.5), "mc_var_prob": var[i], "correct": correct[i]} for i in range(n)]
    aucs = []
    got, want = _both(
        tmp_path,
        lambda d: (tfig.plot_uncertainty_hist(rows, d / "hist.png"),
                   aucs.append(tfig.plot_uncertainty_roc(rows, d / "roc.png"))),
        lambda d: (jfig.plot_uncertainty_hist(pd.DataFrame(rows), d / "hist.png"),
                   aucs.append(jfig.plot_uncertainty_roc(pd.DataFrame(rows), d / "roc.png"))))
    assert_same_figures(got, want)
    assert abs(aucs[0] - aucs[1]) <= 1e-12


def test_reliability_curve(tmp_path):
    prob = np.linspace(0.05, 0.95, 10)
    acc = np.where(np.arange(10) % 3 == 0, np.nan, prob ** 2)
    got, want = _both(tmp_path, lambda d: tfig.plot_reliability_curve(prob, acc, d / "r.png"),
                      lambda d: jfig.plot_reliability_curve(prob, acc, d / "r.png"))
    assert_same_figures(got, want)


def test_snr_histogram_and_spectral_footprint(tmp_path):
    rng = np.random.default_rng(6)
    snr = rng.normal(30, 3, size=23).astype(np.float32)
    band = rng.uniform(size=(23, 16)) * 1e-4
    got, want = _both(
        tmp_path,
        lambda d: (tfig.plot_snr_histogram(snr, d / "snr.png"), tfig.plot_spectral_footprint(band, d / "fp.png")),
        lambda d: (jfig.plot_snr_histogram(snr, d / "snr.png"), jfig.plot_spectral_footprint(band, d / "fp.png")))
    assert_same_figures(got, want)


def test_detection_vs_snr_and_pgd_scatter(tmp_path):
    rng = np.random.default_rng(7)
    rows = [{"attack": a, "score": float(rng.uniform()), "snr_db": float(rng.normal(20, 5))}
            for a in ("clean", "gaussian_noise", "pca_amputation", "pca_jamming", "latent_rounding")]
    per_clip = {m: (rng.normal(25, 3, size=6).astype(np.float32), rng.uniform(size=6).astype(np.float32))
                for m in ("standard_pgd", "subspace_pgd")}
    got, want = _both(
        tmp_path,
        lambda d: (tfig.plot_detection_vs_snr(rows, d / "b.png", title="K=60"),
                   tfig.plot_pgd_scatter(per_clip, d / "c.png")),
        lambda d: (jfig.plot_detection_vs_snr(pd.DataFrame(rows), d / "b.png", title="K=60"),
                   jfig.plot_pgd_scatter(per_clip, d / "c.png")))
    assert_same_figures(got, want)


def test_ablation_heatmap(tmp_path):
    """One (mask, watermark) pair has no row: pandas' pivot holds NaN."""
    rng = np.random.default_rng(8)
    rows = [{"mask": m, "watermark": w, "clip": i, "score": float(rng.uniform())}
            for w in WMS for m in MASKS for i in range(2) if (m, w) != ("keep_only_1", "chunked")]
    rows = _shuffled(rows, 9)
    got, want = _both(tmp_path, lambda d: trep.plot_ablation_heatmap(rows, d / "h.png"),
                      lambda d: jrep.plot_ablation_heatmap(pd.DataFrame(rows), d / "h.png"))
    assert_same_figures(got, want)
    assert "nan" in got[0][1][0]["texts"]


def test_survival_bars(tmp_path):
    """The bar chart of pandas' ``pivot_table(...).plot.bar``: the summary
    rows (clip_index -1) left out, an empty cell drawn as 0."""
    rng = np.random.default_rng(10)
    attacks = ["identity", "gain", "dac", "mp3", "reverb"]
    rows = [{"watermark": w, "attack": a, "clip_index": i, "survived": bool(rng.uniform() < 0.6)}
            for w in WMS for a in attacks for i in (-1, 0, 1, 2) if (w, a) != ("chunked", "dac")]
    rows = _shuffled(rows, 11)
    got, want = _both(tmp_path, lambda d: trep.plot_survival_bars(rows, d / "s.png"),
                      lambda d: jrep.plot_survival_bars(pd.DataFrame(rows), d / "s.png"))
    assert_same_figures(got, want)


@pytest.mark.parametrize("group_col", ["attack_type", "missing"])
def test_variance_and_metric_boxplots(tmp_path, group_col):
    rng = np.random.default_rng(12)
    rows = [{"attack_type": a, "mc_var_prob": float(rng.uniform()) * 1e-3, "sisnr_attack": float(rng.normal(20, 4))}
            for a in ("gain", "dac", "mp3") for _ in range(7)]
    rows[3]["mc_var_prob"] = float("nan")
    rows = _shuffled(rows, 13)
    got, want = _both(
        tmp_path,
        lambda d: (trep.plot_variance_boxplots(rows, d / "v.png", group_col=group_col),
                   trep.plot_metric_boxplots(rows, d / "m.png", group_col=group_col)),
        lambda d: (jrep.plot_variance_boxplots(pd.DataFrame(rows), d / "v.png", group_col=group_col),
                   jrep.plot_metric_boxplots(pd.DataFrame(rows), d / "m.png", group_col=group_col)))
    assert_same_figures(got, want)


def test_save_artifacts_comparison(tmp_path):
    rng = np.random.default_rng(14)
    clips = [(rng.normal(size=16_000) * 0.1).astype(np.float32) for _ in range(3)]
    got, want = _both(tmp_path, lambda d: trep.save_artifacts(d, "clip_0", *clips, 16_000),
                      lambda d: jrep.save_artifacts(d, "clip_0", *clips, 16_000))
    assert_same_figures(got, want)
    assert [n for n, _ in got] == ["clip_0/comparison.png"]
    for name in ("1_original.wav", "2_watermarked.wav", "3_attacked.wav"):
        assert (tmp_path / "port" / "clip_0" / name).read_bytes() == (tmp_path / "jax" / "clip_0" / name).read_bytes()


def test_plots_raise_without_matplotlib(monkeypatch, tmp_path):
    """A direct call raises the ImportError, as JAX's does."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not tfig.available()
    with pytest.raises(ImportError):
        tfig.plot_snr_histogram(np.zeros(4), tmp_path / "x.png")
    assert not list(tmp_path.iterdir())


_REFUSED = r"""
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ImportError(f"import of {name} refused")
        return None
sys.meta_path.insert(0, Refuse())
from nawc_tpu_torch.cli import perturbation
perturbation.main(sys.argv[1:])
assert "matplotlib" not in sys.modules
"""


def test_cli_without_matplotlib_writes_its_csvs_and_names_the_pngs(tmp_path):
    data = write_cli_data(tmp_path / "data")
    out = tmp_path / "out"
    proc = subprocess.run(
        [sys.executable, "-c", _REFUSED, "--audio_glob", str(data / "*.wav"), "--filecount", "2",
         "--seconds", "1.0", "--device", "cpu", "--out_dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (out / "perturbation_analysis.csv").stat().st_size > 0
    assert not list(out.rglob("*.png"))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[figures]")]
    assert len(lines) == 1 and "matplotlib is not installed" in lines[0]
    assert "snr_histogram.png" in lines[0] and "spectral_footprint.png" in lines[0]
