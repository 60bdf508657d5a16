"""The port's PGD and latent-PCA research CLI against nawc_tpu's on the CPU,
mode by mode, on the data of ``tests/_torch_port.write_cli_data`` (the small
codec with the tiny codec's weights), 2 sign steps, 16 PCA components and a
head of 8.

Each CSV must carry the JAX CLI's columns in its order and its values
within the module's bar: scores 1e-3, SI-SNRs 1e-3 dB, latent metrics 1e-4
and 1e-3 relative (the latents of each package's codec, within the codec
bar of each other).  The sign steps part where a sample's gradient is tiny
and takes the other sign in one package (ROADMAP.md C): 0.07% of the
samples here, by 2 lr, which moves a score by under 1e-3, an SI-SNR by
under 0.05 dB and the head/tail energies of the attacked audio's latent
change by under 0.5%."""

import pytest

from _torch_port import assert_csv_close, assert_same_pngs, cli_common, jax_tiny_codec, run_both, write_cli_data
from nawc_tpu.cli import pgd as jax_pgd
from nawc_tpu_torch.cli import pgd


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return write_cli_data(tmp_path_factory.mktemp("pgd_cli"))


@pytest.fixture(scope="module", autouse=True)
def jax_codec():
    with jax_tiny_codec():
        yield


# (tol, rel) per CSV; the sign steps' SI-SNRs within 0.05 dB
SNR = {"snr_db": (0.05, 0.0)}
PGD_CSVS = {
    "attack": {"pgd_attack.csv": (1e-3, 0.0, SNR)},
    "baselines": {"attack_baselines.csv": (1e-3, 0.0, SNR)},
    "exp_a": {"exp_a_metrics.csv": (1e-4, 1e-3, None), "exp_a_cumvar.csv": (1e-4, 1e-3, None)},
    "exp_b": {"exp_b_reconstruction.csv": (1e-3, 0.0, None)},
    "exp_c": {"exp_c_comparison.csv": (1e-3, 0.0, SNR)},
    "interp": {"pgd_interpretability.csv": (1e-4, 5e-3, None)},
}


@pytest.mark.parametrize("mode", list(PGD_CSVS))
def test_pgd_cli_matches_jax(data, tmp_path, mode):
    argv = cli_common(data) + ["--mode", mode, "--steps", "2", "--pca_components", "16", "--head_k", "8"]
    run_both(pgd.main, jax_pgd.main, argv, tmp_path)
    for name, (tol, rel, cols) in PGD_CSVS[mode].items():
        assert_csv_close(tmp_path, name, tol, rel, cols)
    pngs = {"baselines": ["benchmark_chart.png"], "exp_c": ["experiment_c_results.png"]}
    assert assert_same_pngs(tmp_path) == pngs.get(mode, [])
