"""CPU tests of the port's benchmark: ``python -m pytest port_bench/tests``.
The test marked ``cuda`` runs each cell once on a card and skips without
one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

# the codec at a test size: every width cut, the structure and strides kept
TINY = {"encoder_dim": 8, "latent_dim": 32, "decoder_dim": 32, "codebook_size": 64}
SMALL_TRAFFIC = {
    "roundtrip_16x4s": {"batch": 2, "seconds": 0.5, "pool_batches": 2},
    "latent_embed_32x2s": {"batch": 2, "seconds": 0.5, "pool_batches": 1},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (the CUDA kernels of nawc_tpu_torch); "
        "such a test skips without one")


@pytest.fixture
def small():
    """-> run(workload, seed=..., trace=False, mode="bench", seconds=...,
    steps=None) that runs a cell once on the CPU at the test size and
    returns its result line."""
    import time

    import torch

    from port_bench import harness
    from port_bench import run as bench_run

    bench = harness.benchmark()

    def run(workload, seed=2**31 + 7, trace=False, mode="bench", seconds=0.3, steps=None):
        cell = harness.cell(bench, workload)
        files = harness.cell_files(bench, cell)
        cfg = harness.load_json(files["config"])
        cfg["codec"].update(TINY)
        if steps is not None:  # the embed's Adam steps a call
            cfg["semantic"]["steps"] = steps
        tr = harness.load_json(files["traffic"])
        tr.update(SMALL_TRAFFIC[cell["traffic"]])
        return bench_run.execute(bench, workload, seed, seconds, trace, torch.device("cpu"),
                                 time.perf_counter(), config=cfg, traffic=tr, mode=mode)

    return run
