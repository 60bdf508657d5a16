"""Each cell once on the card, for a few seconds, as the benchmark's command
runs it (``python -m pytest -m cuda port_bench/tests/test_bench_card.py``
from the root of a checkout, on a machine with a card).  Skips without a
card."""

import json
import subprocess
import sys

import pytest

from port_bench import harness


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in harness.benchmark()["workloads"]])
def test_cell_once_on_the_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the cells run only on the card")
    bench = harness.benchmark()
    for trace in (0, 1):
        out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", workload,
                              "--seed", str(2**31 + 17), "--seconds", "3", "--trace", str(trace)],
                             cwd=harness.ROOT, capture_output=True, text=True, timeout=360)
        assert out.returncode == 0, out.stderr[-4000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"], line["checks"]
        assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
        kind = "per_layer" if trace else "end_to_end"
        want = {m["name"] for m in harness.metrics_for(bench, workload, kind)}
        assert set(line["metrics"]) <= want and line["metrics"]
        if not trace:
            assert set(line["metrics"]) == want
        else:
            assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
