"""The result line: exactly the contract's keys, and no line without a card."""

import math
import subprocess
import sys

from port_bench import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_line_keys(small):
    line = small("roundtrip-f32")
    assert list(line) == KEYS + ["checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    bench = harness.benchmark()
    want = [m["name"] for m in harness.metrics_for(bench, "roundtrip-f32", "end_to_end")]
    assert sorted(line["metrics"]) == sorted(want)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_line_keys(small):
    line = small("roundtrip-f32", trace=True)
    assert list(line) == KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())
    # a CPU run reads no device metric: the device readers find nothing
    assert not {k for k in line["metrics"] if "roofline" in k or "mfu" in k or "idle" in k}


def test_no_line_without_a_card():
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", "roundtrip-f32",
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=600,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(harness.ROOT / "build")})
    assert out.returncode != 0 and out.stdout == ""
