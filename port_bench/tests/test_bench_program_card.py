"""The program's spans share the profiler's clock on the card: every launch
of a Snake, sswm or lookup kernel in a profiled window of pipeline calls
lies inside the host interval of the span that launches it, as the
program's snapshot records it, and every such kernel runs inside that
span's place on the device's timeline as ``port_bench/program.py`` finds
it.  ``python -m pytest -m cuda port_bench/tests/test_bench_program_card.py``
from the root of a checkout, on a machine with a card; skips without one."""

import json
import time

import pytest

from port_bench import harness, inputs, program

SEED = 2**31 + 23
OWNERS = {"snake_": ("codec.encode", "codec.decode"), "sswm_": ("ss.detect",),
          "nearest_codebook": ("codec.quantize",)}


@pytest.mark.cuda
def test_kernels_lie_inside_the_spans_that_launch_them(tmp_path):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    from nawc_tpu_torch.entry import entry
    from nawc_tpu_torch.utils import profiling
    from port_bench.weights import make_codec

    bench = harness.benchmark()
    cfg = harness.load_json(harness.cell_files(bench, harness.cell(bench, "roundtrip-f32"))["config"])
    dev = torch.device("cuda", 0)
    harness.program_float32()
    codec, _ = make_codec(cfg["codec"], SEED, dev)
    fn, _ = entry(codec, dev)
    r = inputs.rng(SEED, "card clock")
    wav = torch.from_numpy(inputs.speech_clips(r, 4, 48_000, 24_000)).to(dev)
    msg = torch.from_numpy(inputs.messages(r, 4, cfg["watermark"]["n_bits"])).to(dev)
    fn(wav, msg)
    torch.cuda.synchronize()
    profiling.snapshot()
    with profiling.trace(tmp_path):
        torch.cuda.synchronize()
        time.sleep(0.1)  # the profiler may lose a window's first records
        for _ in range(3):
            fn(wav, msg)
    data = json.loads((tmp_path / "trace.json").read_text())
    spans = json.loads((tmp_path / "spans.json").read_text())["spans"]
    base = data["baseTimeNanoseconds"]
    assert base == spans[0]["start_ns"] // program.TRIMONTH_NS * program.TRIMONTH_NS
    assert sum(s["name"] == "entry.call" for s in spans) == 3
    events = data["traceEvents"]
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    launches = [(kernels[e["args"]["correlation"]], e["ts"] * 1000 + base) for e in events
                if e.get("cat") == "cuda_runtime" and e.get("args", {}).get("correlation") in kernels]
    zero_ns = program._device_clock([s for s in spans if s["device_start_ms"] is not None])
    for mark, owners in OWNERS.items():
        mine = [(k, t) for k, t in launches if mark in k["name"]]
        assert mine, mark
        own = [s for s in spans if s["name"] in owners]
        for k, launched_ns in mine:
            assert any(s["start_ns"] <= launched_ns <= s["end_ns"] for s in own), (mark, launched_ns)
            at_ms = (k["ts"] * 1000 + base - zero_ns) / 1e6
            assert any(s["device_start_ms"] <= at_ms <= s["device_start_ms"] + s["device_ms"]
                       for s in own), (mark, at_ms)
