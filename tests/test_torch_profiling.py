"""The port's span and counter recorder (``utils/profiling.py``: spans,
counters, the trace file and its snapshot) on the CPU, and the public names
that complete the port's API, against nawc_tpu's."""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY  # (also caps torch threads)
import nawc_tpu.models as jax_models
import nawc_tpu.utils as jax_utils
from nawc_tpu.models.neural import decode_bits as jax_decode_bits
from nawc_tpu.utils import padding as jpad
from nawc_tpu_torch.models import neural
from nawc_tpu_torch.utils import padding, profiling


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("quality_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "quality_stage" in names and any("mm" in str(n) for n in names)


@pytest.fixture
def recorder():
    """The recorder, cleared and off before and after the test."""
    profiling.disable()
    profiling.snapshot()
    yield profiling
    profiling.disable()
    profiling.snapshot()


def test_nested_spans_carry_parent_and_root(recorder):
    recorder.enable()
    with recorder.annotate("call"):
        with recorder.annotate("stage"):
            with recorder.annotate("leaf"):
                pass
        with recorder.annotate("stage2"):
            pass
    with recorder.annotate("next_call"):
        pass
    spans = {s["name"]: s for s in recorder.snapshot()["spans"]}
    call = spans["call"]
    assert call["parent"] is None and call["root"] == call["id"]
    assert spans["stage"]["parent"] == call["id"] and spans["stage2"]["parent"] == call["id"]
    assert spans["leaf"]["parent"] == spans["stage"]["id"]
    assert {spans[n]["root"] for n in ("stage", "leaf", "stage2")} == {call["id"]}
    assert spans["next_call"]["parent"] is None and spans["next_call"]["root"] != call["id"]
    assert call["start_ns"] <= spans["stage"]["start_ns"] <= spans["leaf"]["end_ns"] <= call["end_ns"]
    assert all(s["device_ms"] is None for s in spans.values())  # no CUDA device: host times only
    assert recorder.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_threads_keep_their_own_parents(recorder):
    recorder.enable()
    inner = {}

    def worker():
        with recorder.annotate("thread_root") as span:
            inner["id"] = span.id

    with recorder.annotate("main_root"):
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
    assert not th.is_alive()
    spans = {s["name"]: s for s in recorder.snapshot()["spans"]}
    assert spans["thread_root"]["parent"] is None and spans["thread_root"]["id"] == inner["id"]


def _tiny_entry():
    """-> (fn, args, the watermarker fn embeds with), with a tiny codec."""
    from nawc_tpu_torch.codec import make_codec
    from nawc_tpu_torch.entry import entry, flagship
    from nawc_tpu_torch.utils.config import CodecConfig

    codec = make_codec(CodecConfig(**TINY), device="cpu", seed=3)
    fn, args = entry(codec=codec, device="cpu")
    return fn, args, flagship(codec, "cpu")[1]


def test_off_records_nothing_and_touches_no_profiler(recorder, monkeypatch):
    fn, args, _ = _tiny_entry()

    def refuse(*a, **k):
        raise AssertionError("the recorder is off")

    monkeypatch.setattr(profiling, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not recorder.recording()
    fn(*args)
    assert recorder.snapshot() == {"spans": [], "counters": {}, "dropped": 0}


def test_span_start_lies_on_the_profilers_clock(recorder, tmp_path):
    with recorder.trace(tmp_path / "trace"):
        with recorder.annotate("clock_probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    ev = next(e for e in data["traceEvents"] if e.get("name") == "clock_probe" and e.get("ph") == "X")
    span = next(s for s in json.loads((tmp_path / "trace" / "spans.json").read_text())["spans"]
                if s["name"] == "clock_probe")
    assert abs(ev["ts"] * 1000 + data["baseTimeNanoseconds"] - span["start_ns"]) < 2e6
    # the profiler turned the recording on, and the exporter's snapshot cleared it
    assert not recorder.recording() and recorder.snapshot()["spans"] == []


def test_span_cap_drops_the_oldest(recorder):
    recorder.enable()
    extra = 5
    for i in range(recorder.MAX_SPANS + extra):
        with recorder.annotate(f"s{i}"):
            pass
    snap = recorder.snapshot()
    assert snap["dropped"] == extra and len(snap["spans"]) == recorder.MAX_SPANS
    assert snap["spans"][0]["name"] == f"s{extra}"
    assert snap["spans"][-1]["name"] == f"s{recorder.MAX_SPANS + extra - 1}"


def test_span_is_kept_only_if_recording_at_both_ends(recorder):
    recorder.enable()
    with recorder.annotate("cut"):
        recorder.disable()
    recorder.enable()
    with recorder.annotate("whole"):
        pass
    assert [s["name"] for s in recorder.snapshot()["spans"]] == ["whole"]


def test_pipeline_call_counts_its_host_to_device_bytes(recorder):
    from nawc_tpu_torch.models.spread_spectrum import _pn_patterns_np

    fn, args, wm = _tiny_entry()
    recorder.enable()
    fn(*args)
    counters = recorder.snapshot()["counters"]
    tables = 2 * _pn_patterns_np(wm.seed, wm.cfg).nbytes  # embed's and detect's pattern tables
    windows = 2 * wm.n_passes + 1  # each embed pass's stft and istft, detect's stft
    assert counters["copy.h2d"] == 2 + windows
    assert counters["copy.h2d_bytes"] == tables + windows * wm.cfg.n_fft * 4


@pytest.mark.parametrize("prefix,kind", [("launches.", "always"), ("tables.built.", "always"),
                                         ("copy.", "recorded")])
def test_counters_count_while_recording_or_always(recorder, prefix, kind):
    counter = prefix + "probe"
    recorder.count(counter, 3)
    assert recorder.snapshot()["counters"] == {}
    recorder.enable()
    recorder.count(counter, 2)
    assert recorder.snapshot()["counters"] == {counter: 2}
    assert recorder.total(counter) == (5 if kind == "always" else 0)
    recorder.reset(prefix)
    assert recorder.total(counter) == 0


def test_launch_counts_agree_and_reset_together(recorder, monkeypatch):
    from nawc_tpu_torch.ops import _lib

    kernel = _lib.CudaKernel("probe_kernel", "probe_kernel", [])
    kernel._fn = lambda *a: 0  # a launch accepted by the runtime, without a card
    monkeypatch.setitem(_lib.KERNELS, kernel.name, kernel)
    kernel()
    recorder.enable()
    kernel()
    kernel()
    assert _lib.KERNELS["probe_kernel"].launches == 3
    recorder.disable()
    kernel()
    recorder.enable()
    assert recorder.snapshot()["counters"] == {"launches.probe_kernel": 2}
    kernel()
    _lib.reset_launches()
    assert kernel.launches == 0 and recorder.snapshot()["counters"] == {}


def test_table_build_is_counted_on_a_miss(recorder):
    from nawc_tpu_torch.ops import _lib

    owner = torch.nn.Linear(2, 2)
    recorder.enable()
    for _ in range(3):
        _lib.derived(owner, "probe_table", [owner.weight], lambda: owner.weight * 2)
    with torch.no_grad():
        owner.weight.add_(1.0)
    _lib.derived(owner, "probe_table", [owner.weight], lambda: owner.weight * 2)
    assert recorder.snapshot()["counters"] == {"tables.built.probe_table": 2}
    recorder.reset("tables.built.probe_table")


@pytest.mark.parametrize("lengths,max_len", [([3, 0, 7], 7), ([5, 2], 9)])
def test_length_mask_matches(lengths, max_len):
    got = padding.length_mask(torch.tensor(lengths), max_len)
    want = jpad.length_mask(jnp.asarray(lengths), max_len)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(50,), (2, 50), (50, 2), (3, 4), (9, 20)])
def test_ensure_mono_np_matches(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(padding.ensure_mono_np(x), jpad.ensure_mono_np(x))


def test_ensure_mono_np_rejects_3d():
    with pytest.raises(ValueError, match="unsupported"):
        padding.ensure_mono_np(np.zeros((2, 2, 2)))


def test_decode_bits_matches():
    logits = np.random.default_rng(1).normal(size=(3, 40, 2 + 16)).astype(np.float32)
    got = neural.decode_bits(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_decode_bits(jnp.asarray(logits))))


def test_package_exports_cover_jaxs():
    import nawc_tpu.eval as jax_eval
    import nawc_tpu.parallel as jax_parallel
    import nawc_tpu_torch.eval as port_eval
    import nawc_tpu_torch.models as port_models
    import nawc_tpu_torch.parallel as port_parallel
    import nawc_tpu_torch.utils as port_utils

    for jax_mod, port_mod in ((jax_models, port_models), (jax_utils, port_utils), (jax_eval, port_eval),
                              (jax_parallel, port_parallel)):
        assert set(jax_mod.__all__) <= set(port_mod.__all__), set(jax_mod.__all__) - set(port_mod.__all__)
        assert all(hasattr(port_mod, n) for n in port_mod.__all__)
