"""The readers of the program's own spans and counters (``port_bench/program.py``
and the metrics that use it) on hand-made records, and in a traced run of
each cell at the test size on the CPU."""

import pytest

from port_bench import harness, program

SPAN_METRICS = {
    "roundtrip-f32": ["encode_ms.pipeline", "quantize_ms.pipeline", "decode_ms.pipeline",
                      "h2d_bytes.pipeline"],
    "latent-embed-f32": ["loss_ms.latent", "backward_ms.latent", "adam_ms.latent"],
}
IDLE = ["idle_codec_ms.pipeline"]


def reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read


def span(name, id_, parent, start_ms, end_ms, dev_at=None, dev_ms=None):
    """A snapshot's span: host times in ms from a base of 10^18 ns; the
    device's, where given, in ms after the first start event."""
    return {"name": name, "id": id_, "parent": parent, "root": 1,
            "start_ns": 10**18 + round(start_ms * 1e6), "end_ns": 10**18 + round(end_ms * 1e6),
            "device_ms": dev_ms, "device_start_ms": dev_at}


def pipeline_record(calls=2, ops=()):
    """Two calls, each: embed 4 ms, attack 12 ms (encode 5, quantize 1,
    decode 5), detect 2 ms on the device; 10 ms apart on the host."""
    spans, i = [], 1
    for c in range(calls):
        t = 20.0 * c
        root = i
        spans += [span("entry.call", i, None, t, t + 19, t, 19.0),
                  span("ss.embed", i + 1, root, t, t + 4, t, 4.0),
                  span("attack.codec", i + 2, root, t + 4, t + 16, t + 4, 12.0),
                  span("codec.encode", i + 3, i + 2, t + 4.5, t + 9.5, t + 4.5, 5.0),
                  span("codec.quantize", i + 4, i + 2, t + 9.5, t + 10.5, t + 9.5, 1.0),
                  span("codec.decode", i + 5, i + 2, t + 10.5, t + 15.5, t + 10.5, 5.0),
                  span("ss.detect", i + 6, root, t + 16, t + 18, t + 16, 2.0)]
        i += 7
    counters = {"copy.h2d": 7 * calls, "copy.h2d_bytes": 3026944 * calls}
    return {"profile": {"ops": list(ops), "busy_s": 0.03, "window_s": 0.04, "units": calls},
            "program": {"spans": spans, "counters": counters, "dropped": 0}}


def test_span_readers_on_a_hand_made_record():
    rec = pipeline_record()
    want = {"encode_ms.pipeline": 5.0, "quantize_ms.pipeline": 1.0, "decode_ms.pipeline": 5.0,
            "h2d_bytes.pipeline": 3026944}
    for name, value in want.items():
        assert reader(name)(rec) == pytest.approx(value, abs=1e-9), name


def test_step_readers_on_a_hand_made_record():
    spans = []
    for k, t in enumerate((0.0, 130.0, 260.0)):
        spans += [span("semantic.loss", 3 * k + 1, None, t, t + 50, t, 50.0 + k),
                  span("semantic.backward", 3 * k + 2, None, t + 50, t + 120, t + 50, 70.0),
                  span("semantic.adam", 3 * k + 3, None, t + 120, t + 128, t + 120, 2.0)]
    rec = {"profile": {"ops": []}, "program": {"spans": spans[:-1], "counters": {}, "dropped": 0}}
    assert reader("loss_ms.latent")(rec) == pytest.approx(51.0)
    assert reader("backward_ms.latent")(rec) == pytest.approx(70.0)
    assert reader("adam_ms.latent")(rec) == pytest.approx(2.0)  # two whole adam spans


def test_spans_without_device_events_read_their_host_time():
    rec = pipeline_record()
    for s in rec["program"]["spans"]:
        s["device_ms"] = s["device_start_ms"] = None
    assert reader("encode_ms.pipeline")(rec) == pytest.approx(5.0)
    assert reader("idle_codec_ms.pipeline")(rec) is None


def test_idle_gaps_go_to_the_span_that_launched_their_end():
    base = 10**18 // program.TRIMONTH_NS * program.TRIMONTH_NS
    zero_us = (10**18 - base) / 1e3  # the trace's ts of the spans' device time 0
    # (name, start, end) in device ms: gaps of 0.5 ms in the embed, 0.4 ending
    # at the attack's own first operation, 0.25 and 1.0 in the encode, 0.2
    # and 1.0 in the detect
    ops = [("k", 0.2, 1.0), ("k", 1.5, 3.9), ("k", 4.3, 4.4), ("k", 4.65, 6.0), ("k", 7.0, 15.9),
           ("k", 16.1, 16.2), ("k", 17.2, 17.9)]
    rec = pipeline_record(calls=1, ops=[(n, zero_us + a * 1e3, (b - a) * 1e3) for n, a, b in ops])
    by_span = program.idle_ms_by_span(rec)
    assert by_span == pytest.approx({"ss.embed": 0.5, "attack.codec": 0.4, "codec.encode": 1.25,
                                     "ss.detect": 1.2})
    assert reader("idle_codec_ms.pipeline")(rec) == pytest.approx(1.65)


def test_idle_readers_refuse_clocks_that_disagree():
    # the operations a day away from every span
    ops = [("k", 86_400e6 + 10.0 * i, 5.0) for i in range(20)]
    rec = pipeline_record(calls=1, ops=ops)
    assert program.idle_ms_by_span(rec) is None
    assert reader("idle_codec_ms.pipeline")(rec) is None


@pytest.mark.parametrize("name", sum(SPAN_METRICS.values(), IDLE))
def test_readers_read_nothing_without_the_programs_spans(name, monkeypatch):
    assert reader(name)({}) is None
    assert reader(name)({"profile": {"ops": []}, "program": None}) is None
    assert reader(name)({"profile": {"ops": []},
                         "program": {"spans": [], "counters": {}, "dropped": 0}}) is None
    # a program without the recorder (the parent of the change that brought it)
    from nawc_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert reader(name)({"profile": {"ops": [("k", 0.0, 1.0)], "busy_s": 1, "window_s": 1}}) is None


@pytest.mark.parametrize("workload", sorted(SPAN_METRICS))
def test_traced_line_holds_the_programs_metrics(small, workload, monkeypatch):
    kwargs = {}
    if workload.startswith("latent"):  # 20 steps a call, in the program and the configuration
        import dataclasses

        from nawc_tpu_torch.models import semantic

        short = dataclasses.replace(semantic._DEFAULT_CFGS["pca"], steps=20)
        monkeypatch.setitem(semantic._DEFAULT_CFGS, "pca", short)
        kwargs = {"steps": 20, "seconds": 0.5}
    line = small(workload, trace=True, **kwargs)
    assert line["correct"], line["checks"]
    for name in SPAN_METRICS[workload]:
        assert line["metrics"][name]["value"] > 0, name
    if workload == "roundtrip-f32":
        # the tiny call's copies: two pattern tables and five Hann windows
        assert line["metrics"]["h2d_bytes.pipeline"]["value"] == 3026944
    # a CPU run reads no device metric
    assert not set(IDLE) & set(line["metrics"])
