"""What the program recorded about itself in a traced run, for the readers
of ``metrics/``.

``nawc_tpu_torch.utils.profiling`` records the program's spans and counters
while a ``torch.profiler`` profile is active, so over the profiled window
of a ``--trace 1`` run.  :func:`snapshot` takes the recorder's snapshot once
and keeps it in the record (``record["program"]``) for every reader after
the first.  A program without the recorder gives None, and the readers then
read nothing.

Times: a span's ``device_ms`` lies between its two CUDA events; its
``device_start_ms`` places it on the device's timeline.  The trace's
operations lie at ``ts * 1000 + base`` on the host's clock, where ``base``
is the start of the current trimonth (7,889,238 s intervals of the epoch,
the Chrome trace's ``baseTimeNanoseconds``).  :func:`idle_ms_by_span` puts
each idle gap of the device down to the innermost span whose events bracket
the operation that ends it, which is the span inside which the host
launched that operation (one stream, in order).
"""

from __future__ import annotations

TRIMONTH_NS = 7_889_238 * 10**9


def snapshot(rec: dict) -> dict | None:
    """The program's snapshot of the traced window, kept in `rec`."""
    if "program" not in rec:
        try:
            from nawc_tpu_torch.utils.profiling import snapshot as take
        except ImportError:  # a program without the recorder
            take = None
        rec["program"] = take() if take is not None and rec.get("profile") else None
    return rec["program"]


def span_ms(span: dict) -> float:
    """Device ms between the span's events; host ms where it has none."""
    if span["device_ms"] is not None:
        return span["device_ms"]
    return (span["end_ns"] - span["start_ns"]) / 1e6


def ms_per(rec: dict, name: str, unit: str) -> float | None:
    """ms of the spans `name` over the number of spans `unit` (a call or a
    step) in the traced window; None without either."""
    snap = snapshot(rec)
    if not snap:
        return None
    spans = snap["spans"]
    n = sum(1 for s in spans if s["name"] == unit)
    got = [span_ms(s) for s in spans if s["name"] == name]
    return sum(got) / n if n and got else None


def per_call(rec: dict, counter: str) -> float | None:
    """A counter of the traced window over its pipeline calls."""
    snap = snapshot(rec)
    if not snap or counter not in snap["counters"]:
        return None
    calls = sum(1 for s in snap["spans"] if s["name"] == "entry.call")
    return snap["counters"][counter] / calls if calls else None


def _device_clock(spans: list[dict]) -> int:
    """The host-clock ns at which the device reached the first start event
    of the snapshot: the device reaches an event no earlier than the host
    records it, and at once where it idles, so the latest bound is taken."""
    bound = None
    for s in spans:
        for host_ns, dev_ms in ((s["start_ns"], s["device_start_ms"]),
                                (s["end_ns"], s["device_start_ms"] + s["device_ms"])):
            b = host_ns - round(dev_ms * 1e6)
            bound = b if bound is None else max(bound, b)
    return bound


def idle_ms_by_span(rec: dict) -> dict[str, float] | None:
    """Idle ms of the profiled window between device operations, by the
    innermost span that launched the operation ending each gap, summed over
    the window (``None`` keys the gaps that no span brackets); None on a
    run without device operations or timed spans, or where fewer than
    nine in ten gaps fall inside a pipeline call (the clocks disagree)."""
    snap, prof = snapshot(rec), rec.get("profile")
    if not snap or not prof or not prof["ops"]:
        return None
    spans = [s for s in snap["spans"] if s["device_start_ms"] is not None]
    if not spans:
        return None
    zero_ns = _device_clock(spans)
    base = spans[0]["start_ns"] // TRIMONTH_NS * TRIMONTH_NS
    gaps, prev_end = [], None
    for _, ts, dur in sorted(prof["ops"], key=lambda o: o[1]):
        if prev_end is not None and ts > prev_end:
            at_ms = (base + round(ts * 1000) - zero_ns) / 1e6  # on the spans' device timeline
            gaps.append((at_ms, (ts - prev_end) / 1e3))
        prev_end = ts + dur if prev_end is None else max(prev_end, ts + dur)
    out: dict = {}
    inside_calls = 0
    for at_ms, ms in gaps:
        open_ = [s for s in spans
                 if s["device_start_ms"] <= at_ms <= s["device_start_ms"] + s["device_ms"]]
        inside_calls += any(s["name"] == "entry.call" for s in open_)
        # the innermost: the latest start on the device, then the last opened
        name = max(open_, key=lambda s: (s["device_start_ms"], s["id"]))["name"] if open_ else None
        out[name] = out.get(name, 0.0) + ms
    return out if gaps and inside_calls >= 0.9 * len(gaps) else None


def idle_ms_per_call(rec: dict, owns) -> float | None:
    """Idle ms per pipeline call of the gaps put down to the spans whose
    names satisfy `owns`."""
    by_span = idle_ms_by_span(rec)
    calls = sum(1 for s in snapshot(rec)["spans"] if s["name"] == "entry.call") if by_span else 0
    if not calls:
        return None
    return sum(ms for name, ms in by_span.items() if name is not None and owns(name)) / calls
