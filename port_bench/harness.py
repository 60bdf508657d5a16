"""The general parts of a run: the cell's files found by name, the closed
loop of the measured window, spans, the profiler window, the device's
identity and the result line.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``); the mix names its driver
(``drivers/<driver>.py``), the code that builds the system under test from
the configuration, makes the mix's inputs and drives the window.  The cell's
correctness limits are ``limits/<cell>.json`` and each per-layer metric is
read by ``metrics/<metric>.py``.  So a later cell, mix, configuration or
metric is a file of its own, found by the name in ``BENCHMARK.json``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "nawc_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file, under a name of its own (the file names of
    metrics hold dots, so they are not importable by name)."""
    name = "port_bench_" + "_".join(path.relative_to(BENCH).with_suffix("").parts).replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def cell_files(bench: dict, w: dict) -> dict:
    """-> the paths of cell `w`'s configuration, traffic, driver and limits."""
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    traffic = BENCH / "traffic" / f"{w['traffic']}.json"
    return {"config": ROOT / conf["file"], "traffic": traffic,
            "driver": BENCH / "drivers" / f"{load_json(traffic)['driver']}.py",
            "limits": BENCH / "limits" / f"{w['name']}.json"}


def metrics_for(bench: dict, workload: str, kind: str) -> list[dict]:
    """The cell's end-to-end (`kind` "end_to_end") or per-layer metrics:
    those that list it, or list no cells."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def program_float32() -> None:
    """The program's own option for its float32 arithmetic
    (``utils.device.float32_parity``, which its CLIs call): cuDNN and cuBLAS
    without TF32, as the configurations state."""
    from nawc_tpu_torch.utils.device import float32_parity

    float32_parity()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Spans:
    """Named wall-clock spans, each closed after a synchronise, kept in
    memory: name -> list of seconds."""

    def __init__(self, device):
        self.device = device
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        sync(self.device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync(self.device)
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def around(self, owner, attr: str, name: str, synced: bool = True):
        """Replace ``owner.attr`` by a wrapper that runs it inside a span
        (`synced`) or a profiler annotation (not synchronised)."""
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            ctx = self.span(name) if synced else torch.profiler.record_function(name)
            with ctx:
                return orig(*args, **kwargs)

        setattr(owner, attr, wrapped)
        try:
            yield
        finally:
            setattr(owner, attr, orig)


def closed_loop(call, seconds: float, device, after=None) -> dict:
    """Call ``call(i)`` back to back, each call ending in a synchronise,
    until `seconds` have passed -> the window's start, end and each call's
    seconds.  ``after(i, out)`` sees each call's result outside its time."""
    durs = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        out = call(i)
        sync(device)
        t1 = time.perf_counter()
        durs.append(t1 - t0)
        if after is not None:
            after(i, out)
        del out
        i += 1
        if t1 - start >= seconds:
            return {"start": start, "end": t1, "call_s": durs}


def p95(values: list[float]) -> float:
    """The 95th percentile by linear interpolation between order statistics."""
    if len(values) < 2:
        return max(values)
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


class Reservoir:
    """A uniform sample of at most `k` items of a stream of unknown length,
    drawn from `rng` (a numpy Generator made from the run's seed)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, make):
        """Keep ``make()`` with the reservoir's odds; `make` is called only
        when the item is kept."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, self.seen))
            if j < self.k:
                self.items[j] = make()


class ProfileWindow:
    """A profiler window opened and closed by the caller, read from the
    profiler's Chrome trace.  It idles `idle_s` after opening (the profiler
    on the card loses a window's first records now and then); the window is
    the span of the annotation from there to the final synchronise."""

    def __init__(self, device, idle_s: float = 0.1):
        from torch.profiler import ProfilerActivity, profile

        self.device, self.idle_s = device, idle_s
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.mark = torch.profiler.record_function("bench.window")

    def open(self) -> None:
        self.prof.__enter__()
        sync(self.device)
        time.sleep(self.idle_s)
        self.mark.__enter__()

    def close(self, units: int) -> dict:
        sync(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        out = ROOT / "build" / "port_bench"
        out.mkdir(parents=True, exist_ok=True)
        path = out / "trace.json"
        self.prof.export_chrome_trace(str(path))
        trace = load_json(path)
        path.unlink()
        return read_trace(trace["traceEvents"], units)


def profile_window(calls, n: int, device) -> dict:
    """Profile `n` calls of ``calls(i)`` in a :class:`ProfileWindow`."""
    win = ProfileWindow(device)
    win.open()
    for i in range(n):
        calls(i)
    return win.close(n)


def _union(intervals) -> float:
    total, end = 0.0, -math.inf
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def read_trace(events: list[dict], n: int) -> dict:
    """Chrome-trace events -> {"ops": [(name, start us, dur us)], window,
    busy and idle gaps}.  Device operations are kernels, copies and sets; a
    gap is named by the host's annotation and operator open where the host
    launched the operation that ends the gap."""
    dev_cats = ("kernel", "gpu_memcpy", "gpu_memset")
    win = next(e for e in events if e.get("name") == "bench.window" and e.get("ph") == "X"
               and e.get("cat") == "user_annotation")
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    ops = [(e["name"], e["ts"], e["dur"], e.get("args", {}).get("correlation"))
           for e in events if e.get("cat") in dev_cats and e.get("ph") == "X"
           and w0 <= e["ts"] <= w1]
    ops.sort(key=lambda o: o[1])
    launches = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    host = [e for e in events if e.get("cat") in ("user_annotation", "cpu_op")
            and e.get("ph") == "X" and e.get("name") != "bench.window"]

    def host_at(ts):
        inner = {}
        for e in host:
            if e["ts"] <= ts <= e["ts"] + e["dur"]:
                kind = e["cat"]
                if kind not in inner or e["dur"] < inner[kind]["dur"]:
                    inner[kind] = e
        names = [inner[k]["name"] for k in ("user_annotation", "cpu_op") if k in inner]
        return " / ".join(names) or "host"

    gaps, prev_end = [], w0
    for name, ts, dur, corr in ops:
        if ts > prev_end:
            gaps.append((ts - prev_end, corr, ts))
        prev_end = max(prev_end, ts + dur)
    if w1 > prev_end:
        gaps.append((w1 - prev_end, None, w1))
    gaps.sort(key=lambda g: -g[0])
    named = [[host_at(launches.get(corr, ts)) if corr is not None else "final synchronise",
              g / 1e6] for g, corr, ts in gaps[:10]]
    totals: dict[str, float] = {}
    for name, ts, dur, _ in ops:
        totals[name] = totals.get(name, 0.0) + dur / 1e6
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    return {"ops": [(name, ts, dur) for name, ts, dur, _ in ops],
            "window_s": (w1 - w0) / 1e6,
            "busy_s": _union((ts, ts + dur) for _, ts, dur, _ in ops) / 1e6,
            "units": n,
            "breakdown": {"device_ops": [[k, v] for k, v in top], "idle_gaps": named}}


def device_info(device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
