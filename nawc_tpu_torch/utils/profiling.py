"""Tracing and profiling (``nawc_tpu/utils/profiling.py``): a
``torch.profiler`` trace written as a Chrome trace, named spans around
pipeline stages, and a wall-clock stage timer for quick CLI summaries."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(out_dir: str | Path):
    """Profile the block on the host and, where there is one, the CUDA
    device; the trace is written as ``<out_dir>/trace.json`` (Chrome trace
    format, read by Perfetto or chrome://tracing).  Yields the profiler."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """Named span (shows up in the profiler's timeline)."""
    return record_function(name)


def _leaves(x) -> list[torch.Tensor]:
    """The tensors of `x`: a tensor, or dicts, lists and tuples of them."""
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


class StageTimer:
    """Wall-clock time per stage.  A stage whose box gets a ``result``
    synchronises the CUDA devices that result lies on before its clock
    stops, so the time covers the device's work."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        box = {}
        try:
            yield box
        finally:
            if "result" in box:
                for dev in {t.device for t in _leaves(box["result"]) if t.is_cuda}:
                    torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:30s} {t:8.3f}s total  {t / n * 1e3:8.1f} ms/call  x{n}")
        return "\n".join(lines)


def device_sync(x) -> float:
    """The sum of every tensor leaf of `x` (a tensor, or dicts, lists and
    tuples of them) in float32, fetched to the host as a ``float``.  The
    fetch waits for everything `x` depends on, so it serves as the barrier
    around anything timed."""
    acc = torch.zeros(())
    for leaf in _leaves(x):
        acc = acc.to(leaf.device) + leaf.detach().float().sum()
    return float(acc)
