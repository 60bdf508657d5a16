"""The port's in-process span and counter recorder, and a ``torch.profiler``
trace written as a Chrome trace beside the recorder's snapshot.

Spans.  ``with annotate(name, device):`` marks one stage of the program.
Recording is on between :func:`enable` and :func:`disable`, and whenever a
``torch.profiler`` profile is active, so that a profiled window carries the
program's spans with it.  While it is off, :func:`annotate` returns one
shared no-op context: it creates no CUDA event, enters no
``record_function`` and keeps nothing.  A recorded span keeps

- its name and id;
- the id of the recorded span it opened inside (its parent), per thread and
  context, and the id of the outermost one (its root), shared by every span
  of one call;
- its host start and end in ns of ``time.time_ns()``, the profiler's clock:
  a Chrome trace's event lies at ``ts * 1000 + baseTimeNanoseconds``;
- where `device` is a CUDA device, a pair of CUDA timing events on its
  current stream, read only by :func:`snapshot` (the hot path never
  synchronises): the snapshot's ``device_ms`` between them, and
  ``device_start_ms``, the start event's ms after the first start event of
  the snapshot's spans on that device, which places the spans on the
  device's timeline.

While a profiler runs, it also enters ``record_function(name)``, so that it
shows in the trace.  A span is kept only if recording was on at both its ends.  At most
:data:`MAX_SPANS` are kept; the oldest are dropped, and counted.

Counters.  ``count(name, n)`` adds `n` to an integer counter while recording
is on.  Kernel launches (``launches.<kernel>``) and the builds of kernel
tables and of the kernel library (``tables.built.<name>``) are counted at all
times besides: :func:`total` reads their running totals.  Every host-to-device
copy of the program goes through :func:`to_device`, which counts
``copy.h2d`` and ``copy.h2d_bytes``.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function

MAX_SPANS = 16384  # spans kept between two snapshots
ALWAYS = ("launches.", "tables.built.")  # counters counted while recording is off too

_NOOP = contextlib.nullcontext()


class _Recorder:
    """What is recorded between two snapshots, and the running totals."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.ids = itertools.count(1)
        self.spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self.dropped = 0
        self.counters: dict[str, int] = {}
        self.totals: dict[str, int] = {}


_REC = _Recorder()
# (id, root id) of the innermost recorded span open in this thread or context
_OPEN: contextvars.ContextVar = contextvars.ContextVar("nawc_open_span", default=None)


def recording() -> bool:
    """Whether spans and counters are recorded now."""
    return _REC.on or _profiler_enabled()


def enable() -> None:
    _REC.on = True


def disable() -> None:
    _REC.on = False


class _Span:
    __slots__ = ("name", "device", "id", "parent", "root", "start_ns", "end_ns", "events",
                 "_token", "_fn")
    # Each host time is read just before its event is recorded, so the device
    # reaches the event no earlier: a bound that places the events on the host's clock.

    def __init__(self, name: str, device: torch.device | None):
        self.name = name
        self.device = device if device is not None and device.type == "cuda" else None

    def __enter__(self):
        outer = _OPEN.get()
        self.id = next(_REC.ids)
        self.parent, self.root = outer if outer is not None else (None, self.id)
        self._token = _OPEN.set((self.id, self.root))
        # outside a profiler no trace would show it, and it costs 15 us a span
        self._fn = record_function(self.name) if _profiler_enabled() else None
        if self._fn is not None:
            self._fn.__enter__()
        self.events = stream = None
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            stream = torch.cuda.current_stream(self.device)
        self.start_ns = time.time_ns()
        if stream is not None:
            self.events[0].record(stream)
        return self

    def __exit__(self, *exc):
        stream = torch.cuda.current_stream(self.device) if self.events is not None else None
        self.end_ns = time.time_ns()
        if stream is not None:
            self.events[1].record(stream)
        if self._fn is not None:
            self._fn.__exit__(*exc)
        _OPEN.reset(self._token)
        if recording():
            with _REC.lock:
                if len(_REC.spans) == MAX_SPANS:
                    _REC.dropped += 1
                _REC.spans.append(self)
        return False

    def as_dict(self, first: dict) -> dict:
        """`first`: device -> the first start event of the snapshot there."""
        ms = at = None
        if self.events is not None:
            self.events[1].synchronize()
            ms = self.events[0].elapsed_time(self.events[1])
            at = first.setdefault(self.device, self.events[0]).elapsed_time(self.events[0])
        return {"name": self.name, "id": self.id, "parent": self.parent, "root": self.root,
                "start_ns": self.start_ns, "end_ns": self.end_ns, "device_ms": ms,
                "device_start_ms": at}


def annotate(name: str, device: torch.device | None = None):
    """A span named `name` around the block; `device` is where its work
    runs (a CUDA device gets timing events).  See the module docstring."""
    return _Span(name, device) if recording() else _NOOP


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`: while recording, and at all times for
    the counters named by :data:`ALWAYS`."""
    always = name.startswith(ALWAYS)
    on = recording()
    if not (always or on):
        return
    with _REC.lock:
        if always:
            _REC.totals[name] = _REC.totals.get(name, 0) + n
        if on:
            _REC.counters[name] = _REC.counters.get(name, 0) + n


def total(name: str) -> int:
    """The running total of a counter named by :data:`ALWAYS`."""
    return _REC.totals.get(name, 0)


def reset(prefix: str) -> None:
    """Set every counter whose name starts with `prefix` to zero: its
    running total and what the next snapshot would read."""
    with _REC.lock:
        for d in (_REC.totals, _REC.counters):
            for k in [k for k in d if k.startswith(prefix)]:
                del d[k]


def to_device(array: np.ndarray, device, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A copy of the host `array` on `device` (in `dtype`), counted as one
    host-to-device copy of the tensor's bytes.  It is counted on any device,
    so that a run on the CPU reads what a card would be sent."""
    t = torch.tensor(array, device=device, dtype=dtype)
    count("copy.h2d")
    count("copy.h2d_bytes", t.nbytes)
    return t


def snapshot() -> dict:
    """-> ``{"spans": [...], "counters": {...}, "dropped": n}``: what was
    recorded since the last snapshot, which it clears.  Waits for the
    device where a span's timing events have not completed."""
    with _REC.lock:
        spans, _REC.spans = list(_REC.spans), collections.deque(maxlen=MAX_SPANS)
        counters, _REC.counters = _REC.counters, {}
        dropped, _REC.dropped = _REC.dropped, 0
    spans.sort(key=lambda s: s.start_ns)
    first: dict = {}
    return {"spans": [s.as_dict(first) for s in spans], "counters": counters, "dropped": dropped}


@contextlib.contextmanager
def trace(out_dir: str | Path):
    """Profile the block on the host and, where there is one, the CUDA
    device; the trace is written as ``<out_dir>/trace.json`` (Chrome trace
    format, read by Perfetto or chrome://tracing) and the recorder's
    :func:`snapshot` after it as ``<out_dir>/spans.json``, on the same
    clock.  Yields the profiler."""
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
    (out / "spans.json").write_text(json.dumps(snapshot()))
