"""How often a ``torch.profiler`` window on the card lacks device records,
by the idle between its opening and the calls it profiles.

    python3 -m nawc_tpu_torch.tools.profiler_windows [--seconds 150]

For `--seconds`, opens windows in turn with 0, 5 and 50 ms of idle before
10 float32 matrix products of (16, 137992) by (137992, 112) (chip_smoke.py's
yardstick for sswm), with 20 products of (4096, 4096) between windows to
keep the card busy.  Prints each window that holds fewer than the 10
products' kernels, then per idle the windows, those short of kernels, and
the range of (a kernel's recorded start - its launch's) over the windows:
a negative value is a device timestamp ahead of the host's.  Runs on the
GPU only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

IDLES_S = (0.0, 0.005, 0.05)
CALLS = 10


def window(fn, idle_s: float) -> tuple[int, float]:
    """-> (device records of the `CALLS` calls of `fn`, the least recorded
    start of a kernel after its launch, us) of one window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(idle_s)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    kernels = {e.correlation_id(): e for e in events if e.device_type() == DeviceType.CUDA}
    lead = [(kernels[e.correlation_id()].start_ns() - e.start_ns()) / 1e3
            for e in events if "LaunchKernel" in e.name() and e.correlation_id() in kernels]
    return len(kernels), min(lead, default=float("nan"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seconds", type=float, default=150.0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profiler_windows: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    a, b = torch.randn(16, 137_992, device=dev), torch.randn(137_992, 112, device=dev)
    big = torch.randn(4096, 4096, device=dev)
    seen: dict[float, list[tuple[int, float]]] = {s: [] for s in IDLES_S}
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        for _ in range(20):
            big @ big
        for idle in IDLES_S:
            n, lead = window(lambda: torch.mm(a, b), idle)
            seen[idle].append((n, lead))
            if n < CALLS:
                print(f"{time.perf_counter() - t0:7.1f} s, idle {idle * 1e3:g} ms: {n} of {CALLS} kernels "
                      f"recorded", flush=True)
    for idle, runs in seen.items():
        leads = [x for _, x in runs if x == x]
        print(f"idle {idle * 1e3:g} ms: {len(runs)} windows, {sum(n < CALLS for n, _ in runs)} short of "
              f"kernels; kernel start - launch {min(leads):.1f} to {max(leads):.1f} us")
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
