"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
With ``--trace 0`` the result line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy seconds and a
breakdown.  The last line of standard output is one JSON object; the
comparison with the reference that decides ``correct`` is printed beside
its limits as the last lines of standard error and as the line's last key.
The run exits non-zero without a result when CUDA or the cards are missing,
when the package under test cannot be imported, and when a module of JAX
or of the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or PyTorch may keep goes inside the checkout, at a fixed path
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "port_bench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "port_bench" / "triton")
if __name__ == "__main__":
    # and so does the compiled bytecode of every module the run imports, PyTorch's too: where
    # the installation keeps none, every run would compile its sources again
    sys.pycache_prefix = str(ROOT / "build" / "port_bench" / "pycache")
    sys.dont_write_bytecode = False
sys.path.insert(0, str(ROOT))

from port_bench import harness  # noqa: E402

T_IMPORTS = time.perf_counter()  # PyTorch and the harness imported


class Run:
    """What a driver is handed: the cell's files, read; the seed, the
    window's length, the trace flag and the device; and the hooks that mark
    the end of set-up and read the memory peak."""

    def __init__(self, workload: str, seed: int, seconds: float, trace: bool, device,
                 config: dict, traffic: dict, control: str, t_start: float, mode: str = "bench",
                 marks: tuple = ()):
        self.workload, self.seed, self.seconds, self.trace = workload, seed, seconds, trace
        self.device, self.config, self.traffic = device, config, traffic
        self.control = control  # the precision of the control, from the cell's limits file
        self.t_start, self.mode = t_start, mode
        self.setup_s = None
        self.peak_bytes = 0
        self.marks: list[tuple[str, float]] = list(marks)

    def mark(self, what: str) -> None:
        """Note the seconds since the start at the end of a set-up step."""
        self.marks.append((what, round(time.perf_counter() - self.t_start, 3)))

    def setup_done(self) -> None:
        """Set-up ends here: the window opens."""
        self.setup_s = time.perf_counter() - self.t_start
        self.mark("set-up")

    def read_peak(self) -> None:
        import torch

        if self.device.type == "cuda":
            self.peak_bytes = int(torch.cuda.max_memory_allocated(self.device))


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """-> (correct, name -> {"value", "limit"}); a number missing, not
    finite or above its limit is not correct."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = checks.get(name, math.inf)
        v = float(v) if v is not None else math.inf
        out[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, out


def execute(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, config: dict | None = None, traffic: dict | None = None,
            limits: dict | None = None, mode: str = "bench", marks: tuple = ()) -> dict:
    """Run the cell once -> the result line as a dict (``checks`` last).
    `config`, `traffic` and `limits` replace the cell's files (tests run the
    harness at a small size on the CPU this way); `marks` are the set-up
    steps (name, seconds from `t_start`) before this call."""
    w = harness.cell(bench, workload)
    files = harness.cell_files(bench, w)
    lim = harness.load_json(files["limits"])
    run = Run(workload, seed, seconds, trace, device,
              config or harness.load_json(files["config"]),
              traffic or harness.load_json(files["traffic"]), lim["control_precision"], t_start,
              mode, marks)
    driver = harness.load_module(files["driver"])
    run.mark("start")
    out = driver.run(run)
    print(f"port_bench: set-up steps (s from start) {run.marks}", file=sys.stderr)
    correct, checks = judge(out["checks"], limits or lim["limits"])
    metrics = {}
    if trace:
        rec = out["record"]
        for m in harness.metrics_for(bench, workload, "per_layer"):
            reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py")
            v = reader.read(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(out["e2e"], setup_s=run.setup_s)
        for m in harness.metrics_for(bench, workload, "end_to_end"):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    dev = dict(harness.device_info(device, w["chips"]), memory_peak_bytes=run.peak_bytes)
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        prof = out["record"]["profile"]
        dev.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = prof["breakdown"]
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.benchmark()
    w = harness.cell(bench, args.workload)
    import torch

    marks = [("imports", round(T_IMPORTS - T_START, 3))]
    import nawc_tpu_torch  # noqa: F401  (the package under test; without it there is no run)

    marks.append(("package", round(time.perf_counter() - T_START, 3)))

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"port_bench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.empty(0, device=device)  # the CUDA context
    marks.append(("cuda", round(time.perf_counter() - T_START, 3)))
    line = execute(bench, args.workload, args.seed, args.seconds, bool(args.trace), device,
                   T_START, marks=tuple(marks))
    # the card's name and power limit, read once the window has closed
    print(f"port_bench: {args.workload} seed {args.seed} on {harness.power_limit()}",
          file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"port_bench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
