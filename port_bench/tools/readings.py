"""The readings that a cell's correctness limits are set from: the
program's compared numbers over many seeds and the control's (the
reference at the cell's control precision in the program's place), all in
one process, each run with a short window at the cell's own size.

    python3 port_bench/tools/readings.py --workload <cell> --seeds 1 2 3 \\
        [--control-seeds 4 5 6] [--fault <name>] [--seconds 3]

With ``--fault`` the program runs with that fault of ``port_bench/faults.py``
planted under it (its readings are a fault's, for the limits of an
optimisation's steps).  ``--also`` prints numbers the driver reads but
the cell does not compare.  Prints one JSON line per run ({"seed", "mode",
"fault", "checks"}) and, last, the largest reading of each number over the
program's seeds and the smallest over the control's.  It needs a card, as a
run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from port_bench import faults, harness  # noqa: E402
from port_bench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--also", nargs="*", default=[],
                    help="numbers of the driver to print that the cell does not compare")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    dev = torch.device("cuda", 0)
    lim = harness.load_json(harness.cell_files(bench, harness.cell(bench, args.workload))["limits"])
    limits = dict(lim["limits"], **{k: float("inf") for k in args.also})
    worst: dict[str, dict[str, float]] = {"bench": {}, "control": {}}
    for mode, seeds in (("bench", args.seeds), ("control", args.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            if args.fault and mode == "bench":
                with faults.planted(args.fault):
                    line = bench_run.execute(bench, args.workload, seed, args.seconds, False, dev,
                                             time.perf_counter(), limits=limits)
            else:
                line = bench_run.execute(bench, args.workload, seed, args.seconds, False, dev,
                                         time.perf_counter(), limits=limits, mode=mode)
            vals = {k: c["value"] for k, c in line["checks"].items()}
            print(json.dumps({"seed": seed, "mode": mode, "fault": args.fault, "checks": vals,
                              "s": round(time.perf_counter() - t0, 1)}), flush=True)
            for k, v in vals.items():
                pick = max if mode == "bench" else min
                worst[mode][k] = pick(worst[mode].get(k, v), v)
    print(json.dumps({"program_max": worst["bench"], "control_min": worst["control"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
