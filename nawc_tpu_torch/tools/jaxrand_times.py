"""Device time of the keyed-draw kernel (``nawc_tpu_torch/csrc/jaxrand.cu``)
at the shapes its paths draw, for one checkout or for two in turns.

    python3 -m nawc_tpu_torch.tools.jaxrand_times [--other DIR]

Times ``ops.jaxrand.normal`` and ``uniform`` at the uncertainty run's
(20, 32, 32000), the sweep's (32, 32000) and vorbis's dither (32, 126,
513), each as the summed duration of its kernels under ``torch.profiler``
over 50 draws after a warm-up (as chip_smoke.py times an op), and checks
the first 2^20 draws of each against the numpy replica bit for bit.  With
``--other``, the same is run for the checkout at DIR (say an unpacked
parent commit, whose kernels build into its own ``build/``) in turns,
other, this, this, other, each in a fresh process, so that the two are
compared on one card.  Prints the card's ``nvidia-smi`` name and power
limit.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CASES = [("normal", (20, 32, 32_000), ()), ("normal", (32, 32_000), ()),
         ("uniform", (32, 32_000), (0.0, 1.0)), ("uniform", (32, 126, 513), (-0.5, 0.5))]


def times(repo: Path, iters: int = 50) -> dict[str, float]:
    """ms per draw of each case with `repo`'s package, in this process."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(repo))
    from nawc_tpu_torch.ops import jaxrand as keyed
    from nawc_tpu_torch.utils import jaxrand

    dev = torch.device("cuda")
    key = jaxrand.prng_key(1)
    out = {}
    for kind, shape, lohi in CASES:
        def draw():
            return getattr(keyed, kind)(key, shape, dev, *lohi)

        # the replica of the first 2^20 draws: a draw is a function of its flat index
        got = draw().flatten()[:2**20].cpu().numpy()
        head = (got.size,)
        want = jaxrand.normal(key, head) if kind == "normal" else jaxrand.uniform(key, head, *lohi)
        if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
            raise AssertionError(f"{repo}: {kind} {shape} differs from the replica")
        for _ in range(3):
            draw()
        torch.cuda.synchronize()
        # idle before the draws: a window that opens on them now and then
        # lacks the device records of its first milliseconds
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(iters):
                draw()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        out[f"{kind} {shape}"] = dev_us / 1e3 / iters
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="a second checkout, timed in turns with this one")
    ap.add_argument("--only", type=Path, help=argparse.SUPPRESS)  # one checkout, in this process
    args = ap.parse_args()
    if args.only:
        print(json.dumps(times(args.only)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("jaxrand_times: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    order = [REPO] if args.other is None else [args.other.resolve(), REPO, REPO, args.other.resolve()]
    for repo in order:
        run = subprocess.run([sys.executable, __file__, "--only", str(repo)], capture_output=True,
                             text=True, timeout=600)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        res = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{repo}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in res.items()))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
