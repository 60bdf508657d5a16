"""Dataset sampler (``nawc_tpu/cli/sample_data.py``; the reference's
``sample_datasets.py``): copy the first N wavs of each dataset directory
into a flat test tree and optionally zip it.

Usage:
  python -m nawc_tpu_torch.cli.sample_data --src <dataset root> --count 120 \
      --out test_data --zip
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help="root containing per-dataset dirs of wavs")
    ap.add_argument("--count", type=int, default=120)
    ap.add_argument("--out", default="test_data")
    ap.add_argument("--zip", action="store_true")
    args = ap.parse_args(argv)

    src = Path(args.src)
    out = Path(args.out)
    total = 0
    datasets = [d for d in sorted(src.iterdir()) if d.is_dir()] or [src]
    for d in datasets:
        wavs = sorted(d.glob("*.wav"))[: args.count]
        dest = out / d.name
        dest.mkdir(parents=True, exist_ok=True)
        for w in wavs:
            shutil.copy2(w, dest / w.name)
        total += len(wavs)
        print(f"[sample_data] {d.name}: {len(wavs)} files")
    if args.zip:
        shutil.make_archive(str(out), "zip", out)
        print(f"[sample_data] wrote {out}.zip")
    print(f"[sample_data] {total} files -> {out}")


if __name__ == "__main__":
    main()
