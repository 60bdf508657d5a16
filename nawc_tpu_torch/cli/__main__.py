"""Unified CLI dispatcher: ``python -m nawc_tpu_torch.cli <command> [args...]``."""

from __future__ import annotations

import importlib
import sys

COMMANDS = ("benchmark", "robustness", "manifold", "ablation", "uncertainty", "perturbation",
            "pgd", "stats", "watermark", "train_codec", "train_wm", "train_gan", "eval_codec",
            "probe", "quality", "sample_data")


def main() -> None:
    cmd = sys.argv[1] if len(sys.argv) > 1 else None
    if cmd not in COMMANDS:
        print("usage: python -m nawc_tpu_torch.cli <command> [args...]\n\ncommands:")
        for c in COMMANDS:
            mod = importlib.import_module(f"nawc_tpu_torch.cli.{c}")
            doc = (mod.__doc__ or "").strip().splitlines()[0]
            print(f"  {c:12s} {doc}")
        raise SystemExit(0 if cmd in ("-h", "--help") else 1)
    importlib.import_module(f"nawc_tpu_torch.cli.{cmd}").main(sys.argv[2:])


if __name__ == "__main__":
    main()
