"""Unified CLI dispatcher: ``python -m nawc_tpu_torch.cli <command> [args...]``.

The commands the port has; the JAX dispatcher's other commands exit
non-zero and name the ROADMAP.md item that ports them."""

from __future__ import annotations

import importlib
import sys

COMMANDS = ("benchmark", "robustness", "manifold", "ablation", "uncertainty", "perturbation",
            "pgd", "stats", "watermark", "train_codec", "train_wm", "train_gan", "eval_codec",
            "probe")
# the JAX dispatcher's commands still to port -> their ROADMAP.md item
QUEUED = {"quality": "A8 and A12", "sample_data": "A12"}


def main() -> None:
    cmd = sys.argv[1] if len(sys.argv) > 1 else None
    if cmd in QUEUED:
        raise SystemExit(f"command {cmd!r} is not ported to nawc_tpu_torch yet "
                         f"(ROADMAP.md {QUEUED[cmd]}); ported: {', '.join(COMMANDS)}")
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
