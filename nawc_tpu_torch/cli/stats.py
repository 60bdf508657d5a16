"""Stats aggregation and feature-importance CLI (``nawc_tpu/cli/stats.py``):
group mean/std of every numeric column, the overall stats, and the Pearson
and Spearman correlation of every numeric column with a target.

Usage:
  python -m nawc_tpu_torch.cli.stats --results results/robustness/test_results.csv \\
      --target 'bitwise/distorted' --out_dir results/stats

It writes ``stats_by_group.csv``, ``overall_stats.csv`` and, when the
target is a column, ``feature_importance.csv`` under ``--out_dir``, with the
JAX CLI's columns, with the top-K bar plot ``feature_importance.png``.
Without matplotlib it writes the CSVs and prints one line naming the
PNG it did not draw.  It runs on the host only.
"""

from __future__ import annotations

import argparse
import csv
import math
from pathlib import Path

# the cells pandas' read_csv reads as NaN by default
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
       "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_BOOL = {"True": True, "TRUE": True, "true": True, "False": False, "FALSE": False, "false": False}


def _number(s: str):
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return None


def _typed_column(cells: list[str]) -> list:
    """A column's cells typed as ``pandas.read_csv`` types them: all
    integers -> int; numbers and NaN cells -> float; all booleans -> bool;
    else strings, NaN cells as NaN."""
    na = [c in _NA for c in cells]
    nums = [None if m else _number(c) for c, m in zip(cells, na)]
    if all(m or n is not None for m, n in zip(na, nums)) and not all(na):
        if not any(na) and all(isinstance(n, int) for n in nums):
            return nums
        return [math.nan if m else float(n) for m, n in zip(na, nums)]
    if not any(na) and all(c in _BOOL for c in cells):
        return [_BOOL[c] for c in cells]
    if all(na):
        return [math.nan] * len(cells)
    return [math.nan if m else c for c, m in zip(cells, na)]


def _read(path: str, sep: str) -> list[dict]:
    with open(path, newline="") as f:
        header, *body = list(csv.reader(f, delimiter=sep))
    cols = [_typed_column([r[j] if j < len(r) else "" for r in body]) for j in range(len(header))]
    return [dict(zip(header, vals)) for vals in zip(*cols)]


def load_table(path: str) -> list[dict]:
    """The table as row dicts, its delimiter found as in the JAX CLI: pipe
    first (the raw_bench convention), then comma."""
    with open(path, newline="") as f:
        head = f.readline()
    sep = "|" if len(head.rstrip("\r\n").split("|")) > 1 else ","
    return _read(path, sep)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results", required=True, help="per-chunk results CSV (pipe or comma)")
    ap.add_argument("--group", nargs="+", default=["attack_type"])
    ap.add_argument("--target", default="bitwise/distorted")
    ap.add_argument("--top_k", type=int, default=15)
    ap.add_argument("--out_dir", default="results/stats")
    args = ap.parse_args(argv)

    from ..eval import figures
    from ..eval.robustness import write_csv
    from ..interp import agg_stats, compute_feature_importance
    from ..interp.feature_importance import columns
    from .robustness import format_table

    rows = load_table(args.results)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    write_csv(agg_stats(rows, [g for g in args.group if g in columns(rows)]), out / "stats_by_group.csv")
    overall = agg_stats([{**r, "_all": 0} for r in rows], ["_all"])
    write_csv([{k: v for k, v in r.items() if k != "_all"} for r in overall], out / "overall_stats.csv")

    if args.target in columns(rows):
        imp = compute_feature_importance(rows, args.target)
        write_csv(imp, out / "feature_importance.csv")
        if figures.available():
            figures.plot_feature_importance(imp, out / "feature_importance.png", args.target, args.top_k)
        else:
            figures.not_drawn([out / "feature_importance.png"])
        print(format_table(imp[: args.top_k], "feature", ("pearson", "spearman", "abs_pearson"), digits=6))
    else:
        print(f"[stats] target {args.target!r} not in columns; wrote group stats only")
    print(f"[stats] wrote {out}")


if __name__ == "__main__":
    main()
