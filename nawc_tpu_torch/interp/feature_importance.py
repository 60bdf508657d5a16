"""Feature-importance correlation analysis and stats aggregation
(``nawc_tpu/interp/feature_importance.py``), on numpy over lists of row
dicts instead of pandas DataFrames.

A table is a list of dicts, one per row; its columns are the keys in the
order they first appear, and a key a row lacks reads as NaN there.
"""

from __future__ import annotations

import math

import numpy as np

Row = dict


def columns(rows: list[Row]) -> list[str]:
    """The table's columns, in the order in which they first appear."""
    return list(dict.fromkeys(k for r in rows for k in r))


def _is_number(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, (bool, np.bool_))


def numeric_columns(rows: list[Row]) -> list[str]:
    """Columns whose every value is a number (as pandas' ``select_dtypes``
    of ``np.number`` picks them: booleans and strings are not)."""
    return [c for c in columns(rows) if all(_is_number(r[c]) for r in rows if c in r)]


def _rankdata(x: np.ndarray) -> np.ndarray:
    """1-based ranks, ties given their average rank."""
    order = np.argsort(x)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(x) + 1)
    _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
    sums = np.zeros(len(counts))
    np.add.at(sums, inv, ranks)
    return sums[inv] / counts[inv]


def compute_feature_importance(rows: list[Row], target: str) -> list[Row]:
    """Pearson and Spearman correlation of every numeric column with
    `target`, over the rows where both are finite (columns with fewer than
    3 such rows or no spread are left out) -> rows (feature, pearson,
    spearman, abs_pearson), by abs_pearson descending, ties in column
    order."""
    num = numeric_columns(rows)
    if target not in num:
        raise KeyError(f"target column {target!r} not numeric or missing")

    def values(c: str) -> np.ndarray:
        return np.array([r.get(c, math.nan) for r in rows], np.float64)

    y = values(target)
    out = []
    for col in num:
        if col == target:
            continue
        x = values(col)
        m = np.isfinite(x) & np.isfinite(y)
        if m.sum() < 3 or x[m].std() == 0 or y[m].std() == 0:
            continue
        pearson = float(np.corrcoef(x[m], y[m])[0, 1])
        spearman = float(np.corrcoef(_rankdata(x[m]), _rankdata(y[m]))[0, 1])
        out.append({"feature": col, "pearson": pearson, "spearman": spearman,
                    "abs_pearson": abs(pearson)})
    return sorted(out, key=lambda r: -r["abs_pearson"])


def agg_stats(rows: list[Row], group_cols: list[str]) -> list[Row]:
    """Group mean and std of every numeric column, as ``<col>_mean`` and
    ``<col>_std``, with the group's row count ``n`` after the group columns.
    Groups come in sorted key order and the std is the sample std (ddof 1,
    NaN for a group of one), as pandas' ``groupby(...).agg(["mean", "std"])``
    gives them; NaNs are skipped."""
    num = [c for c in numeric_columns(rows) if c not in group_cols]
    groups: dict[tuple, list[Row]] = {}
    for r in rows:
        groups.setdefault(tuple(r[g] for g in group_cols), []).append(r)
    out = []
    for key in sorted(groups):
        members = groups[key]
        row: Row = dict(zip(group_cols, key))
        row["n"] = len(members)
        for c in num:
            v = np.array([m.get(c, math.nan) for m in members], np.float64)
            v = v[~np.isnan(v)]
            row[f"{c}_mean"] = float(v.mean()) if v.size else math.nan
            row[f"{c}_std"] = float(v.std(ddof=1)) if v.size > 1 else math.nan
        out.append(row)
    return out
