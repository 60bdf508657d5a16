"""Stats aggregation (``nawc_tpu/interp/feature_importance.py``: ``agg_stats``
only, which the robustness tables need), on numpy over lists of row dicts
instead of pandas DataFrames.  The feature-importance analysis waits for
ROADMAP A9.

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
