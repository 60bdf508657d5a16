"""Dataclass-backed CLI overrides (``nawc_tpu/utils/flags.py``).

`add_dataclass_args` exposes every field of a (frozen) dataclass as
``--prefix.field`` flags; `dataclass_from_args` builds the instance with the
overrides applied.  Tuple fields accept comma-separated values.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing


def _parse_tuple(elem_type):
    def parse(s: str):
        return tuple(elem_type(x) for x in s.split(",") if x != "")

    return parse


def add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str) -> None:
    """Add --<prefix>.<field> options for every field of dataclass `cls`."""
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        t = hints[f.name]
        origin = typing.get_origin(t)
        arg = f"--{prefix}.{f.name}"
        if origin in (tuple, typing.Tuple):
            elem = typing.get_args(t)[0]
            parser.add_argument(arg, type=_parse_tuple(elem), default=None,
                                help=f"{cls.__name__}.{f.name} (comma-separated)")
        elif t is bool or origin is typing.Union and bool in typing.get_args(t):
            parser.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=None, help=f"{cls.__name__}.{f.name}")
        elif origin is typing.Union:  # Optional[...]
            inner = [a for a in typing.get_args(t) if a is not type(None)][0]
            parser.add_argument(arg, type=inner, default=None, help=f"{cls.__name__}.{f.name}")
        else:
            parser.add_argument(arg, type=t, default=None, help=f"{cls.__name__}.{f.name}")


def dataclass_from_args(cls, args: argparse.Namespace, prefix: str, base=None):
    """Build `cls` from `base` (or defaults) with any --prefix.field
    overrides present in `args`."""
    base = base if base is not None else cls()
    updates = {}
    for f in dataclasses.fields(cls):
        v = getattr(args, f"{prefix}.{f.name}", None)
        if v is not None:
            updates[f.name] = v
    return dataclasses.replace(base, **updates) if updates else base
