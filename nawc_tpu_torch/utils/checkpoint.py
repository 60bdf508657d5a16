"""Reader and writer of the flax msgpack checkpoints, with no ``msgpack`` or
``flax``.

``flax.serialization.to_bytes`` writes a msgpack map of maps whose leaves
are ndarrays as ext type 1; the ext payload is itself msgpack of
``(shape, dtype_name, row-major bytes)`` (flax ``_ndarray_to_bytes``).  This
module decodes that subset of msgpack: maps, arrays, str, bin, ext, ints,
floats, nil and bool.  Arrays are ``np.frombuffer`` views of the file's
bytes, never copied element by element.  :func:`save_params` writes the
same subset as msgpack-python packs it, so that
``flax.serialization.from_bytes`` reads what the port saves.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self.take(size))[0]

    def read(self) -> Any:
        tag = self.take(1)[0]
        if tag <= 0x7F:  # positive fixint
            return tag
        if tag >= 0xE0:  # negative fixint
            return tag - 0x100
        if 0x80 <= tag <= 0x8F:
            return self._map(tag & 0x0F)
        if 0x90 <= tag <= 0x9F:
            return self._array(tag & 0x0F)
        if 0xA0 <= tag <= 0xBF:
            return self._str(tag & 0x1F)
        if tag == 0xC0:
            return None
        if tag == 0xC2:
            return False
        if tag == 0xC3:
            return True
        if tag in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            n = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[tag])
            return self.take(n)
        if tag in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[tag])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if tag == 0xCA:
            return self.unpack(">f")
        if tag == 0xCB:
            return self.unpack(">d")
        if 0xCC <= tag <= 0xD3:  # uint 8..64, int 8..64
            fmt = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}[tag]
            return self.unpack(fmt)
        if 0xD4 <= tag <= 0xD8:  # fixext 1/2/4/8/16
            n = 1 << (tag - 0xD4)
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if tag in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[tag]))
        if tag in (0xDC, 0xDD):  # array 16/32
            return self._array(self.unpack(">H" if tag == 0xDC else ">I"))
        if tag in (0xDE, 0xDF):  # map 16/32
            return self._map(self.unpack(">H" if tag == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack tag 0x{tag:02x} at byte {self.pos - 1}")

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ext(code: int, payload: memoryview) -> Any:
    if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
        shape, dtype_name, data = unpackb(payload)
        name = dtype_name if isinstance(dtype_name, str) else str(dtype_name, "utf-8")
        if name == "bfloat16":
            raise ValueError("bfloat16 leaves are not supported by this reader")
        arr = np.frombuffer(data, dtype=np.dtype(name)).reshape(tuple(shape))
        return arr if code == _EXT_NDARRAY else arr[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(payload)
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext code {code}")


def unpackb(data: bytes | memoryview) -> Any:
    """Decode one msgpack object (the subset flax writes)."""
    r = _Reader(memoryview(data))
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} trailing bytes after msgpack object")
    return out


def load_params(path: str | Path) -> dict:
    """-> the nested dict of numpy arrays that flax saved at `path`.

    The arrays are read-only views of the file's bytes."""
    return unpackb(Path(path).read_bytes())


class _Writer:
    """msgpack encoding of maps with str keys, arrays, str, bytes, ints,
    floats, nil, bool and numpy arrays (flax's ext type 1), each in the
    smallest form, as msgpack-python's ``packb`` chooses it."""

    def __init__(self):
        self.parts: list[bytes] = []

    def _head(self, n: int, fix: int | None, fix_max: int, tags: tuple[int, ...]) -> None:
        if fix is not None and n <= fix_max:
            self.parts.append(bytes([fix | n]))
        elif len(tags) == 3 and n < 0x100:
            self.parts.append(struct.pack(">BB", tags[0], n))
        elif n < 0x10000:
            self.parts.append(struct.pack(">BH", tags[-2], n))
        else:
            self.parts.append(struct.pack(">BI", tags[-1], n))

    def write(self, x: Any) -> None:
        if x is None:
            self.parts.append(b"\xc0")
        elif isinstance(x, bool):
            self.parts.append(b"\xc3" if x else b"\xc2")
        elif isinstance(x, int):
            self._int(x)
        elif isinstance(x, float):
            self.parts.append(struct.pack(">Bd", 0xCB, x))
        elif isinstance(x, str):
            b = x.encode("utf-8")
            self._head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
            self.parts.append(b)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            b = bytes(x)
            self._head(len(b), None, 0, (0xC4, 0xC5, 0xC6))
            self.parts.append(b)
        elif isinstance(x, dict):
            self._head(len(x), 0x80, 15, (0xDE, 0xDF))
            for k, v in x.items():
                self.write(k)
                self.write(v)
        elif isinstance(x, (list, tuple)):
            self._head(len(x), 0x90, 15, (0xDC, 0xDD))
            for v in x:
                self.write(v)
        elif isinstance(x, (np.ndarray, np.generic)):
            arr = np.asarray(x)
            payload = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
            self._ext(_EXT_NDARRAY if isinstance(x, np.ndarray) else _EXT_NPSCALAR, payload)
        else:
            raise TypeError(f"cannot write {type(x).__name__} to msgpack")

    def _int(self, x: int) -> None:
        if 0 <= x <= 0x7F or -32 <= x < 0:
            self.parts.append(struct.pack(">b" if x < 0 else ">B", x))
        elif x >= 0:
            for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                  (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
                if x <= top:
                    self.parts.append(struct.pack(">B", tag) + struct.pack(fmt, x))
                    return
            raise OverflowError(x)
        else:
            for tag, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                  (0xD2, ">i", -0x80000000), (0xD3, ">q", -(2**63))):
                if x >= low:
                    self.parts.append(struct.pack(">B", tag) + struct.pack(fmt, x))
                    return
            raise OverflowError(x)

    def _ext(self, code: int, payload: bytes) -> None:
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.parts.append(struct.pack(">Bb", fixed[n], code))
        elif n < 0x100:
            self.parts.append(struct.pack(">BBb", 0xC7, n, code))
        elif n < 0x10000:
            self.parts.append(struct.pack(">BHb", 0xC8, n, code))
        else:
            self.parts.append(struct.pack(">BIb", 0xC9, n, code))
        self.parts.append(payload)


def packb(obj: Any) -> bytes:
    """Encode one object as msgpack (the subset flax writes)."""
    w = _Writer()
    w.write(obj)
    return b"".join(w.parts)


def save_params(path: str | Path, params: dict) -> None:
    """Write a nested dict of numpy arrays (a flax variables tree) as
    ``flax.serialization.to_bytes`` writes it; the file is replaced
    atomically."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(packb(params))
    tmp.replace(path)


def tree_leaves(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """Flatten a nested dict to ``{"a/b/c": leaf}``."""
    out: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(tree_leaves(v, key))
        else:
            out[key] = v
    return out
