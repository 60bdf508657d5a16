"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain C
interface, under ``build/nawc_tpu_torch/`` at the root of the checkout
(git-ignored), at first use, and loaded with ``ctypes``.  No PyTorch
headers are compiled, so the build takes seconds.
The library's file name carries a hash of the sources, so an edited source
is rebuilt and a stale library is never loaded.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :class:`CudaKernel` raises if that is not 0 and
counts the launch otherwise, as ``launches.<kernel>`` in
``utils/profiling``'s counters.

Dispatch rule shared by every op in ``ops/``: a CUDA tensor goes to the
kernel (or the op raises), a CPU tensor goes to the plain PyTorch version.
The :func:`plain_versions` context runs the plain versions on the card; it
exists so that ``chip_smoke.py`` can hold each kernel against its plain
version, and nothing on the main path enters it.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils import profiling

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nawc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib: ctypes.CDLL | None = None
_build_log = ""
_force_plain = contextvars.ContextVar("nawc_force_plain", default=False)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH); "
            "the CUDA toolkit is needed to build the kernels in nawc_tpu_torch/csrc"
        )
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libnawc_kernels_{h.hexdigest()[:16]}.so"


def _check(cmd: list[str], rc: int, log: str) -> None:
    if rc != 0:
        raise RuntimeError(f"nvcc failed (exit {rc}):\n{' '.join(cmd)}\n{log}")


def build() -> tuple[Path, str]:
    """Compile the kernels if their library is missing -> (path, nvcc log).

    The log holds what ``-Xptxas -v`` reports for each kernel (registers,
    shared memory, spills); it is empty when the library was already built.
    A build counts ``tables.built.library`` in ``utils/profiling``'s
    counters, at all times."""
    global _build_log
    out = library_path()
    if out.exists():
        return out, _build_log
    profiling.count("tables.built.library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
            for src, o in zip(_sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    try:
        for cmd, p, log in zip(cmds, procs, logs):
            _check(cmd, p.returncode, log)
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        _check(link, proc.returncode, proc.stdout)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    _build_log = "".join(logs) + proc.stdout
    return out, _build_log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _ = build()
        _lib = ctypes.CDLL(str(path))
    return _lib


class CEntry:
    """One C entry of the library; calling it raises unless it returns 0."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA entry {self.name} failed: cudaError {err}")


class CudaKernel(CEntry):
    """A C entry that launches kernels, with its launch count.

    Every call whose launches the CUDA runtime accepted, and nothing else,
    counts one in ``utils/profiling``'s counter ``launches.<name>``, which
    counts at all times; ``launches`` is its running total."""

    def __init__(self, name: str, symbol: str, argtypes: list):
        super().__init__(name, symbol, argtypes)
        self.counter = f"launches.{name}"

    def __call__(self, *args) -> None:
        super().__call__(*args)
        profiling.count(self.counter)

    @property
    def launches(self) -> int:
        return profiling.total(self.counter)


KERNELS: dict[str, CudaKernel] = {}


def register(kernel: CudaKernel) -> CudaKernel:
    KERNELS[kernel.name] = kernel
    return kernel


def reset_launches() -> None:
    """Every kernel's launch count back to zero, in ``launches`` and in the
    recorder's counters."""
    profiling.reset("launches.")


@contextlib.contextmanager
def plain_versions():
    """Run every op's plain PyTorch version, also on CUDA tensors."""
    token = _force_plain.set(True)
    try:
        yield
    finally:
        _force_plain.reset(token)


def use_kernel(x: torch.Tensor) -> bool:
    """True iff `x` lies on a CUDA device outside :func:`plain_versions`."""
    return x.is_cuda and not _force_plain.get()


# owner -> {name: (each source's (address, version), the sources, the value)};
# keyed by identity, since a tensor's == is elementwise
_DERIVED = WeakIdKeyDictionary()


def derived(owner, name: str, sources: list[torch.Tensor], make):
    """``make()``, kept for `owner` (a module or a tensor) until one of the
    `sources` it was made from is moved, replaced or changed in place.  The
    kept references pin the old storage, so that a new tensor cannot reuse
    its address.  For a kernel's tables that only change with the weights.
    Each ``make()`` counts ``tables.built.<name>`` in ``utils/profiling``'s
    counters, at all times."""
    key = [(t.data_ptr(), t._version) for t in sources]
    kept = _DERIVED.setdefault(owner, {})
    hit = kept.get(name)
    if hit is None or hit[0] != key:
        profiling.count(f"tables.built.{name}")
        hit = kept[name] = (key, [t.detach() for t in sources], make())
    return hit[2]


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: all inputs must lie on {dev}, got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
