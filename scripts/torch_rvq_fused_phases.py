#!/usr/bin/env python3
"""Where the fused residual-VQ encode kernel spends its time, phase by phase.

    python3 scripts/torch_rvq_fused_phases.py

Builds ``nawc_tpu_torch/csrc/rvq_fused.cu`` once more, with its
``NAWC_PHASE`` markers recording the card's global timer on thread 0 of the
first and the last block, into the git-ignored ``build/rvq_fused_phases/``.
Runs it at the main path's shape, z (16, 192, 768), and at bench.py's
unpadded (16, 188), on random tables of the flagship codec's quantizer
(strides 4/2/1), and prints each phase's microseconds, level by level.  The
recording adds its own cost; the kernel's time is the one chip_smoke.py
reports.  Runs on the GPU only.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from nawc_tpu_torch.codec.model import ResidualVQ  # noqa: E402
from nawc_tpu_torch.ops import _lib, rvq_fused  # noqa: E402
from nawc_tpu_torch.utils.config import CodecConfig  # noqa: E402

PRELUDE = r"""
#include <cuda_runtime.h>
__device__ long long nawc_phase_ns[2][64];
#define NAWC_PHASE(i)                                                              \
  do {                                                                             \
    if (threadIdx.x == 0 && (blockIdx.x == 0 || blockIdx.x == gridDim.x - 1)) {   \
      long long t_;                                                                \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                      \
      nawc_phase_ns[blockIdx.x == 0 ? 0 : 1][(i)] = t_;                            \
    }                                                                              \
  } while (0)
extern "C" int nawc_phase_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, nawc_phase_ns, sizeof(nawc_phase_ns));
}
"""
# phase i of level l ends at marker 2 + 8*l + i; markers 0 and 1 bound the prologue
PHASES = ["in_proj partial sums", "in_proj sum + normalise", "codebook wait", "scores",
          "merge over lanes", "merge over warps, codes", "dequantise", "in_proj wait"]


def build() -> ctypes.CDLL:
    out = REPO / "build" / "rvq_fused_phases"
    out.mkdir(parents=True, exist_ok=True)
    (out / "prelude.cuh").write_text(PRELUDE)
    lib = out / "librvq_fused_phases.so"
    cmd = [_lib.find_nvcc(), *_lib.NVCC_FLAGS, "-shared", "-include", str(out / "prelude.cuh"),
           "-o", str(lib), str(_lib.CSRC / "rvq_fused.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(lib))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rvq_fused_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lib = build()
    fn = lib.nawc_rvq_encode
    fn.argtypes = rvq_fused._KERNEL.argtypes
    rng = np.random.default_rng(3)
    q = ResidualVQ(CodecConfig())
    with torch.no_grad():
        for prm in q.parameters():
            fan = prm.shape[-1] if prm.ndim > 1 else 1
            prm.copy_(torch.as_tensor(rng.standard_normal(tuple(prm.shape)) / np.sqrt(fan)))
    q = q.to(dev)
    strides = CodecConfig().vq_strides
    tables = rvq_fused.pack_tables(q, len(strides))
    k, c = tables[5].shape[1], tables[5].shape[2]
    print(torch.cuda.get_device_name(0))
    for b, t in [(16, 192), (16, 188)]:
        z = torch.as_tensor(rng.standard_normal((b, t, 768)), dtype=torch.float32, device=dev)
        codes = torch.empty(sum(b * (t // s) for s in strides), dtype=torch.int32, device=dev)
        args = [_lib.ptr(x) for x in (z, *tables, codes)] + [
            b, t, 768, c, k, (ctypes.c_int * len(strides))(*strides), len(strides), _lib.stream(z)]
        for _ in range(3):
            if fn(*args) != 0:
                raise RuntimeError("the instrumented kernel did not launch")
        torch.cuda.synchronize()
        want = torch.cat([x.reshape(-1) for x in rvq_fused.rvq_encode_reference(z, q, strides)])
        stamps = (ctypes.c_longlong * 128)()
        if lib.nawc_phase_read(stamps) != 0:
            raise RuntimeError("could not read the phase stamps")
        print(f"z ({b}, {t}, 768): {int((codes != want).sum())} codes differ from plain")
        for blk, name in ((0, "first block"), (64, "last block")):
            ns = stamps[blk:blk + 64]
            print(f"  {name}: {(ns[2 + 8 * (len(strides) - 1) + 5] - ns[0]) / 1e3:.2f} us, "
                  f"prologue {(ns[1] - ns[0]) / 1e3:.2f} us")
            prev = ns[1]
            for lvl in range(len(strides)):
                row = []
                for i, phase in enumerate(PHASES):
                    if lvl == len(strides) - 1 and i > 5:
                        break  # the last level stops after its codes
                    end = ns[2 + 8 * lvl + i]
                    row.append(f"{phase} {(end - prev) / 1e3:.2f}")
                    prev = end
                print(f"    level {lvl} (stride {strides[lvl]}): " + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
