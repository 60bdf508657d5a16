"""Device time of the Snake kernel (``nawc_tpu_torch/csrc/snake.cu``) at
the shapes of three encodes, and its SASS instructions per element, for one
checkout or for two in turns.

    python3 -m nawc_tpu_torch.tools.snake_times [--other DIR]

For float32 and bfloat16 it times the forward, the backward with the d
alpha sums (the trainers') and without them (the codec-latent embed's,
whose codec is frozen) at every Snake shape of a 16 x 4 s encode (bench.py's
unpadded T), of the codec-latent embed's 4 x 2 s encode (padded to 49152
samples) and of the trainers' 16 x 32768 crops, each as the summed
duration of its kernels under ``torch.profiler`` over 20 calls after a
warm-up (as chip_smoke.py times an op), and sums them over each encode (7
Snakes a block, 1 at the end) beside the bound (bytes at 3.35 TB/s).  The
forward is held bit for bit against ``snake_reference`` at every shape.
It reads each kernel's SASS (``cuobjdump -sass`` of the built library):
instructions, range checks (FCHK), calls, and instructions per element: the
instructions of the loop that holds the 16-byte loads, less the loops
inside it (single elements, the rare exact path), over the elements of
one trip, which is what a thread issues an element when nothing leaves the
fast path.
With ``--other``, the same is run for the checkout at DIR (say an unpacked
parent commit, whose kernels build into its own ``build/``) in turns,
other, this, this, other, each in a fresh process, so that the two are
compared on one card.  Prints the card's ``nvidia-smi`` name and power
limit.  Runs on the GPU only.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SETS = {
    "16 x 4 s": ((16, 48, 96_000, 7), (16, 96, 48_000, 7), (16, 192, 12_000, 7), (16, 384, 1_500, 7),
                 (16, 768, 188, 1)),
    "codec-latent 4 x 2 s": ((4, 48, 49_152, 7), (4, 96, 24_576, 7), (4, 192, 6_144, 7),
                             (4, 384, 768, 7), (4, 768, 96, 1)),
    "trainers 16 x 32768": ((16, 48, 32_768, 7), (16, 96, 16_384, 7), (16, 192, 4_096, 7),
                            (16, 384, 512, 7), (16, 768, 64, 1)),
}
PASSES = ("forward", "backward", "backward, no d alpha")
# the opcodes counted in each kernel's SASS (the range checks, FCHK, mark
# IEEE divisions; DMUL and F2F the float64 fallback and the bfloat16 roundings)
OPCODES = ("FFMA", "FMUL", "FADD", "MUFU", "FRND", "FSETP", "FCHK", "CALL", "DMUL", "F2F", "BSSY",
           "LDG", "STG")
PEAK_BYTES_PER_S = 3.35e12
SASS_NAME = re.compile(r"snake_(forward|backward)_kernelI(f|13__nv_bfloat16)(?:Lb([01])E)?E")


def sass_text(lib: Path, nvcc: str) -> str:
    """``cuobjdump -sass`` of the library at `lib` (cuobjdump beside nvcc)."""
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def pass_loop(body: str) -> tuple[list[str], int]:
    """One function's SASS -> (its opcodes, the instructions of its pass
    loop): the innermost loop (a backward branch's span) that holds the
    16-byte loads, without the loops inside it (the single elements, the
    rare exact path).  One trip of it is one pass over a thread's vectors,
    every element on the fast path."""
    ins = []
    for line in body.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if m:
            words = [w for w in m.group(2).split() if not w.startswith("@")]
            if words:
                target = re.findall(r"0x([0-9a-f]+)", m.group(2))
                ins.append((int(m.group(1), 16), words[0], int(target[-1], 16) if target else None))
    loops = [(t, a) for a, op, t in ins if op.startswith("BRA") and t is not None and t < a]
    loads = [a for a, op, _ in ins if op.startswith("LDG.E.128")]
    holding = [lp for lp in loops if any(lp[0] <= a <= lp[1] for a in loads)]
    if not holding:
        return [op for _, op, _ in ins], 0
    lo, hi = min(holding, key=lambda lp: lp[1] - lp[0])
    inner = [lp for lp in loops if lo <= lp[0] and lp[1] <= hi and lp != (lo, hi)]
    count = sum(lo <= a <= hi and not any(i0 <= a <= i1 for i0, i1 in inner) for a, _, _ in ins)
    return [op for _, op, _ in ins], count


def kernel_sass(text: str, vectors: int) -> dict[str, dict]:
    """The Snake kernels of ``cuobjdump -sass`` output `text`, whose threads
    take `vectors` 16-byte vectors a pass -> per kernel ("forward f32",
    "backward bf16, no d alpha", ...): its instructions, the pass loop's
    instructions per element, and the count of each of ``OPCODES``.  A
    backward without the bool argument (one kernel for both) is listed
    under both of its labels."""
    out = {}
    for block in text.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        m = SASS_NAME.search(name)
        if not m:
            continue
        ops, loop = pass_loop(body)
        kind, t = m.group(1), "f32" if m.group(2) == "f" else "bf16"
        rec = dict(instructions=len(ops), per_element=round(loop / (vectors * (4 if t == "f32" else 8)), 1),
                   **{k: sum(o == k or o.startswith(k + ".") for o in ops) for k in OPCODES})
        if kind == "forward":
            out[f"forward {t}"] = rec
        else:
            for alpha in ((m.group(3),) if m.group(3) else ("1", "0")):
                out[f"backward {t}" + ("" if alpha == "1" else ", no d alpha")] = rec
    return out


def vectors_of(repo: Path) -> int:
    """The 16-byte vectors a thread takes a pass in `repo`'s ``snake.cu``."""
    source = (repo / "nawc_tpu_torch" / "csrc" / "snake.cu").read_text()
    return int(re.search(r"constexpr int kVec(?:PerLane|PerThread) = (\d+);", source).group(1))


def times(repo: Path, calls: int = 20) -> dict:
    """ms per call of each pass at each shape with `repo`'s package, in this
    process, the sums over each encode, and the SASS counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(repo))
    from nawc_tpu_torch.ops import _lib
    so = importlib.import_module("nawc_tpu_torch.ops.snake")

    lib, _ = _lib.build()
    dev = torch.device("cuda")

    def device_ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        # idle before the calls: a window that opens on them now and then
        # lacks the device records of its first milliseconds
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.05)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / calls

    out = {"sass": kernel_sass(sass_text(lib, _lib.find_nvcc()), vectors_of(repo)), "sums": {},
           "shapes": {}}
    for label, shapes in SETS.items():
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            acc = {k: 0.0 for k in PASSES + ("bound forward", "bound backward")}
            for i, (b, c, t, count) in enumerate(shapes):
                gen = torch.Generator(device=dev).manual_seed(100 + i)
                x = (torch.randn((b, c, t), generator=gen, device=dev) * 2).to(dtype)
                la = torch.randn((c,), generator=gen, device=dev) * 0.3
                g = torch.randn((b, c, t), generator=gen, device=dev).to(dtype)
                alpha = torch.exp(la).to(dtype).float()
                with torch.no_grad():
                    if not torch.equal(so._forward_cuda(x, alpha), so.snake_reference(x, la)):
                        raise AssertionError(f"{repo}: forward {tag} {(b, c, t)} differs from plain")
                ms = {"forward": device_ms(lambda: so._forward_cuda(x, alpha)),
                      "backward": device_ms(lambda: so._backward_cuda(x, alpha, g, True, True)),
                      "backward, no d alpha": device_ms(lambda: so._backward_cuda(x, alpha, g, True, False))}
                out["shapes"][f"{label} {tag} {(b, c, t)}"] = ms
                for k, v in ms.items():
                    acc[k] += count * v
                n = b * c * t
                acc["bound forward"] += count * 2 * n * x.element_size() / PEAK_BYTES_PER_S * 1e3
                acc["bound backward"] += count * 3 * n * x.element_size() / PEAK_BYTES_PER_S * 1e3
                del x, g
            out["sums"][f"{label} {tag}"] = acc
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="a second checkout, timed in turns with this one")
    ap.add_argument("--only", type=Path, help=argparse.SUPPRESS)  # one checkout, in this process
    args = ap.parse_args()
    if args.only:
        print(json.dumps(times(args.only)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("snake_times: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    order = [REPO] if args.other is None else [args.other.resolve(), REPO, REPO, args.other.resolve()]
    for repo in order:
        run = subprocess.run([sys.executable, __file__, "--only", str(repo)], capture_output=True,
                             text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        res = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"== {repo}")
        for k, v in res["sass"].items():
            print(f"  SASS {k}: {v['instructions']} instructions, {v['per_element']} an element, "
                  f"FCHK {v['FCHK']}, CALL {v['CALL']}")
        for k, v in res["shapes"].items():
            print(f"  {k}: " + ", ".join(f"{p} {ms:.4f} ms" for p, ms in v.items()))
        for k, v in res["sums"].items():
            print(f"  sum over one {k} encode: " + ", ".join(f"{p} {ms:.3f} ms" for p, ms in v.items()))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
