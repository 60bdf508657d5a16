#!/usr/bin/env python3
"""Drive the PyTorch port (``nawc_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its seconds:

0. card: name, device count, power limit, whether matplotlib is present
   (the CLIs' PNGs); exit 1 without a CUDA device;
1. build: one ``nvcc`` for each ``nawc_tpu_torch/csrc/*.cu``, all started
   together, linked into the git-ignored ``build/``, printing what
   ``-Xptxas -v`` reports; the draw kernel's and the Snake kernel's
   functions must have no stack frame and no spills, the draw's normal
   instantiation's SASS (by ``cuobjdump -sass``) no float64 conversion or
   arithmetic, and each Snake kernel's opcodes (the range checks, FCHK,
   and the calls among them) and SASS instructions per element are
   printed; the stride-1 and the depthwise convolution kernels' functions
   must have no stack frame and no spills;
2. kernels: each op with a hand-written kernel against its plain PyTorch
   version on the card, at the main path's shapes and at odd shapes (codes
   by the near-tie rule of ``nawc_tpu_torch/ops/parity.py``; sswm also at
   T below the largest roll, T = 10 and 1001, B = 1 and 3, K = 64, Gaussian
   patterns, and twice on the same inputs for bit-identical z, and its
   gradient through the kernel against the plain one; the fused encode also
   at bench.py's unpadded T' = 188), with the
   op's device time per call (its kernels' summed durations under
   ``torch.profiler``, its wrapper's preparation included, and kernel by
   kernel) beside the plain
   version's, their eager wall times, the least time the card could take
   and, for sswm, one ``torch.mm`` of the same contraction as a yardstick;
   and the keyed-draw kernel (``csrc/jaxrand.cu``) bit for bit against the
   numpy replica: the uncertainty run's 20.48 M normals, the sweep's
   (32, 32000) normals and uniforms and vorbis's dither, odd lengths, a
   flat index past one block, keys from split and fold_in, and the
   attacks' uniform ranges, each with its device time, the replica's host
   time and the bound; and the normal draw's transform over its whole
   domain, all 2^23 uniforms, through the bits entry; and the Snake kernel
   (``csrc/snake.cu``): its divisions against ``__fdiv_rn`` (by 6, 20 and
   42 over all 2^32 float32 patterns, by the per-channel den over all 2^32
   numerators for 16 dens, over every den of [1, 2) against 2^16 seeded
   numerators and over every bfloat16 pair, each count of differing
   quotients 0, with its time), then both passes at the five shapes of one 16 x 4 s encode, of
   the codec-latent embed's 4 x 2 s encode and of the trainers' 16 x 32768
   encode, in float32 and bfloat16: the forward bit for bit the plain
   version, the backward's dx and d log_alpha against autograd of the
   plain forward, dx bit for bit its formula, two runs bit for bit, device
   and wall ms of each pass beside the plain version's and the bound, and
   their sums over each encode beside phase 1's instructions per element;
   and the stride-1 convolution kernels (``csrc/same_conv.cu``) at the 50
   convolutions of one bfloat16 16 x 4 s encode and decode against their
   plain version (every output within its ulp bar, two runs bit for bit),
   with their device time beside the plain version's, cuDNN's bfloat16
   ``F.conv1d`` and the bound, then the k 1 GEMM path (``k1conv``) at SNAC
   44 kHz's 29 k 1 convs, then Mimi's 16 x 30 s encode and decode: its 10
   causal k 3 / k 7 convs on the stencil kernel at their left pad and its
   8 k 1 convs on the GEMM path, the sums of each codec's stencil convs and
   of its k 1 convs apart; and the depthwise convolution kernel
   (``csrc/dwconv.cu``) likewise at the 26 depthwise convolutions of one
   SNAC 44 kHz 16 x 4 s encode and decode, beside ATen's grouped bfloat16
   ``F.conv1d``;
3. weights: ``checkpoints/codec_24k.msgpack`` read by the port's own reader,
   converted in memory and moved to the card;
4. main path at full width: ``entry`` (embed -> codec round-trip -> detect)
   on 16 clips x 4 s at 24 kHz, then ``codec.encode``, held against the same
   calls with the plain versions; every kernel of the path (the Snake's
   forward included) must have launched;
5. serving: ``WatermarkService`` embeds and detects 6 ragged requests;
6. timing: embed, encode, detect and the three together per 16 x 4 s batch
   by CUDA events over chained iterations (a record, not a benchmark);
7. profile: one step under ``torch.profiler``, the device's busy share and
   the kernels that take the most device time;
8. sweep: the survivability sweep on seeded speech-like clips and the
   trained codec, each run once with the kernels and once with the plain
   versions: ``run_robustness`` of the spread-spectrum watermark over the
   attack suite (16 clips x 4 s at 16 kHz in 2 s chunks, without and with
   sync detection), ``run_combined`` of spread_spectrum and chunked (16 x
   2 s), ``run_robustness`` of the psychoacoustic watermark (8 x 4 s at
   44.1 kHz) and its ``discover_message_length`` (K = 768).  Every
   ``whiten_correlate`` and ``nearest_codebook`` call of the kernel runs is
   held against its plain version on the same inputs; the rows of the two
   runs must agree (bits and decisions equal except where a near-tie was
   found), no row may carry an error, and the kernels must launch in the
   sweep; every keyed draw of the noise attacks runs on the card and is
   held bit for bit against the plain run's (the replica's).  It prints
   each run's wall time, the slowest attacks, the draws' device time and
   the device time of one robustness run by kind;
9. bf16 codec: the trained codec in bfloat16 on the main path's batch: code
   agreement with the float32 codec per level (JAX's bar: above 0.94 on
   average), decode rel-rms against float32 (under 0.1), and the time per
   batch of embed + bf16 encode + detect beside phase 6's float32 figure;
   the encode and decode launch the stride-1 convolution kernel 50 times;
10. codec-latent watermarks: ``run_combined`` of semantic_pca,
   semantic_cluster, semantic_random and token_green at 200 of their
   operating point's 300 Adam steps on 4 seeded speech-like clips of 2 s at 16 kHz,
   resampled to the codec's 24 kHz as ``cli/benchmark.py`` does, with the
   24 kHz suite.  Every ``rvq_encode_fused`` and ``nearest_codebook`` call
   is held against its plain version on its own inputs (so cuDNN's
   nondeterministic backward, which may move the marked audio between
   runs, cannot hide or fake a difference), and token_green's score is held
   against the plain route's on the same marked audio.  Per method: the
   embed's wall time and ms per Adam step, peak memory of one embed, the
   device time of one step by kind, marked and clean scores, SI-SNR,
   detector pass rate and survival under ``dac`` and ``encodec``; no row
   may be an ERROR row;
11. PGD: ``pgd_attack`` against the spread-spectrum score at ``cli/pgd.py``'s
   defaults (8 x 2 s at 16 kHz, 100 steps, eps 0.02, lr 0.001): the score
   before and after, the SI-SNR, the sswm launches (one forward per step),
   and one step's gradient through the kernel against the plain route's;
12. neural watermark: the trained ``checkpoints/neural_wm.msgpack`` at
   ``NeuralWMConfig()`` on 16 speech-like clips x 4 s at 16 kHz: embed,
   ``detect`` and ``detect_sync`` (clean-channel bit accuracy, presence on
   marked and clean audio, a 200-sample delay) with ms per batch, then
   ``run_robustness`` at ``cli/robustness.py``'s defaults without and with
   sync, kernels against plain (every lookup of ``dac`` held against plain
   on its own inputs, the rows equal, no ERROR row), the sync run on 7 of
   the 19 attacks (``SYNC_ATTACKS``);
13. training: ``train_wm`` (16 x 1 s, 24 steps, the trained codec as
   ``--codec_ckpt`` on every 3rd step), ``train_codec`` (16 x 32768 at
   24 kHz, 5 steps, a dead-code revival, 2 steps) and ``train_gan`` (16 x
   32768, the trained codec, 3 steps) at the CLI defaults on speech-like
   WAV files: each step's float metrics within 1e-5 relative of the same
   step from a copy of the same state under the plain versions, every
   lookup (codebooks moved by the optimiser and by the revival included)
   equal to plain on a copy of its inputs, ms per step, peak memory, the
   device split by kind and the losses; the GAN's encoder and quantizer
   bit for bit unchanged, and a checkpoint written by ``save_params`` read
   back equal; the watermark trainer's augmentation draws bit for bit the
   replica; then ``train_wm``, ``train_codec`` and ``train_gan`` as a
   user runs them, 2 steps each at their defaults, and ``eval_codec`` on
   the fine-tuned codec;
14. interpretability: the probe CLI for spread_spectrum and semantic_pca as
   ``benchmark --probe`` spawns it, then the perturbation (16 x 2 s),
   uncertainty (16 x 2 s, 20 MC samples), ablation (8 x 2 s,
   spread_spectrum and chunked), manifold (8 x 2 s at 24 kHz,
   spread_spectrum and semantic_pca at 100 of its 300 Adam steps) and PGD
   CLIs (8 x 2 s, each of the six modes: 100 steps, eps 0.02, 128 PCA
   components, head 60) at their defaults on speech-like WAV files, the
   input gradient and 16-step integrated gradients of the spread-spectrum
   score on the main path's batch (each against the plain route's by the
   PGD rule), the saliency spectrogram and its top frames, and the stats
   CLI on phase 8's results.  Every kernel call is held against its plain
   version on its own inputs (each draw bit for bit against the replica,
   the uncertainty's against phase 2's of the same key and shape); all
   four kernels must launch; with matplotlib the CLIs' PNGs must exist and
   be non-empty, without it none may, and a line names them.  It prints
   the seconds of each CLI and saliency call, the device time of each
   CLI's draws, the peak memory of the saliency calls and of ``exp_c``,
   and the device split of one IG step, its device events beside the
   kernels it launched;
15. quality and parallel: ``scipy.signal`` must import (the host metrics
   resample with it); the quality CLI in-process at its defaults
   (``--watermark spread_spectrum`` on 16 speech-like WAVs of 2 s at 16
   kHz, ``--results_dir`` over the artifact tree that ``save_artifacts``
   writes from phase 8's 16 x 4 s clips, marked and attacked by ``dac``
   (each clip's ``comparison.png`` where matplotlib is present, none
   without it), and ``--summarize_dir``): seconds per run, the host's
   share (exact STOI and PESQ), the column means, ``pesq_impl``; every
   metric finite, PESQ within the proxy's range, exact STOI 1.0 on
   identical pairs.  Then a
   process group of one over NCCL: ``make_sharded_eval`` on the main
   path's batch equal to the entry's outputs bit for bit, one
   ``make_codec_train_step(..., mesh=)`` step (DDP) at ``train_codec``'s
   defaults (16 x 32768, the trained weights) with every metric within
   1e-5 of the meshless step from the same state, ``tp_nearest_codebook``
   over the trained level-0 codebook equal to ``nearest_codebook``, and the
   shard combine over 2, 4 and 8 slices of it (each slice through the
   lookup kernel) equal to the whole lookup but at near-ties; every sswm
   and lookup call held against plain, both kernels launched; each
   stage's device ms from the recorder's spans (``utils/profiling``) and
   one ``trace()`` of the sharded evaluation, reporting whether the trace
   names the kernels and the program's spans;
16. SNAC bf16 main path: ``entry(codec)``'s ``fn`` with the SNAC 44 kHz
   bfloat16 codec that the benchmark cell ``snac44k-roundtrip-bf16`` runs
   (its configuration's codec block, weights drawn on the card by
   ``port_bench/weights_snac.py``) on 16 clips x 4 s at 44.1 kHz: one call,
   counted from zero after a warm call, must launch the depthwise kernel 26
   times and the stride-1 kernel 29 times; its ms per call;
17. Mimi bf16 main path: ``entry(codec)``'s ``fn`` with the Mimi bfloat16
   codec that the benchmark cell ``mimi-roundtrip-bf16`` runs (its
   configuration's codec block, weights drawn on the card by
   ``port_bench/weights_mimi.py``) on 16 clips x 30 s at 24 kHz: one call,
   counted from zero after a warm call, must launch the stencil kernel 10
   times (its causal k 3 / k 7 convs) and the k 1 GEMM path 8 times; its
   ms per call.

The line before the last is the ``{"kernels": [...]}`` record; the last line
is ``{"ok": true, "device": {...}}``.  Any failed check raises, so the script
exits non-zero and prints no result.  It uses float32 throughout, with TF32
off for cuDNN and cuBLAS (cuDNN convolutions default to TF32, which would
break parity with the JAX reference), and imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

from nawc_tpu_torch.attacks import build_suite, codec_roundtrip, pgd_attack  # noqa: E402
from nawc_tpu_torch.cli.common import build_watermarkers  # noqa: E402
from nawc_tpu_torch.codec import api as codec_api  # noqa: E402
from nawc_tpu_torch.codec import model as codec_model  # noqa: E402
from nawc_tpu_torch.codec import load_codec  # noqa: E402
from nawc_tpu_torch.codec.convert import flax_to_state_dict, state_dict_to_flax  # noqa: E402
from nawc_tpu_torch.codec.model import ResidualVQ  # noqa: E402
from nawc_tpu_torch.entry import entry, flagship  # noqa: E402
from nawc_tpu_torch.dsp.resample import resample  # noqa: E402
from nawc_tpu_torch.eval import run_combined, run_robustness, si_snr  # noqa: E402
from nawc_tpu_torch.models import (  # noqa: E402
    ChunkedWM, PsychoacousticWM, SpreadSpectrumWM, bit_accuracy, random_message)
from nawc_tpu_torch.models import spread_spectrum as ss_module  # noqa: E402
from nawc_tpu_torch.models.spread_spectrum import _NULL_OFFSETS  # noqa: E402
from nawc_tpu_torch.attacks.pgd import _grad  # noqa: E402
from nawc_tpu_torch.eval import figures  # noqa: E402
from nawc_tpu_torch.ops import _lib, parity, rvq, rvq_fused, sswm  # noqa: E402
from nawc_tpu_torch.ops import jaxrand as keyed  # noqa: E402
snake_ops = importlib.import_module("nawc_tpu_torch.ops.snake")  # the module; ops.snake is the op
from nawc_tpu_torch.runtime import WatermarkService  # noqa: E402
from nawc_tpu_torch.tools import snake_times  # noqa: E402
from nawc_tpu_torch.train.adversarial import (  # noqa: E402
    decoder_only_tx, init_discriminators, make_gan_train_step)
from nawc_tpu_torch.train.codec_train import (  # noqa: E402
    CodecTrainState, init_codec_train, make_codec_train_step, make_optimizer, revive_dead_codes,
    speech_batches, trainable_codec)
from nawc_tpu_torch.train.optim import AdamW  # noqa: E402
from nawc_tpu_torch.train.wm_train import init_wm_train, make_wm_train_step  # noqa: E402
from nawc_tpu_torch.utils import jaxrand  # noqa: E402
from nawc_tpu_torch.utils.audio_io import write_wav  # noqa: E402
from nawc_tpu_torch.utils.checkpoint import load_params, save_params, tree_leaves  # noqa: E402
from nawc_tpu_torch.utils.config import CodecConfig, NeuralWMConfig, SpreadSpectrumConfig  # noqa: E402

CHECKPOINT = REPO / "checkpoints" / "codec_24k.msgpack"
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores, TF32 FLOP/s on the tensor cores, fp64 FLOP/s
# outside the tensor cores; int32 operations/s from the Hopper white paper's
# SM (64 INT32 lanes) x 132 SMs x the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_F64_FLOPS = 34e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# an FMA-unit instruction (add, multiply or fused multiply-add) is one
# operation at half the FLOP/s, which count a fused multiply-add as two
PEAK_F32_INSTR = PEAK_F32_FLOPS / 2
PEAK_F64_INSTR = PEAK_F64_FLOPS / 2
# the draw kernel's SASS functions, and the float64 opcodes its normal path must not hold
JAXRAND_SASS = {"uniform": "keyed_kernelILb0E", "normal": "keyed_kernelILb1E",
                "normal_of_bits": "normal_of_bits_kernel"}
F64_OPCODES = ("F2F.F64.F32", "F2F.F32.F64", "DMUL", "DADD", "DFMA")
# the kernels of the main path (phase 4); the draw kernel's own path is the
# sweep (phase 8), the Snake backward's the trainers (phase 13), the
# stride-1 convolution's the bfloat16 codec (phase 9), the depthwise
# convolution's the SNAC bfloat16 main path (phase 16)
MAIN_KERNELS = ("whiten_correlate", "nearest_codebook", "rvq_encode_fused", "snake")
BF16_ONLY = ("same_conv", "k1conv", "dwconv")  # launched by bfloat16 codecs only (dwconv: SNAC's)
LAUNCHES_ON = {"jaxrand": "sweep (phase 8)", "snake_backward": "training (phase 13)",
               "same_conv": "bf16 codec (phase 9)", "k1conv": "SNAC bf16 main path (phase 16)",
               "dwconv": "SNAC bf16 main path (phase 16)"}
Z_TOL = 1e-4       # whiten_correlate z, kernel vs plain (one TF32 pass would miss it)
BIT_Z_MIN = 1e-2   # bits must agree wherever |z| exceeds this
MARKED_TOL = 1e-5
PRESENCE_TOL = 1e-3
BATCH, SECONDS, SR = 16, 4, 24_000
PROFILE_IDLE_S = 0.05  # a profiler window's idle before its calls (device_events)


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    print(f"== phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of `fn` by CUDA events over `iters` back-to-back
    eager calls: for an op of a few small launches, the host's launch rate
    sets this time, not the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_events(fn, calls: int = 1, idle_s: float = PROFILE_IDLE_S) -> list:
    """The device-side events (kernels, copies) of `calls` calls of `fn`,
    by ``torch.profiler``, summed per name.  The window idles `idle_s`
    before the calls: on the H100 a window that opens on the calls now and
    then lacks the device records of its first milliseconds (PERF.md §6)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        time.sleep(idle_s)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_ms(fn, calls: int = 10) -> float:
    """Device time per call of `fn`: the summed durations of its kernels,
    without the gaps in which the card waits for the host."""
    fn()
    torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in device_events(fn, calls)) / 1e3 / calls


def chained_ms(step, x0: torch.Tensor, warmup: int = 2, iters: int = 5) -> float:
    """ms per call of `step: x -> x_next` by CUDA events over `iters`
    chained calls (each input depends on the previous output)."""
    x = x0
    for _ in range(warmup):
        x = step(x)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    x = x0 * 1.001
    start.record()
    for _ in range(iters):
        x = step(x)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, tf32_flops: float = 0.0) -> tuple[float, str]:
    """-> (least ms on the card, "bytes" or "operations"); `flops` run in
    f32 on the CUDA cores, `tf32_flops` on the tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_F32_FLOPS + tf32_flops / PEAK_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def by_kind(events) -> dict[str, float]:
    """Device ms of profiler events grouped by kind: the port's kernels,
    convolutions, elementwise kernels, FFTs and the rest."""
    groups: dict[str, float] = {}
    for e in events:
        kname = e.key.lower()
        group = ("nawc kernels" if any(k in kname for k in ("sswm_", "nearest_codebook",
                                                             "rvq_encode", "jaxrand", "snake_"))
                 else "convolution" if any(k in kname for k in ("conv", "xmma", "implicit_gemm"))
                 else "elementwise" if "elementwise" in kname
                 else "fft" if "fft" in kname
                 else "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    return groups


def timed_pair(label: str, fn) -> tuple[float, float]:
    """-> (device ms of the op `fn`, device ms of `fn` with the plain
    versions) on the same inputs, the wrapper's own preparation included in
    both; prints the eager wall times beside them, and the op's device time
    kernel by kernel."""
    ms, wall = device_ms(fn), wall_ms(fn)
    calls = 10
    for e in sorted(device_events(fn, calls), key=lambda e: -e.self_device_time_total):
        print(f"  {label}: {e.self_device_time_total / 1e3 / calls:.4f} ms per call  {e.key[:90]}")
    with _lib.plain_versions():
        plain_ms, plain_wall = device_ms(fn), wall_ms(fn)
    print(f"{label}: device {ms:.4f} ms per call, plain {plain_ms:.4f} ms; "
          f"eager wall {wall:.4f} ms, plain {plain_wall:.4f} ms")
    return ms, plain_ms


# ------------------------------------------------------------------ phase 2

def check_sswm(dev) -> dict:
    rec = {}
    # the main path's shape, two odd shapes, then T below the largest
    # roll (offsets mod T) and below the statistics' 16 rows, T of a clip
    # over 5.33 s (the statistics' long-T loop), B = 1 and 3, K = 64 and
    # Gaussian patterns
    cases = [(16, 376, 367, 16, "sign"), (3, 77, 130, 16, "sign"), (8, 250, 450, 60, "sign"),
             (16, 40, 367, 16, "sign"), (5, 10, 367, 16, "sign"), (4, 1001, 367, 16, "sign"),
             (1, 376, 367, 16, "sign"), (3, 376, 367, 16, "gauss"), (16, 376, 367, 64, "gauss")]
    for b, t, w, k, kind in cases:
        rng = np.random.default_rng(0)
        r = torch.as_tensor(rng.standard_normal((b, t, w)) * 0.3, dtype=torch.float32, device=dev)
        p = torch.as_tensor(rng.standard_normal((k, t, w)), dtype=torch.float32, device=dev)
        if kind == "sign":
            p = torch.sign(p)
        z_k = sswm.whiten_correlate(r, p, _NULL_OFFSETS)
        with _lib.plain_versions():
            z_p = sswm.whiten_correlate(r, p, _NULL_OFFSETS)
        z_ref = sswm.whiten_correlate_reference(r, p, _NULL_OFFSETS)
        err = float((z_k - z_p).abs().max())
        err_ref = float((z_k - z_ref).abs().max())
        sure = z_p.abs() > BIT_Z_MIN
        shape = (b, t, w, k, kind)
        check(err <= Z_TOL, f"sswm {shape}: |z - plain| {err} > {Z_TOL}")
        check(bool(((z_k > 0) == (z_p > 0))[sure].all()), f"sswm {shape}: bits differ")
        print(f"sswm B,T,W,K={shape}: max|z - plain| {err:.3g}, "
              f"max|z - reference| {err_ref:.3g}")
        if shape == (16, 376, 367, 16, "sign"):  # the main path's shape: time it
            again = sswm.whiten_correlate(r, p, _NULL_OFFSETS)
            check(torch.equal(z_k, again), "sswm: two calls on the same inputs differ")
            print("sswm: two calls give bit-identical z")
            ms, plain_ms = timed_pair("whiten_correlate main shape",
                                      lambda: sswm.whiten_correlate(r, p, _NULL_OFFSETS))
            nv = 1 + len(_NULL_OFFSETS)
            # yardstick: one torch.mm of the scaled residual (B, T*W) against
            # the prebuilt rolled stack (T*W, NV*K), f32 without TF32
            scale, shift = sswm._scale_shift(r)
            rs = (r * scale - shift).reshape(b, t * w)
            stack = sswm._pattern_stack(p, _NULL_OFFSETS).reshape(nv * k, t * w).T.contiguous()
            lib_ms = device_ms(lambda: torch.mm(rs, stack))
            bms, by = bound(*sswm.bound_counts(b, t, w, k, nv))
            print(f"whiten_correlate bound {bms:.4f} ms ({by}); library torch.mm {lib_ms:.4f} ms")
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=lib_ms)
            check_sswm_gradient(r, p)
    # the sweep's shapes (phase 8): 32 chunks of 2 s at 16 kHz; the
    # psychoacoustic detector on 16 chunks of 2 s at 44.1 kHz (K = 60) and
    # its message-length discovery on 8 clips of 4 s (K = 768)
    for b, t, w, k in [(32, 126, 358, 16), (16, 174, 427, 60), (8, 346, 427, 768)]:
        rng = np.random.default_rng(4)
        r = torch.as_tensor(rng.standard_normal((b, t, w)) * 0.3, dtype=torch.float32, device=dev)
        p = torch.sign(torch.as_tensor(rng.standard_normal((k, t, w)), dtype=torch.float32,
                                       device=dev))
        fn = lambda: sswm.whiten_correlate(r, p, _NULL_OFFSETS)  # noqa: E731
        z_k = fn()
        with _lib.plain_versions():
            z_p = fn()
        err = float((z_k - z_p).abs().max())
        check(err <= Z_TOL, f"sswm {(b, t, w, k)}: |z - plain| {err} > {Z_TOL}")
        ms, plain_ms = timed_pair(f"whiten_correlate sweep shape {(b, t, w, k)}", fn)
        bms, by = bound(*sswm.bound_counts(b, t, w, k, 1 + len(_NULL_OFFSETS)))
        print(f"whiten_correlate {(b, t, w, k)}: max|z - plain| {err:.3g}, bound {bms:.4f} ms ({by})")
        del r, p, z_k, z_p
    return rec


def check_sswm_gradient(r0: torch.Tensor, p0: torch.Tensor) -> None:
    """d(sum z * w)/dr and /dp through the kernel's route against the plain
    version's: the kernel's backward is the plain VJP on the same r, p and
    w, so the two must be equal."""
    w = torch.as_tensor(np.random.default_rng(3).standard_normal((r0.shape[0], p0.shape[0])),
                        dtype=torch.float32, device=r0.device)

    def grads():
        r, p = r0.clone().requires_grad_(True), p0.clone().requires_grad_(True)
        (sswm.whiten_correlate(r, p, _NULL_OFFSETS) * w).sum().backward()
        return r.grad, p.grad

    got = grads()
    with _lib.plain_versions():
        want = grads()
    errs = [float((g - h).abs().max()) for g, h in zip(got, want)]
    print(f"whiten_correlate gradient through the kernel vs plain: max|d/dr| diff {errs[0]:.3g}, "
          f"max|d/dp| diff {errs[1]:.3g} (scale {float(want[0].abs().max()):.3g}, "
          f"{float(want[1].abs().max()):.3g})")
    check(all(torch.equal(g, h) for g, h in zip(got, want)),
          "whiten_correlate: the kernel's gradient differs from the plain version's")


def check_nearest_codebook(dev) -> dict:
    rng = np.random.default_rng(1)
    cb = torch.as_tensor(rng.standard_normal((4096, 8)), dtype=torch.float32, device=dev)
    # one codec round-trip of the 16 x 4 s batch looks up 16*48, 16*96 and
    # 16*192 frames; the odd cases are a ragged N and a padded D
    zs = [torch.as_tensor(rng.standard_normal((n, 8)), dtype=torch.float32, device=dev)
          for n in (768, 1536, 3072)]
    odd = [(torch.as_tensor(rng.standard_normal((1001, 5)), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.standard_normal((300, 5)), dtype=torch.float32, device=dev))]
    mism = frames = 0
    err = 0.0
    for z, c in [(z, cb) for z in zs] + odd:
        m, f, g = parity.compare_lookup(rvq.nearest_codebook(z, c), z, c)
        mism, frames, err = mism + m, frames + f, max(err, g)
    parity.check_share(mism, frames, "nearest_codebook")
    print(f"nearest_codebook: {mism} of {frames} codes differ (all near-ties); "
          f"max score gap of a differing pick {err:.3g}")
    ms, plain_ms = timed_pair("nearest_codebook, the 3 lookups of one round-trip",
                              lambda: [rvq.nearest_codebook(z, cb) for z in zs])
    nb = fl = 0.0
    for z in zs:
        b_, f_ = rvq.bound_counts(z.shape[0], 4096, 8)
        nb, fl = nb + b_, fl + f_
    bms, by = bound(nb, fl)
    print(f"nearest_codebook bound {bms:.4f} ms ({by})")
    # no single PyTorch call computes a cosine argmax with first-index ties
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def random_quantizer(cfg: CodecConfig, dev, seed: int) -> ResidualVQ:
    """A residual VQ with random float32 tables drawn from numpy."""
    rng = np.random.default_rng(seed)
    q = ResidualVQ(cfg)
    with torch.no_grad():
        for prm in q.parameters():
            fan = prm.shape[-1] if prm.ndim > 1 else 1
            prm.copy_(torch.as_tensor(rng.standard_normal(tuple(prm.shape)) / np.sqrt(fan),
                                      dtype=torch.float32))
    return q.to(dev).requires_grad_(False)


def check_rvq_fused(dev, quantizer, cases, label: str) -> dict:
    strides = CodecConfig().vq_strides
    rec = {}
    for b, t in cases:
        rng = np.random.default_rng(2)
        z = torch.as_tensor(rng.standard_normal((b, t, 768)), dtype=torch.float32, device=dev)
        got = rvq_fused.rvq_encode_fused(z, quantizer, strides)
        mism, frames, gap = parity.compare_rvq(got, z, quantizer, strides)
        print(f"rvq_encode_fused ({label}) B,T={(b, t)}: {mism} of {frames} codes differ "
              f"(all near-ties); max score gap of a differing pick {gap:.3g}")
        if (b, t) == (BATCH, 192):  # the main path's shape: time it
            again = rvq_fused.rvq_encode_fused(z, quantizer, strides)
            check(all(torch.equal(x, y) for x, y in zip(got, again)),
                  "rvq_encode_fused: two calls on the same inputs differ")
            ms, plain_ms = timed_pair("rvq_encode_fused main shape",
                                      lambda: rvq_fused.rvq_encode_fused(z, quantizer, strides))
            bms, by = bound(*rvq_fused.bound_counts(b, t, 768, 8, 4096, strides))
            print(f"rvq_encode_fused bound {bms:.4f} ms ({by})")
            rec = dict(max_abs_err=gap, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                       library_ms=None)
    return rec


def draw_bound(kind: str, key: np.ndarray, shape: tuple[int, ...], dev) -> tuple[float, str]:
    """-> (least ms on the card, "bytes" or "operations") for one draw: the
    output written once against the hash's int32 work, the float64
    instructions and the float32 ones, each on its own unit (the units run
    side by side, so the slowest of them bounds the operations).  A normal draw's
    log1p branch depends on the data: the count is this draw's, from the
    uniform it transforms (|u|^2 < sqrt(2) - 1 takes the rational branch)."""
    n = int(np.prod(shape))
    rational = 0
    if kind == "normal":
        u = keyed.uniform(key, shape, dev, keyed._NORMAL_LO, keyed._NORMAL_HI)
        rational = int(((u * u) < np.float32(0.41421356237309504880)).sum())
    nb, i32, f64, f32 = keyed.bound_counts(n, kind == "normal", rational)
    t_bytes = nb / PEAK_BYTES_PER_S * 1e3
    t_ops = max(i32 / PEAK_INT32_OPS, f64 / PEAK_F64_INSTR, f32 / PEAK_F32_INSTR) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def replica(kind: str, key: np.ndarray, shape, lohi=()) -> np.ndarray:
    shape = tuple(int(s) for s in shape)
    return jaxrand.normal(key, shape) if kind == "normal" else jaxrand.uniform(key, shape, *lohi)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_jaxrand(dev) -> dict:
    """The draw kernel against the numpy replica, bit for bit: the
    uncertainty run's 20.48 M normals, the sweep's (32, 32000) normal and
    uniform and vorbis's dither, odd lengths and a flat index past one
    block, keys from split and fold_in, and the uniform ranges of the
    attacks (eq's centres, widths and +-depth_db gains, time_jitter's
    +-1) and of the watermark trainer's scale.  -> the uncertainty shape's
    record, and the draws held here by (kind, key, shape, range) for
    phase 14."""
    k0 = jaxrand.prng_key(0)
    ks = jaxrand.split(k0, 3)
    cases = [("normal", jaxrand.prng_key(1), (20, 32, 32_000), ()),  # uncertainty: 20 MC x 32 clips x 2 s
             ("normal", k0, (32, 32_000), ()),                        # the sweep's noise attacks
             ("uniform", k0, (32, 32_000), (0.0, 1.0)),
             ("uniform", k0, (32, 126, 513), (-0.5, 0.5)),           # vorbis's dither
             ("normal", ks[1], (3, 1001), ()),                        # odd length
             ("normal", jaxrand.fold_in(k0, 7), (257,), ()),          # one past a block of 256
             ("normal", k0, (4800,), ()),                             # reverb's IR at 16 kHz
             ("uniform", ks[0], (5,), (0.05, 0.9)),                   # eq's centres, widths, gains
             ("uniform", ks[1], (5,), (0.02, 0.15)),
             ("uniform", ks[2], (5,), (-6.0, 6.0)),
             ("uniform", jaxrand.fold_in(k0, 3), (32, 32), (-1.0, 1.0)),  # time_jitter
             ("uniform", ks[2], (16, 1), (0.76, 1.24))]               # the wm trainer's scale
    rec, held = {}, {}
    counts = {"normal": 0, "uniform": 0}
    for kind, key, shape, lohi in cases:
        fn = getattr(keyed, kind)
        got = fn(key, shape, dev, *lohi)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = torch.from_numpy(replica(kind, key, shape, lohi)).to(dev)
        host_ms = 1e3 * (time.perf_counter() - t0)
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        check(got.shape == want.shape and differ == 0,
              f"jaxrand {kind} {shape} {lohi}: {differ} draws differ from the replica")
        counts[kind] += got.numel()
        err = float((got - want).abs().max())
        ms = device_ms(lambda: fn(key, shape, dev, *lohi))
        bms, by = draw_bound(kind, key, shape, dev)
        line = (f"jaxrand {kind} {shape} range {lohi or '(normal)'}: bit for bit the replica; device "
                f"{ms:.4f} ms, replica on the host {host_ms:.2f} ms, bound {bms:.4f} ms ({by})")
        if shape == (20, 32, 32_000):
            randn_ms = device_ms(lambda: torch.randn(shape, device=dev))
            line += f"; torch.randn of the shape (another generator) {randn_ms:.4f} ms"
            rec = dict(max_abs_err=err, ms=ms, plain_ms=host_ms, bound_ms=bms, bound_by=by,
                       library_ms=None)
            held[(kind, tuple(int(k) for k in key), shape, tuple(lohi))] = got
        print(line)
    print(f"jaxrand: {counts['normal']} normals and {counts['uniform']} uniforms bit for bit the replica")
    check(counts["normal"] >= 10**7, f"jaxrand: fewer than 10^7 normals checked: {counts}")
    check_normal_domain(dev)
    rec["held"] = held
    return rec


def check_normal_domain(dev) -> None:
    """The normal draw's transform on every one of its 2^23 inputs (the
    23-bit mantissas; the low 9 bits, which it drops, set in every 7th)
    through the bits entry, bit for bit the replica's normal_from_bits."""
    bits = np.arange(2**23, dtype=np.uint32) << np.uint32(9)
    bits[::7] |= np.uint32(0x1FF)
    dbits = torch.from_numpy(bits.view(np.int32)).to(dev)
    got = keyed.normal_of_bits(dbits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = jaxrand.normal_from_bits(bits)
    host_ms = 1e3 * (time.perf_counter() - t0)
    differ = np.flatnonzero(got.cpu().numpy().view(np.uint32) != want.view(np.uint32))
    check(differ.size == 0, f"jaxrand normal_of_bits: {differ.size} of 2^23 inputs differ from the "
                            f"replica, first {differ[:4].tolist()}")
    ms = device_ms(lambda: keyed.normal_of_bits(dbits))
    print(f"jaxrand normal_of_bits: all {bits.size} inputs of the normal transform bit for bit the "
          f"replica; device {ms:.4f} ms, replica on the host {host_ms:.2f} ms")


def sass_opcode(line: str) -> str | None:
    """The opcode of one ``cuobjdump -sass`` line
    (``/*0090*/  @P0 DMUL R4, R2, R4 ;  /* 0x... */``), or None."""
    if "*/" not in line or ";" not in line:
        return None
    words = [w for w in line.split("*/", 1)[1].split(";")[0].split() if not w.startswith("@")]
    return words[0] if words else None


def sass_functions(sass: str) -> dict[str, list[str]]:
    """The built library's SASS (``cuobjdump -sass``) -> each function's
    opcodes."""
    out = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        out[name.strip()] = [o for o in map(sass_opcode, body.splitlines()) if o]
    return out


def sass_counts(funcs: dict[str, list[str]]) -> dict[str, dict[str, int]]:
    """The draw kernel's functions -> per function, its instruction count and
    the count of each float64 opcode."""
    out = {}
    for name, ops in funcs.items():
        for label, mangled in JAXRAND_SASS.items():
            if mangled in name:
                out[label] = dict(instructions=len(ops), **{
                    f: sum(o == f or o.startswith(f + ".") for o in ops) for f in F64_OPCODES})
    return out


def ptxas_properties(log: str) -> dict[str, str]:
    """What ``-Xptxas -v`` says of each function: its stack frame and spills."""
    props = {}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties for" in line and i + 1 < len(lines):
            props[line.rsplit(" ", 1)[1]] = lines[i + 1].strip()
    return props


def check_jaxrand_build(funcs: dict[str, list[str]], log: str) -> None:
    """Phase 1's checks of the draw kernel: no stack frame and no spills in
    its functions (``-Xptxas -v``; only on a fresh build, which is when
    nvcc prints it), and no float64 work in the normal path's SASS."""
    props = ptxas_properties(log)
    mine = {n: v for n, v in props.items() if "jaxrand_cu" in n}  # the file's own namespace
    if log:
        check(len(mine) == len(JAXRAND_SASS) and all(
            v.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
            for v in mine.values()), f"jaxrand: ptxas reports {mine}")
        print(f"jaxrand ptxas: {mine}")
    else:
        print("jaxrand ptxas: the library was built before this run; nvcc printed nothing")
    counts = sass_counts(funcs)
    print(f"jaxrand SASS (cuobjdump -sass): {counts}")
    check(set(counts) == set(JAXRAND_SASS), f"jaxrand: SASS functions {sorted(counts)}")
    for label in ("normal", "normal_of_bits"):
        check(all(counts[label][op] == 0 for op in F64_OPCODES),
              f"jaxrand: float64 work in the {label} SASS: {counts[label]}")


class DrawRecorder(contextlib.AbstractContextManager):
    """Replaces ``keyed.normal`` and ``keyed.uniform`` (the draws of the
    attacks, the MC noise, the PCA jamming and the trainer) by wrappers
    that keep each draw's arguments and result and time it on the device
    with CUDA events."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        self.orig = {k: getattr(keyed, k) for k in ("normal", "uniform")}
        for kind, fn in self.orig.items():
            def record(*args, _kind=kind, _fn=fn):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                self.calls.append((_kind, args, out, start, end))
                return out

            setattr(keyed, kind, record)
        return self

    def __exit__(self, *exc):
        for kind, fn in self.orig.items():
            setattr(keyed, kind, fn)

    def device_ms(self, calls=None) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for *_, s, e in (self.calls if calls is None else calls))


def _ident(kind: str, args) -> tuple:
    key, shape, _, *lohi = args
    return kind, tuple(int(k) for k in key), tuple(int(s) for s in shape), tuple(lohi)


def check_draws(calls, held: dict | None = None) -> dict:
    """Every recorded draw bit for bit against the numpy replica, or
    against the draw of the same key, shape and range that phase 2 held
    against it."""
    values = 0
    for kind, args, out, *_ in calls:
        ident = _ident(kind, args)
        want = (held or {}).get(ident)
        if want is None:
            want = torch.from_numpy(replica(kind, args[0], args[1], args[3:])).to(out.device)
        check(same_bits(out, want), f"draw {ident[0]} {ident[2]} {ident[3]} differs from the replica")
        values += out.numel()
    return dict(draws=len(calls), values=values)


def check_draw_pairs(got, want) -> dict:
    """The draws of a kernel run against those of the same run with the
    plain versions (the replica), pair by pair: the same keys, shapes and
    ranges, the same bits."""
    check(len(got) == len(want), f"{len(got)} draws with the kernel against {len(want)} plain")
    values = 0
    for (kg, ag, og, *_), (kw, aw, ow, *_) in zip(got, want):
        check(_ident(kg, ag) == _ident(kw, aw), f"draw {_ident(kg, ag)} against plain {_ident(kw, aw)}")
        check(same_bits(og, ow), f"draw {_ident(kg, ag)[::2]} differs from the replica's")
        values += og.numel()
    return dict(draws=len(got), values=values)


# ------------------------------------------------------------------ the Snake (phases 1, 2)

# one encode's Snakes at CodecConfig(): per encoder block 7 at its (C, T),
# and the final one at (768, T / 512): the main path's 16 x 4 s (bench.py's
# unpadded T), the codec-latent embed's 4 x 2 s (padded to the codec's
# chunk, 49152 samples) and the trainers' 16 x 32768 crops
SNAKE_SETS = {
    f"{BATCH} x {SECONDS} s encode": ((BATCH, 48, 96_000, 7), (BATCH, 96, 48_000, 7),
                                      (BATCH, 192, 12_000, 7), (BATCH, 384, 1_500, 7),
                                      (BATCH, 768, 188, 1)),
    "codec-latent 4 x 2 s encode": ((4, 48, 49_152, 7), (4, 96, 24_576, 7), (4, 192, 6_144, 7),
                                    (4, 384, 768, 7), (4, 768, 96, 1)),
    "trainers' 16 x 32768 encode": ((16, 48, 32_768, 7), (16, 96, 16_384, 7), (16, 192, 4_096, 7),
                                    (16, 384, 512, 7), (16, 768, 64, 1)),
}
SNAKE_DX_TOL = 1e-6    # dx against plain autograd, of the largest |dx| (float32)
SNAKE_DLA_TOL = 1e-5   # d log_alpha against plain autograd, relative (float32)
def bf16_ulp(v: float) -> float:
    return 2.0 ** (np.floor(np.log2(v)) - 7)


def check_snake_build(sass: str, log: str) -> dict[str, dict]:
    """Phase 1's checks of the Snake kernel: no stack frame and no spills in
    any function of ``snake.cu`` (``-Xptxas -v``; only on a fresh build),
    and each of its six kernels' SASS (``snake_times.kernel_sass``): the
    count of each opcode of interest (the range checks, FCHK, are the
    per-channel divisions' IEEE fallbacks in the exact path; the divisions
    by 6, 20 and 42 have none) and the instructions per element of its pass
    loop.  -> ``kernel_sass`` of it."""
    props = ptxas_properties(log)
    mine = {n: v for n, v in props.items() if "snake_cu" in n}
    if log:
        check(len(mine) >= 10 and all(
            v.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
            for v in mine.values()), f"snake: ptxas reports {mine}")
        print(f"snake ptxas: {len(mine)} functions, 0-byte frames, no spills")
    else:
        print("snake ptxas: the library was built before this run; nvcc printed nothing")
    per = snake_times.kernel_sass(sass, snake_times.vectors_of(REPO))
    check(len(per) == 6 and all(c["per_element"] > 0 for c in per.values()),
          f"snake: SASS kernels {per}")
    for label, c in per.items():
        print(f"snake SASS {label}: {c['instructions']} instructions, {c['per_element']} an element in "
              "its pass loop; " + ", ".join(f"{k} {c[k]}" for k in snake_times.OPCODES))
    return per


def trained_dens() -> list[float]:
    """The per-channel divisors of the trained codec's Snakes: the smallest,
    median and largest exp(log_alpha) + 1e-9, in float32 and in bfloat16
    rounding, as the kernel forms them."""
    def leaves(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v)
            elif k == "log_alpha":
                yield np.asarray(v, np.float32).ravel()

    la = torch.from_numpy(np.concatenate(list(leaves(load_params(CHECKPOINT)))))
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        den = (torch.exp(la).to(dtype).float() + torch.tensor(1e-9)).to(dtype).float()
        v = den.sort().values
        out += [float(v[0]), float(v[len(v) // 2]), float(v[-1])]
    return out


def check_snake_divisions(dev) -> None:
    """The Snake kernel's divisions on the card against ``__fdiv_rn``: by 6,
    20 and 42 over all 2^32 float32 patterns; by the per-channel den, in
    the float32 kernels' sequence, over all 2^32 numerators for 16 dens
    (the trained codec's smallest, median and largest in float32 and
    bfloat16 rounding, and 10 seeded ones of exp(N(0, 1)), half rounded to
    bfloat16) and over every den mantissa of [1, 2) against 2^16 seeded
    numerators, and in the bfloat16 kernels' sequence over every bfloat16
    den in [2^-20, 2^20] against all 2^16 bfloat16 numerators.  Every count
    of differing quotients must be 0; prints the counts and the times."""
    for d in (6, 20, 42):
        t0 = time.perf_counter()
        n = snake_ops.check_constant_division(d, dev)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(n["differ"] == 0, f"snake division by {d}: {n['differ']} of 2^32 patterns differ from "
                                f"__fdiv_rn")
        print(f"snake division by {d}: all {n['patterns']} float32 patterns equal __fdiv_rn "
              f"({n['fast']} through fma(v, zh, RN(v zl)), the rest through the float64 product); that "
              f"sequence alone would differ on {n['fast_alone_differ']} finite patterns, all with |v| <= "
              f"{n['fast_alone_max']:.3g}; {ms:.1f} ms")
    rng = np.random.default_rng(18)
    seeded = np.exp(rng.standard_normal(10)).astype(np.float32)
    seeded[5:] = torch.from_numpy(seeded[5:]).to(torch.bfloat16).float().numpy()
    dens = torch.tensor(trained_dens() + seeded.tolist(), dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    n = snake_ops.check_channel_division(dens)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    check(n["differ"] == 0 and n["pairs"] == 16 * 2**32,
          f"snake division by den: {n['differ']} of {n['pairs']} quotients differ from __fdiv_rn")
    print(f"snake division by den {[f'{v:.6g}' for v in dens.tolist()]}: all 2^32 numerators each, "
          f"{n['pairs']} quotients equal __fdiv_rn ({n['fast']} through the Markstein sequence); "
          f"{ms:.1f} ms")
    mant = torch.arange(2**23, dtype=torch.int32, device=dev) | (127 << 23)
    bits = (rng.integers(0, 2, 2**16, dtype=np.uint32) << np.uint32(31)
            | rng.integers(127 - 80, 127 + 80, 2**16, dtype=np.uint32) << np.uint32(23)
            | rng.integers(0, 2**23, 2**16, dtype=np.uint32))
    nums = torch.from_numpy(bits.view(np.float32)).to(dev)
    t0 = time.perf_counter()
    n = snake_ops.check_channel_division(mant.view(torch.float32), nums)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    check(n["differ"] == 0 and n["pairs"] == 2**39,
          f"snake division by den in [1, 2): {n['differ']} of {n['pairs']} quotients differ")
    print(f"snake division by every den in [1, 2) (2^23) against 2^16 seeded numerators: {n['pairs']} "
          f"quotients equal __fdiv_rn ({n['fast']} through the Markstein sequence); {ms:.1f} ms")
    every_bf16 = (torch.arange(2**16, dtype=torch.int32, device=dev) << 16).view(torch.float32)
    bf16_dens = every_bf16[(every_bf16 >= 2.0**-20) & (every_bf16 <= 2.0**20)].contiguous()
    t0 = time.perf_counter()
    n = snake_ops.check_channel_division(bf16_dens, every_bf16, bfloat16=True)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    check(n["differ"] == 0 and n["pairs"] == bf16_dens.numel() * 2**16,
          f"snake bfloat16 division by den: {n['differ']} of {n['pairs']} quotients differ")
    print(f"snake bfloat16 division by every bfloat16 den in [2^-20, 2^20] ({bf16_dens.numel()}) against "
          f"all 2^16 bfloat16 numerators: {n['pairs']} quotients equal __fdiv_rn ({n['fast']} through "
          f"RN(v yn) and the Markstein step); {ms:.1f} ms")


def snake_scalar_divisors(x: torch.Tensor, la: torch.Tensor) -> torch.Tensor:
    """The plain Snake as it stood before the kernel, dividing by Python
    numbers: on the card eager PyTorch multiplies by their rounded
    reciprocals there, which JAX does not."""
    alpha = torch.exp(la).to(x.dtype)[None, :, None]
    u = alpha.float() * x.float() * (1.0 / np.pi)
    u = u - torch.round(u)
    p = u * np.pi
    p2 = p * p
    s = p * (1.0 - p2 / 6.0 * (1.0 - p2 / 20.0 * (1.0 - p2 / 42.0)))
    return x + (s * s).to(x.dtype) / (alpha + 1e-9)


def snake_case(b: int, c: int, t: int, dtype, dev, seed: int):
    """x at 2 sigma, log alpha at 0.3 sigma, g at 1 sigma, drawn on the
    card by a seeded generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((b, c, t), generator=gen, device=dev) * 2).to(dtype)
    la = torch.randn((c,), generator=gen, device=dev) * 0.3
    g = torch.randn((b, c, t), generator=gen, device=dev).to(dtype)
    return x, la, g


def backward_ms(x: torch.Tensor, la: torch.Tensor, g: torch.Tensor, plain: bool) -> tuple[float, float]:
    """Device ms and eager wall ms of one backward of the Snake (the kernel's,
    or autograd's of the plain version) on a graph built once."""
    xr, lr = x.clone().requires_grad_(), la.clone().requires_grad_()
    with _lib.plain_versions() if plain else contextlib.nullcontext():
        y = snake_ops.snake(xr, lr)

    def fn():
        return torch.autograd.grad(y, (xr, lr), g, retain_graph=True)

    return device_ms(fn), wall_ms(fn, iters=10)


def check_snake_shape(b: int, c: int, t: int, dtype, dev, seed: int, old_formula: bool) -> dict:
    """One shape's checks and times (see ``check_snake``) -> {"f", "fp", "b",
    "bp": device ms per call of the forward, its plain version, the
    backward and autograd's of the plain forward; "err_f", "err_dx"}."""
    tag = "f32" if dtype == torch.float32 else "bf16"
    x, la, g = snake_case(b, c, t, dtype, dev, seed)
    n = x.numel()
    with torch.no_grad():
        got = snake_ops.snake(x, la)
        want = snake_ops.snake_reference(x, la)
    differ = int((got != want).sum())
    err_f = float((got.float() - want.float()).abs().max())
    check(differ == 0, f"snake {tag} {(b, c, t)}: {differ} of {n} outputs differ from plain "
                       f"(max {err_f:.3g})")
    if old_formula:
        with torch.no_grad():
            old = snake_scalar_divisors(x, la)
        moved = got != old
        print(f"snake {tag} {(b, c, t)}: the plain formula with Python-number divisors differs "
              f"from the kernel (JAX's formula) in {int(moved.sum())} of {n} outputs, by up to "
              f"{float((got.float() - old.float()).abs().max()):.3g}; the plain version divides "
              "by device tensors and equals it")
        del old, moved
    with torch.no_grad():
        ms_f, plain_f = timed_pair(f"snake {tag} {(b, c, t)}", lambda: snake_ops.snake(x, la))
    bf, byf = bound(*snake_ops.bound_counts(n, c, x.element_size(), backward=False))

    alpha = torch.exp(la).to(dtype).float()
    xk, lk = x.clone().requires_grad_(), la.clone().requires_grad_()
    dx, dla = torch.autograd.grad(snake_ops.snake(xk, lk), (xk, lk), g)
    xp, lp = x.clone().requires_grad_(), la.clone().requires_grad_()
    with _lib.plain_versions():
        pdx, pdla = torch.autograd.grad(snake_ops.snake(xp, lp), (xp, lp), g)
    del xk, lk, xp, lp
    fdx, _ = snake_ops.snake_backward_reference(x, alpha, g)
    again = snake_ops._backward_cuda(x, alpha, g, True, True)
    once = snake_ops._backward_cuda(x, alpha, g, True, True)
    only_dx, _ = snake_ops._backward_cuda(x, alpha, g, True, False)
    err_dx = float((dx.float() - pdx.float()).abs().max())
    err_dla = float((dla - pdla).abs().max())
    top_dx, top_dla = float(pdx.float().abs().max()), float(pdla.abs().max())
    tol_dx, tol_dla = ((SNAKE_DX_TOL * top_dx, SNAKE_DLA_TOL * top_dla) if tag == "f32"
                       else (bf16_ulp(top_dx), bf16_ulp(top_dla)))
    check(err_dx <= tol_dx and err_dla <= tol_dla,
          f"snake backward {tag} {(b, c, t)}: dx off plain by {err_dx:.3g} (bar {tol_dx:.3g}), "
          f"d log_alpha by {err_dla:.3g} (bar {tol_dla:.3g})")
    check(torch.equal(dx, fdx) and torch.equal(only_dx, fdx),
          f"snake backward {tag} {(b, c, t)}: dx is not its formula's")
    check(torch.equal(again[0], once[0]) and torch.equal(again[1], once[1]),
          f"snake backward {tag} {(b, c, t)}: two runs differ")
    del fdx, again, once, only_dx, pdx
    ms_b, wall_b = backward_ms(x, la, g, plain=False)
    plain_b, plain_wall_b = backward_ms(x, la, g, plain=True)
    bb, byb = bound(*snake_ops.bound_counts(n, c, x.element_size(), backward=True))
    print(f"snake backward {tag} {(b, c, t)}: device {ms_b:.4f} ms per call, plain (autograd) "
          f"{plain_b:.4f} ms; eager wall {wall_b:.4f} ms, plain {plain_wall_b:.4f} ms; bound "
          f"{bb:.4f} ms ({byb}); forward bound {bf:.4f} ms ({byf}); dx off plain {err_dx:.3g} "
          f"of {top_dx:.3g}, d log_alpha {err_dla:.3g} of {top_dla:.3g}; deterministic")
    return dict(f=ms_f, fp=plain_f, b=ms_b, bp=plain_b, err_f=err_f, err_dx=err_dx)


def check_snake(dev, sass: dict[str, dict]) -> dict:
    """The Snake kernel's divisions against ``__fdiv_rn`` over their whole
    domains (``check_snake_divisions``), then the kernels against their
    plain versions at the shapes of the encodes of ``SNAKE_SETS``, in
    float32 and bfloat16: the forward bit for bit; the backward's dx and d
    log_alpha against autograd of the plain forward (float32 by
    SNAKE_DX_TOL and SNAKE_DLA_TOL, bfloat16 within one bfloat16 ulp of the
    largest of each), dx bit for bit the kernel's formula
    ``snake_backward_reference`` on the card (with d alpha wanted and
    not), and two runs bit for bit.  Each with device ms per call, plain
    ms, eager wall and the bound; per encode the sums (7 Snakes a block)
    against their bounds, beside phase 1's instructions per element.
    -> {"snake": record, "snake_backward": record} of the main path's
    float32 encode."""
    check_snake_divisions(dev)
    sums = {}
    for s_i, (label, shapes) in enumerate(SNAKE_SETS.items()):
        for dtype in (torch.float32, torch.bfloat16):
            tag = "f32" if dtype == torch.float32 else "bf16"
            acc = dict(f=0.0, fp=0.0, b=0.0, bp=0.0, err_f=0.0, err_dx=0.0)
            counts = np.zeros((2, 2))  # (forward, backward) x (bytes, operations) of one encode
            for i, (b, c, t, count) in enumerate(shapes):
                r = check_snake_shape(b, c, t, dtype, dev, seed=20 + 10 * s_i + i,
                                      old_formula=(s_i, i) == (0, 0))
                for k in ("f", "fp", "b", "bp"):
                    acc[k] += count * r[k]
                for k in ("err_f", "err_dx"):
                    acc[k] = max(acc[k], r[k])
                counts += count * np.array([snake_ops.bound_counts(b * c * t, c, dtype.itemsize,
                                                                   backward=w) for w in (False, True)])
            (acc["fb"], acc["fby"]), (acc["bb"], acc["bby"]) = (bound(*map(float, counts[w]))
                                                                for w in (0, 1))
            sums[(label, tag)] = acc
            per = {k: sass[f"{d} {tag}"]["per_element"] for k, d in (("f", "forward"), ("b", "backward"))}
            print(f"snake {tag}, the Snakes of one {label}: forward {acc['f']:.3f} ms (plain "
                  f"{acc['fp']:.3f}, bound {acc['fb']:.3f}, {acc['fb'] / acc['f']:.0%} of it; "
                  f"{per['f']:.1f} SASS instructions an element); backward {acc['b']:.3f} ms (plain "
                  f"{acc['bp']:.3f}, bound {acc['bb']:.3f}, {acc['bb'] / acc['b']:.0%}; "
                  f"{per['b']:.1f} SASS instructions an element)")
    f32 = sums[(next(iter(SNAKE_SETS)), "f32")]
    # no single PyTorch call computes the Snake or its gradient
    return {"snake": dict(max_abs_err=f32["err_f"], ms=f32["f"], plain_ms=f32["fp"], bound_ms=f32["fb"],
                          bound_by=f32["fby"], library_ms=None),
            "snake_backward": dict(max_abs_err=f32["err_dx"], ms=f32["b"], plain_ms=f32["bp"],
                                   bound_ms=f32["bb"], bound_by=f32["bby"], library_ms=None)}


# ------------------------------------------------------------------ the stride-1 and depthwise convolutions (phases 1, 2)

def check_clean_build(stem: str, log: str) -> None:
    """Phase 1's check of a convolution kernel: no stack frame and no spills
    in any function of ``<stem>.cu`` (``-Xptxas -v``; only on a fresh
    build)."""
    mine = {n: v for n, v in ptxas_properties(log).items() if f"{stem}_cu" in n}
    if log:
        check(len(mine) >= 1 and all(
            v.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
            for v in mine.values()), f"{stem}: ptxas reports {mine}")
        print(f"{stem} ptxas: {len(mine)} functions, 0-byte frames, no spills")
    else:
        print(f"{stem} ptxas: the library was built before this run; nvcc printed nothing")


def device_ms_retried(fn, tries: int = 3) -> float:
    """``device_ms``, taken again where a profiler window lost its events
    and read 0 (§7 of PERF.md: the profiler now and then drops a window's
    first records)."""
    for _ in range(tries):
        ms = device_ms(fn)
        if ms > 0:
            break
    check(ms > 0, f"{tries} profiler windows read no device time")
    return ms


def _same_conv_row(dev, seed: int, c_in, c_out, k, d, left, residual, t, bias=True) -> dict:
    """One stride-1 conv of the kernels of ``csrc/same_conv.cu`` on a batch
    of 16 at T = `t`, padded by `left` zeros on the left and d (k - 1) -
    `left` on the right: the op against its plain version (the bar of
    :func:`check_same_conv`), two runs bit for bit, and device ms of the op,
    of its plain version and of cuDNN's bfloat16 ``F.conv1d`` at the same
    padding (a yardstick only; ``F.pad`` first where the padding is
    uneven), and the bound (the larger of its bytes at 3.35 TB/s and FLOPs
    at 989 TFLOP/s).  The op's first call must launch the GEMM path at k 1
    and the stencil kernel at any other k, once.  -> the row."""
    from nawc_tpu_torch.ops import same_conv as sc
    from nawc_tpu_torch.ops.conv import conv1d

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((BATCH, c_in, t), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randn((c_out, c_in, k), generator=gen, device=dev) / (c_in * k) ** 0.5
    b = torch.randn((c_out,), generator=gen, device=dev) * 0.1 if bias else None
    res = torch.randn((BATCH, c_out, t), generator=gen, device=dev).to(torch.bfloat16) if residual else None
    pads = (left, d * (k - 1) - left)
    name = (f"same_conv {c_in}->{c_out} k{k} d{d}{' +res' if residual else ''}{'' if bias else ' no bias'} "
            f"T {t}{'' if pads[0] == pads[1] else f' causal, left pad {left}'}")

    def op(r):  # the conv op at its padding: the kernel, or the plain version under plain_versions
        return conv1d(x, w, b, 1, lambda n: pads, d, 1, r)

    mine, other = (sc._K1, sc._KERNEL) if k == 1 else (sc._KERNEL, sc._K1)
    with torch.no_grad():
        before = (mine.launches, other.launches)
        got = op(res)
        check((mine.launches - before[0], other.launches - before[1]) == (1, 0),
              f"{name}: the op did not launch {mine.name} alone")
        with _lib.plain_versions():
            want = op(res)
            y = op(None) if residual else want
        acc = torch.nn.functional.conv1d(torch.nn.functional.pad(x, pads).float(),
                                         w.to(torch.bfloat16).float(), None, 1, 0, d)
        scale = torch.maximum(torch.maximum(acc.abs(), y.float().abs()), want.float().abs())
        ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(2.0**-126))) - 7)
        off = (got.float() - want.float()).abs()
        sums = torch.nn.functional.conv1d(torch.nn.functional.pad(x, pads).float().abs(),
                                          w.to(torch.bfloat16).float().abs(), None, 1, 0, d)
        past = int((off > 2 * ulp + sums * (c_in * k * 2.0**-22)).sum())
        ulps, err = float((off / ulp).max()), float(off.max())
        del acc, y, scale, ulp, off, want, sums
        check(torch.equal(got, op(res)), f"{name}: two runs differ")
        ms = device_ms_retried(lambda: op(res))
        with _lib.plain_versions():
            plain_ms = device_ms_retried(lambda: op(res))
        wb, bb = w.to(torch.bfloat16), None if b is None else b.to(torch.bfloat16)
        if pads[0] == pads[1]:
            lib_ms = device_ms_retried(lambda: torch.nn.functional.conv1d(x, wb, bb, 1, left, d))
        else:
            lib_ms = device_ms_retried(lambda: torch.nn.functional.conv1d(torch.nn.functional.pad(x, pads),
                                                                          wb, bb, 1, 0, d))
    check(past == 0, f"{name}: {past} outputs off plain past their bar")
    nbytes, flops = sc.bound_counts(BATCH, c_in, c_out, t, k, residual)
    bound_ms = max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3
    print(f"{name}: device {ms:.4f} ms, plain {plain_ms:.4f}, cuDNN F.conv1d {lib_ms:.4f}, bound "
          f"{bound_ms:.4f} ({100 * bound_ms / ms:.1f}%); {ulps:g} ulps, {err:.3g} off plain")
    return dict(ms=ms, plain=plain_ms, lib=lib_ms, bound=bound_ms, ulps=ulps, err=err)


def _summed(rows: list[tuple[dict, int]]) -> dict:
    """The rows' times, each counted as often as the codec runs it; the
    largest ulps and error."""
    tot = {key: sum(n * r[key] for r, n in rows) for key in ("ms", "plain", "lib", "bound")}
    return dict(tot, ulps=max(r["ulps"] for r, _ in rows), err=max(r["err"] for r, _ in rows))


def check_same_conv(dev) -> dict:
    """The kernels of ``csrc/same_conv.cu`` against their plain version on
    the card at the 50 stride-1 convolutions of one 16 x 4 s bfloat16
    encode and decode (each distinct geometry once, counted as often as the
    codec runs it: 26 on the stencil kernel, 24 k 1 convs on the GEMM path),
    then the GEMM path alone at the 29 k 1 convs of one SNAC 44 kHz encode
    and decode, then Mimi's at one 16 x 30 s encode and decode: its 10
    causal k 3 / k 7 convs on the stencil kernel at their left pad
    (``causal_geometries``: T from 720,000 down to 750, which is not a
    multiple of 8) and its 8 k 1 convs on the GEMM path; every
    output within two bfloat16 ulps of the largest of |acc|, |y| and |out|
    of plain (a flip of RN(acc) and the two adds after it) plus K 2^-22 sum
    |products| (two float32 sums of the K = C_in k products in different
    orders), the largest difference printed in those ulps; two runs bit for
    bit; device ms of the kernel, of the plain version and of cuDNN's
    bfloat16 ``F.conv1d`` at the same padding (a yardstick only), and the
    bound: per launch the larger of its bytes at 3.35 TB/s and FLOPs at 989
    TFLOP/s, summed.  -> the records of ``same_conv`` (the stencil
    kernel's 26 convs, with Mimi's 10 under ``"mimi"``) and ``k1conv``
    (SNAC's 29, with codec24k's 24 under ``"codec24k"`` and Mimi's 8 under
    ``"mimi"``)."""
    from nawc_tpu_torch.tools.conv_layers import causal_geometries, k1_geometries, stride1_geometries

    def tally(geometries):
        counts: dict[tuple, int] = {}
        for g in geometries:
            counts[g] = counts.get(g, 0) + 1
        return sorted(counts.items())

    rows = [(_same_conv_row(dev, 40 + i, c_in, c_out, k, d, d * (k - 1) // 2, res, t), n, k)
            for i, ((c_in, c_out, k, d, res, t), n) in enumerate(tally(stride1_geometries()))]

    def k1_rows(geometries, seed):
        return [(_same_conv_row(dev, seed + i, c_in, c_out, 1, 1, 0, res, t, bias), n)
                for i, ((c_in, c_out, res, bias, t), n) in enumerate(tally(geometries))]

    mimi = CodecConfig.mimi()
    sums = {"same_conv": _summed([(r, n) for r, n, k in rows if k != 1]),
            "k1conv codec24k": _summed([(r, n) for r, n, k in rows if k == 1]),
            "k1conv snac44k": _summed(k1_rows(k1_geometries(CodecConfig.snac_44khz(), 184_320), 90)),
            "same_conv mimi": _summed([(_same_conv_row(dev, 120 + i, c_in, c_out, k, d, left, False, t), n)
                                       for i, ((c_in, c_out, k, d, left, t), n)
                                       in enumerate(tally(causal_geometries(mimi, 720_000)))]),
            "k1conv mimi": _summed(k1_rows(k1_geometries(mimi, 720_000), 140))}
    for (what, r), (n, clip) in zip(sums.items(), [(26, "4 s"), (24, "4 s"), (29, "4 s"), (10, "30 s"),
                                                   (8, "30 s")]):
        print(f"{what}, its {n} launches of one {BATCH} x {clip} encode and decode: {r['ms']:.3f} ms "
              f"(plain {r['plain']:.3f}, cuDNN {r['lib']:.3f}, bound {r['bound']:.3f}: "
              f"{100 * r['bound'] / r['ms']:.0f}% of it); largest {r['ulps']:g} ulps off plain")

    def record(r):
        return dict(max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain"], bound_ms=r["bound"],
                    bound_by="bytes and operations, the larger a launch", library_ms=r["lib"])

    return {"same_conv": dict(record(sums["same_conv"]), mimi=record(sums["same_conv mimi"])),
            "k1conv": dict(record(sums["k1conv snac44k"]), codec24k=record(sums["k1conv codec24k"]),
                           mimi=record(sums["k1conv mimi"]))}


def check_dwconv(dev) -> dict:
    """The depthwise kernel against its plain version on the card at the 26
    depthwise convs of one 16 x 4 s SNAC 44 kHz bfloat16 encode and decode
    (each distinct geometry once, counted as often as the codec runs it):
    every output within two bfloat16 ulps of the largest of |acc|, |y| and
    |out| of plain (acc the float32 sum, y the rounded conv; a flip of
    RN(acc) and the add after it) plus k 2^-22 sum |products| (two float32
    sums of the k products in different orders), the largest difference
    printed in those ulps; two runs bit for bit; device ms of the kernel, of
    the plain version and of ATen's grouped bfloat16 ``F.conv1d`` at the
    same padding (a yardstick only, never called by the port), and the
    bound: x read and the output written once at 3.35 TB/s
    (``counts_snac.dwconv_bytes``' yardstick).  -> the kernel's record."""
    from nawc_tpu_torch.ops import dwconv as dw
    from nawc_tpu_torch.ops.conv import conv1d
    from nawc_tpu_torch.tools.conv_layers import depthwise_geometries

    counts: dict[tuple, int] = {}
    for g in depthwise_geometries():
        counts[g] = counts.get(g, 0) + 1
    tot = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0, ulps=0.0, err=0.0)
    for i, ((c, k, d, t), n) in enumerate(sorted(counts.items())):
        gen = torch.Generator(device=dev).manual_seed(70 + i)
        x = torch.randn((BATCH, c, t), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((c, 1, k), generator=gen, device=dev) / k ** 0.5
        b = torch.randn((c,), generator=gen, device=dev) * 0.1
        p = d * (k - 1) // 2

        def op(bias):  # the conv op as SameConv1d pads: the kernel, or the plain version under plain_versions
            return conv1d(x, w, bias, 1, p, d, c)

        with torch.no_grad():
            got = op(b)
            with _lib.plain_versions():
                want, y = op(b), op(None)
            wf = w.to(torch.bfloat16).float()
            acc = torch.nn.functional.conv1d(x.float(), wf, None, 1, p, d, c)
            scale = torch.maximum(torch.maximum(acc.abs(), y.float().abs()), want.float().abs())
            del acc, y
            ulp = torch.exp2(torch.floor(torch.log2(scale.clamp_min(2.0**-126))) - 7)
            del scale
            off = (got.float() - want.float()).abs()
            sums = torch.nn.functional.conv1d(x.float().abs(), wf.abs(), None, 1, p, d, c)
            past = int((off > 2 * ulp + sums * (k * 2.0**-22)).sum())
            ulps, err = float((off / ulp).max()), float(off.max())
            del ulp, off, want, sums
            check(torch.equal(got, op(b)), f"dwconv {c} d{d} T {t}: two runs differ")
            ms = device_ms_retried(lambda: op(b))
            with _lib.plain_versions():
                plain_ms = device_ms_retried(lambda: op(b))
            wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
            lib_ms = device_ms_retried(lambda: torch.nn.functional.conv1d(x, wb, bb, 1, p, d, c))
        check(past == 0, f"dwconv {c} d{d} T {t}: {past} outputs off plain past their bar")
        bound_ms = dw.bound_bytes(BATCH, c, t, k) / PEAK_BYTES_PER_S * 1e3
        print(f"dwconv {c} k{k} d{d} T {t} (x{n}): device {ms:.4f} ms, plain {plain_ms:.4f}, ATen "
              f"F.conv1d {lib_ms:.4f}, bound {bound_ms:.4f} ({100 * bound_ms / ms:.1f}%); {ulps:g} ulps, "
              f"{err:.3g} off plain")
        for key, v in (("ms", ms), ("plain", plain_ms), ("lib", lib_ms), ("bound", bound_ms)):
            tot[key] += n * v
        tot["ulps"], tot["err"] = max(tot["ulps"], ulps), max(tot["err"], err)
        del x, w, b, got
    print(f"dwconv, the 26 launches of one {BATCH} x {SECONDS} s SNAC 44 kHz encode and decode: "
          f"{tot['ms']:.3f} ms (plain {tot['plain']:.3f}, ATen {tot['lib']:.3f}, bound {tot['bound']:.3f}: "
          f"{100 * tot['bound'] / tot['ms']:.0f}% of it); largest {tot['ulps']:g} ulps off plain")
    return dict(max_abs_err=tot["err"], ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
                bound_by="bytes", library_ms=tot["lib"])


# ------------------------------------------------------------------ phase 8

DISCRETE = ("bitwise/", "hard/", "survived", "detector_works")
NEAR_GATE = 1e-3   # presence gates: |mean |z| - z0| within this is a near-tie
SISNR_TOL = 1e-3   # dB
SCORE_TOL = 1e-3


def speech_clips(n: int, seconds: float, sr: int, seed: int) -> list[np.ndarray]:
    """Speech-like clips from `seed`: five harmonics of a gliding f0 under a
    syllable-rate envelope, plus a noise floor."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    clips = []
    for _ in range(n):
        f0 = rng.uniform(100, 220) * (1 + 0.1 * np.sin(2 * np.pi * rng.uniform(0.3, 1.0) * tt))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5) * tt + rng.uniform(0, 6)), 0, None) ** 2
        tone = sum(np.sin(h * phase) / h for h in range(1, 6)) * env
        clips.append((0.25 * tone + 0.005 * rng.normal(size=tt.size)).astype(np.float32))
    return clips


class Recorder(contextlib.AbstractContextManager):
    """Replaces `name` in `module` by a wrapper that keeps the arguments and
    the result of each call, so that each call of a kernel run can be held
    against the plain version on the same inputs afterwards.  With `clone`
    it keeps detached copies of the tensor arguments and the output
    detached: a codebook in training moves in place after the lookup that
    read it, and a call inside a backward must not keep the graph alive."""

    def __init__(self, module, name: str, clone: bool = False):
        self.module, self.name, self.orig = module, name, getattr(module, name)
        self.clone = clone
        self.calls: list = []

    def __enter__(self):
        def record(*args):
            out = self.orig(*args)
            if self.clone:
                args = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            self.calls.append((args, out.detach() if self.clone and torch.is_tensor(out) else out))
            return out

        setattr(self.module, self.name, record)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def check_sswm_calls(calls, z0: float) -> dict:
    """Every recorded whiten_correlate call against the plain version on
    its inputs: z within Z_TOL, bits equal wherever |z| > BIT_Z_MIN.
    -> shapes and counts of calls, the largest error, the bits at |z| <=
    BIT_Z_MIN that flipped, and the rows whose mean |z| lies within
    NEAR_GATE of the presence gate z0."""
    shapes: dict = {}
    err, flips, near_gates = 0.0, 0, 0
    for (r, p, offs), z_k in calls:
        with _lib.plain_versions():
            z_p = sswm.whiten_correlate(r, p, offs)
        e = float((z_k - z_p).abs().max())
        diff = (z_k > 0) != (z_p > 0)
        shape = (*r.shape, p.shape[0])
        check(e <= Z_TOL, f"sweep sswm {shape}: |z - plain| {e} > {Z_TOL}")
        check(not bool((diff & (z_p.abs() > BIT_Z_MIN)).any()), f"sweep sswm {shape}: bits differ")
        shapes[shape] = shapes.get(shape, 0) + 1
        err, flips = max(err, e), flips + int(diff.sum())
        near_gates += int(((z_p.abs().mean(dim=-1) - z0).abs() <= NEAR_GATE).sum())
    return dict(shapes=shapes, max_err=err, near_bits=flips, near_gates=near_gates)


def check_lookup_calls(calls) -> dict:
    """Every recorded nearest_codebook call against the plain lookup."""
    shapes: dict = {}
    mism = frames = 0
    for (z, cb), codes in calls:
        m, f, _ = parity.compare_lookup(codes, z, cb)
        mism, frames = mism + m, frames + f
        shapes[tuple(z.shape)] = shapes.get(tuple(z.shape), 0) + 1
    parity.check_share(mism, frames, "sweep nearest_codebook")
    return dict(shapes=shapes, near_codes=mism, frames=frames)


def timed_suite(suite: dict, seconds: dict) -> dict:
    """The suite with each attack's wall time (synchronised) added to
    `seconds` under its name."""
    def wrap(name, fn):
        def run(w, k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(w, k)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return run

    return {name: wrap(name, fn) for name, fn in suite.items()}


def rows_of(result) -> list[dict]:
    return result.per_method + result.summary if hasattr(result, "per_method") else result


def compare_rows(label: str, got: list[dict], want: list[dict], near_events: int) -> int:
    """Kernel rows against plain rows: the same keys, strings and integers;
    SI-SNR within SISNR_TOL and scores within SCORE_TOL; the discrete
    columns (bits, decisions) equal.  Cells off those bars are allowed only
    where the run met near-ties (`near_events` > 0), and then under 1% of
    them.  -> the count of such cells."""
    check(len(got) == len(want), f"{label}: {len(got)} rows against {len(want)}")
    off = cells = 0
    for g, w in zip(got, want):
        check(list(g) == list(w), f"{label}: columns differ: {list(g)} vs {list(w)}")
        for k, v in g.items():
            cells += 1
            if isinstance(v, float) and not k.startswith(DISCRETE):
                tol = SISNR_TOL if k.startswith("sisnr") else SCORE_TOL
                bad = not (abs(v - w[k]) <= tol or (np.isnan(v) and np.isnan(w[k])))
            else:
                bad = v != w[k]
            off += bad
    check(off == 0 or (near_events > 0 and off < 0.01 * cells),
          f"{label}: {off} of {cells} cells differ from plain with {near_events} near-ties")
    return off


def sweep_run(label: str, run, z0: float, kernels: tuple[str, ...], attack_s: dict | None = None,
              warm: bool = True) -> dict:
    """`run()` once to warm up (cuDNN's and cuFFT's plans; skipped when not
    `warm`), then with the
    kernels (counts from 0, every sswm and lookup call recorded) and then
    with the plain versions; checks the calls, the kernels' launches, the
    rows and that no row holds an error.  `attack_s`, filled by a
    :func:`timed_suite` in `run`, keeps the kernel run's attack times."""
    if warm:
        run()
    if attack_s is not None:
        attack_s.clear()
    _lib.reset_launches()
    with Recorder(ss_module, "whiten_correlate") as sw, Recorder(codec_model, "nearest_codebook") as lk, \
            DrawRecorder() as dr:
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in _lib.KERNELS.items()}
    for n in kernels:
        check(launches[n] > 0, f"{label}: kernel {n} was not launched in the sweep")
    kernel_attack_s = dict(attack_s or {})
    t0 = time.perf_counter()
    with _lib.plain_versions(), DrawRecorder() as dp:
        want = run()
        torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    rows = rows_of(got)
    errors = [r for r in rows + rows_of(want) if "error" in r]
    check(not errors, f"{label}: error rows: {errors[:2]}")
    s, c = check_sswm_calls(sw.calls, z0), check_lookup_calls(lk.calls)
    draws = check_draw_pairs(dr.calls, dp.calls)
    near = s["near_bits"] + s["near_gates"] + c["near_codes"]
    off = compare_rows(label, rows, rows_of(want), near)
    print(f"sweep {label}: {len(rows)} rows, wall {wall:.2f} s (plain {plain_wall:.2f} s); "
          f"launches {launches}")
    print(f"  whiten_correlate calls by (B, T, W, K): {s['shapes']}, max|z - plain| "
          f"{s['max_err']:.3g}, near-tie bits flipped {s['near_bits']}, rows near the gate "
          f"{s['near_gates']}")
    print(f"  nearest_codebook calls by (N, D): {c['shapes']}: {c['near_codes']} of {c['frames']} "
          f"codes differ (near-ties); row cells off plain: {off}")
    print(f"  jaxrand: {draws['draws']} draws ({draws['values']} values) bit for bit the plain run's, "
          f"{dr.device_ms():.3f} ms of device time (the plain run's, the replica on the host and its copy, "
          f"{dp.device_ms():.1f} ms by the same events)")
    if kernel_attack_s:
        slow = sorted(kernel_attack_s.items(), key=lambda kv: -kv[1])[:5]
        print(f"  attacks {sum(kernel_attack_s.values()):.2f} s of the {wall:.2f} s; slowest "
              "(both applications): " + ", ".join(f"{k} {v:.3f} s" for k, v in slow))
    return dict(rows=rows, plain=rows_of(want), wall=wall, launches=launches, draw_ms=dr.device_ms())


def mean_of(rows: list[dict], col: str) -> float:
    return float(np.mean([r[col] for r in rows]))


def sweep(codec, dev, sizes=((16, 4.0), (16, 2.0), (8, 4.0))) -> dict:
    """Phase 8; `sizes` are (clips, seconds) of the spread-spectrum
    robustness runs, the combined run and the psychoacoustic runs."""
    (n_ss, s_ss), (n_cb, s_cb), (n_psy, s_psy) = sizes
    ss = SpreadSpectrumWM(SpreadSpectrumConfig(alpha=0.1))
    psy = PsychoacousticWM()
    attack_s: dict = {}
    suite16 = build_suite(16_000, codec)
    suite16.pop("identity")
    suite44 = build_suite(44_100, codec)
    suite44.pop("identity")
    clips16 = speech_clips(n_ss, s_ss, 16_000, seed=10)
    wav16 = np.stack(speech_clips(n_cb, s_cb, 16_000, seed=11))
    clips44 = speech_clips(n_psy, s_psy, 44_100, seed=12)
    both = ("whiten_correlate", "nearest_codebook", "jaxrand")
    out = {}
    for kind in ("normal", "uniform"):
        ms = device_ms(lambda: getattr(keyed, kind)(jaxrand.prng_key(0), (32, 32_000), dev))
        print(f"device draw keyed.{kind} (32, 32000): {ms:.4f} ms")
    out["spread_spectrum"] = sweep_run(
        "spread_spectrum", lambda: run_robustness(ss, timed_suite(suite16, attack_s), clips16,
                                                  16_000, 2.0, device=dev),
        ss.presence_z0, both, attack_s)
    out["sync"] = sweep_run(
        "spread_spectrum sync", lambda: run_robustness(ss, suite16, clips16, 16_000, 2.0, sync=True,
                                                       device=dev),
        ss.presence_z0, ("nearest_codebook", "jaxrand"))
    out["combined"] = sweep_run(
        "combined spread_spectrum + chunked",
        lambda: run_combined({"spread_spectrum": ss, "chunked": ChunkedWM()},
                             build_suite(16_000, codec), wav16, device=dev),
        ss.presence_z0, both)
    out["psychoacoustic"] = sweep_run(
        "psychoacoustic", lambda: run_robustness(psy, suite44, clips44, 44_100, 2.0, device=dev),
        psy._core.presence_z0, both)
    for key in ("spread_spectrum", "psychoacoustic"):
        print(f"clean-channel bitwise/clean of {key}: {mean_of(out[key]['rows'], 'bitwise/clean'):.4f} "
              f"(plain {mean_of(out[key]['plain'], 'bitwise/clean'):.4f})")

    with torch.no_grad():
        marked = psy.embed(torch.as_tensor(np.stack(clips44), device=dev))
        _lib.reset_launches()
        with Recorder(ss_module, "whiten_correlate") as sw:
            n_sym = psy.discover_message_length(marked)
        check(_lib.KERNELS["whiten_correlate"].launches > 0, "discovery did not launch sswm")
        with _lib.plain_versions():
            n_plain = psy.discover_message_length(marked)
    out["discovery launches"] = _lib.KERNELS["whiten_correlate"].launches
    s = check_sswm_calls(sw.calls, psy._core.presence_z0)
    check(n_sym == n_plain, f"discover_message_length {n_sym} against plain {n_plain}")
    print(f"discover_message_length: {n_sym} symbols (plain {n_plain}; 5 were embedded); "
          f"sswm calls {s['shapes']}, max|z - plain| {s['max_err']:.3g}")
    out["discovered"] = n_sym
    return out


# ------------------------------------------------------------------ phase 9

def bf16_codec(codec, codec16, marked: torch.Tensor) -> dict:
    """Codes of the bf16 codec against the f32 codec's on the padded marked
    batch, per level, and the bf16 decode of the f32 codes against the f32
    decode."""
    x = codec.pad(marked)
    with torch.no_grad():
        c32, c16 = codec.encode(x), codec16.encode(x)
        y32, y16 = codec.decode(c32), codec16.decode(c32)
    agree = [float((a == b).float().mean()) for a, b in zip(c32, c16)]
    rel = float(((y32 - y16) ** 2).mean().sqrt() / ((y32 ** 2).mean().sqrt() + 1e-9))
    print(f"bf16 vs f32 code agreement per level {[round(a, 4) for a in agree]} (mean "
          f"{np.mean(agree):.4f}, JAX's bar 0.94); decode rel-rms {rel:.4g} (bar 0.1)")
    check(float(np.mean(agree)) > 0.94, f"bf16 code agreement {agree} not above 0.94")
    check(rel < 0.1, f"bf16 decode rel-rms {rel} not under 0.1")
    check(bool(torch.isfinite(y16).all()), "bf16 decode is not finite")
    return dict(agree=agree, rel=rel)


# ------------------------------------------------------------------ phase 10

LATENT_METHODS = ("semantic_pca", "semantic_cluster", "semantic_random", "token_green")
LATENT_ADAM_STEPS = 200  # of the operating point's 300, to fit the script's budget


class TimedEmbed:
    """A watermarker whose every embed is timed (synchronised) and measured
    for peak device memory; the last marked batch is kept."""

    def __init__(self, wm):
        self.wm, self.walls, self.peaks, self.marked = wm, [], [], None
        self.name, self.sample_rate, self.n_bits = wm.name, wm.sample_rate, wm.n_bits

    def embed(self, wav, msg=None, key=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        self.marked = self.wm.embed(wav)
        torch.cuda.synchronize()
        self.walls.append(time.perf_counter() - t0)
        self.peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        return self.marked

    def score(self, wav, msg=None):
        return self.wm.score(wav)

    def detect(self, wav):
        return self.wm.detect(wav)


def embed_steps(wm) -> int:
    return wm.scfg.steps if hasattr(wm, "scfg") else wm.steps


def step_by_kind(wm, x: torch.Tensor, steps: int = 10) -> dict[str, float]:
    """Device ms per Adam step by kind: one `steps`-step embed of the same
    method without the spectral projection, under ``torch.profiler``."""
    short = (dataclasses.replace(wm, cfg=dataclasses.replace(wm.scfg, steps=steps, lsd_weight=0.0))
             if hasattr(wm, "scfg") else dataclasses.replace(wm, steps=steps))
    short.embed(x)  # warm cuDNN's plans for this shape
    return {k: v / steps for k, v in by_kind(device_events(lambda: short.embed(x))).items()}


def codec_latent(codec, dev, n_clips: int = 4, seconds: float = 2.0, steps: int = LATENT_ADAM_STEPS) -> dict:
    """Phase 10; `steps` replaces the operating point's 300 Adam steps of
    each embed."""
    wav16 = torch.as_tensor(np.stack(speech_clips(n_clips, seconds, 16_000, seed=13)), device=dev)
    wav24 = resample(wav16, 16_000, 24_000)  # as cli/benchmark.py feeds the codec-latent methods
    wms = {n: dataclasses.replace(w, cfg=dataclasses.replace(w.scfg, steps=steps))
           if hasattr(w, "scfg") else dataclasses.replace(w, steps=steps)
           for n, w in build_watermarkers(list(LATENT_METHODS), codec).items()}
    timed = {n: TimedEmbed(w) for n, w in wms.items()}
    suite = build_suite(24_000, codec)
    _lib.reset_launches()
    t0 = time.perf_counter()
    with Recorder(codec_api, "rvq_encode_fused") as rf, Recorder(codec_model, "nearest_codebook") as lk, \
            DrawRecorder() as dr:
        rep = run_combined(timed, suite, wav24, device=dev)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in _lib.KERNELS.items()}
    draws = check_draws(dr.calls)
    print(f"codec-latent run_combined ({n_clips} x {seconds} s, {len(suite)} attacks): wall {wall:.1f} s; "
          f"launches {launches}; {draws['draws']} draws bit for bit the replica, {dr.device_ms():.3f} ms "
          "of device time")
    for n in ("rvq_encode_fused", "nearest_codebook", "jaxrand", "snake", "snake_backward"):
        check(launches[n] > 0, f"codec-latent run: kernel {n} was not launched")
    errors = [r for r in rep.per_method + rep.summary if "error" in r]
    check(not errors, f"codec-latent run: error rows: {errors[:2]}")
    mism = frames = 0
    shapes: dict = {}
    for (z, quantizer, strides), codes in rf.calls:
        m, f, _ = parity.compare_rvq(codes, z, quantizer, strides)
        mism, frames = mism + m, frames + f
        shapes[tuple(z.shape)] = shapes.get(tuple(z.shape), 0) + 1
    lookups = check_lookup_calls(lk.calls)
    print(f"  rvq_encode_fused calls by z shape {shapes}: {mism} of {frames} codes differ from plain "
          f"(near-ties); nearest_codebook calls {lookups['shapes']}: {lookups['near_codes']} of "
          f"{lookups['frames']} differ (near-ties)")
    tg = timed["token_green"]
    with torch.no_grad():
        s_k = tg.score(tg.marked)
        with _lib.plain_versions():
            s_p = tg.score(tg.marked)
    err = float((s_k - s_p).abs().max())
    print(f"  token_green score on the same marked audio, kernel vs plain route: max diff {err:.3g}")
    check(err == 0.0 or mism > 0, "token_green: score differs from the plain route without a near-tie")
    summary = {r["watermark"]: r for r in rep.summary}
    out = {"launches": launches, "wall": wall}
    for n, t in timed.items():
        det = [r for r in rep.per_method if r["watermark"] == n and "score_before" in r]
        srv = [r for r in rep.per_method if r["watermark"] == n and "attack" in r]
        surv = {a: mean_of([r for r in srv if r["attack"] == a], "survived") for a in ("dac", "encodec")}
        k = embed_steps(t.wm)
        print(f"{n}: embed walls {[round(w, 2) for w in t.walls]} s for {k} steps "
              f"({1e3 * t.walls[-1] / k:.1f} ms per step, last embed); peak memory of one embed "
              f"{max(t.peaks):.2f} GiB; scores clean {mean_of(det, 'score_before'):.4f} marked "
              f"{mean_of(det, 'score_after'):.4f}; SI-SNR {mean_of(srv, 'sisnr_wm'):.2f} dB; "
              f"detector pass rate {summary[n]['detector_pass_rate']:.3f}; survival dac "
              f"{surv['dac']:.3f}, encodec {surv['encodec']:.3f}")
        out[n] = dict(ms_per_step=1e3 * t.walls[-1] / k, peak_gib=max(t.peaks))
    for n in ("semantic_pca", "token_green"):
        kinds = step_by_kind(timed[n].wm, wav24)
        print(f"{n}: device ms per Adam step by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    return out


# ------------------------------------------------------------------ phase 11

def pgd_phase(dev, n_clips: int = 8, seconds: float = 2.0, steps: int = 100) -> dict:
    """``cli/pgd.py --mode attack`` at its defaults, on speech-like clips."""
    wm = build_watermarkers(["spread_spectrum"])["spread_spectrum"]
    wav = torch.as_tensor(np.stack(speech_clips(n_clips, seconds, 16_000, seed=14)), device=dev)
    msg = random_message(jaxrand.prng_key(0), n_clips, wm.n_bits, device=dev)
    with torch.no_grad():
        marked = wm.embed(wav, msg)
    score_fn = lambda w: wm.score(w, msg)  # noqa: E731
    g_k = _grad(lambda d: score_fn(marked + d).sum(), torch.zeros_like(marked))
    with _lib.plain_versions():
        g_p = _grad(lambda d: score_fn(marked + d).sum(), torch.zeros_like(marked))
    gerr, scale = float((g_k - g_p).abs().max()), float(g_p.abs().max())
    flips = int((torch.sign(g_k) != torch.sign(g_p)).sum())
    print(f"pgd: one step's gradient through the kernel vs the plain route: max diff {gerr:.3g} "
          f"(scale {scale:.3g}), {flips} of {g_p.numel()} signs differ")
    # the score is nonlinear in z, so dscore/dz carries the kernel's z error
    # (within Z_TOL of plain) into the gradient
    check(gerr <= 1e-4 * scale, f"pgd gradient differs from plain by {gerr} (scale {scale})")
    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    attacked = pgd_attack(score_fn, marked, steps=steps, eps=0.02, lr=0.001)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: k.launches for n, k in _lib.KERNELS.items()}
    with torch.no_grad():
        before, after = score_fn(marked), score_fn(attacked)
        snr = si_snr(marked, attacked)
    print(f"pgd {n_clips} x {seconds} s, {steps} steps: wall {wall:.2f} s ({1e3 * wall / steps:.2f} ms "
          f"per step); launches {launches}; score before {float(before.mean()):.4f} after "
          f"{float(after.mean()):.4f}; SI-SNR {float(snr.mean()):.2f} dB; max|delta| "
          f"{float((attacked - marked).abs().max()):.4f}")
    check(launches["whiten_correlate"] >= steps, "pgd: the sswm kernel did not run in every step")
    check(float((attacked - marked).abs().max()) <= 0.02 + 1e-6, "pgd: |delta| above eps")
    check(bool(torch.isfinite(attacked).all()), "pgd: attacked audio not finite")
    return dict(launches=launches, wall=wall)


# ------------------------------------------------------------------ phase 12

NEURAL_CKPT = REPO / "checkpoints" / "neural_wm.msgpack"
# the neural sync sweep's attacks (7 of the 19, to fit the script's budget):
# the shifts that sync detection exists for, a noise, a lossy codec and the
# two codec round-trips (the lookups)
SYNC_ATTACKS = ("time_jitter", "time_stretch", "phase_shift", "gaussian_noise", "mp3", "encodec", "dac")


def neural_phase(codec, dev, n_clips: int = 16, seconds: float = 4.0, wm=None) -> dict:
    """Phase 12: the trained neural watermark; `wm` replaces the checkpoint
    (for a rehearsal on the CPU only)."""
    if wm is None:
        check(NEURAL_CKPT.exists(), f"{NEURAL_CKPT.relative_to(REPO)} is missing")
        wm = build_watermarkers(["neural"], device=dev)["neural"]
    clips = speech_clips(n_clips, seconds, 16_000, seed=15)
    wav = torch.as_tensor(np.stack(clips), device=dev)
    msg = random_message(jaxrand.prng_key(0), n_clips, wm.n_bits, device=dev)
    with torch.no_grad():
        marked = wm.embed(wav, msg)
        pres, bits = wm.detect(marked)
        pres_s, bits_s, offs = wm.detect_sync(marked)
        pres_c, _ = wm.detect(wav)
        # a 200-sample delay (12.5 ms): off the lattice, which detect_sync searches
        pres_d, bits_d, offs_d = wm.detect_sync(torch.roll(marked, 200, dims=-1))
        ms = {name: wall_ms(fn, iters=5, warmup=1) for name, fn in (
            ("embed", lambda: wm.embed(wav, msg)), ("detect", lambda: wm.detect(marked)),
            ("detect_sync", lambda: wm.detect_sync(marked)))}
        snr = float(si_snr(wav, marked).mean())
    acc, acc_s, acc_d = (float(bit_accuracy(b, msg).mean()) for b in (bits, bits_s, bits_d))
    print(f"neural {n_clips} x {seconds} s: clean-channel bit accuracy {acc:.4f} (detect_sync "
          f"{acc_s:.4f}, offsets {sorted(set(offs.tolist()))}); presence marked "
          f"{float(pres.mean()):.4f}, clean {float(pres_c.mean()):.4f}; SI-SNR {snr:.2f} dB; "
          f"delayed 200 samples: bit accuracy {acc_d:.4f}, offsets {sorted(set(offs_d.tolist()))}")
    print("neural ms per batch: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    check(tuple(marked.shape) == tuple(wav.shape), f"neural marked shape {tuple(marked.shape)}")
    check(all(bool(torch.isfinite(x).all()) for x in (marked, pres, pres_c, pres_s)),
          "neural: non-finite output")
    check(acc >= 0.95 and float(pres.mean()) > float(pres_c.mean()),
          f"neural: clean-channel bit accuracy {acc}, presence marked {float(pres.mean())} "
          f"against clean {float(pres_c.mean())}")
    suite = build_suite(16_000, codec)
    suite.pop("identity")
    out = {"ms": ms, "acc": acc}
    # the sync run without its warm-up run (the plans are warm from the
    # first), and on the attacks of SYNC_ATTACKS only: detect_sync costs
    # 3.5 s an attack
    suites = {False: suite, True: {k: suite[k] for k in SYNC_ATTACKS}}
    for label, sync in (("neural", False), ("neural sync", True)):
        out[label] = sweep_run(label, lambda: run_robustness(wm, suites[sync], clips, 16_000, 2.0,
                                                             sync=sync, device=dev),
                               0.0, ("nearest_codebook", "jaxrand"), warm=not sync)
        print(f"  {label}: bitwise/clean {mean_of(out[label]['rows'], 'bitwise/clean'):.4f}, "
              f"bitwise/distorted {mean_of(out[label]['rows'], 'bitwise/distorted'):.4f}")
    out["launches"] = {n: out["neural"]["launches"][n] + out["neural sync"]["launches"][n]
                       for n in _lib.KERNELS}
    return out


# ------------------------------------------------------------------ phase 13

LOSS_RTOL = 1e-5


def synced_ms(fn):
    """-> (fn(), wall ms with the card synchronised on both sides)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def twin_step(label: str, state, step) -> tuple[dict, float, float]:
    """One training step from `state` with the kernels, and the same step
    from a copy of `state` with the plain versions: every float metric
    within LOSS_RTOL relative.  -> (metrics, ms, peak GiB of the kernel
    step)."""
    ref = copy.deepcopy(state)
    with _lib.plain_versions():
        want = step(ref)
    del ref
    torch.cuda.reset_peak_memory_stats()
    got, ms = synced_ms(lambda: step(state))
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k, v in want.items():
        if v.numel() == 1:
            a, b = float(got[k]), float(v)
            check(np.isfinite(a), f"{label}: {k} = {a} is not finite")
            check(abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-6),
                  f"{label}: {k} {a} with the kernels against {b} plain")
    return got, ms, peak


def split_of(step, state) -> dict[str, float]:
    """Device ms of one step, by kind, on a throwaway copy of `state`."""
    return by_kind(device_events(lambda: step(copy.deepcopy(state))))


def print_trainer(label: str, ms: dict, peak: float, split: dict, metrics: list[dict]) -> None:
    print(f"{label}: ms per step " + ", ".join(f"{k} {np.mean(v):.1f} ({len(v)} steps)"
                                                for k, v in ms.items())
          + f"; peak memory {peak:.2f} GiB; device ms per step by kind: "
          + ", ".join(f"{k} {v:.2f}" for k, v in sorted(split.items(), key=lambda kv: -kv[1])))
    print(f"  {label} losses: " + " ".join(f"{float(m['loss']):.4f}" for m in metrics))


def wm_trainer(dev, codec, files, steps: int = 24, batch: int = 16, seconds: float = 1.0) -> dict:
    """``train_wm``'s defaults from the seeded init, with `codec` as
    ``--codec_ckpt``: the codec branch on every 3rd step."""
    cfg = NeuralWMConfig()
    state = init_wm_train(0, cfg, lr=2e-4, weight_decay=1e-5, device=dev)
    fns = {"dsp": make_wm_train_step(cfg), "codec": make_wm_train_step(cfg, codec=codec)}
    batches = speech_batches(files, batch, seconds, cfg.sample_rate, seed=0)
    key = jaxrand.prng_key(1)
    t = int(seconds * cfg.sample_rate)
    ms: dict = {"dsp": [], "codec": []}
    metrics, peak = [], 0.0
    with Recorder(codec_model, "nearest_codebook", clone=True) as lk, DrawRecorder() as dr:
        for i in range(1, steps + 1):
            wav = torch.from_numpy(next(batches)[:, :t]).to(dev)
            key, km, kk = jaxrand.split(key, 3)
            msg = random_message(km, batch, cfg.n_bits, device=dev)
            branch = "codec" if i % 3 == 0 else "dsp"
            m, dt, pk = twin_step(f"wm step {i}", state,
                                  lambda s: fns[branch](s, wav, msg, kk, i))
            ms[branch].append(dt)
            metrics.append(m)
            peak = max(peak, pk)
    split = {b: split_of(lambda s: fns[b](s, wav, msg, kk, i), state) for b in fns}
    lookups = check_lookup_calls(lk.calls)
    draws = check_draws(dr.calls)
    print_trainer(f"wm trainer {batch} x {seconds} s", ms, peak, split["dsp"], metrics)
    print("  codec-branch step device ms by kind: " + ", ".join(
        f"{k} {v:.2f}" for k, v in sorted(split["codec"].items(), key=lambda kv: -kv[1])))
    print(f"  bit_acc {[round(float(m['bit_acc']), 3) for m in metrics]}; nearest_codebook calls "
          f"{lookups['shapes']}: {lookups['near_codes']} of {lookups['frames']} differ (near-ties); "
          f"{draws['draws']} augmentation draws (kernel and plain steps) bit for bit the replica")
    return dict(ms=ms, peak=peak)


def codec_trainer(dev, files, cfg: CodecConfig = CodecConfig(), steps=(5, 2), batch: int = 16,
                  samples: int = 32_768) -> dict:
    """``train_codec``'s defaults from the seeded init: `steps[0]` steps,
    one dead-code revival, `steps[1]` more."""
    state = init_codec_train(0, cfg, device=dev, lr=3e-4, total=20_000)
    step = make_codec_train_step(cfg)
    batches = speech_batches(files, batch, samples / cfg.sample_rate, cfg.sample_rate, seed=0)
    usage = {i: np.zeros(cfg.codebook_size, np.int64) for i in range(cfg.num_levels)}
    ms, metrics, peak, dead = {"step": []}, [], 0.0, None
    with Recorder(codec_model, "nearest_codebook", clone=True) as lk:
        for i in range(steps[0] + steps[1]):
            if i == steps[0]:
                versions = [lv.codebook._version for lv in state.model.quantizer.levels]
                dead = revive_dead_codes(state.model, usage, cfg, np.random.default_rng(7))
                moved = [lv.codebook._version > v for lv, v in zip(state.model.quantizer.levels, versions)]
                print(f"  revived dead codes per level {dead}; codebook versions moved {moved}")
            wav = torch.from_numpy(next(batches)[:, :samples]).to(dev)
            m, dt, pk = twin_step(f"codec step {i + 1}", state, lambda s: step(s, wav))
            for lv in range(cfg.num_levels):
                usage[lv] += m[f"usage_{lv}"].cpu().numpy().astype(np.int64)
            ms["step"].append(dt)
            metrics.append(m)
            peak = max(peak, pk)
    lookups = check_lookup_calls(lk.calls)
    print_trainer(f"codec trainer {batch} x {samples}", ms, peak, split_of(lambda s: step(s, wav), state),
                  metrics)
    print(f"  live codes {[int((u > 0).sum()) for u in usage.values()]}; nearest_codebook calls "
          f"{lookups['shapes']}: {lookups['near_codes']} of {lookups['frames']} differ (near-ties), "
          f"{len(lk.calls)} calls over {len(metrics)} steps")
    return dict(ms=ms, peak=peak, dead=dead)


def gan_trainer(dev, files, tree: dict, cfg: CodecConfig = CodecConfig(), steps: int = 3,
                batch: int = 16, samples: int = 32_768) -> dict:
    """``train_gan``'s defaults: the codec of `tree` (the trained checkpoint)
    and the seeded discriminators; the encoder and quantizer must not move."""
    model = trainable_codec(cfg, 0, dev, tree=tree)
    disc = init_discriminators(1, dev)
    g_opt = decoder_only_tx(model, lr=1e-4, b1=0.8, b2=0.99, weight_decay=1e-4)
    d_opt = AdamW(disc.parameters(), 2e-4, b1=0.8, b2=0.99, weight_decay=1e-4)
    step = make_gan_train_step(cfg)
    state = (model, disc, g_opt, d_opt)
    batches = speech_batches(files, batch, samples / cfg.sample_rate, cfg.sample_rate, seed=0)
    ms, metrics, peak = {"step": []}, [], 0.0
    with Recorder(codec_model, "nearest_codebook", clone=True) as lk:
        for i in range(steps):
            wav = torch.from_numpy(next(batches)[:, :samples]).to(dev)
            m, dt, pk = twin_step(f"gan step {i + 1}", state, lambda s: step(*s, wav))
            ms["step"].append(dt)
            metrics.append(m)
            peak = max(peak, pk)
    lookups = check_lookup_calls(lk.calls)
    print_trainer(f"GAN trainer {batch} x {samples}", ms, peak, split_of(lambda s: step(*s, wav), state),
                  metrics)
    print(f"  d_loss {[round(float(m['d_loss']), 4) for m in metrics]}; nearest_codebook calls "
          f"{lookups['shapes']}: {lookups['near_codes']} of {lookups['frames']} differ (near-ties)")
    before = flax_to_state_dict(tree, model)
    after = model.state_dict()
    frozen = [k for k in after if not k.startswith("decoder.")]
    check(all(torch.equal(after[k].cpu(), before[k]) for k in frozen),
          "GAN: the encoder or the quantizer moved")
    moved = sum(not torch.equal(after[k].cpu(), before[k]) for k in after if k.startswith("decoder."))
    print(f"  encoder and quantizer bit for bit unchanged ({len(frozen)} tensors); {moved} decoder "
          "tensors moved")
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "codec_gan.msgpack"
        saved = state_dict_to_flax(model)
        save_params(path, saved)
        back, want = tree_leaves(load_params(path)), tree_leaves(saved)
        check(list(back) == list(want) and all(np.array_equal(back[k], want[k]) for k in want),
              "a checkpoint written by save_params does not read back equal")
    print(f"  checkpoint of {len(want)} leaves written by save_params reads back equal")
    return dict(ms=ms, peak=peak)


def cli_runs(d: Path, cli_args: dict) -> None:
    """Each training CLI for 2 steps at its defaults on the WAVs in `d`
    (``eval_codec`` on the GAN's checkpoint): every log line finite, every
    checkpoint readable; `cli_args` adds arguments per command (for a
    rehearsal on the CPU only)."""
    from nawc_tpu_torch.cli import eval_codec, train_codec, train_gan, train_wm

    glob = ["--audio_glob", str(d / "*.wav"), "--steps", "2", "--log_every", "1"]
    runs = [(train_wm, glob + ["--codec_ckpt", str(CHECKPOINT), "--out", str(d / "wm.msgpack")]),
            (train_codec, glob + ["--out", str(d / "codec.msgpack")]),
            (train_gan, glob + ["--resume", str(CHECKPOINT), "--val_files", "0",
                                "--out", str(d / "gan.msgpack")])]
    for mod, argv in runs:
        name = mod.__name__.rsplit(".", 1)[-1]
        _, ms = synced_ms(lambda: mod.main(argv + cli_args.get(name, [])))
        out = Path(argv[argv.index("--out") + 1])
        lines = [json.loads(x) for x in out.with_suffix(".log.jsonl").read_text().splitlines()]
        check(len(lines) == 2 and all(np.isfinite(v) for x in lines for v in x.values()
                                      if isinstance(v, float)), f"{name}: log lines {lines}")
        check(len(tree_leaves(load_params(out))) > 0, f"{name}: checkpoint {out} unreadable")
        print(f"cli {name}: 2 steps in {ms / 1e3:.1f} s; losses {[round(x['loss'], 4) for x in lines]}")
    eval_codec.main(["--ckpt", str(d / "gan.msgpack"), "--audio_glob", str(d / "*.wav"), "--offset", "0",
                     "--filecount", "4"] + cli_args.get("eval_codec", []))


def training_phase(dev, codec, tree: dict, sizes: dict | None = None,
                   cli_args: dict | None = None) -> dict:
    """Phase 13: the three trainers at the CLI defaults, on speech-like WAV
    files written to a temporary directory, then each training CLI for 2
    steps; `sizes` and `cli_args` override the defaults (for a rehearsal on
    the CPU only)."""
    sizes = sizes or {}
    with tempfile.TemporaryDirectory() as d:
        files = []
        for i, clip in enumerate(speech_clips(8, 4.0, 24_000, seed=16)):
            files.append(str(Path(d) / f"speech{i}.wav"))
            write_wav(files[-1], clip, 24_000)
        _lib.reset_launches()
        out = {"wm": wm_trainer(dev, codec, files, **sizes.get("wm", {})),
               "codec": codec_trainer(dev, files, **sizes.get("codec", {})),
               "gan": gan_trainer(dev, files, tree, **sizes.get("gan", {}))}
        cli_runs(Path(d), cli_args or {})
    out["launches"] = {n: k.launches for n, k in _lib.KERNELS.items()}
    print(f"launches in the trainers' kernel steps: {out['launches']}")
    for n in ("nearest_codebook", "jaxrand", "snake", "snake_backward"):
        check(out["launches"][n] > 0, f"training: {n} was not launched")
    return out


# ------------------------------------------------------------------ phase 14

MANIFOLD_ADAM_STEPS = 100  # of the semantic embed's 300, to fit the script's budget


def gradient_off(g_k: torch.Tensor, g_p: torch.Tensor, label: str) -> tuple[float, float]:
    """A detector gradient through the kernel against the plain route's, by
    the PGD rule (ROADMAP.md C): within 1e-4 of the largest |gradient| in
    all but 1% of the samples, within 1e-3 everywhere.  -> (max error
    relative to that scale, share of samples off by more than 1e-4)."""
    scale = float(g_p.abs().max())
    err = (g_k - g_p).abs()
    share = float((err > 1e-4 * scale).float().mean())
    check(scale > 0 and float(err.max()) <= 1e-3 * scale and share <= 0.01,
          f"{label}: gradient off plain by {float(err.max())} (scale {scale}), {share} of samples "
          "beyond 1e-4")
    return float(err.max()) / scale, share


def check_rvq_calls(calls) -> dict:
    """Every recorded rvq_encode_fused call against the plain encode."""
    shapes: dict = {}
    mism = frames = 0
    for (z, quantizer, strides), codes in calls:
        m, f, _ = parity.compare_rvq(codes, z, quantizer, strides)
        mism, frames = mism + m, frames + f
        shapes[tuple(z.shape)] = shapes.get(tuple(z.shape), 0) + 1
    parity.check_share(mism, frames, "interp rvq_encode_fused")
    return dict(shapes=shapes, near_codes=mism, frames=frames)


def saliency_runs(wm, marked: torch.Tensor, msg: torch.Tensor, steps: int = 16) -> dict:
    """input_gradient and integrated_gradients of the spread-spectrum score
    on the main path's batch, each against the plain route's, then the
    saliency spectrogram and the top frames: seconds and peak memory per
    call, and the device split of one IG step, with its device events
    beside the kernels it launched."""
    from nawc_tpu_torch import interp

    def score(w):
        return wm.score(w, msg)

    out = {}
    runs = {"input_gradient": lambda: interp.input_gradient(score, marked),
            "integrated_gradients": lambda: interp.integrated_gradients(score, marked, steps=steps)}
    for name, fn in runs.items():
        fn()  # cuFFT's and the allocator's warm-up
        torch.cuda.reset_peak_memory_stats()
        g, ms = synced_ms(fn)
        peak = torch.cuda.max_memory_allocated() / 2**30
        with _lib.plain_versions():
            g_p = fn()
        rel, share = gradient_off(g, g_p, name)
        check(bool(torch.isfinite(g).all()) and g.shape == marked.shape, f"{name}: {tuple(g.shape)}")
        print(f"saliency {name} {tuple(marked.shape)}: {ms / 1e3:.3f} s, peak memory {peak:.2f} GiB; "
              f"against the plain route max error {rel:.3g} of the largest |gradient|, "
              f"{share:.2%} of samples beyond 1e-4")
        out[name] = dict(s=ms / 1e3, peak_gib=peak, sal=g)
    spec, ms_spec = synced_ms(lambda: interp.saliency_spectrogram(marked, out["integrated_gradients"]["sal"]))
    top, ms_top = synced_ms(lambda: interp.topk_salient_frames(spec, 10))
    check(bool(torch.isfinite(spec).all()) and tuple(top.shape) == (marked.shape[0], 10),
          f"saliency spectrogram {tuple(spec.shape)}, top frames {tuple(top.shape)}")
    print(f"saliency_spectrogram {tuple(spec.shape)} {ms_spec / 1e3:.3f} s; topk_salient_frames "
          f"{ms_top / 1e3:.3f} s; clip 0's top frames {top[0].tolist()}")
    # a window opened 50 ms before this step lost its forward here, sswm
    # included, in three runs; one opened 1 s before held all of it
    before = {n: k.launches for n, k in _lib.KERNELS.items()}
    ev = device_events(lambda: interp.input_gradient(score, 0.5 * marked), idle_s=1.0)
    step_launches = {n: k.launches - before[n] for n, k in _lib.KERNELS.items() if k.launches > before[n]}
    kinds = by_kind(ev)
    print("one IG step (a batched gradient at alpha 0.5), device ms by kind: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])))
    print(f"  its launches {step_launches}; its trace holds the port's kernels: "
          f"{'nawc kernels' in kinds}; its {len(ev)} device events:")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total):
        print(f"    {e.self_device_time_total / 1e3:8.4f} ms {e.count:4d}x  {e.key[:110]}")
    out["spectrogram s"], out["topk s"], out["ig step"] = ms_spec / 1e3, ms_top / 1e3, kinds
    return out


def interp_phase(dev, wm, marked: torch.Tensor, msg: torch.Tensor, results_rows: list[dict],
                 n_clips: int = 16, seconds: float = 2.0, semantic_steps: int = MANIFOLD_ADAM_STEPS,
                 cli_args: tuple[str, ...] = (), held: dict | None = None) -> dict:
    """Phase 14: the probe as ``benchmark --probe`` spawns it, then the
    interpretability CLIs at their defaults on speech-like WAVs written to
    a temporary directory, each PGD mode, the saliency of the main path's
    batch and the stats CLI on phase 8's results; every kernel call held
    against its plain version (each draw against the replica, or against
    phase 2's draw of the same key and shape in `held`), and the CLIs' PNGs
    drawn where matplotlib is present.  `cli_args` adds arguments to every
    CLI (for a rehearsal on the CPU only)."""
    from nawc_tpu_torch.cli import ablation, manifold, perturbation, pgd, stats, uncertainty
    from nawc_tpu_torch.cli.common import preflight_probe
    from nawc_tpu_torch.eval import read_csv, write_results_csv
    from nawc_tpu_torch.models import semantic

    out: dict = {"s": {}}
    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        (d / "wav").mkdir()
        for i, clip in enumerate(speech_clips(n_clips, seconds, 16_000, seed=17)):
            write_wav(d / "wav" / f"speech{i}.wav", clip, 16_000)
        glob = str(d / "wav" / "*.wav")
        extra = ["--audio_glob", glob, "--codec_ckpt", str(CHECKPOINT), *cli_args]
        for name in ("spread_spectrum", "semantic_pca"):
            _, ms = synced_ms(lambda: preflight_probe(
                [name], str(CHECKPOINT), "full", 16_000, audio_glob=glob, device=dev.type))
            out["s"][f"probe {name}"] = ms / 1e3
        write_results_csv(results_rows, d / "test_results.csv")
        runs = [("perturbation", perturbation, []), ("uncertainty", uncertainty, []),
                ("ablation", ablation, ["--watermarks", "spread_spectrum", "chunked"]),
                ("manifold", manifold, ["--watermarks", "spread_spectrum", "semantic_pca"])]
        runs += [(f"pgd {m}", pgd, ["--mode", m]) for m in pgd.MODES]
        draw_ms: dict = {}
        _lib.reset_launches()
        with Recorder(ss_module, "whiten_correlate", clone=True) as sw, \
                Recorder(codec_model, "nearest_codebook") as lk, \
                Recorder(codec_api, "rvq_encode_fused") as rf, DrawRecorder() as dr:
            for label, mod, argv in runs:
                argv = argv + extra + ["--out_dir", str(d / label.replace(" ", "_"))]
                n_draws = len(dr.calls)
                with contextlib.ExitStack() as stack:
                    if label == "manifold":
                        cfgs = dict(semantic._DEFAULT_CFGS)
                        semantic._DEFAULT_CFGS["pca"] = dataclasses.replace(cfgs["pca"], steps=semantic_steps)
                        stack.callback(semantic._DEFAULT_CFGS.update, cfgs)
                    torch.cuda.reset_peak_memory_stats()
                    _, ms = synced_ms(lambda: mod.main(argv))
                    out["s"][label] = ms / 1e3
                    if label == "pgd exp_c":
                        out["exp_c peak GiB"] = torch.cuda.max_memory_allocated() / 2**30
                if len(dr.calls) > n_draws:
                    draw_ms[label] = dr.device_ms(dr.calls[n_draws:])
            out["saliency"] = saliency_runs(wm, marked, msg)
            torch.cuda.synchronize()
        launches = {n: k.launches for n, k in _lib.KERNELS.items()}
        draws = check_draws(dr.calls, held)
        _, ms = synced_ms(lambda: stats.main(["--results", str(d / "test_results.csv"),
                                              "--out_dir", str(d / "stats")]))
        out["s"]["stats"] = ms / 1e3
        out["draw ms"] = draw_ms

        tables = {name: read_csv(d / sub / name) for sub, name in [
            ("perturbation", "perturbation_analysis.csv"), ("uncertainty", "uncertainty_results.csv"),
            ("ablation", "layer_ablation.csv"), ("manifold", "manifold_analysis.csv"),
            ("pgd_attack", "pgd_attack.csv"), ("pgd_baselines", "attack_baselines.csv"),
            ("pgd_exp_a", "exp_a_metrics.csv"), ("pgd_exp_b", "exp_b_reconstruction.csv"),
            ("pgd_exp_c", "exp_c_comparison.csv"), ("pgd_interp", "pgd_interpretability.csv"),
            ("stats", "feature_importance.csv"), ("stats", "stats_by_group.csv")]}
        check_figures(interp_pngs(d, len({r["clip"] for r in tables["manifold_analysis.csv"]})), d)
    for name, rows in tables.items():
        vals = [v for r in rows for v in r.values() if isinstance(v, float)]
        check(len(rows) > 0 and all(np.isfinite(vals)), f"{name}: empty or not finite")
    unc = tables["uncertainty_results.csv"]
    acc = mean_of(unc, "correct")
    man = tables["manifold_analysis.csv"]
    att = tables["pgd_attack.csv"]
    n8 = len({r["clip"] for r in man})  # the clips of the 8-clip CLIs
    check(len(tables["layer_ablation.csv"]) == 6 * 2 * n8 and len(man) == 2 * n8
          and len(unc) == 2 * len(tables["perturbation_analysis.csv"]), "interp: row counts")
    check(acc >= 0.85, f"uncertainty: MC accuracy {acc} under the JAX test's 0.85")
    check(mean_of(att, "score_after") < mean_of(att, "score_before"), "pgd attack did not lower the score")
    ss_rows = [r for r in man if r["watermark"] == "spread_spectrum"]
    check(mean_of(ss_rows, "score_wm") > mean_of(ss_rows, "score_clean"), "manifold: marked below clean")

    s, c, r = check_sswm_calls(sw.calls, wm.presence_z0), check_lookup_calls(lk.calls), check_rvq_calls(rf.calls)
    print(f"interp CLIs and saliency: launches {launches}")
    print(f"  whiten_correlate calls by (B, T, W, K): {s['shapes']}, max|z - plain| {s['max_err']:.3g}, "
          f"near-tie bits flipped {s['near_bits']}")
    print(f"  nearest_codebook calls {c['shapes']}: {c['near_codes']} of {c['frames']} codes differ "
          f"(near-ties); rvq_encode_fused calls {r['shapes']}: {r['near_codes']} of {r['frames']} differ")
    for n in _lib.KERNELS:
        if n not in BF16_ONLY:  # interp runs the float32 codec
            check(launches[n] > 0, f"interp: kernel {n} was not launched")
    print("interp seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in out["s"].items())
          + "; device draws " + ", ".join(f"{k} {v:.3f} ms" for k, v in draw_ms.items())
          + f" ({draws['draws']} draws bit for bit the replica); peak memory of exp_c "
          f"{out['exp_c peak GiB']:.2f} GiB")
    print(f"uncertainty accuracy {acc:.4f}; pgd score {mean_of(att, 'score_before'):.4f} -> "
          f"{mean_of(att, 'score_after'):.4f}; manifold delta_att (spread_spectrum) "
          f"{mean_of(ss_rows, 'delta_att'):.4f}; baselines " + ", ".join(
              f"{b['attack']} {b['score']:.3f}" for b in tables["attack_baselines.csv"]))
    out["launches"] = launches
    return out


def interp_pngs(d: Path, n8: int) -> list[Path]:
    """The PNGs phase 14's CLIs draw: the JAX CLIs' sets, the manifold's
    per-clip triplets for its `n8` clips of each of its two watermarks."""
    names = {"perturbation": ["snr_histogram.png", "spectral_footprint.png"],
             "uncertainty": ["variance_boxplots.png", "mc_var_prob_correct_vs_wrong_hist.png",
                             "mc_var_prob_roc.png", "reliability_curve_mc_mean_prob.png"],
             "ablation": ["ablation_heatmap.png", "snac_layer_ablation_chunked.png",
                          "snac_layer_ablation_spread_spectrum.png"],
             "manifold": [f"manifold_global_{k}_all.png" for k in ("delta", "3d", "delta_bar")]
             + [f"plots/{w}/clip_{i}_proj_{w}.png" for w in ("spread_spectrum", "semantic_pca")
                for i in range(n8)],
             "pgd_baselines": ["benchmark_chart.png"], "pgd_exp_c": ["experiment_c_results.png"],
             "stats": ["feature_importance.png"]}
    return [d / sub / n for sub, ns in names.items() for n in ns]


def check_figures(paths: list[Path], root: Path) -> None:
    """With matplotlib, every PNG exists and is not empty; without it, none
    was written, and the line names them (relative to `root`)."""
    if figures.available():
        bad = [str(p) for p in paths if not (p.exists() and p.stat().st_size > 0)]
        check(not bad, f"PNGs missing or empty: {bad}")
        print(f"figures: {len(paths)} PNGs drawn, none empty")
    else:
        drawn = [str(p) for p in paths if p.exists()]
        check(not drawn, f"PNGs written without matplotlib: {drawn}")
        print(f"figures: matplotlib is not installed; {len(paths)} PNGs not drawn: "
              + ", ".join(str(p.relative_to(root)) for p in paths))


# ------------------------------------------------------------------ phase 15

def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


QUALITY_COLS = ("si_snr_clean", "si_snr_watermarked", "delta_si_snr", "snr", "lsd", "stoi", "stoi_dev",
                "lsd_native", "pesq")


def quality_runs(codec, dev, clean16: np.ndarray, d: Path, cli_args: tuple[str, ...] = ()) -> dict:
    """The quality CLI in-process at its defaults: ``--watermark
    spread_spectrum`` on 16 x 2 s speech-like WAVs, ``--results_dir`` over
    the artifact tree that ``save_artifacts`` writes from phase 8's clips
    marked by the spread-spectrum watermark and attacked by ``dac``, then
    ``--summarize_dir``; the seconds of each run and its host share (exact
    STOI and PESQ)."""
    from nawc_tpu_torch.cli import quality as quality_cli
    from nawc_tpu_torch.cli.stats import load_table
    from nawc_tpu_torch.eval import pesq_proxy, quality, stoi_exact
    from nawc_tpu_torch.eval.metrics import pesq_impl
    from nawc_tpu_torch.eval.reporting import save_artifacts

    for i, clip in enumerate(speech_clips(16, 2.0, 16_000, seed=18)):
        write_wav(d / "wav" / f"speech{i}.wav", clip, 16_000)
    ss = SpreadSpectrumWM(SpreadSpectrumConfig(alpha=0.1))
    key = jaxrand.prng_key(0)
    with torch.no_grad():
        x = torch.as_tensor(clean16, device=dev)
        marked = ss.embed(x, random_message(key, x.shape[0], ss.n_bits, device=dev))
        attacked = build_suite(16_000, codec)["dac"](marked, key)
    for i in range(x.shape[0]):
        save_artifacts(d / "artifacts", f"spread_spectrum_{i}", *(
            v[i].cpu().numpy() for v in (x, marked, attacked)), 16_000)
    check_figures([d / "artifacts" / f"spread_spectrum_{i}" / "comparison.png" for i in range(x.shape[0])], d)

    host = {"stoi": 0.0, "pesq": 0.0}
    stoi_batch, pesq_host = stoi_exact.stoi_exact_batch, quality.pesq_host

    def timed(name, fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                host[name] += time.perf_counter() - t0
        return run

    runs = [("watermark", ["--watermark", "spread_spectrum", "--audio_glob", str(d / "wav" / "*.wav"),
                           "--out_csv", str(d / "out" / "spread_spectrum_quality_results.csv")]),
            ("results_dir", ["--results_dir", str(d / "artifacts"),
                             "--out_csv", str(d / "out" / "artifacts_quality_results.csv")]),
            ("summarize_dir", ["--summarize_dir", str(d / "out")])]
    out: dict = {"s": {}, "host s": {}}
    try:
        stoi_exact.stoi_exact_batch = timed("stoi", stoi_batch)
        quality.pesq_host = timed("pesq", pesq_host)
        for label, argv in runs:
            host.update(stoi=0.0, pesq=0.0)
            _, ms = synced_ms(lambda: quality_cli.main(argv + list(cli_args)))
            out["s"][label], out["host s"][label] = ms / 1e3, dict(host)
    finally:
        stoi_exact.stoi_exact_batch, quality.pesq_host = stoi_batch, pesq_host

    tables = {name: load_table(str(d / "out" / f"{name}_quality_results.csv"))
              for name in ("spread_spectrum", "artifacts")}
    summary = load_table(str(d / "out" / "quality_summary.csv"))
    for name, rows in tables.items():
        check(len(rows) == 16, f"quality {name}: {len(rows)} rows")
        for col in QUALITY_COLS[1:]:
            check(all(np.isfinite(r[col]) for r in rows), f"quality {name}: {col} not finite")
        check(all(pesq_proxy._CLIP[0] <= r["pesq"] <= pesq_proxy._CLIP[1] for r in rows),
              f"quality {name}: PESQ outside {pesq_proxy._CLIP}")
        out[name] = {c: mean_of(rows, c) for c in QUALITY_COLS}
    check([r["method"] for r in summary] == ["artifacts", "spread_spectrum"]
          and all(r["pesq_impl"] == pesq_impl() for r in summary), f"quality summary {summary}")
    same = stoi_batch(clean16[:4], clean16[:4], 16_000)
    check(bool(np.all(np.abs(same - 1.0) <= 1e-9)), f"exact STOI of identical pairs {same}")
    for label in out["s"]:
        h = out["host s"][label]
        print(f"quality {label}: {out['s'][label]:.2f} s, host exact STOI {h['stoi']:.2f} s and PESQ "
              f"{h['pesq']:.2f} s ({100 * (h['stoi'] + h['pesq']) / out['s'][label]:.0f}%)")
    for name in tables:
        print(f"quality {name} means: " + ", ".join(f"{k} {v:.4f}" for k, v in out[name].items()))
    print(f"pesq_impl {pesq_impl()}; exact STOI of 4 identical pairs {same.tolist()}")
    out["pesq_impl"] = pesq_impl()
    return out


def parallel_runs(codec, dev, wm, wav: torch.Tensor, msg: torch.Tensor, entry_out, d: Path,
                  train_batch: tuple[int, int] = (16, 32_768)) -> dict:
    """At world size 1 (NCCL on the card): the sharded evaluation of the
    main path's batch against the entry's outputs bit for bit, one
    data-parallel codec train step against the meshless step from the same
    state, the tensor-parallel lookup of the level-0 codebook, and the
    combine over 2, 4 and 8 slices of that codebook in one process; every
    kernel call held against plain; each stage's device ms from the
    recorder's spans and one trace of the sharded evaluation."""
    import torch.distributed as dist

    from nawc_tpu_torch.parallel import combine_shards, make_mesh, make_sharded_eval, tp_nearest_codebook
    from nawc_tpu_torch.parallel import tp as tp_module
    from nawc_tpu_torch.utils import profiling

    marked_e, presence_e, bits_e = entry_out

    def stage(name: str):
        return profiling.annotate(name, dev)

    out: dict = {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(device=dev.type)
        print(f"mesh {mesh.shape} over {dist.get_backend()} on {mesh.device}")
        run = make_sharded_eval(codec, wm, mesh)
        run.gather(*run(wav, msg))  # cuFFT's, cuDNN's and NCCL's warm-up
        _lib.reset_launches()
        profiling.snapshot()
        profiling.enable()
        with Recorder(ss_module, "whiten_correlate") as sw, Recorder(codec_model, "nearest_codebook") as lk:
            with stage("sharded eval (16 x 4 s)"):
                shards = run.gather(*run(wav, msg))
        marked, attacked, presence, bits = shards
        with stage("codec round-trip (entry's)"):
            attacked_e = codec_roundtrip(codec, marked_e, in_sr=wm.sample_rate)
        for label, a, b in [("marked", marked, marked_e), ("attacked", attacked, attacked_e),
                            ("presence", presence, presence_e), ("bits", bits, bits_e)]:
            check(torch.equal(a, b), f"sharded eval: {label} differs from the entry's by "
                  f"{float((a.float() - b.float()).abs().max())}")
        print("sharded eval equals the entry path bit for bit (marked, attacked, presence, bits)")

        # the trained codec's weights (the seeded init's host draws take
        # longer than this whole phase), train_codec's optimiser defaults
        model = trainable_codec(CodecConfig(), 0, dev, tree=load_params(CHECKPOINT))
        state = CodecTrainState(model, make_optimizer(model.parameters(), lr=3e-4, total=20_000), 0)
        twin = copy.deepcopy(state)
        n, samples = train_batch
        w = torch.as_tensor(np.stack(speech_clips(n, samples / SR, SR, seed=19)), device=dev)
        with Recorder(codec_model, "nearest_codebook", clone=True) as lt:
            with stage("codec step, meshless"):
                want = make_codec_train_step(CodecConfig())(twin, w)
            with stage("codec step, mesh (DDP)"):
                got = make_codec_train_step(CodecConfig(), mesh=mesh)(state, w)
        del twin, state, model
        for k, v in want.items():
            if k.startswith("usage_"):
                check(torch.equal(got[k], v), f"dp step: {k} differs")
            else:
                a, b = float(got[k]), float(v)
                check(np.isfinite(a) and abs(a - b) <= LOSS_RTOL * max(abs(b), 1e-6),
                      f"dp step: {k} {a} against {b} meshless")
        print(f"dp codec step ({n} x {samples}): every metric within 1e-5 of the meshless step: "
              + ", ".join(f"{k} {float(got[k]):.5f}" for k in ("loss", "stft", "si_snr")))

        cb = codec.model.quantizer.levels[0].codebook.detach()
        z = next(a[0] for a, _ in lk.calls if a[1].data_ptr() == cb.data_ptr())
        with Recorder(tp_module, "nearest_codebook") as tk:
            whole = rvq.nearest_codebook(z, cb)
            with stage("tp lookup, level 0"):
                codes = tp_nearest_codebook(z, cb, mesh)
            check(torch.equal(codes, whole), "tp_nearest_codebook differs from nearest_codebook")
            margin = rvq.score_margin(z, cb)
            near = {}
            for n_slices in (2, 4, 8):
                rows = cb.shape[0] // n_slices
                with stage(f"combine over {n_slices} slices"):
                    pairs = [tp_module.shard_best(z, cb[s * rows:(s + 1) * rows], s * rows)
                             for s in range(n_slices)]
                    combined = combine_shards(torch.stack([p[0] for p in pairs]),
                                              torch.stack([p[1] for p in pairs]))
                near[n_slices] = parity.near_tie_mismatches(combined, whole, margin)
                parity.check_share(near[n_slices], whole.numel(), f"combine over {n_slices} slices")
        print(f"tp lookup of {tuple(z.shape)} over the level-0 codebook {tuple(cb.shape)} equals "
              f"nearest_codebook; the combine over 2 / 4 / 8 slices: near-tie codes off the whole "
              f"lookup {near}")
        torch.cuda.synchronize()
        launches = {n_: k.launches for n_, k in _lib.KERNELS.items()}
        profiling.disable()
        recorded = profiling.snapshot()
        stages = {sp["name"]: sp["device_ms"] if sp["device_ms"] is not None
                  else (sp["end_ns"] - sp["start_ns"]) / 1e6
                  for sp in recorded["spans"] if sp["parent"] is None}
        check(all(recorded["counters"].get(f"launches.{n_}", 0) == k
                  for n_, k in launches.items()), "parallel: the recorder's launch counts differ")

        s, c = check_sswm_calls(sw.calls, wm.presence_z0), check_lookup_calls(lk.calls + lt.calls + tk.calls)
        print(f"parallel: launches {launches}")
        print(f"  whiten_correlate calls {s['shapes']}, max|z - plain| {s['max_err']:.3g}; "
              f"nearest_codebook calls {c['shapes']}: {c['near_codes']} of {c['frames']} codes differ "
              "(near-ties)")
        for n_ in ("whiten_correlate", "nearest_codebook"):
            check(launches[n_] > 0, f"parallel: kernel {n_} was not launched")

        with profiling.trace(d / "trace"):
            run.gather(*run(wav, msg))
        path = d / "trace" / "trace.json"
        check(path.exists() and path.stat().st_size > 0, "no trace written")
        text = path.read_text()
        names = {k: k in text for k in ("sswm_correlate_kernel", "nearest_codebook_kernel")}
        spans = {sp["name"] for sp in json.loads((d / "trace" / "spans.json").read_text())["spans"]}
        print(f"trace of the sharded eval: {path.stat().st_size} bytes; names the kernels: {names}; "
              f"program spans {sorted(spans)}")
        check({"ss.embed", "codec.encode", "codec.decode", "ss.detect"} <= spans,
              "parallel: the trace's spans.json lacks the program's spans")
        for name, ms in stages.items():
            print(f"{name:30s} {ms:10.2f} ms")
        out.update(launches=launches, trace_names=names, near=near, stages=stages)
    finally:
        dist.destroy_process_group()
    return out


def quality_parallel_phase(dev, codec, wm, wav: torch.Tensor, msg: torch.Tensor, entry_out,
                           clean16: np.ndarray, cli_args: tuple[str, ...] = (),
                           train_batch: tuple[int, int] = (16, 32_768)) -> dict:
    """Phase 15: scipy present, the quality CLI's three modes, then the
    parallel paths at world size 1.  `cli_args` and `train_batch` are for a
    rehearsal on the CPU only."""
    import scipy.signal  # noqa: F401  (the host metrics resample with it; its absence fails the phase)

    with tempfile.TemporaryDirectory() as d:
        d = Path(d)
        out = {"quality": quality_runs(codec, dev, clean16, d, cli_args)}
        out["parallel"] = parallel_runs(codec, dev, wm, wav, msg, entry_out, d, train_batch)
    out["launches"] = out["parallel"]["launches"]
    return out


# ------------------------------------------------------------------ main

# ------------------------------------------------------------------ phase 16

SNAC_CONFIG = REPO / "port_bench" / "configs" / "snac44k-bf16.json"


def snac_phase(dev, n_clips: int = BATCH, seconds: float = SECONDS, seed: int = 23) -> dict:
    """The path of the benchmark cell ``snac44k-roundtrip-bf16``:
    ``entry(codec)``'s ``fn`` (embed -> pad, SNAC encode, RVQ, decode with
    noise -> detect) with the SNAC codec built as the cell builds it, on
    `n_clips` x `seconds` s of seeded noise at 44.1 kHz.  After one warm
    call the launch counts are reset; the next call must launch ``dwconv``
    26 times (13 in the encoder, 13 in the decoder), its 29 k 1 convs on
    the GEMM path (``k1conv``) and the stencil kernel (``same_conv``) not
    at all, and give finite outputs.  -> its launches and ms per call."""
    from port_bench.weights_snac import make_codec as snac_codec

    codec, _ = snac_codec(json.loads(SNAC_CONFIG.read_text())["codec"], seed, dev)
    fn, (_, msg0) = entry(codec, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wav = torch.randn(n_clips, int(seconds * codec.cfg.sample_rate), generator=gen, device=dev) * 0.1
    msg = torch.randint(0, 2, (n_clips, msg0.shape[1]), generator=gen, device=dev, dtype=torch.int32)
    fn(wav, msg)
    torch.cuda.synchronize()
    _lib.reset_launches()
    outs = fn(wav, msg)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in _lib.KERNELS.items()}
    print(f"one SNAC 44 kHz bf16 call, {n_clips} x {seconds} s: launches {launches}")
    check(launches["dwconv"] == 26, f"one SNAC bf16 call launched dwconv {launches['dwconv']} times, not 26")
    check(launches["same_conv"] == 0,
          f"one SNAC bf16 call launched same_conv {launches['same_conv']} times, not 0")
    check(launches["k1conv"] == 29,
          f"one SNAC bf16 call took the k1 GEMM path {launches['k1conv']} times, not 29")
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs), "the SNAC bf16 call is not finite")
    ms = wall_ms(lambda: fn(wav, msg), iters=5, warmup=1)
    print(f"SNAC 44 kHz bf16 entry: {ms:.2f} ms a call ({n_clips * seconds / (ms / 1e3):.1f} s of audio a s)")
    del fn, codec, outs
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms)


# ------------------------------------------------------------------ phase 17

MIMI_CONFIG = REPO / "port_bench" / "configs" / "mimi-bf16.json"


def mimi_phase(dev, n_clips: int = BATCH, seconds: float = 30.0, seed: int = 29) -> dict:
    """The path of the benchmark cell ``mimi-roundtrip-bf16``:
    ``entry(codec)``'s ``fn`` (embed -> pad, Mimi's causal SEANet encoder,
    transformer and downsampler, the split Euclidean RVQ, the upsampler,
    transformer and SEANet decoder -> detect) with the Mimi codec built as
    the cell builds it, on `n_clips` x `seconds` s of seeded noise at 24
    kHz.  After one warm call the launch counts are reset; the next call
    must launch the stencil kernel (``same_conv``) 10 times (the causal
    k 3 / k 7 convs), its 8 k 1 convs on the GEMM path (``k1conv``), the
    depthwise kernel not at all, and give finite outputs.  -> its launches
    and ms per call."""
    from port_bench.weights_mimi import make_codec as mimi_codec

    codec, _ = mimi_codec(json.loads(MIMI_CONFIG.read_text())["codec"], seed, dev)
    fn, (_, msg0) = entry(codec, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    wav = torch.randn(n_clips, int(seconds * codec.cfg.sample_rate), generator=gen, device=dev) * 0.1
    msg = torch.randint(0, 2, (n_clips, msg0.shape[1]), generator=gen, device=dev, dtype=torch.int32)
    fn(wav, msg)
    torch.cuda.synchronize()
    _lib.reset_launches()
    outs = fn(wav, msg)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in _lib.KERNELS.items()}
    print(f"one Mimi bf16 call, {n_clips} x {seconds} s: launches {launches}")
    check(launches["same_conv"] == 10,
          f"one Mimi bf16 call launched same_conv {launches['same_conv']} times, not 10")
    check(launches["k1conv"] == 8, f"one Mimi bf16 call took the k1 GEMM path {launches['k1conv']} times, not 8")
    check(launches["dwconv"] == 0, f"one Mimi bf16 call launched dwconv {launches['dwconv']} times, not 0")
    check(all(bool(torch.isfinite(o.float()).all()) for o in outs), "the Mimi bf16 call is not finite")
    ms = wall_ms(lambda: fn(wav, msg), iters=5, warmup=1)
    print(f"Mimi bf16 entry: {ms:.2f} ms a call ({n_clips * seconds / (ms / 1e3):.1f} s of audio a s)")
    del fn, codec, outs
    torch.cuda.empty_cache()
    return dict(launches=launches, ms=ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    with phase("0 card"):
        device_name = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        smi = nvidia_smi_line()
        print(f"device {device_name!r}, count {count}; nvidia-smi: {smi}")
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
        print(f"matplotlib present: {figures.available()} (the CLIs' PNGs are drawn only with it)")

    with phase("1 build"):
        path, log = _lib.build()
        for line in log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(line.strip())
        _lib.library()
        print(f"built {path.relative_to(REPO)}")
        text = snake_times.sass_text(path, _lib.find_nvcc())
        funcs = sass_functions(text)
        check_jaxrand_build(funcs, log)
        sass = check_snake_build(text, log)
        check_clean_build("same_conv", log)
        check_clean_build("dwconv", log)

    with phase("2 kernels vs plain"):
        rec = {
            "whiten_correlate": check_sswm(dev),
            "nearest_codebook": check_nearest_codebook(dev),
            "rvq_encode_fused": check_rvq_fused(
                dev, random_quantizer(CodecConfig(), dev, 3), [(BATCH, 192), (3, 100), (BATCH, 188)],
                "random tables"),
            "jaxrand": check_jaxrand(dev),
            **check_snake(dev, sass),
            **check_same_conv(dev),
            "dwconv": check_dwconv(dev),
        }

    with phase("3 weights"):
        codec = load_codec(CHECKPOINT, CodecConfig(), device=dev)
        n_params = sum(p.numel() for p in codec.model.parameters())
        print(f"loaded {CHECKPOINT.relative_to(REPO)}: {n_params} parameters on {codec.device}")
        check_rvq_fused(dev, codec.model.quantizer, [(4, 256), (4, 768)], "trained tables")

    with phase("4 main path"):
        fn, _ = entry(codec=codec, device=dev)
        wav = torch.as_tensor(np.random.default_rng(0).normal(size=(BATCH, SR * SECONDS)) * 0.1,
                              dtype=torch.float32, device=dev)
        msg = torch.as_tensor(
            np.random.default_rng(1).integers(0, 2, (BATCH, 16)), dtype=torch.int32, device=dev)
        _lib.reset_launches()
        marked, presence, bits = fn(wav, msg)
        codes = codec.encode(codec.pad(marked))
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in _lib.KERNELS.items()}
        print(f"launches on the main path: {launches}")
        for n in MAIN_KERNELS:
            check(launches[n] > 0, f"kernel {n} was not launched on the main path")

        _, wm = flagship(codec, dev)  # the watermarker `fn` runs
        with _lib.plain_versions():
            marked_p, presence_p, bits_p = fn(wav, msg)
            z_p = wm._correlate(codec_roundtrip(codec, marked_p, in_sr=SR))
            mism, frames, gap = parity.compare_rvq(
                codes, codec.model.encode_latent(codec.pad(marked)),
                codec.model.quantizer, codec.cfg.vq_strides)
        err_m = float((marked - marked_p).abs().max())
        err_p = float((presence - presence_p).abs().max())
        sure = z_p.abs() > BIT_Z_MIN
        check(err_m <= MARKED_TOL, f"marked audio differs from plain by {err_m}")
        check(err_p <= PRESENCE_TOL, f"presence differs from plain by {err_p}")
        check(bool((bits == bits_p)[sure].all()), "bits differ from plain where |z| > 1e-2")
        check(all(bool(torch.isfinite(x).all()) for x in (marked, presence)), "non-finite output")
        check(tuple(marked.shape) == (BATCH, SR * SECONDS), f"marked shape {tuple(marked.shape)}")
        print(f"marked vs plain {err_m:.3g}, presence vs plain {err_p:.3g}, "
              f"encode codes {[tuple(c.shape) for c in codes]}: {mism} of {frames} differ (near-ties, "
              f"max score gap {gap:.3g})")
        _, bits_clean = wm.detect(marked)
        acc_clean = float(bit_accuracy(bits_clean, msg).mean())
        acc_rt = float(bit_accuracy(bits, msg).mean())
        check(acc_clean == 1.0, f"clean-channel bit accuracy {acc_clean} != 1.0")
        print(f"bit accuracy: clean {acc_clean:.4f}, after the codec round-trip {acc_rt:.4f}; "
              f"presence after the round-trip mean {float(presence.mean()):.4f}")

    with phase("5 serving"):
        svc = WatermarkService(wm, buckets=(24_000, 48_000, 96_000, 120_000), max_batch=4, device=dev)
        rng = np.random.default_rng(2)
        secs = [0.7, 1.3, 2.0, 2.9, 4.0, 5.0]
        clips = [(rng.normal(size=int(s * SR)) * 0.1).astype(np.float32) for s in secs]
        msgs = rng.integers(0, 2, (len(clips), 16)).astype(np.int32)
        out = svc.embed(clips, msgs)
        check([len(o) for o in out] == [len(c) for c in clips], "serving changed clip lengths")
        pres, sbits = svc.detect(out)
        check(bool((sbits == msgs).all()),
              f"serving: bits did not round-trip: {(sbits == msgs).mean(1)}")
        print(f"serving {len(clips)} requests ({secs} s): bits round-trip, "
              f"presence {np.round(pres, 4).tolist()}")

    with phase("6 timing"), torch.no_grad():
        def step(x):
            m = wm.embed(x, msg)
            c = codec.encode(codec.pad(m))
            p, b = wm.detect(m)
            eps = (c[0].float().mean() + p.mean() + b.float().mean()) * 1e-4
            return torch.roll(m, 1, dims=0) * (1.0 + eps)

        stages = {
            "embed": lambda x: torch.roll(wm.embed(x, msg), 1, dims=0),
            "codec encode": lambda x: x * (1.0 + codec.encode(codec.pad(x))[0].float().mean() * 1e-6),
            "detect": lambda x: x * (1.0 + wm.detect(x)[0].mean() * 1e-5),
            "embed + encode + detect": step,
        }
        stage_ms = {}
        for label, fn_ in stages.items():
            stage_ms[label] = chained_ms(fn_, marked if label in ("codec encode", "detect") else wav)
            print(f"{label}, {BATCH} x {SECONDS} s: {stage_ms[label]:.3f} ms per batch")
        ms_batch = stage_ms["embed + encode + detect"]
        xrt = BATCH * SECONDS / (ms_batch / 1e3)
        print(f"embed + encode + detect: {xrt:.1f}x real time on {smi}")

    with phase("7 profile"), torch.no_grad():
        x_prof = wav * 1.002
        kernels_ev = sorted(device_events(lambda: step(x_prof)),
                            key=lambda e: -e.self_device_time_total)
        busy_ms = sum(e.self_device_time_total for e in kernels_ev) / 1e3
        groups = by_kind(kernels_ev)
        print(f"one step: {busy_ms:.3f} ms of kernel time = {100 * busy_ms / ms_batch:.1f}% of the "
              f"{ms_batch:.3f} ms per batch timed without the profiler")
        print("by kind: " + ", ".join(f"{k} {v:.3f} ms"
                                      for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
        for e in kernels_ev[:12]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")

    with phase("8 sweep"):
        swept = sweep(codec, dev)
        sweep_launches = {n: sum(swept[k]["launches"][n] for k in
                                 ("spread_spectrum", "sync", "combined", "psychoacoustic"))
                          for n in _lib.KERNELS}
        sweep_launches["whiten_correlate"] += swept["discovery launches"]
        print(f"launches in the sweep's kernel runs: {sweep_launches}; their draws "
              f"{sum(swept[k]['draw_ms'] for k in ('spread_spectrum', 'sync', 'combined', 'psychoacoustic')):.3f}"
              " ms of device time")
        x16 = speech_clips(16, 4.0, 16_000, seed=10)
        ss = SpreadSpectrumWM(SpreadSpectrumConfig(alpha=0.1))
        suite16 = build_suite(16_000, codec)
        suite16.pop("identity")
        ev = device_events(lambda: run_robustness(ss, suite16, x16, 16_000, 2.0, device=dev))
        groups = by_kind(ev)
        busy = sum(groups.values()) / 1e3
        print(f"one spread_spectrum robustness run: {busy:.3f} s of kernel time, "
              f"{100 * busy / swept['spread_spectrum']['wall']:.1f}% of its unprofiled wall time "
              f"({swept['spread_spectrum']['wall']:.2f} s); by "
              "kind: " + ", ".join(f"{k} {v:.3f} ms"
                                   for k, v in sorted(groups.items(), key=lambda kv: -kv[1])))
        for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d}x  {e.key[:100]}")

    with phase("9 bf16 codec"):
        codec16 = load_codec(CHECKPOINT, CodecConfig(compute_dtype="bfloat16"), device=dev)
        _lib.reset_launches()
        bf16 = bf16_codec(codec, codec16, marked)
        bf16_launches = {n: k.launches for n, k in _lib.KERNELS.items()}
        with torch.no_grad():
            def step16(x):
                m = wm.embed(x, msg)
                c = codec16.encode(codec16.pad(m))
                p, b = wm.detect(m)
                eps = (c[0].float().mean() + p.mean() + b.float().mean()) * 1e-4
                return torch.roll(m, 1, dims=0) * (1.0 + eps)

            ms16 = chained_ms(step16, wav)
            enc16 = chained_ms(
                lambda x: x * (1.0 + codec16.encode(codec16.pad(x))[0].float().mean() * 1e-6), marked)
        print(f"embed + bf16 encode + detect, {BATCH} x {SECONDS} s: {ms16:.3f} ms per batch "
              f"({BATCH * SECONDS / (ms16 / 1e3):.1f}x real time), float32 {ms_batch:.3f} ms; "
              f"bf16 codec encode {enc16:.3f} ms, float32 {stage_ms['codec encode']:.3f} ms")
        print(f"launches in the bf16 checks: {bf16_launches}")
        for n in ("rvq_encode_fused", "snake"):
            check(bf16_launches[n] > 0, f"bf16 encode did not launch {n}")
        check(bf16_launches["same_conv"] == 26,
              f"one bf16 encode and decode launched same_conv {bf16_launches['same_conv']} times, not 26")
        check(bf16_launches["k1conv"] == 24,
              f"one bf16 encode and decode took the k1 GEMM path {bf16_launches['k1conv']} times, not 24")
        del codec16

    with phase("10 codec-latent watermarks"):
        latent = codec_latent(codec, dev)

    with phase("11 pgd"):
        pgd = pgd_phase(dev)

    with phase("12 neural watermark"):
        neural = neural_phase(codec, dev)

    with phase("13 training"):
        train = training_phase(dev, codec, load_params(CHECKPOINT))

    with phase("14 interpretability"):
        interp = interp_phase(dev, wm, marked, msg, swept["spread_spectrum"]["rows"],
                              held=rec["jaxrand"]["held"])

    with phase("15 quality and parallel"):
        qp = quality_parallel_phase(dev, codec, wm, wav, msg, (marked, presence, bits), np.stack(x16))

    with phase("16 SNAC bf16 main path"):
        snac = snac_phase(dev)

    with phase("17 Mimi bf16 main path"):
        mimi = mimi_phase(dev)

    print(f"total {time.perf_counter() - t_start:.1f} s")
    # the draw kernel replaces XLA's fusion of jax.random (threefry, erf_inv) in
    # the JAX package's noise draws, the Snake kernels XLA's fusion of
    # Snake.__call__ and its autodiff, not Pallas kernels
    files = {"whiten_correlate": ("sswm.cu", "nawc_tpu/ops/sswm.py:179"),
             "nearest_codebook": ("rvq.cu", "nawc_tpu/ops/rvq.py:55"),
             "rvq_encode_fused": ("rvq_fused.cu", "nawc_tpu/ops/rvq_fused.py:107"),
             "jaxrand": ("jaxrand.cu", "nawc_tpu/interp/uncertainty.py:28"),
             "snake": ("snake.cu", "nawc_tpu/codec/layers.py:42"),
             "snake_backward": ("snake.cu", "nawc_tpu/codec/layers.py:42"),
             "same_conv": ("same_conv.cu", "none: XLA's convolutions of nawc_tpu/codec/layers.py"),
             "k1conv": ("same_conv.cu", "none: XLA's convolutions of nawc_tpu/codec/layers.py"),
             "dwconv": ("dwconv.cu", "none: the JAX package has no depthwise convolution")}
    on = {"sweep (phase 8)": sweep_launches, "training (phase 13)": train["launches"],
          "bf16 codec (phase 9)": bf16_launches, "SNAC bf16 main path (phase 16)": snac["launches"],
          "Mimi bf16 main path (phase 17)": mimi["launches"]}
    kernels = []
    for n, (src, replaces) in files.items():
        r = rec[n]
        check(r["ms"] > 0 and r["plain_ms"] > 0 and r["library_ms"] != 0,
              f"{n}: a time of 0 ms is a profiler window that lost its events: {r}")
        where = LAUNCHES_ON.get(n, "main path (phase 4)")
        kernels.append({
            "name": n, "route": "cuda", "source": f"nawc_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": on[where][n] if where in on else launches[n],
            "launches_on": where,
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "main_launches": launches[n],
            "sweep_launches": sweep_launches[n],
            "bf16_launches": bf16_launches[n],
            "codec_latent_launches": latent["launches"][n],
            "pgd_launches": pgd["launches"][n],
            "neural_launches": neural["launches"][n],
            "train_launches": train["launches"][n],
            "interp_launches": interp["launches"][n],
            "quality_parallel_launches": qp["launches"][n],
            "snac_launches": snac["launches"][n],
            "mimi_launches": mimi["launches"][n],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
