"""Device time of each convolution layer of the codec, kernel by kernel.

    python3 -m nawc_tpu_torch.tools.conv_layers [--codec codec24k|snac44k|mimi]
                                                [--dtype bfloat16] [--out layers.json]

Builds the codec (``codec24k``: ``CodecConfig()``'s widths; ``snac44k``:
``CodecConfig.snac_44khz()``; ``mimi``: ``CodecConfig.mimi()``) in the
given compute type on the card (random weights: the kernels cuDNN picks
depend on shapes alone, ``cudnn.benchmark`` off), runs one encode and
decode of a batch of 16 clips at the benchmark's padded length (98,304
samples at 24 kHz, 184,320 at 44.1 kHz: 4 s; Mimi's 720,000: 30 s), keeps each
convolution module's inputs, and then profiles each module alone on them
(``torch.profiler``, 3 calls after a warm one): its pads, casts, convolution
and bias kernels.  Where a ``ResidualUnit`` adds ``x + y`` outside its
convolutions, that add is profiled as a layer of its own.  Prints the
device ms per call of each layer kind by kernel, each depthwise layer's
share of its byte bound (``ops.dwconv.bound_bytes`` at 3.35 TB/s) and,
in bfloat16, each k = 1 layer's share of its bound (``ops.same_conv.bound_counts``:
bytes at 3.35 TB/s or operations at 989 TFLOP/s, the larger), and with
``--out`` writes every layer's row as JSON.  Runs on a CUDA device only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..codec.api import MODELS
from ..codec.layers import ResidualUnit, SameConv1d, SameConvTranspose1d
from ..codec.mimi import CausalConvTranspose1d
from ..ops import dwconv, same_conv
from ..utils.config import CodecConfig

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 (NVIDIA data sheet)
CODECS = {"codec24k": (CodecConfig, 98_304), "snac44k": (CodecConfig.snac_44khz, 184_320),
          "mimi": (CodecConfig.mimi, 720_000)}


def stride1_geometries(cfg: CodecConfig = CodecConfig(), samples: int = 98_304) -> list[tuple]:
    """(C_in, C_out, k, dilation, residual, T) of the stride-1 convolutions
    of one encode and decode of `samples` samples that ``ops.same_conv``
    takes in bfloat16, in the codec's order: each ResidualUnit's Conv_0 (k 7
    at dilation 1, 3, 9) and Conv_1 (k 1, with the unit's residual), the
    encoder's Conv_1 and the decoder's Conv_0 (50 at ``CodecConfig()``)."""
    out, t, d = [], samples, cfg.encoder_dim

    def units(dim, t):
        return [g for dil in (1, 3, 9) for g in ((dim, dim, 7, dil, False, t), (dim, dim, 1, 1, True, t))]

    for rate in cfg.encoder_rates:
        out += units(d, t)
        d, t = d * 2, t // rate
    out += [(d, cfg.latent_dim, 3, 1, False, t), (cfg.latent_dim, cfg.decoder_dim, 7, 1, False, t)]
    d = cfg.decoder_dim
    for rate in cfg.decoder_rates:
        d, t = d // 2, t * rate
        out += units(d, t)
    return out


def k1_geometries(cfg: CodecConfig = CodecConfig(), samples: int = 98_304) -> list[tuple]:
    """(C_in, C_out, residual, bias, T) of the stride-1 one-group k 1
    convolutions of one encode and decode of `samples` samples, in the
    codec's order, read by forward hooks from a shape pass of the codec on
    the meta device: each ResidualUnit's Conv_1 (with the unit's residual)
    and, in SNAC's layout, the decoder's head conv and each noise block's
    conv (no bias, no residual): 24 at ``CodecConfig()``, 29 at
    ``snac_44khz()``; Mimi's residual blocks' Conv_1: 8 at ``mimi()``."""
    with torch.device("meta"):
        model = MODELS[cfg.layout].module(cfg).eval()
    out = []
    for m in model.modules():
        if isinstance(m, SameConv1d) and m.kernel_size[0] == m.stride[0] == m.groups == 1:
            m.register_forward_hook(lambda mod, args, kwargs, y: out.append(
                (mod.in_channels, mod.out_channels, kwargs.get("residual") is not None, mod.bias is not None,
                 args[0].shape[-1])), with_kwargs=True)
    with torch.no_grad():
        model.decoder(model.encoder(torch.zeros(1, samples, device="meta")))
    return out


def causal_geometries(cfg: CodecConfig = CodecConfig.mimi(), samples: int = 720_000) -> list[tuple]:
    """(C_in, C_out, k, dilation, left pad, T) of the stride-1 one-group
    convs with k > 1 of one encode and decode of `samples` samples in
    Mimi's layout, which ``ops.same_conv`` takes in bfloat16 at their causal
    padding (d (k - 1) zeros on the left), in the codec's order, read by
    forward hooks from a shape pass on the meta device: each residual
    block's Conv_0 (k 3), the encoder's Conv_1 (k 3) and the decoder's
    Conv_0 (k 7): 10 at ``mimi()``."""
    with torch.device("meta"):
        model = MODELS[cfg.layout].module(cfg).eval()
    out = []
    x = torch.zeros(1, 16, 8, dtype=torch.bfloat16)
    for m in model.modules():
        if not isinstance(m, SameConv1d) or m.kernel_size[0] == 1:
            continue
        if same_conv.takes(x, m.in_channels, m.out_channels, m.kernel_size[0], m.stride[0], m.dilation[0],
                           m.groups, m.pads(8)):
            m.register_forward_hook(lambda mod, args, y: out.append(
                (mod.in_channels, mod.out_channels, mod.kernel_size[0], mod.dilation[0],
                 mod.pads(args[0].shape[-1])[0], args[0].shape[-1])))
    with torch.no_grad():
        model.decoder(model.encoder(torch.zeros(1, samples, device="meta")))
    return out


def depthwise_geometries(cfg: CodecConfig = CodecConfig.snac_44khz(),
                         samples: int = 184_320) -> list[tuple]:
    """(C, k, dilation, T) of the depthwise convolutions of one encode and
    decode of `samples` samples in SNAC's layout (``cfg.depthwise``), in the
    codec's order: each ResidualUnit's Conv_0 (k 7 at dilation 1, 3, 9), the
    encoder's and the decoder's DWConv_0 (26 at ``snac_44khz()``)."""
    if not cfg.depthwise:
        return []
    out, t, d = [], samples, cfg.encoder_dim
    for rate in cfg.encoder_rates:
        out += [(d, 7, dil, t) for dil in (1, 3, 9)]
        d, t = d * 2, t // rate
    out += [(d, 7, 1, t), (cfg.latent_dim, 7, 1, t)]
    d = cfg.decoder_dim
    for rate in cfg.decoder_rates:
        d, t = d // 2, t * rate
        out += [(d, 7, dil, t) for dil in (1, 3, 9)]
    return out


def _kind(path: str, mod, args, kwargs) -> str:
    x = args[0]
    k, s, d = mod.kernel_size[0], mod.stride[0], mod.dilation[0]
    c_in, c_out = mod.in_channels, mod.out_channels
    if isinstance(mod, (SameConvTranspose1d, CausalConvTranspose1d)):
        return f"ConvTranspose {c_in}->{c_out} s{s}" + (f" groups {mod.groups}" if mod.groups > 1 else "")
    if ".Res.Conv_" in path:  # Mimi's residual blocks, causal
        return f"Res {path[-6:]} {c_in}->{c_out} k{k}" + (" +res" if kwargs.get("residual") is not None else "")
    if mod.groups > 1 and mod.groups == c_in == c_out:
        return f"depthwise {c_in} k{k} d{d} T {x.shape[-1]}"
    if ".ResidualUnit_" in path and path.endswith("Conv_0"):
        return f"RU Conv_0 {c_in} k{k} d{d}"
    if ".ResidualUnit_" in path:
        return f"RU Conv_1 {c_in} k{k}" + (" +res" if kwargs.get("residual") is not None else "")
    if s > 1:
        return f"strided Conv {c_in}->{c_out} k{k} s{s}"
    return f"{path.split('.')[0]} {path.split('.')[-1]} {c_in}->{c_out} k{k} ({str(x.dtype)[6:]})"


def _device_ms(fn, calls: int = 3) -> dict[str, float]:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # the window's first records can be lost
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = defaultdict(float)
    for e in prof.key_averages():
        # the program's spans (``codec.dwconv``) show on the device as annotations, not kernels
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            out[e.key] += e.self_device_time_total / 1e3 / calls
    return dict(out)


def layer_rows(dtype: str, batch: int = 16, codec: str = "codec24k") -> list[dict]:
    dev = torch.device("cuda")
    make, samples = CODECS[codec]
    cfg = make(compute_dtype=dtype)
    model = MODELS[cfg.layout].module(cfg).to(dev).eval()
    captured: list[tuple[str, torch.nn.Module, tuple, dict]] = []
    adds: list[tuple[str, torch.Tensor, torch.Tensor]] = []
    hooks = []
    for path, mod in model.named_modules():
        if isinstance(mod, (SameConv1d, SameConvTranspose1d, CausalConvTranspose1d)):
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a, kw, _p=path: captured.append((_p, m, a, dict(kw))), with_kwargs=True))
        elif isinstance(mod, ResidualUnit):
            def keep(m, a, out, _p=path):
                if "residual" not in captured[-1][3]:  # the add is outside the conv
                    adds.append((_p, a[0], out - a[0]))
            hooks.append(mod.register_forward_hook(keep))
    wav = torch.randn(batch, samples, device=dev) * 0.1
    with torch.no_grad():
        model.decoder(model.encoder(wav))
    for h in hooks:
        h.remove()
    rows = []
    with torch.no_grad():
        for path, mod, args, kwargs in captured:
            ms = _device_ms(lambda: mod(*args, **kwargs))
            rows.append(dict(layer=path, kind=_kind(path, mod, args, kwargs),
                             shape=list(args[0].shape), kernels=ms, ms=sum(ms.values())))
            b, c, t = args[0].shape
            if rows[-1]["kind"].startswith("depthwise"):
                nbytes = dwconv.bound_bytes(b, c, t, mod.kernel_size[0])
                rows[-1]["bound_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
            elif (isinstance(mod, SameConv1d) and mod.kernel_size[0] == mod.stride[0] == mod.groups == 1
                  and args[0].dtype == torch.bfloat16):  # the bound's bytes and peak are bfloat16's
                res = kwargs.get("residual") is not None
                nbytes, flops = same_conv.bound_counts(b, c, mod.out_channels, t, 1, res)
                rows[-1].update(k1=True, bound_ms=max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS) * 1e3)
        for path, x, y in adds:
            ms = _device_ms(lambda: x + y)
            rows.append(dict(layer=path + ".add", kind=f"RU x + y {x.shape[1]}", shape=list(x.shape),
                             kernels=ms, ms=sum(ms.values())))
    return rows


def family(kernel: str) -> str:
    n = kernel.lower()
    for key, name in (("same_conv", "same_conv (ours)"), ("k1conv", "same_conv k1 (ours)"),
                      ("dwconv", "dwconv (ours)"),
                      ("conv_depthwise", "ATen depthwise"),
                      ("implicit_convolve_sgemm", "implicit_convolve_sgemm"),
                      ("nchwtonhwc", "transposes"), ("nhwctonchw", "transposes"),
                      ("xmma", "tensor-core fprop"), ("cutlass", "tensor-core fprop"),
                      ("dgrad", "dgrad"), ("elementwise", "elementwise")):
        if key in n:
            return name
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--codec", default="codec24k", choices=tuple(CODECS))
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("conv_layers: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = layer_rows(args.dtype, codec=args.codec)
    by_kind: dict[str, dict[str, float]] = defaultdict(lambda: defaultdict(float))
    count: dict[str, int] = defaultdict(int)
    for r in rows:
        count[r["kind"]] += 1
        for k, v in r["kernels"].items():
            by_kind[r["kind"]][family(k)] += v
    print(f"{torch.cuda.get_device_name(0)}, {args.codec} {args.dtype}: device ms per call of 16 clips "
          "by layer kind")
    total = defaultdict(float)
    for kind in sorted(by_kind, key=lambda k: -sum(by_kind[k].values())):
        fams = by_kind[kind]
        for f, v in fams.items():
            total[f] += v
        print(f"  {kind:36s} x{count[kind]:2d}  {sum(fams.values()):8.3f} ms  "
              + ", ".join(f"{f} {v:.3f}" for f, v in sorted(fams.items(), key=lambda kv: -kv[1])))
    print(f"  all layers: {sum(total.values()):.3f} ms: "
          + ", ".join(f"{f} {v:.3f}" for f, v in sorted(total.items(), key=lambda kv: -kv[1])))
    for name, mine in (("depthwise", [r for r in rows if "bound_ms" in r and not r.get("k1")]),
                       ("k = 1", [r for r in rows if r.get("k1")])):
        if not mine:
            continue
        print(f"  {name} layers, furthest from their bound first: {len(mine)} layers, "
              f"{sum(r['ms'] for r in mine):.3f} ms, bound {sum(r['bound_ms'] for r in mine):.3f} ms "
              f"({100 * sum(r['bound_ms'] for r in mine) / sum(r['ms'] for r in mine):.1f}%)")
        for r in sorted(mine, key=lambda r: r["bound_ms"] / r["ms"]):
            print(f"    {r['layer']:40s} {r['kind']:28s} {r['ms']:8.4f} ms  bound {r['bound_ms']:.4f} "
                  f"({100 * r['bound_ms'] / r['ms']:.1f}%)")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(device=torch.cuda.get_device_name(0), dtype=args.dtype, rows=rows), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
