"""The SNAC 44 kHz cell (``snac44k-roundtrip-bf16``) at a test size on the
CPU: its files resolve, its reference loads nothing of the program, its
counts match the codec's modules, a run reads its per-layer metrics and
loads nothing of JAX, and each planted fault and the control come out not
correct."""

import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from port_bench import counts_snac, faults_snac, harness
from port_bench import run as bench_run

CELL = "snac44k-roundtrip-bf16"
# the SNAC layout at a test size: a stride 3, attention windows of 4 and four levels kept
SMALL = {"encoder_dim": 8, "encoder_rates": [2, 3, 2, 2], "latent_dim": 128, "decoder_dim": 256,
         "decoder_rates": [2, 2, 3, 2], "codebook_size": 64, "attn_window": 4}
TRAFFIC = {"batch": 2, "seconds": 0.05, "pool_batches": 2}


def small_files():
    bench = harness.benchmark()
    files = harness.cell_files(bench, harness.cell(bench, CELL))
    cfg = harness.load_json(files["config"])
    cfg["codec"].update(SMALL)
    tr = harness.load_json(files["traffic"])
    tr.update(TRAFFIC)
    return bench, cfg, tr


def run_small(seed=2**31 + 21, trace=False, mode="bench"):
    bench, cfg, tr = small_files()
    return bench_run.execute(bench, CELL, seed, 0.2, trace, torch.device("cpu"),
                             time.perf_counter(), config=cfg, traffic=tr, mode=mode)


def test_cell_resolves_to_its_files():
    bench = harness.benchmark()
    w = harness.cell(bench, CELL)
    assert w["chips"] == 1 and w["config"] == "snac44k-bf16"
    files = harness.cell_files(bench, w)
    assert all(p.is_file() for p in files.values())
    cfg = harness.load_json(files["config"])
    assert cfg["reduced"] == [] and cfg["codec"]["layout"] == "snac"
    pub = cfg["published"]
    for ours, theirs in (("sample_rate", "sampling_rate"), ("attn_window", "attn_window_size"),
                         ("noise_blocks", "noise")):
        assert cfg["codec"][ours] == pub[theirs]
    for key in ("encoder_dim", "encoder_rates", "decoder_dim", "decoder_rates", "codebook_size",
                "codebook_dim", "vq_strides", "depthwise"):
        assert cfg["codec"][key] == pub[key]
    assert cfg["codec"]["latent_dim"] == pub["encoder_dim"] * 2 ** len(pub["encoder_rates"])
    new = ("attn_ms.pipeline", "noise_ms.pipeline", "dwconv_ms.pipeline", "dwconv_roofline.pipeline")
    assert {m["name"] for m in harness.metrics_for(bench, CELL, "per_layer")} >= set(new)


def test_reference_loads_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("nawc_tpu_torch",) + {harness.FORBIDDEN!r}:
                    raise ImportError(f"refused: {{name}}")
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(harness.ROOT)!r})
        from port_bench.reference import snac
        from port_bench import counts_snac
        print("ok", snac.chunk({{"encoder_rates": [2, 3, 8, 8], "vq_strides": [8, 4, 2, 1],
                                 "attn_window": 32}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", "12288"]


def test_reference_normal_is_the_programs_draw():
    import numpy as np

    from nawc_tpu_torch.utils import jaxrand
    from port_bench.reference import snac

    key = jaxrand.split(jaxrand.prng_key(2**31 + 3))[1]
    got = snac.normal(key, (4, 1, 50000)).numpy()
    want = jaxrand.normal(key, (4, 1, 50000))
    assert np.abs(got - want).max() < 2e-6 and np.abs(want).max() > 4.0


def test_counts_match_the_codec_modules():
    """Every conv, depthwise conv, Snake and attention of the program's SNAC
    codec in order, at a short input: shapes from forward hooks."""
    from nawc_tpu_torch.codec.layers import LocalMHA, SameConv1d, SameConvTranspose1d, Snake
    from nawc_tpu_torch.codec.model import SnacCodec
    from port_bench.weights import codec_config

    _, cfg, _ = small_files()
    model = SnacCodec(codec_config(dict(cfg["codec"], compute_dtype="float32"))).eval()
    seen = []

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, Snake):
            seen.append(("snake", x.shape[1], x.shape[2]))
        elif isinstance(mod, LocalMHA):
            seen.append(("attn", x.shape[1], x.shape[2], mod.window))
        elif isinstance(mod, SameConvTranspose1d):
            seen.append(("tconv", mod.in_channels, mod.out_channels, mod.kernel_size[0],
                         out.shape[-1], mod.stride[0]))
        elif mod.groups > 1:
            seen.append(("dwconv", mod.in_channels, mod.kernel_size[0], out.shape[-1]))
        else:
            seen.append(("conv", mod.in_channels, mod.out_channels, mod.kernel_size[0],
                         out.shape[-1]))

    for m in model.modules():
        if isinstance(m, (SameConv1d, SameConvTranspose1d, Snake, LocalMHA)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.roundtrip(torch.zeros(2, 768))
    enc, dec = counts_snac.codec_layers(cfg["codec"], 2, 768)
    # hooks fire as modules end: a LocalMHA after nothing inside it, a conv after its input
    assert sorted(e[1:] for e in enc + dec) == sorted(seen)
    assert [e[1:] for e in enc + dec if e[1] != "attn"] == [s for s in seen if s[0] != "attn"]


def test_counts_at_the_cell_size():
    bench = harness.benchmark()
    cfg = harness.load_json(harness.cell_files(bench, harness.cell(bench, CELL))["config"])
    enc, dec = counts_snac.codec_layers(cfg["codec"], 16, 184320)
    layers = enc + dec
    assert counts_snac.conv_flops(layers) / 1e12 == pytest.approx(4.3150, abs=1e-4)
    assert counts_snac.attention_flops(layers) / 1e12 == pytest.approx(0.2119, abs=1e-4)
    assert sum(1 for e in layers if e[1] == "dwconv") == 26
    assert sum(1 for e in layers if e[1] == "snake") == 57
    # a 96-channel bfloat16 activation at 44.1 kHz: 0.566 GB, read and written by each of the
    # last block's three depthwise convs
    assert counts_snac.dwconv_bytes(layers, "bfloat16") / 1e9 == pytest.approx(16.106, abs=1e-3)


def test_traced_run_reads_the_new_metrics_and_no_device_metric():
    line = run_small(trace=True)
    names = set(line["metrics"])
    assert {"attn_ms.pipeline", "noise_ms.pipeline", "dwconv_ms.pipeline",
            "encode_ms.pipeline", "decode_ms.pipeline", "h2d_bytes.pipeline"} <= names
    assert not {k for k in names if "roofline" in k or "mfu" in k or "idle" in k}


def test_dry_run_loads_no_jax():
    code = textwrap.dedent(f"""
        import importlib.abc, json, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {harness.FORBIDDEN!r}:
                    raise ImportError(f"refused: {{name}}")
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(harness.ROOT)!r})
        sys.path.insert(0, {str(harness.BENCH / "tests")!r})
        import test_bench_snac
        test_bench_snac.run_small(seed=5, trace=True)
        from port_bench import harness
        print(json.dumps(harness.forbidden_modules()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("fault", sorted(faults_snac.FAULTS) + ["altered_code", "flip_strongest_bit"])
def test_fault_is_not_correct(fault):
    with faults_snac.planted(fault):
        line = run_small()
    assert not line["correct"], (fault, line["checks"])


def test_control_is_not_correct():
    line = run_small(mode="control")
    assert not line["correct"], line["checks"]
