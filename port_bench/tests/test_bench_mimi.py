"""The Mimi cell (``mimi-roundtrip-bf16``) at a test size on the CPU: its
files resolve, its reference loads nothing of the program, its counts match
the codec's modules, a run reads its per-layer metrics and loads nothing of
JAX, and each planted fault and the control come out not correct."""

import json
import subprocess
import sys
import textwrap
import time

import pytest
import torch

from port_bench import counts_mimi, faults_mimi, harness
from port_bench import run as bench_run

CELL = "mimi-roundtrip-bf16"
# the Mimi layout at a test size: four ratios of 2, two layers of two heads, a window of 8 frames
# that binds (150 frames a clip), four levels with one semantic
SMALL = {"encoder_dim": 8, "encoder_rates": [2, 2, 2, 2], "decoder_rates": [2, 2, 2, 2], "latent_dim": 32,
         "decoder_dim": 128, "tfm_layers": 2, "tfm_heads": 2, "tfm_ffn": 64, "tfm_context": 8,
         "codebook_size": 64, "codebook_dim": 16, "vq_strides": [1, 1, 1, 1], "semantic_levels": 1, "n_q": 4}
TRAFFIC = {"batch": 2, "seconds": 0.1, "pool_batches": 2}


def small_files():
    bench = harness.benchmark()
    files = harness.cell_files(bench, harness.cell(bench, CELL))
    cfg = harness.load_json(files["config"])
    cfg["codec"].update(SMALL)
    tr = harness.load_json(files["traffic"])
    tr.update(TRAFFIC)
    return bench, cfg, tr


def run_small(seed=2**31 + 26, trace=False, mode="bench"):
    bench, cfg, tr = small_files()
    return bench_run.execute(bench, CELL, seed, 0.2, trace, torch.device("cpu"),
                             time.perf_counter(), config=cfg, traffic=tr, mode=mode)


def test_cell_resolves_to_its_files():
    bench = harness.benchmark()
    w = harness.cell(bench, CELL)
    assert w["chips"] == 1 and w["config"] == "mimi-bf16"
    files = harness.cell_files(bench, w)
    assert all(p.is_file() for p in files.values())
    cfg = harness.load_json(files["config"])
    assert cfg["reduced"] == [] and cfg["codec"]["layout"] == "mimi" and cfg["n_q"] == cfg["codec"]["n_q"] == 8
    pub, c = cfg["published"], cfg["codec"]
    for ours, theirs in (("sample_rate", "sampling_rate"), ("encoder_dim", "num_filters"),
                         ("latent_dim", "hidden_size"), ("codebook_size", "codebook_size"),
                         ("codebook_dim", "codebook_dim"), ("tfm_layers", "num_hidden_layers"),
                         ("tfm_heads", "num_attention_heads"), ("tfm_ffn", "intermediate_size"),
                         ("tfm_context", "sliding_window"), ("semantic_levels", "num_semantic_quantizers")):
        assert c[ours] == pub[theirs], ours
    assert c["decoder_rates"] == pub["upsampling_ratios"] == c["encoder_rates"][::-1]
    assert c["decoder_dim"] == pub["num_filters"] * 2 ** len(pub["upsampling_ratios"])
    assert len(c["vq_strides"]) == pub["num_quantizers"] and c["latent_dim"] // c["tfm_heads"] == pub["head_dim"]
    assert pub["sampling_rate"] / (c["resample_stride"] * 4 * 5 * 6 * 8) == pub["frame_rate"]
    new = ("tfm_ms.pipeline", "tfm_roofline.pipeline", "attn_ms.pipeline", "k1conv_launches.pipeline",
           "same_conv_launches.pipeline", "mfu.pipeline")
    assert {m["name"] for m in harness.metrics_for(bench, CELL, "per_layer")} >= set(new)
    assert not {m["name"] for m in harness.metrics_for(bench, CELL, "per_layer")
                if m["name"].startswith(("snake_", "dwconv_", "noise_"))}


def test_reference_loads_nothing_of_the_program():
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("nawc_tpu_torch",) + {harness.FORBIDDEN!r}:
                    raise ImportError(f"refused: {{name}}")
        sys.meta_path.insert(0, Refuse())
        sys.path.insert(0, {str(harness.ROOT)!r})
        from port_bench.reference import mimi
        from port_bench import counts_mimi
        print("ok", mimi.chunk({{"encoder_rates": [4, 5, 6, 8], "resample_stride": 2}}))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["ok", "1920"]


def test_counts_match_the_codec_modules():
    """Every conv and transposed conv of the program's Mimi codec in order,
    and the transformers' pairs, at a short input: shapes from forward
    hooks."""
    from nawc_tpu_torch.codec.mimi import (CausalConv1d, CausalConvTranspose1d, MimiCodec, SelfAttention,
                                           window_mask)
    from port_bench.weights import codec_config

    _, cfg, _ = small_files()
    c = dict(cfg["codec"], compute_dtype="float32")
    model = MimiCodec(codec_config(c)).eval()
    seen, pairs = [], []

    def hook(mod, args, out):
        if isinstance(mod, CausalConvTranspose1d):
            seen.append(("tconv", mod.in_channels, mod.out_channels, mod.kernel_size[0], out.shape[-1],
                         mod.stride[0], mod.groups))
        elif isinstance(mod, SelfAttention):
            pairs.append(int(window_mask(args[0].shape[1], mod.context, "cpu").sum()) * args[0].shape[0] * mod.heads)
        else:
            seen.append(("conv", mod.in_channels, mod.out_channels, mod.kernel_size[0], out.shape[-1]))

    for m in model.modules():
        if isinstance(m, (CausalConv1d, CausalConvTranspose1d, SelfAttention)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.roundtrip(torch.zeros(2, 2400))
    enc, dec = counts_mimi.codec_layers(c, 2, 2400)
    assert [e[1:] for e in enc + dec] == seen
    t = counts_mimi.frames(c, 2400)
    assert t == 150 and sum(pairs) == 2 * 2 * c["tfm_layers"] * 2 * counts_mimi.window_pairs(t, 8)


def test_counts_at_the_cell_size():
    bench = harness.benchmark()
    cfg = harness.load_json(harness.cell_files(bench, harness.cell(bench, CELL))["config"])
    c = cfg["codec"]
    enc, dec = counts_mimi.codec_layers(c, 16, 720_000)
    assert sum(1 for e in enc + dec if e[1] == "conv" and e[4] in (3, 7) and e[2] % 16 == e[3] % 16 == 0) == 10
    assert sum(1 for e in enc + dec if e[1] == "conv" and e[4] == 1) == 8
    assert counts_mimi.conv_flops(enc) / 1e12 == pytest.approx(1.9481, abs=1e-4)
    assert counts_mimi.conv_flops(dec) / 1e12 == pytest.approx(1.9800, abs=1e-4)
    flops, nbytes = counts_mimi.transformer_counts(c, 16, 720_000)
    assert counts_mimi.frames(c, 720_000) == 750 and counts_mimi.window_pairs(750, 250) == 156_375
    assert flops / 1e12 == pytest.approx(1.2899, abs=1e-4) and nbytes / 1e9 == pytest.approx(4.0328, abs=1e-4)
    assert counts_mimi.rvq_flops(c, 16, 720_000) / 1e12 == pytest.approx(0.0566, abs=1e-4)


def test_traced_run_reads_the_new_metrics_and_no_device_metric():
    line = run_small(trace=True)
    names = set(line["metrics"])
    assert {"tfm_ms.pipeline", "attn_ms.pipeline", "encode_ms.pipeline", "quantize_ms.pipeline",
            "decode_ms.pipeline", "k1conv_ms.pipeline", "h2d_bytes.pipeline"} <= names
    assert not {k for k in names if "roofline" in k or "mfu" in k or "idle" in k}
    assert line["correct"], line["checks"]


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
        import test_bench_mimi
        test_bench_mimi.run_small(seed=5, trace=True)
        from port_bench import harness
        print(json.dumps(harness.forbidden_modules()))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("fault", sorted(faults_mimi.FAULTS) + ["flip_strongest_bit"])
def test_fault_is_not_correct(fault):
    with faults_mimi.planted(fault):
        line = run_small()
    assert not line["correct"], (fault, line["checks"])


def test_control_is_not_correct():
    line = run_small(mode="control")
    assert not line["correct"], line["checks"]
