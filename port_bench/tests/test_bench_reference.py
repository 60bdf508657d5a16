"""The plain reference against the port, whose ops run their plain
versions on the CPU, at a small size: stage by stage for each traffic
mix's entry, then each cell's whole run."""

import numpy as np
import pytest
import torch

from port_bench import harness, inputs
from port_bench.reference import codec as ref_codec
from port_bench.reference import precision
from port_bench.reference import semantic as ref_sem
from port_bench.reference import spread_spectrum as ref_ss
from port_bench.weights import make_codec

from conftest import TINY

CFG = harness.load_json(harness.BENCH / "configs" / "codec24k-f32.json")
WM = CFG["watermark"]
F32 = precision.get("float32")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def tiny_codec():
    block = dict(CFG["codec"], **TINY)
    codec, weights = make_codec(block, 2**31 + 11, torch.device("cpu"))
    return codec, weights, block


@pytest.fixture(scope="module")
def clips():
    r = inputs.rng(2**31 + 5, "test")
    return torch.from_numpy(inputs.speech_clips(r, 2, 12000, 24000))


def test_codec_round_trip(tiny_codec, clips):
    codec, weights, block = tiny_codec
    ref = ref_codec.Codec(weights, block, F32)
    x = ref_codec.pad_to(clips, ref_codec.chunk(block))
    with torch.no_grad():
        z = codec.encode_latent(x)
        zq, codes, _, _ = codec.model.quantizer(z)
        y = codec.model.decoder(zq)
        zr = ref.encode_latent(x)
        zqr, cr, gaps = ref.quantize(zr)
        yr = ref.decode_latent(ref.quantize(zr, forced=codes)[0])
    torch.testing.assert_close(zr, z, rtol=1e-5, atol=1e-4)
    assert all(torch.equal(a.long(), b) for a, b in zip(codes, cr))
    assert max(float(g.max()) for g in gaps) == 0.0
    # the program's quantized latent is z_e + (z_q - z_e), which rounds in float32
    assert _rel(y, yr) < 1e-4


def test_codec_bfloat16_within_its_rounding(tiny_codec, clips):
    codec, weights, block = tiny_codec
    block = dict(block, compute_dtype="bfloat16")
    prog, _ = make_codec(block, 2**31 + 11, torch.device("cpu"))
    x = ref_codec.pad_to(clips, ref_codec.chunk(block))
    with torch.no_grad():
        z = prog.encode_latent(x)
        zr = ref_codec.Codec(weights, block, precision.get("bfloat16")).encode_latent(x)
    assert float((z - zr).norm() / zr.norm()) < 2e-2


def test_watermark_embed_and_detect(clips):
    from nawc_tpu_torch.models.spread_spectrum import SpreadSpectrumWM, _pn_patterns_np
    from nawc_tpu_torch.utils.config import SpreadSpectrumConfig

    wm = SpreadSpectrumWM(cfg=SpreadSpectrumConfig(sample_rate=24000, band_hi_hz=9000.0, alpha=0.1))
    msg = torch.from_numpy(inputs.messages(inputs.rng(1, "m"), 2, 16))
    np.testing.assert_array_equal(
        ref_ss.patterns(WM, 64, "cpu").numpy(), _pn_patterns_np(0, wm.cfg))
    marked = wm.embed(clips, msg)
    torch.testing.assert_close(ref_ss.embed(WM, F32, clips, msg), marked, rtol=0, atol=1e-5)
    presence, bits = wm.detect(marked)
    rp, rb, z = ref_ss.detect(WM, F32, marked)
    torch.testing.assert_close(rp, presence, rtol=0, atol=1e-5)
    assert torch.equal(rb, bits)


def test_semantic_step(tiny_codec, clips):
    from nawc_tpu_torch.models import semantic

    codec, weights, block = tiny_codec
    wm = semantic.SemanticWM(codec, "pca")
    emb = ref_sem.Embed(ref_codec.Codec(weights, block, F32), CFG["semantic"], clips)
    torch.testing.assert_close(emb.axis, wm.axis)
    s = semantic._pn(emb.x.shape[-1] // 512, wm.scfg.pn_seed, "cpu")
    torch.testing.assert_close(emb.pn, s)
    delta = (torch.randn(emb.x.shape, generator=torch.Generator().manual_seed(3)) * 1e-3)
    d = delta.clone().requires_grad_(True)
    semantic._loss(codec, wm.scfg, wm.axis, s, emb.x, emb.mask, d).backward()
    assert _rel(d.grad * emb.mask, emb.grad(delta)) < 1e-4
    # Adam, the budget and the projection from a given state
    g = d.grad * emb.mask
    p = delta.clone().requires_grad_(True)
    opt = torch.optim.Adam([p], lr=wm.scfg.lr)
    p.grad = g.clone()
    opt.step()
    nxt, _, _ = emb.adam(delta, g, torch.zeros_like(g), torch.zeros_like(g), 0, wm.scfg.lr)
    torch.testing.assert_close(nxt, p.detach(), rtol=1e-6, atol=1e-9)
    proj = semantic._spectral_projection(nxt, emb.mask, emb.x_mag, wm.scfg, 24000)
    torch.testing.assert_close(emb.projection(nxt), proj, rtol=1e-4, atol=1e-7)


# roundtrip-bf16 is held to limits read on the card, where cuDNN computes its bfloat16
# convolutions; on the CPU the port emulates them (a float32 conv of bfloat16 values,
# rounded, then the bias), so its test-size run is not the cell's (see
# test_codec_bfloat16_within_its_rounding for its reference)
@pytest.mark.parametrize("workload", ["roundtrip-f32", "latent-embed-f32"])
def test_cell_runs_correct_at_test_size(small, workload):
    line = small(workload)
    assert line["correct"], line["checks"]


def test_latent_window_crosses_calls(small, monkeypatch):
    """A window longer than one embed call goes on into the next calls: the
    line counts more steps than the first call holds after the window
    opened, and stays correct.  The program and the configuration both run
    20 steps a call here."""
    import dataclasses

    from nawc_tpu_torch.models import semantic

    short = dataclasses.replace(semantic._DEFAULT_CFGS["pca"], steps=20)
    monkeypatch.setitem(semantic._DEFAULT_CFGS, "pca", short)
    line = small("latent-embed-f32", steps=20, seconds=2.0)
    assert line["attempted"] > 20 - 2, line["attempted"]
    assert line["correct"], line["checks"]
