"""The port's Mimi layout (``CodecConfig.mimi()``: a causal SEANet with ELU,
two sliding-window RoPE transformers, a learnt resampler and a split
Euclidean RVQ) against the plain reference ``tests/mimi_reference.py``,
stage by stage, at a small Mimi (four ratios of 2, 8 filters, hidden 32,
two layers of two heads of 16, a window of 8 frames, codebooks of 64 x 16,
four levels with one semantic); its causality, window and split; the
published preset's size; and the reference against ``transformers``'
``MimiModel`` on the same weights."""

import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import mimi_reference as ref_mimi
from nawc_tpu_torch.attacks.codec import codec_roundtrip, latent_roundtrip, layer_ablation
from nawc_tpu_torch.codec import mimi
from nawc_tpu_torch.codec.api import CodecState, make_codec
from nawc_tpu_torch.utils import profiling
from nawc_tpu_torch.utils.config import CodecConfig

# hop 16, chunk 32; 40 frames of the quantizer, 80 of the transformers (10 windows of 8)
SMALL = dict(encoder_dim=8, encoder_rates=(2, 2, 2, 2), decoder_rates=(2, 2, 2, 2), latent_dim=32,
             decoder_dim=128, tfm_layers=2, tfm_heads=2, tfm_ffn=64, tfm_context=8, codebook_size=64,
             codebook_dim=16, vq_strides=(1,) * 4, semantic_levels=1, n_q=4)
LENGTH = 1280


def small_cfg(**kw) -> CodecConfig:
    return CodecConfig.mimi(**{**SMALL, **kw})


def ref_cfg(cfg: CodecConfig) -> dict:
    return {"encoder_rates": cfg.encoder_rates, "decoder_rates": cfg.decoder_rates,
            "resample_stride": cfg.resample_stride, "tfm_layers": cfg.tfm_layers, "tfm_heads": cfg.tfm_heads,
            "tfm_context": cfg.tfm_context, "semantic_levels": cfg.semantic_levels, "n_q": cfg.num_levels}


def draw_weights(model: torch.nn.Module, seed: int) -> dict:
    """Every parameter drawn: weights at the LeCun scale, biases, LayerNorms
    and LayerScales off their init (so that each shows in the outputs),
    codebooks at the scale of the projected latent."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        mod = model.get_submodule(name.rpartition(".")[0])
        z = torch.randn(p.shape, generator=g)
        if isinstance(mod, torch.nn.LayerNorm):
            out[name] = 1.0 + 0.1 * z if name.endswith("weight") else 0.1 * z
        elif name.endswith(".scale"):
            out[name] = 0.3 + 0.1 * z
        elif name.endswith(".bias"):
            out[name] = 0.05 * z
        elif name.endswith("codebook"):
            out[name] = 0.5 * z
        else:
            out[name] = z / math.sqrt(mimi.fan_in(mod, p))
    return out


def port(cfg, seed=3):
    with torch.device("meta"):
        model = mimi.MimiCodec(cfg)
    w = draw_weights(model, seed)
    model = model.to_empty(device="cpu")
    model.load_state_dict(w)
    return CodecState(cfg=cfg, model=model.eval().requires_grad_(False)), w


@pytest.fixture(scope="module")
def small():
    return port(small_cfg())


def clips(n=2, length=LENGTH, seed=0):
    r = np.random.default_rng(seed)
    tt = np.arange(length) / 2000.0
    x = [0.3 * np.sin(2 * np.pi * r.uniform(50, 300) * tt) * np.sin(np.pi * tt * 3) ** 2
         + 0.02 * r.normal(size=length) for _ in range(n)]
    return torch.from_numpy(np.stack(x).astype(np.float32))


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


class Stages:
    """Forward hooks that keep the port's stage outputs of one call."""

    def __init__(self, model):
        self.out = {}
        mods = {"seanet": model.encoder.seanet, "enc_tfm": model.encoder.transformer,
                "latent": model.encoder, "dec_tfm": model.decoder.transformer, "decoded": model.decoder}
        self.handles = [m.register_forward_hook(lambda _m, a, o, _k=k: self.out.__setitem__(_k, (a[0], o)))
                        for k, m in mods.items()]
        self.handles.append(model.quantizer.register_forward_hook(
            lambda _m, a, o: self.out.__setitem__("codes", o[1])))

    def close(self):
        for h in self.handles:
            h.remove()


def stage_errors(codec, w, wav, prec="float32") -> dict:
    """The port's round trip of `wav`, and each stage's relative error
    against the reference's fed the port's previous stage; the codes'
    largest relative squared-distance gap."""
    ref = ref_mimi.Mimi(w, ref_cfg(codec.cfg), ref_mimi.PRECISIONS[prec])
    hooks = Stages(codec.model)
    with torch.no_grad():
        codec.roundtrip(wav)
        hooks.close()
        s = hooks.out
        x = s["seanet"][0]
        seanet = ref.seanet_encoder(x)
        enc_t = ref.transformer("encoder.transformer", s["seanet"][1])
        latent = ref.downsample(s["enc_tfm"][1])
        _, _, gaps = ref.quantize(s["latent"][1], forced=s["codes"])
        zq = ref.quantize(s["latent"][1], forced=s["codes"])[0]
        dec_t = ref.transformer("decoder.transformer", s["dec_tfm"][0])
        decoded = ref.seanet_decoder(s["dec_tfm"][1])
    return {"seanet": _rel(s["seanet"][1], seanet), "enc_tfm": _rel(s["enc_tfm"][1], enc_t),
            "latent": _rel(s["latent"][1], latent), "zq": _rel(s["decoded"][0], zq),
            "dec_tfm": _rel(s["dec_tfm"][1], dec_t), "decoded": _rel(s["decoded"][1], decoded),
            "code_gap": max(float(g.max()) for g in gaps), "out": s}


def test_float32_stage_by_stage(small):
    codec, w = small
    e = stage_errors(codec, w, clips())
    s = e["out"]
    assert s["seanet"][1].shape == (2, 32, 80) and s["latent"][1].shape == (2, 40, 32)
    assert [tuple(c.shape) for c in s["codes"]] == [(2, 40)] * 4 and s["decoded"][1].shape == (2, LENGTH)
    for k in ("seanet", "enc_tfm", "latent", "zq", "dec_tfm", "decoded"):
        assert e[k] < 1e-5, (k, e[k])
    assert e["code_gap"] == 0.0
    # the reference's own round trip picks the port's codes
    ref = ref_mimi.Mimi(w, ref_cfg(codec.cfg), ref_mimi.PRECISIONS["float32"])
    with torch.no_grad():
        own = ref.quantize(ref.encode_latent(clips())["latent"])[1]
    assert all(torch.equal(a.long(), b) for a, b in zip(s["codes"], own))


def test_bfloat16_stage_by_stage():
    codec, w = port(small_cfg(compute_dtype="bfloat16"))
    e = stage_errors(codec, w, clips(), prec="bfloat16")
    s = e["out"]
    assert s["seanet"][1].dtype == s["enc_tfm"][1].dtype == s["dec_tfm"][1].dtype == torch.bfloat16
    assert s["latent"][1].dtype == s["decoded"][1].dtype == torch.float32
    for k in ("seanet", "enc_tfm", "latent", "dec_tfm", "decoded"):
        assert e[k] < 1e-2, (k, e[k])
    assert e["zq"] < 1e-6 and e["code_gap"] < 1e-5
    # and far from float32's: the rounding points are bfloat16's
    assert _rel(s["seanet"][1].float(), ref_mimi.Mimi(w, ref_cfg(codec.cfg), ref_mimi.PRECISIONS["float32"])
                .seanet_encoder(s["seanet"][0].float())) > 1e-3


def test_encoder_is_causal(small):
    """Changing the samples from frame m's first on leaves every latent
    frame before m as it was, bit for bit."""
    codec, _ = small
    wav = clips()
    m = 17
    other = wav.clone()
    other[:, m * codec.cfg.chunk:] += torch.randn_like(other[:, m * codec.cfg.chunk:])
    with torch.no_grad():
        a, b = codec.encode_latent(wav), codec.encode_latent(other)
    assert torch.equal(a[:, :m], b[:, :m]) and not torch.allclose(a[:, m], b[:, m])


def test_attention_window_and_pair_count(small):
    """A frame more than the window before t leaves the attention output at t
    unchanged, a frame inside it does not; ``attn.pairs`` counts the pairs
    the dense attention scores, T x T a head and clip, in every layer of
    both transformers."""
    codec, _ = small
    attn = codec.model.encoder.transformer.layers[0].attn
    t, ctx = 80, attn.context
    x = torch.randn(2, t, 32)
    cos, sin = mimi.rotary_tables(torch.arange(t), 16)
    bias = torch.zeros(t, t).masked_fill(~mimi.window_mask(t, ctx, "cpu"), float("-inf"))
    y = x.clone()
    y[:, 30] += 1.0
    with torch.no_grad():
        a, b = attn(x, cos, sin, bias), attn(y, cos, sin, bias)
    changed = (a - b).abs().amax(dim=(0, 2)) > 0
    assert changed.nonzero().flatten().tolist() == list(range(30, 30 + ctx))
    profiling.enable()
    try:
        profiling.snapshot()
        with torch.no_grad():
            codec.roundtrip(clips())
        counters = profiling.snapshot()["counters"]
    finally:
        profiling.disable()
    frames = LENGTH // codec.cfg.hop
    assert counters["attn.pairs"] == 2 * 2 * codec.cfg.tfm_layers * 2 * frames * frames


def test_acoustic_levels_are_fed_the_latent_not_the_semantic_residual(small):
    codec, _ = small
    q = codec.model.quantizer
    with torch.no_grad():
        z = codec.encode_latent(clips())
        codes = q.encode(z)
        _, alone, _ = q.acoustic.quantize(z, 3)
        sem = q.from_codes(codes[:1] + [torch.zeros_like(c) for c in codes[1:]], torch.tensor([1.0, 0, 0, 0]))
        _, fed_residual, _ = q.acoustic.quantize(z - sem, 3)
    assert all(torch.equal(a, b) for a, b in zip(codes[1:], alone))
    assert not all(torch.equal(a, b) for a, b in zip(codes[1:], fed_residual))


def test_euclidean_lookup_is_the_least_distance_first_on_ties():
    from nawc_tpu_torch.ops.rvq import nearest_euclidean

    g = torch.Generator().manual_seed(0)
    cb = torch.randn(64, 16, generator=g)
    cb[9] = cb[4]  # a tie: the first index wins
    z = torch.cat([torch.randn(100, 16, generator=g), cb[4:5] + 1e-3])
    got = nearest_euclidean(z, cb)
    want = torch.cdist(z.double(), cb.double()).argmin(-1)
    assert got.dtype == torch.int32 and torch.equal(got.long(), want) and int(got[-1]) == 4


def test_published_preset_has_mimis_size_and_frame():
    cfg = CodecConfig.mimi()
    with torch.device("meta"):
        model = mimi.MimiCodec(cfg)
    assert sum(p.numel() for p in model.parameters()) == 96_085_825
    assert (cfg.chunk, cfg.hop, cfg.num_levels, len(cfg.vq_strides)) == (1920, 960, 8, 32)
    assert cfg.sample_rate / cfg.chunk == 12.5
    assert len(model.quantizer.acoustic.levels) == 31 and len(model.quantizer.semantic.levels) == 1
    with pytest.raises(ValueError):
        CodecConfig.mimi(decoder_dim=768)
    with pytest.raises(ValueError):
        CodecConfig(tfm_layers=2)


def test_codec_state_paths(small):
    """``codec_roundtrip``, ``latent_roundtrip`` and ``layer_ablation``
    (every level) run on Mimi; ``encode`` takes the module path; the
    codec-latent watermarks' hooks refuse it."""
    codec, _ = small
    wav = clips(length=1000)  # padded to 1024
    with torch.no_grad():
        a = codec_roundtrip(codec, wav)
        b = latent_roundtrip(codec, wav)
        full = layer_ablation(codec, wav, torch.ones(4))
        first = layer_ablation(codec, wav, torch.tensor([1.0, 0.0, 0.0, 0.0]))
        codes = codec.encode(F.pad(wav, (0, 24)))
    assert a.shape == b.shape == full.shape == wav.shape and torch.isfinite(a).all()
    assert torch.allclose(full, a, atol=1e-5) and not torch.equal(full, first)
    assert [tuple(c.shape) for c in codes] == [(2, 32)] * 4
    with pytest.raises(NotImplementedError):
        codec.projected_codebook
    with pytest.raises(NotImplementedError):
        codec.project_latent(torch.zeros(1, 32))


def test_make_codec_draws_mimi():
    codec = make_codec(small_cfg(), device="cpu", seed=5)
    again = make_codec(small_cfg(), device="cpu", seed=5)
    sd, sd2 = codec.model.state_dict(), again.model.state_dict()
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)
    assert float(sd["encoder.transformer.layers.0.attn.scale"][0]) == pytest.approx(0.01)
    assert codec.device == torch.device("cpu")


def test_robustness_cli_builds_mimi(monkeypatch, capsys):
    """``--codec_size mimi``: the robustness CLI builds the published Mimi
    (drawn weights; the default flax checkpoint is not read)."""
    from nawc_tpu_torch.cli import common, robustness

    built = []
    real = common.load_codec

    class Stop(Exception):
        pass

    def load(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    def stop(*a, **kw):
        raise Stop

    monkeypatch.setattr(common, "load_codec", load)
    monkeypatch.setattr(common, "load_audio_clips", stop)
    assert "mimi" in common.CODEC_SIZES
    with pytest.raises(Stop):
        robustness.main(["--codec_size", "mimi", "--device", "cpu"])
    assert built[0].cfg == CodecConfig.mimi() and isinstance(built[0].model, mimi.MimiCodec)
    assert "not read" in capsys.readouterr().out


def _to_transformers(cfg: CodecConfig, w: dict) -> tuple:
    """``transformers``' MimiModel at `cfg` (eager attention) holding the
    weights `w`, and its state dict."""
    from transformers import MimiConfig, MimiModel

    n = len(cfg.encoder_rates)
    hf_cfg = MimiConfig(sampling_rate=cfg.sample_rate, hidden_size=cfg.latent_dim,
                        num_filters=cfg.encoder_dim, upsampling_ratios=list(cfg.decoder_rates),
                        codebook_size=cfg.codebook_size, codebook_dim=cfg.codebook_dim,
                        vector_quantization_hidden_dimension=cfg.codebook_dim,
                        num_quantizers=len(cfg.vq_strides), num_semantic_quantizers=cfg.semantic_levels,
                        upsample_groups=cfg.latent_dim, num_hidden_layers=cfg.tfm_layers,
                        intermediate_size=cfg.tfm_ffn, num_attention_heads=cfg.tfm_heads,
                        num_key_value_heads=cfg.tfm_heads, sliding_window=cfg.tfm_context)
    hf_cfg._attn_implementation = "eager"
    hf = MimiModel(hf_cfg).eval()
    sd = {}

    def conv(hf_name, ours):
        sd[f"{hf_name}.conv.weight"] = w[f"{ours}.weight"]
        if f"{ours}.bias" in w:
            sd[f"{hf_name}.conv.bias"] = w[f"{ours}.bias"]

    def res(hf_name, ours):
        conv(f"{hf_name}.block.1", f"{ours}.Conv_0")
        conv(f"{hf_name}.block.3", f"{ours}.Conv_1")

    conv("encoder.layers.0", "encoder.seanet.Conv_0")
    for i in range(n):
        res(f"encoder.layers.{1 + 3 * i}", f"encoder.seanet.Block_{i}.Res")
        conv(f"encoder.layers.{3 + 3 * i}", f"encoder.seanet.Block_{i}.Conv_0")
        conv(f"decoder.layers.{2 + 3 * i}", f"decoder.seanet.Block_{i}.ConvTranspose_0")
        res(f"decoder.layers.{3 + 3 * i}", f"decoder.seanet.Block_{i}.Res")
    conv(f"encoder.layers.{3 * n + 2}", "encoder.seanet.Conv_1")
    conv("decoder.layers.0", "decoder.seanet.Conv_0")
    conv(f"decoder.layers.{3 * n + 2}", "decoder.seanet.Conv_1")
    conv("downsample", "encoder.downsample")
    conv("upsample", "decoder.upsample")
    for side in ("encoder", "decoder"):
        for j in range(cfg.tfm_layers):
            a, m = f"{side}.transformer.layers.{j}.attn", f"{side}.transformer.layers.{j}.mlp"
            h = f"{side}_transformer.layers.{j}"
            q, k, v = w[f"{a}.in_proj.weight"].chunk(3)
            sd.update({f"{h}.self_attn.q_proj.weight": q, f"{h}.self_attn.k_proj.weight": k,
                       f"{h}.self_attn.v_proj.weight": v, f"{h}.self_attn.o_proj.weight": w[f"{a}.out_proj.weight"],
                       f"{h}.input_layernorm.weight": w[f"{a}.norm.weight"],
                       f"{h}.input_layernorm.bias": w[f"{a}.norm.bias"],
                       f"{h}.post_attention_layernorm.weight": w[f"{m}.norm.weight"],
                       f"{h}.post_attention_layernorm.bias": w[f"{m}.norm.bias"],
                       f"{h}.self_attn_layer_scale.scale": w[f"{a}.scale"],
                       f"{h}.mlp_layer_scale.scale": w[f"{m}.scale"],
                       f"{h}.mlp.fc1.weight": w[f"{m}.fc1.weight"], f"{h}.mlp.fc2.weight": w[f"{m}.fc2.weight"]})
    for ours, theirs in (("semantic", "semantic_residual_vector_quantizer"),
                         ("acoustic", "acoustic_residual_vector_quantizer")):
        sd[f"quantizer.{theirs}.input_proj.weight"] = w[f"quantizer.{ours}.in_proj.weight"][..., None]
        sd[f"quantizer.{theirs}.output_proj.weight"] = w[f"quantizer.{ours}.out_proj.weight"][..., None]
        i = 0
        while f"quantizer.{ours}.levels.{i}.codebook" in w:
            cb = f"quantizer.{theirs}.layers.{i}.codebook"
            sd.update({f"{cb}.embed_sum": w[f"quantizer.{ours}.levels.{i}.codebook"],
                       f"{cb}.cluster_usage": torch.ones(cfg.codebook_size), f"{cb}.initialized": torch.ones(1)})
            i += 1
    missing, unexpected = hf.load_state_dict(sd, strict=False)
    assert not unexpected and not [k for k in missing if "rotary" not in k and "inv_freq" not in k], missing
    return hf, hf_cfg


def test_reference_is_transformers_mimi(small, monkeypatch):
    """The written equations against an independent implementation,
    ``transformers``' MimiModel on the same weights, stage by stage in
    float32: its causal mask replaced by the sliding window that moshi's
    streaming transformer applies (``transformers`` masks causally only)."""
    os.environ.setdefault("USE_TF", "0")  # transformers' TensorFlow side is not wanted
    pytest.importorskip("transformers")
    from transformers.models.mimi import modeling_mimi

    codec, w = small
    cfg = codec.cfg
    hf, hf_cfg = _to_transformers(cfg, w)

    def band(**kw):
        t = kw["input_embeds"].shape[1]
        delta = torch.arange(t)[:, None] - torch.arange(t)[None, :]
        ok = (delta >= 0) & (delta < cfg.tfm_context)
        return torch.zeros(t, t).masked_fill(~ok, float("-inf"))[None, None]

    monkeypatch.setattr(modeling_mimi, "create_causal_mask", band)
    ref = ref_mimi.Mimi(w, ref_cfg(cfg), ref_mimi.PRECISIONS["float32"])
    wav = clips()
    with torch.no_grad():
        mine = ref_mimi.lalm_attack(ref, wav)
        x = wav * (0.7 / wav.abs().amax(dim=-1, keepdim=True).clamp(min=1e-4))  # a whole frame count
        h = hf.encoder(x[:, None])
        t = hf.encoder_transformer(h.transpose(1, 2))[0].transpose(1, 2)
        latent = hf.downsample(t)
        codes = hf.quantizer.encode(latent, cfg.num_levels)
        zq = hf.quantizer.decode(codes.transpose(0, 1))
        u = hf.upsample(zq)
        td = hf.decoder_transformer(u.transpose(1, 2))[0].transpose(1, 2)
        y = hf.decoder(td)[:, 0]
    assert hf_cfg.frame_rate == cfg.sample_rate / cfg.chunk
    assert _rel(mine["seanet"], h) < 1e-5 and _rel(mine["enc_tfm"], t) < 1e-5
    assert _rel(mine["latent"], latent.transpose(1, 2)) < 1e-5
    assert all(torch.equal(a, b) for a, b in zip(mine["codes"], codes))
    assert _rel(mine["zq"], zq.transpose(1, 2)) < 1e-5
    assert _rel(mine["upsampled"], u) < 1e-5 and _rel(mine["dec_tfm"], td) < 1e-5
    assert _rel(mine["decoded"], y) < 1e-5
