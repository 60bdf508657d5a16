"""The port's SNAC layout (``CodecConfig(layout="snac")``: depthwise-separable
residual units, noise blocks, windowed rotary attention, SNAC's padding and
a four-level RVQ) against the plain reference ``tests/snac_reference.py``,
stage by stage, on seeded random weights at a small geometry that keeps a
stride 3, several attention windows and four levels; and the 24 kHz codec's
modules and outputs, which the new keys leave as they were."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import snac_reference as ref_snac
from _torch_port import t, tiny_codecs
from nawc_tpu.codec.model import SnacCodec as JaxSnacCodec
from nawc_tpu.utils.config import CodecConfig as JaxCodecConfig
from nawc_tpu_torch.attacks.codec import codec_roundtrip, layer_ablation
from nawc_tpu_torch.codec import layers
from nawc_tpu_torch.codec.api import CodecState, flax_init_tree
from nawc_tpu_torch.codec.layers import LocalMHA, NoiseBlock, SameConv1d, SameConvTranspose1d
from nawc_tpu_torch.codec.model import SnacCodec
from nawc_tpu_torch.ops import rvq_fused
from nawc_tpu_torch.utils import jaxrand
from nawc_tpu_torch.utils.config import CodecConfig

# hop 24, chunk 24 * lcm(8, 4) = 192; latent 128 (2 heads), decoder 256 (4 heads)
SMALL = dict(encoder_dim=8, encoder_rates=(2, 3, 2, 2), latent_dim=128, decoder_dim=256,
             decoder_rates=(2, 2, 3, 2), codebook_size=64, codebook_dim=8, vq_strides=(8, 4, 2, 1),
             attn_window=4)
LENGTH = 700  # padded to 768: 32 frames, 8 windows, codes of 4, 8, 16, 32 a clip


def small_cfg(**kw) -> CodecConfig:
    return CodecConfig.snac_44khz(**{**SMALL, **kw})


def ref_cfg(cfg: CodecConfig) -> dict:
    return {"encoder_rates": cfg.encoder_rates, "decoder_rates": cfg.decoder_rates,
            "vq_strides": cfg.vq_strides, "attn_window": cfg.attn_window,
            "depthwise": cfg.depthwise}


def draw_weights(model: torch.nn.Module, seed: int) -> dict:
    """Every parameter drawn, biases, LayerNorms and Snake alphas too, at
    0.8 of the LeCun scale (fan-in of a transposed conv: its taps an
    output)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, p in model.state_dict().items():
        mod = model.get_submodule(name.rpartition(".")[0])
        z = torch.randn(p.shape, generator=g)
        if isinstance(mod, torch.nn.LayerNorm):
            out[name] = 1.0 + 0.1 * z if name.endswith("weight") else 0.1 * z
        elif name.endswith(("bias", "log_alpha")):
            out[name] = 0.05 * z
        elif name.endswith("codebook"):
            out[name] = z
        else:
            if isinstance(mod, torch.nn.ConvTranspose1d):
                fan_in = p.shape[0] * p.shape[2] // mod.stride[0]
            else:
                fan_in = p[0].numel()
            out[name] = z * 0.8 / math.sqrt(fan_in)
    out["decoder.Conv_1.weight"] *= 0.05  # keeps the output off tanh's rails
    return out


def clips(n=2, length=LENGTH, seed=0):
    r = np.random.default_rng(seed)
    tt = np.arange(length) / 2000.0
    x = [0.3 * np.sin(2 * np.pi * r.uniform(50, 300) * tt) * np.sin(np.pi * tt * 3) ** 2
         + 0.01 * r.normal(size=length) for _ in range(n)]
    return torch.from_numpy(np.stack(x).astype(np.float32))


class Draws:
    """Forward hooks on the noise blocks' draws: each (key, normals)."""

    def __init__(self, model):
        self.seen = []
        self.handles = [m.register_forward_hook(self.hook) for m in model.modules()
                        if isinstance(m, layers.NoiseDraw)]

    def hook(self, mod, args, out):
        self.seen.append((args[0].copy(), out))

    def close(self):
        for h in self.handles:
            h.remove()


def port(cfg, seed=3):
    model = SnacCodec(cfg).eval().requires_grad_(False)
    w = draw_weights(model, seed)
    model.load_state_dict(w)
    model.seed_noise(seed)
    return CodecState(cfg=cfg, model=model), w


@pytest.fixture(scope="module")
def small():
    return port(small_cfg())


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def stages(codec, w, wav, noise=None):
    """The port's latent, codes, noise and decoded audio for `wav` (padded
    to the chunk), and the reference's stages fed the port's previous ones
    (its noise too, or `noise` where given)."""
    cfg = codec.cfg
    x = F.pad(wav, (0, -wav.shape[-1] % ref_snac.chunk(ref_cfg(cfg))))
    ref = ref_snac.Snac(w, ref_cfg(cfg))
    draws = Draws(codec.model)
    with torch.no_grad():
        z = codec.encode_latent(x)
        zq, codes, _, _ = codec.model.quantizer(z)
        y = codec.model.decoder(zq)
        draws.close()
        noise = [n for _, n in draws.seen] if noise is None else noise
        zr = ref.encode_latent(x)
        zqr, cr = ref.quantize(z)
        yr = ref.decode_latent(ref.quantize(z, forced=codes)[0], noise)
    return {"x": x, "z": z, "zr": zr, "codes": codes, "codes_ref": cr, "zq": zq, "zq_ref": zqr,
            "y": y, "y_ref": yr, "draws": draws.seen}


def test_float32_stage_by_stage(small):
    codec, w = small
    s = stages(codec, w, clips())
    assert s["z"].shape == (2, 32, 128)
    assert [tuple(c.shape) for c in s["codes"]] == [(2, 4), (2, 8), (2, 16), (2, 32)]
    assert _rel(s["z"], s["zr"]) < 1e-5
    assert all(torch.equal(a.long(), b) for a, b in zip(s["codes"], s["codes_ref"]))
    assert _rel(s["zq"], s["zq_ref"]) < 1e-5
    assert s["y"].shape == s["x"].shape and _rel(s["y"], s["y_ref"]) < 1e-4
    assert 1e-2 < float(s["y"].std()) and float(s["y"].abs().max()) < 0.99  # audio, not silence or rails


def test_layout_without_attention_matches_reference():
    """snac_24khz's shape of layout: no attention, three levels."""
    cfg = small_cfg(encoder_rates=(2, 4, 2, 2), decoder_rates=(2, 2, 4, 2), vq_strides=(4, 2, 1),
                    attn_window=0)
    codec, w = port(cfg)
    assert cfg.chunk == 32 * 4 and not hasattr(codec.model.encoder, "LocalMHA_0")
    s = stages(codec, w, clips())
    assert _rel(s["z"], s["zr"]) < 1e-5 and _rel(s["y"], s["y_ref"]) < 1e-4
    assert all(torch.equal(a.long(), b) for a, b in zip(s["codes"], s["codes_ref"]))


def test_noise_is_keyed_and_drawn_anew(small):
    codec, w = small
    codec.model.seed_noise(3)
    first = stages(codec, w, clips())["draws"]
    again = stages(codec, w, clips())["draws"]
    assert [tuple(n.shape) for _, n in first] == [(2, 1, 64), (2, 1, 128), (2, 1, 384),
                                                  (2, 1, 768)]
    keys = [tuple(k) for k, _ in first + again]
    assert len(set(keys)) == 8  # every block, every call: a key of its own
    for key, n in first + again:
        np.testing.assert_array_equal(n.numpy(), jaxrand.normal(key, tuple(n.shape)))
    codec.model.seed_noise(3)
    replay = stages(codec, w, clips())["draws"]
    assert [tuple(k) for k, _ in replay] == keys[:4]


def test_roundtrip_attack_matches_reference(small):
    codec, w = small
    wav = clips(seed=1)
    draws = Draws(codec.model)
    with torch.no_grad():
        out = codec_roundtrip(codec, wav)
    draws.close()
    ref = ref_snac.Snac(w, ref_cfg(codec.cfg))
    g = 0.7 / wav.abs().amax(dim=-1, keepdim=True).clamp(min=1e-4)
    x = F.pad(wav * g, (0, -wav.shape[-1] % ref_snac.chunk(ref_cfg(codec.cfg))))
    zq, _ = ref.quantize(ref.encode_latent(x))
    want = ref.decode_latent(zq, [n for _, n in draws.seen])[:, : wav.shape[-1]] / g
    assert out.shape == wav.shape and _rel(out, want) < 1e-4


def test_bfloat16_within_its_rounding(small):
    _, w = small
    codec, _ = port(small_cfg(compute_dtype="bfloat16"))
    codec.model.load_state_dict(w)
    s = stages(codec, w, clips())
    assert s["z"].dtype == torch.float32
    assert _rel(s["z"], s["zr"]) < 0.05
    assert _rel(s["y"], s["y_ref"]) < 0.15


def block_diagonal_attention(m: LocalMHA, x: torch.Tensor) -> torch.Tensor:
    """LocalMHA another way: full attention over the whole sequence with a
    block-diagonal mask, rotary positions t mod window."""
    b, c, t = x.shape
    h, dh = m.heads, m.dim_head
    y = F.layer_norm(x.transpose(1, 2), (c,), m.norm.weight, m.norm.bias, m.norm.eps)
    q, k, v = (u.reshape(b, t, h, dh).transpose(1, 2) for u in (y @ m.to_qkv.weight.T).chunk(3, -1))
    pos = torch.arange(t) % m.window
    ang = pos[:, None].double() * 10000.0 ** (-torch.arange(0, dh, 2).double() / dh)
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()

    def rot(u):
        u1, u2 = u[..., : dh // 2], u[..., dh // 2:]
        return torch.cat((u1 * cos - u2 * sin, u2 * cos + u1 * sin), dim=-1)

    win = torch.arange(t) // m.window
    mask = win[:, None] == win[None, :]
    scores = (rot(q) @ rot(k).transpose(-1, -2)) / 8.0
    att = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
    o = (att @ v).transpose(1, 2).reshape(b, t, c)
    return x + (o @ m.to_out.weight.T).transpose(1, 2)


def test_local_attention_is_block_diagonal(small):
    m = small[0].model.encoder.LocalMHA_0
    x = torch.randn(2, 128, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        torch.testing.assert_close(m(x), block_diagonal_attention(m, x), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="windows"):
        m(x[..., :30])


@pytest.mark.parametrize("s", [2, 3, 8])
def test_strided_alignment_is_snacs(s):
    g = torch.Generator().manual_seed(s)
    x = torch.randn(2, 16, 24 * s, generator=g)
    conv = SameConv1d(16, 32, 2 * s, stride=s, snac=True)
    want = F.conv1d(x, conv.weight, conv.bias, s, math.ceil(s / 2))
    with torch.no_grad():
        torch.testing.assert_close(conv(x), want)
        conv.snac = False  # flax's SAME agrees at even strides only
        assert torch.allclose(conv(x), want, atol=1e-5) == (s % 2 == 0)
    xt = torch.randn(2, 32, 24, generator=g)
    tconv = SameConvTranspose1d(32, 16, s, snac=True)
    flax_rule = SameConvTranspose1d(32, 16, s)
    flax_rule.load_state_dict(tconv.state_dict())
    want = F.conv_transpose1d(xt, tconv.weight, tconv.bias, s, math.ceil(s / 2), s % 2)
    with torch.no_grad():
        got = tconv(xt)
        torch.testing.assert_close(got, want)
        assert got.shape[-1] == 24 * s
        # SNAC keeps samples [2, 3T + 2) of the full output at stride 3, flax [1, 3T + 1)
        full = F.conv_transpose1d(xt, tconv.weight, tconv.bias, s)
        p = math.ceil(s / 2)
        torch.testing.assert_close(got, full[..., p: p + 24 * s])
        assert torch.allclose(flax_rule(xt), got, atol=1e-5) == (s % 2 == 0)


def test_chunk_rule_for_both_layouts():
    assert CodecConfig().chunk == 4096  # max(4096, 512 * 4)
    assert CodecConfig(encoder_rates=(4, 4, 8, 8), vq_strides=(8, 2, 1)).chunk == 8192
    assert CodecConfig.snac_44khz().chunk == 384 * 32 == 12288
    assert CodecConfig.snac_44khz(attn_window=0).chunk == 384 * 8
    assert small_cfg().chunk == 24 * 8
    with pytest.raises(ValueError, match="latent_dim"):
        CodecConfig.snac_44khz(latent_dim=768)
    with pytest.raises(ValueError, match="snac"):
        CodecConfig(attn_window=32)


def test_snac_44khz_preset_has_the_published_size():
    cfg = CodecConfig.snac_44khz()
    assert (cfg.sample_rate, cfg.hop, cfg.latent_dim, cfg.decoder_dim) == (44100, 384, 1024, 1536)
    with torch.device("meta"):
        model = SnacCodec(cfg)
    assert sum(p.numel() for p in model.parameters()) == 54_517_921  # 54.5 M published
    assert model.encoder.LocalMHA_0.heads == 16 and model.decoder.LocalMHA_0.heads == 24
    assert model.decoder.DecoderBlock_3.ResidualUnit_2.Conv_0.groups == 96


def test_codec24k_modules_and_outputs_unchanged():
    """The 24 kHz codec builds the JAX package's modules (the flax tree's
    paths and shapes, none of SNAC's) and computes JAX's outputs."""
    cfg = CodecConfig()
    with torch.device("meta"):
        model = SnacCodec(cfg)
    shapes = jax.eval_shape(JaxSnacCodec(JaxCodecConfig()).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4096), jnp.float32))
    jax_paths = {"/".join(k.key for k in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(shapes["params"])[0]}
    port_paths = {"/".join(path) for path, _ in _leaves(flax_init_tree(SnacCodec(cfg), 0)["params"])}
    assert port_paths == jax_paths
    assert not any(s in k for k in model.state_dict()
                   for s in ("LocalMHA", "NoiseBlock", "DWConv", "norm"))
    assert model.decoder.noise is None
    jc, tc = tiny_codecs()
    wav = clips(length=8192, seed=2)
    want = np.asarray(jc.roundtrip(jnp.asarray(wav.numpy())))
    with torch.no_grad():
        got = tc.roundtrip(t(wav.numpy())).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# -- planted faults: each must break the comparison --------------------------------------
def _whole_sequence(codec, monkeypatch):
    for m in codec.model.modules():
        if isinstance(m, LocalMHA):
            monkeypatch.setattr(m, "window", 32)  # every frame of the clip


def _positions_not_reset(codec, monkeypatch):
    monkeypatch.setattr(LocalMHA, "positions", lambda self, t, device: torch.arange(
        t, device=device).reshape(t // self.window, self.window))


def _rotary_left_out(codec, monkeypatch):
    monkeypatch.setattr(LocalMHA, "positions", lambda self, t, device: torch.zeros(
        t // self.window, self.window, device=device))


def _noise_left_out(codec, monkeypatch):
    monkeypatch.setattr(NoiseBlock, "forward", lambda self, x: x)


def _flax_padding(codec, monkeypatch):
    def pads(self, t):
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        total = max((-(-t // s) - 1) * s + d * (k - 1) + 1 - t, 0)
        return total // 2, total - total // 2

    monkeypatch.setattr(SameConv1d, "pads", pads)


FAULTS = {"whole_sequence_attention": _whole_sequence, "rotary_left_out": _rotary_left_out,
          "noise_left_out": _noise_left_out, "flax_padding_at_stride_3": _flax_padding}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_breaks_the_comparison(fault, monkeypatch):
    codec, w = port(small_cfg())
    # the normals of the program's keys, for a program that draws none
    keys = layers.NoiseKey(3)
    noise = [torch.from_numpy(jaxrand.normal(keys.next(), (2, 1, n))) for n in (64, 128, 384, 768)]
    FAULTS[fault](codec, monkeypatch)
    s = stages(codec, w, clips(), noise=noise)
    worst = max(_rel(s["z"], s["zr"]), _rel(s["y"], s["y_ref"]))
    assert worst > 1e-3, (fault, worst)


def test_rotary_positions_running_on_across_windows_change_nothing(monkeypatch):
    """Positions not reset per window add one offset to every query and key
    of a window, and a rotary score depends on the difference of the two
    positions only: the fault leaves the attention as it was, but for the
    rounding of larger angles.  (So no comparison can catch it.)"""
    codec, w = port(small_cfg())
    want = stages(codec, w, clips())
    codec.model.seed_noise(3)
    _positions_not_reset(codec, monkeypatch)
    got = stages(codec, w, clips())
    assert _rel(got["z"], want["z"]) < 1e-4 and _rel(got["y"], want["y"]) < 1e-4


# -- the served encode and the CLIs ---------------------------------------------------------
def test_encode_falls_back_where_the_fused_kernel_refuses(monkeypatch):
    # SNAC 44 kHz's strides divide the kernel's 24-frame tile; 16 does not
    assert rvq_fused.takes((4, 2, 1)) and rvq_fused.takes((8, 4, 2, 1))
    assert not rvq_fused.takes((16, 8, 4, 2, 1)) and not rvq_fused.takes((1,) * 9)
    codec, _ = port(small_cfg(vq_strides=(16, 4, 2, 1)))
    monkeypatch.setattr("nawc_tpu_torch.codec.api.rvq_encode_fused", None)  # never reached
    x = F.pad(clips(), (0, -LENGTH % codec.cfg.chunk))
    with torch.no_grad():
        got = codec.encode(x)
        want = codec.model.quantizer.encode(codec.encode_latent(x))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_layer_ablation_runs_on_the_snac_44khz_preset():
    torch.manual_seed(0)
    cfg = CodecConfig.snac_44khz()
    codec = CodecState(cfg=cfg, model=SnacCodec(cfg).eval().requires_grad_(False))
    wav = clips(n=1, length=12000)
    with torch.no_grad():
        full = layer_ablation(codec, wav, torch.ones(4))
        first = layer_ablation(codec, wav, torch.tensor([1.0, 0.0, 0.0, 0.0]))
    assert full.shape == first.shape == wav.shape
    assert torch.isfinite(full).all() and not torch.equal(full, first)


def test_cli_codec_size_snac44k(capsys):
    from nawc_tpu_torch.cli.common import CODEC_SIZES, load_codec

    assert CODEC_SIZES == ("full", "small", "snac44k")
    codec = load_codec(None, "snac44k", device="cpu")
    assert codec.cfg == CodecConfig.snac_44khz()
    assert "RANDOM weights" in capsys.readouterr().out
    assert float(codec.model.encoder.LocalMHA_0.norm.weight.min()) == 1.0
