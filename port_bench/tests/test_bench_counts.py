"""The yardstick's counts against figures counted another way."""

import pytest

from port_bench import counts, harness


@pytest.fixture(scope="module")
def codec_cfg():
    return harness.load_json(harness.BENCH / "configs" / "codec24k-f32.json")["codec"]


def test_codec_convolutions_at_16x4s(codec_cfg):
    # counted with forward hooks on the codec's convolutions at 16 x 4 s
    enc, dec = counts.codec_layers(codec_cfg, 16, 96000)
    assert counts.conv_flops(enc) / 1e12 == pytest.approx(1.2008, abs=5e-5)
    assert counts.conv_flops(dec) / 1e12 == pytest.approx(1.2181, abs=5e-5)


def test_codec_layers_match_the_module(codec_cfg):
    """Every conv and Snake of the port's codec, in order, at a short
    input: shapes from the module's own forward hooks."""
    import torch

    from port_bench.weights import codec_config
    from nawc_tpu_torch.codec.layers import SameConv1d, SameConvTranspose1d, Snake
    from nawc_tpu_torch.codec.model import SnacCodec

    cfg = dict(codec_cfg, encoder_dim=4, latent_dim=16, decoder_dim=16, codebook_size=16)
    model = SnacCodec(codec_config(cfg)).eval()
    seen = []

    def hook(mod, args, out):
        x = args[0]
        if isinstance(mod, Snake):
            seen.append(("snake", x.shape[1], x.shape[2]))
        elif isinstance(mod, SameConvTranspose1d):
            seen.append(("tconv", mod.in_channels, mod.out_channels, mod.kernel_size[0],
                         out.shape[-1], mod.stride[0]))
        else:
            seen.append(("conv", mod.in_channels, mod.out_channels, mod.kernel_size[0],
                         out.shape[-1]))

    for m in model.modules():
        if isinstance(m, (SameConv1d, SameConvTranspose1d, Snake)):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model.roundtrip(torch.zeros(2, 8192))
    enc, dec = counts.codec_layers(cfg, 2, 8192)
    assert [e[1:] for e in enc + dec] == seen


def test_snake_bytes_and_sswm_counts(codec_cfg):
    enc, dec = counts.codec_layers(codec_cfg, 16, 98304)
    assert sum(1 for e in enc + dec if e[1] == "snake") == 58
    # one unpadded 16 x 4 s encode's 29 Snakes, x read and y written in float32: the
    # byte bound chip_smoke.py gives them (3.241 ms at 3.35 TB/s)
    enc96, _ = counts.codec_layers(codec_cfg, 16, 96000)
    assert counts.snake_bytes(enc96, "float32") / 3.35e12 * 1e3 == pytest.approx(3.241, abs=0.001)
    from nawc_tpu_torch.ops.sswm import bound_counts

    wm = harness.load_json(harness.BENCH / "configs" / "codec24k-f32.json")["watermark"]
    assert counts.sswm_counts(wm, 16, 96000) == bound_counts(16, 376, 367, 16, 7)
