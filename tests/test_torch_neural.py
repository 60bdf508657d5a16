"""The port's neural watermark (``nawc_tpu_torch/models/neural.py``) against
nawc_tpu's on the CPU: the tiny ``NeuralWMConfig(dim=4, bottleneck_dim=16)``
from the same converted weights (marked audio within 1e-5, logits within
1e-4 of the largest |logit|, presence within 1e-4, bits and offsets equal
except where the pooled |bit logit| is under 1e-3), the windowed embed, the
seeded init, one 1 s clip through the trained checkpoint, the odd-stride
transposed conv, ``jaxrand.randint``, the checkpoint both ways and the
robustness sweep with ``neural``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t, tiny_codecs
from nawc_tpu.models import neural as jn
from nawc_tpu.utils.checkpoint import load_params as jax_load_params
from nawc_tpu.utils.checkpoint import save_params as jax_save_params
from nawc_tpu.utils.config import NeuralWMConfig as JaxNCfg
from nawc_tpu_torch.cli.common import WM_CHOICES, build_watermarkers
from nawc_tpu_torch.codec.layers import SameConvTranspose1d
from nawc_tpu_torch.models import build
from nawc_tpu_torch.models.neural import (NeuralWM, init_trees, load_neural_wm, neural_from_flax,
                                          neural_to_flax)
from nawc_tpu_torch.utils import jaxrand
from nawc_tpu_torch.utils.checkpoint import load_params, save_params, tree_leaves
from nawc_tpu_torch.utils.config import NeuralWMConfig

NCFG = dict(dim=4, bottleneck_dim=16)
CKPT = "checkpoints/neural_wm.msgpack"
NEAR = 1e-3  # pooled |bit logit| under this is a near-tie


def _random(tree: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def draw(x):
        if x.ndim > 1:
            return (rng.normal(size=x.shape) * 0.8 / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        return (rng.normal(size=x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map(draw, tree)


@pytest.fixture(scope="module")
def pair():
    """-> (JAX NeuralWM, port NeuralWM) with the same random weights (the
    generator's output conv is not zero, so the mark is not silent)."""
    g, d = init_trees(0, NeuralWMConfig(**NCFG))
    g, d = _random(g, 1), _random(d, 2)
    jw = jn.NeuralWM(JaxNCfg(**NCFG), *jax.tree_util.tree_map(jnp.asarray, (g, d)))
    return jw, neural_from_flax(g, d, NeuralWMConfig(**NCFG), device="cpu")


@pytest.fixture(scope="module")
def marked(pair):
    jw, _ = pair
    rng = np.random.default_rng(3)
    wav = (rng.normal(size=(3, 40_000)) * 0.1).astype(np.float32)
    msg = rng.integers(0, 2, (3, 16)).astype(np.int32)
    return wav, msg, np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))


def _bits_equal(got, want, pooled) -> int:
    """Bits equal where the pooled |bit logit| is at least NEAR -> the count
    of near-tie bits (reported; they may differ)."""
    got, want, pooled = np.asarray(got), np.asarray(want), np.asarray(pooled)
    sure = np.abs(pooled) >= NEAR
    np.testing.assert_array_equal(got[sure], want[sure])
    return int((~sure).sum())


def test_seeded_init_is_flaxs():
    j = jn.init_neural_wm(jax.random.PRNGKey(3), JaxNCfg(**NCFG), example_len=640)
    g, d = init_trees(3, NeuralWMConfig(**NCFG))
    for a, b in ((j.gen_params, g), (j.det_params, d)):
        want = tree_leaves(jax.tree_util.tree_map(np.asarray, a))
        got = tree_leaves(b)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-7, err_msg=k)
    assert not np.any(tree_leaves(g)["params/Conv_2/kernel"])  # the mark starts silent


def test_generator_and_detector_match(pair, marked):
    jw, tw = pair
    wav, msg, want = marked
    with torch.no_grad():
        got = tw.embed(t(wav), t(msg)).numpy()
        lg = tw.logits(t(want)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(want - wav).max() > 1e-3  # the mark is there
    jl = np.asarray(jw.logits(jnp.asarray(want)))
    assert lg.shape == jl.shape == (3, 40_000, 18)
    assert np.abs(lg - jl).max() <= 1e-4 * np.abs(jl).max()


def test_windowed_embed_is_per_window(pair, marked):
    """Embedding a 2.5-window clip equals embedding each zero-padded window
    (up to the float32 rounding of a conv over another batch size)."""
    _, tw = pair
    wav, msg, _ = marked
    w = tw.cfg.window
    with torch.no_grad():
        whole = tw.embed(t(wav), t(msg)).numpy()
        for i in range(3):
            part = np.zeros((3, w), np.float32)
            seg = wav[:, i * w:(i + 1) * w]
            part[:, : seg.shape[1]] = seg
            one = tw.embed(t(part), t(msg)).numpy()
            np.testing.assert_allclose(whole[:, i * w:(i + 1) * w], one[:, : seg.shape[1]], atol=1e-6)


def test_detect_matches(pair, marked):
    jw, tw = pair
    _, msg, m = marked
    for x in (m, -m, m[:, :23_456]):
        jp, jb = jw.detect(jnp.asarray(x))
        _, _, pooled = jw._detect_one(jnp.asarray(x))
        with torch.no_grad():
            tp, tb = tw.detect(t(x))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
        near = _bits_equal(tb, jb, pooled)
        print(f"detect {x.shape}: {near} near-tie bits")


def test_detect_sync_matches(pair, marked):
    """A 160-sample delay and a flipped polarity: presence, bits and the
    chosen offsets equal (group 3 pads the 160 candidates)."""
    jw, tw = pair
    _, _, m = marked
    x = -np.roll(m, 160, axis=-1)
    jp, jb, jo = jw.detect_sync(jnp.asarray(x), group=3)
    with torch.no_grad():
        tp, tb, to = tw.detect_sync(t(x), group=3)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    realigned = -np.stack([np.roll(r, -int(o)) for r, o in zip(x, np.asarray(jo))])
    pooled = np.where(np.asarray(jp)[:, None] >= 0, jw._detect_one(jnp.asarray(realigned))[2], 0)
    print(f"detect_sync: offsets {np.asarray(jo)}, {_bits_equal(tb, jb, pooled)} near-tie bits")


def test_trained_checkpoint_one_clip():
    """One 1 s clip through the trained ``neural_wm.msgpack`` in both
    packages: marked within 1e-5, presence within 1e-4, bits equal and
    equal to the message (clean channel)."""
    blob = load_params(CKPT)
    assert len(tree_leaves(blob)) == 54
    tw = load_neural_wm(CKPT, device="cpu")
    assert sum(p.numel() for p in (*tw.gen.parameters(), *tw.det.parameters())) == 6_386_547
    init = jn.init_neural_wm(jax.random.PRNGKey(0), example_len=640)
    jb = jax_load_params(CKPT, {"gen": init.gen_params, "det": init.det_params})
    jw = jn.NeuralWM(JaxNCfg(), jb["gen"], jb["det"])
    rng = np.random.default_rng(4)
    wav = (rng.normal(size=(1, 16_000)) * 0.1).astype(np.float32)
    msg = rng.integers(0, 2, (1, 16)).astype(np.int32)
    want = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    with torch.no_grad():
        got = tw.embed(t(wav), t(msg)).numpy()
        tp, tb = tw.detect(t(want))
    np.testing.assert_allclose(got, want, atol=1e-5)
    jp, jbits = jw.detect(jnp.asarray(want))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(tb.numpy(), msg)


@pytest.mark.parametrize("stride", [2, 3, 4, 5, 8])
def test_same_conv_transpose_matches_flax(stride):
    """flax's SAME ``ConvTranspose`` (kernel 2 * stride) at odd and even
    strides; even strides keep the symmetric ``padding = s / 2`` module bit
    for bit."""
    import flax.linen as fnn

    rng = np.random.default_rng(stride)
    x = rng.normal(size=(2, 13, 6)).astype(np.float32)  # (B, T, C) for flax
    mod = fnn.ConvTranspose(5, (2 * stride,), strides=(stride,), padding="SAME")
    params = mod.init(jax.random.PRNGKey(stride), jnp.asarray(x))
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)  # non-zero bias
    want = np.asarray(mod.apply(params, jnp.asarray(x)))
    conv = SameConvTranspose1d(6, 5, stride)
    k = np.asarray(params["params"]["kernel"])
    conv.weight.data = torch.from_numpy(np.ascontiguousarray(np.flip(k, 0).transpose(1, 2, 0)))
    conv.bias.data = t(params["params"]["bias"])
    with torch.no_grad():
        got = conv(t(x).transpose(1, 2)).transpose(1, 2).numpy()
        plain = torch.nn.functional.conv_transpose1d(t(x).transpose(1, 2), conv.weight, conv.bias,
                                                     stride, stride // 2).transpose(1, 2).numpy()
    assert got.shape == want.shape == (2, 13 * stride, 5)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if stride % 2 == 0:
        np.testing.assert_array_equal(got, plain)


@pytest.mark.parametrize("seed,shape,lo,hi", [
    (0, (), -400, 400), (1, (1000,), 0, 7), (2, (17, 3), -5, 1_000_000),
    (3, (64,), 10, 10), (4, (300,), -2**31, 2**31 - 1), (5, (5, 4, 3), 3, -3),
])
def test_randint_bit_for_bit(seed, shape, lo, hi):
    want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
    got = jaxrand.randint(jaxrand.prng_key(seed), shape, lo, hi)
    assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_neural_checkpoint_cross_reads_bit_for_bit(pair, tmp_path):
    """The port writes, JAX's ``load_params`` reads; JAX writes, the port
    reads; both files byte for byte the same."""
    jw, tw = pair
    save_params(tmp_path / "port.msgpack", neural_to_flax(tw))
    template = {"gen": jw.gen_params, "det": jw.det_params}
    back = jax_load_params(tmp_path / "port.msgpack", template)
    want = tree_leaves(jax.tree_util.tree_map(np.asarray, template))
    got = tree_leaves(jax.tree_util.tree_map(np.asarray, back))
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    jax_save_params(tmp_path / "jax.msgpack", template)
    read = tree_leaves(load_params(tmp_path / "jax.msgpack"))
    assert set(read) == set(want) and all(np.array_equal(read[k], want[k]) for k in want)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_registry_and_build_watermarkers():
    wm = build("neural", NeuralWMConfig(**NCFG), seed=3, device="cpu")
    assert isinstance(wm, NeuralWM) and wm.name == "neural" and wm.sample_rate == 16_000
    built = build_watermarkers(["neural"], device="cpu")["neural"]
    assert sum(p.numel() for p in built.det.parameters()) > 1e6  # the trained checkpoint
    assert "neural" in WM_CHOICES


@pytest.mark.parametrize("sync", [False, True])
def test_robustness_with_neural_matches_jax(sync, pair):
    """``run_robustness`` of the neural watermark over the attack suite (the
    tiny codec), 2 speech-like clips of 1.3 s in 1 s chunks: SI-SNRs within
    1e-3 dB, presence within 1e-4, bit accuracies and decisions equal.  The
    trained checkpoint over the whole suite without sync; with sync the
    tiny pair over four attacks (the AAC surrogate's 30 ms delay among
    them), since JAX's detect_sync scans 160 candidates per chunk and takes
    seconds per attack on the CPU even at the tiny width."""
    from nawc_tpu.attacks import build_suite as jax_suite
    from nawc_tpu.cli.common import build_watermarkers as jax_build
    from nawc_tpu.eval import robustness as jrob
    from nawc_tpu_torch.attacks import build_suite
    from nawc_tpu_torch.eval import run_robustness

    jc, tc = tiny_codecs(seed=4)
    rng = np.random.default_rng(5)
    tt = np.arange(20_800) / 16_000
    clips = [(0.3 * np.sin(2 * np.pi * f * tt) * np.clip(np.sin(2 * np.pi * 4 * tt), 0, None)
              + 0.01 * rng.normal(size=tt.size)).astype(np.float32) for f in (140, 190)]
    if sync:
        jw, tw = pair
    else:
        jw = jax_build(["neural"])["neural"]
        tw = build_watermarkers(["neural"], device="cpu")["neural"]
    keep = ("gain", "aac", "lowpass", "dac") if sync else None
    js, ts = ({k: v for k, v in s.items() if k != "identity" and (keep is None or k in keep)}
              for s in (jax_suite(16_000, jc), build_suite(16_000, tc)))
    assert list(js) == list(ts) and len(js) == (4 if sync else 20)
    want = jrob.run_robustness(jw, js, clips, 16_000, 1.0, sync=sync).to_dict("records")
    got = run_robustness(tw, ts, clips, 16_000, 1.0, sync=sync, device="cpu")
    assert len(got) == len(want) == 2 * len(js)  # one whole 1 s chunk per clip
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k, v in w.items():
            if isinstance(v, float) and k.startswith("sisnr"):
                assert abs(g[k] - v) <= 1e-3 or (np.isnan(v) and np.isnan(g[k])), (k, g[k], v)
            elif isinstance(v, float) and not k.startswith(("bitwise", "hard")):
                assert abs(g[k] - v) <= 1e-4, (w["attack_type"], k, g[k], v)
            else:
                assert g[k] == v, (w["attack_type"], k, g[k], v)
