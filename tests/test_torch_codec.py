"""nawc_tpu_torch.codec against nawc_tpu.codec on the CPU: the tiny codec
with the same flax weights in both, and the trained checkpoint on one 1-s
clip (recon tolerance 5e-4, as tests/test_codec.py)."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from _torch_port import TINY, assert_codes_match, t, tiny_codecs
from nawc_tpu.attacks.codec import codec_roundtrip as jax_codec_roundtrip
from nawc_tpu.codec.api import CodecState as JaxCodecState
from nawc_tpu.codec.api import make_codec as jax_make_codec
from nawc_tpu.utils.config import CodecConfig as JaxCodecConfig
from nawc_tpu_torch.attacks.codec import codec_roundtrip
from nawc_tpu_torch.codec import load_codec, make_codec
from nawc_tpu_torch.codec.convert import flax_to_state_dict
from nawc_tpu_torch.ops.snake import sin2_periodic
from nawc_tpu_torch.utils.config import CodecConfig

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "codec_24k.msgpack"


@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs()


def _wav(seed, n=2, length=8192):
    return (np.random.default_rng(seed).normal(size=(n, length)) * 0.1).astype(np.float32)


def test_sin2_polynomial_matches():
    from nawc_tpu.codec.layers import _sin2_periodic as jax_sin2

    z = np.linspace(-40, 40, 100_001).astype(np.float32)
    np.testing.assert_allclose(sin2_periodic(t(z)).numpy(), np.asarray(jax_sin2(jnp.asarray(z))),
                               atol=1e-6)


def test_latents_match(codecs):
    jc, tc = codecs
    wav = _wav(0)
    want = np.asarray(jc.encode_latent(jnp.asarray(wav)))
    got = tc.encode_latent(t(wav)).numpy()
    assert got.shape == want.shape == (2, 16, TINY["latent_dim"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_decode_latent_matches(codecs):
    jc, tc = codecs
    z = np.random.default_rng(1).normal(size=(2, 16, TINY["latent_dim"])).astype(np.float32)
    np.testing.assert_allclose(tc.decode_latent(t(z)).numpy(),
                               np.asarray(jc.decode_latent(jnp.asarray(z))), atol=5e-4)


def test_encode_codes_match(codecs):
    jc, tc = codecs
    wav = _wav(2)
    want = jc.encode(jnp.asarray(wav))
    got = tc.encode(t(wav))
    unfused = tc.model.encode(t(wav))
    for g, u, w in zip(got, unfused, want):
        assert g.shape == w.shape
        assert_codes_match(g.numpy(), np.asarray(w))
        assert_codes_match(u.numpy(), np.asarray(w))


@pytest.mark.parametrize("mask", [None, (1.0, 1.0, 1.0), (1.0, 0.0, 1.0), (0.0, 0.0, 0.0)])
def test_decode_with_level_mask_matches(codecs, mask):
    jc, tc = codecs
    codes = jc.encode(jnp.asarray(_wav(3)))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.tensor(mask)
    want = np.asarray(jc.decode(codes, level_mask=jm))
    got = tc.decode([t(c) for c in codes], level_mask=tm).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_roundtrip_and_forward_match(codecs):
    jc, tc = codecs
    wav = _wav(4)
    np.testing.assert_allclose(tc.roundtrip(t(wav)).numpy(),
                               np.asarray(jc.roundtrip(jnp.asarray(wav))), atol=5e-4)
    out_j, out_t = jc.forward(jnp.asarray(wav)), tc.forward(t(wav))
    np.testing.assert_allclose(out_t["recon"].numpy(), np.asarray(out_j["recon"]), atol=5e-4)
    for a, b in zip(out_t["codes"], out_j["codes"]):
        assert_codes_match(a.numpy(), np.asarray(b))
    for k in ("commit_loss", "codebook_loss"):
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]), rtol=1e-4)


def test_projection_helpers(codecs):
    jc, tc = codecs
    z = np.random.default_rng(5).normal(size=(1, 8, TINY["latent_dim"])).astype(np.float32)
    np.testing.assert_allclose(tc.project_latent(t(z)).numpy(), np.asarray(jc.project_latent(jnp.asarray(z))),
                               atol=1e-5)
    np.testing.assert_array_equal(tc.projected_codebook.numpy(), np.asarray(jc.projected_codebook))
    assert tc.pad(torch.zeros(1, 5000)).shape == (1, 8192)


def test_make_codec_is_seeded_and_frozen():
    a = make_codec(CodecConfig(**TINY), device="cpu", seed=3)
    b = make_codec(CodecConfig(**TINY), device="cpu", seed=3)
    for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters()):
        assert torch.equal(p, q), n
        assert not p.requires_grad
    assert float(a.model.decoder.Conv_1.weight.abs().max()) == 0.0  # zero-init output conv


@pytest.mark.parametrize("seed", [0, 3])
def test_make_codec_matches_jax_init(seed):
    """The port's random weights are the JAX package's of the same seed,
    parameter for parameter, within 1e-6 (flaxinit's erf_inv may round
    otherwise than XLA's)."""
    tc = make_codec(CodecConfig(**TINY), device="cpu", seed=seed)
    jc = jax_make_codec(jax.random.PRNGKey(seed), JaxCodecConfig(**TINY))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jc.params), tc.model)
    got = tc.model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, rtol=0, err_msg=k)


def test_device_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_codec(CodecConfig(**TINY))


def test_trained_checkpoint_one_second():
    """codec_24k.msgpack through both packages: one 1-s clip, the LALM
    round-trip attack and the fused encode."""
    data = CKPT.read_bytes()
    jc = JaxCodecState(cfg=JaxCodecConfig(), params=serialization.msgpack_restore(data))
    tc = load_codec(CKPT, CodecConfig(), device="cpu")
    wav = (np.random.default_rng(6).normal(size=(1, 24_000)) * 0.1).astype(np.float32)
    want = np.asarray(jax_codec_roundtrip(jc, jnp.asarray(wav), in_sr=24_000))
    got = codec_roundtrip(tc, t(wav), in_sr=24_000).numpy()
    assert got.shape == want.shape == (1, 24_000)
    np.testing.assert_allclose(got, want, atol=5e-4)
    padded = jc.pad(jnp.asarray(wav))
    for g, w in zip(tc.encode(t(padded)), jc.encode(padded)):
        assert g.shape == w.shape
        assert_codes_match(g.numpy(), np.asarray(w))
