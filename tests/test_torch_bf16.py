"""The port's bfloat16 codec against nawc_tpu's bfloat16 codec and against
its own float32 codec on the CPU, with the tiny codec's weights in all four.

Bars: the JAX package's own bf16-vs-f32 bars (``tests/test_codec.py``):
code agreement, averaged over the levels, above 0.94 and decode rel-rms
below 0.1.  Against JAX's bf16 latents the port stays within 2% of the
largest |latent| (bf16 keeps 8 mantissa bits; a one-ulp difference in a
float32 conv sum, which the two packages order differently, grows through
the stack; bf16 against f32 differs about 7 times as much)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY, t, tiny_codecs
from nawc_tpu.codec.layers import Snake as JaxSnake
from nawc_tpu_torch.codec import codec_from_flax
from nawc_tpu_torch.codec.layers import Snake
from nawc_tpu_torch.utils.config import CodecConfig


def _speech(n: int, length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(length) / 24_000
    f0 = rng.uniform(110, 220, (n, 1))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5, (n, 1)) * tt), 0, None) ** 2
    tone = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)) * env
    return (0.2 * tone + 0.01 * rng.normal(size=(n, length))).astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    """-> (JAX f32, JAX bf16, port f32, port bf16), one set of weights."""
    j32, t32 = tiny_codecs()
    j16 = dataclasses.replace(j32, cfg=dataclasses.replace(j32.cfg, compute_dtype="bfloat16"))
    tree = jax.tree_util.tree_map(np.asarray, j32.params)
    t16 = codec_from_flax(tree, CodecConfig(**TINY, compute_dtype="bfloat16"), device="cpu")
    return j32, j16, t32, t16


@pytest.fixture(scope="module")
def wav():
    return _speech(2, 2 * 4096, seed=3)


def _agreement(a, b) -> float:
    return float(np.mean([np.mean(np.asarray(x) == np.asarray(y)) for x, y in zip(a, b)]))


def test_snake_rounds_as_xla_does():
    """A bf16 Snake equals flax's bit for bit: the product alpha * x stays
    float32 into the range reduction, sin^2 and the division round to
    bf16."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 300, 8)) * 2).astype(np.float32)
    log_alpha = (rng.normal(size=(8,)) * 0.3).astype(np.float32)
    want = jax.jit(lambda x: JaxSnake(dtype=jnp.bfloat16).apply(
        {"params": {"log_alpha": jnp.asarray(log_alpha)}}, x))(jnp.asarray(x))
    snake = Snake(8).requires_grad_(False)
    snake.log_alpha.copy_(t(log_alpha))
    got = snake(t(x).transpose(1, 2).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().transpose(1, 2).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_bf16_latents_match_jax_bf16(codecs, wav):
    _, j16, t32, t16 = codecs
    want = np.asarray(j16.encode_latent(jnp.asarray(wav)))
    got = t16.encode_latent(t(wav))
    assert got.dtype == torch.float32 and got.shape == want.shape
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2 * scale)
    # bf16 really runs: the float32 codec's latents differ several times more
    assert np.abs(t32.encode_latent(t(wav)).numpy() - want).max() > 4 * np.abs(got.numpy() - want).max()


def test_bf16_codes_agree_with_jax_bf16_and_port_f32(codecs, wav):
    j32, j16, t32, t16 = codecs
    got = t16.encode(t(wav))
    assert _agreement(got, j16.encode(jnp.asarray(wav))) > 0.94
    assert _agreement(got, t32.encode(t(wav))) > 0.94
    # the JAX package's own bf16-vs-f32 agreement on the same clip, for scale
    assert _agreement(j16.encode(jnp.asarray(wav)), j32.encode(jnp.asarray(wav))) > 0.94


def test_bf16_decode_tracks_f32_and_jax(codecs, wav):
    _, j16, t32, t16 = codecs
    codes = t32.encode(t(wav))
    y32, y16 = t32.decode(codes), t16.decode(codes)
    assert y16.dtype == torch.float32

    def rel_rms(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-9))

    assert rel_rms(y16.numpy(), y32.numpy()) < 0.1
    want = np.asarray(j16.decode([jnp.asarray(c.numpy()) for c in codes]))
    assert rel_rms(y16.numpy(), want) < 0.1
    # the round-trip runs the bf16 encoder and decoder around the f32 VQ
    assert torch.isfinite(t16.roundtrip(t(wav))).all()
