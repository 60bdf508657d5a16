"""nawc_tpu_torch.attacks against nawc_tpu.attacks on the CPU: every attack of
``build_suite`` on the same clips and the same key, at 16 kHz (and at
44.1 kHz for the attacks whose lengths depend on the rate), and the neural
codec attacks through the tiny codec.

Tolerances: elementwise and FIR attacks 1e-5 abs; FFT and STFT attacks
1e-4; codec attacks 5e-4.  The rounding attacks (quantization, the
mp3/aac/vorbis surrogates, the compressor, expander and limiter thresholds)
follow a near-tie rule: a sample may differ beyond its tolerance only where
the JAX side's rounded or thresholded value lies within 1e-5 of the
boundary, and such places must be under 0.1% of the cells."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_port import t, tiny_codecs
from nawc_tpu.attacks import build_suite as jax_build_suite
from nawc_tpu.attacks import dsp as jdsp
from nawc_tpu.attacks.codec import latent_roundtrip as jax_latent_roundtrip
from nawc_tpu.attacks.codec import latent_transform_attack as jax_latent_transform
from nawc_tpu.dsp.stft import stft as jax_stft
from nawc_tpu.utils.config import StftConfig as JaxStftConfig
from nawc_tpu_torch.attacks import build_suite, codec_roundtrip, latent_roundtrip, latent_transform_attack
from nawc_tpu_torch.utils import jaxrand

ELEMENTWISE, FFT, CODEC = 1e-5, 1e-4, 5e-4
NEAR = 1e-5  # the rounding attacks' near-tie margin, on the JAX side's value
TOL = {
    "identity": ELEMENTWISE, "gain": ELEMENTWISE, "polarity": ELEMENTWISE,
    "gaussian_noise": ELEMENTWISE, "background_noise": ELEMENTWISE, "lowpass": ELEMENTWISE,
    "highpass": ELEMENTWISE, "eq": ELEMENTWISE, "quantization": ELEMENTWISE,
    "dynamic_range_compression": ELEMENTWISE, "dynamic_range_expansion": ELEMENTWISE,
    "limiter": ELEMENTWISE, "time_jitter": ELEMENTWISE, "time_stretch": ELEMENTWISE,
    "phase_shift": FFT, "reverb": FFT, "mp3": FFT, "aac": FFT, "vorbis": FFT,
}
SUITE_ORDER = [
    "identity", "gain", "polarity", "gaussian_noise", "background_noise", "lowpass", "highpass",
    "eq", "quantization", "dynamic_range_compression", "dynamic_range_expansion", "limiter",
    "phase_shift", "time_jitter", "time_stretch", "reverb", "mp3", "aac", "vorbis",
]
RATE_CASES = [(name, 16_000) for name in SUITE_ORDER] + [
    (name, 44_100) for name in ("phase_shift", "time_stretch", "reverb", "vorbis")]
KEY_SEED = 5


def _clips(sr: int, seconds: float = 1.3, n: int = 2, seed: int = 0) -> np.ndarray:
    """Speech-like: an enveloped harmonic tone plus noise, with quiet and
    loud frames so that the dynamics attacks cross their thresholds."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * tt)
    tone = (np.sin(2 * np.pi * 220 * tt) + 0.3 * np.sin(2 * np.pi * 1320 * tt)) * env
    return (0.3 * tone[None] + 0.05 * rng.normal(size=(n, tt.size))).astype(np.float32)


def _frames_to_samples(frame_mask: np.ndarray, frame: int, n: int) -> np.ndarray:
    out = np.zeros(frame_mask.shape[:-1] + (n,), bool)
    out[..., : frame_mask.shape[-1] * frame] = np.repeat(frame_mask, frame, axis=-1)
    return out


def _surrogate_near(wav, sr, bandwidth_hz, step_db, dither_key):
    """The JAX side's quantiser input (logmag / step, + u with a dither key)
    and keep threshold per STFT cell -> (B, frames) mask of frames holding a
    cell within NEAR of a rounding or threshold boundary, and the cell share."""
    cfg = JaxStftConfig(1024, 256, 1024)
    logmag = np.asarray(jnp.log10(jnp.abs(jax_stft(jnp.asarray(wav), cfg)) + 1e-9) * 20.0)
    freqs = np.asarray(jnp.linspace(0, sr / 2, logmag.shape[-1]))
    x = logmag / (step_db * (1.0 + 2.0 * (freqs / (sr / 2))))
    if dither_key is not None:
        x = x + np.asarray(jax.random.uniform(dither_key, logmag.shape, minval=-0.5, maxval=0.5))
    cells = np.abs(np.abs(x - np.floor(x)) - 0.5) < NEAR
    cells |= np.abs(logmag - (logmag.max(axis=-1, keepdims=True) - 40.0)) < NEAR
    return cells.any(axis=-1), float(cells.mean())


def _near_tie_samples(name, wav, sr, jkey):
    """-> (samples where the rule lets the two sides differ, share of
    near-tie cells) for a rounding attack; (None, 0) for the others."""
    n = wav.shape[-1]
    if name == "quantization":
        x = wav * np.float32(2 ** 13)
        near = np.abs(np.abs(x - np.floor(x)) - 0.5) < NEAR
        return near, float(near.mean())
    if name in ("dynamic_range_compression", "dynamic_range_expansion"):
        db = np.asarray(jdsp._frame_rms_db(jnp.asarray(wav), 256))
        near = np.abs(db - (-18.0 if name == "dynamic_range_compression" else -35.0)) < NEAR
        return _frames_to_samples(near, 256, n), float(near.mean())
    if name == "limiter":
        frames = wav[..., : n - n % 64].reshape(wav.shape[0], -1, 64)
        near = np.abs(0.27 / (np.abs(frames).max(-1) + 1e-9) - 1.0) < NEAR
        return _frames_to_samples(near, 64, n), float(near.mean())
    if name in ("mp3", "aac", "vorbis"):
        bw, step = {"mp3": (0.8, 0.5), "aac": (0.9, 1.0), "vorbis": (0.85, 4.5)}[name]
        frames, share = _surrogate_near(wav, sr, bw * sr / 2, step, jkey if name == "vorbis" else None)
        # a frame's cells reach the samples of its window, n_fft/2 either side
        near = np.zeros(wav.shape, bool)
        delay = int(round(0.030 * sr)) if name == "aac" else 0
        for b, f in zip(*np.nonzero(frames)):
            near[b, max(0, f * 256 - 512 + delay): f * 256 + 512 + delay] = True
        return near, share
    return None, 0.0


@pytest.mark.parametrize("name,sr", RATE_CASES)
def test_attack_matches_jax(name, sr):
    wav = _clips(sr)
    jkey, tkey = jax.random.PRNGKey(KEY_SEED), jaxrand.prng_key(KEY_SEED)
    want = np.asarray(jax_build_suite(sr)[name](jnp.asarray(wav), jkey))
    got = build_suite(sr)[name](t(wav), tkey).numpy()
    assert got.shape == want.shape == wav.shape and got.dtype == np.float32
    bad = np.abs(got - want) > TOL[name]
    near, share = _near_tie_samples(name, wav, sr, jkey)
    assert share < 1e-3, f"{name}: {share:.2%} of cells are near-ties"
    if near is not None:
        bad &= ~near
    assert not bad.any(), f"{name} @ {sr}: {int(bad.sum())} samples differ by more than {TOL[name]}"


def test_suite_names_order_and_codec_entries():
    jc, tc = tiny_codecs(seed=1)
    assert list(build_suite(16_000)) == list(jax_build_suite(16_000)) == SUITE_ORDER
    assert list(build_suite(44_100, tc)) == list(jax_build_suite(44_100, jc)) \
        == SUITE_ORDER + ["encodec", "dac"]


@pytest.mark.parametrize("name", ["encodec", "dac"])
def test_codec_attacks_match_jax(name):
    jc, tc = tiny_codecs(seed=1)
    wav = _clips(16_000, seconds=0.5)
    want = np.asarray(jax_build_suite(16_000, jc)[name](jnp.asarray(wav), jax.random.PRNGKey(0)))
    got = build_suite(16_000, tc)[name](t(wav), jaxrand.prng_key(0)).numpy()
    assert got.shape == want.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=CODEC)
    fn = latent_roundtrip if name == "encodec" else codec_roundtrip
    np.testing.assert_array_equal(fn(tc, t(wav), in_sr=16_000).numpy(), got)


def test_latent_roundtrip_at_the_codec_rate_and_transform_attack():
    jc, tc = tiny_codecs(seed=2)
    wav = _clips(24_000, seconds=0.4, n=1)
    np.testing.assert_allclose(latent_roundtrip(tc, t(wav)).numpy(),
                               np.asarray(jax_latent_roundtrip(jc, jnp.asarray(wav))), atol=CODEC)
    got = latent_transform_attack(tc, t(wav), lambda z: torch.round(z * 4) / 4).numpy()
    want = np.asarray(jax_latent_transform(jc, jnp.asarray(wav), lambda z: jnp.round(z * 4) / 4))
    assert got.shape == wav.shape
    np.testing.assert_allclose(got, want, atol=CODEC)


@pytest.mark.parametrize("n_out", [100, 16_000, 44_100])
def test_time_jitter_resize_is_half_pixel_linear(n_out):
    """``jax.image.resize(..., "linear")`` of the jitter's 32 control points
    is ``F.interpolate(mode="linear", align_corners=False)``."""
    ctrl = np.random.default_rng(n_out).uniform(-1, 1, (3, 32)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(ctrl), (3, n_out), method="linear"))
    got = F.interpolate(t(ctrl)[:, None], size=n_out, mode="linear", align_corners=False)[:, 0]
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
