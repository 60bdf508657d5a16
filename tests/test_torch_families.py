"""The port's sync detection, chunked and psychoacoustic watermarks and the
Hamming code against nawc_tpu's on the CPU.

Tolerances: z statistics 1e-4; bits equal wherever |z| > 1e-2 (a near-tie
may flip); presence and soft scores 1e-3; marked audio 1e-5; integer
outputs (best lag, codewords, decoded symbols, discovered length) equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import t
from nawc_tpu.models import ChunkedWM as JaxChunked
from nawc_tpu.models import PsychoacousticWM as JaxPsy
from nawc_tpu.models import SpreadSpectrumWM as JaxSS
from nawc_tpu.models.psychoacoustic import bits_to_ints as jax_bits_to_ints
from nawc_tpu.models.psychoacoustic import ints_to_bits as jax_ints_to_bits
from nawc_tpu.utils import ecc as jecc
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu_torch.models import ChunkedWM, PsychoacousticWM, SpreadSpectrumWM, available, build
from nawc_tpu_torch.models.psychoacoustic import bits_to_ints, ints_to_bits
from nawc_tpu_torch.utils import ecc
from nawc_tpu_torch.utils.config import SpreadSpectrumConfig

Z_TOL, BIT_Z, P_TOL = 1e-4, 1e-2, 1e-3


def _speech(sr: int, seconds: float, n: int, seed: int) -> np.ndarray:
    """Harmonic tones under a syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    f0 = rng.uniform(110, 220, (n, 1))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5, (n, 1)) * tt), 0, None) ** 2
    tone = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)) * env
    return (0.2 * tone + 0.01 * rng.normal(size=(n, tt.size))).astype(np.float32)


def _bits_equal_where_sure(got, want, z):
    sure = np.abs(np.asarray(z)) > BIT_Z
    np.testing.assert_array_equal(np.asarray(got)[sure], np.asarray(want)[sure])


# ------------------------------------------------------------------ detect_sync

def _ss_pair():
    kw = dict(alpha=0.1)
    return JaxSS(cfg=JaxSSCfg(**kw)), SpreadSpectrumWM(cfg=SpreadSpectrumConfig(**kw))


@pytest.mark.parametrize("shift", [0, 3 * 256 + 40])
def test_detect_sync_matches_jax(shift):
    """z at every lag, the best lag, the bits and presence, on marked audio
    delayed by `shift` samples and on unmarked audio."""
    jw, tw = _ss_pair()
    wav = _speech(16_000, 2.0, 3, seed=1)
    msg = np.random.default_rng(2).integers(0, 2, (3, 16)).astype(np.int32)
    marked = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    for x in (np.roll(marked, shift, axis=-1), wav):
        z_j = np.asarray(jw._correlate_all_lags(jnp.asarray(x)))
        z_t = tw._correlate_all_lags(t(x)).numpy()
        assert z_t.shape == z_j.shape == (3, 16, 126)
        np.testing.assert_allclose(z_t, z_j, atol=Z_TOL)
        for max_lag in (None, 20):
            p_j, b_j, l_j = jw.detect_sync(jnp.asarray(x), max_lag=max_lag)
            p_t, b_t, l_t = tw.detect_sync(t(x), max_lag=max_lag)
            np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
            z_best = np.take_along_axis(z_j, np.asarray(l_j)[:, None, None], -1)[..., 0]
            _bits_equal_where_sure(b_t.numpy(), b_j, z_best)
            np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=P_TOL)
    _, bits, lag = tw.detect_sync(t(np.roll(marked, shift, axis=-1)))
    assert (bits.numpy() == msg).mean() == 1.0 and set(lag.tolist()) == {shift // 256}


# ------------------------------------------------------------------ chunked

def test_chunked_matches_jax():
    jw, tw = JaxChunked(), ChunkedWM()
    assert "chunked" in available() and build("chunked") == tw
    wav = _speech(16_000, 2.5, 2, seed=3)  # two 1 s chunks and a 0.5 s tail
    msg = np.random.default_rng(4).integers(0, 2, (2, 16)).astype(np.int32)
    m_j = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    m_t = tw.embed(t(wav), t(msg)).numpy()
    np.testing.assert_allclose(m_t, m_j, atol=1e-5)
    np.testing.assert_array_equal(m_t[:, 32_000:], wav[:, 32_000:])
    for x in (m_j, wav):
        z = np.asarray(jw._chunk_z(jnp.asarray(x))).sum(1) / np.sqrt(2.0)
        np.testing.assert_allclose(tw._zsum(t(x)).numpy(), z, atol=Z_TOL)
        p_j, b_j = jw.detect(jnp.asarray(x))
        p_t, b_t = tw.detect(t(x))
        _bits_equal_where_sure(b_t.numpy(), b_j, z)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=P_TOL)
        np.testing.assert_allclose(tw.score(t(x), t(msg)).numpy(),
                                   np.asarray(jw.score(jnp.asarray(x), jnp.asarray(msg))))
        for m in (None, msg):
            want = jw.score_soft(jnp.asarray(x), None if m is None else jnp.asarray(m))
            got = tw.score_soft(t(x), None if m is None else t(m))
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=P_TOL)
    assert tw.score(t(m_t), t(msg)).min() == 1.0


# ------------------------------------------------------------------ resampled

def test_resampled_chunked_matches_jax():
    """The chunked watermark presented at 24 kHz: embed (resampled down,
    embedded, resampled up, cut to length), detect and score."""
    from nawc_tpu.models import at_rate as jax_at_rate

    from nawc_tpu_torch.models import ResampledWM, at_rate

    jw, tw = jax_at_rate(JaxChunked(), 24_000), at_rate(ChunkedWM(), 24_000)
    assert isinstance(tw, ResampledWM) and at_rate(tw.inner, 16_000) is tw.inner
    assert (tw.name, tw.n_bits, tw.sample_rate) == (jw.name, jw.n_bits, 24_000)
    wav = _speech(24_000, 2.0, 2, seed=7)
    msg = np.random.default_rng(8).integers(0, 2, (2, 16)).astype(np.int32)
    m_j = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    m_t = tw.embed(t(wav), t(msg)).numpy()
    assert m_t.shape == wav.shape
    np.testing.assert_allclose(m_t, m_j, atol=1e-5)
    with pytest.raises(ValueError, match="msg is required"):
        tw.embed(t(wav))
    for x in (m_j, wav):
        z = np.asarray(jw.inner._chunk_z(jw._down(jnp.asarray(x)))).sum(1) / np.sqrt(2.0)
        p_j, b_j = jw.detect(jnp.asarray(x))
        p_t, b_t = tw.detect(t(x))
        _bits_equal_where_sure(b_t.numpy(), b_j, z)
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=P_TOL)
        np.testing.assert_allclose(tw.score(t(x), t(msg)).numpy(),
                                   np.asarray(jw.score(jnp.asarray(x), jnp.asarray(msg))))
        np.testing.assert_allclose(tw.score(t(x)).numpy(), np.asarray(jw.score(jnp.asarray(x))),
                                   atol=P_TOL)
    assert tw.score(t(m_t), t(msg)).min() == 1.0


# ------------------------------------------------------------------ psychoacoustic

@pytest.fixture(scope="module")
def psy():
    jw, tw = JaxPsy(), PsychoacousticWM()
    wav = _speech(44_100, 1.0, 2, seed=5)
    msg = np.array([[1, 2, 3, 4, 5], [200, 17, 0, 255, 9]], np.int32)
    marked = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    return jw, tw, wav, msg, marked


def test_psychoacoustic_embed_and_detect_match_jax(psy):
    jw, tw, wav, msg, marked = psy
    assert tw.cfg.n_bits == 60 and tw.n_bits == 40 and tw.sample_rate == 44_100
    np.testing.assert_allclose(tw.embed(t(wav), t(msg)).numpy(), marked, atol=1e-5)
    np.testing.assert_array_equal(tw.default_message(2, "cpu").numpy(),
                                  np.asarray(jw.default_message(2)))
    for x in (marked, wav):
        z = np.asarray(jw._core._correlate(jnp.asarray(x)))
        np.testing.assert_allclose(tw._core._correlate(t(x)).numpy(), z, atol=Z_TOL)
        p_j, b_j = jw.detect(jnp.asarray(x))
        p_t, b_t = tw.detect(t(x))
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=P_TOL)
        # a symbol may decode otherwise only when two codewords' scores nearly tie
        scores = np.einsum("bsn,kn->bsk", z.reshape(2, 5, 12), 2.0 * jecc._CODEWORDS - 1.0)
        top2 = np.sort(scores, axis=-1)[..., -2:]
        sure = np.repeat((top2[..., 1] - top2[..., 0]) > 12 * BIT_Z, 8, axis=-1)
        np.testing.assert_array_equal(b_t.numpy()[sure], np.asarray(b_j)[sure])
        np.testing.assert_array_equal(tw.score(t(x), t(msg)).numpy(),
                                      np.asarray(jw.score(jnp.asarray(x), jnp.asarray(msg))))
    np.testing.assert_array_equal(tw.decode_message(t(marked)).numpy(), msg)
    np.testing.assert_array_equal(tw.score(t(marked)).numpy(), [1.0, 0.0])


def test_psychoacoustic_discovers_the_message_length():
    """The discovery pass on 2 s clips (at 1 s the live symbols' mean |z|
    falls under the gate of 2), with an 8-symbol probe (K = 96) to keep the
    CPU run small; the card runs the default 64 (K = 768)."""
    jw, tw = JaxPsy(), PsychoacousticWM()
    wav = _speech(44_100, 2.0, 2, seed=7)
    marked = np.asarray(jw.embed(jnp.asarray(wav)))
    got = tw.discover_message_length(t(marked), max_symbols=8)
    assert got == jw.discover_message_length(jnp.asarray(marked), max_symbols=8) == 5
    assert tw.discover_message_length(t(wav), max_symbols=8) == 0


def test_symbol_bits_roundtrip():
    ints = np.array([[0, 1, 128, 255], [7, 64, 33, 200]], np.int32)
    bits = ints_to_bits(t(ints))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jax_ints_to_bits(jnp.asarray(ints))))
    np.testing.assert_array_equal(bits_to_ints(bits).numpy(), ints)
    np.testing.assert_array_equal(bits_to_ints(bits).numpy(),
                                  np.asarray(jax_bits_to_ints(jnp.asarray(bits.numpy()))))


# ------------------------------------------------------------------ ecc

def test_hamming_code_matches_jax():
    rng = np.random.default_rng(6)
    data = rng.integers(0, 2, (4, 5, 8)).astype(np.int32)
    cw = ecc.hamming_encode(t(data))
    np.testing.assert_array_equal(cw.numpy(), np.asarray(jecc.hamming_encode(jnp.asarray(data))))
    np.testing.assert_array_equal(ecc._CODEWORDS, jecc._CODEWORDS)
    # one flipped bit per codeword is corrected; the syndrome decoder says so
    flip = (cw.numpy() + np.eye(12, dtype=np.int32)[rng.integers(0, 12, (4, 5))]) % 2
    for code in (cw.numpy(), flip):
        got, n = ecc.hamming_decode(t(code))
        want, wn = jecc.hamming_decode(jnp.asarray(code))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(n.numpy(), np.asarray(wn))
        np.testing.assert_array_equal(got.numpy(), data)
    llr = (2.0 * flip - 1.0) * rng.uniform(0.1, 3.0, flip.shape)
    llr = llr.astype(np.float32)
    d_t, b_t = ecc.hamming_soft_decode(t(llr))
    d_j, b_j = jecc.hamming_soft_decode(jnp.asarray(llr))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))


def test_soft_decode_takes_the_first_codeword_on_ties():
    """All-zero statistics score every codeword 0: byte 0, as jnp.argmax."""
    d, b = ecc.hamming_soft_decode(t(np.zeros((3, 12), np.float32)))
    assert b.tolist() == [0, 0, 0] and int(jax.numpy.argmax(jnp.zeros(256))) == 0
    np.testing.assert_array_equal(d.numpy(), np.zeros((3, 8), np.int32))
