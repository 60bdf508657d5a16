"""nawc_tpu_torch.models.spread_spectrum against nawc_tpu's on the CPU:
embed within ~1e-5, equal bits, and marks made by one package read by the
other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import t
from nawc_tpu.models import SpreadSpectrumWM as JaxWM
from nawc_tpu.models import bit_accuracy as jax_bit_accuracy
from nawc_tpu.models.spread_spectrum import _freq_smooth as jax_freq_smooth
from nawc_tpu.models.spread_spectrum import _level_mask as jax_level_mask
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu.models import random_message as jax_random_message
from nawc_tpu_torch.models import SpreadSpectrumWM, available, bit_accuracy, build, random_message
from nawc_tpu_torch.models.spread_spectrum import _freq_smooth, _level_mask, _quantiles
from nawc_tpu_torch.utils import jaxrand
from nawc_tpu_torch.utils.config import SpreadSpectrumConfig

# the flagship of __graft_entry__.py, and the JAX package's default
# (alpha 0.18 with the level mask sparing the loudest 15% of band bins)
CASES = {
    "flagship": (dict(sample_rate=24_000, band_hi_hz=9000.0, alpha=0.1), 24_000),
    "default": (None, 16_000),
}


def _pair(case):
    kw, sr = CASES[case]
    if kw is None:
        return JaxWM(), SpreadSpectrumWM(), sr
    return JaxWM(cfg=JaxSSCfg(**kw)), SpreadSpectrumWM(cfg=SpreadSpectrumConfig(**kw)), sr


def _signal(sr, n=3, seconds=2.0, seed=0):
    """Noise plus a harmonic tone with an envelope."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    tone = (0.5 * np.sin(2 * np.pi * 220 * tt) + 0.25 * np.sin(2 * np.pi * 1760 * tt)) \
        * (0.5 + 0.5 * np.sin(2 * np.pi * 2.0 * tt))
    x = 0.3 * tone[None] + 0.05 * rng.normal(size=(n, tt.size))
    msg = rng.integers(0, 2, (n, 16)).astype(np.int32)
    return x.astype(np.float32), msg


@pytest.mark.parametrize("case", list(CASES))
def test_embed_matches(case):
    jw, tw, sr = _pair(case)
    wav, msg = _signal(sr)
    want = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    got = tw.embed(t(wav), t(msg)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_detect_and_score_match(case):
    jw, tw, sr = _pair(case)
    wav, msg = _signal(sr, seed=1)
    marked = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    for x in (marked, wav):
        z_j = np.asarray(jw._correlate(jnp.asarray(x)))
        z_t = tw._correlate(t(x)).numpy()
        np.testing.assert_allclose(z_t, z_j, atol=1e-3)
        p_j, b_j = jw.detect(jnp.asarray(x))
        p_t, b_t = tw.detect(t(x))
        sure = np.abs(z_j) > 1e-2
        np.testing.assert_array_equal(b_t.numpy()[sure], np.asarray(b_j)[sure])
        np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-3)
        np.testing.assert_allclose(tw.score(t(x)).numpy(), np.asarray(jw.score(jnp.asarray(x))), atol=1e-3)
        np.testing.assert_allclose(tw.score(t(x), t(msg)).numpy(),
                                   np.asarray(jw.score(jnp.asarray(x), jnp.asarray(msg))), atol=1e-3)


@pytest.mark.parametrize("case", list(CASES))
def test_marks_cross_decode(case):
    """Audio marked by JAX is read by the port, and the reverse."""
    jw, tw, sr = _pair(case)
    wav, msg = _signal(sr, seed=2)
    by_jax = np.asarray(jw.embed(jnp.asarray(wav), jnp.asarray(msg)))
    by_port = tw.embed(t(wav), t(msg)).numpy()
    _, bits_port = tw.detect(t(by_jax))
    _, bits_jax = jw.detect(jnp.asarray(by_port))
    assert float(bit_accuracy(bits_port, t(msg)).mean()) == 1.0
    assert float(jnp.mean(jax_bit_accuracy(bits_jax, jnp.asarray(msg)))) == 1.0


def test_other_seed_does_not_read_the_mark():
    _, tw, sr = _pair("flagship")
    wav, msg = _signal(sr, seed=3)
    marked = tw.embed(t(wav), t(msg))
    p_own, _ = tw.detect(marked)
    p_other, _ = SpreadSpectrumWM(cfg=tw.cfg, seed=5).detect(marked)
    assert float(p_own.min()) > 0.6 and float(p_other.max()) < 0.4


def test_level_mask_and_freq_smooth_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 50, 120)).astype(np.float32)
    for q, lo in [(0.85, 0.0), (0.9, 0.1), (0.0, 0.2)]:
        jc = JaxSSCfg(mask_quantile=q, mask_lo_quantile=lo)
        tc = SpreadSpectrumConfig(mask_quantile=q, mask_lo_quantile=lo)
        np.testing.assert_allclose(_level_mask(t(x), tc).numpy(),
                                   np.asarray(jax_level_mask(jnp.asarray(x), jc)), atol=1e-6)
    np.testing.assert_allclose(_freq_smooth(t(x)).numpy(),
                               np.asarray(jax_freq_smooth(jnp.asarray(x))), atol=1e-5)


@pytest.mark.parametrize("q", [0.85, 0.15])
@pytest.mark.parametrize("rows", ["ties", "smooth", "length 1"])
def test_quantiles_match_jnp(q, rows):
    """The sort-based quantile against ``jnp.quantile``'s default linear
    interpolation, within float32 rounding of the interpolation."""
    rng = np.random.default_rng(5)
    x = {"ties": np.round(rng.normal(size=(3, 1001)), 1),  # many equal values
         "smooth": rng.normal(size=(2, 4, 777)),
         "length 1": rng.normal(size=(4, 1))}[rows].astype(np.float32)
    got = _quantiles(t(x), (q,))[0].numpy()
    want = np.asarray(jnp.quantile(jnp.asarray(x), q, axis=-1))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_level_mask_takes_no_torch_quantile(monkeypatch):
    """``torch.quantile`` refuses rows over 2^24 elements; the level mask
    must not reach it (shown with it made to raise, not with a 16M-cell
    clip) and must still match the JAX mask."""
    def refuse(*a, **k):
        raise RuntimeError("quantile() input tensor is too large")

    monkeypatch.setattr(torch, "quantile", refuse)
    x = np.random.default_rng(6).normal(size=(2, 40, 90)).astype(np.float32)
    jc = JaxSSCfg(mask_quantile=0.85, mask_lo_quantile=0.15)
    tc = SpreadSpectrumConfig(mask_quantile=0.85, mask_lo_quantile=0.15)
    np.testing.assert_allclose(_level_mask(t(x), tc).numpy(),
                               np.asarray(jax_level_mask(jnp.asarray(x), jc)), atol=1e-6)


def test_registry_and_messages():
    assert "spread_spectrum" in available()
    wm = build("spread_spectrum", seed=3)
    assert isinstance(wm, SpreadSpectrumWM) and wm.seed == 3
    with pytest.raises(KeyError):
        build("nope")
    m = random_message(jaxrand.prng_key(0), 4, 16, device="cpu")
    assert m.shape == (4, 16) and m.dtype == torch.int32 and set(m.unique().tolist()) <= {0, 1}
    assert torch.equal(m, random_message(jaxrand.prng_key(0), 4, 16, device="cpu"))
    np.testing.assert_allclose(bit_accuracy(m, m).numpy(), 1.0)


@pytest.mark.parametrize("seed,batch,n_bits", [(0, 4, 16), (1, 1, 16), (7, 3, 5), (123456, 16, 32)])
def test_random_message_is_jaxs(seed, batch, n_bits):
    want = np.asarray(jax_random_message(jax.random.PRNGKey(seed), batch, n_bits))
    got = random_message(jaxrand.prng_key(seed), batch, n_bits, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    folded = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    got = random_message(jaxrand.fold_in(jaxrand.prng_key(seed), 3), batch, n_bits, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_random_message(folded, batch, n_bits)))


def test_random_message_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        random_message(jaxrand.prng_key(0), 2, 16)
