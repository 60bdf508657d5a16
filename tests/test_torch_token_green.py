"""The port's green-list token watermark against nawc_tpu's on the CPU, with
the tiny codec's weights in both.

Tolerances: the green mask and the null matrix equal; the hinge loss's
gradient within 1e-4 of the largest |gradient|; codes equal but for
near-ties (top-2 cosine margin below 1e-4, ``tests/_torch_port.py``), and
where the codes are equal, the green ratio and the score equal to 1e-6.  The
short embed must raise the green-over-red margin, as JAX's test asks, and
keep its budget."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_codes_match, t, tiny_codecs
from nawc_tpu.models import token_green as jt
from nawc_tpu.utils.padding import pad_to_multiple as jax_pad
from nawc_tpu_torch.cli.common import build_watermarkers
from nawc_tpu_torch.models import TokenGreenWM, build, green_mask, token_green


def _speech(n: int, length: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(length) / 24_000
    f0 = rng.uniform(110, 220, (n, 1))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(3, 5, (n, 1)) * tt) ** 2
    tone = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)) * env
    return (0.2 * tone + 0.01 * rng.normal(size=(n, length))).astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs()


@pytest.fixture(scope="module")
def wav():
    return _speech(2, 2 * 4096, seed=6)


@pytest.mark.parametrize("vocab,seed", [(128, 42), (128, 43), (4096, 42), (1000, 7)])
def test_green_mask_and_null_matrix_are_jaxs(vocab, seed):
    got = green_mask(vocab, seed).numpy()
    np.testing.assert_array_equal(got, np.asarray(jt.green_mask(vocab, seed)))
    assert got.sum() == vocab // 2
    np.testing.assert_array_equal(token_green._null_mask_matrix(vocab, seed),
                                  jt._null_mask_matrix(vocab, seed))


def test_hinge_gradient_matches_jax_grad(codecs, wav):
    jc, tc = codecs
    x = np.asarray(jax_pad(jnp.asarray(wav), jc.cfg.chunk))
    silence = (np.abs(x) > 0.005).astype(np.float32)
    delta = (np.random.default_rng(1).normal(size=x.shape) * 1e-3).astype(np.float32)
    mask = jt.green_mask(jc.cfg.codebook_size, 42)
    cn = jt._normalize(jc.params["params"]["quantizer"]["level_0"]["codebook"])

    def jax_loss(d):  # the loss of nawc_tpu's ``_green_phase``, margin 0.1
        zn = jt._normalize(jt._projected(jc.cfg, jc.params, jnp.asarray(x) + d * jnp.asarray(silence)))
        sims = jnp.einsum("btd,kd->btk", zn, cn)
        g = jnp.max(jnp.where(mask[None, None, :], sims, -2.0), axis=-1)
        r = jnp.max(jnp.where(mask[None, None, :], -2.0, sims), axis=-1)
        return jnp.mean(jax.nn.relu(0.1 - (g - r)))

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(delta)))
    d = t(delta).requires_grad_(True)
    token_green._hinge_loss(tc, green_mask(128, 42), 0.1, t(x), t(silence), d).backward()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(d.grad.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_ratio_and_score_match_jax(codecs, wav):
    jc, tc = codecs
    jw, tw = jt.TokenGreenWM(jc), TokenGreenWM(tc)
    compared = 0
    for x in (wav, wav[:, ::-1].copy(), np.zeros_like(wav)):
        codes_t = tw._codes(t(x))
        x_pad = np.asarray(jax_pad(jnp.asarray(x), jc.cfg.chunk))
        lat = tc.encode_latent(t(x_pad))
        z_e = tc.project_latent(lat.reshape(lat.shape[0], -1, 4, lat.shape[-1]).mean(dim=2))  # stride 4
        near = assert_codes_match(codes_t, jw._codes(jnp.asarray(x)), z_e, tc.projected_codebook)
        if near:  # a near-tie moved a code: the ratio may differ by 1 / T0
            continue
        compared += 1
        np.testing.assert_allclose(tw.green_ratio(t(x)).numpy(),
                                   np.asarray(jw.green_ratio(jnp.asarray(x))), atol=1e-6)
        np.testing.assert_allclose(tw.score(t(x)).numpy(), np.asarray(jw.score(jnp.asarray(x))),
                                   atol=1e-6)
        p_t, bits = tw.detect(t(x))
        np.testing.assert_allclose(p_t.numpy(), np.asarray(jw.detect(jnp.asarray(x))[0]), atol=1e-6)
        assert bits.shape == (2, 0)
    assert compared >= 2
    assert np.isfinite(tw.score(t(np.zeros_like(wav))).numpy()).all()


def test_embed_raises_the_green_margin_within_budget(codecs, wav):
    jc, tc = codecs
    tw = TokenGreenWM(tc, steps=12, target_sdr_db=25.0)

    def margin(x):
        sims = token_green._normalize(token_green._projected(tc, tc.pad(t(x)))) @ \
            token_green._normalize(tc.projected_codebook).T
        m = tw.mask
        return (torch.where(m, sims, -2.0).amax(-1) - torch.where(m, -2.0, sims).amax(-1)).mean(-1)

    with torch.no_grad():  # the embed opens its own grad mode
        marked = tw.embed(t(wav)).numpy()
        before, after = margin(wav), margin(marked)
    assert marked.shape == wav.shape
    assert (after > before).all(), (before, after)
    delta = marked - wav
    amp = np.sqrt(np.mean(wav ** 2, axis=-1)) * 10 ** (-25.0 / 20)
    assert (np.linalg.norm(delta, axis=-1) <= amp * np.sqrt(wav.shape[-1]) * 1.001).all()
    assert (np.abs(delta).max(axis=-1) <= 6.0 * amp * 1.001).all()
    # the embed's first steps as JAX's: few steps, so no sign-like update has drifted
    want = np.asarray(jt.TokenGreenWM(jc, steps=3, target_sdr_db=25.0).embed(jnp.asarray(wav)))
    got = TokenGreenWM(tc, steps=3, target_sdr_db=25.0).embed(t(wav)).numpy()
    excused = int((np.abs(got - want) > 1e-4).sum())
    assert excused <= 1e-3 * got.size, f"{excused} samples differ from JAX's by more than 1e-4"


def test_registry_and_cli_build_it(codecs):
    _, tc = codecs
    wm = build("token_green", tc)
    assert isinstance(wm, TokenGreenWM) and wm.seed == 42 and wm.sample_rate == 24_000
    assert isinstance(build_watermarkers(["token_green"], tc)["token_green"], TokenGreenWM)
