"""The port's training path against nawc_tpu's on the CPU, on the tiny
codec and a tiny neural watermark: the 12 differentiable attacks, one step
of each trainer (loss within 1e-5 relative, gradients per leaf within 1e-4
of the leaf's largest |gradient|, and the update by the excused-sample
rule: off JAX's by more than 1e-4 in under 0.1% of the entries), the
optimiser pieces against optax, the dead-code revival, the batch loader,
the checkpoints and the four training CLIs."""

import ast
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_port import TINY, t, tiny_codecs
import nawc_tpu.attacks.dsp as jax_dsp
from nawc_tpu.codec.model import SnacCodec as JaxSnac
from nawc_tpu.train import adversarial as jadv
from nawc_tpu.train import codec_train as jct
from nawc_tpu.train import wm_train as jwt
from nawc_tpu.utils.checkpoint import load_params as jax_load_params
from nawc_tpu.utils.checkpoint import save_params as jax_save_params
from nawc_tpu.utils.config import CodecConfig as JaxCodecCfg
from nawc_tpu.utils.config import NeuralWMConfig as JaxNCfg
from nawc_tpu_torch.codec.convert import state_dict_to_flax, to_flax_layout
from nawc_tpu_torch.models.neural import init_trees, neural_from_flax
from nawc_tpu_torch.train import adversarial as tadv
from nawc_tpu_torch.train import codec_train as tct
from nawc_tpu_torch.train import optim
from nawc_tpu_torch.train import wm_train as twt
from nawc_tpu_torch.utils import audio_io, jaxrand
from nawc_tpu_torch.utils.checkpoint import load_params, save_params, tree_leaves
from nawc_tpu_torch.utils.config import CodecConfig, NeuralWMConfig

NCFG = dict(dim=4, bottleneck_dim=16)
T_WM = 16_000
T_CODEC = 8192
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4    # of each leaf's largest |gradient|
UPDATE_TOL = 1e-4  # excused-sample rule: entries off by more than this ...
EXCUSED = 1e-3     # ... must stay under this share


@pytest.fixture(autouse=True, scope="module")
def native_cpu_convs():
    """PyTorch's native CPU convolutions for these tests: the oneDNN float32
    conv backward of this CPU build sums weight and bias gradients over long
    sequences with errors near 4e-5 of the largest (against float64; JAX's
    and the native path's are under 1e-6).  The card runs cuDNN."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.fixture
def traceable_surrogate(monkeypatch):
    """The reference cannot trace ``_diff_attack``'s codec_surrogate
    branch: ``lossy_codec_surrogate`` is jitted with its bandwidth and step
    as static arguments, and the branch passes traced values.  Its unjitted
    function computes the same values and traces (ROADMAP.md C)."""
    monkeypatch.setattr(jax_dsp, "lossy_codec_surrogate", jax_dsp.lossy_codec_surrogate.__wrapped__)


def _np_leaves(tree) -> dict:
    return {k: np.asarray(v) for k, v in tree_leaves(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _grads(model: torch.nn.Module) -> dict:
    """The module's gradients in flax layout (zeros where none reached)."""
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters() if p.requires_grad}
    return tree_leaves(to_flax_layout(model, grads)["params"])


def assert_grads_close(got: dict, want: dict, moved: dict | None = None) -> None:
    """Each leaf within GRAD_TOL of its largest |gradient|.  Where `moved`
    gives how far JAX's own gradient of that leaf moves when the input or
    the weights move by one float32 ulp (an ill-conditioned loss), the bar
    is the larger of that bar and twice the movement."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        err = float(np.abs(got[k] - w).max())
        bar = GRAD_TOL * float(np.abs(w).max())
        if moved is not None:
            bar = max(bar, 2.0 * moved[k])
        assert err <= bar, (k, err, float(np.abs(w).max()))


def ulp_up(x: np.ndarray) -> np.ndarray:
    return np.nextafter(x, np.float32(np.inf)).astype(np.float32)


def ulp_jitter(tree, seed: int = 0):
    """Every weight moved by one float32 ulp, up or down at random."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda x: np.where(
        rng.uniform(size=np.shape(x)) < 0.5, np.nextafter(x, np.float32(np.inf)),
        np.nextafter(x, np.float32(-np.inf))).astype(np.float32), tree)


def movement(base: dict, *moved: dict) -> dict:
    """Per leaf, the largest change of JAX's gradient over the perturbed runs."""
    return {k: max(float(np.abs(m[k] - base[k]).max()) for m in moved) for k in base}


def assert_update_close(got: dict, want: dict, share: float = EXCUSED, cap: float = np.inf) -> int:
    """-> the entries off by more than UPDATE_TOL (under `share` of all,
    none off by more than `cap`)."""
    diff = np.concatenate([np.abs(got[k] - want[k]).ravel() for k in want])
    off = int((diff > UPDATE_TOL).sum())
    assert off < share * diff.size and diff.max() <= cap, (off, diff.size, float(diff.max()))
    return off


def assert_loss_close(got, want) -> None:
    got = float(got.detach()) if isinstance(got, torch.Tensor) else float(got)
    assert abs(got - float(want)) <= LOSS_RTOL * max(abs(float(want)), 1e-6), (got, want)


def _speech(n: int, length: int, sr: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tt = np.arange(length) / sr
    out = []
    for _ in range(n):
        f0 = rng.uniform(100, 220)
        env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5) * tt), 0, None) ** 2
        tone = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)) * env
        out.append(0.25 * tone + 0.01 * rng.normal(size=length))
    return np.stack(out).astype(np.float32)


def _random_tree(tree: dict, seed: int) -> dict:
    """Same-shaped leaves of LeCun scale (biases and alphas 0.1)."""
    rng = np.random.default_rng(seed)

    def draw(x):
        if x.ndim > 1:
            return (rng.normal(size=x.shape) * 0.8 / np.sqrt(np.prod(x.shape[:-1]))).astype(np.float32)
        return (rng.normal(size=x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map(draw, tree)


# ------------------------------------------------------------------ attacks

@pytest.fixture(scope="module")
def jax_diff_attack():
    """JAX's ``_diff_attack``, jitted once for the 12 branches (the step is
    traced, as in the trainer), with the traceable surrogate."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_dsp, "lossy_codec_surrogate", jax_dsp.lossy_codec_surrogate.__wrapped__)
        fn = jax.jit(jwt._diff_attack)
        fn(jnp.zeros((2, T_WM), jnp.float32), jax.random.PRNGKey(0), jnp.asarray(0), jnp.float32(0.0))
    return fn


@pytest.mark.parametrize("branch", range(12))
def test_diff_attack_branch_matches_jax(branch, jax_diff_attack):
    wav = _speech(2, T_WM, 16_000, seed=1)
    sev = np.float32(0.6)
    want = np.asarray(jax_diff_attack(jnp.asarray(wav), jax.random.PRNGKey(5),
                                      jnp.asarray(12 + branch), jnp.float32(sev)))
    got = twt._diff_attack(t(wav), jaxrand.prng_key(5), 12 + branch, sev).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------------------------ wm step

@pytest.fixture(scope="module")
def wm_trees():
    g, d = init_trees(0, NeuralWMConfig(**NCFG))
    return _random_tree(g, 11), _random_tree(d, 12)


@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs(seed=2)


@pytest.mark.parametrize("branch", ["dsp", "codec"])
def test_wm_step_matches_jax(branch, wm_trees, codecs, traceable_surrogate):
    """Loss, gradients and one clipped AdamW update of the joint step; the
    DSP branch at step 6007 (the reverb, severity 0.5), the codec
    branch through the tiny codec (the STE gradient to the input)."""
    jc, tc = codecs
    step = 6007
    g, d = wm_trees
    rng = np.random.default_rng(3)
    wav = _speech(2, T_WM, 16_000, seed=4)
    msg = rng.integers(0, 2, (2, 16)).astype(np.int32)
    jcfg, tcfg = JaxNCfg(**NCFG), NeuralWMConfig(**NCFG)
    gp, dp = jax.tree_util.tree_map(jnp.asarray, (g, d))
    codec_j, codec_t = (jc, tc) if branch == "codec" else (None, None)

    def jloss(gp, dp):
        return jwt.wm_loss(jcfg, gp, dp, jnp.asarray(wav), jnp.asarray(msg), jax.random.PRNGKey(9),
                           jnp.asarray(step), codec_j)

    (jl, jm), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(gp, dp)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(2e-4, weight_decay=1e-5))
    upd, _ = tx.update(jgrads, tx.init((gp, dp)), (gp, dp))
    jnew = optax.apply_updates((gp, dp), upd)

    wm = neural_from_flax(g, d, tcfg, device="cpu")
    wm.gen.requires_grad_(True)
    wm.det.requires_grad_(True)
    opt = optim.AdamW(list(wm.gen.parameters()) + list(wm.det.parameters()), 2e-4, weight_decay=1e-5)
    opt.zero_grad()
    tl, tm = twt.wm_loss(tcfg, wm, t(wav), t(msg), jaxrand.prng_key(9), step, codec_t)
    tl.backward()
    assert set(tm) == set(jm)
    for k in jm:
        assert_loss_close(tm[k], jm[k])
    assert_grads_close(_grads(wm.gen), _np_leaves(jgrads[0]["params"]))
    assert_grads_close(_grads(wm.det), _np_leaves(jgrads[1]["params"]))
    opt.step()
    assert_update_close(tree_leaves(state_dict_to_flax(wm.gen)["params"]), _np_leaves(jnew[0]["params"]))
    assert_update_close(tree_leaves(state_dict_to_flax(wm.det)["params"]), _np_leaves(jnew[1]["params"]))


# ------------------------------------------------------------------ codec step

def test_codec_step_matches_jax(codecs):
    """The codec loss (usage histograms equal), its gradients, and two steps
    of the warmup-cosine AdamW (the first at learning rate 0).

    The multi-resolution STFT term takes log|S| of the reconstruction, so
    its gradient weighs each bin by 1 / (|S| + 1e-5) in the direction of S:
    at quiet bins that direction is set by float32 rounding, and JAX's own
    gradient moves by up to 4e-3 of a leaf's largest |gradient| when the
    input moves by one ulp (ROADMAP.md C).  The whole gradient is held to
    twice that movement (or the weights'), leaf by leaf; the rest of the
    loss (L1, mel, commitment and codebook terms) to 1e-4."""
    jc, _ = codecs
    tree = jax.tree_util.tree_map(np.asarray, jc.params)
    jcfg, tcfg = JaxCodecCfg(**TINY), CodecConfig(**TINY)
    w1, w2 = _speech(2, T_CODEC, 24_000, seed=5), _speech(2, T_CODEC, 24_000, seed=6)

    def strict(p, w):
        m = jct.codec_loss(jcfg, p, w)[1]
        return m["l1"] + m["mel"] + 0.25 * m["commit"] + m["codebook"]

    both = jax.jit(lambda p, w: (jax.value_and_grad(lambda q: jct.codec_loss(jcfg, q, w), has_aux=True)(p),
                                 jax.grad(strict)(p, w)))
    ((jl, jm), jg), jg_strict = both(jc.params, jnp.asarray(w1))
    (_, jg_x), _ = both(jc.params, jnp.asarray(ulp_up(w1)))
    (_, jg_w), _ = both(ulp_jitter(tree), jnp.asarray(w1))
    jg, jg_strict, jg_x, jg_w = (_np_leaves(x["params"]) for x in (jg, jg_strict, jg_x, jg_w))

    model = tct.trainable_codec(tcfg, device="cpu", tree=tree)
    tl, tm = tct.codec_loss(tcfg, model, t(w1))
    tl.backward(retain_graph=True)
    assert set(tm) == set(jm)
    for k in jm:
        if k.startswith("usage_"):
            np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))
        else:
            assert_loss_close(tm[k], jm[k])
    assert_grads_close(_grads(model), jg, movement(jg, jg_x, jg_w))
    model.zero_grad()
    (tm["l1"] + tm["mel"] + 0.25 * tm["commit"] + tm["codebook"]).backward()
    assert_grads_close(_grads(model), jg_strict)

    tx = jct.make_optimizer(3e-4, total=100)
    jstep = jct.make_codec_train_step(jcfg, tx)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = tx.init(params)
    model = tct.trainable_codec(tcfg, device="cpu", tree=tree)
    state = tct.CodecTrainState(model, tct.make_optimizer(model.parameters(), 3e-4, total=100), 0)
    tstep = tct.make_codec_train_step(tcfg)
    for w in (w1, w2):
        params, opt_state, jm = jstep(params, opt_state, jnp.asarray(w))
        tm = tstep(state, t(w))
        assert_loss_close(tm["loss"], jm["loss"])
    assert state.opt.count == 2
    assert_update_close(tree_leaves(state_dict_to_flax(state.model)["params"]), _np_leaves(params["params"]))


# ------------------------------------------------------------------ GAN step

@pytest.fixture(scope="module")
def gan_setup(codecs):
    jc, _ = codecs
    tree = jax.tree_util.tree_map(np.asarray, jc.params)
    dtree = jax.tree_util.tree_map(np.asarray, jadv.init_discriminators(jax.random.PRNGKey(1), T_CODEC))
    return tree, dtree, _speech(2, T_CODEC, 24_000, seed=7)


def test_discriminator_init_is_flaxs(gan_setup):
    _, dtree, _ = gan_setup
    disc = tadv.init_discriminators(1, device="cpu")
    got, want = tree_leaves(state_dict_to_flax(disc)["params"]), _np_leaves(dtree["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-7, err_msg=k)


def test_gan_gradients_match_jax(gan_setup):
    """The discriminator loss's and the decoder objective's gradients, from
    the same weights, through the public loss functions: the discriminators'
    on the same real and reconstructed inputs, the decoder's held to the
    larger of 1e-4 of the leaf's largest and twice JAX's own movement under
    a one-ulp change of the input or the weights (it carries the codec
    loss's STFT term, see test_codec_step_matches_jax)."""
    tree, dtree, wav = gan_setup
    jcfg, tcfg = JaxCodecCfg(**TINY), CodecConfig(**TINY)
    pad = jadv.pad_for_periods(T_CODEC) - T_CODEC
    disc = jadv.Discriminators()

    @jax.jit
    def jax_grads(w, tree):
        real = jnp.pad(w, ((0, 0), (0, pad)))
        recon0 = JaxSnac(jcfg).apply(tree, w, method=JaxSnac.roundtrip)
        fake0 = jnp.pad(recon0, ((0, 0), (0, pad)))
        jd = jax.grad(lambda dp: jadv.d_loss_fn(disc.apply(dp, real), disc.apply(dp, fake0)))(dtree)
        outs_real = disc.apply(dtree, real)

        def g_obj(gp):
            recon = JaxSnac(jcfg).apply(gp, w, method=JaxSnac.roundtrip)
            rec, _ = jadv.recon_losses(jcfg, w, recon, 0.05)
            outs_fake = disc.apply(dtree, jnp.pad(recon, ((0, 0), (0, pad))))
            return rec + jadv.g_adv_loss_fn(outs_fake) + 2.0 * jadv.feature_match_fn(outs_real, outs_fake)

        return jd, jax.value_and_grad(g_obj)(tree), fake0

    jd, (jl, jg), fake0 = jax_grads(jnp.asarray(wav), tree)
    _, (_, jg_x), _ = jax_grads(jnp.asarray(ulp_up(wav)), tree)
    _, (_, jg_w), _ = jax_grads(jnp.asarray(wav), ulp_jitter(tree))
    jd = _np_leaves(jd["params"])
    jg, jg_x, jg_w = ({k: v for k, v in _np_leaves(x["params"]).items() if k.startswith("decoder/")}
                      for x in (jg, jg_x, jg_w))

    model = tct.trainable_codec(tcfg, device="cpu", tree=tree)
    tdisc = tadv.Discriminators()
    tdisc.load_state_dict(tadv.flax_to_state_dict(dtree, tdisc))
    treal = torch.nn.functional.pad(t(wav), (0, pad))
    # the discriminators' gradient on JAX's reconstruction: the same inputs
    tadv.d_loss_fn(tdisc(treal), tdisc(t(fake0))).backward()
    assert_grads_close(_grads(tdisc), jd)
    tadv.decoder_only_tx(model, lr=1e-4)
    tdisc.requires_grad_(False)
    with torch.no_grad():
        touts_real = tdisc(treal)
    recon = model.roundtrip(t(wav))
    rec, _ = tadv.recon_losses(tcfg, t(wav), recon, 0.05)
    outs_fake = tdisc(torch.nn.functional.pad(recon, (0, pad)))
    tl = rec + tadv.g_adv_loss_fn(outs_fake) + 2.0 * tadv.feature_match_fn(touts_real, outs_fake)
    tl.backward()
    assert_loss_close(tl, jl)
    assert_grads_close(_grads(model), jg, movement(jg, jg_x, jg_w))


def test_gan_step_matches_jax_and_freezes_encoder(gan_setup):
    """One GAN step (D update, then the decoder against the updated D):
    every metric, the updated discriminator and decoder by the
    excused-sample rule, and the encoder and quantizer bit for bit
    unchanged (``multi_transform``'s ``set_to_zero``)."""
    tree, dtree, wav = gan_setup
    jcfg, tcfg = JaxCodecCfg(**TINY), CodecConfig(**TINY)
    inner = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.adamw(1e-4, b1=0.8, b2=0.99, weight_decay=1e-4))
    gtx = jadv.decoder_only_tx(inner, tree)
    dtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(2e-4, b1=0.8, b2=0.99, weight_decay=1e-4))
    gp, dp = jax.tree_util.tree_map(jnp.asarray, (tree, dtree))
    jstep = jadv.make_gan_train_step(jcfg, gtx, dtx)
    gp, dp, _, _, jm = jstep(gp, dp, gtx.init(gp), dtx.init(dp), jnp.asarray(wav))

    model = tct.trainable_codec(tcfg, device="cpu", tree=tree)
    disc = tadv.Discriminators()
    disc.load_state_dict(tadv.flax_to_state_dict(dtree, disc))
    g_opt = tadv.decoder_only_tx(model, lr=1e-4, b1=0.8, b2=0.99, weight_decay=1e-4)
    d_opt = optim.AdamW(disc.parameters(), 2e-4, b1=0.8, b2=0.99, weight_decay=1e-4)
    tm = tadv.make_gan_train_step(tcfg)(model, disc, g_opt, d_opt, t(wav))
    assert set(tm) == set(jm)
    for k in jm:
        assert_loss_close(tm[k], jm[k])
    got = tree_leaves(state_dict_to_flax(model)["params"])
    before = _np_leaves(tree["params"])
    after = _np_leaves(gp["params"])
    frozen = [k for k in got if not k.startswith("decoder/")]
    assert frozen and all(np.array_equal(got[k], before[k]) for k in frozen)
    assert all(np.array_equal(after[k], before[k]) for k in frozen)
    assert_update_close({k: got[k] for k in got if k.startswith("decoder/")},
                        {k: after[k] for k in after if k.startswith("decoder/")})
    assert_update_close(tree_leaves(state_dict_to_flax(disc)["params"]), _np_leaves(dp["params"]))


# ------------------------------------------------------------------ optimiser pieces

@pytest.mark.parametrize("scale", [0.01, 3.0])
def test_clip_by_global_norm_is_optaxs(scale):
    rng = np.random.default_rng(8)
    grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in grads], None)
    got = [t(g) for g in grads]
    norm = optim.clip_by_global_norm_(got, 1.0)
    assert abs(float(norm) - float(optax.global_norm([jnp.asarray(g) for g in grads]))) < 1e-6 * float(norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-7, atol=0)


@pytest.mark.parametrize("total", [20, 100_000])
def test_schedule_is_optaxs_at_optaxs_count(total):
    """The codec trainer's schedule at counts 0 (learning rate 0: the first
    update), mid-warmup, warmup, mid-decay, total and beyond."""
    lr, warmup = 3e-4, min(500, max(total // 10, 1))
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1), lr * 0.05)
    got = optim.warmup_cosine_decay_schedule(0.0, lr, warmup, max(total, warmup + 1), lr * 0.05)
    assert got(0) == 0.0
    for count in (0, warmup // 2, warmup, (warmup + total) // 2, total, total + 7):
        assert abs(got(count) - float(want(count))) <= 1e-6 * lr, count


# ------------------------------------------------------------------ revival, loader

def test_revive_dead_codes_is_jaxs(codecs):
    jc, _ = codecs
    tree = jax.tree_util.tree_map(np.asarray, jc.params)
    jcfg, tcfg = JaxCodecCfg(**TINY), CodecConfig(**TINY)
    rng = np.random.default_rng(10)
    usage = {i: np.where(rng.uniform(size=128) < 0.4, 0, rng.integers(1, 50, 128)).astype(np.int64)
             for i in range(3)}
    usage[2][:] = 0  # a level with no live code is left as it is
    want, jdead = jct.revive_dead_codes(tree, usage, jcfg, np.random.default_rng(7))
    model = tct.trainable_codec(tcfg, device="cpu", tree=tree)
    versions = [lvl.codebook._version for lvl in model.quantizer.levels]
    tdead = tct.revive_dead_codes(model, usage, tcfg, np.random.default_rng(7))
    assert tdead == jdead and jdead[0] > 0
    for i, lvl in enumerate(model.quantizer.levels):
        np.testing.assert_array_equal(lvl.codebook.detach().numpy(),
                                      np.asarray(want["params"]["quantizer"][f"level_{i}"]["codebook"]))
    # the written codebooks move their version (a kernel's cached table is rebuilt)
    assert [lvl.codebook._version > v for lvl, v in zip(model.quantizer.levels, versions)][:2] == [True, True]


def test_speech_batches_are_jaxs(tmp_path):
    files = []
    for i, sr in enumerate((24_000, 24_000, 16_000)):
        files.append(str(tmp_path / f"c{i}.wav"))
        audio_io.write_wav(files[-1], _speech(1, int(sr * (0.3 + 0.4 * i)), sr, seed=20 + i), sr)
    gj = jct.speech_batches(files, 3, 0.5, 24_000, seed=4)
    gt = tct.speech_batches(files, 3, 0.5, 24_000, seed=4)
    for _ in range(4):
        a, b = next(gj), next(gt)
        assert a.shape == b.shape == (3, 12_000) and b.dtype == np.float32
        np.testing.assert_allclose(b, a, atol=1e-6)


# ------------------------------------------------------------------ checkpoints

def test_codec_checkpoint_cross_reads_bit_for_bit(codecs, tmp_path):
    """The port writes, JAX's ``load_params`` reads; JAX writes, the port
    reads; the port's file is byte for byte the one flax writes."""
    jc, _ = codecs
    model = tct.trainable_codec(CodecConfig(**TINY), device="cpu",
                                tree=jax.tree_util.tree_map(np.asarray, jc.params))
    save_params(tmp_path / "port.msgpack", state_dict_to_flax(model))
    back = jax_load_params(tmp_path / "port.msgpack", jc.params)
    want = _np_leaves(jc.params)
    got = _np_leaves(back)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    jax_save_params(tmp_path / "jax.msgpack", jax.tree_util.tree_map(np.asarray, jc.params))
    read = tree_leaves(load_params(tmp_path / "jax.msgpack"))
    assert set(read) == set(want) and all(np.array_equal(read[k], want[k]) for k in want)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


# ------------------------------------------------------------------ CLIs

@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    for i in range(3):
        audio_io.write_wav(root / f"s{i}.wav", _speech(1, 30_000 + 7_000 * i, 24_000, seed=30 + i), 24_000)
    return root


def _log(path) -> list[dict]:
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    for r in rows:
        r.pop("wall")
    return rows


def _assert_logs_close(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want) and all(list(g) == list(w) for g, w in zip(got, want))
    for g, w in zip(got, want):
        for k, v in w.items():
            if isinstance(v, float):
                assert_loss_close(g[k], v)
            else:
                assert g[k] == v, (k, g[k], v)


def _assert_checkpoints_close(got_path, want_path, **rule) -> None:
    got, want = tree_leaves(load_params(got_path)), tree_leaves(load_params(want_path))
    assert list(got) == list(want)
    assert_update_close(got, want, **rule)


def test_train_codec_cli_matches_jax(wav_dir, tmp_path):
    from nawc_tpu.cli import train_codec as jcli
    from nawc_tpu_torch.cli import train_codec as tcli

    common = ["--audio_glob", str(wav_dir / "*.wav"), "--steps", "2", "--batch", "2",
              "--size", "small", "--log_every", "1", "--revive_every", "2", "--seconds", "0.35"]
    jcli.main(common + ["--out", str(tmp_path / "j.msgpack")])
    tcli.main(common + ["--out", str(tmp_path / "t.msgpack"), "--device", "cpu"])
    _assert_logs_close(_log(tmp_path / "t.log.jsonl"), _log(tmp_path / "j.log.jsonl"))
    _assert_checkpoints_close(tmp_path / "t.msgpack", tmp_path / "j.msgpack")


def test_train_gan_cli_matches_jax(wav_dir, tmp_path, codecs):
    from nawc_tpu.cli import train_gan as jcli
    from nawc_tpu_torch.cli import train_gan as tcli

    # the small codec's shapes with the tiny codec's weights: its latents stay in range
    small = tmp_path / "small.msgpack"
    save_params(small, jax.tree_util.tree_map(np.asarray, codecs[0].params))
    common = ["--audio_glob", str(wav_dir / "*.wav"), "--steps", "2", "--batch", "2", "--size", "small",
              "--log_every", "1", "--val_files", "0", "--resume", str(small), "--seconds", "0.35"]
    jcli.main(common + ["--out", str(tmp_path / "j.msgpack")])
    tcli.main(common + ["--out", str(tmp_path / "t.msgpack"), "--device", "cpu"])
    _assert_logs_close(_log(tmp_path / "t.log.jsonl"), _log(tmp_path / "j.log.jsonl"))
    # the decoder's gradient carries the ill-conditioned STFT term, so after
    # two sign-like Adam steps more entries step the other way than after
    # one: within 1e-4 in all but 1%, and no entry off by more than the two
    # steps' 4 lr (ROADMAP.md C)
    _assert_checkpoints_close(tmp_path / "t.msgpack", tmp_path / "j.msgpack", share=1e-2, cap=4e-4)


def test_train_wm_cli_matches_jax(wav_dir, tmp_path, codecs, traceable_surrogate):
    """Two steps at the CLI's NeuralWMConfig, 2 x 0.25 s; with --codec_ckpt
    the codec branch runs on step 3 (not reached), so both step functions
    are built and the DSP branch runs (steps 1 and 2: noise and smoothing)."""
    from nawc_tpu.cli import train_wm as jcli
    from nawc_tpu_torch.cli import train_wm as tcli

    common = ["--audio_glob", str(wav_dir / "*.wav"), "--steps", "2", "--batch", "2",
              "--seconds", "0.25", "--log_every", "1"]
    jcli.main(common + ["--out", str(tmp_path / "j.msgpack")])
    tcli.main(common + ["--out", str(tmp_path / "t.msgpack"), "--device", "cpu"])
    _assert_logs_close(_log(tmp_path / "t.log.jsonl"), _log(tmp_path / "j.log.jsonl"))
    _assert_checkpoints_close(tmp_path / "t.msgpack", tmp_path / "j.msgpack")


def test_eval_codec_cli_matches_jax(wav_dir, capsys):
    from nawc_tpu.cli import eval_codec as jcli
    from nawc_tpu_torch.cli import eval_codec as tcli

    args = ["--ckpt", "none", "--size", "small", "--audio_glob", str(wav_dir / "*.wav"),
            "--filecount", "2", "--offset", "0", "--seconds", "1.0"]
    jcli.main(args)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    tcli.main(args + ["--device", "cpu"])
    got = capsys.readouterr().out.strip().splitlines()[-1]
    g, w = ast.literal_eval(got), ast.literal_eval(want)
    assert list(g) == list(w)
    assert g["codebook_usage_per_level"] == w["codebook_usage_per_level"]
    # the CLI prints values rounded: equal, or one rounding unit apart
    for k, unit in (("mel_l1", 1e-4), ("si_snr_db", 1e-2), ("lsd", 1e-2), ("stoi", 1e-3),
                    ("recon_rms", 1e-4), ("wav_rms", 1e-4)):
        assert abs(g[k] - w[k]) <= 1.01 * unit, (k, g[k], w[k])
