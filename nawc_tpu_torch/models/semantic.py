"""Semantic manifold watermarks (``nawc_tpu/models/semantic.py``): embed by
gradient-optimising a waveform perturbation so that the codec encoder's
latents, projected on a 1-D "manifold axis" of the level-0 codebook, follow
a secret +-1 PN sequence over frames; detect by the self-calibrated
correlation z of the high-passed projection track with that sequence.

The axes: PCA (first right singular vector of the centred codebook, a
float64 numpy SVD on the host, as in JAX), k-means (the unit vector between
two Lloyd centroids, 10 iterations, seed 42) and random (a seed-42 normal
vector).  The JAX module's docstring gives the reasons for the PN design.

The embed is Adam on the delta (``torch.optim.Adam``: optax's formula, eps
outside the square root, both bias corrections), silence-masked, inside an
L2 ball of the target-SDR energy and a peak cap, with a gradient-free
spectral projection after each of ``n_proj_phases`` phases.  It opens
``torch.enable_grad()`` itself, so that it works under a ``no_grad``
caller, as the pure JAX function works under any caller; the graph holds
only the delta (the codec's weights are frozen).  JAX splits each phase
into dispatches of ``max_steps_per_dispatch`` steps, a TPU crash
workaround that changes no value; the port runs each phase as one loop.

These watermarks carry no bits: ``msg`` is ignored, the bits are (B, 0).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..codec.api import CodecState
from ..dsp.stft import istft, stft
from ..utils import jaxrand, profiling
from ..utils.config import SemanticWMConfig, StftConfig
from ..utils.padding import pad_to_multiple
from .base import register

# ---------------------------------------------------------------- axes


def pca_axis(codebook: torch.Tensor) -> torch.Tensor:
    """First right singular vector of the mean-centred codebook, by numpy's
    float64 SVD as in JAX (so that its sign is JAX's)."""
    cb = codebook.detach().cpu().numpy().astype(np.float64)
    _, _, vh = np.linalg.svd(cb - cb.mean(axis=0, keepdims=True), full_matrices=False)
    return profiling.to_device(vh[0].astype(np.float32), codebook.device)


def kmeans_axis(codebook: torch.Tensor, iters: int = 10, seed: int = 42) -> torch.Tensor:
    """Unit vector between two k-means centroids of the codebook: starts
    from ``jax.random.choice(PRNGKey(seed), N, (2,), replace=False)``, then
    `iters` Lloyd iterations (ties to the first centroid)."""
    cb = codebook.detach()
    idx = jaxrand.choice(jaxrand.prng_key(seed), cb.shape[0], (2,))
    cents = cb[profiling.to_device(idx, cb.device).long()]
    for _ in range(iters):
        assign = ((cb[:, None, :] - cents[None, :, :]) ** 2).sum(dim=-1).argmin(dim=-1)
        means = []
        for c in range(2):
            m = (assign == c).to(cb.dtype)[:, None]
            means.append((cb * m).sum(dim=0) / torch.clamp(m.sum(), min=1.0))
        cents = torch.stack(means)
    v = cents[1] - cents[0]
    return v / (torch.linalg.vector_norm(v) + 1e-9)


def random_axis(dim: int, seed: int = 42, device: str | torch.device = "cuda") -> torch.Tensor:
    """The unit vector of ``jax.random.normal(PRNGKey(seed), (dim,))``."""
    v = profiling.to_device(jaxrand.normal(jaxrand.prng_key(seed), (dim,)), device)
    return v / (torch.linalg.vector_norm(v) + 1e-9)


# ---------------------------------------------------------------- core


def _pn(n_frames: int, seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """Per-frame +-1 PN sequence of ``jax.random.bernoulli``; threefry bits
    are counter-based, so shorter sequences are prefixes of longer ones."""
    bits = jaxrand.bernoulli(jaxrand.prng_key(seed), 0.5, (n_frames,))
    return profiling.to_device(2.0 * bits.astype(np.float32) - 1.0, device)


def _residual(proj: torch.Tensor, window: int) -> torch.Tensor:
    """(B, T) -> (B, T): the track minus its centred moving average over
    `window` frames, edge-padded."""
    pad = window // 2
    padded = F.pad(proj[:, None, :], (pad, pad), mode="replicate")[:, 0]
    t = proj.shape[1]
    ma = torch.stack([padded[:, i : i + t] for i in range(window)], dim=0).mean(dim=0)
    return proj - ma


def _zstat(proj: torch.Tensor, s: torch.Tensor, window: int) -> torch.Tensor:
    """Self-calibrated correlation z = mean(s r) / (std(r) / sqrt(T)), with
    the population std (``jnp.std``)."""
    r = _residual(proj, window)
    c = (r * s[None, :]).mean(dim=-1)
    sigma = r.std(dim=-1, correction=0) / np.float32(np.sqrt(r.shape[-1])) + 1e-9
    return c / sigma


def _axis_stats(codebook: torch.Tensor, axis: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean and population std (+ 1e-6) of the codebook's projections on
    `axis`: the unit of the standardised projections."""
    proj = codebook @ axis
    return proj.mean(), proj.std(correction=0) + 1e-6


def _projections(codec: CodecState, wav: torch.Tensor, axis: torch.Tensor,
                 standardize: bool = True) -> torch.Tensor:
    """(B, T) -> (B, T') per-frame projections of the level-0 in_proj of
    the encoder latents on `axis`, in codebook sigmas by default."""
    proj = codec.project_latent(codec.encode_latent(wav)) @ axis
    if standardize:
        mu, sd = _axis_stats(codec.projected_codebook, axis)
        proj = (proj - mu) / sd
    return proj


SHAPE_STFT = StftConfig(1024, 256, 1024)


def _loss(codec: CodecState, scfg: SemanticWMConfig, axis: torch.Tensor, s: torch.Tensor,
          x: torch.Tensor, mask: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """The embed's loss: minus the summed z of the perturbed clips against
    the PN sequence `s`, / 10."""
    proj = _projections(codec, x + delta * mask, axis)
    return -_zstat(proj, s, scfg.ma_window).sum() / 10.0


def _spectral_projection(delta: torch.Tensor, mask: torch.Tensor, x_mag: torch.Tensor,
                         scfg: SemanticWMConfig, sample_rate: int) -> torch.Tensor:
    """Cap |STFT(delta)| at c |STFT(clean)| per bin (c from
    ``proj_headroom_db``, tighter below ``proj_stoi_hz`` by
    ``proj_stoi_extra_db``, bins from ``proj_free_above_hz`` up exempt)."""
    d_spec = stft(delta * mask, SHAPE_STFT)
    d_mag = d_spec.abs() + 1e-12
    n_bins = d_spec.shape[-1]
    freqs = torch.linspace(0.0, sample_rate / 2.0, n_bins, device=delta.device)
    c = torch.full((n_bins,), 10.0 ** (-scfg.proj_headroom_db / 20.0), device=delta.device)
    if scfg.proj_stoi_extra_db > 0.0:
        c_lo = 10.0 ** (-(scfg.proj_headroom_db + scfg.proj_stoi_extra_db) / 20.0)
        c = torch.where(freqs < scfg.proj_stoi_hz, torch.full_like(c, c_lo), c)
    scale = torch.clamp(c * x_mag / d_mag, max=1.0)
    if scfg.proj_free_above_hz > 0.0:
        scale = torch.maximum(scale, (freqs >= scfg.proj_free_above_hz).to(scale.dtype))
    return istft(d_spec * scale, SHAPE_STFT, length=delta.shape[-1])


def semantic_embed(codec: CodecState, scfg: SemanticWMConfig, axis: torch.Tensor,
                   wav: torch.Tensor) -> torch.Tensor:
    """Batched Adam-PGD embed maximising the PN-correlation z under the
    SDR-derived budget; (B, T) -> (B, T).  Spans per step:
    ``semantic.loss``, ``semantic.backward`` and ``semantic.adam``
    (gradient mask, Adam, budget)."""
    x = pad_to_multiple(wav.detach(), codec.cfg.chunk, axis=-1)
    rms = torch.sqrt((x * x).mean(dim=-1, keepdim=True))
    amp = rms * 10.0 ** (-scfg.target_sdr_db / 20.0)  # (B, 1)
    if scfg.dynamic_eps:
        r2 = amp * np.float32(np.sqrt(x.shape[-1]))
        cap = scfg.cap_mult * amp
        mask = (x.abs() > amp).to(x.dtype)
    else:
        r2 = None
        cap = torch.full_like(amp, scfg.eps)
        mask = (x.abs() > scfg.silence_threshold).to(x.dtype)

    def clip_budget(d: torch.Tensor) -> torch.Tensor:
        if r2 is not None:
            norm = torch.sqrt((d * d).sum(dim=-1, keepdim=True)) + 1e-12
            d = d * torch.clamp(r2 / norm, max=1.0)
        return torch.clamp(d, -cap, cap)

    shaping = scfg.lsd_weight > 0.0
    x_mag = stft(x, SHAPE_STFT).abs() if shaping else None
    # the PN sequence goes to the device once: a copy from pageable host
    # memory in every step would wait for the step before it
    s = _pn(x.shape[-1] // codec.cfg.hop, scfg.pn_seed, x.device)
    delta = torch.zeros_like(x, requires_grad=True)
    opt = torch.optim.Adam([delta], lr=scfg.lr)

    dev = x.device
    n_phases = min(max(1, scfg.n_proj_phases) if shaping else 1, max(1, scfg.steps))
    base, rem = divmod(scfg.steps, n_phases)
    with torch.enable_grad():
        for p in range(n_phases):
            # the remainder of steps / n_phases goes to the first phases
            n = base + (1 if p < rem else 0)
            if n == 0:  # steps == 0: JAX dispatches nothing, not even the projection
                continue
            for _ in range(n):
                with profiling.annotate("semantic.loss", dev):
                    loss = _loss(codec, scfg, axis, s, x, mask, delta)
                with profiling.annotate("semantic.backward", dev):
                    loss.backward()
                with profiling.annotate("semantic.adam", dev):
                    delta.grad.mul_(mask)
                    opt.step()
                    opt.zero_grad()
                    with torch.no_grad():
                        delta.copy_(clip_budget(delta))
            if shaping:
                with torch.no_grad():
                    delta.copy_(clip_budget(_spectral_projection(
                        delta, mask, x_mag, scfg, codec.cfg.sample_rate)))
    out = x + delta.detach() * mask
    return out[..., : wav.shape[-1]]


def semantic_score(codec: CodecState, scfg: SemanticWMConfig, axis: torch.Tensor,
                   wav: torch.Tensor) -> torch.Tensor:
    """score_scale * z of the PN correlation; (B, T) -> (B,)."""
    proj = _projections(codec, pad_to_multiple(wav, codec.cfg.chunk, axis=-1), axis)
    s = _pn(proj.shape[-1], scfg.pn_seed, proj.device)
    return scfg.score_scale * _zstat(proj, s, scfg.ma_window)


# ---------------------------------------------------------------- wrapper

_AXIS_BUILDERS = {
    "pca": pca_axis,
    "kmeans": kmeans_axis,
    "random": lambda cb: random_axis(cb.shape[1], device=cb.device),
}


def _op_cfg(pn_seed: int) -> SemanticWMConfig:
    """The JAX package's operating point: 300 steps, target SDR 31 dB, the
    spectral projection at 4 phase ends with the band above 8 kHz exempt."""
    return SemanticWMConfig(
        steps=300, dynamic_eps=True, target_sdr_db=31.0, pn_seed=pn_seed,
        lsd_weight=1.0, proj_headroom_db=0.0, n_proj_phases=4,
        proj_free_above_hz=8000.0,
    )


_DEFAULT_CFGS = {"pca": _op_cfg(701), "kmeans": _op_cfg(702), "random": _op_cfg(703)}

_NAMES = {"pca": "SemanticPCA", "kmeans": "SemanticCluster", "random": "SemanticRandom"}


@dataclasses.dataclass(frozen=True)
class SemanticWM:
    """Presence-only manifold watermark over a codec.  n_bits = 0."""

    codec: CodecState
    axis_kind: str = "pca"
    cfg: SemanticWMConfig | None = None
    n_bits: int = 0

    def __post_init__(self):
        if self.axis_kind not in _AXIS_BUILDERS:
            raise ValueError(f"axis_kind must be one of {sorted(_AXIS_BUILDERS)}")

    @property
    def name(self) -> str:
        return _NAMES[self.axis_kind]

    @property
    def sample_rate(self) -> int:
        return self.codec.cfg.sample_rate

    @property
    def scfg(self) -> SemanticWMConfig:
        return self.cfg or _DEFAULT_CFGS[self.axis_kind]

    @property
    def axis(self) -> torch.Tensor:
        return _AXIS_BUILDERS[self.axis_kind](self.codec.projected_codebook)

    def embed(self, wav: torch.Tensor, msg=None, key=None) -> torch.Tensor:
        return semantic_embed(self.codec, self.scfg, self.axis, wav)

    def projections(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T') standardised per-frame projections."""
        x = pad_to_multiple(wav, self.codec.cfg.chunk, axis=-1)
        return _projections(self.codec, x, self.axis)

    def score(self, wav: torch.Tensor, msg=None) -> torch.Tensor:
        return semantic_score(self.codec, self.scfg, self.axis, wav)

    def detect(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        presence = torch.sigmoid(4.0 * (self.score(wav) - self.scfg.detect_threshold))
        return presence, torch.zeros((wav.shape[0], 0), dtype=torch.int32, device=wav.device)


@register("semantic_pca")
def _build_pca(codec: CodecState) -> SemanticWM:
    return SemanticWM(codec, "pca")


@register("semantic_cluster")
def _build_cluster(codec: CodecState) -> SemanticWM:
    return SemanticWM(codec, "kmeans")


@register("semantic_random")
def _build_random(codec: CodecState) -> SemanticWM:
    return SemanticWM(codec, "random")
