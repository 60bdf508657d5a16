"""Neural-codec attacks (``nawc_tpu/attacks/codec.py``): the LALM round-trip,
codebook-layer ablation and the quantizer-bypass latent round-trip over a
:class:`~nawc_tpu_torch.codec.CodecState`, and a generic latent-space attack.

The first three peak-normalise the input into the codec's training
loudness, pad to the codec chunk, run the codec, undo the gain and fix the
length.
"""

from __future__ import annotations

import torch

from ..codec.api import CodecState
from ..dsp.resample import resample
from ..utils import profiling
from ..utils.device import resolve_device
from ..utils.padding import fix_length, pad_to_multiple


def _norm_gain(wav: torch.Tensor, target_peak: float = 0.7) -> torch.Tensor:
    """Per-clip gain to the codec's training loudness (peak 0.7)."""
    peak = wav.abs().amax(dim=-1, keepdim=True)
    return target_peak / torch.clamp(peak, min=1e-4)


def _attack(codec: CodecState, wav: torch.Tensor, in_sr: int | None, run) -> torch.Tensor:
    with profiling.annotate("attack.codec", wav.device):
        sr = codec.cfg.sample_rate
        t_in = wav.shape[-1]
        resampled = in_sr is not None and in_sr != sr
        x = resample(wav, in_sr, sr) if resampled else wav
        g = _norm_gain(x)
        x = pad_to_multiple(x * g, codec.cfg.chunk, axis=-1)
        y = run(x) / g
        if resampled:
            y = resample(y, sr, in_sr)
        return fix_length(y, t_in)


def codec_roundtrip(
    codec: CodecState, wav: torch.Tensor, in_sr: int | None = None
) -> torch.Tensor:
    """LALM/tokenizer attack: resample -> encode -> quantize -> decode ->
    resample back -> length fix.  `wav` is (B, T) at `in_sr` (default: the
    codec rate)."""
    return _attack(codec, wav, in_sr, codec.roundtrip)


def layer_ablation(
    codec: CodecState, wav: torch.Tensor, level_mask: torch.Tensor, in_sr: int | None = None
) -> torch.Tensor:
    """Codec round-trip with selected RVQ levels zeroed; `level_mask` is
    (num_levels,) in {0, 1}."""
    return _attack(codec, wav, in_sr,
                   lambda x: codec.decode(codec.encode(x), level_mask=level_mask))


def latent_roundtrip(
    codec: CodecState, wav: torch.Tensor, in_sr: int | None = None
) -> torch.Tensor:
    """Quantizer-bypass round-trip (continuous latents): the mild neural-codec
    resynthesis that plays the reference suite's high-bitrate ``encodec``
    attack, where :func:`codec_roundtrip` plays the destructive ``dac``."""
    return _attack(codec, wav, in_sr, lambda x: codec.decode_latent(codec.encode_latent(x)))


def latent_transform_attack(codec: CodecState, wav: torch.Tensor, fn) -> torch.Tensor:
    """Encode continuously, apply `fn` to the latents, decode; no gain
    normalisation and no resampling."""
    t_in = wav.shape[-1]
    z = codec.encode_latent(pad_to_multiple(wav, codec.cfg.chunk, axis=-1))
    return fix_length(codec.decode_latent(fn(z)), t_in)


def ablation_masks(num_levels: int, device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """The reference's mask families: full_all, drop_last_k (k=1..L-1),
    keep_only_i (i=0..L-1)."""
    device = resolve_device(device)
    masks = {"full_all": torch.ones(num_levels, device=device)}
    for k in range(1, num_levels):
        m = torch.ones(num_levels, device=device)
        m[num_levels - k :] = 0.0
        masks[f"drop_last_{k}"] = m
    for i in range(num_levels):
        m = torch.zeros(num_levels, device=device)
        m[i] = 1.0
        masks[f"keep_only_{i}"] = m
    return masks
