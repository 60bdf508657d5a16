"""The port's flagship entry (``__graft_entry__.py::entry``): watermark
embed -> codec round-trip (the LALM attack) -> detect.

The path runs in float32: each call of the returned ``fn`` turns TF32 off
for cuDNN convolutions and cuBLAS matrix products, which PyTorch would
otherwise use for the codec's convolutions and which would break parity with
the JAX reference, and restores the caller's flags after it.
"""

from __future__ import annotations

import numpy as np
import torch

from .attacks.codec import codec_roundtrip
from .codec.api import CodecState, make_codec
from .models.spread_spectrum import SpreadSpectrumWM
from .utils import profiling
from .utils.config import CodecConfig, SpreadSpectrumConfig
from .utils.device import no_tf32, resolve_device


def flagship(codec: CodecState | None = None, device: str | torch.device = "cuda",
             codec_cfg: CodecConfig | None = None) -> tuple[CodecState, SpreadSpectrumWM]:
    """-> (codec, watermarker) of the flagship graph.  Without `codec`, a
    random-weight codec from seed 0, as the JAX entry builds."""
    if codec is None:
        codec = make_codec(codec_cfg or CodecConfig(), device, seed=0)
    wm = SpreadSpectrumWM(cfg=SpreadSpectrumConfig(
        sample_rate=codec.cfg.sample_rate, band_hi_hz=9000.0, alpha=0.1))
    return codec, wm


def entry(codec: CodecState | None = None, device: str | torch.device = "cuda"):
    """-> (fn, example_args); ``fn(wav, msg) -> (marked, presence, bits)``."""
    dev = resolve_device(device)
    codec, wm = flagship(codec, dev)
    sr = codec.cfg.sample_rate

    @torch.no_grad()
    @no_tf32()
    def fn(wav: torch.Tensor, msg: torch.Tensor):
        with profiling.annotate("entry.call", wav.device):
            marked = wm.embed(wav, msg)
            attacked = codec_roundtrip(codec, marked, in_sr=sr)
            presence, bits = wm.detect(attacked)
        return marked, presence, bits

    # 1-s clips, as the JAX entry's example
    batch, seconds = 2, 1
    wav = np.random.default_rng(0).normal(size=(batch, sr * seconds)).astype(np.float32) * 0.1
    msg = np.random.default_rng(1).integers(0, 2, (batch, wm.n_bits))
    return fn, (torch.from_numpy(wav).to(dev), torch.as_tensor(msg, dtype=torch.int32).to(dev))


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK:", [tuple(o.shape) for o in out])
