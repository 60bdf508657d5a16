"""Mimi (kyutai/mimi, the speech tokenizer of Moshi and Sesame's CSM) in the
port's (B, C, T) layout: ``CodecConfig(layout="mimi")``, built by
``CodecConfig.mimi()``.  No JAX counterpart; the equations are the
``moshi`` package's (``models/loaders.py``, ``modules/seanet.py``,
``conv.py``, ``resample.py``, ``transformer.py``, ``quantization/vq.py``):

* a causal SEANet: every conv pads d (k - 1) - (s - 1) zeros on the left
  (and the frames' remainder on the right, none at a multiple of the hop),
  ELU (alpha 1) before each conv but the first, residual blocks
  x + Conv_k1(ELU(Conv_k3(ELU(x)))) with a C/2 bottleneck and an identity
  skip; transposed convs (k = 2 s) trim their last k - s samples;
* after the encoder and before the decoder a transformer of pre-norm
  layers: x + g1 Attn(LN1(x)), then x + g2 W2 GELU(W1 LN2(x)) (LayerScale
  g, no biases, no final norm); attention of heads of latent_dim / heads
  with RoPE at the clip's frame positions (``rotary_tables``/``rotate_half``,
  as ``LocalMHA``'s), over keys 0 <= t_q - t_k < ``tfm_context``;
* a learnt resampler: a strided conv (k 2 s, no bias, replicate padding)
  down, a channel-wise transposed conv (k 2 s, groups = channels, no bias)
  up;
* a split RVQ: the semantic levels and the acoustic levels each project
  the same latent (k1, no bias), pick each level's code at the least
  Euclidean distance (``ops.rvq.nearest_euclidean``) and subtract it; the
  quantized latent is the sum of the two output projections.

Precision follows the bfloat16 codec: convs, ELU, LayerScale and the
transformer's products in ``cfg.compute_dtype``; LayerNorm statistics,
RoPE products and softmax in float32; the RVQ and the decoder's last conv
in float32.  In bfloat16 the stride-1 k3/k7 convs take
``csrc/same_conv.cu``'s stencil at their causal padding, the residual k1
convs its GEMM path, and the last conv ``csrc/outconv.cu``, which reads the
bfloat16 activation in place (``ops/conv.py``).

Departures, none of which changes a shape: weight norm and the codebooks'
EMA buffers are folded into plain weights; RoPE rotates halves
(``transformers``' form) where moshi rotates interleaved pairs, a fixed
permutation of the q and k rows.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv import conv1d, conv_native
from ..ops.rvq import nearest_euclidean
from ..utils import profiling
from ..utils.config import CodecConfig
from .layers import SameConv1d, rotary_tables, rotate_half


class CausalConv1d(SameConv1d):
    """moshi's ``StreamingConv1d`` in causal mode: d (k - 1) - (s - 1) zeros
    on the left and the frames' remainder, -T mod s, on the right; with
    `replicate`, the edge samples in place of the zeros (the downsampler)."""

    def __init__(self, *args, replicate: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.replicate = replicate

    def pads(self, t: int) -> tuple[int, int]:
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        return d * (k - 1) - (s - 1), -t % s

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        if self.replicate:
            x = F.pad(x, self.pads(x.shape[-1]), mode="replicate")
            return conv1d(x, self.weight, self.bias, self.stride[0], 0, self.dilation[0], self.groups, residual)
        return super().forward(x, residual)


class CausalConvTranspose1d(nn.ConvTranspose1d):
    """moshi's ``StreamingConvTranspose1d`` in causal mode (k = 2 s): the full
    transposed output, its last k - s samples trimmed, so that T frames give
    T s samples."""

    def __init__(self, in_ch: int, out_ch: int, stride: int, groups: int = 1, bias: bool = True):
        super().__init__(in_ch, out_ch, 2 * stride, stride=stride, groups=groups, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_native(F.conv_transpose1d, x, self.weight, self.bias, self.stride, 0, 0, self.groups)
        return y[..., : x.shape[-1] * self.stride[0]].contiguous()


class ResBlock(nn.Module):
    """SEANet's residual block: x + Conv_1(ELU(Conv_0(ELU(x)))), Conv_0 k3
    to C/2 channels, Conv_1 k1 back to C with the skip added in the conv."""

    def __init__(self, dim: int, kernel: int = 3, compress: int = 2):
        super().__init__()
        self.Conv_0 = CausalConv1d(dim, dim // compress, kernel)
        self.Conv_1 = CausalConv1d(dim // compress, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(F.elu(self.Conv_0(F.elu(x))), residual=x)


class EncoderBlock(nn.Module):
    """ResBlock(C), ELU, Conv(C -> 2C, k 2 s, stride s)."""

    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.Res = ResBlock(dim)
        self.Conv_0 = CausalConv1d(dim, 2 * dim, 2 * stride, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_0(F.elu(self.Res(x)))


class DecoderBlock(nn.Module):
    """ELU, ConvTranspose(C -> C/2, k 2 s, stride s), ResBlock(C/2)."""

    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.ConvTranspose_0 = CausalConvTranspose1d(dim, dim // 2, stride)
        self.Res = ResBlock(dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Res(self.ConvTranspose_0(F.elu(x)))


class SeanetEncoder(nn.Module):
    """Conv_k7(1 -> C), four EncoderBlocks, ELU, Conv_k3(16 C -> latent):
    (B, 1, T) -> (B, latent_dim, T / hop)."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        dim = cfg.encoder_dim
        self.Conv_0 = CausalConv1d(1, dim, 7)
        for i, rate in enumerate(cfg.encoder_rates):
            self.add_module(f"Block_{i}", EncoderBlock(dim, rate))
            dim *= 2
        self.Conv_1 = CausalConv1d(dim, cfg.latent_dim, 3)
        self.n_blocks = len(cfg.encoder_rates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        for i in range(self.n_blocks):
            h = getattr(self, f"Block_{i}")(h)
        return self.Conv_1(F.elu(h))


class SeanetDecoder(nn.Module):
    """Conv_k7(latent -> 16 C), four DecoderBlocks, ELU, Conv_k3(C -> 1) in
    float32 (no tanh): (B, latent_dim, T') -> (B, T' hop) float32."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        dim = cfg.decoder_dim
        self.Conv_0 = CausalConv1d(cfg.latent_dim, dim, 7)
        for i, rate in enumerate(cfg.decoder_rates):
            self.add_module(f"Block_{i}", DecoderBlock(dim, rate))
            dim //= 2
        self.Conv_1 = CausalConv1d(dim, 1, 3, widen=True)
        self.n_blocks = len(cfg.decoder_rates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.Conv_0(x)
        for i in range(self.n_blocks):
            h = getattr(self, f"Block_{i}")(h)
        return self.Conv_1(F.elu(h))[:, 0]


def window_mask(t: int, context: int, device) -> torch.Tensor:
    """(T, T) True where key t_k lies in query t_q's causal window:
    0 <= t_q - t_k < `context`."""
    delta = torch.arange(t, device=device)[:, None] - torch.arange(t, device=device)[None, :]
    return (delta >= 0) & (delta < context)


class SelfAttention(nn.Module):
    """x + g Attn(LN(x)) on (B, T, C), in a span ``codec.attention``: q, k, v
    by one projection without bias, RoPE on q and k in float32, softmax
    attention (scale dim_head^-1/2) with the additive `bias` of the causal
    window, an output projection without bias, the LayerScale g, the
    residual.  Counts ``attn.pairs``: the query-key pairs the attention
    launch scores, a head and clip each: all T x T of them, since the dense
    SDPA scores the whole square and the bias sets those outside the window
    to -inf."""

    def __init__(self, dim: int, heads: int, context: int, dtype: torch.dtype):
        super().__init__()
        self.heads, self.context = heads, context
        self.norm = nn.LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.in_proj = nn.Linear(dim, 3 * dim, bias=False, dtype=dtype)
        self.out_proj = nn.Linear(dim, dim, bias=False, dtype=dtype)
        self.scale = nn.Parameter(torch.full((dim,), 0.01, dtype=dtype))

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("codec.attention", x.device):
            b, t, c = x.shape
            h, dt = self.heads, x.dtype
            y = F.layer_norm(x, (c,), self.norm.weight, self.norm.bias, self.norm.eps)
            qkv = F.linear(y, self.in_proj.weight).view(b, t, 3, h, c // h).permute(2, 0, 3, 1, 4)
            qk = (qkv[:2].float() * cos + rotate_half(qkv[:2]).float() * sin).to(dt)
            o = F.scaled_dot_product_attention(qk[0], qk[1], qkv[2], attn_mask=bias)
            o = F.linear(o.transpose(1, 2).reshape(b, t, c), self.out_proj.weight)
            profiling.count("attn.pairs", b * h * t * t)
            return x + self.scale * o


class FeedForward(nn.Module):
    """x + g W2 GELU(W1 LN(x)) on (B, T, C), both projections without bias."""

    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, dtype=dtype)
        self.fc1 = nn.Linear(dim, hidden, bias=False, dtype=dtype)
        self.fc2 = nn.Linear(hidden, dim, bias=False, dtype=dtype)
        self.scale = nn.Parameter(torch.full((dim,), 0.01, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x, (x.shape[-1],), self.norm.weight, self.norm.bias, self.norm.eps)
        return x + self.scale * F.linear(F.gelu(F.linear(y, self.fc1.weight)), self.fc2.weight)


class TransformerLayer(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int, context: int, dtype: torch.dtype):
        super().__init__()
        self.attn = SelfAttention(dim, heads, context, dtype)
        self.mlp = FeedForward(dim, hidden, dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        return self.mlp(self.attn(x, cos, sin, bias))


class Transformer(nn.Module):
    """``cfg.tfm_layers`` layers on (B, C, T) -> (B, C, T), in a span
    ``codec.transformer``; RoPE at frame positions 0 .. T - 1.  The weights
    are held in the compute type (LayerNorm's statistics still float32):
    the layers launch no casts."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        dt = cfg.compute_torch_dtype
        self.layers = nn.ModuleList(TransformerLayer(cfg.latent_dim, cfg.tfm_heads, cfg.tfm_ffn, cfg.tfm_context, dt)
                                    for _ in range(cfg.tfm_layers))
        self.dim_head, self.context = cfg.latent_dim // cfg.tfm_heads, cfg.tfm_context

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("codec.transformer", x.device):
            t, dev = x.shape[-1], x.device
            cos, sin = rotary_tables(torch.arange(t, device=dev), self.dim_head)
            bias = torch.zeros(t, t, dtype=x.dtype, device=dev).masked_fill_(
                ~window_mask(t, self.context, dev), float("-inf"))
            h = x.transpose(1, 2).contiguous()
            for layer in self.layers:
                h = layer(h, cos, sin, bias)
            return h.transpose(1, 2)


class Encoder(nn.Module):
    """(B, T) waveform -> (B, T / (hop s), latent_dim) float32 latents: the
    SEANet, the transformer, the downsampler, in a span ``codec.encode``."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        d, s = cfg.latent_dim, cfg.resample_stride
        self.seanet = SeanetEncoder(cfg)
        self.transformer = Transformer(cfg)
        self.downsample = CausalConv1d(d, d, 2 * s, stride=s, bias=False, replicate=True)
        self.dtype = cfg.compute_torch_dtype

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("codec.encode", wav.device):
            h = self.transformer(self.seanet(wav[:, None, :].to(self.dtype)))
            return self.downsample(h).transpose(1, 2).float()


class Decoder(nn.Module):
    """(B, T', latent_dim) -> (B, T' s hop) float32 waveform: the upsampler,
    the transformer, the SEANet, in a span ``codec.decode``."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        d = cfg.latent_dim
        self.upsample = CausalConvTranspose1d(d, d, cfg.resample_stride, groups=d, bias=False)
        self.transformer = Transformer(cfg)
        self.seanet = SeanetDecoder(cfg)
        self.dtype = cfg.compute_torch_dtype

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("codec.decode", z.device):
            return self.seanet(self.transformer(self.upsample(z.transpose(1, 2).to(self.dtype))))


class Level(nn.Module):
    def __init__(self, size: int, dim: int):
        super().__init__()
        self.codebook = nn.Parameter(torch.zeros(size, dim))


class EuclideanRVQ(nn.Module):
    """One of the split RVQ's quantizers: in_proj (latent -> codebook_dim),
    levels of Euclidean codes, out_proj back, in float32."""

    def __init__(self, cfg: CodecConfig, n_levels: int):
        super().__init__()
        self.in_proj = nn.Linear(cfg.latent_dim, cfg.codebook_dim, bias=False)
        self.out_proj = nn.Linear(cfg.codebook_dim, cfg.latent_dim, bias=False)
        self.levels = nn.ModuleList(Level(cfg.codebook_size, cfg.codebook_dim) for _ in range(n_levels))

    def quantize(self, z: torch.Tensor, n: int) -> tuple[torch.Tensor, list[torch.Tensor], torch.Tensor]:
        """z (B, T', D) -> (the sum of the first `n` levels' codewords, their
        codes, the mean squared residual left after them)."""
        residual = F.linear(z.float(), self.in_proj.weight)
        total, codes = torch.zeros_like(residual), []
        for level in self.levels[:n]:
            c = nearest_euclidean(residual, level.codebook)
            q = level.codebook[c.long()]
            residual, total = residual - q, total + q
            codes.append(c)
        return total, codes, residual.pow(2).mean()

    def from_codes(self, codes: Sequence[torch.Tensor], mask: Sequence | None = None) -> torch.Tensor:
        total = None
        for i, c in enumerate(codes):
            q = self.levels[i].codebook[c.long()]
            q = q if mask is None else q * mask[i]
            total = q if total is None else total + q
        return F.linear(total, self.out_proj.weight)


class SplitRVQ(nn.Module):
    """The semantic and the acoustic quantizer, both fed the latent: codes
    [semantic levels..., acoustic levels...], ``cfg.num_levels`` in all."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.n_semantic, self.n_q = cfg.semantic_levels, cfg.num_levels
        self.semantic = EuclideanRVQ(cfg, cfg.semantic_levels)
        self.acoustic = EuclideanRVQ(cfg, len(cfg.vq_strides) - cfg.semantic_levels)

    def forward(self, z: torch.Tensor):
        """z (B, T', D) -> (z_q, codes, commitment loss, codebook loss: 0, the
        codebooks following EMA updates, not a loss)."""
        with profiling.annotate("codec.quantize", z.device):
            sem, c_sem, l_sem = self.semantic.quantize(z, self.n_semantic)
            aco, c_aco, l_aco = self.acoustic.quantize(z, self.n_q - self.n_semantic)
            z_q = F.linear(sem, self.semantic.out_proj.weight) + F.linear(aco, self.acoustic.out_proj.weight)
            return z_q, c_sem + c_aco, l_sem + l_aco, z_q.new_zeros(())

    def encode(self, z: torch.Tensor) -> list[torch.Tensor]:
        return self(z)[1]

    def from_codes(self, codes: Sequence[torch.Tensor], level_mask: torch.Tensor | None = None) -> torch.Tensor:
        """codes -> z_q; `level_mask` (n_q,) zeroes levels (ablation)."""
        with profiling.annotate("codec.quantize", codes[0].device):
            n = self.n_semantic
            mask = (None, None) if level_mask is None else (level_mask[:n], level_mask[n:])
            return (self.semantic.from_codes(codes[:n], mask[0])
                    + self.acoustic.from_codes(codes[n:], mask[1]))


class MimiCodec(nn.Module):
    """Full codec, with ``SnacCodec``'s methods."""

    def __init__(self, cfg: CodecConfig):
        super().__init__()
        if cfg.layout != "mimi":
            raise ValueError(f"MimiCodec: layout {cfg.layout!r} is not 'mimi'")
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quantizer = SplitRVQ(cfg)
        self.decoder = Decoder(cfg)

    def seed_noise(self, seed: int) -> None:
        """Nothing: Mimi's decoder draws no noise."""

    def forward(self, wav: torch.Tensor) -> dict:
        z = self.encoder(wav)
        z_q, codes, commit, cb_loss = self.quantizer(z)
        return {"recon": self.decoder(z_q), "codes": codes, "latent": z, "commit_loss": commit,
                "codebook_loss": cb_loss}

    def encode_latent(self, wav: torch.Tensor) -> torch.Tensor:
        return self.encoder(wav)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def encode(self, wav: torch.Tensor) -> list[torch.Tensor]:
        return self.quantizer.encode(self.encoder(wav))

    def decode(self, codes: Sequence[torch.Tensor], level_mask: torch.Tensor | None = None) -> torch.Tensor:
        return self.decoder(self.quantizer.from_codes(codes, level_mask))

    def roundtrip(self, wav: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.quantizer(self.encoder(wav))[0])

    @property
    def projected_codebook(self) -> torch.Tensor:
        raise NotImplementedError("MimiCodec: the codec-latent (semantic) watermarks do not run on "
                                  "Mimi's split Euclidean RVQ")

    def project_latent(self, z: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("MimiCodec: the codec-latent (semantic) watermarks do not run on "
                                  "Mimi's split Euclidean RVQ")


def fan_in(module: nn.Module, weight: torch.Tensor) -> int:
    """The inputs one output of `module` sums: C_in / groups x k for a conv,
    C_in / groups x k / s for a transposed conv, C_in for a linear layer."""
    if isinstance(module, nn.ConvTranspose1d):
        return weight.shape[0] // module.groups * weight.shape[2] // module.stride[0]
    return weight[0].numel()


def init_weights(model: MimiCodec, seed: int) -> dict[str, torch.Tensor]:
    """Seeded weights for `model` (any device, the meta device too), drawn
    on the CPU: LeCun normal conv and linear weights (std 1 / sqrt(fan-in)),
    zero biases, LayerNorms at 1 and 0, LayerScales at their 0.01 init, and
    fan-in normal codebooks (std 1 / sqrt(codebook_size)), as the port's
    other codecs draw theirs."""
    gen = torch.Generator().manual_seed(int(seed) % 2**63)
    out = {}
    for name, p in model.named_parameters():
        mod = model.get_submodule(name.rpartition(".")[0])
        shape = tuple(p.shape)
        if isinstance(mod, nn.LayerNorm):
            out[name] = torch.full(shape, 1.0 if name.endswith("weight") else 0.0)
        elif name.endswith(".scale"):
            out[name] = torch.full(shape, 0.01)
        elif name.endswith(".bias"):
            out[name] = torch.zeros(shape)
        elif name.endswith("codebook"):
            out[name] = torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        else:
            w = torch.randn(shape, generator=gen)
            out[name] = w / math.sqrt(fan_in(mod, w))
    return out


def make_model(cfg: CodecConfig, seed: int = 0) -> MimiCodec:
    """A :class:`MimiCodec` on the CPU with :func:`init_weights`' draws."""
    with torch.device("meta"):
        model = MimiCodec(cfg)
    weights = init_weights(model, seed)
    model = model.to_empty(device="cpu")
    model.load_state_dict(weights, strict=True)
    return model
