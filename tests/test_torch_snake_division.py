"""The Snake kernel's divisions (``nawc_tpu_torch/csrc/snake.cu``), emulated
exactly on the CPU, against numpy's float32 division (IEEE: round to
nearest even, subnormals kept), which is what ``__fdiv_rn`` gives on the
card.  ``chip_smoke.py`` phase 2 runs the same functions on the card over
all 2^32 float32 patterns.

Emulation, one rounding per instruction as the card rounds: a float32
product (``__fmul_rn``) is exact in float64 and rounds once to float32; a
fused multiply-add (``__fmaf_rn``) is ``_torch_port.fma_once``; a float64
product (``__dmul_rn``) is numpy's, and its float32 conversion
(``__double2float_rn``) numpy's ``astype``; RN(1/den) is numpy's float32
division and RD(1/den) is it moved down one ulp where RN(1/den) den > 1
(exact in float64).  The divisors' constants and the domains' bounds are
read from the kernel's source, so the sequences proven here are the ones
the kernel runs."""

import importlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import fma_once, tiny_codecs

SOURCE = (Path(__file__).resolve().parents[1] / "nawc_tpu_torch" / "csrc" / "snake.cu").read_text()
DIVISORS = (6, 20, 42)


def _hexf(text: str) -> np.float32:
    value = np.float32(float.fromhex(text.strip().rstrip("f")))
    assert float(value) == float.fromhex(text.strip().rstrip("f"))  # a float32, exactly
    return value


def _constant(name: str) -> np.float32:
    return _hexf(re.search(rf"constexpr float {name} = ([^;,]+)[;,]", SOURCE).group(1))


RECIP = {int(d): (_hexf(hi), _hexf(lo)) for d, hi, lo in re.findall(
    r"struct Recip<(\d+)> \{ static constexpr float hi = ([^,]+), lo = ([^;]+); \};", SOURCE)}
CONST_LO = _constant("kConstLo")
DEN_LO, DEN_HI = _constant("kDenLo"), _constant("kDenHi")
NUM_LO, NUM_HI = _constant("kNumLo"), _constant("kNumHi")
F32_MAX = np.finfo(np.float32).max


def fmul(a, b) -> np.ndarray:
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)).astype(np.float32)


def binade(k: int | None) -> np.ndarray:
    """The 2^23 float32 values [2^k, 2^(k+1)); k None: +0 and the subnormals."""
    m = np.arange(2**23, dtype=np.uint32)
    return (m if k is None else (np.uint32(k + 127) << np.uint32(23)) | m).view(np.float32)


def differ(got: np.ndarray, want: np.ndarray) -> int:
    """Values whose bits differ; two NaNs agree."""
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    return int((~same).sum())


def true_div(v: np.ndarray, d) -> np.ndarray:
    with np.errstate(all="ignore"):
        return (v / np.float32(d)).astype(np.float32)


# ---------------------------------------------------------------- by 6, 20, 42

def div_const_fast(v: np.ndarray, d: int) -> np.ndarray:
    """``div_const_fast<d>``: fma(v, zh, RN(v zl))."""
    hi, lo = RECIP[d]
    with np.errstate(all="ignore"):
        return fma_once(v, hi, fmul(v, lo))


def div_const_wide(v: np.ndarray, d: int) -> np.ndarray:
    """``div_const_wide<d>``: RN(RN53(v * RN53(1/d)))."""
    with np.errstate(all="ignore"):
        return (v.astype(np.float64) * (1.0 / d)).astype(np.float32)


def div_const(v: np.ndarray, d: int) -> np.ndarray:
    """``div_const<d>``: the fast sequence for 2^-94 <= |v| <= FLT_MAX, the
    float64 product elsewhere."""
    m = np.abs(v)
    return np.where((m >= CONST_LO) & (m <= F32_MAX), div_const_fast(v, d), div_const_wide(v, d))


def test_the_source_holds_the_constants_proven():
    """zh = RN(1/d) and zl = RN(1/d - zh) (of the float64 1/d) for each
    divisor the polynomial divides by."""
    assert sorted(RECIP) == list(DIVISORS)
    for d, (hi, lo) in RECIP.items():
        assert hi == np.float32(1) / np.float32(d)
        assert lo == np.float32(1.0 / d - float(hi))
    assert CONST_LO == np.float32(2.0**-94)


@pytest.mark.parametrize("d", DIVISORS)
def test_constant_division_is_the_ieee_quotient_for_every_float(d):
    """``div_const<d>`` equals v / d for every float32 v.

    Why one binade and the low range cover every input.  Both sequences are
    odd in v (each rounding to nearest is), so v >= 0 suffices; +-0, the
    infinities and NaN are tried below.

    * The fast sequence, fma(v, zh, RN(v zl)), for |v| >= 2^-94: there
      |v zl| >= 2^-94 |zl| > 2^-125.08 (|zl| > 2^-31.08, asserted), so
      v zl, the sum and the quotient are normal floats, and nothing
      overflows below 2^128 (the quotient is smaller than v).  Scaling v by
      2^k then scales every exact value and every rounding result by 2^k,
      and the true quotient's rounding too, so the fast sequence equals
      RN(v / d) on [2^-94, 2^128) iff it does on the binade [1, 2): all of
      its 2^23 mantissas are tried.
    * The float64 product, RN(RN53(v RN53(1/d))), elsewhere: in float64
      every float32 and its product with 1/d are normal, so RN53 scales
      exactly; the final rounding to float32 scales while the result is a
      normal float32, which holds for |v| >= 2^-120 (d <= 42 < 2^6).  So the
      binade [1, 2) covers [2^-120, 2^128), and what is left, [0, 2^-120),
      is tried whole: the subnormals and +0, and the binades 2^-126 to
      2^-121.

    The binades on either side of 2^-94, where the guard hands over, are
    tried through ``div_const`` itself.  And the fast sequence alone is not
    exact below its bound: it differs on subnormal-grid ties, which is why
    the guard is there."""
    hi, lo = RECIP[d]
    assert abs(float(lo)) > 2.0**-31.08 and float(CONST_LO) * abs(float(lo)) >= 2.0**-126
    one = binade(0)
    want = true_div(one, d)
    assert differ(div_const_fast(one, d), want) == 0
    assert differ(div_const_wide(one, d), want) == 0
    for k in [None] + list(range(-126, -120)):  # [0, 2^-120): the float64 product
        v = binade(k)
        assert differ(div_const_wide(v, d), true_div(v, d)) == 0, k
    for k in (-96, -95, -94, -93):  # the guard's hand-over
        v = binade(k)
        assert differ(div_const(v, d), true_div(v, d)) == 0, k
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, F32_MAX, -F32_MAX, 2.0**-149, -(2.0**-149)],
                       np.float32)
    assert differ(div_const(special, d), true_div(special, d)) == 0
    negative = -np.random.default_rng(d).choice(one, 4096) * np.float32(2.0**40)
    assert differ(div_const(negative, d), true_div(negative, d)) == 0
    low = binade(None)
    assert differ(div_const_fast(low, d), true_div(low, d)) > 0  # ties: the guard is needed


# ---------------------------------------------------------------- by a + 1e-9

def den_consts(den: np.ndarray):
    """``den_of``: yd = RD(1/den), yl = RN((1 - den yd) yn), yn = RN(1/den)."""
    with np.errstate(all="ignore"):
        yn = (np.float32(1) / den).astype(np.float32)
        over = yn.astype(np.float64) * den.astype(np.float64) > 1.0
        yd = np.where(over, np.nextafter(yn, np.float32(0)), yn).astype(np.float32)
        yl = fmul(fma_once(-den, yd, np.float32(1)), yn)
    return yd, yl, yn


def div_den_fast(v: np.ndarray, den: np.ndarray, bfloat16: bool = False) -> np.ndarray:
    """``div_den_fast<T>``: q = fma(v, yd, RN(v yl)) (float32) or RN(v yn)
    (bfloat16), then one Markstein step."""
    yd, yl, yn = den_consts(den)
    with np.errstate(all="ignore"):
        q = fmul(v, yn) if bfloat16 else fma_once(v, yd, fmul(v, yl))
        r = fma_once(q, den, -v)
        return fma_once(-r, yn, q)


def den_domain(v: np.ndarray) -> np.ndarray:
    m = np.abs(v)
    return (m < NUM_HI) & ((m >= NUM_LO) | (v == 0))


def div_den(v: np.ndarray, den: np.ndarray, bfloat16: bool = False) -> np.ndarray:
    """``div_den``: the Markstein sequence where den and v are in its
    domain, ``__fdiv_rn`` elsewhere."""
    fast = (den >= DEN_LO) & (den <= DEN_HI) & den_domain(v)
    with np.errstate(all="ignore"):
        return np.where(fast, div_den_fast(v, den, bfloat16), v / den).astype(np.float32)


def kernel_dens() -> np.ndarray:
    """Every den = a + 1e-9 of the tiny codec's Snakes, as the kernel forms
    it from alpha = exp(log_alpha) in float32 and in bfloat16 rounding."""
    _, codec = tiny_codecs(0)
    la = torch.cat([p.detach().flatten() for n, p in codec.model.named_parameters()
                    if n.endswith("log_alpha")])
    dens = []
    for dtype in (torch.float32, torch.bfloat16):
        alpha = torch.exp(la).to(dtype).float()
        dens.append((alpha + torch.tensor(1e-9, dtype=torch.float32)).to(dtype).float())
    return np.unique(torch.cat(dens).numpy())


def numerators(seed: int, n: int) -> np.ndarray:
    """n seeded float32 numerators: random signs and mantissas, exponents
    over the Markstein domain and past both of its ends, and the edges."""
    rng = np.random.default_rng(seed)
    bits = (rng.integers(0, 2, n, dtype=np.uint32) << np.uint32(31)
            | rng.integers(127 - 100, 127 + 100, n, dtype=np.uint32) << np.uint32(23)
            | rng.integers(0, 2**23, n, dtype=np.uint32))
    edges = np.array([0.0, -0.0, NUM_LO, np.nextafter(NUM_LO, np.float32(0)), -NUM_LO, NUM_HI,
                      np.nextafter(NUM_HI, np.float32(0)), 2.0**-149, 2.0**-126, F32_MAX, np.inf,
                      np.nan, 1.0, -1.0], np.float32)
    return np.concatenate([bits.view(np.float32), edges])


def test_channel_division_is_the_ieee_quotient_on_the_codec_dens():
    """``div_den`` equals v / den for seeded numerators at every den of the
    tiny codec (float32 and bfloat16 rounding); the Markstein sequence
    alone equals it wherever the guard lets it run, and differs outside
    that domain (subnormal numerators), which is why the guard is there.
    Markstein's theorem is the proof for the domain; this and the card's
    check over all 2^32 numerators for the trained codec's dens hold the
    code to it."""
    dens = kernel_dens()
    assert dens.size > 1000 and ((dens >= DEN_LO) & (dens <= DEN_HI)).all()
    nums = numerators(7, 2**11)
    v = np.repeat(nums[None, :], dens.size, axis=0).ravel()
    den = np.repeat(dens, nums.size)
    want = true_div(v, den)
    assert differ(div_den(v, den), want) == 0
    inside = den_domain(v)
    assert inside.mean() > 0.7
    assert differ(div_den_fast(v[inside], den[inside]), want[inside]) == 0
    sub = binade(None)[1:]
    mid = np.full(sub.size, np.median(dens), np.float32)
    assert differ(div_den_fast(sub, mid), true_div(sub, mid)) > 0
    assert differ(div_den(sub, mid), true_div(sub, mid)) == 0


def test_division_checks_and_timing_tool_need_a_card():
    """The card's division checks refuse a CPU device or CPU tensors, and
    the Snake timing tool exits 1 without a card and prints no result."""
    so = importlib.import_module("nawc_tpu_torch.ops.snake")
    with pytest.raises(ValueError):
        so.check_constant_division(6, "cpu")
    with pytest.raises(ValueError):
        so.check_channel_division(torch.ones(2))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "-m", "nawc_tpu_torch.tools.snake_times"],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 1 and "no CUDA device" in proc.stderr and not proc.stdout


def test_bfloat16_channel_division_is_the_ieee_quotient_for_every_bfloat16_pair():
    """The bfloat16 kernels' sequence, RN(v yn) and one Markstein step,
    equals v / den for every bfloat16 v in its domain (+-0 and 2^-80 <= |v|
    < 2^80) and every bfloat16 den in [2^-20, 2^20]; outside the domain
    (subnormal quotients' ties, overflow) it may differ, and ``div_den``
    takes ``__fdiv_rn`` there.

    Why the dens of [1, 2) cover all of [2^-20, 2^20]: dividing by 2^k den
    gives yn 2^-k, RN(v yn 2^-k) = 2^-k RN(v yn), the very same residual r
    (q 2^-k times den 2^k), and 2^-k times the corrected quotient, every
    one a normal float for quotients in [2^-101, 2^101); the true quotient
    scales alike.  So each den of [1, 2) is tried against every bfloat16 v
    of the domain, 128 x 40,962 pairs."""
    every = (np.arange(2**16, dtype=np.uint32) << np.uint32(16)).view(np.float32)
    nums = every[den_domain(every) & np.isfinite(every)]
    dens = every[(every >= 1) & (every < 2)]
    assert nums.size == 2 * 160 * 128 + 2 and dens.size == 128
    v = np.tile(nums, dens.size)
    den = np.repeat(dens, nums.size)
    assert differ(div_den_fast(v, den, bfloat16=True), true_div(v, den)) == 0
    assert differ(div_den(v, den, bfloat16=True), true_div(v, den)) == 0
    tiny = every[(np.abs(every) < NUM_LO) & (every != 0)]
    v, den = np.tile(tiny, dens.size), np.repeat(dens, tiny.size)
    assert differ(div_den_fast(v, den, bfloat16=True), true_div(v, den)) > 0  # the guard is needed
