// The Snake activation of the codec and the neural watermark, forward and
// backward, float32 and bfloat16, over a contiguous (B, C, T) tensor:
//     y = x + S(a x) / (a + 1e-9),   S(z) = s(p)^2,
//     u = z * (1/pi),  u -= rint(u),  p = u * pi,  p2 = p * p,
//     s = p * (1 - p2/6 * (1 - p2/20 * (1 - p2/42)))
// with a = exp(log_alpha) per channel (computed by the caller, in the
// caller's rounding), as nawc_tpu_torch/ops/snake.py::snake_reference.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses Snake.__call__
// (nawc_tpu/codec/layers.py:42) with _sin2_periodic (:20) into one loop
// fusion, and its autodiff into one more.  Eager PyTorch runs about a dozen
// kernels a call, each over the whole activation, and autograd keeps as many
// intermediates; this file is one pass forward and one (plus a small
// reduction) backward, and the backward keeps only x and a.
//
// Rounding.  Every step rounds once, in the order above: __fmul_rn,
// __fadd_rn and __fsub_rn are never contracted into a fused multiply-add,
// every division gives the IEEE quotient RN(v / d) (as JAX computes
// p2 / 6; eager PyTorch on the card multiplies by a rounded reciprocal when
// the divisor is a host scalar, which is why the plain version divides by a
// device tensor), and rintf rounds half to even as jnp.round.  In bfloat16
// a arrives rounded to bfloat16, a x and the polynomial stay float32, and
// S, a + 1e-9, S / (a + 1e-9) and the sum each round to bfloat16 where
// Snake.forward rounds them.
//
// Backward.  With gS = g / (a + 1e-9) the gradient reaching S, S'(z) the
// derivative of the polynomial chain as reverse-mode autodiff forms it
// (rint has zero gradient: S' = 2 s . ds/dp . pi . (1/pi), not 2 sin cos):
//     dx      = g + gS S'(a x) a
//     dalpha  = sum_{b,t} gS S'(a x) x  -  sum_{b,t} g (S / (a+1e-9)) / (a+1e-9)
// the two sums kept apart, as autograd keeps them; in bfloat16 each step
// that autograd of the plain bfloat16 forward rounds to bfloat16 rounds
// here too.  The caller chains dalpha to log_alpha (times a).  The
// per-channel sums over B x T (up to 1.5 M terms a channel) are
// deterministic: each warp sums its own elements of one row in a fixed
// order, the partials go to scratch, and a second kernel adds them per
// channel in a fixed order.  No atomics: two runs give the same bits.
//
// Divisions without the divide instruction's slow path.  An IEEE division
// (__fdiv_rn) is a reciprocal, four fused multiply-adds, a range check
// (FCHK) and a branch to a called slow path: some ten instructions issued.
// The forward divides four times an element and the backward ten, which
// made both passes issue-bound (an H100 issues ~33 T thread-instructions a
// second).  Here every division still gives RN(v / d) bit for bit, by
// shorter sequences of float32 FMA-unit instructions:
//   * by 6, 20 and 42, Brisebarre and Muller's two constants,
//     q = fma(v, zh, RN(v zl)) with zh = RN(1/d), zl ~ 1/d - zh (below),
//     two instructions; it equals RN(v / d) for every |v| >= 2^-94 (all
//     2^32 patterns on the card, chip_smoke.py phase 2; one binade and its
//     scaling argument on the CPU, tests/test_torch_snake_division.py), and
//     fails on subnormal-grid ties below that.  There the exact fallback is
//     one float64 product, RN(RN53(v * RN53(1/d))), equal to RN(v / d) for
//     every float32 v (by the same two proofs: in float64 nothing is
//     subnormal, so one binade and the range of subnormal quotients cover
//     it on the CPU);
//   * by the per-channel den = a + 1e-9, a reciprocal split into
//     yd = RD(1/den) and yl = RN((1 - den yd) yn) >= 0 once per row, the
//     quotient q = fma(v, yd, RN(v yl)), and one Markstein correction with
//     yn = RN(1/den): r = fma(q, den, -v), q' = fma(-r, yn, q); four
//     instructions.  Markstein's theorem (P. Markstein, IBM J. Res. Dev.
//     34(1), 1990; restated in Muller et al., Handbook of Floating-Point
//     Arithmetic, in its chapter on division with a fused multiply-add):
//     in binary precision p, if q is a faithful rounding of a/b, y
//     approximates 1/b with relative error below 2^-p, and r = o(a - bq),
//     q' = o(q + r y) are computed in the rounding mode o (here to nearest
//     even), then r is exact and q' is exactly o(a/b), provided no
//     underflow or overflow occurs.  Here
//     y = yn = RN(1/den) (relative error below 2^-24); q is faithful since
//     yd + yl is 1/den within 2^-46 relative, so q is within 2^-45 |v/den|
//     of the exact quotient before its one rounding; the residual is
//     exact for a faithful q.  The preconditions hold for den in
//     [2^-20, 2^20] and 2^-80 <= |v| < 2^80 (quotient, residual and
//     products normal, or the residual so small that its rounding cannot
//     reach q'), and for v = +-0 (signs kept since yl >= 0).  Other den
//     (a whole row: warp-uniform) and other v take __fdiv_rn.  In the
//     bfloat16 kernels every numerator and den is a bfloat16 value, and
//     there q = RN(v yn) before the same Markstein step gives RN(v / den)
//     for every such pair in that domain (three instructions; no theorem:
//     all the pairs are tried, tests/test_torch_snake_division.py and
//     chip_smoke.py phase 2).
// The fast sequences run unguarded on each 16-byte vector; an element
// whose p2 < 2^-28 (|p| < 2^-14: some 4e-5 of the elements; below it the
// backward's dividends could fall under 2^-94), whose gradient is outside
// the den sequence's domain, or whose row's den is, sends its vector
// through the exact path (the same formula with the guarded divisions
// div_const and div_den) after the pass, once per vector.  With
// p2 >= 2^-28 every constant division's dividend is at least p2^3 / 100
// >= 2^-91 (p2, da6 ~ 2 p2, db20 ~ p2^2 / 3, m3 ~ p2^3 / 60; t1, t2, t3 >=
// 0.63) and S >= 0.4 p2 >= 2^-30, inside both domains.
//
// What bounds it on an H100: bytes, where it can.  One encode of 16 x 4 s
// at 24 kHz runs Snakes over 1.357 G elements; forward one read and one
// write per element, 10.86 GB in float32 -> 3.24 ms at 3.35 TB/s (1.62 ms
// in bfloat16); backward reads x and g and writes dx, 1.5 times that.  In
// instructions issued the forward now needs some 30 an element (about
// 1.2 ms over an encode), the backward some 60-80, which still bounds the
// bfloat16 backward.
// Design: a warp takes a segment of one row (one channel, so a and its
// per-row constants are computed once a segment): up to kSegVecs 16-byte
// vectors (4 floats or 8 bfloat16), in passes of kVecPerLane vectors a lane,
// each pass's loads issued before its arithmetic.  A row with at most
// kSegVecs vectors (T <= 1024 in float32, 2048 in bfloat16) is one
// segment, so a 256-thread block takes 8 short rows; a long row is several
// segments, adjacent in the block.  Two vectors a lane a pass, and the
// backward held to 64 registers (4 blocks an SM), keep more warps in
// flight: on an H100 the backward ran faster so than with four vectors a
// lane at 80 registers, the bfloat16 one most.  Vectors start at the row's first 16-byte
// boundary; the few elements before it and after the last whole vector go
// one per lane through the exact path.  If the tensors' addresses are not
// 16-byte aligned alike, every element goes one per lane.  No shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                              // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kVecPerLane = 2;                         // 16-byte vectors a lane takes a pass
constexpr int kPassVecs = 32 * kVecPerLane;            // vectors a warp takes a pass
constexpr int kSegVecs = 4 * kPassVecs;                // vectors a warp takes a segment
constexpr int kBackwardBlocksPerSM = 4;  // the backward's registers capped at 64 a thread
constexpr long long kMaxBlocks = 1 << 20;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979323846);
constexpr float kPi = (float)3.14159265358979323846;
constexpr float kEps = (float)1e-9;
constexpr float kTinyP2 = 0x1p-28f;     // p2 below it: the exact path
constexpr float kConstLo = 0x1p-94f;    // |v| from which fma(v, zh, RN(v zl)) is RN(v / d)
constexpr float kDenLo = 0x1p-20f;     // the dens the Markstein sequence takes ...
constexpr float kDenHi = 0x1p20f;
constexpr float kNumLo = 0x1p-80f;     // ... and the |v| (and +-0)
constexpr float kNumHi = 0x1p80f;
constexpr float kMaxFloat = 0x1.fffffep127f;

template <typename T> struct Io;

// a 16-byte vector's 4 floats or 8 bfloat16 as float32, and back
template <> struct Io<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void unpack(uint4 q, float* v) {
    v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <> struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  static __device__ __forceinline__ void unpack(uint4 q, float* v) {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) { return *reinterpret_cast<const uint4*>(p); }
// one 16-byte store (a plain uint4 store under a predicate may split into
// four 4-byte ones)
template <typename T>
__device__ __forceinline__ void store16(T* p, uint4 v) { __stwb(reinterpret_cast<uint4*>(p), v); }

// ---------------------------------------------------------------- divisions

// zh = RN(1/d) and zl, RN(1/d - zh) of the float64 1/d (tests/test_torch_snake_division.py
// reads these two tables, and proves the sequence with these very constants)
template <int D> struct Recip;
template <> struct Recip<6> { static constexpr float hi = 0x1.555556p-3f, lo = -0x1.555556p-28f; };
template <> struct Recip<20> { static constexpr float hi = 0x1.99999ap-5f, lo = -0x1.99999ap-31f; };
template <> struct Recip<42> { static constexpr float hi = 0x1.861862p-6f, lo = -0x1.e79e7ap-32f; };

// RN(v / D) for kConstLo <= |v| < 2^128: fma(v, zh, RN(v zl))
template <int D>
__device__ __forceinline__ float div_const_fast(float v) {
  return __fmaf_rn(v, Recip<D>::hi, __fmul_rn(v, Recip<D>::lo));
}

// RN(v / D) for every float32 v: RN(RN53(v * RN53(1/D)))
template <int D>
__device__ __forceinline__ float div_const_wide(float v) {
  return __double2float_rn(__dmul_rn((double)v, 1.0 / D));
}

// RN(v / D) for every float32 v (NaN for NaN), as __fdiv_rn(v, D)
template <int D>
__device__ __forceinline__ float div_const(float v) {
  const float m = fabsf(v);
  return (m >= kConstLo && m <= kMaxFloat) ? div_const_fast<D>(v)
                                                             : div_const_wide<D>(v);
}

// den = a + 1e-9 and what a row divides by it with
struct Den {
  float den, yd, yl, yn;
  bool fast;  // den in [kDenLo, kDenHi]
};

__device__ __forceinline__ Den den_of(float den) {
  Den k;
  k.den = den;
  k.fast = den >= kDenLo && den <= kDenHi;
  k.yn = __frcp_rn(den);
  k.yd = __frcp_rd(den);
  k.yl = __fmul_rn(__fmaf_rn(-den, k.yd, 1.0f), k.yn);  // 1 - den yd is exact and >= 0
  return k;
}

// the numerators the Markstein sequence takes: +-0 and kNumLo <= |v| < kNumHi
__device__ __forceinline__ bool den_domain(float v) {
  const float m = fabsf(v);
  return (m < kNumHi) & ((m >= kNumLo) | (v == 0.0f));
}

// RN(v / den) for k.fast and den_domain(v), the quotient before the
// Markstein step: in float32 fma(v, yd, RN(v yl)); where v and den are
// both bfloat16 values (T = __nv_bfloat16: every numerator of that kernel
// is), RN(v yn) suffices, as the exhaustive checks show (all bfloat16 v
// against all bfloat16 den in [kDenLo, kDenHi], on the card and, by the
// same scaling as above, on the CPU)
template <typename T>
__device__ __forceinline__ float div_den_fast(float v, const Den& k) {
  float q;
  if constexpr (sizeof(T) == 4) q = __fmaf_rn(v, k.yd, __fmul_rn(v, k.yl));
  else q = __fmul_rn(v, k.yn);
  const float r = __fmaf_rn(q, k.den, -v);  // q den - v, exact
  return __fmaf_rn(-r, k.yn, q);
}

// RN(v / den) for every float32 v (bfloat16 v where T is), as __fdiv_rn(v, den)
template <typename T>
__device__ __forceinline__ float div_den(float v, const Den& k) {
  return (k.fast && den_domain(v)) ? div_den_fast<T>(v, k) : __fdiv_rn(v, k.den);
}

// The hot path's divisions, valid where snake_fwd / snake_bwd leave ok set
template <typename T>
struct FastDiv {
  template <int D> static __device__ __forceinline__ float by(float v) { return div_const_fast<D>(v); }
  static __device__ __forceinline__ float by_den(float v, const Den& k) { return div_den_fast<T>(v, k); }
};

// The exact path's divisions, RN(v / d) for every input
template <typename T>
struct ExactDiv {
  template <int D> static __device__ __forceinline__ float by(float v) { return div_const<D>(v); }
  static __device__ __forceinline__ float by_den(float v, const Den& k) { return div_den<T>(v, k); }
};

// ---------------------------------------------------------------- the element

// The forward's intermediates at one element.
struct Poly {
  float p, p2, a6, b20, t1, t2, t3, s;
};

// s(p) of z, step by step as snake_reference's _sin2_periodic
template <typename Div>
__device__ __forceinline__ Poly poly(float z) {
  Poly r;
  float u = __fmul_rn(z, kInvPi);
  u = __fsub_rn(u, rintf(u));
  r.p = __fmul_rn(u, kPi);
  r.p2 = __fmul_rn(r.p, r.p);
  r.t3 = __fsub_rn(1.0f, Div::template by<42>(r.p2));
  r.b20 = Div::template by<20>(r.p2);
  r.t2 = __fsub_rn(1.0f, __fmul_rn(r.b20, r.t3));
  r.a6 = Div::template by<6>(r.p2);
  r.t1 = __fsub_rn(1.0f, __fmul_rn(r.a6, r.t2));
  r.s = __fmul_rn(r.p, r.t1);
  return r;
}

// dS/dz at one element by reverse-mode autodiff of poly() with seed 1
// (snake_backward_reference spells the same steps)
template <typename Div>
__device__ __forceinline__ float poly_grad(const Poly& r) {
  const float ds = __fadd_rn(r.s, r.s);           // S = s * s
  float dp = __fmul_rn(ds, r.t1);                  // s = p * t1
  const float m1 = -__fmul_rn(ds, r.p);            // t1 = 1 - a6 * t2
  const float da6 = __fmul_rn(m1, r.t2);
  const float m2 = -__fmul_rn(m1, r.a6);           // t2 = 1 - b20 * t3
  const float db20 = __fmul_rn(m2, r.t3);
  const float m3 = -__fmul_rn(m2, r.b20);          // t3 = 1 - p2 / 42
  const float dp2 = __fadd_rn(__fadd_rn(Div::template by<6>(da6), Div::template by<20>(db20)),
                              Div::template by<42>(m3));
  const float dpp = __fmul_rn(dp2, r.p);           // p2 = p * p
  dp = __fadd_rn(dp, __fadd_rn(dpp, dpp));
  return __fmul_rn(__fmul_rn(dp, kPi), kInvPi);   // p = u * pi, u = z * (1/pi)
}

// One element's output, before its rounding to T (every store rounds);
// ok is cleared where FastDiv's sequences may not give RN(v / d) (Div =
// ExactDiv ignores it)
template <typename T, typename Div>
__device__ __forceinline__ float snake_fwd(float x, float a, const Den& k, bool& ok) {
  using R = Io<T>;
  const Poly r = poly<Div>(__fmul_rn(a, x));
  ok &= r.p2 >= kTinyP2;
  const float S = R::round(__fmul_rn(r.s, r.s));
  return __fadd_rn(x, R::round(Div::by_den(S, k)));
}

// One element's dx (before its rounding to T, which its store does) and,
// with kAlpha, its terms of the two dalpha sums (the a x path's tz and the
// 1/(a + 1e-9) path's td, which autograd sums apart).  In bfloat16 every
// step that autograd of the plain bfloat16 forward rounds to bfloat16
// rounds here too: g / den, the product's gradient to x, dx, and each
// element's 1/(a + 1e-9) term; in float32 R is the identity.
template <typename T, bool kAlpha, typename Div>
__device__ __forceinline__ float snake_bwd(float x, float g, float a, const Den& k, float& tz,
                                           float& td, bool& ok) {
  using R = Io<T>;
  const Poly r = poly<Div>(__fmul_rn(a, x));
  ok &= (r.p2 >= kTinyP2) & den_domain(g);
  const float dz = __fmul_rn(R::round(Div::by_den(g, k)), poly_grad<Div>(r));
  if (kAlpha) {
    const float S = R::round(__fmul_rn(r.s, r.s));
    tz = __fmul_rn(dz, x);
    td = R::round(__fmul_rn(g, R::round(Div::by_den(R::round(Div::by_den(S, k)), k))));
  }
  return __fadd_rn(g, R::round(__fmul_rn(dz, a)));
}

// The row's layout: `head` single elements up to the first 16-byte boundary
// (all of the row when the tensors are not aligned alike), then `nvec`
// whole vectors, then `tail` single elements.
template <typename T>
struct Row {
  int head, nvec, tail;
  __device__ __forceinline__ Row(const T* start, int T_, bool aligned) {
    constexpr int V = Io<T>::kVec;
    const int mis = (int)((reinterpret_cast<uintptr_t>(start) & 15) / sizeof(T));
    head = aligned ? (mis ? V - mis : 0) : T_;
    if (head > T_) head = T_;
    nvec = (T_ - head) / V;
    tail = T_ - head - nvec * V;
  }
  // the row offset of the i-th single element (i < head + tail)
  __device__ __forceinline__ int single(int i) const {
    return i < head ? i : i + nvec * Io<T>::kVec;
  }
};

// ---------------------------------------------------------------- kernels

// grid: kWarps warps a block; warp w takes segment w % G of row w / G (in
// turn, while w < rows G): the row's vectors [seg, seg + 1) kSegVecs, and its
// single elements i = seg 32 + lane (mod 32 G)
template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_forward_kernel(const T* __restrict__ x, const float* __restrict__ alpha, T* __restrict__ y,
                     int rows, int C, int T_, int G, bool aligned) {
  using R = Io<T>;
  constexpr int V = R::kVec;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); w < (long long)rows * G;
       w += (long long)gridDim.x * kWarps) {
    const int row = (int)(w / G), seg = (int)(w % G), lane = threadIdx.x & 31;
    const size_t base = (size_t)row * T_;
    const float a = alpha[row % C];
    const Den k = den_of(R::round(__fadd_rn(a, kEps)));
    const Row<T> lay(x + base, T_, aligned);
    const T* xr = x + base + lay.head;
    T* yr = y + base + lay.head;
    const int end = min(lay.nvec, (seg + 1) * kSegVecs);
    for (int p0 = seg * kSegVecs; p0 < end; p0 += kPassVecs) {
      uint4 raw[kVecPerLane];
#pragma unroll
      for (int j = 0; j < kVecPerLane; ++j) {
        const int v = p0 + j * 32 + lane;
        if (v < end) raw[j] = load16(xr + (size_t)v * V);
      }
      unsigned bad = 0;
#pragma unroll
      for (int j = 0; j < kVecPerLane; ++j) {
        const int v = p0 + j * 32 + lane;
        if (v < end) {
          float e[V];
          R::unpack(raw[j], e);
          bool ok = k.fast;
#pragma unroll
          for (int i = 0; i < V; ++i) e[i] = snake_fwd<T, FastDiv<T>>(e[i], a, k, ok);
          if (ok) store16(yr + (size_t)v * V, R::pack(e));
          bad |= (unsigned)!ok << j;
        }
      }
      // rare: the vectors the fast sequences may not round right, again
      // element by element through the exact path
      for (; bad; bad &= bad - 1) {
        const size_t o = (size_t)(p0 + (__ffs(bad) - 1) * 32 + lane) * V;
#pragma unroll 1
        for (int i = 0; i < V; ++i) {
          bool unused = true;
          R::store(yr + o + i, snake_fwd<T, ExactDiv<T>>(R::load(xr + o + i), a, k, unused));
        }
      }
    }
    for (int i = seg * 32 + lane; i < lay.head + lay.tail; i += G * 32) {
      const size_t o = base + lay.single(i);
      bool unused = true;
      R::store(y + o, snake_fwd<T, ExactDiv<T>>(R::load(x + o), a, k, unused));
    }
  }
}

// a warp's sum of v over its lanes in a fixed shuffle tree (every lane holds it)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, s));
  return v;
}

// dx (skipped where dx is null) and, with kAlpha, segment (row, seg)'s sums
// of the dalpha terms of its elements: the a x path's in
// partial[row * G + seg], the 1/(a + 1e-9) path's in partial[(rows + row) * G + seg]
template <typename T, bool kAlpha>
__global__ void __launch_bounds__(kThreads, kBackwardBlocksPerSM)
snake_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ alpha, T* __restrict__ dx,
                      float* __restrict__ partial, int rows, int C, int T_, int G, bool aligned) {
  using R = Io<T>;
  constexpr int V = R::kVec;
  for (long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); w < (long long)rows * G;
       w += (long long)gridDim.x * kWarps) {
    const int row = (int)(w / G), seg = (int)(w % G), lane = threadIdx.x & 31;
    const size_t base = (size_t)row * T_;
    const float a = alpha[row % C];
    const Den k = den_of(R::round(__fadd_rn(a, kEps)));
    const Row<T> lay(x + base, T_, aligned);
    const T* xr = x + base + lay.head;
    const T* gr = g + base + lay.head;
    T* dr = dx ? dx + base + lay.head : nullptr;
    float sz = 0.0f, sd = 0.0f;
    const int end = min(lay.nvec, (seg + 1) * kSegVecs);
    for (int p0 = seg * kSegVecs; p0 < end; p0 += kPassVecs) {
      uint4 rx[kVecPerLane], rg[kVecPerLane];
#pragma unroll
      for (int j = 0; j < kVecPerLane; ++j) {
        const int v = p0 + j * 32 + lane;
        if (v < end) {
          rx[j] = load16(xr + (size_t)v * V);
          rg[j] = load16(gr + (size_t)v * V);
        }
      }
      unsigned bad = 0;
#pragma unroll
      for (int j = 0; j < kVecPerLane; ++j) {
        const int v = p0 + j * 32 + lane;
        if (v < end) {
          float ex[V], eg[V];
          R::unpack(rx[j], ex);
          R::unpack(rg[j], eg);
          bool ok = k.fast;
          float nz = sz, nd = sd;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            float tz, td;
            eg[i] = snake_bwd<T, kAlpha, FastDiv<T>>(ex[i], eg[i], a, k, tz, td, ok);
            if (kAlpha) {
              nz = __fadd_rn(nz, tz);
              nd = __fadd_rn(nd, td);
            }
          }
          if (kAlpha) {
            sz = ok ? nz : sz;
            sd = ok ? nd : sd;
          }
          if (ok && dr) store16(dr + (size_t)v * V, R::pack(eg));
          bad |= (unsigned)!ok << j;
        }
      }
      for (; bad; bad &= bad - 1) {
        const size_t o = (size_t)(p0 + (__ffs(bad) - 1) * 32 + lane) * V;
#pragma unroll 1
        for (int i = 0; i < V; ++i) {
          float tz, td;
          bool unused = true;
          const float d = snake_bwd<T, kAlpha, ExactDiv<T>>(R::load(xr + o + i), R::load(gr + o + i), a,
                                                         k, tz, td, unused);
          if (kAlpha) {
            sz = __fadd_rn(sz, tz);
            sd = __fadd_rn(sd, td);
          }
          if (dr) R::store(dr + o + i, d);
        }
      }
    }
    for (int i = seg * 32 + lane; i < lay.head + lay.tail; i += G * 32) {
      const size_t o = base + lay.single(i);
      float tz, td;
      bool unused = true;
      const float d = snake_bwd<T, kAlpha, ExactDiv<T>>(R::load(x + o), R::load(g + o), a, k, tz, td,
                                                     unused);
      if (kAlpha) {
        sz = __fadd_rn(sz, tz);
        sd = __fadd_rn(sd, td);
      }
      if (dx) R::store(dx + o, d);
    }
    if (kAlpha) {
      sz = warp_sum(sz);
      sd = warp_sum(sd);
      if (lane == 0) {
        partial[(size_t)row * G + seg] = sz;
        partial[((size_t)rows + row) * G + seg] = sd;
      }
    }
  }
}

// dalpha[c] from the partials of rows b * C + c, b < B, in a fixed order: one
// warp per channel, lane l taking the flattened (b, segment) entries l, l + 32,
// ... of each path, then a fixed shuffle tree; the two paths' sums are
// rounded to T and added as autograd adds them (the 1/(a + 1e-9) path's
// terms enter with a minus sign)
template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dalpha, int B, int C,
                    int G) {
  const int c = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (c >= C) return;
  const float* pd = partial + (size_t)B * C * G;
  float vz = 0.0f, vd = 0.0f;
  for (int e = lane; e < B * G; e += 32) {
    const int b = e / G;
    const size_t o = ((size_t)b * C + c) * G + (e - b * G);
    vz = __fadd_rn(vz, partial[o]);
    vd = __fadd_rn(vd, pd[o]);
  }
  vz = warp_sum(vz);
  vd = warp_sum(vd);
  if (lane == 0) dalpha[c] = Io<T>::round(__fsub_rn(Io<T>::round(vz), Io<T>::round(vd)));
}

// ---------------------------------------------------------------- checks

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b) || (a != a && b != b);
}

// the counts out[0..3] += the lanes' n[0..2] (summed) and n[3] (max)
__device__ __forceinline__ void tally(unsigned long long* out, unsigned long long n0,
                                      unsigned long long n1, unsigned long long n2, unsigned n3) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    n0 += __shfl_xor_sync(0xffffffffu, n0, s);
    n1 += __shfl_xor_sync(0xffffffffu, n1, s);
    n2 += __shfl_xor_sync(0xffffffffu, n2, s);
    n3 = max(n3, __shfl_xor_sync(0xffffffffu, n3, s));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(out, n0);
    atomicAdd(out + 1, n1);
    atomicAdd(out + 2, n2);
    atomicMax(out + 3, (unsigned long long)n3);
  }
}

// For the float32 patterns first + i step (mod 2^32), i < count: out[0] the
// patterns where div_const<D> differs from __fdiv_rn(v, D) (two NaNs agree),
// out[1] those that take its fast sequence, out[2] the finite ones where the
// fast sequence alone would differ, out[3] the largest |v| bits among those
template <int D>
__device__ void check_const(unsigned long long first, unsigned long long step,
                            unsigned long long count, unsigned long long* out) {
  unsigned long long n0 = 0, n1 = 0, n2 = 0;
  unsigned n3 = 0;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x; i < count;
       i += (unsigned long long)gridDim.x * blockDim.x) {
    const float v = __uint_as_float((unsigned)(first + i * step));
    const float want = __fdiv_rn(v, (float)D);
    const float m = fabsf(v);
    n0 += !same(div_const<D>(v), want);
    n1 += m >= kConstLo && m <= kMaxFloat;
    if (m <= kMaxFloat && !same(div_const_fast<D>(v), want)) {
      ++n2;
      n3 = max(n3, __float_as_uint(m));
    }
  }
  tally(out, n0, n1, n2, n3);
}

__global__ void __launch_bounds__(kThreads)
snake_check_const_kernel(int d, unsigned long long first, unsigned long long step,
                         unsigned long long count, unsigned long long* out) {
  if (d == 6) check_const<6>(first, step, count, out);
  else if (d == 20) check_const<20>(first, step, count, out);
  else check_const<42>(first, step, count, out);
}

// For every (den, numerator) pair, the numerators nums[0, n_nums) or, where
// nums is null, the float32 patterns 0 .. n_nums - 1: out[0] the pairs where
// div_den<T> differs from __fdiv_rn(v, den) (two NaNs agree), out[1] the pairs
// that take its Markstein sequence, out[2] the pairs.  A thread takes one den
// and a block of 256 numerators, so the row constants are made once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_check_den_kernel(const float* __restrict__ dens, int n_dens, const float* __restrict__ nums,
                       unsigned long long n_nums, unsigned long long* out) {
  constexpr unsigned long long kBlock = 256;
  const unsigned long long blocks = (n_nums + kBlock - 1) / kBlock;
  unsigned long long n0 = 0, n1 = 0, n2 = 0;
  for (unsigned long long it = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       it < blocks * n_dens; it += (unsigned long long)gridDim.x * blockDim.x) {
    const Den k = den_of(dens[it / blocks]);
    const unsigned long long lo = (it % blocks) * kBlock;
    const unsigned long long hi = min(lo + kBlock, n_nums);
    for (unsigned long long j = lo; j < hi; ++j) {
      const float v = nums ? nums[j] : __uint_as_float((unsigned)j);
      n0 += !same(div_den<T>(v, k), __fdiv_rn(v, k.den));
      n1 += k.fast && den_domain(v);
      ++n2;
    }
  }
  tally(out, n0, n1, n2, 0);
}

// ---------------------------------------------------------------- host

// warp segments per row: enough kSegVecs-vector segments for the row's
// vectors, at least one
int segments(int T_, int esize) {
  const int per = kSegVecs * (16 / esize);
  const int n = (T_ + per - 1) / per;
  return n > 0 ? n : 1;
}

dim3 grid_of(int rows, int G) {
  const long long blocks = ((long long)rows * G + kWarps - 1) / kWarps;
  return dim3((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
}

bool valid(int B, int C, int T_, int esize) {
  return B >= 1 && C >= 1 && T_ >= 1 && (esize == 4 || esize == 2) &&
         (long long)B * C <= 0x7fffffffLL;
}

bool aligned_alike(const void* a, const void* b, const void* c) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(a) & 15;
  return (reinterpret_cast<uintptr_t>(b) & 15) == m && (!c || (reinterpret_cast<uintptr_t>(c) & 15) == m);
}

template <typename T>
void backward_launch(const void* x, const void* g, const float* alpha, void* dx, float* partial,
                     int rows, int C, int T_, int G, bool al, cudaStream_t s) {
  if (partial) {
    snake_backward_kernel<T, true><<<grid_of(rows, G), kThreads, 0, s>>>(
        (const T*)x, (const T*)g, alpha, (T*)dx, partial, rows, C, T_, G, al);
  } else {
    snake_backward_kernel<T, false><<<grid_of(rows, G), kThreads, 0, s>>>(
        (const T*)x, (const T*)g, alpha, (T*)dx, nullptr, rows, C, T_, G, al);
  }
}

}  // namespace

// y = snake(x) over (B, C, T): x and y contiguous, float32 (esize 4) or
// bfloat16 (esize 2); alpha (C,) float32, already rounded to x's type.
extern "C" int nawc_snake_forward(const void* x, const float* alpha, void* y, int B, int C, int T,
                                  int esize, void* stream) {
  if (!valid(B, C, T, esize)) return (int)cudaErrorInvalidValue;
  const int rows = B * C, G = segments(T, esize);
  const bool al = aligned_alike(x, y, nullptr);
  cudaStream_t s = (cudaStream_t)stream;
  if (esize == 4) {
    snake_forward_kernel<float><<<grid_of(rows, G), kThreads, 0, s>>>(
        (const float*)x, alpha, (float*)y, rows, C, T, G, al);
  } else {
    snake_forward_kernel<__nv_bfloat16><<<grid_of(rows, G), kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, alpha, (__nv_bfloat16*)y, rows, C, T, G, al);
  }
  return (int)cudaGetLastError();
}

// The floats of scratch that nawc_snake_backward needs for dalpha.
extern "C" int nawc_snake_backward_scratch(int B, int C, int T, int esize, size_t* floats) {
  if (!valid(B, C, T, esize)) return (int)cudaErrorInvalidValue;
  *floats = 2 * (size_t)B * C * segments(T, esize);
  return 0;
}

// dx (null: not wanted) and dalpha (C,) float32 (null: not wanted; scratch
// as sized by nawc_snake_backward_scratch) from x, the output gradient g
// (both contiguous, x's type) and alpha as the forward took it.  Every
// channel of dalpha is written.
extern "C" int nawc_snake_backward(const void* x, const void* g, const float* alpha, void* dx,
                                   float* dalpha, float* scratch, int B, int C, int T, int esize,
                                   void* stream) {
  if (!valid(B, C, T, esize) || (!dx && !dalpha)) return (int)cudaErrorInvalidValue;
  const int rows = B * C, G = segments(T, esize);
  const bool al = aligned_alike(x, g, dx);
  float* partial = dalpha ? scratch : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (esize == 4) backward_launch<float>(x, g, alpha, dx, partial, rows, C, T, G, al, s);
  else backward_launch<__nv_bfloat16>(x, g, alpha, dx, partial, rows, C, T, G, al, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !dalpha) return (int)err;
  const int blocks = (C + kWarps - 1) / kWarps;
  if (esize == 4) {
    snake_reduce_kernel<float><<<blocks, kThreads, 0, s>>>(partial, dalpha, B, C, G);
  } else {
    snake_reduce_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(partial, dalpha, B, C, G);
  }
  return (int)cudaGetLastError();
}

// The division check of the constant divisors d = 6, 20, 42 over the float32
// patterns first + i step, i < count: out (4,) uint64, zeroed by the caller,
// as snake_check_const_kernel fills it.
extern "C" int nawc_snake_check_const(int d, unsigned long long first, unsigned long long step,
                                      unsigned long long count, unsigned long long* out,
                                      void* stream) {
  if (d != 6 && d != 20 && d != 42) return (int)cudaErrorInvalidValue;
  const unsigned long long want = (count + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 64 ? (want > 0 ? want : 1) : 132 * 64);
  snake_check_const_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(d, first, step, count, out);
  return (int)cudaGetLastError();
}

// The division check of the per-channel divisor over n_dens dens and the
// numerators nums (n_nums of them; null: every float32 pattern below n_nums),
// by the float32 kernels' sequence (esize 4) or the bfloat16 kernels' (esize
// 2: dens and numerators must be bfloat16 values): out (4,) uint64, zeroed
// by the caller, as snake_check_den_kernel fills it.
extern "C" int nawc_snake_check_den(const float* dens, int n_dens, const float* nums,
                                    unsigned long long n_nums, int esize, unsigned long long* out,
                                    void* stream) {
  if (n_dens < 1 || n_nums < 1 || (!nums && n_nums > (1ULL << 32)) || (esize != 4 && esize != 2))
    return (int)cudaErrorInvalidValue;
  const unsigned long long items = (n_nums + 255) / 256 * n_dens;
  const unsigned long long want = (items + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(want < 132 * 64 ? want : 132 * 64);
  if (esize == 4) {
    snake_check_den_kernel<float><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(dens, n_dens, nums,
                                                                                 n_nums, out);
  } else {
    snake_check_den_kernel<__nv_bfloat16><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        dens, n_dens, nums, n_nums, out);
  }
  return (int)cudaGetLastError();
}
