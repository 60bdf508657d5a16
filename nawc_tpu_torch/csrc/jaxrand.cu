// Keyed draws of jax.random on the card: uniform and normal float32 from a
// threefry2x32 key, bit for bit the values of the numpy replica
// nawc_tpu_torch/utils/jaxrand.py (random_bits, uniform, normal_from_bits,
// _log, _log1p, erf_inv), which holds them against jax.random on the CPU.
//
// Replaces no Pallas kernel: in the JAX package XLA fuses jax.random's
// threefry hash and its erf_inv into the consumer's program on the
// accelerator (nawc_tpu/interp/uncertainty.py:28, nawc_tpu/attacks/dsp.py
// gaussian_noise, background_noise, eq, time_jitter, reverb, vorbis).
//
// Per element i of the row-major output (jax_threefry_partitionable):
//   (y1, y2) = threefry2x32(key, hi32(i), lo32(i)),  bits = y1 ^ y2
//   u        = float32 of the 23 high bits under exponent 0, minus 1
//   uniform  = max(lo, fma(u, span, lo))             span = hi - lo in f32
//   normal   = sqrt(2) * erf_inv(uniform over (nextafter(-1, 0), 1))
// with XLA's CPU erf_inv (Giles' polynomial over its log1p and log).
//
// Bit equality is the point, so every step rounds where the replica
// rounds.  The replica's _fma rounds a float64 product and sum to float64,
// then to float32.  Over the normal draw's whole domain (the 2^23 uniforms
// its bits can make) every one of those 31 steps per draw equals one
// rounding of the exact a * b + c (tests/test_torch_jaxrand.py checks all
// 260,046,848), so the normal instantiation spells each as the hardware's
// one-rounding __fmaf_rn and does no float64 work.  The uniform's range is
// the caller's, where no such proof holds: its one multiply-add stays
// fma64 (__dmul_rn, __dadd_rn, __double2float_rn).  Each unfused float32
// step is an __fmul_rn / __fadd_rn / __fsub_rn, which nvcc does not
// contract (fusing _log's p1 or p * x3 + p1 would change a few of the 2^23
// normals); np.sqrt is __fsqrt_rn, the division __fdiv_rn, np.frexp
// frexpf.  The constants are float32 roundings of the replica's float64
// literals ((float) casts, as np.float32 makes them).  Subnormals are kept
// (nvcc's default -ftz=false), as numpy keeps them.
//
// What bounds it on an H100, for N draws (the uncertainty run's 20 x 32 x
// 32000 = 20.48 M normals):
//   bytes  4 N written, nothing read -> 24.5 us at 3.35 TB/s;
//   int32  about 75 operations per draw for the hash (20 rounds of add,
//          rotate, xor; the key injections; the mantissa) -> 92 us at
//          16.7 TOP/s (132 SMs x 64 INT32 lanes x 1.98 GHz);
//   fp32   about 37 FMA-unit instructions per normal (15, then 20 on
//          log1p's rational branch or 24 on its log) -> 23 us at 33.5 G
//          warp-lane instructions per ms (half of 67 TFLOP/s);
//   issue  a warp runs both log1p branches wherever its draws take both
//          (nearly every warp), so about 170 instructions per warp of
//          draws go through a scheduler that issues one a clock: 640 k
//          warps over 528 schedulers -> about 104 us at 1.98 GHz.
// So the hash's integer work, and the scheduler's issue slots close
// behind it, bound the normal draw; the uniform is the hash alone.
// Design: one thread per element, every helper inlined (no call, no stack
// frame), no shared memory, no reads; the launch writes coalesced float32.
// normal_of_bits is the same transform on given bits: it lets the card be
// checked over the transform's whole domain, and no path calls it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int R>
__device__ __forceinline__ uint32_t rotl(uint32_t x) {
  return __funnelshift_l(x, x, R);
}

template <int A, int B, int C, int D>
__device__ __forceinline__ void four_rounds(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = rotl<A>(x1); x1 ^= x0;
  x0 += x1; x1 = rotl<B>(x1); x1 ^= x0;
  x0 += x1; x1 = rotl<C>(x1); x1 ^= x0;
  x0 += x1; x1 = rotl<D>(x1); x1 ^= x0;
}

// threefry2x32 (20 rounds) of the counter pair (x0, x1), in place
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k1; x1 += k2 + 1u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k0; x1 += k1 + 3u;
  four_rounds<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  four_rounds<13, 15, 26, 6>(x0, x1);  x0 += k2; x1 += k0 + 5u;
}

// the replica's _fma for a uniform over the caller's range: float32
// a * b + c through float64 (the product exact, the sum rounded), then
// float32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

#define F32(x) ((float)(x))

// XLA's float32 log for 0 < v < 1 (the replica's _log)
__device__ __forceinline__ float xla_log(float v) {
  int ei;
  const float m = frexpf(v, &ei);
  float e = (float)ei;
  const bool small = m < F32(0.707106781186547524);
  if (small) e = __fsub_rn(e, 1.0f);
  const float x = __fadd_rn(__fsub_rn(m, 1.0f), small ? m : 0.0f);
  const float x2 = __fmul_rn(x, x);
  const float x3 = __fmul_rn(x2, x);
  const float p = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(x, F32(7.0376836292e-2)), F32(-1.1514610310e-1)), x),
                            F32(1.1676998740e-1));
  const float p1 = __fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(x, F32(-1.2420140846e-1)), F32(1.4249322787e-1)), x),
                             F32(-1.6668057665e-1));
  const float p2 = __fmaf_rn(__fmaf_rn(x, F32(2.0000714765e-1), F32(-2.4999993993e-1)), x, F32(3.3333331174e-1));
  float y = __fmaf_rn(__fadd_rn(__fmul_rn(p, x3), p1), x3, p2);
  y = __fmaf_rn(y, x3, __fmul_rn(F32(-2.12194440e-4), e));
  return __fmaf_rn(F32(0.693359375), e, __fadd_rn(__fmaf_rn(-0.5f, x2, x), y));
}

// XLA's float32 log1p for -1 < x <= 0 (the replica's _log1p)
__device__ __forceinline__ float xla_log1p(float x) {
  if (!(fabsf(x) < F32(0.41421356237309504880))) return xla_log(__fadd_rn(1.0f, x));
  // Cephes' rational approximation, highest power first
  const float num[7] = {F32(4.5270000862445199635215e-5), F32(4.9854102823193375972212e-1),
                        F32(6.5787325942061044846969e0), F32(2.9911919328553073277375e1),
                        F32(6.0949667980987787057556e1), F32(5.7112963590585538103336e1),
                        F32(2.0039553499201281259648e1)};
  const float den[7] = {F32(1.0), F32(1.5062909083469192043167e1), F32(8.3047565967967209469434e1),
                        F32(2.2176239823732856465394e2), F32(3.0909872225312059774938e2),
                        F32(2.1642788614495947685003e2), F32(6.0118660497603843919306e1)};
  float pn = 0.0f, pd = 0.0f;
#pragma unroll
  for (int i = 0; i < 7; ++i) {
    pn = __fmaf_rn(pn, x, num[i]);
    pd = __fmaf_rn(pd, x, den[i]);
  }
  const float x2 = __fmul_rn(x, x);
  const float r = __fdiv_rn(pn, pd);
  return __fadd_rn(x, __fmaf_rn(-0.5f, x2, __fmul_rn(__fmul_rn(x, x2), r)));
}

// XLA's float32 erf_inv for |x| < 1 (the replica's erf_inv)
__device__ __forceinline__ float xla_erf_inv(float x) {
  // Giles' coefficients for w < 5 and w >= 5, highest power first
  const float c_lo[9] = {F32(2.81022636e-08), F32(3.43273939e-07), F32(-3.5233877e-06),
                         F32(-4.39150654e-06), F32(0.00021858087), F32(-0.00125372503),
                         F32(-0.00417768164), F32(0.246640727), F32(1.50140941)};
  const float c_hi[9] = {F32(-0.000200214257), F32(0.000100950558), F32(0.00134934322),
                         F32(-0.00367342844), F32(0.00573950773), F32(-0.0076224613),
                         F32(0.00943887047), F32(1.00167406), F32(2.83297682)};
  float w = -xla_log1p(__fmul_rn(x, -x));
  const bool lo = w < 5.0f;
  w = lo ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = 0.0f;
#pragma unroll
  for (int i = 0; i < 9; ++i) p = __fmaf_rn(p, w, lo ? c_lo[i] : c_hi[i]);
  return __fmul_rn(p, x);
}

// the unit uniform in [0, 1) of the 23 high bits
__device__ __forceinline__ float unit_of_bits(uint32_t bits) {
  return __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
}

// the replica's normal_from_bits: the uniform over (nextafter(-1, 0), 1),
// whose span 1 - lo rounds to 2 in float32, then sqrt(2) erf_inv
__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  const float lo = __uint_as_float(0xBF7FFFFFu);  // nextafter(-1, 0)
  const float v = fmaxf(lo, __fmaf_rn(unit_of_bits(bits), 2.0f, lo));
  return __fmul_rn(F32(1.4142135623730951), xla_erf_inv(v));
}

template <bool kNormal>
__global__ void __launch_bounds__(kThreads)
keyed_kernel(float* __restrict__ out, long long n, uint32_t k0, uint32_t k1, float lo, float span) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t x0 = (uint32_t)((unsigned long long)i >> 32), x1 = (uint32_t)i;
  threefry2x32(k0, k1, x0, x1);
  const uint32_t bits = x0 ^ x1;
  out[i] = kNormal ? normal_of_bits(bits) : fmaxf(lo, fma64(unit_of_bits(bits), span, lo));
}

__global__ void __launch_bounds__(kThreads)
normal_of_bits_kernel(float* __restrict__ out, const uint32_t* __restrict__ bits, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = normal_of_bits(bits[i]);
}

int grid(long long n, unsigned* blocks) {
  const long long b = (n + kThreads - 1) / kThreads;
  if (b > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)b;
  return 0;
}

}  // namespace

// out (n,) float32; key (k0, k1); normal = 0: uniform over [lo, lo + span);
// normal = 1: the normal draw, whose uniform range is fixed (lo and span
// are not read).
extern "C" int nawc_jaxrand(float* out, long long n, unsigned int k0, unsigned int k1, int normal,
                            float lo, float span, void* stream) {
  if (n <= 0) return 0;
  unsigned blocks;
  if (int err = grid(n, &blocks)) return err;
  if (normal)
    keyed_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(out, n, k0, k1, lo, span);
  else
    keyed_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(out, n, k0, k1, lo, span);
  return (int)cudaGetLastError();
}

// out (n,) float32: the normal of each of the n uint32 `bits`, by the
// keyed normal draw's device code
extern "C" int nawc_jaxrand_normal_of_bits(float* out, const unsigned int* bits, long long n,
                                           void* stream) {
  if (n <= 0) return 0;
  unsigned blocks;
  if (int err = grid(n, &blocks)) return err;
  normal_of_bits_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(out, bits, n);
  return (int)cudaGetLastError();
}
