// The codecs' output convolution, C channels to one at stride 1 (the
// decoders' last conv), computed in float32 from the activation where it
// lies:
//     out[b, t] = bias + sum_c sum_j w[c, j] float(x[b, c, t + j - left])
//                                                     (x = 0 outside [0, T))
// for a contiguous, 16-byte aligned x (B, C, T) of bfloat16 or float32, T a
// multiple of 8 (the decoders' T is frames times the hop), k 3 or 7 taps
// (the four decoders' last convs), `left` zeros on the left and k - 1 -
// left on the right (SAME's (k - 1) / 2 on both sides, or Mimi's causal
// k - 1 on the left); w holds (C, k) float32 taps, bias one float32 value
// or null (no add); out is (B, T) float32.
// Each x value is widened exactly to float32 and multiplied by its float32
// tap in a fused multiply-add, summed in float32 (channel by channel, tap by
// tap, j = 0 first), then the bias added: the arithmetic of the plain route
// it replaces (nawc_tpu_torch/ops/conv.py: x.float(), F.pad, cuDNN's float32
// conv with TF32 off), with another summation order.  No operation runs
// across threads, so two runs give the same bits.
//
// Replaces no Pallas kernel: XLA's convolution of the decoder's last conv
// (nawc_tpu/codec/model.py, Decoder's Conv_1, which flax promotes to its
// float32 kernel).  It was added because that conv ran as three passes on
// the card: a float32 copy of the whole full-rate activation, a padded
// copy of that, then cuDNN's implicit_convolve_sgemm<float>, a GEMM with
// one output column (12.9 ms of a 90.8 ms Mimi 16 x 30 s call, PERF.md §5).
//
// Bound on an H100: about 2 k FLOPs an x value against its 2 or 4 bytes,
// under FFMA's ridge, so bytes bound it: x read and the output written once,
// Mimi's 16 x 64 x 720,000 bfloat16 tail 1.52 GB, 0.454 ms at 3.35 TB/s.
//
// Design: read every byte of x once, 16 bytes a load, with a group of
// channels always in flight.
//   * a thread owns a unit of 8 consecutive x values of a row, x[8u, 8u + 8),
//     and the 8 outputs at 8u + left .. 8u + left + 7, whose taps reach x
//     values 8u .. 8u + 6 + k: its own and the first k - 1 of the next
//     unit, which it takes from lane + 1 by a warp shuffle.  Shifting the
//     outputs by `left`, and not the window, keeps every tap position a
//     compile-time constant for any padding; only the stores move;
//   * lane 31 of each warp loads the unit after lane 30's and computes
//     nothing it stores, so a warp stores 31 units and no halo is loaded
//     twice by one warp;
//   * units start at u = -1 (the outputs below `left`) and the unit loads
//     give zeros outside [0, T), which is both pads (T % 8 == 0: a unit
//     lies all inside or all outside);
//   * the channels are loaded in groups (8 bfloat16 or 4 float32 rows, 128
//     bytes a thread), the next group's loads issued before the current
//     group's 8 k fused multiply-adds a channel; the taps sit in shared
//     memory, read as warp-wide broadcasts;
//   * each output lies in one thread's registers through all C channels:
//     the bias added and 8 stores a thread at the end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnits = 31;   // units a warp stores: lane 31 only loads lane 30's halo
constexpr int kMaxC = 1024;  // the taps, (C, k) float32, fit in 28 KB of shared memory

struct Args {
  const void* x;
  const float* w;     // (C, k)
  const float* bias;  // one value, or null
  float* out;         // (B, T)
  int C, T, left;
  int tiles;          // blocks a row
};

// element e of the 8 values held in the words v as float32: kBytes 2,
// bfloat16 pairs (the element at the lower address in the low half); 4, float32
template <int kBytes>
__device__ __forceinline__ float elem(const uint32_t* v, int e) {
  if (kBytes == 4) return __uint_as_float(v[e]);
  const uint32_t word = v[e >> 1];
  return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
}

// The 8 values x[8u, 8u + 8) of a 16-byte aligned row of length T (a
// multiple of 8) as raw words, in 16-byte loads; zeros outside [0, T).
template <int kBytes>
__device__ __forceinline__ void load_unit(const void* row, int T, int u, uint32_t* v) {
  const int t0 = 8 * u;
  const bool ok = t0 >= 0 && t0 < T;
  const uint4* p = reinterpret_cast<const uint4*>(static_cast<const char*>(row) + (ok ? t0 : 0) * kBytes);
#pragma unroll
  for (int q = 0; q < kBytes / 2; ++q) {
    const uint4 r = ok ? __ldg(p + q) : make_uint4(0u, 0u, 0u, 0u);
    v[4 * q] = r.x;
    v[4 * q + 1] = r.y;
    v[4 * q + 2] = r.z;
    v[4 * q + 3] = r.w;
  }
}

// The unit u of channels c0 .. c0 + G - 1 (zeros past C).
template <int kBytes, int G>
__device__ __forceinline__ void load_group(const Args& a, const char* xb, int c0, int u,
                                           uint32_t (&v)[G][2 * kBytes]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (c0 + g < a.C) {
      load_unit<kBytes>(xb + (long long)(c0 + g) * a.T * kBytes, a.T, u, v[g]);
    } else {
#pragma unroll
      for (int q = 0; q < 2 * kBytes; ++q) v[g][q] = 0u;
    }
  }
}

// acc[i] += sum_j tap[j] x[8u + i + j] over the G channels of a group: the
// first k - 1 values of the next unit from lane + 1
template <int kBytes, int K, int G>
__device__ __forceinline__ void fma_group(const uint32_t (&v)[G][2 * kBytes], const float* tap, float* acc) {
  constexpr int kHalo = ((K - 1) * 2 * kBytes + 7) / 8;  // words of the next unit the taps reach
#pragma unroll
  for (int g = 0; g < G; ++g) {
    uint32_t h[kHalo > 0 ? kHalo : 1];
#pragma unroll
    for (int q = 0; q < kHalo; ++q) h[q] = __shfl_down_sync(0xffffffffu, v[g][q], 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float c = tap[g * K + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        acc[i] = fmaf(c, i + j < 8 ? elem<kBytes>(v[g], i + j) : elem<kBytes>(h, i + j - 8), acc[i]);
    }
  }
}

template <int kBytes, int K>
__global__ void __launch_bounds__(kThreads, 2) outconv_kernel(const Args a) {
  constexpr int G = 16 / kBytes;  // channels a group: 128 bytes of x a thread
  extern __shared__ float taps[];  // (C rounded up to G, k), zeros past C
  const int cpad = (a.C + G - 1) / G * G;
  for (int i = threadIdx.x; i < cpad * K; i += kThreads) taps[i] = i < a.C * K ? a.w[i] : 0.f;
  __syncthreads();

  const int row = blockIdx.x / a.tiles, tile = blockIdx.x - row * a.tiles;
  const int lane = threadIdx.x & 31;
  const int u = (tile * kWarps + (threadIdx.x >> 5)) * kUnits + lane - 1;
  const char* xb = static_cast<const char*>(a.x) + (long long)row * a.C * a.T * kBytes;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
  uint32_t v0[G][2 * kBytes], v1[G][2 * kBytes];
  load_group<kBytes, G>(a, xb, 0, u, v0);
  for (int c0 = 0; c0 < cpad; c0 += 2 * G) {
    if (c0 + G < cpad) load_group<kBytes, G>(a, xb, c0 + G, u, v1);
    fma_group<kBytes, K, G>(v0, taps + c0 * K, acc);
    if (c0 + G >= cpad) break;
    if (c0 + 2 * G < cpad) load_group<kBytes, G>(a, xb, c0 + 2 * G, u, v0);
    fma_group<kBytes, K, G>(v1, taps + (c0 + G) * K, acc);
  }

  if (lane == kUnits) return;
  float* o = a.out + (long long)row * a.T;
  const int t0 = 8 * u + a.left;
  const float b = a.bias ? *a.bias : 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (t0 + i >= 0 && t0 + i < a.T) o[t0 + i] = a.bias ? acc[i] + b : acc[i];
}

template <int kBytes>
cudaError_t launch(const Args& a, int k, int blocks, cudaStream_t s) {
  const size_t smem = (size_t)((a.C + 16 / kBytes - 1) / (16 / kBytes) * (16 / kBytes)) * k * sizeof(float);
  if (k == 3)
    outconv_kernel<kBytes, 3><<<blocks, kThreads, smem, s>>>(a);
  else
    outconv_kernel<kBytes, 7><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x: (B, C, T), 16-byte aligned, of `elem_bytes` 2 (bfloat16) or 4
// (float32), T % 8 == 0; k 3 or 7; out (B, T) float32.
extern "C" int nawc_outconv(const void* x, int elem_bytes, const float* w, const float* bias, float* out,
                            int B, int C, int T, int k, int left, void* stream) {
  if (B < 0 || C < 1 || C > kMaxC || T < 0 || T % 8 || (k != 3 && k != 7) || left < 0 || left > k - 1 ||
      (elem_bytes != 2 && elem_bytes != 4) || ((uintptr_t)x & 15) || ((uintptr_t)w & 3) ||
      ((uintptr_t)bias & 3) || ((uintptr_t)out & 3))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * T == 0) return 0;
  Args a;
  a.x = x;
  a.w = w;
  a.bias = bias;
  a.out = out;
  a.C = C;
  a.T = T;
  a.left = left;
  const long long units = (long long)T / 8 + 1;  // u = -1 .. T / 8 - 1
  a.tiles = (int)((units + kWarps * kUnits - 1) / (kWarps * kUnits));
  const long long blocks = (long long)B * a.tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2) return (int)launch<2>(a, k, (int)blocks, s);
  return (int)launch<4>(a, k, (int)blocks, s);
}
