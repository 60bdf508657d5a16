// Depthwise (one group a channel) stride-1 convolutions of the bfloat16
// codec, with SAME zero padding and the bias in the kernel:
//     acc[b, c, t] = sum_j x[b, c, t + j d - p] w[c, j]     (x = 0 outside [0, T))
//     out          = bf16(float(bf16(acc)) + bias[c])
// for a contiguous bfloat16 x (B, C, T), k = 7 and dilation d = 1, 3 or 9
// (SNAC's), p = 3 d; w holds (C, 7) float32 taps and bias (C) float32,
// both bfloat16 values, or bias is null (no add).  The rounding points are
// those of the codec's plain path (nawc_tpu_torch/ops/dwconv.py::
// dwconv_reference): the products of bfloat16 values are exact in float32,
// summed in float32 (tap by tap, j = 0 first), rounded once to bfloat16,
// then the bias added in bfloat16.  Only the float32 summation order
// differs from the plain version's.  Two runs give the same bits.
//
// Replaces no Pallas kernel: the JAX package has no depthwise convolution
// (SNAC's layout exists in the port only).  It was added because PyTorch
// sends no bfloat16 depthwise conv to cuDNN: the 26 depthwise k7 convs of
// SNAC 44 kHz's 16 x 4 s encode and decode ran ATen's
// conv_depthwise2d_forward_kernel_generic, a 2-D kernel used at height 1,
// 48.4 ms a call at 9.9% of the byte bound (PERF.md §5).
//
// Bound on an H100: a 1-D stencil of 7 taps, 14 FLOPs an output against 4
// bytes (x read, the output written), so bytes alone bound it: the 26
// layers of one 16 x 4 s call move 16.1 GB, 4.81 ms at 3.35 TB/s.
//
// Design: stream every byte once, in 16-byte pieces, with as much in
// flight as the SMs hold.
//   * a block takes 8192 outputs: one segment of a long row (the rows of
//     30,720 to 184,320 samples are cut into equal segments of at most
//     8192, rounded to 8), or several whole short rows (8 or 17 of the
//     3,840- and 480-sample rows): the tile shape follows T, which the
//     kernel reads from its input;
//   * each segment's window, its outputs plus p rounded up to 8 on each
//     side, is copied to shared memory by cp.async, 16 bytes a piece, all
//     issued before the first wait; with T % 8 == 0 a piece lies wholly
//     inside or outside [0, T), and a piece outside is zero-filled by the
//     copy itself, which is the SAME padding;
//   * each thread computes 8 neighbouring outputs at a time: it reads the
//     2 p8 / 8 + 1 aligned 16-byte pieces that hold all their taps
//     (conflict-free, neighbouring lanes on neighbouring pieces), the
//     channel's taps in registers, 56 fused multiply-adds, and writes the
//     8 outputs with one 16-byte store.  d is a template parameter, so the
//     taps' positions are compile-time constants and every element is
//     picked from registers;
//   * a ragged T or a misaligned x or output takes the same tiles with
//     2-byte copies and stores.
// The bias add is one add.bf16x2 of the rounded conv and the bias: rounding
// the exact sum of two bfloat16 values once equals rounding it to float32
// and then to bfloat16, as PyTorch's bfloat16 add does (float32 has
// 24 >= 2 x 8 + 2 bits, so the double rounding is innocuous).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;                     // 8-output units a thread takes
constexpr int kTile = kThreads * kUnitsPerThread * 8;  // outputs a block takes
constexpr int kMaxSegs = 64;                           // row segments a block takes, at most
constexpr int kK = 7;  // taps

struct Args {
  const bf16* x;
  const float* w;     // (C, k)
  const float* bias;  // (C) or null
  bf16* out;
  int C, T;
  int p8;             // p rounded up to 8: window element e is time t0 - p8 + e
  int len;            // outputs a segment (a multiple of 8)
  int nseg;           // segments a row
  int segs;           // segments a block
  int win;            // elements a segment's window: len + 2 p8
  int total;          // segments in all: B C nseg
};

union Vec8 {
  uint4 v;
  __nv_bfloat162 h[4];
  bf16 e[8];
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; zeros where !ok (src must still be valid)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// element e of the bfloat16 vector held in r[0], r[1], ... as float32
__device__ __forceinline__ float elem(const uint4* r, int e) {
  const uint4 v = r[e >> 3];
  const int m = (e & 7) >> 1;
  const uint32_t word = m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w;
  return __uint_as_float((e & 1) ? (word & 0xffff0000u) : (word << 16));
}

// What a block keeps of each of its segments: its row, first time, taps and bias.
struct Seg {
  int row[kMaxSegs];
  int t0[kMaxSegs];
  float w[kMaxSegs][kK + 1];  // taps, then the bias (0 without one)
};

// The block's segments g0, g0 + 1, ... (the last block's may end early) -> n of them.
__device__ __forceinline__ int describe(const Args& a, Seg& seg, int g0) {
  const int n = min(a.segs, a.total - g0);
  if (threadIdx.x < n) {
    const int g = g0 + threadIdx.x, row = g / a.nseg, c = row % a.C;
    seg.row[threadIdx.x] = row;
    seg.t0[threadIdx.x] = (g - row * a.nseg) * a.len;
    for (int j = 0; j < kK; ++j) seg.w[threadIdx.x][j] = a.w[c * kK + j];
    seg.w[threadIdx.x][kK] = a.bias ? a.bias[c] : 0.f;
  }
  return n;
}

// The windows of the block's n segments into shared memory.
template <bool kVec>
__device__ __forceinline__ void stage(const Args& a, const Seg& seg, bf16* win, int n) {
  if (kVec) {
    const int per = a.win / 8;  // 16-byte pieces a window
    for (int i = threadIdx.x; i < n * per; i += kThreads) {
      const int s = i / per, q = i - s * per;
      const int t = seg.t0[s] - a.p8 + 8 * q;
      const bool ok = t >= 0 && t < a.T;
      cp_async16(smem_u32(win + s * a.win + 8 * q),
                 ok ? a.x + (long long)seg.row[s] * a.T + t : a.x, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  } else {
    for (int i = threadIdx.x; i < n * a.win; i += kThreads) {
      const int s = i / a.win, e = i - s * a.win;
      const int t = seg.t0[s] - a.p8 + e;
      win[i] = (t >= 0 && t < a.T) ? a.x[(long long)seg.row[s] * a.T + t] : __float2bfloat16_rn(0.f);
    }
  }
}

// acc[i] = sum_j w[j] x[t + i + j D - p] for the unit whose window piece starts at src
// (time t - p8): the taps at compile-time positions, picked from registers
template <int D>
__device__ __forceinline__ void taps(const bf16* src, const float* w, float* acc) {
  constexpr int P = D * (kK - 1) / 2, P8 = (P + 7) / 8 * 8, NV = 2 * P8 / 8 + 1;
  uint4 r[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) r[q] = reinterpret_cast<const uint4*>(src)[q];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int j = 0; j < kK; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(w[j], elem(r, P8 - P + j * D + i), acc[i]);
}

// kVec: 16-byte copies and stores
template <int D, bool kVec>
__global__ void __launch_bounds__(kThreads) dwconv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Seg seg;
  bf16* win = reinterpret_cast<bf16*>(smem);
  const int n = describe(a, seg, blockIdx.x * a.segs);
  __syncthreads();
  stage<kVec>(a, seg, win, n);
  __syncthreads();
  const int units = a.len / 8;
  for (int u = threadIdx.x; u < n * units; u += kThreads) {
    const int s = u / units;
    const int t = seg.t0[s] + 8 * (u - s * units);
    if (t >= a.T) continue;
    float w[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) w[j] = seg.w[s][j];
    float acc[8];
    taps<D>(win + s * a.win + 8 * (u - s * units), w, acc);
    Vec8 y;
#pragma unroll
    for (int m = 0; m < 4; ++m) y.h[m] = __floats2bfloat162_rn(acc[2 * m], acc[2 * m + 1]);
    if (a.bias) {
      const bf16 b = __float2bfloat16_rn(seg.w[s][kK]);
      const __nv_bfloat162 bb = __halves2bfloat162(b, b);
#pragma unroll
      for (int m = 0; m < 4; ++m) y.h[m] = __hadd2(y.h[m], bb);
    }
    bf16* dst = a.out + (long long)seg.row[s] * a.T + t;
    if (kVec) {
      *reinterpret_cast<uint4*>(dst) = y.v;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (t + i < a.T) dst[i] = y.e[i];
    }
  }
}

template <int D>
cudaError_t launch(const Args& a, bool vec, int blocks, size_t smem, cudaStream_t s) {
  if (vec)
    dwconv_kernel<D, true><<<blocks, kThreads, smem, s>>>(a);
  else
    dwconv_kernel<D, false><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int nawc_dwconv(const void* x, const float* w, const float* bias, void* out, int B, int C,
                           int T, int k, int d, void* stream) {
  if (B < 0 || C < 0 || T < 0 || k != kK || (d != 1 && d != 3 && d != 9) || ((uintptr_t)x & 1) ||
      ((uintptr_t)out & 1) || ((uintptr_t)w & 3) || ((uintptr_t)bias & 3))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * C * T == 0) return 0;
  Args a;
  a.x = (const bf16*)x;
  a.w = w;
  a.bias = bias;
  a.out = (bf16*)out;
  a.C = C;
  a.T = T;
  a.p8 = (d * (kK - 1) / 2 + 7) / 8 * 8;
  a.nseg = (int)(((long long)T + kTile - 1) / kTile);
  a.len = ((T + a.nseg - 1) / a.nseg + 7) / 8 * 8;
  a.segs = kTile / a.len < kMaxSegs ? kTile / a.len : kMaxSegs;
  a.win = a.len + 2 * a.p8;
  const long long total = (long long)B * C * a.nseg;
  if (total > 0x7fffffffLL - kMaxSegs) return (int)cudaErrorInvalidValue;
  a.total = (int)total;
  const int blocks = (a.total + a.segs - 1) / a.segs;
  const size_t smem = (size_t)a.segs * a.win * sizeof(bf16);
  const bool vec = T % 8 == 0 && ((uintptr_t)x & 15) == 0 && ((uintptr_t)out & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 1) return (int)launch<1>(a, vec, blocks, smem, s);
  if (d == 3) return (int)launch<3>(a, vec, blocks, smem, s);
  return (int)launch<9>(a, vec, blocks, smem, s);
}
