// Whiten + correlate for the spread-spectrum detector.
//
// Replaces the TPU kernel nawc_tpu/ops/sswm.py::_whiten_correlate_pallas
// (body `_kernel`).  For the band residual r (B, T, W) and the K raw
// patterns p (K, T, W) it writes the calibrated statistics z (B, K):
//     rs[b, t, w]   = r[b, t, w] * scale[b, w] - shift[b, w]
//                     (scale = 1 / (std_t r + 0.2), shift = mean_t r * scale)
//     c[b, j, k]    = sum_{t, w} rs[b, t, w] * p[k, (t - o_j) mod T, w]
//     z[b, k]       = c[b, 0, k] / (sqrt(mean_{j >= 1, k'} c[b, j, k']^2) + 1e-8)
// with o_0 = 0 (the true patterns) and o_1.. the null rolls.  rs has zero
// time-sum per (b, w), so sum_t rs * (p - mean_t p) = sum_t rs * p: the
// patterns need no centring, and p is read as it is.
//
// What bounds it on an H100 (main path: B=16, T=376, W=367, K=16, NV=7):
//   bytes  r + p = 2 * 16*376*367*4 B = 17.7 MB -> 5.3 us at 3.35 TB/s;
//   ops    NV*2 flops per (b, k, t, w) = 0.494 GFLOP, run on the tensor
//          cores in TF32 with three passes (below): 1.48 GFLOP at
//          495 TFLOP/s = 3.0 us, plus 3 f32 flops per residual cell for the
//          statistics (7 MFLOP, 0.1 us at 67 TFLOP/s).
// So bytes bound it: 5.3 us.
//
// Design: the contraction is a (B, T*W) x (T*W, NV*K) product against the
// rolled pattern stack, which is never built: a block gathers the rolled
// rows from one pattern window in shared memory.  It runs as
// mma.sync.m16n8k8 in TF32 on the tensor cores, with B as the 16 rows of
// the product.  Each f32 operand is split x = hi + lo, both exact in TF32,
// and a product is hi*hi + hi*lo + lo*hi: three mma passes that keep about
// f32 accuracy (z within a few 1e-6 of the f32 sums), where one TF32 pass
// would put z errors near the 1e-3 bar.  The mma loop issues a fraction of
// the instructions of an FFMA loop over the same tiles (which needed a
// shared load per 7 FMAs); what sets the contraction's time now is the
// staging of the tiles: 4-byte copies of 32-byte row pieces, since rows of
// W = 367 floats are not 16-byte aligned, and a pattern window 85 rows
// tall for 32 frames.
// Four launches from one entry:
//   1. stats: one block column per (b, 32 bins); each thread holds its rows
//      in registers, so both passes over T (mean, then squared deviations)
//      cost one round of loads; they write scale and shift.
//   2. correlate: a unit is a tile of 32 frames x 8 bins.  A block stages in
//      shared memory by cp.async (every load of a unit in flight at once,
//      each thread with a fixed role, so that a load costs a few
//      instructions) the residual tile for a 16-row b-tile, scaled there in
//      place, and, for a 16-pattern k-tile, the pattern rows
//      [t0 - max o, t0 + 32) with cyclic wrap, so every variant's rolled rows
//      are in one window.  Each of the 8 warps takes 4 frames, one mma
//      k-step of 8 bins each, and keeps NV x 2 C fragments (16 b x 16 k per
//      variant) in registers, one instance per NV (on an H100 one NV = 8
//      instance that skips the variants past a run-time NV spilled and ran
//      15% slower at NV = 7).  Blocks walk units with a grid stride G
//      (chosen here from the SM count, about 2 blocks per SM) and keep their
//      sums across units; at the end the 8
//      warps' sums are added in warp order through shared memory and the
//      block writes its (B, NV, K) partial to scratch.
//   3. reduce: one warp per (b, j, k) adds the block partials in a fixed
//      order (lane l takes partials l, l+32, ..., then a fixed shuffle tree).
//   4. calibrate: one block per b computes z.
// No float atomics: two runs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVariants = 8;
constexpr int kThreads = 256;
constexpr int kTT = 32;        // frames per unit
constexpr int kWC = 8;         // bins per unit
constexpr int kBT = 16;        // rows of a b-tile
constexpr int kKT = 16;        // patterns of a k-tile
constexpr int kCell = 24;      // floats per (frame, bin) cell of rs or p in shared memory:
                               // 16 b or k + pad, so that a fragment load hits 32 banks
constexpr int kRsRow = kWC * kCell + 4;  // floats per frame of rs (+ pad for the staging stores)
constexpr int kMaxRows = 256;  // window rows: kTT + the largest roll
constexpr int kMaxSmem = 232448;
constexpr int kBlocksPerSm = 2;
constexpr int kStatThreads = 512;
constexpr int kStatRows = 32;  // rows a stats thread holds: T <= 16 * 32 in one pass

struct Offsets {
  int o[kMaxVariants];  // o[0] = 0; each 0 <= o[j] < T
};

// Per-bin mean and population std over T; one column of threads per bin.
// A thread holds its rows in registers (up to kStatRows of them, T <= 512)
// so that all its loads are in flight at once and the second pass reads no
// memory; longer T loops over chunks and re-reads them from L1.
__global__ void __launch_bounds__(kStatThreads)
sswm_stats_kernel(const float* __restrict__ r, float* __restrict__ scale,
                  float* __restrict__ shift, int T, int W) {
  constexpr int kRowsY = kStatThreads / 32;
  __shared__ float red[kRowsY][33];
  const int b = blockIdx.y;
  const int w = blockIdx.x * 32 + threadIdx.x;
  const bool ok = w < W;
  const float* rb = r + (size_t)b * T * W + w;
  float v[kStatRows];
  float s = 0.f;
  for (int t0 = threadIdx.y; t0 < T; t0 += kRowsY * kStatRows) {
#pragma unroll
    for (int q = 0; q < kStatRows; ++q) {
      const int t = t0 + q * kRowsY;
      v[q] = ok && t < T ? rb[(size_t)t * W] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kStatRows; ++q) s += v[q];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  float mu = 0.f;
#pragma unroll
  for (int q = 0; q < kRowsY; ++q) mu += red[q][threadIdx.x];
  mu /= (float)T;
  __syncthreads();
  float var = 0.f;
  if (T <= kRowsY * kStatRows) {  // the rows are still in v
#pragma unroll
    for (int q = 0; q < kStatRows; ++q) {
      const float d = threadIdx.y + q * kRowsY < T && ok ? v[q] - mu : 0.f;
      var = fmaf(d, d, var);
    }
  } else {
    for (int t = threadIdx.y; t < T; t += kRowsY) {
      const float d = ok ? rb[(size_t)t * W] - mu : 0.f;
      var = fmaf(d, d, var);
    }
  }
  red[threadIdx.y][threadIdx.x] = var;
  __syncthreads();
  if (threadIdx.y == 0 && ok) {
    float tot = 0.f;
#pragma unroll
    for (int q = 0; q < kRowsY; ++q) tot += red[q][threadIdx.x];
    const float sc = 1.f / (sqrtf(tot / (float)T) + 0.2f);
    scale[(size_t)b * W + w] = sc;
    shift[(size_t)b * W + w] = mu * sc;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both exact in TF32: the 3xTF32 split (hi*hi + hi*lo + lo*hi
// keeps the product to about f32 accuracy)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NV>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sswm_correlate_kernel(const float* __restrict__ r, const float* __restrict__ p,
                      const float* __restrict__ scale, const float* __restrict__ shift,
                      float* __restrict__ partial, int B, int T, int W, int K, int max_o,
                      Offsets offs) {
  extern __shared__ __align__(16) float smem[];
  float* rs_s = smem;                         // [kTT][kWC][kCell], frame stride kRsRow
  float* sc_s = rs_s + kTT * kRsRow;          // [kBT][kWC] scale, then shift
  float* sh_s = sc_s + kBT * kWC;
  int* row_s = reinterpret_cast<int*>(sh_s + kBT * kWC);  // [kTT + max_o] rows of p
  float* p_s = sh_s + kBT * kWC + kMaxRows;   // [kTT + max_o][kWC][kCell]

  const int n_kt = (K + kKT - 1) / kKT;
  const int b0 = (blockIdx.y / n_kt) * kBT;
  const int k0 = (blockIdx.y % n_kt) * kKT;
  const int n_wc = (W + kWC - 1) / kWC;
  const int n_units = ((T + kTT - 1) / kTT) * n_wc;
  const int rows = kTT + max_o;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // mma groupID: b row g (and g + 8), pattern column g
  const int q4 = lane & 3;   // mma threadID_in_group: bin q4 (and q4 + 4)

  // staging roles, fixed per thread: rs element (t, w) for every b of the
  // tile; p element (k, w) for every other window row
  const int st_w = tid & (kWC - 1), st_t = tid >> 3;
  const int sp_w = tid & (kWC - 1), sp_k = (tid >> 3) & (kKT - 1), sp_i0 = tid >> 7;

  int roff[NV];  // window row of frame 0 for each variant, in floats
#pragma unroll
  for (int j = 0; j < NV; ++j) roff[j] = (max_o - offs.o[j]) * kWC * kCell;

  float acc[NV][2][4];  // per variant, per half of the k-tile: the mma C fragment
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[j][h][c] = 0.f;

  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    const int t0 = (u / n_wc) * kTT;
    const int w0 = (u % n_wc) * kWC;
    __syncthreads();  // the previous unit's compute is done with the tiles
    for (int i = tid; i < rows; i += kThreads) {
      int s = (t0 - max_o + i) % T;
      row_s[i] = s < 0 ? s + T : s;
    }
    {  // raw r, scale and shift by cp.async (zero-filled outside the arrays)
      const int tt = t0 + st_t, ww = w0 + st_w;
      const bool ok = tt < T && ww < W;
      const float* src = r + ((size_t)b0 * T + tt) * W + ww;
      float* dst = rs_s + st_t * kRsRow + st_w * kCell;
#pragma unroll 4
      for (int bl = 0; bl < kBT; ++bl) {
        const bool v = ok && b0 + bl < B;
        cp_async4(dst + bl, v ? src + (size_t)bl * T * W : r, v);
      }
      if (tid < kBT * kWC) {
        const int b = b0 + (tid >> 3), w = w0 + (tid & (kWC - 1));
        const bool v = b < B && w < W;
        const size_t sw = v ? (size_t)b * W + w : 0;
        cp_async4(sc_s + tid, scale + sw, v);
        cp_async4(sh_s + tid, shift + sw, v);
      }
    }
    __syncthreads();  // row_s
    {
      const bool ok = k0 + sp_k < K && w0 + sp_w < W;
      const float* src = p + (size_t)(ok ? k0 + sp_k : 0) * T * W + (ok ? w0 + sp_w : 0);
#pragma unroll 4
      for (int i = sp_i0; i < rows; i += kThreads / (kKT * kWC)) {
        cp_async4(p_s + (i * kWC + sp_w) * kCell + sp_k, src + (size_t)row_s[i] * W, ok);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    {  // rs = r * scale - shift in place, with no fused multiply-add, as the
       // plain version rounds it (at T = 1, rs = 0 exactly); frames past T stay 0
      float* e = rs_s + st_t * kRsRow + st_w * kCell;
      const bool ok = t0 + st_t < T;
#pragma unroll 4
      for (int bl = 0; bl < kBT; ++bl)
        e[bl] = ok ? __fmul_rn(e[bl], sc_s[bl * kWC + st_w]) - sh_s[bl * kWC + st_w] : 0.f;
    }
    __syncthreads();

    // warp: frames warp*4 .. warp*4+3 of the unit, each one k-step of 8 bins
#pragma unroll 1
    for (int tl = 0; tl < kTT / 8; ++tl) {
      const int t = warp * (kTT / 8) + tl;
      const float* ra = rs_s + t * kRsRow;
      uint32_t a_hi[4], a_lo[4];
      split_tf32(ra[q4 * kCell + g], a_hi[0], a_lo[0]);
      split_tf32(ra[q4 * kCell + g + 8], a_hi[1], a_lo[1]);
      split_tf32(ra[(q4 + 4) * kCell + g], a_hi[2], a_lo[2]);
      split_tf32(ra[(q4 + 4) * kCell + g + 8], a_hi[3], a_lo[3]);
      const float* pb = p_s + t * kWC * kCell + q4 * kCell + g;
      // per half of the k-tile: the NV B fragments split first, then the
      // three passes, each NV independent mma
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bh[NV][2], bl[NV][2];
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          split_tf32(pb[roff[j] + h * 8], bh[j][0], bl[j][0]);
          split_tf32(pb[roff[j] + 4 * kCell + h * 8], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int j = 0; j < NV; ++j) mma_tf32(acc[j][h], a_lo, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < NV; ++j) mma_tf32(acc[j][h], a_hi, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < NV; ++j) mma_tf32(acc[j][h], a_hi, bh[j][0], bh[j][1]);
      }
    }
  }

  // the 8 warps' sums, added in warp order: red[warp][slot][lane]
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * NV * 8 + j * 8 + h * 4 + c) * 32 + lane] = acc[j][h][c];
  __syncthreads();
  const int G = gridDim.x;
  for (int e = tid; e < NV * 8 * 32; e += kThreads) {
    const int ln = e & 31;
    const int slot = e >> 5;
    float v = 0.f;
#pragma unroll
    for (int q = 0; q < kThreads / 32; ++q) v += red[(q * NV * 8 + slot) * 32 + ln];
    const int j = slot >> 3, h = (slot >> 2) & 1, c = slot & 3;
    const int b = b0 + (ln >> 2) + (c >> 1) * 8;            // C rows g, g + 8
    const int k = k0 + h * 8 + (ln & 3) * 2 + (c & 1);        // C columns 2 q4, 2 q4 + 1
    if (b < B && k < K) partial[(((size_t)b * NV + j) * K + k) * G + blockIdx.x] = v;
  }
}

// c[e] = the G partials of entry e = (b, j, k), added in a fixed order: one
// warp per entry, lane l taking partials l, l+32, ... in four running sums,
// then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
sswm_reduce_kernel(const float* __restrict__ partial, float* __restrict__ c, int n, int G) {
  const int e = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n) return;
  const float* src = partial + (size_t)e * G;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int g0 = lane; g0 < G; g0 += 128) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int g = g0 + 32 * q;
      if (g < G) v[q] += src[g];
    }
  }
  float sum = (v[0] + v[1]) + (v[2] + v[3]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (lane == 0) c[e] = sum;
}

// One block per b: z[b, k] = c[b, 0, k] / (rms of the nulls c[b, j >= 1, :] + 1e-8).
__global__ void __launch_bounds__(kThreads)
sswm_calibrate_kernel(const float* __restrict__ c, float* __restrict__ z, int NV, int K) {
  __shared__ float red[kThreads / 32];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* cb = c + (size_t)b * NV * K;
  float ss = 0.f;
  for (int e = K + threadIdx.x; e < NV * K; e += kThreads) ss = fmaf(cb[e], cb[e], ss);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, s);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
#pragma unroll
  for (int q = 0; q < kThreads / 32; ++q) tot += red[q];
  const float sigma = sqrtf(tot / (float)((NV - 1) * K));
  for (int k = threadIdx.x; k < K; k += kThreads) z[(size_t)b * K + k] = cb[k] / (sigma + 1e-8f);
}

template <int NV>
int launch_correlate(const float* r, const float* p, const float* scale, const float* shift,
                     float* partial, int B, int T, int W, int K, int max_o, const Offsets& offs,
                     dim3 grid, size_t bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(sswm_correlate_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  sswm_correlate_kernel<NV><<<grid, kThreads, bytes, stream>>>(r, p, scale, shift, partial, B, T,
                                                               W, K, max_o, offs);
  return (int)cudaGetLastError();
}

constexpr int (*kLaunchCorrelate[kMaxVariants])(const float*, const float*, const float*,
                                                const float*, float*, int, int, int, int, int,
                                                const Offsets&, dim3, size_t, cudaStream_t) = {
    launch_correlate<1>, launch_correlate<2>, launch_correlate<3>, launch_correlate<4>,
    launch_correlate<5>, launch_correlate<6>, launch_correlate<7>, launch_correlate<8>};

// G, the blocks per (b-tile, k-tile) pair: about kBlocksPerSm blocks per SM
// of the current device in all, and never more than the units of work
int grid_stride(int B, int T, int W, int K, int* G) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int units = ((T + kTT - 1) / kTT) * ((W + kWC - 1) / kWC);
  const int pairs = ((B + kBT - 1) / kBT) * ((K + kKT - 1) / kKT);
  const int g = (kBlocksPerSm * sms + pairs - 1) / pairs;
  *G = g < units ? (g > 1 ? g : 1) : units;
  return 0;
}

bool valid_shape(int B, int T, int W, int K, int n_variants) {
  return B >= 1 && T >= 1 && W >= 1 && K >= 1 && n_variants >= 1 && n_variants <= kMaxVariants;
}

}  // namespace

// The floats of scratch that nawc_whiten_correlate needs for these shapes
// on the current device: per-bin scale and shift (2 B W), then the
// (B, NV, K) partials of the G blocks of each tile pair, then their sums.
extern "C" int nawc_whiten_correlate_scratch(int B, int T, int W, int K, int n_variants,
                                             size_t* floats) {
  if (!valid_shape(B, T, W, K, n_variants)) return (int)cudaErrorInvalidValue;
  int G;
  const int err = grid_stride(B, T, W, K, &G);
  if (err != 0) return err;
  *floats = 2 * (size_t)B * W + (size_t)B * n_variants * K * (G + 1);
  return 0;
}

// r (B, T, W), p (K, T, W) raw patterns; scratch as sized by
// nawc_whiten_correlate_scratch; z (B, K) the result.  offsets[0] = 0,
// every offset lies in [0, T), and the largest at most kMaxRows - kTT.
extern "C" int nawc_whiten_correlate(const float* r, const float* p, float* scratch, float* z,
                                     int B, int T, int W, int K, const int* offsets,
                                     int n_variants, void* stream) {
  if (!valid_shape(B, T, W, K, n_variants)) return (int)cudaErrorInvalidValue;
  Offsets offs;
  int max_o = 0;
  for (int j = 0; j < kMaxVariants; ++j) {
    offs.o[j] = j < n_variants ? offsets[j] : 0;
    if (offs.o[j] < 0 || offs.o[j] >= T) return (int)cudaErrorInvalidValue;
    max_o = offs.o[j] > max_o ? offs.o[j] : max_o;
  }
  if (kTT + max_o > kMaxRows) return (int)cudaErrorInvalidValue;
  int G;
  int rc = grid_stride(B, T, W, K, &G);
  if (rc != 0) return rc;
  const size_t stage = (size_t)kTT * kRsRow + 2 * kBT * kWC + kMaxRows +
                       (size_t)(kTT + max_o) * kWC * kCell;
  const size_t reduce = (size_t)(kThreads / 32) * n_variants * 8 * 32;
  const size_t bytes = 4 * (stage > reduce ? stage : reduce);
  if (bytes > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  float* scale = scratch;
  float* shift = scale + (size_t)B * W;
  float* partial = shift + (size_t)B * W;
  const int n = B * n_variants * K;
  float* c = partial + (size_t)n * G;
  cudaStream_t s = (cudaStream_t)stream;

  sswm_stats_kernel<<<dim3((W + 31) / 32, B), dim3(32, kStatThreads / 32), 0, s>>>(r, scale, shift,
                                                                                T, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, ((B + kBT - 1) / kBT) * ((K + kKT - 1) / kKT));
  rc = kLaunchCorrelate[n_variants - 1](r, p, scale, shift, partial, B, T, W, K, max_o, offs, grid,
                                        bytes, s);
  if (rc != 0) return rc;
  sswm_reduce_kernel<<<(n + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0, s>>>(partial, c, n, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sswm_calibrate_kernel<<<B, kThreads, 0, s>>>(c, z, n_variants, K);
  return (int)cudaGetLastError();
}
