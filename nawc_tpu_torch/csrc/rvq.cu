// Nearest-codebook lookup (cosine): the residual-VQ hot op.
//
// Replaces the TPU kernel nawc_tpu/ops/rvq.py::_nearest_codebook_pallas
// (body `_lookup_kernel`).  Given the frames z (N, d) and the L2-normalised
// codebook cbn (K, D), zero-padded to D >= d (normalised and padded once per
// codebook by the wrapper), it L2-normalises each frame in registers,
// x * rsqrt(sum(x^2) + 1e-8) as the JAX package does, and writes codes[n] =
// the first index of the largest score <zn[n], cbn[k]>.
//
// What bounds it on an H100 (main path: K=4096, D=8; one codec round-trip
// calls it at N = 768, 1536 and 3072 frames for the 16 x 4 s batch):
//   ops    2*N*K*D = 2 * 5376 * 4096 * 8 = 0.35 GFLOP of f32 FMA over the
//          three calls -> 5.3 us at 67 TFLOP/s;
//   bytes  z + cbn + codes = 5376*8*4 + 3 * 4096*8*4 + 5376*4 B = 0.6 MB
//          -> 0.2 us at 3.35 TB/s.
// So it is bound by f32 operations; at these sizes a launch (a few us)
// weighs as much as the work.
//
// Design: fill the card with thread-block clusters.  A cluster of 8 blocks
// shares one tile of 32 frames and splits the codebook in 8 slices, so
// N = 768 already gives 192 blocks.  In a block, lane f of every warp holds
// frame f in registers and warp w scores the codes w, w+8, ... of the slice
// (staged through shared memory in chunks); every lane of a warp reads the
// same code, a broadcast.  Scores are f32 FMA on the CUDA cores (TF32
// would break the 1e-4 near-tie rule of ops/parity.py).  Each thread keeps
// a running (score, index) with strict `>` over increasing indices; the 8
// warps' pairs and then the 8 blocks' pairs (read by rank 0 through
// distributed shared memory) are merged by "larger score, else smaller
// index", which is jnp.argmax's first-index rule whatever the split.  One
// launch, no atomics, the same codes on every run.
// D is a template parameter (8, 16 or 32); a frame of width d < D is
// zero-padded in registers, and the codebook by the wrapper, which changes
// no score.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;       // blocks per frame tile, one codebook slice each
constexpr int kFrames = 32;       // frames per tile: one per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunkFloats = 4096;  // 16 KB of codebook per staged chunk

__device__ __forceinline__ bool better(float s, int i, float best, int best_i) {
  return s > best || (s == best && i < best_i);
}

template <int D>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
nearest_codebook_kernel(const float* __restrict__ zr, const float* __restrict__ cbn,
                        int* __restrict__ codes, int N, int K, int dz) {
  constexpr int kChunk = kChunkFloats / D;
  __shared__ __align__(16) float s_cb[kChunkFloats];
  __shared__ float s_score[kWarps][kFrames];
  __shared__ int s_idx[kWarps][kFrames];
  __shared__ float s_best[kFrames];
  __shared__ int s_best_idx[kFrames];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = tile * kFrames + lane;

  float z[D];
  float ss = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    z[d] = n < N && d < dz ? zr[(size_t)n * dz + d] : 0.f;
    ss = fmaf(z[d], z[d], ss);
  }
  const float inv = rsqrtf(ss + 1e-8f);
#pragma unroll
  for (int d = 0; d < D; ++d) z[d] *= inv;

  const int per = (K + kCluster - 1) / kCluster;
  const int c_lo = min(K, rank * per);
  const int c_hi = min(K, c_lo + per);
  float best = -CUDART_INF_F;
  int best_idx = 0x7fffffff;
  for (int c0 = c_lo; c0 < c_hi; c0 += kChunk) {
    const int m = min(kChunk, c_hi - c0);
    __syncthreads();
    for (int e = threadIdx.x; e < m * D; e += kThreads) s_cb[e] = cbn[(size_t)c0 * D + e];
    __syncthreads();
    for (int c = warp; c < m; c += kWarps) {
      const float4* row = reinterpret_cast<const float4*>(s_cb + c * D);
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < D / 4; ++q) {
        const float4 v = row[q];
        s = fmaf(z[4 * q], v.x, s);
        s = fmaf(z[4 * q + 1], v.y, s);
        s = fmaf(z[4 * q + 2], v.z, s);
        s = fmaf(z[4 * q + 3], v.w, s);
      }
      if (s > best) {  // codes come in increasing order: strict > keeps the first
        best = s;
        best_idx = c0 + c;
      }
    }
  }

  s_score[warp][lane] = best;
  s_idx[warp][lane] = best_idx;
  __syncthreads();
  if (warp == 0) {
    for (int q = 1; q < kWarps; ++q) {
      if (better(s_score[q][lane], s_idx[q][lane], best, best_idx)) {
        best = s_score[q][lane];
        best_idx = s_idx[q][lane];
      }
    }
    s_best[lane] = best;
    s_best_idx[lane] = best_idx;
  }
  cluster.sync();  // every block's pair is in its shared memory
  if (rank == 0 && warp == 0) {
    for (int q = 1; q < kCluster; ++q) {
      const float s = *cluster.map_shared_rank(&s_best[lane], q);
      const int i = *cluster.map_shared_rank(&s_best_idx[lane], q);
      if (better(s, i, best, best_idx)) {
        best = s;
        best_idx = i;
      }
    }
    if (n < N) codes[n] = best_idx < K ? best_idx : 0;  // NaN scores: index 0
  }
  cluster.sync();  // keep the shared memory alive until rank 0 has read it
}

template <int D>
int launch(const float* z, const float* cbn, int* codes, int N, int K, int dz,
           cudaStream_t stream) {
  const int tiles = (N + kFrames - 1) / kFrames;
  nearest_codebook_kernel<D><<<tiles * kCluster, kThreads, 0, stream>>>(z, cbn, codes, N, K, dz);
  return (int)cudaGetLastError();
}

}  // namespace

// z (N, dz) raw frames; cbn (K, D) normalised codebook padded to D >= dz.
extern "C" int nawc_nearest_codebook(const float* z, const float* cbn, int* codes, int N, int K,
                                     int dz, int D, void* stream) {
  if (N <= 0) return 0;
  if (dz < 1 || dz > D || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 8: return launch<8>(z, cbn, codes, N, K, dz, s);
    case 16: return launch<16>(z, cbn, codes, N, K, dz, s);
    case 32: return launch<32>(z, cbn, codes, N, K, dz, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
