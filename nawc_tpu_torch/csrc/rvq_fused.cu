// Fused multi-level residual-VQ encode.
//
// Replaces the TPU kernel nawc_tpu/ops/rvq_fused.py::_rvq_encode_pallas
// (body `_fused_kernel`).  For the latents z (B, T, Dl) and, per level l with
// stride s_l, in_proj (Dl, C) + bias, out_proj (C, Dl) + bias, the codebook
// cb (K, C) and its L2-normalised copy cbn (K, C), it runs for every level:
//   pool the residual by s_l (mean) -> in_proj -> L2-normalise -> cosine
//   scores against cbn -> first-index argmax -> code; dequantise by the
//   gather cb[code] -> out_proj -> repeat s_l times -> subtract.
// The last level's residual is read by nobody, so its dequantise step is
// skipped.  The TPU kernel's one-hot matmul and transposed tables were
// Mosaic workarounds; this kernel gathers.
//
// What bounds it on an H100 (main path: B=16, T=192, Dl=768, C=8, K=4096,
// strides 4/2/1 -> 768 + 1536 + 3072 = 5376 pooled frames), counting only
// the work that the codes need:
//   ops    scores 2*5376*4096*8 = 352 MFLOP; in_proj 2*5376*768*8 = 66 MFLOP;
//          out_proj for the first two levels 2*2304*8*768 = 28 MFLOP;
//          pooling adds (strides 4 and 2) and residual subtracts (first two
//          levels) 4 * 16*192*768 = 9 MFLOP -> 0.456 GFLOP of f32 FMA
//          -> 6.8 us at 67 TFLOP/s;
//   bytes  z 16*192*768*4 B = 9.4 MB, one copy of the tables (no out_proj
//          for the last level) 0.5 MB, codes 21 KB -> 10.0 MB -> 3.0 us at
//          3.35 TB/s.
// So it is bound by f32 operations.
//
// The first design (one block per 8 full-rate frames of one clip, holding
// all Dl channels) took 0.21 ms, 30x the bound.  Its 384 blocks of 256
// threads fit in one wave, so the time was one block's serial chain: each
// block streamed every level's whole normalised codebook (128 KB) from L2
// through one 16 KB chunk with no copy in flight during compute (151 MB of
// L2 reads where the function needs 10 MB), with 2-8 pooled frames a block
// each code row it loaded fed only 16-64 multiply-adds, and in_proj ran one
// warp per (frame, channel) over 24 dependent steps.
//
// This design gives each block a tile of 24 full-rate frames of one clip
// (a ragged last tile allowed) with all Dl channels: 128 blocks of 512
// threads at the main shape, one per SM, one wave, and nothing crosses
// blocks.  (A design that split the channels and the codebook over
// thread-block clusters of 8 was tried first: its two cluster-wide
// exchanges per level and its 768 blocks in three rounds cost more than its
// scores.)  A block:
//   - copies its residual tile (24 x 768 floats), level 0's in_proj and
//     level 0's normalised codebook (4096 x 8 floats, 128 KB) into shared
//     memory by cp.async; level l+1's in_proj is copied while level l
//     scores, its codebook while level l dequantises, so each block reads
//     each table from L2 once (49 MB of codebook reads over the grid, not
//     151).  The wrapper stores in_proj and the normalised codebook as C/4
//     planes of float4s (plane q holds float4 q of every row), so that
//     lanes reading neighbouring rows read neighbouring 16 bytes;
//   - per level, in_proj + bias + L2-normalise of the pooled frames: a warp
//     takes F frames (3 at C = 8, else 1) and a range of channels, its
//     lanes keep F x C sums over their channels (each in_proj row read
//     feeds F x C multiply-adds), the lanes' sums add by halving shuffles
//     and the ranges' in order;
//   - scores in f32 FMA on the CUDA cores (TF32 would break the 1e-4
//     near-tie rule of ops/parity.py): each thread holds R codes (R x C
//     floats, R = 32 / C) in registers, reads up to 12 pooled frames from
//     shared memory as broadcasts and keeps a running (score, index) per
//     frame with strict `>` over its increasing indices; the threads' pairs
//     then merge by halving shuffles and over the warps by "larger score,
//     else smaller index", which is jnp.argmax's first-index rule whatever
//     the split;
//   - dequantises by the gathered raw code rows and out_proj (its columns
//     loaded during the merge), and subtracts from its residual tile in
//     shared memory.
// scripts/torch_rvq_fused_phases.py times these phases on the card.
// Where a level's codebook does not fit beside the tile and in_proj (a
// larger K or C) it streams through the space left, chunk by chunk.  One
// launch, no atomics, every sum in a fixed order: the same codes on every
// run.  C is a template parameter (8, 16 or 32); the wrapper zero-pads other
// C.  Strides must divide 24 and T; what the kernel does not take (also Dl
// over about 1790 at C = 8, where the tile and in_proj fill shared memory)
// it refuses with cudaErrorInvalidValue.

#include <cuda_runtime.h>
#include <math_constants.h>

// Phase boundaries of a block: scripts/torch_rvq_fused_phases.py defines this
// to record a timestamp; in the library it is nothing.
#ifndef NAWC_PHASE
#define NAWC_PHASE(i)
#endif

namespace {

constexpr int kTile = 24;  // full-rate frames per block: a multiple of every stride
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kFrames = kTile / 2;  // pooled frames a thread scores at once
constexpr int kArgmaxKeep = 3;      // frames a lane holds after lane_argmax<kFrames, 16>
constexpr int kMaxLevels = 8;
constexpr int kNone = 0x7fffffff;  // index of "no code yet"

struct Levels {
  int n;
  int stride[kMaxLevels];
  long long code_offset[kMaxLevels];  // start of level l's (B, T / s_l) codes
};

__device__ __forceinline__ bool better(float s, int i, float best, int best_i) {
  return s > best || (s == best && i < best_i);
}

__device__ __forceinline__ void take_better(float s, int i, float& best, int& best_i) {
  if (better(s, i, best, best_i)) {
    best = s;
    best_i = i;
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most `pending` (0 or 1) of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending > 0)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// `n` floats from global `src` to shared `dst`, by every thread; 16-byte
// copies where both are 16-byte aligned and n % 4 == 0
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, bool by16) {
  if (by16) {
    for (int e = threadIdx.x * 4; e < n; e += kThreads * 4) cp_async16(dst + e, src + e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads) cp_async4(dst + e, src + e);
  }
}

// Sum each of the N values over the 32 lanes: while N is even, a lane keeps
// half of its values and adds the partner's copy of that half (one shuffle
// a value), else it adds the partner's whole set.  Ends with the N / 2^h
// sums base .. base + N / 2^h - 1 in v[0 ..], the same on every lane that
// holds that range; a fixed order of additions.
template <int N, int M>
__device__ __forceinline__ void lane_sum(float* v, int& base, int lane) {
  if constexpr (M > 0) {
    if constexpr (N % 2 == 0) {
      const bool hi = (lane & M) != 0;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = hi ? v[i] : v[N / 2 + i];
        const float mine = hi ? v[N / 2 + i] : v[i];
        v[i] = mine + __shfl_xor_sync(0xffffffffu, send, M);
      }
      if (hi) base += N / 2;
      lane_sum<N / 2, M / 2>(v, base, lane);
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], M);
      lane_sum<N, M / 2>(v, base, lane);
    }
  }
}

// The running (score, index) pairs of N frames merge over the 32 lanes as
// lane_sum adds, by "larger score, else smaller index"; ends with the pairs
// of frames base .. base + N / 2^h - 1 in v[0 ..], i[0 ..].
template <int N, int M>
__device__ __forceinline__ void lane_argmax(float* v, int* i, int& base, int lane) {
  if constexpr (M > 0) {
    if constexpr (N % 2 == 0) {
      const bool hi = (lane & M) != 0;
#pragma unroll
      for (int k = 0; k < N / 2; ++k) {
        const float sv = hi ? v[k] : v[N / 2 + k];
        const int si = hi ? i[k] : i[N / 2 + k];
        float mv = hi ? v[N / 2 + k] : v[k];
        int mi = hi ? i[N / 2 + k] : i[k];
        take_better(__shfl_xor_sync(0xffffffffu, sv, M), __shfl_xor_sync(0xffffffffu, si, M), mv,
                    mi);
        v[k] = mv;
        i[k] = mi;
      }
      if (hi) base += N / 2;
      lane_argmax<N / 2, M / 2>(v, i, base, lane);
    } else {
#pragma unroll
      for (int k = 0; k < N; ++k)
        take_better(__shfl_xor_sync(0xffffffffu, v[k], M), __shfl_xor_sync(0xffffffffu, i[k], M),
                    v[k], i[k]);
      lane_argmax<N, M / 2>(v, i, base, lane);
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
rvq_encode_kernel(const float* __restrict__ z, const float* __restrict__ ink,
                  const float* __restrict__ inb, const float* __restrict__ outk,
                  const float* __restrict__ outb, const float* __restrict__ cbn,
                  const float* __restrict__ cbr, int* __restrict__ codes, int T, int Dl, int K,
                  int tiles_per_clip, int chunk, Levels lv) {
  constexpr int R = 32 / C;  // codes a thread holds in registers at once
  constexpr int F = C == 8 ? 3 : 1;  // pooled frames a warp projects at once (odd)
  constexpr int kPre = C == 8 ? 3 : 1;  // dequantise items a thread starts with prefetched columns
  constexpr int kPart = (kWarps > kTile / F ? kWarps : kTile / F) * F * C;  // s_part floats
  extern __shared__ __align__(16) float smem[];
  // in_proj and the codebook come as C / 4 planes of float4s (plane q holds
  // float4 q of every row), so that lanes reading neighbouring rows read
  // neighbouring 16 bytes of shared memory
  float* s_ink = smem;                  // Dl rows: a level's in_proj
  float* s_cb = smem + (size_t)Dl * C;  // chunk rows: a level's codebook, or a chunk
  float* s_res = s_cb + (size_t)chunk * C;      // kTile x Dl: the residual tile
  // normalised pooled frames until the scores are done, then the raw code
  // rows to dequantise
  __shared__ __align__(16) float s_zq[kTile][C];
  // in_proj's partial sums, then each warp's best (score, index) per frame
  __shared__ float s_scratch[kPart > 2 * kWarps * kFrames ? kPart : 2 * kWarps * kFrames];
  float* s_part = s_scratch;
  float(*s_wbest)[kFrames] = reinterpret_cast<float(*)[kFrames]>(s_scratch);
  int(*s_widx)[kFrames] = reinterpret_cast<int(*)[kFrames]>(s_scratch + kWarps * kFrames);

  const int b = blockIdx.x / tiles_per_clip;
  const int t0 = (blockIdx.x - b * tiles_per_clip) * kTile;
  const int rows = min(kTile, T - t0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int L = lv.n;
  const bool resident = chunk >= K;  // a whole level's codebook, copied a level ahead
  NAWC_PHASE(0);
  const float* zt = z + ((size_t)b * T + t0) * Dl;
  copy_async(s_res, zt, rows * Dl, (Dl & 3) == 0 && (reinterpret_cast<size_t>(zt) & 15) == 0);
  copy_async(s_ink, ink, Dl * C, true);
  cp_async_commit();
  if (resident) {
    copy_async(s_cb, cbn, K * C, true);
    cp_async_commit();
  }
  cp_async_wait(resident ? 1 : 0);  // the tile and in_proj; the codebook may be in flight
  __syncthreads();
  NAWC_PHASE(1);

  for (int l = 0; l < L; ++l) {
    const int s = lv.stride[l];
    const int P = rows / s;  // pooled frames of this tile
    const float inv_s = 1.f / (float)s;
    const float bias_c = inb[l * C + tid % C];  // the bias this thread adds in step 1

    // 1. z_e = mean-pool(res) @ in_proj + bias.  A warp takes F frames and
    //    one of `splits` channel ranges: its lanes split the range and keep
    //    F x C sums, so each in_proj row read from shared memory feeds F x C
    //    multiply-adds; the lanes' sums add by halving shuffles, the ranges'
    //    in order through s_part
    const int pf = kTile / s;  // pooled frames of a full tile
    const int fgroups = (pf + F - 1) / F;
    const int splits = kWarps > fgroups ? kWarps / fgroups : 1;
    const int span_d = (Dl + 32 * splits - 1) / (32 * splits) * 32;  // channels a range
    for (int item = warp; item < fgroups * splits; item += kWarps) {
      const int g = item / splits, sp = item - g * splits;
      float acc[F * C];
#pragma unroll
      for (int v = 0; v < F * C; ++v) acc[v] = 0.f;
      const int d_hi = min(Dl, (sp + 1) * span_d);
      for (int d = sp * span_d + lane; d < d_hi; d += 32) {
        float p[F];
#pragma unroll
        for (int i = 0; i < F; ++i) {
          const int f = min(g * F + i, P - 1);  // past P: a copy, never written
          p[i] = 0.f;
          for (int q = 0; q < s; ++q) p[i] += s_res[(f * s + q) * Dl + d];
          p[i] *= inv_s;
        }
        const float4* w = reinterpret_cast<const float4*>(s_ink) + d;
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 v = w[q * Dl];
#pragma unroll
          for (int i = 0; i < F; ++i) {
            acc[i * C + 4 * q] = fmaf(p[i], v.x, acc[i * C + 4 * q]);
            acc[i * C + 4 * q + 1] = fmaf(p[i], v.y, acc[i * C + 4 * q + 1]);
            acc[i * C + 4 * q + 2] = fmaf(p[i], v.z, acc[i * C + 4 * q + 2]);
            acc[i * C + 4 * q + 3] = fmaf(p[i], v.w, acc[i * C + 4 * q + 3]);
          }
        }
      }
      int base = 0;
      lane_sum<F * C, 16>(acc, base, lane);
      // this lane now holds sums base .. base + F - 1 of the warp's (frame, c)
#pragma unroll
      for (int v = 0; v < F; ++v) s_part[(sp * fgroups + g) * F * C + base + v] = acc[v];
    }
    NAWC_PHASE(2 + 8 * l);
    __syncthreads();
    const int n_out = fgroups * F * C;
    for (int o = tid; o < (n_out + 31) / 32 * 32; o += kThreads) {  // whole warps, C lanes a frame
      const int f = o / C, c = o - f * C;
      float v = 0.f;
      if (o < n_out) {
        for (int sp = 0; sp < splits; ++sp) v += s_part[sp * n_out + o];
        v += bias_c;
      }
      float ss = v * v;
#pragma unroll
      for (int sh = C / 2; sh > 0; sh >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, sh);
      if (o < n_out && f < P) s_zq[f][c] = v * rsqrtf(ss + 1e-8f);  // x * rsqrt(sum x^2 + 1e-8)
    }
    NAWC_PHASE(3 + 8 * l);
    if (resident) cp_async_wait(0);  // this level's codebook has landed
    __syncthreads();
    NAWC_PHASE(4 + 8 * l);
    if (l + 1 < L) {
      copy_async(s_ink, ink + (size_t)(l + 1) * Dl * C, Dl * C, true);
      cp_async_commit();
    }

    // 2. scores: the frames of a tile in groups of kFrames, each scored by
    //    `span` threads; per pass a thread holds the R codes j0 + i*span + gt
    const int span = kTile / s > kFrames ? kThreads / 2 : kThreads;  // whole warps
    const int g = tid / span, gt = tid - g * span;
    const int f0 = g * kFrames;  // the group's first frame
    float best[kFrames];
    int bidx[kFrames];
#pragma unroll
    for (int k = 0; k < kFrames; ++k) {
      best[k] = -CUDART_INF_F;
      bidx[k] = kNone;
    }
    const float* cbn_l = cbn + (size_t)l * K * C;
    for (int c0 = 0; c0 < K; c0 += chunk) {  // one pass when resident
      const int m = min(chunk, K - c0);
      if (!resident) {
        __syncthreads();  // the previous chunk is scored
        for (int q = 0; q < C / 4; ++q)
          copy_async(s_cb + (size_t)q * chunk * 4, cbn_l + ((size_t)q * K + c0) * 4, m * 4, true);
        cp_async_commit();
        cp_async_wait(0);
        __syncthreads();
      }
      for (int j0 = 0; j0 < m; j0 += R * span) {
        float cv[R][C];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int j = j0 + i * span + gt;
          const float4* row = reinterpret_cast<const float4*>(s_cb) + (j < m ? j : 0);
#pragma unroll
          for (int q = 0; q < C / 4; ++q) {
            const float4 v = row[q * chunk];
            const bool in = j < m;  // a NaN row scores NaN, which never wins
            cv[i][4 * q] = in ? v.x : CUDART_NAN_F;
            cv[i][4 * q + 1] = in ? v.y : CUDART_NAN_F;
            cv[i][4 * q + 2] = in ? v.z : CUDART_NAN_F;
            cv[i][4 * q + 3] = in ? v.w : CUDART_NAN_F;
          }
        }
#pragma unroll
        for (int k = 0; k < kFrames; ++k) {
          if (f0 + k < P) {
            float sc[R];
#pragma unroll
            for (int i = 0; i < R; ++i) sc[i] = 0.f;
#pragma unroll
            for (int q = 0; q < C / 4; ++q) {
              const float4 x = *reinterpret_cast<const float4*>(&s_zq[f0 + k][4 * q]);
#pragma unroll
              for (int i = 0; i < R; ++i) {
                sc[i] = fmaf(x.x, cv[i][4 * q], sc[i]);
                sc[i] = fmaf(x.y, cv[i][4 * q + 1], sc[i]);
                sc[i] = fmaf(x.z, cv[i][4 * q + 2], sc[i]);
                sc[i] = fmaf(x.w, cv[i][4 * q + 3], sc[i]);
              }
            }
#pragma unroll
            for (int i = 0; i < R; ++i) {
              if (sc[i] > best[k]) {  // increasing indices: strict > keeps the first
                best[k] = sc[i];
                bidx[k] = c0 + j0 + i * span + gt;
              }
            }
          }
        }
      }
    }

    NAWC_PHASE(5 + 8 * l);
    // the out_proj columns of this thread's first dequantise items (step 4),
    // loaded now so that their latency passes during the merge
    const float* outk_l = outk + (size_t)l * C * Dl;
    const float* outb_l = outb + (size_t)l * Dl;
    float w_pre[kPre][C], b_pre[kPre];
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int e = tid + u * kThreads;
      const int d = e % Dl;
      const bool ok = l + 1 < L && e < 2 * Dl;
#pragma unroll
      for (int c = 0; c < C; ++c) w_pre[u][c] = ok ? __ldg(outk_l + (size_t)c * Dl + d) : 0.f;
      b_pre[u] = ok ? __ldg(outb_l + d) : 0.f;
    }

    // 3. merge each frame's pairs over its group's lanes, then warps
    {
      int base = 0;
      lane_argmax<kFrames, 16>(best, bidx, base, lane);
      if ((lane & (32 * kArgmaxKeep / kFrames - 1)) == 0) {
#pragma unroll
        for (int k = 0; k < kArgmaxKeep; ++k) {
          s_wbest[warp][base + k] = best[k];
          s_widx[warp][base + k] = bidx[k];
        }
      }
    }
    __syncthreads();
    NAWC_PHASE(6 + 8 * l);
    if (tid < P) {
      const int k = tid % kFrames;
      const int w0 = (tid / kFrames) * (span / 32);  // the first warp of its group
      float bv = s_wbest[w0][k];
      int bi = s_widx[w0][k];
      for (int w = w0 + 1; w < w0 + span / 32; ++w) take_better(s_wbest[w][k], s_widx[w][k], bv, bi);
      if (bi >= K) bi = 0;  // every score was NaN
      codes[lv.code_offset[l] + (size_t)b * (T / s) + t0 / s + tid] = bi;
      if (l + 1 < L) {
#pragma unroll
        for (int c = 0; c < C; ++c) s_zq[tid][c] = cbr[((size_t)l * K + bi) * C + c];
      }
    }
    NAWC_PHASE(7 + 8 * l);
    if (l == L - 1) break;
    __syncthreads();

    // the next level's codebook, copied while this one dequantises
    if (resident) {
      copy_async(s_cb, cbn_l + (size_t)K * C, K * C, true);
      cp_async_commit();
    }

    // 4. dequantise: out_proj of each frame's code row + bias, subtracted
    //    from the s residual rows it covers.  An item is one channel and one
    //    half of the frames; thread t takes items t, t + 512, ...
    const int half = (P + 1) / 2;
    auto dequantise = [&](int e, const float* w, float bias) {
      const int d = e % Dl;
      const int f_lo = e < Dl ? 0 : half, f_hi = e < Dl ? half : P;
      for (int f = f_lo; f < f_hi; ++f) {
        float o = 0.f;
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          const float4 x = *reinterpret_cast<const float4*>(&s_zq[f][4 * q]);
          o = fmaf(x.x, w[4 * q], o);
          o = fmaf(x.y, w[4 * q + 1], o);
          o = fmaf(x.z, w[4 * q + 2], o);
          o = fmaf(x.w, w[4 * q + 3], o);
        }
        o += bias;
        for (int r = 0; r < s; ++r) s_res[(f * s + r) * Dl + d] -= o;
      }
    };
#pragma unroll
    for (int u = 0; u < kPre; ++u)
      if (tid + u * kThreads < 2 * Dl) dequantise(tid + u * kThreads, w_pre[u], b_pre[u]);
    for (int e = tid + kPre * kThreads; e < 2 * Dl; e += kThreads) {
      float w[C];
#pragma unroll
      for (int c = 0; c < C; ++c) w[c] = __ldg(outk_l + (size_t)c * Dl + e % Dl);
      dequantise(e, w, __ldg(outb_l + e % Dl));
    }
    NAWC_PHASE(8 + 8 * l);
    cp_async_wait(resident ? 1 : 0);  // the next level's in_proj
    __syncthreads();
    NAWC_PHASE(9 + 8 * l);
  }
}

template <int C>
int launch(const float* z, const float* ink, const float* inb, const float* outk,
           const float* outb, const float* cbn, const float* cbr, int* codes, int B, int T,
           int Dl, int K, const Levels& lv, cudaStream_t stream) {
  // shared memory: in_proj, the codebook (a whole level where it fits
  // beside the rest, else chunks), the residual tile
  int dev = 0, optin = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, rvq_encode_kernel<C>);
  if (e != cudaSuccess) return (int)e;
  const long long fixed = (long long)(C + kTile) * Dl * (long long)sizeof(float);
  const long long fit =
      ((long long)optin - (long long)fa.sharedSizeBytes - fixed) / (long long)(C * sizeof(float));
  if (fit < 1) return (int)cudaErrorInvalidValue;
  const int chunk = fit < K ? (int)fit : K;
  const size_t smem = (size_t)fixed + (size_t)chunk * C * sizeof(float);
  e = cudaFuncSetAttribute(rvq_encode_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int tiles_per_clip = (T + kTile - 1) / kTile;
  rvq_encode_kernel<C><<<B * tiles_per_clip, kThreads, smem, stream>>>(
      z, ink, inb, outk, outb, cbn, cbr, codes, T, Dl, K, tiles_per_clip, chunk, lv);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nawc_rvq_encode(const float* z, const float* ink, const float* inb,
                               const float* outk, const float* outb, const float* cbn,
                               const float* cbr, int* codes, int B, int T, int Dl, int C, int K,
                               const int* strides, int n_levels, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || Dl < 1 || K < 1 || B < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  long long off = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    lv.stride[l] = l < n_levels ? strides[l] : 1;
    lv.code_offset[l] = off;
    if (l < n_levels) {
      if (strides[l] < 1 || kTile % strides[l] != 0 || T % strides[l] != 0)
        return (int)cudaErrorInvalidValue;
      off += (long long)B * (T / strides[l]);
    }
  }
  if (B == 0 || T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 8: return launch<8>(z, ink, inb, outk, outb, cbn, cbr, codes, B, T, Dl, K, lv, s);
    case 16: return launch<16>(z, ink, inb, outk, outb, cbn, cbr, codes, B, T, Dl, K, lv, s);
    case 32: return launch<32>(z, ink, inb, outk, outb, cbn, cbr, codes, B, T, Dl, K, lv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
