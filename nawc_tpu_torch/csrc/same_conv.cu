// Stride-1 convolutions of the bfloat16 codec on the tensor cores, with
// SAME padding, the bias and (optionally) a residual add in the kernel:
//     acc[b, co, t] = sum_j sum_ci x[b, ci, t + j d - p] W[co, ci, j]   (x = 0 outside [0, T))
//     y             = bf16(float(bf16(acc)) + bias[co])
//     out           = res ? bf16(float(res[b, co, t]) + float(y)) : y
// for a contiguous bfloat16 x (B, Cin, T), odd k <= 7, any dilation d with
// p = d (k - 1) / 2 <= 32, Cin and Cout multiples of 16; bias is float32
// holding bfloat16 values.  The rounding points are those of the codec's
// plain path (nawc_tpu_torch/ops/conv.py::conv_plain): the
// convolution rounds once to bfloat16, the bias is added in bfloat16, then
// ResidualUnit's x + y.  Only the float32 accumulation order differs.
//
// Replaces no Pallas kernel: the JAX package leaves its convolutions to XLA.
// On the card cuDNN ran the dilated 192- and 384-channel layers in an
// untensored implicit_convolve_sgemm<bf16>, the others behind NCHW <-> NHWC
// transposes, each after a padded copy of the activation (F.pad) and a cast
// of the weight and bias, with ResidualUnit's x + y a pass of its own.
//
// Bound on an H100 (the 50 stride-1 convolutions of one 16 x 4 s encode and
// decode): 2.09 TFLOP -> 2.1 ms at 989 TFLOP/s; 11.9 GB of activations read
// and written once -> 3.5 ms at 3.35 TB/s.  The 48- and 96-channel layers
// and every k = 1 layer are bound by bytes, the wider k = 7 layers by the
// tensor cores.
//
// Design.  A GEMM with M = time, N = Cout, K = Cin per tap, on persistent
// blocks that each walk the (batch, time) tiles of one channel tile:
//   * a tile is 256 times x 48 or 96 output channels.  A block has one
//     producer warpgroup and consumer warpgroups (four of 64 times at 48
//     channels, two of 128 at 96) that only issue wgmma (m64n48k16 or
//     m64n96k16, bf16 -> f32, both operands in shared memory) and write the
//     epilogue.  Named barriers hand each stage over (FULL) and back
//     (EMPTY), so the loads, transposes and MMAs of different stages
//     overlap, and the consumers run no address arithmetic of the loads;
//   * the input channels stream in stages of 16 channels.  The producer
//     copies a stage's x over the tile's times and the halo of the taps by
//     cp.async, 16 bytes a piece, several stages ahead, into a raw tile
//     [channel][time]; pieces outside [0, T) are zero-filled by the copy
//     itself, which is the SAME padding: no padded copy is made.  It then transposes the stage
//     (ldmatrix, stmatrix .trans) to K-major 8-channel groups of
//     [time][8 channels], 16 bytes a time: wgmma's no-swizzle layout with a
//     core matrix at any time, so every tap reads the same stage through a
//     descriptor shifted by j d - p rows, and x is loaded once for all k
//     taps and any dilation;
//   * the weights, laid out once as (k, Cout, Cin) bfloat16 by the caller,
//     stay in shared memory for the whole block where they fit beside the
//     stages, and otherwise stream with them (zero-filled past Cout), in the
//     same K-major layout;
//   * the epilogue rounds, adds the bias, stages the tile in shared memory
//     as [channel][time] and writes it, adding the residual, in 16-byte
//     stores along time, each round's residual loads issued before its
//     stores.
// A ragged T or misaligned x falls back to plain copies for the stage.
// Two runs give the same bits: every sum has a fixed order.
//
// k = 1 (nawc_k1conv): the same arithmetic as a GEMM per batch item,
// out[b] = W x[b], with M = output channels, N = time and K = input
// channels, on operands that already lie as wgmma reads them.  2 C_in C_out
// FLOPs an output time against 2 (C_in + C_out (+ C_out)) bytes: bound by
// bytes below 295 FLOP a byte (every layer of both codecs up to 512
// channels, and 768 with its residual), by the tensor cores above (SNAC's
// 768-channel noise-block conv and its 1024 -> 1536 head).
//   * TMA loads x in place from (B, C_in, T) in boxes of 64 channels x 64
//     times, 128-byte swizzled: wgmma's MN-major (transposed) B operand,
//     so there is no transpose and no producer arithmetic; the weights
//     (1, C_out, C_in) in boxes of 64 input channels x the tile's output
//     channels: the K-major A operand.  Zero-fill past T, C_in and C_out
//     and the clipped store handle every ragged edge (T = 480 at the SNAC
//     head).  T % 8 == 0 and 16-byte aligned x, residual and out: TMA's
//     rows are 16-byte multiples; the caller sends any other k = 1 conv to
//     the stencil kernel above;
//   * stages are 64 input channels, in an mbarrier ring as deep as shared
//     memory allows (3-5 stages of 32-48 KB), filled by one producer
//     thread; a tile is 64 channels x 256 times (C_out <= 64), 128 x 128
//     (C_out <= 128) or 128 x 256, two consumer warpgroups of 64 x 128 or
//     64 x 256 each (one m64nNk16 wgmma a 16-channel step);
//   * persistent blocks, one an SM, walk the tiles in an order that keeps
//     the output-channel tiles of one x tile next to each other, so x comes
//     from HBM once and from L2 for the rest;
//   * the epilogue rounds and adds the bias in registers and writes the
//     tile into a swizzled shared-memory buffer of its consumer, into which
//     TMA brought the residual tile while the main loop ran (a second
//     producer thread, double-buffered where the room allows); the sum is
//     stored by TMA while the consumer goes on to the next tile.
// Accumulation in float32 over 16-channel steps in channel order: two runs
// give the same bits.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <mutex>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kBM = 256;                 // output times a tile
constexpr int kKC = 16;                  // input channels a stage
constexpr int kWStages = 4;              // stages of streamed weights
constexpr int kYRow = kBM + 8;           // elements a row of the output staging
constexpr int kMaxK = 7, kMaxPad = 32;
constexpr int kSmemOptin = 232448;       // H100: a block's shared memory, at most

struct Args {
  const bf16* x;
  const bf16* w;      // (k, Cout, Cin)
  const float* bias;  // (Cout), bfloat16 values
  const bf16* res;    // (B, Cout, T) or null
  bf16* out;          // (B, Cout, T)
  int B, Cin, Cout, T, k, d, p;
  int p8;             // p rounded up to 8: a stage's row r is time t0 - p8 + r
  int rows;           // rows of x a stage holds (a multiple of 32)
  int tiles_t, tiles_n, per_n, chunks;
  int vec_x;          // T % 8 == 0 and x 16-byte aligned: x copies in 16-byte pieces
  int vec;            // T % 8 == 0, out and res 16-byte aligned: 16-byte stores
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void stsm_x4_trans(unsigned addr, const uint32_t* r) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// 16 bytes from global to shared memory; zeros where !ok (src must still be valid)
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// shared-memory writes of this thread (stmatrix, cp.async) visible to wgmma
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across wgmma's
// asynchronous window
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// A no-swizzle, K-major shared-memory matrix: core matrices of 8 rows x 16
// bytes, 128 contiguous bytes each; `lbo` bytes between the two 8-element
// halves of a k16 slice, `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma<48>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<96>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

// A block: one producer warpgroup (x copies and transposes, streamed
// weights) and consumer warpgroups (wgmma and the epilogue).  BN output
// channels: 48 -> four consumers of 64 times, 96 -> two of 128 times (two
// m64 halves each), so that a consumer's accumulators (BN / 2 a half)
// stay in registers.
template <int BN>
struct Block {
  static constexpr int kHalves = BN / 48;                // m64 halves a consumer
  static constexpr int kConsumers = 4 / kHalves;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kCThreads = 128 * kConsumers;     // consumer threads
  static constexpr int kWItems = (kMaxK * 2 * BN + 127) / 128;  // streamed weight pieces a producer thread
};

// named barriers: FULL[b] (a stage in buffer b is ready; producer arrives,
// consumers wait), EMPTY[b] (consumers are done with it; consumers arrive,
// the producer waits), the consumers' own, the producer's own
constexpr int kFull = 1, kEmpty = 3, kConsumerBar = 5, kProducerBar = 6;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// Stages of x in the cp.async ring: six (five in flight) where the weights
// stay resident; four where they stream (their ring takes the room).
template <bool RESIDENT>
__host__ __device__ constexpr int raw_stages() {
  return RESIDENT ? 6 : 4;
}

// A stage is kKC input channels: x over the tile's rows as the raw tile
// [kKC channels][rows + 8] (time fastest; the 8 extra keep its ldmatrix
// reads conflict-free), then transposed to [kKC / 8 groups][rows][8
// channels] for wgmma.  Row r of a stage is time t0 - p8 + r.
template <int THREADS>
struct Stage {
  static constexpr int kMaxRows = kBM + 2 * kMaxPad;
  static constexpr int kFill = (kKC * (kMaxRows / 8) + THREADS - 1) / THREADS;  // 16-byte pieces a thread
};

// (chunk, batch, first time) of a block's stages in order: stage s is chunk
// s % chunks of the block's (s / chunks)-th tile; advanced one stage at a time
struct Cursor {
  int c, rt, b, t0;
  __device__ __forceinline__ void start(const Args& a, int first) {
    c = 0;
    rt = first;
    b = rt / a.tiles_t;
    t0 = (rt - b * a.tiles_t) * kBM;
  }
  __device__ __forceinline__ void next(const Args& a) {
    if (++c == a.chunks) {
      c = 0;
      rt += a.per_n;
      b = rt / a.tiles_t;
      t0 = (rt - b * a.tiles_t) * kBM;
    }
  }
};

// A producer thread's share of filling the raw tile, fixed for the kernel:
// the channel and first row of each of its 16-byte pieces, packed as
// channel * 65536 + row (-1: no piece).  Copies by cp.async where x allows
// 16-byte pieces (T % 8 == 0: a piece lies wholly inside or outside [0, T),
// and outside it is zero-filled), else by plain loads and stores.
template <int THREADS>
struct Fill {
  static constexpr int kN = Stage<THREADS>::kFill;
  int piece[kN];
  __device__ __forceinline__ void init(const Args& a, int tid) {
    const int pieces = a.rows / 8;
#pragma unroll
    for (int f = 0; f < kN; ++f) {
      const int e = tid + f * THREADS, ci = e / pieces;
      piece[f] = e < kKC * pieces ? (ci << 16) | (8 * (e - ci * pieces)) : -1;
    }
  }
  __device__ __forceinline__ void operator()(const Args& a, bf16* raw, const Cursor& at,
                                             int tid) const {
    const int ta = at.t0 - a.p8;
    const bf16* xb = a.x + ((size_t)at.b * a.Cin + at.c * kKC) * a.T;
    if (a.vec_x) {
#pragma unroll
      for (int f = 0; f < kN; ++f) {
        if (piece[f] < 0) continue;
        const int ci = piece[f] >> 16, r = piece[f] & 0xFFFF, tt = ta + r;
        const bool ok = tt >= 0 && tt < a.T;
        cp_async16(smem_u32(raw + ci * (a.rows + 8) + r), ok ? xb + ((size_t)ci * a.T + tt) : a.x, ok);
      }
      return;
    }
    const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
    unsigned short* dst = reinterpret_cast<unsigned short*>(raw);
    for (int e = tid; e < kKC * a.rows; e += THREADS) {
      const int c = e / a.rows, r = e % a.rows, tt = ta + r;
      dst[c * (a.rows + 8) + r] = (tt >= 0 && tt < a.T) ? xs[(size_t)c * a.T + tt] : (unsigned short)0;
    }
  }
};

// The transpose of a stage by the producer's warps: item it is channel
// group it % G and times 32 (it / G).. of the raw tile, read as four 8 x 8
// blocks by ldmatrix (lane l: channel l / 4, times 2 (l % 4), +1) and
// written back transposed by stmatrix .trans into [G][rows][8]; warp w
// takes items w, w + 4, ...
__device__ __forceinline__ void transpose(const Args& a, unsigned raw, unsigned xs, int warp, int lane) {
  constexpr int G = kKC / 8, kN = (Stage<128>::kMaxRows / 32 * G + 3) / 4;
  const int items = a.rows / 32 * G;
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int it = warp + 4 * i, h = it % G, rb = (it / G) * 32;
    if (it >= items) break;
    uint32_t r[4];
    ldsm_x4(raw + (unsigned)(((h * 8 + (lane & 7)) * (a.rows + 8) + rb + 8 * (lane >> 3)) * 2), r);
    stsm_x4_trans(xs + (unsigned)(((h * a.rows + rb + 8 * (lane >> 3) + (lane & 7)) * 8) * 2), r);
  }
}

// A producer thread's share of the streamed weights (16 channels a stage),
// fixed for the kernel: piece e = tid + 128 i of [tap][2 groups][BN][8]
// reads w[tap][n0 + n][16 c + 8 g ..] (src: its offset at c = 0; -1: no
// piece; past Cout: zeros)
template <int BN>
struct WStream {
  static constexpr int kN = Block<BN>::kWItems, THREADS = 128;
  int src[kN];
  unsigned ok;
  __device__ __forceinline__ void init(const Args& a, int n0, int tid) {
    ok = 0;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int e = tid + i * THREADS, n = e % BN, jg = e / BN, j = jg >> 1, g = jg & 1;
      src[i] = e < a.k * 2 * BN ? ((j * a.Cout + n0 + n) * a.Cin + 8 * g) : -1;
      if (n0 + n < a.Cout) ok |= 1u << i;
    }
  }
  __device__ __forceinline__ void operator()(const Args& a, bf16* ws, int c, int tid) const {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (src[i] < 0) continue;
      const bool on = (ok >> i) & 1;
      cp_async16(smem_u32(ws + (tid + i * THREADS) * 8), on ? a.w + src[i] + 16 * c : a.w, on);
    }
  }
};

// All weights of output channels n0.. (input channel groups g0 <= g < g0 +
// G) into [tap][g - g0][n][8 channels], by the producer's threads
template <int BN>
__device__ __forceinline__ void load_w(const Args& a, bf16* ws, int g0, int G, int n0, int tid) {
  for (int e = tid; e < a.k * G * BN; e += 128) {
    const int n = e % BN, jg = e / BN, g = jg % G, j = jg / G;
    const int co = n0 + n;
    const bool ok = co < a.Cout;
    const bf16* src = ok ? a.w + ((size_t)j * a.Cout + co) * a.Cin + (g0 + g) * 8 : a.w;
    cp_async16(smem_u32(ws + e * 8), src, ok);
  }
}

// The staged tile ys [n][time] to out (plus the residual) by the consumer
// threads (ctid): 16-byte stores along time where a.vec, the residual
// loads of a round issued before its stores so that their latencies
// overlap; else element by element.
template <int BN>
__device__ __forceinline__ void store_tile(const Args& a, const bf16* ys, int b, int t0, int n0,
                                           int ctid) {
  constexpr int kThreads = Block<BN>::kCThreads;
  constexpr int kIters = BN * (kBM / 8) / kThreads, kRound = kIters < 4 ? kIters : 4;
  static_assert(BN * (kBM / 8) % kThreads == 0 && kIters % kRound == 0, "whole rounds a thread");
  const int n_rows = min(BN, a.Cout - n0);
  if (a.vec) {
#pragma unroll 1
    for (int q0 = 0; q0 < kIters; q0 += kRound) {
      uint4 rv[kRound];
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int e = ctid + (q0 + q) * kThreads, n = e / (kBM / 8), t = t0 + (e % (kBM / 8)) * 8;
        if (a.res && n < n_rows && t < a.T)
          rv[q] = __ldg(reinterpret_cast<const uint4*>(a.res + ((size_t)b * a.Cout + n0 + n) * a.T + t));
      }
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int e = ctid + (q0 + q) * kThreads, n = e / (kBM / 8), m = (e % (kBM / 8)) * 8, t = t0 + m;
        if (n >= n_rows || t >= a.T) continue;
        uint4 yv = *reinterpret_cast<const uint4*>(ys + n * kYRow + m);
        if (a.res) {
          uint32_t* yw = reinterpret_cast<uint32_t*>(&yv);
          const uint32_t* rw = reinterpret_cast<const uint32_t*>(&rv[q]);
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float2 fy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(yw + h));
            const float2 fr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rw + h));
            const __nv_bfloat162 sum = __floats2bfloat162_rn(fr.x + fy.x, fr.y + fy.y);
            yw[h] = *reinterpret_cast<const uint32_t*>(&sum);
          }
        }
        *reinterpret_cast<uint4*>(a.out + ((size_t)b * a.Cout + n0 + n) * a.T + t) = yv;
      }
    }
    return;
  }
  for (int e = ctid; e < n_rows * (kBM / 8); e += kThreads) {
    const int n = e / (kBM / 8), m = (e % (kBM / 8)) * 8, t = t0 + m;
    if (t >= a.T) continue;
    const size_t o = ((size_t)b * a.Cout + n0 + n) * a.T + t;
    const int cnt = min(8, a.T - t);
    for (int q = 0; q < cnt; ++q) {
      bf16 yq = ys[n * kYRow + m + q];
      if (a.res) yq = __float2bfloat16_rn(__bfloat162float(a.res[o + q]) + __bfloat162float(yq));
      a.out[o + q] = yq;
    }
  }
}

template <int BN, bool RESIDENT>
__global__ void __launch_bounds__(Block<BN>::kThreads, 1) same_conv_kernel(const Args a) {
  constexpr int kThreads = Block<BN>::kThreads, kHalves = Block<BN>::kHalves;
  constexpr int G = kKC / 8, kRaw = raw_stages<RESIDENT>();
  constexpr int kAcc = BN / 2;  // f32 accumulators a consumer thread and half: 64 x BN over 128 threads
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);
  const int rstage = kKC * (a.rows + 8);                        // elements
  bf16* xs = raw + kRaw * rstage;
  const int xstage = G * a.rows * 8;
  bf16* ws = xs + 2 * xstage;
  const int wslab = a.k * (RESIDENT ? a.Cin / 8 : 2) * BN * 8;
  bf16* ys = ws + (RESIDENT ? 1 : kWStages) * wslab;
  float* bias = reinterpret_cast<float*>(ys + BN * kYRow);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp / 4;
  const int n0 = (blockIdx.x % a.tiles_n) * BN;
  const int first = blockIdx.x / a.tiles_n;
  const int row_tiles = a.B * a.tiles_t;
  const int S = (row_tiles - first + a.per_n - 1) / a.per_n * a.chunks;  // stages of this block
  for (int n = tid; n < BN; n += kThreads) bias[n] = n0 + n < a.Cout ? a.bias[n0 + n] : 0.f;
  __syncthreads();

  if (wg == 0) {
    // producer: stage g's x is copied kRaw - 1 stages ahead (cp.async),
    // transposed into buffer g % 2 once the consumers are done with stage
    // g - 2, and handed over; streamed weights of stage g + 2 go into the
    // ring slot of stage g - 2.  cp.async groups: the resident weights',
    // then one a stage (x of stage m in group m, streamed weights of stage
    // m in group m + kRaw - 3, those of stages 0 and 1 in groups 0 and 1).
    Fill<128> fill;
    fill.init(a, tid);
    WStream<BN> wstream;
    if (!RESIDENT) wstream.init(a, n0, tid);
    Cursor at_r, at_w;
    at_r.start(a, first);
    at_w.start(a, first);
    if (RESIDENT) {
      load_w<BN>(a, ws, 0, a.Cin / 8, n0, tid);
      cp_async_commit();
    }
    for (int s = 0; s < kRaw - 1; ++s) {
      if (s < S) {
        fill(a, raw + s * rstage, at_r, tid);
        at_r.next(a);
      }
      if (!RESIDENT && s < 2 && s < S) {
        wstream(a, ws + s * wslab, at_w.c, tid);
        at_w.next(a);
      }
      cp_async_commit();
    }
    const unsigned raw0 = smem_u32(raw), xs0 = smem_u32(xs);
    for (int g = 0; g < S; ++g) {
      bar_sync(kProducerBar, 128);  // every producer warp is done with stage g - 1's raw tile
      if (g >= 2) bar_sync(kEmpty + (g & 1), kThreads);
      if (g + kRaw - 1 < S) {
        fill(a, raw + ((g + kRaw - 1) % kRaw) * rstage, at_r, tid);
        at_r.next(a);
      }
      if (!RESIDENT && g + 2 < S) {
        wstream(a, ws + ((g + 2) % kWStages) * wslab, at_w.c, tid);
        at_w.next(a);
      }
      cp_async_commit();
      // x of stage g (group g) and its streamed weights (group g + 1) have landed
      if (RESIDENT) cp_async_wait<kRaw - 1>();
      else cp_async_wait<kRaw - 2>();
      bar_sync(kProducerBar, 128);
      transpose(a, raw0 + (unsigned)((g % kRaw) * rstage * 2), xs0 + (unsigned)((g & 1) * xstage * 2),
                warp, lane);
      fence_async_shared();
      bar_arrive(kFull + (g & 1), kThreads);
    }
    cp_async_wait<0>();
    return;
  }

  // consumers
  const int cw = wg - 1, ctid = tid - 128, wl = warp % 4;
  Cursor at_g;
  at_g.start(a, first);
  float acc[kHalves][kAcc];
#pragma unroll
  for (int h = 0; h < kHalves; ++h)
#pragma unroll
    for (int e = 0; e < kAcc; ++e) acc[h][e] = 0.f;
  // descriptors advance in 16-byte units: a row of x or of the weights is one
  const uint64_t da0 = desc(smem_u32(xs) + (unsigned)((cw * 64 * kHalves + a.p8 - a.p) * 16),
                            (unsigned)a.rows * 16, 128);
  const uint64_t db0 = desc(smem_u32(ws), BN * 16, 128);
  const int w_step = (RESIDENT ? a.Cin / 8 : 2) * BN;  // units from a tap's weights to the next's

  for (int g = 0; g < S; ++g) {
    bar_sync(kFull + (g & 1), kThreads);
    uint64_t da = da0 + (uint64_t)((g & 1) * xstage * 2 / 16);
    uint64_t db = db0 + (uint64_t)(RESIDENT ? G * at_g.c * BN : (g % kWStages) * wslab * 2 / 16);
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int e = 0; e < kAcc; ++e) fence_operand(acc[h][e]);
    wgmma_fence();
    for (int j = 0; j < a.k; ++j) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) wgmma<BN>(acc[h], da + (uint64_t)(64 * h), db);
      da += (uint64_t)a.d;
      db += (uint64_t)w_step;
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < kHalves; ++h)
#pragma unroll
      for (int e = 0; e < kAcc; ++e) fence_operand(acc[h][e]);
    bar_arrive(kEmpty + (g & 1), kThreads);

    if (at_g.c == a.chunks - 1) {
      // the tile is complete: y = bf16(bf16(acc) + bias) staged as [n][time];
      // accumulator 4 q + e of a thread's half h is row 64 h + 16 wl + l / 4
      // + 8 (e / 2), column 8 q + 2 (l % 4) + e % 2 of its consumer's rows
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int n = q * 8 + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < kHalves; ++h) {
          const int m0 = (cw * kHalves + h) * 64 + wl * 16 + (lane >> 2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float y = __bfloat162float(__float2bfloat16_rn(acc[h][4 * q + e]));
            ys[(n + (e & 1)) * kYRow + m0 + (e >> 1) * 8] = __float2bfloat16_rn(y + bias[n + (e & 1)]);
          }
        }
      }
      bar_sync(kConsumerBar, Block<BN>::kCThreads);
      store_tile<BN>(a, ys, at_g.b, at_g.t0, n0, ctid);
#pragma unroll
      for (int h = 0; h < kHalves; ++h)
#pragma unroll
        for (int e = 0; e < kAcc; ++e) acc[h][e] = 0.f;
    }
    at_g.next(a);
  }
}

template <int BN, bool RESIDENT>
size_t smem_bytes(const Args& a) {
  const size_t wslab = (size_t)a.k * (RESIDENT ? a.Cin / 8 : 2) * BN * 8;
  return 2 * ((size_t)raw_stages<RESIDENT>() * kKC * (a.rows + 8) + 2 * (size_t)(kKC / 8) * a.rows * 8 +
              (RESIDENT ? 1 : kWStages) * wslab + (size_t)BN * kYRow + 2 * (size_t)BN);
}
// blocks of the instantiation an SM holds at `smem` bytes, kept per size
template <int BN, bool RESIDENT>
cudaError_t blocks_per_sm(size_t smem, int* out) {
  static std::mutex lock;
  static size_t sizes[16];
  static int counts[16];
  static int n = 0;
  static bool raised = false;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n; ++i) {
    if (sizes[i] == smem) {
      *out = counts[i];
      return cudaSuccess;
    }
  }
  auto kern = same_conv_kernel<BN, RESIDENT>;
  cudaError_t e = cudaSuccess;
  if (!raised) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptin);
    if (e != cudaSuccess) return e;
    raised = true;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kern, Block<BN>::kThreads, smem);
  if (e != cudaSuccess) return e;
  if (n < 16) {
    sizes[n] = smem;
    counts[n++] = *out;
  }
  return cudaSuccess;
}

template <int BN, bool RESIDENT>
int launch(Args a, cudaStream_t stream) {
  const size_t smem = smem_bytes<BN, RESIDENT>(a);
  if (smem > (size_t)kSmemOptin) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = blocks_per_sm<BN, RESIDENT>(smem, &per_sm);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  a.chunks = a.Cin / kKC;
  const int row_tiles = a.B * a.tiles_t;
  const int fit = sms * per_sm / a.tiles_n;
  a.per_n = fit < 1 ? 1 : (fit < row_tiles ? fit : row_tiles);
  same_conv_kernel<BN, RESIDENT><<<a.per_n * a.tiles_n, Block<BN>::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the weights in shared memory where they fit, else streamed
template <int BN>
int launch_tile(Args a, cudaStream_t stream) {
  if (smem_bytes<BN, true>(a) <= (size_t)kSmemOptin) return launch<BN, true>(a, stream);
  return launch<BN, false>(a, stream);
}


// ---------------------------------------------------------------- k = 1

namespace k1 {

constexpr int kBox = 64 * 128;  // bytes of a TMA box: 64 rows of 64 bfloat16, a 128-byte swizzle row each

// A tile of NW-time consumers: two consumer warpgroups of 64 output
// channels x NW times each, side by side in time (SPLIT_N: a 64 x 2 NW
// tile) or one above the other (a 128 x NW tile).  A stage is the tile's
// weights for 64 input channels (BM rows of 128 bytes) and x for 64 input
// channels over the tile's times (BN / 64 boxes); each consumer has E
// epilogue buffers of its 64 x NW tile; the ring takes the rest.
template <int NW, bool SPLIT_N>
struct Tile {
  static constexpr int BM = SPLIT_N ? 64 : 128;
  static constexpr int BN = SPLIT_N ? 2 * NW : NW;
  static constexpr int kWBytes = BM * 128;
  static constexpr int kStageBytes = kWBytes + BN / 64 * kBox;
  static constexpr int kEpiBytes = NW / 64 * kBox;
  static constexpr int E = NW == 128 ? 2 : 1;
  static constexpr int kFixed = 1024 /* base alignment */ + 1024 /* barriers */ + 2 * E * kEpiBytes;
  static constexpr int S = (kSmemOptin - kFixed) / kStageBytes;
  static constexpr int kSmem = kFixed + S * kStageBytes;
  static_assert(S >= 3, "a ring of at least three stages");
};

struct Args {
  const float* bias;  // (Cout), bfloat16 values
  int Cout, tiles_t, tiles_n, tiles, chunks;
  int res;            // 1: add the residual
};

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// until the phase of parity `parity` has completed; a phase that never
// completes (a fault of the pipeline) traps, an error, instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  for (unsigned polls = 0;; ++polls) {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 26)) asm volatile("trap;\n");
  }
}

__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map, int c0, int c1, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map, int c0, int c1, int c2,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, unsigned src, int c0, int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

// the shared-memory reads of every committed store are done
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// A 128-byte-swizzled shared-memory matrix as TMA writes it
// (CU_TENSOR_MAP_SWIZZLE_128B: 128-byte rows, 8-row atoms of 1024 bytes):
// K-major (the weights) takes no leading offset and `sbo` 1024 between
// groups of 8 rows; MN-major (x) `lbo` between 64-time boxes and `sbo`
// 1024 between groups of 8 channels.
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// D (64 x N, float32) (+)= A (64 x 16, K-major) B (16 x N, MN-major)
template <int N>
__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void mma<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma<256>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// (batch, first time, first output channel) of tile `tile`: output-channel
// tiles fastest, so that the tiles of one x tile run side by side
__device__ __forceinline__ void coords(const Args& a, int tile, int bm, int bn, int& b, int& t0, int& n0) {
  const int ct = tile % a.tiles_n, rt = tile / a.tiles_n;
  b = rt / a.tiles_t;
  t0 = (rt - b * a.tiles_t) * bn;
  n0 = ct * bm;
}

template <int NW, bool SPLIT_N>
__global__ void __launch_bounds__(384, 1)
    k1conv_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                  const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap omap,
                  const Args a) {
  using L = Tile<NW, SPLIT_N>;
  constexpr int S = L::S, E = L::E;
  extern __shared__ unsigned char k1_smem[];
  const unsigned raw = smem_u32(k1_smem);
  const unsigned base = (raw + 1023u) & ~1023u;       // stage s at base + s kStageBytes: weights, then x
  unsigned char* const gbase = k1_smem + (base - raw);
  const unsigned epi = base + S * L::kStageBytes;     // consumer w's buffer e at epi + (w E + e) kEpiBytes
  const unsigned bars = epi + 2 * E * L::kEpiBytes;
  // barriers: FULL[S] (a stage landed), EMPTY[S] (the consumers are done
  // with it), RES[2][E] (a consumer's residual tile landed), FREE[2][E] (its
  // buffer's store has read it)
  auto full = [=](int s) { return bars + 8 * s; };
  auto empty = [=](int s) { return bars + 8 * (S + s); };
  auto res_full = [=](int w, int e) { return bars + 8 * (2 * S + w * E + e); };
  auto free_ = [=](int w, int e) { return bars + 8 * (2 * S + 2 * E + w * E + e); };

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);  // lane 0 of each consumer warp
    }
    for (int w = 0; w < 2; ++w)
      for (int e = 0; e < E; ++e) {
        mbar_init(res_full(w, e), 1);
        mbar_init(free_(w, e), 1);
      }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if (lane != 0) return;
    if (warp == 0) {
      // the stages: the weights' box and x's boxes into the ring
      int g = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
        int b, t0, n0;
        coords(a, tile, L::BM, L::BN, b, t0, n0);
        for (int c = 0; c < a.chunks; ++c, ++g) {
          const int s = g % S;
          mbar_wait(empty(s), ((g / S) & 1) ^ 1);
          mbar_expect(full(s), L::kStageBytes);
          const unsigned st = base + s * L::kStageBytes;
          tma_load_2d(st, &wmap, 64 * c, n0, full(s));
#pragma unroll
          for (int q = 0; q < L::BN / 64; ++q)
            tma_load_3d(st + L::kWBytes + q * kBox, &xmap, t0 + 64 * q, 64 * c, b, full(s));
        }
      }
    } else if (warp <= 2 && a.res) {
      // consumer warp - 1's residual tiles into its epilogue buffers
      const int w = warp - 1;
      int j = 0;
      for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++j) {
        int b, t0, n0;
        coords(a, tile, L::BM, L::BN, b, t0, n0);
        const int tw = SPLIT_N ? t0 + w * NW : t0, nw = SPLIT_N ? n0 : n0 + 64 * w, e = j % E;
        mbar_wait(free_(w, e), ((j / E) & 1) ^ 1);
        mbar_expect(res_full(w, e), L::kEpiBytes);
        const unsigned dst = epi + (w * E + e) * L::kEpiBytes;
#pragma unroll
        for (int q = 0; q < NW / 64; ++q) tma_load_3d(dst + q * kBox, &rmap, tw + 64 * q, nw, b, res_full(w, e));
      }
    }
    return;
  }

  // consumers: warpgroup w computes output channels nw.. (64) x times tw.. (NW)
  const int w = wg - 1, ctid = tid - 128 * wg, r0 = 16 * (warp & 3) + (lane >> 2);
  float acc[NW / 2];
  int g = 0, j = 0;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x, ++j) {
    int b, t0, n0;
    coords(a, tile, L::BM, L::BN, b, t0, n0);
    const int tw = SPLIT_N ? t0 + w * NW : t0, nw = SPLIT_N ? n0 : n0 + 64 * w;
    for (int c = 0; c < a.chunks; ++c, ++g) {
      const int s = g % S;
      mbar_wait(full(s), (g / S) & 1);
      const unsigned st = base + s * L::kStageBytes;
      const unsigned wa = st + (SPLIT_N ? 0 : w * 64 * 128);
      const unsigned xb = st + L::kWBytes + (SPLIT_N ? w * (NW / 64) * kBox : 0);
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) fence_operand(acc[e]);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // 16 input channels a step: 32 bytes along a weight row, 16 rows of x
        mma<NW>(acc, desc_sw128(wa + 32 * k, 16, 1024), desc_sw128(xb + 2048 * k, kBox, 1024), c > 0 || k > 0);
      wgmma_commit();
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) fence_operand(acc[e]);
      if (c > 0) {  // the previous stage's products are done: hand it back
        wgmma_wait<1>();
        if (lane == 0) mbar_arrive(empty((g - 1) % S));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < NW / 2; ++e) fence_operand(acc[e]);
    if (lane == 0) mbar_arrive(empty((g - 1) % S));

    // epilogue: y = bf16(bf16(acc) + bias) (+ the residual, in bfloat16) into
    // the buffer, where accumulator 4 q + 2 h + i of a thread is row r0 + 8 h,
    // time 8 q + 2 (lane % 4) + i: box q / 8, 16-byte chunk (q % 8) ^ (row % 8)
    const int e = j % E;
    const unsigned buf = epi + (w * E + e) * L::kEpiBytes;
    unsigned char* const gbuf = gbase + (buf - base);
    if (a.res) mbar_wait(res_full(w, e), (j / E) & 1);
    else bar_sync(1 + w, 128);  // the buffer's last store has read it
    const float bias0 = nw + r0 < a.Cout ? a.bias[nw + r0] : 0.f;
    const float bias1 = nw + r0 + 8 < a.Cout ? a.bias[nw + r0 + 8] : 0.f;
#pragma unroll
    for (int q = 0; q < NW / 8; ++q) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned off = (q >> 3) * kBox + (r0 + 8 * h) * 128 + (((q & 7) ^ (lane >> 2)) << 4) + (lane & 3) * 4;
        const float bb = h ? bias1 : bias0;
        __nv_bfloat162 y = __floats2bfloat162_rn(__bfloat162float(__float2bfloat16_rn(acc[4 * q + 2 * h])) + bb,
                                                 __bfloat162float(__float2bfloat16_rn(acc[4 * q + 2 * h + 1])) + bb);
        __nv_bfloat162* at = reinterpret_cast<__nv_bfloat162*>(gbuf + off);
        if (a.res) {
          const float2 fr = __bfloat1622float2(*at), fy = __bfloat1622float2(y);
          y = __floats2bfloat162_rn(fr.x + fy.x, fr.y + fy.y);
        }
        *at = y;
      }
    }
    fence_async_shared();
    bar_sync(1 + w, 128);
    if (ctid == 0) {
#pragma unroll
      for (int q = 0; q < NW / 64; ++q) tma_store_3d(&omap, buf + q * kBox, tw + 64 * q, nw, b);
      bulk_commit();
      bulk_wait_read();
      if (a.res) mbar_arrive(free_(w, e));
    }
  }
  if (ctid == 0) bulk_wait();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found with dlopen (the library does not link libcuda)
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A bfloat16 tensor of `rank` dims (innermost first, dense) in boxes of
// `box`, 128-byte swizzled, zeros past its edges
bool encode(CUtensorMap* m, const void* p, int rank, const uint64_t* dims, const uint32_t* box) {
  const EncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t d[3], strides[2];
  cuuint32_t bx[3], es[3] = {1, 1, 1};
  uint64_t stride = 2;
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    bx[i] = box[i];
    if (i > 0) strides[i - 1] = stride;
    stride *= dims[i];
  }
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(p), d, strides, bx, es,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NW, bool SPLIT_N>
int launch(const void* x, const void* w, const float* bias, const void* res, void* out, int B, int Cin, int Cout,
           int T, cudaStream_t stream) {
  using L = Tile<NW, SPLIT_N>;
  CUtensorMap xm, wm, rm, om;
  const uint64_t xd[3] = {(uint64_t)T, (uint64_t)Cin, (uint64_t)B}, wd[2] = {(uint64_t)Cin, (uint64_t)Cout},
                 od[3] = {(uint64_t)T, (uint64_t)Cout, (uint64_t)B};
  const uint32_t xbox[3] = {64, 64, 1}, wbox[2] = {64, (uint32_t)L::BM}, obox[3] = {64, 64, 1};
  if (!encode(&xm, x, 3, xd, xbox) || !encode(&wm, w, 2, wd, wbox) || !encode(&om, out, 3, od, obox) ||
      (res && !encode(&rm, res, 3, od, obox)))
    return (int)cudaErrorInvalidValue;
  if (!res) rm = om;
  static std::once_flag once;
  static cudaError_t raised = cudaSuccess;
  std::call_once(once, [] {
    raised = cudaFuncSetAttribute(k1conv_kernel<NW, SPLIT_N>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  });
  if (raised != cudaSuccess) return (int)raised;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.bias = bias;
  a.Cout = Cout;
  a.tiles_t = (T + L::BN - 1) / L::BN;
  a.tiles_n = (Cout + L::BM - 1) / L::BM;
  a.tiles = B * a.tiles_t * a.tiles_n;
  a.chunks = (Cin + 63) / 64;
  a.res = res != nullptr;
  k1conv_kernel<NW, SPLIT_N><<<a.tiles < sms ? a.tiles : sms, 384, L::kSmem, stream>>>(xm, wm, rm, om, a);
  return (int)cudaGetLastError();
}

}  // namespace k1

}  // namespace

// out = conv(x) + bias (+ res) as above.  x (B, Cin, T), res and out (B,
// Cout, T) contiguous bfloat16; w (k, Cout, Cin) contiguous bfloat16; bias
// (Cout) float32.  Refuses (cudaErrorInvalidValue) what the kernel does not
// take; launches nothing for an empty batch.
extern "C" int nawc_same_conv(const void* x, const void* w, const float* bias, const void* res,
                              void* out, int B, int Cin, int Cout, int T, int k, int d,
                              void* stream) {
  if (B < 0 || T < 0 || Cin < 16 || Cin % 16 || Cout < 16 || Cout % 16 || k < 1 || k > kMaxK ||
      k % 2 == 0 || d < 1 || d * (k - 1) / 2 > kMaxPad || ((uintptr_t)x & 1) ||
      ((uintptr_t)w & 15) || ((uintptr_t)out & 1) || ((uintptr_t)res & 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * T == 0) return 0;
  Args a;
  a.x = (const bf16*)x;
  a.w = (const bf16*)w;
  a.bias = bias;
  a.res = (const bf16*)res;
  a.out = (bf16*)out;
  a.B = B;
  a.Cin = Cin;
  a.Cout = Cout;
  a.T = T;
  a.k = k;
  a.d = d;
  a.p = d * (k - 1) / 2;
  a.p8 = (a.p + 7) / 8 * 8;
  a.rows = (kBM + 2 * a.p8 + 31) / 32 * 32;
  a.tiles_t = (T + kBM - 1) / kBM;
  a.per_n = 1;
  a.chunks = 1;
  a.vec_x = T % 8 == 0 && ((uintptr_t)x & 15) == 0;
  a.vec = T % 8 == 0 && ((uintptr_t)out & 15) == 0 && ((uintptr_t)res & 15) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout <= 48) {
    a.tiles_n = 1;
    return launch_tile<48>(a, s);
  }
  a.tiles_n = (Cout + 95) / 96;
  return launch_tile<96>(a, s);
}

// The k = 1 path: out = conv(x) + bias (+ res) as above for a (1, Cout,
// Cin) w, with T % 8 == 0 and x, w, res and out 16-byte aligned.  Refuses
// (cudaErrorInvalidValue) what it does not take or where libcuda has no
// tensor-map encoder; launches nothing for an empty batch.
extern "C" int nawc_k1conv(const void* x, const void* w, const float* bias, const void* res, void* out, int B,
                           int Cin, int Cout, int T, void* stream) {
  if (B < 0 || T < 0 || T % 8 || Cin < 16 || Cin % 16 || Cout < 16 || Cout % 16 || ((uintptr_t)x & 15) ||
      ((uintptr_t)w & 15) || ((uintptr_t)out & 15) || ((uintptr_t)res & 15))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * T == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (Cout <= 64) return k1::launch<128, true>(x, w, bias, res, out, B, Cin, Cout, T, s);
  if (Cout <= 128) return k1::launch<128, false>(x, w, bias, res, out, B, Cin, Cout, T, s);
  return k1::launch<256, false>(x, w, bias, res, out, B, Cin, Cout, T, s);
}
