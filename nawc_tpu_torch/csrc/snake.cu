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
// __fadd_rn, __fsub_rn and __fdiv_rn are never contracted into a fused
// multiply-add, the divisions are true IEEE divisions (as JAX computes
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
// deterministic: each block sums its own elements of one row in a fixed
// order, the partials go to scratch, and a second kernel adds them per
// channel in a fixed order.  No atomics: two runs give the same bits.
//
// What bounds it on an H100: bytes.  One encode of 16 x 4 s at 24 kHz runs
// Snakes over 1.357 G elements; forward one read and one write per element,
// 10.86 GB in float32 -> 3.24 ms at 3.35 TB/s (1.62 ms in bfloat16);
// backward reads x and g and writes dx, 1.5 times that.  The arithmetic
// (18 float32 operations an element forward, 44 backward) is under a
// third of the bytes' time at 67 TFLOP/s; in instructions issued (each
// IEEE division is several) it comes closer, and bounds bfloat16, which
// moves half the bytes.
// Design: a block takes a chunk of one row (one channel, so a and its
// per-row constants are loaded once), threads take 16-byte vectors (4 floats
// or 8 bfloat16) from the row's first 16-byte boundary on, and the few
// elements before it and after the last whole vector go one per thread.  If
// the tensors' addresses are not 16-byte aligned alike, every element goes
// one per thread.  No shared memory but the backward's block sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;  // 16-byte vectors a thread takes in a row chunk
constexpr int kMaxGridY = 65535;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979323846);
constexpr float kPi = (float)3.14159265358979323846;
constexpr float kEps = (float)1e-9;

template <typename T> struct Io;

template <> struct Io<float> {
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void load_vec(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ __forceinline__ void store_vec(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Io<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  static __device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
    }
  }
  static __device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i]));
      const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]));
      w[i] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The forward's intermediates at one element.
struct Poly {
  float p, a6, b20, t1, t2, t3, s;
};

// s(p) of z, step by step as snake_reference's _sin2_periodic
__device__ __forceinline__ Poly poly(float z) {
  Poly r;
  float u = __fmul_rn(z, kInvPi);
  u = __fsub_rn(u, rintf(u));
  r.p = __fmul_rn(u, kPi);
  const float p2 = __fmul_rn(r.p, r.p);
  r.t3 = __fsub_rn(1.0f, __fdiv_rn(p2, 42.0f));
  r.b20 = __fdiv_rn(p2, 20.0f);
  r.t2 = __fsub_rn(1.0f, __fmul_rn(r.b20, r.t3));
  r.a6 = __fdiv_rn(p2, 6.0f);
  r.t1 = __fsub_rn(1.0f, __fmul_rn(r.a6, r.t2));
  r.s = __fmul_rn(r.p, r.t1);
  return r;
}

// dS/dz at one element by reverse-mode autodiff of poly() with seed 1
// (snake_backward_reference spells the same steps)
__device__ __forceinline__ float poly_grad(const Poly& r) {
  const float ds = __fadd_rn(r.s, r.s);           // S = s * s
  float dp = __fmul_rn(ds, r.t1);                  // s = p * t1
  const float m1 = -__fmul_rn(ds, r.p);            // t1 = 1 - a6 * t2
  const float da6 = __fmul_rn(m1, r.t2);
  const float m2 = -__fmul_rn(m1, r.a6);           // t2 = 1 - b20 * t3
  const float db20 = __fmul_rn(m2, r.t3);
  const float m3 = -__fmul_rn(m2, r.b20);          // t3 = 1 - p2 / 42
  const float dp2 = __fadd_rn(__fadd_rn(__fdiv_rn(da6, 6.0f), __fdiv_rn(db20, 20.0f)),
                              __fdiv_rn(m3, 42.0f));
  const float dpp = __fmul_rn(dp2, r.p);           // p2 = p * p
  dp = __fadd_rn(dp, __fadd_rn(dpp, dpp));
  return __fmul_rn(__fmul_rn(dp, kPi), kInvPi);   // p = u * pi, u = z * (1/pi)
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

template <typename T>
__device__ __forceinline__ float snake_fwd(float x, float a, float den) {
  const Poly r = poly(__fmul_rn(a, x));
  const float S = Io<T>::round(__fmul_rn(r.s, r.s));
  return Io<T>::round(__fadd_rn(x, Io<T>::round(__fdiv_rn(S, den))));
}

// grid (chunks of a row, rows): block (i, row) takes the row's vectors
// [i * kThreads * kVecPerThread, (i + 1) * kThreads * kVecPerThread) and
// its share of the single elements
template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_forward_kernel(const T* __restrict__ x, const float* __restrict__ alpha, T* __restrict__ y,
                     int rows, int C, int T_, bool aligned) {
  constexpr int V = Io<T>::kVec;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t base = (size_t)row * T_;
    const float a = alpha[row % C];
    const float den = Io<T>::round(__fadd_rn(a, kEps));
    const Row<T> lay(x + base, T_, aligned);
    const T* xr = x + base + lay.head;
    T* yr = y + base + lay.head;
    const int v0 = blockIdx.x * kThreads * kVecPerThread + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = v0 + k * kThreads;
      if (v < lay.nvec) {
        float e[V];
        Io<T>::load_vec(xr + (size_t)v * V, e);
#pragma unroll
        for (int j = 0; j < V; ++j) e[j] = snake_fwd<T>(e[j], a, den);
        Io<T>::store_vec(yr + (size_t)v * V, e);
      }
    }
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < lay.head + lay.tail;
         i += gridDim.x * kThreads) {
      const size_t o = base + lay.single(i);
      Io<T>::store(y + o, snake_fwd<T>(Io<T>::load(x + o), a, den));
    }
  }
}

// One element's dx, and its terms of dalpha added to the two running sums
// (the a x path and the 1/(a + 1e-9) path, which autograd sums apart).  In
// bfloat16 every step that autograd of the plain bfloat16 forward rounds to
// bfloat16 rounds here too: g / den, the product's gradient to x, dx, and
// each element's 1/(a + 1e-9) term; in float32 R is the identity.
template <typename T>
__device__ __forceinline__ float snake_bwd(float x, float g, float a, float den, float& sz,
                                           float& sd) {
  using R = Io<T>;
  const Poly r = poly(__fmul_rn(a, x));
  const float S = R::round(__fmul_rn(r.s, r.s));
  const float dz = __fmul_rn(R::round(__fdiv_rn(g, den)), poly_grad(r));
  sz = __fadd_rn(sz, __fmul_rn(dz, x));
  sd = __fadd_rn(sd, R::round(__fmul_rn(g, R::round(__fdiv_rn(R::round(__fdiv_rn(S, den)), den)))));
  return R::round(__fadd_rn(g, R::round(__fmul_rn(dz, a))));
}

// a block's sum of v over its threads, in a fixed order: a shuffle tree,
// then the warps in order (thread 0 holds it)
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float tot = 0.0f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) tot = __fadd_rn(tot, red[w]);
  }
  __syncthreads();
  return tot;
}

// dx (skipped where dx is null) and, where partial is not null, block
// (i, row)'s sums of the dalpha terms of its elements: the a x path's in
// partial[row * G + i], the 1/(a + 1e-9) path's in partial[(rows + row) * G + i]
template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_backward_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ alpha, T* __restrict__ dx,
                      float* __restrict__ partial, int rows, int C, int T_, bool aligned) {
  constexpr int V = Io<T>::kVec;
  __shared__ float red[kThreads / 32];
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const size_t base = (size_t)row * T_;
    const float a = alpha[row % C];
    const float den = Io<T>::round(__fadd_rn(a, kEps));
    const Row<T> lay(x + base, T_, aligned);
    const T* xr = x + base + lay.head;
    const T* gr = g + base + lay.head;
    T* dr = dx ? dx + base + lay.head : nullptr;
    float sz = 0.0f, sd = 0.0f;
    const int v0 = blockIdx.x * kThreads * kVecPerThread + threadIdx.x;
#pragma unroll
    for (int k = 0; k < kVecPerThread; ++k) {
      const int v = v0 + k * kThreads;
      if (v < lay.nvec) {
        float ex[V], eg[V];
        Io<T>::load_vec(xr + (size_t)v * V, ex);
        Io<T>::load_vec(gr + (size_t)v * V, eg);
#pragma unroll
        for (int j = 0; j < V; ++j) eg[j] = snake_bwd<T>(ex[j], eg[j], a, den, sz, sd);
        if (dr) Io<T>::store_vec(dr + (size_t)v * V, eg);
      }
    }
    for (int i = blockIdx.x * kThreads + threadIdx.x; i < lay.head + lay.tail;
         i += gridDim.x * kThreads) {
      const size_t o = base + lay.single(i);
      const float d = snake_bwd<T>(Io<T>::load(x + o), Io<T>::load(g + o), a, den, sz, sd);
      if (dx) Io<T>::store(dx + o, d);
    }
    if (partial) {
      const float tz = block_sum(sz, red);
      const float td = block_sum(sd, red);
      if (threadIdx.x == 0) {
        partial[(size_t)row * gridDim.x + blockIdx.x] = tz;
        partial[((size_t)rows + row) * gridDim.x + blockIdx.x] = td;
      }
    }
  }
}

// dalpha[c] from the partials of rows b * C + c, b < B, in a fixed order: one
// warp per channel, lane l taking the flattened (b, chunk) entries l, l + 32,
// ... of each path, then a fixed shuffle tree; the two paths' sums are
// rounded to T and added as autograd adds them (the 1/(a + 1e-9) path's
// terms enter with a minus sign)
template <typename T>
__global__ void __launch_bounds__(kThreads)
snake_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dalpha, int B, int C,
                    int G) {
  const int c = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
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
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    vz += __shfl_xor_sync(0xffffffffu, vz, s);
    vd += __shfl_xor_sync(0xffffffffu, vd, s);
  }
  if (lane == 0) dalpha[c] = Io<T>::round(__fsub_rn(Io<T>::round(vz), Io<T>::round(vd)));
}

// blocks per row: enough chunks of kThreads x kVecPerThread vectors to
// cover the row's vectors, at least one
int chunks(int T_, int esize) {
  const int V = 16 / esize;
  const int per = kThreads * kVecPerThread * V;
  const int n = (T_ + per - 1) / per;
  return n > 0 ? n : 1;
}

bool valid(int B, int C, int T_, int esize) {
  return B >= 1 && C >= 1 && T_ >= 1 && (esize == 4 || esize == 2) &&
         (long long)B * C <= 0x7fffffffLL;
}

bool aligned_alike(const void* a, const void* b, const void* c) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(a) & 15;
  return (reinterpret_cast<uintptr_t>(b) & 15) == m && (!c || (reinterpret_cast<uintptr_t>(c) & 15) == m);
}

dim3 grid_of(int rows, int T_, int esize) {
  return dim3(chunks(T_, esize), rows < kMaxGridY ? rows : kMaxGridY);
}

}  // namespace

// y = snake(x) over (B, C, T): x and y contiguous, float32 (esize 4) or
// bfloat16 (esize 2); alpha (C,) float32, already rounded to x's type.
extern "C" int nawc_snake_forward(const void* x, const float* alpha, void* y, int B, int C, int T,
                                  int esize, void* stream) {
  if (!valid(B, C, T, esize)) return (int)cudaErrorInvalidValue;
  const int rows = B * C;
  const bool al = aligned_alike(x, y, nullptr);
  cudaStream_t s = (cudaStream_t)stream;
  if (esize == 4) {
    snake_forward_kernel<float><<<grid_of(rows, T, 4), kThreads, 0, s>>>(
        (const float*)x, alpha, (float*)y, rows, C, T, al);
  } else {
    snake_forward_kernel<__nv_bfloat16><<<grid_of(rows, T, 2), kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, alpha, (__nv_bfloat16*)y, rows, C, T, al);
  }
  return (int)cudaGetLastError();
}

// The floats of scratch that nawc_snake_backward needs for dalpha.
extern "C" int nawc_snake_backward_scratch(int B, int C, int T, int esize, size_t* floats) {
  if (!valid(B, C, T, esize)) return (int)cudaErrorInvalidValue;
  *floats = 2 * (size_t)B * C * chunks(T, esize);
  return 0;
}

// dx (null: not wanted) and dalpha (C,) float32 (null: not wanted; scratch
// as sized by nawc_snake_backward_scratch) from x, the output gradient g
// (both contiguous, x's type) and alpha as the forward took it.
extern "C" int nawc_snake_backward(const void* x, const void* g, const float* alpha, void* dx,
                                   float* dalpha, float* scratch, int B, int C, int T, int esize,
                                   void* stream) {
  if (!valid(B, C, T, esize) || (!dx && !dalpha)) return (int)cudaErrorInvalidValue;
  const int rows = B * C;
  const bool al = aligned_alike(x, g, dx);
  float* partial = dalpha ? scratch : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (esize == 4) {
    snake_backward_kernel<float><<<grid_of(rows, T, 4), kThreads, 0, s>>>(
        (const float*)x, (const float*)g, alpha, (float*)dx, partial, rows, C, T, al);
  } else {
    snake_backward_kernel<__nv_bfloat16><<<grid_of(rows, T, 2), kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, alpha, (__nv_bfloat16*)dx, partial, rows,
        C, T, al);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !dalpha) return (int)err;
  const int per = kThreads / 32, G = chunks(T, esize);
  if (esize == 4) {
    snake_reduce_kernel<float><<<(C + per - 1) / per, kThreads, 0, s>>>(partial, dalpha, B, C, G);
  } else {
    snake_reduce_kernel<__nv_bfloat16><<<(C + per - 1) / per, kThreads, 0, s>>>(partial, dalpha, B,
                                                                                 C, G);
  }
  return (int)cudaGetLastError();
}
