// Row-wise RMSNorm on Hopper: out = x · rsqrt(mean(x²) + eps) · scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (via
// rmsnorm).  The Pallas kernel reads a (block_rows × d) tile into VMEM and
// normalises it in one pass.  x is f32 or bf16, scale is f32, the arithmetic
// is f32 and the output has x's type.
//
// What bounds it on this card: bytes.  It does ~4 operations per element it
// reads and writes once, far below the ~20 operations per byte at which the
// float32 units would become the limit.  So the design reads each row from
// device memory once, in 16-byte vectors (8 bf16 or 4 f32 per load), and
// keeps it in registers between the sum of squares and the scaling.  Three
// routes, chosen by the wrapper's rmsnorm_launch_plan (kernels/rmsnorm.py),
// which is the mirror of the launch:
//
//   warp_vec  (many rows)  one warp per row, 8 rows a block.  A lane holds N
//             16-byte vectors of its row (N fixed at compile time, so every
//             load of the row is issued before the first add), the sum of
//             squares is a warp shuffle, and the stores go out straight from
//             registers.  scale is staged once per block in shared memory
//             while the row's loads are in flight, not re-read per element.
//   block_vec (few rows: decode's 4)  one block per row, N vectors a
//             thread, partial sums across warps through shared memory.  A
//             4-row call then occupies 4 SMs and each thread does one or two
//             loads and stores, where a warp per row walked the row twice.
//   general   (d not a multiple of the vector width, a pointer off a
//             16-byte boundary, or a row wider than the block's registers)
//             one block per row with scalar loads: a first pass sums the
//             squares, a second re-reads the row from L1/L2 and scales it.
//
// Rounding follows the plain PyTorch version (rmsnorm_ref) up to the order
// of the sum of squares: (x · r) · scale, each product rounded.
//
// Backward (rmsnorm_bwd_f32 / rmsnorm_bwd_bf16, the gradient the training
// path takes through every norm; the TPU kernel has none, as the reference
// differentiates its plain jnp norm).  For x̂ = x·r, r = rsqrt(mean x² + eps)
// and the output gradient g:
//
//   dx     = r·(g·s − x̂·mean(g·s·x̂))       in x's type,
//   dscale = Σ_rows g·x̂                     in f32.
//
// Also bound by bytes (x and g read once, dx written once).  One block of
// 256 threads takes a run of consecutive rows; a thread holds the columns
// t, t + 256, ... of the current row in registers, the row's two sums
// (Σx², Σg·s·x) are one block reduction, and the thread's dscale columns
// accumulate in registers over the block's rows.  Each block writes its
// dscale partial row; a second kernel sums the partials over the blocks in
// block order, one thread a column: no atomics, so dscale is the same bits
// on every run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerWarpBlock = 8;   // warp_vec: rows (warps) a block
constexpr int kMaxBlockThreads = 512;  // block_vec and general

// Routes, as rmsnorm_launch_plan names them.
enum Route { kWarpVec = 0, kBlockVec = 1, kGeneral = 2 };

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / sizeof(T);
// float4s of scale per vector of x.
template <typename T>
constexpr int kSc = kVec<T> / 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// A 16-byte vector of T unpacked to f32, and packed back.
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ float2 bf2(unsigned int w) {
  __nv_bfloat162 b;
  *reinterpret_cast<unsigned int*>(&b) = w;
  return __bfloat1622float2(b);   // .x is the element at the lower address
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const float2 a = bf2(u.x), b = bf2(u.y), c = bf2(u.z), d = bf2(u.w);
  f[0] = a.x; f[1] = a.y; f[2] = b.x; f[3] = b.y;
  f[4] = c.x; f[5] = c.y; f[6] = d.x; f[7] = d.y;
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ unsigned int bf2_bits(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned int*>(&b);
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(bf2_bits(f[0], f[1]), bf2_bits(f[2], f[3]),
                    bf2_bits(f[4], f[5]), bf2_bits(f[6], f[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = kWarp / 2; off > 0; off /= 2) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// 1 / sqrt(ss / d + eps), rounded step by step like rmsnorm_ref.
__device__ __forceinline__ float inv_rms(float ss, int d, float eps) {
  const float var = __fdiv_rn(ss, static_cast<float>(d));
  return __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}

// Sum over the block of every thread's v (blockDim.x a multiple of 32, at
// most kMaxBlockThreads); every thread gets the same total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kMaxBlockThreads / kWarp];
  v = warp_sum(v);
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x / kWarp); ++w) {
    total = __fadd_rn(total, part[w]);
  }
  return total;
}

// Scales the vectors v[0..N) of one row, whose indices are idx(k), and
// stores them.  sc(k, q) gives the q-th float4 of scale for vector k.
template <typename T, int N, typename Idx, typename Scale>
__device__ __forceinline__ void scale_store(const uint4 (&v)[N], int nvec,
                                            float r, uint4* orow, Idx idx,
                                            Scale sc) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (idx(k) < nvec) {
      float f[kVec<T>];
      float4 s[kSc<T>];
      unpack(v[k], f);
#pragma unroll
      for (int q = 0; q < kSc<T>; ++q) s[q] = sc(k, q);
      const float* sf = reinterpret_cast<const float*>(s);
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) {
        f[e] = __fmul_rn(__fmul_rn(f[e], r), sf[e]);
      }
      orow[idx(k)] = pack(f);
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ float sum_squares(const uint4 (&v)[N], int nvec,
                                             int first, int stride) {
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (first + k * stride < nvec) {
      float f[kVec<T>];
      unpack(v[k], f);
#pragma unroll
      for (int e = 0; e < kVec<T>; ++e) ss = __fmaf_rn(f[e], f[e], ss);
    }
  }
  return ss;
}

// warp_vec: a warp per row; lane l holds vectors l, l + 32, ... of its row.
// Dynamic shared memory: d floats of scale.
template <typename T, int N>
__global__ void __launch_bounds__(kRowsPerWarpBlock * kWarp)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ out, int rows, int d, float eps) {
  extern __shared__ float4 s_scale[];
  const int lane = threadIdx.x % kWarp;
  const long long row = static_cast<long long>(blockIdx.x) *
                            kRowsPerWarpBlock + threadIdx.x / kWarp;
  const int nvec = d / kVec<T>;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4 v[N];
  if (row < rows) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k * kWarp + lane < nvec) v[k] = xr[k * kWarp + lane];
    }
  }
  const float4* sc = reinterpret_cast<const float4*>(scale);
  for (int i = threadIdx.x; i < d / 4; i += blockDim.x) s_scale[i] = sc[i];
  __syncthreads();
  if (row >= rows) return;
  const float r = inv_rms(warp_sum(sum_squares<T, N>(v, nvec, lane, kWarp)),
                          d, eps);
  scale_store<T, N>(
      v, nvec, r, reinterpret_cast<uint4*>(out + row * d),
      [&](int k) { return k * kWarp + lane; },
      [&](int k, int q) { return s_scale[(k * kWarp + lane) * kSc<T> + q]; });
}

// block_vec: a block per row; thread t holds vectors t, t + blockDim.x, ...
template <typename T, int N>
__global__ void __launch_bounds__(kMaxBlockThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     T* __restrict__ out, int d, float eps) {
  const long long row = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  const int nvec = d / kVec<T>;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  const float4* sc = reinterpret_cast<const float4*>(scale);
  uint4 v[N];
  float4 s[N][kSc<T>];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k * nt + t < nvec) {
      v[k] = xr[k * nt + t];
#pragma unroll
      for (int q = 0; q < kSc<T>; ++q) s[k][q] = sc[(k * nt + t) * kSc<T> + q];
    }
  }
  const float r =
      inv_rms(block_sum(sum_squares<T, N>(v, nvec, t, nt)), d, eps);
  scale_store<T, N>(
      v, nvec, r, reinterpret_cast<uint4*>(out + row * d),
      [&](int k) { return k * nt + t; },
      [&](int k, int q) { return s[k][q]; });
}

// general: a block per row, scalar loads, the row read twice.
template <typename T>
__global__ void __launch_bounds__(kMaxBlockThreads)
rmsnorm_general_kernel(const T* __restrict__ x,
                       const float* __restrict__ scale, T* __restrict__ out,
                       int d, float eps) {
  const long long row = blockIdx.x;
  const T* xr = x + row * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(xr[i]);
    ss = __fmaf_rn(v, v, ss);
  }
  const float r = inv_rms(block_sum(ss), d, eps);
  T* orow = out + row * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    store(orow + i, __fmul_rn(__fmul_rn(to_f32(xr[i]), r), scale[i]));
  }
}

// The vectors a thread holds, as rmsnorm_launch_plan's WARP_COUNTS and
// BLOCK_COUNTS list them.
template <typename T>
cudaError_t launch_warp(int n, const T* x, const float* scale, T* out,
                        int rows, int d, float eps, int blocks,
                        cudaStream_t s) {
#define RMS_WARP(N)                                                     \
  case N:                                                               \
    rmsnorm_warp_kernel<T, N><<<blocks, kRowsPerWarpBlock * kWarp,      \
                                d * sizeof(float), s>>>(x, scale, out,  \
                                                        rows, d, eps);  \
    break;
  switch (n) {
    RMS_WARP(1) RMS_WARP(2) RMS_WARP(3) RMS_WARP(4) RMS_WARP(5) RMS_WARP(6)
    RMS_WARP(8) RMS_WARP(10) RMS_WARP(12) RMS_WARP(16) RMS_WARP(20)
    default:
      return cudaErrorInvalidValue;
  }
#undef RMS_WARP
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_block(int n, const T* x, const float* scale, T* out,
                         int d, float eps, int threads, int blocks,
                         cudaStream_t s) {
#define RMS_BLOCK(N)                                                    \
  case N:                                                               \
    rmsnorm_block_kernel<T, N><<<blocks, threads, 0, s>>>(x, scale, out, \
                                                          d, eps);      \
    break;
  switch (n) {
    RMS_BLOCK(1) RMS_BLOCK(2) RMS_BLOCK(4) RMS_BLOCK(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef RMS_BLOCK
  return cudaGetLastError();
}

template <typename T>
int launch(const void* xp, const void* scalep, void* outp, int rows, int d,
           float eps, int route, int per_thread, int threads, int blocks,
           void* stream) {
  const T* x = static_cast<const T*>(xp);
  const float* scale = static_cast<const float*>(scalep);
  T* out = static_cast<T*>(outp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads % kWarp || threads <= 0 || threads > kMaxBlockThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == kGeneral) {
    rmsnorm_general_kernel<T><<<blocks, threads, 0, s>>>(x, scale, out, d,
                                                         eps);
    return static_cast<int>(cudaGetLastError());
  }
  // The vector routes read whole 16-byte vectors from every row start.
  const uintptr_t any = reinterpret_cast<uintptr_t>(xp) |
                        reinterpret_cast<uintptr_t>(scalep) |
                        reinterpret_cast<uintptr_t>(outp);
  if ((route != kWarpVec && route != kBlockVec) || any % 16 ||
      d % kVec<T>) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      route == kWarpVec
          ? launch_warp<T>(per_thread, x, scale, out, rows, d, eps, blocks, s)
          : launch_block<T>(per_thread, x, scale, out, d, eps, threads,
                            blocks, s));
}

// ------------------------------------------------------------- backward
constexpr int kBwdThreads = 256;        // rmsnorm_bwd_plan's BWD_THREADS
constexpr int kBwdReduceThreads = 128;  // BWD_REDUCE_THREADS

// The sums of a and b over the block (kBwdThreads threads); every thread
// gets both.  Safe to call again at once (it syncs before reusing `part`).
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 part[kBwdThreads / kWarp];
  a = warp_sum(a);
  b = warp_sum(b);
  __syncthreads();
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = make_float2(a, b);
  __syncthreads();
  float2 t = make_float2(0.f, 0.f);
#pragma unroll
  for (int w = 0; w < kBwdThreads / kWarp; ++w) {
    t.x = __fadd_rn(t.x, part[w].x);
    t.y = __fadd_rn(t.y, part[w].y);
  }
  return t;
}

// Rows [blockIdx.x · rows_per_block, +rows_per_block) of x and g: dx, and
// this block's dscale partial row partial[blockIdx.x, :].  A thread holds
// PER columns (t + k·kBwdThreads) of a row.
template <typename T, int PER>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 const T* __restrict__ g, T* __restrict__ dx,
                 float* __restrict__ partial, int rows, int d, float eps,
                 int rows_per_block) {
  const int t = threadIdx.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(static_cast<long long>(rows),
                           r0 + rows_per_block);
  float sc[PER], acc[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int col = t + k * kBwdThreads;
    sc[k] = col < d ? scale[col] : 0.f;
    acc[k] = 0.f;
  }
  const float inv_d = 1.f / static_cast<float>(d);
  for (long long row = r0; row < r1; ++row) {
    const T* xr = x + row * d;
    const T* gr = g + row * d;
    float xv[PER], gv[PER];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int col = t + k * kBwdThreads;
      xv[k] = col < d ? to_f32(xr[col]) : 0.f;
      gv[k] = col < d ? to_f32(gr[col]) : 0.f;
      ss = __fmaf_rn(xv[k], xv[k], ss);
      dot = __fmaf_rn(__fmul_rn(gv[k], sc[k]), xv[k], dot);   // g·s·x
    }
    const float2 tot = block_sum2(ss, dot);
    const float r = inv_rms(tot.x, d, eps);
    // mean(g·s·x̂) = r · Σ g·s·x / d
    const float mean = __fmul_rn(__fmul_rn(r, tot.y), inv_d);
    T* dxr = dx + row * d;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int col = t + k * kBwdThreads;
      if (col < d) {
        const float xh = __fmul_rn(xv[k], r);
        store(dxr + col, __fmul_rn(r, __fsub_rn(__fmul_rn(gv[k], sc[k]),
                                                __fmul_rn(xh, mean))));
        acc[k] = __fmaf_rn(gv[k], xh, acc[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int col = t + k * kBwdThreads;
    if (col < d) partial[static_cast<long long>(blockIdx.x) * d + col] =
        acc[k];
  }
}

// dscale[c] = Σ_b partial[b, c], the blocks in order.
__global__ void __launch_bounds__(kBwdReduceThreads)
rmsnorm_bwd_reduce(const float* __restrict__ partial,
                   float* __restrict__ dscale, int nblocks, int d) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= d) return;
  float s = 0.f;
  for (int b = 0; b < nblocks; ++b) {
    s = __fadd_rn(s, partial[static_cast<long long>(b) * d + col]);
  }
  dscale[col] = s;
}

template <typename T>
int launch_bwd(const void* xp, const void* scalep, const void* gp, void* dxp,
               void* partialp, void* dscalep, int rows, int d, float eps,
               int per_thread, int rows_per_block, int blocks,
               void* stream) {
  const T* x = static_cast<const T*>(xp);
  const float* scale = static_cast<const float*>(scalep);
  const T* g = static_cast<const T*>(gp);
  T* dx = static_cast<T*>(dxp);
  float* partial = static_cast<float*>(partialp);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_thread * kBwdThreads < d || rows_per_block <= 0 ||
      static_cast<long long>(blocks) * rows_per_block < rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define RMS_BWD(N)                                                      \
  case N:                                                               \
    rmsnorm_bwd_rows<T, N><<<blocks, kBwdThreads, 0, s>>>(              \
        x, scale, g, dx, partial, rows, d, eps, rows_per_block);        \
    break;
  switch (per_thread) {
    RMS_BWD(1) RMS_BWD(2) RMS_BWD(3) RMS_BWD(4) RMS_BWD(6) RMS_BWD(8)
    RMS_BWD(10) RMS_BWD(12) RMS_BWD(16) RMS_BWD(20) RMS_BWD(24) RMS_BWD(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RMS_BWD
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rmsnorm_bwd_reduce<<<(d + kBwdReduceThreads - 1) / kBwdReduceThreads,
                       kBwdReduceThreads, 0, s>>>(
      partial, static_cast<float*>(dscalep), blocks, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream` of the route rmsnorm_launch_plan chose (route 0
// warp_vec, 1 block_vec, 2 general; per_thread vectors a thread holds;
// threads a block, for block_vec and general; blocks).  x and out are
// (rows, d) row-major, scale is (d,) f32.  Allocates nothing; returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for a plan the
// kernel is not built for).
extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, int route,
                           int per_thread, int threads, int blocks,
                           void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, route, per_thread,
                       threads, blocks, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, int route,
                            int per_thread, int threads, int blocks,
                            void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, route,
                               per_thread, threads, blocks, stream);
}

// The backward: two launches on `stream` (the rows, then the reduction of
// the blocks' dscale partials), as rmsnorm_bwd_plan chose them (per_thread
// columns a thread holds, rows_per_block, blocks).  x, g and dx are (rows,
// d) row-major in x's type; scale, dscale (d,) and partial (blocks, d) f32.
// Allocates nothing; returns the first launch error (0 on success).
extern "C" int rmsnorm_bwd_f32(const void* x, const void* scale,
                               const void* g, void* dx, void* partial,
                               void* dscale, int rows, int d, float eps,
                               int per_thread, int rows_per_block,
                               int blocks, void* stream) {
  return launch_bwd<float>(x, scale, g, dx, partial, dscale, rows, d, eps,
                           per_thread, rows_per_block, blocks, stream);
}

extern "C" int rmsnorm_bwd_bf16(const void* x, const void* scale,
                                const void* g, void* dx, void* partial,
                                void* dscale, int rows, int d, float eps,
                                int per_thread, int rows_per_block,
                                int blocks, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, scale, g, dx, partial, dscale, rows,
                                   d, eps, per_thread, rows_per_block,
                                   blocks, stream);
}
