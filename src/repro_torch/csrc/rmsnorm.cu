// Row-wise RMSNorm on Hopper: out = x · rsqrt(mean(x²) + eps) · scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_rmsnorm_kernel (via
// rmsnorm).  The Pallas kernel reads a (block_rows × d) tile into VMEM and
// normalises it in one pass.  Here one warp takes one row: its lanes stride
// over the row accumulating the sum of squares in f32, a warp shuffle gives
// every lane the total, and a second pass over the same row (now in L1/L2)
// scales and writes it.  x is f32 or bf16, scale is f32, the arithmetic is
// f32 and the output has x's type.
//
// What bounds it on this card: bytes.  It does ~4 operations per element it
// reads and writes once, far below the ~20 operations per byte at which the
// float32 units would become the limit.  One warp per row keeps the
// reduction inside the warp (no shared memory, no block barrier), and with
// thousands of rows in flight the loads of one warp hide the latency of
// another.  The second pass reads the row again from cache, not from device
// memory, while the row is at most a few KB.
//
// Rounding follows the plain PyTorch version (rmsnorm_ref) up to the order
// of the sum of squares: (x · r) · scale, each product rounded.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,        // (rows, d)
                               const float* __restrict__ scale,  // (d,)
                               T* __restrict__ out,              // (rows, d)
                               int rows, int d, float eps) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += kWarp) {
    const float v = to_f32(xr[i]);
    ss = __fmaf_rn(v, v, ss);
  }
  for (int off = kWarp / 2; off > 0; off /= 2) {
    ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
  }
  const float var = __fdiv_rn(ss, static_cast<float>(d));
  const float r = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
  for (int i = lane; i < d; i += kWarp) {
    store(orow + i, __fmul_rn(__fmul_rn(to_f32(xr[i]), r), scale[i]));
  }
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int rows, int d,
           float eps, void* stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rmsnorm_kernel<T><<<blocks, kWarpsPerBlock * kWarp, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<T*>(out), rows, d, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream`; x and out are (rows, d) row-major, scale is (d,)
// f32.  Allocates nothing; returns the launch's cudaError_t (0 on success).
extern "C" int rmsnorm_f32(const void* x, const void* scale, void* out,
                           int rows, int d, float eps, void* stream) {
  return launch<float>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16(const void* x, const void* scale, void* out,
                            int rows, int d, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}
