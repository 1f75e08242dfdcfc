// Causal (optionally sliding-window) GQA attention with an online softmax on
// Hopper, in float32.  q is (B, H, S, D), k and v are (B, KV, S, D), head h
// reads KV head h / (H / KV); the output is (B, H, S, D).  D is 64, 80 or
// 128.  bf16 attention runs flash_attention_sm90.cu on the tensor cores;
// this kernel keeps f32 exact to 1e-5 (TF32 tensor cores could not), for
// the float32 prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (via flash_attention).  The Pallas grid makes the key blocks its innermost
// sequential dimension and carries the running max, sum and accumulator in
// VMEM scratch across grid steps.  Here one block of 256 threads takes one
// (b, h, 64-query tile) and loops over the 64-key tiles itself, so the
// running state never leaves the SM:
//
//   * the query tile and the current key and value tiles sit in shared
//     memory (rows padded to D+1 floats, so the lanes of a warp read
//     distinct banks);
//   * four threads share one query row: each computes the scores of 16 of
//     the tile's 64 keys, the row's max and sum are reduced over the four
//     with two warp shuffles, and each thread keeps D/4 of the row's
//     accumulator in registers; the probabilities reach the other three
//     threads of the row by shuffles, not through shared memory;
//   * key tiles wholly above the diagonal or wholly older than the window
//     are never loaded (the Pallas kernel's pl.when skip), so a 4608-token
//     prompt under a 4096 window does ~half the work of full attention.
//
// Masking follows repro/kernels/ref.py::flash_attention_ref: the window
// applies only with causal=true (the Pallas kernel also skips blocks by the
// window when causal=false, but its in-block mask does not apply it).
// Masked scores are -1e30, as in the Pallas kernel, so a row whose first
// tiles are all masked carries exp(0) terms that the first unmasked tile's
// correction exp(-1e30 − m) wipes out; under causal masking every row has
// its diagonal key, so no row ends fully masked.
//
// What bounds it on this card: operations.  At the h2o-danube-1.8b prefill
// shape it does ~900 multiply-adds per byte of q, k, v and o, on the f32
// units from shared memory (one shared load per multiply-add).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 4 threads per query row
constexpr int kKeysPerThread = kBK / 4;
constexpr float kNegInf = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * (D + 1) + kBK * (D + 1) + kBK * D);
}

// Rows [t0, t0 + 64) of a (S, D) matrix into dst (row stride `stride`);
// rows at or past S are zero.  Loads query tiles too (kBQ == kBK).
template <int D>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int t0, int S, float* dst,
                                          int stride) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int row = i / D;
    const int col = i - row * D;
    const int t = t0 + row;
    dst[row * stride + col] =
        t < S ? src[static_cast<size_t>(t) * D + col] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int H, int KV, int S, float scale, int causal,
                       int window) {
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  constexpr int kDP = D + 1;         // padded row stride
  constexpr int kAcc = D / 4;        // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                  // (kBQ, kDP)
  float* ks = qs + kBQ * kDP;        // (kBK, kDP)
  float* vs = ks + kBK * kDP;        // (kBK, D)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t sd = static_cast<size_t>(S) * D;
  const float* qb = q + (static_cast<size_t>(b) * H + h) * sd;
  const float* kb = k + (static_cast<size_t>(b) * KV + kvh) * sd;
  const float* vb = v + (static_cast<size_t>(b) * KV + kvh) * sd;
  float* ob = out + (static_cast<size_t>(b) * H + h) * sd;

  const int tid = threadIdx.x;
  const int r = tid >> 2;            // query row within the tile
  const int qt = tid & 3;            // which quarter of the row's keys / d
  const int lane = tid & 31;
  const int row_lane0 = lane & ~3;
  const int i = q0 + r;              // query index

  load_tile<D>(qb, q0, S, qs, kDP);

  // Key tiles to visit: under causal masking, none above the block's last
  // query, and (with a window) none wholly older than its first query's
  // window.  Without causal masking, all of them (see the note above).
  const int n_tiles = (S + kBK - 1) / kBK;
  int kt_lo = 0;
  int kt_hi = n_tiles - 1;
  if (causal) {
    kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }

  float m = kNegInf;
  float l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int t0 = kt * kBK;
    __syncthreads();                 // previous tile fully consumed
    load_tile<D>(kb, t0, S, ks, kDP);
    load_tile<D>(vb, t0, S, vs, D);
    __syncthreads();

    float s[kKeysPerThread];
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) s[j] = 0.f;
    const float* qrow = qs + r * kDP;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        s[j] = __fmaf_rn(qd, ks[(qt + 4 * j) * kDP + d], s[j]);
      }
    }
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      const int t = t0 + qt + 4 * j;
      bool ok = t < S;
      if (causal) {
        ok = ok && t <= i;
        if (window > 0) ok = ok && t > i - window;
      }
      s[j] = ok ? __fmul_rn(s[j], scale) : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kKeysPerThread; ++j) {
      s[j] = expf(__fsub_rn(s[j], m_new));
      psum = __fadd_rn(psum, s[j]);
    }
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 2));
    const float alpha = expf(__fsub_rn(m, m_new));
    l = __fadd_rn(__fmul_rn(alpha, l), psum);
    m = m_new;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = __fmul_rn(acc[j], alpha);
    // acc[row, d] += Σ_key p[row, key] · v[key, d]; the p of key kk lives in
    // s[kk / 4] of the row's thread kk % 4.
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float p =
          __shfl_sync(0xffffffffu, s[kk >> 2], row_lane0 | (kk & 3));
      const float* vrow = vs + kk * D + qt;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        acc[j] = __fmaf_rn(p, vrow[4 * j], acc[j]);
      }
    }
  }

  if (i < S) {
    const float inv = l == 0.f ? 1.f : l;
    float* orow = ob + static_cast<size_t>(i) * D + qt;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) orow[4 * j] = __fdiv_rn(acc[j], inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  auto* kernel = flash_attention_kernel<D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, KV, S,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream`; all tensors contiguous.  H must be a multiple of
// KV and D one of 64, 80, 128 (else cudaErrorInvalidValue).  Allocates
// nothing; returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* out, int B, int H,
                                   int KV, int S, int D, float scale,
                                   int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, B, H, KV, S, scale, causal, window, s);
    case 80:
      return launch<80>(q, k, v, out, B, H, KV, S, scale, causal, window, s);
    case 128:
      return launch<128>(q, k, v, out, B, H, KV, S, scale, causal, window,
                         s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
