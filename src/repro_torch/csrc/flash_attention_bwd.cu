// The f32 gradient of causal (optionally sliding-window) GQA attention on
// Hopper: given q (B, H, S, D), k and v (B, KV, S, D), the forward's output
// o and its gradient dout (B, H, S, D), all f32, it computes dq, dk and dv
// (every product, sum and softmax statistic in f32, exact to 1e-5, which
// TF32 tensor cores could not be).  D is 64, 80, 96 or 128.  Head h reads
// KV head h / (H / KV).  The bf16 gradient runs on the tensor cores in
// flash_attention_bwd_sm90.cu.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention.py has no
// backward, because the reference trains through plain jnp attention and
// calls its Pallas kernel only from the kernel tests.  The port runs the
// training forward through flash_attention's kernels, and this is their
// gradient on the f32 route (FlashAttentionFn in kernels/flash_attention.py),
// so that a CUDA tensor never falls back to the plain version.
//
// Two kernels, one launch each, no atomics (the same bits on every run):
//
//   A  (flash_bwd_dq)  one block of 256 threads per (b, h, 64-query tile).
//      Pass 1 recomputes each row's max and log-sum-exp over the key tiles
//      the row visits (as the forward does); D_i = Σ_d dout·o.  Pass 2
//      walks the same tiles again: p = exp(s − lse), dp = dout·vᵀ,
//      ds = p·(dp − D_i), dq += ds·k.  It writes dq, and lse and D_i per
//      row for kernel B (scratch the wrapper allocates).
//   B  (flash_bwd_dkv) one block of 256 threads per (b, KV head, 64-key
//      tile).  It keeps the key and value tile in shared memory and, for
//      each of the H / KV query heads of the group and each query tile that
//      sees this key tile (flash_bwd_tile_plan), recomputes p and ds and
//      accumulates dv += pᵀ·dout and dk += dsᵀ·q in registers, so the GQA
//      sum over the group's heads never leaves the block.
//
// Both follow the f32 forward kernel's layout (csrc/flash_attention.cu):
// tiles in shared memory with rows padded to D+1 floats, four threads a
// row, a row's scores spread over its four threads and passed between them
// by warp shuffles.  Tiles wholly masked are never visited; tiles wholly
// unmasked skip the mask (the same integer arithmetic as the Python mirrors
// flash_tile_plan and flash_bwd_tile_plan).  Masked scores are -1e30 in
// pass 1, as in the forward, and p = 0 in pass 2 and in kernel B.
//
// What bounds it on this card: operations.  About 8 products of the
// visited (query, key) pairs by D, on the f32 units from shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // four threads per row of a tile
constexpr int kPer = kBK / 4;  // scores a thread holds per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kBQ * (D + 1) + 2 * kBQ);
}

// Rows [t0, t0 + 64) of a (S, D) matrix into dst as f32 (row stride D+1);
// rows at or past S are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int t0,
                                          int S, float* dst) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int row = i / D;
    const int col = i - row * D;
    const int t = t0 + row;
    dst[row * (D + 1) + col] =
        t < S ? to_f32(src[static_cast<size_t>(t) * D + col]) : 0.f;
  }
}

__device__ __forceinline__ bool visible(int i, int t, int S, int causal,
                                        int window) {
  bool ok = i < S && t < S;
  if (causal) {
    ok = ok && t <= i;
    if (window > 0) ok = ok && t > i - window;
  }
  return ok;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ o,
             const T* __restrict__ dout, T* __restrict__ dq,
             float* __restrict__ lse_out, float* __restrict__ dsum_out,
             int H, int KV, int S, float scale, int causal, int window) {
  constexpr int kDP = D + 1;
  constexpr int kAcc = D / 4;
  extern __shared__ float smem[];
  float* qs = smem;                  // (kBQ, kDP)
  float* dos = qs + kBQ * kDP;       // (kBQ, kDP)
  float* ks = dos + kBQ * kDP;       // (kBK, kDP)
  float* vs = ks + kBK * kDP;        // (kBK, kDP)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t sd = static_cast<size_t>(S) * D;
  const size_t head = (static_cast<size_t>(b) * H + h);
  const T* qb = q + head * sd;
  const T* ob = o + head * sd;
  const T* dob = dout + head * sd;
  T* dqb = dq + head * sd;
  const T* kb = k + (static_cast<size_t>(b) * KV + kvh) * sd;
  const T* vb = v + (static_cast<size_t>(b) * KV + kvh) * sd;

  const int tid = threadIdx.x;
  const int r = tid >> 2;            // query row within the tile
  const int qt = tid & 3;            // which quarter of the keys / columns
  const int lane = tid & 31;
  const int row_lane0 = lane & ~3;
  const int i = q0 + r;

  load_tile<T, D>(qb, q0, S, qs);
  load_tile<T, D>(dob, q0, S, dos);

  // D_i = Σ_d dout·o, a quarter of the columns a thread
  float dsum = 0.f;
  if (i < S) {
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const size_t at = static_cast<size_t>(i) * D + qt + 4 * j;
      dsum = __fmaf_rn(to_f32(dob[at]), to_f32(ob[at]), dsum);
    }
  }
  dsum = __fadd_rn(dsum, __shfl_xor_sync(0xffffffffu, dsum, 1));
  dsum = __fadd_rn(dsum, __shfl_xor_sync(0xffffffffu, dsum, 2));

  const int n_tiles = (S + kBK - 1) / kBK;
  int kt_lo = 0;
  int kt_hi = n_tiles - 1;
  if (causal) {
    kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }
  const float* qrow = qs + r * kDP;
  const float* dorow = dos + r * kDP;

  // pass 1: the row's max and sum, as the forward computes them
  float m = kNegInf;
  float l = 0.f;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int t0 = kt * kBK;
    __syncthreads();
    load_tile<T, D>(kb, t0, S, ks);
    __syncthreads();
    const bool need_mask =
        t0 + kBK > S ||
        (causal && (t0 + kBK - 1 > q0 ||
                    (window > 0 && t0 <= q0 + kBQ - 1 - window)));
    float s[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[j] = __fmaf_rn(qd, ks[(qt + 4 * j) * kDP + d], s[j]);
      }
    }
    float m_cur = kNegInf;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = !need_mask || visible(i, t0 + qt + 4 * j, S, causal,
                                            window);
      s[j] = ok ? __fmul_rn(s[j], scale) : kNegInf;
      m_cur = fmaxf(m_cur, s[j]);
    }
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
    m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
    const float m_new = fmaxf(m, m_cur);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      psum = __fadd_rn(psum, expf(__fsub_rn(s[j], m_new)));
    }
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 1));
    psum = __fadd_rn(psum, __shfl_xor_sync(0xffffffffu, psum, 2));
    l = __fadd_rn(__fmul_rn(expf(__fsub_rn(m, m_new)), l), psum);
    m = m_new;
  }
  const float lse = __fadd_rn(m, logf(l));

  // pass 2: dq = Σ_keys ds · k
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int t0 = kt * kBK;
    __syncthreads();
    load_tile<T, D>(kb, t0, S, ks);
    load_tile<T, D>(vb, t0, S, vs);
    __syncthreads();
    const bool need_mask =
        t0 + kBK > S ||
        (causal && (t0 + kBK - 1 > q0 ||
                    (window > 0 && t0 <= q0 + kBQ - 1 - window)));
    float s[kPer], dp[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      s[j] = 0.f;
      dp[j] = 0.f;
    }
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float od = dorow[d];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        s[j] = __fmaf_rn(qd, ks[(qt + 4 * j) * kDP + d], s[j]);
        dp[j] = __fmaf_rn(od, vs[(qt + 4 * j) * kDP + d], dp[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const bool ok = !need_mask || visible(i, t0 + qt + 4 * j, S, causal,
                                            window);
      const float p =
          ok ? expf(__fsub_rn(__fmul_rn(s[j], scale), lse)) : 0.f;
      s[j] = __fmul_rn(p, __fsub_rn(dp[j], dsum));   // ds
    }
    // acc[row, c] += Σ_key ds[row, key] · k[key, c]; the ds of key kk
    // lives in s[kk / 4] of the row's thread kk % 4.
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float ds =
          __shfl_sync(0xffffffffu, s[kk >> 2], row_lane0 | (kk & 3));
      const float* krow = ks + kk * kDP + qt;
#pragma unroll
      for (int j = 0; j < kAcc; ++j) {
        acc[j] = __fmaf_rn(ds, krow[4 * j], acc[j]);
      }
    }
  }

  if (i < S) {
    T* dqrow = dqb + static_cast<size_t>(i) * D + qt;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) store(dqrow + 4 * j, __fmul_rn(acc[j], scale));
    if (qt == 0) {
      lse_out[head * S + i] = lse;
      dsum_out[head * S + i] = dsum;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int S,
              float scale, int causal, int window) {
  constexpr int kDP = D + 1;
  constexpr int kAcc = D / 4;
  extern __shared__ float smem[];
  float* ks = smem;                  // (kBK, kDP)
  float* vs = ks + kBK * kDP;        // (kBK, kDP)
  float* qs = vs + kBK * kDP;        // (kBQ, kDP)
  float* dos = qs + kBQ * kDP;       // (kBQ, kDP)
  float* ls = dos + kBQ * kDP;       // (kBQ,) lse of the tile's rows
  float* dss = ls + kBQ;             // (kBQ,) D_i of the tile's rows

  const int k0 = blockIdx.x * kBK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const size_t sd = static_cast<size_t>(S) * D;
  const size_t kvhead = static_cast<size_t>(b) * KV + kvh;

  const int tid = threadIdx.x;
  const int kr = tid >> 2;           // key row within the tile
  const int qq = tid & 3;            // which quarter of the queries / columns
  const int lane = tid & 31;
  const int row_lane0 = lane & ~3;
  const int t = k0 + kr;

  load_tile<T, D>(k + kvhead * sd, k0, S, ks);
  load_tile<T, D>(v + kvhead * sd, k0, S, vs);

  // query tiles that see this key tile (flash_bwd_tile_plan)
  const int n_qt = (S + kBQ - 1) / kBQ;
  int qt_lo = 0;
  int qt_hi = n_qt - 1;
  if (causal) {
    qt_lo = k0 / kBQ;
    if (window > 0) qt_hi = min(qt_hi, (k0 + kBK - 2 + window) / kBQ);
  }
  const float* krow = ks + kr * kDP;
  const float* vrow = vs + kr * kDP;

  float adk[kAcc], adv[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    adk[j] = 0.f;
    adv[j] = 0.f;
  }
  for (int g = 0; g < G; ++g) {
    const size_t head = static_cast<size_t>(b) * H + kvh * G + g;
    const T* qb = q + head * sd;
    const T* dob = dout + head * sd;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();               // previous tile fully consumed
      load_tile<T, D>(qb, q0, S, qs);
      load_tile<T, D>(dob, q0, S, dos);
      if (tid < kBQ) {
        const bool in = q0 + tid < S;
        ls[tid] = in ? lse[head * S + q0 + tid] : 0.f;
        dss[tid] = in ? dsum[head * S + q0 + tid] : 0.f;
      }
      __syncthreads();
      const bool need_mask =
          q0 + kBQ > S || k0 + kBK > S ||
          (causal && (k0 + kBK - 1 > q0 ||
                      (window > 0 && q0 + kBQ - 1 - k0 >= window)));
      float p[kPer], ds[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        p[j] = 0.f;
        ds[j] = 0.f;
      }
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d];
        const float vd = vrow[d];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          p[j] = __fmaf_rn(qs[(qq + 4 * j) * kDP + d], kd, p[j]);
          ds[j] = __fmaf_rn(dos[(qq + 4 * j) * kDP + d], vd, ds[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int qi = qq + 4 * j;
        const bool ok = !need_mask || visible(q0 + qi, t, S, causal, window);
        const float pj =
            ok ? expf(__fsub_rn(__fmul_rn(p[j], scale), ls[qi])) : 0.f;
        ds[j] = __fmul_rn(pj, __fsub_rn(ds[j], dss[qi]));
        p[j] = pj;
      }
      // dv[key, c] += Σ_query p · dout[query, c], dk[key, c] += Σ_query
      // ds · q[query, c]; the p and ds of query qk live in slot qk / 4 of
      // the key row's thread qk % 4 (unrolled, so the slots stay in
      // registers).
#pragma unroll
      for (int qk = 0; qk < kBQ; ++qk) {
        const int src = row_lane0 | (qk & 3);
        const float pv = __shfl_sync(0xffffffffu, p[qk >> 2], src);
        const float dv_ = __shfl_sync(0xffffffffu, ds[qk >> 2], src);
        const float* dor = dos + qk * kDP + qq;
        const float* qr = qs + qk * kDP + qq;
#pragma unroll
        for (int j = 0; j < kAcc; ++j) {
          adv[j] = __fmaf_rn(pv, dor[4 * j], adv[j]);
          adk[j] = __fmaf_rn(dv_, qr[4 * j], adk[j]);
        }
      }
    }
  }

  if (t < S) {
    T* dkrow = dk + kvhead * sd + static_cast<size_t>(t) * D + qq;
    T* dvrow = dv + kvhead * sd + static_cast<size_t>(t) * D + qq;
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      store(dkrow + 4 * j, __fmul_rn(adk[j], scale));
      store(dvrow + 4 * j, adv[j]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* lse,
           void* dsum, int B, int H, int KV, int S, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto* ka = flash_bwd_dq<T, D>;
  auto* kb = flash_bwd_dkv<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  ka<<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, smem, stream>>>(
      qp, kp, vp, static_cast<const T*>(o), dop, static_cast<T*>(dq),
      static_cast<float*>(lse), static_cast<float*>(dsum), H, KV, S, scale,
      causal, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<dim3((S + kBK - 1) / kBK, KV, B), kThreads, smem, stream>>>(
      qp, kp, vp, dop, static_cast<const float*>(lse),
      static_cast<const float*>(dsum), static_cast<T*>(dk),
      static_cast<T*>(dv), H, KV, S, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, void* lse,
             void* dsum, int B, int H, int KV, int S, int D, float scale,
             int causal, int window, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define FLASH_BWD(DIM)                                                     \
  case DIM:                                                                \
    return launch<T, DIM>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, H,   \
                          KV, S, scale, causal, window, s);
    FLASH_BWD(64) FLASH_BWD(80) FLASH_BWD(96) FLASH_BWD(128)
#undef FLASH_BWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The backward: two launches on `stream` (kernel A: dq, and lse and D_i
// into the (B, H, S) f32 scratch `lse` and `dsum`; kernel B: dk and dv).
// q, o, dout, dq are (B, H, S, D), k, v, dk, dv (B, KV, S, D), contiguous
// f32.  Allocates nothing; returns the first launch error (0 on
// success; cudaErrorInvalidValue for a head dim or grouping it is not
// built for).
extern "C" int flash_attention_bwd_f32(const void* q, const void* k,
                                       const void* v, const void* o,
                                       const void* dout, void* dq, void* dk,
                                       void* dv, void* lse, void* dsum,
                                       int B, int H, int KV, int S, int D,
                                       float scale, int causal, int window,
                                       void* stream) {
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, H, KV,
                         S, D, scale, causal, window, stream);
}
