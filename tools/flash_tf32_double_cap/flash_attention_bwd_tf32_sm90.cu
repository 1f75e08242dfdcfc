// The gradient of causal (optionally sliding-window) GQA attention for
// float32 on Hopper's tensor cores.  Given q (B, H, S, D), k and v
// (B, KV, S, D), the forward's output o and its gradient dout (B, H, S, D),
// and the log-sum-exp of each row that the forward kernel
// (flash_attention_tf32_sm90.cu) saved, it computes dq, dk and dv in
// float32.  D is 64, 80, 96 or 128; head h reads KV head h / (H / KV).
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention.py has no
// backward, because the reference trains through plain jnp attention and
// calls its Pallas kernel only from the kernel tests.  This is the gradient
// of the port's f32 forward (FlashAttentionFn in
// kernels/flash_attention.py), so that a CUDA tensor never falls back to
// the plain version.
//
// Accuracy: every product is the three-product tf32 split of
// sm90_common.cuh (about 2^-21 of |a·b|), so the gradients hold 1e-5
// normwise against the plain version's autograd on the card.
//
// What bounds it on this card: operations.  The unmasked pairs' five
// products by D need 6.44e11 operations at batch 1 of h2o-danube-1.8b's
// training shape (H=32, KV=8, S=8192, D=80, window 4096): 3.9 ms at a third
// of the 495 TFLOP/s of tf32, against 0.1 ms for the bytes.  This design
// executes nine products a visited pair (S and dP twice in kernel A, once
// in kernel B), each as three tf32 instructions.
//
// A pre-pass launch (split_tf32_kernel) writes into scratch the wrapper
// allocates the hi and lo planes of q, k, v and dout as they are laid out
// and of kᵀ, qᵀ and doutᵀ (tokens contiguous, permuted in groups of 8):
// wgmma on .tf32 has no transpose flag, so each product that reduces over
// tokens reads the transpose as its K-major B operand.  Then two kernels,
// one launch each, and no atomics: every output element is summed by one
// thread in a fixed order, so a training step gives the same bits on every
// run.
//
//   A  (flash_bwd_dq_tf32)  one block per (b, h, 64-query tile), the
//      heaviest (last) query tiles first: one computing warpgroup and a
//      loading warp (160 threads).  Q and dO (both planes) stay resident;
//      each thread reads its two rows' saved log-sum-exp.  K and V tiles of
//      kBK keys (flash_tile_plan at 64 × kBK) go through one ring, twice,
//      and kᵀ tiles through a second.  S = Q·Kᵀ and dP = dO·Vᵀ are three
//      wgmma m64nBKk8 a k8 step from shared memory and P = exp2(S·c − lse)
//      is computed on the f32 accumulator.  The first pass sums each row's
//      D_i = Σ_t P·dP, which it also writes for kernel B; the second
//      computes dS = P∘(dP − D_i), splits it into tf32 A fragments, and
//      dQ += dS·K is three wgmma m64nDk8 a k8 step on kᵀ.  Five products a
//      visited pair.  The first pass also sums each row's l = Σ_t P, and P
//      is taken as exp2(S·c − lse) / l in both kernels: the saved lse is
//      one f32 of the row's max plus log2 of its sum, rounded at half an
//      ulp of its magnitude, which p = exp2(S·c − lse) alone carries as a
//      relative error (~1e-6 where the max is ~50 under a cap).  In a row
//      that a few keys dominate, dS = P∘(dP − D_i) is a small difference of
//      near-equal terms, which turned that error into 1e-4 of dq on the
//      card; normalised by the l of the same terms, P sums to one as the
//      softmax's does.  D_i is likewise the sum of the very products dS is
//      made of, so that each row's dS sums to zero: rowsum(dout∘o), the
//      same sum in exact arithmetic, rounds apart from them.
//   B  (flash_bwd_dkv_tf32) one block per (b, KV head, 64-key tile), the
//      first key tiles (the heaviest under causal masking) on the lowest
//      block indices; 160 threads as A.  K and V stay resident; for each of
//      the group's heads and each query tile of kBQ rows that sees the key
//      tile (flash_bwd_tile_plan at kBQ × 64), Q and dO go through one ring
//      and qᵀ, doutᵀ and the rows' lse and D_i (plain loads by the loading
//      warp) through a second.  Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ come from shared
//      memory (their corrections summed in kernel A's order, so that they
//      round as its S and dP do), Pᵀ and dSᵀ are split in registers, then
//      dV += Pᵀ·dO and dK += dSᵀ·Q read doutᵀ and qᵀ.  Four products a
//      visited pair; the sum over the group's heads stays in registers.
//
// Shared memory decides the tiles (each element 8 bytes: hi and lo).
// Kernel A: Q and dO resident, 2·64·D·8 bytes; the rings hold K, V and kᵀ,
// 3·kBK·D·8.  Kernel B: K and V resident, 2·64·D·8; a stage holds Q,
// dO, qᵀ and doutᵀ, 4·kBQ·D·8.  One stage a ring, within 227 KB
// (DQ_TILES, DKV_TILES):
//   D =  64: A kBK 64: 64 + 96 KB = 160 KB;  B kBQ 64: 64 + 128 = 192 KB
//   D =  80: A kBK 64: 80 + 120   = 200 KB;  B kBQ 32: 80 +  80 = 160 KB
//   D =  96: A kBK 32: 96 +  72   = 168 KB;  B kBQ 32: 96 +  96 = 192 KB
//   D = 128: A kBK 32: 128 + 96   = 224 KB;  B kBQ 16: 128 + 64 = 192 KB
// The two rings of a kernel overlap each other's loads with compute: the
// first is released once S and dP are done, the second once the products
// that read it are.
//
// Wholly masked tiles are never loaded; only the diagonal, window-edge and
// ragged tiles apply the in-tile mask (the same integer arithmetic as the
// Python mirrors).  A masked p is 0, keys at or past S are masked, the
// window applies only under causal masking
// (repro/kernels/ref.py::flash_attention_ref), and in kernel B so are query
// rows at or past S.  The log-sum-exp is in base 2 of the scores scaled by
// c = log2(e)/sqrt(D), so p = exp2(s·c − lse) is one fused multiply-add and
// one ex2.approx.
//
// A logit softcap (softcap > 0) is a second instantiation of both kernels
// (kCap): each raw score s becomes the capped score less the cap,
// (softcap/scale)·(t − 1) with t = tanh(s·scale/softcap), and the cap's
// derivative 1 − t² is taken beside it, both in double (cap_score,
// sm90_common.cuh); p = exp2 of that against the forward's log-sum-exp of
// the same shifted scores (flash_attention_tf32_sm90.cu), and
// dS = p∘(dP − D_i)∘(1 − t²), before dq's and dk's final ·scale.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kDqBQ = 64;          // dq kernel: query rows a block
constexpr int kDkvBK = 64;         // dk/dv kernel: keys a block
constexpr int kComputeThreads = 128;
constexpr int kThreads = 160;      // + the loading warp
constexpr float kLog2e = 1.4426950408889634f;

// dq kernel: keys a tile per head dim (the note above).
template <int D>
struct Dq;
#define DQ_TILES(DIM, BK)                  \
  template <>                              \
  struct Dq<DIM> {                         \
    static constexpr int kBK = BK;         \
  };
DQ_TILES(64, 64)
DQ_TILES(80, 64)
DQ_TILES(96, 32)
DQ_TILES(128, 32)
#undef DQ_TILES

// dk/dv kernel: query rows a tile per head dim.
template <int D>
struct Dkv;
#define DKV_TILES(DIM, BQ)                 \
  template <>                              \
  struct Dkv<DIM> {                        \
    static constexpr int kBQ = BQ;         \
  };
DKV_TILES(64, 64)
DKV_TILES(80, 32)
DKV_TILES(96, 32)
DKV_TILES(128, 16)
#undef DKV_TILES

template <int D>
struct Dims {
  static constexpr int kAcc = D / 2;   // an n=D accumulator's floats
  // dq kernel
  static constexpr int kDqBK = Dq<D>::kBK;
  using DqQ = Tile<D, kDqBQ>;          // Q, dO: 64 rows of D columns
  using DqK = Tile<D, kDqBK>;          // K, V: kBK rows of D columns
  using DqKt = Tile<kDqBK, D>;         // kᵀ: D rows of kBK keys
  static constexpr int kDqS = kDqBK / 2;
  static constexpr int kDqSmem = 1024 + 4 * DqQ::kBytes + 4 * DqK::kBytes +
                                 2 * DqKt::kBytes + 8 * 5;
  // dk/dv kernel
  static constexpr int kDkvBQ = Dkv<D>::kBQ;
  using DkvK = Tile<D, kDkvBK>;        // K, V: 64 rows of D columns
  using DkvQ = Tile<D, kDkvBQ>;        // Q, dO: kBQ rows of D columns
  using DkvQt = Tile<kDkvBQ, D>;       // qᵀ, doutᵀ: D rows of kBQ queries
  static constexpr int kDkvS = kDkvBQ / 2;
  static constexpr int kDkvSmem = 1024 + 4 * DkvK::kBytes +
                                  4 * DkvQ::kBytes + 4 * DkvQt::kBytes +
                                  4 * 3 * kDkvBQ + 8 * 5;
  static_assert(kDqSmem <= 232448 && kDkvSmem <= 232448, "shared memory");
};

__device__ __forceinline__ bool visible(int i, int t, int S, int causal,
                                        int window) {
  bool ok = i < S && t < S;
  if (causal) {
    ok = ok && t <= i;
    if (window > 0) ok = ok && t > i - window;
  }
  return ok;
}

// One key tile of kernel A on this thread's scores (query rows i0 and
// i0 + 8, keys t0 + 8·(j/4) + cq + (j&1), the m64nN accumulator layout):
// p = exp2(x·c − lse) into s, masked p = 0 if kMask.  Without a cap x is
// the raw score; with kCap it is the capped score less the cap,
// cap_score(s), as the forward takes it (the forward's lse is of those),
// and g gets the cap's derivative 1 − tanh².
template <int N, bool kMask, bool kCap>
__device__ __forceinline__ void p_tile(float (&s)[N], float (&g)[N], int t0,
                                       int i0, int cq, int S, int causal,
                                       int window, float c, Cap cap,
                                       float lse0, float lse1) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const bool hi = j & 2;
    const float lse = hi ? lse1 : lse0;
    float p;
    if constexpr (kCap) {
      p = exp2_approx(cap_exponent(s[j], cap, c, lse, g[j]));
    } else {
      p = exp2_approx(fmaf(s[j], c, -lse));
    }
    if constexpr (kMask) {
      if (!visible(hi ? i0 + 8 : i0, t0 + 8 * (j / 4) + cq + (j & 1), S,
                   causal, window)) {
        p = 0.f;
      }
    }
    s[j] = p;
  }
}

// The p_tile of a tile, masked only where it holds a masked pair.
template <int N, bool kCap>
__device__ __forceinline__ void dq_p(float (&s)[N], float (&g)[N], int t0,
                                     int q0, int i0, int cq, int S,
                                     int causal, int window, float c,
                                     Cap cap, float lse0,
                                     float lse1, int bk) {
  // In-tile mask only where the tile holds a masked pair (the diagonal,
  // the window's lower edge, keys at or past S).
  if (t0 + bk > S ||
      (causal && (t0 + bk - 1 > q0 ||
                  (window > 0 && t0 <= q0 + kDqBQ - 1 - window)))) {
    p_tile<N, true, kCap>(s, g, t0, i0, cq, S, causal, window, c, cap, lse0,
                          lse1);
  } else {
    p_tile<N, false, kCap>(s, g, t0, i0, cq, S, causal, window, c, cap,
                           lse0, lse1);
  }
}

// One query tile of kernel B on this thread's transposed scores (key rows
// t0 and t0 + 8, queries q0 + 8·(j/4) + cq + (j&1)): Pᵀ into s, dSᵀ into dp,
// with each query's lse, D_i and 1 / l (kernel A's) from the stage's rows
// in shared memory; with kCap as p_tile, and dS takes the factor 1 − tanh².
template <int N, bool kMask, bool kCap>
__device__ __forceinline__ void dkv_tile(float (&s)[N], float (&dp)[N],
                                         int q0, int t0, int cq, int S,
                                         int causal, int window, float c,
                                         Cap cap, const float* lse,
                                         const float* di,
                                         const float* inv_l) {
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    const int col = 8 * g + cq;
    const float2 l = *reinterpret_cast<const float2*>(lse + col);
    const float2 d = *reinterpret_cast<const float2*>(di + col);
    const float2 r = *reinterpret_cast<const float2*>(inv_l + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * g + e;
      const float lse_q = (e & 1) ? l.y : l.x;
      float gc = 1.f;    // the cap's derivative
      float p;
      if constexpr (kCap) {
        p = exp2_approx(cap_exponent(s[j], cap, c, lse_q, gc));
      } else {
        p = exp2_approx(fmaf(s[j], c, -lse_q));
      }
      p *= (e & 1) ? r.y : r.x;
      if constexpr (kMask) {
        if (!visible(q0 + col + (e & 1), (e & 2) ? t0 + 8 : t0, S, causal,
                     window)) {
          p = 0.f;
        }
      }
      s[j] = p;
      dp[j] = p * (dp[j] - ((e & 1) ? d.y : d.x));
      if constexpr (kCap) dp[j] *= gc;
    }
  }
}

// Store an n=D accumulator scaled by `scale` as f32 pairs to rows r0 and
// r0 + 8 (those below S) of the (S, D) matrix at `dst`.
template <int D>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[D / 2],
                                           float scale, int r0, int cq,
                                           int S) {
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = 8 * g + cq;
    if (r0 < S) {
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0) * D + col) =
          make_float2(acc[4 * g] * scale, acc[4 * g + 1] * scale);
    }
    if (r0 + 8 < S) {
      *reinterpret_cast<float2*>(dst + static_cast<size_t>(r0 + 8) * D +
                                 col) =
          make_float2(acc[4 * g + 2] * scale, acc[4 * g + 3] * scale);
    }
  }
}

// acc += X·B for one query tile of kernel B: X (Pᵀ or dSᵀ, the m64nBQ
// accumulator layout) split into tf32 A fragments, B the D-row transposed
// tile at `bt` (doutᵀ or qᵀ, both planes); the tile's products are summed
// in acc_t from zero and added to acc in f32.
template <int D, int BQ>
__device__ __forceinline__ void tile_product(float (&acc)[D / 2],
                                             float (&acc_t)[D / 2],
                                             const float (&x)[BQ / 2],
                                             uint32_t (&ah)[BQ / 2],
                                             uint32_t (&al)[BQ / 2],
                                             uint32_t bt) {
  using T = Tile<BQ, D>;
  a_fragments(x, ah, al);
  zero(acc_t);
  fence_regs(acc_t);
  fence_regs(ah);
  fence_regs(al);
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < BQ / 8; ++kb) {
    wgmma_rs3<D>(acc_t, ah + 4 * kb, al + 4 * kb, T::desc(bt, 0, kb),
                 T::desc(bt + T::kBytes, 0, kb));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc_t);
  fence_regs(ah);
  fence_regs(al);
  add_to(acc, acc_t);
}

// The tensor maps of one launch: each split tensor's 32-column map and its
// tail (16-column) map, the rows of a box per kernel.
struct DqMaps {
  CUtensorMap q, q_t, dout, dout_t, k, k_t, v, v_t, kt, kt_t;
};
struct DkvMaps {
  CUtensorMap k, k_t, v, v_t, q, q_t, dout, dout_t, qt, qt_t, dot, dot_t;
};

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_tf32(const __grid_constant__ DqMaps m,
                  const float* __restrict__ lse, float* __restrict__ dq,
                  float* __restrict__ dsum, float* __restrict__ inv_l,
                  int H, int KV, int S, float scale, int causal, int window,
                  Cap cap) {
  using P = Dims<D>;
  constexpr int kBK = P::kDqBK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + 2 * P::DqQ::kBytes;
  const uint32_t k_s = do_s + 2 * P::DqQ::kBytes;
  const uint32_t v_s = k_s + 2 * P::DqK::kBytes;
  const uint32_t kt_s = v_s + 2 * P::DqK::kBytes;
  // mbarriers, 8 bytes each
  const uint32_t q_full = kt_s + 2 * P::DqKt::kBytes;
  const uint32_t kv_full = q_full + 8;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t kt_full = kv_empty + 8;
  const uint32_t kt_empty = kt_full + 8;

  // Heaviest query tiles first, so the last blocks to start are short.
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kDqBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int BH = gridDim.y * H, BKV = gridDim.y * KV;
  const int head = b * H + h;
  const int kv_row = b * KV + h / (H / KV);

  // Key tiles to visit (flash_tile_plan at 64 × kBK).
  const int n_kt = (S + kBK - 1) / kBK;
  int kt_lo = 0;
  int kt_hi = n_kt - 1;
  if (causal) {
    kt_hi = min(kt_hi, (q0 + kDqBQ - 1) / kBK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kComputeThreads);
    mbar_init(kt_full, 1);
    mbar_init(kt_empty, kComputeThreads);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kComputeThreads) {
    // ---- the loading warp: one thread starts every load ----
    if (threadIdx.x == kComputeThreads) {
      mbar_expect_tx(q_full, 4 * P::DqQ::kBytes);
      P::DqQ::load2(q_s, &m.q, &m.q_t, q_full, 0, q0, head, BH);
      P::DqQ::load2(do_s, &m.dout, &m.dout_t, q_full, 0, q0, head, BH);
      // K and V twice (the two passes), kᵀ in the second
      for (int n = 0; n < 2 * n_tiles; ++n) {
        const int t0 = (kt_lo + n % n_tiles) * kBK;
        // a ring is loaded again once the warpgroup released its last tile
        if (n > 0) mbar_wait(kv_empty, (n - 1) & 1);
        mbar_expect_tx(kv_full, 4 * P::DqK::kBytes);
        P::DqK::load2(k_s, &m.k, &m.k_t, kv_full, 0, t0, kv_row, BKV);
        P::DqK::load2(v_s, &m.v, &m.v_t, kv_full, 0, t0, kv_row, BKV);
        const int n2 = n - n_tiles;
        if (n2 < 0) continue;
        if (n2 > 0) mbar_wait(kt_empty, (n2 - 1) & 1);
        mbar_expect_tx(kt_full, 2 * P::DqKt::kBytes);
        P::DqKt::load2(kt_s, &m.kt, &m.kt_t, kt_full, t0, 0, kv_row, BKV);
      }
    }
    return;
  }

  // ---- the computing warpgroup: 64 query rows ----
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // This thread's rows (i0, i0 + 8) and, in every 8-column group of an
  // accumulator, its two columns (cq, cq + 1): the wgmma D-fragment layout.
  const int i0 = q0 + 16 * warp + lane / 4;
  const int i1 = i0 + 8;
  const int cq = 2 * (lane % 4);
  const float c = scale * kLog2e;
  const size_t hs = static_cast<size_t>(head) * S;
  // rows past S take lse = +inf: their p is 0 (they are not stored)
  const float lse0 = i0 < S ? lse[hs + i0] : INFINITY;
  const float lse1 = i1 < S ? lse[hs + i1] : INFINITY;

  // dQ's sum over key tiles, to which each tile's products (acc_t) are
  // added in f32 (the note at the top)
  float acc[P::kAcc], acc_t[P::kAcc];
  zero(acc);
  // scores and dP, then p and dS; b0 and b1 take their products a k8 step
  // at a time, and with a cap b0 then holds 1 − t²
  float s[P::kDqS], dp[P::kDqS], b0[P::kDqS], b1[P::kDqS];
  uint32_t ah[P::kDqS], al[P::kDqS];
  // This thread's share of its rows' Σ_t p (l) and Σ_t p·dP (pass 1); then
  // 1 / l and D_i
  float l0 = 0.f, l1 = 0.f, di0 = 0.f, di1 = 0.f;

  mbar_wait(q_full, 0);
  for (int n = 0; n < 2 * n_tiles; ++n) {
    const bool pass2 = n >= n_tiles;
    const int t0 = (kt_lo + n % n_tiles) * kBK;
    mbar_wait(kv_full, n & 1);
    score_product<kBK, D / 8>(
        s, b0, b1,
        [&](int kk, int pl) {
          return P::DqQ::desc(q_s + pl * P::DqQ::kBytes, 0, kk);
        },
        [&](int kk, int pl) {
          return P::DqK::desc(k_s + pl * P::DqK::kBytes, 0, kk);
        });
    score_product<kBK, D / 8>(
        dp, b0, b1,
        [&](int kk, int pl) {
          return P::DqQ::desc(do_s + pl * P::DqQ::kBytes, 0, kk);
        },
        [&](int kk, int pl) {
          return P::DqK::desc(v_s + pl * P::DqK::kBytes, 0, kk);
        });
    mbar_arrive(kv_empty);
    // p into s; with a cap, 1 − t² into b0
    dq_p<P::kDqS, kCap>(s, b0, t0, q0, i0, cq, S, causal, window, c, cap,
                        lse0, lse1, kBK);

    if (!pass2) {
      // the rows' l = Σ_t p and Σ_t p·dP over the products dS is made of
      // (the note at the top)
#pragma unroll
      for (int j = 0; j < P::kDqS; ++j) {
        if (j & 2) {
          l1 += s[j];
          di1 = fmaf(s[j], dp[j], di1);
        } else {
          l0 += s[j];
          di0 = fmaf(s[j], dp[j], di0);
        }
      }
      if (n == n_tiles - 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
        l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
        l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
        di0 += __shfl_xor_sync(0xffffffffu, di0, 1);
        di0 += __shfl_xor_sync(0xffffffffu, di0, 2);
        di1 += __shfl_xor_sync(0xffffffffu, di1, 1);
        di1 += __shfl_xor_sync(0xffffffffu, di1, 2);
        // rows that saw no key (past S) keep p = 0
        l0 = l0 > 0.f ? 1.f / l0 : 0.f;
        l1 = l1 > 0.f ? 1.f / l1 : 0.f;
        di0 *= l0;
        di1 *= l1;
        if (lane % 4 == 0) {
          if (i0 < S) {
            dsum[hs + i0] = di0;
            inv_l[hs + i0] = l0;
          }
          if (i1 < S) {
            dsum[hs + i1] = di1;
            inv_l[hs + i1] = l1;
          }
        }
      }
      continue;
    }

    // l0 and l1 now hold 1 / l
#pragma unroll
    for (int j = 0; j < P::kDqS; ++j) {
      const float p = s[j] * ((j & 2) ? l1 : l0);
      dp[j] = p * (dp[j] - ((j & 2) ? di1 : di0));
      if constexpr (kCap) dp[j] *= b0[j];
    }
    a_fragments(dp, ah, al);

    mbar_wait(kt_full, (n - n_tiles) & 1);
    zero(acc_t);
    fence_regs(acc_t);
    fence_regs(ah);
    fence_regs(al);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kBK / 8; ++kb) {
      wgmma_rs3<D>(acc_t, ah + 4 * kb, al + 4 * kb,
                   P::DqKt::desc(kt_s, 0, kb),
                   P::DqKt::desc(kt_s + P::DqKt::kBytes, 0, kb));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_t);
    fence_regs(ah);
    fence_regs(al);
    mbar_arrive(kt_empty);
    add_to(acc, acc_t);
  }

  store_rows<D>(dq + hs * D, acc, scale, i0, cq, S);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_tf32(const __grid_constant__ DkvMaps m,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   const float* __restrict__ inv_l, float* __restrict__ dk,
                   float* __restrict__ dv, int H, int KV, int S, float scale,
                   int causal, int window, Cap cap) {
  using P = Dims<D>;
  constexpr int kBQ = P::kDkvBQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = ((smem_addr(smem_raw) + 1023u) & ~1023u) -
                       smem_addr(smem_raw);
  const uint32_t k_s = smem_addr(smem_raw) + pad;
  const uint32_t v_s = k_s + 2 * P::DkvK::kBytes;
  const uint32_t q_s = v_s + 2 * P::DkvK::kBytes;
  const uint32_t do_s = q_s + 2 * P::DkvQ::kBytes;
  const uint32_t qt_s = do_s + 2 * P::DkvQ::kBytes;
  const uint32_t dot_s = qt_s + 2 * P::DkvQt::kBytes;
  // the query tile's lse, its D_i and its 1 / l (3·kBQ floats, the second
  // ring's)
  const uint32_t rows_off = dot_s + 2 * P::DkvQt::kBytes - k_s;
  float* rows = reinterpret_cast<float*>(smem_raw + pad + rows_off);
  const uint32_t kv_full = k_s + rows_off + 4 * 3 * kBQ;
  const uint32_t q_full = kv_full + 8;
  const uint32_t q_empty = q_full + 8;
  const uint32_t qt_full = q_empty + 8;
  const uint32_t qt_empty = qt_full + 8;

  // The first key tiles, the heaviest under causal masking, start first.
  const int k0 = static_cast<int>(blockIdx.z) * kDkvBK;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int BH = gridDim.y * H, BKV = gridDim.y * KV;
  const int G = H / KV;
  const int kv_row = b * KV + kvh;

  // Query tiles that see this key tile (flash_bwd_tile_plan at kBQ × 64),
  // for each of the group's G heads.
  const int n_qt = (S + kBQ - 1) / kBQ;
  int qt_lo = 0;
  int qt_hi = n_qt - 1;
  if (causal) {
    qt_lo = k0 / kBQ;
    if (window > 0) qt_hi = min(qt_hi, (k0 + kDkvBK - 2 + window) / kBQ);
  }
  const int n_q = qt_hi - qt_lo + 1;
  const int n_iter = G * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(q_full, 1);
    mbar_init(q_empty, kComputeThreads);
    // the expect_tx of the loading warp's first lane, then its 32 lanes
    // once the rows are stored
    mbar_init(qt_full, 33);
    mbar_init(qt_empty, kComputeThreads);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kComputeThreads) {
    // ---- the loading warp: lane 0 starts the TMA loads, all 32 lanes
    // load the query rows' lse and D_i ----
    const int lane = threadIdx.x - kComputeThreads;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 4 * P::DkvK::kBytes);
      P::DkvK::load2(k_s, &m.k, &m.k_t, kv_full, 0, k0, kv_row, BKV);
      P::DkvK::load2(v_s, &m.v, &m.v_t, kv_full, 0, k0, kv_row, BKV);
    }
    for (int n = 0; n < n_iter; ++n) {
      const int head = b * H + kvh * G + n / n_q;
      const int q0 = (qt_lo + n % n_q) * kBQ;
      if (lane == 0) {
        if (n > 0) mbar_wait(q_empty, (n - 1) & 1);
        mbar_expect_tx(q_full, 4 * P::DkvQ::kBytes);
        P::DkvQ::load2(q_s, &m.q, &m.q_t, q_full, 0, q0, head, BH);
        P::DkvQ::load2(do_s, &m.dout, &m.dout_t, q_full, 0, q0, head, BH);
      }
      if (n > 0) mbar_wait(qt_empty, (n - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(qt_full, 4 * P::DkvQt::kBytes);
        P::DkvQt::load2(qt_s, &m.qt, &m.qt_t, qt_full, q0, 0, head, BH);
        P::DkvQt::load2(dot_s, &m.dot, &m.dot_t, qt_full, q0, 0, head, BH);
      }
      const size_t hs = static_cast<size_t>(head) * S;
      for (int qi = lane; qi < kBQ; qi += 32) {
        const bool in = q0 + qi < S;
        rows[qi] = in ? lse[hs + q0 + qi] : 0.f;
        rows[kBQ + qi] = in ? dsum[hs + q0 + qi] : 0.f;
        rows[2 * kBQ + qi] = in ? inv_l[hs + q0 + qi] : 0.f;
      }
      __syncwarp();
      mbar_arrive(qt_full);
    }
    return;
  }

  // ---- the computing warpgroup: 64 keys ----
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // This thread's key rows (t0, t0 + 8) and query columns (cq, cq + 1) of
  // every 8-column group: the same fragment layout, transposed.
  const int t0 = k0 + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float c = scale * kLog2e;

  // dK's and dV's sums over the group's query tiles, to which each tile's
  // products (acc_t, dV's then dK's) are added in f32
  float dk_acc[P::kAcc], dv_acc[P::kAcc], acc_t[P::kAcc];
  zero(dk_acc);
  zero(dv_acc);
  float s[P::kDkvS], dp[P::kDkvS], b0[P::kDkvS], b1[P::kDkvS];
  uint32_t ah[P::kDkvS], al[P::kDkvS];

  mbar_wait(kv_full, 0);
  for (int n = 0; n < n_iter; ++n) {
    const int q0 = (qt_lo + n % n_q) * kBQ;
    const uint32_t phase = n & 1;
    mbar_wait(q_full, phase);
    score_product<kBQ, D / 8, true>(
        s, b0, b1,
        [&](int kk, int pl) {
          return P::DkvK::desc(k_s + pl * P::DkvK::kBytes, 0, kk);
        },
        [&](int kk, int pl) {
          return P::DkvQ::desc(q_s + pl * P::DkvQ::kBytes, 0, kk);
        });
    score_product<kBQ, D / 8, true>(
        dp, b0, b1,
        [&](int kk, int pl) {
          return P::DkvK::desc(v_s + pl * P::DkvK::kBytes, 0, kk);
        },
        [&](int kk, int pl) {
          return P::DkvQ::desc(do_s + pl * P::DkvQ::kBytes, 0, kk);
        });
    mbar_arrive(q_empty);

    mbar_wait(qt_full, phase);
    // In-tile mask only where the tile holds a masked pair: rows or keys at
    // or past S, a key after a query (the diagonal), or a query at least
    // the window past a key.
    if (q0 + kBQ > S || k0 + kDkvBK > S ||
        (causal && (k0 + kDkvBK - 1 > q0 ||
                    (window > 0 && q0 + kBQ - 1 - k0 >= window)))) {
      dkv_tile<P::kDkvS, true, kCap>(s, dp, q0, t0, cq, S, causal, window,
                                     c, cap, rows, rows + kBQ,
                                     rows + 2 * kBQ);
    } else {
      dkv_tile<P::kDkvS, false, kCap>(s, dp, q0, t0, cq, S, causal, window,
                                      c, cap, rows, rows + kBQ,
                                      rows + 2 * kBQ);
    }
    // dV += Pᵀ·dO, then dK += dSᵀ·Q, each tile's products summed apart
    tile_product<D, kBQ>(dv_acc, acc_t, s, ah, al, dot_s);
    tile_product<D, kBQ>(dk_acc, acc_t, dp, ah, al, qt_s);
    mbar_arrive(qt_empty);
  }

  const size_t base = static_cast<size_t>(kv_row) * S * D;
  store_rows<D>(dk + base, dk_acc, scale, t0, cq, S);
  store_rows<D>(dv + base, dv_acc, 1.f, t0, cq, S);
}

// The scratch of one launch, in floats: the hi and lo planes of q, dout, k
// and v as laid out, then of kᵀ, qᵀ and doutᵀ (split_floats), then the
// rows' 1 / l (kernel A's, for kernel B).
struct Scratch {
  float *q, *dout, *k, *v, *kt, *qt, *dot, *inv_l;
  static size_t floats(int B, int H, int KV, int S, int D) {
    return 2 * split_floats(B * H, S, D, false) +
           2 * split_floats(B * KV, S, D, false) +
           split_floats(B * KV, S, D, true) +
           2 * split_floats(B * H, S, D, true) +
           static_cast<size_t>(B) * H * S;
  }
  Scratch(float* base, int B, int H, int KV, int S, int D) {
    q = base;
    dout = q + split_floats(B * H, S, D, false);
    k = dout + split_floats(B * H, S, D, false);
    v = k + split_floats(B * KV, S, D, false);
    kt = v + split_floats(B * KV, S, D, false);
    qt = kt + split_floats(B * KV, S, D, true);
    dot = qt + split_floats(B * H, S, D, true);
    inv_l = dot + split_floats(B * H, S, D, true);
  }
};

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout,
           float* dq, float* dk, float* dv, const float* lse, float* dsum,
           float* scratch, int B, int H, int KV, int S, float scale,
           int causal, int window, float softcap, cudaStream_t stream) {
  using P = Dims<D>;
  const bool cap = softcap > 0.f;
  auto* ka = cap ? flash_bwd_dq_tf32<D, true> : flash_bwd_dq_tf32<D, false>;
  auto* kb = cap ? flash_bwd_dkv_tf32<D, true> : flash_bwd_dkv_tf32<D, false>;
  const Cap cap_c = cap_for(D, softcap);
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             P::kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int n_kt = (S + kDkvBK - 1) / kDkvBK;
  if (n_qt > 65535 || n_kt > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scratch sc(scratch, B, H, KV, S, D);
  SplitJobs jobs{};
  jobs.job[0] = {q, sc.q, B * H, 0};
  jobs.job[1] = {dout, sc.dout, B * H, 0};
  jobs.job[2] = {k, sc.k, B * KV, 0};
  jobs.job[3] = {v, sc.v, B * KV, 0};
  jobs.job[4] = {k, sc.kt, B * KV, 1};
  jobs.job[5] = {q, sc.qt, B * H, 1};
  jobs.job[6] = {dout, sc.dot, B * H, 1};
  jobs.S = S;
  jobs.D = D;
  // kernel A reads Q and dO 64 rows a box, K and V kBK, kᵀ D rows of kBK
  // keys; kernel B reads K and V 64 rows a box, Q and dO kBQ, qᵀ and doutᵀ
  // D rows of kBQ queries
  DqMaps ma;
  DkvMaps mb;
  const int bh = B * H, bkv = B * KV;
  if (!split_maps(&ma.q, &ma.q_t, encode, sc.q, bh, S, D, false, kDqBQ, D) ||
      !split_maps(&ma.dout, &ma.dout_t, encode, sc.dout, bh, S, D, false,
                  kDqBQ, D) ||
      !split_maps(&ma.k, &ma.k_t, encode, sc.k, bkv, S, D, false, P::kDqBK,
                  D) ||
      !split_maps(&ma.v, &ma.v_t, encode, sc.v, bkv, S, D, false, P::kDqBK,
                  D) ||
      !split_maps(&ma.kt, &ma.kt_t, encode, sc.kt, bkv, S, D, true, D,
                  P::kDqBK) ||
      !split_maps(&mb.k, &mb.k_t, encode, sc.k, bkv, S, D, false, kDkvBK,
                  D) ||
      !split_maps(&mb.v, &mb.v_t, encode, sc.v, bkv, S, D, false, kDkvBK,
                  D) ||
      !split_maps(&mb.q, &mb.q_t, encode, sc.q, bh, S, D, false, P::kDkvBQ,
                  D) ||
      !split_maps(&mb.dout, &mb.dout_t, encode, sc.dout, bh, S, D, false,
                  P::kDkvBQ, D) ||
      !split_maps(&mb.qt, &mb.qt_t, encode, sc.qt, bh, S, D, true, D,
                  P::kDkvBQ) ||
      !split_maps(&mb.dot, &mb.dot_t, encode, sc.dot, bh, S, D, true, D,
                  P::kDkvBQ)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = launch_split(jobs, 7, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  ka<<<dim3(H, B, n_qt), kThreads, P::kDqSmem, stream>>>(
      ma, lse, dq, dsum, sc.inv_l, H, KV, S, scale, causal, window, cap_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<dim3(KV, B, n_kt), kThreads, P::kDkvSmem, stream>>>(
      mb, lse, dsum, sc.inv_l, dk, dv, H, KV, S, scale, causal, window,
      cap_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward: three launches on `stream` (the pre-pass; kernel A: dq, and
// D_i into the (B, H, S) f32 scratch `dsum` and 1 / l into `scratch`;
// kernel B: dk and dv).  q, o,
// dout, dq are (B, H, S, D) and k, v, dk, dv (B, KV, S, D), contiguous
// float32 (o, which the bf16 entry reads for D_i, is not read); `lse` is
// the forward's (B, H, S) f32 log-sum-exp in base 2 of the scores scaled by
// scale·log2(e) (under a softcap, of the capped scores less the cap;
// softcap 0 for none); scratch the floats
// flash_attention_bwd_f32_tf32_sm90_scratch gives.
// Allocates nothing; returns the first launch error (0 on success;
// cudaErrorInvalidValue for a head dim or grouping it is not built for).
extern "C" int flash_attention_bwd_f32_tf32_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
    void* scratch, int B, int H, int KV, int S, int D, float scale,
    int causal, int window, float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define FLASH_BWD(DIM)                                                     \
  case DIM:                                                                \
    return launch<DIM>(                                                    \
        static_cast<const float*>(q), static_cast<const float*>(k),        \
        static_cast<const float*>(v), static_cast<const float*>(dout),     \
        static_cast<float*>(dq), static_cast<float*>(dk),                  \
        static_cast<float*>(dv),                                           \
        static_cast<const float*>(lse), static_cast<float*>(dsum),         \
        static_cast<float*>(scratch), B, H, KV, S, scale, causal, window,  \
        softcap, s);
    FLASH_BWD(64) FLASH_BWD(80) FLASH_BWD(96) FLASH_BWD(128)
#undef FLASH_BWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of scratch one launch takes (q, dout, k, v and their transposes
// split into tf32 planes).
extern "C" long long flash_attention_bwd_f32_tf32_sm90_scratch(int B, int H,
                                                               int KV, int S,
                                                               int D) {
  return static_cast<long long>(Scratch::floats(B, H, KV, S, D));
}

// Dynamic shared memory a block of kernel A (`which` 0) or B (1) takes at
// head dim D (0 for a D it is not built for).
extern "C" int flash_attention_bwd_f32_tf32_sm90_smem(int D, int which) {
  switch (D) {
    case 64:
      return which ? Dims<64>::kDkvSmem : Dims<64>::kDqSmem;
    case 80:
      return which ? Dims<80>::kDkvSmem : Dims<80>::kDqSmem;
    case 96:
      return which ? Dims<96>::kDkvSmem : Dims<96>::kDqSmem;
    case 128:
      return which ? Dims<128>::kDkvSmem : Dims<128>::kDqSmem;
    default:
      return 0;
  }
}
