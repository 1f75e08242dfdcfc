// Causal (optionally sliding-window) GQA attention for float32 on Hopper's
// tensor cores.  q is (B, H, S, D), k and v are (B, KV, S, D), head h reads
// KV head h / (H / KV); the output is (B, H, S, D) float32, and each row's
// log-sum-exp, which the backward (flash_attention_bwd_tf32_sm90.cu) reads,
// is written to a (B, H, S) f32 tensor in base 2, as the bf16 forward
// (flash_attention_sm90.cu) writes it.  D is 64, 80, 96 or 128.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (via flash_attention) for float32 inputs.  The Pallas grid walks the key
// blocks as its innermost sequential dimension with the running max, sum
// and accumulator in VMEM; here one block takes one (b, h, 128-query tile)
// and walks its key tiles itself, as the bf16 kernel does.
//
// Accuracy: every product is the three-product tf32 split of
// sm90_common.cuh (a_lo·b_hi + a_hi·b_lo + a_hi·b_hi), about 2^-21 of |a·b|
// where one tf32 product would leave 2^-11, so the kernel holds 1e-5
// normwise against the plain f32 version on the card.
//
//   * A pre-pass launch (split_tf32_kernel) writes the hi and lo planes of
//     q and k as they are laid out and of vᵀ (keys contiguous, permuted in
//     groups of 8), into scratch the wrapper allocates: wgmma on .tf32 has
//     no transpose flag, so O = P·V needs vᵀ as its K-major B operand.
//   * 288 threads: warpgroups 0 and 1 compute, 64 query rows each; the first
//     thread of warp 8 starts every TMA load and the rest of it exits (a
//     block of 288 threads may take 224 registers a thread, where 384
//     would leave 168: O, a tile's P·V and P's fragments are live at once).
//   * Q's two planes (128 rows) are loaded once; K and vᵀ tiles of kBK keys
//     go through rings of kStages stages, a "full" mbarrier per stage for K
//     and for vᵀ (TMA completes them) and an "empty" one the 256 computing
//     threads arrive on when they are done with the tile.
//   * S = Q·Kᵀ: three wgmma m64nBKk8 a k8 step, both operands in shared
//     memory, each step summed apart and added in f32 (score_product).  The
//     online softmax runs on the f32 scores as in the bf16 kernel (a row in
//     a quad of threads, exp2 of s·c − m·c with c = log2(e)/sqrt(D)).  P is
//     split into hi and lo tf32 fragments in registers, and a tile's P·V is
//     three wgmma m64nDk8 a k8 step with P from registers and vᵀ from
//     shared memory, summed from zero and added to O in f32 (O·alpha + P·V):
//     the tensor cores' own sums drop bits at each instruction, and O
//     summed over a row's 4096 keys in their accumulator carried 3e-6 of
//     error on the card, a tile's sum ~5e-7.
//   * Tiles wholly above the diagonal or older than the window are never
//     loaded, and only the tiles holding a masked pair apply the in-tile
//     mask (kernels/flash_attention.py::flash_tile_plan at 128 × kBK
//     mirrors the bounds; the tests hold it against the dense mask).
//
// Shared memory decides the tiles.  The split doubles the bytes of an
// element against f32 and quadruples them against bf16: Q takes 128·D·8
// bytes (128 KB at D = 128), one K or vᵀ stage kBK·D·8.  Within the 227 KB
// a block may take (FWD_TILES, + 1 KB of alignment):
//   D =  64: kBK 64, 2 stages: 64 KB + 2 × (32 + 32) KB = 192 KB
//   D =  80: kBK 64, 1 stage:  80 KB +      (40 + 40) KB = 160 KB
//   D =  96: kBK 64, 1 stage:  96 KB +      (48 + 48) KB = 192 KB
//   D = 128: kBK 32, 1 stage: 128 KB +      (32 + 32) KB = 192 KB
// With one stage the K and vᵀ rings still overlap: K of tile n + 1 loads
// while both warpgroups run the softmax and P·V of tile n, vᵀ while they
// run S of tile n + 1.
//
// Masking follows repro/kernels/ref.py::flash_attention_ref: the window
// applies only with causal=true, masked scores are -1e30, and keys at or
// past S (which TMA returns as zeros) are masked too.
//
// A logit softcap (softcap > 0) caps the scaled scores at
// softcap·tanh(s·scale / softcap) before the mask, as the bf16 kernel does;
// it is a second instantiation of the kernel (kCap).  The kernel works on
// the capped scores less the cap, raw score s →
// (softcap/scale)·(tanh(s·(scale/softcap)) − 1) ≤ 0, computed in double
// (cap_score, sm90_common.cuh): the softmax is the same, and the scores
// that carry it (those near the cap) lose no bits to the cap's magnitude,
// which f32 would round at 3.8e-6 of ~50.  The saved log-sum-exp is then of
// the capped scores less the cap (in base 2 of the scaled scores, as
// uncapped), which the backward reads with the same shift.
//
// What bounds it on this card: operations.  At batch 1 of the
// h2o-danube-1.8b prefill (H=32, KV=8, S=4608, D=80, window 4096) the
// unmasked pairs need 1.07e11 operations, 0.65 ms at a third of the 495
// TFLOP/s of tf32 (three instructions a product), against 0.04 ms for the
// bytes.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

using namespace sm90;

constexpr int kBQ = 128;           // query rows per block (2 warpgroups × 64)
constexpr int kComputeThreads = 256;
constexpr int kThreads = 288;      // + the loading warp
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Keys a tile and ring stages per head dim (the note above).
template <int D>
struct Fwd;
#define FWD_TILES(DIM, BK, STAGES)                  \
  template <>                                       \
  struct Fwd<DIM> {                                 \
    static constexpr int kBK = BK, kStages = STAGES; \
  };
FWD_TILES(64, 64, 2)
FWD_TILES(80, 64, 1)
FWD_TILES(96, 64, 1)
FWD_TILES(128, 32, 1)
#undef FWD_TILES

template <int D>
struct Shape {
  static constexpr int kBK = Fwd<D>::kBK;
  static constexpr int kStages = Fwd<D>::kStages;
  using QT = Tile<D, kBQ>;    // Q: 128 rows of D columns
  using KT = Tile<D, kBK>;    // K: kBK rows of D columns
  using VT = Tile<kBK, D>;    // vᵀ: D rows of kBK keys
  static constexpr int kOAcc = D / 2;      // O floats per thread
  static constexpr int kSAcc = kBK / 2;    // S floats per thread
  static constexpr int kQBytes = 2 * QT::kBytes;   // hi and lo
  static constexpr int kKBytes = 2 * KT::kBytes;
  static constexpr int kVBytes = 2 * VT::kBytes;
  static constexpr int kBarriers = 1 + 4 * kStages;
  static constexpr int kSmem =
      1024 + kQBytes + kStages * (kKBytes + kVBytes) + 8 * kBarriers;
  static_assert(kSmem <= 232448, "shared memory");
};

// One tile of the online softmax on this thread's scores (rows i0 and
// i0 + 8, columns t0 + 8·(j/4) + cq + (j&1)), as in flash_attention_sm90.cu:
// mask if kMask, move the running max m, exponentiate in place, add to the
// thread's share l of the row sums; → the factors (alpha) the rows' O must
// take.  While a row has seen only masked keys its max stays -1e30 and m·c
// is taken as 0, so its probabilities are exactly 0.  With kCap each raw
// score s is first capped and less the cap: cap_score(s) (the
// note at the top).
template <int N, bool kMask, bool kCap>
__device__ __forceinline__ void softmax_tile(float (&s)[N], int t0, int i0,
                                             int cq, int S, int causal,
                                             int window, float c, Cap cap,
                                             float& m0, float& m1, float& l0,
                                             float& l1,
                                             float& alpha0, float& alpha1) {
  const int i1 = i0 + 8;
  if constexpr (kCap) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      float g;
      s[j] = static_cast<float>(cap_score(s[j], cap, g));
    }
  }
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int t = t0 + 8 * (j / 4) + cq + (j & 1);
      const int i = (j & 2) ? i1 : i0;
      bool ok = t < S;
      if (causal) {
        ok = ok && t <= i;
        if (window > 0) ok = ok && t > i - window;
      }
      if (!ok) s[j] = kNegInf;
    }
  }
  float x0[4] = {m0, m0, m0, m0}, x1[4] = {m1, m1, m1, m1};
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    x0[g % 4] = fmaxf(x0[g % 4], fmaxf(s[4 * g], s[4 * g + 1]));
    x1[g % 4] = fmaxf(x1[g % 4], fmaxf(s[4 * g + 2], s[4 * g + 3]));
  }
  float mx0 = fmaxf(fmaxf(x0[0], x0[1]), fmaxf(x0[2], x0[3]));
  float mx1 = fmaxf(fmaxf(x1[0], x1[1]), fmaxf(x1[2], x1[3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mc0 = mx0 == kNegInf ? 0.f : mx0 * c;
  const float mc1 = mx1 == kNegInf ? 0.f : mx1 * c;
  alpha0 = exp2_approx(fmaf(m0, c, -mc0));
  alpha1 = exp2_approx(fmaf(m1, c, -mc1));
  m0 = mx0;
  m1 = mx1;
  float y0[4] = {0.f, 0.f, 0.f, 0.f}, y1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    s[4 * g] = exp2_approx(fmaf(s[4 * g], c, -mc0));
    s[4 * g + 1] = exp2_approx(fmaf(s[4 * g + 1], c, -mc0));
    s[4 * g + 2] = exp2_approx(fmaf(s[4 * g + 2], c, -mc1));
    s[4 * g + 3] = exp2_approx(fmaf(s[4 * g + 3], c, -mc1));
    y0[g % 4] += s[4 * g] + s[4 * g + 1];
    y1[g % 4] += s[4 * g + 2] + s[4 * g + 3];
  }
  l0 = l0 * alpha0 + ((y0[0] + y0[1]) + (y0[2] + y0[3]));
  l1 = l1 * alpha1 + ((y1[0] + y1[1]) + (y1[2] + y1[3]));
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tq_tail,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tk_tail,
                            const __grid_constant__ CUtensorMap tvt,
                            float* __restrict__ out, float* __restrict__ lse,
                            int H, int KV, int S, float scale_log2,
                            int causal, int window, Cap cap) {
  using P = Shape<D>;
  constexpr int kBK = P::kBK;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + P::kQBytes;                // kStages K tiles
  const uint32_t v_s = k_s + kStages * P::kKBytes;      // kStages vᵀ tiles
  // mbarriers, 8 bytes each; the per-stage ones at + 8·stage
  const uint32_t q_full = v_s + kStages * P::kVBytes;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  // Heaviest query tiles first, so the last blocks to start are short.
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int kv_row = b * KV + h / (H / KV);

  // Key tiles to visit (flash_tile_plan at 128 × kBK).
  const int n_kt = (S + kBK - 1) / kBK;
  int kt_lo = 0;
  int kt_hi = n_kt - 1;
  if (causal) {
    kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kBK;
  }
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, kComputeThreads);
      mbar_init(v_empty + 8 * s, kComputeThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kComputeThreads) {
    // ---- the loading warp: one thread starts every load ----
    if (threadIdx.x == kComputeThreads) {
      mbar_expect_tx(q_full, P::kQBytes);
      P::QT::load2(q_s, &tq, &tq_tail, q_full, 0, q0, b * H + h, B * H);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        const uint32_t reuse = (n / kStages - 1) & 1;   // its last phase
        const int t0 = (kt_lo + n) * kBK;
        // a stage is loaded again once both computing warpgroups released
        // its tile n − kStages
        if (n >= kStages) mbar_wait(k_empty + 8 * st, reuse);
        mbar_expect_tx(k_full + 8 * st, P::kKBytes);
        P::KT::load2(k_s + st * P::kKBytes, &tk, &tk_tail, k_full + 8 * st,
                     0, t0, kv_row, B * KV);
        if (n >= kStages) mbar_wait(v_empty + 8 * st, reuse);
        mbar_expect_tx(v_full + 8 * st, P::kVBytes);
        P::VT::load2(v_s + st * P::kVBytes, &tvt, &tvt, v_full + 8 * st, t0,
                     0, kv_row, B * KV);
      }
    }
    return;
  }

  // ---- the computing warpgroups: 64 query rows each ----
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  // This thread's rows (i0, i0 + 8) and, in every 8-column group of an
  // accumulator, its two columns (cq, cq + 1): the wgmma D-fragment layout.
  const int i0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);

  // O's sum over key tiles, to which each tile's P·V (o_t) is added in f32
  // (rescaled by alpha as the row max moves)
  float o[P::kOAcc], o_t[P::kOAcc];
  zero(o);
  float m0 = kNegInf, m1 = kNegInf;   // running row max (raw scores)
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the row sum
  float s[P::kSAcc];                  // scores, then probabilities
  float b0[P::kSAcc], b1[P::kSAcc];   // S's products, a k8 step each
  uint32_t ph[P::kSAcc], pl[P::kSAcc];   // P's tf32 A fragments

  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    const uint32_t phase = (n / kStages) & 1;
    const int t0 = (kt_lo + n) * kBK;
    const uint32_t k_st = k_s + st * P::kKBytes;
    const uint32_t v_st = v_s + st * P::kVBytes;
    mbar_wait(k_full + 8 * st, phase);
    score_product<kBK, D / 8>(
        s, b0, b1,
        [&](int kk, int pl) {
          return P::QT::desc(q_s + pl * P::QT::kBytes, 64 * wg, kk);
        },
        [&](int kk, int pl) {
          return P::KT::desc(k_st + pl * P::KT::kBytes, 0, kk);
        });
    mbar_arrive(k_empty + 8 * st);

    // In-tile mask only where the tile holds a masked pair (the diagonal,
    // the window's lower edge, keys at or past S).
    float alpha0, alpha1;
    if (t0 + kBK > S ||
        (causal && (t0 + kBK - 1 > q0 ||
                    (window > 0 && t0 <= q0 + kBQ - 1 - window)))) {
      softmax_tile<P::kSAcc, true, kCap>(s, t0, i0, cq, S, causal, window,
                                         scale_log2, cap, m0, m1,
                                         l0, l1, alpha0, alpha1);
    } else {
      softmax_tile<P::kSAcc, false, kCap>(s, t0, i0, cq, S, causal, window,
                                          scale_log2, cap, m0, m1,
                                          l0, l1, alpha0, alpha1);
    }
    a_fragments(s, ph, pl);

    mbar_wait(v_full + 8 * st, phase);
    zero(o_t);
    fence_regs(o_t);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kBK / 8; ++kb) {
      wgmma_rs3<D>(o_t, ph + 4 * kb, pl + 4 * kb, P::VT::desc(v_st, 0, kb),
                   P::VT::desc(v_st + P::VT::kBytes, 0, kb));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_t);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(v_empty + 8 * st);
#pragma unroll
    for (int j = 0; j < P::kOAcc; ++j) {
      o[j] = fmaf(o[j], (j & 2) ? alpha1 : alpha0, o_t[j]);
    }
  }

  // epilogue: the row sums over the quad, normalise, store f32 pairs
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  const int i1 = i0 + 8;
  float* ob = out + static_cast<size_t>(b * H + h) * S * D;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = 8 * g + cq;
    if (i0 < S) {
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(i0) * D + col) =
          make_float2(o[4 * g] * inv0, o[4 * g + 1] * inv0);
    }
    if (i1 < S) {
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(i1) * D + col) =
          make_float2(o[4 * g + 2] * inv1, o[4 * g + 3] * inv1);
    }
  }
  // Each row's log-sum-exp for the backward, in base 2 of the scaled
  // scores: log2 Σ_t 2^(s_t·c) = m·c + log2(l); +inf for a row that saw no
  // key.
  if (cq == 0) {
    float* lb = lse + static_cast<size_t>(b * H + h) * S;
    if (i0 < S) lb[i0] = l0 == 0.f ? INFINITY : m0 * scale_log2 + log2f(l0);
    if (i1 < S) lb[i1] = l1 == 0.f ? INFINITY : m1 * scale_log2 + log2f(l1);
  }
}

// Floats of the scratch a launch takes: the hi and lo planes of q and k as
// laid out, and of vᵀ.
size_t scratch_floats(int B, int H, int KV, int S, int D) {
  return split_floats(B * H, S, D, false) + split_floats(B * KV, S, D, false) +
         split_floats(B * KV, S, D, true);
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out,
           float* lse, float* scratch, int B, int H, int KV, int S,
           float scale, int causal, int window, float softcap,
           cudaStream_t stream) {
  using P = Shape<D>;
  const bool cap = softcap > 0.f;
  auto* kernel = cap ? flash_attention_tf32_kernel<D, true>
                     : flash_attention_tf32_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  float* qs = scratch;
  float* ks = qs + split_floats(B * H, S, D, false);
  float* vt = ks + split_floats(B * KV, S, D, false);
  SplitJobs jobs{};
  jobs.job[0] = {q, qs, B * H, 0};
  jobs.job[1] = {k, ks, B * KV, 0};
  jobs.job[2] = {v, vt, B * KV, 1};
  jobs.S = S;
  jobs.D = D;
  CUtensorMap tq, tq_tail, tk, tk_tail, tvt, tvt_tail;
  if (!split_maps(&tq, &tq_tail, encode, qs, B * H, S, D, false, kBQ, D) ||
      !split_maps(&tk, &tk_tail, encode, ks, B * KV, S, D, false, P::kBK,
                  D) ||
      !split_maps(&tvt, &tvt_tail, encode, vt, B * KV, S, D, true, D,
                  P::kBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  err = launch_split(jobs, 3, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, P::kSmem, stream>>>(
      tq, tq_tail, tk, tk_tail, tvt, out, lse, H, KV, S, scale * kLog2e,
      causal, window, cap_for(D, softcap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One pre-pass and one attention launch on `stream`; q, k, v and out
// contiguous float32; lse the (B, H, S) f32 log-sum-exp of each row
// (written); scratch the floats flash_attention_f32_tf32_sm90_scratch gives
// (written).  H must be a multiple of KV and D one of 64, 80, 96, 128 (else
// cudaErrorInvalidValue); softcap 0 for none.  Allocates nothing; returns
// the first launch error (0 on success).
extern "C" int flash_attention_f32_tf32_sm90(const void* q, const void* k,
                                             const void* v, void* out,
                                             void* lse, void* scratch, int B,
                                             int H, int KV, int S, int D,
                                             float scale, int causal,
                                             int window, float softcap,
                                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  auto* lf = static_cast<float*>(lse);
  auto* sf = static_cast<float*>(scratch);
  switch (D) {
#define FLASH_FWD(DIM)                                                       \
  case DIM:                                                                  \
    return launch<DIM>(qf, kf, vf, of, lf, sf, B, H, KV, S, scale, causal,   \
                       window, softcap, st);
    FLASH_FWD(64) FLASH_FWD(80) FLASH_FWD(96) FLASH_FWD(128)
#undef FLASH_FWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Floats of scratch one launch takes (q, k and vᵀ split into tf32 planes).
extern "C" long long flash_attention_f32_tf32_sm90_scratch(int B, int H,
                                                           int KV, int S,
                                                           int D) {
  return static_cast<long long>(scratch_floats(B, H, KV, S, D));
}

// Dynamic shared memory one block of the kernel takes at head dim D (0 for
// a D it is not built for).
extern "C" int flash_attention_f32_tf32_sm90_smem(int D) {
  switch (D) {
    case 64:
      return Shape<64>::kSmem;
    case 80:
      return Shape<80>::kSmem;
    case 96:
      return Shape<96>::kSmem;
    case 128:
      return Shape<128>::kSmem;
    default:
      return 0;
  }
}
