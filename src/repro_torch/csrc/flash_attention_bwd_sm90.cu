// The gradient of causal (optionally sliding-window) GQA attention for bf16
// on Hopper's tensor cores.  Given q (B, H, S, D), k and v (B, KV, S, D),
// the forward's output o and its gradient dout (B, H, S, D), and the
// log-sum-exp of each row that the forward kernel (flash_attention_sm90.cu)
// saved, it computes dq, dk and dv in bf16.  D is 64, 80, 96 or 128; head h
// reads KV head h / (H / KV).  The f32 gradient stays on the SIMT kernels of
// flash_attention_bwd.cu; this file takes bf16 only.
//
// Replaces no TPU kernel: src/repro/kernels/flash_attention.py has no
// backward, because the reference trains through plain jnp attention and
// calls its Pallas kernel only from the kernel tests.  This is the gradient
// of the port's bf16 forward (FlashAttentionFn in kernels/flash_attention.py),
// so that a CUDA tensor never falls back to the plain version.
//
// What bounds it on this card: operations.  The unmasked pairs' five
// products by D (S = Q·Kᵀ, dP = dO·Vᵀ, dQ, dK, dV) need 2.58e12 operations at
// h2o-danube-1.8b's training shape (B=4, H=32, KV=8, S=8192, D=80, window
// 4096): 2.6 ms at 989 TFLOP/s, against 0.2 ms for the bytes.  This design
// executes seven products a visited pair, all on the tensor cores: S and dP
// once in each kernel, since neither kernel keeps what the other needs.
//
// Two kernels, one launch each, and no atomics.  dq sums over keys, dk and
// dv over queries and the group's H / KV heads.  One kernel that walks the
// key tiles (FlashAttention-2 and -3) has to add each block's share of dq
// with atomics, in an order that changes from run to run; here every output
// element is summed by one thread in a fixed order, so a training step gives
// the same bits on every run, at the price of S and dP computed twice.
//
//   A  (flash_bwd_dq_sm90)  one block per (b, h, 128-query tile), the
//      heaviest (last) query tiles first.  Q and dO stay resident; each
//      thread reads its two rows' saved log-sum-exp and computes their
//      D_i = Σ_d dout·o, which it also writes for kernel B.  K and V tiles
//      of 64 keys (flash_tile_plan at 128 × 64) go through a two-stage TMA
//      ring.  S = Q·Kᵀ and dP = dO·Vᵀ are wgmma m64n64k16 with both operands
//      in shared memory, K-major; P = exp2(S·c − lse) and dS = P∘(dP − D_i)
//      are computed on the f32 accumulators in registers, and dQ += dS·K
//      takes dS from registers as bf16 pairs with K as the MN-major B
//      operand.  Three products a visited pair.
//   B  (flash_bwd_dkv_sm90) one block per (b, KV head, 128-key tile), the
//      first key tiles (the heaviest under causal masking) on the lowest
//      block indices.  K and V stay resident; for each of the group's heads
//      and each query tile of 64 rows that sees the key tile
//      (flash_bwd_tile_plan at 64 × 128), Q, dO (TMA) and the rows' lse and
//      D_i (plain loads by the loading warpgroup's first warp) go through a
//      two-stage ring.
//      Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (shared memory, K-major), Pᵀ and dSᵀ in
//      registers, then dV += Pᵀ·dO and dK += dSᵀ·Q with the register A
//      operand and Q and dO read MN-major from the same swizzled tiles.  Four
//      products a visited pair; the sum over the group's heads stays in the
//      accumulators.
//
// Both kernels: 384 threads, two computing warpgroups of 64 rows and a
// loading warpgroup that setmaxnreg leaves 24 registers a thread, the
// computing ones 240, as in the forward.  ptxas still keeps their code
// within the launch's 168, so the dk/dv kernel, whose dK and dV
// accumulators take D floats a thread, spills at D >= 80 (128 bytes a
// thread at D=80, 840 at D=128).  Tiles are stored as the forward stores
// them: slabs of 64 bf16 columns with the 128-byte swizzle and, for D = 80
// and 96, a tail slab of 16 or 32 columns with the 32- or 64-byte swizzle.
// Wholly masked tiles are never loaded; only the diagonal, window-edge and
// ragged tiles apply the in-tile mask (the same integer arithmetic as the
// Python mirrors).  A masked p is 0, keys at or past S are masked, the
// window applies only under causal masking
// (repro/kernels/ref.py::flash_attention_ref), and in kernel B so are query
// rows at or past S.  Every product accumulates in f32; P and dS are
// rounded to bf16 only as the A operand of a product, as the forward rounds
// P.
//
// The log-sum-exp is in base 2 of the scores scaled by c = log2(e)/sqrt(D):
// lse = log2 Σ_t 2^(s_t·c), so that p = exp2(s·c − lse) is one fused
// multiply-add and one ex2.approx, as in the forward's softmax.
//
// A logit softcap (softcap > 0) is a second instantiation of both kernels
// (kCap; the uncapped ones are the code that ran before it).  As the
// forward does, each raw score s becomes t = tanh(s·scale/softcap),
// recomputed from S by softcap_sm90.cuh's two forms (an exp form three
// scores in four, a rational one), the capped score in raw units being
// (softcap/scale)·t,
// and p = exp2(t·c·softcap/scale − lse) against the forward's log-sum-exp of
// the capped scores; dS then takes the cap's derivative, dS = p∘(dP − D_i)∘
// (1 − t²), before dq's and dk's final ·scale.  t is recomputed where it is
// used and not kept live: the dk/dv kernel already spills at D >= 80.  The
// capped kernels' warpgroups also take turns to start their S and dP
// products (softcap_sm90.cuh).
//
// Tried on the card (tools/flash_bwd_variants.py times such variants;
// PERF.md §6): a loading warp (288 threads) instead of a warpgroup, 9 %
// slower at danube's shape; a third ring stage, within 2 % either way;
// computing P while dP is in flight and dS while dV is (three wgmma groups
// a tile), slower, with more spills.  __maxnreg__(224) at 288 threads does
// not launch (too many resources requested): nine warps put three on one
// quarter of the SM, whose 16,384 registers hold 170 a thread.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "softcap_sm90.cuh"

namespace {

constexpr int kDqBQ = 128;         // dq kernel: query rows a block
constexpr int kDqBK = 64;          // dq kernel: keys a tile
constexpr int kDkvBK = 128;        // dk/dv kernel: keys a block
constexpr int kDkvBQ = 64;         // dk/dv kernel: query rows a tile
constexpr int kStages = 2;         // ring depth of both kernels
constexpr int kComputeThreads = 256;
constexpr int kThreads = 384;      // + the loading warpgroup
constexpr int kSlabBytes = 128;    // one row of a 64-column bf16 slab
constexpr float kLog2e = 1.4426950408889634f;
// S and dP of a warpgroup: m64n64 accumulators, 32 floats a thread
constexpr int kSAcc = 32;

// A tile's row layout: kFull slabs of 64 columns (128-byte rows, 128-byte
// swizzle), then for D = 80 and 96 a tail slab of the last kTailCols = 16 or
// 32 columns (rows of kTailBytes = 32 or 64 bytes, the swizzle of that
// width).  A tile of R rows puts slab s at + s·R·128 and the tail slab at
// + kFull·R·128.
template <int D>
struct Dims {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128,
                "D must be 64, 80, 96 or 128");
  static constexpr int kFull = D / 64;
  static constexpr int kTailCols = D % 64;
  static constexpr bool kTail = kTailCols != 0;
  static constexpr int kTailBytes = 2 * kTailCols;
  // wgmma's layout type of the tail slab: 3 is the 32-byte swizzle, 2 the
  // 64-byte one
  static constexpr uint64_t kTailSwizzle = kTailCols == 16 ? 3 : 2;
  static constexpr int kAcc = D / 2;              // n=D accumulator floats
  static constexpr int kRowBytes = kFull * kSlabBytes + kTailBytes;
  // dq kernel: Q and dO resident, kStages K and V tiles, then q_full and
  // a full and an empty mbarrier per stage
  static constexpr int kDqQBytes = kDqBQ * kRowBytes;
  static constexpr int kDqKBytes = kDqBK * kRowBytes;
  static constexpr int kDqSmem =
      1024 + 2 * kDqQBytes + 2 * kStages * kDqKBytes + 8 * (1 + 2 * kStages);
  // dk/dv kernel: K and V resident, kStages Q and dO tiles, kStages rows of
  // (lse, D_i) floats, then kv_full and a full and an empty mbarrier per
  // stage (+ 1024 so the tiles can start on the swizzle's 1024-byte period)
  static constexpr int kDkvKBytes = kDkvBK * kRowBytes;
  static constexpr int kDkvQBytes = kDkvBQ * kRowBytes;
  static constexpr int kDkvRowFloats = 2 * kDkvBQ;
  static constexpr int kDkvSmem = 1024 + 2 * kDkvKBytes +
                                  2 * kStages * kDkvQBytes +
                                  4 * kStages * kDkvRowFloats +
                                  8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of `bar` with this parity has completed.  A wait
// that lasts ~8 s (a load that never lands) traps, so the launch fails
// instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One box of a 3-D tensor map into shared memory; completes `bar`'s bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Rows [row, row + R) of head `head` into an R-row tile at `dst`: one box
// per 64-column slab from `full`, and the tail columns from `tail`.
template <int D, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* full,
                                         const CUtensorMap* tail,
                                         uint32_t bar, int row, int head) {
  using P = Dims<D>;
#pragma unroll
  for (int s = 0; s < P::kFull; ++s) {
    tma_load(dst + s * R * kSlabBytes, full, bar, 64 * s, row, head);
  }
  if constexpr (P::kTail) {
    tma_load(dst + P::kFull * R * kSlabBytes, tail, bar, 64 * P::kFull, row,
             head);
  }
}

// wgmma shared-memory descriptors: start address, leading and stride byte
// offsets (each >> 4) and the swizzle (layout type 1: 128 bytes, 2: 64,
// 3: 32).
constexpr uint64_t kSwizzle128 = 1;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// K-major view of rows [r0, r0 + 64) of an R-row tile at k16 step kk of the
// D columns: four steps per 64-column slab (32 bytes apart along its rows),
// then kTailCols / 16 on the tail slab; rows at the swizzle width, 8-row
// groups at 8 rows.
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int r0, int kk) {
  using P = Dims<D>;
  if (kk < 4 * P::kFull) {
    return smem_desc(tile + (kk / 4) * R * kSlabBytes + r0 * kSlabBytes +
                         (kk % 4) * 32,
                     16, 8 * kSlabBytes, kSwizzle128);
  }
  return smem_desc(tile + P::kFull * R * kSlabBytes + r0 * P::kTailBytes +
                       32 * (kk - 4 * P::kFull),
                   16, 8 * P::kTailBytes, P::kTailSwizzle);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pin registers an asynchronous wgmma reads or writes in place: the compiler
// may not move their other uses across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[0:32] (+)= A·B for m64n64k16: A and B in shared memory, both K-major;
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t a,
                                                  uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:32] += A·B for m64n64k16: A (bf16 pairs) in registers, B in
// shared memory MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:8] += A·B for m64n16k16: A (bf16 pairs) in registers, B in
// shared memory MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_m64n16k16_rs(float* d, const uint32_t* a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:16] += A·B for m64n32k16: A (bf16 pairs) in registers, B in
// shared memory MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_m64n32k16_rs(float* d, const uint32_t* a,
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Start acc = A·Bᵀ over the D columns: A rows [a0, a0 + 64) of an Ra-row
// tile, B the 64 rows of an Rb-row tile, both K-major (S = Q·Kᵀ, dP = dO·Vᵀ
// and their transposes).
template <int D, int Ra, int Rb>
__device__ __forceinline__ void start_ss(float (&acc)[kSAcc], uint32_t a,
                                         int a0, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_m64n64k16_ss(acc, kmajor<D, Ra>(a, a0, kk), kmajor<D, Rb>(b, 0, kk),
                       kk > 0);
  }
}

// Start acc += A·B: A the 64×64 bf16 fragments `a` (the m64n64 accumulator
// layout, 16 columns a k16 step), B the 64 rows of an R-row tile read
// MN-major (the transpose flag): per 16 rows one n64 product per 64-column
// slab and one n16 (D = 80) or n32 (D = 96) product on the tail slab.
template <int D, int R>
__device__ __forceinline__ void start_rs(float (&acc)[Dims<D>::kAcc],
                                         const uint32_t (&a)[kSAcc / 2],
                                         uint32_t b) {
  using P = Dims<D>;
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
    for (int js = 0; js < P::kFull; ++js) {
      wgmma_m64n64k16_rs(
          acc + 32 * js, a + 4 * kb,
          smem_desc(b + js * R * kSlabBytes + kb * 16 * kSlabBytes,
                    R * kSlabBytes, 8 * kSlabBytes, kSwizzle128));
    }
    if constexpr (P::kTail) {
      const uint64_t desc =
          smem_desc(b + P::kFull * R * kSlabBytes + kb * 16 * P::kTailBytes,
                    16, 8 * P::kTailBytes, P::kTailSwizzle);
      if constexpr (P::kTailCols == 16) {
        wgmma_m64n16k16_rs(acc + 32 * P::kFull, a + 4 * kb, desc);
      } else {
        wgmma_m64n32k16_rs(acc + 32 * P::kFull, a + 4 * kb, desc);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void pack(uint32_t (&a)[N / 2],
                                     const float (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N / 2; ++j) a[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
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

// Σ_d o·dout of row i over this thread's quarter of the 16-byte chunks,
// summed over the quad (all four lanes take part); 0 past S.
template <int D>
__device__ __forceinline__ float row_dot(const __nv_bfloat16* __restrict__ o,
                                         const __nv_bfloat16* __restrict__ d,
                                         size_t row, bool in, int part) {
  float acc = 0.f;
  if (in) {
    const uint4* ov = reinterpret_cast<const uint4*>(o + row * D);
    const uint4* dv = reinterpret_cast<const uint4*>(d + row * D);
    for (int ch = part; ch < D / 8; ch += 4) {
      const uint4 x = ov[ch];
      const uint4 y = dv[ch];
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 xf = __bfloat1622float2(x2[e]);
        const float2 yf = __bfloat1622float2(y2[e]);
        acc = fmaf(xf.x, yf.x, acc);
        acc = fmaf(xf.y, yf.y, acc);
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// One key tile of kernel A on this thread's scores s and dp (query rows i0
// and i0 + 8, keys t0 + 8·(j/4) + cq + (j&1), the m64n64 accumulator
// layout): p = exp2(s·c − lse), masked p = 0 if kMask, dS = p·(dp − D_i)
// into dp; with kCap s is taken to t = tanh(s·cap_in) first, the capped
// score cap_r·t enters the exp2 as t·(c·cap_r), and dS takes the factor
// 1 − t².
template <bool kMask, bool kCap>
__device__ __forceinline__ void dq_tile(const float (&s)[kSAcc],
                                        float (&dp)[kSAcc], int t0, int i0,
                                        int cq, int S, int causal, int window,
                                        float c, float cap_r, float cap_in,
                                        float lse0, float lse1, float di0,
                                        float di1) {
  CapScales k{};
  if constexpr (kCap) {
    k = softcap_scales(cap_in);
    c *= cap_r;
  }
#pragma unroll
  for (int j = 0; j < kSAcc; ++j) {
    const bool hi = j & 2;
    float x = s[j];
    float t = 0.f;
    if constexpr (kCap) {
      t = softcap_tanh(j, x, k);
      x = t;
    }
    float p = exp2_approx(fmaf(x, c, -(hi ? lse1 : lse0)));
    if constexpr (kMask) {
      if (!visible(hi ? i0 + 8 : i0, t0 + 8 * (j / 4) + cq + (j & 1), S,
                   causal, window)) {
        p = 0.f;
      }
    }
    dp[j] = p * (dp[j] - (hi ? di1 : di0));
    if constexpr (kCap) dp[j] *= 1.f - t * t;
  }
}

// One query tile of kernel B on this thread's transposed scores (key rows
// t0 and t0 + 8, queries q0 + 8·(j/4) + cq + (j&1)): Pᵀ into s, dSᵀ into dp,
// with each query's lse and D_i from the stage's rows in shared memory;
// with kCap as dq_tile.
template <bool kMask, bool kCap>
__device__ __forceinline__ void dkv_tile(float (&s)[kSAcc],
                                         float (&dp)[kSAcc], int q0, int t0,
                                         int cq, int S, int causal,
                                         int window, float c, float cap_r,
                                         float cap_in, const float* lse,
                                         const float* di) {
  CapScales k{};
  if constexpr (kCap) {
    k = softcap_scales(cap_in);
    c *= cap_r;
  }
#pragma unroll
  for (int g = 0; g < kSAcc / 4; ++g) {
    const int col = 8 * g + cq;
    const float2 l = *reinterpret_cast<const float2*>(lse + col);
    const float2 d = *reinterpret_cast<const float2*>(di + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * g + e;
      float x = s[j];
      float t = 0.f;
      if constexpr (kCap) {
        t = softcap_tanh(j, x, k);
        x = t;
      }
      float p = exp2_approx(fmaf(x, c, -((e & 1) ? l.y : l.x)));
      if constexpr (kMask) {
        if (!visible(q0 + col + (e & 1), (e & 2) ? t0 + 8 : t0, S, causal,
                     window)) {
          p = 0.f;
        }
      }
      s[j] = p;
      dp[j] = p * (dp[j] - ((e & 1) ? d.y : d.x));
      if constexpr (kCap) dp[j] *= 1.f - t * t;
    }
  }
}

// Store an n=D accumulator scaled by `scale` as bf16 pairs to rows r0 and
// r0 + 8 (those below S) of the (S, D) matrix at `dst`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&acc)[Dims<D>::kAcc],
                                           float scale, int r0, int cq,
                                           int S) {
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = 8 * g + cq;
    if (r0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dst + static_cast<size_t>(r0) * D +
                                         col) =
          __floats2bfloat162_rn(acc[4 * g] * scale, acc[4 * g + 1] * scale);
    }
    if (r0 + 8 < S) {
      *reinterpret_cast<__nv_bfloat162*>(
          dst + static_cast<size_t>(r0 + 8) * D + col) =
          __floats2bfloat162_rn(acc[4 * g + 2] * scale,
                                acc[4 * g + 3] * scale);
    }
  }
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_sm90(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tq_tail,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tdo_tail,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tk_tail,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tv_tail,
                  const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse,
                  __nv_bfloat16* __restrict__ dq, float* __restrict__ dsum,
                  int H, int KV, int S, float scale, int causal, int window,
                  float cap_r, float cap_in) {
  using P = Dims<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_s = q_s + P::kDqQBytes;
  const uint32_t k_s = do_s + P::kDqQBytes;              // kStages K tiles
  const uint32_t v_s = k_s + kStages * P::kDqKBytes;     // kStages V tiles
  // mbarriers, 8 bytes each; the per-stage ones at + 8·stage
  const uint32_t q_full = v_s + kStages * P::kDqKBytes;
  const uint32_t full = q_full + 8;
  const uint32_t empty = full + 8 * kStages;

  // Heaviest query tiles first, so the last blocks to start are short.
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kDqBQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int head = b * H + h;
  const int kv_row = b * KV + h / (H / KV);

  // Key tiles to visit (flash_tile_plan at kDqBQ × kDqBK): under causal
  // masking none above the block's last query and, with a window, none
  // wholly older than its first query's window.
  const int n_kt = (S + kDqBK - 1) / kDqBK;
  int kt_lo = 0;
  int kt_hi = n_kt - 1;
  if (causal) {
    kt_hi = min(kt_hi, (q0 + kDqBQ - 1) / kDqBK);
    if (window > 0) kt_lo = max(0, q0 - window + 1) / kDqBK;
  }
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kComputeThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kComputeThreads) {
    // ---- the loading warpgroup gives its registers up to the computing
    // ones; one thread starts every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kComputeThreads) {
      mbar_expect_tx(q_full, 2 * P::kDqQBytes);
      tma_tile<D, kDqBQ>(q_s, &tq, &tq_tail, q_full, q0, head);
      tma_tile<D, kDqBQ>(do_s, &tdo, &tdo_tail, q_full, q0, head);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        const int t0 = (kt_lo + n) * kDqBK;
        // a stage is loaded again once both computing warpgroups released
        // its tile n − kStages
        if (n >= kStages) mbar_wait(empty + 8 * st, (n / kStages - 1) & 1);
        mbar_expect_tx(full + 8 * st, 2 * P::kDqKBytes);
        tma_tile<D, kDqBK>(k_s + st * P::kDqKBytes, &tk, &tk_tail,
                           full + 8 * st, t0, kv_row);
        tma_tile<D, kDqBK>(v_s + st * P::kDqKBytes, &tv, &tv_tail,
                           full + 8 * st, t0, kv_row);
      }
    }
    return;
  }

  // ---- the computing warpgroups: 64 query rows each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  // This thread's rows (i0, i0 + 8) and, in every 8-column group of an
  // accumulator, its two columns (cq, cq + 1): the wgmma D-fragment layout.
  const int i0 = q0 + 64 * wg + 16 * warp + lane / 4;
  const int i1 = i0 + 8;
  const int cq = 2 * (lane % 4);
  const float c = scale * kLog2e;
  const size_t hs = static_cast<size_t>(head) * S;
  // rows past S take lse = +inf: their p is 0 (they are not stored)
  const float lse0 = i0 < S ? lse[hs + i0] : INFINITY;
  const float lse1 = i1 < S ? lse[hs + i1] : INFINITY;
  const float di0 = row_dot<D>(o, dout, hs + i0, i0 < S, lane % 4);
  const float di1 = row_dot<D>(o, dout, hs + i1, i1 < S, lane % 4);
  if (lane % 4 == 0) {
    if (i0 < S) dsum[hs + i0] = di0;
    if (i1 < S) dsum[hs + i1] = di1;
  }

  float acc[P::kAcc];
#pragma unroll
  for (int j = 0; j < P::kAcc; ++j) acc[j] = 0.f;
  float s[kSAcc], dp[kSAcc];
  uint32_t a[kSAcc / 2];

  mbar_wait(q_full, 0);
  if constexpr (kCap) turn_init(wg);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    const int t0 = (kt_lo + n) * kDqBK;
    const uint32_t k_st = k_s + st * P::kDqKBytes;
    mbar_wait(full + 8 * st, (n / kStages) & 1);
    if constexpr (kCap) turn_wait(wg);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    start_ss<D, kDqBQ, kDqBK>(s, q_s, 64 * wg, k_st);
    start_ss<D, kDqBQ, kDqBK>(dp, do_s, 64 * wg, v_s + st * P::kDqKBytes);
    wgmma_commit();
    if constexpr (kCap) turn_pass(wg);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // In-tile mask only where the tile holds a masked pair (the diagonal,
    // the window's lower edge, keys at or past S).
    if (t0 + kDqBK > S ||
        (causal && (t0 + kDqBK - 1 > q0 ||
                    (window > 0 && t0 <= q0 + kDqBQ - 1 - window)))) {
      dq_tile<true, kCap>(s, dp, t0, i0, cq, S, causal, window, c, cap_r,
                          cap_in, lse0, lse1, di0, di1);
    } else {
      dq_tile<false, kCap>(s, dp, t0, i0, cq, S, causal, window, c, cap_r,
                           cap_in, lse0, lse1, di0, di1);
    }
    pack(a, dp);

    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
    start_rs<D, kDqBK>(acc, a, k_st);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(a);
    mbar_arrive(empty + 8 * st);
  }

  store_rows<D>(dq + hs * D, acc, scale, i0, cq, S);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_sm90(const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tk_tail,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tv_tail,
                   const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tq_tail,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tdo_tail,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, int H, int KV, int S,
                   float scale, int causal, int window, float cap_r,
                   float cap_in) {
  using P = Dims<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = ((smem_addr(smem_raw) + 1023u) & ~1023u) -
                       smem_addr(smem_raw);
  const uint32_t k_s = smem_addr(smem_raw) + pad;
  const uint32_t v_s = k_s + P::kDkvKBytes;
  const uint32_t q_s = v_s + P::kDkvKBytes;              // kStages Q tiles
  const uint32_t do_s = q_s + kStages * P::kDkvQBytes;   // kStages dO tiles
  // kStages rows of floats: the query tile's lse, then its D_i
  const uint32_t rows_off = 2 * P::kDkvKBytes + 2 * kStages * P::kDkvQBytes;
  float* rows = reinterpret_cast<float*>(smem_raw + pad + rows_off);
  const uint32_t kv_full = k_s + rows_off + 4 * kStages * P::kDkvRowFloats;
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;

  // The first key tiles, the heaviest under causal masking, start first.
  const int k0 = static_cast<int>(blockIdx.z) * kDkvBK;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KV;
  const int kv_row = b * KV + kvh;

  // Query tiles that see this key tile (flash_bwd_tile_plan at kDkvBQ ×
  // kDkvBK), for each of the group's G heads.
  const int n_qt = (S + kDkvBQ - 1) / kDkvBQ;
  int qt_lo = 0;
  int qt_hi = n_qt - 1;
  if (causal) {
    qt_lo = k0 / kDkvBQ;
    if (window > 0) qt_hi = min(qt_hi, (k0 + kDkvBK - 2 + window) / kDkvBQ);
  }
  const int n_q = qt_hi - qt_lo + 1;
  const int n_iter = G * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      // the expect_tx of the loading warp's first lane, then its 32 lanes
      // once the rows are stored
      mbar_init(full + 8 * s, 33);
      mbar_init(empty + 8 * s, kComputeThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kComputeThreads) {
    // ---- the loading warpgroup gives its registers up to the computing
    // ones; of its first warp, lane 0 starts the TMA loads and all 32 lanes
    // load the query rows' lse and D_i ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int lane = threadIdx.x - kComputeThreads;
    if (lane >= 32) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * P::kDkvKBytes);
      tma_tile<D, kDkvBK>(k_s, &tk, &tk_tail, kv_full, k0, kv_row);
      tma_tile<D, kDkvBK>(v_s, &tv, &tv_tail, kv_full, k0, kv_row);
    }
    for (int n = 0; n < n_iter; ++n) {
      const int st = n % kStages;
      const int head = b * H + kvh * G + n / n_q;
      const int q0 = (qt_lo + n % n_q) * kDkvBQ;
      if (n >= kStages) mbar_wait(empty + 8 * st, (n / kStages - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(full + 8 * st, 2 * P::kDkvQBytes);
        tma_tile<D, kDkvBQ>(q_s + st * P::kDkvQBytes, &tq, &tq_tail,
                            full + 8 * st, q0, head);
        tma_tile<D, kDkvBQ>(do_s + st * P::kDkvQBytes, &tdo, &tdo_tail,
                            full + 8 * st, q0, head);
      }
      float* r = rows + st * P::kDkvRowFloats;
      const size_t hs = static_cast<size_t>(head) * S;
#pragma unroll
      for (int e = 0; e < kDkvBQ / 32; ++e) {
        const int qi = lane + 32 * e;
        const bool in = q0 + qi < S;
        r[qi] = in ? lse[hs + q0 + qi] : 0.f;
        r[kDkvBQ + qi] = in ? dsum[hs + q0 + qi] : 0.f;
      }
      __syncwarp();
      mbar_arrive(full + 8 * st);
    }
    return;
  }

  // ---- the computing warpgroups: 64 keys each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  // This thread's key rows (t0, t0 + 8) and query columns (cq, cq + 1) of
  // every 8-column group: the same fragment layout, transposed.
  const int t0 = k0 + 64 * wg + 16 * warp + lane / 4;
  const int cq = 2 * (lane % 4);
  const float c = scale * kLog2e;

  float dk_acc[P::kAcc], dv_acc[P::kAcc];
#pragma unroll
  for (int j = 0; j < P::kAcc; ++j) {
    dk_acc[j] = 0.f;
    dv_acc[j] = 0.f;
  }
  float s[kSAcc], dp[kSAcc];
  uint32_t pa[kSAcc / 2], da[kSAcc / 2];

  mbar_wait(kv_full, 0);
  if constexpr (kCap) turn_init(wg);
  for (int n = 0; n < n_iter; ++n) {
    const int st = n % kStages;
    const int q0 = (qt_lo + n % n_q) * kDkvBQ;
    const uint32_t q_st = q_s + st * P::kDkvQBytes;
    const uint32_t do_st = do_s + st * P::kDkvQBytes;
    mbar_wait(full + 8 * st, (n / kStages) & 1);
    if constexpr (kCap) turn_wait(wg);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
    start_ss<D, kDkvBK, kDkvBQ>(s, k_s, 64 * wg, q_st);
    start_ss<D, kDkvBK, kDkvBQ>(dp, v_s, 64 * wg, do_st);
    wgmma_commit();
    if constexpr (kCap) turn_pass(wg);
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    const float* r = rows + st * P::kDkvRowFloats;
    // In-tile mask only where the tile holds a masked pair: rows or keys at
    // or past S, a key after a query (the diagonal), or a query at least
    // the window past a key.
    if (q0 + kDkvBQ > S || k0 + kDkvBK > S ||
        (causal && (k0 + kDkvBK - 1 > q0 ||
                    (window > 0 && q0 + kDkvBQ - 1 - k0 >= window)))) {
      dkv_tile<true, kCap>(s, dp, q0, t0, cq, S, causal, window, c, cap_r,
                           cap_in, r, r + kDkvBQ);
    } else {
      dkv_tile<false, kCap>(s, dp, q0, t0, cq, S, causal, window, c, cap_r,
                            cap_in, r, r + kDkvBQ);
    }
    pack(pa, s);
    pack(da, dp);

    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
    start_rs<D, kDkvBQ>(dv_acc, pa, do_st);
    start_rs<D, kDkvBQ>(dk_acc, da, q_st);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(empty + 8 * st);
  }

  const size_t base = static_cast<size_t>(kv_row) * S * D;
  store_rows<D>(dk + base, dk_acc, scale, t0, cq, S);
  store_rows<D>(dv + base, dv_acc, 1.f, t0, cq, S);
}

// cuTensorMapEncodeTiled, taken from libcuda through the runtime so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A (D, S, heads) bf16 tensor read in boxes of `cols` columns × `rows` rows
// of one head, with the swizzle of the box's row width: 64 columns (128
// bytes), 32 (64 bytes) or 16 (32 bytes).  Rows past S read as zeros.
bool tensor_map(CUtensorMap* map, EncodeTiled encode, const void* base,
                int D, int S, int heads, int rows, int cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                : cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                             : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The 64-column map and the tail map of a tensor read `rows` rows a box.
bool tensor_maps(CUtensorMap* full, CUtensorMap* tail, EncodeTiled encode,
                 const void* base, int D, int S, int heads, int rows) {
  // the tail map is read only at D = 80 (16 columns) and 96 (32)
  return tensor_map(full, encode, base, D, S, heads, rows, 64) &&
         tensor_map(tail, encode, base, D, S, heads, rows,
                    D % 64 ? D % 64 : 64);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, const void* lse,
           void* dsum, int B, int H, int KV, int S, float scale, int causal,
           int window, float softcap, cudaStream_t stream) {
  using P = Dims<D>;
  const bool cap = softcap > 0.f;
  auto* ka = cap ? flash_bwd_dq_sm90<D, true> : flash_bwd_dq_sm90<D, false>;
  auto* kb = cap ? flash_bwd_dkv_sm90<D, true> : flash_bwd_dkv_sm90<D, false>;
  const float cap_r = cap ? softcap / scale : 0.f;
  const float cap_in = cap ? scale / softcap : 0.f;
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
  // kernel A reads Q and dO 128 rows a box and K and V 64; kernel B the
  // other way round
  CUtensorMap aq, aq_t, ado, ado_t, ak, ak_t, av, av_t;
  CUtensorMap bq, bq_t, bdo, bdo_t, bk, bk_t, bv, bv_t;
  if (!tensor_maps(&aq, &aq_t, encode, q, D, S, B * H, kDqBQ) ||
      !tensor_maps(&ado, &ado_t, encode, dout, D, S, B * H, kDqBQ) ||
      !tensor_maps(&ak, &ak_t, encode, k, D, S, B * KV, kDqBK) ||
      !tensor_maps(&av, &av_t, encode, v, D, S, B * KV, kDqBK) ||
      !tensor_maps(&bq, &bq_t, encode, q, D, S, B * H, kDkvBQ) ||
      !tensor_maps(&bdo, &bdo_t, encode, dout, D, S, B * H, kDkvBQ) ||
      !tensor_maps(&bk, &bk_t, encode, k, D, S, B * KV, kDkvBK) ||
      !tensor_maps(&bv, &bv_t, encode, v, D, S, B * KV, kDkvBK)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ka<<<dim3(H, B, n_qt), kThreads, P::kDqSmem, stream>>>(
      aq, aq_t, ado, ado_t, ak, ak_t, av, av_t,
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<__nv_bfloat16*>(dq),
      static_cast<float*>(dsum), H, KV, S, scale, causal, window, cap_r,
      cap_in);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<dim3(KV, B, n_kt), kThreads, P::kDkvSmem, stream>>>(
      bk, bk_t, bv, bv_t, bq, bq_t, bdo, bdo_t,
      static_cast<const float*>(lse), static_cast<const float*>(dsum),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), H,
      KV, S, scale, causal, window, cap_r, cap_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The backward: two launches on `stream` (kernel A: dq, and D_i into the
// (B, H, S) f32 scratch `dsum`; kernel B: dk and dv).  q, o, dout, dq are
// (B, H, S, D) and k, v, dk, dv (B, KV, S, D), contiguous bf16, 16-byte
// aligned; `lse` is the forward's (B, H, S) f32 log-sum-exp in base 2 of the
// scores scaled by scale·log2(e) (capped, under a softcap; 0 for none).
// The argument list is the f32 entry's of flash_attention_bwd.cu, where
// `lse` is scratch the kernel writes.
// Allocates nothing; returns the first launch error (0 on success;
// cudaErrorInvalidValue for a head dim or grouping it is not built for).
extern "C" int flash_attention_bwd_bf16_sm90(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dsum,
    int B, int H, int KV, int S, int D, float scale, int causal, int window,
    float softcap, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KV <= 0 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define FLASH_BWD(DIM)                                                    \
  case DIM:                                                               \
    return launch<DIM>(q, k, v, o, dout, dq, dk, dv, lse, dsum, B, H, KV, \
                       S, scale, causal, window, softcap, s);
    FLASH_BWD(64) FLASH_BWD(80) FLASH_BWD(96) FLASH_BWD(128)
#undef FLASH_BWD
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a block of kernel A (`which` 0) or B (1) takes at
// head dim D (0 for a D it is not built for).
extern "C" int flash_attention_bwd_bf16_sm90_smem(int D, int which) {
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
