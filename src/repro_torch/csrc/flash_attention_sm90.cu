// Causal (optionally sliding-window) GQA attention for bf16 on Hopper's
// tensor cores.  q is (B, H, S, D), k and v are (B, KV, S, D), head h reads
// KV head h / (H / KV); the output is (B, H, S, D) bf16, and each row's
// log-sum-exp, which the backward (flash_attention_bwd_sm90.cu) reads, is
// written to a (B, H, S) f32 tensor in base 2 (see the epilogue).  D is 64,
// 80, 96 or 128.  The f32 entry stays on the SIMT kernel of
// flash_attention.cu, which is exact to 1e-5; this file takes bf16 only.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::_flash_kernel
// (via flash_attention).  The Pallas grid walks the key blocks as its
// innermost sequential dimension with the running max, sum and accumulator
// in VMEM.  Here one block takes one (b, h, 128-query tile) and walks its key
// tiles itself:
//
//   * 384 threads: warpgroups 0 and 1 compute, 64 query rows each; the first
//     thread of warpgroup 2 starts every TMA load and the rest of it exits.
//     setmaxnreg gives the loading warpgroup 24 registers a thread and the
//     computing ones 240; ptxas still keeps their code within the launch's
//     168, but the kernel ran faster with it than without on the card.
//   * Q (128 rows) is loaded once; K and V tiles of 128 keys go through a
//     ring of two stages in shared memory, with a "full" mbarrier per stage
//     for K and for V (TMA completes them) and an "empty" one the 256
//     computing threads arrive on when they are done with the tile.
//   * A tile is stored as slabs of 64 bf16 columns (128-byte rows, the
//     128-byte swizzle of TMA and wgmma) and, for D = 80 and 96, a tail slab
//     of the last 16 or 32 columns (32- or 64-byte rows, the 32- or 64-byte
//     swizzle).  A second 64-column box whose columns past D TMA fills with
//     zeros loaded slower on the card (PERF.md); the tail slab reads
//     exactly the row's bytes.
//   * S = Q·Kᵀ is wgmma m64n128k16 with both operands in shared memory,
//     K-major: D/16 k16 steps (four per 64-column slab, one or two on the
//     tail slab, each 32 bytes further along its rows).  The softmax runs on the f32 accumulator in registers: a row
//     lives in the 4 threads of a quad, its max is reduced with two
//     shuffles, exp2 takes s·c − m·c (c = log2(e)/sqrt(D)) as one fused
//     multiply-add, and each thread keeps its share of the row sum until the
//     epilogue.
//   * O += P·V takes P from registers: the m64n128 accumulator has the layout
//     of the A fragment, so P is the probabilities converted to bf16 pairs
//     in place (FlashAttention-3 does the same).  V is the B operand,
//     MN-major (the transpose flag): one m64n64k16 per 64-column slab and
//     one m64n16k16 (D = 80) or m64n32k16 (D = 96) on the tail slab.
//   * Tiles wholly above the diagonal or older than the window are never
//     loaded, and only the tiles that hold a masked pair (the diagonal, the
//     window's lower edge, the ragged last tile) apply the in-tile mask.
//     kernels/flash_attention.py::flash_tile_plan mirrors these bounds and
//     the tests hold it against the dense mask.
//
// Masking follows repro/kernels/ref.py::flash_attention_ref: the window
// applies only with causal=true, masked scores are -1e30, and keys at or
// past S (which TMA returns as zeros) are masked too.  P is rounded to bf16
// for the product (the plain version keeps it in f32); the row sums stay in
// f32.
//
// What bounds it on this card: operations.  At the h2o-danube-1.8b prefill
// (B=4, H=32, KV=8, S=4608, D=80, window 4096) the unmasked pairs need
// 4.3e11 operations on the bf16 tensor cores (0.43 ms at 989 TFLOP/s)
// against 0.07 ms for the bytes.  Every multiply-add runs on the tensor
// cores and loads stay off the computing warps; what is left is that a
// warpgroup's softmax does not overlap its own products, only the other
// warpgroup's.  FlashAttention-3's remedy was tried on the card (PERF.md):
// starting S(n) with P(n−1)·V(n−1), running the softmax between the two
// waits, with the two warpgroups taking turns to start them.  ptxas (CUDA 12.9)
// moves the second wait ahead of the softmax, also with P double-buffered
// and 255 registers a thread to spare, so it gained nothing; this loop is
// the simplest of the variants tried, and the fastest.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;           // query rows per block (2 warpgroups × 64)
constexpr int kBK = 128;           // keys per tile
constexpr int kStages = 2;         // K/V ring depth
constexpr int kComputeThreads = 256;
constexpr int kThreads = 384;      // + the loading warpgroup
constexpr int kSlabBytes = 128;    // one row of a 64-column bf16 slab
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// A tile of `rows` rows of D columns in shared memory: kFull slabs of 64
// columns (128-byte rows, 128-byte swizzle), then for D = 80 and 96 a tail
// slab of the last kTailCols = 16 or 32 columns (rows of kTailBytes = 32 or
// 64 bytes, the swizzle of that width).
template <int D>
struct Shape {
  static_assert(D == 64 || D == 80 || D == 96 || D == 128,
                "D must be 64, 80, 96 or 128");
  static constexpr int kFull = D / 64;            // 64-column slabs
  static constexpr int kTailCols = D % 64;        // 0, 16 or 32
  static constexpr bool kTail = kTailCols != 0;
  static constexpr int kTailBytes = 2 * kTailCols;
  // wgmma's layout type of the tail slab: 3 is the 32-byte swizzle, 2 the
  // 64-byte one
  static constexpr uint64_t kTailSwizzle = kTailCols == 16 ? 3 : 2;
  static constexpr int kOAcc = D / 2;             // O floats per thread
  static constexpr int kRowBytes =
      kFull * kSlabBytes + kTailBytes;
  static constexpr int kQBytes = kBQ * kRowBytes;
  static constexpr int kKVBytes = kBK * kRowBytes;   // one K or V stage
  static constexpr int kBarriers = 1 + 4 * kStages;
  // + 1024 so the tiles can start on a 1024-byte boundary (the swizzle's
  // period, which TMA and wgmma both read from the address bits)
  static constexpr int kSmem =
      kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers + 1024;
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

// Rows [row, row + rows) of head `head` into a tile at `dst`: one box per
// 64-column slab from `full`, and the tail columns from `tail`.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, int rows,
                                         const CUtensorMap* full,
                                         const CUtensorMap* tail,
                                         uint32_t bar, int row, int head) {
  using P = Shape<D>;
  for (int s = 0; s < P::kFull; ++s) {
    tma_load(dst + s * rows * kSlabBytes, full, bar, 64 * s, row, head);
  }
  if constexpr (P::kTail) {
    tma_load(dst + P::kFull * rows * kSlabBytes, tail, bar, 64 * P::kFull,
             row, head);
  }
}

// wgmma shared-memory descriptors: start address, leading and stride byte
// offsets (each >> 4) and the swizzle (layout type 1: 128 bytes, 2: 64,
// 3: 32).
// K-major (Q, K): rows at the swizzle width, 8-row groups at 8 rows.
// MN-major (V): 8-key groups at 8 rows; the leading offset steps across
// 64-column atoms, which no product here does.
constexpr uint64_t kSwizzle128 = 1;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
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

// d[0:64] (+)= A·B for m64n128k16: A and B in shared memory, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float* d, uint64_t a,
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
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

// Start S = Q·Kᵀ for warpgroup wg's 64 query rows: D/16 k16 steps, four
// per 64-column slab and kTailCols/16 on the tail slab.
template <int D>
__device__ __forceinline__ void start_qk(float (&s)[kBK / 2], uint32_t q_s,
                                         int wg, uint32_t k_st) {
  using P = Shape<D>;
#pragma unroll
  for (int kk = 0; kk < 4 * P::kFull; ++kk) {
    const uint32_t off = (kk % 4) * 32;   // 16 columns within the slab
    const uint32_t q =
        q_s + (kk / 4) * kBQ * kSlabBytes + 64 * wg * kSlabBytes + off;
    const uint32_t k = k_st + (kk / 4) * kBK * kSlabBytes + off;
    wgmma_m64n128k16_ss(s, smem_desc(q, 16, 8 * kSlabBytes, kSwizzle128),
                        smem_desc(k, 16, 8 * kSlabBytes, kSwizzle128),
                        kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < P::kTailCols / 16; ++kk) {
    const uint32_t q = q_s + P::kFull * kBQ * kSlabBytes +
                       64 * wg * P::kTailBytes + 32 * kk;
    const uint32_t k = k_st + P::kFull * kBK * kSlabBytes + 32 * kk;
    wgmma_m64n128k16_ss(
        s, smem_desc(q, 16, 8 * P::kTailBytes, P::kTailSwizzle),
        smem_desc(k, 16, 8 * P::kTailBytes, P::kTailSwizzle), 1);
  }
}

// Start O += P·V: per 16 keys, one n64 product per 64-column slab of V and
// one n16 (D = 80) or n32 (D = 96) product on the tail slab.
template <int D>
__device__ __forceinline__ void start_pv(float (&o)[Shape<D>::kOAcc],
                                         uint32_t (&p)[kBK / 4],
                                         uint32_t v_st) {
  using P = Shape<D>;
#pragma unroll
  for (int kb = 0; kb < kBK / 16; ++kb) {
#pragma unroll
    for (int js = 0; js < P::kFull; ++js) {
      const uint32_t v = v_st + js * kBK * kSlabBytes + kb * 16 * kSlabBytes;
      wgmma_m64n64k16_rs(o + 32 * js, p + 4 * kb,
                         smem_desc(v, kBK * kSlabBytes, 8 * kSlabBytes,
                                   kSwizzle128));
    }
    if constexpr (P::kTail) {
      const uint32_t v =
          v_st + P::kFull * kBK * kSlabBytes + kb * 16 * P::kTailBytes;
      const uint64_t desc =
          smem_desc(v, 16, 8 * P::kTailBytes, P::kTailSwizzle);
      if constexpr (P::kTailCols == 16) {
        wgmma_m64n16k16_rs(o + 32 * P::kFull, p + 4 * kb, desc);
      } else {
        wgmma_m64n32k16_rs(o + 32 * P::kFull, p + 4 * kb, desc);
      }
    }
  }
}

// One tile of the online softmax on this thread's scores (rows i0 and
// i0 + 8, columns t0 + 8·(j/4) + cq + (j&1)): mask if kMask, move the
// running max m, exponentiate in place, add to the thread's share l of the
// row sums; → the factors (alpha) the rows' O must take.  Scores are raw
// (unscaled); exp2 takes s·c − m·c, c = scale·log2(e).  The max and the sum
// run as four independent chains per row.  While a row has seen only masked
// keys its max stays -1e30 and m·c is taken as 0, so its probabilities are
// exactly 0 (not the plain version's transient exp(0) terms, which the first
// real key's correction wipes: every row that is stored has its own key, so
// the results agree).
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], int t0,
                                             int i0, int cq, int S,
                                             int causal, int window, float c,
                                             float& m0, float& m1,
                                             float& l0, float& l1,
                                             float& alpha0, float& alpha1) {
  const int i1 = i0 + 8;
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < kBK / 2; ++j) {
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
  for (int g = 0; g < kBK / 8; ++g) {
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
  for (int g = 0; g < kBK / 8; ++g) {
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

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tq_tail,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tk_tail,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tv_tail,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ lse, int H, int KV,
                            int S, float scale_log2, int causal, int window) {
  using P = Shape<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = q_s + P::kQBytes;               // kStages K tiles
  const uint32_t v_s = k_s + kStages * P::kKVBytes;    // kStages V tiles
  // mbarriers, 8 bytes each; the per-stage ones at + 8·stage
  const uint32_t q_full = v_s + kStages * P::kKVBytes;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;

  // Heaviest query tiles first, so the last blocks to start are short.
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_row = b * KV + h / (H / KV);

  // Key tiles to visit (flash_tile_plan): under causal masking none above
  // the block's last query and, with a window, none wholly older than its
  // first query's window; without causal masking all of them.
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kComputeThreads) {
    // ---- the loading warpgroup: one thread starts every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kComputeThreads) {
      mbar_expect_tx(q_full, P::kQBytes);
      tma_tile<D>(q_s, kBQ, &tq, &tq_tail, q_full, q0, b * H + h);
      for (int n = 0; n < n_tiles; ++n) {
        const int st = n % kStages;
        const uint32_t reuse = (n / kStages - 1) & 1;   // its last phase
        const int t0 = (kt_lo + n) * kBK;
        // a stage is loaded again once both computing warpgroups released
        // its tile n − kStages
        if (n >= kStages) mbar_wait(k_empty + 8 * st, reuse);
        mbar_expect_tx(k_full + 8 * st, P::kKVBytes);
        tma_tile<D>(k_s + st * P::kKVBytes, kBK, &tk, &tk_tail,
                    k_full + 8 * st, t0, kv_row);
        if (n >= kStages) mbar_wait(v_empty + 8 * st, reuse);
        mbar_expect_tx(v_full + 8 * st, P::kKVBytes);
        tma_tile<D>(v_s + st * P::kKVBytes, kBK, &tv, &tv_tail,
                    v_full + 8 * st, t0, kv_row);
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
  const int cq = 2 * (lane % 4);

  float o[P::kOAcc];
#pragma unroll
  for (int j = 0; j < P::kOAcc; ++j) o[j] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running row max (raw scores)
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the row sum
  float s[kBK / 2];                   // scores, then probabilities (f32)
  uint32_t p[kBK / 4];                // probabilities as bf16 A fragments

  mbar_wait(q_full, 0);
  for (int n = 0; n < n_tiles; ++n) {
    const int st = n % kStages;
    const uint32_t phase = (n / kStages) & 1;
    const int t0 = (kt_lo + n) * kBK;
    mbar_wait(k_full + 8 * st, phase);
    fence_regs(s);
    wgmma_fence();
    start_qk<D>(s, q_s, wg, k_s + st * P::kKVBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    mbar_arrive(k_empty + 8 * st);

    // In-tile mask only where the tile holds a masked pair (the diagonal,
    // the window's lower edge, keys at or past S).
    float alpha0, alpha1;
    if (t0 + kBK > S ||
        (causal && (t0 + kBK - 1 > q0 ||
                    (window > 0 && t0 <= q0 + kBQ - 1 - window)))) {
      softmax_tile<true>(s, t0, i0, cq, S, causal, window, scale_log2, m0,
                         m1, l0, l1, alpha0, alpha1);
    } else {
      softmax_tile<false>(s, t0, i0, cq, S, causal, window, scale_log2, m0,
                          m1, l0, l1, alpha0, alpha1);
    }
#pragma unroll
    for (int j = 0; j < P::kOAcc; ++j) o[j] *= (j & 2) ? alpha1 : alpha0;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);

    mbar_wait(v_full + 8 * st, phase);
    fence_regs(o);
    fence_regs(p);
    wgmma_fence();
    start_pv<D>(o, p, v_s + st * P::kKVBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(p);
    mbar_arrive(v_empty + 8 * st);
  }

  // epilogue: the row sums over the quad, normalise, store bf16 pairs
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / (l0 == 0.f ? 1.f : l0);
  const float inv1 = 1.f / (l1 == 0.f ? 1.f : l1);
  const int i1 = i0 + 8;
  __nv_bfloat16* ob = out + static_cast<size_t>(b * H + h) * S * D;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    const int col = 8 * g + cq;
    if (i0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(i0) * D +
                                         col) =
          __floats2bfloat162_rn(o[4 * g] * inv0, o[4 * g + 1] * inv0);
    }
    if (i1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(i1) * D +
                                         col) =
          __floats2bfloat162_rn(o[4 * g + 2] * inv1, o[4 * g + 3] * inv1);
    }
  }
  // Each row's log-sum-exp for the backward (flash_attention_bwd_sm90.cu),
  // in base 2 of the scaled scores: log2 Σ_t 2^(s_t·c) = m·c + log2(l), the
  // base of the backward's exp2; +inf for a row that saw no key.
  if (cq == 0) {
    float* lb = lse + static_cast<size_t>(b * H + h) * S;
    if (i0 < S) lb[i0] = l0 == 0.f ? INFINITY : m0 * scale_log2 + log2f(l0);
    if (i1 < S) lb[i1] = l1 == 0.f ? INFINITY : m1 * scale_log2 + log2f(l1);
  }
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

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int H, int KV, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  auto* kernel = flash_attention_sm90_kernel<D>;
  constexpr int smem = Shape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the tail maps are read only at D = 80 (16 columns) and 96 (32)
  const int tail = Shape<D>::kTail ? Shape<D>::kTailCols : 64;
  CUtensorMap tq, tq_tail, tk, tk_tail, tv, tv_tail;
  if (!tensor_map(&tq, encode, q, D, S, B * H, kBQ, 64) ||
      !tensor_map(&tq_tail, encode, q, D, S, B * H, kBQ, tail) ||
      !tensor_map(&tk, encode, k, D, S, B * KV, kBK, 64) ||
      !tensor_map(&tk_tail, encode, k, D, S, B * KV, kBK, tail) ||
      !tensor_map(&tv, encode, v, D, S, B * KV, kBK, 64) ||
      !tensor_map(&tv_tail, encode, v, D, S, B * KV, kBK, tail)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tq_tail, tk, tk_tail, tv, tv_tail,
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), H, KV, S,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream`; q, k, v and out contiguous bf16, 16-byte aligned;
// lse the (B, H, S) f32 log-sum-exp of each row (written).  H must be a
// multiple of KV and D one of 64, 80, 96, 128 (else cudaErrorInvalidValue).
// Allocates nothing; returns the launch's cudaError_t (0 on success).
extern "C" int flash_attention_bf16_sm90(const void* q, const void* k,
                                         const void* v, void* out, void* lse,
                                         int B, int H, int KV, int S, int D,
                                         float scale, int causal, int window,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, lse, B, H, KV, S, scale, causal,
                        window, s);
    case 80:
      return launch<80>(q, k, v, out, lse, B, H, KV, S, scale, causal,
                        window, s);
    case 96:
      return launch<96>(q, k, v, out, lse, B, H, KV, S, scale, causal,
                        window, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, H, KV, S, scale, causal,
                         window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory one block of the kernel takes at head dim D (0 for
// a D it is not built for).
extern "C" int flash_attention_bf16_sm90_smem(int D) {
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
