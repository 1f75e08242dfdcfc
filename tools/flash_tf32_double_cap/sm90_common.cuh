// Hopper building blocks shared by the float32 flash-attention kernels
// (flash_attention_tf32_sm90.cu, flash_attention_bwd_tf32_sm90.cu):
// mbarriers, TMA loads and tensor maps, wgmma shared-memory descriptors,
// the tf32 wgmma instructions, and the pre-pass that splits a float32
// tensor into the two tf32 planes those kernels multiply.
//
// The split.  A float32 x is hi + lo with hi = tf32(x) (cvt.rna: the
// nearest value with 10 mantissa bits) and lo = tf32(x − hi); x − hi is
// exact, so hi + lo equals x to about 2^-22 relative.  A product a·b is
// then a_hi·b_hi + a_hi·b_lo + a_lo·b_hi, three tf32 wgmma instructions:
// the dropped a_lo·b_lo and the roundings of lo leave about 2^-21 of |a·b|,
// against 2^-11 for one tf32 product.  wgmma reads a tf32 operand from the
// upper 19 bits of a 32-bit word, so both planes are rounded explicitly.
//
// Tiles.  wgmma on .tf32 takes no transpose flag: both shared-memory
// operands are K-major (the reduction dimension contiguous).  A tile of R
// rows and C columns (C the reduction dimension) is stored as slabs of 32
// floats (128-byte rows, the 128-byte swizzle of TMA and wgmma) and, where C
// is 16 past a multiple of 32 (C = 16 or 80), a tail slab of 16 floats
// (64-byte rows, the 64-byte swizzle): slab s of an R-row tile at
// + s·R·128 bytes, the tail slab after the full ones.  This is the bf16
// kernels' layout byte for byte (a k8 step of tf32 is the 32 bytes of a k16
// step of bf16).  The hi and lo planes of a tile are two such tiles, lo
// right after hi.
//
// Transposed operands.  Where a product reduces over tokens (P·V, dS·K,
// Pᵀ·dO, dSᵀ·Q) the B operand is the (D, tokens) transpose, which the
// pre-pass writes with the tokens of each group of 8 permuted: position p
// of a group holds token 2·(p % 4) + p / 4.  The A operand of those
// products is a probability (or dS) tile held in registers as the f32
// accumulator of the product before it, where a thread holds columns
// (2t, 2t + 1) of each group of 8; a tf32 A fragment wants columns
// (t, t + 4) (t = lane % 4).  With the permutation, positions t and t + 4
// are tokens 2t and 2t + 1, so the accumulator becomes the A fragment with
// no data moved between threads.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace sm90 {

// ------------------------------------------------------------- mbarriers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// ------------------------------------------------------------------ TMA
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

// --------------------------------------------------- wgmma descriptors
// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (each >> 4) and the swizzle (layout type 1: 128 bytes, 2: 64).
constexpr uint64_t kSwizzle128 = 1;
constexpr uint64_t kSwizzle64 = 2;
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | layout << 62;
}

// A K-major float32 tile of R rows by C columns (see the note at the top):
// kFull slabs of 32 columns and, for C % 32 == 16, a 16-column tail slab.
// Each plane takes kBytes; tiles start on a 1024-byte boundary (the
// swizzle's period, which TMA and wgmma read from the address bits).
template <int C, int R>
struct Tile {
  static_assert(C % 16 == 0 && R % 8 == 0, "tile shape");
  static constexpr int kFull = C / 32;
  static constexpr int kTailCols = C % 32;   // 0 or 16
  static constexpr int kBytes = R * C * 4;

  // The descriptor of rows [r0, r0 + 64) (or the whole tile when it is the
  // B operand) at k8 step kk: 32 bytes a step along a slab's rows, 8-row
  // groups at 8 rows.
  __device__ __forceinline__ static uint64_t desc(uint32_t tile, int r0,
                                                  int kk) {
    if (kk < 4 * kFull) {
      return smem_desc(tile + (kk / 4) * R * 128 + r0 * 128 + (kk % 4) * 32,
                       16, 8 * 128, kSwizzle128);
    }
    return smem_desc(tile + kFull * R * 128 + r0 * 64 + 32 * (kk - 4 * kFull),
                     16, 8 * 64, kSwizzle64);
  }

  // Load one plane: columns [c0, c0 + C) of rows [row, row + R) of head
  // `head`, one box a slab (`full`: 32 columns, `tail`: 16).
  __device__ __forceinline__ static void load(uint32_t dst,
                                              const CUtensorMap* full,
                                              const CUtensorMap* tail,
                                              uint32_t bar, int c0, int row,
                                              int head) {
#pragma unroll
    for (int s = 0; s < kFull; ++s) {
      tma_load(dst + s * R * 128, full, bar, c0 + 32 * s, row, head);
    }
    if constexpr (kTailCols != 0) {
      tma_load(dst + kFull * R * 128, tail, bar, c0 + 32 * kFull, row, head);
    }
  }

  // Both planes: hi from head `head`, lo from head `head + lo_off`.
  __device__ __forceinline__ static void load2(uint32_t dst,
                                               const CUtensorMap* full,
                                               const CUtensorMap* tail,
                                               uint32_t bar, int c0, int row,
                                               int head, int lo_off) {
    load(dst, full, tail, bar, c0, row, head);
    load(dst + kBytes, full, tail, bar, c0, row, head + lo_off);
  }
};

// ---------------------------------------------------------------- wgmma
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

// x rounded to tf32 (to nearest, ties away), as the bits wgmma reads.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, both tf32 (see the note at the top).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// The tf32 A fragments of a 64-row accumulator of N columns (the m64nN
// layout: columns 8g + 2t and 8g + 2t + 1 of rows r and r + 8 in
// x[4g .. 4g + 3]) against a B operand whose tokens are permuted in groups
// of 8 (the note at the top): k8 step g takes {x[4g], x[4g + 2],
// x[4g + 1], x[4g + 3]}, split into its hi and lo planes.
template <int N>
__device__ __forceinline__ void a_fragments(const float (&x)[N],
                                            uint32_t (&hi)[N],
                                            uint32_t (&lo)[N]) {
#pragma unroll
  for (int g = 0; g < N / 4; ++g) {
    split_tf32(x[4 * g], hi[4 * g], lo[4 * g]);
    split_tf32(x[4 * g + 2], hi[4 * g + 1], lo[4 * g + 1]);
    split_tf32(x[4 * g + 1], hi[4 * g + 2], lo[4 * g + 2]);
    split_tf32(x[4 * g + 3], hi[4 * g + 3], lo[4 * g + 3]);
  }
}

// ------------------------------------------ the tf32 wgmma instructions
// d[0:8] (+)= A·B for m64n16k8 tf32: A and B in shared memory, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_m64n16k8_ss(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:16] (+)= A·B for m64n32k8 tf32: A and B in shared memory, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_m64n32k8_ss(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:32] (+)= A·B for m64n64k8 tf32: A and B in shared memory, both
// K-major; scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_m64n64k8_ss(
    float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[0:32] += A·B for m64n64k8 tf32: A (four tf32 registers) in registers,
// B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_m64n64k8_rs(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:40] += A·B for m64n80k8 tf32: A (four tf32 registers) in registers,
// B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_m64n80k8_rs(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:48] += A·B for m64n96k8 tf32: A (four tf32 registers) in registers,
// B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_m64n96k8_rs(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0:64] += A·B for m64n128k8 tf32: A (four tf32 registers) in registers,
// B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_m64n128k8_rs(
    float* d, const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


// acc (+)= A·B, m64nNk8, both operands in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64, "no wgmma_ss for this N");
  if constexpr (N == 16) wgmma_tf32_m64n16k8_ss(d, a, b, scale_d);
  if constexpr (N == 32) wgmma_tf32_m64n32k8_ss(d, a, b, scale_d);
  if constexpr (N == 64) wgmma_tf32_m64n64k8_ss(d, a, b, scale_d);
}

// acc += A·B, m64nNk8, A from registers.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  static_assert(N == 64 || N == 80 || N == 96 || N == 128,
                "no wgmma_rs for this N");
  if constexpr (N == 64) wgmma_tf32_m64n64k8_rs(d, a, b);
  if constexpr (N == 80) wgmma_tf32_m64n80k8_rs(d, a, b);
  if constexpr (N == 96) wgmma_tf32_m64n96k8_rs(d, a, b);
  if constexpr (N == 128) wgmma_tf32_m64n128k8_rs(d, a, b);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A score tile S = A·Bᵀ (N columns, K k8 steps; `a(kk, plane)` and
// `b(kk, plane)` give the operands' descriptors at step kk, plane 0 hi and
// 1 lo).  Each step's three products, a_lo·b_hi, a_hi·b_lo (kSwap: the two
// corrections the other way round, so that Sᵀ = B·Aᵀ with the operands'
// roles exchanged rounds as S does) and a_hi·b_hi, are summed by the tensor
// cores from zero, in one of two buffers, and added to s in f32 while the
// next step runs.  The tensor cores' f32 sums drop bits that
// round-to-nearest keeps, at each instruction and relative to the sum so
// far: summed over all steps in their accumulator, S carried several
// times the error of a plain f32 product, which scores near a logit cap
// turn into errors of 1e-5 in the gradients.
template <int N, int K, bool kSwap = false, class DescA, class DescB>
__device__ __forceinline__ void score_product(float (&s)[N / 2],
                                              float (&b0)[N / 2],
                                              float (&b1)[N / 2], DescA a,
                                              DescB b) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    float(&buf)[N / 2] = (kk & 1) ? b1 : b0;
    fence_regs(buf);
    wgmma_fence();
    if constexpr (kSwap) {
      wgmma_ss<N>(buf, a(kk, 0), b(kk, 1), 0);
      wgmma_ss<N>(buf, a(kk, 1), b(kk, 0), 1);
    } else {
      wgmma_ss<N>(buf, a(kk, 1), b(kk, 0), 0);
      wgmma_ss<N>(buf, a(kk, 0), b(kk, 1), 1);
    }
    wgmma_ss<N>(buf, a(kk, 0), b(kk, 0), 1);
    wgmma_commit();
    if (kk > 0) {
      wgmma_wait<1>();
      float(&prev)[N / 2] = (kk & 1) ? b0 : b1;
      fence_regs(prev);
#pragma unroll
      for (int j = 0; j < N / 2; ++j) s[j] = kk == 1 ? prev[j] : s[j] + prev[j];
    }
  }
  wgmma_wait<0>();
  float(&last)[N / 2] = ((K - 1) & 1) ? b1 : b0;
  fence_regs(last);
#pragma unroll
  for (int j = 0; j < N / 2; ++j) s[j] = K == 1 ? last[j] : s[j] + last[j];
}

// d += A·B over one k8 step with A (a probability or dS tile) from
// registers: a_lo·b_hi, a_hi·b_lo, a_hi·b_hi, smallest first.
template <int N>
__device__ __forceinline__ void wgmma_rs3(float* d, const uint32_t* a_hi,
                                          const uint32_t* a_lo,
                                          uint64_t b_hi, uint64_t b_lo) {
  wgmma_rs<N>(d, a_lo, b_hi);
  wgmma_rs<N>(d, a_hi, b_lo);
  wgmma_rs<N>(d, a_hi, b_hi);
}

template <int N>
__device__ __forceinline__ void add_to(float (&d)[N], const float (&e)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] += e[j];
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) d[j] = 0.f;
}

// A logit cap of the raw scores s (scaled score s/sqrt(D), capped at
// softcap·tanh(s / (sqrt(D)·softcap))): u = 1 / (sqrt(D)·softcap) and the
// cap in raw units, r = softcap·sqrt(D).
struct Cap {
  double u, r;
};

inline Cap cap_for(int D, float softcap) {
  const double sd = sqrt(static_cast<double>(D));
  return softcap > 0.f ? Cap{1.0 / (sd * softcap), softcap * sd}
                       : Cap{0.0, 0.0};
}

// The capped score less the cap, r·(tanh(s·u) − 1) ≤ 0, in double from
// e = exp(−2|s·u|): tanh − 1 = −2e/(1+e) (s·u ≥ 0) or −2/(1+e), and
// g = 1 − tanh² = 4e/(1+e)², each exact to the float it is rounded to (in
// float, 1 − tanh² of a saturated score, tanh within 1e-4 of 1, keeps a few
// bits).
__device__ __forceinline__ double cap_score(float s, Cap cap, float& g) {
  const double x = s * cap.u;
  const double e = exp(-2.0 * fabs(x));
  const double r = 1.0 / (1.0 + e);
  g = static_cast<float>(4.0 * e * r * r);
  return cap.r * (x >= 0.0 ? -2.0 * e * r : -2.0 * r);
}

// The backward's exponent of a capped score, x·c − lse with x = cap_score,
// taken in double: rounded to float, x (up to ~900 in raw units) would
// carry 1.5e-5 of error, 2e-6 of every key's p, which the rows that a few
// keys dominate turn into 1e-5 of dq.
__device__ __forceinline__ float cap_exponent(float s, Cap cap, float c,
                                              float lse, float& g) {
  return static_cast<float>(cap_score(s, cap, g) * c - lse);
}

// ------------------------------------------------------------ the split
// One tensor of the pre-pass: `heads` (S, D) float32 matrices at `src`,
// written to `dst` as the hi plane then the lo plane, each either
//   rows:        (heads, S, D), the layout of src, or
//   transposed:  (heads, D, S8), S8 = S rounded up to 8, tokens permuted in
//                groups of 8 (the note at the top), zeros past S.
struct SplitJob {
  const float* src;
  float* dst;
  int heads;
  int transposed;
};
constexpr int kMaxSplitJobs = 7;
struct SplitJobs {
  SplitJob job[kMaxSplitJobs];
  int S, D;
};

constexpr int kSplitThreads = 256;
constexpr int kSplitTokens = 32;   // tokens a block takes at a time

__device__ __forceinline__ void split_store(float x, float* hi, float* lo) {
  uint32_t h, l;
  split_tf32(x, h, l);
  *hi = __uint_as_float(h);
  *lo = __uint_as_float(l);
}

// blockIdx.y picks the job; the blocks stride over its (head, 32-token)
// chunks.
__global__ void __launch_bounds__(kSplitThreads)
split_tf32_kernel(const SplitJobs jobs) {
  __shared__ float tile[kSplitTokens][128 + 1];
  const SplitJob job = jobs.job[blockIdx.y];
  const int S = jobs.S, D = jobs.D;
  const int S8 = (S + 7) / 8 * 8;
  const int n_chunks = ((job.transposed ? S8 : S) + kSplitTokens - 1) /
                       kSplitTokens;
  for (int c = blockIdx.x; c < job.heads * n_chunks; c += gridDim.x) {
    const int head = c / n_chunks;
    const int t0 = (c % n_chunks) * kSplitTokens;
    const float* src = job.src + static_cast<size_t>(head) * S * D;
    if (!job.transposed) {
      const size_t plane = static_cast<size_t>(job.heads) * S * D;
      const size_t base = static_cast<size_t>(head) * S * D +
                          static_cast<size_t>(t0) * D;
      const int n = min(kSplitTokens, S - t0) * D;
      for (int i = threadIdx.x; i < n; i += kSplitThreads) {
        split_store(src[static_cast<size_t>(t0) * D + i], job.dst + base + i,
                    job.dst + plane + base + i);
      }
      continue;
    }
    for (int i = threadIdx.x; i < kSplitTokens * D; i += kSplitThreads) {
      const int r = i / D, col = i - r * D;
      const int t = t0 + r;
      tile[r][col] = t < S ? src[static_cast<size_t>(t) * D + col] : 0.f;
    }
    __syncthreads();
    const size_t plane = static_cast<size_t>(job.heads) * D * S8;
    for (int i = threadIdx.x; i < D * kSplitTokens; i += kSplitThreads) {
      const int d = i / kSplitTokens, p = i % kSplitTokens;
      if (t0 + p >= S8) continue;
      const int q = p % 8;
      const float x = tile[p - q + 2 * (q % 4) + q / 4][d];
      const size_t at = (static_cast<size_t>(head) * D + d) * S8 + t0 + p;
      split_store(x, job.dst + at, job.dst + plane + at);
    }
    __syncthreads();
  }
}

// One launch of the pre-pass over `n` jobs (D at most 128).
inline cudaError_t launch_split(SplitJobs jobs, int n, cudaStream_t stream) {
  split_tf32_kernel<<<dim3(264, n), kSplitThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

// Floats one job's two planes take.
inline size_t split_floats(int heads, int S, int D, bool transposed) {
  const size_t s = transposed ? (S + 7) / 8 * 8 : S;
  return 2 * static_cast<size_t>(heads) * s * D;
}

// ---------------------------------------------------------- tensor maps
// cuTensorMapEncodeTiled, taken from libcuda through the runtime so the
// library needs no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
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

// A (cols, rows, heads) float32 tensor (cols contiguous) read in boxes of
// `box_cols` (32: the 128-byte swizzle; 16: the 64-byte one) × `box_rows`
// of one head.  Boxes past the edges read as zeros.
inline bool tensor_map_f32(CUtensorMap* map, EncodeTiled encode,
                           const void* base, int cols, int rows, int heads,
                           int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 4,
                                 static_cast<cuuint64_t>(rows) * cols * 4};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of one split tensor (both planes: 2·heads heads) for tiles of
// `box_rows` rows: `full` reads 32-column boxes, `tail` 16-column ones
// (C % 32 == 16; else it repeats `full`).  Rows layout: (D, S, 2·heads);
// transposed: (S8, D, 2·heads) with box_rows = D.
inline bool split_maps(CUtensorMap* full, CUtensorMap* tail,
                       EncodeTiled encode, const float* planes, int heads,
                       int S, int D, bool transposed, int box_rows,
                       int tile_cols) {
  const int cols = transposed ? (S + 7) / 8 * 8 : D;
  const int rows = transposed ? D : S;
  return tensor_map_f32(full, encode, planes, cols, rows, 2 * heads, 32,
                        box_rows) &&
         tensor_map_f32(tail, encode, planes, cols, rows, 2 * heads,
                        tile_cols % 32 ? 16 : 32, box_rows);
}

}  // namespace sm90
