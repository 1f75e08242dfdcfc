// What the capped (kCap) instantiations of the bf16 flash kernels
// (flash_attention_sm90.cu, flash_attention_bwd_sm90.cu) share.
//
// tanh: t = tanh(s·cap_in) of a raw score s, cap_in = scale / softcap, in
// one of two forms, chosen by the score's place in a thread's unrolled tile
// so that the two pipes the forms load share the work:
//
//   exp form, three scores in four: t = 1 − 2 / (1 + 2^(s·k2)), k2 =
//     2·log2(e)·cap_in: two MUFU operations (ex2.approx, rcp.approx) and
//     three FMA-pipe instructions.
//   rational form, one score in four: z = sat(s·k_in + 1/2) − 1/2 with
//     k_in = cap_in / (2·kCapClamp) (one saturating FMA clamps x = s·cap_in
//     to ±kCapClamp and takes z = x / (2·kCapClamp)), then t = z·P(z²) /
//     Q(z²), P and Q of degree 3, Q(0) = 1: one MUFU operation (the
//     reciprocal) and eleven FMA-pipe instructions.
//
// The accurate tanhf takes about twenty instructions and two MUFU
// operations a score; tanh.approx.f32 is one, but its relative error near
// 2^-11 moves a score by ~0.02 at a cap of 50.  On the H100 (danube's
// shapes, cap 50) one rational score in four beat all exp, all rational,
// one in two and one in eight (tools/flash_cap_variants.py).  The
// rational form's constants are the minimax fit of
// tools/softcap_tanh_fit.py: ≤ 1.5e-6 from tanh on every float32 x, the
// clamp's tail 1 − tanh(7) included; the exp form is within 1e-6 given
// ex2.approx's and rcp.approx's errors.  So a capped score softcap·t is
// within 1.5e-6·softcap of the exact one either way
// (tests/test_torch_softcap_formula.py holds both to 1e-5·softcap).
//
// Turns (the backward kernels): the cap makes a tile's SIMT work outlast
// its products, so the two computing warpgroups take turns to start their
// S and dP products, as FlashAttention-3's warp scheduler barrier does: a
// warpgroup waits on its own named barrier (1 + wg, 256 threads) before it
// starts them and arrives on the other's after, and warpgroup 0 arrives on
// its own once before the loop.  Each then runs its SIMT work while the
// other's products hold the tensor cores.  The forward ran slower with
// turns, and takes none.
#pragma once

#include <cuda_runtime.h>

constexpr float kCapClamp = 7.0f;
constexpr float kCapP[4] = {14.0f, 338.620789f, 1241.41943f, 427.853027f};
constexpr float kCapQ[3] = {89.5198898f, 815.404297f, 1095.79919f};
constexpr float kCapExp = 2.88539008f;       // 2·log2(e)
constexpr int kCapRationalEvery = 4;         // one score in four, the rational

// A launch's two scales, from its cap_in = scale / softcap
struct CapScales {
  float k_in;   // the rational form's
  float k2;     // the exp form's
};

__device__ __forceinline__ CapScales softcap_scales(float cap_in) {
  return {cap_in * (0.5f / kCapClamp), cap_in * kCapExp};
}

__device__ __forceinline__ float tanh_rational(float s, float k_in) {
  float y;
  asm("fma.rn.sat.f32 %0, %1, %2, 0f3F000000;" : "=f"(y) : "f"(s), "f"(k_in));
  const float z = y - 0.5f;
  const float w = z * z;
  const float p =
      fmaf(fmaf(fmaf(kCapP[3], w, kCapP[2]), w, kCapP[1]), w, kCapP[0]);
  const float q = fmaf(fmaf(fmaf(kCapQ[2], w, kCapQ[1]), w, kCapQ[0]), w, 1.f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));
  return (z * p) * r;
}

__device__ __forceinline__ float tanh_exp(float s, float k2) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(s * k2));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(e + 1.f));
  return fmaf(-2.f, r, 1.f);
}

// t = tanh(s·cap_in) for the score at place j of a thread's tile (j a
// constant of the unrolled loop, so the form is chosen at compile time)
__device__ __forceinline__ float softcap_tanh(int j, float s, CapScales k) {
  return j % kCapRationalEvery == 1 ? tanh_rational(s, k.k_in)
                                    : tanh_exp(s, k.k2);
}

// A warpgroup's turn: wait on its own barrier, pass to the other's.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// before the loop: warpgroup 0 takes the first turn
__device__ __forceinline__ void turn_init(int wg) {
  if (wg == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");
}
