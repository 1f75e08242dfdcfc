// Mamba-2 (SSD) inter-chunk state recurrence on Hopper:
//
//   h_0 = 0,  h_before[c] = h_c,  h_{c+1} = h_c · decay[c] + dbx[c],
//   h_final = h_C.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_scan_kernel
// (via ssd_scan).  The Pallas grid walks the chunks as its innermost
// sequential dimension and keeps one (P, N) state tile in VMEM scratch.  On
// Hopper nothing carries over between blocks, but every state element
// (b, h, p, n) is an independent recurrence over the chunks: one thread owns
// one element and walks the C chunks in order, keeping h in a register.
// Neighbouring threads own neighbouring (p, n), so every chunk's loads and
// stores are coalesced rows of P·N floats.
//
// What bounds it on this card: bytes.  Each element of dbx is read once and
// each element of h_before written once (2 operations per 8 bytes).  The loop
// carries h through a register, so the only dependent chain is one multiply
// and one add per chunk; the loads of later chunks do not depend on h and are
// issued ahead (the loop is unrolled), and B·H·P·N threads (786,432 at the
// mamba2-130m prefill) keep enough loads in flight to cover the latency.
//
// Rounding is exactly the plain PyTorch version's (ssd_scan_ref): h·decay
// rounded, then + dbx rounded, no fused multiply-add.
//
// Backward (ssd_scan_bwd_f32, the gradient of the training path; the TPU
// kernel has none).  With G the gradient of the state leaving chunk c,
// starting from g_final and walking c = C−1 … 0:
//
//   d_dbx[c]   = G,
//   d_decay[c] = Σ_{p,n} G · h_before[c],
//   G          ← G · decay[c] + g_before[c].
//
// Bound by bytes like the forward (h_before and g_before read once, d_dbx
// written once).  One block of kBwdThreads threads owns one (b, h): a thread
// keeps PER state elements' G in registers and walks the chunks backwards;
// d_decay[c] is a block reduction of the threads' partial sums in a fixed
// order, so no atomics and the same bits on every run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void ssd_scan_kernel(const float* __restrict__ decay,  // (B, C, H)
                                const float* __restrict__ dbx,    // (B, C, H, P·N)
                                float* __restrict__ before,       // (B, C, H, P·N)
                                float* __restrict__ final_state,  // (B, H, P·N)
                                int C, int H, int PN) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t step = static_cast<size_t>(H) * PN;
  size_t idx = (static_cast<size_t>(b) * C * H + h) * PN + e;
  const float* dec = decay + static_cast<size_t>(b) * C * H + h;
  float state = 0.f;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float x = dbx[idx];
    const float a = dec[static_cast<size_t>(c) * H];
    before[idx] = state;
    state = __fadd_rn(__fmul_rn(state, a), x);
    idx += step;
  }
  final_state[(static_cast<size_t>(b) * H + h) * PN + e] = state;
}

constexpr int kBwdThreads = 512;   // ssd_scan_bwd_plan's BWD_THREADS
constexpr int kWarp = 32;

// Σ over the block of v; every thread gets it.  Syncs before reusing its
// shared memory, so it can be called again at once.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float part[kBwdThreads / kWarp];
  for (int off = kWarp / 2; off > 0; off /= 2) {
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  __syncthreads();
  if (threadIdx.x % kWarp == 0) part[threadIdx.x / kWarp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kBwdThreads / kWarp; ++w) t = __fadd_rn(t, part[w]);
  return t;
}

template <int PER>
__global__ void __launch_bounds__(kBwdThreads)
ssd_scan_bwd_kernel(const float* __restrict__ decay,     // (B, C, H)
                    const float* __restrict__ before,    // (B, C, H, P·N)
                    const float* __restrict__ g_before,  // (B, C, H, P·N)
                    const float* __restrict__ g_final,   // (B, H, P·N)
                    float* __restrict__ d_dbx,           // (B, C, H, P·N)
                    float* __restrict__ d_decay,         // (B, C, H)
                    int C, int H, int PN) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const size_t fin = (static_cast<size_t>(b) * H + h) * PN;
  float G[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = t + k * kBwdThreads;
    G[k] = e < PN ? g_final[fin + e] : 0.f;
  }
  for (int c = C - 1; c >= 0; --c) {
    const size_t dc = (static_cast<size_t>(b) * C + c) * H + h;
    const size_t base = dc * PN;
    const float a = decay[dc];
    float part = 0.f;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = t + k * kBwdThreads;
      if (e < PN) {
        d_dbx[base + e] = G[k];
        part = __fadd_rn(part, __fmul_rn(G[k], before[base + e]));
        G[k] = __fadd_rn(__fmul_rn(G[k], a), g_before[base + e]);
      }
    }
    part = block_sum(part);
    if (t == 0) d_decay[dc] = part;
  }
}

}  // namespace

// One launch on `stream`.  All tensors are contiguous f32.  Allocates
// nothing; returns the launch's cudaError_t (0 on success).
extern "C" int ssd_scan_f32(const void* decay, const void* dbx, void* before,
                            void* final_state, int B, int C, int H, int PN,
                            void* stream) {
  const int threads = 256;
  const dim3 grid((PN + threads - 1) / threads, H, B);
  ssd_scan_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(decay), static_cast<const float*>(dbx),
      static_cast<float*>(before), static_cast<float*>(final_state), C, H,
      PN);
  return static_cast<int>(cudaGetLastError());
}

// The backward: one launch on `stream`, a block of 512 threads per (b, h),
// per_thread = ceil(PN / 512) state elements a thread (1, 2, 4, 8, 16 or
// 32: ssd_scan_bwd_plan).  All tensors contiguous f32.  Allocates nothing;
// returns the launch's cudaError_t (0 on success).
extern "C" int ssd_scan_bwd_f32(const void* decay, const void* before,
                                const void* g_before, const void* g_final,
                                void* d_dbx, void* d_decay, int B, int C,
                                int H, int PN, int per_thread, void* stream) {
  const dim3 grid(H, B);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_thread * kBwdThreads < PN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* dec = static_cast<const float*>(decay);
  const float* bef = static_cast<const float*>(before);
  const float* gb = static_cast<const float*>(g_before);
  const float* gf = static_cast<const float*>(g_final);
  float* ddbx = static_cast<float*>(d_dbx);
  float* ddec = static_cast<float*>(d_decay);
#define SSD_BWD(N)                                                    \
  case N:                                                             \
    ssd_scan_bwd_kernel<N><<<grid, kBwdThreads, 0, s>>>(              \
        dec, bef, gb, gf, ddbx, ddec, C, H, PN);                      \
    break;
  switch (per_thread) {
    SSD_BWD(1) SSD_BWD(2) SSD_BWD(4) SSD_BWD(8) SSD_BWD(16) SSD_BWD(32)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SSD_BWD
  return static_cast<int>(cudaGetLastError());
}
