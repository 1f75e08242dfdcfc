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
