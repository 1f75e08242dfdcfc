// Eq.-6 GCN aggregation over an edge list, one edge-dropout mask per chain.
//
// Replaces the TPU kernel src/repro/kernels/gcn_spmm.py::_gcn_kernel (via
// gcn_aggregate).  That kernel fuses the normalisation into dense (bm × bk)
// tiles of A for the matrix unit.  The paper graphs have E/V of 1.04–1.08, so
// on Hopper the dense tiles would be ~99.8% zeros; this kernel walks a CSR of
// the symmetrised neighbour lists instead and never forms Â in memory:
//
//   deg[b,i] = 1 + Σ_{k ∈ row i} keep[b, eid[k]]          (self loop never dropped)
//   r        = 1 / sqrt(deg)
//   out[b,i,:] = r_i · (r_i · h[b,i,:] + Σ_{k ∈ row i} keep[b,eid[k]] · r_j · h[b,j,:])
//
// What bounds it on this card: bytes.  It does ~2 operations per 4-byte
// element of h it reads.  Threads run over the feature axis, so each
// neighbour row of h is one coalesced read.  The normalised operator is
// symmetric, so the gradient with respect to h is this same kernel applied to
// the output gradient.
//
// Arithmetic is rounded like the plain PyTorch version (gcn_aggregate_ref):
// no fused multiply-add, neighbours summed in CSR order (edges where i is the
// source, then edges where i is the destination, each in edge order).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gcn_degree_kernel(const int32_t* __restrict__ rowptr,
                                  const int32_t* __restrict__ eid,
                                  const float* __restrict__ keep,   // (B, E)
                                  float* __restrict__ rscale,       // (B, V)
                                  int B, int V, int E) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * V) return;
  const int b = idx / V;
  const int i = idx - b * V;
  const float* kb = keep + static_cast<size_t>(b) * E;
  float deg = 1.f;
  for (int k = rowptr[i]; k < rowptr[i + 1]; ++k) {
    deg = __fadd_rn(deg, kb[eid[k]]);
  }
  rscale[idx] = __frcp_rn(__fsqrt_rn(deg));
}

__global__ void gcn_aggregate_kernel(const int32_t* __restrict__ rowptr,
                                     const int32_t* __restrict__ col,
                                     const int32_t* __restrict__ eid,
                                     const float* __restrict__ keep,    // (B, E)
                                     const float* __restrict__ rscale,  // (B, V)
                                     const float* __restrict__ h,       // (B, V, F)
                                     float* __restrict__ out,           // (B, V, F)
                                     int V, int E, int F, int rows_per_block) {
  const int b = blockIdx.y;
  const size_t vf = static_cast<size_t>(V) * F;
  const float* hb = h + b * vf;
  const float* rb = rscale + static_cast<size_t>(b) * V;
  const float* kb = keep + static_cast<size_t>(b) * E;
  float* ob = out + b * vf;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(row0 + rows_per_block, V);
  for (int i = row0; i < row1; ++i) {
    const float ri = rb[i];
    const int k0 = rowptr[i];
    const int k1 = rowptr[i + 1];
    for (int f = threadIdx.x; f < F; f += blockDim.x) {
      float acc = __fmul_rn(ri, hb[static_cast<size_t>(i) * F + f]);
      for (int k = k0; k < k1; ++k) {
        const int j = col[k];
        const float c = __fmul_rn(kb[eid[k]], rb[j]);
        acc = __fadd_rn(acc, __fmul_rn(c, hb[static_cast<size_t>(j) * F + f]));
      }
      ob[static_cast<size_t>(i) * F + f] = __fmul_rn(ri, acc);
    }
  }
}

}  // namespace

// Two launches on `stream`: degrees into the caller's (B, V) scratch
// `rscale`, then the aggregation.  Allocates nothing; returns the launches'
// cudaError_t (0 on success).
extern "C" int gcn_aggregate_f32(const void* rowptr, const void* col,
                                 const void* eid, const void* keep,
                                 const void* h, void* rscale, void* out,
                                 int B, int V, int E, int F, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const int blocks = (B * V + threads - 1) / threads;
  gcn_degree_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(eid),
      static_cast<const float*>(keep), static_cast<float*>(rscale), B, V, E);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rows_per_block = 4;
  int width = ((F + 31) / 32) * 32;
  if (width > 256) width = 256;
  const dim3 grid((V + rows_per_block - 1) / rows_per_block, B);
  gcn_aggregate_kernel<<<grid, width, 0, s>>>(
      static_cast<const int32_t*>(rowptr), static_cast<const int32_t*>(col),
      static_cast<const int32_t*>(eid), static_cast<const float*>(keep),
      static_cast<const float*>(rscale), static_cast<const float*>(h),
      static_cast<float*>(out), V, E, F, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
