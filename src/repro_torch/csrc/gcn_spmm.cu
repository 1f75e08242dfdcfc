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
// element of h it reads.  At the search's size (B=16, V=602, F=128: 9.9 MB,
// which stays in the 50 MB L2 from call to call) the time goes to the
// per-row work around those bytes: a chain of dependent index loads and
// the degree sums, which a warp executes once for however many features it
// carries.  So the design makes one launch of it and gives each row few
// lanes:
//
//   - G lanes per row (chain b, node i), 32 / G rows a warp, 8 warps a
//     block.  With F a multiple of 4 (and h 16-byte aligned) a row takes 16
//     lanes and each lane two float4 of a 128-feature pass, so F = 128 is
//     one pass and a warp's index work serves two rows; otherwise a row
//     takes 8 lanes of 8 floats (a 64-feature pass).  Wider F takes more
//     passes over the same neighbour list.
//   - The degrees are fused.  Each row computes r for itself and for its
//     neighbours from keep (about two keep reads each at these E/V, from
//     L2), so no pass over the whole graph runs first and no (B, V) scratch
//     is written.
//   - Lane g of a row takes entry g of the row's CSR list with one 16-byte
//     load (neighbour j, edge e, and the bounds of j's own list, stored with
//     the entry by gcn_graph), so the chain is rowptr → entry → (keep[e],
//     the eids of j's list) → their keeps.  The neighbours and their
//     coefficients keep · r_j are broadcast within the row's lanes with
//     __shfl_sync, and the h rows of two neighbours are loaded before the
//     first is added.
//
// B·V must fit an int (the wrapper checks); nothing else bounds V.  The
// normalised operator is symmetric, so the gradient with respect to h is
// this same kernel applied to the output gradient.
//
// The same source holds the GraphSAGE mean aggregation (sage_aggregate_f32,
// at the end of the file), which walks the same CSR with the same keep mask.
//
// Arithmetic is rounded like the plain PyTorch version (gcn_aggregate_ref):
// no fused multiply-add, degrees and neighbours summed in CSR order (edges
// where i is the source, then edges where i is the destination, each in edge
// order), the self term first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kLoadAhead = 2;        // neighbours' h rows in flight at once
constexpr unsigned kAll = 0xffffffffu;

// 1 / sqrt(1 + Σ keep over the edges eid[lo..hi)), summed in order; the
// edges' ids are loaded four at a time, then their keeps.
__device__ __forceinline__ float rscale(const int32_t* __restrict__ eid,
                                        const float* __restrict__ kb, int lo,
                                        int hi) {
  float deg = 1.f;
  for (int m = lo; m < hi; m += 4) {
    int e[4];
    float kv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) e[u] = m + u < hi ? eid[m + u] : 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) kv[u] = m + u < hi ? kb[e[u]] : 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (m + u < hi) deg = __fadd_rn(deg, kv[u]);
    }
  }
  return __frcp_rn(__fsqrt_rn(deg));
}

// W features at p (a float4 or a float); zeros where `active` is false.
template <int W>
__device__ __forceinline__ void load(const float* p, bool active,
                                     float (&v)[W]) {
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = 0.f;
  if (!active) return;
  if constexpr (W == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = *p;
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const float (&v)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

// G lanes a row, P vectors of W features a lane per pass of G·P·W features.
template <int G, int P, int W>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
gcn_aggregate_kernel(const int32_t* __restrict__ rowptr,
                     const int4* __restrict__ csr,     // (2E,) j, e, lo_j, hi_j
                     const int32_t* __restrict__ eid,  // (2E,)
                     const float* __restrict__ keep,   // (B, E)
                     const float* __restrict__ h,      // (B, V, F)
                     float* __restrict__ out,          // (B, V, F)
                     int B, int V, int E, int F) {
  constexpr int kRows = kWarp / G;   // rows a warp
  const int lane = threadIdx.x % kWarp;
  const int g = lane % G;
  const long long task =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
       threadIdx.x / kWarp) * kRows + lane / G;
  const bool valid = task < static_cast<long long>(B) * V;
  if (!__any_sync(kAll, valid)) return;   // the whole warp past the end
  const int t32 = valid ? static_cast<int>(task) : 0;   // B·V fits an int
  const int b = t32 / V;
  const int i = t32 - b * V;
  const float* kb = keep + static_cast<size_t>(b) * E;
  const size_t vf = static_cast<size_t>(V) * F;
  const float* hb = h + b * vf;
  float* ob = out + b * vf;

  const int k0 = valid ? rowptr[i] : 0;
  const int n = valid ? rowptr[i + 1] - k0 : 0;   // the row's entries
  const int nmax = __reduce_max_sync(kAll, n);    // the warp's loop bound

  // The entry a lane holds in the chunk at `off`: its neighbour and
  // coefficient keep · r_j (zeros past the row's end).
  auto entry = [&](int off, int& j, float& kp, float& c) {
    j = 0;
    kp = c = 0.f;
    if (off + g < n) {
      const int4 en = csr[k0 + off + g];
      j = en.x;
      kp = kb[en.y];
      c = __fmul_rn(kp, rscale(eid, kb, en.z, en.w));
    }
  };

  // r_i from the keeps in CSR order; the first chunk's entries are kept.
  int j0;
  float kp0, c0;
  entry(0, j0, kp0, c0);
  float deg = 1.f;
  for (int off = 0; off < nmax; off += G) {
    float kp = kp0;
    if (off > 0) kp = off + g < n ? kb[csr[k0 + off + g].y] : 0.f;
    for (int t = 0; t < min(nmax - off, G); ++t) {
      const float kt = __shfl_sync(kAll, kp, t, G);
      if (off + t < n) deg = __fadd_rn(deg, kt);
    }
  }
  const float ri = __frcp_rn(__fsqrt_rn(deg));

  for (int f0 = 0; f0 < F; f0 += G * P * W) {
    float acc[P][W];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int f = f0 + (p * G + g) * W;
      load<W>(hb + static_cast<size_t>(i) * F + f, valid && f < F, acc[p]);
#pragma unroll
      for (int w = 0; w < W; ++w) acc[p][w] = __fmul_rn(ri, acc[p][w]);
    }
    for (int off = 0; off < nmax; off += G) {
      int jl = j0;
      float kl, cl = c0;
      if (off > 0) entry(off, jl, kl, cl);   // lists longer than G
      for (int t = 0; t < min(nmax - off, G); t += kLoadAhead) {
        float hv[kLoadAhead][P][W];
#pragma unroll
        for (int u = 0; u < kLoadAhead; ++u) {
          const int j = __shfl_sync(kAll, jl, (t + u) % G, G);
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int f = f0 + (p * G + g) * W;
            load<W>(hb + static_cast<size_t>(j) * F + f,
                    off + t + u < n && f < F, hv[u][p]);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoadAhead; ++u) {
          const float c = __shfl_sync(kAll, cl, (t + u) % G, G);
          if (off + t + u < n) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
#pragma unroll
              for (int w = 0; w < W; ++w) {
                acc[p][w] = __fadd_rn(acc[p][w], __fmul_rn(c, hv[u][p][w]));
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int f = f0 + (p * G + g) * W;
      if (valid && f < F) {
#pragma unroll
        for (int w = 0; w < W; ++w) acc[p][w] = __fmul_rn(ri, acc[p][w]);
        store<W>(ob + static_cast<size_t>(i) * F + f, acc[p]);
      }
    }
  }
}

template <int G, int P, int W>
int launch(const void* rowptr, const void* csr, const void* eid,
           const void* keep, const void* h, void* out, int B, int V, int E,
           int F, cudaStream_t s) {
  constexpr long long kRowsPerBlock = kWarpsPerBlock * (kWarp / G);
  const int blocks = static_cast<int>(
      (static_cast<long long>(B) * V + kRowsPerBlock - 1) / kRowsPerBlock);
  gcn_aggregate_kernel<G, P, W><<<blocks, kWarpsPerBlock * kWarp, 0, s>>>(
      static_cast<const int32_t*>(rowptr), static_cast<const int4*>(csr),
      static_cast<const int32_t*>(eid), static_cast<const float*>(keep),
      static_cast<const float*>(h), static_cast<float*>(out), B, V, E, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch on `stream`.  vec4 = 1 takes 16 lanes a row and float4 loads
// (F a multiple of 4; h, out and csr on 16-byte boundaries), vec4 = 0 takes
// 8 lanes a row and one float a load.  B·V must fit an int.  Allocates
// nothing; returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for vec4 where F or the pointers do not allow it,
// or a csr off a 16-byte boundary).
extern "C" int gcn_aggregate_f32(const void* rowptr, const void* csr,
                                 const void* eid, const void* keep,
                                 const void* h, void* out, int B, int V,
                                 int E, int F, int vec4, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t vec_ptrs = reinterpret_cast<uintptr_t>(h) |
                             reinterpret_cast<uintptr_t>(out);
  if (reinterpret_cast<uintptr_t>(csr) % 16 ||
      (vec4 && (F % 4 || vec_ptrs % 16))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return vec4 ? launch<16, 2, 4>(rowptr, csr, eid, keep, h, out, B, V, E, F,
                                 s)
              : launch<8, 8, 1>(rowptr, csr, eid, keep, h, out, B, V, E, F,
                                s);
}

// ---------------------------------------------------------------------------
// GraphSAGE mean aggregation over the same CSR and keep mask.
//
// Not a port of a Pallas kernel: the reference encoder computes it as a dense
// product, ((A + Aᵀ) @ z) / deg with A the edge-dropped adjacency and
// deg = max(in + out degree, 1) (src/repro/core/gnn.py:119-122).  Here every
// chain has its own keep mask, so the operator would be a (B, V, V) batched
// product of ~99.8% zeros; this walks the symmetrised neighbour lists:
//
//   deg[b,i] = max(Σ_{k ∈ row i} keep[b, eid[k]], 1)       (no self loop)
//   post:  out[b,i,:] = (Σ_{k ∈ row i} keep[b,e_k] · h[b,j_k,:]) / deg[b,i]
//   pre:   out[b,i,:] =  Σ_{k ∈ row i} (keep[b,e_k] / deg[b,j_k]) · h[b,j_k,:]
//
// "post" is the forward.  The operator D⁻¹S (S symmetric) is not, so its
// transpose S D⁻¹ is "pre": the backward applies it to the output gradient.
//
// A simple kernel: one warp a row (chain b, node i), the lanes across the
// features, four a lane per 128-feature pass; every lane walks the row's
// entries (their loads are broadcasts).  Sums run in CSR order, products and
// sums rounded separately (no fused multiply-add).
namespace {

constexpr int kSageWarpsPerBlock = 8;
constexpr int kSagePerLane = 4;

// max(Σ keep over the edges eid[lo..hi), 1)
__device__ __forceinline__ float sage_degree(const int32_t* __restrict__ eid,
                                             const float* __restrict__ kb,
                                             int lo, int hi) {
  float deg = 0.f;
  for (int m = lo; m < hi; ++m) deg = __fadd_rn(deg, kb[eid[m]]);
  return fmaxf(deg, 1.f);
}

__global__ void __launch_bounds__(kSageWarpsPerBlock * kWarp)
sage_aggregate_kernel(const int32_t* __restrict__ rowptr,
                      const int4* __restrict__ csr,     // (2E,) j, e, lo_j, hi_j
                      const int32_t* __restrict__ eid,  // (2E,)
                      const float* __restrict__ keep,   // (B, E)
                      const float* __restrict__ h,      // (B, V, F)
                      float* __restrict__ out,          // (B, V, F)
                      int B, int V, int E, int F, int prescale) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kSageWarpsPerBlock +
      threadIdx.x / kWarp;
  if (row >= static_cast<long long>(B) * V) return;   // whole warps
  const int lane = threadIdx.x % kWarp;
  const int b = static_cast<int>(row / V);
  const int i = static_cast<int>(row - static_cast<long long>(b) * V);
  const float* kb = keep + static_cast<size_t>(b) * E;
  const size_t vf = static_cast<size_t>(V) * F;
  const float* hb = h + b * vf;
  float* orow = out + b * vf + static_cast<size_t>(i) * F;
  const int lo = rowptr[i];
  const int hi = rowptr[i + 1];
  const float deg_i = prescale ? 1.f : sage_degree(eid, kb, lo, hi);

  for (int f0 = 0; f0 < F; f0 += kWarp * kSagePerLane) {
    float acc[kSagePerLane];
#pragma unroll
    for (int u = 0; u < kSagePerLane; ++u) acc[u] = 0.f;
    for (int k = lo; k < hi; ++k) {
      const int4 en = csr[k];
      float c = kb[en.y];
      if (prescale) c = __fdiv_rn(c, sage_degree(eid, kb, en.z, en.w));
      const float* hj = hb + static_cast<size_t>(en.x) * F;
#pragma unroll
      for (int u = 0; u < kSagePerLane; ++u) {
        const int f = f0 + u * kWarp + lane;
        if (f < F) acc[u] = __fadd_rn(acc[u], __fmul_rn(c, hj[f]));
      }
    }
#pragma unroll
    for (int u = 0; u < kSagePerLane; ++u) {
      const int f = f0 + u * kWarp + lane;
      if (f < F) orow[f] = prescale ? acc[u] : __fdiv_rn(acc[u], deg_i);
    }
  }
}

}  // namespace

// One launch on `stream`: prescale = 0 is the forward (the sum over a row
// divided by the row's degree), prescale = 1 its transpose (each neighbour's
// term divided by the neighbour's degree).  B·V must fit an int.  Allocates
// nothing; returns the launch's cudaError_t (0 on success).
extern "C" int sage_aggregate_f32(const void* rowptr, const void* csr,
                                  const void* eid, const void* keep,
                                  const void* h, void* out, int B, int V,
                                  int E, int F, int prescale, void* stream) {
  if (reinterpret_cast<uintptr_t>(csr) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long rows = static_cast<long long>(B) * V;
  const int blocks = static_cast<int>(
      (rows + kSageWarpsPerBlock - 1) / kSageWarpsPerBlock);
  sage_aggregate_kernel<<<blocks, kSageWarpsPerBlock * kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(rowptr), static_cast<const int4*>(csr),
      static_cast<const int32_t*>(eid), static_cast<const float*>(keep),
      static_cast<const float*>(h), static_cast<float*>(out), B, V, E, F,
      prescale);
  return static_cast<int>(cudaGetLastError());
}
