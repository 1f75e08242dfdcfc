// Level-major list-schedule makespan of B placements on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/levelsim.py::_level_kernel (via
// level_makespan).  The Pallas grid walks the topological levels in order on
// one core and vectorises over the placement batch; here the placements are
// the parallel axis: one warp per placement, levels walked in order inside
// the warp.
//
// What bounds it on this card: neither bytes (each placement reads its (V,)
// row once and writes its (V+1,) finish row once) nor operations.  It is a
// dependent chain: L levels, each a gather over the level's predecessors
// followed by W sequential first-minimum queue updates.  The design keeps
// every value on that chain on chip: the placement's finish vector and device
// row live in shared memory, the D·Q queue state is a few shared floats that
// only lane 0 touches, and the level tables (read by every warp) stay in L2.
//
// Arithmetic is rounded exactly like the plain PyTorch version
// (level_makespan_ref): no fused multiply-add, predecessor transfer terms
// summed in index order, slots retired in table order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;

__global__ void level_makespan_kernel(
    const int32_t* __restrict__ nodes,       // (L, W), pad = V
    const int32_t* __restrict__ preds,       // (L, W, P), pad = V
    const float* __restrict__ dur,           // (L, W, D)
    const float* __restrict__ pred_bytes,    // (L, W, P)
    const float* __restrict__ pred_data,     // (L, W, P), 1 = data/pad pred
    const int32_t* __restrict__ placements,  // (B, V)
    const float* __restrict__ inv_bw,        // (D, D)
    const float* __restrict__ lat,           // (D, D)
    const float* __restrict__ queue_init,    // (D, Q), +inf = masked queue
    float* __restrict__ finish,              // (B, V + 1)
    float* __restrict__ transfer,            // (B,)
    int L, int W, int P, int V, int D, int Q) {
  extern __shared__ float smem[];
  float* fin = smem;                                   // V + 1
  float* queues = fin + (V + 1);                       // D * Q
  float* ready = queues + D * Q;                       // W
  float* txsum = ready + W;                            // W
  int* dev = reinterpret_cast<int*>(txsum + W);        // V + 1

  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  const int32_t* prow = placements + static_cast<size_t>(b) * V;
  for (int v = lane; v < V; v += kWarp) {
    fin[v] = 0.f;
    dev[v] = prow[v];
  }
  if (lane == 0) {
    fin[V] = 0.f;   // sentinel slot: pads and data preds read finish 0
    dev[V] = 0;     // and device 0
  }
  for (int i = lane; i < D * Q; i += kWarp) queues[i] = queue_init[i];
  __syncwarp();

  float tr = 0.f;   // lane 0's running transfer total
  for (int l = 0; l < L; ++l) {
    // Readiness of every slot of the level: lanes over slots, predecessors
    // in index order within a lane.
    for (int w = lane; w < W; w += kWarp) {
      const int s = l * W + w;
      const int d = dev[nodes[s]];
      float r = 0.f;
      float t = 0.f;
      for (int p = 0; p < P; ++p) {
        const int k = s * P + p;
        const int u = preds[k];
        const int du = dev[u];
        float tx = 0.f;
        if (!(pred_data[k] > 0.f) && du != d) {
          tx = __fadd_rn(__fmul_rn(pred_bytes[k], inv_bw[du * D + d]),
                         lat[du * D + d]);
        }
        r = fmaxf(r, __fadd_rn(fin[u], tx));
        t = __fadd_rn(t, tx);
      }
      ready[w] = r;
      txsum[w] = t;
    }
    __syncwarp();
    // Queue bookkeeping in retire order: earliest-free queue, first minimum.
    if (lane == 0) {
      for (int w = 0; w < W; ++w) {
        const int s = l * W + w;
        const int v = nodes[s];
        if (v == V) continue;   // pad slot: queues, finish and total untouched
        const int d = dev[v];
        float* qrow = queues + d * Q;
        int q = 0;
        float qf = qrow[0];
        for (int j = 1; j < Q; ++j) {
          if (qrow[j] < qf) {
            qf = qrow[j];
            q = j;
          }
        }
        const float f = __fadd_rn(fmaxf(ready[w], qf), dur[s * D + d]);
        fin[v] = f;
        qrow[q] = f;
        tr = __fadd_rn(tr, txsum[w]);
      }
    }
    __syncwarp();
  }

  float* frow = finish + static_cast<size_t>(b) * (V + 1);
  for (int v = lane; v <= V; v += kWarp) frow[v] = fin[v];
  if (lane == 0) transfer[b] = tr;
}

}  // namespace

// Launches one warp per placement on `stream`.  Allocates nothing; returns
// the launch's cudaError_t (0 on success).
extern "C" int level_makespan_f32(
    const void* nodes, const void* preds, const void* dur,
    const void* pred_bytes, const void* pred_data, const void* placements,
    const void* inv_bw, const void* lat, const void* queue_init,
    void* finish, void* transfer,
    int B, int L, int W, int P, int V, int D, int Q, void* stream) {
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(V + 1)
                                       + static_cast<size_t>(D) * Q + 2 * W);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_makespan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  level_makespan_kernel<<<B, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nodes), static_cast<const int32_t*>(preds),
      static_cast<const float*>(dur), static_cast<const float*>(pred_bytes),
      static_cast<const float*>(pred_data),
      static_cast<const int32_t*>(placements),
      static_cast<const float*>(inv_bw), static_cast<const float*>(lat),
      static_cast<const float*>(queue_init), static_cast<float*>(finish),
      static_cast<float*>(transfer), L, W, P, V, D, Q);
  return static_cast<int>(cudaGetLastError());
}
