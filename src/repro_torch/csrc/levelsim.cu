// Level-major list-schedule makespan of B placements on Hopper.
//
// Replaces the TPU kernel src/repro/kernels/levelsim.py::_level_kernel (via
// level_makespan).  The Pallas grid walks the topological levels in order on
// one core and vectorises over the placement batch; here the placements are
// the parallel axis and each walks the levels in order.
//
// What bounds it on this card: neither bytes (each placement reads its (V,)
// row once and writes its (V+1,) finish row once) nor operations.  It is a
// dependent chain: L levels, each a gather over the level's predecessors
// followed by the level's queue updates in table order, one warp issuing it.
// So the design takes every load off that chain and every instruction that
// does not need it out of the level loop:
//
// - Staged route.  A block copies the level tables (one int32 array over the
//   real slots, see level_record_offsets in kernels/levelsim.py) and its
//   placements' device rows into shared memory with cp.async, once.  Each
//   placement's finish vector (V+1 floats) lives in shared memory too.
// - The static half of every slot of every placement (its device, its
//   duration there, the transfer terms of its first kPre predecessors and
//   their sum) depends only on the tables and the placement.  A prologue
//   computes it for all of the block's placements into shared memory, so the
//   level loop only loads it, a chunk ahead, and its chain is: the
//   predecessors' finish times (shared memory), their maximum, a shuffle,
//   and the queue updates.
// - A block takes few placements (the plan spreads the batch over the SMs)
//   and always kMaxWarpsPerBlock warps: all of them stage the tables and
//   compute the prologue, those that hold placements then walk the levels.
//   The chain's time does not depend on how many placements a warp carries,
//   the prologue's does.
// - G lanes a placement (G the next power of two >= W, at most 32), so a warp
//   scores up to 32/G placements.  Lane g of a group takes slot g of each
//   chunk of G slots of a level.  The queue pass runs in every group at once:
//   the leader retires the chunk's slots in table order, slot 0 its own, the
//   rest shuffled from their lanes.  Its D·Q queue state is in registers when
//   D·Q <= kRegQueueMax (a template on D and Q, the earliest queue found by a
//   fixed tree of selects), in shared memory above that.  The pass reads no
//   memory besides the shuffles.
// - General route, for tables or finish vectors too large for shared memory:
//   tables, finish vectors and device rows stay in device memory and the
//   static half is computed in the level loop.
//
// Arithmetic is rounded exactly like the plain PyTorch version
// (level_makespan_ref): no fused multiply-add, predecessor transfer terms
// summed in index order, slots retired in table order onto the first
// earliest-free queue, pad slots leave everything untouched (the records hold
// no pad slots).  The tables list a slot's real predecessors first and fold
// data and pad predecessors into the sentinel V: those contribute finish 0
// (fin[V] stays 0) and transfer +0.0, which change neither the maximum nor
// the sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarpsPerBlock = 4;
constexpr int kRegQueueMax = 8;
constexpr int kPre = 4;   // predecessors of a slot whose terms are precomputed
constexpr int kStatic = 4 + kPre;   // words of a slot's static half
enum Route { kStaged = 0, kGeneral = 1 };
// The launch's integer parameters, in the order of the `params` array
// (kernels/levelsim.py::PARAMS mirrors it).
enum Param {
  kTableWords, kOffNodes, kOffUpre, kOffPreds, kOffDur, kL, kW, kP, kV, kD,
  kQ, kS, kRoute, kGroup, kPerBlock, kWarps, kParams
};

// (D, Q) with D·Q <= kRegQueueMax: each gets a kernel with its queues in
// registers.
#define LEVEL_REG_SHAPES(X)                                             \
  X(1, 1) X(1, 2) X(1, 3) X(1, 4) X(1, 5) X(1, 6) X(1, 7) X(1, 8)       \
  X(2, 1) X(2, 2) X(2, 3) X(2, 4) X(3, 1) X(3, 2) X(4, 1) X(4, 2)       \
  X(5, 1) X(6, 1) X(7, 1) X(8, 1)

struct Args {
  // Records over the S real slots, each section 16-byte aligned: first
  // (L+1) | nodes (S) | upre (S, kPre) | preds {id, bytes} (S, P) | dur (S, D)
  const int32_t* tables;
  const int32_t* placements;  // (B, V)
  const float* inv_bw;        // (D, D)
  const float* lat;           // (D, D)
  const float* queue_init;    // (D, Q), +inf = masked queue
  float* finish;              // (B, V + 1)
  float* transfer;            // (B,)
  int B, L, W, P, V, D, Q, S;
  int off_nodes, off_upre, off_preds, off_dur, table_words;
  int group;                  // lanes a placement, a power of two <= 32
  int per_block;              // placements a block
};

__host__ __device__ inline size_t words16(size_t n) { return (n + 3) & ~size_t(3); }

// Dynamic shared memory of a block of `ppb` placements, in the order the
// kernel carves it (kernels/levelsim.py::level_smem mirrors it).
__host__ __device__ inline size_t smem_bytes(int route, int ppb, int V, int D,
                                             int Q, int S, int table_words) {
  size_t n = 4 * words16(2 * size_t(D) * D + size_t(D) * Q);
  if (route == kStaged) {
    n += 4 * (size_t(table_words) + words16(size_t(ppb) * (V + 1))
              + words16(size_t(ppb) * V + 4) + size_t(ppb) * S * kStatic);
  }
  if (route == kGeneral || D * Q > kRegQueueMax) {
    n += 4 * size_t(ppb) * D * Q;
  }
  return n;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// A placement's D·Q queue free times in registers.
template <int D, int Q>
struct RegQueues {
  float q[D * Q];

  __device__ __forceinline__ void init(const float* qinit, float*, bool) {
#pragma unroll
    for (int i = 0; i < D * Q; ++i) q[i] = qinit[i];
  }

  // Retire a node of duration `dur` ready at `ready` on device d onto its
  // first earliest-free queue; → its finish time.
  __device__ __forceinline__ float retire(int d, float ready, float dur,
                                          bool) {
    float row[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      row[j] = q[j];
#pragma unroll
      for (int e = 1; e < D; ++e) row[j] = d == e ? q[e * Q + j] : row[j];
    }
    // First minimum as a tree: a pair's right half (the higher indices)
    // wins only when strictly smaller.
    int id[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) id[j] = j;
#pragma unroll
    for (int step = 1; step < Q; step *= 2) {
#pragma unroll
      for (int j = 0; j + step < Q; j += 2 * step) {
        const bool right = row[j + step] < row[j];
        row[j] = right ? row[j + step] : row[j];
        id[j] = right ? id[j + step] : id[j];
      }
    }
    const float f = __fadd_rn(fmaxf(ready, row[0]), dur);
    const int at = d * Q + id[0];
#pragma unroll
    for (int i = 0; i < D * Q; ++i) q[i] = i == at ? f : q[i];
    return f;
  }
};

// The same in shared memory, one row of D·Q floats a placement, for D·Q
// above kRegQueueMax (and the general route).  Every lane of the group
// reads it; only the leader writes.
struct SharedQueues {
  float* q;
  int DQ, Q;

  __device__ __forceinline__ void init(const float* qinit, float* mine,
                                       bool leader) {
    q = mine;
    if (leader) {
      for (int i = 0; i < DQ; ++i) q[i] = qinit[i];
    }
  }

  __device__ __forceinline__ float retire(int d, float ready, float dur,
                                          bool leader) {
    float* row = q + d * Q;
    int k = 0;
    float qf = row[0];
    for (int j = 1; j < Q; ++j) {
      if (row[j] < qf) {
        qf = row[j];
        k = j;
      }
    }
    const float f = __fadd_rn(fmaxf(ready, qf), dur);
    if (leader) row[k] = f;
    return f;
  }
};

template <int D, int Q>
struct QueuesFor {
  using T = RegQueues<D, Q>;
};
template <>
struct QueuesFor<0, 0> {
  using T = SharedQueues;
};

// The transfer term of `bytes` from device du to d (du != d), with the
// (D, D) link constants in shared memory.
__device__ __forceinline__ float transfer_term(float bytes, int du, int d,
                                               int D, const float* invbw,
                                               const float* lat) {
  return __fadd_rn(__fmul_rn(bytes, invbw[du * D + d]), lat[du * D + d]);
}

// A slot's static half, stored as the words {t, dur, d, 0, tx[0..kPre)}.
struct Static {
  float t, dur;
  int d;
  float tx[kPre];
};

// The static half of real slot rs for the placement whose devices are `dev`.
__device__ __forceinline__ Static static_half(int rs, const Args& a, int D,
                                              const int32_t* tab,
                                              const int32_t* dev,
                                              const float* invbw,
                                              const float* lat) {
  const int V = a.V;
  Static st;
  const int d = dev[tab[a.off_nodes + rs]];
  st.d = d;
  st.dur = __int_as_float(tab[a.off_dur + rs * D + d]);
  const int2* rec = reinterpret_cast<const int2*>(tab + a.off_preds)
      + size_t(rs) * a.P;
  float t = 0.f;
#pragma unroll
  for (int k = 0; k < kPre; ++k) {
    const int2 e = k < a.P ? rec[k] : make_int2(V, 0);
    const int du = e.x != V ? dev[e.x] : d;
    const float tx = du != d
        ? transfer_term(__int_as_float(e.y), du, d, D, invbw, lat) : 0.f;
    st.tx[k] = tx;
    t = __fadd_rn(t, tx);
  }
  st.t = t;
  return st;
}

// What a lane holds of its slot in a chunk, loaded a chunk ahead.
struct Slot {
  int rs;        // real slot index, or -1 past the chunk's real slots
  int v;         // its node (V when rs < 0)
  int n;         // real slots of the chunk (uniform)
  int u[kPre];   // its first kPre predecessor ids (V = none)
  Static st;     // its static half
};

// Chunk q (chunk c of level l, q = l·chunks + c; past the last, the last) of
// lane g: its real slot, node, predecessor ids and static half.
template <bool kStagedRoute>
__device__ __forceinline__ void load_slot(Slot& sl, int q, int chunks, int g,
                                          const Args& a, int D,
                                          const int32_t* tab,
                                          const float* stat,
                                          const int32_t* dev,
                                          const float* invbw,
                                          const float* lat) {
  const int V = a.V;
  q = min(q, a.L * chunks - 1);
  const int l = chunks == 1 ? q : q / chunks;
  const int first = tab[l];
  const int base = first + (q - l * chunks) * a.group;
  const int n = max(0, min(tab[l + 1] - base, a.group));
  const bool real = g < n;
  // A lane past the level's real slots reads the level's first, masked.
  const int rs = real ? base + g : first;
  sl.rs = real ? rs : -1;
  sl.n = n;
  sl.v = real ? tab[a.off_nodes + rs] : V;
  const int4 u4 = *reinterpret_cast<const int4*>(tab + a.off_upre + rs * kPre);
  sl.u[0] = u4.x;
  sl.u[1] = u4.y;
  sl.u[2] = u4.z;
  sl.u[3] = u4.w;
  if (kStagedRoute) {
    const float4* src = reinterpret_cast<const float4*>(stat + size_t(rs) * kStatic);
    const float4 h = src[0];
    const float4 x = src[1];
    sl.st.t = h.x;
    sl.st.dur = h.y;
    sl.st.d = __float_as_int(h.z);
    sl.st.tx[0] = x.x;
    sl.st.tx[1] = x.y;
    sl.st.tx[2] = x.z;
    sl.st.tx[3] = x.w;
  } else {
    sl.st = static_half(rs, a, D, tab, dev, invbw, lat);
  }
}

template <int kD, int kQ, bool kStagedRoute>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
level_makespan_kernel(const Args a) {
  static_assert(kPre == 4, "load_slot moves the predecessor ids as an int4");
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = kD > 0 ? kD : a.D;
  const int Q = kQ > 0 ? kQ : a.Q;
  const int V = a.V, W = a.W, P = a.P, S = a.S, G = a.group;
  const int ppw = kWarp / G;
  const int ppb = a.per_block;
  const int b0 = blockIdx.x * ppb;
  const int nb = min(ppb, a.B - b0);   // placements of this block
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;

  unsigned char* p = smem;
  const int32_t* tab = a.tables;
  float* fin_s = nullptr;
  const int32_t* dev_s = nullptr;
  float* stat_s = nullptr;
  if (kStagedRoute) {
    int32_t* tab_s = reinterpret_cast<int32_t*>(p);
    p += 4 * size_t(a.table_words);
    fin_s = reinterpret_cast<float*>(p);
    p += 4 * words16(size_t(ppb) * (V + 1));
    int32_t* devbuf = reinterpret_cast<int32_t*>(p);
    p += 4 * words16(size_t(ppb) * V + 4);
    stat_s = reinterpret_cast<float*>(p);
    p += 4 * size_t(ppb) * S * kStatic;
    // The tables, in 16-byte pieces.
    for (int i = tid; i < a.table_words / 4; i += blockDim.x) {
      cp_async16(tab_s + 4 * i, a.tables + 4 * i);
    }
    // The block's placement rows, contiguous in device memory: copied at the
    // same offset modulo 16 bytes, so the middle goes in 16-byte pieces.
    const int32_t* src = a.placements + size_t(b0) * V;
    const int n = nb * V;
    const int phase = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    int32_t* dst = devbuf + phase;
    const int head = min((4 - phase) & 3, n);
    const int n4 = (n - head) >> 2;
    for (int i = tid; i < head; i += blockDim.x) cp_async4(dst + i, src + i);
    for (int i = tid; i < n4; i += blockDim.x) {
      cp_async16(dst + head + 4 * i, src + head + 4 * i);
    }
    for (int i = head + 4 * n4 + tid; i < n; i += blockDim.x) {
      cp_async4(dst + i, src + i);
    }
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const int nz = static_cast<int>(words16(size_t(ppb) * (V + 1)) / 4);
    for (int i = tid; i < nz; i += blockDim.x) {
      reinterpret_cast<float4*>(fin_s)[i] = zero;
    }
    tab = tab_s;
    dev_s = dst;
  }
  float* invbw = reinterpret_cast<float*>(p);
  float* lat = invbw + D * D;
  float* qinit = lat + D * D;
  p += 4 * words16(2 * size_t(D) * D + size_t(D) * Q);
  float* qshared = reinterpret_cast<float*>(p);
  for (int i = tid; i < D * D; i += blockDim.x) {
    invbw[i] = a.inv_bw[i];
    lat[i] = a.lat[i];
  }
  for (int i = tid; i < D * Q; i += blockDim.x) qinit[i] = a.queue_init[i];
  if (kStagedRoute) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  if (kStagedRoute) {
    // The static half of every (placement, real slot) of the block, by all
    // the block's threads.
    for (int row = 0; row < nb; ++row) {
      const int32_t* drow = dev_s + size_t(row) * V;
      float* srow = stat_s + size_t(row) * S * kStatic;
      for (int rs = tid; rs < S; rs += blockDim.x) {
        const Static st = static_half(rs, a, D, tab, drow, invbw, lat);
        float4* out = reinterpret_cast<float4*>(srow + size_t(rs) * kStatic);
        out[0] = make_float4(st.t, st.dur, __int_as_float(st.d), 0.f);
        out[1] = make_float4(st.tx[0], st.tx[1], st.tx[2], st.tx[3]);
      }
    }
    __syncthreads();
  }

  // Warps past the block's placements only helped fill shared memory.
  const int first = (tid / kWarp) * ppw;   // this warp's first placement
  if (first >= nb) return;

  const int g = lane & (G - 1);             // lane within the group
  const int mine = first + lane / G;   // placement in block
  const bool active = mine < nb;
  // A group past the batch's end mirrors the block's last placement and
  // writes nothing.
  const int row = active ? mine : nb - 1;
  const bool leader = active && g == 0;
  float* fin;
  const int32_t* dev;
  const float* stat = kStagedRoute ? stat_s + size_t(row) * S * kStatic
                                   : nullptr;
  if (kStagedRoute) {
    fin = fin_s + size_t(row) * (V + 1);
    dev = dev_s + size_t(row) * V;
  } else {
    fin = a.finish + size_t(b0 + row) * (V + 1);
    dev = a.placements + size_t(b0 + row) * V;
    if (active) {
      for (int v = g; v <= V; v += G) fin[v] = 0.f;
    }
    __syncwarp();
  }
  typename QueuesFor<kD, kQ>::T queues;
  if constexpr (kD == 0) {
    queues.DQ = D * Q;
    queues.Q = Q;
  }
  queues.init(qinit, qshared + size_t(row) * D * Q, leader);
  __syncwarp();

  const int chunks = (W + G - 1) / G;   // chunks of G slots a level
  Slot sl, nx;
  load_slot<kStagedRoute>(sl, 0, chunks, g, a, D, tab, stat, dev, invbw, lat);
  float tr = 0.f;   // the running transfer total (the leader's is stored)
  for (int q = 0; q < a.L * chunks; ++q) {
    // The next chunk's slot, loaded now: nothing in it waits on this level.
    load_slot<kStagedRoute>(nx, q + 1, chunks, g, a, D, tab, stat, dev, invbw,
                            lat);
    // Readiness: the predecessors' finish times, the chain's only loads
    // (fin[V] is 0 and its term +0.0, so a missing predecessor adds
    // nothing), maxed as a tree.
    float m[kPre];
#pragma unroll
    for (int k = 0; k < kPre; ++k) m[k] = __fadd_rn(fin[sl.u[k]], sl.st.tx[k]);
#pragma unroll
    for (int step = 1; step < kPre; step *= 2) {
#pragma unroll
      for (int k = 0; k + step < kPre; k += 2 * step) {
        m[k] = fmaxf(m[k], m[k + step]);
      }
    }
    float r = fmaxf(m[0], 0.f);
    float t = sl.st.t;
    if (P > kPre && sl.rs >= 0) {
      // Predecessors past the first kPre (wide graphs): loaded here.
      const int2* rec = reinterpret_cast<const int2*>(tab + a.off_preds)
          + size_t(sl.rs) * P;
      const int d = sl.st.d;
      for (int k = kPre; k < P; ++k) {
        const int2 e = rec[k];
        if (e.x == V) break;   // the real ones come first
        const int du = dev[e.x];
        const float tx = du != d
            ? transfer_term(__int_as_float(e.y), du, d, D, invbw, lat) : 0.f;
        r = fmaxf(r, __fadd_rn(fin[e.x], tx));
        t = __fadd_rn(t, tx);
      }
    }
    // Queue pass over the chunk's real slots, in table order: every lane of
    // a group runs it on the same values (slot 0 is the leader's own, the
    // rest are shuffled from their lanes); the leader stores.
    if (sl.n > 0) {
      const float f = queues.retire(sl.st.d, r, sl.st.dur, leader);
      if (leader) fin[sl.v] = f;
      tr = __fadd_rn(tr, t);
    }
    for (int j = 1; j < sl.n; ++j) {
      const int vj = __shfl_sync(kFull, sl.v, j, G);
      const int dj = __shfl_sync(kFull, sl.st.d, j, G);
      const float uj = __shfl_sync(kFull, sl.st.dur, j, G);
      const float tj = __shfl_sync(kFull, t, j, G);
      const float rj = __shfl_sync(kFull, r, j, G);
      const float f = queues.retire(dj, rj, uj, leader);
      if (leader) fin[vj] = f;
      tr = __fadd_rn(tr, tj);
    }
    sl = nx;
    __syncwarp();
  }

  if (kStagedRoute) {
    // This warp's placements are contiguous in `finish` and in fin_s.
    const int cnt = min(ppw, nb - first);
    float* out = a.finish + size_t(b0 + first) * (V + 1);
    const float* src = fin_s + size_t(first) * (V + 1);
    for (size_t i = lane; i < size_t(cnt) * (V + 1); i += kWarp) out[i] = src[i];
  }
  if (leader) a.transfer[b0 + mine] = tr;
}

using Kernel = void (*)(Args);

Kernel pick(int route, int D, int Q) {
  if (route == kGeneral) return level_makespan_kernel<0, 0, false>;
  if (D * Q > kRegQueueMax) return level_makespan_kernel<0, 0, true>;
#define LEVEL_REG_CASE(d, q) \
  if (D == d && Q == q) return level_makespan_kernel<d, q, true>;
  LEVEL_REG_SHAPES(LEVEL_REG_CASE)
#undef LEVEL_REG_CASE
  return nullptr;
}

}  // namespace

// Dynamic shared memory of a block of `ppb` placements on `route`, for the
// launch plan's check.
extern "C" long long level_makespan_smem(int route, int ppb, int V, int D,
                                         int Q, int S, int table_words) {
  return static_cast<long long>(
      smem_bytes(route, ppb, V, D, Q, S, table_words));
}

// Launches the plan's grid (kernels/levelsim.py::level_launch_plan) for B
// placements on `stream`: `params` holds the ints of enum Param (the records'
// section offsets, the shapes, and the plan's route, lanes a placement,
// placements and warps a block), fixed for a graph and a batch size.
// Allocates nothing; returns the launch's cudaError_t (0 on success).
extern "C" int level_makespan_f32(
    const void* tables, const int* params, const void* placements,
    const void* inv_bw, const void* lat, const void* queue_init,
    void* finish, void* transfer, int B, void* stream) {
  const int route = params[kRoute], group = params[kGroup];
  const int per_block = params[kPerBlock], warps = params[kWarps];
  const int D = params[kD], Q = params[kQ];
  if ((route != kStaged && route != kGeneral) || group < 1 || group > kWarp
      || (group & (group - 1)) || warps < 1 || warps > kMaxWarpsPerBlock
      || per_block < 1 || per_block > warps * (kWarp / group) || B < 1
      || params[kL] < 1 || params[kW] < 1 || params[kP] < 1 || params[kV] < 1
      || D < 1 || Q < 1 || params[kS] < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = pick(route, D, Q);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(route, per_block, params[kV], D, Q,
                                 params[kS], params[kTableWords]);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args a;
  a.tables = static_cast<const int32_t*>(tables);
  a.placements = static_cast<const int32_t*>(placements);
  a.inv_bw = static_cast<const float*>(inv_bw);
  a.lat = static_cast<const float*>(lat);
  a.queue_init = static_cast<const float*>(queue_init);
  a.finish = static_cast<float*>(finish);
  a.transfer = static_cast<float*>(transfer);
  a.B = B;
  a.L = params[kL];
  a.W = params[kW];
  a.P = params[kP];
  a.V = params[kV];
  a.D = D;
  a.Q = Q;
  a.S = params[kS];
  a.off_nodes = params[kOffNodes];
  a.off_upre = params[kOffUpre];
  a.off_preds = params[kOffPreds];
  a.off_dur = params[kOffDur];
  a.table_words = params[kTableWords];
  a.group = group;
  a.per_block = per_block;
  kernel<<<(B + per_block - 1) / per_block, warps * kWarp, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
