// Pieces shared by the VQS-family kernels (vqs.cu, vqs_bf.cu).
//
// Both kernels simulate one ensemble member per thread block over the whole
// horizon, on the int32 RES = 2^16 size grid of the engines, with the
// constants, flag bits and grid arithmetic below.  vqs.cu splits the
// member's state by `split_layout`:
//   * shared memory: the K_RED table, per-server aggregates that every
//     work-list step reads (next departure slot, occupancy, resident jobs,
//     configuration, flag bits, 32-bit subscription mask), per-queue
//     counters, the slot's arrival lanes, and the ring planes when they fit;
//   * a per-member global workspace (allocated by the wrapper): the (L, K)
//     job planes — sizes and departure slots as int32, VQ types as int8 —
//     which are touched only by departures and placements, and the ring
//     planes when they do not fit beside the rest.
// vqs_bf.cu lays its own state out (`vqs_bf_layout`).  The Python side reads
// either layout through the exported `<name>_shared_bytes` /
// `<name>_workspace_bytes`; it is written only in the kernels' sources.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"

namespace vqsk {

constexpr int kThreads = 512;
constexpr int kMaxJ = 16;  // 2J queues fit one 32-bit mask; 2^J <= RES
constexpr int kInfSlot = 0x7fffffff;
constexpr int kInf32 = 0x7fffffff;
constexpr int kRes = 1 << 16;
constexpr int kCap = kRes;                     // unit server capacity
constexpr int kReserve = (2 * kRes + 1) / 3;   // the VQ_1 reservation
constexpr size_t kSmemLimit = 232448;          // dynamic + static, per block
constexpr size_t kStaticSmem = 1024;           // reduction/broadcast scratch

// Per-server flag bits.  The first three persist across slots; the rest are
// rebuilt every slot.
enum Flag : int {
  kK1 = 1,          // active configuration has k_1 > 0
  kHasCfg = 2,      // server has a configuration
  kInEmpty = 4,     // the scheduler's _empty membership
  kFreed = 8,       // a job left this slot
  kEmptyNow = 16,   // no resident job after this slot's departures
  kVisit = 32,      // in this slot's visit set
  kRenew = 64,      // visit needs a configuration renewal at first touch
  kTouched = 128,   // reached by the work list this slot
  kAdvanced = 256,  // served (or passed) and done for this slot
};
constexpr int kSlotFlags = kK1 | kHasCfg | kInEmpty;

struct Layout {
  bool rings_in_smem;
  size_t shared_bytes;     // dynamic shared memory of one block
  size_t workspace_bytes;  // global workspace of one member (16-aligned)
};

// Rings join the fixed part in shared memory when both fit beside the
// static scratch; the workspace holds srv, dep (int32), the rings when they
// do not fit, then vqof (int8).  `shared_bytes` is the dynamic part; the
// exported `<name>_shared_bytes` adds the static scratch, which is what the
// per-block limit is checked against.
__host__ inline Layout split_layout(size_t fixed_words, size_t ring_words, int L, int K) {
  Layout lay;
  const size_t both = 4 * (fixed_words + ring_words);
  lay.rings_in_smem = both + kStaticSmem <= kSmemLimit;
  lay.shared_bytes = lay.rings_in_smem ? both : 4 * fixed_words;
  const size_t lk = static_cast<size_t>(L) * K;
  const size_t ws = 8 * lk + (lay.rings_in_smem ? 0 : 4 * ring_words) + lk;
  lay.workspace_bytes = (ws + 15) / 16 * 16;
  return lay;
}

// The member's (L, K) planes and, when they live in global memory, its
// rings, carved from the workspace in the order of `split_layout`.
struct JobPlanes {
  int* srv;
  int* dep;
  int* rings;  // nullptr when the rings are in shared memory
  signed char* vqof;
};

__device__ inline JobPlanes job_planes(unsigned char* ws, int L, int K, size_t ring_words,
                                       bool rings_in_smem) {
  const size_t lk = static_cast<size_t>(L) * K;
  JobPlanes p;
  p.srv = reinterpret_cast<int*>(ws);
  p.dep = p.srv + lk;
  p.rings = rings_in_smem ? nullptr : p.dep + lk;
  p.vqof = reinterpret_cast<signed char*>(p.dep + lk + (rings_in_smem ? 0 : ring_words));
  return p;
}

// max(round(size * RES), 1) in float32, round half to even — the engines'
// in-loop quantization.
__device__ __forceinline__ int to_grid(float s) {
  return __float2int_rz(fmaxf(rintf(s * 65536.f), 1.f));
}

// Partition-I type of a grid size (ops.vq_type_of_grid, comparison for
// comparison).
__device__ __forceinline__ int classify(int g, int J) {
  int m = 0;
  for (int k = 1; k <= J; ++k) m += g <= (kRes >> k);
  m = min(m, J - 1);
  const int upper = kRes >> m;
  const int t = 3 * g > 2 * upper ? 2 * m : 2 * m + 1;
  return g <= (kRes >> J) ? 2 * J - 1 : t;
}

// Effective size: the last VQ rounds up to 1/2^J.
__device__ __forceinline__ int effective(int g, int v, int J) {
  return v == 2 * J - 1 ? max(g, kRes >> J) : g;
}

// t + d with int32 wrap-around, as the engines' int32 arithmetic.
__device__ __forceinline__ int add_wrap(int t, int d) {
  return static_cast<int>(static_cast<unsigned>(t) + static_cast<unsigned>(d));
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(repro::kFullMask, v, off);
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(repro::kFullMask, v, off));
  return v;
}

// Row of K_RED maximizing <k, qcnt> (paper Eq. 8), first row on ties —
// called by a whole warp, result in every lane.  Lane i weighs rows i,
// i + 32, ... in order, keeping the first best.
__device__ __forceinline__ int max_weight_row(const int* confs, const int* qcnt, int C, int nvq) {
  const int lane = threadIdx.x & 31;
  int w = -kInf32 - 1, i = kInf32;
  for (int c = lane; c < C; c += 32) {
    int wc = 0;
    for (int j = 0; j < nvq; ++j) wc += confs[c * nvq + j] * qcnt[j];
    if (wc > w) {
      w = wc;
      i = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ow = __shfl_xor_sync(repro::kFullMask, w, off);
    const int oi = __shfl_xor_sync(repro::kFullMask, i, off);
    if (ow > w || (ow == w && oi < i)) {
      w = ow;
      i = oi;
    }
  }
  return i;
}

// j* of a K_RED row: the first nonzero type other than 1, or -1.
__device__ __forceinline__ int first_other_type(const int* row, int nvq) {
  for (int j = 0; j < nvq; ++j) {
    if (j != 1 && row[j] > 0) return j;
  }
  return -1;
}

// This slot's arrivals, a lane per thread: VQ type (-1 for lanes past
// n_t), effective size, and duration from the last A of the row's D lanes.
__device__ inline void classify_arrivals(const float* sizes_t, const int* durs_t, int n_t, int A,
                                         int D, int J, int* a_vq, int* a_eff, int* a_dur) {
  for (int a = threadIdx.x; a < A; a += blockDim.x) {
    int v = -1, e = 0, d = 0;
    if (a < n_t) {
      const int g = to_grid(sizes_t[a]);
      v = classify(g, J);
      e = effective(g, v, J);
      d = durs_t[D - A + a];
    }
    a_vq[a] = v;
    a_eff[a] = e;
    a_dur[a] = d;
  }
}

// The visit set: freed servers, woken subscribers (their subscriptions to
// the arrived types are consumed), and _empty members while work is
// queued.  A visit renews the configuration at first touch when the server
// emptied this slot or never had one.
__device__ inline void visit_pass(int* flags, unsigned* want, int L, unsigned arrived, int qtot) {
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    int f = flags[l];
    const unsigned w = want[l];
    want[l] = w & ~arrived;
    if ((f & kFreed) || (w & arrived) || ((f & kInEmpty) && qtot > 0)) {
      f |= kVisit;
      if ((f & kEmptyNow) || !(f & kHasCfg)) f |= kRenew;
    }
    flags[l] = f;
  }
}

// 1 when a visited server was neither served nor passed this slot (the
// step bound cut the slot short), in every thread.
__device__ inline int any_pending(const int* flags, int L, int* red) {
  int pend = 0;
  for (int l = threadIdx.x; l < L; l += blockDim.x) {
    const int f = flags[l];
    if ((f & kVisit) && !(f & kAdvanced)) pend = 1;
  }
  return repro::block_reduce(pend, red, repro::MaxI());
}

// The slot's outputs (thread 0 writes): queued jobs, occupancy as the
// float of the int32 grid sum over RES, departures.
__device__ inline void write_slot(const int* occ, const int* qcnt, int L, int nvq, int n_dep,
                                  int* red, int* qlen_t, float* occ_t, int* ndep_t) {
  int my_occ = 0;
  for (int l = threadIdx.x; l < L; l += blockDim.x) my_occ += occ[l];
  const int occ_tot = repro::block_reduce(my_occ, red, repro::SumI());
  if (threadIdx.x == 0) {
    int q = 0;
    for (int j = 0; j < nvq; ++j) q += qcnt[j];
    *qlen_t = q;
    *occ_t = __int2float_rn(occ_tot) / 65536.f;
    *ndep_t = n_dep;
  }
}

}  // namespace vqsk
