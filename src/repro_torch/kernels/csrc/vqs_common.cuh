// Pieces shared by the scheduler kernels of the VQS family (vqs.cu,
// vqs_bf.cu) and, for the grid arithmetic, the bitmask words and the
// departure bookkeeping, by bfjs_mr.cu.
//
// Each kernel simulates one ensemble member per thread block over the whole
// horizon on the int32 RES = 2^16 size grid of the engines, with a decision
// warp that makes every decision and a stream warp that loads the next slot
// and keeps bookkeeping off the decision chain.  Lane i of a warp owns
// servers i, i + 32, ...: a per-lane bitmask word w holds, in bit b, server
// (32 w + b) * 32 + i, so a lane's set bits are its servers in index order
// and bit b over all lanes is the round of 32 servers starting at
// (32 w + b) * 32.  Each kernel lays its own state out
// (`<name>_layout`); the Python side reads it through the exported
// `<name>_shared_bytes` / `<name>_workspace_bytes`.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"

namespace vqsk {

constexpr int kMaxJ = 16;  // 2J queues fit one 32-bit mask; 2^J <= RES
constexpr int kInfSlot = 0x7fffffff;
constexpr int kInf32 = 0x7fffffff;
constexpr int kRes = 1 << 16;
constexpr int kCap = kRes;                     // unit server capacity
constexpr int kReserve = (2 * kRes + 1) / 3;   // the VQ_1 reservation
constexpr size_t kSmemLimit = 232448;          // dynamic + static, per block
constexpr size_t kStaticSmem = 1024;           // reduction/broadcast scratch
constexpr int kEffBits = 17;                   // effective sizes are <= RES = 2^16
constexpr int kEffMask = (1 << kEffBits) - 1;

// Per-server flag bits, rebuilt for the servers of each slot's visit set
// (kK1 and kHasCfg persist across slots).
enum Flag : int {
  kK1 = 1,          // active configuration has k_1 > 0
  kHasCfg = 2,      // server has a configuration
  kFreed = 8,       // a job left this slot
  kEmptyNow = 16,   // no resident job after this slot's departures
  kRenew = 64,      // visit needs a configuration renewal at first touch
  kTouched = 128,   // reached by the work list this slot
};

// Bitmask words of a row of K job slots, and of one lane's servers.
__host__ __device__ inline int row_words(int K) { return (K + 31) / 32; }
__host__ __device__ inline int lane_words(int L) { return ((L + 31) / 32 + 31) / 32; }

// The word (of a (words, 32) per-lane mask) and the bit of server s.
__device__ __forceinline__ int mask_at(int s) { return ((s >> 5) >> 5) * 32 + (s & 31); }
__device__ __forceinline__ unsigned mask_bit(int s) { return 1u << ((s >> 5) & 31); }

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

// Words of one slot's classified arrivals (`classify_slot`).
__host__ __device__ inline int arrival_words(int A, int nvq) { return 4 * A + 2 * nvq; }

// Stream warp: slot u's arrivals classified into b (arrival_words words):
// type (-1 past n_u), effective size, duration (the last A of the row's D
// lanes), rank among the slot's arrivals of its type; per type, the count
// and the arrivals of lower types.
__device__ inline void classify_slot(int* b, int n_u, const float* sizes_u, const int* durs_u,
                                     int A, int D, int J) {
  const int lane = threadIdx.x & 31, nvq = 2 * J;
  int *bvq = b, *beff = b + A, *bdur = b + 2 * A, *brank = b + 3 * A;
  int *bcnt = b + 4 * A, *boff = bcnt + nvq;
  for (int a = lane; a < A; a += 32) {
    int v = -1, e = 0, d = 0;
    if (a < n_u) {
      const int gq = to_grid(sizes_u[a]);
      v = classify(gq, J);
      e = effective(gq, v, J);
      d = durs_u[D - A + a];
    }
    bvq[a] = v;
    beff[a] = e;
    bdur[a] = d;
  }
  __syncwarp();
  for (int a = lane; a < A; a += 32) {
    const int v = bvq[a];
    int r = 0;
    for (int c = 0; c < a; ++c) r += bvq[c] == v;
    brank[a] = r;
  }
  for (int j = lane; j < nvq; j += 32) {
    int c = 0, o = 0;
    for (int a = 0; a < A; ++a) {
      const int v = bvq[a];
      c += v == j;
      o += v >= 0 && v < j;
    }
    bcnt[j] = c;
    boff[j] = o;
  }
}

// Stream warp: the next departure slot and due slots of each row in `recf`
// (rows that lost jobs at slot t), over the jobs it kept (`rec_mask`, whose
// departure slots `dep` were written before t); the result goes to rec_nd
// and rec_mask, which the decision warp merges (`merge_departures`).
__device__ inline void recompute_departures(const unsigned* recf, const int* dep,
                                            unsigned* rec_mask, int* rec_nd, int NW, int K,
                                            int t) {
  const int lane = threadIdx.x & 31, KW = row_words(K);
  for (int w = 0; w < NW; ++w) {
    unsigned m = recf[w * 32 + lane];
    while (m) {
      const int l = (w * 32 + __ffs(m) - 1) * 32 + lane;
      m &= m - 1;
      const int* drow = dep + static_cast<size_t>(l) * K;
      unsigned* rm = rec_mask + static_cast<size_t>(l) * KW;
      int nd = kInfSlot;
      for (int kw = 0; kw < KW; ++kw) {
        for (unsigned b = rm[kw]; b; b &= b - 1) {
          const int dk = drow[kw * 32 + __ffs(b) - 1];
          if (dk > t && dk < nd) nd = dk;
        }
      }
      for (int kw = 0; kw < KW; ++kw) {
        unsigned out = 0u;
        for (unsigned b = rm[kw]; b; b &= b - 1) {
          const int k = __ffs(b) - 1;
          if (nd != kInfSlot && drow[kw * 32 + k] == nd) out |= 1u << k;
        }
        rm[kw] = out;
      }
      rec_nd[l] = nd;
    }
  }
}

// Decision warp, at the start of a slot: the recomputed next departures of
// last slot's rows join what placements set meanwhile; `recf` is cleared.
__device__ inline void merge_departures(unsigned* recf, const int* rec_nd,
                                        const unsigned* rec_mask, int* next_dep, unsigned* due,
                                        int NW, int KW) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int w = 0; w < NW; ++w) {
    unsigned m = recf[w * 32 + lane];
    recf[w * 32 + lane] = 0u;
    while (m) {
      const int l = (w * 32 + __ffs(m) - 1) * 32 + lane;
      m &= m - 1;
      const int nd = rec_nd[l], cur = next_dep[l];
      unsigned* dm = due + static_cast<size_t>(l) * KW;
      const unsigned* rm = rec_mask + static_cast<size_t>(l) * KW;
      if (nd < cur) {
        next_dep[l] = nd;
#pragma unroll 1
        for (int kw = 0; kw < KW; ++kw) dm[kw] = rm[kw];
      } else if (nd == cur && nd != kInfSlot) {
#pragma unroll 1
        for (int kw = 0; kw < KW; ++kw) dm[kw] |= rm[kw];
      }
    }
  }
}

// Row c of K_RED as a renewal: k_1 > 0 (bit 0), j* + 1 (bits 1-6; 0 when
// the row has no type but 1), k_{j*} (bits 7 and up) — j* is the first
// nonzero type other than 1.
__device__ inline int decode_row(const int* row, int nvq) {
  int js = -1;
  for (int j = 0; j < nvq && js < 0; ++j) {
    if (j != 1 && row[j] > 0) js = j;
  }
  return (row[1] > 0) | ((js + 1) << 1) | ((js >= 0 ? row[js] : 0) << 7);
}

// The max-weight rows of K_RED (paper Eq. 8) kept by the decision warp:
// lane i holds the weights <k_c, qcnt> of rows c = i and i + 32 (C = 4J - 4
// <= 60), moved by every change of a queue count; `best` is the first row
// of the greatest weight.
struct MaxWeight {
  int w_lo = 0, w_hi = 0;

  __device__ void move(const int* confs, int C, int nvq, int j, int delta) {
    const int lane = threadIdx.x & 31;
    if (lane < C) w_lo += delta * confs[lane * nvq + j];
    if (lane + 32 < C) w_hi += delta * confs[(lane + 32) * nvq + j];
  }

  __device__ int best(int C) const {
    const int lane = threadIdx.x & 31;
    int bw = -1, bc = 0x7fffffff;
    if (lane < C) { bw = w_lo; bc = lane; }
    if (lane + 32 < C && w_hi > bw) { bw = w_hi; bc = lane + 32; }
    unsigned top;
    return repro::warp_argmax_key(static_cast<unsigned>(bw + 1), bc, top);
  }
};

}  // namespace vqsk
