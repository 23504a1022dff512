// Fused multi-resource BF-J/S slot engine (paper Section VIII) on Hopper.
//
// Replaces the Pallas TPU kernel `_bfjs_mr_kernel`
// (src/repro/kernels/bfjs_mr/bfjs_mr.py).  One thread block simulates one
// member of the Monte-Carlo ensemble over the whole horizon, on the int32
// RES = 2^16 grid of the engines, with R resources (1 <= R <= 4, a template
// parameter).  Per slot: departures; up to A_max arrivals enter the first
// empty queue positions; then a work list of at most W steps: BF-S over the
// freed servers in ascending order — repeatedly the queued job with the
// largest total demand that fits (ties: lowest seq, lowest position) — then
// BF-J over the landed arrivals in order — the feasible server with the
// lowest exact Tetris alignment score <demand, available> (ties: lowest
// index).  Each BF-S placement, each BF-S K-full block (which ends the BF-S
// pass and counts in `truncated`) and each BF-J attempt (placed, K-full,
// infeasible, or already taken by BF-S) is one step; a slot that ends with
// the steps spent while a fit or a feasible queued arrival remains adds 1 to
// `truncated`.  The trajectory is the one of the scan engine
// (repro_torch/core/engine/bfjs_mr.py, the plain version) on every field,
// occupancy included: all arithmetic is integer.
//
// The TPU kernel recomputes the (L, Qcap) fits matrix at every step.  This
// kernel follows the oracle's loop order instead, which needs no matrix:
// placements only consume queue entries and only shrink availability, so a
// freed server with no fitting job has none for the rest of the slot, and
// the lowest freed server with a fit — the scan engine's choice at every
// step — is the current one of an ascending walk.  A BF-S step is one
// block-wide arg-max over the queue for the current server; a BF-J step one
// block-wide arg-min over the L servers.
//
// The alignment score is computed as the JAX `alignment_score_pair_jnp`
// does — an int32 (hi, lo) pair against the split demand (d >> 8, d & 255),
// in wrapping 32-bit arithmetic — and compared as hi * 256 + lo in 64 bits,
// which orders exactly as the lexicographic pair.  No float enters: a float
// mul+add may be contracted into an FMA, which flips tie-breaks.
//
// What bounds it here: slot t+1 depends on slot t and step s+1 on step s,
// so the time is the chain of T x (steps) block-wide reductions — a latency
// bound, far above the bytes it must move.  The TPU kernel kept the whole
// state in VMEM: 340,304 bytes at L = 1000, K = 16, R = 2, Qcap = 1024, over
// the 232,448 bytes of shared memory a block may use.  So the state is
// split: shared memory holds what every step reads — per-server occupancy
// (L, R), a cached next departure slot, the freed flags and the slot's
// ascending freed list — and the queue (R demand rows, durations, seq ids)
// while it fits; a per-member global workspace from the wrapper holds the
// (L, K, R) demand plane and the (L, K) departure plane, which only
// departures and placements touch (192 KB a member at that shape), and the
// queue when it does not fit.  A server's row is scanned for departures only
// in the slot its cached next departure comes due.
#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"
#include "vqs_common.cuh"  // to_grid, add_wrap

namespace {

constexpr int kThreads = 512;
constexpr int kMaxR = 4;
constexpr int kInfSlot = 0x7fffffff;
constexpr int kNone = 0x7fffffff;
constexpr long long kKeyMin = -0x7fffffffffffffffLL - 1;
constexpr long long kKeyMax = 0x7fffffffffffffffLL;
constexpr size_t kSmemLimit = 232448;  // dynamic + static, per block
constexpr size_t kStaticSmem = 1024;   // reduction/broadcast scratch

struct Caps {
  int v[kMaxR];  // per-resource capacity on the grid, round(c * RES)
};

struct Layout {
  bool queue_in_smem;
  size_t shared_bytes;     // dynamic shared memory of one block
  size_t workspace_bytes;  // global workspace of one member (16-aligned)
};

// Shared: occ (L, R), next_dep, freed, freed list (L each), arrival
// positions (A), then the queue — qdem (R, Qcap), qdur, qseq (Qcap each) —
// when it fits beside the static scratch.  Workspace: dem (L, K, R), dep
// (L, K), then the queue when it does not fit.
__host__ Layout bfjs_mr_layout(int L, int K, int Qcap, int A, int R) {
  const size_t fixed = static_cast<size_t>(L) * (R + 3) + A;
  const size_t queue = static_cast<size_t>(R + 2) * Qcap;
  Layout lay;
  lay.queue_in_smem = 4 * (fixed + queue) + kStaticSmem <= kSmemLimit;
  lay.shared_bytes = 4 * (lay.queue_in_smem ? fixed + queue : fixed);
  const size_t ws =
      4 * (static_cast<size_t>(L) * K * (R + 1) + (lay.queue_in_smem ? 0 : queue));
  lay.workspace_bytes = (ws + 15) / 16 * 16;
  return lay;
}

// First empty slot (departure kInfSlot) of a server's departure row —
// called by a whole warp, result in every lane; K when the row is full.
__device__ __forceinline__ int warp_first_empty(const int* drow, int K) {
  const int lane = threadIdx.x & 31;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const unsigned b = __ballot_sync(repro::kFullMask, k < K && drow[k] == kInfSlot);
    if (b) return k0 + __ffs(b) - 1;
  }
  return K;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
bfjs_mr_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
               const int* __restrict__ durs, int T, int L, int K, int Qcap, int A, int D,
               int W, Caps caps, unsigned char* __restrict__ ws, size_t ws_stride,
               int queue_in_smem, int* __restrict__ qlen, float* __restrict__ occ_out,
               int* __restrict__ ndep_out, int* __restrict__ dropped_out,
               int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ long long redv[32];
  __shared__ int redi[32];
  __shared__ int bc_slot;

  int* occ = smem;                // (L, R) occupied grid units
  int* next_dep = occ + L * R;    // earliest departure slot > t per server
  int* freed = next_dep + L;      // a job left this slot
  int* flist = freed + L;         // the freed servers, ascending
  int* new_pos = flist + L;       // queue position of each arrival lane

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;
  int* dem = reinterpret_cast<int*>(ws + g * ws_stride);  // (L, K, R)
  int* dep = dem + static_cast<size_t>(L) * K * R;        // (L, K)
  int* qdem = queue_in_smem ? new_pos + A : dep + static_cast<size_t>(L) * K;  // (R, Qcap)
  int* qdur = qdem + static_cast<size_t>(R) * Qcap;
  int* qseq = qdur + Qcap;  // -1 = empty
  n += g * T;
  sizes += g * T * static_cast<size_t>(A) * R;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ_out += g * T * R;
  ndep_out += g * T;

  for (int i = tid; i < L * R; i += nt) occ[i] = 0;
  for (int l = tid; l < L; l += nt) next_dep[l] = kInfSlot;
  for (size_t i = tid; i < static_cast<size_t>(L) * K * R; i += nt) dem[i] = 0;
  for (size_t i = tid; i < static_cast<size_t>(L) * K; i += nt) dep[i] = kInfSlot;
  for (int q = tid; q < Qcap; q += nt) {
    for (int r = 0; r < R; ++r) qdem[r * Qcap + q] = 0;
    qdur[q] = 1;
    qseq[q] = -1;
  }
  __syncthreads();

  // Block-uniform counters: every thread holds the same values.
  int q_cnt = 0, seq0 = 0, dropped = 0, n_trunc = 0;

  // Place queue entry q on server l (warp 0): the first empty slot of the
  // row takes its demand and departure slot t + dur.  Returns, in every
  // thread after the barrier, the slot used, or K when the row is full.
  auto place = [&](int l, int q, int t) {
    if (warp == 0) {
      int* drow = dep + static_cast<size_t>(l) * K;
      const int slot = warp_first_empty(drow, K);
      if (lane == 0) {
        bc_slot = slot;
        if (slot < K) {
          int* mrow = dem + (static_cast<size_t>(l) * K + slot) * R;
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int d = qdem[r * Qcap + q];
            mrow[r] = d;
            occ[l * R + r] += d;
          }
          const int dd = vqsk::add_wrap(t, qdur[q]);
          drow[slot] = dd;
          if (dd > t && dd < next_dep[l]) next_dep[l] = dd;
          qseq[q] = -1;
        }
      }
    }
    __syncthreads();
    const int slot = bc_slot;
    __syncthreads();
    return slot;
  };

  // Whether queue entry q fits server l.
  auto fits = [&](int q, int l) {
    bool ok = true;
#pragma unroll
    for (int r = 0; r < R; ++r) ok &= qdem[r * Qcap + q] <= caps.v[r] - occ[l * R + r];
    return ok;
  };

  for (int t = 0; t < T; ++t) {
    // 1. departures: scan a server's row only when its next departure is due
    int my_dep = 0;
    for (int l = tid; l < L; l += nt) {
      int c = 0;
      if (next_dep[l] == t) {
        int* drow = dep + static_cast<size_t>(l) * K;
        int* mrow = dem + static_cast<size_t>(l) * K * R;
        int out[R];
#pragma unroll
        for (int r = 0; r < R; ++r) out[r] = 0;
        int nd = kInfSlot;
        for (int k = 0; k < K; ++k) {
          const int dk = drow[k];
          if (dk == t) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
              out[r] += mrow[k * R + r];
              mrow[k * R + r] = 0;
            }
            drow[k] = kInfSlot;
            ++c;
          } else if (dk > t && dk < nd) {
            nd = dk;
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) occ[l * R + r] -= out[r];
        next_dep[l] = nd;
        my_dep += c;
      }
      freed[l] = c > 0;
    }
    for (int a = tid; a < A; a += nt) new_pos[a] = -1;
    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());

    // 2. arrivals: arrival a < A takes the a-th empty queue position.  Each
    // thread owns a contiguous chunk of the queue; a scan of the chunks'
    // empty counts gives each chunk its first rank.  Arrivals without a
    // position (or past the A lanes) are dropped; all take a seq id.
    const int n_t = n[t], n_lanes = min(n_t, A);
    int n_landed;
    {
      const int chunk = (Qcap + nt - 1) / nt;
      const int q0 = min(tid * chunk, Qcap), q1 = min(q0 + chunk, Qcap);
      int cnt = 0;
      for (int q = q0; q < q1; ++q) cnt += qseq[q] < 0;
      int n_empty;
      int rank = repro::block_exclusive_scan(cnt, redi, n_empty);
      for (int q = q0; q < q1 && rank < n_lanes; ++q) {
        if (qseq[q] >= 0) continue;
        const int a = rank++;
        const float* s_a = sizes + (static_cast<size_t>(t) * A + a) * R;
#pragma unroll
        for (int r = 0; r < R; ++r) qdem[r * Qcap + q] = vqsk::to_grid(s_a[r]);
        qdur[q] = durs[static_cast<size_t>(t) * D + D - A + a];
        qseq[q] = seq0 + a;
        new_pos[a] = q;
      }
      n_landed = min(n_lanes, n_empty);
      dropped += n_t - n_landed;
      q_cnt += n_landed;
      seq0 += n_t;
    }

    // the freed servers in ascending order, by the same chunked scan
    int n_freed;
    {
      const int chunk = (L + nt - 1) / nt;
      const int l0 = min(tid * chunk, L), l1 = min(l0 + chunk, L);
      int cnt = 0;
      for (int l = l0; l < l1; ++l) cnt += freed[l];
      int rank = repro::block_exclusive_scan(cnt, redi, n_freed);
      for (int l = l0; l < l1; ++l) {
        if (freed[l]) flist[rank++] = l;
      }
    }
    __syncthreads();

    // 3. BF-S: walk the freed servers; each takes its best fitting job
    // until none fits.  A K-full target ends the BF-S pass.
    int steps = 0;
    bool blocked = false;
    for (int fi = 0; fi < n_freed && steps < W && !blocked && q_cnt > 0;) {
      const int l = flist[fi];
      long long best = kKeyMin;
      int bq = kNone;
      for (int q = tid; q < Qcap; q += nt) {
        const int s = qseq[q];
        if (s < 0 || !fits(q, l)) continue;
        unsigned tot = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) tot += static_cast<unsigned>(qdem[r * Qcap + q]);
        // largest total demand, then lowest seq (seq >= 0 when queued)
        const long long key = static_cast<long long>(static_cast<int>(tot)) * (1LL << 32) +
                              (0x7fffffffLL - s);
        if (key > best) {
          best = key;
          bq = q;
        }
      }
      repro::block_arg64<false>(best, bq, redv, redi);
      if (bq >= Qcap) {
        ++fi;  // nothing fits this server for the rest of the slot
        continue;
      }
      ++steps;
      if (place(l, bq, t) < K) {
        --q_cnt;
      } else {
        ++n_trunc;
        blocked = true;
      }
    }

    // 4. BF-J: one attempt per landed arrival, in order
    int a_ptr = 0;
    for (; a_ptr < n_landed && steps < W; ++a_ptr) {
      ++steps;
      const int q = new_pos[a_ptr];
      if (qseq[q] < 0) continue;  // BF-S placed it
      int d[R];
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = qdem[r * Qcap + q];
      long long best = kKeyMax;
      int bl = kNone;
      for (int l = tid; l < L; l += nt) {
        bool feas = true;
        unsigned hi = 0, lo = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int av = caps.v[r] - occ[l * R + r];
          feas &= d[r] <= av;
          hi += static_cast<unsigned>(av) * static_cast<unsigned>(d[r] >> 8);
          lo += static_cast<unsigned>(av) * static_cast<unsigned>(d[r] & 255);
        }
        if (!feas) continue;
        const int lo_s = static_cast<int>(lo);
        const int s_hi = static_cast<int>(hi + static_cast<unsigned>(lo_s >> 8));
        const long long key = static_cast<long long>(s_hi) * 256 + (lo_s & 255);
        if (key < best) {
          best = key;
          bl = l;
        }
      }
      repro::block_arg64<true>(best, bl, redv, redi);
      if (bl >= L) continue;  // no feasible server
      if (place(bl, q, t) < K) {
        --q_cnt;
      } else {
        ++n_trunc;
      }
    }

    // saturation check, when the steps ran out: a fit on a freed, unblocked
    // server, or a queued arrival not yet tried that fits some server
    if (steps >= W) {
      int pend = 0;
      if (!blocked) {
        const long long pairs = static_cast<long long>(n_freed) * Qcap;
        for (long long i = tid; i < pairs && !pend; i += nt) {
          const int q = static_cast<int>(i % Qcap);
          pend = qseq[q] >= 0 && fits(q, flist[i / Qcap]);
        }
      }
      const long long pairs = static_cast<long long>(n_landed - a_ptr) * L;
      for (long long i = tid; i < pairs && !pend; i += nt) {
        const int q = new_pos[a_ptr + i / L];
        pend = qseq[q] >= 0 && fits(q, static_cast<int>(i % L));
      }
      n_trunc += repro::block_reduce(pend, redi, repro::MaxI());
    }

    // the slot's outputs: occupancy per resource as the float of the int32
    // grid sum over RES, queued jobs, departures
#pragma unroll
    for (int r = 0; r < R; ++r) {
      int my = 0;
      for (int l = tid; l < L; l += nt) my += occ[l * R + r];
      const int tot = repro::block_reduce(my, redi, repro::SumI());
      if (tid == 0) occ_out[static_cast<size_t>(t) * R + r] = __int2float_rn(tot) / 65536.f;
    }
    if (tid == 0) {
      qlen[t] = q_cnt;
      ndep_out[t] = n_dep;
    }
  }
  if (tid == 0) {
    dropped_out[g] = dropped;
    trunc_out[g] = n_trunc;
  }
}

template <int R>
int launch_r(const int* n, const float* sizes, const int* durs, int G, int T, int L, int K,
             int Qcap, int A, int D, int W, const Caps& caps, void* ws, int* qlen, float* occ,
             int* ndep, int* dropped, int* truncated, cudaStream_t stream) {
  const Layout lay = bfjs_mr_layout(L, K, Qcap, A, R);
  cudaError_t err = cudaFuncSetAttribute(bfjs_mr_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.shared_bytes));
  if (err != cudaSuccess) return err;
  bfjs_mr_kernel<R><<<G, kThreads, lay.shared_bytes, stream>>>(
      n, sizes, durs, T, L, K, Qcap, A, D, W, caps, static_cast<unsigned char*>(ws),
      lay.workspace_bytes, lay.queue_in_smem, qlen, occ, ndep, dropped, truncated);
  return cudaGetLastError();
}

}  // namespace

extern "C" size_t bfjs_mr_shared_bytes(int L, int K, int Qcap, int A, int R) {
  return bfjs_mr_layout(L, K, Qcap, A, R).shared_bytes + kStaticSmem;
}

extern "C" size_t bfjs_mr_workspace_bytes(int L, int K, int Qcap, int A, int R) {
  return bfjs_mr_layout(L, K, Qcap, A, R).workspace_bytes;
}

// caps: R per-resource capacities on the grid (host memory).  Returns the
// CUDA error of the launch; R outside 1..4 returns cudaErrorInvalidValue.
extern "C" int bfjs_mr_launch(const int* n, const float* sizes, const int* durs, int G, int T,
                              int L, int K, int R, int Qcap, int A, int D, int W, const int* caps,
                              void* ws, int* qlen, float* occ, int* ndep, int* dropped,
                              int* truncated, void* stream) {
  Caps c = {};
  for (int r = 0; r < R && r < kMaxR; ++r) c.v[r] = caps[r];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (R) {
    case 1:
      return launch_r<1>(n, sizes, durs, G, T, L, K, Qcap, A, D, W, c, ws, qlen, occ, ndep,
                         dropped, truncated, s);
    case 2:
      return launch_r<2>(n, sizes, durs, G, T, L, K, Qcap, A, D, W, c, ws, qlen, occ, ndep,
                         dropped, truncated, s);
    case 3:
      return launch_r<3>(n, sizes, durs, G, T, L, K, Qcap, A, D, W, c, ws, qlen, occ, ndep,
                         dropped, truncated, s);
    case 4:
      return launch_r<4>(n, sizes, durs, G, T, L, K, Qcap, A, D, W, c, ws, qlen, occ, ndep,
                         dropped, truncated, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
