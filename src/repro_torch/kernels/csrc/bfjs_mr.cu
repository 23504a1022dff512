// Fused multi-resource BF-J/S slot engine (paper Section VIII) on Hopper.
//
// Replaces the Pallas TPU kernel `_bfjs_mr_kernel`
// (src/repro/kernels/bfjs_mr/bfjs_mr.py).  One thread block simulates one
// member of the Monte-Carlo ensemble over the whole horizon, on the int32
// RES = 2^16 grid of the engines, with R resources (1 <= R <= 4, a template
// parameter).  Per slot: departures; up to A_max arrivals enter the first
// empty queue positions; then a work list of at most W steps: BF-S over the
// freed servers in ascending order — repeatedly the queued job with the
// largest total demand that fits (ties: lowest seq) — then BF-J over the
// landed arrivals in order — the feasible server with the lowest exact
// Tetris alignment score <demand, available> (ties: lowest index).  Each
// BF-S placement, each BF-S K-full block (which ends the BF-S pass and
// counts in `truncated`) and each BF-J attempt (placed, K-full, infeasible,
// or already taken by BF-S) is one step; a slot that ends with the steps
// spent while a fit or a feasible queued arrival remains adds 1 to
// `truncated`.  The trajectory is the one of the scan engine
// (repro_torch/core/engine/bfjs_mr.py, the plain version) on every field,
// occupancy included: all arithmetic is integer.  Placements only consume
// queue entries and only shrink availability, so a freed server with no
// fitting job has none for the rest of the slot, and the scan engine's
// choice at every step — the lowest freed server with a fit — is the
// current one of an ascending walk.
//
// The alignment score is computed as the JAX `alignment_score_pair_jnp`
// does — an int32 (hi, lo) pair against the split demand (d >> 8, d & 255),
// in wrapping 32-bit arithmetic — and ordered as the lexicographic pair
// (hi as a signed int, then lo, then the lowest index).  No float enters: a
// float mul+add may be contracted into an FMA, which flips tie-breaks.
//
// What bounds it: slot t+1 needs slot t and step s+1 needs step s, so the
// time is (slots) x (steps a slot) x (the latency of one step) — a latency
// chain, hundreds of times above the bytes it must move and its operations.
// The design keeps that chain short:
//   * A decision warp makes every BF-S and BF-J decision with warp-
//     synchronous reductions (`redux.sync` on 32-bit keys), so no block
//     barrier sits inside a step.  Lane i owns servers i, i + 32, ... and
//     queue positions i, i + 32, ...: per-lane bitmasks hold the queue's
//     occupied positions and the freed servers, so a BF-S test walks only
//     the queued jobs (about 20 at the path's shape, not Qcap), a BF-S key
//     (total demand, then seq) is two `redux` stages and a third for the
//     position, and arrivals land in the lowest empty positions with a
//     `warp_rank` per round of 32 positions.  The BF-S walk takes the freed
//     servers round by round (bit b of every lane's word) and, in a round,
//     in lane order; BF-J passes over the arrivals BF-S placed 32 at a
//     time, a step each.
//   * A freed server whose availability misses the queue's smallest demand
//     on some resource (taken per resource from the slot's queue; it only
//     grows as jobs leave) has no fit and costs no reduction.
//   * The BF-J scan over all L servers is the heaviest step (R products a
//     server).  It runs on a warpgroup: the decision warp posts the demand,
//     the three scan warps and it each reduce a quarter of the servers to a
//     64-bit key (order key of the score's hi word, lo & 255, index), and the
//     four meet on two named barriers.  (The decision warp alone took 8.6%
//     longer a slot at the path's shape.)
//   * Departures: a next-departure slot and a due-slot bitmask per row, so
//     only due rows and their due slots are touched; availability per
//     resource is kept per server and occupancy as a running integer total,
//     the same int32 value as the sum over servers.
//   * A stream warp keeps the streams and the bookkeeping off the chain: it
//     loads slot t+1's demand rows (`to_grid`) and durations into a double
//     buffer, and recomputes from the (L, K) departure slots in the device
//     workspace the next departure and due slots of every row that lost a
//     job, which the decision warp merges at the start of the next slot.
//     The decision and stream warps meet once a slot on a named barrier.
// At the path's shape a slot then takes ~34,800 cycles on the card for ~28
// steps: the BF-S tests and walk ~60%, the BF-J scans ~19%, departures
// ~12%, each a series of dependent shared-memory round trips and warp
// reductions.  The decision warp's loops with a run-time trip count are not
// unrolled (`#pragma unroll 1`): with few warps on the SM the smaller code
// ran faster on the card in the sibling kernels (bfjs, vqs_bf).  Shared memory
// holds per-server availability (padded to 1, 2 or 4 words for vector
// loads) and next departure slots, the masks and the stream buffers, then,
// as far as they fit, the row bookkeeping (occupied, due and recomputed
// bitmasks, recomputed departures), the queue (demand vectors, durations,
// seq ids) and the (L, K, R) demand plane — all of them at the path's shape
// (R = 2).  The rest, and the departure slots, live in the per-member
// workspace: the demand plane at R = 3 and 4, the queue at Qcap = 40000,
// the bookkeeping for clusters of thousands of servers.
#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"
#include "vqs_common.cuh"  // to_grid, add_wrap, bitmask words

namespace {

using vqsk::kInfSlot;
using vqsk::lane_words;
using vqsk::row_words;

constexpr int kScanWarps = 4;  // warps of the BF-J server scan, the decision warp one of them
constexpr int kThreads = 32 * (kScanWarps + 1);  // decision, stream, scan warps
constexpr int kPairThreads = 64;  // the decision and stream warps
constexpr int kSlotBarrier = 1;   // decision and stream warps, once a slot
constexpr int kDepartBarrier = 2; // decision warp arrives, stream warp waits
constexpr int kScanGo = 3;        // scan warps: a request is posted
constexpr int kScanDone = 4;      // scan warps: every part is reduced
constexpr int kMaxR = 4;
constexpr size_t kSmemLimit = 232448;  // dynamic + static, per block
constexpr size_t kStaticSmem = 128;    // the scan's request and results

struct Caps {
  int v[kMaxR];  // per-resource capacity on the grid, round(c * RES)
};

__host__ __device__ inline int vec_words(int R) { return R == 3 ? 4 : R; }
__host__ __device__ inline size_t r4(size_t x) { return (x + 3) / 4 * 4; }
// One slot's stream buffer: A demand vectors, then A durations and n.
__host__ __device__ inline size_t slot_words(int A, int R) {
  return r4(static_cast<size_t>(A) * vec_words(R)) + r4(A + 1);
}

// Word offsets of the shared arrays, byte offsets of the workspace arrays.
struct Carve {
  size_t avail, sbuf, qdem, dem, qdur, qseq, next_dep, book, masks, qmask, newpos, words;
  size_t w_dem, w_qdem, w_dep, w_qdur, w_qseq, w_book, w_bytes;
};

// b_s, q_s, d_s: the row bookkeeping (recomputed next departure; occupied,
// due and recomputed due bitmasks), the queue, the demand plane in shared
// memory.
__host__ __device__ inline Carve carve(int L, int K, int Qcap, int A, int R, bool b_s, bool q_s,
                                       bool d_s) {
  const size_t RP = vec_words(R), KW = row_words(K), NW = lane_words(L);
  const size_t QW = lane_words(Qcap), Ls = L, LK = Ls * K;
  Carve c;
  size_t o = 0;  // vector arrays first, each a multiple of 4 words
  c.avail = o; o += r4(Ls * RP);
  c.sbuf = o; o += 2 * slot_words(A, R);
  c.qdem = o; if (q_s) o += r4(static_cast<size_t>(Qcap) * RP);
  c.dem = o; if (d_s) o += r4(LK * RP);
  c.qdur = o; if (q_s) o += Qcap;
  c.qseq = o; if (q_s) o += Qcap;
  c.next_dep = o; o += Ls;
  const size_t book = Ls * (1 + 3 * KW);
  c.book = o; if (b_s) o += book;
  c.masks = o; o += 2 * 32 * NW;  // live, recf
  c.qmask = o; o += 32 * QW;
  c.newpos = o; o += A;
  c.words = o;
  size_t w = 0;
  c.w_dem = w; if (!d_s) w += 4 * r4(LK * RP);
  c.w_qdem = w; if (!q_s) w += 4 * r4(static_cast<size_t>(Qcap) * RP);
  c.w_dep = w; w += 4 * LK;
  c.w_qdur = w; if (!q_s) w += 4 * static_cast<size_t>(Qcap);
  c.w_qseq = w; if (!q_s) w += 4 * static_cast<size_t>(Qcap);
  c.w_book = w; if (!b_s) w += 4 * book;
  c.w_bytes = (w + 15) / 16 * 16;
  return c;
}

struct Layout {
  bool book_in_smem, queue_in_smem, dem_in_smem;
  size_t shared_bytes;     // dynamic shared memory of one block
  size_t workspace_bytes;  // device workspace of one member (16-aligned)
};

// The row bookkeeping joins the fixed part in shared memory when it fits
// (every shape short of thousands of servers or very long rows), then the
// queue, then the demand plane.
__host__ Layout bfjs_mr_layout(int L, int K, int Qcap, int A, int R) {
  Layout lay;
  auto fits = [&](bool b_s, bool q_s, bool d_s) {
    return 4 * carve(L, K, Qcap, A, R, b_s, q_s, d_s).words + kStaticSmem <= kSmemLimit;
  };
  lay.book_in_smem = fits(true, false, false);
  lay.queue_in_smem = fits(lay.book_in_smem, true, false);
  lay.dem_in_smem = fits(lay.book_in_smem, lay.queue_in_smem, true);
  const Carve c =
      carve(L, K, Qcap, A, R, lay.book_in_smem, lay.queue_in_smem, lay.dem_in_smem);
  lay.shared_bytes = 4 * c.words;
  lay.workspace_bytes = c.w_bytes;
  return lay;
}

template <int R>
__device__ __forceinline__ void load_vec(const int* p, int (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = p[0];
  } else if constexpr (R == 2) {
    const int2 x = *reinterpret_cast<const int2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    const int4 x = *reinterpret_cast<const int4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    if constexpr (R == 4) v[3] = x.w;
  }
}

template <int R>
__device__ __forceinline__ void store_vec(int* p, const int (&v)[R]) {
  if constexpr (R == 1) {
    p[0] = v[0];
  } else if constexpr (R == 2) {
    *reinterpret_cast<int2*>(p) = make_int2(v[0], v[1]);
  } else if constexpr (R == 3) {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], 0);
  } else {
    *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
  }
}

// Lowest key of the warp, a 64-bit key reduced as two 32-bit stages.
__device__ __forceinline__ unsigned long long warp_min64(unsigned long long k) {
  const unsigned hi = static_cast<unsigned>(k >> 32);
  const unsigned mh = __reduce_min_sync(repro::kFullMask, hi);
  const unsigned ml =
      __reduce_min_sync(repro::kFullMask, hi == mh ? static_cast<unsigned>(k) : 0xffffffffu);
  return (static_cast<unsigned long long>(mh) << 32) | ml;
}

constexpr unsigned long long kNoServer = ~0ull;  // no feasible server (index bits all set)

// BF-J key of the servers vt, vt + stride, ... < L that take demand d:
// (order key of the score's signed hi word, lo & 255, index), least first.
template <int R>
__device__ __forceinline__ unsigned long long scan_part(const int* avail, int L, const int (&d)[R],
                                                        int vt, int stride) {
  constexpr int RP = R == 3 ? 4 : R;
  unsigned dh[R], dl[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    dh[r] = static_cast<unsigned>(d[r] >> 8);
    dl[r] = static_cast<unsigned>(d[r] & 255);
  }
  unsigned long long best = kNoServer;
#pragma unroll 4
  for (int l = vt; l < L; l += stride) {
    int av[R];
    load_vec<R>(avail + l * RP, av);
    bool feas = true;
    unsigned hi = 0u, lo = 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      feas &= d[r] <= av[r];
      hi += static_cast<unsigned>(av[r]) * dh[r];
      lo += static_cast<unsigned>(av[r]) * dl[r];
    }
    const int lo_s = static_cast<int>(lo);
    const unsigned s_hi = hi + static_cast<unsigned>(lo_s >> 8);
    const unsigned long long key =
        (static_cast<unsigned long long>(s_hi ^ 0x80000000u) << 32) |
        (static_cast<unsigned>(lo_s & 255) << 24) | static_cast<unsigned>(l);
    if (feas && key < best) best = key;
  }
  return best;
}

template <int R, bool kFast>
__global__ void __launch_bounds__(kThreads, 1)
bfjs_mr_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
               const int* __restrict__ durs, int T, int L, int K, int Qcap, int A, int D,
               int W, Caps caps, unsigned char* __restrict__ ws, size_t ws_stride,
               int book_in_smem, int queue_in_smem, int dem_in_smem, int* __restrict__ qlen,
               float* __restrict__ occ_out, int* __restrict__ ndep_out,
               int* __restrict__ dropped_out, int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int scan_req[kMaxR + 1];  // the demand, then 1 = scan, 0 = quit
  __shared__ unsigned long long scan_res[kScanWarps];
  constexpr int RP = R == 3 ? 4 : R;
  const int KW = row_words(K), NW = lane_words(L), QW = lane_words(Qcap);
  const int SW = static_cast<int>(slot_words(A, R)), SZ = static_cast<int>(r4(A * RP));
  const bool b_s = kFast || book_in_smem, q_s = kFast || queue_in_smem;
  const bool d_s = kFast || dem_in_smem;
  const Carve c = carve(L, K, Qcap, A, R, b_s, q_s, d_s);
  const size_t g = blockIdx.x;
  unsigned char* wsg = ws + g * ws_stride;
  int* avail = smem + c.avail;  // (L, RP) capacity left per resource
  int* sbuf = smem + c.sbuf;    // 2 x SW stream words
  int* qdem = q_s ? smem + c.qdem : reinterpret_cast<int*>(wsg + c.w_qdem);  // (Qcap, RP)
  int* dem = d_s ? smem + c.dem : reinterpret_cast<int*>(wsg + c.w_dem);     // (L, K, RP)
  int* qdur = q_s ? smem + c.qdur : reinterpret_cast<int*>(wsg + c.w_qdur);
  int* qseq = q_s ? smem + c.qseq : reinterpret_cast<int*>(wsg + c.w_qseq);
  int* dep = reinterpret_cast<int*>(wsg + c.w_dep);  // (L, K) departure slots
  int* next_dep = smem + c.next_dep;
  int* rec_nd = b_s ? smem + c.book : reinterpret_cast<int*>(wsg + c.w_book);  // recomputed
  unsigned* occm = reinterpret_cast<unsigned*>(rec_nd + L);  // (L, KW) occupied slots
  unsigned* due = occm + static_cast<size_t>(L) * KW;        // slots leaving at next_dep
  unsigned* rec_mask = due + static_cast<size_t>(L) * KW;    // recomputed due slots
  unsigned* live = reinterpret_cast<unsigned*>(smem + c.masks);  // (NW, 32) freed servers
                                                                  // that may still take a job
  unsigned* recf = live + 32 * NW;   // rows whose next departure is recomputed
  unsigned* qmask = reinterpret_cast<unsigned*>(smem + c.qmask);  // (QW, 32) queued positions
  int* newpos = smem + c.newpos;    // queue position of each landed arrival

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  n += g * T;
  sizes += g * T * static_cast<size_t>(A) * R;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ_out += g * T * R;
  ndep_out += g * T;

  for (int l = tid; l < L; l += kThreads) {
#pragma unroll
    for (int r = 0; r < RP; ++r) avail[l * RP + r] = r < R ? caps.v[r] : 0;
    next_dep[l] = rec_nd[l] = kInfSlot;
  }
  for (int i = tid; i < L * KW; i += kThreads) occm[i] = due[i] = rec_mask[i] = 0u;
  for (int i = tid; i < 2 * 32 * NW; i += kThreads) live[i] = 0u;
  for (int i = tid; i < 32 * QW; i += kThreads) qmask[i] = 0u;
  __syncthreads();

  if (warp >= 2) {
    // ---- the scan warps: a part of each BF-J scan --------------------------
    const int vt = (warp - 1) * 32 + lane;
    for (;;) {
      repro::named_barrier(kScanGo, 32 * kScanWarps);
      if (!scan_req[kMaxR]) return;
      int d[R];
#pragma unroll
      for (int r = 0; r < R; ++r) d[r] = scan_req[r];
      const unsigned long long k = warp_min64(scan_part<R>(avail, L, d, vt, 32 * kScanWarps));
      if (lane == 0) scan_res[warp - 1] = k;
      repro::named_barrier(kScanDone, 32 * kScanWarps);
    }
  }

  if (warp == 1) {
    // ---- the stream and bookkeeping warp -----------------------------------
    // Slot u's demand vectors on the grid, the last A duration lanes, n[u].
    auto fetch = [&](int u) {
      int* b = sbuf + (u & 1) * SW;
      const float* su = sizes + static_cast<size_t>(u) * A * R;
      for (int i = lane; i < A * R; i += 32) {
        const int a = i / R;
        b[a * RP + i - a * R] = vqsk::to_grid(su[i]);
      }
      const int* du = durs + static_cast<size_t>(u) * D + D - A;
      for (int a = lane; a < A; a += 32) b[SZ + a] = du[a];
      if (lane == 0) b[SZ + A] = n[u];
    };
    if (T > 0) fetch(0);
    repro::named_barrier(kSlotBarrier, kPairThreads);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) fetch(t + 1);
      repro::named_barrier(kDepartBarrier, kPairThreads);
      vqsk::recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);
      repro::named_barrier(kSlotBarrier, kPairThreads);
    }
    return;
  }

  // ---- the decision warp ----------------------------------------------------
  repro::named_barrier(kSlotBarrier, kPairThreads);
  // Warp-uniform: counters, the seq counter, occupancy totals per resource.
  int q_cnt = 0, seq0 = 0, dropped = 0, n_trunc = 0;
  int occ_tot[R];
#pragma unroll
  for (int r = 0; r < R; ++r) occ_tot[r] = 0;

  // The BF-J scan: the lowest key over all servers (kNoServer if none).
  auto bfj_scan = [&](const int (&d)[R]) -> unsigned long long {
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) scan_req[r] = d[r];
      scan_req[kMaxR] = 1;
    }
    repro::named_barrier(kScanGo, 32 * kScanWarps);
    unsigned long long k = warp_min64(scan_part<R>(avail, L, d, lane, 32 * kScanWarps));
    repro::named_barrier(kScanDone, 32 * kScanWarps);
#pragma unroll
    for (int w = 1; w < kScanWarps; ++w) k = min(k, scan_res[w]);
    return k;
  };

  // The queued job that BF-S gives a server with availability av: the
  // largest total demand that fits, then the lowest seq; -1 if none fits.
  auto bfs_pick = [&](const int (&av)[R]) -> int {
    bool found = false;
    int bt = 0, bs = 0, bq = -1;
#pragma unroll 1
    for (int w = 0; w < QW; ++w) {
      for (unsigned m = qmask[w * 32 + lane]; m; m &= m - 1) {
        const int q = (w * 32 + __ffs(m) - 1) * 32 + lane;
        int d[R];
        load_vec<R>(qdem + q * RP, d);
        bool fit = true;
        unsigned tot = 0u;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          fit &= d[r] <= av[r];
          tot += static_cast<unsigned>(d[r]);
        }
        if (!fit) continue;
        const int s = qseq[q];
        if (!found || static_cast<int>(tot) > bt || (static_cast<int>(tot) == bt && s < bs)) {
          found = true;
          bt = static_cast<int>(tot);
          bs = s;
          bq = q;
        }
      }
    }
    if (!__any_sync(repro::kFullMask, found)) return -1;
    // largest total (as a signed int), then lowest seq (seq >= 0), then its position
    const unsigned tk = found ? static_cast<unsigned>(bt) ^ 0x80000000u : 0u;
    const unsigned mt = __reduce_max_sync(repro::kFullMask, tk);
    const bool cand = found && tk == mt;
    const unsigned ms =
        __reduce_min_sync(repro::kFullMask, cand ? static_cast<unsigned>(bs) : 0xffffffffu);
    return static_cast<int>(__reduce_min_sync(
        repro::kFullMask, cand && static_cast<unsigned>(bs) == ms ? static_cast<unsigned>(bq)
                                                                  : 0xffffffffu));
  };

  // Lowest live freed server (L if none).
  auto next_live = [&]() -> int {
    int cl = L;
#pragma unroll 1
    for (int w = 0; w < NW; ++w) {
      const unsigned m = live[w * 32 + lane];
      if (m) {
        cl = (w * 32 + __ffs(m) - 1) * 32 + lane;
        break;
      }
    }
    return __reduce_min_sync(repro::kFullMask, cl);
  };
  auto drop_live = [&](int s) {
    if (lane == (s & 31)) live[vqsk::mask_at(s)] &= ~vqsk::mask_bit(s);
    __syncwarp();
  };
  auto queued = [&](int q) { return (qmask[vqsk::mask_at(q)] & vqsk::mask_bit(q)) != 0u; };

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int* sb = sbuf + (t & 1) * SW;
    const int n_t = sb[SZ + A];

    // One queued job onto server s at its first empty slot (dep == INF;
    // a job due at INF keeps its slot empty, as in the engines).  Returns
    // false, placing nothing, when the row is full.
    auto place = [&](int s, int q, const int (&d)[R]) -> bool {
      const unsigned* om = occm + static_cast<size_t>(s) * KW;
      int k = K;
#pragma unroll 1
      for (int kw = 0; kw < KW; ++kw) {
        const int rest = K - 32 * kw;
        const unsigned open = ~om[kw] & (rest >= 32 ? 0xffffffffu : (1u << rest) - 1u);
        if (open) {
          k = 32 * kw + __ffs(open) - 1;
          break;
        }
      }
      if (k == K) return false;
      if (lane == 0) {
        const int dd = vqsk::add_wrap(t, qdur[q]);
        const size_t at = static_cast<size_t>(s) * K + k;
        store_vec<R>(dem + at * RP, d);
        dep[at] = dd;
        int av[R];
        load_vec<R>(avail + s * RP, av);
#pragma unroll
        for (int r = 0; r < R; ++r) av[r] -= d[r];
        store_vec<R>(avail + s * RP, av);
        const unsigned bit = 1u << (k & 31);
        if (dd != kInfSlot) {
          occm[static_cast<size_t>(s) * KW + k / 32] |= bit;
          if (dd > t) {
            unsigned* dm = due + static_cast<size_t>(s) * KW;
            const int nd = next_dep[s];
            if (dd < nd) {
              next_dep[s] = dd;
#pragma unroll 1
              for (int kw = 0; kw < KW; ++kw) dm[kw] = kw == k / 32 ? bit : 0u;
            } else if (dd == nd) {
              dm[k / 32] |= bit;
            }
          }
        }
        qmask[vqsk::mask_at(q)] &= ~vqsk::mask_bit(q);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) occ_tot[r] += d[r];
      --q_cnt;
      __syncwarp();
      return true;
    };

    // 0. the next departures the stream warp recomputed for last slot's rows
    vqsk::merge_departures(recf, rec_nd, rec_mask, next_dep, due, NW, KW);

    // 1. departures: only due rows and their due slots; the lanes walk their
    // due rows together
    int my_dep = 0;
    int out[R];
#pragma unroll
    for (int r = 0; r < R; ++r) out[r] = 0;
    bool any_freed = false;
#pragma unroll 1
    for (int w = 0; w < NW; ++w) {
      unsigned dm = 0u, fr = 0u, rm = 0u;
#pragma unroll 8
      for (int b = 0; b < 32; ++b) {
        const int l = (w * 32 + b) * 32 + lane;
        if (l < L && next_dep[l] == t) dm |= 1u << b;
      }
      while (dm) {
        const int b = __ffs(dm) - 1;
        dm &= dm - 1;
        const int l = (w * 32 + b) * 32 + lane;
        unsigned* om = occm + static_cast<size_t>(l) * KW;
        unsigned* lv = due + static_cast<size_t>(l) * KW;
        unsigned* keep = rec_mask + static_cast<size_t>(l) * KW;
        int o[R];
#pragma unroll
        for (int r = 0; r < R; ++r) o[r] = 0;
        int cnt = 0;
        bool kept = false;
#pragma unroll 1
        for (int kw = 0; kw < KW; ++kw) {
          const unsigned leave = lv[kw], left = om[kw] & ~leave;
          for (unsigned x = leave; x; x &= x - 1) {
            int d[R];
            load_vec<R>(dem + (static_cast<size_t>(l) * K + kw * 32 + __ffs(x) - 1) * RP, d);
#pragma unroll
            for (int r = 0; r < R; ++r) o[r] += d[r];
            ++cnt;
          }
          om[kw] = left;
          keep[kw] = left;
          lv[kw] = 0u;
          kept = kept || left != 0u;
        }
        int av[R];
        load_vec<R>(avail + l * RP, av);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          av[r] += o[r];
          out[r] += o[r];
        }
        store_vec<R>(avail + l * RP, av);
        next_dep[l] = kInfSlot;
        my_dep += cnt;
        if (kept) rm |= 1u << b;
        if (cnt) fr |= 1u << b;
      }
      live[w * 32 + lane] = fr;
      recf[w * 32 + lane] = rm;
      any_freed = any_freed || fr != 0u;
    }
    const int n_dep = __reduce_add_sync(repro::kFullMask, my_dep);
#pragma unroll
    for (int r = 0; r < R; ++r) occ_tot[r] -= __reduce_add_sync(repro::kFullMask, out[r]);
    any_freed = __any_sync(repro::kFullMask, any_freed);
    // the rows that lost jobs are ready for the stream warp
    asm volatile("bar.arrive %0, %1;" ::"r"(kDepartBarrier), "r"(kPairThreads) : "memory");

    // 2. arrivals take the lowest empty queue positions, a round of 32 at a
    // time (position = 32 * round + lane); the rest are dropped
    const int want = min(n_t, A);
    int n_landed = 0;
    if (want > 0) {
      int base = 0;
#pragma unroll 1
      for (int w = 0; w < QW && base < want; ++w) {
        unsigned qw = qmask[w * 32 + lane];
        const int r0 = w * 32;  // first round of the word
        const int rounds = min(32, (Qcap + 31) / 32 - r0);
        unsigned open = ~__reduce_and_sync(repro::kFullMask, qw);
        if (rounds < 32) open &= (1u << rounds) - 1u;
        while (open && base < want) {
          const int b = __ffs(open) - 1;
          open &= open - 1;
          const int q = (r0 + b) * 32 + lane;
          const bool empty = q < Qcap && !((qw >> b) & 1u);
          int cnt;
          const int r = base + repro::warp_rank(empty, cnt);
          if (empty && r < want) {
            int d[R];
            load_vec<R>(sb + r * RP, d);
            store_vec<R>(qdem + q * RP, d);
            qdur[q] = sb[SZ + r];
            qseq[q] = seq0 + r;
            newpos[r] = q;
            qw |= 1u << b;
          }
          base += cnt;
        }
        qmask[w * 32 + lane] = qw;
      }
      n_landed = min(want, base);
      __syncwarp();
    }
    dropped += n_t - n_landed;
    q_cnt += n_landed;
    seq0 += n_t;

    // 3. BF-S: walk the freed servers in ascending order; each takes its
    // best fitting job until none fits.  A K-full target ends the BF-S pass.
    int steps = 0;
    bool blocked = false;
    int qmin[R];  // smallest queued demand per resource, as of this point
    if (any_freed && q_cnt > 0) {
      int m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) m[r] = 0x7fffffff;
#pragma unroll 1
      for (int w = 0; w < QW; ++w) {
        for (unsigned x = qmask[w * 32 + lane]; x; x &= x - 1) {
          int d[R];
          load_vec<R>(qdem + ((w * 32 + __ffs(x) - 1) * 32 + lane) * RP, d);
#pragma unroll
          for (int r = 0; r < R; ++r) m[r] = min(m[r], d[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) qmin[r] = __reduce_min_sync(repro::kFullMask, m[r]);
      // freed servers below a smallest demand have no fit for the slot
#pragma unroll 1
      for (int w = 0; w < NW; ++w) {
        unsigned lw = live[w * 32 + lane];
        for (unsigned x = lw; x; x &= x - 1) {
          const int b = __ffs(x) - 1;
          int av[R];
          load_vec<R>(avail + ((w * 32 + b) * 32 + lane) * RP, av);
          bool ok = true;
#pragma unroll
          for (int r = 0; r < R; ++r) ok &= av[r] >= qmin[r];
          if (!ok) lw &= ~(1u << b);
        }
        live[w * 32 + lane] = lw;
      }
      // the walk: rounds of 32 servers in index order, each round's live
      // servers in lane order; a server leaves `live` once nothing fits it
      bool stop = false;
#pragma unroll 1
      for (int w = 0; w < NW && !stop; ++w) {
        unsigned lw = live[w * 32 + lane];
        unsigned rounds = __reduce_or_sync(repro::kFullMask, lw);
        while (rounds && !stop) {
          const int b = __ffs(rounds) - 1;
          rounds &= rounds - 1;
          unsigned lanes = __ballot_sync(repro::kFullMask, (lw >> b) & 1u);
          while (lanes && !stop) {
            const int ln = __ffs(lanes) - 1;
            lanes &= lanes - 1;
            const int cur = (w * 32 + b) * 32 + ln;
#pragma unroll 1
            for (;;) {
              if (steps >= W || blocked || q_cnt == 0) {
                stop = true;
                break;
              }
              int av[R];
              load_vec<R>(avail + cur * RP, av);
              bool ok = true;
#pragma unroll
              for (int r = 0; r < R; ++r) ok &= av[r] >= qmin[r];
              const int q = ok ? bfs_pick(av) : -1;
              if (q < 0) {  // nothing fits this server for the rest of the slot
                if (lane == ln) lw &= ~(1u << b);
                break;
              }
              ++steps;
              int d[R];
              load_vec<R>(qdem + q * RP, d);
              if (!place(cur, q, d)) {
                ++n_trunc;
                blocked = true;
              }
            }
          }
        }
        live[w * 32 + lane] = lw;
      }
      __syncwarp();
    }

    // 4. BF-J: one attempt — one step — per landed arrival, in order; the
    // arrivals BF-S placed are passed over 32 at a time, a step each
    int a_ptr = 0;
#pragma unroll 1
    for (int a0 = 0; a0 < n_landed && steps < W; a0 += 32) {
      unsigned todo = __ballot_sync(repro::kFullMask,
                                    a0 + lane < n_landed && queued(newpos[a0 + lane]));
#pragma unroll 1
      while (todo && steps < W) {
        const int a = a0 + __ffs(todo) - 1;
        todo &= todo - 1;
        if (steps + a - a_ptr >= W) {  // the steps run out on placed arrivals
          a_ptr += W - steps;
          steps = W;
          break;
        }
        steps += a - a_ptr + 1;
        a_ptr = a + 1;
        const int q = newpos[a];
        int d[R];
        load_vec<R>(qdem + q * RP, d);
        const unsigned long long k = bfj_scan(d);
        if (static_cast<unsigned>(k) == 0xffffffffu) continue;  // no feasible server
        if (!place(static_cast<int>(k & 0xffffffu), q, d)) ++n_trunc;
      }
      const int pass = min(min(n_landed, a0 + 32) - a_ptr, W - steps);  // placed ones left
      if (pass > 0) {
        steps += pass;
        a_ptr += pass;
      }
    }

    // saturation check, when the steps ran out: a fit on a freed server not
    // yet exhausted (the BF-S pass unblocked), or a queued arrival not yet
    // tried that fits some server
    if (steps >= W) {
      bool pend = false;
      if (!blocked && q_cnt > 0 && any_freed) {
#pragma unroll 1
        for (int s = next_live(); s < L && !pend; s = next_live()) {
          int av[R];
          load_vec<R>(avail + s * RP, av);
          pend = bfs_pick(av) >= 0;
          drop_live(s);
        }
      }
#pragma unroll 1
      for (int a = a_ptr; a < n_landed && !pend; ++a) {
        const int q = newpos[a];
        if (!queued(q)) continue;
        int d[R];
        load_vec<R>(qdem + q * RP, d);
        pend = static_cast<unsigned>(warp_min64(scan_part<R>(avail, L, d, lane, 32))) !=
               0xffffffffu;
      }
      n_trunc += pend ? 1 : 0;
    }

    // the slot's outputs: occupancy per resource as the float of the int32
    // grid sum over RES, queued jobs, departures
    int my_occ = occ_tot[0];
#pragma unroll
    for (int r = 1; r < R; ++r) my_occ = lane == r ? occ_tot[r] : my_occ;
    if (lane < R) occ_out[static_cast<size_t>(t) * R + lane] = __int2float_rn(my_occ) / 65536.f;
    if (lane == 0) {
      qlen[t] = q_cnt;
      ndep_out[t] = n_dep;
    }
    repro::named_barrier(kSlotBarrier, kPairThreads);
  }
  if (lane == 0) {
    dropped_out[g] = dropped;
    trunc_out[g] = n_trunc;
  }
  if (lane == 0) scan_req[kMaxR] = 0;  // the scan warps leave
  repro::named_barrier(kScanGo, 32 * kScanWarps);
}

template <int R>
int launch_r(const int* n, const float* sizes, const int* durs, int G, int T, int L, int K,
             int Qcap, int A, int D, int W, const Caps& caps, void* ws, int* qlen, float* occ,
             int* ndep, int* dropped, int* truncated, cudaStream_t stream) {
  const Layout lay = bfjs_mr_layout(L, K, Qcap, A, R);
  auto kernel = lay.book_in_smem && lay.queue_in_smem && lay.dem_in_smem
                    ? bfjs_mr_kernel<R, true>
                    : bfjs_mr_kernel<R, false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.shared_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<G, kThreads, lay.shared_bytes, stream>>>(
      n, sizes, durs, T, L, K, Qcap, A, D, W, caps, static_cast<unsigned char*>(ws),
      lay.workspace_bytes, lay.book_in_smem, lay.queue_in_smem, lay.dem_in_smem, qlen, occ, ndep,
      dropped, truncated);
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
