// Fused VQS slot engine (paper Section V) on Hopper.
//
// Replaces the Pallas TPU kernel `_vqs_kernel`
// (src/repro/kernels/vqs/vqs.py).  One thread block simulates one member of
// the Monte-Carlo ensemble over the whole horizon.  Per slot: departures;
// classification of up to A_max arrivals into 2J virtual-queue rings on the
// int32 RES grid; the visit set (freed servers, woken subscribers, empty
// servers while work is queued); a work list of at most W+1 steps, each of
// which advances past every pending server that cannot place (renewing its
// configuration to the shared max-weight row of K_RED at first touch,
// granting _empty membership at first touch, writing its subscriptions) and
// serves the first server that can: one reserved VQ_1 job, or a prefix-fit
// batch of up to `drain` head-of-VQ_{j*} jobs.  It takes every J the grid
// allows (2 <= J <= 16: the 2J queues fit a 32-bit mask) and any drain.  The
// trajectory is the one of the scan engine (repro_torch/core/engine/vqs.py,
// the plain version) on every field, occupancy included: all arithmetic is
// integer.
//
// What bounds it: a latency chain — slot t+1 needs slot t and step s+1 needs
// step s — far above its bytes (counts, arrival sizes and durations in;
// three (G, T) trajectories out) and its operations.  The design keeps the
// chain short:
//   * A decision warp makes every decision with warp-synchronous
//     reductions, so no block barrier sits inside a step.  Lane i owns
//     servers i, i + 32, ...; the pending set (visited, not yet advanced),
//     the _empty set and each type's subscribers are per-lane bitmasks.
//   * One walk a step finds the placer and advances past the servers below
//     it: rounds of 32 consecutive servers (bit b of every lane's word) are
//     taken in index order, only rounds that hold a pending server; in a
//     round each lane tests its server and a ballot gives the lowest that
//     can place.  Every pending server below it is touched and advanced in
//     the same pass (the renewal candidate, the non-empty queues and the
//     ring heads do not change until the serve).  VQS's "can place" follows
//     the renewed configuration, which follows the max-weight row of the
//     current queue counts, so a server above the placer is tested again
//     each step; only advanced servers leave the pending set, and a walk
//     starts at the placer's round.  When no queue holds a job no server
//     can place, and each lane advances its own pending servers without the
//     rounds.  A server gets jobs only as a placer, which keeps them for the
//     slot: so a pending server renews, and joins _empty, iff it is empty,
//     and no per-server flags are built at the visit.
//   * Bookkeeping moves off the steps: the max-weight row's weights are kept
//     per lane and moved by every change of a queue count (K_RED rows
//     decoded once); queue counts and heads live in lanes, the ring heads'
//     sizes in a small shared array; occupancy is a running integer total.
//   * The job planes leave device memory: a packed (L, K) plane of effective
//     size and type (eff | vq << 17) in shared memory when it fits, per-row
//     occupied and due-slot bitmasks, and the next departure slot per row,
//     so departures read only the due slots.  The departure slots live in a
//     per-member device workspace, written at placement and read only by
//     the second warp.
//   * A second warp loads and classifies slot t+1's arrivals (type,
//     effective size, duration, rank within the type, counts per type) into
//     a double buffer while the decision warp runs slot t, so landing needs
//     no O(A^2) loop, and, once the decision warp has taken slot t's
//     departures (it signals on a named barrier), recomputes the next
//     departure and due slots of every row that lost a job.  The two warps
//     meet once a slot on another named barrier.
// At the vqs path's shape a slot still costs ~43,500 cycles on the card for
// ~12.5 steps: the walk ~46% (each round a few dependent shared-memory round
// trips and a ballot on one warp), the serves ~33%.  The serve's prefix fit is
// warp-level, 32 ring entries at a time.  The decision warp's loops with a
// run-time trip count are not unrolled (`#pragma unroll 1`): with one warp
// on the SM the smaller code ran faster in the sibling kernels.  Shared
// memory holds the K_RED table, per-server aggregates (occupancy and VQ_1
// occupancy, next departure, configuration), the masks, the arrival
// buffers, then the row bookkeeping (bitmasks, recomputed departures), the
// rings and the packed job plane as far as they fit; the rest moves to the
// workspace (J = 7, Qcap = 4096 puts the rings there; clusters of thousands
// of servers the bookkeeping too).  It takes every J the grid allows
// (2 <= J <= 16) and any drain.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "vqs_common.cuh"

namespace {

using namespace vqsk;

constexpr int kVqsThreads = 64;    // warp 0 decides, warp 1 streams and books
constexpr int kSlotBarrier = 1;    // both warps, once a slot
constexpr int kDepartBarrier = 2;  // decision warp arrives, stream warp waits
constexpr int kJsShift = 16;       // a server's word: kK1 | kHasCfg, then its j* + 1
constexpr int kBig = 1 << 30;      // the head size of an empty ring: fits nothing

struct VqsLayout {
  bool book_in_smem, rings_in_smem, jobs_in_smem;
  size_t shared_bytes;     // dynamic shared memory of one block
  size_t workspace_bytes;  // device workspace of one member (16-aligned)
};

// Words of the core: the K_RED table, per-server aggregates, the masks, the
// per-queue words and the arrival buffers; and of the per-row bookkeeping
// (recomputed next departure; occupied, due and recomputed due bitmasks).
__host__ __device__ inline size_t core_words(int J, int L, int A) {
  const size_t nvq = 2 * J, C = 4 * J - 4, NW = lane_words(L);
  return C * nvq + C + 4 * static_cast<size_t>(L) + (3 + nvq) * 32 * NW + 2 * nvq + 32 +
         2 * arrival_words(A, nvq);
}
__host__ __device__ inline size_t book_words(int L, int K) {
  return static_cast<size_t>(L) * (1 + 3 * row_words(K));
}

// The core always sits in shared memory; the row bookkeeping joins it when
// it fits (every shape short of thousands of servers), then the rings, then
// the packed job plane.  The workspace holds the departure slots, then
// whatever did not fit, in that order.
__host__ VqsLayout vqs_layout(int J, int L, int K, int Qcap, int A) {
  const size_t rings = 4 * static_cast<size_t>(J) * Qcap, jobs = static_cast<size_t>(L) * K;
  const size_t book = book_words(L, K);
  size_t words = core_words(J, L, A);
  auto fits = [&](size_t more) { return 4 * (words + more) + kStaticSmem <= kSmemLimit; };
  VqsLayout lay;
  lay.book_in_smem = fits(book);
  if (lay.book_in_smem) words += book;
  lay.rings_in_smem = lay.book_in_smem && fits(rings);
  if (lay.rings_in_smem) words += rings;
  lay.jobs_in_smem = lay.book_in_smem && fits(jobs);
  if (lay.jobs_in_smem) words += jobs;
  lay.shared_bytes = 4 * words;
  const size_t ws = 4 * (jobs + (lay.book_in_smem ? 0 : book) + (lay.rings_in_smem ? 0 : rings) +
                         (lay.jobs_in_smem ? 0 : jobs));
  lay.workspace_bytes = (ws + 15) / 16 * 16;
  return lay;
}

// Where the bookkeeping, the rings and the packed job plane live are
// template arguments, so the compiler addresses them as shared memory when
// they are.
template <bool kBookInSmem, bool kRingsInSmem, bool kJobsInSmem>
__global__ void __launch_bounds__(kVqsThreads, 1)
vqs_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
           const int* __restrict__ durs, const int* __restrict__ confs_in, int T, int J, int L,
           int K, int Qcap, int A, int D, int W, int P, unsigned char* __restrict__ ws,
           size_t ws_stride, int* __restrict__ qlen, float* __restrict__ occ_out,
           int* __restrict__ ndep_out, int* __restrict__ dropped_out,
           int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) int smem[];
  const int nvq = 2 * J, C = 4 * J - 4, KW = row_words(K), NW = lane_words(L);
  const int AB = arrival_words(A, nvq);
  int* confs = smem;                // (C, 2J) K_RED
  int* rowcfg = confs + C * nvq;    // (C) K_RED rows decoded
  // per server: resident effective size and that of VQ_1 jobs (C is a
  // multiple of 4, so the pairs are 8-byte aligned)
  int2* occ2 = reinterpret_cast<int2*>(rowcfg + C);
  int* next_dep = reinterpret_cast<int*>(occ2 + L);
  int* fj = next_dep + L;           // kK1 | kHasCfg | (configured j* + 1) << kJsShift
  unsigned* pend = reinterpret_cast<unsigned*>(fj + L);  // (NW, 32) pending servers
  unsigned* recf = pend + 32 * NW;  // (NW, 32) rows whose next departure is recomputed
  unsigned* inem = recf + 32 * NW;  // (NW, 32) members of the scheduler's _empty set
  unsigned* subs = inem + 32 * NW;  // (2J, NW, 32) subscribers of each type
  // per queue (2J each): where this slot's arrivals start (head + count), ...
  int* tailb = reinterpret_cast<int*>(subs + nvq * 32 * NW);
  int* found = tailb + nvq;         // this slot's arrivals that found a place
  int* heff = found + nvq;          // (32) size at the head of each ring, kBig if empty
  int* abuf = heff + 32;            // 2 x slot buffers of classified arrivals

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;
  const size_t ring_words = static_cast<size_t>(nvq) * Qcap;
  const size_t LK = static_cast<size_t>(L) * K;
  // the rest in the layout's order: shared memory after the core, the
  // workspace after the (L, K) departure slots
  int* sp = smem + core_words(J, L, A);
  int* dep = reinterpret_cast<int*>(ws + g * ws_stride);
  int* wp = dep + LK;
  int *rec_nd, *ring_eff, *job;
  if constexpr (kBookInSmem) {
    rec_nd = sp;
    sp += book_words(L, K);
  } else {
    rec_nd = wp;
    wp += book_words(L, K);
  }
  if constexpr (kRingsInSmem) {
    ring_eff = sp;
    sp += 2 * ring_words;
  } else {
    ring_eff = wp;
    wp += 2 * ring_words;
  }
  job = kJobsInSmem ? sp : wp;  // (L, K) packed size and type
  unsigned* occm = reinterpret_cast<unsigned*>(rec_nd + L);  // (L, KW) occupied slots
  unsigned* due = occm + static_cast<size_t>(L) * KW;        // slots leaving at next_dep
  unsigned* rec_mask = due + static_cast<size_t>(L) * KW;    // recomputed due slots
  int* ring_dur = ring_eff + ring_words;
  n += g * T;
  sizes += g * T * A;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ_out += g * T;
  ndep_out += g * T;

  for (int i = tid; i < C * nvq; i += kVqsThreads) confs[i] = confs_in[i];
  for (int c = tid; c < C; c += kVqsThreads) rowcfg[c] = decode_row(confs_in + c * nvq, nvq);
  for (int l = tid; l < L; l += kVqsThreads) {
    next_dep[l] = rec_nd[l] = kInfSlot;
    occ2[l] = make_int2(0, 0);
    fj[l] = 0;  // no flags, j* = -1
  }
  for (size_t i = tid; i < static_cast<size_t>(L) * KW; i += kVqsThreads) {
    occm[i] = due[i] = rec_mask[i] = 0u;
  }
  for (int i = tid; i < 32 * NW; i += kVqsThreads) {
    pend[i] = recf[i] = 0u;
    unsigned all = 0u;  // all servers start in _empty
    for (int bit = 0; bit < 32; ++bit) {
      if (((i / 32) * 32 + bit) * 32 + i % 32 < L) all |= 1u << bit;
    }
    inem[i] = all;
  }
  for (int i = tid; i < nvq * 32 * NW; i += kVqsThreads) subs[i] = 0u;
  for (int j = tid; j < 32; j += kVqsThreads) heff[j] = kBig;
  __syncthreads();

  if (warp == 1) {
    // ---- the stream and bookkeeping warp --------------------------------
    auto load_slot = [&](int u) {
      classify_slot(abuf + (u & 1) * AB, n[u], sizes + static_cast<size_t>(u) * A,
                    durs + static_cast<size_t>(u) * D, A, D, J);
    };
    if (T > 0) load_slot(0);
    repro::named_barrier(kSlotBarrier, kVqsThreads);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) load_slot(t + 1);
      repro::named_barrier(kDepartBarrier, kVqsThreads);
      recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);
      repro::named_barrier(kSlotBarrier, kVqsThreads);
    }
    return;
  }

  // ---- the decision warp -------------------------------------------------
  repro::named_barrier(kSlotBarrier, kVqsThreads);
  // Warp-uniform: counters, the running occupancy and queue totals; lane j
  // keeps the count and the head (modulo Qcap) of ring j, and every lane the
  // max-weight weights of K_RED rows `lane` and `lane + 32`.
  int dropped = 0, n_trunc = 0, q_tot = 0;
  unsigned occ_tot = 0u;
  MaxWeight mw;
  int qcnt = 0, hd = 0;
  const unsigned lanes_below = (1u << lane) - 1u;

  // lane j: the size at the head of ring j
  auto refresh_head = [&]() {
    if (lane < nvq) heff[lane] = qcnt > 0 ? ring_eff[static_cast<size_t>(lane) * Qcap + hd] : kBig;
  };

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int* b = abuf + (t & 1) * AB;
    const int *bvq = b, *beff = b + A, *bdur = b + 2 * A, *brank = b + 3 * A;
    const int* bcnt = b + 4 * A;

    // 0. the next departures the stream warp recomputed for last slot's rows
    merge_departures(recf, rec_nd, rec_mask, next_dep, due, NW, KW);

    // 1. arrivals: the r-th arrival of type j goes to ring j's tail + r
    // while the ring has room; the rest are dropped
    const int c_j = lane < nvq ? bcnt[lane] : 0;
    const unsigned arrived = __ballot_sync(repro::kFullMask, c_j > 0);
    const int f_j = min(c_j, Qcap - qcnt);
    if (lane < nvq) {
      found[lane] = f_j;
      tailb[lane] = hd + qcnt;
    }
    dropped += __reduce_add_sync(repro::kFullMask, c_j - f_j);
    q_tot += __reduce_add_sync(repro::kFullMask, f_j);
    qcnt += f_j;
    for (unsigned m = arrived; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      mw.move(confs, C, nvq, j, __shfl_sync(repro::kFullMask, f_j, j));
    }
    __syncwarp();
#pragma unroll 1
    for (int a = lane; a < A; a += 32) {
      const int v = bvq[a];
      if (v >= 0 && brank[a] < found[v]) {
        const size_t at = static_cast<size_t>(v) * Qcap + (tailb[v] + brank[a]) % Qcap;
        ring_eff[at] = beff[a];
        ring_dur[at] = bdur[a];
      }
    }
    __syncwarp();
    refresh_head();

    // 2. departures (only the due slots; the lanes walk their due rows
    // together), then the visit set — freed servers, subscribers woken by
    // an arrived type (those subscriptions are consumed), and _empty members
    // while work is queued.  A visited server renews its configuration at
    // first touch when it is empty or has none.  A server gets jobs only as
    // a placer, which keeps them for the slot, and a placer is touched: so a
    // pending server is untouched and renews iff it is empty (it has a
    // configuration iff it holds a job), and only an empty one joins _empty
    // at first touch.
    int my_dep = 0, my_pend = 0;
    unsigned my_out = 0u;
#pragma unroll 1
    for (int w = 0; w < NW; ++w) {
      unsigned dm = 0u, fr = 0u, rm = 0u;
#pragma unroll 8
      for (int bit = 0; bit < 32; ++bit) {
        const int l = (w * 32 + bit) * 32 + lane;
        if (l < L && next_dep[l] == t) dm |= 1u << bit;
      }
      while (dm) {
        const int bit = __ffs(dm) - 1;
        dm &= dm - 1;
        const int l = (w * 32 + bit) * 32 + lane;
        unsigned* om = occm + static_cast<size_t>(l) * KW;
        unsigned* lv = due + static_cast<size_t>(l) * KW;
        unsigned* keep = rec_mask + static_cast<size_t>(l) * KW;
        int out = 0, out1 = 0, c = 0;
        bool kept = false;
#pragma unroll 1
        for (int kw = 0; kw < KW; ++kw) {
          const unsigned leave = lv[kw], left = om[kw] & ~leave;
          for (unsigned x = leave; x; x &= x - 1) {
            const int p = job[static_cast<size_t>(l) * K + kw * 32 + __ffs(x) - 1];
            const int e = p & kEffMask;
            out += e;
            if ((p >> kEffBits) == 1) out1 += e;
            ++c;
          }
          om[kw] = left;
          keep[kw] = left;
          lv[kw] = 0u;
          kept = kept || left != 0u;
        }
        const int2 oo = occ2[l];
        occ2[l] = make_int2(oo.x - out, oo.y - out1);
        next_dep[l] = kInfSlot;
        my_out += static_cast<unsigned>(out);
        my_dep += c;
        if (kept) rm |= 1u << bit;
        if (c) fr |= 1u << bit;
      }
      unsigned woken = 0u;
      for (unsigned m = arrived; m; m &= m - 1) {
        unsigned* sj = subs + (__ffs(m) - 1) * 32 * NW + w * 32 + lane;
        woken |= *sj;
        *sj = 0u;
      }
      const unsigned pm = fr | woken | (q_tot > 0 ? inem[w * 32 + lane] : 0u);
      pend[w * 32 + lane] = pm;
      recf[w * 32 + lane] = rm;
      my_pend += __popc(pm);
    }
    const int n_dep = __reduce_add_sync(repro::kFullMask, my_dep);
    occ_tot -= __reduce_add_sync(repro::kFullMask, my_out);
    int n_pend = __reduce_add_sync(repro::kFullMask, my_pend);
    // the rows that lost jobs are ready for the stream warp
    asm volatile("bar.arrive %0, %1;" ::"r"(kDepartBarrier), "r"(kVqsThreads) : "memory");
    __syncwarp();

    // 3. work list: at most W+1 steps, stopping once nothing is pending
    bool done = false;
#pragma unroll 1
    for (int step = 0; step <= W; ++step) {
      if (n_pend == 0) {
        done = true;
        break;
      }
      // the renewal candidate (the first max-weight row of the current queue
      // counts), the non-empty queues and the ring heads: fixed until the
      // serve
      const unsigned hx = __ballot_sync(repro::kFullMask, qcnt > 0);
      const int rc = rowcfg[mw.best(C)];
      const int r_k1 = rc & 1, r_js = ((rc >> 1) & 63) - 1;
      const bool q1 = (hx >> 1) & 1u;
      const int he1 = heff[1];
      // the walk: rounds of pending servers in index order; in each, the
      // lowest server that can place is the placer, and the pending ones
      // below it are touched and advanced
      int placer = L, p_k1 = 0, p_js = -1, p_budget = 0, adv = 0;
#pragma unroll 1
      for (int w = 0; w < NW && placer == L; ++w) {
        unsigned pw = pend[w * 32 + lane];
        unsigned ie = 0u, s1 = 0u, sr = 0u;  // new _empty members, subscribers to 1 and r_js
        // the lane's pending server l at `bit`, in its effective configuration
        // (an empty one renews to the candidate and joins _empty); unless it
        // is the placer, it is advanced and subscribes to the types it waits
        // for
        auto touch = [&](int bit, int l, bool empty, int k1, int js, bool has1, bool advance) {
          if (empty) {
            fj[l] = r_k1 * kK1 | kHasCfg | (r_js + 1) << kJsShift;
            ie |= 1u << bit;
          }
          if (advance) {
            pw &= ~(1u << bit);
            ++adv;
            if (k1 && !has1 && !q1) s1 |= 1u << bit;
            if (js >= 0 && !((hx >> js) & 1u)) {
              if (js == r_js) {
                sr |= 1u << bit;
              } else {
                subs[js * 32 * NW + w * 32 + lane] |= 1u << bit;
              }
            }
          }
        };
        if (hx == 0u) {
          // nothing is queued, so no server can place: every pending server
          // is advanced, each lane walking its own
#pragma unroll 1
          for (unsigned m = pw; m; m &= m - 1) {
            const int bit = __ffs(m) - 1, l = (w * 32 + bit) * 32 + lane;
            const int fw = fj[l];
            const int2 oo = occ2[l];
            const bool empty = oo.x == 0;
            touch(bit, l, empty, empty ? r_k1 : (fw & kK1) != 0,
                  empty ? r_js : (fw >> kJsShift) - 1, oo.y > 0, true);
          }
        } else {
          unsigned rounds = __reduce_or_sync(repro::kFullMask, pw);
          while (rounds) {
            const int bit = __ffs(rounds) - 1;
            rounds &= rounds - 1;
            const bool mine = (pw >> bit) & 1u;
            const int l = (w * 32 + bit) * 32 + lane;
            int k1 = 0, js = -1, ocap = kCap, other = 0;
            bool empty = false, has1 = false, k1_can = false, js_can = false;
            if (mine) {
              const int fw = fj[l];
              const int2 oo = occ2[l];
              empty = oo.x == 0;
              k1 = empty ? r_k1 : (fw & kK1) != 0;
              js = empty ? r_js : (fw >> kJsShift) - 1;
              other = oo.x - oo.y;
              ocap = k1 ? kCap - kReserve : kCap;
              has1 = oo.y > 0;
              k1_can = k1 && !has1 && he1 <= kCap - oo.x;  // an empty ring's kBig fits nothing
              js_can = js >= 0 && other + heff[js] <= ocap;
            }
            const unsigned can = __ballot_sync(repro::kFullMask, k1_can || js_can);
            const int pl = can ? __ffs(can) - 1 : 32;
            if (mine && lane <= pl) touch(bit, l, empty, k1, js, has1, lane < pl);
            if (can) {
              placer = (w * 32 + bit) * 32 + pl;
              p_k1 = __shfl_sync(repro::kFullMask, k1_can ? 1 : 0, pl);
              p_js = __shfl_sync(repro::kFullMask, js, pl);
              p_budget = __shfl_sync(repro::kFullMask, ocap - other, pl);
              break;
            }
          }
        }
        pend[w * 32 + lane] = pw;
        if (ie) inem[w * 32 + lane] |= ie;
        if (s1) subs[1 * 32 * NW + w * 32 + lane] |= s1;
        if (sr) subs[r_js * 32 * NW + w * 32 + lane] |= sr;
      }
      n_pend -= __reduce_add_sync(repro::kFullMask, adv);
      __syncwarp();
      if (placer == L) continue;  // every pending server was advanced

      // serve the placer: one reserved VQ_1 job, or the longest
      // head-of-VQ_{j*} prefix of at most P jobs that fits the budget, 32
      // ring entries at a time (sizes are >= 1, so the sums only grow)
      const int j = p_k1 ? 1 : max(p_js, 0);
      const int cnt = __shfl_sync(repro::kFullMask, qcnt, j);
      const int h = __shfl_sync(repro::kFullMask, hd, j);
      const int* re = ring_eff + static_cast<size_t>(j) * Qcap;
      const int* rd = ring_dur + static_cast<size_t>(j) * Qcap;
      unsigned* om = occm + static_cast<size_t>(placer) * KW;
      unsigned* dmask = due + static_cast<size_t>(placer) * KW;
      const unsigned ow0 = om[0];  // loaded ahead of the prefix fit
      int nd = next_dep[placer];
      int m = 1;
      if (!p_k1) {
        const int avail = min(P, cnt);
        int base = 0;
        m = 0;
#pragma unroll 1
        for (int q0 = 0; q0 < avail; q0 += 32) {
          const int q = q0 + lane;
          const int ri = h + q < Qcap ? h + q : h + q - Qcap;  // q < Qcap
          int cum = q < avail ? re[ri] : 0;
#pragma unroll
          for (int off = 1; off < 32; off <<= 1) {
            const int y = __shfl_up_sync(repro::kFullMask, cum, off);
            if (lane >= off) cum += y;
          }
          cum += base;
          const unsigned bm = __ballot_sync(repro::kFullMask, q < avail && cum <= p_budget);
          m += __popc(bm);
          if (bm != repro::kFullMask) break;
          base = __shfl_sync(repro::kFullMask, cum, 31);
        }
      }

      // the p-th job goes to the p-th empty slot of the row; next departure
      // and due slots follow, chunk by chunk of 32 slots
      int free_cnt = 0, add = 0;
#pragma unroll 1
      for (int kw = 0; kw < KW && free_cnt < m; ++kw) {
        const int k = kw * 32 + lane;
        const unsigned ow = kw == 0 ? ow0 : om[kw];
        const bool empty = k < K && !((ow >> lane) & 1u);
        const unsigned eb = __ballot_sync(repro::kFullMask, empty);
        const int r = free_cnt + __popc(eb & lanes_below);
        const bool put = empty && r < m;
        int dd = kInfSlot;
        if (put) {
          const int ri = h + r < Qcap ? h + r : h + r - Qcap;  // r < m <= Qcap
          const int er = re[ri];
          dd = add_wrap(t, rd[ri]);
          const size_t at = static_cast<size_t>(placer) * K + k;
          job[at] = er | (j << kEffBits);
          dep[at] = dd;
          add += er;
        }
        const unsigned pb = __ballot_sync(repro::kFullMask, put);
        const int cmin = __reduce_min_sync(repro::kFullMask, put && dd > t ? dd : kInfSlot);
        const unsigned cb = __ballot_sync(repro::kFullMask, put && dd == cmin && cmin != kInfSlot);
        if (lane == 0 && pb) {
          om[kw] = ow | pb;
          if (cmin < nd) {
#pragma unroll 1
            for (int x = 0; x < KW; ++x) dmask[x] = x == kw ? cb : 0u;
          } else if (cmin == nd && cmin != kInfSlot) {
            dmask[kw] |= cb;
          }
        }
        nd = min(nd, cmin);
        free_cnt += __popc(eb);
      }
      // (the loop ran over the whole row when it has fewer than m free slots)
      add = __reduce_add_sync(repro::kFullMask, add);
      if (lane == 0) {
        const int2 oo = occ2[placer];
        occ2[placer] = make_int2(oo.x + add, oo.y + (j == 1 ? add : 0));
        next_dep[placer] = nd;
        if (m > 0) inem[mask_at(placer)] &= ~mask_bit(placer);
      }
      if (lane == j) {
        qcnt -= m;
        hd = h + m < Qcap ? h + m : h + m - Qcap;  // m <= Qcap
        heff[j] = qcnt > 0 ? re[hd] : kBig;
      }
      q_tot -= m;
      occ_tot += static_cast<unsigned>(add);
      mw.move(confs, C, nvq, j, -m);
      n_trunc += max(m - free_cnt, 0);  // K-overflow
      __syncwarp();
    }
    // step bound hit with servers still unserved: the slot finished lazily
    if (!done) n_trunc += n_pend > 0 ? 1 : 0;

    // the slot's outputs: queued jobs, occupancy as the float of the int32
    // grid sum over RES, departures
    if (lane == 0) {
      qlen[t] = q_tot;
      occ_out[t] = __int2float_rn(static_cast<int>(occ_tot)) / 65536.f;
      ndep_out[t] = n_dep;
    }
    repro::named_barrier(kSlotBarrier, kVqsThreads);
  }
  if (lane == 0) {
    dropped_out[g] = dropped;
    trunc_out[g] = n_trunc;
  }
}

}  // namespace

extern "C" size_t vqs_shared_bytes(int J, int L, int K, int Qcap, int A) {
  return vqs_layout(J, L, K, Qcap, A).shared_bytes + kStaticSmem;
}

extern "C" size_t vqs_workspace_bytes(int J, int L, int K, int Qcap, int A) {
  return vqs_layout(J, L, K, Qcap, A).workspace_bytes;
}

extern "C" int vqs_launch(const int* n, const float* sizes, const int* durs, const int* confs,
                          int G, int T, int J, int L, int K, int Qcap, int A, int D, int W, int P,
                          void* ws, int* qlen, float* occ, int* ndep, int* dropped,
                          int* truncated, void* stream) {
  const VqsLayout lay = vqs_layout(J, L, K, Qcap, A);
  auto kernel = !lay.book_in_smem ? vqs_kernel<false, false, false>
                : lay.rings_in_smem ? (lay.jobs_in_smem ? vqs_kernel<true, true, true>
                                                        : vqs_kernel<true, true, false>)
                                    : (lay.jobs_in_smem ? vqs_kernel<true, false, true>
                                                        : vqs_kernel<true, false, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.shared_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<G, kVqsThreads, lay.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      n, sizes, durs, confs, T, J, L, K, Qcap, A, D, W, P, static_cast<unsigned char*>(ws),
      lay.workspace_bytes, qlen, occ, ndep, dropped, truncated);
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
