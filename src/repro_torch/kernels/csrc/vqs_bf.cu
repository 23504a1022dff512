// Fused VQS-BF slot engine (paper Section VI) on Hopper.
//
// Replaces the Pallas TPU kernel `_vqs_bf_kernel`
// (src/repro/kernels/vqs_bf/vqs_bf.py).  One thread block simulates one
// member of the Monte-Carlo ensemble over the whole horizon.  Per slot:
// departures; classification of up to A_max arrivals into 2J size-bucketed
// rings (each arrival takes the lowest empty slot of its bucket and a
// sequence stamp); the visit set; a work list of at most W+1 steps, each of
// which advances past every pending server that cannot place and serves the
// first one that can with ONE largest-fit pop, staged (i) a VQ_1 job while
// none is resident, (ii) a VQ_{j*} job below the k_{j*} cap, (iii) any job;
// then the arrival-side BF-J pass offering every arrival still queued (its
// sequence stamp survived) to the tightest feasible server.  The trajectory
// is the one of the scan engine (repro_torch/core/engine/vqs_bf.py, the
// plain version) on every field, occupancy included.
//
// What bounds it: a latency chain — slot t+1 needs slot t and step s+1 needs
// step s — far above its bytes and operations.  The design keeps the chain
// short:
//   * A decision warp makes every decision.  Its reductions are
//     warp-synchronous (`redux.sync` on 32-bit integer keys of the 2^16
//     grid, then more for the lowest index, stamp and position), so no
//     block barrier sits inside a step.  Lane i owns servers i, i + 32,
//     ...; the pending set (visited, not yet advanced), the _empty set and
//     each type's subscribers are per-lane bitmasks, so a step walks only
//     the pending servers, in index order per lane.
//   * A server can place iff its residual takes the smallest queued job
//     (stages (i) and (ii) need a fitting job of one bucket, so they imply
//     it): pass 1 is one compare a server, and a pending server that misses
//     is not tested again in the slot (the smallest job only grows, its
//     residual does not change).  Last step's placer, while it can still
//     place, is this step's, with nothing to touch.
//   * Bookkeeping moves off the steps: bucket minima are rescanned only
//     when a pop took one or arrivals changed it; the max-weight row's
//     weights are kept per lane and moved by every change of a queue count,
//     the queue counts live in lanes, and K_RED's rows are decoded once;
//     occupancy is a running integer sum; a lane per bucket finds the
//     empty ring slots; the arrival-side pass walks only the arrivals still
//     queued.
//   * The job planes leave device memory: a packed (L, K) plane of effective
//     size and type (eff | vq << 17) in shared memory when it fits, per-row
//     occupied and due-slot bitmasks, and the next departure slot per row.
//     A placement finds its slot with one bitmask word; departures read only
//     the due slots' packed words.  The departure slots themselves live in
//     a per-member device workspace, written at placement and read only by
//     the second warp.
//   * A second warp keeps the streams and the bookkeeping off the chain: it
//     loads and classifies slot t+1's arrivals (grid size, type, effective
//     size, duration, rank within the type, counts per type) into a double
//     buffer while the decision warp runs slot t, and, once the decision
//     warp has taken slot t's departures (it signals on a named barrier),
//     recomputes from the workspace the next departure slot and due slots of
//     every row that lost a job.  The decision warp merges them at the start
//     of slot t+1; the two warps meet once a slot on another named barrier.
// At the vqs-bf path's shape the chain is still ~4,600 cycles a step on the
// card: pass 2 over the ~445 servers a slot visits (all of _empty while
// work is queued), the pop, and pass 1, each a series of dependent
// shared-memory round trips and warp reductions on one warp.
// The decision warp's loops with a trip count known only at run time are
// not unrolled (`#pragma unroll 1`): with one warp on the SM the smaller
// code ran faster on the card than the loads that unrolling overlaps.
// Shared memory holds per-server aggregates (next departure, occupancy,
// flags, configuration, resident jobs per type in 16 bits), the bitmasks,
// the rings (sizes, durations, sequence stamps) when they fit, and the
// packed job plane when it also fits; what does not fit moves to the
// workspace.  It takes every J the grid allows (2 <= J <= 16) and K < 65536.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "vqs_common.cuh"

namespace {

using namespace vqsk;

constexpr int kBfThreads = 64;    // warp 0 decides, warp 1 streams and books
constexpr int kSlotBarrier = 1;   // both warps, once a slot
constexpr int kDepartBarrier = 2; // decision warp arrives, stream warp waits
constexpr int kNone = 0x7fffffff;

struct BfLayout {
  bool rings_in_smem, jobs_in_smem;
  size_t shared_bytes;     // dynamic shared memory of one block
  size_t workspace_bytes;  // device workspace of one member (16-aligned)
};

// The fixed part always sits in shared memory; the rings join it when they
// fit, then the packed job plane when it fits too.  The workspace holds the
// departure slots, then whatever did not fit.
__host__ BfLayout vqs_bf_layout(int J, int L, int K, int Qcap, int A) {
  const size_t nvq = 2 * J, C = 4 * J - 4, KW = row_words(K), NW = lane_words(L);
  const size_t Ls = L;
  const size_t fixed = C * nvq + C + 6 * Ls + 3 * KW * Ls + (4 + nvq) * 32 * NW + 3 * nvq +
                       2 * arrival_words(A, nvq) + 3 * static_cast<size_t>(A) +
                       (Ls * nvq + 1) / 2;
  const size_t rings = 3 * nvq * Qcap, jobs = Ls * K;
  BfLayout lay;
  lay.rings_in_smem = 4 * (fixed + rings) + kStaticSmem <= kSmemLimit;
  size_t words = fixed + (lay.rings_in_smem ? rings : 0);
  lay.jobs_in_smem = 4 * (words + jobs) + kStaticSmem <= kSmemLimit;
  if (lay.jobs_in_smem) words += jobs;
  lay.shared_bytes = 4 * words;
  const size_t ws = 4 * (jobs + (lay.rings_in_smem ? 0 : rings) + (lay.jobs_in_smem ? 0 : jobs));
  lay.workspace_bytes = (ws + 15) / 16 * 16;
  return lay;
}

// Where the rings and the packed job plane live is a template argument, so
// the compiler addresses them as shared memory (LDS/STS) when they are.
template <bool kRingsInSmem, bool kJobsInSmem>
__global__ void __launch_bounds__(kBfThreads, 1)
vqs_bf_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
              const int* __restrict__ durs, const int* __restrict__ confs_in, int T, int J,
              int L, int K, int Qcap, int A, int D, int W, unsigned char* __restrict__ ws,
              size_t ws_stride, int* __restrict__ qlen,
              float* __restrict__ occ_out, int* __restrict__ ndep_out,
              int* __restrict__ dropped_out, int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) int smem[];
  const int nvq = 2 * J, C = 4 * J - 4, KW = row_words(K), NW = lane_words(L);
  const int AB = arrival_words(A, nvq);
  int* confs = smem;                   // (C, 2J) K_RED
  int* next_dep = confs + C * nvq;     // per server (L each) ...
  int* occ = next_dep + L;
  int* flags = occ + L;
  int* cfg_js = flags + L;
  int* cfg_ks = cfg_js + L;
  int* rec_nd = cfg_ks + L;           // recomputed next departure
  unsigned* occm = reinterpret_cast<unsigned*>(rec_nd + L);  // (L, KW) occupied slots
  unsigned* due = occm + static_cast<size_t>(L) * KW;        // slots leaving at next_dep
  unsigned* rec_mask = due + static_cast<size_t>(L) * KW;    // recomputed due slots
  unsigned* pend = rec_mask + static_cast<size_t>(L) * KW;   // (NW, 32) pending servers
  unsigned* fail = pend + 32 * NW;     // (NW, 32) pending servers that cannot place
  unsigned* recf = fail + 32 * NW;     // (NW, 32) rows whose next departure is recomputed
  unsigned* inem = recf + 32 * NW;     // (NW, 32) members of the scheduler's _empty set
  unsigned* subs = inem + 32 * NW;     // (2J, NW, 32) subscribers of each type
  int* rowcfg = reinterpret_cast<int*>(subs + nvq * 32 * NW);  // (C) K_RED rows decoded
  int* hw = rowcfg + C;                // per queue (2J each): high-water mark, live entries below
  int* rmin = hw + nvq;                // smallest queued size
  int* found = rmin + nvq;             // this slot's arrivals that found a slot
  int* abuf = found + nvq;             // 2 x slot buffers of classified arrivals
  int* epos = abuf + 2 * AB;           // empty ring slots found, grouped by type
  int* a_pos = epos + A;
  int* a_land = a_pos + A;
  unsigned short* tcnt = reinterpret_cast<unsigned short*>(a_land + A);  // (L, 2J)
  int* tail = reinterpret_cast<int*>(tcnt) + (L * nvq + 1) / 2;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;
  const size_t ring_words = static_cast<size_t>(nvq) * Qcap;
  const size_t LK = static_cast<size_t>(L) * K;
  int* dep = reinterpret_cast<int*>(ws + g * ws_stride);  // (L, K) departure slots
  int* wnext = dep + LK;
  int* ring_eff = kRingsInSmem ? tail : wnext;
  int* ring_dur = ring_eff + ring_words;
  int* ring_seq = ring_dur + ring_words;
  int* job = kJobsInSmem ? (kRingsInSmem ? tail + 3 * ring_words : tail)
                         : (kRingsInSmem ? wnext : wnext + 3 * ring_words);
  n += g * T;
  sizes += g * T * A;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ_out += g * T;
  ndep_out += g * T;

  for (int i = tid; i < C * nvq; i += kBfThreads) confs[i] = confs_in[i];
  for (int c = tid; c < C; c += kBfThreads) rowcfg[c] = decode_row(confs_in + c * nvq, nvq);
  for (int l = tid; l < L; l += kBfThreads) {
    next_dep[l] = rec_nd[l] = kInfSlot;
    occ[l] = cfg_ks[l] = flags[l] = 0;
    cfg_js[l] = -1;
  }
  for (size_t i = tid; i < static_cast<size_t>(L) * KW; i += kBfThreads) occm[i] = due[i] = 0u;
  for (int i = tid; i < L * nvq; i += kBfThreads) tcnt[i] = 0;
  for (int i = tid; i < 32 * NW; i += kBfThreads) {
    pend[i] = fail[i] = recf[i] = 0u;
    unsigned all = 0u;  // all servers start in _empty
    for (int bit = 0; bit < 32; ++bit) {
      if (((i / 32) * 32 + bit) * 32 + i % 32 < L) all |= 1u << bit;
    }
    inem[i] = all;
  }
  for (int i = tid; i < nvq * 32 * NW; i += kBfThreads) subs[i] = 0u;
  for (int j = tid; j < nvq; j += kBfThreads) {
    hw[j] = 0;
    rmin[j] = kInf32;
  }
  for (size_t i = tid; i < ring_words; i += kBfThreads) {
    ring_eff[i] = 0;
    ring_dur[i] = 1;
    ring_seq[i] = 0;
  }
  __syncthreads();

  if (warp == 1) {
    // ---- the stream and bookkeeping warp --------------------------------
    // slot u's arrivals, classified and ranked within their type
    auto load_slot = [&](int u) {
      classify_slot(abuf + (u & 1) * AB, n[u], sizes + static_cast<size_t>(u) * A,
                    durs + static_cast<size_t>(u) * D, A, D, J);
    };
    if (T > 0) load_slot(0);
    repro::named_barrier(kSlotBarrier, kBfThreads);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) load_slot(t + 1);
      repro::named_barrier(kDepartBarrier, kBfThreads);
      recompute_departures(recf, dep, rec_mask, rec_nd, NW, K, t);
      repro::named_barrier(kSlotBarrier, kBfThreads);
    }
    return;
  }

  // ---- the decision warp -------------------------------------------------
  repro::named_barrier(kSlotBarrier, kBfThreads);
  // Warp-uniform state: counters, the sequence counter, the running
  // occupancy and queue totals, the smallest queued size over all buckets
  // and the buckets whose minimum is stale; each lane keeps the max-weight
  // weights of K_RED rows `lane` and `lane + 32`.
  int dropped = 0, n_trunc = 0, seq_ctr = 0, q_tot = 0, glob_min = kInf32;
  unsigned occ_tot = 0u, dirty = 0u;
  MaxWeight mw;
  int qcnt = 0;  // lane j: jobs queued in bucket j

  // A queue count moved by `delta`: the weights of the rows follow.
  auto move_count = [&](int j, int delta) { mw.move(confs, C, nvq, j, delta); };

  // Smallest entry of bucket j, and the smallest over all buckets; lowers
  // the bucket's high-water mark to just past its last entry.
  auto rescan = [&](int j) {
    const int* re = ring_eff + static_cast<size_t>(j) * Qcap;
    const int other = lane < nvq && lane != j ? rmin[lane] : kInf32;
    int m = kInf32, top = -1;
#pragma unroll 1
    for (int q = lane; q < hw[j]; q += 32) {
      const int e = re[q];
      if (e > 0) {
        m = min(m, e);
        top = q;
      }
    }
    m = __reduce_min_sync(repro::kFullMask, m);
    top = __reduce_max_sync(repro::kFullMask, top);
    glob_min = __reduce_min_sync(repro::kFullMask, min(other, m));
    __syncwarp();
    if (lane == 0) {
      rmin[j] = m;
      hw[j] = top + 1;
    }
    __syncwarp();
  };

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int* b = abuf + (t & 1) * AB;
    const int *bvq = b, *beff = b + A, *bdur = b + 2 * A, *brank = b + 3 * A;
    const int *bcnt = b + 4 * A, *boff = bcnt + nvq;

    // One job onto the first empty slot of server s: resident aggregates
    // and the row's next departure follow; a full row places nothing.
    auto place = [&](int s, int e, int d, int v) {
      const unsigned* om = occm + static_cast<size_t>(s) * KW;
      int k = K;
#pragma unroll 1
      for (int kw = 0; kw < KW; ++kw) {
        const int rest = K - 32 * kw;
        const unsigned avail = ~om[kw] & (rest >= 32 ? 0xffffffffu : (1u << rest) - 1u);
        if (avail) {
          k = 32 * kw + __ffs(avail) - 1;
          break;
        }
      }
      if (k < K) {
        if (lane == 0) {
          const int dd = add_wrap(t, d);
          const size_t at = static_cast<size_t>(s) * K + k;
          job[at] = e | (v << kEffBits);
          dep[at] = dd;
          occ[s] += e;
          ++tcnt[s * nvq + v];
          occm[static_cast<size_t>(s) * KW + k / 32] |= 1u << (k & 31);
          if (dd > t) {
            unsigned* dm = due + static_cast<size_t>(s) * KW;
            const int nd = next_dep[s];
            if (dd < nd) {
              next_dep[s] = dd;
#pragma unroll 1
              for (int kw = 0; kw < KW; ++kw) dm[kw] = kw == k / 32 ? 1u << (k & 31) : 0u;
            } else if (dd == nd) {
              dm[k / 32] |= 1u << (k & 31);
            }
          }
        }
        occ_tot += static_cast<unsigned>(e);
      } else {
        ++n_trunc;  // K-overflow: the popped job is not placed
      }
      if (lane == 0) inem[mask_at(s)] &= ~mask_bit(s);
      __syncwarp();
    };

    // A job leaves bucket j's ring at `at`.
    auto unqueue = [&](int j, size_t at) {
      if (lane == 0) ring_eff[at] = 0;
      if (lane == j) --qcnt;
      --q_tot;
      move_count(j, -1);
      __syncwarp();
    };

    // 0. the next departures the stream warp recomputed for last slot's rows
    merge_departures(recf, rec_nd, rec_mask, next_dep, due, NW, KW);

    // 1. arrivals: the r-th arrival of a type takes the r-th empty slot of
    // its bucket (a lane per bucket finds them)
    const int c_j = lane < nvq ? bcnt[lane] : 0;
    const unsigned arrived = __ballot_sync(repro::kFullMask, c_j > 0);
    int f_j = 0;
    if (c_j > 0) {
      const int* re = ring_eff + static_cast<size_t>(lane) * Qcap;
      int* ep = epos + boff[lane];
      int last = 0;
#pragma unroll 1
      for (int q = 0; q < Qcap && f_j < c_j; ++q) {
        if (re[q] == 0) {
          ep[f_j++] = q;
          last = q;
        }
      }
      found[lane] = f_j;
      qcnt += f_j;
      if (f_j > 0) hw[lane] = max(hw[lane], last + 1);
    }
    dropped += __reduce_add_sync(repro::kFullMask, c_j - f_j);
    q_tot += __reduce_add_sync(repro::kFullMask, f_j);
    __syncwarp();
    for (unsigned m = arrived; m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      move_count(j, found[j]);
    }
#pragma unroll 1
    for (int a = lane; a < A; a += 32) {
      const int v = bvq[a];
      const int land = v >= 0 && brank[a] < found[v];
      int pos = 0;
      if (land) {
        pos = epos[boff[v] + brank[a]];
        const size_t at = static_cast<size_t>(v) * Qcap + pos;
        ring_eff[at] = beff[a];
        ring_dur[at] = bdur[a];
        ring_seq[at] = seq_ctr + a;
      }
      a_land[a] = land;
      a_pos[a] = pos;
    }
    const int slot_seq = seq_ctr;
    seq_ctr += A;
    dirty |= arrived;
    __syncwarp();

    // 2. departures (only the due slots; the lanes walk their due rows
    // together), then the visit set — freed servers, subscribers woken by
    // an arrived type (those subscriptions are consumed), and _empty members
    // while work is queued — and its slot flags.  Flags of servers outside
    // the set are not read this slot.
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
        int out = 0, c = 0;
        bool kept = false;
#pragma unroll 1
        for (int kw = 0; kw < KW; ++kw) {
          const unsigned leave = lv[kw], left = om[kw] & ~leave;
          for (unsigned x = leave; x; x &= x - 1) {
            const int p = job[static_cast<size_t>(l) * K + kw * 32 + __ffs(x) - 1];
            out += p & kEffMask;
            --tcnt[l * nvq + (p >> kEffBits)];
            ++c;
          }
          om[kw] = left;
          keep[kw] = left;
          lv[kw] = 0u;
          kept = kept || left != 0u;
        }
        occ[l] -= out;
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
      for (unsigned m = pm; m; m &= m - 1) {
        const int bit = __ffs(m) - 1;
        const int l = (w * 32 + bit) * 32 + lane;
        int f = (flags[l] & (kK1 | kHasCfg)) | ((fr >> bit) & 1u ? kFreed : 0);
        const unsigned* om = occm + static_cast<size_t>(l) * KW;
        bool empty_now = true;
#pragma unroll 1
        for (int kw = 0; kw < KW; ++kw) empty_now = empty_now && om[kw] == 0u;
        if (empty_now) f |= kEmptyNow;
        if ((f & kEmptyNow) || !(f & kHasCfg)) f |= kRenew;
        flags[l] = f;
      }
      pend[w * 32 + lane] = pm;
      fail[w * 32 + lane] = 0u;
      recf[w * 32 + lane] = rm;
      my_pend += __popc(pm);
    }
    const int n_dep = __reduce_add_sync(repro::kFullMask, my_dep);
    occ_tot -= __reduce_add_sync(repro::kFullMask, my_out);
    int n_pend = __reduce_add_sync(repro::kFullMask, my_pend);
    // the rows that lost jobs are ready for the stream warp
    asm volatile("bar.arrive %0, %1;" ::"r"(kDepartBarrier), "r"(kBfThreads) : "memory");

    for (unsigned m = dirty; m; m &= m - 1) rescan(__ffs(m) - 1);
    dirty = 0u;

    // 3. work list: at most W+1 one-placement steps
    bool done = false;
    int placer = -1;  // last step's placer; pending servers below it were advanced
#pragma unroll 1
    for (int step = 0; step <= W; ++step) {
      if (n_pend == 0) {
        done = true;
        break;
      }
      // A server can place when its residual takes the smallest queued job
      // (stages (i) and (ii) need a job of one bucket that fits, so they
      // imply it).  While last step's placer still can, it is the lowest
      // pending server that can, and touching it again changes nothing.
      const int occ_max = kCap - glob_min;
      if (placer < 0 || occ[placer] > occ_max) {
        // pass 1: the lowest pending server that can place.  One that
        // cannot stays unable for the rest of the list (the smallest job
        // only grows, its residual does not change), so it is tested once.
        int first = L;
#pragma unroll 1
        for (int w = 0; w < NW && first == L; ++w) {
          unsigned bad = 0u;
          for (unsigned m = pend[w * 32 + lane] & ~fail[w * 32 + lane]; m; m &= m - 1) {
            const int bit = __ffs(m) - 1;
            const int l = (w * 32 + bit) * 32 + lane;
            if (occ[l] <= occ_max) {
              first = l;
              break;
            }
            bad |= 1u << bit;
          }
          if (bad) fail[w * 32 + lane] |= bad;
        }
        placer = __reduce_min_sync(repro::kFullMask, first);

        // the renewal candidate, the first max-weight row of K_RED (Eq. 8),
        // and the non-empty queues
        const unsigned hx = __ballot_sync(repro::kFullMask, qcnt > 0);
        const int rc = rowcfg[mw.best(C)];
        const int r_k1 = rc & 1, r_js = ((rc >> 1) & 63) - 1, r_ks = rc >> 7;

        // pass 2: touch every pending server up to the placer (renewal at
        // first touch, _empty membership), advance past the ones below it
        // (subscribing them to the types they wait for)
        int adv = 0;
#pragma unroll 1
        for (int w = 0; w < NW; ++w) {
          unsigned keep = pend[w * 32 + lane];
          for (unsigned m = keep; m; m &= m - 1) {
            const int bit = __ffs(m) - 1;
            const int l = (w * 32 + bit) * 32 + lane;
            if (l > placer) break;
            int f = flags[l];
            const bool ren = (f & kRenew) && !(f & kTouched);
            const int k1 = ren ? r_k1 : (f & kK1) != 0;
            const int js = ren ? r_js : cfg_js[l];
            const int ks = ren ? r_ks : cfg_ks[l];
            if (ren) {
              f = r_k1 ? (f | kK1) : (f & ~kK1);
              cfg_js[l] = r_js;
              cfg_ks[l] = r_ks;
            }
            if (!(f & kTouched) && (f & kEmptyNow)) inem[w * 32 + lane] |= 1u << bit;
            f |= kHasCfg | kTouched;
            if (l < placer) {
              keep &= ~(1u << bit);
              ++adv;
              if (k1 && !((hx >> 1) & 1u) && tcnt[l * nvq + 1] == 0)
                subs[1 * 32 * NW + w * 32 + lane] |= 1u << bit;
              if (js >= 0 && !((hx >> js) & 1u) && tcnt[l * nvq + js] < ks)
                subs[js * 32 * NW + w * 32 + lane] |= 1u << bit;
            }
            flags[l] = f;
          }
          pend[w * 32 + lane] = keep;
        }
        n_pend -= __reduce_add_sync(repro::kFullMask, adv);
        __syncwarp();
        if (placer == L) {  // every pending server was advanced
          placer = -1;
          continue;
        }
      }

      // serve the placer, staged (i) -> (ii) -> (iii): the largest entry <=
      // its residual over the allowed buckets whose smallest entry fits,
      // lowest bucket on ties, then FIFO (smallest stamp), then lowest
      // position
      const int fp = flags[placer], resid = kCap - occ[placer];
      const int js = cfg_js[placer];
      const bool do1 = (fp & kK1) && tcnt[placer * nvq + 1] == 0 && rmin[1] <= resid;
      const bool doj = !do1 && js >= 0 && tcnt[placer * nvq + js] < cfg_ks[placer] &&
                       rmin[js] <= resid;
      const unsigned allowed = (do1 ? 2u : doj ? 1u << js : 0xffffffffu) &
                               __ballot_sync(repro::kFullMask, lane < nvq && rmin[lane] <= resid);
      unsigned bk = 0u;  // (size << 5) | (31 - bucket): larger size, then lower bucket
      int bs = kNone, bq = kNone;
      for (unsigned m = allowed; m; m &= m - 1) {
        const int j = __ffs(m) - 1;
        const int* re = ring_eff + static_cast<size_t>(j) * Qcap;
        const int* rs = ring_seq + static_cast<size_t>(j) * Qcap;
#pragma unroll 1
        for (int q = lane; q < hw[j]; q += 32) {
          const int e = re[q];
          if (e > 0 && e <= resid) {
            const unsigned k = (static_cast<unsigned>(e) << 5) | static_cast<unsigned>(31 - j);
            const int s = rs[q];
            if (k > bk || (k == bk && (s < bs || (s == bs && q < bq)))) {
              bk = k;
              bs = s;
              bq = q;
            }
          }
        }
      }
      const unsigned pk = __reduce_max_sync(repro::kFullMask, bk);
      if (pk != 0u) {
        const int ps = __reduce_min_sync(repro::kFullMask, bk == pk ? bs : kNone);
        const int pq = __reduce_min_sync(repro::kFullMask, bk == pk && bs == ps ? bq : kNone);
        const int pj = 31 - static_cast<int>(pk & 31u), pe = static_cast<int>(pk >> 5);
        const size_t at = static_cast<size_t>(pj) * Qcap + pq;
        place(placer, pe, ring_dur[at], pj);
        unqueue(pj, at);
        if (pe == rmin[pj]) rescan(pj);  // else the bucket's smallest stays
      }
    }
    // step bound hit with servers still unserved: the slot finished lazily
    if (!done) n_trunc += n_pend > 0 ? 1 : 0;

    // 4. arrival-side BF-J pass over the arrivals still in their bucket
    // (same sequence stamp): each goes to the tightest feasible server
#pragma unroll 1
    for (int a0 = 0; a0 < A; a0 += 32) {
      const int a = a0 + lane;
      bool queued = false;
      if (a < A && a_land[a]) {
        const size_t at = static_cast<size_t>(bvq[a]) * Qcap + a_pos[a];
        queued = ring_eff[at] > 0 && ring_seq[at] == slot_seq + a;
      }
      for (unsigned m = __ballot_sync(repro::kFullMask, queued); m; m &= m - 1) {
        const int aa = a0 + __ffs(m) - 1;
        const int v = bvq[aa], e = beff[aa];
        unsigned br = repro::kNoMinKey;
        int bl = L;
#pragma unroll 1
        for (int l = lane; l < L; l += 32) {
          const int rr = kCap - occ[l];
          if (rr >= e && static_cast<unsigned>(rr) < br) {
            br = static_cast<unsigned>(rr);
            bl = l;
          }
        }
        unsigned bestr;
        const int s = repro::warp_argmin_key(br, bl, bestr);
        if (bestr == repro::kNoMinKey) continue;  // fits no server
        place(s, e, bdur[aa], v);
        unqueue(v, static_cast<size_t>(v) * Qcap + a_pos[aa]);
        dirty |= 1u << v;
      }
    }

    // the slot's outputs: queued jobs, occupancy as the float of the int32
    // grid sum over RES, departures
    if (lane == 0) {
      qlen[t] = q_tot;
      occ_out[t] = __int2float_rn(static_cast<int>(occ_tot)) / 65536.f;
      ndep_out[t] = n_dep;
    }
    repro::named_barrier(kSlotBarrier, kBfThreads);
  }
  if (lane == 0) {
    dropped_out[g] = dropped;
    trunc_out[g] = n_trunc;
  }
}

}  // namespace

extern "C" size_t vqs_bf_shared_bytes(int J, int L, int K, int Qcap, int A) {
  return vqs_bf_layout(J, L, K, Qcap, A).shared_bytes + kStaticSmem;
}

extern "C" size_t vqs_bf_workspace_bytes(int J, int L, int K, int Qcap, int A) {
  return vqs_bf_layout(J, L, K, Qcap, A).workspace_bytes;
}

extern "C" int vqs_bf_launch(const int* n, const float* sizes, const int* durs,
                             const int* confs, int G, int T, int J, int L, int K, int Qcap, int A,
                             int D, int W, int /*drain: VQS only*/, void* ws, int* qlen,
                             float* occ, int* ndep, int* dropped, int* truncated, void* stream) {
  const BfLayout lay = vqs_bf_layout(J, L, K, Qcap, A);
  auto kernel = lay.rings_in_smem ? (lay.jobs_in_smem ? vqs_bf_kernel<true, true>
                                                      : vqs_bf_kernel<true, false>)
                                  : (lay.jobs_in_smem ? vqs_bf_kernel<false, true>
                                                      : vqs_bf_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.shared_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<G, kBfThreads, lay.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      n, sizes, durs, confs, T, J, L, K, Qcap, A, D, W, static_cast<unsigned char*>(ws),
      lay.workspace_bytes, qlen, occ, ndep, dropped, truncated);
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
