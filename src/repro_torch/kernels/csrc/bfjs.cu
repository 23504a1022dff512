// Fused BF-J/S slot engine (paper Section IV) on Hopper.
//
// Replaces the Pallas TPU kernel `_bfjs_kernel`
// (src/repro/kernels/bfjs/bfjs.py).  One thread block simulates one member
// of the Monte-Carlo ensemble over the whole horizon.  Per slot:
// departures; first-empty enqueue of up to A_max arrivals; a bounded list of
// `W` placement steps, each the BF-S refill of the lowest-index freed server
// that still has a fitting job, else the BF-J attempt of the next landed
// arrival; the saturation check that counts `truncated` slots.  The
// trajectory is the one of the scan engine (repro_torch/core/engine/bfjs.py,
// the plain version), bit for bit.
//
// What bounds it: slot t+1 needs slot t and placement step s+1 needs step s,
// so the time is (slots) x (steps a slot) x (the latency of one step) — a
// latency chain, hundreds of times above the bytes it must move (the used
// stream lanes and the (G, T) outputs) and its operations.  The design keeps
// that chain short:
//   * A decision warp makes every decision of the chain.  Its reductions are
//     warp-synchronous (`redux.sync` on order-preserving 32-bit keys of the
//     float residuals and sizes, then a second one for the lowest index), so
//     no block barrier sits inside a step.  Lane i owns servers i, i + 32,
//     ..., so the residual scans read conflict-free and a lane's own scan is
//     already in index order.
//   * Less work a step: a per-row next-departure slot makes departures test
//     L entries, not L x K; the freed servers are per-lane bitmasks, and a
//     freed server that cannot take the smallest queued job is dropped from
//     the live mask for the rest of the slot (the smallest job only grows and
//     a residual only shrinks within a slot — except at the slot-0 overwrite
//     of a full row, which puts its server back); queue scans stop at a
//     high-water mark below which every queued job lies (first-empty
//     enqueue), lowered by every scan; once no freed server fits, the BF-S
//     part of a step is skipped for the rest of the slot.
//   * A second warp keeps the streams and the bookkeeping off the chain: it
//     loads slot t+1's count, sizes and used duration lanes into a double
//     buffer in shared memory while the decision warp runs slot t, and adds
//     slot t-1's occupancy from a snapshot of the row sums.  The two warps
//     meet once a slot on a named barrier.  Duration lanes past the buffer
//     (a BF-S refill beyond the A_max + 4 buffered ones, only with a
//     larger work_steps) are read from device memory.
// At the path's shape a slot then takes ~40,000 cycles on the card for ~30
// steps, most of them in placement, the smallest-job and lowest-fitting-
// freed-server tests, departures and the BF-S choice, each a series of
// dependent shared-memory round trips and warp reductions on one warp.
// The decision warp's loops with a trip count known only at run time are
// not unrolled (`#pragma unroll 1`): with one warp on the SM the smaller
// code ran faster on the card than the loads that unrolling overlaps.
// The whole state stays in shared memory for the horizon: srv (L,K) f32 and
// dep (L,K) i32 with rows padded to an odd stride; the queue (Qcap) f32; row
// sums (L) f32, from which residuals are `1 - rowsum` exactly as the engines
// compute them, and the residuals' order keys (L), which the scans compare;
// next departures (L) i32; the occupancy snapshots (2 x L
// rounded up to 32, zero-padded) f32; the landed positions (A_max) i32; the
// freed and live masks; and the two stream buffers.
//
// Summation order decides placements (residual comparisons are exact), so
// every row sum is a left-to-right float32 chain from srv[l][0], recomputed
// only for rows that changed, and occupancy adds the row sums in ascending
// row order — the order of the plain version.
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 64;  // warp 0 decides, warp 1 streams and books
constexpr int kInfSlot = 0x7fffffff;
constexpr int kSlotBarrier = 1;  // named barrier the two warps meet on

__host__ __device__ inline int padded_stride(int K) { return K | 1; }

__host__ __device__ inline int round32(int x) { return (x + 31) / 32 * 32; }

// Mask words a lane holds: one bit per server it owns, ceil(L / 32) of them.
__host__ __device__ inline int mask_words(int L) { return ((L + 31) / 32 + 31) / 32; }

// BF-S duration lanes buffered a slot: the default work list's A_max + 4.
__host__ __device__ inline int bfs_lanes(int L, int K, int A) { return min(A + 4, L * K + A); }

// One slot's stream buffer: count, A sizes, BF-S lanes, A BF-J lanes.
__host__ __device__ inline int slot_words(int L, int K, int A) {
  return 1 + 2 * A + bfs_lanes(L, K, A);
}

__host__ inline size_t bfjs_smem_bytes(int L, int K, int Qcap, int A) {
  const size_t words = 2 * static_cast<size_t>(L) * padded_stride(K) + Qcap + 3 * L +
                       2 * round32(L) + A + 2 * 32 * mask_words(L) + 2 * slot_words(L, K, A);
  return 4 * words;
}

// Left-to-right float32 sum of n >= 1 non-negative floats, x[0] first
// (-0.0 + x[0] is x[0] exactly), loads issued eight at a time ahead of their
// adds (adding the +0.0 padding is exact).
__device__ __forceinline__ float chain_sum(const float* x, int n) {
  float s = -0.f;
  for (int k0 = 0; k0 < n; k0 += 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = k0 + j < n ? x[k0 + j] : 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = s + v[j];
  }
  return s;
}

// The same over a zero-padded, 16-byte aligned run of n = 32m floats, with
// the next 32 loaded while the current 32 are added: the occupancy chain.
__device__ __forceinline__ float chain_sum32(const float* x, int n) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4 cur[8], nxt[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cur[j] = x4[j];
  float s = -0.f;
  for (int b = 0; b < n / 32; ++b) {
    if (b + 1 < n / 32) {
#pragma unroll
      for (int j = 0; j < 8; ++j) nxt[j] = x4[8 * (b + 1) + j];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s = s + cur[j].x;
      s = s + cur[j].y;
      s = s + cur[j].z;
      s = s + cur[j].w;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cur[j] = nxt[j];
  }
  return s;
}

__device__ __forceinline__ int add_wrap(int t, int d) {
  return static_cast<int>(static_cast<unsigned>(t) + static_cast<unsigned>(d));
}

__global__ void __launch_bounds__(kThreads, 1)
bfjs_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
            const int* __restrict__ durs, int T, int L, int K, int Qcap, int A, int W,
            int* __restrict__ qlen, float* __restrict__ occ, int* __restrict__ ndep_out,
            int* __restrict__ dropped_out, int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = padded_stride(K), LP = round32(L), NW = mask_words(L);
  const int PB = bfs_lanes(L, K, A), SW = slot_words(L, K, A);
  // 16-byte aligned first: the two occupancy snapshots (LP is a multiple of
  // 32 floats)
  float* snap = reinterpret_cast<float*>(smem);
  float* srv = snap + 2 * LP;
  int* dep = reinterpret_cast<int*>(srv + static_cast<size_t>(L) * KP);
  float* queue = reinterpret_cast<float*>(dep + static_cast<size_t>(L) * KP);
  float* rsum = queue + Qcap;
  int* next_dep = reinterpret_cast<int*>(rsum + L);
  unsigned* rkey = reinterpret_cast<unsigned*>(next_dep + L);  // order keys of 1 - rsum
  int* newpos = reinterpret_cast<int*>(rkey + L);
  unsigned* freed = reinterpret_cast<unsigned*>(newpos + A);  // (NW, 32): freed this slot
  unsigned* live = freed + 32 * NW;  // freed servers that may still fit
  int* sbuf = reinterpret_cast<int*>(live + 32 * NW);  // 2 x SW stream words

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;
  const int LK = L * K, D = LK + A;
  n += g * T;
  sizes += g * T * A;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ += g * T;
  ndep_out += g * T;

  for (int i = tid; i < L * KP; i += kThreads) { srv[i] = 0.f; dep[i] = kInfSlot; }
  for (int i = tid; i < Qcap; i += kThreads) queue[i] = 0.f;
  for (int i = tid; i < L; i += kThreads) {
    rsum[i] = 0.f;
    rkey[i] = repro::float_order_key(1.f);
    next_dep[i] = kInfSlot;
  }
  for (int i = tid; i < 2 * LP; i += kThreads) snap[i] = 0.f;
  for (int i = tid; i < 32 * NW; i += kThreads) live[i] = 0u;
  __syncthreads();

  if (warp == 1) {
    // ---- the stream and bookkeeping warp --------------------------------
    // Slot u's words: n[u], sizes[u, :A] (as bits), durs[u, :PB], durs[u, LK:LK+A].
    auto fetch = [&](int u, int i) -> int {
      if (i == 0) return n[u];
      if (i <= A) return __float_as_int(sizes[static_cast<size_t>(u) * A + i - 1]);
      const int* du = durs + static_cast<size_t>(u) * D;
      return i <= A + PB ? du[i - 1 - A] : du[LK + i - 1 - A - PB];
    };
    constexpr int kPer = 8;  // words a lane keeps in flight across the chain
    auto prefetch = [&](int u, bool with_occ, int t_occ) {
      int* dst = sbuf + (u & 1) * SW;
      int v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = lane + 32 * j;
        v[j] = i < SW ? fetch(u, i) : 0;
      }
      if (with_occ && lane == 0) occ[t_occ] = chain_sum32(snap + (t_occ & 1) * LP, LP);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int i = lane + 32 * j;
        if (i < SW) dst[i] = v[j];
      }
      for (int i = lane + 32 * kPer; i < SW; i += 32) dst[i] = fetch(u, i);
    };
    if (T > 0) prefetch(0, false, 0);
    repro::named_barrier(kSlotBarrier, kThreads);
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) {
        prefetch(t + 1, t >= 1, t - 1);
      } else if (t >= 1 && lane == 0) {
        occ[t - 1] = chain_sum32(snap + ((t - 1) & 1) * LP, LP);
      }
      repro::named_barrier(kSlotBarrier, kThreads);
    }
    if (T > 0 && lane == 0) occ[T - 1] = chain_sum32(snap + ((T - 1) & 1) * LP, LP);
    return;
  }

  // ---- the decision warp -------------------------------------------------
  repro::named_barrier(kSlotBarrier, kThreads);
  // Counters, the high-water mark and the smallest queued size (as an order
  // key, kNoMinKey for an empty queue; rescanned only after the job that
  // held it left) are uniform across the warp.
  int q_cnt = 0, dropped = 0, n_trunc = 0, hwm = 0;
  unsigned qmin_key = repro::kNoMinKey;
  bool qmin_stale = false;

  // The smallest queued size; a rescan also lowers the high-water mark to
  // just past the last queued job.
  auto queue_min = [&]() -> unsigned {
    if (!qmin_stale) return qmin_key;
    qmin_stale = false;
    unsigned m = repro::kNoMinKey;
    int top = -1;
#pragma unroll 1
    for (int q = lane; q < hwm; q += 32) {
      const float v = queue[q];
      if (v > 0.f) {
        m = min(m, repro::float_order_key(v));
        top = q;
      }
    }
    hwm = __reduce_max_sync(repro::kFullMask, top) + 1;
    qmin_key = __reduce_min_sync(repro::kFullMask, m);
    return qmin_key;
  };

  // Lowest live freed server whose residual takes the smallest queued job
  // (L if none); freed servers that cannot leave the live mask.
  auto first_fit_freed = [&](unsigned qmin_key) -> int {
    int c = L;
#pragma unroll 1
    for (int w = 0; w < NW && c == L; ++w) {
      unsigned m = live[w * 32 + lane];
      while (m) {
        const int b = __ffs(m) - 1;
        const int l = (w * 32 + b) * 32 + lane;
        if (qmin_key != repro::kNoMinKey && rkey[l] >= qmin_key) { c = l; break; }
        m &= m - 1;
        live[w * 32 + lane] &= ~(1u << b);
      }
    }
    return __reduce_min_sync(repro::kFullMask, c);
  };

#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    const int* sb = sbuf + (t & 1) * SW;
    const float* sb_sizes = reinterpret_cast<const float*>(sb + 1);
    const int* sb_bfs = sb + 1 + A;
    const int* sb_bfj = sb_bfs + PB;

    // 1. departures: a lane per owned row whose next departure is due; the
    // lanes walk their due rows together
    int my_dep = 0;
    bool any_freed = false;
#pragma unroll 1
    for (int w = 0; w < NW; ++w) {
      unsigned due = 0u, fm = 0u;
#pragma unroll 8
      for (int b = 0; b < 32; ++b) {
        const int l = (w * 32 + b) * 32 + lane;
        if (l < L && next_dep[l] == t) due |= 1u << b;
      }
      while (due) {
        const int b = __ffs(due) - 1;
        due &= due - 1;
        const int l = (w * 32 + b) * 32 + lane;
        float* row = srv + l * KP;
        int* drow = dep + l * KP;
        int c = 0, nd = kInfSlot;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const int dk = drow[k];
          if (dk == t) {
            row[k] = 0.f;
            drow[k] = kInfSlot;
            ++c;
          } else if (dk > t && dk < nd) {
            nd = dk;
          }
        }
        next_dep[l] = nd;
        if (c) {
          const float rs = chain_sum(row, K);
          rsum[l] = rs;
          rkey[l] = repro::float_order_key(1.f - rs);
          fm |= 1u << b;
          my_dep += c;
        }
      }
      freed[w * 32 + lane] = fm;
      live[w * 32 + lane] = fm;
      any_freed |= fm != 0u;
    }
    const int n_dep = __reduce_add_sync(repro::kFullMask, my_dep);
    bool bfs_live = __any_sync(repro::kFullMask, any_freed);

    // 2. arrivals -> first empty queue slots, in queue order
    const int n_t = sb[0];
    const int want = min(n_t, A);
    int n_landed = 0;
    if (want > 0) {
      int base = 0, last = -1;
      unsigned newmin = repro::kNoMinKey;
#pragma unroll 1
      for (int q0 = 0; q0 < Qcap && base < want; q0 += 32) {
        const int q = q0 + lane;
        const bool empty = q < Qcap && queue[q] == 0.f;
        int cnt;
        const int r = base + repro::warp_rank(empty, cnt);
        if (empty && r < want) {
          const float sz = sb_sizes[r];
          queue[q] = sz;
          newpos[r] = q;
          last = q;
          newmin = min(newmin, repro::float_order_key(sz));
        }
        base += cnt;
      }
      n_landed = min(want, base);
      hwm = max(hwm, __reduce_max_sync(repro::kFullMask, last) + 1);
      qmin_key = min(qmin_key, __reduce_min_sync(repro::kFullMask, newmin));
      __syncwarp();
    }
    dropped += n_t - n_landed;
    q_cnt += n_landed;

    // One job onto server s: first empty slot, slot 0 when the row is full
    // (the engines' argmax-of-all-False quirk); the row sum is recomputed.
    // When no job sits after the slot, the new chain is the old sum + size.
    auto place = [&](int s, float size, int qidx, int dur) {
      float* row = srv + s * KP;
      const float rs_old = rsum[s];
      const int nd_old = next_dep[s];
      int slot = K;
      bool tail = false;  // a job sits after the chosen slot
#pragma unroll 1
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        const float v = k < K ? row[k] : 0.f;
        const unsigned zb = __ballot_sync(repro::kFullMask, k < K && v == 0.f);
        const unsigned nzb = __ballot_sync(repro::kFullMask, k < K && v != 0.f);
        if (slot == K && zb) {
          const int b = __ffs(zb) - 1;
          slot = k0 + b;
          tail = b < 31 && (nzb >> (b + 1)) != 0u;
        } else if (slot < K) {
          tail = tail || nzb != 0u;
        }
      }
      const bool full = slot == K;
      if (full) slot = 0;
      if (lane == 0) {
        row[slot] = size;
        const int dd = add_wrap(t, dur);
        dep[s * KP + slot] = dd;
        if (dd > t && dd < nd_old) next_dep[s] = dd;
        queue[qidx] = 0.f;
        const float rs = full || tail ? chain_sum(row, K) : rs_old + size;
        rsum[s] = rs;
        rkey[s] = repro::float_order_key(1.f - rs);
      }
      // an overwrite can lower a row sum: a freed server takes part again
      if (full) {
        const int at = ((s >> 5) >> 5) * 32 + (s & 31), bit = (s >> 5) & 31;
        if ((freed[at] >> bit) & 1u) {
          if (lane == (s & 31)) live[at] |= 1u << bit;
          bfs_live = true;
        }
      }
      __syncwarp();
      --q_cnt;
      qmin_stale = qmin_stale || repro::float_order_key(size) == qmin_key;
    };

    // 3+4. BF-S then BF-J as one bounded placement work list.
    int dc = 0, a_ptr = 0;
    bool done = false;
#pragma unroll 1
    for (int step = 0; step < W; ++step) {
      int cur = L;
      if (bfs_live) {
        cur = first_fit_freed(queue_min());
        bfs_live = cur < L;
      }
      if (cur == L && a_ptr >= n_landed) { done = true; break; }
      if (cur < L) {
        // BF-S: largest queued job that fits server `cur`, lowest index.
        const unsigned rck = rkey[cur];
        unsigned bk = repro::kNoMaxKey;
        int bi = 0x7fffffff;
#pragma unroll 1
        for (int q = lane; q < hwm; q += 32) {
          const float v = queue[q];
          const unsigned k = repro::float_order_key(v);
          if (v > 0.f && k <= rck && k > bk) { bk = k; bi = q; }
        }
        unsigned best;
        const int qi = repro::warp_argmax_key(bk, bi, best);
        const int didx = dc++;
        const int dur = didx < PB ? sb_bfs[didx]
                                  : durs[static_cast<size_t>(t) * D + min(didx, D - 1)];
        place(cur, repro::order_key_float(best), qi, dur);
      } else {
        // BF-J: tightest feasible server for the next landed arrival (a
        // job BF-S already took has size 0 and is skipped).
        const int a = a_ptr++;
        const int pos = newpos[a];
        const float sz = queue[pos];
        if (sz > 0.f) {
          const unsigned ksz = repro::float_order_key(sz);
          unsigned bk = repro::kNoMinKey;
          int bi = L;
#pragma unroll 8
          for (int i = 0; i < (L + 31) / 32; ++i) {
            const int l = i * 32 + lane;
            const unsigned k = l < L ? rkey[l] : 0u;
            if (k >= ksz && k < bk) { bk = k; bi = l; }
          }
          unsigned best;
          const int s = repro::warp_argmin_key(bk, bi, best);
          if (best != repro::kNoMinKey) place(s, sz, pos, sb_bfj[a]);
        }
      }
    }

    // saturation check: a placement the unbounded policy would still make
    // => the bounded list cut this slot short.
    if (!done) {
      const unsigned qk = queue_min();
      bool pend = false;
      unsigned rk = repro::kNoMaxKey;
#pragma unroll 1
      for (int w = 0; w < NW; ++w) {
        unsigned m = live[w * 32 + lane];
        while (m) {
          const int l = (w * 32 + __ffs(m) - 1) * 32 + lane;
          if (qk != repro::kNoMinKey && rkey[l] >= qk) pend = true;
          m &= m - 1;
        }
      }
#pragma unroll 1
      for (int l = lane; l < L; l += 32) rk = max(rk, rkey[l]);
      const float rmax = repro::order_key_float(__reduce_max_sync(repro::kFullMask, rk));
#pragma unroll 1
      for (int a = a_ptr + lane; a < n_landed; a += 32) {
        const float sz = queue[newpos[a]];
        if (sz > 0.f && sz <= rmax) pend = true;
      }
      n_trunc += __any_sync(repro::kFullMask, pend) ? 1 : 0;
    }

    // the slot's row sums for the occupancy warp, then the slot's outputs
    float* sn = snap + (t & 1) * LP;
#pragma unroll 1
    for (int l = lane; l < L; l += 32) sn[l] = rsum[l];
    if (lane == 0) {
      qlen[t] = q_cnt;
      ndep_out[t] = n_dep;
    }
    repro::named_barrier(kSlotBarrier, kThreads);
  }
  if (lane == 0) {
    dropped_out[g] = dropped;
    trunc_out[g] = n_trunc;
  }
}

}  // namespace

extern "C" size_t bfjs_shared_bytes(int L, int K, int Qcap, int A) {
  return bfjs_smem_bytes(L, K, Qcap, A);
}

extern "C" int bfjs_launch(const int* n, const float* sizes, const int* durs, int G, int T, int L,
                           int K, int Qcap, int A, int W, int* qlen, float* occ, int* ndep,
                           int* dropped, int* truncated, void* stream) {
  const size_t smem = bfjs_smem_bytes(L, K, Qcap, A);
  cudaError_t err = cudaFuncSetAttribute(bfjs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bfjs_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, sizes, durs, T, L, K, Qcap, A, W, qlen, occ, ndep, dropped, truncated);
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
