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
// allows (2 <= J <= 16: the 2J queues fit a 32-bit mask) and any drain.  The trajectory is the one of
// the scan engine (repro_torch/core/engine/vqs.py, the plain version) on
// every field, occupancy included: all arithmetic is integer.
//
// What bounds it here: slot t+1 depends on slot t and step s+1 on step s,
// so the time is the chain of T x (steps) block-wide reductions — a latency
// bound, far above the bytes it must move (counts, arrival sizes and
// durations in; three (G, T) trajectories out).  The TPU kernel kept the
// whole state (three (L, K) planes, two (2J, Qcap) rings) in VMEM; at
// L = 1000, K = 16, 2J = 8, Qcap = 1024 that is 306 KB, over the 227 KB of
// shared memory a block may use.  So the state is split
// (vqs_common.cuh): every step reads only per-server aggregates kept in
// shared memory — next departure slot, occupancy, VQ_1 occupancy, resident
// jobs, j*, flag bits, subscription mask — so the step is O(L / threads);
// the (L, K) job planes sit in a per-member global workspace (L2-resident
// at 128 members) and are touched only by the few departures and
// placements of a slot.  A server's row is scanned for departures only in
// the slot its cached next departure comes due.  The rings stay in shared
// memory when they fit (the slice's shape) and move to the workspace
// otherwise (J = 7, Qcap = 4096), through the same pointers.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "vqs_common.cuh"

namespace {

using namespace vqsk;

__host__ Layout vqs_layout(int J, int L, int K, int Qcap, int A) {
  const size_t nvq = 2 * J;
  const size_t fixed = (4 * J - 4) * nvq + 7 * static_cast<size_t>(L) + 3 * nvq +
                       4 * static_cast<size_t>(A);
  return split_layout(fixed, 2 * nvq * Qcap, L, K);
}

// Block-wide broadcast slots.
enum Bc : int { kArrived, kQtot, kHx, kRK1, kRJs, kDoK1, kJs, kBudget, kNumBc };

__global__ void __launch_bounds__(kThreads)
vqs_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
           const int* __restrict__ durs, const int* __restrict__ confs_in, int T, int J, int L,
           int K, int Qcap, int A, int D, int W, int P, unsigned char* __restrict__ ws,
           size_t ws_stride, int rings_in_smem, int* __restrict__ qlen,
           float* __restrict__ occ_out, int* __restrict__ ndep_out,
           int* __restrict__ dropped_out, int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int redi[32];
  __shared__ int bc[kNumBc];

  const int nvq = 2 * J, C = 4 * J - 4;
  int* confs = smem;                // (C, 2J) K_RED
  int* next_dep = confs + C * nvq;  // per server (L each) ...
  int* occ = next_dep + L;          // resident effective size
  int* occ1 = occ + L;              // ... of VQ_1 jobs
  int* njobs = occ1 + L;
  int* cfg_js = njobs + L;
  int* flags = cfg_js + L;
  unsigned* want = reinterpret_cast<unsigned*>(flags + L);  // subscriptions
  int* head = flags + 2 * L;        // per queue (2J each) ...
  int* qcnt = head + nvq;
  int* head_eff = qcnt + nvq;       // size at the head of each ring
  int* a_vq = head_eff + nvq;       // per arrival lane (A each) ...
  int* a_eff = a_vq + A;
  int* a_dur = a_eff + A;
  int* a_land = a_dur + A;

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;
  const size_t ring_words = static_cast<size_t>(nvq) * Qcap;
  const JobPlanes jp = job_planes(ws + g * ws_stride, L, K, 2 * ring_words, rings_in_smem);
  int* srv = jp.srv;
  int* dep = jp.dep;
  signed char* vqof = jp.vqof;
  int* ring_eff = rings_in_smem ? a_land + A : jp.rings;
  int* ring_dur = ring_eff + ring_words;
  n += g * T;
  sizes += g * T * A;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ_out += g * T;
  ndep_out += g * T;

  for (int i = tid; i < C * nvq; i += nt) confs[i] = confs_in[i];
  for (int l = tid; l < L; l += nt) {
    next_dep[l] = kInfSlot;
    occ[l] = occ1[l] = njobs[l] = want[l] = 0;
    cfg_js[l] = -1;
    flags[l] = kInEmpty;  // all servers start empty
  }
  for (int j = tid; j < nvq; j += nt) head[j] = qcnt[j] = 0;
  for (size_t i = tid; i < static_cast<size_t>(L) * K; i += nt) {
    srv[i] = 0;
    dep[i] = kInfSlot;
    vqof[i] = -1;
  }
  for (size_t i = tid; i < ring_words; i += nt) {
    ring_eff[i] = 0;
    ring_dur[i] = 1;
  }
  __syncthreads();

  // Counters of thread 0, written out at the end.
  int dropped = 0, n_trunc = 0;

  for (int t = 0; t < T; ++t) {
    // 1. departures: scan a server's row only when its next departure is due
    int my_dep = 0;
    for (int l = tid; l < L; l += nt) {
      int f = flags[l] & kSlotFlags;
      if (next_dep[l] == t) {
        int* row = srv + static_cast<size_t>(l) * K;
        int* drow = dep + static_cast<size_t>(l) * K;
        signed char* vrow = vqof + static_cast<size_t>(l) * K;
        int nd = kInfSlot, c = 0, out = 0, out1 = 0;
        for (int k = 0; k < K; ++k) {
          const int dk = drow[k];
          if (dk == t) {
            const int e = row[k];
            out += e;
            if (vrow[k] == 1) out1 += e;
            row[k] = 0;
            drow[k] = kInfSlot;
            vrow[k] = -1;
            ++c;
          } else if (dk > t && dk < nd) {
            nd = dk;
          }
        }
        occ[l] -= out;
        occ1[l] -= out1;
        njobs[l] -= c;
        next_dep[l] = nd;
        my_dep += c;
        f |= kFreed;
      }
      if (njobs[l] == 0) f |= kEmptyNow;
      flags[l] = f;
    }
    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());

    // 2. arrivals: classify one lane per thread, then append each landed
    // arrival at its ring's tail in lane order
    const int n_t = n[t];
    classify_arrivals(sizes + static_cast<size_t>(t) * A, durs + static_cast<size_t>(t) * D, n_t,
                      A, D, J, a_vq, a_eff, a_dur);
    __syncthreads();
    for (int a = tid; a < A; a += nt) {
      const int v = a_vq[a];
      int land = 0;
      if (v >= 0) {
        int rank = 0;
        for (int b = 0; b < a; ++b) rank += a_vq[b] == v;
        const int cnt = qcnt[v];
        land = cnt + rank < Qcap;
        if (land) {
          const size_t at = static_cast<size_t>(v) * Qcap + (head[v] + cnt + rank) % Qcap;
          ring_eff[at] = a_eff[a];
          ring_dur[at] = a_dur[a];
        }
      }
      a_land[a] = land;
    }
    __syncthreads();
    if (tid == 0) {
      unsigned arrived = 0;
      int qtot = 0;
      for (int a = 0; a < A; ++a) {
        const int v = a_vq[a];
        if (v < 0) continue;
        arrived |= 1u << v;  // every sampled arrival wakes its subscribers
        if (a_land[a]) {
          ++qcnt[v];
        } else {
          ++dropped;
        }
      }
      for (int j = 0; j < nvq; ++j) qtot += qcnt[j];
      bc[kArrived] = static_cast<int>(arrived);
      bc[kQtot] = qtot;
    }
    __syncthreads();

    // 3. visit set
    visit_pass(flags, want, L, static_cast<unsigned>(bc[kArrived]), bc[kQtot]);

    // 4. work list: at most W+1 steps, stopping once nothing is pending
    bool done = false;
    for (int step = 0; step <= W; ++step) {
      if (warp == 0) {
        // shared step values: ring heads, non-empty queues, and the
        // renewal candidate of the current queue sizes
        if (lane < nvq) head_eff[lane] = ring_eff[static_cast<size_t>(lane) * Qcap + head[lane] % Qcap];
        const unsigned hx = __ballot_sync(repro::kFullMask, lane < nvq && qcnt[lane] > 0);
        const int r = max_weight_row(confs, qcnt, C, nvq);
        if (lane == 0) {
          bc[kHx] = static_cast<int>(hx);
          bc[kRK1] = confs[r * nvq + 1] > 0;
          bc[kRJs] = first_other_type(confs + r * nvq, nvq);
        }
      }
      __syncthreads();
      const unsigned hx = static_cast<unsigned>(bc[kHx]);
      const int r_k1 = bc[kRK1], r_js = bc[kRJs];

      // The effective configuration of pending server l and whether it can
      // place (identical in both passes below).
      auto view = [&](int l, int f, int& k1, int& js, bool& has1, bool& k1_can, bool& js_ex,
                      bool& js_can, int& ocap, int& other) {
        const bool ren = (f & kRenew) && !(f & kTouched);
        k1 = ren ? r_k1 : (f & kK1) != 0;
        js = ren ? r_js : cfg_js[l];
        const int o = occ[l], o1 = occ1[l];
        const int resid = kCap - o;
        other = o - o1;
        ocap = k1 ? kCap - kReserve : kCap;
        has1 = o1 > 0;
        k1_can = k1 && !has1 && ((hx >> 1) & 1) && head_eff[1] <= resid;
        js_ex = js >= 0 && ((hx >> js) & 1);
        js_can = js_ex && other + head_eff[js] <= ocap;
        return ren;
      };

      // pass 1: the placer is the lowest pending server that can place;
      // key L means "pending, none can place", L+1 "nothing pending"
      int key = L + 1;
      for (int l = tid; l < L; l += nt) {
        const int f = flags[l];
        if (!(f & kVisit) || (f & kAdvanced)) continue;
        int k1, js, ocap, other;
        bool has1, k1_can, js_ex, js_can;
        view(l, f, k1, js, has1, k1_can, js_ex, js_can, ocap, other);
        key = min(key, (k1_can || js_can) ? l : L);
      }
      key = repro::block_reduce(key, redi, repro::MinI());
      if (key > L) {
        done = true;
        break;
      }
      const int placer = key;

      // pass 2: touch every pending server up to the placer, advance past
      // the ones below it
      for (int l = tid; l < L && l <= placer; l += nt) {
        int f = flags[l];
        if (!(f & kVisit) || (f & kAdvanced)) continue;
        int k1, js, ocap, other;
        bool has1, k1_can, js_ex, js_can;
        const bool ren = view(l, f, k1, js, has1, k1_can, js_ex, js_can, ocap, other);
        if (ren) {
          f = r_k1 ? (f | kK1) : (f & ~kK1);
          cfg_js[l] = r_js;
        }
        // _empty membership at FIRST touch only
        if (!(f & kTouched) && (f & kEmptyNow)) f |= kInEmpty;
        f |= kHasCfg | kTouched;
        if (l < placer) {
          f |= kAdvanced;
          unsigned w = want[l];
          if (k1 && !has1 && !((hx >> 1) & 1)) w |= 2u;
          if (js >= 0 && !js_ex) w |= 1u << js;
          want[l] = w;
        } else {
          bc[kDoK1] = k1_can;
          bc[kJs] = js;
          bc[kBudget] = ocap - other;
        }
        flags[l] = f;
      }
      __syncthreads();

      // serve the placer (warp 0): one reserved VQ_1 job, or the longest
      // head-of-VQ_{j*} prefix of at most P jobs that fits the budget,
      // 32 ring entries at a time (sizes are >= 1, so the sums only grow)
      if (placer < L && warp == 0) {
        const int do_k1 = bc[kDoK1];
        const int j = do_k1 ? 1 : max(bc[kJs], 0);
        const int budget = bc[kBudget];
        const int* re = ring_eff + static_cast<size_t>(j) * Qcap;
        const int* rd = ring_dur + static_cast<size_t>(j) * Qcap;
        const int h = head[j];
        int m = 1;
        if (!do_k1) {
          const int avail = min(P, qcnt[j]);
          int base = 0;
          m = 0;
          for (int q0 = 0; q0 < avail; q0 += 32) {
            const int q = q0 + lane;
            int cum = q < avail ? re[(h + q) % Qcap] : 0;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
              const int y = __shfl_up_sync(repro::kFullMask, cum, off);
              if (lane >= off) cum += y;
            }
            cum += base;
            const unsigned b = __ballot_sync(repro::kFullMask, q < avail && cum <= budget);
            m += __popc(b);
            if (b != repro::kFullMask) break;
            base = __shfl_sync(repro::kFullMask, cum, 31);
          }
        }

        // the p-th job goes to the p-th empty slot of the row
        int* row = srv + static_cast<size_t>(placer) * K;
        int* drow = dep + static_cast<size_t>(placer) * K;
        signed char* vrow = vqof + static_cast<size_t>(placer) * K;
        int free_cnt = 0, add = 0, placed = 0, mind = kInfSlot;
        for (int k0 = 0; k0 < K; k0 += 32) {
          const int k = k0 + lane;
          const bool empty = k < K && row[k] == 0;
          const unsigned b = __ballot_sync(repro::kFullMask, empty);
          const int r = free_cnt + __popc(b & ((1u << lane) - 1));
          if (empty && r < m) {
            const int er = re[(h + r) % Qcap];
            const int dr = rd[(h + r) % Qcap];
            const int dd = add_wrap(t, dr);
            row[k] = er;
            drow[k] = dd;
            vrow[k] = static_cast<signed char>(j);
            add += er;
            ++placed;
            if (dd > t) mind = min(mind, dd);
          }
          free_cnt += __popc(b);
        }
        add = warp_sum(add);
        placed = warp_sum(placed);
        mind = warp_min(mind);
        if (lane == 0) {
          occ[placer] += add;
          if (j == 1) occ1[placer] += add;
          njobs[placer] += placed;
          next_dep[placer] = min(next_dep[placer], mind);
          head[j] += m;
          qcnt[j] -= m;
          if (m > 0) flags[placer] &= ~kInEmpty;
          n_trunc += max(m - free_cnt, 0);  // K-overflow
        }
      }
      __syncthreads();
    }
    // step bound hit with servers still unserved: the slot finished lazily
    if (!done) n_trunc += any_pending(flags, L, redi);

    write_slot(occ, qcnt, L, nvq, n_dep, redi, qlen + t, occ_out + t, ndep_out + t);
  }
  if (tid == 0) {
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
  const Layout lay = vqs_layout(J, L, K, Qcap, A);
  cudaError_t err = cudaFuncSetAttribute(vqs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.shared_bytes));
  if (err != cudaSuccess) return err;
  vqs_kernel<<<G, kThreads, lay.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      n, sizes, durs, confs, T, J, L, K, Qcap, A, D, W, P, static_cast<unsigned char*>(ws),
      lay.workspace_bytes, lay.rings_in_smem, qlen, occ, ndep, dropped, truncated);
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
