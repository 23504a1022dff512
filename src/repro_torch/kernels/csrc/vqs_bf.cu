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
// What bounds it here: like the VQS kernel, a latency chain of block-wide
// reductions — one placement per step, and one block argmin per arrival
// still queued after the serve pass — far above its bytes and operations.
// The TPU kernel kept three (L, K) planes and three (2J, Qcap) rings in
// VMEM (342 KB at the slice's shape, over the 227 KB a block may use).
// Here (vqs_common.cuh) the steps read per-server aggregates in shared
// memory — next departure slot, occupancy, resident jobs in total and per
// type (16-bit), configuration (k_1, j*, k_{j*}), flags, subscriptions — and
// the (L, K) job planes live in a per-member global workspace, touched only
// by departures and placements.  The rings (sizes, durations, sequence
// stamps) stay in shared memory when they fit and move to the workspace
// otherwise.  The TPU pop reduced over every one of the 2J x Qcap lanes;
// here one warp per bucket scans only up to the bucket's high-water mark
// (pushes fill the lowest hole, so every live entry lies below it) and the
// per-bucket winners are combined in bucket order.  It takes every J the
// grid allows (2 <= J <= 16) and K < 65536.
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "vqs_common.cuh"

namespace {

using namespace vqsk;

__host__ Layout vqs_bf_layout(int J, int L, int K, int Qcap, int A) {
  const size_t nvq = 2 * J;
  const size_t fixed = (4 * J - 4) * nvq + 7 * static_cast<size_t>(L) +
                       (static_cast<size_t>(L) * nvq + 1) / 2 + 9 * nvq +
                       7 * static_cast<size_t>(A);
  return split_layout(fixed, 3 * nvq * Qcap, L, K);
}

struct MinLL {
  __device__ long long operator()(long long a, long long b) const { return a < b ? a : b; }
};

// Block-wide broadcast slots.
enum Bc : int { kArrived, kQtot, kHx, kRK1, kRJs, kRKs, kDo1, kDoJ, kJsx, kResid, kNumBc };

// Pop order: larger size, then smaller sequence stamp, then lower position.
__device__ __forceinline__ bool pops_before(int e, int s, int q, int be, int bs, int bq) {
  return e > be || (e == be && (s < bs || (s == bs && q < bq)));
}

// minBlocks = 1 lets ptxas use up to 65536 / kThreads registers; without
// it, ptxas held this kernel to 64 and spilled.
__global__ void __launch_bounds__(kThreads, 1)
vqs_bf_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
              const int* __restrict__ durs, const int* __restrict__ confs_in, int T, int J,
              int L, int K, int Qcap, int A, int D, int W, unsigned char* __restrict__ ws,
              size_t ws_stride, int rings_in_smem, int* __restrict__ qlen,
              float* __restrict__ occ_out, int* __restrict__ ndep_out,
              int* __restrict__ dropped_out, int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) int smem[];
  __shared__ int redi[32];
  __shared__ long long redl[32];
  __shared__ int bc[kNumBc];

  const int nvq = 2 * J, C = 4 * J - 4;
  int* confs = smem;                // (C, 2J) K_RED
  int* next_dep = confs + C * nvq;  // per server (L each) ...
  int* occ = next_dep + L;
  int* njobs = occ + L;
  int* cfg_js = njobs + L;
  int* cfg_ks = cfg_js + L;
  int* flags = cfg_ks + L;
  unsigned* want = reinterpret_cast<unsigned*>(flags + L);  // subscriptions
  unsigned short* tcnt = reinterpret_cast<unsigned short*>(flags + 2 * L);  // (L, 2J)
  int* qcnt = flags + 2 * L + (L * nvq + 1) / 2;  // per queue (2J each) ...
  int* hw = qcnt + nvq;        // high-water mark: live entries lie below
  int* row_min = hw + nvq;     // smallest queued size
  int* best_e = row_min + nvq;  // the bucket's pop candidate
  int* best_s = best_e + nvq;
  int* best_q = best_s + nvq;
  int* a_cnt = best_q + nvq;   // this slot's arrivals of the type
  int* a_off = a_cnt + nvq;    // arrivals of lower types
  int* a_found = a_off + nvq;  // of them, how many found an empty slot
  int* a_vq = a_found + nvq;   // per arrival lane (A each) ...
  int* a_eff = a_vq + A;
  int* a_dur = a_eff + A;
  int* a_rank = a_dur + A;
  int* a_pos = a_rank + A;
  int* a_land = a_pos + A;
  int* epos = a_land + A;      // empty ring slots found, grouped by type

  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const size_t g = blockIdx.x;
  const size_t ring_words = static_cast<size_t>(nvq) * Qcap;
  const JobPlanes jp = job_planes(ws + g * ws_stride, L, K, 3 * ring_words, rings_in_smem);
  int* srv = jp.srv;
  int* dep = jp.dep;
  signed char* vqof = jp.vqof;
  int* ring_eff = rings_in_smem ? epos + A : jp.rings;
  int* ring_dur = ring_eff + ring_words;
  int* ring_seq = ring_dur + ring_words;
  n += g * T;
  sizes += g * T * A;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ_out += g * T;
  ndep_out += g * T;

  for (int i = tid; i < C * nvq; i += nt) confs[i] = confs_in[i];
  for (int l = tid; l < L; l += nt) {
    next_dep[l] = kInfSlot;
    occ[l] = njobs[l] = cfg_ks[l] = want[l] = 0;
    cfg_js[l] = -1;
    flags[l] = kInEmpty;  // all servers start empty
  }
  for (int i = tid; i < L * nvq; i += nt) tcnt[i] = 0;
  for (int j = tid; j < nvq; j += nt) qcnt[j] = hw[j] = 0;
  for (size_t i = tid; i < static_cast<size_t>(L) * K; i += nt) {
    srv[i] = 0;
    dep[i] = kInfSlot;
    vqof[i] = -1;
  }
  for (size_t i = tid; i < ring_words; i += nt) {
    ring_eff[i] = 0;
    ring_dur[i] = 1;
    ring_seq[i] = 0;
  }
  __syncthreads();

  // Counters of thread 0, written out at the end; the sequence counter is
  // the same in every thread.
  int dropped = 0, n_trunc = 0, seq_ctr = 0;

  // One job onto the first empty slot of server s (warp 0, result of lane
  // 0): resident aggregates follow; a full row places nothing.
  auto place = [&](int s, int e, int d, int v, int t) {
    int* row = srv + static_cast<size_t>(s) * K;
    const int k = warp_first_free(row, K);
    if (lane == 0) {
      if (k < K) {
        const int dd = add_wrap(t, d);
        row[k] = e;
        dep[static_cast<size_t>(s) * K + k] = dd;
        vqof[static_cast<size_t>(s) * K + k] = static_cast<signed char>(v);
        occ[s] += e;
        ++njobs[s];
        ++tcnt[s * nvq + v];
        if (dd > t) next_dep[s] = min(next_dep[s], dd);
      } else {
        ++n_trunc;  // K-overflow: the popped job is not placed
      }
      flags[s] &= ~kInEmpty;
    }
  };

  for (int t = 0; t < T; ++t) {
    // 1. departures: scan a server's row only when its next departure is due
    int my_dep = 0;
    for (int l = tid; l < L; l += nt) {
      int f = flags[l] & kSlotFlags;
      if (next_dep[l] == t) {
        int* row = srv + static_cast<size_t>(l) * K;
        int* drow = dep + static_cast<size_t>(l) * K;
        signed char* vrow = vqof + static_cast<size_t>(l) * K;
        int nd = kInfSlot, c = 0, out = 0;
        for (int k = 0; k < K; ++k) {
          const int dk = drow[k];
          if (dk == t) {
            out += row[k];
            --tcnt[l * nvq + vrow[k]];
            row[k] = 0;
            drow[k] = kInfSlot;
            vrow[k] = -1;
            ++c;
          } else if (dk > t && dk < nd) {
            nd = dk;
          }
        }
        occ[l] -= out;
        njobs[l] -= c;
        next_dep[l] = nd;
        my_dep += c;
        f |= kFreed;
      }
      if (njobs[l] == 0) f |= kEmptyNow;
      flags[l] = f;
    }
    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());

    // 2. arrivals: classify one lane per thread; the r-th arrival of a type
    // takes the r-th empty slot of its bucket (a warp per bucket finds them)
    const int n_t = n[t];
    classify_arrivals(sizes + static_cast<size_t>(t) * A, durs + static_cast<size_t>(t) * D, n_t,
                      A, D, J, a_vq, a_eff, a_dur);
    __syncthreads();
    for (int a = tid; a < A; a += nt) {
      const int v = a_vq[a];
      int rank = 0;
      for (int b = 0; b < a; ++b) rank += a_vq[b] == v;
      a_rank[a] = rank;
    }
    for (int j = tid; j < nvq; j += nt) {
      int c = 0, o = 0;
      for (int b = 0; b < A; ++b) {
        const int v = a_vq[b];
        c += v == j;
        o += v >= 0 && v < j;
      }
      a_cnt[j] = c;
      a_off[j] = o;
    }
    __syncthreads();
    for (int j = warp; j < nvq; j += nt >> 5) {
      const int c = a_cnt[j];
      const int* re = ring_eff + static_cast<size_t>(j) * Qcap;
      int base = 0;
      for (int q0 = 0; q0 < Qcap && base < c; q0 += 32) {
        const int q = q0 + lane;
        const bool empty = q < Qcap && re[q] == 0;
        const unsigned b = __ballot_sync(repro::kFullMask, empty);
        const int r = base + __popc(b & ((1u << lane) - 1));
        if (empty && r < c) epos[a_off[j] + r] = q;
        base += __popc(b);
      }
      if (lane == 0) a_found[j] = min(base, c);
    }
    __syncthreads();
    for (int a = tid; a < A; a += nt) {
      const int v = a_vq[a];
      const int land = v >= 0 && a_rank[a] < a_found[v];
      int pos = 0;
      if (land) {
        pos = epos[a_off[v] + a_rank[a]];
        const size_t at = static_cast<size_t>(v) * Qcap + pos;
        ring_eff[at] = a_eff[a];
        ring_dur[at] = a_dur[a];
        ring_seq[at] = seq_ctr + a;
      }
      a_land[a] = land;
      a_pos[a] = pos;
    }
    if (tid == 0) {
      unsigned arrived = 0;
      int qtot = 0;
      for (int j = 0; j < nvq; ++j) {
        const int c = a_cnt[j], found = a_found[j];
        if (c > 0) arrived |= 1u << j;  // every sampled arrival wakes
        if (found > 0) hw[j] = max(hw[j], epos[a_off[j] + found - 1] + 1);
        qcnt[j] += found;
        dropped += c - found;
        qtot += qcnt[j];
      }
      bc[kArrived] = static_cast<int>(arrived);
      bc[kQtot] = qtot;
    }
    __syncthreads();
    const int slot_seq = seq_ctr;
    seq_ctr += A;

    // 3. visit set
    visit_pass(flags, want, L, static_cast<unsigned>(bc[kArrived]), bc[kQtot]);

    // 4. work list: at most W+1 one-placement steps
    bool done = false;
    for (int step = 0; step <= W; ++step) {
      for (int j = warp; j < nvq; j += nt >> 5) {
        // a warp per bucket: the smallest queued size of bucket j
        const int* re = ring_eff + static_cast<size_t>(j) * Qcap;
        int m = kInf32;
        for (int q = lane; q < hw[j]; q += 32) {
          const int e = re[q];
          if (e > 0 && e < m) m = e;
        }
        m = warp_min(m);
        if (lane == 0) row_min[j] = m;
      }
      if (warp == 0) {
        const unsigned hx = __ballot_sync(repro::kFullMask, lane < nvq && qcnt[lane] > 0);
        const int r = max_weight_row(confs, qcnt, C, nvq);
        if (lane == 0) {
          const int js = first_other_type(confs + r * nvq, nvq);
          bc[kHx] = static_cast<int>(hx);
          bc[kRK1] = confs[r * nvq + 1] > 0;
          bc[kRJs] = js;
          bc[kRKs] = js >= 0 ? confs[r * nvq + js] : 0;
        }
      }
      __syncthreads();
      const unsigned hx = static_cast<unsigned>(bc[kHx]);
      const int r_k1 = bc[kRK1], r_js = bc[kRJs], r_ks = bc[kRKs];
      int glob_min = kInf32;
      for (int j = 0; j < nvq; ++j) glob_min = min(glob_min, row_min[j]);

      auto view = [&](int l, int f, int& k1, int& js, int& ks, bool& has1, bool& k1_can,
                      bool& js_can, bool& any_can, int& cnt_js, int& resid) {
        const bool ren = (f & kRenew) && !(f & kTouched);
        k1 = ren ? r_k1 : (f & kK1) != 0;
        js = ren ? r_js : cfg_js[l];
        ks = ren ? r_ks : cfg_ks[l];
        resid = kCap - occ[l];
        has1 = tcnt[l * nvq + 1] > 0;
        cnt_js = js >= 0 ? tcnt[l * nvq + js] : 0;
        k1_can = k1 && !has1 && row_min[1] <= resid;
        js_can = js >= 0 && cnt_js < ks && row_min[js] <= resid;
        any_can = glob_min <= resid;
        return ren;
      };

      // pass 1: the placer is the lowest pending server that can place
      int key = L + 1;
      for (int l = tid; l < L; l += nt) {
        const int f = flags[l];
        if (!(f & kVisit) || (f & kAdvanced)) continue;
        int k1, js, ks, cnt_js, resid;
        bool has1, k1_can, js_can, any_can;
        view(l, f, k1, js, ks, has1, k1_can, js_can, any_can, cnt_js, resid);
        key = min(key, (k1_can || js_can || any_can) ? l : L);
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
        int k1, js, ks, cnt_js, resid;
        bool has1, k1_can, js_can, any_can;
        const bool ren = view(l, f, k1, js, ks, has1, k1_can, js_can, any_can, cnt_js, resid);
        if (ren) {
          f = r_k1 ? (f | kK1) : (f & ~kK1);
          cfg_js[l] = r_js;
          cfg_ks[l] = r_ks;
        }
        if (!(f & kTouched) && (f & kEmptyNow)) f |= kInEmpty;  // first touch
        f |= kHasCfg | kTouched;
        if (l < placer) {
          f |= kAdvanced;
          unsigned w = want[l];
          if (k1 && !has1 && !((hx >> 1) & 1)) w |= 2u;
          if (js >= 0 && cnt_js < ks && !((hx >> js) & 1)) w |= 1u << js;
          want[l] = w;
        } else {
          bc[kDo1] = k1_can;
          bc[kDoJ] = !k1_can && js_can;
          bc[kJsx] = max(js, 0);
          bc[kResid] = resid;
        }
        flags[l] = f;
      }
      __syncthreads();
      if (placer == L) continue;  // every pending server was advanced

      // serve the placer: each allowed bucket's warp finds its largest
      // entry <= the residual (FIFO among equals) ...
      const int do1 = bc[kDo1], doj = bc[kDoJ], jsx = bc[kJsx], cap = bc[kResid];
      for (int j = warp; j < nvq; j += nt >> 5) {
        int be = 0, bs = kInf32, bq = kInf32;
        if (do1 ? j == 1 : (!doj || j == jsx)) {
          const int* re = ring_eff + static_cast<size_t>(j) * Qcap;
          const int* rs = ring_seq + static_cast<size_t>(j) * Qcap;
          for (int q = lane; q < hw[j]; q += 32) {
            const int e = re[q];
            if (e > 0 && e <= cap && pops_before(e, rs[q], q, be, bs, bq)) {
              be = e;
              bs = rs[q];
              bq = q;
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const int oe = __shfl_xor_sync(repro::kFullMask, be, off);
          const int os = __shfl_xor_sync(repro::kFullMask, bs, off);
          const int oq = __shfl_xor_sync(repro::kFullMask, bq, off);
          if (pops_before(oe, os, oq, be, bs, bq)) {
            be = oe;
            bs = os;
            bq = oq;
          }
        }
        if (lane == 0) {
          best_e[j] = be;
          best_s[j] = bs;
          best_q[j] = bq;
        }
      }
      __syncthreads();
      // ... and the largest wins, lowest bucket on ties (warp 0 pops it)
      if (warp == 0) {
        int bj = -1, be = 0;
        for (int j = 0; j < nvq; ++j) {
          if (best_e[j] > be) {
            be = best_e[j];
            bj = j;
          }
        }
        if (bj >= 0) {
          const size_t at = static_cast<size_t>(bj) * Qcap + best_q[bj];
          place(placer, be, ring_dur[at], bj, t);
          if (lane == 0) {
            ring_eff[at] = 0;
            --qcnt[bj];
          }
        }
      }
      __syncthreads();
    }
    // step bound hit with servers still unserved: the slot finished lazily
    if (!done) n_trunc += any_pending(flags, L, redi);

    // 5. arrival-side BF-J pass, lane by lane: an arrival still in its
    // bucket (same sequence stamp) goes to the tightest feasible server
    for (int a = 0; a < A; ++a) {
      if (!a_land[a]) continue;
      const int v = a_vq[a], e = a_eff[a];
      const size_t at = static_cast<size_t>(v) * Qcap + a_pos[a];
      if (!(ring_eff[at] > 0 && ring_seq[at] == slot_seq + a)) continue;
      long long best = 0x7fffffffffffffffLL;
      for (int l = tid; l < L; l += nt) {
        const int r = kCap - occ[l];
        if (r >= e) best = min(best, (static_cast<long long>(r) << 32) | l);
      }
      best = repro::block_reduce(best, redl, MinLL());
      if (best == 0x7fffffffffffffffLL) continue;  // fits no server
      if (warp == 0) {
        place(static_cast<int>(best & 0xffffffff), e, a_dur[a], v, t);
        if (lane == 0) {
          ring_eff[at] = 0;
          --qcnt[v];
        }
      }
      __syncthreads();
    }

    write_slot(occ, qcnt, L, nvq, n_dep, redi, qlen + t, occ_out + t, ndep_out + t);
  }
  if (tid == 0) {
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
  const Layout lay = vqs_bf_layout(J, L, K, Qcap, A);
  cudaError_t err = cudaFuncSetAttribute(
      vqs_bf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(lay.shared_bytes));
  if (err != cudaSuccess) return err;
  vqs_bf_kernel<<<G, kThreads, lay.shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      n, sizes, durs, confs, T, J, L, K, Qcap, A, D, W, static_cast<unsigned char*>(ws),
      lay.workspace_bytes, lay.rings_in_smem, qlen, occ, ndep, dropped, truncated);
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
