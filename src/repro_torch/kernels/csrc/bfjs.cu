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
// What bounds it here: slot t+1 depends on slot t and placement step s+1 on
// step s, so the time is the chain of T x (steps) block-wide reductions — a
// latency bound; the bytes it must move (the used stream lanes and the
// (G,T) outputs) and its operations take far less.  The TPU kernel ran the
// time-window grid axis in order with state in VMEM; on the card nothing
// carries across blocks, so the loop over every slot sits inside the block
// and the whole state stays in shared memory for the horizon:
//   srv (L,K) f32 and dep (L,K) i32, rows padded to an odd stride so a
//   thread per row touches distinct banks; queue (Qcap) f32; the row sums
//   (L) f32, from which residuals are `1 - rowsum` exactly as the engines
//   compute them; the landed positions (A_max) i32 and freed flags (L).
// Duration lanes are read straight from device memory, only those used
// (durs[t, dc] for BF-S refills, durs[t, L*K + a] for BF-J placements).
// The arrival enqueue is one block-wide prefix count of empty queue slots.
// The work list stops as soon as no BF-S refill and no BF-J attempt is left:
// the remaining steps would change nothing, and the saturation check is then
// false by construction.
//
// Summation order decides placements (residual comparisons are exact), so
// every row sum is a left-to-right float32 chain from srv[l][0], recomputed
// only for rows that changed, and occupancy adds the row sums in ascending
// row order — the order of the plain version.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kInfSlot = 0x7fffffff;

__host__ __device__ inline int padded_stride(int K) { return K | 1; }

__host__ inline size_t bfjs_smem_bytes(int L, int K, int Qcap, int A) {
  const size_t words = 2 * static_cast<size_t>(L) * padded_stride(K) + Qcap + L + A;
  return words * 4 + ((L + 3) / 4) * 4;
}

__device__ __forceinline__ float row_sum(const float* row, int K) {
  float s = row[0];
  for (int k = 1; k < K; ++k) s = s + row[k];
  return s;
}

__global__ void __launch_bounds__(kThreads)
bfjs_kernel(const int* __restrict__ n, const float* __restrict__ sizes,
            const int* __restrict__ durs, int T, int L, int K, int Qcap, int A, int W,
            int* __restrict__ qlen, float* __restrict__ occ, int* __restrict__ ndep,
            int* __restrict__ dropped_out, int* __restrict__ trunc_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KP = padded_stride(K);
  float* srv = reinterpret_cast<float*>(smem);
  int* dep = reinterpret_cast<int*>(srv + static_cast<size_t>(L) * KP);
  float* queue = reinterpret_cast<float*>(dep + static_cast<size_t>(L) * KP);
  float* rsum = queue + Qcap;
  int* newpos = reinterpret_cast<int*>(rsum + L);
  unsigned char* freed = reinterpret_cast<unsigned char*>(newpos + A);
  __shared__ float redf[32];
  __shared__ int redi[32];

  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t g = blockIdx.x;
  const int D = L * K + A;
  n += g * T;
  sizes += g * T * A;
  durs += g * T * static_cast<size_t>(D);
  qlen += g * T;
  occ += g * T;
  ndep += g * T;

  for (int i = tid; i < L * KP; i += nt) { srv[i] = 0.f; dep[i] = kInfSlot; }
  for (int i = tid; i < Qcap; i += nt) queue[i] = 0.f;
  for (int i = tid; i < L; i += nt) { rsum[i] = 0.f; freed[i] = 0; }
  __syncthreads();

  // Counters are uniform across the block: every thread updates them from
  // the same broadcast values.
  int q_cnt = 0, dropped = 0, n_trunc = 0;
  const int chunk = (Qcap + nt - 1) / nt;

  for (int t = 0; t < T; ++t) {
    // 1. departures (a thread per server row)
    int my_dep = 0;
    for (int l = tid; l < L; l += nt) {
      float* row = srv + l * KP;
      int* drow = dep + l * KP;
      int c = 0;
      for (int k = 0; k < K; ++k) {
        if (drow[k] == t) { row[k] = 0.f; drow[k] = kInfSlot; ++c; }
      }
      freed[l] = c > 0;
      if (c) rsum[l] = row_sum(row, K);
      my_dep += c;
    }
    const int n_dep = repro::block_reduce(my_dep, redi, repro::SumI());

    // 2. arrivals -> first empty queue slots: one prefix count of empties
    // over contiguous per-thread chunks, in queue order.
    const int n_t = n[t];
    const int want = min(n_t, A);
    int n_landed = 0;
    if (want > 0) {
      const int lo = min(tid * chunk, Qcap), hi = min(lo + chunk, Qcap);
      int cnt = 0;
      for (int q = lo; q < hi; ++q) cnt += queue[q] == 0.f;
      int total;
      int r = repro::block_exclusive_scan(cnt, redi, total);
      for (int q = lo; q < hi && r < want; ++q) {
        if (queue[q] == 0.f) {
          queue[q] = sizes[static_cast<size_t>(t) * A + r];
          newpos[r] = q;
          ++r;
        }
      }
      n_landed = min(want, total);
      __syncthreads();
    }
    dropped += n_t - n_landed;
    q_cnt += n_landed;

    // 3+4. BF-S then BF-J as one bounded placement work list.
    const int* durs_t = durs + static_cast<size_t>(t) * D;
    int dc = 0, a_ptr = 0;
    bool done = false;
    for (int step = 0; step < W; ++step) {
      float m = CUDART_INF_F;
      for (int q = tid; q < Qcap; q += nt) {
        const float v = queue[q];
        if (v > 0.f && v < m) m = v;
      }
      const float qmin = repro::block_reduce(m, redf, repro::MinF());
      int c = L;
      for (int l = tid; l < L; l += nt) {
        if (freed[l] && 1.f - rsum[l] >= qmin) { c = l; break; }
      }
      const int cur = repro::block_reduce(c, redi, repro::MinI());
      if (cur == L && a_ptr >= n_landed) { done = true; break; }

      int tgt = -1, qidx = 0, didx = 0;
      float size = 0.f;
      if (cur < L) {
        // BF-S: largest queued job that fits server `cur`, lowest index.
        const float rc = 1.f - rsum[cur];
        float bv = -CUDART_INF_F;
        int bi = 0x7fffffff;
        for (int q = tid; q < Qcap; q += nt) {
          const float v = queue[q];
          if (v > 0.f && v <= rc && repro::higher_pair(v, q, bv, bi)) { bv = v; bi = q; }
        }
        repro::block_arg<false>(bv, bi, redf, redi);
        tgt = cur;
        qidx = bi;
        size = bv;
        didx = min(dc, D - 1);
        ++dc;
      } else {
        // BF-J: tightest feasible server for the next landed arrival (a
        // job BF-S already took has size 0 and is skipped).
        const int a = a_ptr++;
        const int pos = newpos[a];
        const float sz = queue[pos];
        if (sz > 0.f) {
          float bv = CUDART_INF_F;
          int bi = 0x7fffffff;
          for (int l = tid; l < L; l += nt) {
            const float r = 1.f - rsum[l];
            if (r >= sz && repro::lower_pair(r, l, bv, bi)) { bv = r; bi = l; }
          }
          repro::block_arg<true>(bv, bi, redf, redi);
          if (bi < L) {
            tgt = bi;
            qidx = pos;
            size = sz;
            didx = L * K + a;
          }
        }
      }
      if (tgt >= 0) {
        if (tid == 0) {
          float* row = srv + tgt * KP;
          int* drow = dep + tgt * KP;
          // first empty slot; slot 0 when the row is full (the engines'
          // argmax-of-all-False quirk)
          int slot = 0;
          for (int k = 0; k < K; ++k) {
            if (row[k] == 0.f) { slot = k; break; }
          }
          row[slot] = size;
          drow[slot] = t + durs_t[didx];
          queue[qidx] = 0.f;
          rsum[tgt] = row_sum(row, K);
        }
        --q_cnt;
        __syncthreads();
      }
    }

    // saturation check: a placement the unbounded policy would still make
    // => the bounded list cut this slot short.
    if (!done) {
      float m = CUDART_INF_F;
      for (int q = tid; q < Qcap; q += nt) {
        const float v = queue[q];
        if (v > 0.f && v < m) m = v;
      }
      const float qmin = repro::block_reduce(m, redf, repro::MinF());
      int pend = 0;
      float rmax = -CUDART_INF_F;
      for (int l = tid; l < L; l += nt) {
        const float r = 1.f - rsum[l];
        if (freed[l] && r >= qmin) pend = 1;
        rmax = fmaxf(rmax, r);
      }
      pend = repro::block_reduce(pend, redi, repro::MaxI());
      rmax = repro::block_reduce(rmax, redf, repro::MaxF());
      for (int a = a_ptr; a < n_landed; ++a) {
        const float sz = queue[newpos[a]];
        if (sz > 0.f && sz <= rmax) pend = 1;
      }
      n_trunc += pend;
    }

    if (tid == 0) {
      float o = rsum[0];
      for (int l = 1; l < L; ++l) o = o + rsum[l];
      occ[t] = o;
      qlen[t] = q_cnt;
      ndep[t] = n_dep;
    }
    __syncthreads();
  }
  if (tid == 0) {
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
