// Sequential Best-Fit placement (the paper's BF-J inner loop) on Hopper.
//
// Replaces the Pallas TPU kernel `_best_fit_kernel`
// (src/repro/kernels/best_fit/best_fit.py).  Each job, in order, goes to the
// feasible server (r >= size) with the least residual, lowest index on ties;
// -1 means rejected (nothing fits, or !(size > 0)).  The chosen residual
// becomes `r - size` in float32 and nothing else is written.  The TPU kernel
// masks an infeasible server to kBig = 3.4e38 and keeps a feasible one only
// where its masked value equals the least: a job whose tightest fit lies
// above kBig (an infinite residual, say) is rejected whenever some server is
// infeasible.  This kernel keeps that rule.
//
// What bounds it: the N placements of a problem form a dependent chain, so
// the time is N decisions back to back, a latency far above both the bytes
// the kernel moves and its compares.  The design shortens each link:
//  * residuals are held as order-preserving 32-bit keys (exact_key), in
//    registers: thread t of W warps holds servers [t * S, t * S + S) in its
//    S slots.  A scan subtracts key(size) from every slot, so infeasible
//    servers wrap past every feasible one and one unsigned minimum (an
//    adjacent-pair tree, fully unrolled, lowest slot on ties) finds a
//    thread's tightest fit; one `redux.sync` gives the warp's.  No register is
//    indexed at run time: the owner lane updates its slot by a predicated
//    select.
//  * only the least key travels.  The servers are laid out in blocks, so the
//    lowest index among equal keys is in the lowest warp, lane and slot that
//    hold the key: the lowest warp is read off the exchange, the lowest lane
//    off a ballot, and that lane stores the assignment and updates its slot.
//  * W = 4 warps a problem (a warpgroup, one warp on each SM sub-partition)
//    up to 8192 servers; above that, 8 warps walk the keys in shared memory
//    (up to 58,080 servers: L * 4 bytes + 128 of static shared memory under
//    232,448).  The warps publish (least key, largest key) and meet on a
//    named barrier once a placement, double-buffered, and all take the same
//    minimum.
//  * sizes are loaded 32 at a time, one per lane, a chunk ahead of use, and
//    each job's size is broadcast by shuffle one job early, so the chain
//    never waits on device memory.
//  * a job with !(size > 0), or larger than the largest non-NaN residual, is
//    rejected without a scan.  Residuals only fall, so that maximum is
//    recomputed only when its server is placed (a warp's own maximum reaches
//    the others at the next exchange; until then they test against a stale,
//    larger one, which only costs a scan).
// Build without fast-math: no flush to zero, IEEE subtraction, and keys
// that give every untouched residual back bit for bit (-0.0 and NaN too).
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr float kBig = 3.4e38f;            // infeasibility sentinel of the TPU kernel
constexpr unsigned kKeyInf = 0xff800000u;  // exact_key(+inf); positive NaNs key above it
constexpr int kMaxSlots = 64;              // register keys a lane
constexpr int kGroupWarps = 4;
constexpr int kGroupCap = kGroupWarps * 32 * kMaxSlots;  // servers a warpgroup holds in registers
constexpr int kSharedWarps = 8;                          // warps of the shared-memory route
constexpr int kXchBarrier = 1;

// Bijective order key: the unsigned order of the keys is the order of the
// floats (NaN aside), and unlike repro::float_order_key -0.0 keeps a key of
// its own (one below +0.0), so repro::order_key_float returns every bit
// pattern.  Both zeros and every negative residual key below any size > 0.
__device__ __forceinline__ unsigned exact_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned finite_or_zero(unsigned k) { return k <= kKeyInf ? k : 0u; }

// Lane's least (key - ks) over its S register slots and the lowest slot that
// holds it: adjacent pairs first, so the left operand of every compare holds
// the lower slots and a strict < keeps them on ties.
template <int S>
__device__ __forceinline__ void lane_argmin(const unsigned (&rk)[S], unsigned ks, unsigned& d,
                                            int& slot) {
  unsigned v[S];
  int s[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    v[k] = rk[k] - ks;
    s[k] = k;
  }
#pragma unroll
  for (int h = 1; h < S; h *= 2) {
#pragma unroll
    for (int k = 0; k < S; k += 2 * h) {
      const bool c = v[k + h] < v[k];
      v[k] = c ? v[k + h] : v[k];
      s[k] = c ? s[k + h] : s[k];
    }
  }
  d = v[0];
  slot = s[0];
}

// W warps a problem; S register slots a lane, or S == 0: keys in dynamic
// shared memory.  Thread t = w * 32 + lane holds the servers [t * C, t * C +
// C), C = S (or, in shared memory, the odd C >= L / 32W that spreads a round
// of loads over all banks), so the lowest index among equal keys lies in the
// lowest warp, then the lowest lane, then the lowest slot.
template <int W, int S>
__global__ void __launch_bounds__(32 * W)
best_fit_kernel(const float* __restrict__ resid, const float* __restrict__ sizes, int L, int N,
                int* __restrict__ assign, float* __restrict__ out_resid) {
  extern __shared__ unsigned keys[];
  __shared__ uint2 xch[2][W];  // per warp: (least key - ks, largest finite key), double-buffered
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, me = threadIdx.x;
  const int C = S > 0 ? S : ((L + 32 * W - 1) / (32 * W)) | 1;
  const int base = me * C;  // this thread's first server
  const unsigned kKeyBig = exact_key(kBig);
  const size_t g = blockIdx.x;
  resid += g * L;
  out_resid += g * L;
  sizes += g * N;
  assign += g * N;

  // ---- set-up: keys, and the problem's largest finite, least and largest keys
  unsigned rk[S > 0 ? S : 1];
  unsigned mx = 0u, mn = 0xffffffffu, top = 0u;
  if constexpr (S > 0) {
#pragma unroll
    for (int k = 0; k < S; ++k) {
      const int l = base + k;
      rk[k] = l < L ? exact_key(resid[l]) : 0u;  // padding: below every size, never written
      if (l < L) mn = min(mn, rk[k]);
      top = max(top, rk[k]);
      mx = max(mx, finite_or_zero(rk[k]));
    }
  } else {
    for (int l = base; l < min(base + C, L); ++l) {
      const unsigned k = exact_key(resid[l]);
      keys[l] = k;
      mn = min(mn, k);
      top = max(top, k);
      mx = max(mx, finite_or_zero(k));
    }
  }
  unsigned wmax = __reduce_max_sync(repro::kFullMask, mx);  // this warp's largest finite key
  unsigned gmax = wmax;  // the problem's (a bound on it): the no-scan test
  unsigned gmin = __reduce_min_sync(repro::kFullMask, mn);  // least key: an infeasible server?
  bool nan = __reduce_max_sync(repro::kFullMask, top) > kKeyInf;  // a positive-NaN server?
  if (lane == 0) {
    xch[0][w] = make_uint2(wmax, gmin);
    xch[1][w] = make_uint2(nan, 0u);
  }
  __syncthreads();
  for (int i = 0; i < W; ++i) {
    gmax = max(gmax, xch[0][i].x);
    gmin = min(gmin, xch[0][i].y);
    nan = nan || xch[1][i].x;
  }
  __syncthreads();

  // ---- the chain
  float cur = lane < N ? sizes[lane] : 0.f;  // sizes of jobs [j - j % 32, +32), one a lane
  float nxt = 32 + lane < N ? sizes[32 + lane] : 0.f;
  float size = __shfl_sync(repro::kFullMask, cur, 0);
  int xp = 0;  // exchanges made: picks the buffer
  for (int j = 0; j < N; ++j) {
    if ((j & 31) == 31) {  // next chunk: nxt is read only here, 32 jobs after its load
      asm volatile("mov.b32 %0, %1;" : "=f"(cur) : "f"(nxt));
      nxt = j + 33 + lane < N ? sizes[j + 33 + lane] : 0.f;
    }
    // the next job's size, off the chain (the source lane is (j + 1) % 32: the
    // threadIdx bit keeps the compiler from moving the result to a uniform
    // register at once, which would wait for the shuffle here)
    const float size_n =
        __shfl_sync(repro::kFullMask, cur, ((j + 1) & 31) | (threadIdx.x & 32));
    const unsigned ks = exact_key(size);
    bool placed = false;
    if (size > 0.f && ks <= gmax) {  // else nothing fits: rejected without a scan
      unsigned d;
      int slot;  // this thread's least key - ks (infeasible keys wrap past feasible), its slot
      if constexpr (S > 0) {
        lane_argmin(rk, ks, d, slot);
      } else {
        d = 0xffffffffu;  // a thread with no server offers none
        slot = 0;
        for (int k = 0; k < C && base + k < L; ++k) {  // rising k: a strict < keeps the lowest
          const unsigned v = keys[base + k] - ks;
          if (v < d) {
            d = v;
            slot = k;
          }
        }
      }
      unsigned bd = __reduce_min_sync(repro::kFullMask, d);
      uint2* x = xch[xp++ & 1];
      if (lane == 0) x[w] = make_uint2(bd, wmax);
      repro::named_barrier(kXchBarrier, 32 * W);
      uint2 e[W];
      bd = 0xffffffffu;
      gmax = 0u;
#pragma unroll
      for (int i = 0; i < W; ++i) {
        e[i] = x[i];
        bd = min(bd, e[i].x);
        gmax = max(gmax, e[i].y);
      }
      int first = W;
#pragma unroll
      for (int i = W - 1; i >= 0; --i) first = e[i].x == bd ? i : first;
      const bool mine = w == first;  // this warp holds the tightest server (the lowest if they tie)
      const unsigned bk = bd + ks;  // the tightest key
      // feasible: bk in [ks, key(inf)]; above kBig it loses to an infeasible server
      if (bd <= kKeyInf - ks && (bk <= kKeyBig || (gmin >= ks && !nan))) {
        placed = true;
        // r - size of a feasible r >= size > 0 is +0, positive or (inf - inf) a positive NaN
        const unsigned nk = __float_as_uint(__uint_as_float(bk & 0x7fffffffu) - size) | 0x80000000u;
        gmin = min(gmin, nk);
        nan = nan || nk > kKeyInf;
        if (mine) {  // warp-uniform: the lowest lane holding the key owns the server
          const bool own = lane == __ffs(__ballot_sync(repro::kFullMask, d == bd)) - 1;
          if (own) assign[j] = base + slot;
          if constexpr (S > 0) {
#pragma unroll
            for (int k = 0; k < S; ++k) rk[k] = own && k == slot ? nk : rk[k];
          } else {
            if (own) keys[base + slot] = nk;
          }
          if (bk == wmax) {
            unsigned m = 0u;
            if constexpr (S > 0) {
#pragma unroll
              for (int k = 0; k < S; ++k) m = max(m, finite_or_zero(rk[k]));
            } else {
              for (int l = base; l < min(base + C, L); ++l) m = max(m, finite_or_zero(keys[l]));
            }
            wmax = __reduce_max_sync(repro::kFullMask, m);
          }
        }
      }
    }
    if (!placed && me == 0) assign[j] = -1;
    size = size_n;
  }

  // ---- write back
  if constexpr (S > 0) {
#pragma unroll
    for (int k = 0; k < S; ++k)
      if (base + k < L) out_resid[base + k] = repro::order_key_float(rk[k]);
  } else {
    for (int l = base; l < min(base + C, L); ++l) out_resid[l] = repro::order_key_float(keys[l]);
  }
}

struct Args {
  const float* resid;
  const float* sizes;
  int G, L, N;
  int* assign;
  float* out_resid;
  cudaStream_t stream;
};

template <int W, int S>
cudaError_t launch_as(const Args& a) {
  const size_t smem = S == 0 ? static_cast<size_t>(a.L) * sizeof(unsigned) : 0;
  if (S == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        best_fit_kernel<W, S>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // an L past the shared memory: leave no error for the next launch
      return err;
    }
  }
  best_fit_kernel<W, S><<<a.G, 32 * W, smem, a.stream>>>(a.resid, a.sizes, a.L, a.N, a.assign,
                                                         a.out_resid);
  return cudaGetLastError();
}

// The warpgroup instance with the fewest slots that hold L servers.
cudaError_t launch_registers(const Args& a) {
  const int per_lane = (a.L + 32 * kGroupWarps - 1) / (32 * kGroupWarps);
  if (per_lane <= 8) return launch_as<kGroupWarps, 8>(a);
  if (per_lane <= 16) return launch_as<kGroupWarps, 16>(a);
  if (per_lane <= 32) return launch_as<kGroupWarps, 32>(a);
  return launch_as<kGroupWarps, kMaxSlots>(a);
}

}  // namespace

// A warpgroup over register keys up to 8192 servers, eight warps over keys
// in shared memory above (an L past 58,080 fails on the shared-memory size).
extern "C" int best_fit_launch(const float* resid, const float* sizes, int G, int L, int N,
                               int* assign, float* out_resid, void* stream) {
  const Args a{resid, sizes, G, L, N, assign, out_resid, static_cast<cudaStream_t>(stream)};
  return L <= kGroupCap ? launch_registers(a) : launch_as<kSharedWarps, 0>(a);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
