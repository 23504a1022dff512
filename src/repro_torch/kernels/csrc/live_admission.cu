// Live admission: the serving engine's BF-J/S controller, one launch a call.
//
// Not a port of a Pallas kernel: the JAX package runs this controller
// (src/repro/serving/live.py) as four jitted XLA programs.  The module exists
// so that each controller call (admit, refill, release, tick, push_front)
// is ONE device call and only the placement vector comes back to the host.
// BF-S is a data-dependent loop (place the largest fitting queued job until
// none fits), which torch ops could keep on the device only with a host
// round trip a pick; this kernel keeps the whole loop in one launch.
//
// State, in device memory between calls (int32 grid units, RES = 2**16):
//   residual (L)      free units of each replica
//   q_rid, q_size     (Qcap) the FIFO queue, lane 0 the head, live lanes first
//   q_len, dropped, invalid   counters
// One thread block stages it in shared memory, runs the op, and writes it
// back.  Every op follows the JAX steps lane for lane:
//   * BF-J (admit): each live arrival lane in order goes to the replica of
//     least residual among those with residual >= size, lowest index on
//     ties; none feasible: appended to the queue, or counted in `dropped`
//     when the queue is full.
//   * BF-S (refill, tick): on a replica, repeatedly take the queued lane of
//     greatest size among those that fit (lanes < q_len, size <= residual),
//     the lowest lane on ties (first maximum); removing lane p shifts lanes
//     p.. left by one, lane Qcap - 1 taking the old lane 0 (a roll, as
//     jnp.roll does).
//   * release: each live event adds its size to its replica when the
//     replica exists, size >= 0 and the sum stays <= RES; otherwise the
//     event is counted in `invalid` (the host raises on its next read).
//   * tick: all releases first, then BF-S on every replica an event named,
//     in ascending replica order.
//   * push_front: roll the queue right by one and put the job at lane 0;
//     on a full queue the tail lane falls off and is counted in `dropped`.
// Arithmetic on the residuals wraps as int32 does in XLA.
//
// Reductions take order-preserving 32-bit keys of the int32 values and the
// lowest-index helpers of reduce.cuh (a thread's strided elements, then a
// warp's `redux.sync`, then the warps' results on every warp).
//
// `out` receives [count, q_len, dropped, invalid] after the op, then the
// op's lanes: admit writes the A placements (-1: queued, dropped or masked);
// refill and tick write the placed request ids (Qcap lanes) and their
// replicas (Qcap lanes), -1 past `count`.
#include <climits>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

using repro::kNoMaxKey;
using repro::kNoMinKey;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRes = 1 << 16;
constexpr int kHeader = 4;

enum Op { kAdmit = 0, kRefill = 1, kRelease = 2, kTick = 3, kPushFront = 4 };

struct Args {
  int op;
  int* residual;
  int* q_rid;
  int* q_size;
  int* q_len;
  int* dropped;
  int* invalid;
  int L, Qcap;
  const int* ev;  // (3, A): admit (rid, size, live); release, tick (replica, size, live)
  int A;
  int a0, a1;     // refill: replica; push_front: rid, size
  int* out;
};

__device__ __forceinline__ unsigned int_key(int v) {
  return static_cast<unsigned>(v) ^ 0x80000000u;
}

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

struct Shared {
  unsigned key[kWarps];
  int idx[kWarps];
  int q_len, dropped, invalid, count;
};

// Lowest index among the block's least (kMin) or greatest keys; every thread
// gets the result.  Threads offering nothing pass idx = INT_MAX.
template <bool kMin>
__device__ int block_arg(unsigned key, int idx, Shared& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned best;
  int at = kMin ? repro::warp_argmin_key(key, idx, best)
                : repro::warp_argmax_key(key, idx, best);
  if (lane == 0) {
    s.key[warp] = best;
    s.idx[warp] = at;
  }
  __syncthreads();
  const unsigned k = lane < kWarps ? s.key[lane] : (kMin ? kNoMinKey : kNoMaxKey);
  const int i = lane < kWarps ? s.idx[lane] : INT_MAX;
  at = kMin ? repro::warp_argmin_key(k, i, best) : repro::warp_argmax_key(k, i, best);
  __syncthreads();  // s.key and s.idx are free again
  return at;
}

// BF-S on replica r: place the largest fitting queued lane until none fits.
__device__ void refill(int r, int* res, int* qr, int* qs, const Args& a, Shared& s) {
  const int tid = threadIdx.x, Q = a.Qcap;
  while (true) {
    const int cap = res[r], n = s.q_len;
    unsigned key = kNoMaxKey;
    int idx = INT_MAX;
    bool any = false;
    for (int i = tid; i < Q; i += kThreads) {
      const bool fits = i < n && qs[i] <= cap;
      any |= fits;
      const unsigned k = int_key(fits ? qs[i] : -1);
      if (i == tid || k > key) {
        key = k;
        idx = i;
      }
    }
    if (!__syncthreads_or(any)) break;
    const int pick = block_arg<false>(key, idx, s);
    const int size = qs[pick], rid = qr[pick], r0 = qr[0], s0 = qs[0];
    __syncthreads();  // every thread has read the lanes the shift rewrites
    for (int base = pick; base < Q; base += kThreads) {
      const int i = base + tid;
      int vr = 0, vs = 0;
      if (i < Q) {
        vr = i + 1 < Q ? qr[i + 1] : r0;
        vs = i + 1 < Q ? qs[i + 1] : s0;
      }
      __syncthreads();
      if (i < Q) {
        qr[i] = vr;
        qs[i] = vs;
      }
      __syncthreads();
    }
    if (tid == 0) {
      res[r] = wrap_add(res[r], -size);
      s.q_len -= 1;
      if (s.count < Q) {
        a.out[kHeader + s.count] = rid;
        a.out[kHeader + Q + s.count] = r;
      }
      s.count += 1;
    }
    __syncthreads();
  }
}

// The events' releases, by one thread in lane order; marks freed replicas.
__device__ void release(int* res, int* freed, const Args& a, Shared& s) {
  for (int j = 0; j < a.A; ++j) {
    const int rep = a.ev[j], size = a.ev[a.A + j];
    const bool live = a.ev[2 * a.A + j] != 0;
    const bool known = rep >= 0 && rep < a.L;
    const int at = rep < 0 ? 0 : (rep >= a.L ? a.L - 1 : rep);
    const bool ok = live && known && size >= 0 && wrap_add(res[at], size) <= kRes;
    if (ok) res[at] = wrap_add(res[at], size);
    s.invalid += live && !ok;
    if (freed != nullptr && live && known) freed[rep] = 1;
  }
}

__global__ void __launch_bounds__(kThreads) live_admission_kernel(Args a) {
  extern __shared__ int smem[];
  int* res = smem;               // L
  int* freed = res + a.L;        // L
  int* qr = freed + a.L;         // Qcap
  int* qs = qr + a.Qcap;         // Qcap
  __shared__ Shared s;
  const int tid = threadIdx.x, L = a.L, Q = a.Qcap;

  for (int i = tid; i < L; i += kThreads) {
    res[i] = a.residual[i];
    freed[i] = 0;
  }
  for (int i = tid; i < Q; i += kThreads) {
    qr[i] = a.q_rid[i];
    qs[i] = a.q_size[i];
  }
  const int lanes = a.op == kAdmit ? a.A : (a.op == kRefill || a.op == kTick ? 2 * Q : 0);
  for (int i = tid; i < lanes; i += kThreads) a.out[kHeader + i] = -1;
  if (tid == 0) {
    s.q_len = *a.q_len;
    s.dropped = *a.dropped;
    s.invalid = *a.invalid;
    s.count = 0;
  }
  __syncthreads();

  if (a.op == kAdmit) {
    for (int j = 0; j < a.A; ++j) {
      if (a.ev[2 * a.A + j] == 0) continue;  // masked lane: placement -1
      const int rid = a.ev[j], size = a.ev[a.A + j];
      unsigned key = kNoMinKey;
      int idx = INT_MAX;
      bool any = false;
      for (int i = tid; i < L; i += kThreads) {
        const bool feas = res[i] >= size;
        any |= feas;
        const unsigned k = feas ? int_key(res[i]) : int_key(INT_MAX);
        if (i == tid || k < key) {
          key = k;
          idx = i;
        }
      }
      any = __syncthreads_or(any);
      const int best = block_arg<true>(key, idx, s);
      if (tid == 0) {
        if (any) {
          res[best] = wrap_add(res[best], -size);
          a.out[kHeader + j] = best;
        } else if (s.q_len < Q) {
          qr[s.q_len] = rid;
          qs[s.q_len] = size;
          s.q_len += 1;
        } else {
          s.dropped += 1;
        }
      }
      __syncthreads();
    }
  } else if (a.op == kRefill) {
    refill(a.a0, res, qr, qs, a, s);
  } else if (a.op == kRelease) {
    if (tid == 0) release(res, nullptr, a, s);
    __syncthreads();
  } else if (a.op == kTick) {
    if (tid == 0) release(res, freed, a, s);
    __syncthreads();
    for (int r = 0; r < L; ++r)
      if (freed[r]) refill(r, res, qr, qs, a, s);
  } else if (a.op == kPushFront) {
    const int n = s.q_len;
    for (int top = Q - 1; top >= 1; top -= kThreads) {
      const int i = top - tid;
      int vr = 0, vs = 0;
      if (i >= 1) {
        vr = qr[i - 1];
        vs = qs[i - 1];
      }
      __syncthreads();
      if (i >= 1) {
        qr[i] = vr;
        qs[i] = vs;
      }
      __syncthreads();
    }
    if (tid == 0) {
      qr[0] = a.a0;
      qs[0] = a.a1;
      s.dropped += n >= Q;
      s.q_len = n + 1 < Q ? n + 1 : Q;
    }
    __syncthreads();
  }

  for (int i = tid; i < L; i += kThreads) a.residual[i] = res[i];
  for (int i = tid; i < Q; i += kThreads) {
    a.q_rid[i] = qr[i];
    a.q_size[i] = qs[i];
  }
  if (tid == 0) {
    *a.q_len = s.q_len;
    *a.dropped = s.dropped;
    *a.invalid = s.invalid;
    a.out[0] = s.count;
    a.out[1] = s.q_len;
    a.out[2] = s.dropped;
    a.out[3] = s.invalid;
  }
}

}  // namespace

extern "C" int live_admission_shared_bytes(int L, int Qcap) {
  return static_cast<int>(sizeof(int)) * (2 * L + 2 * Qcap);
}

extern "C" int live_admission_launch(int op, int* residual, int* q_rid, int* q_size, int* q_len,
                                     int* dropped, int* invalid, int L, int Qcap, const int* ev,
                                     int A, int a0, int a1, int* out, void* stream) {
  const Args a{op, residual, q_rid, q_size, q_len, dropped, invalid, L, Qcap, ev, A, a0, a1, out};
  const int smem = live_admission_shared_bytes(L, Qcap);
  cudaError_t err = cudaFuncSetAttribute(live_admission_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  live_admission_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
