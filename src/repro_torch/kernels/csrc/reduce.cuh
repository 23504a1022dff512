// Reductions shared by the scheduler kernels.
//
// The block-wide arg-reduction: called by all threads of the block with the
// same arguments in the same order, it returns the result to all of them and
// ends with __syncthreads(), so its scratch may be reused by the next call
// and shared-memory writes made before the call are visible after it.
// Warp-wide helpers (below it): called by all 32 lanes of one warp,
// they return the result to every lane and need no barrier; on sm_80+ a
// 32-bit min or max is one `redux.sync`.  Arg-reductions break ties to the
// lowest index, as the JAX engines' min-of-masked-iota selections do.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// (value, index) pair: lowest value wins, then lowest index.
__device__ __forceinline__ bool lower_pair(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// (value, index) pair: highest value wins, then lowest index.
__device__ __forceinline__ bool higher_pair(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

template <bool kMin>
__device__ __forceinline__ void block_arg(float& v, int& i, float* redf, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (kMin ? lower_pair(ov, oi, v, i) : higher_pair(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { redf[warp] = v; redi[warp] = i; }
  __syncthreads();
  v = redf[0];
  i = redi[0];
  for (int w = 1; w < nwarps; ++w) {
    if (kMin ? lower_pair(redf[w], redi[w], v, i) : higher_pair(redf[w], redi[w], v, i)) {
      v = redf[w];
      i = redi[w];
    }
  }
  __syncthreads();
}

// ---- warp-wide --------------------------------------------------------------

// 32-bit key whose unsigned order is the order of the float `f` (not NaN).
// -0.0 takes the key of +0.0, since the two compare equal.  The keys of NaN
// bit patterns, 0 and 0xffffffff among them, are free to mark "no value".
__device__ __forceinline__ unsigned float_order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr unsigned kNoMinKey = 0xffffffffu;  // offered by lanes with nothing, to a min
constexpr unsigned kNoMaxKey = 0u;           // ... to a max

// Lowest index among the lanes that hold the warp's least key; `best`
// receives that key (kNoMinKey when no lane offered one).
__device__ __forceinline__ int warp_argmin_key(unsigned key, int idx, unsigned& best) {
  best = __reduce_min_sync(kFullMask, key);
  return static_cast<int>(
      __reduce_min_sync(kFullMask, key == best ? static_cast<unsigned>(idx) : 0xffffffffu));
}

// Lowest index among the lanes that hold the warp's greatest key.
__device__ __forceinline__ int warp_argmax_key(unsigned key, int idx, unsigned& best) {
  best = __reduce_max_sync(kFullMask, key);
  return static_cast<int>(
      __reduce_min_sync(kFullMask, key == best ? static_cast<unsigned>(idx) : 0xffffffffu));
}

// Exclusive prefix count of `pred` over the lanes below this one; `total`
// receives the warp's count.
__device__ __forceinline__ int warp_rank(bool pred, int& total) {
  const unsigned b = __ballot_sync(kFullMask, pred);
  total = __popc(b);
  return __popc(b & ((1u << (threadIdx.x & 31)) - 1u));
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `threads` threads, a
// multiple of 32: how two warps of a block meet without stopping the rest.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace repro
