// Reductions shared by the scheduler kernels.
//
// Warp-wide helpers: called by all 32 lanes of one warp, they return the
// result to every lane and need no barrier; on sm_80+ a 32-bit min or max is
// one `redux.sync`.  Arg-reductions break ties to the lowest index, as the
// JAX engines' min-of-masked-iota selections do.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

// 32-bit key whose unsigned order is the order of the float `f` (not NaN).
// -0.0 takes the key of +0.0, since the two compare equal.  The keys of NaN
// bit patterns, 0 and 0xffffffff among them, are free to mark "no value".
__device__ __forceinline__ unsigned float_order_key(float f) {
  unsigned u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float of a key.  It also inverts the bijective form of the key (the
// one above without its -0.0 line): every bit pattern, -0.0 and NaN too.
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
