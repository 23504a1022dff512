// Block-wide reductions shared by the scheduler kernels.
//
// Every helper is called by all threads of the block with the same
// arguments in the same order and returns the result to all of them.  Each
// one ends with __syncthreads(), so the scratch `red` may be reused by the
// next call and shared-memory writes made before the call are visible after
// it.  Arg-reductions break ties to the lowest index, as the JAX engines'
// min-of-masked-iota selections do.
#pragma once

#include <cuda_runtime.h>

namespace repro {

constexpr unsigned kFullMask = 0xffffffffu;

struct MinF { __device__ float operator()(float a, float b) const { return fminf(a, b); } };
struct MaxF { __device__ float operator()(float a, float b) const { return fmaxf(a, b); } };
struct MinI { __device__ int operator()(int a, int b) const { return a < b ? a : b; } };
struct MaxI { __device__ int operator()(int a, int b) const { return a > b ? a : b; } };
struct SumI { __device__ int operator()(int a, int b) const { return a + b; } };

template <class T, class Op>
__device__ __forceinline__ T block_reduce(T v, T* red, Op op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(kFullMask, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < nwarps; ++w) r = op(r, red[w]);
  __syncthreads();
  return r;
}

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

// (64-bit key, index) pair: with kMin the lowest key wins, else the
// highest; ties go to the lowest index.
template <bool kMin>
__device__ __forceinline__ bool better_pair64(long long v, int i, long long bv, int bi) {
  return (kMin ? v < bv : v > bv) || (v == bv && i < bi);
}

template <bool kMin>
__device__ __forceinline__ void block_arg64(long long& v, int& i, long long* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const long long ov = __shfl_xor_sync(kFullMask, v, off);
    const int oi = __shfl_xor_sync(kFullMask, i, off);
    if (better_pair64<kMin>(ov, oi, v, i)) { v = ov; i = oi; }
  }
  if (lane == 0) { redv[warp] = v; redi[warp] = i; }
  __syncthreads();
  v = redv[0];
  i = redi[0];
  for (int w = 1; w < nwarps; ++w) {
    if (better_pair64<kMin>(redv[w], redi[w], v, i)) {
      v = redv[w];
      i = redi[w];
    }
  }
  __syncthreads();
}

// Exclusive prefix sum of one int per thread, in thread order; `total`
// receives the block-wide sum.
__device__ __forceinline__ int block_exclusive_scan(int v, int* red, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int base = 0, tot = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) base += red[w];
    tot += red[w];
  }
  __syncthreads();
  total = tot;
  return base + x - v;
}

}  // namespace repro
