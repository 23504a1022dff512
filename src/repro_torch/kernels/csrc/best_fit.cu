// Sequential Best-Fit placement (the paper's BF-J inner loop) on Hopper.
//
// Replaces the Pallas TPU kernel `_best_fit_kernel`
// (src/repro/kernels/best_fit/best_fit.py).  Each job, in order, goes to the
// feasible server with the least residual capacity, lowest index on ties;
// -1 means rejected (nothing fits, or size <= 0).  The chosen residual
// becomes `r - size` in float32.
//
// What bounds it here: the N placements of one problem form a dependent
// chain, so the time is N block-wide argmin reductions back to back — a
// latency bound, far above both the bytes it moves and the operations it
// does.  The design keeps the chain on chip: one thread block per problem,
// the (L,) residuals in shared memory for the whole chain, each
// placement one strided pass over them plus a warp-shuffle (value, index)
// argmin; independent problems run as separate blocks across the SMs.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 3.4e38f;  // infeasibility sentinel of the TPU kernel

__global__ void __launch_bounds__(kThreads)
best_fit_kernel(const float* __restrict__ resid, const float* __restrict__ sizes,
                int L, int N, int* __restrict__ assign, float* __restrict__ out_resid) {
  extern __shared__ float r[];
  __shared__ float redf[32];
  __shared__ int redi[32];
  const size_t g = blockIdx.x;
  resid += g * L;
  out_resid += g * L;
  sizes += g * N;
  assign += g * N;

  for (int l = threadIdx.x; l < L; l += blockDim.x) r[l] = resid[l];
  __syncthreads();

  for (int j = 0; j < N; ++j) {
    const float size = sizes[j];
    // Key (masked residual, index): an infeasible server is masked to kBig
    // and its index pushed past L, so among equal masked values a feasible
    // server wins — the TPU kernel's `(masked == best) & feasible`.
    float bv = CUDART_INF_F;
    int bi = 0x7fffffff;
    for (int l = threadIdx.x; l < L; l += blockDim.x) {
      const float x = r[l];
      const bool feas = x >= size;
      const float m = feas ? x : kBig;
      const int key = feas ? l : L + l;
      if (repro::lower_pair(m, key, bv, bi)) { bv = m; bi = key; }
    }
    repro::block_arg<true>(bv, bi, redf, redi);
    if (threadIdx.x == 0) {
      const bool ok = bi < L && size > 0.f;
      assign[j] = ok ? bi : -1;
      if (ok) r[bi] = r[bi] - size;
    }
    __syncthreads();
  }
  for (int l = threadIdx.x; l < L; l += blockDim.x) out_resid[l] = r[l];
}

}  // namespace

extern "C" int best_fit_launch(const float* resid, const float* sizes, int G, int L, int N,
                               int* assign, float* out_resid, void* stream) {
  const size_t smem = static_cast<size_t>(L) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(best_fit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  best_fit_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      resid, sizes, L, N, assign, out_resid);
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
