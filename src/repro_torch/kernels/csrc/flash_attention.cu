// Causal / sliding-window GQA flash attention (forward) on Hopper.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py).  For batch b,
// query head h and kv head h / G:
//
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / G, j] * scale, masked) @ v
//
// with key j valid when j <= i (causal) and j > i - window (window > 0);
// invalid keys score -1e30.
//
// What bounds it here: operations.  At S = 2048 and hd = 128 each query
// row meets ~S/2 keys, ~4 hd operations each, against 4 hd bytes of q and
// out: hundreds of operations per byte.  This first version computes in
// float32 on the CUDA cores (the TPU kernel casts both operands to float32
// before each dot), not on the tensor cores, so it runs far from the
// bf16 tensor-core bound; wgmma or mma.sync on bf16 tiles is later work.
// The design: one thread block per (b, h, 64-query tile), 16 x 16 threads,
// each thread owning a 4 x 4 block of the 64 x 64 score tile and 4 rows x
// HD/16 columns of the output accumulator in registers.  The query tile
// stays in shared memory (transposed, padded against bank conflicts); each
// 64-key tile of kv head h / G is staged through shared memory once per
// query tile, so K and V are never replicated per query head.  Key tiles
// that the causal or window mask hides in full are skipped, with the TPU
// kernel's tile rule; partly masked tiles use the same masks and constants.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attention.cuh"

namespace {

constexpr int kBQ = 64;   // query rows per block
constexpr int kBK = 64;   // keys per tile
constexpr int kThreads = 256;
constexpr int kQS = kBQ + 1;  // row strides, padded so transposed stores
constexpr int kKS = kBK + 1;  // and per-row reads avoid bank conflicts
constexpr int kPS = kBK + 1;
constexpr int kRows = kBQ / 16;  // query rows per thread: ty + 16 i
constexpr int kCols = kBK / 16;  // keys per thread: tx + 16 j

__host__ __device__ constexpr size_t shared_floats(int HD) {
  return static_cast<size_t>(HD) * kQS + static_cast<size_t>(HD) * kKS +
         static_cast<size_t>(kBK) * HD + static_cast<size_t>(kBQ) * kPS;
}

// HD: the head dim padded up to a multiple of 16 (zero-filled in shared
// memory, so padded dims add exact zeros to every dot).
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H, int KV, int Sq,
                       int Sk, int hd, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qT = smem;              // qT[d * kQS + r]
  float* kT = qT + HD * kQS;     // kT[d * kKS + c]
  float* vs = kT + HD * kKS;     // vs[c * HD + d]
  float* ps = vs + kBK * HD;     // ps[r * kPS + c]
  constexpr int kDims = HD / 16;  // output dims per thread: tx + 16 j

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* qb = q + static_cast<size_t>(bh) * Sq * hd;
  const size_t kv0 = (static_cast<size_t>(b) * KV + kvh) * static_cast<size_t>(Sk) * hd;
  const T* kb = k + kv0;
  const T* vb = v + kv0;
  T* ob = out + static_cast<size_t>(bh) * Sq * hd;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < Sq && d < hd) x = repro::to_float(qb[static_cast<size_t>(q0 + r) * hd + d]);
    qT[d * kQS + r] = x;
  }

  float m[kRows], l[kRows], acc[kRows][kDims];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = repro::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
  }

  // Key tiles that run, by the TPU kernel's rule: causal skips a tile that
  // starts past the query tile's last row (q0 + kBQ - 1); a window skips a
  // tile whose last key is <= q0 - window.
  int kt_lo = 0, kt_hi = (Sk - 1) / kBK;
  if (causal) kt_hi = min(kt_hi, (q0 + kBQ - 1) / kBK);
  if (window > 0) {
    const int first_key = q0 - window + 1;
    if (first_key > 0) kt_lo = first_key / kBK;
  }

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      float kx = 0.f, vx = 0.f;
      if (k0 + c < Sk && d < hd) {
        const size_t at = static_cast<size_t>(k0 + c) * hd + d;
        kx = repro::to_float(kb[at]);
        vx = repro::to_float(vb[at]);
      }
      kT[d * kKS + c] = kx;
      vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = qT[d * kQS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = kT[d * kKS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax per row; a row's 64 scores sit in the 16 lanes of one
    // half-warp (same ty)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = -CUDART_INF_F;  // keys past Sk do not exist
        if (col < Sk) {
          bool ok = !causal || row >= col;
          if (window > 0) ok = ok && col > row - window;
          x = ok ? s[i][j] * scale : repro::kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = repro::group_max<16>(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float e = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPS + tx + 16 * j] = e;
        sum += e;
      }
      sum = repro::group_sum<16>(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kDims; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        const float vv = vs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kDims; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) ob[static_cast<size_t>(row) * hd + d] = repro::from_float<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
           int Sq, int Sk, int hd, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = shared_floats(HD) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), H, KV, Sq, Sk, hd, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
             int Sq, int Sk, int hd, int causal, int window, float scale, cudaStream_t s) {
  if (hd <= 16) return launch<T, 16>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
  if (hd <= 32) return launch<T, 32>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
  if (hd <= 64) return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
  if (hd <= 128) return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
  if (hd <= 256) return launch<T, 256>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), out (B, H, Sq, hd): contiguous,
// all of one type (bf16 != 0: bfloat16, else float32).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KV, int Sq, int Sk, int hd,
                                      int causal, int window, float scale, int bf16,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
  return dispatch<float>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
