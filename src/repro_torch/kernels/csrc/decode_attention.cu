// One-token GQA decode attention over a linear KV cache, on Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention/decode_attention.py).  For row b and
// query head h = kv * G + g:
//
//   out[b, h] = softmax_c(q[b, h] . k[b, kv, c] * scale, masked) @ v[b, kv]
//
// where cache row c is valid when c <= pos[b] (and c > pos[b] - window when
// window > 0); invalid rows score -1e30.  `pos` is one int32 per row — the
// TPU kernel's scalar `pos` under the serving engine's per-request vmap.
//
// What bounds it here: bytes.  Each valid cache row is read once and used
// for G = H / KV query heads (4 for llama3-8b), two operations per element
// per head, so the work is ~2G operations per 2-byte element: far below the
// card's ~295 operations per byte.  The design reads each valid row once:
// one thread block per (b, kv head) holds the G queries of that kv head in
// shared memory and streams the cache in chunks of kChunk rows (contiguous
// in the (B, KV, C, hd) layout) through shared memory in 16-byte vectors,
// with an online softmax per head: one thread per (head, row) for the
// scores, one per (head, pair of dims) for p @ v.  Chunks past pos[b], and
// before the window, are skipped: with the -1e30 masking they add exactly
// nothing (see attention.cuh).  Still simple: one block per (b, kv head)
// leaves most SMs idle at small batch, and a chunk's loads are not
// overlapped with the previous chunk's arithmetic.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attention.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;  // cache rows per pass

// 16-byte vectors a cache row of hd elements of `elt` bytes takes in shared
// memory: rounded up to 1 (mod 8), so the rows start 4 banks apart and the
// 32 lanes of a warp reading one vector of 32 consecutive rows need only
// the 4 wavefronts that 512 bytes take.
__host__ __device__ inline int row_vectors(int hd, int elt) {
  const int vecs = hd * elt / 16;
  return vecs + ((9 - vecs % 8) % 8);
}

// Floats before the cache chunk: q and acc (G, hd), scores (G, kChunk),
// running max, sum and correction (G); rounded up to 16 bytes.
__host__ __device__ inline size_t float_words(int G, int hd) {
  const size_t n = 2 * static_cast<size_t>(G) * hd + static_cast<size_t>(G) * kChunk +
                   3 * static_cast<size_t>(G);
  return (n + 3) / 4 * 4;
}

__host__ __device__ inline size_t shared_bytes(int G, int hd, int elt) {
  return float_words(G, hd) * sizeof(float) +
         2 * static_cast<size_t>(kChunk) * row_vectors(hd, elt) * 16;
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p);
template <>
__device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Needs hd * sizeof(T) % 16 == 0 and 16-byte aligned k and v (the wrapper
// checks both).
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int H, int KV, int C, int hd, int window,
                        float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kVec = 16 / sizeof(T);
  const int G = H / KV;
  const int vecs = hd / kVec;                       // 16-byte vectors in a row
  const int row_vecs = row_vectors(hd, sizeof(T));  // and in a padded smem row
  float* q_s = reinterpret_cast<float*>(smem);      // (G, hd)
  float* acc_s = q_s + G * hd;                      // (G, hd)
  float* s_s = acc_s + G * hd;                      // (G, kChunk): scores, then p
  float* m_s = s_s + G * kChunk;                    // (G)
  float* l_s = m_s + G;                             // (G)
  float* corr_s = l_s + G;                          // (G)
  uint4* k_s = reinterpret_cast<uint4*>(smem) + float_words(G, hd) / 4;  // (kChunk, row_vecs)
  uint4* v_s = k_s + kChunk * row_vecs;                                  // (kChunk, row_vecs)

  const int b = blockIdx.x / KV, kvh = blockIdx.x % KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G;
  const T* qb = q + head0 * hd;  // the G query heads of this kv head, contiguous
  T* ob = out + head0 * hd;
  const size_t cache0 = (static_cast<size_t>(b) * KV + kvh) * static_cast<size_t>(C) * hd;
  const uint4* kb = reinterpret_cast<const uint4*>(k + cache0);
  const uint4* vb = reinterpret_cast<const uint4*>(v + cache0);

  for (int i = tid; i < G * hd; i += kThreads) {
    q_s[i] = repro::to_float(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = repro::kNegInf;
    l_s[g] = 0.f;
  }

  // Rows [lo, hi] hold every valid entry.  With none valid, every row is
  // masked and the TPU kernel returns the plain mean of v over the whole
  // cache (each p = exp(0)); walking all rows reproduces that.
  const int p = pos[b];
  int lo = window > 0 ? max(p - window + 1, 0) : 0;
  int hi = min(p, C - 1);
  if (lo > hi) {
    lo = 0;
    hi = C - 1;
  }

  for (int c0 = lo; c0 <= hi; c0 += kChunk) {
    const int rows = min(kChunk, hi - c0 + 1);
    __syncthreads();  // the previous chunk's readers are done
    // the chunk's rows are contiguous in the cache: coalesced 16-byte loads,
    // several in flight per thread, kept in the input type
    const uint4* kc = kb + static_cast<size_t>(c0) * vecs;
    const uint4* vc = vb + static_cast<size_t>(c0) * vecs;
#pragma unroll 4
    for (int i = tid; i < rows * vecs; i += kThreads) {
      const int r = i / vecs, c = i - r * vecs;
      k_s[r * row_vecs + c] = kc[i];
      v_s[r * row_vecs + c] = vc[i];
    }
    __syncthreads();

    // scores: one thread per (head, row); a warp holds one head's 32 rows
    for (int i = tid; i < G * kChunk; i += kThreads) {
      const int g = i / kChunk, r = i - g * kChunk;
      const int c = c0 + r;
      float s = -CUDART_INF_F;  // rows past the chunk's end do not exist
      if (r < rows) {
        const uint4* kr = k_s + r * row_vecs;
        const float* qg = q_s + g * hd;
        float a0 = 0.f, a1 = 0.f;
        for (int t = 0; t < vecs; ++t) {
          float kx[kVec], qx[kVec];
          repro::load16(reinterpret_cast<const T*>(kr + t), kx);
#pragma unroll
          for (int j = 0; j < kVec; j += 4) repro::load16(qg + t * kVec + j, qx + j);
#pragma unroll
          for (int j = 0; j < kVec; j += 2) {
            a0 = fmaf(qx[j], kx[j], a0);
            a1 = fmaf(qx[j + 1], kx[j + 1], a1);
          }
        }
        const bool valid = c <= p && (window == 0 || c > p - window);
        s = valid ? (a0 + a1) * scale : repro::kNegInf;
      }
      s_s[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float* sg = s_s + g * kChunk;
      float mx = -CUDART_INF_F;
      for (int r = lane; r < kChunk; r += 32) mx = fmaxf(mx, sg[r]);
      mx = repro::group_max<32>(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int r = lane; r < kChunk; r += 32) {
        const float e = expf(sg[r] - m_new);
        sg[r] = e;
        sum += e;
      }
      sum = repro::group_sum<32>(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v: one thread per (head, pair of dims)
    const int pairs = hd / 2;
    for (int i = tid; i < G * pairs; i += kThreads) {
      const int g = i / pairs, d = 2 * (i - g * pairs);
      const float* pg = s_s + g * kChunk;
      float a0 = 0.f, a1 = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float2 vv = load2(reinterpret_cast<const T*>(v_s + r * row_vecs) + d);
        a0 = fmaf(pg[r], vv.x, a0);
        a1 = fmaf(pg[r], vv.y, a1);
      }
      const float corr = corr_s[g];
      acc_s[g * hd + d] = acc_s[g * hd + d] * corr + a0;
      acc_s[g * hd + d + 1] = acc_s[g * hd + d + 1] * corr + a1;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * hd; i += kThreads)
    ob[i] = repro::from_float<T>(acc_s[i] / fmaxf(l_s[i / hd], 1e-30f));
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out, int B,
           int H, int KV, int C, int hd, int window, float scale, cudaStream_t stream) {
  const size_t smem = shared_bytes(H / KV, hd, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_attention_kernel<T><<<B * KV, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
      static_cast<T*>(out), H, KV, C, hd, window, scale);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper's gate);
// elt: bytes per element (4 float32, 2 bfloat16).
extern "C" long long decode_attention_shared_bytes(int G, int hd, int elt) {
  return static_cast<long long>(shared_bytes(G, hd, elt));
}

// q (B, H, hd), k and v (B, KV, C, hd), out (B, H, hd): contiguous, all of
// one type (bf16 != 0: bfloat16, else float32); pos (B,) int32.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const int* pos, void* out, int B, int H, int KV,
                                       int C, int hd, int window, float scale, int bf16,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch<__nv_bfloat16>(q, k, v, pos, out, B, H, KV, C, hd, window, scale, s);
  return launch<float>(q, k, v, pos, out, B, H, KV, C, hd, window, scale, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
