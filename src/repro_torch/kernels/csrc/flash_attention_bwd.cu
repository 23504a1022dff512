// Backward of causal / sliding-window GQA flash attention on Hopper.
//
// Replaces no Pallas kernel: the JAX package trains through its jnp
// `chunked_attention` (src/repro/models/attention.py:71-135) and leaves
// its gradient to XLA, so it has no backward kernel.  The port's train
// path runs attention through the flash forward (csrc/flash_attention.cu,
// the counterpart of `_flash_kernel` at
// src/repro/kernels/flash_attention/flash_attention.py:21), and this is
// that forward's gradient.  For batch b, query head h and kv head h / G,
// with P = softmax(scale q k^T) over the visible keys (key j visible to
// query i when j <= i if causal and j > i - window if window > 0),
// D = rowsum(dO * O) and dS = P * (dO V^T - D), zero at masked scores:
//
//   dq = scale dS K,   dk = scale dS^T Q,   dv = P^T dO,
//
// dk and dv summed over the G = H / KV query heads of each kv head.
//
// Two launches, one after the other on the caller's stream:
//
// * dq: a block per (b, h, query tile).  It recomputes each row's max and
//   sum over the visible key tiles (the forward's tile rule), writes the
//   row's log-sum-exp and D, then walks the key tiles again and
//   accumulates dq = scale dS K in registers.
// * dkv: a block per (b, kv head, key tile).  It loops over the group's
//   query heads and the query tiles that see a key of the tile, recomputes
//   P from the saved log-sum-exp, and accumulates dk and dv in registers.
//
// Each output element is summed by one thread in a fixed order: no
// atomics, so two runs on the same inputs give the same bits (a resumed
// training run repeats an uninterrupted one).
//
// What bounds it here: operations.  At llama3-8b's S = 2048, hd = 128
// each query row meets ~S/2 keys, and the five products of a (query, key)
// pair (q k^T, dO V^T, dS K, dS^T Q, P^T dO) are ~10 hd operations
// against a few hd bytes of the row's tensors.  This first design runs
// them in float32 on the CUDA cores (as the forward's CUDA-core instance
// does, 16 x 16 threads with register tiles, tiles staged through shared
// memory transposed and padded by one so the reads are conflict-free) and
// recomputes q k^T in both launches and twice in dq: eight products a
// pair.  It takes float32 or bf16 tensors, hd <= 256 and hd_v <= hd; hd
// is padded to 32, 64, 128, 192 or 256 by zero fill in shared memory,
// which adds exact zeros to every dot.  Tensor cores (wgmma) and TMA
// loads are later speed work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attention.cuh"

namespace bwd {

constexpr int kThreads = 256;  // 16 x 16: thread (ty, tx)

// Shared floats of a block: four (HD x BT) tiles stored dim-major with
// rows padded to BT + 1, two (BT x BT) score tiles and two row vectors.
template <int HD, int BT>
__host__ __device__ constexpr size_t shared_floats() {
  return 4 * static_cast<size_t>(HD) * (BT + 1) + 2 * static_cast<size_t>(BT) * (BT + 1) +
         2 * static_cast<size_t>(BT);
}

// Rows r0 .. r0 + BT of a row-major (nrows, width) matrix into dst[d * (BT
// + 1) + r], zero past nrows and past width up to HD.
template <typename T, int HD, int BT>
__device__ __forceinline__ void load_t(float* dst, const T* src, int r0, int nrows, int width) {
  constexpr int P = BT + 1;
  for (int i = threadIdx.x; i < BT * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (r0 + r < nrows && d < width)
      x = repro::to_float(src[static_cast<size_t>(r0 + r) * width + d]);
    dst[d * P + r] = x;
  }
}

// s[i][j] = sum_d aT[d][ty + 16 i] * bT[d][tx + 16 j] over the HD dims.
template <int HD, int BT>
__device__ __forceinline__ void tile_dot(const float* aT, const float* bT, int ty, int tx,
                                         float (&s)[BT / 16][BT / 16]) {
  constexpr int P = BT + 1, R = BT / 16;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = aT[d * P + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < R; ++j) b[j] = bT[d * P + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ bool visible(int row, int col, int Sq, int Sk, int causal,
                                        int window) {
  bool ok = row < Sq && col < Sk;
  if (causal) ok = ok && row >= col;
  if (window > 0) ok = ok && col > row - window;
  return ok;
}

template <typename T, int HD, int BT>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ out, const T* __restrict__ dout, T* __restrict__ dq,
          float* __restrict__ lse, float* __restrict__ delta, int H, int KV, int Sq, int Sk,
          int hd, int hdv, int causal, int window, float scale) {
  constexpr int P = BT + 1, R = BT / 16, DD = HD / 16;
  extern __shared__ float smem[];
  float* qT = smem;           // qT[d * P + r]
  float* dT = qT + HD * P;    // dO^T
  float* kT = dT + HD * P;
  float* vT = kT + HD * P;
  float* ds = vT + HD * P;    // ds[r * P + c]
  float* rowD = ds + 2 * BT * P;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t qrow = static_cast<size_t>(bh) * Sq;
  const size_t krow = (static_cast<size_t>(b) * KV + kvh) * static_cast<size_t>(Sk);
  const T* kb = k + krow * hd;
  const T* vb = v + krow * hdv;
  const T* ob = out + qrow * hdv;

  load_t<T, HD, BT>(qT, q + qrow * hd, q0, Sq, hd);
  load_t<T, HD, BT>(dT, dout + qrow * hdv, q0, Sq, hdv);
  __syncthreads();

  // D = rowsum(dO * O): a row's 16 lanes (one half-warp) split its dims
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (q0 + r < Sq)
      for (int e = tx; e < hdv; e += 16)
        acc = fmaf(dT[e * P + r], repro::to_float(ob[static_cast<size_t>(q0 + r) * hdv + e]), acc);
    acc = repro::group_sum<16>(acc);
    if (tx == 0) rowD[r] = acc;
  }

  // key tiles that hold a visible key (the forward's rule)
  int kt_lo = 0, kt_hi = (Sk - 1) / BT;
  if (causal) kt_hi = min(kt_hi, (q0 + BT - 1) / BT);
  if (window > 0) {
    const int first_key = q0 - window + 1;
    if (first_key > 0) kt_lo = first_key / BT;
  }

  // pass 1: each row's max and sum over its visible keys
  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_t<T, HD, BT>(kT, kb, k0, Sk, hd);
    __syncthreads();
    float s[R][R];
    tile_dot<HD, BT>(qT, kT, ty, tx, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float x = visible(row, k0 + tx + 16 * j, Sq, Sk, causal, window)
                            ? s[i][j] * scale
                            : -CUDART_INF_F;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], repro::group_max<16>(mx));
      // with nothing visible yet every term is exp(-inf) = 0; the shuffles
      // run on every lane either way
      const float base = m_new == -CUDART_INF_F ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) sum += expf(s[i][j] - base);
      l[i] = l[i] * expf(m[i] - base) + repro::group_sum<16>(sum);
      m[i] = m_new;
    }
  }
  float L[R], Dr[R];
  __syncthreads();  // rowD written
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    L[i] = m[i] + logf(l[i]);
    Dr[i] = rowD[r];
    if (tx == 0 && q0 + r < Sq) {
      lse[qrow + q0 + r] = L[i];
      delta[qrow + q0 + r] = Dr[i];
    }
  }

  // pass 2: dq = scale dS K
  float acc[R][DD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DD; ++j) acc[i][j] = 0.f;
  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();  // the previous tile's readers are done
    load_t<T, HD, BT>(kT, kb, k0, Sk, hd);
    load_t<T, HD, BT>(vT, vb, k0, Sk, hdv);
    __syncthreads();
    float s[R][R], dp[R][R];
    tile_dot<HD, BT>(qT, kT, ty, tx, s);
    tile_dot<HD, BT>(dT, vT, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int c = tx + 16 * j;
        const float p = visible(q0 + r, k0 + c, Sq, Sk, causal, window)
                            ? expf(s[i][j] * scale - L[i])
                            : 0.f;
        ds[r * P + c] = p * (dp[i][j] - Dr[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BT; ++c) {
      float dsv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = ds[(ty + 16 * i) * P + c];
#pragma unroll
      for (int j = 0; j < DD; ++j) {
        const float kv = kT[(tx + 16 * j) * P + c];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][j] = fmaf(dsv[i], kv, acc[i][j]);
      }
    }
  }

  T* dqb = dq + qrow * hd;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < DD; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dqb[static_cast<size_t>(row) * hd + d] = repro::from_float<T>(scale * acc[i][j]);
    }
  }
}

template <typename T, int HD, int BT>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int H,
           int KV, int Sq, int Sk, int hd, int hdv, int causal, int window, float scale) {
  constexpr int P = BT + 1, R = BT / 16, DD = HD / 16;
  extern __shared__ float smem[];
  float* kT = smem;
  float* vT = kT + HD * P;
  float* qT = vT + HD * P;
  float* dT = qT + HD * P;
  float* ps = dT + HD * P;    // ps[r * P + c]: r a query row, c a key
  float* ds = ps + BT * P;
  float* rowL = ds + BT * P;
  float* rowD = rowL + BT;

  const int kvb = blockIdx.y;
  const int b = kvb / KV, kvh = kvb % KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * BT;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t krow = static_cast<size_t>(kvb) * Sk;

  load_t<T, HD, BT>(kT, k + krow * hd, k0, Sk, hd);
  load_t<T, HD, BT>(vT, v + krow * hdv, k0, Sk, hdv);

  // query tiles holding a row that sees a key of this tile: causal rows
  // from k0 on; a window ends at the last key + window - 1
  const int qt_lo = causal ? k0 / BT : 0;
  int qt_hi = (Sq - 1) / BT;
  if (window > 0) qt_hi = min(qt_hi, (k0 + BT - 1 + window - 1) / BT);

  // keys c = ty + 16 i, dims d = tx + 16 j
  float gk[R][DD], gv[R][DD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < DD; ++j) {
      gk[i][j] = 0.f;
      gv[i][j] = 0.f;
    }

  for (int g = 0; g < G; ++g) {
    const size_t qrow = (static_cast<size_t>(b) * H + kvh * G + g) * static_cast<size_t>(Sq);
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // the previous tile's readers are done
      load_t<T, HD, BT>(qT, q + qrow * hd, q0, Sq, hd);
      load_t<T, HD, BT>(dT, dout + qrow * hdv, q0, Sq, hdv);
      for (int r = tid; r < BT; r += kThreads) {
        const bool in = q0 + r < Sq;
        rowL[r] = in ? lse[qrow + q0 + r] : 0.f;
        rowD[r] = in ? delta[qrow + q0 + r] : 0.f;
      }
      __syncthreads();
      // scores with query rows r = ty + 16 i, keys c = tx + 16 j
      float s[R][R], dp[R][R];
      tile_dot<HD, BT>(qT, kT, ty, tx, s);
      tile_dot<HD, BT>(dT, vT, ty, tx, dp);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int c = tx + 16 * j;
          const float p = visible(q0 + r, k0 + c, Sq, Sk, causal, window)
                              ? expf(s[i][j] * scale - rowL[r])
                              : 0.f;
          ps[r * P + c] = p;
          ds[r * P + c] = p * (dp[i][j] - rowD[r]);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BT; ++r) {
        float pv[R], dsv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = ps[r * P + ty + 16 * i];
          dsv[i] = ds[r * P + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DD; ++j) {
          const float dov = dT[(tx + 16 * j) * P + r];
          const float qv = qT[(tx + 16 * j) * P + r];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            gv[i][j] = fmaf(pv[i], dov, gv[i][j]);
            gk[i][j] = fmaf(dsv[i], qv, gk[i][j]);
          }
        }
      }
    }
  }

  T* dkb = dk + krow * hd;
  T* dvb = dv + krow * hdv;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Sk) continue;
#pragma unroll
    for (int j = 0; j < DD; ++j) {
      const int d = tx + 16 * j;
      if (d < hd) dkb[static_cast<size_t>(key) * hd + d] = repro::from_float<T>(scale * gk[i][j]);
      if (d < hdv) dvb[static_cast<size_t>(key) * hdv + d] = repro::from_float<T>(gv[i][j]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *out, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  int B, H, KV, Sq, Sk, hd, hdv, causal, window;
  float scale;
};

template <typename T, int HD, int BT>
int launch_dq(const Args& a, cudaStream_t stream) {
  const size_t smem = shared_floats<HD, BT>() * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, HD, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BT - 1) / BT, a.B * a.H);
  dq_kernel<T, HD, BT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.out), static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.lse,
      a.delta, a.H, a.KV, a.Sq, a.Sk, a.hd, a.hdv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD, int BT>
int launch_dkv(const Args& a, cudaStream_t stream) {
  const size_t smem = shared_floats<HD, BT>() * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T, HD, BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + BT - 1) / BT, a.B * a.KV);
  dkv_kernel<T, HD, BT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.H, a.KV, a.Sq, a.Sk, a.hd, a.hdv, a.causal, a.window, a.scale);
  return cudaGetLastError();
}

template <typename T, int HD, int BT>
int launch(const Args& a, bool dq, cudaStream_t s) {
  return dq ? launch_dq<T, HD, BT>(a, s) : launch_dkv<T, HD, BT>(a, s);
}

// The instance of width HD (hd padded up) and tile BT: 64-row tiles up to
// hd 128, 32-row tiles above (shared memory).
template <typename T>
int dispatch(const Args& a, bool dq, cudaStream_t s) {
  if (a.hd <= 32) return launch<T, 32, 64>(a, dq, s);
  if (a.hd <= 64) return launch<T, 64, 64>(a, dq, s);
  if (a.hd <= 128) return launch<T, 128, 64>(a, dq, s);
  if (a.hd <= 192) return launch<T, 192, 32>(a, dq, s);
  if (a.hd <= 256) return launch<T, 256, 32>(a, dq, s);
  return cudaErrorInvalidValue;
}

int entry(bool dq_pass, const void* q, const void* k, const void* v, const void* out,
          const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta, int B,
          int H, int KV, int Sq, int Sk, int hd, int hdv, int causal, int window, float scale,
          int bf16, void* stream) {
  if (hdv > hd || H % KV) return cudaErrorInvalidValue;
  const Args a{q, k, v, out, dout, dq, dk, dv, lse, delta,
               B, H, KV, Sq, Sk, hd, hdv, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, dq_pass, s) : dispatch<float>(a, dq_pass, s);
}

}  // namespace bwd

// Both launches take q (B, H, Sq, hd), k (B, KV, Sk, hd), v (B, KV, Sk,
// hd_v), out and dout (B, H, Sq, hd_v), dq like q, dk like k and dv like
// v, contiguous and of one type (bf16 != 0: bfloat16, else float32), and
// lse and delta, (B, H, Sq) float32: dq writes them, dkv reads them, so
// dkv is launched after dq on the same stream.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, void* dq,
                                             float* lse, float* delta, int B, int H, int KV,
                                             int Sq, int Sk, int hd, int hdv, int causal,
                                             int window, float scale, int bf16, void* stream) {
  return bwd::entry(true, q, k, v, out, dout, dq, nullptr, nullptr, lse, delta, B, H, KV, Sq,
                    Sk, hd, hdv, causal, window, scale, bf16, stream);
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, float* lse, float* delta,
                                              void* dk, void* dv, int B, int H, int KV, int Sq,
                                              int Sk, int hd, int hdv, int causal, int window,
                                              float scale, int bf16, void* stream) {
  return bwd::entry(false, q, k, v, nullptr, dout, nullptr, dk, dv, lse, delta, B, H, KV, Sq,
                    Sk, hd, hdv, causal, window, scale, bf16, stream);
}

// Shared memory a block of either launch takes for head dim hd (0 past
// the widest instance).
extern "C" long long flash_attention_bwd_shared_bytes(int hd) {
  if (hd <= 32) return bwd::shared_floats<32, 64>() * sizeof(float);
  if (hd <= 64) return bwd::shared_floats<64, 64>() * sizeof(float);
  if (hd <= 128) return bwd::shared_floats<128, 64>() * sizeof(float);
  if (hd <= 192) return bwd::shared_floats<192, 32>() * sizeof(float);
  if (hd <= 256) return bwd::shared_floats<256, 32>() * sizeof(float);
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
