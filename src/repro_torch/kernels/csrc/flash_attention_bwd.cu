// Backward of causal / sliding-window GQA flash attention on Hopper.
//
// The backward of the flash forward (csrc/flash_attention.cu, the
// counterpart of the Pallas TPU kernel `_flash_kernel` at
// src/repro/kernels/flash_attention/flash_attention.py:21).  It replaces no
// Pallas kernel: the JAX package trains through its jnp `chunked_attention`
// (src/repro/models/attention.py:71-135) and leaves the gradient to XLA.
// For batch b, query head h and kv head h / G, with P = exp(scale q k^T -
// lse) over the visible keys (key j visible to query i when j <= i if
// causal and j > i - window if window > 0; lse each row's log-sum-exp,
// which the forward saved), D = rowsum(dO * O) and dS = P * (dO V^T - D),
// zero at masked scores:
//
//   dq = scale dS K,   dk = scale dS^T Q,   dv = P^T dO,
//
// dk and dv summed over the G = H / KV query heads of each kv head.
//
// Two launches, one after the other on the caller's stream: dq (a block
// per (b, h, query tile); it also writes D for the second), then dk and dv
// (a block per (b, kv head, key tile), over the group's query heads and
// the query tiles that see the key tile).  Each output element is summed
// by one thread in a fixed order: no atomics, so two runs on the same
// inputs give the same bits (a resumed training run repeats an
// uninterrupted one).  Neither launch recomputes the log-sum-exp.
//
// What bounds it here: operations.  At llama3-8b's S = 2048, hd = 128
// each query row meets ~S/2 keys, and a visible (query, key) pair costs
// five products (q k^T, dO V^T, dS K, dS^T Q, P^T dO), ~10 hd operations,
// against a few hd bytes of each row's tensors: hundreds of operations a
// byte, so the tensor cores set the bound.  The split into two
// deterministic launches recomputes q k^T and dO V^T once more: seven
// products a pair.  Two instances, chosen by dtype and width (the
// wrapper's `instance`, the forward's rule):
//
// * bf16 with hd <= 128: the tensor-core instance (namespace bwd_tc).  A
//   producer warpgroup (one thread, 40 registers after setmaxnreg) loads
//   each block's resident tiles once and streams the others through a
//   2-stage ring with TMA, completion counted on mbarriers; all tiles are
//   128-byte swizzled, as wgmma reads them, and q, k, v, out and dout are
//   read through their strides (the model's (B, S, H, hd) views need no
//   copy).  Two consumer warpgroups of 64 rows each (232 registers) run
//   every product with wgmma into float32 registers.  dkv: K and V of 128
//   keys stay resident; each streamed tile is 64 query rows of Q and dO
//   with their lse and D (bulk copies); S^T = K Q^T and dP^T = V dO^T
//   from shared memory, P^T = exp2(S^T scale log2(e) - lse log2(e)) and
//   dS^T on the accumulator fragments, both rounded to bf16 in registers
//   as the A fragments of dV += P^T dO and dK += dS^T Q (dO and Q read
//   MN-major, as the forward reads V); dK and dV (64 x hd float32 each)
//   stay in registers across all G x query tiles, and dK is scaled once
//   at the end.  dq: Q and dO of 128 rows stay resident; the ring streams
//   64-key tiles of K and V; D is summed from out and dout in device
//   memory while the first tiles load; S = Q K^T, dP = dO V^T, dS rounded
//   to bf16, dQ += dS K (K read MN-major).  Masks are applied only on
//   tiles that the causal diagonal, the window's edge or the ends of Sq
//   and Sk cut; tiles with no visible pair are skipped.  hd < 128 runs
//   the 64- or 128-column instance, TMA's zero fill padding the columns
//   past hd.
// * float32, and any hd > 128 (MLA's 192 / 128): the CUDA-core instance
//   (namespace bwd), float32 arithmetic, which the float32 gradient gate
//   (1e-4) needs, as the forward keeps its float32 instance there.  16 x
//   16 threads with register tiles, tiles staged through shared memory
//   transposed and padded by one so the reads are conflict-free, on
//   contiguous tensors; hd is padded to 32, 64, 128, 192 or 256 by zero
//   fill in shared memory, which adds exact zeros to every dot.  It takes
//   hd_v <= hd.  Seven float32 products a pair on the CUDA cores: slow,
//   and kept for the arithmetic.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attention.cuh"
#include "hopper.cuh"

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
          const float* __restrict__ lse, float* __restrict__ delta, int H, int KV, int Sq, int Sk,
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

  // each row's log-sum-exp, from the forward
  float L[R], Dr[R];
  __syncthreads();  // rowD written
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
    const bool in = q0 + r < Sq;
    L[i] = in ? lse[qrow + q0 + r] : 0.f;
    Dr[i] = rowD[r];
    if (tx == 0 && in) delta[qrow + q0 + r] = Dr[i];
  }

  // dq = scale dS K
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
#pragma unroll 2  // by 4, ptxas spills at hd 192
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
  const float* lse;
  float* delta;
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
          const void* dout, void* dq, void* dk, void* dv, const float* lse, float* delta, int B,
          int H, int KV, int Sq, int Sk, int hd, int hdv, int causal, int window, float scale,
          int bf16, void* stream) {
  if (hdv > hd || H % KV) return cudaErrorInvalidValue;
  const Args a{q, k, v, out, dout, dq, dk, dv, lse, delta,
               B, H, KV, Sq, Sk, hd, hdv, causal, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(a, dq_pass, s) : dispatch<float>(a, dq_pass, s);
}

}  // namespace bwd

namespace bwd_tc {

using hopper::desc_sw128;
using hopper::ex2;
using hopper::pack_bf16;

constexpr int kRows = 64;                         // a warpgroup's rows; a streamed tile's
constexpr int kConsumers = 2;                     // warpgroups of kRows resident rows each
constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer warpgroup
constexpr int kStages = 2;                        // ring depth of the streamed tiles
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout (bytes from a 1024-byte aligned base).  Resident:
// two tensors (dq: Q and dO; dkv: K and V) of kConsumers tiles of kRows
// rows, tile (a, w) of tensor a for warpgroup w.  Streamed: two rings of
// kStages tiles (dq: K and V; dkv: Q and dO).  A tile of kRows x HD bf16
// is HD / 64 column blocks of kRows x 128 bytes, 128-byte swizzled, as
// TMA writes it.
template <int HD>
struct Layout {
  static constexpr int kTile = kRows * HD * 2;
  static constexpr int kRing0 = 2 * kConsumers * kTile;
  static constexpr int kRing1 = kRing0 + kStages * kTile;
  static constexpr int kBytes = kRing1 + kStages * kTile;
  __host__ __device__ static constexpr int res(int a, int w) {
    return (a * kConsumers + w) * kTile;
  }
};

struct Params {
  int H, KV, Sq, Sk, hd, causal, window;
  int vs;                  // row stride of lse and delta (a multiple of 4)
  float scale, scale_log2;
  const float* lse;        // (B, H, vs): the forward's log-sum-exp, natural log
  float* delta;            // (B, H, vs): D, written by dq, read by dkv
  const __nv_bfloat16 *out, *dout;
  long long o_s, o_h, o_b, do_s, do_h, do_b;  // strides (row, head, batch), elements
  __nv_bfloat16 *g0, *g1;                     // dq: dq; dkv: dk, dv
  long long g0_s, g0_h, g0_b, g1_s, g1_h, g1_b;
};

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ bool visible(int row, int col, const Params& p) {
  return row < p.Sq && col < p.Sk && (!p.causal || col <= row) &&
         (p.window <= 0 || col > row - p.window);
}

// A kRows x kRows tile of (query rows r0.., keys c0..): no visible pair,
// some masked pairs, or every pair visible (the masks are then skipped).
enum TileKind { kSkip, kMasked, kFull };

__device__ __forceinline__ TileKind tile_kind(int r0, int c0, const Params& p) {
  const int r1 = r0 + kRows - 1, c1 = c0 + kRows - 1;
  if (r0 >= p.Sq || c0 >= p.Sk || (p.causal && c0 > r1) ||
      (p.window > 0 && c1 <= r0 - p.window))
    return kSkip;
  const bool full = r1 < p.Sq && c1 < p.Sk && (!p.causal || c1 <= r0) &&
                    (p.window <= 0 || c0 > r1 - p.window);
  return full ? kFull : kMasked;
}

// Descriptor of step kk (16 columns of hd) of a K-major kRows-row tile.
__device__ __forceinline__ uint64_t k_major(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk / 4) * kRows * 128 + (kk % 4) * 32, 16, 1024);
}

// Descriptor of step kk (16 rows) of a tile read MN-major (hd contiguous).
__device__ __forceinline__ uint64_t mn_major(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 16 * 128, kRows * 128, 1024);
}

// acc = A B^T for A and B kRows-row tiles, both K-major over HD columns.
template <int HD>
__device__ __forceinline__ void issue_abt(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_ss(acc, k_major(a, kk), k_major(b, kk), kk > 0);
}

// acc += A B for A (64 x kRows) bf16 fragments and B a kRows-row tile read
// MN-major.
template <int HD>
__device__ __forceinline__ void issue_ab(float (&acc)[HD / 2], const uint32_t (&a)[kRows / 16][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) hopper::wgmma_rs(acc, a[kk], mn_major(b, kk), 1);
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int kk = 0; kk < N; ++kk) hopper::fence_regs(a[kk]);
}

// Accumulator entry i of a thread (m64n64 fragment): row 8 ((i / 2) % 2)
// past the thread's first row, column 8 (i / 4) + i % 2 past its first.
__device__ __forceinline__ int frag_row(int i) { return 8 * ((i >> 1) & 1); }
__device__ __forceinline__ int frag_col(int i) { return 8 * (i >> 2) + (i & 1); }

// dS (and P) of a dq tile, rounded to bf16 as A fragments: rows are the
// thread's query rows row0, row0 + 8 (lse2 in log2 units, dd their D),
// columns keys from c0.
template <bool kMask>
__device__ __forceinline__ void dq_grads(const float (&s)[32], const float (&dp)[32],
                                         uint32_t (&ds)[kRows / 16][4], const float (&lse2)[2],
                                         const float (&dd)[2], int row0, int c0,
                                         const Params& p) {
  // entries 2 n and 2 n + 1 (n = 4 kk + j) are one A-fragment register
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float x[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * n + e, r = (i >> 1) & 1;
      const float pr = ex2(fmaf(s[i], p.scale_log2, -lse2[r]));
      x[e] = pr * (dp[i] - dd[r]);
      if (kMask && !visible(row0 + frag_row(i), c0 + frag_col(i), p)) x[e] = 0.f;
    }
    ds[n / 4][n % 4] = pack_bf16(x[0], x[1]);
  }
}

// P^T and dS^T of a dkv tile, rounded to bf16 as A fragments: rows are
// the thread's keys key0, key0 + 8, columns query rows from q0 (their
// log-sum-exp and D from shared memory).
template <bool kMask>
__device__ __forceinline__ void dkv_grads(const float (&st)[32], const float (&dpt)[32],
                                          uint32_t (&pt)[kRows / 16][4],
                                          uint32_t (&dst)[kRows / 16][4], const float* lse,
                                          const float* dd, int key0, int q0, int col0,
                                          const Params& p) {
  // entries 2 n and 2 n + 1 (n = 4 kk + j) are one A-fragment register
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float x[2], y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * n + e, c = col0 + frag_col(i);
      const float pr = ex2(fmaf(st[i], p.scale_log2, -lse[c] * kLog2e));
      const bool ok = !kMask || visible(q0 + c, key0 + frag_row(i), p);
      x[e] = ok ? pr : 0.f;
      y[e] = ok ? pr * (dpt[i] - dd[c]) : 0.f;
    }
    pt[n / 4][n % 4] = pack_bf16(x[0], x[1]);
    dst[n / 4][n % 4] = pack_bf16(y[0], y[1]);
  }
}

// Write a 64 x HD float32 accumulator times `scale` in bf16 through the
// strides (row, with the thread's rows row0 and row0 + 8), columns < hd,
// rows < nrows.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 2], float scale,
                                           __nv_bfloat16* base, long long row_stride, int row0,
                                           int nrows, int col0, int hd) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrows) continue;
    __nv_bfloat16* out = base + row * row_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < hd)
        *reinterpret_cast<uint32_t*>(out + col) =
            pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

// -- dq: a block per (b, h, 128 query rows) ----------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
             const __grid_constant__ CUtensorMap v_map,
             const __grid_constant__ CUtensorMap do_map, const Params p) {
  using L = Layout<HD>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t res_full, full[kStages], empty[kStages];
  __shared__ float d_rows[kConsumers][kRows];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows * kConsumers;  // longest tiles first

  // key tiles holding a key that a row of the block sees
  int kt_hi = (p.Sk - 1) / kRows;
  if (p.causal) kt_hi = min(kt_hi, (q0 + kRows * kConsumers - 1) / kRows);
  int kt_lo = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) kt_lo = (q0 - p.window + 1) / kRows;
  const int n_tiles = max(kt_hi - kt_lo + 1, 0);

  if (threadIdx.x == 0) {
    mbar_init(&res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // -- producer: one thread loads Q and dO once, then the K, V ring -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(&res_full, 2 * kConsumers * L::kTile);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_4d(smem + L::res(0, w) + c * kRows * 128, &q_map, &res_full, c * 64,
                      q0 + w * kRows, h, b);
          tma_load_4d(smem + L::res(1, w) + c * kRows * 128, &do_map, &res_full, c * 64,
                      q0 + w * kRows, h, b);
        }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, k0 = (kt_lo + it) * kRows;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kTile);
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_4d(smem + L::kRing0 + s * L::kTile + c * kRows * 128, &k_map, &full[s],
                      c * 64, k0, kvh, b);
          tma_load_4d(smem + L::kRing1 + s * L::kTile + c * kRows * 128, &v_map, &full[s],
                      c * 64, k0, kvh, b);
        }
      }
    }
  } else {
    // -- consumers: kRows query rows each ------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int first = q0 + wg * kRows;
    const int row0 = first + 16 * warp + lane / 4, col0 = 2 * (lane % 4);
    const size_t vrow = (static_cast<size_t>(b) * p.H + h) * p.vs;

    // D = rowsum(dO * O) of the warpgroup's rows, two threads a row, read
    // through the strides while TMA brings the tiles
    {
      const int r = t / 2, row = first + r;
      float acc = 0.f;
      if (row < p.Sq) {
        const __nv_bfloat16* o = p.out + b * p.o_b + h * p.o_h + row * p.o_s;
        const __nv_bfloat16* d = p.dout + b * p.do_b + h * p.do_h + row * p.do_s;
        for (int c = 8 * (t % 2); c < p.hd; c += 16) {
          float x[8], y[8];
          repro::load16(o + c, x);
          repro::load16(d + c, y);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (t % 2 == 0) {
        d_rows[wg][r] = acc;
        if (row < p.Sq) p.delta[vrow + row] = acc;
      }
      wg_sync(wg);
    }
    float lse2[2], dd[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      lse2[r] = row < p.Sq ? p.lse[vrow + row] * kLog2e : 0.f;
      dd[r] = d_rows[wg][row - first];
    }

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    const uint32_t q_addr = smem_u32(smem + L::res(0, wg));
    const uint32_t do_addr = smem_u32(smem + L::res(1, wg));
    mbar_wait(&res_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, k0 = (kt_lo + it) * kRows;
      mbar_wait(&full[s], (it / kStages) & 1);
      const TileKind kind = tile_kind(first, k0, p);
      if (kind != kSkip) {
        const uint32_t k_addr = smem_u32(smem + L::kRing0 + s * L::kTile);
        const uint32_t v_addr = smem_u32(smem + L::kRing1 + s * L::kTile);
        float sc[32], dp[32];
        wgmma_fence();
        issue_abt<HD>(sc, q_addr, k_addr);   // S = Q K^T
        issue_abt<HD>(dp, do_addr, v_addr);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);
        uint32_t ds[kRows / 16][4];
        if (kind == kMasked)
          dq_grads<true>(sc, dp, ds, lse2, dd, row0, k0 + col0, p);
        else
          dq_grads<false>(sc, dp, ds, lse2, dd, row0, k0 + col0, p);
        wgmma_fence();
        issue_ab<HD>(dq, ds, k_addr);        // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_frags(ds);
      }
      mbar_arrive(&empty[s]);
    }
    store_rows<HD>(dq, p.scale, p.g0 + b * p.g0_b + h * p.g0_h, p.g0_s, row0, p.Sq, col0, p.hd);
  }
}

// -- dk, dv: a block per (b, kv head, 128 keys) --------------------------------
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
              const __grid_constant__ CUtensorMap v_map,
              const __grid_constant__ CUtensorMap do_map, const Params p) {
  using L = Layout<HD>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t res_full, full[kStages], empty[kStages];
  __shared__ __align__(16) float lse_s[kStages][kRows], d_s[kStages][kRows];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int b = blockIdx.x / p.KV, kvh = blockIdx.x % p.KV;
  const int G = p.H / p.KV;
  const int k0 = blockIdx.y * kRows * kConsumers;  // causal: most query tiles first

  // query tiles holding a row that sees a key of the block: causal rows
  // from k0 on; a window ends at the last key + window - 1
  const int qt_lo = p.causal ? k0 / kRows : 0;
  int qt_hi = (p.Sq - 1) / kRows;
  if (p.window > 0) qt_hi = min(qt_hi, (k0 + kRows * kConsumers - 2 + p.window) / kRows);
  const int nq = max(qt_hi - qt_lo + 1, 0);
  const int n_tiles = G * nq;  // query head g = it / nq, tile qt_lo + it % nq

  if (threadIdx.x == 0) {
    mbar_init(&res_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // -- producer: K and V once, then the ring of Q, dO, lse and D tiles ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(&res_full, 2 * kConsumers * L::kTile);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_4d(smem + L::res(0, w) + c * kRows * 128, &k_map, &res_full, c * 64,
                      k0 + w * kRows, kvh, b);
          tma_load_4d(smem + L::res(1, w) + c * kRows * 128, &v_map, &res_full, c * 64,
                      k0 + w * kRows, kvh, b);
        }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages, g = it / nq;
        const int q0 = (qt_lo + it - g * nq) * kRows, h = kvh * G + g;
        // lse and D rows q0.. up to the padded row end (16-byte units)
        const uint32_t vec = min(kRows, p.vs - q0) * 4;
        const size_t vrow = (static_cast<size_t>(b) * p.H + h) * p.vs + q0;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * L::kTile + 2 * vec);
        for (int c = 0; c < HD / 64; ++c) {
          tma_load_4d(smem + L::kRing0 + s * L::kTile + c * kRows * 128, &q_map, &full[s],
                      c * 64, q0, h, b);
          tma_load_4d(smem + L::kRing1 + s * L::kTile + c * kRows * 128, &do_map, &full[s],
                      c * 64, q0, h, b);
        }
        bulk_load(lse_s[s], p.lse + vrow, vec, &full[s]);
        bulk_load(d_s[s], p.delta + vrow, vec, &full[s]);
      }
    }
  } else {
    // -- consumers: kRows keys each; dK and dV stay in registers --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int first = k0 + wg * kRows;
    const int key0 = first + 16 * warp + lane / 4, col0 = 2 * (lane % 4);
    const uint32_t k_addr = smem_u32(smem + L::res(0, wg));
    const uint32_t v_addr = smem_u32(smem + L::res(1, wg));

    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) {
      dk[i] = 0.f;
      dv[i] = 0.f;
    }
    mbar_wait(&res_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages, g = it / nq;
      const int q0 = (qt_lo + it - g * nq) * kRows;
      mbar_wait(&full[s], (it / kStages) & 1);
      const TileKind kind = tile_kind(q0, first, p);
      if (kind != kSkip) {
        const uint32_t q_addr = smem_u32(smem + L::kRing0 + s * L::kTile);
        const uint32_t do_addr = smem_u32(smem + L::kRing1 + s * L::kTile);
        float st[32], dpt[32];
        wgmma_fence();
        issue_abt<HD>(st, k_addr, q_addr);    // S^T = K Q^T
        issue_abt<HD>(dpt, v_addr, do_addr);  // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);
        uint32_t pt[kRows / 16][4], dst[kRows / 16][4];
        if (kind == kMasked)
          dkv_grads<true>(st, dpt, pt, dst, lse_s[s], d_s[s], key0, q0, col0, p);
        else
          dkv_grads<false>(st, dpt, pt, dst, lse_s[s], d_s[s], key0, q0, col0, p);
        wgmma_fence();
        issue_ab<HD>(dv, pt, do_addr);        // dV += P^T dO
        issue_ab<HD>(dk, dst, q_addr);        // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_frags(pt);
        fence_frags(dst);
      }
      mbar_arrive(&empty[s]);
    }
    store_rows<HD>(dk, p.scale, p.g0 + b * p.g0_b + kvh * p.g0_h, p.g0_s, key0, p.Sk, col0,
                   p.hd);
    store_rows<HD>(dv, 1.f, p.g1 + b * p.g1_b + kvh * p.g1_h, p.g1_s, key0, p.Sk, col0, p.hd);
  }
}

// strides: 24 int64, (row, head, batch) of q, k, v, out, dout, dq, dk, dv.
template <int HD>
int launch(bool dq_pass, const void* q, const void* k, const void* v, const void* out,
           const void* dout, void* g0, void* g1, const float* lse, float* delta, int B, int H,
           int KV, int Sq, int Sk, int hd, const long long* strides, int vs, int causal,
           int window, float scale, cudaStream_t stream) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return hopper::kErrNoEncode;
  CUtensorMap qm, km, vm, dom;
  if (hopper::make_map(encode, &qm, q, hd, Sq, H, B, strides, kRows) ||
      hopper::make_map(encode, &km, k, hd, Sk, KV, B, strides + 3, kRows) ||
      hopper::make_map(encode, &vm, v, hd, Sk, KV, B, strides + 6, kRows) ||
      hopper::make_map(encode, &dom, dout, hd, Sq, H, B, strides + 12, kRows))
    return hopper::kErrEncode;
  const long long* gs = strides + (dq_pass ? 15 : 18);  // dq, or dk then dv
  const Params p{H, KV, Sq, Sk, hd, causal, window, vs, scale, scale * kLog2e, lse, delta,
                 static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
                 strides[9], strides[10], strides[11], strides[12], strides[13], strides[14],
                 static_cast<__nv_bfloat16*>(g0), static_cast<__nv_bfloat16*>(g1),
                 gs[0], gs[1], gs[2], gs[3], gs[4], gs[5]};
  const int smem = Layout<HD>::kBytes + 1024;  // + room to align the base
  const int rows = kRows * kConsumers;
  auto kernel = dq_pass ? dq_tc_kernel<HD> : dkv_tc_kernel<HD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid = dq_pass ? dim3(B * H, (Sq + rows - 1) / rows)
                            : dim3(B * KV, (Sk + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, stream>>>(qm, km, vm, dom, p);
  return cudaGetLastError();
}

int entry(bool dq_pass, const void* q, const void* k, const void* v, const void* out,
          const void* dout, void* g0, void* g1, const float* lse, float* delta, int B, int H,
          int KV, int Sq, int Sk, int hd, const long long* strides, int vs, int causal,
          int window, float scale, void* stream) {
  if (H % KV || vs % 4) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64>(dq_pass, q, k, v, out, dout, g0, g1, lse, delta, B, H, KV, Sq, Sk, hd,
                      strides, vs, causal, window, scale, s);
  if (hd <= 128)
    return launch<128>(dq_pass, q, k, v, out, dout, g0, g1, lse, delta, B, H, KV, Sq, Sk, hd,
                       strides, vs, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace bwd_tc


// The CUDA-core instance.  Both launches take q (B, H, Sq, hd), k (B, KV,
// Sk, hd), v (B, KV, Sk, hd_v), out and dout (B, H, Sq, hd_v), dq like q,
// dk like k and dv like v, contiguous and of one type (bf16 != 0:
// bfloat16, else float32), lse (B, H, Sq) float32 from the forward, and
// delta (B, H, Sq) float32: dq writes it, dkv reads it, so dkv is
// launched after dq on the same stream.
extern "C" int flash_attention_bwd_dq_launch(const void* q, const void* k, const void* v,
                                             const void* out, const void* dout, void* dq,
                                             const float* lse, float* delta, int B, int H,
                                             int KV, int Sq, int Sk, int hd, int hdv,
                                             int causal, int window, float scale, int bf16,
                                             void* stream) {
  return bwd::entry(true, q, k, v, out, dout, dq, nullptr, nullptr, lse, delta, B, H, KV, Sq,
                    Sk, hd, hdv, causal, window, scale, bf16, stream);
}

extern "C" int flash_attention_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                              const void* dout, const float* lse,
                                              const float* delta, void* dk, void* dv, int B,
                                              int H, int KV, int Sq, int Sk, int hd, int hdv,
                                              int causal, int window, float scale, int bf16,
                                              void* stream) {
  return bwd::entry(false, q, k, v, nullptr, dout, nullptr, dk, dv, lse,
                    const_cast<float*>(delta), B, H, KV, Sq, Sk, hd, hdv, causal, window, scale,
                    bf16, stream);
}

// The tensor-core instance: bf16 q (B, H, Sq, hd), k and v (B, KV, Sk, hd),
// out and dout (B, H, Sq, hd), dq like q, dk like k and dv like v, each
// with hd contiguous and any other strides that are multiples of 8
// elements, 16-byte aligned, hd <= 128 and hd % 8 == 0 (v, out and dout
// zero-padded to q's width); strides: 24 int64, (row, head, batch) of q,
// k, v, out, dout, dq, dk, dv.  lse and delta (B, H, vs) float32 with vs
// >= Sq a multiple of 4, 16-byte aligned: lse from the forward, delta
// written by dq and read by dkv.
extern "C" int flash_attention_bwd_tc_dq_launch(const void* q, const void* k, const void* v,
                                                const void* out, const void* dout, void* dq,
                                                const float* lse, float* delta, int B, int H,
                                                int KV, int Sq, int Sk, int hd,
                                                const long long* strides, int vs, int causal,
                                                int window, float scale, void* stream) {
  return bwd_tc::entry(true, q, k, v, out, dout, dq, nullptr, lse, delta, B, H, KV, Sq, Sk, hd,
                       strides, vs, causal, window, scale, stream);
}

extern "C" int flash_attention_bwd_tc_dkv_launch(const void* q, const void* k, const void* v,
                                                 const void* dout, const float* lse,
                                                 const float* delta, void* dk, void* dv, int B,
                                                 int H, int KV, int Sq, int Sk, int hd,
                                                 const long long* strides, int vs, int causal,
                                                 int window, float scale, void* stream) {
  return bwd_tc::entry(false, q, k, v, nullptr, dout, dk, dv, lse, const_cast<float*>(delta),
                       B, H, KV, Sq, Sk, hd, strides, vs, causal, window, scale, stream);
}

extern "C" const char* cuda_error_string(int err) { return hopper::error_string(err); }
