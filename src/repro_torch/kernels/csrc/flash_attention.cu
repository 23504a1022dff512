// Causal / sliding-window GQA flash attention (forward) on Hopper.
//
// Replaces the Pallas TPU kernel `_flash_kernel`
// (src/repro/kernels/flash_attention/flash_attention.py:21).  For batch b,
// query head h and kv head h / G:
//
//   out[b, h, i] = softmax_j(q[b, h, i] . k[b, h / G, j] * scale, masked) @ v
//
// with key j valid when j <= i (causal) and j > i - window (window > 0);
// invalid keys score -1e30.
//
// What bounds it here: operations.  At S = 2048 and hd = 128 each query
// row meets ~S/2 keys, ~4 hd operations each, against 4 hd bytes of q and
// out: hundreds of operations per byte, so the bf16 tensor cores set the
// bound.  Two instances, chosen by dtype and width (the wrapper states
// the same rule):
//
// * bf16 with hd <= 128: the tensor-core instance (namespace tc), a
//   warp-specialised forward pass in the shape of FlashAttention-3.  One
//   thread block per (b, h, 128-row query tile), query tiles longest
//   first so the causal diagonal leaves no tail of idle SMs.  A producer
//   warpgroup (one thread, 40 registers after setmaxnreg) loads the query
//   tile once and the 128-key K and V tiles of kv head h / G into a
//   3-stage ring with TMA, completion counted on mbarriers; the tiles are
//   128-byte swizzled, the layout wgmma reads.  Two consumer warpgroups
//   (232 registers each), 64 query rows apiece, compute S = Q K^T with
//   wgmma from shared memory into float32 registers, run the online
//   softmax (in log2 units: the scale carries log2(e)) on the
//   accumulator fragments, reducing over the 4 lanes that share a row,
//   round P to bf16 and accumulate O += P V with wgmma, P from registers
//   and V read MN-major from shared memory.  Two overlaps keep the tensor
//   cores fed: within a warpgroup, tile j's S = Q K^T and tile j - 1's
//   O += P V are issued together and tile j's softmax runs while the
//   latter computes; between the two warpgroups, named barriers take
//   turns at issuing (ping-pong), so one's softmax overlaps the other's
//   products.  Key tiles run from the diagonal down; fully masked ones
//   are skipped by the TPU kernel's rule at this tile size, and tiles the
//   masks cannot touch skip the mask tests.  q, k, v and out are read and
//   written through their strides (TMA descriptors take them), so the
//   model's (B, S, H, hd) views need no copy; hd < 128 is padded to the
//   64- or 128-column instance by TMA's zero fill of the box past hd.
// * float32, and any hd > 128: the CUDA-core instance (namespace simt),
//   float32 arithmetic as the TPU kernel casts to float32 before each dot,
//   which the float32 model's 1e-4 teacher-forced gate needs (TF32 would
//   not hold it).  One block per (b, h, 64-query tile), 16 x 16 threads
//   with 4 x 4 register tiles; each 64-key tile is staged through shared
//   memory once per query tile.
//
// Both keep the TPU kernel's numbers: masked scores are -1e30 (never
// -inf, which marks only keys past Sk), l is clamped at 1e-30, and a row
// whose first processed tile is masked in full adds exp(0) per entry,
// which the first valid tile's correction erases.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace simt {

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

}  // namespace simt

namespace tc {

using hopper::desc_sw128;

constexpr int kBM = 128;                         // query rows per block
constexpr int kBN = 128;                         // keys per tile
constexpr int kStages = 3;                       // K/V ring depth
constexpr int kConsumers = 2;                    // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1); // + the producer warpgroup
constexpr int kAtom = 64;                        // bf16 in a 128-byte swizzled row

// Shared-memory layout (bytes from a 1024-byte aligned base): each
// consumer's 64 x HD query rows, then the K ring, then the V ring.  A
// tile of R rows is HD / 64 column blocks of R x 128 bytes.
template <int HD>
struct Layout {
  static constexpr int kQRows = kBM / kConsumers;
  static constexpr int kQBytes = kQRows * HD * 2;  // one consumer's query rows
  static constexpr int kTileBytes = kBN * HD * 2;  // one K or V tile
  static constexpr int kK = kConsumers * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBytes = kV + kStages * kTileBytes;
};

struct Params {
  int H, KV, Sq, Sk, hd, causal, window;
  float scale_log2;          // hd^-0.5 * log2(e)
  long long o_b, o_h, o_s;   // out strides, elements
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P in bf16: the accumulator fragment of 16 keys is the A fragment.
__device__ __forceinline__ void pack_p(const float (&sc)[kBN / 2], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

__device__ __forceinline__ void fence_p(uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) hopper::fence_regs(pa[kk]);
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// Issue S = Q K^T for one key tile (both K-major, 16 columns of hd a step).
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[kBN / 2], uint32_t q_addr, uint32_t k_addr) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hopper::wgmma_ss(
        sc, desc_sw128(q_addr + (kk / 4) * Layout<HD>::kQRows * 128 + (kk % 4) * 32, 16, 1024),
        desc_sw128(k_addr + (kk / 4) * kBN * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
  hopper::wgmma_commit();
}

// Issue O += P V for one key tile: P from registers, V MN-major (hd
// contiguous), 16 keys a step.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&pa)[kBN / 16][4],
                                         uint32_t v_addr) {
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    hopper::wgmma_rs(o, pa[kk], desc_sw128(v_addr + kk * 16 * 128, kBN * 128, 1024), 1);
  hopper::wgmma_commit();
}

// Scale and mask the scores of the key tile at k0 (accumulator fragment:
// entry i of a thread is row row0 + 8 ((i / 2) % 2), key k0 + 8 (i / 4) +
// col0 + i % 2), fold them into the rows' running max m and sum l (this
// lane's part) and replace them by exp2(score - m); corr gets each row's
// correction of the earlier tiles.  kMask: apply the masks (a tile they
// cannot touch skips the tests).
template <bool kMask>
__device__ __forceinline__ void online_softmax(float (&sc)[kBN / 2], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int k0, int row0, int col0,
                                               const Params& p) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = kMask ? sc[i] * p.scale_log2 : sc[i];
    if (kMask) {
      const int row = row0 + 8 * r;
      const int col = k0 + 8 * (i >> 2) + col0 + (i & 1);
      if (col >= p.Sk)
        x = -CUDART_INF_F;  // keys past Sk do not exist
      else if ((p.causal && col > row) || (p.window > 0 && col <= row - p.window))
        x = repro::kNegInf;
    }
    sc[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  // the 4 lanes that hold a row share its max
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = repro::group_max<4>(mx[r]);
    if (!kMask) mx[r] *= p.scale_log2;
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = ex2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = kMask ? ex2(sc[i] - m[r]) : ex2(fmaf(sc[i], p.scale_log2, -m[r]));
    l[r] += sc[i];
  }
}

// Whether key tile kt lies inside every mask for all of the block's rows
// q0 .. q0 + kBM - 1.
__device__ __forceinline__ bool block_unmasked(int kt, int q0, const Params& p) {
  const int k0 = kt * kBN;
  return k0 + kBN <= p.Sk && (!p.causal || k0 + kBN - 1 <= q0) &&
         (p.window <= 0 || k0 > q0 + kBM - 1 - p.window);
}

// One tile of the consumer loop: S = Q K^T of tile it beside O += P V of
// tile it - 1 on the tensor cores, tile it's softmax while the latter
// runs, then release tile it - 1's stage.
template <int HD, bool kMask>
__device__ __forceinline__ void consume_tile(int it, int kt_hi, float (&sc)[kBN / 2],
                                             float (&o)[HD / 2], uint32_t (&pa)[kBN / 16][4],
                                             float (&m)[2], float (&l)[2], uint32_t q_addr,
                                             uint32_t k_addr, uint32_t v_addr, int row0,
                                             int col0, const Params& p, uint64_t* k_full,
                                             uint64_t* v_full, uint64_t* empty, int wg) {
  using namespace hopper;
  constexpr int kTile = Layout<HD>::kTileBytes;
  const int s = it % kStages, sp = (it - 1) % kStages;
  mbar_wait(&k_full[s], (it / kStages) & 1);
  mbar_wait(&v_full[sp], ((it - 1) / kStages) & 1);
  named_sync(1 + wg);
  issue_qk<HD>(sc, q_addr, k_addr + s * kTile);
  issue_pv<HD>(o, pa, v_addr + sp * kTile);
  named_arrive(2 - wg);
  wgmma_wait<1>();  // S is in; P V still runs
  fence_regs(sc);
  float corr[2];
  online_softmax<kMask>(sc, m, l, corr, (kt_hi - it) * kBN, row0, col0, p);
  wgmma_wait<0>();
  fence_regs(o);
  fence_p(pa);
  mbar_arrive(&empty[sp]);
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];
  pack_p(sc, pa);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          __nv_bfloat16* __restrict__ out, const Params p) {
  using L = Layout<HD>;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest query tiles first

  // Key tiles that run, by the TPU kernel's rule: causal skips a tile that
  // starts past the query tile's last row; a window skips a tile whose
  // last key is <= q0 - window.  They run from kt_hi down.
  int kt_hi = (p.Sk - 1) / kBN;
  if (p.causal) kt_hi = min(kt_hi, (q0 + kBM - 1) / kBN);
  int kt_lo = 0;
  if (p.window > 0 && q0 - p.window + 1 > 0) kt_lo = (q0 - p.window + 1) / kBN;
  const int n_tiles = max(kt_hi - kt_lo + 1, 0);

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // -- producer: one thread keeps the ring full ---------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(&q_full, kConsumers * L::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load_4d(smem + w * L::kQBytes + c * L::kQRows * 128, &q_map, &q_full, c * kAtom,
                      q0 + w * L::kQRows, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int k0 = (kt_hi - it) * kBN;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], L::kTileBytes);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load_4d(smem + L::kK + s * L::kTileBytes + c * kBN * 128, &k_map, &k_full[s],
                      c * kAtom, k0, kvh, b);
        mbar_expect_tx(&v_full[s], L::kTileBytes);
        for (int c = 0; c < HD / kAtom; ++c)
          tma_load_4d(smem + L::kV + s * L::kTileBytes + c * kBN * 128, &v_map, &v_full[s],
                      c * kAtom, k0, kvh, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each --------------------------------------
    // Tile it's S = Q K^T runs on the tensor cores beside tile it - 1's
    // O += P V; the softmax of tile it overlaps the latter.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int first = q0 + wg * L::kQRows;
    const int row0 = first + 16 * warp + lane / 4;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = smem_u32(smem + wg * L::kQBytes);
    const uint32_t k_addr = smem_u32(smem + L::kK), v_addr = smem_u32(smem + L::kV);

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {repro::kNegInf, repro::kNegInf}, l[2] = {0.f, 0.f};
    float sc[kBN / 2];
    uint32_t pa[kBN / 16][4];  // P of the previous tile, bf16: the A fragment

    if (wg == 0) named_arrive(1);  // warpgroup 0 issues first
    mbar_wait(&q_full, 0);
    if (n_tiles > 0) {
      // the first tile alone: S, then its softmax
      mbar_wait(&k_full[0], 0);
      named_sync(1 + wg);
      issue_qk<HD>(sc, q_addr, k_addr);
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(sc);
      float corr[2];
      online_softmax<true>(sc, m, l, corr, kt_hi * kBN, row0, col0, p);
      pack_p(sc, pa);
    }
    // Tiles 1.. in three runs, each free of branches between a wgmma and
    // its wait: masked near the diagonal and the end of Sk, unmasked, then
    // masked again where the window starts.  Both warpgroups take the same
    // runs (the block's rows decide).
    int it = 1;
    for (; it < n_tiles && !block_unmasked(kt_hi - it, q0, p); ++it)
      consume_tile<HD, true>(it, kt_hi, sc, o, pa, m, l, q_addr, k_addr, v_addr, row0, col0, p,
                             k_full, v_full, empty, wg);
    for (; it < n_tiles && block_unmasked(kt_hi - it, q0, p); ++it)
      consume_tile<HD, false>(it, kt_hi, sc, o, pa, m, l, q_addr, k_addr, v_addr, row0, col0, p,
                              k_full, v_full, empty, wg);
    for (; it < n_tiles; ++it)
      consume_tile<HD, true>(it, kt_hi, sc, o, pa, m, l, q_addr, k_addr, v_addr, row0, col0, p,
                             k_full, v_full, empty, wg);
    if (n_tiles > 0) {
      const int sl = (n_tiles - 1) % kStages;
      mbar_wait(&v_full[sl], ((n_tiles - 1) / kStages) & 1);
      named_sync(1 + wg);
      issue_pv<HD>(o, pa, v_addr + sl * L::kTileBytes);
      named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(o);
      fence_p(pa);
    }

    // out = O / max(l, 1e-30), written through out's strides
    __nv_bfloat16* ob = out + b * p.o_b + h * p.o_h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / fmaxf(repro::group_sum<4>(l[r]), 1e-30f);
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      __nv_bfloat16* orow = ob + row * p.o_s;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const int col = 8 * j + col0;
        if (col < p.hd)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// Error codes of this file beside CUDA's (see cuda_error_string).
constexpr int kErrNoEncode = -1;
constexpr int kErrEncode = -2;

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library does not link libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// A (hd, rows, heads, batch) bf16 map with strides in elements (row, head,
// batch), read in 64-column boxes of box_rows rows, 128-byte swizzled.
int make_map(EncodeTiled encode, CUtensorMap* map, const void* base, int hd, int rows, int heads,
             int batch, const long long* strides, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t bytes[3] = {static_cast<cuuint64_t>(strides[0]) * 2,
                               static_cast<cuuint64_t>(strides[1]) * 2,
                               static_cast<cuuint64_t>(strides[2]) * 2};
  const cuuint32_t box[4] = {kAtom, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                            bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// strides: q, k, v, out, each (row, head, batch) in elements.
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV, int Sq,
           int Sk, int hd, const long long* strides, int causal, int window, float scale,
           cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kErrNoEncode;
  CUtensorMap qm, km, vm;
  if (make_map(encode, &qm, q, hd, Sq, H, B, strides, Layout<HD>::kQRows) ||
      make_map(encode, &km, k, hd, Sk, KV, B, strides + 3, kBN) ||
      make_map(encode, &vm, v, hd, Sk, KV, B, strides + 6, kBN))
    return kErrEncode;
  const int smem = Layout<HD>::kBytes + 1024;  // + room to align the base
  cudaError_t err = cudaFuncSetAttribute(flash_attention_tc_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const Params p{H, KV, Sq, Sk, hd, causal, window, scale * 1.4426950408889634f,
                 strides[11], strides[10], strides[9]};
  const dim3 grid(B * H, (Sq + kBM - 1) / kBM);
  flash_attention_tc_kernel<HD><<<grid, kThreads, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), p);
  return cudaGetLastError();
}

}  // namespace tc

// bf16 q (B, H, Sq, hd), k and v (B, KV, Sk, hd), out (B, H, Sq, hd), each
// with hd contiguous and any other strides that are multiples of 8
// elements, 16-byte aligned, hd <= 128 and hd % 8 == 0.  strides: 12
// int64, (row, head, batch) of q, k, v, out.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* out,
                                         int B, int H, int KV, int Sq, int Sk, int hd,
                                         const long long* strides, int causal, int window,
                                         float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return tc::launch<64>(q, k, v, out, B, H, KV, Sq, Sk, hd, strides, causal, window, scale, s);
  if (hd <= 128)
    return tc::launch<128>(q, k, v, out, B, H, KV, Sq, Sk, hd, strides, causal, window, scale, s);
  return cudaErrorInvalidValue;
}

// The CUDA-core instance: q (B, H, Sq, hd), k and v (B, KV, Sk, hd), out
// (B, H, Sq, hd), contiguous, all of one type (bf16 != 0: bfloat16, else
// float32).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KV, int Sq, int Sk, int hd,
                                      int causal, int window, float scale, int bf16,
                                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return simt::dispatch<__nv_bfloat16>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window,
                                         scale, s);
  return simt::dispatch<float>(q, k, v, out, B, H, KV, Sq, Sk, hd, causal, window, scale, s);
}

extern "C" const char* cuda_error_string(int err) {
  if (err == tc::kErrNoEncode) return "cuTensorMapEncodeTiled not found in the driver";
  if (err == tc::kErrEncode) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
