// One-token GQA decode attention over a linear KV cache, on Hopper.
//
// Replaces the Pallas TPU kernel `_decode_kernel`
// (src/repro/kernels/decode_attention/decode_attention.py:22).  For row b
// and query head h = kv * G + g:
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
// card's ~295 operations per byte, and the arithmetic stays float32 on the
// CUDA cores.  What the design does about it: it spreads the valid rows
// over many SMs, streams them with bulk copies, and reads each element
// from shared memory once.
//
// * A split over the cache.  Each (row, kv head, group of up to 4 query
//   heads) is a thread-block cluster of `cs` blocks (cs <= 8, chosen on
//   the host from the shapes only, so that about two blocks sit on each
//   SM; the grid never depends on pos, so the launch can be captured in a
//   CUDA graph and replayed with new positions).  The valid rows [lo, hi]
//   of the row, read from pos on the device, are cut into cs contiguous
//   shares, one per block.
// * A ring of bulk copies.  A block streams its share in chunks of kChunk
//   rows: a chunk's K rows and its V rows are each contiguous in the
//   (B, KV, C, hd) layout, so one thread moves each with one
//   cp.async.bulk into a kStages-deep ring, completion counted on the
//   stage's mbarrier, the next chunks in flight while one is computed.
// * Each element read once from shared memory.  Scores: the 8 lanes (for
//   hd = 128) of a row group share a cache row, each holding 16 of its
//   elements and the same 16 of every query in registers, summed over the
//   group by shuffles.  p @ v: each thread owns one 16-byte vector of hd
//   for all the block's heads over every 16th row, its sums in registers,
//   added up through shared memory at the end.  Each block keeps its own
//   online-softmax (m, l, acc) for its heads.
// * A merge in the same launch.  After cluster.sync() the blocks read each
//   other's (m, l, acc) through distributed shared memory, each block
//   finishing a 1/cs slice of the outputs: m = max m_i, weights
//   exp(m_i - m) on l_i and acc_i, out = acc / max(l, 1e-30).  With the
//   -1e30 masking this is exact where it matters: a share with no valid
//   row (m = -1e30, l = 0) gets weight 0 whenever any share has one; when
//   no row is valid at all, lo..hi is the whole cache, every share is
//   masked (m_i = -1e30, weight 1) and the merge gives the TPU kernel's
//   mean of v over the cache.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "attention.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;          // cache rows per pass
constexpr int kHeads = 4;           // query heads per block (a kv head's G in groups)
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kTargetBlocks = 264;  // two blocks on each of an H100's 132 SMs

// Lanes that share a cache row in the scores: each holds 16 elements of
// the row (and of each query) in registers, so ceil(hd / 16) lanes,
// rounded up to a power of two.
__host__ __device__ inline int lanes_per_row(int hd) {
  int lanes = 1;
  while (lanes * 16 < hd) lanes *= 2;
  return lanes;
}

// Floats before the ring: scores (kChunk, kHeads), running max, sum and
// correction (kHeads), the block's acc (kHeads, hd), and the cluster's m
// and l (kMaxCluster, kHeads) for the merge; rounded up to 16 bytes.
__host__ __device__ inline size_t float_words(int hd) {
  const size_t n = kChunk * kHeads + 3 * kHeads + static_cast<size_t>(kHeads) * hd +
                   2 * kMaxCluster * kHeads;
  return (n + 3) / 4 * 4;
}

// Threads that split a chunk's rows in p @ v, each owning one 16-byte
// vector of hd for the block's heads.
__host__ __device__ inline int pv_phases(int hd, int elt) {
  const int phases = kThreads / (hd * elt / 16);
  return phases < kChunk ? phases : kChunk;
}

// The ring of stages (a chunk's K rows then its V rows, as in the cache),
// reused at the end to sum the p @ v threads' parts.
__host__ __device__ inline size_t ring_bytes(int hd, int elt, int stages) {
  const size_t ring = static_cast<size_t>(stages) * 2 * kChunk * hd * elt;
  const size_t parts = static_cast<size_t>(pv_phases(hd, elt)) * kHeads * hd * sizeof(float);
  return ring > parts ? ring : parts;
}

__host__ __device__ inline size_t shared_bytes(int hd, int elt, int stages) {
  return float_words(hd) * sizeof(float) + ring_bytes(hd, elt, stages);
}

// The ring depth: the most of 3, 2 or 1 stages that fits in a block's
// shared memory (one stage loads and computes in turn, as wide float32
// heads need).
inline int ring_stages(int hd, int elt) {
  int stages = 3;
  while (stages > 1 && shared_bytes(hd, elt, stages) > 232448) --stages;
  return stages;
}

// Blocks per (row, kv head, head group): the largest power of two <= 8
// that keeps the grid within kTargetBlocks and gives each block at least
// a chunk of a full cache.
inline int cluster_size(int B, int H, int KV, int C) {
  const int G = H / KV;
  const long long units = static_cast<long long>(B) * KV * ((G + kHeads - 1) / kHeads);
  int cs = 1;
  while (cs < kMaxCluster && units * cs * 2 <= kTargetBlocks && C >= 2 * cs * kChunk) cs *= 2;
  return cs;
}

// Sum over the `width` consecutive lanes of a lane group (width a power of
// two <= 32, the same in every lane).
__device__ __forceinline__ float lane_group_sum(float v, int width) {
  for (int off = width / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Needs hd * sizeof(T) % 16 == 0, hd <= 512 and 16-byte aligned q, k and v
// (the wrapper checks them).  Launched as clusters of cs blocks, one
// cluster per (b, kv head, group of kHeads query heads).
template <typename T, int kStages>
__global__ void __launch_bounds__(kThreads, 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, int H, int KV, int C, int hd, int window,
                        float scale) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];  // chunk landed in stage s
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int kVec = 16 / sizeof(T);  // elements in a 16-byte vector
  constexpr int kVpl = 16 / kVec;       // vectors of a row a scores lane holds
  const int G = H / KV;
  const int groups = (G + kHeads - 1) / kHeads;
  const int vecs = hd / kVec;                       // 16-byte vectors in a row
  const int L = lanes_per_row(hd);
  float* s_s = reinterpret_cast<float*>(smem);      // (kChunk, kHeads): scores, then p
  float* m_s = s_s + kChunk * kHeads;               // (kHeads)
  float* l_s = m_s + kHeads;                        // (kHeads)
  float* corr_s = l_s + kHeads;                     // (kHeads)
  float* acc_s = corr_s + kHeads;                   // (kHeads, hd)
  float* pm_s = acc_s + kHeads * hd;                // (kMaxCluster, kHeads)
  float* pl_s = pm_s + kMaxCluster * kHeads;        // (kMaxCluster, kHeads)
  uint4* ring = reinterpret_cast<uint4*>(smem) + float_words(hd) / 4;
  const int stage_vecs = 2 * kChunk * vecs;         // K then V of one chunk

  const int unit = blockIdx.x / cs;
  const int hg = unit % groups, kvh = (unit / groups) % KV, b = unit / (groups * KV);
  const int g0 = hg * kHeads, nh = min(kHeads, G - g0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g0;
  const T* qb = q + head0 * hd;  // the block's query heads, contiguous
  T* ob = out + head0 * hd;
  const size_t cache0 = (static_cast<size_t>(b) * KV + kvh) * static_cast<size_t>(C) * hd;
  const uint4* kb = reinterpret_cast<const uint4*>(k + cache0);
  const uint4* vb = reinterpret_cast<const uint4*>(v + cache0);

  // Rows [lo, hi] hold every valid entry.  With none valid, every row is
  // masked and the TPU kernel returns the plain mean of v over the whole
  // cache (each p = exp(0)); walking all rows reproduces that.  This
  // block's share is [s_lo, s_hi] (empty when the share rounds to none).
  const int p = pos[b];
  int lo = window > 0 ? max(p - window + 1, 0) : 0;
  int hi = min(p, C - 1);
  if (lo > hi) {
    lo = 0;
    hi = C - 1;
  }
  const long long n = hi - lo + 1;
  const int s_lo = lo + static_cast<int>(n * rank / cs);
  const int s_hi = lo + static_cast<int>(n * (rank + 1) / cs) - 1;
  const int chunks = (s_hi - s_lo + kChunk) / kChunk;

  // Chunk ci into ring stage ci % kStages: its K rows and its V rows are
  // each contiguous in the cache, so one thread moves each with one bulk
  // copy, completion counted on the stage's barrier.
  auto load_chunk = [&](int ci) {
    const int c0 = s_lo + ci * kChunk;
    const uint32_t bytes = min(kChunk, s_hi - c0 + 1) * vecs * 16;
    uint4* k_s = ring + (ci % kStages) * stage_vecs;
    uint64_t* bar = &full[ci % kStages];
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(k_s, kb + static_cast<size_t>(c0) * vecs, bytes, bar);
    bulk_load(k_s + kChunk * vecs, vb + static_cast<size_t>(c0) * vecs, bytes, bar);
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    fence_mbar_init();
    for (int ci = 0; ci < kStages - 1 && ci < chunks; ++ci) load_chunk(ci);
  }

  // Scores: the L lanes of a row group share a cache row; lane rl holds
  // vectors rl + L i (i < kVpl) of the row and of each query, the queries
  // in registers, so shared memory serves each K element once.
  const int rl = lane & (L - 1);
  float qr[kHeads][kVpl][kVec];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int i = 0; i < kVpl; ++i) {
      const int t = rl + L * i;
      if (h < nh && t < vecs) {
        repro::load16(qb + static_cast<size_t>(h) * hd + t * kVec, qr[h][i]);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) qr[h][i][j] = 0.f;
      }
    }
  if (tid < kHeads) {
    m_s[tid] = repro::kNegInf;
    l_s[tid] = 0.f;
  }

  // p @ v: thread (ph, vi) owns vector vi of hd for the block's heads over
  // rows ph, ph + phases, ... of each chunk, its sums in registers.
  const int phases = pv_phases(hd, sizeof(T));
  const int vi = tid % vecs, ph = tid / vecs;
  float acc[kHeads][kVec];
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[h][j] = 0.f;

  __syncthreads();  // the barriers are set up
  for (int ci = 0; ci < chunks; ++ci) {
    if (ci > 0) __syncthreads();  // chunk ci - 1 is done: its stage is free
    if (tid == 0 && ci + kStages - 1 < chunks) load_chunk(ci + kStages - 1);
    mbar_wait(&full[ci % kStages], (ci / kStages) & 1);

    const int c0 = s_lo + ci * kChunk;
    const int rows = min(kChunk, s_hi - c0 + 1);
    const uint4* k_s = ring + (ci % kStages) * stage_vecs;
    const uint4* v_s = k_s + kChunk * vecs;

    // scores of every head for 32 / L rows a warp at a time
    for (int r = warp * (32 / L) + lane / L; r < kChunk; r += kWarps * (32 / L)) {
      float part[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) part[h] = 0.f;
      if (r < rows) {
        const uint4* kr = k_s + r * vecs;
#pragma unroll
        for (int i = 0; i < kVpl; ++i) {
          const int t = rl + L * i;
          if (t < vecs) {
            float kx[kVec];
            repro::load16(reinterpret_cast<const T*>(kr + t), kx);
#pragma unroll
            for (int h = 0; h < kHeads; ++h)
#pragma unroll
              for (int j = 0; j < kVec; ++j) part[h] = fmaf(qr[h][i][j], kx[j], part[h]);
          }
        }
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h) part[h] = lane_group_sum(part[h], L);
      if (rl == 0) {
        const int c = c0 + r;
        const bool valid = c <= p && (window == 0 || c > p - window);
#pragma unroll
        for (int h = 0; h < kHeads; ++h)  // rows past the chunk's end do not exist
          s_s[r * kHeads + h] =
              r < rows ? (valid ? part[h] * scale : repro::kNegInf) : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // online softmax: warp h for head h, kChunk / 32 rows a lane
    if (warp < kHeads) {
      const int h = warp;
      float x[kChunk / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kChunk / 32; ++j) {
        x[j] = s_s[(lane + 32 * j) * kHeads + h];
        mx = fmaxf(mx, x[j]);
      }
      mx = repro::group_max<32>(mx);
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk / 32; ++j) {
        x[j] = expf(x[j] - m_new);
        s_s[(lane + 32 * j) * kHeads + h] = x[j];
        sum += x[j];
      }
      sum = repro::group_sum<32>(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
        corr_s[h] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v
    if (ph < phases) {
      const float4 corr = *reinterpret_cast<const float4*>(corr_s);
      const float cr[kHeads] = {corr.x, corr.y, corr.z, corr.w};
#pragma unroll
      for (int h = 0; h < kHeads; ++h)
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc[h][j] *= cr[h];
      for (int r = ph; r < rows; r += phases) {
        float vx[kVec];
        repro::load16(reinterpret_cast<const T*>(v_s + r * vecs + vi), vx);
        const float4 pr = *reinterpret_cast<const float4*>(s_s + r * kHeads);
        const float pp[kHeads] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
        for (int h = 0; h < kHeads; ++h)
#pragma unroll
          for (int j = 0; j < kVec; ++j) acc[h][j] = fmaf(pp[h], vx[j], acc[h][j]);
      }
    }
  }
  __syncthreads();

  // the block's acc: the p @ v threads' parts summed through the ring
  float* parts = reinterpret_cast<float*>(ring);  // (phases, kHeads, hd)
  if (ph < phases) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h)
#pragma unroll
      for (int j = 0; j < kVec; ++j) parts[(ph * kHeads + h) * hd + vi * kVec + j] = acc[h][j];
  }
  __syncthreads();
  for (int i = tid; i < kHeads * hd; i += kThreads) {
    float a = 0.f;
    for (int f = 0; f < phases; ++f) a += parts[f * kHeads * hd + i];
    acc_s[i] = a;
  }

  // merge the cluster's shares: block `rank` finishes outputs [o_lo, o_hi)
  // of its nh heads, reading the others' acc through distributed shared
  // memory
  cluster.sync();
  if (tid < cs * kHeads) {
    pm_s[tid] = *cluster.map_shared_rank(m_s + tid % kHeads, tid / kHeads);
    pl_s[tid] = *cluster.map_shared_rank(l_s + tid % kHeads, tid / kHeads);
  }
  __syncthreads();
  const int per = (nh * hd + cs - 1) / cs;
  const int o_lo = rank * per, o_hi = min(nh * hd, o_lo + per);
  for (int i = o_lo + tid; i < o_hi; i += kThreads) {
    const int h = i / hd;
    float m = -CUDART_INF_F;
    for (int r = 0; r < cs; ++r) m = fmaxf(m, pm_s[r * kHeads + h]);
    float l = 0.f, a = 0.f;
    for (int r = 0; r < cs; ++r) {
      const float w = expf(pm_s[r * kHeads + h] - m);
      l += w * pl_s[r * kHeads + h];
      a += w * *cluster.map_shared_rank(acc_s + i, r);
    }
    ob[i] = repro::from_float<T>(a / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int kStages>
int launch_stages(const void* q, const void* k, const void* v, const int* pos, void* out, int B,
                  int H, int KV, int C, int hd, int window, float scale, cudaStream_t stream) {
  const int cs = cluster_size(B, H, KV, C);
  const size_t smem = shared_bytes(hd, sizeof(T), kStages);
  auto kernel = decode_attention_kernel<T, kStages>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(B * KV * ((H / KV + kHeads - 1) / kHeads) * cs);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), pos, static_cast<T*>(out), H, KV, C, hd,
                           window, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out, int B, int H,
           int KV, int C, int hd, int window, float scale, cudaStream_t stream) {
  switch (ring_stages(hd, sizeof(T))) {
    case 3:
      return launch_stages<T, 3>(q, k, v, pos, out, B, H, KV, C, hd, window, scale, stream);
    case 2:
      return launch_stages<T, 2>(q, k, v, pos, out, B, H, KV, C, hd, window, scale, stream);
    default:
      return launch_stages<T, 1>(q, k, v, pos, out, B, H, KV, C, hd, window, scale, stream);
  }
}

}  // namespace

// Bytes of dynamic shared memory one block needs (the wrapper's gate);
// elt: bytes per element (4 float32, 2 bfloat16).
extern "C" long long decode_attention_shared_bytes(int hd, int elt) {
  return static_cast<long long>(shared_bytes(hd, elt, ring_stages(hd, elt)));
}

// Blocks that split each (row, kv head, group of 4 query heads) in a launch
// of this shape.
extern "C" int decode_attention_cluster_size(int B, int H, int KV, int C) {
  return cluster_size(B, H, KV, C);
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
