// Mamba2 SSD chunk scan (state-space duality core, forward) on Hopper.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan/ssd_scan.py).  For batch b and head h, over
// chunks of Lc steps in order, from a zero (hd, N) state S:
//
//   cs      = cumsum(a)                                   (Lc,)
//   L[i, j] = exp(cs_i - cs_j) for i >= j, else 0         (Lc, Lc)
//   y       = ((C B^T) o L) x + (C S^T) o exp(cs)         (Lc, hd)
//   S      <- S exp(cs_last) + x^T (B o exp(cs_last - cs))
//
// with x = dt * x (Lc, hd), B and C (Lc, N), a = dt * A (Lc,), all read as
// float32; y is written in x's type.  B and C are per group: head h of H
// reads group h / (H / G) of G (G = H is the TPU kernel's per-head layout;
// Mamba2 shares one group across heads, so the model passes its G groups
// and no per-head copies).  The final state is not returned (the TPU
// kernel keeps it in VMEM scratch only).
//
// What bounds it here: operations.  At Lc = 256, hd = 64, N = 128 a chunk
// is 21.0 M float32 operations over the causal pairs j <= i (C B^T and its
// product with x, Lc (Lc + 1) (N + hd)) plus C S^T and the state update
// (4 Lc hd N), against 0.4 MB of inputs and output for a head of its own
// group: ~50 operations per byte, above the float32 CUDA-core ridge
// (67 TFLOP/s over 3.35 TB/s, 20).
// This first version computes in float32 on the CUDA cores, as the TPU
// kernel does (TF32 or bf16 tensor-core products would round inputs it
// keeps in float32), and skips the key tiles above the diagonal.
//
// The design: one thread block per (b, h) walks the chunks in order, so
// the state stays in shared memory for the whole sequence (transposed,
// ST[n][p], so that a thread's p columns are consecutive words).  A whole
// chunk's operands do not fit in a block's 227 KB at full width (x 64 KB,
// B and C 128 KB each, L 256 KB), so the chunk is tiled: 64-row query
// tiles of C, and for each the 64-row key tiles j <= i of B and x, with
// the decay exp(cs_i - cs_j) applied per element from sums in shared
// memory.  Those are kept per tile: `loc`, the cumsum inside each 64-row
// tile, and `tot`, the tiles' totals.  cs_i - cs_j is then formed as
// loc_i - loc_j plus the totals of the tiles between, never as the
// difference of two long cumsums: at Lc = 1024, |cs| reaches several
// hundred, and its float32 rounding (~6e-5) would enter every decay.
// 16 x 16 threads; each owns 4 query rows x 4 keys of a score tile and 4
// rows x HD/16 columns of the output tile in registers.  Every row's y
// reads the old state; the state update runs after the chunk's last
// output tile, over the key tiles once more, each thread owning NP/16 x
// HD/16 entries of the state.  Shapes: hd <= 64 and N <= 128 (padded to
// HD and NP, multiples of 16, with zeros that add exact zeros), any Lc up
// to 1024 (the ragged last tile is zero-filled and masked).  Shared memory
// at full width: 133,392 bytes a block, so one block an SM; B * H = 96
// blocks on 132 SMs at the Mamba2 path's prefill (B = 4, 24 heads).
#include <cuda_runtime.h>

#include "attention.cuh"

namespace {

constexpr int kT = 64;         // rows per query / key tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTS = kT + 1;    // padded stride of the transposed tiles
constexpr int kRows = kT / 16; // tile rows per thread: ty + 16 i
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 16;

// Shared-memory layout in floats: ST (NP x HD), CT and BT (NP x kTS), xs
// (kT x HD), ps (kT x kTS), loc (the chunk's tiles, nt x kT), tot (nt).
__host__ __device__ constexpr int off_ct(int HD, int NP) { return NP * HD; }
__host__ __device__ constexpr int off_bt(int HD, int NP) { return off_ct(HD, NP) + NP * kTS; }
__host__ __device__ constexpr int off_xs(int HD, int NP) { return off_bt(HD, NP) + NP * kTS; }
__host__ __device__ constexpr int off_ps(int HD, int NP) { return off_xs(HD, NP) + kT * HD; }
__host__ __device__ constexpr int off_loc(int HD, int NP) { return off_ps(HD, NP) + kT * kTS; }

__host__ __device__ constexpr size_t shared_floats(int HD, int NP, int Lc) {
  const int nt = (Lc + kT - 1) / kT;
  return static_cast<size_t>(off_loc(HD, NP)) + nt * kT + nt;
}

// Sum of the tile totals tot[lo..hi), in order.
__device__ __forceinline__ float tile_sum(const float* tot, int lo, int hi) {
  float v = 0.f;
  for (int t = lo; t < hi; ++t) v += tot[t];
  return v;
}

// rows from `src` (row stride `width`, `rows` valid from `r0`, `width` valid
// columns) into the transposed tile dst[n * kTS + r], zero-filled to NP x kT;
// scale[r] multiplies row r where given.
template <typename T, int NP>
__device__ __forceinline__ void load_transposed(float* dst, const T* __restrict__ src, int r0,
                                                int rows, int width, const float* scale) {
  for (int i = threadIdx.x; i < kT * NP; i += kThreads) {
    const int r = i / NP, n = i % NP;
    float v = 0.f;
    if (r0 + r < rows && n < width) {
      v = repro::to_float(src[static_cast<size_t>(r0 + r) * width + n]);
      if (scale != nullptr) v *= scale[r];
    }
    dst[n * kTS + r] = v;
  }
}

// xs[c * HD + p] = x[k0 + c, p], zero-filled to kT x HD.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src, int k0, int rows,
                                          int hd) {
  for (int i = threadIdx.x; i < kT * HD; i += kThreads) {
    const int c = i / HD, p = i % HD;
    float v = 0.f;
    if (k0 + c < rows && p < hd) v = repro::to_float(src[static_cast<size_t>(k0 + c) * hd + p]);
    dst[i] = v;
  }
}

template <typename T, int HD, int NP>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bm, const T* __restrict__ Cm,
                const T* __restrict__ a, T* __restrict__ y, int H, int G, int nc, int Lc, int hd,
                int N) {
  extern __shared__ float smem[];
  float* ST = smem;                    // ST[n * HD + p]: the state S[p, n]
  float* CT = smem + off_ct(HD, NP);   // CT[n * kTS + r] = C[q0 + r, n]
  float* BT = smem + off_bt(HD, NP);   // BT[n * kTS + c] = B[k0 + c, n] (x decay in the update)
  float* xs = smem + off_xs(HD, NP);   // xs[c * HD + p] = x[k0 + c, p]
  float* ps = smem + off_ps(HD, NP);   // ps[r * kTS + c]: decayed scores; decays in the update
  const int nt = (Lc + kT - 1) / kT;
  float* loc = smem + off_loc(HD, NP); // loc[i]: cumsum of a inside i's tile
  float* tot = loc + nt * kT;          // tot[t]: tile t's sum of a
  constexpr int kDims = HD / 16;  // state / output columns per thread: tx + 16 j
  constexpr int kStateRows = NP / 16;  // state rows per thread: ty + 16 i

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = blockIdx.x;
  const size_t bg = (bh / H) * G + (bh % H) / (H / G);  // head h reads group h / (H / G)
  const T* xb = x + bh * nc * Lc * hd;
  const T* bb = Bm + bg * nc * Lc * N;
  const T* cb = Cm + bg * nc * Lc * N;
  const T* ab = a + bh * nc * Lc;
  T* yb = y + bh * nc * Lc * hd;

  for (int i = tid; i < NP * HD; i += kThreads) ST[i] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const size_t cx = static_cast<size_t>(ci) * Lc * hd, cn = static_cast<size_t>(ci) * Lc * N;
    const T* xc = xb + cx;
    const T* bc = bb + cn;
    const T* cc = cb + cn;
    const T* ac = ab + static_cast<size_t>(ci) * Lc;
    T* yc = yb + cx;

    // -- loc and tot: one warp per tile, two entries a lane, a warp scan
    __syncthreads();  // the previous chunk's readers of loc, tot and ST are done
    for (int t = tid / 32; t < nt; t += kWarps) {
      const int lane = tid % 32, i = t * kT + 2 * lane;
      const float a0 = i < Lc ? repro::to_float(ac[i]) : 0.f;
      const float a1 = i + 1 < Lc ? repro::to_float(ac[i + 1]) : 0.f;
      const float pair = a0 + a1;
      float incl = pair;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      loc[i] = before + a0;
      loc[i + 1] = incl;
      if (lane == 31) tot[t] = incl;
    }
    __syncthreads();
    const float last = tile_sum(tot, 0, nt);  // cs_last

    // -- outputs, one 64-row query tile at a time
    for (int qt = 0; qt < nt; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the previous tile's readers of CT are done
      load_transposed<T, NP>(CT, cc, q0, Lc, N, nullptr);
      __syncthreads();

      // inter-chunk term (C S^T) o exp(cs), from the state before this chunk
      float acc[kRows][kDims];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kDims; ++j) acc[i][j] = 0.f;
      if (ci > 0) {
        const float off = tile_sum(tot, 0, qt);  // cs before the tile
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[kRows], sv[kDims];
#pragma unroll
          for (int i = 0; i < kRows; ++i) cv[i] = CT[n * kTS + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kDims; ++j) sv[j] = ST[n * HD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kDims; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int row = q0 + ty + 16 * i;
          const float e = row < Lc ? expf(off + loc[row]) : 0.f;
#pragma unroll
          for (int j = 0; j < kDims; ++j) acc[i][j] *= e;
        }
      }

      // intra-chunk term ((C B^T) o L) x over the key tiles j <= i
      for (int kt = 0; kt <= qt; ++kt) {
        const int k0 = kt * kT;
        const float span = tile_sum(tot, kt, qt);  // a over tiles kt..qt-1
        __syncthreads();  // the previous key tile's readers are done
        load_transposed<T, NP>(BT, bc, k0, Lc, N, nullptr);
        load_rows<T, HD>(xs, xc, k0, Lc, hd);
        __syncthreads();

        float s[kRows][kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kRows; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float cv[kRows], bv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) cv[i] = CT[n * kTS + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kRows; ++j) bv[j] = BT[n * kTS + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kRows; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int r = ty + 16 * i, row = q0 + r;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const int c = tx + 16 * j, col = k0 + c;
            // L[i, j] = exp(cs_i - cs_j) where i >= j, else 0 (a select:
            // exp of a positive difference above the diagonal may be inf)
            const bool valid = col <= row && row < Lc;
            ps[r * kTS + c] = valid ? s[i][j] * expf(loc[row] - loc[col] + span) : 0.f;
          }
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < kT; ++c) {
          float pv[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i) pv[i] = ps[(ty + 16 * i) * kTS + c];
#pragma unroll
          for (int j = 0; j < kDims; ++j) {
            const float xv = xs[c * HD + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= Lc) continue;
#pragma unroll
        for (int j = 0; j < kDims; ++j) {
          const int p = tx + 16 * j;
          if (p < hd) yc[static_cast<size_t>(row) * hd + p] = repro::from_float<T>(acc[i][j]);
        }
      }
    }

    // -- state update S <- S exp(cs_last) + x^T (B o exp(cs_last - cs)),
    // after every output row of the chunk has read the old state
    float sacc[kStateRows][kDims];
#pragma unroll
    for (int i = 0; i < kStateRows; ++i)
#pragma unroll
      for (int j = 0; j < kDims; ++j) sacc[i][j] = 0.f;
    for (int kt = 0; kt < nt; ++kt) {
      const int k0 = kt * kT;
      __syncthreads();  // the previous tile's readers of BT, xs, ps are done
      // cs_last - cs_j = (a over tiles kt..nt-1) - loc_j
      const float rest = tile_sum(tot, kt, nt);
      if (tid < kT) ps[tid] = k0 + tid < Lc ? expf(rest - loc[k0 + tid]) : 0.f;
      __syncthreads();
      load_transposed<T, NP>(BT, bc, k0, Lc, N, ps);
      load_rows<T, HD>(xs, xc, k0, Lc, hd);
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kT; ++c) {
        float bv[kStateRows], xv[kDims];
#pragma unroll
        for (int i = 0; i < kStateRows; ++i) bv[i] = BT[(ty + 16 * i) * kTS + c];
#pragma unroll
        for (int j = 0; j < kDims; ++j) xv[j] = xs[c * HD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kStateRows; ++i)
#pragma unroll
          for (int j = 0; j < kDims; ++j) sacc[i][j] = fmaf(bv[i], xv[j], sacc[i][j]);
      }
    }
    // each thread owns its (n, p) entries; no thread reads ST in this loop
    const float keep = expf(last);
#pragma unroll
    for (int i = 0; i < kStateRows; ++i)
#pragma unroll
      for (int j = 0; j < kDims; ++j) {
        float* s = &ST[(ty + 16 * i) * HD + tx + 16 * j];
        *s = *s * keep + sacc[i][j];
      }
  }
}

template <typename T, int HD, int NP>
int launch(const void* x, const void* Bm, const void* Cm, const void* a, void* y, int BH, int H,
           int G, int nc, int Lc, int hd, int N, cudaStream_t stream) {
  const size_t smem = shared_floats(HD, NP, Lc) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, HD, NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<T, HD, NP><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(a), static_cast<T*>(y), H, G, nc, Lc, hd, N);
  return cudaGetLastError();
}

template <typename T, int HD>
int dispatch_state(const void* x, const void* Bm, const void* Cm, const void* a, void* y, int BH,
                   int H, int G, int nc, int Lc, int hd, int N, cudaStream_t s) {
  if (N <= 16) return launch<T, HD, 16>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  if (N <= 32) return launch<T, HD, 32>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  if (N <= 64) return launch<T, HD, 64>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  if (N <= 128) return launch<T, HD, 128>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  return cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const void* x, const void* Bm, const void* Cm, const void* a, void* y, int BH,
             int H, int G, int nc, int Lc, int hd, int N, cudaStream_t s) {
  if (Lc < 1 || Lc > kMaxTiles * kT) return cudaErrorInvalidValue;
  if (H < 1 || G < 1 || H % G != 0 || BH % H != 0) return cudaErrorInvalidValue;
  if (hd <= 16) return dispatch_state<T, 16>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  if (hd <= 32) return dispatch_state<T, 32>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  if (hd <= 64) return dispatch_state<T, 64>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// xdt, y (B * H, nc, Lc, hd); Bm, Cm (B * G, nc, Lc, N), H % G == 0;
// a (B * H, nc, Lc): contiguous, all of one type (bf16 != 0: bfloat16,
// else float32).
extern "C" int ssd_scan_launch(const void* x, const void* Bm, const void* Cm, const void* a,
                               void* y, int BH, int H, int G, int nc, int Lc, int hd, int N,
                               int bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return dispatch<__nv_bfloat16>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
  return dispatch<float>(x, Bm, Cm, a, y, BH, H, G, nc, Lc, hd, N, s);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
