// Mamba2 SSD chunk scan (state-space duality core, forward) on Hopper:
// three chunk-parallel stages, products on the tensor cores in split TF32.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`
// (src/repro/kernels/ssd_scan/ssd_scan.py).  For batch b and head h, over
// chunks of Lc steps, from a zero (hd, N) state:
//
//   cs      = cumsum(a)                                   (Lc,)
//   L[i, j] = exp(cs_i - cs_j) for i >= j, else 0         (Lc, Lc)
//   y       = ((C B^T) o L) x + (C S^T) o exp(cs)         (Lc, hd)
//   S      <- S exp(cs_last) + x^T (B o exp(cs_last - cs))
//
// with x = dt * x (Lc, hd) and a = dt * A (Lc,) in float32, B and C (Lc, N)
// in float32 or bfloat16 (read in their own type; the conversion is exact);
// y is written in float32.  Head h of H reads group h / (H / G) of B and C.
// The final state is not returned (the TPU kernel keeps it in VMEM only).
//
// The TPU kernel walks the chunks of one (b, h) in order on one core.  Here
// the chunks run in parallel, in three launches:
//
//   1. chunk states, a block per (b, h, c): s_c = x^T (B o exp(cs_last - cs)),
//      an (hd, N) tile, and the chunk's total of a, cs_last;
//   2. state pass, sequential over the chunks of each (b, h) and parallel
//      over its hd * N entries: S_c = S_{c-1} exp(cs_last,c) + s_c, writing
//      over s_c the state S_{c-1} that chunk c starts from;
//   3. chunk scan, a block per (b, h, c, 64-row query tile), the longest
//      tiles first: y = ((C B^T) o L) x over the key tiles j <= i, plus
//      (C S_{c-1}^T) o exp(cs); 4 warps of 16 rows, and for float32 B and
//      C 4 more, each pair of warps sharing 16 rows and taking half of
//      every key tile (and of N in C S^T), their partials added at the end.
//
// What bounds it: operations.  At mamba2-130m's prefill (B = 4, S = 8192,
// 24 heads of 64, N = 128, Lc = 256) the call is 64.6 GFLOP over the causal
// pairs against 0.439 GB of inputs and output.  Every product runs on the
// tensor cores (`mma.sync.m16n8k8` in TF32) in split TF32: each float32
// operand v is cut into hi = v with the low 13 mantissa bits cleared and
// lo = (v - hi) cleared the same way, and a.b is taken as
// a_lo.b_hi + a_hi.b_lo + a_hi.b_hi with a float32 accumulator, which keeps
// float32 accuracy (a single TF32 product keeps ~3 digits, not enough for
// the 1e-4 gates).  A bfloat16 operand is exact in TF32 and is not split.
// `mma.sync` rather than `wgmma`: wgmma's TF32 form takes K-major operands
// only, and x in P x and in x^T B is MN-major in memory; mma.sync reads its
// fragments from padded shared tiles in either layout without a transpose.
// The pads make every fragment load free of bank conflicts: a K-major
// float32 tile has a row stride of 4 (mod 32) words, an MN-major one 8, a
// bfloat16 tile 8 (mod 64) elements.  P's accumulator fragments serve as
// the A fragments of P x with no shuffle: its k index is permuted inside
// each 8-key step (k = t <-> key 2t, k = t + 4 <-> key 2t + 1), and x's
// rows are read in the same order.  The three products of a split run term
// by term over a row of independent accumulators, so that no product waits
// on the one issued just before it.
//
// Tiles are loaded with `cp.async.bulk`, one bulk copy per row, issued by
// the 32 lanes of warp 0 and counted on an mbarrier; rows are read through
// the caller's strides (the model's (B, nc, Lc, H, P) layout needs no copy),
// so each row must be a whole number of 16-byte units and 16-byte aligned
// (the wrapper pads hd and N where they are not).  Decays are formed from
// per-tile sums: `loc`, the cumsum of a inside each 64-row tile, and
// `tot`, the tiles' totals; cs_i - cs_j is
// loc_i - loc_j plus the totals of the tiles between, never the difference
// of two long cumsums (at Lc = 1024, |cs| reaches several hundred and its
// float32 rounding, ~6e-5, would enter every decay).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;          // rows per tile
constexpr int kThreads = 128;  // stage 1: 4 warps

// Stage 3: 4 warps a share of the keys (and of N in C S^T).  float32 B and
// C take two shares (8 warps: each split product is three mma, so more
// warps hide their latency; 2.07 against 2.20 ms a call at the Mamba2
// prefill shape on an H100), bfloat16 B and C one (4 warps: the scores
// are single exact products, and the shares' merge costs more than it
// hides; 1.54 against 1.80 ms).
constexpr int scan_threads(int split) { return 128 * split; }
template <typename TB>
constexpr int scan_split() { return sizeof(TB) == 2 ? 1 : 2; }
constexpr int kMaxTiles = 16;   // Lc <= 1024
constexpr uint32_t kTf32Mask = 0xffffe000u;

struct Strides {
  long long b, h, c, l;  // in elements; the last dimension is contiguous
};

struct Geometry {
  int batch, H, G, nc, Lc, hd, N;
  Strides x, B, C, a, y;
};

// -- shared-tile row strides (elements) ----------------------------------------
// float32: K-major rows (fragment reads at row g, column t) 4 (mod 32) words,
// MN-major rows (row t, column g) 8 (mod 32); bfloat16: 8 (mod 64) elements
// for both.
template <typename T, bool kKMajor>
__host__ __device__ constexpr int row_stride(int width) {
  return sizeof(T) == 2 ? (width + 63) / 64 * 64 + 8 : width + (kKMajor ? 4 : 8);
}

// Stage 1: barrier, x tile (kT x SX float), B tile (kT x SB), loc (nt * kT), tot.
template <typename TB, int HD, int NP>
struct StatesLayout {
  static constexpr int kSX = row_stride<float, false>(HD);
  static constexpr int kSB = row_stride<TB, false>(NP);
  static constexpr int kX = 16;
  static constexpr int kB = kX + kT * kSX * 4;
  static constexpr int kLoc = kB + kT * kSB * static_cast<int>(sizeof(TB));
  static constexpr int bytes(int nt) { return kLoc + (nt * kT + kMaxTiles) * 4; }
};

// Stage 3: 2 barriers, C tile (kT x SC), the key region (the state S, HD x SS
// float, then per key tile B (kT x SC) and x (kT x SX float)), loc, tot.
template <typename TB, int HD, int NP>
struct ScanLayout {
  static constexpr int kSC = row_stride<TB, true>(NP);
  static constexpr int kSS = row_stride<float, true>(NP);
  static constexpr int kSX = HD + 4;  // x read as (2t, g): 4 (mod 32) words
  static constexpr int kC = 16;
  static constexpr int kKey = kC + kT * kSC * static_cast<int>(sizeof(TB));
  static constexpr int kKeyX = kKey + kT * kSC * static_cast<int>(sizeof(TB));
  static constexpr int kKeyEnd = kKeyX + kT * kSX * 4 > kKey + HD * kSS * 4
                                     ? kKeyX + kT * kSX * 4
                                     : kKey + HD * kSS * 4;
  static constexpr int kLoc = kKeyEnd;
  static constexpr int bytes(int nt) { return kLoc + (nt * kT + kMaxTiles) * 4; }
};

// -- split TF32 -----------------------------------------------------------------
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// v = hi + lo + r, |r| < 2^-20 |v|: hi and lo with the low 13 mantissa bits cleared.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(v) & kTf32Mask;
  hi = h;
  lo = __float_as_uint(v - __uint_as_float(h)) & kTf32Mask;
}

// A value read from a T tile: a bfloat16 is exact in TF32 (lo = 0, unused).
template <typename T>
__device__ __forceinline__ void split_ld(const T* p, uint32_t& hi, uint32_t& lo) {
  if constexpr (std::is_same<T, float>::value) {
    split(*p, hi, lo);
  } else {
    hi = __float_as_uint(ld(p));
    lo = 0u;
  }
}

// d (16 x 8) += a (16 x 8) . b (8 x 8), TF32 inputs, float32 accumulator.
// Not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a.b[j] for the n-steps j < kN with j <= last: one term of a
// split product over a row of independent accumulators.
template <int kN>
__device__ __forceinline__ void mma_row(float (&d)[kN][4], const uint32_t (&a)[4],
                                        const uint32_t (&b)[kN][2], int last = kN - 1) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
    if (j <= last) mma(d[j], a, b[j]);
}

// The same in split TF32: the cross terms first, then hi.hi, each term
// over every j before the next, so that consecutive products are
// independent; an operand exact in TF32 (kAExact, kBExact) has no lo part.
template <bool kAExact, bool kBExact, int kN>
__device__ __forceinline__ void mma3_row(float (&d)[kN][4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], const uint32_t (&bh)[kN][2],
                                         const uint32_t (&bl)[kN][2], int last = kN - 1) {
  if constexpr (!kAExact) mma_row(d, al, bh, last);
  if constexpr (!kBExact) mma_row(d, ah, bl, last);
  mma_row(d, ah, bh, last);
}

// -- shared helpers ---------------------------------------------------------------
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Zero [begin, end) of shared memory (16-byte aligned, a multiple of 16 bytes).
__device__ __forceinline__ void zero_smem(unsigned char* begin, unsigned char* end) {
  float4* p = reinterpret_cast<float4*>(begin);
  const int n = static_cast<int>(end - begin) / 16;
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Rows [0, rows) from global memory (row stride gstride elements) to shared
// memory (row stride sstride elements), row_bytes each, one bulk copy a row
// from the lanes of one warp; completion counted on bar.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int sstride, const T* src, long long gstride,
                                          int rows, int row_bytes, uint64_t* bar, int lane) {
  for (int r = lane; r < rows; r += 32)
    hopper::bulk_load(dst + r * sstride, src + r * gstride, row_bytes, bar);
}

// Warp 0 arms bar for `bytes` and issues the copies `issue(lane)` makes.
template <typename F>
__device__ __forceinline__ void load_tiles(uint64_t* bar, uint32_t bytes, const F& issue) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) hopper::mbar_expect_tx(bar, bytes);
    __syncwarp();
    issue(threadIdx.x);
  }
}

// loc[i]: cumsum of a inside i's 64-row tile; tot[t]: tile t's sum (zero
// past Lc); one warp a tile, two entries a lane.
__device__ __forceinline__ void tile_cumsums(const float* __restrict__ ac, long long sl, int Lc,
                                             int nt, float* loc, float* tot) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = warp; t < nt; t += blockDim.x / 32) {
    const int i = t * kT + 2 * lane;
    const float a0 = i < Lc ? ac[i * sl] : 0.f;
    const float a1 = i + 1 < Lc ? ac[(i + 1) * sl] : 0.f;
    float incl = a0 + a1;
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
}

// Sum of the tile totals tot[lo..hi), in order.
__device__ __forceinline__ float tile_sum(const float* tot, int lo, int hi) {
  float v = 0.f;
  for (int t = lo; t < hi; ++t) v += tot[t];
  return v;
}

// -- stage 1: chunk states --------------------------------------------------------
// s[p, n] = sum_l x[l, p] w_l B[l, n], w_l = exp(cs_last - cs_l): an (hd x
// N) product over Lc, A = x^T and B o w both MN-major.  Warp w owns columns
// [w NP/4, (w + 1) NP/4) of s and all its HD rows.
template <typename TB, int HD, int NP>
__global__ void __launch_bounds__(kThreads, 3)
chunk_states_kernel(const float* __restrict__ x, const TB* __restrict__ Bm,
                    const float* __restrict__ a, float* __restrict__ states,
                    float* __restrict__ totals, const Geometry geo) {
  using L = StatesLayout<TB, HD, NP>;
  constexpr int kMT = HD / 16, kNT = NP / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* xs = reinterpret_cast<float*>(smem + L::kX);
  TB* bs = reinterpret_cast<TB*>(smem + L::kB);
  const int nt = (geo.Lc + kT - 1) / kT;
  float* w = reinterpret_cast<float*>(smem + L::kLoc);  // loc, then the decays w
  float* tot = w + nt * kT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  int id = blockIdx.x;  // (b, c, h), the heads of one chunk adjacent: they share B
  const int h = id % geo.H;
  id /= geo.H;
  const int c = id % geo.nc;
  const int b = id / geo.nc;
  const int grp = h / (geo.H / geo.G);
  const float* xc = x + b * geo.x.b + h * geo.x.h + c * geo.x.c;
  const TB* bc = Bm + b * geo.B.b + grp * geo.B.h + c * geo.B.c;
  const float* ac = a + b * geo.a.b + h * geo.a.h + c * geo.a.c;
  const size_t bhc = (static_cast<size_t>(b) * geo.H + h) * geo.nc + c;

  // pad columns stay zero; rows past a ragged last tile meet w = 0 and must
  // not hold NaN patterns
  if (geo.N != NP || geo.hd != HD || geo.Lc % kT != 0) zero_smem(smem + L::kX, smem + L::kLoc);
  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_mbar_init();
  }
  tile_cumsums(ac, geo.a.l, geo.Lc, nt, w, tot);
  fence_proxy_async();
  __syncthreads();
  // w_l = exp(cs_last - cs_l) = exp((a over tiles t_l..nt-1) - loc_l); 0 past Lc
  for (int i = tid; i < nt * kT; i += kThreads)
    w[i] = i < geo.Lc ? expf(tile_sum(tot, i / kT, nt) - w[i]) : 0.f;
  if (tid == 0) totals[bhc] = tile_sum(tot, 0, nt);
  __syncthreads();

  const int n0 = warp * (NP / 4);
  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;

  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kT, rows = min(kT, geo.Lc - k0);
    load_tiles(bar, rows * (geo.hd * 4 + geo.N * static_cast<int>(sizeof(TB))), [&](int ln) {
      copy_rows(xs, L::kSX, xc + k0 * geo.x.l, geo.x.l, rows, geo.hd * 4, bar, ln);
      copy_rows(bs, L::kSB, bc + k0 * geo.B.l, geo.B.l, rows,
                geo.N * static_cast<int>(sizeof(TB)), bar, ln);
    });
    hopper::mbar_wait(bar, kt & 1);
    // rows past Lc (stale or zero) meet w = 0
    const float* wk = w + k0;
#pragma unroll
    for (int ks = 0; ks < kT / 8; ++ks) {
      const int l0 = 8 * ks + t, l1 = l0 + 4;
      const float w0 = wk[l0], w1 = wk[l1];
      uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const int n = n0 + 8 * j + g;
        split(ld(bs + l0 * L::kSB + n) * w0, bh[j][0], bl[j][0]);
        split(ld(bs + l1 * L::kSB + n) * w1, bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int p = 16 * m + g;
        uint32_t ah[4], al[4];
        split(xs[l0 * L::kSX + p], ah[0], al[0]);
        split(xs[l0 * L::kSX + p + 8], ah[1], al[1]);
        split(xs[l1 * L::kSX + p], ah[2], al[2]);
        split(xs[l1 * L::kSX + p + 8], ah[3], al[3]);
        mma3_row<false, false>(acc[m], ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with the tiles before they are refilled
  }

  float* st = states + bhc * geo.hd * geo.N;
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + 8 * j + 2 * t;
      if (n >= geo.N) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * m + g + 8 * r;
        if (p < geo.hd)
          *reinterpret_cast<float2*>(st + static_cast<size_t>(p) * geo.N + n) =
              make_float2(acc[m][j][2 * r], acc[m][j][2 * r + 1]);
      }
    }
}

// -- stage 2: state pass --------------------------------------------------------
// states (BH, nc, entries): on entry the chunk states s_c, on exit the state
// S_{c-1} each chunk starts from (S_{-1} = 0).  A thread owns 4 entries of
// one (b, h) and walks its chunks in order, loading 8 chunks ahead.
__global__ void __launch_bounds__(256)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ totals, int nc,
                  int entries) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= entries) return;
  const size_t bh = blockIdx.y;
  float4* s = reinterpret_cast<float4*>(states + bh * nc * entries + i);
  const float* tot = totals + bh * nc;
  const int q = entries / 4;
  float4 S = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 8) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < nc) v[j] = s[static_cast<size_t>(c0 + j) * q];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (c0 + j >= nc) break;
      s[static_cast<size_t>(c0 + j) * q] = S;
      const float k = expf(tot[c0 + j]);
      S.x = __fadd_rn(__fmul_rn(S.x, k), v[j].x);
      S.y = __fadd_rn(__fmul_rn(S.y, k), v[j].y);
      S.z = __fadd_rn(__fmul_rn(S.z, k), v[j].z);
      S.w = __fadd_rn(__fmul_rn(S.w, k), v[j].w);
    }
  }
}

// -- stage 3: chunk scan --------------------------------------------------------
// y[i] = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) x_j + exp(cs_i) C_i S^T for
// the 64 rows of one query tile.  kSplit shares of 4 warps: warp (rg,
// half) owns rows 16 rg .. 16 rg + 15 and share `half` of the work on
// them, the keys 64 half / kSplit .. of each key tile and the N columns
// half N / kSplit .. of C S^T, into a partial y of all HD columns; with
// two shares the partials meet in shared memory at the end.  Key tiles
// past the diagonal are skipped, and inside the diagonal tile the 8-key
// steps past a warp's last row.
template <typename TB, int HD, int NP, int kSplit>
__global__ void __launch_bounds__(scan_threads(kSplit), 2)
chunk_scan_kernel(const float* __restrict__ x, const TB* __restrict__ Bm,
                  const TB* __restrict__ Cm, const float* __restrict__ a,
                  const float* __restrict__ starts, float* __restrict__ y, const Geometry geo) {
  using L = ScanLayout<TB, HD, NP>;
  constexpr bool kExact = std::is_same<TB, __nv_bfloat16>::value;
  constexpr int kPN = HD / 8;       // 8-column steps of y
  constexpr int kJN = kT / 8 / kSplit;  // 8-key steps of a warp's share of a key tile
  constexpr int kKS = NP / 8 / kSplit;  // 8-column steps of a warp's share of N
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar_c = reinterpret_cast<uint64_t*>(smem);
  uint64_t* bar_k = bar_c + 1;
  TB* cs = reinterpret_cast<TB*>(smem + L::kC);
  float* ss = reinterpret_cast<float*>(smem + L::kKey);
  TB* kb = reinterpret_cast<TB*>(smem + L::kKey);
  float* kx = reinterpret_cast<float*>(smem + L::kKeyX);
  const int nt = (geo.Lc + kT - 1) / kT;
  float* loc = reinterpret_cast<float*>(smem + L::kLoc);
  float* tot = loc + nt * kT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 4, half = warp / 4;
  int id = blockIdx.x;  // (qt, b, c, h): longest tiles first, heads of a chunk adjacent
  const int h = id % geo.H;
  id /= geo.H;
  const int c = id % geo.nc;
  id /= geo.nc;
  const int b = id % geo.batch;
  const int qt = nt - 1 - id / geo.batch;
  const int grp = h / (geo.H / geo.G);
  const float* xc = x + b * geo.x.b + h * geo.x.h + c * geo.x.c;
  const TB* bc = Bm + b * geo.B.b + grp * geo.B.h + c * geo.B.c;
  const TB* cc = Cm + b * geo.C.b + grp * geo.C.h + c * geo.C.c;
  const float* ac = a + b * geo.a.b + h * geo.a.h + c * geo.a.c;
  const size_t bhc = (static_cast<size_t>(b) * geo.H + h) * geo.nc + c;
  const float* st = starts + bhc * geo.hd * geo.N;
  const int rowb = geo.N * static_cast<int>(sizeof(TB));
  // zero fill matters only where a tile is not filled whole: pad columns
  // of hd or N, or rows past a ragged last tile
  const bool padded = geo.N != NP || geo.hd != HD || geo.Lc % kT != 0;

  if (padded) zero_smem(smem + L::kC, smem + L::kKeyEnd);
  if (tid == 0) {
    hopper::mbar_init(bar_c, 1);
    hopper::mbar_init(bar_k, 1);
    hopper::fence_mbar_init();
  }
  tile_cumsums(ac, geo.a.l, geo.Lc, nt, loc, tot);
  fence_proxy_async();
  __syncthreads();

  const int q0 = qt * kT, qrows = min(kT, geo.Lc - q0);
  const bool has_state = c > 0;  // chunk 0 starts from zero
  load_tiles(bar_c, qrows * rowb + (has_state ? geo.hd * geo.N * 4 : 0), [&](int ln) {
    copy_rows(cs, L::kSC, cc + q0 * geo.C.l, geo.C.l, qrows, rowb, bar_c, ln);
    if (has_state) copy_rows(ss, L::kSS, st, geo.N, geo.hd, geo.N * 4, bar_c, ln);
  });
  const int r0 = 16 * rg + g;  // the thread's rows r0 and r0 + 8 of the tile
  float yacc[kPN][4];
#pragma unroll
  for (int pn = 0; pn < kPN; ++pn)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[pn][e] = 0.f;
  hopper::mbar_wait(bar_c, 0);

  // A fragments of C's rows for the 8-column step ks of N
  auto c_frag = [&](int ks, uint32_t(&ah)[4], uint32_t(&al)[4]) {
    const TB* row = cs + r0 * L::kSC + 8 * ks + t;
    split_ld(row, ah[0], al[0]);
    split_ld(row + 8 * L::kSC, ah[1], al[1]);
    split_ld(row + 4, ah[2], al[2]);
    split_ld(row + 8 * L::kSC + 4, ah[3], al[3]);
  };

  if (has_state) {  // (C S^T) o exp(cs) over this warp's half of N, S (hd x N) K-major
#pragma unroll 2
    for (int kk = 0; kk < kKS; ++kk) {
      const int ks = half * kKS + kk;
      uint32_t ah[4], al[4], bh[kPN][2], bl[kPN][2];
      c_frag(ks, ah, al);
#pragma unroll
      for (int pn = 0; pn < kPN; ++pn) {
        const float* srow = ss + (8 * pn + g) * L::kSS + 8 * ks + t;
        split(srow[0], bh[pn][0], bl[pn][0]);
        split(srow[4], bh[pn][1], bl[pn][1]);
      }
      mma3_row<kExact, false>(yacc, ah, al, bh, bl);
    }
    const float off = tile_sum(tot, 0, qt);  // cs before the tile
    const float e0 = expf(off + loc[q0 + r0]), e1 = expf(off + loc[q0 + r0 + 8]);
#pragma unroll
    for (int pn = 0; pn < kPN; ++pn) {
      yacc[pn][0] *= e0;
      yacc[pn][1] *= e0;
      yacc[pn][2] *= e1;
      yacc[pn][3] *= e1;
    }
  }
  __syncthreads();  // every warp is done with S
  if (padded) {
    zero_smem(smem + L::kKey, smem + L::kKeyEnd);  // pad columns of the key tiles
    fence_proxy_async();
    __syncthreads();
  }

  const int kj = half * kJN * 8;  // first key of the warp's share of a key tile
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kT, krows = min(kT, geo.Lc - k0);
    load_tiles(bar_k, krows * (rowb + geo.hd * 4), [&](int ln) {
      copy_rows(kb, L::kSC, bc + k0 * geo.B.l, geo.B.l, krows, rowb, bar_k, ln);
      copy_rows(kx, L::kSX, xc + k0 * geo.x.l, geo.x.l, krows, geo.hd * 4, bar_k, ln);
    });
    const float span = tile_sum(tot, kt, qt);  // a over tiles kt..qt-1
    const bool diag = kt == qt;
    // the warp's last 8-key step (local to its half) at or below its rows
    const int jlast = diag ? 2 * rg + 1 - half * kJN : kJN - 1;
    hopper::mbar_wait(bar_k, kt & 1);
    if (jlast >= 0) {
      // scores C B^T, B K-major
      float s[kJN][4];
#pragma unroll
      for (int jn = 0; jn < kJN; ++jn)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jn][e] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < NP / 8; ++ks) {
        uint32_t ah[4], al[4], bh[kJN][2], bl[kJN][2];
        c_frag(ks, ah, al);
#pragma unroll
        for (int jn = 0; jn < kJN; ++jn) {
          if (jn > jlast) continue;
          const TB* brow = kb + (kj + 8 * jn + g) * L::kSC + 8 * ks + t;
          split_ld(brow, bh[jn][0], bl[jn][0]);
          split_ld(brow + 4, bh[jn][1], bl[jn][1]);
        }
        mma3_row<kExact, kExact>(s, ah, al, bh, bl, jlast);
      }

      // P = scores o L: exp(loc_i - loc_j + span) at or below the diagonal,
      // a select above it (where the exponent may overflow)
      const float li0 = loc[q0 + r0] + span, li1 = loc[q0 + r0 + 8] + span;
#pragma unroll
      for (int jn = 0; jn < kJN; ++jn) {
        if (jn > jlast) continue;
        const int cj = kj + 8 * jn + 2 * t;
        const float lj0 = loc[k0 + cj], lj1 = loc[k0 + cj + 1];
        s[jn][0] = diag && cj > r0 ? 0.f : s[jn][0] * expf(li0 - lj0);
        s[jn][1] = diag && cj + 1 > r0 ? 0.f : s[jn][1] * expf(li0 - lj1);
        s[jn][2] = diag && cj > r0 + 8 ? 0.f : s[jn][2] * expf(li1 - lj0);
        s[jn][3] = diag && cj + 1 > r0 + 8 ? 0.f : s[jn][3] * expf(li1 - lj1);
      }

      // y += P x: P's accumulator fragments as A fragments (k = t <-> key
      // 2t, k = t + 4 <-> key 2t + 1), x's rows read in that order
#pragma unroll
      for (int jn = 0; jn < kJN; ++jn) {
        if (jn > jlast) continue;
        uint32_t ah[4], al[4];
        split(s[jn][0], ah[0], al[0]);
        split(s[jn][2], ah[1], al[1]);
        split(s[jn][1], ah[2], al[2]);
        split(s[jn][3], ah[3], al[3]);
        const float* xrow = kx + (kj + 8 * jn + 2 * t) * L::kSX + g;
        uint32_t bh[kPN][2], bl[kPN][2];
#pragma unroll
        for (int pn = 0; pn < kPN; ++pn) {
          split(xrow[8 * pn], bh[pn][0], bl[pn][0]);
          split(xrow[L::kSX + 8 * pn], bh[pn][1], bl[pn][1]);
        }
        mma3_row<false, false>(yacc, ah, al, bh, bl);
      }
    }
    __syncthreads();  // every warp is done with the key tiles before they are refilled
  }

  // with two shares, the partials: warp (rg, half) keeps columns half *
  // HD/2 .. and hands the other half to its partner through shared memory
  // (the key region, free again), lane by lane (red[rg][half][step][e][lane])
  constexpr int kHalf = kPN / 2;
  if constexpr (kSplit == 2) {
    float* red = reinterpret_cast<float*>(smem + L::kKey);
    float* mine = red + ((rg * 2 + half) * kHalf * 4) * 32 + lane;
#pragma unroll
    for (int pn = 0; pn < kPN; ++pn) {
      if ((pn < kHalf) == (half == 0)) continue;  // a column step this warp keeps
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[((pn % kHalf) * 4 + e) * 32] = yacc[pn][e];
    }
    __syncthreads();
  }
  float* yc = y + b * geo.y.b + h * geo.y.h + c * geo.y.c;
#pragma unroll
  for (int pn = 0; pn < kPN; ++pn) {
    if constexpr (kSplit == 2) {
      if ((pn < kHalf) != (half == 0)) continue;
      const float* theirs = reinterpret_cast<const float*>(smem + L::kKey) +
                            ((rg * 2 + (1 - half)) * kHalf * 4) * 32 + lane;
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[pn][e] += theirs[((pn % kHalf) * 4 + e) * 32];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = q0 + r0 + 8 * r, p = 8 * pn + 2 * t;
      if (i < geo.Lc && p < geo.hd)
        *reinterpret_cast<float2*>(yc + i * geo.y.l + p) =
            make_float2(yacc[pn][2 * r], yacc[pn][2 * r + 1]);
    }
  }
}

// -- host side ----------------------------------------------------------------------
Strides strides_at(const long long* s) { return {s[0], s[1], s[2], s[3]}; }

struct StatesLaunch {
  const void *x, *Bm, *a;
  void *states, *totals;
  Geometry geo;
  cudaStream_t stream;
  template <typename TB, int HD, int NP>
  int run() const {
    using L = StatesLayout<TB, HD, NP>;
    const int smem = L::bytes((geo.Lc + kT - 1) / kT);
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_states_kernel<TB, HD, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    chunk_states_kernel<TB, HD, NP><<<geo.batch * geo.H * geo.nc, kThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const TB*>(Bm), static_cast<const float*>(a),
        static_cast<float*>(states), static_cast<float*>(totals), geo);
    return cudaGetLastError();
  }
};

struct ScanLaunch {
  const void *x, *Bm, *Cm, *a, *starts;
  void* y;
  Geometry geo;
  cudaStream_t stream;
  template <typename TB, int HD, int NP>
  int run() const {
    using L = ScanLayout<TB, HD, NP>;
    const int nt = (geo.Lc + kT - 1) / kT;
    const int smem = L::bytes(nt);
    constexpr int kSplit = scan_split<TB>();
    const cudaError_t err = cudaFuncSetAttribute(chunk_scan_kernel<TB, HD, NP, kSplit>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    chunk_scan_kernel<TB, HD, NP, kSplit><<<nt * geo.batch * geo.H * geo.nc,
                                            scan_threads(kSplit), smem, stream>>>(
        static_cast<const float*>(x), static_cast<const TB*>(Bm), static_cast<const TB*>(Cm),
        static_cast<const float*>(a), static_cast<const float*>(starts), static_cast<float*>(y),
        geo);
    return cudaGetLastError();
  }
};

template <typename TB, int HD, typename F>
int by_state(const F& f, int N) {
  if (N <= 32) return f.template run<TB, HD, 32>();
  if (N <= 64) return f.template run<TB, HD, 64>();
  if (N <= 128) return f.template run<TB, HD, 128>();
  return cudaErrorInvalidValue;
}

template <typename F>
int dispatch(const F& f, int bf16) {
  const Geometry& geo = f.geo;
  const int unit = bf16 ? 8 : 4;  // N elements in 16 bytes
  if (geo.batch < 1 || geo.nc < 1 || geo.Lc < 1 || geo.Lc > kMaxTiles * kT || geo.H < 1 ||
      geo.G < 1 || geo.H % geo.G != 0 || geo.hd < 4 || geo.hd % 4 != 0 || geo.N < unit ||
      geo.N % unit != 0)
    return cudaErrorInvalidValue;
  if (bf16) {
    if (geo.hd <= 16) return by_state<__nv_bfloat16, 16>(f, geo.N);
    if (geo.hd <= 32) return by_state<__nv_bfloat16, 32>(f, geo.N);
    if (geo.hd <= 64) return by_state<__nv_bfloat16, 64>(f, geo.N);
  } else {
    if (geo.hd <= 16) return by_state<float, 16>(f, geo.N);
    if (geo.hd <= 32) return by_state<float, 32>(f, geo.N);
    if (geo.hd <= 64) return by_state<float, 64>(f, geo.N);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Stage 1.  x (B, H, nc, Lc, hd) float32, Bm (B, G, nc, Lc, N) float32 or
// (bf16 != 0) bfloat16, a (B, H, nc, Lc) float32, each read through its
// strides (b, h or g, c, l: `strides`, 12 int64 in elements) with the last
// dimension contiguous; x's and Bm's rows whole 16-byte units, 16-byte
// aligned.  Writes states (B, H, nc, hd, N) and totals (B, H, nc), float32,
// contiguous.
extern "C" int ssd_chunk_states_launch(const void* x, const void* Bm, const void* a, void* states,
                                       void* totals, int batch, int H, int G, int nc, int Lc,
                                       int hd, int N, int bf16, const long long* strides,
                                       void* stream) {
  Geometry geo{batch, H, G, nc, Lc, hd, N};
  geo.x = strides_at(strides);
  geo.B = strides_at(strides + 4);
  geo.a = strides_at(strides + 8);
  const StatesLaunch f{x, Bm, a, states, totals, geo, static_cast<cudaStream_t>(stream)};
  return dispatch(f, bf16);
}

// Stage 2, in place: states (BH, nc, entries) float32, contiguous, entries
// a multiple of 4; totals (BH, nc).
extern "C" int ssd_state_pass_launch(void* states, const void* totals, int BH, int nc, int entries,
                                     void* stream) {
  if (BH < 1 || BH > 65535 || nc < 1 || entries < 4 || entries % 4 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((entries / 4 + 255) / 256, BH);
  state_pass_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(totals), nc, entries);
  return cudaGetLastError();
}

// Stage 3.  x, Bm, a as in stage 1, Cm like Bm, starts (B, H, nc, hd, N)
// float32 contiguous (stage 2's output), y (B, H, nc, Lc, hd) float32
// through its strides; `strides`: 20 int64, (b, h or g, c, l) of x, Bm, Cm,
// a and y.
extern "C" int ssd_chunk_scan_launch(const void* x, const void* Bm, const void* Cm, const void* a,
                                     const void* starts, void* y, int batch, int H, int G, int nc,
                                     int Lc, int hd, int N, int bf16, const long long* strides,
                                     void* stream) {
  Geometry geo{batch, H, G, nc, Lc, hd, N};
  geo.x = strides_at(strides);
  geo.B = strides_at(strides + 4);
  geo.C = strides_at(strides + 8);
  geo.a = strides_at(strides + 12);
  geo.y = strides_at(strides + 16);
  const ScanLaunch f{x, Bm, Cm, a, starts, y, geo, static_cast<cudaStream_t>(stream)};
  return dispatch(f, bf16);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
