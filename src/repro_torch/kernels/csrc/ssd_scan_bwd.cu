// Mamba2 SSD chunk scan, backward, on Hopper: four launches, products on
// the tensor cores in split TF32.
//
// The backward of the forward in csrc/ssd_scan.cu (the Pallas TPU kernel
// `_ssd_kernel`, src/repro/kernels/ssd_scan/ssd_scan.py, has none: JAX
// differentiates `ssd_chunk_scan`, src/repro/models/mamba2.py, with XLA).
// For batch b, head h and chunk c of Lc steps, rows i, j of the chunk,
// cs = cumsum(a) inside the chunk, T = cs_last, L_ij = exp(cs_i - cs_j) for
// i >= j, S the state the chunk starts from (the forward's stage 2 writes
// it), y the forward's output and dy its cotangent:
//
//   1. chunk dstates, a block per (b, h, c):
//        dS_c = dy^T (C o exp(cs))                                (hd x N)
//   2. reverse state pass, a block per (b, h), sequential over the chunks
//      from the last: Q_c = R_{c+1}, R_c = dS_c + exp(T_c) R_{c+1}
//      (R_nc = 0), Q_c written over dS_c; and the end-state product
//        e_c = <Q_c, S_{c+1}>   (Frobenius; 0 for the last chunk)
//   3. chunk scan backward, a block per (b, h, c), its 64-row tiles from
//      the last:
//        dx_j = sum_{i>=j} (C_i.B_j) L_ij dy_i + exp(T - cs_j) Q_c B_j
//        dB_j = sum_{i>=j} (dy_i.x_j) L_ij C_i + exp(T - cs_j) Q_c^T x_j
//        dC_i = sum_{j<=i} (dy_i.x_j) L_ij B_j + exp(cs_i) S_c^T dy_i
//        dcs_i = dy_i.y_i - x_i.dx_i,  dcs_last += e_c
//        da_k = sum_{i>=k} dcs_i     (inside the chunk, carried over tiles)
//      dB and dC per head, into float32 scratch;
//   4. group sum: dB and dC of group g are the sums over its heads, in head
//      order, written in B's and C's type.
//
// dcs is the gradient of the loss through cs.  Written out, it is the row
// sums of M_ij = (C_i.B_j)(dy_i.x_j) L_ij less its column sums, plus
// dy_i.y_off_i - W_i with W_j = exp(T - cs_j) x_j.Q_c B_j, plus sum_j W_j +
// dT_c on the last row, dT_c = exp(T_c) <R_{c+1}, S_c>.  The row sum of M
// is dy_i.y_diag_i and the column sum x_j.dx_diag_j, so the terms close
// into dy_i.y_i - x_i.dx_i; and sum_j W_j + dT_c = <Q_c, exp(T_c) S_c +
// s_c> = <Q_c, S_{c+1}>.  So stage 3 needs no M: it reads the forward's y
// (saved by the autograd Function) and the dx it has just formed.  The
// plain versions (ref.py) keep M, so they check this closed form.
//
// No atomics: every sum runs in a fixed order (the group sum over heads in
// stage 4, the end-state product as a block reduction in stage 2, row dots
// as shuffles), so two calls on the same inputs give equal bits.
//
// Stage 3's layout: 8 warps.  For the key side of tile t (rows j: dx, dB),
// warps 0-3 own 16 rows each and form dx (scores B C^T over N, then P dy),
// warps 4-7 the same rows and form dB (scores x dy^T over hd, then P' C),
// over the query tiles u >= t, reading one shared copy of each tile.  For
// the query side (rows i: dC), each pair of warps shares 16 rows, both
// form the scores dy x^T and each keeps half of N, over the key tiles
// u <= t.  Products are `mma.sync.m16n8k8` in split TF32 as in the
// forward (float32 operand v = hi + lo, a.b = a_lo.b_hi + a_hi.b_lo +
// a_hi.b_hi; a bfloat16 operand is exact and not split); a score tile's
// accumulator fragments serve as the A fragments of the next product with
// its k index permuted inside each 8-step (k = t <-> 2t, k = t + 4 <-> 2t
// + 1), the B rows read in that order.  Decays come from per-tile sums
// (`loc`, the cumsum of a inside each 64-row tile, and `tot`, the tiles'
// totals), never as the difference of two long cumsums.  Rows arrive by
// `cp.async.bulk` through the caller's strides, one bulk copy a row.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;              // rows per tile
constexpr int kThreads = 128;       // stage 1: 4 warps
constexpr int kScanThreads = 256;   // stage 3: 8 warps
constexpr int kPassThreads = 256;   // stage 2
constexpr int kPassVec = 8;         // float4 a thread in stage 2: hd N <= 8192
constexpr int kMaxTiles = 16;       // Lc <= 1024
constexpr uint32_t kTf32Mask = 0xffffe000u;

struct Strides {
  long long b, h, c, l;  // in elements; the last dimension is contiguous
};

struct Geometry {
  int batch, H, G, nc, Lc, hd, N;
  Strides x, B, C, a, dy, y, dx, da;
};

// Shared-tile row strides (elements): float32 width + 4 (4 mod 32 words:
// rows g and columns t, and rows 2t and columns g, fall in distinct banks),
// bfloat16 8 (mod 64) elements.
template <typename T>
__host__ __device__ constexpr int row_stride(int width) {
  return sizeof(T) == 2 ? (width + 63) / 64 * 64 + 8 : width + 4;
}

// Stage 1: barrier, dy tile (kT x SX float), C tile (kT x SB), loc, tot.
template <typename TB, int HD, int NP>
struct DStatesLayout {
  static constexpr int kSX = HD + 8;  // read MN-major (row t, column g): 8 mod 32
  static constexpr int kSB = sizeof(TB) == 2 ? (NP + 63) / 64 * 64 + 8 : NP + 8;
  static constexpr int kX = 16;
  static constexpr int kB = kX + kT * kSX * 4;
  static constexpr int kLoc = kB + kT * kSB * static_cast<int>(sizeof(TB));
  static constexpr int bytes(int nt) { return kLoc + (nt * kT + kMaxTiles) * 4; }
};

// Stage 3: barrier; the own region (the tile's B then x for the key side,
// its dy for the query side); the other region (Q or S, then per tile C
// and dy, or B and x); loc, tot, and the rows' dy.y and x.dx.
template <typename TB, int HD, int NP>
struct ScanBwdLayout {
  static constexpr int kSB = row_stride<TB>(NP);
  static constexpr int kSX = row_stride<float>(HD);
  static constexpr int kSS = row_stride<float>(NP);
  static constexpr int kTileB = kT * kSB * static_cast<int>(sizeof(TB));
  static constexpr int kTileX = kT * kSX * 4;
  static constexpr int kOwn = 16;
  static constexpr int kOwnX = kOwn + kTileB;
  static constexpr int kOther = kOwnX + kTileX;
  static constexpr int kOtherX = kOther + kTileB;
  static constexpr int kOtherEnd =
      kOtherX + kTileX > kOther + HD * kSS * 4 ? kOtherX + kTileX : kOther + HD * kSS * 4;
  static constexpr int kLoc = kOtherEnd;
  static constexpr int bytes(int nt) { return kLoc + (nt * kT + kMaxTiles + 2 * kT) * 4; }
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
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One k-step of a split product over a row of n-steps: d[j] += a . b(j)
// for lo <= j <= hi, the B fragments of j from b_at(j, bh, bl), eight
// n-steps at a time; each term runs over the eight before the next, so
// consecutive products are independent.  An operand exact in TF32
// (kAExact, kBExact) has no lo part.
template <bool kAExact, bool kBExact, int kN, typename FB>
__device__ __forceinline__ void kstep(float (&d)[kN][4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], const FB& b_at, int lo = 0,
                                      int hi = kN - 1) {
#pragma unroll
  for (int j0 = 0; j0 < kN; j0 += 8) {
    constexpr int kW = kN < 8 ? kN : 8;
    uint32_t bh[kW][2], bl[kW][2];
#pragma unroll
    for (int jj = 0; jj < kW; ++jj) b_at(j0 + jj, bh[jj], bl[jj]);
    if constexpr (!kAExact) {
#pragma unroll
      for (int jj = 0; jj < kW; ++jj)
        if (j0 + jj >= lo && j0 + jj <= hi) mma(d[j0 + jj], al, bh[jj]);
    }
    if constexpr (!kBExact) {
#pragma unroll
      for (int jj = 0; jj < kW; ++jj)
        if (j0 + jj >= lo && j0 + jj <= hi) mma(d[j0 + jj], ah, bl[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < kW; ++jj)
      if (j0 + jj >= lo && j0 + jj <= hi) mma(d[j0 + jj], ah, bh[jj]);
  }
}

// A fragments of rows r0 and r0 + 8 of a row-major tile at columns k0 + t
// and k0 + t + 4.
template <typename T>
__device__ __forceinline__ void a_frag(const T* tile, int stride, int r0, int k0, int t,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const T* p = tile + r0 * stride + k0 + t;
  split_ld(p, ah[0], al[0]);
  split_ld(p + 8 * stride, ah[1], al[1]);
  split_ld(p + 4, ah[2], al[2]);
  split_ld(p + 8 * stride + 4, ah[3], al[3]);
}

// A score tile's accumulator fragments (16 rows x 8 columns) as the A
// fragments of the next product, k permuted (k = t <-> column 2t, k = t + 4
// <-> column 2t + 1).
__device__ __forceinline__ void p_frag(const float (&s)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split(s[0], ah[0], al[0]);
  split(s[2], ah[1], al[1]);
  split(s[1], ah[2], al[2]);
  split(s[3], ah[3], al[3]);
}

template <int kN>
__device__ __forceinline__ void zero(float (&d)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
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
    fence_proxy_async();
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

// -- stage 1: chunk dstates ---------------------------------------------------------
// dS[p, n] = sum_i dy[i, p] w_i C[i, n], w_i = exp(cs_i): an (hd x N)
// product over Lc, A = dy^T and C o w both MN-major.  Warp w owns columns
// [w NP/4, (w + 1) NP/4) of dS and all its HD rows.
template <typename TB, int HD, int NP>
__global__ void __launch_bounds__(kThreads, 3)
chunk_dstates_kernel(const float* __restrict__ dy, const TB* __restrict__ Cm,
                     const float* __restrict__ a, float* __restrict__ dstates, const Geometry geo) {
  using L = DStatesLayout<TB, HD, NP>;
  constexpr int kMT = HD / 16, kNT = NP / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* gs = reinterpret_cast<float*>(smem + L::kX);
  TB* cs = reinterpret_cast<TB*>(smem + L::kB);
  const int nt = (geo.Lc + kT - 1) / kT;
  float* w = reinterpret_cast<float*>(smem + L::kLoc);  // loc, then the decays w
  float* tot = w + nt * kT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  int id = blockIdx.x;  // (b, c, h), the heads of one chunk adjacent: they share C
  const int h = id % geo.H;
  id /= geo.H;
  const int c = id % geo.nc;
  const int b = id / geo.nc;
  const int grp = h / (geo.H / geo.G);
  const float* gc = dy + b * geo.dy.b + h * geo.dy.h + c * geo.dy.c;
  const TB* cc = Cm + b * geo.C.b + grp * geo.C.h + c * geo.C.c;
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
  // w_i = exp(cs_i) = exp((a over tiles 0..t_i-1) + loc_i); 0 past Lc
  for (int i = tid; i < nt * kT; i += kThreads)
    w[i] = i < geo.Lc ? expf(tile_sum(tot, 0, i / kT) + w[i]) : 0.f;
  __syncthreads();

  const int n0 = warp * (NP / 4);
  float acc[kMT][kNT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m) zero(acc[m]);

  for (int kt = 0; kt < nt; ++kt) {
    const int k0 = kt * kT, rows = min(kT, geo.Lc - k0);
    load_tiles(bar, rows * (geo.hd * 4 + geo.N * static_cast<int>(sizeof(TB))), [&](int ln) {
      copy_rows(gs, L::kSX, gc + k0 * geo.dy.l, geo.dy.l, rows, geo.hd * 4, bar, ln);
      copy_rows(cs, L::kSB, cc + k0 * geo.C.l, geo.C.l, rows,
                geo.N * static_cast<int>(sizeof(TB)), bar, ln);
    });
    hopper::mbar_wait(bar, kt & 1);
    const float* wk = w + k0;
#pragma unroll
    for (int ks = 0; ks < kT / 8; ++ks) {
      const int l0 = 8 * ks + t, l1 = l0 + 4;
      const float w0 = wk[l0], w1 = wk[l1];
#pragma unroll
      for (int m = 0; m < kMT; ++m) {
        const int p = 16 * m + g;
        uint32_t ah[4], al[4];
        split(gs[l0 * L::kSX + p], ah[0], al[0]);
        split(gs[l0 * L::kSX + p + 8], ah[1], al[1]);
        split(gs[l1 * L::kSX + p], ah[2], al[2]);
        split(gs[l1 * L::kSX + p + 8], ah[3], al[3]);
        kstep<false, false>(acc[m], ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          const int n = n0 + 8 * j + g;
          split(ld(cs + l0 * L::kSB + n) * w0, bh[0], bl[0]);
          split(ld(cs + l1 * L::kSB + n) * w1, bh[1], bl[1]);
        });
      }
    }
    __syncthreads();  // every warp is done with the tiles before they are refilled
  }

  float* st = dstates + bhc * geo.hd * geo.N;
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

// -- stage 2: reverse state pass ------------------------------------------------
// dstates (BH, nc, entries): on entry dS_c, on exit Q_c.  A block per (b, h)
// walks its chunks from the last, each thread keeping R for up to kPassVec
// float4 of the entries; end[bh, c] = <Q_c, S_{c+1}> as a block reduction
// in a fixed order (S_{c+1} = starts[c + 1]; 0 for the last chunk).
__global__ void __launch_bounds__(kPassThreads)
state_pass_bwd_kernel(float* __restrict__ dstates, const float* __restrict__ starts,
                      const float* __restrict__ totals, float* __restrict__ end, int nc,
                      int entries) {
  __shared__ float red[kPassThreads / 32];
  const size_t bh = blockIdx.x;
  const int tid = threadIdx.x, q = entries / 4;
  float4 R[kPassVec];
#pragma unroll
  for (int k = 0; k < kPassVec; ++k) R[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = nc - 1; c >= 0; --c) {
    float4* ds = reinterpret_cast<float4*>(dstates + (bh * nc + c) * entries);
    const float4* sn =
        c + 1 < nc ? reinterpret_cast<const float4*>(starts + (bh * nc + c + 1) * entries) : nullptr;
    const float k = expf(totals[bh * nc + c]);
    float part = 0.f;
#pragma unroll
    for (int v = 0; v < kPassVec; ++v) {
      const int e = tid + v * kPassThreads;
      if (e >= q) break;
      const float4 d = ds[e];
      ds[e] = R[v];
      if (sn != nullptr) {
        const float4 s = sn[e];
        part = fmaf(R[v].x, s.x, part);
        part = fmaf(R[v].y, s.y, part);
        part = fmaf(R[v].z, s.z, part);
        part = fmaf(R[v].w, s.w, part);
      }
      R[v].x = __fadd_rn(__fmul_rn(R[v].x, k), d.x);
      R[v].y = __fadd_rn(__fmul_rn(R[v].y, k), d.y);
      R[v].z = __fadd_rn(__fmul_rn(R[v].z, k), d.z);
      R[v].w = __fadd_rn(__fmul_rn(R[v].w, k), d.w);
    }
    part = warp_sum(part);
    if (tid % 32 == 0) red[tid / 32] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int w = 0; w < kPassThreads / 32; ++w) s += red[w];
      end[bh * nc + c] = s;
    }
    __syncthreads();  // red is refilled by the next chunk
  }
}

// -- stage 3: chunk scan backward -------------------------------------------------
// A block per (b, h, c); its tiles from the last, each in two phases (the
// key side: dx and dB of its rows; the query side: dC), then da of its
// rows from dcs_i = dy_i.y_i - x_i.dx_i, carried across the tiles.
template <typename TB, int HD, int NP>
__global__ void __launch_bounds__(kScanThreads, 1)
chunk_scan_bwd_kernel(const float* __restrict__ x, const TB* __restrict__ Bm,
                      const TB* __restrict__ Cm, const float* __restrict__ a,
                      const float* __restrict__ dy, const float* __restrict__ y,
                      const float* __restrict__ starts, const float* __restrict__ qs,
                      const float* __restrict__ end, float* __restrict__ dx,
                      float* __restrict__ dBh, float* __restrict__ dCh, float* __restrict__ da,
                      const Geometry geo) {
  using L = ScanBwdLayout<TB, HD, NP>;
  constexpr bool kExact = std::is_same<TB, __nv_bfloat16>::value;
  constexpr int kPN = HD / 8;       // 8-column steps of hd
  constexpr int kNN = NP / 8;       // 8-column steps of N
  constexpr int kNH = NP / 16;      // 8-column steps of half of N
  constexpr int kJN = kT / 8;       // 8-row steps of a tile
  constexpr int kAcc = kPN > kNN ? kPN : kNN;
  constexpr int kRow = static_cast<int>(sizeof(TB));
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  TB* own_b = reinterpret_cast<TB*>(smem + L::kOwn);       // key side: B_t
  float* own_x = reinterpret_cast<float*>(smem + L::kOwnX);  // key side: x_t
  float* own_g = reinterpret_cast<float*>(smem + L::kOwn);   // query side: dy_t
  float* qss = reinterpret_cast<float*>(smem + L::kOther);   // Q or S (HD x kSS)
  TB* oth_b = reinterpret_cast<TB*>(smem + L::kOther);       // C_u or B_u
  float* oth_x = reinterpret_cast<float*>(smem + L::kOtherX);  // dy_u or x_u
  const int nt = (geo.Lc + kT - 1) / kT;
  float* loc = reinterpret_cast<float*>(smem + L::kLoc);
  float* tot = loc + nt * kT;
  float* gy = tot + kMaxTiles;  // dy_i.y_i of the tile's rows
  float* xdx = gy + kT;         // x_j.dx_j

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int rg = warp % 4, side = warp / 4;
  int id = blockIdx.x;  // (b, c, h): the heads of a chunk adjacent
  const int h = id % geo.H;
  id /= geo.H;
  const int c = id % geo.nc;
  const int b = id / geo.nc;
  const int grp = h / (geo.H / geo.G);
  const float* xc = x + b * geo.x.b + h * geo.x.h + c * geo.x.c;
  const TB* bc = Bm + b * geo.B.b + grp * geo.B.h + c * geo.B.c;
  const TB* cc = Cm + b * geo.C.b + grp * geo.C.h + c * geo.C.c;
  const float* ac = a + b * geo.a.b + h * geo.a.h + c * geo.a.c;
  const float* gc = dy + b * geo.dy.b + h * geo.dy.h + c * geo.dy.c;
  const float* yc = y + b * geo.y.b + h * geo.y.h + c * geo.y.c;
  float* dxc = dx + b * geo.dx.b + h * geo.dx.h + c * geo.dx.c;
  float* dac = da + b * geo.da.b + h * geo.da.h + c * geo.da.c;
  const size_t bhc = (static_cast<size_t>(b) * geo.H + h) * geo.nc + c;
  const float* sc = starts + bhc * geo.hd * geo.N;
  const float* qc = qs + bhc * geo.hd * geo.N;
  float* dbc = dBh + bhc * geo.Lc * NP;
  float* dcc = dCh + bhc * geo.Lc * NP;
  const int rowb = geo.N * kRow, rowx = geo.hd * 4, rows_s = geo.N * 4;
  // pad columns of hd or N, and rows past a ragged last tile, must read as
  // zero: such instances zero a region before every load into it
  const bool padded = geo.N != NP || geo.hd != HD || geo.Lc % kT != 0;
  const bool has_state = c > 0;  // chunk 0 starts from zero

  if (tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_mbar_init();
  }
  tile_cumsums(ac, geo.a.l, geo.Lc, nt, loc, tot);
  __syncthreads();
  const float last = end[bhc];
  uint32_t phase = 0;
  float carry = 0.f;  // warp 0: da's sum over the later tiles

  // loads into [lo, hi) after every warp is done with it
  auto refill = [&](unsigned char* lo, unsigned char* hi, uint32_t bytes, auto issue) {
    __syncthreads();
    if (padded) {
      zero_smem(lo, hi);
      fence_proxy_async();
      __syncthreads();
    }
    load_tiles(bar, bytes, issue);
    hopper::mbar_wait(bar, phase);
    phase ^= 1u;
  };

  const int r0 = 16 * rg + g;  // the thread's rows r0 and r0 + 8 of the tile
  for (int tt = nt - 1; tt >= 0; --tt) {
    const int t0 = tt * kT, trows = min(kT, geo.Lc - t0);
    const float before = tile_sum(tot, 0, tt);  // cs before the tile

    // ---- key side: rows j of tile tt ----------------------------------------
    refill(smem + L::kOwn, smem + L::kOtherEnd, trows * (rowb + rowx) + geo.hd * rows_s,
           [&](int ln) {
             copy_rows(own_b, L::kSB, bc + t0 * geo.B.l, geo.B.l, trows, rowb, bar, ln);
             copy_rows(own_x, L::kSX, xc + t0 * geo.x.l, geo.x.l, trows, rowx, bar, ln);
             copy_rows(qss, L::kSS, qc, geo.N, geo.hd, rows_s, bar, ln);
           });
    // exp(T - cs_j) = exp((a over tiles tt..nt-1) - loc_j) for the thread's rows
    const float after = tile_sum(tot, tt, nt);
    const float wq0 = expf(after - loc[t0 + r0]), wq1 = expf(after - loc[t0 + r0 + 8]);
    // one accumulator for either side, so that both are not live at once:
    // dx in its first kPN steps (side 0), dB (side 1)
    float acc[kAcc][4];
    auto& dxa = *reinterpret_cast<float(*)[kPN][4]>(&acc[0][0]);
    auto& dba = *reinterpret_cast<float(*)[kNN][4]>(&acc[0][0]);
    if (side == 0) {
      // dx_j = exp(T - cs_j) (B_j . Q^T): k over N, Q (hd x N) K-major
      zero(dxa);
#pragma unroll 2
      for (int ks = 0; ks < kNN; ++ks) {
        uint32_t ah[4], al[4];
        a_frag(own_b, L::kSB, r0, 8 * ks, t, ah, al);
        kstep<kExact, false>(dxa, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          const float* q = qss + (8 * j + g) * L::kSS + 8 * ks + t;
          split(q[0], bh[0], bl[0]);
          split(q[4], bh[1], bl[1]);
        });
      }
#pragma unroll
      for (int j = 0; j < kPN; ++j) {
        dxa[j][0] *= wq0;
        dxa[j][1] *= wq0;
        dxa[j][2] *= wq1;
        dxa[j][3] *= wq1;
      }
    } else {
      // dB_j = exp(T - cs_j) (x_j . Q): k over hd, Q MN-major
      zero(dba);
#pragma unroll 2
      for (int ks = 0; ks < kPN; ++ks) {
        uint32_t ah[4], al[4];
        a_frag(own_x, L::kSX, r0, 8 * ks, t, ah, al);
        kstep<false, false>(dba, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          const float* q = qss + (8 * ks + t) * L::kSS + 8 * j + g;
          split(q[0], bh[0], bl[0]);
          split(q[4 * L::kSS], bh[1], bl[1]);
        });
      }
#pragma unroll
      for (int j = 0; j < kNN; ++j) {
        dba[j][0] *= wq0;
        dba[j][1] *= wq0;
        dba[j][2] *= wq1;
        dba[j][3] *= wq1;
      }
    }

    for (int u = tt; u < nt; ++u) {
      const int u0 = u * kT, urows = min(kT, geo.Lc - u0);
      refill(smem + L::kOther, smem + L::kOtherEnd, urows * (rowb + rowx), [&](int ln) {
        copy_rows(oth_b, L::kSB, cc + u0 * geo.C.l, geo.C.l, urows, rowb, bar, ln);
        copy_rows(oth_x, L::kSX, gc + u0 * geo.dy.l, geo.dy.l, urows, rowx, bar, ln);
      });
      const bool diag = u == tt;
      // query steps at or after the warp's first row (queries i >= j)
      const int jfirst = diag ? 2 * rg : 0;
      const float span = tile_sum(tot, tt, u);  // a over tiles tt..u-1
      float s[kJN][4];
      zero(s);
      if (side == 0) {  // scores B_t C_u^T over N
#pragma unroll 2
        for (int ks = 0; ks < kNN; ++ks) {
          uint32_t ah[4], al[4];
          a_frag(own_b, L::kSB, r0, 8 * ks, t, ah, al);
          kstep<kExact, kExact>(s, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
            const TB* p = oth_b + (8 * j + g) * L::kSB + 8 * ks + t;
            split_ld(p, bh[0], bl[0]);
            split_ld(p + 4, bh[1], bl[1]);
          }, jfirst);
        }
      } else {  // scores x_t dy_u^T over hd
#pragma unroll 2
        for (int ks = 0; ks < kPN; ++ks) {
          uint32_t ah[4], al[4];
          a_frag(own_x, L::kSX, r0, 8 * ks, t, ah, al);
          kstep<false, false>(s, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
            const float* p = oth_x + (8 * j + g) * L::kSX + 8 * ks + t;
            split(p[0], bh[0], bl[0]);
            split(p[4], bh[1], bl[1]);
          }, jfirst);
        }
      }
      // times L_ij = exp(loc_i - loc_j + span) for i >= j, a select below
      const float lj0 = loc[t0 + r0] - span, lj1 = loc[t0 + r0 + 8] - span;
#pragma unroll
      for (int jn = 0; jn < kJN; ++jn) {
        const int ci = 8 * jn + 2 * t;
        const float li0 = loc[u0 + ci], li1 = loc[u0 + ci + 1];
        s[jn][0] = diag && ci < r0 ? 0.f : s[jn][0] * expf(li0 - lj0);
        s[jn][1] = diag && ci + 1 < r0 ? 0.f : s[jn][1] * expf(li1 - lj0);
        s[jn][2] = diag && ci < r0 + 8 ? 0.f : s[jn][2] * expf(li0 - lj1);
        s[jn][3] = diag && ci + 1 < r0 + 8 ? 0.f : s[jn][3] * expf(li1 - lj1);
      }
      if (side == 0) {  // dx += P dy_u
#pragma unroll
        for (int jn = 0; jn < kJN; ++jn) {
          if (jn < jfirst) continue;
          uint32_t ah[4], al[4];
          p_frag(s[jn], ah, al);
          const float* grow = oth_x + (8 * jn + 2 * t) * L::kSX + g;
          kstep<false, false>(dxa, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
            split(grow[8 * j], bh[0], bl[0]);
            split(grow[L::kSX + 8 * j], bh[1], bl[1]);
          });
        }
      } else {  // dB += P' C_u
#pragma unroll
        for (int jn = 0; jn < kJN; ++jn) {
          if (jn < jfirst) continue;
          uint32_t ah[4], al[4];
          p_frag(s[jn], ah, al);
          const TB* crow = oth_b + (8 * jn + 2 * t) * L::kSB + g;
          kstep<false, kExact>(dba, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
            split_ld(crow + 8 * j, bh[0], bl[0]);
            split_ld(crow + L::kSB + 8 * j, bh[1], bl[1]);
          });
        }
      }
    }

    // the key side's results: dx and x.dx (side 0), dB per head (side 1)
    if (side == 0) {
      float d0 = 0.f, d1 = 0.f;
#pragma unroll
      for (int pn = 0; pn < kPN; ++pn) {
        const int p = 8 * pn + 2 * t;
        const float* x0 = own_x + r0 * L::kSX + p;
        const float* x1 = x0 + 8 * L::kSX;
        d0 = fmaf(dxa[pn][0], x0[0], d0);
        d0 = fmaf(dxa[pn][1], x0[1], d0);
        d1 = fmaf(dxa[pn][2], x1[0], d1);
        d1 = fmaf(dxa[pn][3], x1[1], d1);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = t0 + r0 + 8 * r;
          if (j < geo.Lc && p < geo.hd)
            *reinterpret_cast<float2*>(dxc + j * geo.dx.l + p) =
                make_float2(dxa[pn][2 * r], dxa[pn][2 * r + 1]);
        }
      }
      d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
      d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
      d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
      if (t == 0) {
        xdx[r0] = d0;
        xdx[r0 + 8] = d1;
      }
    } else {
#pragma unroll
      for (int nn = 0; nn < kNN; ++nn)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int j = t0 + r0 + 8 * r, n = 8 * nn + 2 * t;
          if (j < geo.Lc)
            *reinterpret_cast<float2*>(dbc + static_cast<size_t>(j) * NP + n) =
                make_float2(dba[nn][2 * r], dba[nn][2 * r + 1]);
        }
    }

    // ---- query side: rows i of tile tt ----------------------------------------
    refill(smem + L::kOwn, smem + L::kOtherEnd, trows * rowx + (has_state ? geo.hd * rows_s : 0),
           [&](int ln) {
             copy_rows(own_g, L::kSX, gc + t0 * geo.dy.l, geo.dy.l, trows, rowx, bar, ln);
             if (has_state) copy_rows(qss, L::kSS, sc, geo.N, geo.hd, rows_s, bar, ln);
           });
    // dy_i.y_i of the tile's rows, a warp a row
    for (int r = warp; r < trows; r += kScanThreads / 32) {
      float v = 0.f;
      for (int p = lane; p < geo.hd; p += 32)
        v = fmaf(own_g[r * L::kSX + p], yc[(t0 + r) * geo.y.l + p], v);
      v = warp_sum(v);
      if (lane == 0) gy[r] = v;
    }
    const int n0 = side * kNH;  // the warp's half of N, in 8-column steps
    float dca[kNH][4];
    zero(dca);
    if (has_state) {  // dC_i = exp(cs_i) (dy_i . S): k over hd, S MN-major
#pragma unroll 2
      for (int ks = 0; ks < kPN; ++ks) {
        uint32_t ah[4], al[4];
        a_frag(own_g, L::kSX, r0, 8 * ks, t, ah, al);
        kstep<false, false>(dca, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          const float* q = qss + (8 * ks + t) * L::kSS + 8 * (n0 + j) + g;
          split(q[0], bh[0], bl[0]);
          split(q[4 * L::kSS], bh[1], bl[1]);
        });
      }
      const float e0 = expf(before + loc[t0 + r0]), e1 = expf(before + loc[t0 + r0 + 8]);
#pragma unroll
      for (int j = 0; j < kNH; ++j) {
        dca[j][0] *= e0;
        dca[j][1] *= e0;
        dca[j][2] *= e1;
        dca[j][3] *= e1;
      }
    }
    for (int u = 0; u <= tt; ++u) {
      const int u0 = u * kT, urows = min(kT, geo.Lc - u0);
      refill(smem + L::kOther, smem + L::kOtherEnd, urows * (rowb + rowx), [&](int ln) {
        copy_rows(oth_b, L::kSB, bc + u0 * geo.B.l, geo.B.l, urows, rowb, bar, ln);
        copy_rows(oth_x, L::kSX, xc + u0 * geo.x.l, geo.x.l, urows, rowx, bar, ln);
      });
      const bool diag = u == tt;
      const int jlast = diag ? 2 * rg + 1 : kJN - 1;  // key steps at or below the warp's rows
      const float span = tile_sum(tot, u, tt);        // a over tiles u..tt-1
      float s[kJN][4];
      zero(s);
#pragma unroll 2
      for (int ks = 0; ks < kPN; ++ks) {  // scores dy_t x_u^T over hd
        uint32_t ah[4], al[4];
        a_frag(own_g, L::kSX, r0, 8 * ks, t, ah, al);
        kstep<false, false>(s, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          const float* p = oth_x + (8 * j + g) * L::kSX + 8 * ks + t;
          split(p[0], bh[0], bl[0]);
          split(p[4], bh[1], bl[1]);
        }, 0, jlast);
      }
      const float li0 = loc[t0 + r0] + span, li1 = loc[t0 + r0 + 8] + span;
#pragma unroll
      for (int jn = 0; jn < kJN; ++jn) {
        const int cj = 8 * jn + 2 * t;
        const float lj0 = loc[u0 + cj], lj1 = loc[u0 + cj + 1];
        s[jn][0] = diag && cj > r0 ? 0.f : s[jn][0] * expf(li0 - lj0);
        s[jn][1] = diag && cj + 1 > r0 ? 0.f : s[jn][1] * expf(li0 - lj1);
        s[jn][2] = diag && cj > r0 + 8 ? 0.f : s[jn][2] * expf(li1 - lj0);
        s[jn][3] = diag && cj + 1 > r0 + 8 ? 0.f : s[jn][3] * expf(li1 - lj1);
      }
#pragma unroll
      for (int jn = 0; jn < kJN; ++jn) {  // dC += P' B_u over the warp's half of N
        if (jn > jlast) continue;
        uint32_t ah[4], al[4];
        p_frag(s[jn], ah, al);
        const TB* brow = oth_b + (8 * jn + 2 * t) * L::kSB + 8 * n0 + g;
        kstep<false, kExact>(dca, ah, al, [&](int j, uint32_t(&bh)[2], uint32_t(&bl)[2]) {
          split_ld(brow + 8 * j, bh[0], bl[0]);
          split_ld(brow + L::kSB + 8 * j, bh[1], bl[1]);
        });
      }
    }
#pragma unroll
    for (int nn = 0; nn < kNH; ++nn)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = t0 + r0 + 8 * r, n = 8 * (n0 + nn) + 2 * t;
        if (i < geo.Lc)
          *reinterpret_cast<float2*>(dcc + static_cast<size_t>(i) * NP + n) =
              make_float2(dca[nn][2 * r], dca[nn][2 * r + 1]);
      }

    // ---- da of the tile's rows: the reverse cumsum of dcs, carried --------
    __syncthreads();  // gy and xdx are complete
    if (warp == 0) {
      const int ra = kT - 1 - 2 * lane, rb = ra - 1;  // rows from the tile's end
      auto dcs = [&](int r) {
        if (r >= trows) return 0.f;
        const float v = gy[r] - xdx[r];
        return t0 + r == geo.Lc - 1 ? v + last : v;
      };
      const float va = dcs(ra), vb = dcs(rb);
      float incl = va + vb;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += u;
      }
      float prev = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) prev = 0.f;
      if (ra < trows) dac[(t0 + ra) * geo.da.l] = carry + prev + va;
      if (rb < trows) dac[(t0 + rb) * geo.da.l] = carry + incl;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
  }
}

// -- stage 4: group sum -------------------------------------------------------------
// dB[b, g, c, l, n] = sum over the heads of group g, in order, of dBh[b, h,
// c, l, n] (float32, (B, H, nc, Lc, NPAD) contiguous), in TB through the
// output's strides; the same for dC.  A thread per (row, 4 columns).
template <typename TB>
__global__ void __launch_bounds__(256)
group_sum_kernel(const float* __restrict__ dBh, const float* __restrict__ dCh, TB* __restrict__ dB,
                 TB* __restrict__ dC, int batch, int H, int G, int nc, int Lc, int N, int npad,
                 Strides sb, Strides sc) {
  const int q = npad / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long rows = static_cast<long long>(batch) * G * nc * Lc;
  if (idx >= rows * q) return;
  const int n = static_cast<int>(idx % q) * 4;
  long long r = idx / q;
  const int l = static_cast<int>(r % Lc);
  r /= Lc;
  const int c = static_cast<int>(r % nc);
  r /= nc;
  const int g = static_cast<int>(r % G);
  const int b = static_cast<int>(r / G);
  const int hpg = H / G;
  float4 sb4 = make_float4(0.f, 0.f, 0.f, 0.f), sc4 = sb4;
  for (int k = 0; k < hpg; ++k) {
    const size_t off =
        ((((static_cast<size_t>(b) * H + g * hpg + k) * nc + c) * Lc + l) * npad) + n;
    const float4 vb = *reinterpret_cast<const float4*>(dBh + off);
    const float4 vc = *reinterpret_cast<const float4*>(dCh + off);
    sb4.x += vb.x, sb4.y += vb.y, sb4.z += vb.z, sb4.w += vb.w;
    sc4.x += vc.x, sc4.y += vc.y, sc4.z += vc.z, sc4.w += vc.w;
  }
  const float vb[4] = {sb4.x, sb4.y, sb4.z, sb4.w}, vc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
  TB* ob = dB + b * sb.b + g * sb.h + c * sb.c + l * sb.l;
  TB* oc = dC + b * sc.b + g * sc.h + c * sc.c + l * sc.l;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (n + e >= N) break;
    if constexpr (std::is_same<TB, float>::value) {
      ob[n + e] = vb[e];
      oc[n + e] = vc[e];
    } else {
      ob[n + e] = __float2bfloat16_rn(vb[e]);
      oc[n + e] = __float2bfloat16_rn(vc[e]);
    }
  }
}

// -- host side ----------------------------------------------------------------------
Strides strides_at(const long long* s) { return {s[0], s[1], s[2], s[3]}; }

struct DStatesLaunch {
  const void *dy, *Cm, *a;
  void* dstates;
  Geometry geo;
  cudaStream_t stream;
  template <typename TB, int HD, int NP>
  int run() const {
    using L = DStatesLayout<TB, HD, NP>;
    const int smem = L::bytes((geo.Lc + kT - 1) / kT);
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_dstates_kernel<TB, HD, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    chunk_dstates_kernel<TB, HD, NP><<<geo.batch * geo.H * geo.nc, kThreads, smem, stream>>>(
        static_cast<const float*>(dy), static_cast<const TB*>(Cm), static_cast<const float*>(a),
        static_cast<float*>(dstates), geo);
    return cudaGetLastError();
  }
};

struct ScanBwdLaunch {
  const void *x, *Bm, *Cm, *a, *dy, *y, *starts, *qs, *end;
  void *dx, *dBh, *dCh, *da;
  Geometry geo;
  cudaStream_t stream;
  template <typename TB, int HD, int NP>
  int run() const {
    using L = ScanBwdLayout<TB, HD, NP>;
    const int smem = L::bytes((geo.Lc + kT - 1) / kT);
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_scan_bwd_kernel<TB, HD, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    chunk_scan_bwd_kernel<TB, HD, NP><<<geo.batch * geo.H * geo.nc, kScanThreads, smem, stream>>>(
        static_cast<const float*>(x), static_cast<const TB*>(Bm), static_cast<const TB*>(Cm),
        static_cast<const float*>(a), static_cast<const float*>(dy), static_cast<const float*>(y),
        static_cast<const float*>(starts), static_cast<const float*>(qs),
        static_cast<const float*>(end), static_cast<float*>(dx), static_cast<float*>(dBh),
        static_cast<float*>(dCh), static_cast<float*>(da), geo);
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

bool valid(const Geometry& geo, int bf16) {
  const int unit = bf16 ? 8 : 4;  // N elements in 16 bytes
  return geo.batch >= 1 && geo.nc >= 1 && geo.Lc >= 1 && geo.Lc <= kMaxTiles * kT && geo.H >= 1 &&
         geo.G >= 1 && geo.H % geo.G == 0 && geo.hd >= 4 && geo.hd % 4 == 0 && geo.hd <= 64 &&
         geo.N >= unit && geo.N % unit == 0 && geo.N <= 128;
}

template <typename F>
int dispatch(const F& f, int bf16) {
  const Geometry& geo = f.geo;
  if (!valid(geo, bf16)) return cudaErrorInvalidValue;
  if (bf16) {
    if (geo.hd <= 16) return by_state<__nv_bfloat16, 16>(f, geo.N);
    if (geo.hd <= 32) return by_state<__nv_bfloat16, 32>(f, geo.N);
    return by_state<__nv_bfloat16, 64>(f, geo.N);
  }
  if (geo.hd <= 16) return by_state<float, 16>(f, geo.N);
  if (geo.hd <= 32) return by_state<float, 32>(f, geo.N);
  return by_state<float, 64>(f, geo.N);
}

// The N of the instance that serves N: the width of the per-head scratch rows.
int padded_state(int N) { return N <= 32 ? 32 : N <= 64 ? 64 : 128; }

}  // namespace

// Stage 1.  dy (B, H, nc, Lc, hd) float32, Cm (B, G, nc, Lc, N) float32 or
// (bf16 != 0) bfloat16, a (B, H, nc, Lc) float32, each through its strides
// (b, h or g, c, l: 12 int64 in elements, those of dy, Cm, a) with rows of
// whole 16-byte units, 16-byte aligned.  Writes dstates (B, H, nc, hd, N)
// float32, contiguous.
extern "C" int ssd_chunk_dstates_launch(const void* dy, const void* Cm, const void* a,
                                        void* dstates, int batch, int H, int G, int nc, int Lc,
                                        int hd, int N, int bf16, const long long* strides,
                                        void* stream) {
  Geometry geo{batch, H, G, nc, Lc, hd, N};
  geo.dy = strides_at(strides);
  geo.C = strides_at(strides + 4);
  geo.a = strides_at(strides + 8);
  const DStatesLaunch f{dy, Cm, a, dstates, geo, static_cast<cudaStream_t>(stream)};
  return dispatch(f, bf16);
}

// Stage 2, in place: dstates (BH, nc, entries) float32 holds dS on entry and
// Q on return; starts (BH, nc, entries) the forward's chunk-start states;
// totals (BH, nc); writes end (BH, nc).  Contiguous; entries a multiple of
// 4 up to 8192.
extern "C" int ssd_state_pass_bwd_launch(void* dstates, const void* starts, const void* totals,
                                         void* end, int BH, int nc, int entries, void* stream) {
  if (BH < 1 || nc < 1 || entries < 4 || entries % 4 != 0 ||
      entries > 4 * kPassVec * kPassThreads)
    return cudaErrorInvalidValue;
  state_pass_bwd_kernel<<<BH, kPassThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(dstates), static_cast<const float*>(starts),
      static_cast<const float*>(totals), static_cast<float*>(end), nc, entries);
  return cudaGetLastError();
}

// Stage 3.  x, Bm, Cm, a and dy as above, y (the forward's float32 output)
// like dy; starts and q (B, H, nc, hd, N) and end (B, H, nc) float32
// contiguous.  Writes dx (like x, through its strides), da (like a), and
// dBh, dCh (B, H, nc, Lc, NPAD) float32 contiguous, NPAD = 32, 64 or 128,
// the least at or above N.  `strides`: 32
// int64, (b, h or g, c, l) of x, Bm, Cm, a, dy, y, dx and da.
extern "C" int ssd_chunk_scan_bwd_launch(const void* x, const void* Bm, const void* Cm,
                                         const void* a, const void* dy, const void* y,
                                         const void* starts, const void* q, const void* end,
                                         void* dx, void* dBh, void* dCh, void* da, int batch,
                                         int H, int G, int nc, int Lc, int hd, int N, int bf16,
                                         const long long* strides, void* stream) {
  Geometry geo{batch, H, G, nc, Lc, hd, N};
  geo.x = strides_at(strides);
  geo.B = strides_at(strides + 4);
  geo.C = strides_at(strides + 8);
  geo.a = strides_at(strides + 12);
  geo.dy = strides_at(strides + 16);
  geo.y = strides_at(strides + 20);
  geo.dx = strides_at(strides + 24);
  geo.da = strides_at(strides + 28);
  const ScanBwdLaunch f{x,  Bm,  Cm,  a,  dy, y, starts, q, end,
                        dx, dBh, dCh, da, geo, static_cast<cudaStream_t>(stream)};
  return dispatch(f, bf16);
}

// Stage 4.  dBh, dCh as stage 3 writes them; dB and dC (B, G, nc, Lc, N) in
// float32 or (bf16 != 0) bfloat16 through their strides (8 int64: (b, g,
// c, l) of dB, then of dC).
extern "C" int ssd_group_sum_launch(const void* dBh, const void* dCh, void* dB, void* dC, int batch,
                                    int H, int G, int nc, int Lc, int N, int bf16,
                                    const long long* strides, void* stream) {
  if (batch < 1 || nc < 1 || Lc < 1 || G < 1 || H % G != 0 || N < 1 || N > 128)
    return cudaErrorInvalidValue;
  const int npad = padded_state(N);
  const long long threads = static_cast<long long>(batch) * G * nc * Lc * (npad / 4);
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  const Strides sb = strides_at(strides), sc = strides_at(strides + 4);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    group_sum_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(dBh), static_cast<const float*>(dCh),
        static_cast<__nv_bfloat16*>(dB), static_cast<__nv_bfloat16*>(dC), batch, H, G, nc, Lc, N,
        npad, sb, sc);
  else
    group_sum_kernel<float><<<blocks, 256, 0, s>>>(
        static_cast<const float*>(dBh), static_cast<const float*>(dCh), static_cast<float*>(dB),
        static_cast<float*>(dC), batch, H, G, nc, Lc, N, npad, sb, sc);
  return cudaGetLastError();
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
