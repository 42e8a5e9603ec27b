// Mamba2 SSD chunked scan (CUDA C++, sm_90a): K4 of the port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:ssd_pallas
// (_ssd_kernel).  For each (batch b, head h) the sequence is cut into
// chunks of L tokens, and an (N, P) float32 state S is carried from chunk
// to chunk.  Within a chunk, with cs the inclusive prefix sum of dt:
//
//   M[t][u] = (C_t . B_u) exp(A (cs_t - cs_u)) dt_u   for u <= t, else 0
//   y_t     = sum_u M[t][u] x_u + exp(A cs_t) (C_t . S) + D x_t
//   S      <- exp(A cs_L) S + Z,  Z = sum_u exp(A (cs_L - cs_u)) dt_u B_u (x) x_u
//
// Decomposition.  The TPU grid (B, H, n_chunks) walks the chunks of one
// (b, h) in order on one core and keeps S in VMEM scratch.  Here the
// chunk axis is split across blocks, in four launches on one stream:
//
//   0. chunk_gram, one block per (b, chunk, 64-row t tile, u tile <= t):
//      the tile C_t B_u^T, which is the same for every head, so it is
//      made once and read by every head's pass-3 blocks;
//   1. chunk_state, one block per (b, h, chunk): the chunk's own state
//      contribution Z (N x P) and its decay exp(A cs_L), written to a
//      float32 buffer of states (B, H, n_chunks, N, P);
//   2. state_pass, one thread per (b, h, n, p): the sequential pass over
//      the chunks, S_in(0) = 0, S_in(c + 1) = exp(A cs_L(c)) S_in(c) +
//      Z(c), each chunk's incoming state written over its Z in place;
//   3. chunk_output, one block per (b, h, chunk, 64-row t tile), the
//      tiles with the most causal work first: y = exp(A cs_t) (C S_in) +
//      M x + D x for the tile's rows, M made from each Gram tile up to the
//      diagonal in the A-fragment layout of the product M x.
//
// Separate launches, not a single chained scan: the sequential part is 8
// chunks of an elementwise recurrence, far too little to be worth a
// block-order dependence (a chained scan waits on blocks that may not be
// resident yet), and the launch boundaries order the passes.  Tiles move
// from device memory into shared memory with each lane's 16 loads in
// flight before any store (load_rows): the passes wait on those loads
// more than on the tensor cores.
//
// Tensor cores.  Every product -- Z = (w B)^T X in pass 1, C S_in, C B^T
// and M X in pass 3 -- runs mma.sync m16n8k8 with TF32 operands and a
// float32 accumulator, and keeps the float32 function's accuracy by
// 3xTF32: each float32 operand v splits into v_hi = tf32(v) and v_lo =
// tf32(v - v_hi) (cvt.rna), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi
// (a_lo b_lo, about 2^-22 relative, is dropped).  A bf16 or float16 x is
// exact in TF32 (8 or 10 mantissa bits in 10, and float16's exponent range
// inside TF32's), so the products with x (pass 1's and M X) need only
// a_lo x + a_hi x.  One TF32 product alone keeps about
// 11 bits and misses SSD_TOL (chip_smoke.py); the decay, dt, its prefix
// sum and the exponentials stay float32 on the CUDA cores.  Operand
// tiles sit in shared memory with rows padded so that each fragment load
// of a warp touches 32 distinct banks.  Inside a (t, u) tile the exponent
// A (cs_t - cs_u) is positive for u > t and may overflow, so M is
// selected to 0 there, never multiplied by a 0/1 mask (inf * 0 = NaN).
// The prefix sum of dt is taken by one warp: each lane sums a segment in
// token order, then adds the totals of the lanes below it (the reference
// multiplies by a lower-triangular matrix of ones: the same sums in
// another order).
//
// Layout.  x (B, S, H, P) and y are read and written by their strides
// (head dim contiguous), dt (B, S, H) by its strides, Bm and Cm (B, S, N)
// by their batch and sequence strides (state dim contiguous), so the
// model's slices of its input projection are read in place.  x and y are
// float32, bf16 or float16 (y written in x's type); everything else is
// float32.
//
// What bounds it.  At mamba2-130m's prefill (B = 4, S = 2048, H = 24,
// P = 64, N = 128, L = 256) the function needs about 15 GFLOP of float32
// products and moves about 60 MB; the scratch between the passes adds
// about 230 MB, most of it the Gram tiles read by every head from L2.  At
// the TF32 tensor-core rate the nominal products take 0.031 ms, about as
// long as the function's bytes with the scratch (PERF.md); the kernel
// runs far from both: 3xTF32 executes two to three times the nominal
// products with mma.sync fed from shared memory, and each block waits
// on its tile loads with few warps resident (116 registers a thread).
// wgmma with TMA-fed tiles, and a pass-3 block that keeps its x tiles
// for several t tiles, are the next steps (ROADMAP, K4).
#ifdef HFAV_EMULATE
#include "../../stencil2d/csrc/emulate.h"
#else
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
// the block's dynamic shared memory (emulate.h defines it for the host)
extern __shared__ float hfav_smem[];
#endif
#include <math.h>

namespace ssd {

constexpr int T = 64;  // rows (t or u) of a tile
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int OUT_THREADS = 128;  // pass 3: 4 warps of 16 t rows each
constexpr int PASS_THREADS = 256;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* D;
  void* y;
  float* states;  // (B, H, n_chunks, N, P): Z, then the incoming states
  float* decay;   // (B, H, n_chunks): exp(A cs_L) of each chunk
  float* gram;    // (B, n_chunks, pairs, T, T): C_t B_u^T, u tile <= t tile
  long long B, S, H, P, N, L;
  long long xs[3], dts[3], bs[2], cs[2], ys[3];  // strides, in elements
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ void store(float* q, float v) { *q = v; }
__device__ __forceinline__ void store(__nv_bfloat16* q, float v) {
  *q = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* q, float v) {
  *q = __float2half_rn(v);
}
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ __forceinline__ int pad16(int n) {
  return (n + 15) / 16 * 16;
}

// cvt.rna.tf32.f32: v rounded to TF32, as a float32 bit pattern
__device__ __forceinline__ unsigned tf32(float v) {
#ifdef HFAV_EMULATE
  return hfav_tf32(v);
#else
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
#endif
}

// d += a b, one mma.sync m16n8k8 with TF32 operands
__device__ __forceinline__ void mma(float d[4], const unsigned a[4],
                                    const unsigned b[2]) {
#ifdef HFAV_EMULATE
  hfav_mma_tf32(d, a, b, d);
#else
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// An A fragment split in TF32 terms: hi = tf32(v), lo = tf32(v - hi).
struct Split4 {
  unsigned hi[4], lo[4];
};

__device__ __forceinline__ Split4 split(const float v[4]) {
  Split4 s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s.hi[i] = tf32(v[i]);
    s.lo[i] = tf32(v[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

// Terms of each product: 3 (the kernel), or 1 (a_hi b_hi alone: the CPU
// tests build that to show that one TF32 product misses SSD_TOL).
#ifndef SSD_TF32_TERMS
#define SSD_TF32_TERMS 3
#endif

// d += a b by 3xTF32 (2xTF32 when b is exact in TF32: B_EXACT).
template <bool B_EXACT>
__device__ __forceinline__ void mma3(float d[4], const Split4& a,
                                     const float b[2]) {
  unsigned hi[2], lo[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    hi[i] = tf32(b[i]);
    lo[i] = tf32(b[i] - __uint_as_float(hi[i]));
  }
  if (SSD_TF32_TERMS > 1) {
    mma(d, a.lo, hi);
    if (!B_EXACT) mma(d, a.hi, lo);
  }
  mma(d, a.hi, hi);
}

// A fragment (16 x 8, rows r0 .., columns k0 ..) of a row-major tile with
// row stride `ld`: lane (g, t) holds rows g, g + 8 at columns t, t + 4.
__device__ __forceinline__ void load_a(float a[4], const float* m, int ld,
                                       int r0, int k0, int g, int t) {
  a[0] = m[(r0 + g) * ld + k0 + t];
  a[1] = m[(r0 + g + 8) * ld + k0 + t];
  a[2] = m[(r0 + g) * ld + k0 + t + 4];
  a[3] = m[(r0 + g + 8) * ld + k0 + t + 4];
}

// The same fragment of the transpose of a row-major tile (element (r, k)
// at m[k * ld + r]).
__device__ __forceinline__ void load_at(float a[4], const float* m, int ld,
                                        int r0, int k0, int g, int t) {
  a[0] = m[(k0 + t) * ld + r0 + g];
  a[1] = m[(k0 + t) * ld + r0 + g + 8];
  a[2] = m[(k0 + t + 4) * ld + r0 + g];
  a[3] = m[(k0 + t + 4) * ld + r0 + g + 8];
}

// B fragment (8 x 8, rows k0 .., columns n0 ..) of a row-major K x N tile:
// lane (g, t) holds rows t, t + 4 of column g.
__device__ __forceinline__ void load_b(float b[2], const float* m, int ld,
                                       int k0, int n0, int g, int t) {
  b[0] = m[(k0 + t) * ld + n0 + g];
  b[1] = m[(k0 + t + 4) * ld + n0 + g];
}

// The same fragment of a tile stored transposed (element (k, n) at
// m[n * ld + k]).
__device__ __forceinline__ void load_bt(float b[2], const float* m, int ld,
                                        int k0, int n0, int g, int t) {
  b[0] = m[(n0 + g) * ld + k0 + t];
  b[1] = m[(n0 + g) * ld + k0 + t + 4];
}

// Copy rows [0, nrows) x columns [0, ncols) of a row-major tile in device
// memory (row stride ld elements; row r scaled by scale[r] when given)
// into rows [0, rows) x columns [0, cpad) of a shared tile of row stride
// sst, zeros elsewhere, with CC = ceil(cpad / 32) column steps of a warp.
// Each warp takes 16 / CC rows at a time and each lane loads its 16
// values of them before storing any, so they are in flight together.
template <int CC, typename TS>
__device__ __forceinline__ void load_rows(float* dst, int sst, int rows,
                                          int cpad, const TS* src,
                                          long long ld, int nrows, int ncols,
                                          const float* scale) {
  constexpr int R = 16 / CC;
  const int lane = threadIdx.x % 32, nw = blockDim.x / 32;
  for (int r0 = R * (threadIdx.x / 32); r0 < rows; r0 += R * nw) {
    float v[R][CC];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const TS* const row = src + (r0 + i) * ld;
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        const int col = lane + 32 * k;
        v[i][k] = r0 + i < nrows && col < ncols ? to_f(row[col]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (r0 + i >= rows) break;
      const float f = scale != nullptr && r0 + i < nrows ? scale[r0 + i]
                                                          : 1.f;
#pragma unroll
      for (int k = 0; k < CC; ++k) {
        const int col = lane + 32 * k;
        if (col < cpad) dst[(r0 + i) * sst + col] = v[i][k] * f;
      }
    }
  }
}

// load_rows for any cpad <= 128.
template <typename TS>
__device__ __forceinline__ void load_tile(float* dst, int sst, int rows,
                                          int cpad, const TS* src,
                                          long long ld, int nrows, int ncols,
                                          const float* scale) {
  switch ((cpad + 31) / 32) {
    case 1:
      load_rows<1>(dst, sst, rows, cpad, src, ld, nrows, ncols, scale);
      break;
    case 2:
      load_rows<2>(dst, sst, rows, cpad, src, ld, nrows, ncols, scale);
      break;
    case 3:
      load_rows<3>(dst, sst, rows, cpad, src, ld, nrows, ncols, scale);
      break;
    default:
      load_rows<4>(dst, sst, rows, cpad, src, ld, nrows, ncols, scale);
  }
}

// dt of chunk `c` into dts[0, L) and its inclusive prefix sum into cum:
// warp 0 takes it, each lane a segment in token order plus the totals of
// the lanes below it (tot: 32 floats).  Ends with a block barrier.
__device__ __forceinline__ void chunk_dt(const Params& p, const float* dt,
                                         long long s0, float* dts,
                                         float* cum, float* tot) {
  const int L = static_cast<int>(p.L);
  for (int i = threadIdx.x; i < L; i += blockDim.x)
    dts[i] = dt[(s0 + i) * p.dts[1]];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, seg = (L + 31) / 32;
    const int lo = imin(lane * seg, L), hi = imin(lo + seg, L);
    float s = 0.f;
    for (int i = lo; i < hi; ++i) s += dts[i];
    tot[lane] = s;
    __syncwarp();
    float run = 0.f;
    for (int l = 0; l < lane; ++l) run += tot[l];
    for (int i = lo; i < hi; ++i) {
      run += dts[i];
      cum[i] = run;
    }
  }
  __syncthreads();
}

// Shared memory of each tiled pass, in floats (the host mirrors them in
// kernel.py).
inline long long state_smem(long long N, long long P, long long L) {
  return 3 * L + 32 + T * (pad16(N) + 8) + T * (pad16(P) + 8);
}

inline long long gram_smem(long long N) { return 2 * T * (pad16(N) + 4); }

inline long long out_smem(long long N, long long P, long long L) {
  const long long cst = pad16(N) + 4, xst = pad16(P) + 8;
  const long long cs = T * cst + pad16(N) * xst;  // C rows, S_in
  const long long gx = T * (T + 4) + T * xst;     // a G tile, x rows
  return 2 * L + 32 + (cs > gx ? cs : gx);
}

// The (t tile, u tile) pairs of a chunk with u tile <= t tile, in order
// (0, 0), (1, 0), (1, 1), (2, 0), ...: pair (tt, ut) is tt (tt + 1) / 2 + ut.
__host__ __device__ __forceinline__ int n_pairs(int ntt) {
  return ntt * (ntt + 1) / 2;
}

// Pass 1: Z = sum_u w_u B_u (x) x_u, w_u = exp(A (cs_L - cs_u)) dt_u, for
// one (b, h, chunk); warp w makes rows 16 w .. 16 w + 15 of the N x P
// state (blockDim = 32 ceil(N / 16)).
template <typename TXY, bool XEXACT>
__global__ void __launch_bounds__(PASS_THREADS) chunk_state(const Params p) {
  const int N = static_cast<int>(p.N), P = static_cast<int>(p.P);
  const int L = static_cast<int>(p.L);
  const int nc = static_cast<int>(p.S / p.L);
  const int Np = pad16(N), Pp = pad16(P);
  const int bst = Np + 8, xst = Pp + 8;  // 8 mod 32: conflict-free frags
  float* const dts = hfav_smem;  // [L]
  float* const cum = dts + L;    // [L]
  float* const wts = cum + L;    // [L] w_u
  float* const tot = wts + L;    // [32]
  float* const Bs = tot + 32;    // [T][bst] w_u B_u of a u tile
  float* const Xs = Bs + T * bst;  // [T][xst] x of a u tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long blk = blockIdx.x;
  const int c = static_cast<int>(blk % nc);
  const long long bh = blk / nc, h = bh % p.H, b = bh / p.H;
  const long long s0 = static_cast<long long>(c) * L;
  const float a = p.A[h];
  const TXY* const x =
      static_cast<const TXY*>(p.x) + b * p.xs[0] + h * p.xs[2];
  const float* const Bm = p.Bm + b * p.bs[0];

  chunk_dt(p, p.dt + b * p.dts[0] + h * p.dts[2], s0, dts, cum, tot);
  const float last = cum[L - 1];
  for (int i = tid; i < L; i += blockDim.x)
    wts[i] = expf(a * (last - cum[i])) * dts[i];

  const int npt = (P + 7) / 8;  // 8-column tiles of P
  float acc[8][4] = {};
  for (int u0 = 0; u0 < L; u0 += T) {
    const int nu = imin(T, L - u0);
    __syncthreads();  // wts is written; the last tile's readers are done
    load_tile(Bs, bst, T, Np, Bm + (s0 + u0) * p.bs[1], p.bs[1], nu, N,
              wts + u0);
    load_tile(Xs, xst, T, Pp, x + (s0 + u0) * p.xs[1], p.xs[1], nu, P,
              static_cast<const float*>(nullptr));
    __syncthreads();
    for (int k0 = 0; k0 < nu; k0 += 8) {
      float af[4];
      load_at(af, Bs, bst, 16 * warp, k0, g, t);
      const Split4 as = split(af);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= npt) break;
        float bf[2];
        load_b(bf, Xs, xst, k0, 8 * j, g, t);
        mma3<XEXACT>(acc[j], as, bf);
      }
    }
  }
  float* const Z = p.states + (bh * nc + c) * p.N * p.P;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= npt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 16 * warp + g + 8 * (e / 2), q = 8 * j + 2 * t + e % 2;
      if (n < N && q < P) Z[n * P + q] = acc[j][e];
    }
  }
  if (tid == 0) p.decay[bh * nc + c] = expf(a * last);
}

// The Gram pass: G = C_t B_u^T for one (b, chunk, t tile, u tile <=
// t tile), the same for every head, so made once and read by the heads'
// pass-3 blocks; warp w makes rows 16 w .. 16 w + 15 of the 64 x 64 tile.
__global__ void __launch_bounds__(OUT_THREADS) chunk_gram(const Params p) {
  const int N = static_cast<int>(p.N), L = static_cast<int>(p.L);
  const int nc = static_cast<int>(p.S / p.L), ntt = (L + T - 1) / T;
  const int np = n_pairs(ntt), Np = pad16(N), cst = Np + 4;
  float* const Cs = hfav_smem;     // [T][cst] C rows of the t tile
  float* const Bs = Cs + T * cst;  // [T][cst] B rows of the u tile
  const long long blk = blockIdx.x;
  const int pr = static_cast<int>(blk % np);
  const long long bc = blk / np, b = bc / nc;
  const int c = static_cast<int>(bc % nc);
  int tt = 0;
  while (n_pairs(tt + 1) <= pr) ++tt;
  const int ut = pr - n_pairs(tt);
  const int t0 = tt * T, u0 = ut * T;
  const long long s0 = static_cast<long long>(c) * L;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, r0 = 16 * warp;
  load_tile(Cs, cst, T, Np, p.Cm + b * p.cs[0] + (s0 + t0) * p.cs[1],
            p.cs[1], imin(T, L - t0), N, static_cast<const float*>(nullptr));
  load_tile(Bs, cst, T, Np, p.Bm + b * p.bs[0] + (s0 + u0) * p.bs[1],
            p.bs[1], imin(T, L - u0), N, static_cast<const float*>(nullptr));
  __syncthreads();
  float gm[8][4] = {};
  for (int k0 = 0; k0 < Np; k0 += 8) {
    float af[4];
    load_a(af, Cs, cst, r0, k0, g, t);
    const Split4 as = split(af);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float bf[2];
      load_bt(bf, Bs, cst, k0, 8 * j, g, t);
      mma3<false>(gm[j], as, bf);
    }
  }
  float* const G = p.gram + blk * T * T;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      G[(r0 + g + 8 * (e / 2)) * T + 8 * j + 2 * t + e % 2] = gm[j][e];
}

// Pass 2: per (b, h) and state entry, S_in(0) = 0 and S_in(c + 1) =
// decay(c) S_in(c) + Z(c), each S_in(c) written over Z(c).
__global__ void __launch_bounds__(PASS_THREADS) state_pass(const Params p) {
  const int nc = static_cast<int>(p.S / p.L);
  const long long np = p.N * p.P;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= p.B * p.H * np) return;
  const long long bh = idx / np, e = idx - bh * np;
  float* const z = p.states + bh * nc * np + e;
  const float* const dc = p.decay + bh * nc;
  constexpr int K = 8;  // chunks whose states are loaded together
  float s = 0.f;
  for (int c0 = 0; c0 < nc; c0 += K) {
    float zc[K], d[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      zc[k] = c0 + k < nc ? z[(c0 + k) * np] : 0.f;
      d[k] = c0 + k < nc ? dc[c0 + k] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (c0 + k >= nc) break;
      z[(c0 + k) * np] = s;
      s = d[k] * s + zc[k];
    }
  }
}

// Pass 3: rows t0 .. t0 + 63 of y for one (b, h, chunk); warp w makes
// rows t0 + 16 w .. t0 + 16 w + 15.  M is made from the Gram tile in the
// A-fragment layout of M x, one 8-column step at a time.
template <typename TXY, bool XEXACT>
__global__ void __launch_bounds__(OUT_THREADS) chunk_output(const Params p) {
  const int N = static_cast<int>(p.N), P = static_cast<int>(p.P);
  const int L = static_cast<int>(p.L);
  const int nc = static_cast<int>(p.S / p.L), ntt = (L + T - 1) / T;
  const int Np = pad16(N), Pp = pad16(P);
  const int cst = Np + 4, xst = Pp + 8, gst = T + 4;
  float* const dts = hfav_smem;    // [L]
  float* const cum = dts + L;      // [L]
  float* const tot = cum + L;      // [32]
  float* const Cs = tot + 32;      // [T][cst] C rows of the t tile
  float* const Ss = Cs + T * cst;  // [Np][xst] S_in
  float* const Gs = Cs;            // [T][gst] a Gram tile (after C S_in)
  float* const Xs = Gs + T * gst;  // [T][xst] x of a u tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // the t tiles with the most u tiles come first
  const long long nbhc = p.B * p.H * nc, blk = blockIdx.x;
  const int tt = ntt - 1 - static_cast<int>(blk / nbhc);
  const long long bhc = blk % nbhc, bh = bhc / nc, h = bh % p.H, b = bh / p.H;
  const int c = static_cast<int>(bhc % nc);
  const int t0 = tt * T, nt = imin(T, L - t0);
  const long long s0 = static_cast<long long>(c) * L;
  const float a = p.A[h], dskip = p.D[h];
  const TXY* const x =
      static_cast<const TXY*>(p.x) + b * p.xs[0] + h * p.xs[2];
  TXY* const y = static_cast<TXY*>(p.y) + b * p.ys[0] + h * p.ys[2];

  chunk_dt(p, p.dt + b * p.dts[0] + h * p.dts[2], s0, dts, cum, tot);
  const int npt = (P + 7) / 8, r0 = 16 * warp;
  // this lane's rows of the tile (A-fragment rows g and g + 8), clamped
  const int tr0 = imin(t0 + r0 + g, L - 1), tr1 = imin(t0 + r0 + g + 8, L - 1);
  float acc[8][4] = {};
  // the rolled-in state: acc = exp(A cs_t) (C_t . S_in); S_in = 0 at c = 0
  if (c > 0) {
    load_tile(Cs, cst, T, Np, p.Cm + b * p.cs[0] + (s0 + t0) * p.cs[1],
              p.cs[1], nt, N, static_cast<const float*>(nullptr));
    load_tile(Ss, xst, Np, Pp, p.states + (bh * nc + c) * p.N * p.P, p.P, N,
              P, static_cast<const float*>(nullptr));
    __syncthreads();
    for (int k0 = 0; k0 < Np; k0 += 8) {
      float af[4];
      load_a(af, Cs, cst, r0, k0, g, t);
      const Split4 as = split(af);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= npt) break;
        float bf[2];
        load_b(bf, Ss, xst, k0, 8 * j, g, t);
        mma3<false>(acc[j], as, bf);
      }
    }
    const float e0 = expf(a * cum[tr0]), e1 = expf(a * cum[tr1]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= e0;
      acc[j][1] *= e0;
      acc[j][2] *= e1;
      acc[j][3] *= e1;
    }
  }

  // the chunk itself: u tiles up to the diagonal
  const float* const gram =
      p.gram + ((b * nc + c) * n_pairs(ntt) + n_pairs(tt)) * T * T;
  const bool live0 = t0 + r0 + g < L, live1 = t0 + r0 + g + 8 < L;
  for (int ut = 0; ut <= tt; ++ut) {
    const int u0 = ut * T, nu = imin(T, L - u0);
    __syncthreads();  // readers of Cs, Ss, Gs and Xs are done
    load_tile(Gs, gst, T, T, gram + ut * T * T, T, T, T,
              static_cast<const float*>(nullptr));
    load_tile(Xs, xst, T, Pp, x + (s0 + u0) * p.xs[1], p.xs[1], nu, P,
              static_cast<const float*>(nullptr));
    __syncthreads();
    for (int k0 = 0; k0 < nu; k0 += 8) {
      // M at rows (g, g + 8) x columns (k0 + t, k0 + t + 4), selected,
      // not masked: exp of a positive exponent may be inf
      float af[4];
      load_a(af, Gs, gst, r0, k0, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + t + 4 * (i / 2), u = u0 + col;
        const int tr = i % 2 ? tr1 : tr0;
        const bool live = (i % 2 ? live1 : live0) && col < nu && u <= tr;
        af[i] = live ? af[i] * expf(a * (cum[tr] - cum[u])) * dts[u] : 0.f;
      }
      const Split4 as = split(af);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= npt) break;
        float bf[2];
        load_b(bf, Xs, xst, k0, 8 * j, g, t);
        mma3<XEXACT>(acc[j], as, bf);
      }
    }
  }

  // y = acc + D x
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= npt) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + g + 8 * (e / 2), q = 8 * j + 2 * t + e % 2;
      if (row >= nt || q >= P) continue;
      const long long s = s0 + t0 + row;
      store(y + s * p.ys[1] + q,
            acc[j][e] + dskip * to_f(x[s * p.xs[1] + q]));
    }
  }
}

#ifndef HFAV_EMULATE
template <typename Kernel>
int launch1(Kernel kernel, long long blocks, int threads, long long smem,
            void* stream, const Params& p) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(blocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
#else
template <typename Kernel>
int launch1(Kernel kernel, long long blocks, int threads, long long smem,
            void*, const Params& p) {
  return emulate_launch(kernel, p, blocks, threads, smem);
}
#endif

template <typename TXY, bool XEXACT>
int launch(const Params& p, void* stream, long long* grid) {
  const long long nc = p.S / p.L, ntt = (p.L + T - 1) / T;
  const long long g1 = p.B * p.H * nc;
  const long long g0 = p.B * nc * n_pairs(static_cast<int>(ntt));
  const long long g2 = (p.B * p.H * p.N * p.P + PASS_THREADS - 1) / PASS_THREADS;
  const long long g3 = g1 * ntt;
  grid[0] = grid[1] = grid[2] = grid[3] = 0;
  if (g1 == 0) return 0;
  const long long f = static_cast<long long>(sizeof(float));
  int e = launch1(chunk_gram, g0, OUT_THREADS, gram_smem(p.N) * f, stream, p);
  if (e) return e;
  grid[0] = g0;
  e = launch1(chunk_state<TXY, XEXACT>, g1,
              32 * static_cast<int>((p.N + 15) / 16),
              state_smem(p.N, p.P, p.L) * f, stream, p);
  if (e) return e;
  grid[1] = g1;
  e = launch1(state_pass, g2, PASS_THREADS, 0, stream, p);
  if (e) return e;
  grid[2] = g2;
  e = launch1(chunk_output<TXY, XEXACT>, g3, OUT_THREADS,
              out_smem(p.N, p.P, p.L) * f, stream, p);
  if (e) return e;
  grid[3] = g3;
  return 0;
}

}  // namespace ssd

// ptrs: x, dt, A, Bm, Cm, D, y, then float32 scratch: states (B, H, S /
// L, N, P), decay (B, H, S / L), gram (B, S / L, pairs, 64, 64) with
// pairs = n (n + 1) / 2 for n = ceil(L / 64).  ints: x/y dtype (0
// float32, 1 bfloat16, 2 float16), B, S, H, P, N, L (a divisor of S), the
// (batch, seq, head) strides of x, of dt and of y, and the (batch, seq)
// strides of Bm and of Cm, in elements.  grid receives the blocks of the
// four launches.  Returns 0, a CUDA error code, -1 for a dtype it was not built
// for, or -2 for a shape it does not take (P > 64, N > 128, or L not
// dividing S).
extern "C" int ssd_forward(void* const* ptrs, const long long* ints,
                           void* stream, long long* grid) {
  ssd::Params p;
  p.x = ptrs[0];
  p.dt = static_cast<const float*>(ptrs[1]);
  p.A = static_cast<const float*>(ptrs[2]);
  p.Bm = static_cast<const float*>(ptrs[3]);
  p.Cm = static_cast<const float*>(ptrs[4]);
  p.D = static_cast<const float*>(ptrs[5]);
  p.y = ptrs[6];
  p.states = static_cast<float*>(ptrs[7]);
  p.decay = static_cast<float*>(ptrs[8]);
  p.gram = static_cast<float*>(ptrs[9]);
  p.B = ints[1];
  p.S = ints[2];
  p.H = ints[3];
  p.P = ints[4];
  p.N = ints[5];
  p.L = ints[6];
  for (int k = 0; k < 3; ++k) {
    p.xs[k] = ints[7 + k];
    p.dts[k] = ints[10 + k];
    p.ys[k] = ints[13 + k];
  }
  for (int k = 0; k < 2; ++k) {
    p.bs[k] = ints[16 + k];
    p.cs[k] = ints[18 + k];
  }
  if (p.P < 1 || p.P > ssd::MAX_P || p.N < 1 || p.N > ssd::MAX_N ||
      p.L < 1 || p.S % p.L)
    return -2;
  if (ints[0] == 0) return ssd::launch<float, false>(p, stream, grid);
  if (ints[0] == 1) return ssd::launch<__nv_bfloat16, true>(p, stream, grid);
  if (ints[0] == 2) return ssd::launch<__half, true>(p, stream, grid);
  return -1;
}

extern "C" const char* ssd_error_string(int e) {
  if (e == -1) return "dtype not built";
  if (e == -2) return "shape not taken (P <= 64, N <= 128, L divides S)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
