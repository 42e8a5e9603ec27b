// Flash attention forward (CUDA C++, sm_90a): K2 of the port.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:flash_attention_fwd
// (_attn_kernel): GQA attention with causal and sliding-window masks and
// a query offset, the softmax taken online over KV tiles with rolling
// float32 accumulators (m, l, acc) -- the HFAV contraction of the score
// matrix into the reduction triple (identity init, online combine,
// normalise).
//
// What bounds it.  At the prefill shape the work is 4 D flops per
// unmasked (query, key) pair and head (Q K^T and P V) against one read
// of q, k, v and one write of o: hundreds of flops per byte, so the
// tensor-core rate bounds it.
//
// Decomposition.  The TPU kernel walks KV blocks as the sequential last
// grid axis and carries (m, l, acc) in VMEM scratch.  Here one block of
// 4 warps (128 threads) owns one (batch, head, 64-row query tile), each
// warp 16 query rows, and a loop inside the block walks the 64-key KV
// tiles, so the accumulators live in registers for the block's whole
// life.  Causal tiles stop at the diagonal and tiles a sliding window
// masks entirely are skipped: with the finite sentinel -1e30 a fully
// masked tile only adds p = 1 terms while m is still -1e30, which the
// first real score wipes out (alpha = 2^(-1e30 - m) = 0), so skipping it
// changes nothing for a row that has one unmasked key.  Blocks are
// numbered so that the heaviest query tiles (the last, under a causal
// mask) of every (batch, head) are launched first.
//
// bf16 and float16 inputs: tensor cores (attn_kernel_tc).
// - Loads.  The query tile is copied once, K and V tiles of 64 keys go
//   through a ring of two stages in shared memory, all by cp.async
//   16-byte copies (cp.async.cg: L2 only), so the next tile's loads
//   overlap this tile's products; keys past Skv and query rows past Sq
//   are zero-filled.  Rows are 16-byte chunks; chunk c of row r is
//   stored at chunk c ^ ((r / RPU) & XM) of the row (an XOR swizzle), so
//   the 8 row addresses of every ldmatrix phase fall in 8 different
//   bank groups; at D = 80 (10 chunks, not a power of two) a row is
//   padded to 11 chunks instead, which does the same.  At D = 128 the
//   block holds 16 KB of Q and 2 x 2 x 16 KB of K and V: 80 KB, two
//   blocks an SM.
// - S = Q K^T by mma.sync m16n8k16 bf16 with float32 accumulation (exact
//   products, so the scores differ from float32 ones only in summation
//   order): Q's A fragments are loaded once by ldmatrix and stay in
//   registers (D / 16 k-steps x 4 registers); K's B fragments come by
//   ldmatrix (not transposed: K rows hold d contiguously).
// - Mask and online softmax on the accumulator fragments, where lane l
//   holds rows l / 4 and l / 4 + 8 at columns 2 (l % 4) + {0, 1} of each
//   n8 tile.  The scale and log2(e) are folded into one factor and the
//   exponentials are exp2f of scores in the log2 domain.  The row max
//   and, at the end, the row sum are taken across the quad with two
//   __shfl_xor_sync (xor 1, 2); m, l and the 16 x D float32 output of
//   each warp stay in registers.  Only tiles that cross the diagonal,
//   the window's edge or Skv compute the mask.
// - O += P V with P split in three bf16 terms.  The score accumulators
//   of two adjacent n8 tiles are the A fragment of one k16 step (no trip
//   through shared memory); V's B fragments come by ldmatrix.trans, each
//   used by the three terms of two n8 tiles.  The reference computes p
//   and p @ v in float32 (src/repro/kernels/flash_attention/kernel.py:
//   69-74).  Rounding P to bf16 once, as SDPA and FlashAttention do,
//   puts the output 1.9e-3 to 2.1e-3 (relative L2) from the float32
//   function on random bf16 inputs (S = 257 and 2048, D = 64 and 128,
//   causal), past the port's bf16 gate (1e-3).  Two terms, P_hi =
//   bf16(p) and P_lo = bf16(p - P_hi), keep 16 of p's bits: 5.4e-5 to
//   9.0e-5 there, but on short rows the flips they leave moved zamba2's
//   bf16 caches past the 2e-2 of the on-card model test
//   (tests/test_torch_ssd_kernel.py), which the float32 kernel passed.
//   So each term is the bf16 residue of the last (P_hi, P_mid, P_lo):
//   24 bits, float32's precision, at 2x the tensor-core work of a single
//   P (a short-row CPU test pins the third term); the bound still
//   counts the function's 4 D flops per pair.  l sums the unrounded
//   float32 p.  At D <= 80 the kernel is held to 168 registers, so three
//   blocks share an SM.
// - float16 (the same kernel, mma.sync f16): P in two float16 terms
//   (FA_F16_TERMS).  float16 keeps 11 bits, and a residue below its
//   smallest normal, 2^-14, keeps fewer, but P_lo only ever carries
//   what P_hi dropped, at most 2^-12 p, so two terms leave an absolute
//   error of at most 2^-25 a term against l >= 1.  Measured on an H100
//   (scripts/attention_terms.py; random float16 q, k, v, causal; relative
//   L2 to the plain version, which rounds the float32 result to float16
//   once): S = 257, D = 64 / 128: one term 2.57e-4 / 2.42e-4, two
//   1.03e-5 / 1.41e-5, three 1.04e-5 / 1.41e-5; S = 2048: one 2.63e-4 /
//   2.59e-4, two 3.28e-5 / 2.41e-5, three 3.28e-5 / 2.40e-5; the
//   float16 gate's relative L2 is 2.5e-4.  So one term misses it, a
//   third gains nothing over two and costs 13-19 % more time at S =
//   2048.
// - What is left.  This is FlashAttention-2's design on mma.sync.  The
//   path to SDPA's rate is Hopper's: wgmma with P from registers and K,
//   V from shared memory through descriptors, TMA loads, a producer warp
//   and 128-row tiles of two consumer warpgroups.  wgmma cannot be
//   emulated on the host without a descriptor-exact model of shared
//   memory layouts, which would take this kernel's CPU tests away;
//   mma.sync keeps them.
//
// float32 inputs: scalar FMA (attn_kernel_f32).  Tensor cores would
// round the inputs to TF32 (10-bit mantissas), which cannot meet the
// float32 gate (atol 2e-5, relative L2 1e-5), and the serving path is
// bf16.  256 threads, each holding a 4 x 4 score tile and a 4 x D/16
// slice of the output; K, then V, of one tile share one shared-memory
// buffer (~92 KB at D = 128); padded strides keep the transposed stores
// and the score loop free of bank conflicts.
//
// Layout.  q is read in place from (B, Sq, H, D) and k, v from
// (B, Skv, KVH, D) through their strides (the last dim contiguous; for
// bf16 and float16 every other stride and the base 16-byte aligned, which
// fa_forward checks); the TPU kernel's transposes to (B*H, S, D) are full
// copies on this card.  Query head h reads KV head h / (H / KVH).
#ifdef HFAV_EMULATE
#include "../../stencil2d/csrc/emulate.h"
#else
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
// the block's dynamic shared memory (emulate.h defines it for the host)
extern __shared__ __align__(16) float hfav_smem[];
#endif
#include <math.h>

namespace fa {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per tile
constexpr float NEG_INF = -1e30f;  // finite: exp(NEG_INF - NEG_INF) = 1
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long B, Sq, Skv, H, KVH, nq;
  long long qs[3], ks[3], vs[3], os[3];  // (batch, seq, head) strides
  long long causal, window, q_offset;    // window <= 0: none
  float scale;
};

__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

// The block's query tile, (batch, head) and the KV tiles its rows can
// see.  Block x takes query tile nq - 1 - x / (B H) of (batch, head)
// x % (B H): every (batch, head)'s heaviest tiles first.
struct Work {
  long long b, h, kvh, q0, t_first, t_last, qlo, qhi;
};

__device__ __forceinline__ Work block_work(const Params& p) {
  Work w;
  const long long bid = blockIdx.x, bh = bid % (p.B * p.H);
  w.q0 = (p.nq - 1 - bid / (p.B * p.H)) * BQ;
  w.h = bh % p.H;
  w.b = bh / p.H;
  w.kvh = w.h / (p.H / p.KVH);
  w.qlo = w.q0 + p.q_offset;
  w.qhi = lmin(w.q0 + BQ, p.Sq) - 1 + p.q_offset;
  long long klo = 0, khi = p.Skv - 1;
  if (p.causal) khi = lmin(khi, w.qhi);
  if (p.window > 0) klo = lmax(klo, w.qlo - p.window + 1);
  w.t_first = klo / BKV;
  w.t_last = khi >= klo ? khi / BKV : w.t_first - 1;
  return w;
}

// ---------------------------------------------------------------------
// The device instructions of the tensor-core kernel, each with a host
// twin in emulate.h (g++ -DHFAV_EMULATE).
// ---------------------------------------------------------------------
#ifdef HFAV_EMULATE
inline void cp_async16(void* dst, const void* src, int src_bytes) {
  hfav_cp_async16(dst, src, src_bytes);
}
inline void cp_async_commit() { hfav_cp_async_commit(); }
template <int N>
inline void cp_async_wait() {
  hfav_cp_async_wait(N);
}
inline void ldmatrix_x4(unsigned r[4], const void* row) {
  hfav_ldmatrix_x4(r, row, false);
}
inline void ldmatrix_x4_trans(unsigned r[4], const void* row) {
  hfav_ldmatrix_x4(r, row, true);
}
inline void mma_bf16(float d[4], const unsigned a[4], unsigned b0,
                     unsigned b1) {
  const unsigned b[2] = {b0, b1};
  hfav_mma_bf16(d, a, b, d);
}
inline unsigned pack_bf16(float lo, float hi) {
  return __float2bfloat16(lo).x | static_cast<unsigned>(__float2bfloat16(hi).x)
                                      << 16;
}
inline void mma_f16(float d[4], const unsigned a[4], unsigned b0,
                    unsigned b1) {
  const unsigned b[2] = {b0, b1};
  hfav_mma_f16(d, a, b, d);
}
inline unsigned pack_f16(float lo, float hi) {
  return __float2half_rn(lo).x | static_cast<unsigned>(__float2half_rn(hi).x)
                                     << 16;
}
inline float f16_lo(unsigned w) {
  return __half2float({static_cast<unsigned short>(w & 0xffffu)});
}
inline float f16_hi(unsigned w) {
  return __half2float({static_cast<unsigned short>(w >> 16)});
}
#else
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned r[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned r[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
// d += A B: A 16 x 16 (4 registers), B 16 x 8 (b0, b1), d 16 x 8 float32
__device__ __forceinline__ void mma_bf16(float d[4], const unsigned a[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// d += A B in float16 operands, as mma_bf16
__device__ __forceinline__ void mma_f16(float d[4], const unsigned a[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as float16 (round to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}
// the two float16 halves of a packed pair as float32
__device__ __forceinline__ float f16_lo(unsigned w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
}
__device__ __forceinline__ float f16_hi(unsigned w) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(w >> 16)));
}
#endif

// the two bf16 halves of a packed pair as float32
__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// P's terms in float16 (the header comment gives the measurement)
#ifndef FA_F16_TERMS
#define FA_F16_TERMS 2
#endif

// The 16-bit element types of the tensor-core kernel: the product, two
// floats packed as a pair (lo in the low half), a pair's halves as
// float, and the terms P is split into.
template <typename T>
struct Elem;
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int P_TERMS = 3;
  static __device__ __forceinline__ void mma(float d[4], const unsigned a[4],
                                             unsigned b0, unsigned b1) {
    mma_bf16(d, a, b0, b1);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ float lo(unsigned w) { return bf16_lo(w); }
  static __device__ __forceinline__ float hi(unsigned w) { return bf16_hi(w); }
};
template <>
struct Elem<__half> {
  static constexpr int P_TERMS = FA_F16_TERMS;
  static __device__ __forceinline__ void mma(float d[4], const unsigned a[4],
                                             unsigned b0, unsigned b1) {
    mma_f16(d, a, b0, b1);
  }
  static __device__ __forceinline__ unsigned pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  static __device__ __forceinline__ float lo(unsigned w) { return f16_lo(w); }
  static __device__ __forceinline__ float hi(unsigned w) { return f16_hi(w); }
};

// ---------------------------------------------------------------------
// bf16 and float16: tensor cores
// ---------------------------------------------------------------------
constexpr int TC_THREADS = 128;  // 4 warps, 16 query rows each

// A tile of 64 rows of D 16-bit values in shared memory, 16-byte chunks
// swizzled.
template <int D>
struct Tile {
  static constexpr int NC = D / 8;  // chunks in a row
  static constexpr bool POW2 = (NC & (NC - 1)) == 0;
  static constexpr int LD = POW2 ? NC : NC + 1;     // chunks a row takes
  static constexpr int RPU = NC >= 8 ? 1 : 8 / NC;  // rows a swizzle step
  static constexpr int XM = NC >= 8 ? 7 : NC - 1;
  static constexpr int BYTES = 64 * LD * 16;
  // the byte offset of chunk c of row r
  static __device__ __forceinline__ int off(int r, int c) {
    return 16 * (r * LD + (POW2 ? c ^ ((r / RPU) & XM) : c));
  }
};

// cp.async rows row0 .. row0 + 63 of src (row stride `ld` elements) into
// the tile dst; rows at or past `nrows` are zero-filled.
template <int D, typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src,
                                          long long ld, long long row0,
                                          long long nrows) {
  using L = Tile<D>;
  for (int i = threadIdx.x; i < 64 * L::NC; i += TC_THREADS) {
    const int r = i / L::NC, c = i % L::NC;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + L::off(r, c), ok ? src + (row0 + r) * ld + 8 * c : src,
               ok ? 16 : 0);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, D <= 80 ? 3 : 2)
    attn_kernel_tc(const Params p) {
  using L = Tile<D>;
  using E = Elem<T>;
  constexpr int KS = D / 16;  // k16 steps of Q K^T
  constexpr int NT = D / 8;   // n8 tiles of the output
  constexpr int SN = BKV / 8;  // n8 tiles of a score tile
  unsigned char* const Qs = reinterpret_cast<unsigned char*>(hfav_smem);
  unsigned char* const Ks = Qs + L::BYTES;      // 2 stages
  unsigned char* const Vs = Ks + 2 * L::BYTES;  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const Work w = block_work(p);
  const T* const q =
      static_cast<const T*>(p.q) + w.b * p.qs[0] + w.h * p.qs[2];
  const T* const k =
      static_cast<const T*>(p.k) + w.b * p.ks[0] + w.kvh * p.ks[2];
  const T* const v =
      static_cast<const T*>(p.v) + w.b * p.vs[0] + w.kvh * p.vs[2];
  T* const o = static_cast<T*>(p.o) + w.b * p.os[0] + w.h * p.os[2];
  const float sl = p.scale * LOG2E;  // scores in the log2 domain

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // rows g, g + 8
  unsigned qf[KS][4];
  // this lane's ldmatrix row: row (lane & 7) + 8 ((lane >> 3) & 1) of
  // the 16-row group, chunk lane >> 4 of the chunk pair
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lhalf = lane >> 4;

  if (w.t_first <= w.t_last) {
    load_tile<D>(Qs, q, p.qs[1], w.q0, p.Sq);
    load_tile<D>(Ks, k, p.ks[1], w.t_first * BKV, p.Skv);
    load_tile<D>(Vs, v, p.vs[1], w.t_first * BKV, p.Skv);
  }
  cp_async_commit();

  for (long long t = w.t_first; t <= w.t_last; ++t) {
    const int st = static_cast<int>(t - w.t_first) & 1;
    if (t < w.t_last) {  // the next tile into the other stage
      load_tile<D>(Ks + (st ^ 1) * L::BYTES, k, p.ks[1], (t + 1) * BKV,
                   p.Skv);
      load_tile<D>(Vs + (st ^ 1) * L::BYTES, v, p.vs[1], (t + 1) * BKV,
                   p.Skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // every group but the newest: this tile (and Q)
    __syncthreads();
    if (t == w.t_first) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], Qs + L::off(16 * warp + lrow, 2 * kk + lhalf));
    }
    const unsigned char* const Kt = Ks + st * L::BYTES;
    const unsigned char* const Vt = Vs + st * L::BYTES;

    // S = Q K^T, 16 x 64 per warp
    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < SN; j += 2) {
        // n8 tiles j, j + 1 at chunks 2 kk, 2 kk + 1
        unsigned b[4];
        ldmatrix_x4(b, Kt + L::off(8 * (j + lhalf) + (lane & 7),
                                   2 * kk + ((lane >> 3) & 1)));
        E::mma(s[j], qf[kk], b[0], b[1]);
        E::mma(s[j + 1], qf[kk], b[2], b[3]);
      }

    // scale, mask, and each row's max
    const long long k0 = t * BKV;
    const bool edge = k0 + BKV > p.Skv || (p.causal && k0 + BKV - 1 > w.qlo) ||
                      (p.window > 0 && k0 <= w.qhi - p.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sl;
        if (edge) {
          const long long qpos =
              w.qlo + 16 * warp + g + 8 * (e / 2);
          const long long kpos = k0 + 8 * j + 2 * t4 + e % 2;
          bool ok = kpos < p.Skv;
          if (p.causal) ok = ok && kpos <= qpos;
          if (p.window > 0) ok = ok && kpos > qpos - p.window;
          if (!ok) x = NEG_INF;
        }
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }

    // online combine: new max, rescale, p = 2^(s - m)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      const float alpha = exp2f(m[r] - mn);
      m[r] = mn;
      l[r] *= alpha;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[j][e] - m[e / 2]);
        s[j][e] = pe;
        l[e / 2] += pe;  // this lane's part of the row sum, unrounded
      }

    // O += P_hi V + P_mid V + P_lo V (float16: P_hi V + P_lo V), one k16
    // step per two n8 score tiles
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      unsigned ph[E::P_TERMS][4];  // P_hi, (P_mid,) P_lo
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        // register x: rows g (x even) or g + 8 of score tile 2 kk + x / 2
        float a = s[2 * kk + x / 2][2 * (x % 2)];
        float b = s[2 * kk + x / 2][2 * (x % 2) + 1];
#pragma unroll
        for (int t = 0; t < E::P_TERMS; ++t) {  // each the last's residue
          ph[t][x] = E::pack(a, b);
          a -= E::lo(ph[t][x]);
          b -= E::hi(ph[t][x]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        // keys 16 kk .. 16 kk + 15 of output n8 tiles n, n + 1
        unsigned b[4];
        ldmatrix_x4_trans(b, Vt + L::off(16 * kk + lrow, n + lhalf));
#pragma unroll
        for (int t = 0; t < E::P_TERMS; ++t) {
          E::mma(acc[n], ph[t], b[0], b[1]);
          E::mma(acc[n + 1], ph[t], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_async_wait<0>();

  // normalise (l clamped at 1e-30, as on the TPU) and store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    const long long row = w.q0 + 16 * warp + g + 8 * r;
    if (row >= p.Sq) continue;
    T* const orow = o + row * p.os[1] + 2 * t4;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<unsigned*>(orow + 8 * n) =
          E::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
constexpr long long smem_bytes_tc() {
  return 5LL * Tile<D>::BYTES;  // Q, 2 stages of K, 2 of V
}

// ---------------------------------------------------------------------
// float32: scalar FMA
// ---------------------------------------------------------------------
constexpr int TX = 16;    // threads along the keys / head dim
constexpr int TY = 16;    // threads along the query rows
constexpr int THREADS = TX * TY;
constexpr int RQ = BQ / TY;   // query rows per thread: ty + TY * i
constexpr int RK = BKV / TX;  // keys per thread: tx + TX * j
constexpr int QLD = BQ + 1;   // padded leading dims in shared memory
constexpr int KLD = BKV + 1;
constexpr int PLD = BKV + 1;
constexpr int RLD = TX + 1;

template <int D>
constexpr long long smem_bytes_f32() {
  return ((long long)D * QLD + (D * KLD > BKV * D ? D * KLD : BKV * D) +
          BQ * PLD + 2 * BQ * RLD) *
         (long long)sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(THREADS) attn_kernel_f32(const Params p) {
  constexpr int NC = D / TX;  // output columns per thread: tx + TX * c
  float* const Qs = hfav_smem;                 // [D][QLD], scaled
  float* const KVs = Qs + D * QLD;             // K as [D][KLD], V as [BKV][D]
  float* const Ps = KVs + (D * KLD > BKV * D ? D * KLD : BKV * D);  // [BQ][PLD]
  float* const Rmax = Ps + BQ * PLD;           // [BQ][RLD] row partials
  float* const Rsum = Rmax + BQ * RLD;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const Work w = block_work(p);
  const float* const q =
      static_cast<const float*>(p.q) + w.b * p.qs[0] + w.h * p.qs[2];
  const float* const k =
      static_cast<const float*>(p.k) + w.b * p.ks[0] + w.kvh * p.ks[2];
  const float* const v =
      static_cast<const float*>(p.v) + w.b * p.vs[0] + w.kvh * p.vs[2];
  float* const o = static_cast<float*>(p.o) + w.b * p.os[0] + w.h * p.os[2];
  const long long q0 = w.q0;

  // the query tile, transposed and scaled (q.astype(f32) * scale)
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const long long s = q0 + r;
    Qs[d * QLD + r] = s < p.Sq ? q[s * p.qs[1] + d] * p.scale : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (long long t = w.t_first; t <= w.t_last; ++t) {
    const long long k0 = t * BKV;
    __syncthreads();  // the last tile's V and P reads are done
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const long long s = k0 + r;
      KVs[d * KLD + r] = s < p.Skv ? k[s * p.ks[1] + d] : 0.f;
    }
    __syncthreads();

    float sc[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) sc[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[RQ], bk[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = Qs[d * QLD + ty + TY * i];
#pragma unroll
      for (int j = 0; j < RK; ++j) bk[j] = KVs[d * KLD + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) sc[i][j] += a[i] * bk[j];
    }

    // mask, and each row's partial max over this thread's keys
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const long long qpos = q0 + ty + TY * i + p.q_offset;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const long long kpos = k0 + tx + TX * j;
        bool ok = kpos < p.Skv;
        if (p.causal) ok = ok && kpos <= qpos;
        if (p.window > 0) ok = ok && kpos > qpos - p.window;
        if (!ok) sc[i][j] = NEG_INF;
        mx = fmaxf(mx, sc[i][j]);
      }
      Rmax[(ty + TY * i) * RLD + tx] = mx;
    }
    __syncthreads();

    // online combine: new max, rescale factor, p = exp(s - m)
    float alpha[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty + TY * i;
      float mt = m[i];
      for (int x = 0; x < TX; ++x) mt = fmaxf(mt, Rmax[row * RLD + x]);
      alpha[i] = expf(m[i] - mt);
      m[i] = mt;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float e = expf(sc[i][j] - mt);
        Ps[row * PLD + tx + TX * j] = e;
        sum += e;
      }
      Rsum[row * RLD + tx] = sum;
    }
    __syncthreads();  // P and the row sums are complete; K is consumed

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = ty + TY * i;
      float sum = 0.f;
      for (int x = 0; x < TX; ++x) sum += Rsum[row * RLD + x];
      l[i] = l[i] * alpha[i] + sum;
    }
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const long long s = k0 + r;
      KVs[r * D + d] = s < p.Skv ? v[s * p.vs[1] + d] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha[i];
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[RQ], vv[NC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + TY * i) * PLD + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = KVs[kk * D + tx + TX * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += pv[i] * vv[c];
    }
  }

  // normalise (l clamped at 1e-30, as on the TPU) and store
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const long long s = q0 + ty + TY * i;
    if (s >= p.Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[s * p.os[1] + tx + TX * c] = acc[i][c] / li;
  }
}

template <typename Kernel>
int launch(Kernel kernel, const Params& p, int threads, long long smem,
           void* stream, long long* grids) {
  const long long nblocks = p.B * p.H * p.nq;
  grids[0] = 0;
  if (nblocks == 0) return 0;
#ifdef HFAV_EMULATE
  (void)stream;
  const int e = emulate_launch(kernel, p, nblocks, threads, smem);
  if (e == 0) grids[0] = nblocks;
  return e;
#else
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(nblocks), threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(p);
  const cudaError_t l = cudaGetLastError();
  if (l == cudaSuccess) grids[0] = nblocks;
  return static_cast<int>(l);
#endif
}

// dtype: 0 float32, 1 bf16, 2 float16
template <int D>
int launch_d(long long dtype, const Params& p, void* stream,
             long long* grids) {
  if (dtype == 1)
    return launch(attn_kernel_tc<__nv_bfloat16, D>, p, TC_THREADS,
                  smem_bytes_tc<D>(), stream, grids);
  if (dtype == 2)
    return launch(attn_kernel_tc<__half, D>, p, TC_THREADS,
                  smem_bytes_tc<D>(), stream, grids);
  return launch(attn_kernel_f32<D>, p, THREADS, smem_bytes_f32<D>(), stream,
                grids);
}

int dispatch_d(long long D, long long dtype, const Params& p, void* stream,
               long long* grids) {
  switch (D) {
    case 16: return launch_d<16>(dtype, p, stream, grids);
    case 32: return launch_d<32>(dtype, p, stream, grids);
    case 64: return launch_d<64>(dtype, p, stream, grids);
    case 80: return launch_d<80>(dtype, p, stream, grids);
    case 128: return launch_d<128>(dtype, p, stream, grids);
    default: return -1;
  }
}

// cp.async reads q, k and v in 16-byte row pieces and o is written in
// packed pairs: the four bases and every stride but the last (in
// elements of 2 bytes) must be 16-byte aligned.  The only check of it.
bool aligned16(const Params& p) {
  const void* ptrs[4] = {p.q, p.k, p.v, p.o};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<unsigned long long>(ptr) % 16) return false;
  for (int a = 0; a < 3; ++a)
    if (p.qs[a] % 8 || p.ks[a] % 8 || p.vs[a] % 8 || p.os[a] % 8)
      return false;
  return true;
}

}  // namespace fa

// ptrs: q, k, v, o.  ints: dtype (0 float32, 1 bfloat16, 2 float16), B,
// Sq, Skv, H, KVH, D, the (batch, seq, head) strides of q, k, v and o in
// elements, causal, window (<= 0: none), q_offset.  grids receives the
// blocks launched.  Returns 0, a CUDA error code, -1 for a head dim or
// dtype it was not built for, or -2 for bf16 or float16 rows that are not
// 16-byte aligned.
extern "C" int fa_forward(void* const* ptrs, const long long* ints,
                          float scale, void* stream, long long* grids) {
  fa::Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.o = ptrs[3];
  p.B = ints[1];
  p.Sq = ints[2];
  p.Skv = ints[3];
  p.H = ints[4];
  p.KVH = ints[5];
  for (int a = 0; a < 3; ++a) {
    p.qs[a] = ints[7 + a];
    p.ks[a] = ints[10 + a];
    p.vs[a] = ints[13 + a];
    p.os[a] = ints[16 + a];
  }
  p.causal = ints[19];
  p.window = ints[20];
  p.q_offset = ints[21];
  p.scale = scale;
  p.nq = (p.Sq + fa::BQ - 1) / fa::BQ;
  grids[0] = 0;
  if (ints[0] == 0) return fa::dispatch_d(ints[6], 0, p, stream, grids);
  if (ints[0] == 1 || ints[0] == 2) {
    if (!fa::aligned16(p)) return -2;
    return fa::dispatch_d(ints[6], ints[0], p, stream, grids);
  }
  return -1;
}

extern "C" const char* fa_error_string(int e) {
  if (e == -1) return "head dim or dtype not built";
  if (e == -2)
    return "bf16 and float16 rows are read 16 bytes at a time: q, k, v "
           "and o need 16-byte aligned bases and (batch, seq, head) "
           "strides";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
