// Split-KV decode attention (CUDA C++, sm_90a): K3 of the port.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode/kernel.py:flash_decode (_decode_kernel):
// one new query token per sequence attends over its KV cache; only the
// first lengths[b] positions count, less those outside an optional
// sliding window.  The KV axis is the reduced dimension of the HFAV
// reduction triple (identity, online combine, normalise).
//
// What bounds it.  Each step reads the valid part of K and V once and
// does ~4 flops per cached element, far below the card's ~295 flops per
// byte in bf16, so device-memory bytes bound it: the design's one aim is
// to keep enough 16-byte loads in flight to stream the valid keys at the
// memory rate, whatever the lengths.
//
// Decomposition (flash-decoding).  The TPU kernel walks the whole cache
// of one (batch, KV head) in order on one core: grid (B, KVH, nkv).  On
// this card B * KVH blocks would leave most of the 132 SMs idle (32 at
// qwen3-0.6b's B = 4, KVH = 8), so the KV axis is split across nsplit
// blocks as well.  The host picks nsplit from the SM count and B * KVH
// alone (about two blocks an SM, at most one split per 64 cache
// positions), so a step reads nothing back from the device.  Block
// (b, kvh, split) finds its sequence's valid range [max(0, len - window),
// min(len, S)) on the device, cuts it into nsplit pieces of a multiple of
// 64 keys, and takes piece `split`, with the `group` query heads of one
// KV head together, as in the TPU kernel; it leaves one partial
// (m, l, acc) per query head and the count of keys it held.  A second,
// small kernel combines the partials of each (b, h) in split order:
// M = max m_s, out = sum e^(m_s - M) acc_s / max(sum e^(m_s - M) l_s,
// 1e-30).  A split with no key (the valid range is short, or empty)
// exits at once and leaves the identity (m = -1e30, l = 0, acc = 0),
// which the combine weighs by exp(-1e30 - M) = 0: at the main path's
// lengths (31 of a 4096-position cache) one split of each (b, kvh) works.
//
// Streaming.  A key row of D values is D / E 16-byte chunks (E = 8 bf16
// or float16, 4 float32); LPR lanes (the chunk count rounded up to a
// power of two) take one row, chunk c on lane c, so a warp loads 32 / LPR
// whole rows in one instruction with neighbouring lanes on neighbouring
// addresses.
// Each lane keeps U rows of K and of V in flight in registers (an
// unrolled register pipeline, no shared memory): it issues all 2U 16-byte
// loads, then takes the U dot products with the group's query heads,
// which live in its registers (E columns each, scaled), and reduces them
// across the LPR lanes of the row with __shfl_xor_sync.  Every lane then
// keeps an online (m, l, acc) per head over the rows it saw, acc being
// its own E columns.  At the end the row groups of a warp are folded by
// __shfl_xor_sync and the 4 warps' partials through shared memory.
//
// Layout.  q is read from (B, H, D) and the caches in place from
// (B, S, KVH, D) through their strides (16-byte aligned, which
// fd_decode checks); the TPU kernel's transpose of the caches to
// (B, KVH, S, D) copies the whole cache on every call.
//
// Types.  q and the caches may each be float32, bf16 or float16.  When q
// is bf16 or float16 and the caches are of another type, each cached
// value is rounded to q's type on load, as the reference casts the caches
// to the compute dtype before attending: a bf16 cache under float16 q
// goes bf16 -> float16 -> float, so a value past 65504 becomes Inf and
// one below 2^-14 a float16 subnormal, as in the reference (bf16 -> float
// alone would be another function).  All arithmetic is float32 and the
// output takes q's dtype.
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

namespace fd {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PIECE = 64;  // a split's keys are a multiple of this
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part_ml;   // (B, H, nsplit, 2): m, l
  float* part_acc;  // (B, H, nsplit, D)
  int* part_n;      // (B, KVH, nsplit): keys each split block held
  long long B, S, H, KVH, D, nsplit, window;  // window <= 0: none
  long long qs[2], ks[3], vs[3], os[2];
  int q_type;    // q's dtype: 0 float32, 1 bf16, 2 float16
  int round_to;  // cached values rounded on load: 0 not, 1 bf16, 2 float16
  float scale;
};

// x rounded to bf16 (mode 1) or float16 (mode 2), as float
__device__ __forceinline__ float rounded(float x, int mode) {
  return mode == 1 ? __bfloat162float(__float2bfloat16(x))
                   : __half2float(__float2half_rn(x));
}

// The float16 value of 16 bits
__device__ __forceinline__ float f16_value(unsigned bits) {
#ifdef HFAV_EMULATE
  return __half2float({static_cast<unsigned short>(bits)});
#else
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
#endif
}

// The two 16-bit values of a word (the first in the low half) as float32
__device__ __forceinline__ void pair(const __nv_bfloat16*, unsigned w,
                                     float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void pair(const __half*, unsigned w, float& lo,
                                     float& hi) {
  lo = f16_value(w & 0xffffu);
  hi = f16_value(w >> 16);
}

// The E values of a 16-byte chunk of TC as float32.
template <typename TC>
__device__ __forceinline__ void unpack(const uint4& c, float (&x)[4]) {
  x[0] = __uint_as_float(c.x);
  x[1] = __uint_as_float(c.y);
  x[2] = __uint_as_float(c.z);
  x[3] = __uint_as_float(c.w);
}
template <typename TC>
__device__ __forceinline__ void unpack(const uint4& c, float (&x)[8]) {
  const unsigned w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pair(static_cast<const TC*>(nullptr), w[i], x[2 * i], x[2 * i + 1]);
}

__device__ __forceinline__ float q_value(const Params& p, long long i) {
  if (p.q_type == 1)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p.q)[i]);
  if (p.q_type == 2) return __half2float(static_cast<const __half*>(p.q)[i]);
  return static_cast<const float*>(p.q)[i];
}

// An output value in q's type
__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16(v);
}
__device__ __forceinline__ void store(__half* o, float v) {
  *o = __float2half_rn(v);
}

// TC: the caches' element type; MG: the group size rounded up to a power
// of two (the head slots of the per-lane registers).
template <typename TC, int D, int MG>
__global__ void __launch_bounds__(THREADS) split_kernel(const Params p) {
  constexpr int E = 16 / static_cast<int>(sizeof(TC));  // values a chunk
  constexpr int NCH = D / E;                            // chunks a row
  constexpr int LPR = NCH <= 2    ? 2
                      : NCH <= 4  ? 4
                      : NCH <= 8  ? 8
                      : NCH <= 16 ? 16
                                  : 32;  // lanes a row
  constexpr int RPW = 32 / LPR;          // rows a warp loads at once
  constexpr int U = MG <= 2 ? 8 : MG <= 4 ? 4 : 2;  // rows a lane in flight
  constexpr int STEP = WARPS * RPW * U;              // rows a block pass
  static_assert(NCH <= 32, "a row is at most 32 chunks");

  const int G = static_cast<int>(p.H / p.KVH);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = lane % LPR, rg = lane / LPR;  // chunk, row group
  const bool on = c < NCH;                    // this lane loads a chunk
  long long bid = blockIdx.x;
  const long long split = bid % p.nsplit;
  bid /= p.nsplit;
  const long long kvh = bid % p.KVH, b = bid / p.KVH;

  // this split's piece of the valid range
  const long long len = p.lengths[b];
  const long long end = len < p.S ? len : p.S;  // a length past the cache
  long long start = 0;
  if (p.window > 0 && len - p.window > 0) start = len - p.window;
  const long long valid = end - start;
  const long long piece =
      valid > 0 ? (valid + p.nsplit - 1) / p.nsplit : 0;
  const long long per = (piece + PIECE - 1) / PIECE * PIECE;
  const long long lo = start + split * per;
  const long long hi = lo + per < end ? lo + per : end;
  const int n = hi > lo ? static_cast<int>(hi - lo) : 0;
  const long long part0 = (b * p.H + kvh * G) * p.nsplit + split;
  if (tid == 0) p.part_n[(b * p.KVH + kvh) * p.nsplit + split] = n;

  if (n == 0) {  // the identity of the reduction triple
    for (int g = tid; g < G; g += THREADS) {
      p.part_ml[(part0 + g * p.nsplit) * 2] = NEG_INF;
      p.part_ml[(part0 + g * p.nsplit) * 2 + 1] = 0.f;
    }
    for (int idx = tid; idx < G * D; idx += THREADS)
      p.part_acc[(part0 + (idx / D) * p.nsplit) * D + idx % D] = 0.f;
    return;
  }

  // the group's query heads, this lane's E columns, scaled
  float qr[MG][E];
#pragma unroll
  for (int g = 0; g < MG; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = g < G && on ? q_value(p, b * p.qs[0] +
                                              (kvh * G + g) * p.qs[1] +
                                              c * E + e) *
                                   p.scale
                             : 0.f;
  const int to_q = p.round_to;
  const TC* const k = static_cast<const TC*>(p.k) + b * p.ks[0] +
                      kvh * p.ks[2] + lo * p.ks[1] + c * E;
  const TC* const v = static_cast<const TC*>(p.v) + b * p.vs[0] +
                      kvh * p.vs[2] + lo * p.vs[1] + c * E;

  float m[MG], l[MG], acc[MG][E];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }

  // pass r0 takes rows r0 + (u WARPS + warp) RPW + rg, u < U
  for (int r0 = 0; r0 < n; r0 += STEP) {
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int row = r0 + (u * WARPS + warp) * RPW + rg;
      if (row < n && on) {
        kr[u] = __ldg(reinterpret_cast<const uint4*>(k + row * p.ks[1]));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(v + row * p.vs[1]));
      } else {
        kr[u] = vr[u] = uint4{0u, 0u, 0u, 0u};
      }
    }
    float s[U][MG];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kv[E];
      unpack<TC>(kr[u], kv);
      if (to_q) {
#pragma unroll
        for (int e = 0; e < E; ++e) kv[e] = rounded(kv[e], to_q);
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d += qr[g][e] * kv[e];
#pragma unroll
        for (int x = 1; x < LPR; x *= 2) d += __shfl_xor_sync(0xffffffffu, d, x);
        s[u][g] = d;
      }
    }
    // online combine over the U rows: new max, rescale, p = e^(s - m)
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (r0 + (u * WARPS + warp) * RPW + rg < n) mx = fmaxf(mx, s[u][g]);
      const float alpha = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r0 + (u * WARPS + warp) * RPW + rg >= n) continue;
      float vv[E];
      unpack<TC>(vr[u], vv);
      if (to_q) {
#pragma unroll
        for (int e = 0; e < E; ++e) vv[e] = rounded(vv[e], to_q);
      }
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        const float pe = expf(s[u][g] - m[g]);
        l[g] += pe;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] += pe * vv[e];
      }
    }
  }

  // fold the warp's row groups (lanes c + LPR rg), then the warps
#pragma unroll
  for (int x = LPR; x < 32; x *= 2)
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], x);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[g], x);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn), bo = expf(mo - mn);
      m[g] = mn;
      l[g] = l[g] * a + lo_ * bo;
#pragma unroll
      for (int e = 0; e < E; ++e)
        acc[g][e] = acc[g][e] * a +
                    __shfl_xor_sync(0xffffffffu, acc[g][e], x) * bo;
    }
  float* const Wm = hfav_smem;            // [WARPS][G]
  float* const Wl = Wm + WARPS * G;       // [WARPS][G]
  float* const Wacc = Wl + WARPS * G;     // [WARPS][G][D]
  if (rg == 0 && on) {
#pragma unroll
    for (int g = 0; g < MG; ++g) {
      if (g >= G) break;
      if (c == 0) {
        Wm[warp * G + g] = m[g];
        Wl[warp * G + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
        Wacc[(warp * G + g) * D + c * E + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, Wm[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(Wm[w * G + g] - M);
      L += wt * Wl[w * G + g];
      A += wt * Wacc[(w * G + g) * D + d];
    }
    const long long part = part0 + g * p.nsplit;
    p.part_acc[part * D + d] = A;
    if (d == 0) {
      p.part_ml[part * 2] = M;
      p.part_ml[part * 2 + 1] = L;
    }
  }
}

template <typename TQ>
__global__ void __launch_bounds__(THREADS) combine_kernel(const Params p) {
  const long long bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const float* const ml = p.part_ml + bh * p.nsplit * 2;
  const float* const acc = p.part_acc + bh * p.nsplit * p.D;
  float M = NEG_INF;
  for (long long s = 0; s < p.nsplit; ++s) M = fmaxf(M, ml[2 * s]);
  for (long long d = threadIdx.x; d < p.D; d += THREADS) {
    float L = 0.f, A = 0.f;
    for (long long s = 0; s < p.nsplit; ++s) {
      const float w = expf(ml[2 * s] - M);
      L += w * ml[2 * s + 1];
      A += w * acc[s * p.D + d];
    }
    store(static_cast<TQ*>(p.o) + b * p.os[0] + h * p.os[1] + d,
          A / fmaxf(L, 1e-30f));
  }
}

template <typename TC, int D, int MG>
int launch(const Params& p, void* stream, long long* grids) {
  const long long nsplit_blocks = p.B * p.KVH * p.nsplit;
  const long long smem =
      WARPS * (p.H / p.KVH) * (D + 2) * (long long)sizeof(float);
  auto combine = p.q_type == 1   ? combine_kernel<__nv_bfloat16>
                 : p.q_type == 2 ? combine_kernel<__half>
                                 : combine_kernel<float>;
  grids[0] = grids[1] = 0;
  if (p.B * p.H == 0) return 0;
#ifdef HFAV_EMULATE
  (void)stream;
  int e = emulate_launch(split_kernel<TC, D, MG>, p, nsplit_blocks, THREADS,
                         smem);
  if (e) return e;
  grids[0] = nsplit_blocks;
  e = emulate_launch(combine, p, p.B * p.H, THREADS, 0);
  if (e) return e;
  grids[1] = p.B * p.H;
  return 0;
#else
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      split_kernel<TC, D, MG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  split_kernel<TC, D, MG><<<static_cast<unsigned>(nsplit_blocks), THREADS,
                            static_cast<size_t>(smem), st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grids[0] = nsplit_blocks;
  combine<<<static_cast<unsigned>(p.B * p.H), THREADS, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grids[1] = p.B * p.H;
  return 0;
#endif
}

template <typename TC, int D>
int dispatch_group(const Params& p, void* stream, long long* grids) {
  const long long G = p.H / p.KVH;
  if (G <= 1) return launch<TC, D, 1>(p, stream, grids);
  if (G <= 2) return launch<TC, D, 2>(p, stream, grids);
  if (G <= 4) return launch<TC, D, 4>(p, stream, grids);
  if (G <= 8) return launch<TC, D, 8>(p, stream, grids);
  if (G <= 16) return launch<TC, D, 16>(p, stream, grids);
  return -1;
}

template <typename TC>
int dispatch_d(const Params& p, void* stream, long long* grids) {
  switch (p.D) {
    case 16: return dispatch_group<TC, 16>(p, stream, grids);
    case 32: return dispatch_group<TC, 32>(p, stream, grids);
    case 64: return dispatch_group<TC, 64>(p, stream, grids);
    case 80: return dispatch_group<TC, 80>(p, stream, grids);
    case 128: return dispatch_group<TC, 128>(p, stream, grids);
    default: return -1;
  }
}

}  // namespace fd

// ptrs: q, k_cache, v_cache, lengths (int32), o, part_ml, part_acc,
// part_n.  ints: q dtype, cache dtype (0 float32, 1 bfloat16, 2
// float16), B, S, H,
// KVH, D, nsplit, window (<= 0: none), the (batch, head) strides of q
// and o, the (batch, seq, head) strides of k and v, in elements.  grids
// receives the blocks launched: split kernel, combine kernel.  Returns
// 0, a CUDA error code, -1 for a group size, head dim or dtype it was not
// built for, or -2 for cache rows that are not 16-byte aligned.
extern "C" int fd_decode(void* const* ptrs, const long long* ints,
                         float scale, void* stream, long long* grids) {
  fd::Params p;
  p.q = ptrs[0];
  p.k = ptrs[1];
  p.v = ptrs[2];
  p.lengths = static_cast<const int*>(ptrs[3]);
  p.o = ptrs[4];
  p.part_ml = static_cast<float*>(ptrs[5]);
  p.part_acc = static_cast<float*>(ptrs[6]);
  p.part_n = static_cast<int*>(ptrs[7]);
  p.B = ints[2];
  p.S = ints[3];
  p.H = ints[4];
  p.KVH = ints[5];
  p.D = ints[6];
  p.nsplit = ints[7];
  p.window = ints[8];
  p.qs[0] = ints[9];
  p.qs[1] = ints[10];
  p.os[0] = ints[11];
  p.os[1] = ints[12];
  for (int a = 0; a < 3; ++a) {
    p.ks[a] = ints[13 + a];
    p.vs[a] = ints[16 + a];
  }
  p.scale = scale;
  grids[0] = grids[1] = 0;
  const long long tq = ints[0], tc = ints[1];
  if (tq < 0 || tq > 2 || tc < 0 || tc > 2 || p.nsplit < 1) return -1;
  p.q_type = static_cast<int>(tq);
  p.round_to = tq != 0 && tc != tq ? static_cast<int>(tq) : 0;
  const long long step = tc ? 8 : 4;  // elements in 16 bytes
  const void* bases[2] = {p.k, p.v};
  for (const void* ptr : bases)
    if (reinterpret_cast<unsigned long long>(ptr) % 16) return -2;
  for (int a = 0; a < 3; ++a)
    if (p.ks[a] % step || p.vs[a] % step) return -2;
  // FD_CACHE, where defined, builds the split kernels of one cache type
  // (0 float32, 1 bf16, 2 float16): kernel.py builds one library a type,
  // the three in parallel, where one nvcc over all of them would be the
  // longest job of the port's build
#if !defined(FD_CACHE) || FD_CACHE == 0
  if (tc == 0) return fd::dispatch_d<float>(p, stream, grids);
#endif
#if !defined(FD_CACHE) || FD_CACHE == 1
  if (tc == 1) return fd::dispatch_d<__nv_bfloat16>(p, stream, grids);
#endif
#if !defined(FD_CACHE) || FD_CACHE == 2
  if (tc == 2) return fd::dispatch_d<__half>(p, stream, grids);
#endif
  return -1;
}

extern "C" const char* fd_error_string(int e) {
  if (e == -1) return "group size, head dim or dtype not built";
  if (e == -2)
    return "cache rows are read 16 bytes at a time: the caches need "
           "16-byte aligned bases and (batch, seq, head) strides";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
