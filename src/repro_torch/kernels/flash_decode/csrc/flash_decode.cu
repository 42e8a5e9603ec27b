// Split-KV decode attention (CUDA C++, sm_90a): K3 of the port.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_decode/kernel.py:flash_decode (_decode_kernel):
// one new query token per sequence attends over its KV cache; only the
// first lengths[b] positions count, less those outside an optional
// sliding window.  The KV axis is the reduced dimension of the HFAV
// reduction triple (identity, online combine, normalise).
//
// Decomposition (flash-decoding).  The TPU kernel walks the whole cache
// of one (batch, KV head) in order on one core: grid (B, KVH, nkv).  On
// this card B * KVH blocks would leave most of the 132 SMs idle (32 at
// qwen3-0.6b's B = 4, KVH = 8), so the KV axis is also split across
// blocks: block (b, kvh, split) takes keys [split * chunk, (split + 1) *
// chunk) of the valid range, with the `group` query heads of one KV head
// together, as in the TPU kernel, and leaves one partial (m, l, acc) per
// query head.  A second, small kernel combines the partials of each
// (b, h) in split order:  M = max m_s,  out = sum e^(m_s - M) acc_s /
// max(sum e^(m_s - M) l_s, 1e-30).  A split that holds no valid key
// (past lengths[b], or before the window) exits at once and leaves the
// identity (m = -1e30, l = 0, acc = 0), which the combine weighs by
// exp(-1e30 - M) = 0.
//
// Inside a block the chunk's scores fit in shared memory, so the softmax
// of one chunk is exact (one max, one sum) and needs no online rescale:
// K is staged through shared memory 64 keys at a time (coalesced loads,
// odd-padded rows), each thread takes (head, key) dot products, tree
// reductions give each head's max and sum, then thread d sums p * v over
// the chunk for column d of every head of the group, reading V once.
//
// Layout.  q is read from (B, H, D) and the caches in place from
// (B, S, KVH, D) through their strides; the TPU kernel's transpose of the
// caches to (B, KVH, S, D) copies the whole cache on every call.
//
// What bounds it.  Each step reads the valid part of K and V once and
// does ~4 flops per cached element, far below the card's ~295 flops per
// byte in bf16, so device-memory bytes bound it.  Splitting the KV axis
// is what gives it enough blocks to stream at the memory rate.
//
// Types.  q may be float32 or bf16, the caches float32 or bf16.  When q is
// bf16 and the caches float32, each cached value is rounded to bf16 on
// load, as the reference casts the caches to the compute dtype before
// attending; all arithmetic is float32 and the output takes q's dtype.
#ifdef HFAV_EMULATE
#include "../../stencil2d/csrc/emulate.h"
#else
#include <cuda_bf16.h>
#include <cuda_runtime.h>
// the block's dynamic shared memory (emulate.h defines it for the host)
extern __shared__ float hfav_smem[];
#endif
#include <math.h>

namespace fd {

constexpr int THREADS = 128;
constexpr int KT = 64;  // keys staged in shared memory at a time
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  float* part_ml;   // (B, H, nsplit, 2): m, l
  float* part_acc;  // (B, H, nsplit, D)
  long long B, S, H, KVH, D, chunk, nsplit, window;  // window <= 0: none
  long long qs[2], ks[3], vs[3], os[2];
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// A cached value as the attention sees it: widened to float32, after
// rounding to bf16 when the query (the compute dtype) is bf16.
template <typename TQ, typename TC>
__device__ __forceinline__ float cached(TC x) {
  if constexpr (sizeof(TQ) == 2 && sizeof(TC) == 4)
    return __bfloat162float(__float2bfloat16(x));
  else
    return to_f(x);
}

inline long long smem_floats(long long group, long long D, long long chunk) {
  return group * D + KT * (D + 1) + group * chunk + 2 * THREADS;
}

// MG: the group size rounded up to a power of two (the head slots of the
// per-thread accumulators).
template <typename TQ, typename TC, int MG>
__global__ void __launch_bounds__(THREADS) split_kernel(const Params p) {
  // 32-bit index arithmetic inside the block (64-bit division is slow)
  const int G = static_cast<int>(p.H / p.KVH), D = static_cast<int>(p.D);
  float* const Qs = hfav_smem;         // [G][D], scaled
  float* const Ks = Qs + G * D;        // [KT][D + 1]
  float* const Sc = Ks + KT * (D + 1);  // [G][chunk] scores, then p
  float* const Red = Sc + G * p.chunk;  // [THREADS] reductions
  float* const Red2 = Red + THREADS;

  const int tid = threadIdx.x;
  long long bid = blockIdx.x;
  const long long split = bid % p.nsplit;
  bid /= p.nsplit;
  const long long kvh = bid % p.KVH, b = bid / p.KVH;
  const long long len = p.lengths[b];
  const long long end = len < p.S ? len : p.S;  // a length past the cache
  long long lo = split * p.chunk;               // counts the whole cache
  const long long hi = lo + p.chunk < end ? lo + p.chunk : end;
  if (p.window > 0 && lo < len - p.window) lo = len - p.window;
  const int n = static_cast<int>(hi - lo);  // valid keys of this split
  const long long part0 = (b * p.H + kvh * G) * p.nsplit + split;

  if (n <= 0) {  // the identity of the reduction triple
    for (int g = tid; g < G; g += THREADS) {
      p.part_ml[(part0 + g * p.nsplit) * 2] = NEG_INF;
      p.part_ml[(part0 + g * p.nsplit) * 2 + 1] = 0.f;
    }
    for (int idx = tid; idx < G * D; idx += THREADS)
      p.part_acc[(part0 + (idx / D) * p.nsplit) * D + idx % D] = 0.f;
    return;
  }

  const TQ* const q = static_cast<const TQ*>(p.q) + b * p.qs[0];
  for (int idx = tid; idx < G * D; idx += THREADS) {
    const int g = idx / D, d = idx % D;
    Qs[idx] = to_f(q[(kvh * G + g) * p.qs[1] + d]) * p.scale;
  }
  const TC* const k = static_cast<const TC*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const TC* const v = static_cast<const TC*>(p.v) + b * p.vs[0] + kvh * p.vs[2];

  // scores of every (head, key) of the chunk
  for (int t0 = 0; t0 < n; t0 += KT) {
    const int nt = n - t0 < KT ? n - t0 : KT;
    __syncthreads();  // Qs is complete; the last tile's reads are done
    for (int idx = tid; idx < nt * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      Ks[r * (D + 1) + d] = cached<TQ, TC>(k[(lo + t0 + r) * p.ks[1] + d]);
    }
    __syncthreads();
    for (int pair = tid; pair < G * KT; pair += THREADS) {
      const int g = pair / KT, r = pair % KT;
      if (r >= nt) continue;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s += Qs[g * D + d] * Ks[r * (D + 1) + d];
      Sc[g * p.chunk + t0 + r] = s;
    }
  }
  __syncthreads();

  // each head's max and sum over the chunk: THREADS / MG threads a head
  constexpr int TPG = THREADS / MG;
  const int g = tid / TPG, lane = tid % TPG;
  float mx = NEG_INF;
  if (g < G)
    for (int j = lane; j < n; j += TPG) mx = fmaxf(mx, Sc[g * p.chunk + j]);
  Red[tid] = mx;
  __syncthreads();
  for (int s = TPG / 2; s > 0; s /= 2) {
    if (lane < s) Red[tid] = fmaxf(Red[tid], Red[tid + s]);
    __syncthreads();
  }
  const float m = Red[g * TPG];
  float sum = 0.f;
  if (g < G)
    for (int j = lane; j < n; j += TPG) {
      const float e = expf(Sc[g * p.chunk + j] - m);
      Sc[g * p.chunk + j] = e;
      sum += e;
    }
  Red2[tid] = sum;
  __syncthreads();
  for (int s = TPG / 2; s > 0; s /= 2) {
    if (lane < s) Red2[tid] += Red2[tid + s];
    __syncthreads();
  }
  if (g < G && lane == 0) {
    p.part_ml[(part0 + g * p.nsplit) * 2] = m;
    p.part_ml[(part0 + g * p.nsplit) * 2 + 1] = Red2[tid];
  }

  // acc[g][d] = sum_j p[g][j] * v[j][d], one column per thread
  for (int d = tid; d < D; d += THREADS) {
    float acc[MG];
#pragma unroll
    for (int gg = 0; gg < MG; ++gg) acc[gg] = 0.f;
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float vv = cached<TQ, TC>(v[(lo + j) * p.vs[1] + d]);
#pragma unroll
      for (int gg = 0; gg < MG; ++gg)
        if (gg < G) acc[gg] += Sc[gg * p.chunk + j] * vv;
    }
#pragma unroll
    for (int gg = 0; gg < MG; ++gg)
      if (gg < G) p.part_acc[(part0 + gg * p.nsplit) * D + d] = acc[gg];
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

template <typename TQ, typename TC, int MG>
int launch(const Params& p, void* stream, long long* grids) {
  const long long nsplit_blocks = p.B * p.KVH * p.nsplit;
  const long long smem =
      smem_floats(p.H / p.KVH, p.D, p.chunk) * (long long)sizeof(float);
  grids[0] = grids[1] = 0;
  if (p.B * p.H == 0) return 0;
#ifdef HFAV_EMULATE
  (void)stream;
  int e = emulate_launch(split_kernel<TQ, TC, MG>, p, nsplit_blocks, THREADS,
                         smem);
  if (e) return e;
  grids[0] = nsplit_blocks;
  e = emulate_launch(combine_kernel<TQ>, p, p.B * p.H, THREADS, 0);
  if (e) return e;
  grids[1] = p.B * p.H;
  return 0;
#else
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaFuncSetAttribute(
      split_kernel<TQ, TC, MG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  split_kernel<TQ, TC, MG><<<static_cast<unsigned>(nsplit_blocks), THREADS,
                             static_cast<size_t>(smem), st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grids[0] = nsplit_blocks;
  combine_kernel<TQ><<<static_cast<unsigned>(p.B * p.H), THREADS, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  grids[1] = p.B * p.H;
  return 0;
#endif
}

template <typename TQ, typename TC>
int dispatch_group(const Params& p, void* stream, long long* grids) {
  const long long G = p.H / p.KVH;
  if (G <= 1) return launch<TQ, TC, 1>(p, stream, grids);
  if (G <= 2) return launch<TQ, TC, 2>(p, stream, grids);
  if (G <= 4) return launch<TQ, TC, 4>(p, stream, grids);
  if (G <= 8) return launch<TQ, TC, 8>(p, stream, grids);
  if (G <= 16) return launch<TQ, TC, 16>(p, stream, grids);
  return -1;
}

}  // namespace fd

// ptrs: q, k_cache, v_cache, lengths (int32), o, part_ml, part_acc.
// ints: q dtype, cache dtype (0 float32, 1 bfloat16), B, S, H, KVH, D,
// chunk, nsplit, window (<= 0: none), the (batch, head) strides of q and
// o, the (batch, seq, head) strides of k and v, in elements.  grids
// receives the blocks launched: split kernel, combine kernel.  Returns 0,
// a CUDA error code, or -1 for a group size or dtype it was not built for.
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
  p.B = ints[2];
  p.S = ints[3];
  p.H = ints[4];
  p.KVH = ints[5];
  p.D = ints[6];
  p.chunk = ints[7];
  p.nsplit = ints[8];
  p.window = ints[9];
  p.qs[0] = ints[10];
  p.qs[1] = ints[11];
  p.os[0] = ints[12];
  p.os[1] = ints[13];
  for (int a = 0; a < 3; ++a) {
    p.ks[a] = ints[14 + a];
    p.vs[a] = ints[17 + a];
  }
  p.scale = scale;
  const long long tq = ints[0], tc = ints[1];
  if (tq == 0 && tc == 0)
    return fd::dispatch_group<float, float>(p, stream, grids);
  if (tq == 0 && tc == 1)
    return fd::dispatch_group<float, __nv_bfloat16>(p, stream, grids);
  if (tq == 1 && tc == 0)
    return fd::dispatch_group<__nv_bfloat16, float>(p, stream, grids);
  if (tq == 1 && tc == 1)
    return fd::dispatch_group<__nv_bfloat16, __nv_bfloat16>(p, stream, grids);
  return -1;
}

extern "C" const char* fd_error_string(int e) {
  if (e == -1) return "group size or dtype not built";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
