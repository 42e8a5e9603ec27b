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
// Decomposition.  The TPU kernel walks KV blocks as the sequential last
// grid axis and carries (m, l, acc) in VMEM scratch.  Here one block
// owns one (batch, head, 64-row query tile) and a loop inside it walks
// the KV tiles, so the accumulators live in registers for the block's
// whole life.  Causal tiles stop at the diagonal and tiles a sliding
// window masks entirely are skipped: with the finite sentinel -1e30 a
// fully masked tile only adds p = 1 terms while m is still -1e30, which
// the first real score wipes out (alpha = exp(-1e30 - m) = 0), so
// skipping it changes nothing for a row that has one unmasked key.  The
// heaviest causal tiles (the last query tiles) are launched first.
//
// Layout.  q is read in place from (B, Sq, H, D) and k, v from
// (B, Skv, KVH, D) through their strides (the last dim contiguous); the
// TPU kernel's transposes to (B*H, S, D) are full copies on this card.
// Query head h reads KV head h / (H / KVH).  Ragged sizes need no
// padding: keys past Skv load as zeros and are masked, query rows past
// Sq are computed and not stored.
//
// What bounds it.  At the prefill shape the work is ~2*2*Sq*Skv*D flops
// per head (half of it under a causal mask) against one read of q, k, v
// and one write of o, so the tensor-core rate bounds it.  This first
// version uses scalar float32 FMA from shared memory (no mma, no TMA):
// 256 threads, each holding a 4 x 4 score tile and a 4 x D/16 slice of
// the output; K, then V, of one tile share one shared-memory buffer, so
// a block needs ~92 KB at D = 128 and two blocks fit on an SM.  Padded
// strides (BQ + 1, BKV + 1) keep the transposed stores and the score
// loop free of bank conflicts.  bf16 inputs are widened to float32 on
// load; all arithmetic and accumulation is float32, as on the TPU.
#ifdef HFAV_EMULATE
#include "../../stencil2d/csrc/emulate.h"
#else
#include <cuda_bf16.h>
#include <cuda_runtime.h>
// the block's dynamic shared memory (emulate.h defines it for the host)
extern __shared__ float hfav_smem[];
#endif
#include <math.h>

namespace fa {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per tile
constexpr int TX = 16;    // threads along the keys / head dim
constexpr int TY = 16;    // threads along the query rows
constexpr int THREADS = TX * TY;
constexpr int RQ = BQ / TY;   // query rows per thread: ty + TY * i
constexpr int RK = BKV / TX;  // keys per thread: tx + TX * j
constexpr int QLD = BQ + 1;   // padded leading dims in shared memory
constexpr int KLD = BKV + 1;
constexpr int PLD = BKV + 1;
constexpr int RLD = TX + 1;
constexpr float NEG_INF = -1e30f;  // finite: exp(NEG_INF - NEG_INF) = 1

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ long long lmin(long long a, long long b) {
  return a < b ? a : b;
}
__device__ __forceinline__ long long lmax(long long a, long long b) {
  return a > b ? a : b;
}

template <int D>
constexpr long long smem_floats() {
  return (long long)D * QLD + (D * KLD > BKV * D ? D * KLD : BKV * D) +
         BQ * PLD + 2 * BQ * RLD;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) attn_kernel(const Params p) {
  constexpr int NC = D / TX;  // output columns per thread: tx + TX * c
  float* const Qs = hfav_smem;                 // [D][QLD], scaled
  float* const KVs = Qs + D * QLD;             // K as [D][KLD], V as [BKV][D]
  float* const Ps = KVs + (D * KLD > BKV * D ? D * KLD : BKV * D);  // [BQ][PLD]
  float* const Rmax = Ps + BQ * PLD;           // [BQ][RLD] row partials
  float* const Rsum = Rmax + BQ * RLD;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  long long bid = blockIdx.x;
  const long long qt = p.nq - 1 - bid % p.nq;  // heaviest tiles first
  bid /= p.nq;
  const long long h = bid % p.H, b = bid / p.H;
  const long long kvh = h / (p.H / p.KVH);
  const T* const q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* const k = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* const v = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  T* const o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[2];
  const long long q0 = qt * BQ;

  // the query tile, transposed and scaled (q.astype(f32) * scale)
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const long long s = q0 + r;
    Qs[d * QLD + r] = s < p.Sq ? to_f(q[s * p.qs[1] + d]) * p.scale : 0.f;
  }

  // the KV tiles any row of this query tile can see
  const long long qlo = q0 + p.q_offset;
  const long long qhi = lmin(q0 + BQ, p.Sq) - 1 + p.q_offset;
  long long klo = 0, khi = p.Skv - 1;
  if (p.causal) khi = lmin(khi, qhi);
  if (p.window > 0) klo = lmax(klo, qlo - p.window + 1);
  const long long t_first = klo / BKV;
  const long long t_last = khi >= klo ? khi / BKV : t_first - 1;

  float m[RQ], l[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (long long t = t_first; t <= t_last; ++t) {
    const long long k0 = t * BKV;
    __syncthreads();  // the last tile's V and P reads are done
    for (int idx = tid; idx < BKV * D; idx += THREADS) {
      const int r = idx / D, d = idx % D;
      const long long s = k0 + r;
      KVs[d * KLD + r] = s < p.Skv ? to_f(k[s * p.ks[1] + d]) : 0.f;
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
      KVs[r * D + d] = s < p.Skv ? to_f(v[s * p.vs[1] + d]) : 0.f;
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
      store(o + s * p.os[1] + tx + TX * c, acc[i][c] / li);
  }
}

template <typename T, int D>
int launch(const Params& p, void* stream, long long* grids) {
  const long long nblocks = p.B * p.H * p.nq;
  const long long smem = smem_floats<D>() * (long long)sizeof(float);
  grids[0] = 0;
  if (nblocks == 0) return 0;
#ifdef HFAV_EMULATE
  (void)stream;
  const int e = emulate_launch(attn_kernel<T, D>, p, nblocks, THREADS, smem);
  if (e == 0) grids[0] = nblocks;
  return e;
#else
  const cudaError_t e = cudaFuncSetAttribute(
      attn_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  attn_kernel<T, D><<<static_cast<unsigned>(nblocks), THREADS,
                      static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(p);
  const cudaError_t l = cudaGetLastError();
  if (l == cudaSuccess) grids[0] = nblocks;
  return static_cast<int>(l);
#endif
}

template <typename T>
int dispatch_d(long long D, const Params& p, void* stream, long long* grids) {
  switch (D) {
    case 16: return launch<T, 16>(p, stream, grids);
    case 32: return launch<T, 32>(p, stream, grids);
    case 64: return launch<T, 64>(p, stream, grids);
    case 80: return launch<T, 80>(p, stream, grids);
    case 128: return launch<T, 128>(p, stream, grids);
    default: return -1;
  }
}

}  // namespace fa

// ptrs: q, k, v, o.  ints: dtype (0 float32, 1 bfloat16), B, Sq, Skv,
// H, KVH, D, the (batch, seq, head) strides of q, k, v and o in
// elements, causal, window (<= 0: none), q_offset.  grids receives the
// blocks launched.  Returns 0, a CUDA error code, or -1 for a head dim or
// dtype it was not built for.
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
  if (ints[0] == 0) return fa::dispatch_d<float>(ints[6], p, stream, grids);
  if (ints[0] == 1)
    return fa::dispatch_d<__nv_bfloat16>(ints[6], p, stream, grids);
  return -1;
}

extern "C" const char* fa_error_string(int e) {
  if (e == -1) return "head dim or dtype not built";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
