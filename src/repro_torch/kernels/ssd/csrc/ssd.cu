// Mamba2 SSD chunked scan (CUDA C++, sm_90a): K4 of the port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd/kernel.py:ssd_pallas
// (_ssd_kernel).  For each (batch b, head h) the sequence is cut into
// chunks of L tokens, and an (N, P) float32 state S is carried from chunk
// to chunk.  Within a chunk, with cs the inclusive prefix sum of dt:
//
//   M[t][u] = (C_t . B_u) exp(A (cs_t - cs_u)) dt_u   for u <= t, else 0
//   y_t     = sum_u M[t][u] x_u + exp(A cs_t) (C_t . S) + D x_t
//   S      <- exp(A cs_L) S + sum_u exp(A (cs_L - cs_u)) dt_u B_u (x) x_u
//
// Decomposition.  The TPU grid (B, H, n_chunks) walks the chunks of one
// (b, h) in order on one core and keeps S in VMEM scratch.  Here one block
// takes one (b, h) and walks its chunks in a loop, with S in shared memory
// for the whole walk (128 x 64 x 4 = 32 KB at mamba2-130m).  The chunk's
// L x L matrix M does not fit (256 KB at L = 256), so it is made and used
// one 64 x 64 (t, u) tile at a time, and only the tiles with u-tile <=
// t-tile are visited (the causal half, as flash attention stops at the
// diagonal).  Inside a tile the exponent A (cs_t - cs_u) is positive for
// u > t and may overflow, so M is selected to 0 there, never multiplied
// by a 0/1 mask (inf * 0 = NaN).  The prefix sum of dt is taken by one
// thread in token order, where the reference multiplies by a
// lower-triangular matrix of ones: the same sums in another order.
//
// Each 64 x 64 product is scalar float32 FMA from shared memory: 256
// threads, each owning a 4 x 4 register tile (rows ty + 16 i, columns
// tx + 16 j), with C rows padded to N + 1 and B tiles stored transposed
// and padded to 65, so no product reads a bank twice.  The state update
// gives each thread up to 8 x 4 entries of S.  The state after the last
// chunk is not an output (prefill leaves no SSM cache), so it is not
// computed.
//
// Layout.  x (B, S, H, P) and y are read and written by their strides
// (head dim contiguous), dt (B, S, H) by its strides, Bm and Cm (B, S, N)
// by their batch and sequence strides (state dim contiguous), so the
// model's slices of its input projection are read in place.  x and y are
// float32 or bf16; everything else, and all arithmetic, is float32.
//
// What bounds it.  At mamba2-130m's prefill (B = 4, S = 2048, H = 24,
// P = 64, N = 128, L = 256) the function needs about 16 GFLOP of float32
// products and moves about 60 MB: at the card's float32 rate the
// operations take longer than the bytes (PERF.md).  This first design is
// bound by neither: it runs one block per (b, h), 96 blocks on 132 SMs
// at that shape, each walking 8 chunks in sequence, with scalar FMA fed
// from shared memory; every head's block re-reads Bm and Cm, which all
// heads share.  Splitting the chunk axis across blocks (per-chunk states
// in parallel, a short sequential pass over the states, then the
// outputs) and tensor-core products are the next steps (ROADMAP, K4).
#ifdef HFAV_EMULATE
#include "../../stencil2d/csrc/emulate.h"
#else
#include <cuda_bf16.h>
#include <cuda_runtime.h>
// the block's dynamic shared memory (emulate.h defines it for the host)
extern __shared__ float hfav_smem[];
#endif
#include <math.h>

namespace ssd {

constexpr int THREADS = 256;
constexpr int TX = 16;  // threads along a tile's columns; 16 rows of them
constexpr int T = 64;   // rows (t or u) of a tile
constexpr int MAX_P = 4 * TX;
constexpr int MAX_N = 8 * TX;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* D;
  void* y;
  long long B, S, H, P, N, L;
  long long xs[3], dts[3], bs[2], cs[2], ys[3];  // strides, in elements
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* q, float v) { *q = v; }
__device__ __forceinline__ void store(__nv_bfloat16* q, float v) {
  *q = __float2bfloat16(v);
}
__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

inline long long smem_floats(long long N, long long P, long long L) {
  return N * P + 2 * L + T * (N + 1) + N * (T + 1) + T * P + T * (T + 1);
}

template <typename TXY>
__global__ void __launch_bounds__(THREADS) chunk_scan(const Params p) {
  // 32-bit index arithmetic inside the block
  const int N = static_cast<int>(p.N), P = static_cast<int>(p.P);
  const int L = static_cast<int>(p.L);
  const int nc = static_cast<int>(p.S / p.L);
  float* const Ss = hfav_smem;          // [N][P] the carried state
  float* const dts = Ss + N * P;        // [L] dt of the chunk
  float* const cum = dts + L;           // [L] its inclusive prefix sum
  float* const Ct = cum + L;            // [T][N + 1] C rows of a t tile
  float* const Bt = Ct + T * (N + 1);   // [N][T + 1] B rows of a u tile
  float* const Xs = Bt + N * (T + 1);   // [T][P] x rows of a u tile
  float* const Mt = Xs + T * P;         // [T][T + 1] a tile of M

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const long long b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const float a = p.A[h], dskip = p.D[h];
  const TXY* const x =
      static_cast<const TXY*>(p.x) + b * p.xs[0] + h * p.xs[2];
  TXY* const y = static_cast<TXY*>(p.y) + b * p.ys[0] + h * p.ys[2];
  const float* const dt = p.dt + b * p.dts[0] + h * p.dts[2];
  const float* const Bm = p.Bm + b * p.bs[0];
  const float* const Cm = p.Cm + b * p.cs[0];
  // this thread's columns; one past P reads column P - 1 (never stored)
  int col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col[j] = imin(tx + TX * j, P - 1);

  for (int idx = tid; idx < N * P; idx += THREADS) Ss[idx] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const long long s0 = static_cast<long long>(c) * L;
    __syncthreads();  // the last chunk is done with dts, cum and Ss
    for (int i = tid; i < L; i += THREADS) dts[i] = dt[(s0 + i) * p.dts[1]];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int i = 0; i < L; ++i) {
        s += dts[i];
        cum[i] = s;
      }
    }

    for (int t0 = 0; t0 < L; t0 += T) {
      const int nt = imin(T, L - t0);
      __syncthreads();  // cum is written; the last tile's reads are done
      for (int idx = tid; idx < nt * N; idx += THREADS) {
        const int r = idx / N, n = idx - r * N;
        Ct[r * (N + 1) + n] = Cm[(s0 + t0 + r) * p.cs[1] + n];
      }
      __syncthreads();
      // the rolled-in state: acc = exp(A cs_t) (C_t . S).  Rows past nt
      // hold stale C rows; they are never stored.
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Ct[(ty + TX * i) * (N + 1) + n];
#pragma unroll
        for (int j = 0; j < 4; ++j) sv[j] = Ss[n * P + col[j]];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += cv[i] * sv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = expf(a * cum[t0 + imin(ty + TX * i, nt - 1)]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }

      // the chunk itself: u tiles up to the diagonal
      for (int u0 = 0; u0 <= t0; u0 += T) {
        const int nu = imin(T, L - u0);
        __syncthreads();  // the last u tile's readers of Bt, Xs, Mt are done
        for (int idx = tid; idx < nu * N; idx += THREADS) {
          const int r = idx / N, n = idx - r * N;
          Bt[n * (T + 1) + r] = Bm[(s0 + u0 + r) * p.bs[1] + n];
        }
        for (int idx = tid; idx < nu * P; idx += THREADS) {
          const int r = idx / P, q = idx - r * P;
          Xs[r * P + q] = to_f(x[(s0 + u0 + r) * p.xs[1] + q]);
        }
        __syncthreads();
        float g[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Ct[(ty + TX * i) * (N + 1) + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bt[n * (T + 1) + tx + TX * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) g[i][j] += cv[i] * bv[j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty + TX * i, tc = imin(t, L - 1);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = u0 + tx + TX * j;
            // selected, not masked: exp of a positive exponent may be inf
            float m = 0.f;
            if (u <= t && t < L) m = g[i][j] * expf(a * (cum[tc] - cum[u])) * dts[u];
            Mt[(ty + TX * i) * (T + 1) + tx + TX * j] = m;
          }
        }
        __syncthreads();
        for (int k = 0; k < nu; ++k) {
          float mv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) mv[i] = Mt[(ty + TX * i) * (T + 1) + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = Xs[k * P + col[j]];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] += mv[i] * xv[j];
        }
      }

      // y = acc + D x
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty + TX * i;
        if (t >= nt) continue;
        const long long row = s0 + t0 + t;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int q = tx + TX * j;
          if (q < P)
            store(y + row * p.ys[1] + q,
                  acc[i][j] + dskip * to_f(x[row * p.xs[1] + q]));
        }
      }
    }

    // state passing: S <- exp(A cs_L) S + B^T diag(w) X, w_u = exp(A (cs_L
    // - cs_u)) dt_u; not needed after the last chunk
    if (c + 1 == nc) break;
    __syncthreads();  // every reader of Ss (C . S) is done
    const float last = cum[L - 1];
    const float dfull = expf(a * last);
    float sacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = imin(ty + TX * i, N - 1);
#pragma unroll
      for (int j = 0; j < 4; ++j) sacc[i][j] = Ss[n * P + col[j]] * dfull;
    }
    for (int u0 = 0; u0 < L; u0 += T) {
      const int nu = imin(T, L - u0);
      __syncthreads();  // the last u tile's readers of Bt and Xs are done
      for (int idx = tid; idx < nu * N; idx += THREADS) {
        const int r = idx / N, n = idx - r * N;
        const float w = expf(a * (last - cum[u0 + r])) * dts[u0 + r];
        Bt[n * (T + 1) + r] = Bm[(s0 + u0 + r) * p.bs[1] + n] * w;
      }
      for (int idx = tid; idx < nu * P; idx += THREADS) {
        const int r = idx / P, q = idx - r * P;
        Xs[r * P + q] = to_f(x[(s0 + u0 + r) * p.xs[1] + q]);
      }
      __syncthreads();
      for (int k = 0; k < nu; ++k) {
        float bv[8], xv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          bv[i] = Bt[imin(ty + TX * i, N - 1) * (T + 1) + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = Xs[k * P + col[j]];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sacc[i][j] += bv[i] * xv[j];
      }
    }
    // each thread writes only its own entries, which only it has read
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = ty + TX * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx + TX * j;
        if (n < N && q < P) Ss[n * P + q] = sacc[i][j];
      }
    }
  }
}

template <typename TXY>
int launch(const Params& p, void* stream, long long* grid) {
  const long long blocks = p.B * p.H;
  const long long smem = smem_floats(p.N, p.P, p.L) *
                         static_cast<long long>(sizeof(float));
  *grid = 0;
  if (blocks == 0 || p.S == 0) return 0;
#ifdef HFAV_EMULATE
  (void)stream;
  const int e = emulate_launch(chunk_scan<TXY>, p, blocks, THREADS, smem);
  if (e) return e;
#else
  cudaError_t e = cudaFuncSetAttribute(
      chunk_scan<TXY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  chunk_scan<TXY><<<static_cast<unsigned>(blocks), THREADS,
                    static_cast<size_t>(smem),
                    static_cast<cudaStream_t>(stream)>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
#endif
  *grid = blocks;
  return 0;
}

}  // namespace ssd

// ptrs: x, dt, A, Bm, Cm, D, y.  ints: x/y dtype (0 float32, 1 bfloat16),
// B, S, H, P, N, L (a divisor of S), the (batch, seq, head) strides of x,
// of dt and of y, and the (batch, seq) strides of Bm and of Cm, in
// elements.  grid receives the blocks launched.  Returns 0, a CUDA error
// code, -1 for a dtype it was not built for, or -2 for a shape it does not
// take (P > 64, N > 128, or L not dividing S).
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
  if (ints[0] == 0) return ssd::launch<float>(p, stream, grid);
  if (ints[0] == 1) return ssd::launch<__nv_bfloat16>(p, stream, grid);
  return -1;
}

extern "C" const char* ssd_error_string(int e) {
  if (e == -1) return "dtype not built";
  if (e == -2) return "shape not taken (P <= 64, N <= 128, L divides S)";
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
