// Device machinery of the HFAV stencil kernel (CUDA C++, sm_90a).
//
// Replaces the Pallas TPU stencil interpreter
// src/repro/kernels/stencil2d/kernel.py:build_call.  The emitter
// (repro_torch/kernels/stencil2d/emit.py) writes one .cu per CallPlan
// holding only the plan's step sequence and its lowered kernel bodies;
// everything shared lives here:
//
//   * floor-mod slots and clamped row / plane indices (the reference's
//     _mod and _row_pos: warm-up and drain steps repeat edge rows),
//   * the row ring: input rows copied a few row steps ahead of their use
//     by cp.async (the emitter fixes how many: emit.RING),
//   * predicated row seats and output rows,
//   * the block, chunk and ownership logic of the decomposition,
//   * the fold of the accumulators' per-block partial rows by the last
//     block to finish.
//
// Decomposition.  A Pallas TPU grid runs in order and carries VMEM state
// from step to step; CUDA blocks run in parallel.  So a block walks its
// rows of j in a loop (threads stride over the columns of each row), the
// outer dims that an accumulator spans are walked in order inside the
// block, and the other outer tiles go across blocks.  Both the row range
// and, in a call with plane windows, the plane dim (the last outer dim)
// are cut into chunks, one block for each pair of a plane chunk and a row
// chunk (a row tile of those planes).  A block starts its walk early so
// that its windows hold what an in-order run would hold at its first
// owned step: `prime` rows before its first owned row (the longest chain
// of its steps' reads back through its rolling windows, and its plane
// windows' reads behind their writes), and the plane prime (the planes its plane windows' reads look
// back behind their writes) before its first owned plane.  So a producer
// plane window recomputes the rows of its halo inside the block
// (overlapped tiling).  A block writes outputs and combines accumulators
// only at the steps it owns, and each (plane, row) step has exactly one
// owner; it leaves one partial accumulator row per block and kept tile
// in the global scratch, and the last block to finish (an atomic ticket,
// reset by that block for the next launch) folds them in a fixed order.
//
// The row step.  A block walks its (walk, plane, row) steps in one
// sequence.  At step t it waits for its copies of step t's input rows
// (issued at step t - RING), meets the block at one barrier, issues the
// copies of step t + RING's rows, and runs the plan's fused
// steps in phases: one loop over the columns each, a barrier between two
// phases only where a later one reads what an earlier one wrote at
// another thread's column (the emitter's hazard analysis).  A local read
// only at the column of the thread that wrote it lives in a register.
//
// Every window of a block -- rolling rows, locals, accumulators and the
// plane windows of its row tile -- lives in one per-block region: shared
// memory when it fits, else this block's slice of a global scratch.  A
// plane window holds `p_stages` planes of its tile's rows only, addressed
// by a floor-mod slot of the plane and of the row (the tile plus the
// reach of its reads fits in the slots), so contracted planes never go
// to device memory when the region is in shared memory.
//
// Bound: every call streams each input row once and writes each output
// row once, with a handful of flops per element, so it is bound by
// device-memory bytes.  Windows in shared memory make a row read at
// several offsets cost one trip to device memory; the chunks' primed
// steps read again what a neighbouring block reads.  The ring keeps RING
// row steps of input copies in flight behind the compute, so a row step
// does not wait a full memory latency.
//
// Element types.  The inputs, outputs and windows (rolling rows, plane
// windows, the ring's copies) hold the call's element type, float, bf16
// (__nv_bfloat16) or float16 (__half): where the Pallas kernel stores in
// its dtype.  The arithmetic runs in float registers, and the locals that
// live in shared memory, the accumulator rows, their per-block partial
// rows and the device fold stay float: a bf16 or float16 result is
// rounded once, when the folded row is written.  The Pallas kernel keeps
// an accumulator row in its dtype and rounds it at every row's combine,
// so a long sum stagnates (normalization at 4096 x 2048 computed so in
// bf16 is 42 % off the exact value in relative L2, this kernel 0.18 %);
// no kernel whose blocks run in parallel could repeat that order.  A
// 2-byte row that starts or ends between two 4-byte words takes its odd
// element with the element before it or with two bytes of zeros after it
// (cp.async copies 4, 8 or 16 bytes).
#pragma once

#ifdef HFAV_EMULATE
#include "emulate.h"
#else
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#endif
#include <math.h>
#include <stdint.h>

namespace hfav {

// Kernel parameters: the device pointers (inputs, outputs, the global
// scratch, the fold's tickets) and the runtime sizes, both in an order the
// emitter fixes per CallPlan.  The pointers are typed by the inputs' and
// outputs' element type T; the kernel casts the scratch's and tickets'.
template <int NP, int ND, typename T = float>
struct Params {
  T* p[NP];
  long long d[ND];
};

// A float as element type T (bf16 and float16 round to nearest even).
template <typename T>
__device__ __forceinline__ T from_float(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// Floor-mod slot rotation: robust to the negative positions of pipeline
// priming, where C's % would give a negative slot.  32-bit: a block's
// positions are row steps, and the emitter passes constant moduli where
// it can.
__device__ __forceinline__ int slot(int pos, int stages) {
  const int r = pos % stages;
  return r < 0 ? r + stages : r;
}

// The slot after `s` of `n`.
__device__ __forceinline__ int next(int s, int n) { return s + 1 == n ? 0 : s + 1; }

// `v` in [-n, 2n) brought into [0, n).
__device__ __forceinline__ int wrap(int v, int n) {
  return v < 0 ? v + n : (v >= n ? v - n : v);
}

__device__ __forceinline__ long long clamp(long long v, long long lo,
                                           long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Floats a window row of n values takes: room for the row to start at
// its source's address mod 16 bytes.
__host__ __device__ __forceinline__ long long cap4(long long n) {
  return (n + 6) / 4 * 4;
}

// The float offset, mod 4, of a source row: where its window row starts
// past a 16-byte boundary, so the copy's interior goes in 16-byte pieces.
__device__ __forceinline__ int shift4(const float* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The same for rows of a 2-byte type (bf16, float16): 8 elements a
// 16-byte piece.
__host__ __device__ __forceinline__ long long cap8(long long n) {
  return (n + 14) / 8 * 8;
}
template <typename T>
__device__ __forceinline__ int shift8(const T* p) {
  static_assert(sizeof(T) == 2, "a 2-byte element type");
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 1) & 7);
}

#ifdef HFAV_EMULATE
inline void cp_async16(float* dst, const float* src) {
  hfav_cp_async16(dst, src, 16);
}
inline void cp_async4(float* dst, const float* src) {
  hfav_cp_async4(dst, src);
}
inline void cp_async2(void* dst, const void* src) {
  hfav_cp_async(dst, src, 4, 2);
}
inline void commit() { hfav_cp_async_commit(); }
inline void wait_ring_n(int n) { hfav_cp_async_wait(n); }
#else
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes from device to shared memory, through L2 only
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// 4 bytes from device to shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// 2 bytes from device to shared memory and 2 bytes of zeros after them
// (a 4-byte copy that reads 2: both addresses 4-byte aligned)
__device__ __forceinline__ void cp_async2(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(2)
               : "memory");
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are pending
template <int N>
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// the same for a depth known at run time (at most 7)
__device__ __forceinline__ void wait_ring_n(int n) {
  switch (n) {
    case 0: wait_ring<0>(); break;
    case 1: wait_ring<1>(); break;
    case 2: wait_ring<2>(); break;
    case 3: wait_ring<3>(); break;
    case 4: wait_ring<4>(); break;
    case 5: wait_ring<5>(); break;
    case 6: wait_ring<6>(); break;
    default: wait_ring<7>(); break;
  }
}
#endif

// Issue the copy of one row of n values from device memory into a window
// row that starts at the same address mod 16 bytes: 16-byte cp.async for
// the aligned interior, 4-byte for a ragged head and tail, the threads of
// the block striding over the pieces.  A window in the global scratch
// (no shared memory) is copied at once with plain loads and stores.
__device__ __forceinline__ void issue_row(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n, long long use_smem) {
  if (!use_smem) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = __ldg(src + c);
    return;
  }
  const int head = min(n, (4 - shift4(src)) & 3);
  const int body = (n - head) >> 2, tail = (n - head) & 3;
  for (int k = threadIdx.x; k < body; k += blockDim.x)
    cp_async16(dst + head + 4 * k, src + head + 4 * k);
  for (int k = threadIdx.x; k < head + tail; k += blockDim.x) {
    const int c = k < head ? k : head + 4 * body + (k - head);
    cp_async4(dst + c, src + c);
  }
}

// The same for a row of a 2-byte type (bf16, float16), as 4-byte words:
// a row that starts between two words copies the element before it too
// when that lies in the tensor starting at `lo` (into the window row's
// margin), else its first element by a plain load and store, which the
// ring's wait and barrier order as they order the copies; a row that ends
// between two words copies its last element and 2 bytes of zeros (into
// the margin).  No copy reads outside the tensor.
template <typename T>
__device__ __forceinline__ void issue_row(T* __restrict__ dst,
                                          const T* __restrict__ src, int n,
                                          long long use_smem, const T* lo) {
  static_assert(sizeof(T) == 2, "a 2-byte element type");
  if (!use_smem) {
    for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = __ldg(src + c);
    return;
  }
  if (n > 0 && (reinterpret_cast<uintptr_t>(src) & 2)) {
    if (src > lo) {
      --src;
      --dst;
      ++n;
    } else {
      if (threadIdx.x == 0) *dst = *src;
      ++src;
      ++dst;
      --n;
    }
  }
  issue_row(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src),
            n >> 1, use_smem);
  if ((n & 1) && threadIdx.x == blockDim.x - 1)
    cp_async2(dst + n - 1, src + n - 1);
}

// Fill the columns of an n-wide row outside [lo, hi) with v (the
// identity-filled margins of an output row).
template <typename T>
__device__ __forceinline__ void fill_outside(T* __restrict__ row, int n,
                                             int lo, int hi, float v) {
  const T t = from_float<T>(v);
  for (int c = threadIdx.x; c < lo; c += blockDim.x) row[c] = t;
  for (int c = hi + threadIdx.x; c < n; c += blockDim.x) row[c] = t;
}

// Set an n-wide row to v.
__device__ __forceinline__ void fill_row(float* __restrict__ row, int n,
                                         float v) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) row[c] = v;
}

// Zero this block's share of the border rows of a goal array: its ND
// dims (the outer tiles, then the rows) of extents ext, rows of n
// values, the seat [a, b) in each.  The border is cut into disjoint
// slabs (dim k below, then above its seat, the dims before k inside
// theirs, the dims after k whole), its rows numbered slab after slab,
// and a block zeroes rows part, part + parts, ... of them: once each
// over a launch's parts blocks, apart from the row steps.
template <int ND, typename T>
__device__ void zero_border(T* __restrict__ goal, const long long (&ext)[ND],
                            const long long (&a)[ND],
                            const long long (&b)[ND], long long n,
                            long long part, long long parts) {
  const T z = from_float<T>(0.0f);
  long long t = part, first = 0;
  for (int k = 0; k < ND; ++k) {
    for (int above = 0; above < 2; ++above) {
      const long long lo = above ? b[k] : 0, hi = above ? ext[k] : a[k];
      long long rows = hi - lo;
      for (int d = 0; d < ND; ++d)
        if (d != k) rows *= d < k ? b[d] - a[d] : ext[d];
      for (; t < first + rows; t += parts) {
        long long rest = t - first, at = 0, place = 1;
        for (int d = ND - 1; d >= 0; --d) {
          const long long span = d == k ? hi - lo
                                 : d < k ? b[d] - a[d] : ext[d];
          const long long off = d == k ? lo : d < k ? a[d] : 0;
          at += (off + rest % span) * place;
          rest /= span;
          place *= ext[d];
        }
        T* const row = goal + at * n;
        for (long long c = threadIdx.x; c < n; c += blockDim.x) row[c] = z;
      }
      first += rows;
    }
  }
}

// The steps one block walks for chunk `chunk` of length `len` of a range
// of `steps`: [first, end), of which it owns [own, end).  `first` lies
// `prime` steps before `own` (clamped to the range start), which refills
// every window before the first owned step.
struct Chunk {
  long long first, own, end;
};

__device__ __forceinline__ Chunk chunk_of(long long chunk, long long len,
                                          long long steps,
                                          long long prime) {
  Chunk c;
  c.own = chunk * len;
  c.end = c.own + len < steps ? c.own + len : steps;
  c.first = c.own - prime > 0 ? c.own - prime : 0;
  return c;
}

// A position in a block's walk: step t of the sequence, the walk index
// (over the outer dims the block walks whole), the plane and the row
// within the block's plane chunk and row chunk.
struct Cursor {
  int t, sq, pi, ji;

  __device__ __forceinline__ void advance(int nrows, int nplanes) {
    ++t;
    if (++ji == nrows) {
      ji = 0;
      if (++pi == nplanes) {
        pi = 0;
        ++sq;
      }
    }
  }
};

// The value at position `pos` after `levels` (at most L) halvings of the
// `n` rows at `src` (`ld` floats apart, `src` at the column), halving as
// lane_reduce does: pairs (i, i + half) with half = ceil(m / 2) of a
// level's length m, a missing partner the identity.  Its 2^levels loads
// do not depend on each other.
template <int L, typename Fn>
__device__ __forceinline__ float fold_tree(const float* __restrict__ src,
                                           long long ld, int n, int levels,
                                           int pos, float ident, Fn fn) {
  if constexpr (L == 0) {
    return __ldcg(src + pos * ld);
  } else {
    if (levels == 0) return __ldcg(src + pos * ld);
    int m = n;  // the length of the level below the top
    for (int l = 1; l < levels; ++l) m = (m + 1) / 2;
    const int half = (m + 1) / 2;
    const float a = fold_tree<L - 1>(src, ld, n, levels - 1, pos, ident, fn);
    return fn(a, pos + half < m ? fold_tree<L - 1>(src, ld, n, levels - 1,
                                                   pos + half, ident, fn)
                                : ident);
  }
}

// Fold `n` rows of `w` floats (row i at src + i * ld) into the row `out`
// (of element type O: the one rounding of a bf16 accumulator) in
// lane_reduce's order, four levels a pass: each (position, column)
// item of a pass is a thread's, combining up to 16 rows; the passes
// between write `tmp` (ceil(n / 16) + ceil(n / 256) rows, in turn; none
// for n <= 16).  Run by one whole block (no inlining: its registers stay
// out of the row step's).
template <typename Fn, typename O>
__device__ __noinline__ void fold_rows(const float* src, long long ld, int n,
                                       float* tmp, O* out, int w,
                                       float ident, Fn fn) {
  float* const bufs[2] = {tmp, tmp + ((n + 15) / 16) * w};
  int b = 0;
  while (true) {
    int levels = 0, m = n;
    while (m > 1 && levels < 4) {
      m = (m + 1) / 2;
      ++levels;
    }
    for (int it = threadIdx.x; it < m * w; it += blockDim.x) {
      const int c = it % w, pos = it / w;
      const float v = fold_tree<4>(src + c, ld, n, levels, pos, ident, fn);
      if (m == 1)
        out[c] = from_float<O>(v);
      else
        bufs[b][static_cast<long long>(pos) * w + c] = v;
    }
    __syncthreads();
    if (m == 1) return;
    src = bufs[b];
    ld = w;
    n = m;
    b ^= 1;
  }
}

// Whether this block is the last of `nblocks` to get here: every thread
// fences its writes, the block meets, one thread takes a ticket; the last
// block resets the ticket for the next launch.
__device__ __forceinline__ bool last_block(unsigned* ticket,
                                           long long nblocks) {
  __threadfence();
  __syncthreads();
  bool last = false;
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == static_cast<unsigned>(nblocks - 1);
  if (!__syncthreads_or(last)) return false;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0;
  return true;
}

// The region of per-block scratch: shared memory when the block's
// windows fit there, else this block's slice of the global scratch.
__device__ __forceinline__ float* fast_scratch(float* smem, float* gscratch,
                                               long long use_smem,
                                               long long per_block) {
  return use_smem ? smem : gscratch + (long long)blockIdx.x * per_block;
}

// The same for block `blk` of an example of a batched launch (the
// example's own global scratch).
__device__ __forceinline__ float* fast_scratch(float* smem, float* gscratch,
                                               long long use_smem,
                                               long long per_block,
                                               long long blk) {
  return use_smem ? smem : gscratch + blk * per_block;
}

// A batched launch runs the blocks of a single call once for each
// example, example by example (the outermost factor of the grid).  Its
// parameters are a single call's but for the pointers: each of the NI
// inputs' points at that input's row of a table of addresses, one an
// example, so an example's inputs stay wherever its caller holds them;
// each of the others (outputs, scratch, tickets: the launch's own)
// points at the first example's, and its bytes from one example to the
// next follow the size parameters.  This gives example `ex`'s: every
// input, output, scratch and ticket of a single call on that example.
template <int ND, int NI, int NP, int NB, typename T>
__device__ __forceinline__ Params<NP, ND, T> example(
    const Params<NP, NB, T>& batch, long long ex) {
  static_assert(NB == ND + NP - NI, "one stride a pointer of the launch");
  Params<NP, ND, T> e;
  for (int i = 0; i < NI; ++i)
    e.p[i] = reinterpret_cast<T* const*>(batch.p[i])[ex];
  for (int i = NI; i < NP; ++i)
    e.p[i] = reinterpret_cast<T*>(reinterpret_cast<char*>(batch.p[i]) +
                                  ex * batch.d[ND + i - NI]);
  for (int i = 0; i < ND; ++i) e.d[i] = batch.d[i];
  return e;
}

// Launch one emitted kernel: sets the dynamic shared-memory limit when a
// launch needs more than the default 48 KB, launches on the caller's
// stream, and returns cudaGetLastError() (0 when the launch was taken).
template <int NP, int ND, typename T>
int launch(void (*kernel)(Params<NP, ND, T>), void** ptrs,
           const long long* ints, long long nblocks, int threads,
           long long smem_bytes, void* stream) {
  Params<NP, ND, T> prm;
  for (int i = 0; i < NP; ++i) prm.p[i] = static_cast<T*>(ptrs[i]);
  for (int i = 0; i < ND; ++i) prm.d[i] = ints[i];
#ifdef HFAV_EMULATE
  return emulate_launch(kernel, prm, nblocks, threads, smem_bytes);
#else
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<static_cast<unsigned>(nblocks), threads,
           static_cast<size_t>(smem_bytes),
           static_cast<cudaStream_t>(stream)>>>(prm);
  return static_cast<int>(cudaGetLastError());
#endif
}

// Blocks of `threads` threads and `smem_bytes` of dynamic shared memory
// that one SM holds of the built kernel
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor; the emulation answers
// from its model), or minus the error code.
template <typename Kernel>
int occupancy(Kernel kernel, int threads, long long smem_bytes) {
#ifdef HFAV_EMULATE
  (void)kernel;
  return emulate_occupancy(threads, smem_bytes);
#else
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes));
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel, threads, static_cast<size_t>(smem_bytes));
  return e == cudaSuccess ? n : -static_cast<int>(e);
#endif
}

// The built kernel's registers a thread and local memory a thread
// (spills and stack, bytes) in `out` (cudaFuncGetAttributes); 0, or
// minus the error code.  The emulation answers from its occupancy
// model: 64 registers, no local memory.
template <typename Kernel>
int attrs(Kernel kernel, long long* out) {
#ifdef HFAV_EMULATE
  (void)kernel;
  out[0] = 64;
  out[1] = 0;
  return 0;
#else
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return -static_cast<int>(e);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  return 0;
#endif
}

}  // namespace hfav

// The emulation's block order (emulate.h), set by the tests.
#ifdef HFAV_EMULATE
#define HFAV_EMULATE_ENTRY_POINTS                                          \
  extern "C" void hfav_emulate_block_stride(long long s) {                 \
    hfav_block_stride = s;                                                 \
  }
#else
#define HFAV_EMULATE_ENTRY_POINTS
#endif

// The entry points every emitted source defines through this macro.
#define HFAV_ENTRY_POINTS(KERNEL, NP, ND)                                  \
  HFAV_EMULATE_ENTRY_POINTS                                                \
  extern "C" int hfav_launch(void** ptrs, const long long* ints,          \
                             long long nblocks, int threads,              \
                             long long smem_bytes, void* stream) {        \
    return hfav::launch<NP, ND>(KERNEL, ptrs, ints, nblocks, threads,     \
                                smem_bytes, stream);                      \
  }                                                                       \
  extern "C" int hfav_occupancy(int threads, long long smem_bytes) {       \
    return hfav::occupancy(KERNEL, threads, smem_bytes);                  \
  }                                                                       \
  extern "C" int hfav_attrs(long long* out) {                             \
    return hfav::attrs(KERNEL, out);                                      \
  }                                                                       \
  extern "C" const char* hfav_error_string(int e) {                       \
    return cudaGetErrorString(static_cast<cudaError_t>(e));               \
  }
