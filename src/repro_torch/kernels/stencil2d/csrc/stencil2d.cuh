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
//   * row streaming into shared or global windows,
//   * predicated row seats and output rows,
//   * the block, chunk and ownership logic of the decomposition.
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
// owned step: `prime` rows before its first owned row (the rows its
// rolling windows, and its plane windows' reads behind their writes, look
// back), and the plane prime (the planes its plane windows' reads look
// back behind their writes) before its first owned plane.  So a producer
// plane window recomputes the rows of its halo inside the block
// (overlapped tiling).  A block writes outputs and combines accumulators
// only at the steps it owns, and each (plane, row) step has exactly one
// owner; it leaves one partial accumulator row per block and kept tile,
// which the host folds in block order.
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
// steps read again what a neighbouring block reads.
#pragma once

#ifdef HFAV_EMULATE
#include "emulate.h"
#else
#include <cuda_runtime.h>
#endif
#include <math.h>

namespace hfav {

// Kernel parameters: the device pointers (inputs, outputs, the global
// scratch) and the runtime sizes, both in an order the emitter fixes per
// CallPlan.
template <int NP, int ND>
struct Params {
  float* p[NP];
  long long d[ND];
};

// Floor-mod slot rotation: robust to the negative positions of pipeline
// priming, where C's % would give a negative slot.
__device__ __forceinline__ long long slot(long long pos, long long stages) {
  const long long r = pos % stages;
  return r < 0 ? r + stages : r;
}

__device__ __forceinline__ long long clamp(long long v, long long lo,
                                           long long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Copy one row of n values from device memory into a window row; the
// threads of the block stride over the columns.
__device__ __forceinline__ void stream_row(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int n) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) dst[c] = __ldg(src + c);
}

// Fill the columns of an n-wide row outside [lo, hi) with v (the
// identity-filled margins of an output row).
__device__ __forceinline__ void fill_outside(float* __restrict__ row, int n,
                                             int lo, int hi, float v) {
  for (int c = threadIdx.x; c < lo; c += blockDim.x) row[c] = v;
  for (int c = hi + threadIdx.x; c < n; c += blockDim.x) row[c] = v;
}

// Set an n-wide row to v.
__device__ __forceinline__ void fill_row(float* __restrict__ row, int n,
                                         float v) {
  for (int c = threadIdx.x; c < n; c += blockDim.x) row[c] = v;
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

// The region of per-block scratch: shared memory when the block's
// windows fit there, else this block's slice of the global scratch.
__device__ __forceinline__ float* fast_scratch(float* smem, float* gscratch,
                                               long long use_smem,
                                               long long per_block) {
  return use_smem ? smem : gscratch + (long long)blockIdx.x * per_block;
}

// Launch one emitted kernel: sets the dynamic shared-memory limit when a
// launch needs more than the default 48 KB, launches on the caller's
// stream, and returns cudaGetLastError() (0 when the launch was taken).
template <int NP, int ND, typename Kernel>
int launch(Kernel kernel, void** ptrs, const long long* ints,
           long long nblocks, int threads, long long smem_bytes,
           void* stream) {
  Params<NP, ND> prm;
  for (int i = 0; i < NP; ++i) prm.p[i] = static_cast<float*>(ptrs[i]);
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

}  // namespace hfav

// The entry points every emitted source defines through this macro.
#define HFAV_ENTRY_POINTS(KERNEL, NP, ND)                                  \
  extern "C" int hfav_launch(void** ptrs, const long long* ints,          \
                             long long nblocks, int threads,              \
                             long long smem_bytes, void* stream) {        \
    return hfav::launch<NP, ND>(KERNEL, ptrs, ints, nblocks, threads,     \
                                smem_bytes, stream);                      \
  }                                                                       \
  extern "C" const char* hfav_error_string(int e) {                       \
    return cudaGetErrorString(static_cast<cudaError_t>(e));               \
  }
