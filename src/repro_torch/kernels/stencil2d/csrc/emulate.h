// Host emulation of the CUDA constructs the port's kernels use (the
// stencil kernels of stencil2d.cuh, flash attention, flash decode and the
// SSD scan), so the kernels' index, slot, chunk, tile, fragment and
// ownership logic can be compiled with a host C++ compiler (g++
// -std=c++20 -DHFAV_EMULATE) and tested on a machine without a GPU.
// Blocks run one after another (block 0 first, or in the order of a
// stride set by the test: hfav_block_stride); the threads of a block are host threads
// that meet at a std::barrier in __syncthreads(), so a missing barrier
// shows up as a wrong result, and each block's shared memory starts as
// NaNs, so does a read of a word no thread of the block wrote.  Never
// used for a GPU build.
//
// Warps.  Threads 32w .. 32w + 31 of a block form warp w, with a barrier
// of its own (__syncwarp) and one exchange slot per lane.  A warp
// collective -- __shfl_xor_sync, ldmatrix (x4, plain or .trans), mma.sync
// m16n8k16 bf16 and f16 and m16n8k8 tf32 -- writes each lane's operand to
// its slot, meets the warp at its barrier, reads what it needs from the other
// lanes' slots, and meets it again before any slot is reused; the operands go
// in and come out in the fragment layouts of the PTX ISA, so a kernel's
// fragment indexing is tested as written.
//
// cp.async is deferred, as on the card: a copy (16 or 4 bytes, zero-filled
// past the source size) fills its destination with NaNs when
// it is issued -- the bytes are in flight and undefined -- and is queued
// in the thread's open group; commit closes the group, and wait_group N
// performs the thread's oldest groups until at most N are pending.  So a
// read before the wait that retires its copy, or a copy into a slot that
// some thread still reads, shows as a NaN in the result.  A block's
// copies still pending when it ends are dropped.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstring>
#include <deque>
#include <iterator>
#include <numeric>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __shared__
#define __launch_bounds__(...)
#define __align__(n)

typedef void* cudaStream_t;

using std::max;
using std::min;

struct hfav_dim {
  unsigned x;
};
inline thread_local hfav_dim threadIdx;
inline hfav_dim blockIdx;
inline hfav_dim blockDim;
inline std::barrier<>* hfav_block_barrier = nullptr;
// Blocks of a launch of n run in the order b * stride mod n (the stride
// moved up to the next one prime to n): 1 runs them in order, another
// interleaves them, as the card may, so that a block that waits for no
// other to finish, but must, shows.
inline long long hfav_block_stride = 1;
// the block's dynamic shared memory (the emitted kernels declare it
// `extern __shared__ float hfav_smem[]`)
alignas(16) float hfav_smem[232448 / sizeof(float)];
// the NaN that fills what is undefined: a float NaN whose two halves are
// bf16 and float16 NaNs too, so a 16-bit element read before it is
// written shows
inline constexpr unsigned hfav_nan_bits = 0x7fc07fc0u;

inline void __syncthreads() { hfav_block_barrier->arrive_and_wait(); }

// __syncthreads_or: a barrier that returns whether any thread of the
// block passed a non-zero predicate.
inline std::atomic<int> hfav_block_or{0};

inline int __syncthreads_or(int pred) {
  if (pred) hfav_block_or.store(1);
  __syncthreads();
  const int any = hfav_block_or.load();
  __syncthreads();
  if (threadIdx.x == 0) hfav_block_or.store(0);
  __syncthreads();
  return any;
}

inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}

template <typename T>
inline T __ldcg(const T* p) {
  return *p;
}

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __int_as_float(unsigned v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}

inline float __uint_as_float(unsigned v) { return __int_as_float(v); }

struct alignas(16) uint4 {
  unsigned x, y, z, w;
};

// bfloat16 as the card stores it (16 bits: the high half of a float),
// with the conversions of cuda_bf16.h; float -> bf16 rounds to nearest
// even (an overflow to Inf, Inf and NaN kept).
struct __nv_bfloat16 {
  unsigned short x;
};

inline float __bfloat162float(__nv_bfloat16 h) {
  const unsigned u = static_cast<unsigned>(h.x) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u)  // NaN stays a quiet NaN
    return {static_cast<unsigned short>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) { return __float2bfloat16(f); }

// float16 as the card stores it (1 sign, 5 exponent and 10 mantissa
// bits), with the conversions of cuda_fp16.h: float -> half rounds to
// nearest even, to a subnormal below 2^-14 and to Inf past 65504 (from
// 65520 on); NaN stays a quiet NaN.
struct __half {
  unsigned short x;
};

inline float __half2float(__half h) {
  const unsigned s = static_cast<unsigned>(h.x & 0x8000u) << 16;
  const unsigned e = (h.x >> 10) & 0x1fu, m = h.x & 0x3ffu;
  if (e == 0) {  // zero or subnormal: m 2^-24, exact in float
    float f = static_cast<float>(m) * 0x1p-24f;
    unsigned u;
    std::memcpy(&u, &f, sizeof u);
    return __uint_as_float(u | s);
  }
  if (e == 0x1f) return __uint_as_float(s | 0x7f800000u | (m << 13));
  return __uint_as_float(s | ((e + 112) << 23) | (m << 13));
}

inline __half __float2half_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  const unsigned s = (u >> 16) & 0x8000u, a = u & 0x7fffffffu;
  auto half = [s](unsigned v) {
    return __half{static_cast<unsigned short>(s | v)};
  };
  if (a > 0x7f800000u) return half(0x7e00u | (a >> 13));  // NaN
  if (a >= 0x477ff000u) return half(0x7c00u);              // Inf
  if (a < 0x38800000u) {  // below 2^-14: a subnormal (or zero) of 2^-24
    const unsigned e = a >> 23;
    if (e < 102) return half(0);  // below 2^-25: rounds to zero
    const unsigned m = (a & 0x7fffffu) | 0x800000u, sh = 126 - e;
    unsigned r = m >> sh;
    const unsigned rem = m & ((1u << sh) - 1), mid = 1u << (sh - 1);
    if (rem > mid || (rem == mid && (r & 1u))) ++r;
    return half(r);
  }
  unsigned r = (a >> 13) - (112u << 10);
  const unsigned rem = a & 0x1fffu;
  if (rem > 0x1000u || (rem == 0x1000u && (r & 1u))) ++r;
  return half(r);
}

inline __half __float2half(float f) { return __float2half_rn(f); }

inline const char* cudaGetErrorString(int) { return "emulated launch"; }
#define cudaError_t int

// ---- warps -------------------------------------------------------------
struct hfav_slot {
  alignas(16) unsigned char bytes[32];
};
inline std::deque<std::barrier<>>* hfav_warp_barriers = nullptr;
inline hfav_slot* hfav_slots = nullptr;  // one per thread of the block

inline unsigned hfav_lane() { return threadIdx.x % 32; }

inline void __syncwarp(unsigned = 0xffffffffu) {
  (*hfav_warp_barriers)[threadIdx.x / 32].arrive_and_wait();
}

// Publish `n` bytes of this lane's operand, and meet the warp.
inline void hfav_publish(const void* src, std::size_t n) {
  std::memcpy(hfav_slots[threadIdx.x].bytes, src, n);
  __syncwarp();
}

// The slot of lane `l` of this thread's warp.
inline const unsigned char* hfav_peer(unsigned l) {
  return hfav_slots[threadIdx.x - hfav_lane() + l].bytes;
}

template <typename T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) <= sizeof(hfav_slot::bytes));
  hfav_publish(&v, sizeof v);
  T out;
  std::memcpy(&out, hfav_peer(hfav_lane() ^ static_cast<unsigned>(lane_mask)),
              sizeof out);
  __syncwarp();
  return out;
}

// ldmatrix.sync.aligned.m8n8.x4(.trans).shared.b16: lanes 8i .. 8i + 7
// give the row addresses of 8 x 8 matrix i (16 bytes a row); register i
// of lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of
// matrix i, or with .trans rows 2 (l % 4) and 2 (l % 4) + 1 of column
// l / 4 (the first element in the low half).
inline void hfav_ldmatrix_x4(unsigned r[4], const void* row, bool trans) {
  hfav_publish(&row, sizeof row);
  const unsigned lane = hfav_lane();
  auto addr = [](unsigned l) {
    const unsigned char* a;
    std::memcpy(&a, hfav_peer(l), sizeof a);
    return a;
  };
  for (unsigned i = 0; i < 4; ++i) {
    if (!trans) {
      std::memcpy(&r[i], addr(8 * i + lane / 4) + 4 * (lane % 4), 4);
    } else {
      unsigned short lo, hi;
      std::memcpy(&lo, addr(8 * i + 2 * (lane % 4)) + 2 * (lane / 4), 2);
      std::memcpy(&hi, addr(8 * i + 2 * (lane % 4) + 1) + 2 * (lane / 4), 2);
      r[i] = lo | static_cast<unsigned>(hi) << 16;
    }
  }
  __syncwarp();
}

// mma.sync.aligned.m16n8k16.row.col.f32.{bf16,f16}.{bf16,f16}.f32:
// d = A B + c with A 16 x 16, B 16 x 8, 16-bit pairs packed low element
// first, each element read by `value` (bf16 or float16 to float).  Lane
// l, with g = l / 4 and t = l % 4, holds A rows g and g + 8 at columns
// 2t, 2t + 1 (registers 0, 1) and 2t + 8, 2t + 9 (registers 2, 3); B
// rows 2t, 2t + 1 (register 0) and 2t + 8, 2t + 9 (register 1) of column
// g; and c, d at rows g (0, 1) and g + 8 (2, 3), columns 2t and 2t + 1.
// Products are exact in float32; the sum is taken in k order after c.
template <typename Value>
inline void hfav_mma_m16n8k16(float d[4], const unsigned a[4],
                              const unsigned b[2], const float c[4],
                              Value value) {
  unsigned ops[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  hfav_publish(ops, sizeof ops);
  auto lo = [&](unsigned w) { return value(w & 0xffffu); };
  auto hi = [&](unsigned w) { return value(w >> 16); };
  float A[16][16], B[16][8];
  for (unsigned l = 0; l < 32; ++l) {
    unsigned o[6];
    std::memcpy(o, hfav_peer(l), sizeof o);
    const unsigned g = l / 4, t = l % 4;
    for (unsigned h = 0; h < 2; ++h) {  // column halves of A, row halves of B
      A[g][2 * t + 8 * h] = lo(o[2 * h]);
      A[g][2 * t + 8 * h + 1] = hi(o[2 * h]);
      A[g + 8][2 * t + 8 * h] = lo(o[2 * h + 1]);
      A[g + 8][2 * t + 8 * h + 1] = hi(o[2 * h + 1]);
      B[2 * t + 8 * h][g] = lo(o[4 + h]);
      B[2 * t + 8 * h + 1][g] = hi(o[4 + h]);
    }
  }
  __syncwarp();
  const unsigned g = hfav_lane() / 4, t = hfav_lane() % 4;
  for (unsigned e = 0; e < 4; ++e) {
    const unsigned row = g + 8 * (e / 2), col = 2 * t + e % 2;
    float s = c[e];
    for (unsigned k = 0; k < 16; ++k) s += A[row][k] * B[k][col];
    d[e] = s;
  }
}

inline void hfav_mma_bf16(float d[4], const unsigned a[4], const unsigned b[2],
                          const float c[4]) {
  hfav_mma_m16n8k16(d, a, b, c, [](unsigned v) {
    return __bfloat162float({static_cast<unsigned short>(v)});
  });
}

inline void hfav_mma_f16(float d[4], const unsigned a[4], const unsigned b[2],
                         const float c[4]) {
  hfav_mma_m16n8k16(d, a, b, c, [](unsigned v) {
    return __half2float({static_cast<unsigned short>(v)});
  });
}

// cvt.rna.tf32.f32: round to TF32 (10 explicit mantissa bits) to nearest,
// ties away from zero; the result is a float32 bit pattern whose low 13
// bits are zero.
inline unsigned hfav_tf32(float v) {
  unsigned u;
  std::memcpy(&u, &v, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) return u;  // NaN stays NaN
  return (u + 0x1000u) & 0xffffe000u;
}

// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: d = A B + c with
// A 16 x 8, B 8 x 8, operands float32 bit patterns of which the tensor
// core reads the TF32 part (the low 13 bits are ignored).  Lane l, with
// g = l / 4 and t = l % 4, holds A rows g (registers 0, 2) and g + 8 (1,
// 3) at columns t (0, 1) and t + 4 (2, 3); B rows t (register 0) and
// t + 4 (1) of column g; and c, d as for the bf16 product.  Products of
// two TF32 values are exact in float32; the sum is taken in k order
// after c.
inline void hfav_mma_tf32(float d[4], const unsigned a[4], const unsigned b[2],
                          const float c[4]) {
  unsigned ops[6] = {a[0], a[1], a[2], a[3], b[0], b[1]};
  hfav_publish(ops, sizeof ops);
  auto tf = [](unsigned w) { return __uint_as_float(w & 0xffffe000u); };
  float A[16][8], B[8][8];
  for (unsigned l = 0; l < 32; ++l) {
    unsigned o[6];
    std::memcpy(o, hfav_peer(l), sizeof o);
    const unsigned g = l / 4, t = l % 4;
    A[g][t] = tf(o[0]);
    A[g + 8][t] = tf(o[1]);
    A[g][t + 4] = tf(o[2]);
    A[g + 8][t + 4] = tf(o[3]);
    B[t][g] = tf(o[4]);
    B[t + 4][g] = tf(o[5]);
  }
  __syncwarp();
  const unsigned g = hfav_lane() / 4, t = hfav_lane() % 4;
  for (unsigned e = 0; e < 4; ++e) {
    const unsigned row = g + 8 * (e / 2), col = 2 * t + e % 2;
    float s = c[e];
    for (unsigned k = 0; k < 8; ++k) s += A[row][k] * B[k][col];
    d[e] = s;
  }
}

// ---- cp.async ----------------------------------------------------------
struct hfav_copy {
  void* dst;
  const void* src;
  int bytes, src_bytes;
};
inline thread_local std::vector<hfav_copy> hfav_open_group;
inline thread_local std::deque<std::vector<hfav_copy>> hfav_groups;

inline void hfav_cp_async(void* dst, const void* src, int bytes,
                          int src_bytes) {
  for (int b = 0; b < bytes; b += 4)
    std::memcpy(static_cast<char*>(dst) + b, &hfav_nan_bits, 4);
  hfav_open_group.push_back({dst, src, bytes, src_bytes});
}

// cp.async.cg.shared.global, 16 bytes, the rest zero past `src_bytes`
inline void hfav_cp_async16(void* dst, const void* src, int src_bytes) {
  hfav_cp_async(dst, src, 16, src_bytes);
}

// cp.async.ca.shared.global, 4 bytes
inline void hfav_cp_async4(void* dst, const void* src) {
  hfav_cp_async(dst, src, 4, 4);
}

// cp.async.commit_group
inline void hfav_cp_async_commit() {
  hfav_groups.push_back(std::move(hfav_open_group));
  hfav_open_group.clear();
}

// cp.async.wait_group n: perform the oldest groups until n are pending
inline void hfav_cp_async_wait(int n) {
  while (static_cast<int>(hfav_groups.size()) > n) {
    for (const hfav_copy& c : hfav_groups.front()) {
      std::memset(c.dst, 0, c.bytes);
      const int n_src = c.src_bytes < c.bytes ? c.src_bytes : c.bytes;
      if (n_src > 0) std::memcpy(c.dst, c.src, n_src);
    }
    hfav_groups.pop_front();
  }
}

// The occupancy model of a build without a card: blocks an SM holds by
// threads (2048), blocks (32), registers (65536 at 64 a thread, the
// bound of __launch_bounds__(1024)) and shared memory (233472 bytes,
// 1024 of them reserved per block).
inline int emulate_occupancy(int threads, long long smem_bytes) {
  int n = std::min({2048 / threads, 32, 65536 / (threads * 64)});
  if (smem_bytes > 0)
    n = std::min(n, static_cast<int>(233472 / (smem_bytes + 1024)));
  return n;
}

template <typename Kernel, typename Params>
int emulate_launch(Kernel kernel, const Params& prm, long long nblocks,
                   int threads, long long smem_bytes) {
  if (smem_bytes > static_cast<long long>(sizeof hfav_smem)) return 1;
  blockDim.x = static_cast<unsigned>(threads);
  std::vector<hfav_slot> slots(threads);
  hfav_slots = slots.data();
  long long stride = hfav_block_stride;
  while (nblocks > 0 && std::gcd(stride, nblocks) != 1) ++stride;
  for (long long b = 0; b < nblocks; ++b) {
    blockIdx.x = static_cast<unsigned>(b * stride % nblocks);
    // a block finds no value of an earlier block in shared memory: every
    // word starts as a NaN, so a read before a write shows in the result
    std::fill(std::begin(hfav_smem), std::end(hfav_smem),
              __int_as_float(hfav_nan_bits));
    std::barrier<> bar(threads);
    hfav_block_barrier = &bar;
    std::deque<std::barrier<>> warps;
    for (int w = 0; w < threads; w += 32)
      warps.emplace_back(threads - w < 32 ? threads - w : 32);
    hfav_warp_barriers = &warps;
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([&, t] {
        threadIdx.x = static_cast<unsigned>(t);
        kernel(prm);
      });
    for (auto& th : pool) th.join();
  }
  return 0;
}
