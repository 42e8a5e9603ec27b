// Host emulation of the CUDA constructs the port's kernels use (the
// stencil kernels of stencil2d.cuh, flash attention and flash decode),
// so the kernels' index, slot, chunk, tile and ownership logic can be
// compiled with a host C++ compiler (g++ -std=c++20
// -DHFAV_EMULATE) and tested on a machine without a GPU.  Blocks run one
// after another; the threads of a block are host threads that meet at
// a std::barrier in __syncthreads(), so a missing barrier shows up as a
// wrong result.  Never used for a GPU build.
#pragma once

#include <barrier>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__
#define __launch_bounds__(n)

typedef void* cudaStream_t;

struct hfav_dim {
  unsigned x;
};
inline thread_local hfav_dim threadIdx;
inline hfav_dim blockIdx;
inline hfav_dim blockDim;
inline std::barrier<>* hfav_block_barrier = nullptr;
// the block's dynamic shared memory (the emitted kernels declare it
// `extern __shared__ float hfav_smem[]`)
float hfav_smem[232448 / sizeof(float)];

inline void __syncthreads() { hfav_block_barrier->arrive_and_wait(); }

template <typename T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __int_as_float(unsigned v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}

// bfloat16 as the card stores it (the high half of a float), with the
// conversions of cuda_bf16.h; float -> bf16 rounds to nearest even.
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

inline const char* cudaGetErrorString(int) { return "emulated launch"; }
#define cudaError_t int

template <typename Kernel, typename Params>
int emulate_launch(Kernel kernel, const Params& prm, long long nblocks,
                   int threads, long long smem_bytes) {
  if (smem_bytes > static_cast<long long>(sizeof hfav_smem)) return 1;
  blockDim.x = static_cast<unsigned>(threads);
  for (long long b = 0; b < nblocks; ++b) {
    blockIdx.x = static_cast<unsigned>(b);
    std::barrier<> bar(threads);
    hfav_block_barrier = &bar;
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
