// A host stand-in for the CUDA runtime, so that the tests can compile a
// kernel source of ceno_tpu_torch/csrc with a C++ compiler and run it on the
// CPU (tests/test_torch_sumcheck_kernels.py, tests/test_torch_gl_device.py).
// A launch runs its blocks one after the other, each block's threads as
// std::threads, __syncthreads as a std::barrier and __shared__ arrays as
// statics (one block at a time shares them). The warp functions
// (__shfl_sync, __shfl_xor_sync, __syncwarp) hold for a block of one warp,
// as csrc/sumcheck.cu's duplex launches: each lane puts its value into a
// static slot, the block's barrier, each lane reads its source's slot, the
// barrier again. So every lane must reach every shuffle, as on the card.
// Kernel launches (kernel<<<grid, block, smem, stream>>>(args)) are
// rewritten by the test into
// run_kernel(Launch(grid, block, smem, stream), kernel, args).
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }

inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;
inline std::barrier<>* g_barrier = nullptr;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
inline uint32_t min(uint32_t a, uint32_t b) { return std::min(a, b); }
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
inline uint64_t __umul64hi(uint64_t a, uint64_t b) {
  return (uint64_t)(((unsigned __int128)a * b) >> 64);
}
inline uint32_t __brev(uint32_t x) {
  uint32_t r = 0;
  for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
  return r;
}
template <class T> inline T __ldg(const T* p) { return *p; }

// A block of one warp: lane = threadIdx.x < 32.
inline uint32_t g_warp_slots[32];

inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }

inline uint32_t warp_exchange(uint32_t v, unsigned src) {
  if (blockDim.x > 32) std::abort();  // the stand-in's shuffles take one warp
  g_warp_slots[threadIdx.x] = v;
  __syncthreads();
  uint32_t r = g_warp_slots[src];
  __syncthreads();
  return r;
}

// CUDA: the source lane is srcLane mod width within the caller's segment
// of width lanes.
inline uint32_t __shfl_sync(unsigned, uint32_t v, int src, int width = 32) {
  const unsigned seg = threadIdx.x & ~static_cast<unsigned>(width - 1);
  return warp_exchange(v, seg + (static_cast<unsigned>(src) & (width - 1)));
}

// CUDA: lane ^ laneMask; a source past the caller's segment gives the
// caller's own value.
inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int lane_mask, int width = 32) {
  const unsigned seg = threadIdx.x & ~static_cast<unsigned>(width - 1);
  const unsigned src = threadIdx.x ^ static_cast<unsigned>(lane_mask);
  return warp_exchange(v, src >= seg + width ? threadIdx.x : src);
}

struct Launch {
  dim3 grid, block;
  Launch(dim3 g, dim3 b, size_t = 0, void* = nullptr) : grid(g), block(b) {}
};

template <class F, class... A>
void run_kernel(Launch L, F f, A... args) {
  gridDim = L.grid;
  blockDim = L.block;
  for (unsigned by = 0; by < L.grid.y; ++by)
    for (unsigned bx = 0; bx < L.grid.x; ++bx) {
      std::barrier<> bar(L.block.x);
      g_barrier = &bar;
      std::vector<std::thread> ts;
      for (unsigned t = 0; t < L.block.x; ++t)
        ts.emplace_back([=]() {
          threadIdx = dim3(t, 0, 0);
          blockIdx = dim3(bx, by, 0);
          f(args...);
        });
      for (auto& th : ts) th.join();
    }
}
