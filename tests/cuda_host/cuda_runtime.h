// A host stand-in for the CUDA runtime, so that the tests can compile a
// kernel source of ceno_tpu_torch/csrc with a C++ compiler and run it on the
// CPU (tests/test_torch_sumcheck_kernels.py). A launch runs its blocks one
// after the other, each block's threads as std::threads, __syncthreads as a
// std::barrier and __shared__ arrays as statics (one block at a time shares
// them). Enough for csrc/sumcheck.cu, which has no warp shuffles; kernel
// launches (kernel<<<grid, block, smem, stream>>>(args)) are rewritten by
// the test into run_kernel(Launch(grid, block, smem, stream), kernel, args).
#pragma once
#include <algorithm>
#include <barrier>
#include <cstddef>
#include <cstdint>
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
template <class T> inline T __ldg(const T* p) { return *p; }

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
