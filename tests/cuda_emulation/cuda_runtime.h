// Stand-in for <cuda_runtime.h> that lets a host C++ compiler build a CUDA
// source of the port and run its kernels on the CPU: one block at a time,
// one host thread per CUDA thread, a pthread barrier for __syncthreads().
// tests/test_torch_emulated.py rewrites the few constructs a host compiler
// cannot parse (the <<<...>>> launch, the cp.async inline assembly, the
// extern __shared__ array) and includes this file in place of the real one.
// With -ffp-contract=off the float arithmetic rounds as the card's does
// under --fmad=false, so a kernel can be held bitwise to its plain version.
#pragma once
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <pthread.h>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n)
#define __ldg(p) (*(p))

struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
static thread_local emu_dim3 threadIdx, blockIdx;
static emu_dim3 blockDim, gridDim;
alignas(16) static float emu_smem[1 << 18];         // 1 MiB: more than a block may ask for
static pthread_barrier_t emu_barrier;
inline void __syncthreads() { pthread_barrier_wait(&emu_barrier); }
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0;
const int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
const int cudaFuncAttributePreferredSharedMemoryCarveout = 9;
const int cudaDevAttrMultiProcessorCount = 16;
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* device) { *device = 0; return 0; }
// two "SMs", so that a persistent grid walks its grid-stride loop
inline int cudaDeviceGetAttribute(int* value, int, int) { *value = 2; return 0; }

// Runs `blocks` blocks of `threads` threads one after the other.  Shared
// memory is filled with NaNs before each block, so that a read of a value
// that was never written shows in the result.
template <class F, class... A>
void emu_launch(F kernel, unsigned blocks, unsigned threads, size_t bytes, A... args) {
  gridDim.x = blocks;
  blockDim.x = threads;
  pthread_barrier_init(&emu_barrier, nullptr, threads);
  for (unsigned b = 0; b < blocks; ++b) {
    std::memset(emu_smem, 0xff, std::min(bytes + 4096, sizeof(emu_smem)));
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx.x = t;
        blockIdx.x = b;
        kernel(args...);
      });
    for (auto& th : pool) th.join();
  }
  pthread_barrier_destroy(&emu_barrier);
}
