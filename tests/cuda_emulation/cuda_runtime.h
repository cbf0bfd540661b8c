// Stand-in for <cuda_runtime.h> that lets a host C++ compiler build a CUDA
// source of the port and run its kernels on the CPU: one block at a time,
// one host thread per CUDA thread, a pthread barrier for __syncthreads().
// tests/test_torch_emulated.py rewrites the few constructs a host compiler
// cannot parse (the <<<...>>> launch, the cp.async inline assembly, the
// extern __shared__ array, of floats or float4s) and includes this file in
// place of the real one.  With -ffp-contract=off the float arithmetic
// rounds as the card's does under --fmad=false, so a kernel can be held
// bitwise to its plain version; fmaf is the fused multiply-add of <cmath>.
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

struct alignas(16) float4 { float x, y, z, w; };

struct emu_dim3 { unsigned x = 0, y = 0, z = 0; };
static thread_local emu_dim3 threadIdx, blockIdx;
static emu_dim3 blockDim, gridDim;
alignas(16) static float emu_smem[1 << 18];         // 1 MiB: more than a block may ask for
static pthread_barrier_t emu_barrier;
inline void __syncthreads() { pthread_barrier_wait(&emu_barrier); }
// Warp shuffles and votes as exchanges behind a barrier of the warp's 32
// threads: every lane of a warp must call them the same number of times, as
// on the card (blocks are whole warps).
static long long emu_xchg[1024];
static int emu_count;
static pthread_barrier_t emu_warp_barrier[32];
inline void emu_warp_sync() { pthread_barrier_wait(&emu_warp_barrier[threadIdx.x >> 5]); }
template <class T> inline T emu_lane(T v, int src) {       // lane `src` of this warp's v
  const unsigned t = threadIdx.x;
  std::memcpy(&emu_xchg[t], &v, sizeof(T));
  emu_warp_sync();
  T r;
  std::memcpy(&r, &emu_xchg[(t & ~31u) + (unsigned)src], sizeof(T));
  emu_warp_sync();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src) { return emu_lane(v, src & 31); }
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  const unsigned l = threadIdx.x & 31u;
  const T r = emu_lane(v, (int)(l + d < 32u ? l + d : l));
  return r;
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const unsigned l = threadIdx.x & 31u;
  return emu_lane(v, (int)(l >= d ? l - d : l));
}
inline unsigned __ballot_sync(unsigned, int p) {
  const unsigned t = threadIdx.x;
  emu_xchg[t] = p != 0;
  emu_warp_sync();
  unsigned r = 0;
  for (unsigned l = 0; l < 32; ++l) r |= (unsigned)emu_xchg[(t & ~31u) + l] << l;
  emu_warp_sync();
  return r;
}
inline int __syncthreads_count(int p) {
  if (threadIdx.x == 0) emu_count = 0;
  pthread_barrier_wait(&emu_barrier);
  if (p) __atomic_fetch_add(&emu_count, 1, __ATOMIC_SEQ_CST);
  pthread_barrier_wait(&emu_barrier);
  const int r = emu_count;
  pthread_barrier_wait(&emu_barrier);
  return r;
}
inline int atomicAdd(int* a, int v) { return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST); }
using std::max;
using std::min;

typedef int cudaError_t;
typedef void* cudaStream_t;
const int cudaSuccess = 0;
const int cudaErrorInvalidValue = 1;
const int cudaErrorInvalidConfiguration = 9;
const int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
const int cudaFuncAttributePreferredSharedMemoryCarveout = 9;
const int cudaDevAttrMultiProcessorCount = 16;
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* device) { *device = 0; return 0; }
// two "SMs", so that a persistent grid walks its grid-stride loop
inline int cudaDeviceGetAttribute(int* value, int, int) { *value = 2; return 0; }
// A kernel's registers and local bytes are the card's compiler's: none here.
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F> inline int cudaFuncGetAttributes(cudaFuncAttributes* attr, F) {
  attr->numRegs = 0;
  attr->localSizeBytes = 0;
  return 0;
}
// Blocks an SM by threads and shared memory alone (an H100's 2,048 threads
// and 228 KB, 1 KB of it kept per block): the stand-in knows no registers.
template <class F> inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int threads,
                                                                            size_t bytes) {
  *n = std::min(2048 / threads, (int)(233472 / (bytes + 1024)));
  return 0;
}

// Runs `blocks` blocks of `threads` threads one after the other.  Shared
// memory is filled with NaNs before each block, so that a read of a value
// that was never written shows in the result.
template <class F, class... A>
void emu_launch(F kernel, unsigned blocks, unsigned threads, size_t bytes, A... args) {
  gridDim.x = blocks;
  blockDim.x = threads;
  pthread_barrier_init(&emu_barrier, nullptr, threads);
  for (unsigned w = 0; w < threads / 32; ++w) pthread_barrier_init(&emu_warp_barrier[w], nullptr, 32);
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
  for (unsigned w = 0; w < threads / 32; ++w) pthread_barrier_destroy(&emu_warp_barrier[w]);
}
