// A stand-in for the CUDA runtime, so that a host compiler can rehearse the
// port's kernels (pigeons_tpu_torch/csrc/*.cu) without a card:
//
//   g++ -x c++ -std=c++17 -O1 -ffp-contract=off -pthread -shared -fPIC
//       -I tests/cuda_stub -o kernel.so pigeons_tpu_torch/csrc/banded_slice.cu
//
// A launch runs the grid's blocks one after the other and the threads of a
// block as host threads. __syncthreads is a barrier over the block, and the
// warp primitives (__syncwarp, __ballot_sync, __shfl_sync, __shfl_xor_sync)
// are rendezvous of the threads that the mask names, so that a kernel whose
// threads disagree about a mask hangs here as it would on the card (callers
// set a time limit). __fmaf_rn is fmaf and -ffp-contract=off keeps the
// compiler from fusing anything else, so the arithmetic is the card's under
// nvcc --fmad=false, bit for bit. Only what the port's sources use is here.
// tests/test_torch_csrc_host.py builds the sources this way and holds them
// against their torch twins.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <condition_variable>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __shared__
#define __constant__
#define __forceinline__ inline
#define __launch_bounds__(...)

struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorLaunchOutOfResources = 701 };
enum { cudaDevAttrMultiProcessorCount = 16 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

// a device of 2 SMs that keep 2 blocks resident each
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) { return *device = 0, cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) { return *value = 2, cudaSuccess; }
template <class Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, Kernel, int, size_t) {
  return *blocks = 2, cudaSuccess;
}
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, int, int) { return cudaSuccess; }

template <class T> inline T min(T a, T b) { return b < a ? b : a; }
template <class T> inline T max(T a, T b) { return a < b ? b : a; }
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
template <class To, class From> inline To stub_bit_cast(From v) {
  To out;
  memcpy(&out, &v, sizeof out);
  return out;
}
inline float __uint_as_float(uint32_t v) { return stub_bit_cast<float>(v); }
inline float __int_as_float(int32_t v) { return stub_bit_cast<float>(v); }
inline int32_t __float_as_int(float v) { return stub_bit_cast<int32_t>(v); }
inline double __longlong_as_double(long long v) { return stub_bit_cast<double>(v); }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }

namespace cuda_stub {

// Where the threads that a mask names meet: each leaves a word, the last to
// arrive publishes all of them, and everyone reads the published words.
struct Rendezvous {
  std::mutex m;
  std::condition_variable cv;
  unsigned arrived = 0, generation = 0;
  uint32_t words[32] = {}, published[32] = {};
};

struct Block {
  std::mutex m;
  std::condition_variable cv;
  unsigned arrived = 0, generation = 0;
  std::mutex warps_m;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<Rendezvous>> warps;  // (warp, mask)
};

inline Block* current_block = nullptr;  // blocks run one at a time
inline std::mutex atomics_m;

// The words that the threads of `mask` in this thread's warp brought.
inline void meet(unsigned mask, uint32_t word, uint32_t out[32]) {
  const unsigned lane = threadIdx.x % 32;
  Rendezvous* r;
  {
    std::lock_guard<std::mutex> lock(current_block->warps_m);
    auto& slot = current_block->warps[{threadIdx.x / 32, mask}];
    if (!slot) slot = std::make_unique<Rendezvous>();
    r = slot.get();
  }
  std::unique_lock<std::mutex> lock(r->m);
  r->words[lane] = word;
  const unsigned generation = r->generation;
  if (++r->arrived == (unsigned)__builtin_popcount(mask)) {
    memcpy(r->published, r->words, sizeof r->words);
    r->arrived = 0;
    r->generation += 1;
    r->cv.notify_all();
  } else {
    r->cv.wait(lock, [&] { return r->generation != generation; });
  }
  memcpy(out, r->published, sizeof r->published);
}

}  // namespace cuda_stub

// the kernels' dynamic shared memory (csrc/common.cuh: dynamic_shared), at
// the most a block may ask for
namespace pigeons {
alignas(16) inline float pigeons_dynamic_shared[232448 / sizeof(float)];
}

inline void __syncthreads() {
  cuda_stub::Block* b = cuda_stub::current_block;
  std::unique_lock<std::mutex> lock(b->m);
  const unsigned generation = b->generation;
  if (++b->arrived == blockDim.x) {
    b->arrived = 0;
    b->generation += 1;
    b->cv.notify_all();
  } else {
    b->cv.wait(lock, [&] { return b->generation != generation; });
  }
}

inline void __syncwarp(unsigned mask) {
  uint32_t words[32];
  cuda_stub::meet(mask, 0, words);
}

inline unsigned __ballot_sync(unsigned mask, bool predicate) {
  uint32_t words[32];
  cuda_stub::meet(mask, predicate, words);
  unsigned out = 0;
  for (int i = 0; i < 32; ++i)
    if ((mask >> i & 1u) && words[i]) out |= 1u << i;
  return out;
}

// lane src (lane ^ lane_mask) of this thread's segment of `width` lanes
inline float __shfl_sync(unsigned mask, float value, int src, int width = 32) {
  uint32_t words[32];
  cuda_stub::meet(mask, stub_bit_cast<uint32_t>(value), words);
  const unsigned lane = threadIdx.x % 32, segment = lane & ~(unsigned)(width - 1);
  return stub_bit_cast<float>(words[segment | ((unsigned)src & (width - 1))]);
}

inline float __shfl_xor_sync(unsigned mask, float value, int lane_mask, int width = 32) {
  return __shfl_sync(mask, value, (int)(threadIdx.x % 32) ^ lane_mask, width);
}

template <class T> inline T atomicAdd(T* address, T value) {
  std::lock_guard<std::mutex> lock(cuda_stub::atomics_m);
  const T old = *address;
  *address = old + value;
  return old;
}

// kernel<<<grid, block, shared_bytes, stream>>>(args...), synchronously
template <class... Params, class... Args>
void cuda_stub_launch(void (*kernel)(Params...), dim3 grid, dim3 block, size_t, cudaStream_t,
                      Args... args) {
  for (unsigned bx = 0; bx < grid.x; ++bx) {
    cuda_stub::Block state;
    cuda_stub::current_block = &state;
    std::vector<std::thread> threads;
    for (unsigned tx = 0; tx < block.x; ++tx)
      threads.emplace_back([=] {
        threadIdx = dim3(tx);
        blockIdx = dim3(bx);
        blockDim = block;
        gridDim = grid;
        kernel(args...);
      });
    for (std::thread& t : threads) t.join();
  }
  cuda_stub::current_block = nullptr;
}

#define PIGEONS_LAUNCH(kernel, grid, block, shared_bytes, stream, ...) \
  cuda_stub_launch(kernel, grid, block, shared_bytes, stream, __VA_ARGS__)
