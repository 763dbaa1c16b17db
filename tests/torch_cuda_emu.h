// CPU emulation of the CUDA built-ins that the port's hand-written kernels
// use, so that a .cu file compiles with g++ -std=c++20 and its kernels run
// on the CPU (tests/torch_cuda_emu.py rewrites each <<<...>>> launch into
// emu_launch and builds the result).
//
// One std::thread per CUDA thread; the blocks of a launch run one after
// another, so `static` stands for __shared__.  __syncthreads is a per-block
// std::barrier; __syncwarp, the ballot and the shuffles meet at a per-warp
// std::barrier with an exchange array.  Every thread of a warp must reach
// each warp operation, as the kernels' full-mask calls require on the card.
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__ static
#define __shared__ static

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};
struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
using std::max;
using std::min;

struct EmuWarp {
  std::barrier<> bar{32};
  long long x[32];
};
struct EmuBlock {
  explicit EmuBlock(int n) : bar(n), warps((n + 31) / 32) {}
  std::barrier<> bar;
  std::vector<EmuWarp> warps;
};
inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;
inline thread_local EmuBlock* emu_block;

inline void __syncthreads() { emu_block->bar.arrive_and_wait(); }
inline EmuWarp& emu_warp() { return emu_block->warps[threadIdx.x >> 5]; }
inline void __syncwarp(unsigned = 0xffffffffu) {
  emu_warp().bar.arrive_and_wait();
}
// lane `src`'s value of v, for every lane of the warp
inline long long emu_exchange(long long v, int src) {
  EmuWarp& w = emu_warp();
  w.x[threadIdx.x & 31] = v;
  w.bar.arrive_and_wait();
  const long long r = w.x[src & 31];
  w.bar.arrive_and_wait();
  return r;
}
inline unsigned __ballot_sync(unsigned, bool p) {
  EmuWarp& w = emu_warp();
  w.x[threadIdx.x & 31] = p;
  w.bar.arrive_and_wait();
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (w.x[i] ? 1u : 0u) << i;
  w.bar.arrive_and_wait();
  return m;
}
inline int __shfl_sync(unsigned, int v, int src) {
  return static_cast<int>(emu_exchange(v, src));
}
inline int __shfl_xor_sync(unsigned, int v, int m) {
  return static_cast<int>(emu_exchange(v, (threadIdx.x & 31) ^ m));
}
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int lane = threadIdx.x & 31;
  const int src = lane - static_cast<int>(d);
  return static_cast<int>(emu_exchange(v, src < 0 ? lane : src));
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
template <class T>
T __ldg(const T* p) {
  return *p;
}

template <typename... P, typename... A>
void emu_launch(void (*k)(P...), dim3 grid, dim3 block, A... args) {
  for (unsigned b = 0; b < grid.x; ++b) {
    EmuBlock blk(static_cast<int>(block.x));
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = block;
        gridDim = grid;
        emu_block = &blk;
        k(args...);
      });
    for (auto& t : ts) t.join();
  }
}
