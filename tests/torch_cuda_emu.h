// CPU emulation of the CUDA built-ins that the port's hand-written kernels
// use, so that a .cu file compiles with g++ -std=c++20 and its kernels run
// on the CPU (tests/torch_cuda_emu.py rewrites each <<<...>>> launch into
// emu_launch and builds the result).
//
// One std::thread per CUDA thread; the blocks of a launch run one after
// another, so `static` stands for __shared__, and a block's dynamic shared
// memory (`extern __shared__`, rewritten by torch_cuda_emu.py) is a buffer
// of the launch's size that its threads share.  __syncthreads is a per-block
// std::barrier; __syncwarp, the ballot and the shuffles meet at a per-warp
// std::barrier with an exchange array.  Every thread of a warp must reach
// each warp operation, as the kernels' full-mask calls require on the card.
#pragma once
#include <algorithm>
#include <cmath>
#include <atomic>
#include <barrier>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __constant__ static
#define __shared__ static
#define __noinline__ __attribute__((noinline))
#define __align__(n) __attribute__((aligned(n)))
// a kernel source leaves its inline-PTX helpers to this header
#define TORCH_CUDA_EMU 1

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
struct float4 {
  float x, y, z, w;
};
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
struct int2 {
  int x, y;
};
inline int2 make_int2(int a, int b) { return {a, b}; }
struct uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorMisalignedAddress = 716
};
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// the emulated card: 2 SMs holding one block each, so that a kernel which
// walks its work with a grid-stride loop sized to the resident blocks
// takes several rounds
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
// the first fault of the launches since the last cudaGetLastError, which
// returns and clears it
inline std::atomic<int> emu_error{cudaSuccess};
inline cudaError_t cudaGetLastError() { return emu_error.exchange(0); }
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
inline thread_local void* emu_dynamic;

template <class T>
T* emu_dynamic_shared() {
  return static_cast<T*>(emu_dynamic);
}

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
inline float __shfl_xor_sync(unsigned, float v, int m) {
  int bits;
  std::memcpy(&bits, &v, 4);
  bits = static_cast<int>(emu_exchange(bits, (threadIdx.x & 31) ^ m));
  float r;
  std::memcpy(&r, &bits, 4);
  return r;
}
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int lane = threadIdx.x & 31;
  const int src = lane - static_cast<int>(d);
  return static_cast<int>(emu_exchange(v, src < 0 ? lane : src));
}
inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return static_cast<unsigned>((static_cast<unsigned long long>(a) * b) >> 32);
}
// byte i of the result is byte (s >> 4i) & 7 of the eight bytes {y, x}
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const unsigned long long b =
      (static_cast<unsigned long long>(y) << 32) | x;
  unsigned r = 0;
  for (int i = 0; i < 4; ++i)
    r |= static_cast<unsigned>((b >> (8 * ((s >> (4 * i)) & 7))) & 0xffu)
         << (8 * i);
  return r;
}
// one rounding, as the card's FFMA
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
template <class T>
T __ldg(const T* p) {
  return *p;
}
// cp.async as the kernels wrap it: the copy happens at once, so commit and
// wait have nothing to do (the kernel's barrier after the wait still orders
// the lanes); an address not aligned to the copy's size faults, as on the
// card
template <int N>
inline void emu_copy_async(void* smem, const void* gmem) {
  if (reinterpret_cast<uintptr_t>(smem) % N ||
      reinterpret_cast<uintptr_t>(gmem) % N) {
    int ok = cudaSuccess;
    emu_error.compare_exchange_strong(ok, cudaErrorMisalignedAddress);
    return;
  }
  std::memcpy(smem, gmem, N);
}
inline void copy_async16(void* smem, const void* gmem) {
  emu_copy_async<16>(smem, gmem);
}
inline void copy_async8(void* smem, const void* gmem) {
  emu_copy_async<8>(smem, gmem);
}
inline void copy_async4(void* smem, const void* gmem) {
  emu_copy_async<4>(smem, gmem);
}
inline void copy_async_commit() {}
inline void copy_async_wait(int) {}
inline void copy_async_wait_all() {}
// st.global.v4 / .v2 as the kernels wrap them; unaligned faults
template <int N>
inline void emu_store_vector(int32_t* p, const int* v) {
  if (reinterpret_cast<uintptr_t>(p) % (4 * N)) {
    int ok = cudaSuccess;
    emu_error.compare_exchange_strong(ok, cudaErrorMisalignedAddress);
    return;
  }
  std::memcpy(p, v, 4 * N);
}
inline void store_global_v4(int32_t* p, int a, int b, int c, int d) {
  const int v[4] = {a, b, c, d};
  emu_store_vector<4>(p, v);
}
inline void store_global_v2(int32_t* p, int a, int b) {
  const int v[2] = {a, b};
  emu_store_vector<2>(p, v);
}
// ld.global.nc.v2.u32 of eight bytes as the kernels wrap it; an address
// not 8-byte aligned faults (the load returns zeros), as on the card
inline uint2 load_global_v2u(const uint8_t* p) {
  if (reinterpret_cast<uintptr_t>(p) % 8) {
    int ok = cudaSuccess;
    emu_error.compare_exchange_strong(ok, cudaErrorMisalignedAddress);
    return {0u, 0u};
  }
  uint2 v;
  std::memcpy(&v, p, 8);
  return v;
}
// cvt.pack.sat.s8.s32.b32 as the kernels wrap it
inline unsigned pack_sat_s8(int a, int b, unsigned c) {
  const auto s8 = [](int v) {
    return static_cast<unsigned>(std::min(std::max(v, -128), 127)) & 0xffu;
  };
  return (c << 16) | (s8(a) << 8) | s8(b);
}

template <typename... P, typename... A>
void emu_launch_smem(void (*k)(P...), dim3 grid, dim3 block, size_t smem,
                     A... args) {
  for (unsigned b = 0; b < grid.x; ++b) {
    EmuBlock blk(static_cast<int>(block.x));
    struct alignas(16) Chunk {
      char b[16];
    };
    std::vector<Chunk> dyn(smem / sizeof(Chunk) + 1);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        blockDim = block;
        gridDim = grid;
        emu_block = &blk;
        emu_dynamic = dyn.data();
        k(args...);
      });
    for (auto& t : ts) t.join();
  }
}

template <typename... P, typename... A>
void emu_launch(void (*k)(P...), dim3 grid, dim3 block, A... args) {
  emu_launch_smem(k, grid, block, 0, args...);
}
