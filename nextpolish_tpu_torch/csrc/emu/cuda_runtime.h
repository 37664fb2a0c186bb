#pragma once
// A CPU stand-in for the part of CUDA that csrc/band_align.cu and
// csrc/chain_scan.cu use, so that emu_band.py and emu_chain.py can compile
// those sources with g++ and run them without a card.
// Every CUDA thread is a std::thread; a block's threads share one buffer as
// shared memory; shuffles and ballots go through a per-warp buffer between
// two waits on the warp's std::barrier; __syncthreads waits on the block's.
// The source's NPT_* macros are defined here: its dynamic shared memory is
// the block's buffer, cp.async a plain 16-byte copy, and a launch runs the
// kernel's blocks one at a time.  So this finds wrong logic, not races
// between blocks.
#include <math.h>
#include <stddef.h>
#include <stdlib.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <barrier>
#include <chrono>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __align__(x)
#define __shared__

struct dim3_ {
  unsigned x = 0, y = 0, z = 0;
};
struct EmuBlock {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<std::unique_ptr<std::barrier<>>> wbar;
  std::vector<int> xbuf;  // one int a thread, for shuffles and ballots
  std::vector<uint8_t> smem;
};
inline thread_local dim3_ threadIdx, blockIdx, blockDim;
inline thread_local EmuBlock* emu_blk;
inline thread_local uint8_t* emu_smem_base;

struct uint4 {
  unsigned x, y, z, w;
};
struct uint2 {
  unsigned x, y;
};
struct int4 {
  int x, y, z, w;
};
struct float4 {
  float x, y, z, w;
};
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
template <class T>
T __ldg(const T* p) {
  return *p;
}
template <class T>
void __stcs(T* p, T v) {
  *p = v;
}
// chain_scan.cu's L2 policies, polling load and timer (inline PTX on the
// card)
inline uint64_t npt_l2_keep() { return 0; }
inline uint64_t npt_l2_drop() { return 0; }
inline float4 npt_ld_volatile4(const float4* q) {
  const int* p = reinterpret_cast<const int*>(q);
  int v[4];
  for (int k = 0; k < 4; k++) v[k] = __atomic_load_n(p + k, __ATOMIC_ACQUIRE);
  float4 r;
  memcpy(&r, v, 16);
  return r;
}
inline uint64_t npt_globaltimer() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
inline unsigned __float_as_uint(float x) {
  unsigned u;
  memcpy(&u, &x, 4);
  return u;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
// a waiting thread gives its core to the others (a launch's blocks run
// one at a time, so a wait is only ever on a thread of the same block)
inline void __nanosleep(unsigned) { std::this_thread::yield(); }
inline void __trap() { abort(); }
// single roundings, as on the card (g++ builds this without -ffast-math
// and for a target without FMA)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
// byte n of the result = byte (s >> 4n) & 7 of the eight bytes x, y
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  const uint64_t v = (uint64_t)y << 32 | x;
  unsigned r = 0;
  for (int n = 0; n < 4; n++)
    r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}

// mode 0 down, 1 up, 2 xor, 3 from lane d, within sections of `width`
// lanes; a lane whose source lies past its section reads its own value, as
// on the card; any 4-byte type
inline int emu_shfl(int v, int mode, int d, int width = 32) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int base = lane & ~(width - 1);
  int* buf = emu_blk->xbuf.data() + 32 * w;
  buf[lane] = v;
  emu_blk->wbar[w]->arrive_and_wait();
  int src = lane;
  if (mode == 0)
    src = lane + d < base + width ? lane + d : lane;
  else if (mode == 1)
    src = lane - d >= base ? lane - d : lane;
  else if (mode == 2)
    src = (lane ^ d) < base + width ? lane ^ d : lane;
  else
    src = base + (d & (width - 1));
  const int r = buf[src];
  emu_blk->wbar[w]->arrive_and_wait();
  return r;
}
template <class T>
T emu_shfl_as(T v, int mode, int d, int width) {
  static_assert(sizeof(T) == 4, "4-byte shuffles only");
  int i;
  memcpy(&i, &v, 4);
  i = emu_shfl(i, mode, d, width);
  memcpy(&v, &i, 4);
  return v;
}
template <class T>
T __shfl_down_sync(unsigned, T v, int d, int width = 32) {
  return emu_shfl_as(v, 0, d, width);
}
template <class T>
T __shfl_up_sync(unsigned, T v, int d, int width = 32) {
  return emu_shfl_as(v, 1, d, width);
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int d, int width = 32) {
  return emu_shfl_as(v, 2, d, width);
}
template <class T>
T __shfl_sync(unsigned, T v, int d, int width = 32) {
  return emu_shfl_as(v, 3, d, width);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  unsigned m = 0;
  for (int l = 0; l < 32; l++)
    m |= static_cast<unsigned>(emu_shfl(pred != 0, 3, l)) << l;
  return m;
}
inline bool __all_sync(unsigned, int pred) {
  return __ballot_sync(0xffffffffu, pred) == 0xffffffffu;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline void __syncthreads() { emu_blk->bar->arrive_and_wait(); }
inline void __syncwarp() { emu_blk->wbar[threadIdx.x >> 5]->arrive_and_wait(); }
inline long long clock64() { return 0; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline cudaError_t cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
// the H100's 132 SMs
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return 0;
}
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return 0;
}
inline cudaError_t emu_last_error = 0;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = emu_last_error;
  emu_last_error = 0;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "refused by the emulated launch" : "no error";
}

// Runs f once a thread of each of `grid` blocks of `block` threads with
// `sm` bytes of shared memory; a launch the card would refuse sets the
// error cudaGetLastError reports.
inline void emu_launch(int grid, int block, size_t sm,
                       const std::function<void()>& f) {
  if (block < 32 || block > 1024 || block % 32 || sm > 232448) {
    emu_last_error = cudaErrorInvalidValue;
    return;
  }
  for (int g = 0; g < grid; g++) {
    EmuBlock blk;
    blk.bar = std::make_unique<std::barrier<>>(block);
    for (int w = 0; w < block / 32; w++)
      blk.wbar.push_back(std::make_unique<std::barrier<>>(32));
    blk.xbuf.assign(block, 0);
    blk.smem.assign(sm + 16, 0xcd);
    uint8_t* base =
        blk.smem.data() + ((16 - ((uintptr_t)blk.smem.data() & 15)) & 15);
    std::vector<std::thread> th;
    for (int t = 0; t < block; t++)
      th.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = g;
        blockDim.x = block;
        emu_blk = &blk;
        emu_smem_base = base;
        f();
      });
    for (auto& x : th) x.join();
  }
}

// NPT_LAUNCH(grid, block, sm, stream, kernel)(args...)
template <class F>
struct EmuLaunch {
  int grid, block;
  size_t sm;
  F* kernel;
  template <class... A>
  void operator()(A... a) const {
    emu_launch(grid, block, sm, [&] { kernel(a...); });
  }
};
template <class F>
EmuLaunch<F> emu_launcher(int grid, int block, size_t sm, F* kernel) {
  return {grid, block, sm, kernel};
}

#define NPT_EMU 1
#define NPT_DYNAMIC_SMEM(name) uint8_t* name = emu_smem_base
#define NPT_CP_ASYNC16(dst, src) memcpy(dst, src, 16)
#define NPT_CP_ASYNC16_HINT(dst, src, pol) ((void)(pol), memcpy(dst, src, 16))
#define NPT_CP_ASYNC_COMMIT() ((void)0)
#define NPT_CP_ASYNC_WAIT(n) ((void)0)
#define NPT_LAUNCH(grid, block, sm, stream, ...) \
  ((void)(stream), emu_launcher(grid, block, sm, &__VA_ARGS__))
