// A host emulation of what the block kernels (deseq2_tpu_torch/csrc/
// *_block.cu) and the wide K2 (disp_ls.cu) take from CUDA, for
// tests/test_torch_block_emulation.py: one thread block at a time as its
// launch's std::threads (at most kThreads) sharing memory,
// __syncthreads as a barrier, warp shuffles, votes and mma.sync as an
// exchange between a warp's 32 threads.  The sources compile with g++
// -std=c++20 once emulate.py has replaced their inline PTX and launch
// syntax.  Arithmetic is the host's (std::fma in the mma), so results
// match the card's to rounding, not bit for bit.
#pragma once
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__

using std::exp;
using std::fabs;
using std::isnan;
using std::lgamma;
using std::log;
using std::log1p;
using std::sqrt;
inline float expf(float v) { return std::exp(v); }
inline float logf(float v) { return std::log(v); }
inline float log1pf(float v) { return std::log1p(v); }
inline float sqrtf(float v) { return std::sqrt(v); }
inline float lgammaf(float v) { return std::lgamma(v); }
inline float fabsf(float v) { return std::fabs(v); }

struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1, cudaErrorInvalidConfiguration = 9 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
template <class K>
inline int cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return 0; }
// one resident block on one SM: a persistent launch is one block
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                         size_t) {
  *n = 1;
  return 0;
}
inline int cudaGetDevice(int* d) {
  *d = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 1;
  return 0;
}
inline int cudaGetLastError() { return 0; }

namespace emu {
constexpr int kThreads = 256;
// the running launch's threads a block
inline int nthreads = kThreads;
inline thread_local int tid = 0;
struct Dim {
  unsigned x, y, z;
};
inline std::barrier<>* block_bar = nullptr;
inline std::barrier<>* warp_bar[kThreads / 32];
inline double xa[kThreads / 32][32], xb[kThreads / 32][32];
inline unsigned long long xu[kThreads / 32][32];
inline std::atomic<int> any{0};
// the launch's dynamic shared memory, exactly its size (so that an
// address sanitizer sees a read past it)
inline unsigned char* smem = nullptr;

inline void warp_sync() { warp_bar[tid >> 5]->arrive_and_wait(); }

template <class T>
inline T shfl(T v, int src) {
  static_assert(sizeof(T) <= 8);
  const int w = tid >> 5;
  double d = 0;
  std::memcpy(&d, &v, sizeof(T));
  xa[w][tid & 31] = d;
  warp_sync();
  const double o = xa[w][src & 31];
  warp_sync();
  T r;
  std::memcpy(&r, &o, sizeof(T));
  return r;
}

// mma.sync m8n8k4 f64: lane l holds A[l/4][l%4], B[l%4][l/4] and
// C[l/4][2 (l%4) + e]
inline void mma(double (&c)[2], double a, double b) {
  const int w = tid >> 5, l = tid & 31;
  xa[w][l] = a;
  xb[w][l] = b;
  warp_sync();
  for (int e = 0; e < 2; ++e) {
    const int n = 2 * (l & 3) + e;
    double s = c[e];
    for (int k = 0; k < 4; ++k)
      s = std::fma(xa[w][4 * (l >> 2) + k], xb[w][4 * n + k], s);
    c[e] = s;
  }
  warp_sync();
}

inline unsigned long long reduce_or(unsigned long long v) {
  const int w = tid >> 5;
  xu[w][tid & 31] = v;
  warp_sync();
  unsigned long long o = 0;
  for (int k = 0; k < 32; ++k) o |= xu[w][k];
  warp_sync();
  return o;
}

template <class K, class... A>
void launch_kernel(int block_threads, size_t bytes, K kernel, A... args) {
  nthreads = block_threads;
  smem = static_cast<unsigned char*>(
      std::aligned_alloc(16, (bytes + 15) / 16 * 16));
  std::memset(smem, 0xff, bytes);  // NaN: a read before a write shows
  std::barrier<> bar(nthreads);
  block_bar = &bar;
  for (auto& b : warp_bar) b = new std::barrier<>(32);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back([t, &kernel, &args...] {
      tid = t;
      kernel(args...);
    });
  for (auto& th : threads) th.join();
  for (auto& b : warp_bar) delete b;
  std::free(smem);
}
}  // namespace emu

#define threadIdx (emu::Dim{(unsigned)emu::tid, 0u, 0u})
#define blockDim (emu::Dim{(unsigned)emu::nthreads, 1u, 1u})
#define blockIdx (emu::Dim{0u, 0u, 0u})

inline void __syncthreads() { emu::block_bar->arrive_and_wait(); }
inline bool __syncthreads_or(bool p) {
  __syncthreads();
  if (p) emu::any.store(1);
  __syncthreads();
  const bool r = emu::any.load() != 0;
  __syncthreads();
  if (emu::tid == 0) emu::any.store(0);
  __syncthreads();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { emu::warp_sync(); }
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int o) {
  return emu::shfl(v, (emu::tid & 31) ^ o);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
  return emu::shfl(v, src);
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return (unsigned)emu::reduce_or(v);
}
inline bool __any_sync(unsigned, bool p) { return emu::reduce_or(p) != 0; }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline unsigned long long atomicOr(unsigned long long* p,
                                   unsigned long long v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}
