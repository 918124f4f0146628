// A host emulation of what the block kernels (deseq2_tpu_torch/csrc/
// *_block.cu), the wide K1 and K2 (irls.cu, disp_ls.cu) and the templated
// kernels (irls.cu, disp_ls.cu, disp_grid.cu) take from CUDA, for
// tests/test_torch_*_emulation.py: one thread block at a time, its
// launch's threads (at most kThreads) as fibers on the calling thread
// (ucontext), each on a stack of its own, sharing memory; a fiber runs
// until it reaches a barrier, then the next one runs (round robin), so
// __syncthreads and __syncwarp are barriers over the block's or the
// warp's fibers, and warp shuffles, votes and mma.sync an exchange between
// a warp's 32 fibers.  (One OS thread: a barrier costs a context switch a
// fiber, where 256 OS threads on a few cores took milliseconds.)  Under
// an address sanitizer the switches are announced to it
// (__sanitizer_start_switch_fiber).  The sources compile with g++
// -std=c++20 once emulate.py has replaced their inline PTX and launch
// syntax.  Arithmetic is the host's (std::fma in the mma), so results
// match the card's to rounding, not bit for bit.
#pragma once
#include <ucontext.h>

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <vector>
#if defined(__SANITIZE_ADDRESS__)
#include <sanitizer/common_interface_defs.h>
#define EMU_ASAN 1
#else
#define EMU_ASAN 0
#endif

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
// rounded products that are never contracted into a multiply-add
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }

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

#if defined(__x86_64__)
// A fiber switch without swapcontext's signal-mask system call: push the
// callee-saved registers, save the stack pointer to *from, load `to`, pop
// them and return there (a new fiber's stack holds emu_fiber_start as the
// return address).
extern "C" void emu_switch(void** from, void* to);
__asm__(R"(
  .text
  .hidden emu_switch
  .globl emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
)");
#endif

namespace emu {
// the most threads a block: disp_grid.cu's kGridWarps = 10 warps
constexpr int kThreads = 320;
// a fiber's stack
constexpr size_t kStack = size_t(1) << 18;
// the running launch's threads a block, the running one and its block
inline int nthreads = kThreads;
inline int tid = 0;
inline int bid = 0;
struct Dim {
  unsigned x, y, z;
};
// a barrier: its arrivals and its generation
struct Bar {
  int count = 0;
  unsigned gen = 0;
};
// a fiber: its context and stack, whether it has ended, and the barrier
// (and generation) it waits at, if any
struct Fiber {
  void* sp;  // the saved stack pointer (emu_switch)
  ucontext_t ctx;  // elsewhere: swapcontext's
  unsigned char* stack;
  bool done;
  const Bar* wait;
  unsigned wgen;
  int ex;  // the parity of the fiber's warp exchanges
};
inline Fiber fibers[kThreads];
inline void* sched_sp = nullptr;
inline ucontext_t sched;
// the scheduler's stack, for the sanitizer's switches back to it
inline const void* sched_bottom = nullptr;
inline size_t sched_size = 0;
inline std::function<void()> body;
inline Bar block_bar;
inline Bar warp_bar[kThreads / 32];
// a warp's exchange buffers, two of each: a warp's lanes make the same
// exchanges in the same order, and exchange k + 2 (buffer k % 2 again)
// writes only after every lane has passed exchange k + 1's barrier, so
// after its reads of exchange k: one barrier an exchange
inline double xa[2][kThreads / 32][32], xb[2][kThreads / 32][32];
inline unsigned long long xu[2][kThreads / 32][32];
inline std::atomic<int> any{0};
// the launch's dynamic shared memory, exactly its size (so that an
// address sanitizer sees a read past it)
inline unsigned char* smem = nullptr;

// the running fiber back to the scheduler (done: for good)
inline void to_sched(bool done = false) {
#if EMU_ASAN
  __sanitizer_start_switch_fiber(nullptr, sched_bottom, sched_size);
#endif
#if defined(__x86_64__)
  emu_switch(&fibers[tid].sp, sched_sp);
#else
  if (done) return;  // the fiber's function returns to uc_link
  swapcontext(&fibers[tid].ctx, &sched);
#endif
#if EMU_ASAN
  __sanitizer_finish_switch_fiber(nullptr, &sched_bottom, &sched_size);
#endif
}

// wait until the n fibers of b have arrived
inline void arrive_and_wait(Bar& b, int n) {
  const unsigned g = b.gen;
  if (++b.count == n) {
    b.count = 0;
    ++b.gen;
    return;
  }
  fibers[tid].wait = &b;
  fibers[tid].wgen = g;
  to_sched();  // resumed once the barrier's generation has moved on
  fibers[tid].wait = nullptr;
}

inline void warp_sync() { arrive_and_wait(warp_bar[tid >> 5], 32); }

inline void fiber_main() {
#if EMU_ASAN
  __sanitizer_finish_switch_fiber(nullptr, &sched_bottom, &sched_size);
#endif
  body();
  fibers[tid].done = true;
  to_sched(true);
}

// the running fiber's next exchange buffer
inline int next_ex() { return fibers[tid].ex ^= 1; }

template <class T>
inline T shfl(T v, int src) {
  static_assert(sizeof(T) <= 8);
  const int w = tid >> 5, x = next_ex();
  double d = 0;
  std::memcpy(&d, &v, sizeof(T));
  xa[x][w][tid & 31] = d;
  warp_sync();
  const double o = xa[x][w][src & 31];
  T r;
  std::memcpy(&r, &o, sizeof(T));
  return r;
}

// mma.sync m8n8k4 f64: lane l holds A[l/4][l%4], B[l%4][l/4] and
// C[l/4][2 (l%4) + e]
inline void mma(double (&c)[2], double a, double b) {
  const int w = tid >> 5, l = tid & 31, x = next_ex();
  xa[x][w][l] = a;
  xb[x][w][l] = b;
  warp_sync();
  for (int e = 0; e < 2; ++e) {
    const int n = 2 * (l & 3) + e;
    double s = c[e];
    for (int k = 0; k < 4; ++k)
      s = std::fma(xa[x][w][4 * (l >> 2) + k], xb[x][w][4 * n + k], s);
    c[e] = s;
  }
}

inline unsigned long long reduce_or(unsigned long long v) {
  const int w = tid >> 5, x = next_ex();
  xu[x][w][tid & 31] = v;
  warp_sync();
  unsigned long long o = 0;
  for (int k = 0; k < 32; ++k) o |= xu[x][w][k];
  return o;
}

// One block of a launch (block bid) as its threads' fibers.
template <class K, class... A>
void launch_block(int block_threads, size_t bytes, K kernel, A... args) {
  nthreads = block_threads;
  smem = static_cast<unsigned char*>(
      std::aligned_alloc(16, (bytes + 15) / 16 * 16));
  std::memset(smem, 0xff, bytes);  // NaN: a read before a write shows
  block_bar = Bar{};
  for (auto& b : warp_bar) b = Bar{};
  body = [&kernel, &args...] { kernel(args...); };
  for (int t = 0; t < nthreads; ++t) {
    Fiber& f = fibers[t];
    f.stack = static_cast<unsigned char*>(std::malloc(kStack));
    f.done = false;
    f.wait = nullptr;
    f.ex = 0;
#if defined(__x86_64__)
    // emu_switch's six registers, then fiber_main as its return address
    // (16-byte aligned, so that fiber_main starts as a call would)
    void** top = reinterpret_cast<void**>(f.stack + kStack);
    top[-2] = reinterpret_cast<void*>(&fiber_main);
    for (int r = 3; r <= 8; ++r) top[-r] = nullptr;
    f.sp = top - 8;
#else
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack;
    f.ctx.uc_stack.ss_size = kStack;
    f.ctx.uc_link = &sched;
    makecontext(&f.ctx, fiber_main, 0);
#endif
  }
  // round robin: each fiber that can go on runs to its next barrier (or
  // its end)
  for (int left = nthreads; left > 0;) {
    for (int t = 0; t < nthreads; ++t) {
      const Fiber& f = fibers[t];
      if (f.done || (f.wait != nullptr && f.wait->gen == f.wgen)) continue;
      tid = t;
#if EMU_ASAN
      void* fake = nullptr;
      __sanitizer_start_switch_fiber(&fake, fibers[t].stack, kStack);
#endif
#if defined(__x86_64__)
      emu_switch(&sched_sp, fibers[t].sp);
#else
      swapcontext(&sched, &fibers[t].ctx);
#endif
#if EMU_ASAN
      __sanitizer_finish_switch_fiber(fake, nullptr, nullptr);
#endif
      if (fibers[t].done) --left;
    }
  }
  for (int t = 0; t < nthreads; ++t) std::free(fibers[t].stack);
  std::free(smem);
}

// The launch's blocks one after another (a persistent launch is one block:
// the occupancy above), each as its threads' fibers.
template <class K, class... A>
void launch_kernel(int blocks, int block_threads, size_t bytes, K kernel,
                   A... args) {
  for (bid = 0; bid < blocks; ++bid)
    launch_block(block_threads, bytes, kernel, args...);
  bid = 0;
}
}  // namespace emu

#define threadIdx (emu::Dim{(unsigned)emu::tid, 0u, 0u})
#define blockDim (emu::Dim{(unsigned)emu::nthreads, 1u, 1u})
#define blockIdx (emu::Dim{(unsigned)emu::bid, 0u, 0u})

inline void __syncthreads() {
  emu::arrive_and_wait(emu::block_bar, emu::nthreads);
}
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
