// Hopper bulk-copy plumbing shared by the persistent tile kernels: K2
// stacked_copy (stacked.cu) and K6 mesh_fold (mesh.cu).
//
// A tile kernel keeps a ring of stages in dynamic shared memory.  One
// thread issues 1-D bulk copies (cp.async.bulk, the Tensor Memory
// Accelerator's non-tensor form: one instruction moves a whole
// 16-byte-aligned span, the hardware computes the addresses) from
// device memory into a stage and arms the stage's mbarrier with the
// bytes it expects; the copy completes the barrier's transaction
// count.  K6's consumer warps then fold from shared memory and
// release the stage on a second barrier; K2 sends the stage back out
// with a bulk store (cp.async.bulk ... bulk_group) and refills it
// only after cp.async.bulk.wait_group.read.  So a few threads keep
// many bytes in flight, which is what a kernel bound by bytes needs.
//
// Every wait is bounded: a stage that never completes (a fault in the
// kernel, never expected) traps after WATCHDOG_NS instead of hanging
// the card.
//
// The grid is persistent: blocks_per_sm() asks the occupancy API how
// many blocks of a kernel fit on one SM at the stage ring's shared
// memory (after opting the kernel in to the card's largest dynamic
// shared memory, once per kernel and card), and the launch takes that
// many blocks on every SM; blocks walk one flat tile list.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <map>
#include <mutex>
#include <set>
#include <tuple>
#include <utility>

#define BAR_BYTES 128  // the mbarriers, ahead of the stage ring
#define WATCHDOG_NS 2000000000ull

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after every mbar_init of the block, before any thread uses them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, unsigned parity) {
  uint32_t ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const unsigned long long t0 = now_ns();
  while (!mbar_try(bar, parity))
    if (now_ns() - t0 > WATCHDOG_NS) __trap();
}

// device memory -> shared memory, completing ``bar``'s transactions;
// src, dst and bytes multiples of 16
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src,
                                         unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// shared memory -> device memory, in the thread's current bulk group
__device__ __forceinline__ void bulk_s2g(void* dst, uint32_t src, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
                   reinterpret_cast<uint64_t>(dst)),
               "r"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Blocks of ``fn`` that fit on one SM at ``threads`` threads and
// ``smem`` bytes of dynamic shared memory on the current card (0 if
// none; -1 on an API error).  Cached per (kernel, card, smem).
static int blocks_per_sm(const void* fn, int threads, size_t smem) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  static std::set<std::pair<const void*, int>> opted;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  const auto key = std::make_tuple(fn, dev, smem);
  std::lock_guard<std::mutex> hold(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) return it->second;
  if (!opted.count({fn, dev})) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin) != cudaSuccess)
      return -1;
    opted.insert({fn, dev});
  }
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem) !=
      cudaSuccess)
    return -1;
  cache[key] = blocks;
  return blocks;
}
