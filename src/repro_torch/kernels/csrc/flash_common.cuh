// Helpers shared by the flash attention kernels (flash_attention.cu, the
// wgmma + TMA kernel; flash_attention_mma.cu, the mma.sync and float32 ones).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SMEM_MAX = 232448;  // 227 KB: what a block may use

// cudaFuncSetAttribute once per kernel and device, not on every launch
struct SmemAttr {
  std::atomic<unsigned long long> done{0};
  cudaError_t ensure(const void* kern) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
    return err;
  }
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
