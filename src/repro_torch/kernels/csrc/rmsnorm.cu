// RMSNorm for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm. Per
// row of D elements, with float32 statistics:
//
//     out = x * rsqrt(mean(x^2) + eps) * (1 + w)      (cast once to x's type)
//
// x and out are (rows, D) row-major in float32 or bfloat16; w is (D,) in
// float32 or bfloat16, independently of x. The TPU kernel normalises a block
// of 128 rows per grid step in VMEM; here a row is one warp's work (D < 1024)
// or one block's (D >= 1024), and many rows are in flight across the SMs.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once with 3 operations and a share of one reduction; at granite's prefill
// shape (512 x 1536 bf16) the function moves 3.1 MB, 0.94 us at 3.35 TB/s.
//
// Design: a row is loaded once into registers, 16 bytes a thread per load
// where every row starts 16-byte aligned (x, out and w aligned and D a
// multiple of a vector), else one element a thread per load (the scalar
// path). Each thread sums its squares in f32; a warp-shuffle reduction (and,
// for a block, one pass through shared memory) gives the row's sum; the scale
// pass runs from the registers and stores in the same pattern. kPer bounds
// the elements a thread holds: D <= 32 * 32 on the warp path and
// D <= threads * 16 on the block path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpRows = 4;      // rows (warps) per block on the warp path
constexpr int kWarpPer = 32;      // elements a lane holds on the warp path
constexpr int kBlockPer = 16;     // elements a thread holds on the block path
constexpr int kBlockMinD = 1024;  // rows this wide take a block each
constexpr int kMaxThreads = 1024;

// Elements are handled as their bits: float, or uint16_t for bfloat16 (a
// union of trivial types; the upper half of a float is its bfloat16 value).
using bf16_bits = uint16_t;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16_bits v) {
  return __uint_as_float((unsigned)v << 16);  // exact
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16_bits from_f<bf16_bits>(float v) {
  // round to nearest even, as torch's .to(bfloat16)
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// N elements of T as whole 16-byte words (or one 8-byte word).
template <typename T, int N>
union Pack {
  static constexpr int kBytes = N * (int)sizeof(T);
  using Word = typename std::conditional<(kBytes >= 16), uint4, uint2>::type;
  Word w[kBytes / (int)sizeof(Word)];
  T e[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_pack(const T* p, float (&dst)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(pk.w) / sizeof(pk.w[0])); ++i)
    pk.w[i] = reinterpret_cast<const typename Pack<T, N>::Word*>(p)[i];
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = to_f(pk.e[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_pack(T* p, const float (&src)[N]) {
  Pack<T, N> pk;
#pragma unroll
  for (int j = 0; j < N; ++j) pk.e[j] = from_f<T>(src[j]);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(pk.w) / sizeof(pk.w[0])); ++i)
    reinterpret_cast<typename Pack<T, N>::Word*>(p)[i] = pk.w[i];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kBlock: one block per row (else one warp per row, kWarpRows rows a block).
// kVec: every row is 16-byte aligned and a whole number of 16-byte vectors.
template <typename TX, typename TW, bool kBlock, bool kVec>
__global__ void rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                               TX* __restrict__ out, int rows, int D, float eps) {
  constexpr int kPer = kBlock ? kBlockPer : kWarpPer;
  constexpr int kV = 16 / (int)sizeof(TX);  // elements of x in 16 bytes
  const int nthr = kBlock ? (int)blockDim.x : kWarp;
  const int t = kBlock ? (int)threadIdx.x : (int)(threadIdx.x % kWarp);
  const long long row = kBlock ? (long long)blockIdx.x
                               : (long long)blockIdx.x * kWarpRows + threadIdx.x / kWarp;
  if (!kBlock && row >= rows) return;  // a whole warp leaves; no barrier follows
  const TX* xr = x + row * D;
  TX* orow = out + row * D;

  float v[kPer];
  float ss = 0.f;
  if (kVec) {
    const int nv = D / kV;
#pragma unroll
    for (int i = 0; i < kPer / kV; ++i) {
      const int vi = t + i * nthr;
      if (vi < nv) {
        float tmp[kV];
        load_pack<TX, kV>(xr + vi * kV, tmp);
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          v[i * kV + j] = tmp[j];
          ss = fmaf(tmp[j], tmp[j], ss);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + i * nthr;
      if (e < D) {
        v[i] = to_f(xr[e]);
        ss = fmaf(v[i], v[i], ss);
      }
    }
  }

  ss = warp_sum(ss);
  if (kBlock) {
    __shared__ float s_part[kMaxThreads / kWarp];
    __shared__ float s_total;
    const int lane = t % kWarp, wid = t / kWarp;
    if (lane == 0) s_part[wid] = ss;
    __syncthreads();
    if (wid == 0) {
      float p = lane < nthr / kWarp ? s_part[lane] : 0.f;
      p = warp_sum(p);
      if (lane == 0) s_total = p;
    }
    __syncthreads();
    ss = s_total;
  }
  const float r = rsqrtf(ss / (float)D + eps);

  if (kVec) {
    const int nv = D / kV;
#pragma unroll
    for (int i = 0; i < kPer / kV; ++i) {
      const int vi = t + i * nthr;
      if (vi < nv) {
        float wv[kV], o[kV];
        load_pack<TW, kV>(w + vi * kV, wv);
#pragma unroll
        for (int j = 0; j < kV; ++j) o[j] = (v[i * kV + j] * r) * (1.f + wv[j]);
        store_pack<TX, kV>(orow + vi * kV, o);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = t + i * nthr;
      if (e < D) orow[e] = from_f<TX>((v[i] * r) * (1.f + to_f(w[e])));
    }
  }
}

template <typename TX, typename TW, bool kBlock, bool kVec>
int launch(const void* x, const void* w, void* out, int rows, int D, float eps,
           cudaStream_t stream) {
  dim3 grid, block;
  if (kBlock) {
    // enough threads that each holds at most 8 elements (kBlockPer bounds it)
    int thr = ((D + 7) / 8 + kWarp - 1) / kWarp * kWarp;
    thr = thr < 128 ? 128 : (thr > kMaxThreads ? kMaxThreads : thr);
    if (D > thr * kBlockPer) return (int)cudaErrorInvalidValue;
    grid = dim3(rows);
    block = dim3(thr);
  } else {
    if (D > kWarp * kWarpPer) return (int)cudaErrorInvalidValue;
    grid = dim3((rows + kWarpRows - 1) / kWarpRows);
    block = dim3(kWarp * kWarpRows);
  }
  rmsnorm_kernel<TX, TW, kBlock, kVec><<<grid, block, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out),
      rows, D, eps);
  return (int)cudaGetLastError();
}

template <typename TX, typename TW>
int dispatch(const void* x, const void* w, void* out, int rows, int D, float eps,
             cudaStream_t stream) {
  constexpr int kV = 16 / (int)sizeof(TX);
  // a vector of x's kV elements reads kV elements of w: 8, 16 or 32 bytes
  const size_t w_align = (size_t)kV * sizeof(TW) < 16 ? (size_t)kV * sizeof(TW) : 16;
  const bool vec = D % kV == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0 &&
                   (uintptr_t)w % w_align == 0;
  const bool blk = D >= kBlockMinD;
  if (blk)
    return vec ? launch<TX, TW, true, true>(x, w, out, rows, D, eps, stream)
               : launch<TX, TW, true, false>(x, w, out, rows, D, eps, stream);
  return vec ? launch<TX, TW, false, true>(x, w, out, rows, D, eps, stream)
             : launch<TX, TW, false, false>(x, w, out, rows, D, eps, stream);
}

}  // namespace

// x, out: (rows, D) row-major, dtype x_dtype; w: (D,), dtype w_dtype
// (0 = float32, 1 = bfloat16). Launches on `stream`, does not synchronise;
// returns the launch's CUDA error (0 = ok).
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out, int rows, int D,
                           int x_dtype, int w_dtype, float eps, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (x_dtype < 0 || x_dtype > 1 || w_dtype < 0 || w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = bf16_bits;
  if (x_dtype == 0)
    return w_dtype == 0 ? dispatch<float, float>(x, w, out, rows, D, eps, s)
                        : dispatch<float, bf16>(x, w, out, rows, D, eps, s);
  return w_dtype == 0 ? dispatch<bf16, float>(x, w, out, rows, D, eps, s)
                      : dispatch<bf16, bf16>(x, w, out, rows, D, eps, s);
}
