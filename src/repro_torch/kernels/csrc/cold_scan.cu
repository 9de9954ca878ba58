// Cold-start scan of the batched workflow simulator, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cold_scan.py::cold_scan.
// Per row b (one (seed, placement) lane of the sweep), over the requests k
// of one workflow node:
//
//     last      = -inf
//     mask[b,k] = (t0[k] - last) > keep_warm[b]
//     last      = mask[b,k] ? cold_end[b,k] : warm_end[b,k]
//
// Rows are independent; time is sequential. Unlike the TPU kernel, which
// takes one keep_warm and computes in f32, this one takes keep_warm per row
// (a moved step lands on a platform with another keep_warm) and compares in
// the dtype it is given (f32 or f64): on the f64 path an f32 cast could flip
// a comparison whose gap lies within an f32 ulp of keep_warm. Only
// subtractions, comparisons and selects touch the values, so the result is
// exact; build without --use_fast_math.
//
// Its bound is bytes. Each row reads 2·T values and writes T mask bytes
// (151 MB in f32, 285 MB in f64 at B = T = 4096, 45 and 85 us at 3.35 TB/s);
// the arithmetic is three operations per element. The design: one warp owns
// 32 rows and walks time in tiles of 32 requests. Each lane loads element
// (row r, tile time lane) for all 32 rows, so every load instruction of the
// warp reads one row's 32 consecutive values (coalesced); the tile goes
// through shared memory transposed, lane r scans its own row over the 32
// requests (unrolled for a full tile), and the mask bits go back out row by
// row (lane l writes request l), coalesced again. The next tile's 64 loads
// are issued before the scan of the current one, so the scan hides behind
// them. There is one thread per row, so a sweep of B rows keeps only B/32
// warps busy: at B = 4096 about one warp per SM, and the kernel is bound by
// that warp's latency, not by bytes. Splitting time into chunks (the
// GF(2)-affine form of cold_scan_parallel) is the way to more parallelism.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kW = 32;  // rows per warp == requests per tile

// One request of one row: cold iff the gap since the previous end clears
// keep_warm; the row's previous end becomes the cold or the warm end.
template <typename T>
__device__ __forceinline__ bool scan_step(T t0, T warm, T cold, T kw, T& last) {
  const bool m = (t0 - last) > kw;
  last = m ? cold : warm;
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kW) cold_scan_kernel(
    const T* __restrict__ t0, const T* __restrict__ warm,
    const T* __restrict__ cold, const T* __restrict__ keep_warm,
    uint8_t* __restrict__ mask, int B, int n) {
  __shared__ T s_warm[kW][kW + 1];  // [request in tile][row], padded
  __shared__ T s_cold[kW][kW + 1];
  __shared__ T s_t0[kW];

  const int lane = threadIdx.x;
  const int row0 = blockIdx.x * kW;
  const int my_row = row0 + lane;
  const T kw = my_row < B ? keep_warm[my_row] : T(0);
  T last = T(-INFINITY);

  T rw[kW], rc[kW];  // the tile in flight: (row0 + r, t + lane)
  T rt;

  // first tile
  {
    const int tt = lane;
    const bool t_ok = tt < n;
    rt = t_ok ? t0[tt] : T(0);
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      const bool ok = t_ok && row0 + r < B;
      const size_t off = (size_t)(row0 + r) * n + tt;
      rw[r] = ok ? warm[off] : T(0);
      rc[r] = ok ? cold[off] : T(0);
    }
  }

  for (int t = 0; t < n; t += kW) {
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      s_warm[lane][r] = rw[r];
      s_cold[lane][r] = rc[r];
    }
    s_t0[lane] = rt;
    __syncwarp();

    // issue the next tile's loads before scanning this one
    if (t + kW < n) {
      const int tt = t + kW + lane;
      const bool t_ok = tt < n;
      rt = t_ok ? t0[tt] : T(0);
#pragma unroll
      for (int r = 0; r < kW; ++r) {
        const bool ok = t_ok && row0 + r < B;
        const size_t off = (size_t)(row0 + r) * n + tt;
        rw[r] = ok ? warm[off] : T(0);
        rc[r] = ok ? cold[off] : T(0);
      }
    }

    const int steps = min(kW, n - t);
    unsigned bits = 0u;
    if (steps == kW) {
      // full tile: unrolled, so the shared loads run ahead of the chain
#pragma unroll
      for (int k = 0; k < kW; ++k) {
        bits |= (unsigned)scan_step(s_t0[k], s_warm[k][lane], s_cold[k][lane],
                                    kw, last) << k;
      }
    } else {
      for (int k = 0; k < steps; ++k) {
        bits |= (unsigned)scan_step(s_t0[k], s_warm[k][lane], s_cold[k][lane],
                                    kw, last) << k;
      }
    }
    __syncwarp();  // shared tile reads done before the next overwrite

    const int tt = t + lane;
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      const unsigned b = __shfl_sync(0xffffffffu, bits, r);
      if (row0 + r < B && tt < n) {
        mask[(size_t)(row0 + r) * n + tt] = (uint8_t)((b >> lane) & 1u);
      }
    }
  }
}

template <typename T>
int launch(const void* t0, const void* warm, const void* cold,
           const void* keep_warm, void* mask, int B, int n,
           cudaStream_t stream) {
  const int blocks = (B + kW - 1) / kW;
  cold_scan_kernel<T><<<blocks, kW, 0, stream>>>(
      static_cast<const T*>(t0), static_cast<const T*>(warm),
      static_cast<const T*>(cold), static_cast<const T*>(keep_warm),
      static_cast<uint8_t*>(mask), B, n);
  return (int)cudaGetLastError();
}

}  // namespace

// t0 (n,), warm/cold (B, n) row-major, keep_warm (B,), all of one dtype
// (0 = float32, 1 = float64); mask (B, n) bytes of 0/1. Launches on
// `stream`, does not synchronise; returns the launch's CUDA error (0 = ok).
extern "C" int cold_scan_fwd(const void* t0, const void* warm,
                             const void* cold, const void* keep_warm,
                             void* mask, int B, int n, int dtype,
                             void* stream) {
  if (B <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(t0, warm, cold, keep_warm, mask, B, n, s);
  if (dtype == 1) return launch<double>(t0, warm, cold, keep_warm, mask, B, n, s);
  return (int)cudaErrorInvalidValue;
}
