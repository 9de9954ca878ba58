// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan,
// reached from prefill at src/repro/models/griffin.py:103-105 when
// cfg.use_pallas is set. Per channel w of batch row b, from h = 0:
//
//     h_t = exp(log_a_t) * h_{t-1} + b_t,   y_t = h_t,   h_last = h_{T-1}
//
// log_a, b, y are (B, T, W) row-major float32; h_last is (B, W). Unlike the
// TPU kernel, T need not be a multiple of a chunk.
//
// What bounds it on an H100: bytes. At recurrentgemma-9b's prefill shape
// (B = 1, T = 512, W = 4096) the function reads log_a and b once and writes
// y once, 25.2 MB: 7.5 us at 3.35 TB/s, against 3 operations and one exp per
// element. The recurrence is sequential in time, so one thread per channel
// gives only B * W / 32 warps (128 at that shape, about one per SM), each
// with one step's loads in flight: the latency-bound shape that left the
// cold-start scan at 7x its bound.
//
// Design: time splits into kChunks chunks, using the associativity of
// (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2). A block owns 32 neighbouring
// channels (one warp wide, so every load of a warp reads 128 contiguous
// bytes) and all kChunks chunks of them, one warp per chunk:
//   1. each thread walks its chunk from h = 0 and keeps the chunk's decay
//      product and end state;
//   2. one warp carries the state across the kChunks chunks in shared
//      memory (kChunks steps per channel) and writes h_last;
//   3. each thread walks its chunk again from its carried start state and
//      writes y. The second read of log_a and b comes from L2 (a block
//      reads them twice within microseconds; 16.8 MB at that shape).
// Each walk loads kAhead steps into registers before the dependent chain,
// so a warp keeps 2 * kAhead loads in flight: 16 warps per SM, 32 KB.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kLanes = 32;   // channels per block
constexpr int kChunks = 16;  // time chunks per block, one warp each
constexpr int kAhead = 8;    // time steps loaded ahead of the chain

__global__ void __launch_bounds__(kLanes * kChunks)
rglru_scan_kernel(const float* __restrict__ log_a, const float* __restrict__ b,
                  float* __restrict__ y, float* __restrict__ h_last, int T, int W) {
  __shared__ float s_a[kChunks][kLanes];  // decay product of each chunk
  __shared__ float s_h[kChunks][kLanes];  // end state from h = 0, then start state

  const int lane = threadIdx.x;
  const int c = threadIdx.y;
  const int w = blockIdx.x * kLanes + lane;
  const int row = blockIdx.y;
  const bool ok = w < W;
  const int len = (T + kChunks - 1) / kChunks;
  const int t0 = min(T, c * len);
  const int t1 = min(T, t0 + len);
  const size_t base = (size_t)row * T * W + w;

  // 1. the chunk from h = 0 (padding steps load a = 1, b = 0: no change)
  float A = 1.f, h = 0.f;
  if (ok) {
    for (int t = t0; t < t1; t += kAhead) {
      float la[kAhead], bb[kAhead];
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const bool in = t + u < t1;
        la[u] = in ? log_a[base + (size_t)(t + u) * W] : 0.f;
        bb[u] = in ? b[base + (size_t)(t + u) * W] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        const float a = expf(la[u]);
        h = fmaf(a, h, bb[u]);
        A *= a;
      }
    }
  }
  s_a[c][lane] = A;
  s_h[c][lane] = h;
  __syncthreads();

  // 2. carry the state across the chunks
  if (c == 0) {
    float hin = 0.f;
    for (int k = 0; k < kChunks; ++k) {
      const float hk = s_h[k][lane];
      s_h[k][lane] = hin;
      hin = fmaf(s_a[k][lane], hin, hk);
    }
    if (ok) h_last[(size_t)row * W + w] = hin;
  }
  __syncthreads();
  if (!ok) return;

  // 3. the chunk again from its start state, writing every h
  h = s_h[c][lane];
  for (int t = t0; t < t1; t += kAhead) {
    float la[kAhead], bb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const bool in = t + u < t1;
      la[u] = in ? log_a[base + (size_t)(t + u) * W] : 0.f;
      bb[u] = in ? b[base + (size_t)(t + u) * W] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (t + u < t1) {
        h = fmaf(expf(la[u]), h, bb[u]);
        y[base + (size_t)(t + u) * W] = h;
      }
    }
  }
}

}  // namespace

// log_a, b, y: (B, T, W) float32 row-major; h_last: (B, W) float32.
// Launches on `stream`, does not synchronise; returns the launch's CUDA
// error (0 = ok).
extern "C" int rglru_scan_fwd(const void* log_a, const void* b, void* y,
                              void* h_last, int B, int T, int W, void* stream) {
  if (B <= 0 || T <= 0 || W <= 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + kLanes - 1) / kLanes, B);
  const dim3 block(kLanes, kChunks);
  rglru_scan_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(log_a), static_cast<const float*>(b),
      static_cast<float*>(y), static_cast<float*>(h_last), T, W);
  return (int)cudaGetLastError();
}
