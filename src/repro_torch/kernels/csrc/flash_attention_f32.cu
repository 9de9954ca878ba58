// Flash attention forward for Hopper (sm_90a) in float32, at every head
// dim that is a multiple of 16 up to 256. The same function as
// flash_attention.cu, which describes it and what bounds it; the TPU
// kernel it replaces, repro/kernels/flash_attention.py (flash_attention ->
// pl.pallas_call), spans the whole head dim in one block, so it takes all
// of these.
//
// The products stay on the CUDA cores in f32 (tensor cores would round to
// TF32 and miss the f32 tolerance). One block of 256 threads per 64-row q
// tile: four threads share a query row, each owning every fourth column of
// the head dimension (d / 4 columns), and a row's dot products reduce with
// two warp shuffles. The head dim is a run-time argument up to the
// instantiation's DMAX (64, 128 or 256): the shared-memory K/V rows and a
// thread's q slice are DMAX wide, zeros past d, so the unrolled products
// keep compile-time strides and no branch (the zero columns add exact
// zeros: the sums of a d are those of its own instantiation). One
// instantiation for every multiple of 16 took 152 s of nvcc on the H100
// machine.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int F32_BQ = 64;   // query rows per block
constexpr int TPR = 4;       // threads per query row
constexpr int F32_THREADS = F32_BQ * TPR;

template <int DMAX, int BK>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq,
              int S, int H, int K, int D, int causal, int window, float scale) {
  constexpr int DC = DMAX / TPR;  // head-dim columns owned by one thread
  extern __shared__ float smem[];
  float* ks = smem;               // [BK][DMAX], zeros past D
  float* vs = smem + BK * DMAX;   // [BK][DMAX], zeros past D

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int q0 = tile * F32_BQ;
  const int t = q0 + row;

  // this thread's q slice: columns part, part + 4, part + 8, ... (zeros
  // past D, as the tiles' columns are)
  float qr[DC];
  float acc[DC];
  const size_t q_off = ((size_t)b * Tq + t) * H * D + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    qr[c] = t < Tq && c * TPR + part < D ? q[q_off + c * TPR + part] : 0.f;
    acc[c] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  // reachable kv range of this q tile
  const int q_hi = min(q0 + F32_BQ, Tq) - 1;
  const int k_hi = causal ? min(S - 1, q_hi) : S - 1;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_lo / BK;
  const int kt_hi = k_hi >= 0 ? k_hi / BK : -1;

  const size_t kv_row = (size_t)K * D;  // stride between kv positions
  const size_t kv_base = (size_t)b * S * kv_row + (size_t)kh * D;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int s0 = kt * BK;
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * DMAX; i += F32_THREADS) {
      const int j = i / DMAX;
      const int c = i % DMAX;
      const int s = s0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (s < S && c < D) {
        const size_t off = kv_base + (size_t)s * kv_row + c;
        kv_k = k[off];
        kv_v = v[off];
      }
      ks[i] = kv_k;
      vs[i] = kv_v;
    }
    __syncthreads();

    float sc[BK];
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DC; ++c) dot += qr[c] * ks[j * DMAX + c * TPR + part];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int s = s0 + j;
      bool ok = s < S;
      if (causal) ok = ok && (t >= s);
      if (window >= 0) ok = ok && (t - s < window);
      sc[j] = ok ? dot * scale : NEG_INF;
      m_tile = fmaxf(m_tile, sc[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      // masked entries hold exactly NEG_INF; no real score comes near it
      const float p = sc[j] > 0.5f * NEG_INF ? expf(sc[j] - m_new) : 0.f;
      sc[j] = p;
      psum += p;
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = sc[j];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[c] += p * vs[j * DMAX + c * TPR + part];
    }
    m = m_new;
  }

  if (t < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      if (c * TPR + part < D) o[q_off + c * TPR + part] = acc[c] * inv;
  }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Tq, int S, int H, int K, int D, int causal,
                       int window, float scale, cudaStream_t stream) {
  constexpr int BK = DMAX > 128 ? 32 : 64;
  constexpr size_t smem = 2 * BK * DMAX * sizeof(float);
  static SmemAttr attr;
  cudaError_t err = attr.ensure((const void*)flash_fwd_f32<DMAX, BK>);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + F32_BQ - 1) / F32_BQ, H, B);
  flash_fwd_f32<DMAX, BK><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, S, H, K, D,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q: (B, Tq, H, D), k/v: (B, S, K, D), o: (B, Tq, H, D), float32, all
// contiguous, D a multiple of 16 up to 256. window < 0 means no window.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_f32_fwd(const void* q, const void* k, const void* v,
                                       void* o, int B, int Tq, int S, int H,
                                       int K, int D, int causal, int window,
                                       float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || K <= 0 || H % K != 0 || D <= 0 || D % 16 ||
      D > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64)
    return (int)launch_f32<64>(q, k, v, o, B, Tq, S, H, K, D, causal, window, scale, st);
  if (D <= 128)
    return (int)launch_f32<128>(q, k, v, o, B, Tq, S, H, K, D, causal, window, scale, st);
  return (int)launch_f32<256>(q, k, v, o, B, Tq, S, H, K, D, causal, window, scale, st);
}
