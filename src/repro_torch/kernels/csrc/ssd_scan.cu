// Mamba-2 SSD chunk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::ssd_scan,
// reached from prefill at src/repro/models/ssm.py:159-161 when
// cfg.use_pallas is set. Shapes: x (B, L, H, P), dt (B, L, H), A_log (H,),
// B and C (B, L, N), L a multiple of the chunk Q. Per (batch, head), with
// a = -exp(A_log[h]) and, within each chunk, cum_t = sum_{s<=t} a dt_s:
//
//   y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s  +  exp(cum_t) C_t . h
//   h  <- h exp(cum_{Q-1}) + sum_s exp(cum_{Q-1} - cum_s) dt_s B_s x_s^T
//
// with h (P x N) in float32 from zero, carried across chunks; y in x's type,
// the final h as float32 (B, H, P, N). x, B, C are float32 or bfloat16 (one
// type); dt and A_log arrive as float32 (the wrapper casts, exactly). All
// products are float32 on the CUDA cores, as the TPU kernel accumulates in
// f32 (preferred_element_type).
//
// What bounds it on an H100: operations. At mamba2-370m's prefill shape
// (B = 1, L = 512, H = 32, P = 64, N = 128, Q = 256, bf16) the function
// moves 5.5 MB (1.7 us at 3.35 TB/s) and needs, per chunk, the causal halves
// of C B^T (8.4 MFLOP, shared by the heads) and of the intra-chunk product
// (135 MFLOP), the state update (134) and the inter-chunk term (134):
// 0.82 GFLOP per launch, 12.3 us at 67 TFLOP/s in f32.
//
// Design: the TPU kernel's grid runs (batch, head block, chunk) with the
// chunk axis sequential and the state in VMEM scratch. Here a block owns
// one (batch, head, tile of kPT rows of P): y[t, p] and h[p, :] depend only
// on their own p, so P splits across blocks (128 blocks at the shape
// above, rather than 32 with whole heads). The block loops over the chunks
// itself, the state tile (kPT x N f32, 8 KB) in shared memory. Per chunk:
//   * dt_s and a block-wide inclusive scan of a dt_s into shared memory,
//     summed in float64 and rounded once, as the plain version does: cum
//     reaches 1e3 and more, where an ulp of float32 sums taken in another
//     order would become a relative error of every decay exp(cum_t - cum_s)
//     (3% of the logits of mamba2-370m at full width, bf16);
//   * for each tile of kT rows t: C's rows staged in f32; the inter-chunk
//     term from the state; then for each tile of kT columns s <= t: B's
//     rows and x's tile staged, the kT x kT tile of G = (C B^T) masked,
//     decayed and scaled by dt computed on the fly (s <= t only, before
//     the exp), and accumulated into y. G is never staged whole (a Q x Q
//     f32 G is 256 KB, over the 227 KB a block may use);
//   * the state update over tiles of kT s, after every t has read the old
//     state, from x pre-scaled by exp(cum_{Q-1} - cum_s) dt_s.
// Every product is register-tiled: a thread computes a 4 x 4 block of G
// (its C and B rows strided by 16, so the float4 reads of a quarter-warp
// land in distinct banks), 4 rows of y and of the inter-chunk term, and a
// 2 x 4 block of the state. Rows are padded to N + 4 and global rows are
// read 16 bytes a thread. Each block recomputes the causal half of C B^T
// for its head and P tile, 8x the work of the products it feeds at
// kPT = 16: the price of 4x more blocks. Tensor cores (the products are
// matrix products), sharing C B^T across heads and overlapping the staging
// loads with the products are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 16;  // rows of P per block
constexpr int kT = 64;   // rows t and columns s per tile
constexpr int kLdg = kT + 4;

// 16 bytes of global memory as float32 in shared memory
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int W = 4;
  __device__ static void load(const float* src, float* dst) {
    *reinterpret_cast<float4*>(dst) = __ldg(reinterpret_cast<const float4*>(src));
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ static void load(const __nv_bfloat16* src, float* dst) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
    const float2 a = __bfloat1622float2(h2[0]), b = __bfloat1622float2(h2[1]);
    const float2 c = __bfloat1622float2(h2[2]), d = __bfloat1622float2(h2[3]);
    reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
    reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
  }
};

template <int W>
__device__ __forceinline__ void zero_vec(float* dst) {
#pragma unroll
  for (int k = 0; k < W / 4; ++k)
    reinterpret_cast<float4*>(dst)[k] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch casts
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [row0, row0 + rows) of a (., N) matrix into dst[kT][ld] as f32,
// 16 bytes a thread; the rest of the kT rows are zero
template <typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* __restrict__ src,
                                           size_t row0, int rows, int N, int ld) {
  constexpr int W = Vec<T>::W;
  const int cpr = N / W;
  for (int i = threadIdx.x; i < kT * cpr; i += kThreads) {
    const int r = i / cpr, c = i - r * cpr;
    float* d = dst + r * ld + c * W;
    if (r < rows) Vec<T>::load(src + (row0 + r) * N + c * W, d);
    else zero_vec<W>(d);
  }
}

// x[b, l0 + s0 + s, h, p0 + p] for s < kT, p < kPT into dst[kT][kPT]
template <typename T>
__device__ __forceinline__ void stage_x(float* dst, const T* __restrict__ x,
                                        size_t bl0, int s0, int Q, int H, int h,
                                        int P, int p0) {
  constexpr int W = Vec<T>::W;
  constexpr int cpr = kPT / W;
  for (int i = threadIdx.x; i < kT * cpr; i += kThreads) {
    const int sl = i / cpr, c = i - sl * cpr;
    const int s = s0 + sl, p = p0 + c * W;
    float* d = dst + sl * kPT + c * W;
    if (s < Q && p < P) Vec<T>::load(x + ((bl0 + s) * H + h) * P + p, d);
    else zero_vec<W>(d);
  }
}

size_t smem_floats(int N, int Q) {
  return 2 * kWarps                   // scan scratch (kWarps doubles)
         + 2 * (size_t)kT * (N + 4)   // C and B tiles
         + (size_t)kPT * (N + 4)      // state tile
         + kT * kPT                   // x tile
         + kT * kLdg                  // G tile, transposed: [s][t]
         + kT                         // state weights
         + 2 * (size_t)Q;             // cum, dt
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state, int L, int H, int P, int N, int Q) {
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 4;  // row stride of C, B and the state
  double* red = reinterpret_cast<double*>(smem);
  float* cs = smem + 2 * kWarps;
  float* bs = cs + kT * ld;
  float* hs = bs + kT * ld;
  float* xs = hs + kPT * ld;
  float* gT = xs + kT * kPT;
  float* ws = gT + kT * kLdg;
  float* cum = ws + kT;
  float* dts = cum + Q;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, bat = blockIdx.z;
  const float a = -expf(A_log[h]);
  const int nc = L / Q;
  const int n4s = N / 4;
  // G block of this thread: rows tg + 16 i, columns sg + 16 j
  const int tg = tid / 16, sg = tid % 16;
  // y and inter-chunk outputs of this thread: rows tq * 4 + i, column pl
  const int tq = tid / kPT, pl = tid % kPT;

  for (int i = tid; i < kPT * ld; i += kThreads) hs[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const size_t bl0 = (size_t)bat * L + (size_t)c * Q;  // first row of the chunk

    // dt and cum = inclusive scan of a * dt over the chunk, summed in f64
    // and rounded once: the plain version's float32 values whatever the
    // order of the sums
    double carry = 0.0;
    for (int base = 0; base < Q; base += kThreads) {
      const int s = base + tid;
      float d = 0.f;
      if (s < Q) {
        d = dt[(bl0 + s) * H + h];
        dts[s] = d;
      }
      double v = (double)(a * d);
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double n = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += n;
      }
      if (lane == 31) red[warp] = v;
      __syncthreads();
      if (warp == 0) {
        double wv = lane < kWarps ? red[lane] : 0.0;
#pragma unroll
        for (int off = 1; off < kWarps; off <<= 1) {
          const double n = __shfl_up_sync(0xffffffffu, wv, off);
          if (lane >= off) wv += n;
        }
        if (lane < kWarps) red[lane] = wv;
      }
      __syncthreads();
      v += carry + (warp > 0 ? red[warp - 1] : 0.0);
      if (s < Q) cum[s] = (float)v;
      carry += red[kWarps - 1];
      __syncthreads();
    }

    // y, one tile of kT rows t at a time
    for (int t0 = 0; t0 < Q; t0 += kT) {
      stage_rows(cs, Cm, bl0 + t0, min(kT, Q - t0), N, ld);
      __syncthreads();

      // inter-chunk term: exp(cum_t) C_t . h[p, :]
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      {
        const float4* hrow = reinterpret_cast<const float4*>(hs + pl * ld);
        for (int n4 = 0; n4 < n4s; ++n4) {
          const float4 hv = hrow[n4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i] = dot4(reinterpret_cast<const float4*>(cs + (tq * 4 + i) * ld)[n4],
                          hv, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + tq * 4 + i;
          acc[i] = t < Q ? acc[i] * expf(cum[t]) : 0.f;
        }
      }

      // intra-chunk term over the tiles of s <= t
      for (int s0 = 0; s0 <= t0; s0 += kT) {
        stage_rows(bs, Bm, bl0 + s0, min(kT, Q - s0), N, ld);
        stage_x(xs, x, bl0, s0, Q, H, h, P, p0);
        __syncthreads();

        {
          float cb[4][4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
          for (int n4 = 0; n4 < n4s; ++n4) {
            float4 cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              cv[i] = reinterpret_cast<const float4*>(cs + (tg + 16 * i) * ld)[n4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bv[j] = reinterpret_cast<const float4*>(bs + (sg + 16 * j) * ld)[n4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) cb[i][j] = dot4(cv[i], bv[j], cb[i][j]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int tl = tg + 16 * i, t = t0 + tl;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int sl = sg + 16 * j, s = s0 + sl;
              float gv = 0.f;
              if (t < Q && s <= t) gv = cb[i][j] * expf(cum[t] - cum[s]) * dts[s];
              gT[sl * kLdg + tl] = gv;
            }
          }
        }
        __syncthreads();

#pragma unroll 8
        for (int sl = 0; sl < kT; ++sl) {
          const float xv = xs[sl * kPT + pl];
          const float4 g4 = *reinterpret_cast<const float4*>(gT + sl * kLdg + tq * 4);
          acc[0] = fmaf(g4.x, xv, acc[0]);
          acc[1] = fmaf(g4.y, xv, acc[1]);
          acc[2] = fmaf(g4.z, xv, acc[2]);
          acc[3] = fmaf(g4.w, xv, acc[3]);
        }
        __syncthreads();  // before the next tile overwrites bs, xs, gT (and cs)
      }

      const int p = p0 + pl;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + tq * 4 + i;
        if (t < Q && p < P) y[((bl0 + t) * H + h) * P + p] = from_f32<T>(acc[i]);
      }
    }

    // state update, after every row t has read the old state
    const float cum_end = cum[Q - 1];
    const float decay = expf(cum_end);
    for (int i = tid; i < kPT * N; i += kThreads) {
      const int pp = i / N, n = i - pp * N;
      hs[pp * ld + n] *= decay;
    }
    for (int s0 = 0; s0 < Q; s0 += kT) {
      stage_rows(bs, Bm, bl0 + s0, min(kT, Q - s0), N, ld);
      stage_x(xs, x, bl0, s0, Q, H, h, P, p0);
      if (tid < kT) {
        const int s = s0 + tid;
        ws[tid] = s < Q ? expf(cum_end - cum[s]) * dts[s] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < kT * kPT; i += kThreads) xs[i] *= ws[i / kPT];
      __syncthreads();
      // a 2 x 4 block of the state per work item: rows 2 pq, 2 pq + 1,
      // columns 4 nq .. 4 nq + 3
      for (int w = tid; w < (kPT / 2) * n4s; w += kThreads) {
        const int pq = w / n4s, nq = w - pq * n4s;
        float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
#pragma unroll 8
        for (int sl = 0; sl < kT; ++sl) {
          const float2 wx = *reinterpret_cast<const float2*>(xs + sl * kPT + 2 * pq);
          const float4 bv = reinterpret_cast<const float4*>(bs + sl * ld)[nq];
          a0.x = fmaf(wx.x, bv.x, a0.x); a0.y = fmaf(wx.x, bv.y, a0.y);
          a0.z = fmaf(wx.x, bv.z, a0.z); a0.w = fmaf(wx.x, bv.w, a0.w);
          a1.x = fmaf(wx.y, bv.x, a1.x); a1.y = fmaf(wx.y, bv.y, a1.y);
          a1.z = fmaf(wx.y, bv.z, a1.z); a1.w = fmaf(wx.y, bv.w, a1.w);
        }
        float4* h0 = reinterpret_cast<float4*>(hs + (2 * pq) * ld) + nq;
        float4* h1 = reinterpret_cast<float4*>(hs + (2 * pq + 1) * ld) + nq;
        float4 v0 = *h0, v1 = *h1;
        v0.x += a0.x; v0.y += a0.y; v0.z += a0.z; v0.w += a0.w;
        v1.x += a1.x; v1.y += a1.y; v1.z += a1.z; v1.w += a1.w;
        *h0 = v0;
        *h1 = v1;
      }
      __syncthreads();
    }
  }

  for (int i = tid; i < kPT * N; i += kThreads) {
    const int pp = i / N, n = i - pp * N;
    const int p = p0 + pp;
    if (p < P) state[(((size_t)bat * H + h) * P + p) * N + n] = hs[pp * ld + n];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, void* y, void* state, int B, int L, int H, int P,
           int N, int Q, cudaStream_t stream) {
  constexpr int W = Vec<T>::W;
  if (N % W != 0 || P % W != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
       reinterpret_cast<uintptr_t>(Cm)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const size_t bytes = smem_floats(N, Q) * sizeof(float);
  if (bytes > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<float*>(state),
      L, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, L, H, P); B, C: (B, L, N), all of one type (0 = float32,
// 1 = bfloat16), 16-byte aligned, N and P multiples of 16 bytes' worth of
// elements (4 in f32, 8 in bf16); dt (B, L, H) and A_log (H,) float32;
// state (B, H, P, N) float32; L % Q == 0. Launches on `stream`, does not
// synchronise; returns the launch's CUDA error (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A_log,
                            const void* Bm, const void* Cm, void* y, void* state,
                            int B, int L, int H, int P, int N, int Q, int dtype,
                            void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (Q <= 0 || L % Q != 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A_log, Bm, Cm, y, state, B, L, H, P, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, y, state, B, L, H, P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
