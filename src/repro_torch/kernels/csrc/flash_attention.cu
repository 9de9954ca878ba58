// Flash attention forward for Hopper (sm_90a): online softmax, GQA, causal
// and sliding-window masks, any sequence length.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> pl.pallas_call), reached from prefill attention at
// repro/models/layers.py:193-196 when cfg.use_pallas is set. Computes the
// same function: softmax(Q K^T * scale + mask) V with query positions
// 0..T-1 and key positions 0..S-1, query head h reading kv head h / (H/K),
// masked scores at -1e30, running max / denominator / accumulator in f32,
// output acc / max(l, 1e-30) in the input type.
//
// What bounds it on an H100: at the serving path's prefill shape
// (B=1, T=S=512, H=16, K=8, d=128, bf16, causal) the function must move
// 6.3 MB (Q, K, V read once, O written once): 1.9 us at 3.35 TB/s, against
// 1.1 GFLOP of unmasked QK^T and PV products, 1.1 us at the bf16
// tensor-core peak. So it is memory-bound, but only by a factor of two: a
// kernel that left the products on the CUDA cores (67 TFLOP/s in f32)
// would be bound by them instead, at 16 us.
//
// Design: the TPU kernel walks the kv blocks as a sequential grid axis with
// the softmax state in VMEM scratch; here that axis is a loop inside one
// thread block, and blocks run in parallel over (q tile, head, batch).
// Common to both versions below:
//   * The kv loop runs only over the tiles that the causal and window masks
//     leave reachable from this q tile, so unreachable tiles are never
//     loaded (the TPU kernel still DMAs them).
//   * K and V tiles are staged in shared memory once per q tile and read by
//     all its rows, so each K/V byte leaves device memory once per q tile
//     rather than once per query.
//   * Ragged T and S are masked in the kernel: rows past T compute but do
//     not store, keys past S are masked.
//
// bfloat16 (the serving path): tensor cores through mma.sync m16n8k16
// (bf16 in, f32 accumulate). A block of 4 warps owns 64 query rows, 16 per
// warp. S = Q K^T of a 64-key tile lands in registers in the accumulator
// layout, which is also the A-operand layout of the P V product, so P never
// leaves registers: it is rounded to bf16 (as the plain version rounds p to
// v's dtype) and fed straight back. K and V tiles arrive by cp.async into
// two shared-memory buffers, so the copy of the next tile overlaps the
// products of this one; ldmatrix reads the fragments, transposing V's on
// the way. Rows are padded by 8 elements so those reads are free of bank
// conflicts. Blocks start from the last q tile, which under a causal mask
// has the most kv tiles, to even out the tail. A tile that all of a warp's
// rows see whole skips the mask.
//
// float32: the products stay on the CUDA cores in f32 (tensor cores would
// round to TF32 and miss the f32 tolerance). One block of 256 threads per
// 64-row q tile: four threads share a query row, each owning every fourth
// column of the head dimension, and a row's dot products reduce with two
// warp shuffles.
//
// wgmma, TMA, and splitting the kv loop of long rows over several blocks
// are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bfloat16: mma.sync tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_BQ = 64;               // query rows per block, 16 per warp
constexpr int MMA_BK = 64;               // keys per kv tile
constexpr int MMA_THREADS = (MMA_BQ / 16) * 32;
constexpr int PAD = 8;                   // bf16 row padding in shared memory

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register stop; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 address the rows
// of matrix i, and register i receives matrix i in mma fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major fragment) * b (16x8, column fragment)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int Tq, int S, int H, int K,
               int causal, int window, float scale) {
  constexpr int LD = D + PAD;        // row stride of every tile: [row][dim]
  constexpr int NT = MMA_BK / 8;     // key columns of S, 8 per mma tile
  constexpr int ND = D / 8;          // head-dim columns of O, 8 per mma tile
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int KV_TILE = MMA_BK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + MMA_BQ * LD;  // two K tiles, then two V tiles
  __nv_bfloat16* vs = ks + 2 * KV_TILE;

  const int tile = gridDim.x - 1 - blockIdx.x;  // most kv tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;        // fragment row group
  const int tig = tid % 4;       // thread in group: fragment column pair
  const int q0 = tile * MMA_BQ;
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  const size_t q_row = (size_t)H * D;
  for (int i = tid; i < MMA_BQ * CH; i += MMA_THREADS) {
    const int r = i / CH, c = i % CH;
    const int t = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < Tq)
      val = *reinterpret_cast<const uint4*>(
          q + ((size_t)b * Tq + t) * q_row + (size_t)h * D + c * 8);
    *reinterpret_cast<uint4*>(qs + r * LD + c * 8) = val;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};  // this thread's columns only; summed at the end

  // reachable kv range of this q tile
  const int q_hi = min(q0 + MMA_BQ, Tq) - 1;
  const int k_hi = causal ? min(S - 1, q_hi) : S - 1;
  const int k_lo = window >= 0 ? max(0, q0 - window + 1) : 0;
  const int kt_lo = k_lo / MMA_BK;
  const int kt_hi = k_hi >= 0 ? k_hi / MMA_BK : -1;

  const size_t kv_row = (size_t)K * D;
  const size_t kv_base = (size_t)b * S * kv_row + (size_t)kh * D;
  const float scale_log2 = scale * 1.4426950408889634f;  // scores in log2 units

  // K and V tiles stream through two shared-memory buffers: the copy of
  // tile kt+1 is in flight while tile kt is computed
  auto load_tile = [&](int kt, int buf) {
    const int s0 = kt * MMA_BK;
    for (int i = tid; i < MMA_BK * CH; i += MMA_THREADS) {
      const int j = i / CH, c = i % CH;
      const bool ok = s0 + j < S;
      const size_t off = ok ? kv_base + (size_t)(s0 + j) * kv_row + c * 8 : 0;
      cp_async16(ks + buf * KV_TILE + j * LD + c * 8, k + off, ok);
      cp_async16(vs + buf * KV_TILE + j * LD + c * 8, v + off, ok);
    }
    cp_async_commit();
  };
  if (kt_lo <= kt_hi) load_tile(kt_lo, 0);

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int s0 = kt * MMA_BK;
    const int buf = (kt - kt_lo) & 1;
    if (kt < kt_hi) {
      load_tile(kt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (and, the first time, qs) visible to all
    const __nv_bfloat16* kb = ks + buf * KV_TILE;
    const __nv_bfloat16* vb = vs + buf * KV_TILE;

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];  // rows +0/+8 (lanes & 8) x dims +0/+8 (lanes & 16)
      ldsm_x4(a, qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t bk[4];  // keys +0/+8 (lanes & 16) x dims +0/+8 (lanes & 8)
        ldsm_x4(bk, kb + (j * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma_bf16(sc[j], a, bk[0], bk[1]);
        mma_bf16(sc[j + 1], a, bk[2], bk[3]);
      }
    }

    // mask, scale, online softmax in base 2 (exp2 is one instruction);
    // element e of tile j is row row0 + 8*(e/2), key s0 + 8j + 2*tig + e%2.
    // A tile that every row of this warp sees whole needs no mask.
    const bool whole = s0 + MMA_BK <= S &&
                       (!causal || s0 + MMA_BK - 1 <= q0 + warp * 16) &&
                       (window < 0 || q0 + warp * 16 + 15 - s0 < window);
    float m_tile[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (!whole) {
          const int t = row0 + (e >> 1) * 8;
          const int s = s0 + j * 8 + tig * 2 + (e & 1);
          ok = s < S;
          if (causal) ok = ok && (t >= s);
          if (window >= 0) ok = ok && (t - s < window);
        }
        sc[j][e] = ok ? sc[j][e] * scale_log2 : NEG_INF;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], sc[j][e]);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's four threads hold its 64 keys
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 1));
      m_tile[r] = fmaxf(m_tile[r], __shfl_xor_sync(0xffffffffu, m_tile[r], 2));
      const float m_new = fmaxf(m[r], m_tile[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked entries hold exactly NEG_INF; no real score comes near it
        const float p = sc[j][e] > 0.5f * NEG_INF ? exp2f(sc[j][e] - m[e >> 1]) : 0.f;
        sc[j][e] = p;
        psum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V: the S accumulator of key tiles 2kk, 2kk+1 is the A fragment;
    // V's B fragments come from its row-major tile through a transposing load
#pragma unroll
    for (int kk = 0; kk < MMA_BK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                             pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                             pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                             pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bv[4];  // keys +0/+8 (lanes & 8) x dims +0/+8 (lanes & 16)
        ldsm_x4_t(bv, vb + (kk * 16 + (lane & 15)) * LD + (n + (lane >> 4)) * 8);
        mma_bf16(acc[n], a, bv[0], bv[1]);
        mma_bf16(acc[n + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before its refill
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + r * 8;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + ((size_t)b * Tq + t) * q_row + (size_t)h * D + tig * 2;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int F32_BQ = 64;   // query rows per block
constexpr int TPR = 4;       // threads per query row
constexpr int F32_THREADS = F32_BQ * TPR;

template <int D, int BK>
__global__ void __launch_bounds__(F32_THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int Tq,
              int S, int H, int K, int causal, int window, float scale) {
  constexpr int DC = D / TPR;  // head-dim columns owned by one thread
  extern __shared__ float smem[];
  float* ks = smem;            // [BK][D]
  float* vs = smem + BK * D;   // [BK][D]

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int q0 = tile * F32_BQ;
  const int t = q0 + row;

  // this thread's q slice: columns part, part + 4, part + 8, ...
  float qr[DC];
  float acc[DC];
  const size_t q_off = ((size_t)b * Tq + t) * H * D + (size_t)h * D;
#pragma unroll
  for (int c = 0; c < DC; ++c) {
    qr[c] = t < Tq ? q[q_off + c * TPR + part] : 0.f;
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
    for (int i = tid; i < BK * D; i += F32_THREADS) {
      const int j = i / D;
      const int c = i % D;
      const int s = s0 + j;
      float kv_k = 0.f, kv_v = 0.f;
      if (s < S) {
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
      for (int c = 0; c < DC; ++c) dot += qr[c] * ks[j * D + c * TPR + part];
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
      for (int c = 0; c < DC; ++c) acc[c] += p * vs[j * D + c * TPR + part];
    }
    m = m_new;
  }

  if (t < Tq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) o[q_off + c * TPR + part] = acc[c] * inv;
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Tq, int S, int H, int K, int causal,
                        int window, float scale, cudaStream_t stream) {
  const size_t smem = (MMA_BQ + 4 * MMA_BK) * (D + PAD) * sizeof(__nv_bfloat16);
  auto kern = flash_fwd_bf16<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + MMA_BQ - 1) / MMA_BQ, H, B);
  kern<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Tq,
      S, H, K, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Tq, int S, int H, int K, int causal,
                       int window, float scale, cudaStream_t stream) {
  constexpr int BK = D > 128 ? 32 : 64;
  const size_t smem = 2 * BK * D * sizeof(float);
  auto kern = flash_fwd_f32<D, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + F32_BQ - 1) / F32_BQ, H, B);
  kern<<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Tq, S, H, K,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

#define FLASH_DISPATCH_D(fn, D, ...)           \
  switch (D) {                                 \
    case 16: return (int)fn<16>(__VA_ARGS__);  \
    case 32: return (int)fn<32>(__VA_ARGS__);  \
    case 64: return (int)fn<64>(__VA_ARGS__);  \
    case 128: return (int)fn<128>(__VA_ARGS__); \
    case 256: return (int)fn<256>(__VA_ARGS__); \
    default: return (int)cudaErrorInvalidValue; \
  }

// q: (B, Tq, H, D), k/v: (B, S, K, D), o: (B, Tq, H, D), all contiguous.
// dtype: 0 = float32, 1 = bfloat16. window < 0 means no window.
// Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Tq, int S, int H, int K,
                                   int D, int causal, int window, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_DISPATCH_D(launch_f32, D, q, k, v, o, B, Tq, S, H, K, causal, window, scale, st)
  }
  if (dtype == 1) {
    FLASH_DISPATCH_D(launch_bf16, D, q, k, v, o, B, Tq, S, H, K, causal, window, scale, st)
  }
  return (int)cudaErrorInvalidValue;
}
