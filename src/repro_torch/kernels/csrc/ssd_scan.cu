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
// type); dt and A_log arrive as float32 (the wrapper casts, exactly). Every
// product accumulates in f32, as the TPU kernel's (preferred_element_type).
//
// What bounds it on an H100: operations. At mamba2-370m's prefill shape
// (B = 1, L = 512, H = 32, P = 64, N = 128, Q = 256, bf16) the function
// moves 5.5 MB (1.7 us at 3.35 TB/s) and needs, per chunk, the causal halves
// of C B^T (8.4 MFLOP, shared by the heads) and of the intra-chunk product
// (135 MFLOP), the state update (134) and the inter-chunk term (134, none
// in the first chunk): 0.54-0.69 GFLOP per launch, 8-10 us at 67 TFLOP/s
// in f32.
//
// Design: two kernels a call.
//   1. C B^T once per (batch, chunk), for every head: one block per 64 x 64
//      tile of the causal half writes the f32 tile to a scratch of (B,
//      chunks, Qp, Qp) floats (Qp = Q rounded up to 64; 512 KB at the shape
//      above, L2-resident) that the wrapper allocates. In bfloat16 the tile
//      is mma.sync m16n8k16 (bf16 in, f32 accumulate): products of bf16 are
//      exact in f32, so only the order of the f32 sums differs from the
//      CUDA cores'. N is staged 64 columns at a time, zero-padded to the
//      mma's depth of 16 (N = 8 in the JAX package's kernel tests). In
//      float32 the tile stays on the CUDA cores (never TF32), 4 x 4 outputs
//      a thread, summed over N in order.
//   2. The scan. The TPU kernel's grid runs (batch, head block, chunk) with
//      the chunk axis sequential and the state in VMEM scratch. Here a block
//      owns one (batch, head, tile of kPT rows of P): y[t, p] and h[p, :]
//      depend only on their own p, so P splits across blocks (128 blocks at
//      the shape above). The block loops over the chunks itself, the state
//      tile (kPT x N f32) in shared memory. Per chunk:
//      * dt_s and a block-wide inclusive scan of a dt_s into shared memory,
//        summed in float64 and rounded once, as the plain version does: cum
//        reaches 1e3 and more, where an ulp of float32 sums taken in another
//        order would become a relative error of every decay exp(cum_t -
//        cum_s) (3% of the logits of mamba2-370m at full width, bf16);
//      * for each tile of kT rows t: from the second chunk on, the
//        inter-chunk term from C's rows and the state; then for each tile
//        of kT columns s <= t: the C B^T tile read from the scratch,
//        masked (s <= t only, before the exp: a masked difference becomes
//        -1e30, so no branch and no positive exponent), decayed and scaled
//        by dt into G, and G x accumulated into y;
//      * the state update over tiles of kT s, after every t has read the
//        old state, from x weighted by exp(cum_{Q-1} - cum_s) dt_s.
//      Each step's tiles (C rows for the inter-chunk term; C B^T and x for
//      a (t, s) step; B and x for a state step) arrive by cp.async into a
//      ring of two slots in their input type: step k+1's loads are in
//      flight while step k computes. The first step of a chunk is issued
//      before its scan.
//      Products are register-tiled f32 on the CUDA cores, each split over
//      two halves of the block along s (or n for the inter-chunk term) to
//      get more multiply-adds per shared-memory load: a thread owns 4 rows
//      t x 2 columns p of y (8 per 2 loads) and a 4 x 4 block of the state
//      (16 per 2 loads); the halves' sums meet in shared memory.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 16;  // rows of P per block
constexpr int kT = 64;   // rows t and columns s per tile
constexpr int kLdg = kT + 4;  // row stride of G, transposed
constexpr int kLdc = kT + 4;  // row stride of a C B^T tile (16-byte rows)
constexpr int kKC = 64;  // columns of N staged at a time by the bf16 C B^T pass
constexpr int kKC32 = 32;  // the same for the f32 pass
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
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 address the rows
// of matrix i, and register i receives matrix i in mma fragment layout
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
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

template <typename T>
constexpr int kVec = 16 / sizeof(T);  // elements in 16 bytes

// one element, and four consecutive elements, of a shared-memory tile in
// its input type, as float32
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
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

// (t tile, s tile) of the i-th tile of a causal half, t-major
__device__ __host__ __forceinline__ void pair_of(int i, int& ti, int& si) {
  ti = 0;
  while (i >= (ti + 1) * (ti + 2) / 2) ++ti;
  si = i - ti * (ti + 1) / 2;
}

// ---------------------------------------------------------------------------
// pass 1: C B^T, one 64 x 64 tile of a chunk's causal half a block
// ---------------------------------------------------------------------------
// bfloat16: mma.sync; warp w computes rows 16 (w % 4) .. + 15 and columns
// 32 (w / 4) .. + 31 of the tile
__global__ void __launch_bounds__(kThreads)
ssd_cb_bf16(const __nv_bfloat16* __restrict__ Bm, const __nv_bfloat16* __restrict__ Cm,
            float* __restrict__ cb, int L, int N, int Q, int Qp) {
  constexpr int LD = kKC + 8;  // 144-byte rows: ldmatrix free of bank conflicts
  __shared__ __align__(16) __nv_bfloat16 cs[kT * LD];
  __shared__ __align__(16) __nv_bfloat16 bs[kT * LD];
  int ti, si;
  pair_of(blockIdx.x, ti, si);
  const int c = blockIdx.y, bat = blockIdx.z, nc = L / Q;
  const int t0 = ti * kT, s0 = si * kT;
  const size_t bl0 = (size_t)bat * L + (size_t)c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = (warp % 4) * 16, wc = (warp / 4) * 32;
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kKC) {
    for (int i = tid; i < kT * (kKC / 8); i += kThreads) {
      const int r = i / (kKC / 8), col = n0 + (i % (kKC / 8)) * 8;
      uint4 cv = make_uint4(0, 0, 0, 0), bv = cv;  // zero past Q and past N
      if (col < N && t0 + r < Q)
        cv = __ldg(reinterpret_cast<const uint4*>(Cm + (bl0 + t0 + r) * N + col));
      if (col < N && s0 + r < Q)
        bv = __ldg(reinterpret_cast<const uint4*>(Bm + (bl0 + s0 + r) * N + col));
      *reinterpret_cast<uint4*>(cs + r * LD + (col - n0)) = cv;
      *reinterpret_cast<uint4*>(bs + r * LD + (col - n0)) = bv;
    }
    __syncthreads();
    const int ksteps = (min(kKC, N - n0) + 15) / 16;
    for (int kk = 0; kk < ksteps; ++kk) {
      uint32_t a[4];  // rows +0/+8 (lanes & 8) x columns +0/+8 (lanes & 16)
      ldsm_x4(a, cs + (wr + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];  // s +0/+8 (lanes & 16) x columns +0/+8 (lanes & 8)
        ldsm_x4(b, bs + (wc + j * 8 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();
  }
  // element e of n-tile j: row wr + lane/4 + 8 (e/2), column wc + 8 j + 2 (lane%4) + e%2
  float* out = cb + (((size_t)bat * nc + c) * Qp + t0) * Qp + s0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(out + (size_t)(wr + lane / 4 + 8 * h) * Qp + wc + 8 * j +
                                 2 * (lane % 4)) = make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
}

// float32: CUDA cores, a 4 x 4 block of the tile a thread (rows tg + 16 i,
// columns sg + 16 j), summed over N in order
__global__ void __launch_bounds__(kThreads)
ssd_cb_f32(const float* __restrict__ Bm, const float* __restrict__ Cm,
           float* __restrict__ cb, int L, int N, int Q, int Qp) {
  constexpr int LD = kKC32 + 4;
  __shared__ __align__(16) float cs[kT * LD];
  __shared__ __align__(16) float bs[kT * LD];
  int ti, si;
  pair_of(blockIdx.x, ti, si);
  const int c = blockIdx.y, bat = blockIdx.z, nc = L / Q;
  const int t0 = ti * kT, s0 = si * kT;
  const size_t bl0 = (size_t)bat * L + (size_t)c * Q;
  const int tid = threadIdx.x, tg = tid / 16, sg = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int n0 = 0; n0 < N; n0 += kKC32) {
    for (int i = tid; i < kT * (kKC32 / 4); i += kThreads) {
      const int r = i / (kKC32 / 4), col = n0 + (i % (kKC32 / 4)) * 4;
      float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
      if (col < N && t0 + r < Q)
        cv = __ldg(reinterpret_cast<const float4*>(Cm + (bl0 + t0 + r) * N + col));
      if (col < N && s0 + r < Q)
        bv = __ldg(reinterpret_cast<const float4*>(Bm + (bl0 + s0 + r) * N + col));
      *reinterpret_cast<float4*>(cs + r * LD + (col - n0)) = cv;
      *reinterpret_cast<float4*>(bs + r * LD + (col - n0)) = bv;
    }
    __syncthreads();
    const int n4s = (min(kKC32, N - n0) + 3) / 4;
    for (int n4 = 0; n4 < n4s; ++n4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cv[i] = reinterpret_cast<const float4*>(cs + (tg + 16 * i) * LD)[n4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = reinterpret_cast<const float4*>(bs + (sg + 16 * j) * LD)[n4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = dot4(cv[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = cb + (((size_t)bat * nc + c) * Qp + t0) * Qp + s0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(size_t)(tg + 16 * i) * Qp + sg + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------------
// pass 2: the scan
// ---------------------------------------------------------------------------
// shared memory before the ring, in floats
__host__ __device__ __forceinline__ size_t scan_floats(int N, int Q) {
  const size_t n = 2 * kWarps                 // scan scratch (kWarps doubles)
                   + (size_t)kPT * (N + 4)     // state tile
                   + kT * kLdg                 // G tile [s][t], or weighted x [s][p]
                   + kT * kPT                  // the s halves' partial y
                   + 2 * (size_t)Q;            // cum, dt
  return (n + 3) / 4 * 4;                      // the ring starts 16-byte aligned
}

// one ring slot: a (t, s) step's C B^T tile (f32, kT x kLdc) or the C or B
// rows of an inter-chunk or state step (kT x (N + W) in the input type),
// then, at tile_bytes, the step's x tile (kT x kPT in the input type)
template <typename T>
__host__ __device__ __forceinline__ size_t tile_bytes(int N) {
  const size_t cb_tile = (size_t)kT * kLdc * 4;
  const size_t b_tile = (size_t)kT * (N + 16 / sizeof(T)) * sizeof(T);
  return cb_tile > b_tile ? cb_tile : b_tile;
}
template <typename T>
__host__ __device__ __forceinline__ size_t slot_bytes(int N) {
  return (tile_bytes<T>(N) + (size_t)kT * kPT * sizeof(T) + 15) / 16 * 16;
}

// where a step's tiles come from: the chunk's C B^T tiles, its C, B and x
// rows
template <typename T>
struct StepSrc {
  const float* cb;  // C B^T scratch
  const T* Bm;
  const T* Cm;
  const T* x;
  size_t bl0;       // first row of the chunk in (B*L)
  size_t cb0;       // first row of the chunk's C B^T in the scratch
  int Qp, Q, N, H, h, P, p0;
};

// The steps of a chunk, in order: for each t tile, the C rows of the
// inter-chunk term (from the second chunk on), then the (t, s) tiles
// s <= t; then the state update's s tiles.
struct Step {
  int kind;  // 0: C rows of t tile ti; 1: (ti, si); 2: state tile si
  int ti, si;
};
__device__ __forceinline__ Step step_of(int k, int nt, bool inter) {
  for (int ti = 0; ti < nt; ++ti) {
    const int n = (int)inter + ti + 1;
    if (k < n) return inter && k == 0 ? Step{0, ti, 0} : Step{1, ti, k - (int)inter};
    k -= n;
  }
  return Step{2, 0, k};
}

// rows [r0, r0 + kT) of a (., N) matrix in the input type into a tile of
// row stride N + W (zeros past Q), as cp.async
template <typename T>
__device__ __forceinline__ void issue_rows(T* dst, const T* src, size_t bl0, int r0,
                                           int Q, int N) {
  constexpr int W = kVec<T>;
  const int cpr = N / W, ld = N + W;
  for (int i = threadIdx.x; i < kT * cpr; i += kThreads) {
    const int r = i / cpr, cc = i - r * cpr;
    const bool ok = r0 + r < Q;
    cp_async16(dst + r * ld + cc * W, ok ? src + (bl0 + r0 + r) * N + cc * W : src, ok);
  }
}

// the loads of step k into a ring slot, one cp.async group: a C B^T tile
// (f32), or C or B rows (input type); then, for (t, s) and state steps, at
// x_off the step's x tile
template <typename T>
__device__ __forceinline__ void issue_step(int k, unsigned char* base, size_t x_off,
                                           int nt, bool inter, const StepSrc<T>& g) {
  constexpr int W = kVec<T>;
  const Step st = step_of(k, nt, inter);
  if (st.kind == 0) {
    issue_rows(reinterpret_cast<T*>(base), g.Cm, g.bl0, st.ti * kT, g.Q, g.N);
    cp_async_commit();
    return;
  }
  const int s0 = st.si * kT;
  if (st.kind == 1) {
    float* cbd = reinterpret_cast<float*>(base);
    const float* src = g.cb + (g.cb0 + st.ti * kT) * g.Qp + s0;
    for (int i = threadIdx.x; i < kT * (kT / 4); i += kThreads) {
      const int r = i / (kT / 4), q4 = i % (kT / 4);
      cp_async16(cbd + r * kLdc + q4 * 4, src + (size_t)r * g.Qp + q4 * 4, true);
    }
  } else {
    issue_rows(reinterpret_cast<T*>(base), g.Bm, g.bl0, s0, g.Q, g.N);
  }
  T* xd = reinterpret_cast<T*>(base + x_off);
  constexpr int xcpr = kPT / W;
  for (int i = threadIdx.x; i < kT * xcpr; i += kThreads) {
    const int sl = i / xcpr, cc = i - sl * xcpr;
    const int s = s0 + sl, p = g.p0 + cc * W;
    const bool ok = s < g.Q && p < g.P;
    cp_async16(xd + sl * kPT + cc * W,
               ok ? g.x + ((g.bl0 + s) * g.H + g.h) * g.P + p : g.x, ok);
  }
  cp_async_commit();
}

// x[s, p0 + p], x[s, p0 + p + 1] of a shared-memory x tile as float32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ cb,
                T* __restrict__ y, float* __restrict__ state, int L, int H,
                int P, int N, int Q, int Qp) {
  constexpr int W = kVec<T>;
  constexpr int kHalf = kThreads / 2;  // the s (or n) halves of a product
  extern __shared__ __align__(16) float smem[];
  const int ld = N + 4;    // row stride of the state (f32)
  const int ldb = N + W;   // row stride of a C or B tile (input type)
  double* red = reinterpret_cast<double*>(smem);
  float* hs = smem + 2 * kWarps;
  float* gT = hs + kPT * ld;   // G [s][t] in a (t, s) step; w x [s][p] in a state step
  float* ys = gT + kT * kLdg;  // the second half's partial y [t][p]
  float* cum = ys + kT * kPT;
  float* dts = cum + Q;
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem + scan_floats(N, Q));
  const size_t slot = slot_bytes<T>(N);
  const size_t x_off = tile_bytes<T>(N);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * kPT, h = blockIdx.y, bat = blockIdx.z;
  const float a = -expf(A_log[h]);
  const int nc = L / Q;
  const int n4s = N / 4;
  const int nt = (Q + kT - 1) / kT;
  // G: rows tg + 16 i, columns sg + 16 j of the tile
  const int tg = tid / 16, sg = tid % 16;
  // y: half `half` of the threads sums s (and n) of its half; each thread
  // rows 4 rq .. 4 rq + 3, columns 2 pp, 2 pp + 1 of the block's P rows
  const int half = tid / kHalf, u = tid % kHalf;
  const int rq = u / (kPT / 2), pp = u % (kPT / 2);

  for (int i = tid; i < kPT * ld; i += kThreads) hs[i] = 0.f;

  for (int c = 0; c < nc; ++c) {
    const size_t bl0 = (size_t)bat * L + (size_t)c * Q;  // first row of the chunk

    const StepSrc<T> src{cb, Bm, Cm, x, bl0, ((size_t)bat * nc + c) * Qp, Qp, Q, N, H, h, P, p0};
    const bool inter = c > 0;  // the first chunk's state is zero
    const int n_steps = (inter ? nt : 0) + nt * (nt + 1) / 2 + nt;
    auto ready = [&](int k) {  // step k's tiles landed, k+1's in flight
      if (k + 1 < n_steps) {
        issue_step(k + 1, ring + ((k + 1) & 1) * slot, x_off, nt, inter, src);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    };
    issue_step(0, ring, x_off, nt, inter, src);  // overlaps the scan below

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
    int k = 0;
    for (int t0 = 0; t0 < Q; t0 += kT) {
      float acc[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
      if (inter) {
        // inter-chunk term exp(cum_t) C_t . h[p, :]; each half of the
        // threads sums half of n
        ready(k);
        __syncthreads();
        const T* csr = reinterpret_cast<const T*>(ring + (k & 1) * slot);
        const int n4_lo = half * (n4s / 2), n4_hi = half ? n4s : n4s / 2;
        const float4* h0 = reinterpret_cast<const float4*>(hs + (2 * pp) * ld);
        const float4* h1 = reinterpret_cast<const float4*>(hs + (2 * pp + 1) * ld);
        for (int n4 = n4_lo; n4 < n4_hi; ++n4) {
          const float4 hv0 = h0[n4], hv1 = h1[n4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 cv = load4(csr + (4 * rq + i) * ldb + 4 * n4);
            acc[i][0] = dot4(cv, hv0, acc[i][0]);
            acc[i][1] = dot4(cv, hv1, acc[i][1]);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * rq + i;
          const float e = expf(cum[t < Q ? t : Q - 1]);  // rows past Q are not stored
          acc[i][0] *= e;
          acc[i][1] *= e;
        }
        __syncthreads();  // before this slot is refilled
        ++k;
      }

      // intra-chunk term over the tiles of s <= t
      float cum_t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cum_t[i] = t0 + tg + 16 * i < Q ? cum[t0 + tg + 16 * i] : 0.f;
      for (int s0 = 0; s0 <= t0; s0 += kT, ++k) {
        ready(k);
        __syncthreads();
        const unsigned char* base = ring + (k & 1) * slot;
        const float* cbs = reinterpret_cast<const float*>(base);
        const T* xs = reinterpret_cast<const T*>(base + x_off);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int sl = sg + 16 * j, s = s0 + sl;
          const float cum_s = s < Q ? cum[s] : 0.f;
          const float dt_s = s < Q ? dts[s] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // masked before the exp: t < s differences are positive and
            // would overflow; -1e30 gives exp = 0 without a branch
            const int tl = tg + 16 * i, t = t0 + tl;
            const float d = t < Q && s <= t ? cum_t[i] - cum_s : -1e30f;
            gT[sl * kLdg + tl] = cbs[tl * kLdc + sl] * expf(d) * dt_s;
          }
        }
        __syncthreads();

        const int s_lo = half * (kT / 2);
#pragma unroll 8
        for (int sl = s_lo; sl < s_lo + kT / 2; ++sl) {
          const float2 xv = load2(xs + sl * kPT + 2 * pp);
          const float4 g4 = *reinterpret_cast<const float4*>(gT + sl * kLdg + 4 * rq);
          acc[0][0] = fmaf(g4.x, xv.x, acc[0][0]);
          acc[1][0] = fmaf(g4.y, xv.x, acc[1][0]);
          acc[2][0] = fmaf(g4.z, xv.x, acc[2][0]);
          acc[3][0] = fmaf(g4.w, xv.x, acc[3][0]);
          acc[0][1] = fmaf(g4.x, xv.y, acc[0][1]);
          acc[1][1] = fmaf(g4.y, xv.y, acc[1][1]);
          acc[2][1] = fmaf(g4.z, xv.y, acc[2][1]);
          acc[3][1] = fmaf(g4.w, xv.y, acc[3][1]);
        }
        __syncthreads();  // before gT and this slot are written again
      }

      // the two halves' sums -> y
      if (half == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float2*>(ys + (4 * rq + i) * kPT + 2 * pp) =
              make_float2(acc[i][0], acc[i][1]);
      }
      __syncthreads();
      if (half == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + 4 * rq + i;
          const float2 o = *reinterpret_cast<const float2*>(ys + (4 * rq + i) * kPT + 2 * pp);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = p0 + 2 * pp + e;
            if (t < Q && p < P)
              y[((bl0 + t) * H + h) * P + p] = from_f32<T>(acc[i][e] + (e ? o.y : o.x));
          }
        }
      }
    }

    // state update, after every row t has read the old state:
    // h = h exp(cum_end) + sum_s (exp(cum_end - cum_s) dt_s x_s) B_s^T
    const float cum_end = cum[Q - 1];
    const float decay = expf(cum_end);
    for (int i = tid; i < kPT * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      hs[r * ld + n] *= decay;
    }
    float* wxs = gT;  // [s][p]: x weighted by exp(cum_end - cum_s) dt_s
    for (int s0 = 0; s0 < Q; s0 += kT, ++k) {
      ready(k);
      __syncthreads();
      const unsigned char* base = ring + (k & 1) * slot;
      const T* bd = reinterpret_cast<const T*>(base);
      const T* xs = reinterpret_cast<const T*>(base + x_off);
      for (int i = tid; i < kT * kPT; i += kThreads) {
        const int s = s0 + i / kPT;  // rows past Q: x and dt are 0
        const int sc = s < Q ? s : Q - 1;
        wxs[i] = to_f32(xs[i]) * (expf(cum_end - cum[sc]) * (s < Q ? dts[sc] : 0.f));
      }
      __syncthreads();
      // a 4 x 4 block of the state per work item (rows 4 pq .. + 3,
      // columns 4 nq .. + 3), summed over this half's s
      const int s_lo = half * (kT / 2);
      for (int w0 = 0; w0 < (kPT / 4) * n4s; w0 += kHalf) {  // same trips for all
        const int w = w0 + u;
        const bool active = w < (kPT / 4) * n4s;
        const int pq = active ? w / n4s : 0, nq = active ? w - pq * n4s : 0;
        float4 a4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a4[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (active) {
#pragma unroll 8
          for (int sl = s_lo; sl < s_lo + kT / 2; ++sl) {
            const float4 wx = *reinterpret_cast<const float4*>(wxs + sl * kPT + 4 * pq);
            const float4 bv = load4(bd + sl * ldb + 4 * nq);
            const float wr[4] = {wx.x, wx.y, wx.z, wx.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              a4[r].x = fmaf(wr[r], bv.x, a4[r].x);
              a4[r].y = fmaf(wr[r], bv.y, a4[r].y);
              a4[r].z = fmaf(wr[r], bv.z, a4[r].z);
              a4[r].w = fmaf(wr[r], bv.w, a4[r].w);
            }
          }
        }
        // the halves add into the state one after the other
        for (int turn = 0; turn < 2; ++turn) {
          if (turn == half && active) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              float4* hp = reinterpret_cast<float4*>(hs + (4 * pq + r) * ld) + nq;
              float4 v = *hp;
              v.x += a4[r].x; v.y += a4[r].y; v.z += a4[r].z; v.w += a4[r].w;
              *hp = v;
            }
          }
          __syncthreads();
        }
      }
    }
  }

  for (int i = tid; i < kPT * N; i += kThreads) {
    const int pp2 = i / N, n = i - pp2 * N;
    const int p = p0 + pp2;
    if (p < P) state[(((size_t)bat * H + h) * P + p) * N + n] = hs[pp2 * ld + n];
  }
}

template <typename T>
cudaError_t launch_cb(const T* Bm, const T* Cm, float* cb, int B, int L, int N,
                      int Q, int Qp, cudaStream_t stream);
template <>
cudaError_t launch_cb<float>(const float* Bm, const float* Cm, float* cb, int B,
                             int L, int N, int Q, int Qp, cudaStream_t stream) {
  const int nt = Qp / kT;
  ssd_cb_f32<<<dim3(nt * (nt + 1) / 2, L / Q, B), kThreads, 0, stream>>>(Bm, Cm, cb, L, N, Q, Qp);
  return cudaGetLastError();
}
template <>
cudaError_t launch_cb<__nv_bfloat16>(const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
                                     float* cb, int B, int L, int N, int Q, int Qp,
                                     cudaStream_t stream) {
  const int nt = Qp / kT;
  ssd_cb_bf16<<<dim3(nt * (nt + 1) / 2, L / Q, B), kThreads, 0, stream>>>(Bm, Cm, cb, L, N, Q, Qp);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm,
           const void* Cm, void* cb, void* y, void* state, int B, int L, int H,
           int P, int N, int Q, cudaStream_t stream) {
  constexpr int W = kVec<T>;
  if (N % W != 0 || P % W != 0) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
       reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(cb)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int Qp = (Q + kT - 1) / kT * kT;
  const int nt = Qp / kT;
  if (nt * (nt + 1) / 2 > 65535 || L / Q > 65535) return (int)cudaErrorInvalidValue;
  const size_t bytes = scan_floats(N, Q) * sizeof(float) + 2 * slot_bytes<T>(N);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;  // 227 KB a block
  static SmemAttr attr;
  cudaError_t err = attr.ensure((const void*)ssd_scan_kernel<T>);
  if (err != cudaSuccess) return (int)err;
  err = launch_cb<T>(static_cast<const T*>(Bm), static_cast<const T*>(Cm),
                     static_cast<float*>(cb), B, L, N, Q, Qp, stream);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((P + kPT - 1) / kPT, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A_log), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(cb), static_cast<T*>(y),
      static_cast<float*>(state), L, H, P, N, Q, Qp);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (B, L, H, P); B, C: (B, L, N), all of one type (0 = float32,
// 1 = bfloat16), 16-byte aligned, N and P multiples of 16 bytes' worth of
// elements (4 in f32, 8 in bf16); dt (B, L, H) and A_log (H,) float32;
// state (B, H, P, N) float32; L % Q == 0; cb the C B^T scratch, B * (L/Q) *
// Qp * Qp floats with Qp = Q rounded up to a multiple of 64, 16-byte
// aligned. Launches both passes on `stream`, does not synchronise; returns
// the first failed launch's CUDA error (0 = ok).
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A_log,
                            const void* Bm, const void* Cm, void* cb, void* y,
                            void* state, int B, int L, int H, int P, int N, int Q,
                            int dtype, void* stream) {
  if (B <= 0 || L <= 0 || H <= 0 || P <= 0 || N <= 0) return 0;
  if (Q <= 0 || L % Q != 0 || H > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A_log, Bm, Cm, cb, y, state, B, L, H, P, N, Q, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, cb, y, state, B, L, H, P, N, Q, s);
  return (int)cudaErrorInvalidValue;
}
