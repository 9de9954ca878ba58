// Flash attention forward for Hopper (sm_90a): online softmax, GQA, causal
// and sliding-window masks, any sequence length.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention -> pl.pallas_call), reached from prefill attention at
// repro/models/layers.py:193-196 when cfg.use_pallas is set. Computes the
// same function: softmax(Q K^T * scale + mask) V with query positions
// 0..T-1 and key positions 0..S-1, query head h reading kv head h / (H/K),
// masked scores at -1e30, running max / denominator / accumulator in f32,
// p rounded to the input type before P V, output acc / max(l, 1e-30) in the
// input type.
//
// What bounds it on an H100: at qwen3-1.7b's prefill shape (B=1, T=S=512,
// H=16, K=8, d=128, bf16, causal) the function moves 6.3 MB (Q, K, V read
// once, O written once): 1.9 us at 3.35 TB/s, against 1.1 GFLOP of unmasked
// QK^T and PV products, 1.1 us at the bf16 tensor-core peak. Memory-bound,
// but only by a factor of two, and at this size latency (the chain of
// dependent products and exponentials a q tile walks through its kv tiles)
// and how evenly the work spreads over 132 SMs matter more than either.
//
// bfloat16, d in {64, 128, 256} (the served models' head dims): a
// warp-specialised wgmma + TMA kernel.
//   * A block is one consumer warpgroup (4 warps, 64 query rows of one head)
//     and one producer warp. The producer's lane 0 loads the Q tile and the
//     K tiles (64 keys), lane 1 the V tiles, with cp.async.bulk.tensor into
//     two rings of two stages; each stage has a full mbarrier (expect-tx
//     byte count) and an empty one (one arrival per consumer warp). K of
//     tile j+2 is requested as soon as QK^T of tile j is done, V of tile j+2
//     once PV of tile j is. The tensor maps view q as (d, H, T, B) and k/v
//     as (d, K, S, B), so a box of (64 dims, one head, 64 rows, one batch)
//     is one head's tile with no gather; rows past T or S arrive as zeros
//     (keys past S are still masked: a zero score is not -1e30). A tile is
//     d/64 such boxes: 128-byte rows in the 128-byte swizzle, which the
//     wgmma descriptors name (layout SW128, 1024 bytes between 8-row
//     groups, each 64-column atom of d its own region).
//   * S = Q K^T is wgmma m64n64k16 with both operands in shared memory,
//     K-major (d contiguous), d/16 instructions advancing 32 bytes inside
//     an atom. O += P V takes P from registers: the S accumulator's
//     per-thread layout is the A fragment's, so p is rounded to bf16 and
//     packed pairwise in place; V is the MN-major B operand (the transpose
//     bit), one m64n64k16 per 64 columns of d and 16 keys.
//   * The softmax is straight-line: an exponential is one FFMA and one
//     ex2.approx.ftz, the mask two compares against a row's key bounds, and
//     one uniform branch skips it for a tile every row of the warp sees
//     whole. (Written with a branch per element and exp2f, it took longer
//     than both products together.) A tile is QK^T, softmax, PV in turn:
//     issuing QK^T of the next tile before PV of this one measured slower.
//   * Schedule. A block is one q tile (64 rows of one head) against its
//     reachable kv tiles; under a causal mask q tile i reaches i+1 kv
//     tiles. Blocks run the longest q tiles first (the q tile is the
//     slowest grid axis, counted from the last). Cutting a long q tile's
//     kv range over several blocks, with an exact combine of their (m, l,
//     acc) partials, was built and timed on the card: at every served head
//     shape and every prompt length from 256 to 512 it was 15-51% slower
//     than whole q tiles, also where whole q tiles leave SMs idle
//     (PERF.md), so the kernel has no split.
//   * Only the tiles that the causal and window masks leave reachable are
//     loaded.
//   * A block is 160 threads; an SM holds 3 at d = 64, 2 at d = 128 (80 KB
//     of shared memory), 1 at d = 256 (160 KB: two 32 KB K and V stages).
//     With one consumer warpgroup a block has no registers to move between
//     roles, so setmaxnreg is not used: d = 256 holds its 128 O
//     accumulators in the 255 registers a thread may have at one block per
//     SM.
//   * Host cost: the tensor maps are passed by value as __grid_constant__
//     parameters. cuTensorMapEncodeTiled takes 2.6-4.1 us a call on the
//     H100 machine's host, three a launch, and cuTensorMapReplaceAddress
//     0.5-0.9 us (tools/flash_ab.py), so a map is encoded once per shape
//     and cached, and a launch copies the cached map and sets its base
//     address. The shared-memory attribute is set once per kernel and
//     device, not per launch.
//
// bfloat16, d in {16, 32}: tensor cores through mma.sync m16n8k16 (bf16 in,
// f32 accumulate), 4 warps of 16 query rows, K/V tiles by cp.async into two
// shared-memory buffers and ldmatrix fragments (V's transposed), P kept in
// registers as the A fragment. No served model has these head dims.
//
// float32: the products stay on the CUDA cores in f32 (tensor cores would
// round to TF32 and miss the f32 tolerance). One block of 256 threads per
// 64-row q tile: four threads share a query row, each owning every fourth
// column of the head dimension, and a row's dot products reduce with two
// warp shuffles.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <array>
#include <atomic>
#include <map>
#include <mutex>

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

// ---------------------------------------------------------------------------
// The reachable kv tiles of a q tile (mirrored by
// kernels/flash_attention.py::kv_tiles, which the CPU tests check)
// ---------------------------------------------------------------------------
constexpr int TILE = 64;  // query rows per q tile, keys per kv tile

// reachable kv tiles [lo, hi] of q tile qt (empty when hi < lo)
__host__ __device__ __forceinline__ void kv_tiles(int qt, int Tq, int S, int causal,
                                                  int window, int& lo, int& hi) {
  const int q0 = qt * TILE;
  const int q_hi = (q0 + TILE < Tq ? q0 + TILE : Tq) - 1;
  const int k_hi = causal && q_hi < S - 1 ? q_hi : S - 1;
  const int k_lo = window >= 0 && q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  lo = k_lo / TILE;
  hi = k_lo <= k_hi ? k_hi / TILE : lo - 1;
}

// ---------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count));
}

// one arrival that also tells the barrier how many bytes TMA will deliver
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// until the phase of parity `parity` has completed. A wait that spins
// 2^24 times traps (a launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_addr(bar);
  for (unsigned spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1u << 24)) __trap();
  }
}

// a (64 dims, 1 head, rows, 1 batch) box of a 4-d tensor map into shared
// memory, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory matrix descriptor: 128-byte swizzle, 8-row groups
// 1024 bytes apart. The leading-byte offset (the stride between 64-column
// swizzle atoms of an MN-major operand, unused by K-major ones) is set to
// the same 1024: every operand here spans one atom in the direction it
// names, so the field is never read for a stride and cannot disagree.
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t addr = smem_addr(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of an accumulator across
// the wgmma issue / wait that own it
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, f32 accumulator layout) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---------------------------------------------------------------------------
// bfloat16, d in {64, 128, 256}: wgmma + TMA
// ---------------------------------------------------------------------------
constexpr int HOP_THREADS = 160;  // one consumer warpgroup, one producer warp
constexpr int STAGES = 2;         // K/V ring depth
constexpr int ATOM_BYTES = TILE * 128;  // 64 rows of one 64-column atom

template <int D>
constexpr int hopper_smem() {
  // Q tile, STAGES K and V tiles, 1 + 4 STAGES mbarriers, slack to align
  // to 1024
  return TILE * D * 2 * (1 + 2 * STAGES) + 8 * (1 + 4 * STAGES) + 1024;
}

// S (64 x 64 f32) = Q K^T for a K tile: both operands in shared memory,
// K-major; d/16 instructions, 32 bytes apart inside a 64-column atom
template <int D>
__device__ __forceinline__ void issue_qk(float (&s_acc)[32], const unsigned char* qs,
                                         const unsigned char* kb) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * ATOM_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(s_acc, desc_sw128(qs + off), desc_sw128(kb + off), kk > 0);
  }
  wgmma_commit();
}

// O (64 x D f32) += P V for a V tile: P from registers (bf16, A-fragment
// layout), V in shared memory MN-major; one instruction per 16 keys and 64
// columns of d
template <int D>
__device__ __forceinline__ void issue_pv(float (&o_acc)[D / 64][32],
                                         const uint32_t (&p)[TILE / 16][4],
                                         const unsigned char* vb) {
#pragma unroll
  for (int a = 0; a < D / 64; ++a) fence_regs(o_acc[a]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk)
#pragma unroll
    for (int a = 0; a < D / 64; ++a)
      wgmma_rs_n64(o_acc[a], p[kk], desc_sw128(vb + a * ATOM_BYTES + kk * 16 * 128));
  wgmma_commit();
}

// 2^x in one MUFU.EX2; results below 2^-126 flush to 0 (p is rounded to
// bf16 next, and no such p moves a sum of terms of at least 2^0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// mask S of the kv tile at key s0, online softmax in base 2: P (bf16, in
// the A-fragment layout), the rescale factor of the old state and this
// thread's share of the row sums. m_r holds each row's running maximum of
// the unscaled scores. Element e of column group j is row row0 + 8*(e/2),
// key s0 + 8j + 2*tig + e%2; warp w's rows start at q0 + 16 w.
// Straight-line code, about 7 instructions an element: one uniform branch
// skips the mask of a tile that every row of the warp sees whole, and the
// exponent is one FFMA, p = 2^(s*scale - m*scale). Masked scores hold -1e30;
// a row with no key yet takes m = 0 for the exponent, so its p are 0 too.
__device__ __forceinline__ void softmax_tile(float (&s_acc)[32], uint32_t (&p)[TILE / 16][4],
                                             float (&m_r)[2], float (&alpha)[2],
                                             float (&rsum)[2], int s0, int q0, int warp,
                                             int row0, int tig, int S, int causal,
                                             int window, float scale_log2) {
  const int wrow = q0 + warp * 16;
  const bool whole = s0 + TILE <= S && (!causal || s0 + TILE - 1 <= wrow) &&
                     (window < 0 || wrow + 15 - s0 < window);
  if (!whole) {
    // keys [lo, hi] of each of this thread's two rows, relative to s0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      const int hi = (causal && t < S - 1 ? t : S - 1) - s0;
      const int lo = (window >= 0 ? t - window + 1 : 0) - s0;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = j * 8 + tig * 2 + e;
          if (k > hi || k < lo) s_acc[4 * j + 2 * r + e] = NEG_INF;
        }
    }
  }
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < 32; ++i) mt[(i >> 1) & 1] = fmaxf(mt[(i >> 1) & 1], s_acc[i]);
  float neg_ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row's four threads hold its 64 keys
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float m_new = fmaxf(m_r[r], mt[r]);
    // both maxima -1e30 (no key yet): 2^0; a first key: 2^-huge = 0
    alpha[r] = ex2((m_r[r] - m_new) * scale_log2);
    m_r[r] = m_new;
    neg_ms[r] = m_new > 0.5f * NEG_INF ? -m_new * scale_log2 : 0.f;
    rsum[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const float pv = ex2(fmaf(s_acc[i], scale_log2, neg_ms[(i >> 1) & 1]));
    s_acc[i] = pv;
    rsum[(i >> 1) & 1] += pv;
  }
#pragma unroll
  for (int kk = 0; kk < TILE / 16; ++kk) {
    p[kk][0] = pack_bf16(s_acc[8 * kk + 0], s_acc[8 * kk + 1]);
    p[kk][1] = pack_bf16(s_acc[8 * kk + 2], s_acc[8 * kk + 3]);
    p[kk][2] = pack_bf16(s_acc[8 * kk + 4], s_acc[8 * kk + 5]);
    p[kk][3] = pack_bf16(s_acc[8 * kk + 6], s_acc[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(HOP_THREADS, D == 64 ? 3 : D == 128 ? 2 : 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, int Tq, int S, int H, int K,
                 int causal, int window, float scale_log2) {
  constexpr int ATOMS = D / 64;
  constexpr int TILE_BYTES = TILE * D * 2;  // one Q, K or V tile
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align every tile to it
  unsigned char* qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + TILE_BYTES;
  unsigned char* vs = ks + STAGES * TILE_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * TILE_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // most kv tiles first
  const int kh = h / (H / K);
  int kt0, kt_hi;
  kv_tiles(qt, Tq, S, causal, window, kt0, kt_hi);
  const int q0 = qt * TILE;
  const int n = max(0, kt_hi - kt0 + 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, 4);  // one arrival per consumer warp
      mbar_init(v_empty + s, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: lane 0 loads Q, then K through its ring; lane 1 V through
    // its own. K of tile i+2 is requested as soon as QK^T of tile i is done
    // and V of tile i+2 once PV of tile i is, each a full iteration before
    // it is read.
    if (lane < 2) {
      const CUtensorMap* map = lane == 0 ? &kmap : &vmap;
      uint64_t* full = lane == 0 ? k_full : v_full;
      uint64_t* empty = lane == 0 ? k_empty : v_empty;
      unsigned char* ring = lane == 0 ? ks : vs;
      if (lane == 0) {
        mbar_expect_tx(q_full, TILE_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(qs + a * ATOM_BYTES, &qmap, q_full, a * 64, h, q0, b);
      }
      for (int i = 0; i < n; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + st, (i / STAGES - 1) & 1);
        unsigned char* dst = ring + st * TILE_BYTES;
        mbar_expect_tx(full + st, TILE_BYTES);
        for (int a = 0; a < ATOMS; ++a)
          tma_load_4d(dst + a * ATOM_BYTES, map, full + st, a * 64, kh,
                      (kt0 + i) * TILE, b);
      }
    }
    return;
  }

  // consumer warpgroup: warp w owns rows 16w..16w+15 of the q tile; this
  // thread rows row0 and row0 + 8, columns 2*tig, 2*tig+1 of every 8
  const int g = lane / 4, tig = lane % 4;
  const int row0 = q0 + warp * 16 + g;
  float o_acc[ATOMS][32];
#pragma unroll
  for (int a = 0; a < ATOMS; ++a)
#pragma unroll
    for (int i = 0; i < 32; ++i) o_acc[a][i] = 0.f;
  float s_acc[32];
  uint32_t p_cur[TILE / 16][4];
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's columns only; summed at the end

  mbar_wait(q_full, 0);
  if (n > 0) {
    float alpha[2], rsum[2];
    mbar_wait(k_full, 0);
    issue_qk<D>(s_acc, qs, ks);
    wgmma_wait<0>();
    fence_regs(s_acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_empty);  // K stage 0 may be refilled
    softmax_tile(s_acc, p_cur, m_r, alpha, rsum, kt0 * TILE, q0, warp, row0, tig, S,
                 causal, window, scale_log2);
    l_r[0] = rsum[0];
    l_r[1] = rsum[1];
    // per tile: QK^T, softmax and the O rescale, then PV (issuing QK^T of
    // tile j+1 before PV of tile j measured slower on the card)
    for (int j = 0; j < n; ++j) {
      const int st = j % STAGES, ph = (j / STAGES) & 1;
      if (j > 0) {
        mbar_wait(k_full + st, ph);
        issue_qk<D>(s_acc, qs, ks + st * TILE_BYTES);
        wgmma_wait<0>();
        fence_regs(s_acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(k_empty + st);  // K stage st may be refilled
        softmax_tile(s_acc, p_cur, m_r, alpha, rsum, (kt0 + j) * TILE, q0, warp,
                     row0, tig, S, causal, window, scale_log2);
#pragma unroll
        for (int a = 0; a < ATOMS; ++a)
#pragma unroll
          for (int i = 0; i < 32; ++i) o_acc[a][i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + rsum[r];
      }
      mbar_wait(v_full + st, ph);
      issue_pv<D>(o_acc, p_cur, vs + st * TILE_BYTES);
      wgmma_wait<0>();
#pragma unroll
      for (int a = 0; a < ATOMS; ++a) fence_regs(o_acc[a]);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_empty + st);  // V stage st may be refilled
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + r * 8;
    if (t >= Tq) continue;
    const float inv = 1.f / fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* out = o + (((size_t)b * Tq + t) * H + h) * D + tig * 2;
#pragma unroll
    for (int a = 0; a < ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(out + a * 64 + j * 8) =
            __floats2bfloat162_rn(o_acc[a][4 * j + 2 * r] * inv,
                                  o_acc[a][4 * j + 2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// bfloat16, d in {16, 32}: mma.sync tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_BQ = 64;               // query rows per block, 16 per warp
constexpr int MMA_BK = 64;               // keys per kv tile
constexpr int MMA_THREADS = (MMA_BQ / 16) * 32;
constexpr int PAD = 8;                   // bf16 row padding in shared memory

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

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// a (d, heads, rows, batch) bf16 tensor map with (64, 1, 64, 1) boxes in the
// 128-byte swizzle; rows past `rows` read as zeros
bool encode_map(CUtensorMap* map, const void* ptr, int D, int heads, int rows,
                int B) {
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                           (cuuint64_t)rows * heads * D * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)TILE, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the same map from a cache of one encoded map per shape, with its base
// address replaced: a launch pays a copy and cuTensorMapReplaceAddress, not
// an encode
bool tensor_map(CUtensorMap* map, const void* ptr, int D, int heads, int rows,
                int B) {
  static std::mutex mu;
  static std::map<std::array<int, 4>, CUtensorMap> cache;
  const std::array<int, 4> key{D, heads, rows, B};
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it == cache.end()) {
      CUtensorMap m;
      if (!encode_map(&m, ptr, D, heads, rows, B)) return false;
      if (cache.size() >= 4096) cache.clear();  // bounded over many prompt lengths
      it = cache.emplace(key, m).first;
    }
    *map = it->second;
  }
  return cuTensorMapReplaceAddress(map, const_cast<void*>(ptr)) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_hopper(const void* q, const void* k, const void* v, void* o,
                          int B, int Tq, int S, int H, int K, int causal,
                          int window, float scale, cudaStream_t stream) {
  const int n_qt = (Tq + TILE - 1) / TILE;
  if (n_qt > 65535 || B > 65535) return cudaErrorInvalidValue;  // grid z, y
  CUtensorMap qm, km, vm;
  if (!tensor_map(&qm, q, D, H, Tq, B) || !tensor_map(&km, k, D, K, S, B) ||
      !tensor_map(&vm, v, D, K, S, B))
    return cudaErrorInvalidValue;
  static SmemAttr attr;
  cudaError_t err = attr.ensure((const void*)flash_fwd_hopper<D>);
  if (err != cudaSuccess) return err;
  flash_fwd_hopper<D><<<dim3(H, B, n_qt), HOP_THREADS, hopper_smem<D>(), stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), Tq, S, H, K, causal, window,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int Tq, int S, int H, int K, int causal,
                        int window, float scale, cudaStream_t stream) {
  const size_t smem = (MMA_BQ + 4 * MMA_BK) * (D + PAD) * sizeof(__nv_bfloat16);
  static SmemAttr attr;
  cudaError_t err = attr.ensure((const void*)flash_fwd_bf16<D>);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + MMA_BQ - 1) / MMA_BQ, H, B);
  flash_fwd_bf16<D><<<grid, MMA_THREADS, smem, stream>>>(
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
  static SmemAttr attr;
  cudaError_t err = attr.ensure((const void*)flash_fwd_f32<D, BK>);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + F32_BQ - 1) / F32_BQ, H, B);
  flash_fwd_f32<D, BK><<<grid, F32_THREADS, smem, stream>>>(
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

// q: (B, Tq, H, D), k/v: (B, S, K, D), o: (B, Tq, H, D), all contiguous and
// 16-byte aligned. dtype: 0 = float32, 1 = bfloat16. window < 0 means no
// window. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Tq, int S, int H,
                                   int K, int D, int causal, int window,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    FLASH_DISPATCH_D(launch_f32, D, q, k, v, o, B, Tq, S, H, K, causal, window, scale, st)
  }
  if (dtype == 1) {
    switch (D) {
      case 64: return (int)launch_hopper<64>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
      case 128: return (int)launch_hopper<128>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
      case 256: return (int)launch_hopper<256>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
      case 16: return (int)launch_bf16<16>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
      case 32: return (int)launch_bf16<32>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaErrorInvalidValue;
}
