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
// warp-specialised wgmma + TMA kernel, in this file. Every other head dim
// (a multiple of 16 up to 256) and float32 go to flash_attention_mma.cu.
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <array>
#include <map>
#include <mutex>

#include "flash_common.cuh"

namespace {

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

}  // namespace

// q: (B, Tq, H, D), k/v: (B, S, K, D), o: (B, Tq, H, D), bfloat16, all
// contiguous and 16-byte aligned, D in {64, 128, 256}. window < 0 means no
// window. Returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Tq, int S, int H,
                                   int K, int D, int causal, int window,
                                   float scale, void* stream) {
  if (B <= 0 || Tq <= 0 || S <= 0 || K <= 0 || H % K != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return (int)launch_hopper<64>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
    case 128: return (int)launch_hopper<128>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
    case 256: return (int)launch_hopper<256>(q, k, v, o, B, Tq, S, H, K, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
