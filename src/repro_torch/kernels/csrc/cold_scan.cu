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
// Unlike the TPU kernel, which takes one keep_warm and computes in f32, this
// one takes keep_warm per row (a moved step lands on a platform with another
// keep_warm) and compares in the dtype it is given (f32 or f64): on the f64
// path an f32 cast could flip a comparison whose gap lies within an f32 ulp
// of keep_warm. Only subtractions, comparisons and bit operations touch the
// values, so the result is exact; build without --use_fast_math.
//
// Its bound is bytes. Each row reads 2·T values and writes T mask bytes
// (151 MB in f32, 285 MB in f64 at B = T = 4096, 45 and 85 us at 3.35 TB/s);
// the arithmetic is a few operations per element.
//
// The design takes the time axis apart. last is warm_end[k-1] or
// cold_end[k-1], so request k's mask is a select of two comparisons that do
// not depend on the state:
//
//     mask[k] = mask[k-1] ? cold_gap[k] : warm_gap[k]
//     warm_gap[k] = (t0[k] - warm_end[k-1]) > keep_warm   (cold_gap likewise)
//
// that is s = a ^ (b & s_prev) with (a, b) = (warm_gap, warm_gap ^ cold_gap),
// an affine map over GF(2). Request 0 makes the recurrence's own comparison
// against last = -inf: both of its "previous ends" are -inf, so b = 0. The
// maps compose associatively ((a1, b1) then (a2, b2) is (a2 ^ (b2 & a1),
// b2 & b1)), and because each map makes exactly the comparisons of the
// recurrence, the scan equals it for any input, NaN and +-inf included.
//
//   * A warp walks a row in tiles of 128 requests, 4 consecutive ones a
//     lane (16-byte loads in f32, two in f64, the next tile's loads in
//     flight while this one is scanned). A lane takes the previous
//     request's ends of its first request from the lane before
//     (__shfl_up_sync), lane 0 from the previous tile. It composes its 4
//     maps, the warp scans the 32 lane maps in 5 shuffle steps, and each
//     lane replays its 4 maps from the state its prefix gives: the mask
//     bits, stored as 4 bytes a lane, 128 contiguous bytes a warp. The
//     state bit is carried from tile to tile.
//   * Few rows (the scorer's and the controller's calls) would leave most
//     SMs idle, so the host splits T into chunks of whole tiles, up to 16
//     warps a row, all in one block (kernels/cold_scan.py::cold_scan_plan
//     chooses the split from B, T and the SM count). Each warp first
//     composes its chunk's map without knowing the state entering it, the
//     maps meet in shared memory, each warp folds those of the chunks before
//     its own into its entering state, and walks its chunk again (a chunk
//     of one tile keeps its maps in registers and reads nothing twice).
//   * kernels/cold_scan.py::cold_scan_words is this arithmetic in plain
//     PyTorch; the CPU tests hold it to the reference.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;
constexpr int kPerLane = 4;                 // consecutive requests a lane holds
constexpr int kTile = kLanes * kPerLane;    // requests a warp takes a step
constexpr int kMaxChunks = 16;              // warps a row
constexpr int kMinWarps = 4;                // warps a block
constexpr int kMaxThreads = kMaxChunks * kLanes;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kIdentity = 2u;          // the map (a, b) = (0, 1), as a | b << 1

// (a1, b1) then (a2, b2), each packed as a | b << 1
__device__ __forceinline__ unsigned compose(unsigned first, unsigned then) {
  const unsigned a = (then & 1u) ^ ((then >> 1) & first & 1u);
  return a | ((then & first) & 2u);
}

// the state after map m from state s
__device__ __forceinline__ unsigned apply(unsigned m, unsigned s) {
  return (m & 1u) ^ ((m >> 1) & s);
}

// 4 consecutive values of T
template <typename T>
union Quad {
  uint4 w[sizeof(T) * kPerLane / 16];
  T e[kPerLane];
};

// requests k..k+3 of p (zeros past n); kVec: n % 4 == 0 and p 16-byte
// aligned, so a lane's 4 are all in or all out
template <typename T, bool kVec>
__device__ __forceinline__ void load4(const T* __restrict__ p, int k, int n,
                                      T (&v)[kPerLane]) {
  if (kVec) {
    Quad<T> q;
#pragma unroll
    for (int i = 0; i < (int)(sizeof(q.w) / sizeof(q.w[0])); ++i)
      q.w[i] = k < n ? reinterpret_cast<const uint4*>(p + k)[i] : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = q.e[j];
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) v[j] = k + j < n ? p[k + j] : T(0);
  }
}

template <typename T>
struct Requests {
  T t[kPerLane], w[kPerLane], c[kPerLane];
};

template <typename T, bool kVec>
__device__ __forceinline__ void load_requests(const T* t0, const T* wr, const T* cr,
                                              int k, int n, Requests<T>& r) {
  load4<T, kVec>(t0, k, n, r.t);
  load4<T, kVec>(wr, k, n, r.w);
  load4<T, kVec>(cr, k, n, r.c);
}

// The maps of a lane's requests k..k+3 (bit j of a and b: request k + j;
// the identity past n), and the warp's inclusive scan of the lane maps.
// pw, pc: the ends of the request before the tile (lane 0's previous).
template <typename T>
__device__ __forceinline__ void tile_maps(const Requests<T>& r, T pw, T pc, T kw, int k,
                                          int n, unsigned& a, unsigned& b,
                                          unsigned& incl) {
  const int lane = (int)threadIdx.x % kLanes;
  T uw = __shfl_up_sync(kFull, r.w[kPerLane - 1], 1);
  T uc = __shfl_up_sync(kFull, r.c[kPerLane - 1], 1);
  if (lane == 0) {
    uw = pw;
    uc = pc;
  }
  a = 0u;
  b = 0u;
  unsigned m = kIdentity;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const T prev_w = j == 0 ? uw : r.w[j - 1];
    const T prev_c = j == 0 ? uc : r.c[j - 1];
    unsigned aj = 0u, bj = 1u;
    if (k + j < n) {
      const bool wg = (r.t[j] - prev_w) > kw;
      const bool cg = (r.t[j] - prev_c) > kw;
      aj = wg;
      bj = wg != cg;
    }
    a |= aj << j;
    b |= bj << j;
    m = compose(m, aj | (bj << 1));
  }
#pragma unroll
  for (int o = 1; o < kLanes; o <<= 1) {
    const unsigned p = __shfl_up_sync(kFull, m, o);
    if (lane >= o) m = compose(p, m);
  }
  incl = m;
}

// The lane's 4 mask bits from the state s entering the tile; s moves past
// the tile.
__device__ __forceinline__ unsigned tile_masks(unsigned a, unsigned b, unsigned incl,
                                               unsigned& s) {
  const int lane = (int)threadIdx.x % kLanes;
  unsigned e = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) e = kIdentity;
  unsigned st = apply(e, s);
  unsigned bits = 0u;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    st = ((a >> j) & 1u) ^ ((b >> j) & st & 1u);
    bits |= st << j;
  }
  s = apply(__shfl_sync(kFull, incl, kLanes - 1), s);
  return bits;
}

template <bool kVec>
__device__ __forceinline__ void store_masks(uint8_t* __restrict__ mr, int k, int n,
                                            unsigned bits) {
  if (kVec) {
    if (k < n)
      *reinterpret_cast<uint32_t*>(mr + k) = (bits & 1u) | ((bits & 2u) << 7) |
                                             ((bits & 4u) << 14) | ((bits & 8u) << 21);
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (k + j < n) mr[k + j] = (uint8_t)((bits >> j) & 1u);
  }
}

// One warp's walk over tiles [tile0, tile1) of its row, the next tile's
// loads in flight while one is scanned. kStore: write the masks from the
// entering state s (s moves past the walk); else compose the walk's map,
// returned. a, b, incl: the last tile's maps.
template <typename T, bool kVec, bool kStore>
__device__ __forceinline__ unsigned walk(const T* t0, const T* wr, const T* cr,
                                         uint8_t* mr, T kw, int n, int tile0, int tile1,
                                         T pw, T pc, unsigned& s, unsigned& a,
                                         unsigned& b, unsigned& incl) {
  const int lane = (int)threadIdx.x % kLanes;
  unsigned map = kIdentity;
  int k = tile0 * kTile + lane * kPerLane;
  Requests<T> cur;
  if (tile0 < tile1) load_requests<T, kVec>(t0, wr, cr, k, n, cur);
  for (int tile = tile0; tile < tile1; ++tile, k += kTile) {
    Requests<T> nxt;
    if (tile + 1 < tile1) load_requests<T, kVec>(t0, wr, cr, k + kTile, n, nxt);
    tile_maps(cur, pw, pc, kw, k, n, a, b, incl);
    if (kStore)
      store_masks<kVec>(mr, k, n, tile_masks(a, b, incl, s));
    else
      map = compose(map, __shfl_sync(kFull, incl, kLanes - 1));
    pw = __shfl_sync(kFull, cur.w[kPerLane - 1], kLanes - 1);
    pc = __shfl_sync(kFull, cur.c[kPerLane - 1], kLanes - 1);
    cur = nxt;
  }
  return map;
}

// A block is max(nch, kMinWarps) warps: blockDim / 32 / nch rows of nch
// chunks each, chunk ch of a row being tiles [ch * tpc, (ch + 1) * tpc).
template <typename T, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) cold_scan_kernel(
    const T* __restrict__ t0, const T* __restrict__ warm, const T* __restrict__ cold,
    const T* __restrict__ keep_warm, uint8_t* __restrict__ mask, int B, int n, int nch,
    int tpc) {
  __shared__ unsigned s_chunk[kMaxThreads / kLanes];
  const int wib = (int)threadIdx.x / kLanes;
  const long long row = (long long)blockIdx.x * ((int)blockDim.x / kLanes / nch) + wib / nch;
  const int ch = wib % nch;
  const bool live = row < B;  // whole warps: a warp is one row's chunk
  const T kw = live ? keep_warm[row] : T(0);
  const T* wr = warm + row * n;
  const T* cr = cold + row * n;
  uint8_t* mr = mask + row * n;
  const int ntiles = (n + kTile - 1) / kTile;
  const int tile0 = ch * tpc;
  const int tile1 = min(ntiles, tile0 + tpc);
  // the ends of the request before the chunk; a row's request 0 compares
  // against -inf as the recurrence does
  T pw = T(-INFINITY), pc = T(-INFINITY);
  if (live && tile0 > 0 && tile0 < tile1) {
    pw = wr[tile0 * kTile - 1];
    pc = cr[tile0 * kTile - 1];
  }
  unsigned s = 0u;  // the state entering the chunk: chunk 0's maps ignore it
  unsigned a = 0u, b = 0u, incl = kIdentity;
  if (nch > 1) {
    unsigned map = kIdentity;
    if (live)
      map = walk<T, kVec, false>(t0, wr, cr, mr, kw, n, tile0, tile1, pw, pc, s, a, b,
                                 incl);
    if (threadIdx.x % kLanes == 0) s_chunk[wib] = map;
    __syncthreads();
    for (int c = 0; c < ch; ++c) s = apply(s_chunk[wib - ch + c], s);
  }
  if (!live || tile0 >= tile1) return;
  if (nch > 1 && tpc == 1) {  // one tile: its maps are still in registers
    store_masks<kVec>(mr, tile0 * kTile + ((int)threadIdx.x % kLanes) * kPerLane, n,
                      tile_masks(a, b, incl, s));
    return;
  }
  walk<T, kVec, true>(t0, wr, cr, mr, kw, n, tile0, tile1, pw, pc, s, a, b, incl);
}

template <typename T, bool kVec>
int launch(const void* t0, const void* warm, const void* cold, const void* keep_warm,
           void* mask, int B, int n, int nch, int tpc, cudaStream_t stream) {
  const int warps = nch > kMinWarps ? nch : kMinWarps;
  const int rows_per_block = warps / nch;
  const long long blocks = ((long long)B + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cold_scan_kernel<T, kVec><<<(unsigned)blocks, warps * kLanes, 0, stream>>>(
      static_cast<const T*>(t0), static_cast<const T*>(warm),
      static_cast<const T*>(cold), static_cast<const T*>(keep_warm),
      static_cast<uint8_t*>(mask), B, n, nch, tpc);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* t0, const void* warm, const void* cold, const void* keep_warm,
             void* mask, int B, int n, int nch, int tpc, cudaStream_t stream) {
  const bool vec = n % kPerLane == 0 && (uintptr_t)t0 % 16 == 0 &&
                   (uintptr_t)warm % 16 == 0 && (uintptr_t)cold % 16 == 0 &&
                   (uintptr_t)mask % 4 == 0;
  return vec ? launch<T, true>(t0, warm, cold, keep_warm, mask, B, n, nch, tpc, stream)
             : launch<T, false>(t0, warm, cold, keep_warm, mask, B, n, nch, tpc, stream);
}

}  // namespace

// t0 (n,), warm/cold (B, n) row-major, keep_warm (B,), all of one dtype
// (0 = float32, 1 = float64); mask (B, n) bytes of 0/1. n_chunks (a power
// of two up to 16) warps a row, each tiles_per_chunk tiles of 128 requests
// (kernels/cold_scan.py::cold_scan_plan). Launches on `stream`, does not
// synchronise; returns the launch's CUDA error (0 = ok).
extern "C" int cold_scan_fwd(const void* t0, const void* warm, const void* cold,
                             const void* keep_warm, void* mask, int B, int n, int dtype,
                             int n_chunks, int tiles_per_chunk, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n_chunks < 1 || n_chunks > kMaxChunks || (n_chunks & (n_chunks - 1)) ||
      tiles_per_chunk < 1 ||
      (long long)n_chunks * tiles_per_chunk * kTile < (long long)n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(t0, warm, cold, keep_warm, mask, B, n, n_chunks,
                           tiles_per_chunk, s);
  if (dtype == 1)
    return dispatch<double>(t0, warm, cold, keep_warm, mask, B, n, n_chunks,
                            tiles_per_chunk, s);
  return (int)cudaErrorInvalidValue;
}
