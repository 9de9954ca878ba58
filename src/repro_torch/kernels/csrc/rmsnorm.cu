// RMSNorm for Hopper (sm_90a), with the residual add or the SiLU gate that
// comes before a norm taken in the same launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm. Per
// row of D elements, with float32 statistics:
//
//     y = g * rsqrt(mean(g^2) + eps) * (1 + w)      (cast once to g's type)
//
// where g, the row normalised, comes from a prologue (a template
// parameter):
//   none  g = a                                     (the TPU kernel's function)
//   add   g = s = a + b, rounded to promote(a, b) as an eager add rounds it;
//         s is written too (the residual stream), and the statistics are
//         taken from the rounded s, as `x = x + h; rmsnorm(x)` takes them
//   gate  g = a * silu(b), silu(b) rounded to b's type and the product to
//         promote(a, b), as eager bfloat16 rounds `y * silu(z)` (mamba2's
//         norm_y)
// a, b and w are each float32 or bfloat16; y and s take promote(a, b) (a's
// type without a prologue). a and b are (rows, D) with row strides of
// their own (b may be a column slice of a wider projection), y and s are
// (rows, D) contiguous, w is (D,).
//
// What bounds it on an H100: bytes. Each element is read once (twice with a
// prologue) and written once (twice for add), with a few operations and a
// share of one reduction: granite's prefill norm (512 x 1536 bf16, no
// prologue) moves 3.1 MB, 0.94 us at 3.35 TB/s. A decode step's norm (1-4
// rows of 1024-4096) moves a few KB: there the launch and one row's chain
// of dependent loads, reduction and stores are the time, and what the
// prologues save is the eager add, silu and multiply launches around it.
//
// Design: a block is (G threads a row) x (R rows). G is a power of two up
// to a warp (lanes of one warp for narrow rows: qk-norm's 128 takes 8 or
// 16 lanes) and whole warps above, up to 512; each thread holds its units in
// registers, a unit being 16 bytes of a where every row of every operand
// is 16-byte aligned (the vector path) or else one element. The host
// picks G so that a thread holds one unit where the rows are fewer than
// the SMs (a decode step's 1-64 rows: more threads, shorter chains) and
// two otherwise (a prefill's rows), and R so that wide shapes of few rows
// run as many short blocks (granite's 512 prefill rows are 512 blocks of
// 3 warps, not 128 blocks of 4 rows) and narrow rows share blocks of 256
// threads. A launch plan sweep (units 1/2/4 a thread x 128/256/512
// threads a block at the served shapes) chose this: PERF.md. Rows within
// kMaxG threads of two units take the narrow instantiation (registers for
// two units: 31-64 registers), wider ones the wide (32 elements a thread,
// up to 128 registers); with the wide registers everywhere, one unit a
// thread at granite's shape took 4.68 us against 3.61. All loads (a, b and w) are issued before the
// first use, so w's round trip overlaps a's rather than following the
// reduction. The sum of squares reduces by warp shuffles within a row's
// lanes and, for rows wider than a warp, once through shared memory, each
// warp summing the row's partials with a shuffle; the scale pass runs from
// the registers and stores in the same pattern as the loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr int kNarrowUnits = 2;   // units a thread holds: most rows
constexpr int kWidePer = 32;      // elements a thread holds: rows too wide for that
constexpr int kMaxG = 512;        // threads a row
constexpr int kMaxThreads = 512;  // threads a block
constexpr int kBlockThreads = 256;  // a block's threads where rows are many
constexpr int kUnitsPerThread = 2;  // what the host aims a thread to hold

enum Prologue { kNone = 0, kAdd = 1, kGate = 2 };

// Elements are handled as their bits: float, or uint16_t for bfloat16 (a
// union of trivial types; the upper half of a float is its bfloat16 value).
using bf16_bits = uint16_t;

// the type an eager op of A and B returns: float if either is float
template <typename A, typename B>
using promote_t = typename std::conditional<
    std::is_same<A, float>::value || std::is_same<B, float>::value, float,
    bf16_bits>::type;

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

// v rounded to T and back: what a tensor of type T holds
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// N elements of T as whole 16-byte words (or one 8-byte word); N == 1 is
// one element
template <typename T, int N>
union Pack {
  static constexpr int kBytes = N * (int)sizeof(T);
  using Word = typename std::conditional<
      (kBytes >= 16), uint4,
      typename std::conditional<(kBytes >= 8), uint2, T>::type>::type;
  Word w[kBytes / (int)sizeof(Word)];
  T e[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_unit(const T* p, float* dst) {
  using P = Pack<T, N>;
  P pk;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(pk.w) / sizeof(pk.w[0])); ++i)
    pk.w[i] = reinterpret_cast<const typename P::Word*>(p)[i];
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = to_f(pk.e[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_unit(T* p, const float* src) {
  using P = Pack<T, N>;
  P pk;
#pragma unroll
  for (int j = 0; j < N; ++j) pk.e[j] = from_f<T>(src[j]);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(pk.w) / sizeof(pk.w[0])); ++i)
    reinterpret_cast<typename P::Word*>(p)[i] = pk.w[i];
}

// kP: the prologue. kVec: every row of every operand is 16-byte aligned
// for a's vectors (a unit is 16 bytes of a, else one element). kWide: a
// thread holds up to 32 elements (rows wider than kMaxG threads of
// kNarrowUnits units), else kNarrowUnits units: registers, and so the
// blocks an SM holds, follow what the row needs.
template <int kP, typename TA, typename TB, typename TW, bool kVec, bool kWide>
__global__ void __launch_bounds__(kMaxThreads) rmsnorm_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b, const TW* __restrict__ w,
    promote_t<TA, TB>* __restrict__ s_out, promote_t<TA, TB>* __restrict__ y_out,
    int rows, int D, long long lda, long long ldb, float eps) {
  using TO = promote_t<TA, TB>;
  constexpr int kV = kVec ? 16 / (int)sizeof(TA) : 1;  // elements a unit
  constexpr int kUnits = kWide ? kWidePer / kV : kNarrowUnits;
  constexpr int kPer = kUnits * kV;  // elements a thread holds
  // a block is (G threads a row) x (rows): no division on the way in
  const int G = (int)blockDim.x;
  const int t = (int)threadIdx.x;
  const long long row = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;  // dead threads still join the reduction
  const int nunits = D / kV;
  const TA* ar = a + row * lda;
  const TB* br = b + row * ldb;

  float v[kPer], u[kPer], wv[kPer];
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int e = (t + i * G) * kV;
    if (live && t + i * G < nunits) {
      load_unit<TA, kV>(ar + e, v + i * kV);
      if (kP != kNone) load_unit<TB, kV>(br + e, u + i * kV);
      load_unit<TW, kV>(w + e, wv + i * kV);
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    if (live && t + i * G < nunits) {
#pragma unroll
      for (int j = 0; j < kV; ++j) {
        float g = v[i * kV + j];
        if (kP == kAdd) g = round_to<TO>(g + u[i * kV + j]);
        if (kP == kGate) {
          const float z = u[i * kV + j];
          g = round_to<TO>(g * round_to<TB>(z / (1.f + expf(-z))));
        }
        v[i * kV + j] = g;
        ss = fmaf(g, g, ss);
      }
    }
  }

  // the row's sum: shuffles within its lanes, then across its warps
  for (int o = (G < kWarp ? G : kWarp) / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (G > kWarp) {  // G is whole warps: a row's are threadIdx.y's
    __shared__ float s_part[kMaxThreads / kWarp];
    const int w0 = (int)threadIdx.y * (G / kWarp);
    if (t % kWarp == 0) s_part[w0 + t / kWarp] = ss;
    __syncthreads();
    // every warp of the row sums the row's partials the same way: one
    // shared load a lane and 5 shuffles, not a serial walk
    const int lane = t % kWarp;
    ss = lane < G / kWarp ? s_part[w0 + lane] : 0.f;
#pragma unroll
    for (int o = kWarp / 2; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  }
  const float r = rsqrtf(ss / (float)D + eps);

  TO* sr = kP == kAdd ? s_out + row * D : nullptr;
  TO* yr = y_out + row * D;
#pragma unroll
  for (int i = 0; i < kUnits; ++i) {
    const int e = (t + i * G) * kV;
    if (live && t + i * G < nunits) {
      float o[kV];
#pragma unroll
      for (int j = 0; j < kV; ++j) o[j] = (v[i * kV + j] * r) * (1.f + wv[i * kV + j]);
      store_unit<TO, kV>(yr + e, o);
      if (kP == kAdd) store_unit<TO, kV>(sr + e, v + i * kV);  // exact: already rounded
    }
  }
}

int sm_count() {
  static int count[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    count[dev] = n > 0 ? n : 132;
  }
  return count[dev];
}

template <int kP, typename TA, typename TB, typename TW, bool kVec, bool kWide>
int launch_plan(const void* a, const void* b, const void* w, void* s_out, void* y_out,
                int rows, int D, long long lda, long long ldb, int G, int R, float eps,
                cudaStream_t stream) {
  const long long blocks = ((long long)rows + R - 1) / R;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  using TO = promote_t<TA, TB>;
  rmsnorm_kernel<kP, TA, TB, TW, kVec, kWide><<<(unsigned)blocks, dim3(G, R), 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<const TW*>(w),
      static_cast<TO*>(s_out), static_cast<TO*>(y_out), rows, D, lda, ldb, eps);
  return (int)cudaGetLastError();
}

template <int kP, typename TA, typename TB, typename TW, bool kVec>
int launch(const void* a, const void* b, const void* w, void* s_out, void* y_out,
           int rows, int D, long long lda, long long ldb, float eps,
           cudaStream_t stream) {
  constexpr int kV = kVec ? 16 / (int)sizeof(TA) : 1;
  const int nunits = D / kV;
  // G threads a row, each about per units: a power of two up to a warp,
  // whole warps above
  const int per = rows < sm_count() ? 1 : kUnitsPerThread;
  int G = (nunits + per - 1) / per;
  if (G <= kWarp) {
    int p2 = 1;
    while (p2 < G) p2 *= 2;
    G = p2;
  } else {
    G = (G + kWarp - 1) / kWarp * kWarp;
  }
  if (G > kMaxG) G = kMaxG;
  const bool wide = nunits > G * kNarrowUnits;
  if (nunits > G * (kWidePer / kV)) return (int)cudaErrorInvalidValue;
  // rows a block: about two blocks an SM where rows allow, at most
  // kBlockThreads threads (one row if G is wider), and whole warps
  const int fill = rows / (2 * sm_count());
  int R = G >= kBlockThreads ? 1 : kBlockThreads / G;
  if (fill < R) R = fill > 1 ? fill : 1;
  if (R * G < kWarp) R = kWarp / G;
  else R = (R * G + kWarp - 1) / kWarp * kWarp / G;
  if (R * G > kMaxThreads) R = kMaxThreads / G;
  return wide ? launch_plan<kP, TA, TB, TW, kVec, true>(a, b, w, s_out, y_out, rows, D,
                                                        lda, ldb, G, R, eps, stream)
              : launch_plan<kP, TA, TB, TW, kVec, false>(a, b, w, s_out, y_out, rows, D,
                                                         lda, ldb, G, R, eps, stream);
}

// p (of elements of type T, read or written in units of n) may take whole
// units: aligned to the unit's bytes, up to 16
template <typename T>
bool unit_aligned(const void* p, int n) {
  size_t bytes = (size_t)n * sizeof(T);
  if (bytes > 16) bytes = 16;
  return (uintptr_t)p % bytes == 0;
}

template <int kP, typename TA, typename TB, typename TW>
int dispatch(const void* a, const void* b, const void* w, void* s_out, void* y_out,
             int rows, int D, long long lda, long long ldb, float eps,
             cudaStream_t stream) {
  using TO = promote_t<TA, TB>;
  constexpr int kV = 16 / (int)sizeof(TA);
  const bool vec = D % kV == 0 && lda % kV == 0 && unit_aligned<TA>(a, kV) &&
                   unit_aligned<TW>(w, kV) && unit_aligned<TO>(y_out, kV) &&
                   (kP == kNone || (ldb % kV == 0 && unit_aligned<TB>(b, kV))) &&
                   (kP != kAdd || unit_aligned<TO>(s_out, kV));
  return vec ? launch<kP, TA, TB, TW, true>(a, b, w, s_out, y_out, rows, D, lda, ldb,
                                            eps, stream)
             : launch<kP, TA, TB, TW, false>(a, b, w, s_out, y_out, rows, D, lda, ldb,
                                             eps, stream);
}

template <int kP, typename TA, typename TB>
int dispatch_w(int w_dtype, const void* a, const void* b, const void* w, void* s_out,
               void* y_out, int rows, int D, long long lda, long long ldb, float eps,
               cudaStream_t s) {
  return w_dtype == 0
             ? dispatch<kP, TA, TB, float>(a, b, w, s_out, y_out, rows, D, lda, ldb, eps, s)
             : dispatch<kP, TA, TB, bf16_bits>(a, b, w, s_out, y_out, rows, D, lda, ldb,
                                               eps, s);
}

template <int kP>
int dispatch_ab(int a_dtype, int b_dtype, int w_dtype, const void* a, const void* b,
                const void* w, void* s_out, void* y_out, int rows, int D, long long lda,
                long long ldb, float eps, cudaStream_t s) {
  using bf16 = bf16_bits;
  if (a_dtype == 0)
    return b_dtype == 0
               ? dispatch_w<kP, float, float>(w_dtype, a, b, w, s_out, y_out, rows, D,
                                              lda, ldb, eps, s)
               : dispatch_w<kP, float, bf16>(w_dtype, a, b, w, s_out, y_out, rows, D,
                                             lda, ldb, eps, s);
  return b_dtype == 0
             ? dispatch_w<kP, bf16, float>(w_dtype, a, b, w, s_out, y_out, rows, D, lda,
                                           ldb, eps, s)
             : dispatch_w<kP, bf16, bf16>(w_dtype, a, b, w, s_out, y_out, rows, D, lda,
                                          ldb, eps, s);
}

}  // namespace

// a: (rows, D) with row stride lda; b: (rows, D) with row stride ldb (read
// by the add and gate prologues only); w: (D,); y_out and s_out (written by
// the add prologue only): (rows, D) contiguous, of type promote(a, b) (a's
// without a prologue). Dtypes: 0 = float32, 1 = bfloat16. prologue: 0 none,
// 1 add, 2 gate. Launches on `stream`, does not synchronise; returns the
// launch's CUDA error (0 = ok).
extern "C" int rmsnorm_fwd(const void* a, const void* b, const void* w, void* s_out,
                           void* y_out, int rows, int D, long long lda, long long ldb,
                           int a_dtype, int b_dtype, int w_dtype, int prologue,
                           float eps, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (a_dtype < 0 || a_dtype > 1 || b_dtype < 0 || b_dtype > 1 || w_dtype < 0 ||
      w_dtype > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (prologue) {
    case kNone:  // b is not read: its type is a's
      return a_dtype == 0
                 ? dispatch_w<kNone, float, float>(w_dtype, a, a, w, s_out, y_out, rows,
                                                   D, lda, lda, eps, s)
                 : dispatch_w<kNone, bf16_bits, bf16_bits>(w_dtype, a, a, w, s_out, y_out,
                                                           rows, D, lda, lda, eps, s);
    case kAdd:
      return dispatch_ab<kAdd>(a_dtype, b_dtype, w_dtype, a, b, w, s_out, y_out, rows,
                               D, lda, ldb, eps, s);
    case kGate:
      return dispatch_ab<kGate>(a_dtype, b_dtype, w_dtype, a, b, w, s_out, y_out, rows,
                                D, lda, ldb, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
