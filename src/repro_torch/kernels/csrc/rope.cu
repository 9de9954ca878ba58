// Rotary position embedding of q and k in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's rope (src/repro/models/
// layers.py::rope) is plain jnp, which XLA fuses into the attention
// sublayer. Eager PyTorch runs it as ~17 launches a tensor, twice a layer,
// one of them a copy of theta from pageable host memory that waits for the
// stream to drain. This kernel takes q and k in one launch a layer; theta
// is an argument, so nothing is copied to the card and the angle table is
// never stored.
//
// Per position p (positions[r] of row r = b * T + t) and pair index
// i < half = d / 2, in float32 and in the order the eager ops on the card
// round (kernels/rope.py::rope_plain; the division by half is PyTorch's
// multiply by the reciprocal of a scalar divisor):
//
//     e = -i * (1 / half)      freq = theta ** e      ang = p * freq
//     o[i]        = x[i] * cos(ang) - x[i + half] * sin(ang)
//     o[i + half] = x[i + half] * cos(ang) + x[i] * sin(ang)
//
// each product and sum rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn:
// nothing contracts into an FMA), o rounded once to x's type. powf, cosf
// and sinf are CUDA's accurate functions, the ones PyTorch's pow, cos and
// sin call for float32; the build sets no fast-math. The result is the
// plain version's, bit for bit.
//
// What bounds it on an H100: bytes. q and k are read once and written once
// (qwen3-32b at T = 1536: 64 + 8 heads of 128 in bf16, 56.6 MB, 16.9 us at
// 3.35 TB/s); the angles cost half cosf and sinf a position.
//
// Design: a block takes P consecutive rows (positions). Its threads first
// compute the P x half angles' cos and sin once into shared memory, then
// rotate every head of q and of k at those rows: a thread takes one unit
// (16 bytes: 8 bf16 or 4 float32 values) of the first half of a head and
// the matching unit of the second half, so consecutive threads read
// consecutive 16-byte words of a head. Where half is not a whole number
// of units, or a pointer is not 16-byte aligned, a unit is one element.
// The host picks P so that a block has about kItemsPerBlock units of work
// and the grid at least two blocks an SM where the rows allow.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kItemsPerBlock = 2048;  // units of work a block aims at
constexpr int kMaxD = 256;
constexpr int kMaxRows = 32;  // rows a block: 32 x 128 angles, 32 KB of cos and sin

using bf16_bits = uint16_t;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16_bits v) {
  return __uint_as_float((unsigned)v << 16);  // exact
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16_bits from_f<bf16_bits>(float v) {
  // round to nearest even, as torch's .to(bfloat16) on the card
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

// N elements of T: one 16-byte word where N * sizeof(T) == 16, else one element
template <typename T, int N>
union Pack {
  using Word = typename std::conditional<(N * sizeof(T) == 16), uint4, T>::type;
  Word w;
  T e[N];
};

template <typename T, int N>
__device__ __forceinline__ void load_unit(const T* p, float* dst) {
  Pack<T, N> pk;
  pk.w = *reinterpret_cast<const typename Pack<T, N>::Word*>(p);
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = to_f(pk.e[j]);
}

template <typename T, int N>
__device__ __forceinline__ void store_unit(T* p, const float* src) {
  Pack<T, N> pk;
#pragma unroll
  for (int j = 0; j < N; ++j) pk.e[j] = from_f<T>(src[j]);
  *reinterpret_cast<typename Pack<T, N>::Word*>(p) = pk.w;
}

// kV: elements a unit (16 / sizeof(T), or 1). TP: the positions' type.
template <typename T, int kV, typename TP>
__global__ void __launch_bounds__(kThreads) rope_qk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, T* __restrict__ qo,
    T* __restrict__ ko, const TP* __restrict__ pos, int rows, int T_len, int H,
    int K, int half, int pos_batched, int P, float theta) {
  extern __shared__ float angles[];  // cos then sin, P x half each
  float* cs = angles;
  float* sn = angles + P * half;
  const int row0 = blockIdx.x * P;
  const int np = min(P, rows - row0);
  const float inv_half = __fdiv_rn(1.0f, (float)half);

  for (int idx = threadIdx.x; idx < np * half; idx += kThreads) {
    const int p = idx / half;
    const int i = idx - p * half;
    const int r = row0 + p;
    const float fp = (float)pos[pos_batched ? r : r % T_len];
    const float freq = powf(theta, __fmul_rn(-(float)i, inv_half));
    const float ang = __fmul_rn(fp, freq);
    cs[idx] = cosf(ang);
    sn[idx] = sinf(ang);
  }
  __syncthreads();

  const int nu = half / kV;  // units in a half of a head
  const int per_row = (H + K) * nu;
  const int d = 2 * half;
  for (int idx = threadIdx.x; idx < np * per_row; idx += kThreads) {
    const int p = idx / per_row;
    const int rem = idx - p * per_row;
    const int h = rem / nu;
    const int i0 = (rem - h * nu) * kV;
    const long long r = row0 + p;
    const long long off = h < H ? (r * H + h) * d : (r * K + (h - H)) * d;
    const T* src = (h < H ? q : k) + off;
    T* dst = (h < H ? qo : ko) + off;
    float x1[kV], x2[kV], o1[kV], o2[kV];
    load_unit<T, kV>(src + i0, x1);
    load_unit<T, kV>(src + half + i0, x2);
    const float* c = cs + p * half + i0;
    const float* s = sn + p * half + i0;
#pragma unroll
    for (int j = 0; j < kV; ++j) {
      o1[j] = __fsub_rn(__fmul_rn(x1[j], c[j]), __fmul_rn(x2[j], s[j]));
      o2[j] = __fadd_rn(__fmul_rn(x2[j], c[j]), __fmul_rn(x1[j], s[j]));
    }
    store_unit<T, kV>(dst + i0, o1);
    store_unit<T, kV>(dst + half + i0, o2);
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

template <typename T, int kV, typename TP>
int launch(const void* q, const void* k, void* qo, void* ko, const void* pos, int rows,
           int T_len, int H, int K, int half, int pos_batched, float theta,
           cudaStream_t stream) {
  const int per_row = (H + K) * (half / kV);
  int P = kItemsPerBlock / (per_row > 0 ? per_row : 1);
  const int fill = rows / (2 * sm_count());  // rows a block at two blocks an SM
  if (P > fill) P = fill;
  if (P > kMaxRows * 128 / half) P = kMaxRows * 128 / half;
  if (P < 1) P = 1;
  const long long blocks = ((long long)rows + P - 1) / P;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)P * half * sizeof(float);
  rope_qk_kernel<T, kV, TP><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(qo),
      static_cast<T*>(ko), static_cast<const TP*>(pos), rows, T_len, H, K, half,
      pos_batched, P, theta);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

template <typename T, typename TP>
int dispatch(const void* q, const void* k, void* qo, void* ko, const void* pos,
             int rows, int T_len, int H, int K, int half, int pos_batched, float theta,
             cudaStream_t stream) {
  constexpr int kV = 16 / (int)sizeof(T);
  const bool vec = half % kV == 0 && aligned16(q) && aligned16(k) && aligned16(qo) &&
                   aligned16(ko);
  return vec ? launch<T, kV, TP>(q, k, qo, ko, pos, rows, T_len, H, K, half,
                                 pos_batched, theta, stream)
             : launch<T, 1, TP>(q, k, qo, ko, pos, rows, T_len, H, K, half,
                                pos_batched, theta, stream);
}

}  // namespace

// q: (B, T, H, d) and k: (B, T, K, d), contiguous, of one type (dtype 0 =
// float32, 1 = bfloat16); qo and ko: their rotated copies, same shapes;
// pos: (T,) or, with pos_batched, (B, T), contiguous, int32 (pos_dtype 0)
// or int64 (1). d even, up to 256. Launches on `stream`, does not
// synchronise; returns the launch's CUDA error (0 = ok).
extern "C" int rope_qk_fwd(const void* q, const void* k, void* qo, void* ko,
                           const void* pos, int B, int T, int H, int K, int d,
                           int dtype, int pos_dtype, int pos_batched, float theta,
                           void* stream) {
  if (B <= 0 || T <= 0 || d <= 0 || H + K <= 0) return 0;
  if (d % 2 || d > kMaxD || H < 0 || K < 0 || dtype < 0 || dtype > 1 ||
      pos_dtype < 0 || pos_dtype > 1 || (long long)B * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rows = B * T, half = d / 2;
  if (dtype == 0)
    return pos_dtype == 0
               ? dispatch<float, int>(q, k, qo, ko, pos, rows, T, H, K, half, pos_batched,
                                      theta, s)
               : dispatch<float, long long>(q, k, qo, ko, pos, rows, T, H, K, half,
                                            pos_batched, theta, s);
  return pos_dtype == 0
             ? dispatch<bf16_bits, int>(q, k, qo, ko, pos, rows, T, H, K, half,
                                        pos_batched, theta, s)
             : dispatch<bf16_bits, long long>(q, k, qo, ko, pos, rows, T, H, K, half,
                                              pos_batched, theta, s);
}
