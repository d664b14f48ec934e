// Train-mode BatchNorm over channels-last data, for sm_90a: the per-channel
// statistics (stats) and the affine pass (normalize).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_bn_stats_kernel` and
// `_bn_norm_kernel` (behind `bn_train_fused`), the two passes every
// channels-last BatchNorm of a training forward makes over its (M, C)
// activation, M = batch x height x width.
//
// What bounds them on an H100: bytes.  Stats reads M*C items once and does
// three flops per item; normalize reads and writes them once with one fma.
// The least times are M*C*sizeof(T) and 2*M*C*sizeof(T) over 3.35 TB/s.
//
// Design.  Both kernels lay a 256-thread block out as (256 / lanes) rows by
// `lanes` channel lanes; lane l owns `vec` adjacent channels (16-byte loads:
// 8 bf16 or 4 f32, or 1 when C is no multiple of that), so a warp reads
// whole contiguous rows.  blockIdx.y picks a tile of lanes*vec channels,
// blockIdx.x a range of rows.
//
// Stats.  The TPU grid walks M in order, adding into one (1, C) block; here
// M is split across blocks instead (about a thousand in all, so C = 64 at
// 1.6 M rows fills the card as well as C = 2048 at 6 K rows).  Each thread
// sums x - pivot and its square in f32 over its rows (pivot = row 0, the
// reference's recentring against E[x^2] - mean^2 cancellation); the block
// adds its row groups in a fixed order and writes one partial per split.  A
// second launch adds the partials per channel, again in a fixed order, and
// finishes the reference's formula: mean_c = s1/M, var = max(s2/M -
// mean_c^2, 0), mean = mean_c + pivot.  No float atomics, so two runs give
// the same bits.
//
// Normalize.  Each thread loads its channels' f32 scale and shift once and
// streams its rows: y = fma(x, scale, shift), stored in x's dtype (round to
// nearest even for bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxVec = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*p);
  } else {
    static_assert(sizeof(T) * VEC == 16, "16-byte vectors");
    uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(e[j]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    *p = from_f32<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) e[j] = from_f32<T>(v[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = __ldg(p + j);
}

// grid (splits, tiles); part is (2, splits, C) f32: sums, then squares
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const T* __restrict__ x, float* __restrict__ part, int M,
                 int C, int lanes, int rows_per_split, int splits) {
  const int lane = threadIdx.x % lanes;
  const int row0 = threadIdx.x / lanes;
  const int step = kThreads / lanes;
  const int tile_w = lanes * VEC;
  const int c = blockIdx.y * tile_w + lane * VEC;
  const int split = blockIdx.x;
  const long long r_begin = static_cast<long long>(split) * rows_per_split;
  const long long r_end =
      min(static_cast<long long>(M), r_begin + rows_per_split);
  float s1[VEC], s2[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s1[j] = s2[j] = 0.f;
  if (c < C) {
    float piv[VEC];
    load_vec<T, VEC>(x + c, piv);
#pragma unroll 4
    for (long long r = r_begin + row0; r < r_end; r += step) {
      float v[VEC];
      load_vec<T, VEC>(x + r * C + c, v);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[j] - piv[j];
        s1[j] += d;
        s2[j] = fmaf(d, d, s2[j]);
      }
    }
  }
  __shared__ float sh1[kThreads * kMaxVec];
  __shared__ float sh2[kThreads * kMaxVec];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    sh1[row0 * tile_w + lane * VEC + j] = s1[j];
    sh2[row0 * tile_w + lane * VEC + j] = s2[j];
  }
  __syncthreads();
  // tile_w <= 32 lanes x 8 = kThreads: one channel per thread, row groups
  // added in order
  const int t = threadIdx.x;
  const int ch = blockIdx.y * tile_w + t;
  if (t < tile_w && ch < C) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < step; ++r) {
      a += sh1[r * tile_w + t];
      b += sh2[r * tile_w + t];
    }
    part[static_cast<size_t>(split) * C + ch] = a;
    part[static_cast<size_t>(splits + split) * C + ch] = b;
  }
}

// 32 channels per block; 8 warps take every 8th split, then warp 0 adds the
// 8 sums in order
template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_stats_final(const T* __restrict__ x, const float* __restrict__ part,
               float* __restrict__ mean, float* __restrict__ var, int M,
               int C, int splits) {
  constexpr int kGroups = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int group = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int s = group; s < splits; s += kGroups) {
      a += part[static_cast<size_t>(s) * C + c];
      b += part[static_cast<size_t>(splits + s) * C + c];
    }
  }
  __shared__ float sa[kThreads];
  __shared__ float sb[kThreads];
  sa[threadIdx.x] = a;
  sb[threadIdx.x] = b;
  __syncthreads();
  if (group == 0 && c < C) {
    for (int g = 1; g < kGroups; ++g) {
      a += sa[g * 32 + lane];
      b += sb[g * 32 + lane];
    }
    const float n = static_cast<float>(M);
    const float mean_c = a / n;
    var[c] = fmaxf(b / n - mean_c * mean_c, 0.f);
    mean[c] = mean_c + to_f32(x[c]);
  }
}

// grid (row blocks, tiles)
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_normalize(const T* __restrict__ x, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ out, int M,
             int C, int lanes, int rows_per_block) {
  const int lane = threadIdx.x % lanes;
  const int row0 = threadIdx.x / lanes;
  const int step = kThreads / lanes;
  const int c = blockIdx.y * lanes * VEC + lane * VEC;
  if (c >= C) return;
  float sc[VEC], sh[VEC];
  load_f32<VEC>(scale + c, sc);
  load_f32<VEC>(shift + c, sh);
  const long long r_begin =
      static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r_end =
      min(static_cast<long long>(M), r_begin + rows_per_block);
#pragma unroll 8
  for (long long r = r_begin + row0; r < r_end; r += step) {
    float v[VEC];
    load_vec<T, VEC>(x + r * C + c, v);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = fmaf(v[j], sc[j], sh[j]);
    store_vec<T, VEC>(out + r * C + c, v);
  }
}

bool valid_tiling(int C, int vec, int lanes, int native_vec) {
  if (vec != 1 && vec != native_vec) return false;
  if (vec != 1 && C % vec != 0) return false;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0) return false;
  return true;
}

template <typename T, int VEC>
int stats(const void* x, void* part, void* mean, void* var, int M, int C,
          int lanes, int rows_per_split, int splits, cudaStream_t s) {
  const int tiles = (C + lanes * VEC - 1) / (lanes * VEC);
  bn_stats_partial<T, VEC><<<dim3(splits, tiles), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<float*>(part), M, C, lanes,
      rows_per_split, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  bn_stats_final<T><<<(C + 31) / 32, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(part),
      static_cast<float*>(mean), static_cast<float*>(var), M, C, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int normalize(const void* x, const void* scale, const void* shift, void* out,
              int M, int C, int lanes, int rows_per_block, cudaStream_t s) {
  const int tiles = (C + lanes * VEC - 1) / (lanes * VEC);
  const int blocks = (M + rows_per_block - 1) / rows_per_block;
  bn_normalize<T, VEC><<<dim3(blocks, tiles), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<T*>(out), M, C, lanes,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous (M, C); part: (2, splits, C) f32 scratch; mean, var: (C,)
// f32.  dtype: 0 = float32, 1 = bfloat16.  vec: 1, or 16 / sizeof(T) when C
// is a multiple of it and x is 16-byte aligned.  lanes: a power of two <= 32.
// Returns the cudaError_t of the launches.
extern "C" int tpumx_bn_stats(const void* x, void* part, void* mean,
                              void* var, int M, int C, int vec, int lanes,
                              int rows_per_split, int splits, int dtype,
                              void* stream) {
  if (M <= 0 || C <= 0) return 0;
  if (splits <= 0 || rows_per_split <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && valid_tiling(C, vec, lanes, 4))
    return vec == 4 ? stats<float, 4>(x, part, mean, var, M, C, lanes,
                                      rows_per_split, splits, s)
                    : stats<float, 1>(x, part, mean, var, M, C, lanes,
                                      rows_per_split, splits, s);
  if (dtype == 1 && valid_tiling(C, vec, lanes, 8))
    return vec == 8 ? stats<__nv_bfloat16, 8>(x, part, mean, var, M, C,
                                              lanes, rows_per_split, splits,
                                              s)
                    : stats<__nv_bfloat16, 1>(x, part, mean, var, M, C,
                                              lanes, rows_per_split, splits,
                                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// out = x * scale + shift per channel, in x's dtype; scale, shift: (C,) f32.
extern "C" int tpumx_bn_normalize(const void* x, const void* scale,
                                  const void* shift, void* out, int M, int C,
                                  int vec, int lanes, int rows_per_block,
                                  int dtype, void* stream) {
  if (M <= 0 || C <= 0) return 0;
  if (rows_per_block <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && valid_tiling(C, vec, lanes, 4))
    return vec == 4 ? normalize<float, 4>(x, scale, shift, out, M, C, lanes,
                                          rows_per_block, s)
                    : normalize<float, 1>(x, scale, shift, out, M, C, lanes,
                                          rows_per_block, s);
  if (dtype == 1 && valid_tiling(C, vec, lanes, 8))
    return vec == 8 ? normalize<__nv_bfloat16, 8>(x, scale, shift, out, M,
                                                  C, lanes, rows_per_block, s)
                    : normalize<__nv_bfloat16, 1>(x, scale, shift, out, M,
                                                  C, lanes, rows_per_block,
                                                  s);
  return static_cast<int>(cudaErrorInvalidValue);
}
