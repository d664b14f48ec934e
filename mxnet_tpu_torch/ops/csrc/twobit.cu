// 2-bit gradient compression with error feedback, for sm_90a: pack and
// unpack in the "pallas" wire layout.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_twobit_pack_kernel` and
// `_twobit_unpack_kernel` (behind `twobit_pack` / `twobit_unpack`), which
// GradientCompression runs on every gradient of a compressed training step.
//
// Layout (the wire format, bit for bit).  The flat gradient is cut into rows
// of 2048 elements; each row packs into 128 uint32 words, word j of row r
// holding element r*2048 + i*128 + j in bits 2i..2i+1 (i = 0..15).  Codes:
// 0b01 where g >= t, 0b10 where g <= -t (both, 0b11, only when t <= 0), 0
// otherwise, with g = grad + residual.  The TPU wrapper pads the flat input
// with zeros to whole rows (to a multiple of 64 rows past 64); the padded
// words are part of the format.
//
// What bounds them on an H100: bytes.  Pack reads grad and residual and
// writes the new residual (12 bytes an element) plus 4 bytes a packed word;
// unpack reads the words and writes 4 (f32) or 2 (bf16) bytes an element.
// A handful of compares and selects an element is far below the operation
// bound.
//
// Design: one thread per packed word.  The thread walks its 16 elements at
// stride 128, so at each step a warp reads 32 neighbouring f32 (coalesced
// 128-byte transactions) and has 32 independent loads in flight.  No padded
// copy is made: an element past the end is taken as g = 0 (the zero pad of
// the reference), contributes its code to the word and writes no residual.
// The residual is (g - sel(pos, t, 0)) + sel(neg, t, 0) in that order,
// selects and no multiply, so no fma contraction can change a bit against
// the plain version.  Unpack writes code 1 as +t, code 2 as -t and any
// other as 0, with t already rounded to the output type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;      // 2-bit codes per word
constexpr int kWordsPerRow = 128;
constexpr int kRow = kLanes * kWordsPerRow;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
twobit_pack_kernel(const float* __restrict__ grad,
                   const float* __restrict__ residual,
                   uint32_t* __restrict__ packed, float* __restrict__ newres,
                   long long n, long long words, float t) {
  const long long w = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (w >= words) return;
  const long long base = (w / kWordsPerRow) * kRow + (w % kWordsPerRow);
  uint32_t acc = 0u;
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const long long idx = base + static_cast<long long>(i) * kWordsPerRow;
    const bool live = idx < n;
    const float g = live ? grad[idx] + residual[idx] : 0.f;
    const bool pos = g >= t;
    const bool neg = g <= -t;
    if (live) newres[idx] = (g - (pos ? t : 0.f)) + (neg ? t : 0.f);
    acc |= (static_cast<uint32_t>(pos) | (static_cast<uint32_t>(neg) << 1))
           << (2 * i);
  }
  packed[w] = acc;
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
twobit_unpack_kernel(const uint32_t* __restrict__ packed, T* __restrict__ out,
                     long long n, long long words, float t) {
  const long long w = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (w >= words) return;
  const long long base = (w / kWordsPerRow) * kRow + (w % kWordsPerRow);
  if (base >= n) return;
  const uint32_t word = packed[w];
  const T pos = from_f32<T>(t), neg = from_f32<T>(-t), zero = from_f32<T>(0.f);
#pragma unroll
  for (int i = 0; i < kLanes; ++i) {
    const long long idx = base + static_cast<long long>(i) * kWordsPerRow;
    if (idx < n) {
      const uint32_t code = (word >> (2 * i)) & 3u;
      out[idx] = code == 1u ? pos : (code == 2u ? neg : zero);
    }
  }
}

unsigned int blocks_for(long long words) {
  return static_cast<unsigned int>((words + kThreads - 1) / kThreads);
}

}  // namespace

// grad, residual, newres: n contiguous f32; packed: `words` uint32 (a whole
// number of 128-word rows covering n).  Returns the launch's cudaError_t.
extern "C" int tpumx_twobit_pack(const void* grad, const void* residual,
                                 void* packed, void* newres, long long n,
                                 long long words, float t, void* stream) {
  if (words <= 0) return 0;
  twobit_pack_kernel<<<blocks_for(words), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(grad), static_cast<const float*>(residual),
      static_cast<uint32_t*>(packed), static_cast<float*>(newres), n, words,
      t);
  return static_cast<int>(cudaGetLastError());
}

// packed: `words` uint32; out: n contiguous elements of dtype 0 = float32,
// 1 = bfloat16; t already rounded to that dtype.
extern "C" int tpumx_twobit_unpack(const void* packed, void* out, long long n,
                                   long long words, float t, int dtype,
                                   void* stream) {
  if (words <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(packed);
  if (dtype == 0)
    twobit_unpack_kernel<float><<<blocks_for(words), kThreads, 0, s>>>(
        p, static_cast<float*>(out), n, words, t);
  else if (dtype == 1)
    twobit_unpack_kernel<__nv_bfloat16><<<blocks_for(words), kThreads, 0, s>>>(
        p, static_cast<__nv_bfloat16*>(out), n, words, t);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
