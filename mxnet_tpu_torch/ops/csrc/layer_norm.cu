// Fused LayerNorm(+tanh-GELU) over the last axis, for sm_90a.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py `_ln_kernel` (behind
// `layer_norm_fused`), the per-row LayerNorm the transformer LM runs twice
// per block and once at the end of every model step.
//
// What bounds it on an H100: bytes.  Each element is read once and written
// once with ~10 flops in between, so the least time is 2*M*C*sizeof(T)
// over 3.35 TB/s; at the serving shapes (M = 8..512 rows, C = 768) the
// call is short enough that launch latency dominates.
//
// Design: one warp per row, eight rows per 256-thread block.  Lanes stride
// the row with consecutive addresses (coalesced 128-byte transactions).
// One pass gives both sums, recentred on the row's first element exactly as
// the TPU kernel does (pivot one-pass E[x^2]-mean^2 without cancellation);
// a butterfly shuffle leaves the totals in every lane.  The second pass
// re-reads the row, which the first pass just brought into L1, so device
// memory sees one read and one write.  Statistics and the epilogue are f32
// for f32 and bf16 inputs alike.  Wider tiles, vector loads and several
// rows per warp for small C are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

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

// jax.nn.gelu(approximate=True), term for term
__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  float cdf = 0.5f * (1.0f + tanhf(k * (x + 0.044715f * (x * x * x))));
  return x * cdf;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                  const T* __restrict__ beta, T* __restrict__ out, int rows,
                  int cols, float eps, int gelu) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * cols;
  T* orow = out + static_cast<size_t>(row) * cols;
  const float pivot = to_f32(xr[0]);
  float s1 = 0.f, s2 = 0.f;
  for (int c = lane; c < cols; c += 32) {
    float v = to_f32(xr[c]) - pivot;
    s1 += v;
    s2 += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  const float mean_c = s1 / cols;
  const float var = fmaxf(s2 / cols - mean_c * mean_c, 0.f);
  const float inv = rsqrtf(var + eps);
  for (int c = lane; c < cols; c += 32) {
    float v = ((to_f32(xr[c]) - pivot) - mean_c) * inv * to_f32(gamma[c]) +
              to_f32(beta[c]);
    if (gelu) v = gelu_tanh(v);
    orow[c] = from_f32<T>(v);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* out,
           int rows, int cols, float eps, int gelu, cudaStream_t stream) {
  dim3 grid((rows + kWarps - 1) / kWarps);
  layer_norm_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out), rows, cols, eps,
      gelu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
extern "C" int tpumx_layer_norm(const void* x, const void* gamma,
                                const void* beta, void* out, int rows,
                                int cols, float eps, int gelu, int dtype,
                                void* stream) {
  if (rows <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, gamma, beta, out, rows, cols, eps, gelu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, out, rows, cols, eps, gelu,
                                 s);
  return static_cast<int>(cudaErrorInvalidValue);
}
