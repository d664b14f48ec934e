// Paged attention over one layer's KV pool, for sm_90a.
//
// Replaces: mxnet_tpu/ops/paged_attention.py `_paged_kernel` (behind
// `paged_attention`), the attention of the generation engine's every model
// step: decode (T = 1 query per slot) and chunked prefill (T = a seq bucket
// at B = 1), against K/V that live in fixed-size blocks named by a per-row
// block table.
//
// What bounds it on an H100: bytes.  The work is the live K/V blocks of
// each row (read once), plus q and the output; the least time is those
// bytes over 3.35 TB/s.  Flops per byte are ~2*T_tile, far below the
// card's ridge for T = 1; for the prefill tiles the f32 CUDA-core math
// (67 TFLOP/s) is what bounds it.
//
// Design.  The TPU kernel runs a grid (B, H, W) whose W axis is sequential
// and carries the online-softmax state in VMEM scratch.  Blocks here run in
// no order, so the W axis becomes a loop inside one thread block of four
// warps, one block per (query tile, head h, row b):
//   - the block reads its row's table entries and max_pos[b] itself (there
//     is no scalar prefetch); a table entry of 0 (the null block) or a
//     logical block past max_pos[b] is skipped, as is a block wholly past
//     the tile's last query position (every score in it is masked);
//   - a live (block_size, D) K/V tile is staged in shared memory as f32
//     (K rows padded to D+1 floats so lanes reading different keys hit
//     different banks), then walked 32 keys at a time: lane j scores key
//     j, the warp reduces max and sum with shuffles, and each lane
//     accumulates D/32 output dims with the probabilities broadcast by
//     shuffle; m, l and acc are f32 per query in registers;
//   - prefill tiles (T > 4): the block stages each tile once and every
//     warp attends its own four queries to it;
//   - decode (T <= 4): one tile would leave three warps idle, so the warps
//     split the row's blocks instead (warp w takes logical blocks w, w+4,
//     ...), each staging its own tiles with no block-wide barrier, and the
//     four partial (m, l, acc) states merge in shared memory at the end;
//   - mask is cache position <= query position with the TPU kernel's
//     -1e30 fill; a query that saw no live block (max_pos = -1) writes 0.
// The scale is the caller's f32 1/sqrt(D).  Split-K across blocks for long
// contexts at small batch, wgmma for the prefill tiles and TMA staging are
// later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kQPW = 4;  // queries per warp in a prefill tile
constexpr float kNeg = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Stage one (bs, D) K/V tile of head h from physical block `blk` as f32,
// threads `first`.. stepping by `stride`.
template <typename T>
__device__ __forceinline__ void stage_tile(
    const T* __restrict__ k_pool, const T* __restrict__ v_pool, float* k_s,
    float* v_s, int blk, int h, int H, int D, int bs, int first,
    int stride) {
  const size_t blk_off = static_cast<size_t>(blk) * bs * H * D;
  for (int i = first; i < bs * D; i += stride) {
    const int j = i / D, d = i - j * D;
    const size_t src = blk_off + (static_cast<size_t>(j) * H + h) * D + d;
    k_s[j * (D + 1) + d] = to_f32(k_pool[src]);
    v_s[j * D + d] = to_f32(v_pool[src]);
  }
}

// One warp attends one query (qv, at cache position qpos) to a staged tile
// whose first key sits at cache position `base`: the online-softmax update
// of the TPU kernel's `_step`, 32 keys at a time.
template <int DPL>
__device__ __forceinline__ void attend_tile(
    const float* k_s, const float* v_s, const float* qv, int qpos, int base,
    int D, int bs, int lane, float& m, float& l, float (&acc)[DPL]) {
  for (int kc = 0; kc < bs; kc += 32) {
    const int key = kc + lane;
    const bool exists = key < bs;
    float s = -INFINITY;
    if (exists) {
      const float* kr = k_s + key * (D + 1);
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot += qv[d] * kr[d];
      s = (base + key <= qpos) ? dot : kNeg;
    }
    const float m_new = fmaxf(m, warp_max(s));
    const float p = exists ? expf(s - m_new) : 0.f;
    const float alpha = expf(m - m_new);
    l = alpha * l + warp_sum(p);
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    const int nk = min(32, bs - kc);
    for (int jj = 0; jj < nk; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
      const float* vr = v_s + (kc + jj) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] += pj * vr[d];
      }
    }
    m = m_new;
  }
}

// out row = acc / l, the lane's D/32 dims
template <typename T, int DPL>
__device__ __forceinline__ void write_row(T* __restrict__ orow, float l,
                                          const float (&acc)[DPL], int D,
                                          int lane) {
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    if (d < D) orow[d] = from_f32<T>(acc[i] * inv);
  }
}

// Prefill tiles: kWarps * kQPW queries per block, each live tile staged
// once for the whole block.
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_tile_kernel(const T* __restrict__ q,
                            const T* __restrict__ k_pool,
                            const T* __restrict__ v_pool,
                            const int* __restrict__ tables,
                            const int* __restrict__ positions,
                            const int* __restrict__ max_pos,
                            T* __restrict__ out, int T_len, int H, int D,
                            int bs, int W, float scale) {
  constexpr int QT = kWarps * kQPW;
  extern __shared__ float smem[];
  float* k_s = smem;                      // [bs][D + 1]
  float* v_s = k_s + bs * (D + 1);        // [bs][D]
  float* q_s = v_s + bs * D;              // [QT][D], pre-scaled
  __shared__ int tile_last_pos;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0 = blockIdx.x * QT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int mp = max_pos[b];

  // stage the tile's queries (scaled in f32, as the TPU kernel does)
  for (int i = tid; i < QT * D; i += kWarps * 32) {
    const int tq = i / D, d = i - tq * D;
    const int t = t0 + tq;
    float v = 0.f;
    if (t < T_len)
      v = to_f32(q[((static_cast<size_t>(b) * T_len + t) * H + h) * D + d]) *
          scale;
    q_s[i] = v;
  }
  if (tid == 0) {
    int last = -1;
    for (int tq = 0; tq < QT && t0 + tq < T_len; ++tq)
      last = max(last, positions[b * T_len + t0 + tq]);
    tile_last_pos = last;
  }

  const int tw = t0 + warp * kQPW;          // this warp's first query
  const int nq = max(0, min(kQPW, T_len - tw));
  int qpos[kQPW];
  float m[kQPW], l[kQPW], acc[kQPW][DPL];
#pragma unroll
  for (int j = 0; j < kQPW; ++j) {
    qpos[j] = j < nq ? positions[b * T_len + tw + j] : -1;
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }
  __syncthreads();
  const int last_pos = tile_last_pos;

  for (int w = 0; w < W; ++w) {
    const int blk = tables[b * W + w];
    const int base = w * bs;
    // block-uniform skip: null entry, past the row's last valid query, or
    // past every query of this tile
    if (blk == 0 || base > mp || base > last_pos) continue;
    __syncthreads();  // previous tile fully consumed
    stage_tile(k_pool, v_pool, k_s, v_s, blk, h, H, D, bs, tid, kWarps * 32);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kQPW; ++j) {
      if (j >= nq) break;  // warp-uniform
      attend_tile<DPL>(k_s, v_s, q_s + (warp * kQPW + j) * D, qpos[j], base,
                       D, bs, lane, m[j], l[j], acc[j]);
    }
  }

#pragma unroll
  for (int j = 0; j < kQPW; ++j) {
    if (j >= nq) break;
    T* orow = out + ((static_cast<size_t>(b) * T_len + tw + j) * H + h) * D;
    write_row<T, DPL>(orow, l[j], acc[j], D, lane);
  }
}

// Decode (T <= kWarps): one block per (head, row); the warps split the
// row's logical blocks and merge their partial softmax states at the end.
template <typename T, int DPL>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_split_kernel(const T* __restrict__ q,
                             const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ positions,
                             const int* __restrict__ max_pos,
                             T* __restrict__ out, int T_len, int H, int D,
                             int bs, int W, float scale) {
  constexpr int QN = kWarps;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tile_f = bs * (2 * D + 1);
  float* k_s = smem + warp * tile_f;       // this warp's [bs][D + 1]
  float* v_s = k_s + bs * (D + 1);         // this warp's [bs][D]
  float* q_s = smem + kWarps * tile_f;     // [QN][D], pre-scaled
  float* st_m = q_s + QN * D;              // [kWarps][QN]
  float* st_l = st_m + kWarps * QN;        // [kWarps][QN]
  float* st_acc = st_l + kWarps * QN;      // [kWarps][QN][D]

  for (int i = tid; i < T_len * D; i += kWarps * 32) {
    const int t = i / D, d = i - t * D;
    q_s[i] =
        to_f32(q[((static_cast<size_t>(b) * T_len + t) * H + h) * D + d]) *
        scale;
  }
  const int mp = max_pos[b];
  int qpos[QN];
  int last_pos = -1;
  float m[QN], l[QN], acc[QN][DPL];
#pragma unroll
  for (int j = 0; j < QN; ++j) {
    qpos[j] = j < T_len ? positions[b * T_len + j] : -1;
    last_pos = max(last_pos, qpos[j]);
    m[j] = kNeg;
    l[j] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[j][i] = 0.f;
  }
  __syncthreads();  // queries staged

  for (int w = warp; w < W; w += kWarps) {
    const int blk = tables[b * W + w];
    const int base = w * bs;
    if (blk == 0 || base > mp || base > last_pos) continue;  // warp-uniform
    __syncwarp();  // this warp's previous tile fully consumed
    stage_tile(k_pool, v_pool, k_s, v_s, blk, h, H, D, bs, lane, 32);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < QN; ++j) {
      if (j >= T_len) break;  // warp-uniform
      attend_tile<DPL>(k_s, v_s, q_s + j * D, qpos[j], base, D, bs, lane,
                       m[j], l[j], acc[j]);
    }
  }

  // merge the warps' partial states: M = max m, L = sum l * e^(m - M),
  // acc = sum acc * e^(m - M); a warp that saw nothing has m = -1e30, l = 0
#pragma unroll
  for (int j = 0; j < QN; ++j) {
    if (j >= T_len) break;
    if (lane == 0) {
      st_m[warp * QN + j] = m[j];
      st_l[warp * QN + j] = l[j];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) st_acc[(warp * QN + j) * D + d] = acc[j][i];
    }
  }
  __syncthreads();
  const int j = warp;  // warp j finalizes query j
  if (j < T_len) {
    float M = kNeg;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, st_m[w * QN + j]);
    float L = 0.f;
    float o[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) o[i] = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(st_m[w * QN + j] - M);
      L += c * st_l[w * QN + j];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) o[i] += c * st_acc[(w * QN + j) * D + d];
      }
    }
    T* orow = out + ((static_cast<size_t>(b) * T_len + j) * H + h) * D;
    write_row<T, DPL>(orow, L, o, D, lane);
  }
}

template <typename T, int DPL>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const int* tables, const int* positions, const int* max_pos,
           void* out, int B, int T_len, int H, int D, int bs, int W,
           float scale, cudaStream_t stream) {
  const bool split = T_len <= kWarps;
  size_t smem;
  dim3 grid;
  void (*kern)(const T*, const T*, const T*, const int*, const int*,
               const int*, T*, int, int, int, int, int, float);
  if (split) {
    smem = sizeof(float) *
           (static_cast<size_t>(kWarps) * bs * (2 * D + 1) + kWarps * D +
            2 * kWarps * kWarps + static_cast<size_t>(kWarps) * kWarps * D);
    grid = dim3(1, H, B);
    kern = paged_attention_split_kernel<T, DPL>;
  } else {
    constexpr int QT = kWarps * kQPW;
    smem = sizeof(float) * (static_cast<size_t>(bs) * (2 * D + 1) + QT * D);
    grid = dim3((T_len + QT - 1) / QT, H, B);
    kern = paged_attention_tile_kernel<T, DPL>;
  }
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kern<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, positions, max_pos,
      static_cast<T*>(out), T_len, H, D, bs, W, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const int* tables, const int* positions, const int* max_pos,
             void* out, int B, int T_len, int H, int D, int bs, int W,
             float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k_pool, v_pool, tables, positions, max_pos, out,
                        B, T_len, H, D, bs, W, scale, stream);
  if (D <= 64)
    return launch<T, 2>(q, k_pool, v_pool, tables, positions, max_pos, out,
                        B, T_len, H, D, bs, W, scale, stream);
  if (D <= 128)
    return launch<T, 4>(q, k_pool, v_pool, tables, positions, max_pos, out,
                        B, T_len, H, D, bs, W, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (B, T, H, D); k_pool, v_pool: (num_blocks, bs, H, D), all
// contiguous in `dtype` (0 = float32, 1 = bfloat16); tables (B, W),
// positions (B, T), max_pos (B,) int32.  Returns the launch's cudaError_t.
extern "C" int tpumx_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* tables,
                                     const void* positions,
                                     const void* max_pos, void* out, int B,
                                     int T_len, int H, int D, int bs, int W,
                                     float scale, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(positions);
  const int* mp = static_cast<const int*>(max_pos);
  if (dtype == 0)
    return dispatch<float>(q, k_pool, v_pool, tb, ps, mp, out, B, T_len, H,
                           D, bs, W, scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k_pool, v_pool, tb, ps, mp, out, B,
                                   T_len, H, D, bs, W, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
