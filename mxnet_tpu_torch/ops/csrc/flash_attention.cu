// Flash attention for sm_90a: the forward with its per-row log-sum-exp, the
// dQ pass and the dK/dV pass of the backward.
//
// Replaces: mxnet_tpu/ops/flash_attention.py `_fwd_kernel` (entry
// tpumx_flash_fwd), `_dq_kernel` (tpumx_flash_dq) and `_dkv_kernel`
// (tpumx_flash_dkv), the attention of the transformer LM's training step
// when `flash_attention(causal=True)` is its `attention=` callable.
//
// What bounds them on an H100: operations.  At the LM's training shape
// (B*H = 96 heads, T = 1024, D = 64, causal) the forward needs 4*D
// flops per live (query, key) pair (12.9 GFLOP), dQ 6*D (19.3) and dK/dV
// 8*D (25.8), against 50-75 MB of q, k, v, g and outputs: ~200 flops per
// byte in f32, far above the card's balance point for CUDA-core f32.
//
// Design (simple and right first).  The TPU grid's sequential innermost axis
// (k tiles for the forward and dQ, q tiles for dK/dV), which carries the
// running sums in VMEM scratch, becomes a loop inside one thread block.  A
// block of 256 threads owns one 64-row tile of one (batch, head) and walks
// the 64-row tiles of the other side, staged in shared memory as f32 (bf16
// inputs are widened as they are staged); q is multiplied by `scale` in f32
// while staged, as the reference does.  Thread (ty, tx) of the 16 x 16
// grid holds rows ty + 16*i (i < 4) of its tile against columns tx + 16*j
// of the other, so each score row lives in 16 lanes of one warp and its max
// and sum are 4-step shuffles; the same thread owns the same rows of the
// accumulators, so the online-softmax rescale needs no exchange.  Shared
// rows are padded to D+1 floats, which makes the strided column reads
// conflict-free.  Ragged T is masked in the kernel (rows past T load as 0,
// keys past T get probability 0), never padded in memory; with `causal`,
// tiles strictly above the diagonal are skipped.
//
// The backward keeps the reference's split into two passes: dQ (one block
// per q tile) and dK/dV (one block per k tile).  Every output element has
// one writer, so there are no atomics and the gradients are bitwise
// deterministic from run to run.  All arithmetic is f32 on CUDA cores
// (`fmaf`); tensor cores (mma.sync / wgmma with TMA) are later work.
//
// Layouts: q, k and v are (B, T, H, D) with D contiguous and the element
// strides of B, T and H given (the LM passes strided views of its fused
// qkv product, so nothing is copied); g, out, dq, dk and dv are contiguous
// (B, T, H, D); lse and delta are contiguous (B, H, T) float32.  D is 16,
// 32, 64 or 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kPad = kTile + 1;  // row stride of the (64, 64) score tiles
constexpr float kNeg = -1e30f;   // the reference's _NEG

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

// sum / max over the 16 lanes that hold one score row
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows row0 .. row0+63 of one head (src points at its row 0, `ld` elements
// between rows) into dst (64, D+1) as f32 times `mul`; rows past T are 0
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long ld, int row0, int Tn,
                                      float mul) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D, row = row0 + r;
    dst[r * (D + 1) + d] =
        row < Tn ? to_f32(src[static_cast<long long>(row) * ld + d]) * mul
                 : 0.f;
  }
}

// causal: key tile kt is live for the query tile starting at q0
__device__ __forceinline__ int k_tiles(int q0, int Tn, int causal) {
  const int n = (Tn + kTile - 1) / kTile;
  return causal ? min(n, (q0 + kTile - 1) / kTile + 1) : n;
}

// ---- kernel 6: forward ----------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, long long sb, long long st,
                 long long sh, T* __restrict__ out, float* __restrict__ lse,
                 int Tn, int H, float scale, int causal) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* Ps = Vs + kTile * LD;  // (64, kPad) probabilities
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // the longest causal rows first: they finish last otherwise
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  stage<T, D>(Qs, q + base, st, q0, Tn, scale);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int nk = k_tiles(q0, Tn, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done
    stage<T, D>(Ks, k + base, st, k0, Tn, 1.f);
    stage<T, D>(Vs, v + base, st, k0, Tn, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Tn && (!causal || kpos <= qpos);
        s[i][j] = ok ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tn) continue;
    const float lm = fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<long long>(b) * Tn + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] / lm);
    if (tx == 0) lse[static_cast<long long>(bh) * Tn + row] = m[i] + logf(lm);
  }
}

// ---- kernel 7: dQ ---------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, long long sb, long long st,
                long long sh, const T* __restrict__ g,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int Tn,
                int H, float scale, int causal) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Gs = Qs + kTile * LD;
  float* Ks = Gs + kTile * LD;
  float* Vs = Ks + kTile * LD;
  float* DSs = Vs + kTile * LD;  // (64, kPad) p * (dp - delta)
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long gbase = static_cast<long long>(b) * Tn * H * D +
                          static_cast<long long>(h) * D;
  stage<T, D>(Qs, q + base, st, q0, Tn, scale);
  stage<T, D>(Gs, g + gbase, static_cast<long long>(H) * D, q0, Tn, 1.f);
  float lse_r[4], del_r[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = static_cast<long long>(bh) * Tn + row;
    lse_r[i] = row < Tn ? lse[at] : 0.f;
    del_r[i] = row < Tn ? delta[at] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int nk = k_tiles(q0, Tn, causal);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    stage<T, D>(Ks, k + base, st, k0, Tn, 1.f);
    stage<T, D>(Vs, v + base, st, k0, Tn, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], gg[4], kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * LD + d];
        gg[i] = Gs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kk[j] = Ks[(tx + 16 * j) * LD + d];
        vv[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], kk[j], s[i][j]);
          dp[i][j] = fmaf(gg[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool ok = kpos < Tn && (!causal || kpos <= qpos);
        const float p = expf((ok ? s[i][j] : kNeg) - lse_r[i]);
        DSs[(ty + 16 * i) * kPad + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kTile; ++c) {
      float ds[4], kk[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = DSs[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) kk[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(ds[i], kk[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tn) continue;
    T* orow = dq + gbase + static_cast<long long>(row) * H * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

// ---- kernel 8: dK and dV --------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, long long sb, long long st,
                 long long sh, const T* __restrict__ g,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int Tn, int H, float scale, int causal) {
  constexpr int LD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;
  float* Gs = Qs + kTile * LD;
  float* Pt = Gs + kTile * LD;  // (64 keys, kPad) probabilities, transposed
  float* DSt = Pt + kTile * kPad;
  float* lse_s = DSt + kTile * kPad;
  float* del_s = lse_s + kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  // causal: the first k tiles see the most query tiles, and launch first
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long gbase = static_cast<long long>(b) * Tn * H * D +
                          static_cast<long long>(h) * D;
  stage<T, D>(Ks, k + base, st, k0, Tn, 1.f);
  stage<T, D>(Vs, v + base, st, k0, Tn, 1.f);
  float dk_acc[4][NJ], dv_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  const int nq = (Tn + kTile - 1) / kTile;
  // causal: query tiles strictly above this key tile's diagonal see none
  // of it (tiles are square, so that is every tile before blockIdx.x)
  for (int qt = causal ? blockIdx.x : 0; qt < nq; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    stage<T, D>(Qs, q + base, st, q0, Tn, scale);
    stage<T, D>(Gs, g + gbase, static_cast<long long>(H) * D, q0, Tn, 1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * Tn + row;
      lse_s[threadIdx.x] = row < Tn ? lse[at] : 0.f;
      del_s[threadIdx.x] = row < Tn ? delta[at] : 0.f;
    }
    __syncthreads();
    // transposed tiles: thread rows are keys, thread columns queries
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float kk[4], vv[4], a[4], gg[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty + 16 * i) * LD + d];
        vv[i] = Vs[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = Qs[(tx + 16 * j) * LD + d];
        gg[j] = Gs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[j], kk[i], s[i][j]);
          dp[i][j] = fmaf(gg[j], vv[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, qpos = q0 + r;
        const bool ok =
            kpos < Tn && qpos < Tn && (!causal || kpos <= qpos);
        const float p = expf((ok ? s[i][j] : kNeg) - lse_s[r]);
        Pt[(ty + 16 * i) * kPad + r] = p;
        DSt[(ty + 16 * i) * kPad + r] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kTile; ++r) {
      float p[4], ds[4], gg[NJ], a[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Pt[(ty + 16 * i) * kPad + r];
        ds[i] = DSt[(ty + 16 * i) * kPad + r];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        gg[j] = Gs[r * LD + tx + 16 * j];
        a[j] = Qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv_acc[i][j] = fmaf(p[i], gg[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], a[j], dk_acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Tn) continue;
    const long long at = gbase + static_cast<long long>(row) * H * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[at + tx + 16 * j] = from_f32<T>(dk_acc[i][j]);
      dv[at + tx + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// dynamic shared memory in bytes of each kernel
template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPad);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (4 * kTile * (D + 1) + kTile * kPad);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) *
         (4 * kTile * (D + 1) + 2 * kTile * kPad + 2 * kTile);
}

// above 48 KB a kernel must opt in to its dynamic shared memory, once
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess) *done = true;
  return err;
}

struct Shape {
  int B, Tn, H;
  float scale;
  int causal;
  cudaStream_t stream;
  dim3 grid() const {
    return dim3((Tn + kTile - 1) / kTile, static_cast<unsigned>(B * H));
  }
};

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, long long sb,
        long long st, long long sh, void* out, void* lse, const Shape& s) {
  static bool done = false;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err = opt_in(kernel, fwd_smem<D>(), &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s.grid(), kThreads, fwd_smem<D>(), s.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sb, st, sh, static_cast<T*>(out),
      static_cast<float*>(lse), s.Tn, s.H, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, long long sb,
       long long st, long long sh, const void* g, const void* lse,
       const void* delta, void* dq_out, const Shape& s) {
  static bool done = false;
  auto kernel = flash_dq_kernel<T, D>;
  cudaError_t err = opt_in(kernel, dq_smem<D>(), &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s.grid(), kThreads, dq_smem<D>(), s.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sb, st, sh, static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq_out), s.Tn, s.H, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, long long sb,
        long long st, long long sh, const void* g, const void* lse,
        const void* delta, void* dk_out, void* dv_out, const Shape& s) {
  static bool done = false;
  auto kernel = flash_dkv_kernel<T, D>;
  cudaError_t err = opt_in(kernel, dkv_smem<D>(), &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s.grid(), kThreads, dkv_smem<D>(), s.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sb, st, sh, static_cast<const T*>(g),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk_out), static_cast<T*>(dv_out), s.Tn, s.H, s.scale,
      s.causal);
  return static_cast<int>(cudaGetLastError());
}

// one instantiation per (dtype, head dim); dtype 0 = float32, 1 = bfloat16
#define TPUMX_DISPATCH(CALL)                                        \
  switch (dtype * 1000 + D) {                                       \
    case 16: return CALL(float, 16);                                \
    case 32: return CALL(float, 32);                                \
    case 64: return CALL(float, 64);                                \
    case 128: return CALL(float, 128);                              \
    case 1016: return CALL(__nv_bfloat16, 16);                      \
    case 1032: return CALL(__nv_bfloat16, 32);                      \
    case 1064: return CALL(__nv_bfloat16, 64);                      \
    case 1128: return CALL(__nv_bfloat16, 128);                     \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }

}  // namespace

// Every entry returns the cudaError_t of its launch (0 when T or B*H is 0).
extern "C" int tpumx_flash_fwd(const void* q, const void* k, const void* v,
                               long long sb, long long st, long long sh,
                               void* out, void* lse, int B, int Tn, int H,
                               int D, float scale, int causal, int dtype,
                               void* stream) {
  if (B * H <= 0 || Tn <= 0) return 0;
  const Shape s{B, Tn, H, scale, causal, static_cast<cudaStream_t>(stream)};
#define TPUMX_FWD(TY, DD) fwd<TY, DD>(q, k, v, sb, st, sh, out, lse, s)
  TPUMX_DISPATCH(TPUMX_FWD)
#undef TPUMX_FWD
}

extern "C" int tpumx_flash_dq(const void* q, const void* k, const void* v,
                              long long sb, long long st, long long sh,
                              const void* g, const void* lse,
                              const void* delta, void* dq_out, int B, int Tn,
                              int H, int D, float scale, int causal,
                              int dtype, void* stream) {
  if (B * H <= 0 || Tn <= 0) return 0;
  const Shape s{B, Tn, H, scale, causal, static_cast<cudaStream_t>(stream)};
#define TPUMX_DQ(TY, DD) \
  dq<TY, DD>(q, k, v, sb, st, sh, g, lse, delta, dq_out, s)
  TPUMX_DISPATCH(TPUMX_DQ)
#undef TPUMX_DQ
}

extern "C" int tpumx_flash_dkv(const void* q, const void* k, const void* v,
                               long long sb, long long st, long long sh,
                               const void* g, const void* lse,
                               const void* delta, void* dk_out, void* dv_out,
                               int B, int Tn, int H, int D, float scale,
                               int causal, int dtype, void* stream) {
  if (B * H <= 0 || Tn <= 0) return 0;
  const Shape s{B, Tn, H, scale, causal, static_cast<cudaStream_t>(stream)};
#define TPUMX_DKV(TY, DD) \
  dkv<TY, DD>(q, k, v, sb, st, sh, g, lse, delta, dk_out, dv_out, s)
  TPUMX_DISPATCH(TPUMX_DKV)
#undef TPUMX_DKV
}
