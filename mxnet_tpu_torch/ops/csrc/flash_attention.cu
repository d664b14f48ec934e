// Flash attention for sm_90a: the forward with its per-row log-sum-exp, the
// dQ pass and the dK/dV pass of the backward.
//
// Replaces: mxnet_tpu/ops/flash_attention.py `_fwd_kernel` (entry
// tpumx_flash_fwd), `_dq_kernel` (tpumx_flash_dq) and `_dkv_kernel`
// (tpumx_flash_dkv), the attention of the transformer LM's training step
// when `flash_attention(causal=True)` is its `attention=` callable.
//
// Two designs sit behind the three entries, chosen by dtype:
//
//  dtype     forward                dQ                    dK/dV
//  bfloat16  flash_fwd_tc_kernel    flash_dq_tc_kernel    flash_dkv_tc_kernel
//  float32   flash_fwd_tf32_kernel  flash_dq_tf32_kernel  flash_dkv_tf32_kernel
//
// What bounds them on an H100.  At the LM's training shape (B*H = 96
// heads, T = 1024, D = 64, causal) the forward needs 4*D flops per live
// (query, key) pair (12.9 GFLOP), dQ 6*D (19.3) and dK/dV 8*D (25.8),
// against 50-75 MB of q, k, v, g and outputs.  In bf16 on the tensor cores
// (989 TFLOP/s, 3.35 TB/s) the forward is bound by bytes: 50 MB is 0.0151
// ms against 0.013 ms of products (and 50.4 M exps, ~0.013 ms on the
// SFUs); dQ and dK/dV are bound by operations, 0.0196 and 0.0261 ms.  In
// f32 all three are bound by operations: f32 accuracy on the tensor cores
// takes three TF32 products (495 / 3 = 165 TFLOP/s, against 67 on the
// CUDA cores), 0.078, 0.117 and 0.156 ms.
//
// bf16: the tensor-core design (flash_*_tc_kernel), FlashAttention-2 on
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), written in inline PTX.
// Four warps own 64 rows of one (batch, head), 16 a warp.  Tiles of the
// other side stream from device memory by 16-byte cp.async copies through
// a 2-stage ring in shared memory, the next tile's copy in flight while
// this one computes; rows are padded by 16 bytes so that ldmatrix reads
// them without bank conflicts.  A operands are in registers (the forward's
// q, or dK/dV's k and v, loaded once by ldmatrix at D <= 64; p and ds built
// from the f32 accumulators, whose m16n8 layout of two adjacent n-tiles is the k16 A
// layout); B operands come by ldmatrix, `.trans` where the contraction runs
// over keys or queries.  The scores are products of bf16 inputs, exact in
// f32, scaled by `scale` in f32 after the product.  p and ds, the A
// operands of the second products (P V, P^T g, dS^T q, dS K), are each
// split into a bf16 high part and a bf16 low part (hi = bf16(x), lo =
// bf16(x - hi)) and multiplied twice, since one bf16 rounding of them does
// not hold the causal rows to a bf16 tolerance; those sums stay f32.  The
// softmax runs in base 2 (scores prescaled by log2 e; exp2f), and lse is
// written in natural log.  Masks apply only on tiles that cross the
// diagonal or the ragged end.  Outputs go through shared memory, so their
// stores are 16 bytes and coalesced.
//
// dQ (19.3 GFLOP at the LM shape, operation-bound at 0.0196 ms) works
// query-major: per 64-key tile, S = Q K^T and dP = g V^T with q and g as A
// operands, dS = P (dP - delta) in dP's registers, then dQ += dS K with k
// by ldmatrix.trans.  Only its third product is split, it has no online
// rescale, and `scale` multiplies dQ once at the store.  It reads q and g
// from shared memory at every product, so that its dQ accumulator (64
// registers a thread at D = 128) and the S and dP tiles do not spill;
// holding them in registers instead was no faster at D = 64 or 128.
// dK/dV works key-major (S^T = K Q^T, dP^T = V g^T), so k and v stay A
// operands; at D = 128 it keeps k and v in shared memory and takes
// 32-query tiles, so that its two f32 accumulators (dK, dV: 128 registers
// a thread) do not spill.
//
// f32: the 3xTF32 design (flash_*_tf32_kernel), the bf16 kernels'
// skeleton (four warps of 16 rows, the other side's tiles through a
// 2-stage cp.async ring, masks on edge tiles only, outputs through shared
// memory) on mma.sync.m16n8k8 with TF32 operands.  One
// TF32 rounding keeps 11 of f32's 24 bits (relative error 2^-11), which
// misses an f32 tolerance (rtol 1e-4), and an error in s moves p by the
// same relative amount; so every operand of every product, the score
// products too, is split, x = big + small with big = tf32(x) rounded to
// nearest with ties away from zero and small = x - big truncated to TF32
// (split_tf32), and each product is big*big + big*small + small*big with
// f32 sums (a product of two TF32 values is exact in f32; the dropped
// small*small is ~2^-22 relative, small's truncation at most 2^-21).  q is multiplied by `scale` in f32 before it is split,
// as the reference scales it.  Tiles are staged as f32 rows of D + 4
// floats and split as each fragment is read (32-bit shared loads:
// ldmatrix moves 16-bit elements), so shared memory holds one copy of each
// tile; p and ds are split from their accumulators in registers.  An
// accumulator's columns 2t and 2t+1 become the A operand's contraction
// indices t and t+4 (acc_to_a), so a B operand read across rows (k in dS
// K, g in P^T g, q in dS^T q) takes rows 2t and 2t+1 in that order; with
// rows of D + 4 floats that read and the row-wise one both hit 32
// distinct banks, so q and g (dK/dV) and k (dQ), read both ways, need no
// swizzle.  The split, three instructions an element, and not the
// tensor cores, bounds these kernels: the other side's tiles are 16 or
// 32 rows and the register budget is set for three blocks an SM
// (FwdTf32, DqTf32, DkvTf32), so that enough warps hide its latency.  The
// softmax runs in base 2 as above, on scores of the scaled q.  The forward
// is the bf16 forward's online softmax on these products: S = (scale q)
// K^T with q scaled and split exactly as dQ and dK/dV split it, so that
// their recomputed p = exp(s - lse) sees the forward's s; P split from its
// accumulator for O += P V; 1/l multiplies O at the store.
//
// Every design masks ragged T in the kernel (rows past T load as 0 and are
// not written, keys past T get probability 0), never pads in memory, and
// skips causal tiles strictly above the diagonal.  The backward keeps the
// reference's split into two passes: dQ (one block per q tile) and dK/dV
// (one block per k tile).  Every output element has one writer, so there
// are no atomics and the gradients are bitwise deterministic from run to
// run.
//
// Layouts: q, k and v are (B, T, H, D) with D contiguous and the element
// strides of B, T and H given (the LM passes strided views of its fused
// qkv product, so nothing is copied); g, out, dq, dk and dv are contiguous
// (B, T, H, D); lse and delta are contiguous (B, H, T) float32.  D is 16,
// 32, 64 or 128.  Every kernel copies 16-byte chunks, so q, k, v and g
// start on 16 bytes and the B, T and H strides are multiples of 16 bytes
// (the wrapper copies inputs that are not).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;
constexpr float kNeg = -1e30f;   // the reference's _NEG

// max(l, 1e-30) as the reference takes it: a NaN sum stays NaN (fmaxf
// would give 1e-30), so a NaN row's lse is NaN as the reference's is
__device__ __forceinline__ float max_sum(float l) {
  return l < 1e-30f ? 1e-30f : l;
}

// causal: key tile kt is live for the query tile starting at q0
__device__ __forceinline__ int k_tiles(int q0, int Tn, int causal) {
  const int n = (Tn + kTile - 1) / kTile;
  return causal ? min(n, (q0 + kTile - 1) / kTile + 1) : n;
}

// ---- bf16 on the tensor cores: building blocks ----------------------------
using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;  // four warps, 16 rows of the block's tile each
constexpr int kTcPad = 8;        // bf16 of padding after each shared row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory, asynchronously; zeros when
// !valid (src then points at a valid row and is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.  `_t` delivers each matrix transposed.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate.  Lane l
// (g = l / 4, t = l % 4) holds d[0..1] at row g, columns 2t and 2t+1, and
// d[2..3] at row g+8; a[0..3] at (g, 2t), (g+8, 2t), (g, 2t+8), (g+8, 2t+8)
// (pairs of columns); b0 at rows 2t, 2t+1 of column g, b1 at rows 2t+8, 2t+9.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats x0, x1 as a pair of bf16 pairs, hi = bf16(x) and lo =
// bf16(x - hi) (round to nearest; x0 in the low halves): hi + lo carries
// 16 of x's 24 bits
__device__ __forceinline__ void split_bf16(unsigned& hi, unsigned& lo,
                                           float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// The A operand of one k16 step, split into hi and lo parts, from the f32
// accumulators of the two adjacent n-tiles c0 (columns 0-7) and c1 (8-15)
// of a 16x16 product.  One bf16 rounding of p or ds takes the causal
// rows' outputs past a bf16 tolerance (rtol 2e-2, atol 1e-3) against f32
// arithmetic on the same inputs: early rows mix few keys with weights near
// 1, so 2^-9 of a weight is not averaged away.  Two products, hi and lo,
// keep 16 bits.
__device__ __forceinline__ void acc_to_a2(unsigned (&hi)[4],
                                          unsigned (&lo)[4],
                                          const float (&c0)[4],
                                          const float (&c1)[4]) {
  split_bf16(hi[0], lo[0], c0[0], c0[1]);
  split_bf16(hi[1], lo[1], c0[2], c0[3]);
  split_bf16(hi[2], lo[2], c1[0], c1[1]);
  split_bf16(hi[3], lo[3], c1[2], c1[3]);
}

// d += (hi + lo) b: the two products of a split A operand
__device__ __forceinline__ void mma_bf16x2(float (&d)[4],
                                           const unsigned (&hi)[4],
                                           const unsigned (&lo)[4],
                                           unsigned b0, unsigned b1) {
  mma_bf16(d, lo, b0, b1);
  mma_bf16(d, hi, b0, b1);
}

// Per-lane ldmatrix offsets inside a 16x16 block of a row-major shared
// tile (ld elements between rows):
//  - a: the A operand (rows are the product's rows): row l & 15, column
//    8 * (l >> 4) gives a[0..3];
//  - b_n: the B operand from a tile stored [n][k] (keys by d, for q k^T):
//    row (l & 7) + 8 * (l >> 4), column 8 * ((l >> 3) & 1) gives b0, b1 of
//    n-tile 0 in r[0..1] and of n-tile 1 in r[2..3];
//  - b_t: the B operand from a tile stored [k][n] (keys by d, for p v),
//    with `.trans`: row (l & 7) + 8 * ((l >> 3) & 1), column 8 * (l >> 4),
//    the same register order.
struct Lanes {
  int a, b_n, b_t;
  __device__ __forceinline__ Lanes(int lane, int ld)
      : a((lane & 15) * ld + (lane >> 4) * 8),
        b_n(((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8),
        b_t(((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8) {}
};

// Shared rows of the tensor-core kernels hold D elements and 16 bytes of
// padding: kTcPad bf16 or kF32Pad floats.
constexpr int kF32Pad = 4;
template <typename T> constexpr int kRowPad = 16 / sizeof(T);
static_assert(kRowPad<bf16> == kTcPad && kRowPad<float> == kF32Pad);

// rows row0 .. row0+R-1 of one head (src points at its row 0, `ld` elements
// between rows) into dst (R, D + kRowPad<T>) by 16-byte cp.async; rows past
// T are zeros
template <int R, int D, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long ld,
                                          int row0, int Tn) {
  constexpr int kPer = kRowPad<T>, kChunks = D / kPer;
  for (int c = threadIdx.x; c < R * kChunks; c += kTcThreads) {
    const int r = c / kChunks, ch = c % kChunks, row = row0 + r;
    const bool ok = row < Tn;
    cp_async16(dst + r * (D + kPer) + ch * kPer,
               src + static_cast<long long>(ok ? row : 0) * ld + ch * kPer,
               ok);
  }
}

// the same for R f32 values (lse or delta of R rows), 4 bytes each
template <int R>
__device__ __forceinline__ void copy_vals(float* dst, const float* src,
                                          int row0, int Tn) {
  for (int i = threadIdx.x; i < R; i += kTcThreads) {
    const int row = row0 + i;
    const bool ok = row < Tn;
    cp_async4(dst + i, src + (ok ? row : 0), ok);
  }
}

__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// one warp's 16 rows of an f32 accumulator tile (16, D), times mul0 (rows
// g) and mul1 (rows g+8), to rows row0.. of a (B, T, H, D) output of type T
// (dst at row 0 of the head, `ld` elements between rows) through the warp's
// 16 rows of shared memory (`stage`), with 16-byte coalesced stores; rows
// past T are not written
template <int D, typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst, long long ld,
                                           int row0, int Tn, T* stage,
                                           const float (&c)[D / 8][4],
                                           float mul0, float mul1, int lane) {
  constexpr int kPer = kRowPad<T>, LDS = D + kPer, kChunks = D / kPer;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    put2(stage + g * LDS + n * 8 + 2 * t, c[n][0] * mul0, c[n][1] * mul0);
    put2(stage + (g + 8) * LDS + n * 8 + 2 * t, c[n][2] * mul1,
         c[n][3] * mul1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, ch = i % kChunks, row = row0 + r;
    if (row < Tn)
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(row) * ld +
                                ch * kPer) =
          *reinterpret_cast<const uint4*>(stage + r * LDS + ch * kPer);
  }
}

// ---- kernel 6 on the tensor cores: bf16 forward ---------------------------
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, long long sb, long long st,
                    long long sh, bf16* __restrict__ out,
                    float* __restrict__ lse, int Tn, int H, float scale,
                    int causal) {
  constexpr int LDS = D + kTcPad, KD = D / 16, ND = D / 8, NS = kTile / 8;
  constexpr int kTileElems = kTile * LDS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ks = Qs + kTileElems;      // two stages
  bf16* Vs = Ks + 2 * kTileElems;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const Lanes at(lane, LDS);
  // the longest causal rows first: they finish last otherwise
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int r0 = q0 + warp * 16;  // this warp's first row
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const int nk = k_tiles(q0, Tn, causal);

  copy_rows<kTile, D>(Qs, q + base, st, q0, Tn);
  copy_rows<kTile, D>(Ks, k + base, st, 0, Tn);
  copy_rows<kTile, D>(Vs, v + base, st, 0, Tn);
  cp_async_commit();

  unsigned qf[KD][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // running max (base-2 units) of rows g and g+8, and this lane's part of
  // their running sums (the quad's parts are added at the end)
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float sl2 = scale * kLog2e;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    if (kt + 1 < nk) {  // the next tile's copy overlaps this tile's math
      const int nxt = ((kt + 1) & 1) * kTileElems;
      copy_rows<kTile, D>(Ks + nxt, k + base, st, k0 + kTile, Tn);
      copy_rows<kTile, D>(Vs + nxt, v + base, st, k0 + kTile, Tn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], Qs + warp * 16 * LDS + at.a + kk * 16);
    }
    const bf16* Kt = Ks + (kt & 1) * kTileElems;
    const bf16* Vt = Vs + (kt & 1) * kTileElems;

    // S = Q K^T: 16 rows x 64 keys a warp
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        unsigned bk[4];
        ldsm_x4(bk, Kt + n2 * 16 * LDS + at.b_n + kk * 16);
        mma_bf16(s[2 * n2], qf[kk], bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], qf[kk], bk[2], bk[3]);
      }

    // scale (into base-2 units), mask, online softmax
    const bool edge = k0 + kTile > Tn || (causal && k0 + kTile - 1 > r0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          const int qpos = r0 + g + (e >> 1) * 8;
          if (kpos >= Tn || (causal && kpos > qpos)) x = kNeg;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P split into bf16 hi and lo in registers as the A operand
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      unsigned ph[4], pl[4];
      acc_to_a2(ph, pl, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        unsigned bv[4];
        ldsm_x4_t(bv, Vt + kk * 16 * LDS + at.b_t + dn * 16);
        mma_bf16x2(o[2 * dn], ph, pl, bv[0], bv[1]);
        mma_bf16x2(o[2 * dn + 1], ph, pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  float lm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lm[r] = max_sum(l[r]);
  }
  // out through this warp's own 16 rows of Qs (read only by this warp)
  store_rows<D>(out + (static_cast<long long>(b) * Tn * H + h) * D,
                static_cast<long long>(H) * D, r0, Tn, Qs + warp * 16 * LDS,
                o, 1.f / lm[0], 1.f / lm[1], lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + g + 8 * r;
      if (row < Tn)
        lse[static_cast<long long>(bh) * Tn + row] =
            m[r] * kLn2 + logf(lm[r]);
    }
  }
}

// ---- kernel 8 on the tensor cores: bf16 dK and dV -------------------------
// Query rows per tile, and whether k and v live in registers (D <= 64) or
// are read from shared memory at every product (D = 128, so that the dK
// and dV accumulators keep the registers).
template <int D> struct DkvTc {
  static constexpr int kRows = D <= 64 ? 64 : 32;
  static constexpr bool kKvInRegs = D <= 64;
};

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, long long sb, long long st,
                    long long sh, const bf16* __restrict__ g,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Tn, int H, float scale,
                    int causal) {
  constexpr int BQ = DkvTc<D>::kRows;
  constexpr bool kRegs = DkvTc<D>::kKvInRegs;
  constexpr int LDS = D + kTcPad, KD = D / 16, ND = D / 8, NQ = BQ / 8;
  constexpr int kQElems = BQ * LDS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Ks = reinterpret_cast<bf16*>(tc_smem);
  bf16* Vs = Ks + kTile * LDS;
  bf16* Qs = Vs + kTile * LDS;  // two stages
  bf16* Gs = Qs + 2 * kQElems;  // two stages
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kQElems);  // two stages
  float* Ds = Ls + 2 * BQ;                                 // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const Lanes at(lane, LDS);
  // causal: the first k tiles see the most query tiles, and launch first
  const int k0 = blockIdx.x * kTile;
  const int kr0 = k0 + warp * 16;  // this warp's first key
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long gld = static_cast<long long>(H) * D;
  const long long gbase = static_cast<long long>(b) * Tn * gld +
                          static_cast<long long>(h) * D;
  const float* lse_bh = lse + static_cast<long long>(bh) * Tn;
  const float* del_bh = delta + static_cast<long long>(bh) * Tn;
  // causal: query rows before this key tile see none of it
  const int qs = causal ? k0 : 0;

  copy_rows<kTile, D>(Ks, k + base, st, k0, Tn);
  copy_rows<kTile, D>(Vs, v + base, st, k0, Tn);
  copy_rows<BQ, D>(Qs, q + base, st, qs, Tn);
  copy_rows<BQ, D>(Gs, g + gbase, gld, qs, Tn);
  copy_vals<BQ>(Ls, lse_bh, qs, Tn);
  copy_vals<BQ>(Ds, del_bh, qs, Tn);
  cp_async_commit();

  unsigned kf[kRegs ? KD : 1][4], vf[kRegs ? KD : 1][4];
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float sl2 = scale * kLog2e;
  const bf16* Kw = Ks + warp * 16 * LDS + at.a;
  const bf16* Vw = Vs + warp * 16 * LDS + at.a;

  int it = 0;
  for (int q0 = qs; q0 < Tn; q0 += BQ, ++it) {
    if (q0 + BQ < Tn) {  // the next tile's copy overlaps this tile's math
      const int nxt = (it + 1) & 1;
      copy_rows<BQ, D>(Qs + nxt * kQElems, q + base, st, q0 + BQ, Tn);
      copy_rows<BQ, D>(Gs + nxt * kQElems, g + gbase, gld, q0 + BQ, Tn);
      copy_vals<BQ>(Ls + nxt * BQ, lse_bh, q0 + BQ, Tn);
      copy_vals<BQ>(Ds + nxt * BQ, del_bh, q0 + BQ, Tn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(kf[kk], Kw + kk * 16);
          ldsm_x4(vf[kk], Vw + kk * 16);
        }
      }
    }
    const bf16* Qt = Qs + (it & 1) * kQElems;
    const bf16* Gt = Gs + (it & 1) * kQElems;
    const float* Lt = Ls + (it & 1) * BQ;
    const float* Dt = Ds + (it & 1) * BQ;

    // S^T = K Q^T: 16 keys x BQ queries a warp
    float sT[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = kf[kk][e];
      } else {
        ldsm_x4(a, Kw + kk * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < NQ / 2; ++n2) {
        unsigned bq[4];
        ldsm_x4(bq, Qt + n2 * 16 * LDS + at.b_n + kk * 16);
        mma_bf16(sT[2 * n2], a, bq[0], bq[1]);
        mma_bf16(sT[2 * n2 + 1], a, bq[2], bq[3]);
      }
    }

    // P^T = exp(scale * S^T - lse[q]), 0 where masked
    const bool edge =
        q0 + BQ > Tn || k0 + kTile > Tn || (causal && q0 < k0 + kTile - 1);
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = n * 8 + 2 * t + (e & 1);
        float p = exp2f(fmaf(sT[n][e], sl2, -Lt[qi] * kLog2e));
        if (edge) {
          const int kpos = kr0 + gi + (e >> 1) * 8, qpos = q0 + qi;
          if (kpos >= Tn || qpos >= Tn || (causal && kpos > qpos)) p = 0.f;
        }
        sT[n][e] = p;
      }

    // dV += P^T g, P^T split (g by ldmatrix.trans: the contraction runs
    // over queries)
#pragma unroll
    for (int kq = 0; kq < NQ / 2; ++kq) {
      unsigned ph[4], pl[4];
      acc_to_a2(ph, pl, sT[2 * kq], sT[2 * kq + 1]);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        unsigned bg[4];
        ldsm_x4_t(bg, Gt + kq * 16 * LDS + at.b_t + dn * 16);
        mma_bf16x2(dva[2 * dn], ph, pl, bg[0], bg[1]);
        mma_bf16x2(dva[2 * dn + 1], ph, pl, bg[2], bg[3]);
      }
    }

    // dP^T = V g^T, then dS^T = P^T (dP^T - delta[q]) in its place
    float dsT[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dsT[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned a[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = vf[kk][e];
      } else {
        ldsm_x4(a, Vw + kk * 16);
      }
#pragma unroll
      for (int n2 = 0; n2 < NQ / 2; ++n2) {
        unsigned bg[4];
        ldsm_x4(bg, Gt + n2 * 16 * LDS + at.b_n + kk * 16);
        mma_bf16(dsT[2 * n2], a, bg[0], bg[1]);
        mma_bf16(dsT[2 * n2 + 1], a, bg[2], bg[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsT[n][e] = sT[n][e] * (dsT[n][e] - Dt[n * 8 + 2 * t + (e & 1)]);

    // dK += dS^T Q, dS^T split (q by ldmatrix.trans); `scale` once at the
    // end
#pragma unroll
    for (int kq = 0; kq < NQ / 2; ++kq) {
      unsigned dh[4], dl[4];
      acc_to_a2(dh, dl, dsT[2 * kq], dsT[2 * kq + 1]);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        unsigned bq[4];
        ldsm_x4_t(bq, Qt + kq * 16 * LDS + at.b_t + dn * 16);
        mma_bf16x2(dka[2 * dn], dh, dl, bq[0], bq[1]);
        mma_bf16x2(dka[2 * dn + 1], dh, dl, bq[2], bq[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  // dK and dV through this warp's own 16 rows of Ks and Vs (read only by
  // this warp)
  store_rows<D>(dk + gbase, gld, kr0, Tn, Ks + warp * 16 * LDS, dka, scale,
                scale, lane);
  store_rows<D>(dv + gbase, gld, kr0, Tn, Vs + warp * 16 * LDS, dva, 1.f,
                1.f, lane);
}

// ---- kernel 7 on the tensor cores: bf16 dQ --------------------------------
// q and g A-fragments are read from shared memory at every product, so that
// the dQ accumulator and the S and dP tiles keep the registers at every D.
// At D = 32 ptxas's own register target (96) spills; asking for 4 blocks an
// SM raises it to 128.
template <int D>
__global__ void __launch_bounds__(kTcThreads, D == 32 ? 4 : 0)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, long long sb, long long st,
                   long long sh, const bf16* __restrict__ g,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int Tn, int H, float scale, int causal) {
  constexpr int BK = kTile;
  constexpr int LDS = D + kTcPad, KD = D / 16, ND = D / 8, NS = BK / 8;
  constexpr int kKElems = BK * LDS;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* Qs = reinterpret_cast<bf16*>(tc_smem);
  bf16* Gs = Qs + kTile * LDS;
  bf16* Ks = Gs + kTile * LDS;  // two stages
  bf16* Vs = Ks + 2 * kKElems;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const Lanes at(lane, LDS);
  // the longest causal rows first: they finish last otherwise
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int r0 = q0 + warp * 16;  // this warp's first row
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long gld = static_cast<long long>(H) * D;
  const long long gbase = static_cast<long long>(b) * Tn * gld +
                          static_cast<long long>(h) * D;
  // causal: keys past this tile's last row see none of it
  const int nk = ((causal ? min(Tn, q0 + kTile) : Tn) + BK - 1) / BK;

  copy_rows<kTile, D>(Qs, q + base, st, q0, Tn);
  copy_rows<kTile, D>(Gs, g + gbase, gld, q0, Tn);
  copy_rows<BK, D>(Ks, k + base, st, 0, Tn);
  copy_rows<BK, D>(Vs, v + base, st, 0, Tn);
  cp_async_commit();

  // lse (in base-2 units) and delta of rows gi and gi+8
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gi + 8 * r;
    const long long i = static_cast<long long>(bh) * Tn + row;
    lse2[r] = row < Tn ? lse[i] * kLog2e : 0.f;
    del[r] = row < Tn ? delta[i] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl2 = scale * kLog2e;
  const bf16* Qw = Qs + warp * 16 * LDS + at.a;
  const bf16* Gw = Gs + warp * 16 * LDS + at.a;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nk) {  // the next tile's copy overlaps this tile's math
      const int nxt = ((kt + 1) & 1) * kKElems;
      copy_rows<BK, D>(Ks + nxt, k + base, st, k0 + BK, Tn);
      copy_rows<BK, D>(Vs + nxt, v + base, st, k0 + BK, Tn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + (kt & 1) * kKElems;
    const bf16* Vt = Vs + (kt & 1) * kKElems;

    // S = Q K^T and dP = g V^T: 16 rows x BK keys a warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned aq[4], ag[4];
      ldsm_x4(aq, Qw + kk * 16);
      ldsm_x4(ag, Gw + kk * 16);
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        unsigned bk[4], bv[4];
        ldsm_x4(bk, Kt + n2 * 16 * LDS + at.b_n + kk * 16);
        ldsm_x4(bv, Vt + n2 * 16 * LDS + at.b_n + kk * 16);
        mma_bf16(s[2 * n2], aq, bk[0], bk[1]);
        mma_bf16(s[2 * n2 + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[2 * n2], ag, bv[0], bv[1]);
        mma_bf16(dp[2 * n2 + 1], ag, bv[2], bv[3]);
      }
    }

    // P = exp(scale * S - lse), 0 where masked; dS = P (dP - delta) in
    // dP's place
    const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > r0);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(fmaf(s[n][e], sl2, -lse2[e >> 1]));
        if (edge) {
          const int kpos = k0 + n * 8 + 2 * t + (e & 1);
          const int qpos = r0 + gi + (e >> 1) * 8;
          if (kpos >= Tn || (causal && kpos > qpos)) p = 0.f;
        }
        dp[n][e] = p * (dp[n][e] - del[e >> 1]);
      }

    // dQ += dS K, dS split (k by ldmatrix.trans: the sum runs over keys);
    // `scale` once at the store
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      unsigned dh[4], dl[4];
      acc_to_a2(dh, dl, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int dn = 0; dn < KD; ++dn) {
        unsigned bk[4];
        ldsm_x4_t(bk, Kt + kk * 16 * LDS + at.b_t + dn * 16);
        mma_bf16x2(acc[2 * dn], dh, dl, bk[0], bk[1]);
        mma_bf16x2(acc[2 * dn + 1], dh, dl, bk[2], bk[3]);
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  // dq through this warp's own 16 rows of Qs (read only by this warp)
  store_rows<D>(dq + gbase, gld, r0, Tn, Qs + warp * 16 * LDS, acc, scale,
                scale, lane);
}

// ---- f32 on the tensor cores: 3xTF32 building blocks ---------------------
// x as a split TF32 pair for the tensor cores, which read only the top 19
// bits of a .tf32 operand:
//  - big = tf32(x), rounded to nearest with ties away from zero as
//    cvt.rna.tf32.f32 rounds: the f32 pattern plus half a TF32 ulp
//    (0x1000); masking its low 13 bits gives its value;
//  - small = x - big, exact in f32 (at most 13 significant bits), passed
//    whole: the tensor cores truncate it to TF32, an error of at most
//    2^-10 of small, 2^-21 of x.
// Three instructions an element.  A NaN stays NaN: the carry into a NaN's
// all-ones exponent may turn big into +-0 (the card's NaN, 0x7fffffff,
// reads as -0), but small = x - big is then NaN and is not rounded, and
// every product takes big*small and small*big (mma_3xtf32), so the NaN
// reaches each sum it is in.  An infinity gives a NaN small, as
// cvt.rna.tf32.f32 would.
__device__ __forceinline__ void split_tf32(unsigned& big, unsigned& small,
                                           float x) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u));
}

// d += a (16x8, row) * b (8x8, col): tf32 in, f32 accumulate.  Lane l
// (g = l / 4, t = l % 4) holds a[0..3] at (g, t), (g+8, t), (g, t+4),
// (g+8, t+4), b0 at (k = t, n = g) and b1 at (t+4, g); d as in mma_bf16.
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the A and B operands of one k8 step, each element split
struct FragA {
  unsigned big[4], small[4];
};
struct FragB {
  unsigned big[2], small[2];
};

// d += a b at about f32 accuracy: big*big + big*small + small*big, the
// small terms first; small*small (~2^-22 relative) is dropped
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a,
                                           const FragB& b) {
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// p[0] * mul from shared memory, split
__device__ __forceinline__ void lds_split(unsigned& big, unsigned& small,
                                          const float* p, float mul) {
  split_tf32(big, small, *p * mul);
}

// Per-lane offsets inside a row-major shared f32 tile (ld floats between
// rows):
//  - d: the direct read, row g and column t: A from a tile stored [m][k]
//    (rows g and g+8, columns t and t+4) and B from one stored [n][k] (row
//    g, columns t and t+4);
//  - tr: B from a tile stored [k][n], column g, with the contraction index
//    permuted inside each k8 step as acc_to_a orders an accumulator's
//    columns: k = t at row 2t, k = t+4 at row 2t+1.
// With ld = D + 4 both reads hit 32 distinct banks at every D.
struct LanesF32 {
  int d, tr;
  __device__ __forceinline__ LanesF32(int lane, int ld)
      : d((lane >> 2) * ld + (lane & 3)),
        tr(2 * (lane & 3) * ld + (lane >> 2)) {}
};

// A of one k8 step, p at (row 0, column k0) of the tile plus LanesF32::d
template <int LD>
__device__ __forceinline__ void lds_a(FragA& f, const float* p, float mul) {
  lds_split(f.big[0], f.small[0], p, mul);
  lds_split(f.big[1], f.small[1], p + 8 * LD, mul);
  lds_split(f.big[2], f.small[2], p + 4, mul);
  lds_split(f.big[3], f.small[3], p + 8 * LD + 4, mul);
}
// B from a tile stored [n][k], p at (n0, k0) plus LanesF32::d
__device__ __forceinline__ void lds_b(FragB& f, const float* p, float mul) {
  lds_split(f.big[0], f.small[0], p, mul);
  lds_split(f.big[1], f.small[1], p + 4, mul);
}
// B from a tile stored [k][n], p at (k0, n0) plus LanesF32::tr
template <int LD>
__device__ __forceinline__ void lds_bt(FragB& f, const float* p, float mul) {
  lds_split(f.big[0], f.small[0], p, mul);
  lds_split(f.big[1], f.small[1], p + LD, mul);
}

// The A operand of one k8 step, split in registers, from the f32
// accumulator c of one 8-column n-tile (columns 2t and 2t+1 of rows g and
// g+8): column 2t becomes k = t and 2t+1 becomes k = t+4, so the B operand
// must be read in that order (lds_bt).
__device__ __forceinline__ void acc_to_a(FragA& f, const float (&c)[4]) {
  split_tf32(f.big[0], f.small[0], c[0]);
  split_tf32(f.big[1], f.small[1], c[2]);
  split_tf32(f.big[2], f.small[2], c[1]);
  split_tf32(f.big[3], f.small[3], c[3]);
}

// Tiling of the f32 kernels: a block owns 64 rows, 16 a warp, and the
// other side streams in tiles of kOther rows.  Splitting, not the tensor
// cores, bounds these kernels, and its chains of dependent instructions
// need warps to hide their latency: kBlocks (0: ptxas's own target) asks
// ptxas for registers that let that many blocks share an SM.  At D <= 64
// three blocks; dK/dV there takes 16-query tiles, with which its two
// accumulators (dK, dV) and the S^T and dS^T tiles fit under that cap.  At
// D = 128 the accumulators need more registers: 16-row tiles and no cap.
// The forward holds one accumulator (O) and one score tile, as dQ does,
// under the same caps; at D <= 64 it takes 64-key tiles (87 KB of shared
// memory at D = 64, so two blocks an SM), which ran 4% faster than
// 32-key tiles on an H100 (chip_flash_sweep.py): half the loop trips and
// barriers outweigh the masked half-tiles on the diagonal.
template <int D> struct FwdTf32 {
  static constexpr int kOther = D <= 64 ? 64 : 16, kBlocks = D <= 64 ? 3 : 0;
};
template <int D> struct DqTf32 {
  static constexpr int kOther = D <= 64 ? 32 : 16, kBlocks = D <= 64 ? 3 : 0;
};
template <int D> struct DkvTf32 {
  static constexpr int kOther = 16, kBlocks = D <= 64 ? 3 : 0;
};

// ---- kernel 6, f32 on the tensor cores: 3xTF32 forward --------------------
template <int D>
__global__ void __launch_bounds__(kTcThreads, FwdTf32<D>::kBlocks)
flash_fwd_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, long long sb, long long st,
                      long long sh, float* __restrict__ out,
                      float* __restrict__ lse, int Tn, int H, float scale,
                      int causal) {
  constexpr int BK = FwdTf32<D>::kOther;
  constexpr int LD = D + kF32Pad, KD = D / 8, ND = D / 8, NS = BK / 8;
  constexpr int kKvElems = BK * LD;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Qs = reinterpret_cast<float*>(tc_smem);
  float* Ks = Qs + kTile * LD;    // two stages
  float* Vs = Ks + 2 * kKvElems;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const LanesF32 at(lane, LD);
  // the longest causal rows first: they finish last otherwise
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int r0 = q0 + warp * 16;  // this warp's first row
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  // causal: keys past this tile's last row see none of it
  const int nk = ((causal ? min(Tn, q0 + kTile) : Tn) + BK - 1) / BK;

  copy_rows<kTile, D>(Qs, q + base, st, q0, Tn);
  copy_rows<BK, D>(Ks, k + base, st, 0, Tn);
  copy_rows<BK, D>(Vs, v + base, st, 0, Tn);
  cp_async_commit();

  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // running max (base-2 units) of rows gi and gi+8, and this lane's part
  // of their running sums (the quad's parts are added at the end)
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const float* Qw = Qs + warp * 16 * LD + at.d;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nk) {  // the next tile's copy overlaps this tile's math
      const int nxt = ((kt + 1) & 1) * kKvElems;
      copy_rows<BK, D>(Ks + nxt, k + base, st, k0 + BK, Tn);
      copy_rows<BK, D>(Vs + nxt, v + base, st, k0 + BK, Tn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (kt & 1) * kKvElems;
    const float* Vt = Vs + (kt & 1) * kKvElems;

    // causal: keys past this warp's last row are all masked
    if (!causal || k0 < r0 + 16) {
      // S = (scale q) K^T: 16 rows x BK keys a warp
      float s[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        FragA aq;
        lds_a<LD>(aq, Qw + kk * 8, scale);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          FragB bk;
          lds_b(bk, Kt + n * 8 * LD + at.d + kk * 8, 1.f);
          mma_3xtf32(s[n], aq, bk);
        }
      }

      // into base-2 units, mask, online softmax
      const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > r0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * kLog2e;
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = r0 + gi + (e >> 1) * 8;
            if (kpos >= Tn || (causal && kpos > qpos)) x = kNeg;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - m[e >> 1]);
          s[n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V, P split from its accumulator (v read across rows: the
      // sum runs over keys)
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        FragA ap;
        acc_to_a(ap, s[kk]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          FragB bv;
          lds_bt<LD>(bv, Vt + kk * 8 * LD + n * 8 + at.tr, 1.f);
          mma_3xtf32(o[n], ap, bv);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  float lm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    lm[r] = max_sum(l[r]);
  }
  // out through this warp's own 16 rows of Qs (read only by this warp)
  store_rows<D>(out + (static_cast<long long>(b) * Tn * H + h) * D,
                static_cast<long long>(H) * D, r0, Tn, Qs + warp * 16 * LD,
                o, 1.f / lm[0], 1.f / lm[1], lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + gi + 8 * r;
      if (row < Tn)
        lse[static_cast<long long>(bh) * Tn + row] =
            m[r] * kLn2 + logf(lm[r]);
    }
  }
}

// ---- kernel 7, f32 on the tensor cores: 3xTF32 dQ -------------------------
template <int D>
__global__ void __launch_bounds__(kTcThreads, DqTf32<D>::kBlocks)
flash_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, long long sb, long long st,
                     long long sh, const float* __restrict__ g,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq,
                     int Tn, int H, float scale, int causal) {
  constexpr int BK = DqTf32<D>::kOther;
  constexpr int LD = D + kF32Pad, KD = D / 8, ND = D / 8, NS = BK / 8;
  constexpr int kKElems = BK * LD;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Qs = reinterpret_cast<float*>(tc_smem);
  float* Gs = Qs + kTile * LD;
  float* Ks = Gs + kTile * LD;  // two stages
  float* Vs = Ks + 2 * kKElems;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const LanesF32 at(lane, LD);
  // the longest causal rows first: they finish last otherwise
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int r0 = q0 + warp * 16;  // this warp's first row
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long gld = static_cast<long long>(H) * D;
  const long long gbase = static_cast<long long>(b) * Tn * gld +
                          static_cast<long long>(h) * D;
  // causal: keys past this tile's last row see none of it
  const int nk = ((causal ? min(Tn, q0 + kTile) : Tn) + BK - 1) / BK;

  copy_rows<kTile, D>(Qs, q + base, st, q0, Tn);
  copy_rows<kTile, D>(Gs, g + gbase, gld, q0, Tn);
  copy_rows<BK, D>(Ks, k + base, st, 0, Tn);
  copy_rows<BK, D>(Vs, v + base, st, 0, Tn);
  cp_async_commit();

  // lse (in base-2 units) and delta of rows gi and gi+8
  float lse2[2], del[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + gi + 8 * r;
    const long long i = static_cast<long long>(bh) * Tn + row;
    lse2[r] = row < Tn ? lse[i] * kLog2e : 0.f;
    del[r] = row < Tn ? delta[i] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float* Qw = Qs + warp * 16 * LD + at.d;
  const float* Gw = Gs + warp * 16 * LD + at.d;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    if (kt + 1 < nk) {  // the next tile's copy overlaps this tile's math
      const int nxt = ((kt + 1) & 1) * kKElems;
      copy_rows<BK, D>(Ks + nxt, k + base, st, k0 + BK, Tn);
      copy_rows<BK, D>(Vs + nxt, v + base, st, k0 + BK, Tn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + (kt & 1) * kKElems;
    const float* Vt = Vs + (kt & 1) * kKElems;

    // causal: keys past this warp's last row are all masked
    if (!causal || k0 < r0 + 16) {
      // S = (scale q) K^T and dP = g V^T: 16 rows x BK keys a warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        FragA aq, ag;
        lds_a<LD>(aq, Qw + kk * 8, scale);
        lds_a<LD>(ag, Gw + kk * 8, 1.f);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          FragB bk, bv;
          lds_b(bk, Kt + n * 8 * LD + at.d + kk * 8, 1.f);
          lds_b(bv, Vt + n * 8 * LD + at.d + kk * 8, 1.f);
          mma_3xtf32(s[n], aq, bk);
          mma_3xtf32(dp[n], ag, bv);
        }
      }

      // P = exp(S - lse), 0 where masked; dS = P (dP - delta) in dP's
      // place
      const bool edge = k0 + BK > Tn || (causal && k0 + BK - 1 > r0);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(fmaf(s[n][e], kLog2e, -lse2[e >> 1]));
          if (edge) {
            const int kpos = k0 + n * 8 + 2 * t + (e & 1);
            const int qpos = r0 + gi + (e >> 1) * 8;
            if (kpos >= Tn || (causal && kpos > qpos)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - del[e >> 1]);
        }

      // dQ += dS K (k read across rows: the sum runs over keys); `scale`
      // once at the store
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        FragA ad;
        acc_to_a(ad, dp[kk]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          FragB bk;
          lds_bt<LD>(bk, Kt + kk * 8 * LD + n * 8 + at.tr, 1.f);
          mma_3xtf32(acc[n], ad, bk);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  // dq through this warp's own 16 rows of Qs (read only by this warp)
  store_rows<D>(dq + gbase, gld, r0, Tn, Qs + warp * 16 * LD, acc, scale,
                scale, lane);
}

// ---- kernel 8, f32 on the tensor cores: 3xTF32 dK and dV ------------------
template <int D>
__global__ void __launch_bounds__(kTcThreads, DkvTf32<D>::kBlocks)
flash_dkv_tf32_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, long long sb, long long st,
                      long long sh, const float* __restrict__ g,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Tn,
                      int H, float scale, int causal) {
  constexpr int BQ = DkvTf32<D>::kOther;
  constexpr int LD = D + kF32Pad, KD = D / 8, ND = D / 8, NQ = BQ / 8;
  constexpr int kQElems = BQ * LD;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* Ks = reinterpret_cast<float*>(tc_smem);
  float* Vs = Ks + kTile * LD;
  float* Qs = Vs + kTile * LD;   // two stages
  float* Gs = Qs + 2 * kQElems;  // two stages
  float* Ls = Gs + 2 * kQElems;  // two stages
  float* Ds = Ls + 2 * BQ;       // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gi = lane >> 2, t = lane & 3;
  const LanesF32 at(lane, LD);
  // causal: the first k tiles see the most query tiles, and launch first
  const int k0 = blockIdx.x * kTile;
  const int kr0 = k0 + warp * 16;  // this warp's first key
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const long long base = b * sb + h * sh;
  const long long gld = static_cast<long long>(H) * D;
  const long long gbase = static_cast<long long>(b) * Tn * gld +
                          static_cast<long long>(h) * D;
  const float* lse_bh = lse + static_cast<long long>(bh) * Tn;
  const float* del_bh = delta + static_cast<long long>(bh) * Tn;
  // causal: query rows before this key tile see none of it
  const int qs = causal ? k0 : 0;

  copy_rows<kTile, D>(Ks, k + base, st, k0, Tn);
  copy_rows<kTile, D>(Vs, v + base, st, k0, Tn);
  copy_rows<BQ, D>(Qs, q + base, st, qs, Tn);
  copy_rows<BQ, D>(Gs, g + gbase, gld, qs, Tn);
  copy_vals<BQ>(Ls, lse_bh, qs, Tn);
  copy_vals<BQ>(Ds, del_bh, qs, Tn);
  cp_async_commit();

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float* Kw = Ks + warp * 16 * LD + at.d;
  const float* Vw = Vs + warp * 16 * LD + at.d;

  int it = 0;
  for (int q0 = qs; q0 < Tn; q0 += BQ, ++it) {
    if (q0 + BQ < Tn) {  // the next tile's copy overlaps this tile's math
      const int nxt = (it + 1) & 1;
      copy_rows<BQ, D>(Qs + nxt * kQElems, q + base, st, q0 + BQ, Tn);
      copy_rows<BQ, D>(Gs + nxt * kQElems, g + gbase, gld, q0 + BQ, Tn);
      copy_vals<BQ>(Ls + nxt * BQ, lse_bh, q0 + BQ, Tn);
      copy_vals<BQ>(Ds + nxt * BQ, del_bh, q0 + BQ, Tn);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qt = Qs + (it & 1) * kQElems;
    const float* Gt = Gs + (it & 1) * kQElems;
    const float* Lt = Ls + (it & 1) * BQ;
    const float* Dt = Ds + (it & 1) * BQ;

    // causal: queries before this warp's first key are all masked
    if (!causal || q0 + BQ > kr0) {
      // S^T = K (scale q)^T: 16 keys x BQ queries a warp
      float sT[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        FragA ak;
        lds_a<LD>(ak, Kw + kk * 8, 1.f);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          FragB bq;
          lds_b(bq, Qt + n * 8 * LD + at.d + kk * 8, scale);
          mma_3xtf32(sT[n], ak, bq);
        }
      }

      // P^T = exp(S^T - lse[q]), 0 where masked
      const bool edge = q0 + BQ > Tn || kr0 + 16 > Tn ||
                        (causal && q0 < kr0 + 15);
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = n * 8 + 2 * t + (e & 1);
          float p = exp2f(fmaf(sT[n][e], kLog2e, -Lt[qi] * kLog2e));
          if (edge) {
            const int kpos = kr0 + gi + (e >> 1) * 8, qpos = q0 + qi;
            if (kpos >= Tn || qpos >= Tn || (causal && kpos > qpos)) p = 0.f;
          }
          sT[n][e] = p;
        }

      // dV += P^T g (g read across rows: the sum runs over queries)
#pragma unroll
      for (int kq = 0; kq < NQ; ++kq) {
        FragA ap;
        acc_to_a(ap, sT[kq]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          FragB bg;
          lds_bt<LD>(bg, Gt + kq * 8 * LD + n * 8 + at.tr, 1.f);
          mma_3xtf32(dva[n], ap, bg);
        }
      }

      // dP^T = V g^T, then dS^T = P^T (dP^T - delta[q]) in its place
      float dsT[NQ][4];
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsT[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        FragA av;
        lds_a<LD>(av, Vw + kk * 8, 1.f);
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          FragB bg;
          lds_b(bg, Gt + n * 8 * LD + at.d + kk * 8, 1.f);
          mma_3xtf32(dsT[n], av, bg);
        }
      }
#pragma unroll
      for (int n = 0; n < NQ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dsT[n][e] = sT[n][e] * (dsT[n][e] - Dt[n * 8 + 2 * t + (e & 1)]);

      // dK += dS^T (scale q) (q read across rows)
#pragma unroll
      for (int kq = 0; kq < NQ; ++kq) {
        FragA ad;
        acc_to_a(ad, dsT[kq]);
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          FragB bq;
          lds_bt<LD>(bq, Qt + kq * 8 * LD + n * 8 + at.tr, scale);
          mma_3xtf32(dka[n], ad, bq);
        }
      }
    }
    __syncthreads();  // this stage's readers are done before it refills
  }

  // dK and dV through this warp's own 16 rows of Ks and Vs (read only by
  // this warp)
  store_rows<D>(dk + gbase, gld, kr0, Tn, Ks + warp * 16 * LD, dka, 1.f, 1.f,
                lane);
  store_rows<D>(dv + gbase, gld, kr0, Tn, Vs + warp * 16 * LD, dva, 1.f, 1.f,
                lane);
}

// dynamic shared memory in bytes of each kernel
template <int D> constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * 5 * kTile * (D + kTcPad);
}
template <int D> constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * 6 * kTile * (D + kTcPad);
}
template <int D> constexpr size_t dkv_tc_smem() {
  constexpr int BQ = DkvTc<D>::kRows;
  return sizeof(bf16) * (2 * kTile + 4 * BQ) * (D + kTcPad) +
         sizeof(float) * 4 * BQ;
}
template <int D> constexpr size_t fwd_tf32_smem() {
  return sizeof(float) * (kTile + 4 * FwdTf32<D>::kOther) * (D + kF32Pad);
}
template <int D> constexpr size_t dq_tf32_smem() {
  return sizeof(float) * (2 * kTile + 4 * DqTf32<D>::kOther) * (D + kF32Pad);
}
template <int D> constexpr size_t dkv_tf32_smem() {
  constexpr int BQ = DkvTf32<D>::kOther;
  return sizeof(float) * ((2 * kTile + 4 * BQ) * (D + kF32Pad) + 4 * BQ);
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

// bf16 takes the tensor-core kernels, f32 the 3xTF32 ones
template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, long long sb,
        long long st, long long sh, void* out, void* lse, const Shape& s) {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  static bool done = false;
  auto kernel = [] {
    if constexpr (kBf16)
      return flash_fwd_tc_kernel<D>;
    else
      return flash_fwd_tf32_kernel<D>;
  }();
  constexpr size_t smem = kBf16 ? fwd_tc_smem<D>() : fwd_tf32_smem<D>();
  cudaError_t err = opt_in(kernel, smem, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s.grid(), kTcThreads, smem, s.stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), sb, st, sh, static_cast<T*>(out),
      static_cast<float*>(lse), s.Tn, s.H, s.scale, s.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, long long sb,
       long long st, long long sh, const void* g, const void* lse,
       const void* delta, void* dq_out, const Shape& s) {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  static bool done = false;
  auto kernel = [] {
    if constexpr (kBf16)
      return flash_dq_tc_kernel<D>;
    else
      return flash_dq_tf32_kernel<D>;
  }();
  constexpr size_t smem = kBf16 ? dq_tc_smem<D>() : dq_tf32_smem<D>();
  cudaError_t err = opt_in(kernel, smem, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s.grid(), kTcThreads, smem, s.stream>>>(
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
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  static bool done = false;
  auto kernel = [] {
    if constexpr (kBf16)
      return flash_dkv_tc_kernel<D>;
    else
      return flash_dkv_tf32_kernel<D>;
  }();
  constexpr size_t smem = kBf16 ? dkv_tc_smem<D>() : dkv_tf32_smem<D>();
  cudaError_t err = opt_in(kernel, smem, &done);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<s.grid(), kTcThreads, smem, s.stream>>>(
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
