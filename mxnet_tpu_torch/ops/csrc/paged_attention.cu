// Paged attention over one layer's KV pool, for sm_90a.
//
// Replaces: mxnet_tpu/ops/paged_attention.py `_paged_kernel` (float pool)
// and `_paged_kernel_q` (int8 pool, per-(block, head) f32 scales), both
// behind `paged_attention`: the attention of the generation engine's every
// model step, decode (T = 1 query per slot) and chunked prefill (T = a seq
// bucket at B = 1), against K/V that live in fixed-size blocks named by a
// per-row block table.
//
// Two designs sit behind each entry, chosen by T:
//
//   route            kernels                                 grid
//   decode (T <= 4)  paged_decode_split_kernel, then         (splits, H, B)
//                    paged_decode_merge_kernel               (H, B)
//   prefill (T > 4)  paged_prefill_tile_kernel               (T/64, H, B)
//
// What bounds them on an H100.  Decode is bound by bytes: the live K/V
// blocks of each row, read once (one byte an element plus two f32 scales
// per block and head for the int8 pool), over 3.35 TB/s; at 2*T flops a
// K/V element it is far below the card's ridge.  The serving step's decode
// call (B = 8, contexts up to 1,000 positions, H = 12, D = 64) reads 17.4
// MB from an f32 pool and 4.4 MB from an int8 one: 5.2 and 1.3 us, so
// launch latency and memory round trips set the floor.  Prefill at T = 512 does 2*D flops a (query, key)
// pair twice over and is bound by the f32 CUDA-core rate (67 TFLOP/s).
//
// Decode: flash-decoding.  The TPU kernel walks a row's blocks on a
// sequential grid axis with the online-softmax state in VMEM; here the
// context is cut into spans of 128 positions (max(1, 128 / bs) whole pool
// blocks, so block sizes 16 and 32 both give hundreds of thread blocks at
// the serving shape), one thread block of 128 threads per (span, h, b):
//   - the block reads its span's table entries in parallel and compacts
//     the live ones (entry != 0, start <= max_pos[b] and <= the last query
//     position); a span with none past the row's last live block exits at
//     once, so table entry 0, blocks past max_pos and their scales are
//     never read, NaN scales in block 0 included;
//   - every live row of the span (rows past the last query position are
//     not needed) is copied at once by cp.async, 16 bytes a copy where the
//     (key, head) row of D elements allows it and 8, 4, 2 or 1 bytes where
//     it does not, and only then waited on; tiles stay in the pool's dtype
//     in shared memory, so an int8 tile takes a quarter of an f32 one;
//   - a thread scores one key, reading its row in 16-byte chunks against
//     q (pre-scaled in f32, broadcast from shared memory); K rows are
//     padded to an odd number of chunks, so the eight threads of a
//     shared-memory phase hit eight bank groups.  The value sum gives L
//     lanes to a key (L = D/4 rounded up to a power of two), 4 elements a
//     lane, contiguous and free of bank conflicts.  The int8 pool's scales
//     are folded into the math: s = ks * (q . k_int8) and acc += (p * vs)
//     * v_int8, one multiply a key instead of one an element, which
//     differs from the reference's `k.astype(f32) * ks` only in f32
//     rounding order;
//   - the span's (m, l, acc[D]) is f32; the block writes it to a workspace
//     (the wrapper's `torch.empty`), or its output directly when the row
//     has one span.  The merge kernel combines a row's spans in span order
//     (M = max m, L = sum l e^(m - M), out = sum acc e^(m - M) / L), with
//     no atomics, so the output repeats bit for bit.  A span that saw no
//     live block contributes m = -1e30, l = 0.
// Prefill: one block of 256 threads per (64-query tile, h, b), a CUDA-core
// register tiling: thread (ty, tx) holds queries ty + 16i against keys
// tx + 16j (i, j < 4)
// of each 64 x 64 score tile, row max and sum are 16-lane shuffles, all
// arithmetic is f32 `fmaf`.  K/V stream as 64-key tiles assembled from
// ceil(64 / bs) pool blocks, looked up in the row's table row by row,
// through a 2-stage cp.async ring in the pool's dtype (the next tile's
// copies in flight while this one computes); null and dead blocks' rows,
// and rows past the tile's last query position, are zero-filled, never
// read, and masked out; tiles past them are skipped.  K is widened once
// per tile into a padded f32 tile for the score loop; V is read in its own
// dtype.  int8: each key column carries its own block's scales.  bf16 q on
// a bf16 pool takes the same f32 CUDA-core design.
//
// Both: a query attends to cache positions <= its own with the TPU
// kernel's -1e30 fill; q is multiplied by the caller's f32 1/sqrt(D)
// before the dot product, as the TPU kernel does; scores and sums are f32
// (no TF32); a row with no live block (max_pos = -1) writes 0.  Tensor
// cores for bf16 prefill and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr float kNeg = -1e30f;  // the reference's _NEG
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kSpan = 128;      // decode: positions (K/V rows) a block holds
constexpr int kPreThreads = 256;
constexpr int kTile = 64;       // prefill: queries and keys a tile
constexpr int kPad = kTile + 1;
constexpr size_t kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
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
// max / sum over the 16 lanes that hold one prefill score row
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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cw bytes (16, 8, 4: cp.async, in flight until waited on; 2, 1: plain)
// from device to shared memory; both addresses are cw-aligned
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const unsigned char* src,
                                           int cw) {
  if (cw == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else if (cw == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else if (cw == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else if (cw == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  } else {
    *dst = *src;
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 consecutive elements from shared memory as f32 (16, 8 or 4 bytes)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16);
  v[1] = __uint_as_float(x.x & 0xffff0000u);
  v[2] = __uint_as_float(x.y << 16);
  v[3] = __uint_as_float(x.y & 0xffff0000u);
}
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[4]) {
  const unsigned x = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = static_cast<float>(static_cast<int8_t>((x >> (8 * e)) & 0xffu));
}

// one 16-byte chunk from shared memory as 16 / sizeof(element) f32 values
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  load4(p, v);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load16(const int8_t* p, float (&v)[16]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[4 * i + e] =
          static_cast<float>(static_cast<int8_t>((w[i] >> (8 * e)) & 0xffu));
}

// bytes of one (key, head) row of D elements in shared memory: rounded up
// to 16 so that every row starts on 16 bytes
__host__ __device__ __forceinline__ int row_pitch(int D, int item) {
  return (D * item + 15) / 16 * 16;
}
// the decode route's K rows: an odd number of 16-byte chunks, so that
// eight threads reading one chunk each of eight consecutive rows hit
// eight different bank groups
__host__ __device__ __forceinline__ int key_pitch(int D, int item) {
  return 16 * (((D * item + 15) / 16) | 1);
}

// ---- decode: one span of a row's context per block --------------------
// Workspace: per (b, h, span, t) an f32 record [m, l, acc[0..D)].
template <typename T, typename KV, int NQ>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_split_kernel(const T* __restrict__ q,
                          const KV* __restrict__ k_pool,
                          const KV* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ positions,
                          const int* __restrict__ max_pos,
                          T* __restrict__ out, float* __restrict__ ws,
                          int T_len, int H, int D, int bs, int W, int bps,
                          int n_splits, float scale, int cw) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kItem = sizeof(KV);
  constexpr int kEPC = 16 / kItem;  // elements a 16-byte chunk
  extern __shared__ __align__(16) unsigned char smem[];
  const int rb = D * kItem, nch = (rb + 15) / 16, qp = nch * kEPC;
  const int rpk = key_pitch(D, kItem), rpv = row_pitch(D, kItem);
  unsigned char* k_s = smem;                        // [kSpan][rpk] bytes
  unsigned char* v_s = k_s + kSpan * rpk;           // [kSpan][rpv]
  long long* r_src = reinterpret_cast<long long*>(v_s + kSpan * rpv);
  float* q_s = reinterpret_cast<float*>(r_src + kSpan);  // [NQ][qp]
  float* s_s = q_s + NQ * qp;                       // [NQ][kSpan]
  float* red = s_s + NQ * kSpan;                    // [warps][NQ][D]
  float* slot_ks = red + kDecWarps * NQ * D;        // [kSpan] per block
  float* slot_vs = slot_ks + kSpan;                 // [kSpan]
  int* r_pos = reinterpret_cast<int*>(slot_vs + kSpan);  // [kSpan] per row
  int* r_slot = r_pos + kSpan;                      // [kSpan]
  int* slot_blk = r_slot + kSpan;                   // [kSpan]
  int* slot_w = slot_blk + kSpan;                   // [kSpan]
  int* warp_cnt = slot_w + kSpan;                   // [warps]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // q (pre-scaled, 0 past D), the span's table entries, max_pos and the
  // positions are read together
  for (int i = tid; i < NQ * qp; i += kDecThreads) {
    const int t = i / qp, d = i - t * qp;
    q_s[i] = t < T_len && d < D
                 ? to_f32(q[((static_cast<size_t>(b) * T_len + t) * H + h) *
                                D + d]) * scale
                 : 0.f;
  }
  const int w = split * bps + tid;
  int blk = tid < bps && w < W ? tables[b * W + w] : 0;
  const int mp = max_pos[b];
  int qpos[NQ];
  int last = -1;
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    qpos[t] = t < T_len ? positions[b * T_len + t] : -1;
    last = max(last, qpos[t]);
  }
  // a live block starts at or before blim; spans past its block are dead
  const int blim = min(mp, last);
  const int live_splits = blim < 0 ? 0 : (blim / bs) / bps + 1;
  if (live_splits == 0) {  // nothing to attend: span 0 writes the zeros
    if (split == 0)
      for (int i = tid; i < T_len * D; i += kDecThreads) {
        const int t = i / D, d = i - t * D;
        out[((static_cast<size_t>(b) * T_len + t) * H + h) * D + d] =
            from_f32<T>(0.f);
      }
    return;
  }
  if (split >= live_splits) return;

  // compact the span's live blocks (in table order) into slots; an int8
  // block's two scales are copied beside its rows
  if (w > blim / bs) blk = 0;
  const bool live = blk != 0;
  const unsigned bal = __ballot_sync(0xffffffffu, live);
  if (lane == 0) warp_cnt[warp] = __popc(bal);
  __syncthreads();
  int before = 0, nlive = 0;
#pragma unroll
  for (int i = 0; i < kDecWarps; ++i) {
    before += i < warp ? warp_cnt[i] : 0;
    nlive += warp_cnt[i];
  }
  if (live) {
    const int slot = before + __popc(bal & ((1u << lane) - 1u));
    slot_blk[slot] = blk;
    slot_w[slot] = w;
    if constexpr (kQuant) {
      const size_t at = static_cast<size_t>(blk) * H + h;
      copy_chunk(reinterpret_cast<unsigned char*>(slot_ks + slot),
                 reinterpret_cast<const unsigned char*>(k_scale + at), 4);
      copy_chunk(reinterpret_cast<unsigned char*>(slot_vs + slot),
                 reinterpret_cast<const unsigned char*>(v_scale + at), 4);
    }
  }
  if (rb & 15)  // K rows are read in whole chunks: zero their tails
    for (int i = tid; i < kSpan * (nch * 16 - rb); i += kDecThreads) {
      const int r = i / (nch * 16 - rb);
      k_s[r * rpk + rb + i - r * (nch * 16 - rb)] = 0;
    }
  __syncthreads();
  // rows of the live blocks up to the last query position: only the last
  // live block can end early
  const int nrows =
      nlive == 0 ? 0
                 : (nlive - 1) * bs +
                       min(bs, last - slot_w[nlive - 1] * bs + 1);

  // the value sum: L lanes a key, 4 elements a lane, G key groups
  int L = 1;
  while (4 * L < D) L <<= 1;
  const int li = tid & (L - 1), g = tid / L, G = kDecThreads / L;
  const int nvalid = min(4, max(0, D - 4 * li));
  float acc[NQ][4], m[NQ], l[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    m[t] = kNeg;
    l[t] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  }

  // copies: thread tid walks (row, chunk) pairs tid, tid + 128, ...
  const int cpr = rb / cw, dr = kDecThreads / cpr, dc = kDecThreads % cpr;
  const int r_first = tid / cpr, c_first = tid - r_first * cpr;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k_pool);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v_pool);
  for (int r0 = 0; r0 < nrows; r0 += kSpan) {  // one pass unless bs > 128
    const int rows = min(kSpan, nrows - r0);
    if (r0 > 0) __syncthreads();  // the last chunk's readers are done
    if (tid < rows) {
      const int gr = r0 + tid, slot = gr / bs, j = gr - slot * bs;
      r_pos[tid] = slot_w[slot] * bs + j;
      r_slot[tid] = slot;
      r_src[tid] =
          ((static_cast<long long>(slot_blk[slot]) * bs + j) * H + h) * rb;
    }
    __syncthreads();
    for (int r = r_first, c = c_first; r < rows;) {
      const long long src = r_src[r] + c * cw;
      copy_chunk(k_s + r * rpk + c * cw, kb + src, cw);
      copy_chunk(v_s + r * rpv + c * cw, vb + src, cw);
      c += dc;
      r += dr;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // scores, a thread a row (q broadcast from shared memory), into s_s
    // (masked: -1e30)
    for (int k = tid; k < rows; k += kDecThreads) {
      const KV* kr = reinterpret_cast<const KV*>(k_s + k * rpk);
      float dot[NQ][2];
#pragma unroll
      for (int t = 0; t < NQ; ++t) dot[t][0] = dot[t][1] = 0.f;
#pragma unroll 2
      for (int c = 0; c < nch; ++c) {
        float kv[kEPC];
        load16(kr + c * kEPC, kv);
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          const float4* qc =
              reinterpret_cast<const float4*>(q_s + t * qp + c * kEPC);
#pragma unroll
          for (int e = 0; e < kEPC / 4; ++e) {
            const float4 qq = qc[e];
            dot[t][0] = fmaf(qq.x, kv[4 * e], dot[t][0]);
            dot[t][1] = fmaf(qq.y, kv[4 * e + 1], dot[t][1]);
            dot[t][0] = fmaf(qq.z, kv[4 * e + 2], dot[t][0]);
            dot[t][1] = fmaf(qq.w, kv[4 * e + 3], dot[t][1]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        float sc = dot[t][0] + dot[t][1];
        if constexpr (kQuant) sc *= slot_ks[r_slot[k]];
        s_s[t * kSpan + k] = r_pos[k] <= qpos[t] ? sc : kNeg;
      }
    }
    __syncthreads();
    // the chunk's max and sum, the same in every warp
#pragma unroll
    for (int t = 0; t < NQ; ++t) {
      float mx = -INFINITY;
#pragma unroll 4
      for (int k = lane; k < rows; k += 32)
        mx = fmaxf(mx, s_s[t * kSpan + k]);
      const float m_new = fmaxf(m[t], warp_max(mx));
      const float alpha = expf(m[t] - m_new);
      float ps = 0.f;
#pragma unroll 4
      for (int k = lane; k < rows; k += 32)
        ps += expf(s_s[t * kSpan + k] - m_new);
      l[t] = alpha * l[t] + warp_sum(ps);
      m[t] = m_new;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][e] *= alpha;
    }
    // acc += p v over this thread's keys
    if (nvalid > 0) {
#pragma unroll 4
      for (int k = g; k < rows; k += G) {
        float vv[4];
        load4(reinterpret_cast<const KV*>(v_s + k * rpv) + 4 * li, vv);
#pragma unroll
        for (int e = 0; e < 4; ++e) vv[e] = e < nvalid ? vv[e] : 0.f;
        const float vscl = kQuant ? slot_vs[r_slot[k]] : 1.f;
#pragma unroll
        for (int t = 0; t < NQ; ++t) {
          float p = expf(s_s[t * kSpan + k] - m[t]);
          if constexpr (kQuant) p *= vscl;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[t][e] = fmaf(p, vv[e], acc[t][e]);
        }
      }
    }
  }

  // sum acc over the key groups: the warp's by shuffle, then the warps'
  for (int off = L; off < 32; off <<= 1)
#pragma unroll
    for (int t = 0; t < NQ; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[t][e] += __shfl_xor_sync(0xffffffffu, acc[t][e], off);
  if (lane < L) {
#pragma unroll
    for (int t = 0; t < NQ; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < nvalid) red[(warp * NQ + t) * D + 4 * li + e] = acc[t][e];
  }
  __syncthreads();
  for (int i = tid; i < T_len * D; i += kDecThreads) {
    const int t = i / D, d = i - t * D;
    float o = 0.f;
#pragma unroll
    for (int wp = 0; wp < kDecWarps; ++wp) o += red[(wp * NQ + t) * D + d];
    float mt = m[0], lt = l[0];
#pragma unroll
    for (int tt = 1; tt < NQ; ++tt)
      if (tt == t) {
        mt = m[tt];
        lt = l[tt];
      }
    if (live_splits == 1) {
      out[((static_cast<size_t>(b) * T_len + t) * H + h) * D + d] =
          from_f32<T>(o / fmaxf(lt, 1e-30f));
    } else {
      float* rec = ws + ((((static_cast<size_t>(b) * H + h) * n_splits +
                           split) * T_len + t) * (D + 2));
      if (d == 0) {
        rec[0] = mt;
        rec[1] = lt;
      }
      rec[2 + d] = o;
    }
  }
}

// ---- decode: merge a row's spans in span order ---------------------------
// One block per (h, b); shared memory holds each live span's weight
// e^(m - M) for each query, and each query's sum L.
template <typename T>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_merge_kernel(const int* __restrict__ positions,
                          const int* __restrict__ max_pos,
                          const float* __restrict__ ws, T* __restrict__ out,
                          int T_len, int H, int D, int bs, int bps,
                          int n_splits) {
  extern __shared__ float coef[];  // [n_splits][T_len], then L[T_len]
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int last = -1;
  for (int t = 0; t < T_len; ++t) last = max(last, positions[b * T_len + t]);
  const int blim = min(max_pos[b], last);
  const int live_splits = blim < 0 ? 0 : (blim / bs) / bps + 1;
  if (live_splits <= 1) return;  // the split kernel wrote the output
  const size_t rec_len = D + 2;
  const float* base = ws + (static_cast<size_t>(b) * H + h) * n_splits *
                               T_len * rec_len;
  // warp t: M = max m over the spans, then the weights and L, each a
  // fixed-order reduction
  float* Ls = coef + n_splits * T_len;
  if (warp < T_len) {
    const int t = warp;
    float M = kNeg;
    for (int s = lane; s < live_splits; s += 32)
      M = fmaxf(M, base[(static_cast<size_t>(s) * T_len + t) * rec_len]);
    M = warp_max(M);
    float Lsum = 0.f;
    for (int s = lane; s < live_splits; s += 32) {
      const float* rec = base + (static_cast<size_t>(s) * T_len + t) * rec_len;
      const float c = expf(rec[0] - M);
      coef[s * T_len + t] = c;
      Lsum += c * rec[1];
    }
    Lsum = warp_sum(Lsum);
    if (lane == 0) Ls[t] = Lsum;
  }
  __syncthreads();
  for (int i = tid; i < T_len * D; i += kDecThreads) {
    const int t = i / D, d = i - t * D;
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < live_splits; ++s)
      o += coef[s * T_len + t] *
           base[(static_cast<size_t>(s) * T_len + t) * rec_len + 2 + d];
    out[((static_cast<size_t>(b) * T_len + t) * H + h) * D + d] =
        from_f32<T>(o / fmaxf(Ls[t], 1e-30f));
  }
}

// ---- prefill: one 64-query tile per block ---------------------------------
template <typename T, typename KV, int DM>
__global__ void __launch_bounds__(kPreThreads)
paged_prefill_tile_kernel(const T* __restrict__ q,
                          const KV* __restrict__ k_pool,
                          const KV* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ positions,
                          const int* __restrict__ max_pos,
                          T* __restrict__ out, int T_len, int H, int D,
                          int bs, int W, float scale, int cw) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kItem = sizeof(KV);
  constexpr int NJ = DM / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int rp = row_pitch(D, kItem), rpe = rp / kItem, LD = D + 1;
  unsigned char* ring = smem;  // [stage][K, V][kTile][rp] bytes
  float* Kf = reinterpret_cast<float*>(ring + 4 * kTile * rp);  // [64][LD]
  float* Qs = Kf + kTile * LD;             // [64][LD], pre-scaled
  float* Ps = Qs + kTile * LD;             // [64][kPad]
  float* meta_ks = Ps + kTile * kPad;      // [stage][64] key scales
  float* meta_vs = meta_ks + 2 * kTile;    // [stage][64]
  int* meta_live = reinterpret_cast<int*>(meta_vs + 2 * kTile);  // [2][64]
  int* qpos_s = meta_live + 2 * kTile;     // [64]
  int* last_s = qpos_s + kTile;            // [1]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int t0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int mp = max_pos[b];
  for (int e = tid; e < kTile * D; e += kPreThreads) {
    const int r = e / D, d = e - r * D, t = t0 + r;
    Qs[r * LD + d] =
        t < T_len
            ? to_f32(q[((static_cast<size_t>(b) * T_len + t) * H + h) * D +
                       d]) * scale
            : 0.f;
  }
  if (tid < kTile)
    qpos_s[tid] = t0 + tid < T_len ? positions[b * T_len + t0 + tid] : -1;
  __syncthreads();
  if (tid < 32) {
    int v = max(qpos_s[tid], qpos_s[tid + 32]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v = max(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (tid == 0) last_s[0] = v;
  }
  __syncthreads();
  const int last = last_s[0];
  // the last key position any query of the tile needs: at most the tile's
  // last query position, in a block that starts at or before max_pos
  const int blim = min(mp, last);
  const int kend =
      blim < 0 ? -1 : min(last, min(W * bs - 1, (blim / bs) * bs + bs - 1));
  const int nt = kend < 0 ? 0 : kend / kTile + 1;

  const int rb = D * kItem, cpr = rb / cw;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k_pool);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v_pool);
  // tile kt's K/V rows into ring stage `st`: 4 threads a row
  auto issue = [&](int kt, int st) {
    const int r = tid >> 2, part = tid & 3, p = kt * kTile + r;
    int blk = 0;
    if (p <= kend) blk = tables[b * W + p / bs];
    unsigned char* kd = ring + ((st * 2) * kTile + r) * rp;
    unsigned char* vd = ring + ((st * 2 + 1) * kTile + r) * rp;
    if (blk != 0) {
      const size_t src =
          ((static_cast<size_t>(blk) * bs + p % bs) * H + h) * rb;
      for (int c = part; c < cpr; c += 4) {
        copy_chunk(kd + c * cw, kb + src + c * cw, cw);
        copy_chunk(vd + c * cw, vb + src + c * cw, cw);
      }
    } else {
      for (int c = part; c < rp / 16; c += 4) {
        *reinterpret_cast<uint4*>(kd + c * 16) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd + c * 16) = make_uint4(0, 0, 0, 0);
      }
    }
    if (part == 0) {
      meta_live[st * kTile + r] = blk != 0;
      if constexpr (kQuant) {
        meta_ks[st * kTile + r] =
            blk != 0 ? k_scale[static_cast<size_t>(blk) * H + h] : 0.f;
        meta_vs[st * kTile + r] =
            blk != 0 ? v_scale[static_cast<size_t>(blk) * H + h] : 0.f;
      }
    }
  };

  float m[4], l[4], acc[4][NJ];
  int qp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
    qp[i] = qpos_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  if (nt > 0) {
    issue(0, 0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < nt) {
      issue(kt + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile kt (copies, zero rows, meta) visible
    const KV* kr = reinterpret_cast<const KV*>(ring + (st * 2) * kTile * rp);
    const KV* vr =
        reinterpret_cast<const KV*>(ring + (st * 2 + 1) * kTile * rp);
    for (int e = tid; e < kTile * D; e += kPreThreads) {
      const int r = e / D, d = e - r * D;
      Kf[r * LD + d] = to_f32(kr[r * rpe + d]);
    }
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
      for (int j = 0; j < 4; ++j) c[j] = Kf[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
    bool kl[4];
    float kscl[4], vscl[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = st * kTile + tx + 16 * j;
      kl[j] = meta_live[col] != 0;
      kscl[j] = kQuant ? meta_ks[col] : 1.f;
      vscl[j] = kQuant ? meta_vs[col] : 1.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = kt * kTile + tx + 16 * j;
        float v = kQuant ? s[i][j] * kscl[j] : s[i][j];
        v = kpos <= qp[i] ? v : kNeg;
        s[i][j] = kl[j] ? v : -INFINITY;  // a dead key is no key
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPad + tx + 16 * j] = kQuant ? p * vscl[j] : p;
        rs += p;
      }
      l[i] = alpha * l[i] + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kTile; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * kPad + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        vv[j] = d < D ? to_f32(vr[c * rpe + d]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // stage st's readers are done before it is refilled
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = t0 + ty + 16 * i;
    if (row >= T_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((static_cast<size_t>(b) * T_len + row) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) orow[d] = from_f32<T>(acc[i][j] * inv);
    }
  }
}

// ---- host side ---------------------------------------------------------
size_t decode_smem(int nq, int D, int item) {
  const int qp = (D * item + 15) / 16 * (16 / item);
  return static_cast<size_t>(kSpan) *
             (key_pitch(D, item) + row_pitch(D, item) + sizeof(long long)) +
         sizeof(float) * (static_cast<size_t>(nq) * (qp + kSpan) +
                          static_cast<size_t>(kDecWarps) * nq * D +
                          2 * kSpan) +
         sizeof(int) * (4 * kSpan + kDecWarps);
}
size_t prefill_smem(int D, int item) {
  return 4 * static_cast<size_t>(kTile) * row_pitch(D, item) +
         sizeof(float) * (2 * static_cast<size_t>(kTile) * (D + 1) +
                          kTile * kPad + 4 * kTile) +
         sizeof(int) * (3 * kTile + 4);
}
int decode_nq(int T_len) { return T_len == 1 ? 1 : 4; }
// positions a decode block holds, in whole pool blocks
int blocks_per_split(int bs) { return bs >= kSpan ? 1 : kSpan / bs; }

// the widest copy (16, 8, 4, 2 or 1 bytes) that a (key, head) row of rb
// bytes and both pools' base addresses allow
int copy_width(const void* k, const void* v, int rb) {
  int cw = 16;
  while (cw > 1 && (rb % cw != 0 || reinterpret_cast<uintptr_t>(k) % cw != 0 ||
                    reinterpret_cast<uintptr_t>(v) % cw != 0))
    cw >>= 1;
  return cw;
}

// refuses, before any launch, a layout past the card's 232,448 bytes a
// block (the wrapper raises on the error code)
template <typename K>
int allow_smem(K kern, size_t smem) {
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024)
    return static_cast<int>(cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
  return 0;
}

struct Args {
  const void *q, *k_pool, *v_pool;
  const float *k_scale, *v_scale;
  const int *tables, *positions, *max_pos;
  void* out;
  float* ws;
  int B, T_len, H, D, bs, W, n_splits;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int NQ>
int launch_decode(const Args& a) {
  const int bps = blocks_per_split(a.bs);
  if (a.n_splits != (a.W + bps - 1) / bps)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = decode_smem(NQ, a.D, sizeof(KV));
  auto kern = paged_decode_split_kernel<T, KV, NQ>;
  int rc = allow_smem(kern, smem);
  if (rc != 0) return rc;
  const int cw = copy_width(a.k_pool, a.v_pool, a.D * sizeof(KV));
  kern<<<dim3(a.n_splits, a.H, a.B), kDecThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k_pool),
      static_cast<const KV*>(a.v_pool), a.k_scale, a.v_scale, a.tables,
      a.positions, a.max_pos, static_cast<T*>(a.out), a.ws, a.T_len, a.H,
      a.D, a.bs, a.W, bps, a.n_splits, a.scale, cw);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  auto merge = paged_decode_merge_kernel<T>;
  const size_t msmem =
      sizeof(float) * (static_cast<size_t>(a.n_splits) + 1) * a.T_len;
  rc = allow_smem(merge, msmem);
  if (rc != 0) return rc;
  merge<<<dim3(a.H, a.B), kDecThreads, msmem, a.stream>>>(
      a.positions, a.max_pos, a.ws, static_cast<T*>(a.out), a.T_len, a.H,
      a.D, a.bs, bps, a.n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV, int DM>
int launch_prefill(const Args& a) {
  const size_t smem = prefill_smem(a.D, sizeof(KV));
  auto kern = paged_prefill_tile_kernel<T, KV, DM>;
  int rc = allow_smem(kern, smem);
  if (rc != 0) return rc;
  const int cw = copy_width(a.k_pool, a.v_pool, a.D * sizeof(KV));
  kern<<<dim3((a.T_len + kTile - 1) / kTile, a.H, a.B), kPreThreads, smem,
         a.stream>>>(static_cast<const T*>(a.q),
                     static_cast<const KV*>(a.k_pool),
                     static_cast<const KV*>(a.v_pool), a.k_scale, a.v_scale,
                     a.tables, a.positions, a.max_pos,
                     static_cast<T*>(a.out), a.T_len, a.H, a.D, a.bs, a.W,
                     a.scale, cw);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KV>
int dispatch(const Args& a) {
  if (a.D <= 0 || a.D > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (a.T_len <= 4)
    return a.T_len == 1 ? launch_decode<T, KV, 1>(a)
                        : launch_decode<T, KV, 4>(a);
  if (a.D <= 32) return launch_prefill<T, KV, 32>(a);
  if (a.D <= 64) return launch_prefill<T, KV, 64>(a);
  return launch_prefill<T, KV, 128>(a);
}

// q's dtype code: 0 = float32, 1 = bfloat16.  The float pool has q's
// dtype; the quantized one is int8.
template <bool kQuant>
int dispatch_q_dtype(Args& a, int dtype) {
  if (a.B <= 0 || a.T_len <= 0) return 0;
  if (dtype == 0)
    return dispatch<float, std::conditional_t<kQuant, int8_t, float>>(a);
  if (dtype == 1)
    return dispatch<__nv_bfloat16,
                    std::conditional_t<kQuant, int8_t, __nv_bfloat16>>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, out: (B, T, H, D); k_pool, v_pool: (num_blocks, bs, H, D), all
// contiguous in `dtype` (0 = float32, 1 = bfloat16); tables (B, W),
// positions (B, T), max_pos (B,) int32; ws: the decode route's f32
// workspace of B * H * n_splits * T * (D + 2) floats, n_splits = ceil(W /
// max(1, 128 / bs)) (the launch refuses another; prefill leaves ws
// unused).  Returns the launches' cudaError_t.
extern "C" int tpumx_paged_attention(const void* q, const void* k_pool,
                                     const void* v_pool, const void* tables,
                                     const void* positions,
                                     const void* max_pos, void* out,
                                     void* ws, int B, int T_len, int H,
                                     int D, int bs, int W, int n_splits,
                                     float scale, int dtype, void* stream) {
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(tables), static_cast<const int*>(positions),
         static_cast<const int*>(max_pos), out, static_cast<float*>(ws),
         B, T_len, H, D, bs, W, n_splits, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch_q_dtype<false>(a, dtype);
}

// The int8 pool: k_pool, v_pool (num_blocks, bs, H, D) int8 with k_scale,
// v_scale (num_blocks, H) float32; q and out in `dtype` as above.
extern "C" int tpumx_paged_attention_q(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* positions, const void* max_pos, void* out, void* ws, int B,
    int T_len, int H, int D, int bs, int W, int n_splits, float scale,
    int dtype, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(tables), static_cast<const int*>(positions),
         static_cast<const int*>(max_pos), out, static_cast<float*>(ws),
         B, T_len, H, D, bs, W, n_splits, scale,
         static_cast<cudaStream_t>(stream)};
  return dispatch_q_dtype<true>(a, dtype);
}
