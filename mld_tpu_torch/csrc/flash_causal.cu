// Causal multi-head attention of the CLIP text tower, one warp per (example,
// head, tile of 16 queries), a block per (example, head) or several, on
// Hopper's tensor cores (sm_90a).
//
// Replaces: mld_tpu/ops/attention.py:_flash_causal_kernel (called from
// sdpa_flash_causal, l.223; pallas_call l.252).
//
// What it computes, per (example, head) with q, k, v [S, Dh] (S <= 128):
//   s[i, j] = (q_i . k_j) * sm_scale, keys j > i excluded (-1e9 on the TPU,
//   whose exp is exactly 0 because the diagonal is always attended);
//   p = softmax_j(s) in f32, rounded to the operands' dtype;
//   out_i = sum_j p[i, j] v_j, accumulated in f32, stored in q's dtype.
// Operands are f32 or bf16; bf16 products are exact in f32, as on the TPU
// (bf16 operands, f32 accumulation).
//
// What bounds it on this card: at the serving shapes ([128, 12, S, 64], S = 8
// .. 77, bf16) a launch reads and writes 1.6-15.1 MB (1-4.5 us at 3.35 TB/s)
// and computes 0.03-1.0 GFLOP, so the bound is bytes; what a kernel this
// small loses time to is latency: launch, the first loads, and the steps in
// order inside one (example, head).
//
// What the design does about it:
//  * A block holds whole (example, head)s: their Q, K and V rows come into
//    shared memory once, by cp.async from all its threads (16 bytes a copy,
//    8 where a row is not a multiple of 16 bytes; rows past S and columns
//    past Dh zero-filled), and after one barrier each warp computes one
//    16-query tile from them. Short sequences put several heads in a block
//    (4 at S = 16), so that a block has 4 warps at least.
//  * Scores for the whole tile row stay in registers (S <= 128): mma.sync
//    m16n8k16 bf16 with f32 accumulation, or m16n8k8 TF32 with the three-pass
//    split for f32 (x = big + small, a.b ~ big.big + small.big + big.small;
//    within the 1e-5 bar, tests/test_torch_tf32_split.py::test_causal_bar).
//    Key tiles wholly above a warp's diagonal are not multiplied.
//  * The softmax runs on the accumulator fragments: the row max and sum go
//    across the four threads that share a row by two shuffles; no score
//    matrix in shared memory. P is divided by the sum and rounded to v's
//    dtype (the TPU kernel's cast, attention.py:215) before P.V.
//  * P.V takes the score fragments as its A operand without a trip through
//    shared memory (bf16: two 8-key tiles are one 16-key A fragment, V by
//    ldmatrix.trans; f32: the keys permuted inside an 8-key step, t <-> 2t,
//    t + 4 <-> 2t + 1, in P and V alike). The tensor cores' sums truncate, so
//    the f32 arm keeps the small products in accumulators of their own.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kMaxWarps = 8;     // S <= 128: 8 tiles of 16 queries
constexpr int kBlockWarps = 4;   // the heads a block takes fill this many warps
constexpr size_t kBlockSmem = 113 * 1024;  // two blocks an SM at least

// geometry for operand type T and head width padded to DHP (elements)
template <typename T, int DHP>
struct Geo {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kQKStr = DHP + 8;                 // rows of Q and K
  static constexpr int kVStr = kF32 ? DHP + 4 : DHP + 8;  // rows of V
  // one head's Q, K and V rows [Sp], Sp = S rounded up to 16
  __host__ __device__ static size_t head_elems(int Sp) {
    return (size_t)Sp * (2 * kQKStr + kVStr);
  }
};

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [0, rows) of a contiguous [nrows, Dh] operand into shared rows of `str`
// elements, DHP columns, by the block; zeros past nrows and past Dh
template <typename T, int DHP, int BYTES>
__device__ __forceinline__ void block_rows(T* dst, int str, const T* src, int rows,
                                           int nrows, int Dh) {
  constexpr int kE = BYTES / (int)sizeof(T);
  constexpr int kPer = DHP / kE;
  for (int c = threadIdx.x; c < rows * kPer; c += blockDim.x) {
    const int r = c / kPer;
    const int e = (c - r * kPer) * kE;
    const bool ok = r < nrows && e < Dh;
    copy_async<BYTES>(dst + r * str + e, ok ? src + (size_t)r * Dh + e : src, ok);
  }
}

// the block's heads h0 .. h0 + nh - 1: Q, K and V rows [Sp] each
template <typename T, int DHP, int BYTES>
__device__ __forceinline__ void block_load(T* smem, const T* q, const T* k, const T* v,
                                           int h0, int nh, int S, int Sp, int Dh) {
  using G = Geo<T, DHP>;
  for (int i = 0; i < nh; ++i) {
    T* qs = smem + i * G::head_elems(Sp);
    const size_t base = (size_t)(h0 + i) * S * Dh;
    block_rows<T, DHP, BYTES>(qs, G::kQKStr, q + base, Sp, S, Dh);
    block_rows<T, DHP, BYTES>(qs + Sp * G::kQKStr, G::kQKStr, k + base, Sp, S, Dh);
    block_rows<T, DHP, BYTES>(qs + 2 * Sp * G::kQKStr, G::kVStr, v + base, Sp, S, Dh);
  }
}

// KMAX: keys a tile can need (S rounded up to 16, at most KMAX)
template <typename T, int DHP, int KMAX>
__global__ void __launch_bounds__(32 * kMaxWarps)
causal_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ out, int BH, int S, int Dh, int Sp, float sm_scale, int vec,
              int heads) {
  using G = Geo<T, DHP>;
  constexpr int NT = KMAX / 8;  // score tiles of 8 keys
  constexpr int ND = DHP / 8;   // output tiles of 8 columns
  extern __shared__ float4 smem_f4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (and B column)
  const int t = lane & 3;
  const int tiles = Sp / 16;
  const int h0 = blockIdx.x * heads;
  const int nh = min(heads, BH - h0);
  T* smem = reinterpret_cast<T*>(smem_f4);
  if (vec == 16)
    block_load<T, DHP, 16>(smem, q, k, v, h0, nh, S, Sp, Dh);
  else
    block_load<T, DHP, 8>(smem, q, k, v, h0, nh, S, Sp, Dh);
  copy_commit();
  copy_wait<0>();
  __syncthreads();
  // this warp: head h0 + warp / tiles, queries q0 .. q0 + 15
  if (warp / tiles >= nh) return;
  const int bh = h0 + warp / tiles;
  const int q0 = warp % tiles * 16;
  const int kend = q0 + 16;  // keys 0 .. q0 + 15 are on or below the diagonal
  T* qs = smem + (warp / tiles) * G::head_elems(Sp) + q0 * G::kQKStr;
  const T* ks = smem + (warp / tiles) * G::head_elems(Sp) + Sp * G::kQKStr;
  const T* vs = ks + Sp * G::kQKStr;
  const size_t base = (size_t)bh * S * Dh;

  // scores: s[nt] holds rows g and g + 8 against keys 8 nt + 2 t, + 1
  float s[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  if constexpr (G::kF32) {
    const float* qf = reinterpret_cast<const float*>(qs);
    const float* kf = reinterpret_cast<const float*>(ks);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt >= kend) break;
      float c[4] = {0.f, 0.f, 0.f, 0.f};  // the small products
#pragma unroll
      for (int kk = 0; kk < DHP / 8; ++kk) {
        // head dimension permuted: k = t <-> 8 kk + 2t, k = t + 4 <-> 8 kk + 2t + 1
        const float2 q0v = *reinterpret_cast<const float2*>(qf + g * G::kQKStr + 8 * kk + 2 * t);
        const float2 q1v =
            *reinterpret_cast<const float2*>(qf + (g + 8) * G::kQKStr + 8 * kk + 2 * t);
        const float2 kv =
            *reinterpret_cast<const float2*>(kf + (8 * nt + g) * G::kQKStr + 8 * kk + 2 * t);
        uint32_t ab[4], as[4], bb[2], bs[2];
        split_tf32(q0v.x, ab[0], as[0]);
        split_tf32(q1v.x, ab[1], as[1]);
        split_tf32(q0v.y, ab[2], as[2]);
        split_tf32(q1v.y, ab[3], as[3]);
        split_tf32(kv.x, bb[0], bs[0]);
        split_tf32(kv.y, bb[1], bs[1]);
        mma_tf32(c, as, bb);
        mma_tf32(c, ab, bs);
        mma_tf32(s[nt], ab, bb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] += c[e];
    }
  } else {
    uint32_t qa[DHP / 16][4];
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const T* r0 = qs + g * G::kQKStr + 16 * kk + 2 * t;
      const T* r1 = r0 + 8 * G::kQKStr;
      qa[kk][0] = ld_u32(r0);
      qa[kk][1] = ld_u32(r1);
      qa[kk][2] = ld_u32(r0 + 8);
      qa[kk][3] = ld_u32(r1 + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      if (8 * nt >= kend) break;
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
        const T* kp = ks + (8 * nt + g) * G::kQKStr + 16 * kk + 2 * t;
        const uint32_t bf[2] = {ld_u32(kp), ld_u32(kp + 8)};
        mma_bf16(s[nt], qa[kk], bf);
      }
    }
  }

  // softmax over keys j <= i, for rows i = q0 + g and q0 + g + 8
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (8 * nt >= kend) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + g + 8 * (e >> 1);
      const int key = 8 * nt + 2 * t + (e & 1);
      const float x = key <= row ? s[nt][e] * sm_scale : -INFINITY;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (8 * nt >= kend) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[nt][e] = expf(s[nt][e] - mx[e >> 1]);  // 0 above the diagonal
      sum[e >> 1] += s[nt][e];
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
    sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (8 * nt >= kend) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = s[nt][e] / sum[e >> 1];
  }

  // out = P.V over the key tiles up to the diagonal
  float o[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  if constexpr (G::kF32) {
    const float* vf = reinterpret_cast<const float*>(vs);
    float oc[ND][4];  // the small products
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) oc[nd][0] = oc[nd][1] = oc[nd][2] = oc[nd][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      if (8 * kc >= kend) break;
      // keys permuted as above: k = t <-> key 8 kc + 2t, k = t + 4 <-> 8 kc + 2t + 1
      uint32_t pb[4], ps[4];
      split_tf32(s[kc][0], pb[0], ps[0]);
      split_tf32(s[kc][2], pb[1], ps[1]);
      split_tf32(s[kc][1], pb[2], ps[2]);
      split_tf32(s[kc][3], pb[3], ps[3]);
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const float* v0 = vf + (8 * kc + 2 * t) * G::kVStr + 8 * nd + g;
        uint32_t bb[2], bs[2];
        split_tf32(v0[0], bb[0], bs[0]);
        split_tf32(v0[G::kVStr], bb[1], bs[1]);
        mma_tf32(oc[nd], ps, bb);
        mma_tf32(oc[nd], pb, bs);
        mma_tf32(o[nd], pb, bb);
      }
    }
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] += oc[nd][e];
  } else {
    // P rounded to bf16: the score tiles 2c and 2c + 1 are the A operand of
    // keys 16c .. 16c + 15; V fragments by ldmatrix.trans, two column tiles
    // a load
    const int vr = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int vc = (lane >> 4) * 8;
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      if (16 * c >= kend) break;
      const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                              pack_bf16(s[2 * c][2], s[2 * c][3]),
                              pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                              pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND; nd += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, vs + (16 * c + vr) * G::kVStr + 8 * nd + vc);
        const uint32_t b0[2] = {r[0], r[1]};
        const uint32_t b1[2] = {r[2], r[3]};
        mma_bf16(o[nd], pa, b0);
        mma_bf16(o[nd + 1], pa, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + g + 8 * i;
    if (row >= S) continue;
    T* orow = out + base + (size_t)row * Dh;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = 8 * nd + 2 * t;  // Dh % 4 == 0: col + 1 < Dh too
      if (col >= Dh) continue;
      if constexpr (G::kF32)
        *reinterpret_cast<float2*>(orow + col) = make_float2(o[nd][2 * i], o[nd][2 * i + 1]);
      else
        *reinterpret_cast<uint32_t*>(orow + col) = pack_bf16(o[nd][2 * i], o[nd][2 * i + 1]);
    }
  }
}

template <typename T, int DHP, int KMAX>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int Dh,
           float sm_scale, cudaStream_t stream) {
  const int Sp = (S + 15) / 16 * 16;
  const int tiles = Sp / 16;
  const size_t per = Geo<T, DHP>::head_elems(Sp) * sizeof(T);
  int heads = kBlockWarps / tiles > 0 ? kBlockWarps / tiles : 1;
  while (heads > 1 && heads * per > kBlockSmem) --heads;
  const size_t smem = heads * per;
  cudaError_t err = cudaFuncSetAttribute(causal_kernel<T, DHP, KMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = (Dh * sizeof(T)) % 16 == 0 ? 16 : 8;
  const int blocks = (BH + heads - 1) / heads;
  causal_kernel<T, DHP, KMAX><<<blocks, 32 * heads * tiles, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), BH, S, Dh, Sp, sm_scale, vec, heads);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_shape(const void* q, const void* k, const void* v, void* out, int BH, int S,
                 int Dh, float sm_scale, cudaStream_t stream) {
  if (Dh <= 64) {
    if (S <= 32) return launch<T, 64, 32>(q, k, v, out, BH, S, Dh, sm_scale, stream);
    if (S <= 64) return launch<T, 64, 64>(q, k, v, out, BH, S, Dh, sm_scale, stream);
    return launch<T, 64, 128>(q, k, v, out, BH, S, Dh, sm_scale, stream);
  }
  if (S <= 32) return launch<T, 128, 32>(q, k, v, out, BH, S, Dh, sm_scale, stream);
  if (S <= 64) return launch<T, 128, 64>(q, k, v, out, BH, S, Dh, sm_scale, stream);
  return launch<T, 128, 128>(q, k, v, out, BH, S, Dh, sm_scale, stream);
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous [BH, S, Dh] device arrays of one dtype, f32
// (bf16 == 0) or bf16 (bf16 == 1); S <= 128, Dh a multiple of 4 up to 128.
// Returns a cudaError_t (0 on success) after the asynchronous launch.
int mld_flash_causal_forward(const void* q, const void* k, const void* v,
                             void* out, int BH, int S, int Dh, float sm_scale,
                             int bf16, void* stream) {
  if (BH <= 0 || S <= 0 || S > 128 || Dh < 4 || Dh > 128 || Dh % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_shape<__nv_bfloat16>(q, k, v, out, BH, S, Dh, sm_scale, st);
  return launch_shape<float>(q, k, v, out, BH, S, Dh, sm_scale, st);
}

}  // extern "C"
