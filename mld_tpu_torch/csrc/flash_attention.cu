// Bidirectional multi-head attention with a key-padding mask, one block per
// (example, head, tile of 64 queries), on Hopper's tensor cores (sm_90a).
//
// Replaces: mld_tpu/ops/attention.py:_flash_kernel (launched by
// sdpa_pallas, l.113, through pallas_call, l.142; dispatch sdpa, l.304).
//
// What it computes, per (example b, head h) with q [Sq, Dh], k, v [Sk, Dh]:
//   s[i, j] = (q_i . k_j) * sm_scale in f32, from operands upcast to f32;
//   s[i, j] = -1e9 where key j is invalid (valid[b, j] == 0);
//   p = softmax_j(s) in f32; out_i = sum_j p[i, j] v_j in f32, stored in q's
//   dtype.
// A fully masked row therefore averages v over the Sk real keys, which is
// sdpa_xla's result. The TPU kernel pads Sk to a multiple of 128 with invalid
// zero keys, so its fully masked rows divide by the padded count instead
// (ROADMAP.md, section 3): here keys past Sk are excluded (probability 0),
// never filled with -1e9.
//
// What bounds it on this card: matrix products. The s512 self-attention
// ([12, 4, 512, 128]) is 6.4 GFLOP a launch over 6 MB of operands, ~1,000
// FLOP a byte, far above the ridge of every unit. The TPU kernel computes at
// Precision.HIGHEST, a multi-pass bf16 emulation of f32 on the MXU; its
// counterpart here is the three-pass TF32 split on the tensor cores: x = big
// + small, big rounded to TF32 and small the rest, and a.b ~ big.big +
// big.small + small.big in f32 accumulators, which keeps ~22 of f32's 24
// mantissa bits (a CPU emulation holds it within f32's 1e-5 bar:
// tests/test_torch_tf32_split.py). So the f32 arm is bound by 495 / 3 = 165
// TFLOP/s of TF32 products and the bf16 arm by 989 TFLOP/s of bf16 products
// (exact bf16 x bf16 products, f32 accumulation, P rounded to bf16 for P.V),
// and both by keeping the tensor cores fed from shared memory.
//
// What the design does about it:
//  * The TPU kernel holds one (example, head)'s whole Sq x Sk score tile in
//    VMEM (1 MB at 512 x 512); here keys stream through shared memory in
//    tiles (32 keys in f32, 64 in bf16) with an online softmax.
//  * Four warps, 16 query rows each: mma.sync m16n8k8 (TF32) or m16n8k16
//    (bf16) products with the scores and the output accumulator in
//    registers, FlashAttention-2 style: the scores' accumulator fragments
//    become the A operand of P.V without a trip through shared memory. For
//    TF32 the thread holds keys 2t and 2t+1 of an 8-key tile where the A
//    operand wants t and t+4; P.V sums over keys, so the k index is
//    permuted (k = t <-> key 2t, k = t+4 <-> key 2t+1) in P and in V alike,
//    and Q.K^T permutes its head dimension the same way (64-bit loads).
//    bf16 V fragments come through ldmatrix.trans.
//  * The tensor cores sum into the f32 accumulator without rounding to
//    nearest, so the f32 arm keeps its chains of products short: each key
//    tile's P.V goes into fresh accumulators that a rounded f32 add folds
//    into the output, and the small products of P.V and of the scores into
//    accumulators of their own. One accumulator per output over all keys
//    drifted to 2.2e-6 at the s512 self-attention; this keeps it within
//    5.5e-7-8.9e-7, as close as PyTorch's f32 SDPA (PERF.md).
//  * K and V tiles are double-buffered and copied with cp.async: the next
//    tile's copy is in flight while the current one is multiplied. Rows
//    past Sk and columns past Dh are zero-filled by the copy.
//  * Operands are read in place through batch, head and row strides, so the
//    views of the packed QKV projection need no copy; the copy width is the
//    widest of 16, 8, 4 (or 2) bytes that every base, stride and row length
//    allows (bf16 rows of Dh = 4 or 68 take 8-byte copies). The output is
//    written through strides too, so the out-projection reads it without
//    one.
//  * Row padding in shared memory keeps the fragment loads free of bank
//    conflicts: Q and K rows are DHP + 8 elements, f32 V rows DHP + 4.
//  * Dh is padded to 32, 64 or 128 at compile time (zero columns add
//    nothing to a score and are not stored).
//
// The reduced arms of f32 tensors (the C entry's `arm` 2 and 3) compute as
// the JAX package's sdpa_xla (attention.py:48-73) does when its einsums
// inherit a reduced matmul precision: q and k rounded (to TF32 under
// "high", to bf16 under "default"), f32 scores, -1e9 at masked keys, f32
// softmax, then the NORMALISED probabilities and v rounded alike, P.V
// summed in f32 and stored in f32. The bf16-tensor arm above rounds the
// unnormalised exponentials of an online softmax instead, which would put
// the rounding at other points; so these arms take two sweeps over the key
// tiles: the first (K only) takes each row's max and sum of exp(s - max),
// the second recomputes the scores, rounds p = exp(s - max) / sum and
// multiplies it by V. The scores cost twice: a third more products than
// one sweep. TF32 operands are rounded to nearest, ties to even, on the
// bits, as the plain version rounds (precision.round_bits), not by
// split_tf32's add, which rounds ties away; bf16 operands by
// __float2bfloat16_rn, the same rounding. Products of rounded operands are
// exact, so these arms are bound by one pass of TF32 (495 TFLOP/s) or bf16
// (989 TFLOP/s) products; each key tile's P.V goes into accumulators of
// its own, folded into the output by a rounded add, as in the f32 arm.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // queries a block, 16 a warp
constexpr float kMaskFill = -1e9f;
constexpr float kLog2e = 1.4426950408889634f;
// the C entry's arms: f32 tensors at 3xTF32, bf16 tensors, f32 tensors with
// operands rounded to TF32, f32 tensors with bf16 operands
constexpr int kArmF32 = 0, kArmBf16 = 1, kArmTf32 = 2, kArmBf16Ops = 3;

struct Strides {
  long long b, h, r;  // elements between examples, heads and rows
};

// tile geometry for operand type T and padded head width DHP (elements)
template <typename T, int DHP>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kBK = kF32 ? 32 : 64;  // keys a tile
  static constexpr int kQKStr = DHP + 8;      // row stride of Q and K
  static constexpr int kVStr = kF32 ? DHP + 4 : DHP + 8;
  static constexpr int kQ = kRows * kQKStr;
  static constexpr int kK = kBK * kQKStr;
  static constexpr int kV = kBK * kVStr;
  static constexpr size_t smem_bytes() {
    return sizeof(T) * ((size_t)kQ + 2 * ((size_t)kK + kV)) +
           sizeof(float) * 2 * kBK;
  }
};

// rows [r0, r0 + rows) of an operand (row i at base + i * rstride) into
// shared rows of `str` elements, DHP columns; zeros past nrows and past Dh
template <typename T, int DHP, int BYTES>
__device__ __forceinline__ void load_rows(T* dst, int str, const T* base,
                                          long long rstride, int r0, int rows,
                                          int nrows, int Dh) {
  constexpr int kE = BYTES / (int)sizeof(T);  // elements a copy
  constexpr int kPer = DHP / kE;              // copies a row
  for (int c = threadIdx.x; c < rows * kPer; c += kThreads) {
    const int r = c / kPer;
    const int e = (c - r * kPer) * kE;
    const bool ok = r0 + r < nrows && e < Dh;
    copy_async<BYTES>(dst + r * str + e,
                      ok ? base + (long long)(r0 + r) * rstride + e : base, ok);
  }
}

template <typename T, int DHP>
__device__ __forceinline__ void load_tile(int vec, T* dst, int str,
                                          const T* base, long long rstride,
                                          int r0, int rows, int nrows, int Dh) {
  if (vec == 16)
    load_rows<T, DHP, 16>(dst, str, base, rstride, r0, rows, nrows, Dh);
  else if (vec == 8)
    load_rows<T, DHP, 8>(dst, str, base, rstride, r0, rows, nrows, Dh);
  else if constexpr (sizeof(T) == 2) {
    if (vec == 4)
      load_rows<T, DHP, 4>(dst, str, base, rstride, r0, rows, nrows, Dh);
    else
      load_rows<T, DHP, 2>(dst, str, base, rstride, r0, rows, nrows, Dh);
  } else {
    load_rows<T, DHP, 4>(dst, str, base, rstride, r0, rows, nrows, Dh);
  }
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 1 for a valid key, 0 for a masked one, -1 past Sk
__device__ __forceinline__ float key_flag(const unsigned char* vrow, int j,
                                          int Sk) {
  return j >= Sk ? -1.f : (vrow == nullptr || vrow[j]) ? 1.f : 0.f;
}

// The tensor cores add each product into the f32 accumulator without
// rounding to nearest (the sum is cut toward zero), so a long chain of
// products into one accumulator drifts by up to an ulp of the sum a
// product. The f32 products below keep those chains short: the big.big
// products of a key tile go into an accumulator of their own, which a plain
// f32 add (round to nearest) folds into the running sum, and the two small
// products into another, whose sum is ~2^-11 of the result.

// scores of this warp's 16 rows against one key tile, f32 operands:
// s[nt] holds rows g and g + 8, keys 8 nt + 2t and 8 nt + 2t + 1; s comes
// in zeroed and takes the big.big products, c the small ones
template <int DHP, int NT, int QKSTR>
__device__ __forceinline__ void scores(float (&s)[NT][4], const float* qs,
                                       const float* ks, int g, int t) {
  float c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DHP / 8; ++kk) {
    // head dimension permuted: k = t <-> 8kk + 2t, k = t + 4 <-> 8kk + 2t + 1
    const float2 q0 = *reinterpret_cast<const float2*>(qs + g * QKSTR + 8 * kk + 2 * t);
    const float2 q1 = *reinterpret_cast<const float2*>(qs + (g + 8) * QKSTR + 8 * kk + 2 * t);
    uint32_t ab[4], as[4];
    split_tf32(q0.x, ab[0], as[0]);
    split_tf32(q1.x, ab[1], as[1]);
    split_tf32(q0.y, ab[2], as[2]);
    split_tf32(q1.y, ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float2 kv = *reinterpret_cast<const float2*>(
          ks + (8 * nt + g) * QKSTR + 8 * kk + 2 * t);
      uint32_t bb[2], bs[2];
      split_tf32(kv.x, bb[0], bs[0]);
      split_tf32(kv.y, bb[1], bs[1]);
      mma_tf32(c[nt], as, bb);
      mma_tf32(c[nt], ab, bs);
      mma_tf32(s[nt], ab, bb);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] += c[nt][e];
}

// o += p.v for one key tile, f32: the keys of p's tile nt are permuted as
// above (k = t <-> key 2t, k = t + 4 <-> key 2t + 1). Each 8 output columns
// take the tile's products in accumulators of their own (a chain of NT
// big.big products), added to o once.
template <int DHP, int NT, int VSTR>
__device__ __forceinline__ void p_times_v(float (&o)[DHP / 8][4],
                                          const float (&p)[NT][4],
                                          const float* vs, int g, int t) {
  uint32_t pb[NT][4], ps[NT][4];
#pragma unroll
  for (int kc = 0; kc < NT; ++kc) {
    split_tf32(p[kc][0], pb[kc][0], ps[kc][0]);
    split_tf32(p[kc][2], pb[kc][1], ps[kc][1]);
    split_tf32(p[kc][1], pb[kc][2], ps[kc][2]);
    split_tf32(p[kc][3], pb[kc][3], ps[kc][3]);
  }
#pragma unroll
  for (int nd = 0; nd < DHP / 8; ++nd) {
    float a[4] = {0.f, 0.f, 0.f, 0.f}, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      const float* v0 = vs + (8 * kc + 2 * t) * VSTR + g + 8 * nd;
      uint32_t bb[2], bs[2];
      split_tf32(v0[0], bb[0], bs[0]);
      split_tf32(v0[VSTR], bb[1], bs[1]);
      mma_tf32(c, ps[kc], bb);
      mma_tf32(c, pb[kc], bs);
      mma_tf32(a, pb[kc], bb);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] += a[e] + c[e];
  }
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const unsigned char* __restrict__ valid,
             T* __restrict__ out, int Sq, int Sk, int Dh, Strides sq,
             Strides sk, Strides sv, Strides so, float sm_scale, int vec) {
  using G = Tile<T, DHP>;
  constexpr int kBK = G::kBK;
  constexpr int kNT = kBK / 8;   // score tiles of 8 keys
  constexpr int kND = DHP / 8;   // output tiles of 8 columns
  extern __shared__ float4 smem_f4[];
  T* qs = reinterpret_cast<T*>(smem_f4);
  T* ks = qs + G::kQ;                                       // [2][kBK][.]
  T* vs = ks + 2 * G::kK;                                   // [2][kBK][.]
  float* kflag = reinterpret_cast<float*>(vs + 2 * G::kV);  // [2][kBK]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // mma fragment row (and B column)
  const int t = lane & 3;   // thread in its group of four
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const unsigned char* vrow = valid ? valid + (long long)b * Sk : nullptr;
  const int n_tiles = (Sk + kBK - 1) / kBK;

  auto load_kv = [&](int kt) {
    const int st = kt & 1;
    load_tile<T, DHP>(vec, ks + st * G::kK, G::kQKStr, kb, sk.r, kt * kBK,
                      kBK, Sk, Dh);
    load_tile<T, DHP>(vec, vs + st * G::kV, G::kVStr, vb, sv.r, kt * kBK,
                      kBK, Sk, Dh);
  };

  // the block's queries and the first key tile, then the warp's Q rows
  load_tile<T, DHP>(vec, qs, G::kQKStr, q + b * sq.b + h * sq.h, sq.r, q0,
                    kRows, Sq, Dh);
  load_kv(0);
  copy_commit();
  if (tid < kBK) kflag[tid] = key_flag(vrow, tid, Sk);
  copy_wait<0>();
  __syncthreads();
  const T* qw = qs + 16 * warp * G::kQKStr;
  // bf16: the warp's Q fragments stay in registers for every key tile
  uint32_t qf[G::kF32 ? 1 : DHP / 16][4];
  if constexpr (!G::kF32) {
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const T* r0 = qw + g * G::kQKStr + 16 * kk + 2 * t;
      const T* r1 = r0 + 8 * G::kQKStr;
      qf[kk][0] = ld_u32(r0);
      qf[kk][1] = ld_u32(r1);
      qf[kk][2] = ld_u32(r0 + 8);
      qf[kk][3] = ld_u32(r1 + 8);
    }
  }

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // running max (log2 units) and this thread's part of the running sum, for
  // rows g and g + 8
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};
  const float scale2 = sm_scale * kLog2e;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const bool more = kt + 1 < n_tiles;
    float flag_next = 0.f;
    if (more) {
      load_kv(kt + 1);
      if (tid < kBK) flag_next = key_flag(vrow, (kt + 1) * kBK + tid, Sk);
    }
    copy_commit();
    copy_wait<1>();  // tile kt has landed; tile kt + 1 may be in flight
    __syncthreads();
    const int st = kt & 1;
    const T* kt_s = ks + st * G::kK;
    const T* vt_s = vs + st * G::kV;
    const float* fl = kflag + st * kBK;

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    if constexpr (G::kF32) {
      scores<DHP, kNT, G::kQKStr>(s, reinterpret_cast<const float*>(qw),
                                  reinterpret_cast<const float*>(kt_s), g, t);
    } else {
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk) {
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const T* kp = kt_s + (8 * nt + g) * G::kQKStr + 16 * kk + 2 * t;
          const uint32_t bf[2] = {ld_u32(kp), ld_u32(kp + 8)};
          mma_bf16(s[nt], qf[kk], bf);
        }
      }
    }

    // scale (log2 units), -1e9 at masked keys, -inf past Sk; tile max
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f = fl[8 * nt + 2 * t + (e & 1)];
        const float x = f > 0.f ? s[nt][e] * scale2
                        : f == 0.f ? kMaskFill : -CUDART_INF_F;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // every tile holds a key below Sk, so the new max is finite
      const float m_new = fmaxf(m_run[i], mx[i]);
      alpha[i] = exp2f(m_run[i] - m_new);  // 0 on the first tile
      m_run[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m_run[e >> 1]);  // 0 past Sk
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + rs[i];
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      o[nd][0] *= alpha[0];
      o[nd][1] *= alpha[0];
      o[nd][2] *= alpha[1];
      o[nd][3] *= alpha[1];
    }

    if constexpr (G::kF32) {
      p_times_v<DHP, kNT, G::kVStr>(o, s, reinterpret_cast<const float*>(vt_s),
                                    g, t);
    } else {
      // bf16 P: the score tiles 2c and 2c + 1 are the A operand of keys
      // 16c..16c+15; V fragments by ldmatrix.trans, two column tiles a load
      const int vr = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int vc = (lane >> 4) * 8;
#pragma unroll
      for (int c = 0; c < kBK / 16; ++c) {
        const uint32_t pa[4] = {pack_bf16(s[2 * c][0], s[2 * c][1]),
                                pack_bf16(s[2 * c][2], s[2 * c][3]),
                                pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]),
                                pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3])};
#pragma unroll
        for (int nd = 0; nd < kND; nd += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vt_s + (16 * c + vr) * G::kVStr + 8 * nd + vc);
          const uint32_t b0[2] = {r[0], r[1]};
          const uint32_t b1[2] = {r[2], r[3]};
          mma_bf16(o[nd], pa, b0);
          mma_bf16(o[nd + 1], pa, b1);
        }
      }
    }

    if (more && tid < kBK) kflag[(st ^ 1) * kBK + tid] = flag_next;
    __syncthreads();  // every warp is done with stage st before its refill
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
  }
  const int row0 = q0 + 16 * warp + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Sq) continue;
    const float inv = 1.f / l_run[i];
    T* orow = out + b * so.b + h * so.h + (long long)row * so.r;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int col = 8 * nd + 2 * t;  // Dh % 4 == 0: col + 1 < Dh too
      if (col < Dh) {
        orow[col] = from_f<T>(o[nd][2 * i] * inv);
        orow[col + 1] = from_f<T>(o[nd][2 * i + 1] * inv);
      }
    }
  }
}

// f32 x as TF32, rounded to nearest, ties to even, on the bits (the
// rounding of precision.round_bits; split_tf32 rounds ties away)
__device__ __forceinline__ uint32_t tf32_rne(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u + 0xfffu + ((u >> 13) & 1u)) & 0xffffe000u;
}

// scores of this warp's 16 rows against one key tile of f32 K in a reduced
// arm, laid out as in scores(): s[nt] holds rows g and g + 8, keys 8 nt +
// 2t and 8 nt + 2t + 1. bf16: qf holds the warp's Q fragments, K is
// rounded as it is read; TF32: Q and K rounded as they are read, the head
// dimension permuted as in scores()
template <bool BF16OPS, int DHP, int NT, int QKSTR>
__device__ __forceinline__ void scores_reduced(float (&s)[NT][4],
                                               const float* qs,
                                               const uint32_t (&qf)[DHP / 16][4],
                                               const float* ks, int g, int t) {
  if constexpr (BF16OPS) {
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kp = ks + (8 * nt + g) * QKSTR + 16 * kk + 2 * t;
        const float2 k0 = *reinterpret_cast<const float2*>(kp);
        const float2 k1 = *reinterpret_cast<const float2*>(kp + 8);
        const uint32_t bf[2] = {pack_bf16(k0.x, k0.y), pack_bf16(k1.x, k1.y)};
        mma_bf16(s[nt], qf[kk], bf);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < DHP / 8; ++kk) {
      const float2 q0 = *reinterpret_cast<const float2*>(qs + g * QKSTR + 8 * kk + 2 * t);
      const float2 q1 = *reinterpret_cast<const float2*>(qs + (g + 8) * QKSTR + 8 * kk + 2 * t);
      const uint32_t a[4] = {tf32_rne(q0.x), tf32_rne(q1.x), tf32_rne(q0.y),
                             tf32_rne(q1.y)};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 kv = *reinterpret_cast<const float2*>(
            ks + (8 * nt + g) * QKSTR + 8 * kk + 2 * t);
        const uint32_t b[2] = {tf32_rne(kv.x), tf32_rne(kv.y)};
        mma_tf32(s[nt], a, b);
      }
    }
  }
}

// o += p.v for one key tile of f32 V in a reduced arm, p and v rounded as
// they are read; each 8 output columns take the tile's products in
// accumulators of their own, added to o once. bf16: the score tiles 2c and
// 2c + 1 are the A operand of keys 16c..16c+15; TF32: keys permuted as in
// p_times_v()
template <bool BF16OPS, int DHP, int NT, int VSTR>
__device__ __forceinline__ void p_times_v_reduced(float (&o)[DHP / 8][4],
                                                  const float (&p)[NT][4],
                                                  const float* vs, int g,
                                                  int t) {
  if constexpr (BF16OPS) {
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int c = 0; c < NT / 2; ++c) {
      pa[c][0] = pack_bf16(p[2 * c][0], p[2 * c][1]);
      pa[c][1] = pack_bf16(p[2 * c][2], p[2 * c][3]);
      pa[c][2] = pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]);
      pa[c][3] = pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3]);
    }
#pragma unroll
    for (int nd = 0; nd < DHP / 8; ++nd) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < NT / 2; ++c) {
        const float* v0 = vs + (16 * c + 2 * t) * VSTR + 8 * nd + g;
        const uint32_t b[2] = {pack_bf16(v0[0], v0[VSTR]),
                               pack_bf16(v0[8 * VSTR], v0[9 * VSTR])};
        mma_bf16(a, pa[c], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] += a[e];
    }
  } else {
    uint32_t pb[NT][4];
#pragma unroll
    for (int kc = 0; kc < NT; ++kc) {
      pb[kc][0] = tf32_rne(p[kc][0]);
      pb[kc][1] = tf32_rne(p[kc][2]);
      pb[kc][2] = tf32_rne(p[kc][1]);
      pb[kc][3] = tf32_rne(p[kc][3]);
    }
#pragma unroll
    for (int nd = 0; nd < DHP / 8; ++nd) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < NT; ++kc) {
        const float* v0 = vs + (8 * kc + 2 * t) * VSTR + g + 8 * nd;
        const uint32_t b[2] = {tf32_rne(v0[0]), tf32_rne(v0[VSTR])};
        mma_tf32(a, pb[kc], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nd][e] += a[e];
    }
  }
}

// The reduced arms of f32 tensors (see the head of this file): steps 0 ..
// n_tiles - 1 are the first sweep (K tiles only), steps n_tiles .. 2 n_tiles
// - 1 the second (K and V); the double buffer and the key flags alternate
// by step. Scores in natural units, exp and the division as the plain
// version takes them (expf, IEEE division).
template <bool BF16OPS, int DHP>
__global__ void __launch_bounds__(kThreads, 2)
flash_reduced_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ out, int Sq, int Sk, int Dh,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     float sm_scale, int vec) {
  using G = Tile<float, DHP>;
  constexpr int kBK = G::kBK;
  constexpr int kNT = kBK / 8;
  constexpr int kND = DHP / 8;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* ks = qs + G::kQ;        // [2][kBK][.]
  float* vs = ks + 2 * G::kK;    // [2][kBK][.]
  float* kflag = vs + 2 * G::kV; // [2][kBK]

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const unsigned char* vrow = valid ? valid + (long long)b * Sk : nullptr;
  const int n_tiles = (Sk + kBK - 1) / kBK;
  const int n_steps = 2 * n_tiles;

  auto tile_of = [&](int i) { return i < n_tiles ? i : i - n_tiles; };
  auto load = [&](int i) {
    const int st = i & 1;
    const int r0 = tile_of(i) * kBK;
    load_tile<float, DHP>(vec, ks + st * G::kK, G::kQKStr, kb, sk.r, r0, kBK,
                          Sk, Dh);
    if (i >= n_tiles)
      load_tile<float, DHP>(vec, vs + st * G::kV, G::kVStr, vb, sv.r, r0, kBK,
                            Sk, Dh);
  };

  load_tile<float, DHP>(vec, qs, G::kQKStr, q + b * sq.b + h * sq.h, sq.r, q0,
                        kRows, Sq, Dh);
  load(0);
  copy_commit();
  if (tid < kBK) kflag[tid] = key_flag(vrow, tid, Sk);
  copy_wait<0>();
  __syncthreads();
  const float* qw = qs + 16 * warp * G::kQKStr;
  uint32_t qf[DHP / 16][4];
  if constexpr (BF16OPS) {
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const float* r0 = qw + g * G::kQKStr + 16 * kk + 2 * t;
      const float* r1 = r0 + 8 * G::kQKStr;
      qf[kk][0] = pack_bf16(r0[0], r0[1]);
      qf[kk][1] = pack_bf16(r1[0], r1[1]);
      qf[kk][2] = pack_bf16(r0[8], r0[9]);
      qf[kk][3] = pack_bf16(r1[8], r1[9]);
    }
  }

  float o[kND][4];
#pragma unroll
  for (int nd = 0; nd < kND; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
  // rows g and g + 8: the running max, and this thread's part of the
  // running sum (the whole row's after the first sweep)
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.f, 0.f};

  for (int i = 0; i < n_steps; ++i) {
    const bool more = i + 1 < n_steps;
    float flag_next = 0.f;
    if (more) {
      load(i + 1);
      if (tid < kBK) flag_next = key_flag(vrow, tile_of(i + 1) * kBK + tid, Sk);
    }
    copy_commit();
    copy_wait<1>();
    __syncthreads();
    const int st = i & 1;
    const float* fl = kflag + st * kBK;

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    scores_reduced<BF16OPS, DHP, kNT, G::kQKStr>(s, qw, qf, ks + st * G::kK,
                                                 g, t);
    // scaled as the plain version scales, -1e9 at masked keys, -inf past Sk
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float f = fl[8 * nt + 2 * t + (e & 1)];
        s[nt][e] = f > 0.f ? s[nt][e] * sm_scale
                   : f == 0.f ? kMaskFill : -CUDART_INF_F;
      }
    }
    if (i < n_tiles) {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        // every tile holds a key below Sk, so the new max is finite
        const float m_new = fmaxf(m_run[r], mx[r]);
        l_run[r] *= expf(m_run[r] - m_new);  // 0 on the first tile
        m_run[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          l_run[e >> 1] += expf(s[nt][e] - m_run[e >> 1]);  // 0 past Sk
      if (i == n_tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
          l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = __fdiv_rn(expf(s[nt][e] - m_run[e >> 1]), l_run[e >> 1]);
      p_times_v_reduced<BF16OPS, DHP, kNT, G::kVStr>(o, s, vs + st * G::kV, g,
                                                     t);
    }

    if (more && tid < kBK) kflag[(st ^ 1) * kBK + tid] = flag_next;
    __syncthreads();  // every warp is done with stage st before its refill
  }

  const int row0 = q0 + 16 * warp + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    float* orow = out + b * so.b + h * so.h + (long long)row * so.r;
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) {
      const int col = 8 * nd + 2 * t;
      if (col < Dh) {
        orow[col] = o[nd][2 * r];
        orow[col + 1] = o[nd][2 * r + 1];
      }
    }
  }
}

template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* q, const void* k,
           const void* v, const void* valid, void* out, int B, int H, int Sq,
           int Sk, int Dh, Strides sq, Strides sk, Strides sv, Strides so,
           float sm_scale, int vec, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
      static_cast<T*>(out), Sq, Sk, Dh, sq, sk, sv, so, sm_scale, vec);
  return (int)cudaGetLastError();
}

// the arm's kernel at the padded head width DHP
template <typename T, int DHP>
int launch_arm(int arm, const void* q, const void* k, const void* v,
               const void* valid, void* out, int B, int H, int Sq, int Sk,
               int Dh, Strides sq, Strides sk, Strides sv, Strides so,
               float sm_scale, int vec, cudaStream_t stream) {
  const size_t smem = Tile<T, DHP>::smem_bytes();
  if constexpr (std::is_same<T, float>::value) {
    if (arm == kArmTf32)
      return launch<T>(flash_reduced_kernel<false, DHP>, smem, q, k, v, valid,
                       out, B, H, Sq, Sk, Dh, sq, sk, sv, so, sm_scale, vec,
                       stream);
    if (arm == kArmBf16Ops)
      return launch<T>(flash_reduced_kernel<true, DHP>, smem, q, k, v, valid,
                       out, B, H, Sq, Sk, Dh, sq, sk, sv, so, sm_scale, vec,
                       stream);
  }
  return launch<T>(flash_kernel<T, DHP>, smem, q, k, v, valid, out, B, H, Sq,
                   Sk, Dh, sq, sk, sv, so, sm_scale, vec, stream);
}

template <typename T>
int launch_dh(int arm, const void* q, const void* k, const void* v,
              const void* valid, void* out, int B, int H, int Sq, int Sk,
              int Dh, Strides sq, Strides sk, Strides sv, Strides so,
              float sm_scale, cudaStream_t stream) {
  // widest copy that every operand's base, strides and row length allow
  unsigned long long a = (unsigned long long)(uintptr_t)q |
                         (uintptr_t)k | (uintptr_t)v |
                         (unsigned long long)Dh * sizeof(T);
  for (const Strides& s : {sq, sk, sv})
    a |= (unsigned long long)(s.b | s.h | s.r) * sizeof(T);
  int vec = 16;
  while (vec > (int)sizeof(T) && (a & (vec - 1))) vec >>= 1;
  if (Dh <= 32)
    return launch_arm<T, 32>(arm, q, k, v, valid, out, B, H, Sq, Sk, Dh, sq,
                             sk, sv, so, sm_scale, vec, stream);
  if (Dh <= 64)
    return launch_arm<T, 64>(arm, q, k, v, valid, out, B, H, Sq, Sk, Dh, sq,
                             sk, sv, so, sm_scale, vec, stream);
  return launch_arm<T, 128>(arm, q, k, v, valid, out, B, H, Sq, Sk, Dh, sq,
                            sk, sv, so, sm_scale, vec, stream);
}

}  // namespace

extern "C" {

// q [B, H, Sq, Dh], k, v [B, H, Sk, Dh] and out [B, H, Sq, Dh]: device arrays
// of one dtype, addressed through the given batch, head and row strides (in
// elements) with unit stride along Dh. arm: 0 f32 at 3xTF32, 1 bf16, 2 f32
// with operands rounded to TF32, 3 f32 with bf16 operands (kArm*).
// valid: [B, Sk] bytes, contiguous, nonzero = attend, or null for all keys.
// Returns a cudaError_t (0 on success) after the asynchronous launch.
int mld_flash_forward(const void* q, const void* k, const void* v,
                      const void* valid, void* out, int B, int H, int Sq,
                      int Sk, int Dh, long long q_sb, long long q_sh,
                      long long q_sr, long long k_sb, long long k_sh,
                      long long k_sr, long long v_sb, long long v_sh,
                      long long v_sr, long long o_sb, long long o_sh,
                      long long o_sr, float sm_scale, int arm, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || Sq <= 0 || Sk <= 0 ||
      Dh < 4 || Dh > 128 || Dh % 4 != 0 || arm < kArmF32 || arm > kArmBf16Ops)
    return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sr}, sk{k_sb, k_sh, k_sr},
      sv{v_sb, v_sh, v_sr}, so{o_sb, o_sh, o_sr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (arm == kArmBf16)
    return launch_dh<__nv_bfloat16>(arm, q, k, v, valid, out, B, H, Sq, Sk,
                                    Dh, sq, sk, sv, so, sm_scale, st);
  return launch_dh<float>(arm, q, k, v, valid, out, B, H, Sq, Sk, Dh, sq, sk,
                          sv, so, sm_scale, st);
}

}  // extern "C"
