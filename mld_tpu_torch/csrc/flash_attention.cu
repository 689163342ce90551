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
// summed in f32 and stored in f32. TF32 operands are rounded to nearest,
// ties to even, on the bits, as the plain version rounds
// (precision.round_bits), not by split_tf32's add, which rounds ties away;
// bf16 operands by __float2bfloat16_rn, the same rounding. Products of
// rounded operands are exact; each key tile's P.V goes into accumulators
// of its own, folded into the output by a rounded add, as in the f32 arm.
// The bf16-tensor arm above rounds the unnormalised exponentials of an
// online softmax instead, so these arms cannot start P.V before a row's
// sum is known.
//
// What bounds them on this card: bytes, at every shape the port serves
// them. The plain VAE decode's [128, 4, 196, 64] against 197 keys moves
// 103 MB of f32 operands and output (0.031 ms at 3.35 TB/s) for 5.1 GFLOP
// (0.005 ms of bf16, 0.010 of TF32 products at the tensor cores' peak);
// hidden mode's [256, 4, 79, 64] 83 MB (0.025 ms) for 1.6 GFLOP; raw
// motion's [256, 4, 198, 128] 415 MB (0.124 ms) for 20.6 GFLOP (0.021 /
// 0.042 ms); s512's [12, 4, 512, 128] 50 MB (0.015 ms) for 6.4 GFLOP
// (0.007 / 0.013 ms).
//
// What flash_reduced_kernel does about it:
//  * One sweep over K, read once an item (64 queries of one example and
//    head): each warp keeps its 16 rows of scores in shared memory (512
//    bytes a warp for every 8 keys: 51 KB a block at 197 keys, 128 KB at
//    512) until the row's max and sum are known, then V streams once. Q.K^T
//    is computed once a score.
//  * One exp a score and no division: log2 e is folded into the score
//    scale, each score takes one ex2.approx (MUFU.EX2, within 2 ulp), each
//    row one IEEE reciprocal, and p = e * (1 / l) is rounded as it is
//    packed into P.V's A operand. The plain version divides exp(s - max) by
//    the sum; the two part where a last-bit difference moves a probability
//    across a rounding boundary: sparse flips, inside the RMS bar of
//    chip_smoke.py phase 3, as a CPU emulation of this arithmetic shows
//    (tests/test_torch_flash_reduced_arith.py).
//  * Operands rounded once a block: each 32-row tile lands in f32 and is
//    converted once into a tile of the arm's type (bf16: half the bytes, V
//    read by ldmatrix.trans; TF32: rounded on the bits), each compute warp
//    converting 8 of its rows; Q's fragments go to registers once an item.
//  * Copies by TMA: one cp.async.bulk.tensor a tile, a 32-row box of a 4-D
//    tensor map of each operand (Dh, then rows, heads and examples in order
//    of their strides, so the head views of the packed QKV projection need
//    no copy), zeros past the rows and past Dh, completion counted on an
//    mbarrier. One lane of a fifth warp keeps `stages` tiles in flight (2
//    to 8, as many as fit beside the scores, two blocks an SM where they
//    fit), across items. A bulk copy a row was bound by the copy engine's
//    requests, not by bytes. One named barrier of the compute warps a tile;
//    no block-wide barrier after the start.
//  * A persistent grid: as many blocks as the card holds at once, walking
//    the items so that those of one head run side by side and share K and
//    V through L2.
//  * The products, not the bytes, bound the kernel: the copies alone take
//    two fifths to a half of its time, the products alone 0.6-0.8 of it,
//    and on mma.sync the MMAs with their operand loads took half of the
//    products in bf16 and two thirds in TF32
//    (scripts/bench_flash_reduced_parts.py). At DHP = 128 (raw motion's
//    and s512's Dh) warpgroup MMAs pay over mma.sync: an item's 64 queries
//    are one m64 wgmma tile, Q.K^T reads K from shared memory in the
//    128-byte swizzle (both arms), and TF32's P.V reads V transposed (32
//    keys make a 128-byte row); a quarter off TF32's time, a tenth off
//    bf16's (PERF.md, section 6). bf16's P.V stays on mma.sync: its rows
//    of 32 keys are 64 bytes. Up to DHP = 64 the kernel stays on mma.sync,
//    whose per-warp tiles let a warp past Sq skip its products; TF32's P.V
//    at DHP = 128 sums all key tiles in the tensor cores' accumulators.
//  * Rows whose scores leave no room for two landing slots (past ~600-700
//    keys, by arm and Dh) and operands the copy engine cannot address take
//    flash_reduced_long_kernel, chosen by shape in the C entry: two
//    sweeps over the key tiles (the row's max and sum, then the scores
//    again and P.V), expf and an IEEE division a score.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <climits>
#include <initializer_list>
#include <map>
#include <mutex>
#include <tuple>
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

// The reduced arms' path for rows longer than flash_reduced_kernel keeps on
// chip, or operands it cannot bulk-copy (see the head of this file): two
// sweeps over the key tiles. Steps 0 .. n_tiles - 1 are the first sweep (K
// tiles only: each row's max and sum), steps n_tiles .. 2 n_tiles - 1 the
// second (K and V: the scores again, P normalised and rounded, P.V); the
// double buffer and the key flags alternate by step. Scores in natural
// units, exp and the division as the plain version takes them (expf, IEEE
// division).
template <bool BF16OPS, int DHP>
__global__ void __launch_bounds__(kThreads, 2)
flash_reduced_long_kernel(const float* __restrict__ q, const float* __restrict__ k,
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

// ------------------------------------------ the reduced arms, one sweep
// Geometry of flash_reduced_kernel (see the head of this file) for the arm's
// operand type (bf16, or TF32 kept as f32 bits) at padded head width DHP. A
// tile is 32 rows of one operand: keys of K or V, or queries (an item's 64
// queries are two tiles).
template <bool BF16OPS, int DHP>
struct Red {
  using Op = typename std::conditional<BF16OPS, __nv_bfloat16, float>::type;
  static constexpr int kConsumers = 4;  // warps of 16 queries
  static constexpr int kThreads = 32 * (kConsumers + 1);  // + the copy warp
  static constexpr int kBK = 32;        // rows a tile
  static constexpr int kTyped = 2;      // tiles in the arm's type
  static constexpr int kMaxStages = 8;  // f32 landing slots, chosen at launch
  // row strides of the typed tiles (elements): Q, K and bf16 V; TF32 V
  // (conflict-free fragment loads, as in Tile)
  static constexpr int kStr = DHP + 8;
  static constexpr int kVStr = BF16OPS ? DHP + 8 : DHP + 4;
  static constexpr int kStageFloats = kBK * DHP;
  static constexpr size_t kStageBytes = sizeof(float) * kStageFloats;
  // at DHP = 128 the products are warpgroup MMAs (wgmma) with B read from
  // shared memory: Q.K^T in both arms (K in the 128-byte swizzle, K-major:
  // 4 KB a 128-byte column block of the tile's 32 keys) and P.V in TF32 (V
  // transposed, 128 rows of 32 keys, K-major); bf16 V's rows of 32 keys are
  // 64 bytes, under the swizzle's 128, and keep mma.sync
  static constexpr bool kWG = DHP == 128;
  // a typed tile's bytes, a multiple of 1 KB (the swizzle's atoms)
  static constexpr size_t kTypedBytes =
      (sizeof(Op) * kBK * kStr + 1023) / 1024 * 1024;
  static constexpr size_t kBarBytes = 16 * kMaxStages;  // full, drained
  // the typed tiles, then the barriers (the landing slots that follow are
  // aligned for the copy engine)
  static constexpr size_t kFixed = kTyped * kTypedBytes + kBarBytes;
  // then the landing slots, each warp's scores ([8-key column][lane] float4,
  // 512 bytes a column) and its row of the key mask (bytes, to a multiple of
  // the tile); 1 KB to align the start
  __host__ __device__ static int mask_stride(int Sk) {
    return (Sk + kBK - 1) / kBK * kBK;
  }
  static size_t smem_bytes(int Sk, int stages) {
    return 1024 + kFixed + stages * kStageBytes +
           (size_t)kConsumers * ((Sk + 7) / 8 * 512 + mask_stride(Sk));
  }
};

// where an operand's tensor map keeps the rows, heads and examples: which of
// its dims 1-3 (dim 0 is Dh; the three in order of their strides)
struct RedDims {
  int row, head, ex;
};

// A walk over a block's tiles in order: for each of its items (64 queries of
// one example and head; block x takes items x, x + gridDim.x, ...) its
// two query tiles, the key tiles of K, then those of V.
struct RedWalk {
  int H, n_qt, n_kt;
  int item, lt;  // where the walk is: the item, the tile in it
  int q0, b, h;  // the item's first query, example and head

  __device__ __forceinline__ void enter(int it) {
    item = it;
    lt = 0;
    const int bh = it / n_qt;
    q0 = (it - bh * n_qt) * 64;
    b = bh / H;
    h = bh - b * H;
  }
  __device__ __forceinline__ void next() {
    if (++lt == 2 + 2 * n_kt) enter(item + gridDim.x);
  }
  // which operand the tile is (0 Q, 1 K, 2 V) and its first row
  __device__ __forceinline__ int operand(int& r0) const {
    if (lt < 2) {
      r0 = q0 + 32 * lt;
      return 0;
    }
    if (lt < 2 + n_kt) {
      r0 = 32 * (lt - 2);
      return 1;
    }
    r0 = 32 * (lt - 2 - n_kt);
    return 2;
  }
};

// The reduced arms of f32 tensors, one sweep (see the head of this file), on
// a persistent grid: warps 0-3 compute, 16 queries each; one lane of warp 4
// copies. Tile i of a block lands, by one TMA copy of a 32-row box of its
// operand's tensor map (zeros past the rows and past Dh), in slot i % stages
// (barrier full); each compute warp converts a quarter of its rows into
// typed tile i % 2 and arrives (drained, 128 arrivals: the slot may be
// refilled); a named barrier of the compute warps, and every warp reads the
// typed tile. Copies run `stages` tiles ahead of the conversion, across
// items. MINB: the blocks an SM the registers are budgeted for (2 holds a
// thread to 168 registers, five warps a block on an SM's four register
// files).
template <bool BF16OPS, int DHP, int MINB>
__global__ void __launch_bounds__(Red<BF16OPS, DHP>::kThreads, MINB)
flash_reduced_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, RedDims dq,
                     RedDims dk, RedDims dv,
                     const unsigned char* __restrict__ valid,
                     float* __restrict__ out, int H, int Sq, int Sk, int Dh,
                     Strides so, float sm_scale, int n_items, int stages) {
  using R = Red<BF16OPS, DHP>;
  using Op = typename R::Op;
  constexpr int kND = DHP / 8;
  constexpr int kBK = R::kBK;
  constexpr int kNT = kBK / 8;  // 8-key score columns a tile
  constexpr int kCompute = 32 * R::kConsumers;
  extern __shared__ float4 smem_f4[];
  char* base = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_f4) + 1023) & ~uintptr_t(1023));
  char* typed = base;  // [kTyped][kTypedBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + R::kTyped * R::kTypedBytes);
  uint64_t* drained = full + R::kMaxStages;  // [stages] each
  float* stage = reinterpret_cast<float*>(full + 2 * R::kMaxStages);
  const int n8 = (Sk + 7) / 8;  // 8-key score columns kept
  float4* scores = reinterpret_cast<float4*>(stage + stages * R::kStageFloats);
  unsigned char* masks =
      reinterpret_cast<unsigned char*>(scores + R::kConsumers * n8 * 32);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  RedWalk walk;
  walk.H = H;
  walk.n_qt = (Sq + 63) / 64;
  walk.n_kt = (Sk + kBK - 1) / kBK;
  const int n_kt = walk.n_kt;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&drained[s], kCompute);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the one block-wide barrier

  if (warp == R::kConsumers) {
    if (lane == 0) {
      // tiles of this block (the host keeps the count in an int)
      const int total = (n_items - (int)blockIdx.x + (int)gridDim.x - 1) /
                        (int)gridDim.x * (2 + 2 * n_kt);
      walk.enter(blockIdx.x);
      int s = 0;
      unsigned ph = 0;
      for (int i = 0; i < total; ++i) {
        if (i >= stages) mbar_wait(&drained[s], ph ^ 1);
        int r0;
        const int op = walk.operand(r0);
        const CUtensorMap* tm = op == 0 ? &tq : op == 1 ? &tk : &tv;
        const RedDims d = op == 0 ? dq : op == 1 ? dk : dv;
        const int c[3] = {d.row == 1 ? r0 : d.head == 1 ? walk.h : walk.b,
                          d.row == 2 ? r0 : d.head == 2 ? walk.h : walk.b,
                          d.row == 3 ? r0 : d.head == 3 ? walk.h : walk.b};
        mbar_expect_bytes(&full[s], (unsigned)R::kStageBytes);
        tma_load_4d(stage + s * R::kStageFloats, tm, 0, c[0], c[1], c[2],
                    &full[s]);
        walk.next();
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  const int g = lane >> 2;
  const int t4 = lane & 3;
  const float scale2 = sm_scale * kLog2e;
  float4* sc = scores + warp * n8 * 32;  // this warp's columns
  unsigned char* mrow = masks + warp * R::mask_stride(Sk);
  int s = 0, u = 0;  // the next landing slot (and its parity), typed tile
  unsigned ph = 0;
  // the next tile, of operand `op` (0 Q, 1 K, 2 V): wait for it to land,
  // convert this warp's quarter of its rows into the arm's type and layout,
  // free the slot, wait for the other warps
  auto take = [&](int op) -> const Op* {
    mbar_wait(&full[s], ph);
    const float* src = stage + s * R::kStageFloats;
    char* dst = typed + u * R::kTypedBytes;
    if (R::kWG && op == 2 && !BF16OPS) {
      // V transposed for P.V's B: row n (a column of V) holds the tile's 32
      // keys in the order of P's A fragments (k = t <-> key 2t, k = t + 4
      // <-> key 2t + 1 of each 8), 128 bytes in the 128-byte swizzle; this
      // warp's 8 keys are one such group
      const int kq = lane >> 2;
      const int slot = 8 * warp + (kq & 1) * 4 + (kq >> 1);
#pragma unroll
      for (int j = 0; j < DHP / 16; ++j) {
        const int col = 4 * ((lane & 3) + 4 * j);
        const float4 x = *reinterpret_cast<const float4*>(
            src + (8 * warp + kq) * DHP + col);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = col + e;
          *reinterpret_cast<uint32_t*>(
              dst + n * 128 + (((slot >> 2) ^ (n & 7)) << 4) + (slot & 3) * 4) =
              tf32_rne(xs[e]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < DHP / 16; ++j) {
        const int c = lane + 32 * j;
        const int r = 8 * warp + c / (DHP / 4);
        const int col = c % (DHP / 4) * 4;
        const float4 x = *reinterpret_cast<const float4*>(src + r * DHP + col);
        // padded rows, or for K at DHP = 128 the 128-byte swizzle: column
        // block col * size / 128, 16-byte chunk c of row r at chunk c ^ (r % 8)
        int at = (r * (op == 2 ? R::kVStr : R::kStr) + col) * (int)sizeof(Op);
        if (R::kWG && op == 1) {
          const int byte = col * (int)sizeof(Op);
          at = (byte >> 7) * (R::kBK * 128) + r * 128 +
               ((((byte & 127) >> 4) ^ (r & 7)) << 4) + (byte & 15);
        }
        if constexpr (BF16OPS) {
          *reinterpret_cast<uint2*>(dst + at) =
              make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
        } else {
          *reinterpret_cast<uint4*>(dst + at) = make_uint4(
              tf32_rne(x.x), tf32_rne(x.y), tf32_rne(x.z), tf32_rne(x.w));
        }
      }
    }
    // the warpgroup MMAs read shared memory through the async proxy
    if constexpr (R::kWG) fence_proxy_async();
    mbar_arrive(&drained[s]);
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
    named_barrier(1, kCompute);
    u ^= 1;
    return reinterpret_cast<const Op*>(dst);
  };

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    walk.enter(item);
    const int b = walk.b;
    const int h = walk.h;
    const int row0 = walk.q0 + 16 * warp;
    // warp-uniform: skip the work, not the protocol; a warpgroup MMA takes
    // all four warps, so at DHP = 128 every warp computes (rows past Sq are
    // zeros and are not stored)
    const bool active = R::kWG || row0 < Sq;
    if (active && valid != nullptr) {
      // the example's key mask, this warp's own copy
      __syncwarp();
      const unsigned char* vrow = valid + (long long)b * Sk;
#pragma unroll 8
      for (int j = lane; j < Sk; j += 32) mrow[j] = vrow[j];
      __syncwarp();
    }

    // the warp's Q fragments, rounded once
    uint32_t qf[BF16OPS ? DHP / 16 : DHP / 8][4];
    for (int j = 0; j < 2; ++j) {
      const Op* qt = take(0);
      if (active && j == warp / 2) {
        const Op* qw = qt + 16 * (warp & 1) * R::kStr;
        if constexpr (BF16OPS) {
#pragma unroll
          for (int kk = 0; kk < DHP / 16; ++kk) {
            const Op* r0 = qw + g * R::kStr + 16 * kk + 2 * t4;
            const Op* r1 = r0 + 8 * R::kStr;
            qf[kk][0] = ld_u32(r0);
            qf[kk][1] = ld_u32(r1);
            qf[kk][2] = ld_u32(r0 + 8);
            qf[kk][3] = ld_u32(r1 + 8);
          }
        } else if constexpr (R::kWG) {
          // wgmma reads K from shared memory in Dh's own order, so Q's
          // fragments keep it: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3
          // (g + 8, t + 4) of each 8-wide k-step
          const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qw);
#pragma unroll
          for (int kk = 0; kk < DHP / 8; ++kk) {
            const uint32_t* r0 = q32 + g * R::kStr + 8 * kk + t4;
            const uint32_t* r1 = r0 + 8 * R::kStr;
            qf[kk][0] = r0[0];
            qf[kk][1] = r1[0];
            qf[kk][2] = r0[4];
            qf[kk][3] = r1[4];
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < DHP / 8; ++kk) {
            const uint2 a0 = *reinterpret_cast<const uint2*>(
                qw + g * R::kStr + 8 * kk + 2 * t4);
            const uint2 a1 = *reinterpret_cast<const uint2*>(
                qw + (g + 8) * R::kStr + 8 * kk + 2 * t4);
            qf[kk][0] = a0.x;
            qf[kk][1] = a1.x;
            qf[kk][2] = a0.y;
            qf[kk][3] = a1.y;
          }
        }
      }
    }

    // one sweep over K: scores in log2 units (log2 e folded into the
    // scale), -1e9 at masked keys, -inf past Sk, kept in the warp's columns
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    for (int kt = 0; kt < n_kt; ++kt) {
      const Op* ks = take(1);
      if (!active) continue;
      float s4[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) s4[nt][0] = s4[nt][1] = s4[nt][2] = s4[nt][3] = 0.f;
      if constexpr (R::kWG) {
        // the warpgroup's 64 x 32 scores, a k-step 32 bytes of a K row:
        // column block kk / 4, 32 (kk % 4) bytes into its rows
        float (&d)[16] = *reinterpret_cast<float(*)[16]>(&s4[0][0]);
        const char* kb = reinterpret_cast<const char*>(ks);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < (BF16OPS ? DHP / 16 : DHP / 8); ++kk) {
          const uint64_t desc = smem_desc_sw128(
              kb + (kk >> 2) * (R::kBK * 128) + (kk & 3) * 32, 1024);
          if constexpr (BF16OPS)
            wgmma_bf16_n32(d, qf[kk], desc, kk > 0);
          else
            wgmma_tf32_n32(d, qf[kk], desc, kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int i = 0; i < 16; ++i) reg_fence(d[i]);
#pragma unroll
        for (int kk = 0; kk < (BF16OPS ? DHP / 16 : DHP / 8); ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) reg_fence(qf[kk][i]);
      } else if constexpr (BF16OPS) {
#pragma unroll
        for (int kk = 0; kk < DHP / 16; ++kk) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const Op* kp = ks + (8 * nt + g) * R::kStr + 16 * kk + 2 * t4;
            const uint32_t bf[2] = {ld_u32(kp), ld_u32(kp + 8)};
            mma_bf16(s4[nt], qf[kk], bf);
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < DHP / 8; ++kk) {
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            const uint2 kv = *reinterpret_cast<const uint2*>(
                ks + (8 * nt + g) * R::kStr + 8 * kk + 2 * t4);
            const uint32_t bf[2] = {kv.x, kv.y};
            mma_tf32(s4[nt], qf[kk], bf);
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const int key = kBK * kt + 8 * nt + 2 * t4;  // and key + 1
        unsigned keep = (key < Sk) | (key + 1 < Sk) << 1;
        if (valid != nullptr) keep &= (mrow[key] != 0) | (mrow[key + 1] != 0) << 1;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in_row = key + (e & 1) < Sk;
          const float x = keep >> (e & 1) & 1u ? s4[nt][e] * scale2
                          : in_row ? kMaskFill : -CUDART_INF_F;
          s4[nt][e] = x;
          m[e >> 1] = fmaxf(m[e >> 1], x);
        }
        if (kNT * kt + nt < n8)
          sc[(kNT * kt + nt) * 32 + lane] =
              make_float4(s4[nt][0], s4[nt][1], s4[nt][2], s4[nt][3]);
      }
    }

    // the row's max and sum, one exp a score, one reciprocal a row
    float inv[2] = {0.f, 0.f};
    if (active) {
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      }
#pragma unroll 4
      for (int c = 0; c < n8; ++c) {
        float4 x = sc[c * 32 + lane];
        x.x = ex2_approx(x.x - m[0]);  // 0 past Sk; 1 in a fully masked row
        x.y = ex2_approx(x.y - m[0]);
        x.z = ex2_approx(x.z - m[1]);
        x.w = ex2_approx(x.w - m[1]);
        l[0] += x.x + x.y;
        l[1] += x.z + x.w;
        sc[c * 32 + lane] = x;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = __frcp_rn(l[r]);
      }
    }

    // V streamed once: p = e / l rounded as it is packed into P.V's A
    // operand; each key tile's products in accumulators of their own,
    // folded into o by a rounded add
    float o[kND][4];
#pragma unroll
    for (int nd = 0; nd < kND; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    if (valid != nullptr && item + (int)gridDim.x < n_items &&
        128 * lane < Sk) {
      // the next item's key mask into L1 while V streams
      const int nb = (item + (int)gridDim.x) / walk.n_qt / H;
      prefetch_l1(valid + (long long)nb * Sk + 128 * lane);
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const Op* vs = take(2);
      if (!active) continue;
      float p[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kNT * kt + nt < n8) e = sc[(kNT * kt + nt) * 32 + lane];
        p[nt][0] = e.x * inv[0];
        p[nt][1] = e.y * inv[0];
        p[nt][2] = e.z * inv[1];
        p[nt][3] = e.w * inv[1];
      }
      if constexpr (BF16OPS) {
        uint32_t pa[kNT / 2][4];
#pragma unroll
        for (int c = 0; c < kNT / 2; ++c) {
          pa[c][0] = pack_bf16(p[2 * c][0], p[2 * c][1]);
          pa[c][1] = pack_bf16(p[2 * c][2], p[2 * c][3]);
          pa[c][2] = pack_bf16(p[2 * c + 1][0], p[2 * c + 1][1]);
          pa[c][3] = pack_bf16(p[2 * c + 1][2], p[2 * c + 1][3]);
        }
        // V fragments by ldmatrix.trans, two column tiles a load
        const int vr = (lane & 7) + ((lane >> 3) & 1) * 8;
        const int vc = (lane >> 4) * 8;
#pragma unroll
        for (int nd = 0; nd < kND; nd += 2) {
          float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < kNT / 2; ++c) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, vs + (16 * c + vr) * R::kVStr + 8 * nd + vc);
            const uint32_t b0[2] = {r[0], r[1]};
            const uint32_t b1[2] = {r[2], r[3]};
            mma_bf16(a0, pa[c], b0);
            mma_bf16(a1, pa[c], b1);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[nd][e] += a0[e];
            o[nd + 1][e] += a1[e];
          }
        }
      } else {
        // keys permuted as in p_times_v(): k = t <-> key 2t, t + 4 <-> 2t + 1
        uint32_t pb[kNT][4];
#pragma unroll
        for (int kc = 0; kc < kNT; ++kc) {
          pb[kc][0] = tf32_rne(p[kc][0]);
          pb[kc][1] = tf32_rne(p[kc][2]);
          pb[kc][2] = tf32_rne(p[kc][1]);
          pb[kc][3] = tf32_rne(p[kc][3]);
        }
        if constexpr (R::kWG) {
          // o += P.V over the warpgroup, a k-step 8 keys (32 bytes) of the
          // transposed V's rows; the sums stay in the tensor cores'
          // accumulators across the key tiles
          float (&d)[4 * kND] = *reinterpret_cast<float(*)[4 * kND]>(&o[0][0]);
          const char* vt = reinterpret_cast<const char*>(vs);
          wgmma_fence();
#pragma unroll
          for (int kc = 0; kc < kNT; ++kc)
            wgmma_tf32(d, pb[kc], smem_desc_sw128(vt + 32 * kc, 1024), 1);
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int i = 0; i < 4 * kND; ++i) reg_fence(d[i]);
#pragma unroll
          for (int kc = 0; kc < kNT; ++kc)
#pragma unroll
            for (int i = 0; i < 4; ++i) reg_fence(pb[kc][i]);
        } else {
          const uint32_t* vb = reinterpret_cast<const uint32_t*>(vs);
#pragma unroll
          for (int nd = 0; nd < kND; ++nd) {
            float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kc = 0; kc < kNT; ++kc) {
              const uint32_t* v0 = vb + (8 * kc + 2 * t4) * R::kVStr + g + 8 * nd;
              const uint32_t bf[2] = {v0[0], v0[R::kVStr]};
              mma_tf32(a, pb[kc], bf);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) o[nd][e] += a[e];
          }
        }
      }
    }

    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        if (row >= Sq) continue;
        float* orow = out + b * so.b + h * so.h + (long long)row * so.r;
#pragma unroll
        for (int nd = 0; nd < kND; ++nd) {
          const int col = 8 * nd + 2 * t4;
          if (col < Dh) {
            orow[col] = o[nd][2 * r];
            orow[col + 1] = o[nd][2 * r + 1];
          }
        }
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

// cuTensorMapEncodeTiled from the driver, through the runtime (no link to
// the driver library); null where the driver lacks it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const bool ok = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault,
                                            &found) == cudaSuccess &&
                    found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// the tensor map of an f32 operand [B, H, S, Dh] (strides in elements): dim
// 0 is Dh, dims 1-3 are rows, heads and examples in order of their strides
// (a dim of one element placed last), boxes of DHP columns x 32 rows,
// zeros outside the tensor; false where the driver refuses it
bool red_map(CUtensorMap* tm, RedDims* d, const void* p, int B, int H, int S,
             int Dh, Strides st, int dhp) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  struct Dim {
    long long stride;
    int n, which;  // which: 0 rows, 1 heads, 2 examples
  } e[3] = {{st.r, S, 0}, {st.h, H, 1}, {st.b, B, 2}};
  long long span = 0;
  for (const Dim& x : e)
    if (x.n > 1) span = std::max(span, x.stride * x.n);
  for (Dim& x : e)
    if (x.n == 1) x.stride = std::max(span, (long long)Dh);
  std::sort(e, e + 3, [](const Dim& a, const Dim& b) {
    return a.stride < b.stride;
  });
  cuuint64_t dims[4] = {(cuuint64_t)Dh, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)dhp, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)e[i].n;
    strides[i] = (cuuint64_t)e[i].stride * sizeof(float);
    if (e[i].which == 0) {
      box[i + 1] = 32;
      d->row = i + 1;
    } else if (e[i].which == 1) {
      d->head = i + 1;
    } else {
      d->ex = i + 1;
    }
  }
  return encode(tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(p),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// flash_reduced_kernel on a persistent grid (as many blocks as fit on the
// card at once, at most one an item), or kLongRows where it does not take
// the call: rows whose scores leave no room for two landing slots in the
// shared memory a block may use, operands the copy engine cannot address
// (rows not 16-byte aligned, or a tensor map the driver refuses), or more
// tiles than an int counts
constexpr int kLongRows = -1;

// what the reduced launches read of the current device, asked once a device
struct DeviceFacts {
  int optin, per_sm_bytes, reserved, n_sm;
};

cudaError_t device_facts(DeviceFacts& f) {
  static std::mutex mu;
  static std::map<int, DeviceFacts> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(dev);
  if (it == known.end()) {
    DeviceFacts d;
    err = cudaDeviceGetAttribute(&d.optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.per_sm_bytes, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &d.reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&d.n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return err;
    it = known.emplace(dev, d).first;
  }
  f = it->second;
  return cudaSuccess;
}

// blocks an SM of `kernel` at `smem` bytes, asked once for each kernel, size
// and device; the first ask for a kernel lifts its dynamic shared memory cap
// to the block's limit
template <typename Kernel>
cudaError_t blocks_per_sm(Kernel kernel, int threads, size_t smem, int optin,
                          int& per_sm) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, size_t, int>, int> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const auto key = std::make_tuple((const void*)kernel, smem, dev);
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it == known.end()) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    it = known.emplace(key, per_sm).first;
  }
  per_sm = it->second;
  return cudaSuccess;
}

template <bool BF16OPS, int DHP>
int launch_reduced(const void* q, const void* k, const void* v,
                   const void* valid, void* out, int B, int H, int Sq, int Sk,
                   int Dh, Strides sq, Strides sk, Strides sv, Strides so,
                   float sm_scale, int vec, cudaStream_t stream) {
  using R = Red<BF16OPS, DHP>;
  DeviceFacts dev;
  cudaError_t err = device_facts(dev);
  if (err != cudaSuccess) return (int)err;
  if (vec != 16) return kLongRows;
  // landing slots: as many as fit (up to kMaxStages) beside two blocks an
  // SM, else beside one; at least two
  const size_t need = R::smem_bytes(Sk, 0);
  int stages = 0, blocks = 2;
  for (; blocks >= 1; --blocks) {
    const size_t budget = std::min(
        (size_t)dev.optin, (size_t)(dev.per_sm_bytes / blocks - dev.reserved));
    stages = budget > need
                 ? (int)std::min((budget - need) / R::kStageBytes,
                                 (size_t)R::kMaxStages)
                 : 0;
    if (stages >= 2) break;
  }
  if (stages < 2) return kLongRows;
  const long long n_items = (long long)B * H * ((Sq + 63) / 64);
  const long long per_item = 2 + 2 * ((Sk + R::kBK - 1) / R::kBK);
  CUtensorMap tq, tk, tv;
  RedDims dq, dk, dv;
  if (!red_map(&tq, &dq, q, B, H, Sq, Dh, sq, DHP) ||
      !red_map(&tk, &dk, k, B, H, Sk, Dh, sk, DHP) ||
      !red_map(&tv, &dv, v, B, H, Sk, Dh, sv, DHP))
    return kLongRows;
  // registers budgeted for two blocks an SM where shared memory holds two,
  // but for TF32 at DHP = 128, whose Q fragments and accumulators would
  // spill (up to DHP = 64 both arms fit the two-block budget anyway)
  auto kernel = flash_reduced_kernel<BF16OPS, DHP, DHP < 128 ? 2 : 1>;
  if constexpr (DHP == 128 && BF16OPS)
    if (blocks == 2) kernel = flash_reduced_kernel<BF16OPS, DHP, 2>;
  const size_t smem = R::smem_bytes(Sk, stages);
  int per_sm = 0;
  err = blocks_per_sm(kernel, R::kThreads, smem, dev.optin, per_sm);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long grid = std::min(n_items, (long long)per_sm * dev.n_sm);
  if (n_items + grid > INT_MAX ||
      (n_items + grid - 1) / grid * per_item > INT_MAX)
    return kLongRows;
  kernel<<<(unsigned)grid, R::kThreads, smem, stream>>>(
      tq, tk, tv, dq, dk, dv, static_cast<const unsigned char*>(valid),
      static_cast<float*>(out), H, Sq, Sk, Dh, so, sm_scale, (int)n_items,
      stages);
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
    if (arm == kArmTf32 || arm == kArmBf16Ops) {
      const bool bf = arm == kArmBf16Ops;
      const int err =
          bf ? launch_reduced<true, DHP>(q, k, v, valid, out, B, H, Sq, Sk,
                                         Dh, sq, sk, sv, so, sm_scale, vec,
                                         stream)
             : launch_reduced<false, DHP>(q, k, v, valid, out, B, H, Sq, Sk,
                                          Dh, sq, sk, sv, so, sm_scale, vec,
                                          stream);
      if (err != kLongRows) return err;
      auto long_rows = bf ? &flash_reduced_long_kernel<true, DHP>
                          : &flash_reduced_long_kernel<false, DHP>;
      return launch<T>(long_rows, smem, q, k, v, valid, out, B, H, Sq, Sk,
                       Dh, sq, sk, sv, so, sm_scale, vec, stream);
    }
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
