// Whole post-norm U-Net-skip decoder stack of the MLD VAE, as one C entry
// point that launches a fixed sequence of kernels on the caller's stream, on
// Hopper's tensor cores (sm_90a).
//
// Replaces: mld_tpu/ops/fused_seq_decoder.py:_decoder_kernel (called from
// fused_skip_decoder, l.204; pallas_call l.284).
//
// What it computes, for L = 2n+1 layers over B sequences of T frame queries of
// width D, cross-attending M <= 8 latent tokens per sequence:
//   output block i first merges the popped skip: x = x@Wsx + skip@Wss + bs;
//   self-attention: qkv = x@Wqkv + b; per head softmax(q.k / sqrt(Dh)) over
//     the sequence's valid frames (key 0 always attended, so padded query rows
//     and empty sequences stay finite); x = LN1(x + attn@Wo + bo);
//   cross-attention to the M latent tokens: x = LN2(x + cross@Wo_x + bo_x);
//   FFN: x = LN3(x + gelu(x@W1 + b1)@W2 + b2), exact erf GELU;
//   input block i pushes x onto the skip stack.
// LayerNorm eps is 1e-5 everywhere. The final norm runs outside, as on the TPU.
//
// What bounds it on this card: at the flagship shapes (B=128, T=196, D=256,
// H=4, F=1024, L=9) the stack is ~382 GFLOP of weight products a call over
// R = B*T = 25,088 rows, and ~23 GFLOP of self-attention. In f32 the weight
// products run as three TF32 products (2.3 ms at 495 / 3 TFLOP/s), in bf16 as
// bf16 products (0.39 ms at 989 TFLOP/s). The activations do not fit on chip
// (the skip stack alone is 4 x 25.7 MB in f32, where the TPU kernel kept a
// tile of 4 sequences and its skip stack in VMEM), so the phases of a layer
// pass ~0.6 GB a layer through device memory (~1.6 ms a call at 3.35 TB/s),
// and every 64-row tile reads its weights again from L2 (~23 GB a call in
// f32 with the split weights, ~6 GB in bf16).
//
// What the design does about it:
//  * Each phase of a layer is one kernel over all rows, on one stream: the
//    TPU's sequential layer grid becomes the order of launches. Activations,
//    the skip stack and the temporaries live in a workspace in device memory
//    that the wrapper allocates.
//  * Weight products are one GEMM kernel on wgmma: a block computes 64 rows x
//    256 columns, each of its two warpgroups 64 x 128 (m64n128), with A from
//    registers and W from shared memory through descriptors. The weights are
//    stored [N, K] (torch's Linear layout) and cut, when stacked
//    (ops/fused_seq_decoder.py:tile_weights), into 8 KB tiles of 64 rows x
//    128 bytes already in wgmma's 128-byte swizzle (without it the 8 rows the
//    tensor cores read together share their banks: twice the time), so that
//    one bulk copy (cp.async.bulk, completing on an mbarrier) brings each
//    tile in as the tensor cores read it; A comes by cp.async, 16 bytes a
//    thread. A ring of 3 stages (f32) or 2 (bf16, two blocks an SM).
//  * f32 weights: m64n128k8 TF32, x = big + small with big rounded to TF32
//    (csrc/mma_sm90.cuh:split_tf32), a.w ~ big.big + small.big + big.small:
//    the counterpart of the TPU kernel's Precision.HIGHEST. The weights'
//    halves are split when stacked (wgmma reads them from shared memory
//    as they lie), the activations' in registers. A single TF32 pass misses
//    the 1e-4 bar, the split holds it
//    (tests/test_torch_tf32_split.py::test_decoder_stack_bar).
//    bf16 weights: m64n128k16 bf16, the activation operand rounded to bf16 as
//    the fragment is formed (the TPU kernel's a.astype(w.dtype)).
//  * The tensor cores sum into f32 accumulators without rounding to nearest,
//    and over K = 1024 the f32 arm's error grew several-fold with one
//    accumulator. There each stage's products (12 wgmma) go into fresh
//    accumulators, which a rounded f32 add folds into the running sum; the
//    bf16 arm's error is its rounding, so its sums run straight, which frees
//    the registers for two blocks an SM.
//  * Epilogues are fused and staged through the ring, which is free after
//    the last stage: bias, exact erf GELU, or residual + LayerNorm over the
//    whole 256-wide row (a block holds whole rows; a row's sums go across the
//    two warpgroups through shared memory) and at M = 1 the second LayerNorm
//    of the cross-attention too (below). The residual's rows come in and the
//    output's rows go out by bulk copies, one a row: writing 8-byte pieces
//    from the fragments, and loading the residual and bias beside them, was
//    the GEMMs' largest cost.
//  * Self-attention is K3 (csrc/flash_attention.cu, its launcher
//    mld_flash_forward, linked into the same library): it reads q, k and v
//    through strides from the packed [R, 3D] projection, computes f32 scores
//    and P.V on the tensor cores (3xTF32) and writes [R, D] for the
//    out-projection. Its key mask is the frame mask with key 0 set, built
//    once a call by a small kernel.
//  * Cross-attention at M = 1: the one real key gets probability exactly 1
//    (the TPU's 7 padded keys are at -1e9 and exp to exactly 0), so every
//    query row's cross-attention output is its sequence's value row, and its
//    out-projection is one row per sequence, c[b]. Those two small products
//    come first in a layer, and the out-projection's epilogue of the
//    self-attention then computes x = LN2(LN1(x + attn@Wo + bo) + c[b]):
//    the TPU kernel's arithmetic, with T-fold fewer products and no pass of
//    its own. For 1 < M <= 8 the general path computes q, K/V and a softmax
//    over the M keys (one warp a row and head, f32).
//  * bf16 weights: the buffers that are only ever operands of bf16 products
//    (the FFN hidden layer and the skip stack) are stored in bf16, which is
//    exact against the plain version (it rounds them there anyway) and halves
//    their traffic. qkv, the attention output and the residual stream stay
//    f32; attention scores and P.V are f32 (HIGHEST on the TPU).
// Kernel launches a call: 1 + L * 7 + n at M = 1, 1 + L * 9 + n otherwise
// (68 and 86 for the flagship stack).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "mma_sm90.cuh"

// K3's launcher (csrc/flash_attention.cu), in the same library
extern "C" int mld_flash_forward(const void* q, const void* k, const void* v,
                                 const void* valid, void* out, int B, int H, int Sq,
                                 int Sk, int Dh, long long q_sb, long long q_sh,
                                 long long q_sr, long long k_sb, long long k_sh,
                                 long long k_sr, long long v_sb, long long v_sh,
                                 long long v_sr, long long o_sb, long long o_sh,
                                 long long o_sr, float sm_scale, int arm, void* stream);

namespace {

using namespace mma_sm90;

constexpr int kThreads = 256;  // 2 warpgroups, each 64 rows x 128 columns
constexpr int kBM = 64;        // rows a block
constexpr int kBN = 256;       // columns a block: a whole D-wide row for LayerNorm
constexpr int kWN = 128;       // columns a warpgroup
constexpr uint32_t kSBO = 1024;  // W in shared memory: 8 rows of 128 bytes an atom
constexpr int kChunkRows = 64;   // W arrives in chunks of 64 rows x 128 bytes
constexpr int kChunkBytes = kChunkRows * 128;
constexpr int kOutStr = kBN + 8;  // staged output rows (elements): conflict-free float2s
constexpr float kLnEps = 1e-5f;

// tile geometry by weight type: a stage is 128 bytes of each W row, 4 wgmma
// k-steps of 32 bytes
template <typename W>
struct Tile {
  static constexpr bool kF32 = sizeof(W) == 4;
  // f32: 3 stages fill an SM; bf16: two blocks an SM of 2 stages each, so
  // that one block's epilogue overlaps the other's products
  static constexpr int kStages = kF32 ? 3 : 2;
  static constexpr int kBlocks = kF32 ? 1 : 2;
  static constexpr int kBK = 128 / (int)sizeof(W);
  // A row stride (elements): f32 read as words in the f32 arm (4 mod 32
  // banks) and as float2s in the bf16 arm (8 mod 32), bf16 as words
  static constexpr int kAStr = kF32 ? kBK + 4 : kBK + 8;
  static constexpr int kABytes = kBM * kAStr * 4;  // sized for f32 A
  static constexpr int kWBytes = kBN * 128;
  static constexpr int kWTiles = kF32 ? 2 : 1;     // f32 weights: big, small
  static constexpr int kStageBytes = kABytes + kWTiles * kWBytes;
  // the ring, the LayerNorm's row sums [2][kBM][2 warpgroups], the
  // epilogue's vectors [5][kBN] (bias, gamma, beta, gamma2, beta2), and
  // barriers: one a slot for its weights' bulk copies, one for the residual
  static constexpr int kRedBytes = 2 * kBM * 2 * 4;
  static constexpr int kVecBytes = 5 * kBN * 4;
  static constexpr int kSmem = kStages * kStageBytes + kRedBytes + kVecBytes + (kStages + 1) * 8;
};

enum Epilogue { kStore = 0, kGelu = 1, kLN = 2 };

struct GemmArgs {
  // A = [a | a2] along the reduction: a [M, K1] (row stride lda), a2 [M, K2]
  // (lda2; K2 = 0: none), each f32 or, with a*_bf16, bf16
  const void* a;
  const void* a2;
  int lda, lda2, a_bf16, a2_bf16, K1, K2;
  // W [N, K1 + K2] in the weight dtype, tiled (ops/fused_seq_decoder.py:
  // tile_weights): chunk (N / 64, K / 128 bytes) of 64 rows x 128 bytes in
  // wgmma's 128-byte swizzle, 8 KB each, row chunks outermost; f32 weights
  // as big (TF32) and small (the rest) matrices of that shape
  const void* w;
  const void* w_small;
  const float* bias;  // [N] or null
  void* out;          // [M, N], row stride ldo; bf16 if out_bf16 (kStore, kGelu)
  int ldo, out_bf16, M, N;
  int scale_cols;     // kStore: columns n < scale_cols are scaled after the bias
  float scale;
  // kLN: out = LN(res + acc + bias; gamma, beta), then, with rowc,
  // out = LN(out + rowc[m / rows_c]; gamma2, beta2); out is f32 and may alias
  // res (row stride ldo); out2, if set, takes a bf16 copy of out
  const float* res;
  const float* gamma;
  const float* beta;
  const float* rowc;
  int rows_c;
  const float* gamma2;
  const float* beta2;
  __nv_bfloat16* out2;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// In-place LayerNorm of the block's rows, held in the warpgroups'
// accumulators: v[4j + 2h + e] is row 16 w4 + 8 h + g, column 128 wg + 8 j +
// 2 t + e. Columns >= N hold 0 and stay out of the statistics. A row's sums
// go across the two warpgroups through red ([2][kBM][2] floats).
__device__ __forceinline__ void rows_layernorm(float (&v)[64], int N,
                                               const float* __restrict__ gamma,
                                               const float* __restrict__ beta,
                                               float* red, int w4, int wg, int g,
                                               int t) {
  const int col0 = kWN * wg + 2 * t;
  float mu[2], rstd[2];
  for (int pass = 0; pass < 2; ++pass) {
    float* buf = red + pass * kBM * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = v[4 * j + 2 * h + e];
          if (pass == 0) {
            s += x;
          } else if (col0 + 8 * j + e < N) {
            const float d = x - mu[h];
            s += d * d;
          }
        }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t == 0) buf[(16 * w4 + 8 * h + g) * 2 + wg] = s;
    }
    __syncthreads();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 r = *reinterpret_cast<const float2*>(buf + (16 * w4 + 8 * h + g) * 2);
      const float tot = (r.x + r.y) / N;
      if (pass == 0)
        mu[h] = tot;
      else
        rstd[h] = rsqrtf(tot + kLnEps);
    }
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      const float ga = col < N ? gamma[col] : 0.f;
      const float be = col < N ? beta[col] : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& x = v[4 * j + 2 * h + e];
        x = (x - mu[h]) * rstd[h] * ga + be;
      }
    }
}

// out[m, n] = epilogue(sum_k A[m, k] W[n, k] + bias[n]) over a 64 x 256 tile:
// warpgroup wg multiplies the 64 rows by W rows 128 wg .. + 127 with wgmma,
// A from registers, W from the ring through descriptors.
template <typename W, int EPI>
__global__ void __launch_bounds__(kThreads, Tile<W>::kBlocks) gemm_kernel(const GemmArgs g) {
  using Tl = Tile<W>;
  constexpr int kBK = Tl::kBK;
  constexpr int kS = Tl::kStages;
  extern __shared__ __align__(1024) float4 smem_f4[];  // swizzle atoms are 1 KB
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f4);
  float* red = reinterpret_cast<float*>(smem + kS * Tl::kStageBytes);
  float* vec = reinterpret_cast<float*>(smem + kS * Tl::kStageBytes + Tl::kRedBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(vec) +
                                               Tl::kVecBytes);  // [kS + 1]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gq = lane >> 2;  // fragment row
  const int tq = lane & 3;   // thread in its group of four
  const int wg = warp >> 2;  // warpgroup: columns 128 wg .. + 127
  const int w4 = warp & 3;   // rows 16 w4 .. + 15 of the tile
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int K = g.K1 + g.K2;
  const int ktiles = K / kBK;
  const int wchunks = min(kBN, g.N - n0) / kChunkRows;  // W chunks of this block

  // reduction tile kt into ring slot s: its A rows (zeros past M) in their
  // source type, 16 bytes a copy by every thread; its W rows by one thread,
  // one bulk copy a chunk, counted on the slot's barrier (rows past N are
  // left as they are: their output columns are never stored)
  auto load_stage = [&](int kt, int s) {
    unsigned char* as = smem + s * Tl::kStageBytes;
    const int k0 = kt * kBK;
    const bool second = k0 >= g.K1;
    const int ka = second ? k0 - g.K1 : k0;
    const int ld = second ? g.lda2 : g.lda;
    if (second ? g.a2_bf16 : g.a_bf16) {
      constexpr int kPer = kBK / 8;
      const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(second ? g.a2 : g.a);
      for (int c = tid; c < kBM * kPer; c += kThreads) {
        const int r = c / kPer;
        const int e = (c - r * kPer) * 8;
        const bool ok = m0 + r < g.M;
        copy_async<16>(reinterpret_cast<__nv_bfloat16*>(as) + r * Tl::kAStr + e,
                       src + (size_t)(ok ? m0 + r : 0) * ld + ka + e, ok);
      }
    } else {
      constexpr int kPer = kBK / 4;
      const float* src = static_cast<const float*>(second ? g.a2 : g.a);
      for (int c = tid; c < kBM * kPer; c += kThreads) {
        const int r = c / kPer;
        const int e = (c - r * kPer) * 4;
        const bool ok = m0 + r < g.M;
        copy_async<16>(reinterpret_cast<float*>(as) + r * Tl::kAStr + e,
                       src + (size_t)(ok ? m0 + r : 0) * ld + ka + e, ok);
      }
    }
    if (tid == 0) {
      mbar_expect_bytes(&full[s], Tl::kWTiles * wchunks * kChunkBytes);
#pragma unroll
      for (int h = 0; h < Tl::kWTiles; ++h) {
        const unsigned char* src = static_cast<const unsigned char*>(h ? g.w_small : g.w);
        for (int c = 0; c < wchunks; ++c)
          bulk_copy(as + Tl::kABytes + h * Tl::kWBytes + c * kChunkBytes,
                    src + ((size_t)(n0 / kChunkRows + c) * ktiles + kt) * kChunkBytes,
                    kChunkBytes, &full[s]);
      }
    }
  };

  float acc[64];  // the running sums
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (tid == 0) {
    for (int s = 0; s <= kS; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // the epilogue's vectors over this block's columns, with the first stage
  {
    const int cols = min(kBN, g.N - n0);
    for (int c = tid; c < 5 * (kBN / 4); c += kThreads) {
      const int v = c / (kBN / 4);
      const int e = (c - v * (kBN / 4)) * 4;
      const float* src = v == 0   ? g.bias
                         : v == 1 ? g.gamma
                         : v == 2 ? g.beta
                         : v == 3 ? g.gamma2
                                  : g.beta2;
      const bool ok = src != nullptr && e < cols;
      copy_async<16>(vec + v * kBN + e, ok ? src + n0 + e : static_cast<const float*>(g.w), ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kS - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    copy_commit();
  }
  const int ar = 16 * w4 + gq;  // this thread's A rows: ar, ar + 8
  for (int kt = 0; kt < ktiles; ++kt) {
    copy_wait<kS - 2>();                    // tile kt's A rows have landed
    mbar_wait(&full[kt % kS], (kt / kS) & 1);  // and its W rows
    __syncthreads();  // every warp is done with the slot refilled next
    if (kt + kS - 1 < ktiles) load_stage(kt + kS - 1, (kt + kS - 1) % kS);
    copy_commit();
    const unsigned char* as = smem + (kt % kS) * Tl::kStageBytes;
    const unsigned char* ws = as + Tl::kABytes + wg * (kWN / 8) * kSBO;
    if constexpr (Tl::kF32) {
      // TF32 A fragments, split x = big + small: a0 (r, t), a1 (r + 8, t),
      // a2 (r, t + 4), a3 (r + 8, t + 4) of each 8-wide k-step. The stage's
      // tensor-core sums go to part, folded into acc by rounded f32 adds
      const float* a = reinterpret_cast<const float*>(as);
      float part[64] = {};
      uint32_t ab[4][4], asm_[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* r0 = a + ar * Tl::kAStr + 8 * kk + tq;
        const float* r1 = r0 + 8 * Tl::kAStr;
        split_tf32(r0[0], ab[kk][0], asm_[kk][0]);
        split_tf32(r1[0], ab[kk][1], asm_[kk][1]);
        split_tf32(r0[4], ab[kk][2], asm_[kk][2]);
        split_tf32(r1[4], ab[kk][3], asm_[kk][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = smem_desc_sw128(ws + kk * 32, kSBO);
        const uint64_t ds = smem_desc_sw128(ws + Tl::kWBytes + kk * 32, kSBO);
        wgmma_tf32(part, asm_[kk], db, kk > 0);
        wgmma_tf32(part, ab[kk], ds, 1);
        wgmma_tf32(part, ab[kk], db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          reg_fence(ab[kk][i]);
          reg_fence(asm_[kk][i]);
        }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        reg_fence(part[i]);
        acc[i] += part[i];
      }
    } else {
      // bf16 A fragments: a0 (r, 2t..), a1 (r + 8, 2t..), a2 (r, 2t + 8..),
      // a3 (r + 8, 2t + 8..) of each 16-wide k-step; f32 A rounded here.
      // The sums go straight into acc
      uint32_t af[4][4];
      if ((kt * kBK >= g.K1) ? g.a2_bf16 : g.a_bf16) {
        const __nv_bfloat16* a = reinterpret_cast<const __nv_bfloat16*>(as);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const __nv_bfloat16* r0 = a + ar * Tl::kAStr + 16 * kk + 2 * tq;
          const __nv_bfloat16* r1 = r0 + 8 * Tl::kAStr;
          af[kk][0] = ld_u32(r0);
          af[kk][1] = ld_u32(r1);
          af[kk][2] = ld_u32(r0 + 8);
          af[kk][3] = ld_u32(r1 + 8);
        }
      } else {
        const float* a = reinterpret_cast<const float*>(as);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* r0 = a + ar * Tl::kAStr + 16 * kk + 2 * tq;
          const float* r1 = r0 + 8 * Tl::kAStr;
          const float2 x0 = *reinterpret_cast<const float2*>(r0);
          const float2 x1 = *reinterpret_cast<const float2*>(r1);
          const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
          const float2 x3 = *reinterpret_cast<const float2*>(r1 + 8);
          af[kk][0] = pack_bf16(x0.x, x0.y);
          af[kk][1] = pack_bf16(x1.x, x1.y);
          af[kk][2] = pack_bf16(x2.x, x2.y);
          af[kk][3] = pack_bf16(x3.x, x3.y);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16(acc, af[kk], smem_desc_sw128(ws + kk * 32, kSBO), 1);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) reg_fence(af[kk][i]);
#pragma unroll
      for (int i = 0; i < 64; ++i) reg_fence(acc[i]);
    }
  }

  // the epilogue, staged through the ring, which is free now: the residual
  // rows come in and the output rows go out by bulk copies, one a row. The
  // thread's elements: acc[4j + 2h + e] at tile row 16 w4 + 8 h + g, column
  // 128 wg + 8 j + 2 t + e
  fence_proxy_async();  // the ring's reads are done before bulk copies refill it
  __syncthreads();      // every warp is done with the ring
  float* stage = reinterpret_cast<float*>(smem);  // f32 [kBM][kOutStr]
  __nv_bfloat16* stage16 = reinterpret_cast<__nv_bfloat16*>(smem + kBM * kOutStr * 4);
  const int rows = min(kBM, g.M - m0);
  const int cols = min(kBN, g.N - n0);
  const int c0 = kWN * wg + 2 * tq;  // the thread's first column in the tile
  if constexpr (EPI == kLN) {
    // v = res + acc + bias over whole rows (n0 = 0, N <= 256); 0 past N
    if (tid == 0) {
      mbar_expect_bytes(&full[kS], rows * cols * 4);
      for (int r = 0; r < rows; ++r)
        bulk_copy(stage + r * kOutStr, g.res + (size_t)(m0 + r) * g.ldo, cols * 4, &full[kS]);
    }
    mbar_wait(&full[kS], 0);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = c0 + 8 * j;
        const bool ok = col < cols;
        const float2 r = *reinterpret_cast<const float2*>(stage + (ar + 8 * h) * kOutStr + col);
        const float2 b = *reinterpret_cast<const float2*>(vec + col);
        acc[4 * j + 2 * h] = ok ? acc[4 * j + 2 * h] + b.x + r.x : 0.f;
        acc[4 * j + 2 * h + 1] = ok ? acc[4 * j + 2 * h + 1] + b.y + r.y : 0.f;
      }
    rows_layernorm(acc, cols, vec + kBN, vec + 2 * kBN, red, w4, wg, gq, tq);
    if (g.rowc != nullptr) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = min(m0 + ar + 8 * h, g.M - 1);
        const float* c = g.rowc + (size_t)(row / g.rows_c) * g.N;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = c0 + 8 * j;
          if (col < cols) {
            const float2 cv = *reinterpret_cast<const float2*>(c + col);
            acc[4 * j + 2 * h] += cv.x;
            acc[4 * j + 2 * h + 1] += cv.y;
          }
        }
      }
      rows_layernorm(acc, cols, vec + 3 * kBN, vec + 4 * kBN, red, w4, wg, gq, tq);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = c0 + 8 * j;
      const float2 b = *reinterpret_cast<const float2*>(vec + col);
      const float sc = n0 + col < g.scale_cols ? g.scale : 1.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float& v0 = acc[4 * j + 2 * h];
        float& v1 = acc[4 * j + 2 * h + 1];
        v0 += b.x;
        v1 += b.y;
        if constexpr (EPI == kGelu) {
          v0 = gelu(v0);
          v1 = gelu(v1);
        } else {
          v0 *= sc;
          v1 *= sc;
        }
      }
    }
  }
  const bool f32_out = EPI == kLN || !g.out_bf16;
  const bool bf16_out = (EPI != kLN && g.out_bf16) || (EPI == kLN && g.out2 != nullptr);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int o = (ar + 8 * h) * kOutStr + c0 + 8 * j;
      const float v0 = acc[4 * j + 2 * h];
      const float v1 = acc[4 * j + 2 * h + 1];
      if (f32_out) *reinterpret_cast<float2*>(stage + o) = make_float2(v0, v1);
      if (bf16_out) *reinterpret_cast<uint32_t*>(stage16 + o) = pack_bf16(v0, v1);
    }
  fence_proxy_async();  // the staged rows are read by the bulk stores
  __syncthreads();
  if (tid < rows) {
    const size_t o = (size_t)(m0 + tid) * g.ldo + n0;
    if (f32_out) bulk_store(static_cast<float*>(g.out) + o, stage + tid * kOutStr, cols * 4);
    if (bf16_out)
      bulk_store(EPI == kLN ? g.out2 + o : static_cast<__nv_bfloat16*>(g.out) + o,
                 stage16 + tid * kOutStr, cols * 2);
    bulk_store_drain();
  }
}

// the self-attention's key mask: the frame mask with key 0 set, as bytes
__global__ void __launch_bounds__(kThreads)
key_mask_kernel(const int* __restrict__ valid, unsigned char* __restrict__ key_ok, int R,
                int T) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < R) key_ok[i] = (i % T == 0 || valid[i] != 0) ? 1 : 0;
}

// -------------------------------------------------------- cross-attention
// General M (1 < M <= 8): one warp per (row, head). q: [B*T, D] pre-scaled;
// kv: [B*M, 2D] (k then v); out: [B*T, D].
__global__ void __launch_bounds__(kThreads)
cross_attention_kernel(const float* __restrict__ q, const float* __restrict__ kv,
                       float* __restrict__ out, int B, int T, int M, int D, int H) {
  const int Dh = D / H;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)B * T * H) return;
  const int h = (int)(warp % H);
  const long long row = warp / H;
  const int b = (int)(row / T);
  const float* qr = q + row * D + h * Dh;
  float sc[8];
  float m = -3.0e38f;
  for (int j = 0; j < M; ++j) {
    const float* kr = kv + ((size_t)b * M + j) * 2 * D + h * Dh;
    float part = 0.f;
    for (int d = lane; d < Dh; d += 32) part = fmaf(qr[d], kr[d], part);
    sc[j] = warp_sum(part);
    m = fmaxf(m, sc[j]);
  }
  float sum = 0.f;
  for (int j = 0; j < M; ++j) {
    sc[j] = expf(sc[j] - m);
    sum += sc[j];
  }
  for (int d = lane; d < Dh; d += 32) {
    float o = 0.f;
    for (int j = 0; j < M; ++j)
      o = fmaf(sc[j] / sum, kv[((size_t)b * M + j) * 2 * D + D + h * Dh + d], o);
    out[row * D + h * Dh + d] = o;
  }
}

// ------------------------------------------------- host side: the launches
struct Weights {
  // matrices [L or n, out, in] in the weight dtype
  const void *wqkv_s, *wo_s, *wqkv_x, *wo_x, *w1, *w2, *ws;
  const float *bqkv_s, *bo_s, *bqkv_x, *bo_x, *ln1s, *ln1b, *ln2s, *ln2b, *ln3s, *ln3b,
      *b1, *b2, *bs;
};

// the workspace, in bytes from its start, each buffer 256-byte aligned
// (ops/fused_seq_decoder.py:workspace_bytes)
struct Layout {
  size_t xa, xb, skips, attn, big, memkv, crossc, key_ok, total;
};

size_t align256(size_t n) { return (n + 255) & ~(size_t)255; }

Layout layout(long long B, long long T, long long M, long long D, long long F,
              long long n_block, bool bf16) {
  const long long R = B * T;
  const long long es = bf16 ? 2 : 4;  // the skip stack's and FFN hidden's element
  Layout l;
  size_t o = 0;
  l.xa = o;
  o += align256(R * D * 4);
  l.xb = o;
  o += align256(R * D * 4);
  l.skips = o;
  o += align256(n_block * R * D * es);
  l.attn = o;
  o += align256(R * D * 4);
  l.big = o;  // qkv [R, 3D] f32, the FFN hidden [R, F] or the cross q [R, D] f32
  o += align256(R * (3 * D * 4 > F * es ? 3 * D * 4 : F * es));
  l.memkv = o;
  o += align256(B * M * 2 * D * 4);
  l.crossc = o;
  o += align256(B * D * 4);
  l.key_ok = o;
  o += align256(R);
  l.total = o;
  return l;
}

// one GEMM launch; returns a cudaError_t
template <typename W, int EPI>
int gemm(const GemmArgs& g, cudaStream_t stream) {
  const int smem = Tile<W>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<W, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + kBN - 1) / kBN);
  gemm_kernel<W, EPI><<<grid, kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

// a weight matrix as the kernels read it: the weights, and for f32 the small
// half (the TF32 rest), which follows the big half of each layer's matrix
struct Mat {
  const void* w;
  const void* small;
};

// rows r0.. of matrix l of a stacked [L, P, rows, cols] weight array (P = 2
// for f32: big then small; 1 for bf16)
template <typename W>
Mat layer_mat(const void* base, int l, int rows, int cols, int r0 = 0) {
  constexpr int P = sizeof(W) == 4 ? 2 : 1;
  const W* m = static_cast<const W*>(base) + (size_t)l * P * rows * cols;
  return {m + (size_t)r0 * cols, P == 2 ? m + (size_t)(rows + r0) * cols : nullptr};
}

// out [M, N] (row stride ldo) = a [M, K] (row stride lda) times w [N, K]
// + bias, all f32 but the weights
GemmArgs gemm_args(const void* a, int lda, Mat w, int K, const float* bias, void* out,
                   int ldo, int M, int N) {
  GemmArgs g = {};
  g.a = a;
  g.lda = lda;
  g.K1 = K;
  g.w = w.w;
  g.w_small = w.small;
  g.bias = bias;
  g.out = out;
  g.ldo = ldo;
  g.M = M;
  g.N = N;
  return g;
}

#define CHECK(expr)           \
  do {                        \
    const int e_ = (expr);    \
    if (e_ != 0) return e_;   \
  } while (0)

// expr is the error of one kernel launch: return it, or count the launch
#define LAUNCHED(expr)        \
  do {                        \
    CHECK(expr);              \
    ++*launched;              \
  } while (0)

template <typename W>
int run(const float* tgt, const float* mem, const int* valid, float* out, const Weights& wt,
        unsigned char* ws, int B, int T, int M, int D, int H, int F, int n_block,
        int* launched, cudaStream_t stream) {
  constexpr bool kBf = sizeof(W) == 2;
  const int R = B * T;
  const int L = 2 * n_block + 1;
  const int D3 = 3 * D;
  const int Dh = D / H;
  const float scale = (float)(1.0 / std::sqrt((double)Dh));
  const size_t RD = (size_t)R * D;
  const Layout lay = layout(B, T, M, D, F, n_block, kBf);
  float* xa = reinterpret_cast<float*>(ws + lay.xa);
  float* xb = reinterpret_cast<float*>(ws + lay.xb);
  W* skips = reinterpret_cast<W*>(ws + lay.skips);
  float* attn = reinterpret_cast<float*>(ws + lay.attn);
  float* qkv = reinterpret_cast<float*>(ws + lay.big);
  W* hidden = reinterpret_cast<W*>(ws + lay.big);
  float* memkv = reinterpret_cast<float*>(ws + lay.memkv);
  float* crossc = reinterpret_cast<float*>(ws + lay.crossc);
  unsigned char* key_ok = ws + lay.key_ok;

  key_mask_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, stream>>>(valid, key_ok, R, T);
  LAUNCHED((int)cudaGetLastError());

  const float* x = tgt;
  for (int l = 0; l < L; ++l) {
    const size_t lD = (size_t)l * D;
    if (l > n_block) {
      // output block i: [x | skip] @ [Wsx; Wss] + bs as one reduction
      const int i = l - n_block - 1;
      float* t = x == xa ? xb : xa;
      GemmArgs g = gemm_args(x, D, layer_mat<W>(wt.ws, i, D, 2 * D), D, wt.bs + (size_t)i * D,
                             t, D, R, D);
      g.a2 = skips + (size_t)(n_block - 1 - i) * RD;
      g.lda2 = D;
      g.a2_bf16 = kBf;
      g.K2 = D;
      LAUNCHED((gemm<W, kStore>(g, stream)));
      x = t;
    }
    float* y = x == xa ? xb : xa;  // this layer's activation buffer

    if (M == 1) {
      // probability 1 on the one key: a sequence's cross-attention output is
      // its value row; c[b] = (mem[b] Wv + bv) Wo_x + bo_x, for LN2 below
      GemmArgs g = gemm_args(mem, D, layer_mat<W>(wt.wqkv_x, l, D3, D, 2 * D), D,
                             wt.bqkv_x + 3 * lD + 2 * D, memkv, D, B, D);
      LAUNCHED((gemm<W, kStore>(g, stream)));
      g = gemm_args(memkv, D, layer_mat<W>(wt.wo_x, l, D, D), D, wt.bo_x + lD, crossc, D, B, D);
      LAUNCHED((gemm<W, kStore>(g, stream)));
    }

    // self-attention: the QKV projection, K3 over its strided heads, and the
    // out-projection + LN1 (+ c[b] and LN2 at M = 1)
    {
      GemmArgs g = gemm_args(x, D, layer_mat<W>(wt.wqkv_s, l, D3, D), D, wt.bqkv_s + 3 * lD,
                             qkv, D3, R, D3);
      LAUNCHED((gemm<W, kStore>(g, stream)));
      LAUNCHED(mld_flash_forward(qkv, qkv + D, qkv + 2 * D, key_ok, attn, B, H, T, T, Dh,
                                 (long long)T * D3, Dh, D3, (long long)T * D3, Dh, D3,
                                 (long long)T * D3, Dh, D3, (long long)T * D, Dh, D, scale,
                                 0 /* 3xTF32 under every precision, as JAX pins HIGHEST */,
                                 stream));
      g = gemm_args(attn, D, layer_mat<W>(wt.wo_s, l, D, D), D, wt.bo_s + lD, y, D, R, D);
      g.res = x;
      g.gamma = wt.ln1s + lD;
      g.beta = wt.ln1b + lD;
      if (M == 1) {
        g.rowc = crossc;
        g.rows_c = T;
        g.gamma2 = wt.ln2s + lD;
        g.beta2 = wt.ln2b + lD;
      }
      LAUNCHED((gemm<W, kLN>(g, stream)));
    }

    if (M > 1) {
      const float* bx = wt.bqkv_x + 3 * lD;
      float* qx = qkv;  // [R, D], pre-scaled
      GemmArgs g = gemm_args(y, D, layer_mat<W>(wt.wqkv_x, l, D3, D), D, bx, qx, D, R, D);
      g.scale_cols = D;
      g.scale = scale;
      LAUNCHED((gemm<W, kStore>(g, stream)));
      g = gemm_args(mem, D, layer_mat<W>(wt.wqkv_x, l, D3, D, D), D, bx + D, memkv, 2 * D,
                    B * M, 2 * D);
      LAUNCHED((gemm<W, kStore>(g, stream)));
      const int blocks = (int)(((long long)R * H * 32 + kThreads - 1) / kThreads);
      cross_attention_kernel<<<blocks, kThreads, 0, stream>>>(qx, memkv, attn, B, T, M, D, H);
      LAUNCHED((int)cudaGetLastError());
      g = gemm_args(attn, D, layer_mat<W>(wt.wo_x, l, D, D), D, wt.bo_x + lD, y, D, R, D);
      g.res = y;
      g.gamma = wt.ln2s + lD;
      g.beta = wt.ln2b + lD;
      LAUNCHED((gemm<W, kLN>(g, stream)));
    }

    // FFN; the layer's output goes to the caller's output, the skip stack
    // (f32 weights) or y, which a bf16 skip stack takes a copy of
    {
      GemmArgs g = gemm_args(y, D, layer_mat<W>(wt.w1, l, F, D), D, wt.b1 + (size_t)l * F,
                             hidden, F, R, F);
      g.out_bf16 = kBf;
      LAUNCHED((gemm<W, kGelu>(g, stream)));
      const bool push = l < n_block;
      float* dst = l == L - 1 ? out
                   : (push && !kBf) ? reinterpret_cast<float*>(skips) + (size_t)l * RD
                                    : y;
      g = gemm_args(hidden, F, layer_mat<W>(wt.w2, l, D, F), F, wt.b2 + lD, dst, D, R, D);
      g.a_bf16 = kBf;
      g.res = y;
      g.gamma = wt.ln3s + lD;
      g.beta = wt.ln3b + lD;
      if (push && kBf) g.out2 = reinterpret_cast<__nv_bfloat16*>(skips) + (size_t)l * RD;
      LAUNCHED((gemm<W, kLN>(g, stream)));
      x = dst;
    }
  }
  return 0;
}

#undef LAUNCHED
#undef CHECK

}  // namespace

extern "C" {

// tgt: f32 [B, T, D] queries; mem: f32 [B, M, D]; valid: int32 [B, T];
// out: f32 [B, T, D]. Matrices are [L or n, out, in] (torch's Linear layout;
// the skip linears [n, D, 2D]) in f32 (weight_bf16 == 0) or bf16
// (weight_bf16 == 1); vectors f32 [L or n, K]. ws: scratch of ws_bytes bytes
// (ops/fused_seq_decoder.py:workspace_bytes). All device pointers on the
// current device. *launched receives the number of kernels launched. Returns
// a cudaError_t (0 on success) after the asynchronous launches.
int mld_skip_decoder_forward(const void* tgt, const void* mem, const void* valid, void* out,
                             const void* wqkv_s, const void* bqkv_s, const void* wo_s,
                             const void* bo_s, const void* wqkv_x, const void* bqkv_x,
                             const void* wo_x, const void* bo_x, const void* ln1s,
                             const void* ln1b, const void* ln2s, const void* ln2b,
                             const void* ln3s, const void* ln3b, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* wsk, const void* bs,
                             void* ws, long long ws_bytes, int B, int T, int M, int D, int H,
                             int F, int n_block, int weight_bf16, int* launched, void* stream) {
  *launched = 0;
  if (B <= 0 || B > 65535 || T <= 0 || M < 1 || M > 8 || D <= 0 || D > kBN || D % 64 != 0 ||
      H <= 0 || D % H != 0 || (D / H) > 128 || (D / H) % 4 != 0 || F <= 0 || F % 64 != 0 ||
      n_block < 0)
    return (int)cudaErrorInvalidValue;
  if ((size_t)ws_bytes < layout(B, T, M, D, F, n_block, weight_bf16 != 0).total)
    return (int)cudaErrorInvalidValue;
  Weights wt;
  wt.wqkv_s = wqkv_s;
  wt.wo_s = wo_s;
  wt.wqkv_x = wqkv_x;
  wt.wo_x = wo_x;
  wt.w1 = w1;
  wt.w2 = w2;
  wt.ws = wsk;
  wt.bqkv_s = static_cast<const float*>(bqkv_s);
  wt.bo_s = static_cast<const float*>(bo_s);
  wt.bqkv_x = static_cast<const float*>(bqkv_x);
  wt.bo_x = static_cast<const float*>(bo_x);
  wt.ln1s = static_cast<const float*>(ln1s);
  wt.ln1b = static_cast<const float*>(ln1b);
  wt.ln2s = static_cast<const float*>(ln2s);
  wt.ln2b = static_cast<const float*>(ln2b);
  wt.ln3s = static_cast<const float*>(ln3s);
  wt.ln3b = static_cast<const float*>(ln3b);
  wt.b1 = static_cast<const float*>(b1);
  wt.b2 = static_cast<const float*>(b2);
  wt.bs = static_cast<const float*>(bs);
  const float* t = static_cast<const float*>(tgt);
  const float* m = static_cast<const float*>(mem);
  const int* v = static_cast<const int*>(valid);
  float* o = static_cast<float*>(out);
  unsigned char* w = static_cast<unsigned char*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bf16)
    return run<__nv_bfloat16>(t, m, v, o, wt, w, B, T, M, D, H, F, n_block, launched, st);
  return run<float>(t, m, v, o, wt, w, B, T, M, D, H, F, n_block, launched, st);
}

}  // extern "C"
