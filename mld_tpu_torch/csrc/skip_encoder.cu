// Whole post-norm U-Net-skip encoder stack of the MLD latent denoiser, in one
// launch, on Hopper's tensor cores (sm_90a).
//
// Replaces: mld_tpu/ops/fused_layer.py:_skip_encoder_kernel (driver
// fused_skip_encoder, l.272; pallas_call l.334). Also covers
// _layer_kernel (fused_encoder_layer_sbd, l.155) as the n_block = 0 case.
//
// What it computes, for L = 2n+1 layers (input_blocks[0..n-1], middle_block,
// output_blocks[0..n-1]) over sequences of S <= 8 tokens of width D:
//   output block i first merges the popped skip: x = x@Wsx + skip@Wss + bs
//   qkv = x@Wqkv + bqkv; per head softmax((q*scale).k) over the S tokens of
//   the sequence; x = LN1(x + attn@Wo + bo); x = LN2(x + gelu(x@W1+b1)@W2+b2)
//   input block i pushes x onto the skip stack.
// The final LayerNorm of the stack runs outside, as on the TPU.
//
// Two arms, chosen by the weights' type, that share the kernel's name
// (skip_encoder_kernel<W>), its entry point and its CUDA-core steps' arithmetic
// (LayerNorm rsqrtf(var + 1e-5), GELU erff, softmax, residuals and the skip
// stack in f32), and nothing of their products.
//
// ---- f32 weights (skip_encoder_kernel<float>, 3xTF32 on mma.sync) ----
// What bounds it on this card: the flagship stack holds 7.6 M matrix
// parameters (30 MB in f32), which every tile of rows must stream from L2
// once per call, while the activations are a few KB. The products are
// 2 x rows x 7.6 M FLOP; the three-pass TF32 split triples them on the
// tensor cores, and mma.sync TF32 runs well below wgmma's 495 TFLOP/s, so
// the arm is bound by the tensor cores' mma.sync rate on the SMs a batch
// occupies and by the L2 reads (tiles x 30 MB).
//
// What the design does about it:
//  * Blocks run in no order, so the TPU's sequential grid over layers becomes
//    a loop over layers inside each block. A tile holds whole sequences (32
//    rows: 10 sequences of 3 tokens), since attention only mixes the S tokens
//    of one sequence; its two m16 tiles share every weight fragment, so 26
//    tiles at B=128 under CFG read 0.78 GB of L2, where the FMA design's
//    6-row tiles read 3.8 GB.
//  * A thread-block cluster of c = 1, 2, 4 or 8 blocks shares a tile: each
//    block multiplies 1/c of every product's output columns, so it streams
//    1/c of the weights, then copies its columns into the other blocks'
//    activations through distributed shared memory (16 bytes a copy); a
//    cluster barrier after each product makes them whole again. LayerNorm,
//    attention and the skip stack run redundantly in each block on identical
//    data. The wrapper picks c so that tiles x c blocks still fit the SMs
//    (c = 8 up to 16 tiles, 160 sequences; 4 at B=128, 26 tiles).
//  * Each weight is used by exactly one warp of one block, once, so weights
//    go from L2 straight into registers: no shared-memory staging and no
//    barrier inside a product. The weights are stored in the order the
//    mma.sync B fragments take them (ops/fused_layer.py:pack_fragments): one
//    16-byte load a lane gives it two k steps of one n-tile, a warp's load is
//    512 contiguous bytes, and each warp keeps kDepth of them in flight (64 KB
//    a block), across the boundaries between its n-tiles.
//  * 16 warps a block deal the n-tiles round; where a block has at most 8
//    n-tiles (D-wide products at c >= 4), 2 or 4 warps share one, each
//    taking a part of K, and add their sums through shared memory, so that
//    no warp idles through the longest product (W2, K = F).
//  * Products are mma.sync m16n8k8 TF32 with the 3xTF32 split (x = big +
//    small, a.b ~ big.big + big.small + small.big, the three in separate f32
//    accumulators so that no product waits for another; within the f32 bar
//    of 1e-4). Activation rows are padded so that the A fragment loads from
//    shared memory are free of bank conflicts. The product loop is one
//    non-inlined function: unrolled for its loads in flight, it would
//    otherwise be copied into every call site.
//  * The tile's activations and the QKV/FFN temporaries live in shared memory
//    across all layers (209 KB at the flagship widths). That leaves no room
//    for the skip stack at 32 rows (4 x 32 KB), so it goes to a scratch
//    buffer in device memory, written and read once a call (128 KB a block,
//    against 7.5 MB of weights).
//
// ---- bf16 weights (skip_encoder_kernel<__nv_bfloat16>, wgmma) ----
// Replaces the f32 arm's design run at bf16 (mma.sync m16n8k16), which
// streamed each product's weights from L2 into registers only once a warp
// reached the product, since every product ended in a cluster barrier: the
// L2 latency sat on the layer chain 44 times a launch at L = 9 (74 at
// L = 15), though no weight depends on the activations (0.47 ms at 256
// sequences on an H100 SXM, 40x the work's least time).
//
// What bounds it on this card: the same stack in bf16 is 15 MB, streamed
// by every tile (at c blocks a tile, 15 / c MB a block) from an L2 that
// holds it; the products are 2 x rows x 7.6 M FLOP at 989 TFLOP/s (12 us
// at 256 sequences). Between them lies a chain of dependent steps, five or
// six a layer (products, exchanges across the cluster, LayerNorm,
// attention), on few warps, so each step's latency is exposed: that chain
// bounds 256 sequences; the weights' stream bounds 1,024 (one block a tile,
// 15 MB a block).
//
// What the design does about it:
//  * The order of every product's weights is fixed (output block's merge,
//    QKV, Wo, W1, W2 a layer), so producer warps walk it from the first
//    layer to the last, bringing 8 KB weight tiles (64 output features x 64
//    k) into a ring of 4-8 shared-memory stages by bulk copies (the TMA
//    unit, cp.async.bulk on an mbarrier): they run ahead across products
//    and layers, and wait only for a stage to be freed. One thread issues a
//    stage in about 700 cycles (its waits and address arithmetic), 23 GB/s
//    a SM whatever the ring's depth, so two warps take every other stage,
//    the ring's depth a multiple of two so that each slot has one producer
//    (the wait on a slot's parity must not run a phase ahead). The two
//    consumer warpgroups wait only on the activations.
//  * Operands swapped, so that 32-row tiles stay full: the weights are
//    wgmma's A (M = 64 output features), the tile's 32 rows its B (N = 32),
//    m64n32k16 with both operands in shared memory (K-major, 128-byte
//    swizzle, both packed so; ops/fused_layer.py:pack_tiles), f32
//    accumulators, one for each of a stage's four k steps, so that four
//    chains of wgmma are in flight (one chain waits out each product's
//    latency, some 230 cycles). A block's output features are whole
//    64-feature tiles, dealt to the two warpgroups in pairs, the ring
//    filled k stage by k stage across a pair, so that both progress
//    together; a warpgroup holds one stage while it issues the next.
//  * The activation operand is rounded to bf16 (round to nearest even)
//    before every product, as the TPU kernel does (a.astype(w.dtype)), so it
//    is kept as bf16 operand panels in shared memory, written where it is
//    made (LayerNorm, attention, GELU, the popped skip); the residual stream
//    and the QKV projection stay f32. The FFN hidden exists only as bf16
//    panels, so 32 rows fit with a 7-stage ring at the flagship widths.
//  * Clusters of c = 1, 2 or 4 blocks split every product's output features
//    as before (c x 64 must divide D and F), and QKV and attention by heads
//    (c divides H): a block computes its heads' q, k and v and their
//    attention, and only the attention output (bf16) crosses the cluster.
//    Each block copies its features into the others through distributed
//    shared memory by st.async, whose bytes complete on the receiver's
//    mbarrier: no fence, no cluster barrier, and the producers never wait
//    for a product. The output block's two skip linears are one product
//    over K = 2D ([x | popped skip]). Every exchanged output lands in a
//    buffer that no step since the receiver's previous exchange touches, so
//    a block one exchange ahead cannot overwrite what another still reads:
//    the attention output goes to the popped skip's panels (popped only
//    before an output block, whose merge is an exchange), and before an
//    output block W2 writes the rows behind the hidden panels, where
//    LayerNorm 2 reads them.
//  * LayerNorm takes four rows a warp at once, its gamma and beta loaded a
//    product ahead; the epilogue's biases load before the tile multiplies.
//  * Both arms: LayerNorm, attention and the skip stack run redundantly in
//    each block of a cluster, on identical data (the bf16 arm's attention
//    only for its heads).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <initializer_list>

#include "mma_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace mma_sm90;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // tile rows: two m16 tiles of the mma
constexpr int kPadX = 8;   // f32 padding of an activation row
constexpr int kDepth = 8;  // fragment loads a warp keeps in flight

// weight rows that one 16-byte fragment load covers (two k steps of the
// mma), by weight type
template <typename W>
struct Frag;
template <>
struct Frag<float> {
  static constexpr int kPair = 16;
};

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

enum Epilogue { kStore = 0, kAdd = 1, kGelu = 2 };

template <typename W>
struct Args {
  const float* x;
  float* out;
  float* skip;  // scratch [grid, n_block, kRows, D]
  const W* wqkv;
  const float* bqkv;
  const W* wo;
  const float* bo;
  const float* ln1s;
  const float* ln1b;
  const W* w1;
  const float* b1;
  const W* w2;
  const float* b2;
  const float* ln2s;
  const float* ln2b;
  const W* wsx;
  const W* wss;
  const float* bs;
  int n_seq, S, D, H, F, n_block, seq_per_block, cluster;
  float scale;
};

// one k pair of the warp's 32 x 8 tile (both m16 tiles against one n-tile):
// a, the tile's activations at the pair's first k (row stride a_str); w,
// the lane's fragments of the n-tile. f32 weights: two m16n8k8 steps of
// 3xTF32, k permuted inside a step (k = t <-> 2t, k = t + 4 <-> 2t + 1) so
// that A comes in float2s; acc[m][0] takes big.big, acc[m][1] small.big,
// acc[m][2] big.small, so that no product waits for another
template <typename W>
__device__ __forceinline__ void pair_product(float (&acc)[2][3][4],
                                             const float* a, int a_str,
                                             const uint4& w, int g, int t);

template <>
__device__ __forceinline__ void pair_product<float>(float (&acc)[2][3][4],
                                                    const float* a, int a_str,
                                                    const uint4& w, int g,
                                                    int t) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    uint32_t bb[2], bs[2];
    split_tf32(__uint_as_float(s ? w.z : w.x), bb[0], bs[0]);
    split_tf32(__uint_as_float(s ? w.w : w.y), bb[1], bs[1]);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* r = a + (16 * m + g) * a_str + 8 * s + 2 * t;
      const float2 lo = *reinterpret_cast<const float2*>(r);
      const float2 hi = *reinterpret_cast<const float2*>(r + 8 * a_str);
      uint32_t ab[4], as[4];
      split_tf32(lo.x, ab[0], as[0]);
      split_tf32(hi.x, ab[1], as[1]);
      split_tf32(lo.y, ab[2], as[2]);
      split_tf32(hi.y, ab[3], as[3]);
      mma_tf32(acc[m][1], as, bb);
      mma_tf32(acc[m][0], ab, bb);
      mma_tf32(acc[m][2], ab, bs);
    }
  }
}

// the finished n-tile: columns n0 .. n0 + 7 of this block's out, (op)= acc +
// bias (the lane's two columns' biases b0, b1)
__device__ __forceinline__ void store_tile(const float (&acc)[2][3][4],
                                           int n0, float b0, float b1,
                                           float* out, int out_str,
                                           Epilogue ep, int g, int t) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2* o = reinterpret_cast<float2*>(out + (16 * m + 8 * h + g) * out_str +
                                            n0 + 2 * t);
      float v0 = acc[m][0][2 * h] + acc[m][1][2 * h] + acc[m][2][2 * h] + b0;
      float v1 =
          acc[m][0][2 * h + 1] + acc[m][1][2 * h + 1] + acc[m][2][2 * h + 1] + b1;
      if (ep == kAdd) {
        const float2 r = *o;
        v0 += r.x;
        v1 += r.y;
      } else if (ep == kGelu) {
        v0 = gelu(v0);
        v1 = gelu(v1);
      }
      *o = make_float2(v0, v1);
    }
}

// out[r, n] (op)= sum_k in[r, k] w[k, n] + bias[n] for the 32 tile rows and
// n < N, w being a [K, N] matrix in fragment order: this block multiplies
// its N / cluster columns, n-tiles dealt round the warps, then copies them
// into every other block of the cluster. Where the block has at most half
// as many n-tiles as warps, 2 or 4 warps share an n-tile, each taking a
// part of K, and add their sums through `part` (shared, 3 kWarps / 4 x 256
// floats). in: shared, row stride in_str; out: shared, row stride out_str,
// not in. Ends with a cluster barrier, after which every block holds the
// whole output. Not inlined: one copy of the loop serves every product.
template <typename W>
__device__ __noinline__ void tile_matmul(const W* w, int rank, int cluster,
                                         const float* __restrict__ in,
                                         int in_str, int K, int N,
                                         const float* __restrict__ bias,
                                         float* out, int out_str, Epilogue ep,
                                         float* part) {
  using Fr = Frag<W>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tiles_n = N / 8;                // n-tiles of the product
  const int tiles_b = tiles_n / cluster;    // of this block
  const int pairs_k = K / Fr::kPair;
  // warps an n-tile, each taking 1/split of K
  const int split = (4 * tiles_b <= kWarps && pairs_k % 4 == 0)   ? 4
                    : (2 * tiles_b <= kWarps && pairs_k % 2 == 0) ? 2
                                                                  : 1;
  const int warps_n = kWarps / split;       // warps along n
  const int wn = warp % warps_n;
  const int wk = warp / warps_n;            // the warp's half of K, if split
  const int mine = wn < tiles_b ? (tiles_b - wn + warps_n - 1) / warps_n : 0;
  const int pairs = pairs_k / split;        // k pairs a warp multiplies
  const int total = mine * pairs;           // (n-tile, k pair) steps of the warp
  // the lane's fragment of n-tile j at k pair p: frag[(p tiles_n + j) 32];
  // the warp's i-th n-tile is j0 + i warps_n, its first k pair wk pairs
  const uint4* frag = reinterpret_cast<const uint4*>(w) + lane +
                      (size_t)wk * pairs * tiles_n * 32;
  in += wk * pairs * Fr::kPair;
  const int j0 = rank * tiles_b + wn;
  int lj = 0, lp = 0;  // the next load: the warp's n-tile lj, k pair lp

  uint4 buf[kDepth];
#pragma unroll
  for (int d = 0; d < kDepth; ++d) {
    if (d < total) {
      buf[d] = load_stream(frag + ((size_t)lp * tiles_n + j0 + lj * warps_n) * 32);
      if (++lp == pairs) {
        lp = 0;
        ++lj;
      }
    }
  }
  float acc[2][3][4] = {};
  float b0 = 0.f, b1 = 0.f;
  int cj = 0, cp = 0;  // the step being multiplied: n-tile cj, k pair cp
  for (int i0 = 0; i0 < total; i0 += kDepth) {
#pragma unroll
    for (int d = 0; d < kDepth; ++d) {
      if (i0 + d < total) {
        const int n0 = 8 * (j0 + cj * warps_n);
        if (cp == 0 && bias != nullptr) {  // in flight while the tile multiplies
          b0 = bias[n0 + 2 * t];
          b1 = bias[n0 + 2 * t + 1];
        }
        pair_product<W>(acc, in + cp * Fr::kPair, in_str, buf[d], g, t);
        if (i0 + d + kDepth < total) {
          buf[d] = load_stream(frag + ((size_t)lp * tiles_n + j0 + lj * warps_n) * 32);
          if (++lp == pairs) {
            lp = 0;
            ++lj;
          }
        }
        if (++cp == pairs && split == 1) {
          store_tile(acc, n0, b0, b1, out, out_str, ep, g, t);
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int k = 0; k < 3; ++k)
              acc[m][k][0] = acc[m][k][1] = acc[m][k][2] = acc[m][k][3] = 0.f;
          cp = 0;
          ++cj;
        }
      }
    }
  }
  if (split > 1) {
    // at most one n-tile a warp here: the other parts' sums join the first's
    if (wk > 0 && mine) {
      float* pw = part + ((wk - 1) * warps_n + wn) * 256 + lane;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pw[(4 * m + i) * 32] = acc[m][0][i] + acc[m][1][i] + acc[m][2][i];
    }
    __syncthreads();
    if (wk == 0 && mine) {
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        if (q >= split) break;
        const float* pw = part + ((q - 1) * warps_n + wn) * 256 + lane;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][0][i] += pw[(4 * m + i) * 32];
      }
      store_tile(acc, 8 * j0, b0, b1, out, out_str, ep, g, t);
    }
  }
  cg::cluster_group cl = cg::this_cluster();
  if (cluster > 1) {
    // this block's columns into the others, 16 bytes a copy, a warp a row
    __syncthreads();
    const int cols = N / cluster;
    const int c0 = rank * cols;
    for (int r = warp; r < kRows; r += kWarps)
      for (int c = 4 * lane; c < cols; c += 128) {
        float* src = out + r * out_str + c0 + c;
        const float4 v = *reinterpret_cast<const float4*>(src);
        for (int p = 1; p < cluster; ++p)
          *reinterpret_cast<float4*>(
              cl.map_shared_rank(src, (rank + p) & (cluster - 1))) = v;
      }
  }
  cl.sync();
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// in-place LayerNorm over the first D columns of shared [rows, str], one
// warp a row
__device__ void tile_layernorm(float* x, int str, int rows, int D,
                               const float* __restrict__ g,
                               const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kWarps) {
    float* row = x + r * str;
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s += row[i];
    const float mu = warp_sum(s) / D;
    float v = 0.f;
    for (int i = lane; i < D; i += 32) {
      const float d = row[i] - mu;
      v += d * d;
    }
    const float rstd = rsqrtf(warp_sum(v) / D + 1e-5f);
    for (int i = lane; i < D; i += 32) row[i] = (row[i] - mu) * rstd * g[i] + b[i];
  }
}

// attention of every tile row over the S tokens of its own sequence.
// qkv: shared [rows, 3D], row stride qs; probs: shared [rows, H, S];
// out: shared [rows, D], row stride os. Dh is a multiple of 4.
__device__ void tile_attention(const float* qkv, int qs, float* probs,
                               float* out, int os, int rows, int S, int D,
                               int H, float scale) {
  const int Dh = D / H;
  for (int idx = threadIdx.x; idx < rows * H * S; idx += kThreads) {
    const int r = idx / (H * S);
    const int h = (idx / S) % H;
    const int j = idx % S;
    const float4* q = reinterpret_cast<const float4*>(qkv + r * qs + h * Dh);
    const float4* k = reinterpret_cast<const float4*>(
        qkv + ((r / S) * S + j) * qs + D + h * Dh);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int d = 0; d < Dh / 4; ++d) {
      const float4 a = q[d], b = k[d];
      s.x = fmaf(a.x, b.x, s.x);
      s.y = fmaf(a.y, b.y, s.y);
      s.z = fmaf(a.z, b.z, s.z);
      s.w = fmaf(a.w, b.w, s.w);
    }
    probs[idx] = ((s.x + s.y) + (s.z + s.w)) * scale;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * H; idx += kThreads) {
    float* p = probs + idx * S;
    float m = p[0];
    for (int j = 1; j < S; ++j) m = fmaxf(m, p[j]);
    float denom = 0.f;
    for (int j = 0; j < S; ++j) {
      p[j] = expf(p[j] - m);
      denom += p[j];
    }
    const float inv = 1.f / denom;
    for (int j = 0; j < S; ++j) p[j] *= inv;
  }
  __syncthreads();
  const int quads = D / 4;
  for (int idx = threadIdx.x; idx < rows * quads; idx += kThreads) {
    const int r = idx / quads;
    const int c = 4 * (idx - r * quads);
    const float* p = probs + (r * H + c / Dh) * S;
    const float* v = qkv + (r / S) * S * qs + 2 * D + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < S; ++j) {
      const float4 vj = *reinterpret_cast<const float4*>(v + j * qs);
      acc.x = fmaf(p[j], vj.x, acc.x);
      acc.y = fmaf(p[j], vj.y, acc.y);
      acc.z = fmaf(p[j], vj.z, acc.z);
      acc.w = fmaf(p[j], vj.w, acc.w);
    }
    *reinterpret_cast<float4*>(out + r * os + c) = acc;
  }
  __syncthreads();
}

// row strides (floats) of the activation buffers: x and t [32, D], big
// [32, max(3D, F)] (QKV or the FFN hidden)
__host__ __device__ inline int x_stride(int D) { return D + kPadX; }
__host__ __device__ inline int big_stride(int D, int F) {
  return (3 * D > F ? 3 * D : F) + kPadX;
}

// x, t, big, the attention probabilities [32, H, S] and the partial sums
// of products whose warps split K
__host__ __device__ inline size_t smem_floats(int D, int F, int H, int S) {
  return (size_t)kRows * (2 * x_stride(D) + big_stride(D, F) + H * S) +
         3 * kWarps / 4 * 256;
}

// rows of the tile between shared [kRows, str] and global [kRows, D]
// (contiguous), 16 bytes a copy
__device__ void copy_rows(float* dst, int dst_str, const float* src,
                          int src_str, int D) {
  const int quads = D / 4;
  for (int e = threadIdx.x; e < kRows * quads; e += kThreads) {
    const int r = e / quads;
    const int c = 4 * (e - r * quads);
    *reinterpret_cast<float4*>(dst + r * dst_str + c) =
        *reinterpret_cast<const float4*>(src + r * src_str + c);
  }
}

// ================================================================ bf16 arm
namespace bf16_arm {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 256;  // two warpgroups: products and the rest
constexpr int kProducers = 2;    // warps feeding the ring, each every other stage
constexpr int kThreads = kConsumers + 32 * kProducers;
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kTileM = 64;                 // output features a wgmma (its M)
constexpr int kTileBytes = kTileM * 128;   // a ring stage: 64 features x 64 k
constexpr int kPanelBytes = kRows * 128;   // an operand's 32 rows x 64 k
constexpr int kMinStages = 4;              // two held by the warpgroups, two filling
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 227 * 1024;
constexpr int kBarConsumers = 1;           // named barrier of the consumers
constexpr uint32_t kSBO = 1024;            // 8 rows of 128 bytes a swizzle atom

// Shared memory, in bytes from a 1 KB-aligned base: the weight ring; the
// operand panels (x's bf16 copy, then the attention output or the popped
// skip); big (the f32 QKV rows, or the FFN hidden's bf16 panels and behind
// them f32 rows: W2's output before an output block); x's f32 rows; the
// attention probabilities; the ring's full and empty barriers and the two
// exchange barriers
struct Layout {
  int ob, big, tail, x, probs, bars, total;
  __host__ __device__ Layout(int D, int F, int H, int S, int stages) {
    const int rows_f32 = kRows * (D + 4) * 4;
    const int qkv = kRows * (3 * D + 4) * 4;
    ob = stages * kTileBytes;
    big = ob + 2 * (D / 64) * kPanelBytes;
    tail = big + (F / 64) * kPanelBytes;
    const int big_bytes = qkv > tail - big + rows_f32 ? qkv : tail - big + rows_f32;
    x = big + ((big_bytes + 1023) & ~1023);
    probs = x + rows_f32;
    bars = probs + ((kRows * H * S * 4 + 15) & ~15);
    total = bars + 8 * (2 * stages + 2);
  }
};

// the deepest ring that fits beside the rest (and the base's alignment), in
// whole rounds of the producers: each slot is then always filled by the same
// producer, in order, so that its wait on the slot's parity cannot run a
// phase ahead
__host__ __device__ inline int ring_stages(int D, int F, int H, int S) {
  int st = (kSmemLimit - 1024 - Layout(D, F, H, S, 0).total) / (kTileBytes + 16);
  st = st > kMaxStages ? kMaxStages : st;
  return st - st % kProducers;
}

__host__ __device__ inline size_t smem_bytes(int D, int F, int H, int S) {
  return 1024 + (size_t)Layout(D, F, H, S, ring_stages(D, F, H, S)).total;
}

// element (r, k) of an operand of 32 rows x K: 64-wide k panels of 32 rows of
// 128 bytes, the 16-byte chunk c of row r stored at chunk c ^ (r % 8)
__device__ __forceinline__ int op_off(int r, int k) {
  return (k >> 6) * kPanelBytes + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) + ((k & 7) << 1);
}

// a load of global memory issued here, in order with the inline assembly
// around it (wgmma, barriers): the compiler would otherwise sink it to its
// first use, after the product, and expose its latency there
__device__ __forceinline__ float load_early(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void sync_consumers() {
  named_barrier(kBarConsumers, kConsumers);
}

// the operand panels written by this thread are visible to wgmma, and every
// consumer's writes to every consumer
__device__ __forceinline__ void publish() {
  fence_proxy_async();
  sync_consumers();
}

// the position in the weight stream: slot and phase of the next stage, and
// how many stages came before it
struct Ring {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, slot;
  unsigned phase;
  int pos;
  __device__ void advance(int n = 1) {
    pos += n;
    for (slot += n; slot >= stages; slot -= stages) phase ^= 1u;
  }
};

// out[r, n] = sum_k in[r, k] W[k, n]: W's 64 x 64 tiles (pack_tiles) in w,
// k past K0 in w2 (the output block's skip linear, [x | skip] . [Wsx; Wss]).
// The N columns are `parts` groups of N / parts (QKV: 3, q k v), and a
// block of the cluster multiplies its 1/c of each (QKV: its heads)
struct Product {
  const bf16* w;
  const bf16* w2;
  int K0, K, N, parts;
  // the 64-feature tile of W that is this block's t-th of T
  __device__ int tile(int t, int T, int rank) const {
    const int per = T / parts;
    return (t / per) * (N / parts / kTileM) + rank * per + t % per;
  }
};

enum Out { kF32 = 0, kGeluBf16 = 1 };

// A producer (the first lane of producer warp `who`): every kProducers-th
// stage of a product, in the consumers' order (a single thread issues a
// stage in about 700 cycles of waits and address arithmetic, 12 bytes a
// cycle; two keep the tensor cores fed). This block's output tiles are its
// 1/c of each part; a pair of them goes k stage by k stage, the pair's two
// tiles side by side
__device__ void produce(const Product& p, Ring& rg, int rank, int cluster, int who) {
  const int T = p.N / (kTileM * cluster);
  const int KS = p.K / 64, KS0 = p.K0 / 64;
  for (int m = 0; m < T; m += 2) {
    const int pair = m + 1 < T ? 2 : 1;
    // the pair's tiles: k stages below KS0 from w, the rest from w2
    const unsigned char* w[2];
    const unsigned char* w2[2];
    for (int h = 0; h < pair; ++h) {
      const size_t mt = p.tile(m + h, T, rank);
      w[h] = reinterpret_cast<const unsigned char*>(p.w) + mt * KS0 * kTileBytes;
      w2[h] = p.w2 == nullptr ? nullptr
                              : reinterpret_cast<const unsigned char*>(p.w2) +
                                    ((long long)mt * (KS - KS0) - KS0) * kTileBytes;
    }
    for (int ks = 0; ks < KS; ++ks)
      for (int h = 0; h < pair; ++h) {
        if ((rg.pos & (kProducers - 1)) == who) {
          const unsigned char* src = (ks < KS0 ? w[h] : w2[h]) + (size_t)ks * kTileBytes;
          mbar_wait(&rg.empty[rg.slot], rg.phase ^ 1u);
          mbar_expect_bytes(&rg.full[rg.slot], (unsigned)kTileBytes);
          bulk_copy(rg.base + rg.slot * kTileBytes, src, kTileBytes, &rg.full[rg.slot]);
        }
        rg.advance();
      }
  }
}

// the finished tile: the sum of acc[0..3][4j + 2h + e] is output feature
// f + 8h of row 8j + 2t + e, whose bias is bias[h]; kF32: out[r, n] = sum +
// bias (+ res[r, n]), rows of stride os; kGeluBf16: gelu(sum + bias)
// rounded into the operand panels hid. The residuals are all read before
// the first store: out may be res, and store-then-load pairs would chain
__device__ __forceinline__ void store_tile(const float (&acc)[4][16], int f, int t,
                                           const float (&bias)[2], Out kind, float* out,
                                           int os, const float* res, unsigned char* hid) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = ((acc[0][i] + acc[1][i]) + (acc[2][i] + acc[3][i])) + bias[(i >> 1) & 1];
  // v[4j + 2h + e]: row 8j + 2t + e, feature f + 8h
  if (kind == kGeluBf16) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = 8 * (i >> 2) + 2 * t + (i & 1), n = f + 8 * ((i >> 1) & 1);
      *reinterpret_cast<bf16*>(hid + op_off(r, n)) = __float2bfloat16_rn(gelu(v[i]));
    }
    return;
  }
  if (res != nullptr) {
    float rv[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      rv[i] = res[(8 * (i >> 2) + 2 * t + (i & 1)) * os + f + 8 * ((i >> 1) & 1)];
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] += rv[i];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[(8 * (i >> 2) + 2 * t + (i & 1)) * os + f + 8 * ((i >> 1) & 1)] = v[i];
}

// The consumers: this block's output features of one product for the 32
// rows, in: operand panels [32 x K]. Warpgroup wg multiplies tile m + wg of
// each pair (whose k stage ks is the ring's stage 2 ks + wg of the pair, or
// ks alone), holding one stage while the next is issued, and stores it. The
// four k steps of a stage go to four accumulators, so that four chains of
// wgmma are in flight, not one. The accumulators must stay in registers:
// handed by reference to a function that is not inlined (store_tile, or
// this one's caller), they live in memory, and the compiler stores each as
// its wgmma is issued, before the product has landed (wrong sums on the
// card)
__device__ void consume(const Product& p, Ring& rg, int rank, int cluster,
                        const unsigned char* in, const float* __restrict__ bias,
                        Out kind, float* out, int os, const float* res,
                        unsigned char* hid) {
  const int wg = threadIdx.x >> 7;
  const int w4 = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int T = p.N / (kTileM * cluster);
  const int KS = p.K / 64;
  for (int m = 0; m < T; m += 2) {
    const int pair = m + 1 < T ? 2 : 1;
    if (wg < pair) {
      const int f = p.tile(m + wg, T, rank) * kTileM + 16 * w4 + g;
      const float b[2] = {load_early(bias + f), load_early(bias + f + 8)};
      float acc[4][16];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[kk][i] = 0.f;
      Ring r = rg;
      r.advance(wg);
      int held = -1;  // the slot of the product in flight
      for (int ks = 0; ks < KS; ++ks) {
        mbar_wait(&r.full[r.slot], r.phase);
        const unsigned char* a = r.base + r.slot * kTileBytes;
        const unsigned char* bp = in + ks * kPanelBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_bf16_ss_n32(acc[kk], smem_desc_sw128(a + 32 * kk, kSBO),
                            smem_desc_sw128(bp + 32 * kk, kSBO), ks);
        wgmma_commit();
        wgmma_wait<1>();
        if (held >= 0 && lane == 0) mbar_arrive(&r.empty[held]);
        held = r.slot;
        r.advance(pair);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 16; ++i) reg_fence(acc[kk][i]);
      if (lane == 0) mbar_arrive(&r.empty[held]);
      store_tile(acc, f, t, b, kind, out, os, res, hid);
    }
    rg.advance(pair * KS);
  }
}

// This block's part of a product's output (rows of `bytes` bytes from byte
// off, row pitch `pitch`) into every other block of the cluster by st.async,
// whose bytes complete on their barrier bar; returns once every other
// block's part is here (bar's phase of the given parity)
__device__ void exchange(unsigned char* buf, int rows, int pitch, int off,
                         int bytes, uint64_t* bar, unsigned parity, int rank,
                         int cluster) {
  if (threadIdx.x == 0) mbar_expect_bytes(bar, (unsigned)((cluster - 1) * rows * bytes));
  const int chunks = bytes >> 4;
  for (int e = threadIdx.x; e < rows * chunks; e += kConsumers) {
    const int r = e / chunks;
    unsigned char* src = buf + r * pitch + off + ((e - r * chunks) << 4);
    const uint4 v = *reinterpret_cast<const uint4*>(src);
    for (int p = 1; p < cluster; ++p)
      st_async_remote(src, v, bar, (rank + p) & (cluster - 1));
  }
  mbar_wait_cluster(bar, parity);
  fence_proxy_async();  // what arrived is an operand of wgmma
}

// rows of f32 src (row stride ss) rounded into operand panels
__device__ void round_rows(const float* __restrict__ src, int ss,
                           unsigned char* __restrict__ op, int D) {
  const int quads = D / 4;
  for (int e = threadIdx.x; e < kRows * quads; e += kConsumers) {
    const int r = e / quads;
    const int c = 4 * (e - r * quads);
    const float4 v = *reinterpret_cast<const float4*>(src + r * ss + c);
    *reinterpret_cast<uint2*>(op + op_off(r, c)) =
        make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  }
}

// a LayerNorm's gamma and beta at a lane's columns lane + 32 k (D <= 32
// kLnPer), loaded a product ahead, so that their latency hides behind it
constexpr int kLnPer = 8;
constexpr int kLnRows = kRows / kConsumerWarps;
struct LnParams {
  float ga[kLnPer], be[kLnPer];
  __device__ void load(const float* __restrict__ gamma, const float* __restrict__ beta,
                       int D) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int k = 0; k < kLnPer; ++k) {
      const int i = lane + 32 * k;
      ga[k] = i < D ? load_early(gamma + i) : 0.f;
      be[k] = i < D ? load_early(beta + i) : 0.f;
    }
  }
};

// LayerNorm of the rows of src (stride D + 4) into dst (the same stride;
// may be src; null: none) and the operand panels op. A warp takes rows w,
// w + 8, w + 16, w + 24 together, a lane columns lane + 32 k; each row's
// sums in the order of a warp a row
__device__ void layernorm_rows(const float* src, float* dst, unsigned char* op,
                               int D, const LnParams& pr) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int xs = D + 4;
  float v[kLnRows][kLnPer], mu[kLnRows], rstd[kLnRows];
#pragma unroll
  for (int rr = 0; rr < kLnRows; ++rr) {
    const float* row = src + (w + kConsumerWarps * rr) * xs;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kLnPer; ++k) {
      const int i = lane + 32 * k;
      v[rr][k] = i < D ? row[i] : 0.f;
      s += v[rr][k];
    }
    mu[rr] = s;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int rr = 0; rr < kLnRows; ++rr) mu[rr] += __shfl_xor_sync(0xffffffffu, mu[rr], o);
#pragma unroll
  for (int rr = 0; rr < kLnRows; ++rr) {
    mu[rr] /= D;
    float q = 0.f;
#pragma unroll
    for (int k = 0; k < kLnPer; ++k) {
      const float d = v[rr][k] - mu[rr];
      if (lane + 32 * k < D) q += d * d;
    }
    rstd[rr] = q;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int rr = 0; rr < kLnRows; ++rr)
      rstd[rr] += __shfl_xor_sync(0xffffffffu, rstd[rr], o);
#pragma unroll
  for (int rr = 0; rr < kLnRows; ++rr) {
    const int r = w + kConsumerWarps * rr;
    const float rs = rsqrtf(rstd[rr] / D + 1e-5f);
#pragma unroll
    for (int k = 0; k < kLnPer; ++k) {
      const int i = lane + 32 * k;
      if (i >= D) break;
      const float y = (v[rr][k] - mu[rr]) * rs * pr.ga[k] + pr.be[k];
      if (dst != nullptr) dst[r * xs + i] = y;
      *reinterpret_cast<bf16*>(op + op_off(r, i)) = __float2bfloat16_rn(y);
    }
  }
}

// attention of every tile row over the S tokens of its own sequence, for
// heads h0 .. h0 + Hb - 1 (this block's), with tile_attention's arithmetic,
// its output (columns h0 Dh .. (h0 + Hb) Dh - 1) rounded into the operand
// panels op. qkv: [rows, 3D] of stride 3D + 4; probs: [rows, Hb, S]. The
// output goes a warp a row, a lane 4 columns of each 128
__device__ void attention_rows(const float* __restrict__ qkv, float* __restrict__ probs,
                               unsigned char* __restrict__ op, int rows, int S, int D,
                               int H, int h0, int Hb, float scale) {
  const int Dh = D / H;
  const int qs = 3 * D + 4;
  for (int idx = threadIdx.x; idx < rows * Hb * S; idx += kConsumers) {
    const int r = idx / (Hb * S);
    const int h = h0 + (idx / S) % Hb;
    const int j = idx % S;
    const float4* q = reinterpret_cast<const float4*>(qkv + r * qs + h * Dh);
    const float4* k = reinterpret_cast<const float4*>(
        qkv + ((r / S) * S + j) * qs + D + h * Dh);
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int d = 0; d < Dh / 4; ++d) {
      const float4 a = q[d], b = k[d];
      s.x = fmaf(a.x, b.x, s.x);
      s.y = fmaf(a.y, b.y, s.y);
      s.z = fmaf(a.z, b.z, s.z);
      s.w = fmaf(a.w, b.w, s.w);
    }
    probs[idx] = ((s.x + s.y) + (s.z + s.w)) * scale;
  }
  sync_consumers();
  for (int idx = threadIdx.x; idx < rows * Hb; idx += kConsumers) {
    float* p = probs + idx * S;
    float m = p[0];
    for (int j = 1; j < S; ++j) m = fmaxf(m, p[j]);
    float denom = 0.f;
    for (int j = 0; j < S; ++j) {
      p[j] = expf(p[j] - m);
      denom += p[j];
    }
    const float inv = 1.f / denom;
    for (int j = 0; j < S; ++j) p[j] *= inv;
  }
  sync_consumers();
  const int lane = threadIdx.x & 31;
  const int c0 = h0 * Dh, c1 = c0 + Hb * Dh;
  for (int r = threadIdx.x >> 5; r < rows; r += kConsumerWarps) {
    const float* v0 = qkv + (r / S) * S * qs + 2 * D;
    for (int c = c0 + 4 * lane; c < c1; c += 128) {
      const float* p = probs + (r * Hb + (c - c0) / Dh) * S;
      const float* v = v0 + c;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int j = 0; j < S; ++j) {
        const float4 vj = *reinterpret_cast<const float4*>(v + j * qs);
        acc.x = fmaf(p[j], vj.x, acc.x);
        acc.y = fmaf(p[j], vj.y, acc.y);
        acc.z = fmaf(p[j], vj.z, acc.z);
        acc.w = fmaf(p[j], vj.w, acc.w);
      }
      *reinterpret_cast<uint2*>(op + op_off(r, c)) =
          make_uint2(pack_bf16(acc.x, acc.y), pack_bf16(acc.z, acc.w));
    }
  }
}

// The whole stack for one tile (a block of its cluster). Threads below
// kConsumers compute, the first lanes of the next kProducers warps feed the
// ring.
__device__ __forceinline__ void stack(const Args<bf16>& a) {
  extern __shared__ float4 smem_f4[];
  const int D = a.D, F = a.F, S = a.S, H = a.H, n_block = a.n_block;
  const int c = a.cluster;
  const int stages = ring_stages(D, F, H, S);
  const Layout lay(D, F, H, S, stages);
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_f4);
  base += (1024 - (smem_addr(base) & 1023)) & 1023;  // swizzle atoms are 1 KB
  unsigned char* ob = base + lay.ob;
  unsigned char* big = base + lay.big;
  float* qkv = reinterpret_cast<float*>(big);
  float* tail = reinterpret_cast<float*>(base + lay.tail);
  float* x = reinterpret_cast<float*>(base + lay.x);
  float* probs = reinterpret_cast<float*>(base + lay.probs);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + lay.bars);
  uint64_t* empty = full + stages;
  uint64_t* xchg = empty + stages;
  const int xs = D + 4, qs = 3 * D + 4;
  const int rank = (int)cg::this_cluster().block_rank();
  const bool producer = threadIdx.x >= kConsumers;

  const int tile = blockIdx.x / c;
  const int seq0 = tile * a.seq_per_block;
  const int n_valid = min(a.seq_per_block, a.n_seq - seq0);
  const int rows = a.seq_per_block * S;  // rows that attention visits
  const int valid = n_valid * S * D;     // floats read from / written to global
  const float* xg = a.x + (size_t)seq0 * S * D;
  float* skip = a.skip + (size_t)blockIdx.x * n_block * kRows * D;

  uint4* z = reinterpret_cast<uint4*>(ob);
  for (int i = threadIdx.x; i < (lay.bars - lay.ob) / 16; i += kThreads)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // lane 0 of each warp of a warpgroup
    }
    mbar_init(&xchg[0], 1);  // thread 0's arrival with the bytes expected
    mbar_init(&xchg[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  for (int i = threadIdx.x; i < valid; i += kThreads) x[(i / D) * xs + i % D] = xg[i];
  __syncthreads();
  if (!producer) round_rows(x, xs, ob, D);
  fence_proxy_async();
  // every block of the cluster is running and initialised before any
  // writes into another's shared memory or arrivals on its barriers
  cg::this_cluster().sync();

  Ring rg{base, full, empty, stages, 0, 0u, 0};
  int q = 0;  // exchanges so far: barrier q % 2, its phase q / 2
  // this block's part of an output into the other blocks: rows of `bytes`
  // from byte rank x bytes, row pitch `pitch` (or, rows = 1, whole panels)
  auto share = [&](unsigned char* buf, int n_rows, int pitch, int bytes) {
    publish();
    if (c > 1) exchange(buf, n_rows, pitch, rank * bytes, bytes, &xchg[q & 1], (q >> 1) & 1, rank, c);
    ++q;
  };
  auto product = [&](const Product& p, const unsigned char* in,
                     const float* bias, Out kind, float* out, int os,
                     const float* res, bool whole) {
    if (producer) {
      if ((threadIdx.x & 31) == 0) produce(p, rg, rank, c, (threadIdx.x - kConsumers) >> 5);
      return;
    }
    consume(p, rg, rank, c, in, bias, kind, out, os, res, big);
    if (!whole)  // QKV: the block's own heads are all it needs
      publish();
    else if (kind == kGeluBf16)
      share(big, 1, 0, p.N / c / 64 * kPanelBytes);
    else
      share(reinterpret_cast<unsigned char*>(out), kRows, 4 * os, 4 * p.N / c);
  };
  unsigned char* ot = ob + (D / 64) * kPanelBytes;  // attention out, popped skip

  const int L = 2 * n_block + 1;
  for (int l = 0; l < L; ++l) {
    const size_t lD = (size_t)l * D;
    if (l > n_block) {
      // output block i: [x | stack.pop()] @ [Wsx; Wss] + b
      const size_t i = l - n_block - 1;
      product({a.wsx + i * D * D, a.wss + i * D * D, D, 2 * D, D, 1}, ob, a.bs + i * D,
              kF32, x, xs, nullptr, true);
      if (!producer) {
        round_rows(x, xs, ob, D);
        publish();
      }
    }
    // each block its heads' q, k and v, their attention, then the whole
    // attention output in every block
    product({a.wqkv + lD * 3 * D, nullptr, D, D, 3 * D, 3}, ob, a.bqkv + 3 * lD, kF32,
            qkv, qs, nullptr, false);
    if (!producer) {
      attention_rows(qkv, probs, ot, rows, S, D, H, rank * (H / c), H / c, a.scale);
      share(ot, 1, 0, D / c / 64 * kPanelBytes);
    }
    LnParams ln;
    if (!producer) ln.load(a.ln1s + lD, a.ln1b + lD, D);
    product({a.wo + lD * D, nullptr, D, D, D, 1}, ot, a.bo + lD, kF32, x, xs, x, true);
    if (!producer) {
      layernorm_rows(x, x, ob, D, ln);
      publish();
    }
    product({a.w1 + lD * F, nullptr, D, D, F, 1}, ob, a.b1 + (size_t)l * F, kGeluBf16,
            nullptr, 0, nullptr, true);
    // before an output block, which overwrites x, W2's sums go behind the
    // hidden panels, where no block's next product writes
    const bool merge_next = l >= n_block && l + 1 < L;
    float* y = merge_next ? tail : x;
    if (!producer) ln.load(a.ln2s + lD, a.ln2b + lD, D);
    product({a.w2 + (size_t)l * F * D, nullptr, F, F, D, 1}, big, a.b2 + lD, kF32, y, xs, x,
            true);
    if (!producer) {
      layernorm_rows(y, merge_next ? nullptr : x, ob, D, ln);
      if (l < n_block) {
        float* sk = skip + (size_t)l * kRows * D;
        for (int e = threadIdx.x; e < kRows * D / 4; e += kConsumers) {
          const int r = e / (D / 4), cc = 4 * (e - r * (D / 4));
          *reinterpret_cast<float4*>(sk + r * D + cc) =
              *reinterpret_cast<const float4*>(x + r * xs + cc);
        }
      }
      if (merge_next)
        round_rows(skip + (size_t)(2 * n_block - 1 - l) * kRows * D, D, ot, D);
      publish();
    }
  }

  if (!producer && rank == 0) {
    float* og = a.out + (size_t)seq0 * S * D;
    for (int i = threadIdx.x; i < valid; i += kConsumers) og[i] = x[(i / D) * xs + i % D];
  }
  __syncwarp();
  // no block leaves while another may still write into it
  cg::this_cluster().sync();
}

// every product splits into c x 64-feature tiles of each block and 64-wide
// k stages; heads in whole 16-byte copies; a LayerNorm row in a warp's
// registers; a ring of kMinStages at least
inline bool shape_ok(int D, int F, int H, int S, int cluster) {
  for (int N : {D, F})
    if (N % (cluster * kTileM) != 0) return false;
  if (H % cluster != 0) return false;  // QKV and attention split by heads
  return (D / H) % 4 == 0 && D <= 32 * kLnPer && ring_stages(D, F, H, S) >= kMinStages;
}

}  // namespace bf16_arm

// threads a block, by arm
template <typename W>
struct Arm {
  static constexpr int kBlockThreads = kThreads;
};
template <>
struct Arm<__nv_bfloat16> {
  static constexpr int kBlockThreads = bf16_arm::kThreads;
};

template <typename W>
__global__ void __launch_bounds__(Arm<W>::kBlockThreads, 1)
skip_encoder_kernel(const Args<W> a) {
  if constexpr (sizeof(W) == 2) {
    bf16_arm::stack(a);
    return;
  } else {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int D = a.D, F = a.F, S = a.S, H = a.H, n_block = a.n_block;
  const int xs = x_stride(D);
  const int bs = big_stride(D, F);
  float* x = smem;
  float* t = x + kRows * xs;
  float* big = t + kRows * xs;
  float* probs = big + kRows * bs;
  float* part = probs + kRows * H * S;
  const int total = (int)smem_floats(D, F, H, S);
  const int rank = (int)cg::this_cluster().block_rank();
  const int c = a.cluster;

  const int tile = blockIdx.x / c;
  const int seq0 = tile * a.seq_per_block;
  const int n_valid = min(a.seq_per_block, a.n_seq - seq0);
  const int rows = a.seq_per_block * S;  // rows that attention visits
  const int valid = n_valid * S * D;     // floats read from / written to global
  const float* xg = a.x + (size_t)seq0 * S * D;
  float* skip = a.skip + (size_t)blockIdx.x * n_block * kRows * D;

  for (int i = threadIdx.x; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < valid; i += kThreads) x[(i / D) * xs + i % D] = xg[i];
  // every block of the cluster is running and initialised before any
  // writes into another's shared memory
  cg::this_cluster().sync();

  const int L = 2 * n_block + 1;
  for (int l = 0; l < L; ++l) {
    if (l > n_block) {
      // output block i: concat([x, stack.pop()]) @ W + b, as two products
      const int i = l - n_block - 1;
      const size_t iDD = (size_t)i * D * D;
      tile_matmul(a.wsx + iDD, rank, c, x, xs, D, D, a.bs + (size_t)i * D, t,
                  xs, kStore, part);
      copy_rows(x, xs, skip + (size_t)(n_block - 1 - i) * kRows * D, D, D);
      __syncthreads();
      tile_matmul(a.wss + iDD, rank, c, x, xs, D, D, nullptr, t, xs, kAdd, part);
      float* tmp = x;
      x = t;
      t = tmp;
    }
    const size_t lD = (size_t)l * D;
    tile_matmul(a.wqkv + lD * 3 * D, rank, c, x, xs, D, 3 * D,
                a.bqkv + 3 * lD, big, bs, kStore, part);
    tile_attention(big, bs, probs, t, xs, rows, S, D, H, a.scale);
    tile_matmul(a.wo + lD * D, rank, c, t, xs, D, D, a.bo + lD, x, xs, kAdd, part);
    tile_layernorm(x, xs, kRows, D, a.ln1s + lD, a.ln1b + lD);
    __syncthreads();
    tile_matmul(a.w1 + lD * F, rank, c, x, xs, D, F, a.b1 + (size_t)l * F,
                big, bs, kGelu, part);
    tile_matmul(a.w2 + (size_t)l * F * D, rank, c, big, bs, F, D, a.b2 + lD,
                x, xs, kAdd, part);
    tile_layernorm(x, xs, kRows, D, a.ln2s + lD, a.ln2b + lD);
    __syncthreads();
    if (l < n_block) copy_rows(skip + (size_t)l * kRows * D, D, x, xs, D);
  }

  if (rank == 0) {
    float* og = a.out + (size_t)seq0 * S * D;
    for (int i = threadIdx.x; i < valid; i += kThreads) og[i] = x[(i / D) * xs + i % D];
  }
  }
}

template <typename W>
int launch(const Args<W>& a, cudaStream_t stream) {
  const size_t smem = sizeof(W) == 2 ? bf16_arm::smem_bytes(a.D, a.F, a.H, a.S)
                                     : sizeof(float) * smem_floats(a.D, a.F, a.H, a.S);
  cudaError_t err = cudaFuncSetAttribute(
      skip_encoder_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.n_seq + a.seq_per_block - 1) / a.seq_per_block;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.cluster);
  cfg.blockDim = dim3(Arm<W>::kBlockThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, skip_encoder_kernel<W>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename W>
int dispatch(const void* x, void* out, void* skip, const void* wqkv,
             const void* bqkv,
             const void* wo, const void* bo, const void* ln1s,
             const void* ln1b, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* ln2s, const void* ln2b,
             const void* wsx, const void* wss, const void* bs, int n_seq,
             int S, int D, int H, int F, int n_block, int seq_per_block,
             int cluster, cudaStream_t stream) {
  Args<W> a;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
  a.skip = static_cast<float*>(skip);
  a.wqkv = static_cast<const W*>(wqkv);
  a.bqkv = static_cast<const float*>(bqkv);
  a.wo = static_cast<const W*>(wo);
  a.bo = static_cast<const float*>(bo);
  a.ln1s = static_cast<const float*>(ln1s);
  a.ln1b = static_cast<const float*>(ln1b);
  a.w1 = static_cast<const W*>(w1);
  a.b1 = static_cast<const float*>(b1);
  a.w2 = static_cast<const W*>(w2);
  a.b2 = static_cast<const float*>(b2);
  a.ln2s = static_cast<const float*>(ln2s);
  a.ln2b = static_cast<const float*>(ln2b);
  a.wsx = static_cast<const W*>(wsx);
  a.wss = static_cast<const W*>(wss);
  a.bs = static_cast<const float*>(bs);
  a.n_seq = n_seq;
  a.S = S;
  a.D = D;
  a.H = H;
  a.F = F;
  a.n_block = n_block;
  a.seq_per_block = seq_per_block;
  a.cluster = cluster;
  a.scale = (float)(1.0 / std::sqrt((double)(D / H)));
  return launch<W>(a, stream);
}

// every product: whole n-tiles in each block of the cluster, K whole k
// pairs; rows and heads in whole 16-byte copies
template <typename W>
bool widths_ok(int D, int F, int H, int cluster) {
  for (int N : {D, 3 * D, F})
    if (N % (cluster * 8) != 0) return false;
  for (int K : {D, F})
    if (K % Frag<W>::kPair != 0) return false;
  return (D / H) % 4 == 0;
}

}  // namespace

extern "C" {

// All pointers are device pointers on the current device; x/out are
// contiguous f32 [n_seq, S, D]; skip is f32 scratch of ceil(n_seq /
// seq_per_block) * cluster * n_block * 32 * D floats (null when n_block ==
// 0); matrices are [L or n_block, in, out] in f32 (weight_bf16 == 0), each
// in the fragment order of pack_fragments, or bf16 (weight_bf16 == 1), each
// in the tiles of pack_tiles (ops/fused_layer.py); vectors are f32.
// seq_per_block * S <= 32; cluster is 1, 2, 4 or 8 blocks a tile, and D, 3D
// and F split into cluster x n-tiles of 8 columns (f32) or 64 (bf16).
// Returns a cudaError_t (0 on success) after the asynchronous launch.
int mld_skip_encoder_forward(const void* x, void* out, void* skip,
                             const void* wqkv,
                             const void* bqkv, const void* wo, const void* bo,
                             const void* ln1s, const void* ln1b,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* ln2s,
                             const void* ln2b, const void* wsx,
                             const void* wss, const void* bs, int n_seq,
                             int S, int D, int H, int F, int n_block,
                             int seq_per_block, int cluster, int weight_bf16,
                             void* stream) {
  if (n_seq <= 0 || S <= 0 || S > 8 || D <= 0 || F <= 0 || H <= 0 ||
      D % H != 0 || n_block < 0 || seq_per_block <= 0 ||
      seq_per_block * S > kRows || (n_block > 0 && skip == nullptr) ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      !(weight_bf16 ? bf16_arm::shape_ok(D, F, H, S, cluster)
                    : widths_ok<float>(D, F, H, cluster) &&
                          sizeof(float) * smem_floats(D, F, H, S) <= 227 * 1024))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bf16)
    return dispatch<__nv_bfloat16>(x, out, skip, wqkv, bqkv, wo, bo, ln1s, ln1b, w1,
                                   b1, w2, b2, ln2s, ln2b, wsx, wss, bs, n_seq,
                                   S, D, H, F, n_block, seq_per_block,
                                   cluster, st);
  return dispatch<float>(x, out, skip, wqkv, bqkv, wo, bo, ln1s, ln1b, w1, b1, w2,
                         b2, ln2s, ln2b, wsx, wss, bs, n_seq, S, D, H, F,
                         n_block, seq_per_block, cluster, st);
}

}  // extern "C"
