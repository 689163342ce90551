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
// What bounds it on this card: the flagship stack holds 7.6 M matrix
// parameters (30 MB in f32, 15 MB in bf16), which every tile of rows must
// stream from L2 once per call, while the activations are a few KB. The
// products are 2 x rows x 7.6 M FLOP; in f32 the three-pass TF32 split
// triples them on the tensor cores, and mma.sync TF32 runs well below
// wgmma's 495 TFLOP/s, so the f32 arm is bound by the tensor cores' mma.sync
// rate on the SMs a batch occupies and by the L2 reads (tiles x 30 MB); the
// bf16 arm by the L2 reads and the per-product synchronisation.
//
// What the design does about it:
//  * Blocks run in no order, so the TPU's sequential grid over layers becomes
//    a loop over layers inside each block. A tile holds whole sequences (32
//    rows: 10 sequences of 3 tokens), since attention only mixes the S tokens
//    of one sequence; its two m16 tiles share every weight fragment, so 26
//    tiles at B=128 under CFG read 0.78 GB of L2 in f32, where the FMA
//    design's 6-row tiles read 3.8 GB.
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
//  * Products are mma.sync: m16n8k8 TF32 with the 3xTF32 split for f32
//    weights (x = big + small, a.b ~ big.big + big.small + small.big, the
//    three in separate f32 accumulators so that no product waits for another;
//    within the f32 bar of 1e-4), m16n8k16 bf16 for bf16 weights with the
//    activation operand rounded to bf16 as in the TPU kernel
//    (a.astype(w.dtype)), f32 accumulation either way. Activation rows are
//    padded so that the A fragment loads from shared memory are free of bank
//    conflicts. The product loop is one non-inlined function: unrolled for
//    its loads in flight, it would otherwise be copied into every call site.
//  * The tile's activations and the QKV/FFN temporaries live in shared memory
//    across all layers (209 KB at the flagship widths). That leaves no room
//    for the skip stack at 32 rows (4 x 32 KB), so it goes to a scratch
//    buffer in device memory, written and read once a call (128 KB a block,
//    against 7.5 MB of weights).
//  * LayerNorm (rsqrtf(var + 1e-5)), GELU (erff), softmax and residuals stay
//    f32 CUDA-core code, as in the TPU kernel.

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
template <>
struct Frag<__nv_bfloat16> {
  static constexpr int kPair = 32;
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

// bf16 weights: two m16n8k16 steps, the activation operand rounded to bf16;
// acc[m][s] takes step s
template <>
__device__ __forceinline__ void pair_product<__nv_bfloat16>(
    float (&acc)[2][3][4], const float* a, int a_str, const uint4& w, int g,
    int t) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const uint32_t bf[2] = {s ? w.z : w.x, s ? w.w : w.y};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* r0 = a + (16 * m + g) * a_str + 16 * s + 2 * t;
      const float* r1 = r0 + 8 * a_str;
      const float2 x0 = *reinterpret_cast<const float2*>(r0);
      const float2 x1 = *reinterpret_cast<const float2*>(r1);
      const float2 x2 = *reinterpret_cast<const float2*>(r0 + 8);
      const float2 x3 = *reinterpret_cast<const float2*>(r1 + 8);
      const uint32_t af[4] = {pack_bf16(x0.x, x0.y), pack_bf16(x1.x, x1.y),
                              pack_bf16(x2.x, x2.y), pack_bf16(x3.x, x3.y)};
      mma_bf16(acc[m][s], af, bf);
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

template <typename W>
__global__ void __launch_bounds__(kThreads, 1)
skip_encoder_kernel(const Args<W> a) {
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

template <typename W>
int launch(const Args<W>& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.D, a.F, a.H, a.S);
  cudaError_t err = cudaFuncSetAttribute(
      skip_encoder_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (a.n_seq + a.seq_per_block - 1) / a.seq_per_block;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * a.cluster);
  cfg.blockDim = dim3(kThreads);
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
// 0); matrices are [L or n_block, in, out] in f32 (weight_bf16 == 0) or bf16
// (weight_bf16 == 1), each in the fragment order of pack_fragments
// (ops/fused_layer.py); vectors are f32. seq_per_block * S <= 32; cluster is
// 1, 2, 4 or 8 blocks a tile, and D, 3D and F split into cluster x n-tiles
// of 8 columns. Returns a cudaError_t (0 on success) after the asynchronous
// launch.
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
      !(weight_bf16 ? widths_ok<__nv_bfloat16>(D, F, H, cluster)
                    : widths_ok<float>(D, F, H, cluster)) ||
      sizeof(float) * smem_floats(D, F, H, S) > 227 * 1024)
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
