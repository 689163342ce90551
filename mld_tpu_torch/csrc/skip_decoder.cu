// Whole post-norm U-Net-skip decoder stack of the MLD VAE, as one C entry
// point that launches a fixed sequence of kernels on the caller's stream, for
// NVIDIA Hopper (sm_90a).
//
// Replaces: mld_tpu/ops/fused_seq_decoder.py:_decoder_kernel (called from
// fused_skip_decoder, l.204; pallas_call l.284).
//
// What it computes, for L = 2n+1 layers over B sequences of T frame queries of
// width D, cross-attending M <= 8 latent tokens per sequence:
//   output block i first merges the popped skip: x = x@Wsx + skip@Wss + bs;
//   self-attention: qkv = x@Wqkv + b, q *= 1/sqrt(Dh); per head softmax over
//     the sequence's valid frames (key 0 always attended, so padded query rows
//     and empty sequences stay finite); x = LN1(x + attn@Wo + bo);
//   cross-attention to the M latent tokens: x = LN2(x + cross@Wo_x + bo_x);
//   FFN: x = LN3(x + gelu(x@W1 + b1)@W2 + b2), exact erf GELU;
//   input block i pushes x onto the skip stack.
// LayerNorm eps is 1e-5 everywhere. The final norm runs outside, as on the TPU.
//
// What bounds it on this card: at the flagship shapes (B=128, T=196, D=256,
// H=4, F=1024, L=9) the stack is ~0.4 TFLOP of products a call, 90% of them
// weight products over R = B*T = 25,088 rows, so it is bound by arithmetic.
// The activations do not fit on chip: one sequence's f32 activation is 200 KB
// and the skip stack at B=128 is 4 x 25.7 MB, where the TPU kernel kept a tile
// of 4 sequences and its whole skip stack in 110 MB of VMEM.
//
// What the design does about it:
//  * Activations, the skip stack and the temporaries live in a workspace in
//    device memory (the wrapper allocates it), and each phase of a layer is
//    one kernel over all rows: the TPU's sequential layer grid becomes the
//    order of launches on one stream.
//  * Weight products are one row-tiled GEMM kernel (64 rows x 256 columns a
//    block, 8 x 8 outputs a thread, double-buffered shared-memory tiles) with
//    the epilogues fused: bias, q scaling, exact GELU, and residual +
//    LayerNorm (a block holds whole rows when N = D <= 256, and a row's 256
//    columns sit in one warp, so the row statistics are warp shuffles). The
//    skip merge is one GEMM over the concatenated reduction [x | skip].
//  * Self-attention: one block per (sequence, head, 64 queries); scores of the
//    query tile against all keys stay in shared memory (99 KB at T=196, two
//    blocks an SM), softmax in f32, then P.V over 64-key chunks.
//  * Cross-attention at M = 1: the one real key gets probability exactly 1
//    (the TPU's 7 padded keys are at -1e9 and exp to exactly 0), so every
//    query row's cross-attention output is its sequence's value row, as on the
//    TPU. The out-projection then is the same for all T rows of a sequence,
//    so it is computed once per sequence and added before LN2. This is exactly
//    the TPU kernel's arithmetic, with T-fold fewer products. For 1 < M <= 8
//    the general path computes q, K/V and a softmax over the M keys.
//  * bf16 weights: the activation operand is rounded to bf16 too and products
//    accumulate in f32 (the TPU kernel's _mm); attention scores and P.V stay
//    f32 (HIGHEST on the TPU).
//  * Plain FMA loops in f32: tensor cores (mma / wgmma, exact for the bf16 arm)
//    and keeping the FFN hidden row tile on chip are later work.
// Kernel launches a call: L * (5 + 3) + n at M = 1, L * (5 + 4) + n otherwise
// (76 and 85 for the flagship stack).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr float kLnEps = 1e-5f;
constexpr float kNegInf = -1e9f;

// ------------------------------------------------------------------ GEMM
constexpr int kBM = 64;        // rows a block
constexpr int kBN = 256;       // columns a block
constexpr int kBK = 16;        // reduction rows a stage
constexpr int kAPad = kBM + 4; // A tile stored transposed, padded row

enum Epilogue { kBias = 0, kGelu = 1, kResLN = 2 };

struct GemmArgs {
  const float* a;   // [M, K1] with row stride lda
  const void* w;    // [K1, N] with row stride ldw (weight dtype)
  const float* a2;  // optional second operand [M, K2] (K2 = 0: none)
  const void* w2;   // [K2, N] with row stride ldw2
  int lda, ldw, lda2, ldw2, K1, K2;
  const float* bias;  // [N] or null
  float* out;         // [M, N], row stride ldo
  int ldo;
  const float* res;   // kResLN: residual [M, N], row stride ldo; may alias out
  const float* gamma;
  const float* beta;
  int M, N;
  int scale_cols;  // kBias: columns n < scale_cols are scaled after the bias
  float scale;
};

// matmul operand rounding: f32 weights multiply f32 activations; bf16 weights
// multiply activations rounded to bf16 (the TPU kernel's a.astype(w.dtype))
template <typename W>
__device__ __forceinline__ float operand(float v);
template <>
__device__ __forceinline__ float operand<float>(float v) { return v; }
template <>
__device__ __forceinline__ float operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float4 load_w4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// out[m, n] = epilogue(sum_k A[m, k] W[k, n] + bias[n]), A = [a | a2] and
// W = [w ; w2] along the reduction. Thread (ty, tx) of the 8 x 32 layout owns
// rows ty*8 .. ty*8+7 and columns tx*4 .. tx*4+3 and 128 + tx*4 .. +3 of the
// block's 64 x 256 tile, so one warp holds 8 whole rows (when N <= 256).
template <typename W, int EPI>
__global__ void __launch_bounds__(kThreads, 2) gemm_kernel(const GemmArgs g) {
  __shared__ __align__(16) float As[2][kBK][kAPad];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const W* w1p = static_cast<const W*>(g.w);
  const W* w2p = static_cast<const W*>(g.w2);
  const int ktiles = (g.K1 + g.K2) / kBK;

  // this thread's share of a stage: one float4 of A, four quads of W
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 4;
  const int b_k = tid >> 6;
  const int b_n = (tid & 63) * 4;
  float4 ra;
  float4 rb[4];

  auto load_stage = [&](int kt) {
    const int k0 = kt * kBK;
    const int m = m0 + a_row;
    if (m < g.M) {
      const float* src = k0 < g.K1 ? g.a + (size_t)m * g.lda + k0
                                   : g.a2 + (size_t)m * g.lda2 + (k0 - g.K1);
      ra = *reinterpret_cast<const float4*>(src + a_k);
    } else {
      ra = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    const int n = n0 + b_n;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + b_k + 4 * i;
      if (n < g.N) {
        rb[i] = k < g.K1 ? load_w4(w1p + (size_t)k * g.ldw + n)
                         : load_w4(w2p + (size_t)(k - g.K1) * g.ldw2 + n);
      } else {
        rb[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  auto store_stage = [&](int buf) {
    As[buf][a_k + 0][a_row] = operand<W>(ra.x);
    As[buf][a_k + 1][a_row] = operand<W>(ra.y);
    As[buf][a_k + 2][a_row] = operand<W>(ra.z);
    As[buf][a_k + 3][a_row] = operand<W>(ra.w);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(&Bs[buf][b_k + 4 * i][b_n]) = rb[i];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load_stage(0);
  store_stage(0);
  __syncthreads();
  for (int kt = 0; kt < ktiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < ktiles) load_stage(kt + 1);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][kk][128 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < ktiles) store_stage(cur ^ 1);
    __syncthreads();
  }

  int cols[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) cols[j] = n0 + (j < 4 ? tx * 4 + j : 128 + tx * 4 + j - 4);
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = (g.bias && cols[j] < g.N) ? g.bias[cols[j]] : 0.f;

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    const bool row_ok = m < g.M;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = acc[i][j] + bias[j];
    if (EPI == kResLN) {
      // whole row in this warp: x = res + v, LayerNorm over the N columns
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool ok = row_ok && cols[j] < g.N;
        v[j] = ok ? v[j] + g.res[(size_t)m * g.ldo + cols[j]] : 0.f;
        s += v[j];
      }
      const float mu = warp_sum(s) / g.N;
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = cols[j] < g.N ? v[j] - mu : 0.f;
        q += d * d;
      }
      const float rstd = rsqrtf(warp_sum(q) / g.N + kLnEps);
      if (row_ok) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (cols[j] < g.N)
            g.out[(size_t)m * g.ldo + cols[j]] =
                (v[j] - mu) * rstd * g.gamma[cols[j]] + g.beta[cols[j]];
      }
    } else if (row_ok) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cols[j] >= g.N) continue;
        float o = v[j];
        if (EPI == kGelu) o = gelu(o);
        if (EPI == kBias && cols[j] < g.scale_cols) o *= g.scale;
        g.out[(size_t)m * g.ldo + cols[j]] = o;
      }
    }
  }
}

// --------------------------------------------------------- self-attention
constexpr int kQT = 64;          // queries a block
constexpr int kKC = 64;          // keys a chunk
constexpr int kTPad = kQT + 4;   // transposed tile row (16-byte aligned)

__host__ __device__ inline int keys_padded(int T) { return (T + kKC - 1) / kKC * kKC; }
__host__ __device__ inline size_t attn_smem_floats(int T, int Dh) {
  // qt [Dh][kTPad], chunk (kt [Dh][kTPad] or v [kKC][Dh]), s [kQT][Tk + 4]
  const size_t chunk = (size_t)Dh * kTPad > (size_t)kKC * Dh ? (size_t)Dh * kTPad : (size_t)kKC * Dh;
  return (size_t)Dh * kTPad + chunk + (size_t)kQT * (keys_padded(T) + 4);
}

// qkv: [B*T, 3D] (q pre-scaled); valid: int32 [B, T]; out: [B*T, D].
// grid (ceil(T / 64), H, B). Dh <= 64, Dh % 4 == 0.
__global__ void __launch_bounds__(kThreads)
self_attention_kernel(const float* __restrict__ qkv, const int* __restrict__ valid,
                      float* __restrict__ out, int T, int D, int Dh) {
  extern __shared__ float4 smem_f4[];
  float* qt = reinterpret_cast<float*>(smem_f4);
  float* chunk = qt + (size_t)Dh * kTPad;
  const size_t chunk_floats =
      (size_t)Dh * kTPad > (size_t)kKC * Dh ? (size_t)Dh * kTPad : (size_t)kKC * Dh;
  float* s = chunk + chunk_floats;
  const int Tk = keys_padded(T);
  const int sst = Tk + 4;
  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int D3 = 3 * D;
  const float* base = qkv + (size_t)b * T * D3;
  const int* vb = valid + (size_t)b * T;
  const int dq4 = Dh / 4;
  const int tid = threadIdx.x;

  // the query tile, transposed: qt[d][i]
  for (int idx = tid; idx < kQT * dq4; idx += kThreads) {
    const int i = idx % kQT;
    const int d = 4 * (idx / kQT);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + i < T) v = *reinterpret_cast<const float4*>(base + (size_t)(q0 + i) * D3 + h * Dh + d);
    qt[(d + 0) * kTPad + i] = v.x;
    qt[(d + 1) * kTPad + i] = v.y;
    qt[(d + 2) * kTPad + i] = v.z;
    qt[(d + 3) * kTPad + i] = v.w;
  }

  // pass 1: scores against every key chunk; thread = 4 queries x 4 keys
  const int ti = tid >> 4;   // query quad
  const int tj = tid & 15;   // key quad
  for (int c0 = 0; c0 < Tk; c0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * dq4; idx += kThreads) {
      const int j = idx % kKC;
      const int d = 4 * (idx / kKC);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + j < T) v = *reinterpret_cast<const float4*>(base + (size_t)(c0 + j) * D3 + D + h * Dh + d);
      chunk[(d + 0) * kTPad + j] = v.x;
      chunk[(d + 1) * kTPad + j] = v.y;
      chunk[(d + 2) * kTPad + j] = v.z;
      chunk[(d + 3) * kTPad + j] = v.w;
    }
    __syncthreads();
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kTPad + 4 * ti);
      const float4 k = *reinterpret_cast<const float4*>(chunk + d * kTPad + 4 * tj);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float kv[4] = {k.x, k.y, k.z, k.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], kv[c], acc[r][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = c0 + 4 * tj + c;
      // masked keys score -1e9 as on the TPU (exp gives exactly 0); key 0 is
      // always attended; keys beyond T are never read
      const bool ok = j < T && (j == 0 || vb[j] != 0);
#pragma unroll
      for (int r = 0; r < 4; ++r) s[(4 * ti + r) * sst + j] = ok ? acc[r][c] : kNegInf;
    }
  }
  __syncthreads();

  // softmax over the T keys, one warp a row
  const int lane = tid & 31;
  for (int i = tid >> 5; i < kQT; i += kThreads / 32) {
    if (q0 + i >= T) continue;
    float* row = s + (size_t)i * sst;
    float m = -3.0e38f;
    for (int j = lane; j < T; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j < T; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < T; j += 32) row[j] = row[j] / sum;
  }

  // pass 2: out = P.V over value chunks; thread = 4 queries x 4 columns
  const int dq = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int c0 = 0; c0 < T; c0 += kKC) {
    __syncthreads();
    for (int idx = tid; idx < kKC * dq4; idx += kThreads) {
      const int j = idx / dq4;
      const int d = 4 * (idx % dq4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c0 + j < T) v = *reinterpret_cast<const float4*>(base + (size_t)(c0 + j) * D3 + 2 * D + h * Dh + d);
      *reinterpret_cast<float4*>(chunk + j * Dh + d) = v;
    }
    __syncthreads();
    if (dq < dq4) {
      const int jn = min(kKC, T - c0);
      for (int j = 0; j < jn; ++j) {
        const float4 v = *reinterpret_cast<const float4*>(chunk + j * Dh + 4 * dq);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = s[(4 * ti + r) * sst + c0 + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
  }
  if (dq < dq4) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int q = q0 + 4 * ti + r;
      if (q < T)
        *reinterpret_cast<float4*>(out + ((size_t)b * T + q) * D + h * Dh + 4 * dq) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
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

// M = 1: x[r] = LN(x[r] + c[r / T]), in place, one warp a row; c: [B, D] is
// the sequence's cross-attention output after the out-projection.
__global__ void __launch_bounds__(kThreads)
add_row_layernorm_kernel(float* __restrict__ x, const float* __restrict__ c,
                         const float* __restrict__ gamma, const float* __restrict__ beta,
                         int R, int T, int D) {
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  float* xr = x + row * D;
  const float* cr = c + (row / T) * D;
  float v[8];  // D <= 256
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    v[k] = i < D ? xr[i] + cr[i] : 0.f;
    s += v[k];
  }
  const float mu = warp_sum(s) / D;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    const float d = i < D ? v[k] - mu : 0.f;
    q += d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / D + kLnEps);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    if (i < D) xr[i] = (v[k] - mu) * rstd * gamma[i] + beta[i];
  }
}

// ------------------------------------------------- host side: the launches
struct Weights {
  const void *wqkv_s, *wo_s, *wqkv_x, *wo_x, *w1, *w2, *wsx, *wss;
  const float *bqkv_s, *bo_s, *bqkv_x, *bo_x, *ln1s, *ln1b, *ln2s, *ln2b, *ln3s, *ln3b,
      *b1, *b2, *bs;
};

// one GEMM launch; returns a cudaError_t
template <typename W, int EPI>
int gemm(const GemmArgs& g, cudaStream_t stream) {
  const dim3 grid((g.M + kBM - 1) / kBM, (g.N + kBN - 1) / kBN);
  gemm_kernel<W, EPI><<<grid, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

GemmArgs gemm_args(const float* a, int lda, const void* w, int ldw, int K, const float* bias,
                   float* out, int ldo, int M, int N) {
  GemmArgs g = {};
  g.a = a;
  g.lda = lda;
  g.w = w;
  g.ldw = ldw;
  g.K1 = K;
  g.bias = bias;
  g.out = out;
  g.ldo = ldo;
  g.M = M;
  g.N = N;
  return g;
}

// matrix l of a stacked [L, rows, cols] weight array
template <typename W>
const W* layer_mat(const void* base, int l, int rows, int cols) {
  return static_cast<const W*>(base) + (size_t)l * rows * cols;
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
        float* ws, int B, int T, int M, int D, int H, int F, int n_block, int* launched,
        cudaStream_t stream) {
  const int R = B * T;
  const int L = 2 * n_block + 1;
  const int D3 = 3 * D;
  const int Dh = D / H;
  const float scale = (float)(1.0 / std::sqrt((double)Dh));
  const size_t RD = (size_t)R * D;

  // workspace layout (ops/fused_seq_decoder.py:workspace_floats)
  float* xa = ws;
  float* xb = xa + RD;
  float* skips = xb + RD;
  float* attn = skips + (size_t)n_block * RD;
  float* big = attn + RD;  // qkv [R, 3D], cross q [R, D] or FFN hidden [R, F]
  float* memkv = big + (size_t)R * (D3 > F ? D3 : F);
  float* crossc = memkv + (size_t)B * M * 2 * D;

  const size_t attn_smem = attn_smem_floats(T, Dh) * sizeof(float);
  CHECK((int)cudaFuncSetAttribute(self_attention_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)attn_smem));
  const dim3 attn_grid((T + kQT - 1) / kQT, H, B);
  const int warps_rows = (int)(((long long)R * 32 + kThreads - 1) / kThreads);

  const float* x = tgt;
  for (int l = 0; l < L; ++l) {
    const size_t lD = (size_t)l * D;
    if (l > n_block) {
      // output block i: x@Wsx + skip@Wss + bs as one GEMM over [x | skip]
      const int i = l - n_block - 1;
      float* t = x == xa ? xb : xa;
      GemmArgs g = gemm_args(x, D, layer_mat<W>(wt.wsx, i, D, D), D, D, wt.bs + (size_t)i * D, t, D, R, D);
      g.a2 = skips + (size_t)(n_block - 1 - i) * RD;
      g.lda2 = D;
      g.w2 = layer_mat<W>(wt.wss, i, D, D);
      g.ldw2 = D;
      g.K2 = D;
      LAUNCHED((gemm<W, kBias>(g, stream)));
      x = t;
    }
    float* y = x == xa ? xb : xa;  // this layer's activation buffer

    // self-attention
    {
      GemmArgs g = gemm_args(x, D, layer_mat<W>(wt.wqkv_s, l, D, D3), D3, D, wt.bqkv_s + 3 * lD, big,
                             D3, R, D3);
      g.scale_cols = D;
      g.scale = scale;
      LAUNCHED((gemm<W, kBias>(g, stream)));
      self_attention_kernel<<<attn_grid, kThreads, attn_smem, stream>>>(big, valid, attn, T, D, Dh);
      LAUNCHED((int)cudaGetLastError());
      g = gemm_args(attn, D, layer_mat<W>(wt.wo_s, l, D, D), D, D, wt.bo_s + lD, y, D, R, D);
      g.res = x;
      g.gamma = wt.ln1s + lD;
      g.beta = wt.ln1b + lD;
      LAUNCHED((gemm<W, kResLN>(g, stream)));
    }

    // cross-attention to the M latent tokens
    const W* wx = layer_mat<W>(wt.wqkv_x, l, D, D3);
    const float* bx = wt.bqkv_x + 3 * lD;
    if (M == 1) {
      // probability 1 on the one key: every row's output is the value row,
      // and its out-projection is one row per sequence
      GemmArgs g = gemm_args(mem, D, wx + 2 * D, D3, D, bx + 2 * D, memkv, D, B, D);
      LAUNCHED((gemm<W, kBias>(g, stream)));
      g = gemm_args(memkv, D, layer_mat<W>(wt.wo_x, l, D, D), D, D, wt.bo_x + lD, crossc, D, B, D);
      LAUNCHED((gemm<W, kBias>(g, stream)));
      add_row_layernorm_kernel<<<warps_rows, kThreads, 0, stream>>>(y, crossc, wt.ln2s + lD,
                                                                    wt.ln2b + lD, R, T, D);
      LAUNCHED((int)cudaGetLastError());
    } else {
      GemmArgs g = gemm_args(y, D, wx, D3, D, bx, big, D, R, D);
      g.scale_cols = D;
      g.scale = scale;
      LAUNCHED((gemm<W, kBias>(g, stream)));
      g = gemm_args(mem, D, wx + D, D3, D, bx + D, memkv, 2 * D, B * M, 2 * D);
      LAUNCHED((gemm<W, kBias>(g, stream)));
      const int blocks = (int)(((long long)R * H * 32 + kThreads - 1) / kThreads);
      cross_attention_kernel<<<blocks, kThreads, 0, stream>>>(big, memkv, attn, B, T, M, D, H);
      LAUNCHED((int)cudaGetLastError());
      g = gemm_args(attn, D, layer_mat<W>(wt.wo_x, l, D, D), D, D, wt.bo_x + lD, y, D, R, D);
      g.res = y;
      g.gamma = wt.ln2s + lD;
      g.beta = wt.ln2b + lD;
      LAUNCHED((gemm<W, kResLN>(g, stream)));
    }

    // FFN; the layer's output goes to the skip stack, the caller's output,
    // or stays in y
    {
      GemmArgs g = gemm_args(y, D, layer_mat<W>(wt.w1, l, D, F), F, D, wt.b1 + (size_t)l * F, big, F,
                             R, F);
      LAUNCHED((gemm<W, kGelu>(g, stream)));
      float* dst = l < n_block ? skips + (size_t)l * RD : (l == L - 1 ? out : y);
      g = gemm_args(big, F, layer_mat<W>(wt.w2, l, F, D), D, F, wt.b2 + lD, dst, D, R, D);
      g.res = y;
      g.gamma = wt.ln3s + lD;
      g.beta = wt.ln3b + lD;
      LAUNCHED((gemm<W, kResLN>(g, stream)));
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
// out: f32 [B, T, D]. Matrices are [L or n, in, out] in f32 (weight_bf16 == 0)
// or bf16 (weight_bf16 == 1); vectors f32 [L or n, K]. ws: f32 scratch of
// ws_floats elements (ops/fused_seq_decoder.py:workspace_floats). All device
// pointers on the current device. *launched receives the number of kernels
// launched. Returns a cudaError_t (0 on success) after the asynchronous
// launches.
int mld_skip_decoder_forward(const void* tgt, const void* mem, const void* valid, void* out,
                             const void* wqkv_s, const void* bqkv_s, const void* wo_s,
                             const void* bo_s, const void* wqkv_x, const void* bqkv_x,
                             const void* wo_x, const void* bo_x, const void* ln1s,
                             const void* ln1b, const void* ln2s, const void* ln2b,
                             const void* ln3s, const void* ln3b, const void* w1, const void* b1,
                             const void* w2, const void* b2, const void* wsx, const void* wss,
                             const void* bs, void* ws, long long ws_floats, int B, int T, int M,
                             int D, int H, int F, int n_block, int weight_bf16, int* launched,
                             void* stream) {
  *launched = 0;
  if (B <= 0 || T <= 0 || M < 1 || M > 8 || D <= 0 || D > 256 || D % 16 != 0 || H <= 0 ||
      D % H != 0 || (D / H) > 64 || (D / H) % 4 != 0 || F <= 0 || F % 16 != 0 || n_block < 0)
    return (int)cudaErrorInvalidValue;
  const long long R = (long long)B * T;
  const long long need = R * D * (3 + n_block) + R * (3 * D > F ? 3 * D : F) +
                         (long long)B * M * 2 * D + (long long)B * D;
  if (ws_floats < need) return (int)cudaErrorInvalidValue;
  if (attn_smem_floats(T, D / H) * sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;
  Weights wt;
  wt.wqkv_s = wqkv_s;
  wt.wo_s = wo_s;
  wt.wqkv_x = wqkv_x;
  wt.wo_x = wo_x;
  wt.w1 = w1;
  wt.w2 = w2;
  wt.wsx = wsx;
  wt.wss = wss;
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
  float* w = static_cast<float*>(ws);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bf16)
    return run<__nv_bfloat16>(t, m, v, o, wt, w, B, T, M, D, H, F, n_block, launched, st);
  return run<float>(t, m, v, o, wt, w, B, T, M, D, H, F, n_block, launched, st);
}

}  // extern "C"
