// Whole post-norm U-Net-skip encoder stack of the MLD latent denoiser, in one
// launch, for NVIDIA Hopper (sm_90a).
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
// parameters (30 MB in f32, 15 MB in bf16). Every block reads all of them
// once per call and does one FMA per weight element and row of its tile (3-16
// rows), so the weights, which fit in the 50 MB L2, are read from L2 once per
// block. With one block per tile, a small batch is bound by how fast one SM
// can pull 30 MB (latency of the loads, then its FMA rate); a batch that fills
// the SMs is bound by total L2 reads (128 blocks x 30 MB at B=128). The
// activations are tiny ([2B, 3, 256] f32) and never leave shared memory.
//
// What the design does about it:
//  * Blocks run in no order, so the TPU's sequential grid over layers becomes
//    a loop over layers inside each block. Each block owns a tile of whole
//    sequences: attention only mixes the S tokens of one sequence, so no block
//    needs another's rows and there is no cross-block synchronisation.
//  * The tile's activation, its n-deep skip stack and the QKV/FFN temporaries
//    live in dynamic shared memory across all layers; only weights are read
//    from global memory.
//  * To keep many bytes in flight per SM, each thread owns 4 neighbouring
//    output columns of the [in, out] weight layout (one 16-byte load a weight
//    row, neighbouring threads on neighbouring addresses), keeps two register
//    buffers of 8 weight rows (the next 8 load while the current 8 multiply)
//    and ROWS x 4 f32 accumulators. Where a product has fewer column quads
//    than threads (N = D), the threads split the reduction and add their
//    partial sums in a fixed order.
//  * The wrapper picks the tile (sequences per block) from the batch so that
//    small batches still spread over the SMs, and the kernel is instantiated
//    for 4, 8 and 16 rows so that little work goes to padding rows.
//  * bf16 weights halve the L2 stream. As in the TPU kernel, the activation
//    operand is rounded to bf16 too and products accumulate in f32; softmax,
//    LayerNorm (rsqrtf(var + 1e-5)), GELU (erff) and residuals stay f32.
//  * Plain FMA loops in f32: tensor cores (mma / wgmma), which would let a
//    block hold more rows and so cut the L2 reads, and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kKStep = 8;  // weight rows loaded per batch: 8 vector loads in flight

// four consecutive output columns of one weight row, as one vector load
__device__ __forceinline__ void load_quad(const float* p, float (&f)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}
__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}

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

// kKStep weight rows of this thread's 4 columns, starting at p
template <typename W>
__device__ __forceinline__ void load_rows(const W* p, int N, float (&wv)[kKStep][4]) {
#pragma unroll
  for (int kk = 0; kk < kKStep; ++kk) load_quad(p + (size_t)kk * N, wv[kk]);
}

// acc[r][c] += sum_kk in[r, kk] * wv[kk][c] over kKStep reduction rows
template <typename W, int ROWS>
__device__ __forceinline__ void fma_rows(const float* in, int K,
                                         const float (&wv)[kKStep][4],
                                         float (&acc)[ROWS][4]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const float4 a0 = *reinterpret_cast<const float4*>(in + r * K);
    const float4 a1 = *reinterpret_cast<const float4*>(in + r * K + 4);
    const float a[kKStep] = {operand<W>(a0.x), operand<W>(a0.y), operand<W>(a0.z),
                             operand<W>(a0.w), operand<W>(a1.x), operand<W>(a1.y),
                             operand<W>(a1.z), operand<W>(a1.w)};
#pragma unroll
    for (int kk = 0; kk < kKStep; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[kk], wv[kk][c], acc[r][c]);
  }
}

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

enum Epilogue { kStore = 0, kAdd = 1, kGelu = 2 };

// Reduction splits: a power of two that gives idle threads part of the
// reduction when there are fewer column quads (N/4) than threads, and keeps
// each split a multiple of kKStep rows.
__device__ __forceinline__ int k_splits(int K, int N) {
  int s = 1;
  while (2 * s * (N / 4) <= kThreads && K % (2 * s * kKStep) == 0) s *= 2;
  return s;
}

// out[r, n] (op)= sum_k in[r, k] * w[k, n] + bias[n] for r < ROWS, n < N.
// in: shared [ROWS, K]; w: global [K, N]; out: shared [ROWS, N];
// K % 8 == 0, N % 4 == 0. A work item is (column quad, reduction split):
// 4 columns x K/splits rows of w into ROWS x 4 f32 accumulators. With more
// than one split every thread holds at most one item, and the splits add
// into `out` one after another, in a fixed order.
template <typename W, int ROWS>
__device__ void tile_matmul(const float* __restrict__ in, int K,
                            const W* __restrict__ w, int N,
                            const float* __restrict__ bias,
                            float* __restrict__ out, Epilogue ep) {
  const int nq = N / 4;
  const int splits = k_splits(K, N);
  const int kc = K / splits;
  for (int item0 = 0; item0 < nq * splits; item0 += kThreads) {
    const int item = item0 + threadIdx.x;
    const bool active = item < nq * splits;
    const int s = item / nq;
    const int n = 4 * (item % nq);
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

    if (active) {
      // two register buffers of kKStep weight rows: the loads of the next
      // batch are in flight while the current one is multiplied
      const W* wp = w + (size_t)s * kc * N + n;
      const float* ip = in + s * kc;
      float wa[kKStep][4], wb[kKStep][4];
      load_rows(wp, N, wa);
      for (int k = 0; k < kc; k += 2 * kKStep) {
        const bool second = k + kKStep < kc;
        if (second) load_rows(wp + (size_t)(k + kKStep) * N, N, wb);
        fma_rows<W, ROWS>(ip + k, K, wa, acc);
        if (second) {
          if (k + 2 * kKStep < kc) load_rows(wp + (size_t)(k + 2 * kKStep) * N, N, wa);
          fma_rows<W, ROWS>(ip + k + kKStep, K, wb, acc);
        }
      }
    }

    for (int t = 0; t < splits; ++t) {
      if (active && s == t) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float b = (t == 0 && bias) ? bias[n + c] : 0.f;
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float v = acc[r][c] + b;
            float* o = out + r * N + n + c;
            if (t > 0 || ep == kAdd) {
              *o += v;
            } else if (ep == kGelu && splits == 1) {
              *o = gelu(v);
            } else {
              *o = v;
            }
          }
        }
      }
      if (splits > 1) __syncthreads();
    }
  }
  if (splits > 1 && ep == kGelu) {
    for (int i = threadIdx.x; i < ROWS * N; i += kThreads) out[i] = gelu(out[i]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// in-place LayerNorm over the last axis of shared [rows, D], one warp a row
__device__ void tile_layernorm(float* x, int rows, int D,
                               const float* __restrict__ g,
                               const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kThreads / 32) {
    float* row = x + r * D;
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
// qkv: shared [rows, 3D]; probs: shared [rows, H, S]; out: shared [rows, D]
__device__ void tile_attention(const float* qkv, float* probs, float* out,
                               int rows, int S, int D, int H, float scale) {
  const int Dh = D / H;
  const int D3 = 3 * D;
  for (int idx = threadIdx.x; idx < rows * H * S; idx += kThreads) {
    const int r = idx / (H * S);
    const int h = (idx / S) % H;
    const int j = idx % S;
    const float* q = qkv + r * D3 + h * Dh;
    const float* k = qkv + ((r / S) * S + j) * D3 + D + h * Dh;
    float s = 0.f;
    for (int d = 0; d < Dh; ++d) s = fmaf(q[d] * scale, k[d], s);
    probs[idx] = s;
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
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    const float* p = probs + (r * H + c / Dh) * S;
    const float* v = qkv + (r / S) * S * D3 + 2 * D + c;
    float acc = p[0] * v[0];
    for (int j = 1; j < S; ++j) acc = fmaf(p[j], v[j * D3], acc);
    out[idx] = acc;
  }
  __syncthreads();
}

template <typename W>
struct Args {
  const float* x;
  float* out;
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
  int n_seq, S, D, H, F, n_block, seq_per_block;
  float scale;
};

template <int ROWS>
__host__ __device__ constexpr size_t smem_floats_for(int D, int F, int H,
                                                     int S, int n_block) {
  return (size_t)ROWS * D * 2                       // x, t
         + (size_t)ROWS * (3 * D > F ? 3 * D : F)   // qkv / ffn hidden
         + (size_t)n_block * ROWS * D               // skip stack
         + (size_t)ROWS * H * S;                    // attention probs
}

template <typename W, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
skip_encoder_kernel(const Args<W> a) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const int D = a.D, F = a.F, S = a.S, H = a.H, n_block = a.n_block;
  const int big_cols = 3 * D > F ? 3 * D : F;
  float* x = smem;
  float* t = x + ROWS * D;
  float* big = t + ROWS * D;
  float* skips = big + ROWS * big_cols;
  float* probs = skips + (size_t)n_block * ROWS * D;
  const size_t total = smem_floats_for<ROWS>(D, F, H, S, n_block);

  const int seq0 = blockIdx.x * a.seq_per_block;
  const int n_valid = min(a.seq_per_block, a.n_seq - seq0);
  const int rows = a.seq_per_block * S;       // rows that attention visits
  const int valid = n_valid * S * D;          // floats read from / written to global
  const float* xg = a.x + (size_t)seq0 * S * D;

  for (size_t i = threadIdx.x; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  for (int i = threadIdx.x; i < valid; i += kThreads) x[i] = xg[i];
  __syncthreads();

  const int L = 2 * n_block + 1;
  for (int l = 0; l < L; ++l) {
    if (l > n_block) {
      // output block i: concat([x, stack.pop()]) @ W + b, as two products
      const int i = l - n_block - 1;
      const float* skip = skips + (size_t)(n_block - 1 - i) * ROWS * D;
      tile_matmul<W, ROWS>(x, D, a.wsx + (size_t)i * D * D, D, a.bs + (size_t)i * D, t, kStore);
      tile_matmul<W, ROWS>(skip, D, a.wss + (size_t)i * D * D, D, nullptr, t, kAdd);
      __syncthreads();
      float* tmp = x;
      x = t;
      t = tmp;
    }
    const size_t lD = (size_t)l * D;
    tile_matmul<W, ROWS>(x, D, a.wqkv + lD * 3 * D, 3 * D, a.bqkv + 3 * lD, big, kStore);
    __syncthreads();
    tile_attention(big, probs, t, rows, S, D, H, a.scale);
    tile_matmul<W, ROWS>(t, D, a.wo + lD * D, D, a.bo + lD, x, kAdd);
    __syncthreads();
    tile_layernorm(x, ROWS, D, a.ln1s + lD, a.ln1b + lD);
    __syncthreads();
    tile_matmul<W, ROWS>(x, D, a.w1 + lD * F, F, a.b1 + (size_t)l * F, big, kGelu);
    __syncthreads();
    tile_matmul<W, ROWS>(big, F, a.w2 + (size_t)l * F * D, D, a.b2 + lD, x, kAdd);
    __syncthreads();
    tile_layernorm(x, ROWS, D, a.ln2s + lD, a.ln2b + lD);
    __syncthreads();
    if (l < n_block) {
      float* dst = skips + (size_t)l * ROWS * D;
      for (int i = threadIdx.x; i < ROWS * D; i += kThreads) dst[i] = x[i];
      __syncthreads();
    }
  }

  float* og = a.out + (size_t)seq0 * S * D;
  for (int i = threadIdx.x; i < valid; i += kThreads) og[i] = x[i];
}

template <typename W, int ROWS>
int launch(const Args<W>& a, cudaStream_t stream) {
  const size_t smem =
      smem_floats_for<ROWS>(a.D, a.F, a.H, a.S, a.n_block) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      skip_encoder_kernel<W, ROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (a.n_seq + a.seq_per_block - 1) / a.seq_per_block;
  skip_encoder_kernel<W, ROWS><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename W>
int dispatch(const void* x, void* out, const void* wqkv, const void* bqkv,
             const void* wo, const void* bo, const void* ln1s,
             const void* ln1b, const void* w1, const void* b1, const void* w2,
             const void* b2, const void* ln2s, const void* ln2b,
             const void* wsx, const void* wss, const void* bs, int n_seq,
             int S, int D, int H, int F, int n_block, int seq_per_block,
             cudaStream_t stream) {
  Args<W> a;
  a.x = static_cast<const float*>(x);
  a.out = static_cast<float*>(out);
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
  a.scale = (float)(1.0 / std::sqrt((double)(D / H)));
  const int rows = seq_per_block * S;
  if (rows <= 4) return launch<W, 4>(a, stream);
  if (rows <= 8) return launch<W, 8>(a, stream);
  if (rows <= 16) return launch<W, 16>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// All pointers are device pointers on the current device; x/out are
// contiguous f32 [n_seq, S, D]; matrices are [L or n_block, in, out] in f32
// (weight_bf16 == 0) or bf16 (weight_bf16 == 1); vectors are f32. Returns a
// cudaError_t (0 on success) after the asynchronous launch.
int mld_skip_encoder_forward(const void* x, void* out, const void* wqkv,
                             const void* bqkv, const void* wo, const void* bo,
                             const void* ln1s, const void* ln1b,
                             const void* w1, const void* b1, const void* w2,
                             const void* b2, const void* ln2s,
                             const void* ln2b, const void* wsx,
                             const void* wss, const void* bs, int n_seq,
                             int S, int D, int H, int F, int n_block,
                             int seq_per_block, int weight_bf16,
                             void* stream) {
  if (n_seq <= 0 || S <= 0 || S > 8 || D % 8 != 0 || F % 8 != 0 ||
      H <= 0 || D % H != 0 || n_block < 0 || seq_per_block <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (weight_bf16)
    return dispatch<__nv_bfloat16>(x, out, wqkv, bqkv, wo, bo, ln1s, ln1b, w1,
                                   b1, w2, b2, ln2s, ln2b, wsx, wss, bs, n_seq,
                                   S, D, H, F, n_block, seq_per_block, st);
  return dispatch<float>(x, out, wqkv, bqkv, wo, bo, ln1s, ln1b, w1, b1, w2,
                         b2, ln2s, ln2b, wsx, wss, bs, n_seq, S, D, H, F,
                         n_block, seq_per_block, st);
}

}  // extern "C"
