// Causal multi-head attention of the CLIP text tower, one block per
// (example, head), for NVIDIA Hopper (sm_90a).
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
// What bounds it on this card: nothing big. At the serving shapes (S = 8..77,
// Dh = 64, 12 heads) one head's q, k and v take at most 59 KB in f32 and the
// score tile 25 KB, so a block keeps everything in shared memory and reads
// each input byte from device memory once. The work per block is small
// (77 x 77 x 64 x 2 FMAs at most, half of it masked), so the kernel is bound
// by shared-memory loads and by the number of blocks in flight.
//
// What the design does about it:
//  * The TPU kernel pads S and Dh to 128 lanes and computes the full square;
//    here S is padded only to a multiple of 4, and score tiles that lie wholly
//    above the diagonal are skipped.
//  * Scores come in 4 x 4 register tiles from q and k stored transposed in
//    shared memory (two 16-byte loads feed 16 FMAs); P.V in 4-row x 4-column
//    tiles that stop at the diagonal.
//  * One warp a row for the softmax (max, exp, sum, divide), in f32.
//  * Plain FMA loops: tensor cores (mma) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// shared memory: qt [Dh][Sp], kt [Dh][Sp], vs [Sp][Dh], p [Sp][Sp] (f32)
__host__ __device__ inline size_t smem_floats(int Sp, int Dh) {
  return (size_t)3 * Sp * Dh + (size_t)Sp * Sp;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_causal_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int S,
                    int Dh, int Sp, float sm_scale) {
  extern __shared__ float4 smem_f4[];
  float* qt = reinterpret_cast<float*>(smem_f4);
  float* kt = qt + (size_t)Dh * Sp;
  float* vs = kt + (size_t)Dh * Sp;
  float* p = vs + (size_t)Sp * Dh;
  const size_t base = (size_t)blockIdx.x * S * Dh;

  // load one (example, head); rows S..Sp-1 are zero
  for (int i = threadIdx.x; i < Sp * Dh; i += kThreads) {
    const int s = i / Dh;
    const int d = i - s * Dh;
    float qv = 0.f, kv = 0.f, vv = 0.f;
    if (s < S) {
      qv = to_f(q[base + i]);
      kv = to_f(k[base + i]);
      vv = to_f(v[base + i]);
    }
    qt[d * Sp + s] = qv;
    kt[d * Sp + s] = kv;
    vs[i] = vv;
  }
  __syncthreads();

  // scores, 4 x 4 tiles on or below the diagonal
  const int nt = Sp / 4;
  for (int t = threadIdx.x; t < nt * nt; t += kThreads) {
    const int ti = t / nt;
    const int tj = t - ti * nt;
    if (tj > ti) continue;
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int d = 0; d < Dh; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * Sp + 4 * ti);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * Sp + 4 * tj);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) p[(4 * ti + r) * Sp + 4 * tj + c] = acc[r][c] * sm_scale;
  }
  __syncthreads();

  // softmax over keys j <= i, one warp a row; p = 0 above the diagonal
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x >> 5; i < Sp; i += kThreads / 32) {
    float* row = p + (size_t)i * Sp;
    if (i >= S) {
      for (int j = lane; j < Sp; j += 32) row[j] = 0.f;
      continue;
    }
    float m = -3.0e38f;
    for (int j = lane; j <= i; j += 32) m = fmaxf(m, row[j]);
    m = warp_max(m);
    float sum = 0.f;
    for (int j = lane; j <= i; j += 32) {
      const float e = expf(row[j] - m);
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < Sp; j += 32) {
      // probabilities are cast to v's dtype before P.V (attention.py:215)
      row[j] = j <= i ? to_f(from_f<T>(row[j] / sum)) : 0.f;
    }
  }
  __syncthreads();

  // out = P.V, 4 rows x 4 columns a tile, keys up to the tile's last row
  const int nd = Dh / 4;
  for (int t = threadIdx.x; t < nt * nd; t += kThreads) {
    const int ti = t / nd;
    const int dq = t - ti * nd;
    const int jmax = min(4 * ti + 3, S - 1);
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
    for (int j = 0; j <= jmax; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(vs + j * Dh + 4 * dq);
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = p[(4 * ti + r) * Sp + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pr, bv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ti + r;
      if (i < S) {
        T* o = out + base + (size_t)i * Dh + 4 * dq;
#pragma unroll
        for (int c = 0; c < 4; ++c) o[c] = from_f<T>(acc[r][c]);
      }
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int S, int Dh, float sm_scale, cudaStream_t stream) {
  const int Sp = (S + 3) / 4 * 4;
  const size_t smem = smem_floats(Sp, Dh) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_causal_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_causal_kernel<T><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Dh, Sp, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: contiguous [BH, S, Dh] device arrays of one dtype, f32
// (bf16 == 0) or bf16 (bf16 == 1). Returns a cudaError_t (0 on success)
// after the asynchronous launch.
int mld_flash_causal_forward(const void* q, const void* k, const void* v,
                             void* out, int BH, int S, int Dh, float sm_scale,
                             int bf16, void* stream) {
  if (BH <= 0 || S <= 0 || S > 128 || Dh <= 0 || Dh > 128 || Dh % 4 != 0)
    return (int)cudaErrorInvalidValue;
  if (smem_floats((S + 3) / 4 * 4, Dh) * sizeof(float) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) return launch<__nv_bfloat16>(q, k, v, out, BH, S, Dh, sm_scale, st);
  return launch<float>(q, k, v, out, BH, S, Dh, sm_scale, st);
}

}  // extern "C"
