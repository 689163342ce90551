// Bidirectional multi-head attention with a key-padding mask, one block per
// (example, head, tile of 64 queries), for NVIDIA Hopper (sm_90a).
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
// What bounds it on this card: f32 FMAs. The s512 self-attention
// ([12, 4, 512, 128]) is 6.4 GFLOP a launch over 6 MB of operands, ~1,000
// FLOP a byte, far above the f32 ridge; tensor cores are ruled out (the TPU
// kernel pins Precision.HIGHEST and TF32 keeps 10 mantissa bits), so the
// bound is the card's 67 TFLOP/s of f32 FMA, and what keeps the FMA pipes
// fed: shared-memory loads and enough warps in flight.
//
// What the design does about it:
//  * The TPU kernel holds one (example, head)'s whole Sq x Sk score tile in
//    VMEM (1 MB at 512 x 512); here keys stream through shared memory in
//    tiles of 64 with an online softmax (running max and sum per row).
//  * Two threads own a query row, each half of its Dh columns: the q half
//    and the output accumulator half live in registers, so every k and v
//    element read from shared memory is a broadcast to the warp's 16 rows
//    and feeds 4 FMAs a 16-byte load. Partial scores meet with one shuffle.
//    Keys go in chunks of 8: 8 independent dot products, one max, one
//    rescale of the accumulator, 8 exps.
//  * Two barriers a key tile and ~68 KB of shared memory at Dh = 128. The
//    launch bound asks for two blocks an SM, which leaves the registers
//    room enough not to spill (a bound of three spilled at Dh = 128 and was
//    slower at small grids). 64 queries a block: the s512 self-attention at
//    six prompts under CFG is 384 blocks.
//  * Measured on the card (PERF.md, K3): the tile loads, synchronous and
//    scalar, take ~40% of a launch at [12, 4, 512, 128], and a layout with
//    twice the FMAs a shared-memory load (four threads a pair of rows) was
//    no faster. Copies that overlap compute (cp.async into a second buffer)
//    are the next step, then wider register tiles.
//  * Operands are read in place through batch, head and row strides, so the
//    views of the packed QKV projection need no copy; the output is written
//    through strides too, so the out-projection reads it without one.
//  * Dh is padded to 32, 64 or 128 at compile time (zero columns add
//    nothing to a score and are not stored).
//  * Plain FMA loops: tensor cores for a bf16 arm are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = kThreads / 2;  // queries a block
constexpr int kBK = 64;              // keys a shared-memory tile
constexpr int kChunk = 8;            // keys a softmax update
constexpr float kMaskFill = -1e9f;

struct Strides {
  long long b, h, r;  // elements between examples, heads and rows
};

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

// a key row in shared memory: the two column halves with 4 floats between
// them, so that the two threads of a query row read different banks
template <int DHP>
struct Layout {
  static constexpr int kHalf = DHP / 2;
  static constexpr int kRow = DHP + 4;
  __host__ __device__ static constexpr int col(int d) {
    return d < kHalf ? d : d + 4;
  }
  __host__ __device__ static constexpr size_t smem_bytes() {
    return sizeof(float) * ((size_t)2 * kBK * kRow + kBK);
  }
};

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const unsigned char* __restrict__ valid,
             T* __restrict__ out, int Sq, int Sk, int Dh, Strides sq,
             Strides sk, Strides sv, Strides so, float sm_scale) {
  using L = Layout<DHP>;
  constexpr int kHalf = L::kHalf;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* vs = ks + kBK * L::kRow;
  float* kval = vs + kBK * L::kRow;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kRows + (tid >> 1);
  const int half = tid & 1;
  const int c0 = half * kHalf;           // first column of this thread
  const int soff = half * (kHalf + 4);   // its offset in a key row
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // this thread's half of its query row (zero past Sq and past Dh)
  float qr[kHalf];
  {
    const T* qrow = q + b * sq.b + h * sq.h + (long long)row * sq.r;
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      qr[i] = row < Sq && c0 + i < Dh ? to_f(qrow[c0 + i]) : 0.f;
  }
  float acc[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) acc[i] = 0.f;
  float m_run = -CUDART_INF_F, l_run = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += kBK) {
    const int nk = min(kBK, Sk - k0);
    // keys loaded: nk rounded up to a chunk, the rest zero
    const int nk_pad = (nk + kChunk - 1) / kChunk * kChunk;
    __syncthreads();  // every thread is done with the last tile
    for (int e = tid; e < nk_pad * DHP; e += kThreads) {
      const int j = e / DHP;
      const int d = e - j * DHP;
      float kv = 0.f, vv = 0.f;
      if (j < nk && d < Dh) {
        kv = to_f(kb[(long long)(k0 + j) * sk.r + d]);
        vv = to_f(vb[(long long)(k0 + j) * sv.r + d]);
      }
      ks[j * L::kRow + L::col(d)] = kv;
      vs[j * L::kRow + L::col(d)] = vv;
    }
    for (int j = tid; j < nk_pad; j += kThreads)
      kval[j] = valid == nullptr || (j < nk && valid[(long long)b * Sk + k0 + j]) ? 1.f : 0.f;
    __syncthreads();

    for (int jc = 0; jc < nk; jc += kChunk) {
      // 16 scores: this thread's half-dot products, summed with the other
      // half's
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) s[c] = 0.f;
#pragma unroll
      for (int i = 0; i < kHalf; i += 4) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const float4 kk = *reinterpret_cast<const float4*>(
              ks + (jc + c) * L::kRow + soff + i);
          s[c] = fmaf(qr[i], kk.x, s[c]);
          s[c] = fmaf(qr[i + 1], kk.y, s[c]);
          s[c] = fmaf(qr[i + 2], kk.z, s[c]);
          s[c] = fmaf(qr[i + 3], kk.w, s[c]);
        }
      }
      float m_chunk = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[c] += __shfl_xor_sync(0xffffffffu, s[c], 1);
        // scaled, -1e9 at invalid keys; keys past Sk take no part
        s[c] = jc + c >= nk ? -CUDART_INF_F
               : kval[jc + c] != 0.f ? s[c] * sm_scale : kMaskFill;
        m_chunk = fmaxf(m_chunk, s[c]);
      }
      // the chunk's first key is in range, so m_new is finite
      const float m_new = fmaxf(m_run, m_chunk);
      const float alpha = expf(m_run - m_new);  // 0 on the first chunk
      m_run = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[c] = expf(s[c] - m_new);  // 0 past Sk
        sum += s[c];
      }
      l_run = l_run * alpha + sum;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
#pragma unroll
        for (int i = 0; i < kHalf; i += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + (jc + c) * L::kRow + soff + i);
          acc[i] = fmaf(s[c], vv.x, acc[i]);
          acc[i + 1] = fmaf(s[c], vv.y, acc[i + 1]);
          acc[i + 2] = fmaf(s[c], vv.z, acc[i + 2]);
          acc[i + 3] = fmaf(s[c], vv.w, acc[i + 3]);
        }
      }
    }
  }

  if (row < Sq) {
    const float inv = 1.f / l_run;
    T* orow = out + b * so.b + h * so.h + (long long)row * so.r;
#pragma unroll
    for (int i = 0; i < kHalf; ++i)
      if (c0 + i < Dh) orow[c0 + i] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int DHP>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int B, int H, int Sq, int Sk, int Dh, Strides sq,
           Strides sk, Strides sv, Strides so, float sm_scale,
           cudaStream_t stream) {
  const size_t smem = Layout<DHP>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DHP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_kernel<T, DHP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const unsigned char*>(valid),
      static_cast<T*>(out), Sq, Sk, Dh, sq, sk, sv, so, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* valid,
              void* out, int B, int H, int Sq, int Sk, int Dh, Strides sq,
              Strides sk, Strides sv, Strides so, float sm_scale,
              cudaStream_t stream) {
  if (Dh <= 32)
    return launch<T, 32>(q, k, v, valid, out, B, H, Sq, Sk, Dh, sq, sk, sv,
                         so, sm_scale, stream);
  if (Dh <= 64)
    return launch<T, 64>(q, k, v, valid, out, B, H, Sq, Sk, Dh, sq, sk, sv,
                         so, sm_scale, stream);
  return launch<T, 128>(q, k, v, valid, out, B, H, Sq, Sk, Dh, sq, sk, sv, so,
                        sm_scale, stream);
}

}  // namespace

extern "C" {

// q [B, H, Sq, Dh], k, v [B, H, Sk, Dh] and out [B, H, Sq, Dh]: device arrays
// of one dtype, f32 (bf16 == 0) or bf16 (bf16 == 1), addressed through the
// given batch, head and row strides (in elements) with unit stride along Dh.
// valid: [B, Sk] bytes, contiguous, nonzero = attend, or null for all keys.
// Returns a cudaError_t (0 on success) after the asynchronous launch.
int mld_flash_forward(const void* q, const void* k, const void* v,
                      const void* valid, void* out, int B, int H, int Sq,
                      int Sk, int Dh, long long q_sb, long long q_sh,
                      long long q_sr, long long k_sb, long long k_sh,
                      long long k_sr, long long v_sb, long long v_sh,
                      long long v_sr, long long o_sb, long long o_sh,
                      long long o_sr, float sm_scale, int bf16, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || Sq <= 0 || Sk <= 0 ||
      Dh < 4 || Dh > 128 || Dh % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const Strides sq{q_sb, q_sh, q_sr}, sk{k_sb, k_sh, k_sr},
      sv{v_sb, v_sh, v_sr}, so{o_sb, o_sh, o_sr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_dh<__nv_bfloat16>(q, k, v, valid, out, B, H, Sq, Sk, Dh, sq,
                                    sk, sv, so, sm_scale, st);
  return launch_dh<float>(q, k, v, valid, out, B, H, Sq, Sk, Dh, sq, sk, sv, so,
                          sm_scale, st);
}

}  // extern "C"
