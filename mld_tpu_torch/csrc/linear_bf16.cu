// The serving precision's reduced linear in its bf16 arithmetic, one launch
// on Hopper's tensor cores (sm_90a):
//
//   y [M, N] = bf16(x [M, K]) . bf16(w [N, K])^T (+ b [N]),  f32 in and out,
//
// both operands rounded to bf16 to nearest even (as Tensor.bfloat16()), the
// products on wgmma with f32 accumulation, b added to the f32 accumulator,
// y written once. Nothing is computed at a lower precision than the
// cast-cast-GEMM-add sequence it replaces (utils/precision.py: _mm then
// `y + b`); only the order of the f32 sums differs.
//
// Replaces no Pallas kernel: the JAX package leaves its dots to XLA, which
// on a TPU rounds the operands inside the matrix unit. It was added because
// on this card the same arithmetic took four launches and three trips
// through device memory a linear (x rounded to a bf16 copy, w likewise, the
// GEMM writing f32, a broadcast bias add reading and writing it again).
//
// What bounds it on this card: bytes. At the served widths (K and N of 256
// to 1,536) a linear does 2K N / 4(K + N) operations a byte of f32 moved,
// 128 at 512 x 512, below the H100's ridge of 295: its least time is x read
// once and y written once at 3.35 TB/s (the weights are a few MB and stay
// in L2).
//
// What the design does about it:
//  * x is read by the kernel itself, as f32, and rounded on chip. Each
//    thread copies the x values of its own A fragment (two rows, 16 k of a
//    64-wide chunk) by cp.async into slots of a shared-memory ring that
//    only it reads, so the ring needs no barrier: two chunks (64 KB a
//    block) are in flight while the tensor cores multiply a third and
//    while a tile's epilogue stores. The thread then rounds its values in
//    pairs (cvt.rn.bf16x2.f32) into wgmma's A fragment in registers. Inside
//    each 16-wide k step a thread's four k values are contiguous in memory
//    (4t .. 4t + 3 for the lane's t), so four lanes copy 64 contiguous
//    bytes of a row; the weights are stored in the same order of k, which a
//    product allows. Rows of x not 16-byte aligned (K = 263: 1,052 bytes)
//    are copied 4 bytes at a time.
//  * The weights are rounded once per block and kept on chip: a block owns
//    a slice of BN = 64 NC output features, rounds its K x BN slice into
//    shared memory (wgmma's 128-byte swizzle, up to 128 KB) while its first
//    chunks of x are in flight, and then walks its tiles of 128 rows (a
//    persistent grid). The blocks of one row group walk the same rows at
//    the same time, so the slices after the first read x from L2. A slice
//    too deep for that (K past 1,024 at BN 64) is taken in segments of K,
//    rounded again for each tile.
//  * y is written once from the accumulators with the bias added, 8 bytes
//    a lane where rows allow it.
//  * Tile widths and grid follow from M, N and K: the fewest slices whose
//    weights fit, then the fewest features a slice that covers N; with few
//    row tiles (M of 64-128) the narrowest slices, so more SMs share the
//    rounding of the weights. Zeros fill k past K, rows past M and features
//    past N.
//  * No split-K and no atomics: each output is summed by one thread in a
//    fixed order, so launches on the same inputs are bitwise equal.
//
// Tried and dropped (PERF.md, section 6): x by TMA into a ring shared by
// the block's warps, fed by a producer warp, and multicast to the blocks of
// a cluster of slices (up to 8), so that L2 is read once a cluster: no
// faster than one block a slice, and with cluster-scope barrier waits many
// times slower; the per-thread ring beat both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kWG = 2;                        // warpgroups a block
constexpr int kThreads = 128 * kWG;
constexpr int kTileRows = 64 * kWG;           // rows of a block's tile
constexpr int kChunk = 64;                    // k of a chunk: 128 bytes of bf16
constexpr int kChunkBytes = 64 * 128;         // 64 features of a weight chunk
constexpr int kWeightBytes = 128 * 1024;      // the weights' shared memory
constexpr int kMaxNC = 4;                     // BN <= 256
constexpr int kStages = 3;                    // x chunks in the ring
constexpr int kStageBytes = kThreads * 8 * 16;   // 8 slots of 16 bytes a thread
constexpr size_t kSmemBytes = 1024 + kWeightBytes + 64 * kMaxNC * sizeof(float) +
                              (size_t)kStages * kStageBytes;

// d (+)= a . b for a warpgroup: a 64 x 16 bf16 from registers (each warp 16
// rows, the m16n8k16 A layout), b 16 x 64 bf16 from shared memory (desc,
// K-major), d 64 x 64 f32 (d[4j..4j+3] the m16n8 C fragment of columns
// 8j..8j+7); scale_d == 0 overwrites d
__device__ __forceinline__ void wgmma_bf16_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

struct Params {
  const float* x;
  const float* w;
  const float* b;
  float* y;
  int M, N, K;
  int n_slices, groups, cps;
  int vec_w, vec_y;   // rows of w 16-byte aligned; rows of y 8-byte aligned
};

// Shared memory, from a 1 KB-aligned base: the weight slice as [chunk][BN
// rows][128 bytes], each row 64 k values of one feature in the 128-byte
// swizzle (its 16-byte unit q at q ^ (row & 7)), k permuted inside each
// 16-wide step as the A fragments are (memory k 4t + j at position
// 2t + (j & 1) + 8 (j >> 1)); the slice's bias, BN floats; the ring
// [kStages][8 slots][kThreads][16 bytes].
//
// Rounds chunks [c0, c0 + nch) of the features [n0, n0 + BN) into ws.
template <int NC>
__device__ __forceinline__ void round_weights(uint8_t* ws, const Params& p, int n0, int c0,
                                              int nch) {
  constexpr int BN = 64 * NC;
  constexpr int kUnroll = 8;
  const int items = nch * BN * 16;   // 16 groups of 4 k a feature's chunk
  for (int base = threadIdx.x; base < items; base += kThreads * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int it = base + u * kThreads;
      const int grp = it & 15, rest = it >> 4;
      const int n = rest % BN, cc = rest / BN;
      const int k = (c0 + cc) * kChunk + 4 * grp;
      const float* src = p.w + (size_t)(n0 + n) * p.K + k;
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (it < items && n0 + n < p.N) {
        if (p.vec_w) {
          if (k < p.K) v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          if (k < p.K) v[u].x = __ldg(src);
          if (k + 1 < p.K) v[u].y = __ldg(src + 1);
          if (k + 2 < p.K) v[u].z = __ldg(src + 2);
          if (k + 3 < p.K) v[u].w = __ldg(src + 3);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int it = base + u * kThreads;
      if (it >= items) break;
      const int grp = it & 15, rest = it >> 4;
      const int n = rest % BN, cc = rest / BN;
      const int s = grp >> 2, tt = grp & 3, sw = n & 7;
      uint8_t* row = ws + (size_t)cc * BN * 128 + n * 128 + 4 * tt;
      *reinterpret_cast<uint32_t*>(row + (((2 * s) ^ sw) << 4)) = pack_bf16(v[u].x, v[u].y);
      *reinterpret_cast<uint32_t*>(row + (((2 * s + 1) ^ sw) << 4)) = pack_bf16(v[u].z, v[u].w);
    }
  }
}

// slot (h, s) of this thread in a ring stage: row r + 8 h, memory k
// 16 s + 4t .. + 3 of the chunk; a warp's 32 slots are 512 contiguous bytes
__device__ __forceinline__ uint8_t* slot(uint8_t* stage, int h, int s) {
  return stage + ((h * 4 + s) * kThreads + threadIdx.x) * 16;
}

// this thread's x of the 64-wide chunk at k0 (= chunk start + 4t) into its
// slots of a ring stage, rows r and r + 8; zeros past M and K. AL: rows of x
// 16-byte aligned (one 16-byte copy a slot), else four 4-byte copies.
template <bool AL>
__device__ __forceinline__ void copy_x(uint8_t* stage, const float* __restrict__ x, int r,
                                       int M, int K, int k0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    const float* src = x + (size_t)row * K + k0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int n = row < M ? K - k0 - 16 * s : 0;   // floats left in the row
      if constexpr (AL) {
        copy_async<16>(slot(stage, h, s), n > 0 ? src + 16 * s : x, n > 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          copy_async<4>(slot(stage, h, s) + 4 * e, n > e ? src + 16 * s + e : x, n > e);
      }
    }
  }
}

template <int NC, bool AL>
__global__ void __launch_bounds__(kThreads, 1) linear_bf16_kernel(const Params p) {
  constexpr int BN = 64 * NC;
  extern __shared__ float4 smem_f4[];
  uint8_t* ws = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_f4) + 1023) & ~uintptr_t(1023));
  float* bias = reinterpret_cast<float*>(ws + (size_t)p.cps * BN * 128);
  uint8_t* ring = reinterpret_cast<uint8_t*>(bias + BN);

  const int slice = blockIdx.x % p.n_slices, group = blockIdx.x / p.n_slices;
  const int n0 = slice * BN;
  const int nkc = (p.K + kChunk - 1) / kChunk;
  const bool segmented = p.cps < nkc;
  const int n_tiles = (p.M + kTileRows - 1) / kTileRows;
  if (group >= n_tiles) return;
  const int steps = ((n_tiles - 1 - group) / p.groups + 1) * nkc;

  const int tid = threadIdx.x, wg = tid >> 7, wi = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row_off = 64 * wg + 16 * wi + g;   // and row_off + 8

  // the chunks of steps 0 .. kStages - 2 in flight before the weights
  int ctile = group, ckc = 0;   // the chunk the next copy brings
  for (int d = 0; d < kStages - 1; ++d) {
    if (d < steps)
      copy_x<AL>(ring + d * kStageBytes, p.x, ctile * kTileRows + row_off, p.M, p.K,
                 ckc * kChunk + 4 * t);
    copy_commit();
    if (++ckc == nkc) {
      ckc = 0;
      ctile += p.groups;
    }
  }
  for (int i = tid; i < BN; i += kThreads)
    bias[i] = (p.b != nullptr && n0 + i < p.N) ? p.b[n0 + i] : 0.f;

  float acc[NC][32];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;

  int tile = group, kc = 0;
  for (int step = 0; step < steps; ++step) {
    if (kc % p.cps == 0 && (step == 0 || segmented)) {
      // every warpgroup is past its last product on the slice's chunks
      __syncthreads();
      round_weights<NC>(ws, p, n0, kc, min(p.cps, nkc - kc));
      fence_proxy_async();
      __syncthreads();
    }
    // this thread's copies of the step's chunk have landed
    copy_wait<kStages - 2>();
    uint8_t* stage = ring + (step % kStages) * kStageBytes;
    uint32_t a[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float4 lo = *reinterpret_cast<const float4*>(slot(stage, 0, s));
      const float4 hi = *reinterpret_cast<const float4*>(slot(stage, 1, s));
      a[s][0] = pack_bf16(lo.x, lo.y);
      a[s][1] = pack_bf16(hi.x, hi.y);
      a[s][2] = pack_bf16(lo.z, lo.w);
      a[s][3] = pack_bf16(hi.z, hi.w);
    }
    // refill the slots read the step before with the chunk kStages - 1 on
    if (step + kStages - 1 < steps)
      copy_x<AL>(ring + ((step + kStages - 1) % kStages) * kStageBytes, p.x,
                 ctile * kTileRows + row_off, p.M, p.K, ckc * kChunk + 4 * t);
    copy_commit();
    if (++ckc == nkc) {
      ckc = 0;
      ctile += p.groups;
    }

    const uint8_t* chunk = ws + (size_t)(kc % p.cps) * BN * 128;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int j = 0; j < NC; ++j)
        wgmma_bf16_n64(acc[j], a[s], smem_desc_sw128(chunk + j * kChunkBytes + 32 * s, 1024),
                       kc > 0 || s > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(acc[j][i]);
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) reg_fence(a[s][i]);

    if (kc == nkc - 1) {
      // y = acc + b, rows row_off and row_off + 8, columns 8q + 2t and
      // 8q + 2t + 1 of each 64-feature part j
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = tile * kTileRows + row_off + 8 * h;
        if (row >= p.M) continue;
        float* yr = p.y + (size_t)row * p.N;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = 64 * j + 8 * q + 2 * t, col = n0 + c;
            if (col >= p.N) continue;
            float y0 = acc[j][4 * q + 2 * h], y1 = acc[j][4 * q + 2 * h + 1];
            if (p.b != nullptr) {
              y0 += bias[c];
              y1 += bias[c + 1];
            }
            if (p.vec_y && col + 1 < p.N) {
              *reinterpret_cast<float2*>(yr + col) = make_float2(y0, y1);
            } else {
              yr[col] = y0;
              if (col + 1 < p.N) yr[col + 1] = y1;
            }
          }
      }
      kc = 0;
      tile += p.groups;
    } else {
      ++kc;
    }
  }
  copy_wait<0>();
}

// the first launch of a kernel on a device lifts its dynamic shared memory cap
template <typename Kernel>
cudaError_t lift(Kernel kernel) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, bool> done;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair((const void*)kernel, dev);
  if (done.count(key)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err == cudaSuccess) done[key] = true;
  return err;
}

template <int NC, bool AL>
int launch(const Params& p, cudaStream_t stream) {
  auto kernel = linear_bf16_kernel<NC, AL>;
  const cudaError_t err = lift(kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = 1024 + (size_t)p.cps * NC * kChunkBytes + 64 * NC * sizeof(float) +
                      (size_t)kStages * kStageBytes;
  kernel<<<p.n_slices * p.groups, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool AL>
int launch_nc(int NC, const Params& p, cudaStream_t stream) {
  switch (NC) {
    case 1: return launch<1, AL>(p, stream);
    case 2: return launch<2, AL>(p, stream);
    case 3: return launch<3, AL>(p, stream);
    default: return launch<4, AL>(p, stream);
  }
}

// The tiles of an M x N x K launch on an SM count: 64-feature parts a slice
// (NC), slices, row groups (the persistent grid is slices x groups) and
// the chunks of 64 k a block keeps (cps; fewer than K's means segments).
void plan(int M, int N, int K, int n_sm, int* nc, int* n_slices, int* groups, int* cps) {
  const int nkc = (K + kChunk - 1) / kChunk;
  const int parts = (N + 63) / 64;
  const int n_tiles = (M + kTileRows - 1) / kTileRows;
  int fit = kWeightBytes / (kChunkBytes * nkc);
  fit = fit < 1 ? 1 : (fit > kMaxNC ? kMaxNC : fit);
  if (fit > parts) fit = parts;
  int slices = (parts + fit - 1) / fit;
  // few row tiles: narrower slices, more blocks rounding the weights
  while (fit > 1 && (long long)slices * n_tiles < n_sm) {
    --fit;
    slices = (parts + fit - 1) / fit;
  }
  const int NC = (parts + slices - 1) / slices;
  int g = n_sm / slices;
  g = g < 1 ? 1 : (g > n_tiles ? n_tiles : g);
  const int per = (n_tiles + g - 1) / g;   // tiles a block walks
  g = (n_tiles + per - 1) / per;           // as few groups as give that
  const int kept = kWeightBytes / (kChunkBytes * NC);
  *nc = NC;
  *n_slices = slices;
  *groups = g;
  *cps = kept < nkc ? kept : nkc;
}

}  // namespace

extern "C" {

// x [M, K], w [N, K], b [N] or null, y [M, N]: contiguous f32 device arrays
// on the current device. Returns a cudaError_t (0 on success) after the
// asynchronous launch on `stream`.
int mld_linear_bf16_forward(const void* x, const void* w, const void* b, void* y, int M, int N,
                            int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || x == nullptr || w == nullptr || y == nullptr)
    return (int)cudaErrorInvalidValue;
  static std::mutex mu;
  static std::map<int, int> sms;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = sms.find(dev);
    if (it == sms.end()) {
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      it = sms.emplace(dev, n_sm).first;
    }
    n_sm = it->second;
  }
  const auto aligned = [](const void* q, int to) {
    return reinterpret_cast<uintptr_t>(q) % to == 0;
  };
  Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.b = static_cast<const float*>(b);
  p.y = static_cast<float*>(y);
  p.M = M;
  p.N = N;
  p.K = K;
  p.vec_w = K % 4 == 0 && aligned(w, 16);
  p.vec_y = N % 2 == 0 && aligned(y, 8);
  int nc = 1;
  plan(M, N, K, n_sm, &nc, &p.n_slices, &p.groups, &p.cps);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K % 4 == 0 && aligned(x, 16)) return launch_nc<true>(nc, p, st);
  return launch_nc<false>(nc, p, st);
}

}  // extern "C"
