// Tensor-core and asynchronous-copy helpers shared by the port's kernels
// (sm_90a): cp.async copies into shared memory, streaming 16-byte loads,
// the TF32 split of an f32 operand, mma.sync products and ldmatrix fragment
// loads.
//
// Fragment layouts (PTX ISA, mma.sync), for lane = 4 g + t of a warp:
//   m16n8k8 TF32  A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                 a3 (g + 8, t + 4); B (8 x 8, col): b0 (t, g), b1 (t + 4, g)
//   m16n8k16 bf16 A: a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..),
//                 a3 (g + 8, 2t+8..); B: b0 (2t..2t+1, g), b1 (2t+8.., g)
//   C/D (16 x 8): c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
// A product sums over k, so a kernel may permute k inside a step as long as
// A and B use the same permutation; the TF32 users take k = t <-> 2t and
// k = t + 4 <-> 2t + 1, which turns a thread's two k values into
// neighbours in memory (one 64-bit load).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_sm90 {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy BYTES (2, 4, 8 or 16) from global to shared memory, zeros where !ok;
// 2 bytes is below cp.async's smallest copy and goes as a plain copy
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool ok) {
  if constexpr (BYTES == 2) {
    *static_cast<uint16_t*>(dst) = ok ? *static_cast<const uint16_t*>(src) : 0;
  } else if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(ok ? BYTES : 0));
  }
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small: big is x rounded to TF32 (to nearest, ties away, as
// cvt.rna, but by an integer add and mask: cvt runs on a slower pipe), small
// the exact f32 rest, which the tensor core truncates to TF32 as it reads it
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of bf16 stored [k][n] (n contiguous), two neighbouring n-tiles:
// lanes 0-7, 8-15, 16-23, 24-31 give the addresses of rows k0..k0+7 and
// k0+8..k0+15 at column n0, then at n0 + 8; r = {b0, b1} of each n-tile
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// one 16-byte load from global memory through the read-only path, not kept
// in L1: a stream of data that this thread reads once (it stays in L2 for
// the other blocks that read it)
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// two f32 rounded to bf16 and packed, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace mma_sm90
