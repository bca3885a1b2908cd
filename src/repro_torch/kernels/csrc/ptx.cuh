// Inline-PTX wrappers shared by the port's Hopper kernels (sm_90a):
// asynchronous global -> shared copies (cp.async), shared-memory matrix
// fragment loads (ldmatrix), the bf16 tensor-core product (mma.sync
// m16n8k16, float32 accumulate) and the TF32 one (m16n8k8) with its
// float32 -> tf32 rounding.  Included by the kernels'
// sources; `_build.py` passes this directory with -I and hashes this file
// into every library that includes it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy, global -> shared, bypassing L1.  Both addresses 16-byte
// aligned.  `full` false: the 16 bytes at `dst` are zero-filled and
// nothing is read (src must still be a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool full) {
  const int n = full ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

// 4-byte copy, global -> shared (for rows that are not 16-byte aligned);
// `full` false zero-fills as above.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool full) {
  const int n = full ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory: lanes 8j..8j+7 give the row
// addresses (16 bytes each) of matrix j, and every lane receives in r[j]
// the two elements (row lane/4, columns 2(lane%4), +1) of matrix j.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The same, each matrix transposed: r[j] holds (rows 2(lane%4), +1,
// column lane/4) of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d += a b for a 16x16 bf16 A (row-major fragment, 4 registers), a 16x8
// bf16 B (column fragment, 2 registers) and a 16x8 float32 D.  With g =
// lane / 4 and c = 2 (lane % 4): a[0] = A[g][c..c+1], a[1] = A[g+8][c..],
// a[2] = A[g][c+8..], a[3] = A[g+8][c+8..]; b[0] = B[c..c+1][g], b[1] =
// B[c+8..c+9][g]; d[0..1] = D[g][c..c+1], d[2..3] = D[g+8][c..c+1].
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 mantissa bits; to nearest, ties away from zero:
// cvt.rna), in a 32-bit register with the low 13 bits zero.
__device__ __forceinline__ uint32_t cvt_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a b for a 16x8 tf32 A (row-major fragment, 4 registers), an 8x8
// tf32 B (column fragment, 2 registers) and a 16x8 float32 D.  With g =
// lane / 4 and t = lane % 4: a[0] = A[g][t], a[1] = A[g+8][t], a[2] =
// A[g][t+4], a[3] = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; d as for
// m16n8k16 (d[0..1] = D[g][2t..2t+1], d[2..3] = D[g+8][2t..2t+1]).
__device__ __forceinline__ void mma_tf32_1688(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 1 / x within 1 ulp (rcp.approx; x normal): no slow path, whose call
// can leave ptxas a stack frame in a kernel that holds many registers.
__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
  return r;
}

// Two floats rounded to bf16 (nearest even) in one register, `lo` in the
// low half: the element order of an mma fragment.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace ptx
