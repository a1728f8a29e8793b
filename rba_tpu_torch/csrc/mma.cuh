// Helpers shared by the tensor-core kernels (built for sm_90a): 16-byte
// cp.async staging into shared memory, mbarrier-counted bulk copies, ldmatrix
// fragment loads, the m16n8k16 bf16 mma and the m16n8k8 TF32 mma, both with
// fp32 sums.
//
// Fragment layout of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for
// lane l with g = l / 4 and t = l % 4 (PTX ISA, "Matrix fragments for mma.m16n8k16"):
//   A (16 x 16, row-major), four .b32 of two bf16 each, the lower column in the low half:
//     a0 = A[g][2t, 2t+1]   a1 = A[g+8][2t, 2t+1]   a2 = A[g][2t+8, 2t+9]   a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col": B[k][n] stored as n-major rows of k), two .b32:
//     b0 = B[2t, 2t+1][g]   b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, fp32): c0, c1 = C[g][2t, 2t+1]   c2, c3 = C[g+8][2t, 2t+1]
// So the C fragments of two neighbouring 8-column tiles are, once packed to bf16,
// the A fragment of the 16-deep product that follows: a0, a1 from the first tile's
// (c0, c1), (c2, c3), and a2, a3 from the second's.
//
// Fragment layout of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, same g and t
// (PTX ISA, "Matrix fragments for mma.m16n8k8"), one TF32 value per .b32:
//   A (16 x 8, row-major):  a0 = A[g][t]   a1 = A[g+8][t]   a2 = A[g][t+4]   a3 = A[g+8][t+4]
//   B (8 x 8, "col"):       b0 = B[t][g]   b1 = B[t+4][g]
//   C, D (16 x 8, fp32): as above.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rba {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronous; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
// 4 bytes, for rows whose starts are not 16-byte aligned
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers and bulk copies (the TMA engine, without a tensor map): one thread asks
// for a whole row, the copy engine moves it and counts its bytes on an mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also announces `bytes` more to come from bulk copies
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// wait for the phase of parity `parity` to complete; traps instead of hanging if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();  // far beyond any copy's latency
  }
}
// order this thread's earlier shared-memory reads before later bulk copies into the same bytes
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to shared memory,
// counted on `bar`
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(smem)), "l"(gmem), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Four 8x8 bf16 matrices; lanes 8i .. 8i+7 give the row addresses of matrix i
// (16 bytes each) and r[i] receives matrix i in the fragment layout above.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}
// The same with each matrix transposed: for B read from a (k, n) row-major tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d += a . b on the tensor cores: a 16x16 bf16, b 16x8 bf16, d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (10 mantissa bits, nearest, ties away from zero): an fp32 bit
// pattern with the low 13 bits clear
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a . b on the tensor cores: a 16x8 TF32, b 8x8 TF32, d 16x8 fp32
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (nearest even) in one .b32, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// v rounded to bf16 and widened back
__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

}  // namespace rba
