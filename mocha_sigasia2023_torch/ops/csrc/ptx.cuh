// Inline PTX for Hopper (sm_90a): mbarriers, TMA tensor copies from global
// to shared memory, the TF32 tensor-core product with its 3xTF32 split, and
// the bf16 product with its fragment loads.
#pragma once

#include <stdint.h>

namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (phase parity starts at 0) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// Hands a ring stage back to its producer.  The mbarrier's release/acquire
// orders this thread's reads of the stage (plain loads, ldmatrix: the
// generic proxy) only against other generic-proxy accesses; the producer's
// next TMA write into the stage is in the async proxy, so the reads are
// fenced against it first.  Without the fence, the bf16 kernel's ldmatrix
// reads of v met the next chunk's bytes in about 4 of 10 launches at
// M = 45 on an H100.
__device__ __forceinline__ void mbar_release_stage(uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  mbar_arrive(bar);
}

// One arrival that also tells the barrier to expect `bytes` of TMA copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spins until the phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA: one box of a 4-D tensor map (a __grid_constant__ kernel
// parameter) from global to shared memory at the coordinates c0 (innermost)
// .. c3, completing on `bar`; elements outside the tensor arrive as zeros ----

__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// ---- TF32 tensor cores ----

// Round to TF32 (nearest, ties away from zero); the low 13 bits are zero.
// The same rounding as cvt.rna.tf32.f32 for finite x, in two integer
// instructions: adding half a TF32 ulp to the magnitude bits and masking.
// (ptxas expands cvt.rna into a longer sequence: with it the attention
// kernel took 1.35x as long on an H100, scripts/attention_ablation.py.)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small: big = tf32(x), small = x - big (exact in fp32).  The
// MMA reads only the top 19 bits of a TF32 operand, so it truncates small,
// and big + small as the tensor cores see it keeps about 21 bits of x.
// (Rounding small as well would cost two more instructions a split for
// about one bit.)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = __float_as_uint(x - __uint_as_float(big));
}

// d += a b for a 16x8 (row) by 8x8 (col) tile; fp32 accumulation.
// Fragments (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 3xTF32: d += a_small b_big + a_big b_small + a_big b_big (the small
// terms first, so they are not lost against the big product).
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// ---- bf16 tensor cores ----

// Two floats rounded to bf16 (nearest, ties to even) in one 32-bit word,
// `lo` in the low half: the order of a row of a fragment in memory.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b for a 16x16 (row) by 16x8 (col) bf16 tile; fp32 accumulation.
// Fragments (g = lane / 4, t = lane % 4), two bf16 a register, the lower
// column or row in the low half: a = A[g][2t..], A[g+8][2t..], A[g][2t+8..],
// A[g+8][2t+8..]; b = B[2t..][g], B[2t+8..][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, transposed: lane L gives the
// address of row L % 8 of matrix L / 8 (16 bytes, 16-byte aligned), and
// register i of lane (g, t) receives matrix i's elements [2t][g] and
// [2t+1][g], the first in the low half.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&d)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr)
      : "memory");
}

}  // namespace ptx
