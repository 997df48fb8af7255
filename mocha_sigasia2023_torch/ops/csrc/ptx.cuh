// Inline PTX for Hopper (sm_90a): mbarriers, TMA tensor copies between
// global and shared memory, asynchronous copies (cp.async), ldmatrix, the
// TF32 tensor-core product with its 3xTF32 split, the bf16 mma.sync
// product, and the bf16 warpgroup products (wgmma).
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
// fenced against it first.  Without the fence, an earlier bf16 kernel's
// ldmatrix reads of v met the next chunk's bytes in about 4 of 10 launches
// at M = 45 on an H100.  (wgmma reads shared memory in the async proxy and
// is complete once wgmma_wait returns; its stages are released here all the
// same, so that every release in the repo has one form.)
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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  tma_load_4d(smem_addr(dst), map, c0, c1, c2, c3, bar);
}

// One box from shared memory at `src` into the tensor at c0 .. c3, in this
// thread's current bulk group; elements outside the tensor are not written.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src,
                                             int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's bulk groups still read shared
// memory (their sources may then be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// Waits until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;" :: "n"(N) : "memory");
}

// Brings a tensor map (a __grid_constant__ kernel parameter) into the cache.
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- asynchronous copies (cp.async), completing by commit group ----

// `Bytes` (4, 8 or 16) from global `src` to shared `dst`, both aligned to
// `Bytes`; 16-byte copies bypass L1.
template <int Bytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                 :: "r"(dst), "l"(src), "n"(Bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Waits until at most N of this thread's commit groups are incomplete.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// ---- ldmatrix: four 8x8 b16 matrices, lanes 8i..8i+7 giving the 16-byte
// row addresses of matrix i; r[i] holds matrix i's row lane / 4, elements
// 2 (lane % 4) and 2 (lane % 4) + 1 (with .trans: of the transpose) ----

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- shared stores ----

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
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

// d += a b for a 16x16 (row) by 16x8 (col) bf16 tile; the products are
// exact in fp32 and summed in fp32.  Fragments (g = lane / 4,
// t = lane % 4), two bf16 a word, the lower column in the low half:
// a = A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..];
// b = B[2t..][g], B[2t+8..][g]; d as in mma_tf32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 warpgroup products (wgmma) ----
//
// A warpgroup is 4 consecutive warps (128 threads).  Its fp32 accumulator
// of a 64 x N product holds, for warp w and lane (g = lane / 4,
// t = lane % 4), d[4j + 0..3] = D[16w + g][8j + 2t], D[16w + g][8j + 2t + 1],
// D[16w + g + 8][8j + 2t], D[16w + g + 8][8j + 2t + 1]: the mma.sync
// layout, one 8-column tile j after another.

// The shared-memory matrix descriptor of a tile laid down by TMA with the
// 128-byte swizzle (1024-byte atoms of 8 rows of 128 bytes), in 16-byte
// units: the start address; the stride byte offset, 1024 bytes from one
// 8-row group to the next (rows of a K-major operand, K of an MN-major one);
// the leading byte offset, unused here (1): it steps K inside a K-major
// atom, or across 64-element MN atoms of an MN-major operand 64 wide; and
// the swizzle mode (bits 62-63 = 1).  The base offset (bits 49-51) stays 0:
// every tile starts on a 1024-byte boundary, and a K step inside an atom
// only moves the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// Orders this thread's register writes (accumulators, A fragments) before
// the wgmma that read them.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until at most N committed wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across wgmma_fence / wgmma_wait (it cannot see the asynchronous writes).
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x N, fp32, the accumulator layout above) += A B^T for one k16
// step, N = 64, 96 or 128: A (64 x 16) and B (N x 16) both K-major in
// shared memory, read through the descriptors a and b.  accumulate = 0
// overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_ss(float (&d)[N / 2],
                                                  uint64_t a, uint64_t b,
                                                  int accumulate);

template <>
__device__ __forceinline__ void wgmma_m64nNk16_ss<64>(float (&d)[32],
                                                     uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_ss<96>(float (&d)[48],
                                                     uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_m64nNk16_ss<128>(float (&d)[64],
                                                     uint64_t a, uint64_t b,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, fp32) += A B for one k16 step: A (64 x 16 bf16) from
// registers in the accumulator's row order (a[0] = A[g][2t..2t+1],
// a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..] for warp
// w's rows 16w..16w+15), B (16 x 64) MN-major in shared memory (the
// transpose bit set).  accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                   const uint32_t (&a)[4],
                                                   uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

}  // namespace ptx
