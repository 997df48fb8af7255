// Fused multi-head attention for every shape the tuned kernels do not take,
// fp32 or bf16 in and out.
//
// Replaces the TPU kernel mocha_sigasia2023_tpu/ops/attention.py::_attn_kernel
// (launched by fused_attention, pl.pallas_call at :63) outside the envelope of
// attention.cu and attention_bf16.cu: more than 128 keys, a head dim that is
// not a multiple of 64, or a start or (batch, head, row) stride that is not
// 16-byte aligned, so that TMA cannot copy it.  The JAX kernel takes any
// (N, M, d) block; so does this one: any N, M, d >= 1 and any element
// strides on (batch, head, row) with a unit last stride.
//
// What it computes is what _attn_kernel computes, for each (batch, head):
// logits s = (q k^T) * scale in fp32, the row max m and the row sum
// l = sum exp(s - m) in fp32, P = exp(s - m) / l rounded to v's dtype from
// the final m and l, P v summed in fp32, the output rounded to q's dtype.
//
// What bounds it on an H100: at the shapes that reach it (the 120-frame
// config's encoder chunk, B*H = 512, N = M = 180, d = 96) the bytes: q, k
// and v read once and o written once take 42.3 us in fp32 and 21.1 us in
// bf16 at 3.35 TB/s, the products 12.9 us at the TF32 rate (38.6 us in
// 3xTF32) and 6.5 us at the bf16 rate.  So the design reads each head's
// q, k and v into shared memory with coalesced asynchronous copies that
// overlap the products, computes every logit once, and keeps both
// products on the tensor cores so that they stay under the copies.  As
// built it stays well above that bound (PERF.md): a CTA keeps its rows'
// fp32 logits in shared memory (48 KB at 180 keys), so two or three CTAs
// (8-12 warps) share an SM, and each 32-key step of copies and products
// runs behind one barrier with little to overlap it; the general variants
// of scripts/attention_ablation.py show the copies and the loop around
// them as the largest part.  Deeper rings and larger or smaller row blocks
// did not move it.
//
// Numerics: fp32 products run in 3xTF32 (x = big + small, big = tf32(x),
// a b ~ a_small b_big + a_big b_small + a_big b_big, mma.sync.m16n8k8 with
// fp32 accumulation), the logits summed per 32 head-dim columns and the
// sums added in fp32, as attention.cu does: single-pass TF32 misses the
// fp32 contract (atol 2e-5 / rtol 1e-4).  bf16 products run in
// mma.sync.m16n8k16, exact products summed in fp32, as the TPU kernel's
// are.  The logits are kept in base 2, (q k^T) * (scale * log2 e), so that
// e = exp(s - m) is exp2f of their difference; P = e / l is a reciprocal
// and one correction (div_by), which rounds as division does.
//
// Design.  `general_plan` in ops/attention.py lays out each call and
// passes the plan here; it keeps shared memory under 227 KB whatever N, M
// and d are, so no shape is refused.
//   * A CTA of rows / 16 warps owns a block of up to 64 query rows and all
//     of d; warp w owns rows 16w..16w+15 across every key, so a row's max
//     and sum reduce over the quad of lanes that hold it, never across
//     warps.  A 1-D grid of (batch, head, row block) items, row blocks
//     innermost so that the CTAs that share a head's keys run together and
//     find them in L2.  The grid is at most 2^20 CTAs, and a CTA walks
//     items in steps of the grid, so any count of items runs.
//   * The head dim is padded with zeros in shared memory to the MMA depth
//     (8 fp32, 16 bf16).  Up to 128 columns, q is staged once and stays;
//     past that, q and k are staged in 128-column chunks, q beside each k
//     chunk.  k and v stream in tiles of 32 keys (four 8-key MMA tiles)
//     through two buffers: load i + 1 is in flight (cp.async) while load
//     i is multiplied.  Keys past M are staged as zeros and masked out of
//     the max, the sum and P.
//   * Copies follow each view's pointers and strides: 16-byte cp.async
//     where the start and the (batch, head, row) strides are 16-byte
//     aligned (the generator's (B, N, H, d) projections at d = 32, 96 and
//     128), else 8- or 4-byte cp.async, else plain loads (bf16 views at an
//     odd element offset); the last columns of a row that do not fill a
//     copy are plain loads.  Staged rows sit 16 bytes apart modulo 128
//     (fp32) or an odd multiple of 16 bytes (bf16), so the fp32 fragment
//     loads and bf16 ldmatrix hit every bank once.
//   * Resident path (the plan's `resident`: the CTA's fp32 logit rows for
//     all M keys fit beside q and two buffers in half an SM's shared
//     memory, so that two CTAs still share an SM; past that the two-pass
//     path ran faster on an H100): each 32-key tile of logits is computed
//     once and stored in shared memory in the order its thread holds it,
//     so the softmax never leaves the thread and its
//     quad: the max while storing, then e = exp(s - m) and the sum over
//     the same words.  P v then runs over every column block of v, each
//     tile's e read back by the thread that wrote it and rounded to P =
//     e / l in v's dtype from the final max and sum, without computing a
//     logit again.  v's first tile loads while the softmax runs.
//   * Two-pass path (longer rows): the first pass keeps each thread's
//     running max and sum (rescaled when a tile raises the max) and
//     combines them over the quad; the second computes each tile's logits
//     again, forms P in registers and multiplies it straight into the
//     tile's v block, staged in the same buffer as its last k chunk, so a
//     tile is one step (with more than one column block, the logits once
//     a block).
//   * P v takes P as the A fragment in the order the logits' accumulators
//     hold it: fp32 A columns t and t + 4 are keys 2t and 2t + 1 (the
//     order of k within one MMA is free, and v is read in that order);
//     bf16 two 8-key tiles make one k16 step, v read by ldmatrix.trans.
//   * Each warp writes its 16 rows of an output block straight into the
//     output view, column pairs as one access where the view allows it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kKeys = 32;          // keys a staged tile of k or v
constexpr int kKeyTiles = kKeys / 8;
constexpr int kSumCols = 32;       // fp32 logits summed per 32 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxRows = 64;       // query rows a CTA, 16 a warp
constexpr int kSmemLimit = 232448;
constexpr int kMaxDevices = 64;
constexpr long long kMaxGrid = 1 << 20;  // CTAs; past it a CTA takes more items

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  long long items;  // B * H * row_blocks
  int H, N, M, D, row_blocks;
  float scale_log2;  // scale * log2(e): the logits in base 2
  // the plan (ops/attention.py GeneralPlan), widths in elements
  int rows, depth, chunk, chunks, col_block, col_blocks;
  int q_stride, c_stride, v_stride, buffer, keys;
  // per call: bytes of one asynchronous copy of q, k, v (16, 8, 4; 0 for
  // plain loads), and whether output column pairs are one access
  int q_vec, k_vec, v_vec, o_pairs;
};

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and back: P in v's dtype, kept as an fp32 word.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// e / sum as fp32 division rounds it, given inv = 1 / sum rounded (the
// same Markstein correction as attention_bf16.cu).
__device__ __forceinline__ float div_by(float e, float sum, float inv) {
  const float q = e * inv;
  return fmaf(fmaf(-sum, q, e), inv, q);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows x cols (cols a multiple of the MMA depth) of a row-major view
// into shared memory at `dst` (row stride dst_stride): row r < valid_rows,
// column c < valid_cols comes from src[r * src_stride + c], everything
// else is zero.  vec bytes a copy (16, 8, 4: cp.async; 0: plain loads).
// The threads cover a row's copies side by side and step down the rows
// (one division a call; pointers advance by a fixed step).
template <typename T>
__device__ __forceinline__ void stage(T* dst, int dst_stride, const T* src,
                                      long long src_stride, int rows,
                                      int valid_rows, int cols,
                                      int valid_cols, int vec) {
  const int unit = vec ? vec / (int)sizeof(T) : 1;
  const int per_row = min(cols / unit, (int)blockDim.x);  // threads a row
  const int row_step = blockDim.x / per_row;
  const int r0 = threadIdx.x / per_row;
  if (r0 >= row_step) return;
  const int c0 = (threadIdx.x - r0 * per_row) * unit;
  T* d_row = dst + r0 * dst_stride;
  const T* s_row = src + r0 * src_stride;
  for (int r = r0; r < rows; r += row_step) {
    for (int c = c0; c < cols; c += per_row * unit) {
      T* d = d_row + c;
      const T* s = s_row + c;
      if (r < valid_rows && c + unit <= valid_cols) {
        const uint32_t a = ptx::smem_addr(d);
        if (vec == 16) ptx::cp_async<16>(a, s);
        else if (vec == 8) ptx::cp_async<8>(a, s);
        else if (vec == 4) ptx::cp_async<4>(a, s);
        else *d = *s;
      } else {
        for (int u = 0; u < unit; ++u)
          d[u] = (r < valid_rows && c + u < valid_cols) ? s[u]
                                                        : from_f32<T>(0.f);
      }
    }
    d_row += row_step * dst_stride;
    s_row += row_step * src_stride;
  }
}

// part[j] += q k_j^T over the 8 head-dim columns at col, in 3xTF32, for
// the warp's 16 query rows at q (row stride qs) and the tile's 32 keys at
// k (row stride ks).  The order of k within one MMA is free: A columns t
// and t + 4 (B rows t and t + 4) are head-dim columns 2t and 2t + 1, so
// each fragment pair is one 8-byte load.
__device__ __forceinline__ void qk_step(const float* q, int qs, const float* k,
                                        int ks, int col, int g, int t,
                                        float (&part)[kKeyTiles][4]) {
  const float2 lo = *reinterpret_cast<const float2*>(q + g * qs + col + 2 * t);
  const float2 hi =
      *reinterpret_cast<const float2*>(q + (g + 8) * qs + col + 2 * t);
  uint32_t ab[4], as[4];
  ptx::split_tf32(lo.x, ab[0], as[0]);  // A[g][t]:     row g,   column 2t
  ptx::split_tf32(hi.x, ab[1], as[1]);  // A[g+8][t]:   row g+8, column 2t
  ptx::split_tf32(lo.y, ab[2], as[2]);  // A[g][t+4]:   row g,   column 2t+1
  ptx::split_tf32(hi.y, ab[3], as[3]);  // A[g+8][t+4]: row g+8, column 2t+1
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    const float2 kb =
        *reinterpret_cast<const float2*>(k + (8 * j + g) * ks + col + 2 * t);
    uint32_t bb[2], bs[2];
    ptx::split_tf32(kb.x, bb[0], bs[0]);  // B[t][g]:   key g, column 2t
    ptx::split_tf32(kb.y, bb[1], bs[1]);  // B[t+4][g]: key g, column 2t+1
    ptx::mma_tf32x3(part[j], ab, as, bb, bs);
  }
}

// acc[j] += q k_j^T over `width` head-dim columns (a multiple of 8), each
// 32 columns summed apart and then added; a full 32 columns unrolled with
// no guard, so that the products of its steps interleave.
__device__ __forceinline__ void qk_tile(const float* q, int qs, const float* k,
                                        int ks, int width, int g, int t,
                                        float (&acc)[kKeyTiles][4]) {
  for (int c0 = 0; c0 < width; c0 += kSumCols) {
    float part[kKeyTiles][4] = {};
    if (width - c0 >= kSumCols) {
#pragma unroll
      for (int kk = 0; kk < kSumCols; kk += 8)
        qk_step(q, qs, k, ks, c0 + kk, g, t, part);
    } else {
      for (int kk = 0; kk < width - c0; kk += 8)
        qk_step(q, qs, k, ks, c0 + kk, g, t, part);
    }
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

// The same in bf16: A from ldmatrix of q's rows, B from ldmatrix of k's
// rows (two 8-key tiles a load), `width` a multiple of 16.
__device__ __forceinline__ void qk_tile(const __nv_bfloat16* q, int qs,
                                        const __nv_bfloat16* k, int ks,
                                        int width, int g, int t,
                                        float (&acc)[kKeyTiles][4]) {
  const int lane = threadIdx.x % 32;
  const uint32_t qa = ptx::smem_addr(q + (lane & 15) * qs + (lane >> 4) * 8);
  const uint32_t kb = ptx::smem_addr(
      k + ((lane & 7) + ((lane >> 4) << 3)) * ks + ((lane >> 3) & 1) * 8);
#pragma unroll 2
  for (int c = 0; c < width; c += 16) {
    uint32_t a[4];
    ptx::ldmatrix_x4(a, qa + 2 * c);
#pragma unroll
    for (int j = 0; j < kKeyTiles; j += 2) {
      uint32_t b[4];
      ptx::ldmatrix_x4(b, kb + 2 * (16 * (j / 2) * ks + c));
      ptx::mma_bf16(acc[j], a, b[0], b[1]);
      ptx::mma_bf16(acc[j + 1], a, b[2], b[3]);
    }
  }
}

// out[n] += P v[:, 8n..8n+7] for the tile's 32 keys and the NT output
// tiles of a column block (no guard: columns past d are staged as zeros),
// P in the logits' accumulator order, v's tile at v (row stride vs), in
// 3xTF32.
template <int NT>
__device__ __forceinline__ void pv_tile(const float (&p)[kKeyTiles][4],
                                        const float* v, int vs, int g, int t,
                                        float (&out)[NT][4]) {
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    uint32_t ab[4], as[4];
    ptx::split_tf32(p[j][0], ab[0], as[0]);  // row g,   key 2t
    ptx::split_tf32(p[j][2], ab[1], as[1]);  // row g+8, key 2t
    ptx::split_tf32(p[j][1], ab[2], as[2]);  // row g,   key 2t+1
    ptx::split_tf32(p[j][3], ab[3], as[3]);  // row g+8, key 2t+1
    const float* vb = v + (8 * j + 2 * t) * vs + g;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t bb[2], bs[2];
      ptx::split_tf32(vb[8 * n], bb[0], bs[0]);       // key 2t
      ptx::split_tf32(vb[vs + 8 * n], bb[1], bs[1]);  // key 2t+1
      ptx::mma_tf32x3(out[n], ab, as, bb, bs);
    }
  }
}

// The same in bf16 (NT even): keys 16s..16s+15 are one k16 step, P's
// 8-key tiles 2s and 2s + 1 its A fragment, v's B fragments two output
// tiles a ldmatrix.trans.
template <int NT>
__device__ __forceinline__ void pv_tile(const float (&p)[kKeyTiles][4],
                                        const __nv_bfloat16* v, int vs, int g,
                                        int t, float (&out)[NT][4]) {
  const int lane = threadIdx.x % 32;
  const uint32_t vb = ptx::smem_addr(
      v + ((lane & 7) + ((lane >> 3) & 1) * 8) * vs + (lane >> 4) * 8);
#pragma unroll
  for (int s = 0; s < kKeyTiles / 2; ++s) {
    const uint32_t a[4] = {ptx::pack_bf16x2(p[2 * s][0], p[2 * s][1]),
                           ptx::pack_bf16x2(p[2 * s][2], p[2 * s][3]),
                           ptx::pack_bf16x2(p[2 * s + 1][0], p[2 * s + 1][1]),
                           ptx::pack_bf16x2(p[2 * s + 1][2], p[2 * s + 1][3])};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ptx::ldmatrix_x4_trans(b, vb + 2 * (16 * s * vs + 8 * n));
      ptx::mma_bf16(out[n], a, b[0], b[1]);
      ptx::mma_bf16(out[n + 1], a, b[2], b[3]);
    }
  }
}

// Which load comes next in an item, in the order the compute consumes
// them: first the logits' loads (block < 0; key tile, chunk), then per
// column block either its v tiles (resident) or, per key tile, its chunks
// again, the last with the tile's v block beside it (two-pass).  Advanced
// once a load, so that no load divides its index.
struct Cursor {
  int block = -1, tile = 0, part = 0;

  template <bool kResident>
  __device__ __forceinline__ void advance(int chunks, int tiles) {
    if ((kResident && block >= 0) || ++part == chunks) {
      part = 0;
      if (++tile == tiles) {
        tile = 0;
        ++block;
      }
    }
  }
};

template <typename T, int NT, bool kResident>
__global__ void __launch_bounds__(kMaxRows * 2)
    attention_general(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* q_res = reinterpret_cast<T*>(smem);  // q, when one chunk holds d
  T* buf0 = q_res + (p.chunks == 1 ? p.rows * p.q_stride : 0);
  float4* logits = reinterpret_cast<float4*>(buf0 + 2 * p.buffer);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int tiles = p.keys / kKeys;
  const int loads =
      tiles * (p.chunks + p.col_blocks * (kResident ? 1 : p.chunks));
  // a buffer: a k chunk (after its q chunk when d takes more than one),
  // then, two-pass, a v block
  const int k_part =
      (p.chunks > 1 ? p.rows * p.c_stride : 0) + kKeys * p.c_stride;
  // this warp's logits, one float4 (an 8-key MMA tile) a lane
  float4* my_logits = logits + warp * (p.keys / 8) * 32 + lane;

  for (long long item = blockIdx.x; item < p.items; item += gridDim.x) {
    __syncthreads();  // the last item's reads of q and the ring are done
    const long long bh = item / p.row_blocks;
    const int row0 = (int)(item - bh * p.row_blocks) * p.rows;
    const long long b = bh / p.H, h = bh - b * p.H;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                  row0 * p.q_sn;
    const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    const int q_rows = min(p.rows, p.N - row0);

    Cursor cur;  // the next load to issue
    auto issue = [&](int i) {
      T* dst = buf0 + (i & 1) * p.buffer;
      const int key0 = cur.tile * kKeys, keys = min(kKeys, p.M - key0);
      auto stage_v = [&](T* to) {
        const int col0 = cur.block * p.col_block;
        stage(to, p.v_stride, vb + key0 * p.v_sn + col0, p.v_sn, kKeys, keys,
              p.col_block, p.D - col0, p.v_vec);
      };
      if (kResident && cur.block >= 0) {
        stage_v(dst);
      } else {
        if (p.chunks == 1) {
          if (i == 0)
            stage(q_res, p.q_stride, qb, p.q_sn, p.rows, q_rows, p.depth,
                  p.D, p.q_vec);
          stage(dst, p.c_stride, kb + key0 * p.k_sn, p.k_sn, kKeys, keys,
                p.depth, p.D, p.k_vec);
        } else {
          const int col0 = cur.part * p.chunk;
          const int width = min(p.chunk, p.depth - col0);
          stage(dst, p.c_stride, qb + col0, p.q_sn, p.rows, q_rows, width,
                p.D - col0, p.q_vec);
          stage(dst + p.rows * p.c_stride, p.c_stride,
                kb + key0 * p.k_sn + col0, p.k_sn, kKeys, keys, width,
                p.D - col0, p.k_vec);
        }
        if (!kResident && cur.block >= 0 && cur.part == p.chunks - 1)
          stage_v(dst + k_part);
      }
      cur.advance<kResident>(p.chunks, tiles);
    };

    // Two buffers: load i + 1 is in flight while load i is multiplied.
    // It goes into the buffer of load i - 1, which every thread finished
    // with before the __syncthreads that opens step i.
    int i = 0;
    issue(0);
    ptx::cp_async_commit();
    auto next = [&]() -> const T* {
      ptx::cp_async_wait<0>();
      __syncthreads();
      if (i + 1 < loads) issue(i + 1);
      ptx::cp_async_commit();
      return buf0 + (i & 1) * p.buffer;
    };
    auto done = [&]() { ++i; };

    // S = q k^T for key tile j over every chunk, scaled to base 2 (so that
    // exp(s - m) is one exp2f), keys past M at -inf: the warp's 16 rows,
    // rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 8jj + 2t (+1).  Returns
    // the buffer of the last chunk, which stays staged until the next
    // call of next().
    auto logit_tile = [&](int j, float (&s)[kKeyTiles][4]) -> const T* {
      const T* st = nullptr;
#pragma unroll
      for (int jj = 0; jj < kKeyTiles; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[jj][e] = 0.f;
      for (int c = 0; c < p.chunks; ++c) {
        st = next();
        // q resident (one chunk) or staged before the k chunk
        const bool one = p.chunks == 1;
        const T* qw = one ? q_res + warp * 16 * p.q_stride
                          : st + warp * 16 * p.c_stride;
        const T* kw = one ? st : st + p.rows * p.c_stride;
        qk_tile(qw, one ? p.q_stride : p.c_stride, kw, p.c_stride,
                min(p.chunk, p.depth - c * p.chunk), g, t, s);
        done();
      }
#pragma unroll
      for (int jj = 0; jj < kKeyTiles; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = j * kKeys + 8 * jj + 2 * t + (e & 1);
          s[jj][e] = key < p.M ? s[jj][e] * p.scale_log2 : -INFINITY;
        }
      return st;
    };

    // the output block at column col0: rows g and g + 8 of the warp
    auto store = [&](const float (&out)[NT][4], int col0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + warp * 16 + g + 8 * half;
        if (row >= p.N) continue;
        T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh +
                row * p.o_sn;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = col0 + 8 * n + 2 * t;
          if (col >= p.D) continue;
          const T x0 = from_f32<T>(out[n][2 * half]);
          const T x1 = from_f32<T>(out[n][2 * half + 1]);
          if (p.o_pairs && col + 1 < p.D) {
            if constexpr (sizeof(T) == 4)
              *reinterpret_cast<float2*>(ob + col) = make_float2(x0, x1);
            else
              *reinterpret_cast<__nv_bfloat162*>(ob + col) =
                  __halves2bfloat162(x0, x1);
          } else {
            ob[col] = x0;
            if (col + 1 < p.D) ob[col + 1] = x1;
          }
        }
      }
    };

    float mx[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    if constexpr (kResident) {
      // logits once, into shared memory, with each thread's row max
      for (int j = 0; j < tiles; ++j) {
        float s[kKeyTiles][4];
        logit_tile(j, s);
#pragma unroll
        for (int jj = 0; jj < kKeyTiles; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[jj][e]);
          my_logits[(j * kKeyTiles + jj) * 32] =
              make_float4(s[jj][0], s[jj][1], s[jj][2], s[jj][3]);
        }
      }
      // e = exp(s - m) and the sum over the words this thread wrote (v's
      // first tile is loading meanwhile)
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
#pragma unroll 4
      for (int j = 0; j < p.keys / 8; ++j) {
        float4 x = my_logits[j * 32];
        x.x = exp2f(x.x - mx[0]);
        x.y = exp2f(x.y - mx[0]);
        x.z = exp2f(x.z - mx[1]);
        x.w = exp2f(x.w - mx[1]);
        sum[0] += x.x + x.y;
        sum[1] += x.z + x.w;
        my_logits[j * 32] = x;
      }
      sum[0] = quad_sum(sum[0]);
      sum[1] = quad_sum(sum[1]);
      const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
      // P v, column block by column block, P = e / l in v's dtype formed
      // from the final max and sum as each tile's e is read back
      for (int cb = 0; cb < p.col_blocks; ++cb) {
        const int col0 = cb * p.col_block;
        float out[NT][4] = {};
        for (int j = 0; j < tiles; ++j) {
          float pt[kKeyTiles][4];
#pragma unroll
          for (int jj = 0; jj < kKeyTiles; ++jj) {
            const float4 x = my_logits[(j * kKeyTiles + jj) * 32];
            pt[jj][0] = round_to<T>(div_by(x.x, sum[0], inv0));
            pt[jj][1] = round_to<T>(div_by(x.y, sum[0], inv0));
            pt[jj][2] = round_to<T>(div_by(x.z, sum[1], inv1));
            pt[jj][3] = round_to<T>(div_by(x.w, sum[1], inv1));
          }
          const T* st = next();
          pv_tile<NT>(pt, st, p.v_stride, g, t, out);
          done();
        }
        store(out, col0);
      }
    } else {
      // pass 1: each thread's running max and sum, then the quad's
      for (int j = 0; j < tiles; ++j) {
        float s[kKeyTiles][4];
        logit_tile(j, s);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < kKeyTiles; ++jj)
            tmax = fmaxf(tmax, fmaxf(s[jj][2 * r], s[jj][2 * r + 1]));
          const float mnew = fmaxf(mx[r], tmax);
          if (mnew == -INFINITY) continue;  // no key of this thread yet
          float tsum = 0.f;
#pragma unroll
          for (int jj = 0; jj < kKeyTiles; ++jj)
            tsum += exp2f(s[jj][2 * r] - mnew) +
                    exp2f(s[jj][2 * r + 1] - mnew);
          sum[r] = sum[r] * exp2f(mx[r] - mnew) + tsum;
          mx[r] = mnew;
        }
      }
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m = quad_max(mx[r]);
        sum[r] = quad_sum(mx[r] == -INFINITY ? 0.f
                                             : sum[r] * exp2f(mx[r] - m));
        mx[r] = m;
        inv[r] = 1.f / sum[r];
      }
      // pass 2: P = e / l in v's dtype from the logits again, then P v
      // with the v block staged beside the tile's last k chunk
      for (int cb = 0; cb < p.col_blocks; ++cb) {
        const int col0 = cb * p.col_block;
        float out[NT][4] = {};
        for (int j = 0; j < tiles; ++j) {
          float s[kKeyTiles][4];
          const T* st = logit_tile(j, s);
#pragma unroll
          for (int jj = 0; jj < kKeyTiles; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              s[jj][e] = round_to<T>(
                  div_by(exp2f(s[jj][e] - mx[r]), sum[r], inv[r]));
            }
          pv_tile<NT>(s, st + k_part, p.v_stride, g, t, out);
        }
        store(out, col0);
      }
    }
  }
}

// Bytes of one asynchronous copy of a (B, H, rows, D) view: the largest of
// 16, 8 and 4 that divides its start and every (batch, head, row) stride
// in bytes (a dimension of extent 1 is never stepped); 0 for plain loads.
int copy_bytes(const void* ptr, long long sb, int B, long long sh, int H,
               long long sn, int rows, int esize) {
  for (int vec = 16; vec >= 4; vec /= 2) {
    auto ok = [&](long long s, int n) {
      return n == 1 || s * esize % vec == 0;
    };
    if ((uintptr_t)ptr % vec == 0 && ok(sb, B) && ok(sh, H) && ok(sn, rows))
      return vec;
  }
  return 0;
}

template <typename T, int NT, bool kResident>
int launch_instance(const Params& p, int threads, int smem, unsigned blocks,
                    cudaStream_t stream) {
  // once per device: shared memory above 48 KB needs the attribute (the
  // plan's smem is at most kSmemLimit), and the largest carveout lets
  // CTAs share an SM
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= kMaxDevices || !configured[dev])) {
    e = cudaFuncSetAttribute(attention_general<T, NT, kResident>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_general<T, NT, kResident>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  attention_general<T, NT, kResident><<<blocks, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int NT>
int launch_path(const Params& p, int resident, int threads, int smem,
                unsigned blocks, cudaStream_t s) {
  return resident ? launch_instance<T, NT, true>(p, threads, smem, blocks, s)
                  : launch_instance<T, NT, false>(p, threads, smem, blocks, s);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           long long q_sb, long long q_sh, long long q_sn, long long k_sb,
           long long k_sh, long long k_sn, long long v_sb, long long v_sh,
           long long v_sn, long long o_sb, long long o_sh, long long o_sn,
           int B, int H, int N, int M, int D, float scale, const int* plan,
           void* stream) {
  if (B < 1 || H < 1 || N < 1 || M < 1 || D < 1 || plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const int rows = plan[0], depth = plan[1], chunk = plan[2],
            chunks = plan[3], col_block = plan[4], col_blocks = plan[5],
            q_stride = plan[6], c_stride = plan[7], v_stride = plan[8],
            buffer = plan[9], keys = plan[10], resident = plan[11],
            smem = plan[12], col_tiles = col_block / 8;
  const int step = sizeof(T) == 4 ? 8 : 16;
  // a plan that does not cover the call is refused without a launch
  if (rows < 16 || rows > kMaxRows || rows % 16 || depth < D ||
      depth % step || chunk % step || chunk * chunks < depth ||
      col_block < 32 || col_block > 128 || col_block % 32 ||
      col_block * col_blocks < depth || keys < M || keys % kKeys ||
      (chunks == 1 && q_stride < depth) || c_stride < chunk ||
      v_stride < col_block || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  const int esize = sizeof(T);
  const int k_part = (chunks > 1 ? rows * c_stride : 0) + kKeys * c_stride;
  const int v_part = kKeys * v_stride;
  if (buffer < (resident ? (k_part > v_part ? k_part : v_part)
                         : k_part + v_part))
    return (int)cudaErrorInvalidValue;
  if ((long long)smem < (long long)esize *
                            ((chunks == 1 ? rows * q_stride : 0) +
                             2LL * buffer) +
                        (resident ? 4LL * rows * keys : 0))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (N + rows - 1) / rows;
  const Params p{q, k, v, o, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                 v_sb, v_sh, v_sn, o_sb, o_sh, o_sn,
                 (long long)B * H * row_blocks, H, N, M, D, row_blocks,
                 scale * kLog2e,
                 rows, depth, chunk, chunks, col_block, col_blocks,
                 q_stride, c_stride, v_stride, buffer, keys,
                 copy_bytes(q, q_sb, B, q_sh, H, q_sn, N, esize),
                 copy_bytes(k, k_sb, B, k_sh, H, k_sn, M, esize),
                 copy_bytes(v, v_sb, B, v_sh, H, v_sn, M, esize),
                 copy_bytes(o, o_sb, B, o_sh, H, o_sn, N, esize) >= 2 * esize};
  const unsigned blocks =
      (unsigned)(p.items < kMaxGrid ? p.items : kMaxGrid);
  const int threads = rows * 2;  // a warp of 32 per 16 rows
  cudaStream_t s = (cudaStream_t)stream;
  switch (col_tiles) {
    case 4: return launch_path<T, 4>(p, resident, threads, smem, blocks, s);
    case 8: return launch_path<T, 8>(p, resident, threads, smem, blocks, s);
    case 12: return launch_path<T, 12>(p, resident, threads, smem, blocks, s);
  }
  return launch_path<T, 16>(p, resident, threads, smem, blocks, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  Takes
// any B, H, N, M, D >= 1 and element strides on (batch, head, row) with a
// unit last stride; `plan` points at the 13 ints of ops/attention.py's
// general_plan(N, M, D, dtype) (GeneralPlan's fields in order), and a
// plan that does not cover the call returns cudaErrorInvalidValue
// without a launch.
#define MOCHA_GENERAL_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      long long q_sb, long long q_sh, long long q_sn,       \
                      long long k_sb, long long k_sh, long long k_sn,       \
                      long long v_sb, long long v_sh, long long v_sn,       \
                      long long o_sb, long long o_sh, long long o_sn,       \
                      int B, int H, int N, int M, int D, float scale,       \
                      const int* plan, void* stream) {                      \
    return launch<T>(q, k, v, o, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb,  \
                     v_sh, v_sn, o_sb, o_sh, o_sn, B, H, N, M, D, scale,    \
                     plan, stream);                                         \
  }

MOCHA_GENERAL_ENTRY(mocha_attention_general_f32, float)
MOCHA_GENERAL_ENTRY(mocha_attention_general_bf16, __nv_bfloat16)
