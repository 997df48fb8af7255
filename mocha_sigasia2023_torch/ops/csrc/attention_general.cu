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
// l = sum exp(s - m) in fp32, P = exp(s - m) / l rounded to v's dtype, P v
// summed in fp32, the output rounded to q's dtype.  Two passes over the keys
// keep that rounding: the first finds m and l (l rescaled when a later tile
// raises m), the second forms P from the final m and l and multiplies it
// into v.  Flash attention's single pass would round the unnormalised
// exp(s - m) to bf16 and divide at the end, which the TPU kernel does not.
//
// What bounds it on an H100: nothing tuned.  It is the simple kernel that is
// right first: every product runs on the CUDA cores in fp32 FMA, the logits
// are computed twice (once a pass) and once more for each 64-column block of
// the output, and q, k and v are staged through shared memory by plain
// loads.  No tensor cores and no TMA, so nothing about the layout is
// required beyond element alignment.  Its times are in PERF.md beside its
// bound; making it fast is later work.
//
// Design.  One CTA of 256 threads per (batch, head, 16 query rows, 64 output
// columns), in a 1-D grid (column blocks innermost, so the CTAs that share a
// head's keys run together and find them in L2).
//   * Thread t owns query row t / 16 and keys (or output columns)
//     (t % 16) + 16 i, i < 4; the 16 threads of a row are a half warp, so a
//     row's max and sum reduce with four shuffles.
//   * A key tile is 64 keys.  Its logits accumulate over the head dim in
//     64-column chunks of q (16 x 64) and k (64 x 64) staged in shared memory
//     (rows padded by one float against bank conflicts); columns past d and
//     keys past M are staged as zeros, and keys past M are left out of the
//     max, the sum and P.
//   * The second pass writes the tile's P (16 x 64) and v's 64 x 64 block of
//     the CTA's output columns to shared memory and each thread sums its four
//     outputs in fp32 over the tile's keys.
// Shared memory is 40.3 KB whatever N, M and d are, so no shape is refused.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;     // query rows a CTA
constexpr int kCols = 64;     // output columns a CTA
constexpr int kKeys = 64;     // keys a tile
constexpr int kDepth = 64;    // head-dim columns of q and k staged at a time
constexpr int kThreads = 256;
constexpr int kPer = 4;       // logits (or outputs) a thread
constexpr int kLanes = 16;    // threads that share a query row

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
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

struct Params {
  long long q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  int H, N, M, D;
  int row_blocks, col_blocks;
  float scale;
};

struct Smem {
  float q[kRows][kDepth + 1];
  float k[kKeys][kDepth + 1];
  float v[kKeys][kCols];
  float p[kRows][kKeys + 1];
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Thread t's four logits of the key tile at key0: (q_row . k_key) * scale
// over all of d, in one fixed order, so both passes get the same values.
template <typename T>
__device__ void tile_logits(Smem& sm, const Params& p, const T* qb,
                            const T* kb, int row0, int key0,
                            float s[kPer]) {
  const int t = threadIdx.x, r = t / kLanes, j = t % kLanes;
#pragma unroll
  for (int i = 0; i < kPer; ++i) s[i] = 0.f;
  for (int c0 = 0; c0 < p.D; c0 += kDepth) {
    __syncthreads();  // the last readers of the staged tiles are done
    for (int e = t; e < kRows * kDepth; e += kThreads) {
      const int rr = e / kDepth, cc = e % kDepth;
      const int row = row0 + rr, col = c0 + cc;
      sm.q[rr][cc] = (row < p.N && col < p.D)
                         ? to_f32(qb[(long long)row * p.q_sn + col])
                         : 0.f;
    }
    for (int e = t; e < kKeys * kDepth; e += kThreads) {
      const int jj = e / kDepth, cc = e % kDepth;
      const int key = key0 + jj, col = c0 + cc;
      sm.k[jj][cc] = (key < p.M && col < p.D)
                         ? to_f32(kb[(long long)key * p.k_sn + col])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll 16
    for (int c = 0; c < kDepth; ++c) {
      const float qv = sm.q[r][c];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        s[i] = fmaf(qv, sm.k[j + kLanes * i][c], s[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) s[i] *= p.scale;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_general(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      const Params p) {
  __shared__ Smem sm;
  long long id = blockIdx.x;
  const int cb = (int)(id % p.col_blocks);
  id /= p.col_blocks;
  const int rb = (int)(id % p.row_blocks);
  const long long bh = id / p.row_blocks;
  const long long b = bh / p.H, h = bh % p.H;
  const int row0 = rb * kRows, col0 = cb * kCols;
  const T* qb = q + b * p.q_sb + h * p.q_sh;
  const T* kb = k + b * p.k_sb + h * p.k_sh;
  const T* vb = v + b * p.v_sb + h * p.v_sh;
  const int t = threadIdx.x, r = t / kLanes, j = t % kLanes;

  // pass 1: the row max and the row sum of exp(s - max)
  float m = -INFINITY, l = 0.f;
  for (int key0 = 0; key0 < p.M; key0 += kKeys) {
    float s[kPer];
    tile_logits(sm, p, qb, kb, row0, key0, s);
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (key0 + j + kLanes * i < p.M) tmax = fmaxf(tmax, s[i]);
    const float mnew = fmaxf(m, half_warp_max(tmax));
    float tsum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if (key0 + j + kLanes * i < p.M) tsum += expf(s[i] - mnew);
    l = l * expf(m - mnew) + half_warp_sum(tsum);
    m = mnew;
  }

  // pass 2: P = exp(s - max) / sum in v's dtype, then P v in fp32
  float acc[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) acc[i] = 0.f;
  for (int key0 = 0; key0 < p.M; key0 += kKeys) {
    float s[kPer];
    tile_logits(sm, p, qb, kb, row0, key0, s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const bool valid = key0 + j + kLanes * i < p.M;
      sm.p[r][j + kLanes * i] =
          valid ? to_f32(from_f32<T>(expf(s[i] - m) / l)) : 0.f;
    }
    for (int e = t; e < kKeys * kCols; e += kThreads) {
      const int jj = e / kCols, cc = e % kCols;
      const int key = key0 + jj, col = col0 + cc;
      sm.v[jj][cc] = (key < p.M && col < p.D)
                         ? to_f32(vb[(long long)key * p.v_sn + col])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < kKeys; ++jj) {
      const float pv = sm.p[r][jj];
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        acc[i] = fmaf(pv, sm.v[jj][j + kLanes * i], acc[i]);
    }
  }

  const int row = row0 + r;
  if (row < p.N) {
    T* ob = o + b * p.o_sb + h * p.o_sh + (long long)row * p.o_sn;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int col = col0 + j + kLanes * i;
      if (col < p.D) ob[col] = from_f32<T>(acc[i]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           long long q_sb, long long q_sh, long long q_sn, long long k_sb,
           long long k_sh, long long k_sn, long long v_sb, long long v_sh,
           long long v_sn, long long o_sb, long long o_sh, long long o_sn,
           int B, int H, int N, int M, int D, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || M < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (N + kRows - 1) / kRows;
  const int col_blocks = (D + kCols - 1) / kCols;
  const long long blocks = (long long)B * H * row_blocks * col_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Params p{q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb, v_sh, v_sn,
                 o_sb, o_sh, o_sn, H, N, M, D, row_blocks, col_blocks,
                 scale};
  attention_general<T><<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, p);
  return (int)cudaGetLastError();
}

}  // namespace

#define MOCHA_GENERAL_ENTRY(NAME, T)                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, \
                      long long q_sb, long long q_sh, long long q_sn,       \
                      long long k_sb, long long k_sh, long long k_sn,       \
                      long long v_sb, long long v_sh, long long v_sn,       \
                      long long o_sb, long long o_sh, long long o_sn,       \
                      int B, int H, int N, int M, int D, float scale,       \
                      void* stream) {                                       \
    return launch<T>(q, k, v, o, q_sb, q_sh, q_sn, k_sb, k_sh, k_sn, v_sb,  \
                     v_sh, v_sn, o_sb, o_sh, o_sn, B, H, N, M, D, scale,    \
                     stream);                                               \
  }

MOCHA_GENERAL_ENTRY(mocha_attention_general_f32, float)
MOCHA_GENERAL_ENTRY(mocha_attention_general_bf16, __nv_bfloat16)
