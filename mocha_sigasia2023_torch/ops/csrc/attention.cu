// Fused multi-head attention, fp32, for the generator's 90-token blocks.
//
// Replaces the TPU kernel mocha_sigasia2023_tpu/ops/attention.py::_attn_kernel
// (launched by fused_attention, pl.pallas_call at :63).  For every
// (batch, head) it computes softmax(q k^T * scale) v: fp32 logits, the row
// max subtracted before exp, fp32 accumulation, output in fp32.
//
// What bounds it on an H100: at the main-path shapes (N = M = 90, d = 128
// or 256) one call moves q, k, v and o once (94 MB for the 64-stream
// decoder call) and does 2*2*N*M*d flops per head (2.1 GFLOP), so the
// roofline is about even between HBM (3.35 TB/s) and the fp32 FMA rate
// outside the tensor cores (67 TFLOP/s).  This kernel uses exact fp32 FMA,
// no TF32 and no tensor cores, so that it agrees with the fp32 reference to
// 2e-5; wgmma and TMA are a later step.
//
// Design: the TPU kernel holds one whole head (q, k, v: 3 x 90 x d) in VMEM.
// At d = 256 that is 3 x 92 KB, more than the 227 KB a block may use, so
// here one block owns 16 query rows of one head:
//   1. logits: q and k are staged 64 head-dim columns at a time in shared
//      memory; each thread owns one key column and 8 query rows and keeps
//      its 8 partial dot products in registers;
//   2. softmax: one warp per 2 rows, max and sum by warp shuffles;
//   3. P.V: v is staged 64 columns at a time; each thread owns one output
//      column and 4 rows.
// The key/value rows of one head are read by the ceil(N/16) blocks that
// share them, which find them in L2.  Shared memory is 45.5 KB a block.
// q, k, v and o are addressed through (batch, head, row) strides with a
// unit last stride, so the caller's (B, N, H, d) projections need no copy.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 16;        // query rows per block
constexpr int kChunk = 64;       // head-dim columns staged per pass
constexpr int kMaxKeys = 128;    // largest key count a block holds
constexpr int kThreads = 256;
constexpr int kKeyPad = kChunk + 1;  // row pad: a warp's 32 keys hit 32 banks
constexpr int kRowsPerKeyThread = kRows / (kThreads / kMaxKeys);  // 8
constexpr int kRowsPerColThread = kRows / (kThreads / kChunk);    // 4

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(kThreads)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     Strides sq, Strides sk, Strides sv, Strides so,
                     int H, int N, int M, int D, float scale) {
  __shared__ float qs[kRows][kChunk];
  __shared__ float kv[kMaxKeys][kKeyPad];
  __shared__ float ps[kRows][kMaxKeys];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int row0 = blockIdx.y * kRows;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  // ---- logits: thread -> key `key`, rows row_lo + 2*i ----
  const int key = tid % kMaxKeys;
  const int row_lo = tid / kMaxKeys;
  float acc[kRowsPerKeyThread];
#pragma unroll
  for (int i = 0; i < kRowsPerKeyThread; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < D; c0 += kChunk) {
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      qs[r][c] = (row0 + r < N) ? qb[(row0 + r) * sq.n + c0 + c] : 0.f;
    }
    for (int i = tid; i < M * kChunk; i += kThreads) {
      const int m = i / kChunk, c = i % kChunk;
      kv[m][c] = kb[m * sk.n + c0 + c];
    }
    __syncthreads();
    if (key < M) {
#pragma unroll 8
      for (int c = 0; c < kChunk; ++c) {
        const float kc = kv[key][c];
#pragma unroll
        for (int i = 0; i < kRowsPerKeyThread; ++i)
          acc[i] = fmaf(qs[row_lo + 2 * i][c], kc, acc[i]);
      }
    }
    __syncthreads();
  }
  if (key < M) {
#pragma unroll
    for (int i = 0; i < kRowsPerKeyThread; ++i) ps[row_lo + 2 * i][key] = acc[i] * scale;
  }
  __syncthreads();

  // ---- row softmax: warp w owns rows 2w and 2w+1 ----
  const int warp = tid / 32, lane = tid % 32;
  for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
    float mx = -INFINITY;
    for (int j = lane; j < M; j += 32) mx = fmaxf(mx, ps[r][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < M; j += 32) {
      const float e = expf(ps[r][j] - mx);
      ps[r][j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int j = lane; j < M; j += 32) ps[r][j] = ps[r][j] / sum;
  }
  __syncthreads();

  // ---- P.V: thread -> column `col`, rows row_v + 4*i ----
  const int col = tid % kChunk;
  const int row_v = tid / kChunk;
  for (int c0 = 0; c0 < D; c0 += kChunk) {
    for (int i = tid; i < M * kChunk; i += kThreads) {
      const int m = i / kChunk, c = i % kChunk;
      kv[m][c] = vb[m * sv.n + c0 + c];
    }
    __syncthreads();
    float out[kRowsPerColThread];
#pragma unroll
    for (int i = 0; i < kRowsPerColThread; ++i) out[i] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float vc = kv[m][col];
#pragma unroll
      for (int i = 0; i < kRowsPerColThread; ++i)
        out[i] = fmaf(ps[row_v + 4 * i][m], vc, out[i]);
    }
#pragma unroll
    for (int i = 0; i < kRowsPerColThread; ++i) {
      const int r = row0 + row_v + 4 * i;
      if (r < N) ob[r * so.n + c0 + col] = out[i];
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes B*H >= 1, N >= 1, 1 <= M <= 128 and D a positive multiple of 64;
// returns cudaErrorInvalidValue for anything else without launching.
extern "C" int mocha_attention_f32(
    const float* q, const float* k, const float* v, float* o,
    long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn,
    int B, int H, int N, int M, int D, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || M < 1 || M > kMaxKeys || D < kChunk ||
      D % kChunk != 0 || (long long)B * H > 0x7fffffffLL ||
      (N + kRows - 1) / kRows > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(B * H), (unsigned)((N + kRows - 1) / kRows));
  attention_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      q, k, v, o, Strides{q_sb, q_sh, q_sn}, Strides{k_sb, k_sh, k_sn},
      Strides{v_sb, v_sh, v_sn}, Strides{o_sb, o_sh, o_sn}, H, N, M, D, scale);
  return (int)cudaGetLastError();
}
