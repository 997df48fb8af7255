// Fused multi-head attention, fp32 in and out, for the generator's 90-token
// blocks.
//
// Replaces the TPU kernel mocha_sigasia2023_tpu/ops/attention.py::_attn_kernel
// (launched by fused_attention, pl.pallas_call at :63).  For every
// (batch, head) it computes softmax(q k^T * scale) v: the row max is
// subtracted before exp, and the output is fp32.
//
// What bounds it on an H100: one call has to read q, k and v and write o
// once.  At the main-path shapes (N = M = 90; B*H = 256 with d = 256, or
// B*H = 512 with d = 128) that is 94.4 MB, 0.0282 ms at 3.35 TB/s.  The
// products, 4*B*H*N*M*d operations, take 0.0043 ms at the TF32 tensor-core
// peak and about three times that in 3xTF32, so the bytes bind.
//
// Numerics: the contract is the fp32 plain version within atol 2e-5 /
// rtol 1e-4.  Single-pass TF32 keeps 11 bits and misses it, so every product
// runs in 3xTF32: x = big + small with big = tf32(x) and small = x - big, and
// a b ~ a_small b_big + a_big b_small + a_big b_big, each an
// mma.sync.m16n8k8 TF32 tile with fp32 accumulation.  The logits are summed
// per 32-column chunk and the chunk sums added in fp32: one accumulation
// chain over all of d was 7x further from float64 at logits near +-40
// (scripts/attention_ablation.py).  Not wgmma: its TF32
// form needs both operands K-major, so v would have to be transposed, and
// the products are not what bounds the kernel.
//
// Design.  One CTA per (batch, head) owns up to 96 query rows, so at
// N <= 96 each head's q, k and v cross from HBM to shared memory once.
//   * Warp w owns query rows 16w..16w+15 across all keys (KT tiles of 8).
//   * The head dim streams in 32-column chunks through a three-stage ring in
//     shared memory: first q|k chunks, then v chunks.  Thread 0 fills a
//     stage with one TMA box per matrix ([rows x 32 columns], 128-byte
//     rows), completing on the stage's "full" mbarrier; every thread
//     arrives on its "empty" mbarrier when done with it, behind a proxy
//     fence that orders its reads before the next TMA write, and thread 0
//     waits on that before refilling.  So two chunks are in flight while one is
//     multiplied, and v's first chunks load during the last q k^T chunks and
//     the softmax.  TMA fills rows past N or M with zeros.  The three tensor
//     maps are encoded on the host for every call, since their addresses
//     change.  A 1-D cp.async.bulk per row (256 bytes, 720-1,080 copies a
//     head) was tried first and was much slower.
//   * The boxes use the 128-byte swizzle (unit u of row r at u ^ (r % 8)),
//     which makes every fragment load of q, k and v free of bank conflicts;
//     each thread's loads are a few base pointers plus constants.
//   * The logits stay in the MMA accumulators; softmax takes the row max and
//     sum over the quad of lanes that share a row.
//   * P.V takes P straight from those accumulators.  The order of k within
//     one MMA is free, so A's columns t and t+4 are keys 2t and 2t+1, which
//     is what a thread holds, and v is read in that same order: no shuffle
//     and no shared memory for P.  Each warp writes its 16 rows x 32 columns
//     of a chunk straight into the output view.
// Shared memory is 3 stages x (96 + keys) x 128 bytes: 73 KB at M = 90, and
// registers are held to 168 a thread, so two heads share an SM.  q, k, v
// and o are addressed through (batch, head, row) strides with a unit last
// stride, so the caller's (B, N, H, d) projections need no copy.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"
#include "tma.cuh"

namespace {

constexpr int kChunk = 32;              // head-dim columns a stage: 128 B
constexpr int kTiles = kChunk / 8;      // 8-wide MMA tiles per chunk
constexpr int kMaxKeys = 128;
constexpr int kDimMultiple = 64;        // the head dims the wrapper admits
static_assert(kDimMultiple % kChunk == 0, "chunks tile the head dim");
constexpr int kMaxWarps = 6;            // 16 query rows a warp
constexpr int kStages = 3;
constexpr int kBarBytes = 2 * kStages * 8;  // full[] and empty[] mbarriers
constexpr int kAlign = 1024;            // the 128-byte swizzle's period
constexpr int kMaxDevices = 64;

struct Params {
  float* o;
  long long o_sb, o_sh, o_sn;
  int H, N, M, D;
  float scale;
};

// Shared layout of one ring stage, in floats: a chunk of q as a
// [kQRows][32] TMA box, then the chunk of k (or v) as a [KT*8][32] box.
// Both use the 128-byte swizzle: the 16-byte unit u of row r sits at unit
// u ^ (r % 8).
constexpr int kQRows = kMaxWarps * 16;
constexpr int kQBox = kQRows * kChunk;
template <int KT>
struct Stage {
  static constexpr int kKBox = KT * 8 * kChunk;
  static constexpr int kFloats = kQBox + kKBox;
};

// acc[j] += q_tile k_tile_j^T over one chunk, in 3xTF32.  Rows r0 + g
// (+8) of q and rows 8j + g of k all have r % 8 == g, so the 8 swizzled
// units a thread reads sit at 8 per-thread offsets; every load is then one
// of 16 base pointers plus a constant.  Each chunk is summed into `part`
// and then added to acc, G key tiles at a time.
template <int KT>
__device__ __forceinline__ void qk_chunk(const float* st, int r0, int g, int t,
                                         float (&acc)[KT][4]) {
  constexpr int G = KT % 4 == 0 ? 4 : 2;
  const float* qp[8];
  const float* kp[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int x = ((u ^ g) & 7) * 4 + t;
    qp[u] = st + (r0 + g) * kChunk + x;
    kp[u] = st + kQBox + g * kChunk + x;
  }
#pragma unroll
  for (int j0 = 0; j0 < KT; j0 += G) {
    float part[G][4];
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[jj][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTiles; ++kk) {
      const int u = 2 * kk;  // columns 8kk + t and 8kk + t + 4
      uint32_t ab[4], as[4];
      ptx::split_tf32(qp[u][0], ab[0], as[0]);               // A[g][t]
      ptx::split_tf32(qp[u][8 * kChunk], ab[1], as[1]);      // A[g+8][t]
      ptx::split_tf32(qp[u + 1][0], ab[2], as[2]);           // A[g][t+4]
      ptx::split_tf32(qp[u + 1][8 * kChunk], ab[3], as[3]);  // A[g+8][t+4]
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const int kj = (j0 + jj) * 8 * kChunk;
        uint32_t bb[2], bs[2];
        ptx::split_tf32(kp[u][kj], bb[0], bs[0]);      // B[t][g]
        ptx::split_tf32(kp[u + 1][kj], bb[1], bs[1]);  // B[t+4][g]
        ptx::mma_tf32x3(part[jj], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j0 + jj][e] += part[jj][e];
  }
}

// out = P v_chunk for one chunk of v, in 3xTF32.  P comes from the logits
// accumulators: a thread holds keys 2t and 2t+1 of each key tile, so it
// reads v rows 8j + 2t (+1), columns 8n + g; those sit at 8 per-thread
// swizzled offsets.
template <int KT>
__device__ __forceinline__ void pv_chunk(const float* st, int g, int t,
                                         const float (&p)[KT][4],
                                         float (&out)[kTiles][4]) {
  const float* vp[kTiles][2];
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 2 * t + e;
      vp[n][e] = st + kQBox + r * kChunk + (((2 * n + g / 4) ^ r) & 7) * 4 +
                 g % 4;
    }
#pragma unroll
  for (int n = 0; n < kTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    uint32_t ab[4], as[4];
    ptx::split_tf32(p[j][0], ab[0], as[0]);  // row g,   key 2t
    ptx::split_tf32(p[j][2], ab[1], as[1]);  // row g+8, key 2t
    ptx::split_tf32(p[j][1], ab[2], as[2]);  // row g,   key 2t+1
    ptx::split_tf32(p[j][3], ab[3], as[3]);  // row g+8, key 2t+1
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      uint32_t bb[2], bs[2];
      ptx::split_tf32(vp[n][0][j * 8 * kChunk], bb[0], bs[0]);
      ptx::split_tf32(vp[n][1][j * 8 * kChunk], bb[1], bs[1]);
      ptx::mma_tf32x3(out[n], ab, as, bb, bs);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int KT>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
attention_tf32x3_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, Params p) {
  extern __shared__ unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStages;
  const uint32_t base = ptx::smem_addr(smem_raw);
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((base + kBarBytes + kAlign - 1) / kAlign * kAlign - base));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows = blockDim.x / 2;       // 16 query rows per warp
  constexpr int kKBox = Stage<KT>::kKBox;
  constexpr int kStageFloats = Stage<KT>::kFloats;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int row0 = blockIdx.y * rows;
  const int nq = min(rows, p.N - row0);  // query rows this CTA stores
  const int L = p.D / kChunk;            // chunks per matrix
  const int loads = 2 * L;               // q|k chunks, then v chunks

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], blockDim.x);
    }
    ptx::fence_mbar_init();
  }
  __syncthreads();

  // Thread 0: fill stage i % kStages with load i, once every thread has
  // released that stage's previous load.  The q box sits first, the k or v
  // box after it.
  auto produce = [&](int i) {
    const int s = i % kStages;
    float* st = ring + s * kStageFloats;
    if (i >= kStages) ptx::mbar_wait(&empty[s], (i / kStages - 1) & 1);
    const bool qk = i < L;
    const int c0 = (qk ? i : i - L) * kChunk;
    ptx::mbar_arrive_expect_tx(&full[s],
                               4 * ((qk ? rows * kChunk : 0) + kKBox));
    if (qk) ptx::tma_load_4d(st, &tq, c0, row0, h, b, &full[s]);
    ptx::tma_load_4d(st + kQBox, qk ? &tk : &tv, c0, 0, h, b, &full[s]);
  };
  if (tid == 0)
    for (int i = 0; i < kStages; ++i) produce(i);
  __syncwarp();

  // ---- logits: S = q k^T, chunk by chunk ----
  float s_acc[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
  for (int i = 0; i < L; ++i) {
    const int s = i % kStages;
    const float* st = ring + s * kStageFloats;
    ptx::mbar_wait(&full[s], (i / kStages) & 1);
    qk_chunk<KT>(st, warp * 16, g, t, s_acc);
    ptx::mbar_release_stage(&empty[s]);
    if (tid == 0 && i + kStages < loads) produce(i + kStages);
    __syncwarp();
  }

  // ---- softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) ----
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + 2 * t + (e & 1);
      const float x = key < p.M ? s_acc[j][e] * p.scale : -INFINITY;
      s_acc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(s_acc[j][e] - mx[e >> 1]);
      s_acc[j][e] = x;
      sum[e >> 1] += x;
    }
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) inv[r] = 1.f / quad_sum(sum[r]);

  // ---- out = P v / sum, chunk by chunk ----
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  float* ob = p.o + b * p.o_sb + h * p.o_sh + row0 * p.o_sn;
  for (int i = L; i < loads; ++i) {
    const int s = i % kStages;
    const float* st = ring + s * kStageFloats;
    ptx::mbar_wait(&full[s], (i / kStages) & 1);
    float out[kTiles][4];
    pv_chunk<KT>(st, g, t, s_acc, out);
    ptx::mbar_release_stage(&empty[s]);
    if (tid == 0 && i + kStages < loads) produce(i + kStages);
    __syncwarp();
    const int c0 = (i - L) * kChunk + 2 * t;
#pragma unroll
    for (int n = 0; n < kTiles; ++n) {
      if (r_lo < nq)
        *reinterpret_cast<float2*>(ob + r_lo * p.o_sn + c0 + n * 8) =
            make_float2(out[n][0] * inv[0], out[n][1] * inv[0]);
      if (r_hi < nq)
        *reinterpret_cast<float2*>(ob + r_hi * p.o_sn + c0 + n * 8) =
            make_float2(out[n][2] * inv[1], out[n][3] * inv[1]);
    }
  }
}

// A (B, H, rows, D) fp32 view as a tensor map of [box_rows x 32] boxes.
bool encode_map(CUtensorMap* map, const float* ptr, int B, int H, int rows,
                int D, long long sb, long long sh, long long sn,
                int box_rows) {
  return tma::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, B, H,
                         rows, D, sb, sh, sn, kChunk, box_rows);
}

template <int KT>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const Params& p, dim3 grid, int threads,
           int smem, cudaStream_t stream) {
  // Once per device (smem depends on KT only): more than 48 KB of shared
  // memory needs this attribute, and the largest carveout lets two CTAs of
  // the main-path shapes share an SM.
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && (dev >= kMaxDevices || !configured[dev])) {
    e = cudaFuncSetAttribute(attention_tf32x3_kernel<KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_tf32x3_kernel<KT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  attention_tf32x3_kernel<KT><<<grid, threads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

bool aligned(long long stride, int extent) {
  return tma::aligned(stride, extent, 4);
}

using tma::aligned;

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes B*H >= 1, N >= 1, 1 <= M <= 128, D a positive multiple of 64,
// 16-byte-aligned q, k, v, o and (batch, head, row) strides in multiples of
// 4 floats; returns cudaErrorInvalidValue for anything else without
// launching.
extern "C" int mocha_attention_f32(
    const float* q, const float* k, const float* v, float* o,
    long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn,
    int B, int H, int N, int M, int D, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || M < 1 || M > kMaxKeys || D < kDimMultiple ||
      D % kDimMultiple != 0 || (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!(aligned(q) && aligned(k) && aligned(v) && aligned(o) &&
        aligned(q_sb, B) && aligned(q_sh, H) && aligned(q_sn, N) &&
        aligned(k_sb, B) && aligned(k_sh, H) && aligned(k_sn, M) &&
        aligned(v_sb, B) && aligned(v_sh, H) && aligned(v_sn, M) &&
        aligned(o_sb, B) && aligned(o_sh, H) && aligned(o_sn, N)))
    return (int)cudaErrorInvalidValue;
  const int warps = N > 16 * kMaxWarps ? kMaxWarps : (N + 15) / 16;
  const int rows = warps * 16;
  const int kt = (M + 15) / 16 * 2;  // an even count of 8-key tiles
  const dim3 grid((unsigned)(B * H), (unsigned)((N + rows - 1) / rows));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!(encode_map(&tq, q, B, H, N, D, q_sb, q_sh, q_sn, rows) &&
        encode_map(&tk, k, B, H, M, D, k_sb, k_sh, k_sn, kt * 8) &&
        encode_map(&tv, v, B, H, M, D, v_sb, v_sh, v_sn, kt * 8)))
    return (int)cudaErrorInvalidValue;
  // barriers, then the ring from the next 1024-byte boundary
  const int smem =
      kBarBytes + kAlign + kStages * (kQRows + kt * 8) * kChunk * 4;
  const Params p{o, o_sb, o_sh, o_sn, H, N, M, D, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = warps * 32;
  switch (kt) {
    case 2: return launch<2>(tq, tk, tv, p, grid, threads, smem, s);
    case 4: return launch<4>(tq, tk, tv, p, grid, threads, smem, s);
    case 6: return launch<6>(tq, tk, tv, p, grid, threads, smem, s);
    case 8: return launch<8>(tq, tk, tv, p, grid, threads, smem, s);
    case 10: return launch<10>(tq, tk, tv, p, grid, threads, smem, s);
    case 12: return launch<12>(tq, tk, tv, p, grid, threads, smem, s);
    case 14: return launch<14>(tq, tk, tv, p, grid, threads, smem, s);
    case 16: return launch<16>(tq, tk, tv, p, grid, threads, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
