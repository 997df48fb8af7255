// Fused multi-head attention, bf16 in and out, for the generator's 90-token
// blocks under the bf16 serving mode.
//
// Replaces the TPU kernel mocha_sigasia2023_tpu/ops/attention.py::_attn_kernel
// (launched by fused_attention, pl.pallas_call at :63) on bf16 inputs, and
// computes what it computes there: for every (batch, head) the logits as
// bf16 x bf16 products summed in fp32, times scale; the max-subtracted
// softmax in fp32; P rounded to bf16 (:47); P v summed in fp32; the output
// rounded to bf16.  The contract is that plain version (upcast, fp32 math,
// the same two roundings) within atol 8e-3 / rtol 8e-3: the two differ by
// the fp32 summation order, and by P's rounding where that order moves a
// value across a bf16 boundary.
//
// What bounds it on an H100: one call has to read q, k and v and write o
// once, 2 bytes an element.  At the decoder shape (B*H = 256, N = M = 90,
// d = 256) that is 47.2 MB, 0.0141 ms at 3.35 TB/s; the products,
// 4*B*H*N*M*d operations, take 0.002 ms at the 989 TFLOP/s bf16 rate.  So
// the bytes bind.
//
// Design: the fp32 kernel's (attention.cu) with bf16 operands.
//   * One CTA per (batch, head) owns up to 96 query rows; warp w owns rows
//     16w..16w+15 across all keys (KT tiles of 8).
//   * The head dim streams in 64-column chunks (128-byte rows) through a
//     three-stage TMA ring with full/empty mbarriers: first q|k chunks,
//     then v chunks.  The boxes use the 128-byte swizzle.  A thread
//     releases a stage behind a proxy fence (ptx::mbar_release_stage), so
//     the next TMA write cannot overtake its ldmatrix reads.
//   * Both products are single-pass mma.sync.m16n8k16 bf16 with fp32
//     accumulation: a bf16 product is exact in fp32, so there is nothing to
//     split.  q and k fragments are 32-bit shared loads of two bf16; under
//     the swizzle the 32 lanes hit 32 banks.
//   * Softmax in registers; P is normalised in fp32, rounded to bf16 and
//     packed into A fragments straight from the logits accumulators (the
//     accumulator of key tiles 2i and 2i+1 is the A fragment of keys
//     16i..16i+15).
//   * v's B fragments come from ldmatrix.trans: B wants two consecutive keys
//     in one register, and v is stored key-major.
//   * Each warp rounds its 16 rows x 64 columns of a chunk to bf16 and
//     writes them straight into the output view.
// Shared memory is 3 stages x (96 + keys) x 128 bytes: 73 KB at M = 90, so
// two heads share an SM.  q, k, v and o are addressed through (batch, head,
// row) strides with a unit last stride.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"
#include "tma.cuh"

namespace {

constexpr int kChunk = 64;                 // head-dim columns a stage
constexpr int kRowBytes = kChunk * 2;      // 128 B: one swizzle row
constexpr int kKSteps = kChunk / 16;       // k16 steps of q k^T per chunk
constexpr int kOutTiles = kChunk / 8;      // 8-wide output tiles per chunk
constexpr int kMaxKeys = 128;
constexpr int kDimMultiple = 64;           // the head dims the wrapper admits
static_assert(kDimMultiple % kChunk == 0, "chunks tile the head dim");
constexpr int kMaxWarps = 6;               // 16 query rows a warp
constexpr int kStages = 3;
constexpr int kBarBytes = 2 * kStages * 8; // full[] and empty[] mbarriers
constexpr int kAlign = 1024;               // the 128-byte swizzle's period
constexpr int kMaxDevices = 64;
constexpr int kQRows = kMaxWarps * 16;
constexpr int kQBoxBytes = kQRows * kRowBytes;

struct Params {
  uint16_t* o;
  long long o_sb, o_sh, o_sn;
  int H, N, M, D;
  float scale;
};

// One ring stage: a chunk of q as a [kQRows][64] box, then the chunk of k
// (or v) as a [KT*8][64] box.  Both sizes are multiples of 1024 bytes, so
// every box starts on the swizzle's period.
template <int KT>
struct Stage {
  static constexpr int kKBoxBytes = KT * 8 * kRowBytes;
  static constexpr int kBytes = kQBoxBytes + kKBoxBytes;
};

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// acc[j] += q_tile k_tile_j^T over one chunk.  Rows r0 + g (+8) of q and
// rows 8j + g of k all have r % 8 == g, so a thread's columns 16kk + 2t and
// 16kk + 8 + 2t sit in swizzled units (2kk) ^ g and (2kk + 1) ^ g of its
// rows, at byte 4t.
template <int KT>
__device__ __forceinline__ void qk_chunk(const unsigned char* st, int r0,
                                         int g, int t, float (&acc)[KT][4]) {
  const unsigned char* q = st + (r0 + g) * kRowBytes + 4 * t;
  const unsigned char* k = st + kQBoxBytes + g * kRowBytes + 4 * t;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int lo = ((2 * kk) ^ g) << 4, hi = ((2 * kk + 1) ^ g) << 4;
    uint32_t a[4];
    a[0] = ld32(q + lo);                   // A[g][16kk + 2t..]
    a[1] = ld32(q + 8 * kRowBytes + lo);   // A[g+8][16kk + 2t..]
    a[2] = ld32(q + hi);                   // A[g][16kk + 8 + 2t..]
    a[3] = ld32(q + 8 * kRowBytes + hi);   // A[g+8][16kk + 8 + 2t..]
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const unsigned char* kj = k + j * 8 * kRowBytes;
      ptx::mma_bf16(acc[j], a, ld32(kj + lo), ld32(kj + hi));
    }
  }
}

// out = P v_chunk for one chunk of v.  For keys 16i..16i+15 and output
// columns 16n..16n+15 of the chunk, one ldmatrix.x4.trans reads the four
// 8x8 blocks (keys +0/+8) x (columns +0/+8): lane L points at key
// 16i + 8 * (L / 8 % 2) + L % 8, unit 2n + L / 16, whose swizzled place
// only needs L % 8.
template <int KT>
__device__ __forceinline__ void pv_chunk(uint32_t st, int lane,
                                         const uint32_t (&p)[KT / 2][4],
                                         float (&out)[kOutTiles][4]) {
  const int r = lane % 8, mi = lane / 8;
  const uint32_t v = st + kQBoxBytes + ((mi % 2) * 8 + r) * kRowBytes;
#pragma unroll
  for (int n = 0; n < kOutTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[n][e] = 0.f;
#pragma unroll
  for (int i = 0; i < KT / 2; ++i)
#pragma unroll
    for (int n = 0; n < kOutTiles / 2; ++n) {
      uint32_t b[4];
      ptx::ldmatrix_x4_trans(
          b, v + i * 16 * kRowBytes + (((2 * n + mi / 2) ^ r) << 4));
      ptx::mma_bf16(out[2 * n], p[i], b[0], b[1]);
      ptx::mma_bf16(out[2 * n + 1], p[i], b[2], b[3]);
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
attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, Params p) {
  extern __shared__ unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kStages;
  const uint32_t base = ptx::smem_addr(smem_raw);
  unsigned char* ring =
      smem_raw + ((base + kBarBytes + kAlign - 1) / kAlign * kAlign - base);
  const uint32_t ring_addr = ptx::smem_addr(ring);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int rows = blockDim.x / 2;       // 16 query rows per warp
  constexpr int kKBoxBytes = Stage<KT>::kKBoxBytes;
  constexpr int kStageBytes = Stage<KT>::kBytes;
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
  // released that stage's previous load.
  auto produce = [&](int i) {
    const int s = i % kStages;
    unsigned char* st = ring + s * kStageBytes;
    if (i >= kStages) ptx::mbar_wait(&empty[s], (i / kStages - 1) & 1);
    const bool qk = i < L;
    const int c0 = (qk ? i : i - L) * kChunk;
    ptx::mbar_arrive_expect_tx(&full[s],
                               (qk ? rows * kRowBytes : 0) + kKBoxBytes);
    if (qk) ptx::tma_load_4d(st, &tq, c0, row0, h, b, &full[s]);
    ptx::tma_load_4d(st + kQBoxBytes, qk ? &tk : &tv, c0, 0, h, b, &full[s]);
  };
  // (at d = 64 there are only two loads: a third would land after exit)
  if (tid == 0)
    for (int i = 0; i < kStages && i < loads; ++i) produce(i);
  __syncwarp();

  // ---- logits: S = q k^T, chunk by chunk ----
  float s_acc[KT][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s_acc[j][e] = 0.f;
  for (int i = 0; i < L; ++i) {
    const int s = i % kStages;
    ptx::mbar_wait(&full[s], (i / kStages) & 1);
    qk_chunk<KT>(ring + s * kStageBytes, warp * 16, g, t, s_acc);
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
#pragma unroll
  for (int r = 0; r < 2; ++r) sum[r] = quad_sum(sum[r]);
  // P = e / sum in fp32, rounded to bf16 (the TPU kernel's p.astype(v.dtype))
  uint32_t pk[KT / 2][4];
#pragma unroll
  for (int i = 0; i < KT / 2; ++i) {
    const float(&lo)[4] = s_acc[2 * i];
    const float(&hi)[4] = s_acc[2 * i + 1];
    pk[i][0] = ptx::pack_bf16x2(lo[0] / sum[0], lo[1] / sum[0]);
    pk[i][1] = ptx::pack_bf16x2(lo[2] / sum[1], lo[3] / sum[1]);
    pk[i][2] = ptx::pack_bf16x2(hi[0] / sum[0], hi[1] / sum[0]);
    pk[i][3] = ptx::pack_bf16x2(hi[2] / sum[1], hi[3] / sum[1]);
  }

  // ---- out = P v, chunk by chunk ----
  const int r_lo = warp * 16 + g, r_hi = r_lo + 8;
  uint16_t* ob = p.o + b * p.o_sb + h * p.o_sh + row0 * p.o_sn;
  for (int i = L; i < loads; ++i) {
    const int s = i % kStages;
    ptx::mbar_wait(&full[s], (i / kStages) & 1);
    float out[kOutTiles][4];
    pv_chunk<KT>(ring_addr + s * kStageBytes, lane, pk, out);
    ptx::mbar_release_stage(&empty[s]);
    if (tid == 0 && i + kStages < loads) produce(i + kStages);
    __syncwarp();
    const int c0 = (i - L) * kChunk + 2 * t;
#pragma unroll
    for (int n = 0; n < kOutTiles; ++n) {
      if (r_lo < nq)
        *reinterpret_cast<uint32_t*>(ob + r_lo * p.o_sn + c0 + n * 8) =
            ptx::pack_bf16x2(out[n][0], out[n][1]);
      if (r_hi < nq)
        *reinterpret_cast<uint32_t*>(ob + r_hi * p.o_sn + c0 + n * 8) =
            ptx::pack_bf16x2(out[n][2], out[n][3]);
    }
  }
}

// A (B, H, rows, D) bf16 view as a tensor map of [box_rows x 64] boxes.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int H, int rows,
                int D, long long sb, long long sh, long long sn,
                int box_rows) {
  return tma::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, B, H,
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
    e = cudaFuncSetAttribute(attention_bf16_kernel<KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attention_bf16_kernel<KT>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (e == cudaSuccess && dev < kMaxDevices) configured[dev] = true;
  }
  if (e != cudaSuccess) return (int)e;
  attention_bf16_kernel<KT><<<grid, threads, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

bool aligned(long long stride, int extent) {
  return tma::aligned(stride, extent, 2);
}

using tma::aligned;

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Takes bf16 q, k, v, o, B*H >= 1, N >= 1, 1 <= M <= 128, D a positive
// multiple of 64, 16-byte-aligned pointers and (batch, head, row) strides in
// multiples of 8 elements; returns cudaErrorInvalidValue for anything else
// without launching.
extern "C" int mocha_attention_bf16(
    const void* q, const void* k, const void* v, void* o,
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
      kBarBytes + kAlign + kStages * (kQBoxBytes + kt * 8 * kRowBytes);
  const Params p{static_cast<uint16_t*>(o), o_sb, o_sh, o_sn, H, N, M, D,
                 scale};
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
