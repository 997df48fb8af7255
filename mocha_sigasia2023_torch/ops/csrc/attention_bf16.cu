// Fused multi-head attention, bf16 in and out, for the generator's 90-token
// blocks under the bf16 serving mode.
//
// Replaces the TPU kernel mocha_sigasia2023_tpu/ops/attention.py::_attn_kernel
// (launched by fused_attention, pl.pallas_call at :63) on bf16 inputs, and
// computes what it computes there: for every (batch, head) the logits as
// bf16 x bf16 products summed in fp32, times scale; the max-subtracted
// softmax in fp32; P = e / sum in fp32, rounded to bf16 (:47); P v summed in
// fp32; the output rounded to bf16.  The contract is that plain version
// (upcast, fp32 math, the same two roundings) within atol 8e-3 / rtol 8e-3:
// the two differ by the fp32 summation order, and by P's rounding where that
// order moves a value across a bf16 boundary.  P is normalised by division
// before it is rounded, as the TPU kernel does.  Deferring the division to
// the output, as flash attention does, rounds e instead of e / sum; the CPU
// emulation (tests/test_torch_attention.py) measures what that would cost.
//
// What bounds it on an H100: one call has to read q, k and v and write o
// once, 2 bytes an element.  At the decoder shape (B*H = 256, N = M = 90,
// d = 256) that is 47.2 MB, 0.0141 ms at 3.35 TB/s; the products,
// 4*B*H*N*M*d operations, take 0.002 ms at the 989 TFLOP/s bf16 rate.  So
// the bytes bind, and the design keeps the memory busy from the first load
// to the last store: the next head's copies land while this head's
// products, softmax and stores run.
//
// Design: a persistent, warp-specialized kernel.
//   * Work items are (batch, head, block of 128 query rows).  The grid has
//     min(items, SMs) CTAs, one per SM (the shared memory holds one), and CTA
//     i takes items i, i + grid, ...: no CTA takes more than one item above
//     another.  On a 132-SM H100: the encoder chunk (512 items) 4 each on
//     116 CTAs and 3 on 16; the decoder and cross shapes (256 items) 2 on 124
//     and 1 on 8.
//   * 288 threads: consumer warpgroups 0 and 1 own query rows 0-63 and
//     64-127 of an item; warp 8 is the producer, and one of its lanes
//     issues every TMA load.  No setmaxnreg: it only moves registers from
//     one warpgroup to another, and nothing here would take them.  ptxas
//     gives every thread what the consumers need, with no spills: 113,
//     136 and 163 registers at KT = 8, 12 and 16 (288 x 163 = 46,944 of
//     the SM's 65,536), and the shared memory holds one CTA a SM anyway.
//   * The head dim streams in 64-column chunks (128-byte rows) through a
//     ring of as many stages as the shared memory holds: each item's q|k
//     chunks, then its v chunks.  A stage holds a [128 rows x 64] q box and
//     a [KT * 8 keys x 64] k or v box (28 KB and 6 stages at KT = 12); TMA
//     fills rows past N or M with zeros.  The producer runs ahead across
//     items.  Stage index and mbarrier parity run on across items (one
//     counter pair in the producer, one in the consumers), never restart
//     per item: with 2 * d / 64 loads an item and 6 stages, an item starts
//     at another stage and parity than the one before it.
//   * q k^T is wgmma.m64nNk16, N = KT * 8 >= M keys (one instance each for
//     64, 96 and 128: with the 128 one alone, scripts/attention_ablation.py's
//     one_instance read 8% slower at the encoder chunk, 3% at the decoder
//     and 27% at M = 45 on an H100), with both operands K-major, read through
//     128-byte-swizzle descriptors straight from the TMA boxes (4 k16 steps
//     a chunk; one fp32 accumulator chain over all of d).  Keys at or past M
//     are masked to -inf; key tiles wholly past M skip the exp.
//   * The logits accumulator is, register for register, the A fragment of
//     the next product: P = e / sum is rounded to bf16 and packed in place.
//     The division is a reciprocal and one correction (div_by), which
//     rounds as division does.  P v is wgmma.m64n64k16 with A from
//     registers and v as an MN-major B (the transpose bit), KT / 2 k16
//     steps; keys past M meet P = 0 and zero rows of v.
//   * Each warp rounds its 16 rows x 64 columns of an output chunk to bf16
//     into one of two swizzled staging tiles of its own, and one lane stores
//     the tile with one TMA store into the output view; rows at or past N
//     are clipped by the store, and a warp with no row below N stores
//     nothing.  The store runs while the warp goes on.  (Per warp rather
//     than per warpgroup: a __syncwarp then orders a tile's writes before
//     its store.  A warpgroup's 64 rows in one store need two named
//     barriers of 128 threads a chunk, and the ablation's wg_store read 1%
//     slower at the encoder chunk and the decoder and 7% at M = 45.)
//   * The four tensor maps are encoded by the host at every call and
//     prefetched at kernel start.
// Where trouble is likely, and what is done about it:
//   * Stage release: a stage is read by wgmma alone, so one lane a warp
//     hands it back, after the warp's wgmma_wait has retired every product
//     that reads it, and only through ptx::mbar_release_stage (proxy fence,
//     then the arrive).
//   * Staging tile, the reverse hazard: the generic-proxy writes of a tile
//     are read by an async-proxy store.  Each lane fences its writes
//     (fence_staging) before the __syncwarp, and the storing lane waits on
//     cp.async.bulk.wait_group.read before the tile is written again.
//   * Descriptors: every box starts on a 1024-byte boundary (the swizzle's
//     period), so the base offset is 0.  K-major q and k: SBO = 1024 bytes
//     (8 rows), LBO unused; a k16 step adds 32 bytes to the start address.
//     MN-major v: SBO = 1024 bytes (8 keys), LBO unused (one 64-column atom);
//     a k16 step adds 2048 bytes.  Accumulators are read only after
//     wgmma_wait, behind ptx::fence_operands.
//   * Phase parity across items: the counters above.
//   * ptxas serializes every wgmma of the kernel when a wgmma_wait sits
//     under a condition that it cannot tie to the products' own; the waits
//     here are unconditional.
// q, k, v and o are addressed through (batch, head, row) strides with a unit
// last stride.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"
#include "tma.cuh"

namespace {

constexpr int kChunk = 64;                   // head-dim columns a load
constexpr int kRowBytes = kChunk * 2;        // 128 B: one swizzle row
constexpr int kKSteps = kChunk / 16;         // k16 steps of q k^T a chunk
constexpr int kMaxKeys = 128;
constexpr int kOutTiles = kChunk / 8;        // 8-column output tiles a chunk
constexpr int kDimMultiple = 64;             // the head dims the wrapper admits
static_assert(kDimMultiple % kChunk == 0, "chunks tile the head dim");
constexpr int kConsumers = 2;                // warpgroups of 64 query rows
constexpr int kRows = 64 * kConsumers;       // query rows an item
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kProducerWarp = kConsumerThreads / 32;
constexpr int kThreads = kConsumerThreads + 32;
constexpr int kQBoxBytes = kRows * kRowBytes;        // 16 KB
constexpr int kOutBoxBytes = 16 * kRowBytes;         // a warp's rows
constexpr int kOutBuffers = 2;                       // per warp
constexpr int kStagingBytes =
    kConsumerThreads / 32 * kOutBuffers * kOutBoxBytes;
constexpr int kMaxStages = 8;
constexpr int kBarBytes = 2 * kMaxStages * 8;        // full[] and empty[]
constexpr int kAlign = 1024;                         // the swizzle's period
constexpr int kMaxDevices = 64;

struct Params {
  int H, N, M, D;
  int row_blocks, items, stages;
  float scale;
};

// A ring stage: a [128 rows x 64] q box, then a [KT * 8 keys x 64] k or v
// box; both are multiples of 1024 bytes.
template <int KT>
struct Stage {
  static constexpr int kBytes = kQBoxBytes + KT * 8 * kRowBytes;
};

struct Item {
  int b, h, row0;
};

__device__ __forceinline__ Item item_at(int item, const Params& p) {
  const int bh = item / p.row_blocks;
  return {bh / p.H, bh % p.H, (item % p.row_blocks) * kRows};
}

// Orders this thread's generic-proxy writes of a staging tile before the
// async-proxy TMA store that reads it.
__device__ __forceinline__ void fence_staging() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// e / sum as fp32 division rounds it, for finite e >= 0 and a normal sum,
// given inv = 1 / sum rounded: q = e * inv, then one correction from the
// exact residual e - sum * q (Markstein).  tests/test_torch_attention.py
// holds the emulated form equal to the division wherever the quotient is a
// normal fp32.  Plain division (div.rn) is a longer sequence with a branch
// to a slow path; scripts/attention_ablation.py's "ieee_div" times it.
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

// KT: key tiles of 8, the n of q k^T is KT * 8 >= M (64, 96 or 128)
template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to, Params p) {
  extern __shared__ unsigned char smem_raw[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
  uint64_t* empty = full + kMaxStages;
  const uint32_t base = ptx::smem_addr(smem_raw);
  const uint32_t ring = (base + kBarBytes + kAlign - 1) / kAlign * kAlign;
  const int tid = threadIdx.x, warp = tid / 32;
  const int L = p.D / kChunk;                // chunks per matrix
  constexpr int kStageBytes = Stage<KT>::kBytes;
  constexpr int kKeySteps = KT / 2;          // k16 steps of P v

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], kConsumerThreads / 32);
    }
    ptx::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    // ---- producer: one lane keeps the ring full, item after item ----
    if (tid % 32 == 0) {
      ptx::prefetch_tensormap(&tq);
      ptx::prefetch_tensormap(&tk);
      ptx::prefetch_tensormap(&tv);
      ptx::prefetch_tensormap(&to);
      // the stage and its round of the CTA's next load: the ring runs on
      // across items
      int s = 0;
      uint32_t round = 0;
      for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
        const Item it = item_at(item, p);
        // q|k chunks, then v chunks
        for (int i = 0; i < 2 * L; ++i) {
          // stage s is free once every consumer warp released its last round
          if (round > 0) ptx::mbar_wait(&empty[s], (round - 1) & 1);
          const uint32_t st = ring + s * kStageBytes;
          const bool qk = i < L;
          const int c0 = (qk ? i : i - L) * kChunk;
          ptx::mbar_arrive_expect_tx(
              &full[s], (qk ? kQBoxBytes : 0) + KT * 8 * kRowBytes);
          if (qk) ptx::tma_load_4d(st, &tq, c0, it.row0, it.h, it.b, &full[s]);
          ptx::tma_load_4d(st + kQBoxBytes, qk ? &tk : &tv, c0, 0, it.h, it.b,
                           &full[s]);
          if (++s == p.stages) {
            s = 0;
            ++round;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64wg..64wg+63 of an item ----
    const int wg = warp / 4, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row_w = 64 * wg + 16 * (warp % 4);  // this warp's 16 rows
    // two staging tiles of [16 rows x 64] a warp
    const uint32_t staging =
        ring + p.stages * kStageBytes + warp * kOutBuffers * kOutBoxBytes;
    int s = 0, s_done = 0;    // the next stage to wait on, and to release
    uint32_t phase = 0, stores = 0;
    // every stage is read by wgmma alone (async proxy), so one lane a warp
    // hands it back, once the warp's wgmma_wait has retired its reads
    auto wait_full = [&]() {
      ptx::mbar_wait(&full[s], phase);
      const uint32_t st = ring + s * kStageBytes;
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
      return st;
    };
    auto release = [&]() {
      __syncwarp();
      if (lane == 0) ptx::mbar_release_stage(&empty[s_done]);
      if (++s_done == p.stages) s_done = 0;
    };
    // rounds this warp's 16 rows x 64 columns of output chunk c to bf16 in
    // a staging tile and stores them with one TMA store
    auto store = [&](const float (&o)[kChunk / 2], const Item& it, int c) {
      const uint32_t tile = staging + (stores++ % kOutBuffers) * kOutBoxBytes;
      if (lane == 0) ptx::bulk_wait_read<kOutBuffers - 1>();  // its last read
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kOutTiles; ++j) {
        const uint32_t at = tile + g * kRowBytes + ((j ^ g) << 4) + 4 * t;
        ptx::st_shared_b32(at, ptx::pack_bf16x2(o[4 * j], o[4 * j + 1]));
        ptx::st_shared_b32(at + 8 * kRowBytes,
                           ptx::pack_bf16x2(o[4 * j + 2], o[4 * j + 3]));
      }
      fence_staging();
      __syncwarp();
      if (lane == 0) {
        ptx::tma_store_4d(&to, tile, c * kChunk, it.row0 + row_w, it.h, it.b);
        ptx::bulk_commit();
      }
    };
    for (int item = blockIdx.x; item < p.items; item += gridDim.x) {
      const Item it = item_at(item, p);
      const bool rows_in = it.row0 + row_w < p.N;  // any of the warp's rows

      // ---- logits: S = q k^T, 4 k16 steps a chunk ----
      float s_acc[KT * 4];
      for (int c = 0; c < L; ++c) {
        const uint32_t st = wait_full();
        const uint64_t dq = ptx::desc_sw128(st + wg * 64 * kRowBytes);
        const uint64_t dk = ptx::desc_sw128(st + kQBoxBytes);
        ptx::fence_operands(s_acc);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk)
          ptx::wgmma_m64nNk16_ss<KT * 8>(s_acc, dq + 2 * kk, dk + 2 * kk,
                                         c + kk > 0);
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        ptx::fence_operands(s_acc);
        release();
      }

      // ---- softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) of the
      // warp; key tiles all at or past M are skipped ----
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < KT; ++j)
        if (j * 8 < p.M)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j * 8 + 2 * t + (e & 1);
            const float x = key < p.M ? s_acc[4 * j + e] * p.scale : -INFINITY;
            s_acc[4 * j + e] = x;
            mx[e] = fmaxf(mx[e], x);
          }
      float sum[4] = {0.f, 0.f, 0.f, 0.f}, row_max[2], row_sum[2], inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        row_max[r] = quad_max(fmaxf(mx[2 * r], mx[2 * r + 1]));
#pragma unroll
      for (int j = 0; j < KT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x =
              j * 8 < p.M ? expf(s_acc[4 * j + e] - row_max[e >> 1]) : 0.f;
          s_acc[4 * j + e] = x;
          sum[e] += x;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        row_sum[r] = quad_sum(sum[2 * r] + sum[2 * r + 1]);
        inv[r] = __frcp_rn(row_sum[r]);
      }
      // P = e / sum in fp32, rounded to bf16 (the TPU kernel's
      // p.astype(v.dtype)): key tiles 2i and 2i + 1 are the A fragment of
      // the k16 step over keys 16i..16i+15
      uint32_t pk[kKeySteps][4];
#pragma unroll
      for (int i = 0; i < kKeySteps; ++i) {
        const int j = 8 * i;   // tile 2i at j, tile 2i + 1 at j + 4
        float q[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int r = (e >> 1) & 1;
          q[e] = div_by(s_acc[j + e], row_sum[r], inv[r]);
        }
        pk[i][0] = ptx::pack_bf16x2(q[0], q[1]);
        pk[i][1] = ptx::pack_bf16x2(q[2], q[3]);
        pk[i][2] = ptx::pack_bf16x2(q[4], q[5]);
        pk[i][3] = ptx::pack_bf16x2(q[6], q[7]);
      }

      // ---- out = P v, chunk by chunk, each stored by TMA; keys at or past
      // M meet P = 0 and zero rows of v ----
      for (int c = 0; c < L; ++c) {
        const uint32_t v = wait_full() + kQBoxBytes;
        float o[kChunk / 2];
        ptx::fence_operands(o);
        ptx::wgmma_fence();
#pragma unroll
        for (int i = 0; i < kKeySteps; ++i)
          ptx::wgmma_m64n64k16_rs(o, pk[i], ptx::desc_sw128(v + i * 2048),
                                  i > 0);
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        ptx::fence_operands(o);
        release();
        if (rows_in) store(o, it, c);
      }
    }
    if (lane == 0) ptx::bulk_wait<0>();
  }
}

// A (B, H, rows, D) bf16 view as a tensor map of [box_rows x 64] boxes.
bool encode_map(CUtensorMap* map, const void* ptr, int B, int H, int rows,
                int D, long long sb, long long sh, long long sn,
                int box_rows) {
  return tma::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, B, H,
                         rows, D, sb, sh, sn, kChunk, box_rows);
}

// Per device and instance, once: the SM count, the stages the shared memory
// holds, and the instance's shared-memory attribute.
struct Launch {
  int sms = 0, stages = 0, smem = 0;
};

template <int KT>
int launch_config(Launch* out) {
  static Launch known[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && known[dev].sms > 0) {
    *out = known[dev];
    return 0;
  }
  int sms = 0, optin = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return (int)e;
  Launch l;
  l.sms = sms;
  l.stages = (optin - kBarBytes - kAlign - kStagingBytes) / Stage<KT>::kBytes;
  if (l.stages > kMaxStages) l.stages = kMaxStages;
  if (l.stages < 2) return (int)cudaErrorInvalidConfiguration;
  l.smem = kBarBytes + kAlign + l.stages * Stage<KT>::kBytes + kStagingBytes;
  e = cudaFuncSetAttribute(attention_bf16_kernel<KT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices) known[dev] = l;
  *out = l;
  return 0;
}

template <int KT>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long (&st)[12], int B, int H, int N, int M, int D,
           float scale, cudaStream_t stream) {
  Launch l;
  const int err = launch_config<KT>(&l);
  if (err != 0) return err;
  CUtensorMap tq, tk, tv, to;
  if (!(encode_map(&tq, q, B, H, N, D, st[0], st[1], st[2], kRows) &&
        encode_map(&tk, k, B, H, M, D, st[3], st[4], st[5], KT * 8) &&
        encode_map(&tv, v, B, H, M, D, st[6], st[7], st[8], KT * 8) &&
        encode_map(&to, o, B, H, N, D, st[9], st[10], st[11], 16)))
    return (int)cudaErrorInvalidValue;
  const int row_blocks = (N + kRows - 1) / kRows;
  const int items = B * H * row_blocks;
  const Params p{H, N, M, D, row_blocks, items, l.stages, scale};
  const int grid = items < l.sms ? items : l.sms;
  attention_bf16_kernel<KT><<<grid, kThreads, l.smem, stream>>>(tq, tk, tv,
                                                                to, p);
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
      D % kDimMultiple != 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * H * ((N + kRows - 1) / kRows) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (!(aligned(q) && aligned(k) && aligned(v) && aligned(o) &&
        aligned(q_sb, B) && aligned(q_sh, H) && aligned(q_sn, N) &&
        aligned(k_sb, B) && aligned(k_sh, H) && aligned(k_sn, M) &&
        aligned(v_sb, B) && aligned(v_sh, H) && aligned(v_sn, M) &&
        aligned(o_sb, B) && aligned(o_sh, H) && aligned(o_sn, N)))
    return (int)cudaErrorInvalidValue;
  const long long st[12] = {q_sb, q_sh, q_sn, k_sb, k_sh, k_sn,
                            v_sb, v_sh, v_sn, o_sb, o_sh, o_sn};
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 64) return launch<8>(q, k, v, o, st, B, H, N, M, D, scale, s);
  if (M <= 96) return launch<12>(q, k, v, o, st, B, H, N, M, D, scale, s);
  return launch<16>(q, k, v, o, st, B, H, N, M, D, scale, s);
}
