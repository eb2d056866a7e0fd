// K4: output layer + full row softmax, s8[B, K] x s8[K, N] -> f32 or bf16
// [B, out_dim], optionally masked (u8 [B, N], nonzero = active).
// K6: the masked K4 skipping every all-inactive (64-frame x 128-senone) tile.
// Both take the weight transposed, Wt s8[N, K] (ops/kernels.py:kernel_layout).
// K4 runs the wgmma loop, K6 the mma.sync loop (both below).
//
// Replaces, as K4, fastdnn_tpu/ops/pallas_kernels.py:
// output_layer_posteriors_resident -> _resident_softmax_kernel_factory
// (:321-434): unmasked or masked, both lazy semantics, f32 or bf16 (`fast`)
// posteriors; as K6, fastdnn_tpu/ops/pallas_kernels.py:
// output_layer_posteriors_resident_block_sparse ->
// _resident_block_sparse_kernel_factory (:974-1100).
//
// On the TPU the whole K x N int8 weight (16.8 MB at 2048 x 8192) sat in VMEM
// and each grid step saw complete logit rows.  No SM holds that, so here one
// block owns BM = 64 frames (their activations stay in shared memory), walks
// the N tiles 128 columns at a time, writes the logits of the columns below
// out_dim to device memory and keeps a running (max, sum-exp) per row; padding
// columns are capped at -1e30 as on the TPU (:346-348).  A second sweep of the
// same block rescales its own rows to exp(z - m) / s.  Softmax is per row, so
// no block needs another's result.
//
// Masking happens before the logit is stored or joins the stats, as in the
// TPU kernel (:340-345): under "reference" an inactive senone's logit is 0
// and takes part in the max, so the second sweep writes exp(0 - m) / s for
// it; under "active_only" it is -1e30 and adds nothing, and a row whose max
// stayed at -1e30 (no active senone) is written as zeros (:352-354).
//
// The mask is read one tile ahead: before a tile's products, each lane loads
// the 32 mask bytes of the next tile that its epilogue will need into
// registers (load_mask), and turns them into one word of bits only when that
// tile starts (mask_word).  K6's skip test is a __syncthreads_or over the
// same bits, so each block reads its own mask tiles, instead of a
// wrapper-side activity table as the TPU's scalar prefetch had
// (:1062-1064).  A skipped
// tile loads no weight and issues no MMA, but still counts: its valid columns
// are stored and folded into the stats as the fill logit (0 under
// "reference": the max becomes max(m, 0) and the sum gains count * exp(0 -
// m); -1e30 under "active_only": nothing).  The skip granularity is this
// kernel's 128-column tile, where the TPU's default was 512; the posteriors do
// not depend on it.
//
// Bound: 271 G int8 ops at B = 8192, K = 2048, N = 8064, but as for K2 the
// measured bound is L2 traffic: each block re-reads the whole 16.5 MB weight.
// The logits make one extra round trip through device memory (written, then
// read and rewritten in the second sweep: 2 x 4 x B x out_dim bytes), the part
// the TPU kept on chip.  The f32 path keeps them in the output itself; the
// bf16 path cannot, so its wrapper allocates an f32 scratch [B, out_dim]
// (262 MB at B = 8192, out_dim = 8000; written once, read once) and the second
// sweep reads it and writes 2-byte posteriors.  The mask adds one byte per
// (frame, padded column), read once (66 MB at B = 8192, N = 8064).  Read in
// the epilogue, after the tile's products, it showed: K4 masked took 2.96 ms
// against 2.29 unmasked, every tile waiting on it once more.  Read one tile
// ahead it costs 2.54 ms (H100 80GB HBM3 at 700 W, one call).  Only the
// masked instantiations carry the mask code (MASKED), so the unmasked main
// path keeps its 80 registers and its time.  expf, not __expf.
//
// Two loops:
//  * the wgmma loop (resident_softmax_wgmma_kernel): K4 in every variant
//    (unmasked, masked under both semantics, f32 or bf16), on
//    csrc/hopper.cuh's warp-specialised shape.  Bound of the unmasked f32
//    K4 at B = 8192, K = 2048, N = 8064, out_dim = 8000: 271 G int8 ops,
//    0.137 ms; the bytes in and out 295 MB (0.088 ms); the second sweep's
//    extra round trip of the logits is 524 MB more.  A cluster of 2 blocks
//    owns 64 frames, and each block takes half of the column tiles: twice
//    the blocks of one per 64 frames, so a batch below 132 x 64 frames
//    keeps twice the SMs busy.  A producer warp streams the block's [N, K]
//    weight tiles by TMA (128-byte swizzle, 128 x 128-byte boxes) through
//    an mbarrier ring that never drains; each stage is released with one
//    block-scope arrival (a cluster-scope release per stage cost about 40%
//    of the loop; PERF.md).  Two consumer warpgroups take the block's tiles
//    in turn: one dequantizes, masks, stores the logits and folds them into
//    its rows' running (max, sum-exp), held in registers (a row's columns
//    sit in 4 lanes of one warp), while the other runs the next tile's
//    products.  The mask bytes of a tile are loaded at the start of its
//    epilogue, all in flight at once, behind the other warpgroup's
//    products.  The two warpgroups' stats of a row merge by the same online
//    formula, then the two blocks' through distributed shared memory, in
//    rank order, so both get the same bits.  The second sweep rescales only
//    the block's own columns, on all 8 consumer warps with 16-byte accesses
//    and 8 loads in flight per thread; it is still about a third of the
//    kernel (PERF.md).
//  * the mma.sync loop below (resident_softmax_kernel): K6's skipping
//    variant, and every K4 variant kept callable off every path so the two
//    loops can be timed in turns on one card.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BM = 64;
// four stages: 16% faster than two (2.25-2.34 vs 2.75 ms at B = 8192,
// K = 2048, H100 80GB HBM3 at 700 W); the widest K that fits beside the
// 64-frame block is then 2048
constexpr int kStages = 4;
using fdn::kColsPerLane;
using fdn::kEmptyRowMax;
using fdn::kNegCap;
using fdn::kReference;
using fdn::kWarps;
using fdn::warp_max;
using fdn::warp_sum;
constexpr int kRowsPerWarp = BM / kWarps;  // epilogue rows of one warp

__host__ __device__ constexpr size_t smem_bytes(int k) {
  return static_cast<size_t>(BM) * k + kStages * fdn::kWStageBytes +
         sizeof(int) * BM * fdn::kLdc + 2 * sizeof(float) * BM;
}

__device__ __forceinline__ void store_p(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_p(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// MASKED: the mask (u8 [B, N]) is read, otherwise it is never touched.
// `logits` holds the raw f32 logits between the two sweeps; for f32
// posteriors it is `out` itself (so neither is __restrict__).
template <bool SKIP, bool MASKED, typename OutT>
__global__ void __launch_bounds__(fdn::kThreads)
    resident_softmax_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                            const int* __restrict__ colsum, const float* __restrict__ bias,
                            float inv_scale, const uint8_t* __restrict__ mask, int semantics,
                            float* logits, OutT* out, int K, int N, int out_dim) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* a_res = reinterpret_cast<int8_t*>(smem);
  int8_t* w_stage = a_res + BM * K;
  int* c_tile = reinterpret_cast<int*>(w_stage + kStages * fdn::kWStageBytes);
  float* row_m = reinterpret_cast<float*>(c_tile + BM * fdn::kLdc);
  float* row_s = row_m + BM;

  const int m0 = blockIdx.x * BM;
  const int chunks = K / 16;
  for (int i = threadIdx.x; i < BM * chunks; i += fdn::kThreads) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<int4*>(a_res + (c * BM + r) * 16) =
        *reinterpret_cast<const int4*>(x + static_cast<size_t>(m0 + r) * K + c * 16);
  }
  if (threadIdx.x < BM) {
    row_m[threadIdx.x] = -INFINITY;
    row_s[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  // the logit of an inactive senone
  const float fill = semantics == kReference ? 0.0f : kNegCap;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t raw[kRowsPerWarp][kColsPerLane] = {};
  if constexpr (MASKED) fdn::load_mask(raw, mask, N, m0, 0, warp, lane);
  for (int n0 = 0; n0 < N; n0 += fdn::kBN) {
    uint32_t word = ~0u;
    if constexpr (MASKED) {
      word = fdn::mask_word(raw);
      if (n0 + fdn::kBN < N) fdn::load_mask(raw, mask, N, m0, n0 + fdn::kBN, warp, lane);
    }
    bool active = true;
    // the tile is skipped when no lane of any warp holds a set bit
    if constexpr (SKIP) active = __syncthreads_or(word != 0) != 0;
    if (active) {
      fdn::Acc<BM> acc;
      fdn::mma_tile<BM, true, kStages>(acc, nullptr, 0, 0, a_res, wt, K, n0, K, nullptr, w_stage);
      fdn::store_acc<BM>(acc, c_tile);
    }
    __syncthreads();
    // one warp per row: lane covers columns lane, lane + 32, ... of the tile,
    // so the logit stores coalesce; each row's stats belong to one warp
    for (int r = warp; r < BM; r += kWarps, word >>= kColsPerLane) {
      const size_t row = static_cast<size_t>(m0 + r);
      float z[kColsPerLane];
      float tile_max = kNegCap;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int n = n0 + lane + 32 * j;
        float v = kNegCap;
        if (n < out_dim) {
          v = fill;
          if (active && (!MASKED || (word >> j & 1u))) {
            v = fdn::dequantize(c_tile[r * fdn::kLdc + lane + 32 * j], colsum[n], inv_scale,
                                bias[n]);
          }
          logits[row * out_dim + n] = v;
        }
        z[j] = v;
        tile_max = fmaxf(tile_max, v);
      }
      tile_max = warp_max(tile_max);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, tile_max);
      float e = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) e += expf(z[j] - m_new);
      e = warp_sum(e);
      __syncwarp();
      if (lane == 0) {
        row_s[r] = row_s[r] * expf(m_old - m_new) + e;
        row_m[r] = m_new;
      }
      __syncwarp();
    }
    __syncthreads();
  }

  // second sweep: each lane rescales exactly the logits it wrote above
  for (int r = warp; r < BM; r += kWarps) {
    const float m = row_m[r];
    const float s = row_s[r];
    const bool empty = m <= kEmptyRowMax;
    const size_t row = static_cast<size_t>(m0 + r) * out_dim;
    for (int n = lane; n < out_dim; n += 32)
      store_p(out + row + n, empty ? 0.0f : expf(logits[row + n] - m) / s);
  }
}

template <bool SKIP, bool MASKED, typename OutT>
int launch(const void* x, const void* wt, const void* colsum, const void* bias, float inv_scale,
           const void* mask, int semantics, void* logits, void* out, int b, int k, int n,
           int out_dim, int device, void* stream) {
  const size_t bytes = smem_bytes(k);
  auto kernel = resident_softmax_kernel<SKIP, MASKED, OutT>;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fdn::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b / BM, fdn::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
      static_cast<const uint8_t*>(mask), semantics, static_cast<float*>(logits),
      static_cast<OutT*>(out), k, n, out_dim);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the wgmma loop
// ---------------------------------------------------------------------------
namespace hp = fdn::hopper;

// six stages keep the widest K that fits at 2048
constexpr int kWgStages = 6;
// blocks of a cluster, sharing 64 frames and splitting the column tiles:
// 2 beat clusters of 2 blocks on 128 frames sharing stages by multicast, 4
// lost at B = 8192 (PERF.md)
constexpr int kSplit = 2;
// loads in flight per thread in the second sweep: 8 beat 4 by about 10%,
// 16 gained nothing more (PERF.md)
constexpr int kSweepInFlight = 8;
static_assert(hp::kConsumers == 2, "the row stats of two consumer warpgroups merge");

__host__ __device__ constexpr size_t wgmma_smem_bytes(int k) {
  return hp::kAlign + static_cast<size_t>(hp::kFrames) * k + kWgStages * hp::kStageBytes +
         hp::Ring<kWgStages, 1>::kBytes + sizeof(float2) * hp::kConsumers * hp::kFrames;
}

// One consumer warpgroup's tile: logits of columns [n0, n0 + 128) of its
// 64 rows (dequantized; -1e30 from out_dim on, never stored), stored to
// `logits`, and folded into the running (max, sum-exp) of the thread's two
// rows r and r + 8 (the 4 lanes of a quad hold a row's columns of the tile).
// MASKED: the mask (u8 [B, N], nonzero = active) decides each logit as in
// the mma.sync loop: an inactive senone's logit is `fill` (0 under
// reference, -1e30 under active_only).  Its 32 bytes pairs are loaded first,
// all in flight at once; the other warpgroup's products run meanwhile.
template <bool MASKED>
__device__ __forceinline__ void softmax_epilogue(const int (&d)[64], float* logits, int out_dim,
                                                 int m0, int n0, const int* colsum,
                                                 const float* bias, float inv,
                                                 const uint8_t* mask, int N, float fill,
                                                 int thread_in_wg, float (&m)[2], float (&s)[2]) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int col = n0 + 2 * (lane % 4);
  const int r0 = m0 + warp * 16 + lane / 4;
  float* rows[2] = {logits + static_cast<size_t>(r0) * out_dim,
                    logits + static_cast<size_t>(r0 + 8) * out_dim};
  uchar2 active[16][2];
  if constexpr (MASKED) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        active[q][h] =
            *reinterpret_cast<const uchar2*>(mask + static_cast<size_t>(r0 + 8 * h) * N + col + 8 * q);
  }
  const bool pairs = (out_dim & 1) == 0;  // a float2 store stays 8-byte aligned
  float z[64];
  float tile_max[2] = {kNegCap, kNegCap};
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int n = col + 8 * q;  // even, and n + 1 < N
    const int2 cs = *reinterpret_cast<const int2*>(colsum + n);
    const float2 b = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& v0 = z[4 * q + 2 * h];
      float& v1 = z[4 * q + 2 * h + 1];
      v0 = fdn::dequantize(d[4 * q + 2 * h], cs.x, inv, b.x);
      v1 = fdn::dequantize(d[4 * q + 2 * h + 1], cs.y, inv, b.y);
      if constexpr (MASKED) {
        if (!active[q][h].x) v0 = fill;
        if (!active[q][h].y) v1 = fill;
      }
      if (n >= out_dim) v0 = kNegCap;
      if (n + 1 >= out_dim) v1 = kNegCap;
      tile_max[h] = fmaxf(tile_max[h], fmaxf(v0, v1));
      if (pairs && n < out_dim) {
        *reinterpret_cast<float2*>(rows[h] + n) = make_float2(v0, v1);
      } else {
        if (n < out_dim) rows[h][n] = v0;
        if (n + 1 < out_dim) rows[h][n + 1] = v1;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
    tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
  }
  const float m_new[2] = {fmaxf(m[0], tile_max[0]), fmaxf(m[1], tile_max[1])};
  float e[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 64; ++i) e[(i >> 1) & 1] += expf(z[i] - m_new[(i >> 1) & 1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    e[h] += __shfl_xor_sync(0xffffffffu, e[h], 1);
    e[h] += __shfl_xor_sync(0xffffffffu, e[h], 2);
    s[h] = s[h] * expf(m[h] - m_new[h]) + e[h];
    m[h] = m_new[h];
  }
}

__device__ __forceinline__ float posterior(float z, float2 ms) {
  return ms.x <= kEmptyRowMax ? 0.0f : expf(z - ms.x) / ms.y;  // no active senone: zeros
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// The second sweep: columns [c0, c1) of the block's rows from logits to
// exp(z - m) / s, by the consumer threads (f32 posteriors overwrite their
// logits: `logits` is `out`).  16-byte accesses, kSweepInFlight loads in
// flight per thread, when out_dim % 4 == 0 (c0 and c1 then are multiples
// of 4); otherwise one warp per row, 4-byte accesses.
template <typename OutT>
__device__ __forceinline__ void rescale_rows(const float* logits, OutT* out, int out_dim, int m0,
                                             int c0, int c1, const float2* stats, int tid) {
  if ((out_dim & 3) == 0) {
    // the part is [64 rows x per_row] float4s, walked in steps of the
    // consumer threads from (r, j) = (tid / per_row, tid % per_row)
    const int per_row = (c1 - c0) / 4;
    if (per_row <= 0) return;
    int r = tid / per_row, j = tid - r * per_row;
    while (r < hp::kFrames) {
      float4 v[kSweepInFlight];
      int rows[kSweepInFlight], cols[kSweepInFlight];
#pragma unroll
      for (int u = 0; u < kSweepInFlight; ++u) {
        rows[u] = r;
        cols[u] = c0 + 4 * j;
        if (r < hp::kFrames)
          v[u] = *reinterpret_cast<const float4*>(logits + static_cast<size_t>(m0 + r) * out_dim + cols[u]);
        j += hp::kConsumerThreads;
        while (j >= per_row) {
          j -= per_row;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kSweepInFlight; ++u) {
        if (rows[u] < hp::kFrames) {
          const float2 ms = stats[rows[u]];
          store4(out + static_cast<size_t>(m0 + rows[u]) * out_dim + cols[u],
                 make_float4(posterior(v[u].x, ms), posterior(v[u].y, ms),
                             posterior(v[u].z, ms), posterior(v[u].w, ms)));
        }
      }
    }
  } else {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < hp::kFrames; r += hp::kConsumerThreads / 32) {
      const float2 ms = stats[r];
      const size_t row = static_cast<size_t>(m0 + r) * out_dim;
      for (int n = c0 + lane; n < c1; n += 32) store_p(out + row + n, posterior(logits[row + n], ms));
    }
  }
}

// the online merge of two (max, sum-exp) pairs; a pair that saw no column
// (-inf, 0) leaves the other as it is
__device__ __forceinline__ float2 merge_stats(float2 a, float2 b) {
  if (b.x == -INFINITY) return a;
  if (a.x == -INFINITY) return b;
  const float mm = fmaxf(a.x, b.x);
  return make_float2(mm, a.y * expf(a.x - mm) + b.y * expf(b.x - mm));
}

// a float2 at p's offset in the shared memory of block `cta` of the cluster
__device__ __forceinline__ float2 load_cluster(const float2* p, unsigned cta) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(fdn::smem_addr(p)), "r"(cta));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}

// The column tiles of a launch split over the kSplit blocks of a cluster,
// which share their 64 frames: block `rank` takes tiles [g0, g0 + tiles).
struct ColumnPart {
  int g0, tiles;
  __device__ __forceinline__ ColumnPart(int all_tiles, int rank) {
    const int per = (all_tiles + kSplit - 1) / kSplit;
    g0 = rank * per;
    tiles = min(all_tiles, g0 + per) - g0;
  }
};

// `logits` holds the raw f32 logits between the epilogue and the sweep;
// for f32 posteriors it is `out` itself (so neither is __restrict__).
// A cluster of kSplit blocks owns 64 frames; each block reads its own part
// of the column tiles (no multicast), and the blocks trade their rows'
// (max, sum-exp) through distributed shared memory before each rescales
// its own columns.
template <bool MASKED, typename OutT>
__global__ void __launch_bounds__(hp::kThreads, 1)
    resident_softmax_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                                  const int8_t* __restrict__ x, const int* __restrict__ colsum,
                                  const float* __restrict__ bias, float inv_scale,
                                  const uint8_t* __restrict__ mask, int semantics, float* logits,
                                  OutT* out, int K, int N, int out_dim) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hp::align_smem(smem_raw);
  int8_t* acts = reinterpret_cast<int8_t*>(smem);
  int8_t* stages = acts + hp::kFrames * K;
  uint64_t* bars = reinterpret_cast<uint64_t*>(stages + kWgStages * hp::kStageBytes);
  hp::Ring<kWgStages, 1> ring{bars};
  // (m, s) per row: [warpgroup][row]; the block's merge goes to [0][row],
  // the cluster's to [1][row]
  float2* stats = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(bars) +
                                            hp::Ring<kWgStages, 1>::kBytes);

  const int wg = threadIdx.x / 128;
  const unsigned rank = hp::cluster_rank();
  const int m0 = blockIdx.x / kSplit * hp::kFrames;
  const ColumnPart part(N / hp::kTileN, rank);
  const int steps = K / hp::kStageK;
  if (threadIdx.x == 0) ring.init();
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      for (int g = 0; g < part.tiles; ++g)
        for (int t = 0; t < steps; ++t)
          ring.produce(stages, &w_map, g * steps + t, t * hp::kStageK, (part.g0 + g) * hp::kTileN, 0);
    }
    hp::cluster_sync();  // the consumers' exchange
    hp::cluster_sync();
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    const int tid = threadIdx.x;
    const int tw = tid % 128;
    const float fill = semantics == kReference ? 0.0f : kNegCap;  // an inactive senone's logit
    hp::load_frames(acts, x, m0, K, tid, hp::kConsumerThreads);
    hp::fence_proxy_async();
    hp::consumer_sync();
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    float m[2] = {-INFINITY, -INFINITY};
    float s[2] = {0.0f, 0.0f};
    for (int g = wg, n = 0; g < part.tiles; g += hp::kConsumers, ++n) {
      hp::tile_products(d, ring, stages, acts, K, g * steps, wg, n, tw);
      softmax_epilogue<MASKED>(d, logits, out_dim, m0, (part.g0 + g) * hp::kTileN, colsum, bias,
                               inv_scale, mask, N, fill, tw, m, s);
    }
    if (tw % 4 == 0) {
      const int r = (tw / 32) * 16 + (tw % 32) / 4;
      stats[wg * hp::kFrames + r] = make_float2(m[0], s[0]);
      stats[wg * hp::kFrames + r + 8] = make_float2(m[1], s[1]);
    }
    __threadfence_block();  // the logits, for the sweep's other threads
    hp::consumer_sync();
    if (tid < hp::kFrames) stats[tid] = merge_stats(stats[tid], stats[hp::kFrames + tid]);
    hp::cluster_sync();  // every block's [0][row] is merged
    if (tid < hp::kFrames) {  // in rank order, so every block gets the same bits
      float2 all = make_float2(-INFINITY, 0.0f);
#pragma unroll
      for (int p = 0; p < kSplit; ++p) all = merge_stats(all, load_cluster(stats + tid, p));
      stats[hp::kFrames + tid] = all;
    }
    hp::consumer_sync();
    rescale_rows(logits, out, out_dim, m0, min(part.g0 * hp::kTileN, out_dim),
                 min((part.g0 + part.tiles) * hp::kTileN, out_dim), stats + hp::kFrames, tid);
    hp::cluster_sync();  // no block leaves while another reads its stats
  }
}

template <bool MASKED, typename OutT>
int launch_wgmma_variant(const CUtensorMap& map, const void* x, const void* colsum,
                         const void* bias, float inv_scale, const void* mask, int semantics,
                         void* logits, void* out, int b, int k, int n, int out_dim, void* stream) {
  return static_cast<int>(hp::launch_clustered(
      resident_softmax_wgmma_kernel<MASKED, OutT>, kSplit * b / hp::kFrames, kSplit,
      wgmma_smem_bytes(k), stream, map, static_cast<const int8_t*>(x),
      static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
      static_cast<const uint8_t*>(mask), semantics, static_cast<float*>(logits),
      static_cast<OutT*>(out), k, n, out_dim));
}

}  // namespace

// K4.  mask: nullptr (unmasked) or u8 [B, N]; semantics 0 reference,
// 1 active_only.  fast == 0: out is f32 [B, out_dim] and `logits` is ignored
// (the logits live in out); fast != 0: out is bf16 [B, out_dim] and `logits`
// an f32 [B, out_dim] scratch.  Requires B % 64 == 0, K % 128 == 0,
// N % 128 == 0, 0 < out_dim <= N, 16-byte aligned x, wt and mask, and
// fdn_resident_softmax_smem_bytes(K) within the block limit (checked by the
// wrapper).
extern "C" int fdn_resident_softmax(const void* x, const void* wt, const void* colsum,
                                    const void* bias, float inv_scale, const void* mask,
                                    int semantics, void* logits, void* out, int fast, int b, int k,
                                    int n, int out_dim, int device, void* stream) {
  if (fast && mask)
    return launch<false, true, __nv_bfloat16>(x, wt, colsum, bias, inv_scale, mask, semantics,
                                              logits, out, b, k, n, out_dim, device, stream);
  if (fast)
    return launch<false, false, __nv_bfloat16>(x, wt, colsum, bias, inv_scale, mask, semantics,
                                               logits, out, b, k, n, out_dim, device, stream);
  if (mask)
    return launch<false, true, float>(x, wt, colsum, bias, inv_scale, mask, semantics, out, out,
                                      b, k, n, out_dim, device, stream);
  return launch<false, false, float>(x, wt, colsum, bias, inv_scale, mask, semantics, out, out, b,
                                     k, n, out_dim, device, stream);
}

// K6: masked (mask u8 [B, N], required), f32 out [B, out_dim]; the same
// requirements as K4.
extern "C" int fdn_resident_softmax_block_sparse(const void* x, const void* wt,
                                                 const void* colsum, const void* bias,
                                                 float inv_scale, const void* mask, int semantics,
                                                 void* out, int b, int k, int n, int out_dim,
                                                 int device, void* stream) {
  return launch<true, true, float>(x, wt, colsum, bias, inv_scale, mask, semantics, out, out, b,
                                   k, n, out_dim, device, stream);
}

extern "C" long long fdn_resident_softmax_smem_bytes(int k) {
  return static_cast<long long>(smem_bytes(k));
}

// K4's wgmma loop: the arguments of fdn_resident_softmax, and the same
// requirements (B % 64 == 0) with fdn_resident_softmax_wgmma_smem_bytes(K)
// for the shared memory.
extern "C" int fdn_resident_softmax_wgmma(const void* x, const void* wt, const void* colsum,
                                          const void* bias, float inv_scale, const void* mask,
                                          int semantics, void* logits, void* out, int fast, int b,
                                          int k, int n, int out_dim, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  CUtensorMap map;
  if (err == cudaSuccess) err = hp::weight_map(&map, wt, n, k, hp::kTileN);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fast && mask)
    return launch_wgmma_variant<true, __nv_bfloat16>(
        map, x, colsum, bias, inv_scale, mask, semantics, logits, out, b, k, n, out_dim, stream);
  if (fast)
    return launch_wgmma_variant<false, __nv_bfloat16>(
        map, x, colsum, bias, inv_scale, mask, semantics, logits, out, b, k, n, out_dim, stream);
  if (mask)
    return launch_wgmma_variant<true, float>(
        map, x, colsum, bias, inv_scale, mask, semantics, out, out, b, k, n, out_dim, stream);
  return launch_wgmma_variant<false, float>(
      map, x, colsum, bias, inv_scale, mask, semantics, out, out, b, k, n, out_dim, stream);
}

extern "C" long long fdn_resident_softmax_wgmma_smem_bytes(int k) {
  return static_cast<long long>(wgmma_smem_bytes(k));
}

// Clusters of the wgmma loop (kSplit blocks each) at input width k that the
// card seats at once (-1 if it cannot tell).
extern "C" int fdn_resident_softmax_wgmma_max_clusters(int k, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  return hp::max_active_clusters(resident_softmax_wgmma_kernel<false, float>, kSplit,
                                 wgmma_smem_bytes(k));
}
