// K4: output layer + full row softmax, s8[B, K] x s8[K, N] -> f32 or bf16
// [B, out_dim], optionally masked (u8 [B, N], nonzero = active).
// K6: the masked K4 skipping every all-inactive (64-frame x 128-senone) tile.
// K4's ROWSCALE variant (f32, masked or not): each row dequantizes with its
// own scale, row_scale[r], in place of the layer's: a low-rank output
// layer's expand product on the bottleneck's signed codes (no zero point,
// csrc/lowrank_layer.cu), at K = the rank.
// Both take the weight transposed, Wt s8[N, K] (ops/kernels.py:kernel_layout),
// and run one kernel, resident_softmax_wgmma_kernel, on csrc/hopper.cuh's
// warp-specialised wgmma loop; K6 is its SPARSE variant.
//
// Replaces, as K4, fastdnn_tpu/ops/pallas_kernels.py:
// output_layer_posteriors_resident -> _resident_softmax_kernel_factory
// (:321-434): unmasked or masked, both lazy semantics, f32 or bf16 (`fast`)
// posteriors; as K6, fastdnn_tpu/ops/pallas_kernels.py:
// output_layer_posteriors_resident_block_sparse ->
// _resident_block_sparse_kernel_factory (:974-1100).
//
// On the TPU the whole K x N int8 weight (16.8 MB at 2048 x 8192) sat in VMEM
// and each grid step saw complete logit rows.  No SM holds that, so here a
// cluster of kSplit = 2 blocks owns 64 frames (their activations stay in each
// block's shared memory) and each block walks half of the N tiles, 128
// columns at a time: it writes the logits of the columns below out_dim to
// device memory and keeps a running (max, sum-exp) per row; padding columns
// are capped at -1e30 as on the TPU (:346-348).  The two blocks trade their
// rows' stats through distributed shared memory, then a second sweep of each
// block rescales its own columns to exp(z - m) / s.
//
// Masking happens before the logit is stored or joins the stats, as in the
// TPU kernel (:340-345): under "reference" an inactive senone's logit is 0
// and takes part in the max, so the second sweep writes exp(0 - m) / s for
// it; under "active_only" it is -1e30 and adds nothing, and a row whose max
// stayed at -1e30 (no active senone) is written as zeros (:352-354).
//
// Bound: the unmasked f32 K4 at B = 8192, K = 2048, N = 8064, out_dim =
// 8000 is 271 G int8 ops, 0.137 ms; the bytes in and out 295 MB (0.088 ms);
// the second sweep's extra round trip of the logits (the part the TPU kept
// on chip) is 524 MB more.  The bf16 path cannot keep the logits in its
// output, so its wrapper allocates an f32 scratch [B, out_dim] (written
// once, read once) and the second sweep reads it and writes 2-byte
// posteriors.  The mask adds one byte per (frame, padded column).
//
// The loop.  A producer thread streams the block's [N, K] weight tiles by
// TMA (128-byte swizzle, 128 x 128-byte boxes) through an mbarrier ring that
// never drains; each stage is released with one block-scope arrival (a
// cluster-scope release per stage cost about 40% of the loop; PERF.md).  Two
// consumer warpgroups take the block's tiles in turn: one dequantizes,
// masks, stores the logits and folds them into its rows' running (max,
// sum-exp), held in registers (a row's columns sit in 4 lanes of one warp),
// while the other runs the next tile's products.  The mask bytes of a tile
// are loaded at the start of its epilogue, all in flight at once, behind the
// other warpgroup's products.  The two warpgroups' stats of a row merge by
// the same online formula, then the two blocks' through distributed shared
// memory, in rank order, so both get the same bits.  Splitting the columns
// over two blocks that share 64 frames gives a batch below 132 x 64 frames
// twice the SMs.  The second sweep rescales only the block's own columns,
// on all 8 consumer warps with 16-byte accesses and 8 loads in flight per
// thread; in K4 it is about a third of the kernel (PERF.md).  expf, not
// __expf.
//
// RECOMPUTE: two passes over the products in place of the logits' round
// trip, for a short K (the wrapper chooses by K alone:
// ops/kernels.py:_recomputes).  At K = 256 (the SVD net's output layer, B =
// 8192, N = 6016, out_dim 5976) the products are 25 G int8 operations
// (0.013 ms), while the round trip, 196 MB of logits stored, then read back
// and overwritten, moved 588 MB: K4 took 0.41 ms.  Pass 1 runs the block's
// products and folds each dequantized, masked logit into its row's (max,
// sum-exp) as above, storing nothing; the stats merge as above; pass 2
// streams the same weight tiles a second time (the frames stay in shared
// memory; at K = 256 the whole weight, 1.54 MB, sits in L2), runs the
// products again, whose integers are exact, so the logits come out bitwise
// the same, and writes each posterior once.  Bound: the posteriors once,
// 196 MB, and the frames and weight, 3.6 MB (0.060 ms), against the
// products twice, 50 G operations (0.026 ms).  What the design does about
// it: the producer streams both passes without draining its ring, so pass
// 2's first tiles land during the exchange; the warpgroups keep their turns
// across the passes (one's epilogue beside the other's products); pass 2's
// posteriors leave through TMA stores from two 2 KB slots per warp (stores
// from registers, 16 rows of 32 bytes per warp instruction, held K4 at
// 0.335 ms; the staged stores 0.255); and a row's 1 / s is taken once, each
// quotient corrected by one FMA, where a division per element branched to
// its slow path (0.174 ms without).  The ring is 4 stages, so the slots fit
// at K = 2048.  The `fast` variant needs no f32 scratch.  At K = 1024 the
// two paths are within 5% of each other, and at 2048 the second pass's
// products cost more than the round trip saves (PERF.md, the timings in
// turns of chip_smoke.py's phase 33).
//
// K6 (SPARSE).  Before any product, the producer warpgroup reads the mask
// bytes of the block's own tiles (64 rows x 128 columns each, 16 loads in
// flight per thread, while the consumers load the frames) and keeps one bit
// per tile in shared memory, then the compacted list of the active tiles:
// the per-block part of the TPU's activity table (:1063-1064), which its
// scalar prefetch held.  The producer streams weight stages for the listed
// tiles only, the consumers take alternate entries of the list, and the
// ring's stage indices (and so its barrier parities) count list entries, so
// a skipped tile loads no stage, takes no ring slot and runs no wgmma.  Its
// valid columns still count as the fill logit: under reference the block's
// stats fold them in closed form, once (the max becomes max(m, 0), the sum
// gains count * exp(0 - m)); under active_only they add nothing.  No logit
// of a skipped tile is stored: the second sweep writes the fill's
// posterior, exp(0 - m) / s or 0, one value per row, without reading.  On
// clustered masks most tiles are skipped, so most of the sweep's round trip
// through device memory goes with the products.  The skip granularity is
// this kernel's 128-column tile, where the TPU's default was 512; the
// posteriors do not depend on it.  Bound at B = 8192, K = 2048, N = 8064:
// the bytes, frames 16.8 MB, weight 16.5 MB, masks 66 MB and posteriors
// 262 MB (0.108 ms); the products of the active tiles are a fraction of
// K4's 0.137 ms.
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "row_stats.cuh"

namespace {

namespace hp = fdn::hopper;
namespace rs = fdn::rowstats;
using fdn::kEmptyRowMax;
using fdn::kNegCap;
using fdn::kReference;
using rs::kSplit;
using SparseTiles = rs::SparseTiles<rs::kMaxPartTiles, uint8_t>;

// six stages keep the widest K that fits at 2048
constexpr int kStages = 6;
// RECOMPUTE: four stages, and each consumer warp's two slots of posteriors
// on their way out (a TMA store box of 16 rows x 128 bytes, 32 f32 or 64
// bf16 columns, in the 128-byte swizzle), so that K = 2048 fits too
constexpr int kRecomputeStages = 4;
constexpr int kStoreRows = 16;
constexpr int kBoxBytes = kStoreRows * 128;
constexpr int kStagingBytes = (hp::kConsumerThreads / 32) * 2 * kBoxBytes;
// loads in flight per thread in the second sweep: 8 beat 4 by about 10%,
// 16 gained nothing more (PERF.md)
constexpr int kSweepInFlight = 8;

template <bool SPARSE, bool RECOMPUTE = false>
__host__ __device__ constexpr size_t smem_bytes(int k) {
  return hp::kAlign + static_cast<size_t>(hp::kFrames) * k +
         (RECOMPUTE ? kRecomputeStages : kStages) * hp::kStageBytes +
         (RECOMPUTE ? kStagingBytes : 0) + hp::Ring<RECOMPUTE ? kRecomputeStages : kStages, 1>::kBytes +
         sizeof(float2) * hp::kConsumers * hp::kFrames + (SPARSE ? sizeof(SparseTiles) : 0);
}

__device__ __forceinline__ void store_p(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_p(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One consumer warpgroup's tile: logits of columns [n0, n0 + 128) of its
// 64 rows (dequantized, masked; -1e30 from out_dim on, never stored; the
// shared tile_logits), stored to `logits`, and folded into the running
// (max, sum-exp) of the thread's two rows r and r + 8.
// STORE false (RECOMPUTE's pass 1): the logits are folded, not stored.
template <bool MASKED, bool STORE = true>
__device__ __forceinline__ void softmax_epilogue(const int (&d)[64], float* logits, int out_dim,
                                                 int m0, int n0, const int* colsum,
                                                 const float* bias, const float (&inv)[2],
                                                 const uint8_t* mask, int N, float fill,
                                                 int thread_in_wg, float (&m)[2], float (&s)[2]) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int col = n0 + 2 * (lane % 4);
  const int r0 = m0 + warp * 16 + lane / 4;
  float* rows[2] = {logits + static_cast<size_t>(r0) * out_dim,
                    logits + static_cast<size_t>(r0 + 8) * out_dim};
  const bool pairs = (out_dim & 1) == 0;  // a float2 store stays 8-byte aligned
  float z[64], tile_max[2];
  rs::tile_logits<MASKED>(d, z, tile_max, r0, col, colsum, bias, inv, mask, N, fill, out_dim,
                          [&](int h, int n, float v0, float v1) {
                            if constexpr (STORE) {
                              if (pairs && n < out_dim) {
                                *reinterpret_cast<float2*>(rows[h] + n) = make_float2(v0, v1);
                              } else {
                                if (n < out_dim) rows[h][n] = v0;
                                if (n + 1 < out_dim) rows[h][n + 1] = v1;
                              }
                            }
                          });
  rs::quad_max(tile_max);
  rs::fold_stats(z, tile_max, m, s);
}

__device__ __forceinline__ float posterior(float z, float2 ms) {
  return ms.x <= kEmptyRowMax ? 0.0f : expf(z - ms.x) / ms.y;  // no active senone: zeros
}

// RECOMPUTE's posterior of a row: m, s its merged (max, sum-exp), r =
// RN(1 / s), or 0 for a row with no active senone (whose posteriors come
// out 0).  exp(z - m) / s as one product and one FMA correction (Markstein),
// the correctly rounded quotient wherever it is not subnormal, so bitwise
// posterior()'s in that range, without the division's slow-path branch at
// each element, which kept the compiler from overlapping the elements' work
// and cost about a third of the kernel (PERF.md)
struct RowNorm {
  float m, s, r;
};

__device__ __forceinline__ RowNorm row_norm(float2 ms) {
  return {ms.x, ms.y, ms.x <= kEmptyRowMax ? 0.0f : __frcp_rn(ms.y)};
}

__device__ __forceinline__ float posterior(float z, const RowNorm& n) {
  const float a = expf(z - n.m);
  const float q = __fmul_rn(a, n.r);
  return __fmaf_rn(__fmaf_rn(-n.s, q, a), n.r, q);
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// RECOMPUTE's pass 2, one consumer warpgroup's tile: the logits of columns
// [n0, n0 + 128) of its 64 rows, made again as softmax_epilogue made them,
// -> posteriors (posterior() with ms[h], the RowNorm of the thread's row
// r0 + 8 h) of the columns below out_dim, into `out`.  Staged
// (out's rows 16-byte aligned): each warp writes its 16 rows a box of 128
// bytes of columns at a time into one of its two slots at `staging`, and
// one lane stores the box by TMA (out_map clips the columns past out_dim)
// while the warp fills the other slot; otherwise stores from registers.
template <bool MASKED, typename OutT>
__device__ __forceinline__ void posterior_epilogue(const int (&d)[64], OutT* out,
                                                   const CUtensorMap* out_map,
                                                   unsigned char* staging, int out_dim, int m0,
                                                   int n0, const int* colsum, const float* bias,
                                                   const float (&inv)[2], const uint8_t* mask,
                                                   int N, float fill, const RowNorm (&ms)[2],
                                                   int thread_in_wg) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int col = n0 + 2 * (lane % 4);
  const int r0 = m0 + warp * kStoreRows + lane / 4;
  float z[64], tile_max[2];
  if (out_dim % (16 / sizeof(OutT)) != 0) {
    OutT* rows[2] = {out + static_cast<size_t>(r0) * out_dim,
                     out + static_cast<size_t>(r0 + 8) * out_dim};
    const bool pairs = (out_dim & 1) == 0;  // a pair's store stays aligned
    rs::tile_logits<MASKED>(d, z, tile_max, r0, col, colsum, bias, inv, mask, N, fill, out_dim,
                            [&](int h, int n, float v0, float v1) {
                              if (n >= out_dim) return;
                              const float p0 = posterior(v0, ms[h]);
                              if (pairs) {
                                store_pair(rows[h] + n, p0, posterior(v1, ms[h]));
                              } else {
                                store_p(rows[h] + n, p0);
                                if (n + 1 < out_dim) store_p(rows[h] + n + 1, posterior(v1, ms[h]));
                              }
                            });
    return;
  }
  constexpr int kBoxCols = 128 / sizeof(OutT);
  constexpr int kBoxQ = kBoxCols / 8;  // the thread's column pairs per row in a box
  rs::tile_logits<MASKED>(d, z, tile_max, r0, col, colsum, bias, inv, mask, N, fill, out_dim,
                          [](int, int, float, float) {});
  unsigned char* slots = staging + warp * 2 * kBoxBytes;
#pragma unroll
  for (int c = 0; c < hp::kTileN / kBoxCols; ++c) {
    unsigned char* box = slots + (c % 2) * kBoxBytes;
    if (lane == 0) hp::bulk_wait_read<1>();  // the slot's last box has left
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kBoxQ; ++j) {
      const int q = c * kBoxQ + j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lane / 4 + 8 * h;  // row % 8 == lane / 4
        const int byte = j * 2 * sizeof(OutT) * 4 + 2 * sizeof(OutT) * (lane % 4);
        store_pair(reinterpret_cast<OutT*>(box + row * 128 + (((byte >> 4) ^ (lane / 4)) << 4) +
                                           (byte & 15)),
                   posterior(z[4 * q + 2 * h], ms[h]), posterior(z[4 * q + 2 * h + 1], ms[h]));
      }
    }
    hp::fence_proxy_async();
    __syncwarp();  // the box is written
    if (lane == 0) {
      if (n0 + c * kBoxCols < out_dim)
        hp::tma_store(out_map, box, n0 + c * kBoxCols, m0 + warp * kStoreRows);
      hp::bulk_commit();
    }
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v.x, v.y);
  q[1] = __floats2bfloat162_rn(v.z, v.w);
}

// K6: does the block's tile holding column c (its part starting at column
// c0) have an active senone?
__device__ __forceinline__ bool tile_active(const SparseTiles* sp, int c, int c0) {
  return rs::part_tile_active(sp, (c - c0) / hp::kTileN);
}

// The second sweep: columns [c0, c1) of the block's rows from logits to
// exp(z - m) / s, by the consumer threads (f32 posteriors overwrite their
// logits: `logits` is `out`).  16-byte accesses, kSweepInFlight loads in
// flight per thread, when out_dim % 4 == 0 (c0 and c1 then are multiples
// of 4); otherwise one warp per row, 4-byte accesses.  SPARSE: a column of a
// skipped tile has no logit stored; it gets its row's fill posterior
// (sp->fill_p) without a load.
template <bool SPARSE, typename OutT>
__device__ __forceinline__ void rescale_rows(const float* logits, OutT* out, int out_dim, int m0,
                                             int c0, int c1, const float2* stats,
                                             const SparseTiles* sp, int tid) {
  if ((out_dim & 3) == 0) {
    // the part is [64 rows x per_row] float4s, walked in steps of the
    // consumer threads from (r, j) = (tid / per_row, tid % per_row)
    const int per_row = (c1 - c0) / 4;
    if (per_row <= 0) return;
    int r = tid / per_row, j = tid - r * per_row;
    while (r < hp::kFrames) {
      float4 v[kSweepInFlight];
      int rows[kSweepInFlight], cols[kSweepInFlight];
      bool skipped[kSweepInFlight] = {};
#pragma unroll
      for (int u = 0; u < kSweepInFlight; ++u) {
        rows[u] = r;
        cols[u] = c0 + 4 * j;
        if constexpr (SPARSE) skipped[u] = !tile_active(sp, cols[u], c0);
        if (r < hp::kFrames && !skipped[u])
          v[u] = *reinterpret_cast<const float4*>(logits + static_cast<size_t>(m0 + r) * out_dim + cols[u]);
        j += hp::kConsumerThreads;
        while (j >= per_row) {
          j -= per_row;
          ++r;
        }
      }
#pragma unroll
      for (int u = 0; u < kSweepInFlight; ++u) {
        if (rows[u] >= hp::kFrames) continue;
        float4 p;
        if (skipped[u]) {
          const float f = sp->fill_p[rows[u]];
          p = make_float4(f, f, f, f);
        } else {
          const float2 ms = stats[rows[u]];
          p = make_float4(posterior(v[u].x, ms), posterior(v[u].y, ms), posterior(v[u].z, ms),
                          posterior(v[u].w, ms));
        }
        store4(out + static_cast<size_t>(m0 + rows[u]) * out_dim + cols[u], p);
      }
    }
  } else {
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < hp::kFrames; r += hp::kConsumerThreads / 32) {
      const float2 ms = stats[r];
      const size_t row = static_cast<size_t>(m0 + r) * out_dim;
      for (int n = c0 + lane; n < c1; n += 32) {
        if constexpr (SPARSE) {
          if (!tile_active(sp, n, c0)) {
            store_p(out + row + n, sp->fill_p[r]);
            continue;
          }
        }
        store_p(out + row + n, posterior(logits[row + n], ms));
      }
    }
  }
}

// `logits` holds the raw f32 logits between the epilogue and the sweep;
// for f32 posteriors it is `out` itself (so neither is __restrict__).
// A cluster of kSplit blocks owns 64 frames; each block reads its own part
// of the column tiles (no multicast), and the blocks trade their rows'
// (max, sum-exp) through distributed shared memory before each rescales
// its own columns.  MASKED: the mask is read; SPARSE (K6, MASKED): tiles
// with no active senone are skipped; ROWSCALE: row r dequantizes with
// row_scale[r], not inv_scale; RECOMPUTE: the two passes over the products
// in place of the sweep (`logits` unused).
template <bool MASKED, bool SPARSE, typename OutT, bool ROWSCALE = false, bool RECOMPUTE = false>
__global__ void __launch_bounds__(hp::kThreads, 1)
    resident_softmax_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                                  const int8_t* __restrict__ x, const int* __restrict__ colsum,
                                  const float* __restrict__ bias, float inv_scale,
                                  const uint8_t* __restrict__ mask, int semantics, float* logits,
                                  OutT* out, int K, int N, int out_dim,
                                  const float* __restrict__ row_scale,
                                  const __grid_constant__ CUtensorMap out_map) {
  static_assert(MASKED || !SPARSE, "K6 is the masked variant");
  static_assert(!(SPARSE && ROWSCALE), "no skipping variant takes a per-row scale");
  static_assert(!(SPARSE && RECOMPUTE), "K6 stores no logit of a skipped tile: it keeps the sweep");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hp::align_smem(smem_raw);
  int8_t* acts = reinterpret_cast<int8_t*>(smem);
  constexpr int S = RECOMPUTE ? kRecomputeStages : kStages;
  int8_t* stages = acts + hp::kFrames * K;
  // RECOMPUTE: the consumer warps' posterior slots (1024-byte aligned)
  unsigned char* staging = reinterpret_cast<unsigned char*>(stages + S * hp::kStageBytes);
  uint64_t* bars = reinterpret_cast<uint64_t*>(staging + (RECOMPUTE ? kStagingBytes : 0));
  hp::Ring<S, 1> ring{bars};
  // (m, s) per row: [warpgroup][row]; the block's merge goes to [0][row],
  // the cluster's to [1][row]
  float2* stats = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(bars) +
                                            hp::Ring<S, 1>::kBytes);
  SparseTiles* sp =  // K6 only: nothing of it stays live in K4
      SPARSE ? reinterpret_cast<SparseTiles*>(stats + hp::kConsumers * hp::kFrames) : nullptr;

  const int wg = threadIdx.x / 128;
  const unsigned rank = hp::cluster_rank();
  const int m0 = blockIdx.x / kSplit * hp::kFrames;
  const rs::ColumnPart part(N / hp::kTileN, rank);
  const int steps = K / hp::kStageK;
  if (threadIdx.x == 0) ring.init();
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    if constexpr (SPARSE) {
      rs::find_active_tiles(sp, mask, N, m0, part, out_dim, threadIdx.x % 128);
      __syncwarp();
      rs::named_arrive<rs::kListBarrier, hp::kThreads>();
    }
    hp::reg_dealloc<hp::kProducerRegs>();
    if constexpr (RECOMPUTE) {
      // pass 2's stages are freed only after the consumers' exchange, so
      // the producer warpgroup arrives at it before it streams
      hp::cluster_arrive();
      if (threadIdx.x % 128 == 0) {
        // stage j * steps + t: the t-th 128 bytes of K of the block's tile
        // j (pass 1) or j - tiles (pass 2)
        for (int j = 0; j < 2 * part.tiles; ++j) {
          const int g = j < part.tiles ? j : j - part.tiles;
          for (int t = 0; t < steps; ++t)
            ring.produce(stages, &w_map, j * steps + t, t * hp::kStageK, (part.g0 + g) * hp::kTileN,
                         0);
        }
      }
      hp::cluster_wait();
    } else {
      if (threadIdx.x % 128 == 0) {
        // stage e * steps + t: the t-th 128 bytes of K of the e-th tile taken
        const int count = SPARSE ? sp->count : part.tiles;
        for (int e = 0; e < count; ++e) {
          const int g = SPARSE ? sp->list[e] : e;
          for (int t = 0; t < steps; ++t)
            ring.produce(stages, &w_map, e * steps + t, t * hp::kStageK, (part.g0 + g) * hp::kTileN, 0);
        }
      }
      hp::cluster_sync();  // the consumers' exchange
    }
    hp::cluster_sync();
  } else {
    const int tid = threadIdx.x;
    const int tw = tid % 128;
    const float fill = semantics == kReference ? 0.0f : kNegCap;  // an inactive senone's logit
    // K6: the frames load while the producer warpgroup finds the active
    // tiles, before the register grant, which waits for its release
    if constexpr (SPARSE) hp::load_frames(acts, x, m0, K, tid, hp::kConsumerThreads);
    hp::reg_alloc<hp::kConsumerRegs>();
    if constexpr (!SPARSE) hp::load_frames(acts, x, m0, K, tid, hp::kConsumerThreads);
    hp::fence_proxy_async();
    if constexpr (SPARSE) rs::named_sync<rs::kListBarrier, hp::kThreads>();
    hp::consumer_sync();
    const int count = SPARSE ? sp->count : part.tiles;
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    float m[2] = {-INFINITY, -INFINITY};
    float s[2] = {0.0f, 0.0f};
    float inv[2] = {inv_scale, inv_scale};  // the scales of the thread's rows r0 and r0 + 8
    if constexpr (ROWSCALE) {
      const int r0 = m0 + (tw / 32) * 16 + (tw % 32) / 4;
      inv[0] = row_scale[r0];
      inv[1] = row_scale[r0 + 8];
    }
    // the warpgroups take the tiles in turn, e = wg, wg + 2, ...; under
    // RECOMPUTE the turns run on through pass 2, e = count + the tile
    int e = wg, n = 0;
    for (; e < count; e += hp::kConsumers, ++n) {
      const int g = SPARSE ? sp->list[e] : e;
      hp::tile_products(d, ring, stages, acts, K, e * steps, wg, n, tw);
      softmax_epilogue<MASKED, !RECOMPUTE>(d, logits, out_dim, m0, (part.g0 + g) * hp::kTileN,
                                           colsum, bias, inv, mask, N, fill, tw, m, s);
    }
    const int r = (tw / 32) * 16 + (tw % 32) / 4;  // the thread's rows r and r + 8
    if (tw % 4 == 0) {
      stats[wg * hp::kFrames + r] = make_float2(m[0], s[0]);
      stats[wg * hp::kFrames + r + 8] = make_float2(m[1], s[1]);
    }
    if constexpr (!RECOMPUTE) __threadfence_block();  // the logits, for the sweep's other threads
    hp::consumer_sync();
    if (tid < hp::kFrames) {
      float2 block = rs::merge_stats(stats[tid], stats[hp::kFrames + tid]);
      // K6 under reference: the skipped tiles' valid columns, logit 0 each
      if constexpr (SPARSE) {
        if (semantics == kReference && sp->skipped_cols > 0)
          block = rs::merge_stats(block, make_float2(0.0f, static_cast<float>(sp->skipped_cols)));
      }
      stats[tid] = block;
    }
    hp::cluster_sync();  // every block's [0][row] is merged
    if (tid < hp::kFrames) {  // in rank order, so every block gets the same bits
      float2 all = make_float2(-INFINITY, 0.0f);
#pragma unroll
      for (int p = 0; p < kSplit; ++p) all = rs::merge_stats(all, rs::load_cluster(stats + tid, p));
      stats[hp::kFrames + tid] = all;
      if constexpr (SPARSE) sp->fill_p[tid] = posterior(fill, all);
    }
    hp::consumer_sync();
    if constexpr (RECOMPUTE) {
      const RowNorm ms[2] = {row_norm(stats[hp::kFrames + r]), row_norm(stats[hp::kFrames + r + 8])};
      for (; e < 2 * count; e += hp::kConsumers, ++n) {
        hp::tile_products(d, ring, stages, acts, K, e * steps, wg, n, tw);
        posterior_epilogue<MASKED>(d, out, &out_map, staging + wg * (kStagingBytes / 2), out_dim,
                                   m0, (part.g0 + e - count) * hp::kTileN, colsum, bias, inv, mask,
                                   N, fill, ms, tw);
      }
      if (tw % 32 == 0) hp::bulk_wait_all();  // the posteriors have left the slots
    } else {
      rescale_rows<SPARSE>(logits, out, out_dim, m0, min(part.g0 * hp::kTileN, out_dim),
                           min((part.g0 + part.tiles) * hp::kTileN, out_dim), stats + hp::kFrames,
                           sp, tid);
    }
    hp::cluster_sync();  // no block leaves while another reads its stats
  }
}

template <bool MASKED, bool SPARSE, typename OutT, bool ROWSCALE = false, bool RECOMPUTE = false>
int launch(const void* x, const void* wt, const void* colsum, const void* bias, float inv_scale,
           const void* mask, int semantics, void* logits, void* out, int b, int k, int n,
           int out_dim, int device, void* stream, const void* row_scale = nullptr) {
  CUtensorMap map, out_map;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = hp::weight_map(&map, wt, n, k, hp::kTileN);
  out_map = map;  // read only by RECOMPUTE's staged stores
  if (err == cudaSuccess && RECOMPUTE && out_dim % (16 / sizeof(OutT)) == 0)
    err = sizeof(OutT) == 4
              ? hp::tensor_map(&out_map, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, out_dim,
                               kStoreRows)
              : hp::tensor_map(&out_map, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, out_dim,
                               kStoreRows);
  if (err == cudaSuccess)
    err = hp::launch_clustered(
        resident_softmax_wgmma_kernel<MASKED, SPARSE, OutT, ROWSCALE, RECOMPUTE>, kSplit * b / hp::kFrames,
        kSplit, smem_bytes<SPARSE, RECOMPUTE>(k), stream, map, static_cast<const int8_t*>(x),
        static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
        static_cast<const uint8_t*>(mask), semantics, static_cast<float*>(logits),
        static_cast<OutT*>(out), k, n, out_dim, static_cast<const float*>(row_scale), out_map);
  return static_cast<int>(err);
}

template <bool RECOMPUTE>
int resident(const void* x, const void* wt, const void* colsum, const void* bias, float inv_scale,
             const void* mask, int semantics, void* logits, void* out, int fast, int b, int k,
             int n, int out_dim, int device, void* stream) {
  if (fast && mask)
    return launch<true, false, __nv_bfloat16, false, RECOMPUTE>(
        x, wt, colsum, bias, inv_scale, mask, semantics, logits, out, b, k, n, out_dim, device,
        stream);
  if (fast)
    return launch<false, false, __nv_bfloat16, false, RECOMPUTE>(
        x, wt, colsum, bias, inv_scale, mask, semantics, logits, out, b, k, n, out_dim, device,
        stream);
  if (mask)
    return launch<true, false, float, false, RECOMPUTE>(x, wt, colsum, bias, inv_scale, mask,
                                                        semantics, out, out, b, k, n, out_dim,
                                                        device, stream);
  return launch<false, false, float, false, RECOMPUTE>(x, wt, colsum, bias, inv_scale, mask,
                                                       semantics, out, out, b, k, n, out_dim,
                                                       device, stream);
}

template <bool RECOMPUTE>
int resident_rowscale(const void* x, const void* wt, const void* colsum, const void* bias,
                      const void* row_scale, const void* mask, int semantics, void* out, int b,
                      int k, int n, int out_dim, int device, void* stream) {
  if (mask)
    return launch<true, false, float, true, RECOMPUTE>(x, wt, colsum, bias, 0.0f, mask, semantics,
                                                       out, out, b, k, n, out_dim, device, stream,
                                                       row_scale);
  return launch<false, false, float, true, RECOMPUTE>(x, wt, colsum, bias, 0.0f, mask, semantics,
                                                      out, out, b, k, n, out_dim, device, stream,
                                                      row_scale);
}

}  // namespace

// K4.  mask: nullptr (unmasked) or u8 [B, N]; semantics 0 reference,
// 1 active_only.  fast == 0: out is f32 [B, out_dim] and `logits` is ignored
// (the logits live in out); fast != 0: out is bf16 [B, out_dim] and `logits`
// an f32 [B, out_dim] scratch, unused (may be nullptr) under recompute.
// recompute != 0: the two passes over the products in place of the sweep.
// Requires B % 64 == 0, K % 128 == 0, N % 128 == 0, 0 < out_dim <= N,
// 16-byte aligned x, wt and mask, and fdn_resident_softmax_wgmma_smem_bytes(K)
// (recompute: fdn_resident_softmax_recompute_smem_bytes(K)) within the block
// limit (checked by the wrapper).
extern "C" int fdn_resident_softmax_wgmma(const void* x, const void* wt, const void* colsum,
                                          const void* bias, float inv_scale, const void* mask,
                                          int semantics, void* logits, void* out, int fast,
                                          int recompute, int b, int k, int n, int out_dim,
                                          int device, void* stream) {
  return recompute ? resident<true>(x, wt, colsum, bias, inv_scale, mask, semantics, logits, out,
                                    fast, b, k, n, out_dim, device, stream)
                   : resident<false>(x, wt, colsum, bias, inv_scale, mask, semantics, logits, out,
                                     fast, b, k, n, out_dim, device, stream);
}

// K4's ROWSCALE variant: f32 out [B, out_dim], masked or not, row r's
// logits dequantized with row_scale[r] (f32 [B]); K4's requirements and its
// recompute flag.
extern "C" int fdn_resident_softmax_rowscale(const void* x, const void* wt, const void* colsum,
                                             const void* bias, const void* row_scale,
                                             const void* mask, int semantics, void* out,
                                             int recompute, int b, int k, int n, int out_dim,
                                             int device, void* stream) {
  if (row_scale == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return recompute ? resident_rowscale<true>(x, wt, colsum, bias, row_scale, mask, semantics, out,
                                             b, k, n, out_dim, device, stream)
                   : resident_rowscale<false>(x, wt, colsum, bias, row_scale, mask, semantics, out,
                                              b, k, n, out_dim, device, stream);
}

extern "C" long long fdn_resident_softmax_wgmma_smem_bytes(int k) {
  return static_cast<long long>(smem_bytes<false>(k));
}

// K4 under recompute: a ring of four stages and the posteriors' slots
extern "C" long long fdn_resident_softmax_recompute_smem_bytes(int k) {
  return static_cast<long long>(smem_bytes<false, true>(k));
}

// K6: masked (mask u8 [B, N], required), f32 out [B, out_dim]; the
// requirements of K4, with fdn_resident_softmax_block_sparse_smem_bytes(K)
// for the shared memory, and N <= 65,536 (kSplit * 128 * kMaxPartTiles).
extern "C" int fdn_resident_softmax_block_sparse(const void* x, const void* wt,
                                                 const void* colsum, const void* bias,
                                                 float inv_scale, const void* mask, int semantics,
                                                 void* out, int b, int k, int n, int out_dim,
                                                 int device, void* stream) {
  if (mask == nullptr || n > kSplit * hp::kTileN * rs::kMaxPartTiles)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<true, true, float>(x, wt, colsum, bias, inv_scale, mask, semantics, out, out, b, k,
                                   n, out_dim, device, stream);
}

extern "C" long long fdn_resident_softmax_block_sparse_smem_bytes(int k) {
  return static_cast<long long>(smem_bytes<true>(k));
}

// Clusters of kSplit blocks of K4 at input width k that the card seats at
// once (-1 if it cannot tell).
extern "C" int fdn_resident_softmax_wgmma_max_clusters(int k, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  return hp::max_active_clusters(resident_softmax_wgmma_kernel<false, false, float>, kSplit,
                                 smem_bytes<false>(k));
}
