// K8: output-layer logits plus flash-softmax stats, s8[B, K] x s8[K, N] ->
// z [B, N] and the per-row (max, sum-exp) m, s [B], optionally masked
// (u8 [B, N], nonzero = active) and optionally skipping all-inactive
// (64-frame x 128-senone) tiles; and its normalize, exp(z - m) / s, as one
// kernel of its own.  The weight arrives transposed, Wt s8[N, K]
// (ops/kernels.py:kernel_layout).
//
// Replaces, in one family, fastdnn_tpu/ops/pallas_kernels.py:
//   B5 output_layer_posteriors -> _flash_stats_call -> _stats_kernel_factory
//      (:437-668): the stats kernel the JAX scorer falls back to when the
//      output layer is too large for the resident kernel; FAST stores z in
//      bf16 relative to its tile max, with the f32 tile maxes beside it; and
//      the normalize XLA fused after it (:572-585), here normalize_stats;
//   B6 output_layer_flash_stats (:671-707): the same with a dynamic
//      `valid_count`, the per-shard half of the tensor-parallel softmax;
//   B7 output_layer_posteriors_block_sparse / output_flash_stats_block_sparse
//      -> _block_sparse_kernel_factory (:710-971): SKIP, with CAPPED_FILL.
//
// Design: K4's kernel (csrc/resident_softmax.cu) without its second sweep,
// with the activations streamed beside the weight (csrc/hopper.cuh), so K
// has no limit.  The dense variants (unmasked, masked, FAST) run the wide
// tile: a block owns 128 frames and takes 256-column tiles; a producer warp
// keeps a TMA mbarrier ring of 4 stages full, each a 256 x 128-byte weight
// slice and the block's 128 x 128-byte activation tile (48 KB), across
// tiles, so the loads run on during an epilogue; both consumer warpgroups
// read every stage, each running m64n256k32 on its own 64 frames.  A
// cluster of 2 blocks shares the 128 frames and splits the column tiles
// (row_stats.cuh: ColumnPart).  The epilogue takes a tile's 128 accumulators
// a thread in two 128-column halves, within the consumers' 232 registers:
// it dequantizes ((acc + colsum) * inv_scale + bias, rounded after the
// multiply and after the add; the tile's colsum and bias copied into shared
// memory while its products run), masks (reference: an inactive logit is 0
// and joins the max; active_only: -1e30), caps every column at or beyond
// `valid_count` (a runtime argument) at -1e30, stores z for every padded
// column (FAST: bf16 z - tile max, and the f32 tile max per row and
// 128-column tile) through TMA stores from a small shared buffer, and folds
// the half into each row's (max, sum-exp), held in registers.  Each row
// belongs to one warpgroup; the two blocks merge their rows' stats through
// distributed shared memory, in rank order, and block 0 writes m and s.
// Shapes: B % 64 == 0 (a last block's second 64 frames past B are TMA's
// zero rows, neither stored nor folded) and N % 128 == 0 (a last tile's
// second half past N is TMA's zero rows, skipped).  The TPU kernel's
// [B, 128] VMEM stats scratch becomes registers.
//
// SKIP keeps the 64 x 128 tile of K2's ring, its consumer warpgroups taking
// the tiles in turn (one's epilogue beside the other's wgmma), in pairs of
// blocks on 64 frames: its skipping is defined on 64 x 128 mask tiles, and
// a larger tile would skip less.  It takes K6's approach: the producer
// warpgroup reads the block's mask tiles before it streams and keeps the
// list of the active ones; the ring streams those alone.  A skipped tile
// loads nothing and runs no wgmma: the producer warpgroup's other three
// warps store its fill (0 or -1e30; -1e30 beyond valid_count under
// CAPPED_FILL) with 16-byte stores, and under reference its valid columns
// fold into the block's stats once, in closed form, as logit 0 (the pair
// (0, count)); under active_only they add nothing.  m is the same max of the
// same values as the plain version's, so it is bitwise equal; s is a sum in
// another order.
//
// Bound: at B = 8192, K = 2048, N = 8064 the products are 271 G int8 ops
// (0.137 ms at 1979 TOP/s), more than the bytes: frames 16.8 MB, weight
// 16.5 MB and z 264 MB (0.089 ms at 3.35 TB/s); at the YouTube net's K =
// 2560, N = 17,664, 741 G ops (0.374 ms) against 0.19 ms of bytes.  Each
// block reads its half of the weight and its frames' activations from L2
// once per tile.  On the 64 x 128 tile every 128-byte K step landed 24 KB in
// shared memory for 2.1 M products (87 a byte), and the products alone ran
// at 51% of the int8 peak; the wide tile lands 48 KB for 8.4 M (175 a byte),
// issues one wgmma for every two, and its products alone run at 85%
// (PERF.md, PR 23).  Its cost is the epilogue, which no longer runs beside
// the other warpgroup's products: it runs beside the next tile's loads, its
// z stores leave through TMA and its column constants wait in shared memory,
// so K8 reaches about 54% of its bound there (38% on the 64 x 128 tile).
// Clusters of 4 (two blocks along frames sharing each weight slice by
// multicast) seat only 30 at a time on the H100, not the 32 that B = 8192
// needs.  The normalize is bytes alone: z read and posteriors written once,
// 524 MB at out_dim 8000 (0.157 ms).  expf, not __expf.
#include <cuda_bf16.h>
#include <float.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "row_stats.cuh"

namespace {

namespace hp = fdn::hopper;
namespace rs = fdn::rowstats;
using fdn::kEmptyRowMax;
using fdn::kNegCap;
using fdn::kReference;

// SKIP: K2's ring, 8 stages of a 16 KB weight slice and an 8 KB activation
// tile
constexpr int kStages = 8;
// the dense variants: the wide tile's ring, 4 stages of a 32 KB weight slice
// and a 16 KB activation tile
constexpr int kWideStages = 4;
// each consumer warpgroup's buffer of z on its way out: 64 rows x 128
// bytes, 32 f32 or 64 bf16 columns, a TMA store box of 16 rows per warp
constexpr int kStoreRows = 16;
constexpr int kStoreBytes = hp::kFrames * 128;
// each consumer warpgroup's copies of a tile's zero-point sums and biases,
// one for the tile in its epilogue and one for the tile in its products
constexpr int kColumnBytes = hp::kWideTileN * (sizeof(int) + sizeof(float));
constexpr int kColumnBuffers = 2;
// the warpgroups' named barriers, kColumnBarrier + warpgroup
constexpr int kColumnBarrier = 4;
using WideRing = hp::WideRing<kWideStages>;
// SKIP's list of a block's active tiles: up to 8192 column tiles per block
// of a pair (N <= 2,097,152), uint16 each, 17.3 KB of shared memory
constexpr int kSkipMaxPartTiles = 8192;
using SkipTiles = rs::SparseTiles<kSkipMaxPartTiles, uint16_t>;
// the threads of a normalize block
constexpr int kNormThreads = 256;

template <bool FAST>
using ZType = typename std::conditional<FAST, __nv_bfloat16, float>::type;

template <bool SKIP>
__host__ __device__ constexpr size_t smem_bytes() {
  if constexpr (SKIP)
    return hp::kAlign + static_cast<size_t>(kStages) * (hp::kStageBytes + hp::kActBlockBytes) +
           hp::Ring<kStages, 1>::kBytes + sizeof(float2) * hp::kConsumers * hp::kFrames +
           sizeof(SkipTiles);
  else
    return hp::kAlign + static_cast<size_t>(kWideStages) * hp::kWideStageBytes +
           static_cast<size_t>(hp::kConsumers) * (kStoreBytes + kColumnBuffers * kColumnBytes) +
           WideRing::kBytes + sizeof(float2) * hp::kWideFrames;
}

// SKIP: one consumer warpgroup's tile t (columns [128 t, 128 t + 128)) of
// its 64 rows: the masked, capped logits stored to z and folded into the
// thread's rows' running (max, sum-exp).
__device__ __forceinline__ void skip_epilogue(const int (&d)[64], float* z, int m0, int t,
                                              const int* colsum, const float* bias, float inv,
                                              const uint8_t* mask, int N, float fill,
                                              int valid_count, int thread_in_wg, float (&m)[2],
                                              float (&s)[2]) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int col = t * hp::kTileN + 2 * (lane % 4);
  const int r0 = m0 + warp * 16 + lane / 4;
  float* rows[2] = {z + static_cast<size_t>(r0) * N, z + static_cast<size_t>(r0 + 8) * N};
  float v[64], tile_max[2];
  const float invs[2] = {inv, inv};
  rs::tile_logits<true>(d, v, tile_max, r0, col, colsum, bias, invs, mask, N, fill, valid_count,
                        [&](int h, int n, float v0, float v1) {
                          *reinterpret_cast<float2*>(rows[h] + n) = make_float2(v0, v1);
                        });
  rs::quad_max(tile_max);
  rs::fold_stats(v, tile_max, m, s);
}

// A tile's zero-point sums and biases (columns [c0, c0 + 256) up to N) ->
// `cols` in shared memory (256 int32 sums, then 256 f32 biases) by the
// warpgroup's 128 threads, 16 bytes each, as an asynchronous copy: it lands
// while the tile's products run (cp_async_wait before the epilogue reads it)
__device__ __forceinline__ void copy_columns(unsigned char* cols, const int* colsum,
                                             const float* bias, int c0, int N,
                                             int thread_in_wg) {
  constexpr int kChunks = hp::kWideTileN * sizeof(int) / 16;  // 16-byte chunks per array
  const int chunk = thread_in_wg % kChunks;
  const bool sums = thread_in_wg < kChunks;
  if (c0 + 4 * chunk >= N) return;
  const void* src = sums ? static_cast<const void*>(colsum + c0 + 4 * chunk)
                         : static_cast<const void*>(bias + c0 + 4 * chunk);
  unsigned char* dst = cols + (sums ? 0 : hp::kWideTileN * sizeof(int)) + 16 * chunk;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(fdn::smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rowstats::tile_logits with the zero-point sums and biases read from
// `cols` (copy_columns), at tile_col, the thread's column `col` counted from
// the tile's first: the same operations in the same order
template <bool MASKED>
__device__ __forceinline__ void wide_logits(const int (&d)[64], float (&z)[64],
                                            float (&tile_max)[2], int r0, int col, int tile_col,
                                            const unsigned char* cols, float inv,
                                            const uint8_t* mask, int N, float fill, int cap) {
  const int* cs_s = reinterpret_cast<const int*>(cols);
  const float* b_s = reinterpret_cast<const float*>(cols + hp::kWideTileN * sizeof(int));
  uchar2 active[16][2];
  if constexpr (MASKED) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        active[q][h] = *reinterpret_cast<const uchar2*>(mask + static_cast<size_t>(r0 + 8 * h) * N +
                                                        col + 8 * q);
  }
  tile_max[0] = tile_max[1] = kNegCap;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int n = col + 8 * q;
    const int2 cs = *reinterpret_cast<const int2*>(cs_s + tile_col + 8 * q);
    const float2 b = *reinterpret_cast<const float2*>(b_s + tile_col + 8 * q);
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
      if (n >= cap) v0 = kNegCap;
      if (n + 1 >= cap) v1 = kNegCap;
      tile_max[h] = fmaxf(tile_max[h], fmaxf(v0, v1));
    }
  }
}

__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128) : "memory");
}

// The wide tile's epilogue of one consumer warpgroup's 128-column half h of
// its tile (columns [128 t, 128 t + 128), t = 2 tile + h) for its 64 rows:
// the masked, capped logits, from the tile's column constants in `cols`,
// stored to z (FAST: bf16 z - tile max, the tile maxes to tile_max_out
// [B, N / 128]) through TMA stores and folded into the rows' running (max,
// sum-exp).  A box of 32 f32 (FAST: 64 bf16) columns at a time: each warp
// writes its 16 rows of it into its part of the warpgroup's 128-byte-swizzled
// buffer `buf` and one of its threads stores them, while all fold the box's
// columns; the part is written again once the store has read it.  The fold
// is rowstats::fold_stats's, term for term in the same order.
template <bool MASKED, bool FAST>
__device__ __forceinline__ void staged_epilogue(const int (&d)[64], unsigned char* buf,
                                                const CUtensorMap* z_map, float* tile_max_out,
                                                int m0, int t, const unsigned char* cols,
                                                float inv, const uint8_t* mask, int N, float fill,
                                                int valid_count, int thread_in_wg, float (&m)[2],
                                                float (&s)[2]) {
  constexpr int kBoxCols = FAST ? 64 : 32;
  constexpr int kBoxQ = kBoxCols / 8;  // the thread's column pairs per row in a box
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int tile_col = (t % 2) * hp::kTileN + 2 * (lane % 4);
  const int col = t * hp::kTileN + 2 * (lane % 4);
  const int r0 = m0 + warp * kStoreRows + lane / 4;
  unsigned char* part = buf + warp * kStoreRows * 128;  // the warp's rows of the box
  float v[64], tile_max[2];
  wide_logits<MASKED>(d, v, tile_max, r0, col, tile_col, cols, inv, mask, N, fill, valid_count);
  rs::quad_max(tile_max);
  if constexpr (FAST) {
    if (lane % 4 == 0) {
      const size_t tiles = N / hp::kTileN;
      tile_max_out[r0 * tiles + t] = tile_max[0];
      tile_max_out[(r0 + 8) * tiles + t] = tile_max[1];
    }
  }
  const float m_new[2] = {fmaxf(m[0], tile_max[0]), fmaxf(m[1], tile_max[1])};
  float e[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < hp::kTileN / kBoxCols; ++c) {
    if (lane == 0) hp::bulk_wait_read<0>();
    __syncwarp();  // the part's last box has left
#pragma unroll
    for (int j = 0; j < kBoxQ; ++j) {
      const int q = c * kBoxQ + j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = lane / 4 + 8 * h;  // row % 8 == lane / 4
        const float v0 = v[4 * q + 2 * h], v1 = v[4 * q + 2 * h + 1];
        if constexpr (FAST) {
          const int byte = 16 * j + 4 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(part + row * 128 + (((byte >> 4) ^ (lane / 4)) << 4) +
                                             (byte & 15)) =
              __floats2bfloat162_rn(v0 - tile_max[h], v1 - tile_max[h]);
        } else {
          const int byte = 32 * j + 8 * (lane % 4);
          *reinterpret_cast<float2*>(part + row * 128 + (((byte >> 4) ^ (lane / 4)) << 4) +
                                     (byte & 15)) = make_float2(v0, v1);
        }
      }
    }
    hp::fence_proxy_async();
    __syncwarp();  // the box is written
    if (lane == 0) {
      hp::tma_store(z_map, part, t * hp::kTileN + c * kBoxCols, m0 + warp * kStoreRows);
      hp::bulk_commit();
    }
#pragma unroll
    for (int i = 4 * c * kBoxQ; i < 4 * (c + 1) * kBoxQ; ++i)
      e[(i >> 1) & 1] += expf(v[i] - m_new[(i >> 1) & 1]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    e[h] += __shfl_xor_sync(0xffffffffu, e[h], 1);
    e[h] += __shfl_xor_sync(0xffffffffu, e[h], 2);
    s[h] = s[h] * expf(m[h] - m_new[h]) + e[h];
    m[h] = m_new[h];
  }
}

// SKIP, the producer warpgroup's warps 1-3 (thread i of `count`): the fill
// logits of the block's skipped tiles, 16-byte stores; columns at or beyond
// `cap` hold -1e30.
__device__ __forceinline__ void store_skipped(float* z, const SkipTiles* sp,
                                              const rs::ColumnPart& part, int m0, int N,
                                              float fill, int cap, int i, int count) {
  constexpr int kChunks = hp::kTileN / 4;  // float4s per row of a tile
  for (int g = 0; g < part.tiles; ++g) {
    if (rs::part_tile_active(sp, g)) continue;
    const int c0 = (part.g0 + g) * hp::kTileN;
    for (int j = i; j < hp::kFrames * kChunks; j += count) {
      const int c = c0 + 4 * (j % kChunks);
      const float4 v = make_float4(c < cap ? fill : kNegCap, c + 1 < cap ? fill : kNegCap,
                                   c + 2 < cap ? fill : kNegCap, c + 3 < cap ? fill : kNegCap);
      *reinterpret_cast<float4*>(z + static_cast<size_t>(m0 + j / kChunks) * N + c) = v;
    }
  }
}

// SKIP's body, on the 64 x 128 tile: the producer warpgroup lists the
// block's active tiles, streams those alone through K2's ring and stores the
// skipped tiles' fill; the consumer warpgroups take the listed tiles in turn.
// A pair of blocks shares 64 frames and splits the column tiles.
__device__ __forceinline__ void skipping_stats(unsigned char* smem, const CUtensorMap* w_map,
                                               const CUtensorMap* x_map, const int* colsum,
                                               const float* bias, float inv_scale,
                                               const uint8_t* mask, int semantics,
                                               int valid_count, int capped_fill, float* z,
                                               float* m_out, float* s_out, int K, int N) {
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  int8_t* acts = stages + kStages * hp::kStageBytes;  // one activation tile per stage
  hp::Ring<kStages, 1> ring{reinterpret_cast<uint64_t*>(acts + kStages * hp::kActBlockBytes)};
  // (m, s) per row: [warpgroup][row]; the block's merge goes to [0][row]
  float2* stats = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(ring.bars) +
                                            hp::Ring<kStages, 1>::kBytes);
  SkipTiles* sp = reinterpret_cast<SkipTiles*>(stats + hp::kConsumers * hp::kFrames);

  const int wg = threadIdx.x / 128;
  const unsigned rank = hp::cluster_rank();
  const int m0 = blockIdx.x / rs::kSplit * hp::kFrames;
  const rs::ColumnPart part(N / hp::kTileN, rank);
  const int steps = K / hp::kStageK;
  const float fill = semantics == kReference ? 0.0f : kNegCap;  // an inactive senone's logit
  if (threadIdx.x == 0) ring.init();
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    const int pt = threadIdx.x % 128;
    rs::find_active_tiles(sp, mask, N, m0, part, valid_count, pt);
    __syncwarp();
    rs::named_arrive<rs::kListBarrier, hp::kThreads>();
    hp::reg_dealloc<hp::kProducerRegs>();
    if (pt == 0) {
      // stage e * steps + t: the t-th 128 bytes of K of the e-th tile listed
      for (int e = 0; e < sp->count; ++e) {
        const int g = sp->list[e];
        for (int t = 0; t < steps; ++t)
          ring.produce(stages, w_map, e * steps + t, t * hp::kStageK, (part.g0 + g) * hp::kTileN,
                       0, acts, x_map, m0);
      }
    } else if (pt >= 32) {
      store_skipped(z, sp, part, m0, N, fill, capped_fill ? valid_count : N, pt - 32, 96);
    }
    hp::cluster_sync();  // the consumers' exchange
    hp::cluster_sync();
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    rs::named_sync<rs::kListBarrier, hp::kThreads>();
    const int tid = threadIdx.x;
    const int tw = tid % 128;
    const int count = sp->count;
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    float m[2] = {-INFINITY, -INFINITY};
    float s[2] = {0.0f, 0.0f};
    for (int e = wg, n = 0; e < count; e += hp::kConsumers, ++n) {
      const int g = sp->list[e];
      hp::tile_products<kStages, 1, true>(d, ring, stages, acts, K, e * steps, wg, n, tw);
      skip_epilogue(d, z, m0, part.g0 + g, colsum, bias, inv_scale, mask, N, fill, valid_count,
                    tw, m, s);
    }
    if (tw % 4 == 0) {
      const int r = (tw / 32) * 16 + (tw % 32) / 4;
      stats[wg * hp::kFrames + r] = make_float2(m[0], s[0]);
      stats[wg * hp::kFrames + r + 8] = make_float2(m[1], s[1]);
    }
    hp::consumer_sync();
    if (tid < hp::kFrames) {
      float2 block = rs::merge_stats(stats[tid], stats[hp::kFrames + tid]);
      // under reference: the skipped tiles' valid columns, logit 0 each
      if (semantics == kReference && sp->skipped_cols > 0)
        block = rs::merge_stats(block, make_float2(0.0f, static_cast<float>(sp->skipped_cols)));
      stats[tid] = block;
    }
    hp::cluster_sync();  // every block's [0][row] is merged
    if (rank == 0 && tid < hp::kFrames) {  // in rank order
      float2 all = make_float2(-INFINITY, 0.0f);
#pragma unroll
      for (int p = 0; p < rs::kSplit; ++p) all = rs::merge_stats(all, rs::load_cluster(stats + tid, p));
      // a row that folded nothing (every tile skipped, none of its columns
      // counted) keeps the cap, as the plain version's clamp does
      m_out[m0 + tid] = fmaxf(all.x, kNegCap);
      s_out[m0 + tid] = all.y;
    }
    hp::cluster_sync();  // no block leaves while another reads its stats
  }
}

// The dense variants' body, on the wide tile (hopper.cuh): a block owns 128
// frames (f0 ..), each warpgroup 64 of them, and takes its part of the
// 256-column tiles: the kSplit blocks of a cluster share the frames and
// split the tiles.  Each tile's accumulators go through the epilogue in
// two 128-column halves; a half at or past N (N % 256 == 128) is skipped,
// and so are a warpgroup's rows at or past B (B % 128 == 64: TMA's zeros).
template <bool MASKED, bool FAST>
__device__ __forceinline__ void wide_stats(unsigned char* smem, const CUtensorMap* w_map,
                                           const CUtensorMap* x_map, const CUtensorMap* z_map,
                                           const int* colsum,
                                           const float* bias, float inv_scale,
                                           const uint8_t* mask, int semantics, int valid_count,
                                           float* m_out, float* s_out, float* tile_max_out,
                                           int B, int K, int N) {
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  // per consumer warpgroup: its z buffer, then its two copies of column constants
  unsigned char* wg_bufs = smem + kWideStages * hp::kWideStageBytes;
  constexpr int kWgBytes = kStoreBytes + kColumnBuffers * kColumnBytes;
  WideRing ring{reinterpret_cast<uint64_t*>(wg_bufs + hp::kConsumers * kWgBytes)};
  // (m, s) of each of the block's rows
  float2* stats =
      reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(ring.bars) + WideRing::kBytes);

  const int wg = threadIdx.x / 128;
  const unsigned rank = hp::cluster_rank();
  const int f0 = blockIdx.x / rs::kSplit * hp::kWideFrames;
  const rs::ColumnPart part((N + hp::kWideTileN - 1) / hp::kWideTileN, rank);
  const int steps = K / hp::kStageK;
  const float fill = semantics == kReference ? 0.0f : kNegCap;  // an inactive senone's logit
  if (threadIdx.x == 0) ring.init();
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      for (int e = 0; e < part.tiles; ++e)
        for (int t = 0; t < steps; ++t)
          ring.produce(stages, w_map, x_map, e * steps + t, t * hp::kStageK,
                       (part.g0 + e) * hp::kWideTileN, f0);
    }
    hp::cluster_sync();  // the consumers' exchange
    hp::cluster_sync();
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    const int m0 = f0 + wg * hp::kFrames;
    const bool in_rows = m0 < B;
    unsigned char* buf = wg_bufs + wg * kWgBytes;
    unsigned char* cols = buf + kStoreBytes;
    float m[2] = {-INFINITY, -INFINITY};
    float s[2] = {0.0f, 0.0f};
    for (int e = 0; e < part.tiles; ++e) {
      const int c0 = (part.g0 + e) * hp::kWideTileN;
      unsigned char* tile_cols = cols + (e % kColumnBuffers) * kColumnBytes;
      if (in_rows) {
        copy_columns(tile_cols, colsum, bias, c0, N, tw);
        cp_async_commit();
      }
      // zeroed here, so no accumulator lives across the epilogue
      int d[2][64];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 64; ++i) d[h][i] = 0;
      hp::wide_tile_products(d, ring, stages, K, e * steps, wg, tw);
      if (in_rows) {
        cp_async_wait();
        warpgroup_sync(kColumnBarrier + wg);  // the tile's column constants have landed
        const int t = 2 * (part.g0 + e);  // the tile's first 128 columns
        staged_epilogue<MASKED, FAST>(d[0], buf, z_map, tile_max_out, m0, t, tile_cols,
                                      inv_scale, mask, N, fill, valid_count, tw, m, s);
        if ((t + 1) * hp::kTileN < N)
          staged_epilogue<MASKED, FAST>(d[1], buf, z_map, tile_max_out, m0, t + 1, tile_cols,
                                        inv_scale, mask, N, fill, valid_count, tw, m, s);
      }
    }
    if (tw % 32 == 0) hp::bulk_wait_all();  // z has left the buffers
    if (in_rows && tw % 4 == 0) {
      const int r = wg * hp::kFrames + (tw / 32) * 16 + (tw % 32) / 4;
      stats[r] = make_float2(m[0], s[0]);
      stats[r + 8] = make_float2(m[1], s[1]);
    }
    hp::cluster_sync();  // every block's rows are in place
    const int tid = threadIdx.x;
    if (rank == 0 && tid < hp::kWideFrames && f0 + tid < B) {  // in rank order
      float2 all = make_float2(-INFINITY, 0.0f);
#pragma unroll
      for (int p = 0; p < rs::kSplit; ++p) all = rs::merge_stats(all, rs::load_cluster(stats + tid, p));
      m_out[f0 + tid] = fmaxf(all.x, kNegCap);
      s_out[f0 + tid] = all.y;
    }
    hp::cluster_sync();  // no block leaves while another reads its stats
  }
}

// MASKED: the mask is read (always under SKIP); `semantics` 0 reference,
// 1 active_only.  FAST: z is bf16 (z - tile max) and the f32 tile maxes go
// to tile_max [B, N / 128].  SKIP: all-inactive tiles are skipped, and
// capped_fill != 0 stores -1e30 beyond valid_count in them.  SKIP runs the
// 64 x 128 tile, the others the wide tile.
template <bool MASKED, bool FAST, bool SKIP>
__global__ void __launch_bounds__(hp::kThreads, 1)
    flash_stats_kernel(const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap z_map, const int* __restrict__ colsum,
                       const float* __restrict__ bias, float inv_scale,
                       const uint8_t* __restrict__ mask, int semantics, int valid_count,
                       int capped_fill, ZType<FAST>* __restrict__ z, float* __restrict__ m_out,
                       float* __restrict__ s_out, float* __restrict__ tile_max_out, int B, int K,
                       int N) {
  static_assert(MASKED || !SKIP, "tile skipping reads the mask");
  static_assert(!(SKIP && FAST), "the skipping variant stores f32 z");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hp::align_smem(smem_raw);
  if constexpr (SKIP)
    skipping_stats(smem, &w_map, &x_map, colsum, bias, inv_scale, mask, semantics, valid_count,
                   capped_fill, z, m_out, s_out, K, N);
  else
    wide_stats<MASKED, FAST>(smem, &w_map, &x_map, &z_map, colsum, bias, inv_scale, mask,
                             semantics, valid_count, m_out, s_out, tile_max_out, B, K, N);
}

template <bool MASKED, bool FAST, bool SKIP>
cudaError_t launch(const void* x, const void* wt, const void* colsum, const void* bias,
                   float inv_scale, const void* mask, int semantics, int valid_count,
                   int capped_fill, void* z, void* m, void* s, void* tile_max, int b, int k, int n,
                   void* stream) {
  // a pair of blocks' frames and a tile's columns
  constexpr int frames = SKIP ? hp::kFrames : hp::kWideFrames;
  constexpr int tile_n = SKIP ? hp::kTileN : hp::kWideTileN;
  CUtensorMap w_map, x_map, z_map;
  cudaError_t err = hp::weight_map(&w_map, wt, n, k, tile_n);
  if (err == cudaSuccess) err = hp::weight_map(&x_map, x, b, k, frames);
  // the dense variants' z, boxes of 128 bytes x 16 rows (SKIP stores its own)
  if (err == cudaSuccess && !SKIP)
    err = FAST ? hp::tensor_map(&z_map, z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, n, kStoreRows)
               : hp::tensor_map(&z_map, z, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, n, kStoreRows);
  if (err != cudaSuccess) return err;
  if (SKIP) z_map = x_map;
  return hp::launch_clustered(
      flash_stats_kernel<MASKED, FAST, SKIP>, rs::kSplit * ((b + frames - 1) / frames), rs::kSplit,
      smem_bytes<SKIP>(), stream, w_map, x_map, z_map, static_cast<const int*>(colsum),
      static_cast<const float*>(bias), inv_scale, static_cast<const uint8_t*>(mask), semantics,
      valid_count, capped_fill, static_cast<ZType<FAST>*>(z), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(tile_max), b, k, n);
}

// ---------------------------------------------------------------------------
// The normalize: out[r, c] = exp(z[r, c] - m[r]) / max(s[r], tiny) for
// c < out_dim, 0 for a row with m[r] <= -1e29 (no active senone); FAST
// rebuilds z as bf16 z_rel + the f32 max of its 128-column tile and writes
// bf16.  One pass, V elements per thread: 16-byte loads and stores (V = 4
// f32, 8 bf16) when out_dim keeps the output rows 16-byte aligned, else
// V = 1.  Block (x, y) takes columns [256 V x, 256 V (x + 1)) of rows y,
// y + gridDim.y, ...
// ---------------------------------------------------------------------------
template <int V>
__device__ __forceinline__ void load_z(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = p[i];
  }
}
template <int V>
__device__ __forceinline__ void load_z(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const int4 q = *reinterpret_cast<const int4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}
template <int V>
__device__ __forceinline__ void store_p(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}
template <int V>
__device__ __forceinline__ void store_p(__nv_bfloat16* p, const float (&v)[V]) {
  if constexpr (V == 8) {
    int4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<int4*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = __float2bfloat16_rn(v[i]);
  }
}

template <bool FAST, int V>
__global__ void __launch_bounds__(kNormThreads)
    normalize_stats_kernel(const ZType<FAST>* __restrict__ z, const float* __restrict__ m,
                           const float* __restrict__ s, const float* __restrict__ tile_max,
                           ZType<FAST>* __restrict__ out, int b, int n, int out_dim) {
  const int c = (blockIdx.x * kNormThreads + threadIdx.x) * V;
  if (c >= out_dim) return;
  const int tiles = n / hp::kTileN;
  for (int row = blockIdx.y; row < b; row += gridDim.y) {
    const float mr = m[row];
    const float sr = fmaxf(s[row], FLT_MIN);
    float v[V];
    load_z<V>(z + static_cast<size_t>(row) * n + c, v);
    if constexpr (FAST) {
      // V divides 128: the V columns lie in one tile
      const float shift = tile_max[static_cast<size_t>(row) * tiles + c / hp::kTileN];
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] += shift;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = mr <= kEmptyRowMax ? 0.0f : expf(v[i] - mr) / sr;
    store_p<V>(out + static_cast<size_t>(row) * out_dim + c, v);
  }
}

template <bool FAST, int V>
cudaError_t launch_normalize(const void* z, const void* m, const void* s, const void* tile_max,
                             void* out, int b, int n, int out_dim, void* stream) {
  const int per_row = (out_dim + V - 1) / V;
  const dim3 grid((per_row + kNormThreads - 1) / kNormThreads, b < 65535 ? b : 65535);
  normalize_stats_kernel<FAST, V><<<grid, kNormThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ZType<FAST>*>(z), static_cast<const float*>(m),
      static_cast<const float*>(s), static_cast<const float*>(tile_max),
      static_cast<ZType<FAST>*>(out), b, n, out_dim);
  return cudaGetLastError();
}

}  // namespace

// K8.  mask: nullptr (unmasked) or u8 [B, N]; semantics 0 reference,
// 1 active_only; 0 <= valid_count <= N.  fast == 0: z is f32 [B, N] and
// tile_max is ignored; fast != 0: z is bf16 [B, N] (z - tile max) and
// tile_max f32 [B, N / 128].  m, s: f32 [B].  skip != 0 (mask required, fast
// == 0, N <= 2,097,152): all-inactive (64 x 128) tiles are skipped, and
// capped_fill != 0 stores -1e30 beyond valid_count in them.  Requires
// B % 64 == 0, K % 128 == 0, N % 128 == 0, 16-byte aligned x, wt and mask,
// and fdn_flash_stats_smem_bytes(skip) within the block limit (checked by
// the wrapper).  Returns a cudaError_t; 1 (cudaErrorInvalidValue) for a
// combination the kernel has no instantiation of.
extern "C" int fdn_flash_stats(const void* x, const void* wt, const void* colsum,
                               const void* bias, float inv_scale, const void* mask, int semantics,
                               int valid_count, int skip, int capped_fill, int fast, void* z,
                               void* m, void* s, void* tile_max, int b, int k, int n, int device,
                               void* stream) {
#define FDN_FLASH_ARGS                                                                        \
  x, wt, colsum, bias, inv_scale, mask, semantics, valid_count, capped_fill, z, m, s, tile_max, \
      b, k, n, stream
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (skip) {
    if (!mask || fast || n > rs::kSplit * hp::kTileN * kSkipMaxPartTiles)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch<true, false, true>(FDN_FLASH_ARGS));
  }
  if (mask)
    return static_cast<int>(fast ? launch<true, true, false>(FDN_FLASH_ARGS)
                                 : launch<true, false, false>(FDN_FLASH_ARGS));
  return static_cast<int>(fast ? launch<false, true, false>(FDN_FLASH_ARGS)
                               : launch<false, false, false>(FDN_FLASH_ARGS));
#undef FDN_FLASH_ARGS
}

extern "C" long long fdn_flash_stats_smem_bytes(int skip) {
  return static_cast<long long>(skip ? smem_bytes<true>() : smem_bytes<false>());
}

// K8's normalize.  z f32 [B, N] (tile_max nullptr, out f32 [B, out_dim]) or
// bf16 z_rel [B, N] with tile_max f32 [B, N / 128] (out bf16); m, s f32 [B];
// 0 < out_dim <= N, N % 128 == 0.
extern "C" int fdn_normalize_stats(const void* z, const void* m, const void* s,
                                   const void* tile_max, void* out, int b, int n, int out_dim,
                                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_max)
    err = out_dim % 8 == 0 ? launch_normalize<true, 8>(z, m, s, tile_max, out, b, n, out_dim, stream)
                           : launch_normalize<true, 1>(z, m, s, tile_max, out, b, n, out_dim, stream);
  else
    err = out_dim % 4 == 0 ? launch_normalize<false, 4>(z, m, s, tile_max, out, b, n, out_dim, stream)
                           : launch_normalize<false, 1>(z, m, s, tile_max, out, b, n, out_dim, stream);
  return static_cast<int>(err);
}
