// The row-softmax pieces K4, K6 (csrc/resident_softmax.cu) and K8
// (csrc/flash_stats.cu) share on csrc/hopper.cuh's loop: the masked,
// capped logits of a consumer warpgroup's 64 x 128 tile and their fold into
// each row's running (max, sum-exp) held in registers; the merge of two such
// pairs and its cluster-wide form through distributed shared memory; the
// split of the column tiles over the kSplit blocks of a cluster that share
// 64 frames; and the list of a block's active tiles that the skipping
// variants (K6, K8 SKIP) stream alone.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace fdn {

// a logit excluded from the softmax (padding, beyond valid, inactive under
// active_only): -1e30, not -inf, so exp(z - m) never sees inf - inf
constexpr float kNegCap = -1e30f;
// a row max at or below this means no senone of the row was active
constexpr float kEmptyRowMax = -1e29f;
// masked semantics (ops/kernels.py:_SEMANTICS): 0 reference, 1 active_only
constexpr int kReference = 0;

namespace rowstats {

namespace hp = fdn::hopper;

// blocks of a cluster, sharing 64 frames and splitting the column tiles:
// 2 beat clusters of 2 blocks on 128 frames sharing stages by multicast, 4
// lost at B = 8192 (PERF.md)
constexpr int kSplit = 2;
// K6's most column tiles for one block of a cluster (N <= kSplit * 128 *
// kMaxPartTiles; K8's skipping variant lists more, csrc/flash_stats.cu),
// and the mask loads in flight per producer thread while it finds them
constexpr int kMaxPartTiles = 256;
constexpr int kScanInFlight = 16;
// named barriers beside hp::kConsumerBarrier: the producer warpgroup's own,
// and the one on which it hands the list of active tiles to the consumers
constexpr int kProducerBarrier = 2;
constexpr int kListBarrier = 3;
static_assert(hp::kConsumers == 2, "the row stats of two consumer warpgroups merge");
static_assert(32 * kScanInFlight * 16 == hp::kFrames * hp::kTileN, "one warp reads a tile at once");

// The skipping variants' tile bookkeeping, in shared memory, for at most
// MAX_TILES column tiles per block, listed as Entry (which holds MAX_TILES - 1)
template <int MAX_TILES, class Entry>
struct SparseTiles {
  static_assert(MAX_TILES % 32 == 0 && MAX_TILES - 1 <= static_cast<Entry>(~Entry{0}),
                "an Entry holds every tile index");
  static constexpr int kMaxTiles = MAX_TILES;
  using entry_type = Entry;
  uint32_t active[MAX_TILES / 32];  // bit g: the block's tile g has an active senone
  Entry list[MAX_TILES];            // the active tiles, in order
  int count;                        // entries of `list`
  int skipped_cols;                 // valid columns of the skipped tiles
  float fill_p[hp::kFrames];        // K6: each row's posterior of a skipped column
};

// The logits of one consumer warpgroup's tile, columns [col0, col0 + 128)
// of its 64 rows, into z (the thread's 64 accumulators' places: rows r0 and
// r0 + 8, columns col + 8 q + {0, 1}, col = col0 + 2 (lane % 4)):
// dequantized, then MASKED (u8 [B, N], nonzero = active) an inactive
// senone's logit is `fill` (0 under reference, -1e30 under active_only),
// then every column at or beyond `cap` is -1e30; row r0 + 8 h dequantizes
// with inv[h] (the layer's scale, or K4's per-row scale of a low-rank
// output layer).  tile_max[h] gets the thread's max of row r0 + 8 h; store(h, n, v0, v1) sees each pair of
// columns (n, n + 1) of row r0 + 8 h as it is made.  The mask's byte pairs
// are loaded first, all in flight at once; the other warpgroup's products
// run meanwhile.
template <bool MASKED, class Store>
__device__ __forceinline__ void tile_logits(const int (&d)[64], float (&z)[64], float (&tile_max)[2],
                                            int r0, int col, const int* colsum, const float* bias,
                                            const float (&inv)[2], const uint8_t* mask, int N, float fill,
                                            int cap, Store store) {
  uchar2 active[16][2];
  if constexpr (MASKED) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        active[q][h] =
            *reinterpret_cast<const uchar2*>(mask + static_cast<size_t>(r0 + 8 * h) * N + col + 8 * q);
  }
  tile_max[0] = tile_max[1] = kNegCap;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int n = col + 8 * q;  // even, and n + 1 < N
    const int2 cs = *reinterpret_cast<const int2*>(colsum + n);
    const float2 b = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float& v0 = z[4 * q + 2 * h];
      float& v1 = z[4 * q + 2 * h + 1];
      v0 = dequantize(d[4 * q + 2 * h], cs.x, inv[h], b.x);
      v1 = dequantize(d[4 * q + 2 * h + 1], cs.y, inv[h], b.y);
      if constexpr (MASKED) {
        if (!active[q][h].x) v0 = fill;
        if (!active[q][h].y) v1 = fill;
      }
      if (n >= cap) v0 = kNegCap;
      if (n + 1 >= cap) v1 = kNegCap;
      tile_max[h] = fmaxf(tile_max[h], fmaxf(v0, v1));
      store(h, n, v0, v1);
    }
  }
}

// the thread's tile maxes -> its rows' maxes over the tile (a row's
// columns of the tile sit in the 4 lanes of a quad)
__device__ __forceinline__ void quad_max(float (&tile_max)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 1));
    tile_max[h] = fmaxf(tile_max[h], __shfl_xor_sync(0xffffffffu, tile_max[h], 2));
  }
}

// The tile's logits z (tile_logits) with their rows' maxes (quad_max)
// folded into the running (max m, sum-exp s) of the thread's rows r0 and
// r0 + 8: m' = max(m, tile max), s' = s exp(m - m') + sum exp(z - m').
// expf, not __expf.
__device__ __forceinline__ void fold_stats(const float (&z)[64], const float (&tile_max)[2],
                                           float (&m)[2], float (&s)[2]) {
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
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(p)), "r"(cta));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(remote) : "memory");
  return v;
}

template <int ID, int THREADS>
__device__ __forceinline__ void named_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
}
template <int ID, int THREADS>
__device__ __forceinline__ void named_arrive() {
  asm volatile("bar.arrive %0, %1;\n" ::"n"(ID), "n"(THREADS) : "memory");
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

// The skipping variants, the producer warpgroup (thread pt of 128) before
// it streams: one bit per tile of the block's part whose 64 x 128 mask bytes
// hold a nonzero (warp w reads tiles w, w + 4, ..., 16 loads per lane in
// flight), then, by its first warp, the compacted list and the skipped
// tiles' valid columns (those below `valid`).  part.tiles <= Tiles::kMaxTiles.
template <class Tiles>
__device__ __forceinline__ void find_active_tiles(Tiles* sp, const uint8_t* mask, int N, int m0,
                                                  const ColumnPart& part, int valid, int pt) {
  const int warp = pt / 32, lane = pt % 32;
  for (int i = pt; i < Tiles::kMaxTiles / 32; i += 128) sp->active[i] = 0;
  named_sync<kProducerBarrier, 128>();
  for (int g = warp; g < part.tiles; g += 4) {
    const uint8_t* tile = mask + static_cast<size_t>(m0) * N + (part.g0 + g) * hp::kTileN;
    int4 v[kScanInFlight];
#pragma unroll
    for (int i = 0; i < kScanInFlight; ++i) {
      const int c = lane + 32 * i;  // 16-byte chunk c: row c / 8, chunk c % 8 of the row
      v[i] = *reinterpret_cast<const int4*>(tile + static_cast<size_t>(c / 8) * N + (c % 8) * 16);
    }
    int any = 0;
#pragma unroll
    for (int i = 0; i < kScanInFlight; ++i) any |= v[i].x | v[i].y | v[i].z | v[i].w;
    if (__any_sync(0xffffffffu, any != 0) && lane == 0) atomicOr(&sp->active[g / 32], 1u << (g % 32));
  }
  named_sync<kProducerBarrier, 128>();
  if (warp == 0) {
    int count = 0, skipped = 0;
    for (int base = 0; base < part.tiles; base += 32) {
      const int g = base + lane;
      const bool in = g < part.tiles;
      const bool act = in && ((sp->active[g / 32] >> (g % 32)) & 1u);
      const unsigned ballot = __ballot_sync(0xffffffffu, act);
      if (act) sp->list[count + __popc(ballot & ((1u << lane) - 1))] = static_cast<typename Tiles::entry_type>(g);
      count += __popc(ballot);
      const int cols = in && !act ? min(max(valid - (part.g0 + g) * hp::kTileN, 0), hp::kTileN) : 0;
      skipped += __reduce_add_sync(0xffffffffu, cols);
    }
    if (lane == 0) {
      sp->count = count;
      sp->skipped_cols = skipped;
    }
  }
}

// is the block's tile g (of its part) active?
template <class Tiles>
__device__ __forceinline__ bool part_tile_active(const Tiles* sp, int g) {
  return (sp->active[g / 32] >> (g % 32)) & 1u;
}

}  // namespace rowstats
}  // namespace fdn
