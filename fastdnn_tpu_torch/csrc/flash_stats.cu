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
// with the activations streamed as K2 streams them (csrc/hopper.cuh).  A
// cluster of 2 blocks shares 64 frames and splits the column tiles
// (row_stats.cuh: ColumnPart); in each block a producer warp keeps a TMA
// mbarrier ring full, every stage a 128 x 128-byte weight slice and the
// 64 x 128-byte activation tile beside it (so K has no limit), and two
// consumer warpgroups take the tiles in turn, one's epilogue beside the
// other's wgmma.  The epilogue (row_stats.cuh: tile_logits) dequantizes
// ((acc + colsum) * inv_scale + bias, rounded after the multiply and after
// the add), masks (reference: an inactive logit is 0 and joins the max;
// active_only: -1e30), caps every column at or beyond `valid_count` (a
// runtime argument) at -1e30, stores z for every padded column (FAST: bf16
// z - tile max, and the f32 tile max per row and 128-column tile) and folds
// the tile into each row's (max, sum-exp), held in registers.  The two
// warpgroups merge their stats, then the two blocks theirs through
// distributed shared memory, in rank order, and block 0 writes m and s.
// The TPU kernel's [B, 128] VMEM stats scratch becomes registers.
//
// SKIP takes K6's approach: the producer warpgroup reads the block's mask
// tiles before it streams and keeps the list of the active ones; the ring
// streams those alone.  A skipped tile loads nothing and runs no wgmma: the
// producer warpgroup's other three warps store its fill (0 or -1e30; -1e30
// beyond valid_count under CAPPED_FILL) with 16-byte stores, and under
// reference its valid columns fold into the block's stats once, in closed
// form, as logit 0 (the pair (0, count)); under active_only they add
// nothing.  m is the same max of the same values as the plain version's, so
// it is bitwise equal; s is a sum in another order.
//
// Bound: at B = 8192, K = 2048, N = 8064 the products are 271 G int8 ops
// (0.137 ms at 1979 TOP/s), more than the bytes: frames 16.8 MB, weight
// 16.5 MB and z 264 MB (0.089 ms at 3.35 TB/s).  As for K4, each block
// reads its half of the weight from L2, and here also its 64 x K
// activations once per tile.  The normalize is bytes alone: z read and
// posteriors written once, 524 MB at out_dim 8000 (0.157 ms).  expf, not
// __expf.
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

// K2's ring: 8 stages of a 16 KB weight slice and an 8 KB activation tile
constexpr int kStages = 8;
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
  return hp::kAlign + static_cast<size_t>(kStages) * (hp::kStageBytes + hp::kActBlockBytes) +
         hp::Ring<kStages, 1>::kBytes + sizeof(float2) * hp::kConsumers * hp::kFrames +
         (SKIP ? sizeof(SkipTiles) : 0);
}

// One consumer warpgroup's tile t (columns [128 t, 128 t + 128)) of its 64
// rows: the masked, capped logits stored to z (FAST: bf16 z - tile max,
// the tile maxes to tile_max_out [B, N / 128]) and folded into the thread's
// rows' running (max, sum-exp).
template <bool MASKED, bool FAST>
__device__ __forceinline__ void stats_epilogue(const int (&d)[64], ZType<FAST>* z,
                                               float* tile_max_out, int m0, int t,
                                               const int* colsum, const float* bias, float inv,
                                               const uint8_t* mask, int N, float fill,
                                               int valid_count, int thread_in_wg, float (&m)[2],
                                               float (&s)[2]) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int col = t * hp::kTileN + 2 * (lane % 4);
  const int r0 = m0 + warp * 16 + lane / 4;
  ZType<FAST>* rows[2] = {z + static_cast<size_t>(r0) * N, z + static_cast<size_t>(r0 + 8) * N};
  float v[64], tile_max[2];
  rs::tile_logits<MASKED>(d, v, tile_max, r0, col, colsum, bias, inv, mask, N, fill, valid_count,
                          [&](int h, int n, float v0, float v1) {
                            if constexpr (!FAST)
                              *reinterpret_cast<float2*>(rows[h] + n) = make_float2(v0, v1);
                          });
  rs::quad_max(tile_max);
  if constexpr (FAST) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(rows[h] + col + 8 * q) = __floats2bfloat162_rn(
            v[4 * q + 2 * h] - tile_max[h], v[4 * q + 2 * h + 1] - tile_max[h]);
    if (lane % 4 == 0) {
      const size_t tiles = N / hp::kTileN;
      tile_max_out[r0 * tiles + t] = tile_max[0];
      tile_max_out[(r0 + 8) * tiles + t] = tile_max[1];
    }
  }
  rs::fold_stats(v, tile_max, m, s);
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

// MASKED: the mask is read (always under SKIP); `semantics` 0 reference,
// 1 active_only.  FAST: z is bf16 (z - tile max) and the f32 tile maxes go
// to tile_max [B, N / 128].  SKIP: all-inactive tiles are skipped, and
// capped_fill != 0 stores -1e30 beyond valid_count in them.
template <bool MASKED, bool FAST, bool SKIP>
__global__ void __launch_bounds__(hp::kThreads, 1)
    flash_stats_kernel(const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap x_map, const int* __restrict__ colsum,
                       const float* __restrict__ bias, float inv_scale,
                       const uint8_t* __restrict__ mask, int semantics, int valid_count,
                       int capped_fill, ZType<FAST>* __restrict__ z, float* __restrict__ m_out,
                       float* __restrict__ s_out, float* __restrict__ tile_max_out, int K, int N) {
  static_assert(MASKED || !SKIP, "tile skipping reads the mask");
  static_assert(!(SKIP && FAST), "the skipping variant stores f32 z");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hp::align_smem(smem_raw);
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  int8_t* acts = stages + kStages * hp::kStageBytes;  // one activation tile per stage
  hp::Ring<kStages, 1> ring{reinterpret_cast<uint64_t*>(acts + kStages * hp::kActBlockBytes)};
  // (m, s) per row: [warpgroup][row]; the block's merge goes to [0][row]
  float2* stats = reinterpret_cast<float2*>(reinterpret_cast<unsigned char*>(ring.bars) +
                                            hp::Ring<kStages, 1>::kBytes);
  SkipTiles* sp =
      SKIP ? reinterpret_cast<SkipTiles*>(stats + hp::kConsumers * hp::kFrames) : nullptr;

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
    if constexpr (SKIP) {
      rs::find_active_tiles(sp, mask, N, m0, part, valid_count, pt);
      __syncwarp();
      rs::named_arrive<rs::kListBarrier, hp::kThreads>();
    }
    hp::reg_dealloc<hp::kProducerRegs>();
    if (pt == 0) {
      // stage e * steps + t: the t-th 128 bytes of K of the e-th tile taken
      const int count = SKIP ? sp->count : part.tiles;
      for (int e = 0; e < count; ++e) {
        const int g = SKIP ? sp->list[e] : e;
        for (int t = 0; t < steps; ++t)
          ring.produce(stages, &w_map, e * steps + t, t * hp::kStageK, (part.g0 + g) * hp::kTileN,
                       0, acts, &x_map, m0);
      }
    } else if constexpr (SKIP) {
      if (pt >= 32)
        store_skipped(z, sp, part, m0, N, fill, capped_fill ? valid_count : N, pt - 32, 96);
    }
    hp::cluster_sync();  // the consumers' exchange
    hp::cluster_sync();
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    if constexpr (SKIP) rs::named_sync<rs::kListBarrier, hp::kThreads>();
    const int tid = threadIdx.x;
    const int tw = tid % 128;
    const int count = SKIP ? sp->count : part.tiles;
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    float m[2] = {-INFINITY, -INFINITY};
    float s[2] = {0.0f, 0.0f};
    for (int e = wg, n = 0; e < count; e += hp::kConsumers, ++n) {
      const int g = SKIP ? sp->list[e] : e;
      hp::tile_products<kStages, 1, true>(d, ring, stages, acts, K, e * steps, wg, n, tw);
      stats_epilogue<MASKED, FAST>(d, z, tile_max_out, m0, part.g0 + g, colsum, bias, inv_scale,
                                   mask, N, fill, valid_count, tw, m, s);
    }
    if (tw % 4 == 0) {
      const int r = (tw / 32) * 16 + (tw % 32) / 4;
      stats[wg * hp::kFrames + r] = make_float2(m[0], s[0]);
      stats[wg * hp::kFrames + r + 8] = make_float2(m[1], s[1]);
    }
    hp::consumer_sync();
    if (tid < hp::kFrames) {
      float2 block = rs::merge_stats(stats[tid], stats[hp::kFrames + tid]);
      // SKIP under reference: the skipped tiles' valid columns, logit 0 each
      if constexpr (SKIP) {
        if (semantics == kReference && sp->skipped_cols > 0)
          block = rs::merge_stats(block, make_float2(0.0f, static_cast<float>(sp->skipped_cols)));
      }
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

template <bool MASKED, bool FAST, bool SKIP>
cudaError_t launch(const void* x, const void* wt, const void* colsum, const void* bias,
                   float inv_scale, const void* mask, int semantics, int valid_count,
                   int capped_fill, void* z, void* m, void* s, void* tile_max, int b, int k, int n,
                   void* stream) {
  CUtensorMap w_map, x_map;
  cudaError_t err = hp::weight_map(&w_map, wt, n, k, hp::kTileN);
  if (err == cudaSuccess) err = hp::weight_map(&x_map, x, b, k, hp::kFrames);
  if (err != cudaSuccess) return err;
  return hp::launch_clustered(
      flash_stats_kernel<MASKED, FAST, SKIP>, rs::kSplit * b / hp::kFrames, rs::kSplit,
      smem_bytes<SKIP>(), stream, w_map, x_map, static_cast<const int*>(colsum),
      static_cast<const float*>(bias), inv_scale, static_cast<const uint8_t*>(mask), semantics,
      valid_count, capped_fill, static_cast<ZType<FAST>*>(z), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(tile_max), k, n);
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
