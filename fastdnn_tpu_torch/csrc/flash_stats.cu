// K8: output-layer logits plus flash-softmax stats, s8[B, K] x s8[K, N] ->
// z [B, N] and the per-row running (max, sum-exp) m, s [B], optionally
// masked (u8 [B, N], nonzero = active) and optionally skipping all-inactive
// (64-frame x 128-senone) tiles.  The weight arrives transposed, Wt s8[N, K]
// (ops/kernels.py:kernel_layout).  The normalize, exp(z - m) / s, is plain
// tensor code outside the kernel, as it was XLA outside the Pallas kernel.
//
// Replaces, in one family, fastdnn_tpu/ops/pallas_kernels.py:
//   B5 output_layer_posteriors -> _flash_stats_call -> _stats_kernel_factory
//      (:437-668): the stats kernel the JAX scorer falls back to when the
//      output layer is too large for the resident kernel; FAST stores z in
//      bf16 relative to its tile max, with the f32 tile maxes beside it;
//   B6 output_layer_flash_stats (:671-707): the same with a dynamic
//      `valid_count`, the per-shard half of the tensor-parallel softmax;
//   B7 output_layer_posteriors_block_sparse / output_flash_stats_block_sparse
//      -> _block_sparse_kernel_factory (:710-971): SKIP, with CAPPED_FILL.
//
// Design.  One block owns BM = 64 frames and sweeps the N tiles 128 columns
// at a time, as K4 does (csrc/resident_softmax.cu), keeping each row's
// running (max, sum-exp) in the registers of the warp that owns the row.
// Unlike K4 it does not keep the frame block's activations in shared memory:
// they stream beside the weight slice through K5's cp.async ring
// (fdn::mma_tile with A staged), so shared memory holds only the ring and the
// C tile and the output layer's input width K has no limit from it (K4 stops
// at K = 2048).  The logits go to z once and are never read back here; the
// TPU kernel's [B, 128] VMEM stats scratch becomes registers, because blocks
// run in parallel and own whole rows.
//
// Epilogue per tile: the K5 dequantization ((acc + colsum) * inv_scale + bias,
// rounded after the multiply and after the add), then the mask (reference:
// an inactive logit is 0 and joins the max; active_only: -1e30), then the
// cap: a column at or beyond `valid_count` (a runtime argument) is -1e30.  A
// skipped tile (SKIP) issues no weight load and no product.  The TPU kernel
// accounted for skipped tiles in the stats' initial value (m = 0, s = nskip
// under reference); here each skipped tile folds in as it comes:
// under reference its valid columns enter as logit 0 (m = max(m, 0), s gains
// count * exp(-m)); under active_only it adds nothing.  Its stored z is the
// fill (0 or -1e30), and -1e30 beyond `valid_count` under CAPPED_FILL (the
// tensor-parallel shards keep the full padded width).  m is the same max of
// the same values as the plain version's, so it is bitwise equal; s is a sum
// in another order.
//
// Bound: at B = 8192, K = 2048, N = 8064 the products are 271 G int8 ops, but
// as for K4 the bound is the bytes each SM receives from L2: each block reads
// the whole 16.5 MB weight (as K4 does) and, unlike K4, its 64 x K
// activation slice once per tile (63 x 128 KB = 8.3 MB more per block), so
// about 1.5x K4's L2 traffic.  z adds one write of 4 (FAST: 2) bytes per
// (frame, padded column) to device memory.  expf, not __expf.
#include <cuda_bf16.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int kStages = 4;  // 130 KB: one block per SM, as the 128 blocks at B = 8192 use
constexpr size_t kSmemBytes =
    kStages * (BM * fdn::kBK + fdn::kWStageBytes) + sizeof(int) * BM * fdn::kLdc;
using fdn::kColsPerLane;
using fdn::kNegCap;
using fdn::kReference;
using fdn::kWarps;
constexpr int kRowsPerWarp = BM / kWarps;  // epilogue rows of one warp: warp + kWarps * i

template <bool FAST>
using ZType = typename std::conditional<FAST, __nv_bfloat16, float>::type;

// MASKED: the mask is read (always under SKIP).  SEMANTICS: 0 reference,
// 1 active_only (only read when MASKED).  FAST: z is bf16 (z - tile max) and
// the f32 tile maxes go to tile_max [B, N / 128].  SKIP: all-inactive tiles
// are skipped.  CAPPED_FILL: a skipped tile stores -1e30 beyond valid_count.
template <bool MASKED, int SEMANTICS, bool FAST, bool SKIP, bool CAPPED_FILL>
__global__ void __launch_bounds__(fdn::kThreads)
    flash_stats_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                       const int* __restrict__ colsum, const float* __restrict__ bias,
                       float inv_scale, const uint8_t* __restrict__ mask, int valid_count,
                       ZType<FAST>* __restrict__ z, float* __restrict__ m_out,
                       float* __restrict__ s_out, float* __restrict__ tile_max_out, int K, int N) {
  static_assert(MASKED || !SKIP, "tile skipping reads the mask");
  static_assert(!(SKIP && FAST), "the skipping variant stores f32 z");
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* a_stage = reinterpret_cast<int8_t*>(smem);
  int8_t* w_stage = a_stage + kStages * BM * fdn::kBK;
  int* c_tile = reinterpret_cast<int*>(w_stage + kStages * fdn::kWStageBytes);

  const int m0 = blockIdx.x * BM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = N / fdn::kBN;
  // the logit of an inactive senone
  constexpr float fill = SEMANTICS == kReference ? 0.0f : kNegCap;

  float row_m[kRowsPerWarp], row_s[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    row_m[i] = kNegCap;
    row_s[i] = 0.0f;
  }
  uint8_t raw[kRowsPerWarp][kColsPerLane] = {};
  if constexpr (MASKED) fdn::load_mask(raw, mask, N, m0, 0, warp, lane);

  for (int t = 0; t < tiles; ++t) {
    const int n0 = t * fdn::kBN;
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
      fdn::mma_tile<BM, false, kStages>(acc, x, K, m0, nullptr, wt, K, n0, K, a_stage, w_stage);
      fdn::store_acc<BM>(acc, c_tile);
    }
    __syncthreads();

    if constexpr (SKIP) {
      if (!active) {
        // valid columns of the tile: under reference each enters as logit 0
        const int count = min(max(valid_count - n0, 0), fdn::kBN);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const size_t row = static_cast<size_t>(m0 + warp + kWarps * i) * N;
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) {
            const int n = n0 + lane + 32 * j;
            z[row + n] = (CAPPED_FILL && n >= valid_count) ? kNegCap : fill;
          }
          if (SEMANTICS == kReference && count > 0) {
            const float m_new = fmaxf(row_m[i], 0.0f);
            row_s[i] =
                row_s[i] * expf(row_m[i] - m_new) + static_cast<float>(count) * expf(-m_new);
            row_m[i] = m_new;
          }
        }
        continue;  // no C tile was written: the next tile's barrier suffices
      }
    }

#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp + kWarps * i;
      const size_t row = static_cast<size_t>(m0 + r) * N;
      float v[kColsPerLane];
      float tile_max = kNegCap;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        const int n = n0 + c;
        float val = fdn::dequantize(c_tile[r * fdn::kLdc + c], colsum[n], inv_scale, bias[n]);
        if (MASKED && !((word >> (kColsPerLane * i + j)) & 1u)) val = fill;
        if (n >= valid_count) val = kNegCap;
        v[j] = val;
        tile_max = fmaxf(tile_max, val);
      }
      tile_max = fdn::warp_max(tile_max);
      if constexpr (FAST) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          z[row + n0 + lane + 32 * j] = __float2bfloat16_rn(v[j] - tile_max);
        if (lane == 0) tile_max_out[static_cast<size_t>(m0 + r) * tiles + t] = tile_max;
      } else {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j) z[row + n0 + lane + 32 * j] = v[j];
      }
      const float m_new = fmaxf(row_m[i], tile_max);
      float e = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) e += expf(v[j] - m_new);
      e = fdn::warp_sum(e);
      row_s[i] = row_s[i] * expf(row_m[i] - m_new) + e;
      row_m[i] = m_new;
    }
    // every warp is done reading the C tile before the next tile rewrites it
    __syncthreads();
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      m_out[m0 + warp + kWarps * i] = row_m[i];
      s_out[m0 + warp + kWarps * i] = row_s[i];
    }
  }
}

template <bool MASKED, int SEMANTICS, bool FAST, bool SKIP, bool CAPPED_FILL>
int launch(const void* x, const void* wt, const void* colsum, const void* bias, float inv_scale,
           const void* mask, int valid_count, void* z, void* m, void* s, void* tile_max, int b,
           int k, int n, int device, void* stream) {
  auto kernel = flash_stats_kernel<MASKED, SEMANTICS, FAST, SKIP, CAPPED_FILL>;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fdn::allow_smem(kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<b / BM, fdn::kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
      static_cast<const uint8_t*>(mask), valid_count, static_cast<ZType<FAST>*>(z),
      static_cast<float*>(m), static_cast<float*>(s), static_cast<float*>(tile_max), k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K8.  mask: nullptr (unmasked) or u8 [B, N]; semantics 0 reference,
// 1 active_only; 0 <= valid_count <= N.  fast == 0: z is f32 [B, N] and
// tile_max is ignored; fast != 0: z is bf16 [B, N] (z - tile max) and
// tile_max f32 [B, N / 128].  m, s: f32 [B].  skip != 0 (mask required, fast
// == 0): all-inactive (64 x 128) tiles are skipped, and capped_fill != 0
// stores -1e30 beyond valid_count in them.  Requires B % 64 == 0,
// K % 128 == 0, N % 128 == 0, 16-byte aligned x and wt (checked by the
// wrapper).  Returns a cudaError_t; 1 (cudaErrorInvalidValue) for a
// combination the kernel has no instantiation of.
extern "C" int fdn_flash_stats(const void* x, const void* wt, const void* colsum,
                               const void* bias, float inv_scale, const void* mask, int semantics,
                               int valid_count, int skip, int capped_fill, int fast, void* z,
                               void* m, void* s, void* tile_max, int b, int k, int n, int device,
                               void* stream) {
#define FDN_FLASH_ARGS \
  x, wt, colsum, bias, inv_scale, mask, valid_count, z, m, s, tile_max, b, k, n, device, stream
  const bool ref = semantics == kReference;
  if (skip) {
    if (!mask || fast) return static_cast<int>(cudaErrorInvalidValue);
    if (ref)
      return capped_fill ? launch<true, 0, false, true, true>(FDN_FLASH_ARGS)
                         : launch<true, 0, false, true, false>(FDN_FLASH_ARGS);
    return capped_fill ? launch<true, 1, false, true, true>(FDN_FLASH_ARGS)
                       : launch<true, 1, false, true, false>(FDN_FLASH_ARGS);
  }
  if (!mask)
    return fast ? launch<false, 0, true, false, false>(FDN_FLASH_ARGS)
                : launch<false, 0, false, false, false>(FDN_FLASH_ARGS);
  if (ref)
    return fast ? launch<true, 0, true, false, false>(FDN_FLASH_ARGS)
                : launch<true, 0, false, false, false>(FDN_FLASH_ARGS);
  return fast ? launch<true, 1, true, false, false>(FDN_FLASH_ARGS)
              : launch<true, 1, false, false, false>(FDN_FLASH_ARGS);
#undef FDN_FLASH_ARGS
}
