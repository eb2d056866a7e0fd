// K4: output layer + full row softmax, s8[B, K] x s8[K, N] -> f32 or bf16
// [B, out_dim], optionally masked (u8 [B, N], nonzero = active).
// K6: the masked K4 skipping every all-inactive (64-frame x 128-senone) tile.
// Both take the weight transposed, Wt s8[N, K] (ops/kernels.py:kernel_layout),
// and share this tile loop.
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
#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

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
