// K4: output layer + full row softmax, s8[B, K] x s8[K, N] -> f32[B, out_dim]
// (the weight arrives transposed, Wt s8[N, K]; ops/kernels.py:kernel_layout).
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:output_layer_posteriors_resident
// -> _resident_softmax_kernel_factory (:321-434), unmasked, f32 output.  On
// the TPU the whole K x N int8 weight (16.8 MB at 2048 x 8192) sat in VMEM and
// each grid step saw complete logit rows.  No SM holds that, so here one
// block owns BM = 64 frames (their activations stay in shared memory), walks
// the N tiles 128 columns at a time, writes the raw logits of the columns
// below out_dim straight into the output and keeps a running (max, sum-exp)
// per row; padding columns are capped at -1e30 as on the TPU (:346-348).  A
// second sweep of the same block rescales its own rows in place to
// exp(z - m) / s.  Softmax is per row, so no block needs another's result.
//
// Bound: 271 G int8 ops at B = 8192, K = 2048, N = 8064, but as for K2 the
// measured bound is L2 traffic: each block re-reads the whole 16.5 MB weight.
// The logits make one extra round trip through device memory (written, then
// read and rewritten in the second sweep: 2 x 4 x B x out_dim bytes), the part
// the TPU kept on chip.  expf, not __expf.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BM = 64;
// four stages: 16% faster than two (2.25-2.34 vs 2.75 ms at B = 8192,
// K = 2048, H100 80GB HBM3 at 700 W); the widest K that fits beside the
// 64-frame block is then 2048
constexpr int kStages = 4;
constexpr float kNegCap = -1e30f;

__host__ __device__ constexpr size_t smem_bytes(int k) {
  return static_cast<size_t>(BM) * k + kStages * fdn::kWStageBytes +
         sizeof(int) * BM * fdn::kLdc + 2 * sizeof(float) * BM;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(fdn::kThreads)
    resident_softmax_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                            const int* __restrict__ colsum, const float* __restrict__ bias,
                            float inv_scale, float* __restrict__ out, int K, int N, int out_dim) {
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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarps = fdn::kThreads / 32;
  for (int n0 = 0; n0 < N; n0 += fdn::kBN) {
    fdn::Acc<BM> acc;
    fdn::mma_tile<BM, true, kStages>(acc, nullptr, 0, 0, a_res, wt, K, n0, K, nullptr, w_stage);
    fdn::store_acc<BM>(acc, c_tile);
    __syncthreads();
    // one warp per row: lane covers columns lane, lane + 32, ... of the tile,
    // so the logit stores coalesce; each row's stats belong to one warp
    for (int r = warp; r < BM; r += kWarps) {
      float z[fdn::kBN / 32];
      float tile_max = kNegCap;
#pragma unroll
      for (int j = 0; j < fdn::kBN / 32; ++j) {
        const int n = n0 + lane + 32 * j;
        float v = fdn::dequantize(c_tile[r * fdn::kLdc + lane + 32 * j], colsum[n], inv_scale,
                                  bias[n]);
        if (n < out_dim) {
          out[static_cast<size_t>(m0 + r) * out_dim + n] = v;
        } else {
          v = kNegCap;
        }
        z[j] = v;
        tile_max = fmaxf(tile_max, v);
      }
      tile_max = warp_max(tile_max);
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, tile_max);
      float e = 0.0f;
#pragma unroll
      for (int j = 0; j < fdn::kBN / 32; ++j) e += expf(z[j] - m_new);
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
    float* row = out + static_cast<size_t>(m0 + r) * out_dim;
    for (int n = lane; n < out_dim; n += 32) row[n] = expf(row[n] - m) / s;
  }
}

}  // namespace

// Requires B % 64 == 0, K % 128 == 0, N % 128 == 0, 0 < out_dim <= N and
// fdn_resident_softmax_smem_bytes(K) within the block limit (checked by the
// wrapper).
extern "C" int fdn_resident_softmax(const void* x, const void* wt, const void* colsum,
                                    const void* bias, float inv_scale, void* out, int b, int k,
                                    int n, int out_dim, int device, void* stream) {
  const size_t bytes = smem_bytes(k);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fdn::allow_smem(resident_softmax_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  resident_softmax_kernel<<<b / BM, fdn::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
      static_cast<float*>(out), k, n, out_dim);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long fdn_resident_softmax_smem_bytes(int k) {
  return static_cast<long long>(smem_bytes(k));
}
