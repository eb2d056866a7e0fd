// K2: one quantized hidden layer, s8[B, K] x s8[K, N] -> shifted s8[B, N]
// (the weight arrives transposed, Wt s8[N, K]; ops/kernels.py:kernel_layout).
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:fused_hidden_layer -> _layer_call
// with _hidden_kernel (:81-84, :130-208): exact int32 product, + colsum128,
// x inv_scale, + bias, then the K1 sigmoid, all before anything leaves the
// block, so device memory sees int8 in, int8 weights, int8 out.
//
// Bound: at the flagship shape (B = 8320, K = N = 2048) the layer is 70 G
// int8 ops against ~21 MB of device-memory traffic, far above the card's
// ops-per-byte ridge on paper.  The TPU grid ran frames fastest so one VMEM
// weight block served every frame block; here blocks run in parallel, each
// owning a 64 x 128 output tile, and re-read their weight and activation
// tiles from the 50 MB L2 (~0.8 GB per layer).  Measured on an H100, that
// L2 traffic, not the tensor cores, bounds the loop; it feeds mma.sync
// (m16n8k32) from ldmatrix through a 3-stage cp.async ring, not wgmma/TMA.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int kStages = 3;  // 107 KB: two blocks per SM
constexpr size_t kSmemBytes =
    kStages * (BM * fdn::kBK + fdn::kWStageBytes) + sizeof(int) * BM * fdn::kLdc;

__global__ void __launch_bounds__(fdn::kThreads)
    hidden_layer_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                        const int* __restrict__ colsum, const float* __restrict__ bias,
                        float inv_scale, int8_t* __restrict__ out, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* a_stage = reinterpret_cast<int8_t*>(smem);
  int8_t* w_stage = a_stage + kStages * BM * fdn::kBK;
  int* c_tile = reinterpret_cast<int*>(w_stage + kStages * fdn::kWStageBytes);

  const int n0 = blockIdx.x * fdn::kBN;
  const int m0 = blockIdx.y * BM;
  fdn::Acc<BM> acc;
  fdn::mma_tile<BM, false, kStages>(acc, x, K, m0, nullptr, wt, K, n0, K, a_stage, w_stage);
  fdn::store_acc<BM>(acc, c_tile);
  __syncthreads();

  // epilogue: 16 consecutive columns of one row per step -> one 16-byte store
  constexpr int kChunks = fdn::kBN / 16;
  for (int i = threadIdx.x; i < BM * kChunks; i += fdn::kThreads) {
    const int r = i / kChunks, c0 = (i % kChunks) * 16;
    alignas(16) int8_t v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + c0 + j;
      v[j] = fdn::quantized_sigmoid_shifted(
          fdn::dequantize(c_tile[r * fdn::kLdc + c0 + j], colsum[n], inv_scale, bias[n]));
    }
    *reinterpret_cast<int4*>(out + static_cast<size_t>(m0 + r) * N + n0 + c0) =
        *reinterpret_cast<const int4*>(v);
  }
}

}  // namespace

// Requires B % 64 == 0, K % 128 == 0, N % 128 == 0 (checked by the wrapper).
extern "C" int fdn_hidden_layer(const void* x, const void* wt, const void* colsum,
                                const void* bias, float inv_scale, void* out, int b, int k, int n,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fdn::allow_smem(hidden_layer_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / fdn::kBN, b / BM);
  hidden_layer_kernel<<<grid, fdn::kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
      static_cast<int8_t*>(out), k, n);
  return static_cast<int>(cudaGetLastError());
}
