// K5: output-layer logits, s8[B, K] x s8[K, N] -> f32[B, N], no softmax
// (the weight arrives transposed, Wt s8[N, K]; ops/kernels.py:kernel_layout).
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:output_layer_logits -> _layer_call
// with _logits_kernel (:109-111, :1103-1127): exact int32 product, + colsum128,
// x inv_scale, + bias, rounded after the multiply and after the add (the
// library is built with -fmad=false), so the result is bitwise the plain
// version's.  It serves the frame-by-frame LazyContext (one frame, padded to
// one 64-row tile, per decoder frame) and fused_softmax=False.
//
// Bound: the K2 design (csrc/hidden_layer.cu), with an f32 epilogue in place
// of the sigmoid.  At B = 64 the launch is 63 blocks, each streaming its
// 128 x K weight slice once: the 16.5 MB weight read from device memory
// (about 5 us at 3.35 TB/s) bounds it, and the grid fills half the SMs.  At
// B = 8192 every block re-reads its weight slice from L2 and the 4-byte output
// (264 MB at N = 8064) adds device-memory traffic the int8 layers do not have.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int kStages = 3;  // 107 KB: two blocks per SM
constexpr size_t kSmemBytes =
    kStages * (BM * fdn::kBK + fdn::kWStageBytes) + sizeof(int) * BM * fdn::kLdc;

__global__ void __launch_bounds__(fdn::kThreads)
    output_logits_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                         const int* __restrict__ colsum, const float* __restrict__ bias,
                         float inv_scale, float* __restrict__ out, int K, int N) {
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

  // epilogue: 4 consecutive columns of one row per step -> one 16-byte store
  constexpr int kChunks = fdn::kBN / 4;
  for (int i = threadIdx.x; i < BM * kChunks; i += fdn::kThreads) {
    const int r = i / kChunks, c0 = (i % kChunks) * 4;
    const int* c = c_tile + r * fdn::kLdc + c0;
    const int n = n0 + c0;
    float4 v;
    v.x = fdn::dequantize(c[0], colsum[n], inv_scale, bias[n]);
    v.y = fdn::dequantize(c[1], colsum[n + 1], inv_scale, bias[n + 1]);
    v.z = fdn::dequantize(c[2], colsum[n + 2], inv_scale, bias[n + 2]);
    v.w = fdn::dequantize(c[3], colsum[n + 3], inv_scale, bias[n + 3]);
    *reinterpret_cast<float4*>(out + static_cast<size_t>(m0 + r) * N + n) = v;
  }
}

}  // namespace

// Requires B % 64 == 0, K % 128 == 0, N % 128 == 0 (checked by the wrapper).
extern "C" int fdn_output_logits(const void* x, const void* wt, const void* colsum,
                                 const void* bias, float inv_scale, void* out, int b, int k, int n,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fdn::allow_smem(output_logits_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / fdn::kBN, b / BM);
  output_logits_kernel<<<grid, fdn::kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
      static_cast<float*>(out), k, n);
  return static_cast<int>(cudaGetLastError());
}
