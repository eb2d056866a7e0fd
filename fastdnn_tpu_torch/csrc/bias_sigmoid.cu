// K1 as a kernel of its own: out[b, n] = quantized_sigmoid_shifted(lin[b, n] + bias[n]).
//
// Replaces the quantized-sigmoid epilogue of the input layer, which the JAX
// package leaves to XLA behind its f32 matmul (fastdnn_tpu/ops/matmul.py:
// input_layer_step, :39-52), and is the kernel through which the exhaustive
// 1281-entry check reaches the shared epilogue
// (fastdnn_tpu/ops/pallas_kernels.py:_quantized_sigmoid_shifted, :50-78).
// Bound: device-memory bytes (4 read, 1 written per element, plus one tanhf);
// a grid-stride loop over consecutive elements keeps every access coalesced.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
    bias_sigmoid_kernel(const float* __restrict__ lin, const float* __restrict__ bias,
                        int8_t* __restrict__ out, long long total, int n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    out[i] = fdn::quantized_sigmoid_shifted(__fadd_rn(lin[i], bias[i % n]));
  }
}

}  // namespace

extern "C" int fdn_bias_sigmoid_i8(const void* lin, const void* bias, void* out, long long total,
                                   int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (total + 255) / 256;
  if (blocks > 132 * 32) blocks = 132 * 32;
  bias_sigmoid_kernel<<<static_cast<int>(blocks), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lin), static_cast<const float*>(bias), static_cast<int8_t*>(out),
      total, n);
  return static_cast<int>(cudaGetLastError());
}
