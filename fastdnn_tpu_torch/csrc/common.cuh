// Device code shared by the port's Hopper kernels: the quantized-sigmoid
// epilogue (K1) and its table, the dequantization step, and two small
// helpers.  The kernels' products run on csrc/hopper.cuh's wgmma loop.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -fmad=false, never
// --use_fast_math, one nvcc per source (fastdnn_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fdn {

// ---------------------------------------------------------------------------
// K1: quantized sigmoid -> shifted int8.
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:_quantized_sigmoid_shifted
// (:50-78), the epilogue of every TPU hidden kernel:
//   k = trunc(100 * lin + copysign(0.5, lin))   C round(): half away from zero
//   s = floor(127.5 * tanh(k / 200))            round(255 * sigmoid(k / 100)) - 128
// Bound: a handful of flops per element, always fused behind a product.
// Exactness is the design constraint, not speed:
//   * each multiply and add is an explicitly rounded __fmul_rn / __fadd_rn,
//     so no FMA contraction merges the two roundings the XLA oracle makes
//     (a single rounding can move k across a half-step boundary);
//   * tanhf is the accurate libdevice tanh (no fast math; not tanh.approx),
//     within 2 ulp, far inside the >= 0.0216-count margin every table entry
//     has except k = +/-513, which stay pinned as on the TPU (no-ops here).
// ---------------------------------------------------------------------------
constexpr float kSigmoidResolution = 100.0f;
constexpr float kHalfScale = 127.5f;                                  // 255 / 2
constexpr float kHalfInvResolution = static_cast<float>(0.5 / 100.0);  // as XLA rounds it

// the integer step k of lin
__device__ __forceinline__ float sigmoid_step(float lin) {
  return truncf(__fadd_rn(__fmul_rn(lin, kSigmoidResolution), copysignf(0.5f, lin)));
}

// s of an integer step k
__device__ __forceinline__ int8_t sigmoid_of_step(float k) {
  float s = floorf(__fmul_rn(kHalfScale, tanhf(__fmul_rn(k, kHalfInvResolution))));
  if (k == 513.0f) s = 126.0f;
  if (k == -513.0f) s = -127.0f;
  return static_cast<int8_t>(s);
}

__device__ __forceinline__ int8_t quantized_sigmoid_shifted(float lin) {
  return sigmoid_of_step(sigmoid_step(lin));
}

// The same function through a table.  It depends on lin only through k, and
// for |k| >= kSigmoidTableHalf it is 127 or -128 (127.5 tanh(k / 200) lies in
// [127.08, 127.5] there), so a block that fills `table` with
// fill_sigmoid_table (kSigmoidTableBytes in shared memory) turns each value
// into one rounding and one lookup, bitwise equal to the call.
constexpr int kSigmoidTableHalf = 641;
constexpr int kSigmoidTableBytes = 2 * kSigmoidTableHalf + 1;

__device__ __forceinline__ void fill_sigmoid_table(int8_t* table, int tid, int count) {
  for (int i = tid; i < kSigmoidTableBytes; i += count)
    table[i] = sigmoid_of_step(static_cast<float>(i - kSigmoidTableHalf));
}

__device__ __forceinline__ int8_t sigmoid_from_table(const int8_t* table, float lin) {
  const float half = static_cast<float>(kSigmoidTableHalf);
  const float k = fminf(fmaxf(sigmoid_step(lin), -half), half);
  return table[static_cast<int>(k) + kSigmoidTableHalf];
}

// (acc + colsum128) * inv_scale + bias, rounded after the multiply and after
// the add exactly as fastdnn_tpu/ops/matmul.py:dequantize (:55-63) is.
__device__ __forceinline__ float dequantize(int acc, int colsum, float inv_scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc + colsum), inv_scale), bias);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Kernels that need more than the default 48 KB of dynamic shared memory
// must raise the per-function limit first.
template <typename Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace fdn
