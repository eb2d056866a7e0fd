// K1 as a kernel of its own: out[b, n] = quantized_sigmoid_shifted(lin[b, n] + bias[n]).
//
// Replaces the quantized-sigmoid epilogue of the input layer, which the JAX
// package leaves to XLA behind its f32 matmul (fastdnn_tpu/ops/matmul.py:
// input_layer_step, :39-52), and is the kernel through which the exhaustive
// 1281-entry check reaches the shared epilogue
// (fastdnn_tpu/ops/pallas_kernels.py:_quantized_sigmoid_shifted, :50-78).
//
// Bound: device-memory bytes, 4 read and 1 written per element (the bias
// stays in L1).  The work per element has to stay below what 5 bytes of
// traffic hide, so:
//   * one warp per row, each lane owning 16 consecutive columns at a time:
//     four 16-byte streaming loads (__ldcs), the bias as float4 through the
//     read-only path, and one 16-byte streaming store of 16 packed int8;
//   * the row and the 16-column chunk are 32-bit loop indices (no division;
//     only the row's base offset is 64-bit);
//   * the sigmoid comes from the block's 1,283-byte shared table
//     (fill_sigmoid_table / sigmoid_from_table, common.cuh), bitwise equal to
//     quantized_sigmoid_shifted: one rounding, a clamp and one lookup;
//   * a grid of at most one resident wave (kMaxBlocks) walks the rows, so
//     each block fills its table once for many rows.
// A row whose input or output does not start on a 16-byte boundary (N not a
// multiple of 16 puts every row after the first off it; so does a slice of
// a larger buffer), and each row's last N % 16 columns, take the scalar
// path: the same lookup, one element per lane, still coalesced.
// lin + bias stays one __fadd_rn, as the build forbids FMA contraction.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;  // one warp per row
constexpr int kChunk = 16;                    // columns per lane and step
constexpr int kMinBlocksPerSm = 4;
// The most blocks launched: kMinBlocksPerSm on each of the H100's 132 SMs,
// resident at once by the launch bounds.  More rows are walked in turn.
constexpr int kMaxBlocks = 132 * kMinBlocksPerSm;

__device__ __forceinline__ uint32_t sigmoid4(const int8_t* table, float4 x, float4 b) {
  const uint32_t s0 = static_cast<uint8_t>(fdn::sigmoid_from_table(table, __fadd_rn(x.x, b.x)));
  const uint32_t s1 = static_cast<uint8_t>(fdn::sigmoid_from_table(table, __fadd_rn(x.y, b.y)));
  const uint32_t s2 = static_cast<uint8_t>(fdn::sigmoid_from_table(table, __fadd_rn(x.z, b.z)));
  const uint32_t s3 = static_cast<uint8_t>(fdn::sigmoid_from_table(table, __fadd_rn(x.w, b.w)));
  return s0 | (s1 << 8) | (s2 << 16) | (s3 << 24);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    bias_sigmoid_kernel(const float* __restrict__ lin, const float* __restrict__ bias,
                        int8_t* __restrict__ out, int rows, int n) {
  __shared__ int8_t table[fdn::kSigmoidTableBytes];
  fdn::fill_sigmoid_table(table, threadIdx.x, kThreads);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int chunks = n / kChunk;  // whole 16-column chunks of a row
  const bool bias_vector = aligned16(bias);
  const float4* bias4 = reinterpret_cast<const float4*>(bias);
  for (int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5); row < rows;
       row += gridDim.x * kRowsPerBlock) {
    const size_t base = static_cast<size_t>(row) * static_cast<size_t>(n);
    const float* src = lin + base;
    int8_t* dst = out + base;
    int scalar_from = 0;
    if (bias_vector && aligned16(src) && aligned16(dst)) {
      const float4* src4 = reinterpret_cast<const float4*>(src);
      uint4* dst16 = reinterpret_cast<uint4*>(dst);
      for (int c = lane; c < chunks; c += 32) {
        float4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = __ldcs(src4 + 4 * c + i);
        uint32_t packed[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) packed[i] = sigmoid4(table, x[i], __ldg(bias4 + 4 * c + i));
        __stcs(dst16 + c, make_uint4(packed[0], packed[1], packed[2], packed[3]));
      }
      scalar_from = chunks * kChunk;
    }
    for (int j = scalar_from + lane; j < n; j += 32)
      dst[j] = fdn::sigmoid_from_table(table, __fadd_rn(__ldcs(src + j), __ldg(bias + j)));
  }
}

}  // namespace

extern "C" int fdn_bias_sigmoid_i8(const void* lin, const void* bias, void* out, long long total,
                                   int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 0 || total % n != 0 || total / n > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = static_cast<int>(total / n);
  const int wanted = (rows - 1) / kRowsPerBlock + 1;
  const int blocks = wanted < kMaxBlocks ? wanted : kMaxBlocks;
  bias_sigmoid_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lin), static_cast<const float*>(bias), static_cast<int8_t*>(out),
      rows, n);
  return static_cast<int>(cudaGetLastError());
}
