// K3: all L equal-width hidden layers in one launch, s8[B, H] -> s8[B, H]
// (weights transposed per layer, Wt s8[L, H, H]; ops/kernels.py:kernel_layout).
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:fused_hidden_stack ->
// _stack_kernel_factory (:211-318).  On the TPU a sequential grid axis over
// layers carried the activations in a VMEM scratch; blocks here run in
// parallel and in no order, so the layer axis becomes a loop inside the block:
// each block owns BM = 64 frames, keeps their activations in shared memory
// (64 * H bytes = 128 KB at H = 2048) and walks layer after layer, 128 output
// columns at a time, with K2's product and epilogue.  A layer's output goes
// to the block's own rows of `out` (they stay in L2) and is read back into
// shared memory before the next layer; after the last layer it is already
// in place.  No other block touches those rows, so no grid-wide sync is
// needed.
//
// Bound: 6 layers at B = 8192, H = 2048 are 412 G int8 ops, but the loop is
// bound by the rate weight bytes reach each SM: every block re-reads the
// whole 25 MB weight stack from L2 (it fits in the 50 MB L2).  One output
// buffer in device memory instead of a shared-memory ping-pong is what lets
// a block hold 64 frames instead of 32, halving the weight bytes per product.
#include "common.cuh"

namespace {

constexpr int BM = 64;
// one block per SM; three stages keep the widest H that fits at 2304
constexpr int kStages = 3;

__host__ __device__ constexpr size_t smem_bytes(int h) {
  return static_cast<size_t>(BM) * h + kStages * fdn::kWStageBytes +
         sizeof(int) * BM * fdn::kLdc;
}

// rows [m0, m0 + BM) of a row-major [*, H] int8 matrix -> the panelled tile
__device__ __forceinline__ void load_rows(int8_t* tile, const int8_t* src, int m0, int H) {
  const int chunks = H / 16;
  for (int i = threadIdx.x; i < BM * chunks; i += fdn::kThreads) {
    const int r = i / chunks, c = i % chunks;
    *reinterpret_cast<int4*>(tile + (c * BM + r) * 16) =
        *reinterpret_cast<const int4*>(src + static_cast<size_t>(m0 + r) * H + c * 16);
  }
}

// `out` is written and read back by the same block: no __restrict__, so
// its loads never take the read-only (non-coherent) path
__global__ void __launch_bounds__(fdn::kThreads)
    hidden_stack_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                        const int* __restrict__ colsum, const float* __restrict__ inv_scales,
                        const float* __restrict__ bias, int8_t* out, int H, int L) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* acts = reinterpret_cast<int8_t*>(smem);
  int8_t* w_stage = acts + BM * H;
  int* c_tile = reinterpret_cast<int*>(w_stage + kStages * fdn::kWStageBytes);

  const int m0 = blockIdx.x * BM;
  load_rows(acts, x, m0, H);
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const int8_t* wl = wt + static_cast<size_t>(l) * H * H;
    const int* cs = colsum + static_cast<size_t>(l) * H;
    const float* bl = bias + static_cast<size_t>(l) * H;
    const float inv = inv_scales[l];
    for (int n0 = 0; n0 < H; n0 += fdn::kBN) {
      fdn::Acc<BM> acc;
      fdn::mma_tile<BM, true, kStages>(acc, nullptr, 0, 0, acts, wl, H, n0, H, nullptr, w_stage);
      fdn::store_acc<BM>(acc, c_tile);
      __syncthreads();
      constexpr int kChunks = fdn::kBN / 16;
      for (int i = threadIdx.x; i < BM * kChunks; i += fdn::kThreads) {
        const int r = i / kChunks, c0 = (i % kChunks) * 16;
        alignas(16) int8_t v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int n = n0 + c0 + j;
          v[j] = fdn::quantized_sigmoid_shifted(
              fdn::dequantize(c_tile[r * fdn::kLdc + c0 + j], cs[n], inv, bl[n]));
        }
        *reinterpret_cast<int4*>(out + static_cast<size_t>(m0 + r) * H + n0 + c0) =
            *reinterpret_cast<const int4*>(v);
      }
      __syncthreads();
    }
    // every product of layer l is done and its output is visible to the
    // block (the __syncthreads above): reload it as layer l + 1's input
    if (l + 1 < L) {
      load_rows(acts, out, m0, H);
      __syncthreads();
    }
  }
}

}  // namespace

// Requires B % 64 == 0, H % 128 == 0 and fdn_hidden_stack_smem_bytes(H) within
// the block limit (checked by the wrapper).  `out` must not alias `x`.
extern "C" int fdn_hidden_stack(const void* x, const void* wt, const void* colsum,
                                const void* inv_scales, const void* bias, void* out, int b, int h,
                                int l, int device, void* stream) {
  const size_t bytes = smem_bytes(h);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fdn::allow_smem(hidden_stack_kernel, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  hidden_stack_kernel<<<b / BM, fdn::kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<const int*>(colsum), static_cast<const float*>(inv_scales),
      static_cast<const float*>(bias), static_cast<int8_t*>(out), h, l);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long fdn_hidden_stack_smem_bytes(int h) {
  return static_cast<long long>(smem_bytes(h));
}
