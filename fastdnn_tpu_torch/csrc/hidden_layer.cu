// K2: one quantized hidden layer, s8[B, K] x s8[K, N] -> shifted s8[B, N]
// (the weight arrives transposed, Wt s8[N, K]; ops/kernels.py:kernel_layout).
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:fused_hidden_layer -> _layer_call
// with _hidden_kernel (:81-84, :130-208): exact int32 product, + colsum128,
// x inv_scale, + bias, then the K1 sigmoid, all before anything leaves the
// block, so device memory sees int8 in, int8 weights, int8 out.
//
// Bound: at the main path's shape (B = 8320, K = N = 2048) the layer is 70 G
// int8 ops (0.035 ms at 1979 TOP/s) against ~21 MB of device-memory traffic.
// The TPU grid ran frames fastest so one VMEM weight block served every frame
// block; here blocks run in parallel, and what bounds them is the rate at
// which stages reach each SM from L2 (as for K3, PERF.md).
//
// K3's loop (csrc/hidden_stack.cu) for one layer of any K x N, on
// csrc/hopper.cuh's warp-specialised shape (streamed_layer_kernel, which K5
// shares with an f32 epilogue): a block owns 64 frames and a range of
// 128-column tiles; a producer warp streams 128 x 128-byte weight stages by
// TMA through an mbarrier ring, its two consumer warpgroups take the tiles
// in turn (wgmma m64n128k32 s8, one's epilogue beside the other's
// products), and blocks in clusters of 2 along frames share each weight
// stage by multicast.  The quantized sigmoid goes through the block's table
// (common.cuh: sigmoid_from_table).  Unlike K3, the block's activations do
// not sit in shared memory: a 64 x 128-byte tile of them comes with each
// weight stage, through the same ring and barrier, so K has no limit and the
// ring holds 8 stages of 24 KB.  On the H100 this was faster at every B than
// holding the [64 x K] activations beside a 5-stage ring (PERF.md), though
// it reads them from L2 once per tile.  When the frame blocks are fewer than
// the SMs, the column tiles split over floor(SMs / frame blocks) blocks per
// frame block (no split at B = 8320: 130 blocks; 8 at B = 1024).
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

// the quantized sigmoid of each dequantized value, through the block's table
struct SigmoidEpilogue {
  using Out = int8_t;
  static constexpr size_t kSmemBytes = fdn::kSigmoidTableBytes;
  static __device__ __forceinline__ void prepare(unsigned char* table, int tid, int count) {
    fdn::fill_sigmoid_table(reinterpret_cast<int8_t*>(table), tid, count);
  }
  static __device__ __forceinline__ void store(const int (&d)[64], int8_t* out, int ld, int m0,
                                               int n0, const int* cs, const float* bl, float inv,
                                               const unsigned char* table, int thread_in_wg) {
    hp::layer_epilogue(d, out, ld, m0, n0, cs, bl, inv, reinterpret_cast<const int8_t*>(table),
                       thread_in_wg);
  }
};

}  // namespace

// Requires B % (64 * cluster) == 0 (cluster 1 or 2), K % 128 == 0,
// N % 128 == 0, 16-byte aligned x and wt, and fdn_hidden_layer_smem_bytes()
// within the block limit (checked by the wrapper).
extern "C" int fdn_hidden_layer(const void* x, const void* wt, const void* colsum,
                                const void* bias, float inv_scale, void* out, int b, int k, int n,
                                int cluster, int device, void* stream) {
  return static_cast<int>(hp::streamed_layer<SigmoidEpilogue>(x, wt, colsum, bias, inv_scale, out,
                                                              b, k, n, cluster, device, stream));
}

extern "C" long long fdn_hidden_layer_smem_bytes() {
  return static_cast<long long>(hp::streamed_layer_smem_bytes<SigmoidEpilogue>());
}
