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
// csrc/hopper.cuh's warp-specialised shape: a block owns 64 frames and a
// range of 128-column tiles; a producer warp streams 128 x 128-byte weight
// stages by TMA through an mbarrier ring, its two consumer warpgroups take
// the tiles in turn (wgmma m64n128k32 s8, one's epilogue beside the other's
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
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

constexpr int kStages = 8;

constexpr size_t kSmemBytes = hp::kAlign +
                              static_cast<size_t>(kStages) * (hp::kStageBytes + hp::kActBlockBytes) +
                              hp::Ring<kStages, 1>::kBytes + fdn::kSigmoidTableBytes;

// Block b is frame block b % frame_blocks of column split b / frame_blocks;
// a cluster's blocks are consecutive frame blocks of one split.  The split
// takes tiles [split * tiles / splits, (split + 1) * tiles / splits).  The
// weight map views Wt as [N, K], the activation map x as [B, K].
template <int CS>
__global__ void __launch_bounds__(hp::kThreads, 1)
    hidden_layer_kernel(const __grid_constant__ CUtensorMap w_map,
                        const __grid_constant__ CUtensorMap x_map,
                        const int* __restrict__ colsum, const float* __restrict__ bias,
                        float inv_scale, int8_t* __restrict__ out, int K, int N,
                        int frame_blocks, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hp::align_smem(smem_raw);
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  int8_t* acts = stages + kStages * hp::kStageBytes;  // one activation tile per stage
  hp::Ring<kStages, CS> ring{reinterpret_cast<uint64_t*>(acts + kStages * hp::kActBlockBytes)};
  int8_t* table = reinterpret_cast<int8_t*>(ring.bars) + hp::Ring<kStages, CS>::kBytes;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x % frame_blocks * hp::kFrames;
  const int split = blockIdx.x / frame_blocks;
  const int tiles = N / hp::kTileN;
  const int first_tile = split * tiles / splits;
  const int my_tiles = (split + 1) * tiles / splits - first_tile;
  const int steps = K / hp::kStageK;
  if (threadIdx.x == 0) ring.init();
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      const unsigned rank = hp::cluster_rank();
      for (int g = 0; g < my_tiles; ++g)
        for (int t = 0; t < steps; ++t)
          ring.produce(stages, &w_map, g * steps + t, t * hp::kStageK,
                       (first_tile + g) * hp::kTileN, rank, acts, &x_map, m0);
    }
    hp::cluster_sync();
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    fdn::fill_sigmoid_table(table, threadIdx.x, hp::kConsumerThreads);
    hp::consumer_sync();
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int g = wg, n = 0; g < my_tiles; g += hp::kConsumers, ++n) {
      hp::tile_products<kStages, CS, true>(d, ring, stages, acts, K, g * steps, wg, n, tw);
      hp::layer_epilogue(d, out, N, m0, (first_tile + g) * hp::kTileN, colsum, bias, inv_scale,
                         table, tw);
    }
    hp::cluster_sync();
  }
}

template <int CS>
cudaError_t launch(const void* x, const void* wt, const void* colsum, const void* bias,
                   float inv_scale, void* out, int b, int k, int n, int sms, void* stream) {
  CUtensorMap w_map, x_map;
  cudaError_t err = hp::weight_map(&w_map, wt, n, k, hp::kTileN / CS);
  if (err == cudaSuccess) err = hp::weight_map(&x_map, x, b, k, hp::kFrames);
  if (err != cudaSuccess) return err;
  const int frame_blocks = b / hp::kFrames;
  const int tiles = n / hp::kTileN;
  const int splits = frame_blocks >= sms ? 1 : std::min(tiles, sms / frame_blocks);
  return hp::launch_clustered(hidden_layer_kernel<CS>, frame_blocks * splits, CS, kSmemBytes,
                              stream, w_map, x_map, static_cast<const int*>(colsum),
                              static_cast<const float*>(bias), inv_scale,
                              static_cast<int8_t*>(out), k, n, frame_blocks, splits);
}

}  // namespace

// Requires B % (64 * cluster) == 0 (cluster 1 or 2), K % 128 == 0,
// N % 128 == 0, 16-byte aligned x and wt, and fdn_hidden_layer_smem_bytes()
// within the block limit (checked by the wrapper).
extern "C" int fdn_hidden_layer(const void* x, const void* wt, const void* colsum,
                                const void* bias, float inv_scale, void* out, int b, int k, int n,
                                int cluster, int device, void* stream) {
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cluster) {
    case 1: return launch<1>(x, wt, colsum, bias, inv_scale, out, b, k, n, sms, stream);
    case 2: return launch<2>(x, wt, colsum, bias, inv_scale, out, b, k, n, sms, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long fdn_hidden_layer_smem_bytes() { return static_cast<long long>(kSmemBytes); }
