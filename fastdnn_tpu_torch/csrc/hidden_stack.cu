// K3: all L equal-width hidden layers in one launch, s8[B, H] -> s8[B, H]
// (weights transposed per layer, Wt s8[L, H, H]; ops/kernels.py:kernel_layout).
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:fused_hidden_stack ->
// _stack_kernel_factory (:211-318).  On the TPU a sequential grid axis over
// layers carried the activations in a VMEM scratch; blocks here run in
// parallel and in no order, so the layer axis becomes a loop inside the block:
// each block owns 64 frames, keeps their activations in shared memory
// (64 * H bytes = 128 KB at H = 2048) and walks layer after layer, 128 output
// columns at a time.  A layer's output goes to the block's own rows of `out`
// (they stay in L2) and is read back into shared memory before the next
// layer; after the last layer it is already in place.  No other block touches
// those rows, so no grid-wide sync is needed.
//
// Bound: 6 layers at B = 8192, H = 2048 are 412 G int8 ops (0.208 ms at the
// H100's 1979 TOP/s); the bytes in and out are 59 MB (0.018 ms).  What bounds
// a block in practice is the rate the weight bytes reach its SM: every block
// needs the whole 25 MB weight stack from L2 (it fits in the 50 MB L2).
//
// The loop, on csrc/hopper.cuh's warp-specialised shape.  A producer warp
// streams the weight stages by TMA through an mbarrier ring that never
// drains, running ahead across tiles and into the next layer's weights,
// which do not depend on the activations; only the consumers wait for the
// activation reload at a layer boundary.  Each stage is released with one
// block-scope arrival (a cluster-scope release per stage cost about 40% of
// the loop; PERF.md).  Blocks of 64 frames run in clusters of 2 (1 for an
// odd number of blocks) sharing each stage by multicast, so L2 serves each
// stage once per pair of SMs.  The two consumer warpgroups take the tiles in
// turn, one's epilogue beside the other's products.  The quantized sigmoid
// goes through a per-block table of its 1283 distinct steps (common.cuh:
// sigmoid_from_table): with the accurate tanhf per value, the epilogue of a
// warpgroup's 8192 values outlasted the other warpgroup's products.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

// five stages keep the widest H that fits at 2304
constexpr int kWgStages = 5;

__host__ __device__ constexpr size_t wgmma_smem_bytes(int h) {
  return hp::kAlign + static_cast<size_t>(hp::kFrames) * h + kWgStages * hp::kStageBytes +
         hp::Ring<kWgStages, 1>::kBytes + fdn::kSigmoidTableBytes;
}

// Tiles are numbered over the whole stack: tile g is layer g / tiles,
// columns (g % tiles) * 128; consumer warpgroup w takes g = w, w + 2, ...
// The weight map views Wt as [L * H, H].
template <int CS>
__global__ void __launch_bounds__(hp::kThreads, 1)
    hidden_stack_wgmma_kernel(const __grid_constant__ CUtensorMap w_map,
                              const int8_t* __restrict__ x, const int* __restrict__ colsum,
                              const float* __restrict__ inv_scales,
                              const float* __restrict__ bias, int8_t* out, int H, int L) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hp::align_smem(smem_raw);
  int8_t* acts = reinterpret_cast<int8_t*>(smem);
  int8_t* stages = acts + hp::kFrames * H;
  hp::Ring<kWgStages, CS> ring{
      reinterpret_cast<uint64_t*>(stages + kWgStages * hp::kStageBytes)};
  int8_t* table = stages + kWgStages * hp::kStageBytes + hp::Ring<kWgStages, CS>::kBytes;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * hp::kFrames;
  const int tiles = H / hp::kTileN;
  const int steps = H / hp::kStageK;
  if (threadIdx.x == 0) ring.init();
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      const unsigned rank = hp::cluster_rank();
      for (int g = 0; g < L * tiles; ++g)
        for (int t = 0; t < steps; ++t)
          ring.produce(stages, &w_map, g * steps + t, t * hp::kStageK,
                       (g / tiles) * H + (g % tiles) * hp::kTileN, rank);
    }
    hp::cluster_sync();
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    const int tid = threadIdx.x;
    const int tw = tid % 128;
    hp::load_frames(acts, x, m0, H, tid, hp::kConsumerThreads);
    fdn::fill_sigmoid_table(table, tid, hp::kConsumerThreads);
    hp::fence_proxy_async();
    hp::consumer_sync();
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    // a layer boundary: both consumer warpgroups have stored their tiles of
    // the layer (and their products, which read `acts`, are complete), so
    // the layer's output replaces the activations
    int layer = 0;
    auto next_layer = [&] {
      __threadfence_block();
      hp::consumer_sync();
      hp::load_frames(acts, out, m0, H, tid, hp::kConsumerThreads);
      hp::fence_proxy_async();
      hp::consumer_sync();
      ++layer;
    };
    for (int g = wg, n = 0; g < L * tiles; g += hp::kConsumers, ++n) {
      const int l = g / tiles;
      while (layer < l) next_layer();
      hp::tile_products(d, ring, stages, acts, H, g * steps, wg, n, tw);
      hp::layer_epilogue(d, out, H, m0, (g % tiles) * hp::kTileN,
                         colsum + static_cast<size_t>(l) * H, bias + static_cast<size_t>(l) * H,
                         inv_scales[l], table, tw);
    }
    while (layer < L - 1) next_layer();  // the boundaries after this warpgroup's last tile
    hp::cluster_sync();
  }
}

template <int CS>
int launch_wgmma(const void* x, const void* wt, const void* colsum, const void* inv_scales,
                 const void* bias, void* out, int b, int h, int l, void* stream) {
  CUtensorMap map;
  cudaError_t err = hp::weight_map(&map, wt, static_cast<uint64_t>(l) * h, h, hp::kTileN / CS);
  if (err == cudaSuccess)
    err = hp::launch_clustered(hidden_stack_wgmma_kernel<CS>, b / hp::kFrames, CS,
                               wgmma_smem_bytes(h), stream, map, static_cast<const int8_t*>(x),
                               static_cast<const int*>(colsum),
                               static_cast<const float*>(inv_scales),
                               static_cast<const float*>(bias), static_cast<int8_t*>(out), h, l);
  return static_cast<int>(err);
}

}  // namespace

// K3 in clusters of `cluster` (1 or 2) blocks along frames
// sharing weight stages by multicast.  Requires B % (64 * cluster) == 0,
// H % 128 == 0, a 16-byte aligned wt and fdn_hidden_stack_wgmma_smem_bytes(H)
// within the block limit (checked by the wrapper).  `out` must not alias `x`.
extern "C" int fdn_hidden_stack_wgmma(const void* x, const void* wt, const void* colsum,
                                      const void* inv_scales, const void* bias, void* out, int b,
                                      int h, int l, int cluster, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cluster) {
    case 1: return launch_wgmma<1>(x, wt, colsum, inv_scales, bias, out, b, h, l, stream);
    case 2: return launch_wgmma<2>(x, wt, colsum, inv_scales, bias, out, b, h, l, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long fdn_hidden_stack_wgmma_smem_bytes(int h) {
  return static_cast<long long>(wgmma_smem_bytes(h));
}

// Clusters of `cluster` blocks of the wgmma loop at width h that the card
// seats at once (-1 if it cannot tell).
extern "C" int fdn_hidden_stack_wgmma_max_clusters(int h, int cluster, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const size_t bytes = wgmma_smem_bytes(h);
  switch (cluster) {
    case 1: return hp::max_active_clusters(hidden_stack_wgmma_kernel<1>, 1, bytes);
    case 2: return hp::max_active_clusters(hidden_stack_wgmma_kernel<2>, 2, bytes);
    default: return -1;
  }
}
