// K10: one low-rank hidden layer, the restructured layer of Xue, Li and Gong
// (Interspeech 2013), s8[B, K] -> shifted s8[B, N] in one launch:
//
//   z   = f32(h @ P + colsum128) * p_inv           P s8[K, k], the bottleneck
//   s   = max|z| / 127 per frame                   (an all-zero row: s = 0)
//   q   = clip(round_half_away(z / s), -127, 127)  signed codes, no zero point
//   out = sigmoid(f32(f32(q @ E) * f32(s * e_inv)) + bias)   E s8[k, N]
//
// both factors transposed as every weight (Pt s8[k, K], Et s8[N, k];
// ops/kernels.py:kernel_layout), the quantized contract of
// quant/quantize.py, bitwise its plain version (ops/matmul.py:
// lowrank_layer_step).  And its first half alone for an output layer,
// lowrank_bottleneck: the codes s8[B, k] and each frame's scale s * e_inv
// f32[B], which the output kernels (K4, lazy_output) take as a per-row
// scale.
//
// Replaces no TPU kernel: fastdnn_tpu/ops/pallas_kernels.py has no
// low-rank layer.  The second product ends in the epilogue of its hidden
// layer (fused_hidden_layer, :180-208: + bias, then the quantized sigmoid).
//
// Bound: at B = 8192, K = N = 2048, k = 256 the layer is 17.2 G int8 ops
// (0.0087 ms at 1979 TOP/s) against 1 MB of weights and 33.6 MB of frames
// in and out (0.010 ms at 3.35 TB/s): a quarter of the dense layer's
// products, and a short K (256) in the second product, whose epilogue (the
// dequantization and the sigmoid table over 16.8 M outputs) is as long as
// its products.
//
// Design: K2's loop (csrc/hopper.cuh, streamed_layer_kernel), two products
// deep.  A block owns 64 frames; a cluster of 2 blocks shares each weight
// stage by multicast, so the pair owns a 128-frame tile and L2 serves each
// stage once for it; a producer warp keeps K2's ring of 8 stages full across
// both products.  The first product's k / 128 column tiles (k <= 256) go one
// to each consumer warpgroup, with the frames' activations streamed beside
// the weight stages; each warpgroup dequantizes its 64 x 128 tile of z in
// registers, and the two trade their rows' max |z| through shared memory.
// Each then writes its codes into its 128-byte-wide block of a [64 x k]
// swizzled A operand in shared memory (the bottleneck writes them to device
// memory instead), and the second product runs on it as K3's resident
// activations do: its N / 128 tiles taken in turn, one warpgroup's epilogue
// (K2's, with each row's scale in place of the layer's) beside the other's
// products.  The ring's stage and tile counts run on across the two
// products, so its loads never drain between them.  128 blocks at B = 8192
// on the H100's 132 SMs, where a 128-frame block would seat 64.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

// K2's ring: 8 stages of a 16 KB weight slice and an 8 KB activation tile
constexpr int kStages = 8;
// the rank a block holds: one 128-column tile of z per consumer warpgroup
constexpr int kMaxRankTiles = hp::kConsumers;
constexpr float kCodeMax = 127.0f;

// the block's shared memory past the ring and the codes
struct Side {
  float part_max[hp::kConsumers][hp::kFrames];  // each warpgroup's rows' max |z| over its tile
  float scale[hp::kFrames];                      // each row's s * e_inv
  int8_t table[fdn::kSigmoidTableBytes];
};

__host__ __device__ constexpr size_t smem_bytes() {
  return hp::kAlign + static_cast<size_t>(kStages) * (hp::kStageBytes + hp::kActBlockBytes) +
         kMaxRankTiles * hp::kActBlockBytes + hp::Ring<kStages, 1>::kBytes + sizeof(Side);
}
static_assert(smem_bytes() <= 232448, "fits the H100's block");

// a value of z -> its code under the row's s (0 when s is 0), rounding half
// away from zero as the sigmoid's step does (common.cuh: sigmoid_step)
__device__ __forceinline__ int8_t code_of(float z, float s) {
  if (!(s > 0.0f)) return 0;
  const float x = __fdiv_rn(z, s);
  const float k = truncf(__fadd_rn(x, copysignf(0.5f, x)));
  return static_cast<int8_t>(fminf(fmaxf(k, -kCodeMax), kCodeMax));
}

// One consumer warpgroup's tile of the second product: int8 columns
// [n0, n0 + 128) of the block's 64 rows of `out` (row stride ld), K2's
// epilogue (hopper.cuh: layer_epilogue) with each row's scale in place of
// the layer's and no zero-point sum (the codes have none).
__device__ __forceinline__ void expand_epilogue(const int (&d)[64], int8_t* out, int ld, int m0,
                                                int n0, const float* bias, const float* scale,
                                                const int8_t* table, int thread_in_wg) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int row = warp * 16 + lane / 4;
  const int col = n0 + 2 * (lane % 4);
  const float s0 = scale[row], s1 = scale[row + 8];
  int8_t* o = out + static_cast<size_t>(m0 + row) * ld + col;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int n = col + 8 * q;
    const float2 b = *reinterpret_cast<const float2*>(bias + n);
    char2 top, bottom;  // rows row and row + 8
    top.x = fdn::sigmoid_from_table(table, fdn::dequantize(d[4 * q], 0, s0, b.x));
    top.y = fdn::sigmoid_from_table(table, fdn::dequantize(d[4 * q + 1], 0, s0, b.y));
    bottom.x = fdn::sigmoid_from_table(table, fdn::dequantize(d[4 * q + 2], 0, s1, b.x));
    bottom.y = fdn::sigmoid_from_table(table, fdn::dequantize(d[4 * q + 3], 0, s1, b.y));
    *reinterpret_cast<char2*>(o + 8 * q) = top;
    *reinterpret_cast<char2*>(o + 8 * static_cast<size_t>(ld) + 8 * q) = bottom;
  }
}

// The body of both kernels.  HIDDEN: both products, out s8[B, N]; else the
// first product alone, out the codes s8[B, k] and scale_out f32[B].
template <int CS, bool HIDDEN>
__device__ __forceinline__ void lowrank_body(unsigned char* smem, const CUtensorMap* p_map,
                                             const CUtensorMap* x_map, const CUtensorMap* e_map,
                                             const int* p_colsum, float p_inv, float e_inv,
                                             const float* bias, int8_t* out, float* scale_out,
                                             int K, int rank, int N) {
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  int8_t* acts = stages + kStages * hp::kStageBytes;  // one activation tile per stage
  int8_t* codes = acts + kStages * hp::kActBlockBytes;  // the second product's A operand
  hp::Ring<kStages, CS> ring{
      reinterpret_cast<uint64_t*>(codes + kMaxRankTiles * hp::kActBlockBytes)};
  Side* side = reinterpret_cast<Side*>(reinterpret_cast<unsigned char*>(ring.bars) +
                                       hp::Ring<kStages, CS>::kBytes);

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x * hp::kFrames;
  const int steps1 = K / hp::kStageK;
  const int tiles1 = rank / hp::kTileN;  // z's column tiles, tile g to warpgroup g
  const int steps2 = rank / hp::kStageK;
  const int tiles2 = HIDDEN ? N / hp::kTileN : 0;
  const int base2 = tiles1 * steps1;  // the second product's first stage
  if (threadIdx.x == 0) ring.init();
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      const unsigned crank = hp::cluster_rank();
      for (int g = 0; g < tiles1; ++g)
        for (int t = 0; t < steps1; ++t)
          ring.produce(stages, p_map, g * steps1 + t, t * hp::kStageK, g * hp::kTileN, crank, acts,
                       x_map, m0);
      for (int j = 0; j < tiles2; ++j)
        for (int t = 0; t < steps2; ++t)
          ring.produce(stages, e_map, base2 + j * steps2 + t, t * hp::kStageK, j * hp::kTileN,
                       crank);
    }
    hp::cluster_sync();
    return;
  }

  hp::reg_alloc<hp::kConsumerRegs>();
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  const int row = warp * 16 + lane / 4;  // the thread's rows row and row + 8 of the block
  const int col = 2 * (lane % 4);        // and columns col + 8 q + {0, 1} of a tile
  if constexpr (HIDDEN) fdn::fill_sigmoid_table(side->table, threadIdx.x, hp::kConsumerThreads);

  // the first product: warpgroup wg's tile of z, columns [128 wg, 128 wg + 128)
  float z[64];
  float amax[2] = {0.0f, 0.0f};
  if (wg < tiles1) {
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    hp::tile_products<kStages, CS, true>(d, ring, stages, acts, K, wg * steps1, wg, 0, tw);
    const int* cs = p_colsum + wg * hp::kTileN + col;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int2 c = *reinterpret_cast<const int2*>(cs + 8 * q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        z[4 * q + e] = __fmul_rn(__int2float_rn(d[4 * q + e] + (e % 2 ? c.y : c.x)), p_inv);
        amax[e / 2] = fmaxf(amax[e / 2], fabsf(z[4 * q + e]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // a row's columns of the tile sit in the 4 lanes of a quad
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 1));
      amax[h] = fmaxf(amax[h], __shfl_xor_sync(0xffffffffu, amax[h], 2));
    }
  }
  if (lane % 4 == 0) {  // a warpgroup without a tile offers 0
    side->part_max[wg][row] = amax[0];
    side->part_max[wg][row + 8] = amax[1];
  }
  hp::consumer_sync();
  if (wg < tiles1) {
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      s[h] = __fdiv_rn(fmaxf(side->part_max[0][row + 8 * h], side->part_max[1][row + 8 * h]),
                       kCodeMax);
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const char2 c =
            make_char2(code_of(z[4 * q + 2 * h], s[h]), code_of(z[4 * q + 2 * h + 1], s[h]));
        const int r = row + 8 * h, byte = col + 8 * q;
        if constexpr (HIDDEN) {
          *reinterpret_cast<char2*>(codes + wg * hp::kActBlockBytes + hp::swizzle128(r, byte >> 4) +
                                    (byte & 15)) = c;
        } else {
          *reinterpret_cast<char2*>(out + static_cast<size_t>(m0 + r) * rank + wg * hp::kTileN +
                                    byte) = c;
        }
      }
    if (wg == 0 && lane % 4 == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float scale = __fmul_rn(s[h], e_inv);
        if constexpr (HIDDEN) side->scale[row + 8 * h] = scale;
        else scale_out[m0 + row + 8 * h] = scale;
      }
    }
  }

  if constexpr (HIDDEN) {
    hp::fence_proxy_async();  // the codes, for wgmma
    hp::consumer_sync();      // every code and scale is in place
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    // tile g of the launch (the first product's were 0 .. tiles1 - 1) is
    // warpgroup g % 2's (g / 2)-th
    for (int j = 0; j < tiles2; ++j) {
      const int g = tiles1 + j;
      if (g % hp::kConsumers != wg) continue;
      hp::tile_products<kStages, CS, false>(d, ring, stages, codes, rank, base2 + j * steps2, wg,
                                            g / hp::kConsumers, tw);
      expand_epilogue(d, out, N, m0, j * hp::kTileN, bias, side->scale, side->table, tw);
    }
  }
  hp::cluster_sync();
}

template <int CS>
__global__ void __launch_bounds__(hp::kThreads, 1)
    lowrank_layer_kernel(const __grid_constant__ CUtensorMap p_map,
                         const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap e_map,
                         const int* __restrict__ p_colsum,
                         float p_inv, float e_inv, const float* __restrict__ bias,
                         int8_t* __restrict__ out, int K, int rank, int N) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  lowrank_body<CS, true>(hp::align_smem(smem_raw), &p_map, &x_map, &e_map, p_colsum, p_inv, e_inv,
                         bias, out, nullptr, K, rank, N);
}

template <int CS>
__global__ void __launch_bounds__(hp::kThreads, 1)
    lowrank_bottleneck_kernel(const __grid_constant__ CUtensorMap p_map,
                              const __grid_constant__ CUtensorMap x_map,
                              const int* __restrict__ p_colsum, float p_inv, float e_inv,
                              int8_t* __restrict__ codes, float* __restrict__ scale, int K,
                              int rank) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  lowrank_body<CS, false>(hp::align_smem(smem_raw), &p_map, &x_map, nullptr, p_colsum, p_inv,
                          e_inv, nullptr, codes, scale, K, rank, 0);
}

template <int CS>
cudaError_t launch(const void* x, const void* p_t, const void* p_colsum, float p_inv,
                   const void* e_t, float e_inv, const void* bias, void* out, void* scale, int b,
                   int k, int rank, int n, void* stream) {
  CUtensorMap p_map, x_map, e_map;
  cudaError_t err = hp::weight_map(&p_map, p_t, rank, k, hp::kTileN / CS);
  if (err == cudaSuccess) err = hp::weight_map(&x_map, x, b, k, hp::kFrames);
  if (err == cudaSuccess && e_t != nullptr)
    err = hp::weight_map(&e_map, e_t, n, rank, hp::kTileN / CS);
  if (err != cudaSuccess) return err;
  const int blocks = b / hp::kFrames;
  if (e_t != nullptr)
    return hp::launch_clustered(lowrank_layer_kernel<CS>, blocks, CS, smem_bytes(), stream, p_map,
                                x_map, e_map, static_cast<const int*>(p_colsum), p_inv, e_inv,
                                static_cast<const float*>(bias), static_cast<int8_t*>(out), k,
                                rank, n);
  return hp::launch_clustered(lowrank_bottleneck_kernel<CS>, blocks, CS, smem_bytes(), stream,
                              p_map, x_map, static_cast<const int*>(p_colsum), p_inv, e_inv,
                              static_cast<int8_t*>(out), static_cast<float*>(scale), k, rank);
}

int dispatch(const void* x, const void* p_t, const void* p_colsum, float p_inv, const void* e_t,
             float e_inv, const void* bias, void* out, void* scale, int b, int k, int rank, int n,
             int cluster, int device, void* stream) {
  if (rank <= 0 || rank > kMaxRankTiles * hp::kTileN || rank % hp::kTileN)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cluster) {
    case 1:
      return static_cast<int>(launch<1>(x, p_t, p_colsum, p_inv, e_t, e_inv, bias, out, scale, b,
                                        k, rank, n, stream));
    case 2:
      return static_cast<int>(launch<2>(x, p_t, p_colsum, p_inv, e_t, e_inv, bias, out, scale, b,
                                        k, rank, n, stream));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// K10.  Requires B % (64 * cluster) == 0 (cluster 1 or 2), K % 128 == 0,
// rank 128 or 256, N % 128 == 0, 16-byte aligned x, p_t and e_t, and
// fdn_lowrank_smem_bytes() within the block limit (checked by the wrapper).
extern "C" int fdn_lowrank_layer(const void* x, const void* p_t, const void* p_colsum,
                                 float p_inv, const void* e_t, float e_inv, const void* bias,
                                 void* out, int b, int k, int rank, int n, int cluster, int device,
                                 void* stream) {
  if (e_t == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(x, p_t, p_colsum, p_inv, e_t, e_inv, bias, out, nullptr, b, k, rank, n, cluster,
                  device, stream);
}

// The bottleneck of a low-rank output layer: codes s8[B, rank] and scale
// f32[B]; K10's requirements.
extern "C" int fdn_lowrank_bottleneck(const void* x, const void* p_t, const void* p_colsum,
                                      float p_inv, float e_inv, void* codes, void* scale, int b,
                                      int k, int rank, int cluster, int device, void* stream) {
  return dispatch(x, p_t, p_colsum, p_inv, nullptr, e_inv, nullptr, codes, scale, b, k, rank, 0,
                  cluster, device, stream);
}

extern "C" long long fdn_lowrank_smem_bytes() { return static_cast<long long>(smem_bytes()); }
