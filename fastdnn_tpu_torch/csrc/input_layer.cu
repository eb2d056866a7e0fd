// K9: the float input layer in one launch,
// out[b, n] = quantized_sigmoid_shifted(f32(frames[b] . W[:, n]) + bias[n]),
// frames f32 [B, K], W f32 [K, H] -> shifted s8 [B, H].
//
// Replaces the input layer the JAX package leaves to XLA, the f32 product of
// fastdnn_tpu/ops/matmul.py:input_layer_step (:39-52), fused with its
// quantized-sigmoid epilogue, fastdnn_tpu/ops/pallas_kernels.py:
// _quantized_sigmoid_shifted (:50-78; K1 as a kernel of its own).  Nothing of
// the f32 product reaches device memory: frames in, s8 out.
//
// Bound: at B = 8192, K = 432, H = 2048 the three TF32 products below are
// 43.5 G operations (0.088 ms at the H100's 494.7 TFLOP/s), against 38 MB of
// device-memory traffic (0.011 ms).  Per SM, what also counts is the rate at
// which stages reach it from L2 (PERF.md: ~40 GB/s in the wgmma loops), so a
// block takes 128 frames: both consumer warpgroups read each weight stage,
// which halves the weight bytes per frame against 64-frame blocks.
//
// Precision: f32 operands on TF32 tensor cores, as 3xTF32.  The weight is
// split once, on the host side (ops/kernels.py:input_layer_operand), into
// W_hi = tf32(W) and W_lo = tf32(W - W_hi), both K-major [H, K]; each
// consumer splits its frames the same way (cvt.rna.tf32.f32) and issues
// a_lo W_hi and a_hi W_lo, then a_hi W_hi (wgmma m64n128k8, A from
// registers); the a_lo W_lo term (~2^-22 relative) is dropped.  The tensor
// core's f32 accumulation is not IEEE (earlier tensor cores were measured to
// truncate at every product group), a drift that would grow with the 162
// products of each output (K = 432), so the products of each 32-deep stage
// go into a fresh accumulator that is then added to a running f32 sum with
// one IEEE rounding.  The gate: <= 1 count
// on at most 1e-4 of the entries against the f64 product rounded once to
// f32 (chip_smoke.py phase 4).
//
// Shape: csrc/hopper.cuh's three warpgroups.  A block owns 128 frames and a
// range of 128-column tiles (split over floor(SMs / frame blocks) blocks
// when there are fewer frame blocks than SMs); the producer warp keeps a
// ring of 48 KB stages full by TMA (128-byte swizzle, boxes of 128 rows x 32
// f32: the block's frames, W_hi and W_lo for one 32-deep slice of K; the
// tensor maps' K extent zero-fills the last slice), and warpgroup w takes
// frames [64 w, 64 w + 64) of every stage.  The epilogue adds the bias, looks
// the sigmoid up in the block's table and stores 16-byte rows through a
// shared-memory tile.
//
// The 1-pass bf16 variant (input_layer_bf16_kernel, input precision
// "default"): both operands rounded to the nearest bf16 (ties to even), the
// products accumulated in f32.  The weight is rounded once, on the host side
// (ops/kernels.py:input_layer_operand(w, "default"): bf16 [H, K16], K-major,
// K zero-padded to a multiple of 16); the frames arrive as f32 through TMA
// and each consumer rounds them in registers (cvt.rn.bf16x2.f32) into
// wgmma m64n128k16's A fragments.  A stage is one 64-deep slice of K: two
// f32 boxes of frames (32 each) and one box of the operand (64 bf16 per
// 128-byte row), the same 48 KB as K9's; each stage's four products go into
// a fresh accumulator that is added to the running f32 sum, as in K9.  A
// product of two bf16 is exact in f32, so against its plain version
// (ops/matmul.py:input_layer_step(..., "default"), the f64 product of the
// rounded operands rounded once) it differs only by summation order.
// Bound: at B = 8192, K = 432, H = 2048 its products are 14.5 G bf16
// operations (0.0147 ms at the H100's 989.4 TFLOP/s) against 32.8 MB of
// device-memory traffic (0.0098 ms).
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

constexpr int kRows = hp::kConsumers * hp::kFrames;  // frames per block
constexpr int kSliceK = 32;                          // f32 per 128-byte row
constexpr int kBoxBytes = 128 * 128;                 // 128 rows x 128 bytes
constexpr int kStageBytes = 3 * kBoxBytes;           // frames, W_hi, W_lo
constexpr int kStages = 4;
constexpr int kOutTileBytes = kRows * hp::kTileN;
constexpr int kOutBarrier = 2;  // named barriers 2 and 3: one per consumer warpgroup

constexpr size_t kSmemBytes = hp::kAlign + static_cast<size_t>(kStages) * kStageBytes +
                              kOutTileBytes + 2 * kStages * sizeof(uint64_t) +
                              fdn::kSigmoidTableBytes;

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(kOutBarrier + wg) : "memory");
}

// warpgroup wg's A fragments of a stage's frame box for its four 8-deep
// steps, split into TF32 halves (wgmma_tf32's layout)
__device__ __forceinline__ void load_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                           const unsigned char* frames, int wg, int thread_in_wg) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int r = 64 * wg + 16 * warp + lane / 4;  // r % 8 == lane / 4
  const unsigned char* top = frames + r * 128 + (lane % 4) * 4;
  const unsigned char* bottom = top + 8 * 128;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int c0 = ((2 * ks) ^ (lane / 4)) << 4, c1 = ((2 * ks + 1) ^ (lane / 4)) << 4;
    const float v[4] = {*reinterpret_cast<const float*>(top + c0),
                        *reinterpret_cast<const float*>(bottom + c0),
                        *reinterpret_cast<const float*>(top + c1),
                        *reinterpret_cast<const float*>(bottom + c1)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[ks][e] = hp::tf32_rna(v[e]);
      lo[ks][e] = hp::tf32_rna(__fsub_rn(v[e], __uint_as_float(hi[ks][e])));
    }
  }
}

// warpgroup wg's 64 rows of a tile: sum + bias -> the sigmoid through the
// table -> the block's [128 x 128] s8 out tile (16-byte chunks swizzled by
// row) -> 16-byte stores of the rows below B
__device__ __forceinline__ void store_tile(const float (&sum)[64], const float* __restrict__ bias,
                                           int8_t* tile, const int8_t* table,
                                           int8_t* __restrict__ out, int B, int H, int m0, int n0,
                                           int wg, int thread_in_wg) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int r = 64 * wg + 16 * warp + lane / 4;
  warpgroup_sync(wg);  // the previous tile's rows have left
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int c = 8 * q + 2 * (lane % 4);
    const float2 b = *reinterpret_cast<const float2*>(bias + n0 + c);
    char2 top, bottom;  // rows r and r + 8
    top.x = fdn::sigmoid_from_table(table, __fadd_rn(sum[4 * q], b.x));
    top.y = fdn::sigmoid_from_table(table, __fadd_rn(sum[4 * q + 1], b.y));
    bottom.x = fdn::sigmoid_from_table(table, __fadd_rn(sum[4 * q + 2], b.x));
    bottom.y = fdn::sigmoid_from_table(table, __fadd_rn(sum[4 * q + 3], b.y));
    const int chunk = ((c >> 4) ^ (r & 7)) << 4;  // (r + 8) & 7 == r & 7
    *reinterpret_cast<char2*>(tile + r * 128 + chunk + (c & 15)) = top;
    *reinterpret_cast<char2*>(tile + (r + 8) * 128 + chunk + (c & 15)) = bottom;
  }
  warpgroup_sync(wg);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = thread_in_wg + 128 * j;
    const int row = 64 * wg + i / 8, c = i % 8;
    if (m0 + row < B)
      *reinterpret_cast<int4*>(out + static_cast<size_t>(m0 + row) * H + n0 + 16 * c) =
          *reinterpret_cast<const int4*>(tile + row * 128 + ((c ^ (row & 7)) << 4));
  }
}

// Block b is frame block b % frame_blocks of column split b / frame_blocks;
// the split takes tiles [split * tiles / splits, (split + 1) * tiles /
// splits).  x_map views the frames as f32 [B, K], w_map the operand as f32
// [2 H, K] (W_hi rows, then W_lo rows).
__global__ void __launch_bounds__(hp::kThreads, 1)
    input_layer_kernel(const __grid_constant__ CUtensorMap x_map,
                       const __grid_constant__ CUtensorMap w_map, const float* __restrict__ bias,
                       int8_t* __restrict__ out, int B, int K, int H, int frame_blocks,
                       int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = hp::align_smem(smem_raw);
  int8_t* out_tile = reinterpret_cast<int8_t*>(stages + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tile + kOutTileBytes);
  uint64_t* empty = full + kStages;
  int8_t* table = reinterpret_cast<int8_t*>(empty + kStages);

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x % frame_blocks * kRows;
  const int split = blockIdx.x / frame_blocks;
  const int tiles = H / hp::kTileN;
  const int first_tile = split * tiles / splits;
  const int my_tiles = (split + 1) * tiles / splits - first_tile;
  const int steps = (K + kSliceK - 1) / kSliceK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, hp::kConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      for (int g = 0; g < my_tiles; ++g) {
        const int n0 = (first_tile + g) * hp::kTileN;
        for (int t = 0; t < steps; ++t) {
          const int i = g * steps + t, slot = i % kStages;
          hp::mbar_wait(empty + slot, ((i / kStages) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(full + slot, kStageBytes);
          unsigned char* dst = stages + slot * kStageBytes;
          hp::tma_load(dst, &x_map, full + slot, t * kSliceK, m0);
          hp::tma_load(dst + kBoxBytes, &w_map, full + slot, t * kSliceK, n0);
          hp::tma_load(dst + 2 * kBoxBytes, &w_map, full + slot, t * kSliceK, H + n0);
        }
      }
    }
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    fdn::fill_sigmoid_table(table, threadIdx.x, hp::kConsumerThreads);
    hp::consumer_sync();
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int g = 0; g < my_tiles; ++g) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
      for (int t = 0; t < steps; ++t) {
        const int i = g * steps + t, slot = i % kStages;
        const unsigned char* st = stages + slot * kStageBytes;
        hp::mbar_wait(full + slot, (i / kStages) & 1);
        uint32_t hi[4][4], lo[4][4];
        load_split(hi, lo, st, wg, tw);
        const unsigned char* w_hi = st + kBoxBytes;
        const unsigned char* w_lo = st + 2 * kBoxBytes;
        hp::wgmma_fence();
        // the small terms first, into a fresh accumulator, then the large
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          hp::wgmma_tf32(acc, lo[ks], hp::desc_sw128(w_hi + 32 * ks), ks > 0);
          hp::wgmma_tf32(acc, hi[ks], hp::desc_sw128(w_lo + 32 * ks), true);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) hp::wgmma_tf32(acc, hi[ks], hp::desc_sw128(w_hi + 32 * ks), true);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_acc(acc);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          hp::fence_regs(hi[ks]);
          hp::fence_regs(lo[ks]);
        }
        if (tw == 0) hp::mbar_arrive(empty + slot);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
      store_tile(sum, bias, out_tile, table, out, B, H, m0, (first_tile + g) * hp::kTileN, wg, tw);
    }
  }
}

constexpr int kSliceK16 = 64;  // bf16 per 128-byte row of the operand

// warpgroup wg's A fragments of a stage's two frame boxes for its four
// 16-deep steps, rounded to bf16 (wgmma_bf16's layout); with `second` false
// the second box was not loaded (it lies past K) and its steps read zeros
__device__ __forceinline__ void load_bf16(uint32_t (&a)[4][4], const unsigned char* frames,
                                          bool second, int wg, int thread_in_wg) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int r = 64 * wg + 16 * warp + lane / 4;  // r % 8 == lane / 4
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    if (ks >= 2 && !second) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[ks][e] = 0;
      continue;
    }
    const unsigned char* top = frames + (ks >> 1) * kBoxBytes + r * 128;
    const unsigned char* bottom = top + 8 * 128;
    const int c = 16 * (ks & 1) + 2 * (lane % 4);  // f32 column of the box row
    const int o0 = (((c >> 2) ^ (lane / 4)) << 4) + 4 * (c & 3);        // columns c, c + 1
    const int o1 = ((((c >> 2) + 2) ^ (lane / 4)) << 4) + 4 * (c & 3);  // c + 8, c + 9
    const float2 v0 = *reinterpret_cast<const float2*>(top + o0);
    const float2 v1 = *reinterpret_cast<const float2*>(bottom + o0);
    const float2 v2 = *reinterpret_cast<const float2*>(top + o1);
    const float2 v3 = *reinterpret_cast<const float2*>(bottom + o1);
    a[ks][0] = hp::bf16x2_rn(v0.x, v0.y);
    a[ks][1] = hp::bf16x2_rn(v1.x, v1.y);
    a[ks][2] = hp::bf16x2_rn(v2.x, v2.y);
    a[ks][3] = hp::bf16x2_rn(v3.x, v3.y);
  }
}

// K9's shape with the bf16 stage: x_map views the frames as f32 [B, K],
// w_map the operand as bf16 [H, K16].
__global__ void __launch_bounds__(hp::kThreads, 1)
    input_layer_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                            const __grid_constant__ CUtensorMap w_map,
                            const float* __restrict__ bias, int8_t* __restrict__ out, int B, int K,
                            int H, int frame_blocks, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* stages = hp::align_smem(smem_raw);
  int8_t* out_tile = reinterpret_cast<int8_t*>(stages + kStages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(out_tile + kOutTileBytes);
  uint64_t* empty = full + kStages;
  int8_t* table = reinterpret_cast<int8_t*>(empty + kStages);

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x % frame_blocks * kRows;
  const int split = blockIdx.x / frame_blocks;
  const int tiles = H / hp::kTileN;
  const int first_tile = split * tiles / splits;
  const int my_tiles = (split + 1) * tiles / splits - first_tile;
  const int steps = (K + kSliceK16 - 1) / kSliceK16;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(full + s, 1);
      hp::mbar_init(empty + s, hp::kConsumers);
    }
    hp::fence_barrier_init();
  }
  __syncthreads();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      for (int g = 0; g < my_tiles; ++g) {
        const int n0 = (first_tile + g) * hp::kTileN;
        for (int t = 0; t < steps; ++t) {
          const int i = g * steps + t, slot = i % kStages;
          const int k0 = t * kSliceK16;
          // a box wholly past the frames' K extent is not copied
          const bool second = k0 + kSliceK < K;
          hp::mbar_wait(empty + slot, ((i / kStages) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(full + slot, second ? kStageBytes : kStageBytes - kBoxBytes);
          unsigned char* dst = stages + slot * kStageBytes;
          hp::tma_load(dst + 2 * kBoxBytes, &w_map, full + slot, k0, n0);
          hp::tma_load(dst, &x_map, full + slot, k0, m0);
          if (second) hp::tma_load(dst + kBoxBytes, &x_map, full + slot, k0 + kSliceK, m0);
        }
      }
    }
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    fdn::fill_sigmoid_table(table, threadIdx.x, hp::kConsumerThreads);
    hp::consumer_sync();
    float acc[64], sum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    for (int g = 0; g < my_tiles; ++g) {
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
      for (int t = 0; t < steps; ++t) {
        const int i = g * steps + t, slot = i % kStages;
        const unsigned char* st = stages + slot * kStageBytes;
        hp::mbar_wait(full + slot, (i / kStages) & 1);
        uint32_t a[4][4];
        load_bf16(a, st, t * kSliceK16 + kSliceK < K, wg, tw);
        const unsigned char* w = st + 2 * kBoxBytes;
        hp::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) hp::wgmma_bf16(acc, a[ks], hp::desc_sw128(w + 32 * ks), ks > 0);
        hp::wgmma_commit();
        hp::wgmma_wait<0>();
        hp::fence_acc(acc);
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) hp::fence_regs(a[ks]);
        if (tw == 0) hp::mbar_arrive(empty + slot);
#pragma unroll
        for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
      }
      store_tile(sum, bias, out_tile, table, out, B, H, m0, (first_tile + g) * hp::kTileN, wg, tw);
    }
  }
}

// One launch of either kernel: the frames' map (f32 [b, k], boxes of kRows
// rows) and the operand's ([w_rows, w_cols] of w_type), then the grid.
template <typename Kernel>
int launch(Kernel kernel, const void* frames, const void* w, CUtensorMapDataType w_type,
           uint32_t w_elem_bytes, uint64_t w_rows, uint64_t w_cols, const void* bias, void* out,
           int b, int k, int h, int device, void* stream) {
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  CUtensorMap x_map, w_map;
  if (err == cudaSuccess)
    err = hp::tensor_map(&x_map, frames, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b, k, kRows);
  if (err == cudaSuccess)
    err = hp::tensor_map(&w_map, w, w_type, w_elem_bytes, w_rows, w_cols, hp::kTileN);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int frame_blocks = (b + kRows - 1) / kRows;
  const int tiles = h / hp::kTileN;
  const int splits = frame_blocks >= sms ? 1 : std::min(tiles, sms / frame_blocks);
  return static_cast<int>(hp::launch_clustered(kernel, frame_blocks * splits, 1, kSmemBytes, stream,
                                               x_map, w_map, static_cast<const float*>(bias),
                                               static_cast<int8_t*>(out), b, k, h, frame_blocks,
                                               splits));
}

}  // namespace

// Requires H % 128 == 0, K % 4 == 0 (16-byte rows for TMA), 16-byte aligned
// frames and w (the operand [2, H, K]: W_hi and W_lo, K-major), and
// fdn_input_layer_smem_bytes() within the block limit (checked by the
// wrapper).  Any B.
extern "C" int fdn_input_layer(const void* frames, const void* w, const void* bias, void* out,
                               int b, int k, int h, int device, void* stream) {
  return launch(input_layer_kernel, frames, w, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 2ull * h, k,
                bias, out, b, k, h, device, stream);
}

// The bf16 variant: w the operand bf16 [H, K16], K16 = k rounded up to a
// multiple of 16; otherwise as fdn_input_layer, with the same shared memory.
extern "C" int fdn_input_layer_bf16(const void* frames, const void* w, const void* bias, void* out,
                                    int b, int k, int h, int device, void* stream) {
  return launch(input_layer_bf16_kernel, frames, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h,
                (k + 15) / 16 * 16, bias, out, b, k, h, device, stream);
}

extern "C" long long fdn_input_layer_smem_bytes() { return static_cast<long long>(kSmemBytes); }
