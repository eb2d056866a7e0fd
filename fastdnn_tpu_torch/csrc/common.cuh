// Device code shared by the port's Hopper kernels: the quantized-sigmoid
// epilogue (K1), the dequantization step, an int8 tensor-core tile engine
// (ldmatrix + mma.sync) that K5 (output logits) and K8 (flash stats) run
// their products through, and K8's row-softmax epilogue pieces.  The wgmma
// kernels (K2, K3, K4, K6, K7, K9) build on csrc/hopper.cuh.
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

// ---------------------------------------------------------------------------
// int8 tensor-core tile engine.
//
// A block of kThreads threads (8 warps, 2 along M x 4 along N) computes one
// int32 tile C[BM x kBN] = A[BM x K] * W[K x kBN], exact, on the tensor cores
// with mma.sync.m16n8k32 (s8 x s8 -> s32).  The weight arrives transposed,
// Wt = W^T row-major [N, ldk] (K contiguous, see ops/kernels.py:
// kernel_layout), and streams through shared memory in kBK-deep stages, a
// ring of STAGES buffers filled by cp.async, so the next STAGES - 1 stages
// load while one multiplies.
// A either streams beside W (the logits and stats kernels) or already sits
// whole in shared memory (the stack's activations, the output layer's frame
// block).
//
// Both operands are K-contiguous, so every fragment is one ldmatrix: the
// 16-bit 8x8 matrices it moves are 8 rows x 16 int8 along K, which is
// exactly the s8 fragment layout of m16n8k32 (A row-major, B "col").  From
// an N-contiguous weight tile each B fragment would be gathered byte by
// byte and permuted, and the shared-memory pipe, not the tensor cores,
// would bound the loop.
//
// Shared-memory int8 tiles are stored in 16-byte K panels: element (r, k) of
// an R-row tile sits at ((k / 16) * R + r) * 16 + k % 16.  The 8 row
// addresses of one ldmatrix matrix are then 128 contiguous bytes: no bank
// conflict.
// ---------------------------------------------------------------------------
constexpr int kThreads = 256;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kBK = 128;           // K per stage: four 32-deep mma steps
constexpr int kBN = 128;           // output columns per tile
constexpr int kLdc = kBN + 8;      // int32 C-tile row stride (padded)
constexpr int kWStageBytes = kBK * kBN;
static_assert(kWStageBytes % (16 * kThreads) == 0, "whole 16-byte W chunks per thread and stage");
static_assert(kBN == kWarpsN * 32, "each warp owns 32 output columns");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16 x 32 s8, row) * b (32 x 8 s8, col), s32 accumulators.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BM>
struct Acc {
  static constexpr int MT = BM / (16 * kWarpsM);  // 16-row tiles per warp
  static constexpr int NT = 4;                    // 8-column tiles per warp
  static_assert(MT >= 1 && BM % (16 * kWarpsM) == 0, "BM must be a multiple of 32");
  int c[MT][NT][4];
};

// acc = A[m0 : m0+BM, 0:K] * W[0:K, n0 : n0+kBN], W given as Wt [N, ldk].
//   A_RESIDENT: a_res is the panelled [BM x K] tile in shared memory.
//   otherwise:  a_g is row-major [*, lda] in device memory, staged through
//               a_stage (STAGES * BM * kBK bytes).
// w_stage holds STAGES * kWStageBytes.  Requires K % kBK == 0, ldk % 16 == 0,
// lda % 16 == 0, 16-byte aligned bases.  Ends with a __syncthreads(), so the
// caller may reuse the stage buffers at once.
template <int BM, bool A_RESIDENT, int STAGES>
__device__ __forceinline__ void mma_tile(Acc<BM>& acc, const int8_t* __restrict__ a_g, int lda,
                                         int m0, const int8_t* a_res,
                                         const int8_t* __restrict__ wt, int ldk, int n0, int K,
                                         int8_t* a_stage, int8_t* w_stage) {
  constexpr int MT = Acc<BM>::MT;
  constexpr int NT = Acc<BM>::NT;
  constexpr int kChunks = kBK / 16;  // 16-byte K chunks per row and stage
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  // ldmatrix: lane l addresses row l % 8 of matrix l / 8
  const int mat = lane >> 3;
  const int row8 = lane & 7;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[i][j][e] = 0;

  auto load_stage = [&](int stage, int k0) {
    int8_t* ws = w_stage + stage * kWStageBytes;
    for (int i = tid; i < kWStageBytes / 16; i += kThreads) {
      const int n = i / kChunks, kc = i % kChunks;
      cp_async16(ws + (kc * kBN + n) * 16, wt + static_cast<size_t>(n0 + n) * ldk + k0 + kc * 16);
    }
    if constexpr (!A_RESIDENT) {
      int8_t* as = a_stage + stage * BM * kBK;
      for (int i = tid; i < BM * kChunks; i += kThreads) {
        const int r = i / kChunks, kc = i % kChunks;
        cp_async16(as + (kc * BM + r) * 16, a_g + static_cast<size_t>(m0 + r) * lda + k0 + kc * 16);
      }
    }
  };

  // one commit group per stage, empty past the end, so that waiting for
  // all but the newest STAGES - 2 groups always means "stage t has landed"
  const int steps = K / kBK;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s * kBK);
    cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();
    // also: every warp is done with stage t - 1, whose buffer refills next
    __syncthreads();
    if (t + STAGES - 1 < steps) load_stage((t + STAGES - 1) % STAGES, (t + STAGES - 1) * kBK);
    cp_async_commit();
    const int slot = t % STAGES;
    const int8_t* ws = w_stage + slot * kWStageBytes;
    const int8_t* as = A_RESIDENT ? a_res : a_stage + slot * BM * kBK;
    const int a_kc0 = A_RESIDENT ? t * kChunks : 0;  // this stage's first K chunk in A
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      unsigned a[MT][4];
      unsigned b[NT / 2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // matrices: rows +0/+8 (mat & 1) x K chunk +0/+1 (mat >> 1) -> a0..a3
        const int r = wm * (BM / kWarpsM) + i * 16 + row8 + (mat & 1) * 8;
        const int kc = a_kc0 + ks * 2 + (mat >> 1);
        ldmatrix_x4(a[i], as + (kc * BM + r) * 16);
      }
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        // matrices: K chunk +0/+1 (mat & 1) x columns +0/+8 (mat >> 1) ->
        // (b0, b1) of two adjacent 8-column tiles
        const int n = wn * 32 + j * 16 + row8 + (mat >> 1) * 8;
        const int kc = ks * 2 + (mat & 1);
        ldmatrix_x4(b[j], ws + (kc * kBN + n) * 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_s8(acc.c[i][j], a[i], b[j >> 1][(j & 1) * 2], b[j >> 1][(j & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Accumulators -> row-major int32 C tile [BM x kLdc] in shared memory
// (m16n8 accumulator layout: c0, c1 at row lane / 4, columns 2 * (lane % 4)
// and +1; c2, c3 eight rows below).
template <int BM>
__device__ __forceinline__ void store_acc(Acc<BM>& acc, int* c_tile) {
  constexpr int MT = Acc<BM>::MT;
  constexpr int NT = Acc<BM>::NT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wm * (BM / kWarpsM) + i * 16 + (lane >> 2);
      const int c = wn * 32 + j * 8 + (lane & 3) * 2;
      *reinterpret_cast<int2*>(c_tile + r * kLdc + c) = make_int2(acc.c[i][j][0], acc.c[i][j][1]);
      *reinterpret_cast<int2*>(c_tile + (r + 8) * kLdc + c) =
          make_int2(acc.c[i][j][2], acc.c[i][j][3]);
    }
}

// ---------------------------------------------------------------------------
// Row-softmax epilogue pieces of K8 (csrc/flash_stats.cu), with the constants
// K4 and K6 (csrc/resident_softmax.cu) share: one warp per row of a C tile,
// each lane holding columns lane, lane + 32, ... of it, so logit stores
// coalesce.
// ---------------------------------------------------------------------------
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerLane = kBN / 32;
// a logit excluded from the softmax (padding, beyond valid, inactive under
// active_only): -1e30, not -inf, so exp(z - m) never sees inf - inf
constexpr float kNegCap = -1e30f;
// a row max at or below this means no senone of the row was active
constexpr float kEmptyRowMax = -1e29f;
// masked semantics (ops/kernels.py:_SEMANTICS): 0 reference, 1 active_only
constexpr int kReference = 0;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// This lane's mask bytes of the tile at n0: raw[i][j] is row warp + kWarps i,
// column n0 + lane + 32 j, exactly the logits the lane handles in the
// epilogue.  The loads are independent (each warp reads 32 consecutive bytes
// per load) and nothing reads them until the next tile, so issued one tile
// ahead they land while this tile's products run.
template <int ROWS>
__device__ __forceinline__ void load_mask(uint8_t (&raw)[ROWS][kColsPerLane],
                                          const uint8_t* __restrict__ mask, int N, int m0, int n0,
                                          int warp, int lane) {
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const uint8_t* row = mask + static_cast<size_t>(m0 + warp + kWarps * i) * N + n0 + lane;
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) raw[i][j] = row[32 * j];
  }
}

// raw bytes -> one word, bit kColsPerLane * i + j set for an active senone
template <int ROWS>
__device__ __forceinline__ uint32_t mask_word(const uint8_t (&raw)[ROWS][kColsPerLane]) {
  static_assert(ROWS * kColsPerLane <= 32, "one bit per (row, column) of the lane");
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j)
      word |= static_cast<uint32_t>(raw[i][j] != 0) << (kColsPerLane * i + j);
  return word;
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
