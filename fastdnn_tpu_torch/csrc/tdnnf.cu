// The TDNN-F chain net's kernels (models/tdnnf.py; the quantized contract of
// quant/quantize.py), each bitwise its plain version in ops/matmul.py:
//
//       tdnnf_input     tdnn1: f32(sum_k f64(x_k) * f64(w_k)) in the order of k,
//                       + bias, ReLU, batchnorm, the row's codes and scale; f64
//                       on CUDA cores, so that the sum is one its plain
//                       version and the reference can take in the same order
//                       (K9's 3xTF32 product is not: a last-bit difference
//                       flips a code now and then, and 34 requantizations
//                       carry the flip through the chunk)
//
//   K11 tdnnf_project   a factorized layer's linear part, N = 160 (and, as
//                       chain_project, prefinal-l and prefinal-chain's second
//                       linear, N = 256, with an optional bias):
//                       c = requant(sum_i T(q[map(r) + o_i], W_i) [+ bias]),
//                       K a multiple of 128
//   K12 tdnnf_expand    its affine part (and, as chain_expand,
//                       prefinal-chain's affine with no bypass):
//                       x = f32(f32(max(u, 0) * gamma) + beta),
//                       u = sum_i T(c[map(r) + o_i], E_i) + bias, plus the
//                       bypass f32(f32(q_h * s_h) * 0.66) of the row the bypass
//                       map gives; out requant(x); K a multiple of 32 up to
//                       256, N a multiple of 128
//   K13 chain_logits    the chain output y = f32(T(p, O) + o), f32 [B, N],
//                       no softmax; K a multiple of 32 up to 256, N of 8
//
// with T(q, W) = f32(f32(q @ W) * f32(s * inv)) for a row's codes q and
// scale s, and requant(v): s = max|v| / 127, codes round_half_away(v / s)
// clipped to [-127, 127] (0 where s is 0).  A term reads its rows through a
// row map (r / per_out * per_in + first + r % per_out * step) and a row
// offset, the time offset of the layer's stride in rows of its rate: no
// spliced copy of the activations is made.  A row outside the input reads
// codes 0 and scale 0.  The rate drop (the first layer at a third of the
// frame rate) is the map (rows_low, rows, first, 3); the outputs' rows are
// the map (outputs, rows_low, out_first, 1) into prefinal-l.
//
// Replaces no TPU kernel: fastdnn_tpu/ops/pallas_kernels.py has no net with
// time context.  The affine part ends in the epilogue of a hidden layer
// there (fused_hidden_layer, :180-208), with ReLU, batchnorm, the bypass
// and the requantization in place of the sigmoid.
//
// Bound: a run_tdnn_1d request of 64 chunks of 150 frames (the needed rows
// of each layer, nets/tdnnf.py in the benchmark): tdnn1 4.9 G f64
// multiply-adds (0.29 ms at the H100's 33.5 TFLOP/s of f64 on CUDA cores;
// the roofline counts them at TF32's peak, as any input layer); the
// factorized layers 2.6 G int8 operations
// of the factorized layers a chunk, 168 G in all (0.085 ms at 1979 TOP/s)
// against ~240 MB of codes in and out (0.07 ms at 3.35 TB/s); the chain
// output 11.5 G operations against its 89.6 MB of f32 outputs (0.027 ms):
// bound by memory.
//
// Design (a first one): csrc/hopper.cuh's int8 wgmma on operands staged in
// its 128-byte swizzle by cp.async, one warpgroup a block owning 64 rows;
// no TMA and no warp specialisation (the row maps and offsets read rows no
// tensor map describes).  Each offset's product accumulates apart, in its
// own wgmma accumulators, and the epilogue sums the terms in f32 in the
// contract's order.  A requant needs a row's max over all of its columns,
// which the 4 lanes of a quad hold between them: K11 keeps all 160 (256)
// columns in registers (wgmma n128 + n32, or n256) and meets the quad's
// maxima by shuffles; K12 (N = 1536) runs its products twice, as K4 at a
// short K does (csrc/resident_softmax.cu): a first pass over the column
// tiles for each row's max, a second for the codes, its K of at most 256
// being cheap to recompute.  Every multiply and add of an epilogue is an
// explicitly rounded __fmul_rn / __fadd_rn.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

constexpr int kThreads = 128;        // one warpgroup a block
constexpr int kRows = hp::kFrames;   // 64 rows a block: wgmma m64
constexpr int kBlockK = 128;         // K bytes of a swizzled block
constexpr int kTileN = hp::kTileN;   // K12's and K13's column tile: wgmma n128
constexpr int kProjectN = 160;       // K11's N: wgmma n128 + n32
constexpr int kChainN = 256;         // chain_project's N: wgmma n256
constexpr int kStages = 4;           // K11's pipeline
constexpr float kCodeMax = 127.0f;

struct RowMap {
  int per_out, per_in, first, step;
};

struct Term {
  const int8_t* a;     // codes [n_in, K]
  const float* scale;  // [n_in]
  const int8_t* w;     // [N, K], K contiguous
  float inv;           // 1 / the matrix's multiplier
  int offset;          // rows past the map's row
};

struct Bypass {
  const int8_t* codes;  // [n_in, N]
  const float* scale;
  float factor;
  RowMap map;
};

__device__ __forceinline__ int map_row(const RowMap& m, int r) {
  return r / m.per_out * m.per_in + m.first + r % m.per_out * m.step;
}

// the input row that output row r reads through the term, or -1
__device__ __forceinline__ int term_row(const Term& t, const RowMap& m, int r, int n_out,
                                        int n_in) {
  if (r >= n_out) return -1;
  const int i = map_row(m, r) + t.offset;
  return i >= 0 && i < n_in ? i : -1;
}

// the row's f32(s * inv), 0 for a row outside the input
__device__ __forceinline__ float row_scale(const Term& t, int i) {
  return i >= 0 ? __fmul_rn(t.scale[i], t.inv) : 0.0f;
}

// a value -> its code under the row's s (0 when s is 0), rounding half away
// from zero (csrc/lowrank_layer.cu's code_of)
__device__ __forceinline__ int8_t code_of(float v, float s) {
  if (!(s > 0.0f)) return 0;
  const float x = __fdiv_rn(v, s);
  const float k = truncf(__fadd_rn(x, copysignf(0.5f, x)));
  return static_cast<int8_t>(fminf(fmaxf(k, -kCodeMax), kCodeMax));
}

// the max of a row over the 4 lanes of a quad, which hold its columns
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(fdn::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes [k0, k0 + k) of `rows` rows of src (row stride `stride` bytes) into
// shared memory as k / 128 blocks of [rows x 128 bytes] in the 128-byte
// swizzle (hp::swizzle128, what TMA's SWIZZLE_128B writes); a row whose
// src_row() is negative as zeros.  k a multiple of 16.
template <typename SrcRow>
__device__ __forceinline__ void stage_swizzled(int8_t* dst, int rows, int k, int k0,
                                               const int8_t* src, int stride, SrcRow src_row) {
  const int chunks = k / 16;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = i % chunks;
    const int s = src_row(r);
    cp_async16(dst + (c >> 3) * rows * kBlockK + hp::swizzle128(r, c & 7),
               s >= 0 ? src + static_cast<size_t>(s) * stride + k0 + 16 * c : src, s >= 0);
  }
}

// the cp.async copies waited for, made visible to wgmma, the block met
__device__ __forceinline__ void staged() {
  hp::fence_proxy_async();
  __syncthreads();
}

// the descriptor of 32-deep step j of a swizzled operand of `rows` rows
__device__ __forceinline__ uint64_t step_desc(const int8_t* base, int rows, int j) {
  return hp::desc_sw128(base + (j >> 2) * rows * kBlockK + (j & 3) * 32);
}

__host__ __device__ constexpr int swizzled_bytes(int rows, int k) {
  return (k + kBlockK - 1) / kBlockK * rows * kBlockK;
}

__device__ __forceinline__ void fence_acc16(int (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 32 s32) += A (64 x 32 s8) * B^T (B: 32 x 32 s8, K-major), or =
// with accumulate == false; d laid out as hp::wgmma_s8's (q = 0 .. 3).
__device__ __forceinline__ void wgmma_s8_n32(int (&d)[16], uint64_t a, uint64_t b,
                                             bool accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// ---------------------------------------------------------------------------
// K11: every column of 64 rows in registers, K streamed through kStages
// stages of [64 x 128] codes and [N x 128] weights.

template <bool CHAIN>
__host__ __device__ constexpr size_t project_smem() {
  return hp::kAlign + static_cast<size_t>(kStages) *
                          (kRows * kBlockK + (CHAIN ? kChainN : kProjectN) * kBlockK);
}

template <int TERMS, bool CHAIN, bool BIAS>
__device__ __forceinline__ void project_body(unsigned char* smem, const Term& t0, const Term& t1,
                                             const RowMap& map, int n_in, const float* bias,
                                             int8_t* out, float* out_scale, int n_out, int K) {
  constexpr int N = CHAIN ? kChainN : kProjectN;
  constexpr int kA = kRows * kBlockK;
  constexpr int kStage = kA + N * kBlockK;
  constexpr int NQ = N / 8;  // the thread's column pairs: 8 q + 2 (lane % 4)
  int8_t* stages = reinterpret_cast<int8_t*>(hp::align_smem(smem));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kRows;
  const int nk = K / kBlockK;
  const int steps = TERMS * nk;

  auto load = [&](int step) {
    if (step < steps) {
      const Term& t = step / nk == 0 ? t0 : t1;
      const int k0 = step % nk * kBlockK;
      int8_t* st = stages + step % kStages * kStage;
      stage_swizzled(st, kRows, kBlockK, k0, t.a, K,
                     [&](int r) { return term_row(t, map, m0 + r, n_out, n_in); });
      stage_swizzled(st + kA, N, kBlockK, k0, t.w, K, [](int r) { return r; });
    }
    cp_async_commit();  // empty past the last step: the groups keep count
  };

  int d[TERMS][CHAIN ? 2 : 1][64];  // columns [128 h, 128 h + 128) of each term
  int e[TERMS][16];                 // K11's columns [128, 160)
  for (int s = 0; s < kStages - 1; ++s) load(s);
#pragma unroll
  for (int term = 0; term < TERMS; ++term) {
    for (int kc = 0; kc < nk; ++kc) {
      const int step = term * nk + kc;
      load(step + kStages - 1);
      cp_async_wait<kStages - 1>();
      staged();
      const int8_t* st = stages + step % kStages * kStage;
      hp::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBlockK / 32; ++ks) {
        const uint64_t a = hp::desc_sw128(st + ks * 32);
        const bool acc = kc > 0 || ks > 0;
        if constexpr (CHAIN) {
          hp::wgmma_s8_n256(d[term], a, hp::desc_sw128(st + kA + ks * 32), acc);
        } else {
          hp::wgmma_s8(d[term][0], a, hp::desc_sw128(st + kA + ks * 32), acc);
          wgmma_s8_n32(e[term], a, hp::desc_sw128(st + kA + kTileN * kBlockK + ks * 32), acc);
        }
      }
      hp::wgmma_commit();
      hp::wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < (CHAIN ? 2 : 1); ++h) hp::fence_acc(d[term][h]);
      if constexpr (!CHAIN) fence_acc16(e[term]);
      __syncthreads();  // the stage is refilled next
    }
  }

  // the epilogue: the thread's rows r[0] and r[1] = r[0] + 8
  const int r[2] = {m0 + warp * 16 + lane / 4, m0 + warp * 16 + lane / 4 + 8};
  float rs[TERMS][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[0][h] = row_scale(t0, term_row(t0, map, r[h], n_out, n_in));
    if constexpr (TERMS == 2) rs[1][h] = row_scale(t1, term_row(t1, map, r[h], n_out, n_in));
  }
  auto acc_at = [&](int i, int q, int j) -> int {
    if constexpr (CHAIN) return d[i][q >> 4][4 * (q & 15) + j];
    else return q < 16 ? d[i][0][4 * q + j] : e[i][4 * (q - 16) + j];
  };
  auto value = [&](int q, int j) -> float {
    float x = __fmul_rn(__int2float_rn(acc_at(0, q, j)), rs[0][j >> 1]);
    if constexpr (TERMS == 2)
      x = __fadd_rn(x, __fmul_rn(__int2float_rn(acc_at(1, q, j)), rs[1][j >> 1]));
    if constexpr (BIAS) x = __fadd_rn(x, bias[8 * q + 2 * (lane % 4) + (j & 1)]);
    return x;
  };
  float amax[2] = {0.0f, 0.0f};
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int j = 0; j < 4; ++j) amax[j >> 1] = fmaxf(amax[j >> 1], fabsf(value(q, j)));
  float s[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) s[h] = __fdiv_rn(quad_max(amax[h]), kCodeMax);
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int n = 8 * q + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r[h] < n_out)
        *reinterpret_cast<char2*>(out + static_cast<size_t>(r[h]) * N + n) =
            make_char2(code_of(value(q, 2 * h), s[h]), code_of(value(q, 2 * h + 1), s[h]));
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r[h] < n_out) out_scale[r[h]] = s[h];
  }
}

template <int TERMS>
__global__ void __launch_bounds__(kThreads)
    tdnnf_project_kernel(Term t0, Term t1, RowMap map, int n_in, int8_t* __restrict__ out,
                         float* __restrict__ out_scale, int n_out, int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  project_body<TERMS, false, false>(smem, t0, t1, map, n_in, nullptr, out, out_scale, n_out, K);
}

template <bool BIAS>
__global__ void __launch_bounds__(kThreads)
    chain_project_kernel(Term t0, RowMap map, int n_in, const float* __restrict__ bias,
                         int8_t* __restrict__ out, float* __restrict__ out_scale, int n_out,
                         int K) {
  extern __shared__ __align__(1024) unsigned char smem[];
  project_body<1, true, BIAS>(smem, t0, t0, map, n_in, bias, out, out_scale, n_out, K);
}

// ---------------------------------------------------------------------------
// K12: the block's rows of each term resident, the column tiles' weights
// through two stages, twice over the tiles.

__host__ __device__ constexpr size_t expand_smem(int terms, int k) {
  return hp::kAlign + static_cast<size_t>(terms) *
                          (swizzled_bytes(kRows, k) + 2 * swizzled_bytes(kTileN, k));
}

template <int TERMS, bool BYPASS>
__device__ __forceinline__ void expand_body(unsigned char* smem, const Term& t0, const Term& t1,
                                            const RowMap& map, int n_in, const float* bias,
                                            const float* gamma, const float* beta,
                                            const Bypass& by, int8_t* out, float* out_scale,
                                            int n_out, int K, int N) {
  const int a_bytes = swizzled_bytes(kRows, K), w_bytes = swizzled_bytes(kTileN, K);
  int8_t* acts = reinterpret_cast<int8_t*>(hp::align_smem(smem));  // TERMS x a_bytes
  int8_t* ws = acts + TERMS * a_bytes;                               // 2 x TERMS x w_bytes
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kRows;
  const int tiles = N / kTileN, total = 2 * tiles, steps = K / 32;

#pragma unroll
  for (int i = 0; i < TERMS; ++i) {  // they join the first tile's group
    const Term& t = i == 0 ? t0 : t1;
    stage_swizzled(acts + i * a_bytes, kRows, K, 0, t.a, K,
                   [&](int r) { return term_row(t, map, m0 + r, n_out, n_in); });
  }
  auto load = [&](int it) {
    if (it < total) {
      const int n0 = it % tiles * kTileN;
#pragma unroll
      for (int i = 0; i < TERMS; ++i) {
        const Term& t = i == 0 ? t0 : t1;
        stage_swizzled(ws + ((it & 1) * TERMS + i) * w_bytes, kTileN, K, 0,
                       t.w + static_cast<size_t>(n0) * K, K, [](int r) { return r; });
      }
    }
    cp_async_commit();
  };

  const int r[2] = {m0 + warp * 16 + lane / 4, m0 + warp * 16 + lane / 4 + 8};
  float rs[TERMS][2], sb[2] = {0.0f, 0.0f};
  const int8_t* by_row[2] = {nullptr, nullptr};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rs[0][h] = row_scale(t0, term_row(t0, map, r[h], n_out, n_in));
    if constexpr (TERMS == 2) rs[1][h] = row_scale(t1, term_row(t1, map, r[h], n_out, n_in));
    if constexpr (BYPASS) {
      if (r[h] < n_out) {
        const int i = map_row(by.map, r[h]);
        sb[h] = by.scale[i];
        by_row[h] = by.codes + static_cast<size_t>(i) * N;
      }
    }
  }

  float amax[2] = {0.0f, 0.0f}, s[2] = {0.0f, 0.0f};
  int d[TERMS][64];
  load(0);
  for (int it = 0; it < total; ++it) {
    load(it + 1);
    cp_async_wait<1>();
    staged();
    const int pass = it / tiles, n0 = it % tiles * kTileN;
    hp::wgmma_fence();
#pragma unroll
    for (int i = 0; i < TERMS; ++i) {
      const int8_t* w = ws + ((it & 1) * TERMS + i) * w_bytes;
      for (int j = 0; j < steps; ++j)
        hp::wgmma_s8(d[i], step_desc(acts + i * a_bytes, kRows, j), step_desc(w, kTileN, j),
                     j > 0);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < TERMS; ++i) hp::fence_acc(d[i]);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int n = n0 + 8 * q + 2 * (lane % 4);
      const float2 bi = *reinterpret_cast<const float2*>(bias + n);
      const float2 gm = *reinterpret_cast<const float2*>(gamma + n);
      const float2 bt = *reinterpret_cast<const float2*>(beta + n);
      float x[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = j >> 1, c = j & 1;
        float u = __fmul_rn(__int2float_rn(d[0][4 * q + j]), rs[0][h]);
        if constexpr (TERMS == 2)
          u = __fadd_rn(u, __fmul_rn(__int2float_rn(d[1][4 * q + j]), rs[1][h]));
        u = __fadd_rn(u, c ? bi.y : bi.x);
        x[j] = __fadd_rn(__fmul_rn(fmaxf(u, 0.0f), c ? gm.y : gm.x), c ? bt.y : bt.x);
      }
      if constexpr (BYPASS) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (by_row[h] != nullptr) {
            const char2 b = *reinterpret_cast<const char2*>(by_row[h] + n);
            x[2 * h] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(b.x), sb[h]), by.factor),
                                 x[2 * h]);
            x[2 * h + 1] = __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(b.y), sb[h]), by.factor),
                                     x[2 * h + 1]);
          }
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) amax[j >> 1] = fmaxf(amax[j >> 1], fabsf(x[j]));
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (r[h] < n_out)
            *reinterpret_cast<char2*>(out + static_cast<size_t>(r[h]) * N + n) =
                make_char2(code_of(x[2 * h], s[h]), code_of(x[2 * h + 1], s[h]));
      }
    }
    if (it == tiles - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) s[h] = __fdiv_rn(quad_max(amax[h]), kCodeMax);
    }
    __syncthreads();  // the tile's stage is refilled next
  }
  if (lane % 4 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (r[h] < n_out) out_scale[r[h]] = s[h];
  }
}

template <int TERMS>
__global__ void __launch_bounds__(kThreads)
    tdnnf_expand_kernel(Term t0, Term t1, RowMap map, int n_in, const float* __restrict__ bias,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        Bypass by, int8_t* __restrict__ out, float* __restrict__ out_scale,
                        int n_out, int K, int N) {
  extern __shared__ __align__(1024) unsigned char smem[];
  expand_body<TERMS, true>(smem, t0, t1, map, n_in, bias, gamma, beta, by, out, out_scale, n_out,
                           K, N);
}

__global__ void __launch_bounds__(kThreads)
    chain_expand_kernel(Term t0, RowMap map, int n_in, const float* __restrict__ bias,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        int8_t* __restrict__ out, float* __restrict__ out_scale, int n_out, int K,
                        int N) {
  extern __shared__ __align__(1024) unsigned char smem[];
  expand_body<1, false>(smem, t0, t0, map, n_in, bias, gamma, beta, Bypass{}, out, out_scale,
                        n_out, K, N);
}

// ---------------------------------------------------------------------------
// K13: a 64-row x 128-column tile a block.

__host__ __device__ constexpr size_t logits_smem(int k) {
  return hp::kAlign + static_cast<size_t>(swizzled_bytes(kRows, k) + swizzled_bytes(kTileN, k));
}

__global__ void __launch_bounds__(kThreads)
    chain_logits_kernel(Term t, const float* __restrict__ bias, float* __restrict__ out,
                        int n_rows, int K, int N) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int8_t* acts = reinterpret_cast<int8_t*>(hp::align_smem(smem));
  int8_t* w = acts + swizzled_bytes(kRows, K);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * kRows, n0 = blockIdx.y * kTileN;
  stage_swizzled(acts, kRows, K, 0, t.a, K,
                 [&](int r) { return m0 + r < n_rows ? m0 + r : -1; });
  stage_swizzled(w, kTileN, K, 0, t.w + static_cast<size_t>(n0) * K, K,
                 [&](int r) { return n0 + r < N ? r : -1; });
  cp_async_commit();
  cp_async_wait<0>();
  staged();
  int d[64];
  hp::wgmma_fence();
  for (int j = 0; j < K / 32; ++j)
    hp::wgmma_s8(d, step_desc(acts, kRows, j), step_desc(w, kTileN, j), j > 0);
  hp::wgmma_commit();
  hp::wgmma_wait<0>();
  hp::fence_acc(d);
  const int r[2] = {m0 + warp * 16 + lane / 4, m0 + warp * 16 + lane / 4 + 8};
  float rs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rs[h] = row_scale(t, r[h] < n_rows ? r[h] : -1);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int n = n0 + 8 * q + 2 * (lane % 4);
    if (n >= N) continue;
    const float2 bi = *reinterpret_cast<const float2*>(bias + n);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (r[h] >= n_rows) continue;
      float2 y;
      y.x = __fadd_rn(__fmul_rn(__int2float_rn(d[4 * q + 2 * h]), rs[h]), bi.x);
      y.y = __fadd_rn(__fmul_rn(__int2float_rn(d[4 * q + 2 * h + 1]), rs[h]), bi.y);
      *reinterpret_cast<float2*>(out + static_cast<size_t>(r[h]) * N + n) = y;
    }
  }
}

// ---------------------------------------------------------------------------
// tdnnf_input: tdnn1 on CUDA cores, each product term in f64.  A block owns
// kInputRows rows: their frames as f64 in shared memory, then, 512 columns
// at a time (two a thread), the sum over k in order of f64(x) * f64(w) (each
// term exact in f64, so __fma_rn adds it with one rounding, as the plain
// version's separate product and sum do), rounded once to f32, through the
// ReLU-batchnorm epilogue into shared memory; then each row's max over all
// H columns, and the codes.

constexpr int kInputRows = 16;
constexpr int kInputMaxK = 256;

__host__ __device__ constexpr size_t input_smem(int k, int h) {
  return static_cast<size_t>(kInputRows) * (k * sizeof(double) + h * sizeof(float)) +
         kInputRows * sizeof(float);
}

// the ReLU-batchnorm epilogue of one value: f32(f32(max(f32(y + b), 0) * g) + t)
__device__ __forceinline__ float relu_bn(float y, float b, float g, float t) {
  return __fadd_rn(__fmul_rn(fmaxf(__fadd_rn(y, b), 0.0f), g), t);
}

__global__ void __launch_bounds__(256)
    tdnnf_input_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const float* __restrict__ bias, const float* __restrict__ gamma,
                       const float* __restrict__ beta, int8_t* __restrict__ out,
                       float* __restrict__ out_scale, int B, int K, int H) {
  extern __shared__ __align__(1024) unsigned char smem[];
  double* xs = reinterpret_cast<double*>(smem);                    // [kInputRows][K]
  float* ys = reinterpret_cast<float*>(xs + kInputRows * K);       // [kInputRows][H]
  float* scale = ys + kInputRows * H;                              // [kInputRows]
  const int m0 = blockIdx.x * kInputRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int i = tid; i < kInputRows * K; i += blockDim.x) {
    const int r = i / K, k = i % K;
    xs[i] = m0 + r < B ? static_cast<double>(x[static_cast<size_t>(m0 + r) * K + k]) : 0.0;
  }
  __syncthreads();
  for (int n0 = 0; n0 < H; n0 += 2 * 256) {
    const int c[2] = {n0 + tid, n0 + 256 + tid};
    const bool live[2] = {c[0] < H, c[1] < H};
    double acc[2][kInputRows];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int r = 0; r < kInputRows; ++r) acc[j][r] = 0.0;
    for (int k = 0; k < K; ++k) {
      const double w0 = live[0] ? static_cast<double>(w[static_cast<size_t>(k) * H + c[0]]) : 0.0;
      const double w1 = live[1] ? static_cast<double>(w[static_cast<size_t>(k) * H + c[1]]) : 0.0;
#pragma unroll
      for (int r = 0; r < kInputRows; ++r) {
        const double xv = xs[r * K + k];
        acc[0][r] = __fma_rn(xv, w0, acc[0][r]);
        acc[1][r] = __fma_rn(xv, w1, acc[1][r]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!live[j]) continue;
      const float b = bias[c[j]], g = gamma[c[j]], t = beta[c[j]];
#pragma unroll
      for (int r = 0; r < kInputRows; ++r)
        ys[r * H + c[j]] = relu_bn(__double2float_rn(acc[j][r]), b, g, t);
    }
  }
  __syncthreads();
  for (int r = warp; r < kInputRows; r += blockDim.x / 32) {  // a warp's rows' max |h|
    float m = 0.0f;
    for (int c = lane; c < H; c += 32) m = fmaxf(m, fabsf(ys[r * H + c]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) scale[r] = __fdiv_rn(m, kCodeMax);
  }
  __syncthreads();
  for (int i = tid; i < kInputRows * H; i += blockDim.x) {
    const int r = i / H;
    if (m0 + r < B) out[static_cast<size_t>(m0) * H + i] = code_of(ys[i], scale[r]);
  }
  if (tid < kInputRows && m0 + tid < B) out_scale[m0 + tid] = scale[tid];
}

// ---------------------------------------------------------------------------
// Host side.

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, void* stream, Args... args) {
  cudaError_t err = fdn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

Term make_term(const void* a, const void* scale, const void* w, float inv, int offset) {
  return Term{static_cast<const int8_t*>(a), static_cast<const float*>(scale),
              static_cast<const int8_t*>(w), inv, offset};
}

int blocks_of(int rows) { return (rows + kRows - 1) / kRows; }

}  // namespace

// K11: terms (a_i codes s8[n_in, K], s_i scale f32[n_in], w_i s8[N, K],
// inv_i, off_i), the second absent when a1 is null; the row map; out
// s8[n_out, N] and out_scale f32[n_out].  chain 0: tdnnf_project_kernel,
// N = 160, no bias; chain 1: chain_project_kernel, one term, N = 256, bias
// f32[N] or null.  K % 128 == 0, 16-byte aligned a_i and w_i.
extern "C" int fdn_tdnnf_project(const void* a0, const void* s0, const void* w0, float inv0,
                                 int off0, const void* a1, const void* s1, const void* w1,
                                 float inv1, int off1, int per_out, int per_in, int first,
                                 int step, int n_in, const void* bias, void* out, void* out_scale,
                                 int n_out, int k, int n, int chain, int device, void* stream) {
  if (k <= 0 || k % kBlockK || n != (chain ? kChainN : kProjectN) || (chain && a1 != nullptr) ||
      (!chain && bias != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  const Term t0 = make_term(a0, s0, w0, inv0, off0);
  const Term t1 = a1 ? make_term(a1, s1, w1, inv1, off1) : t0;
  const RowMap map{per_out, per_in, first, step};
  int8_t* o = static_cast<int8_t*>(out);
  float* os = static_cast<float*>(out_scale);
  const dim3 grid(blocks_of(n_out));
  if (chain) {
    const float* b = static_cast<const float*>(bias);
    err = b ? launch(chain_project_kernel<true>, grid, project_smem<true>(), stream, t0, map,
                     n_in, b, o, os, n_out, k)
            : launch(chain_project_kernel<false>, grid, project_smem<true>(), stream, t0, map,
                     n_in, b, o, os, n_out, k);
  } else {
    err = a1 ? launch(tdnnf_project_kernel<2>, grid, project_smem<false>(), stream, t0, t1, map,
                      n_in, o, os, n_out, k)
             : launch(tdnnf_project_kernel<1>, grid, project_smem<false>(), stream, t0, t1, map,
                      n_in, o, os, n_out, k);
  }
  return static_cast<int>(err);
}

// K12: terms as fdn_tdnnf_project's; bias, gamma, beta f32[N]; the bypass
// codes s8[., N] and scale, its factor and row map (chain 0:
// tdnnf_expand_kernel, with the bypass; chain 1: chain_expand_kernel, one
// term, no bypass).  K % 32 == 0, K <= 256, N % 128 == 0, 16-byte aligned
// a_i and w_i, 8-byte aligned bias, gamma and beta.
extern "C" int fdn_tdnnf_expand(const void* a0, const void* s0, const void* w0, float inv0,
                                int off0, const void* a1, const void* s1, const void* w1,
                                float inv1, int off1, int per_out, int per_in, int first, int step,
                                int n_in, const void* bias, const void* gamma, const void* beta,
                                const void* by_codes, const void* by_scale, float by_factor,
                                int by_per_out, int by_per_in, int by_first, int by_step,
                                void* out, void* out_scale, int n_out, int k, int n, int chain,
                                int device, void* stream) {
  if (k <= 0 || k % 32 || k > 256 || n <= 0 || n % kTileN ||
      (chain && (a1 != nullptr || by_codes != nullptr)) || (!chain && by_codes == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_out == 0) return 0;
  const Term t0 = make_term(a0, s0, w0, inv0, off0);
  const Term t1 = a1 ? make_term(a1, s1, w1, inv1, off1) : t0;
  const RowMap map{per_out, per_in, first, step};
  const float* b = static_cast<const float*>(bias);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  int8_t* o = static_cast<int8_t*>(out);
  float* os = static_cast<float*>(out_scale);
  const dim3 grid(blocks_of(n_out));
  if (chain) {
    err = launch(chain_expand_kernel, grid, expand_smem(1, k), stream, t0, map, n_in, b, gm, bt, o,
                 os, n_out, k, n);
  } else {
    const Bypass by{static_cast<const int8_t*>(by_codes), static_cast<const float*>(by_scale),
                    by_factor, RowMap{by_per_out, by_per_in, by_first, by_step}};
    err = a1 ? launch(tdnnf_expand_kernel<2>, grid, expand_smem(2, k), stream, t0, t1, map, n_in,
                      b, gm, bt, by, o, os, n_out, k, n)
             : launch(tdnnf_expand_kernel<1>, grid, expand_smem(1, k), stream, t0, t1, map, n_in,
                      b, gm, bt, by, o, os, n_out, k, n);
  }
  return static_cast<int>(err);
}

// K13: codes s8[rows, K] with scale f32[rows], O s8[N, K] with inv, bias
// f32[N] -> out f32[rows, N].  K % 32 == 0, K <= 256, N % 8 == 0.
extern "C" int fdn_chain_logits(const void* a, const void* scale, const void* w, float inv,
                                const void* bias, void* out, int rows, int k, int n, int device,
                                void* stream) {
  if (k <= 0 || k % 32 || k > 256 || n <= 0 || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return 0;
  const dim3 grid(blocks_of(rows), (n + kTileN - 1) / kTileN);
  return static_cast<int>(launch(chain_logits_kernel, grid, logits_smem(k), stream,
                                 make_term(a, scale, w, inv, 0), static_cast<const float*>(bias),
                                 static_cast<float*>(out), rows, k, n));
}

// tdnn1: frames f32[b, k] x w f32[k, h] -> codes s8[b, h] and scale f32[b],
// the product in f64 in the order of k.  k <= 256, input_smem(k, h) within the
// block's limit (checked by the wrapper).
extern "C" int fdn_tdnnf_input(const void* x, const void* w, const void* bias, const void* gamma,
                               const void* beta, void* out, void* scale, int b, int k, int h,
                               int device, void* stream) {
  if (k <= 0 || k > kInputMaxK || h <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  const size_t smem = input_smem(k, h);
  err = fdn::allow_smem(tdnnf_input_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  tdnnf_input_kernel<<<(b + kInputRows - 1) / kInputRows, 256, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<int8_t*>(out),
      static_cast<float*>(scale), b, k, h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" long long fdn_tdnnf_input_smem_bytes(int k, int h) {
  return static_cast<long long>(input_smem(k, h));
}

// Shared memory of a launch: kind 0 K11 (terms 0: chain_project), 1 K12
// with `terms` terms at K, 2 K13 at K.
extern "C" long long fdn_tdnnf_smem_bytes(int kind, int terms, int k, int n) {
  (void)n;
  if (kind == 0) return static_cast<long long>(terms ? project_smem<false>() : project_smem<true>());
  if (kind == 1) return static_cast<long long>(expand_smem(terms, k));
  return static_cast<long long>(logits_smem(k));
}
