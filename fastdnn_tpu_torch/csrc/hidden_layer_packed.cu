// K7: one int4 hidden layer stored two nibbles per byte,
// s8[B, K] x packed s8[K/2, N] -> shifted s8[B, N].  The weight arrives in
// the kernels' layout, Wp s8[N, K/2], K contiguous (ops/kernels.py:
// kernel_layout of quant.quantize.pack_int4_trunk's [K/2, N]): the low
// nibble of byte (n, p) is weight W[p, n], the high nibble W[K/2 + p, n].
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:fused_hidden_layer(packed=True)
// -> _layer_call with _hidden_kernel_packed (:87-106, :130-174):
//   acc = x[:, :K/2] @ lo + x[:, K/2:] @ hi
// then + colsum128, x inv_scale, + bias and the K1 sigmoid, as K2.  Integer
// sums are exact, so the result is bitwise K2's on the same int4 values held
// unpacked.
//
// Bound: as for the first K2 (an mma.sync loop, since moved to wgmma), the
// weight and activation tiles every block re-reads from L2, not the tensor
// cores.  The design halves the
// weight part: each stage brings 128 columns x 64 packed bytes (128 logical
// K) of the weight, beside the two 64-byte activation slices those bytes
// multiply, x[:, k0 : k0+64] and x[:, K/2+k0 : K/2+k0+64].  The packed tile
// sits in shared memory in the K-panel layout of an s8 tile, so one
// ldmatrix gives each thread 4 packed bytes at exactly the positions the
// m16n8k32 B fragment wants; the nibbles are widened to s8 there, in
// registers (no byte shifts: ((w & 0x0F) ^ 8) - 8 per byte with __vsub4),
// and the same mma.sync runs twice, once per activation slice.
#include "common.cuh"

namespace {

constexpr int BM = 64;
constexpr int kStages = 3;
constexpr int kPK = 64;                               // packed bytes per stage (128 logical K)
constexpr int kPChunks = kPK / 16;                    // 16-byte packed chunks per row and stage
constexpr int kAStageBytes = BM * 2 * kPK;            // the lo and the hi activation slices
constexpr int kWStageBytes = fdn::kBN * kPK;          // the packed weight tile
constexpr size_t kSmemBytes =
    kStages * (kAStageBytes + kWStageBytes) + sizeof(int) * BM * fdn::kLdc;
static_assert(kWStageBytes % (16 * fdn::kThreads) == 0, "whole W chunks per thread and stage");
static_assert(kAStageBytes % (16 * fdn::kThreads) == 0, "whole A chunks per thread and stage");

// Sign-extend the low / high nibble of each byte of w to a byte.
__device__ __forceinline__ unsigned widen_lo(unsigned w) {
  return __vsub4((w & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}
__device__ __forceinline__ unsigned widen_hi(unsigned w) {
  return __vsub4(((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u, 0x08080808u);
}

__global__ void __launch_bounds__(fdn::kThreads)
    hidden_layer_packed_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wp,
                               const int* __restrict__ colsum, const float* __restrict__ bias,
                               float inv_scale, int8_t* __restrict__ out, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* a_stage = reinterpret_cast<int8_t*>(smem);
  int8_t* w_stage = a_stage + kStages * kAStageBytes;
  int* c_tile = reinterpret_cast<int*>(w_stage + kStages * kWStageBytes);

  constexpr int MT = fdn::Acc<BM>::MT;
  constexpr int NT = fdn::Acc<BM>::NT;
  const int n0 = blockIdx.x * fdn::kBN;
  const int m0 = blockIdx.y * BM;
  const int KH = K / 2;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / fdn::kWarpsN;
  const int wn = warp % fdn::kWarpsN;
  const int mat = lane >> 3;  // ldmatrix: lane l addresses row l % 8 of matrix l / 8
  const int row8 = lane & 7;

  fdn::Acc<BM> acc;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.c[i][j][e] = 0;

  // Stage at packed column p0: the weight tile as K panels [kPChunks][kBN][16],
  // the activations as [2 * kPChunks][BM][16], the lo slice's chunks first.
  auto load_stage = [&](int stage, int p0) {
    int8_t* ws = w_stage + stage * kWStageBytes;
    for (int i = tid; i < kWStageBytes / 16; i += fdn::kThreads) {
      const int n = i / kPChunks, kc = i % kPChunks;
      fdn::cp_async16(ws + (kc * fdn::kBN + n) * 16,
                      wp + static_cast<size_t>(n0 + n) * KH + p0 + kc * 16);
    }
    int8_t* as = a_stage + stage * kAStageBytes;
    for (int i = tid; i < kAStageBytes / 16; i += fdn::kThreads) {
      const int r = i / (2 * kPChunks), c = i % (2 * kPChunks);
      const int k = (c < kPChunks ? p0 : KH + p0) + (c % kPChunks) * 16;
      fdn::cp_async16(as + (c * BM + r) * 16, x + static_cast<size_t>(m0 + r) * K + k);
    }
  };

  // one commit group per stage, empty past the end (as fdn::mma_tile)
  const int steps = KH / kPK;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s, s * kPK);
    fdn::cp_async_commit();
  }
  for (int t = 0; t < steps; ++t) {
    fdn::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage t landed; every warp is done with stage t - 1
    if (t + kStages - 1 < steps) load_stage((t + kStages - 1) % kStages, (t + kStages - 1) * kPK);
    fdn::cp_async_commit();
    const int slot = t % kStages;
    const int8_t* ws = w_stage + slot * kWStageBytes;
    const int8_t* as = a_stage + slot * kAStageBytes;
#pragma unroll
    for (int ks = 0; ks < kPK / 32; ++ks) {
      unsigned alo[MT][4], ahi[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // matrices: rows +0/+8 (mat & 1) x K chunk +0/+1 (mat >> 1) -> a0..a3
        const int r = wm * (BM / fdn::kWarpsM) + i * 16 + row8 + (mat & 1) * 8;
        const int kc = ks * 2 + (mat >> 1);
        fdn::ldmatrix_x4(alo[i], as + (kc * BM + r) * 16);
        fdn::ldmatrix_x4(ahi[i], as + ((kPChunks + kc) * BM + r) * 16);
      }
      unsigned blo[NT / 2][4], bhi[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        // matrices: K chunk +0/+1 (mat & 1) x columns +0/+8 (mat >> 1) ->
        // (b0, b1) of two adjacent 8-column tiles, as packed bytes
        const int n = wn * 32 + j * 16 + row8 + (mat >> 1) * 8;
        const int kc = ks * 2 + (mat & 1);
        unsigned packed[4];
        fdn::ldmatrix_x4(packed, ws + (kc * fdn::kBN + n) * 16);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          blo[j][e] = widen_lo(packed[e]);
          bhi[j][e] = widen_hi(packed[e]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int e = (j & 1) * 2;
          fdn::mma_s8(acc.c[i][j], alo[i], blo[j >> 1][e], blo[j >> 1][e + 1]);
          fdn::mma_s8(acc.c[i][j], ahi[i], bhi[j >> 1][e], bhi[j >> 1][e + 1]);
        }
    }
  }
  fdn::cp_async_wait<0>();
  __syncthreads();
  fdn::store_acc<BM>(acc, c_tile);
  __syncthreads();

  // epilogue: 16 consecutive columns of one row per step -> one 16-byte store
  constexpr int kChunks = fdn::kBN / 16;
  for (int i = tid; i < BM * kChunks; i += fdn::kThreads) {
    const int r = i / kChunks, c0 = (i % kChunks) * 16;
    alignas(16) int8_t v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + c0 + j;
      v[j] = fdn::quantized_sigmoid_shifted(
          fdn::dequantize(c_tile[r * fdn::kLdc + c0 + j], colsum[n], inv_scale, bias[n]));
    }
    *reinterpret_cast<int4*>(out + static_cast<size_t>(m0 + r) * N + n0 + c0) =
        *reinterpret_cast<const int4*>(v);
  }
}

}  // namespace

// Requires B % 64 == 0, K % 128 == 0 (K/2 % 64), N % 128 == 0 (checked by the wrapper).
extern "C" int fdn_hidden_layer_packed(const void* x, const void* wp, const void* colsum,
                                       const void* bias, float inv_scale, void* out, int b,
                                       int k, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = fdn::allow_smem(hidden_layer_packed_kernel, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n / fdn::kBN, b / BM);
  hidden_layer_packed_kernel<<<grid, fdn::kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wp),
      static_cast<const int*>(colsum), static_cast<const float*>(bias), inv_scale,
      static_cast<int8_t*>(out), k, n);
  return static_cast<int>(cudaGetLastError());
}
