// K5: output-layer logits, s8[B, K] x s8[K, N] -> f32[B, N], no softmax
// (the weight arrives transposed, Wt s8[N, K]; ops/kernels.py:kernel_layout).
//
// Replaces fastdnn_tpu/ops/pallas_kernels.py:output_layer_logits -> _layer_call
// with _logits_kernel (:109-111, :1103-1127): exact int32 product, + colsum128,
// x inv_scale, + bias, rounded after the multiply and after the add (the
// library is built with -fmad=false), so the result is bitwise the plain
// version's.  It serves the frame-by-frame LazyContext (one frame, padded to
// one 64-row tile, per decoder frame) and fused_softmax=False.
//
// K2's kernel (csrc/hopper.cuh: streamed_layer_kernel) with an f32 epilogue
// in place of the sigmoid: TMA weight stages and activation tiles in one
// mbarrier ring, wgmma m64n128k32 s8, two consumer warpgroups taking the
// column tiles in turn, clusters of 2 along frames sharing each stage by
// multicast (1 when the frame blocks are odd), and the columns split over
// the SMs when the frame blocks are few (B = 64: 63 blocks of one tile).
// The epilogue trades a float2 with the neighbouring lane of its quad, so
// each thread stores 4 consecutive columns of one row: 16-byte stores.
//
// Bound: at B = 64 the launch reads the whole 16.5 MB weight (N = 8064,
// K = 2048) once from device memory: about 5 us at 3.35 TB/s, against
// 2.1 G int8 ops (1 us).  At B = 8192 the products are 271 G int8 ops
// (0.137 ms), the 264 MB f32 output 0.079 ms of device-memory writes, and
// every block reads its weight stages from L2, as K2 does.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

// (acc + colsum) * inv_scale + bias per element, f32 out
struct LogitsEpilogue {
  using Out = float;
  static constexpr size_t kSmemBytes = 0;
  static __device__ __forceinline__ void prepare(unsigned char*, int, int) {}
  // Thread t holds rows r and r + 8 (r = 16 (t / 32) + (t % 32) / 4),
  // columns 8 q + 2 (t % 4) + {0, 1} (hopper.cuh: wgmma_s8).  Lanes 2j and
  // 2j + 1 of a quad swap a pair: the even lane then holds columns
  // 8 q + 4 j .. + 3 of row r, the odd lane the same of row r + 8.
  static __device__ __forceinline__ void store(const int (&d)[64], float* out, int ld, int m0,
                                               int n0, const int* cs, const float* bl, float inv,
                                               const unsigned char*, int thread_in_wg) {
    const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
    const bool odd = lane & 1;
    const int col = n0 + 2 * (lane % 4);
    const int row = m0 + warp * 16 + lane / 4 + (odd ? 8 : 0);
    float* o = out + static_cast<size_t>(row) * ld + n0 + 4 * ((lane % 4) / 2);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int n = col + 8 * q;
      const int2 c = *reinterpret_cast<const int2*>(cs + n);
      const float2 b = *reinterpret_cast<const float2*>(bl + n);
      const float2 top = make_float2(fdn::dequantize(d[4 * q], c.x, inv, b.x),
                                     fdn::dequantize(d[4 * q + 1], c.y, inv, b.y));
      const float2 bottom = make_float2(fdn::dequantize(d[4 * q + 2], c.x, inv, b.x),
                                        fdn::dequantize(d[4 * q + 3], c.y, inv, b.y));
      const float2 send = odd ? top : bottom;
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, 1),
                                     __shfl_xor_sync(0xffffffffu, send.y, 1));
      *reinterpret_cast<float4*>(o + 8 * q) = odd ? make_float4(got.x, got.y, bottom.x, bottom.y)
                                                  : make_float4(top.x, top.y, got.x, got.y);
    }
  }
};

}  // namespace

// Requires B % (64 * cluster) == 0 (cluster 1 or 2), K % 128 == 0,
// N % 128 == 0, 16-byte aligned x and wt, and fdn_output_logits_smem_bytes()
// within the block limit (checked by the wrapper).
extern "C" int fdn_output_logits(const void* x, const void* wt, const void* colsum,
                                 const void* bias, float inv_scale, void* out, int b, int k, int n,
                                 int cluster, int device, void* stream) {
  return static_cast<int>(hp::streamed_layer<LogitsEpilogue>(x, wt, colsum, bias, inv_scale, out,
                                                             b, k, n, cluster, device, stream));
}

extern "C" long long fdn_output_logits_smem_bytes() {
  return static_cast<long long>(hp::streamed_layer_smem_bytes<LogitsEpilogue>());
}
