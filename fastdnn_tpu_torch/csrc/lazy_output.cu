// A lazily scored frame's output layer in one launch: for each of a few
// rows of last-hidden activations s8 [rows, K] and its mask u8 [rows, W]
// (nonzero = active, W >= out_dim), the logits of the active senones only,
// s8 [K] x s8 [K, N] (the weight transposed, Wt s8 [N, K];
// ops/kernels.py:kernel_layout), folded into the row's (max, sum-exp), and
// the masked posteriors f32 [rows, out_dim] written out.
//
// Replaces, for rows <= engine/scorer.py:LAZY_OUTPUT_MAX_ROWS, the route of
// fastdnn_tpu/engine/scorer.py:_masked_from_acts_fn (:590-621): B10
// (fastdnn_tpu/ops/pallas_kernels.py:output_layer_logits, :1104) over the
// whole padded width, then XLA's masked softmax
// (fastdnn_tpu/ops/matmul.py:masked_softmax_reference / _active_only).
// On the card that route was the row padded to K5's 64-frame tile, one K5
// launch and seven to eight torch ops, each an allocation and a launch.
//
// One cluster of kCluster blocks per row; block `rank` takes the row's
// columns [rank * per, (rank + 1) * per) of out_dim.  The block keeps the
// row's activations in shared memory, lists its active columns (a ballot
// over the mask bytes), and gives each warp kInFlight listed senones at a
// time: each lane reads 16-byte pieces of the senones' contiguous weight
// rows, multiplies them with __dp4a (exact int32), the warp sums the lanes
// (__reduce_add_sync, exact), and one lane dequantizes with K5's epilogue
// arithmetic (common.cuh:dequantize), so an active logit is bitwise K5's.
// An inactive senone loads no weight: its logit is the fill, 0 under
// "reference" (it joins the max) and -1e30 under "active_only" (it adds
// nothing), as in csrc/resident_softmax.cu.  The block keeps its logits in
// shared memory.  Each warp folds the logits it computes into a running
// (max, sum-exp), behind the other warps' loads; the block merges its
// warps' pairs and, once, its inactive columns' fill (row_stats.cuh:
// merge_stats, in closed form as K6 does), the blocks of the cluster read
// each other's pairs through distributed shared memory (load_cluster), and
// each merges them in the same fixed tree, so every block gets the same
// bits and writes its own columns as exp(z - m) / s, or 0 in a row with no
// active senone under active_only.  No device-memory scratch, atomic or
// memset: launches on different streams share nothing.  ROWSCALE (a
// low-rank output layer's expand product on the bottleneck's codes,
// csrc/lowrank_layer.cu): each row dequantizes with its own scale,
// row_scale[row], in place of the layer's, as K4's ROWSCALE does.
//
// Bound: one row at the flagship's widths (K = 2048, out_dim = 8000) with
// 3,200 active senones reads 6.6 MB of weight rows (2 us at 3.35 TB/s)
// against 13 M int8 operations; the frame's other bytes (activations,
// mask, colsums, biases, posteriors) are 0.1 MB.  The weight (16.5 MB)
// stays in the 50 MB L2 between frames, and the rows arrive at what one
// cluster's SMs take in from it: 46-56 GB/s an SM on the H100, the same by
// bulk copies (TMA) into a ring of shared memory as by these loads, so
// about 8 us at 40% masks, beside 4.4 us of list, merge and sweep
// (PERF.md).
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"
#include "row_stats.cuh"

namespace {

namespace hp = fdn::hopper;
namespace rs = fdn::rowstats;
using fdn::kEmptyRowMax;
using fdn::kNegCap;

// semantics: 0 reference, 1 active_only (ops/kernels.py:_SEMANTICS), and 2,
// the masked logits themselves (inactive 0), with no softmax
constexpr int kActiveOnly = 1;
constexpr int kLogitsOnly = 2;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
// senones a warp takes at once: their weight loads are in flight together
constexpr int kInFlight = 4;
// 16-byte pieces of a weight row a lane loads at once (2 KB a senone at
// K = 2048 is one step)
constexpr int kSteps = 4;
// blocks per row: 16 (a non-portable cluster size) take the weight rows in
// on twice the SMs of the portable 8: 13.6 against 17.4 us a row at 40%
// masks on the H100 (PERF.md)
constexpr int kCluster = 16;

struct Shared {
  int warp_count[kWarps];
  float2 warp_stats[kWarps];
  float2 block_stats;  // read by every block of the cluster
  float2 row_stats;
};

__host__ __device__ constexpr int block_columns(int out_dim) {
  return (out_dim + kCluster - 1) / kCluster;
}
// dynamic shared memory: the row's activations (K bytes), then the logits
// of the block's columns and the list of its active ones
__host__ __device__ constexpr size_t dynamic_smem_bytes(int k, int out_dim) {
  return static_cast<size_t>(k) + 8 * static_cast<size_t>(block_columns(out_dim));
}

// the two halves of hp::cluster_sync, for work between them; the arrival
// is relaxed (no fence): it only says that the block's reads of the others'
// shared memory, whose values it has used, are done
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ int dot4(int4 w, int4 a, int acc) {
  acc = __dp4a(w.x, a.x, acc);
  acc = __dp4a(w.y, a.y, acc);
  acc = __dp4a(w.z, a.z, acc);
  return __dp4a(w.w, a.w, acc);
}

// The exact int32 products of the row's activations (acts, K / 16 pieces
// in shared memory) with the weight rows of senones cols[u] (-1: none), as
// every lane of the warp gets them.
__device__ __forceinline__ void senone_products(const int4* acts, const int8_t* wt, int K,
                                                const int (&cols)[kInFlight],
                                                int (&acc)[kInFlight], int lane) {
  const int pieces = K / 16;
  const int4* rows[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    rows[u] = reinterpret_cast<const int4*>(wt + static_cast<size_t>(max(cols[u], 0)) * K);
    acc[u] = 0;
  }
  for (int i0 = lane; i0 < pieces; i0 += 32 * kSteps) {
    int4 w[kInFlight][kSteps];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u)
#pragma unroll
      for (int t = 0; t < kSteps; ++t) {
        const int i = i0 + 32 * t;
        w[u][t] = cols[u] >= 0 && i < pieces ? __ldg(rows[u] + i) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
    for (int t = 0; t < kSteps; ++t) {
      const int i = i0 + 32 * t;
      if (i < pieces) {
        const int4 a = acts[i];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) acc[u] = dot4(w[u][t], a, acc[u]);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) acc[u] = __reduce_add_sync(0xffffffffu, acc[u]);
}

// (max, sum-exp) pairs of the lanes merged into lane 0 in a fixed tree, so
// that the same pairs give the same bits in any block
__device__ __forceinline__ float2 merge_lanes(float2 st) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float2 other = make_float2(__shfl_down_sync(0xffffffffu, st.x, o),
                                     __shfl_down_sync(0xffffffffu, st.y, o));
    st = rs::merge_stats(st, other);
  }
  return st;
}

template <bool ROWSCALE>
__global__ void __launch_bounds__(kThreads, 1)
    lazy_output_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                       const int* __restrict__ colsum, const float* __restrict__ bias,
                       float inv_scale, const uint8_t* __restrict__ mask, int mask_stride,
                       int semantics, float* __restrict__ out, int K, int out_dim,
                       const float* __restrict__ row_scale) {
  extern __shared__ int4 acts[];
  __shared__ Shared sh;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = static_cast<int>(hp::cluster_rank());
  const int row = blockIdx.x / kCluster;
  if constexpr (ROWSCALE) inv_scale = row_scale[row];
  const int per = block_columns(out_dim);
  const int c0 = min(out_dim, rank * per);
  const int c1 = min(out_dim, c0 + per);
  float* z = reinterpret_cast<float*>(reinterpret_cast<int8_t*>(acts) + K);  // logits of [c0, c1)
  int* list = reinterpret_cast<int*>(z + per);  // the active columns, in order
  const int4* x_row = reinterpret_cast<const int4*>(x + static_cast<size_t>(row) * K);
  for (int i = tid; i < K / 16; i += kThreads) acts[i] = x_row[i];  // ready at the first barrier
  const uint8_t* m_row = mask + static_cast<size_t>(row) * mask_stride;
  const float fill = semantics == kActiveOnly ? kNegCap : 0.0f;

  // the list, kThreads columns at a time; an inactive column's logit is the fill
  int count = 0;
  for (int base = c0; base < c1; base += kThreads) {
    const int c = base + tid;
    const bool in = c < c1;
    const bool active = in && m_row[c] != 0;
    if (in && !active) z[c - c0] = fill;
    const unsigned ballot = __ballot_sync(0xffffffffu, active);
    if (lane == 0) sh.warp_count[warp] = __popc(ballot);
    __syncthreads();
    int offset = count;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int n = sh.warp_count[w];
      offset += w < warp ? n : 0;
      count += n;
    }
    if (active) list[offset + __popc(ballot & ((1u << lane) - 1))] = c;
    __syncthreads();  // the list is complete; warp_count is the next pass's
  }

  // the active logits, kInFlight listed senones a warp at a time; every
  // lane gets the same logits and folds them into the warp's running
  // (max, sum-exp), which the other warps' loads hide
  float2 st = make_float2(-INFINITY, 0.0f);
  for (int e = warp * kInFlight; e < count; e += kWarps * kInFlight) {
    int cols[kInFlight], acc[kInFlight], cs[kInFlight];
    float b[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      cols[u] = e + u < count ? list[e + u] : -1;
      cs[u] = cols[u] >= 0 ? __ldg(colsum + cols[u]) : 0;
      b[u] = cols[u] >= 0 ? __ldg(bias + cols[u]) : 0.0f;
    }
    senone_products(acts, wt, K, cols, acc, lane);
    float v[kInFlight], top = -INFINITY;
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      v[u] = fdn::dequantize(acc[u], cs[u], inv_scale, b[u]);
      if (cols[u] >= 0) top = fmaxf(top, v[u]);
      if (lane == u && cols[u] >= 0) z[cols[u] - c0] = v[u];
    }
    const float m = fmaxf(st.x, top);
    float sum = st.y * expf(st.x - m);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) sum += cols[u] >= 0 ? expf(v[u] - m) : 0.0f;
    st = make_float2(m, sum);
  }
  if (lane == 0) sh.warp_stats[warp] = st;
  __syncthreads();  // the logits are in z, the warps' stats in sh
  float* o_row = out + static_cast<size_t>(row) * out_dim;
  if (semantics == kLogitsOnly) {  // before any block reads another's stats
    for (int c = c0 + tid; c < c1; c += kThreads) o_row[c] = z[c - c0];
    return;
  }
  if (warp == 0) {  // the warps' stats, then the inactive columns' fill, each once
    st = merge_lanes(lane < kWarps ? sh.warp_stats[lane] : make_float2(-INFINITY, 0.0f));
    const int inactive = c1 - c0 - count;
    if (inactive) st = rs::merge_stats(st, make_float2(fill, static_cast<float>(inactive)));
    if (lane == 0) sh.block_stats = st;
  }
  hp::cluster_sync();  // every block's stats are in its shared memory
  if (warp == 0) {  // the same tree over the blocks, so every block gets the same bits
    st = merge_lanes(lane < kCluster ? rs::load_cluster(&sh.block_stats, lane)
                                   : make_float2(-INFINITY, 0.0f));
    if (lane == 0) sh.row_stats = st;
  }
  cluster_arrive_relaxed();  // this block reads no other's shared memory from here
  __syncthreads();
  const float2 ms = sh.row_stats;
  for (int c = c0 + tid; c < c1; c += kThreads)
    o_row[c] = ms.x <= kEmptyRowMax ? 0.0f : expf(z[c - c0] - ms.x) / ms.y;  // no active senone: 0
  cluster_wait();  // no block leaves while another reads its stats
}

// The launch of `kernel` over `rows` clusters at input width k and output
// width out_dim; 16-block clusters allowed.
template <typename Kernel>
cudaError_t configure(Kernel kernel, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int rows,
                      int k, int out_dim, void* stream) {
  const size_t smem = dynamic_smem_bytes(k, out_dim);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) err = fdn::allow_smem(kernel, smem);
  *cfg = {};
  cfg->gridDim = dim3(rows * kCluster);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return err;
}

template <bool ROWSCALE>
cudaError_t launch(const void* x, const void* wt, const void* colsum, const void* bias,
                   float inv_scale, const void* mask, int mask_stride, int semantics, void* out,
                   int rows, int k, int out_dim, const void* row_scale, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure(lazy_output_kernel<ROWSCALE>, &cfg, &attr, rows, k, out_dim, stream);
  if (err == cudaSuccess)
    err = cudaLaunchKernelEx(&cfg, lazy_output_kernel<ROWSCALE>, static_cast<const int8_t*>(x),
                             static_cast<const int8_t*>(wt), static_cast<const int*>(colsum),
                             static_cast<const float*>(bias), inv_scale,
                             static_cast<const uint8_t*>(mask), mask_stride, semantics,
                             static_cast<float*>(out), k, out_dim,
                             static_cast<const float*>(row_scale));
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// Requires rows >= 1, K % 16 == 0, 16-byte aligned x and wt,
// 0 < out_dim <= N, mask_stride >= out_dim; semantics 0 reference,
// 1 active_only, 2 the masked logits (out holds them, inactive 0).
// row_scale: nullptr, or f32 [rows], each row's scale in place of
// inv_scale (the ROWSCALE variant).
extern "C" int fdn_lazy_output(const void* x, const void* wt, const void* colsum, const void* bias,
                               float inv_scale, const void* mask, int mask_stride, int semantics,
                               void* out, int rows, int k, int out_dim, const void* row_scale,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = row_scale ? launch<true>(x, wt, colsum, bias, inv_scale, mask, mask_stride, semantics,
                                   out, rows, k, out_dim, row_scale, stream)
                    : launch<false>(x, wt, colsum, bias, inv_scale, mask, mask_stride, semantics,
                                    out, rows, k, out_dim, row_scale, stream);
  return static_cast<int>(err);
}

// Shared memory of a block at input width k and output width out_dim:
// the wrapper holds it to the card's limit.
extern "C" long long fdn_lazy_output_smem_bytes(int k, int out_dim) {
  return static_cast<long long>(dynamic_smem_bytes(k, out_dim) + sizeof(Shared));
}

// Clusters the card seats at once at input width k and output width
// out_dim (-1 if it cannot tell).
extern "C" int fdn_lazy_output_max_clusters(int k, int out_dim, int device) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = 0;
  if (cudaSetDevice(device) != cudaSuccess ||
      configure(lazy_output_kernel<false>, &cfg, &attr, 64, k, out_dim, nullptr) != cudaSuccess ||
      cudaOccupancyMaxActiveClusters(&clusters, lazy_output_kernel<false>, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}
