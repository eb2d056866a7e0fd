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
// Bound: at B = 8320, K = N = 2048 the layer is 70 G int8 ops (0.035 ms at
// 1979 TOP/s) against ~19 MB of device-memory traffic.  Each packed stage
// brings half of K2's weight bytes for the same products, but in practice
// the loop follows its shared-memory traffic: per packed stage 32 KB land
// by TMA, the widening reads 16 KB and writes 32 KB, and the products read
// 48 KB, against 96 KB for the same work in K2 (PERF.md).
//
// K2's loop on csrc/hopper.cuh's warp-specialised shape, with one more step
// per stage.  The producer thread streams packed stages by TMA: 128 columns
// x 128 packed bytes (16 KB, one swizzle row; 256 logical K), multicast over
// a cluster of 2 blocks along frames as K2's, with the two 64 x 128-byte
// activation tiles those bytes multiply, x[:, p0 : p0+128] and
// x[:, K/2+p0 : K/2+p0+128], on the same barrier.  wgmma reads its B operand
// only from shared memory, so the producer warpgroup's three idle warps
// widen each packed stage there, in K2's 128-byte-swizzled layout (a nibble
// keeps its byte's offset, so the widening is elementwise): the high
// nibbles in place, the low ones into the slot's second 16 KB.  A slot (48
// KB; four fit) has three barriers: TMA landed (full), widened (ready),
// consumed (empty).  The widening bounded the loop while it sign-extended
// (four logic ops per 4 bytes), so a nibble v is widened to the u8 v + 8
// (one op), the products run s8 x u8, and each row then subtracts 8 x the
// sum of its
// activations over the same tiles, which a 64 x 8 wgmma against a tile of
// ones computes in each consumer warpgroup's first tile.  The consumers run
// K2's products twice per stage (lo activations x lo weights, hi x hi, one
// accumulator) and K2's epilogue.  When K/2 is not a multiple of 128 (K =
// 384, 128) TMA zero-fills the packed stage past K/2 (widened to 8, like
// every nibble 0), the lo activation tile reads real hi columns and the hi
// tile zeros past K; the row sums run over the same tiles, so the
// correction still leaves only the real weights.  When the frame blocks are
// fewer than the SMs, the column tiles split over floor(SMs / frame blocks)
// blocks per frame block, as K2's do.
#include <algorithm>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace hp = fdn::hopper;

constexpr int kWideners = 96;  // the producer warpgroup's warps 1-3

// A slot: the packed stage (by TMA; its high nibbles widened in place),
// the widened low nibbles, and the lo and hi activation tiles (by TMA)
constexpr int kSlotBytes = 2 * hp::kStageBytes + 2 * hp::kActBlockBytes;

// the B operand of the row-sum product: 8 rows of 128 ones
constexpr int kOnesBytes = 8 * hp::kStageK;

template <int S>
constexpr size_t smem_bytes() {
  return hp::kAlign + static_cast<size_t>(S) * kSlotBytes + kOnesBytes + hp::Ring<S, 1>::kBytes +
         S * sizeof(uint64_t) + fdn::kSigmoidTableBytes;
}

// The low / high nibble v in [-8, 7] of each byte of w as the u8 v + 8:
// v + 8 = nibble ^ 8.  One logic op (and a shift) per 4 bytes, against
// four for the sign-extended s8; the products subtract 8 x the activation
// row sums instead.
__device__ __forceinline__ unsigned widen_lo(unsigned w) { return (w & 0x0F0F0F0Fu) ^ 0x08080808u; }
__device__ __forceinline__ unsigned widen_hi(unsigned w) { return widen_lo(w >> 4); }

// d (64 x 128 s32) += A (64 x 32 s8) * B^T (B: 128 x 32 u8, K-major), as
// hp::wgmma_s8 with an unsigned B
__device__ __forceinline__ void wgmma_s8u8(int (&d)[64], uint64_t a, uint64_t b, bool accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.u8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),
        "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]),
        "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

// r (64 x 8 s32) += A (64 x 32 s8) * B^T (B: 8 x 32 s8): with B all ones,
// every column of r is the row sum of A; thread t of the warpgroup holds
// row 16 (t / 32) + (t % 32) / 4 in r[0], r[1] and that row + 8 in r[2],
// r[3], the rows of its d in wgmma_s8u8
__device__ __forceinline__ void wgmma_rowsum(int (&r)[4], uint64_t a, uint64_t b, bool accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)));
}

__device__ __forceinline__ void fence_rowsum(int (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Consumer warpgroup w's products for its n-th tile over `steps` packed
// stages from first_stage: d = x_lo * U_lo^T + x_hi * U_hi^T (U = W + 8,
// u8), as hp::tile_products, each stage waited for landed (its activation
// tiles came by TMA) and widened (ready), and released as soon as its
// products are done; then d -= 8 x the row sums rs.  ROWSUM (the
// warpgroup's first tile): the same activation tiles also go through
// wgmma_rowsum against `ones` into rs, which the later tiles reuse.
template <bool ROWSUM, int S, int CS>
__device__ __forceinline__ void packed_tile_products(int (&d)[64], int (&rs)[4],
                                                     hp::Ring<S, CS>& ring, uint64_t* ready,
                                                     const int8_t* slots, const int8_t* ones,
                                                     int steps, int first_stage, int w, int n,
                                                     int thread_in_wg) {
  ring.wait_turn(w, n);
  hp::fence_acc(d);
  fence_rowsum(rs);
  for (int t = 0; t < steps; ++t) {
    const int i = first_stage + t, slot = i % S;
    hp::mbar_wait(ring.full(slot), (i / S) & 1);
    hp::mbar_wait(ready + slot, (i / S) & 1);
    if (t == steps - 1 && thread_in_wg == 0) ring.pass_turn(w);
    const int8_t* hi = slots + slot * kSlotBytes;
    const int8_t* lo = hi + hp::kStageBytes;
    const int8_t* a = lo + hp::kStageBytes;
    hp::wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ks = 0; ks < hp::kStageK / 32; ++ks) {
        const uint64_t desc_a = hp::desc_sw128(a + h * hp::kActBlockBytes + ks * 32);
        wgmma_s8u8(d, desc_a, hp::desc_sw128((h ? hi : lo) + ks * 32), t > 0 || h > 0 || ks > 0);
        if constexpr (ROWSUM)
          wgmma_rowsum(rs, desc_a, hp::desc_sw128(ones + ks * 32), t > 0 || h > 0 || ks > 0);
      }
    hp::wgmma_commit();
    if (t > 0) {
      hp::wgmma_wait<1>();
      ring.release(i - 1, thread_in_wg);
    }
  }
  hp::wgmma_wait<0>();
  hp::fence_acc(d);
  fence_rowsum(rs);
  ring.release(first_stage + steps - 1, thread_in_wg);
  // x * W = x * U - 8 x (row sum of x over the same tiles)
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] -= 8 * rs[i & 2];
}

// Block b is frame block b % frame_blocks of column split b / frame_blocks;
// a cluster's blocks are consecutive frame blocks of one split.  The weight
// map views Wp as [N, K/2], the activation map x as [B, K].
template <int S, int CS>
__global__ void __launch_bounds__(hp::kThreads, 1)
    hidden_layer_packed_kernel(const __grid_constant__ CUtensorMap w_map,
                               const __grid_constant__ CUtensorMap x_map,
                               const int* __restrict__ colsum, const float* __restrict__ bias,
                               float inv_scale, int8_t* __restrict__ out, int K, int N,
                               int frame_blocks, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = hp::align_smem(smem_raw);
  int8_t* slots = reinterpret_cast<int8_t*>(smem);  // [S][packed / hi, lo, acts lo, acts hi]
  int8_t* ones = slots + S * kSlotBytes;
  hp::Ring<S, CS> ring{reinterpret_cast<uint64_t*>(ones + kOnesBytes)};
  uint64_t* ready = ring.bars + hp::Ring<S, CS>::kBytes / sizeof(uint64_t);  // widened, [S]
  int8_t* table = reinterpret_cast<int8_t*>(ready + S);

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x % frame_blocks * hp::kFrames;
  const int split = blockIdx.x / frame_blocks;
  const int tiles = N / hp::kTileN;
  const int first_tile = split * tiles / splits;
  const int my_tiles = (split + 1) * tiles / splits - first_tile;
  const int half = K / 2;
  const int steps = (half + hp::kStageK - 1) / hp::kStageK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) hp::mbar_init(ready + s, kWideners);
    ring.init();  // and the fence that publishes every barrier's init
  }
  hp::cluster_sync();

  if (wg == hp::kConsumers) {
    hp::reg_dealloc<hp::kProducerRegs>();
    const int pt = threadIdx.x % 128;
    if (pt == 0) {
      // packed stage i: bytes t * 128 .. of K/2 of tile g, i = g * steps + t.
      // The slots are kSlotBytes apart: the weight part is copied as
      // copy_weight would, at that stride
      const unsigned rank = hp::cluster_rank();
      constexpr int kRows = hp::kTileN / CS;
      for (int g = 0; g < my_tiles; ++g)
        for (int t = 0; t < steps; ++t) {
          const int i = g * steps + t, slot = i % S;
          hp::mbar_wait(ring.empty(slot), ((i / S) & 1) ^ 1);
          hp::mbar_arrive_expect_tx(ring.full(slot), hp::kStageBytes + 2 * hp::kActBlockBytes);
          int8_t* dst = slots + slot * kSlotBytes;
          const int row0 = (first_tile + g) * hp::kTileN;
          if constexpr (CS == 1) {
            hp::tma_load(dst, &w_map, ring.full(slot), t * hp::kStageK, row0);
          } else {
            hp::tma_load_multicast(dst + rank * kRows * hp::kStageK, &w_map, ring.full(slot),
                                   t * hp::kStageK, row0 + rank * kRows,
                                   static_cast<uint16_t>((1u << CS) - 1));
          }
          int8_t* a = dst + 2 * hp::kStageBytes;
          hp::tma_load(a, &x_map, ring.full(slot), t * hp::kStageK, m0);
          hp::tma_load(a + hp::kActBlockBytes, &x_map, ring.full(slot), half + t * hp::kStageK, m0);
        }
    } else if (pt >= 128 - kWideners) {
      // each thread reads its chunks of the packed stage and writes their
      // high nibbles back in place and their low nibbles beside
      const int wt = pt - (128 - kWideners);
      for (int i = 0; i < my_tiles * steps; ++i) {
        hp::mbar_wait(ring.full(i % S), (i / S) & 1);
        uint4* hi = reinterpret_cast<uint4*>(slots + (i % S) * kSlotBytes);
        uint4* lo = hi + hp::kStageBytes / 16;
#pragma unroll 2
        for (int c = wt; c < hp::kStageBytes / 16; c += kWideners) {
          const uint4 v = hi[c];
          lo[c] = make_uint4(widen_lo(v.x), widen_lo(v.y), widen_lo(v.z), widen_lo(v.w));
          hi[c] = make_uint4(widen_hi(v.x), widen_hi(v.y), widen_hi(v.z), widen_hi(v.w));
        }
        hp::fence_proxy_async();  // the widened bytes, for wgmma
        hp::mbar_arrive(ready + i % S);
      }
    }
    hp::cluster_sync();
  } else {
    hp::reg_alloc<hp::kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    fdn::fill_sigmoid_table(table, threadIdx.x, hp::kConsumerThreads);
    for (int i = threadIdx.x; i < kOnesBytes / 4; i += hp::kConsumerThreads)
      reinterpret_cast<int*>(ones)[i] = 0x01010101;
    hp::fence_proxy_async();
    hp::consumer_sync();
    int d[64], rs[4] = {};
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int g = wg, n = 0; g < my_tiles; g += hp::kConsumers, ++n) {
      if (n == 0)
        packed_tile_products<true>(d, rs, ring, ready, slots, ones, steps, g * steps, wg, n, tw);
      else
        packed_tile_products<false>(d, rs, ring, ready, slots, ones, steps, g * steps, wg, n, tw);
      hp::layer_epilogue(d, out, N, m0, (first_tile + g) * hp::kTileN, colsum, bias, inv_scale,
                         table, tw);
    }
    hp::cluster_sync();
  }
}

// four slots of 48 KB and the sigmoid table fit; five do not
constexpr int kSlots = 4;

template <int CS>
cudaError_t launch(const void* x, const void* wp, const void* colsum, const void* bias,
                   float inv_scale, void* out, int b, int k, int n, int sms, void* stream) {
  CUtensorMap w_map, x_map;
  cudaError_t err = hp::weight_map(&w_map, wp, n, k / 2, hp::kTileN / CS);
  if (err == cudaSuccess) err = hp::weight_map(&x_map, x, b, k, hp::kFrames);
  if (err != cudaSuccess) return err;
  const int frame_blocks = b / hp::kFrames;
  const int tiles = n / hp::kTileN;
  const int splits = frame_blocks >= sms ? 1 : std::min(tiles, sms / frame_blocks);
  return hp::launch_clustered(hidden_layer_packed_kernel<kSlots, CS>, frame_blocks * splits, CS,
                              smem_bytes<kSlots>(), stream, w_map, x_map,
                              static_cast<const int*>(colsum), static_cast<const float*>(bias),
                              inv_scale, static_cast<int8_t*>(out), k, n, frame_blocks, splits);
}

}  // namespace

// Requires B % (64 * cluster) == 0 (cluster 1 or 2), K % 128 == 0,
// N % 128 == 0, 16-byte aligned x and wp, and fdn_hidden_layer_packed_smem_bytes()
// within the block limit (checked by the wrapper).
extern "C" int fdn_hidden_layer_packed(const void* x, const void* wp, const void* colsum,
                                       const void* bias, float inv_scale, void* out, int b,
                                       int k, int n, int cluster, int device, void* stream) {
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (cluster) {
    case 1: return launch<1>(x, wp, colsum, bias, inv_scale, out, b, k, n, sms, stream);
    case 2: return launch<2>(x, wp, colsum, bias, inv_scale, out, b, k, n, sms, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" long long fdn_hidden_layer_packed_smem_bytes() {
  return static_cast<long long>(smem_bytes<kSlots>());
}
