// Hopper (sm_90a) building blocks of every int8 and TF32 kernel of the port:
// K2 and K5 (csrc/hidden_layer.cu, csrc/output_logits.cu, one kernel
// template below, streamed_layer_kernel), K3 (csrc/hidden_stack.cu), K4,
// K6 (csrc/resident_softmax.cu), K7 (csrc/hidden_layer_packed.cu), K8
// (csrc/flash_stats.cu) and K9 (csrc/input_layer.cu): mbarriers, TMA tensor
// copies (multicast across a thread-block cluster), int8 wgmma from
// shared-memory descriptors and TF32 wgmma with A from registers, register
// reallocation, the quantized-sigmoid epilogue of a hidden layer's tile,
// and the host side of a launch (tensor maps, cluster launches).  The
// row-softmax pieces K4, K6 and K8 share are in csrc/row_stats.cuh.
//
// Shape of the int8 kernels (K2-K8).  A block is three warpgroups and owns
// kFrames = 64 frames.  Their int8 activations sit whole in shared memory as
// the wgmma A operand (K3, K4, K6), or a 64 x 128-byte tile of them comes
// with each weight stage (K2, K5, K7, K8: any K).  Warpgroup 2 is the
// producer: one thread keeps a ring of kStageBytes weight stages (kTileN
// output columns x kStageK of K) full with TMA copies, in the order the
// tiles are consumed, across tiles and (K3) layers, never draining.
// Warpgroups 0 and 1 are consumers and take the output tiles in turn
// (ping-pong): while one runs a tile's products the other runs the previous
// tile's epilogue.  K2's, K3's, K5's and K7's blocks of a cluster (along
// frames) share each weight stage: every block copies 1 / cluster of it and
// multicasts that part to all, so L2 serves each stage once per cluster;
// each SM still receives every byte of it.  K4's, K6's and K8's blocks of a
// cluster share their frames instead and split the tiles, each streaming
// its own (a ring of CS = 1); K6 and K8 SKIP stream only the tiles their
// mask leaves active.  K7's stages are packed int4, which the producer
// warpgroup's other three warps widen to s8 in shared memory before the
// consumers read them.  K9 (f32 frames, TF32 products) keeps the three
// warpgroups and the barriers but runs a ring of its own: both consumers
// read every stage, for 64 frames each.
//
// Layout: both operands K-major in the 128-byte swizzle (TMA's
// CU_TENSOR_MAP_SWIZZLE_128B, wgmma layout type 1): a [rows x 128-byte] block
// keeps row r at r * 128 bytes with its 16-byte chunk c at chunk c ^ (r % 8),
// 8-row groups 1024 bytes apart; a 32-deep int8 (8-deep TF32) wgmma step is
// a 32-byte offset into the row.  The resident activations ([64 x K]) are
// K / 128 such blocks, written by the consumers themselves.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the library links no libcuda
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <utility>
#include <vector>

#include "common.cuh"

namespace fdn {
namespace hopper {

constexpr int kFrames = 64;          // rows of the block, one wgmma m64
constexpr int kConsumers = 2;        // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kConsumerThreads = 128 * kConsumers;
constexpr int kTileN = 128;          // output columns per tile: wgmma n128
constexpr int kStageK = 128;         // K bytes per stage: one swizzle row
constexpr int kStageBytes = kTileN * kStageK;
constexpr int kActBlockBytes = kFrames * kStageK;
constexpr int kAlign = 1024;         // the 128-byte swizzle repeats every 8 rows
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kConsumerBarrier = 1;  // named barrier of the consumer warpgroups

// ---------------------------------------------------------------------------
// device side
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  const unsigned a = smem_addr(p);
  return p + ((kAlign - (a & (kAlign - 1))) & (kAlign - 1));
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled block
__device__ __forceinline__ int swizzle128(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// rows [m0, m0 + kFrames) of a row-major int8 [*, K] matrix -> the swizzled
// A operand (K / 128 blocks of [kFrames x 128 bytes]), by `count` threads
__device__ __forceinline__ void load_frames(int8_t* acts, const int8_t* src, int m0, int K,
                                            int tid, int count) {
  const int chunks = K / 16;
  for (int i = tid; i < kFrames * chunks; i += count) {
    const int r = i / chunks, c = i % chunks;
    const int4 v = *reinterpret_cast<const int4*>(src + static_cast<size_t>(m0 + r) * K + c * 16);
    *reinterpret_cast<int4*>(acts + (c >> 3) * kActBlockBytes + swizzle128(r, c & 7)) = v;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned addr, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed.  A wait of more
// than kWaitLimitNs (the legitimate ones last microseconds) means a broken
// protocol: trap, so the launch fails instead of holding the card.
constexpr uint64_t kWaitLimitNs = 10'000'000'000ull;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const uint64_t start = global_ns();
  while (!mbar_try_wait(addr, parity)) {
    if (global_ns() - start > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// arrive on the barrier at the same offset in block `cta` of the cluster,
// releasing at block scope (as CUTLASS's cluster barriers do): enough to
// hand back a stage this thread's warpgroup has finished reading.  A
// cluster-scope release (.release.cluster) is a fence, and one per stage
// cost about 40% of the loop (PERF.md)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned cta) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_addr(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// every thread of every block of the cluster; not .aligned, so warps that
// diverged (the producer's idle lanes) may call it from their own branch
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// generic-proxy shared-memory writes -> visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kConsumerBarrier), "n"(kConsumerThreads) : "memory");
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// TMA: box (c0 = K byte, c1 = row) of `map` -> dst, completion on `bar`;
// with a mask, the same bytes land at the same offset in every block of the
// mask and complete on each one's barrier at `bar`'s offset
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                   int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major, 128-byte-swizzled operand at
// p: start >> 4, leading offset 1 (unused when swizzled), stride 1024 bytes
// between 8-row groups, layout type 1 (128-byte swizzle)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 128 s32, the warpgroup's accumulators) += A (64 x 32 s8) * B^T
// (B: 128 x 32 s8, K-major), or = with accumulate == false.  Thread t of the
// warpgroup holds, for q = 0..15, d[4q + e] at row 16 (t / 32) + (t % 32) / 4
// (+ 8 for e >= 2), column 8 q + 2 (t % 4) + e % 2.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, bool accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// d (64 x 128 f32) += A (64 x 8 tf32, registers) * B^T (B: 128 x 8 tf32,
// K-major in shared memory), or = with accumulate == false.  a[] holds, for
// thread t of the warpgroup, row r = 16 (t / 32) + (t % 32) / 4 and column
// c = t % 4 of A as a[0] = (r, c), a[1] = (r + 8, c), a[2] = (r, c + 4),
// a[3] = (r + 8, c + 4); d as in wgmma_s8.  The registers of a[] are read
// asynchronously: they must keep their values until the wgmma_wait that
// covers this product.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           bool accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(static_cast<int>(accumulate)));
}

// the f32 and register-operand counterparts of fence_acc
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// x rounded to TF32 (10 explicit mantissa bits), to nearest, ties away from
// zero; the 13 low bits of the result are zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// One weight stage ring, shared by a cluster, and the turn order of the two
// consumer warpgroups.  Stage i (counted over the whole launch) sits in slot
// i % S; full[slot] completes when its bytes have landed, empty[slot] when
// the consumer warpgroup of every block of the cluster has released it (a
// multicast stage is refilled in all blocks at once).  A barrier's phase is
// waited for by parity, so a waiter must never be more than one phase
// ahead: a warpgroup starts waiting for tile g's stages only once every
// stage of tile g - 1 has landed (turn[w], passed by the other warpgroup
// after its last full-wait), or, a whole tile ahead, it would take an older
// phase of a slot for its own.  The products of the two still overlap: a
// warpgroup's last stage and epilogue run beside the next tile's products.
template <int S, int CS>
struct Ring {
  uint64_t* bars;  // full[S], empty[S], turn[kConsumers]

  static constexpr size_t kBytes = (2 * S + kConsumers) * sizeof(uint64_t);
  __device__ __forceinline__ uint64_t* full(int slot) { return bars + slot; }
  __device__ __forceinline__ uint64_t* empty(int slot) { return bars + S + slot; }
  __device__ __forceinline__ uint64_t* turn(int w) { return bars + 2 * S + w; }

  __device__ __forceinline__ void init() {
    for (int s = 0; s < S; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CS);
    }
    for (int w = 0; w < kConsumers; ++w) mbar_init(turn(w), 1);
    fence_barrier_init();
  }

  // producer thread: wait for slot i % S to be free everywhere, then copy
  // this block's 1 / CS of stage i (rows row0 + [rank, rank + 1) * 128 / CS,
  // bytes k0 .. k0 + 127 of `map`) into it in every block of the cluster
  __device__ __forceinline__ void produce(int8_t* stages, const CUtensorMap* map, int i, int k0,
                                          int row0, unsigned rank) {
    const int slot = i % S;
    mbar_wait(empty(slot), ((i / S) & 1) ^ 1);
    mbar_arrive_expect_tx(full(slot), kStageBytes);
    copy_weight(stages, map, slot, k0, row0, rank);
  }

  // the same, with the block's own 64-frame activation tile of stage i
  // (bytes k0 .. k0 + 127 of rows m0 .. m0 + 63 of `act_map`) landing in
  // act_stages' slot beside it, on the same barrier (K2: the activations
  // stream with the weight instead of sitting in shared memory whole)
  __device__ __forceinline__ void produce(int8_t* stages, const CUtensorMap* map, int i, int k0,
                                          int row0, unsigned rank, int8_t* act_stages,
                                          const CUtensorMap* act_map, int m0) {
    const int slot = i % S;
    mbar_wait(empty(slot), ((i / S) & 1) ^ 1);
    mbar_arrive_expect_tx(full(slot), kStageBytes + kActBlockBytes);
    copy_weight(stages, map, slot, k0, row0, rank);
    tma_load(act_stages + slot * kActBlockBytes, act_map, full(slot), k0, m0);
  }

  __device__ __forceinline__ void copy_weight(int8_t* stages, const CUtensorMap* map, int slot,
                                              int k0, int row0, unsigned rank) {
    constexpr int kRows = kTileN / CS;
    int8_t* dst = stages + slot * kStageBytes + rank * kRows * kStageK;
    if constexpr (CS == 1) {
      tma_load(dst, map, full(slot), k0, row0);
    } else {
      tma_load_multicast(dst, map, full(slot), k0, row0 + rank * kRows,
                         static_cast<uint16_t>((1u << CS) - 1));
    }
  }

  // consumer warpgroup: stage i has landed
  __device__ __forceinline__ const int8_t* wait_full(const int8_t* stages, int i) {
    const int slot = i % S;
    mbar_wait(full(slot), (i / S) & 1);
    return stages + slot * kStageBytes;
  }

  // consumer warpgroup, after its products on stage i are complete: one
  // arrival on slot i % S's empty barrier in each block of the cluster
  __device__ __forceinline__ void release(int i, int thread_in_wg) {
    if constexpr (CS == 1) {
      if (thread_in_wg == 0) mbar_arrive(empty(i % S));
    } else {
      if (thread_in_wg < CS) mbar_arrive_cluster(empty(i % S), thread_in_wg);
    }
  }

  // warpgroup w before its n-th tile (tile w + kConsumers n): the previous
  // tile's stages have all landed
  __device__ __forceinline__ void wait_turn(int w, int n) {
    if (w == 0 && n == 0) return;
    mbar_wait(turn(w), (w == 0 ? n - 1 : n) & 1);
  }
  __device__ __forceinline__ void pass_turn(int w) { mbar_arrive(turn((w + 1) % kConsumers)); }
};

// Consumer warpgroup w's products for its n-th tile: d = A [64 x K] *
// W[tile]^T over K / 128 stages, stage first_stage + t for the t-th 128
// bytes of K.  Keeps one wgmma group in flight and releases each stage as
// soon as the products that read it are done.  A is `acts` whole ([64 x K]
// as K / 128 swizzled blocks) or, STREAMED, the activation tile that came
// with each stage (Ring::produce with act_stages = acts).
template <int S, int CS, bool STREAMED = false>
__device__ __forceinline__ void tile_products(int (&d)[64], Ring<S, CS>& ring,
                                              const int8_t* stages, const int8_t* acts, int K,
                                              int first_stage, int w, int n, int thread_in_wg) {
  const int steps = K / kStageK;
  ring.wait_turn(w, n);
  fence_acc(d);
  for (int t = 0; t < steps; ++t) {
    const int8_t* b = ring.wait_full(stages, first_stage + t);
    if (t == steps - 1 && thread_in_wg == 0) ring.pass_turn(w);
    const int8_t* a = STREAMED ? acts + (first_stage + t) % S * kActBlockBytes
                               : acts + t * kActBlockBytes;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kStageK / 32; ++ks)
      wgmma_s8(d, desc_sw128(a + ks * 32), desc_sw128(b + ks * 32), t > 0 || ks > 0);
    wgmma_commit();
    if (t > 0) {
      wgmma_wait<1>();
      ring.release(first_stage + t - 1, thread_in_wg);
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  ring.release(first_stage + steps - 1, thread_in_wg);
}

// One consumer warpgroup's tile of a quantized hidden layer's output: int8
// columns [n0, n0 + 128) of the block's 64 rows of `out` (row stride ld),
// from its accumulators: dequantize, then the quantized sigmoid through the
// block's table (fill_sigmoid_table), bitwise equal to the call.
__device__ __forceinline__ void layer_epilogue(const int (&d)[64], int8_t* out, int ld, int m0,
                                               int n0, const int* cs, const float* bl, float inv,
                                               const int8_t* table, int thread_in_wg) {
  const int warp = thread_in_wg / 32, lane = thread_in_wg % 32;
  const int col = n0 + 2 * (lane % 4);
  int8_t* o = out + static_cast<size_t>(m0 + warp * 16 + lane / 4) * ld + col;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const int n = col + 8 * q;
    const int2 c = *reinterpret_cast<const int2*>(cs + n);
    const float2 b = *reinterpret_cast<const float2*>(bl + n);
    char2 top, bottom;  // rows r and r + 8
    top.x = sigmoid_from_table(table, dequantize(d[4 * q], c.x, inv, b.x));
    top.y = sigmoid_from_table(table, dequantize(d[4 * q + 1], c.y, inv, b.y));
    bottom.x = sigmoid_from_table(table, dequantize(d[4 * q + 2], c.x, inv, b.x));
    bottom.y = sigmoid_from_table(table, dequantize(d[4 * q + 3], c.y, inv, b.y));
    *reinterpret_cast<char2*>(o + 8 * q) = top;
    *reinterpret_cast<char2*>(o + 8 * static_cast<size_t>(ld) + 8 * q) = bottom;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (the library
// links no libcuda)
__host__ inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static std::once_flag once;
  static EncodeTiled found = nullptr;
  static cudaError_t status = cudaSuccess;
  std::call_once(once, [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult query;
#if CUDART_VERSION >= 12050
    status = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                              cudaEnableDefault, &query);
#else
    status = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &query);
#endif
    if (status == cudaSuccess && (query != cudaDriverEntryPointSuccess || p == nullptr))
      status = cudaErrorSymbolNotFound;
    found = reinterpret_cast<EncodeTiled>(p);
  });
  *fn = found;
  return status;
}

// The tensor map of a row-major [rows, cols] matrix of `type` (elements of
// elem_bytes) at ptr, boxes of 128 bytes of a row x box_rows rows, 128-byte
// swizzle; elements past the extents read as zero.  A map is a pure function
// of its arguments, so a cached one is always right: each weight is encoded
// once, not at every launch.
__host__ inline cudaError_t tensor_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                                       uint32_t elem_bytes, uint64_t rows, uint64_t cols,
                                       uint32_t box_rows) {
  struct Entry {
    const void* ptr;
    CUtensorMapDataType type;
    uint64_t rows, cols;
    uint32_t box_rows;
    CUtensorMap map;
  };
  static std::mutex lock;
  static std::vector<Entry> cache;
  std::lock_guard<std::mutex> guard(lock);
  for (const Entry& e : cache) {
    if (e.ptr == ptr && e.type == type && e.rows == rows && e.cols == cols &&
        e.box_rows == box_rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kStageK / elem_bytes), box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  if (cache.size() >= 64) cache.clear();
  cache.push_back(Entry{ptr, type, rows, cols, box_rows, *map});
  return cudaSuccess;
}

// the map of a row-major int8 [rows, cols] matrix (boxes of 128 bytes x
// box_rows rows)
__host__ inline cudaError_t weight_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                                       uint64_t cols, uint32_t box_rows) {
  return tensor_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, rows, cols, box_rows);
}

// Launch `kernel` on `blocks` blocks of kThreads threads in clusters of
// `cluster` along x.
template <typename... Params, typename... Args>
__host__ inline cudaError_t launch_clustered(void (*kernel)(Params...), int blocks, int cluster,
                                             size_t smem, void* stream, Args&&... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// How many clusters of `cluster` blocks of `kernel` the card seats at once.
template <typename... Params>
__host__ inline int max_active_clusters(void (*kernel)(Params...), int cluster, size_t smem) {
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = -1;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess) return -1;
  return n;
}

// ---------------------------------------------------------------------------
// One layer on the streamed loop: s8 [B, K] x s8 [K, N] (the weight as Wt
// [N, K]) through an epilogue, K2's kernel (the quantized sigmoid) and K5's
// (f32 logits).  Block b is frame block b % frame_blocks of column split
// b / frame_blocks; a cluster's blocks are consecutive frame blocks of one
// split and share each weight stage by multicast.  The split takes tiles
// [split * tiles / splits, (split + 1) * tiles / splits): when the frame
// blocks are fewer than the SMs, the columns split over floor(SMs / frame
// blocks) blocks per frame block.  The activations do not sit in shared
// memory: a 64 x 128-byte tile of them comes with each weight stage,
// through the same ring and barrier, so K has no limit and the ring holds 8
// stages of 24 KB.
//
// Epilogue: `Out`, the output element; kSmemBytes, the block's shared
// memory beside the ring; prepare(extra, tid, count), by the consumer
// threads before their first tile; store(d, out, ld, m0, n0, colsum, bias,
// inv, extra, thread_in_wg), one consumer warpgroup's 64 x 128 output tile
// from its accumulators.
// ---------------------------------------------------------------------------
constexpr int kLayerStages = 8;

template <class Epilogue>
__host__ __device__ constexpr size_t streamed_layer_smem_bytes() {
  return kAlign + static_cast<size_t>(kLayerStages) * (kStageBytes + kActBlockBytes) +
         Ring<kLayerStages, 1>::kBytes + Epilogue::kSmemBytes;
}

template <class Epilogue, int CS>
__global__ void __launch_bounds__(kThreads, 1)
    streamed_layer_kernel(const __grid_constant__ CUtensorMap w_map,
                          const __grid_constant__ CUtensorMap x_map,
                          const int* __restrict__ colsum, const float* __restrict__ bias,
                          float inv_scale, typename Epilogue::Out* __restrict__ out, int K, int N,
                          int frame_blocks, int splits) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_smem(smem_raw);
  int8_t* stages = reinterpret_cast<int8_t*>(smem);
  int8_t* acts = stages + kLayerStages * kStageBytes;  // one activation tile per stage
  Ring<kLayerStages, CS> ring{reinterpret_cast<uint64_t*>(acts + kLayerStages * kActBlockBytes)};
  unsigned char* extra = reinterpret_cast<unsigned char*>(ring.bars) + Ring<kLayerStages, CS>::kBytes;

  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.x % frame_blocks * kFrames;
  const int split = blockIdx.x / frame_blocks;
  const int tiles = N / kTileN;
  const int first_tile = split * tiles / splits;
  const int my_tiles = (split + 1) * tiles / splits - first_tile;
  const int steps = K / kStageK;
  if (threadIdx.x == 0) ring.init();
  cluster_sync();

  if (wg == kConsumers) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x % 128 == 0) {
      const unsigned rank = cluster_rank();
      for (int g = 0; g < my_tiles; ++g)
        for (int t = 0; t < steps; ++t)
          ring.produce(stages, &w_map, g * steps + t, t * kStageK, (first_tile + g) * kTileN, rank,
                       acts, &x_map, m0);
    }
    cluster_sync();
  } else {
    reg_alloc<kConsumerRegs>();
    const int tw = threadIdx.x % 128;
    Epilogue::prepare(extra, threadIdx.x, kConsumerThreads);
    consumer_sync();
    int d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0;
    for (int g = wg, n = 0; g < my_tiles; g += kConsumers, ++n) {
      tile_products<kLayerStages, CS, true>(d, ring, stages, acts, K, g * steps, wg, n, tw);
      Epilogue::store(d, out, N, m0, (first_tile + g) * kTileN, colsum, bias, inv_scale, extra, tw);
    }
    cluster_sync();
  }
}

template <class Epilogue, int CS>
__host__ inline cudaError_t launch_streamed_layer(const void* x, const void* wt, const void* colsum,
                                                  const void* bias, float inv_scale, void* out,
                                                  int b, int k, int n, int sms, void* stream) {
  CUtensorMap w_map, x_map;
  cudaError_t err = weight_map(&w_map, wt, n, k, kTileN / CS);
  if (err == cudaSuccess) err = weight_map(&x_map, x, b, k, kFrames);
  if (err != cudaSuccess) return err;
  const int frame_blocks = b / kFrames;
  const int tiles = n / kTileN;
  const int splits = frame_blocks >= sms ? 1 : std::min(tiles, sms / frame_blocks);
  return launch_clustered(streamed_layer_kernel<Epilogue, CS>, frame_blocks * splits, CS,
                          streamed_layer_smem_bytes<Epilogue>(), stream, w_map, x_map,
                          static_cast<const int*>(colsum), static_cast<const float*>(bias),
                          inv_scale, static_cast<typename Epilogue::Out*>(out), k, n,
                          frame_blocks, splits);
}

// The launch of one layer on `device`'s stream in clusters of `cluster`
// (1 or 2) blocks.  Requires B % (64 * cluster) == 0, K % 128 == 0,
// N % 128 == 0, 16-byte aligned x and wt.
template <class Epilogue>
__host__ inline cudaError_t streamed_layer(const void* x, const void* wt, const void* colsum,
                                           const void* bias, float inv_scale, void* out, int b,
                                           int k, int n, int cluster, int device, void* stream) {
  int sms = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  switch (cluster) {
    case 1:
      return launch_streamed_layer<Epilogue, 1>(x, wt, colsum, bias, inv_scale, out, b, k, n, sms,
                                                stream);
    case 2:
      return launch_streamed_layer<Epilogue, 2>(x, wt, colsum, bias, inv_scale, out, b, k, n, sms,
                                                stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace hopper
}  // namespace fdn
