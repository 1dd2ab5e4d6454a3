// The bf16 mainloop shared by both 3x3 conv kernels on Hopper (sm_90a): an
// implicit GEMM on wgmma with both operands brought in by TMA.
//
//   out[p, n] = act(sum_k A[p, k] * Bw[n, k]),  k = (tap, channel)
//
// M = output pixels, N = Cout, K = 9 taps x Cin channels.  A tile is BM
// output pixels (128 or 256) x BN output channels (64, 128 or 256); the
// pixels are a spatial box (TW, TH, TB) of the NHWC activations with
// TW * TH * TB = BM (powers of two), chosen by the caller's plan
// (ops/kernels/conv_plan.py).  K is walked in steps of BK = 64 channels of
// one tap:
//
//   * A: one TMA load of the 4-D box (64, TW, TH, TB) from a tensor map over
//     x (dims C, W, H, B) at (c0, x0 + dx - halo, y0 + dy - halo, b0).  The
//     box lands as BM rows of 128 bytes, which is a K-major BM x 64 tile
//     with the 128-byte swizzle for any box shape.  halo = 1 for unpadded x:
//     TMA fills coordinates outside the tensor with zeros, and that fill is
//     the SAME padding (no mask, no padded copy).  halo = 0 for the padded
//     copy xp of the im2col kernel.  Channels past C are zero-filled too, so
//     Cin need not be a multiple of 64.
//   * B: one TMA load of the box (64, 1, BN) from a 3-D map over the weights
//     laid out (Cout, 9, Cin) at (c0, tap, n0): it stops at the tap's last
//     channel (a flat (Cout, 9*Cin) map would run into the next tap's
//     weights whenever Cin % 64 != 0) and zero-fills past Cin and Cout.
//   * STRIP (rows of TW = 128 pixels): a stage holds the TH rows y0 + dy - 1
//     .. of 130 pixels, x0 - 1 .. x0 + 128, and the weights of the three taps
//     (dy, 0..2); tap dx multiplies the strip from row dx on.  A is then read
//     from L2 three times per output instead of nine.
//
// A block is persistent: it walks tiles blockIdx.x, + gridDim.x, ... (in a
// cluster, its cluster's tile groups; see CLUSTER below).  Warp 8
// is the producer: its lane 0 keeps a ring of STAGES stages in flight, each
// with a full and an empty mbarrier, tile after tile, K step after K step.
// Warps 0-7 are two consumer warpgroups, which multiply with
// wgmma.mma_async m64nBNk16 into f32 registers, keep one wgmma group in
// flight and free a stage once its group has retired.  Two schedules:
//
//   * cooperative (the four-stage 128 x 256 and 256 x 128 tiles of the
//     deep layers, Cin > 128 into Cout > 256 where the swapped boxes do
//     not take them): both warpgroups share each tile, warpgroup g taking
//     rows (BM/2)g .., and both store it from registers after its last K
//     step.  The tensor cores idle meanwhile;
//     at Cout > 128 a tile has 4-36x more K steps than its epilogue is
//     long.  (A three-stage form with a TMA store from a staging tile, the
//     fourth stage's room, ran 4-11 % slower and was dropped.)
//   * PINGPONG (the rest): each warpgroup owns whole tiles, warpgroup 0
//     the block's even local tiles and warpgroup 1 the odd ones, and waits
//     only on its own tiles' stages.  A pair of named barriers hands the
//     tensor cores over: warpgroup g issues tile j's products only after
//     the other one has issued tile j - 1's, so that the epilogue of one
//     tile runs while the other warpgroup's products are in flight.  The
//     turn also keeps the stage parities right: when a warpgroup waits on
//     a stage, every earlier fill of it has landed and the next cannot
//     start before this warpgroup frees it, so the full barrier is at most
//     one phase from the one waited for.  A warpgroup holds a whole tile's
//     accumulators: BM x BN <= 16384, 128 f32 registers a thread.
//   * SWAP (ping-pong, 64 channels a tile, Cout % 8 == 0; the plan takes
//     it up to Cout 256, and to 512 from Cin <= 256): the same schedule
//     with the operands' roles swapped,
//     D (channels x pixels) = W (64 x K) * X (pixels x K)^T: the
//     64 output channels are the wgmma's M and the tile's pixels its N, so
//     a K step is one m64n256k16 (or, for strips, one m64n128k16 a row)
//     instead of four m64n64k16.  Both operands stay K-major in the
//     same stages.  The epilogue writes the channels-by-pixels tile into
//     the staging tile transposed, with stmatrix .trans.
//
// CLUSTER (the cooperative schedule only, in the configurations that
// CONV_WGMMA_CONFIG marks; the plan takes it for the 128 x 256 tile into
// Cout >= 512 on maps at least 32 wide): a launch in clusters of two
// CTAs, launched with cudaLaunchKernelEx, walks groups of two pixel tiles
// of one Cout block in lockstep.  The two share the block's weights' box,
// which each loads BN / 2 rows of and multicasts by TMA into the same
// stage of both; each loads its own A box.  Each full barrier expects the
// whole stage's bytes as without a cluster.  A stage is refilled only
// once both CTAs have freed it: each consumer warp arrives on the empty
// barrier of both (mapa + a remote mbarrier.arrive, one lane each), and
// an empty barrier counts the warps of both.  A cluster barrier starts
// and ends the kernel, so that no CTA multicasts into its peer or arrives
// on its barriers before they exist or after it has left.  The last group
// along an odd count of pixel tiles holds a tile past the batch: its A
// loads are zeros, and store_registers' masks drop its stores.  Only the
// loads change, so each output is the same sum, bit for bit, with or
// without a cluster.
//
// The epilogue applies scale/shift (AFFINE) and the optional ReLU in f32
// and rounds to bf16 once.  The cooperative schedule, and PINGPONG where
// Cout % 8 != 0, store channel pairs from registers, masking rows outside
// the image or batch and channels past Cout.  PINGPONG with Cout % 8 == 0
// (the plan's tma_store) writes the tile into the warpgroup's own staging
// tile in shared memory as TMA's 128-byte swizzle lays it out (BN / 64 boxes of BM rows of 128
// bytes) and one thread stores each box with cp.async.bulk.tensor over a
// 4-D map of out (Cout, W, H, B); TMA drops what lies past the tensor,
// which replaces the masks.  The staging tile is written again only once
// the previous tile's stores have read it.
//
// Every output is one sum over the same K order whichever schedule or
// tile runs, so a forward reproduces bit for bit.
//
// What bounds it: at UNet's shapes the work is 2 * 9 * Cin flops per output
// value, far above the H100's ridge point, so the tensor cores' rate, which
// only wgmma reaches.  Below that, where Cout <= 128 and K is short, the
// operand bytes each stage pulls from L2 (tall tiles and strips cut them;
// so does a cluster's multicast, 48 -> 32 KB a K step of the 128 x 256
// tile) and the epilogue (which PINGPONG overlaps with the other
// warpgroup's products).  TMA moves the operands and the output with no
// thread spending an instruction or a register on the copy.
//
// Host side: the tensor maps are encoded per launch with
// cuTensorMapEncodeTiled (taken through the runtime's driver entry point, so
// nothing links libcuda) and passed as __grid_constant__ parameters.  Every
// refusal (entry point, encode, shared-memory attribute, launch) comes back
// as an error code; nothing is retried another way.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include <atomic>

namespace wgmma_conv {

constexpr int BK = 64;         // channels of one tap per K step: 128 bytes
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int PRODUCER_WARP = CONSUMERS * 4;
constexpr int THREADS = CONSUMERS * 128 + 32;

// Error codes beyond cudaError_t's range (see kernels_error_string).
constexpr int kErrEntryPoint = 10000;  // + cudaError_t of the lookup
constexpr int kErrTensorMap = 20000;   // + CUresult of the encode

// n / d for 0 <= n < 2^31 as (mulhi(n, mul) + n) >> shift, with shift =
// ceil(log2 d) and mul = floor(2^32 (2^shift - d) / d) + 1 worked out once
// on the host (make_divisor; the sum stays below 2^32 for n < 2^31).  The
// tile loops divide each tile index by three launch values, and a
// division by a value the compiler cannot see costs a reciprocal on the
// card at each tile: on the H100, UNet's 17 convs ran 2 % longer with
// them.  (Their registers cost the 256 x 64 ping-pong instance, at the
// register ceiling, 16 more bytes of spills a thread, which shows on
// calls of one tile a block: 2-3 % on the zoo's batch-2 convs.)
struct Divisor {
  int d;
  uint32_t mul;
  int shift;
  __device__ __forceinline__ int div(int n) const {
    return (int)((__umulhi((uint32_t)n, mul) + (uint32_t)n) >> shift);
  }
};

struct Params {
  int B, H, W, Cin, Cout;  // output geometry (H, W of the output)
  int tw_log, th_log, tb;  // box: TW = 1 << tw_log, TH = 1 << th_log
  Divisor tiles_w, tiles_h, tiles_n;
  int groups;              // tile groups: one tile a CTA of the cluster
  int halo;                // 1: unpadded x; 0: padded xp
  int relu;
  int tma_store;           // ping-pong: the epilogue stores through map_out
  const float* scale;      // AFFINE only
  const float* shift;
  __nv_bfloat16* out;      // (B, H, W, Cout)
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

// The wgmma body's schedules (conv_plan.SCHEDULES).
constexpr int SCHED_COOPERATIVE = 0, SCHED_PINGPONG = 1, SCHED_SWAP = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.  A wait that
// outlasts ~10 s of clock traps instead of hanging the device: the launch
// then fails with an error that the caller sees.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// The weights' load multicast: the box lands at offset `dst` of every CTA
// of the cluster in `mask` (bit r: cluster rank r), and each of them
// counts its bytes on its own barrier at offset `bar`.
__device__ __forceinline__ void tma_load_3d_mc(uint32_t dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               int c2, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The weights' box (or, CLUSTER, this CTA's rows of it, multicast into
// both CTAs of the pair) at (c0, tap, n0).
template <bool CLUSTER>
__device__ __forceinline__ void load_weights(uint32_t dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int c0, int tap,
                                             int n0) {
  if constexpr (CLUSTER)
    tma_load_3d_mc(dst, map, bar, c0, tap, n0, 0x3);
  else
    tma_load_3d(dst, map, bar, c0, tap, n0);
}

// One arrival on the barrier at `bar`'s offset in cluster CTA `rank`
// (the default semantics, release at the CTA's scope, as for a local
// arrival: what it orders is this thread's reads of the stage, which its
// wgmma_wait has completed, before the peer's next fill).
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: releases this thread's shared
// memory writes and barrier inits to the cluster, then waits for all.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::
          : "memory");
}

// Shared -> global: the 4-D box at (c0, c1, c2, c3) of `map`, clipped to
// the tensor, in the thread's bulk group.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Until the thread's committed bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Until the thread's committed bulk stores are complete.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Makes this thread's shared-memory writes visible to TMA (the async
// proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Four 8 x 8 bf16 matrices from a warp's registers, each stored
// transposed: r[i] of lane l holds row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1 of matrix i; lane 8 i + k gives the address of the
// 16-byte memory row k of matrix i, which receives the matrix's column k.
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};\n" ::"r"(addr),
      "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Named barriers (id 0 is __syncthreads): `count` threads, whole warps.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory matrix descriptor of a K-major tile stored as rows of 128
// bytes with the 128-byte swizzle (what TMA writes with SWIZZLE_128B): start
// address >> 4, leading byte offset 1 (unused for this layout), stride byte
// offset 1024 (8 rows) >> 4, base offset 0, layout type 1 (128-byte
// swizzle).  Stepping 16 k (32 bytes) inside a row adds 2 to the start
// address.  The swizzle is a function of the absolute shared-memory address
// (bits 4-6 XOR bits 7-9), for TMA's writes and wgmma's reads alike, so a
// window may start at any row of a 1024-byte-aligned tile with base offset
// 0: the strips' windows start at rows dx, 130 + dx, ...  (Setting the base
// offset to (address >> 7) & 7 there gave wrong products on the H100.)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x N, f32, registers) = A (64 x 16, smem) * B (16 x N, smem)^T
// [+ D when scale_d != 0]; both operands K-major bf16.
__device__ __forceinline__ void wgmma_m64nk16(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64nk16(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64nk16(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The tile of cluster CTA rm (of CM) in tile group g -> origin (x0, y0,
// b0) of its pixel box and first channel n0.  Group g holds pixel tiles
// (g / tiles_n) CM + rm of Cout block g % tiles_n; the Cout blocks vary
// fastest, so the blocks sharing an A box run side by side.  Without a
// cluster a group is one tile.  The last group may hold a pixel tile past
// the batch (b0 >= B).
template <int CM>
__device__ __forceinline__ void tile_origin(const Params& p, int g, int rm,
                                            int bn, int& x0, int& y0, int& b0,
                                            int& n0) {
  const int gm = p.tiles_n.div(g);
  const int nt = g - gm * p.tiles_n.d;
  const int m = gm * CM + rm;
  const int q = p.tiles_w.div(m);
  const int bx = m - q * p.tiles_w.d;
  const int bb = p.tiles_h.div(q);
  const int by = q - bb * p.tiles_h.d;
  x0 = bx << p.tw_log;
  y0 = by << p.th_log;
  b0 = bb * p.tb;
  n0 = nt * bn;
}

// Named barriers of the consumers (id 0 is __syncthreads).  PINGPONG:
// BAR_TURN + g lets warpgroup g issue its next tile's products, once the
// other warpgroup has issued its previous tile's (both warpgroups, 256
// threads); BAR_STAGING + g orders warpgroup g's writes to its staging
// tile around the TMA stores (128 threads).
constexpr int BAR_TURN = 1;
constexpr int BAR_STAGING = 3;

// The sizes of a (BM, BN, STAGES, STRIP, SCHED) configuration.
template <int BM_, int BN_, int STAGES_, bool STRIP_, int SCHED_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, STAGES = STAGES_;
  static constexpr bool STRIP = STRIP_;
  static constexpr bool PINGPONG = SCHED_ != SCHED_COOPERATIVE;
  static constexpr bool SWAP = SCHED_ == SCHED_SWAP;
  // rows of the A tile one consumer warpgroup multiplies, m64 blocks of it
  static constexpr int ROWS = PINGPONG ? BM : BM / CONSUMERS;
  static constexpr int MI = ROWS / 64;
  // The accumulators: AM wgmma blocks of 64 rows x AN columns.  Pixels x
  // channels: MI blocks of BN; SWAP, channels x pixels: one block of the
  // tile's pixels, or one a strip row (a row's 128 pixels are contiguous
  // in the stage, two rows are not).
  static constexpr int AM = SWAP ? (STRIP ? BM / 128 : 1) : MI;
  static constexpr int AN = SWAP ? BM / AM : BN;
  // A stage holds one tap's box and weights, or (STRIP) TH = BM / 128 rows
  // of 130 pixels and the weights of the taps (dy, 0..2).
  static constexpr int TAPS = STRIP ? 3 : 1;  // taps per stage
  static constexpr int A_TX = STRIP ? 130 * (BM / 128) * BK * 2 : BM * BK * 2;
  static constexpr int A_BYTES = (A_TX + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = BN * BK * 2;  // one tap
  static constexpr int STAGE_BYTES = A_BYTES + TAPS * B_BYTES;
  // a warpgroup's bf16 staging tile (PINGPONG): BN / 64 boxes of BM rows
  static constexpr int OUT_BYTES = PINGPONG ? BM * BN * 2 : 0;
  // dynamic shared memory a block: the ring, the staging tiles, and 1024
  // bytes to align the ring to the swizzle's atom
  static constexpr int SMEM =
      STAGES * STAGE_BYTES + CONSUMERS * OUT_BYTES + 1024;

  static_assert(BM == 128 || BM == 256, "tile rows");
  static_assert(BN == 64 || BN == 128 || BN == 256, "wgmma tile width");
  static_assert(MI >= 1 && AM * AN / 2 <= 128,
                "a warpgroup's accumulators: at most 128 registers");
  static_assert(!SWAP || BN == 64, "SWAP: the 64 channels are wgmma's M");
  static_assert(!STRIP || BM % 128 == 0, "strips are rows of 128 pixels");
  static_assert(STAGE_BYTES % 1024 == 0 && OUT_BYTES % 1024 == 0,
                "stages and staging tiles on swizzle-atom boundaries");
  static_assert(SMEM + 2 * STAGES * 8 <= 232448, "shared memory of a block");
};

// Frees stage s: lane 0's arrival on this CTA's empty barrier, and in a
// cluster lane 1's on the same barrier of the peer (`self`: this CTA's
// rank), whose producer fills this CTA's stages too, so that neither
// arrival waits on the other.  (The two issued one after another from
// lane 0 with release at the cluster's scope took each K step twice as
// long.)
template <bool CLUSTER>
__device__ __forceinline__ void free_stage(uint64_t* empty, int s, int lane,
                                           uint32_t self) {
  if (lane == 0) mbar_arrive(&empty[s]);
  if constexpr (CLUSTER) {
    if (lane == 1) mbar_arrive_remote(&empty[s], self ^ 1);
  }
}

// The K steps of one tile: waits for each stage (it = the ring's count of
// the tile's first step), issues its products into acc (rows row0 .. of
// the A tile), keeps one wgmma group in flight and frees a stage once its
// group has retired.  Returns the last stage, which the caller frees after
// wgmma_wait<0>.
template <class T, bool CLUSTER>
__device__ __forceinline__ int mainloop(float (&acc)[T::AM][T::AN / 2],
                                        uint32_t ring, uint64_t* full,
                                        uint64_t* empty, int it, int KT,
                                        int row0, int lane,
                                        uint32_t self) {
  int prev = 0;
  for (int kt = 0; kt < KT; ++kt, ++it) {
    const int s = it % T::STAGES;
    mbar_wait(&full[s], (it / T::STAGES) & 1);
    const uint32_t a = ring + s * T::STAGE_BYTES;
    const uint32_t b = a + T::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int dx = 0; dx < T::TAPS; ++dx)
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
#pragma unroll
        for (int mi = 0; mi < T::AM; ++mi) {
          // first A row of block mi: 64 pixels, or (SWAP) AN pixels as
          // wgmma's columns, the weights' 64 channels as its rows
          const int r0 = row0 + mi * (T::SWAP ? T::AN : 64);
          const int row = T::STRIP ? (r0 / 128) * 130 + r0 % 128 + dx : r0;
          const uint64_t dp = smem_desc(a + row * 128 + 32 * k);
          const uint64_t dw = smem_desc(b + dx * T::B_BYTES + 32 * k);
          wgmma_m64nk16(acc[mi], T::SWAP ? dw : dp, T::SWAP ? dp : dw,
                        (kt > 0 || dx > 0 || k > 0) ? 1 : 0);
        }
    wgmma_commit();
    if (kt > 0) {
      wgmma_wait<1>();  // the previous step's group has retired
      free_stage<CLUSTER>(empty, prev, lane, self);
    }
    prev = s;
  }
  return prev;
}

// The epilogue's f32 arithmetic on one pair of columns n, n + 1.
template <bool AFFINE>
__device__ __forceinline__ void affine_relu(const Params& p, int n, bool two,
                                            float& v0, float& v1) {
  if constexpr (AFFINE) {
    if (n < p.Cout) v0 = fmaf(v0, __ldg(p.scale + n), __ldg(p.shift + n));
    if (two) v1 = fmaf(v1, __ldg(p.scale + n + 1), __ldg(p.shift + n + 1));
  }
  if (p.relu) {
    v0 = fmaxf(v0, 0.f);
    v1 = fmaxf(v1, 0.f);
  }
}

// Epilogue from registers.  Accumulator [mi][j*4 + h*2 + e] holds row
// row0 + 64*mi + 16*(t/32) + (t%32)/4 + 8*h and column 8*j + 2*(t%4) + e
// of the tile (t: thread in the warpgroup); tile row r is box pixel
// (r >> (tw+th), (r >> tw) % TH, r % TW).
template <class T, bool AFFINE>
__device__ __forceinline__ void store_registers(
    const float (&acc)[T::AM][T::AN / 2], const Params& p, int x0, int y0,
    int b0, int n0, int row0, int t) {
  const int tw_mask = (1 << p.tw_log) - 1;
  const int th_mask = (1 << p.th_log) - 1;
  const bool pairs = (p.Cout & 1) == 0;  // 4-byte aligned bf16 pairs
#pragma unroll
  for (int mh = 0; mh < 2 * T::MI; ++mh) {
    const int mi = mh / 2;
    const int h = mh % 2;
    const int r = row0 + 64 * mi + 16 * (t / 32) + (t % 32) / 4 + 8 * h;
    const int xx = x0 + (r & tw_mask);
    const int yy = y0 + ((r >> p.tw_log) & th_mask);
    const int bb = b0 + (r >> (p.tw_log + p.th_log));
    if (xx >= p.W || yy >= p.H || bb >= p.B) continue;
    __nv_bfloat16* row =
        p.out + (((int64_t)bb * p.H + yy) * p.W + xx) * p.Cout;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (t % 4);
      if (n >= p.Cout) continue;
      const bool two = n + 1 < p.Cout;
      float v0 = acc[mi][j * 4 + h * 2];
      float v1 = acc[mi][j * 4 + h * 2 + 1];
      affine_relu<AFFINE>(p, n, two, v0, v1);
      if (two && pairs) {
        *reinterpret_cast<__nv_bfloat162*>(row + n) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        row[n] = __float2bfloat16_rn(v0);
        if (two) row[n + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// The bf16 tile into the warpgroup's staging tile, laid out as the output
// map's boxes: BN / 64 boxes of BM rows of 128 bytes in the tile's row
// order (which is the box's pixel order), 16-byte chunk c of row r at
// chunk c ^ (r % 8) (the 128-byte swizzle).  A warp's 4-byte writes of
// channel pairs cover 8 rows of one chunk column, which the swizzle
// spreads over all 32 banks.
template <class T, bool AFFINE>
__device__ __forceinline__ void stage_pairs(
    const float (&acc)[T::AM][T::AN / 2], const Params& p, uint32_t staging,
    int n0, int t) {
  const int sw = (t % 32) / 4;  // r % 8 of both of this thread's rows
#pragma unroll
  for (int mh = 0; mh < 2 * T::MI; ++mh) {
    const int mi = mh / 2;
    const int h = mh % 2;
    const int r = 64 * mi + 16 * (t / 32) + (t % 32) / 4 + 8 * h;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (t % 4);
      float v0 = acc[mi][j * 4 + h * 2];
      float v1 = acc[mi][j * 4 + h * 2 + 1];
      affine_relu<AFFINE>(p, n, n < p.Cout, v0, v1);
      st_shared_u32(staging + (j / 8) * (T::BM * 128) + r * 128 +
                        (((j % 8) ^ sw) << 4) + (t % 4) * 4,
                    pack_bf16x2(v0, v1));
    }
  }
}

// The same staging tile from SWAP's channels-by-pixels accumulators:
// [mb][j*4 + h*2 + e] holds channel 16*(t/32) + (t%32)/4 + 8*h and pixel
// AN*mb + 8*j + 2*(t%4) + e, so a warp holds 8 x 8 matrices (j, h) with
// the channels as rows and each thread needs the scale and shift of two
// channels only.  stmatrix .trans stores each matrix as 8 pixel rows of
// 8 channels, one 16-byte chunk of the staging row: lane l addresses row
// l % 8 of matrix l / 8 = (j - j0) * 2 + h, chunk 2*(t/32) + h of pixel
// AN*mb + 8*j + l % 8, at chunk ^ (pixel % 8); the 8 rows of a matrix
// land in 8 distinct chunk columns, all 32 banks.
template <class T, bool AFFINE>
__device__ __forceinline__ void stage_transposed(
    const float (&acc)[T::AM][T::AN / 2], const Params& p, uint32_t staging,
    int n0, int t) {
  const int lane = t % 32;
  const int k = lane % 8;
  const uint32_t chunk = ((2 * (t / 32) + (lane / 8) % 2) ^ k) << 4;
  float sc[2] = {1.f, 1.f}, sh[2] = {0.f, 0.f};
  if constexpr (AFFINE) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + 16 * (t / 32) + lane / 4 + 8 * h;
      if (n < p.Cout) {
        sc[h] = __ldg(p.scale + n);
        sh[h] = __ldg(p.shift + n);
      }
    }
  }
#pragma unroll
  for (int mb = 0; mb < T::AM; ++mb)
#pragma unroll
    for (int j0 = 0; j0 < T::AN / 8; j0 += 2) {
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i / 2;
        const int h = i % 2;
        float v0 = acc[mb][j * 4 + h * 2];
        float v1 = acc[mb][j * 4 + h * 2 + 1];
        if constexpr (AFFINE) {
          v0 = fmaf(v0, sc[h], sh[h]);
          v1 = fmaf(v1, sc[h], sh[h]);
        }
        if (p.relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        r[i] = pack_bf16x2(v0, v1);
      }
      const int pixel = T::AN * mb + 8 * (j0 + lane / 16) + k;
      stmatrix_x4_trans(staging + pixel * 128 + chunk, r);
    }
}

// Epilogue through the warpgroup's staging tile (ping-pong, Cout % 8 ==
// 0): once the previous tile's boxes have been read from it, the bf16
// tile goes in (stage_pairs, or stage_transposed for SWAP), and thread 0
// stores each box that starts below Cout with TMA.
template <class T, bool AFFINE>
__device__ __forceinline__ void store_tma(
    const float (&acc)[T::AM][T::AN / 2], const Params& p,
    const CUtensorMap* map_out, uint32_t staging, int x0, int y0, int b0,
    int n0, int wg, int t) {
  if (t == 0) bulk_wait_read();
  bar_sync(BAR_STAGING + wg, 128);
  if constexpr (T::SWAP)
    stage_transposed<T, AFFINE>(acc, p, staging, n0, t);
  else
    stage_pairs<T, AFFINE>(acc, p, staging, n0, t);
  fence_proxy_async();
  bar_sync(BAR_STAGING + wg, 128);
  if (t == 0) {
#pragma unroll
    for (int q = 0; q < T::BN / 64; ++q)
      if (n0 + 64 * q < p.Cout)
        tma_store_4d(map_out, staging + q * (T::BM * 128), n0 + 64 * q, x0,
                     y0, b0);
    bulk_commit();
  }
}

template <int BM, int BN, int STAGES, bool STRIP, int SCHED, bool AFFINE,
          bool CLUSTER>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_w,
            const __grid_constant__ CUtensorMap map_out, const Params p) {
  using T = Tile<BM, BN, STAGES, STRIP, SCHED>;
  constexpr bool PINGPONG = T::PINGPONG;
  static_assert(!CLUSTER || !PINGPONG, "clusters: the cooperative schedule");
  // CTAs a cluster: CLUSTER, two along the pixel tiles; without one, the
  // block is its own cluster
  constexpr int CM = CLUSTER ? 2 : 1;

  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES];
  __shared__ uint64_t empty[STAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this CTA's rank in its cluster, which its tile and its rows of the
  // shared weights' box follow
  const uint32_t rank = CLUSTER ? cluster_ctarank() : 0;
  const int cluster = blockIdx.x / CM;
  const int n_clusters = gridDim.x / CM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      // one arrival per warp of the warpgroups that multiply the stage, in
      // each CTA of the cluster (the producer fills them all)
      mbar_init(&empty[s], (PINGPONG ? 1 : CONSUMERS) * 4 * CM);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // no peer multicasts into this CTA or arrives on its barriers before
  // they are initialised
  if constexpr (CLUSTER)
    cluster_sync();
  else
    __syncthreads();

  const int chunks = (p.Cin + BK - 1) / BK;  // K steps per tap
  const int KT = (9 / T::TAPS) * chunks;

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_w))
                   : "memory");
      // rows of the weights' box this CTA loads (and multicasts)
      constexpr int WROWS = BN / CM;
      int it = 0;
      for (int g = cluster; g < p.groups; g += n_clusters) {
        int x0, y0, b0, n0;
        tile_origin<CM>(p, g, rank, BN, x0, y0, b0, n0);
        const int nw = n0 + rank * WROWS;
        for (int kt = 0; kt < KT; ++kt, ++it) {
          const int s = it % STAGES;
          mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          const int step = kt / chunks;  // tap, or the strip's dy
          const int c0 = (kt - step * chunks) * BK;
          const uint32_t a = ring + s * T::STAGE_BYTES;
          const uint32_t b = a + T::A_BYTES + rank * WROWS * 128;
          // the whole stage's bytes, whichever CTA loads them
          mbar_expect_tx(&full[s], T::A_TX + T::TAPS * T::B_BYTES);
          if constexpr (STRIP) {
            tma_load_4d(a, &map_x, &full[s], c0, x0 - p.halo,
                        y0 + step - p.halo, b0);
            for (int dx = 0; dx < 3; ++dx)
              load_weights<CLUSTER>(b + dx * T::B_BYTES, &map_w, &full[s], c0,
                                    3 * step + dx, nw);
          } else {
            const int dy = step / 3;
            const int dx = step - dy * 3;
            tma_load_4d(a, &map_x, &full[s], c0, x0 + dx - p.halo,
                        y0 + dy - p.halo, b0);
            load_weights<CLUSTER>(b, &map_w, &full[s], c0, step, nw);
          }
        }
      }
    }
  } else {
    const int wg = warp / 4;
    const int t = threadIdx.x % 128;  // thread in the warpgroup
    float acc[T::AM][T::AN / 2];
#pragma unroll
    for (int mi = 0; mi < T::AM; ++mi)
#pragma unroll
      for (int i = 0; i < T::AN / 2; ++i) acc[mi][i] = 0.f;
    if constexpr (PINGPONG) {
      // This block's tiles are j = 0 .. n_local - 1 (tile blockIdx.x + j *
      // gridDim.x, ring steps j * KT ..); warpgroup wg takes j = wg, wg + 2,
      // ...  Tile j waits for the other warpgroup to have issued tile
      // j - 1, and lets it start tile j + 1 once its own products are
      // issued: each bar_sync on BAR_TURN + wg meets exactly one
      // bar_arrive from the other warpgroup.
      const int n_local =
          (p.groups - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
      const uint32_t staging = ring + STAGES * T::STAGE_BYTES +
                               wg * T::OUT_BYTES;
      for (int j = wg; j < n_local; j += CONSUMERS) {
        if (j > 0) bar_sync(BAR_TURN + wg, CONSUMERS * 128);
        const int last = mainloop<T, CLUSTER>(acc, ring, full, empty, j * KT,
                                              KT, 0, lane, rank);
        if (j + 1 < n_local) bar_arrive(BAR_TURN + (wg ^ 1), CONSUMERS * 128);
        // the tile's origin, for the epilogue only: its divisions run under
        // the last products, not before the first
        int x0, y0, b0, n0;
        tile_origin<CM>(p, blockIdx.x + j * gridDim.x, 0, BN, x0, y0, b0, n0);
        wgmma_wait<0>();
        free_stage<CLUSTER>(empty, last, lane, rank);
        if constexpr (T::SWAP) {  // the launcher ensures p.tma_store
          store_tma<T, AFFINE>(acc, p, &map_out, staging, x0, y0, b0, n0, wg,
                               t);
        } else if (p.tma_store) {
          store_tma<T, AFFINE>(acc, p, &map_out, staging, x0, y0, b0, n0, wg,
                               t);
        } else {
          store_registers<T, AFFINE>(acc, p, x0, y0, b0, n0, 0, t);
        }
      }
      if (p.tma_store && t == 0) bulk_wait();
    } else {
      // Both warpgroups share each tile, warpgroup wg its rows wg * ROWS
      // .., and store them from registers after its last K step; the CTAs
      // of a cluster walk the same groups.
      int it = 0;
      for (int g = cluster; g < p.groups; g += n_clusters, it += KT) {
        const int last = mainloop<T, CLUSTER>(acc, ring, full, empty, it, KT,
                                              wg * T::ROWS, lane, rank);
        int x0, y0, b0, n0;
        tile_origin<CM>(p, g, rank, BN, x0, y0, b0, n0);
        wgmma_wait<0>();
        free_stage<CLUSTER>(empty, last, lane, rank);
        store_registers<T, AFFINE>(acc, p, x0, y0, b0, n0, wg * T::ROWS, t);
      }
    }
  }
  // no CTA leaves while its peer may still arrive on its barriers
  if constexpr (CLUSTER) {
    __syncwarp();
    cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct EncodeFn {
  PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  int error = 0;
};

// cuTensorMapEncodeTiled from the driver, looked up once per process.
inline const EncodeFn& encode_fn() {
  static const EncodeFn found = [] {
    EncodeFn e;
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess || !fn) {
      e.error = kErrEntryPoint + (err != cudaSuccess ? (int)err : 999);
    } else {
      e.fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
    }
    return e;
  }();
  return found;
}

// Tiled bf16 map with the 128-byte swizzle and zero fill out of bounds;
// dims and box innermost first, strides in bytes for dims 1.. .
inline int encode_map(CUtensorMap* map, const void* base, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box) {
  const EncodeFn& e = encode_fn();
  if (!e.fn) return e.error;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = e.fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap + (int)r;
}

// The launch plan, as computed by ops/kernels/conv_plan.py (ConvPlan.ints).
// schedule is the wgmma body's (SCHED_COOPERATIVE, SCHED_PINGPONG,
// SCHED_SWAP), tma_store whether its epilogue stores by TMA and cluster
// its CTAs a cluster (1 or 2); chunk and smem are the box bodies'
// (channels a K step, shared-memory bytes a block), which the wgmma body
// reads neither of.
struct Plan {
  int body, bm, tw, th, tb, bn, stages, strip, schedule, tma_store, cluster,
      grid_x, grid_y, tiles_w, tiles_h, tiles_b, tiles_n, chunk, smem;
};
constexpr int PLAN_INTS = 19;

inline Divisor make_divisor(int d) {
  Divisor v;
  int s = 0;
  while ((1ll << s) < d) ++s;
  v.d = d;
  v.shift = s;
  v.mul = (uint32_t)((((1ull << s) - d) << 32) / d + 1);
  return v;
}

inline int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (1 << l) == v ? l : -1;
}

// Launches one configuration, in clusters of `cluster` CTAs (1, or 2 where
// CLUSTERED: the configuration has a clustered instance).  A cluster
// launch sizes the persistent grid to the clusters the card holds at once
// (cudaOccupancyMaxActiveClusters, queried once per instance: it depends
// on the instance and its shared memory only), a multiple of the cluster;
// a refused cluster launch returns its error, and so does a failed query,
// at every call.
template <int BM, int BN, int STAGES, bool STRIP, int SCHED, bool AFFINE,
          bool CLUSTERED>
int launch_config(const CUtensorMap& mx, const CUtensorMap& mw,
                  const CUtensorMap& mo, const Params& p, int cluster,
                  int grid, cudaStream_t stream) {
  using T = Tile<BM, BN, STAGES, STRIP, SCHED>;
  if (cluster == 1) {
    auto kern = conv_kernel<BM, BN, STAGES, STRIP, SCHED, AFFINE, false>;
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    kern<<<grid, THREADS, T::SMEM, stream>>>(mx, mw, mo, p);
    return (int)cudaGetLastError();
  }
  if constexpr (!CLUSTERED) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (cluster != 2) return (int)cudaErrorInvalidValue;
    auto kern = conv_kernel<BM, BN, STAGES, STRIP, SCHED, AFFINE, true>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = T::SMEM;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    static std::atomic<int> active{0};  // clusters the card holds; 0: unknown
    int clusters = active.load(std::memory_order_relaxed);
    if (clusters == 0) {
      err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
      active.store(clusters, std::memory_order_relaxed);
    }
    cfg.gridDim = dim3((grid / 2 < clusters ? grid / 2 : clusters) * 2);
    void* args[] = {const_cast<CUtensorMap*>(&mx),
                    const_cast<CUtensorMap*>(&mw),
                    const_cast<CUtensorMap*>(&mo), const_cast<Params*>(&p)};
    err = cudaLaunchKernelExC(&cfg, (const void*)kern, args);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
}

// x: (B, Hx, Wx, C) bf16 with Hx, Wx = H, W (halo 1) or H+2, W+2 (halo 0);
// w: (Cout, 9, C) bf16; out: (B, H, W, Cout) bf16.  The plan's tma_store
// says whether out is stored by TMA (ping-pong plans with Cout % 8 == 0,
// TMA's 16-byte strides) or from registers, its cluster the CTAs a
// cluster.  Returns 0 or an error code; cudaErrorInvalidValue when the
// plan is not one this body takes, its tiles do not cover the output, its
// cluster is not 1, or 2 in a configuration instantiated with a cluster,
// with a grid of whole clusters, or its tma_store is not what the
// schedule, Cout and out's 16-byte alignment allow (a SWAP plan stores
// only by TMA).
template <bool AFFINE>
int launch(const Plan& pl, const void* x, const void* w, const float* scale,
           const float* shift, void* out, long long B, int H, int W, int C,
           int Cout, int halo, int relu, cudaStream_t stream) {
  const int tw_log = log2_exact(pl.tw);
  const int th_log = log2_exact(pl.th);
  if (tw_log < 0 || th_log < 0 || pl.tw * pl.th * pl.tb != pl.bm ||
      (pl.strip && (pl.tw != 128 || pl.tb != 1)) ||
      C % 8 != 0 || B > (1ll << 30) || pl.grid_y != 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  const long long tiles_m = (long long)pl.tiles_w * pl.tiles_h * pl.tiles_b;
  const long long tiles = tiles_m * pl.tiles_n;
  if (tiles > 0x7fffffff || pl.grid_x < 1 ||
      (long long)pl.tiles_w << tw_log < W || (long long)pl.tiles_h << th_log < H ||
      (long long)pl.tiles_b * pl.tb < B || (long long)pl.tiles_n * pl.bn < Cout)
    return (int)cudaErrorInvalidValue;
  if (pl.cluster < 1 || pl.cluster > 2 || pl.grid_x % pl.cluster != 0)
    return (int)cudaErrorInvalidValue;

  const int Hx = H + 2 * (1 - halo);
  const int Wx = W + 2 * (1 - halo);
  CUtensorMap mx, mw;
  const cuuint64_t xd[4] = {(cuuint64_t)C, (cuuint64_t)Wx, (cuuint64_t)Hx,
                            (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)C * 2, (cuuint64_t)Wx * C * 2,
                            (cuuint64_t)Hx * Wx * C * 2};
  const cuuint32_t xb[4] = {BK, (cuuint32_t)(pl.tw + (pl.strip ? 2 : 0)),
                            (cuuint32_t)pl.th, (cuuint32_t)pl.tb};
  int err = encode_map(&mx, x, 4, xd, xs, xb);
  if (err) return err;
  const cuuint64_t wd[3] = {(cuuint64_t)C, 9, (cuuint64_t)Cout};
  const cuuint64_t ws[2] = {(cuuint64_t)C * 2, (cuuint64_t)9 * C * 2};
  const cuuint32_t wb[3] = {BK, 1, (cuuint32_t)(pl.bn / pl.cluster)};
  err = encode_map(&mw, w, 3, wd, ws, wb);
  if (err) return err;
  CUtensorMap mo = {};
  const bool tma_store = pl.tma_store != 0;
  if (tma_store != (pl.schedule != SCHED_COOPERATIVE && Cout % 8 == 0) ||
      (tma_store && reinterpret_cast<uintptr_t>(out) % 16) ||
      (pl.schedule == SCHED_SWAP && !tma_store))
    return (int)cudaErrorInvalidValue;
  if (tma_store) {
    const cuuint64_t od[4] = {(cuuint64_t)Cout, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
    const cuuint64_t os[3] = {(cuuint64_t)Cout * 2, (cuuint64_t)W * Cout * 2,
                              (cuuint64_t)H * W * Cout * 2};
    const cuuint32_t ob[4] = {BK, (cuuint32_t)pl.tw, (cuuint32_t)pl.th,
                              (cuuint32_t)pl.tb};
    err = encode_map(&mo, out, 4, od, os, ob);
    if (err) return err;
  }

  Params p;
  p.B = (int)B;
  p.H = H;
  p.W = W;
  p.Cin = C;
  p.Cout = Cout;
  p.tw_log = tw_log;
  p.th_log = th_log;
  p.tb = pl.tb;
  p.tiles_w = make_divisor(pl.tiles_w);
  p.tiles_h = make_divisor(pl.tiles_h);
  p.tiles_n = make_divisor(pl.tiles_n);
  p.halo = halo;
  p.relu = relu;
  p.tma_store = tma_store;
  p.groups = (int)((tiles_m + pl.cluster - 1) / pl.cluster) * pl.tiles_n;
  p.scale = scale;
  p.shift = shift;
  p.out = static_cast<__nv_bfloat16*>(out);
  // The (BM, BN, stages, strip, schedule) configurations the plan may name
  // (conv_plan.WGMMA_CONFIGS), and whether each has a clustered instance
  // (conv_plan.CLUSTERED).
#define CONV_WGMMA_CONFIG(BM_, BN_, ST_, SP_, SC_, CL_)                    \
  if (pl.bm == BM_ && pl.bn == BN_ && pl.stages == ST_ && pl.strip == SP_ && \
      pl.schedule == SC_)                                                  \
    return launch_config<BM_, BN_, ST_, SP_, SC_, AFFINE, CL_>(            \
        mx, mw, mo, p, pl.cluster, pl.grid_x, stream);
  CONV_WGMMA_CONFIG(256, 128, 4, 0, 0, false)
  CONV_WGMMA_CONFIG(128, 256, 4, 0, 0, true)
  CONV_WGMMA_CONFIG(256, 64, 4, 0, 1, false)
  CONV_WGMMA_CONFIG(128, 64, 4, 1, 1, false)
  CONV_WGMMA_CONFIG(128, 128, 5, 0, 1, false)
  CONV_WGMMA_CONFIG(256, 64, 4, 0, 2, false)
  CONV_WGMMA_CONFIG(128, 64, 4, 1, 2, false)
#undef CONV_WGMMA_CONFIG
  return (int)cudaErrorInvalidValue;
}

}  // namespace wgmma_conv
