// The narrow bf16 body of kernel 1 (3x3 SAME conv + per-channel affine +
// optional ReLU on NHWC activations) for Hopper (sm_90a): bf16 calls with
// Cin % 8 == 0, 16-byte-aligned operands and few channels on one side
// (Cin <= 32 or Cout <= 32), of the widths that ops/kernels/conv_plan.py
// routes here (NARROW_SHAPES; plan body 4, "narrow").
//
// Part of the port of the TPU kernel conv3x3_affine_relu_pallas
// (jcfszxc_unet_tpu/ops/pallas/conv_fused.py, body _kernel); the other
// bodies are in conv3x3_affine_relu.cu and conv3x3_wgmma.cuh.  Function:
//   out = relu?(conv3x3_SAME(x, w) * scale + shift), f32 accumulation,
//   rounded to bf16 once.
//
// What bounds it.  A conv does 9 Cin Cout / (Cin + Cout) operations a
// byte: 144 at 32 -> 32, 36 at 8 -> 8, at most ~250 on these shapes, all
// below the H100's ~295 (989 TFLOP/s over 3.35 TB/s).  So bytes bound
// these convs: each input byte should come from device memory once, each
// output byte go back once, with enough loads and stores in flight.  The
// wgmma body, built for the compute-bound layers, takes 64 channels of one
// tap a K step (half or an eighth of it empty here), makes the channels or
// the pixels 64-row operands that these widths fill a half to an eighth
// of, and brings each input pixel into shared memory once a tap or a
// three-tap strip.
//
// Design:
//   * Persistent blocks, at most one an SM.  Each lays the call's weights
//     out once in shared memory, straight from w (Cout, 9, Cin), as the
//     products' B operand: (tap, k16 step, half, n, 8 channels), zero past
//     Cin and Cout, read through no-swizzle descriptors; no workspace and
//     no second launch.  Scale and shift go beside them.
//   * Tiles.  A tile is a TW x TH box of output pixels of one image (TW
//     and TH multiples of 8, 256 pixels, 128 at Cout > 32), walked along
//     W, then H, then the batch.  Its haloed input box, (TW + 2) x (TH + 2)
//     pixels of CK = 16 or 32 channels (a chunk; Cin > CK takes several),
//     comes in by one TMA load whose zero fill outside the tensor is the
//     SAME padding and pads Cin to the chunk.  The box lands as rows of
//     CK * 2 bytes, one a pixel, with TMA's 32- or 64-byte swizzle, which
//     is the K-major layout wgmma reads with the same swizzle.
//   * Taps.  The products are m64nNk16 wgmma with the pixels as M and N =
//     Cout rounded up to 8 (8, 16, 24, 32, 64 or 128), so no channel row
//     sits empty beyond that rounding.  An m64 block is an 8 x 8 block of
//     output pixels: 8 box rows of 8 pixels, the rows BW * CK * 2 bytes
//     apart (the descriptor's stride), so tap (dy, dx) of the block is the
//     descriptor at box pixel (y + dy) * BW + x + dx: nine fixed offsets
//     into one box.  The swizzle follows the absolute address bits for
//     TMA's writes and wgmma's reads alike (as the wgmma body's row strips
//     rely on: conv3x3_wgmma.cuh, smem_desc), so a block may start at any
//     pixel and its row groups lie any number of bytes apart.
//   * Warp roles.  Warp 8 is the producer: its lane 0 keeps the chunks'
//     boxes in flight.  Warps 0-7 are two consumer warpgroups; warpgroup g
//     takes the block's tiles g, g + 2, ... and has its own ring of two
//     stages (full and empty mbarriers), so neither ever waits on a stage
//     the other fills and one's epilogue runs under the other's products.
//   * Epilogue.  Scale, shift and ReLU in f32, rounded to bf16 once.
//     Where Cout % 8 == 0 the tile goes into the warpgroup's staging tile
//     (as the output map's boxes of up to 64 channels, with the swizzle of
//     their row width) and out by one TMA store a box, under the next
//     tile's loads and products; TMA clips what lies past the tensor.
//     Cout 17, 2 and 1 have rows that are not 16-byte multiples: they store
//     from registers.
//
// Every output is one sum in a fixed order (chunk, tap, k16 step), so a
// forward reproduces bit for bit.  Offsets into x and out are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_wgmma.cuh"

namespace narrow {

using wgmma_conv::bar_sync;
using wgmma_conv::bulk_commit;
using wgmma_conv::bulk_wait;
using wgmma_conv::bulk_wait_read;
using wgmma_conv::Divisor;
using wgmma_conv::fence_proxy_async;
using wgmma_conv::mbar_arrive;
using wgmma_conv::mbar_expect_tx;
using wgmma_conv::mbar_init;
using wgmma_conv::mbar_wait;
using wgmma_conv::pack_bf16x2;
using wgmma_conv::smem_u32;
using wgmma_conv::st_shared_u32;
using wgmma_conv::tma_load_4d;
using wgmma_conv::tma_store_4d;
using wgmma_conv::wgmma_commit;
using wgmma_conv::wgmma_fence;
using wgmma_conv::wgmma_wait;

constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int PRODUCER_WARP = 8;
constexpr int THREADS = CONSUMERS * 128 + 32;
constexpr int SPW = 2;           // stages a consumer warpgroup
constexpr int STAGES = CONSUMERS * SPW;
constexpr int BAR_STAGING = 1;   // named barriers 1, 2: a warpgroup's staging

// The sizes of an (N, CK) instance: N the products' width (Cout rounded up
// to 8), CK the channels of a chunk.
template <int N_, int CK_>
struct Cfg {
  static constexpr int N = N_, CK = CK_;
  static constexpr int MB = N >= 64 ? 2 : 4;  // m64 blocks a tile
  static constexpr int ROW = 2 * CK;           // bytes of a box pixel
  static constexpr int KS = CK / 16;           // k16 steps of a chunk
  // descriptor layout type: 3 = 32-byte swizzle, 2 = 64-byte
  static constexpr uint64_t LAYOUT = CK == 16 ? 3 : 2;
  static_assert(N % 8 == 0 && N >= 8 && N <= 128, "products' width");
  static_assert(CK == 16 || CK == 32, "chunk");
  static_assert(MB * N / 2 <= 128, "accumulators: at most 128 registers");
};

struct Params {
  int B, H, W, Cin, Cout;
  int tw, th, bw;          // tile TW x TH, box row BW = TW + 2 pixels
  Divisor tiles_w, tiles_h;
  int tiles;               // tiles_w * tiles_h * B
  int chunks;              // ceil(Cin / CK)
  int stage_bytes;         // a stage (1024-byte multiple)
  int box_bytes;           // what TMA writes a stage: BW (TH + 2) CK 2
  int staging_bytes;       // a warpgroup's staging tile (0: register stores)
  int relu;
  const uint16_t* w;       // (Cout, 9, Cin)
  const float* scale;
  const float* shift;
  __nv_bfloat16* out;      // (B, H, W, Cout)
};

// D (64 x N, f32) [+]= A (64 x 16, smem) * B (16 x N, smem)^T, both
// K-major bf16; scale_d 0 overwrites D.
template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma<8>(float (&d)[4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "%4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<24>(float (&d)[12], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %14, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11}, "
      "%12, %13, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t da,
                                          uint64_t db, int scale_d) {
  wgmma_conv::wgmma_m64nk16(d, da, db, scale_d);
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64], uint64_t da,
                                           uint64_t db, int scale_d) {
  wgmma_conv::wgmma_m64nk16(d, da, db, scale_d);
}

// Shared-memory matrix descriptor: start address, leading byte offset
// (no swizzle: between the two core matrices of a k16 step; swizzled: 16,
// unused), stride byte offset (between core matrices 8 rows apart), all
// >> 4, base offset 0, and the layout type.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

// Origin of tile t: x0, y0 of its box and its image b.
__device__ __forceinline__ void origin(const Params& p, int t, int& x0,
                                       int& y0, int& b) {
  const int q = p.tiles_w.div(t);
  const int bx = t - q * p.tiles_w.d;
  b = p.tiles_h.div(q);
  const int by = q - b * p.tiles_h.d;
  x0 = bx * p.tw;
  y0 = by * p.th;
}

template <int N, int CK>
__global__ void __launch_bounds__(THREADS, 1)
conv_kernel(const __grid_constant__ CUtensorMap map_x,
            const __grid_constant__ CUtensorMap map_out, const Params p) {
  using C = Cfg<N, CK>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[STAGES];
  __shared__ uint64_t empty[STAGES];
  // the ring, the two staging tiles, the weights, then scale and shift;
  // the ring and the staging tiles on 1024-byte (swizzle atom) boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const gring = smem_raw + (ring - raw);
  const uint32_t staging0 = ring + STAGES * p.stage_bytes;
  const uint32_t wts = staging0 + CONSUMERS * p.staging_bytes;
  const int KT = p.chunks * C::KS;  // k16 steps of a tap
  const int wbytes = 9 * KT * N * 32;
  float* const sc = reinterpret_cast<float*>(gring + (wts - ring) + wbytes);
  float* const sh = sc + N;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // The weights as the B operand: 16-byte unit i = ((tap * KT + ks) * 2 +
  // half) * N + n holds channels 16 ks + 8 half .. + 7 of output channel n
  // (zero past Cin and Cout), so a k16 step's two core-matrix columns are
  // N * 16 bytes apart and its row groups of 8 channels 128.
  const int units = 18 * KT * N;
  for (int i = threadIdx.x; i < units; i += THREADS) {
    const int n = i % N;
    const int r = i / N;
    const int tk = r >> 1;
    const int ks = tk % KT;
    const int tap = tk / KT;
    const int c = 16 * ks + 8 * (r & 1);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < p.Cout && c < p.Cin)
      v = __ldg(reinterpret_cast<const uint4*>(
          p.w + ((int64_t)n * 9 + tap) * p.Cin + c));
    *reinterpret_cast<uint4*>(gring + (wts - ring) + 16 * i) = v;
  }
  for (int i = threadIdx.x; i < N; i += THREADS) {
    sc[i] = i < p.Cout ? __ldg(p.scale + i) : 0.f;
    sh[i] = i < p.Cout ? __ldg(p.shift + i) : 0.f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival a warp of its warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the weights, for wgmma's reads
  __syncthreads();

  if (warp == PRODUCER_WARP) {
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_x))
                   : "memory");
      // local tile j goes to warpgroup j % 2, whose fills count it
      for (int j = 0, t = blockIdx.x; t < p.tiles; ++j, t += gridDim.x) {
        int x0, y0, b;
        origin(p, t, x0, y0, b);
        const int g = j & 1;
        for (int c = 0; c < p.chunks; ++c) {
          const int it = (j >> 1) * p.chunks + c;
          const int s = g * SPW + it % SPW;
          mbar_wait(&empty[s], ((it / SPW) & 1) ^ 1);
          mbar_expect_tx(&full[s], p.box_bytes);
          tma_load_4d(ring + s * p.stage_bytes, &map_x, &full[s], c * CK,
                      x0 - 1, y0 - 1, b);
        }
      }
    }
    return;
  }

  const int g = warp / 4;           // consumer warpgroup
  const int t = threadIdx.x % 128;  // thread in the warpgroup
  const int wq = t / 32;            // warp in the warpgroup
  const uint32_t staging = staging0 + g * p.staging_bytes;
  const int tw8 = p.tw / 8;
  const uint32_t sbo = p.bw * C::ROW;
  // first box pixel of m64 block mb (8 x 8 pixels, blocks along x first)
  int blk[C::MB];
#pragma unroll
  for (int mb = 0; mb < C::MB; ++mb)
    blk[mb] = (mb / tw8) * 8 * p.bw + (mb % tw8) * 8;
  const uint64_t da0 = desc(0, 16, sbo, C::LAYOUT);
  const uint64_t db0 = desc(wts, N * 16, 128, 0);

  float acc[C::MB][N / 2];
  for (int j = g, tl = blockIdx.x + g * gridDim.x; tl < p.tiles;
       j += CONSUMERS, tl += CONSUMERS * gridDim.x) {
    int prev = 0;
    for (int c = 0; c < p.chunks; ++c) {
      const int it = (j >> 1) * p.chunks + c;
      const int s = g * SPW + it % SPW;
      mbar_wait(&full[s], (it / SPW) & 1);
      const uint32_t a = ring + s * p.stage_bytes;
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int toff = (tap / 3) * p.bw + tap % 3;
#pragma unroll
        for (int k = 0; k < C::KS; ++k) {
          const uint64_t db =
              db0 + (((uint64_t)(tap * KT + c * C::KS + k) * N * 32) >> 4);
#pragma unroll
          for (int mb = 0; mb < C::MB; ++mb) {
            const uint32_t addr = a + (blk[mb] + toff) * C::ROW + 32 * k;
            wgmma<N>(acc[mb], da0 | ((addr & 0x3FFFF) >> 4), db,
                     (c > 0 || tap > 0 || k > 0) ? 1 : 0);
          }
        }
      }
      wgmma_commit();
      if (c > 0) {
        wgmma_wait<1>();  // the previous chunk's products have retired
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = s;
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Epilogue.  acc[mb][j * 4 + h * 2 + e] holds pixel (x0 + 8 (mb %
    // tw8) + lane / 4, y0 + 8 (mb / tw8) + 2 wq + h) and channel 8 j +
    // 2 (t % 4) + e.
    int x0, y0, b;
    origin(p, tl, x0, y0, b);
    const int n2 = 2 * (t % 4);
    if (p.staging_bytes) {
      // boxes of IN channels (rows of RB bytes), TMA's swizzle of that
      // width (swizzle_of): 16-byte chunk bits 4.. XOR address bits 7..,
      // none for rows of 16 or 48 bytes
      constexpr int IN = N < 64 ? N : 64;
      constexpr int RB = 2 * IN;
      constexpr uint32_t SWZ =
          RB == 32 || RB == 64 || RB == 128 ? RB / 16 - 1 : 0;
      const int px_tile = p.tw * p.th;
      if (t == 0) bulk_wait_read();  // the previous tile's stores
      bar_sync(BAR_STAGING + g, 128);
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int px = ((mb / tw8) * 8 + 2 * wq + h) * p.tw +
                         (mb % tw8) * 8 + lane / 4;
#pragma unroll
          for (int jn = 0; jn < N / 8; ++jn) {
            const int n = 8 * jn + n2;
            float v0 = fmaf(acc[mb][jn * 4 + h * 2], sc[n], sh[n]);
            float v1 = fmaf(acc[mb][jn * 4 + h * 2 + 1], sc[n + 1],
                            sh[n + 1]);
            if (p.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            const uint32_t lin = (n / IN) * (px_tile * RB) + px * RB +
                                 (n % IN) * 2;
            st_shared_u32(staging + (lin ^ (((lin >> 7) & SWZ) << 4)),
                          pack_bf16x2(v0, v1));
          }
        }
      fence_proxy_async();
      bar_sync(BAR_STAGING + g, 128);
      if (t == 0) {
#pragma unroll
        for (int q = 0; q < N / IN; ++q)
          tma_store_4d(&map_out, staging + q * (px_tile * RB), q * IN, x0,
                       y0, b);
        bulk_commit();
      }
    } else {
      const bool pairs = (p.Cout & 1) == 0;
#pragma unroll
      for (int mb = 0; mb < C::MB; ++mb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int xx = x0 + (mb % tw8) * 8 + lane / 4;
          const int yy = y0 + (mb / tw8) * 8 + 2 * wq + h;
          if (xx >= p.W || yy >= p.H) continue;
          __nv_bfloat16* row =
              p.out + (((int64_t)b * p.H + yy) * p.W + xx) * p.Cout;
#pragma unroll
          for (int jn = 0; jn < N / 8; ++jn) {
            const int n = 8 * jn + n2;
            if (n >= p.Cout) continue;
            float v0 = fmaf(acc[mb][jn * 4 + h * 2], sc[n], sh[n]);
            float v1 = fmaf(acc[mb][jn * 4 + h * 2 + 1], sc[n + 1],
                            sh[n + 1]);
            if (p.relu) {
              v0 = fmaxf(v0, 0.f);
              v1 = fmaxf(v1, 0.f);
            }
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(row + n) =
                  __floats2bfloat162_rn(v0, v1);
            } else {
              row[n] = __float2bfloat16_rn(v0);
              if (n + 1 < p.Cout) row[n + 1] = __float2bfloat16_rn(v1);
            }
          }
        }
    }
  }
  if (p.staging_bytes && t == 0) bulk_wait();
}

// Tiled bf16 map, zero fill out of bounds; dims and box innermost first,
// strides in bytes for dims 1.. .
int encode(CUtensorMap* map, const void* base, const cuuint64_t* dims,
           const cuuint64_t* strides, const cuuint32_t* box,
           CUtensorMapSwizzle swizzle) {
  const wgmma_conv::EncodeFn& e = wgmma_conv::encode_fn();
  if (!e.fn) return e.error;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const CUresult r = e.fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : wgmma_conv::kErrTensorMap + (int)r;
}

// TMA's swizzle for rows of `bytes` (16: none).
CUtensorMapSwizzle swizzle_of(int bytes) {
  return bytes == 32    ? CU_TENSOR_MAP_SWIZZLE_32B
         : bytes == 64  ? CU_TENSOR_MAP_SWIZZLE_64B
         : bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE;
}

inline int round1024(long long v) { return (int)((v + 1023) / 1024 * 1024); }

template <int N, int CK>
int launch_config(const wgmma_conv::Plan& pl, Params p, const void* x,
                  long long B, cudaStream_t stream) {
  using C = Cfg<N, CK>;
  if (pl.tw * pl.th != 64 * C::MB) return (int)cudaErrorInvalidValue;
  p.chunks = (p.Cin + CK - 1) / CK;
  p.box_bytes = p.bw * (p.th + 2) * CK * 2;
  p.stage_bytes = round1024(p.box_bytes);
  const int kt = p.chunks * C::KS;
  // conv_plan.narrow_smem
  const long long smem = 1024 + (long long)STAGES * p.stage_bytes +
                         (long long)CONSUMERS * p.staging_bytes +
                         9ll * kt * N * 32 + 8ll * N;
  if (smem != pl.smem) return (int)cudaErrorInvalidValue;

  CUtensorMap mx, mo = {};
  const cuuint64_t xd[4] = {(cuuint64_t)p.Cin, (cuuint64_t)p.W,
                            (cuuint64_t)p.H, (cuuint64_t)B};
  const cuuint64_t xs[3] = {(cuuint64_t)p.Cin * 2,
                            (cuuint64_t)p.W * p.Cin * 2,
                            (cuuint64_t)p.H * p.W * p.Cin * 2};
  const cuuint32_t xb[4] = {CK, (cuuint32_t)p.bw, (cuuint32_t)(p.th + 2), 1};
  int err = encode(&mx, x, xd, xs, xb, swizzle_of(2 * CK));
  if (err) return err;
  if (p.staging_bytes) {
    const int in = N < 64 ? N : 64;
    const cuuint64_t od[4] = {(cuuint64_t)p.Cout, (cuuint64_t)p.W,
                              (cuuint64_t)p.H, (cuuint64_t)B};
    const cuuint64_t os[3] = {(cuuint64_t)p.Cout * 2,
                              (cuuint64_t)p.W * p.Cout * 2,
                              (cuuint64_t)p.H * p.W * p.Cout * 2};
    const cuuint32_t ob[4] = {(cuuint32_t)in, (cuuint32_t)p.tw,
                              (cuuint32_t)p.th, 1};
    err = encode(&mo, p.out, od, os, ob, swizzle_of(2 * in));
    if (err) return err;
  }
  auto kern = conv_kernel<N, CK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<pl.grid_x, THREADS, (size_t)smem, stream>>>(mx, mo, p);
  return (int)cudaGetLastError();
}

}  // namespace narrow

// The narrow body on a plan of ops/kernels/conv_plan.narrow_plan: x (B, H,
// W, Cin), w (Cout, 9, Cin), out (B, H, W, Cout), bf16, contiguous, 16-byte
// aligned, Cin % 8 == 0.  Returns 0, the error of a refused tensor-map
// encode, shared-memory attribute or launch, or cudaErrorInvalidValue for a
// plan this body does not take: tiles that do not cover the output, a
// width or chunk without an instance, shared memory other than the plan's,
// or a tma_store flag other than Cout % 8 == 0.
int conv3x3_narrow_launch(const wgmma_conv::Plan& pl, const void* x,
                          const void* w, const float* scale,
                          const float* shift, void* out, long long B, int H,
                          int W, int Cin, int Cout, int relu,
                          cudaStream_t stream) {
  const long long tiles = (long long)pl.tiles_w * pl.tiles_h * pl.tiles_b;
  if (Cin % 8 || Cin < 8 || Cout < 1 || pl.bn != (Cout + 7) / 8 * 8 ||
      pl.tb != 1 || pl.tw % 8 || pl.th % 8 || pl.tw < 8 || pl.th < 8 ||
      pl.tw > 254 || pl.th > 254 || pl.stages != narrow::STAGES ||
      pl.strip || pl.cluster != 1 || pl.grid_y != 1 || pl.tiles_n != 1 ||
      pl.tiles_b != B || (long long)pl.tiles_w * pl.tw < W ||
      (long long)pl.tiles_h * pl.th < H || tiles > 0x7fffffff ||
      pl.grid_x < 1 || pl.grid_x > tiles || pl.tma_store != (Cout % 8 == 0) ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16 ||
      (pl.tma_store && reinterpret_cast<uintptr_t>(out) % 16))
    return (int)cudaErrorInvalidValue;
  narrow::Params p;
  p.B = (int)B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.tw = pl.tw;
  p.th = pl.th;
  p.bw = pl.tw + 2;
  p.tiles_w = wgmma_conv::make_divisor(pl.tiles_w);
  p.tiles_h = wgmma_conv::make_divisor(pl.tiles_h);
  p.tiles = (int)tiles;
  p.staging_bytes = pl.tma_store ? pl.tw * pl.th * Cout * 2 : 0;
  p.relu = relu;
  p.w = static_cast<const uint16_t*>(w);
  p.scale = scale;
  p.shift = shift;
  p.out = static_cast<__nv_bfloat16*>(out);
  // The (N, chunk) instances the plan may name (conv_plan.NARROW_INSTANCES).
#define CONV_NARROW_CONFIG(N_, CK_)                                       \
  if (pl.bn == N_ && pl.chunk == CK_)                                     \
    return narrow::launch_config<N_, CK_>(pl, p, x, B, stream);
  CONV_NARROW_CONFIG(8, 16)
  CONV_NARROW_CONFIG(8, 32)
  CONV_NARROW_CONFIG(16, 16)
  CONV_NARROW_CONFIG(16, 32)
  CONV_NARROW_CONFIG(24, 16)
  CONV_NARROW_CONFIG(24, 32)
  CONV_NARROW_CONFIG(32, 16)
  CONV_NARROW_CONFIG(32, 32)
  CONV_NARROW_CONFIG(64, 32)
  CONV_NARROW_CONFIG(128, 32)
#undef CONV_NARROW_CONFIG
  return (int)cudaErrorInvalidValue;
}
