// Fused 3x3 SAME conv + per-channel affine (folded BatchNorm or bias) +
// optional ReLU, for NHWC activations on Hopper (sm_90a).
//
// Replaces the TPU kernel conv3x3_affine_relu_pallas
// (jcfszxc_unet_tpu/ops/pallas/conv_fused.py, body _kernel).  Function:
//   out = relu?(conv3x3_SAME(x, w) * scale + shift), f32 accumulation,
//   stored once in the activation dtype (float32 or bfloat16).
//
// Form: an implicit GEMM with M = B*H*W output pixels, N = Cout and
// K = 9*Cin ordered (tap, cin).  The weights come K-major, w (Cout, 9, Cin),
// so that row n of the GEMM's B operand is contiguous.  The out-of-image
// taps read zeros: no padded copy of x is made.
//
// Bound on the H100: at UNet's shapes the work is 2*9*Cin flops per output
// value, far above the card's ridge point, so the tensor cores' rate bounds
// the bf16 path, and only wgmma reaches it.  Four bodies, chosen by the
// caller's plan (ops/kernels/conv_plan.py) from dtype, Cin, Cout and
// alignment, and checked, each against its own tile:
//   * wgmma (bf16, Cin % 8 == 0, x and w 16-byte aligned: 17 of UNet's 18
//     convs): the TMA-fed, warp-specialised wgmma mainloop of
//     conv3x3_wgmma.cuh, whose TMA zero fill supplies the halo;
//   * narrow (the same bf16 calls with Cin <= 32 into Cout <= 128, or Cout
//     <= 32: the zoo's byte-bound convs, none of UNet's): conv3x3_narrow.cu,
//     one TMA-loaded haloed box of all the taps per tile and the weights
//     resident in shared memory;
//   * mma_sync (bf16, any other Cin or alignment: the Cin = 3 stem of every
//     model, MultiResUNet's odd widths plain and space-to-depth): TMA needs
//     16-byte global strides and a 3-channel pixel is 6 bytes, so this body
//     loads one haloed input box per tile into shared memory with its
//     channels padded to a multiple of 8, forms the nine taps as fixed
//     offsets into it and multiplies with ldmatrix + mma.sync (m16n8k16, and
//     m16n8k8 for an odd 8-channel group).  The stem is bound by its output
//     bytes (64 channels out of 3 in), so the epilogue stores each pixel's
//     channels as 16-byte words; the odd widths by operations, which the box
//     keeps from repeating its loads and divisions nine times;
//   * f32_box (every float32 call): on the CUDA cores, so f32 products stay
//     exact f32.  One haloed input box per tile in shared memory as channel
//     planes, fed by a 4-stage cp.async ring with zero fill, and each
//     thread's 16 pixels x 4 channels (8 x 8 in boxes 8 wide)
//     register-blocked over the three horizontal taps of a tap row
//     (namespace f32 below).
//
// Offsets into x and out are 64-bit: B*H*W*C passes 2^31 at UNet's shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "conv3x3_wgmma.cuh"

// The narrow body (bf16, Cin <= 32 or Cout <= 32): conv3x3_narrow.cu.
int conv3x3_narrow_launch(const wgmma_conv::Plan& pl, const void* x,
                          const void* w, const float* scale,
                          const float* shift, void* out, long long B, int H,
                          int W, int Cin, int Cout, int relu,
                          cudaStream_t stream);

namespace {

// Bodies, as numbered by ops/kernels/conv_plan.py.
enum Body { kF32Box = 1, kMmaSync = 2, kWgmma = 3, kNarrow = 4 };

// ---------------------------------------------------------------------------
// cp.async (both box bodies)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// 4 bytes, or zeros where `bytes` is 0 (nothing is read from src then).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// float32: one haloed input box per tile, a cp.async ring over channel
// chunks, register-blocked taps on the CUDA cores
// ---------------------------------------------------------------------------
//
// A tile is BM output pixels, a (TW, TH, TB) box of powers of two with TW a
// multiple of 8, by BN output channels.  Its input is the haloed box (TB,
// TH + 2, TW + 2) of x, brought into shared memory once per chunk of CK = 4
// channels as four channel planes, each box row TW + 4 floats (16-byte
// aligned rows).  Every box value is one 4-byte cp.async, zero-filled
// (source size 0) outside the image and past Cin, so the products read no
// bounds test; each input value is read from device memory once per tile,
// not once per tap.  Four neighbouring
// threads copy the four channels of one box pixel, so a warp's copy
// touches 8 pixels' 16-byte runs; each box pixel's source and plane offset
// are worked out once per tile into a table after the ring.
//
// The weights are laid out once per call by pad_weights into a workspace of
// (channel tile, chunk, 9, CK, BN) runs, zero past Cout and Cin: a stage's
// weights are one contiguous run that 16-byte cp.asyncs copy.  STAGES
// stages ring over the chunks, with one cp.async group and one barrier a
// chunk.
//
// Products.  A thread owns TM consecutive pixels of one box row by TN
// channels (4 * cg .. + 3, and for TN = 8 also BN / 2 + 4 * cg .. + 3, so a
// quarter-warp's 16-byte weight reads fall in distinct banks).  For each
// channel of the chunk and tap row dy it reads the TM + 2 box pixels
// x0 - 1 .. x0 + TM once (16-byte reads and one 8-byte read) and applies
// the three horizontal taps from registers, as slices [0..TM-1],
// [1..TM] and [2..TM+1]: at TM = 16, TN = 4, 5 + 3 shared-memory reads
// for 192 FFMAs (TM = 8, TN = 8: 3 + 6).  A warp is 8 channel groups by 4
// pixel groups, so its input reads are broadcasts.
//
// Epilogue: scale, shift and ReLU on the accumulators, each pixel's channels
// stored as 16-byte words (a warp writes 128 contiguous bytes a pixel)
// where Cout % 4 == 0, else one float at a time.  One accumulation order per
// output and no atomics: the result is bit-identical from call to call.
//
// Bound: 2 * 9 * Cin flops per output value against 4 * (Cin + Cout) bytes,
// so every UNet conv but the stem is bound by the FFMA pipe (67 TFLOP/s);
// products stay exact f32 (no TF32).

namespace f32 {

constexpr int THREADS = 256;  // 8 warps
constexpr int CK = 4;         // input channels a stage
constexpr int STAGES = 4;     // cp.async ring depth

// BM pixels (BM / TM pixel groups of TM consecutive pixels of a box row)
// by BN = TN * (THREADS / (BM / TM)) channels; PLANE floats a channel
// plane (TB (TH + 2) (TW + 4) at most), 8 mod 32, so the four planes that
// a unit's four threads write fall in distinct banks; then the box pixels'
// table, (source, offset) each.
template <int BM, int TM, int TN>
struct Cfg {
  static constexpr int BM_LOG = BM == 128 ? 7 : 8;
  static constexpr int PG = BM / TM;        // pixel groups
  static constexpr int CG = THREADS / PG;   // channel groups
  static constexpr int BN = CG * TN;
  static constexpr int WC = CG / 8;         // warps across the channel groups
  static constexpr int PLANE = BM == 128 ? 424 : 616;
  static constexpr int A_FLOATS = CK * PLANE;
  static constexpr int B_FLOATS = 9 * CK * BN;  // one (tile, chunk)
  static constexpr int STAGE = A_FLOATS + B_FLOATS;
  static constexpr int SMEM = STAGES * STAGE * 4 + PLANE * 8;
  static_assert((1 << BM_LOG) == BM && CG % 8 == 0 &&
                    (TN == 4 || TN == 8) && (TM == 8 || TM == 16),
                "tile layout");
  static_assert(PLANE % 32 == 8, "plane banks");
  static_assert(2 * (SMEM + 1024) <= 228 * 1024, "two blocks an SM");
};

struct Params {
  const float* x;      // (B, H, W, Cin)
  const float* wp;     // the laid-out weights (tiles_n, chunks, 9, CK, BN)
  const float* scale;
  const float* shift;
  float* out;          // (B, H, W, Cout)
  int B, H, W, Cin, Cout;
  int tw_log, th_log, tb;  // box: TW = 1 << tw_log, TH = 1 << th_log
  int rs;                  // floats a box row: TW + 4
  int tiles_w, tiles_h, tiles_n;
  int chunks;              // ceil(Cin / CK)
  int relu;
  int vec_out;             // Cout % 4 == 0 and out 16-byte aligned
};

template <int BM, int TM, int TN>
__global__ void __launch_bounds__(THREADS, 2) conv_kernel(const Params p) {
  using C = Cfg<BM, TM, TN>;
  extern __shared__ __align__(16) float f32_smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int TH = 1 << p.th_log;
  const int BW = (1 << p.tw_log) + 2;
  const int BH = TH + 2;

  // The tile: channel tile fastest, so the blocks that read one box run
  // together.
  int t = blockIdx.x;
  const int nt = t % p.tiles_n;
  t /= p.tiles_n;
  const int x0 = (t % p.tiles_w) << p.tw_log;
  t /= p.tiles_w;
  const int y0 = (t % p.tiles_h) << p.th_log;
  const int b0 = t / p.tiles_h * p.tb;
  const int n0 = nt * C::BN;

  // The box pixels' table, after the ring: the pixel of x each copies (-1
  // outside the image) and its offset in a plane, fixed over the chunks.
  int2* tab = reinterpret_cast<int2*>(f32_smem + STAGES * C::STAGE);
  const int box_px = p.tb * BH * BW;
  for (int e = tid; e < box_px; e += THREADS) {
    const int r = e / BW;
    const int px = e - r * BW;
    const int pb = r / BH;
    const int py = r - pb * BH;
    const int xx = x0 - 1 + px;
    const int yy = y0 - 1 + py;
    const int bb = b0 + pb;
    const bool in = bb < p.B && (unsigned)yy < (unsigned)p.H &&
                    (unsigned)xx < (unsigned)p.W;
    tab[e] = make_int2(in ? (bb * p.H + yy) * p.W + xx : -1, r * p.rs + px);
  }
  __syncthreads();

  const uint32_t ring = wgmma_conv::smem_u32(f32_smem);
  // Chunk k into stage `slot`: channel lc of box pixels tid / 4, + 64, ...
  // (a unit), then the weights.
  const int lc = tid & (CK - 1);
  auto load = [&](int k, int slot) {
    const uint32_t sa = ring + slot * (C::STAGE * 4);
    const uint32_t sp = sa + lc * (C::PLANE * 4);
    const int ch = k * CK + lc;
    for (int e = tid / CK; e < box_px; e += THREADS / CK) {
      const int2 t = tab[e];
      const bool ok = t.x >= 0 && ch < p.Cin;
      cp_async4(sp + t.y * 4, ok ? p.x + (int64_t)t.x * p.Cin + ch : p.x,
                ok ? 4 : 0);
    }
    const float* wsrc = p.wp + ((int64_t)nt * p.chunks + k) * C::B_FLOATS;
    const uint32_t sb = sa + C::A_FLOATS * 4;
    for (int i = tid; i < C::B_FLOATS / 4; i += THREADS)
      cp_async16(sb + 16 * i, wsrc + 4 * i);
  };

  // Products: pixel group pg (TM consecutive pixels of one box row, the
  // groups numbered down the tile's rows first, so that a warp's four
  // groups read four rows, in distinct banks), channel group cg.
  const int cg = (warp % C::WC) * 8 + (lane & 7);
  const int pg = (warp / C::WC) * 4 + (lane >> 3);
  const int rows_log = C::BM_LOG - p.tw_log;  // tile rows: TB * TH
  const int row = pg & ((1 << rows_log) - 1);  // (image, y) in the box
  const int xl = (pg >> rows_log) * TM;
  const int bl = row >> p.th_log;
  const int yl = row & (TH - 1);
  // top-left tap of the thread's first pixel, and its weights' column
  const int a_off = (bl * BH + yl) * p.rs + xl;
  const int b_off = 4 * cg;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < p.chunks) load(s, s);
    cp_async_commit();
  }
  for (int k = 0; k < p.chunks; ++k) {
    cp_async_wait<STAGES - 2>();  // chunk k has landed (this thread's part)
    __syncthreads();              // everyone's part; chunk k - 1 is read
    if (k + STAGES - 1 < p.chunks)
      load(k + STAGES - 1, (k + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* as = f32_smem + (k % STAGES) * C::STAGE + a_off;
    const float* bs =
        f32_smem + (k % STAGES) * C::STAGE + C::A_FLOATS + b_off;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* ap = as + c * C::PLANE + dy * p.rs;
        float a[TM + 2];
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(ap + 4 * q);
          a[4 * q] = v.x;
          a[4 * q + 1] = v.y;
          a[4 * q + 2] = v.z;
          a[4 * q + 3] = v.w;
        }
        const float2 v = *reinterpret_cast<const float2*>(ap + TM);
        a[TM] = v.x;
        a[TM + 1] = v.y;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* bp = bs + ((dy * 3 + dx) * CK + c) * C::BN;
          float b[TN];
          const float4 lo = *reinterpret_cast<const float4*>(bp);
          b[0] = lo.x;
          b[1] = lo.y;
          b[2] = lo.z;
          b[3] = lo.w;
          if constexpr (TN == 8) {
            const float4 hi =
                *reinterpret_cast<const float4*>(bp + C::BN / 2);
            b[4] = hi.x;
            b[5] = hi.y;
            b[6] = hi.z;
            b[7] = hi.w;
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i + dx], b[j], acc[i][j]);
        }
      }
    }
  }

  // Epilogue: this thread's channels n0 + nb + e (nb = 4 cg, and for TN = 8
  // also BN / 2 + 4 cg) of its TM pixels.
  const int oy = y0 + yl;
  const int ob = b0 + bl;
  if (oy >= p.H || ob >= p.B) return;
  float sc[TN], sh[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + (j >> 2) * (C::BN / 2) + b_off + (j & 3);
    sc[j] = n < p.Cout ? __ldg(p.scale + n) : 0.f;
    sh[j] = n < p.Cout ? __ldg(p.shift + n) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int ox = x0 + xl + i;
    if (ox < p.W) {
      float* dst = p.out + ((int64_t)(ob * p.H + oy) * p.W + ox) * p.Cout + n0;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const int nb = h * (C::BN / 2) + b_off;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = fmaf(acc[i][4 * h + e], sc[4 * h + e], sh[4 * h + e]);
          if (p.relu) v[e] = fmaxf(v[e], 0.f);
        }
        if (p.vec_out && n0 + nb + 4 <= p.Cout) {
          *reinterpret_cast<float4*>(dst + nb) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n0 + nb + e < p.Cout) dst[nb + e] = v[e];
        }
      }
    }
  }
}

// The weights w (Cout, 9, Cin) laid out as the stages read them: wp
// (tiles_n, chunks, 9, CK, bn), zero past Cout and Cin.  Element i is taken
// in (tile, chunk, tap, n, c) order, c fastest, so that neighbouring threads
// read one output channel's CK consecutive weights and a warp writes 8
// consecutive floats of each of CK rows.
__global__ void pad_weights(const float* __restrict__ w,
                            float* __restrict__ wp, int Cin, int Cout,
                            int chunks, int bn, int64_t total) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = i / CK;
    const int c = (int)(i - r * CK);
    const int n = (int)(r % bn);
    r /= bn;
    const int tap = (int)(r % 9);
    r /= 9;  // tile * chunks + chunk
    const int k = (int)(r % chunks);
    const int nn = (int)(r / chunks) * bn + n;
    const int cin = k * CK + c;
    wp[((r * 9 + tap) * CK + c) * bn + n] =
        nn < Cout && cin < Cin ? w[((int64_t)nn * 9 + tap) * Cin + cin]
                               : 0.f;
  }
}

template <int BM, int TM, int TN>
int launch_config(const wgmma_conv::Plan& pl, Params p, const float* w,
                  void* workspace, long long workspace_bytes,
                  cudaStream_t stream) {
  using C = Cfg<BM, TM, TN>;
  const long long ws = (long long)p.tiles_n * p.chunks * C::B_FLOATS;
  if (pl.smem != C::SMEM || pl.tw < TM || workspace_bytes < 4 * ws ||
      reinterpret_cast<uintptr_t>(workspace) % 16 ||
      (long long)p.tb * ((1 << p.th_log) + 2) * p.rs > C::PLANE)
    return (int)cudaErrorInvalidValue;
  p.wp = static_cast<const float*>(workspace);
  const long long blocks = (ws + 255) / 256 < 4096 ? (ws + 255) / 256 : 4096;
  pad_weights<<<(unsigned)blocks, 256, 0, stream>>>(
      w, static_cast<float*>(workspace), p.Cin, p.Cout, p.chunks, C::BN, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kern = conv_kernel<BM, TM, TN>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<pl.grid_x, THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// workspace: at least 4 * tiles_n * chunks * 9 * CK * BN bytes, 16-byte
// aligned (conv_plan.box_workspace_bytes).  Returns 0 or an error code;
// cudaErrorInvalidValue when the plan is not one this body takes, its
// tiles do not cover the output, its box overflows a plane or the workspace
// is too small.
int launch(const wgmma_conv::Plan& pl, const float* x, const float* w,
           const float* scale, const float* shift, float* out, long long B,
           int H, int W, int Cin, int Cout, int relu, void* workspace,
           long long workspace_bytes, cudaStream_t stream) {
  const int tw_log = wgmma_conv::log2_exact(pl.tw);
  const int th_log = wgmma_conv::log2_exact(pl.th);
  if (tw_log < 3 || th_log < 0 || pl.tb < 1 ||
      pl.tw * pl.th * pl.tb != pl.bm || pl.stages != STAGES ||
      pl.chunk != CK || pl.grid_y != 1 || pl.tiles_n < 1 ||
      B * H * W > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)pl.tiles_w * pl.tiles_h * pl.tiles_b * pl.tiles_n;
  if (tiles > 0x7fffffff || (long long)pl.tiles_w << tw_log < W ||
      (long long)pl.tiles_h << th_log < H || (long long)pl.tiles_b * pl.tb < B ||
      (long long)pl.tiles_n * pl.bn < Cout || pl.grid_x != tiles)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.wp = nullptr;
  p.scale = scale;
  p.shift = shift;
  p.out = out;
  p.B = (int)B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.tw_log = tw_log;
  p.th_log = th_log;
  p.tb = pl.tb;
  p.rs = pl.tw + 4;
  p.tiles_w = pl.tiles_w;
  p.tiles_h = pl.tiles_h;
  p.tiles_n = pl.tiles_n;
  p.chunks = (Cin + CK - 1) / CK;
  p.relu = relu;
  p.vec_out = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  // The (BM, BN) tiles the plan may name (conv_plan.F32_TILES), each with
  // its thread tile, TM pixels by TN channels: 16-pixel rows where the box
  // is at least 16 wide, else 8, and 8 for BN = 32 (conv_plan.f32_tm).
  const int tm = pl.bn == 32 || pl.tw < 16 ? 8 : 16;
#define CONV_F32_CONFIG(BM_, TM_, TN_)                                   \
  if (pl.bm == BM_ && pl.bn == Cfg<BM_, TM_, TN_>::BN && tm == TM_)      \
    return launch_config<BM_, TM_, TN_>(pl, p, w, workspace,             \
                                        workspace_bytes, stream);
  CONV_F32_CONFIG(128, 16, 4)
  CONV_F32_CONFIG(128, 8, 8)
  CONV_F32_CONFIG(256, 16, 4)
  CONV_F32_CONFIG(256, 8, 8)
  CONV_F32_CONFIG(256, 8, 4)
#undef CONV_F32_CONFIG
  return (int)cudaErrorInvalidValue;
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16 where TMA cannot go (Cin % 8 != 0, or x, w not 16-byte aligned):
// one haloed input box per tile in shared memory, wgmma (or, for Cin <= 8,
// mma.sync) reading it at nine fixed offsets
// ---------------------------------------------------------------------------
//
// A tile is BM = 128 output pixels, a (TW, TH, TB) box of powers of two
// chosen by the plan, by BN output channels.  Its input is the haloed box
// (TB, TH + 2, TW + 2) of x, brought into shared memory once per channel
// chunk of CK with every channel padded to a multiple of 8 (zeros), as
// planes of 8 channels: group j of box pixel p is the 16 bytes at
// (j * PLANE + p) * 16.  Tap (dy, dx) of tile row r is box pixel
// box_pixel(r) + dy * (TW + 2) + dx, so the nine taps are nine fixed offsets
// into the same box (the Pallas kernel's shifted windows of one haloed row
// strip) and the inner loop has no division and no bounds test.  The
// weights come the same way, (9, CK / 8, BN, 8) a chunk.
//
// Products.  Chunks of CK = 32 (Cin > 8): each of the two warpgroups runs
// wgmma m64nBNk16 with both operands read from shared memory through
// no-swizzle descriptors: a core matrix is 8 rows of 16 bytes, which for A
// are 8 consecutive box pixels of one plane (boxes 8 wide, so the 8 rows
// of a warpgroup's m64 block are 8 box rows, BW * 16 bytes apart) and for
// B 8 output channels; the two 8-channel halves of a k16 step are a plane
// apart.  An odd last group is paired with a zero plane.  CK = 8 (the
// stem, Cin <= 8): one m16n8k8 mma.sync a tap, fed by ldmatrix, Cin = 3
// multiplying 8 lanes.
//
// Loads.  The weights are laid out once per call by pad_weights into a
// workspace in the stages' own layout, (channel tile, chunk, 9, CK / 8, BN,
// 8) zero-padded, so a stage's weights are one contiguous run that
// cp.async copies in 16-byte pieces.  x is read by units of 8 channels of
// one box pixel with the widest loads that Cin and the pointer's alignment
// allow (2 to 16 bytes), zero outside the image and past Cin, and stored
// as one 16-byte word.  A block is persistent over the tiles blockIdx.x,
// + gridDim.x, ... (the grid is a multiple of the channel tiles, so a
// block keeps its n0) and walks (tile, chunk) steps through two
// shared-memory stages: the next step's weights (cp.async) and box units
// (registers) are in flight while the current step multiplies, across tile
// boundaries too, and the box units are stored while the wgmmas run.
// Weights already in a stage (one chunk, the same n0) are not copied again.
//
// Epilogue: scale, shift and ReLU in f32 on the accumulators, bf16 into a
// shared tile (the finished stage's box planes, for wgmma), then each
// pixel's channels stored as 16-, 8-, 4- or 2-byte words as Cout and the
// output's alignment allow.

namespace bf16 {

constexpr int BM = 128;        // output pixels per tile
constexpr int THREADS = 256;   // 8 warps: two warpgroups
constexpr int BOX_MAX = 240;   // haloed box pixels TB (TH + 2) (TW + 2)

template <int BN, int CK>
struct Cfg {
  static_assert(BN % 16 == 0 && BN >= 16 && BN <= 64, "channel tile");
  static_assert(CK == 8 || CK == 32, "chunk");
  static constexpr bool WG = CK == 32;  // wgmma; else mma.sync m16n8k8
  static constexpr int N8 = CK / 8;     // 8-channel groups of a chunk
  static constexpr int LDC = BN + 8;    // epilogue tile row (bf16)
  static constexpr int CST = BM * LDC;  // epilogue tile (bf16)
  // Box pixels a plane: at least BOX_MAX (and, for wgmma, room for the
  // epilogue tile in the planes), 2 mod 8 in 16-byte words, so a unit's
  // four planes, stored by neighbouring threads, fall in different banks.
  static constexpr int PLANE_MIN =
      WG && CST / (N8 * 8) > BOX_MAX ? (CST + N8 * 8 - 1) / (N8 * 8) : BOX_MAX;
  static constexpr int PLANE = PLANE_MIN + ((10 - PLANE_MIN % 8) % 8);
  static constexpr int A_ELEMS = N8 * PLANE * 8;
  static constexpr int B_ELEMS = 9 * N8 * BN * 8;      // one (tile, chunk)
  static constexpr int STAGE = A_ELEMS + B_ELEMS;      // bf16 a stage
  static constexpr int UNITS = (BOX_MAX * N8 + THREADS - 1) / THREADS;
  static constexpr int MIN_BLOCKS = WG ? 2 : 3;        // blocks an SM
  // wgmma's epilogue tile lives in the finished stage's box planes.
  static_assert(!WG || A_ELEMS >= CST, "epilogue tile in the box planes");
  static constexpr int SMEM = (2 * STAGE + (WG ? 0 : CST)) * 2;
};

struct Params {
  const uint16_t* x;   // (B, H, W, Cin)
  const uint16_t* wp;  // the padded weights (tiles_n, chunks, 9, CK/8, BN, 8)
  const float* scale;
  const float* shift;
  uint16_t* out;       // (B, H, W, Cout)
  int B, H, W, Cin, Cout;
  int tw_log, th_log, tb;  // box: TW = 1 << tw_log, TH = 1 << th_log
  int tiles_w, tiles_h, tiles_n, tiles;
  int chunks;              // ceil(Cin / CK)
  int relu;
  int vec_x, vec_out;      // bf16 a global access
};

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x1(uint32_t addr, uint32_t& r0) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
               : "=r"(r0)
               : "r"(addr)
               : "memory");
}

// Makes this thread's shared-memory writes (stores, cp.async) visible to
// the async proxy that wgmma reads its operands through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D += A (16x8) * B (8x8), bf16 in, f32 out.
__device__ __forceinline__ void mma_k8(float* d, uint32_t a0, uint32_t a1,
                                       uint32_t b0) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between the two core matrices of a k16 step (lbo) and between
// core matrices 8 rows apart (sbo), all >> 4.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// D (64 x N, f32) += A (64 x 16, smem) * B (16 x N, smem)^T, both K-major.
__device__ __forceinline__ void wgmma_k16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_k16(float (&d)[16], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_k16(float (&d)[24], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  wgmma_conv::wgmma_m64nk16(d, da, db, 1);
}

// Eight consecutive bf16 (raw bits) from q, zero from element `rem` on
// (rem >= 8: all eight), `vec` elements a load: q is 2 * vec-byte aligned
// and rem a multiple of vec.
__device__ __forceinline__ uint4 load8(const uint16_t* __restrict__ q,
                                       int rem, int vec) {
  if (rem >= 8) {
    if (vec == 8) return __ldg(reinterpret_cast<const uint4*>(q));
    if (vec == 4) {
      const uint2 lo = __ldg(reinterpret_cast<const uint2*>(q));
      const uint2 hi = __ldg(reinterpret_cast<const uint2*>(q) + 1);
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    if (vec == 2) {
      const unsigned int* p = reinterpret_cast<const unsigned int*>(q);
      return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
  }
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t lo = 2 * i < rem ? (uint32_t)__ldg(q + 2 * i) : 0u;
    const uint32_t hi = 2 * i + 1 < rem ? (uint32_t)__ldg(q + 2 * i + 1) : 0u;
    r[i] = lo | (hi << 16);
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// A block's walk over its (tile, chunk) steps: tiles blockIdx.x,
// + gridDim.x, ... as digits (bx, by, bb) of the box grid and the channel
// tile nt (fastest in the tile index), advanced without division.
struct Walk {
  int bx, by, bb, nt, chunk;

  __device__ __forceinline__ void start(const Params& p) {
    const int t = blockIdx.x;
    nt = t % p.tiles_n;
    int m = t / p.tiles_n;
    bx = m % p.tiles_w;
    m /= p.tiles_w;
    by = m % p.tiles_h;
    bb = m / p.tiles_h;
    chunk = 0;
  }
  // (dx, dy, db): gridDim.x / tiles_n in the same digits.
  __device__ __forceinline__ void next(const Params& p, int dx, int dy,
                                       int db) {
    if (++chunk < p.chunks) return;
    chunk = 0;
    bx += dx;
    if (bx >= p.tiles_w) {
      bx -= p.tiles_w;
      ++by;
    }
    by += dy;
    if (by >= p.tiles_h) {
      by -= p.tiles_h;
      ++bb;
    }
    bb += db;
  }
};

// This thread's box units: unit u = tid + i * THREADS is channel group
// u % (CK / 8) of box pixel e = u / (CK / 8) = (pb, py, px), packed as
// coord[i] = pb << 16 | py << 8 | px (-1 past the box).
template <int CK>
struct Units {
  static constexpr int N = Cfg<16, CK>::UNITS;
  static constexpr int N8 = CK / 8;
  int coord[N];

  // channel offset of unit i in its chunk, and its offset in a stage
  __device__ __forceinline__ static int j8(int i) {
    return 8 * ((threadIdx.x + i * THREADS) % N8);
  }
  __device__ __forceinline__ static int dst(int i, int plane) {
    const int u = threadIdx.x + i * THREADS;
    return ((u % N8) * plane + u / N8) * 8;
  }
};

template <int CK>
__device__ __forceinline__ void load_box(const Params& p, const Walk& s,
                                         const Units<CK>& un,
                                         uint4 (&pre)[Units<CK>::N]) {
  const int c0 = s.chunk * CK;
  const int x0 = (s.bx << p.tw_log) - 1;
  const int y0 = (s.by << p.th_log) - 1;
  const int b0 = s.bb * p.tb;
#pragma unroll
  for (int i = 0; i < Units<CK>::N; ++i) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int rem = p.Cin - c0 - un.j8(i);
    if (un.coord[i] >= 0 && rem > 0) {
      const int xx = x0 + (un.coord[i] & 255);
      const int yy = y0 + ((un.coord[i] >> 8) & 255);
      const int bb = b0 + (un.coord[i] >> 16);
      if (bb < p.B && (unsigned)yy < (unsigned)p.H &&
          (unsigned)xx < (unsigned)p.W)
        v = load8(p.x + (((int64_t)bb * p.H + yy) * p.W + xx) * p.Cin + c0 +
                      un.j8(i),
                  rem, p.vec_x);
    }
    pre[i] = v;
  }
}

template <int CK>
__device__ __forceinline__ void store_box(uint16_t* stage, const Units<CK>& un,
                                          int plane,
                                          const uint4 (&pre)[Units<CK>::N]) {
#pragma unroll
  for (int i = 0; i < Units<CK>::N; ++i)
    if (un.coord[i] >= 0)
      *reinterpret_cast<uint4*>(stage + un.dst(i, plane)) = pre[i];
}

// The step's weights, one contiguous run of the workspace, into the stage.
template <int BN, int CK>
__device__ __forceinline__ void copy_weights(const Params& p, const Walk& s,
                                             uint32_t stage) {
  using C = Cfg<BN, CK>;
  const uint16_t* src =
      p.wp + (int64_t)(s.nt * p.chunks + s.chunk) * C::B_ELEMS;
  const uint32_t dst = stage + C::A_ELEMS * 2;
  for (int i = threadIdx.x; i < C::B_ELEMS / 8; i += THREADS)
    cp_async16(dst + 16 * i, src + 8 * i);
}

template <int BN, int CK>
__global__ void __launch_bounds__(THREADS, Cfg<BN, CK>::MIN_BLOCKS)
conv_kernel(const Params p) {
  using C = Cfg<BN, CK>;
  extern __shared__ __align__(128) uint16_t box_smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int TW = 1 << p.tw_log;
  const int TH = 1 << p.th_log;
  const int BW = TW + 2;
  const int BH = TH + 2;
  const int box_px = p.tb * BH * BW;

  Units<CK> un;
#pragma unroll
  for (int i = 0; i < Units<CK>::N; ++i) {
    const int u = tid + i * THREADS;
    const int e = u / C::N8;  // box pixel
    const int r = e / BW;
    un.coord[i] = e < box_px ? ((r / BH) << 16) | ((r % BH) << 8) | (e - r * BW)
                             : -1;
  }

  // Box pixel of tile row r at tap (0, 0), i.e. input (y0 - 1 + ty,
  // x0 - 1 + tx) for output (y0 + ty, x0 + tx).
  auto box_pixel = [&](int r) {
    return ((r >> (p.tw_log + p.th_log)) * BH + ((r >> p.tw_log) & (TH - 1))) *
               BW +
           (r & (TW - 1));
  };
  const uint32_t ring = wgmma_conv::smem_u32(box_smem);

  // Operand addresses, bytes from a stage's start.  wgmma: this
  // warpgroup's first A row and the B tile, as descriptors.  mma.sync: this
  // lane's ldmatrix rows, A at k8 (one x4 for the warp's two m16 blocks)
  // and B at k8 (one x4 for four n8 tiles).
  const int wg = warp >> 2;
  uint64_t da = 0, db = 0;
  uint32_t a8 = 0, b8 = 0;
  if constexpr (C::WG) {
    da = desc_plain(ring + box_pixel(64 * wg) * 16, C::PLANE * 16, BW * 16);
    db = desc_plain(ring + C::A_ELEMS * 2, BN * 16, 128);
  } else {
    const int wm = warp & 3;
    const int wn = warp >> 2;
    a8 = box_pixel(wm * 32 + 16 * (lane >> 4) + 8 * ((lane >> 3) & 1) +
                   (lane & 7)) *
         16;
    b8 = (C::A_ELEMS + (wn * (BN / 2) + lane % (BN / 2)) * 8) * 2;
  }

  // The block's steps and the tile stride in box-grid digits.  The grid is
  // a multiple of tiles_n, or each block has one tile.
  const int steps =
      (p.tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x *
      p.chunks;
  const int ds = (int)gridDim.x / p.tiles_n;
  const int dx = ds % p.tiles_w;
  const int dy = ds / p.tiles_w % p.tiles_h;
  const int db_ = ds / (p.tiles_w * p.tiles_h);
  Walk cur_s, next_s;  // the step multiplied, the step loaded
  cur_s.start(p);
  next_s = cur_s;

  // Epilogue: each tile row is one output pixel, its min(BN, Cout - n0)
  // channels stored vec_out at a time; this thread's first (row, word)
  // and its stride over them.
  const int n0 = cur_s.nt * BN;
  const int per_row = min(BN, p.Cout - n0) / p.vec_out;
  const int sr0 = tid / per_row;
  const int sj0 = tid - sr0 * per_row;
  const int dsr = THREADS / per_row;
  const int dsj = THREADS - dsr * per_row;

  // Accumulators: wgmma, this warpgroup's 64 rows x BN; mma.sync, the
  // warp's 32 rows x BN / 2 as [m16 block][n8 tile][4].
  constexpr int NACC = C::WG ? BN / 2 : 2 * (BN / 16) * 4;
  float acc[NACC];
#pragma unroll
  for (int e = 0; e < NACC; ++e) acc[e] = 0.f;

  uint4 pre[Units<CK>::N];
  // (channel tile, chunk) of each stage's weights
  int wtag0 = cur_s.nt * p.chunks;
  int wtag1 = -1;
  copy_weights<BN, CK>(p, cur_s, ring);
  cp_async_commit();
  load_box<CK>(p, cur_s, un, pre);
  store_box<CK>(box_smem, un, C::PLANE, pre);
  cp_async_wait<0>();
  if constexpr (C::WG) fence_proxy_async();
  __syncthreads();

  for (int i = 0; i < steps; ++i) {
    const int cur = i & 1;
    const bool more = i + 1 < steps;
    if (more) {  // the next step's loads are in flight over the products
      next_s.next(p, dx, dy, db_);
      const int tag = next_s.nt * p.chunks + next_s.chunk;
      if (tag != (cur ? wtag0 : wtag1)) {
        copy_weights<BN, CK>(p, next_s, ring + (cur ^ 1) * (C::STAGE * 2));
        if (cur) {
          wtag0 = tag;
        } else {
          wtag1 = tag;
        }
      }
      cp_async_commit();
      load_box<CK>(p, next_s, un, pre);
    }

    const uint32_t stage = ring + cur * (C::STAGE * 2);
    uint16_t* cst;  // the epilogue's bf16 tile
    if constexpr (C::WG) {
      // 8-channel groups of the chunk, in k16 steps (an odd one paired
      // with the zero plane after it)
      const int n16 = (min(C::N8, (p.Cin - cur_s.chunk * CK + 7) >> 3) + 1) >> 1;
      const uint64_t soff = cur * (C::STAGE / 8);  // descriptor units
      wgmma_conv::wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
        for (int s = 0; s < C::N8 / 2; ++s) {
          if (s < n16) {
            wgmma_k16(acc,
                      da + soff + (tap / 3) * BW + tap % 3 + 2 * s * C::PLANE,
                      db + soff + (tap * C::N8 + 2 * s) * BN);
          }
        }
      }
      wgmma_conv::wgmma_commit();
      if (more)  // stored while the products run
        store_box<CK>(box_smem + (cur ^ 1) * C::STAGE, un, C::PLANE, pre);
      wgmma_conv::wgmma_wait<0>();
      cst = box_smem + cur * C::STAGE;
    } else {
      constexpr int NT = BN / 16;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const uint32_t at = stage + ((tap / 3) * BW + tap % 3) * 16;
        const uint32_t bt = stage + tap * (BN * 16);
        uint32_t a[4];
        uint32_t b[NT];
        ldsm_x4(at + a8, a[0], a[1], a[2], a[3]);
        if (NT == 4) {
          ldsm_x4(bt + b8, b[0], b[1], b[2], b[3]);
        } else if (NT == 3) {
          ldsm_x2(bt + b8, b[0], b[1]);
          ldsm_x1(bt + b8 + 2 * (8 * 16), b[NT - 1]);
        } else if (NT == 2) {
          ldsm_x2(bt + b8, b[0], b[1]);
        } else {
          ldsm_x1(bt + b8, b[0]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            mma_k8(acc + (mi * NT + nt) * 4, a[2 * mi], a[2 * mi + 1], b[nt]);
          }
      }
      if (more) store_box<CK>(box_smem + (cur ^ 1) * C::STAGE, un, C::PLANE, pre);
      cst = box_smem + 2 * C::STAGE;
    }

    if (cur_s.chunk == p.chunks - 1) {
      // Epilogue: accumulators -> bf16 tile (after every warp's products,
      // since for wgmma the tile overwrites the stage's box planes).
      __syncthreads();
      const int q = lane & 3;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        // wgmma: [j*4 + h*2 + e] is row 64 wg + 16 (warp % 4) + lane / 4 +
        // 8h, column 8j + 2q + e.  mma.sync: [(mi*NT + nt)*4 + 2h + e] is
        // row 32 (warp % 4) + 16 mi + lane / 4 + 8h, column
        // (BN/2)(warp / 4) + 8 nt + 2q + e.
        const int col = C::WG ? 8 * j + 2 * q
                              : (BN / 2) * (warp >> 2) + 8 * (j % (BN / 16)) +
                                    2 * q;
        const int n = n0 + col;
        const float sc0 = n < p.Cout ? __ldg(p.scale + n) : 0.f;
        const float sh0 = n < p.Cout ? __ldg(p.shift + n) : 0.f;
        const float sc1 = n + 1 < p.Cout ? __ldg(p.scale + n + 1) : 0.f;
        const float sh1 = n + 1 < p.Cout ? __ldg(p.shift + n + 1) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = C::WG ? 64 * wg + 16 * (warp & 3) + (lane >> 2) + 8 * h
                                : 32 * (warp & 3) + 16 * (j / (BN / 16)) +
                                      (lane >> 2) + 8 * h;
          const int k = j * 4 + 2 * h;
          float v0 = fmaf(acc[k], sc0, sh0);
          float v1 = fmaf(acc[k + 1], sc1, sh1);
          if (p.relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(cst + row * C::LDC + col) =
              __floats2bfloat162_rn(v0, v1);
          acc[k] = 0.f;
          acc[k + 1] = 0.f;
        }
      }
      __syncthreads();
      const int vec = p.vec_out;
      const int x0 = cur_s.bx << p.tw_log;
      const int y0 = cur_s.by << p.th_log;
      const int b0 = cur_s.bb * p.tb;
      for (int r = sr0, j = sj0; r < BM;) {
        const int xx = x0 + (r & (TW - 1));
        const int yy = y0 + ((r >> p.tw_log) & (TH - 1));
        const int bb = b0 + (r >> (p.tw_log + p.th_log));
        if (xx < p.W && yy < p.H && bb < p.B) {
          uint16_t* dst = p.out +
                          (((int64_t)bb * p.H + yy) * p.W + xx) * p.Cout + n0 +
                          j * vec;
          const uint16_t* src = cst + r * C::LDC + j * vec;
          if (vec == 8) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          } else if (vec == 4) {
            *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
          } else if (vec == 2) {
            *reinterpret_cast<uint32_t*>(dst) =
                *reinterpret_cast<const uint32_t*>(src);
          } else {
            *dst = *src;
          }
        }
        r += dsr;
        j += dsj;
        if (j >= per_row) {
          j -= per_row;
          ++r;
        }
      }
    }

    if (more) {
      cp_async_wait<0>();
      if constexpr (C::WG) fence_proxy_async();
      cur_s = next_s;
    }
    __syncthreads();
  }
}

// The weights w (Cout, 9, Cin) laid out as the stages read them: wp
// (tiles_n, chunks, 9, ck / 8, bn, 8), zero past Cout and Cin.
__global__ void pad_weights(const uint16_t* __restrict__ w,
                            uint16_t* __restrict__ wp, int Cin, int Cout,
                            int chunks, int bn, int ck, int64_t total) {
  const int n8 = ck / 8;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t r = i / 8;
    const int e = (int)(i - r * 8);
    const int n = (int)(r % bn);
    r /= bn;
    const int j = (int)(r % n8);
    r /= n8;
    const int tap = (int)(r % 9);
    r /= 9;
    const int c = (int)(r % chunks);
    const int nn = (int)(r / chunks) * bn + n;
    const int cin = c * ck + 8 * j + e;
    wp[i] = (nn < Cout && cin < Cin) ? w[((int64_t)nn * 9 + tap) * Cin + cin]
                                     : (uint16_t)0;
  }
}

// bf16 a global access: the widest of 8, 4, 2 that divides c with ptr
// aligned to it, else 1.
inline int vec_of(int c, const void* ptr) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  for (int v = 8; v > 1; v >>= 1)
    if (c % v == 0 && a % (2 * v) == 0) return v;
  return 1;
}

template <int BN, int CK>
int launch_config(const wgmma_conv::Plan& pl, Params p, const void* w,
                  void* workspace, long long workspace_bytes,
                  cudaStream_t stream) {
  using C = Cfg<BN, CK>;
  const long long ws = (long long)p.tiles_n * p.chunks * C::B_ELEMS;
  // wgmma reads 8 box pixels of one row as a core matrix and a warpgroup's
  // 64 rows as 8 box rows of one image: boxes 8 wide and at least 8 tall.
  if (pl.smem != C::SMEM || workspace_bytes < 2 * ws ||
      reinterpret_cast<uintptr_t>(workspace) % 16 ||
      (C::WG && (pl.tw != 8 || pl.th < 8)))
    return (int)cudaErrorInvalidValue;
  p.wp = static_cast<const uint16_t*>(workspace);
  const long long blocks = (ws + 255) / 256 < 4096 ? (ws + 255) / 256 : 4096;
  pad_weights<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const uint16_t*>(w), static_cast<uint16_t*>(workspace),
      p.Cin, p.Cout, p.chunks, BN, CK, ws);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kern = conv_kernel<BN, CK>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::SMEM);
  if (err != cudaSuccess) return (int)err;
  kern<<<pl.grid_x, THREADS, C::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// workspace: at least 2 * tiles_n * chunks * 9 * BN * chunk bytes, 16-byte
// aligned (conv_plan.box_workspace_bytes).  Returns 0 or an error code;
// cudaErrorInvalidValue when the plan is not one this body takes, its
// tiles do not cover the output or the workspace is too small.
int launch(const wgmma_conv::Plan& pl, const void* x, const void* w,
           const float* scale, const float* shift, void* out, long long B,
           int H, int W, int Cin, int Cout, int relu, void* workspace,
           long long workspace_bytes, cudaStream_t stream) {
  const int tw_log = wgmma_conv::log2_exact(pl.tw);
  const int th_log = wgmma_conv::log2_exact(pl.th);
  if (tw_log < 0 || th_log < 0 || pl.tb < 1 || pl.bm != BM ||
      pl.tw * pl.th * pl.tb != BM ||
      pl.tb * (pl.th + 2) * (pl.tw + 2) > BOX_MAX || pl.stages != 2 ||
      pl.grid_x < 1 || pl.grid_y != 1 || pl.tiles_n < 1 || B > (1ll << 30))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)pl.tiles_w * pl.tiles_h * pl.tiles_b * pl.tiles_n;
  if (tiles > 0x7fffffff || (long long)pl.tiles_w << tw_log < W ||
      (long long)pl.tiles_h << th_log < H || (long long)pl.tiles_b * pl.tb < B ||
      (long long)pl.tiles_n * pl.bn < Cout || pl.grid_x > tiles ||
      (pl.grid_x != tiles && pl.grid_x % pl.tiles_n != 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const uint16_t*>(x);
  p.wp = nullptr;
  p.scale = scale;
  p.shift = shift;
  p.out = static_cast<uint16_t*>(out);
  p.B = (int)B;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cout = Cout;
  p.tw_log = tw_log;
  p.th_log = th_log;
  p.tb = pl.tb;
  p.tiles_w = pl.tiles_w;
  p.tiles_h = pl.tiles_h;
  p.tiles_n = pl.tiles_n;
  p.tiles = (int)tiles;
  p.chunks = pl.chunk > 0 ? (Cin + pl.chunk - 1) / pl.chunk : 0;
  p.relu = relu;
  p.vec_x = vec_of(Cin, x);
  p.vec_out = vec_of(Cout, out);
  // The (BN, chunk) pairs the plan may name (conv_plan.BOX_BNS x
  // conv_plan.BOX_CHUNKS).
#define CONV_BOX_CONFIG(BN_, CK_)                                       \
  if (pl.bn == BN_ && pl.chunk == CK_)                                  \
    return launch_config<BN_, CK_>(pl, p, w, workspace, workspace_bytes, \
                                   stream);
  CONV_BOX_CONFIG(16, 8)
  CONV_BOX_CONFIG(32, 8)
  CONV_BOX_CONFIG(48, 8)
  CONV_BOX_CONFIG(64, 8)
  CONV_BOX_CONFIG(16, 32)
  CONV_BOX_CONFIG(32, 32)
  CONV_BOX_CONFIG(48, 32)
  CONV_BOX_CONFIG(64, 32)
#undef CONV_BOX_CONFIG
  return (int)cudaErrorInvalidValue;
}

}  // namespace bf16

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it; scale and shift
// are float32).  x (B, H, W, Cin), w (Cout, 9, Cin) K-major, out (B, H, W,
// Cout), all contiguous.  plan: wgmma_conv::PLAN_INTS ints from
// ops/kernels/conv_plan.py (body, box, BN, stages, grid, tiles, chunk,
// shared-memory bytes).  workspace: the weights laid out by the mma_sync
// and f32_box bodies (conv_plan.box_workspace_bytes; unused by wgmma).
// Returns 0, or the error of a refused tensor-map encode, shared-memory
// attribute or launch, or cudaErrorInvalidValue for a plan the body does
// not take or whose grid or tiles do not cover the output.
extern "C" int conv3x3_affine_relu_launch(int dtype, const void* x,
                                          const void* w, const void* scale,
                                          const void* shift, void* out,
                                          long long B, int H, int W, int Cin,
                                          int Cout, int relu, const int* plan,
                                          void* workspace,
                                          long long workspace_bytes,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const wgmma_conv::Plan pl = *reinterpret_cast<const wgmma_conv::Plan*>(plan);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 1 && pl.body == kMmaSync) {
    return bf16::launch(pl, x, w, sc, sh, out, B, H, W, Cin, Cout, relu,
                        workspace, workspace_bytes, s);
  } else if (dtype == 1 && pl.body == kWgmma) {
    return wgmma_conv::launch<true>(pl, x, w, sc, sh, out, B, H, W, Cin, Cout,
                                    /*halo=*/1, relu, s);
  } else if (dtype == 1 && pl.body == kNarrow) {
    return conv3x3_narrow_launch(pl, x, w, sc, sh, out, B, H, W, Cin, Cout,
                                 relu, s);
  } else if (dtype == 0 && pl.body == kF32Box) {
    return f32::launch(pl, static_cast<const float*>(x),
                       static_cast<const float*>(w), sc, sh,
                       static_cast<float*>(out), B, H, W, Cin, Cout, relu,
                       workspace, workspace_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Message for a code returned by a launch function of this library.
extern "C" const char* kernels_error_string(int code) {
  static thread_local char buf[160];
  if (code >= wgmma_conv::kErrTensorMap) {
    snprintf(buf, sizeof buf,
             "cuTensorMapEncodeTiled refused the tensor map (CUresult %d)",
             code - wgmma_conv::kErrTensorMap);
    return buf;
  }
  if (code >= wgmma_conv::kErrEntryPoint) {
    snprintf(buf, sizeof buf,
             "no driver entry point for cuTensorMapEncodeTiled (status %d)",
             code - wgmma_conv::kErrEntryPoint);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
