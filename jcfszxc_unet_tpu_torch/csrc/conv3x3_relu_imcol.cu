// 3x3 SAME conv + ReLU as one deep im2col product, for NHWC activations on
// Hopper (sm_90a).
//
// Replaces the TPU kernel make_imcol_kernel.run
// (scripts/tpu_imcol_conv_probe.py).  Function:
//   out = relu(conv3x3_SAME(x, w)), f32 accumulation, stored once in the
//   activation dtype (float32 or bfloat16); no affine.
//
// The probe's design carried over: the caller zero-pads x in device memory
// into xp (B, H+2, W+2, C) and views the weights as one (9*C, Cout) matrix,
// so the kernel reads the halo with no per-tap bounds test and runs ONE
// K = 9*C reduction per output tile.  Here the caller also pads the
// channels to C % 8 == 0 (zeros in xp and in the weights), so every run
// of 8 consecutive k lies inside one tap and is one 16-byte load, and it
// hands over the weights transposed, wt (Cout, 9*C), so both operands are
// k-contiguous.  Row k = tap*C + c of the product's B operand is
// w[tap / 3][tap % 3][c][:].
//
// A block owns 128 output pixels x 64 output channels, with pixels taken
// in (b, y, x) order across rows and images, so any B, H and W work; only
// the last tile's pixels and channels are masked.
//   * bfloat16 (the probe's type): a 3-stage ring of cp.async 16-byte
//     copies straight into shared memory (no register staging: without
//     the halo mask every copy is a plain block copy, or a zero fill past
//     the last pixel), 8 warps of mma.sync m16n8k16 on 32 x 32 warp tiles.
//   * float32: register-staged 16-byte loads, double-buffered shared
//     memory, 8 x 4 outputs per thread on FMAs (full f32 products).
//
// Bound on the H100 at the probe's geometry (B 64, 128 x 128, 128 -> 64):
// 1152 multiply-adds per output element, so operations; mma.sync reaches
// only part of the tensor cores' rate (wgmma fed by TMA is later work).
// The caller's padded copy adds its own bytes outside the kernel.
//
// Offsets into xp and out are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// Offset (elements) into xp of the top-left tap of output pixel p.
__device__ __forceinline__ int64_t pixel_base(int64_t p, int H, int W, int C) {
  const int64_t row = p / W;  // b * H + y
  const int x = (int)(p - row * W);
  const int64_t b = row / H;
  const int y = (int)(row - b * H);
  return ((b * (H + 2) + y) * (int64_t)(W + 2) + x) * C;
}

// Offset of GEMM column k = tap * C + c from a pixel's base.
__device__ __forceinline__ int64_t k_offset(int k, int W, int C) {
  const int tap = k / C;
  const int c = k - tap * C;
  const int dy = tap / 3;
  const int dx = tap - dy * 3;
  return ((int64_t)dy * (W + 2) + dx) * C + c;
}

// ---------------------------------------------------------------------------
// float32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int BM = 128;   // output pixels per block
constexpr int BN = 64;    // output channels per block
constexpr int BK = 16;    // K step
constexpr int TM = 8;     // pixels per thread
constexpr int TN = 4;     // channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

static_assert(THREADS == 256, "tile shape and thread count disagree");
static_assert(BM * BK == THREADS * 8, "each thread loads 8 A values");
static_assert(BN * BK == THREADS * 4, "each thread loads 4 B values");

__global__ void __launch_bounds__(THREADS)
imcol_kernel(const float* __restrict__ xp, const float* __restrict__ wt,
             float* __restrict__ out, int64_t M, int H, int W, int C,
             int Cout) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;
  const int KT = (K + BK - 1) / BK;

  // Load roles: one pixel and 8 consecutive k of A (a warp takes 32
  // consecutive pixels, so its shared-memory stores hit 32 banks); one
  // output channel and 4 consecutive k of B.
  const int am = tid % BM;
  const int ak = (tid / BM) * 8;
  const int64_t ap = m0 + am;
  const bool a_valid = ap < M;
  const int64_t a_base = a_valid ? pixel_base(ap, H, W, C) : 0;
  const int bn = tid % BN;
  const int bk = (tid / BN) * 4;
  const bool b_valid = n0 + bn < Cout;
  const float* w_row = wt + (int64_t)(b_valid ? n0 + bn : 0) * K;

  // Compute roles: TM pixels x TN channels per thread.
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 a_reg[2];
  float4 b_reg;
  auto load = [&](int kt) {
    const int ka = kt * BK + ak;  // K % 8 == 0: all 8 in or all out
    if (a_valid && ka < K) {
      const float* q = xp + a_base + k_offset(ka, W, C);
      a_reg[0] = *reinterpret_cast<const float4*>(q);
      a_reg[1] = *reinterpret_cast<const float4*>(q + 4);
    } else {
      a_reg[0] = zero;
      a_reg[1] = zero;
    }
    const int kb = kt * BK + bk;
    b_reg = (b_valid && kb < K) ? *reinterpret_cast<const float4*>(w_row + kb)
                                : zero;
  };
  auto stage = [&](int buf) {
    const float a[8] = {a_reg[0].x, a_reg[0].y, a_reg[0].z, a_reg[0].w,
                        a_reg[1].x, a_reg[1].y, a_reg[1].z, a_reg[1].w};
#pragma unroll
    for (int j = 0; j < 8; ++j) As[buf][ak + j][am] = a[j];
    Bs[buf][bk + 0][bn] = b_reg.x;
    Bs[buf][bk + 1][bn] = b_reg.y;
    Bs[buf][bk + 2][bn] = b_reg.z;
    Bs[buf][bk + 3][bn] = b_reg.w;
  };

  load(0);
  stage(0);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) load(kt + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][tm * TM]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[cur][k][tm * TM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[cur][k][tn * TN]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) stage(cur ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tn * TN + j;
    if (n >= Cout) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t p = m0 + tm * TM + i;
      if (p < M) out[p * Cout + n] = fmaxf(acc[i][j], 0.f);
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: cp.async ring + mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace bf16 {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // K step (two k16 mma steps)
constexpr int STAGES = 3;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;        // warp tile rows
constexpr int WN = 32;        // warp tile columns
constexpr int LDS = BK + 8;   // smem row stride (bf16): 80 bytes, 16-byte
                              // aligned and conflict-free for fragments

static_assert((BM / WM) * (BN / WN) * 32 == THREADS, "warp grid");
static_assert(BM * BK == THREADS * 16, "each thread copies 2 x 8 A values");
static_assert(BN * BK == THREADS * 8, "each thread copies 8 B values");
static_assert(STAGES * (BM + BN) * LDS * 2 <= 48 * 1024, "static smem");

// 16-byte global -> shared copy; zero fill when !valid (no global read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
imcol_kernel(const uint16_t* __restrict__ xp, const uint16_t* __restrict__ wt,
             __nv_bfloat16* __restrict__ out, int64_t M, int H, int W, int C,
             int Cout) {
  // k-contiguous rows for both operands: As[pixel][k], Bs[channel][k].
  __shared__ __align__(16) uint16_t As[STAGES][BM][LDS];
  __shared__ __align__(16) uint16_t Bs[STAGES][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * C;
  const int KT = (K + BK - 1) / BK;

  // Copy roles: rows r and r + 64 of A and row r of B, each at k offset
  // kc of the step (four threads cover one 64-byte row).
  const int r = tid >> 2;
  const int kc = (tid & 3) * 8;
  int64_t a_base[2];
  bool a_valid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t p = m0 + r + 64 * i;
    a_valid[i] = p < M;
    a_base[i] = a_valid[i] ? pixel_base(p, H, W, C) : 0;
  }
  const bool b_valid = n0 + r < Cout;
  const uint16_t* w_row = wt + (int64_t)(b_valid ? n0 + r : 0) * K;

  auto load_stage = [&](int kt, int buf) {
    const int k = kt * BK + kc;  // K % 8 == 0: all 8 in or all out
    const bool k_in = k < K;
    const int64_t k_off = k_in ? k_offset(k, W, C) : 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      cp_async16(&As[buf][r + 64 * i][kc], xp + a_base[i] + k_off,
                 a_valid[i] && k_in);
    cp_async16(&Bs[buf][r][kc], w_row + (k_in ? k : 0), b_valid && k_in);
  };

  // Compute roles: warp (wm, wn) owns rows wm*32.. and columns wn*32..;
  // fragment coordinates g (group) and q (thread in group) per the PTX
  // m16n8k16 layouts.
  const int wm = warp % (BM / WM);
  const int wn = warp / (BM / WM);
  const int g = lane >> 2;
  const int q = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // One commit group per step (empty past the end), so that waiting for
  // all but STAGES - 2 groups always means step kt has landed.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt visible to all; step kt - 1 fully consumed
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk, nk % STAGES);
    cp_async_commit();

    const int cur = kt % STAGES;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      uint32_t af[2][4];
      uint32_t bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r0 = wm * WM + mi * 16 + g;
        const int k = ks + 2 * q;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(&As[cur][r0][k]);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(&As[cur][r0 + 8][k]);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(&As[cur][r0][k + 8]);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(&As[cur][r0 + 8][k + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * WN + ni * 8 + g;
        const int k = ks + 2 * q;
        bfr[ni][0] = *reinterpret_cast<const uint32_t*>(&Bs[cur][c][k]);
        bfr[ni][1] = *reinterpret_cast<const uint32_t*>(&Bs[cur][c][k + 8]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_16816(acc[mi][ni], af[mi], bfr[ni]);
    }
  }
  cp_async_wait<0>();  // no copy in flight when the block exits

  // Accumulator (mi, ni, e) sits at row g (+8 for e >= 2) and column
  // 2q + (e & 1) of the warp's 16 x 8 sub-tile (mi, ni).
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * WN + ni * 8 + 2 * q + e;
      if (n >= Cout) continue;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t p = m0 + wm * WM + mi * 16 + g + 8 * h;
          if (p < M)
            out[p * Cout + n] =
                __float2bfloat16_rn(fmaxf(acc[mi][ni][2 * h + e], 0.f));
        }
      }
    }
  }
}

}  // namespace bf16

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xp, wt and out share it).  xp is
// (B, H+2, W+2, C) with a zero border, wt is (Cout, 9*C), C % 8 == 0, both
// contiguous and 16-byte aligned, checked by the caller; out is (B, H, W,
// Cout).  Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_relu_imcol_launch(int dtype, const void* xp,
                                         const void* wt, void* out,
                                         long long B, int H, int W, int C,
                                         int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t M = (int64_t)B * H * W;
  if (dtype == 0) {
    const dim3 grid((unsigned)((M + f32::BM - 1) / f32::BM),
                    (unsigned)((Cout + f32::BN - 1) / f32::BN));
    f32::imcol_kernel<<<grid, f32::THREADS, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(wt),
        static_cast<float*>(out), M, H, W, C, Cout);
  } else if (dtype == 1) {
    const dim3 grid((unsigned)((M + bf16::BM - 1) / bf16::BM),
                    (unsigned)((Cout + bf16::BN - 1) / bf16::BN));
    bf16::imcol_kernel<<<grid, bf16::THREADS, 0, s>>>(
        static_cast<const uint16_t*>(xp), static_cast<const uint16_t*>(wt),
        static_cast<__nv_bfloat16*>(out), M, H, W, C, Cout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
