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
// channels to C % 8 == 0 (zeros in xp and in the weights) and hands over
// the weights transposed, wt (Cout, 9*C): row n is w[..., n] raveled
// (dy, dx, c), both operands K-major.
//
// Bound on the H100 at the probe's geometry (B 64, 128 x 128, 128 -> 64):
// 1152 multiply-adds per output value, so the tensor cores' rate, which
// only wgmma reaches (the first form's mma.sync fed by a cp.async ring
// reached 140 TFLOP/s).  Two bodies, chosen by the caller's plan
// (ops/kernels/conv_plan.py):
//   * bfloat16 (the probe's type): the TMA-fed wgmma mainloop of
//     conv3x3_wgmma.cuh, with a 4-D tensor map over xp read at
//     (c0, x0 + dx, y0 + dy, b0) (halo 0: the border is in xp; at the
//     probe's 128-wide maps, as row strips from (c0, x0, y0 + dy, b0)) and
//     wt viewed as (Cout, 9, C); no scale or shift.  C is always a multiple
//     of 8, so every bf16 call takes this body.
//   * float32: register-staged 16-byte loads, double-buffered shared
//     memory, 8 x 4 outputs per thread on FMAs (full f32 products), with
//     pixels taken in (b, y, x) order across rows and images.
// The caller's padded copy adds its own bytes outside the kernel.
//
// Offsets into xp and out are 64-bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv3x3_wgmma.cuh"

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xp, wt and out share it).  xp is
// (B, H+2, W+2, C) with a zero border, wt is (Cout, 9*C), C % 8 == 0, both
// contiguous and 16-byte aligned, checked by the caller; out is (B, H, W,
// Cout).  plan: wgmma_conv::PLAN_INTS ints from ops/kernels/conv_plan.py;
// body 0 (fma) for float32, 3 (wgmma) for bfloat16.  Returns 0, or the
// error of a refused tensor-map encode, shared-memory attribute or launch,
// or cudaErrorInvalidValue for a plan the body does not take or whose tiles
// do not cover the output.
extern "C" int conv3x3_relu_imcol_launch(int dtype, const void* xp,
                                         const void* wt, void* out,
                                         long long B, int H, int W, int C,
                                         int Cout, const int* plan,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const wgmma_conv::Plan pl = *reinterpret_cast<const wgmma_conv::Plan*>(plan);
  const int64_t M = (int64_t)B * H * W;
  if (dtype == 0 && pl.body == 0) {
    if ((int64_t)pl.grid_x * f32::BM < M || (int64_t)pl.grid_y * f32::BN < Cout)
      return (int)cudaErrorInvalidValue;
    f32::imcol_kernel<<<dim3((unsigned)pl.grid_x, (unsigned)pl.grid_y),
                        f32::THREADS, 0, s>>>(
        static_cast<const float*>(xp), static_cast<const float*>(wt),
        static_cast<float*>(out), M, H, W, C, Cout);
  } else if (dtype == 1 && pl.body == 3) {
    return wgmma_conv::launch<false>(pl, xp, wt, nullptr, nullptr, out, B, H,
                                     W, C, Cout, /*halo=*/0, /*relu=*/1, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
