// Fused 3x3 SAME conv + per-channel affine (folded BatchNorm or bias) +
// optional ReLU, for NHWC activations and HWIO weights on Hopper (sm_90a).
//
// Replaces the TPU kernel conv3x3_affine_relu_pallas
// (jcfszxc_unet_tpu/ops/pallas/conv_fused.py, body _kernel).  Function:
//   out = relu?(conv3x3_SAME(x, w) * scale + shift), f32 accumulation,
//   stored once in the activation dtype (float32 or bfloat16).
//
// Form: an implicit GEMM with M = B*H*W output pixels, N = Cout and
// K = 9*Cin, with K ordered (tap, cin) so that row k of the GEMM's B
// operand is row k of the HWIO weight viewed as (9*Cin, Cout).  A block
// owns a (pixels x output channels) tile and walks K in steps: it gathers
// the A tile (pixels x k) straight from x, with the out-of-image taps
// zero-filled by masking (no padded copy of x), and the B tile from w,
// into shared memory, double-buffered with the next step's global loads
// in flight while the current step computes.  The epilogue applies
// scale/shift/ReLU to the f32 accumulators before the single store.
//
// Two bodies share that form:
//   * bfloat16 (the evaluation default): 128 x 64 tiles, 8 warps each
//     owning 32 x 32, on the tensor cores with mma.sync m16n8k16
//     (bf16 in, f32 accumulate);
//   * float32: 128 x 64 tiles, 8 x 4 outputs per thread, FMAs on the
//     CUDA cores, so the f32 path keeps full f32 products.
//
// Bound on the H100: at UNet's shapes the work is 9*Cin multiply-adds per
// output element, far above the card's ridge point, so it is bound by
// operations.  mma.sync reaches only part of the tensor cores' rate on
// Hopper; left for later: wgmma on tiles fed by TMA, a deeper pipeline,
// warp specialisation and a persistent tile scheduler.
//
// Offsets into x and out are 64-bit: B*H*W*C passes 2^31 at UNet's shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Source pixel of tap `tap` (0..8, row-major 3x3) for output pixel p at
// (py, px); false where the tap falls outside the image.
__device__ __forceinline__ bool tap_source(int tap, int64_t p, int py, int px,
                                           int H, int W, int64_t* src) {
  const int dy = tap / 3 - 1;
  const int dx = tap - (tap / 3) * 3 - 1;
  const int yy = py + dy;
  const int xx = px + dx;
  if (yy < 0 || yy >= H || xx < 0 || xx >= W) return false;
  *src = p + (int64_t)dy * W + dx;
  return true;
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
static_assert(BM * BK == THREADS * 8, "each thread gathers 8 A values");
static_assert(BN * BK == THREADS * 4, "each thread gathers 4 B values");

// Gathers this thread's 8 A values (one pixel, k in [k0, k0 + 8)) and 4 B
// values (one k row, 4 consecutive output channels) of K step kt.
// VEC: Cin % 8 == 0 and x is 16-byte aligned, so the 8 k's share one tap
// and are two float4 loads.
template <bool VEC>
__device__ __forceinline__ void gather(
    const float* __restrict__ x, const float* __restrict__ w, int kt, int K,
    int Cin, int Cout, int H, int W, int64_t ap, bool a_valid, int ay, int ax,
    int ak, int bk, int bn, int n0, float (&a_reg)[8], float (&b_reg)[4]) {
  const int k0 = kt * BK + ak;
  if (VEC) {
    int64_t src;
    const int tap = k0 / Cin;
    if (a_valid && k0 < K && tap_source(tap, ap, ay, ax, H, W, &src)) {
      const float* q = x + src * Cin + (k0 - tap * Cin);
      const float4 lo = *reinterpret_cast<const float4*>(q);
      const float4 hi = *reinterpret_cast<const float4*>(q + 4);
      a_reg[0] = lo.x; a_reg[1] = lo.y; a_reg[2] = lo.z; a_reg[3] = lo.w;
      a_reg[4] = hi.x; a_reg[5] = hi.y; a_reg[6] = hi.z; a_reg[7] = hi.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) a_reg[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = k0 + j;
      const int tap = k / Cin;
      int64_t src;
      a_reg[j] = (a_valid && k < K && tap_source(tap, ap, ay, ax, H, W, &src))
                     ? x[src * Cin + (k - tap * Cin)]
                     : 0.f;
    }
  }
  const int kb = kt * BK + bk;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + bn + j;
    b_reg[j] = (kb < K && n < Cout) ? w[(int64_t)kb * Cout + n] : 0.f;
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            float* __restrict__ out, int64_t M, int H, int W, int Cin,
            int Cout, int relu) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int KT = (K + BK - 1) / BK;

  // Gather roles: a warp takes 32 consecutive pixels at one k offset, so
  // its shared-memory stores hit 32 different banks.
  const int am = tid % BM;
  const int ak = (tid / BM) * 8;
  const int64_t ap = m0 + am;
  const bool a_valid = ap < M;
  int ay = 0;
  int ax = 0;
  if (a_valid) {
    const int64_t row = ap / W;
    ax = (int)(ap - row * W);
    ay = (int)(row % H);
  }
  const int bk = tid / (BN / 4);
  const int bn = (tid % (BN / 4)) * 4;

  // Compute roles: TM pixels x TN channels per thread.
  const int tn = tid % (BN / TN);
  const int tm = tid / (BN / TN);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  float a_reg[8];
  float b_reg[4];

  gather<VEC>(x, w, 0, K, Cin, Cout, H, W, ap, a_valid, ay, ax, ak, bk, bn,
              n0, a_reg, b_reg);
#pragma unroll
  for (int j = 0; j < 8; ++j) As[0][ak + j][am] = a_reg[j];
  *reinterpret_cast<float4*>(&Bs[0][bk][bn]) =
      make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) {
      gather<VEC>(x, w, kt + 1, K, Cin, Cout, H, W, ap, a_valid, ay, ax, ak,
                  bk, bn, n0, a_reg, b_reg);
    }
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
    if (more) {
      const int nxt = cur ^ 1;
#pragma unroll
      for (int j = 0; j < 8; ++j) As[nxt][ak + j][am] = a_reg[j];
      *reinterpret_cast<float4*>(&Bs[nxt][bk][bn]) =
          make_float4(b_reg[0], b_reg[1], b_reg[2], b_reg[3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int n = n0 + tn * TN + j;
    if (n >= Cout) continue;
    const float sc = scale[n];
    const float sh = shift[n];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t p = m0 + tm * TM + i;
      if (p >= M) continue;
      float v = fmaf(acc[i][j], sc, sh);
      if (relu) v = fmaxf(v, 0.f);
      out[p * Cout + n] = v;
    }
  }
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------

namespace bf16 {

constexpr int BM = 128;      // output pixels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // K step (two k16 mma steps)
constexpr int THREADS = 256;  // 8 warps: 4 along M x 2 along N
constexpr int WM = 32;       // warp tile rows
constexpr int WN = 32;       // warp tile columns
constexpr int LDS = BK + 8;  // smem row stride (bf16): conflict-free fragments

static_assert((BM / WM) * (BN / WN) * 32 == THREADS, "warp grid");
static_assert(BM * BK == THREADS * 16, "each thread gathers 16 A values");
static_assert(BN * BK == THREADS * 8, "each thread gathers 8 B values");

// D += A (16x16, row-major) * B (16x8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight bf16 values (raw bits) of x for one pixel, k in [k0, k0 + 8).
template <bool VEC>
__device__ __forceinline__ uint4 gather_a8(const uint16_t* __restrict__ x,
                                           int k0, int K, int Cin, int64_t ap,
                                           bool a_valid, int ay, int ax, int H,
                                           int W) {
  if (VEC) {
    // Cin % 8 == 0 and x 16-byte aligned: one tap, one 16-byte load.
    int64_t src;
    const int tap = k0 / Cin;
    if (a_valid && k0 < K && tap_source(tap, ap, ay, ax, H, W, &src))
      return *reinterpret_cast<const uint4*>(x + src * Cin + (k0 - tap * Cin));
    return make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t pair = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + j + h;
        const int tap = k / Cin;
        int64_t src;
        if (a_valid && k < K && tap_source(tap, ap, ay, ax, H, W, &src))
          pair |= (uint32_t)x[src * Cin + (k - tap * Cin)] << (16 * h);
      }
      r[j / 2] = pair;
    }
    return make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// Eight bf16 values of w for one output channel n, k in [k0, k0 + 8).
__device__ __forceinline__ uint4 gather_b8(const uint16_t* __restrict__ w,
                                           int k0, int K, int n, int Cout) {
  uint32_t r[4];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    uint32_t pair = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + j + h;
      if (k < K && n < Cout) pair |= (uint32_t)w[(int64_t)k * Cout + n] << (16 * h);
    }
    r[j / 2] = pair;
  }
  return make_uint4(r[0], r[1], r[2], r[3]);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
conv_kernel(const uint16_t* __restrict__ x, const uint16_t* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            __nv_bfloat16* __restrict__ out, int64_t M, int H, int W, int Cin,
            int Cout, int relu) {
  // k-contiguous rows for both operands: As[pixel][k], Bs[channel][k].
  __shared__ __align__(16) uint16_t As[2][BM][LDS];
  __shared__ __align__(16) uint16_t Bs[2][BN][LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int K = 9 * Cin;
  const int KT = (K + BK - 1) / BK;

  // Gather roles: one pixel and 16 consecutive k of A; one output channel
  // and 8 consecutive k of B (a warp reads 32 consecutive channels).
  const int am = tid % BM;
  const int ak = (tid / BM) * 16;
  const int64_t ap = m0 + am;
  const bool a_valid = ap < M;
  int ay = 0;
  int ax = 0;
  if (a_valid) {
    const int64_t row = ap / W;
    ax = (int)(ap - row * W);
    ay = (int)(row % H);
  }
  const int bn = tid % BN;
  const int bk = (tid / BN) * 8;

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
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  uint4 a_reg[2];
  uint4 b_reg;
  auto gather = [&](int kt) {
    const int k0 = kt * BK;
    a_reg[0] = gather_a8<VEC>(x, k0 + ak, K, Cin, ap, a_valid, ay, ax, H, W);
    a_reg[1] = gather_a8<VEC>(x, k0 + ak + 8, K, Cin, ap, a_valid, ay, ax, H, W);
    b_reg = gather_b8(w, k0 + bk, K, n0 + bn, Cout);
  };
  auto stage = [&](int buf) {
    *reinterpret_cast<uint4*>(&As[buf][am][ak]) = a_reg[0];
    *reinterpret_cast<uint4*>(&As[buf][am][ak + 8]) = a_reg[1];
    *reinterpret_cast<uint4*>(&Bs[buf][bn][bk]) = b_reg;
  };

  gather(0);
  stage(0);
  __syncthreads();

  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < KT;
    if (more) gather(kt + 1);
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
    if (more) stage(cur ^ 1);
    __syncthreads();
  }

  // Accumulator (mi, ni, r) sits at row g (+8 for r >= 2) and column
  // 2q + (r & 1) of the warp's 16 x 8 sub-tile (mi, ni).
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * WN + ni * 8 + 2 * q + e;
      if (n >= Cout) continue;
      const float sc = scale[n];
      const float sh = shift[n];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t p = m0 + wm * WM + mi * 16 + g + 8 * h;
          if (p >= M) continue;
          float v = fmaf(acc[mi][ni][2 * h + e], sc, sh);
          if (relu) v = fmaxf(v, 0.f);
          out[p * Cout + n] = __float2bfloat16_rn(v);
        }
      }
    }
  }
}

}  // namespace bf16

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it; scale and shift
// are float32).  vec: Cin % 8 == 0 and x 16-byte aligned, checked by the
// caller.  Returns cudaGetLastError() after the launch.
extern "C" int conv3x3_affine_relu_launch(int dtype, const void* x,
                                          const void* w, const void* scale,
                                          const void* shift, void* out,
                                          long long B, int H, int W, int Cin,
                                          int Cout, int relu, int vec,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t M = (int64_t)B * H * W;
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  if (dtype == 0) {
    const dim3 grid((unsigned)((M + f32::BM - 1) / f32::BM),
                    (unsigned)((Cout + f32::BN - 1) / f32::BN));
    const float* xt = static_cast<const float*>(x);
    const float* wt = static_cast<const float*>(w);
    float* o = static_cast<float*>(out);
    if (vec)
      f32::conv_kernel<true><<<grid, f32::THREADS, 0, s>>>(
          xt, wt, sc, sh, o, M, H, W, Cin, Cout, relu);
    else
      f32::conv_kernel<false><<<grid, f32::THREADS, 0, s>>>(
          xt, wt, sc, sh, o, M, H, W, Cin, Cout, relu);
  } else if (dtype == 1) {
    const dim3 grid((unsigned)((M + bf16::BM - 1) / bf16::BM),
                    (unsigned)((Cout + bf16::BN - 1) / bf16::BN));
    const uint16_t* xt = static_cast<const uint16_t*>(x);
    const uint16_t* wt = static_cast<const uint16_t*>(w);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    if (vec)
      bf16::conv_kernel<true><<<grid, bf16::THREADS, 0, s>>>(
          xt, wt, sc, sh, o, M, H, W, Cin, Cout, relu);
    else
      bf16::conv_kernel<false><<<grid, bf16::THREADS, 0, s>>>(
          xt, wt, sc, sh, o, M, H, W, Cin, Cout, relu);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
