// Per-sample Dice statistics of (B, H, W) float32 maps on Hopper:
//   inter = 2 * sum(clamp(p, 0, 1) * t), ps = sum(clamp(p, 0, 1)),
//   ts = sum(t), each accumulated in f32.
//
// Replaces the TPU kernel dice_sums_pallas
// (jcfszxc_unet_tpu/ops/pallas/dice_fused.py, body _kernel), which held a
// whole map in VMEM and reduced it in one grid step per sample.
//
// Form: two passes and no atomics, so the result does not change from run
// to run.  Pass 1 runs on a (chunks, B) grid; each block clamps p in
// registers, reduces its chunk of one map to three partial sums by warp
// shuffle and shared memory, and writes partials[B, chunks, 3].  The
// ragged tail of a map (584 * 565 = 329,960 pixels on DRIVE) is masked by
// the loop bound.  Pass 2 runs one block per sample and sums that sample's
// partials in a fixed order.
//
// Bound on the H100: two f32 reads per pixel and three flops, so it is
// bound by bytes.  Left for later: 16-byte vector loads and folding pass 2
// into the last block of pass 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PART_THREADS = 256;
constexpr int FINISH_THREADS = 128;

// Sums v[0..2] over the block; the totals are valid in thread 0.
template <int THREADS>
__device__ __forceinline__ void block_sum3(float (&v)[3]) {
  __shared__ float warp_sums[THREADS / 32][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) warp_sums[warp][i] = v[i];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      float s = 0.f;
      for (int k = 0; k < THREADS / 32; ++k) s += warp_sums[k][i];
      v[i] = s;
    }
  }
}

__global__ void __launch_bounds__(PART_THREADS)
dice_partials_kernel(const float* __restrict__ p, const float* __restrict__ t,
                     float* __restrict__ partials, int64_t hw, int64_t chunk,
                     int n_chunks) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t start = (int64_t)c * chunk;
  const int64_t end = start + chunk < hw ? start + chunk : hw;
  const float* pb = p + (int64_t)b * hw;
  const float* tb = t + (int64_t)b * hw;
  float v[3] = {0.f, 0.f, 0.f};
  for (int64_t i = start + threadIdx.x; i < end; i += PART_THREADS) {
    float pv = pb[i];
    // clamp that keeps NaN, as jnp.clip / torch.clamp do
    pv = pv < 0.f ? 0.f : (pv > 1.f ? 1.f : pv);
    const float tv = tb[i];
    v[0] = fmaf(pv, tv, v[0]);
    v[1] += pv;
    v[2] += tv;
  }
  block_sum3<PART_THREADS>(v);
  if (threadIdx.x == 0) {
    float* out = partials + ((int64_t)b * n_chunks + c) * 3;
    out[0] = v[0];
    out[1] = v[1];
    out[2] = v[2];
  }
}

__global__ void __launch_bounds__(FINISH_THREADS)
dice_finish_kernel(const float* __restrict__ partials, float* __restrict__ inter,
                   float* __restrict__ ps, float* __restrict__ ts,
                   int n_chunks) {
  const int b = blockIdx.x;
  const float* pb = partials + (int64_t)b * n_chunks * 3;
  float v[3] = {0.f, 0.f, 0.f};
  for (int c = threadIdx.x; c < n_chunks; c += FINISH_THREADS) {
    v[0] += pb[c * 3];
    v[1] += pb[c * 3 + 1];
    v[2] += pb[c * 3 + 2];
  }
  block_sum3<FINISH_THREADS>(v);
  if (threadIdx.x == 0) {
    inter[b] = 2.f * v[0];
    ps[b] = v[1];
    ts[b] = v[2];
  }
}

}  // namespace

// probs, target: (B, hw) float32, contiguous.  partials: (B, n_chunks, 3)
// float32 scratch with n_chunks = ceil(hw / chunk).  inter, ps, ts: (B,)
// float32.  Returns cudaGetLastError() after both launches.
extern "C" int dice_sums_launch(const void* probs, const void* target,
                                void* partials, void* inter, void* ps,
                                void* ts, int B, long long hw, long long chunk,
                                int n_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid1((unsigned)n_chunks, (unsigned)B);
  dice_partials_kernel<<<grid1, PART_THREADS, 0, s>>>(
      static_cast<const float*>(probs), static_cast<const float*>(target),
      static_cast<float*>(partials), hw, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dice_finish_kernel<<<(unsigned)B, FINISH_THREADS, 0, s>>>(
      static_cast<const float*>(partials), static_cast<float*>(inter),
      static_cast<float*>(ps), static_cast<float*>(ts), n_chunks);
  return (int)cudaGetLastError();
}
