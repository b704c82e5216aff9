// One eval-mode SE-ResNet GlobalPoolBias block on Hopper: four sm_90a kernels
// enqueued by one call.
//
// Replaces the TPU kernel keisei_tpu/ops/fused_block.py:fused_gpbias_block
// (_block_kernel). Per board:
//   g2  = FC2(relu(FC1(bf16(mean || max || std of x))))        (std: pop, +1e-10)
//   h   = relu(conv1(x) * s1 + b1) + g2                      -> bf16
//   z   = conv2(h) * s2 + b2                                    (f32)
//   se  = FC_se2(bf16(relu(FC_se1(bf16(mean(z))))))
//   y   = relu(z * sigmoid(se[:C]) + se[C:] + x)             -> bf16
// FC inputs are rounded to bf16, all sums are f32, z stays f32 through the SE
// scale, the shift and the residual, as in the TPU kernel.
//
// What bounds it on an H100: the two convs, 2 * 2*81*9*C*C FLOP per board
// (191 MFLOP at C=256), on the tensor cores. The TPU kernel is one kernel
// whose grid step owns whole boards; its port as one CTA per board on mma.sync
// (this file's first version) ran at a seventh of the card's rate: an 81-row M
// tile padded to 96, 2.36 MB of weights streamed from L2 by every CTA, and
// mma.sync from shared memory, which tops out under half of the bf16 peak.
// What this design does about it:
//
// - Both convs run on the wgmma + TMA mainloop of conv_wgmma_common.cuh, whose
//   M runs over 64 or 128 BOARDS AT ONE SQUARE: a tap is a dense TMA box, a
//   weight slice serves the whole tile, and the accumulator never pads.
// - With that tiling no CTA holds the 81 squares of a board, which the global
//   pool of x and the SE mean of z need. So the block is split at those two
//   board-wide reductions into four kernels on one stream:
//     K0 gp_pool_kernel      x -> g2 (B, C) f32             one thread per channel
//     K1 conv + kEpiH        x, w1, s1, b1, g2 -> h bf16    persistent wgmma tiles
//     K2 conv + kEpiRaw      h, w2 -> conv2's sums, f32     the same tiles
//     K3 se_residual_kernel  sums, s2, b2, x -> y bf16      one thread per channel
//   (z = sums * s2 + b2 is taken in K3, where a thread owns one channel.)
//   h costs one bf16 round trip and conv2's sums one f32 round trip through device
//   memory (L2 at B <= 256: x, h and z of a block are 10.6 MB at B=64, 42 MB
//   at B=256). The sums cross in f32 because the function keeps z f32 until
//   y's single rounding; a bf16 z would halve the traffic and be another
//   function.
// - Why not a cluster whose CTAs cover a board tile's 81 squares and reduce
//   over distributed shared memory: clusters that run in lock-step were
//   slower than independent CTAs at every B on this mainloop (measured on
//   the conv with 2-CTA multicast), and 81 CTAs exceed a cluster's 16.
// - Why no atomics: K0 and K3 give a thread one channel of one board, its 81
//   values in registers, summed in square order, and the in-block FCs add
//   their partial sums in slice order. Two runs give the same bits.
//
// The stage harness (fused_block_stage.cu) runs these same kernels cut after
// a stage.
#include "fused_block_common.cuh"

namespace keisei {

// ---- K3: SE over z, residual with x -> y --------------------------------------
//
// One CTA per board, one thread per channel: z = conv2's sum * s2 + b2 with the
// thread's own two scalars, its 81 values in registers between the mean and
// the output.
__global__ void __launch_bounds__(256)
se_residual_kernel(const float* __restrict__ sums, const float* __restrict__ bn2,
                   const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ se1w,
                   const float* __restrict__ se1b,
                   const __nv_bfloat16* __restrict__ se2w, const float* __restrict__ se2b,
                   __nv_bfloat16* __restrict__ y, int B, int sec) {
  extern __shared__ __align__(16) float fc_smem[];
  const int C = blockDim.x, c = threadIdx.x, board = blockIdx.x;
  float* zmean_s = fc_smem;        // C
  float* se_s = zmean_s + C;       // sec
  float* part_s = se_s + sec;

  const float s2 = bn2[c], b2 = bn2[C + c];
  float v[kSquares];
#pragma unroll
  for (int m = 0; m < kSquares; ++m) v[m] = sums[((size_t)m * B + board) * C + c];
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < kSquares; ++m) {
    v[m] = v[m] * s2 + b2;
    sum += v[m];
  }
  zmean_s[c] = round_bf16(sum / 81.f);
  __syncthreads();
  int slices = fc_partials<1>(zmean_s, se1w, C, sec, part_s);
  __syncthreads();
  for (int j = c; j < sec; j += C)
    se_s[j] = round_bf16(fmaxf(se1b[j] + fc_sum<1>(part_s, slices, sec, 0, j), 0.f));
  __syncthreads();
  slices = fc_partials<1>(se_s, se2w, sec, 2 * C, part_s);
  __syncthreads();
  const float gate = se2b[c] + fc_sum<1>(part_s, slices, 2 * C, 0, c);
  const float scale = 1.f / (1.f + expf(-gate));
  const float shift = se2b[C + c] + fc_sum<1>(part_s, slices, 2 * C, 0, C + c);
#pragma unroll
  for (int m = 0; m < kSquares; ++m) {
    const size_t at = ((size_t)m * B + board) * C + c;
    y[at] = __float2bfloat16_rn(fmaxf(v[m] * scale + shift + __bfloat162float(x[at]), 0.f));
  }
}

static int launch_se_residual(const float* sums, const float* bn2, const void* x,
                              const void* se1w, const void* se1b, const void* se2w,
                              const void* se2b, void* y, int B, int C, int sec,
                              cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)C + sec +
                                       fc_part_floats(1, C, sec > 2 * C ? sec : 2 * C));
  cudaError_t e = cudaFuncSetAttribute(se_residual_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  se_residual_kernel<<<B, C, smem, stream>>>(
      sums, bn2, static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(se1w),
      static_cast<const float*>(se1b), static_cast<const __nv_bfloat16*>(se2w),
      static_cast<const float*>(se2b), static_cast<__nv_bfloat16*>(y), B, sec);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// x (9, 9, B, C) bf16; w1, w2 (3, 3, C, C) bf16; bn (4, C) f32 rows
// [s1, b1, s2, b2]; gp1w (3C, gpc), gp2w (gpc, C), se1w (C, sec),
// se2w (sec, 2C) bf16; their biases f32 -> out (9, 9, B, C) bf16. Scratch the
// caller allocates: g2 (B, C) f32, h (9, 9, B, C) bf16, z (9, 9, B, C) f32
// (conv2's sums).
// `boards` (64 or 128) is the convs' tile height, `pool_boards` (1 or 4) the
// boards per CTA of the pool kernel. C must be 128 or 256 and every pointer
// 16-byte aligned. Enqueues four kernels; returns a cudaError_t.
int keisei_fused_gpbias_block(const void* x, const void* w1, const void* w2, const void* bn,
                              const void* gp1w, const void* gp1b, const void* gp2w,
                              const void* gp2b, const void* se1w, const void* se1b,
                              const void* se2w, const void* se2b, void* out, void* g2, void* h,
                              void* z, int B, int C, int gpc, int sec, int boards,
                              int pool_boards, void* stream) {
  using namespace keisei;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || gpc < 1 || sec < 1 || gpc > kFcMaxWidth || sec > kFcMaxWidth ||
      (C != 128 && C != 256) ||
      !aligned16({x, w1, w2, bn, gp1w, gp2w, se1w, se2w, out, g2, h, z}))
    return (int)cudaErrorInvalidValue;
  const float* bnf = static_cast<const float*>(bn);
  float* g2f = static_cast<float*>(g2);
  int e = launch_gp_pool<false>(x, gp1w, gp1b, gp2w, gp2b, g2f, B, C, gpc, pool_boards, s);
  if (e != 0) return e;
  e = launch_block_conv<kEpiH>(x, w1, bnf, bnf + C, g2f, h, B, C, boards, s);
  if (e != 0) return e;
  e = launch_block_conv<kEpiRaw>(h, w2, nullptr, nullptr, nullptr, z, B, C, boards, s);
  if (e != 0) return e;
  return launch_se_residual(static_cast<const float*>(z), bnf + 2 * C, x, se1w, se1b, se2w, se2b,
                            out, B, C, sec, s);
}

}  // extern "C"
