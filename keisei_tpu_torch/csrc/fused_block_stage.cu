// The fused block without SE, cut after a stage and that stage written in
// f32: the bisect harness of fused_block.cu. sm_90a only.
//
// Replaces the TPU kernel scripts/debug_fused_block.py:run_stage. It runs the
// block's own kernels (fused_block_common.cuh) up to the stage, with the
// epilogue cut there, so a stage that disagrees with its plain version names
// the production code:
//   conv1   K1's conv, the raw f32 accumulator                    (kEpiRaw)
//   bnrelu  K1's conv, relu(acc * s1 + b1)                        (kEpiBnRelu)
//   pool    K0, the f32 mean of x over the 81 squares (before the bf16
//           rounding the FC input takes), broadcast over the squares
//   gpbias  K0, then K1's conv, relu(acc * s1 + b1) + g2, before the bf16
//           store of h                                            (kEpiGpBias)
//   conv2   K0, K1 and K2 as in the block: h in bf16, then conv2's raw f32
//           accumulator over it; bn2 and the SE are K3's          (kEpiRaw)
// What bounds each is what bounds the block's kernel it runs; these exist to
// be compared, not to be fast.
#include "fused_block_common.cuh"

extern "C" {

// The block's operands up to gp2b -> out (9, 9, B, C) f32, the stage `stage`
// (0 conv1, 1 bnrelu, 2 pool, 3 gpbias, 4 conv2). Scratch the caller
// allocates: g2 (B, C) f32, h (9, 9, B, C) bf16. `boards` and `pool_boards` as
// keisei_fused_gpbias_block takes them. C must be 128 or 256. Returns a
// cudaError_t.
int keisei_fused_block_stage(const void* x, const void* w1, const void* w2, const void* bn,
                             const void* gp1w, const void* gp1b, const void* gp2w,
                             const void* gp2b, void* out, void* g2, void* h, int B, int C,
                             int gpc, int stage, int boards, int pool_boards, void* stream) {
  using namespace keisei;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || gpc < 1 || gpc > kFcMaxWidth || (C != 128 && C != 256) ||
      !aligned16({x, w1, w2, bn, gp1w, gp2w, out, g2, h}))
    return (int)cudaErrorInvalidValue;
  const float* bnf = static_cast<const float*>(bn);
  float* g2f = static_cast<float*>(g2);
  switch (stage) {
    case 0:
      return launch_block_conv<kEpiRaw>(x, w1, nullptr, nullptr, nullptr, out, B, C, boards, s);
    case 1:
      return launch_block_conv<kEpiBnRelu>(x, w1, bnf, bnf + C, nullptr, out, B, C, boards, s);
    case 2:
      return launch_gp_pool<true>(x, gp1w, gp1b, gp2w, gp2b, static_cast<float*>(out), B, C, gpc,
                                  pool_boards, s);
    case 3:
    case 4: {
      int e = launch_gp_pool<false>(x, gp1w, gp1b, gp2w, gp2b, g2f, B, C, gpc, pool_boards, s);
      if (e != 0) return e;
      if (stage == 3)
        return launch_block_conv<kEpiGpBias>(x, w1, bnf, bnf + C, g2f, out, B, C, boards, s);
      e = launch_block_conv<kEpiH>(x, w1, bnf, bnf + C, g2f, h, B, C, boards, s);
      if (e != 0) return e;
      return launch_block_conv<kEpiRaw>(h, w2, nullptr, nullptr, nullptr, out, B, C, boards, s);
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
