// One eval-mode SE-ResNet GlobalPoolBias block as a single sm_90a kernel.
//
// Replaces the TPU kernel keisei_tpu/ops/fused_block.py:fused_gpbias_block
// (_block_kernel). Per board:
//   g   = FC2(relu(FC1(bf16(mean || max || std of x))))        (std: pop, +1e-10)
//   h   = relu(conv1(x) * s1 + b1) + g                       -> bf16
//   z   = conv2(h) * s2 + b2
//   se  = FC_se2(bf16(relu(FC_se1(bf16(mean(z))))))
//   y   = relu(z * sigmoid(se[:C]) + se[C:] + x)             -> bf16
// FC inputs are rounded to bf16, all sums are f32, as in the TPU kernel.
//
// What bounds it on an H100: the two convs, 2 * 2*81*9*C*C FLOP per board
// (191 MFLOP at C=256), on the tensor cores. The point of the TPU kernel is
// that x is read once and y written once; that holds here too: x, h, the
// pool, the FC vectors and the SE vectors never leave the SM. The pool and
// the SE mean need all 81 squares of a board, so a CTA owns whole boards:
// one board, whose x and h tiles (2 x 82 x C bf16 = 82 KB at C=256) stay in
// shared memory. The conv weights (2 x 1.18 MB at C=256) cannot stay
// resident as they do in the TPU's VMEM; they stream from L2 in 32-row
// slices through a 2-stage cp.async ring, so every CTA reads 2.36 MB of
// weights from L2 per block (151 MB per block at B=64). conv2's
// accumulators stay in registers through the SE: a warp owns all 96 rows of
// its channels, so the SE mean is a warp reduction. See conv_common.cuh.
//
// The kernel is templated on a stop stage. kFull is the block above. The
// others replace the TPU bisect harness scripts/debug_fused_block.py
// (run_stage: the block without SE, cut after a stage, that stage written
// in f32): they run the same code up to the stage, write it as (9, 9, B, C)
// f32 and return:
//   kConv1   conv1's raw f32 accumulator
//   kBnRelu  relu(conv1 * s1 + b1)
//   kPool    the f32 mean of x over the 81 squares (before the bf16
//            rounding the FC input takes), broadcast over the squares
//   kGpBias  relu(conv1 * s1 + b1) + g2, before the bf16 store of h
//   kConv2   conv2's raw f32 accumulator over bf16(h), no bn2, no SE
#include <math.h>

#include "conv_common.cuh"

namespace keisei {

enum Stage { kConv1 = 0, kBnRelu = 1, kPool = 2, kGpBias = 3, kConv2 = 4, kFull = 5 };

// The f32 stage output (9, 9, B, C): channels n, n+1 of square m.
__device__ __forceinline__ void store_stage(void* out, int m, int board, int B, int C, int n,
                                            float v0, float v1) {
  *reinterpret_cast<float2*>(static_cast<float*>(out) + ((size_t)m * B + board) * C + n) =
      make_float2(v0, v1);
}

template <int NT, int STAGE>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ w2, const float* __restrict__ bn,
                   const __nv_bfloat16* __restrict__ gp1w, const float* __restrict__ gp1b,
                   const __nv_bfloat16* __restrict__ gp2w, const float* __restrict__ gp2b,
                   const __nv_bfloat16* __restrict__ se1w, const float* __restrict__ se1b,
                   const __nv_bfloat16* __restrict__ se2w, const float* __restrict__ se2b,
                   void* __restrict__ out, int B, int gpc, int sec) {
  constexpr int C = 64 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* h_s = x_s + kRows * C;
  __nv_bfloat16* wbuf = h_s + kRows * C;
  float* pool_s = reinterpret_cast<float*>(wbuf + 2 * kKStage * C);  // 3C
  float* g2_s = pool_s + 3 * C;                                        // C
  float* zmean_s = g2_s + C;                                           // C
  float* scale_s = zmean_s + C;                                        // C
  float* shift_s = scale_s + C;                                        // C
  float* g_s = shift_s + C;                                            // gpc
  float* se_s = g_s + gpc;                                             // sec

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int board = blockIdx.x;

  load_board(x_s, x, board, B, C, C);
  for (int q = tid; q < C / 8; q += blockDim.x)
    *reinterpret_cast<uint4*>(h_s + swz(kZeroRow, q, C)) = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // --- global-pool bias from the block input ---
  if constexpr (STAGE >= kPool) {
    for (int c = tid; c < C; c += blockDim.x) {
      float sum = 0.f, mx = -INFINITY;
      for (int m = 0; m < 81; ++m) {
        const float v = __bfloat162float(x_s[swz(m, c >> 3, C) + (c & 7)]);
        sum += v;
        mx = fmaxf(mx, v);
      }
      const float mean = sum / 81.f;
      if constexpr (STAGE == kPool) {
        float* o = static_cast<float*>(out) + (size_t)board * C + c;
        for (int m = 0; m < 81; ++m) o[(size_t)m * B * C] = mean;
        continue;
      }
      float var = 0.f;
      for (int m = 0; m < 81; ++m) {
        const float d = __bfloat162float(x_s[swz(m, c >> 3, C) + (c & 7)]) - mean;
        var += d * d;
      }
      pool_s[c] = bf16_round(mean);
      pool_s[C + c] = bf16_round(mx);
      pool_s[2 * C + c] = bf16_round(sqrtf(var / 81.f + 1e-10f));
    }
    __syncthreads();
    for (int j = tid; j < gpc; j += blockDim.x) {
      float a = gp1b[j];
      for (int k = 0; k < 3 * C; ++k) a += pool_s[k] * __bfloat162float(gp1w[(size_t)k * gpc + j]);
      g_s[j] = bf16_round(fmaxf(a, 0.f));
    }
    __syncthreads();
    for (int n = tid; n < C; n += blockDim.x) {
      float a = gp2b[n];
      for (int j = 0; j < gpc; ++j) a += g_s[j] * __bfloat162float(gp2w[(size_t)j * C + n]);
      g2_s[n] = a;
    }
    __syncthreads();
  }
  if constexpr (STAGE == kPool) return;

  // --- conv1 + bn1 + relu + pool bias -> h (bf16, shared memory) ---
  float acc[kMTiles][NT][4];
  conv_taps<NT>(x_s, C, w1, C, wbuf, acc);
  const int nq = warp * NT * 8 + 2 * (lane & 3);  // first of this lane's 2 channels per n-tile
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + (lane >> 2) + half * 8;
      if (m >= 81) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nq + nt * 8;
        if constexpr (STAGE == kConv1) {
          store_stage(out, m, board, B, C, n, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
          continue;
        }
        float h0 = fmaxf(acc[mt][nt][2 * half] * bn[n] + bn[C + n], 0.f);
        float h1 = fmaxf(acc[mt][nt][2 * half + 1] * bn[n + 1] + bn[C + n + 1], 0.f);
        if constexpr (STAGE == kBnRelu) {
          store_stage(out, m, board, B, C, n, h0, h1);
          continue;
        }
        h0 += g2_s[n];
        h1 += g2_s[n + 1];
        if constexpr (STAGE == kGpBias) {
          store_stage(out, m, board, B, C, n, h0, h1);
          continue;
        }
        *reinterpret_cast<__nv_bfloat162*>(h_s + swz(m, n >> 3, C) + (n & 7)) =
            __floats2bfloat162_rn(h0, h1);
      }
    }
  }
  if constexpr (STAGE < kConv2) return;
  __syncthreads();

  // --- conv2 + bn2 -> z (registers), SE mean by warp reduction ---
  conv_taps<NT>(h_s, C, w2, C, wbuf, acc);
  if constexpr (STAGE == kConv2) {
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + (lane >> 2) + half * 8;
        if (m >= 81) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          store_stage(out, m, board, B, C, nq + nt * 8, acc[mt][nt][2 * half],
                      acc[mt][nt][2 * half + 1]);
      }
    return;
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nq + nt * 8;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + (lane >> 2) + half * 8;
        float& z0 = acc[mt][nt][2 * half];
        float& z1 = acc[mt][nt][2 * half + 1];
        z0 = z0 * bn[2 * C + n] + bn[3 * C + n];
        z1 = z1 * bn[2 * C + n + 1] + bn[3 * C + n + 1];
        if (m < 81) {
          s0 += z0;
          s1 += z1;
        }
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (lane < 4) {
      zmean_s[n] = s0 / 81.f;
      zmean_s[n + 1] = s1 / 81.f;
    }
  }
  __syncthreads();
  for (int j = tid; j < sec; j += blockDim.x) {
    float a = se1b[j];
    for (int n = 0; n < C; ++n)
      a += bf16_round(zmean_s[n]) * __bfloat162float(se1w[(size_t)n * sec + j]);
    se_s[j] = bf16_round(fmaxf(a, 0.f));
  }
  __syncthreads();
  for (int o = tid; o < 2 * C; o += blockDim.x) {
    float a = se2b[o];
    for (int j = 0; j < sec; ++j) a += se_s[j] * __bfloat162float(se2w[(size_t)j * 2 * C + o]);
    if (o < C)
      scale_s[o] = 1.f / (1.f + expf(-a));
    else
      shift_s[o - C] = a;
  }
  __syncthreads();

  // --- y = relu(z * scale + shift + x) -> device memory ---
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + (lane >> 2) + half * 8;
      if (m >= 81) continue;
      __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + ((size_t)m * B + board) * C;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nq + nt * 8;
        const __nv_bfloat162 xr =
            *reinterpret_cast<const __nv_bfloat162*>(x_s + swz(m, n >> 3, C) + (n & 7));
        const float y0 = acc[mt][nt][2 * half] * scale_s[n] + shift_s[n] + __low2float(xr);
        const float y1 =
            acc[mt][nt][2 * half + 1] * scale_s[n + 1] + shift_s[n + 1] + __high2float(xr);
        *reinterpret_cast<__nv_bfloat162*>(dst + n) =
            __floats2bfloat162_rn(fmaxf(y0, 0.f), fmaxf(y1, 0.f));
      }
    }
  }
}

template <int NT, int STAGE>
static int launch_fused_block(const void* x, const void* w1, const void* w2, const void* bn,
                              const void* gp1w, const void* gp1b, const void* gp2w,
                              const void* gp2b, const void* se1w, const void* se1b,
                              const void* se2w, const void* se2b, void* out, int B, int gpc,
                              int sec, cudaStream_t stream) {
  constexpr int C = 64 * NT;
  const size_t smem = sizeof(__nv_bfloat16) * (2 * (size_t)kRows * C + 2 * kKStage * C) +
                      sizeof(float) * (7 * (size_t)C + gpc + sec);
  cudaError_t e = cudaFuncSetAttribute(fused_block_kernel<NT, STAGE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  typedef const __nv_bfloat16* BP;
  typedef const float* FP;
  fused_block_kernel<NT, STAGE><<<B, kThreads, smem, stream>>>(
      static_cast<BP>(x), static_cast<BP>(w1), static_cast<BP>(w2), static_cast<FP>(bn),
      static_cast<BP>(gp1w), static_cast<FP>(gp1b), static_cast<BP>(gp2w),
      static_cast<FP>(gp2b), static_cast<BP>(se1w), static_cast<FP>(se1b),
      static_cast<BP>(se2w), static_cast<FP>(se2b), out, B, gpc, sec);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// x (9, 9, B, C) bf16; w1, w2 (3, 3, C, C) bf16; bn (4, C) f32 rows
// [s1, b1, s2, b2]; gp1w (3C, gpc), gp2w (gpc, C), se1w (C, sec),
// se2w (sec, 2C) bf16; their biases f32 -> out (9, 9, B, C) bf16.
// C must be 128 or 256. Returns a cudaError_t.
int keisei_fused_gpbias_block(const void* x, const void* w1, const void* w2, const void* bn,
                              const void* gp1w, const void* gp1b, const void* gp2w,
                              const void* gp2b, const void* se1w, const void* se1b,
                              const void* se2w, const void* se2b, void* out, int B, int C,
                              int gpc, int sec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || gpc < 1 || sec < 1 || gpc > 4096 || sec > 4096) return (int)cudaErrorInvalidValue;
  if (C == 256)
    return keisei::launch_fused_block<4, keisei::kFull>(x, w1, w2, bn, gp1w, gp1b, gp2w, gp2b,
                                                         se1w, se1b, se2w, se2b, out, B, gpc,
                                                         sec, s);
  if (C == 128)
    return keisei::launch_fused_block<2, keisei::kFull>(x, w1, w2, bn, gp1w, gp1b, gp2w, gp2b,
                                                         se1w, se1b, se2w, se2b, out, B, gpc,
                                                         sec, s);
  return (int)cudaErrorInvalidValue;
}

// The block without SE cut after `stage` (0 conv1, 1 bnrelu, 2 pool, 3
// gpbias, 4 conv2): the same operands as above up to gp2b -> out (9, 9, B, C)
// f32. C must be 128 or 256. Returns a cudaError_t.
int keisei_fused_block_stage(const void* x, const void* w1, const void* w2, const void* bn,
                             const void* gp1w, const void* gp1b, const void* gp2w,
                             const void* gp2b, void* out, int B, int C, int gpc, int stage,
                             void* stream) {
  using namespace keisei;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || gpc < 1 || gpc > 4096) return (int)cudaErrorInvalidValue;
#define KEISEI_STAGE(NT, ST)                                                               \
  if (C == 64 * NT && stage == ST)                                                       \
    return launch_fused_block<NT, ST>(x, w1, w2, bn, gp1w, gp1b, gp2w, gp2b, nullptr,    \
                                      nullptr, nullptr, nullptr, out, B, gpc, 0, s);
  KEISEI_STAGE(4, kConv1) KEISEI_STAGE(4, kBnRelu) KEISEI_STAGE(4, kPool)
  KEISEI_STAGE(4, kGpBias) KEISEI_STAGE(4, kConv2)
  KEISEI_STAGE(2, kConv1) KEISEI_STAGE(2, kBnRelu) KEISEI_STAGE(2, kPool)
  KEISEI_STAGE(2, kGpBias) KEISEI_STAGE(2, kConv2)
#undef KEISEI_STAGE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
