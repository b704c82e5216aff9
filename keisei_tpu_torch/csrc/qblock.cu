// One eval-mode int8 SE-ResNet GlobalPoolBias block for sm_90a, on s8
// tensor cores (mma.sync m16n8k32 s8.s8 -> s32).
//
// Replaces the TPU kernel keisei_tpu/ops/qblock.py:quantized_gpbias_block
// (_qblock_kernel). Its function, per tile of bt boards with input scale sx:
//   xf = xq * sx
//   g2 = FC2(bf16(relu(FC1(bf16(mean || max || std of xf)))))
//   h  = relu(f32(conv1_s32(xq)) * (sx * m1) + b1) + g2
//   hq, sh = quantize over the tile (h)
//   z  = f32(conv2_s32(hq)) * (sh * m2) + b2
//   y  = relu(z * sigmoid(se[:C]) + se[C:] + xf),  se = SE FCs of mean(z)
//   yq, sy = quantize over the tile (y)
// quantize: scale = amax / 127 (1 if amax is 0), q = clip(rn(v / scale), +-127).
// Every multiply, add and divide outside the sums is written with the _rn
// intrinsics, so nvcc contracts none of them into an FMA and each rounds
// where the plain version rounds.
//
// The TPU kernel's banded (145, B, 3C) layout exists to give its int8
// matrix unit K >= 512; it is not carried over. Here x is (9, 9, B, C) int8
// and the conv weights are (3, 3, Cout, Cin) int8, K-contiguous per output
// channel, because ldmatrix can transpose only 16-bit elements: both MMA
// operands are then read with plain ldmatrix (an int8 k32 fragment has the
// byte layout of a bf16 k16 one).
//
// The two quantizations need the amax over a whole tile of bt boards, and
// one CTA owns one board (as in fused_block.cu), so the block is three
// kernels split at those two reductions:
//   1. conv1_kernel:   pool, gp bias, int8 conv1, h -> f32 scratch, max|h| per board
//   2. conv2_kernel:   tile scale sh, quantize h, int8 conv2, SE, residual
//                      -> y into the same f32 scratch, max|y| per board
//   3. requant_kernel: tile scale sy, quantize y -> yq
// That costs two f32 round trips of the activation through L2/HBM
// (2 x 81 x B x C x 4 bytes written and read), where the TPU kernel kept h
// and y in VMEM.
//
// What bounds it on an H100: the two int8 convs, 2 * 2*81*9*C*C operations
// per board (191 M at C=256) on the s8 tensor cores; the activation bytes
// (int8 in and out, the f32 scratch) are small beside the weights, which
// (2 x 590 KB at C=256) stream from L2 in 128-byte K slices through a
// 2-stage cp.async ring, as in conv_common.cuh.
#include <math.h>

#include "qblock_common.cuh"

namespace keisei {

// Kernel 1: pool + gp bias from the dequantized input, int8 conv1,
// h = relu(acc * (sx * m1) + b1) + g2 -> h_out (9, 9, B, C) f32, and
// max|h| of the board -> hmax[board].
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
qblock_conv1_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                    const int8_t* __restrict__ w1, const float* __restrict__ bn,
                    const __nv_bfloat16* __restrict__ gp1w, const float* __restrict__ gp1b,
                    const __nv_bfloat16* __restrict__ gp2w, const float* __restrict__ gp2b,
                    float* __restrict__ h_out, float* __restrict__ hmax, int B, int gpc, int bt) {
  constexpr int C = 64 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* x_s = reinterpret_cast<int8_t*>(smem);
  int8_t* wbuf = x_s + kRows * C;
  float* pool_s = reinterpret_cast<float*>(smem + conv_smem_bytes<NT>());  // 3C
  float* g2_s = pool_s + 3 * C;                                            // C
  float* mult_s = g2_s + C;                                                // C: sx * m1
  float* red_s = mult_s + C;                                               // kWarps
  float* g_s = red_s + kWarps;                                             // gpc

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int board = blockIdx.x;
  const float s = sx[board / bt];

  load_board_s8(x_s, xq, board, B, C);
  __syncthreads();

  // --- global-pool bias from the dequantized block input ---
  for (int c = tid; c < C; c += blockDim.x) {
    float sum = 0.f, mx = 0.f;  // the TPU kernel's max runs over the zero border too
    for (int m = 0; m < 81; ++m) {
      const float v = __fmul_rn((float)x_s[swz8(m, c >> 4, C) + (c & 15)], s);
      sum = __fadd_rn(sum, v);
      mx = fmaxf(mx, v);
    }
    const float mean = __fdiv_rn(sum, 81.f);
    float var = 0.f;
    for (int m = 0; m < 81; ++m) {
      const float d = __fsub_rn(__fmul_rn((float)x_s[swz8(m, c >> 4, C) + (c & 15)], s), mean);
      var = __fadd_rn(var, __fmul_rn(d, d));
    }
    pool_s[c] = bf16_round(mean);
    pool_s[C + c] = bf16_round(mx);
    pool_s[2 * C + c] = bf16_round(sqrtf(__fadd_rn(__fdiv_rn(var, 81.f), 1e-10f)));
    mult_s[c] = __fmul_rn(s, bn[c]);
  }
  __syncthreads();
  for (int j = tid; j < gpc; j += blockDim.x) {
    float a = 0.f;
    for (int k = 0; k < 3 * C; ++k) a += pool_s[k] * __bfloat162float(gp1w[(size_t)k * gpc + j]);
    g_s[j] = bf16_round(fmaxf(__fadd_rn(a, gp1b[j]), 0.f));
  }
  __syncthreads();
  for (int n = tid; n < C; n += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < gpc; ++j) a += g_s[j] * __bfloat162float(gp2w[(size_t)j * C + n]);
    g2_s[n] = __fadd_rn(a, gp2b[n]);
  }
  __syncthreads();

  // --- int8 conv1 -> dequant + bn1 + relu + pool bias -> h ---
  int acc[kMTiles][NT][4];
  conv_taps_s8<NT>(x_s, w1, wbuf, acc);
  const int nq = warp * NT * 8 + 2 * (lane & 3);  // first of this lane's 2 channels per n-tile
  float hm = 0.f;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + (lane >> 2) + half * 8;
      if (m >= 81) continue;
      float* dst = h_out + ((size_t)m * B + board) * C;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nq + nt * 8;
        float h[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __fadd_rn(__fmul_rn((float)acc[mt][nt][2 * half + e], mult_s[n + e]),
                                    bn[C + n + e]);
          h[e] = __fadd_rn(fmaxf(a, 0.f), g2_s[n + e]);
          hm = fmaxf(hm, fabsf(h[e]));
        }
        *reinterpret_cast<float2*>(dst + n) = make_float2(h[0], h[1]);
      }
    }
  }
  store_block_max(hm, red_s, hmax + board);
}

// Kernel 2: the tile scale sh of h, h -> int8, int8 conv2, z = acc * (sh *
// m2) + b2, SE from mean(z), y = relu(z * scale + shift + xq * sx) -> act
// (in place over this board's h), and max|y| of the board -> ymax[board].
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
qblock_conv2_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                    const int8_t* __restrict__ w2, const float* __restrict__ bn,
                    const __nv_bfloat16* __restrict__ se1w, const float* __restrict__ se1b,
                    const __nv_bfloat16* __restrict__ se2w, const float* __restrict__ se2b,
                    float* __restrict__ act, const float* __restrict__ hmax,
                    float* __restrict__ ymax, int B, int sec, int bt) {
  constexpr int C = 64 * NT;
  constexpr int cpr = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);
  int8_t* wbuf = a_s + kRows * C;
  float* mult_s = reinterpret_cast<float*>(smem + conv_smem_bytes<NT>());  // C: sh * m2
  float* zmean_s = mult_s + C;                                             // C
  float* scale_s = zmean_s + C;                                            // C
  float* shift_s = scale_s + C;                                            // C
  float* red_s = shift_s + C;                                              // kWarps
  float* sh_s = red_s + kWarps;                                            // 1
  float* se_s = sh_s + 1;                                                  // sec

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int board = blockIdx.x, tile = board / bt;

  if (warp == 0) {
    const float sh = tile_scale(hmax, tile, bt);
    if (lane == 0) *sh_s = sh;
  }
  __syncthreads();
  const float sh = *sh_s;
  for (int q = tid; q < kRows * cpr; q += blockDim.x) {
    const int p = q / cpr, ch = q % cpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (p < 81) v = quant16(act + ((size_t)p * B + board) * C + ch * 16, sh);
    *reinterpret_cast<uint4*>(a_s + swz8(p, ch, C)) = v;
  }
  for (int c = tid; c < C; c += blockDim.x) mult_s[c] = __fmul_rn(sh, bn[2 * C + c]);
  __syncthreads();

  // --- int8 conv2 -> dequant + bn2 -> z (f32 bits kept in acc), SE mean ---
  int acc[kMTiles][NT][4];
  conv_taps_s8<NT>(a_s, w2, wbuf, acc);
  load_board_s8(a_s, xq, board, B, C);  // the residual; conv2 is done with a_s
  const int nq = warp * NT * 8 + 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int n = nq + nt * 8;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 16 + (lane >> 2) + half * 8;
        const float z0 = __fadd_rn(__fmul_rn((float)acc[mt][nt][2 * half], mult_s[n]),
                                   bn[3 * C + n]);
        const float z1 = __fadd_rn(__fmul_rn((float)acc[mt][nt][2 * half + 1], mult_s[n + 1]),
                                   bn[3 * C + n + 1]);
        acc[mt][nt][2 * half] = __float_as_int(z0);
        acc[mt][nt][2 * half + 1] = __float_as_int(z1);
        if (m < 81) {
          s0 = __fadd_rn(s0, z0);
          s1 = __fadd_rn(s1, z1);
        }
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, off));
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, off));
    }
    if (lane < 4) {
      zmean_s[n] = __fdiv_rn(s0, 81.f);
      zmean_s[n + 1] = __fdiv_rn(s1, 81.f);
    }
  }
  __syncthreads();
  for (int j = tid; j < sec; j += blockDim.x) {
    float a = 0.f;
    for (int n = 0; n < C; ++n)
      a += bf16_round(zmean_s[n]) * __bfloat162float(se1w[(size_t)n * sec + j]);
    se_s[j] = bf16_round(fmaxf(__fadd_rn(a, se1b[j]), 0.f));
  }
  __syncthreads();
  for (int o = tid; o < 2 * C; o += blockDim.x) {
    float a = 0.f;
    for (int j = 0; j < sec; ++j) a += se_s[j] * __bfloat162float(se2w[(size_t)j * 2 * C + o]);
    a = __fadd_rn(a, se2b[o]);
    if (o < C)
      scale_s[o] = 1.f / (1.f + expf(-a));
    else
      shift_s[o - C] = a;
  }
  __syncthreads();

  // --- y = relu(z * scale + shift + xq * sx) -> act ---
  const float s = sx[tile];
  float ym = 0.f;
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + (lane >> 2) + half * 8;
      if (m >= 81) continue;
      float* dst = act + ((size_t)m * B + board) * C;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nq + nt * 8;
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = __int_as_float(acc[mt][nt][2 * half + e]);
          const float xf = __fmul_rn((float)a_s[swz8(m, n >> 4, C) + ((n + e) & 15)], s);
          const float v =
              __fadd_rn(__fadd_rn(__fmul_rn(z, scale_s[n + e]), shift_s[n + e]), xf);
          y[e] = fmaxf(v, 0.f);
          ym = fmaxf(ym, y[e]);
        }
        *reinterpret_cast<float2*>(dst + n) = make_float2(y[0], y[1]);
      }
    }
  }
  store_block_max(ym, red_s, ymax + board);
}

// Kernel 3: grid (B / bt, 81). The tile scale sy of y, y -> yq int8 for
// one board row of every board of the tile; row 0 also writes sy[tile].
__global__ void __launch_bounds__(kThreads)
qblock_requant_kernel(const float* __restrict__ act, const float* __restrict__ ymax,
                      int8_t* __restrict__ yq, float* __restrict__ sy, int B, int C, int bt) {
  __shared__ float scale_s;
  const int tile = blockIdx.x, m = blockIdx.y;
  if (threadIdx.x < 32) {
    const float scale = tile_scale(ymax, tile, bt);
    if (threadIdx.x == 0) {
      scale_s = scale;
      if (m == 0) sy[tile] = scale;
    }
  }
  __syncthreads();
  const float scale = scale_s;
  const int cpr = C >> 4;
  for (int q = threadIdx.x; q < bt * cpr; q += blockDim.x) {
    const size_t off = ((size_t)m * B + tile * bt + q / cpr) * C + (q % cpr) * 16;
    *reinterpret_cast<uint4*>(yq + off) = quant16(act + off, scale);
  }
}

template <int NT>
static int launch_qblock(const void* xq, const void* sx, const void* wq1, const void* wq2,
                         const void* bn, const void* gp1w, const void* gp1b, const void* gp2w,
                         const void* gp2b, const void* se1w, const void* se1b, const void* se2w,
                         const void* se2b, void* yq, void* sy, void* act, void* board_max, int B,
                         int gpc, int sec, int bt, cudaStream_t stream) {
  constexpr int C = 64 * NT;
  typedef const int8_t* QP;
  typedef const float* FP;
  typedef const __nv_bfloat16* BP;
  float* hmax = static_cast<float*>(board_max);
  float* ymax = hmax + B;

  const size_t smem1 = conv_smem_bytes<NT>() + sizeof(float) * (5 * (size_t)C + kWarps + gpc);
  cudaError_t e = cudaFuncSetAttribute(qblock_conv1_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (e != cudaSuccess) return (int)e;
  qblock_conv1_kernel<NT><<<B, kThreads, smem1, stream>>>(
      static_cast<QP>(xq), static_cast<FP>(sx), static_cast<QP>(wq1), static_cast<FP>(bn),
      static_cast<BP>(gp1w), static_cast<FP>(gp1b), static_cast<BP>(gp2w),
      static_cast<FP>(gp2b), static_cast<float*>(act), hmax, B, gpc, bt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem2 = conv_smem_bytes<NT>() + sizeof(float) * (4 * (size_t)C + kWarps + 1 + sec);
  e = cudaFuncSetAttribute(qblock_conv2_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return (int)e;
  qblock_conv2_kernel<NT><<<B, kThreads, smem2, stream>>>(
      static_cast<QP>(xq), static_cast<FP>(sx), static_cast<QP>(wq2), static_cast<FP>(bn),
      static_cast<BP>(se1w), static_cast<FP>(se1b), static_cast<BP>(se2w),
      static_cast<FP>(se2b), static_cast<float*>(act), hmax, ymax, B, sec, bt);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  qblock_requant_kernel<<<dim3(B / bt, 81), kThreads, 0, stream>>>(
      static_cast<FP>(act), ymax, static_cast<int8_t*>(yq), static_cast<float*>(sy), B, C, bt);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// xq (9, 9, B, C) int8 and sx (B/bt) f32; wq1, wq2 (3, 3, C, C) int8
// [tap][cout][cin]; bn (4, C) f32 rows [s1*ws1, b1, s2*ws2, b2]; gp1w (3C,
// gpc), gp2w (gpc, C), se1w (C, sec), se2w (sec, 2C) bf16, their biases f32
// -> yq (9, 9, B, C) int8, sy (B/bt) f32. act (9, 9, B, C) f32 and
// board_max (2, B) f32 are scratch. C must be 128 or 256 and bt must
// divide B. Launches three kernels in stream order. Returns a cudaError_t.
int keisei_quantized_gpbias_block(const void* xq, const void* sx, const void* wq1,
                                  const void* wq2, const void* bn, const void* gp1w,
                                  const void* gp1b, const void* gp2w, const void* gp2b,
                                  const void* se1w, const void* se1b, const void* se2w,
                                  const void* se2b, void* yq, void* sy, void* act,
                                  void* board_max, int B, int C, int gpc, int sec, int bt,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || bt < 1 || B % bt != 0 || gpc < 1 || sec < 1 || gpc > 4096 || sec > 4096)
    return (int)cudaErrorInvalidValue;
  if (C == 256)
    return keisei::launch_qblock<4>(xq, sx, wq1, wq2, bn, gp1w, gp1b, gp2w, gp2b, se1w, se1b,
                                    se2w, se2b, yq, sy, act, board_max, B, gpc, sec, bt, s);
  if (C == 128)
    return keisei::launch_qblock<2>(xq, sx, wq1, wq2, bn, gp1w, gp1b, gp2w, gp2b, se1w, se1b,
                                    se2w, se2b, yq, sy, act, board_max, B, gpc, sec, bt, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
