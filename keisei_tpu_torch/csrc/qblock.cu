// One eval-mode int8 SE-ResNet GlobalPoolBias block on Hopper: six sm_90a
// kernels enqueued by one call, the two convs on s8 wgmma fed by TMA.
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
// Every multiply, add and divide outside the integer sums is written with the
// _rn intrinsics, so nvcc contracts none of them into an FMA and each rounds
// where the plain version rounds.
//
// What bounds it on an H100: the two int8 convs, 2 * 2*81*9*C*C operations
// per board (191 M at C=256) on the s8 tensor cores. Its first port (one CTA
// per board, mma.sync from shared memory, both weight tensors streamed from
// L2 by every CTA) ran at 5% of that rate. What this design does about it:
//
// - Both convs run on conv_wgmma_common.cuh's mainloop with ConvS8: M runs
//   over 64 or 128 BOARDS AT ONE SQUARE, a tap is one dense TMA box of the
//   (9, 9, B, C) int8 activation (the border is TMA's zero fill), a K step is
//   128 channels (four k32 wgmmas), and the weights keep their (3, 3, Cout,
//   Cin) layout, K-contiguous, which is what the integer wgmma reads.
// - With that tiling no CTA holds a board's 81 squares (the pool and the SE
//   mean) nor a quantization tile's 32 boards x 81 squares (the two amaxes),
//   so the block is split at those reductions into six kernels on one stream:
//     K0 gp_pool_kernel<PoolS8>  xq, sx -> g2 (B, C) f32; zeroes the maxima
//     K1 conv + QConvH           xq, w1, m1, b1, g2 -> h f32, max|h| per tile
//     Q1 requant_kernel<C, 0>    h -> hq int8, sh
//     K2 conv + QConvSums        hq, w2 -> conv2's sums, f32
//     K3 qblock_se_kernel        sums, sh, m2, b2, SE, xq, sx -> y f32, max y
//     Q2 requant_kernel<C, 1>    y -> yq int8, sy
//   K0 is the bf16 block's pool kernel (fused_block_common.cuh) with an int8
//   loader. K2 stores the sums as they are (each converted to f32 once): the
//   affine waits for K3, where a thread owns one channel. The tile maxima
//   are warp-reduced and sent to the tile's word by atomicMax on the f32's
//   bits (qblock_common.cuh): equal bits on every run.
// - h, conv2's sums and y share one f32 buffer (each is dead when the next
//   is written; K3 reads a board-channel's 81 sums into registers and writes
//   its y over them): each crosses device memory once in 32 bits, as the
//   function keeps them f32 until their single quantization. (Q2 taking y
//   again from the sums and xq, so that y never crosses device memory, was
//   measured slower at B = 64, 256 and 1024: its per-channel loads cost more
//   than the 85 MB it saved.)
#include "fused_block_common.cuh"
#include "qblock_common.cuh"

namespace keisei {

// K0's loader: xq * sx[tile], the max over the zero border too (it starts at
// 0, as the TPU kernel's max over its padded layout does); CTA 0 zeroes the
// block's 2 x B / bt tile maxima, which K1 and K3 take after K0 has run.
struct PoolS8 {
  using FcAcc = double;
  const int8_t* xq;
  const float* sx;
  unsigned* maxima;
  int n_maxima, bt;
  __device__ __forceinline__ float operator()(int m, int board, int c, int B, int C) const {
    return __fmul_rn((float)xq[((size_t)m * B + board) * C + c], sx[board / bt]);
  }
  __device__ __forceinline__ static float max_init() { return 0.f; }
  __device__ __forceinline__ void prologue() const {
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < n_maxima; i += blockDim.x) maxima[i] = 0u;
  }
};

// K1's epilogue: h = relu(f32(acc) * (sx[tile] * m1) + b1) + g2[board] -> f32,
// and max|h| of the warp's 16 boards -> their tile's word. The warp's rows lie
// in one tile (b0 is a multiple of 64, bt of 16), so sx is one scalar per lane,
// folded into the per-channel multiplier once.
struct QConvH {
  const float* sx;
  const float* m1;
  const float* b1;
  const float* g2;
  float* h;
  unsigned* hmax;
  int bt;

  struct Cols {
    float4 m, b;
  };
  struct Row {
    float4 g;
  };
  struct Map {
    const float *m1, *b1, *g2;
    float s;             // sx of the lane's tile
    mutable float amax;  // max |h| of the lane's values so far
    __device__ __forceinline__ Cols cols(int n) const {
      const float4 m = *reinterpret_cast<const float4*>(m1 + n);
      return Cols{make_float4(__fmul_rn(s, m.x), __fmul_rn(s, m.y), __fmul_rn(s, m.z),
                              __fmul_rn(s, m.w)),
                  *reinterpret_cast<const float4*>(b1 + n)};
    }
    // A row past B reads the last board's bias and is never stored: no branch.
    __device__ __forceinline__ Row row(int n, int b, int B, int C) const {
      return Row{*reinterpret_cast<const float4*>(g2 + (size_t)min(b, B - 1) * C + n)};
    }
    __device__ __forceinline__ float one(int a, float m, float b, float g) const {
      const float v = __fadd_rn(fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(a), m), b), 0.f), g);
      amax = fmaxf(amax, fabsf(v));
      return v;
    }
    __device__ __forceinline__ float4 operator()(int4 a, const Cols& c, const Row& r) const {
      return make_float4(one(a.x, c.m.x, c.b.x, r.g.x), one(a.y, c.m.y, c.b.y, r.g.y),
                         one(a.z, c.m.z, c.b.z, r.g.z), one(a.w, c.m.w, c.b.w, r.g.w));
    }
  };

  template <int NACC>
  __device__ __forceinline__ void operator()(const int (&acc)[NACC], int p, int board, int n0,
                                             int q, int B, int Cout) const {
    const int row0 = board - ((threadIdx.x & 31) >> 2);  // the warp's first row
    const Map f{m1, b1, g2, sx[min(row0, B - 1) / bt], 0.f};
    // 128 columns: a ring of 2 row loads, or the 64 x 128 tile (128 registers
    // at 2 CTAs per SM) spills
    store_tile_mapped<2 * NACC, NACC == 64 ? 2 : 4>(acc, h, p, board, n0, q, B, Cout, f);
    warp_tile_max(f.amax, hmax, row0, B, bt);
  }
};

// K2's epilogue: conv2's sums as they are, each converted to f32 once (a sum
// above 2^24 rounds here, as the plain version's one conversion rounds it).
struct QConvSums {
  float* out;
  __device__ __forceinline__ NoLoad cols(int) const { return {}; }
  __device__ __forceinline__ NoLoad row(int, int, int, int) const { return {}; }
  __device__ __forceinline__ float4 operator()(int4 a, NoLoad, NoLoad) const {
    return make_float4(__int2float_rn(a.x), __int2float_rn(a.y), __int2float_rn(a.z),
                       __int2float_rn(a.w));
  }
  template <int NACC>
  __device__ __forceinline__ void operator()(const int (&acc)[NACC], int p, int board, int n0,
                                             int q, int B, int Cout) const {
    store_tile_mapped<2 * NACC>(acc, out, p, board, n0, q, B, Cout, *this);
  }
};

// ---- K3: SE over z, residual with xq * sx -> y, max y per tile --------------
//
// One CTA per board, one thread per channel: z = sum * (sh * m2) + b2 with the
// thread's own scalars, its 81 values in registers between the mean and the
// output, which goes over the sums in `act`.
__global__ void __launch_bounds__(256)
qblock_se_kernel(float* act, const float* __restrict__ sh, const float* __restrict__ bn,
                 const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const __nv_bfloat16* __restrict__ se1w, const float* __restrict__ se1b,
                 const __nv_bfloat16* __restrict__ se2w, const float* __restrict__ se2b,
                 unsigned* __restrict__ ymax, int B, int sec, int bt) {
  extern __shared__ __align__(16) float fc_smem[];
  const int C = blockDim.x, c = threadIdx.x, board = blockIdx.x, tile = board / bt;
  float* zmean_s = fc_smem;       // C
  float* se_s = zmean_s + C;      // sec
  float* red_s = se_s + sec;      // a float per warp
  double* part_s = reinterpret_cast<double*>(fc_smem + acc_aligned<double>(C + sec + C / 32));

  const float mult = __fmul_rn(sh[tile], bn[2 * C + c]), b2 = bn[3 * C + c];
  float v[kSquares];
#pragma unroll
  for (int m = 0; m < kSquares; ++m) v[m] = act[((size_t)m * B + board) * C + c];
  float sum = 0.f;
#pragma unroll
  for (int m = 0; m < kSquares; ++m) {
    v[m] = __fadd_rn(__fmul_rn(v[m], mult), b2);
    sum = __fadd_rn(sum, v[m]);
  }
  zmean_s[c] = round_bf16(__fdiv_rn(sum, 81.f));
  __syncthreads();
  int slices = fc_partials<1>(zmean_s, se1w, C, sec, part_s);
  __syncthreads();
  for (int j = c; j < sec; j += C)
    se_s[j] = round_bf16(fmaxf(__fadd_rn(se1b[j], fc_sum<1>(part_s, slices, sec, 0, j)), 0.f));
  __syncthreads();
  slices = fc_partials<1>(se_s, se2w, sec, 2 * C, part_s);
  __syncthreads();
  const float gate = __fadd_rn(se2b[c], fc_sum<1>(part_s, slices, 2 * C, 0, c));
  const float scale = 1.f / (1.f + expf(-gate));
  const float shift = __fadd_rn(se2b[C + c], fc_sum<1>(part_s, slices, 2 * C, 0, C + c));
  const float s = sx[tile];
  float ym = 0.f;
#pragma unroll
  for (int m = 0; m < kSquares; ++m) {
    const size_t at = ((size_t)m * B + board) * C + c;
    const float xf = __fmul_rn((float)xq[at], s);
    const float y = fmaxf(__fadd_rn(__fadd_rn(__fmul_rn(v[m], scale), shift), xf), 0.f);
    act[at] = y;
    ym = fmaxf(ym, y);
  }
  ym = warp_max(ym);
  if ((c & 31) == 0) red_s[c >> 5] = ym;
  __syncthreads();
  if (c == 0) {
    for (int w = 1; w < C / 32; ++w) ym = fmaxf(ym, red_s[w]);
    atomicMax(ymax + tile, max_word(ym));
  }
}

static int launch_qblock_se(float* act, const float* sh, const float* bn, const void* xq,
                            const void* sx, const void* se1w, const void* se1b, const void* se2w,
                            const void* se2b, unsigned* ymax, int B, int C, int sec, int bt,
                            cudaStream_t stream) {
  const size_t smem = sizeof(float) * acc_aligned<double>(C + sec + C / 32) +
                      sizeof(double) * fc_part_floats(1, C, sec > 2 * C ? sec : 2 * C);
  cudaError_t e = cudaFuncSetAttribute(qblock_se_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  qblock_se_kernel<<<B, C, smem, stream>>>(
      act, sh, bn, static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const __nv_bfloat16*>(se1w), static_cast<const float*>(se1b),
      static_cast<const __nv_bfloat16*>(se2w), static_cast<const float*>(se2b), ymax, B, sec, bt);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// xq (9, 9, B, C) int8 and sx (B/bt) f32; wq1, wq2 (3, 3, C, C) int8
// [tap][cout][cin]; bn (4, C) f32 rows [s1*ws1, b1, s2*ws2, b2]; gp1w (3C,
// gpc), gp2w (gpc, C), se1w (C, sec), se2w (sec, 2C) bf16, their biases f32
// -> yq (9, 9, B, C) int8, sy (B/bt) f32. Scratch the caller allocates: g2
// (B, C) f32, act (9, 9, B, C) f32 (h, then conv2's sums, then y), hq (9, 9,
// B, C) int8, stats (3, B/bt) of 32 bits (the h and y maxima, then sh).
// `boards` (64 or 128) is the convs' tile height, `pool_boards` (1 or 4) the
// boards per CTA of the pool kernel. C must be 128 or 256, bt a multiple of
// 16 that divides B, and every pointer 16-byte aligned. Enqueues six
// kernels; returns a cudaError_t.
int keisei_quantized_gpbias_block(const void* xq, const void* sx, const void* wq1,
                                  const void* wq2, const void* bn, const void* gp1w,
                                  const void* gp1b, const void* gp2w, const void* gp2b,
                                  const void* se1w, const void* se1b, const void* se2w,
                                  const void* se2b, void* yq, void* sy, void* g2, void* act,
                                  void* hq, void* stats, int B, int C, int gpc, int sec, int bt,
                                  int boards, int pool_boards, void* stream) {
  using namespace keisei;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || bt < 16 || bt % 16 != 0 || B % bt != 0 || gpc < 1 || sec < 1 ||
      gpc > kFcMaxWidth || sec > kFcMaxWidth || (C != 128 && C != 256) ||
      !aligned16({xq, wq1, wq2, bn, gp1w, gp2w, se1w, se2w, yq, g2, act, hq, stats}))
    return (int)cudaErrorInvalidValue;
  const int tiles = B / bt;
  const float* bnf = static_cast<const float*>(bn);
  const float* sxf = static_cast<const float*>(sx);
  float* g2f = static_cast<float*>(g2);
  float* actf = static_cast<float*>(act);
  unsigned* hmax = static_cast<unsigned*>(stats);
  unsigned* ymax = hmax + tiles;
  float* sh = reinterpret_cast<float*>(ymax + tiles);

  int e = launch_gp_pool<false>(PoolS8{static_cast<const int8_t*>(xq), sxf, hmax, 2 * tiles, bt},
                                gp1w, gp1b, gp2w, gp2b, g2f, B, C, gpc, pool_boards, s);
  if (e != 0) return e;
  e = conv3x3_wgmma<QConvH, ConvS8>(xq, wq1, QConvH{sxf, bnf, bnf + C, g2f, actf, hmax, bt}, B, C,
                                    C, boards, C, 1, s);
  if (e != 0) return e;
  e = launch_requant<0>(actf, hmax, hq, sh, B, C, bt, s);
  if (e != 0) return e;
  e = conv3x3_wgmma<QConvSums, ConvS8>(hq, wq2, QConvSums{actf}, B, C, C, boards, C, 1, s);
  if (e != 0) return e;
  e = launch_qblock_se(actf, sh, bnf, xq, sx, se1w, se1b, se2w, se2b, ymax, B, C, sec, bt, s);
  if (e != 0) return e;
  return launch_requant<1>(actf, ymax, yq, static_cast<float*>(sy), B, C, bt, s);
}

}  // extern "C"
