// The int8 block with parts stripped, for sm_90a: where qblock.cu's time goes.
//
// Replaces the TPU probe scripts/profile_qblock_parts.py:make_stripped
// (_convs_kernel, _bf16_kernel, _convs3d_kernel), the block kernel of
// keisei_tpu/ops/qblock.py with parts removed. Each variant here is built
// from qblock.cu's own pieces (qblock_common.cuh: one CTA per board, the s8
// conv with weights streamed from L2, the tile scale and int8 rounding), so
// its time is the time of those pieces inside the block:
//   convs    int8 conv1, h = max(acc * 1e-4, 0), h -> f32 scratch and the
//            board's max (kernel A); tile scale, h -> int8, int8 conv2,
//            clip(acc, +-127) -> int8 (kernel B). The f32 round trip and the
//            split at the tile-wide amax are those of qblock.cu.
//   vpuonly  convs with each GEMM replaced by its input: acc = x, then
//            acc = hq (the same two kernels, no conv).
//   novpu    conv1, acc & 1 -> int8 back into the board's shared tile,
//            conv2, acc & 1 -> int8: one kernel, no round trip.
//   bf16gemm novpu's structure on bf16 operands: h = bf16(conv1 * 1e-2) in
//            shared memory, y = bf16(conv2 * 1e-2) (conv_common.cuh's conv).
//   gemmonly both convs from x: conv1 & 1 -> out[0], conv2 & 1 -> out[1].
// The TPU variants work on the banded (145, B, 3C) layout and do not mask
// its 11x11 border, so border garbage enters their amax and their conv2
// input; here the board is (9, 9) with a zero border, which is the masked
// function (the production rule).
//
// What bounds them on an H100: the convs (2*81*9*C*C operations per board
// and conv) on the tensor cores; vpuonly moves bytes only (x in, y out).
#include <math.h>

#include "qblock_common.cuh"

namespace keisei {

enum Part { kConvs = 0, kNoVpu = 1, kVpuOnly = 2, kBf16Gemm = 3, kGemmOnly = 4 };

// fn(m, n, v0, v1) for every interior square m of this lane's accumulator
// fragments and the lane's two channels n, n+1 of each n-tile.
template <int NT, typename Acc, typename F>
__device__ __forceinline__ void each_pair(const Acc (&acc)[kMTiles][NT][4], F fn) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = warp * NT * 8 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + (lane >> 2) + half * 8;
      if (m >= 81) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        fn(m, nq + nt * 8, acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
    }
}

// The int8 values of a board tile at the lane's accumulator positions (the
// "GEMM replaced by its input" of vpuonly).
template <int NT>
__device__ __forceinline__ void tile_values(const int8_t* a_s, int (&acc)[kMTiles][NT][4]) {
  constexpr int C = 64 * NT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = warp * NT * 8 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = min(mt * 16 + (lane >> 2) + half * 8, 81);  // row 81 is zero
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = nq + nt * 8 + e;
          acc[mt][nt][2 * half + e] = a_s[swz8(m, n >> 4, C) + (n & 15)];
        }
    }
}

__device__ __forceinline__ uint16_t pack2(int q0, int q1) {
  return (uint16_t)((q0 & 0xff) | ((q1 & 0xff) << 8));
}

// int8 (9, 9, B, C) output: channels n, n+1 of square m of `board`.
__device__ __forceinline__ void store2(int8_t* out, int m, int board, int B, int C, int n,
                                       int q0, int q1) {
  *reinterpret_cast<uint16_t*>(out + ((size_t)m * B + board) * C + n) = pack2(q0, q1);
}

// convs / vpuonly, kernel A: h = max(acc * 1e-4, 0) -> act f32, max h -> hmax.
template <int NT, bool GEMM>
__global__ void __launch_bounds__(kThreads, 1)
qpart_h_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w1,
               float* __restrict__ act, float* __restrict__ hmax, int B) {
  constexpr int C = 64 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* x_s = reinterpret_cast<int8_t*>(smem);
  int8_t* wbuf = x_s + kRows * C;
  float* red_s = reinterpret_cast<float*>(smem + conv_smem_bytes<NT>());  // kWarps
  const int board = blockIdx.x;

  load_board_s8(x_s, xq, board, B, C);
  __syncthreads();
  int acc[kMTiles][NT][4];
  if constexpr (GEMM)
    conv_taps_s8<NT>(x_s, w1, wbuf, acc);
  else
    tile_values<NT>(x_s, acc);
  float hm = 0.f;
  each_pair<NT>(acc, [&](int m, int n, int a0, int a1) {
    const float h0 = fmaxf(__fmul_rn((float)a0, 1e-4f), 0.f);
    const float h1 = fmaxf(__fmul_rn((float)a1, 1e-4f), 0.f);
    hm = fmaxf(hm, fmaxf(h0, h1));
    *reinterpret_cast<float2*>(act + ((size_t)m * B + board) * C + n) = make_float2(h0, h1);
  });
  store_block_max(hm, red_s, hmax + board);
}

// convs / vpuonly, kernel B: the tile scale of h, h -> int8, acc = conv2 (or
// the int8 h), clip(acc, +-127) -> yq.
template <int NT, bool GEMM>
__global__ void __launch_bounds__(kThreads, 1)
qpart_y_kernel(const float* __restrict__ act, const float* __restrict__ hmax,
               const int8_t* __restrict__ w2, int8_t* __restrict__ yq, int B, int bt) {
  constexpr int C = 64 * NT;
  constexpr int cpr = C / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* a_s = reinterpret_cast<int8_t*>(smem);
  int8_t* wbuf = a_s + kRows * C;
  float* sh_s = reinterpret_cast<float*>(smem + conv_smem_bytes<NT>());
  const int tid = threadIdx.x, board = blockIdx.x;

  if (tid < 32) {
    const float sh = tile_scale(hmax, board / bt, bt);
    if (tid == 0) *sh_s = sh;
  }
  __syncthreads();
  const float sh = *sh_s;
  for (int q = tid; q < kRows * cpr; q += blockDim.x) {
    const int p = q / cpr, ch = q % cpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (p < 81) v = quant16(act + ((size_t)p * B + board) * C + ch * 16, sh);
    *reinterpret_cast<uint4*>(a_s + swz8(p, ch, C)) = v;
  }
  __syncthreads();
  int acc[kMTiles][NT][4];
  if constexpr (GEMM)
    conv_taps_s8<NT>(a_s, w2, wbuf, acc);
  else
    tile_values<NT>(a_s, acc);
  each_pair<NT>(acc, [&](int m, int n, int a0, int a1) {
    store2(yq, m, board, B, C, n, min(max(a0, -127), 127), min(max(a1, -127), 127));
  });
}

// novpu (SECOND = true: conv2 over the int8 h written back into the board
// tile) and gemmonly (SECOND = false: conv2 over x, both halves stored).
template <int NT, bool SECOND>
__global__ void __launch_bounds__(kThreads, 1)
qpart_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w1,
                  const int8_t* __restrict__ w2, int8_t* __restrict__ out, int B) {
  constexpr int C = 64 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* x_s = reinterpret_cast<int8_t*>(smem);
  int8_t* wbuf = x_s + kRows * C;
  const int board = blockIdx.x;

  load_board_s8(x_s, xq, board, B, C);
  __syncthreads();
  int acc[kMTiles][NT][4];
  conv_taps_s8<NT>(x_s, w1, wbuf, acc);  // ends with a __syncthreads: x_s is free
  if constexpr (SECOND) {
    each_pair<NT>(acc, [&](int m, int n, int a0, int a1) {
      *reinterpret_cast<uint16_t*>(x_s + swz8(m, n >> 4, C) + (n & 15)) = pack2(a0 & 1, a1 & 1);
    });
    __syncthreads();
  } else {
    each_pair<NT>(acc, [&](int m, int n, int a0, int a1) {
      store2(out, m, board, B, C, n, a0 & 1, a1 & 1);
    });
    out += (size_t)81 * B * C;
  }
  conv_taps_s8<NT>(x_s, w2, wbuf, acc);
  each_pair<NT>(acc, [&](int m, int n, int a0, int a1) {
    store2(out, m, board, B, C, n, a0 & 1, a1 & 1);
  });
}

// bf16gemm: h = bf16(conv1(x) * 1e-2) into the board tile, y = bf16(conv2(h)
// * 1e-2) -> out. Weights (3, 3, Cin, Cout) bf16, as conv_common.cuh reads.
template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
qpart_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                  const __nv_bfloat16* __restrict__ w2, __nv_bfloat16* __restrict__ out, int B) {
  constexpr int C = 64 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wbuf = x_s + kRows * C;
  const int board = blockIdx.x;

  load_board(x_s, x, board, B, C, C);
  __syncthreads();
  float acc[kMTiles][NT][4];
  conv_taps<NT>(x_s, C, w1, C, wbuf, acc);
  each_pair<NT>(acc, [&](int m, int n, float a0, float a1) {
    *reinterpret_cast<__nv_bfloat162*>(x_s + swz(m, n >> 3, C) + (n & 7)) =
        __floats2bfloat162_rn(__fmul_rn(a0, 1e-2f), __fmul_rn(a1, 1e-2f));
  });
  __syncthreads();
  conv_taps<NT>(x_s, C, w2, C, wbuf, acc);
  each_pair<NT>(acc, [&](int m, int n, float a0, float a1) {
    *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)m * B + board) * C + n) =
        __floats2bfloat162_rn(__fmul_rn(a0, 1e-2f), __fmul_rn(a1, 1e-2f));
  });
}

template <int NT>
static int launch_part(int part, const void* x, const void* w1, const void* w2, void* out,
                       void* act, void* board_max, int B, int bt, cudaStream_t stream) {
  typedef const int8_t* QP;
  const size_t smem = conv_smem_bytes<NT>() + sizeof(float) * kWarps;
  cudaError_t e = cudaSuccess;
  auto set = [&](const void* kernel, size_t bytes) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    return e == cudaSuccess;
  };
  float* f_act = static_cast<float*>(act);
  float* hmax = static_cast<float*>(board_max);
  int8_t* q_out = static_cast<int8_t*>(out);
  switch (part) {
    case kConvs:
    case kVpuOnly: {
      const bool gemm = part == kConvs;
      auto ka = gemm ? qpart_h_kernel<NT, true> : qpart_h_kernel<NT, false>;
      auto kb = gemm ? qpart_y_kernel<NT, true> : qpart_y_kernel<NT, false>;
      if (!set((const void*)ka, smem)) return (int)e;
      ka<<<B, kThreads, smem, stream>>>(static_cast<QP>(x), static_cast<QP>(w1), f_act, hmax, B);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
      if (!set((const void*)kb, smem)) return (int)e;
      kb<<<B, kThreads, smem, stream>>>(f_act, hmax, static_cast<QP>(w2), q_out, B, bt);
      break;
    }
    case kNoVpu:
    case kGemmOnly: {
      auto k = part == kNoVpu ? qpart_gemm_kernel<NT, true> : qpart_gemm_kernel<NT, false>;
      if (!set((const void*)k, smem)) return (int)e;
      k<<<B, kThreads, smem, stream>>>(static_cast<QP>(x), static_cast<QP>(w1),
                                       static_cast<QP>(w2), q_out, B);
      break;
    }
    case kBf16Gemm: {
      typedef const __nv_bfloat16* BP;
      constexpr int C = 64 * NT;
      const size_t bytes = sizeof(__nv_bfloat16) * ((size_t)kRows * C + 2 * kKStage * C);
      if (!set((const void*)qpart_bf16_kernel<NT>, bytes)) return (int)e;
      qpart_bf16_kernel<NT><<<B, kThreads, bytes, stream>>>(
          static_cast<BP>(x), static_cast<BP>(w1), static_cast<BP>(w2),
          static_cast<__nv_bfloat16*>(out), B);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// One stripped variant of the int8 block (part: 0 convs, 1 novpu, 2 vpuonly,
// 3 bf16gemm, 4 gemmonly). x (9, 9, B, C) int8 (bf16 for bf16gemm); w1, w2
// (3, 3, C, C) int8 [tap][cout][cin] (bf16 [tap][cin][cout] for bf16gemm)
// -> out (9, 9, B, C) int8 (bf16 for bf16gemm; (2, 9, 9, B, C) for
// gemmonly). act (9, 9, B, C) f32 and board_max (B) f32 are scratch for
// convs and vpuonly, whose tile of bt boards must divide B. C must be 128
// or 256. Returns a cudaError_t.
int keisei_qblock_part(int part, const void* x, const void* w1, const void* w2, void* out,
                       void* act, void* board_max, int B, int C, int bt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || bt < 1 || B % bt != 0) return (int)cudaErrorInvalidValue;
  if (C == 256) return keisei::launch_part<4>(part, x, w1, w2, out, act, board_max, B, bt, s);
  if (C == 128) return keisei::launch_part<2>(part, x, w1, w2, out, act, board_max, B, bt, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
