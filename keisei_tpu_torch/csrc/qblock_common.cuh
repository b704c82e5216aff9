// The int8 block's quantization pieces, shared by qblock.cu (the block) and
// qblock_parts.cu (its stripped variants): the tile-wide maxima, the tile
// scale, int8 rounding, and the requantize kernel Q. sm_90a only.
//
// A tile of bt boards (bt a multiple of 16) has one scale, amax / 127 (1 if
// amax is 0), from the largest |v| over its boards. The kernels that write v
// reduce it in the warp and send it to the tile's word with atomicMax on the
// bits of the non-negative f32: non-negative floats order like their
// unsigned bits, and a maximum does not depend on order, so two runs give
// the same bits. The words start at 0 on the stream (K0 or a memset zeroes
// them), so a CUDA graph replay starts clean.
#pragma once

#include "conv_wgmma_common.cuh"

namespace keisei {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The word of a non-negative maximum: fabsf turns a -0 (which fmaxf may
// return for a zero) into +0, whose bits order below every positive float.
__device__ __forceinline__ unsigned max_word(float v) { return __float_as_uint(fabsf(v)); }

// The max over the warp's lanes of v (>= 0) -> the word of the tile that
// holds `row` (one of the warp's rows, all in one tile), unless row >= B. All
// 32 lanes must call it.
__device__ __forceinline__ void warp_tile_max(float v, unsigned* __restrict__ words, int row,
                                              int B, int bt) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0 && row < B) atomicMax(words + row / bt, max_word(v));
}

// The quantization scale of a tile from the bits of its amax.
__device__ __forceinline__ float tile_scale(unsigned amax_bits) {
  const float v = __uint_as_float(amax_bits);
  return v > 0.f ? __fdiv_rn(v, 127.f) : 1.f;
}

__device__ __forceinline__ uint32_t quant4(float4 v, float scale) {
  const float e[4] = {v.x, v.y, v.z, v.w};
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = min(max(__float2int_rn(__fdiv_rn(e[i], scale)), -127), 127);
    out |= (uint32_t)(q & 0xff) << (8 * i);
  }
  return out;
}

// The requantize passes' grid: one thread per 16 channels of one board at
// one square (one 16-byte store, and the index arithmetic, the tile's scale
// and its IEEE quotient once per 16 values: these passes move 5 bytes per
// value, and at 4 values a thread they were as much instructions as bytes);
// blockIdx.y is the square, so no thread divides by B.
template <int C>
struct RequantGrid {
  static constexpr int kChunks = C / 16;  // threads per board row
  int board, n;                           // the thread's board and first channel
  size_t at;                              // the thread's 16-value chunk in (9, 9, B, C)
  __device__ __forceinline__ explicit RequantGrid(int B) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    board = j / kChunks;
    n = (j - board * kChunks) * 16;
    at = (size_t)blockIdx.y * B * kChunks + j;
  }
  static dim3 grid(int B) { return dim3((B * kChunks + 255) / 256, 81); }
};

// The B / bt scales of a tile's words -> scales, by the first threads.
__device__ __forceinline__ void write_scales(const unsigned* amax, float* scales, int tiles) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.y == 0 && j < tiles) scales[j] = tile_scale(amax[j]);
}

// Q: v (9, 9, B, C) f32 -> out int8, each value rounded with its tile's
// scale; the B / bt scales -> scales (unless null). PASS only names the
// kernel (0: h, 1: y), so that a trace tells the block's two passes apart.
template <int C, int PASS>
__global__ void __launch_bounds__(256)
requant_kernel(const float4* __restrict__ v, const unsigned* __restrict__ amax,
               uint4* __restrict__ out, float* __restrict__ scales, int B, int bt) {
  const RequantGrid<C> t(B);
  if (scales != nullptr) write_scales(amax, scales, B / bt);
  if (t.board >= B) return;
  const float s = tile_scale(amax[t.board / bt]);
  const float4* src = v + 4 * t.at;
  out[t.at] = make_uint4(quant4(src[0], s), quant4(src[1], s), quant4(src[2], s),
                         quant4(src[3], s));
}

template <int PASS>
static int launch_requant(const float* v, const unsigned* amax, void* out, float* scales, int B,
                          int C, int bt, cudaStream_t stream) {
  const float4* src = reinterpret_cast<const float4*>(v);
  uint4* dst = static_cast<uint4*>(out);
  if (C == 256)
    requant_kernel<256, PASS><<<RequantGrid<256>::grid(B), 256, 0, stream>>>(src, amax, dst,
                                                                             scales, B, bt);
  else if (C == 128)
    requant_kernel<128, PASS><<<RequantGrid<128>::grid(B), 256, 0, stream>>>(src, amax, dst,
                                                                             scales, B, bt);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace keisei
