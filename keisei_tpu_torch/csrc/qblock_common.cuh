// Shared pieces of the int8 block kernels (qblock.cu) and their stripped
// probes (qblock_parts.cu): the s8 tensor-core 3x3 conv of one board held in
// shared memory, the tile-wide quantization scale and int8 rounding.
#pragma once

#include "conv_common.cuh"

namespace keisei {

constexpr int kKBytes = 128;  // Cin bytes of weights per pipeline stage (4 k32 MMA steps)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The quantization scale of tile `tile` from its boards' maxima; called by
// a whole warp, every lane gets the result.
__device__ __forceinline__ float tile_scale(const float* board_max, int tile, int bt) {
  float v = 0.f;
  for (int i = threadIdx.x & 31; i < bt; i += 32) v = fmaxf(v, board_max[tile * bt + i]);
  v = warp_max(v);
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

// Quantize 16 consecutive f32 values to 16 int8 in one uint4.
__device__ __forceinline__ uint4 quant16(const float* src, float scale) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  return make_uint4(quant4(s4[0], scale), quant4(s4[1], scale), quant4(s4[2], scale),
                    quant4(s4[3], scale));
}

// The maximum of v over the CTA, written by thread 0 to *out. red_s holds
// one float per warp.
__device__ __forceinline__ void store_block_max(float v, float* red_s, float* out) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red_s[0];
    for (int i = 1; i < kWarps; ++i) m = fmaxf(m, red_s[i]);
    *out = m;
  }
}

// One board of a (9, 9, B, C) int8 activation into an 82-row swizzled
// tile; row 81 is zero.
__device__ __forceinline__ void load_board_s8(int8_t* a_s, const int8_t* __restrict__ x,
                                              int board, int B, int C) {
  const int cpr = C >> 4;
  for (int q = threadIdx.x; q < kRows * cpr; q += blockDim.x) {
    const int p = q / cpr, ch = q % cpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (p < 81) v = *reinterpret_cast<const uint4*>(x + ((size_t)p * B + board) * C + (ch << 4));
    *reinterpret_cast<uint4*>(a_s + swz8(p, ch, C)) = v;
  }
}

// acc[mt][nt][:] = the int32 sum over taps and Cin of A(shifted) x W for
// this warp's channels. w is the (3, 3, C, C) [tap][cout][cin] int8 weight
// in device memory; wbuf holds 2 stages of C x kKBytes. The 3x3 shift is in
// the A row addresses (row 81 is the zero row), as in conv_common.cuh.
// Ends with a __syncthreads().
template <int NT>
__device__ __forceinline__ void conv_taps_s8(const int8_t* a_s, const int8_t* __restrict__ w,
                                             int8_t* wbuf, int (&acc)[kMTiles][NT][4]) {
  constexpr int C = 64 * NT;
  constexpr int kchunks = C / kKBytes;
  constexpr int nstages = 9 * kchunks;
  constexpr int CPR = kKBytes / 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  auto load_stage = [&](int s, int buf) {
    const int tap = s / kchunks, k0 = (s % kchunks) * kKBytes;
    int8_t* dst = wbuf + buf * C * kKBytes;
    for (int q = tid; q < C * CPR; q += blockDim.x) {
      const int n = q / CPR, ch = q % CPR;
      cp_async16(dst + swz8(n, ch, kKBytes), w + ((size_t)(tap * C + n) * C + k0 + ch * 16), 16);
    }
  };

  // ldmatrix.x4 lane addresses. A: matrices (rows 0-7 | 8-15) x (k bytes
  // 0-15 | 16-31) -> a0..a3 of m16n8k32. B: (k lo, k hi) of n-tile 2j, then
  // of n-tile 2j+1 -> b0, b1 of each.
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achk = (lane >> 4) & 1;
  const int brow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int bchk = (lane >> 3) & 1;
  const int n_base = warp * NT * 8;

  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) load_stage(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int tap = s / kchunks, k0 = (s % kchunks) * kKBytes;
    const int di = tap / 3, dj = tap % 3;
    int src_row[kMTiles];
#pragma unroll
    for (int mt = 0; mt < kMTiles; ++mt) {
      const int m = mt * 16 + arow;
      int src = kZeroRow;
      if (m < 81) {
        const int sr = m / 9 + di - 1, sc = m % 9 + dj - 1;
        if (sr >= 0 && sr < 9 && sc >= 0 && sc < 9) src = sr * 9 + sc;
      }
      src_row[mt] = src;
    }
    const int8_t* wb = wbuf + (s & 1) * C * kKBytes;
#pragma unroll
    for (int ks = 0; ks < kKBytes / 32; ++ks) {
      uint32_t bfrag[NT][2];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j)
        ldmatrix_x4(bfrag[2 * j][0], bfrag[2 * j][1], bfrag[2 * j + 1][0], bfrag[2 * j + 1][1],
                    wb + swz8(n_base + j * 16 + brow, ks * 2 + bchk, kKBytes));
      const int kc = (k0 >> 4) + ks * 2 + achk;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, a_s + swz8(src_row[mt], kc, C));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_s8(acc[mt][nt], a0, a1, a2, a3, bfrag[nt][0], bfrag[nt][1]);
      }
    }
    __syncthreads();
  }
}

template <int NT>
__host__ __device__ constexpr size_t conv_smem_bytes() {
  return (size_t)kRows * 64 * NT + 2 * (size_t)64 * NT * kKBytes;
}

}  // namespace keisei
