// Shared pieces of the GEMM probes (tiled_mm.cu, dot_chain.cu): 8 warps as
// 2 x 4 over a 64 x 128 CTA tile, each warp 32 x 32 (2 m16 x 4 n8 tiles);
// both operands K-contiguous in swizzled shared memory (A [m][k], B [n][k],
// rows a multiple of 128 bytes wide), read with plain ldmatrix as in
// mma_rate.cu; s8 (m16n8k32 -> s32) or bf16 (m16n8k16 -> f32).
#pragma once

#include <type_traits>

#include "conv_common.cuh"

namespace keisei {

constexpr int kTileM = 64;
constexpr int kTileN = 128;
constexpr int kSliceBytes = 128;  // K bytes per pipeline stage: 4 k32-byte MMA steps

template <bool BF16>
using GemmAcc = typename std::conditional<BF16, float, int>::type;

template <typename Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[2][4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
}

// acc += A[a_row0 .. +32][one 128-byte K slice] x B[b_row0 .. +32][the same
// slice]^T, the slice starting at 16-byte chunk a_chunk0 of A's rows and
// b_chunk0 of B's.
template <typename Acc>
__device__ __forceinline__ void warp_mma_slice(Acc (&acc)[2][4][4], const unsigned char* a_s,
                                               int a_width, int a_row0, int a_chunk0,
                                               const unsigned char* b_s, int b_width, int b_row0,
                                               int b_chunk0) {
  const int lane = threadIdx.x & 31;
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achk = (lane >> 4) & 1;
  const int brow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int bchk = (lane >> 3) & 1;
#pragma unroll
  for (int ks = 0; ks < kSliceBytes / 32; ++ks) {
    uint32_t af[2][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                  a_s + swz8(a_row0 + mt * 16 + arow, a_chunk0 + ks * 2 + achk, a_width));
#pragma unroll
    for (int j = 0; j < 2; ++j)
      ldmatrix_x4(bf[2 * j][0], bf[2 * j][1], bf[2 * j + 1][0], bf[2 * j + 1][1],
                  b_s + swz8(b_row0 + j * 16 + brow, b_chunk0 + ks * 2 + bchk, b_width));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma32(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

// Copy `rows` rows of one 128-byte K slice (from byte k0 of rows `row_bytes`
// wide, starting at row r0 of a matrix with `nrows` rows) into a swizzled
// stage 128 bytes wide; rows past the matrix are zero-filled.
__device__ __forceinline__ void load_slice(unsigned char* dst, const unsigned char* src,
                                           int row_bytes, int r0, int nrows, int rows, int k0) {
  for (int q = threadIdx.x; q < rows * 8; q += blockDim.x) {
    const int r = q >> 3, c = q & 7;
    const bool ok = r0 + r < nrows;
    cp_async16(dst + swz8(r, c, kSliceBytes),
               src + (size_t)(ok ? r0 + r : 0) * row_bytes + k0 + c * 16, ok ? 16 : 0);
  }
}

}  // namespace keisei
