// Shared pieces of the Hopper conv kernels: bf16 tensor-core 3x3 conv of
// one 9x9 board held in shared memory, with the weights streamed from L2.
//
// Layout in shared memory ("A tile"): 82 rows x Kp bf16 channels. Rows
// 0..80 are the board's squares (row-major 9x9), row 81 is all zeros and
// stands in for every out-of-board tap and for the 15 padding rows of the
// last 16-row MMA tile (M = 81 rounded up to 96). Each row is Kp/8 chunks of
// 16 bytes; chunk j of row r is stored at position j ^ (r & 7), so the eight
// rows one ldmatrix reads land in eight different bank groups.
//
// The conv is implicit GEMM: for each of the 9 taps and each 32-deep slice
// of Cin, the A fragment rows are the shifted squares (each lane of
// ldmatrix supplies its own row address, so the shift costs nothing) and
// the B fragment is a 32 x Cout slice of the HWIO weights, double-buffered
// in shared memory with cp.async. mma.sync m16n8k16 bf16 -> f32.
//
// Warps split Cout: warp w owns channels [w*8*NT, (w+1)*8*NT) over all 96
// rows, so every accumulator of a channel lives in one warp (the fused
// block's SE mean is a warp reduction). Cout = 64 * NT with 8 warps.
//
// conv_taps_tile is the general form: a CTA holds BPC boards (81*BPC rows,
// then the zero row), and its 8 warps split M as well as N (WM x WN), so
// that a tile of more than 96 rows still keeps its accumulators in
// registers; a pass covers NP = WN*NTW*8 output channels starting at n0,
// and a caller with Cout > NP makes Cout / NP passes over the same A tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace keisei {

constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 82;       // 81 squares + the zero row
constexpr int kZeroRow = 81;
constexpr int kMTiles = 6;      // 96 rows of M
constexpr int kKStage = 32;     // Cin rows of weights per pipeline stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                                  uint32_t& r3, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// int8 x int8 -> int32, m16n8k32. An s8 k32 fragment has the byte layout
// of a bf16 k16 one, so the same ldmatrix addressing feeds both.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One k32-byte MMA step in either type (s8: m16n8k32, bf16: m16n8k16), for
// kernels templated on the operand type.
__device__ __forceinline__ void mma32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  mma_s8(c, a[0], a[1], a[2], a[3], b0, b1);
}
__device__ __forceinline__ void mma32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
}

// Byte offset of (row, 16-byte chunk) in a swizzled tile whose rows are
// `width` bytes wide (chunk ^ row&7: the 8 rows one ldmatrix reads land in
// 8 different bank groups). width is a multiple of 128.
__device__ __forceinline__ int swz8(int row, int chunk, int width) {
  return row * width + ((chunk ^ (row & 7)) << 4);
}

// Element offset of (row, first channel of 16-byte chunk `chunk`) in a
// swizzled tile whose rows are `width` bf16 wide.
__device__ __forceinline__ int swz(int row, int chunk, int width) {
  return row * width + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Load boards [board0, board0 + nb) of a (9, 9, B, Cin) bf16 activation
// into an A tile of width Kp: board b's squares at rows b*81 .. b*81+80,
// then the zero row 81*nb; channels >= Cin and boards >= B are zero.
__device__ __forceinline__ void load_boards(__nv_bfloat16* a_s, const __nv_bfloat16* x,
                                            int board0, int nb, int B, int Cin, int Kp) {
  const int cpr = Kp >> 3;
  const bool vec = (Cin & 7) == 0;
  for (int q = threadIdx.x; q < (81 * nb + 1) * cpr; q += blockDim.x) {
    const int r = q / cpr, ch = q % cpr, c0 = ch << 3;
    const int b = r / 81, p = r - 81 * b;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (b < nb && board0 + b < B && c0 < Cin) {
      const __nv_bfloat16* src = x + ((size_t)p * B + board0 + b) * Cin + c0;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        alignas(16) __nv_bfloat16 e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = (c0 + i < Cin) ? src[i] : __float2bfloat16(0.f);
        v = *reinterpret_cast<const uint4*>(e);
      }
    }
    *reinterpret_cast<uint4*>(a_s + swz(r, ch, Kp)) = v;
  }
}

// One board: rows 0..80, zero row 81.
__device__ __forceinline__ void load_board(__nv_bfloat16* a_s, const __nv_bfloat16* x,
                                           int board, int B, int Cin, int Kp) {
  load_boards(a_s, x, board, 1, B, Cin, Kp);
}

// acc[i][j][:] = the sum over taps and Cin of A(shifted) x W for m-tile
// wm*MTW + i (zero past the BPC boards' rows) and channels n0 + wn*NTW*8 +
// j*8 .. +8, where warp = wm*WN + wn. a_s holds BPC boards (the A tile
// above with the zero row at 81*BPC); w is the (3, 3, Cin, Cout) bf16
// weight in device memory; wbuf holds 2 stages of kKStage x NP bf16. Ends
// with a __syncthreads().
template <int BPC, int MTW, int NTW, int WN>
__device__ __forceinline__ void conv_taps_tile(const __nv_bfloat16* a_s, int Kp,
                                               const __nv_bfloat16* __restrict__ w, int Cin,
                                               int Cout, int n0, __nv_bfloat16* wbuf,
                                               float (&acc)[MTW][NTW][4]) {
  constexpr int NP = WN * NTW * 8;
  constexpr int CPR = NP / 8;
  constexpr int kZero = 81 * BPC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int kchunks = Kp / kKStage;
  const int nstages = 9 * kchunks;

#pragma unroll
  for (int i = 0; i < MTW; ++i)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;

  auto load_stage = [&](int s, int buf) {
    const int tap = s / kchunks, k0 = (s % kchunks) * kKStage;
    __nv_bfloat16* dst_base = wbuf + buf * kKStage * NP;
    for (int q = tid; q < kKStage * CPR; q += blockDim.x) {
      const int row = q / CPR, ch = q % CPR, k = k0 + row;
      const bool ok = k < Cin;
      const __nv_bfloat16* src = w + ((size_t)(tap * Cin + (ok ? k : 0)) * Cout + n0 + ch * 8);
      cp_async16(dst_base + swz(row, ch, NP), src, ok ? 16 : 0);
    }
  };

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int acol = ((lane >> 4) & 1) * 8;               // and its 8-column half
  const int n_base = wn * NTW * 8;

  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) load_stage(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int tap = s / kchunks, k0 = (s % kchunks) * kKStage;
    const int di = tap / 3, dj = tap % 3;
    int src_row[MTW];
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
      const int m = (wm * MTW + i) * 16 + arow;
      int src = kZero;
      if (m < kZero) {
        const int b = m / 81, p = m - 81 * b;
        const int sr = p / 9 + di - 1, sc = p % 9 + dj - 1;
        if (sr >= 0 && sr < 9 && sc >= 0 && sc < 9) src = b * 81 + sr * 9 + sc;
      }
      src_row[i] = src;
    }
    const __nv_bfloat16* wb = wbuf + (s & 1) * kKStage * NP;
#pragma unroll
    for (int ks = 0; ks < kKStage / 16; ++ks) {
      uint32_t bfrag[NTW][2];
#pragma unroll
      for (int j = 0; j < NTW / 2; ++j) {
        const int krow = ks * 16 + arow;
        const int ncol = n_base + j * 16 + acol;
        ldmatrix_x4_trans(bfrag[2 * j][0], bfrag[2 * j][1], bfrag[2 * j + 1][0],
                          bfrag[2 * j + 1][1], wb + swz(krow, ncol >> 3, NP));
      }
      const int kc = (k0 + ks * 16 + acol) >> 3;
#pragma unroll
      for (int i = 0; i < MTW; ++i) {  // tiles past MT read the zero row: no branch
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, a_s + swz(src_row[i], kc, Kp));
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
          mma_bf16(acc[i][nt], a0, a1, a2, a3, bfrag[nt][0], bfrag[nt][1]);
      }
    }
    __syncthreads();
  }
}

// One board, 8 warps over Cout = 64 * NT, each warp all 96 rows.
template <int NT>
__device__ __forceinline__ void conv_taps(const __nv_bfloat16* a_s, int Kp,
                                          const __nv_bfloat16* __restrict__ w, int Cin,
                                          __nv_bfloat16* wbuf, float (&acc)[kMTiles][NT][4]) {
  conv_taps_tile<1, kMTiles, NT, kThreads / 32>(a_s, Kp, w, Cin, 64 * NT, 0, wbuf, acc);
}

}  // namespace keisei
