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

// Element offset of (row, first channel of 16-byte chunk `chunk`) in a
// swizzled tile whose rows are `width` bf16 wide.
__device__ __forceinline__ int swz(int row, int chunk, int width) {
  return row * width + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Load one board of a (9, 9, B, Cin) bf16 activation into an A tile of
// width Kp (channels >= Cin and row 81 zero).
__device__ __forceinline__ void load_board(__nv_bfloat16* a_s, const __nv_bfloat16* x,
                                           int board, int B, int Cin, int Kp) {
  const int cpr = Kp >> 3;
  const bool vec = (Cin & 7) == 0;
  for (int q = threadIdx.x; q < kRows * cpr; q += blockDim.x) {
    const int p = q / cpr, ch = q % cpr, c0 = ch << 3;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (p < 81 && c0 < Cin) {
      const __nv_bfloat16* src = x + ((size_t)p * B + board) * Cin + c0;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(src);
      } else {
        alignas(16) __nv_bfloat16 e[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = (c0 + i < Cin) ? src[i] : __float2bfloat16(0.f);
        v = *reinterpret_cast<const uint4*>(e);
      }
    }
    *reinterpret_cast<uint4*>(a_s + swz(p, ch, Kp)) = v;
  }
}

// acc[mt][nt][:] += sum over taps and Cin of A(shifted) x W for this warp's
// channels. w is the (3, 3, Cin, 64*NT) bf16 weight in device memory; wbuf
// holds 2 stages of kKStage x Cout bf16. Ends with a __syncthreads().
template <int NT>
__device__ __forceinline__ void conv_taps(const __nv_bfloat16* a_s, int Kp,
                                          const __nv_bfloat16* __restrict__ w, int Cin,
                                          __nv_bfloat16* wbuf, float (&acc)[kMTiles][NT][4]) {
  constexpr int COUT = 64 * NT;
  constexpr int CPR = COUT / 8;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kchunks = Kp / kKStage;
  const int nstages = 9 * kchunks;

#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  auto load_stage = [&](int s, int buf) {
    const int tap = s / kchunks, k0 = (s % kchunks) * kKStage;
    __nv_bfloat16* dst_base = wbuf + buf * kKStage * COUT;
    for (int q = tid; q < kKStage * CPR; q += blockDim.x) {
      const int row = q / CPR, ch = q % CPR, k = k0 + row;
      const bool ok = k < Cin;
      const __nv_bfloat16* src = w + ((size_t)(tap * Cin + (ok ? k : 0)) * COUT + ch * 8);
      cp_async16(dst_base + swz(row, ch, COUT), src, ok ? 16 : 0);
    }
  };

  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix row of this lane
  const int acol = ((lane >> 4) & 1) * 8;               // and its 8-column half
  const int n_base = warp * NT * 8;

  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) load_stage(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int tap = s / kchunks, k0 = (s % kchunks) * kKStage;
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
    const __nv_bfloat16* wb = wbuf + (s & 1) * kKStage * COUT;
#pragma unroll
    for (int ks = 0; ks < kKStage / 16; ++ks) {
      uint32_t bfrag[NT][2];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int krow = ks * 16 + arow;
        const int ncol = n_base + j * 16 + acol;
        ldmatrix_x4_trans(bfrag[2 * j][0], bfrag[2 * j][1], bfrag[2 * j + 1][0],
                          bfrag[2 * j + 1][1], wb + swz(krow, ncol >> 3, COUT));
      }
      const int kc = (k0 + ks * 16 + acol) >> 3;
#pragma unroll
      for (int mt = 0; mt < kMTiles; ++mt) {
        uint32_t a0, a1, a2, a3;
        ldmatrix_x4(a0, a1, a2, a3, a_s + swz(src_row[mt], kc, Kp));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a0, a1, a2, a3, bfrag[nt][0], bfrag[nt][1]);
      }
    }
    __syncthreads();
  }
}

}  // namespace keisei
