// The 3x3 conv's wgmma + TMA mainloop, shared by conv3x3_wgmma.cu (the conv
// alone) and fused_block_common.cuh (the fused block's two convs): the same
// kernel, templated on what happens to a finished accumulator tile (the
// epilogue functor). sm_90a only.
//
// x (9, 9, B, Cin) bf16, w (3, 3, Cin, Cout) bf16, Cin a multiple of 64:
//
// - The layout is square-major, board-minor: for a fixed square the B boards
//   are B contiguous rows of Cin channels. So the GEMM's M runs over boards
//   at ONE output square (64 or 128 of them), not over the squares of one
//   board. The A operand of tap (di, dj) is then x[i+di-1, j+dj-1,
//   b0:b0+BM, k0:k0+64], a dense box of the 4-D tensor: one TMA load, no
//   gather. A square off the board is a coordinate of -1 or 9, which TMA
//   fills with zeros: that IS the SAME padding. Boards past B are
//   zero-filled the same way and masked at the store.
// - The weights stay HWIO: a stage's 64 x NT slice is NT/64 boxes of 64
//   input rows x 64 output channels, read N-contiguous through the wgmma
//   transpose bit. No per-call transpose of w.
// - One producer thread keeps TMA loads in flight into a ring of STAGES
//   stages (A: BM x 64, W: 64 x NT, both bf16, 128-byte swizzled); one
//   consumer warpgroup per 64 rows of the tile holds its 64 x NT f32
//   accumulator in registers over all 9 taps x Cin/64 K steps, with one
//   wgmma group in flight while the next stage's is started. Full / empty
//   mbarriers only: no __syncthreads() in the loop. With two consumer
//   warpgroups the producer gives its registers up (setmaxnreg).
// - The grid may be persistent: one CTA per SM slot walks tiles t, t + grid,
//   ..., the barriers' phases running on across tiles, so that a tile's
//   epilogue overlaps the next tile's first loads.
// - Epilogue: the functor gets the lane's fragment of the 64 x NT tile and
//   writes it out; store_tile_bf16 / store_tile_mapped below give every lane
//   contiguous channels to store, masked for boards >= B.
//
// Tiles (boards x output channels, stages, CTAs per SM):
//   128 x 256, 4 stages of 48 KB, 1   64 x 256, 5 stages of 40 KB, 1
//   128 x 128, 6 stages of 32 KB, 1   64 x 128, 4 stages of 24 KB, 2
// Every epilogue is a kernel of its own (a template instantiation), and the
// conv alone is compiled in its own source file: the 64 x 256 tile, whose
// single consumer warpgroup has no partner to fill the gaps between its
// instructions, lost 10-17% when a second variant shared its kernel body.
#pragma once

#include "wgmma_common.cuh"

namespace keisei {

template <int WGS, int NT, int STAGES>
struct ConvTile {
  static constexpr int kRows = 64 * WGS;                  // boards per CTA
  static constexpr int kABytes = kRows * wg::kRowBytes;   // BM boards x 64 channels
  static constexpr int kWAtom = 64 * wg::kRowBytes;       // 64 input rows x 64 output channels
  static constexpr int kWBytes = kWAtom * (NT / 64);
  static constexpr int kStage = kABytes + kWBytes;
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kSmem = STAGES * kStage + 2 * STAGES * 8 + wg::kAtomBytes;
};

// ---- the accumulator fragment on its way to (9, 9, B, Cout) -------------------
//
// A lane holds rows `board` and `board + 8` of the tile (see wgmma_common.cuh's
// fragment layout).

// bf16 out, the sums as they are: one rounding, a 4 x 4 register transpose
// inside each quad, 16 bytes per lane.
template <int NT>
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[NT / 2],
                                                __nv_bfloat16* __restrict__ out, int p, int board,
                                                int n0, int q, int B, int Cout) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int b = board + 8 * half;
    __nv_bfloat16* dst = out + ((size_t)p * B + b) * Cout + n0 + 8 * q;
#pragma unroll
    for (int g = 0; g < NT / 32; ++g) {
      uint32_t v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(acc[(4 * g + c) * 4 + 2 * half],
                                                          acc[(4 * g + c) * 4 + 2 * half + 1]);
        v[c] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      wg::quad_transpose(v, q);
      if (b < B) *reinterpret_cast<uint4*>(dst + 32 * g) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

__device__ __forceinline__ void store_channels(float* dst, const float4& v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store_channels(__nv_bfloat16* dst, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
}

// f32 or bf16 out, the sums mapped per channel first: lanes q and q ^ 1 trade
// halves of two 8-channel blocks in f32, so that a lane holds 4 adjacent
// channels n .. n + 3 of one row. `f.cols(n)` loads what f needs per channel
// (shared by the lane's two rows), `f.row(n, b, B, Cout)` what it needs per
// board and channel, and `f(v, cols, row)` maps the four sums in place; one
// rounding at the store if OutT is bf16.
//
// The tile goes out in NT / 8 steps of 4 channels of one row. f's loads are
// plain loads, which the compiler keeps between the stores they were written
// between (they might alias), so their order is this function's: the per-row
// load of step s + kAhead is started before step s is mapped and stored, which
// keeps kAhead loads from L2 in flight at 4 registers each; the per-channel
// loads run 16 channels ahead. (Read-only loads
// left to the compiler start a whole tile's loads at once, run the kernel up
// to its register limit and spill the accumulator.)
template <int NT, typename OutT, typename F>
__device__ __forceinline__ void store_tile_mapped(const float (&acc)[NT / 2],
                                                  OutT* __restrict__ out, int p, int board, int n0,
                                                  int q, int B, int Cout, const F& f) {
  constexpr int kSteps = NT / 8, kAhead = 4;
  const int col = n0 + ((q & 1) ? 8 + 2 * (q - 1) : 2 * q);
  decltype(f.row(0, 0, 0, 0)) rows[kAhead];
#pragma unroll
  for (int s = 0; s < kAhead; ++s)
    rows[s] = f.row(col + 16 * (s >> 1), board + 8 * (s & 1), B, Cout);
  auto cols_ahead = f.cols(col);
#pragma unroll
  for (int jp = 0; jp < NT / 16; ++jp) {
    const int n = col + 16 * jp;
    const auto cols = cols_ahead;
    if (jp + 1 < NT / 16) cols_ahead = f.cols(n + 16);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int s = 2 * jp + half, b = board + 8 * half;
      const auto row = rows[s % kAhead];
      if (s + kAhead < kSteps)
        rows[s % kAhead] = f.row(col + 16 * ((s + kAhead) >> 1), board + 8 * (s & 1), B, Cout);
      float lo[2] = {acc[8 * jp + 2 * half], acc[8 * jp + 2 * half + 1]};
      float hi[2] = {acc[8 * jp + 4 + 2 * half], acc[8 * jp + 4 + 2 * half + 1]};
      wg::quad_pair(lo, hi, q);
      float4 v = make_float4(lo[0], lo[1], hi[0], hi[1]);
      f(v, cols, row);
      if (b < B) store_channels(out + ((size_t)p * B + b) * Cout + n, v);
    }
  }
}

// ---- the kernel ---------------------------------------------------------------

// `epi(acc, p, board, n0, q, B, Cout)` writes a finished tile: square p, the
// lane's first row `board` (its second is board + 8), first channel n0.
template <int WGS, int NT, int STAGES, int MIN_CTAS, typename Epilogue>
__global__ void __launch_bounds__(128 * (WGS + 1), MIN_CTAS)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                     const __grid_constant__ CUtensorMap map_w, const Epilogue epi, int B, int Cin,
                     int Cout, int tiles_b, int tiles_n, int tiles) {
  using T = ConvTile<WGS, NT, STAGES>;
  static_assert(NT == 128 || NT == 256, "one wgmma covers the tile's width");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_addr(smem_raw) + wg::kAtomBytes - 1) & ~(wg::kAtomBytes - 1);
  const uint32_t full = ring + STAGES * T::kStage, empty = full + STAGES * 8;
  const int group = threadIdx.x >> 7;
  const int k_chunks = Cin >> 6, iters = 9 * k_chunks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(full + 8 * s, 1);         // the producer's arrive + the stage's bytes
      wg::mbar_init(empty + 8 * s, 4 * WGS);  // one arrival per consumer warp
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (group == WGS) {
    // ---- producer --------------------------------------------------------
    if constexpr (WGS == 2) wg::setmaxnreg_dec<40>();
    if (threadIdx.x != 128 * WGS) return;
    wg::prefetch_tensor_map(&map_x);
    wg::prefetch_tensor_map(&map_w);
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = (tile % tiles_n) * NT, rest = tile / tiles_n;
      const int b0 = (rest % tiles_b) * T::kRows, p = rest / tiles_b;
      const int i = p / 9, j = p - 9 * i;
      for (int tap = 0; tap < 9; ++tap) {
        const int di = tap / 3, dj = tap - 3 * di;
        for (int kc = 0; kc < k_chunks; ++kc) {
          wg::mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage, a_s = ring + stage * T::kStage;
          wg::mbar_arrive_expect_tx(bar, T::kStage);
          wg::tma_load_4d(a_s, &map_x, bar, kc * 64, b0, j + dj - 1, i + di - 1);
#pragma unroll
          for (int a = 0; a < NT / 64; ++a)
            wg::tma_load_2d(a_s + T::kABytes + a * T::kWAtom, &map_w, bar, n0 + a * 64,
                            tap * Cin + kc * 64);
          if (++stage == STAGES) { stage = 0; phase ^= 1; }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup `group` owns rows 64*group .. +63 of the tile --
  if constexpr (WGS == 2) wg::setmaxnreg_inc<232>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, q = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n0 = (tile % tiles_n) * NT, rest = tile / tiles_n;
    const int b0 = (rest % tiles_b) * T::kRows, p = rest / tiles_b;
    float acc[NT / 2];
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[e] = 0.f;
    int prev = -1;
    for (int it = 0; it < iters; ++it) {
      wg::mbar_wait(full + 8 * stage, phase);
      wg::wgmma_fence();
      const uint32_t a_s = ring + stage * T::kStage + group * 64 * wg::kRowBytes;
      const uint32_t w_s = ring + stage * T::kStage + T::kABytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = wg::smem_desc(a_s + kk * 32, 16, wg::kAtomBytes);
        const uint64_t dw = wg::smem_desc(w_s + kk * 16 * wg::kRowBytes, T::kWAtom,
                                          wg::kAtomBytes);
        if constexpr (NT == 256) wg::wgmma_bf16_n256<1>(acc, da, dw, 1);
        else wg::wgmma_bf16_n128<1>(acc, da, dw, 1);
      }
      wg::wgmma_commit();
      if (prev >= 0) {  // the group before has retired: its stage goes back
        wg::wgmma_wait<1>();
        __syncwarp();
        if (lane == 0) wg::mbar_arrive(empty + 8 * prev);
      }
      prev = stage;
      if (++stage == STAGES) { stage = 0; phase ^= 1; }
    }
    wg::wgmma_wait<0>();
    wg::acc_fence(acc);
    __syncwarp();
    if (lane == 0) wg::mbar_arrive(empty + 8 * prev);

    epi(acc, p, b0 + group * 64 + warp * 16 + (lane >> 2), n0, q, B, Cout);
  }
}

// ---- host ---------------------------------------------------------------------

template <int WGS, int NT, int STAGES, int MIN_CTAS, typename Epilogue>
static int launch_conv3x3_wgmma(const void* x, const void* w, const Epilogue& epi, int B, int Cin,
                                int Cout, int persistent, cudaStream_t stream) {
  using T = ConvTile<WGS, NT, STAGES>;
  CUtensorMap map_x, map_w;
  const cuuint64_t row = (cuuint64_t)Cin * 2;
  const cuuint64_t dims_x[4] = {(cuuint64_t)Cin, (cuuint64_t)B, 9, 9};
  const cuuint64_t strides_x[3] = {row, row * B, row * B * 9};
  const cuuint32_t box_x[4] = {64, T::kRows, 1, 1};
  int e = wg::make_tensor_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims_x, strides_x,
                              box_x);
  if (e != 0) return e;
  const cuuint64_t dims_w[2] = {(cuuint64_t)Cout, (cuuint64_t)9 * Cin};
  const cuuint64_t strides_w[1] = {(cuuint64_t)Cout * 2};
  const cuuint32_t box_w[2] = {64, 64};
  e = wg::make_tensor_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, dims_w, strides_w,
                          box_w);
  if (e != 0) return e;
  auto kernel = conv3x3_wgmma_kernel<WGS, NT, STAGES, MIN_CTAS, Epilogue>;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        T::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  const int tiles_b = (B + T::kRows - 1) / T::kRows, tiles_n = Cout / NT;
  const int tiles = 81 * tiles_b * tiles_n;
  int grid = tiles;
  if (persistent) {
    const int slots = wg::sm_count() * MIN_CTAS;
    if (slots < 1) return (int)cudaErrorInvalidDevice;
    if (slots < grid) grid = slots;
  }
  kernel<<<grid, T::kThreads, T::kSmem, stream>>>(map_x, map_w, epi, B, Cin, Cout, tiles_b,
                                                   tiles_n, tiles);
  return (int)cudaGetLastError();
}

// The conv with `boards` (64 or 128) boards of one square per CTA and
// `cout_tile` (128 or 256) output channels per CTA; `persistent` != 0 launches
// one CTA per SM slot that walks the tiles. Cin must be a multiple of 64 and
// Cout of cout_tile. Returns a cudaError_t.
template <typename Epilogue>
static int conv3x3_wgmma(const void* x, const void* w, const Epilogue& epi, int B, int Cin,
                         int Cout, int boards, int cout_tile, int persistent,
                         cudaStream_t s) {
  if (B < 1 || Cin < 64 || Cin % 64 != 0 || (cout_tile != 128 && cout_tile != 256) ||
      Cout < cout_tile || Cout % cout_tile != 0)
    return (int)cudaErrorInvalidValue;
  if (boards == 128 && cout_tile == 256)
    return launch_conv3x3_wgmma<2, 256, 4, 1>(x, w, epi, B, Cin, Cout, persistent, s);
  if (boards == 64 && cout_tile == 256)
    return launch_conv3x3_wgmma<1, 256, 5, 1>(x, w, epi, B, Cin, Cout, persistent, s);
  if (boards == 128 && cout_tile == 128)
    return launch_conv3x3_wgmma<2, 128, 6, 1>(x, w, epi, B, Cin, Cout, persistent, s);
  if (boards == 64 && cout_tile == 128)
    return launch_conv3x3_wgmma<1, 128, 4, 2>(x, w, epi, B, Cin, Cout, persistent, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace keisei
