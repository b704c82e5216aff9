// The 3x3 conv's wgmma + TMA mainloop, shared by conv3x3_wgmma.cu (the bf16
// conv alone), fused_block_common.cuh (the bf16 block's two convs) and
// qblock.cu / qblock_parts.cu (the int8 block's two convs and its stripped
// variants): one kernel, templated on the operand type (ConvBf16, ConvS8) and
// on what happens to a finished accumulator tile (the epilogue functor).
// sm_90a only.
//
// x (9, 9, B, Cin), bf16 or int8; Cin a multiple of one K step (64 bf16 or
// 128 int8 channels: one 128-byte row):
//
// - The layout is square-major, board-minor: for a fixed square the B boards
//   are B contiguous rows of Cin channels. So the GEMM's M runs over boards
//   at ONE output square (64 or 128 of them), not over the squares of one
//   board. The A operand of tap (di, dj) is then x[i+di-1, j+dj-1,
//   b0:b0+BM, k0:k0+K step], a dense box of the 4-D tensor: one TMA load, no
//   gather. A square off the board is a coordinate of -1 or 9, which TMA
//   fills with zeros: that IS the SAME padding. Boards past B are
//   zero-filled the same way and masked at the store.
// - The weights are read as they are stored, with no per-call transpose
//   (ConvBf16 / ConvS8 below): bf16 HWIO N-contiguous through the wgmma
//   transpose bit, int8 (3, 3, Cout, Cin) K-contiguous (the integer wgmma
//   has no transpose bit).
// - One producer thread keeps TMA loads in flight into a ring of STAGES
//   stages (A: BM x 128 bytes, W: 128 bytes x NT, both 128-byte swizzled);
//   one consumer warpgroup per 64 rows of the tile holds its 64 x NT f32 or
//   s32 accumulator in registers over all 9 taps x Cin / K step stages, with
//   one wgmma group in flight while the next stage's is started. Full / empty
//   mbarriers only: no __syncthreads() in the loop. With two consumer
//   warpgroups the producer gives its registers up (setmaxnreg).
// - The grid may be persistent: one CTA per SM slot walks tiles t, t + grid,
//   ..., the barriers' phases running on across tiles, so that a tile's
//   epilogue overlaps the next tile's first loads.
// - Epilogue: the functor gets the lane's fragment of the 64 x NT tile and
//   writes it out; store_tile_bf16 / store_tile_mapped below give every lane
//   contiguous channels to store, masked for boards >= B.
//
// Tiles (boards x output channels, stages, CTAs per SM; a stage's bytes are
// the same for both types):
//   128 x 256, 4 stages of 48 KB, 1   64 x 256, 5 stages of 40 KB, 1
//   128 x 128, 6 stages of 32 KB, 1   64 x 128, 4 stages of 24 KB, 2
// Every epilogue and operand type is a kernel of its own (a template
// instantiation), and the bf16 conv alone is compiled in its own source file:
// the 64 x 256 tile, whose single consumer warpgroup has no partner to fill
// the gaps between its instructions, lost 10-17% when a second variant
// shared its kernel body.
#pragma once

#include "wgmma_common.cuh"

namespace keisei {

template <int WGS, int NT, int STAGES>
struct ConvTile {
  static constexpr int kRows = 64 * WGS;                  // boards per CTA
  static constexpr int kABytes = kRows * wg::kRowBytes;   // BM boards x one K step
  static constexpr int kWBytes = NT * wg::kRowBytes;      // one K step x NT output channels
  static constexpr int kStage = kABytes + kWBytes;
  static constexpr int kThreads = 128 * (WGS + 1);
  static constexpr int kSmem = STAGES * kStage + 2 * STAGES * 8 + wg::kAtomBytes;
};

// ---- the operand types ------------------------------------------------------------
//
// What differs between the bf16 and the int8 conv: the element, the K step
// (one 128-byte row), the accumulator, how the weights are mapped and loaded,
// and the wgmma a stage issues (four of k16 or k32 per 128-byte row).

// bf16 x bf16 -> f32. w (3, 3, Cin, Cout) HWIO, a 2-D map {Cout, 9 Cin}: a
// stage's weights are NT / 64 boxes of 64 K rows x 64 output channels (an
// atom of 8,192 bytes each), read MN-major through the transpose bit.
struct ConvBf16 {
  using Acc = float;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kElem = 2;
  static constexpr int kKStep = wg::kRowBytes / kElem;  // 64 channels
  static constexpr int kWAtom = 64 * wg::kRowBytes;

  template <int NT>
  static int weight_map(CUtensorMap* map, const void* w, int Cin, int Cout) {
    const cuuint64_t dims[2] = {(cuuint64_t)Cout, (cuuint64_t)9 * Cin};
    const cuuint64_t strides[1] = {(cuuint64_t)Cout * kElem};
    const cuuint32_t box[2] = {64, 64};
    return wg::make_tensor_map(map, kType, 2, w, dims, strides, box);
  }
  template <int NT>
  static __device__ __forceinline__ void load_weights(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int tap, int kc, int n0,
                                                      int Cin, int Cout) {
#pragma unroll
    for (int a = 0; a < NT / 64; ++a)
      wg::tma_load_2d(dst + a * kWAtom, map, bar, n0 + a * 64, tap * Cin + kc * kKStep);
  }
  template <int NT>
  static __device__ __forceinline__ void mma(Acc (&acc)[NT / 2], uint32_t a_s, uint32_t w_s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wg::smem_desc(a_s + kk * 32, 16, wg::kAtomBytes);
      const uint64_t dw = wg::smem_desc(w_s + kk * 16 * wg::kRowBytes, kWAtom, wg::kAtomBytes);
      if constexpr (NT == 256) wg::wgmma_bf16_n256<1>(acc, da, dw, 1);
      else wg::wgmma_bf16_n128<1>(acc, da, dw, 1);
    }
  }
};

// s8 x s8 -> s32. w (3, 3, Cout, Cin) int8, K-contiguous per output channel, a
// 2-D map {Cin, 9 Cout}: a stage's weights are one box of 128 K bytes x NT
// output channels, read K-major like the activations (the integer wgmma has
// no transpose bit). At C = 256 a tile is 2 K steps x 9 taps = 18 stages.
struct ConvS8 {
  using Acc = int;
  static constexpr CUtensorMapDataType kType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kElem = 1;
  static constexpr int kKStep = wg::kRowBytes;  // 128 channels

  template <int NT>
  static int weight_map(CUtensorMap* map, const void* w, int Cin, int Cout) {
    const cuuint64_t dims[2] = {(cuuint64_t)Cin, (cuuint64_t)9 * Cout};
    const cuuint64_t strides[1] = {(cuuint64_t)Cin};
    const cuuint32_t box[2] = {wg::kRowBytes, NT};
    return wg::make_tensor_map(map, kType, 2, w, dims, strides, box);
  }
  template <int NT>
  static __device__ __forceinline__ void load_weights(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int tap, int kc, int n0,
                                                      int Cin, int Cout) {
    wg::tma_load_2d(dst, map, bar, kc * kKStep, tap * Cout + n0);
  }
  template <int NT>
  static __device__ __forceinline__ void mma(Acc (&acc)[NT / 2], uint32_t a_s, uint32_t w_s) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wg::smem_desc(a_s + kk * 32, 16, wg::kAtomBytes);
      const uint64_t dw = wg::smem_desc(w_s + kk * 32, 16, wg::kAtomBytes);
      if constexpr (NT == 256) wg::wgmma_s8_n256(acc, da, dw, 1);
      else wg::wgmma_s8_n128(acc, da, dw, 1);
    }
  }
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

__device__ __forceinline__ float4 channels4(const float (&lo)[2], const float (&hi)[2]) {
  return make_float4(lo[0], lo[1], hi[0], hi[1]);
}
__device__ __forceinline__ int4 channels4(const int (&lo)[2], const int (&hi)[2]) {
  return make_int4(lo[0], lo[1], hi[0], hi[1]);
}

__device__ __forceinline__ void store_channels(float* dst, const float4& v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store_channels(__nv_bfloat16* dst, const float4& v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(dst) = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                                              *reinterpret_cast<const uint32_t*>(&hi));
}
__device__ __forceinline__ void store_channels(int8_t* dst, const char4& v) {
  *reinterpret_cast<char4*>(dst) = v;
}

// f32, bf16 or int8 out, the sums mapped per channel first: lanes q and q ^ 1
// trade halves of two 8-channel blocks, so that a lane holds 4 adjacent
// channels n .. n + 3 of one row. `f.cols(n)` loads what f needs per channel
// (shared by the lane's two rows), `f.row(n, b, B, Cout)` what it needs per
// board and channel, and `f(v, cols, row)` maps the four sums (a float4 or
// an int4) to what is stored: a float4 (one rounding at the store if OutT is
// bf16) or a char4.
//
// The tile goes out in NT / 8 steps of 4 channels of one row. f's loads are
// plain loads, which the compiler keeps between the stores they were written
// between (they might alias), so their order is this function's: the per-row
// load of step s + AHEAD (even) is started before step s is mapped and
// stored, which keeps AHEAD loads from L2 in flight at 4 registers each; the
// per-channel loads run 16 channels ahead. (Read-only loads
// left to the compiler start a whole tile's loads at once, run the kernel up
// to its register limit and spill the accumulator.)
// What f.cols / f.row return for an epilogue that loads nothing per channel
// or per row.
struct NoLoad {};

template <int NT, int AHEAD = 4, typename OutT, typename AccT, typename F>
__device__ __forceinline__ void store_tile_mapped(const AccT (&acc)[NT / 2],
                                                  OutT* __restrict__ out, int p, int board, int n0,
                                                  int q, int B, int Cout, const F& f) {
  constexpr int kSteps = NT / 8, kAhead = AHEAD;
  static_assert(AHEAD % 2 == 0 && AHEAD <= kSteps, "a ring of whole row pairs");
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
      AccT lo[2] = {acc[8 * jp + 2 * half], acc[8 * jp + 2 * half + 1]};
      AccT hi[2] = {acc[8 * jp + 4 + 2 * half], acc[8 * jp + 4 + 2 * half + 1]};
      wg::quad_pair(lo, hi, q);
      const auto v = f(channels4(lo, hi), cols, row);
      if (b < B) store_channels(out + ((size_t)p * B + b) * Cout + n, v);
    }
  }
}

// ---- the kernel ---------------------------------------------------------------

// `epi(acc, p, board, n0, q, B, Cout)` writes a finished tile: square p, the
// lane's first row `board` (its second is board + 8), first channel n0.
template <typename K, int WGS, int NT, int STAGES, int MIN_CTAS, typename Epilogue>
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
  const int k_chunks = Cin / K::kKStep, iters = 9 * k_chunks;

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
          wg::tma_load_4d(a_s, &map_x, bar, kc * K::kKStep, b0, j + dj - 1, i + di - 1);
          K::template load_weights<NT>(a_s + T::kABytes, &map_w, bar, tap, kc, n0, Cin, Cout);
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
    typename K::Acc acc[NT / 2];
#pragma unroll
    for (int e = 0; e < NT / 2; ++e) acc[e] = 0;
    int prev = -1;
    for (int it = 0; it < iters; ++it) {
      wg::mbar_wait(full + 8 * stage, phase);
      wg::wgmma_fence();
      const uint32_t a_s = ring + stage * T::kStage + group * 64 * wg::kRowBytes;
      const uint32_t w_s = ring + stage * T::kStage + T::kABytes;
      K::template mma<NT>(acc, a_s, w_s);
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

template <typename K, int WGS, int NT, int STAGES, int MIN_CTAS, typename Epilogue>
static int launch_conv3x3_wgmma(const void* x, const void* w, const Epilogue& epi, int B, int Cin,
                                int Cout, int persistent, cudaStream_t stream) {
  using T = ConvTile<WGS, NT, STAGES>;
  CUtensorMap map_x, map_w;
  const cuuint64_t row = (cuuint64_t)Cin * K::kElem;
  const cuuint64_t dims_x[4] = {(cuuint64_t)Cin, (cuuint64_t)B, 9, 9};
  const cuuint64_t strides_x[3] = {row, row * B, row * B * 9};
  const cuuint32_t box_x[4] = {K::kKStep, T::kRows, 1, 1};
  int e = wg::make_tensor_map(&map_x, K::kType, 4, x, dims_x, strides_x, box_x);
  if (e != 0) return e;
  e = K::template weight_map<NT>(&map_w, w, Cin, Cout);
  if (e != 0) return e;
  auto kernel = conv3x3_wgmma_kernel<K, WGS, NT, STAGES, MIN_CTAS, Epilogue>;
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
// `cout_tile` (128 or 256) output channels per CTA, on operands of type K
// (ConvBf16 or ConvS8); `persistent` != 0 launches one CTA per SM slot that
// walks the tiles. Cin must be a multiple of K's step and Cout of cout_tile.
// Returns a cudaError_t.
template <typename Epilogue, typename K = ConvBf16>
static int conv3x3_wgmma(const void* x, const void* w, const Epilogue& epi, int B, int Cin,
                         int Cout, int boards, int cout_tile, int persistent,
                         cudaStream_t s) {
  if (B < 1 || Cin < K::kKStep || Cin % K::kKStep != 0 ||
      (cout_tile != 128 && cout_tile != 256) || Cout < cout_tile || Cout % cout_tile != 0)
    return (int)cudaErrorInvalidValue;
  if (boards == 128 && cout_tile == 256)
    return launch_conv3x3_wgmma<K, 2, 256, 4, 1>(x, w, epi, B, Cin, Cout, persistent, s);
  if (boards == 64 && cout_tile == 256)
    return launch_conv3x3_wgmma<K, 1, 256, 5, 1>(x, w, epi, B, Cin, Cout, persistent, s);
  if (boards == 128 && cout_tile == 128)
    return launch_conv3x3_wgmma<K, 2, 128, 6, 1>(x, w, epi, B, Cin, Cout, persistent, s);
  if (boards == 64 && cout_tile == 128)
    return launch_conv3x3_wgmma<K, 1, 128, 4, 2>(x, w, epi, B, Cin, Cout, persistent, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace keisei
