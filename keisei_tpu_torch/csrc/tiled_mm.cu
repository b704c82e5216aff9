// A GEMM tiled over M and N for sm_90a: s8 x s8 -> s32 or bf16 x bf16 -> f32,
// on Hopper's warpgroup MMA fed by TMA (wgmma_common.cuh).
//
// Replaces the TPU probe scripts/profile_conv_alternatives.py:make_pallas_mm
// (_mm_kernel, _mm_kernel_bf16): (4096, 1152) @ (1152, 256), the im2col
// shape of a 3x3 conv over 128 input channels at 4096 rows, tiled over M by
// 512 rows with both operands resident in VMEM. Here a CTA computes a 64 x
// 128 output tile (4096 x 256 -> 128 CTAs on 132 SMs; 128 x 256 tiles
// would give 32). B is stored [n][k], K-contiguous, as the port's int8 conv
// weights are: both operands are K-major, the only form the s8 wgmma takes.
//
// What bounds it on an H100: 2*M*K*N operations (2.4 G at the probe's
// shape) on the tensor cores against (M + N)*K operand bytes and M*N*4
// output bytes; at 128 CTAs of 9 (int8) or 18 (bf16) 128-byte K slices the
// kernel is as short as its latencies, so the design keeps every load in
// flight at once: one producer thread starts the TMA loads of both operand
// tiles into a ring of 8 stages (the whole K in int8, nearly half in bf16)
// before the first has landed; the consumer warpgroup starts each arrived
// slice's four wgmmas as one group with one group in flight; full / empty
// mbarriers only, no block-wide barrier in the loop. Rows past M and
// columns past N are zero-filled by TMA and masked at the store; the
// accumulators leave as 16-byte stores after one exchange inside each quad.
#include "wgmma_common.cuh"

namespace keisei {

constexpr int kMmTileM = 64;
constexpr int kMmTileN = 128;
constexpr int kMmStages = 8;
constexpr int kMmABytes = kMmTileM * wg::kRowBytes;
constexpr int kMmStage = (kMmTileM + kMmTileN) * wg::kRowBytes;
constexpr int kMmSmem = kMmStages * kMmStage + 2 * kMmStages * 8 + wg::kAtomBytes;
constexpr int kMmThreads = 256;  // a consumer warpgroup and the producer's

template <bool BF16>
__global__ void __launch_bounds__(kMmThreads, 1)
tiled_mm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                void* __restrict__ out_raw, int M, int N, int slices) {
  using Acc = typename std::conditional<BF16, float, int>::type;
  constexpr int kSliceElems = BF16 ? 64 : 128;  // K elements in 128 bytes
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_addr(smem_raw) + wg::kAtomBytes - 1) & ~(wg::kAtomBytes - 1);
  const uint32_t full = ring + kMmStages * kMmStage, empty = full + kMmStages * 8;
  const int m0 = blockIdx.x * kMmTileM, n0 = blockIdx.y * kMmTileN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kMmStages; ++s) {
      wg::mbar_init(full + 8 * s, 1);   // the producer's arrive + the stage's bytes
      wg::mbar_init(empty + 8 * s, 4);  // one arrival per consumer warp
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer --------------------------------------------------------
    if (threadIdx.x != 128) return;
    wg::prefetch_tensor_map(&map_a);
    wg::prefetch_tensor_map(&map_b);
    int stage = 0;
    uint32_t phase = 0;
    for (int s = 0; s < slices; ++s) {
      wg::mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t bar = full + 8 * stage, a_s = ring + stage * kMmStage;
      wg::mbar_arrive_expect_tx(bar, kMmStage);
      wg::tma_load_2d(a_s, &map_a, bar, s * kSliceElems, m0);
      wg::tma_load_2d(a_s + kMmABytes, &map_b, bar, s * kSliceElems, n0);
      if (++stage == kMmStages) { stage = 0; phase ^= 1; }
    }
    return;
  }

  // ---- the consumer warpgroup ----------------------------------------------
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, q = lane & 3;
  Acc acc[kMmTileN / 2];
#pragma unroll
  for (int e = 0; e < kMmTileN / 2; ++e) acc[e] = 0;
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int s = 0; s < slices; ++s) {
    wg::mbar_wait(full + 8 * stage, phase);
    wg::wgmma_fence();
    const uint32_t a_s = ring + stage * kMmStage, b_s = a_s + kMmABytes;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = wg::smem_desc(a_s + kk * 32, 16, wg::kAtomBytes);
      const uint64_t db = wg::smem_desc(b_s + kk * 32, 16, wg::kAtomBytes);
      if constexpr (BF16) wg::wgmma_bf16_n128<0>(acc, da, db, 1);
      else wg::wgmma_s8_n128(acc, da, db, 1);
    }
    wg::wgmma_commit();
    if (prev >= 0) {  // the group before has retired: its stage goes back
      wg::wgmma_wait<1>();
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty + 8 * prev);
    }
    prev = stage;
    if (++stage == kMmStages) { stage = 0; phase ^= 1; }
  }
  wg::wgmma_wait<0>();
  wg::acc_fence(acc);

  // (M, N) row-major, 16 bytes per lane: an even lane of a quad stores four
  // columns of the lower 8-column block of a pair, an odd lane of the upper
  Acc* out = static_cast<Acc*>(out_raw);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + warp * 16 + (lane >> 2) + 8 * half;
#pragma unroll
    for (int jp = 0; jp < kMmTileN / 16; ++jp) {
      Acc lo[2] = {acc[8 * jp + 2 * half], acc[8 * jp + 2 * half + 1]};
      Acc hi[2] = {acc[8 * jp + 4 + 2 * half], acc[8 * jp + 4 + 2 * half + 1]};
      wg::quad_pair(lo, hi, q);
      const int col = n0 + 16 * jp + ((q & 1) ? 8 + 2 * (q - 1) : 2 * q);
      if (row < M && col < N) {
        uint4 v;
        v.x = *reinterpret_cast<const uint32_t*>(&lo[0]);
        v.y = *reinterpret_cast<const uint32_t*>(&lo[1]);
        v.z = *reinterpret_cast<const uint32_t*>(&hi[0]);
        v.w = *reinterpret_cast<const uint32_t*>(&hi[1]);
        *reinterpret_cast<uint4*>(out + (size_t)row * N + col) = v;
      }
    }
  }
}

template <bool BF16>
static int launch_tiled_mm(const void* a, const void* b, void* out, int M, int N, int K,
                           cudaStream_t stream) {
  const int elem = BF16 ? 2 : 1, kbytes = K * elem;
  if (kbytes % wg::kRowBytes != 0) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type =
      BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t strides[1] = {(cuuint64_t)kbytes};
  const cuuint64_t dims_a[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t dims_b[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint32_t box_a[2] = {(cuuint32_t)(wg::kRowBytes / elem), kMmTileM};
  const cuuint32_t box_b[2] = {(cuuint32_t)(wg::kRowBytes / elem), kMmTileN};
  CUtensorMap map_a, map_b;
  int e = wg::make_tensor_map(&map_a, type, 2, a, dims_a, strides, box_a);
  if (e != 0) return e;
  e = wg::make_tensor_map(&map_b, type, 2, b, dims_b, strides, box_b);
  if (e != 0) return e;
  cudaError_t ce = cudaFuncSetAttribute(tiled_mm_kernel<BF16>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, kMmSmem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid((M + kMmTileM - 1) / kMmTileM, (N + kMmTileN - 1) / kMmTileN);
  tiled_mm_kernel<BF16><<<grid, kMmThreads, kMmSmem, stream>>>(map_a, map_b, out, M, N,
                                                               kbytes / wg::kRowBytes);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// a (M, K) and b (N, K) [n][k], both int8 (bf16 = 0) or both bf16 (bf16 = 1)
// -> out (M, N) = a @ b^T, int32 or f32. K bytes must be a multiple of 128
// and N a multiple of 8. Returns a cudaError_t.
int keisei_tiled_mm(const void* a, const void* b, void* out, int M, int N, int K, int bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 8 || N % 8 != 0 || K < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? keisei::launch_tiled_mm<true>(a, b, out, M, N, K, s)
              : keisei::launch_tiled_mm<false>(a, b, out, M, N, K, s);
}

}  // extern "C"
