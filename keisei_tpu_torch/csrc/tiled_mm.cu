// A GEMM tiled over M and N for sm_90a: s8 x s8 -> s32 or bf16 x bf16 -> f32.
//
// Replaces the TPU probe scripts/profile_conv_alternatives.py:make_pallas_mm
// (_mm_kernel, _mm_kernel_bf16): (4096, 1152) @ (1152, 256), the im2col
// shape of a 3x3 conv over 128 input channels at 4096 rows, tiled over M by
// 512 rows with both operands resident in VMEM. Here a CTA computes a 64 x
// 128 output tile (4096 x 256 -> 128 CTAs on 132 SMs; 128 x 256 tiles
// would give 32), and both operand tiles stream from L2 in 128-byte K
// slices through a 3-stage cp.async ring (gemm_tile.cuh). B is stored
// [n][k], K-contiguous, as the port's int8 conv weights are; the output is
// written straight from the accumulators, (M, N) row-major.
//
// What bounds it on an H100: 2*M*K*N operations (2.4 G at the probe's
// shape) on the tensor cores against (M + N)*K operand bytes and M*N*4
// output bytes; simple and right first: no wgmma/TMA yet.
#include "gemm_tile.cuh"

namespace keisei {

constexpr int kMmStages = 3;

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
tiled_mm_kernel(const unsigned char* __restrict__ a, const unsigned char* __restrict__ b,
                GemmAcc<BF16>* __restrict__ out, int M, int N, int kbytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_ring = smem;                                          // stages x 64 x 128 B
  unsigned char* b_ring = smem + kMmStages * kTileM * kSliceBytes;       // stages x 128 x 128 B
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int nk = kbytes / kSliceBytes;

  auto load_stage = [&](int s) {
    const int buf = s % kMmStages;
    load_slice(a_ring + buf * kTileM * kSliceBytes, a, kbytes, m0, M, kTileM, s * kSliceBytes);
    load_slice(b_ring + buf * kTileN * kSliceBytes, b, kbytes, n0, N, kTileN, s * kSliceBytes);
  };

  GemmAcc<BF16> acc[2][4][4];
  zero_acc(acc);
#pragma unroll
  for (int s = 0; s < kMmStages - 1; ++s) {
    if (s < nk) load_stage(s);
    cp_async_commit();
  }
  for (int s = 0; s < nk; ++s) {
    cp_async_wait<kMmStages - 2>();
    __syncthreads();  // stage s has landed, and every warp is done with stage s - 1
    if (s + kMmStages - 1 < nk) load_stage(s + kMmStages - 1);
    cp_async_commit();
    const int buf = s % kMmStages;
    warp_mma_slice(acc, a_ring + buf * kTileM * kSliceBytes, kSliceBytes, wm * 32, 0,
                   b_ring + buf * kTileN * kSliceBytes, kSliceBytes, wn * 32, 0);
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = m0 + wm * 32 + mt * 16 + (lane >> 2) + half * 8;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
        if (col >= N) continue;
        GemmAcc<BF16>* dst = out + (size_t)row * N + col;
        dst[0] = acc[mt][nt][2 * half];
        dst[1] = acc[mt][nt][2 * half + 1];
      }
    }
}

template <bool BF16>
static int launch_tiled_mm(const void* a, const void* b, void* out, int M, int N, int K,
                           cudaStream_t stream) {
  const int kbytes = K * (BF16 ? 2 : 1);
  if (kbytes % kSliceBytes != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMmStages * (kTileM + kTileN) * kSliceBytes;
  cudaError_t e = cudaFuncSetAttribute(tiled_mm_kernel<BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + kTileM - 1) / kTileM, (N + kTileN - 1) / kTileN);
  tiled_mm_kernel<BF16><<<grid, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(a), static_cast<const unsigned char*>(b),
      static_cast<GemmAcc<BF16>*>(out), M, N, kbytes);
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
