// A chain of dependent (M, 768) @ (768, 768) products for sm_90a, with the
// weight streamed from L2: the tensor-core rate the port's blocks can reach
// when their weights do not fit in shared memory.
//
// Replaces the TPU probe scripts/profile_qblock_parts.py:make_dotrate
// (X <- (X @ W) & 1 in int8, X <- bf16((X @ W) * 1e-3) in bf16, 8 times,
// X (121*32, 768) and W resident in VMEM). W is 576 KB in int8 (1.15 MB in
// bf16), more than an SM's 227 KB of shared memory, so here it streams from
// L2: each CTA keeps 64 rows of X resident (two buffers, X_i and X_{i+1})
// and, per step and per 128 output columns, reads W's 128 x 768 slice in
// 128-byte K slices through a cp.async ring (4 stages in int8, 2 in bf16,
// whose two X buffers take 192 KB). W is stored [n][k], K-contiguous.
// M = 3872 is not a multiple of 64: the last of the 61 CTAs has 32 rows and
// zero-fills the rest. The rate is read beside the CTA count (61 of 132
// SMs) and beside mma_rate.cu's, whose operands are all resident.
//
// What bounds it on an H100: 2*M*768*768 operations per step on the tensor
// cores; each CTA reads W (576 KB or 1.15 MB) from L2 once per step.
#include "gemm_tile.cuh"

namespace keisei {

constexpr int kDotK = 768;  // K = N

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
dot_chain_kernel(const unsigned char* __restrict__ x, const unsigned char* __restrict__ w,
                 unsigned char* __restrict__ out, int M, int chain) {
  constexpr int kRowBytes = kDotK * (BF16 ? 2 : 1);
  constexpr int kChunks = kRowBytes / 16;
  constexpr int kSlices = kRowBytes / kSliceBytes;  // K slices per output tile
  constexpr int kNTiles = kDotK / kTileN;
  constexpr int kStages = BF16 ? 2 : 4;
  constexpr int kStageBytes = kTileN * kSliceBytes;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* x_cur = smem;
  unsigned char* x_next = smem + kTileM * kRowBytes;
  unsigned char* w_ring = smem + 2 * kTileM * kRowBytes;
  const int m0 = blockIdx.x * kTileM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  for (int q = threadIdx.x; q < kTileM * kChunks; q += blockDim.x) {
    const int r = q / kChunks, c = q % kChunks;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) v = reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * kRowBytes)[c];
    *reinterpret_cast<uint4*>(x_cur + swz8(r, c, kRowBytes)) = v;
  }

  // stage s: step s / (kNTiles * kSlices), output tile (s / kSlices) % kNTiles, slice s % kSlices
  const int total = chain * kNTiles * kSlices;
  auto load_stage = [&](int s) {
    const int nt = (s / kSlices) % kNTiles, kc = s % kSlices;
    load_slice(w_ring + (s % kStages) * kStageBytes, w, kRowBytes, nt * kTileN, kDotK, kTileN,
               kc * kSliceBytes);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) load_stage(s);
    cp_async_commit();
  }
  GemmAcc<BF16> acc[2][4][4];
  for (int s = 0; s < total; ++s) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // slice s has landed; every warp is done with slice s - 1 and with x_next
    if (s + kStages - 1 < total) load_stage(s + kStages - 1);
    cp_async_commit();
    const int nt = (s / kSlices) % kNTiles, kc = s % kSlices;
    if (kc == 0) zero_acc(acc);
    warp_mma_slice(acc, x_cur, kRowBytes, wm * 32, kc * (kSliceBytes / 16),
                   w_ring + (s % kStages) * kStageBytes, kSliceBytes, wn * 32, 0);
    if (kc == kSlices - 1) {  // the tile's sums are done: X_{i+1} = f(sums) -> x_next
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = wm * 32 + mt * 16 + (lane >> 2) + half * 8;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = nt * kTileN + wn * 32 + j * 8 + 2 * (lane & 3);
            const int byte = col * (BF16 ? 2 : 1);
            unsigned char* dst = x_next + swz8(r, byte >> 4, kRowBytes) + (byte & 15);
            if constexpr (BF16)
              *reinterpret_cast<__nv_bfloat162*>(dst) =
                  __floats2bfloat162_rn(__fmul_rn(acc[mt][j][2 * half], 1e-3f),
                                        __fmul_rn(acc[mt][j][2 * half + 1], 1e-3f));
            else
              *reinterpret_cast<uint16_t*>(dst) =
                  (uint16_t)((acc[mt][j][2 * half] & 1) | ((acc[mt][j][2 * half + 1] & 1) << 8));
          }
        }
      if (nt == kNTiles - 1) {  // the step is done; the next __syncthreads publishes x_next
        unsigned char* t = x_cur;
        x_cur = x_next;
        x_next = t;
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < kTileM * kChunks; q += blockDim.x) {
    const int r = q / kChunks, c = q % kChunks;
    if (m0 + r < M)
      reinterpret_cast<uint4*>(out + (size_t)(m0 + r) * kRowBytes)[c] =
          *reinterpret_cast<const uint4*>(x_cur + swz8(r, c, kRowBytes));
  }
}

template <bool BF16>
static int launch_dot_chain(const void* x, const void* w, void* out, int M, int chain,
                            cudaStream_t stream) {
  constexpr int kStages = BF16 ? 2 : 4;
  const size_t smem = 2 * (size_t)kTileM * kDotK * (BF16 ? 2 : 1) +
                      (size_t)kStages * kTileN * kSliceBytes;
  cudaError_t e = cudaFuncSetAttribute(dot_chain_kernel<BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dot_chain_kernel<BF16><<<(M + kTileM - 1) / kTileM, kThreads, smem, stream>>>(
      static_cast<const unsigned char*>(x), static_cast<const unsigned char*>(w),
      static_cast<unsigned char*>(out), M, chain);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// x (M, 768) and w (768, 768) [n][k], both int8 (bf16 = 0) or both bf16
// (bf16 = 1) -> out (M, 768) of the same type: X_0 = x, X_{i+1} =
// (X_i @ w^T) & 1 (int8) or bf16((X_i @ w^T) * 1e-3) (bf16), out = X_chain.
// Returns a cudaError_t.
int keisei_dot_chain(const void* x, const void* w, void* out, int M, int chain, int bf16,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || chain < 1) return (int)cudaErrorInvalidValue;
  return bf16 ? keisei::launch_dot_chain<true>(x, w, out, M, chain, s)
              : keisei::launch_dot_chain<false>(x, w, out, M, chain, s);
}

}  // extern "C"
