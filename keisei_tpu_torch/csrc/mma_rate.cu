// Tensor-core rate probe for sm_90a: a chain of dependent (M, K) @ (K, K)
// products held in shared memory, with mma.sync s8 -> s32 (m16n8k32) or
// bf16 -> f32 (m16n8k16).
//
// Replaces the TPU probe scripts/profile_int8_mxu.py:make (a chain of
// square GEMMs inside one Pallas kernel, operands resident in VMEM). Each
// CTA owns 128 rows of A and the whole (K, K) B in shared memory, K = 256;
// step i computes O = X_i @ B^T (B stored (N, K), K-contiguous, as the
// port's conv weights are) and X_{i+1} = O & 1 (O mod 2, 0 or 1), written
// back over X_i. The sums are exact integers in both types, so the result
// is exact and the plain version can check it bit for bit; each step
// depends on the one before, so nothing can be hoisted.
//
// It measures what the port's kernels are built from: mma.sync fed by
// ldmatrix from swizzled shared memory, 8 warps with 64 x 64 warp tiles.
// What bounds it: the tensor cores (2*M*K*K operations per step) and the
// shared-memory reads that feed them (4 KB of ldmatrix per 32 MMAs per
// warp); device memory is touched only to load and store the rows once.
#include <type_traits>

#include "conv_common.cuh"

namespace keisei {

constexpr int kProbeK = 256;     // K = N
constexpr int kProbeRows = 128;  // rows of A per CTA: 2 warps of 64 rows x 4 warps of 64 columns

__device__ __forceinline__ void mma32(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  mma_s8(c, a[0], a[1], a[2], a[3], b0, b1);
}
__device__ __forceinline__ void mma32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  mma_bf16(c, a[0], a[1], a[2], a[3], b0, b1);
}

__device__ __forceinline__ int parity(int v) { return v & 1; }
__device__ __forceinline__ int parity(float v) { return __float2int_rz(v) & 1; }

template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
mma_rate_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b, uint4* __restrict__ out,
                int chain) {
  using Acc = typename std::conditional<BF16, float, int>::type;
  constexpr int kRowBytes = kProbeK * (BF16 ? 2 : 1);  // one 32-byte MMA K-step = 16 or 32 elements
  constexpr int kChunks = kRowBytes / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* b_s = smem;                         // kProbeK rows (n) x kRowBytes (k)
  unsigned char* x_s = smem + kProbeK * kRowBytes;   // kProbeRows x kRowBytes
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = (warp & 1) * 64, col0 = (warp >> 1) * 64;
  const uint4* a_g = a + (size_t)blockIdx.x * kProbeRows * kChunks;

  for (int q = tid; q < kProbeK * kChunks; q += blockDim.x)
    *reinterpret_cast<uint4*>(b_s + swz8(q / kChunks, q % kChunks, kRowBytes)) = b[q];
  for (int q = tid; q < kProbeRows * kChunks; q += blockDim.x)
    *reinterpret_cast<uint4*>(x_s + swz8(q / kChunks, q % kChunks, kRowBytes)) = a_g[q];
  __syncthreads();

  // ldmatrix lane addresses, as in conv_common.cuh / qblock.cu
  const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int achk = (lane >> 4) & 1;
  const int brow = (lane & 7) + ((lane >> 4) & 1) * 8;
  const int bchk = (lane >> 3) & 1;

  for (int step = 0; step < chain; ++step) {
    Acc acc[4][8][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
#pragma unroll
    for (int ks = 0; ks < kRowBytes / 32; ++ks) {
      uint32_t af[4][4], bf[8][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(af[mt][0], af[mt][1], af[mt][2], af[mt][3],
                    x_s + swz8(row0 + mt * 16 + arow, ks * 2 + achk, kRowBytes));
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ldmatrix_x4(bf[2 * j][0], bf[2 * j][1], bf[2 * j + 1][0], bf[2 * j + 1][1],
                    b_s + swz8(col0 + j * 16 + brow, ks * 2 + bchk, kRowBytes));
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) mma32(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
    }
    __syncthreads();  // every warp has read X_i
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + mt * 16 + (lane >> 2) + half * 8;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = col0 + nt * 8 + 2 * (lane & 3);
          const int byte = col * (BF16 ? 2 : 1);
          unsigned char* dst = x_s + swz8(r, byte >> 4, kRowBytes) + (byte & 15);
          const int p0 = parity(acc[mt][nt][2 * half]), p1 = parity(acc[mt][nt][2 * half + 1]);
          if constexpr (BF16)
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn((float)p0, (float)p1);
          else
            *reinterpret_cast<uint16_t*>(dst) = (uint16_t)(p0 | (p1 << 8));
        }
      }
    }
    __syncthreads();
  }
  uint4* o_g = out + (size_t)blockIdx.x * kProbeRows * kChunks;
  for (int q = tid; q < kProbeRows * kChunks; q += blockDim.x)
    o_g[q] = *reinterpret_cast<const uint4*>(x_s + swz8(q / kChunks, q % kChunks, kRowBytes));
}

template <bool BF16>
static int launch_mma_rate(const void* a, const void* b, void* out, int M, int chain,
                           cudaStream_t stream) {
  const size_t smem = (size_t)(kProbeK + kProbeRows) * kProbeK * (BF16 ? 2 : 1);
  cudaError_t e = cudaFuncSetAttribute(mma_rate_kernel<BF16>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  mma_rate_kernel<BF16><<<M / kProbeRows, kThreads, smem, stream>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b), static_cast<uint4*>(out),
      chain);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// a (M, 256) and b (256, 256) [n][k], int8 (bf16 = 0) or bf16 (bf16 = 1)
// -> out (M, 256) of the same type: X_0 = a, X_{i+1} = (X_i @ b^T) mod 2,
// out = X_chain. M must be a positive multiple of 128. Returns a cudaError_t.
int keisei_mma_rate(const void* a, const void* b, void* out, int M, int chain, int bf16,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < keisei::kProbeRows || M % keisei::kProbeRows != 0 || chain < 1)
    return (int)cudaErrorInvalidValue;
  return bf16 ? keisei::launch_mma_rate<true>(a, b, out, M, chain, s)
              : keisei::launch_mma_rate<false>(a, b, out, M, chain, s);
}

}  // extern "C"
