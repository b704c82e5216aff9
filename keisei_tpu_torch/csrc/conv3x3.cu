// SAME 3x3 convolution, bf16 in / f32 accumulate / bf16 out, for sm_90a.
//
// Replaces the TPU kernel keisei_tpu/ops/conv3x3.py:conv3x3_hwbc
// (_conv_kernel): x (9, 9, B, Cin), w (3, 3, Cin, Cout) -> (9, 9, B, Cout).
//
// What bounds it on an H100: at the path's shapes (the input conv, Cin=50,
// Cout=256, and the C=256 probe) it is tensor-core work, 2*81*9*Cin*Cout
// FLOP per board against 2*81*(Cin+Cout) bytes of activations; the weights
// (up to 1.18 MB) are re-read from L2 by every CTA. The TPU kernel keeps a
// 16-board tile and the whole weight in 100 MiB of VMEM; here one CTA owns
// one board (81 squares, padded to 96 MMA rows), holds it in shared memory
// with Cin zero-padded to a multiple of 64 (so Cin=50 needs no special MMA
// path), and streams the weights through a 2-stage cp.async ring. See
// conv_common.cuh. Simple and right first: no wgmma/TMA yet.
#include "conv_common.cuh"

namespace keisei {

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int B, int Cin, int Kp) {
  constexpr int COUT = 64 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wbuf = a_s + kRows * Kp;
  const int board = blockIdx.x;

  load_board(a_s, x, board, B, Cin, Kp);
  __syncthreads();

  float acc[kMTiles][NT][4];
  conv_taps<NT>(a_s, Kp, w, Cin, wbuf, acc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = warp * NT * 8 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < kMTiles; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + (lane >> 2) + half * 8;
      if (m >= 81) continue;
      __nv_bfloat16* dst = out + ((size_t)m * B + board) * COUT + n0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
      }
    }
  }
}

template <int NT>
static int launch_conv3x3(const void* x, const void* w, void* out, int B, int Cin,
                          cudaStream_t stream) {
  const int Kp = (Cin + 63) / 64 * 64;
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)kRows * Kp + 2 * kKStage * 64 * NT);
  cudaError_t e = cudaFuncSetAttribute(conv3x3_kernel<NT>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  conv3x3_kernel<NT><<<B, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), B, Cin, Kp);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// x (9, 9, B, Cin) bf16, w (3, 3, Cin, Cout) bf16 -> out (9, 9, B, Cout) bf16.
// Cout must be 128 or 256; 1 <= Cin <= 256. Returns a cudaError_t.
int keisei_conv3x3_hwbc(const void* x, const void* w, void* out, int B, int Cin, int Cout,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Cin < 1 || Cin > 256) return (int)cudaErrorInvalidValue;
  if (Cout == 256) return keisei::launch_conv3x3<4>(x, w, out, B, Cin, s);
  if (Cout == 128) return keisei::launch_conv3x3<2>(x, w, out, B, Cin, s);
  return (int)cudaErrorInvalidValue;
}

const char* keisei_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
