// SAME 3x3 convolution, bf16 in / f32 accumulate / bf16 out, for sm_90a, on
// mma.sync with whole boards per CTA. Reached only through conv3x3_bpc with
// 1, 2 or 4 boards per CTA: conv3x3_hwbc takes the wgmma kernel
// (conv3x3_wgmma.cu) for every shape, padding Cin to a multiple of 64.
//
// The first port of the TPU kernel keisei_tpu/ops/conv3x3.py:conv3x3_hwbc
// (_conv_kernel): x (9, 9, B, Cin), w (3, 3, Cin, Cout) -> (9, 9, B, Cout).
//
// What bounds it on an H100: tensor-core work, 2*81*9*Cin*Cout FLOP per
// board against 2*81*(Cin+Cout) bytes of activations; the weights (up to
// 1.18 MB) are re-read from L2 by every CTA. The TPU kernel keeps a
// 16-board tile and the whole weight in 100 MiB of VMEM; here one CTA owns
// one board (81 squares, padded to 96 MMA rows), holds it in shared memory
// with Cin zero-padded to a multiple of 64 (so Cin=50 needs no special MMA
// path), and streams the weights through a 2-stage cp.async ring. See
// conv_common.cuh. mma.sync from shared memory reaches under half of the
// card's bf16 rate, which is why the production route left this kernel.
//
// conv3x3_bpc_kernel is the same conv with BPC boards per CTA (replacing
// the TPU probe scripts/profile_pallas_conv.py:pallas_conv, whose grid step
// holds b_t boards): each 32-row weight slice read from L2 then serves
// BPC boards, so a conv at B boards reads 9*Cin*Cout*2 * B/BPC bytes of
// weights from L2 in place of B times that slice. 81*BPC rows are padded to
// the next multiple of 16 (BPC=2: 162 -> 176, 11 m-tiles; BPC=4: 324 ->
// 336, 21), against 81 -> 96 for one board. The 8 warps split M (WM) as
// well as N, each warp holding at most 6 m-tiles x 4 n-tiles of
// accumulators, and Cout is covered in passes of NP channels over the same
// A tile: BPC=2 takes 2 x 4 warps and NP=128, BPC=4 4 x 2 warps and NP=64.
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

// BPC boards per CTA; warps WM x (8/WM), MTW m-tiles and 4 n-tiles each.
template <int BPC, int WM, int MTW>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_bpc_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                   __nv_bfloat16* __restrict__ out, int B, int Cin, int Cout, int Kp) {
  constexpr int WN = kThreads / 32 / WM;
  constexpr int NTW = 4;
  constexpr int NP = WN * NTW * 8;
  constexpr int MT = (81 * BPC + 15) / 16;
  static_assert(WM * MTW >= MT, "the warps must cover every m-tile");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wbuf = a_s + (81 * BPC + 1) * Kp;
  const int board0 = blockIdx.x * BPC;

  load_boards(a_s, x, board0, BPC, B, Cin, Kp);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp % WN;
  for (int n0 = 0; n0 < Cout; n0 += NP) {
    float acc[MTW][NTW][4];
    conv_taps_tile<BPC, MTW, NTW, WN>(a_s, Kp, w, Cin, Cout, n0, wbuf, acc);
    const int nq = n0 + wn * NTW * 8 + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < MTW; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = (wm * MTW + i) * 16 + (lane >> 2) + half * 8;
        const int b = m / 81, p = m - 81 * b;
        if (m >= 81 * BPC || board0 + b >= B) continue;
        __nv_bfloat16* dst = out + ((size_t)p * B + board0 + b) * Cout + nq;
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
              __floats2bfloat162_rn(acc[i][nt][2 * half], acc[i][nt][2 * half + 1]);
        }
      }
    }
  }
}

template <int BPC, int WM, int MTW>
static int launch_conv3x3_bpc(const void* x, const void* w, void* out, int B, int Cin, int Cout,
                              cudaStream_t stream) {
  constexpr int NP = (kThreads / 32 / WM) * 4 * 8;
  if (Cout % NP != 0) return (int)cudaErrorInvalidValue;
  const int Kp = (Cin + 63) / 64 * 64;
  const size_t smem = sizeof(__nv_bfloat16) * ((size_t)(81 * BPC + 1) * Kp + 2 * kKStage * NP);
  cudaError_t e = cudaFuncSetAttribute(conv3x3_bpc_kernel<BPC, WM, MTW>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  conv3x3_bpc_kernel<BPC, WM, MTW><<<(B + BPC - 1) / BPC, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), B, Cin, Cout, Kp);
  return (int)cudaGetLastError();
}

}  // namespace keisei

extern "C" {

// x (9, 9, B, Cin) bf16, w (3, 3, Cin, Cout) bf16 -> out (9, 9, B, Cout) bf16,
// with bpc (1, 2 or 4) boards per CTA; one board is the main path's kernel.
// Cout must be 128 or 256; 1 <= Cin <= 256. Returns a cudaError_t.
int keisei_conv3x3_bpc(const void* x, const void* w, void* out, int B, int Cin, int Cout,
                       int bpc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || Cin < 1 || Cin > 256 || (Cout != 128 && Cout != 256))
    return (int)cudaErrorInvalidValue;
  if (bpc == 1)
    return Cout == 256 ? keisei::launch_conv3x3<4>(x, w, out, B, Cin, s)
                       : keisei::launch_conv3x3<2>(x, w, out, B, Cin, s);
  if (bpc == 2) return keisei::launch_conv3x3_bpc<2, 2, 6>(x, w, out, B, Cin, Cout, s);
  if (bpc == 4) return keisei::launch_conv3x3_bpc<4, 4, 6>(x, w, out, B, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}

const char* keisei_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
