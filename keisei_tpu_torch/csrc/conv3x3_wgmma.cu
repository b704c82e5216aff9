// SAME 3x3 convolution for Cin a multiple of 64, bf16 in / f32 accumulate /
// bf16 out, on Hopper's warpgroup MMA fed by TMA. sm_90a only.
//
// Replaces the TPU kernel keisei_tpu/ops/conv3x3.py:conv3x3_hwbc
// (_conv_kernel) at the trunk's widths and, with its channels padded to 64,
// at the input conv's (ops/conv3x3.py pads Cin = 50; the fused forward keeps
// its observation planes padded), and with 64 or 128 boards per CTA the TPU
// probe scripts/profile_pallas_conv.py:pallas_conv (its b_t):
// x (9, 9, B, Cin), w (3, 3, Cin, Cout) -> (9, 9, B, Cout).
//
// What bounds it on an H100: tensor-core work, 2*81*9*Cin*Cout FLOP per
// board against 2*81*(Cin+Cout) bytes of activations. mma.sync from
// ldmatrix (conv3x3.cu) tops out under half of the card's bf16 rate, so
// this kernel is built on wgmma: M runs over boards at one output square, a
// tap's A operand is one dense TMA box, the border is TMA's zero fill, and a
// producer thread keeps a ring of swizzled stages full for the consumer
// warpgroups. The mainloop, its tiles and the stores are in
// conv_wgmma_common.cuh (shared with the fused block's convs); this file is
// the conv alone: the epilogue rounds the f32 sums to bf16 once.
//
// The wrapper picks the tile by B and Cout (ops/conv3x3.py:wgmma_tile, with
// the measurements behind the choice): a CTA covers all of Cout; 64 boards
// while the tiles are few waves over the 132 SMs, 128 boards beyond.
// Clusters of 2 CTAs that fetch half of each weight slice and multicast it
// to both were measured too: slower at every B (the pair runs in lock-step,
// and L2 reads are not what holds the kernel), so each CTA loads its own.
#include "conv_wgmma_common.cuh"

namespace keisei {

// One rounding of the f32 sums, (9, 9, B, Cout) bf16.
struct StoreBf16 {
  __nv_bfloat16* out;
  template <int NACC>
  __device__ __forceinline__ void operator()(const float (&acc)[NACC], int p, int board, int n0,
                                             int q, int B, int Cout) const {
    store_tile_bf16<2 * NACC>(acc, out, p, board, n0, q, B, Cout);
  }
};

}  // namespace keisei

extern "C" {

// x (9, 9, B, Cin) bf16, w (3, 3, Cin, Cout) bf16 -> out (9, 9, B, Cout) bf16
// with `boards` (64 or 128) boards of one square per CTA and `cout_tile`
// (128 or 256) output channels per CTA; `persistent` != 0 launches one CTA
// per SM slot that walks the tiles. Cin must be a multiple of 64 and Cout of
// cout_tile. Returns a cudaError_t.
int keisei_conv3x3_wgmma(const void* x, const void* w, void* out, int B, int Cin, int Cout,
                         int boards, int cout_tile, int persistent, void* stream) {
  return keisei::conv3x3_wgmma(x, w, keisei::StoreBf16{static_cast<__nv_bfloat16*>(out)}, B, Cin,
                               Cout, boards, cout_tile, persistent,
                               static_cast<cudaStream_t>(stream));
}

}  // extern "C"
