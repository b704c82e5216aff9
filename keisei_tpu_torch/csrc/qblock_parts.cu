// The int8 block with parts stripped, for sm_90a: where qblock.cu's time goes.
//
// Replaces the TPU probe scripts/profile_qblock_parts.py:make_stripped
// (_convs_kernel, _bf16_kernel, _convs3d_kernel), the block kernel of
// keisei_tpu/ops/qblock.py with parts removed. Each variant here is composed
// from qblock.cu's own pieces (the s8 wgmma conv of conv_wgmma_common.cuh,
// the tile maxima and the requantize kernel of qblock_common.cuh), so its
// time is the time of those pieces inside the block:
//   convs    s8 conv1 with the epilogue h = max(acc * 1e-4, 0) -> f32 and
//            the tile's max (as K1), the requantize pass Q1, s8 conv2 with
//            clip(acc, +-127) -> int8: the GEMMs, the f32 round trip and the
//            split at the tile-wide amax of the block.
//   vpuonly  the same three passes with each GEMM replaced by its input:
//            h = max(x * 1e-4, 0) and its tile max, Q1, clip(hq).
//   novpu    s8 conv1, acc & 1 -> int8 in device memory, s8 conv2, acc & 1.
//            The int8 h crosses device memory: no CTA holds a board.
//   bf16gemm novpu's structure on bf16 operands, the bf16 wgmma conv twice
//            with the epilogue bf16(acc * 1e-2).
//   gemmonly both s8 convs from x: conv1 & 1 -> out[0], conv2 & 1 -> out[1].
// The TPU variants work on the banded (145, B, 3C) layout and do not mask
// its 11x11 border, so border garbage enters their amax and their conv2
// input; here the board is (9, 9) with a zero border, which is the masked
// function (the production rule).
//
// What bounds them on an H100: the convs (2*81*9*C*C operations per board
// and conv) on the tensor cores; vpuonly moves bytes only (x in, y out).
#include "qblock_common.cuh"

namespace keisei {

enum Part { kConvs = 0, kNoVpu = 1, kVpuOnly = 2, kBf16Gemm = 3, kGemmOnly = 4 };

__device__ __forceinline__ char4 clip4(int4 a) {
  return make_char4(min(max(a.x, -127), 127), min(max(a.y, -127), 127), min(max(a.z, -127), 127),
                    min(max(a.w, -127), 127));
}

// The epilogues: out(acc) per element, stored as OutT (convs' h also sends
// the warp's max to its tile's word).
template <typename OutT, typename Map>
struct PartEpilogue {
  OutT* out;
  unsigned* words;  // convs' h only
  int bt;
  __device__ __forceinline__ NoLoad cols(int) const { return {}; }
  __device__ __forceinline__ NoLoad row(int, int, int, int) const { return {}; }
  template <typename V>
  __device__ __forceinline__ auto operator()(V a, NoLoad, NoLoad) const {
    return Map::map(a, amax);
  }
  mutable float amax = 0.f;
  template <int NACC, typename AccT>
  __device__ __forceinline__ void operator()(const AccT (&acc)[NACC], int p, int board, int n0,
                                             int q, int B, int Cout) const {
    const PartEpilogue f{out, words, bt};
    store_tile_mapped<2 * NACC>(acc, out, p, board, n0, q, B, Cout, f);
    if (words != nullptr) warp_tile_max(f.amax, words, board - ((threadIdx.x & 31) >> 2), B, bt);
  }
};

struct MapH {  // convs' conv1: h = max(acc * 1e-4, 0), tracked for the tile max
  __device__ __forceinline__ static float one(int a, float& amax) {
    const float h = fmaxf(__fmul_rn(__int2float_rn(a), 1e-4f), 0.f);
    amax = fmaxf(amax, h);
    return h;
  }
  __device__ __forceinline__ static float4 map(int4 a, float& amax) {
    return make_float4(one(a.x, amax), one(a.y, amax), one(a.z, amax), one(a.w, amax));
  }
};
struct MapClip {  // convs' conv2: clip(acc, +-127)
  __device__ __forceinline__ static char4 map(int4 a, float&) { return clip4(a); }
};
struct MapParity {  // novpu, gemmonly: acc & 1
  __device__ __forceinline__ static char4 map(int4 a, float&) {
    return make_char4(a.x & 1, a.y & 1, a.z & 1, a.w & 1);
  }
};
struct MapBf16 {  // bf16gemm: acc * 1e-2, rounded to bf16 at the store
  __device__ __forceinline__ static float4 map(float4 a, float&) {
    return make_float4(__fmul_rn(a.x, 1e-2f), __fmul_rn(a.y, 1e-2f), __fmul_rn(a.z, 1e-2f),
                       __fmul_rn(a.w, 1e-2f));
  }
};

// vpuonly's first pass: h = max(x * 1e-4, 0) -> f32 and the tile's max; grid
// (B / bt, 81): a CTA takes one square of one tile's boards.
__global__ void __launch_bounds__(256)
vpu_h_kernel(const char4* __restrict__ x, float4* __restrict__ h, unsigned* __restrict__ words,
             int B, int C, int bt) {
  __shared__ float red_s[8];
  const int quads = bt * C / 4;
  const size_t base = ((size_t)blockIdx.y * B + (size_t)blockIdx.x * bt) * C / 4;
  float m = 0.f;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const char4 v = x[base + i];
    const float4 o = make_float4(fmaxf(__fmul_rn((float)v.x, 1e-4f), 0.f),
                                 fmaxf(__fmul_rn((float)v.y, 1e-4f), 0.f),
                                 fmaxf(__fmul_rn((float)v.z, 1e-4f), 0.f),
                                 fmaxf(__fmul_rn((float)v.w, 1e-4f), 0.f));
    h[base + i] = o;
    m = fmaxf(m, fmaxf(fmaxf(o.x, o.y), fmaxf(o.z, o.w)));
  }
  m = warp_max(m);
  if ((threadIdx.x & 31) == 0) red_s[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)blockDim.x / 32; ++w) m = fmaxf(m, red_s[w]);
    atomicMax(words + blockIdx.x, max_word(m));
  }
}

// vpuonly's last pass: clip(hq, +-127) -> out, 4 values per thread.
__global__ void __launch_bounds__(256)
vpu_clip_kernel(const char4* __restrict__ hq, char4* __restrict__ out, int quads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < quads) {
    const char4 v = hq[i];
    out[i] = clip4(make_int4(v.x, v.y, v.z, v.w));
  }
}

template <typename K, typename Map, typename OutT>
static int part_conv(const void* x, const void* w, void* out, unsigned* words, int B, int C,
                     int bt, int boards, cudaStream_t s) {
  return conv3x3_wgmma<PartEpilogue<OutT, Map>, K>(
      x, w, PartEpilogue<OutT, Map>{static_cast<OutT*>(out), words, bt}, B, C, C, boards, C, 1,
      s);
}

static int launch_part(int part, const void* x, const void* w1, const void* w2, void* out,
                       void* act, void* hq, void* words, int B, int C, int bt, int boards,
                       cudaStream_t s) {
  unsigned* maxima = static_cast<unsigned*>(words);
  float* h = static_cast<float*>(act);
  const int quads = 81 * B * (C / 4);
  int e = 0;
  switch (part) {
    case kConvs:
    case kVpuOnly:
      if ((e = (int)cudaMemsetAsync(maxima, 0, sizeof(unsigned) * (B / bt), s)) != 0) return e;
      if (part == kConvs) {
        e = part_conv<ConvS8, MapH, float>(x, w1, h, maxima, B, C, bt, boards, s);
      } else {
        vpu_h_kernel<<<dim3(B / bt, 81), 256, 0, s>>>(static_cast<const char4*>(x),
                                                       reinterpret_cast<float4*>(h), maxima, B,
                                                       C, bt);
        e = (int)cudaGetLastError();
      }
      if (e != 0) return e;
      if ((e = launch_requant<0>(h, maxima, hq, nullptr, B, C, bt, s)) != 0) return e;
      if (part == kConvs)
        return part_conv<ConvS8, MapClip, int8_t>(hq, w2, out, nullptr, B, C, bt, boards, s);
      vpu_clip_kernel<<<(quads + 255) / 256, 256, 0, s>>>(static_cast<const char4*>(hq),
                                                           static_cast<char4*>(out), quads);
      return (int)cudaGetLastError();
    case kNoVpu:  // conv2 over the parity bits of conv1
    case kGemmOnly:   // both convs over x, the halves of out
      e = part_conv<ConvS8, MapParity, int8_t>(x, w1, part == kNoVpu ? hq : out, nullptr, B, C,
                                               bt, boards, s);
      if (e != 0) return e;
      if (part == kNoVpu)
        return part_conv<ConvS8, MapParity, int8_t>(hq, w2, out, nullptr, B, C, bt, boards, s);
      return part_conv<ConvS8, MapParity, int8_t>(x, w2, static_cast<int8_t*>(out) + 81 * B * C,
                                                  nullptr, B, C, bt, boards, s);
    case kBf16Gemm:  // h (bf16) in act
      e = part_conv<ConvBf16, MapBf16, __nv_bfloat16>(x, w1, act, nullptr, B, C, bt, boards, s);
      if (e != 0) return e;
      return part_conv<ConvBf16, MapBf16, __nv_bfloat16>(act, w2, out, nullptr, B, C, bt, boards,
                                                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace keisei

extern "C" {

// One stripped variant of the int8 block (part: 0 convs, 1 novpu, 2 vpuonly,
// 3 bf16gemm, 4 gemmonly). x (9, 9, B, C) int8 (bf16 for bf16gemm); w1, w2
// (3, 3, C, C) int8 [tap][cout][cin] (bf16 [tap][cin][cout] for bf16gemm)
// -> out (9, 9, B, C) int8 (bf16 for bf16gemm; (2, 9, 9, B, C) for
// gemmonly). Scratch the caller allocates: act (9, 9, B, C) f32 (convs,
// vpuonly: h) or bf16 (bf16gemm: h), hq (9, 9, B, C) int8 (convs, vpuonly,
// novpu) and words (B / bt) of 32 bits (convs, vpuonly: the tile maxima);
// null where a variant takes none. `boards` (64 or 128) is the convs' tile
// height. C must be 128 or 256, bt a multiple of 16 that divides B. Returns
// a cudaError_t.
int keisei_qblock_part(int part, const void* x, const void* w1, const void* w2, void* out,
                       void* act, void* hq, void* words, int B, int C, int bt, int boards,
                       void* stream) {
  if (B < 1 || bt < 16 || bt % 16 != 0 || B % bt != 0 || (C != 128 && C != 256))
    return (int)cudaErrorInvalidValue;
  return keisei::launch_part(part, x, w1, w2, out, act, hq, words, B, C, bt, boards,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
