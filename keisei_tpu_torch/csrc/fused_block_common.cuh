// The pieces of the eval-mode GlobalPoolBias block on Hopper, shared by
// fused_block.cu (the block), fused_block_stage.cu (the block cut after a
// stage) and qblock.cu (the int8 block, whose K0 is this pool kernel on an
// int8 loader): the pool kernel K0, the epilogues that make the wgmma conv
// (conv_wgmma_common.cuh) into K1 and K2, and the FC helper that K0 and the SE
// kernels use. sm_90a only. See fused_block.cu for the design.
#pragma once

#include <math.h>

#include <initializer_list>
#include <type_traits>

#include "conv_wgmma_common.cuh"

namespace keisei {

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

constexpr int kSquares = 81;
constexpr int kFcMaxSlices = 32;
constexpr int kFcBatch = 16;
constexpr int kFcMaxWidth = 4096;  // the widest FC the kernels size their shared memory for

// ---- an in-block FC over all threads of a CTA --------------------------------
//
// out[g][j] = sum_k in_s[g * K + k] * w[k * N + j] for GB input vectors at once
// (w is (K, N) bf16, N contiguous). A thread takes V adjacent outputs (16-byte
// weight loads at V = 8) of one of `slices` contiguous K ranges; the partial
// sums go to part_s[(s * GB + g) * N + j] and fc_sum adds them in slice order,
// so the result does not depend on which thread ran when. Returns `slices`.
// Acc is the type of the sums: float (the bf16 block), or double (the int8
// block: its FC inputs and weights are bf16 values, so every product is
// exact, and the sums carry 53 bits, so the one rounding to f32 is that of
// the exact dot product whatever the order, as in its plain version, except
// where the products' magnitudes span more than 2^37).
template <int GB, int V, typename Acc>
__device__ __forceinline__ int fc_partials_v(const float* __restrict__ in_s,
                                             const __nv_bfloat16* __restrict__ w, int K, int N,
                                             Acc* __restrict__ part_s) {
  const int cols = N / V;
  int slices = (int)blockDim.x / cols;
  slices = slices < 1 ? 1 : (slices > kFcMaxSlices ? kFcMaxSlices : slices);
  if (slices > K) slices = K;
  for (int item = threadIdx.x; item < slices * cols; item += blockDim.x) {
    const int s = item / cols, j = (item - s * cols) * V;
    const int k0 = (int)((long long)K * s / slices), k1 = (int)((long long)K * (s + 1) / slices);
    Acc a[GB][V];
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int v = 0; v < V; ++v) a[g][v] = 0.f;
    // kBatch weight loads in flight before their sums: the loads come from L2,
    // and a CTA has few threads to hide that latency behind (half as many
    // beside double sums, whose registers they would otherwise spill)
    constexpr int kBatch = sizeof(Acc) == sizeof(float) ? kFcBatch : kFcBatch / 2;
    for (int kb = k0; kb < k1; kb += kBatch) {
      typename std::conditional<V == 8, uint4, __nv_bfloat16>::type raw[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (kb + i >= k1) break;
        if constexpr (V == 8)
          raw[i] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(kb + i) * N + j));
        else
          raw[i] = w[(size_t)(kb + i) * N + j];
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        if (kb + i >= k1) break;
        float wf[V];
        if constexpr (V == 8) {
          const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            wf[2 * v] = __low2float(pairs[v]);
            wf[2 * v + 1] = __high2float(pairs[v]);
          }
        } else {
          wf[0] = __bfloat162float(raw[i]);
        }
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const Acc xin = in_s[g * K + kb + i];
#pragma unroll
          for (int v = 0; v < V; ++v) a[g][v] += xin * (Acc)wf[v];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int v = 0; v < V; ++v) part_s[(size_t)(s * GB + g) * N + j + v] = a[g][v];
  }
  return slices;
}

template <int GB, typename Acc = float>
__device__ __forceinline__ int fc_partials(const float* in_s, const __nv_bfloat16* w, int K,
                                           int N, Acc* part_s) {
  return N % 8 == 0 ? fc_partials_v<GB, 8>(in_s, w, K, N, part_s)
                    : fc_partials_v<GB, 1>(in_s, w, K, N, part_s);
}

template <int GB, typename Acc = float>
__device__ __forceinline__ float fc_sum(const Acc* part_s, int slices, int N, int g, int j) {
  Acc a = 0.f;
  for (int s = 0; s < slices; ++s) a += part_s[(size_t)(s * GB + g) * N + j];
  return (float)a;
}

// Elements of shared memory fc_partials needs for outputs up to n_max wide.
static inline size_t fc_part_floats(int gb, int threads, int n_max) {
  const int wide = 8 * threads;
  return (size_t)gb * (n_max > wide ? n_max : wide);
}

// `floats` floats rounded up to a whole number of Acc: where the FC
// partials start after them.
template <typename Acc>
__host__ __device__ constexpr int acc_aligned(int floats) {
  constexpr int k = sizeof(Acc) / sizeof(float);
  return (floats + k - 1) / k * k;
}

// ---- K0: the global pool of x and the two gp FCs -> g2 (B, C) f32 ------------
//
// One thread per channel, GB boards per CTA (the FC weights a CTA reads from
// L2 then serve GB boards). A thread keeps its channel's 81 values in
// registers and sums them in square order: mean, max, population std
// (+1e-10), each rounded to bf16 as FC inputs are. POOL_STAGE writes the f32
// mean broadcast over the squares, (9, 9, B, C), and stops.
//
// `ld` reads the block input: `ld(m, board, c, B, C)` is x at square m as an
// f32, `Loader::max_init()` where its max starts, `ld.prologue()` runs first
// in every CTA, and `Loader::FcAcc` is the FCs' sum type (fc_partials). The
// bf16 block reads x (PoolBf16); the int8 block dequantizes xq with its
// tile's scale, takes the max over the zero border too, sums its FCs in
// double, and zeroes its tile maxima there (qblock.cu's PoolS8).
struct PoolBf16 {
  using FcAcc = float;
  const __nv_bfloat16* x;
  __device__ __forceinline__ float operator()(int m, int board, int c, int B, int C) const {
    return __bfloat162float(x[((size_t)m * B + board) * C + c]);
  }
  __device__ __forceinline__ static float max_init() { return -INFINITY; }
  __device__ __forceinline__ void prologue() const {}
};

template <int GB, bool POOL_STAGE, typename Loader>
__global__ void __launch_bounds__(256)
gp_pool_kernel(const Loader ld, const __nv_bfloat16* __restrict__ gp1w,
               const float* __restrict__ gp1b, const __nv_bfloat16* __restrict__ gp2w,
               const float* __restrict__ gp2b, float* __restrict__ out, int B, int gpc) {
  using Acc = typename Loader::FcAcc;
  extern __shared__ __align__(16) float fc_smem[];
  const int C = blockDim.x, c = threadIdx.x;
  float* pool_s = fc_smem;              // GB x 3C
  float* g_s = pool_s + GB * 3 * C;     // GB x gpc
  Acc* part_s = reinterpret_cast<Acc*>(g_s + acc_aligned<Acc>(GB * gpc));  // 3C is even

  ld.prologue();
  for (int g = 0; g < GB; ++g) {
    const int board = blockIdx.x * GB + g;
    float mean = 0.f, mx = 0.f, sd = 0.f;
    if (board < B) {
      float v[kSquares];
#pragma unroll
      for (int m = 0; m < kSquares; ++m) v[m] = ld(m, board, c, B, C);
      float sum = 0.f;
      mx = Loader::max_init();
#pragma unroll
      for (int m = 0; m < kSquares; ++m) {
        sum = __fadd_rn(sum, v[m]);
        mx = fmaxf(mx, v[m]);
      }
      mean = __fdiv_rn(sum, 81.f);
      if constexpr (POOL_STAGE) {
#pragma unroll
        for (int m = 0; m < kSquares; ++m) out[((size_t)m * B + board) * C + c] = mean;
        continue;
      }
      float var = 0.f;
#pragma unroll
      for (int m = 0; m < kSquares; ++m) {
        const float d = __fsub_rn(v[m], mean);
        var = __fadd_rn(var, __fmul_rn(d, d));
      }
      sd = sqrtf(__fadd_rn(__fdiv_rn(var, 81.f), 1e-10f));
    }
    pool_s[g * 3 * C + c] = round_bf16(mean);
    pool_s[g * 3 * C + C + c] = round_bf16(mx);
    pool_s[g * 3 * C + 2 * C + c] = round_bf16(sd);
  }
  if constexpr (POOL_STAGE) return;
  __syncthreads();
  int slices = fc_partials<GB>(pool_s, gp1w, 3 * C, gpc, part_s);
  __syncthreads();
  for (int idx = c; idx < GB * gpc; idx += C) {
    const int g = idx / gpc, j = idx - g * gpc;
    g_s[idx] = round_bf16(fmaxf(gp1b[j] + fc_sum<GB>(part_s, slices, gpc, g, j), 0.f));
  }
  __syncthreads();
  slices = fc_partials<GB>(g_s, gp2w, gpc, C, part_s);
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    const int board = blockIdx.x * GB + g;
    if (board < B) out[(size_t)board * C + c] = gp2b[c] + fc_sum<GB>(part_s, slices, C, g, c);
  }
}

template <int GB, bool POOL_STAGE, typename Loader>
static int launch_gp_pool_gb(const Loader& ld, const void* gp1w, const void* gp1b,
                             const void* gp2w, const void* gp2b, float* out, int B, int C, int gpc,
                             cudaStream_t stream) {
  using Acc = typename Loader::FcAcc;
  const size_t smem = sizeof(float) * (GB * 3 * C + acc_aligned<Acc>(GB * gpc)) +
                      sizeof(Acc) * fc_part_floats(GB, C, gpc > C ? gpc : C);
  auto kernel = gp_pool_kernel<GB, POOL_STAGE, Loader>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + GB - 1) / GB, C, smem, stream>>>(
      ld, static_cast<const __nv_bfloat16*>(gp1w), static_cast<const float*>(gp1b),
      static_cast<const __nv_bfloat16*>(gp2w), static_cast<const float*>(gp2b), out, B, gpc);
  return (int)cudaGetLastError();
}

// pool_boards: 1 or 4 boards per CTA (ops/fused_block.py:block_plan picks).
template <bool POOL_STAGE, typename Loader>
static int launch_gp_pool(const Loader& ld, const void* gp1w, const void* gp1b, const void* gp2w,
                          const void* gp2b, float* out, int B, int C, int gpc, int pool_boards,
                          cudaStream_t stream) {
  if (pool_boards == 1)
    return launch_gp_pool_gb<1, POOL_STAGE>(ld, gp1w, gp1b, gp2w, gp2b, out, B, C, gpc, stream);
  if (pool_boards == 4)
    return launch_gp_pool_gb<4, POOL_STAGE>(ld, gp1w, gp1b, gp2w, gp2b, out, B, C, gpc, stream);
  return (int)cudaErrorInvalidValue;
}

// ---- K1 / K2: what happens to a conv's accumulator tile ----------------------
//
// The block's epilogue, cut where EPI says (the stage harness's cuts are the
// production code up to that point):
//   kEpiRaw     the f32 sums                            -> f32 (K2; stages conv1, conv2)
//   kEpiBnRelu  relu(acc * scale + shift)               -> f32 (stage bnrelu)
//   kEpiGpBias  relu(acc * scale + shift) + g2[board]   -> f32 (stage gpbias)
//   kEpiH       the same, rounded once                  -> bf16 (K1: h)
// K2 stores conv2's sums as they are: its BatchNorm affine is per channel, and
// K3 gives a thread one channel, so it costs two scalars there and a pair of
// 16-byte loads per 4 channels here.
enum BlockEpi { kEpiRaw = 0, kEpiBnRelu = 1, kEpiGpBias = 2, kEpiH = 3 };

template <int EPI>
struct BlockEpilogue {
  const float* scale;  // (C,) folded BatchNorm scale
  const float* shift;  // (C,) folded BatchNorm shift
  const float* g2;     // (B, C) global-pool bias (kEpiGpBias, kEpiH)
  void* out;           // (9, 9, B, C) bf16 (kEpiH) or f32

  struct Cols {
    float4 s, t;
  };
  struct Row {
    float4 g;
  };
  __device__ __forceinline__ Cols cols(int n) const {
    if constexpr (EPI == kEpiRaw) return Cols{};
    return Cols{*reinterpret_cast<const float4*>(scale + n),
                *reinterpret_cast<const float4*>(shift + n)};
  }
  // A row past B reads the last board's bias and is never stored: no branch.
  __device__ __forceinline__ Row row(int n, int b, int B, int C) const {
    if constexpr (EPI == kEpiRaw || EPI == kEpiBnRelu) return Row{};
    return Row{*reinterpret_cast<const float4*>(g2 + (size_t)min(b, B - 1) * C + n)};
  }
  __device__ __forceinline__ float4 operator()(float4 v, const Cols& c, const Row& r) const {
    if constexpr (EPI == kEpiRaw) return v;
    v = make_float4(v.x * c.s.x + c.t.x, v.y * c.s.y + c.t.y, v.z * c.s.z + c.t.z,
                    v.w * c.s.w + c.t.w);
    v = make_float4(fmaxf(v.x, 0.f), fmaxf(v.y, 0.f), fmaxf(v.z, 0.f), fmaxf(v.w, 0.f));
    if constexpr (EPI == kEpiBnRelu) return v;
    return make_float4(v.x + r.g.x, v.y + r.g.y, v.z + r.g.z, v.w + r.g.w);
  }

  template <int NACC>
  __device__ __forceinline__ void operator()(const float (&acc)[NACC], int p, int board, int n0,
                                             int q, int B, int Cout) const {
    if constexpr (EPI == kEpiH)
      store_tile_mapped<2 * NACC>(acc, static_cast<__nv_bfloat16*>(out), p, board, n0, q, B, Cout,
                                  *this);
    else
      store_tile_mapped<2 * NACC>(acc, static_cast<float*>(out), p, board, n0, q, B, Cout, *this);
  }
};

// One of the block's convs, C -> C, on the persistent tiles of `boards` x C.
template <int EPI>
static int launch_block_conv(const void* a, const void* w, const float* scale, const float* shift,
                             const float* g2, void* out, int B, int C, int boards,
                             cudaStream_t stream) {
  return conv3x3_wgmma(a, w, BlockEpilogue<EPI>{scale, shift, g2, out}, B, C, C, boards, C, 1,
                       stream);
}

static inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace keisei
