// A chain of dependent square products X_{i+1} = f(X_i @ W) for sm_90a, on
// warpgroup MMAs (wgmma) fed by TMA, with thread-block clusters that split
// W's output columns among their CTAs.
//   int8: s8 x s8 -> s32 sums, f(s) = s & 1;
//   bf16: bf16 x bf16 -> f32 sums, f(s) = bf16(s * 1e-3) (one rounding).
// W is given as W^T ([n][k], K-contiguous): the s8 wgmma takes K-major
// operands only. The sums are exact in int8, so the result is too.
//
// Replaces two TPU probes that compute this function with X and W resident
// in VMEM: scripts/profile_int8_mxu.py:make (the matrix-unit rate: (M, 512)
// @ (512, 512), 32 products per call) and scripts/profile_qblock_parts.py:
// make_dotrate (the block's GEMM shape: (3872, 768) @ (768, 768), 8 per
// call). Rows are independent and steps dependent, so a CTA keeps its rows'
// X in shared memory for the whole chain.
//
// What bounds it on an H100: 2*M*K*K operations per step on the tensor
// cores. W (256 KB int8 / 512 KB bf16 at K = 512; 576 KB / 1.15 MB at 768)
// does not fit in one SM's 227 KB, so the design is a cluster of CN CTAs
// along N: they share one tile of 64 or 128 rows, CTA j owns W's output
// columns [j K/CN, (j+1) K/CN), and its W slice is loaded once by TMA and
// stays resident where it fits (configs 1-3 below); the bf16 K = 768 slice
// (288 KB) streams from L2 through a TMA ring every step, refilled by the
// warpgroup's first thread as each stage retires. A step: each warpgroup
// (64 rows) runs wgmmas over all of K (A = X_i in shared memory, B = the
// CTA's W slice), applies f() in registers, stores its columns of X_{i+1}
// into its own X, and hands them to the other CTAs of the cluster, which
// take the rest of X_{i+1} from their peers; what bounds the chain on this
// card is that exchange, not the MMAs. Two exchanges (Exchange):
//   kL2           stores into a scratch of 2 * M * K in device memory (it
//                 stays in L2; two halves by step parity, so a peer may still
//                 read one while the next is written), the cluster barrier,
//                 then TMA loads of the peers' slices;
//   kDsmemValues  16-byte stores into every peer's X through distributed
//                 shared memory, then the cluster barrier.
// A CTA takes 32-72 KB of X a step from its peers. Where both ran, L2 took
// less time than distributed shared memory (PERF.md, section 6), so a
// config's exchange follows from its column slice (Cfg::EX): kL2 where the
// slice is whole 128-byte rows of X, which TMA loads; kDsmemValues where it
// is not (int8 K = 768: 192 bytes). Before X_i may be overwritten, every
// CTA must have read it (a relaxed cluster barrier). The wgmmas over the
// CTA's own columns of X_{i+1} (its K steps come first) start before the
// exchange and run under it. One X buffer suffices: the registers hold
// X_{i+1} until the peers are done with X_i.
// The last step stores f(sums) to device memory; rows past M (the last
// tile of a partial M) are zero-filled by TMA and masked at the store.
//
//   config            K    CN  rows  W slice            X       smem     exchange
//   int8  (row 4)     512  2   128   128 KB resident    64 KB   193 KB   L2
//   bf16  (row 4)     512  4   64    128 KB resident    64 KB   193 KB   L2
//   int8  (row 8)     768  4   64    144 KB resident    48 KB   193 KB   DSMEM
//   bf16  (row 8)     768  4   64    5 x 24 KB stages   96 KB   217 KB   L2
//
// The launch carries the cluster dimension (cudaLaunchKernelEx); every
// config is a template instantiation, a kernel of its own.
#include "wgmma_common.cuh"

namespace keisei {
namespace chain {

// ---- device: clusters and distributed shared memory --------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The cluster barrier (every thread of every CTA of the cluster), in two
// halves: arrive, do other work, wait. arrive_relaxed publishes nothing;
// arrive releases this thread's earlier writes, wait acquires the others'.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The address in CTA `rank`'s shared memory of `addr` in this CTA's.
__device__ __forceinline__ uint32_t map_shared(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_cluster(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Orders this thread's generic-proxy writes to device memory before later
// async-proxy (TMA) reads of them, by any CTA.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}
// Order generic-proxy writes to shared memory (this CTA's; any CTA's of the
// cluster) before later async-proxy (wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async_cta() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async_cluster() {
  asm volatile("fence.proxy.async.shared::cluster;\n" ::: "memory");
}
// A barrier over the `threads` threads that use id `id` (not 0: __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- the configurations ---------------------------------------------------------

// How the CTAs of a cluster hand X_{i+1}'s column slices to each other.
enum Exchange : int {
  kDsmemValues = 0,  // 16-byte stores into the peers' X through distributed shared memory
  kL2 = 1,           // through device memory (L2): stores, then TMA loads of the peers' slices
};

template <bool BF16_, int K_, int CN_, int WGS_, int STAGES_>
struct Cfg {
  static constexpr bool BF16 = BF16_;
  static constexpr int K = K_, CN = CN_, WGS = WGS_, STAGES = STAGES_;  // STAGES 0: W resident
  static constexpr int kElem = BF16 ? 2 : 1;
  static constexpr int kKBytes = K * kElem;
  static constexpr int kSlices = kKBytes / wg::kRowBytes;  // 128-byte K slices
  static constexpr int kSliceElems = wg::kRowBytes / kElem;
  static constexpr int kN = K / CN;  // output columns of a CTA
  // TMA moves whole 128-byte rows of X: the peers' slices through L2 where they are
  static constexpr int EX = kN * kElem % wg::kRowBytes == 0 ? kL2 : kDsmemValues;
  static constexpr int kKSteps = kKBytes / 32;      // 32-byte K steps of one wgmma each
  static constexpr int kOwnSteps = kN * kElem / 32;  // those over the CTA's own columns
  static constexpr int kRows = 64 * WGS;
  static constexpr int kXSlice = kRows * wg::kRowBytes;
  static constexpr int kXBytes = kSlices * kXSlice;
  static constexpr int kWStage = kN * wg::kRowBytes;  // one K slice of the CTA's W slice
  static constexpr int kWBytes = (STAGES ? STAGES : kSlices) * kWStage;
  // X_0 (and a resident W) loaded; the ring's stages; the peers' slices loaded (kL2)
  static constexpr int kBars = 1 + STAGES + 1;
  static constexpr int kSmem = wg::kAtomBytes + kXBytes + kWBytes + 8 * kBars;
  static constexpr int kThreads = 128 * WGS;
  using Acc = typename std::conditional<BF16, float, int>::type;
  static_assert(kKBytes % wg::kRowBytes == 0 && K % CN == 0, "K");
  static_assert(kN % (BF16 ? 32 : 64) == 0 && kN <= 256, "a CTA's columns: one wgmma, whole 16-byte groups");
  static_assert(kSmem <= 232448, "shared memory");
  static_assert(STAGES == 0 || WGS == 1, "a streamed W feeds one warpgroup");
};

template <bool BF16, int N>
__device__ __forceinline__ void mma(typename std::conditional<BF16, float, int>::type (&d)[N / 2],
                                    uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BF16 && N == 128) wg::wgmma_bf16_n128<0>(d, da, db, scale_d);
  else if constexpr (BF16 && N == 192) wg::wgmma_bf16_n192<0>(d, da, db, scale_d);
  else if constexpr (!BF16 && N == 192) wg::wgmma_s8_n192(d, da, db, scale_d);
  else if constexpr (!BF16 && N == 256) wg::wgmma_s8_n256(d, da, db, scale_d);
  else static_assert(N == 0, "no wgmma wrapper for this width");
}

// One 16-byte group of f(sums) per lane: lane q of a quad gets the group's
// q-th 16 bytes of columns after a 4 x 4 exchange inside the quad. `g` is a
// group of 64 int8 or 32 bf16 columns, `half` picks the lane's upper row.
// Returns the byte offset of the lane's 16 bytes in the CTA's column slice.
template <class C>
__device__ __forceinline__ uint4 pack_group(const typename C::Acc (&acc)[C::kN / 2], int g,
                                            int half, int q, int& byte) {
  uint32_t v[4];
  if constexpr (C::BF16) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 8-column block 4g + c: this lane's two columns
      const int e = (4 * g + c) * 4 + 2 * half;
      const __nv_bfloat162 pair = __halves2bfloat162(__float2bfloat16_rn(__fmul_rn(acc[e], 1e-3f)),
                                                     __float2bfloat16_rn(__fmul_rn(acc[e + 1], 1e-3f)));
      v[c] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    wg::quad_transpose(v, q);  // lane q: block 4g + q's 8 columns, in order
    byte = (32 * g + 8 * q) * 2;
    return make_uint4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {  // 16 columns: blocks 8g + 2c (lo) and 8g + 2c + 1 (hi)
      const int lo = (8 * g + 2 * c) * 4 + 2 * half, hi = lo + 4;
      v[c] = (uint32_t)(acc[lo] & 1) | ((uint32_t)(acc[lo + 1] & 1) << 8) |
             ((uint32_t)(acc[hi] & 1) << 16) | ((uint32_t)(acc[hi + 1] & 1) << 24);
    }
    wg::quad_transpose(v, q);  // lane q: from lane i, columns 2i, 2i+1 (lo) and 8+2i, 9+2i (hi)
    byte = 64 * g + 16 * q;
    return make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                      __byte_perm(v[0], v[1], 0x7632), __byte_perm(v[2], v[3], 0x7632));
  }
}

// The wgmmas over K steps [FROM, TO) of a CTA's order with its W slice
// resident: the 32-byte K steps rotated by `rot` (the CTA's rank times its
// own steps), so that the CTA's own columns of X come first.
template <class C, int FROM, int TO>
__device__ __forceinline__ void mma_resident(typename C::Acc (&acc)[C::kN / 2], uint32_t a_s,
                                             uint32_t w_s, int rot) {
#pragma unroll
  for (int t = FROM; t < TO; ++t) {
    int u = t + rot;
    if (u >= C::kKSteps) u -= C::kKSteps;
    const uint32_t s = u >> 2, kk = (u & 3) * 32;
    mma<C::BF16, C::kN>(acc, wg::smem_desc(a_s + s * C::kXSlice + kk, 16, wg::kAtomBytes),
                        wg::smem_desc(w_s + s * C::kWStage + kk, 16, wg::kAtomBytes), t != 0);
  }
}

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
gemm_chain_kernel(const __grid_constant__ CUtensorMap map_x,
                  const __grid_constant__ CUtensorMap map_w,
                  const __grid_constant__ CUtensorMap map_s, unsigned char* __restrict__ out,
                  unsigned char* __restrict__ scratch, int M, int chain) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t x_s = (wg::smem_addr(smem_raw) + wg::kAtomBytes - 1) & ~(wg::kAtomBytes - 1);
  const uint32_t w_s = x_s + C::kXBytes;
  const uint32_t loaded = w_s + C::kWBytes, full = loaded + 8, xbar = full + 8 * C::STAGES;
  const uint32_t rank = cluster_rank();
  const int m0 = (blockIdx.x / C::CN) * C::kRows;
  const int group = threadIdx.x >> 7;  // warpgroup `group` owns rows 64*group .. +63 of the tile
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3, q = lane & 3;
  const uint32_t a_s = x_s + group * 64 * wg::kRowBytes;
  constexpr int kGroups = C::kN / (C::BF16 ? 32 : 64);  // 16-byte groups of a row half
  constexpr int kTotal = C::STAGES ? C::kSlices : 1;    // streamed K slices per step
  constexpr int kOwnSlices = C::kN * C::kElem / wg::kRowBytes;

  // a streamed W: slice `it` of the launch (step it / kSlices) into stage it % STAGES
  auto load_w = [&](int it) {
    const int st = C::STAGES ? it % C::STAGES : 0;
    wg::mbar_arrive_expect_tx(full + 8 * st, C::kWStage);
    wg::tma_load_2d(w_s + st * C::kWStage, &map_w, full + 8 * st,
                    (it % C::kSlices) * C::kSliceElems, (int)rank * C::kN);
  };
  if (threadIdx.x == 0) {
    wg::mbar_init(loaded, 1);
    for (int s = 0; s < C::STAGES; ++s) wg::mbar_init(full + 8 * s, 1);
    wg::mbar_init(xbar, 1);
    wg::mbar_init_fence();
    wg::prefetch_tensor_map(&map_x);
    wg::prefetch_tensor_map(&map_w);
    if constexpr (C::EX == kL2) wg::prefetch_tensor_map(&map_s);
    // X_0 of the tile's rows and, if resident, the CTA's W slice
    wg::mbar_arrive_expect_tx(loaded, C::kXBytes + (C::STAGES ? 0 : C::kWBytes));
    for (int s = 0; s < C::kSlices; ++s) {
      wg::tma_load_2d(x_s + s * C::kXSlice, &map_x, loaded, s * C::kSliceElems, m0);
      if constexpr (C::STAGES == 0)
        wg::tma_load_2d(w_s + s * C::kWStage, &map_w, loaded, s * C::kSliceElems,
                        (int)rank * C::kN);
    }
    if constexpr (C::STAGES > 0)
      for (int it = 0; it < C::STAGES && it < chain * kTotal; ++it) load_w(it);
  }
  __syncthreads();

  typename C::Acc acc[C::kN / 2];
#pragma unroll
  for (int e = 0; e < C::kN / 2; ++e) acc[e] = 0;
  uint4 pk[2 * kGroups];  // f(sums) of the lane's two rows, 16 bytes a group
  int byte[kGroups];
  uint32_t off[2 * kGroups];  // their places in X
  const int rot = (int)rank * C::kOwnSteps;
  wg::mbar_wait(loaded, 0);
  if constexpr (C::STAGES == 0) {
    wg::wgmma_fence();
    mma_resident<C, 0, C::kKSteps>(acc, a_s, w_s, rot);
    wg::wgmma_commit();
  }

  // One way out of the loop, after every wgmma has retired (a conditional
  // exit with wgmmas in flight makes ptxas wait for them at the exit).
  for (int step = 0;; ++step) {
    // acc = X_i (64 rows x K) @ the CTA's W slice^T (K x kN)
    if constexpr (C::STAGES == 0) {
      if (step > 0) {  // the own columns' wgmmas are in flight: add the peers' columns
        wg::wgmma_fence();
        mma_resident<C, C::kOwnSteps, C::kKSteps>(acc, a_s, w_s, rot);
        wg::wgmma_commit();
      }
      wg::wgmma_wait<0>();
    } else {
#pragma unroll 1
      for (int s = 0; s < C::kSlices; ++s) {
        const int it = step * C::kSlices + s, st = C::STAGES ? it % C::STAGES : 0;
        wg::mbar_wait(full + 8 * st, (it / C::STAGES) & 1);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma<C::BF16, C::kN>(acc,
                              wg::smem_desc(a_s + s * C::kXSlice + kk * 32, 16, wg::kAtomBytes),
                              wg::smem_desc(w_s + st * C::kWStage + kk * 32, 16, wg::kAtomBytes),
                              (s | kk) != 0);
        wg::wgmma_commit();
        if (s > 0) {  // the group before has retired in every warp: its stage takes the
          wg::wgmma_wait<1>();  // slice STAGES on
          named_sync(1, 128);
          if (threadIdx.x == 0 && it - 1 + C::STAGES < chain * kTotal) load_w(it - 1 + C::STAGES);
        }
      }
      wg::wgmma_wait<0>();
      named_sync(1, 128);
      const int last = (step + 1) * C::kSlices - 1;
      if (threadIdx.x == 0 && last + C::STAGES < chain * kTotal) load_w(last + C::STAGES);
    }
    wg::acc_fence(acc);
    // kDsmemValues: every CTA of the cluster is done reading its X_i once all have arrived
    if (C::EX == kDsmemValues && step < chain - 1) cluster_arrive_relaxed();
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int g = 0; g < kGroups; ++g) pk[half * kGroups + g] = pack_group<C>(acc, g, half, q, byte[g]);

    if (step == chain - 1) {  // X_chain: this CTA's columns of its rows, to device memory
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + group * 64 + warp * 16 + (lane >> 2) + 8 * half;
#pragma unroll
        for (int g = 0; g < kGroups; ++g)
          if (row < M)
            *reinterpret_cast<uint4*>(out + (size_t)row * C::kKBytes + rank * C::kN * C::kElem +
                                      byte[g]) = pk[half * kGroups + g];
      }
      break;
    }

    // X_{i+1}'s own columns into this CTA's X: only its own wgmmas read them
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = group * 64 + warp * 16 + (lane >> 2) + 8 * half;  // row in the tile
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int col = rank * C::kN * C::kElem + byte[g];  // byte column of X's row
        off[half * kGroups + g] = (col >> 7) * C::kXSlice + r * wg::kRowBytes +
                                  ((((col & 127) >> 4) ^ (r & 7)) << 4);
        st_shared(x_s + off[half * kGroups + g], pk[half * kGroups + g]);
        if constexpr (C::EX == kL2) {  // and into this step's half of the scratch
          const int row = m0 + r;
          if (row < M)
            *reinterpret_cast<uint4*>(scratch + ((size_t)((step + 1) & 1) * M + row) * C::kKBytes +
                                      col) = pk[half * kGroups + g];
        }
      }
    }
    if constexpr (C::EX == kL2) fence_proxy_async_global();
    fence_proxy_async_cta();
    if constexpr (C::STAGES == 0) {  // the next step's wgmmas over the own columns, in flight
      named_sync(1 + group, 128);
      wg::wgmma_fence();
      mma_resident<C, 0, C::kOwnSteps>(acc, a_s, w_s, rot);
      wg::wgmma_commit();
    }
    if constexpr (C::EX == kDsmemValues) {
      cluster_wait();  // every peer has read X_i: this CTA's columns of X_{i+1} go to them
#pragma unroll
      for (int p = 1; p < C::CN; ++p) {
        const uint32_t peer_x = map_shared(x_s, ((int)rank + p) % C::CN);
#pragma unroll
        for (int i = 0; i < 2 * kGroups; ++i) st_cluster(peer_x + off[i], pk[i]);
      }
      fence_proxy_async_cluster();
      cluster_arrive();
      cluster_wait();  // X_{i+1} is whole in every CTA of the cluster
      fence_proxy_async_cta();
    } else {  // kL2: the peers' columns of X_{i+1} from the scratch, once all have stored theirs
      cluster_arrive();
      cluster_wait();
      if (threadIdx.x == 0) {
        wg::mbar_arrive_expect_tx(xbar, (C::CN - 1) * kOwnSlices * C::kXSlice);
        for (int p = 1; p < C::CN; ++p) {
          const int peer = ((int)rank + p) % C::CN;
          for (int s = peer * kOwnSlices; s < (peer + 1) * kOwnSlices; ++s)
            tma_load_3d(x_s + s * C::kXSlice, &map_s, xbar, s * C::kSliceElems, m0, (step + 1) & 1);
        }
      }
      wg::mbar_wait(xbar, step & 1);
    }
  }
}

// ---- host ---------------------------------------------------------------------

template <class C>
static int launch(const void* x, const void* wt, void* out, void* scratch, int M, int chain,
                  cudaStream_t stream, int* max_clusters) {
  const CUtensorMapDataType type =
      C::BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const cuuint64_t strides[2] = {(cuuint64_t)C::kKBytes, (cuuint64_t)M * C::kKBytes};
  const cuuint64_t dims_x[2] = {(cuuint64_t)C::K, (cuuint64_t)M};
  const cuuint64_t dims_w[2] = {(cuuint64_t)C::K, (cuuint64_t)C::K};
  const cuuint64_t dims_s[3] = {(cuuint64_t)C::K, (cuuint64_t)M, 2};
  const cuuint32_t box_x[3] = {(cuuint32_t)C::kSliceElems, (cuuint32_t)C::kRows, 1};
  const cuuint32_t box_w[2] = {(cuuint32_t)C::kSliceElems, (cuuint32_t)C::kN};
  auto kernel = gemm_chain_kernel<C>;
  cudaError_t ce = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        C::kSmem);
  if (ce != cudaSuccess) return (int)ce;
  const int tiles = (M + C::kRows - 1) / C::kRows;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C::CN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(tiles * C::CN);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = C::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (max_clusters != nullptr)
    return (int)cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
  if (C::EX == kL2 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap map_x, map_w, map_s = {};
  int e = wg::make_tensor_map(&map_x, type, 2, x, dims_x, strides, box_x);
  if (e != 0) return e;
  e = wg::make_tensor_map(&map_w, type, 2, wt, dims_w, strides, box_w);
  if (e != 0) return e;
  if (C::EX == kL2) {
    e = wg::make_tensor_map(&map_s, type, 3, scratch, dims_s, strides, box_x);
    if (e != 0) return e;
  }
  ce = cudaLaunchKernelEx(&cfg, kernel, map_x, map_w, map_s, static_cast<unsigned char*>(out),
                          static_cast<unsigned char*>(scratch), M, chain);
  if (ce != cudaSuccess) return (int)ce;
  return (int)cudaGetLastError();
}

// The configurations the wrappers take (ops/gemm_chain.py: PLANS).
static int dispatch(const void* x, const void* wt, void* out, void* scratch, int M, int K,
                    int chain, int bf16, cudaStream_t s, int* max_clusters) {
  if (!bf16 && K == 512) return launch<Cfg<false, 512, 2, 2, 0>>(x, wt, out, scratch, M, chain, s, max_clusters);
  if (bf16 && K == 512) return launch<Cfg<true, 512, 4, 1, 0>>(x, wt, out, scratch, M, chain, s, max_clusters);
  if (!bf16 && K == 768) return launch<Cfg<false, 768, 4, 1, 0>>(x, wt, out, scratch, M, chain, s, max_clusters);
  if (bf16 && K == 768) return launch<Cfg<true, 768, 4, 1, 5>>(x, wt, out, scratch, M, chain, s, max_clusters);
  return (int)cudaErrorInvalidValue;
}

}  // namespace chain
}  // namespace keisei

extern "C" {

// x (M, K) and wt (K, K) [n][k] (W^T), both int8 (bf16 = 0) or both bf16
// (bf16 = 1), K in {512, 768} -> out (M, K) of the same type: X_0 = x,
// X_{i+1} = (X_i @ wt^T) & 1 (int8) or bf16((X_i @ wt^T) * 1e-3) (bf16),
// out = X_chain. `scratch`, 2 * M * K elements of x's type, carries X
// between the cluster's CTAs where the configuration exchanges through L2
// (Cfg::EX). Returns a cudaError_t.
int keisei_gemm_chain(const void* x, const void* wt, void* out, void* scratch, int M, int K,
                      int chain, int bf16, void* stream) {
  if (M < 1 || chain < 1) return (int)cudaErrorInvalidValue;
  return keisei::chain::dispatch(x, wt, out, scratch, M, K, chain, bf16,
                                 static_cast<cudaStream_t>(stream), nullptr);
}

// How many clusters of the (K, bf16) configuration the card runs at once
// (cudaOccupancyMaxActiveClusters), into *clusters. Returns a cudaError_t.
int keisei_gemm_chain_clusters(int K, int bf16, int* clusters) {
  if (clusters == nullptr) return (int)cudaErrorInvalidValue;
  return keisei::chain::dispatch(nullptr, nullptr, nullptr, nullptr, 1, K, 1, bf16, nullptr,
                                 clusters);
}

}  // extern "C"
