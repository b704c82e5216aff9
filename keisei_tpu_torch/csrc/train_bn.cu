// The SE-ResNet's train-mode non-GEMM data path on Hopper: BatchNorm with
// batch statistics, the global pool of a block's input and the block's two
// epilogues, forward and backward, for activations in bf16 or f32 (the
// model's params.dtype), NCHW, so that one (board b, channel c) row is its
// 81 contiguous squares.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it into the convolutions' neighbours. Written out in eager PyTorch it
// is ~26 full-activation passes a block forward and ~50 backward, mostly in
// f32 (models/se_resnet.py, the plain path). Here:
//
//   forward   pool_stats_kernel   x -> mean || max || std (B, 3C) f32       1 read
//             bn_reduce_kernel<0> y -> per-CTA partial sums of y and y^2     1 read
//               (+ each (b, c)'s sum over its squares: the SE input of bn2)
//             bn_finish_kernel    partials -> (2, C) sums, in a fixed order
//             bn_apply_kernel     y (, x) -> the normalised output           1 read (2), 1 write
//   backward  bn_reduce_kernel<1..3>  grad, y (, out) -> the per-channel and
//               per-(b, c) sums of BatchNorm, SE, gp bias and the affine    2-3 reads
//               (tail: also writes the residual's gradient)                 (1 write)
//             bn_finish_kernel    -> the gradients of mean, mul and beta
//             bn_moments_grad_kernel -> those of the sums (and the SE input's
//               rows), the weight and the bias: the (C,)-sized step in closed form
//             bn_grad_kernel      grad, y -> dy, every term in one sum       2 reads, 1 write
//             pool_grad_kernel    x, dpool (+ the residual's gradient) -> dx 1-2 reads, 1 write
//
// What bounds it on an H100: bytes. A pass at B=1,024, C=256 moves 21.2M
// values (42.5 MB in bf16), ~13 us at 3.35 TB/s, and does a few FLOP a value.
// What the design does about it: every intermediate of the eager chain (the
// f32 copy of x, x*x, x - mean, the normalised f32 tensor, the SE product and
// the sums of the residual) stays in registers; a value is read in the
// activation's type and converted to f32 there; a warp owns a row, so the
// reductions over a row's 81 squares are shuffles, and four rows are in
// flight a warp before any is used. The (C,)-sized step between the sums
// and the apply (the mean, E[y^2], an all-reduce under data parallelism,
// the clamp, the running statistics, rsqrt * weight) stays in PyTorch.
//
// No atomics: a reduction CTA owns a chunk of boards for 32 channels and
// writes its partial sums; bn_finish_kernel adds a channel's partials in
// chunk order. Two runs give the same bits.
//
// The normalised value z = (y - mean) * mul + beta is taken with
// round-to-nearest intrinsics in that order (no contraction), so the
// backward recomputes the forward's z, and its ReLU mask, bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace keisei {
namespace trainbn {

constexpr int kSq = 81;          // squares a (b, c) row
constexpr int kThreads = 256;    // every kernel's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;         // rows a warp has in flight
constexpr int kGroup = kWarps * kRows;  // channels of a reduction CTA: a warp owns 4
constexpr int kChunk = 4;        // boards of a reduction CTA
constexpr unsigned kFull = 0xffffffffu;

enum ReduceMode { kSums = 0, kGradPlain = 1, kGradHead = 2, kGradTail = 3 };
enum ApplyMode { kApplyPlain = 0, kApplyHead = 1, kApplyTail = 2 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
// v rounded to the activation's type and back
__device__ __forceinline__ float rnd(float v, const float*) { return v; }
__device__ __forceinline__ float rnd(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// lane's squares of a row are lane, lane + 32 and (lanes < 17) lane + 64
__device__ __forceinline__ bool has(int lane, int k) { return k < 2 || lane < kSq - 64; }

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int lane, float (&v)[3]) {
  v[0] = ld(p + lane);
  v[1] = ld(p + lane + 32);
  v[2] = lane < kSq - 64 ? ld(p + lane + 64) : 0.f;
}

template <typename T>
__device__ __forceinline__ void store_row(T* __restrict__ p, int lane, const float (&v)[3]) {
  st(p + lane, v[0]);
  st(p + lane + 32, v[1]);
  if (lane < kSq - 64) st(p + lane + 64, v[2]);
}

// butterfly: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// the same over n rows at once: their shuffle chains overlap
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
}

template <int N>
__device__ __forceinline__ void warp_maxes(float (&v)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = fmaxf(v[i], __shfl_xor_sync(kFull, v[i], o));
}

__device__ __forceinline__ float bn_z(float y, float mean, float mul, float beta) {
  return __fadd_rn(__fmul_rn(__fsub_rn(y, mean), mul), beta);
}

__device__ __forceinline__ float sigmoid(float s) { return 1.f / (1.f + expf(-s)); }

// a BatchNorm's per-channel mean, mul (rsqrt(var + eps) * weight) and beta, f32
struct Affine {
  const float* mean;
  const float* mul;
  const float* beta;
};

// ---- global pool of a block's input -------------------------------------------
//
// One warp a row, kRows rows a warp: mean, max and the population std with
// 1e-10 inside the sqrt, as models/se_resnet.py:global_pool, into the
// (B, 3C) [mean | max | std] layout the gp FC reads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_stats_kernel(const T* __restrict__ x, float* __restrict__ pool, int B, int C) {
  const int lane = threadIdx.x & 31;
  const long R = (long)B * C;
  const long r0 = (((long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kRows;
  if (r0 >= R) return;
  float v[kRows][3] = {};
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (r0 + i < R) load_row(x + (r0 + i) * kSq, lane, v[i]);
  float mean[kRows], mx[kRows], d[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    mean[i] = v[i][0] + v[i][1] + v[i][2];  // v[i][2] is 0 on lanes >= 17
    mx[i] = fmaxf(v[i][0], v[i][1]);
    if (has(lane, 2)) mx[i] = fmaxf(mx[i], v[i][2]);
  }
  warp_sums(mean);
  warp_maxes(mx);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    mean[i] = __fdiv_rn(mean[i], (float)kSq);
    d[i] = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float t = __fsub_rn(v[i][k], mean[i]);
      if (has(lane, k)) d[i] += t * t;
    }
  }
  warp_sums(d);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long r = r0 + i;
    if (r >= R || lane != 0) break;
    const long b = r / C, c = r - b * C;
    float* p = pool + b * 3 * C + c;
    p[0] = mean[i];
    p[C] = mx[i];
    p[2 * C] = sqrtf(__fdiv_rn(d[i], (float)kSq) + 1e-10f);
  }
}

// dx = dmean / 81 + dstd (x - mean) / (81 std) + dmax / n on each of the n
// squares tied at the max (split evenly, as torch.amax's backward splits it)
// (+ add, the gradient the block's residual gives x, where it is not null)
template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_grad_kernel(const T* __restrict__ x, const float* __restrict__ pool,
                 const float* __restrict__ dpool, const T* __restrict__ add, T* __restrict__ dx,
                 int B, int C) {
  const int lane = threadIdx.x & 31;
  const long R = (long)B * C;
  const long r0 = (((long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kRows;
  if (r0 >= R) return;
  float v[kRows][3], va[kRows][3];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= R) break;
    load_row(x + (r0 + i) * kSq, lane, v[i]);
    if (add != nullptr) load_row(add + (r0 + i) * kSq, lane, va[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long r = r0 + i;
    if (r >= R) break;
    const long b = r / C, c = r - b * C;
    const long at = b * 3 * C + c;
    const float mean = pool[at], mx = pool[at + C], sd = pool[at + 2 * C];
    const float dm = dpool[at], dmx = dpool[at + C], dsd = dpool[at + 2 * C];
    int ties = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) ties += __popc(__ballot_sync(kFull, has(lane, k) && v[i][k] == mx));
    const float a = dm / kSq, coef = dsd / (kSq * sd), share = dmx / ties;
    float g[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      g[k] = a + coef * (v[i][k] - mean) + (v[i][k] == mx ? share : 0.f) +
             (add != nullptr ? va[i][k] : 0.f);
    store_row(dx + r * kSq, lane, g);
  }
}

// ---- reductions: per-channel sums (two-stage) and per-(b, c) sums ------------------
//
// CTA (chunk, group) owns boards [chunk * kChunk, +kChunk) of channels
// [group * 32, +32); warp w the 4 consecutive channels group * 32 + 4w + u,
// whose rows at one board are contiguous: one step loads those 4 rows.
// Each lane adds its squares' terms over the chunk in a fixed order; the CTA
// writes the warp sums of channel c to partials[(q * C + c) * chunks + chunk].
//
//   kSums      e1 = y, e2 = y^2; rows[b, c] = the row's sum of y (if asked, f32)
//   kGradPlain dz = g (* [out > 0] with a ReLU); e1 = dz, e2 = dz (y - mean)
//   kGradHead  dz = g * [rnd(z) > 0]; dg[b, c] = the row's sum of g (the gp
//              bias's gradient, in T)
//   kGradTail  dr = g * [out > 0], written to dres (the residual's gradient);
//              dz = dr * sigmoid(s), s = se[b, c]; dse[b, c] = sum dr z *
//              sigmoid'(s) (the SE scale's gradient), dse[b, C + c] = sum dr
//              (the shift's), in T
struct ReduceArgs {
  const void* g;       // the upstream gradient (grad modes)
  const void* out;     // the layer's output: its ReLU mask
  const void* y;       // the BatchNorm's input
  Affine af;           // (grad modes)
  const void* se;      // (B, 2C): the SE's scale and shift (kGradTail)
  float* partials;     // (2, C, chunks)
  float* rows;         // (B, C) f32 (kSums) or null
  void* drow;          // (B, C) dg (kGradHead), (B, 2C) dse (kGradTail), in T
  void* dres;          // (B, C, 9, 9) (kGradTail)
  int B, C, relu;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) bn_reduce_kernel(ReduceArgs a) {
  const int lane = threadIdx.x & 31;
  const int c0 = blockIdx.y * kGroup + (threadIdx.x >> 5) * kRows;
  if (c0 >= a.C) return;  // a whole warp: no shuffle waits on it
  const int chunks = gridDim.x, C = a.C;
  const int b_lo = blockIdx.x * kChunk, b_hi = min(a.B, b_lo + kChunk);
  const int nc = min(kRows, C - c0);
  const T* y = static_cast<const T*>(a.y);
  const T* g = static_cast<const T*>(a.g);
  const T* out = static_cast<const T*>(a.out);
  const T* se = static_cast<const T*>(a.se);
  T* drow = static_cast<T*>(a.drow);
  float mean[kRows], mul[kRows], beta[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int c = min(c0 + u, C - 1);
    mean[u] = MODE == kSums ? 0.f : a.af.mean[c];
    mul[u] = MODE == kSums ? 0.f : a.af.mul[c];
    beta[u] = MODE == kSums ? 0.f : a.af.beta[c];
  }
  float acc1[kRows] = {}, acc2[kRows] = {};
  for (int b = b_lo; b < b_hi; ++b) {
    const long base = ((long)b * C + c0) * kSq;
    float vy[kRows][3], vg[kRows][3], vo[kRows][3];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (u >= nc) break;
      load_row(y + base + u * kSq, lane, vy[u]);
      if (MODE != kSums) load_row(g + base + u * kSq, lane, vg[u]);
      if (MODE == kGradTail || (MODE == kGradPlain && a.relu))
        load_row(out + base + u * kSq, lane, vo[u]);
    }
    float rs0[kRows] = {}, rs1[kRows] = {}, sg[kRows] = {};
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (u >= nc) break;
      if (MODE == kGradTail) sg[u] = sigmoid(ld(se + (long)b * 2 * C + c0 + u));
      float dr[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        if (!has(lane, k)) {
          dr[k] = 0.f;
          continue;
        }
        const float yv = vy[u][k];
        if (MODE == kSums) {
          acc1[u] += yv;
          acc2[u] += yv * yv;
          rs0[u] += yv;
          continue;
        }
        float dz = vg[u][k];
        if (MODE == kGradPlain && a.relu && !(vo[u][k] > 0.f)) dz = 0.f;
        if (MODE == kGradHead) {
          rs0[u] += dz;
          if (!(rnd(bn_z(yv, mean[u], mul[u], beta[u]), y) > 0.f)) dz = 0.f;
        }
        if (MODE == kGradTail) {
          dr[k] = vo[u][k] > 0.f ? dz : 0.f;
          rs0[u] += dr[k];
          rs1[u] += dr[k] * bn_z(yv, mean[u], mul[u], beta[u]);
          dz = dr[k] * sg[u];
        }
        acc1[u] += dz;
        acc2[u] += dz * __fsub_rn(yv, mean[u]);
      }
      if (MODE == kGradTail) store_row(static_cast<T*>(a.dres) + base + u * kSq, lane, dr);
    }
    // the rows' sums: sums of y (kSums, if asked), dg (kGradHead), dse (kGradTail)
    if ((MODE == kSums && a.rows != nullptr) || MODE == kGradHead || MODE == kGradTail) {
      warp_sums(rs0);
      if (MODE == kGradTail) warp_sums(rs1);
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (u >= nc || lane != 0) break;
        const long bc = (long)b * C + c0 + u;
        if (MODE == kSums) a.rows[bc] = rs0[u];
        if (MODE == kGradHead) st(drow + bc, rs0[u]);
        if (MODE == kGradTail) {
          st(drow + (long)b * 2 * C + c0 + u, rs1[u] * sg[u] * (1.f - sg[u]));
          st(drow + (long)b * 2 * C + C + c0 + u, rs0[u]);
        }
      }
    }
  }
  warp_sums(acc1);
  warp_sums(acc2);
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (u >= nc || lane != 0) break;
    a.partials[(long)(c0 + u) * chunks + blockIdx.x] = acc1[u];
    a.partials[(long)(C + c0 + u) * chunks + blockIdx.x] = acc2[u];
  }
}

// The partials of row qc (q * C + c) added in order: thread t adds t, t + 256,
// ..., then the CTA's warps in order. Sums: out (2, C) = [sum e1 | sum e2].
// Gradients (mul given): out (3, C) = [-mul * s1 | s2 | s1], the gradients of
// mean, mul and beta through z = (y - mean) * mul + beta.
__global__ void __launch_bounds__(kThreads)
bn_finish_kernel(const float* __restrict__ partials, const float* __restrict__ mul,
                 float* __restrict__ out, int chunks, int C) {
  __shared__ float part[kWarps];
  const float* p = partials + (long)blockIdx.x * chunks;
  float s = 0.f;
  for (int j = threadIdx.x; j < chunks; j += kThreads) s += p[j];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += part[w];
    if (mul == nullptr) {
      out[blockIdx.x] = t;
    } else if (blockIdx.x < C) {
      out[blockIdx.x] = -mul[blockIdx.x] * t;
      out[2 * C + blockIdx.x] = t;
    } else {
      out[blockIdx.x] = t;
    }
  }
}

// ---- the (C,)-sized step's gradient ------------------------------------------------
//
// The step is FlaxBatchNorm.batch_affine in PyTorch: m = sums / n (a sum over
// the ranks under data parallelism), var = clamp(E[y^2] - mean^2, 0),
// mul = rsqrt(var + eps) * w; for a block's bn2 also the SE input
// se_in[b, c] = (rows[b, c] / 81 - mean) * mul + beta. Given the gradients of
// mean, mul and beta through the apply (bn_finish_kernel's) and of se_in, one
// CTA of 32 x 32 threads a group of 32 channels writes, in closed form:
//   drows[b, c] = dse_in * mul / 81,
//   dw = dmul r, db = dbeta, r = rsqrt(max(var_raw, 0) + eps),
//   dvar = -dmul w r^3 / 2 where var_raw >= 0 (torch.clamp's gradient), else 0,
//   dsums = [dmean - 2 mean dvar, dvar] * scale (scale 1 / n; 1 under data
//   parallelism, where the caller sums over the ranks first),
// with dmean, dmul, dbeta taking the SE input's sums over b (thread row t
// adds b = t, t + 32, ..., then the rows in order).
struct MomentsArgs {
  Affine dapply;        // the apply's gradients of mean, mul, beta
  Affine af;            // mean, mul (beta unused)
  const float* var_raw; // (C,)
  const float* w;       // (C,)
  const float* rows;    // (B, C) the rows' sums, or null
  const float* dse;     // (B, C) the gradient of se_in, or null
  float* drows;         // (B, C), where rows is given
  float* dsums;         // (2, C)
  float* dw;            // (C,)
  float* db;            // (C,)
  int B, C;
  float eps, scale;
};

constexpr int kMomentRows = 32;

__global__ void __launch_bounds__(32 * kMomentRows) bn_moments_grad_kernel(MomentsArgs a) {
  __shared__ float part[2][kMomentRows][33];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + tx;
  const bool live = c < a.C;
  const float mean = live ? a.af.mean[c] : 0.f, mul = live ? a.af.mul[c] : 0.f;
  float t1 = 0.f, t2 = 0.f;
  if (a.rows != nullptr && live) {
    for (int b = ty; b < a.B; b += kMomentRows) {
      const long bc = (long)b * a.C + c;
      const float d = a.dse[bc];
      t1 += d;
      t2 += d * (a.rows[bc] / kSq - mean);
      a.drows[bc] = d * mul / kSq;
    }
  }
  part[0][ty][tx] = t1;
  part[1][ty][tx] = t2;
  __syncthreads();
  if (ty != 0 || !live) return;
  for (int j = 1; j < kMomentRows; ++j) {
    t1 += part[0][j][tx];
    t2 += part[1][j][tx];
  }
  const float dbeta = a.dapply.beta[c] + t1;
  const float dmul = a.dapply.mul[c] + t2;
  const float dmean = a.dapply.mean[c] - mul * t1;
  const float vr = a.var_raw[c];
  const float r = rsqrtf(fmaxf(vr, 0.f) + a.eps);
  const float dvar = vr >= 0.f ? -0.5f * dmul * a.w[c] * r * r * r : 0.f;
  a.dw[c] = dmul * r;
  a.db[c] = dbeta;
  a.dsums[c] = (dmean - 2.f * mean * dvar) * a.scale;
  a.dsums[a.C + c] = dvar * a.scale;
}

// ---- apply passes ---------------------------------------------------------------
//
//   kApplyPlain out = z, or relu(z)
//   kApplyHead  h = relu(rnd(z)) + g[b, c]                    (g: the gp bias, T)
//   kApplyTail  out = relu(z * sigmoid(s) + t + x), [s | t] = se[b] (T)
struct ApplyArgs {
  const void* y;
  const void* x;       // the block's input (kApplyTail)
  Affine af;
  const void* row;     // (B, C) g (kApplyHead), (B, 2C) se (kApplyTail), in T
  void* out;
  int B, C, relu;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(ApplyArgs a) {
  const int lane = threadIdx.x & 31;
  const long R = (long)a.B * a.C;
  const long r0 = (((long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kRows;
  if (r0 >= R) return;
  const T* y = static_cast<const T*>(a.y);
  const T* x = static_cast<const T*>(a.x);
  const T* row = static_cast<const T*>(a.row);
  float vy[kRows][3], vx[kRows][3];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= R) break;
    load_row(y + (r0 + i) * kSq, lane, vy[i]);
    if (MODE == kApplyTail) load_row(x + (r0 + i) * kSq, lane, vx[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long r = r0 + i;
    if (r >= R) break;
    const long b = r / a.C;
    const int c = (int)(r - b * a.C);
    const float mean = a.af.mean[c], mul = a.af.mul[c], beta = a.af.beta[c];
    float r0v = 0.f, r1v = 0.f;
    if (MODE == kApplyHead) r0v = ld(row + r);
    if (MODE == kApplyTail) {
      r0v = sigmoid(ld(row + b * 2 * a.C + c));
      r1v = ld(row + b * 2 * a.C + a.C + c);
    }
    float o[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float z = bn_z(vy[i][k], mean, mul, beta);
      if (MODE == kApplyPlain) o[k] = a.relu ? fmaxf(z, 0.f) : z;
      if (MODE == kApplyHead) o[k] = fmaxf(rnd(z, y), 0.f) + r0v;
      if (MODE == kApplyTail) o[k] = fmaxf(z * r0v + r1v + vx[i][k], 0.f);
    }
    store_row(static_cast<T*>(a.out) + r * kSq, lane, o);
  }
}

// ---- the gradient into the conv -------------------------------------------------
//
// dy = dz * mul + dsum1[c] + 2 y dsum2[c] (+ drow[b, c]): the apply's term and
// the sums' terms (mean, E[y^2], and for the tail the SE input's per-row sum)
// in one pass; dz as bn_reduce_kernel takes it (kGradTail: g is dres, masked).
struct GradArgs {
  const void* g;
  const void* out;     // kGradPlain with a ReLU
  const void* y;
  Affine af;
  const void* se;      // (B, 2C) in T (kGradTail)
  const float* dsums;  // (2, C): the gradients of the sums of y and y^2
  const float* drow;   // (B, C): the gradient of the rows' sums (kGradTail) or null
  void* dy;
  int B, C, relu;
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) bn_grad_kernel(GradArgs a) {
  const int lane = threadIdx.x & 31;
  const long R = (long)a.B * a.C;
  const long r0 = (((long)blockIdx.x * kThreads + threadIdx.x) >> 5) * kRows;
  if (r0 >= R) return;
  const T* y = static_cast<const T*>(a.y);
  const T* g = static_cast<const T*>(a.g);
  const T* out = static_cast<const T*>(a.out);
  const T* se = static_cast<const T*>(a.se);
  float vy[kRows][3], vg[kRows][3], vo[kRows][3];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (r0 + i >= R) break;
    load_row(y + (r0 + i) * kSq, lane, vy[i]);
    load_row(g + (r0 + i) * kSq, lane, vg[i]);
    if (MODE == kGradPlain && a.relu) load_row(out + (r0 + i) * kSq, lane, vo[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long r = r0 + i;
    if (r >= R) break;
    const long b = r / a.C;
    const int c = (int)(r - b * a.C);
    const float mean = a.af.mean[c], mul = a.af.mul[c], beta = a.af.beta[c];
    const float d1 = a.dsums[c], d2 = a.dsums[a.C + c];
    const float sg = MODE == kGradTail ? sigmoid(ld(se + b * 2 * a.C + c)) : 0.f;
    const float dw = a.drow != nullptr ? a.drow[r] : 0.f;
    float o[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float yv = vy[i][k];
      float dz = vg[i][k];
      if (MODE == kGradPlain && a.relu && !(vo[i][k] > 0.f)) dz = 0.f;
      if (MODE == kGradHead && !(rnd(bn_z(yv, mean, mul, beta), y) > 0.f)) dz = 0.f;
      if (MODE == kGradTail) dz *= sg;
      o[k] = dz * mul + (d1 + 2.f * yv * d2) + dw;
    }
    store_row(static_cast<T*>(a.dy) + r * kSq, lane, o);
  }
}

inline unsigned row_blocks(int B, int C) {
  const long warps = ((long)B * C + kRows - 1) / kRows;
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

template <typename T>
int reduce(int mode, ReduceArgs a, float* sums, cudaStream_t s) {
  const dim3 grid((a.B + kChunk - 1) / kChunk, (a.C + kGroup - 1) / kGroup);
  switch (mode) {
    case kSums: bn_reduce_kernel<T, kSums><<<grid, kThreads, 0, s>>>(a); break;
    case kGradPlain: bn_reduce_kernel<T, kGradPlain><<<grid, kThreads, 0, s>>>(a); break;
    case kGradHead: bn_reduce_kernel<T, kGradHead><<<grid, kThreads, 0, s>>>(a); break;
    case kGradTail: bn_reduce_kernel<T, kGradTail><<<grid, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bn_finish_kernel<<<2 * a.C, kThreads, 0, s>>>(a.partials, mode == kSums ? nullptr : a.af.mul,
                                                sums, (int)grid.x, a.C);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(int mode, ApplyArgs a, cudaStream_t s) {
  const unsigned blocks = row_blocks(a.B, a.C);
  switch (mode) {
    case kApplyPlain: bn_apply_kernel<T, kApplyPlain><<<blocks, kThreads, 0, s>>>(a); break;
    case kApplyHead: bn_apply_kernel<T, kApplyHead><<<blocks, kThreads, 0, s>>>(a); break;
    case kApplyTail: bn_apply_kernel<T, kApplyTail><<<blocks, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int grad(int mode, GradArgs a, cudaStream_t s) {
  const unsigned blocks = row_blocks(a.B, a.C);
  switch (mode) {
    case kGradPlain: bn_grad_kernel<T, kGradPlain><<<blocks, kThreads, 0, s>>>(a); break;
    case kGradHead: bn_grad_kernel<T, kGradHead><<<blocks, kThreads, 0, s>>>(a); break;
    case kGradTail: bn_grad_kernel<T, kGradTail><<<blocks, kThreads, 0, s>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

Affine affine(const void* mean, const void* mul, const void* beta) {
  return Affine{static_cast<const float*>(mean), static_cast<const float*>(mul),
                static_cast<const float*>(beta)};
}

}  // namespace trainbn
}  // namespace keisei

extern "C" {

// dmean, dmul, dbeta (the apply's), mean, mul, var_raw, w (C,); rows, dse
// (B, C) or null -> drows (B, C) (where rows is given), dsums (2, C), dw, db
// (C,); all f32.
int keisei_bn_moments_backward(const void* dmean, const void* dmul, const void* dbeta,
                               const void* mean, const void* mul,
                               const void* var_raw, const void* w, const void* rows,
                               const void* dse, void* drows, void* dsums, void* dw, void* db,
                               int B, int C, float eps, float scale, void* stream) {
  using namespace keisei::trainbn;
  if (B < 1 || C < 1 || (rows == nullptr) != (dse == nullptr)) return (int)cudaErrorInvalidValue;
  const float* f = nullptr;
  MomentsArgs a{affine(dmean, dmul, dbeta), affine(mean, mul, f),
                static_cast<const float*>(var_raw), static_cast<const float*>(w),
                static_cast<const float*>(rows), static_cast<const float*>(dse),
                static_cast<float*>(drows), static_cast<float*>(dsums), static_cast<float*>(dw),
                static_cast<float*>(db), B, C, eps, scale};
  bn_moments_grad_kernel<<<(C + 31) / 32, 32 * kMomentRows, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Every tensor is contiguous; activations (B, C, 9, 9), the gp bias g (B, C)
// and the SE output se (B, 2C) in bf16 (bf16 = 1) or f32 (bf16 = 0); every
// other operand f32, a BatchNorm's mean, mul and beta (C,) each. Each returns
// a cudaError_t.

// x -> pool (B, 3C): [mean | max | std]
int keisei_pool_stats(const void* x, void* pool, int B, int C, int bf16, void* stream) {
  using namespace keisei::trainbn;
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = row_blocks(B, C);
  float* p = static_cast<float*>(pool);
  if (bf16)
    pool_stats_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(x), p, B, C);
  else
    pool_stats_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), p, B, C);
  return (int)cudaGetLastError();
}

// x, pool, dpool (B, 3C), add (like x, or null) -> dx
int keisei_pool_stats_backward(const void* x, const void* pool, const void* dpool,
                               const void* add, void* dx, int B, int C, int bf16,
                               void* stream) {
  using namespace keisei::trainbn;
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = row_blocks(B, C);
  const float* p = static_cast<const float*>(pool);
  const float* dp = static_cast<const float*>(dpool);
  using bf = __nv_bfloat16;
  if (bf16)
    pool_grad_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const bf*>(x), p, dp,
                                                 static_cast<const bf*>(add),
                                                 static_cast<bf*>(dx), B, C);
  else
    pool_grad_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const float*>(x), p, dp,
                                                 static_cast<const float*>(add),
                                                 static_cast<float*>(dx), B, C);
  return (int)cudaGetLastError();
}

// mode 0: y -> sums (2, C) of y and y^2 (and rows, (B, C) f32, unless null);
// modes 1-3 (plain, head, tail): g, y (, out, se) -> sums (3, C), the
// gradients of mean, mul and beta; drow (head: dg (B, C), tail: dse (B, 2C))
// and dres (tail). partials: (2, C, ceil(B / 4)) f32 scratch.
int keisei_bn_reduce(int mode, const void* g, const void* out, const void* y, const void* mean,
                     const void* mul, const void* beta, const void* se, void* partials,
                     void* sums, void* rows, void* drow, void* dres, int B, int C, int relu,
                     int bf16, void* stream) {
  using namespace keisei::trainbn;
  if (B < 1 || C < 1 || (C + kGroup - 1) / kGroup > 65535 || (mode != kSums && mul == nullptr))
    return (int)cudaErrorInvalidValue;
  ReduceArgs a{g, out, y, affine(mean, mul, beta), se, static_cast<float*>(partials),
               static_cast<float*>(rows), drow, dres, B, C, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sm = static_cast<float*>(sums);
  return bf16 ? reduce<__nv_bfloat16>(mode, a, sm, s) : reduce<float>(mode, a, sm, s);
}

// mode 0 (plain, relu optional), 1 (the block's head: row = g), 2 (its tail:
// x, row = se) -> out
int keisei_bn_apply(int mode, const void* y, const void* x, const void* mean, const void* mul,
                    const void* beta, const void* row, void* out, int B, int C, int relu,
                    int bf16, void* stream) {
  using namespace keisei::trainbn;
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  ApplyArgs a{y, x, affine(mean, mul, beta), row, out, B, C, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? apply<__nv_bfloat16>(mode, a, s) : apply<float>(mode, a, s);
}

// mode 1 (plain), 2 (head), 3 (tail: g = dres), as keisei_bn_reduce's;
// dsums (2, C), drow (B, C) f32 or null -> dy
int keisei_bn_grad_apply(int mode, const void* g, const void* out, const void* y,
                         const void* mean, const void* mul, const void* beta, const void* se,
                         const void* dsums, const void* drow, void* dy, int B, int C, int relu,
                         int bf16, void* stream) {
  using namespace keisei::trainbn;
  if (B < 1 || C < 1) return (int)cudaErrorInvalidValue;
  GradArgs a{g, out, y, affine(mean, mul, beta), se, static_cast<const float*>(dsums),
             static_cast<const float*>(drow), dy, B, C, relu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? grad<__nv_bfloat16>(mode, a, s) : grad<float>(mode, a, s);
}

}  // extern "C"
