// Online-contrastive loss, forward and backward, for Hopper (sm_90a).
//
// Forward replaces the TPU Pallas kernel repro/kernels/contrastive/
// kernel.py::contrastive_components (body `_kernel`): per-pair cosine
// distances d = 1 - <e1,e2> / max(|e1||e2|, 1e-9), the batch statistics
// min_neg (smallest distance of a distinct pair) and max_pos (largest of a
// duplicate pair), then the hard-pair sums
//   pos_loss = sum d^2 over duplicates with d > min_neg,
//   neg_loss = sum max(margin - d, 0)^2 over distincts with d < max_pos.
// It writes those four components exactly as the TPU kernel does (no
// fallback: a one-class batch keeps the sentinels +-1e9), and beside them
// the training loss of ../ops.py, whose masks fall back to every pair of a
// class when the other class is absent, divided by B.  Labels: 1 is a
// duplicate, 0 a distinct pair, anything else neither.
//
// Backward is the port's own (the reference takes its gradient from XLA):
// with the coefficient c = (2 d hp - 2 max(m - d, 0) hn) / B for the loss's
// masks hp and hn, and den = |e1||e2|,
//   dL/de1 = up * (a1 e1 - b e2),  dL/de2 = up * (a2 e2 - b e1),
//   a1 = c <e1,e2> / (|e1|^2 den),  a2 = c <e1,e2> / (|e2|^2 den),  b = c / den,
// and, where den < 1e-9 clamps the denominator, a1 = a2 = 0, b = c / 1e-9.
// No gradient flows through min_neg or max_pos: they only select.
//
// Bound.  The forward reads 2 B D floats once and does ~6 B D flops; the
// backward reads the rows of the hard pairs and writes 2 B D floats: both
// are bound by bytes.  At the training batch (B = 16, D = 768) the forward
// is 96 KB, far below a launch's own cost, so what it takes is the launch;
// at B = 4096 it is 25 MB, a few microseconds at HBM rate.
//
// Design.  The TPU kernel is a sequential (2, n_tiles) grid with the batch
// statistics in SMEM.  Here it is ONE cooperative launch (the wrapper caps
// the grid at the CTAs that fit on the card at once), its two phases
// separated by a grid barrier:
//   phase 0: warp w of CTA c owns rows ((k * grid + c) * kWarps + w) for
//     k < rows_per_warp; for each it issues all of a row's 16-byte loads
//     (kUnroll float4 of e1 and of e2 per lane) before the first FMA, sums
//     <e1,e2>, |e1|^2, |e2|^2, and saves (c1, c2, a, d) per row, the
//     backward's scalars before the coefficient.  The CTA reduces
//     (min_neg, max_pos, n_pos, n_neg) in one pass: shuffles on the
//     4-tuple, one shared-memory step, shuffles again; each CTA writes its
//     4-tuple to a per-CTA partial.
//   grid barrier; then every CTA reduces the partials (a few hundred at
//     most) the same way, forms both mask sets for its own rows (lane l of
//     a warp takes the warp's rows k = l, l + 32, ...), overwrites each
//     row's saved scalars with (c c1, c c2, c a, c), and writes a per-CTA
//     4-tuple of sums (pos_loss, neg_loss, and the loss's two sums).
//   grid barrier; then CTA 0 sums the per-CTA 4-tuples in CTA order and
//     writes the components and the loss.
// With grid = 1 (the training batch) both barriers are __syncthreads and
// the statistics never leave shared memory.  Every sum runs in a fixed
// order (no atomics), so a call is deterministic.
//
// Backward: one warp per pair, 8 warps a CTA.  A row whose coefficient is
// 0 (a pair that is not hard) writes zeros without reading e1 or e2; the
// others stream both rows with 16-byte loads (all of a chunk's loads before
// its FMAs) and 16-byte stores.  The scalar path takes widths that are not
// a multiple of 4 or rows that are not 16-byte aligned.  The backward stays
// a launch of its own: folded into the forward it would write 2 B D floats
// where only the value is wanted (contrastive_components, evaluation), and
// the upstream gradient is known only after the forward.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;                  // forward: one row per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kGradWarps = 8;               // backward: one row per warp
constexpr int kGradThreads = 32 * kGradWarps;
constexpr int kUnroll = 6;                  // float4 per lane a chunk: D = 768
constexpr float kBig = 1e9f;

// (min_neg, max_pos, n_pos, n_neg) of a set of rows.
struct Stats {
  float mn, mx;
  int np, nn;
};

__device__ __forceinline__ Stats stats_identity() {
  return Stats{kBig, -kBig, 0, 0};
}

__device__ __forceinline__ Stats stats_join(Stats a, const Stats& b) {
  a.mn = fminf(a.mn, b.mn);
  a.mx = fmaxf(a.mx, b.mx);
  a.np += b.np;
  a.nn += b.nn;
  return a;
}

__device__ __forceinline__ Stats warp_stats(Stats s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    Stats t;
    t.mn = __shfl_xor_sync(0xffffffffu, s.mn, o);
    t.mx = __shfl_xor_sync(0xffffffffu, s.mx, o);
    t.np = __shfl_xor_sync(0xffffffffu, s.np, o);
    t.nn = __shfl_xor_sync(0xffffffffu, s.nn, o);
    s = stats_join(s, t);
  }
  return s;
}

__device__ __forceinline__ float4 warp_sum4(float4 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
    v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
    v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
  }
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The CTA's reduction of one Stats per thread, returned to every thread;
// `sh` holds kWarps + 1 entries and is used by no other reduction.
__device__ __forceinline__ Stats cta_stats(Stats s, Stats* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_stats(s);
  if (lane == 0) sh[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = warp_stats(lane < kWarps ? sh[lane] : stats_identity());
    if (lane == 0) sh[kWarps] = s;
  }
  __syncthreads();
  return sh[kWarps];
}

__device__ __forceinline__ float4 cta_sum4(float4 v, float4* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum4(v);
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum4(lane < kWarps ? sh[lane] : make_float4(0.f, 0.f, 0.f, 0.f));
    if (lane == 0) sh[kWarps] = v;
  }
  __syncthreads();
  return sh[kWarps];
}

__device__ __forceinline__ void dot3(const float4& x, const float4& y,
                                     float& num, float& s1, float& s2) {
  num = fmaf(x.x, y.x, num); num = fmaf(x.y, y.y, num);
  num = fmaf(x.z, y.z, num); num = fmaf(x.w, y.w, num);
  s1 = fmaf(x.x, x.x, s1); s1 = fmaf(x.y, x.y, s1);
  s1 = fmaf(x.z, x.z, s1); s1 = fmaf(x.w, x.w, s1);
  s2 = fmaf(y.x, y.x, s2); s2 = fmaf(y.y, y.y, s2);
  s2 = fmaf(y.z, y.z, s2); s2 = fmaf(y.w, y.w, s2);
}

// <a,c>, |a|^2, |c|^2 of one row pair, summed over the warp (every lane
// gets the sums).  A full chunk's loads are unconditional, so all of them
// issue before the first FMA; the rest of the row (none at D = 768) goes a
// float4 at a time.
__device__ __forceinline__ void row_sums(const float* __restrict__ a,
                                         const float* __restrict__ c, int D,
                                         int vec4, int lane, float& num,
                                         float& s1, float& s2) {
  num = 0.f, s1 = 0.f, s2 = 0.f;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* c4 = reinterpret_cast<const float4*>(c);
    const int n4 = D >> 2;
    int i = lane;
    for (; i + 32 * (kUnroll - 1) < n4; i += 32 * kUnroll) {
      float4 x[kUnroll], y[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        x[j] = __ldg(a4 + i + 32 * j);
        y[j] = __ldg(c4 + i + 32 * j);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) dot3(x[j], y[j], num, s1, s2);
    }
    for (; i < n4; i += 32) dot3(__ldg(a4 + i), __ldg(c4 + i), num, s1, s2);
  } else {
#pragma unroll 4
    for (int i = lane; i < D; i += 32) {
      const float x = __ldg(a + i), y = __ldg(c + i);
      num = fmaf(x, y, num);
      s1 = fmaf(x, x, s1);
      s2 = fmaf(y, y, s2);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    num += __shfl_xor_sync(0xffffffffu, num, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
}

// out: comps (4,) = pos_loss, neg_loss, min_neg, max_pos (TPU semantics),
// then the loss at out[4]; saved (B,) float4; part_stats and part_sums
// (grid,) each, unused when grid = 1.
__global__ void __launch_bounds__(kThreads)
contrastive_forward_kernel(const float* __restrict__ e1,
                           const float* __restrict__ e2,
                           const int* __restrict__ labels, int B, int D,
                           int vec4, int rows_per_warp, float margin,
                           float* __restrict__ out, float4* saved,
                           Stats* part_stats, float4* part_sums) {
  __shared__ Stats sh_rows[kWarps + 1], sh_parts[kWarps + 1];
  __shared__ float4 sh_sums[kWarps + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int grid = gridDim.x, cta = blockIdx.x;

  // phase 0: distances, saved scalars, the CTA's statistics
  Stats st = stats_identity();
  for (int k = 0; k < rows_per_warp; ++k) {
    const int b = (k * grid + cta) * kWarps + warp;
    if (b >= B) break;
    float num, s1, s2;
    row_sums(e1 + (size_t)b * D, e2 + (size_t)b * D, D, vec4, lane, num, s1,
             s2);
    const float n1 = sqrtf(s1), n2 = sqrtf(s2);
    const float den = n1 * n2;
    const float d = 1.f - num / fmaxf(den, 1e-9f);
    const int l = __ldg(labels + b);
    if (l == 0) { st.mn = fminf(st.mn, d); st.nn += 1; }
    if (l == 1) { st.mx = fmaxf(st.mx, d); st.np += 1; }
    if (lane == 0) {
      // dd/de1 = c1 e1 - a e2, dd/de2 = c2 e2 - a e1
      const bool clamped = !(den >= 1e-9f);
      const float a = clamped ? 1.f / 1e-9f : 1.f / den;
      const float c1 = clamped ? 0.f : num / (n1 * n1 * den);
      const float c2 = clamped ? 0.f : num / (n2 * n2 * den);
      saved[b] = make_float4(c1, c2, a, d);
    }
  }
  // every lane of a warp holds the same statistics: reduce lane 0's
  if (lane != 0) st = stats_identity();
  st = cta_stats(st, sh_rows);
  if (grid > 1) {
    if (threadIdx.x == 0) part_stats[cta] = st;
    cg::this_grid().sync();
    Stats all = stats_identity();
    for (int i = threadIdx.x; i < grid; i += kThreads)
      all = stats_join(all, part_stats[i]);
    st = cta_stats(all, sh_parts);
  }
  const float min_neg = st.mn, max_pos = st.mx;
  const bool any_pos = st.np > 0, any_neg = st.nn > 0;

  // phase 1: masks, coefficients and the CTA's sums over its own rows
  const float inv_b = 1.f / static_cast<float>(B);
  float4 sums = make_float4(0.f, 0.f, 0.f, 0.f);   // pc, nc, pl, nl
  for (int k = lane; k < rows_per_warp; k += 32) {
    const int b = (k * grid + cta) * kWarps + warp;
    if (b >= B) break;
    const float4 s = saved[b];
    const float d = s.w;
    const int l = __ldg(labels + b);
    const float r = fmaxf(margin - d, 0.f);
    const bool hp_c = l == 1 && d > min_neg;
    const bool hn_c = l == 0 && d < max_pos;
    const bool hp_l = l == 1 && (any_neg ? d > min_neg : true);
    const bool hn_l = l == 0 && (any_pos ? d < max_pos : true);
    if (hp_c) sums.x += d * d;
    if (hn_c) sums.y += r * r;
    if (hp_l) sums.z += d * d;
    if (hn_l) sums.w += r * r;
    const float c = ((hp_l ? 2.f * d : 0.f) - (hn_l ? 2.f * r : 0.f)) * inv_b;
    saved[b] = make_float4(c * s.x, c * s.y, c * s.z, c);
  }
  sums = cta_sum4(sums, sh_sums);
  if (grid > 1) {
    if (threadIdx.x == 0) part_sums[cta] = sums;
    cg::this_grid().sync();
    if (cta != 0) return;
    float4 all = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = threadIdx.x; i < grid; i += kThreads)
      all = add4(all, part_sums[i]);
    sums = cta_sum4(all, sh_sums);
  }
  if (threadIdx.x == 0) {
    out[0] = sums.x;
    out[1] = sums.y;
    out[2] = min_neg;
    out[3] = max_pos;
    out[4] = (sums.z + sums.w) / static_cast<float>(B);
  }
}

__device__ __forceinline__ float4 grad4(float p, float q, const float4& x,
                                        const float4& y) {
  return make_float4(fmaf(p, x.x, -q * y.x), fmaf(p, x.y, -q * y.y),
                     fmaf(p, x.z, -q * y.z), fmaf(p, x.w, -q * y.w));
}

// saved (B,) float4 = (a1, a2, b, c) from the forward; upstream a device
// scalar.
__global__ void __launch_bounds__(kGradThreads)
contrastive_backward_kernel(const float* __restrict__ e1,
                            const float* __restrict__ e2,
                            const float4* __restrict__ saved,
                            const float* __restrict__ upstream, int B, int D,
                            int vec4, float* __restrict__ g1,
                            float* __restrict__ g2) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kGradWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float4 s = saved[b];
  const size_t off = (size_t)b * D;
  const bool hard = s.w != 0.f;
  const float u = *upstream;
  const float a1 = u * s.x, a2 = u * s.y, bt = u * s.z;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(e1 + off);
    const float4* y4 = reinterpret_cast<const float4*>(e2 + off);
    float4* o1 = reinterpret_cast<float4*>(g1 + off);
    float4* o2 = reinterpret_cast<float4*>(g2 + off);
    const int n4 = D >> 2;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!hard) {
      for (int i = lane; i < n4; i += 32) {
        o1[i] = z;
        o2[i] = z;
      }
      return;
    }
    int i = lane;
    for (; i + 32 * (kUnroll - 1) < n4; i += 32 * kUnroll) {
      float4 x[kUnroll], y[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        x[j] = __ldg(x4 + i + 32 * j);
        y[j] = __ldg(y4 + i + 32 * j);
      }
#pragma unroll
      for (int j = 0; j < kUnroll; ++j) {
        o1[i + 32 * j] = grad4(a1, bt, x[j], y[j]);
        o2[i + 32 * j] = grad4(a2, bt, y[j], x[j]);
      }
    }
    for (; i < n4; i += 32) {
      const float4 x = __ldg(x4 + i), y = __ldg(y4 + i);
      o1[i] = grad4(a1, bt, x, y);
      o2[i] = grad4(a2, bt, y, x);
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      if (!hard) {
        g1[off + i] = 0.f;
        g2[off + i] = 0.f;
        continue;
      }
      const float x = __ldg(e1 + off + i), y = __ldg(e2 + off + i);
      g1[off + i] = fmaf(a1, x, -bt * y);
      g2[off + i] = fmaf(a2, y, -bt * x);
    }
  }
}

}  // namespace

extern "C" {

// CTAs of the forward kernel one SM holds at once, for the current device:
// the wrapper's cap on the cooperative grid is this times the SM count.
// Returns the CUDA error of the query (0 = answered).
int contrastive_forward_ctas_per_sm(int* ctas) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, contrastive_forward_kernel, kThreads, 0);
}

// Forward: one cooperative launch of `grid` CTAs on `stream` (the wrapper's
// geometry: grid at most the co-resident CTAs, rows_per_warp * grid *
// kWarps >= B).  out holds 8 floats (comps, the loss, padding), then the
// saved (B,) float4, then, when grid > 1, 2 * grid float4 of per-CTA
// partials; it must be 16-byte aligned.  Returns the launch's error, then
// cudaGetLastError() (0 = launched).
int contrastive_forward_launch(const float* e1, const float* e2,
                               const int* labels, int B, int D, int vec4,
                               int grid, int rows_per_warp, float margin,
                               float* out, void* stream) {
  if (B < 1 || grid < 1 || rows_per_warp < 1 ||
      (int64_t)rows_per_warp * grid * kWarps < B ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  float4* saved = reinterpret_cast<float4*>(out + 8);
  Stats* part_stats = reinterpret_cast<Stats*>(saved + B);
  float4* part_sums = reinterpret_cast<float4*>(part_stats + grid);
  void* args[] = {&e1, &e2, &labels, &B, &D, &vec4, &rows_per_warp,
                  &margin, &out, &saved, &part_stats, &part_sums};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(contrastive_forward_kernel), dim3(grid),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Backward: one warp per pair, ceil(B / 8) CTAs; `saved` is the forward's
// (B,) float4, `upstream` the loss's incoming gradient, a device scalar.
int contrastive_backward_launch(const float* e1, const float* e2,
                                const float* saved, const float* upstream,
                                int B, int D, int vec4, float* g1, float* g2,
                                void* stream) {
  const int blocks = (B + kGradWarps - 1) / kGradWarps;
  contrastive_backward_kernel<<<blocks, kGradThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      e1, e2, reinterpret_cast<const float4*>(saved), upstream, B, D, vec4,
      g1, g2);
  return (int)cudaGetLastError();
}

}  // extern "C"
