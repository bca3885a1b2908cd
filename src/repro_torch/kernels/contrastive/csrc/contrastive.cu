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
// fallback), and beside them the training loss of ../ops.py, whose masks
// fall back to every pair of a class when the other class is absent, divided
// by B.  Labels: 1 is a duplicate, 0 a distinct pair, anything else neither.
//
// Backward is the port's own (the reference takes its gradient from XLA):
// with g = dL * (2 d hp - 2 max(m - d, 0) hn) / B for the loss's masks hp and
// hn, and den = |e1||e2|,
//   dL/de1 = g * (-e2 / den + <e1,e2> e1 / (|e1|^2 den)),  symmetric for e2,
// and, where den < 1e-9 clamps the denominator, dL/de1 = -g e2 / 1e-9.  No
// gradient flows through min_neg or max_pos: they only select.
//
// Design.  The TPU kernel runs a sequential two-phase grid with the batch
// statistics in SMEM.  CUDA blocks run in no order, so the barrier between
// the phases becomes a second launch:
//   launch 1 (rows): one warp per pair computes <e1,e2>, |e1|, |e2| and d in
//     fp32 FMA (float4 loads when D % 4 == 0) and saves them per row;
//   launch 2 (reduce): one block reduces min_neg, max_pos and the class
//     counts over B, then forms the masks, sums the components and the loss,
//     and saves each row's coefficient (2 d hp - 2 max(m - d, 0) hn) / B;
//   backward: one block per row scales the saved coefficient by the
//     upstream gradient and writes both rows' gradients.
// Bound: the forward reads 2 B D floats once and does ~6 B D flops; the
// backward reads them again and writes as many: both are bound by bytes.
// At the training batch (B = 16, D = 768) the work is ~100 KB, far below
// a launch's own cost, so what the kernels take is launch latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;
constexpr int kReduceThreads = 1024;
constexpr int kGradThreads = 256;
constexpr float kBig = 1e9f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows: (B, 4) = d, <e1,e2>, |e1|, |e2|.
__global__ void __launch_bounds__(kRowThreads)
contrastive_rows_kernel(const float* __restrict__ e1,
                        const float* __restrict__ e2, int B, int D, int vec4,
                        float* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  const float* a = e1 + (size_t)b * D;
  const float* c = e2 + (size_t)b * D;
  float num = 0.f, s1 = 0.f, s2 = 0.f;
  if (vec4) {
    const float4* a4 = reinterpret_cast<const float4*>(a);
    const float4* c4 = reinterpret_cast<const float4*>(c);
    for (int i = lane; i < (D >> 2); i += 32) {
      const float4 x = __ldg(a4 + i);
      const float4 y = __ldg(c4 + i);
      num = fmaf(x.x, y.x, num); num = fmaf(x.y, y.y, num);
      num = fmaf(x.z, y.z, num); num = fmaf(x.w, y.w, num);
      s1 = fmaf(x.x, x.x, s1); s1 = fmaf(x.y, x.y, s1);
      s1 = fmaf(x.z, x.z, s1); s1 = fmaf(x.w, x.w, s1);
      s2 = fmaf(y.x, y.x, s2); s2 = fmaf(y.y, y.y, s2);
      s2 = fmaf(y.z, y.z, s2); s2 = fmaf(y.w, y.w, s2);
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float x = __ldg(a + i), y = __ldg(c + i);
      num = fmaf(x, y, num);
      s1 = fmaf(x, x, s1);
      s2 = fmaf(y, y, s2);
    }
  }
  num = warp_sum(num);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    const float n1 = sqrtf(s1), n2 = sqrtf(s2);
    const float d = 1.f - num / fmaxf(n1 * n2, 1e-9f);
    float4 out = make_float4(d, num, n1, n2);
    reinterpret_cast<float4*>(rows)[b] = out;
  }
}

// Block-wide reductions through shared memory (kReduceThreads / 32 warps).
__device__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? scratch[threadIdx.x] : 0.f;
  if (warp == 0) v = warp_sum(v);
  if (threadIdx.x == 0) scratch[0] = v;
  __syncthreads();
  return scratch[0];
}

__device__ float block_min(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? scratch[threadIdx.x] : kBig;
  if (warp == 0) v = warp_min(v);
  if (threadIdx.x == 0) scratch[0] = v;
  __syncthreads();
  return scratch[0];
}

__device__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = threadIdx.x < (blockDim.x >> 5) ? scratch[threadIdx.x] : -kBig;
  if (warp == 0) v = warp_max(v);
  if (threadIdx.x == 0) scratch[0] = v;
  __syncthreads();
  return scratch[0];
}

// comps: (4,) = pos_loss, neg_loss, min_neg, max_pos (TPU semantics);
// loss: () the training loss; coef: (B,) dLoss/dd per unit upstream.
__global__ void __launch_bounds__(kReduceThreads)
contrastive_reduce_kernel(const float* __restrict__ rows,
                          const int* __restrict__ labels, int B,
                          float margin, float* __restrict__ comps,
                          float* __restrict__ loss,
                          float* __restrict__ coef) {
  __shared__ float scratch[32];
  float mn = kBig, mx = -kBig, npos = 0.f, nneg = 0.f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float d = rows[4 * b];
    const int l = labels[b];
    if (l == 0) { mn = fminf(mn, d); nneg += 1.f; }
    if (l == 1) { mx = fmaxf(mx, d); npos += 1.f; }
  }
  const float min_neg = block_min(mn, scratch);
  const float max_pos = block_max(mx, scratch);
  const bool any_pos = block_sum(npos, scratch) > 0.f;
  const bool any_neg = block_sum(nneg, scratch) > 0.f;

  const float inv_b = 1.f / static_cast<float>(B);
  float pc = 0.f, nc = 0.f, pl = 0.f, nl = 0.f;
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const float d = rows[4 * b];
    const int l = labels[b];
    const float r = fmaxf(margin - d, 0.f);
    const bool hp_c = l == 1 && d > min_neg;
    const bool hn_c = l == 0 && d < max_pos;
    const bool hp_l = l == 1 && (any_neg ? d > min_neg : true);
    const bool hn_l = l == 0 && (any_pos ? d < max_pos : true);
    if (hp_c) pc += d * d;
    if (hn_c) nc += r * r;
    if (hp_l) pl += d * d;
    if (hn_l) nl += r * r;
    coef[b] = ((hp_l ? 2.f * d : 0.f) - (hn_l ? 2.f * r : 0.f)) * inv_b;
  }
  pc = block_sum(pc, scratch);
  nc = block_sum(nc, scratch);
  pl = block_sum(pl, scratch);
  nl = block_sum(nl, scratch);
  if (threadIdx.x == 0) {
    comps[0] = pc;
    comps[1] = nc;
    comps[2] = min_neg;
    comps[3] = max_pos;
    *loss = (pl + nl) / static_cast<float>(B);
  }
}

__global__ void __launch_bounds__(kGradThreads)
contrastive_backward_kernel(const float* __restrict__ e1,
                            const float* __restrict__ e2,
                            const float* __restrict__ rows,
                            const float* __restrict__ coef,
                            const float* __restrict__ upstream, int D,
                            float* __restrict__ g1, float* __restrict__ g2) {
  const int b = blockIdx.x;
  const float g = *upstream * coef[b];
  const float num = rows[4 * b + 1], n1 = rows[4 * b + 2],
              n2 = rows[4 * b + 3];
  const float den = n1 * n2;
  const bool clamped = !(den >= 1e-9f);
  // dd/de1 = -a e2 + c1 e1, dd/de2 = -a e1 + c2 e2
  const float a = clamped ? 1.f / 1e-9f : 1.f / den;
  const float c1 = clamped ? 0.f : num / (n1 * n1 * den);
  const float c2 = clamped ? 0.f : num / (n2 * n2 * den);
  const size_t off = (size_t)b * D;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float x = e1[off + i], y = e2[off + i];
    g1[off + i] = g * fmaf(c1, x, -a * y);
    g2[off + i] = g * fmaf(c2, y, -a * x);
  }
}

}  // namespace

extern "C" {

// Forward: two launches on `stream` (rows, then the one-block reduce);
// returns cudaGetLastError() after them (0 = launched).
int contrastive_forward_launch(const float* e1, const float* e2,
                               const int* labels, int B, int D, int vec4,
                               float margin, float* rows, float* comps,
                               float* loss, float* coef, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (B + kRowWarps - 1) / kRowWarps;
  contrastive_rows_kernel<<<blocks, kRowThreads, 0, s>>>(e1, e2, B, D, vec4,
                                                         rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  contrastive_reduce_kernel<<<1, kReduceThreads, 0, s>>>(
      rows, labels, B, margin, comps, loss, coef);
  return cudaGetLastError();
}

// Backward: one block per pair; `upstream` is the loss's incoming
// gradient, a device scalar.
int contrastive_backward_launch(const float* e1, const float* e2,
                                const float* rows, const float* coef,
                                const float* upstream, int B, int D,
                                float* g1, float* g2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  contrastive_backward_kernel<<<B, kGradThreads, 0, s>>>(
      e1, e2, rows, coef, upstream, D, g1, g2);
  return cudaGetLastError();
}

}  // extern "C"
