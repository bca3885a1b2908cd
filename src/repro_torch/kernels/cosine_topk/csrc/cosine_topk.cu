// Streaming cosine top-k over a flat key panel, for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/cosine_topk/kernel.py::
// cosine_topk (body `_kernel`): scores = q @ keys^T over the valid rows,
// invalid rows scored -1e30, and the k best of each query row.  The (Q x N)
// score matrix never exists in device memory.  Order is that of
// jax.lax.top_k over the masked score row (the plain version ../ref.py):
// score descending, lowest index first among ties, each index once —
// masked rows take part with their -1e30 score, so a query with fewer than
// k valid rows still gets k distinct indices.  (The Pallas kernel's
// k-round argmax can return one masked index twice there; the port follows
// the reference's plain version, which the flat store runs off the TPU.)
//
// Design.  On the TPU the corpus streams through VMEM block by block with a
// running top-k carried across the sequential grid.  Here the grid is
// (query tiles, splits of N): a block holds a tile of kQT query rows in
// shared memory and walks its share of the key rows, one warp per key row.
// A lane loads its slice of the row once (float4 when D % 4 == 0) and
// multiplies it into all kQT queries, so a key row is read once per query
// tile, not once per query; the kQT dot products are reduced by shuffles
// and lane j keeps query j's running top-k in registers.  The block merges
// its warps' lists in shared memory and writes one partial list per
// (query, split); a second launch merges the splits.  Splitting N keeps
// several blocks per SM busy at the serving batch (Q = 64 is 8 tiles).
// Arithmetic is fp32 FMA: no TF32, no bf16, no MMA.
//
// Bound.  One lookup reads the keys once (N D 4 bytes) and does 2 Q N D
// flops; at Q = 64, D = 768 that is 96 flops per byte, above the fp32
// balance of the card (67 TFLOP/s over 3.35 TB/s = 20), so the fp32 rate
// bounds it.  What this simple design leaves on the table: each key element
// is multiplied by query values read from shared memory (one 4-byte shared
// load per FMA), so shared-memory bandwidth, not the FMA units, caps it; a
// register-tiled outer product (several keys per lane) is the next step.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 8;               // query rows per block
constexpr float kNeg = -1e30f;
constexpr int kPosPad = 0x7fffffff;

__device__ __forceinline__ bool better(float s1, int p1, float s2, int p2) {
  return s1 > s2 || (s1 == s2 && p1 < p2);
}

// Running top-k kept sorted best-first; (score desc, index asc).
template <int KM>
struct TopK {
  float s[KM];
  int p[KM];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      s[i] = -CUDART_INF_F;
      p[i] = kPosPad;
    }
  }

  __device__ __forceinline__ void push(float cs, int cp, int k) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i < k && better(cs, cp, s[i], p[i])) {
        float ts = s[i]; s[i] = cs; cs = ts;
        int tp = p[i]; p[i] = cp; cp = tp;
      }
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int KM>
__global__ void __launch_bounds__(kThreads)
cosine_topk_partial_kernel(const float* __restrict__ q,
                           const float* __restrict__ keys,
                           const uint8_t* __restrict__ valid, int Q, int N,
                           int D, int k, int vec4, int rows_per_split,
                           float* __restrict__ part_s,
                           int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dp = (D + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem);                 // kQT * Dp
  float* ws = qs + kQT * Dp;                                  // lists
  int* wi = reinterpret_cast<int*>(ws + kWarps * kQT * KM);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);

  for (int i = threadIdx.x; i < kQT * Dp; i += kThreads) {
    const int j = i / Dp, d = i - j * Dp;
    qs[i] = (q0 + j < Q && d < D) ? q[(size_t)(q0 + j) * D + d] : 0.f;
  }
  __syncthreads();

  TopK<KM> top;
  top.init();
  for (int r = r0 + warp; r < r1; r += kWarps) {
    float acc[kQT];
#pragma unroll
    for (int j = 0; j < kQT; ++j) acc[j] = 0.f;
    if (vec4) {
      const float4* k4 = reinterpret_cast<const float4*>(keys) +
                         (size_t)r * (D >> 2);
      const float4* q4 = reinterpret_cast<const float4*>(qs);
      for (int c = lane; c < (D >> 2); c += 32) {
        const float4 kv = __ldg(k4 + c);
#pragma unroll
        for (int j = 0; j < kQT; ++j) {
          const float4 qv = q4[j * (Dp >> 2) + c];
          acc[j] = fmaf(qv.x, kv.x, acc[j]);
          acc[j] = fmaf(qv.y, kv.y, acc[j]);
          acc[j] = fmaf(qv.z, kv.z, acc[j]);
          acc[j] = fmaf(qv.w, kv.w, acc[j]);
        }
      }
    } else {
      const float* kr = keys + (size_t)r * D;
      for (int d = lane; d < D; d += 32) {
        const float kv = __ldg(kr + d);
#pragma unroll
        for (int j = 0; j < kQT; ++j) acc[j] = fmaf(qs[j * Dp + d], kv, acc[j]);
      }
    }
    float mine = 0.f;
#pragma unroll
    for (int j = 0; j < kQT; ++j) {
      const float s = warp_sum(acc[j]);
      if (lane == j) mine = s;
    }
    top.push(valid[r] ? mine : kNeg, r, k);     // lane j: query q0 + j
  }

  if (lane < kQT) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      ws[(warp * kQT + lane) * KM + i] = top.s[i];
      wi[(warp * kQT + lane) * KM + i] = top.p[i];
    }
  }
  __syncthreads();
  if (threadIdx.x < kQT && q0 + threadIdx.x < Q) {
    const int j = threadIdx.x;
    TopK<KM> all;
    all.init();
    for (int w = 0; w < kWarps; ++w)
      for (int i = 0; i < k; ++i)
        all.push(ws[(w * kQT + j) * KM + i], wi[(w * kQT + j) * KM + i], k);
    const size_t base = ((size_t)(q0 + j) * S + split) * k;
    for (int i = 0; i < k; ++i) {
      part_s[base + i] = all.s[i];
      part_i[base + i] = all.p[i];
    }
  }
}

// One thread per query row: merge its S partial lists of k.
template <int KM>
__global__ void cosine_topk_merge_kernel(const float* __restrict__ part_s,
                                         const int* __restrict__ part_i,
                                         int Q, int S, int k,
                                         float* __restrict__ out_s,
                                         int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= Q) return;
  TopK<KM> all;
  all.init();
  const size_t base = (size_t)row * S * k;
  for (int c = 0; c < S * k; ++c) all.push(part_s[base + c], part_i[base + c],
                                          k);
  for (int i = 0; i < k; ++i) {
    out_s[(size_t)row * k + i] = all.s[i];
    out_i[(size_t)row * k + i] = all.p[i];
  }
}

template <int KM>
cudaError_t launch(const float* q, const float* keys, const uint8_t* valid,
                   int Q, int N, int D, int k, int vec4, int S,
                   float* part_s, int* part_i, float* out_s, int* out_i,
                   size_t smem, cudaStream_t stream) {
  const int rows_per_split = (N + S - 1) / S;
  dim3 grid((Q + kQT - 1) / kQT, S);
  cosine_topk_partial_kernel<KM><<<grid, kThreads, smem, stream>>>(
      q, keys, valid, Q, N, D, k, vec4, rows_per_split, part_s, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cosine_topk_merge_kernel<KM><<<(Q + 127) / 128, 128, 0, stream>>>(
      part_s, part_i, Q, S, k, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k the kernel takes (the wrapper refuses more).
int cosine_topk_max_k() { return 16; }

// Query rows per block (the wrapper sizes the split count with it).
int cosine_topk_query_tile() { return kQT; }

// Shared memory bytes one block of the partial pass needs.
size_t cosine_topk_smem_bytes(int D, int k) {
  const int KM = k <= 1 ? 1 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
  return sizeof(float) * kQT * ((D + 3) & ~3) + 8u * kWarps * kQT * KM;
}

// Two launches on `stream`: the partial top-k of every (query tile, split)
// into part_s/part_i (Q * S * k each), then the merge into out_s/out_i
// (Q * k each).  Returns cudaGetLastError() after them (0 = launched).
int cosine_topk_launch(const float* q, const float* keys,
                       const uint8_t* valid, int Q, int N, int D, int k,
                       int vec4, int S, float* part_s, int* part_i,
                       float* out_s, int* out_i, void* stream) {
  const size_t smem = cosine_topk_smem_bytes(D, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch<1>(q, keys, valid, Q, N, D, k, vec4, S, part_s,
                               part_i, out_s, out_i, smem, s);
  if (k <= 4) return launch<4>(q, keys, valid, Q, N, D, k, vec4, S, part_s,
                               part_i, out_s, out_i, smem, s);
  if (k <= 8) return launch<8>(q, keys, valid, Q, N, D, k, vec4, S, part_s,
                               part_i, out_s, out_i, smem, s);
  return launch<16>(q, keys, valid, Q, N, D, k, vec4, S, part_s, part_i,
                    out_s, out_i, smem, s);
}

}  // extern "C"
