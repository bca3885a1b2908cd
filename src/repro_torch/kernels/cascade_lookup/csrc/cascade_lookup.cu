// Fused cascade lookup of the tiered semantic cache, for Hopper (sm_90a),
// over one key panel or an ensemble of E stacked panels.
//
// Replaces two TPU Pallas kernels of repro/kernels/cascade_lookup/kernel.py:
//   * cascade_lookup (body `_kernel`): one pass that scores the hot exact
//     tier, selects the IVF probes, gathers the probed buckets and the
//     unindexed ring tail of the warm tier, keeps a running top-k per tier
//     and merges the two (hot wins ties), then applies the per-query
//     threshold;
//   * cascade_lookup_ensemble (body `_ens_kernel`): the same over E key
//     panels, one per embedder (DESIGN.md §13).  A candidate's score is
//     the fused sum_e w[q,e] * <q_e, key_e[row]>, masked after the sum;
//     routing (probe selection) runs on panel 0, the pilot, alone.
// It computes exactly what the plain versions in ../ref.py compute,
// including the tie order of jax.lax.top_k: lowest hot row first in the
// hot tier, lowest flat candidate position (probe-major, tail last) in the
// warm tier, hot before warm in the merge.  The single cascade is E = 1
// with no weights: the score is the one cosine itself.
//
// Design.  On the TPU a sequential grid carries the running top-k in VMEM
// from step to step; CUDA blocks run in no order, so here one block owns
// one query row and loops over everything that row needs:
//   * the query's E panel rows and its E weights sit in shared memory;
//   * hot phase: each warp strides over hot rows; a row's score is E
//     lane-strided dot products over D (float4 loads when D % 4 == 0),
//     each with a shuffle reduction, summed with the weights in panel
//     order; every lane holds the same warp-private top-k in registers
//     and the block merges the warp lists in shared memory;
//   * probes: the K centroid scores of the pilot query go to shared
//     memory, then warp 0 runs n_probe argmax rounds (lowest index on
//     ties);
//   * warm phase: warps stride over the flat candidate positions
//     f in [0, n_probe*bucket + tail), map f to its bucket slot or tail
//     offset and mask it (slot >= 0, valid, tenant, write epoch) once for
//     all panels -- the candidate index stream is shared, which is the
//     point of fusing the ensemble -- then score the row on every panel
//     in fp32 FMA; int8 rows are widened to fp32, multiplied by the fp32
//     query and scaled by the panel's row scale (the query is never
//     quantized and no int8 MMA is used);
//   * thread 0 merges the tiers and writes the outputs.
// Arithmetic is fp32 end to end: no TF32, no bf16.  Masked candidates keep
// the score NEG = -1e30 and still take part in the selection, so ties
// among them resolve by position exactly as in the plain version.
//
// Bound.  The work is gathers and dot products of a few thousand rows per
// query: a few hundred MFLOP against tens of MB, far below the card's
// operations-per-byte balance, so the kernel is bound by the bytes it
// moves; an ensemble reads E times the single cascade's key bytes with
// the same index and metadata traffic.  What this simple design leaves on
// the table: hot rows and popular buckets are re-read by every query
// block (only L2 reuse saves them), a small batch (Q rows) fills only Q of
// the 132 SMs, and each warp waits on one dependent row at a time.
// Splitting the candidates of one query over several CTAs with a merge
// pass, and staging rows through shared memory with cp.async/TMA, are the
// next steps.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxE = 8;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -1e30f;
constexpr int kPosPad = 0x7fffffff;

__device__ __forceinline__ bool better(float s1, int p1, float s2, int p2) {
  return s1 > s2 || (s1 == s2 && p1 < p2);
}

// Running top-k kept sorted best-first; (score desc, pos asc).  Every index
// is a compile-time constant after unrolling, so the lists stay in
// registers; `k` <= KM is the live length.
template <int KM>
struct TopK {
  float s[KM];
  int p[KM];
  int slot[KM];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      s[i] = -CUDART_INF_F;
      p[i] = kPosPad;
      slot[i] = -1;
    }
  }

  __device__ __forceinline__ void push(float cs, int cp, int cslot, int k) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      if (i < k && better(cs, cp, s[i], p[i])) {
        float ts = s[i]; s[i] = cs; cs = ts;
        int tp = p[i]; p[i] = cp; cp = tp;
        int tl = slot[i]; slot[i] = cslot; cslot = tl;
      }
    }
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// <q, row> for an fp32 row; every lane returns the full sum.
__device__ __forceinline__ float dot_f32(const float* __restrict__ qs,
                                         const float* __restrict__ row,
                                         int D, bool vec4, int lane) {
  float acc = 0.f;
  if (vec4) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int d = lane; d < (D >> 2); d += 32) {
      float4 a = q4[d];
      float4 b = __ldg(r4 + d);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
      acc = fmaf(a.z, b.z, acc);
      acc = fmaf(a.w, b.w, acc);
    }
  } else {
    for (int d = lane; d < D; d += 32) acc = fmaf(qs[d], __ldg(row + d), acc);
  }
  return warp_sum(acc);
}

// <q, float(row8)> for an int8 row (the caller multiplies by the scale).
__device__ __forceinline__ float dot_i8(const float* __restrict__ qs,
                                        const int8_t* __restrict__ row,
                                        int D, bool vec4, int lane) {
  float acc = 0.f;
  if (vec4) {
    const float4* q4 = reinterpret_cast<const float4*>(qs);
    const char4* r4 = reinterpret_cast<const char4*>(row);
    for (int d = lane; d < (D >> 2); d += 32) {
      float4 a = q4[d];
      char4 b = __ldg(r4 + d);
      acc = fmaf(a.x, static_cast<float>(b.x), acc);
      acc = fmaf(a.y, static_cast<float>(b.y), acc);
      acc = fmaf(a.z, static_cast<float>(b.z), acc);
      acc = fmaf(a.w, static_cast<float>(b.w), acc);
    }
  } else {
    for (int d = lane; d < D; d += 32)
      acc = fmaf(qs[d], static_cast<float>(__ldg(row + d)), acc);
  }
  return warp_sum(acc);
}

struct Args {
  const float* q; const float* weights; int E; int Q;
  const int* q_tenants; const float* thr;
  const float* hot_keys; const uint8_t* hot_valid; const int* hot_tenants;
  const int* hot_vids; int n_hot;
  const float* warm_keys; const int8_t* warm_keys_q; const float* warm_scales;
  const uint8_t* warm_valid; const int* warm_tenants; const int* warm_vids;
  const int* warm_seq; int cap;
  const float* centroids; const int* members; int n_clusters; int bucket;
  const int* cursor; const int* indexed_total;
  int D; int k; int n_probe; int tail; int quantized;
  float* out_scores; int* out_vids; int* out_wslots; int* out_hslots;
  uint8_t* out_hot_hit; uint8_t* out_hit;
};

// The score of one row: sum_e w_e * <q_e, row_e> over the E panels in
// panel order (panel e of the row at keys + e * panel_stride); without
// weights (the single cascade) the one cosine itself.  `scales` (int8
// panels) holds each panel's row scale at scales + e * scale_stride.
__device__ __forceinline__ float fused_score(
    const float* __restrict__ qs, int Dp, const float* __restrict__ wq,
    bool weighted, int E, const float* __restrict__ keys,
    const int8_t* __restrict__ keys_q, const float* __restrict__ scales,
    size_t panel_stride, size_t scale_stride, int row, int D, bool vec4,
    int lane) {
  float s = 0.f;
  for (int e = 0; e < E; ++e) {
    float c;
    if (keys_q != nullptr)
      c = dot_i8(qs + e * Dp, keys_q + e * panel_stride + (size_t)row * D,
                 D, vec4, lane) *
          scales[e * scale_stride + row];
    else
      c = dot_f32(qs + e * Dp, keys + e * panel_stride + (size_t)row * D, D,
                  vec4, lane);
    s = !weighted ? c : e == 0 ? c * wq[0] : fmaf(c, wq[e], s);
  }
  return s;
}

// Block-wide merge of the per-warp lists into one list, written to
// shared memory (res_*) by thread 0.
template <int KM>
__device__ void block_merge(const TopK<KM>& mine, float* ws, int* wp,
                            int* wl, float* res_s, int* res_p, int* res_l,
                            int k, int warp, int lane) {
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      ws[warp * KM + i] = mine.s[i];
      wp[warp * KM + i] = mine.p[i];
      wl[warp * KM + i] = mine.slot[i];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    TopK<KM> all;
    all.init();
    for (int w = 0; w < kWarps; ++w)
      for (int i = 0; i < k; ++i)
        all.push(ws[w * KM + i], wp[w * KM + i], wl[w * KM + i], k);
#pragma unroll
    for (int i = 0; i < KM; ++i) {
      res_s[i] = all.s[i];
      res_p[i] = all.p[i];
      res_l[i] = all.slot[i];
    }
  }
  __syncthreads();
}

template <int KM>
__global__ void __launch_bounds__(kThreads)
cascade_lookup_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, k = a.k, E = a.E;
  const int Dp = (D + 3) & ~3;
  float* qs = reinterpret_cast<float*>(smem);                 // E * Dp
  float* wq = qs + E * Dp;                                    // E, padded
  float* cs = wq + ((E + 3) & ~3);                            // n_clusters
  int* probes = reinterpret_cast<int*>(cs + a.n_clusters);    // n_probe
  float* ws = reinterpret_cast<float*>(probes + a.n_probe);   // warps*KM
  int* wp = reinterpret_cast<int*>(ws + kWarps * KM);
  int* wl = wp + kWarps * KM;
  float* hs = reinterpret_cast<float*>(wl + kWarps * KM);     // KM each
  int* hp = reinterpret_cast<int*>(hs + KM);
  int* hl = hp + KM;
  float* rs = reinterpret_cast<float*>(hl + KM);
  int* rp = reinterpret_cast<int*>(rs + KM);
  int* rl = rp + KM;

  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool vec4 = (D & 3) == 0;
  const int qt = a.q_tenants[row];

  for (int i = threadIdx.x; i < E * D; i += kThreads) {
    const int e = i / D, d = i - e * D;
    qs[e * Dp + d] = a.q[((size_t)e * a.Q + row) * D + d];
  }
  const bool weighted = a.weights != nullptr;
  if (weighted && threadIdx.x < E)
    wq[threadIdx.x] = a.weights[(size_t)row * E + threadIdx.x];
  __syncthreads();

  // ---- hot tier: tenant-masked exact top-k ------------------------------
  const size_t hot_stride = (size_t)a.n_hot * D;
  TopK<KM> top;
  top.init();
  for (int r = warp; r < a.n_hot; r += kWarps) {
    float s = kNeg;
    if (a.hot_valid[r] && a.hot_tenants[r] == qt)
      s = fused_score(qs, Dp, wq, weighted, E, a.hot_keys, nullptr, nullptr,
                      hot_stride, 0, r, D, vec4, lane);
    top.push(s, r, r, k);
  }
  block_merge<KM>(top, ws, wp, wl, hs, hp, hl, k, warp, lane);

  // ---- probe selection on the pilot: centroid scores + argmax rounds ----
  for (int c = warp; c < a.n_clusters; c += kWarps) {
    float s = dot_f32(qs, a.centroids + (size_t)c * D, D, vec4, lane);
    if (lane == 0) cs[c] = s;
  }
  __syncthreads();
  if (warp == 0) {
    for (int r = 0; r < a.n_probe; ++r) {
      float bs = -CUDART_INF_F;
      int bi = kPosPad;
      for (int c = lane; c < a.n_clusters; c += 32)
        if (better(cs[c], c, bs, bi)) { bs = cs[c]; bi = c; }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        float os = __shfl_xor_sync(0xffffffffu, bs, o);
        int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
      }
      if (lane == 0) {
        probes[r] = bi;
        cs[bi] = -CUDART_INF_F;   // taken; centroid scores are finite
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- warm tier: IVF buckets + unindexed tail, position-keyed top-k ----
  const int cursor = *a.cursor;
  const int indexed_total = *a.indexed_total;
  const int n_ivf = a.n_probe * a.bucket;
  const int n_cand = n_ivf + a.tail;
  top.init();
  for (int f = warp; f < n_cand; f += kWarps) {
    int cand;
    const bool is_tail = f >= n_ivf;
    if (!is_tail) {
      const int pr = f / a.bucket;
      cand = a.members[(size_t)probes[pr] * a.bucket + (f - pr * a.bucket)];
    } else {
      // floor-mod: the ring index of the (f - n_ivf)-th newest write
      int pos = (cursor - 1 - (f - n_ivf)) % a.cap;
      pos = (pos + a.cap) % a.cap;
      cand = a.warm_seq[pos] > indexed_total ? pos : -1;
    }
    const int safe = min(max(cand, 0), a.cap - 1);
    const bool ok = cand >= 0 && a.warm_valid[safe] &&
                    a.warm_tenants[safe] == qt &&
                    (is_tail || a.warm_seq[safe] <= indexed_total);
    float s = kNeg;
    if (ok)
      s = fused_score(qs, Dp, wq, weighted, E, a.warm_keys,
                      a.quantized ? a.warm_keys_q : nullptr, a.warm_scales,
                      (size_t)a.cap * D, (size_t)a.cap, safe, D, vec4, lane);
    top.push(s, f, safe, k);
  }
  block_merge<KM>(top, ws, wp, wl, rs, rp, rl, k, warp, lane);

  // ---- best-of-tiers merge (hot first: ties resolve hot) ----------------
  if (threadIdx.x == 0) {
    TopK<KM> fin;
    fin.init();
    for (int i = 0; i < k; ++i) fin.push(hs[i], i, 0, k);
    for (int i = 0; i < k; ++i) fin.push(rs[i], k + i, 0, k);
    for (int j = 0; j < k; ++j) {
      const int c = fin.p[j];
      const float s = fin.s[j];
      int vid = -1, wslot = -1;
      if (s > kNeg / 2) {
        if (c < k) {
          vid = a.hot_vids[hl[c]];
        } else {
          wslot = rl[c - k];
          vid = a.warm_vids[wslot];
        }
      }
      a.out_scores[(size_t)row * k + j] = s;
      a.out_vids[(size_t)row * k + j] = vid;
      a.out_wslots[(size_t)row * k + j] = wslot;
    }
    a.out_hslots[row] = hl[0];
    const bool hit = fin.s[0] >= a.thr[row];
    a.out_hit[row] = hit;
    a.out_hot_hit[row] = hit && fin.p[0] < k;
  }
}

template <int KM>
cudaError_t launch(const Args& a, int Q, size_t smem, cudaStream_t stream) {
  cascade_lookup_kernel<KM><<<Q, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k and E the kernel takes (the wrapper refuses more).
int cascade_lookup_max_k() { return 16; }
int cascade_lookup_max_e() { return kMaxE; }

// Shared memory bytes one block needs.
size_t cascade_lookup_smem_bytes(int E, int D, int n_clusters, int n_probe,
                                 int k) {
  const int KM = k <= 1 ? 1 : k <= 4 ? 4 : k <= 8 ? 8 : 16;
  return sizeof(float) * (E * ((D + 3) & ~3) + ((E + 3) & ~3) + n_clusters) +
         sizeof(int) * n_probe + 12u * (kWarps * KM) + 24u * KM;
}

// Launches one block per query row on `stream`; returns cudaGetLastError()
// after the launch (0 = launched).  `q` is (E, Q, D), the key panels are
// (E, rows, D) and the int8 scales (E, cap); `weights` (Q, E) may be NULL
// with E = 1 (the single cascade: scores are the cosines themselves).
int cascade_lookup_launch(
    const float* q, const float* weights, int E, const int* q_tenants,
    const float* thr, const float* hot_keys, const uint8_t* hot_valid,
    const int* hot_tenants, const int* hot_vids, int n_hot,
    const float* warm_keys, const int8_t* warm_keys_q,
    const float* warm_scales, const uint8_t* warm_valid,
    const int* warm_tenants, const int* warm_vids, const int* warm_seq,
    int cap, const float* centroids, const int* members, int n_clusters,
    int bucket, const int* cursor, const int* indexed_total, int Q, int D,
    int k, int n_probe, int tail, int quantized, float* out_scores,
    int* out_vids, int* out_wslots, int* out_hslots, uint8_t* out_hot_hit,
    uint8_t* out_hit, void* stream) {
  if (E < 1 || E > kMaxE || (weights == nullptr && E != 1))
    return cudaErrorInvalidValue;
  Args a{q, weights, E, Q, q_tenants, thr, hot_keys, hot_valid, hot_tenants,
         hot_vids, n_hot, warm_keys, warm_keys_q, warm_scales, warm_valid,
         warm_tenants, warm_vids, warm_seq, cap, centroids, members,
         n_clusters, bucket, cursor, indexed_total, D, k, n_probe, tail,
         quantized, out_scores, out_vids, out_wslots, out_hslots,
         out_hot_hit, out_hit};
  const size_t smem =
      cascade_lookup_smem_bytes(E, D, n_clusters, n_probe, k);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch<1>(a, Q, smem, s);
  if (k <= 4) return launch<4>(a, Q, smem, s);
  if (k <= 8) return launch<8>(a, Q, smem, s);
  return launch<16>(a, Q, smem, s);
}

}  // extern "C"
