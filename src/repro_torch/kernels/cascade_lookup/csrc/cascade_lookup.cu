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
// Bound.  A lookup reads each needed hot and warm row once (E panels each),
// the centroids and the probed inverted lists, and does 2 D flops per
// (query, row) pair it scores: a few hundred MFLOP against tens of MB, far
// below the card's operations-per-byte balance, so device-memory bytes bound
// it.  The TPU design carries the running top-k across a sequential grid; a
// CUDA port of it (one block per query) gives Q = 64 blocks on 132 SMs,
// re-reads every hot row and every popular bucket once per query, and
// serialises each warp on one dependent row at a time.
//
// Design: three launches.
//   1. Probes: one block per query scores the K centroids with the pilot
//      query (each warp four centroids at once, lane-strided over D) and
//      keeps the n_probe best (lowest centroid index on ties).
//   2. Scoring: every CTA scores one segment of at most kRT = 64 rows against
//      a tile of at most kQT = 16 queries, as a register-tiled fp32 GEMM
//      (each thread a 2 x 4 patch of (query, row) scores, D walked in
//      chunks of 32 columns staged in shared memory with 16-byte cp.async
//      copies, 6 deep: a CTA's time is its bytes over the bytes it keeps in
//      flight, so five chunks are in flight while one is multiplied).  The segments are the hot tier's rows in chunks of
//      64 (every query tile); the ring tail's candidates in chunks of 64
//      (every query tile); and each probed bucket's inverted list in chunks
//      of 64, against the queries that probe that bucket (each CTA finds
//      its bucket's queries in the probe table, in query order), so a
//      bucket shared by many queries is read once per 16 of them, not once
//      per query.  A row is copied only if it is live (valid, and indexed
//      for a bucket row) and some query of the tile has its tenant; the
//      tenant and validity masks then apply per (query, row), masked pairs
//      keep the score -1e30 and their position, as in the plain version.
//      For E > 1 each panel's cosine is summed with the query's weight in
//      panel order; int8 warm rows are widened to fp32 and scaled by the
//      row's scale (the query is never quantized).  Each CTA folds its
//      scores into a top-k of (score, position, slot) per query and writes
//      it as one partial list: the hot row, or the flat warm position
//      (probe rank * bucket + offset, tail last) that the plain version
//      uses.
//   3. Merge: one warp per query merges its hot partials, then its warm
//      partials (k rounds of a warp-wide argmax), then the two tiers (hot
//      first) and applies the threshold.
// Arithmetic is fp32 FMA end to end: no TF32, no tensor cores.  Every
// (query, row) dot product runs over D in the same order wherever the row
// falls in a tile, so equal rows score equally and tie by position.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 16;                    // queries per scoring CTA
constexpr int kRT = 64;                    // rows per scoring CTA
constexpr int kDC = 32;                    // D columns per staged chunk
constexpr int kPitch = kDC + 4;            // floats per staged fp32 row
constexpr int kPitch8 = kDC + 16;          // bytes per staged int8 row
constexpr int kStages = 6;                 // 5 chunks in flight per CTA
constexpr int kStageFloats = (kQT + kRT) * kPitch;
constexpr int kSPitch = kRT + 1;           // score-plane row (floats)
constexpr int kFold = kThreads / kQT;      // threads folding one query
constexpr int kMaxE = 8;
constexpr int kMergeThreads = 128;         // 4 queries per merge block
constexpr int kProbeThreads = 512;         // 64 centroids in one round
constexpr int kProbeDots = 4;              // centroids per warp at once
constexpr float kNeg = -1e30f;
constexpr int kPosPad = 0x7fffffff;

static_assert(kThreads == 8 * kQT && kRT == 64, "2 x 4 patches per thread");
static_assert(kRT % kFold == 0, "each fold thread takes kRT / kFold rows");
static_assert(kRT * kPitch8 <= kRT * kPitch * 4, "int8 rows fit the stage");

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

  // drop the head (the best entry)
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i + 1 < KM; ++i) {
      s[i] = s[i + 1];
      p[i] = p[i + 1];
      slot[i] = slot[i + 1];
    }
    s[KM - 1] = -CUDART_INF_F;
    p[KM - 1] = kPosPad;
    slot[KM - 1] = -1;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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
  // scratch and geometry (the wrapper's `kernel.geometry`)
  int* probes;                         // Q x n_probe
  float* part_s; int* part_p; int* part_l;   // Q x n_part x k
  int q_tiles, hot_chunks, bucket_chunks, tail_chunks, n_part;
};

// ---------------------------------------------------------------------------
// 1. probes: the pilot query against the centroids, n_probe argmax rounds
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kProbeThreads)
cascade_probe_kernel(Args a) {
  extern __shared__ float cs[];              // n_clusters
  const int row = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int D = a.D, K = a.n_clusters;
  const float* qrow = a.q + (size_t)row * D;   // panel 0, the pilot
  // each warp kProbeDots centroids at once (independent loads in flight);
  // every dot lane-strided over D, then reduced over the warp
  for (int c0 = warp * kProbeDots; c0 < K;
       c0 += kProbeDots * (kProbeThreads / 32)) {
    float acc[kProbeDots];
#pragma unroll
    for (int j = 0; j < kProbeDots; ++j) acc[j] = 0.f;
    if ((D & 3) == 0) {
      const float4* q4 = reinterpret_cast<const float4*>(qrow);
      for (int d = lane; d < (D >> 2); d += 32) {
        const float4 x = __ldg(q4 + d);
#pragma unroll
        for (int j = 0; j < kProbeDots; ++j) {
          if (c0 + j < K) {
            const float4 y = __ldg(reinterpret_cast<const float4*>(
                a.centroids + (size_t)(c0 + j) * D) + d);
            acc[j] = fmaf(x.x, y.x, acc[j]);
            acc[j] = fmaf(x.y, y.y, acc[j]);
            acc[j] = fmaf(x.z, y.z, acc[j]);
            acc[j] = fmaf(x.w, y.w, acc[j]);
          }
        }
      }
    } else {
      for (int d = lane; d < D; d += 32) {
        const float x = __ldg(qrow + d);
#pragma unroll
        for (int j = 0; j < kProbeDots; ++j)
          if (c0 + j < K)
            acc[j] = fmaf(x, __ldg(a.centroids + (size_t)(c0 + j) * D + d),
                          acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kProbeDots; ++j) {
      const float s = warp_sum(acc[j]);
      if (lane == 0 && c0 + j < K) cs[c0 + j] = s;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  for (int r = 0; r < a.n_probe; ++r) {
    float bs = -CUDART_INF_F;
    int bi = kPosPad;
    for (int c = lane; c < a.n_clusters; c += 32)
      if (better(cs[c], c, bs, bi)) { bs = cs[c]; bi = c; }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(os, oi, bs, bi)) { bs = os; bi = oi; }
    }
    if (lane == 0) {
      a.probes[(size_t)row * a.n_probe + r] = bi;
      cs[bi] = -CUDART_INF_F;            // taken; centroid scores are finite
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// 2. scoring: one segment of rows x one tile of queries
// ---------------------------------------------------------------------------

// Wait until at most n (0 <= n <= kStages - 2) of this thread's cp.async
// groups are in flight.
__device__ __forceinline__ void wait_pending(int n) {
  static_assert(kStages - 2 <= 4, "wait_pending covers up to 4 groups");
  switch (n) {
    case 0: ptx::cp_async_wait<0>(); break;
    case 1: ptx::cp_async_wait<1>(); break;
    case 2: ptx::cp_async_wait<2>(); break;
    case 3: ptx::cp_async_wait<3>(); break;
    default: ptx::cp_async_wait<4>(); break;
  }
}

constexpr size_t kScoreSmem =
    sizeof(float) * (kStages * kStageFloats + kQT * kSPitch);

template <int KM, bool VEC>
__global__ void __launch_bounds__(kThreads) cascade_score_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  float* plane = smem + kStages * kStageFloats;      // kQT x kSPitch
  __shared__ int qidx[kQT], qpart[kQT], qten[kQT], qbase[kQT];
  __shared__ float qw[kQT * kMaxE];
  __shared__ int rslot[kRT], rpos[kRT], rten[kRT];
  __shared__ uint8_t rlive[kRT], rload[kRT];
  __shared__ int wcount[kWarps];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = a.D, E = a.E, Q = a.Q;
  const int n_ivf = a.n_probe * a.bucket;

  // which segment (kind 0 hot, 1 probed bucket, 2 tail) and query tile
  int id = blockIdx.x, kind, qt, rc, cl = 0;
  const int n_hot_items = a.q_tiles * a.hot_chunks;
  const int n_tail_items = a.q_tiles * a.tail_chunks;
  if (id < n_hot_items) {
    kind = 0;
    qt = id / a.hot_chunks;
    rc = id - qt * a.hot_chunks;
  } else if ((id -= n_hot_items) < n_tail_items) {
    kind = 2;
    qt = id / a.tail_chunks;
    rc = id - qt * a.tail_chunks;
  } else {                                 // query tile outermost: the
    id -= n_tail_items;                    // first tiles, which most
    kind = 1;                              // buckets fill, run first
    const int per = a.n_clusters * a.bucket_chunks;
    qt = id / per;
    id -= qt * per;
    cl = id / a.bucket_chunks;
    rc = id - cl * a.bucket_chunks;
  }

  // the tile's queries: the qt-th 16 of all queries (hot, tail), or of
  // those that probe bucket cl, in query order (found in the probe table)
  if (tid < kQT) qidx[tid] = -1;
  __syncthreads();
  if (kind != 1) {
    const int qi = qt * kQT + tid;
    if (tid < kQT && qi < Q) {
      qidx[tid] = qi;
      qpart[tid] = kind == 0 ? rc
                             : a.hot_chunks + a.n_probe * a.bucket_chunks + rc;
      qbase[tid] = kind == 0 ? 0 : n_ivf;
    }
  } else {
    const int lo = qt * kQT;
    const int n = Q * a.n_probe;
    int seen = 0;
    for (int i0 = 0; i0 < n && seen < lo + kQT; i0 += kThreads) {
      const int i = i0 + tid;
      const bool hit = i < n && a.probes[i] == cl;
      const unsigned bal = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) wcount[warp] = __popc(bal);
      __syncthreads();
      int at = seen + __popc(bal & ((1u << lane) - 1u)), total = 0;
      for (int w = 0; w < kWarps; ++w) {
        at += w < warp ? wcount[w] : 0;
        total += wcount[w];
      }
      if (hit && at >= lo && at < lo + kQT) {
        const int rank = i % a.n_probe;
        qidx[at - lo] = i / a.n_probe;
        qpart[at - lo] = a.hot_chunks + rank * a.bucket_chunks + rc;
        qbase[at - lo] = rank * a.bucket;
      }
      seen += total;
      __syncthreads();                     // wcount is reused
    }
  }
  __syncthreads();
  if (qidx[0] < 0) return;                 // no query probes this bucket
  const bool weighted = a.weights != nullptr;
  if (tid < kQT && qidx[tid] >= 0) {
    const int qi = qidx[tid];
    qten[tid] = a.q_tenants[qi];
    for (int e = 0; e < E; ++e)
      qw[tid * kMaxE + e] = weighted ? a.weights[(size_t)qi * E + e] : 1.f;
  }
  __syncthreads();

  // the segment's rows: slot (-1 past its end), offset in the segment,
  // tenant, live, and whether any query of the tile needs the row
  if (tid < kRT) {
    const int j = rc * kRT + tid;
    int slot = -1, ten = 0;
    bool live = false;
    if (kind == 0) {
      if (j < a.n_hot) {
        slot = j;
        live = a.hot_valid[j] != 0;
        ten = a.hot_tenants[j];
      }
    } else if (kind == 1) {
      if (j < a.bucket) {
        const int cand = a.members[(size_t)cl * a.bucket + j];
        slot = min(max(cand, 0), a.cap - 1);
        live = cand >= 0 && a.warm_valid[slot] &&
               a.warm_seq[slot] <= *a.indexed_total;
        ten = a.warm_tenants[slot];
      }
    } else if (j < a.tail) {
      // floor-mod: the ring index of the j-th newest write
      int pos = (*a.cursor - 1 - j) % a.cap;
      pos = (pos + a.cap) % a.cap;
      const int cand = a.warm_seq[pos] > *a.indexed_total ? pos : -1;
      slot = min(max(cand, 0), a.cap - 1);
      live = cand >= 0 && a.warm_valid[slot];
      ten = a.warm_tenants[slot];
    }
    bool need = false;
    if (live)
      for (int t = 0; t < kQT; ++t)
        need = need || (qidx[t] >= 0 && qten[t] == ten);
    rslot[tid] = slot;
    rpos[tid] = j;
    rten[tid] = ten;
    rlive[tid] = live;
    rload[tid] = need;
  }
  __syncthreads();

  const bool i8 = kind != 0 && a.quantized;
  const float* rows_f = kind == 0 ? a.hot_keys : a.warm_keys;
  const size_t rows_n = kind == 0 ? (size_t)a.n_hot : (size_t)a.cap;
  const int n_chunks = max(1, (D + kDC - 1) / kDC);
  const int n_steps = E * n_chunks;

  // what this thread copies in every step (16-byte copies): query row
  // tid / 8 and rows tid / 8 + 16 m at float column 4 (tid % 8) of the
  // chunk (int8: row tid / 2 at byte 16 (tid % 2)); null where not needed
  const int cq = tid & 7;
  const int rq = tid >> 3;
  const float* q_src =
      qidx[rq] >= 0 ? a.q + (size_t)qidx[rq] * D + 4 * cq : nullptr;
  const float* r_src[kRT / 16];
#pragma unroll
  for (int m = 0; m < kRT / 16; ++m) {
    const int r = rq + 16 * m;
    r_src[m] = rload[r] && !i8 ? rows_f + (size_t)rslot[r] * D + 4 * cq
                               : nullptr;
  }
  const int8_t* r8_src = rload[tid >> 1] && i8
      ? a.warm_keys_q + (size_t)rslot[tid >> 1] * D + 16 * (tid & 1)
      : nullptr;

  // stage step `it` (panel it / n_chunks, D chunk it % n_chunks): the
  // tile's query rows, then the segment's rows; zeros where not needed
  auto load = [&](int it) {
    const int e = it / n_chunks;
    const int d0 = (it - e * n_chunks) * kDC;
    float* st = smem + (it % kStages) * kStageFloats;
    float* rs = st + kQT * kPitch;
    const float* qe = a.q + (size_t)e * Q * D;
    if (VEC) {
      static_assert(kQT * (kDC / 4) == kThreads &&
                    kRT * (kDC / 4) == (kRT / 16) * kThreads &&
                    kRT * (kDC / 16) == kThreads,
                    "per thread: one q copy, kRT / 16 fp32 row copies or "
                    "one int8 row copy");
      bool in = q_src != nullptr && d0 + 4 * cq < D;
      ptx::cp_async_16(st + rq * kPitch + 4 * cq,
                       in ? q_src + (size_t)e * Q * D + d0 : a.q, in);
      if (!i8) {
#pragma unroll
        for (int m = 0; m < kRT / 16; ++m) {
          in = r_src[m] != nullptr && d0 + 4 * cq < D;
          ptx::cp_async_16(rs + (rq + 16 * m) * kPitch + 4 * cq,
                           in ? r_src[m] + (size_t)e * rows_n * D + d0 : a.q,
                           in);
        }
      } else {
        int8_t* r8 = reinterpret_cast<int8_t*>(rs);
        in = r8_src != nullptr && d0 + 16 * (tid & 1) < D;
        ptx::cp_async_16(r8 + (tid >> 1) * kPitch8 + 16 * (tid & 1),
                         in ? r8_src + (size_t)e * rows_n * D + d0
                            : reinterpret_cast<const int8_t*>(a.q),
                         in);
      }
      ptx::cp_async_commit();
    } else {                               // D % 16 != 0: plain loads
      for (int i = tid; i < kQT * kDC; i += kThreads) {
        const int r = i / kDC, c = i - r * kDC;
        const bool in = qidx[r] >= 0 && d0 + c < D;
        st[r * kPitch + c] = in ? qe[(size_t)qidx[r] * D + d0 + c] : 0.f;
      }
      if (!i8) {
        const float* re = rows_f + (size_t)e * rows_n * D;
        for (int i = tid; i < kRT * kDC; i += kThreads) {
          const int r = i / kDC, c = i - r * kDC;
          const bool in = rload[r] && d0 + c < D;
          rs[r * kPitch + c] = in ? re[(size_t)rslot[r] * D + d0 + c] : 0.f;
        }
      } else {
        const int8_t* re = a.warm_keys_q + (size_t)e * rows_n * D;
        int8_t* r8 = reinterpret_cast<int8_t*>(rs);
        for (int i = tid; i < kRT * kDC; i += kThreads) {
          const int r = i / kDC, c = i - r * kDC;
          const bool in = rload[r] && d0 + c < D;
          r8[r * kPitch8 + c] = in ? re[(size_t)rslot[r] * D + d0 + c] : 0;
        }
      }
    }
  };

  const int tx = tid & 15;                 // rows tx + 16 j
  const int ty = tid >> 4;                 // queries ty, ty + 8
  float acc[2][4], sc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;

  // one barrier a step: after it, step it has landed for every thread
  // and every thread is done with step it - 1, whose stage then takes
  // the copies of step it + kStages - 1
  for (int it = 0; it < kStages - 1 && it < n_steps; ++it) load(it);
  for (int it = 0; it < n_steps; ++it) {
    if (VEC) wait_pending(min(n_steps - 1 - it, kStages - 2));
    __syncthreads();
    if (it + kStages - 1 < n_steps) load(it + kStages - 1);
    const int e = it / n_chunks;
    const int c = it - e * n_chunks;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    const float* qs = smem + (it % kStages) * kStageFloats;
    const float* rs = qs + kQT * kPitch;
    if (!i8) {
#pragma unroll
      for (int d = 0; d < kDC; d += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(qs + ty * kPitch + d);
        const float4 a1 =
            *reinterpret_cast<const float4*>(qs + (ty + 8) * kPitch + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(rs + (tx + 16 * j) * kPitch + d);
          acc[0][j] = fmaf(a0.x, b.x, acc[0][j]);
          acc[0][j] = fmaf(a0.y, b.y, acc[0][j]);
          acc[0][j] = fmaf(a0.z, b.z, acc[0][j]);
          acc[0][j] = fmaf(a0.w, b.w, acc[0][j]);
          acc[1][j] = fmaf(a1.x, b.x, acc[1][j]);
          acc[1][j] = fmaf(a1.y, b.y, acc[1][j]);
          acc[1][j] = fmaf(a1.z, b.z, acc[1][j]);
          acc[1][j] = fmaf(a1.w, b.w, acc[1][j]);
        }
      }
    } else {
      const int8_t* r8 = reinterpret_cast<const int8_t*>(rs);
#pragma unroll
      for (int d = 0; d < kDC; d += 4) {
        const float4 a0 = *reinterpret_cast<const float4*>(qs + ty * kPitch + d);
        const float4 a1 =
            *reinterpret_cast<const float4*>(qs + (ty + 8) * kPitch + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const char4 b8 =
              *reinterpret_cast<const char4*>(r8 + (tx + 16 * j) * kPitch8 + d);
          const float bx = b8.x, by = b8.y, bz = b8.z, bw = b8.w;
          acc[0][j] = fmaf(a0.x, bx, acc[0][j]);
          acc[0][j] = fmaf(a0.y, by, acc[0][j]);
          acc[0][j] = fmaf(a0.z, bz, acc[0][j]);
          acc[0][j] = fmaf(a0.w, bw, acc[0][j]);
          acc[1][j] = fmaf(a1.x, bx, acc[1][j]);
          acc[1][j] = fmaf(a1.y, by, acc[1][j]);
          acc[1][j] = fmaf(a1.z, bz, acc[1][j]);
          acc[1][j] = fmaf(a1.w, bw, acc[1][j]);
        }
      }
    }
    if (c == n_chunks - 1) {
      // this panel's cosines into the fused score, in panel order
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float scale =
            i8 && rload[r] ? a.warm_scales[(size_t)e * a.cap + rslot[r]] : 1.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float cs = i8 ? acc[i][j] * scale : acc[i][j];
          const float w = qw[(ty + 8 * i) * kMaxE + e];
          sc[i][j] = !weighted ? cs : e == 0 ? cs * w : fmaf(cs, w, sc[i][j]);
        }
      }
    }
  }

  // masks per (query, row), then each query's kFold threads fold its rows
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const bool ok = rlive[r] && qidx[t] >= 0 && rten[r] == qten[t];
      plane[t * kSPitch + r] = ok ? sc[i][j] : kNeg;
    }
  }
  __syncthreads();
  const int fq = tid / kFold;
  const int fs = tid - fq * kFold;
  TopK<KM> top;
  top.init();
  if (qidx[fq] >= 0) {
#pragma unroll
    for (int m = 0; m < kRT / kFold; ++m) {
      const int r = fs + kFold * m;
      if (rslot[r] >= 0)
        top.push(plane[fq * kSPitch + r], qbase[fq] + rpos[r], rslot[r], a.k);
    }
  }
  // the kFold lists of each query through the idle stage buffers
  float* ls = smem;
  int* lp = reinterpret_cast<int*>(ls + kThreads * KM);
  int* ll = lp + kThreads * KM;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    ls[tid * KM + i] = top.s[i];
    lp[tid * KM + i] = top.p[i];
    ll[tid * KM + i] = top.slot[i];
  }
  __syncthreads();
  if (fs == 0 && qidx[fq] >= 0) {
    TopK<KM> all;
    all.init();
    for (int f = 0; f < kFold; ++f)
      for (int i = 0; i < a.k; ++i) {
        const int at = (tid + f) * KM + i;
        all.push(ls[at], lp[at], ll[at], a.k);
      }
    const size_t base =
        ((size_t)qidx[fq] * a.n_part + qpart[fq]) * (size_t)a.k;
#pragma unroll
    for (int i = 0; i < KM; ++i) {         // constant indices: registers
      if (i < a.k) {
        a.part_s[base + i] = all.s[i];
        a.part_p[base + i] = all.p[i];
        a.part_l[base + i] = all.slot[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 3. merge: one warp per query
// ---------------------------------------------------------------------------

template <int KM>
__global__ void __launch_bounds__(kMergeThreads) cascade_merge_kernel(Args a) {
  __shared__ float ts[kMergeThreads / 32][2][KM];
  __shared__ int tp[kMergeThreads / 32][2][KM], tl[kMergeThreads / 32][2][KM];
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  if (row >= a.Q) return;                  // the whole warp
  const int k = a.k;
  // each tier's partial lists: k rounds of a warp-wide (score, pos)
  // argmax over the lanes' heads; positions are distinct within a tier,
  // so exactly one lane holds each winner
  for (int tier = 0; tier < 2; ++tier) {
    const int p0 = tier == 0 ? 0 : a.hot_chunks;
    const int p1 = tier == 0 ? a.hot_chunks : a.n_part;
    const size_t base = ((size_t)row * a.n_part + p0) * k;
    TopK<KM> mine;
    mine.init();
    for (int c = lane; c < (p1 - p0) * k; c += 32)
      mine.push(a.part_s[base + c], a.part_p[base + c], a.part_l[base + c],
                k);
    for (int i = 0; i < k; ++i) {
      float bs = mine.s[0];
      int bp = mine.p[0];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, bs, o);
        const int op = __shfl_xor_sync(0xffffffffu, bp, o);
        if (better(os, op, bs, bp)) { bs = os; bp = op; }
      }
      if (mine.p[0] == bp && mine.s[0] == bs) {
        ts[w][tier][i] = bs;
        tp[w][tier][i] = bp;
        tl[w][tier][i] = mine.slot[0];
        mine.pop();
      }
      __syncwarp();
    }
  }
  if (lane != 0) return;
  // best-of-tiers merge (hot first: ties resolve hot)
  TopK<KM> fin;
  fin.init();
  for (int i = 0; i < k; ++i) fin.push(ts[w][0][i], i, 0, k);
  for (int i = 0; i < k; ++i) fin.push(ts[w][1][i], k + i, 0, k);
#pragma unroll
  for (int j = 0; j < KM; ++j) {           // constant indices: registers
    if (j >= k) break;
    const int c = fin.p[j];
    const float s = fin.s[j];
    int vid = -1, wslot = -1;
    if (s > kNeg / 2) {
      if (c < k) {
        vid = a.hot_vids[tl[w][0][c]];
      } else {
        wslot = tl[w][1][c - k];
        vid = a.warm_vids[wslot];
      }
    }
    a.out_scores[(size_t)row * k + j] = s;
    a.out_vids[(size_t)row * k + j] = vid;
    a.out_wslots[(size_t)row * k + j] = wslot;
  }
  a.out_hslots[row] = tl[w][0][0];
  const bool hit = fin.s[0] >= a.thr[row];
  a.out_hit[row] = hit;
  a.out_hot_hit[row] = hit && fin.p[0] < k;
}

template <int KM>
cudaError_t launch(const Args& a, int vec, cudaStream_t stream) {
  cascade_probe_kernel<<<a.Q, kProbeThreads, sizeof(float) * a.n_clusters,
                         stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int ctas = a.q_tiles * (a.hot_chunks + a.tail_chunks +
                                a.n_clusters * a.bucket_chunks);
  auto score = vec ? cascade_score_kernel<KM, true>
                   : cascade_score_kernel<KM, false>;
  e = cudaFuncSetAttribute(score, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kScoreSmem);
  if (e != cudaSuccess) return e;
  score<<<ctas, kThreads, kScoreSmem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int per_block = kMergeThreads / 32;
  cascade_merge_kernel<KM><<<(a.Q + per_block - 1) / per_block,
                             kMergeThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k and E the kernel takes (the wrapper refuses more).
int cascade_lookup_max_k() { return 16; }
int cascade_lookup_max_e() { return kMaxE; }

// Shared memory bytes of the probe kernel (one float per centroid).
size_t cascade_lookup_probe_smem_bytes(int n_clusters) {
  return sizeof(float) * (size_t)n_clusters;
}

// Three launches on `stream` (probes, scoring, merge); returns
// cudaGetLastError() after them (0 = launched), or cudaErrorInvalidValue
// for arguments it does not take.  `q` is (E, Q, D), the key panels are
// (E, rows, D) and the int8 scales (E, cap); `weights` (Q, E) may be NULL
// with E = 1 (the single cascade: scores are the cosines themselves).  The
// scratch holds the probes (Q x n_probe int32) and the partial lists (Q x
// n_part x k of float scores, int positions and int slots); the geometry
// (row_tile, query_tile, q_tiles, hot/bucket/tail chunks, n_part) is the
// wrapper's `kernel.geometry`, checked here against the kernel's tiles.
// vec: D % 16 == 0 and every panel 16-byte aligned (16-byte copies).
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
    uint8_t* out_hit, int* probes, float* part_s, int* part_p, int* part_l,
    int row_tile, int query_tile, int q_tiles, int hot_chunks,
    int bucket_chunks, int tail_chunks, int n_part, int vec, void* stream) {
  if (E < 1 || E > kMaxE || (weights == nullptr && E != 1) || k < 1 ||
      k > 16 || row_tile != kRT || query_tile != kQT ||
      q_tiles != (Q + kQT - 1) / kQT ||
      hot_chunks != (n_hot + kRT - 1) / kRT ||
      bucket_chunks != (bucket + kRT - 1) / kRT ||
      tail_chunks != (tail + kRT - 1) / kRT ||
      n_part != hot_chunks + n_probe * bucket_chunks + tail_chunks ||
      cascade_lookup_probe_smem_bytes(n_clusters) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  Args a{q, weights, E, Q, q_tenants, thr, hot_keys, hot_valid, hot_tenants,
         hot_vids, n_hot, warm_keys, warm_keys_q, warm_scales, warm_valid,
         warm_tenants, warm_vids, warm_seq, cap, centroids, members,
         n_clusters, bucket, cursor, indexed_total, D, k, n_probe, tail,
         quantized, out_scores, out_vids, out_wslots, out_hslots,
         out_hot_hit, out_hit, probes, part_s, part_p, part_l, q_tiles,
         hot_chunks, bucket_chunks, tail_chunks, n_part};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (k <= 1) e = launch<1>(a, vec, s);
  else if (k <= 4) e = launch<4>(a, vec, s);
  else if (k <= 8) e = launch<8>(a, vec, s);
  else e = launch<16>(a, vec, s);
  return (int)e;
}

}  // extern "C"
