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
// Design: a register-tiled float32 GEMM with the top-k fused.  On the TPU
// the corpus streams through VMEM block by block with a running top-k
// carried across the sequential grid.  Here the grid is (query tiles of
// kBQ = 64, splits of N); a block walks its split in key tiles of 8 TN
// rows (32, or 64 for panels large enough to fill the card with fewer,
// longer blocks: the wrapper picks).  Each tile's score block is computed
// by kGroups groups of 128 threads, each thread holding a 4 x TN register
// patch (queries ty + 16 i, keys tx + 8 j), the groups splitting every
// chunk of kDC columns of D between them (a split-K inside the block, for
// twice the warps at the flat cache's 4096 rows).  Each chunk's q slice
// and key slice are staged in shared memory with cp.async, 2 or 3 deep,
// so the copies of the next chunks are in flight while this one is
// multiplied; (4 + TN) 16-byte shared loads feed 16 TN FMAs.  Rows are
// padded to an odd count of 16-byte chunks, so the key loads are free of
// bank conflicts and the query loads are broadcasts.  Ragged Q, N and D
// are zero-filled by the copies (src-size 0) and masked.  After each key
// tile the groups' partial scores meet in shared memory, and kFold threads
// per query fold them into that query's register top-k, keyed (score
// desc, index asc); at the end the block merges its kFold lists per query
// and writes one partial list per (query, split).  A second launch, one
// warp per query, merges the splits.  Arithmetic is float32 FMA: no TF32, no
// bf16, no MMA (the flat cache's threshold sits in the 4th decimal).
//
// bf16 panels.  q and keys may both be bf16, as the Pallas kernel takes
// them (it casts both to float32 on load).  Here too the conversion is on
// load: the bf16 staging path reads 4 values (8 bytes) a thread from
// global memory into registers, widens them to float32 (a 16-bit shift)
// and stores the float4 into the same shared stage as the float32 path,
// so the register-tiled float32 GEMM and the top-k are unchanged.  cp.async
// cannot convert in flight, so these stages are written synchronously
// (the float32 path keeps its copies in flight); bf16 halves the bytes
// read, and the float32 FMA rate still bounds the lookup.
//
// Bound.  One lookup reads the keys once (N D 4 bytes) and does 2 Q N D
// flops; at Q = 64, D = 768 that is ~32 flops per byte, above the float32
// balance of the card (67 TFLOP/s over 3.35 TB/s = 20), so the float32
// FMA rate bounds it.  On this card the kernel reaches about 45 % of that
// rate at N = 65536: the query tile is re-read from L2 for every key tile
// (the key tile trades that traffic against the number of blocks at N =
// 4096), and at N = 4096 the merge is a second launch.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"

namespace {

constexpr int kBQ = 64;               // query rows per block
constexpr int kGroups = 2;            // thread groups sharing each D chunk
constexpr int kGroupThreads = 128;    // 16 (queries) x 8 (keys) patches
constexpr int kThreads = kGroups * kGroupThreads;      // 256
constexpr int kDG = 32;               // D columns per group per chunk
constexpr int kDC = kGroups * kDG;    // D columns per chunk
constexpr int kPitch = kDC + 4;       // floats per staged row (17 x 16 B)
constexpr int kFold = kThreads / kBQ; // threads folding one query's scores
constexpr float kNeg = -1e30f;
constexpr int kPosPad = 0x7fffffff;

using bf16_bits = uint16_t;           // a bf16 value's raw 16 bits

// bf16 -> float32 is exact: the bf16 bits are a float32's high half
__device__ __forceinline__ float bf16_to_float(bf16_bits b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// four bf16 (8 bytes, element 0 in the low half of x) -> float4
__device__ __forceinline__ float4 bf16x4_to_float4(uint2 u) {
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// A thread's patch is 4 queries (ty + 16 i) x TN keys (tx + 8 j), so a
// key tile is 8 TN rows: 32 at TN = 4 (more blocks, for the flat cache's
// 4096 rows) or 64 at TN = 8 (half the re-reads of the query tile from
// L2, and 12 shared loads per 128 FMAs, for large panels).
template <int TN>
struct Tile {
  static constexpr int kBN = 8 * TN;                  // key rows per tile
  static constexpr int kStages = TN == 4 ? 3 : 2;     // cp.async depth
  static constexpr int kStageFloats = (kBQ + kBN) * kPitch;
  static constexpr int kSPitch = kBN + 1;             // score-plane row
  static constexpr int kPlaneFloats = kBQ * kSPitch;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kStages * kStageFloats + kGroups * kPlaneFloats);
  static_assert(kBN % kFold == 0, "each fold thread takes kBN / kFold keys");
};

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

  // drop the head (the best entry)
  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int i = 0; i + 1 < KM; ++i) {
      s[i] = s[i + 1];
      p[i] = p[i + 1];
    }
    s[KM - 1] = -CUDART_INF_F;
    p[KM - 1] = kPosPad;
  }
};

template <int KM, int TN, bool VEC, typename T>
__global__ void __launch_bounds__(kThreads, 2)
cosine_topk_partial_kernel(const T* __restrict__ q,
                           const T* __restrict__ keys,
                           const uint8_t* __restrict__ valid, int Q, int N,
                           int D, int k, int rows_per_split,
                           float* __restrict__ part_s,
                           int* __restrict__ part_i) {
  using Tl = Tile<TN>;
  constexpr int kBN = Tl::kBN;
  constexpr int kStages = Tl::kStages;
  extern __shared__ __align__(16) float smem[];
  float* planes = smem + kStages * Tl::kStageFloats;  // kGroups planes

  const int tid = threadIdx.x;
  const int grp = tid / kGroupThreads;
  const int gt = tid - grp * kGroupThreads;
  const int tx = gt & 7;              // keys tx + 8 j
  const int ty = gt >> 3;             // queries ty + 16 i
  const int fq = tid / kFold;         // fold: query fq, keys fs + kFold m
  const int fs = tid - fq * kFold;
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int S = gridDim.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(N, r0 + rows_per_split);
  const int n_tiles = r1 > r0 ? (r1 - r0 + kBN - 1) / kBN : 0;
  const int n_chunks = max(1, (D + kDC - 1) / kDC);   // D = 0: zeros
  const int n_steps = n_tiles * n_chunks;

  // stage step `it` (key tile it / n_chunks, D chunk it % n_chunks): rows
  // 0..kBQ-1 the query slice, then kBN key rows; zeros past Q, r1 and D.
  // float32 by cp.async; bf16 through registers, widened on the way
  auto load = [&](int it) {
    const int t = it / n_chunks;
    const int d0 = (it - t * n_chunks) * kDC;
    const int kr0 = r0 + t * kBN;
    float* st = smem + (it % kStages) * Tl::kStageFloats;
    if constexpr (std::is_same<T, bf16_bits>::value) {
      if (VEC) {                      // 4 values (8 bytes) a thread
        constexpr int kC4 = kDC / 4;
        for (int i = tid; i < (kBQ + kBN) * kC4; i += kThreads) {
          const int r = i / kC4, c = i - r * kC4;
          const int d = d0 + c * 4;
          const bool isq = r < kBQ;
          const int row = isq ? q0 + r : kr0 + r - kBQ;
          const bf16_bits* src = isq ? q : keys;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (d < D && row < (isq ? Q : r1))
            v = bf16x4_to_float4(*reinterpret_cast<const uint2*>(
                src + (size_t)row * D + d));
          *reinterpret_cast<float4*>(st + r * kPitch + c * 4) = v;
        }
      } else {
        for (int i = tid; i < (kBQ + kBN) * kDC; i += kThreads) {
          const int r = i / kDC, c = i - r * kDC;
          const int d = d0 + c;
          const bool isq = r < kBQ;
          const int row = isq ? q0 + r : kr0 + r - kBQ;
          const bf16_bits* src = isq ? q : keys;
          st[r * kPitch + c] = d < D && row < (isq ? Q : r1)
                                   ? bf16_to_float(src[(size_t)row * D + d])
                                   : 0.f;
        }
      }
    } else if (VEC) {
      constexpr int kC4 = kDC / 4;
      for (int i = tid; i < (kBQ + kBN) * kC4; i += kThreads) {
        const int r = i / kC4, c = i - r * kC4;
        const int d = d0 + c * 4;
        const bool isq = r < kBQ;
        const int row = isq ? q0 + r : kr0 + r - kBQ;
        const bool in = d < D && row < (isq ? Q : r1);
        const float* src = isq ? q : keys;
        ptx::cp_async_16(st + r * kPitch + c * 4,
                         src + (in ? (size_t)row * D + d : 0), in);
      }
    } else {
      for (int i = tid; i < (kBQ + kBN) * kDC; i += kThreads) {
        const int r = i / kDC, c = i - r * kDC;
        const int d = d0 + c;
        const bool isq = r < kBQ;
        const int row = isq ? q0 + r : kr0 + r - kBQ;
        const bool in = d < D && row < (isq ? Q : r1);
        const float* src = isq ? q : keys;
        ptx::cp_async_4(st + r * kPitch + c,
                        src + (in ? (size_t)row * D + d : 0), in);
      }
    }
    ptx::cp_async_commit();           // empty group on the bf16 path
  };

  TopK<KM> top;
  top.init();
  float acc[4][TN];

  for (int it = 0; it < kStages - 1 && it < n_steps; ++it) load(it);
  for (int it = 0; it < n_steps; ++it) {
    if (it + kStages - 1 < n_steps) {
      load(it + kStages - 1);
      ptx::cp_async_wait<kStages - 1>();
    } else if (kStages > 2 && it + 1 < n_steps) {
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();                  // step it landed for every thread
    const int t = it / n_chunks;
    const int c = it - t * n_chunks;
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    const float* qs = smem + (it % kStages) * Tl::kStageFloats + grp * kDG;
    const float* ks = qs + kBQ * kPitch;
#pragma unroll
    for (int d = 0; d < kDG; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kPitch +
                                                d);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * kPitch + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    if (c == n_chunks - 1) {
      // the tile's scores: both groups' partial sums meet in the planes,
      // then each query's kFold threads fold its kBN scores
      float* pl = planes + grp * Tl::kPlaneFloats;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          pl[(ty + 16 * i) * Tl::kSPitch + tx + 8 * j] = acc[i][j];
      __syncthreads();
      const int kr0 = r0 + t * kBN;
#pragma unroll
      for (int m = 0; m < kBN / kFold; ++m) {
        const int key = fs + kFold * m;
        const int r = kr0 + key;
        if (r < r1) {
          float sc = planes[fq * Tl::kSPitch + key];
#pragma unroll
          for (int gg = 1; gg < kGroups; ++gg)
            sc += planes[gg * Tl::kPlaneFloats + fq * Tl::kSPitch + key];
          top.push(valid[r] ? sc : kNeg, r, k);
        }
      }
    }
    __syncthreads();                  // stage it % kStages and the planes
  }                                   // are free again

  // the kFold lists of each query, through the (now idle) stage buffers
  float* ls = smem;
  int* li = reinterpret_cast<int*>(smem + kBQ * kFold * KM);
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    ls[tid * KM + i] = top.s[i];
    li[tid * KM + i] = top.p[i];
  }
  __syncthreads();
  if (tid < kBQ && q0 + tid < Q) {
    TopK<KM> all;
    all.init();
    for (int f = 0; f < kFold; ++f)
      for (int i = 0; i < k; ++i)
        all.push(ls[(tid * kFold + f) * KM + i],
                 li[(tid * kFold + f) * KM + i], k);
    const size_t base = ((size_t)(q0 + tid) * S + split) * k;
    for (int i = 0; i < k; ++i) {
      part_s[base + i] = all.s[i];
      part_i[base + i] = all.p[i];
    }
  }
}

// One warp per query row: each lane keeps a top-k of its share of the S
// partial lists, then k rounds of a warp-wide (score, index) argmax over
// the lanes' heads, the winning lane dropping its head.  Indices are
// distinct across splits, so exactly one lane holds each winner.
template <int KM>
__global__ void cosine_topk_merge_kernel(const float* __restrict__ part_s,
                                         const int* __restrict__ part_i,
                                         int Q, int S, int k,
                                         float* __restrict__ out_s,
                                         int* __restrict__ out_i) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= Q) return;               // the whole warp
  TopK<KM> mine;
  mine.init();
  const size_t base = (size_t)row * S * k;
  for (int c = lane; c < S * k; c += 32)
    mine.push(part_s[base + c], part_i[base + c], k);
  for (int i = 0; i < k; ++i) {
    float bs = mine.s[0];
    int bp = mine.p[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float os = __shfl_xor_sync(0xffffffffu, bs, o);
      const int op = __shfl_xor_sync(0xffffffffu, bp, o);
      if (better(os, op, bs, bp)) {
        bs = os;
        bp = op;
      }
    }
    if (mine.p[0] == bp) mine.pop();
    if (lane == 0) {
      out_s[(size_t)row * k + i] = bs;
      out_i[(size_t)row * k + i] = bp;
    }
  }
}

constexpr int kMergeThreads = 128;    // 4 query rows per block

template <int KM, int TN, bool VEC, typename T>
cudaError_t launch_partial(const void* q, const void* keys,
                           const uint8_t* valid, int Q, int N, int D, int k,
                           int S, int rows_per_split, float* part_s,
                           int* part_i, cudaStream_t stream) {
  auto kern = cosine_topk_partial_kernel<KM, TN, VEC, T>;
  constexpr size_t smem = Tile<TN>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + kBQ - 1) / kBQ, S);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys), valid, Q, N, D,
      k, rows_per_split, part_s, part_i);
  return cudaGetLastError();
}

template <int KM, typename T>
cudaError_t launch_tiles(const void* q, const void* keys,
                         const uint8_t* valid, int Q, int N, int D, int k,
                         int vec, int key_tile, int S, int rows_per_split,
                         float* part_s, int* part_i, cudaStream_t stream) {
  if (key_tile == 32)
    return vec ? launch_partial<KM, 4, true, T>(q, keys, valid, Q, N, D, k,
                                                S, rows_per_split, part_s,
                                                part_i, stream)
               : launch_partial<KM, 4, false, T>(q, keys, valid, Q, N, D, k,
                                                 S, rows_per_split, part_s,
                                                 part_i, stream);
  if (key_tile == 64)
    return vec ? launch_partial<KM, 8, true, T>(q, keys, valid, Q, N, D, k,
                                                S, rows_per_split, part_s,
                                                part_i, stream)
               : launch_partial<KM, 8, false, T>(q, keys, valid, Q, N, D, k,
                                                 S, rows_per_split, part_s,
                                                 part_i, stream);
  return cudaErrorInvalidValue;
}

template <int KM>
cudaError_t launch(const void* q, const void* keys, const uint8_t* valid,
                   int Q, int N, int D, int k, int bf16, int vec,
                   int key_tile, int S, int rows_per_split, float* part_s,
                   int* part_i, float* out_s, int* out_i,
                   cudaStream_t stream) {
  const cudaError_t err =
      bf16 ? launch_tiles<KM, bf16_bits>(q, keys, valid, Q, N, D, k, vec,
                                         key_tile, S, rows_per_split, part_s,
                                         part_i, stream)
           : launch_tiles<KM, float>(q, keys, valid, Q, N, D, k, vec,
                                     key_tile, S, rows_per_split, part_s,
                                     part_i, stream);
  if (err != cudaSuccess) return err;
  const int rows_per_block = kMergeThreads / 32;
  cosine_topk_merge_kernel<KM>
      <<<(Q + rows_per_block - 1) / rows_per_block, kMergeThreads, 0,
         stream>>>(part_s, part_i, Q, S, k, out_s, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest k the kernel takes (the wrapper refuses more).
int cosine_topk_max_k() { return 16; }

// Query rows per block of the partial pass (the wrapper sizes the splits
// of N with it and with the key tile it picks, 32 or 64 rows).
int cosine_topk_query_tile() { return kBQ; }

// Two launches on `stream`: the partial top-k of every (query tile, split
// of rows_per_split key rows, a multiple of key_tile) into part_s/part_i
// (Q * S * k each), then the merge into out_s/out_i (Q * k each).  q and
// keys are both float32 (bf16 = 0) or both bf16 (bf16 = 1).  vec: D % 4 ==
// 0 with q and keys 16-byte aligned (float32: 16-byte copies) or 8-byte
// aligned (bf16: 8-byte loads); else element-wide copies.  Returns
// cudaGetLastError() after them (0 = launched), or cudaErrorInvalidValue
// for a key tile other than 32 or 64.
int cosine_topk_launch(const void* q, const void* keys, const uint8_t* valid,
                       int Q, int N, int D, int k, int bf16, int vec,
                       int key_tile, int S, int rows_per_split, float* part_s,
                       int* part_i, float* out_s, int* out_i, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 1) return launch<1>(q, keys, valid, Q, N, D, k, bf16, vec,
                               key_tile, S, rows_per_split, part_s, part_i,
                               out_s, out_i, s);
  if (k <= 4) return launch<4>(q, keys, valid, Q, N, D, k, bf16, vec,
                               key_tile, S, rows_per_split, part_s, part_i,
                               out_s, out_i, s);
  if (k <= 8) return launch<8>(q, keys, valid, Q, N, D, k, bf16, vec,
                               key_tile, S, rows_per_split, part_s, part_i,
                               out_s, out_i, s);
  return launch<16>(q, keys, valid, Q, N, D, k, bf16, vec, key_tile, S,
                    rows_per_split, part_s, part_i, out_s, out_i, s);
}

}  // extern "C"
